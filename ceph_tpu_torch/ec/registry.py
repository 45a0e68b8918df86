"""ErasureCodePluginRegistry — plugin factory registry.

Port of ``ceph_tpu/ec/registry.py`` (reference
src/erasure-code/ErasureCodePlugin.cc:126-184): plugins are registered by
name into a lock-guarded singleton, version-checked, and instantiated per
profile.  Built in: ``jerasure`` (the default, as in the JAX package and
in Ceph), ``isa``, ``cuda``, ``shec``, ``lrc``, ``regenerating`` and
``example_xor``.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict

from .interface import ErasureCodeInterface, ErasureCodeProfile

# version handshake analog of __erasure_code_version (ErasureCodePlugin.h:24-27)
PLUGIN_VERSION = "ceph_tpu_torch-ec-1"


class ErasureCodePlugin:
    """Factory wrapper; subclass or pass a callable returning a codec."""

    version = PLUGIN_VERSION

    def __init__(self, factory: Callable[[], ErasureCodeInterface]):
        self._factory = factory

    def make(self, profile: ErasureCodeProfile) -> ErasureCodeInterface:
        codec = self._factory()
        codec.init(dict(profile))
        return codec


class ErasureCodePluginRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._plugins: Dict[str, ErasureCodePlugin] = {}

    def add(self, name: str, plugin: ErasureCodePlugin) -> None:
        with self._lock:
            if name in self._plugins:
                raise KeyError(f"plugin {name} already registered")
            if plugin.version != PLUGIN_VERSION:
                raise RuntimeError(
                    f"plugin {name} version {plugin.version} does not match "
                    f"expected {PLUGIN_VERSION}")
            self._plugins[name] = plugin

    def get(self, name: str) -> ErasureCodePlugin:
        with self._lock:
            self._load_builtin(name)
            if name not in self._plugins:
                raise KeyError(f"unknown erasure-code plugin {name!r}")
            return self._plugins[name]

    def factory(self, name: str,
                profile: ErasureCodeProfile) -> ErasureCodeInterface:
        return self.get(name).make(profile)

    def preload(self, names) -> None:
        """Load each named plugin now (``osd_erasure_code_plugins``);
        an unknown name raises."""
        for n in names:
            self.get(n)

    def names(self):
        """Every built-in plugin, sorted: the JAX package's list with
        ``cuda`` for ``tpu``."""
        with self._lock:
            for n in ("jerasure", "isa", "cuda", "lrc", "shec",
                      "regenerating", "example_xor"):
                self._load_builtin(n)
            return sorted(self._plugins)

    # lazy built-in registration (avoids import cycles)
    def _load_builtin(self, name: str) -> None:
        if name in self._plugins:
            return
        factory = None
        if name == "jerasure":
            from .jerasure import ErasureCodeJerasure
            factory = ErasureCodeJerasure
        elif name == "isa":
            from .isa import ErasureCodeIsa
            factory = ErasureCodeIsa
        elif name == "cuda":
            from .cuda_plugin import ErasureCodeCuda
            factory = ErasureCodeCuda
        elif name == "lrc":
            from .lrc import ErasureCodeLrc
            factory = ErasureCodeLrc
        elif name == "shec":
            from .shec import ErasureCodeShec
            factory = ErasureCodeShec
        elif name == "regenerating":
            from .regenerating import ErasureCodeRegenerating
            factory = ErasureCodeRegenerating
        elif name == "example_xor":
            from .example_xor import ErasureCodeExampleXor
            factory = ErasureCodeExampleXor
        if factory is not None:
            self._plugins[name] = ErasureCodePlugin(factory)


instance = ErasureCodePluginRegistry()


def create_erasure_code(profile: ErasureCodeProfile) -> ErasureCodeInterface:
    """mon-style entry point (reference mon/OSDMonitor.cc:5335
    get_erasure_code): profile['plugin'] selects the codec (default
    ``jerasure``, as in the JAX package).  The backend defaults to
    ``cuda`` whatever the plugin."""
    return instance.factory(profile.get("plugin", "jerasure"), profile)
