"""Compressor plugin registry — src/compressor/ analog.

The reference ships a compression plugin framework that mirrors the EC
plugin registry (compressor/CompressionPlugin.h; registry/factory like
ErasureCodePlugin.cc:126-184, used by BlueStore's compress-on-write and
the messenger).  Same shape here: named plugins registered in a
singleton, a factory resolving name -> instance, and a stable
Compressor interface (compressor/Compressor.h: compress/decompress over
buffers).

Plugins: zlib (always present — stdlib), and snappy/zstd/lz4 which
register only when their python bindings exist in the image (the
reference similarly builds plugins conditionally).  The "none"
passthrough matches Compressor::COMP_ALG_NONE.

Compression is host-side by design: it serves the storage/wire path,
not the device compute path (BlueStore itself is out of scope per
SURVEY §2.9; the consumer here is checkpoint/export files and any
TCP-messenger payload compression).

The port's own copy of ``ceph_tpu/compressor/registry.py``: the same
names, classes and error text.
"""
from __future__ import annotations

import zlib
from typing import Callable, Dict, List, Optional


class Compressor:
    """compressor/Compressor.h interface."""

    name = "none"

    def compress(self, data: bytes) -> bytes:
        return bytes(data)

    def decompress(self, data: bytes) -> bytes:
        return bytes(data)


class NoneCompressor(Compressor):
    name = "none"


class ZlibCompressor(Compressor):
    """compressor/zlib plugin (the reference's default alongside snappy)."""

    name = "zlib"

    def __init__(self, level: int = 5):
        self.level = level

    def compress(self, data: bytes) -> bytes:
        return zlib.compress(bytes(data), self.level)

    def decompress(self, data: bytes) -> bytes:
        return zlib.decompress(bytes(data))


def _try_snappy() -> Optional[type]:
    try:
        import snappy

        class SnappyCompressor(Compressor):
            name = "snappy"

            def compress(self, data: bytes) -> bytes:
                return snappy.compress(bytes(data))

            def decompress(self, data: bytes) -> bytes:
                return snappy.decompress(bytes(data))

        return SnappyCompressor
    except ImportError:
        return None


def _try_zstd() -> Optional[type]:
    try:
        import zstandard

        class ZstdCompressor(Compressor):
            name = "zstd"

            def __init__(self):
                self._c = zstandard.ZstdCompressor()
                self._d = zstandard.ZstdDecompressor()

            def compress(self, data: bytes) -> bytes:
                return self._c.compress(bytes(data))

            def decompress(self, data: bytes) -> bytes:
                return self._d.decompress(bytes(data))

        return ZstdCompressor
    except ImportError:
        return None


def _try_lz4() -> Optional[type]:
    try:
        import lz4.frame

        class Lz4Compressor(Compressor):
            name = "lz4"

            def compress(self, data: bytes) -> bytes:
                return lz4.frame.compress(bytes(data))

            def decompress(self, data: bytes) -> bytes:
                return lz4.frame.decompress(bytes(data))

        return Lz4Compressor
    except ImportError:
        return None


class CompressorRegistry:
    """CompressionPluginRegistry analog: names -> factories, preloaded
    with whatever this environment can supply."""

    def __init__(self):
        self._factories: Dict[str, Callable[[], Compressor]] = {}
        self.register("none", NoneCompressor)
        self.register("zlib", ZlibCompressor)
        for probe in (_try_snappy, _try_zstd, _try_lz4):
            cls = probe()
            if cls is not None:
                self.register(cls.name, cls)

    def register(self, name: str,
                 factory: Callable[[], Compressor]) -> None:
        self._factories[name] = factory

    def supported(self) -> List[str]:
        return sorted(self._factories)

    def create(self, name: str) -> Compressor:
        factory = self._factories.get(name)
        if factory is None:
            raise KeyError(
                f"unsupported compressor {name!r}; "
                f"available: {self.supported()}")
        return factory()


g_compressor_registry = CompressorRegistry()


def create_compressor(name: str) -> Compressor:
    """Factory (Compressor::create role)."""
    return g_compressor_registry.create(name)
