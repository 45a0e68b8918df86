"""The smallest stand-in for ``ceph_tpu/common/config.py``: the options
the port reads, under the JAX package's names and defaults, with the
same ``get_val`` / ``set_val`` / ``rm_val`` calls.  No schema, observers
or injectargs: later slices grow it as they port the modules that need
them.

- ``os_memstore_device_bytes_max`` (int, 0 = no limit): device-resident
  shard bytes before the LRU demotes the coldest to host bytes
  (``os_store/device_shard.py``).
"""
from __future__ import annotations

import threading
from typing import Any, Dict

DEFAULTS: Dict[str, Any] = {
    "os_memstore_device_bytes_max": 0,
}


class Config:
    def __init__(self):
        self.values: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def get_val(self, name: str) -> Any:
        with self._lock:
            if name in self.values:
                return self.values[name]
        if name not in DEFAULTS:
            raise KeyError(f"unknown option {name}")
        return DEFAULTS[name]

    def set_val(self, name: str, value: Any) -> None:
        if name not in DEFAULTS:
            raise KeyError(f"unknown option {name}")
        with self._lock:
            self.values[name] = type(DEFAULTS[name])(value)

    def rm_val(self, name: str) -> None:
        with self._lock:
            self.values.pop(name, None)


g_conf = Config()
