"""crc32c (Castagnoli) on the host, with Ceph's conventions.

Port of ``ceph_tpu/utils/crc32c.py``: raw crc32c updates with no pre or
post inversion, seeded with -1 (reference include/crc32c.h,
common/crc32c*.cc table paths), so ``crc32c(b"") == 0xFFFFFFFF``.
``crc32c`` runs the port's native C++ library (``native.py``), which it
builds on first use; a failed build raises, there is no software route.
``crc32c_sw`` is the plain table loop, kept as the reference the native
path is held to.  Both hash the logical bytes: an array is fed to the
library as ``np.ascontiguousarray(a.astype(np.uint8))``.  The card
computes the same function in ``ops/crc32c_device.py``.
"""
from __future__ import annotations

import numpy as np

from ..native import crc32c as _native_crc32c

_POLY = 0x82F63B78  # reflected CRC-32C polynomial


def _build_table() -> np.ndarray:
    t = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ _POLY if c & 1 else c >> 1
        t[i] = c
    return t


_TABLE = _build_table()
_TABLE_INTS = [int(v) for v in _TABLE]


def crc32c_sw(data, crc: int = 0xFFFFFFFF) -> int:
    """Raw crc32c of ``data`` (bytes-like or a numpy array, taken as
    uint8) continued from register ``crc``; one table step per byte."""
    buf = data.astype(np.uint8).tobytes() if isinstance(data, np.ndarray) \
        else bytes(data)
    table = _TABLE_INTS
    c = int(crc) & 0xFFFFFFFF
    for b in buf:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c


def crc32c(data, crc: int = 0xFFFFFFFF) -> int:
    """The port's host crc32c: the native library's table update."""
    return _native_crc32c(data, crc)
