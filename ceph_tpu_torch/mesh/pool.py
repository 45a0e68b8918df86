"""Staging-buffer pool: padded batch buffers reused across flushes.

Port of ``ceph_tpu/mesh/pool.py``, unchanged: host numpy buffers.

Every mesh flush assembles its requests into ONE padded (S_pad, k, Cb)
host buffer before each member's upload.  Allocating that buffer per
flush is exactly the churn the zero-copy ROADMAP item indicts (the
allocation is invisible to the copy ledger but very visible to the
allocator); the pool keeps a small free list per shape so steady-state
traffic reuses the same staging memory flush after flush.

Buffers are handed out EXCLUSIVELY (acquire/release), so concurrent
flushes of different signature queues can never scribble over each
other's staging rows; a released buffer is zeroed lazily by the next
acquirer (the pad lanes must read zero — GF-coding zero rows encode to
zero rows, which the slicing discards).
"""
from __future__ import annotations

from ..common.lockdep import DebugLock
from typing import Dict, List, Tuple

import numpy as np


class StagingPool:
    """Per-shape free lists of C-contiguous uint8 staging buffers."""

    def __init__(self, per_shape: int = 4):
        self._lock = DebugLock("MeshBufferPool::lock")
        self._free: Dict[Tuple[int, ...], List[np.ndarray]] = {}
        self._per_shape = max(int(per_shape), 1)
        self.hits = 0
        self.misses = 0

    def acquire(self, shape: Tuple[int, ...]) -> Tuple[np.ndarray, bool]:
        """-> (zeroed buffer, came_from_pool).  A fresh buffer is born
        zeroed (np.zeros); a reused one is memset back to zero here —
        a fill, not a data copy, so it never lands on the copy ledger
        (np.pad zeroed its pad lanes the same way on the old path)."""
        with self._lock:
            lst = self._free.get(tuple(shape))
            buf = lst.pop() if lst else None
        if buf is not None:
            buf.fill(0)
            with self._lock:
                self.hits += 1
            return buf, True
        with self._lock:
            self.misses += 1
        return np.zeros(shape, dtype=np.uint8), False

    def release(self, buf: np.ndarray) -> None:
        key = buf.shape
        with self._lock:
            lst = self._free.setdefault(key, [])
            if len(lst) < self._per_shape:
                lst.append(buf)

    def set_capacity(self, per_shape: int) -> None:
        with self._lock:
            self._per_shape = max(int(per_shape), 1)
            for lst in self._free.values():
                del lst[self._per_shape:]

    def clear(self) -> int:
        """Drop every pooled buffer; returns how many were released so
        the elastic-membership transition can account the staging
        memory a topology change returns to the allocator."""
        with self._lock:
            dropped = sum(len(lst) for lst in self._free.values())
            self._free.clear()
            self.hits = 0
            self.misses = 0
        return dropped

    def dump(self) -> Dict:
        with self._lock:
            return {
                "shapes": {str(list(k)): len(v)
                           for k, v in sorted(self._free.items())},
                "hits": self.hits,
                "misses": self.misses,
                "per_shape": self._per_shape,
            }
