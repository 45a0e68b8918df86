"""HitSet — per-PG access tracking for the cache-tier agent.

The reference records object accesses in periodically-rotated bloom
filters (src/osd/HitSet.h BloomHitSet; hit_set_setup / hit_set_persist
in PrimaryLogPG.cc): the agent asks "was this object touched in the
last N periods?" to decide flush/evict temperature.  Same design here:
a fixed-width bloom with rjenkins-derived probes, a deque of sealed
sets, and a combined containment query.

The port's own copy of ``ceph_tpu/osd/hit_set.py``.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Iterable

from ..utils.str_hash import ceph_str_hash_rjenkins

_BITS = 1 << 12            # 4096-bit filter: ample for test-scale PGs
_PROBES = 4


class BloomHitSet:
    def __init__(self):
        self.bits = 0
        self.inserts = 0

    def _probes(self, name: str) -> Iterable[int]:
        h1 = ceph_str_hash_rjenkins(name)
        h2 = ceph_str_hash_rjenkins(name + "\x01")
        for i in range(_PROBES):
            yield (h1 + i * h2) % _BITS

    def insert(self, name: str) -> None:
        for p in self._probes(name):
            self.bits |= 1 << p
        self.inserts += 1

    def contains(self, name: str) -> bool:
        return all(self.bits >> p & 1 for p in self._probes(name))

    def encode(self) -> bytes:
        return self.bits.to_bytes(_BITS // 8, "little")

    @classmethod
    def decode(cls, blob: bytes) -> "BloomHitSet":
        hs = cls()
        hs.bits = int.from_bytes(blob, "little")
        return hs


class HitSetHistory:
    """Current open set + up to *count* sealed predecessors."""

    def __init__(self, count: int = 4):
        self.count = count
        self.current = BloomHitSet()
        self.sealed: Deque[BloomHitSet] = deque(maxlen=max(count, 1))
        self.last_rotate = 0.0

    def record(self, name: str) -> None:
        self.current.insert(name)

    def rotate(self, now: float) -> None:
        """Seal the open set (hit_set_persist role)."""
        self.sealed.append(self.current)
        self.current = BloomHitSet()
        self.last_rotate = now

    def maybe_rotate(self, now: float, period: float) -> None:
        if now - self.last_rotate >= period:
            self.rotate(now)

    def contains(self, name: str) -> bool:
        if self.current.contains(name):
            return True
        return any(hs.contains(name) for hs in self.sealed)
