"""Device-resident shard bodies.

Port of ``ceph_tpu/os_store/device_shard.py``.  A ``DeviceShard`` is a
shard body that never made the device->host trip: a 1-D uint8 tensor
on the card plus its length and the crc32c the fused encode computed
before any copy to the host (``ops/resident.py``).  The body is
materialized to host bytes lazily, on the first host read, so a write's
encode->store path moves no body bytes.

Residency is bounded: every live resident shard is registered with the
process-wide ``g_device_budget`` LRU.  When resident bytes exceed
``os_memstore_device_bytes_max`` (``common/config.py``; 0 = no limit)
the coldest shards are *demoted*: copied down to host bytes and dropped
from the card.  The budget holds weak references only, so a shard that
its owner discards releases its bytes without an unregister call.

Storage: the budget counts ``length`` bytes per shard, so a shard should
own its tensor's storage; then a demoted or dropped shard gives back
exactly what the budget subtracts.  ``ops/resident.py`` allocates every
body on its own for that reason.  A shard built on a view of a larger
tensor frees nothing until every other view of that storage is gone.

All state transitions (resident -> host) happen under the budget's one
lock, so ``materialize`` may race from scrub, read and eviction at once
and exactly one device->host copy happens.

Not carried from the JAX package: the devprof accounting of the copies
(``memstore.fetch_shard``, ``memstore.demote_shard``), which waits for
the port's trace layer.  The six counters keep their names and live in
the module-local ``Counters`` below.
"""
from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import torch

from ..common.config import g_conf

# ---- counters (the JAX package's memstore_device family, by name) -----------
l_msd_resident_bytes = "resident_bytes"     # gauge: resident shard bytes
l_msd_resident_shards = "resident_shards"   # gauge: resident shard count
l_msd_materializations = "materializations"  # lazy first host reads
l_msd_demotions = "demotions"               # budget-pressure demotions
l_msd_crc_device = "crc_device"             # digests from the device CRC
l_msd_crc_host = "crc_host"                 # digests hashed on host bytes
_COUNTERS = (l_msd_resident_bytes, l_msd_resident_shards,
             l_msd_materializations, l_msd_demotions, l_msd_crc_device,
             l_msd_crc_host)


class Counters:
    """Named u64 counters and gauges with ``inc`` / ``set`` / ``dump``."""

    def __init__(self, names):
        self._vals: Dict[str, int] = {n: 0 for n in names}
        self._lock = threading.Lock()

    def inc(self, name: str, by: int = 1) -> None:
        with self._lock:
            self._vals[name] += by

    def set(self, name: str, value: int) -> None:
        with self._lock:
            self._vals[name] = int(value)

    def get(self, name: str) -> int:
        with self._lock:
            return self._vals[name]

    def dump(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._vals)


_msd_pc = Counters(_COUNTERS)


def memstore_device_perf_counters() -> Counters:
    """The device-resident shard store's counters."""
    return _msd_pc


class DeviceShardBudget:
    """LRU byte budget over all live device-resident shards.

    Weak entries keyed by shard identity; ``weakref.finalize`` returns
    the bytes of shards their owner simply dropped.  Eviction collects
    victims under the lock and demotes them outside it (demotion
    re-enters the lock to transition the shard's state).
    """

    def __init__(self):
        # reentrant: a finalizer may run while this thread holds it
        self.lock = threading.RLock()
        # id(shard) -> (weakref, nbytes); insertion order = LRU order
        self._entries: "OrderedDict[int, Tuple[weakref.ref, int]]" = \
            OrderedDict()
        self._bytes = 0

    # -- gauges --------------------------------------------------------------
    def _publish_locked(self) -> None:
        pc = memstore_device_perf_counters()
        pc.set(l_msd_resident_bytes, self._bytes)
        pc.set(l_msd_resident_shards, len(self._entries))

    def resident_bytes(self) -> int:
        with self.lock:
            return self._bytes

    def resident_shards(self) -> int:
        with self.lock:
            return len(self._entries)

    # -- membership ----------------------------------------------------------
    def admit(self, shard: "DeviceShard") -> None:
        sid = id(shard)
        with self.lock:
            if sid not in self._entries:
                self._entries[sid] = (weakref.ref(shard), shard.length)
                self._bytes += shard.length
                self._publish_locked()
        weakref.finalize(shard, self._finalized, sid)
        self._evict_over_budget()

    def touch(self, shard: "DeviceShard") -> None:
        with self.lock:
            if id(shard) in self._entries:
                self._entries.move_to_end(id(shard))

    def _remove_locked(self, sid: int) -> None:
        ent = self._entries.pop(sid, None)
        if ent is not None:
            self._bytes -= ent[1]
            self._publish_locked()

    def _finalized(self, sid: int) -> None:
        with self.lock:
            ent = self._entries.get(sid)
            # the slot may have been recycled onto a live newcomer
            if ent is not None and ent[0]() is None:
                self._remove_locked(sid)

    # -- eviction ------------------------------------------------------------
    def _evict_over_budget(self) -> None:
        limit = int(g_conf.get_val("os_memstore_device_bytes_max"))
        if limit <= 0:
            return
        while True:
            with self.lock:
                if self._bytes <= limit or not self._entries:
                    return
                sid, (ref, _nb) = next(iter(self._entries.items()))
                victim = ref()
                if victim is None:
                    self._remove_locked(sid)
                    continue
            victim.demote()


g_device_budget = DeviceShardBudget()


class DeviceShard:
    """One shard body on the card: tensor + length + crc.

    ``bytes(shard)`` / ``len(shard)`` make it usable where host bytes
    are expected; the bytes() coercion is the lazy materialization.
    """

    __slots__ = ("_dev", "_host", "length", "crc", "__weakref__")

    def __init__(self, dev: torch.Tensor, length: int, crc: int):
        if dev.dim() != 1 or dev.dtype != torch.uint8 or \
                dev.numel() != int(length):
            raise ValueError(f"shard body must be a 1-D uint8 tensor of "
                             f"{length} bytes, got {tuple(dev.shape)} "
                             f"{dev.dtype}")
        self._dev: Optional[torch.Tensor] = dev
        self._host: Optional[bytes] = None
        self.length = int(length)
        self.crc = int(crc)
        g_device_budget.admit(self)

    @property
    def is_resident(self) -> bool:
        return self._host is None

    def __len__(self) -> int:
        return self.length

    def device_array(self) -> Optional[torch.Tensor]:
        """The live device tensor, or None once materialized/demoted."""
        return self._dev

    def _to_host_locked(self) -> bytes:
        host = self._dev.cpu().numpy().tobytes()
        assert len(host) == self.length
        self._host = host
        self._dev = None
        g_device_budget._remove_locked(id(self))
        return host

    def materialize(self) -> bytes:
        """Host bytes; the first call is the one device->host copy of
        this shard's life, later calls are free."""
        if self._host is not None:
            return self._host
        with g_device_budget.lock:
            if self._host is not None:
                return self._host
            host = self._to_host_locked()
        memstore_device_perf_counters().inc(l_msd_materializations)
        return host

    def __bytes__(self) -> bytes:
        return self.materialize()

    def demote(self) -> None:
        """Budget-pressure copy-down: the same transition as
        materialize, counted as a demotion."""
        if self._host is not None:
            return
        with g_device_budget.lock:
            if self._host is not None:
                return
            self._to_host_locked()
        memstore_device_perf_counters().inc(l_msd_demotions)

    def corrupted(self) -> "DeviceShard":
        """Flip the first body byte (fault injection: the stored crc goes
        stale, as bitrot would leave it).  The resident body is cloned
        first, so no other holder of the old tensor or of its storage
        sees the flip."""
        if self.length == 0:
            return self
        with g_device_budget.lock:
            if self._host is not None:
                rot = bytearray(self._host)
                rot[0] ^= 0x01
                self._host = bytes(rot)
            else:
                dev = self._dev.clone()
                dev[0] ^= 1
                self._dev = dev
        return self
