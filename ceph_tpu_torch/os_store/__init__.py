"""Object stores of the port: ``MemStore`` (device-resident shard
bodies as ``DeviceShard`` handles), ``WALStore`` (the journaled,
file-backed store) and the residency budget."""
from .device_shard import (DeviceShard, g_device_budget,
                           memstore_device_perf_counters)
from .memstore import MemStore, Transaction, hobject_t
from .walstore import WALStore, mount_store

__all__ = ["MemStore", "Transaction", "hobject_t", "WALStore",
           "mount_store", "DeviceShard", "g_device_budget",
           "memstore_device_perf_counters"]


def parse_pg_from_cid(cid: str):
    """(pool, ps) from a PG collection name, or None for non-PG
    collections (the 'meta' map-history collection, malformed names).
    Collection grammar: "{pool}.{ps}[s{shard}][_meta]" — THE one
    parser shared by the OSD's stray scan and the offline tools."""
    body = cid[:-5] if cid.endswith("_meta") else cid
    tail = body.split(".")[-1]
    if "s" in tail:
        body = body[:body.rindex("s")]
    try:
        pool_s, ps_s = body.split(".")
        return int(pool_s), int(ps_s)
    except ValueError:
        return None
