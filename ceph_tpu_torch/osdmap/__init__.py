"""OSDMap of the port: pools, the scalar pg -> up/acting pipeline and the
whole-map batch mapping (``OSDMapMapping``) on the card's CRUSH mapper."""
from .types import (
    FLAG_EC_OVERWRITES, FLAG_HASHPSPOOL, TYPE_ERASURE, TYPE_REPLICATED,
    ceph_stable_mod, pg_pool_t, pg_t,
)
from .osdmap import (
    CEPH_OSD_DEFAULT_PRIMARY_AFFINITY, CEPH_OSD_IN, CEPH_OSD_OUT,
    Incremental, OSDMap, crush_memo,
)
from .mapping import OSDMapMapping, PoolMapping, pool_pps

__all__ = [
    "FLAG_EC_OVERWRITES", "FLAG_HASHPSPOOL", "TYPE_ERASURE",
    "TYPE_REPLICATED", "ceph_stable_mod", "pg_pool_t", "pg_t",
    "CEPH_OSD_DEFAULT_PRIMARY_AFFINITY", "CEPH_OSD_IN", "CEPH_OSD_OUT",
    "Incremental", "OSDMap", "OSDMapMapping", "PoolMapping", "pool_pps",
]
