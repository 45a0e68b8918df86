"""Cluster-map value types: pg_t and pg_pool_t.

Semantics mirror the reference types (src/osd/osd_types.{h,cc}): a PG is
(pool, ps); a pool carries the placement parameters — pg_num/pgp_num with
their power-of-two masks for ceph_stable_mod splitting (osd_types.cc:1250),
the crush rule, replica/EC sizing, and the hashpspool seed-mixing flag
(osd_types.cc:1412-1427).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

from ..crush.hash import crush_hash32_2
from ..crush.constants import (
    CRUSH_HASH_RJENKINS1, PG_POOL_TYPE_ERASURE, PG_POOL_TYPE_REPLICATED,
)
from ..utils.str_hash import CEPH_STR_HASH_RJENKINS, ceph_str_hash

TYPE_REPLICATED = PG_POOL_TYPE_REPLICATED
TYPE_ERASURE = PG_POOL_TYPE_ERASURE

FLAG_HASHPSPOOL = 1 << 0
FLAG_FULL = 1 << 1            # pool is full (osd_types.h:1148)
FLAG_FULL_QUOTA = 1 << 10     # full because quota exceeded (:1157)
FLAG_NEARFULL = 1 << 11       # pool is nearfull (:1158)
FLAG_EC_OVERWRITES = 1 << 17


def ceph_stable_mod(x: int, b: int, bmask: int) -> int:
    """Stable modulo under pg_num growth (include/rados.h:84-90)."""
    if (x & bmask) < b:
        return x & bmask
    return x & (bmask >> 1)


@dataclass(frozen=True, order=True)
class pg_t:
    pool: int
    ps: int

    def __str__(self) -> str:
        return f"{self.pool}.{self.ps:x}"


@dataclass
class pg_pool_t:
    type: int = TYPE_REPLICATED
    size: int = 3
    min_size: int = 2
    crush_rule: int = 0
    object_hash: int = CEPH_STR_HASH_RJENKINS
    pg_num: int = 8
    pgp_num: int = 8
    flags: int = FLAG_HASHPSPOOL
    last_change: int = 0
    erasure_code_profile: str = ""
    stripe_width: int = 0
    # enabled application (pg_pool_t application_metadata keys; the
    # default pool carries "rbd")
    application: str = ""
    # pool snapshots (pg_pool_t snaps/snap_seq, osd_types.h): snap id ->
    # name; removed ids accumulate so PGs can trim clones
    snap_seq: int = 0
    snaps: Dict[int, str] = field(default_factory=dict)
    removed_snaps: List[int] = field(default_factory=list)
    # self-managed (unmanaged) snap mode: ids are allocated by the mon but
    # snapshots exist only in client-supplied SnapContexts (librbd-style;
    # pg_pool_t::is_unmanaged_snaps_mode, osd_types.h).  A pool commits to
    # one mode on first use; mixing is refused like the reference does.
    selfmanaged: bool = False
    # pool quotas (pg_pool_t quota_max_*, "osd pool set-quota"): 0 =
    # unlimited; the mgr sets FLAG_FULL_QUOTA|FLAG_FULL when exceeded
    quota_max_objects: int = 0
    quota_max_bytes: int = 0

    def live_snaps(self) -> set:
        """Snap ids that may still be referenced — the trim liveness
        set.  Pool mode: the named snaps.  Selfmanaged mode: every
        allocated-and-not-removed id (any client's snapc may cite it,
        so only removal makes a clone garbage); cached because clone
        writes consult this per mutation and snap_seq only grows."""
        if not self.selfmanaged:
            return set(self.snaps)
        key = (self.snap_seq, len(self.removed_snaps))
        cached = getattr(self, "_live_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        live = set(range(1, self.snap_seq + 1)) - set(self.removed_snaps)
        object.__setattr__(self, "_live_cache", (key, live))
        return live
    # cache tiering (pg_pool_t tier fields, osd_types.h): a BASE pool
    # gains read_tier/write_tier redirects; the CACHE pool records
    # tier_of + agent/hit-set knobs (HitSet.h; OSDMonitor "osd tier")
    tier_of: int = -1            # base pool id (set on the cache pool)
    read_tier: int = -1          # cache pool id (set on the base pool)
    write_tier: int = -1
    cache_mode: str = ""         # "writeback" (the implemented mode)
    hit_set_period: float = 60.0
    hit_set_count: int = 4
    target_max_objects: int = 0  # 0 = no eviction pressure
    pg_num_mask: int = field(default=0, repr=False)
    pgp_num_mask: int = field(default=0, repr=False)

    def __post_init__(self):
        self.calc_pg_masks()

    def calc_pg_masks(self) -> None:
        self.pg_num_mask = (1 << (self.pg_num - 1).bit_length()) - 1
        self.pgp_num_mask = (1 << (self.pgp_num - 1).bit_length()) - 1

    def set_pg_num(self, n: int) -> None:
        self.pg_num = n
        self.calc_pg_masks()

    def set_pgp_num(self, n: int) -> None:
        self.pgp_num = n
        self.calc_pg_masks()

    def is_replicated(self) -> bool:
        return self.type == TYPE_REPLICATED

    def is_erasure(self) -> bool:
        return self.type == TYPE_ERASURE

    def can_shift_osds(self) -> bool:
        """Replicated pools compact holes; EC pools keep positional NONEs
        (osd_types.h:1506-1515)."""
        return self.type == TYPE_REPLICATED

    def has_flag(self, f: int) -> bool:
        return bool(self.flags & f)

    def allows_ecoverwrites(self) -> bool:
        return self.has_flag(FLAG_EC_OVERWRITES)

    # ---- placement math ---------------------------------------------------
    def hash_key(self, key: str, ns: str = "") -> int:
        if not ns:
            return ceph_str_hash(self.object_hash, key)
        buf = ns.encode() + b"\x1f" + key.encode()
        return ceph_str_hash(self.object_hash, buf)

    def raw_pg_to_pg(self, pg: pg_t) -> pg_t:
        return pg_t(pg.pool, ceph_stable_mod(pg.ps, self.pg_num,
                                             self.pg_num_mask))

    def raw_pg_to_pps(self, pg: pg_t) -> int:
        """Placement seed: pool-salted when hashpspool (osd_types.cc:1412)."""
        if self.flags & FLAG_HASHPSPOOL:
            return crush_hash32_2(
                ceph_stable_mod(pg.ps, self.pgp_num, self.pgp_num_mask),
                pg.pool)
        return ceph_stable_mod(pg.ps, self.pgp_num, self.pgp_num_mask) \
            + pg.pool
