"""OSDMap: the epoched cluster map and the pg→OSD mapping pipeline.

State and pipeline semantics mirror the reference (src/osd/OSDMap.{h,cc}):
osd up/exists flags, 16.16 in/out weights (OSDMap.h:512), primary affinity
(:516), pg_upmap / pg_upmap_items overrides (:519-520), pg_temp /
primary_temp, pools, and the embedded crush map.  The full per-PG pipeline
(_pg_to_raw_osds → _apply_upmap → _raw_to_up_osds → _pick_primary →
_apply_primary_affinity → _get_temp_osds, OSDMap.cc:1936-2185) is
implemented exactly; batch mapping lives in mapping.py where the crush
evaluation runs on the card's candidate-table mapper and the post-passes
vectorize.

Incremental diffs (OSDMap.h:393) carry new/changed state between epochs the
way the mon publishes them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..crush import CrushWrapper
from ..crush.constants import CRUSH_ITEM_NONE
from ..crush.hash import crush_hash32_2
from .types import pg_pool_t, pg_t

CEPH_OSD_IN = 0x10000
CEPH_OSD_OUT = 0
CEPH_OSD_MAX_PRIMARY_AFFINITY = 0x10000
CEPH_OSD_DEFAULT_PRIMARY_AFFINITY = 0x10000

# osd_state bits (include/rados.h)
CEPH_OSD_EXISTS = 1
CEPH_OSD_UP = 2


@dataclass
class Incremental:
    """Delta between epoch-1 and epoch (OSDMap.h:393-395 analog)."""
    epoch: int = 0
    new_max_osd: int = -1
    new_flags: int = -1        # cluster CEPH_OSDMAP_* flags; -1 = keep
    new_pools: Dict[int, pg_pool_t] = field(default_factory=dict)
    new_pool_names: Dict[int, str] = field(default_factory=dict)
    old_pools: List[int] = field(default_factory=list)
    new_up: Dict[int, bool] = field(default_factory=dict)       # osd -> up?
    new_weight: Dict[int, int] = field(default_factory=dict)
    # weight to restore if the osd boots after an AUTO out (replicated
    # like osd_xinfo_t::old_weight, osd/OSDMap.h; 0 = clear the memo)
    new_old_weight: Dict[int, int] = field(default_factory=dict)
    new_primary_affinity: Dict[int, int] = field(default_factory=dict)
    new_pg_upmap: Dict[pg_t, List[int]] = field(default_factory=dict)
    old_pg_upmap: List[pg_t] = field(default_factory=list)
    new_pg_upmap_items: Dict[pg_t, List[Tuple[int, int]]] = \
        field(default_factory=dict)
    old_pg_upmap_items: List[pg_t] = field(default_factory=list)
    new_pg_temp: Dict[pg_t, List[int]] = field(default_factory=dict)
    new_primary_temp: Dict[pg_t, int] = field(default_factory=dict)
    new_erasure_code_profiles: Dict[str, Dict[str, str]] = \
        field(default_factory=dict)
    crush: Optional[CrushWrapper] = None
    # mon-service payloads committed with the epoch (PaxosService
    # siblings sharing the one Paxos, src/mon/PaxosService.h): cluster
    # log entries (LogMonitor) and config-key mutations
    # (ConfigKeyService; value None = delete).  OSDMap consumers ignore
    # them — they are replicated mon state riding the same consensus.
    service_log: List[Tuple[float, str, str, str]] = \
        field(default_factory=list)          # (stamp, who, level, text)
    service_config_kv: Dict[str, Optional[str]] = \
        field(default_factory=dict)


# cluster-wide osdmap flags (include/rados.h:139-142)
CEPH_OSDMAP_NEARFULL = 1 << 0
CEPH_OSDMAP_FULL = 1 << 1
CEPH_OSDMAP_PAUSEWR = 1 << 3


class OSDMap:
    def __init__(self):
        self.epoch = 0
        self.flags = 0
        # map identity/stamps (OSDMap::print header fields); tools
        # built maps (osdmaptool --createsimple) keep the zero fsid
        # like the reference's zeroed uuid_d
        self.fsid = "00000000-0000-0000-0000-000000000000"
        self.created = 0.0
        self.modified = 0.0
        self.crush_version = 1
        self.max_osd = 0
        self.osd_state: List[int] = []
        self.osd_weight: List[int] = []
        self.osd_primary_affinity: Optional[List[int]] = None
        self.pools: Dict[int, pg_pool_t] = {}
        self.pool_name: Dict[int, str] = {}
        self.pool_max = -1
        self.pg_upmap: Dict[pg_t, List[int]] = {}
        self.pg_upmap_items: Dict[pg_t, List[Tuple[int, int]]] = {}
        self.pg_temp: Dict[pg_t, List[int]] = {}
        self.primary_temp: Dict[pg_t, int] = {}
        # osd -> weight before an automatic out (osd_xinfo_t::old_weight):
        # lives in the map so every mon agrees across failovers
        self.osd_old_weight: Dict[int, int] = {}
        self.erasure_code_profiles: Dict[str, Dict[str, str]] = {}
        self.crush = CrushWrapper()

    # ---- osd state --------------------------------------------------------
    def set_max_osd(self, n: int) -> None:
        while len(self.osd_state) < n:
            self.osd_state.append(0)
            self.osd_weight.append(CEPH_OSD_OUT)
            if self.osd_primary_affinity is not None:
                self.osd_primary_affinity.append(
                    CEPH_OSD_DEFAULT_PRIMARY_AFFINITY)
        del self.osd_state[n:]
        del self.osd_weight[n:]
        self.max_osd = n
        if self.crush.get_max_devices() < n:
            self.crush.set_max_devices(n)

    def exists(self, osd: int) -> bool:
        return (0 <= osd < self.max_osd
                and bool(self.osd_state[osd] & CEPH_OSD_EXISTS))

    def is_up(self, osd: int) -> bool:
        return (0 <= osd < self.max_osd
                and bool(self.osd_state[osd] & CEPH_OSD_UP))

    def is_down(self, osd: int) -> bool:
        return not self.is_up(osd)

    def is_in(self, osd: int) -> bool:
        return self.exists(osd) and self.get_weight(osd) > 0

    def is_out(self, osd: int) -> bool:
        return not self.is_in(osd)

    def get_weight(self, osd: int) -> int:
        return self.osd_weight[osd]

    def set_osd(self, osd: int, up: bool = True,
                weight: int = CEPH_OSD_IN) -> None:
        """Create/refresh an osd entry (test/mini-cluster convenience)."""
        if osd >= self.max_osd:
            self.set_max_osd(osd + 1)
        self.osd_state[osd] = CEPH_OSD_EXISTS | (CEPH_OSD_UP if up else 0)
        self.osd_weight[osd] = weight

    def set_primary_affinity(self, osd: int, aff: int) -> None:
        if self.osd_primary_affinity is None:
            self.osd_primary_affinity = \
                [CEPH_OSD_DEFAULT_PRIMARY_AFFINITY] * self.max_osd
        self.osd_primary_affinity[osd] = aff

    # ---- pools ------------------------------------------------------------
    def add_pool(self, name: str, pool: pg_pool_t,
                 pool_id: int = -1) -> int:
        if pool_id < 0:
            self.pool_max += 1
            pool_id = self.pool_max
        else:
            self.pool_max = max(self.pool_max, pool_id)
        self.pools[pool_id] = pool
        self.pool_name[pool_id] = name
        return pool_id

    def get_pg_pool(self, pool_id: int) -> Optional[pg_pool_t]:
        return self.pools.get(pool_id)

    def lookup_pg_pool_name(self, name: str) -> int:
        for pid, n in self.pool_name.items():
            if n == name:
                return pid
        return -2  # -ENOENT

    # ---- object → pg ------------------------------------------------------
    def map_to_pg(self, pool_id: int, name: str, key: str = "",
                  nspace: str = "") -> pg_t:
        pool = self.pools[pool_id]
        ps = pool.hash_key(key if key else name, nspace)
        return pg_t(pool_id, ps)

    object_locator_to_pg = map_to_pg

    # ---- pg → osds pipeline (OSDMap.cc:1936-2185) -------------------------
    def _pg_to_raw_osds(self, pool: pg_pool_t, pg: pg_t
                        ) -> Tuple[List[int], int]:
        pps = pool.raw_pg_to_pps(pg)
        size = pool.size
        ruleno = self.crush.find_rule(pool.crush_rule, pool.type, size)
        osds: List[int] = []
        if ruleno >= 0:
            osds = self.crush.do_rule(
                ruleno, pps, size, self.osd_weight,
                choose_args_index=pg.pool
                if pg.pool in self.crush.crush.choose_args else None)
        self._remove_nonexistent_osds(pool, osds)
        return osds, pps

    def _remove_nonexistent_osds(self, pool: pg_pool_t,
                                 osds: List[int]) -> None:
        if pool.can_shift_osds():
            osds[:] = [o for o in osds if self.exists(o)]
        else:
            for i, o in enumerate(osds):
                if o != CRUSH_ITEM_NONE and not self.exists(o):
                    osds[i] = CRUSH_ITEM_NONE

    def _apply_upmap(self, pool: pg_pool_t, raw_pg: pg_t,
                     raw: List[int]) -> List[int]:
        pg = pool.raw_pg_to_pg(raw_pg)
        p = self.pg_upmap.get(pg)
        if p is not None:
            if any(o != CRUSH_ITEM_NONE and 0 <= o < self.max_osd
                   and self.osd_weight[o] == 0 for o in p):
                # an explicit target is marked out: ignore the whole
                # override, including any pg_upmap_items (OSDMap.cc:1971)
                return raw
            raw = list(p)
        q = self.pg_upmap_items.get(pg)
        if q is not None:
            for frm, to in q:
                exists = False
                pos = -1
                for i, o in enumerate(raw):
                    if o == to:
                        exists = True
                        break
                    if (o == frm and pos < 0
                            and not (to != CRUSH_ITEM_NONE
                                     and 0 <= to < self.max_osd
                                     and self.osd_weight[to] == 0)):
                        pos = i
                if not exists and pos >= 0:
                    raw[pos] = to
        return raw

    def _raw_to_up_osds(self, pool: pg_pool_t,
                        raw: List[int]) -> List[int]:
        if pool.can_shift_osds():
            return [o for o in raw if self.exists(o) and self.is_up(o)]
        return [o if (o != CRUSH_ITEM_NONE and self.exists(o)
                      and self.is_up(o)) else CRUSH_ITEM_NONE
                for o in raw]

    @staticmethod
    def _pick_primary(osds: List[int]) -> int:
        for o in osds:
            if o != CRUSH_ITEM_NONE:
                return o
        return -1

    def _apply_primary_affinity(self, seed: int, pool: pg_pool_t,
                                osds: List[int], primary: int
                                ) -> Tuple[List[int], int]:
        aff = self.osd_primary_affinity
        if aff is None:
            return osds, primary
        if not any(o != CRUSH_ITEM_NONE
                   and aff[o] != CEPH_OSD_DEFAULT_PRIMARY_AFFINITY
                   for o in osds):
            return osds, primary
        pos = -1
        for i, o in enumerate(osds):
            if o == CRUSH_ITEM_NONE:
                continue
            a = aff[o]
            if (a < CEPH_OSD_MAX_PRIMARY_AFFINITY
                    and (crush_hash32_2(seed, o) >> 16) >= a):
                # rejected as primary; remember as fallback
                if pos < 0:
                    pos = i
            else:
                pos = i
                break
        if pos < 0:
            return osds, primary
        primary = osds[pos]
        if pool.can_shift_osds() and pos > 0:
            osds = [primary] + osds[:pos] + osds[pos + 1:]
        return osds, primary

    def _get_temp_osds(self, pool: pg_pool_t, raw_pg: pg_t
                       ) -> Tuple[List[int], int]:
        pg = pool.raw_pg_to_pg(raw_pg)
        temp_pg: List[int] = []
        p = self.pg_temp.get(pg)
        if p is not None:
            for o in p:
                if not self.exists(o) or self.is_down(o):
                    if not pool.can_shift_osds():
                        temp_pg.append(CRUSH_ITEM_NONE)
                else:
                    temp_pg.append(o)
        temp_primary = self.primary_temp.get(pg, -1)
        if temp_primary == -1 and temp_pg:
            temp_primary = self._pick_primary(temp_pg)
        return temp_pg, temp_primary

    def pg_to_raw_osds(self, pg: pg_t) -> Tuple[List[int], int]:
        pool = self.get_pg_pool(pg.pool)
        if pool is None:
            return [], -1
        raw, _ = self._pg_to_raw_osds(pool, pg)
        return raw, self._pick_primary(raw)

    def pg_to_raw_up(self, pg: pg_t) -> Tuple[List[int], int]:
        pool = self.get_pg_pool(pg.pool)
        if pool is None:
            return [], -1
        raw, pps = self._pg_to_raw_osds(pool, pg)
        raw = self._apply_upmap(pool, pg, raw)
        up = self._raw_to_up_osds(pool, raw)
        primary = self._pick_primary(raw)
        up, primary = self._apply_primary_affinity(pps, pool, up, primary)
        return up, primary

    def pg_to_up_acting_osds(self, pg: pg_t
                             ) -> Tuple[List[int], int, List[int], int]:
        """Returns (up, up_primary, acting, acting_primary)
        (OSDMap.cc:2154-2185)."""
        pool = self.get_pg_pool(pg.pool)
        if pool is None or pg.ps >= pool.pg_num:
            return [], -1, [], -1
        acting, acting_primary = self._get_temp_osds(pool, pg)
        raw, pps = self._pg_to_raw_osds(pool, pg)
        raw = self._apply_upmap(pool, pg, raw)
        up = self._raw_to_up_osds(pool, raw)
        up_primary = self._pick_primary(up)
        up, up_primary = self._apply_primary_affinity(
            pps, pool, up, up_primary)
        if not acting:
            acting = up
            if acting_primary == -1:
                acting_primary = up_primary
        return up, up_primary, acting, acting_primary

    # ---- epochs -----------------------------------------------------------
    def apply_incremental(self, inc: Incremental) -> None:
        assert inc.epoch == self.epoch + 1, (inc.epoch, self.epoch)
        self.epoch = inc.epoch
        if inc.new_flags >= 0:
            self.flags = inc.new_flags
        if inc.new_max_osd >= 0:
            self.set_max_osd(inc.new_max_osd)
        for pid in inc.old_pools:
            self.pools.pop(pid, None)
            self.pool_name.pop(pid, None)
        for pid, pool in inc.new_pools.items():
            self.pools[pid] = pool
            self.pool_max = max(self.pool_max, pid)
        for pid, name in inc.new_pool_names.items():
            self.pool_name[pid] = name
        for osd, up in inc.new_up.items():
            st = self.osd_state[osd] | CEPH_OSD_EXISTS
            self.osd_state[osd] = (st | CEPH_OSD_UP) if up \
                else (st & ~CEPH_OSD_UP)
        for osd, w in inc.new_weight.items():
            if osd >= self.max_osd:
                self.set_max_osd(osd + 1)
            self.osd_state[osd] |= CEPH_OSD_EXISTS
            self.osd_weight[osd] = w
        for osd, w in inc.new_old_weight.items():
            if w:
                self.osd_old_weight[osd] = w
            else:
                self.osd_old_weight.pop(osd, None)
        for osd, a in inc.new_primary_affinity.items():
            self.set_primary_affinity(osd, a)
        for pg in inc.old_pg_upmap:
            self.pg_upmap.pop(pg, None)
        self.pg_upmap.update(inc.new_pg_upmap)
        for pg in inc.old_pg_upmap_items:
            self.pg_upmap_items.pop(pg, None)
        self.pg_upmap_items.update(inc.new_pg_upmap_items)
        for pg, osds in inc.new_pg_temp.items():
            if osds:
                self.pg_temp[pg] = list(osds)
            else:
                self.pg_temp.pop(pg, None)
        for pg, p in inc.new_primary_temp.items():
            if p >= 0:
                self.primary_temp[pg] = p
            else:
                self.primary_temp.pop(pg, None)
        self.erasure_code_profiles.update(inc.new_erasure_code_profiles)
        if inc.crush is not None:
            self.crush = inc.crush
