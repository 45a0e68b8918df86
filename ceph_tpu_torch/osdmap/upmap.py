"""pg-upmap optimizer — semantics-exact port of OSDMap::calc_pg_upmaps.

The reference balancer's upmap mode (src/osd/OSDMap.cc:3926, driven by
`osdmaptool --upmap` and mgr/balancer) iteratively finds the fullest
OSD whose deviation ratio exceeds the threshold and retargets ONE of
its PGs onto underfull OSDs via the constrained rule re-mapper
(crush/remap.py), restarting until nothing exceeds the threshold or
``max`` changes were made.

Decision-identical with the reference, which requires care beyond the
algorithm's shape:
  - float32 arithmetic for weights/targets/deviations (the reference
    uses C ``float``; threshold comparisons sit exactly on boundaries);
  - map/set orderings: pgs ascend (pool, seed); osds ascend;
    deviation ties break by ascending osd, and the fullest-first scan
    visits equal deviations in DESCENDING osd order (C++ multimap
    rbegin reverses insertion order within equal keys);
  - ``orig`` comes from the RAW mapping (no upmaps applied), while the
    per-iteration PG counts come from the upmap-applied ``up`` sets.

Byte-exact agreement with the reference's recorded `osdmaptool
--upmap` output is pinned by tests/test_osdmaptool_golden.py.

The port's own copy of ``ceph_tpu/osdmap/upmap.py``.  Its raw mapping
takes the native library's mapper, or the host ``crush_do_rule`` when the
caller asks for the host: one route, chosen before it runs, and no
fallback between them.  The loop keeps the reference's decisions and
float32 arithmetic; what does not change between its rounds is computed
once.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..crush.remap import get_rule_weight_osd_map, try_remap_rule
from ..native import NativeCrushMapper
from .osdmap import OSDMap
from .types import pg_t

NONE = 0x7FFFFFFF
F = np.float32


class PendingInc:
    """The slice of OSDMap::Incremental calc_pg_upmaps fills."""

    def __init__(self):
        self.new_pg_upmap_items: Dict[pg_t, List[Tuple[int, int]]] = {}
        self.old_pg_upmap_items: Set[pg_t] = set()


def _raw_all(m: OSDMap, pool_id: int, pool,
             host_mapper: bool = False) -> List[List[int]]:
    """RAW mapping (no upmaps) for every pg of the pool (the
    per-iteration loop only overlays upmap items on top of this, so it
    is computed once).  The batch goes through the native library's
    mapper, or, when the caller asks for the host (``host_mapper``),
    through ``crush_do_rule``; the route is chosen here, before any pg
    is mapped, and a failure of either raises."""
    size = pool.size
    ruleno = m.crush.find_rule(pool.crush_rule, pool.type, size)
    if ruleno < 0:
        return [[] for _ in range(pool.pg_num)]
    pps = [pool.raw_pg_to_pps(pg_t(pool_id, ps))
           for ps in range(pool.pg_num)]
    choose_args = m.crush.crush.choose_args.get(pool_id)
    if host_mapper:
        rows = [m.crush.do_rule(ruleno, x, size, m.osd_weight,
                                choose_args_index=pool_id
                                if choose_args is not None else None)
                for x in pps]
    else:
        nm = NativeCrushMapper(m.crush.crush, choose_args)
        out, lens = nm.do_rule_batch(ruleno, pps, size, m.osd_weight)
        rows = [row[:n] for row, n in zip(out.tolist(), lens.tolist())]
    for row in rows:
        m._remove_nonexistent_osds(pool, row)
    return rows


def try_pg_upmap(m: OSDMap, pg: pg_t, overfull: Set[int],
                 underfull: Sequence[int],
                 raw: Sequence[int]
                 ) -> Optional[Tuple[List[int], List[int]]]:
    """(OSDMap::try_pg_upmap)  ``raw`` is the pg's raw mapping
    (caller-cached _pg_to_raw_osds result).  Returns (orig, out) or
    None when no useful remap exists."""
    pool = m.get_pg_pool(pg.pool)
    if pool is None:
        return None
    rule = m.crush.find_rule(pool.crush_rule, pool.type, pool.size)
    if rule < 0:
        return None
    orig = list(raw)
    if not any(o in overfull for o in orig):
        return None
    out = try_remap_rule(m.crush, rule, pool.size, overfull, underfull,
                         orig)
    if out is None or out == orig:
        return None
    return orig, out


def calc_pg_upmaps(m: OSDMap, max_deviation_ratio: float, max: int,
                   only_pools: Optional[Set[int]] = None,
                   pending_inc: Optional[PendingInc] = None,
                   host_mapper: bool = False) -> int:
    """(OSDMap::calc_pg_upmaps)  Mutates ``m``'s pg_upmap_items like
    the reference mutates its tmp copy; returns changes made.  The raw
    mapping is the native library's unless ``host_mapper``.

    Nothing the loop reads but the upmap items changes inside it, so
    the up sets of pgs without upmap items, the pools' pgs and the
    float32 osd weights are computed once, before the first round,
    with the same operations in the same order."""
    if pending_inc is None:
        pending_inc = PendingInc()
    if not only_pools:
        only_pools = set(m.pools.keys())
    max_dev = F(max_deviation_ratio)

    raw_cache: Dict[int, List[List[int]]] = {}
    for pool_id in sorted(only_pools):
        pool = m.pools.get(pool_id)
        if pool is not None:
            raw_cache[pool_id] = _raw_all(m, pool_id, pool, host_mapper)

    pools = [pid for pid in sorted(m.pools.keys()) if pid in only_pools]
    pool_pgs: Dict[int, List[pg_t]] = {}
    up_cache: Dict[int, List[List[int]]] = {}
    total_pgs = 0
    osd_weight_total = F(0.0)
    osd_weight: Dict[int, F] = {}
    for pool_id in pools:
        pool = m.pools[pool_id]
        pool_pgs[pool_id] = [pg_t(pool_id, ps)
                             for ps in range(pool.pg_num)]
        # the reference counts UP sets (pg_to_up_acting_osds):
        # down/nonexistent osds must not accumulate pgs
        up_cache[pool_id] = [
            [o for o in m._raw_to_up_osds(pool, list(row)) if o != NONE]
            for row in raw_cache[pool_id]]
        total_pgs += pool.size * pool.pg_num

        ruleno = m.crush.find_rule(pool.crush_rule, pool.type,
                                   pool.size)
        # no matching rule -> empty weight map (the reference's
        # unsigned-index ENOENT), while total_pgs still counted
        pmap = get_rule_weight_osd_map(m.crush, ruleno) \
            if ruleno >= 0 else {}
        for osd in sorted(pmap):
            # get_weightf: 16.16 in/out weight as C float
            wf = F(F(m.osd_weight[osd]) / F(0x10000)) \
                if 0 <= osd < m.max_osd else F(0.0)
            adjusted = F(wf * F(pmap[osd]))
            osd_weight[osd] = F(osd_weight.get(osd, F(0.0))
                                + adjusted)
            osd_weight_total = F(osd_weight_total + adjusted)

    num_changed = 0
    while True:
        pgs_by_osd: Dict[int, List[pg_t]] = {}
        upmapped_ps: Dict[int, Set[int]] = {}
        for pg in list(m.pg_upmap) + list(m.pg_upmap_items):
            upmapped_ps.setdefault(pg.pool, set()).add(pg.ps)
        for pool_id in pools:
            pool = m.pools[pool_id]
            raws = raw_cache[pool_id]
            ups = up_cache[pool_id]
            pgs = pool_pgs[pool_id]
            upmapped = upmapped_ps.get(pool_id, ())
            for ps in range(pool.pg_num):
                pg = pgs[ps]
                if ps in upmapped:
                    row = m._apply_upmap(pool, pg, list(raws[ps]))
                    up = [o for o in m._raw_to_up_osds(pool, list(row))
                          if o != NONE]
                else:
                    up = ups[ps]
                for o in up:
                    if o in pgs_by_osd:
                        pgs_by_osd[o].append(pg)
                    else:
                        pgs_by_osd[o] = [pg]
        for osd in sorted(osd_weight):
            pgs_by_osd.setdefault(osd, [])

        if osd_weight_total == 0:
            break
        pgs_per_weight = F(F(total_pgs) / osd_weight_total)

        # deviation per osd; multimap<float,int> == stable sort by
        # deviation over ascending-osd insertion order
        osd_deviation: Dict[int, F] = {}
        deviation_osd: List[Tuple[F, int]] = []
        overfull: Set[int] = set()
        for osd in sorted(pgs_by_osd):
            target = F(F(osd_weight.get(osd, F(0.0))) * pgs_per_weight)
            deviation = F(F(len(pgs_by_osd[osd])) - target)
            osd_deviation[osd] = deviation
            deviation_osd.append((deviation, osd))
            if float(deviation) >= 1.0:
                overfull.add(osd)
        deviation_osd.sort(key=lambda t: float(t[0]))  # stable

        underfull: List[int] = []
        for dev, osd in deviation_osd:
            if float(dev) >= -0.999:
                break
            underfull.append(osd)
        if not overfull or not underfull:
            break

        # fullest first; reversed(stable sort) == multimap rbegin
        # (equal deviations visited in descending osd order)
        restart = False
        for dev, osd in reversed(deviation_osd):
            target = F(F(osd_weight.get(osd, F(0.0))) * pgs_per_weight)
            assert target > 0
            if F(dev / target) < max_dev:
                break
            num_to_move = int(dev)       # trunc toward zero
            if num_to_move < 1:
                break

            pgs = pgs_by_osd[osd]        # ascending (pool, seed)

            # drop an existing remap that lands on this overfull osd
            for pg in pgs:
                items = m.pg_upmap_items.get(pg)
                if items is not None:
                    for _frm, to in items:
                        if to == osd:
                            del m.pg_upmap_items[pg]
                            pending_inc.old_pg_upmap_items.add(pg)
                            num_changed += 1
                            restart = True
                            break   # entry gone; scanning on would
                            #         re-delete (the reference erases
                            #         mid-iteration, which is UB there)
                if restart:
                    break
            if restart:
                break

            for pg in pgs:
                if pg in m.pg_upmap or pg in m.pg_upmap_items:
                    continue
                r = try_pg_upmap(m, pg, overfull, underfull,
                                 raw_cache[pg.pool][pg.ps])
                if r is None:
                    continue
                orig, out = r
                if len(orig) != len(out):
                    continue
                assert orig != out
                rmi = [(orig[i], out[i]) for i in range(len(out))
                       if orig[i] != out[i]]
                m.pg_upmap_items[pg] = rmi
                pending_inc.new_pg_upmap_items[pg] = list(rmi)
                restart = True
                num_changed += 1
                break
            if restart:
                break

        if not restart:
            break
        max -= 1
        if max == 0:
            break
    return num_changed
