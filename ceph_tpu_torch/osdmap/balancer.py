"""calc_pg_upmaps — the upmap balancer.

Functional equivalent of OSDMap::calc_pg_upmaps (reference osd/OSDMap.h:1305,
used by `osdmaptool --upmap` and the mgr balancer module): iteratively move
PG replicas off the most-overfull OSD onto the most-underfull candidate via
pg_upmap_items entries, while respecting the rule's failure-domain
separation (the reference walks the rule via try_remap_rule,
CrushWrapper.h:1503; here candidates are constrained to unused failure
domains and every move is validated by actually re-running the mapping).

The port's own copy of ``ceph_tpu/osdmap/balancer.py``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from ..crush.constants import (
    CRUSH_ITEM_NONE, CRUSH_RULE_CHOOSELEAF_FIRSTN,
    CRUSH_RULE_CHOOSELEAF_INDEP, CRUSH_RULE_CHOOSE_FIRSTN,
    CRUSH_RULE_CHOOSE_INDEP,
)
from ..crush.types import ChooseArg, WeightSet
from .osdmap import Incremental, OSDMap
from .types import pg_t


def _failure_domain_type(osdmap: OSDMap, ruleno: int) -> int:
    rule = osdmap.crush.crush.rules[ruleno]
    for step in rule.steps:
        if step.op in (CRUSH_RULE_CHOOSELEAF_FIRSTN,
                       CRUSH_RULE_CHOOSELEAF_INDEP,
                       CRUSH_RULE_CHOOSE_FIRSTN, CRUSH_RULE_CHOOSE_INDEP):
            return step.arg2
    return 0


def _domain_of(osdmap: OSDMap, osd: int, dtype: int) -> int:
    """The ancestor bucket of type *dtype* containing *osd* (osd itself
    when the domain is the device)."""
    if dtype == 0:
        return osd
    cw = osdmap.crush
    item = osd
    seen = 0
    while seen < 16:
        seen += 1
        parent = None
        for b in cw.crush.buckets:
            if b is not None and item in b.items:
                parent = b
                break
        if parent is None:
            return item
        if parent.type == dtype:
            return parent.id
        item = parent.id
    return item


def calc_pg_upmaps(osdmap: OSDMap, max_deviation: float = 0.01,
                   max_iterations: int = 100,
                   pools: Optional[List[int]] = None,
                   inc: Optional[Incremental] = None) -> int:
    """Compute pg_upmap_items flattening the distribution.

    Delegates to the decision-identical port of the reference's
    OSDMap::calc_pg_upmaps (osdmap/upmap.py, pinned byte-for-byte to
    the recorded osdmaptool cram outputs by
    tests/test_osdmaptool_golden.py).  Results land in *inc* (and the
    map's pg_upmap_items for chained evaluation); returns the number
    of changes, like the reference.
    """
    from .upmap import PendingInc
    from .upmap import calc_pg_upmaps as _exact
    pi = PendingInc()
    n = _exact(osdmap, max_deviation, max_iterations,
               set(pools) if pools else None, pi)
    if inc is not None:
        inc.new_pg_upmap_items.update(pi.new_pg_upmap_items)
        inc.old_pg_upmap_items.extend(sorted(pi.old_pg_upmap_items))
    return n


# ---- crush-compat mode (per-position weight_set optimization) --------------

def _bucket_depths(cw) -> List[Tuple[int, object]]:
    """Buckets ordered leaf-most first: (depth-from-devices, bucket)."""
    m = cw.crush

    def depth(b) -> int:
        d = 1
        for it in b.items:
            if it < 0:
                sub = m.bucket(it)
                if sub is not None:
                    d = max(d, 1 + depth(sub))
        return d

    out = [(depth(b), b) for b in m.buckets if b is not None]
    out.sort(key=lambda t: t[0])
    return out


def calc_weight_set(osdmap: OSDMap, pool_id: int,
                    max_iterations: int = 30,
                    step: float = 0.4) -> Tuple[float, float]:
    """crush-compat balancer (pybind/mgr/balancer/module.py
    do_crush_compat): optimize a per-position ``weight_set``
    (crush.h:273 crush_choose_arg) so the pool's PG distribution
    flattens WITHOUT any pg_upmap entries — the mode for clients too
    old to decode upmaps.

    Leaf (device) weights in each position's set are nudged toward
    each osd's per-position placement target; interior buckets' entries
    re-aggregate their children.  The weight_set with the best overall
    stddev wins and is stored under the map's choose_args[pool_id].
    Returns (stddev_before, stddev_after) in PG-copy units.
    """
    pool = osdmap.pools[pool_id]
    cw = osdmap.crush
    m = cw.crush
    npos = pool.size
    # working weight sets: bucket id -> per-position weight lists,
    # seeded from the topology weights
    wsets: Dict[int, List[List[int]]] = {}
    for b in m.buckets:
        if b is not None:
            wsets[b.id] = [list(b.item_weights) for _ in range(npos)]

    def install(ws) -> None:
        args = [ChooseArg() for _ in range(len(m.buckets))]
        for bid, per_pos in ws.items():
            args[-1 - bid] = ChooseArg(
                weight_set=[WeightSet(weights=list(p))
                            for p in per_pos])
        m.choose_args[pool_id] = args

    def measure():
        counts = [dict() for _ in range(npos)]
        for ps in range(pool.pg_num):
            up, _ = osdmap.pg_to_raw_up(pg_t(pool_id, ps))
            for pos, o in enumerate(up):
                if o != CRUSH_ITEM_NONE and pos < npos:
                    counts[pos][o] = counts[pos].get(o, 0) + 1
        return counts

    def stddev(counts) -> float:
        total: Dict[int, int] = {}
        for c in counts:
            for o, n in c.items():
                total[o] = total.get(o, 0) + n
        osds = [o for o in range(osdmap.max_osd)
                if osdmap.exists(o) and osdmap.osd_weight[o] > 0]
        if not osds:
            return 0.0
        mean = sum(total.get(o, 0) for o in osds) / len(osds)
        return (sum((total.get(o, 0) - mean) ** 2
                    for o in osds) / len(osds)) ** 0.5

    # weight-proportional per-position targets from the TOPOLOGY
    leaf_w: Dict[int, int] = {}
    for b in m.buckets:
        if b is None:
            continue
        for it, w in zip(b.items, b.item_weights):
            if it >= 0:
                leaf_w[it] = w
    wsum = sum(leaf_w.values()) or 1

    baseline = measure()
    best_dev = before = stddev(baseline)
    best_ws = {bid: [list(p) for p in per]
               for bid, per in wsets.items()}
    counts = baseline
    depth_order = _bucket_depths(cw)    # topology-invariant
    for _ in range(max_iterations):
        copies = [sum(c.values()) for c in counts]
        for pos in range(npos):
            tgt = {o: copies[pos] * w / wsum for o, w in leaf_w.items()}
            for b in m.buckets:
                if b is None:
                    continue
                pp = wsets[b.id][pos]
                for i, it in enumerate(b.items):
                    if it < 0:
                        continue
                    actual = counts[pos].get(it, 0)
                    want = tgt.get(it, 0.0)
                    if want <= 0:
                        continue
                    factor = 1.0 + step * (want - actual) / max(want, 1.0)
                    pp[i] = max(1, int(pp[i] * factor))
        # interior buckets re-aggregate their children per position
        for _d, b in depth_order:
            for pos in range(npos):
                for i, it in enumerate(b.items):
                    if it < 0:
                        sub = m.bucket(it)
                        if sub is not None:
                            wsets[b.id][pos][i] = max(
                                1, sum(wsets[it][pos]))
        install(wsets)
        counts = measure()
        dev = stddev(counts)
        if dev < best_dev:
            best_dev = dev
            best_ws = {bid: [list(p) for p in per]
                       for bid, per in wsets.items()}
    install(best_ws)
    return before, best_dev
