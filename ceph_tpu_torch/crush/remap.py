"""CRUSH constrained re-mapping — the upmap balancer's search engine.

Semantics-exact port of the reference's CrushWrapper remap helpers
(src/crush/CrushWrapper.cc): ``try_remap_rule`` walks a rule's steps
over an EXISTING mapping and swaps overfull devices for underfull ones
while preserving every placement constraint the rule encodes (failure
domains stay distinct, replacements stay inside the same take subtree,
intermediate buckets with overfull-but-unswappable leaves are replaced
by peers that do have underfull capacity).  ``OSDMap.calc_pg_upmaps``
drives it; byte-exact agreement with the reference's recorded
osdmaptool output is pinned by tests/test_osdmaptool_golden.py.

The port's own copy of ``ceph_tpu/crush/remap.py``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

from .constants import (
    CRUSH_RULE_CHOOSELEAF_FIRSTN, CRUSH_RULE_CHOOSELEAF_INDEP,
    CRUSH_RULE_CHOOSE_FIRSTN, CRUSH_RULE_CHOOSE_INDEP, CRUSH_RULE_EMIT,
    CRUSH_RULE_TAKE,
)


def get_parent_of_type(cw, item: int, type: int) -> int:
    """First ancestor bucket of *type* above *item*; 0 when orphaned
    (CrushWrapper::get_parent_of_type)."""
    while True:
        p = cw._parent_of(item)
        if p is None:
            return 0
        item = p.id
        if cw.crush.bucket(item).type == type:
            return item


def subtree_contains(cw, root: int, item: int) -> bool:
    """(CrushWrapper::subtree_contains)"""
    if root == item:
        return True
    if root >= 0:
        return False
    b = cw.crush.bucket(root)
    if b is None:
        return False
    return any(subtree_contains(cw, c, item) for c in b.items)


def get_rule_weight_osd_map(cw, ruleno: int) -> Dict[int, float]:
    """osd -> normalized weight fraction under the rule's takes
    (CrushWrapper::get_rule_weight_osd_map).  float32 arithmetic, like
    the reference's ``float``, so downstream deviation compares that
    sit exactly on a threshold round the same way."""
    import numpy as np
    rule = cw.crush.rules[ruleno]
    if rule is None:
        raise KeyError(f"no rule {ruleno}")
    pmap: Dict[int, float] = {}
    for step in rule.steps:
        if step.op != CRUSH_RULE_TAKE:
            continue
        m: Dict[int, np.float32] = {}
        total = np.float32(0.0)
        n = step.arg1
        if n >= 0:
            m[n] = np.float32(1.0)
            total = np.float32(1.0)
        else:
            # breadth-first over the subtree (_get_take_weight_osd_map)
            queue = [n]
            while queue:
                bno = queue.pop(0)
                b = cw.crush.bucket(bno)
                for j, it in enumerate(b.items):
                    if it >= 0:
                        w = np.float32(
                            np.float32(b.item_weights[j]) /
                            np.float32(0x10000))
                        m[it] = w
                        total = np.float32(total + w)
                    else:
                        queue.append(it)
        for osd, w in m.items():
            pmap[osd] = float(np.float32(
                np.float32(pmap.get(osd, 0.0)) + np.float32(w / total)))
    return pmap


def _choose_type_stack(cw, stack: List[Tuple[int, int]],
                       overfull: Set[int], underfull: Sequence[int],
                       orig: Sequence[int], idx: List[int],
                       used: Set[int], pw: List[int]) -> List[int]:
    """(CrushWrapper::_choose_type_stack)  ``idx`` is the one-element
    mutable cursor into ``orig`` (the reference's iterator ``i``)."""
    w = list(pw)
    cumulative_fanout = [0] * len(stack)
    f = 1
    for j in range(len(stack) - 1, -1, -1):
        cumulative_fanout[j] = f
        f *= stack[j][1]

    # per-level buckets that hold at least one underfull device
    underfull_buckets: List[Set[int]] = [set()
                                         for _ in range(len(stack) - 1)]
    for osd in underfull:
        item = osd
        for j in range(len(stack) - 2, -1, -1):
            item = get_parent_of_type(cw, item, stack[j][0])
            underfull_buckets[j].add(item)

    for j in range(len(stack)):
        type_, fanout = stack[j]
        cum_fanout = cumulative_fanout[j]
        o: List[int] = []
        tmpi = idx[0]
        for from_ in w:
            leaves: List[Set[int]] = [set() for _ in range(fanout)]
            done = False
            for pos in range(fanout):
                if type_ > 0:
                    # non-leaf: record the choice + its leaf cohort
                    item = get_parent_of_type(cw, orig[tmpi], type_)
                    o.append(item)
                    n = cum_fanout
                    while n > 0 and tmpi < len(orig):
                        leaves[pos].add(orig[tmpi])
                        tmpi += 1
                        n -= 1
                else:
                    # leaf: swap an overfull device for an underfull one
                    replaced = False
                    if orig[idx[0]] in overfull:
                        for item in underfull:
                            if item in used:
                                continue
                            if not subtree_contains(cw, from_, item):
                                continue
                            if item in orig:
                                continue
                            o.append(item)
                            used.add(item)
                            replaced = True
                            idx[0] += 1
                            break
                    if not replaced:
                        o.append(orig[idx[0]])
                        idx[0] += 1
                    if idx[0] >= len(orig):
                        done = True
                        break
            if j + 1 < len(stack):
                # a chosen bucket with overfull leaves but NO underfull
                # candidates can't fix anything: swap it for a same-
                # parent peer that has spare underfull capacity
                for pos in range(fanout):
                    if pos >= len(o):
                        break
                    if o[pos] in underfull_buckets[j]:
                        continue
                    if not any(osd in overfull for osd in leaves[pos]):
                        continue
                    for alt in sorted(underfull_buckets[j]):
                        if alt in o:
                            continue
                        if j == 0 or \
                                get_parent_of_type(
                                    cw, o[pos], stack[j - 1][0]) == \
                                get_parent_of_type(
                                    cw, alt, stack[j - 1][0]):
                            o[pos] = alt
                            break
            if done or idx[0] >= len(orig):
                break
        w = o
    return w


def try_remap_rule(cw, ruleno: int, maxout: int, overfull: Set[int],
                   underfull: Sequence[int], orig: Sequence[int]
                   ) -> Optional[List[int]]:
    """Alternative mapping for ``orig`` under rule *ruleno* moving
    overfull->underfull (CrushWrapper::try_remap_rule); None on error."""
    rule = cw.crush.rules[ruleno]
    if rule is None:
        return None
    m = cw.crush
    w: List[int] = []
    out: List[int] = []
    idx = [0]
    used: Set[int] = set()
    type_stack: List[Tuple[int, int]] = []
    for step in rule.steps:
        if step.op == CRUSH_RULE_TAKE:
            ok = (0 <= step.arg1 < m.max_devices) or \
                (0 <= -1 - step.arg1 < len(m.buckets)
                 and m.bucket(step.arg1) is not None)
            if ok:
                w = [step.arg1]
        elif step.op in (CRUSH_RULE_CHOOSELEAF_FIRSTN,
                         CRUSH_RULE_CHOOSELEAF_INDEP):
            numrep = step.arg1
            if numrep <= 0:
                numrep += maxout
            type_stack.append((step.arg2, numrep))
            type_stack.append((0, 1))
            w = _choose_type_stack(cw, type_stack, overfull, underfull,
                                   orig, idx, used, w)
            type_stack = []
        elif step.op in (CRUSH_RULE_CHOOSE_FIRSTN,
                         CRUSH_RULE_CHOOSE_INDEP):
            numrep = step.arg1
            if numrep <= 0:
                numrep += maxout
            type_stack.append((step.arg2, numrep))
        elif step.op == CRUSH_RULE_EMIT:
            if type_stack:
                w = _choose_type_stack(cw, type_stack, overfull,
                                       underfull, orig, idx, used, w)
                type_stack = []
            out.extend(w)
            w = []
    return out
