"""The CRUSH rule interpreter — exact host implementation.

Reproduces crush_do_rule's semantics step for step (reference
src/crush/mapper.c:883-1087, crush_choose_firstn :443, crush_choose_indep
:638, bucket choosers :58-367) so that mappings are bit-identical: the same
rjenkins hashes, the same fixed-point straw2 draw (crush_ln LUT + s64
truncated division), the same r' = r + ftotal retry sequences, collision and
out-rejection logic, and the same firstn/indep output conventions
(CRUSH_ITEM_NONE padding for indep).

The port's own copy of ``ceph_tpu/crush/mapper.py``.  It is the oracle the
card's candidate-table mapper (ops/crush_fast.py) is held against, and it
replays the lanes that mapper flags as unresolved.  Written for clarity and
exactness, not speed.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .constants import (
    CRUSH_BUCKET_UNIFORM, CRUSH_BUCKET_LIST, CRUSH_BUCKET_TREE,
    CRUSH_BUCKET_STRAW, CRUSH_BUCKET_STRAW2,
    CRUSH_ITEM_NONE, CRUSH_ITEM_UNDEF,
    CRUSH_RULE_TAKE, CRUSH_RULE_CHOOSE_FIRSTN, CRUSH_RULE_CHOOSE_INDEP,
    CRUSH_RULE_EMIT, CRUSH_RULE_CHOOSELEAF_FIRSTN,
    CRUSH_RULE_CHOOSELEAF_INDEP, CRUSH_RULE_SET_CHOOSE_TRIES,
    CRUSH_RULE_SET_CHOOSELEAF_TRIES, CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES,
    CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
    CRUSH_RULE_SET_CHOOSELEAF_VARY_R, CRUSH_RULE_SET_CHOOSELEAF_STABLE,
    S64_MIN,
)
from .hash import (crush_hash32_2, crush_hash32_3, crush_hash32_3_np,
                   crush_hash32_4)
from .ln import crush_ln, crush_ln_np
from .types import Bucket, CrushMap, ChooseArg


def crush_find_rule(map: CrushMap, ruleset: int, type: int, size: int) -> int:
    for i, r in enumerate(map.rules):
        if (r is not None and r.ruleset == ruleset and r.type == type
                and r.min_size <= size <= r.max_size):
            return i
    return -1


# ---- bucket choosers ------------------------------------------------------

def _perm_choose(bucket: Bucket, x: int, r: int) -> int:
    """Pseudo-random permutation choose (uniform buckets).

    The reference memoizes the permutation in a workspace
    (mapper.c:76-131); the permutation itself is a deterministic
    Fisher-Yates keyed on (bucket, x), so recomputing the prefix gives
    identical results.
    """
    size = bucket.size
    pr = r % size
    perm = list(range(size))
    for p in range(pr + 1):
        if p < size - 1:
            i = crush_hash32_3(x, bucket.id, p) % (size - p)
            if i:
                perm[p], perm[p + i] = perm[p + i], perm[p]
    return bucket.items[perm[pr]]


def _list_choose(bucket, x: int, r: int) -> int:
    for i in range(bucket.size - 1, -1, -1):
        w = crush_hash32_4(x, bucket.items[i], r, bucket.id)
        w &= 0xFFFF
        w = (w * bucket.sum_weights[i]) >> 16
        if w < bucket.item_weights[i]:
            return bucket.items[i]
    return bucket.items[0]


def _tree_choose(bucket, x: int, r: int) -> int:
    n = bucket.num_nodes >> 1
    while not (n & 1):
        w = bucket.node_weights[n]
        t = (crush_hash32_4(x, n, r, bucket.id) * w) >> 32
        # descend: left child is n - 2^(h-1), right is n + 2^(h-1)
        h = (n & -n).bit_length() - 1
        left = n - (1 << (h - 1))
        if t < bucket.node_weights[left]:
            n = left
        else:
            n = left + (1 << h)
    return bucket.items[n >> 1]


def _straw_choose(bucket, x: int, r: int) -> int:
    high = 0
    high_draw = 0
    for i in range(bucket.size):
        draw = crush_hash32_3(x, bucket.items[i], r) & 0xFFFF
        draw *= bucket.straws[i]
        if i == 0 or draw > high_draw:
            high = i
            high_draw = draw
    return bucket.items[high]


def _straw2_choose(bucket, x: int, r: int,
                   arg: Optional[ChooseArg], position: int) -> int:
    weights = bucket.item_weights
    ids = bucket.items
    if arg is not None:
        if arg.weight_set:
            pos = min(position, len(arg.weight_set) - 1)
            weights = arg.weight_set[pos].weights
        if arg.ids:
            ids = arg.ids
    n = bucket.size
    draw = _straw2_argmax_np if n >= STRAW2_NUMPY_MIN else _straw2_argmax_py
    return bucket.items[draw(ids, weights, x, r, n)]


# Two forms of one draw (mapper.c bucket_straw2_choose): ln / w as an s64
# division truncating toward zero, S64_MIN for a zero weight, the first of
# equal draws winning.  The scalar loop costs a Python hash per item; the
# numpy form costs a fixed ~200 array operations whatever the width.  A
# bucket of at least STRAW2_NUMPY_MIN items takes the numpy form: the width
# where the two cost the same on the host (chip_smoke.py's phase 5c times
# both at widths 2..50; PERF.md records the crossover, 12-14 items).
STRAW2_NUMPY_MIN = 14
# -2^48 * ln2(u / 2^16) of every 16-bit hash (crush_ln's fixed-point log)
_NEG_LN = (np.uint64(0x1000000000000)
           - crush_ln_np(np.arange(0x10000, dtype=np.uint32))).astype(np.int64)


def _straw2_argmax_py(ids, weights, x: int, r: int, n: int) -> int:
    high = 0
    high_draw = 0
    for i in range(n):
        w = weights[i]
        if w:
            u = crush_hash32_3(x, ids[i], r) & 0xFFFF
            ln = crush_ln(u) - 0x1000000000000
            # s64 division truncating toward zero; ln <= 0, w > 0
            draw = -((-ln) // w)
        else:
            draw = S64_MIN
        if i == 0 or draw > high_draw:
            high = i
            high_draw = draw
    return high


def _straw2_argmax_np(ids, weights, x: int, r: int, n: int) -> int:
    ids = np.asarray(ids[:n], dtype=np.int64).astype(np.uint32)
    w = np.asarray(weights[:n], dtype=np.int64)
    u = crush_hash32_3_np(np.uint32(x & 0xFFFFFFFF), ids,
                          np.uint32(r & 0xFFFFFFFF)) & np.uint32(0xFFFF)
    # np.argmax keeps the first of equal draws
    draw = np.where(w > 0, -(_NEG_LN[u] // np.maximum(w, 1)), S64_MIN)
    return int(np.argmax(draw))


def _bucket_choose(map: CrushMap, bucket: Bucket, x: int, r: int,
                   choose_args, position: int) -> int:
    assert bucket.size > 0
    if bucket.alg == CRUSH_BUCKET_UNIFORM:
        return _perm_choose(bucket, x, r)
    if bucket.alg == CRUSH_BUCKET_LIST:
        return _list_choose(bucket, x, r)
    if bucket.alg == CRUSH_BUCKET_TREE:
        return _tree_choose(bucket, x, r)
    if bucket.alg == CRUSH_BUCKET_STRAW:
        return _straw_choose(bucket, x, r)
    if bucket.alg == CRUSH_BUCKET_STRAW2:
        arg = None
        if choose_args is not None:
            bno = -1 - bucket.id
            if bno < len(choose_args):
                arg = choose_args[bno]
        return _straw2_choose(bucket, x, r, arg, position)
    return bucket.items[0]


def _is_out(map: CrushMap, weight: Sequence[int], item: int, x: int) -> bool:
    if item >= len(weight):
        return True
    w = weight[item]
    if w >= 0x10000:
        return False
    if w == 0:
        return True
    return (crush_hash32_2(x, item) & 0xFFFF) >= w


# ---- choose: firstn -------------------------------------------------------

def _choose_firstn(map: CrushMap, bucket: Bucket, weight, x: int,
                   numrep: int, type: int, out: List[int], outpos: int,
                   out_size: int, tries: int, recurse_tries: int,
                   local_retries: int, local_fallback_retries: int,
                   recurse_to_leaf: bool, vary_r: int, stable: int,
                   out2: Optional[List[int]], parent_r: int,
                   choose_args) -> int:
    count = out_size
    rep = 0 if stable else outpos
    while rep < numrep and count > 0:
        ftotal = 0
        skip_rep = False
        retry_descent = True
        item = 0
        while retry_descent:
            retry_descent = False
            in_bucket = bucket
            flocal = 0
            retry_bucket = True
            while retry_bucket:
                retry_bucket = False
                collide = False
                r = rep + parent_r + ftotal
                if in_bucket.size == 0:
                    reject = True
                else:
                    if (local_fallback_retries > 0
                            and flocal >= (in_bucket.size >> 1)
                            and flocal > local_fallback_retries):
                        item = _perm_choose(in_bucket, x, r)
                    else:
                        item = _bucket_choose(map, in_bucket, x, r,
                                              choose_args, outpos)
                    if item >= map.max_devices:
                        skip_rep = True
                        break
                    itemtype = map.bucket(item).type if item < 0 else 0
                    if itemtype != type:
                        sub = map.bucket(item) if item < 0 else None
                        if sub is None:
                            skip_rep = True
                            break
                        in_bucket = sub
                        retry_bucket = True
                        continue
                    # collision?
                    for i in range(outpos):
                        if out[i] == item:
                            collide = True
                            break
                    reject = False
                    if not collide and recurse_to_leaf:
                        if item < 0:
                            sub_r = r >> (vary_r - 1) if vary_r else 0
                            if _choose_firstn(
                                    map, map.bucket(item), weight, x,
                                    1 if stable else outpos + 1, 0,
                                    out2, outpos, count,
                                    recurse_tries, 0,
                                    local_retries, local_fallback_retries,
                                    False, vary_r, stable, None, sub_r,
                                    choose_args) <= outpos:
                                reject = True
                        else:
                            out2[outpos] = item
                    if not reject and not collide and itemtype == 0:
                        reject = _is_out(map, weight, item, x)
                if reject or collide:
                    ftotal += 1
                    flocal += 1
                    if collide and flocal <= local_retries:
                        retry_bucket = True
                    elif (local_fallback_retries > 0
                          and flocal <= in_bucket.size + local_fallback_retries):
                        retry_bucket = True
                    elif ftotal < tries:
                        retry_descent = True
                        break
                    else:
                        skip_rep = True
                        break
        if not skip_rep:
            out[outpos] = item
            outpos += 1
            count -= 1
            # choose-tries profile (mapper.c:624: userspace-only
            # histogram behind crush.start_choose_profile)
            prof = getattr(map, "choose_tries", None)
            if prof is not None and ftotal <= map.choose_total_tries:
                prof[ftotal] += 1
        rep += 1
    return outpos


# ---- choose: indep --------------------------------------------------------

def _choose_indep(map: CrushMap, bucket: Bucket, weight, x: int,
                  left: int, numrep: int, type: int,
                  out: List[int], outpos: int, tries: int,
                  recurse_tries: int, recurse_to_leaf: bool,
                  out2: Optional[List[int]], parent_r: int,
                  choose_args) -> None:
    endpos = outpos + left
    for rep in range(outpos, endpos):
        out[rep] = CRUSH_ITEM_UNDEF
        if out2 is not None:
            out2[rep] = CRUSH_ITEM_UNDEF
    ftotal = 0
    while left > 0 and ftotal < tries:
        for rep in range(outpos, endpos):
            if out[rep] != CRUSH_ITEM_UNDEF:
                continue
            in_bucket = bucket
            while True:
                r = rep + parent_r
                if (in_bucket.alg == CRUSH_BUCKET_UNIFORM
                        and in_bucket.size % numrep == 0):
                    r += (numrep + 1) * ftotal
                else:
                    r += numrep * ftotal
                if in_bucket.size == 0:
                    break
                item = _bucket_choose(map, in_bucket, x, r,
                                      choose_args, outpos)
                if item >= map.max_devices:
                    out[rep] = CRUSH_ITEM_NONE
                    if out2 is not None:
                        out2[rep] = CRUSH_ITEM_NONE
                    left -= 1
                    break
                itemtype = map.bucket(item).type if item < 0 else 0
                if itemtype != type:
                    sub = map.bucket(item) if item < 0 else None
                    if sub is None:
                        out[rep] = CRUSH_ITEM_NONE
                        if out2 is not None:
                            out2[rep] = CRUSH_ITEM_NONE
                        left -= 1
                        break
                    in_bucket = sub
                    continue
                collide = False
                for i in range(outpos, endpos):
                    if out[i] == item:
                        collide = True
                        break
                if collide:
                    break
                if recurse_to_leaf:
                    if item < 0:
                        _choose_indep(map, map.bucket(item), weight, x,
                                      1, numrep, 0, out2, rep,
                                      recurse_tries, 0, False, None, r,
                                      choose_args)
                        if out2[rep] == CRUSH_ITEM_NONE:
                            break
                    else:
                        out2[rep] = item
                if itemtype == 0 and _is_out(map, weight, item, x):
                    break
                out[rep] = item
                left -= 1
                break
        ftotal += 1
    for rep in range(outpos, endpos):
        if out[rep] == CRUSH_ITEM_UNDEF:
            out[rep] = CRUSH_ITEM_NONE
        if out2 is not None and out2[rep] == CRUSH_ITEM_UNDEF:
            out2[rep] = CRUSH_ITEM_NONE
    # choose-tries profile: indep records once per invocation with
    # the loop-exit ftotal (mapper.c:809)
    prof = getattr(map, "choose_tries", None)
    if prof is not None and ftotal <= map.choose_total_tries:
        prof[ftotal] += 1


# ---- do_rule --------------------------------------------------------------

def crush_do_rule(map: CrushMap, ruleno: int, x: int, result_max: int,
                  weight: Sequence[int],
                  choose_args: Optional[List[ChooseArg]] = None) -> List[int]:
    """Evaluate rule *ruleno* for input *x*; returns the result vector."""
    if ruleno < 0 or ruleno >= map.max_rules or map.rules[ruleno] is None:
        return []
    rule = map.rules[ruleno]

    result: List[int] = []
    w: List[int] = [0] * result_max
    o: List[int] = [0] * result_max
    c: List[int] = [0] * result_max
    wsize = 0

    # off-by-one adjustment: stored tunable counts "retries" (mapper.c:905)
    choose_tries = map.choose_total_tries + 1
    choose_leaf_tries = 0
    choose_local_retries = map.choose_local_tries
    choose_local_fallback_retries = map.choose_local_fallback_tries
    vary_r = map.chooseleaf_vary_r
    stable = map.chooseleaf_stable

    for step in rule.steps:
        op = step.op
        if op == CRUSH_RULE_TAKE:
            valid_dev = 0 <= step.arg1 < map.max_devices
            valid_bucket = map.bucket(step.arg1) is not None
            if valid_dev or valid_bucket:
                w[0] = step.arg1
                wsize = 1
        elif op == CRUSH_RULE_SET_CHOOSE_TRIES:
            if step.arg1 > 0:
                choose_tries = step.arg1
        elif op == CRUSH_RULE_SET_CHOOSELEAF_TRIES:
            if step.arg1 > 0:
                choose_leaf_tries = step.arg1
        elif op == CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES:
            if step.arg1 >= 0:
                choose_local_retries = step.arg1
        elif op == CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES:
            if step.arg1 >= 0:
                choose_local_fallback_retries = step.arg1
        elif op == CRUSH_RULE_SET_CHOOSELEAF_VARY_R:
            if step.arg1 >= 0:
                vary_r = step.arg1
        elif op == CRUSH_RULE_SET_CHOOSELEAF_STABLE:
            if step.arg1 >= 0:
                stable = step.arg1
        elif op in (CRUSH_RULE_CHOOSELEAF_FIRSTN, CRUSH_RULE_CHOOSE_FIRSTN,
                    CRUSH_RULE_CHOOSELEAF_INDEP, CRUSH_RULE_CHOOSE_INDEP):
            if wsize == 0:
                continue
            firstn = op in (CRUSH_RULE_CHOOSELEAF_FIRSTN,
                            CRUSH_RULE_CHOOSE_FIRSTN)
            recurse_to_leaf = op in (CRUSH_RULE_CHOOSELEAF_FIRSTN,
                                     CRUSH_RULE_CHOOSELEAF_INDEP)
            osize = 0
            for i in range(wsize):
                numrep = step.arg1
                if numrep <= 0:
                    numrep += result_max
                    if numrep <= 0:
                        continue
                bucket = map.bucket(w[i])
                if bucket is None:
                    continue  # w[i] is probably CRUSH_ITEM_NONE
                # the reference passes offset pointers (o+osize, c+osize);
                # sub-lists indexed from 0 reproduce that exactly
                room = result_max - osize
                sub_o = [0] * room
                sub_c = [0] * room
                if firstn:
                    if choose_leaf_tries:
                        recurse_tries = choose_leaf_tries
                    elif map.chooseleaf_descend_once:
                        recurse_tries = 1
                    else:
                        recurse_tries = choose_tries
                    n = _choose_firstn(
                        map, bucket, weight, x, numrep, step.arg2,
                        sub_o, 0, room,
                        choose_tries, recurse_tries,
                        choose_local_retries,
                        choose_local_fallback_retries,
                        recurse_to_leaf, vary_r, stable, sub_c, 0,
                        choose_args)
                    o[osize:osize + n] = sub_o[:n]
                    c[osize:osize + n] = sub_c[:n]
                    osize += n
                else:
                    out_size = min(numrep, room)
                    _choose_indep(
                        map, bucket, weight, x, out_size, numrep,
                        step.arg2, sub_o, 0, choose_tries,
                        choose_leaf_tries if choose_leaf_tries else 1,
                        recurse_to_leaf, sub_c, 0, choose_args)
                    o[osize:osize + out_size] = sub_o[:out_size]
                    c[osize:osize + out_size] = sub_c[:out_size]
                    osize += out_size
            if recurse_to_leaf:
                o[:osize] = c[:osize]
            w, o = o, w
            wsize = osize
        elif op == CRUSH_RULE_EMIT:
            for i in range(wsize):
                if len(result) >= result_max:
                    break
                result.append(w[i])
            wsize = 0
    return result
