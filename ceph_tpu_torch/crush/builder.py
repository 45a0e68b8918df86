"""Bucket construction — weights, straw scalers, tree node weights.

Mirrors the construction semantics of the reference builder
(src/crush/builder.c): list buckets carry cumulative sums, tree buckets an
implicit binary heap of node weights, legacy straw buckets the
double-precision straw scalers (crush_calc_straw, both straw_calc versions).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from .constants import (
    CRUSH_BUCKET_UNIFORM, CRUSH_BUCKET_LIST, CRUSH_BUCKET_TREE,
    CRUSH_BUCKET_STRAW, CRUSH_BUCKET_STRAW2,
)
from .types import (
    Bucket, CrushMap, ListBucket, StrawBucket, Straw2Bucket, TreeBucket,
    UniformBucket,
)


def make_uniform_bucket(type: int, items: Sequence[int],
                        item_weight: int, id: int = 0) -> UniformBucket:
    b = UniformBucket(id=id, type=type, items=list(items),
                      item_weight=item_weight)
    b.weight = item_weight * len(b.items)
    return b


def make_list_bucket(type: int, items: Sequence[int],
                     weights: Sequence[int], id: int = 0) -> ListBucket:
    b = ListBucket(id=id, type=type, items=list(items),
                   item_weights=list(weights))
    s = 0
    b.sum_weights = []
    for w in weights:
        s += w
        b.sum_weights.append(s)
    b.weight = s
    return b


def _tree_depth(size: int) -> int:
    depth = 1
    t = 1
    while t < size:
        t <<= 1
        depth += 1
    return depth


def make_tree_bucket(type: int, items: Sequence[int],
                     weights: Sequence[int], id: int = 0) -> TreeBucket:
    """Binary-heap tree: leaf i lives at node (i<<1)+1; internal node n
    weights are sums of children (builder.c crush_make_tree_bucket)."""
    b = TreeBucket(id=id, type=type, items=list(items))
    size = len(b.items)
    depth = _tree_depth(size)
    b.num_nodes = 1 << depth
    node_weights = [0] * b.num_nodes
    for i, w in enumerate(weights):
        node_weights[(i << 1) + 1] = w

    # internal node n (height h = trailing zeros) = sum of children
    def fill(n: int) -> int:
        if n & 1:
            return node_weights[n]
        h = (n & -n).bit_length() - 1
        left = n - (1 << (h - 1))
        right = n + (1 << (h - 1))
        lw = fill(left) if left < b.num_nodes else 0
        rw = fill(right) if right < b.num_nodes else 0
        node_weights[n] = lw + rw
        return node_weights[n]

    root = b.num_nodes >> 1
    b.weight = fill(root)
    b.node_weights = node_weights
    return b


def calc_straws(weights: Sequence[int], straw_calc_version: int = 1
                ) -> List[int]:
    """Straw scalers for legacy straw buckets (builder.c crush_calc_straw)."""
    size = len(weights)
    reverse = sorted(range(size), key=lambda i: (weights[i], i))
    # insertion sort in the reference is stable with ties keeping original
    # relative order; python sorted() is stable on the key
    straws = [0] * size
    numleft = size
    straw = 1.0
    wbelow = 0.0
    lastw = 0.0
    i = 0
    while i < size:
        if straw_calc_version == 0:
            if weights[reverse[i]] == 0:
                straws[reverse[i]] = 0
                i += 1
                continue
            straws[reverse[i]] = int(straw * 0x10000)
            i += 1
            if i == size:
                break
            if weights[reverse[i]] == weights[reverse[i - 1]]:
                continue
            wbelow += (float(weights[reverse[i - 1]]) - lastw) * numleft
            j = i
            while j < size and weights[reverse[j]] == weights[reverse[i]]:
                numleft -= 1
                j += 1
            wnext = numleft * (weights[reverse[i]] - weights[reverse[i - 1]])
            pbelow = wbelow / (wbelow + wnext)
            straw *= (1.0 / pbelow) ** (1.0 / numleft)
            lastw = float(weights[reverse[i - 1]])
        else:
            if weights[reverse[i]] == 0:
                straws[reverse[i]] = 0
                i += 1
                numleft -= 1
                continue
            straws[reverse[i]] = int(straw * 0x10000)
            i += 1
            if i == size:
                break
            wbelow += (float(weights[reverse[i - 1]]) - lastw) * numleft
            numleft -= 1
            wnext = numleft * (weights[reverse[i]] - weights[reverse[i - 1]])
            pbelow = wbelow / (wbelow + wnext)
            straw *= (1.0 / pbelow) ** (1.0 / numleft)
            lastw = float(weights[reverse[i - 1]])
    return straws


def make_straw_bucket(type: int, items: Sequence[int],
                      weights: Sequence[int], id: int = 0,
                      straw_calc_version: int = 1) -> StrawBucket:
    b = StrawBucket(id=id, type=type, items=list(items),
                    item_weights=list(weights))
    b.weight = sum(weights)
    b.straws = calc_straws(weights, straw_calc_version)
    return b


def make_straw2_bucket(type: int, items: Sequence[int],
                       weights: Sequence[int], id: int = 0) -> Straw2Bucket:
    b = Straw2Bucket(id=id, type=type, items=list(items),
                     item_weights=list(weights))
    b.weight = sum(weights)
    return b


def make_bucket(alg: int, type: int, items: Sequence[int],
                weights: Sequence[int], id: int = 0,
                straw_calc_version: int = 1) -> Bucket:
    if alg == CRUSH_BUCKET_UNIFORM:
        iw = weights[0] if weights else 0x10000
        return make_uniform_bucket(type, items, iw, id)
    if alg == CRUSH_BUCKET_LIST:
        return make_list_bucket(type, items, weights, id)
    if alg == CRUSH_BUCKET_TREE:
        return make_tree_bucket(type, items, weights, id)
    if alg == CRUSH_BUCKET_STRAW:
        return make_straw_bucket(type, items, weights, id, straw_calc_version)
    if alg == CRUSH_BUCKET_STRAW2:
        return make_straw2_bucket(type, items, weights, id)
    raise ValueError(f"unknown bucket alg {alg}")
