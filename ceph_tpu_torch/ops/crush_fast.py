"""Candidate-table CRUSH mapper on the card: K7a and K7b, their wrappers,
their plain PyTorch versions and ``FastRule`` around them.

Port of ``ceph_tpu/ops/crush_fast.py``.  The rule compilation (scope
checks, layered-path depths, the i32 quotient tables) stays host numpy as
there; every part the JAX module jits is a kernel of
``csrc/crush_fast.cu`` or torch glue around one:

1. *Candidates* (topology only, cached per batch of x): for every x and
   every retry r the rule could consume, the full descent root -> failure
   domain (-> leaf), one straw2 draw per level.  ``crush_descend`` (K7a)
   is one launch per stage over the stage's parent lanes and its (R, P)
   grid of retries and weight-set positions (``DescentSpec``); each thread
   derives its lane from its index, and on the last stage of a leaf rule
   it also draws its candidate's leaf attempts.  Draws are always exact:
   the i32 quotient table of a level whose buckets have one uniform weight
   >= 0x10000, otherwise ``G[u] // w``, which the kernel gathers from the
   item's int64 quotient table on a map of at most ``Q64_MAX_TABLES``
   distinct weights and otherwise takes as a multiply-high by the weight's
   magic number (``straw2_magic``), and the plain version divides.  So
   there is no float draw and no risk flag from a draw.
2. *Resolution* (per weight vector): ``crush_resolve`` (K7b) replays the
   firstn/indep retry semantics over the cached candidates, one thread per
   x, and packs each x into one row ``[slots..., count | residual << 16]``.
   Under mode 1 it is the collision pass of a chained rule's middle step,
   part of the candidate phase.
3. *Finishing*: where the round caps (``tries_cap``, ``leaf_tries_cap``)
   stop short of the rule's tries, K7b flags the x.  ``exact_packed``
   gathers the flagged x into an index buffer on the device (a cumsum and
   a scatter, no host sync) and K6 (``crush_kernels.crush_rule``), the
   whole rule with its full tries, writes their exact rows over them.  So
   every row equals ``crush_do_rule`` and no x is recomputed on the host.

Per epoch, ``map_batch`` fetches only the rows that changed since the last
weight vector: ``crush_delta`` (K7c) compacts them on the device into one
flat buffer, with no host sync before the one device-to-host copy.

The device-flow profiler accounts the uploads of x and weights and the
row fetches at the JAX package's sites (``crush.candidates``,
``crush.map_batch``), and ``g_kernel_timer`` times the resolution as
``crush_resolve``.  A full fetch moves the flagged count in front of the
rows, 4 bytes more than the JAX package's.

A CUDA tensor goes to the kernels or raises; only tensors on the CPU take
the plain versions (``crush_descend_plain``, ``crush_resolve_plain``,
``crush_rule_plain``, ``crush_delta_plain``).  ``FastRule(...,
plain=True)`` runs the plain versions on any device: it is the reference
run that chip_smoke.py holds the kernels against, never a default.
``descend_launches.n`` / ``resolve_launches.n`` / ``delta_launches.n``
(and ``crush_kernels.rule_launches.n`` for K6) count launches.

Scope as in the JAX module: straw2 maps, layered hierarchies, jewel-style
tunables for firstn chooseleaf (stable = 1), no local tries, at most two
choose steps; and here at most ``MAX_REP`` slots per step and in the
result.  Anything else raises ``UnsupportedRule`` while the rule compiles,
before any launch.
"""
from __future__ import annotations

import functools
import hashlib
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..crush.constants import (
    CRUSH_ITEM_NONE, CRUSH_ITEM_UNDEF, CRUSH_RULE_CHOOSELEAF_FIRSTN,
    CRUSH_RULE_CHOOSELEAF_INDEP, CRUSH_RULE_CHOOSE_FIRSTN,
    CRUSH_RULE_CHOOSE_INDEP, CRUSH_RULE_EMIT,
    CRUSH_RULE_SET_CHOOSELEAF_STABLE, CRUSH_RULE_SET_CHOOSELEAF_TRIES,
    CRUSH_RULE_SET_CHOOSELEAF_VARY_R, CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
    CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES, CRUSH_RULE_SET_CHOOSE_TRIES,
    CRUSH_RULE_TAKE,
)
from ..common.kernel_trace import g_kernel_timer
from ..crush.types import CrushMap
from ..trace.devprof import g_devprof
from . import _build
from .crush_kernels import (
    G_EXACT, MAX_REP, QTABLE_MIN_W, _SIGNATURES, CompiledCrushMap, compile_map,
    crush_rule, crush_rule_plain_into, g_table, hash32_2, hash32_3,
    quotient_table)
from .gf_pallas import LaunchCounter

NONE = CRUSH_ITEM_NONE
UNDEF = CRUSH_ITEM_UNDEF

descend_launches = LaunchCounter()    # K7a
resolve_launches = LaunchCounter()    # K7b
delta_launches = LaunchCounter()      # K7c
DELTA_ROWS = 1024                     # K7c: rows of one block (kDeltaRows)

# plain descent: lanes per chunk times the widest bucket, in int64 words
_PLAIN_CHUNK_WORDS = 1 << 25


class UnsupportedRule(ValueError):
    pass


# ---- layered-path validation (host) -----------------------------------------

def _layer_path(m: CrushMap, root: int, target_type: int) -> int:
    """Verify the hierarchy under *root* is layered toward *target_type*;
    returns the number of choose levels needed to reach it."""
    return _layer_path_frontier(m, [root], target_type)


def _layer_path_frontier(m: CrushMap, roots: List[int],
                         target_type: int) -> int:
    depth = 0
    frontier = list(roots)
    while True:
        child_types = set()
        for b in frontier:
            bk = m.bucket(b)
            if bk is None or bk.size == 0:
                raise UnsupportedRule("empty/dangling bucket in path")
            for it in bk.items:
                if it >= 0:
                    child_types.add(0)
                else:
                    sb = m.bucket(it)
                    if sb is None:
                        raise UnsupportedRule("dangling bucket ref")
                    child_types.add(sb.type)
        if len(child_types) != 1:
            raise UnsupportedRule("mixed child types: not layered")
        ct = child_types.pop()
        depth += 1
        if ct == target_type:
            return depth
        if ct == 0:
            raise UnsupportedRule("reached devices before target type")
        next_frontier = []
        for b in frontier:
            next_frontier.extend(m.bucket(b).items)
        frontier = next_frontier
        if depth > 10:
            raise UnsupportedRule("hierarchy too deep")


def _advance(m: CrushMap, frontier: List[int]) -> List[int]:
    """One level down: the sub-buckets the frontier's draws can land in."""
    nxt: List[int] = []
    for b in frontier:
        nxt.extend(i for i in m.bucket(b).items if i < 0)
    return nxt


def _level_frontiers(m: CrushMap, root: int, n_levels: int) -> List[List[int]]:
    """Bucket-id frontier feeding each of the n_levels draws under root."""
    out = []
    frontier = [root]
    for _ in range(n_levels):
        out.append(list(frontier))
        frontier = _advance(m, frontier)
    return out


# ---- K7a: the descent ---------------------------------------------------------

# K7a's multiply-high form of a straw2 weight w: m | t << 58 with t =
# ceil(log2 w) and m = ceil(2^(49 + t) / w) (< 2^51), so that floor(G / w)
# is the high word of (G << 15) * m shifted right by t for every
# 0 <= G < 2^49 (Granlund-Montgomery: m w - 2^(49 + t) < w <= 2^t); 0 for a
# zero weight, whose draw is 2^62
MAGIC_SHIFT = 58
G_SHIFT = 15


def straw2_magic(w: np.ndarray) -> np.ndarray:
    """The multiply-high word of each u32 weight of ``w`` (uint64)."""
    w = np.asarray(w, dtype=np.uint32)
    out = np.zeros(w.shape, dtype=np.uint64)
    for v in np.unique(w):
        v = int(v)
        if v:
            t = (v - 1).bit_length()
            m = -(-(1 << (49 + t)) // v)
            out[w == v] = m | (t << MAGIC_SHIFT)
    return out


def straw2_quotient(g: int, word: int) -> int:
    """floor(g / w) from w's multiply-high word, as K7a computes it."""
    m = word & ((1 << MAGIC_SHIFT) - 1)
    return (((g << G_SHIFT) * m) >> 64) >> (word >> MAGIC_SHIFT)


# K7a draws a level without an i32 quotient table from one int64 table
# floor(G[u] / w) per distinct weight (512 KiB each, a table index per
# item) while the map has at most this many distinct nonzero weights, and
# otherwise by the multiply-high.  ``chip_smoke.py --k7a-forms`` timed both
# on the (n) map with 4 to 1000 tables (H100, PERF.md section 6): the
# tables ~5% faster on the EC rule up to 48 of them (24 MiB), 13% slower
# at 64 (32 MiB, past what L2 keeps), 2.5x slower at 1000
Q64_MAX_TABLES = 48


def item_quotient_tables(w: np.ndarray, max_tables=Q64_MAX_TABLES):
    """(qitem, q64): each item's table index ((npos, nb, S) int32, -1 for a
    zero weight) and the tables ((n, 65536) int64 floor(G[u] / w)) of the
    u32 weights ``w``; None when they have more than ``max_tables``
    distinct nonzero values (None: no limit)."""
    w = np.asarray(w, dtype=np.uint32)
    uniq = [int(v) for v in np.unique(w) if v]
    if max_tables is not None and len(uniq) > max_tables:
        return None
    qitem = np.full(w.shape, -1, dtype=np.int32)
    for i, v in enumerate(uniq):
        qitem[w == v] = i
    q64 = (np.stack([G_EXACT // np.int64(v) for v in uniq]) if uniq
           else np.zeros((1, 0x10000), dtype=np.int64))
    return qitem, q64


@functools.lru_cache(maxsize=None)
def g15_table(device: torch.device) -> torch.Tensor:
    """G[u] << 15 for every 16-bit u, K7a's multiply-high operand."""
    return torch.from_numpy(G_EXACT << np.int64(G_SHIFT)).to(device)


@dataclass
class DescentTables:
    """What K7a reads besides its lanes: the compiled map, each bucket's
    quotient table index, the quotient tables, per level whether it draws
    from them (``int_levels``), G (the plain version divides it), and for
    the kernel's other levels each item's int64 quotient table
    (``item_quotient_tables``; None past ``Q64_MAX_TABLES`` weights) or
    else G << 15 and each weight's multiply-high word (``magic``, (npos,
    nb, S) int64 bits of ``straw2_magic``)."""
    cm: CompiledCrushMap
    qidx: torch.Tensor        # (nb,) int32
    qtables: torch.Tensor     # (n_tables, 65536) int32, or (1, 1) unused
    g: torch.Tensor           # (65536,) int64
    int_levels: Tuple[bool, ...]
    g15: torch.Tensor         # (65536,) int64
    magic: torch.Tensor       # (npos, nb, S) int64
    qitem: Optional[torch.Tensor] = None   # (npos, nb, S) int32
    q64: Optional[torch.Tensor] = None     # (n, 65536) int64

    def mask(self, base_level: int, depth: int) -> int:
        return sum(1 << d for d in range(depth)
                   if self.int_levels[base_level + d])


@dataclass(frozen=True)
class DescentSpec:
    """One K7a launch over N parent lanes: the (R, P) grid of retries and
    weight-set positions, the levels of the candidate draw, and the leaf
    attempts drawn from each candidate: ``L`` of them (0: none), each
    ``leaf_depth`` levels from level ``base_level + depth`` on (0: the
    candidate is its own leaf), with firstn's sub-r ``(r >> (vary_r - 1))
    + f2`` (``f2`` when vary_r is 0) at position p (the parent step's
    outpos, mapper.c:561-562), or indep's ``rep + r + numrep * f2`` at
    position ``rep = r % numrep``."""
    R: int
    P: int
    base_level: int
    depth: int
    L: int = 0
    leaf_depth: int = 0
    leaf_firstn: bool = True
    vary_r: int = 0
    numrep: int = 1

    def leaf_lanes(self, r: torch.Tensor, p: torch.Tensor):
        """(sub-r of attempt 0, step per attempt, position) of lanes at
        retry ``r`` and grid position ``p``."""
        if self.leaf_firstn:
            sub_r = (r >> (self.vary_r - 1) if self.vary_r
                     else torch.zeros_like(r))
            return sub_r, 1, p
        rep = r % self.numrep
        return rep + r, self.numrep, rep


def _descend_lanes(x, start, r, pos, tabs: DescentTables, base_level: int,
                   depth: int) -> torch.Tensor:
    """(n,) flat lanes -> (n,) int32 items after ``depth`` straw2 draws
    from bucket index ``start``: ``_descend`` / ``_straw2_int`` /
    ``_straw2_exact64`` step by step (argmin: the first index wins)."""
    cm = tabs.cm
    S = cm.max_size
    lane = torch.arange(S, device=x.device)
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    step = max(1, _PLAIN_CHUNK_WORDS // S)
    for a in range(0, x.shape[0], step):
        xs = x[a:a + step].to(torch.int64)
        rs = r[a:a + step].to(torch.int64)
        ps = pos[a:a + step].to(torch.int64).clamp(max=cm.npos - 1)
        bidx = start[a:a + step].to(torch.int64)
        item = None
        for d in range(depth):
            ids = cm.hash_ids[bidx]                              # (n, S)
            u = hash32_3(xs[:, None], ids, rs[:, None]) & 0xFFFF
            valid = lane[None, :] < cm.sizes[bidx][:, None]
            if tabs.int_levels[base_level + d]:
                q = tabs.qtables[tabs.qidx[bidx].long()[:, None], u]
                q = torch.where(valid, q.to(torch.int64), 0x7FFFFFFF)
            else:
                w = cm.weights[ps, bidx].to(torch.int64) & 0xFFFFFFFF
                q = torch.where(valid & (w > 0),
                                tabs.g[u] // w.clamp(min=1), 1 << 62)
            win = torch.argmin(q, dim=1)
            item = cm.items[bidx, win]
            bidx = (-1 - item.to(torch.int64)).clamp(min=0)
        out[a:a + step] = item
    return out


def crush_descend_plain(xl: torch.Tensor, roots: torch.Tensor,
                        tabs: DescentTables, spec: DescentSpec
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The plain version of K7a; the same contract as ``crush_descend``.
    It flattens the grid into lanes and divides G by each weight."""
    N = xl.shape[0]
    dev = xl.device
    R, P, L = spec.R, spec.P, spec.L
    shape = (R, P, N)
    x = xl.view(1, 1, N).expand(shape).reshape(-1)
    start = roots.view(1, 1, N).expand(shape).reshape(-1)
    r = torch.arange(R, dtype=torch.int64, device=dev).view(R, 1, 1).expand(
        shape).reshape(-1)
    p = torch.arange(P, dtype=torch.int64, device=dev).view(1, P, 1).expand(
        shape).reshape(-1)
    item = _descend_lanes(x, start, r, p, tabs, spec.base_level, spec.depth)
    cand = item.view(R, P, N)
    if not L:
        return cand, None
    if not spec.leaf_depth:
        return cand, cand.unsqueeze(1).expand(R, L, P, N).contiguous()
    sub_r, step, lpos = spec.leaf_lanes(r, p)
    lb = (-1 - item.to(torch.int64)).clamp(min=0)
    leaf = torch.empty((R, L, P, N), dtype=torch.int32, device=dev)
    for f2 in range(L):
        leaf[:, f2] = _descend_lanes(
            x, lb, sub_r + step * f2, lpos, tabs, spec.base_level + spec.depth,
            spec.leaf_depth).view(R, P, N)
    return cand, leaf


def _check_lanes(*ts: torch.Tensor) -> None:
    n = ts[0].shape
    for t in ts:
        if t.dim() != 1 or t.shape != n:
            raise ValueError("lanes must be 1-D tensors of one length")
        if t.dtype != torch.int32:
            raise ValueError(f"lanes must be int32, not {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("lanes must be contiguous")


def crush_descend(xl: torch.Tensor, roots: torch.Tensor,
                  tabs: DescentTables, spec: DescentSpec
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K7a over (N,) int32 parent lanes, x (u32 bits) and start bucket
    index: cand (R, P, N) int32 and, when ``spec.L``, leaf (R, L, P, N)
    int32 (else None).  A CPU tensor takes ``crush_descend_plain``; a CUDA
    tensor launches the kernel on the current stream or raises: one thread
    per (lane, r, p), which draws the candidate and then its leaf
    attempts."""
    _check_lanes(xl, roots)
    if xl.device.type == "cpu":
        return crush_descend_plain(xl, roots, tabs, spec)
    if xl.device.type != "cuda":
        raise RuntimeError(f"crush_descend: no kernel for device {xl.device}")
    cm = tabs.cm
    if any(t is not None and t.device != xl.device
           for t in (roots, cm.items, tabs.qtables, tabs.g15, tabs.magic,
                     tabs.qitem, tabs.q64)):
        raise ValueError("lanes and map tables must share one device")
    if not 1 <= spec.R * spec.P <= 65535:
        raise ValueError(f"grid R x P = {spec.R * spec.P} outside 1..65535")
    N = xl.shape[0]
    dev = xl.device
    cand = torch.empty((spec.R, spec.P, N), dtype=torch.int32, device=dev)
    leaf = (torch.empty((spec.R, spec.L, spec.P, N), dtype=torch.int32,
                        device=dev) if spec.L else None)
    if N == 0:
        return cand, leaf
    lib = _build.load("crush_fast", _SIGNATURES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lb = spec.base_level + spec.depth
    q64 = tabs.q64 is not None
    rc = lib.crush_descend_launch(
        xl.data_ptr(), roots.data_ptr(), cand.data_ptr(),
        leaf.data_ptr() if spec.L else None, N, spec.R, spec.P, spec.L,
        cm.items.data_ptr(), cm.hash_ids.data_ptr(), cm.sizes.data_ptr(),
        tabs.magic.data_ptr(), tabs.qidx.data_ptr(), tabs.qtables.data_ptr(),
        tabs.g15.data_ptr(), tabs.qitem.data_ptr() if q64 else None,
        tabs.q64.data_ptr() if q64 else None, cm.nbuckets, cm.max_size,
        cm.npos, spec.depth, tabs.mask(spec.base_level, spec.depth),
        spec.leaf_depth, tabs.mask(lb, spec.leaf_depth),
        int(spec.leaf_firstn), spec.vary_r, spec.numrep, stream)
    if rc != 0:
        raise RuntimeError(f"crush_descend_launch failed: cudaError {rc}")
    descend_launches.add(1)
    return cand, leaf


# ---- K7b: the resolution --------------------------------------------------------

@dataclass(frozen=True)
class ResolveSpec:
    """The static shape of one resolution: slots, rounds and leaf
    attempts materialised, the rule's own tries, and what applies."""
    numrep: int
    n_rounds: int
    tries: int
    firstn: bool
    P: int = 1                # weight-set positions materialised (firstn)
    n_leaf: int = 0           # leaf attempts materialised
    recurse_tries: int = 1
    leafy: bool = False
    check_out: bool = False   # is_out on the drawn item (choose to devices)
    gate: bool = False        # a flagged lane takes nothing more (firstn)


def _is_out_plain(weight: torch.Tensor, items: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """mapper.c is_out over lanes; ``weight`` int64 u32 values."""
    n = weight.shape[0]
    if n == 0:
        return torch.ones(items.shape, dtype=torch.bool, device=items.device)
    w = weight[items.long().clamp(0, n - 1)]
    h = hash32_2(x, items) & 0xFFFF
    out = torch.where(w >= 0x10000, False, torch.where(w == 0, True, h >= w))
    return out | (items >= n)


def _firstn_plain(spec: ResolveSpec, cand, leaf, x, weight, residual,
                  reads=None):
    """``_resolve_firstn`` / the firstn half of ``_mid_candidates``."""
    N = x.shape[0]
    dev = x.device
    lanes = torch.arange(N, device=dev)
    P = spec.P
    outs = torch.full((N, spec.numrep), NONE, dtype=torch.int32, device=dev)
    leaves = outs.clone()
    pos = torch.zeros(N, dtype=torch.int64, device=dev)
    false = torch.zeros(N, dtype=torch.bool, device=dev)
    for j in range(spec.numrep):
        if P > 1:
            pos = (outs != NONE).sum(1).clamp(max=P - 1)
        done = false
        for ft in range(spec.n_rounds):
            if reads is not None:
                reads += ~done        # the kernel stops at a filled slot
            r = j + ft
            item = cand[r][pos, lanes]
            coll = (outs == item[:, None]).any(1)
            maybe_more = false
            if spec.leafy:
                lok = false
                lsel = torch.full_like(item, NONE)
                for f2 in range(spec.n_leaf):
                    lf = leaf[r, f2][pos, lanes]
                    lcoll = (leaves == lf[:, None]).any(1)
                    good = ~lok & ~lcoll & ~_is_out_plain(weight, lf, x)
                    lsel = torch.where(good, lf, lsel)
                    lok = lok | good
                if spec.n_leaf < spec.recurse_tries:
                    maybe_more = ~lok
                ok = ~coll & lok
            else:
                rej = _is_out_plain(weight, item, x) if spec.check_out \
                    else false
                ok = ~coll & ~rej
                lsel = item
            take = ok & ~done
            if spec.gate:
                take = take & ~residual
            outs[:, j] = torch.where(take, item, outs[:, j])
            leaves[:, j] = torch.where(take, lsel, leaves[:, j])
            residual = residual | (maybe_more & ~done)
            done = done | ok
        if spec.n_rounds < spec.tries:
            residual = residual | ~done
    return (leaves if spec.leafy else outs), residual


def _indep_plain(spec: ResolveSpec, cand, leaf, x, weight, residual, room,
                 reads=None):
    """``_resolve_indep`` / the indep half of ``_mid_candidates``; slots
    at or past ``room`` (per lane) are never filled."""
    N = x.shape[0]
    dev = x.device
    nr = spec.numrep
    outs = torch.full((N, nr), UNDEF, dtype=torch.int32, device=dev)
    leaves = outs.clone()
    false = torch.zeros(N, dtype=torch.bool, device=dev)
    for ft in range(spec.n_rounds):
        for rep in range(nr):
            r = rep + nr * ft
            item = cand[r, 0]
            unfilled = (outs[:, rep] == UNDEF) & (rep < room)
            if reads is not None:
                reads += unfilled     # the kernel skips a filled slot
            coll = (outs == item[:, None]).any(1)
            if spec.leafy:
                lok = false
                lsel = torch.full_like(item, NONE)
                for f2 in range(spec.n_leaf):
                    lf = leaf[r, f2, 0]
                    good = ~lok & ~_is_out_plain(weight, lf, x)
                    lsel = torch.where(good, lf, lsel)
                    lok = lok | good
                if spec.n_leaf < spec.recurse_tries:
                    residual = residual | (unfilled & ~coll & ~lok)
                ok = ~coll & lok
            else:
                rej = _is_out_plain(weight, item, x) if spec.check_out \
                    else false
                ok = ~coll & ~rej
                lsel = item
            take = unfilled & ok
            outs[:, rep] = torch.where(take, item, outs[:, rep])
            leaves[:, rep] = torch.where(take, lsel, leaves[:, rep])
    undef = (outs == UNDEF) & (torch.arange(nr, device=dev)[None, :]
                               < room[:, None])
    if spec.n_rounds < spec.tries:
        residual = residual | undef.any(1)
    sel = leaves if spec.leafy else outs
    return torch.where(sel == UNDEF, NONE, sel), residual


def crush_resolve_plain(spec: ResolveSpec, cand: torch.Tensor,
                        leaf: Optional[torch.Tensor], lane_x: torch.Tensor,
                        valid: torch.Tensor, risk0: torch.Tensor,
                        weight: torch.Tensor, parents: int, width: int,
                        mode: int, reads: Optional[torch.Tensor] = None):
    """The plain version of K7b; the same contract as ``crush_resolve``.

    ``reads``, when given, is an (N,) int64 tensor that gains per lane the
    (slot, round) pairs the kernel evaluates: each loads one ``cand``
    entry and, for a leaf rule, ``n_leaf`` ``leaf`` entries (what a byte
    bound of this weight vector's resolve counts)."""
    N = lane_x.shape[0]
    dev = lane_x.device
    x = lane_x.to(torch.int64) & 0xFFFFFFFF
    w64 = weight.to(torch.int64) & 0xFFFFFFFF
    nr = spec.numrep
    if mode == 1:
        room = torch.full((N,), width, dtype=torch.int64, device=dev)
        r0 = torch.zeros(N, dtype=torch.bool, device=dev)
    else:
        vp = valid.reshape(-1, parents).to(torch.int64)
        vbefore = torch.cumsum(vp, 1) - vp
        room = (width - vbefore * nr).clamp(0, nr).reshape(-1)
        r0 = risk0.clone()
    if spec.firstn:
        sel, lres = _firstn_plain(spec, cand, leaf, x, w64, r0, reads)
    else:
        sel, lres = _indep_plain(spec, cand, leaf, x, w64, r0, room, reads)
    if mode == 1:
        if spec.firstn:
            order = torch.argsort((sel == NONE).to(torch.int32), dim=1,
                                  stable=True)
            sel = torch.gather(sel, 1, order)
        sel = sel[:, :width]
        return torch.where(valid[:, None], sel, NONE), lres
    sel = torch.where(valid[:, None], sel, NONE)
    X = N // parents
    residual = (risk0 | (valid & lres)).reshape(X, parents).any(1)
    if spec.firstn:
        wide = sel.reshape(X, parents * nr)
        order = torch.argsort((wide == NONE).to(torch.int32), dim=1,
                              stable=True)
        out = torch.gather(wide, 1, order)
        counts = (wide != NONE).sum(1).clamp(max=width)
    else:
        vp = valid.reshape(X, parents)
        order = torch.argsort((~vp).to(torch.int32), dim=1, stable=True)
        sel3 = torch.gather(sel.reshape(X, parents, nr), 1,
                            order[:, :, None].expand(X, parents, nr))
        out = sel3.reshape(X, parents * nr)
        counts = (vp.sum(1) * nr).clamp(max=width)
    if out.shape[1] < width:
        out = torch.cat([out, torch.full((X, width - out.shape[1]), NONE,
                                         dtype=torch.int32, device=dev)], 1)
    tail = counts.to(torch.int32) | (residual.to(torch.int32) << 16)
    return torch.cat([out[:, :width], tail[:, None]], 1)


def crush_resolve(spec: ResolveSpec, cand: torch.Tensor,
                  leaf: Optional[torch.Tensor], lane_x: torch.Tensor,
                  valid: torch.Tensor, risk0: torch.Tensor,
                  weight: torch.Tensor, parents: int, width: int,
                  mode: int = 0):
    """K7b.  cand (R, P, N) int32, leaf (R, L, P, N) int32 or None, per
    lane x (int32 bits), valid and initial risk (bool), the epoch's
    weights (int32 bits of u32).

    mode 0 (the last step): -> (N / parents, width + 1) int32 packed rows,
    width = result_max.  mode 1 (a middle step's collision pass) ->
    (picks (N, width) int32, risky (N,) bool), width = its slots.  A CPU
    tensor takes ``crush_resolve_plain``; a CUDA tensor launches the
    kernel on the current stream or raises."""
    N = lane_x.shape[0]
    if cand.dim() != 3 or cand.shape[1] != spec.P or cand.shape[2] != N:
        raise ValueError(f"cand {tuple(cand.shape)} is not (R, P, N)")
    if spec.leafy and (leaf is None
                       or leaf.shape[1:] != (spec.n_leaf, spec.P, N)
                       or leaf.shape[0] != cand.shape[0]):
        raise ValueError("leaf must be (R, L, P, N) for a leaf rule")
    if mode == 0 and N % parents:
        raise ValueError("lanes are not a whole number of parents")
    if lane_x.device.type == "cpu":
        return crush_resolve_plain(spec, cand, leaf, lane_x, valid, risk0,
                                   weight, parents, width, mode)
    if lane_x.device.type != "cuda":
        raise RuntimeError(f"crush_resolve: no kernel for device "
                           f"{lane_x.device}")
    if not 1 <= spec.numrep <= MAX_REP:
        raise ValueError(f"numrep {spec.numrep} outside 1..{MAX_REP}")
    leaf_t = leaf if spec.leafy else cand
    for t in (cand, leaf_t, lane_x, valid, risk0, weight):
        if t.device != lane_x.device or not t.is_contiguous():
            raise ValueError("resolve inputs must be contiguous on one "
                             "device")
    for t in (cand, leaf_t, lane_x, weight):
        if t.dtype != torch.int32:
            raise ValueError("cand, leaf, lane_x and weight must be int32")
    if valid.dtype != torch.bool or risk0.dtype != torch.bool:
        raise ValueError("valid and risk0 must be bool")
    n_x = N if mode == 1 else N // parents
    dev = lane_x.device
    if mode == 1:
        out = torch.empty((N, width), dtype=torch.int32, device=dev)
        risky = torch.empty(N, dtype=torch.bool, device=dev)
    else:
        out = torch.empty((n_x, width + 1), dtype=torch.int32, device=dev)
        risky = out        # not written in mode 0
    if n_x:
        lib = _build.load("crush_fast", _SIGNATURES)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.crush_resolve_launch(
            cand.data_ptr(), leaf_t.data_ptr(), lane_x.data_ptr(),
            valid.data_ptr(), risk0.data_ptr(), weight.data_ptr(),
            out.data_ptr(), risky.data_ptr(), n_x, N, parents, spec.P,
            max(spec.n_leaf, 1), spec.numrep, spec.n_rounds, spec.n_leaf,
            spec.tries, spec.recurse_tries, weight.shape[0],
            int(spec.firstn), int(spec.leafy), int(spec.check_out),
            int(spec.gate), width, mode, stream)
        if rc != 0:
            raise RuntimeError(f"crush_resolve_launch failed: cudaError {rc}")
        resolve_launches.add(1)
    return (out, risky) if mode == 1 else out


def crush_delta_plain(packed: torch.Tensor, prev: torch.Tensor, cap: int,
                      n_flagged: torch.Tensor) -> torch.Tensor:
    """The plain version of K7c; the same contract as ``crush_delta``: a
    cumsum and a scatter, rows past the cap or unchanged parked in slots
    of their own past it."""
    X = packed.shape[0]
    changed = (packed != prev).any(1)
    pos = torch.cumsum(changed, 0) - 1
    ar = torch.arange(X, device=packed.device)
    dest = torch.where(changed & (pos < cap), pos, cap + ar)
    idx = torch.zeros(cap + X, dtype=torch.int32, device=packed.device)
    idx.scatter_(0, dest, ar.to(torch.int32))
    idx = idx[:cap]
    counts = torch.cat([changed.sum(dtype=torch.int32).reshape(1),
                        n_flagged.reshape(1)])
    return torch.cat([counts, idx, packed[idx.long()].reshape(-1)])


def crush_delta(packed: torch.Tensor, prev: torch.Tensor, cap: int,
                n_flagged: torch.Tensor) -> torch.Tensor:
    """K7c: the rows of ``packed`` that differ from ``prev`` (both (X,
    R+1) int32 on one device), as one flat int32 buffer ``[n_changed,
    n_flagged, idx[cap], rows[cap * (R+1)]]``: the first ``min(n_changed,
    cap)`` changed rows' indices in ascending order and their rows, index
    0 and row 0 in the slots past them; ``n_changed`` counts every
    changed row, past the cap too.  A CPU tensor takes
    ``crush_delta_plain``; a CUDA tensor launches the kernel on the
    current stream or raises."""
    if packed.shape != prev.shape or packed.dim() != 2:
        raise ValueError(f"row tables {tuple(packed.shape)} and "
                         f"{tuple(prev.shape)} differ or are not 2-D")
    X, W = packed.shape
    if not 1 <= cap <= X:
        raise ValueError(f"cap {cap} outside 1..{X}")
    if packed.device.type == "cpu":
        return crush_delta_plain(packed, prev, cap, n_flagged)
    if packed.device.type != "cuda":
        raise RuntimeError(f"crush_delta: no kernel for device "
                           f"{packed.device}")
    for t in (packed, prev, n_flagged):
        if t.device != packed.device or not t.is_contiguous() or \
                t.dtype != torch.int32:
            raise ValueError("delta inputs must be contiguous int32 on "
                             "one device")
    n_blocks = -(-X // DELTA_ROWS)
    dev = packed.device
    mask = torch.empty(n_blocks * 32, dtype=torch.int32, device=dev)
    counts = torch.empty(n_blocks, dtype=torch.int32, device=dev)
    out = torch.empty(2 + cap * (W + 1), dtype=torch.int32, device=dev)
    lib = _build.load("crush_fast", _SIGNATURES)
    rc = lib.crush_delta_launch(
        packed.data_ptr(), prev.data_ptr(), X, W, cap, mask.data_ptr(),
        counts.data_ptr(), n_flagged.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"crush_delta_launch failed: cudaError {rc}")
    delta_launches.add(1)
    return out


# ---- the compiled rule ------------------------------------------------------------

class FastRule:
    """Compiled rule: take root; [choose {firstn,indep} n type T;]
    choose[leaf] {firstn,indep} n type T; emit — on the device of ``C``."""

    def __init__(self, C: CompiledCrushMap, ruleno: int, result_max: int,
                 tries_cap: int = 4, leaf_tries_cap: int = 4,
                 choose_args=None, plain: bool = False):
        m = C.map
        self.ruleno = ruleno
        self.choose_args = choose_args
        if not 0 <= ruleno < len(m.rules) or m.rules[ruleno] is None:
            raise UnsupportedRule(f"no rule {ruleno}")
        rule = m.rules[ruleno]
        choose_tries = m.choose_total_tries + 1
        leaf_tries = 0
        vary_r = m.chooseleaf_vary_r
        stable = m.chooseleaf_stable
        take = None
        chooses: List = []
        for step in rule.steps:
            if step.op == CRUSH_RULE_SET_CHOOSE_TRIES:
                if step.arg1 > 0:
                    choose_tries = step.arg1
            elif step.op == CRUSH_RULE_SET_CHOOSELEAF_TRIES:
                if step.arg1 > 0:
                    leaf_tries = step.arg1
            elif step.op == CRUSH_RULE_SET_CHOOSELEAF_VARY_R:
                if step.arg1 >= 0:
                    vary_r = step.arg1
            elif step.op == CRUSH_RULE_SET_CHOOSELEAF_STABLE:
                if step.arg1 >= 0:
                    stable = step.arg1
            elif step.op in (CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES,
                             CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES):
                if step.arg1 > 0:
                    raise UnsupportedRule("local tries")
            elif step.op == CRUSH_RULE_TAKE:
                if take is not None:
                    raise UnsupportedRule("multiple takes")
                take = step.arg1
            elif step.op in (CRUSH_RULE_CHOOSE_FIRSTN,
                             CRUSH_RULE_CHOOSELEAF_FIRSTN,
                             CRUSH_RULE_CHOOSE_INDEP,
                             CRUSH_RULE_CHOOSELEAF_INDEP):
                chooses.append(step)
            elif step.op == CRUSH_RULE_EMIT:
                pass
            else:
                raise UnsupportedRule(f"op {step.op}")
        if take is None or not chooses or take >= 0:
            raise UnsupportedRule("rule shape")
        # chained choose steps: every step but the last selects buckets,
        # resolvable from topology alone, so the whole chain lives in the
        # cached candidate phase; only the last step depends on weights
        self.mid_stages: List[dict] = []
        if len(chooses) > 2:
            raise UnsupportedRule("more than two choose steps")
        for step in chooses[:-1]:
            if step.op in (CRUSH_RULE_CHOOSELEAF_FIRSTN,
                           CRUSH_RULE_CHOOSELEAF_INDEP):
                raise UnsupportedRule("chooseleaf before the last step")
            if step.arg2 == 0:
                raise UnsupportedRule("device choose before the last step")
            n = step.arg1
            if n <= 0:
                n += result_max
            if n <= 0:
                raise UnsupportedRule("numrep")
            if n > MAX_REP:
                raise UnsupportedRule(f"more than {MAX_REP} slots")
            self.mid_stages.append({
                "firstn": step.op == CRUSH_RULE_CHOOSE_FIRSTN,
                # numrep keeps the step's r spacing; the step can only
                # FILL min(numrep, result_max) slots (out_size room)
                "numrep": n, "slots": min(n, result_max),
                "type": step.arg2,
            })
        choose = chooses[-1]
        self.firstn = choose.op in (CRUSH_RULE_CHOOSE_FIRSTN,
                                    CRUSH_RULE_CHOOSELEAF_FIRSTN)
        self.leafy = choose.op in (CRUSH_RULE_CHOOSELEAF_FIRSTN,
                                   CRUSH_RULE_CHOOSELEAF_INDEP)
        numrep = choose.arg1
        if numrep <= 0:
            numrep += result_max
        if numrep <= 0:
            raise UnsupportedRule("numrep")
        self.numrep = min(numrep, result_max) if not self.firstn else numrep
        if self.numrep > MAX_REP:
            raise UnsupportedRule(f"more than {MAX_REP} slots")
        self.target_type = choose.arg2
        if self.firstn and self.leafy and not stable:
            # the leaf draw's rep depends on the dynamic success count
            # without the stable tunable (mapper.c:545)
            raise UnsupportedRule("firstn chooseleaf needs stable=1")
        # firstn indexes weight sets by the dynamic success count
        # (mapper.c:513), so with per-position weight sets the candidates
        # are materialised for every position the walk could be at
        self.posP = min(C.npos, self.numrep) if self.firstn else 1
        if self.leafy:
            if leaf_tries:
                recurse = leaf_tries
            elif self.firstn:
                recurse = 1 if m.chooseleaf_descend_once else choose_tries
            else:
                recurse = 1
        else:
            recurse = 1
        self.take = take
        self.vary_r = vary_r
        self.tries = choose_tries
        self.recurse_tries = recurse
        self.n_rounds = min(tries_cap + 1, choose_tries)
        self.n_leaf = min(leaf_tries_cap + 1, recurse)
        frontier = [take]
        base = 0
        self.parents = 1          # lanes per x feeding the last stage
        for st in self.mid_stages:
            st["posP"] = min(C.npos, st["numrep"]) if st["firstn"] else 1
            d = _layer_path_frontier(m, frontier, st["type"])
            st["depth"] = d
            st["base_level"] = base
            st["tries"] = choose_tries
            st["n_rounds"] = min(tries_cap + 1, choose_tries)
            base += d
            for _ in range(d):
                frontier = _advance(m, frontier)
            self.parents *= st["slots"]
        self.base_level = base
        self.depth = base + _layer_path_frontier(m, frontier,
                                                 self.target_type)
        self.last_depth = self.depth - self.base_level
        self.leaf_depth = 0
        if self.leafy and self.target_type != 0:
            frontier = [take]
            for _ in range(self.depth):
                nxt = []
                for b in frontier:
                    nxt.extend(i for i in m.bucket(b).items)
                frontier = nxt
            if all(i >= 0 for i in frontier):
                self.leaf_depth = 0
            else:
                self.leaf_depth = _layer_path(m, frontier[0], 0)
                for f in frontier:
                    if _layer_path(m, f, 0) != self.leaf_depth:
                        raise UnsupportedRule("uneven leaf depth")
        if not 1 <= result_max <= MAX_REP:
            raise UnsupportedRule(f"result_max {result_max} outside "
                                  f"1..{MAX_REP}")
        self.C = C
        self.device = C.device
        self.result_max = result_max
        self.tables = self._build_tables()
        # K6's program: the whole rule, for the x the round caps flag
        self.program = C.compile_rule(ruleno, result_max)
        self.spec = ResolveSpec(
            numrep=self.numrep, n_rounds=self.n_rounds, tries=self.tries,
            firstn=self.firstn, P=self.posP,
            n_leaf=self.n_leaf,
            recurse_tries=self.recurse_tries, leafy=self.leafy,
            check_out=not self.leafy and self.target_type == 0,
            gate=self.firstn)
        self._descend = crush_descend_plain if plain else crush_descend
        self._resolve = crush_resolve_plain if plain else crush_resolve
        self._rule = crush_rule_plain_into if plain else crush_rule
        self._delta = crush_delta_plain if plain else crush_delta
        self._xd: Optional[torch.Tensor] = None
        self._n_flagged: Optional[torch.Tensor] = None
        self._cand_key: Optional[bytes] = None
        self._cand = None
        # per-epoch delta state: the previous epoch's packed rows on the
        # device and the exact host mirror they correspond to
        self._prev_packed = None
        self._host_out: Optional[np.ndarray] = None
        self._host_counts: Optional[np.ndarray] = None
        self._residual_frac = 0.0
        self.delta_cap = 8192

    # ---- exact integer draw tables ----------------------------------------
    def _build_tables(self) -> DescentTables:
        """Per-level eligibility + shared per-w i32 quotient tables.

        A level draws from the tables iff every bucket its frontier can
        present has uniform item weights >= QTABLE_MIN_W and no
        choose_args weight set overrides them."""
        m = self.C.map
        n_main = self.depth
        n_leaf_lvls = self.leaf_depth if self.leaf_depth else (
            1 if (self.leafy and self.target_type != 0) else 0)
        frontiers = _level_frontiers(m, self.take, n_main)
        if n_leaf_lvls:
            fd_buckets = _level_frontiers(m, self.take, n_main + 1)[n_main]
            merged: List[List[int]] = [[] for _ in range(n_leaf_lvls)]
            for fd in fd_buckets:
                for li, lvl in enumerate(
                        _level_frontiers(m, fd, n_leaf_lvls)):
                    merged[li].extend(lvl)
            frontiers = frontiers + merged
        self.level_frontiers = frontiers
        w_to_idx = {}
        tables: List[np.ndarray] = []
        qidx = np.zeros(self.C.nbuckets, dtype=np.int32)
        lvl_int: List[bool] = []
        use_pos_weights = self.C.npos > 1 or self.choose_args is not None
        for lvl in frontiers:
            ok = not use_pos_weights
            for bid in lvl:
                ws = list(m.bucket(bid).item_weights)
                if not ws or min(ws) != max(ws) or ws[0] < QTABLE_MIN_W:
                    ok = False
                    break
            if ok:
                for bid in lvl:
                    w = int(m.bucket(bid).item_weights[0])
                    if w not in w_to_idx:
                        w_to_idx[w] = len(tables)
                        tables.append(quotient_table(w))
                    qidx[-1 - bid] = w_to_idx[w]
            lvl_int.append(ok)
        dev = self.device
        qt = (np.stack(tables) if tables
              else np.zeros((1, 1), dtype=np.int32))
        magic = straw2_magic(self.C._weights_np).view(np.int64)
        q64 = item_quotient_tables(self.C._weights_np)
        if q64 is not None:
            q64 = [torch.from_numpy(t).to(dev) for t in q64]
        return DescentTables(self.C, torch.from_numpy(qidx).to(dev),
                             torch.from_numpy(qt).to(dev), g_table(dev),
                             tuple(lvl_int), g15_table(dev),
                             torch.from_numpy(magic).to(dev),
                             *(q64 or (None, None)))

    # ---- candidate phase (topology only; cached across epochs) -------------
    def _mid_candidates(self, st: dict, xl, roots, valid):
        """Candidates and the collision-only resolution of one middle
        choose step over N parent lanes: picks (N, slots), risky (N,)."""
        n, rounds, P = st["numrep"], st["n_rounds"], st["posP"]
        R = n + rounds - 1 if st["firstn"] else n * rounds
        cand, _ = self._descend(xl, roots, self.tables, DescentSpec(
            R, P, st["base_level"], st["depth"]))
        spec = ResolveSpec(numrep=n, n_rounds=rounds, tries=st["tries"],
                           firstn=st["firstn"], P=P)
        none = torch.zeros(1, dtype=torch.int32, device=xl.device)
        return self._resolve(spec, cand, None, xl, valid,
                             torch.zeros_like(valid), none, 1, st["slots"],
                             1)

    def descent_spec(self) -> DescentSpec:
        """The last stage's K7a launch: the failure-domain candidates and,
        for a leaf rule, their leaf attempts."""
        R = (self.numrep + self.n_rounds - 1 if self.firstn
             else self.numrep * self.n_rounds)
        L = leaf_depth = 0
        if self.leafy:
            L = self.n_leaf
            # chooseleaf over devices: every leaf attempt is the item itself
            if self.leaf_depth or self.target_type != 0:
                leaf_depth = self.leaf_depth or 1
        return DescentSpec(R, self.posP, self.base_level, self.last_depth,
                           L=L, leaf_depth=leaf_depth,
                           leaf_firstn=self.firstn, vary_r=self.vary_r,
                           numrep=self.numrep)

    def _candidates(self, xd: torch.Tensor):
        """The candidate phase: the middle steps' descents and collision
        passes, then one K7a launch over all (x, parent, retry, position)
        lanes that draws the candidates and their leaf attempts.

        Returns cand (R, P, N) failure-domain items, leaf (R, L, P, N)
        leaf items (None when not leafy), the initial per-lane risk (N,),
        valid (N,) and the per-lane x (N,), N = X * parents."""
        X = xd.shape[0]
        dev = xd.device
        xl = xd
        roots = torch.full((X,), -1 - self.take, dtype=torch.int32,
                           device=dev)
        valid = torch.ones(X, dtype=torch.bool, device=dev)
        risky = torch.zeros(X, dtype=torch.bool, device=dev)
        for st in self.mid_stages:
            sel, rk = self._mid_candidates(st, xl, roots, valid)
            n = st["slots"]
            risky = (risky | rk).repeat_interleave(n)
            xl = xl.repeat_interleave(n)
            flat = sel.reshape(-1)
            valid = valid.repeat_interleave(n) & (flat != NONE)
            roots = (-1 - flat).clamp(min=0)
        cand, leaf = self._descend(xl, roots, self.tables,
                                   self.descent_spec())
        if self.posP == 1:
            # without positions a lane's middle-step risk rolls up to its x
            risky = risky.view(X, self.parents).any(1).repeat_interleave(
                self.parents)
        return cand, leaf, risky, valid, xl

    # ---- resolution phase (per weight vector) ------------------------------
    def resolve_packed(self, weight: torch.Tensor) -> torch.Tensor:
        """K7b: (X, result_max + 1) int32 packed rows for ``weight`` (int32
        bits of the u32 weights, on the rule's device) against the cached
        candidates: EMIT-compacted slots, then ``count | residual << 16``.
        A residual row's slots are a guess; ``exact_packed`` finishes it."""
        if self._cand is None:
            raise RuntimeError("no candidate tables; call "
                               "prepare_candidates(xs) first")
        cand, leaf, risk0, valid, xl = self._cand
        return self._resolve(self.spec, cand, leaf, xl, valid, risk0,
                             weight, self.parents, self.result_max, 0)

    def exact_packed(self, weight: torch.Tensor) -> torch.Tensor:
        """K7b's rows with every flagged x recomputed by K6: the flagged
        rows' indices are compacted on the device (``flagged_index``: a
        cumsum and a scatter, no host sync), and K6 runs the whole rule for
        the first ``n_flagged`` of them, writing each exact row, its count
        in the tail with the residual bit clear.  ``self._n_flagged`` keeps
        the device count."""
        if self._cand is None:
            raise RuntimeError("no candidate tables; call "
                               "prepare_candidates(xs) first")
        packed, self._n_flagged, _idx = self.exact_rows(self._cand,
                                                        self._xd, weight)
        return packed

    def exact_rows(self, cand, xd: torch.Tensor, weight: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``exact_packed`` for the x of ``xd`` against the candidate
        tables ``cand`` (``_candidates(xd)``), leaving this rule's own
        cache alone: K7b, then K6 on the rows it flagged.  Returns
        (packed, n_flagged, idx), all on the device; the first n_flagged
        entries of idx are the flagged rows in order.  The sharded rule
        (``parallel/crush.py``) calls it once per mesh member."""
        c, leaf, risk0, valid, xl = cand
        packed = self._resolve(self.spec, c, leaf, xl, valid, risk0,
                               weight, self.parents, self.result_max, 0)
        idx, n_flagged = self.flagged_index(packed)
        self._rule(self.program, xd, weight, idx=idx, n_live=n_flagged,
                   packed=packed)
        return packed, n_flagged, idx

    def flagged_index(self, packed: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The rows K7b flagged, on the device: (idx (2X,) int32 whose
        first n entries are their indices in order, n (1,) int32)."""
        X = packed.shape[0]
        flagged = (packed[:, self.result_max] >> 16) != 0
        pos = torch.cumsum(flagged, 0, dtype=torch.int32) - 1
        # an unflagged row parks its index in a slot of its own past X
        ar = torch.arange(X, dtype=torch.int32, device=packed.device)
        idx = torch.empty(2 * X, dtype=torch.int32, device=packed.device)
        idx.scatter_(0, torch.where(flagged, pos, X + ar).long(), ar)
        return idx, flagged.sum(dtype=torch.int32).reshape(1)

    # ---- public -----------------------------------------------------------
    def prepare_candidates(self, xs: np.ndarray) -> None:
        """Compute (or reuse) the candidate tables for this batch of x on
        the rule's device.  Topology only: reused across weight vectors."""
        xs = np.ascontiguousarray(xs, dtype=np.uint32)
        key = hashlib.sha1(xs.tobytes()).digest()
        if self._cand_key != key:
            g_devprof.account_h2d("crush.candidates", xs.nbytes)
            with g_devprof.stage("crush.candidates"):
                xd = torch.from_numpy(xs.view(np.int32)).to(self.device)
                self._cand = self._candidates(xd)
            self._xd = xd
            self._cand_key = key
            self._prev_packed = None
            self._host_out = None
            self._host_counts = None

    def map_batch(self, xs: np.ndarray, weight: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """Map every x; exact.  Returns (results [X, result_max] int32,
        counts [X]).  Candidates are cached keyed by the batch of x:
        calling again with the same xs (the whole-map remap of every
        epoch) re-runs only the resolution with the new weights, and
        fetches only the rows that changed."""
        xs = np.ascontiguousarray(xs, dtype=np.uint32)
        w32 = np.ascontiguousarray(weight, dtype=np.uint32)
        self.prepare_candidates(xs)
        R = self.result_max
        X = xs.shape[0]
        g_devprof.account_h2d("crush.map_batch", w32.nbytes)
        with g_devprof.stage("crush.map_batch"):
            wd = torch.from_numpy(w32.view(np.int32)).to(self.device)
            packed = g_kernel_timer.timed("crush_resolve",
                                          self.exact_packed, wd)
        cap = min(self.delta_cap, X)
        if self._prev_packed is not None and self._host_out is not None:
            with g_devprof.stage("crush.map_batch"):
                flat = self._delta(packed, self._prev_packed, cap,
                                   self._n_flagged).cpu().numpy()
            g_devprof.account_d2h("crush.map_batch", flat.nbytes)
            n_changed = int(flat[0])
            self._residual_frac = int(flat[1]) / X
            if n_changed <= cap:
                out, counts = self._host_out, self._host_counts
                if n_changed:
                    idxs = flat[2:2 + n_changed].copy()
                    rows = flat[2 + cap:].reshape(cap, R + 1)[:n_changed]
                    out[idxs] = rows[:, :R]
                    counts[idxs] = rows[:, R]
                self._prev_packed = packed
                return out.copy(), counts.copy()
            # overflow: full fetch, and a larger cap for the next epochs
            self.delta_cap = min(2 * self.delta_cap, max(X, 1))
        flat = torch.cat([self._n_flagged, packed.reshape(-1)]).cpu().numpy()
        g_devprof.account_d2h("crush.map_batch", flat.nbytes)
        full = flat[1:].reshape(X, R + 1)
        out = full[:, :R].copy()
        counts = full[:, R].copy()
        self._residual_frac = int(flat[0]) / X if X else 0.0
        self._prev_packed = packed
        self._host_out = out
        self._host_counts = counts
        return out.copy(), counts.copy()

    @property
    def residual_fraction(self) -> float:
        """Share of the last ``map_batch``'s x that K7b flagged (the round
        caps stopped short of the rule's tries), all finished by K6."""
        return self._residual_frac

    @property
    def host_replayed(self) -> int:
        """x of the last ``map_batch`` recomputed on the host: none, since
        K6 finishes every flagged x on the rule's device.  A read-out for
        the drives that assert it (the JAX package has no such count)."""
        return 0

    @property
    def integer_exact_levels(self) -> List[bool]:
        """Per level: True where draws use the i32 quotient table."""
        return list(self.tables.int_levels)


def compile_fast_rule(m: CrushMap, ruleno: int, result_max: int,
                      choose_args=None, device="cuda", **kw) -> FastRule:
    """Compile ``ruleno`` of ``m`` for ``device`` ("cuda" unless the
    caller asks for the CPU).  Raises ``UnsupportedRule`` (a ValueError)
    or ``compile_map``'s ValueError for a rule or map out of scope."""
    C = compile_map(m, choose_args, device)
    return FastRule(C, ruleno, result_max, choose_args=choose_args, **kw)
