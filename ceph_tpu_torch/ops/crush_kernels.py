"""The dense form of a straw2 CRUSH map for the card, rjenkins and crush_ln
in torch, and K6: the whole-rule mapper.

Port of ``ceph_tpu/ops/crush_kernels.py``.  ``CompiledCrushMap`` /
``compile_map`` hold the map as tensors; ``CompiledCrushMap.compile_rule``
turns a rule's steps into a small int program.  K6 (``crush_rule``, the
kernel ``crush_rule_launch`` of ``csrc/crush_fast.cu``) runs that program
for each x with the rule's full ``choose_tries`` / ``recurse_tries``: the
JAX module's vmapped ``DeviceCrushMapper`` (``:436-558``), ``_descend``,
``_choose_firstn``, ``_choose_indep`` and the EMIT compaction.  Over an
index list (the x K7b flags) it runs one warp per x, whose lanes share
each straw2 draw and hold the slots; over a whole list of x, one thread
per x (there the x of a warp mostly walk the same steps, and that form
measured faster on the card for a firstn rule).  Its plain version
``crush_rule_plain`` runs every x at once as masked loops.  Both follow
the host ``crush_do_rule`` (mapper.c:883-1087) to the letter, so their
rows are that function's rows.  The candidate-table
mapper (``ops/crush_fast.py``) sends K6 the x its round caps leave
unresolved.

The hashes are the plain torch versions of the ones in
``csrc/crush_fast.cu``: torch has no full uint32 arithmetic on the CPU, so
they run in int64 with every step masked to 32 bits (``>>`` of a
non-negative int64 is the logical shift the reference uses).  Inputs are
integer tensors holding u32 values or their int32 bits; the result is an
int64 tensor in [0, 2^32).  ``crush_ln_dev`` is the JAX module's LUT form
in int64; the kernels gather ``G = 2^48 - crush_ln`` from a table
(``G_EXACT``) instead, which the tests hold equal to it.

A CUDA tensor goes to the kernel or raises; only tensors on the CPU take
the plain version.  ``rule_launches.n`` counts K6 launches.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..crush.constants import (
    CRUSH_BUCKET_STRAW, CRUSH_BUCKET_STRAW2, CRUSH_ITEM_NONE,
    CRUSH_ITEM_UNDEF,
    CRUSH_RULE_CHOOSELEAF_FIRSTN, CRUSH_RULE_CHOOSELEAF_INDEP,
    CRUSH_RULE_CHOOSE_FIRSTN, CRUSH_RULE_CHOOSE_INDEP, CRUSH_RULE_EMIT,
    CRUSH_RULE_SET_CHOOSELEAF_STABLE, CRUSH_RULE_SET_CHOOSELEAF_TRIES,
    CRUSH_RULE_SET_CHOOSELEAF_VARY_R, CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
    CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES, CRUSH_RULE_SET_CHOOSE_TRIES,
    CRUSH_RULE_TAKE,
)
from ..crush.ln import LL_NP, RH_LH_NP, crush_ln_np
from ..crush.types import CrushMap
from . import _build
from .gf_matmul import resolve_device
from .gf_pallas import LaunchCounter

M32 = 0xFFFFFFFF
NONE = CRUSH_ITEM_NONE
UNDEF = CRUSH_ITEM_UNDEF
_SEED = 1315423911
_PAD1 = 231232
_PAD2 = 1232
MAX_DESCENT = 12              # > CRUSH_MAX_DEPTH (crush.h:26), as the JAX module
MAX_REP = 32                  # kMaxRep of csrc/crush_fast.cu: slots of a step, K6's row

_VP = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# every entry point of csrc/crush_fast.cu (K6 here, K7a/K7b in crush_fast.py)
_SIGNATURES = {
    "crush_descend_launch": (
        [_VP, _VP, _VP, _VP, _LL, _I, _I, _I,
         _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
         _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _VP], _I),
    "crush_resolve_launch": (
        [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _LL, _LL,
         _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _VP],
        _I),
    "crush_rule_launch": (
        [_VP, _VP, _VP, _LL, _VP, _VP, _LL, _I,
         _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I,
         _VP, _I, _VP, _I, _I, _VP], _I),
    "crush_delta_launch": (
        [_VP, _VP, _LL, _I, _I, _VP, _VP, _VP, _VP, _VP], _I),
}

rule_launches = LaunchCounter()       # K6


# ---- rjenkins (crush/hash.c) in int64 lanes masked to 32 bits --------------

def _mix(a, b, c):
    a = (a - b - c) & M32; a = a ^ (c >> 13)
    b = (b - c - a) & M32; b = b ^ ((a << 8) & M32)
    c = (c - a - b) & M32; c = c ^ (b >> 13)
    a = (a - b - c) & M32; a = a ^ (c >> 12)
    b = (b - c - a) & M32; b = b ^ ((a << 16) & M32)
    c = (c - a - b) & M32; c = c ^ (b >> 5)
    a = (a - b - c) & M32; a = a ^ (c >> 3)
    b = (b - c - a) & M32; b = b ^ ((a << 10) & M32)
    c = (c - a - b) & M32; c = c ^ (b >> 15)
    return a, b, c


def _u32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int64) & M32


def hash32_2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(_u32(a), _u32(b))
    h = a ^ b ^ _SEED
    x = torch.full_like(h, _PAD1)
    y = torch.full_like(h, _PAD2)
    a, b, h = _mix(a, b, h)
    x, a, h = _mix(x, a, h)
    b, y, h = _mix(b, y, h)
    return h


def hash32_3(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
             ) -> torch.Tensor:
    a, b, c = torch.broadcast_tensors(_u32(a), _u32(b), _u32(c))
    h = a ^ b ^ c ^ _SEED
    x = torch.full_like(h, _PAD1)
    y = torch.full_like(h, _PAD2)
    a, b, h = _mix(a, b, h)
    c, x, h = _mix(c, x, h)
    y, a, h = _mix(y, a, h)
    b, x, h = _mix(b, x, h)
    y, c, h = _mix(y, c, h)
    return h


# ---- crush_ln (mapper.c:243-290) in int64 lanes --------------------------------

@functools.lru_cache(maxsize=None)
def _ln_tables(device: torch.device):
    return (torch.from_numpy(RH_LH_NP.astype(np.int64)).to(device),
            torch.from_numpy(LL_NP.astype(np.int64)).to(device))


def crush_ln_dev(u: torch.Tensor) -> torch.Tensor:
    """2^44*log2(u+1) fixed point for u in [0, 0xffff]: the JAX module's
    ``crush_ln_dev`` (two 256-entry LUT gathers) in int64.  The u64
    product x*rh of the reference is taken as 2^32 (x*rh_hi) + x*rh_lo,
    whose bits 48..55 are all the second gather needs, so nothing
    overflows."""
    rh_lh, ll_t = _ln_tables(u.device)
    x = (u.to(torch.int64) + 1) & M32
    v = x & 0x1FFFF
    blen = (v[..., None] >> torch.arange(17, device=u.device)).ne(0).sum(-1)
    need = (x & 0x18000) == 0
    bits = torch.where(need, 16 - blen, 0)
    x = x << bits
    iexpon = torch.where(need, 15 - bits, 15)
    index1 = (x >> 8) << 1
    rh = rh_lh[index1 - 256]
    lh = rh_lh[index1 + 1 - 256]
    hi = x * (rh >> 32) + ((x * (rh & M32)) >> 32)     # floor(x*rh / 2^32)
    index2 = (hi >> 16) & 0xFF                           # (x*rh >> 48) & 0xff
    return (iexpon << 44) + ((lh + ll_t[index2]) >> 4)


# ---- exact integer draw tables ----------------------------------------------

def _build_g_table() -> np.ndarray:
    """G[u] = 2^48 - crush_ln(u) for every 16-bit u (exact int64): the
    straw2 draw -floor(G/w) (mapper.c:322-367) as a gather and a divide."""
    us = np.arange(0x10000, dtype=np.uint32)
    g = (np.uint64(1) << np.uint64(48)) - crush_ln_np(us)
    return g.astype(np.int64)


G_EXACT = _build_g_table()

# minimum uniform weight eligible for a quotient table: floor(G/w) must fit
# the biased-i32 encoding (G_max = 2^48)
QTABLE_MIN_W = 0x10000
_QBIAS = np.int64(1) << np.int64(31)
# K6 keeps at most this many quotient tables (256 KiB each); buckets of any
# further weight draw on the s64 divide
_RULE_MAX_TABLES = 64


def quotient_table(w: int) -> np.ndarray:
    """i32 table T[u] = floor(G(u)/w) - 2^31, order- and tie-exact for
    w >= 0x10000.  The unique u=0 entry (G = 2^48, q may hit exactly
    2^32) is clamped by 1: the runner-up G is 2^48 - 2^44, far more than
    w below the clamp for every w <= 2^31."""
    q = G_EXACT // np.int64(w)
    q = np.minimum(q, (np.int64(1) << np.int64(32)) - 1)
    return (q - _QBIAS).astype(np.int32)


@functools.lru_cache(maxsize=None)
def g_table(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(G_EXACT).to(device)


# ---- compiled map -----------------------------------------------------------

# columns of a compiled rule program (one row per TAKE / choose / EMIT step)
P_OP, P_ARG, P_TYPE, P_NUMREP, P_TRIES, P_RECURSE, P_VARY_R, P_STABLE = \
    range(8)
_CHOOSE_OPS = (CRUSH_RULE_CHOOSE_FIRSTN, CRUSH_RULE_CHOOSELEAF_FIRSTN,
               CRUSH_RULE_CHOOSE_INDEP, CRUSH_RULE_CHOOSELEAF_INDEP)


@dataclass
class RuleProgram:
    """One rule compiled for ``result_max``: ``steps`` (n, 8) int32 on the
    map's device and ``rows`` (the same, numpy).  A row is TAKE (arg = the
    item), EMIT, or a choose op with its type, its numrep after the
    result_max expansion (0: the step leaves nothing), and the tries,
    recurse tries, vary_r and stable in force there.  SET_* steps are
    folded into the rows after them and a TAKE of nothing is dropped,
    as ``crush_do_rule`` ignores it."""
    cm: "CompiledCrushMap"
    result_max: int
    rows: np.ndarray
    steps: torch.Tensor


class CompiledCrushMap:
    """Dense-tensor form of a straw2 CrushMap (+choose_args) on ``device``.

    Buckets are indexed by ``-1 - id``; rows are padded to the largest
    bucket (``max_size``) with CRUSH_ITEM_NONE.  ``weights`` (npos, nb, S)
    carries the per-position straw2 weight sets (crush.h:273
    crush_choose_arg) as the int32 bits of their u32 values; position 0 is
    the plain item_weights when no choose_args are attached.  ``hash_ids``
    differ from ``items`` where a choose_arg sets ``ids``.  ``types`` (nb,)
    is each bucket's type, -1 where the map has no bucket.

    ``allow_legacy`` also admits straw (v1) buckets and pre-bobtail
    local-tries tunables, for the legacy mapper (``ops/crush_legacy.py``),
    which models them; the other mappers do not.  ``algs`` (nb,) numpy is
    each bucket's alg and ``straws`` (nb, S) the straw (v1) scalers as the
    int32 bits of their u32 values (None unless ``allow_legacy``).
    """

    def __init__(self, m: CrushMap, choose_args: Optional[Sequence] = None,
                 device="cuda", allow_legacy: bool = False):
        dev = resolve_device(device)
        nb = len(m.buckets)
        S = max((b.size for b in m.buckets if b is not None), default=1)
        S = max(S, 1)
        items = np.full((nb, S), CRUSH_ITEM_NONE, dtype=np.int32)
        hash_ids = np.zeros((nb, S), dtype=np.int32)
        sizes = np.zeros(nb, dtype=np.int32)
        types = np.full(nb, -1, dtype=np.int32)
        npos = 1
        if choose_args is not None:
            for arg in choose_args:
                if arg is not None and arg.weight_set:
                    npos = max(npos, len(arg.weight_set))
        weights = np.zeros((npos, nb, S), dtype=np.uint32)
        algs = np.zeros(nb, dtype=np.int32)
        straws = np.zeros((nb, S), dtype=np.uint32)
        for bi, b in enumerate(m.buckets):
            if b is None:
                continue
            if b.size and b.alg != CRUSH_BUCKET_STRAW2:
                if not (allow_legacy and b.alg == CRUSH_BUCKET_STRAW):
                    raise ValueError(
                        "device mapper supports straw2 buckets only")
                straws[bi, :b.size] = np.asarray(b.straws, dtype=np.uint32)
            algs[bi] = b.alg
            sizes[bi] = b.size
            types[bi] = b.type
            items[bi, :b.size] = b.items
            hash_ids[bi, :b.size] = b.items
            for it in b.items:
                if it >= 0 and it >= m.max_devices:
                    raise ValueError("bucket item beyond max_devices")
                if it < 0 and m.bucket(it) is None:
                    raise ValueError("dangling bucket reference")
            w = np.asarray(b.item_weights, dtype=np.uint32)
            weights[:, bi, :b.size] = w[None, :]
            arg = None
            if choose_args is not None and bi < len(choose_args):
                arg = choose_args[bi]
            if arg is not None:
                if arg.weight_set:
                    for p in range(npos):
                        ws = arg.weight_set[min(p, len(arg.weight_set) - 1)]
                        weights[p, bi, :b.size] = np.asarray(
                            ws.weights, dtype=np.uint32)
                if arg.ids:
                    hash_ids[bi, :b.size] = arg.ids
        if not allow_legacy and (m.choose_local_tries
                                 or m.choose_local_fallback_tries):
            raise ValueError("device mapper requires bobtail+ tunables "
                             "(choose_local_*_tries == 0)")
        self.map = m
        self.device = dev
        self.nbuckets = nb
        self.max_size = S
        self.npos = npos
        self._weights_np = weights
        self._sizes_np = sizes
        self.items = torch.from_numpy(items).to(dev)
        self.hash_ids = torch.from_numpy(hash_ids).to(dev)
        self.sizes = torch.from_numpy(sizes).to(dev)
        self.types = torch.from_numpy(types).to(dev)
        self.weights = torch.from_numpy(weights.view(np.int32)).to(dev)
        self.algs = algs
        self.straws = (torch.from_numpy(straws.view(np.int32)).to(dev)
                       if allow_legacy else None)
        self._draw_tables = None

    def draw_tables(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """K6's per-bucket draw: (qsel (nb,) int32, qtables (n, 65536)
        int32, G).  A bucket whose items all weigh one w >= 0x10000 at
        every position draws from quotient table ``qsel``; any other (qsel
        -1) draws the s64 quotient G[u] // w.  Both are exact."""
        if self._draw_tables is None:
            qsel = np.full(self.nbuckets, -1, dtype=np.int32)
            w_to_idx: dict = {}
            tables = []
            for bi in range(self.nbuckets):
                n = int(self._sizes_np[bi])
                if n == 0:
                    continue
                ws = self._weights_np[:, bi, :n]
                w = int(ws.flat[0])
                if w < QTABLE_MIN_W or (ws != w).any():
                    continue
                if w not in w_to_idx:
                    if len(tables) == _RULE_MAX_TABLES:
                        continue
                    w_to_idx[w] = len(tables)
                    tables.append(quotient_table(w))
                qsel[bi] = w_to_idx[w]
            qt = (np.stack(tables) if tables
                  else np.zeros((1, 1), dtype=np.int32))
            self._draw_tables = (torch.from_numpy(qsel).to(self.device),
                                 torch.from_numpy(qt).to(self.device),
                                 g_table(self.device))
        return self._draw_tables

    def compile_rule(self, ruleno: int, result_max: int) -> RuleProgram:
        """The rule program of ``ruleno`` (``DeviceCrushMapper._one_x``'s
        step walk, done once on the host).  Raises ValueError where the
        JAX mapper does: no such rule, or local tries set by a step."""
        m = self.map
        if not 0 <= ruleno < len(m.rules) or m.rules[ruleno] is None:
            raise ValueError(f"no rule {ruleno}")
        choose_tries = m.choose_total_tries + 1  # mapper.c:905 off-by-one
        choose_leaf_tries = 0
        vary_r = m.chooseleaf_vary_r
        stable = m.chooseleaf_stable
        rows = []
        for step in m.rules[ruleno].steps:
            op = step.op
            if op == CRUSH_RULE_TAKE:
                if (0 <= step.arg1 < m.max_devices
                        or m.bucket(step.arg1) is not None):
                    rows.append([op, step.arg1, 0, 0, 0, 0, 0, 0])
            elif op == CRUSH_RULE_SET_CHOOSE_TRIES:
                if step.arg1 > 0:
                    choose_tries = step.arg1
            elif op == CRUSH_RULE_SET_CHOOSELEAF_TRIES:
                if step.arg1 > 0:
                    choose_leaf_tries = step.arg1
            elif op in (CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES,
                        CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES):
                if step.arg1 > 0:
                    raise ValueError("local tries unsupported on device")
            elif op == CRUSH_RULE_SET_CHOOSELEAF_VARY_R:
                if step.arg1 >= 0:
                    vary_r = step.arg1
            elif op == CRUSH_RULE_SET_CHOOSELEAF_STABLE:
                if step.arg1 >= 0:
                    stable = step.arg1
            elif op in _CHOOSE_OPS:
                numrep = step.arg1
                if numrep <= 0:
                    numrep = max(numrep + result_max, 0)
                if op in (CRUSH_RULE_CHOOSE_FIRSTN,
                          CRUSH_RULE_CHOOSELEAF_FIRSTN):
                    if choose_leaf_tries:
                        recurse = choose_leaf_tries
                    elif m.chooseleaf_descend_once:
                        recurse = 1
                    else:
                        recurse = choose_tries
                else:
                    recurse = choose_leaf_tries if choose_leaf_tries else 1
                rows.append([op, 0, step.arg2, numrep, choose_tries, recurse,
                             vary_r, stable])
            elif op == CRUSH_RULE_EMIT:
                rows.append([op, 0, 0, 0, 0, 0, 0, 0])
        arr = np.asarray(rows, dtype=np.int32).reshape(-1, 8)
        return RuleProgram(self, result_max, arr,
                           torch.from_numpy(arr).to(self.device))


def compile_map(m: CrushMap, choose_args=None,
                device="cuda") -> CompiledCrushMap:
    """Host-side compilation; raises ValueError if the map is not one the
    card's mapper takes (straw2 only, bobtail+ tunables)."""
    return CompiledCrushMap(m, choose_args, device)


# ---- K6's plain version ---------------------------------------------------------

_OK, _DEAD, _EMPTY = 0, 1, 2


class _Lanes:
    """What the plain rule walk reads: the map tables, G, the epoch's
    weights (int64 u32 values) and, when counting, the draws per x."""

    def __init__(self, cm: CompiledCrushMap, weight: torch.Tensor,
                 draws: Optional[torch.Tensor]):
        self.cm = cm
        self.g = g_table(cm.device)
        self.w = weight.to(torch.int64) & M32
        self.lane = torch.arange(cm.max_size, device=cm.device)
        self.draws = draws

    def straw2(self, b, x, r, pos, who):
        """One straw2 draw per lane from bucket index ``b`` (int64):
        mapper.c:322-367 as K7a's s64 form, the first strict minimum of
        G[u] // w winning (a zero weight draws 2^62)."""
        cm = self.cm
        ids = cm.hash_ids[b]
        u = hash32_3(x[:, None], ids, r[:, None]) & 0xFFFF
        valid = self.lane[None, :] < cm.sizes[b][:, None]
        w = cm.weights[pos.clamp(max=cm.npos - 1), b].to(torch.int64) & M32
        q = torch.where(valid & (w > 0), self.g[u] // w.clamp(min=1),
                        1 << 62)
        if self.draws is not None:
            self.draws.index_add_(0, who, cm.sizes[b].to(torch.int64))
        return cm.items[b, torch.argmin(q, dim=1)].to(torch.int64)

    def descend(self, b, x, r, pos, target, who):
        """``_descend`` over lanes: from bucket index ``b`` draw with r
        fixed until an item of type ``target`` (do-while: the start bucket
        is always drawn from).  Returns (item, status)."""
        n = b.shape[0]
        dev = b.device
        item = torch.zeros(n, dtype=torch.int64, device=dev)
        status = torch.full((n,), _DEAD, dtype=torch.int64, device=dev)
        cur = b.clone()
        live = torch.arange(n, device=dev)
        for _ in range(MAX_DESCENT):
            if live.numel() == 0:
                break
            bb = cur[live]
            empty = self.cm.sizes[bb] == 0
            status[live[empty]] = _EMPTY
            live, bb = live[~empty], bb[~empty]
            it = self.straw2(bb, x[live], r[live], pos[live], who[live])
            item[live] = it
            itype = torch.where(it >= 0, 0,
                                self.cm.types[(-1 - it).clamp(min=0)].long())
            hit = itype == target
            status[live[hit]] = _OK
            dead = ~hit & (it >= 0)
            keep = ~hit & ~dead
            cur[live[keep]] = -1 - it[keep]
            live = live[keep]
        return item, status

    def is_out(self, item, x):
        """mapper.c is_out over lanes (an item past the vector is out)."""
        n = self.w.shape[0]
        if n == 0:
            return torch.ones(item.shape, dtype=torch.bool,
                              device=item.device)
        w = self.w[item.clamp(0, n - 1)]
        h = hash32_2(x, item) & 0xFFFF
        out = torch.where(w >= 0x10000, False,
                          torch.where(w == 0, True, h >= w))
        return out | (item >= n)

    def itype(self, item):
        return torch.where(item >= 0, 0,
                           self.cm.types[(-1 - item).clamp(min=0)].long())


def _in_window(rows, lo, hi, v):
    """Per lane: does ``v`` sit in ``rows[lo:hi]``?"""
    cols = torch.arange(rows.shape[1], device=rows.device)[None, :]
    win = (cols >= lo[:, None]) & (cols < hi[:, None])
    return ((rows == v[:, None]) & win).any(1)


def _firstn_leaf_plain(L, b, x, r, outpos, recurse, vary_r, stable, c, base,
                       who):
    """The chooseleaf recursion of firstn (mapper.c:541-558; numrep 1,
    rep 0 when stable else outpos, parent r shifted by vary_r - 1)."""
    n = b.shape[0]
    dev = b.device
    sub_r = (r >> (vary_r - 1)) if vary_r else torch.zeros_like(r)
    rep = torch.zeros_like(r) if stable else outpos
    ok = torch.zeros(n, dtype=torch.bool, device=dev)
    leaf = torch.full((n,), NONE, dtype=torch.int64, device=dev)
    live = torch.arange(n, device=dev)
    ft = 0
    while live.numel():
        lf, st = L.descend(b[live], x[live], rep[live] + sub_r[live] + ft,
                           outpos[live], 0, who[live])
        good = st == _OK
        good &= ~_in_window(c[live], base[live], base[live] + outpos[live],
                            lf)
        good &= ~L.is_out(lf, x[live])
        leaf[live[good]] = lf[good]
        ok[live[good]] = True
        ft += 1
        if ft >= recurse:
            break
        live = live[~good & (st != _DEAD)]
    return ok, leaf


def _firstn_plain(L, b0, x, numrep, target, count, tries, recurse, leafy,
                  vary_r, stable, o, c, base, who):
    """crush_choose_firstn with bobtail+ tunables (mapper.c:443-636) over
    lanes, writing o/c from column ``base``; returns the picks per lane."""
    n = b0.shape[0]
    dev = b0.device
    outpos = torch.zeros(n, dtype=torch.int64, device=dev)
    count = count.clone()
    for rep in range(numrep):
        live = torch.nonzero(count > 0).squeeze(1)
        ftotal = 0
        while live.numel():
            r = torch.full((live.numel(),), rep + ftotal, dtype=torch.int64,
                           device=dev)
            item, st = L.descend(b0[live], x[live], r, outpos[live], target,
                                 who[live])
            okd = st == _OK
            hi = base[live] + outpos[live]
            collide = okd & _in_window(o[live], base[live], hi, item)
            reject = st == _EMPTY
            if leafy:
                sub = okd & ~collide & (item < 0)
                if sub.any():
                    ls = live[sub]
                    lok, leaf = _firstn_leaf_plain(
                        L, -1 - item[sub], x[ls], r[sub], outpos[ls],
                        recurse, vary_r, stable, c[ls], base[ls], who[ls])
                    rsub = reject[sub]
                    reject[sub] = rsub | ~lok
                    c[ls[lok], hi[sub][lok]] = leaf[lok]
                dev_it = okd & ~collide & (item >= 0)
                c[live[dev_it], hi[dev_it]] = item[dev_it]
            chk = okd & ~collide & ~reject & (L.itype(item) == 0)
            if chk.any():
                rj = reject[chk]
                reject[chk] = rj | L.is_out(item[chk], x[live[chk]])
            good = okd & ~collide & ~reject
            o[live[good], hi[good]] = item[good]
            outpos[live[good]] += 1
            count[live[good]] -= 1
            ftotal += 1
            if ftotal >= tries:
                break
            live = live[~good & (st != _DEAD)]
    return outpos


def _indep_leaf_plain(L, b, x, rep, r, numrep, recurse, who):
    """The chooseleaf recursion of indep (mapper.c:725-741): one slot at
    outpos ``rep``, r' = rep + r + numrep * ft; NONE when it fails."""
    n = b.shape[0]
    dev = b.device
    leaf = torch.full((n,), UNDEF, dtype=torch.int64, device=dev)
    pos = torch.full((n,), rep, dtype=torch.int64, device=dev)
    for ft in range(recurse):
        live = torch.nonzero(leaf == UNDEF).squeeze(1)
        if live.numel() == 0:
            break
        lf, st = L.descend(b[live], x[live], rep + r[live] + numrep * ft,
                           pos[live], 0, who[live])
        leaf[live[st == _DEAD]] = NONE
        good = (st == _OK) & ~L.is_out(lf, x[live])
        leaf[live[good]] = lf[good]
    return torch.where(leaf == UNDEF, NONE, leaf)


def _indep_plain(L, b0, x, out_size, numrep, target, tries, recurse, leafy,
                 o, c, base, who):
    """crush_choose_indep (mapper.c:638-790) over lanes: slots
    [base, base + out_size) start UNDEF, rounds retry them with r' = rep +
    numrep * ftotal (straw2 only, so never the uniform bucket's
    (numrep + 1) * ftotal) until tries run out; dead ends become NONE.  A
    device picked directly is written to ``c`` before its is_out test,
    as mapper.c:736-742 does."""
    n = b0.shape[0]
    dev = b0.device
    cols = torch.arange(o.shape[1], device=dev)[None, :]
    end = base + out_size
    win = (cols >= base[:, None]) & (cols < end[:, None])
    o[win] = UNDEF
    c[win] = UNDEF
    width = int(out_size.max()) if n else 0
    for ftotal in range(tries):
        if not (o[win] == UNDEF).any():
            break
        for rep in range(width):
            col = base + rep
            live = torch.nonzero((rep < out_size)
                                 & (o.gather(1, col.clamp(max=o.shape[1] - 1)
                                             [:, None])[:, 0] == UNDEF)
                                 ).squeeze(1)
            if live.numel() == 0:
                continue
            lc = col[live]
            r = torch.full((live.numel(),), rep + numrep * ftotal,
                           dtype=torch.int64, device=dev)
            item, st = L.descend(b0[live], x[live], r,
                                 torch.zeros_like(r), target, who[live])
            dead = st == _DEAD
            o[live[dead], lc[dead]] = NONE
            c[live[dead], lc[dead]] = NONE
            good = (st == _OK) & ~_in_window(o[live], base[live], end[live],
                                             item)
            if leafy:
                sub = good & (item < 0)
                if sub.any():
                    leaf = _indep_leaf_plain(L, -1 - item[sub], x[live[sub]],
                                             rep, r[sub], numrep, recurse,
                                             who[live[sub]])
                    c[live[sub], lc[sub]] = leaf
                    gsub = good[sub]
                    good[sub] = gsub & (leaf != NONE)
                dev_it = good & (item >= 0)
                c[live[dev_it], lc[dev_it]] = item[dev_it]
            chk = good & (L.itype(item) == 0)
            if chk.any():
                gchk = good[chk]
                good[chk] = gchk & ~L.is_out(item[chk], x[live[chk]])
            o[live[good], lc[good]] = item[good]
    o[win & (o == UNDEF)] = NONE
    c[win & (c == UNDEF)] = NONE


def crush_rule_plain(prog: RuleProgram, x: torch.Tensor,
                     weight: torch.Tensor,
                     draws: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6's plain version: every x (int32 bits or u32 values) through the
    rule program at once, as masked loops with the r' sequences of
    ``crush_do_rule``.  Returns (results (X, result_max) int32, NONE past
    each count; counts (X,) int32).  ``draws``, when given, is an (X,)
    int64 tensor that gains per x the straw2 items it drew (what K6's
    instruction bound counts)."""
    cm = prog.cm
    R = prog.result_max
    dev = x.device
    X = x.shape[0]
    xs = x.to(torch.int64) & M32
    L = _Lanes(cm, weight.to(dev), draws)
    who_all = torch.arange(X, device=dev)
    w = torch.full((X, R), NONE, dtype=torch.int64, device=dev)
    wsize = torch.zeros(X, dtype=torch.int64, device=dev)
    res = torch.full((X, R), NONE, dtype=torch.int64, device=dev)
    nres = torch.zeros(X, dtype=torch.int64, device=dev)
    nb = cm.nbuckets
    for row in prog.rows:
        op = int(row[P_OP])
        if op == CRUSH_RULE_TAKE:
            w[:, 0] = int(row[P_ARG])
            wsize[:] = 1
        elif op == CRUSH_RULE_EMIT:
            for j in range(R):
                m = (j < wsize) & (nres < R)
                lm = torch.nonzero(m).squeeze(1)
                res[lm, nres[lm]] = w[lm, j]
                nres += m
            wsize[:] = 0
        else:
            firstn = op in (CRUSH_RULE_CHOOSE_FIRSTN,
                            CRUSH_RULE_CHOOSELEAF_FIRSTN)
            leafy = op in (CRUSH_RULE_CHOOSELEAF_FIRSTN,
                           CRUSH_RULE_CHOOSELEAF_INDEP)
            numrep, target = int(row[P_NUMREP]), int(row[P_TYPE])
            tries, recurse = int(row[P_TRIES]), int(row[P_RECURSE])
            o = torch.full((X, R), NONE, dtype=torch.int64, device=dev)
            c = o.clone()
            osize = torch.zeros(X, dtype=torch.int64, device=dev)
            for j in range(R if numrep > 0 else 0):
                p = w[:, j]
                bi = (-1 - p).clamp(0, max(nb - 1, 0))
                isb = (j < wsize) & (p < 0) & (-1 - p < nb)
                if nb:
                    isb &= cm.types[bi] >= 0
                live = torch.nonzero(isb).squeeze(1)
                if live.numel() == 0:
                    continue
                room = R - osize[live]
                ol, cl = o[live], c[live]
                if firstn:
                    got = _firstn_plain(
                        L, bi[live], xs[live], numrep, target, room, tries,
                        recurse, leafy, int(row[P_VARY_R]),
                        int(row[P_STABLE]), ol, cl, osize[live],
                        who_all[live])
                else:
                    got = room.clamp(max=numrep)
                    _indep_plain(L, bi[live], xs[live], got, numrep, target,
                                 tries, recurse, leafy, ol, cl, osize[live],
                                 who_all[live])
                o[live], c[live] = ol, cl
                osize[live] += got
            if leafy:
                cols = torch.arange(R, device=dev)[None, :]
                o = torch.where(cols < osize[:, None], c, o)
            w, wsize = o, osize
    return res.to(torch.int32), nres.to(torch.int32)


def crush_rule_plain_into(prog: RuleProgram, x: torch.Tensor,
                          weight: torch.Tensor, idx: torch.Tensor,
                          n_live: torch.Tensor, packed: torch.Tensor) -> None:
    """``crush_rule``'s packed form on the plain version: the rows of x
    ``idx[:n_live]`` into ``packed`` (slots, then the count)."""
    R = prog.result_max
    rows = idx[:int(n_live.reshape(-1)[0])].long()
    res, cnt = crush_rule_plain(prog, x[rows], weight)
    packed[rows, :R] = res
    packed[rows, R] = cnt


# ---- K6: the wrapper -------------------------------------------------------------

def _check_width(result_max: int) -> None:
    if not 1 <= result_max <= MAX_REP:
        raise ValueError(f"result_max {result_max} outside 1..{MAX_REP} "
                         f"for the card's rule mapper")


def crush_rule(prog: RuleProgram, x: torch.Tensor, weight: torch.Tensor,
               idx: Optional[torch.Tensor] = None,
               n_live: Optional[torch.Tensor] = None,
               packed: Optional[torch.Tensor] = None):
    """K6 over (X,) int32 x (u32 bits) with the epoch's weights (int32 bits
    of u32).  Without ``packed``: -> (results (X, result_max) int32,
    counts (X,) int32).  With ``packed`` (X, result_max + 1), the rows of
    the first ``n_live`` (a 1-element int32 tensor, read on the device)
    entries of ``idx`` are computed and written into it, the tail column
    holding the count alone; returns None.  A CPU tensor takes
    ``crush_rule_plain``; a CUDA tensor launches the kernel on the current
    stream or raises: the warp-per-x form with ``idx``, the thread-per-x
    form without."""
    cm = prog.cm
    R = prog.result_max
    if x.dim() != 1 or x.dtype != torch.int32 or weight.dtype != torch.int32:
        raise ValueError("x and weight must be 1-D int32 tensors")
    if (packed is None) != (idx is None) or (idx is None) != (n_live is None):
        raise ValueError("idx, n_live and packed go together")
    if x.device.type == "cpu":
        if packed is None:
            return crush_rule_plain(prog, x, weight)
        return crush_rule_plain_into(prog, x, weight, idx, n_live, packed)
    if x.device.type != "cuda":
        raise RuntimeError(f"crush_rule: no kernel for device {x.device}")
    _check_width(R)
    qsel, qtables, g = cm.draw_tables()
    ts = [x, weight, cm.items, qtables, prog.steps]
    if packed is not None:
        ts += [idx, n_live, packed]
        if (idx.dtype != torch.int32 or n_live.dtype != torch.int32
                or packed.dtype != torch.int32
                or packed.shape != (x.shape[0], R + 1)
                or not packed.is_contiguous() or idx.shape[0] < x.shape[0]):
            raise ValueError("idx/n_live int32, packed (X, result_max + 1) "
                             "contiguous int32")
        out, counts, ld = packed, packed, R + 1
    else:
        out = torch.empty((x.shape[0], R), dtype=torch.int32, device=x.device)
        counts = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
        ld = R
    if any(t.device != x.device for t in ts) or not x.is_contiguous() \
            or not weight.is_contiguous():
        raise ValueError("K6 inputs must be contiguous on one device")
    if x.numel():
        lib = _build.load("crush_fast", _SIGNATURES)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.crush_rule_launch(
            x.data_ptr(), idx.data_ptr() if idx is not None else None,
            n_live.data_ptr() if n_live is not None else None, x.numel(),
            out.data_ptr(), counts.data_ptr(), ld, int(packed is not None),
            cm.items.data_ptr(), cm.hash_ids.data_ptr(), cm.sizes.data_ptr(),
            cm.weights.data_ptr(), qsel.data_ptr(), qtables.data_ptr(),
            g.data_ptr(), cm.types.data_ptr(), cm.nbuckets, cm.max_size,
            cm.npos, prog.steps.data_ptr(), prog.rows.shape[0],
            weight.data_ptr(), weight.shape[0], R, stream)
        if rc != 0:
            raise RuntimeError(f"crush_rule_launch failed: cudaError {rc}")
        rule_launches.add(1)
    return None if packed is not None else (out, counts)


class DeviceCrushMapper:
    """Evaluates one rule for a batch of x values on the map's device (the
    JAX class's contract): K6 on the card, its plain version on the CPU.
    ``choose_args`` is taken, as there, from the compiled map."""

    def __init__(self, compiled: CompiledCrushMap, ruleno: int,
                 result_max: int, choose_args: Optional[Sequence] = None):
        self.C = compiled
        self.program = compiled.compile_rule(ruleno, result_max)
        self.rule = compiled.map.rules[ruleno]
        self.result_max = result_max
        if compiled.device.type == "cuda":
            _check_width(result_max)

    def map_batch(self, xs, weight) -> Tuple[torch.Tensor, torch.Tensor]:
        """Map all xs (u32); returns (results (X, result_max) int32,
        counts (X,) int32) on the map's device."""
        dev = self.C.device
        x = torch.from_numpy(np.ascontiguousarray(
            np.asarray(xs, dtype=np.uint32)).view(np.int32)).to(dev)
        w = torch.from_numpy(np.ascontiguousarray(
            np.asarray(weight, dtype=np.uint32)).view(np.int32)).to(dev)
        return crush_rule(self.program, x, w)
