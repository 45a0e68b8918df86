"""K8: the legacy-tunables CRUSH mapper (straw v1, local tries, the
permutation fallback) on the card.

Port of ``ceph_tpu/ops/crush_legacy.py``.  Pre-bobtail maps (every map
``CrushCompiler.compile`` makes from text without ``tunable`` lines, and
the reference's own set-choose fixtures) run ``crush_choose_firstn`` with
``choose_local_tries`` / ``choose_local_fallback_tries`` > 0: a collision
or rejection first retries at the failing bucket, draws from
``bucket_perm_choose``'s permutation once the local count passes
``size >> 1`` and the fallback count, and only then descends again.
``LegacyFastRule(m, ruleno, result_max, device=...)`` evaluates one
firstn rule of such a map (single take, chained chooses, chooseleaf of
depth 1 in the last step, vary_r 0) for a batch of x.

- On the card, K8 (``crush_legacy``, ``csrc/crush_legacy.cu``): a group
  of 4 lanes per x walks mapper.c's ``crush_choose_firstn`` to the
  reference's own end: every descent of ``choose_tries``, every local
  retry, the permutation draws on demand, each straw draw shared by the
  group's lanes.  No x is left over and nothing is replayed on the host:
  ``residual_fraction`` is 0.0 there.
- On the CPU, its plain version ``crush_legacy_plain``: the JAX module's
  formulation carried over (draw tables T/P for every bucket and retry
  value, the masked retry state machines of each stage and of the
  chooseleaf recursion, chained stages compacted in order), evaluated in
  chunks of x so that the tables fit.  An x that runs past the tables'
  retry window is flagged and replayed with the host ``crush_do_rule``, as
  the JAX ``map_batch`` does; ``residual_fraction`` is the share of such
  x, as in the JAX module.  It serves CPU tensors and the checks, never
  the CUDA path.

Both treat an item past the weight vector as out (mapper.c ``is_out``);
the JAX ``_is_out`` clamps the index instead.  The rules refused
(``UnsupportedRule``) are the JAX module's; on the card a bucket wider than
the kernel's permutation scratch (``MAX_BUCKET``) is refused too, and a
``result_max`` above 32 raises ValueError, before any launch.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..crush.constants import (
    CRUSH_BUCKET_STRAW2, CRUSH_ITEM_NONE, CRUSH_RULE_CHOOSELEAF_FIRSTN,
    CRUSH_RULE_CHOOSE_FIRSTN, CRUSH_RULE_EMIT,
    CRUSH_RULE_SET_CHOOSELEAF_STABLE, CRUSH_RULE_SET_CHOOSELEAF_TRIES,
    CRUSH_RULE_SET_CHOOSELEAF_VARY_R,
    CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
    CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES, CRUSH_RULE_SET_CHOOSE_TRIES,
    CRUSH_RULE_TAKE, S64_MIN,
)
from ..crush.mapper import crush_do_rule
from ..crush.types import CrushMap
from . import _build
from .crush_fast import UnsupportedRule, _layer_path_frontier
from .crush_kernels import (M32, MAX_REP, CompiledCrushMap, g_table,
                            hash32_2, hash32_3)
from .gf_matmul import resolve_device
from .gf_pallas import LaunchCounter

NONE = CRUSH_ITEM_NONE
MAX_BUCKET = 256              # kMaxBucket of csrc/crush_legacy.cu
# the plain version's chunks: x whose T and P tables take this many bytes,
# and (x, bucket, retry, item) draws per step of the tables' build
_TABLE_BYTES = 1 << 29
_TABLE_ELEMS = 1 << 24

_VP = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    "crush_legacy_launch": (
        [_VP, _LL, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _VP, _I,
         _I, _I, _I, _I, _I, _I, _VP, _I, _VP], _I),
}

launches = LaunchCounter()            # K8


class LegacyFastRule:
    """One firstn rule of a legacy-tunables map, evaluated for a batch of
    x: K8 on the card, the plain version on the CPU (``device``)."""

    def __init__(self, m: CrushMap, ruleno: int, result_max: int,
                 tries_cap: int = 64, device="cuda"):
        dev = resolve_device(device)
        self.C = CompiledCrushMap(m, device=dev, allow_legacy=True)
        self.m = m
        self.device = dev
        self.ruleno = ruleno
        self.result_max = result_max
        rule = m.rules[ruleno] if 0 <= ruleno < len(m.rules) else None
        if rule is None:
            raise UnsupportedRule(f"no rule {ruleno}")
        self.tries = m.choose_total_tries + 1
        self.local_retries = m.choose_local_tries
        self.local_fallback = m.choose_local_fallback_tries
        leaf_tries = 0
        vary_r = m.chooseleaf_vary_r
        stable = m.chooseleaf_stable
        take = None
        chooses: List = []
        for step in rule.steps:
            if step.op == CRUSH_RULE_SET_CHOOSE_TRIES:
                if step.arg1 > 0:
                    self.tries = step.arg1
            elif step.op == CRUSH_RULE_SET_CHOOSELEAF_TRIES:
                if step.arg1 > 0:
                    leaf_tries = step.arg1
            elif step.op == CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES:
                if step.arg1 >= 0:
                    self.local_retries = step.arg1
            elif step.op == CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES:
                if step.arg1 >= 0:
                    self.local_fallback = step.arg1
            elif step.op == CRUSH_RULE_SET_CHOOSELEAF_VARY_R:
                if step.arg1 >= 0:
                    vary_r = step.arg1
            elif step.op == CRUSH_RULE_SET_CHOOSELEAF_STABLE:
                if step.arg1 >= 0:
                    stable = step.arg1
            elif step.op == CRUSH_RULE_TAKE:
                if take is not None:
                    raise UnsupportedRule("multiple takes")
                take = step.arg1
            elif step.op in (CRUSH_RULE_CHOOSE_FIRSTN,
                             CRUSH_RULE_CHOOSELEAF_FIRSTN):
                chooses.append(step)
            elif step.op == CRUSH_RULE_EMIT:
                pass
            else:
                raise UnsupportedRule(f"op {step.op}")
        if take is None or take >= 0 or not chooses:
            raise UnsupportedRule("rule shape")
        if vary_r:
            raise UnsupportedRule("legacy machine with vary_r")
        self.stable = stable
        self.take = take
        # per stage: depth along the layered tree, numrep, leafiness
        self.stages: List[dict] = []
        frontier = [take]
        for si, step in enumerate(chooses):
            leafy = step.op == CRUSH_RULE_CHOOSELEAF_FIRSTN
            if leafy and si != len(chooses) - 1:
                raise UnsupportedRule("chooseleaf before the last step")
            n = step.arg1
            if n <= 0:
                n += result_max
            if n <= 0:
                raise UnsupportedRule("numrep")
            d = _layer_path_frontier(m, frontier, step.arg2)
            st = {"numrep": n, "type": step.arg2, "depth": d,
                  "leafy": leafy, "leaf_depth": 0, "recurse": 0}
            if leafy:
                if step.arg2 != 0:
                    nxt = list(frontier)
                    for _ in range(d):
                        nxt = [i for b in nxt
                               for i in m.bucket(b).items if i < 0]
                    if nxt:
                        if _layer_path_frontier(m, nxt, 0) != 1:
                            raise UnsupportedRule("legacy leaf depth > 1")
                        st["leaf_depth"] = 1
                if leaf_tries:
                    st["recurse"] = leaf_tries
                elif m.chooseleaf_descend_once:
                    st["recurse"] = 1
                else:
                    st["recurse"] = self.tries
            self.stages.append(st)
            for _ in range(d):
                frontier = [i for b in frontier
                            for i in m.bucket(b).items if i < 0]
        # the plain version's retry window: local retries may carry flocal
        # to size + fallback before a descent is forced
        smax = int(self.C.max_size)
        self.kl = smax + self.local_fallback + 1
        self.rt = min(tries_cap, self.tries)
        max_slot = max(st["numrep"] for st in self.stages)
        max_leaf = max((st["recurse"] + self.kl
                        for st in self.stages if st["leafy"]), default=0)
        self.rmax = max_slot + self.rt + self.kl + max_leaf + 2
        # the kernel's program: a row per stage
        rows = [[st["numrep"], st["depth"], int(st["leafy"]), st["recurse"]]
                for st in self.stages]
        self.program = np.asarray(rows, dtype=np.int32).reshape(-1, 4)
        if dev.type == "cuda":
            if smax > MAX_BUCKET:
                raise UnsupportedRule(f"bucket of {smax} items > "
                                      f"{MAX_BUCKET} for the card's mapper")
            if not 1 <= result_max <= MAX_REP:
                raise ValueError(f"result_max {result_max} outside "
                                 f"1..{MAX_REP} for the card's mapper")
        self.steps = torch.from_numpy(self.program).to(dev)
        self.algs = torch.from_numpy(self.C.algs).to(dev)
        self._residual_frac = 0.0
        # the plain version's last draw tables: (x's bytes, T, P)
        self._tables: Optional[tuple] = None

    def map_batch(self, xs, weight) -> Tuple[np.ndarray, np.ndarray]:
        """Map every x (u32) under ``weight`` (u32 per device): (out
        (X, result_max) int32, NONE past each count; counts (X,) int32),
        the host ``crush_do_rule``'s rows."""
        xs = np.ascontiguousarray(np.asarray(xs, dtype=np.uint32))
        w32 = np.ascontiguousarray(np.asarray(weight, dtype=np.uint32))
        x = torch.from_numpy(xs.view(np.int32)).to(self.device)
        w = torch.from_numpy(w32.view(np.int32)).to(self.device)
        out_t, cnt_t, res_t = crush_legacy(self, x, w)
        out = out_t.cpu().numpy().copy()
        counts = cnt_t.cpu().numpy().copy()
        residual = res_t.cpu().numpy()
        self._residual_frac = float(residual.mean()) if len(xs) else 0.0
        if self._residual_frac:
            wl = [int(v) for v in w32]
            for i in np.nonzero(residual)[0]:
                r = crush_do_rule(self.m, self.ruleno, int(xs[i]),
                                  self.result_max, wl)
                out[i, :] = NONE
                out[i, :len(r)] = r
                counts[i] = len(r)
        return out, counts

    @property
    def residual_fraction(self) -> float:
        """Share of the last batch's x replayed on the host: the x the
        plain version's retry window could not finish (the JAX meaning);
        0.0 on the card, where K8 runs every x to its end."""
        return self._residual_frac


# ---- K8's plain version -----------------------------------------------------

def _first_max(draw: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum along the last axis (the reference's
    strict-greater update)."""
    lane = torch.arange(draw.shape[-1], device=draw.device)
    hit = draw == draw.max(dim=-1, keepdim=True).values
    return torch.where(hit, lane, draw.shape[-1]).min(dim=-1).values


def _draw_tables(rule: LegacyFastRule, x: torch.Tensor):
    """T[x, b, r], P[x, b, r] (int64 items): each bucket's normal and
    permutation draw for every retry value r < rmax.  The straw (v1) draw
    is (hash & 0xffff) * straw as u48, straw2 the s64 -(G[u] // w); the
    first maximum wins.  P is ``bucket_perm_choose``: Fisher-Yates steps
    p < size - 1 swap position p with p + hash32_3(x, id, p) % (size - p),
    and a step never touches a position before its own, so position
    r % size after steps 0..r % size is that of the whole shuffle."""
    C = rule.C
    dev = x.device
    nb, S, R = C.nbuckets, C.max_size, rule.rmax
    X = x.shape[0]
    r = torch.arange(R, device=dev)
    ids = C.hash_ids.to(torch.int64)
    sizes = C.sizes.to(torch.int64)
    valid = torch.arange(S, device=dev)[None, :] < sizes[:, None]
    is2 = torch.from_numpy(C.algs == CRUSH_BUCKET_STRAW2).to(dev)
    straws = C.straws.to(torch.int64) & M32
    w = C.weights[0].to(torch.int64) & M32
    g = g_table(dev)
    T = torch.empty((X, nb, R), dtype=torch.int64, device=dev)
    step = max(1, _TABLE_ELEMS // max(1, nb * R * S))
    for lo in range(0, X, step):
        xc = x[lo:lo + step]
        u = hash32_3(xc[:, None, None, None], ids[None, :, None, :],
                     r[None, None, :, None]) & 0xFFFF
        d1 = u * straws[None, :, None, :]
        d2 = torch.where(w[None, :, None, :] > 0,
                         -(g[u] // w.clamp(min=1)[None, :, None, :]),
                         S64_MIN)
        draw = torch.where(is2[None, :, None, None], d2, d1)
        draw = torch.where(valid[None, :, None, :], draw, S64_MIN)
        win = _first_max(draw)
        T[lo:lo + step] = C.items.to(torch.int64)[
            torch.arange(nb, device=dev)[None, :, None], win]
        del u, d1, d2, draw, win
    perm = torch.arange(S, device=dev).repeat(X, nb, 1)
    bucket_id = -1 - torch.arange(nb, device=dev)
    for p in range(S - 1):
        act = p < sizes - 1
        h = hash32_3(x[:, None], bucket_id[None, :],
                     torch.tensor(p, device=dev))
        i = h % (sizes - p).clamp(min=1)[None, :]
        do = act[None, :] & (i > 0)
        tgt = (p + i).clamp(max=S - 1)
        vp = perm[:, :, p].clone()
        vt = perm.gather(2, tgt[:, :, None])[:, :, 0]
        perm.scatter_(2, tgt[:, :, None],
                      torch.where(do, vp, vt)[:, :, None])
        perm[:, :, p] = torch.where(do, vt, vp)
    pr = r[None, :] % sizes.clamp(min=1)[:, None]            # (nb, R)
    slot = perm.gather(2, pr[None].expand(X, nb, R))
    P = C.items.to(torch.int64)[torch.arange(nb, device=dev)[None, :, None],
                                slot]
    return T, P


def _tables_for(rule: LegacyFastRule, x: torch.Tensor):
    """``_draw_tables`` of ``x``, kept for the rule's next call on the same
    x: the tables depend on the map and x alone, not on the weights."""
    key = x.cpu().numpy().tobytes()
    if rule._tables is None or rule._tables[0] != key:
        rule._tables = (key,) + _draw_tables(rule, x)
    return rule._tables[1:]


class _Machine:
    """What the plain retry machines read: the tables, the epoch's
    weights and, when asked, per-x marks of the permutation draws and
    local retries taken."""

    def __init__(self, rule: LegacyFastRule, T, P, x, weight, stats):
        self.rule = rule
        self.T, self.P = T, P
        self.x = x
        self.w = weight.to(torch.int64) & M32
        self.sizes = rule.C.sizes.to(torch.int64)
        self.stats = stats

    def gather(self, table, xi, b, r):
        return table[xi, b, r.clamp(0, self.rule.rmax - 1)]

    def is_out(self, items, xi):
        """mapper.c is_out: an item past the weight vector is out."""
        n = self.w.shape[0]
        w = self.w[items.clamp(0, max(n - 1, 0))] if n else \
            torch.zeros_like(items)
        h = hash32_2(self.x[xi], items) & 0xFFFF
        out = torch.where(w >= 0x10000, False,
                          torch.where(w == 0, True, h >= w))
        return out | (items >= n)

    def mark(self, key, mask, xi):
        if self.stats is not None and mask.any():
            self.stats[key][xi[mask]] = True

    def draw(self, xi, b, r, fl, size, live):
        """The bucket's draw at r, or its permutation draw once the local
        count passes size >> 1 and the fallback count."""
        lf = self.rule.local_fallback
        use_perm = (lf > 0) & (fl >= (size >> 1)) & (fl > lf)
        self.mark("perm", live & use_perm, xi)
        return torch.where(use_perm, self.gather(self.P, xi, b, r),
                           self.gather(self.T, xi, b, r))

    def upper(self, xi, roots, slot_r, depth):
        """Plain descent through depth - 1 intervening levels at the
        slot's descent r: the bottom bucket index."""
        b = roots
        for _ in range(max(depth - 1, 0)):
            b = (-1 - self.gather(self.T, xi, b, slot_r)).clamp(min=0)
        return b

    def retry(self, fail, coll, fl, size, xi, limit_ok):
        """mapper.c's retry decision after a failure: (local, descend)."""
        rule = self.rule
        fl2 = fl + 1
        local = fail & ((coll & (fl2 <= rule.local_retries))
                        | ((rule.local_fallback > 0)
                           & (fl2 <= size + rule.local_fallback)))
        self.mark("local", local, xi)
        return local, fail & ~local & limit_ok

    def leaf(self, st, xi, host_item, op, leaves, active):
        """The chooseleaf recursion (depth 1, vary_r 0): one device of
        ``host_item`` that is not in ``leaves`` (the leaves emitted so far),
        at r = op + ftotal (op pinned to 0 under chooseleaf_stable).
        Returns (ok, item); lanes not ``active`` are not evaluated."""
        N = xi.shape[0]
        dev = xi.device
        hb = (-1 - host_item).clamp(min=0)
        hsz = self.sizes[hb]
        base_r = torch.zeros_like(op) if self.rule.stable else op
        ft = torch.zeros(N, dtype=torch.int64, device=dev)
        fl = torch.zeros_like(ft)
        done = torch.zeros(N, dtype=torch.bool, device=dev)
        dead = ~active
        pick = torch.full((N,), NONE, dtype=torch.int64, device=dev)
        for _ in range(st["recurse"] + self.rule.kl):
            live = ~done & ~dead
            if not live.any():
                break
            item = self.draw(xi, hb, base_r + ft, fl, hsz, live)
            coll = (leaves == item[:, None]).any(1)
            rej = self.is_out(item, xi) | (hsz == 0)
            ok = live & ~coll & ~rej
            pick = torch.where(ok, item, pick)
            done |= ok
            fail = live & ~ok
            local, desc = self.retry(fail, coll, fl, hsz, xi,
                                     ft + 1 < st["recurse"])
            ft = torch.where(fail, ft + 1, ft)
            fl = torch.where(local, fl + 1, torch.where(desc, 0, fl))
            dead |= fail & ~local & ~desc
        return done, pick

    def stage(self, st, xi, roots, valid):
        """One firstn choose step for N parent lanes: (sel (N, numrep), the
        emitted values (leaf devices when leafy), NONE where a slot failed;
        residual (N,), lanes past the retry window)."""
        rule = self.rule
        N = xi.shape[0]
        dev = xi.device
        n = st["numrep"]
        outs = torch.full((N, n), NONE, dtype=torch.int64, device=dev)
        sel = outs.clone()
        residual = torch.zeros(N, dtype=torch.bool, device=dev)
        leafy = st["leafy"]
        for j in range(n):
            F = torch.zeros(N, dtype=torch.int64, device=dev)
            ft = torch.zeros_like(F)
            fl = torch.zeros_like(F)
            done = torch.zeros(N, dtype=torch.bool, device=dev)
            dead = torch.zeros_like(done)
            for _ in range(rule.rt + rule.kl):
                active = valid & ~done & ~dead & ~residual
                if not active.any():
                    break
                bbot = self.upper(xi, roots, j + F, st["depth"])
                bsz = self.sizes[bbot]
                r = j + ft
                item = self.draw(xi, bbot, r, fl, bsz, active)
                coll = (outs == item[:, None]).any(1)
                if leafy and st["leaf_depth"]:
                    # the recursion's base r is outpos, the count of
                    # successful slots so far (a dead earlier slot leaves
                    # it behind j)
                    op = (outs[:, :j] != NONE).sum(1)
                    lok, lpick = self.leaf(st, xi, item, op, sel,
                                           active & ~coll)
                    rej = ~lok
                elif st["type"] == 0 or (leafy and not st["leaf_depth"]):
                    lpick = item
                    rej = self.is_out(item, xi) | (bsz == 0)
                else:
                    lpick = item
                    rej = bsz == 0
                ok = active & ~coll & ~rej
                outs[:, j] = torch.where(ok, item, outs[:, j])
                sel[:, j] = torch.where(ok, lpick, sel[:, j])
                done |= ok
                fail = active & ~ok
                local, desc = self.retry(fail, coll, fl, bsz, xi,
                                         ft + 1 < rule.tries)
                dead |= fail & ~local & ~desc
                ft = torch.where(fail, ft + 1, ft)
                fl = torch.where(local, fl + 1, torch.where(desc, 0, fl))
                F = torch.where(desc, ft, F)
                # past the tables' window the reference would go on:
                # defer to the host
                over = (ft >= rule.rt) if rule.rt < rule.tries \
                    else torch.zeros_like(done)
                residual |= active & ~done & ~dead & (
                    over | (r >= rule.rmax - 1))
            residual |= valid & ~done & ~dead
        return sel, residual


def _compact(rows: torch.Tensor) -> torch.Tensor:
    """Each row's non-NONE entries first, in order (firstn's output)."""
    order = torch.argsort((rows == NONE).to(torch.int8), dim=1, stable=True)
    return rows.gather(1, order)


def crush_legacy_plain(rule: LegacyFastRule, x: torch.Tensor,
                       weight: torch.Tensor, stats: Optional[dict] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K8's plain version over (X,) x (u32 values or their int32 bits):
    (out (X, result_max) int32, NONE past each count; counts (X,) int32;
    residual (X,) bool, the x past the tables' retry window).  The draw
    tables of the last chunk are kept on the rule for its next call on the
    same x (an epoch's new weights reuse them).  ``stats``,
    when given, gains per-x bool tensors "perm" and "local": the x that
    took a permutation draw and a local retry."""
    dev = x.device
    X = x.shape[0]
    R = rule.result_max
    xs = x.to(torch.int64) & M32
    if stats is not None:
        stats["perm"] = torch.zeros(X, dtype=torch.bool, device=dev)
        stats["local"] = torch.zeros(X, dtype=torch.bool, device=dev)
    out = torch.full((X, R), NONE, dtype=torch.int32, device=dev)
    counts = torch.zeros(X, dtype=torch.int32, device=dev)
    residual_all = torch.zeros(X, dtype=torch.bool, device=dev)
    chunk = max(1, _TABLE_BYTES // (16 * rule.C.nbuckets * rule.rmax))
    for lo in range(0, X, chunk):
        xc = xs[lo:lo + chunk]
        n = xc.shape[0]
        T, P = _tables_for(rule, xc)
        sub = None
        if stats is not None:
            sub = {k: torch.zeros(n, dtype=torch.bool, device=dev)
                   for k in ("perm", "local")}
        mach = _Machine(rule, T, P, xc, weight.to(dev), sub)
        xi = torch.arange(n, device=dev)
        roots = torch.full((n,), -1 - rule.take, dtype=torch.int64,
                           device=dev)
        valid = torch.ones(n, dtype=torch.bool, device=dev)
        residual = torch.zeros(n, dtype=torch.bool, device=dev)
        for si, st in enumerate(rule.stages):
            sel, res = mach.stage(st, xi, roots, valid)
            residual[xi[res]] = True
            if si == len(rule.stages) - 1:
                break
            # firstn chains compactly: each x's successes in order, cut to
            # result_max (crush_do_rule's o, whose room is what is left)
            wide = _compact(sel.reshape(n, -1))[:, :R]
            xi = torch.arange(n, device=dev).repeat_interleave(wide.shape[1])
            valid = wide.reshape(-1) != NONE
            roots = (-1 - wide.reshape(-1)).clamp(min=0)
        wide = _compact(sel.reshape(n, -1))
        if wide.shape[1] < R:
            wide = torch.cat([wide, torch.full((n, R - wide.shape[1]), NONE,
                                               dtype=wide.dtype, device=dev)],
                             1)
        out[lo:lo + n] = wide[:, :R].to(torch.int32)
        counts[lo:lo + n] = (wide != NONE).sum(1).clamp(max=R).to(torch.int32)
        residual_all[lo:lo + n] = residual
        if stats is not None:
            for k in sub:
                stats[k][lo:lo + n] = sub[k]
    return out, counts, residual_all


# ---- K8: the wrapper --------------------------------------------------------

def crush_legacy(rule: LegacyFastRule, x: torch.Tensor, weight: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K8 over (X,) int32 x (u32 bits) with the epoch's weights (int32 bits
    of u32): (out (X, result_max) int32, counts (X,) int32, residual (X,)
    bool).  A CPU tensor takes ``crush_legacy_plain``; a CUDA tensor
    launches the kernel on the current stream (residual all False: it runs
    every x to its end) or raises."""
    if x.dim() != 1 or x.dtype != torch.int32 or weight.dtype != torch.int32:
        raise ValueError("x and weight must be 1-D int32 tensors")
    if x.device.type == "cpu":
        return crush_legacy_plain(rule, x, weight)
    if x.device.type != "cuda":
        raise RuntimeError(f"crush_legacy: no kernel for device {x.device}")
    C = rule.C
    ts = [x, weight, C.items, C.sizes, rule.algs, C.straws, C.weights,
          rule.steps]
    if any(t.device != x.device for t in ts) or not x.is_contiguous() \
            or not weight.is_contiguous():
        raise ValueError("K8 inputs must be contiguous on the rule's device")
    R = rule.result_max
    out = torch.empty((x.shape[0], R), dtype=torch.int32, device=x.device)
    counts = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
    if x.numel():
        lib = _build.load("crush_legacy", _SIGNATURES)
        g = g_table(x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.crush_legacy_launch(
            x.data_ptr(), x.numel(), out.data_ptr(), counts.data_ptr(),
            C.items.data_ptr(), C.sizes.data_ptr(), rule.algs.data_ptr(),
            C.straws.data_ptr(), C.weights.data_ptr(), g.data_ptr(),
            C.nbuckets, C.max_size, rule.steps.data_ptr(),
            rule.steps.shape[0], -1 - rule.take, rule.tries,
            rule.local_retries, rule.local_fallback, int(bool(rule.stable)),
            R, weight.data_ptr(), weight.shape[0], stream)
        if rc != 0:
            raise RuntimeError(f"crush_legacy_launch failed: cudaError {rc}")
        launches.add(1)
    return out, counts, torch.zeros(x.shape[0], dtype=torch.bool,
                                     device=x.device)
