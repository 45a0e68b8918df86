"""K6's kernel, one warp per x, transcribed lane by lane and held against
its plain version, exactly.

- ``_Warp`` transcribes ``crush_rule_warp_kernel`` of
  ``csrc/crush_fast.cu`` (K6's warp form, which runs an index list such as
  the x K7b flags) for one x with its 32 lanes as lists: each lane's strided share of a
  straw2 draw (items l, l + 32, ...; two per step on the quotient tables),
  the xor-shuffle argmin over (value, item index) pairs, the slot state
  one value per lane (w, o, c), a slot read as a shuffle, a write as one
  lane's, a collision test as a ballot, and the grid's warps striding over
  the live entries of an index list.  It is held against
  ``crush_rule_plain`` on every case of ``test_torch_crush_device.py``'s
  ``_scheme_cases``, on an index list of every x and on a few live entries
  of an index list written into a packed table, and on buckets wider than
  the warp.  Change it with the kernel.
- The reduction alone against the serial first strict minimum (mapper.c's
  strict update) on random values at every width 1..64 with forced ties.

Tolerance: exact equality.
"""
import numpy as np
import pytest
import torch

import ceph_tpu_torch.crush as tc
from ceph_tpu_torch.crush.mapper import crush_do_rule
from ceph_tpu_torch.ops import crush_kernels as tk

from test_torch_crush_device import CF, CI, E, F, T, _scheme_cases
from test_torch_crush_host import build_map, rule_of

WARP = 32
M32 = 0xFFFFFFFF
INT_MAX = (1 << 31) - 1
LLONG_MAX = (1 << 63) - 1
ZERO_DRAW = 1 << 62
NONE, UNDEF = tc.CRUSH_ITEM_NONE, tc.CRUSH_ITEM_UNDEF
LANES = range(WARP)


def _h3(a, b, c):
    return tc.hash.crush_hash32_3(a & M32, b & M32, c & M32)


def lane_minima(vals, table):
    """Each lane's (best, index) over its items l, l + 32, ... of ``vals``
    (the draws of one bucket in item order), as the kernel's loops keep
    them: two items per step on a quotient table, one on the s64 divide;
    the first strict minimum wins within a lane."""
    size = len(vals)
    sentinel = INT_MAX if table else LLONG_MAX
    best, bi = [sentinel] * WARP, [INT_MAX] * WARP
    for lane in LANES:
        step = 2 * WARP if table else WARP
        for k in range(lane, size, step):
            if bi[lane] == INT_MAX or vals[k] < best[lane]:
                best[lane], bi[lane] = vals[k], k
            if table and k + WARP < size and vals[k + WARP] < best[lane]:
                best[lane], bi[lane] = vals[k + WARP], k + WARP
    return best, bi


def shuffle_argmin(best, bi):
    """warp_argmin: five xor-shuffle steps over (value, index) pairs, the
    lower value first, the lower index on a tie; every lane must end on
    the same index."""
    best, bi = list(best), list(bi)
    off = WARP // 2
    while off:
        ov = [best[lane ^ off] for lane in LANES]
        oi = [bi[lane ^ off] for lane in LANES]
        for lane in LANES:
            if ov[lane] < best[lane] or (ov[lane] == best[lane]
                                         and oi[lane] < bi[lane]):
                best[lane], bi[lane] = ov[lane], oi[lane]
        off //= 2
    assert len(set(bi)) == 1, bi
    return bi[0]


def ballot(pred):
    return sum(1 << lane for lane in LANES if pred(lane))


class _Warp:
    """crush_rule_warp_kernel's device functions (``per_warp``) for one
    warp.  Slot state is a list of 32 lane registers; the map tables are
    the wrapper's."""

    def __init__(self, prog, weight):
        cm = prog.cm
        self.items, self.ids = cm.items.numpy(), cm.hash_ids.numpy()
        self.sizes, self.types = cm.sizes.numpy(), cm.types.numpy()
        self.weights = cm.weights.numpy().view(np.uint32)
        qsel, qt, g = cm.draw_tables()
        self.qsel, self.qt, self.g = qsel.numpy(), qt.numpy(), g.numpy()
        self.npos, self.nb = cm.npos, cm.nbuckets
        self.weight = weight
        self.tables_used = set()
        self.widest = 0

    # -- the draw ------------------------------------------------------------

    def straw2(self, b, x, r, p):
        size = int(self.sizes[b])
        table = int(self.qsel[b])
        self.widest = max(self.widest, size)
        if table >= 0:
            self.tables_used.add(table)
            vals = [int(self.qt[table, _h3(x, int(self.ids[b, k]), r)
                                & 0xFFFF]) for k in range(size)]
        else:
            vals = []
            for k in range(size):
                wk = int(self.weights[p, b, k])
                vals.append(int(self.g[_h3(x, int(self.ids[b, k]), r)
                                       & 0xFFFF]) // wk if wk else ZERO_DRAW)
        return int(self.items[b, shuffle_argmin(*lane_minima(vals,
                                                             table >= 0))])

    def type_of(self, item):
        return 0 if item >= 0 else int(self.types[-1 - item])

    def descend(self, b, x, r, pos, type_):
        p = min(pos, self.npos - 1)
        for _ in range(tk.MAX_DESCENT):
            if self.sizes[b] == 0:
                return 0, "empty"
            item = self.straw2(b, x, r & M32, p)
            if self.type_of(item) == type_:
                return item, "ok"
            if item >= 0:
                return item, "dead"
            b = -1 - item
        return 0, "dead"

    def is_out(self, item, x):
        n = len(self.weight)
        if item >= n:
            return True
        w = int(self.weight[max(item, 0)])
        if w >= 0x10000:
            return False
        if w == 0:
            return True
        return (tc.hash.crush_hash32_2(x, item & M32) & 0xFFFF) >= w

    @staticmethod
    def holds(slots, lo, hi, v):
        return ballot(lambda lane: lo <= lane < hi and slots[lane] == v) != 0

    # -- the choose steps ------------------------------------------------------

    def firstn_leaf(self, row, b, x, r, base, outpos, c):
        vary_r, stable, recurse = row[6], row[7], row[5]
        sub_r = (r >> (vary_r - 1)) if vary_r else 0
        rep = 0 if stable else outpos
        ft = 0
        while True:
            lf, st = self.descend(b, x, rep + sub_r + ft, outpos, 0)
            if st == "dead":
                return None
            if st == "ok" and not self.holds(c, base, base + outpos, lf) \
                    and not self.is_out(lf, x):
                return lf
            ft += 1
            if ft >= recurse:
                return None

    def choose_firstn(self, row, b0, x, base, count, o, c):
        op, type_, numrep, tries = row[0], row[2], row[3], row[4]
        leafy = op == CF
        outpos = 0
        rep = 0
        while rep < numrep and count > 0:
            ftotal = 0
            while True:
                r = rep + ftotal
                item, st = self.descend(b0, x, r, outpos, type_)
                if st == "dead":
                    break
                slot = base + outpos
                reject, collide = st == "empty", False
                if not reject:
                    collide = self.holds(o, base, slot, item)
                    if not collide and leafy:
                        leaf = item
                        if item < 0:
                            leaf = self.firstn_leaf(row, -1 - item, x, r,
                                                    base, outpos, c)
                        if leaf is None:
                            reject = True
                        else:
                            c[slot] = leaf            # lane `slot` writes
                    if not reject and not collide and self.type_of(item) == 0:
                        reject = self.is_out(item, x)
                if not reject and not collide:
                    o[slot] = item
                    outpos += 1
                    count -= 1
                    break
                ftotal += 1
                if ftotal >= tries:
                    break
            rep += 1
        return outpos

    def indep_leaf(self, row, b, x, rep, r):
        numrep, recurse = row[3], row[5]
        for ft in range(recurse):
            lf, st = self.descend(b, x, rep + r + numrep * ft, rep, 0)
            if st == "dead":
                return NONE
            if st == "ok" and not self.is_out(lf, x):
                return lf
        return NONE

    def choose_indep(self, row, b0, x, base, out_size, o, c):
        op, type_, numrep, tries = row[0], row[2], row[3], row[4]
        leafy = op == CI
        end = base + out_size
        for lane in range(base, end):
            o[lane] = c[lane] = UNDEF
        left = out_size
        ftotal = 0
        while left > 0 and ftotal < tries:
            for rep in range(out_size):
                slot = base + rep
                if o[slot] != UNDEF:                  # a shuffle from lane slot
                    continue
                r = rep + numrep * ftotal
                item, st = self.descend(b0, x, r, 0, type_)
                if st == "empty":
                    continue
                if st == "dead":
                    o[slot] = c[slot] = NONE
                    left -= 1
                    continue
                if self.holds(o, base, end, item):
                    continue
                if leafy:
                    leaf = (self.indep_leaf(row, -1 - item, x, rep, r)
                            if item < 0 else item)
                    c[slot] = leaf
                    if leaf == NONE:
                        continue
                if self.type_of(item) == 0 and self.is_out(item, x):
                    continue
                o[slot] = item
                left -= 1
            ftotal += 1
        for lane in range(base, end):
            if o[lane] == UNDEF:
                o[lane] = NONE
            if c[lane] == UNDEF:
                c[lane] = NONE

    def one_x(self, rows, x, result_max, out_row):
        """one_x: the program for one x; writes ``out_row`` (lane q writes
        slot q) and returns the count."""
        w, o, c = [NONE] * WARP, [NONE] * WARP, [NONE] * WARP
        wsize = nres = 0
        for row in rows:
            op = row[0]
            if op == T:
                w[0], wsize = int(row[1]), 1
            elif op == E:
                take = min(wsize, result_max - nres)
                for lane in range(take):
                    out_row[nres + lane] = w[lane]
                nres += take
                wsize = 0
            elif wsize > 0:
                firstn = op in (F, CF)
                leafy = op in (CF, CI)
                numrep = row[3]
                osize = 0
                for q in range(wsize if numrep > 0 else 0):
                    parent = w[q]                     # a shuffle from lane q
                    if parent >= 0 or -1 - parent >= self.nb \
                            or self.types[-1 - parent] < 0:
                        continue
                    room = result_max - osize
                    if firstn:
                        osize += self.choose_firstn(row, -1 - parent, x,
                                                    osize, room, o, c)
                    else:
                        out_size = min(numrep, room)
                        self.choose_indep(row, -1 - parent, x, osize,
                                          out_size, o, c)
                        osize += out_size
                w = [c[lane] if leafy and lane < osize else o[lane]
                     for lane in LANES]
                wsize = osize
        for lane in range(nres, result_max):
            out_row[lane] = NONE
        return nres


def _warp_scheme(prog, xs, weight, idx=None, n_live=None, packed=None,
                 grid_warps=3):
    """crush_rule_warp_kernel over a grid of ``grid_warps`` warps striding
    over the live entries: over an index list of every x (rows and
    counts), or the packed table over ``idx[:n_live]``."""
    R = prog.result_max
    wp = _Warp(prog, weight)
    rows = [[int(v) for v in r] for r in prog.rows]
    xs = np.asarray(xs).view(np.uint32)
    n = len(xs)
    live = n if n_live is None else min(n, n_live)
    if packed is None:
        out = np.full((n, R), 7, np.int32)
        cnt = np.zeros(n, np.int32)
    else:
        out = packed
    for warp in range(grid_warps):
        for i in range(warp, live, grid_warps):
            j = i if idx is None else int(idx[i])
            row = out[j]
            nres = wp.one_x(rows, int(xs[j]), R, row)
            if packed is None:
                cnt[j] = nres
            else:
                row[R] = nres
    return (out, cnt, wp) if packed is None else (out, None, wp)


def _hold_against_plain(prog, xs, weights):
    """The transcription equals ``crush_rule_plain`` on every x, over an
    index list of them all and over four live entries of one written into
    a packed table; returns the last _Warp."""
    R = prog.result_max
    xt = torch.from_numpy(xs.view(np.int32))
    for w in weights:
        wt = torch.from_numpy(w.view(np.int32))
        res, cnt = tk.crush_rule(prog, xt, wt)
        got, gcnt, wp = _warp_scheme(prog, xs, w)
        np.testing.assert_array_equal(got, res.numpy())
        np.testing.assert_array_equal(gcnt, cnt.numpy())
        sel = np.array([5, 17, 2 * len(xs) // 3, len(xs) - 1, 2], np.int32)
        idx = np.concatenate([sel, np.zeros(len(xs) - len(sel), np.int32)])
        base = np.full((len(xs), R + 1), 7, np.int32)
        packed = torch.from_numpy(base.copy())
        tk.crush_rule(prog, xt, wt, idx=torch.from_numpy(idx),
                      n_live=torch.tensor([4], dtype=torch.int32),
                      packed=packed)
        want, _, _ = _warp_scheme(prog, xs, w, idx, 4, base.copy())
        np.testing.assert_array_equal(packed.numpy(), want)
        assert (packed.numpy()[2] == 7).all()      # idx[4:] left alone
    return wp


XS = (np.arange(64, dtype=np.uint64) * 2654435761 & M32).astype(np.uint32)


@pytest.mark.parametrize("case", _scheme_cases(), ids=lambda c: c[0])
def test_warp_scheme_matches_plain(case):
    """Every scheme case of the device tests: all-in weights and a mix of
    out and reweighted OSDs; the uniform maps draw some buckets from
    quotient tables."""
    name, cw, n, rno, rmax, args = case
    prog = tk.compile_map(cw.crush, args, device="cpu").compile_rule(rno,
                                                                    rmax)
    rng = np.random.default_rng(7)
    wp = _hold_against_plain(prog, XS, [
        np.full(n, 0x10000, np.uint32),
        rng.choice([0, 0x3000, 0x10000], size=n).astype(np.uint32)])
    if name == "chooseleaf_firstn_False":
        assert wp.tables_used       # the quotient-table draw ran


@pytest.mark.parametrize("table", [True, False], ids=["qtable", "s64"])
def test_shuffle_argmin_is_first_strict_minimum(table):
    """The lanes' strided minima and the xor-shuffle reduction give the
    serial loop's first strict minimum at every width 1..64: on random
    values, few distinct values, all values equal (on the s64 divide:
    all weights zero, every draw 2^62, so item 0 wins), and a tie between
    item 0 (lane 0's first) and item 33 (lane 1's second) below
    everything else."""
    rng = np.random.default_rng(11)
    lo, hi = (-(1 << 31), 1 << 31) if table else (0, 1 << 48)
    for width in range(1, 65):
        cases = [rng.integers(lo, hi, width).tolist(),
                 rng.integers(0, 3, width).tolist(),
                 [int(rng.integers(lo, hi))] * width,
                 [ZERO_DRAW if not table else INT_MAX] * width]
        if width > 33:
            tie = rng.integers(0, hi, width).tolist()
            tie[0] = tie[33] = lo
            cases.append(tie)
        for vals in cases:
            serial = 0
            for k in range(1, width):
                if vals[k] < vals[serial]:
                    serial = k
            assert shuffle_argmin(*lane_minima(vals, table)) == serial, \
                (width, vals)


@pytest.mark.parametrize("case", ["wide_root_firstn", "wide_hosts_indep"])
def test_bucket_wider_than_warp(case):
    """A rule whose buckets are wider than the warp (each lane draws two
    or more items): 40 hosts under the root on quotient tables (chooseleaf
    firstn), or hosts of 38-42 OSDs of uneven weight on the s64 divide
    (chooseleaf indep); rows equal ``crush_rule_plain`` and
    ``crush_do_rule``."""
    if case == "wide_root_firstn":
        cw, n = build_map(tc, n_hosts=40, osds_per_host=2)
        rno, rmax = cw.add_simple_rule("r", "default", "host",
                                       mode="firstn"), 4
    else:
        cw, n = build_map(tc, n_hosts=3, osds_per_host=40, uneven=True)
        rno, rmax = rule_of(tc, cw, [(T, -1, 0), (CI, 4, 1), (E, 0, 0)],
                            "wide", 3, 20), 4
    prog = tk.compile_map(cw.crush, device="cpu").compile_rule(rno, rmax)
    xs = XS[:24]
    w = np.full(n, 0x10000, np.uint32)
    w[::7] = 0
    wp = _hold_against_plain(prog, xs, [w])
    assert wp.widest > WARP
    res, cnt = tk.crush_rule(prog, torch.from_numpy(xs.view(np.int32)),
                             torch.from_numpy(w.view(np.int32)))
    wl = [int(v) for v in w]
    for i, x in enumerate(xs):
        want = crush_do_rule(cw.crush, rno, int(x), rmax, wl)
        assert [int(v) for v in res[i, :cnt[i]]] == want, x

