"""K8's group kernel, transcribed lane by lane and held against the host
``crush_do_rule`` and the kernel's plain version, exactly.

``_Group`` transcribes ``crush_legacy_kernel<NS>`` of
``csrc/crush_legacy.cu`` for one x with its G = 4 lanes as lists: each lane's
strided share of a straw draw (``lane_best``: items lane, lane + G, ...,
two chains per step while the bucket has 2G items left), the xor-shuffle
reduction over (value, item index) with the reference's tie rules (straw
v1 the first maximum, straw2 the first minimum), slot s of w, o and c in
register s // G of lane s % G (a read a shuffle, a write one lane's, a
collision test a ballot), the permutation draw on the leader lane over the
group's scratch, and the flat machine of steps between draws
(``kXStart`` ... ``kLeafFail``) with its one draw site.  Change it with
the kernel.  ``_Thread`` (``test_torch_crush_legacy_kernel.py``) stays the
line-for-line account of mapper.c's semantics that both follow.

The maps: ``chip_smoke.py``'s small legacy maps and its wide map (3 racks
x 2 hosts x 40 OSDs, so a host draw takes several rounds of the group's
lanes), under all-in, zeroed, partial and heavy-out weight vectors; 64 x
per weight vector (16 on the wide map).

Tolerance: exact equality.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from ceph_tpu_torch.crush.compiler import CrushCompiler
from ceph_tpu_torch.crush.constants import CRUSH_BUCKET_STRAW2
from ceph_tpu_torch.crush.hash import crush_hash32_2, crush_hash32_3
from ceph_tpu_torch.crush.mapper import _perm_choose, crush_do_rule
from ceph_tpu_torch.ops import crush_legacy as tl
from ceph_tpu_torch.ops.crush_kernels import G_EXACT

from test_torch_crush_legacy_kernel import _Thread

NONE = tl.NONE
ZERO_DRAW = 1 << 62
INT_MAX = (1 << 31) - 1
LLONG_MAX = (1 << 63) - 1
MAX_REP = 32
UNROLL = 2                        # kUnroll of csrc/crush_legacy.cu
G = 4                             # kLanes of csrc/crush_legacy.cu
WEIGHTS = ("all_in", "out", "quarter", "heavy")   # chip_smoke.legacy_weights
X = 64
X_WIDE = 16                       # the wide map's x per weight vector
MAPS = {**chip_smoke.legacy_small_maps(), **chip_smoke.legacy_wide_maps()}


def lane_best(size, draw, better):
    """Each lane's (best, index) over its items, as ``lane_best`` keeps
    them: UNROLL chains per step while UNROLL * G items are left, then one
    at a time; a lane's first best wins (``better`` is strict)."""
    best, bi = [0] * G, [INT_MAX] * G
    k0 = 0
    while k0 + UNROLL * G <= size:
        for lane in range(G):
            vals = [draw(k0 + j * G + lane) for j in range(UNROLL)]
            for j, v in enumerate(vals):
                if bi[lane] == INT_MAX or better(v, best[lane]):
                    best[lane], bi[lane] = v, k0 + j * G + lane
        k0 += UNROLL * G
    while k0 < size:
        for lane in range(G):
            k = k0 + lane
            if k < size:
                v = draw(k)
                if bi[lane] == INT_MAX or better(v, best[lane]):
                    best[lane], bi[lane] = v, k
        k0 += G
    return best, bi


def shuffle_reduce(best, bi, better, empty):
    """first_max / first_min: log2(G) xor-shuffle steps over (value,
    index) pairs, the better value first, the lower index on a tie; a lane
    with no item holds (``empty``, INT_MAX).  Every lane must end on the
    same index."""
    best = [empty if i == INT_MAX else v for v, i in zip(best, bi)]
    bi = list(bi)
    off = G // 2
    while off:
        ov = [best[lane ^ off] for lane in range(G)]
        oi = [bi[lane ^ off] for lane in range(G)]
        for lane in range(G):
            if better(ov[lane], best[lane]) or (ov[lane] == best[lane]
                                                and oi[lane] < bi[lane]):
                best[lane], bi[lane] = ov[lane], oi[lane]
        off //= 2
    assert len(set(bi)) == 1, bi
    return bi[0]


def first_max(vals):
    """The straw (v1) draw's winner over ``vals``."""
    best, bi = lane_best(len(vals), lambda k: vals[k],
                         lambda v, b: v > b)
    return shuffle_reduce(best, bi, lambda v, b: v > b, 0)


def first_min(vals):
    """The straw2 draw's winner over ``vals``."""
    best, bi = lane_best(len(vals), lambda k: vals[k],
                         lambda v, b: v < b)
    return shuffle_reduce(best, bi, lambda v, b: v < b, LLONG_MAX)


class _Group:
    """``crush_legacy_kernel<NS>`` for one x at a time: the lanes'
    registers are lists, the group's scratch a list.  Counts ``rounds``
    (steps of G lanes in straw draws), ``widest`` (the widest bucket
    drawn from) and ``perm`` (permutation draws)."""

    def __init__(self, rule: tl.LegacyFastRule, weight):
        C = rule.C
        self.items = C.items.cpu().numpy()
        self.sizes = C.sizes.cpu().numpy()
        self.algs = C.algs
        self.straws = C.straws.cpu().numpy().view(np.uint32)
        self.weights = C.weights[0].cpu().numpy().view(np.uint32)
        self.weight = [int(v) for v in weight]
        self.prog = [[int(v) for v in row] for row in rule.program]
        self.take_b = -1 - rule.take
        self.tries = rule.tries
        self.lr, self.lf = rule.local_retries, rule.local_fallback
        self.stable = rule.stable
        self.R = rule.result_max
        self.NS = 1 if self.R <= G else MAX_REP // G
        self.scratch = [0] * tl.MAX_BUCKET
        self.rounds = self.widest = self.perm = 0

    # -- the draws -------------------------------------------------------------

    def bucket_draw(self, b, x, r):
        size = int(self.sizes[b])
        if size == 0:
            return int(self.items[b, 0])
        self.widest = max(self.widest, size)
        self.rounds += -(-size // G)
        if self.algs[b] == CRUSH_BUCKET_STRAW2:
            def draw(k):
                wk = int(self.weights[b, k])
                u = crush_hash32_3(x, int(self.items[b, k]) & 0xFFFFFFFF,
                                   r) & 0xFFFF
                return int(G_EXACT[u]) // wk if wk else ZERO_DRAW
            best, bi = lane_best(size, draw, lambda v, b_: v < b_)
            win = shuffle_reduce(best, bi, lambda v, b_: v < b_, LLONG_MAX)
        else:
            def draw(k):
                u = crush_hash32_3(x, int(self.items[b, k]) & 0xFFFFFFFF,
                                   r) & 0xFFFF
                return u * int(self.straws[b, k])
            best, bi = lane_best(size, draw, lambda v, b_: v > b_)
            win = shuffle_reduce(best, bi, lambda v, b_: v > b_, 0)
        return int(self.items[b, win])

    def perm_draw(self, b, x, r):
        """The lanes fill the scratch (lane l positions l, l + G, ...), the
        leader runs the swaps and one shuffle hands perm[pr] to the
        group."""
        self.perm += 1
        size = int(self.sizes[b])
        pr = r % size
        perm = self.scratch
        for lane in range(G):
            for i in range(lane, size, G):
                perm[i] = i
        p = 0
        while p <= pr and p < size - 1:
            i = crush_hash32_3(x, (-1 - b) & 0xFFFFFFFF, p) % (size - p)
            if i:
                perm[p], perm[p + i] = perm[p + i], perm[p]
            p += 1
        return int(self.items[b, perm[pr]])

    def perm_due(self, size, flocal):
        return self.lf > 0 and flocal >= (size >> 1) and flocal > self.lf

    def is_out(self, item, x):
        n = len(self.weight)
        if item >= n:
            return True
        w = self.weight[item]
        if w >= 0x10000:
            return False
        if w == 0:
            return True
        return (crush_hash32_2(x, item) & 0xFFFF) >= w

    # -- slot state: slot s in lane s % G, register s // G ---------------------

    def slots(self):
        return [[NONE] * self.NS for _ in range(G)]

    def read_slot(self, a, s):
        return a[s % G][s // G]

    def write_slot(self, a, s, v):
        a[s % G][s // G] = v

    def holds(self, a, lo, hi, v):
        """One ballot: any lane with a slot in [lo, hi) holding v."""
        return any(lo <= k * G + lane < hi and a[lane][k] == v
                   for lane in range(G) for k in range(self.NS))

    # -- the flat machine --------------------------------------------------------

    def run(self, x):
        """The kernel's loop for one x: the steps up to each draw, the one
        draw site, the draw's outcome; returns the row the lanes write."""
        R = self.R
        w, o, c = self.slots(), self.slots(), self.slots()
        self.write_slot(w, 0, -1 - self.take_b)
        wsize, s = 1, 0
        step = "stage"
        numrep = depth = recurse = osize = p = 0
        leafy = False
        b0 = base = count = rep = outpos = ftotal = flocal = in_b = d = 0
        item = size = 0
        collide = reject = False
        hb = hsize = lrep = lft = lfl = 0
        lcollide = False
        while True:
            ready = False
            while not ready:
                if step == "stage":
                    if s == len(self.prog):
                        return [self.read_slot(w, k) if k < wsize else NONE
                                for k in range(R)], wsize
                    numrep, depth, lf_, recurse = self.prog[s]
                    leafy = bool(lf_)
                    osize = p = 0
                    step = "parent"
                elif step == "parent":
                    if p < wsize and osize < R:
                        b0 = -1 - self.read_slot(w, p)
                        base, count = osize, R - osize
                        rep = outpos = 0
                        step = "rep_start"
                    else:
                        w = [list(cl) if leafy else list(ol)
                             for ol, cl in zip(o, c)]
                        wsize = osize
                        s += 1
                        step = "stage"
                elif step == "rep_start":
                    if rep < numrep and count > 0:
                        ftotal = 0
                        step = "descend"
                    else:
                        osize += outpos
                        p += 1
                        step = "parent"
                elif step == "descend":
                    in_b, flocal, d = b0, 0, 1
                    step = "descend_draw"
                elif step == "descend_draw":
                    if d < depth:
                        phase, db, r, perm = "descend", in_b, rep + ftotal, \
                            False
                        ready = True
                    else:
                        step = "bottom_draw"
                elif step == "bottom_draw":
                    size = int(self.sizes[in_b])
                    collide = False
                    if size > 0:
                        phase, db, r = "bottom", in_b, rep + ftotal
                        perm = self.perm_due(size, flocal)
                        ready = True
                    else:
                        reject = True
                        step = "bottom_fail"
                elif step == "bottom_resolve":
                    if not reject and not collide:
                        self.write_slot(o, base + outpos, item)
                        outpos += 1
                        count -= 1
                        rep += 1
                        step = "rep_start"
                    else:
                        step = "bottom_fail"
                elif step == "bottom_fail":
                    ftotal += 1
                    flocal += 1
                    if (collide and flocal <= self.lr) or (
                            self.lf > 0 and flocal <= size + self.lf):
                        step = "bottom_draw"
                    elif ftotal < self.tries:
                        step = "descend"
                    else:
                        rep += 1
                        step = "rep_start"
                elif step == "leaf_draw":
                    hsize = int(self.sizes[hb])
                    lcollide = False
                    if hsize > 0:
                        phase, db, r = "leaf", hb, lrep + lft
                        perm = self.perm_due(hsize, lfl)
                        ready = True
                    else:
                        step = "leaf_fail"
                elif step == "leaf_fail":
                    lft += 1
                    lfl += 1
                    if (lcollide and lfl <= self.lr) or (
                            self.lf > 0 and lfl <= hsize + self.lf):
                        step = "leaf_draw"
                    elif lft < recurse:
                        lfl = 0
                        step = "leaf_draw"
                    else:
                        reject = True
                        step = "bottom_resolve"
            # the one draw site
            drawn = (self.perm_draw if perm else self.bucket_draw)(db, x, r)
            if phase == "descend":
                in_b = -1 - drawn
                d += 1
                step = "descend_draw"
            elif phase == "bottom":
                item = drawn
                collide = self.holds(o, base, base + outpos, item)
                reject = False
                step = "bottom_resolve"
                if not collide and leafy:
                    if item < 0:
                        hb = -1 - item
                        lrep = 0 if self.stable else outpos
                        lft = lfl = 0
                        step = "leaf_draw"
                    else:
                        self.write_slot(c, base + outpos, item)
                if step == "bottom_resolve" and not collide and item >= 0:
                    reject = self.is_out(item, x)
            else:
                lcollide = self.holds(c, base, base + outpos, drawn)
                if not lcollide and not self.is_out(drawn, x):
                    self.write_slot(c, base + outpos, drawn)
                    reject = False
                    step = "bottom_resolve"
                else:
                    step = "leaf_fail"


def group_scheme(rule, xs, weight, grid_groups=3):
    """The kernel over ``xs`` with ``grid_groups`` groups striding over
    them: (out (X, R) int32, counts (X,) int32, the _Group of each grid
    group)."""
    n, R = len(xs), rule.result_max
    out = np.full((n, R), 7, np.int32)
    cnt = np.zeros(n, np.int32)
    groups = [_Group(rule, weight) for _ in range(grid_groups)]
    for gi, grp in enumerate(groups):
        for i in range(gi, n, grid_groups):
            row, cnt[i] = grp.run(int(xs[i]))
            out[i] = row
    return out, cnt, groups


def _cases():
    return [(name, rno, size) for name, (_, rules) in MAPS.items()
            for rno, size in rules]


_MAPS, _WANT = {}, {}


def _map(name):
    if name not in _MAPS:
        _MAPS[name] = CrushCompiler().compile(MAPS[name][0]).crush
    return _MAPS[name]


def _per_host(m):
    return m.max_devices // sum(1 for b in m.buckets
                                if b is not None and b.type == 1)


def _want(name, rno, size):
    """The plain version's rows under each weight vector, held against
    ``crush_do_rule`` once per (map, rule) and kept for every weight
    vector's case."""
    key = (name, rno)
    if key not in _WANT:
        m = _map(name)
        rule = tl.LegacyFastRule(m, rno, size, device="cpu")
        weights = chip_smoke.legacy_weights(m.max_devices, _per_host(m),
                                            np.random.default_rng(rno))
        xs = np.random.default_rng(100 + rno).integers(
            0, 2 ** 32, X_WIDE if name.startswith("wide") else X,
            dtype=np.uint64).astype(np.uint32)
        want = {}
        for wname, w in weights.items():
            out, cnt, res = tl.crush_legacy_plain(
                rule, torch.from_numpy(xs.view(np.int32)),
                torch.from_numpy(w.view(np.int32)))
            assert not res.any()
            wl = [int(v) for v in w]
            for i, x in enumerate(xs):
                assert out[i, :cnt[i]].tolist() == crush_do_rule(
                    m, rno, int(x), size, wl), (name, rno, wname, int(x))
            want[wname] = (w, out.numpy(), cnt.numpy())
        _WANT[key] = (rule, xs, want)
    return _WANT[key]


@pytest.mark.parametrize("wname", WEIGHTS)
@pytest.mark.parametrize("name,rno,size", _cases())
def test_group_scheme_matches_plain_and_host(name, rno, size, wname):
    """Under each weight vector, the transcription's rows and counts equal
    the plain version's, which equal ``crush_do_rule``'s; NONE past each
    count.  On the wide map a host draw takes several rounds of the
    group's lanes."""
    rule, xs, want = _want(name, rno, size)
    w, out, cnt = want[wname]
    got, gcnt, groups = group_scheme(rule, xs, w)
    np.testing.assert_array_equal(gcnt, cnt)
    np.testing.assert_array_equal(got, out)
    if name.startswith("wide"):
        assert max(g.widest for g in groups) > 32


def _tie_cases(kind, width, rng):
    """Value lists of one kind for the reductions: random, few distinct
    values, all equal (item 0 wins), and hand-made equal draws between item
    0 and items G + 1 and 2G (the second chain of lane 0 and lane 1's
    first), above (v1) or below (straw2) everything else."""
    if kind == "random":
        return [rng.integers(0, 1 << 48, width).tolist()]
    if kind == "few":
        return [rng.integers(0, 3, width).tolist()]
    if kind == "equal":
        return [[int(rng.integers(0, 1 << 48))] * width]
    cases = []
    for k in (G + 1, 2 * G):
        if k < width:
            hi = rng.integers(0, 1 << 40, width).tolist()
            hi[0] = hi[k] = 1 << 47
            lo = rng.integers(1 << 20, 1 << 40, width).tolist()
            lo[0] = lo[k] = 5
            cases += [hi, lo]
    return cases


@pytest.mark.parametrize("kind", ["random", "few", "equal", "ties"])
def test_reductions_keep_the_tie_rules(kind):
    """lane_best and the shuffle reduction give the serial loop's first
    maximum (straw v1, mapper.c's strict `>`) and first minimum (straw2)
    at every width 1..70, on each kind of value list (``_tie_cases``)."""
    rng = np.random.default_rng(len(kind))
    for width in range(1, 71):
        for vals in _tie_cases(kind, width, rng):
            smax = smin = 0
            for k in range(1, width):
                if vals[k] > vals[smax]:
                    smax = k
                if vals[k] < vals[smin]:
                    smin = k
            assert first_max(vals) == smax, (width, vals)
            assert first_min(vals) == smin, (width, vals)


def test_straw_draws_with_equal_scalers_tie_to_the_first_item():
    """Hand-made equal straw v1 draws: a host's straws all set to one
    value and its items 1 and 2 hashed under one id, so (hash & 0xffff) *
    straw ties between them; the group's winner is the first of the tied
    items, as mapper.c's strict `>` keeps it, and the draw returns its
    item."""
    m = _map("rack3x3x4")
    rule = tl.LegacyFastRule(m, 0, 3, device="cpu")
    tied = 0
    grp = _Group(rule, np.full(m.max_devices, 0x10000, np.uint32))
    b = int(np.nonzero(grp.sizes == 4)[0][0])
    grp.straws = grp.straws.copy()
    grp.straws[b, :4] = 0x10000
    grp.items = grp.items.copy()
    grp.items[b, 2] = grp.items[b, 1]
    for x in range(64):
        for r in range(4):
            d = [(crush_hash32_3(x, int(grp.items[b, k]), r) & 0xFFFF)
                 * 0x10000 for k in range(4)]
            assert d[1] == d[2]
            win = first_max(d)
            assert win == int(np.argmax(d))
            tied += win == 1
            assert grp.bucket_draw(b, x, r) == grp.items[b, win]
    assert tied


def test_permutation_draw_pinned():
    """The leader-lane permutation draw equals the host ``_perm_choose``
    (mapper.c bucket_perm_choose) and ``_Thread.perm_draw`` at every r in
    two cycles of the bucket, for every bucket of the wide map."""
    m = _map("wide3x2x40")
    rule = tl.LegacyFastRule(m, 0, 3, device="cpu")
    w = np.full(m.max_devices, 0x10000, np.uint32)
    t = _Thread(rule, w)
    grp = _Group(rule, w)
    for b, bucket in enumerate(m.buckets):
        if bucket is None:
            continue
        for r in range(2 * bucket.size):
            want = _perm_choose(bucket, 123456789, r)
            assert grp.perm_draw(b, 123456789, r) == want
            assert t.perm_draw(b, 123456789, r) == want


def test_heavy_out_weights_reach_the_permutation_draw():
    """The heavy-out weights drive the transcription into permutation
    draws on the small map, and into none with the fallback tries set to
    0 (rule 5)."""
    m = _map("rack3x3x4")
    heavy = chip_smoke.legacy_weights(m.max_devices, 4,
                                      np.random.default_rng(0))["heavy"]
    xs = np.arange(256, dtype=np.uint32)
    _, _, groups = group_scheme(tl.LegacyFastRule(m, 0, 3, device="cpu"),
                                xs, heavy)
    assert sum(g.perm for g in groups) > 0
    _, _, groups = group_scheme(tl.LegacyFastRule(m, 5, 3, device="cpu"),
                                xs, heavy)
    assert sum(g.perm for g in groups) == 0


def test_wrapper_on_a_cpu_tensor_is_the_plain_version():
    """``crush_legacy`` on CPU tensors returns the plain version's rows and
    counts, no x residual; x or weights that are not 1-D int32 raise
    before anything runs."""
    rule, xs, want = _want("rack3x3x4", 0, 3)
    w, out, cnt = want["out"]
    x = torch.from_numpy(xs.view(np.int32))
    wt = torch.from_numpy(w.view(np.int32))
    got, gcnt, res = tl.crush_legacy(rule, x, wt)
    np.testing.assert_array_equal(got.numpy(), out)
    np.testing.assert_array_equal(gcnt.numpy(), cnt)
    assert not res.any()
    for bad_x, bad_w in ((x.view(-1, 1), wt), (x.to(torch.int64), wt),
                         (x, wt.to(torch.int64))):
        with pytest.raises(ValueError):
            tl.crush_legacy(rule, bad_x, bad_w)
