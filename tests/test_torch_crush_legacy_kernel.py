"""K8's semantics, walked line for line for one x and held against the host
``crush_do_rule`` and the kernel's plain version, exactly.

``_Thread`` is the one-thread account of what ``csrc/crush_legacy.cu``
computes: ``bucket_draw`` (straw v1 u64 draw, first maximum; straw2 s64
quotient, first minimum), ``perm_draw`` (the Fisher-Yates prefix over a
scratch of the bucket's size), ``retry_draw``, ``choose_leaf`` (the
chooseleaf recursion as an inner loop), ``choose_firstn`` (retry_bucket /
retry_descent as one loop) and the stage chaining and EMIT.  It also
counts what the walk hashes per x (straw items, Fisher-Yates steps, is_out
tests), which ``chip_smoke.py`` scales into K8's bound, and the x that
take a permutation draw or a local retry.  The kernel itself, a group of
lanes per x, is transcribed by ``_Group`` in
``test_torch_crush_legacy_group.py``: change that with the kernel, and
this with the semantics.

The maps and weight vectors are ``chip_smoke.py``'s small legacy maps (36-80
OSDs compiled from crushtool text without tunable lines, so with the legacy
tunables 2 / 5 / 19), which its phase 3l also runs on the card.

Tolerance: exact equality.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from ceph_tpu_torch.crush.compiler import CrushCompiler
from ceph_tpu_torch.crush.constants import CRUSH_BUCKET_STRAW2
from ceph_tpu_torch.crush.hash import crush_hash32_2, crush_hash32_3
from ceph_tpu_torch.crush.mapper import crush_do_rule
from ceph_tpu_torch.ops import crush_legacy as tl
from ceph_tpu_torch.ops.crush_kernels import G_EXACT

NONE = tl.NONE
ZERO_DRAW = 1 << 62
MAX_REP = 32
X = 256


class _Thread:
    """K8's walk for one x at a time, with its counts: ``hashed``
    (hash32_3 / hash32_2 evaluations), ``perm`` (draws from the
    permutation), ``local`` (retries at the failing bucket)."""

    def __init__(self, rule: tl.LegacyFastRule, weight):
        C = rule.C
        self.items = C.items.cpu().numpy()
        self.sizes = C.sizes.cpu().numpy()
        self.algs = C.algs
        self.straws = C.straws.cpu().numpy().view(np.uint32)
        self.weights = C.weights[0].cpu().numpy().view(np.uint32)
        self.weight = [int(v) for v in weight]
        self.prog = rule.program
        self.take_b = -1 - rule.take
        self.tries = rule.tries
        self.lr, self.lf = rule.local_retries, rule.local_fallback
        self.stable = rule.stable
        self.R = rule.result_max
        self.hashed = self.perm = self.local = 0

    def h3(self, a, b, c):
        self.hashed += 1
        return crush_hash32_3(a & 0xFFFFFFFF, b & 0xFFFFFFFF, c & 0xFFFFFFFF)

    def bucket_draw(self, b, x, r):
        size = int(self.sizes[b])
        win, best = 0, 0
        if self.algs[b] == CRUSH_BUCKET_STRAW2:
            for k in range(size):
                wk = int(self.weights[b, k])
                q = ZERO_DRAW
                if wk:
                    u = self.h3(x, int(self.items[b, k]), r) & 0xFFFF
                    q = int(G_EXACT[u]) // wk
                if k == 0 or q < best:
                    best, win = q, k
        else:
            for k in range(size):
                u = self.h3(x, int(self.items[b, k]), r) & 0xFFFF
                d = u * int(self.straws[b, k])
                if k == 0 or d > best:
                    best, win = d, k
        return int(self.items[b, win])

    def perm_draw(self, b, x, r):
        size = int(self.sizes[b])
        pr = r % size
        perm = list(range(size))
        p = 0
        while p <= pr and p < size - 1:
            i = self.h3(x, -1 - b, p) % (size - p)
            if i:
                perm[p], perm[p + i] = perm[p + i], perm[p]
            p += 1
        return int(self.items[b, perm[pr]])

    def retry_draw(self, b, size, x, r, flocal):
        if self.lf > 0 and flocal >= (size >> 1) and flocal > self.lf:
            self.perm += 1
            return self.perm_draw(b, x, r)
        return self.bucket_draw(b, x, r)

    def is_out(self, item, x):
        n = len(self.weight)
        if item >= n:
            return True
        w = self.weight[item]
        if w >= 0x10000:
            return False
        if w == 0:
            return True
        self.hashed += 1
        return (crush_hash32_2(x, item) & 0xFFFF) >= w

    def choose_leaf(self, hb, x, rep, tries, leaves, base, outpos):
        size = int(self.sizes[hb])
        ftotal = flocal = 0
        while True:
            collide, reject, item = False, True, 0
            if size > 0:
                item = self.retry_draw(hb, size, x, rep + ftotal, flocal)
                for i in range(outpos):
                    collide |= leaves[base + i] == item
                reject = not collide and self.is_out(item, x)
            if not reject and not collide:
                return item
            ftotal += 1
            flocal += 1
            if collide and flocal <= self.lr:
                self.local += 1
                continue
            if self.lf > 0 and flocal <= size + self.lf:
                self.local += 1
                continue
            if ftotal < tries:
                flocal = 0
                continue
            return None

    def choose_firstn(self, b0, x, numrep, depth, leafy, recurse, o, c,
                      base, count):
        outpos = 0
        rep = 0
        while rep < numrep and count > 0:
            ftotal = flocal = 0
            in_b, item = b0, 0
            descend, skip = True, False
            while True:
                if descend:
                    in_b, flocal = b0, 0
                    for _ in range(1, depth):
                        in_b = -1 - self.bucket_draw(in_b, x, rep + ftotal)
                    descend = False
                size = int(self.sizes[in_b])
                collide, reject = False, True
                if size > 0:
                    item = self.retry_draw(in_b, size, x, rep + ftotal,
                                           flocal)
                    for i in range(outpos):
                        collide |= o[base + i] == item
                    reject = False
                    if not collide and leafy:
                        if item < 0:
                            leaf = self.choose_leaf(
                                -1 - item, x, 0 if self.stable else outpos,
                                recurse, c, base, outpos)
                            reject = leaf is None
                            if not reject:
                                c[base + outpos] = leaf
                        else:
                            c[base + outpos] = item
                    if not reject and not collide and item >= 0:
                        reject = self.is_out(item, x)
                if not reject and not collide:
                    break
                ftotal += 1
                flocal += 1
                if collide and flocal <= self.lr:
                    self.local += 1
                    continue
                if self.lf > 0 and flocal <= size + self.lf:
                    self.local += 1
                    continue
                if ftotal < self.tries:
                    descend = True
                    continue
                skip = True
                break
            if not skip:
                o[base + outpos] = item
                outpos += 1
                count -= 1
            rep += 1
        return outpos

    def run(self, x):
        w = [0] * MAX_REP
        o = [0] * MAX_REP
        c = [0] * MAX_REP
        wsize = 1
        w[0] = -1 - self.take_b
        for numrep, depth, leafy, recurse in self.prog:
            osize = 0
            p = 0
            while p < wsize and osize < self.R:
                osize += self.choose_firstn(
                    -1 - w[p], x, int(numrep), int(depth), bool(leafy),
                    int(recurse), o, c, osize, self.R - osize)
                p += 1
            for k in range(osize):
                w[k] = c[k] if leafy else o[k]
            wsize = osize
        return w[:wsize]


def legacy_scheme(rule, xs, weight):
    """The transcription over ``xs``: (rows, items hashed per x, x taking a
    permutation draw, x taking a local retry)."""
    rows, hashed = [], np.zeros(len(xs), np.int64)
    perm = np.zeros(len(xs), bool)
    local = np.zeros(len(xs), bool)
    for i, x in enumerate(xs):
        t = _Thread(rule, weight)
        rows.append(t.run(int(x)))
        hashed[i], perm[i], local[i] = t.hashed, t.perm > 0, t.local > 0
    return rows, hashed, perm, local


def _cases():
    return [(name, rno, size) for name, (_, rules)
            in chip_smoke.legacy_small_maps().items() for rno, size in rules]


_MAPS = {}


def _map(name):
    if name not in _MAPS:
        text, _ = chip_smoke.legacy_small_maps()[name]
        _MAPS[name] = CrushCompiler().compile(text).crush
    return _MAPS[name]


@pytest.mark.parametrize("name,rno,size", _cases())
def test_kernel_scheme_matches_host_and_plain(name, rno, size):
    """Under every weight vector, the transcription's rows equal
    ``crush_do_rule``'s and the plain version's on 256 x; the x the plain
    version marks as taking a permutation draw and a local retry are the
    ones the transcription takes them on."""
    m = _map(name)
    rule = tl.LegacyFastRule(m, rno, size, device="cpu")
    per_host = m.max_devices // sum(1 for b in m.buckets
                                    if b is not None and b.type == 1)
    weights = chip_smoke.legacy_weights(m.max_devices, per_host,
                                        np.random.default_rng(rno))
    xs = (np.arange(X, dtype=np.uint64) * 2654435761
          & 0xFFFFFFFF).astype(np.uint32)
    for wname, w in weights.items():
        rows, hashed, perm, local = legacy_scheme(rule, xs, w)
        wl = [int(v) for v in w]
        for x, got in zip(xs, rows):
            assert got == crush_do_rule(m, rno, int(x), size, wl), \
                (name, rno, wname, int(x))
        stats = {}
        out, cnt, res = tl.crush_legacy_plain(
            rule, torch.from_numpy(xs.view(np.int32)),
            torch.from_numpy(w.view(np.int32)), stats)
        assert not res.any()
        for i, got in enumerate(rows):
            assert out[i, :cnt[i]].tolist() == got
        np.testing.assert_array_equal(stats["perm"].numpy(), perm)
        np.testing.assert_array_equal(stats["local"].numpy(), local)
        assert (hashed > 0).all()


def test_kernel_scheme_takes_the_permutation_draw():
    """Heavy-out hosts drive local retries past the fallback count: some x
    take the permutation draw, and with the fallback tries set to 0 none
    do."""
    m = _map("rack3x3x4")
    w = chip_smoke.legacy_weights(m.max_devices, 4,
                                  np.random.default_rng(0))["heavy"]
    xs = np.arange(512, dtype=np.uint32)
    _, _, perm, local = legacy_scheme(tl.LegacyFastRule(m, 0, 3,
                                                        device="cpu"), xs, w)
    assert perm.sum() > 0 and local.sum() > perm.sum()
    _, _, perm0, _ = legacy_scheme(tl.LegacyFastRule(m, 5, 3, device="cpu"),
                                   xs, w)
    assert perm0.sum() == 0
