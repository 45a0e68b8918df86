"""K6 of the port, the whole-rule CRUSH mapper, against the JAX package,
exactly.

- ``DeviceCrushMapper`` of the port on the CPU (``crush_rule_plain``)
  against the JAX ``DeviceCrushMapper`` (its vmapped loops, XLA on the
  CPU) and the JAX host ``crush_do_rule``, both maps built through
  ``build_map``, on every map and rule of ``test_crush_device.py``:
  firstn and indep, chooseleaf and direct, out devices and NONE holes,
  chained steps, each tunable profile, ``choose_args``, a take of a bucket
  of its own type; and its two rejections, with the same exception type.
- Rule shapes beyond those (a chained indep step whose block straddles
  result_max, a numrep that expands to nothing, chooseleaf indep straight
  to devices with out devices, two TAKE/EMIT blocks) against the JAX host
  ``crush_do_rule``, whose walk K6 follows step for step.
- The torch ``crush_ln_dev`` against the JAX one over all 65536 u, and
  against the G table the kernels gather from.
- ``_rule_scheme`` transcribes, one x at a time, the loops of
  ``crush_rule_kernel`` in ``csrc/crush_fast.cu`` (get/put slot state, the
  do-while descents, each bucket's quotient table or s64 divide, the
  packed form over an index list); it is held against
  ``crush_rule_plain`` on eight small rules, so the kernel's control flow
  is checked before it reaches the card.  Change it with the kernel.

Tolerance: exact equality.
"""
import numpy as np
import pytest
import torch

import ceph_tpu.crush as jc
import ceph_tpu_torch.crush as tc
from ceph_tpu.ops import crush_kernels as jk
from ceph_tpu_torch.ops import crush_kernels as tk
from ceph_tpu_torch.ops import crush_fast

from test_torch_crush_host import build_map, rule_of, three_level_map

N_X = 400
M32 = 0xFFFFFFFF


def _port(cw, rno, rmax, args=None):
    return tk.DeviceCrushMapper(tk.compile_map(cw.crush, args, device="cpu"),
                                rno, rmax)


def assert_k6_matches(pair, rno, rmax, weight, n_x=N_X, args_index=None,
                      jax_mapper=True):
    """The port's DeviceCrushMapper against the JAX one (when asked) and
    the JAX host interpreter, rows and counts."""
    (rcw, _), (pcw, _) = pair
    xs = np.arange(n_x, dtype=np.uint32)
    pargs = pcw.choose_args_get(args_index) if args_index is not None \
        else None
    res, cnt = _port(pcw, rno, rmax, pargs).map_batch(xs, weight)
    res, cnt = res.numpy(), cnt.numpy()
    if jax_mapper:
        rargs = rcw.choose_args_get(args_index) if args_index is not None \
            else None
        jres, jcnt = jk.DeviceCrushMapper(jk.compile_map(rcw.crush, rargs),
                                          rno, rmax).map_batch(xs, weight)
        np.testing.assert_array_equal(res, np.asarray(jres))
        np.testing.assert_array_equal(cnt, np.asarray(jcnt))
    wl = [int(w) for w in weight]
    for x in range(n_x):
        want = rcw.do_rule(rno, x, rmax, wl, choose_args_index=args_index)
        assert [int(v) for v in res[x, :cnt[x]]] == want, x
        assert (res[x, cnt[x]:] == tc.CRUSH_ITEM_NONE).all()


def _pair(**kw):
    return build_map(jc, **kw), build_map(tc, **kw)


def _both(pair, fn):
    """Apply ``fn(pkg, cw)`` to both maps; the rule numbers agree."""
    (rcw, _), (pcw, _) = pair
    a, b = fn(jc, rcw), fn(tc, pcw)
    assert a == b
    return a


def _simple(mode, erasure=False):
    def add(pkg, cw):
        kw = {"rule_type": pkg.PG_POOL_TYPE_ERASURE} if erasure else {}
        return cw.add_simple_rule("r", "default", "host", mode=mode, **kw)
    return add


def _steps(steps, name, rtype=1, max_size=10):
    return lambda pkg, cw: rule_of(pkg, cw, steps, name, rtype, max_size)


F, I, CF, CI, E, T = (tc.CRUSH_RULE_CHOOSE_FIRSTN, tc.CRUSH_RULE_CHOOSE_INDEP,
                      tc.CRUSH_RULE_CHOOSELEAF_FIRSTN,
                      tc.CRUSH_RULE_CHOOSELEAF_INDEP, tc.CRUSH_RULE_EMIT,
                      tc.CRUSH_RULE_TAKE)


# ---- every map and rule of test_crush_device.py ------------------------------

def test_chooseleaf_firstn_parity():
    pair = _pair()
    rno = _both(pair, _simple("firstn"))
    assert_k6_matches(pair, rno, 3, [0x10000] * pair[0][1])


def test_chooseleaf_firstn_uneven_weights():
    pair = _pair(n_hosts=7, osds_per_host=3, uneven=True)
    rno = _both(pair, _simple("firstn"))
    assert_k6_matches(pair, rno, 3, [0x10000] * pair[0][1])


def test_firstn_with_out_devices():
    pair = _pair(n_hosts=6, osds_per_host=4)
    n = pair[0][1]
    rno = _both(pair, _simple("firstn"))
    rng = np.random.default_rng(3)
    weight = [0x10000] * n
    for i in rng.choice(n, size=n // 3, replace=False):
        weight[i] = int(rng.choice([0, 0x4000, 0x8000, 0xC000]))
    assert_k6_matches(pair, rno, 3, weight)


def test_choose_firstn_direct_osds():
    pair = _pair(n_hosts=4, osds_per_host=5)
    rno = _both(pair, _steps([(T, -1, 0), (F, 0, 0), (E, 0, 0)], "flat"))
    weight = [0x10000] * pair[0][1]
    weight[3] = 0
    weight[11] = 0x7000
    assert_k6_matches(pair, rno, 3, weight)


def test_chooseleaf_indep_parity():
    pair = _pair(n_hosts=8, osds_per_host=3, uneven=True)

    def add(pkg, cw):
        rno = _simple("indep", erasure=True)(pkg, cw)
        cw.set_rule_mask_max_size(rno, 8)
        return rno
    rno = _both(pair, add)
    assert_k6_matches(pair, rno, 6, [0x10000] * pair[0][1])


def test_chooseleaf_indep_with_out_devices_emits_holes():
    pair = _pair(n_hosts=5, osds_per_host=2)
    rno = _both(pair, _simple("indep", erasure=True))
    weight = [0x10000] * pair[0][1]
    weight[0] = 0
    weight[5] = 0
    assert_k6_matches(pair, rno, 4, weight)
    # an impossible layout: indep pads failures with CRUSH_ITEM_NONE
    pair = _pair(n_hosts=3, osds_per_host=1)
    rno = _both(pair, _simple("indep", erasure=True))
    assert_k6_matches(pair, rno, 5, [0x10000] * pair[0][1])


def test_choose_indep_direct_osds():
    pair = _pair(n_hosts=4, osds_per_host=4)
    rno = _both(pair, _steps([(T, -1, 0), (I, 0, 0), (E, 0, 0)], "flatec",
                             3, 20))
    weight = [0x10000] * pair[0][1]
    weight[7] = 0
    assert_k6_matches(pair, rno, 4, weight)


def test_chained_choose_steps():
    pair = _pair(n_hosts=6, osds_per_host=4, uneven=True)
    rno = _both(pair, _steps([(T, -1, 0), (F, 2, 1), (F, 2, 0), (E, 0, 0)],
                             "two-level"))
    assert_k6_matches(pair, rno, 4, [0x10000] * pair[0][1])


@pytest.mark.parametrize("profile", ["bobtail", "firefly", "hammer", "jewel"])
def test_tunable_profiles(profile):
    pair = _pair(n_hosts=5, osds_per_host=3, uneven=True)

    def add(pkg, cw):
        cw.set_tunables_profile(profile)
        return _simple("firstn")(pkg, cw)
    rno = _both(pair, add)
    weight = [0x10000] * pair[0][1]
    weight[2] = 0
    assert_k6_matches(pair, rno, 3, weight, n_x=200)


def test_choose_args_weight_override():
    pair = _pair(n_hosts=4, osds_per_host=3)

    def add(pkg, cw):
        rno = _simple("firstn")(pkg, cw)
        args = cw.choose_args_create(0)
        b = cw.get_bucket(-3)
        args[2].weight_set = [
            pkg.WeightSet(weights=[0x8000 if i == 1 else w
                                   for i, w in enumerate(b.item_weights)]),
            pkg.WeightSet(weights=list(b.item_weights)),
        ]
        return rno
    rno = _both(pair, add)
    assert_k6_matches(pair, rno, 3, [0x10000] * pair[0][1], args_index=0)


def test_choose_take_buckets_own_type():
    pair = _pair(n_hosts=4, osds_per_host=3)
    rno = _both(pair, _steps([(T, -1, 0), (F, 2, 10), (E, 0, 0)],
                             "degenerate"))
    assert_k6_matches(pair, rno, 2, [0x10000] * pair[0][1], n_x=64)


@pytest.mark.parametrize("pkg,kernels", [(jc, jk), (tc, tk)],
                         ids=["jax", "port"])
def test_rejects_non_straw2_map(pkg, kernels):
    cw = pkg.CrushWrapper()
    cw.set_max_devices(4)
    cw.set_type_name(10, "root")
    cw.add_bucket(pkg.CRUSH_BUCKET_STRAW, 10, "default", [0, 1, 2, 3],
                  [0x10000] * 4, id=-1)
    kw = {"device": "cpu"} if kernels is tk else {}
    with pytest.raises(ValueError):
        kernels.compile_map(cw.crush, **kw)


@pytest.mark.parametrize("pkg,kernels", [(jc, jk), (tc, tk)],
                         ids=["jax", "port"])
def test_rejects_legacy_tunables(pkg, kernels):
    cw, _ = build_map(pkg)
    cw.set_tunables_profile("argonaut")
    kw = {"device": "cpu"} if kernels is tk else {}
    with pytest.raises(ValueError):
        kernels.compile_map(cw.crush, **kw)


def test_rejects_no_rule_and_local_tries_steps():
    cw, _ = build_map(tc)
    cm = tk.compile_map(cw.crush, device="cpu")
    with pytest.raises(ValueError):
        tk.DeviceCrushMapper(cm, 3, 3)
    rno = rule_of(tc, cw, [(tc.CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES, 2, 0),
                           (T, -1, 0), (CF, 0, 1), (E, 0, 0)], "local")
    with pytest.raises(ValueError):
        tk.DeviceCrushMapper(tk.compile_map(cw.crush, device="cpu"), rno, 3)


# ---- more rule shapes, against crush_do_rule ------------------------------------

@pytest.mark.parametrize("case", ["straddle", "empty_numrep",
                                  "indep_devices_out", "two_emits"])
def test_rule_walk_follows_crush_do_rule(case):
    """Rule shapes where only the host interpreter is the reference: a
    chained indep step whose second parent's block straddles result_max
    (out_size = what is left), a numrep that expands to nothing (the step
    leaves no item), chooseleaf indep straight to devices with out
    devices (the leaf slot keeps the rejected device, mapper.c:736-742),
    and two TAKE/EMIT blocks."""
    pair = _pair(n_hosts=6, osds_per_host=4, uneven=True)
    n = pair[0][1]
    weight = [0x10000] * n
    rmax = 3
    if case == "straddle":
        st = [(T, -1, 0), (I, 2, 1), (I, 2, 0), (E, 0, 0)]
    elif case == "empty_numrep":
        st = [(T, -1, 0), (F, -5, 1), (F, 1, 0), (E, 0, 0)]
    elif case == "indep_devices_out":
        st = [(T, -2, 0), (CI, 0, 0), (E, 0, 0)]
        weight[0] = weight[2] = 0
        rmax = 5
    else:
        st = [(T, -2, 0), (F, 1, 0), (E, 0, 0), (T, -3, 0), (F, 0, 0),
              (E, 0, 0)]
        rmax = 4
    rno = _both(pair, _steps(st, case, 3, 20))
    assert_k6_matches(pair, rno, rmax, weight, jax_mapper=False)


# ---- crush_ln ------------------------------------------------------------------

def test_crush_ln_dev_matches_jax_and_g_table():
    import jax.numpy as jnp
    from ceph_tpu.arch import enable_x64
    u = np.arange(0x10000, dtype=np.uint32)
    with enable_x64():
        want = np.asarray(jk.crush_ln_dev(jnp.asarray(u)))
    got = tk.crush_ln_dev(torch.from_numpy(u.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal((1 << 48) - got.numpy(), tk.G_EXACT)
    np.testing.assert_array_equal(tk.g_table(torch.device("cpu")).numpy(),
                                  tk.G_EXACT)


# ---- the kernel's loops, transcribed ----------------------------------------------

def _h3(a, b, c):
    return tc.hash.crush_hash32_3(a & M32, b & M32, c & M32)


class _Thread:
    """crush_rule_kernel's device functions for one x."""

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

    def straw2_win(self, b, x, r, p, table):
        win, best = 0, 0
        for k in range(int(self.sizes[b])):
            if table >= 0:
                v = int(self.qt[table, _h3(x, int(self.ids[b, k]), r)
                                & 0xFFFF])
            else:
                wk = int(self.weights[p, b, k])
                v = 1 << 62
                if wk:
                    v = int(self.g[_h3(x, int(self.ids[b, k]), r)
                                   & 0xFFFF]) // wk
            if k == 0 or v < best:
                best, win = v, k
        return int(self.items[b, win])

    def type_of(self, item):
        return 0 if item >= 0 else int(self.types[-1 - item])

    def descend(self, b, x, r, pos, type_):
        p = min(pos, self.npos - 1)
        for _ in range(tk.MAX_DESCENT):
            if self.sizes[b] == 0:
                return 0, "empty"
            table = int(self.qsel[b])
            if table >= 0:
                self.tables_used.add(table)
            item = self.straw2_win(b, x, r & M32, p, table)
            if self.type_of(item) == type_:
                return item, "ok"
            if item >= 0:
                return item, "dead"
            b = -1 - item
        return 0, "dead"

    def is_out(self, item, x):
        n = len(self.weight)
        w = int(self.weight[max(item, 0)]) if item < n else 0
        if item >= n:
            return True
        if w >= 0x10000:
            return False
        if w == 0:
            return True
        return (tc.hash.crush_hash32_2(x, item & M32) & 0xFFFF) >= w

    def firstn_leaf(self, b, x, r, base, outpos, recurse, vary_r, stable, c):
        sub_r = (r >> (vary_r - 1)) if vary_r else 0
        rep = 0 if stable else outpos
        ft = 0
        while True:
            lf, st = self.descend(b, x, rep + sub_r + ft, outpos, 0)
            if st == "dead":
                return None
            if st == "ok" and lf not in c[base:base + outpos] \
                    and not self.is_out(lf, x):
                return lf
            ft += 1
            if ft >= recurse:
                return None

    def choose_firstn(self, row, b0, x, base, count, o, c):
        op, type_, numrep, tries, recurse = (row[0], row[2], row[3], row[4],
                                             row[5])
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
                reject, collide = st == "empty", False
                if not reject:
                    collide = item in o[base:base + outpos]
                    if not collide and leafy:
                        if item < 0:
                            leaf = self.firstn_leaf(
                                -1 - item, x, r, base, outpos, recurse,
                                row[6], row[7], c)
                            if leaf is None:
                                reject = True
                            else:
                                c[base + outpos] = leaf
                        else:
                            c[base + outpos] = item
                    if not reject and not collide and self.type_of(item) == 0:
                        reject = self.is_out(item, x)
                if not reject and not collide:
                    o[base + outpos] = item
                    outpos += 1
                    count -= 1
                    break
                ftotal += 1
                if ftotal >= tries:
                    break
            rep += 1
        return outpos

    def indep_leaf(self, b, x, rep, r, numrep, recurse):
        for ft in range(recurse):
            lf, st = self.descend(b, x, rep + r + numrep * ft, rep, 0)
            if st == "dead":
                return tc.CRUSH_ITEM_NONE
            if st == "ok" and not self.is_out(lf, x):
                return lf
        return tc.CRUSH_ITEM_NONE

    def choose_indep(self, row, b0, x, base, out_size, o, c):
        NONE, UNDEF = tc.CRUSH_ITEM_NONE, tc.CRUSH_ITEM_UNDEF
        op, type_, numrep, tries, recurse = (row[0], row[2], row[3], row[4],
                                             row[5])
        leafy = op == CI
        end = base + out_size
        for i in range(base, end):
            o[i] = c[i] = UNDEF
        left = out_size
        ftotal = 0
        while left > 0 and ftotal < tries:
            for rep in range(out_size):
                if o[base + rep] != UNDEF:
                    continue
                r = rep + numrep * ftotal
                item, st = self.descend(b0, x, r, 0, type_)
                if st == "empty":
                    continue
                if st == "dead":
                    o[base + rep] = c[base + rep] = NONE
                    left -= 1
                    continue
                if item in o[base:end]:
                    continue
                if leafy:
                    if item < 0:
                        leaf = self.indep_leaf(-1 - item, x, rep, r, numrep,
                                               recurse)
                        c[base + rep] = leaf
                        if leaf == NONE:
                            continue
                    else:
                        c[base + rep] = item
                if self.type_of(item) == 0 and self.is_out(item, x):
                    continue
                o[base + rep] = item
                left -= 1
            ftotal += 1
        for i in range(base, end):
            if o[i] == UNDEF:
                o[i] = NONE
            if c[i] == UNDEF:
                c[i] = NONE

    def run(self, rows, x, result_max, NR):
        NONE = tc.CRUSH_ITEM_NONE
        w, o, c = [NONE] * NR, [NONE] * NR, [NONE] * NR
        wsize, out = 0, []
        for row in rows:
            op = row[0]
            if op == T:
                w[0], wsize = int(row[1]), 1
            elif op == E:
                for q in range(wsize):
                    if len(out) >= result_max:
                        break
                    out.append(w[q])
                wsize = 0
            elif wsize > 0:
                firstn = op in (F, CF)
                leafy = op in (CF, CI)
                numrep = row[3]
                osize = 0
                for q in range(wsize if numrep > 0 else 0):
                    parent = w[q]
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
                w = [c[q] if leafy and q < osize else o[q] for q in range(NR)]
                wsize = osize
        return out


def _rule_scheme(prog, xs, weight, idx=None, n_live=None, packed=None):
    """crush_rule_kernel, one x at a time: rows and counts, or the packed
    form over ``idx[:n_live]``."""
    R = prog.result_max
    NR = 3 if R <= 3 else 12 if R <= 12 else tk.MAX_REP
    th = _Thread(prog, weight)
    rows = [[int(v) for v in r] for r in prog.rows]
    xs = np.asarray(xs).view(np.uint32)
    if packed is None:
        out = np.full((len(xs), R), tc.CRUSH_ITEM_NONE, np.int32)
        cnt = np.zeros(len(xs), np.int32)
        for i, x in enumerate(xs):
            got = th.run(rows, int(x), R, NR)
            out[i, :len(got)] = got
            cnt[i] = len(got)
        return out, cnt, th
    for i in range(n_live):
        j = int(idx[i])
        got = th.run(rows, int(xs[j]), R, NR)
        packed[j, :] = tc.CRUSH_ITEM_NONE
        packed[j, :len(got)] = got
        packed[j, R] = len(got)
    return packed, None, th


def _scheme_cases():
    cases = []
    for mode in ("firstn", "indep"):
        for uneven in (False, True):
            cw, n = build_map(tc, n_hosts=6, osds_per_host=3, uneven=uneven)
            cases.append((f"chooseleaf_{mode}_{uneven}", cw, n,
                          cw.add_simple_rule("r", "default", "host",
                                             mode=mode), 4, None))
    for op in (F, I):
        cw, n = build_map(tc, n_hosts=5, osds_per_host=3, uneven=True)
        cases.append((f"chained_{op}", cw, n,
                      rule_of(tc, cw, [(T, -1, 0), (op, 2, 1), (op, 2, 0),
                                       (E, 0, 0)], "c"), 3, None))
    cw, n = three_level_map(tc)
    cases.append(("chained_leaf", cw, n,
                  rule_of(tc, cw, [(T, -1, 0), (F, 2, 2), (CF, 2, 1),
                                   (E, 0, 0)], "c"), 4, None))
    cw, n = build_map(tc, n_hosts=5, osds_per_host=3)
    rno = cw.add_simple_rule("d", "default", "host", mode="firstn")
    args = cw.choose_args_create(0)
    rng = np.random.default_rng(6)
    for bi, b in enumerate(cw.crush.buckets):
        args[bi].weight_set = [tc.WeightSet(weights=[
            int(v) for v in rng.integers(0x8000, 0x20000, b.size)])
            for _ in range(3)]
    cases.append(("positions", cw, n, rno, 3, args))
    return cases


@pytest.mark.parametrize("case", _scheme_cases(), ids=lambda c: c[0])
def test_kernel_scheme_matches_plain(case):
    """The transcription of K6's loops equals ``crush_rule_plain`` on every
    x, in both forms (rows, and rows written over an index list into a
    packed table), under all-in weights and a mix of out and reweighted
    OSDs; the uniform maps draw some buckets from quotient tables."""
    name, cw, n, rno, rmax, args = case
    prog = tk.compile_map(cw.crush, args, device="cpu").compile_rule(rno,
                                                                    rmax)
    xs = torch.from_numpy((np.arange(64, dtype=np.uint64) * 2654435761
                           & M32).astype(np.uint32).view(np.int32))
    rng = np.random.default_rng(7)
    for w in (np.full(n, 0x10000, np.uint32),
              rng.choice([0, 0x3000, 0x10000], size=n).astype(np.uint32)):
        wt = torch.from_numpy(w.view(np.int32))
        res, cnt = tk.crush_rule(prog, xs, wt)
        got, gcnt, th = _rule_scheme(prog, xs.numpy(), w)
        np.testing.assert_array_equal(got, res.numpy())
        np.testing.assert_array_equal(gcnt, cnt.numpy())
        if name == "chooseleaf_firstn_False":
            assert th.tables_used       # the quotient-table draw ran
        sel = np.array([5, 17, 40, 63, 2], dtype=np.int32)
        idx = torch.from_numpy(np.concatenate([sel, np.zeros(59, np.int32)]))
        base = np.full((64, rmax + 1), 7, np.int32)
        packed = torch.from_numpy(base.copy())
        tk.crush_rule(prog, xs, wt, idx=idx,
                      n_live=torch.tensor([4], dtype=torch.int32),
                      packed=packed)
        want, _, _ = _rule_scheme(prog, xs.numpy(), w, idx.numpy(), 4,
                                  base.copy())
        np.testing.assert_array_equal(packed.numpy(), want)
        assert (packed.numpy()[2] == 7).all()      # idx[4:] left alone


def test_wrapper_takes_plain_only_on_cpu():
    """On CPU tensors K6's wrapper is the plain version and counts no
    launch; malformed arguments raise before any launch."""
    cw, n = build_map(tc, n_hosts=4, osds_per_host=3)
    rno = cw.add_simple_rule("d", "default", "host", mode="indep")
    mapper = _port(cw, rno, 3)
    before = tk.rule_launches.n
    res, cnt = mapper.map_batch(np.arange(32), np.full(n, 0x10000, np.uint32))
    assert tk.rule_launches.n == before
    assert res.dtype == torch.int32 and tuple(res.shape) == (32, 3)
    x = torch.zeros(4, dtype=torch.int32)
    w = torch.zeros(n, dtype=torch.int32)
    with pytest.raises(ValueError):
        tk.crush_rule(mapper.program, x.long(), w)
    with pytest.raises(ValueError):
        tk.crush_rule(mapper.program, x, w, idx=x)
    with pytest.raises(crush_fast.UnsupportedRule):
        crush_fast.compile_fast_rule(cw.crush, rno, 33, device="cpu")
