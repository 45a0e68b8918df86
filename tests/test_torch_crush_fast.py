"""The port's candidate-table mapper (K7a/K7b on their plain versions, CPU)
against the JAX package, exactly.

- On integer-table (uniform-weight) maps the port's candidates, leaf
  attempts and packed ``(X, R+1)`` rows, residual bits included, equal
  the JAX ``FastRule``'s (``_cand`` and ``_packed_jit``, XLA on the CPU),
  over several weight vectors; firstn only, since each JAX rule costs
  seconds of XLA compile (the indep one is held in test_torch_osdmap.py).
- Everywhere else ``map_batch`` equals the JAX host ``crush_do_rule``:
  indep, chained rules, choose_args positions, near ties, pathological
  weights, a zero-weight bucket, a map without integer levels, delta
  epochs with cap overflow, room truncation.
- ``_descend_scheme`` / ``_resolve_scheme`` transcribe, one lane or one x
  at a time, the loops of ``csrc/crush_fast.cu`` (K7a, K7b in both
  modes); they are held against the plain versions here, so the kernels'
  control flow is checked before it reaches the card.  Change them with
  the kernels.

Tolerance: exact equality.
"""
import numpy as np
import pytest
import torch

import ceph_tpu.crush as jc
import ceph_tpu_torch.crush as tc
from ceph_tpu.ops.crush_fast import compile_fast_rule as jax_compile
from ceph_tpu_torch.ops import crush_fast, crush_kernels
from ceph_tpu_torch.ops.crush_fast import (NONE, UNDEF, ResolveSpec,
                                           UnsupportedRule,
                                           compile_fast_rule)

import test_crush_device
from test_torch_crush_host import (build_corpus_map, build_map, rule_of,
                                   three_level_map)

N_X = 400
M32 = 0xFFFFFFFF


def port_rule(cw, rno, result_max, choose_args=None, **kw):
    return compile_fast_rule(cw.crush, rno, result_max, choose_args,
                             device="cpu", **kw)


def assert_matches_host(ref_cw, port_cw, rno, result_max, weight,
                        n_x=N_X, choose_args_index=None, fr=None):
    """map_batch of the port against the JAX host interpreter."""
    if fr is None:
        args = (port_cw.choose_args_get(choose_args_index)
                if choose_args_index is not None else None)
        fr = port_rule(port_cw, rno, result_max, args)
    res, cnt = fr.map_batch(np.arange(n_x, dtype=np.uint32), weight)
    wl = [int(w) for w in weight]
    for x in range(n_x):
        want = ref_cw.do_rule(rno, x, result_max, wl,
                              choose_args_index=choose_args_index)
        assert [int(v) for v in res[x, :cnt[x]]] == want, \
            (x, fr.residual_fraction)
    return fr


# ---- packed rows against the JAX FastRule (integer tables, firstn) -----------

def _pair_maps(kind):
    F, E, T = (jc.CRUSH_RULE_CHOOSE_FIRSTN, jc.CRUSH_RULE_EMIT,
               jc.CRUSH_RULE_TAKE)
    out = []
    for pkg in (jc, tc):
        if kind == "chooseleaf":
            cw, n = build_map(pkg, n_hosts=8, osds_per_host=4)
            rno = cw.add_simple_rule("r", "default", "host", mode="firstn")
            rmax = 3
        elif kind == "flat":
            cw, n = build_map(pkg, n_hosts=4, osds_per_host=6)
            rno = rule_of(pkg, cw, [(T, -1, 0), (F, 0, 0), (E, 0, 0)],
                          "flat")
            rmax = 3
        else:   # chained: choose firstn 2 racks; chooseleaf firstn 2 hosts
            cw, n = three_level_map(pkg, uniform=True)
            rno = rule_of(pkg, cw, [(T, -1, 0), (F, 2, 2),
                                    (jc.CRUSH_RULE_CHOOSELEAF_FIRSTN, 2, 1),
                                    (E, 0, 0)], "chain")
            rmax = 4
        out.append((cw, rno, n, rmax))
    return out


@pytest.mark.parametrize("kind", ["chooseleaf", "flat", "chained"])
def test_packed_rows_match_jax(kind):
    import jax.numpy as jnp
    (rcw, rno, n, rmax), (pcw, prno, _, _) = _pair_maps(kind)
    assert prno == rno
    xs = np.arange(N_X, dtype=np.uint32)
    jfr = jax_compile(rcw.crush, rno, rmax)
    pfr = port_rule(pcw, rno, rmax)
    assert all(pfr.integer_exact_levels) and \
        pfr.integer_exact_levels == jfr.integer_exact_levels
    jfr.prepare_candidates(xs)
    pfr.prepare_candidates(xs)
    jcand, jleaf, _, jvalid, jxl = (np.asarray(a) for a in jfr._cand)
    cand, leaf, _, valid, xl = pfr._cand
    R, P, N = cand.shape
    np.testing.assert_array_equal(cand.numpy().reshape(R, N), jcand)
    if pfr.leafy:
        np.testing.assert_array_equal(
            leaf.numpy().reshape(R, pfr.n_leaf, N), jleaf)
    np.testing.assert_array_equal(valid.numpy(), jvalid)
    np.testing.assert_array_equal(xl.numpy().view(np.uint32), jxl)
    rng = np.random.default_rng(5)
    weights = [np.full(n, 0x10000, np.uint32)]
    w = weights[0].copy()
    w[[1, 6]] = 0
    w[3] = 0x8000
    weights.append(w)
    weights.append(rng.choice([0, 0x2000, 0x8000, 0x10000],
                              size=n).astype(np.uint32))
    seen_residual = False
    for w in weights:
        want = np.asarray(jfr._packed_jit(*jfr._cand, jfr._cand_x,
                                          jnp.asarray(w)))
        got = pfr.resolve_packed(torch.from_numpy(w.view(np.int32)))
        np.testing.assert_array_equal(got.numpy(), want)
        seen_residual |= bool(((want[:, rmax] >> 16) != 0).any())
    assert seen_residual      # the residual bits were compared, not all 0


# ---- map_batch against the JAX host interpreter --------------------------------

def test_chooseleaf_indep_exact64():
    rcw, n = test_crush_device.build_map(n_hosts=9, osds_per_host=3,
                                         uneven=True)
    pcw, _ = build_map(tc, n_hosts=9, osds_per_host=3, uneven=True)
    for cw, pkg in ((rcw, jc), (pcw, tc)):
        rno = cw.add_simple_rule("ec", "default", "host", mode="indep",
                                 rule_type=pkg.PG_POOL_TYPE_ERASURE)
        cw.set_rule_mask_max_size(rno, 8)
    fr = assert_matches_host(rcw, pcw, rno, 6, [0x10000] * n)
    assert not any(fr.integer_exact_levels)
    weight = [0x10000] * n
    weight[0] = weight[3] = weight[8] = 0
    weight[5] = 0x7000
    assert_matches_host(rcw, pcw, rno, 6, weight, fr=fr)


@pytest.mark.parametrize("mode", ["firstn", "indep"])
def test_chained_choose(mode):
    """take; choose <mode> 2 type host; choose <mode> 2 type 0; emit."""
    F, I, E, T = (jc.CRUSH_RULE_CHOOSE_FIRSTN, jc.CRUSH_RULE_CHOOSE_INDEP,
                  jc.CRUSH_RULE_EMIT, jc.CRUSH_RULE_TAKE)
    op = F if mode == "firstn" else I
    st = [(T, -1, 0), (op, 2, 1), (op, 2, 0), (E, 0, 0)]
    rcw, n = test_crush_device.build_map(n_hosts=6, osds_per_host=4,
                                         uneven=True)
    pcw, _ = build_map(tc, n_hosts=6, osds_per_host=4, uneven=True)
    rno = rule_of(jc, rcw, st, "c")
    assert rule_of(tc, pcw, st, "c") == rno
    rng = np.random.default_rng(3)
    fr = port_rule(pcw, rno, 4)
    assert fr.parents == 2
    for weight in ([0x10000] * n,
                   [int(w) for w in rng.choice([0, 0x4000, 0x8000, 0x10000],
                                               size=n)]):
        assert_matches_host(rcw, pcw, rno, 4, weight, fr=fr)
    # result_max 3: the straddling parent's block is truncated (room)
    assert_matches_host(rcw, pcw, rno, 3, [0x10000] * n, n_x=200)


def test_chained_chooseleaf_three_levels():
    F, CF, E, T = (jc.CRUSH_RULE_CHOOSE_FIRSTN,
                   jc.CRUSH_RULE_CHOOSELEAF_FIRSTN, jc.CRUSH_RULE_EMIT,
                   jc.CRUSH_RULE_TAKE)
    st = [(T, -1, 0), (F, 2, 2), (CF, 2, 1), (E, 0, 0)]
    (rcw, n), (pcw, _) = three_level_map(jc), three_level_map(tc)
    rno = rule_of(jc, rcw, st, "c")
    rule_of(tc, pcw, st, "c")
    weight = [0x10000] * n
    weight[4] = 0
    weight[11] = 0x6000
    assert_matches_host(rcw, pcw, rno, 4, weight)


def test_choose_args_three_positions():
    """firstn with a 3-position weight set: candidates carry a P axis and
    each lane gathers at its dynamic outpos; ids replace hash ids."""
    maps = []
    for pkg, (cw, n) in ((jc, test_crush_device.build_map(6, 3)),
                         (tc, build_map(tc, 6, 3))):
        rno = cw.add_simple_rule("data", "default", "host", mode="firstn")
        args = cw.choose_args_create(0)
        rng = np.random.default_rng(4)
        for bi, b in enumerate(cw.crush.buckets):
            args[bi].weight_set = [
                pkg.WeightSet(weights=[int(v) for v in rng.integers(
                    0x4000, 0x30000, size=b.size)]) for _ in range(3)]
        args[3].ids = [1000 + i for i in range(cw.crush.buckets[3].size)]
        maps.append((cw, rno, n))
    (rcw, rno, n), (pcw, _, _) = maps
    fr = port_rule(pcw, rno, 3, pcw.choose_args_get(0))
    assert fr.posP == 3 and not any(fr.integer_exact_levels)
    cand, leaf, *_ = (fr.prepare_candidates(np.arange(N_X)) or fr._cand)
    assert cand.shape[1] == 3 and leaf.shape[2] == 3
    weight = [0x10000] * n
    weight[2] = 0
    assert_matches_host(rcw, pcw, rno, 3, weight, choose_args_index=0,
                        fr=fr)


def _tie_maps(pathological):
    out = []
    for pkg in (jc, tc):
        cw = pkg.CrushWrapper()
        cw.set_type_name(1, "host")
        cw.set_type_name(10, "root")
        hosts, osd = [], 0
        if pathological:
            ext = [0x1, 0x2, 0x7fffffff, 0x7ffffffe, 0x10000, 0x10001,
                   0xffff, 0x40000000, 0x3, 0x20000000]
            for h in range(6):
                ws = [ext[(h * 4 + i) % len(ext)] for i in range(4)]
                hosts.append(cw.add_bucket(pkg.CRUSH_BUCKET_STRAW2, 1,
                                           f"h{h}", list(range(osd, osd + 4)),
                                           ws, id=-(h + 2)))
                osd += 4
            hws = [0x1, 0x7fffffff, 0x10000, 0x2, 0x40000000, 0x7ffffffe]
        else:
            for h in range(12):
                hosts.append(cw.add_bucket(
                    pkg.CRUSH_BUCKET_STRAW2, 1, f"h{h}", [osd, osd + 1],
                    [0x7fffffff - h, 0x7ffffffe - h], id=-(h + 2)))
                osd += 2
            hws = [0x7fffffff - h for h in range(12)]
        cw.set_max_devices(osd)
        cw.add_bucket(pkg.CRUSH_BUCKET_STRAW2, 10, "default", hosts, hws,
                      id=-1)
        cw.add_simple_rule("data", "default", "host", mode="firstn")
        out.append((cw, osd))
    return out


@pytest.mark.parametrize("pathological", [False, True],
                         ids=["near_tie_storm", "dynamic_range"])
def test_ties_draw_exactly(pathological):
    """Huge, nearly equal weights tie constantly after the s64 divide and
    the reference breaks ties by index: the first strict minimum must win
    on the first draw, with no replay at all."""
    (rcw, n), (pcw, _) = _tie_maps(pathological)
    fr = assert_matches_host(rcw, pcw, 0, 3, [0x10000] * n, n_x=500)
    assert not any(fr.integer_exact_levels)
    if not pathological:
        assert fr.residual_fraction == 0.0


def test_zero_weight_bucket_and_mixed_levels():
    """A host whose items all weigh 0 draws 2^62 everywhere and still
    returns its item 0 (then is_out rejects it); its level has no integer
    table while the root level keeps one."""
    maps = []
    for pkg in (jc, tc):
        cw = pkg.CrushWrapper()
        cw.set_type_name(1, "host")
        cw.set_type_name(10, "root")
        hosts = []
        for h in range(5):
            ws = [0] * 3 if h == 2 else [0x10000] * 3
            hosts.append(cw.add_bucket(pkg.CRUSH_BUCKET_STRAW2, 1, f"h{h}",
                                       list(range(3 * h, 3 * h + 3)), ws,
                                       id=-(h + 2)))
        cw.set_max_devices(15)
        cw.add_bucket(pkg.CRUSH_BUCKET_STRAW2, 10, "default", hosts,
                      [0x30000] * 5, id=-1)
        cw.add_simple_rule("data", "default", "host", mode="firstn")
        cw.add_simple_rule("ec", "default", "host", mode="indep")
        maps.append(cw)
    rcw, pcw = maps
    for rno in (0, 1):
        fr = assert_matches_host(rcw, pcw, rno, 3, [0x10000] * 15)
        assert fr.integer_exact_levels == [True, False]
        assert (fr.tables.qtables.shape[0], fr.tables.qtables.shape[1]) \
            == (1, 0x10000)


def test_corpus_map_rules_have_no_integer_levels():
    rcw = build_corpus_map(jc)
    pcw = build_corpus_map(tc)
    weight = [0x10000] * 20
    weight[3] = 0
    weight[11] = 0x8000
    for rno, rmax in ((0, 3), (1, 5)):
        fr = assert_matches_host(rcw, pcw, rno, rmax, weight)
        assert fr.integer_exact_levels == [True, False]


def test_heavy_reweight_and_flat_indep():
    rcw, n = test_crush_device.build_map(n_hosts=5, osds_per_host=3)
    pcw, _ = build_map(tc, n_hosts=5, osds_per_host=3)
    rno = rcw.add_simple_rule("data", "default", "host", mode="firstn")
    pcw.add_simple_rule("data", "default", "host", mode="firstn")
    rng = np.random.default_rng(0)
    weight = [int(w) for w in rng.choice([0, 0x2000, 0x8000, 0x10000],
                                         size=n)]
    fr = assert_matches_host(rcw, pcw, rno, 3, weight)
    assert fr.residual_fraction > 0      # K7b flagged x, K6 finished them
    st = [(jc.CRUSH_RULE_TAKE, -1, 0), (jc.CRUSH_RULE_CHOOSE_INDEP, 0, 0),
          (jc.CRUSH_RULE_EMIT, 0, 0)]
    rno = rule_of(jc, rcw, st, "flat", 3, 20)
    rule_of(tc, pcw, st, "flat", 3, 20)
    assert_matches_host(rcw, pcw, rno, 4, weight)


@pytest.mark.parametrize("cap", [0, 1])
@pytest.mark.parametrize("mode", ["firstn", "indep"])
def test_capped_rounds_finish_on_k6(mode, cap, monkeypatch):
    """Round caps of 0 or 1 leave many x flagged; K6 (its plain version
    here) finishes them on the rule's device.  ``map_batch`` equals the
    JAX ``FastRule`` with the same caps (which replays them on the host)
    and the JAX host ``crush_do_rule`` over delta epochs, while the port's
    host interpreter is never called."""
    rcw, n = test_crush_device.build_map(n_hosts=6, osds_per_host=4,
                                         uneven=True)
    pcw, _ = build_map(tc, n_hosts=6, osds_per_host=4, uneven=True)
    rno = rcw.add_simple_rule("d", "default", "host", mode=mode)
    pcw.add_simple_rule("d", "default", "host", mode=mode)
    jfr = jax_compile(rcw.crush, rno, 3, tries_cap=cap, leaf_tries_cap=cap)
    fr = port_rule(pcw, rno, 3, tries_cap=cap, leaf_tries_cap=cap)

    def host_replay(*a, **k):
        raise AssertionError("crush_do_rule ran on the host")
    monkeypatch.setattr(tc.mapper, "crush_do_rule", host_replay)
    xs = np.arange(N_X, dtype=np.uint32)
    rng = np.random.default_rng(11)
    w = np.full(n, 0x10000, np.uint32)
    one_out = w.copy()
    one_out[5] = 0
    mix = rng.choice([0, 0x4000, 0x10000], size=n).astype(np.uint32)
    for weight in (w, one_out, mix, one_out):
        res, cnt = fr.map_batch(xs, weight)
        jres, jcnt = jfr.map_batch(xs, weight)
        np.testing.assert_array_equal(cnt, np.asarray(jcnt))
        np.testing.assert_array_equal(res, np.asarray(jres))
        assert fr.residual_fraction > 0 and fr.host_replayed == 0
        wl = [int(v) for v in weight]
        for x in range(0, N_X, 4):
            assert [int(v) for v in res[x, :cnt[x]]] == \
                rcw.do_rule(rno, x, 3, wl), x


def test_numrep_zero_expands():
    F, E, T = (jc.CRUSH_RULE_CHOOSE_FIRSTN, jc.CRUSH_RULE_EMIT,
               jc.CRUSH_RULE_TAKE)
    st = [(T, -1, 0), (F, 0, 1), (F, 1, 0), (E, 0, 0)]
    rcw, n = test_crush_device.build_map(n_hosts=5, osds_per_host=3)
    pcw, _ = build_map(tc, n_hosts=5, osds_per_host=3)
    rno = rule_of(jc, rcw, st, "c")
    rule_of(tc, pcw, st, "c")
    weight = [0x10000] * n
    weight[1] = 0
    assert_matches_host(rcw, pcw, rno, 3, weight)


@pytest.mark.parametrize("mode", ["firstn", "indep"])
def test_delta_epochs_stay_exact(mode):
    """Every epoch of the delta path equals the host interpreter: weights
    flap, residual rows come and go, and a cap of 8 forces the overflow
    to a full fetch."""
    rcw, n = test_crush_device.build_map(n_hosts=6, osds_per_host=4,
                                         uneven=True)
    pcw, _ = build_map(tc, n_hosts=6, osds_per_host=4, uneven=True)
    rno = rcw.add_simple_rule("data", "default", "host", mode=mode)
    pcw.add_simple_rule("data", "default", "host", mode=mode)
    fr = port_rule(pcw, rno, 3)
    fr.delta_cap = 8
    xs = np.arange(N_X, dtype=np.uint32)
    rng = np.random.default_rng(42)
    weight = np.full(n, 0x10000, dtype=np.uint32)
    descents = []
    for epoch in range(8):
        if epoch:
            if epoch % 3 == 0:
                weight = rng.choice([0, 0x2000, 0x8000, 0x10000],
                                    size=n).astype(np.uint32)
            else:
                weight = weight.copy()
                weight[(5 * epoch) % n] ^= 0x10000
        res, cnt = fr.map_batch(xs, weight)
        descents.append(id(fr._cand[0]))
        wl = [int(w) for w in weight]
        for x in range(0, N_X, 3):
            want = rcw.do_rule(rno, int(x), 3, wl)
            assert [int(v) for v in res[x, :cnt[x]]] == want, (epoch, x)
    assert len(set(descents)) == 1           # candidates were cached
    assert fr.delta_cap > 8                  # the overflow grew the cap


def test_delta_buffer_layout():
    """K7c against numpy: [n_changed, n_flagged, idx[cap], rows]; a row
    whose count alone moved counts as changed."""
    cw, n = build_map(tc, n_hosts=6, osds_per_host=4)
    fr = port_rule(cw, cw.add_simple_rule("d", "default", "host",
                                          mode="firstn"), 3)
    rng = np.random.default_rng(8)
    prev = torch.from_numpy(rng.integers(0, 5, (50, 4), dtype=np.int32))
    new = prev.clone()
    new[[3, 17, 40], 1] += 1
    new[9, 3] += 1                    # the count moved
    prev[22, 3] += 1                  # ... either way
    flagged = torch.tensor([7], dtype=torch.int32)
    flat = fr._delta(new, prev, 8, flagged).numpy()
    changed = [3, 9, 17, 22, 40]
    assert flat[0] == 5 and flat[1] == 7
    np.testing.assert_array_equal(flat[2:7], changed)
    np.testing.assert_array_equal(flat[7:10], 0)
    rows = flat[10:].reshape(8, 4)
    np.testing.assert_array_equal(rows[:5], new.numpy()[changed])
    small = fr._delta(new, prev, 2, flagged).numpy()
    assert small[0] == 5 and list(small[2:4]) == [3, 9]


# ---- scope ---------------------------------------------------------------------

def test_out_of_scope_rules_raise_before_any_launch():
    F, CF, E, T = (tc.CRUSH_RULE_CHOOSE_FIRSTN,
                   tc.CRUSH_RULE_CHOOSELEAF_FIRSTN, tc.CRUSH_RULE_EMIT,
                   tc.CRUSH_RULE_TAKE)
    cw, n = build_map(tc, n_hosts=5, osds_per_host=3)
    before = (crush_fast.descend_launches.n, crush_fast.resolve_launches.n)
    bad = [
        [(T, -1, 0), (F, 2, 10), (F, 1, 1), (F, 1, 0), (E, 0, 0)],
        [(T, -1, 0), (CF, 1, 1), (F, 1, 0), (E, 0, 0)],
        [(T, -1, 0), (F, 40, 0), (E, 0, 0)],
        [(tc.CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES, 2, 0), (T, -1, 0),
         (F, 1, 0), (E, 0, 0)],
        [(T, 0, 0), (E, 0, 0)],
    ]
    for i, st in enumerate(bad):
        rno = rule_of(tc, cw, st, f"bad{i}", max_size=50)
        with pytest.raises(UnsupportedRule):
            port_rule(cw, rno, 50)
    rno = cw.add_simple_rule("leaf", "default", "host", mode="firstn")
    cw.set_tunables_profile("firefly")          # chooseleaf_stable = 0
    with pytest.raises(UnsupportedRule):
        port_rule(cw, rno, 3)
    cw.set_tunables_profile("argonaut")          # local tries
    with pytest.raises(ValueError):
        port_rule(cw, rno, 3)
    straw = tc.CrushWrapper()
    straw.set_type_name(10, "root")
    straw.set_max_devices(4)
    straw.add_bucket(tc.CRUSH_BUCKET_STRAW, 10, "default", [0, 1, 2, 3],
                     [0x10000] * 4, id=-1)
    srno = straw.add_simple_rule("d", "default", "osd", mode="firstn")
    with pytest.raises(ValueError):
        port_rule(straw, srno, 3)
    assert (crush_fast.descend_launches.n,
            crush_fast.resolve_launches.n) == before


# ---- the kernels' loops, transcribed ------------------------------------------

def _h3(a, b, c):
    return tc.hash.crush_hash32_3(a & M32, b & M32, c & M32)


# csrc/crush_common.cuh's rjenkins hash with line j of each mix taking its
# subtraction as two multiply-adds by 0xFFFFFFFF when bit j of ``sub`` is
# set: 0 is hash32_3, K7A_SPLIT hash32_3_split (K7a's draw); on numpy
# uint64 arrays of u32 values or on Python ints
K7A_SPLIT = 0x7F
_SEED, _NEG1 = 1315423911, 0xFFFFFFFF


def hash_form(a, b, c, sub):
    def sub2(bit, a, b, c):
        if (sub >> bit) & 1:
            return (c * _NEG1 + ((b * _NEG1 + a) & M32)) & M32
        return (a - b - c) & M32

    def mix(a, b, c):
        a = sub2(0, a, b, c) ^ (c >> 13)
        b = sub2(1, b, c, a) ^ ((a << 8) & M32)
        c = sub2(2, c, a, b) ^ (b >> 13)
        a = sub2(3, a, b, c) ^ (c >> 12)
        b = sub2(4, b, c, a) ^ ((a << 16) & M32)
        c = sub2(5, c, a, b) ^ (b >> 5)
        a = sub2(6, a, b, c) ^ (c >> 3)
        b = sub2(7, b, c, a) ^ ((a << 10) & M32)
        c = sub2(8, c, a, b) ^ (b >> 15)
        return a, b, c
    one = a ^ a               # 0 of a's type, so the pads take it
    h = a ^ b ^ c ^ (one + _SEED)
    x, y = one + 231232, one + 1232
    a, b, h = mix(a, b, h)
    c, x, h = mix(c, x, h)
    y, a, h = mix(y, a, h)
    b, x, h = mix(b, x, h)
    y, c, h = mix(y, c, h)
    return h


def _descend_scheme(xl, roots, tabs, spec):
    """crush_descend_kernel, one thread (lane, r, p) at a time: the
    candidate's levels, then its leaf attempts, each draw over the
    bucket's items with K7a's hash form, the i32 table on an integer
    level and elsewhere each item's int64 table or the multiply-high of
    its weight."""
    cm = tabs.cm
    items, ids = cm.items.numpy(), cm.hash_ids.numpy()
    sizes = cm.sizes.numpy()
    qidx, qt = tabs.qidx.numpy(), tabs.qtables.numpy()
    magic = tabs.magic.numpy().view(np.uint64)
    g15 = tabs.g15.numpy().view(np.uint64)
    q64 = tabs.q64 is not None
    qitem = tabs.qitem.numpy() if q64 else None
    qtab = tabs.q64.numpy() if q64 else None
    N, R, P, L = len(xl), spec.R, spec.P, spec.L

    def draw(b, x, r, p, table):
        size = int(sizes[b])
        hid = (ids[b, :size].astype(np.int64) & M32).astype(np.uint64)
        u = hash_form(np.uint64(x), hid, np.uint64(r), K7A_SPLIT) \
            & np.uint64(0xFFFF)
        win, best = 0, 0
        for k in range(size):
            if table >= 0:
                v = int(qt[table, int(u[k])])
            elif q64:
                tq = int(qitem[p, b, k])
                v = int(qtab[tq, int(u[k])]) if tq >= 0 else 1 << 62
            else:
                w = int(magic[p, b, k])
                v = 1 << 62
                if w >> 32:
                    m, t = w & ((1 << 58) - 1), w >> 58
                    v = ((int(g15[int(u[k])]) * m) >> 64) >> t
            if k == 0 or v < best:
                best, win = v, k
        return int(items[b, win])

    def path(b, x, r, p, depth, mask):
        item = 0
        for d in range(depth):
            item = draw(b, x, r, p, int(qidx[b]) if (mask >> d) & 1 else -1)
            b = max(-1 - item, 0)
        return item

    mask = tabs.mask(spec.base_level, spec.depth)
    leaf_mask = tabs.mask(spec.base_level + spec.depth, spec.leaf_depth)
    cand = np.empty((R, P, N), np.int32)
    leaf = np.empty((R, L, P, N), np.int32) if L else None
    for y in range(R * P):                    # blockIdx.y
        r, pi = divmod(y, P)
        for lane in range(N):
            x = int(xl[lane]) & M32
            item = path(int(roots[lane]), x, r, min(pi, cm.npos - 1),
                        spec.depth, mask)
            cand[r, pi, lane] = item
            if not L:
                continue
            if spec.leaf_firstn:
                sub_r = r >> (spec.vary_r - 1) if spec.vary_r else 0
                lpos, step = pi, 1
            else:
                lpos = r % spec.numrep
                sub_r, step = lpos + r, spec.numrep
            lpos = min(lpos, cm.npos - 1)
            for f2 in range(L):
                leaf[r, f2, pi, lane] = path(
                    max(-1 - item, 0), x, sub_r + step * f2, lpos,
                    spec.leaf_depth, leaf_mask) if spec.leaf_depth else item
    return cand, leaf


def _is_out_scheme(weight, item, x):
    if item >= len(weight):
        return True
    w = int(weight[max(item, 0)])
    if w >= 0x10000:
        return False
    if w == 0:
        return True
    return (tc.hash.crush_hash32_2(x, item & M32) & 0xFFFF) >= w


def _firstn_scheme(a, cand, leaf, lane, x, weight, residual, evals=None):
    nr = a.numrep
    outs, leaves = [NONE] * nr, [NONE] * nr
    for j in range(nr):
        pos = 0
        if a.P > 1:
            pos = min(sum(o != NONE for o in outs), a.P - 1)
        done = False
        for ft in range(a.n_rounds):
            if done:
                break
            if evals is not None:
                evals[lane] += 1
            r = j + ft
            item = int(cand[r, pos, lane])
            coll = item in outs
            maybe_more, lsel = False, item
            if a.leafy:
                lok, lsel = False, NONE
                for f2 in range(a.n_leaf):
                    lf = int(leaf[r, f2, pos, lane])
                    if not lok and lf not in leaves and \
                            not _is_out_scheme(weight, lf, x):
                        lsel, lok = lf, True
                maybe_more = a.n_leaf < a.recurse_tries and not lok
                ok = not coll and lok
            else:
                ok = not coll and not (a.check_out and
                                       _is_out_scheme(weight, item, x))
            if ok and not done and not (a.gate and residual):
                outs[j], leaves[j] = item, lsel
            if maybe_more and not done:
                residual = True
            done = done or ok
        if a.n_rounds < a.tries and not done:
            residual = True
    return (leaves if a.leafy else outs), residual


def _indep_scheme(a, cand, leaf, lane, x, weight, residual, room,
                  evals=None):
    nr = a.numrep
    outs, leaves = [UNDEF] * nr, [UNDEF] * nr
    for ft in range(a.n_rounds):
        for rep in range(nr):
            if outs[rep] != UNDEF or rep >= room:
                continue
            if evals is not None:
                evals[lane] += 1
            r = rep + nr * ft
            item = int(cand[r, 0, lane])
            coll = item in outs
            lsel = item
            if a.leafy:
                lok, lsel = False, NONE
                for f2 in range(a.n_leaf):
                    lf = int(leaf[r, f2, 0, lane])
                    if not lok and not _is_out_scheme(weight, lf, x):
                        lsel, lok = lf, True
                if a.n_leaf < a.recurse_tries and not coll and not lok:
                    residual = True
                ok = not coll and lok
            else:
                ok = not coll and not (a.check_out and
                                       _is_out_scheme(weight, item, x))
            if ok:
                outs[rep], leaves[rep] = item, lsel
    if a.n_rounds < a.tries and any(outs[k] == UNDEF and k < room
                                    for k in range(nr)):
        residual = True
    sel = leaves if a.leafy else outs
    return [NONE if v == UNDEF else v for v in sel], residual


def _resolve_scheme(a, cand, leaf, lane_x, valid, risk0, weight, parents,
                    width, mode, evals=None):
    """crush_resolve_kernel, one thread (x, or lane in mode 1) at a time;
    ``evals[lane]`` (mode 0) gains the (slot, round) pairs it evaluates."""
    cand = cand.numpy()
    leaf = leaf.numpy() if leaf is not None else None
    weight = weight.numpy().view(np.uint32)
    xs = lane_x.numpy().view(np.uint32)
    valid, risk0 = valid.numpy(), risk0.numpy()
    N = len(xs)
    if mode == 1:
        out = np.full((N, width), NONE, np.int32)
        risky = np.zeros(N, bool)
        for t in range(N):
            x = int(xs[t])
            if a.firstn:
                sel, rk = _firstn_scheme(a, cand, leaf, t, x, weight, False)
                picks = [v for v in sel if v != NONE][:width]
            else:
                sel, rk = _indep_scheme(a, cand, leaf, t, x, weight, False,
                                        width)
                picks = sel[:width]
            out[t, :len(picks)] = picks if valid[t] else NONE
            risky[t] = rk
        return out, risky
    X = N // parents
    out = np.full((X, width + 1), NONE, np.int32)
    for t in range(X):
        c = total = n_valid = 0
        residual = False
        for q in range(parents):
            lane = t * parents + q
            x, v, r0 = int(xs[lane]), bool(valid[lane]), bool(risk0[lane])
            if a.firstn:
                sel, lres = _firstn_scheme(a, cand, leaf, lane, x, weight,
                                           r0, evals)
            else:
                room = min(max(width - n_valid * a.numrep, 0), a.numrep)
                sel, lres = _indep_scheme(a, cand, leaf, lane, x, weight,
                                          r0, room, evals)
            residual |= r0 or (v and lres)
            if not v:
                continue
            n_valid += 1
            for s in sel:
                if a.firstn and s == NONE:
                    continue
                total += 1
                if c < width:
                    out[t, c] = s
                    c += 1
        count = min(total if a.firstn else n_valid * a.numrep, width)
        out[t, width] = count | (int(residual) << 16)
    return out


def _scheme_cases():
    """Small rules whose every K7a / K7b launch the schemes replay."""
    F, I, CF, E, T = (tc.CRUSH_RULE_CHOOSE_FIRSTN,
                      tc.CRUSH_RULE_CHOOSE_INDEP,
                      tc.CRUSH_RULE_CHOOSELEAF_FIRSTN, tc.CRUSH_RULE_EMIT,
                      tc.CRUSH_RULE_TAKE)
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
def test_kernel_schemes_match_plain(case, monkeypatch):
    """Every launch a rule makes, replayed by the schemes of the kernels'
    loops, equals the plain version's result, and so does the packed
    result of every weight vector.  The plain version's count of the
    (slot, round) pairs the resolve evaluates (its byte bound) equals the
    scheme's."""
    _, cw, n, rno, rmax, args = case
    calls = []
    descend_plain = crush_fast.crush_descend_plain
    resolve_plain = crush_fast.crush_resolve_plain

    def descend(xl, roots, tabs, spec):
        want = descend_plain(xl, roots, tabs, spec)
        got = _descend_scheme(xl.numpy(), roots.numpy(), tabs, spec)
        np.testing.assert_array_equal(got[0], want[0].numpy())
        assert (got[1] is None) == (want[1] is None)
        if want[1] is not None:
            np.testing.assert_array_equal(got[1], want[1].numpy())
        calls.append("descend")
        return want

    def resolve(spec, cand, leaf, lane_x, valid, risk0, weight, parents,
                width, mode):
        reads = torch.zeros(lane_x.shape[0], dtype=torch.int64)
        want = resolve_plain(spec, cand, leaf, lane_x, valid, risk0,
                             weight, parents, width, mode, reads=reads)
        evals = np.zeros(lane_x.shape[0], np.int64)
        got = _resolve_scheme(spec, cand, leaf, lane_x, valid, risk0,
                              weight, parents, width, mode, evals)
        if mode == 0:
            np.testing.assert_array_equal(evals, reads.numpy())
        if mode == 1:
            np.testing.assert_array_equal(got[0], want[0].numpy())
            np.testing.assert_array_equal(got[1], want[1].numpy())
        else:
            np.testing.assert_array_equal(got, want.numpy())
        calls.append(f"resolve{mode}")
        return want
    monkeypatch.setattr(crush_fast, "crush_descend_plain", descend)
    monkeypatch.setattr(crush_fast, "crush_resolve_plain", resolve)
    fr = compile_fast_rule(cw.crush, rno, rmax, args, device="cpu",
                           plain=True)
    xs = np.arange(48, dtype=np.uint32) * np.uint32(2654435761)  # >= 2^31
    rng = np.random.default_rng(7)
    for w in (np.full(n, 0x10000, np.uint32),
              rng.choice([0, 0x3000, 0x10000], size=n).astype(np.uint32)):
        res, cnt = fr.map_batch(xs, w)
        wl = [int(v) for v in w]
        for i, x in enumerate(xs):
            want = tc.crush_do_rule(cw.crush, rno, int(x), rmax, wl, args)
            assert [int(v) for v in res[i, :cnt[i]]] == want
    assert "descend" in calls and "resolve0" in calls
    if case[0].startswith("chained"):
        assert "resolve1" in calls


def test_wrappers_take_plain_only_on_cpu(monkeypatch):
    """On CPU tensors the wrappers are the plain versions and count no
    launch."""
    cw, n = build_map(tc, n_hosts=4, osds_per_host=3)
    rno = cw.add_simple_rule("d", "default", "host", mode="indep")
    fr = port_rule(cw, rno, 3)
    before = (crush_fast.descend_launches.n, crush_fast.resolve_launches.n,
              crush_kernels.rule_launches.n)
    fr.map_batch(np.arange(64), np.full(n, 0x10000, np.uint32))
    assert (crush_fast.descend_launches.n, crush_fast.resolve_launches.n,
            crush_kernels.rule_launches.n) == before
    spec = ResolveSpec(numrep=2, n_rounds=2, tries=3, firstn=True)
    with pytest.raises(ValueError):
        crush_fast.crush_resolve(spec, torch.zeros((3, 2, 4), dtype=torch.int32),
                                 None, torch.zeros(4, dtype=torch.int32),
                                 torch.ones(4, dtype=torch.bool),
                                 torch.zeros(4, dtype=torch.bool),
                                 torch.zeros(1, dtype=torch.int32), 1, 2)
    with pytest.raises(ValueError):
        crush_fast.crush_descend(torch.zeros(4, dtype=torch.int64),
                                 torch.zeros(4, dtype=torch.int32),
                                 fr.tables, fr.descent_spec())
