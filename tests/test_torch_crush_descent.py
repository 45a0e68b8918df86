"""K7a as redesigned for Hopper, on the CPU: its arithmetic and its plain
version against the JAX package and the reference's own formulas, exactly.

- The split hash (``csrc/crush_common.cuh`` ``hash32_3_split``: 7 of
  each mix's 9 subtractions as multiply-adds by 0xFFFFFFFF) in its exact
  mod-2^32 Python form (``test_torch_crush_fast.hash_form``), and
  ``hash32_3`` in the same form, against ``crush_hash32_3`` on 10^5 seeded
  triples and on the draws' own inputs.  The split's lines are read from
  the CUDA source, so the Python form follows it.
- The per-item int64 quotient tables up to ``Q64_MAX_TABLES`` distinct
  weights, and None past them.
- The multiply-high that replaced the s64 divide: ``straw2_magic`` and the
  kernel's product (the high word of (G << 15) * m in 32-bit limbs, then
  >> t), against Python's ``//`` on all 65536 G values and on G up to
  2^49 - 1, for every weight of the maps below and for edge weights;
  ``straw2_quotient`` on a sample.
- ``_descend_scheme`` (the kernel, one thread at a time) against
  ``crush_descend_plain`` on every K7a launch of a candidate phase, and the
  port's candidate and leaf tables against the JAX ``FastRule._candidates``
  (XLA on the CPU; exact64 draws under ``enable_x64``, which its
  ``prepare_candidates`` opens), on chained firstn / indep / chooseleaf
  rules, choose_args with 3 positions, a zero-weight host, a map with no
  quotient-table level, and (n)-style mixed weights with weights below
  0x10000.

Tolerance: exact equality.
"""
import re
from pathlib import Path

import numpy as np
import pytest

import ceph_tpu.crush as jc
import ceph_tpu_torch.crush as tc
from ceph_tpu.ops.crush_fast import compile_fast_rule as jax_compile
from ceph_tpu_torch.ops import crush_fast
from ceph_tpu_torch.ops.crush_fast import (
    MAGIC_SHIFT, Q64_MAX_TABLES, compile_fast_rule, item_quotient_tables,
    straw2_magic, straw2_quotient)
from ceph_tpu_torch.ops.crush_kernels import G_EXACT

from test_torch_crush_fast import K7A_SPLIT, _descend_scheme, hash_form
from test_torch_crush_host import rule_of

CSRC = Path(crush_fast.__file__).resolve().parent.parent / "csrc"
M32 = 0xFFFFFFFF
N_X = 64


# ---- the split hash ------------------------------------------------------------

# the probe's two forms (its kernel's SPLIT argument): hash32_3, K7a's split
FORMS = {"hash32_3": 0, "hash32_3_split": K7A_SPLIT}


def _split_lines():
    """The subtraction mask of hash32_3_split as crush_common.cuh writes
    it: bit j set where line j of mix_split subtracts by sub_fma."""
    src = (CSRC / "crush_common.cuh").read_text()
    body = src[src.index("void mix_split("):]
    body = body[:body.index("}")]
    lines = re.findall(r"^\s+([abc]) = (sub_fma\(|\()", body, re.M)
    assert len(lines) == 9
    return sum(1 << j for j, (_, op) in enumerate(lines) if op == "sub_fma(")


def test_split_is_read_from_the_sources():
    assert _split_lines() == K7A_SPLIT
    draw = (CSRC / "crush_fast.cu").read_text()
    draw = draw[draw.index("int descend_draw("):]
    draw = draw[:draw.index("\n}\n")]
    assert draw.count("hash32_3_split(") == 3 and "hash32_3(" not in draw
    probe = (CSRC / "crush_probe.cu").read_text()
    assert "SPLIT ? hash32_3_split(" in probe


@pytest.mark.parametrize("form", FORMS)
def test_split_hash_matches_crush_hash32_3(form):
    rng = np.random.default_rng(1100 + FORMS[form])
    a, b, c = (rng.integers(0, 1 << 32, 100000, dtype=np.uint64)
               for _ in range(3))
    a[:4] = [0, M32, 0, M32]          # the corners of the u32 range
    b[:4] = [0, M32, M32, 0]
    got = hash_form(a, b, c, FORMS[form])
    want = np.array([tc.hash.crush_hash32_3(int(x), int(y), int(z))
                     for x, y, z in zip(a, b, c)], dtype=np.uint64)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("form", FORMS)
def test_split_hash_on_draw_inputs(form):
    """The hash as K7a's draws feed it: x over the u32 range, item and
    bucket ids (negative, as u32) and small r."""
    rng = np.random.default_rng(1200 + FORMS[form])
    x = rng.integers(0, 1 << 32, 20000, dtype=np.uint64)
    ids = (rng.integers(-1000, 1000, 20000) & M32).astype(np.uint64)
    r = rng.integers(0, 64, 20000).astype(np.uint64)
    got = hash_form(x, ids, r, FORMS[form])
    want = np.array([tc.hash.crush_hash32_3(int(a), int(b), int(c))
                     for a, b, c in zip(x, ids, r)], dtype=np.uint64)
    np.testing.assert_array_equal(got, want)


# ---- the multiply-high -------------------------------------------------------------

def _umulhi64(a, b):
    """High 64 bits of the 128-bit product of uint64 arrays, in 32-bit
    limbs (what __umul64hi computes)."""
    lo32 = np.uint64(M32)
    s32 = np.uint64(32)
    a0, a1 = a & lo32, a >> s32
    b0, b1 = b & lo32, b >> s32
    p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = (p00 >> s32) + (p01 & lo32) + (p10 & lo32)
    return p11 + (p01 >> s32) + (p10 >> s32) + (mid >> s32)


def _kernel_quotient(g, word):
    """straw2_quotient of csrc/crush_fast.cu on uint64 arrays."""
    m = word & np.uint64((1 << MAGIC_SHIFT) - 1)
    t = word >> np.uint64(MAGIC_SHIFT)
    return _umulhi64(g << np.uint64(15), m) >> t


EDGE_WEIGHTS = sorted({1, 2, 3, 0x7FFF, 0x8000, 0xFFFF, 0x10000, 0x10001,
                       2**31 - 1, 2**31, 0xFFFFFFFF}
                      | {v for k in range(1, 33) for v in (2**k - 1, 2**k + 1)
                         if 1 <= v <= M32})


def _case_weights():
    ws = set()
    for _, build in CASES:
        (_, _, _), (pcw, _, _) = build()
        for b in pcw.crush.buckets:
            if b is not None:
                ws.update(int(v) for v in b.item_weights)
        for arg in (pcw.choose_args_get(0) or []) if pcw.crush.choose_args \
                else []:
            for s in (arg.weight_set or []) if arg is not None else []:
                ws.update(int(v) for v in s.weights)
    ws.discard(0)
    return sorted(ws)


def test_magic_matches_floor_division():
    weights = sorted(set(EDGE_WEIGHTS) | set(_case_weights()))
    assert 0x1234 in weights and 0x7FFF in weights and len(weights) > 70
    g = np.concatenate([G_EXACT, [0, 1, 2**48, 2**49 - 2, 2**49 - 1]]
                       ).astype(np.uint64)
    words = straw2_magic(np.array(weights, dtype=np.uint32))
    for w, word in zip(weights, words):
        assert int(word) >> 32, w           # nonzero high word: not a zero
        got = _kernel_quotient(g, np.full(g.shape, word, dtype=np.uint64))
        np.testing.assert_array_equal(got, g // np.uint64(w), err_msg=str(w))
        for gv in g[::257].tolist():
            assert straw2_quotient(int(gv), int(word)) == int(gv) // w
    assert int(straw2_magic(np.zeros(3, np.uint32))[1]) == 0


@pytest.mark.parametrize("n", [1, Q64_MAX_TABLES, Q64_MAX_TABLES + 1])
def test_item_quotient_tables_up_to_the_cut(n):
    """One int64 table floor(G / w) per distinct nonzero weight and each
    item's index into them (-1 for a zero weight), up to Q64_MAX_TABLES
    weights; past it None (K7a takes the multiply-high), unless the cut is
    lifted."""
    rng = np.random.default_rng(1300 + n)
    vals = rng.choice(np.arange(1, 1 << 20), n, replace=False)
    w = np.concatenate([vals, [0], vals[::-1]]).astype(np.uint32).reshape(
        1, 1, -1)                                       # (npos, nb, S)
    got = item_quotient_tables(w)
    if n > Q64_MAX_TABLES:
        assert got is None
        got = item_quotient_tables(w, None)
    qitem, q64 = got
    assert q64.shape == (n, 0x10000) and q64.dtype == np.int64
    assert qitem.shape == w.shape
    flat_w, flat_q = w.ravel(), qitem.ravel()
    assert (flat_q[flat_w == 0] == -1).all()
    for wv, qi in zip(flat_w[flat_w > 0], flat_q[flat_w > 0]):
        np.testing.assert_array_equal(q64[qi], G_EXACT // np.int64(wv))


# ---- the descent against its plain version and JAX _candidates ---------------------

def small_map(pkg, n_hosts, per_host, weights, root_ws=None, racks=0):
    """Hosts of ``per_host`` OSDs weighted ``weights(h, i)``, optionally
    in ``racks`` racks, under one root (chip_smoke.py's small shapes)."""
    cw = pkg.CrushWrapper()
    cw.set_type_name(1, "host")
    cw.set_type_name(2, "rack")
    cw.set_type_name(10, "root")
    hosts, hws, osd = [], [], 0
    for h in range(n_hosts):
        ws = [weights(h, i) for i in range(per_host)]
        hosts.append(cw.add_bucket(pkg.CRUSH_BUCKET_STRAW2, 1, f"h{h}",
                                   list(range(osd, osd + per_host)), ws,
                                   id=-(h + 2)))
        hws.append(sum(ws))
        osd += per_host
    top = hosts
    if racks:
        per = n_hosts // racks
        top = [cw.add_bucket(pkg.CRUSH_BUCKET_STRAW2, 2, f"rack{r}",
                             hosts[r * per:(r + 1) * per],
                             hws[r * per:(r + 1) * per], id=-(100 + r))
               for r in range(racks)]
        hws = [sum(hws[r * per:(r + 1) * per]) for r in range(racks)]
    cw.set_max_devices(osd)
    cw.add_bucket(pkg.CRUSH_BUCKET_STRAW2, 10, "default", top,
                  root_ws or [min(w, 0x7FFFFFFF) for w in hws], id=-1)
    return cw, osd


_RNG = np.random.default_rng(20261017)
_UNEVEN = [[int(v) * 0x10000 for v in _RNG.integers(1, 4, 4)]
           for _ in range(9)]
# 40 distinct OSD weights (50 with the hosts' sums), more than K7a keeps
# int64 tables for
_MIXED = [0x8000, 0x10000, 0x18000, 0x20000, 0x1234, 0xFFFF, 0x7FFF, 0x10001,
          0x3, 0x8001, 0xFFFE, 0x20001] + [0x9000 + 0x1111 * k
                                           for k in range(28)]


def _pair(build_one):
    """(JAX (cw, rno, args), port (cw, rno, args)): ``build_one`` through
    each package."""
    return build_one(jc), build_one(tc)


def _chained(op_name):
    def one(pkg):
        op = getattr(pkg, op_name)
        cw, _ = small_map(pkg, 6, 4, lambda h, i: _UNEVEN[h][i])
        rno = rule_of(pkg, cw, [(pkg.CRUSH_RULE_TAKE, -1, 0), (op, 2, 1),
                                (op, 2, 0), (pkg.CRUSH_RULE_EMIT, 0, 0)], "c")
        return cw, rno, None
    return lambda: _pair(one)


def _chained_leaf():
    def one(pkg):
        cw, _ = small_map(pkg, 9, 3, lambda h, i: _UNEVEN[h][i % 4], racks=3)
        rno = rule_of(pkg, cw, [(pkg.CRUSH_RULE_TAKE, -1, 0),
                                (pkg.CRUSH_RULE_CHOOSE_FIRSTN, 2, 2),
                                (pkg.CRUSH_RULE_CHOOSELEAF_FIRSTN, 2, 1),
                                (pkg.CRUSH_RULE_EMIT, 0, 0)], "c")
        return cw, rno, None
    return _pair(one)


def _positions():
    def one(pkg):
        cw, _ = small_map(pkg, 6, 3, lambda h, i: 0x10000)
        rno = cw.add_simple_rule("data", "default", "host", mode="firstn")
        args = cw.choose_args_create(0)
        rng = np.random.default_rng(4)
        for bi, b in enumerate(cw.crush.buckets):
            args[bi].weight_set = [pkg.WeightSet(weights=[
                int(v) for v in rng.integers(0x4000, 0x30000, b.size)])
                for _ in range(3)]
        args[3].ids = [1000 + i for i in range(cw.crush.buckets[3].size)]
        return cw, rno, args
    return _pair(one)


def _simple(mode, weights, n_hosts, per_host, root_ws=None):
    def one(pkg):
        cw, _ = small_map(pkg, n_hosts, per_host, weights, root_ws=root_ws)
        return cw, cw.add_simple_rule(mode, "default", "host", mode=mode), \
            None
    return lambda: _pair(one)


CASES = [
    ("chained_firstn", _chained("CRUSH_RULE_CHOOSE_FIRSTN")),
    ("chained_indep", _chained("CRUSH_RULE_CHOOSE_INDEP")),
    ("chained_chooseleaf_racks", _chained_leaf),
    ("choose_args_3_positions", _positions),
    ("zero_weight_host_firstn", _simple(
        "firstn", lambda h, i: 0 if h == 2 else 0x10000, 5, 3,
        [0x30000] * 5)),
    ("zero_weight_host_indep", _simple(
        "indep", lambda h, i: 0 if h == 2 else 0x10000, 5, 3,
        [0x30000] * 5)),
    ("no_quotient_levels", _simple(
        "firstn", lambda h, i: 0x7FFFFFFF - h - i, 12, 2,
        [0x7FFFFFFF - h for h in range(12)])),
    ("mixed_low_weights_firstn", _simple(
        "firstn", lambda h, i: _MIXED[(4 * h + i) % 40], 12, 4)),
    ("mixed_low_weights_indep", _simple(
        "indep", lambda h, i: _MIXED[(4 * h + i) % 40], 12, 4)),
]


@pytest.mark.parametrize("name,build", CASES, ids=[c[0] for c in CASES])
def test_descent_matches_plain_and_jax(name, build):
    (rcw, rno, rargs), (pcw, prno, pargs) = build()
    assert rno == prno
    rmax = 4 if name.startswith("chained") else 3
    xs = (np.arange(N_X, dtype=np.uint64) * 2654435761 & M32).astype(
        np.uint32)                                      # many >= 2^31
    fr = compile_fast_rule(pcw.crush, prno, rmax, pargs, device="cpu")
    calls = []
    orig = fr._descend

    def record(*a):
        calls.append(a)
        return orig(*a)
    fr._descend = record
    fr.prepare_candidates(xs)
    assert calls
    for xl, roots, tabs, spec in calls:
        want = crush_fast.crush_descend_plain(xl, roots, tabs, spec)
        got = _descend_scheme(xl.numpy(), roots.numpy(), tabs, spec)
        np.testing.assert_array_equal(got[0], want[0].numpy())
        if spec.L:
            np.testing.assert_array_equal(got[1], want[1].numpy())
    if name.startswith(("no_quotient", "mixed", "choose_args")):
        assert not any(fr.integer_exact_levels)
    # more distinct weights than K7a keeps int64 tables for: the
    # multiply-high; a few: the per-item tables
    assert (fr.tables.q64 is None) == name.startswith(("mixed",
                                                       "choose_args"))
    if name.startswith("zero_weight"):
        assert fr.integer_exact_levels == [True, False]
    jfr = jax_compile(rcw.crush, rno, rmax, rargs)
    assert jfr.integer_exact_levels == fr.integer_exact_levels
    jfr.prepare_candidates(xs)
    cand, leaf, _, valid, xl = fr._cand
    jcand, jleaf, jvalid, jxl = (np.asarray(jfr._cand[i])
                                 for i in (0, 1, 3, 4))
    R, P, N = cand.shape
    np.testing.assert_array_equal(cand.numpy().reshape(jcand.shape), jcand)
    if fr.leafy:
        np.testing.assert_array_equal(leaf.numpy().reshape(jleaf.shape),
                                      jleaf)
    np.testing.assert_array_equal(valid.numpy(), jvalid)
    np.testing.assert_array_equal(xl.numpy().view(np.uint32), jxl)
