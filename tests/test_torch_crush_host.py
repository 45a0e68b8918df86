"""The port's host CRUSH against the JAX package's, exactly.

Hashes and crush_ln (the port's scalar, numpy and torch forms) against
``ceph_tpu.crush.hash`` / ``crush.ln`` on seeded random inputs, values at
and above 2^31 included; ``crush_do_rule`` and ``CrushWrapper.do_rule`` on
every rule style of ``test_crush_device.py`` (firstn/indep, chooseleaf or
not, the tunable profiles, choose_args, uneven trees, every bucket
algorithm) and on the corpus map's two rules; the maps themselves, built
through both packages' ``CrushWrapper``; and the rules ``create_rule``
adds for isa, jerasure k=8 m=4 and lrc k4m2l3.  Tolerance: exact
equality everywhere.

``build_map`` / ``build_corpus_map`` here take the package to build with;
the other ``test_torch_*`` CRUSH files import them.
"""
import dataclasses

import numpy as np
import pytest
import torch

import ceph_tpu.crush as jc
import ceph_tpu_torch.crush as tc
from ceph_tpu.crush import hash as jhash, ln as jln
from ceph_tpu.ec import create_erasure_code as jax_create
from ceph_tpu_torch.crush import hash as thash, ln as tln
from ceph_tpu_torch.ec import create_erasure_code as port_create
from ceph_tpu_torch.ops import crush_kernels

import test_crush_device
from test_corpus import CRUSH_CORPUS
from test_corpus import build_corpus_map as jax_corpus_map

N_X = 300


def build_map(pkg, n_hosts=5, osds_per_host=4, uneven=False, seed=7):
    """``test_crush_device.build_map`` through ``pkg``'s CrushWrapper."""
    rng = np.random.default_rng(seed)
    cw = pkg.CrushWrapper()
    cw.set_type_name(1, "host")
    cw.set_type_name(10, "root")
    host_ids, host_ws = [], []
    osd = 0
    for h in range(n_hosts):
        k = osds_per_host + (int(rng.integers(-2, 3)) if uneven else 0)
        k = max(1, k)
        osds = list(range(osd, osd + k))
        osd += k
        if uneven:
            ws = [int(rng.integers(1, 4)) * 0x10000 for _ in osds]
        else:
            ws = [0x10000] * k
        hid = cw.add_bucket(pkg.CRUSH_BUCKET_STRAW2, 1, f"host{h}", osds, ws,
                            id=-(h + 2))
        host_ids.append(hid)
        host_ws.append(sum(ws))
    cw.set_max_devices(osd)
    cw.add_bucket(pkg.CRUSH_BUCKET_STRAW2, 10, "default", host_ids, host_ws,
                  id=-1)
    return cw, osd


def build_corpus_map(pkg):
    """``test_corpus.build_corpus_map`` through ``pkg``'s CrushWrapper."""
    cw = pkg.CrushWrapper()
    cw.set_type_name(1, "host")
    cw.set_type_name(10, "root")
    hosts = []
    for h in range(5):
        osds = list(range(h * 4, h * 4 + 4))
        ws = [0x10000 + 0x4000 * (i % 3) for i in osds]
        hosts.append(cw.add_bucket(pkg.CRUSH_BUCKET_STRAW2, 1, f"host{h}",
                                   osds, ws, id=-(h + 2)))
    cw.set_max_devices(20)
    cw.add_bucket(pkg.CRUSH_BUCKET_STRAW2, 10, "default", hosts,
                  [0x40000] * 5, id=-1)
    cw.add_simple_rule("data", "default", "host", mode="firstn")
    cw.add_simple_rule("ec", "default", "host", mode="indep",
                       rule_type=pkg.PG_POOL_TYPE_ERASURE)
    return cw


def three_level_map(pkg, seed=11, uniform=False):
    """3 racks of 3 hosts of 3 OSDs (``test_crush_fast``'s shapes)."""
    rng = np.random.default_rng(seed)
    cw = pkg.CrushWrapper()
    cw.set_type_name(1, "host")
    cw.set_type_name(2, "rack")
    cw.set_type_name(10, "root")
    osd, bid, racks = 0, -2, []
    for r in range(3):
        hosts = []
        for h in range(3):
            osds = list(range(osd, osd + 3))
            osd += 3
            ws = ([0x10000] * 3 if uniform else
                  [int(rng.integers(1, 4)) * 0x10000 for _ in osds])
            hosts.append(cw.add_bucket(pkg.CRUSH_BUCKET_STRAW2, 1,
                                       f"h{r}{h}", osds, ws, id=bid))
            bid -= 1
        racks.append(cw.add_bucket(pkg.CRUSH_BUCKET_STRAW2, 2, f"rack{r}",
                                   hosts, [0x30000] * 3, id=bid))
        bid -= 1
    cw.set_max_devices(osd)
    cw.add_bucket(pkg.CRUSH_BUCKET_STRAW2, 10, "default", racks,
                  [0x90000] * 3, id=-1)
    return cw, osd


def rule_of(pkg, cw, steps, name, rtype=1, max_size=10):
    return cw.add_rule(pkg.Rule(steps=[pkg.RuleStep(*s) for s in steps],
                                ruleset=1, type=rtype, min_size=1,
                                max_size=max_size), name)


def state(cw):
    """Everything the mapping depends on, as plain data."""
    m = cw.crush
    return ([None if b is None else (type(b).__name__, dataclasses.asdict(b))
             for b in m.buckets],
            [None if r is None else dataclasses.asdict(r) for r in m.rules],
            m.max_devices, m.choose_total_tries, m.choose_local_tries,
            m.choose_local_fallback_tries, m.chooseleaf_descend_once,
            m.chooseleaf_vary_r, m.chooseleaf_stable, m.straw_calc_version,
            cw.name_map, cw.rule_name_map, cw.type_map)


# ---- hash and ln ------------------------------------------------------------

def _u32s(rng, n):
    v = rng.integers(0, 1 << 32, size=n, dtype=np.uint64)
    v[:8] = [0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0xFFFFFFFE,
             0x10000, 0xFFFF]
    return v


def test_scalar_hashes_match_jax():
    rng = np.random.default_rng(1)
    a, b, c, d, e = (_u32s(rng, 400) for _ in range(5))
    for i in range(400):
        ai, bi, ci, di, ei = (int(v[i]) for v in (a, b, c, d, e))
        assert thash.crush_hash32(ai) == jhash.crush_hash32(ai)
        assert thash.crush_hash32_2(ai, bi) == jhash.crush_hash32_2(ai, bi)
        assert thash.crush_hash32_3(ai, bi, ci) == \
            jhash.crush_hash32_3(ai, bi, ci)
        assert thash.crush_hash32_4(ai, bi, ci, di) == \
            jhash.crush_hash32_4(ai, bi, ci, di)
        assert thash.crush_hash32_5(ai, bi, ci, di, ei) == \
            jhash.crush_hash32_5(ai, bi, ci, di, ei)
    # negative item ids hash as their u32 bits
    assert thash.crush_hash32_2(17, -5) == jhash.crush_hash32_2(17, -5)


def test_vector_hashes_match_jax():
    """numpy forms, and the torch forms of the plain versions (int64
    masked to 32 bits, fed as u32 values or as their int32 bits)."""
    rng = np.random.default_rng(2)
    a, b, c = (_u32s(rng, 4096).astype(np.uint32) for _ in range(3))
    want2 = jhash.crush_hash32_2_np(a, b)
    want3 = jhash.crush_hash32_3_np(a, b, c)
    np.testing.assert_array_equal(thash.crush_hash32_2_np(a, b), want2)
    np.testing.assert_array_equal(thash.crush_hash32_3_np(a, b, c), want3)
    for conv in (lambda v: torch.from_numpy(v.astype(np.int64)),
                 lambda v: torch.from_numpy(v.view(np.int32))):
        got2 = crush_kernels.hash32_2(conv(a), conv(b))
        got3 = crush_kernels.hash32_3(conv(a), conv(b), conv(c))
        np.testing.assert_array_equal(got2.numpy(), want2.astype(np.int64))
        np.testing.assert_array_equal(got3.numpy(), want3.astype(np.int64))


def test_crush_ln_matches_jax():
    us = np.arange(0x10000, dtype=np.uint32)
    np.testing.assert_array_equal(tln.crush_ln_np(us), jln.crush_ln_np(us))
    rng = np.random.default_rng(3)
    for u in [0, 1, 0x7FFF, 0x8000, 0xFFFF] + \
            [int(v) for v in rng.integers(0, 0x10000, 200)]:
        assert tln.crush_ln(u) == jln.crush_ln(u)
    np.testing.assert_array_equal(tln.RH_LH_NP, jln.RH_LH_NP)
    np.testing.assert_array_equal(tln.LL_NP, jln.LL_NP)


# ---- maps and crush_do_rule ----------------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"n_hosts": 7, "osds_per_host": 3,
                                     "uneven": True}])
def test_build_map_matches_the_jax_fixture(kw):
    """The port's CrushWrapper builds the map test_crush_device builds."""
    port, n = build_map(tc, **kw)
    ref, n_ref = test_crush_device.build_map(**kw)
    assert n == n_ref
    assert state(port) == state(ref)
    assert state(build_corpus_map(tc)) == state(jax_corpus_map())


def _rule_styles():
    """(name, map builder, rule adder, result_max, weight editor)."""
    F, CF, CI, E, T = (jc.CRUSH_RULE_CHOOSE_FIRSTN,
                       jc.CRUSH_RULE_CHOOSELEAF_FIRSTN,
                       jc.CRUSH_RULE_CHOOSE_INDEP, jc.CRUSH_RULE_EMIT,
                       jc.CRUSH_RULE_TAKE)
    EC = jc.PG_POOL_TYPE_ERASURE

    def simple(mode, rtype=1, mask=None):
        def add(pkg, cw):
            rno = cw.add_simple_rule("r", "default", "host", mode=mode,
                                     rule_type=rtype)
            if mask:
                cw.set_rule_mask_max_size(rno, mask)
            return rno
        return add

    def steps(st, rtype=1, max_size=10):
        return lambda pkg, cw: rule_of(pkg, cw, st, "s", rtype, max_size)

    def out(*pairs):
        def edit(w):
            for i, v in pairs:
                w[i] = v
            return w
        return edit

    def rand_out(seed, n_frac=3):
        def edit(w):
            rng = np.random.default_rng(seed)
            for i in rng.choice(len(w), size=len(w) // n_frac,
                                replace=False):
                w[i] = int(rng.choice([0, 0x4000, 0x8000, 0xC000]))
            return w
        return edit

    return [
        ("chooseleaf_firstn", dict(), simple("firstn"), 3, None),
        ("chooseleaf_firstn_uneven",
         dict(n_hosts=7, osds_per_host=3, uneven=True), simple("firstn"),
         3, None),
        ("firstn_out_devices", dict(n_hosts=6, osds_per_host=4),
         simple("firstn"), 3, rand_out(3)),
        ("choose_firstn_direct", dict(n_hosts=4, osds_per_host=5),
         steps([(T, -1, 0), (F, 0, 0), (E, 0, 0)]), 3,
         out((3, 0), (11, 0x7000))),
        ("chooseleaf_indep_uneven",
         dict(n_hosts=8, osds_per_host=3, uneven=True),
         simple("indep", EC, 8), 6, None),
        ("chooseleaf_indep_holes", dict(n_hosts=5, osds_per_host=2),
         simple("indep", EC), 4, out((0, 0), (5, 0))),
        ("choose_indep_direct", dict(n_hosts=4, osds_per_host=4),
         steps([(T, -1, 0), (CI, 0, 0), (E, 0, 0)], 3, 20), 4,
         out((7, 0),)),
        ("chained", dict(n_hosts=6, osds_per_host=4, uneven=True),
         steps([(T, -1, 0), (F, 2, 1), (F, 2, 0), (E, 0, 0)]), 4, None),
        ("take_own_type", dict(n_hosts=4, osds_per_host=3),
         steps([(T, -1, 0), (F, 2, 10), (E, 0, 0)]), 2, None),
        ("impossible_indep", dict(n_hosts=3, osds_per_host=1),
         simple("indep", EC), 5, None),
        ("chooseleaf_firstn_steps", dict(n_hosts=5, osds_per_host=3),
         steps([(T, -1, 0), (CF, 0, 1), (E, 0, 0)]), 3, out((2, 0),)),
    ]


@pytest.mark.parametrize("style", _rule_styles(), ids=lambda s: s[0])
def test_do_rule_matches_jax(style):
    _, kw, add, result_max, edit = style
    ref, n = test_crush_device.build_map(**kw)
    port, _ = build_map(tc, **kw)
    rno = add(jc, ref)
    assert add(tc, port) == rno
    weight = [0x10000] * n
    if edit:
        weight = edit(weight)
    for x in range(N_X):
        want = ref.do_rule(rno, x, result_max, weight)
        assert port.do_rule(rno, x, result_max, weight) == want, x
        assert tc.crush_do_rule(port.crush, rno, x, result_max,
                                weight) == want, x


@pytest.mark.parametrize("profile", ["argonaut", "bobtail", "firefly",
                                     "hammer", "jewel"])
def test_tunable_profiles_match_jax(profile):
    ref, n = test_crush_device.build_map(n_hosts=5, osds_per_host=3,
                                         uneven=True)
    port, _ = build_map(tc, n_hosts=5, osds_per_host=3, uneven=True)
    ref.set_tunables_profile(profile)
    port.set_tunables_profile(profile)
    assert state(port) == state(ref)
    for mode in ("firstn", "indep"):
        rno = ref.add_simple_rule(mode, "default", "host", mode=mode)
        assert port.add_simple_rule(mode, "default", "host",
                                    mode=mode) == rno
        weight = [0x10000] * n
        weight[2] = 0
        weight[6] = 0x9000
        for x in range(200):
            assert port.do_rule(rno, x, 3, weight) == \
                ref.do_rule(rno, x, 3, weight), (mode, x)


def test_choose_args_match_jax():
    """Per-position weight sets and replacement hash ids."""
    maps = []
    for pkg, (cw, n) in ((jc, test_crush_device.build_map(4, 3)),
                         (tc, build_map(tc, 4, 3))):
        rno = cw.add_simple_rule("data", "default", "host", mode="firstn")
        args = cw.choose_args_create(0)
        b = cw.get_bucket(-3)
        args[2].weight_set = [
            pkg.WeightSet(weights=[0x8000 if i == 1 else w
                                   for i, w in enumerate(b.item_weights)]),
            pkg.WeightSet(weights=list(b.item_weights)),
        ]
        args[0].ids = [-100 - i for i in range(cw.get_bucket(-1).size)]
        maps.append((cw, rno, n))
    (ref, rno, n), (port, prno, _) = maps
    assert prno == rno
    weight = [0x10000] * n
    for x in range(N_X):
        want = ref.do_rule(rno, x, 3, weight, choose_args_index=0)
        assert port.do_rule(rno, x, 3, weight, choose_args_index=0) == want
        assert tc.crush_do_rule(port.crush, rno, x, 3, weight,
                                port.choose_args_get(0)) == want


@pytest.mark.parametrize("alg", ["UNIFORM", "LIST", "TREE", "STRAW",
                                 "STRAW2"])
def test_bucket_algorithms_match_jax(alg):
    """The host interpreter's every bucket chooser (the card's mapper
    takes straw2 only; a map of another algorithm maps here)."""
    cws = []
    for pkg in (jc, tc):
        a = getattr(pkg, f"CRUSH_BUCKET_{alg}")
        cw = pkg.CrushWrapper()
        cw.set_type_name(1, "host")
        cw.set_type_name(10, "root")
        hosts = []
        for h in range(4):
            osds = list(range(3 * h, 3 * h + 3))
            ws = ([0x10000] * 3 if alg == "UNIFORM"
                  else [0x10000 * (1 + (i % 3)) for i in osds])
            hosts.append(cw.add_bucket(a, 1, f"host{h}", osds, ws,
                                       id=-(h + 2)))
        cw.set_max_devices(12)
        cw.add_bucket(a, 10, "default", hosts, [0x30000] * 4, id=-1)
        cw.add_simple_rule("data", "default", "host", mode="firstn")
        cw.add_simple_rule("ec", "default", "host", mode="indep")
        cws.append(cw)
    ref, port = cws
    assert state(port) == state(ref)
    weight = [0x10000] * 12
    weight[4] = 0
    for rno in (0, 1):
        for x in range(200):
            assert port.do_rule(rno, x, 3, weight) == \
                ref.do_rule(rno, x, 3, weight), (rno, x)


@pytest.mark.parametrize("size", [1, 2, 5, 11, 12, 20, 50])
def test_straw2_draw_forms_match_jax(size):
    """Both forms of the host straw2 draw (the scalar loop below
    STRAW2_NUMPY_MIN items, the numpy pass from there) pick what the JAX
    chooser picks, at every width: zero weights, equal weights (first of
    equal draws wins), ids at and past 2^31, replacement ids."""
    from ceph_tpu.crush import mapper as jm
    from ceph_tpu_torch.crush import mapper as tm
    rng = np.random.default_rng(size)
    for trial in range(40):
        items = [int(v) for v in rng.integers(-50, 1000, size)]
        if trial % 4 == 0:
            weights = [0x10000] * size
        else:
            weights = [int(v) for v in rng.choice(
                [0, 1, 0x8000, 0x10000, 0x7fffffff], size)]
        ids = ([int(v) for v in rng.integers(0, 1 << 32, size,
                                             dtype=np.uint64)]
               if trial % 2 else items)
        bucket = jc.Straw2Bucket(id=-1, type=1, items=items,
                                 item_weights=weights)
        arg = jc.ChooseArg(ids=ids) if trial % 2 else None
        for x, r in ((trial, 0), (0xFFFFFFFF - trial, 3), (2 ** 31, 7)):
            want = jm._straw2_choose(bucket, x, r, arg, 0)
            for form in (tm._straw2_argmax_py, tm._straw2_argmax_np):
                assert items[form(ids, weights, x, r, size)] == want, (
                    form.__name__, trial, x, r)


@pytest.mark.parametrize("case", sorted(CRUSH_CORPUS["rules"]))
def test_corpus_rules_match(case):
    """The corpus map's two rules: the port against the recorded mappings
    and against the JAX host mapper."""
    port = build_corpus_map(tc)
    ref = jax_corpus_map()
    entry = CRUSH_CORPUS["rules"][case]
    weight = [0x10000] * 20
    weight[3] = 0
    weight[11] = 0x8000
    for x_str, expect in entry["mappings"].items():
        got = port.do_rule(entry["rule"], int(x_str), entry["numrep"],
                           weight)
        assert got == expect, (case, x_str)
        assert got == ref.do_rule(entry["rule"], int(x_str),
                                  entry["numrep"], weight)


def test_find_rule_and_rule_names_match():
    ref, port = jax_corpus_map(), build_corpus_map(tc)
    for args in ((0, 1, 3), (1, 3, 6), (0, 3, 3), (5, 1, 3)):
        assert port.find_rule(*args) == ref.find_rule(*args)
        assert tc.crush_find_rule(port.crush, *args) == \
            jc.crush_find_rule(ref.crush, *args)
    assert port.rule_name_map == ref.rule_name_map


# ---- create_rule ---------------------------------------------------------------

@pytest.mark.parametrize("prof", [
    {"plugin": "isa", "k": "4", "m": "2"},
    {"plugin": "jerasure", "k": "8", "m": "4"},
    {"plugin": "lrc", "k": "4", "m": "2", "l": "3"},
    {"plugin": "jerasure", "k": "8", "m": "4",
     "crush-failure-domain": "osd"},
], ids=lambda p: "-".join(f"{k}{v}" for k, v in p.items()))
def test_create_rule_matches_jax(prof):
    """The rule each codec adds, step for step, and its mappings."""
    ref = jax_create({**prof, "backend": "host"})
    port = port_create({**prof, "backend": "host"})
    rcw, pcw = jax_corpus_map(), build_corpus_map(tc)
    rno = ref.create_rule("ecpool", rcw)
    assert rno >= 0
    assert port.create_rule("ecpool", pcw) == rno
    assert state(pcw) == state(rcw)
    steps = [(s.op, s.arg1, s.arg2) for s in pcw.crush.rules[rno].steps]
    if prof["plugin"] != "lrc":
        assert (tc.CRUSH_RULE_SET_CHOOSELEAF_TRIES, 5, 0) in steps
        assert (tc.CRUSH_RULE_SET_CHOOSE_TRIES, 100, 0) in steps
    size = port.get_chunk_count()
    assert pcw.crush.rules[rno].max_size == size
    weight = [0x10000] * 20
    weight[7] = 0
    for x in range(64):
        assert pcw.do_rule(rno, x, size, weight) == \
            rcw.do_rule(rno, x, size, weight), x
    # a second rule of the same name is refused the same way
    assert port.create_rule("ecpool", pcw) == ref.create_rule("ecpool", rcw)
