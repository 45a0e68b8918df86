"""The port's legacy-tunables mapper against the JAX package's.

- ``LegacyFastRule(device="cpu").map_batch`` (K8's plain version, with the
  host replay of its residual x) against the JAX ``LegacyFastRule.map_batch``
  and the port's ``crush_do_rule``, on ``chip_smoke.py``'s small legacy maps
  (crushtool text without tunable lines: straw v1 racks of hosts, a mixed
  straw/straw2 map, ``chooseleaf_stable 1``; rules with ``set_choose_tries``,
  ``set_chooseleaf_tries``, ``set_choose_local_tries 0``,
  ``set_choose_local_fallback_tries 0``, a chained choose, a choose of
  devices) under all-in, zeroed, partial and heavy-out-within-hosts weight
  vectors, 256 x each;
- the rules both packages refuse, ``UnsupportedRule`` alike;
- ``CompiledCrushMap(allow_legacy=True)``'s tables against the JAX ones.

Inputs are numpy, from seeds, handed to both.  Tolerance: exact equality.
Each JAX mapper is built once per module (its jit takes ~2 s).
"""
import numpy as np
import pytest
import torch

import chip_smoke
from ceph_tpu.crush.compiler import CrushCompiler as JaxCompiler
from ceph_tpu.ops import crush_fast as jax_fast
from ceph_tpu.ops import crush_kernels as jax_kernels
from ceph_tpu.ops import crush_legacy as jax_legacy
from ceph_tpu_torch.crush.compiler import CrushCompiler
from ceph_tpu_torch.crush.mapper import crush_do_rule
from ceph_tpu_torch.ops import crush_fast as tf
from ceph_tpu_torch.ops import crush_kernels as tk
from ceph_tpu_torch.ops import crush_legacy as tl

X = 256
SMALL = chip_smoke.legacy_small_maps()


@pytest.fixture(scope="module")
def maps():
    """name -> (port map, JAX map), both compiled from the same text."""
    return {name: (CrushCompiler().compile(text).crush,
                   JaxCompiler().compile(text).crush)
            for name, (text, _) in SMALL.items()}


def _per_host(m):
    return m.max_devices // sum(1 for b in m.buckets
                                if b is not None and b.type == 1)


@pytest.mark.parametrize("name,rno,size", [
    (name, rno, size) for name, (_, rules) in SMALL.items()
    for rno, size in rules])
def test_map_batch_matches_jax_and_host(maps, name, rno, size):
    m, jm = maps[name]
    port = tl.LegacyFastRule(m, rno, size, device="cpu")
    ref = jax_legacy.LegacyFastRule(jm, rno, size)
    xs = np.random.default_rng(rno).integers(0, 2 ** 32, X,
                                            dtype=np.uint64).astype(np.uint32)
    weights = chip_smoke.legacy_weights(m.max_devices, _per_host(m),
                                        np.random.default_rng(7 + rno))
    for wname, w in weights.items():
        out, cnt = port.map_batch(xs, w)
        jout, jcnt = ref.map_batch(xs, w)
        np.testing.assert_array_equal(cnt, jcnt, err_msg=wname)
        np.testing.assert_array_equal(out, np.asarray(jout, np.int32),
                                      err_msg=wname)
        assert port.residual_fraction == ref.residual_fraction == 0.0
        wl = [int(v) for v in w]
        for i in range(0, X, 4):
            assert out[i, :cnt[i]].tolist() == crush_do_rule(
                m, rno, int(xs[i]), size, wl), (wname, int(xs[i]))


def _text(steps, tunables=()):
    return chip_smoke.legacy_text_map(2, 2, 3, [steps], tunables=tunables)


TAKE, EMIT = "step take default", "step emit"
REFUSED = {
    "indep": ([TAKE, "step chooseleaf indep 0 type host", EMIT], ()),
    "two_takes": ([TAKE, "step choose firstn 1 type rack", TAKE,
                   "step chooseleaf firstn 1 type host", EMIT], ()),
    "vary_r": ([TAKE, "step chooseleaf firstn 0 type host", EMIT],
               [("chooseleaf_vary_r", 1)]),
    "vary_r_step": (["step set_chooseleaf_vary_r 1", TAKE,
                     "step chooseleaf firstn 0 type host", EMIT], ()),
    "leaf_not_last": ([TAKE, "step chooseleaf firstn 2 type rack",
                       "step choose firstn 1 type osd", EMIT], ()),
    "leaf_depth_2": ([TAKE, "step chooseleaf firstn 0 type rack", EMIT], ()),
    "numrep": ([TAKE, "step chooseleaf firstn -5 type host", EMIT], ()),
    "no_take": (["step chooseleaf firstn 0 type host", EMIT], ()),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_unsupported_rules_refused_alike(case):
    steps, tunables = REFUSED[case]
    text = _text(steps, tunables)
    m = CrushCompiler().compile(text).crush
    jm = JaxCompiler().compile(text).crush
    with pytest.raises(jax_fast.UnsupportedRule):
        jax_legacy.LegacyFastRule(jm, 0, 3)
    with pytest.raises(tf.UnsupportedRule):
        tl.LegacyFastRule(m, 0, 3, device="cpu")
    with pytest.raises(tf.UnsupportedRule):
        tl.LegacyFastRule(m, 1, 3, device="cpu")      # no such rule


def test_supported_shapes_accepted_alike(maps):
    """Every rule of the small maps compiles in both packages, with the
    same stages, tries and local counts."""
    for name, (_, rules) in SMALL.items():
        m, jm = maps[name]
        for rno, size in rules:
            port = tl.LegacyFastRule(m, rno, size, device="cpu")
            ref = jax_legacy.LegacyFastRule(jm, rno, size)
            assert (port.tries, port.local_retries, port.local_fallback,
                    port.stable, port.take, port.kl, port.rt, port.rmax) == (
                ref.tries, ref.local_retries, ref.local_fallback,
                ref.stable, ref.take, ref.kl, ref.rt, ref.rmax)
            for a, b in zip(port.stages, ref.stages):
                for k in ("numrep", "type", "depth", "leafy"):
                    assert a[k] == b[k], (name, rno, k)
                assert a["recurse"] == b.get("recurse", 0)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_compiled_legacy_tables_match_jax(maps, name):
    m, jm = maps[name]
    port = tk.CompiledCrushMap(m, device="cpu", allow_legacy=True)
    ref = jax_kernels.CompiledCrushMap(jm, allow_legacy=True)
    np.testing.assert_array_equal(port.algs, ref.algs)
    np.testing.assert_array_equal(port.straws.numpy().view(np.uint32),
                                  np.asarray(ref.straws))
    np.testing.assert_array_equal(port.weights.numpy().view(np.uint32),
                                  np.asarray(ref.weights))
    for a in ("items", "hash_ids", "sizes"):
        np.testing.assert_array_equal(getattr(port, a).numpy(),
                                      np.asarray(getattr(ref, a)))
    have = port.types.numpy() >= 0
    np.testing.assert_array_equal(port.types.numpy()[have],
                                  np.asarray(ref.types)[have])
    assert (port.nbuckets, port.max_size) == (ref.nbuckets, ref.max_size)


def test_legacy_maps_refused_without_allow_legacy(maps):
    """The other mappers keep refusing straw (v1) buckets and local tries."""
    with pytest.raises(ValueError, match="straw2"):
        tk.CompiledCrushMap(maps["rack3x3x4"][0], device="cpu")
    straw2 = CrushCompiler().compile(chip_smoke.legacy_text_map(
        2, 2, 3, [[TAKE, "step chooseleaf firstn 0 type host", EMIT]],
        ("straw2",) * 3)).crush
    assert straw2.choose_local_tries == 2
    with pytest.raises(ValueError, match="bobtail"):
        tk.CompiledCrushMap(straw2, device="cpu")
    assert tk.CompiledCrushMap(straw2, device="cpu",
                               allow_legacy=True).straws is not None


def test_plain_residual_replays_on_the_host(maps):
    """A tries cap below the rule's tries leaves x past the plain
    version's window: they are flagged and replayed on the host, as the
    JAX map_batch does, and the rows stay the host's."""
    m, jm = maps["rack3x3x4"]
    port = tl.LegacyFastRule(m, 0, 3, tries_cap=1, device="cpu")
    ref = jax_legacy.LegacyFastRule(jm, 0, 3, tries_cap=1)
    w = chip_smoke.legacy_weights(m.max_devices, 4,
                                  np.random.default_rng(3))["heavy"]
    xs = np.arange(X, dtype=np.uint32)
    out, cnt = port.map_batch(xs, w)
    jout, jcnt = ref.map_batch(xs, w)
    assert port.residual_fraction == ref.residual_fraction > 0
    np.testing.assert_array_equal(cnt, jcnt)
    np.testing.assert_array_equal(out, np.asarray(jout, np.int32))
    _, _, res = tl.crush_legacy_plain(
        port, torch.from_numpy(xs.view(np.int32)),
        torch.from_numpy(w.view(np.int32)))
    assert 0 < int(res.sum()) < X
