"""``CrushTester`` of the port (the core of ``crushtool --test``) against the
JAX package's, byte for byte.

Both testers sweep the same map (``build_corpus_map``, built through each
package): the port's on its ``FastRule`` with ``device="cpu"`` (the plain
K7a/K7b, and K6 for the x they flag), the JAX one on its host
``crush_do_rule`` (and, in one case, on its own ``FastRule``).  Each
``--show-*`` mode, ``--pool-id``, ``--weight``, a rule range with missing
rules, ``--simulate`` (the RNG seeded alike), ``--output-choose-tries``
(the host route of both) and the CSV files, with and without
``--batches``; a straw(v1) map takes the host route by scope.  A failure of
the port's mapping raises: nothing catches it.

Tolerance: exact equality of the text and of every file.
"""
import io
import os

import numpy as np
import pytest

import ceph_tpu.crush as jc
import ceph_tpu_torch.crush as tc
from ceph_tpu.crush.tester import CrushTester as JaxTester
from ceph_tpu_torch.crush.tester import CrushTester as PortTester
from ceph_tpu_torch.ops import crush_fast

from test_torch_crush_host import build_corpus_map

MAX_X = 49


def _run(tester, setup):
    out = io.StringIO()
    t = tester(out)
    t.set_max_x(MAX_X)
    setup(t)
    rc = t.test()
    return out.getvalue(), rc, t.bad_mappings


def _pair(setup, jax_device=False, maps=build_corpus_map):
    rcw, pcw = maps(jc), maps(tc)

    def jax_tester(out):
        t = JaxTester(rcw, out)
        t.use_device = jax_device
        return t
    want = _run(jax_tester, setup)
    got = _run(lambda out: PortTester(pcw, out, device="cpu"), setup)
    return got, want


def _flags(*names, **values):
    def setup(t):
        for n in names:
            getattr(t, f"set_output_{n}")(True)
        for k, v in values.items():
            getattr(t, f"set_{k}")(*v) if isinstance(v, tuple) \
                else getattr(t, f"set_{k}")(v)
    return setup


MODES = {
    # the replicated rule's whole numrep range (1..10 on five hosts)
    "statistics": _flags("statistics", rule=0),
    "mappings": _flags("mappings", num_rep=3),
    "bad_mappings": _flags("bad_mappings", num_rep=6),
    "utilization": _flags("utilization", num_rep=3),
    "statistics_utilization": _flags("statistics", "utilization", num_rep=4),
    "utilization_all": _flags("statistics", "utilization_all", num_rep=3),
    "pool_id": _flags("mappings", "statistics", pool_id=5, num_rep=3),
    "weights": _flags("statistics", "mappings", "bad_mappings",
                      device_weight=(3, 0.0), num_rep=5),
    "rule_range": _flags("statistics", min_rule=0, max_rule=3, num_rep=2),
    "one_rule": _flags("mappings", rule=1, num_rep=4),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_text_output_matches_jax(mode):
    got, want = _pair(MODES[mode])
    assert got == want
    assert got[0]                      # something was printed


def test_against_the_jax_device_route():
    """The JAX tester on its own FastRule gives the same bytes."""
    got, want = _pair(_flags("mappings", "statistics", num_rep=3),
                      jax_device=True)
    assert got == want


def test_reweighted_devices_and_bad_mappings():
    def setup(t):
        # host 0 entirely out, two devices reweighted
        for o, w in ((0, 0.0), (1, 0.0), (2, 0.0), (3, 0.0), (7, 0.25),
                     (11, 0.5)):
            t.set_device_weight(o, w)
        t.set_output_bad_mappings(True)
        t.set_output_statistics(True)
        t.set_num_rep(5)
    (text, rc, bad), want = _pair(setup)
    assert (text, rc, bad) == want
    assert bad > 0 and "bad mapping" in text


def test_choose_tries_profile_takes_the_host_route(monkeypatch):
    """--output-choose-tries needs per-x try counts: both testers run
    crush_do_rule, and no FastRule is compiled."""
    def no_rule(*a, **k):
        raise AssertionError("compiled a FastRule for choose_tries")
    monkeypatch.setattr("ceph_tpu_torch.crush.tester.compile_fast_rule",
                        no_rule)
    got, want = _pair(_flags("choose_tries", "statistics", num_rep=3))
    assert got == want


def test_simulate_matches_with_the_rng_seeded(monkeypatch):
    seeded = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng",
                        lambda *a, **k: seeded(1234))
    got, want = _pair(_flags("mappings", "statistics", simulate=True,
                             num_rep=3))
    assert got == want


@pytest.mark.parametrize("batches", [1, 3])
def test_csv_files_match_jax(tmp_path, batches):
    names = {}
    for pkg in ("jax", "port"):
        d = tmp_path / pkg
        d.mkdir()

        def setup(t, d=d):
            t.set_output_csv(True, str(d) + "/t-")
            t.set_batches(batches)
            t.set_num_rep(3)
        names[pkg] = d
        if pkg == "jax":
            def tester(out, cw=build_corpus_map(jc)):
                t = JaxTester(cw, out)
                t.use_device = False
                return t
        else:
            def tester(out, cw=build_corpus_map(tc)):
                return PortTester(cw, out, device="cpu")
        _run(tester, setup)
    files = sorted(os.listdir(names["jax"]))
    assert files == sorted(os.listdir(names["port"]))
    assert len(files) == (16 if batches > 1 else 12)
    for f in files:
        assert (names["jax"] / f).read_bytes() == \
            (names["port"] / f).read_bytes(), f


def test_straw_map_takes_the_host_route():
    """compile_map's scope ValueError (a straw(v1) map), raised before any
    launch, sends the sweep to crush_do_rule; the bytes still match."""
    def straw_map(pkg):
        cw = pkg.CrushWrapper()
        cw.set_type_name(1, "host")
        cw.set_type_name(10, "root")
        hosts = [cw.add_bucket(pkg.CRUSH_BUCKET_STRAW, 1, f"h{h}",
                               [2 * h, 2 * h + 1], [0x10000] * 2,
                               id=-(h + 2)) for h in range(4)]
        cw.set_max_devices(8)
        cw.add_bucket(pkg.CRUSH_BUCKET_STRAW, 10, "default", hosts,
                      [0x20000] * 4, id=-1)
        cw.add_simple_rule("r", "default", "host", mode="firstn")
        return cw
    got, want = _pair(_flags("mappings", "statistics", num_rep=3),
                      maps=straw_map)
    assert got == want


def test_a_failed_mapping_raises(monkeypatch):
    """No except around the device route: a map_batch failure (a failed
    build or launch on the card) reaches the caller."""
    def fail(self, xs, weight):
        raise RuntimeError("crush_resolve_launch failed: cudaError 700")
    monkeypatch.setattr(crush_fast.FastRule, "map_batch", fail)
    t = PortTester(build_corpus_map(tc), io.StringIO(), device="cpu")
    t.set_output_statistics(True)
    with pytest.raises(RuntimeError, match="cudaError"):
        t.test()
