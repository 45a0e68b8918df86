"""The port's product-matrix regenerating codec against the JAX package's,
on the CPU, as a codec and through the daemons.

Codec: the same payloads through both packages' codecs of each profile
(``backend=host`` on both: here the bit-matmul kernel's plain PyTorch
version on CPU tensors, there MUL_TABLE math) give equal shard chunks,
equal any-k and row reconstructions, the same repair plan and equal
repair contributions and rebuilt shards.  ``repair`` refuses a helper set
of the wrong size (``IOError``) or one holding the lost shard
(``ValueError``) on both sides, and the port raises for a mesh of two or
more chips where the JAX codec would shard the solve.

Daemons: a regenerating pool on both packages' daemons stores equal
bodies; after an OSD is killed and marked out, the port's recovery
rebuilds its shards through sub-chunk repair rounds with no fallback,
and the stores equal the JAX twin's.  A device error inside a repair
round propagates; only the codec's refusal sends a round to the
full-stripe path.
"""
import itertools

import numpy as np
import pytest

from ceph_tpu.ec.registry import instance as jax_registry
from ceph_tpu_torch.common.config import g_conf
from ceph_tpu_torch.ec.registry import instance as port_registry
from ceph_tpu_torch.recovery import (l_recovery_fallbacks,
                                     l_recovery_repair_rounds,
                                     recovery_perf_counters)

from torch_daemon_twin import clean  # noqa: F401 (a fixture)
from torch_daemon_twin import (JAX, PORT, assert_same_state,
                               store_state)


PROFILES = [
    {"k": "3", "m": "2", "d": "4"},
    {"k": "4", "m": "3", "d": "6"},
    {"k": "3", "m": "2", "d": "3"},                      # d = k edge
    {"k": "8", "m": "4", "d": "10"},                     # the storm shape
    {"k": "4", "m": "3", "technique": "pm_msr"},         # d = 6
]


def _pair(profile):
    p = {**profile, "backend": "host"}
    return (port_registry.factory("regenerating", dict(p)),
            jax_registry.factory("regenerating", dict(p)))


@pytest.mark.parametrize("profile", PROFILES,
                         ids=[str(p) for p in PROFILES])
def test_codec_matches_jax(clean, profile):
    port, ref = _pair(profile)
    assert port.get_profile() == ref.get_profile()
    assert (port.B, port.alpha, port.d) == (ref.B, ref.alpha, ref.d)
    np.testing.assert_array_equal(port.psi, ref.psi)
    n = port.get_chunk_count()
    rng = np.random.default_rng(17)
    for size in (100, 7777):
        payload = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        full = port.encode(set(range(n)), payload)
        want = ref.encode(set(range(n)), payload)
        for i in range(n):
            np.testing.assert_array_equal(full[i], want[i])
        combos = list(itertools.combinations(range(n), port.k))
        for K in combos[::max(1, len(combos) // 4)]:
            got = port.decode_concat({i: full[i] for i in K})
            assert got == ref.decode_concat({i: full[i] for i in K})
            assert got[:size] == payload
        for lost in (0, n - 1):
            ids = [i for i in range(n) if i != lost]
            for surv in (ids, ids[:port.k]):      # >= d and < d survivors
                chunks = {i: full[i][None, :] for i in surv}
                got = port.decode_batch(chunks, [lost])[lost]
                np.testing.assert_array_equal(
                    got, ref.decode_batch(chunks, [lost])[lost])
                np.testing.assert_array_equal(got.reshape(-1), full[lost])
            plan = port.minimum_to_decode({lost}, set(ids))
            assert plan == ref.minimum_to_decode({lost}, set(ids))
            contribs = {h: port.repair_contribution(
                h, lost, full[h][None, :]) for h in plan}
            for h, c in contribs.items():
                np.testing.assert_array_equal(
                    c, ref.repair_contribution(h, lost, full[h][None, :]))
            rebuilt = port.repair(lost, contribs)
            np.testing.assert_array_equal(rebuilt, ref.repair(lost, contribs))
            np.testing.assert_array_equal(rebuilt.reshape(-1), full[lost])


def test_repair_refusals_and_mesh(clean, monkeypatch):
    port, ref = _pair({"k": "3", "m": "2", "d": "4"})
    n = port.get_chunk_count()
    full = port.encode(set(range(n)), bytes(range(256)) * 20)
    contribs = {h: port.repair_contribution(h, 0, full[h][None, :])
                for h in range(1, n)}
    for codec in (port, ref):
        with pytest.raises(IOError):
            codec.repair(0, dict(list(contribs.items())[:3]))
        with pytest.raises(ValueError):
            codec.repair(1, contribs)
    # the JAX codec would shard this solve over a mesh; the port's has
    # none and refuses before any launch
    monkeypatch.setattr(port, "_use_device", lambda: True)
    g_conf.set_val("ec_mesh_chips", 2)
    with pytest.raises(NotImplementedError, match="mesh"):
        port.repair(0, contribs)
    with pytest.raises(NotImplementedError, match="mesh"):
        port.decode_batch({i: full[i][None, :] for i in range(1, n)}, [0])


def _regen_boot(pkg):
    import chip_smoke
    d = chip_smoke.Daemons(pkg, 6)
    prof = {"plugin": "regenerating", "k": "3", "m": "2", "d": "4",
            "crush-failure-domain": "host"}
    if pkg == PORT:
        prof["backend"] = "host"
    d.create_ec_pool("regen", prof, 4)
    cl = d.client()
    rng = np.random.default_rng(41)
    bodies = {f"o{i}": rng.integers(0, 256, 2500 + i * 3333,
                                    dtype=np.uint8).tobytes()
              for i in range(5)}
    for oid, body in bodies.items():
        assert cl.write_full("regen", oid, body) == 0
    patch = b"\x5a" * 700
    assert cl.write("regen", "o2", patch, 1000) == 0
    bodies["o2"] = bodies["o2"][:1000] + patch + bodies["o2"][1700:]
    assert cl.read("regen", "o3", 500, 4000) == bodies["o3"][500:4500]
    return d, cl, bodies


def _storm(d):
    """Kill one acting member of the pool's first PG, mark it down and
    out, and tick until every PG is active again."""
    pg = next(pg for osd in d.osds.values() for pg in osd.pgs.values()
              if pg.backend is not None and pg.is_primary())
    victim = pg.acting[-1]
    d.kill_osd(victim)
    d.mark_osd_down(victim)
    d.mark_osd_out(victim)
    for _ in range(10):
        d.tick(1.0)
        if all(pg.state == "active" for osd in d.osds.values()
               if osd.name not in d.network.down
               for pg in osd.pgs.values() if pg.is_primary()):
            break
    return victim


def test_regenerating_pool_recovers_by_repair_rounds_as_jax(clean):
    states = {}
    pc = recovery_perf_counters()
    for pkg in (JAX, PORT):
        d, cl, bodies = _regen_boot(pkg)
        r0, f0 = pc.get(l_recovery_repair_rounds), pc.get(
            l_recovery_fallbacks)
        victim = _storm(d)
        if pkg == PORT:
            assert pc.get(l_recovery_repair_rounds) > r0
            assert pc.get(l_recovery_fallbacks) == f0
        for oid, body in bodies.items():
            assert cl.read("regen", oid) == body, (pkg, oid)
        states[pkg] = {k: v for k, v in store_state(d).items()
                       if k[0] != victim}
        d.shutdown()
    assert_same_state(states[JAX], states[PORT])


@pytest.mark.parametrize("fault", ["short_helper", "device_mismatch",
                                   "missing_source", "launch_failed"])
def test_repair_round_catches_only_refusals(clean, monkeypatch, fault):
    """A helper set the codec would refuse (here one contribution a row
    short) sends the repair round to a full-stripe round before the
    call; an error of the K1 wrapper inside the repair (its
    ``ValueError`` for tensors on two devices, the build's
    ``FileNotFoundError`` for a missing source, a failed launch's
    ``RuntimeError``) reaches the caller, and nothing falls back."""
    from ceph_tpu_torch.ec.regenerating import ErasureCodeRegenerating
    from ceph_tpu_torch.ops import gf_pallas
    d, cl, bodies = _regen_boot(PORT)
    pc = recovery_perf_counters()
    f0 = pc.get(l_recovery_fallbacks)
    if fault == "short_helper":
        contribution = ErasureCodeRegenerating.repair_contribution

        def short(self, helper, lost, body):
            out = contribution(self, helper, lost, body)
            return out[:-1] if helper == min(
                h for h in range(self.get_chunk_count()) if h != lost) \
                else out
        monkeypatch.setattr(ErasureCodeRegenerating, "repair_contribution",
                            short)
        _storm(d)
        assert pc.get(l_recovery_fallbacks) > f0
        for oid, body in bodies.items():
            assert cl.read("regen", oid) == body, oid
        d.shutdown()
        return
    exc = {"device_mismatch": ValueError("bit matrix on cuda:0, data on "
                                         "cpu"),
           "missing_source": FileNotFoundError("gf_bit_matmul.cu"),
           "launch_failed": RuntimeError("gf_popc failed: cudaError 700")
           }[fault]
    repair, plain = ErasureCodeRegenerating.repair, \
        gf_pallas.gf_bit_matmul_plain
    inside = []

    def traced_repair(self, lost, contributions):
        inside.append(lost)
        return repair(self, lost, contributions)

    def failing(*args, **kw):
        if inside:
            raise exc
        return plain(*args, **kw)
    monkeypatch.setattr(ErasureCodeRegenerating, "repair", traced_repair)
    monkeypatch.setattr(gf_pallas, "gf_bit_matmul_plain", failing)
    with pytest.raises(type(exc), match=str(exc)):
        _storm(d)
    assert inside, "no repair round ran"
    assert pc.get(l_recovery_fallbacks) == f0
    d.shutdown()


def test_coalesced_regenerating_encodes_match_jax(clean):
    """Encodes of a regenerating codec coalesce in the dispatcher: the
    payloads assemble into message matrices through the codec's own hook
    and one Ψ projection yields every shard row of every request, equal
    to each request alone on the JAX package."""
    from ceph_tpu.osd import ecutil as jax_ecutil
    from ceph_tpu_torch.dispatch import dispatch_perf_counters, g_dispatcher
    from ceph_tpu_torch.dispatch.scheduler import l_dispatch_coalesced
    port, ref = _pair({"k": "4", "m": "3", "d": "5"})
    sinfo = port.make_stripe_info(port.preferred_stripe_width())
    jsinfo = ref.make_stripe_info(ref.preferred_stripe_width())
    n = port.get_chunk_count()
    g_conf.set_val("ec_dispatch_batch_window_us", 10**6)
    rng = np.random.default_rng(23)
    payloads = [rng.integers(0, 256, sinfo.get_stripe_width() * s,
                             dtype=np.uint8).tobytes() for s in (1, 3, 2)]
    c0 = dispatch_perf_counters().get(l_dispatch_coalesced)
    futs = [g_dispatcher.submit_encode(sinfo, port, p, set(range(n)))
            for p in payloads]
    g_dispatcher.flush()
    assert dispatch_perf_counters().get(l_dispatch_coalesced) - c0 == 3
    for fut, p in zip(futs, payloads):
        got = fut.result()
        want = jax_ecutil.encode(jsinfo, ref, p, set(range(n)))
        for i in range(n):
            np.testing.assert_array_equal(got[i], np.asarray(want[i]))
