"""The port's dispatch scheduler against the JAX package's, on the CPU.

Port side: ``ceph_tpu_torch.dispatch`` with ``backend=host`` codecs (the
cuda plugin's K1 runs its plain PyTorch version on CPU tensors).
Reference side: ``ceph_tpu.dispatch`` with ``backend=host`` codecs of
the same profiles (the JAX package on its CPU platform takes the same
route: no stripe padding).  Both packages' ``g_conf`` carry the same
dispatch options in every test.  The cases are ``tests/test_dispatch.py``'s
that need no cluster: window-0 passthrough, the threaded stress, cross-
plugin coalescing, backpressure, window-expiry ``poll``, unbatchable
passthrough, span children, the mid-batch re-run, a raising done-callback
and the occupancy histogram with ``dump``; plus the cross-package case
(byte-equal outputs and equal ``dispatch.*`` host-copy bytes, one
``encode_batch`` per flush) and the port's refusal of a mesh.  Every
output is held byte-exact against per-request ``ecutil`` of both
packages.
"""
import sys
import threading
import time

import numpy as np
import pytest

from ceph_tpu.common.config import g_conf as jax_conf
from ceph_tpu.dispatch import g_dispatcher as jax_dispatcher
from ceph_tpu.ec.isa import ErasureCodeIsa as JaxIsa
from ceph_tpu.ec.jerasure import ErasureCodeJerasure as JaxJerasure
from ceph_tpu.ec.tpu_plugin import ErasureCodeTpu as JaxTpu
from ceph_tpu.mesh import g_chipstat as jax_chipstat
from ceph_tpu.mesh import g_mesh as jax_mesh
from ceph_tpu.osd import ecutil as jax_ecutil
from ceph_tpu.trace import g_devprof as jax_devprof

from ceph_tpu_torch.common.config import g_conf
from ceph_tpu_torch.dispatch import (KIND_ENCODE, batchable,
                                     bucket_chunk_size,
                                     dispatch_perf_counters, g_dispatcher)
from ceph_tpu_torch.dispatch.scheduler import (MESH_OFF_DUMP,
                                               l_dispatch_backpressure,
                                               l_dispatch_coalesced,
                                               l_dispatch_errors,
                                               l_dispatch_fallback_reqs,
                                               l_dispatch_fallbacks,
                                               occupancy_axes)
from ceph_tpu_torch.ec.cuda_plugin import ErasureCodeCuda
from ceph_tpu_torch.ec.isa import ErasureCodeIsa
from ceph_tpu_torch.ec.jerasure import ErasureCodeJerasure
from ceph_tpu_torch.fault import g_faults
from ceph_tpu_torch.ops import gf_pallas
from ceph_tpu_torch.osd import ecutil
from ceph_tpu_torch.trace import g_devprof, g_perf_histograms, g_tracer

OPTIONS = ("ec_dispatch_batch_max", "ec_dispatch_batch_window_us",
           "ec_dispatch_queue_max", "ec_mesh_chips")
# the JAX mesh's own options: its state rides the JAX dispatcher's dump
JAX_MESH_OPTIONS = ("ec_mesh_pool_buffers", "ec_mesh_donate",
                    "ec_mesh_skew_sample_every", "ec_mesh_skew_threshold",
                    "ec_mesh_rateless", "ec_mesh_rateless_tasks")


def set_both(name, value):
    g_conf.set_val(name, value)
    jax_conf.set_val(name, value)


def _defaults():
    """Both dispatchers drained, both packages' options at their
    defaults, and the JAX mesh down with its chip statistics empty."""
    g_dispatcher.flush()
    jax_dispatcher.flush()
    g_faults.clear()
    for name in OPTIONS:
        g_conf.rm_val(name)
        jax_conf.rm_val(name)
    for name in JAX_MESH_OPTIONS:
        jax_conf.rm_val(name)
    jax_mesh.topology()          # rebuilt without a mesh at ec_mesh_chips 0
    jax_chipstat.reset()
    g_tracer.enable(False)
    g_tracer.collector.clear()


@pytest.fixture
def dispatch_conf():
    """Every test starts and ends with both packages at their defaults:
    a test file that ran earlier in the same process may have left
    options set, a mesh up or the JAX chip statistics filled (they ride
    the JAX dispatcher's ``dump``)."""
    _defaults()
    yield
    _defaults()


# a signature mix: (port plugin, JAX twin, k, m, technique)
MIX = [
    (ErasureCodeCuda, JaxTpu, 4, 2, "reed_sol_van"),
    (ErasureCodeCuda, JaxTpu, 8, 4, "reed_sol_van"),
    (ErasureCodeIsa, JaxIsa, 4, 2, "reed_sol_van"),  # groups with cuda 4+2
    (ErasureCodeIsa, JaxIsa, 3, 2, "cauchy"),
    (ErasureCodeJerasure, JaxJerasure, 4, 2, "reed_sol_van"),  # own family
]


def mk(plugin, k, m, technique):
    impl = plugin()
    impl.init({"k": str(k), "m": str(m), "technique": technique,
               "backend": "host"})
    return impl


def impls():
    """Port codecs of MIX, each with its JAX twin as ``.twin``."""
    out = []
    for port, jax, k, m, tech in MIX:
        impl = mk(port, k, m, tech)
        impl.twin = mk(jax, k, m, tech)
        out.append(impl)
    return out


def random_requests(rng, n, codecs=None):
    """n randomized encode/decode/reconstruct requests, each
    ``(kind, sinfo, impl, payload, want, need)``."""
    codecs = codecs or impls()
    reqs = []
    for _ in range(n):
        impl = codecs[rng.integers(0, len(codecs))]
        k, m = impl.k, impl.m
        chunk = int(rng.choice([512, 1024, 1536, 2048, 4096]))
        sinfo = ecutil.stripe_info_t(k, k * chunk)
        stripes = int(rng.integers(1, 5))
        data = rng.integers(0, 256, size=stripes * k * chunk,
                            dtype=np.uint8)
        kind = str(rng.choice(["encode", "decode_concat", "decode",
                               "decode_fail"]))
        want = set(range(k + m))
        if kind == "encode":
            reqs.append(("encode", sinfo, impl, data, want, None))
            continue
        shards = ecutil.encode(sinfo, impl, data, want)
        if kind == "decode_fail":
            # an under-provisioned survivor set: raises IOError for THIS
            # request only
            avail = sorted(rng.choice(k + m, size=k - 1, replace=False))
            reqs.append(("decode_fail", sinfo, impl,
                         {int(i): shards[int(i)] for i in avail}, None,
                         None))
            continue
        avail = sorted(rng.choice(k + m, size=k, replace=False))
        chunks = {int(i): shards[int(i)] for i in avail}
        if kind == "decode_concat":
            reqs.append(("decode_concat", sinfo, impl, chunks, None, None))
        else:
            lost = sorted(set(range(k + m)) - set(chunks))
            need = list(lost[:max(1, len(lost) // 2)]) or [0]
            reqs.append(("decode", sinfo, impl, chunks, None, need))
    return reqs


def run(dispatcher, spec, twin=False):
    kind, sinfo, impl, payload, want, need = spec
    impl = impl.twin if twin else impl
    if kind == "encode":
        return dispatcher.encode(sinfo, impl, payload, want)
    if kind in ("decode_concat", "decode_fail"):
        return dispatcher.decode_concat(sinfo, impl, payload)
    return dispatcher.decode(sinfo, impl, payload, need)


def submit(dispatcher, spec, twin=False):
    kind, sinfo, impl, payload, want, need = spec
    impl = impl.twin if twin else impl
    if kind == "encode":
        return dispatcher.submit_encode(sinfo, impl, payload, want)
    if kind in ("decode_concat", "decode_fail"):
        return dispatcher.submit_decode_concat(sinfo, impl, payload)
    return dispatcher.submit_decode(sinfo, impl, payload, need)


def oracle(spec, eu=ecutil, twin=False):
    kind, sinfo, impl, payload, want, need = spec
    impl = impl.twin if twin else impl
    if kind == "encode":
        return eu.encode(sinfo, impl, payload, want)
    if kind in ("decode_concat", "decode_fail"):
        return eu.decode_concat(sinfo, impl, payload)
    return eu.decode(sinfo, impl, payload, need)


def same(kind, a, b):
    if kind in ("encode", "decode"):
        assert sorted(a) == sorted(b)
        for i in a:
            assert np.asarray(a[i]).tobytes() == np.asarray(b[i]).tobytes(), \
                f"shard {i} differs"
    else:
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def same_as_both_oracles(spec, got):
    """``got`` equals the port's and the JAX package's per-request
    ecutil on the same inputs."""
    same(spec[0], got, oracle(spec))
    same(spec[0], got, oracle(spec, jax_ecutil, twin=True))


# ---- parity ----------------------------------------------------------------
def test_window_zero_is_exact_passthrough(dispatch_conf):
    rng = np.random.default_rng(7)
    for spec in random_requests(rng, 24):
        if spec[0] == "decode_fail":
            with pytest.raises(IOError):
                run(g_dispatcher, spec)
            continue
        same_as_both_oracles(spec, run(g_dispatcher, spec))


@pytest.mark.parametrize("window_us,batch_max", [(50_000, 4),
                                                 (10_000_000, 64)])
def test_threaded_stress_byte_identical(dispatch_conf, window_us,
                                        batch_max):
    """8 threads submit randomized (k, m, technique, size) mixes: every
    output matches per-request ecutil of both packages byte for byte, and
    under-provisioned decodes fail alone without poisoning batchmates."""
    set_both("ec_dispatch_batch_window_us", window_us)
    set_both("ec_dispatch_batch_max", batch_max)
    n_threads, per_thread = 8, 12
    codecs = impls()
    specs = [random_requests(np.random.default_rng(100 + t), per_thread,
                             codecs)
             for t in range(n_threads)]
    results = [[None] * per_thread for _ in range(n_threads)]
    errors = [[None] * per_thread for _ in range(n_threads)]

    def worker(t):
        for i, spec in enumerate(specs[t]):
            try:
                results[t][i] = run(g_dispatcher, spec)
            except Exception as e:        # noqa: BLE001 — recorded
                errors[t][i] = e

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
    finally:
        sys.setswitchinterval(switch)
    assert not any(th.is_alive() for th in threads)
    for t in range(n_threads):
        for i, spec in enumerate(specs[t]):
            if spec[0] == "decode_fail":
                assert isinstance(errors[t][i], IOError), errors[t][i]
                continue
            assert errors[t][i] is None, errors[t][i]
            same_as_both_oracles(spec, results[t][i])
    assert g_dispatcher.dump()["pending"] == 0


def test_cross_plugin_coalescing(dispatch_conf):
    """cuda and isa instances of the same (technique, k, m) share the
    isa-matrix signature family and ride one flush, as the JAX tpu and
    isa plugins do."""
    set_both("ec_dispatch_batch_window_us", 10_000_000)
    cuda = mk(ErasureCodeCuda, 4, 2, "reed_sol_van")
    isa = mk(ErasureCodeIsa, 4, 2, "reed_sol_van")
    assert cuda.codec_signature() == isa.codec_signature() \
        == mk(JaxTpu, 4, 2, "reed_sol_van").codec_signature()
    assert mk(ErasureCodeJerasure, 4, 2, "reed_sol_van").codec_signature() \
        == mk(JaxJerasure, 4, 2, "reed_sol_van").codec_signature()
    rng = np.random.default_rng(3)
    s1 = ecutil.stripe_info_t(4, 4 * 1024)
    s2 = ecutil.stripe_info_t(4, 4 * 768)   # same pow2 bucket (1024)
    assert bucket_chunk_size(768) == 1024
    d1 = rng.integers(0, 256, size=2 * 4 * 1024, dtype=np.uint8)
    d2 = rng.integers(0, 256, size=3 * 4 * 768, dtype=np.uint8)
    want = set(range(6))
    before = dispatch_perf_counters().get(l_dispatch_coalesced)
    f1 = g_dispatcher.submit_encode(s1, cuda, d1, want)
    f2 = g_dispatcher.submit_encode(s2, isa, d2, want)
    r1, r2 = f1.result(), f2.result()
    same("encode", r1, ecutil.encode(s1, cuda, d1, want))
    same("encode", r2, ecutil.encode(s2, isa, d2, want))
    jisa = mk(JaxIsa, 4, 2, "reed_sol_van")
    same("encode", r1, jax_ecutil.encode(s1, jisa, d1, want))
    same("encode", r2, jax_ecutil.encode(s2, jisa, d2, want))
    assert dispatch_perf_counters().get(l_dispatch_coalesced) \
        == before + 2, "the two requests did not share a flush"


# ---- queue mechanics -------------------------------------------------------
def test_backpressure_force_flushes(dispatch_conf):
    set_both("ec_dispatch_batch_window_us", 10_000_000)
    set_both("ec_dispatch_batch_max", 1000)
    set_both("ec_dispatch_queue_max", 4)
    impl = mk(ErasureCodeCuda, 4, 2, "reed_sol_van")
    sinfo = ecutil.stripe_info_t(4, 4 * 512)
    rng = np.random.default_rng(4)
    before = dispatch_perf_counters().get(l_dispatch_backpressure)
    futs = []
    for _ in range(6):
        d = rng.integers(0, 256, size=4 * 512, dtype=np.uint8)
        futs.append((d, g_dispatcher.submit_encode(
            sinfo, impl, d, set(range(6)))))
    assert dispatch_perf_counters().get(l_dispatch_backpressure) > before
    assert g_dispatcher.dump()["pending"] <= 4
    jimpl = mk(JaxTpu, 4, 2, "reed_sol_van")
    for d, f in futs:
        same("encode", f.result(),
             jax_ecutil.encode(sinfo, jimpl, d, set(range(6))))


def test_window_expiry_poll_flushes(dispatch_conf):
    set_both("ec_dispatch_batch_window_us", 1)     # expires at once
    impl = mk(ErasureCodeCuda, 4, 2, "reed_sol_van")
    sinfo = ecutil.stripe_info_t(4, 4 * 512)
    d = (np.arange(4 * 512) % 256).astype(np.uint8)
    f = g_dispatcher.submit_encode(sinfo, impl, d, set(range(6)))
    time.sleep(0.002)
    g_dispatcher.poll()
    assert f.done()
    same("encode", f.result(),
         jax_ecutil.encode(sinfo, mk(JaxTpu, 4, 2, "reed_sol_van"), d,
                           set(range(6))))


def test_unbatchable_codec_passes_through(dispatch_conf):
    """A codec that does not opt in (dispatch_batchable False) executes
    inline even with a window set — never grouped or queued."""
    set_both("ec_dispatch_batch_window_us", 10_000_000)

    class OpaqueCodec(ErasureCodeIsa):
        dispatch_batchable = False

    impl = OpaqueCodec()
    impl.init({"k": "2", "m": "1", "backend": "host"})
    assert not batchable(impl, 512, KIND_ENCODE)
    sinfo = ecutil.stripe_info_t(2, 2 * 512)
    d = (np.arange(2 * 512) % 256).astype(np.uint8)
    out = g_dispatcher.encode(sinfo, impl, d, set(range(3)))
    jimpl = JaxIsa()
    jimpl.init({"k": "2", "m": "1", "backend": "host"})
    same("encode", out, jax_ecutil.encode(sinfo, jimpl, d, set(range(3))))
    f = g_dispatcher.submit_encode(sinfo, impl, d, set(range(3)))
    assert f.done()
    assert g_dispatcher.dump()["pending"] == 0


# ---- observability ---------------------------------------------------------
def test_batch_dispatch_span_children(dispatch_conf):
    set_both("ec_dispatch_batch_window_us", 10_000_000)
    g_tracer.enable()
    impl = mk(ErasureCodeCuda, 4, 2, "reed_sol_van")
    sinfo = ecutil.stripe_info_t(4, 4 * 512)
    rng = np.random.default_rng(5)
    with g_tracer.span("op_root", daemon="test", trace_id=777):
        futs = [g_dispatcher.submit_encode(
            sinfo, impl,
            rng.integers(0, 256, size=4 * 512, dtype=np.uint8),
            set(range(6))) for _ in range(3)]
        for f in futs:
            f.result()
    spans = g_tracer.collector.dump("dispatch")["dispatch"]
    batches = [s for s in spans if s["name"] == "batch_dispatch"]
    assert batches and batches[-1]["tags"]["occupancy"] == 3
    kids = [s for s in spans
            if s["parent_span_id"] == batches[-1]["span_id"]]
    assert len(kids) == 3
    assert all(s["name"] == "batched_req:encode" for s in kids)
    assert all(s["trace_id"] == 777 for s in kids)


def test_mid_batch_rerun_counter_and_span_event(dispatch_conf):
    """A batched call that fails is re-run per request on the same
    device: every request still resolves byte-identically, and the
    re-run is counted and stamped on the submitter's span."""
    set_both("ec_dispatch_batch_window_us", 10_000_000)
    g_tracer.enable()
    impl = mk(ErasureCodeCuda, 4, 2, "reed_sol_van")
    jimpl = mk(JaxTpu, 4, 2, "reed_sol_van")
    sinfo = ecutil.stripe_info_t(4, 4 * 512)
    rng = np.random.default_rng(21)
    payloads = [rng.integers(0, 256, size=4 * 512, dtype=np.uint8)
                for _ in range(3)]
    pc = dispatch_perf_counters()
    before = {c: pc.get(c) for c in (l_dispatch_fallback_reqs,
                                     l_dispatch_fallbacks,
                                     l_dispatch_errors)}
    g_faults.inject("dispatch.batch", mode="once")
    with g_tracer.span("op_root", daemon="test", trace_id=888) as root:
        futs = [g_dispatcher.submit_encode(sinfo, impl, p, set(range(6)))
                for p in payloads]
        for f, p in zip(futs, payloads):
            same("encode", f.result(),
                 jax_ecutil.encode(sinfo, jimpl, p, set(range(6))))
    assert pc.get(l_dispatch_fallbacks) == before[l_dispatch_fallbacks] + 1
    assert pc.get(l_dispatch_fallback_reqs) \
        == before[l_dispatch_fallback_reqs] + 3
    assert pc.get(l_dispatch_errors) == before[l_dispatch_errors]
    events = [e for e in root.tags.get("events", [])
              if e["event"] == "dispatch_fallback"]
    assert len(events) == 3
    assert all(e["kind"] == "encode" for e in events)
    spans = g_tracer.collector.dump("dispatch")["dispatch"]
    batch = [s for s in spans if s["name"] == "batch_dispatch"][-1]
    assert any(e["event"] == "batch_fallback"
               for e in batch["tags"].get("events", []))


def test_raising_done_callback_does_not_poison_batch(dispatch_conf):
    """A consumer callback that raises is the consumer's bug: it is not
    taken for a device failure (no re-run) and does not block
    batchmates."""
    set_both("ec_dispatch_batch_window_us", 10_000_000)
    impl = mk(ErasureCodeCuda, 4, 2, "reed_sol_van")
    jimpl = mk(JaxTpu, 4, 2, "reed_sol_van")
    sinfo = ecutil.stripe_info_t(4, 4 * 512)
    rng = np.random.default_rng(9)
    payloads = [rng.integers(0, 256, size=4 * 512, dtype=np.uint8)
                for _ in range(3)]
    before = dispatch_perf_counters().get(l_dispatch_fallbacks)
    futs = [g_dispatcher.submit_encode(sinfo, impl, p, set(range(6)))
            for p in payloads]
    futs[0].add_done_callback(lambda f: 1 / 0)   # consumer bug
    for f, p in zip(futs, payloads):
        same("encode", f.result(),
             jax_ecutil.encode(sinfo, jimpl, p, set(range(6))))
    assert dispatch_perf_counters().get(l_dispatch_fallbacks) == before


def _keys(d):
    """The nested key structure of a dump (values vary by process)."""
    if isinstance(d, dict):
        return {k: _keys(v) for k, v in d.items()}
    return type(d).__name__


def test_occupancy_histogram_and_dump(dispatch_conf):
    set_both("ec_dispatch_batch_window_us", 10_000_000)
    hist = g_perf_histograms.get("dispatch",
                                 "dispatch_batch_occupancy_histogram",
                                 occupancy_axes)
    before = hist.total_count
    impl = mk(ErasureCodeCuda, 4, 2, "reed_sol_van")
    sinfo = ecutil.stripe_info_t(4, 4 * 512)
    rng = np.random.default_rng(6)
    futs = [g_dispatcher.submit_encode(
        sinfo, impl, rng.integers(0, 256, size=4 * 512, dtype=np.uint8),
        set(range(6))) for _ in range(4)]
    for f in futs:
        f.result()
    assert hist.total_count == before + 1     # one flush of occupancy 4
    d = g_dispatcher.dump()
    jd = jax_dispatcher.dump()
    assert d["options"]["ec_dispatch_batch_window_us"] == 10_000_000
    assert d["options"] == jd["options"]
    assert d["pending"] == 0
    assert d["counters"]["submitted"] > 0
    assert sorted(d["counters"]) == sorted(jd["counters"])
    assert d["occupancy_histogram"]["axes"] \
        == jd["occupancy_histogram"]["axes"]
    assert d["occupancy_histogram"]["axes"][0]["name"] == "batch_occupancy"
    # the mesh pane: the JAX package's mesh-off dump, key for key
    assert d["mesh"] == MESH_OFF_DUMP
    assert _keys(d["mesh"]) == _keys(jd["mesh"])
    assert jd["mesh"]["active"] is False


# ---- the port against the JAX dispatcher -----------------------------------
def _dispatch_sites(devprof):
    return {k: (v["host_copies"], v["host_copy_bytes"])
            for k, v in devprof.dump()["sites"].items()
            if k.startswith("dispatch.")}


def _delta(after, before):
    return {k: (v[0] - before.get(k, (0, 0))[0],
                v[1] - before.get(k, (0, 0))[1])
            for k, v in after.items() if v != before.get(k, (0, 0))}


@pytest.mark.parametrize("kind", ["encode", "decode_concat", "decode"])
def test_same_requests_through_both_dispatchers(dispatch_conf, kind,
                                                monkeypatch):
    """The same requests (mixed chunk sizes in one bucket) through both
    packages' ``g_dispatcher`` with the same options: byte-equal outputs,
    equal ``dispatch.*`` host-copy bytes (the port on ``backend=host``
    pads no stripes, as the JAX package on the CPU), and one
    ``encode_batch`` / ``decode_batch`` per flush."""
    set_both("ec_dispatch_batch_window_us", 10_000_000)
    set_both("ec_dispatch_batch_max", 5)
    impl = mk(ErasureCodeCuda, 8, 4, "reed_sol_van")
    impl.twin = mk(JaxTpu, 8, 4, "reed_sol_van")
    assert impl._use_device() is False and impl.twin._use_device() is False
    rng = np.random.default_rng(31)
    specs = []
    for i in range(5):
        chunk = (768, 1024, 640, 1024, 896)[i]
        sinfo = ecutil.stripe_info_t(8, 8 * chunk)
        data = rng.integers(0, 256, size=(i % 3 + 1) * 8 * chunk,
                            dtype=np.uint8)
        if kind == "encode":
            specs.append(("encode", sinfo, impl, data, set(range(12)), None))
            continue
        shards = ecutil.encode(sinfo, impl, data, set(range(12)))
        chunks = {j: shards[j] for j in range(12) if j not in (1, 9)}
        specs.append((kind, sinfo, impl, chunks, None,
                      [1, 9] if kind == "decode" else None))
    calls = {"port": 0}
    entry = "encode_batch" if kind == "encode" else "decode_batch"
    real = getattr(impl, entry)

    def counted(*a, **kw):
        calls["port"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(impl, entry, counted)
    launches0 = gf_pallas.launches.n
    p0, j0 = _dispatch_sites(g_devprof), _dispatch_sites(jax_devprof)
    port_futs = [submit(g_dispatcher, s) for s in specs]
    port_out = [f.result() for f in port_futs]
    jax_futs = [submit(jax_dispatcher, s, twin=True) for s in specs]
    jax_out = [f.result() for f in jax_futs]
    pd = _delta(_dispatch_sites(g_devprof), p0)
    jd = _delta(_dispatch_sites(jax_devprof), j0)
    assert calls["port"] == 1, "one flush, one batched codec call"
    assert gf_pallas.launches.n == launches0, \
        "the CPU plain version is not a kernel launch"
    for spec, a, b in zip(specs, port_out, jax_out):
        same(kind, a, b)
        same(kind, a, oracle(spec))
    assert pd == jd
    assert "dispatch.stack" in pd and "dispatch.pad_cols" in pd
    assert "dispatch.pad_stripes" not in pd


def test_mesh_of_two_or_more_raises_before_any_launch(dispatch_conf,
                                                      monkeypatch):
    """The port has no mesh: ``ec_mesh_chips`` >= 2 refuses a device
    codec's flush (and its per-request re-run) before any launch; 0 and
    1 are the single-device path."""
    from ceph_tpu_torch.dispatch import batch as pbatch
    impl = mk(ErasureCodeCuda, 4, 2, "reed_sol_van")
    monkeypatch.setattr(impl, "_use_device", lambda: True)
    launched = []
    monkeypatch.setattr(impl, "encode_batch",
                        lambda *a: launched.append(a))
    sinfo = ecutil.stripe_info_t(4, 4 * 512)
    d = (np.arange(4 * 512) % 256).astype(np.uint8)
    for chips in (0, 1):
        g_conf.set_val("ec_mesh_chips", chips)
        assert pbatch._mesh_active() is False
    for chips in (2, 8):
        g_conf.set_val("ec_mesh_chips", chips)
        with pytest.raises(NotImplementedError, match="mesh"):
            g_dispatcher.encode(sinfo, impl, d, set(range(6)))
        g_conf.set_val("ec_dispatch_batch_window_us", 10_000_000)
        f1 = g_dispatcher.submit_encode(sinfo, impl, d, set(range(6)))
        f2 = g_dispatcher.submit_encode(sinfo, impl, d, set(range(6)))
        g_dispatcher.flush()
        for f in (f1, f2):
            assert isinstance(f.exception(), NotImplementedError)
        g_conf.rm_val("ec_dispatch_batch_window_us")
    assert launched == []


def test_launch_counter_under_threads():
    """Wrappers count launches with ``LaunchCounter.add`` under a lock:
    16 threads adding at once lose none."""
    c = gf_pallas.LaunchCounter()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [c.add(1) for _ in range(5000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert c.n == 16 * 5000
    c.reset()
    assert c.n == 0


def test_codec_backend_built_once_under_threads():
    """The codec's lazy backend is built once when threads ask at once."""
    impl = mk(ErasureCodeCuda, 8, 4, "reed_sol_van")
    got = []
    threads = [threading.Thread(target=lambda: got.append(impl.device()))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert len(got) == 8 and all(g is got[0] for g in got)
