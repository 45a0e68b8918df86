"""Measurement bodies of the bench core: EC encode/decode and the CRUSH
remap, all through the fenced harness.

Port of the single-device, cluster-free part of
``ceph_tpu/bench/workloads.py``: ``measure_encode``, ``measure_decode``,
``parity_check``, ``measure_host_native`` (the native C++ region coder),
``measure_dispatch_coalesce`` and ``measure_ec_pipeline`` (the dispatch
scheduler) and ``measure_crush_remap`` with the helpers they share.
Everything here returns schema metrics (schema.py) built from fenced
timings (fence.py), summarized over repeats (stats.py), and stamped with
a roofline verdict (roofline.py).  Per-kernel timings flow through
``common.kernel_trace.g_kernel_timer`` and per-run counters through the
``bench`` perf-counter logger.

Every entry point runs on the card unless the caller passes
``device="cpu"``.  The salted input (no layer can serve a repeat launch
from cache) and the fetch-drain fence are both load-bearing.

The cluster workloads (``measure_traffic``, ``measure_ec_write_zero_copy``,
``measure_recovery_storm``) drive a ``MiniCluster`` through the traffic
harness and the recovery scheduler.  The mesh workloads
(``measure_ec_mesh``, ``measure_mesh_skew``, ``measure_mesh_straggler``,
``measure_degraded_read``) run on a mesh of members (``mesh/``); members
that share one card give parity and per-member launches, not scaling.
The harnesses on top of the mesh (``measure_slo_autotune``, the
controller's three closed-loop scenarios, and ``measure_composed_chaos``,
seeded storylines through ``chaos.run_scenario``) drive clusters and the
mesh together.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .fence import fenced_time, measure_rtt
from .roofline import (EC_DECODE_K8M4_SALTED, EC_ENCODE_K8M4,
                       EC_ENCODE_K8M4_SALTED, validate_reading)
from .schema import make_metric
from .stats import repeat_measure, summarize
from ..common.perf_counters import PerfCounters, PerfCountersBuilder
from ..ec.cuda_plugin import backend_profile
from ..gf.tables import expand_to_bitmatrix
from ..ops.gf_matmul import DeviceRSBackend, resolve_device
from ..ops.gf_pallas import BitMatrix, gf_bit_matmul_kernel
from ..trace.devprof import devflow_delta, g_devprof
from ..trace.oplat import g_oplat

K, M = 8, 4

# ---- perf counters ---------------------------------------------------------
BENCH_FIRST = 90000
l_bench_dispatches = 90001     # device dispatches issued by the harness
l_bench_bytes = 90002          # object bytes pushed through timed regions
l_bench_fences = 90003         # drain fences executed
l_bench_fence_time = 90004     # seconds spent inside fenced regions
BENCH_LAST = 90010

_bench_pc: Optional[PerfCounters] = None


def bench_perf_counters() -> PerfCounters:
    """The bench subsystem's counter logger (admin-socket dumpable)."""
    global _bench_pc
    if _bench_pc is None:
        b = PerfCountersBuilder("bench", BENCH_FIRST, BENCH_LAST)
        b.add_u64_counter(l_bench_dispatches, "dispatches",
                          "device dispatches issued")
        b.add_u64_counter(l_bench_bytes, "bytes",
                          "object bytes through timed regions")
        b.add_u64_counter(l_bench_fences, "fences",
                          "completion fences executed")
        b.add_time_avg(l_bench_fence_time, "fenced_region",
                       "time inside fenced regions")
        _bench_pc = b.create_perf_counters()
    return _bench_pc


# ---- the salted step -------------------------------------------------------
# Process-global monotonic salt: a retried or repeated measurement must
# never replay an input already seen.
_SALT = [0]


def _next_salt() -> int:
    _SALT[0] += 1
    return _SALT[0] & 0xFFFFFFFF


def _salted_step(d: torch.Tensor, bits: BitMatrix,
                 salt: int) -> torch.Tensor:
    """(d ^ salt) @ bits: the u32 salt XORed into every 4-byte word of
    the (S, k, C) batch (little-endian, as the JAX step's bitcast), then
    K1 (``ops/gf_pallas.py``) on the salted copy."""
    s32 = salt & 0xFFFFFFFF
    salted = d.view(torch.int32) ^ (s32 - (1 << 32) if s32 >> 31 else s32)
    return gf_bit_matmul_kernel(salted.view(torch.uint8), bits)


def salted_matmul_step() -> Callable[[torch.Tensor, BitMatrix, int],
                                     torch.Tensor]:
    """The shared (payload ^ salt) @ bits step, ``step(d, bits, salt)``.

    Salting with a never-repeating per-iteration scalar means no layer
    can serve a repeat launch from cache: every iteration is a new
    execution.  The full 32-bit salt is XORed across u32 lanes so the
    input never repeats within a run.  C must be a multiple of 4.
    """
    return _salted_step


def _calibrate_steps(step: Callable[[int], Any], target_s: float,
                     rtt_s: float, lo: int = 4, hi: int = 8192,
                     drain_fn=None) -> int:
    """Pick how many back-to-back dispatches one fenced region needs so
    compute dominates the single drain RTT and the region lands near
    ``target_s``.

    The region is stretched to at least 10x the RTT so the fence costs
    <~10% of the reading.  ``hi`` only bounds the launch queue depth —
    outputs are not retained (fence.fenced_time), so memory does not
    grow with n."""
    probe = fenced_time(step, lo, rtt_s=rtt_s, drain_fn=drain_fn)
    per_step = max((probe.elapsed_s - rtt_s) / lo, 1e-6)
    n = int(max(target_s, 10.0 * rtt_s) / per_step)
    return max(lo, min(n, hi))


def _fenced_throughput(step: Callable[[int], Any], n_steps: int,
                       bytes_per_step: int, rtt_s: float,
                       kernel_name: str,
                       drain_fn=None) -> Tuple[float, Dict[str, Any]]:
    """One fenced sample: GiB/s plus the raw timing dict."""
    timing = fenced_time(step, n_steps, rtt_s=rtt_s,
                         kernel_name=kernel_name, drain_fn=drain_fn)
    pc = bench_perf_counters()
    pc.inc(l_bench_dispatches, n_steps)
    pc.inc(l_bench_bytes, n_steps * bytes_per_step)
    pc.inc(l_bench_fences)
    pc.tinc(l_bench_fence_time, timing.elapsed_s)
    return timing.throughput(bytes_per_step), timing.to_dict()


def _devflow_since(before: Dict[str, int], n_ops: int) -> Dict[str, Any]:
    """The ``devflow`` block every fenced workload carries: device-flow
    deltas over the measured region, normalized per op."""
    return devflow_delta(before, g_devprof.snapshot(), n_ops)


def _stage_breakdown_since(before, wall_s: float,
                           n_ops: int) -> Dict[str, Any]:
    """The ``stage_breakdown`` block every fenced workload carries
    (trace/oplat.py): per-stage time over the measured region, with
    ``coverage`` (stage-sum over wall) as the reconciliation receipt."""
    return g_oplat.breakdown_since(before, wall_s, n_ops)


def _device_info(device="cuda") -> Tuple[str, str, int]:
    """(platform, device kind, device count) of the measured device:
    ``("gpu", torch.cuda.get_device_name, 1)`` on the card."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return "gpu", torch.cuda.get_device_name(dev), 1
    return "cpu", "", 1


def _measure_fenced_gf(bits: BitMatrix, batch: np.ndarray, *,
                       metric_name: str, workload: Dict[str, Any],
                       kernel_name: str, target_seconds: float,
                       repeats: int, warmup: int, rtt_s: Optional[float],
                       mesh=None,
                       n_steps: Optional[int] = None) -> Dict[str, Any]:
    """Shared fenced pipeline for the GF bit-matmul workloads on the
    device that holds ``bits``: warm the salted step, calibrate the
    per-region launch count, take warmup+repeat fenced samples, and wrap
    the median in a schema metric with a roofline verdict.  Encode and
    decode differ only in the bitmatrix and the cost model.

    With *mesh* the same step runs over its members: member i takes rows
    [i*S/n, (i+1)*S/n) of the batch on its device and launches the step
    on its stream, the fence is ``drain_sharded`` (one fetch per member,
    on its stream: each member's completion proven, not inferred) and
    the roofline verdict scales the chip peaks by the mesh's distinct
    devices (``mesh_roofline``)."""
    dev = bits.device
    step_fn = salted_matmul_step()
    drain_fn = None
    if mesh is not None:
        from ..mesh.topology import Shard, Sharded
        from ..parallel.ec import drain_sharded
        n = mesh.size
        if batch.shape[0] % n:
            raise ValueError(f"{batch.shape[0]} stripes do not divide "
                             f"over {n} mesh members")
        rows = batch.shape[0] // n
        per_dev = {d: BitMatrix(bits.bits.cpu().numpy(), d)
                   for d in mesh.distinct_devices}
        pieces = []
        for i, mem in enumerate(mesh.members):
            sl = slice(i * rows, (i + 1) * rows)
            with mem.launching():
                d = torch.from_numpy(
                    np.ascontiguousarray(batch[sl])).to(mem.device)
            pieces.append((mem, sl, d, per_dev[mem.device]))

        def mesh_step(salt: int) -> Sharded:
            shards = []
            for mem, sl, d, bm in pieces:
                with mem.launching():
                    out = step_fn(d, bm, salt)
                shards.append(Shard(mem, out, (sl,)))
            return Sharded((batch.shape[0], bits.r, batch.shape[2]),
                           shards)

        drain_sharded(mesh_step(0))              # first launches, builds

        def step(i: int):
            return mesh_step(_next_salt())

        drain_fn = drain_sharded
    else:
        data = torch.from_numpy(np.ascontiguousarray(batch)).to(dev)
        step_fn(data, bits, 0)                   # first launch, builds
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

        def step(i: int):
            return step_fn(data, bits, _next_salt())

    if rtt_s is None:
        rtt_s = measure_rtt(device=dev)
    bytes_per_step = int(batch.shape[0]) * int(batch.shape[1]) \
        * int(batch.shape[2])
    if n_steps is None:
        n_steps = _calibrate_steps(step,
                                   target_seconds / max(repeats, 1),
                                   rtt_s, drain_fn=drain_fn)
    flow0 = g_devprof.snapshot()
    stage0 = g_oplat.snapshot()
    wall_t0 = time.perf_counter()
    st = repeat_measure(
        lambda: _fenced_throughput(step, n_steps, bytes_per_step, rtt_s,
                                   kernel_name, drain_fn=drain_fn)[0],
        repeats=repeats, warmup=warmup)
    wall_s = time.perf_counter() - wall_t0
    n_ops = n_steps * (repeats + warmup)
    devflow = _devflow_since(flow0, n_ops)
    platform, kind, ndev = _device_info(dev)
    extra = {}
    if mesh is not None:
        from ..parallel.ec import mesh_roofline
        rl = mesh_roofline(st["median"], workload, mesh)
        ndev = len(mesh.distinct_devices)
        extra["mesh_members"] = mesh.size
    else:
        rl = validate_reading(st["median"], workload, platform, kind, ndev)
    return make_metric(
        metric_name, st["median"], "GiB/s", fenced=True,
        rtt_s=rtt_s, stats=st, roofline=rl,
        extra={"n_steps": n_steps, "bytes_per_step": bytes_per_step,
               "platform": platform, "n_devices": ndev, **extra,
               "devflow": devflow,
               "stage_breakdown": _stage_breakdown_since(
                   stage0, wall_s, n_ops)})


def encode_bitmatrix(matrix: np.ndarray, device="cuda") -> BitMatrix:
    """The coding rows of ``matrix`` as K1's bit matrix: what
    ``measure_encode`` multiplies by."""
    return BitMatrix(expand_to_bitmatrix(matrix[K:]), resolve_device(device))


def decode_bitmatrix(matrix: np.ndarray, erasures: int = 2,
                     device="cuda") -> BitMatrix:
    """The bit matrix that rebuilds data rows 0..erasures-1 from the
    other data rows and the first ``erasures`` coding rows: what
    ``measure_decode`` multiplies by."""
    be = DeviceRSBackend(matrix, device)
    lost = tuple(range(erasures))
    srcs = tuple(range(erasures, K)) + tuple(K + i for i in range(erasures))
    return be._decode_bits_for(srcs, lost)


def measure_encode(matrix: np.ndarray, batch: np.ndarray, *,
                   target_seconds: float = 3.0, repeats: int = 3,
                   warmup: int = 1, rtt_s: Optional[float] = None,
                   device="cuda") -> Dict[str, Any]:
    """Fenced EC encode throughput metric for a (S, k, C) batch."""
    return _measure_fenced_gf(
        encode_bitmatrix(matrix, device), batch,
        metric_name="ec_encode_k8m4_fenced",
        workload=EC_ENCODE_K8M4_SALTED, kernel_name="bench_encode_fenced",
        target_seconds=target_seconds, repeats=repeats,
        warmup=warmup, rtt_s=rtt_s)


def measure_decode(matrix: np.ndarray, batch: np.ndarray, *,
                   erasures: int = 2, target_seconds: float = 3.0,
                   repeats: int = 3, warmup: int = 1,
                   rtt_s: Optional[float] = None,
                   device="cuda") -> Dict[str, Any]:
    """Fenced decode-with-erasures throughput metric.

    The survivor payload is random: the product's timing is
    data-independent, and correctness on REAL coded data is proved by
    ``parity_check``.
    """
    return _measure_fenced_gf(
        decode_bitmatrix(matrix, erasures, device), batch,
        metric_name="ec_decode_k8m4_e2_fenced",
        workload=EC_DECODE_K8M4_SALTED, kernel_name="bench_decode_fenced",
        target_seconds=target_seconds, repeats=repeats, warmup=warmup,
        rtt_s=rtt_s)


def parity_check(matrix: np.ndarray, device="cuda") -> bool:
    """Encode REAL data on the device, erase two data shards, decode on
    the device, fetch, byte-compare against the original — the
    correctness receipt for the decode throughput number."""
    rng = np.random.default_rng(20260731)
    data = rng.integers(0, 256, size=(2, K, 4096), dtype=np.uint8)
    be = DeviceRSBackend(matrix, device)
    coding = be.encode(data)
    lost = (0, 1)
    srcs = tuple(range(2, K)) + (K, K + 1)
    survivors = np.concatenate([data[:, 2:, :], coding[:, :2, :]], axis=1)
    got = be.decode_data(survivors, srcs, lost)
    return bool(np.array_equal(got, data[:, :2, :]))


def measure_host_native(matrix: np.ndarray, data2d: np.ndarray,
                        target_seconds: float = 1.5) -> Dict[str, Any]:
    """GiB/s of the native C++ region coder (``native.native_rs_encode``)
    on one (k, C) object.  Host execution completes synchronously, so the
    reading is fenced by construction.  The library is built on first use;
    a failed build raises."""
    from ..native import native_rs_encode
    rows = matrix[K:]
    object_size = int(data2d.shape[0]) * int(data2d.shape[1])
    native_rs_encode(rows, data2d)  # build, warm tables

    def one_sample() -> float:
        n, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < target_seconds / 3:
            native_rs_encode(rows, data2d)
            n += 1
        dt = time.perf_counter() - t0
        one_sample.n_ops += n
        # the whole region is host codec compute: one stage, so the
        # native baseline's stage_breakdown reconciles trivially
        g_oplat.record("bench", "host_compute", dt * 1e6)
        return n * object_size / dt / (1 << 30)

    one_sample.n_ops = 0
    flow0 = g_devprof.snapshot()
    stage0 = g_oplat.snapshot()
    wall_t0 = time.perf_counter()
    st = repeat_measure(one_sample, repeats=3, warmup=0)
    wall_s = time.perf_counter() - wall_t0
    # the native path never crosses the device boundary: its devflow
    # block is the zero-copy baseline the device paths are judged by
    devflow = _devflow_since(flow0, max(one_sample.n_ops, 1))
    rl = validate_reading(st["median"], EC_ENCODE_K8M4, "cpu", "", 1)
    return make_metric("ec_encode_host_native", st["median"], "GiB/s",
                       fenced=True, rtt_s=0.0, stats=st, roofline=rl,
                       extra={"platform": "cpu", "devflow": devflow,
                              "stage_breakdown": _stage_breakdown_since(
                                  stage0, wall_s,
                                  max(one_sample.n_ops, 1))})


def _dispatch_codec(device, object_bytes: int):
    """(codec, device, stripe_info_t, want) of the dispatch workloads: the
    k=8 m=4 reed_sol_van ``cuda`` plugin (the JAX package's ``tpu``),
    with ``backend=host`` when the caller asks for the CPU, and objects
    of ``object_bytes`` as one stripe each."""
    from ..ec.cuda_plugin import ErasureCodeCuda
    from ..osd.ecutil import stripe_info_t
    if object_bytes % K:
        raise ValueError(f"object_bytes {object_bytes} is not a multiple "
                         f"of k={K}")
    dev = resolve_device(device)
    impl = ErasureCodeCuda()
    impl.init({"k": str(K), "m": str(M), "technique": "reed_sol_van",
               "backend": "cuda" if dev.type == "cuda" else "host"})
    return impl, dev, stripe_info_t(K, object_bytes), set(range(K + M))


def _saved_dispatch_conf() -> Dict[str, Any]:
    from ..common.config import g_conf
    return {name: g_conf.values.get(name) for name in
            ("ec_dispatch_batch_max", "ec_dispatch_batch_window_us")}


def _restore_dispatch_conf(saved: Dict[str, Any]) -> None:
    from ..common.config import g_conf
    for name, v in saved.items():
        if v is None:
            g_conf.rm_val(name)
        else:
            g_conf.set_val(name, v)


def measure_dispatch_coalesce(*, n_requests: int = 8,
                              object_bytes: int = 65536,
                              target_seconds: float = 0.6,
                              repeats: int = 3, warmup: int = 1,
                              rtt_s: Optional[float] = None,
                              device="cuda"
                              ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """N concurrent k=8 m=4 encodes of ``object_bytes`` through the
    dispatch scheduler: coalesced (one padded device call per flush,
    batch_max trigger) vs serial dispatch (window=0 exact passthrough,
    one device call per request).

    Fencing: both paths return fully host-materialized chunk buffers —
    the device output is fetched before the clock stops, which is the
    drain contract (fence.py) by construction; the measured region
    therefore includes one transport round trip per device call, which
    is exactly the per-call overhead the coalesced path amortizes.  The
    RTT is measured and reported, never subtracted.  Inputs are salted
    per pass so no layer can serve a repeat from cache.
    """
    from ..common.config import g_conf
    from ..dispatch import g_dispatcher

    impl, dev, sinfo, want = _dispatch_codec(device, object_bytes)
    rng = np.random.default_rng(20260803)
    base = rng.integers(0, 256, size=(n_requests, object_bytes),
                        dtype=np.uint8)
    if rtt_s is None:
        rtt_s = measure_rtt(device=dev)
    saved = _saved_dispatch_conf()
    pc = bench_perf_counters()

    def one_pass(coalesced: bool) -> None:
        payloads = np.bitwise_xor(base, np.uint8(_next_salt() & 0xFF))
        if coalesced:
            futs = [g_dispatcher.submit_encode(sinfo, impl, payloads[i],
                                               want)
                    for i in range(n_requests)]
            for f in futs:
                f.result()
        else:
            for i in range(n_requests):
                g_dispatcher.encode(sinfo, impl, payloads[i], want)
        pc.inc(l_bench_dispatches, 1 if coalesced else n_requests)
        pc.inc(l_bench_bytes, n_requests * object_bytes)

    def make_sampler(coalesced: bool, rounds: int):
        def sample() -> float:
            if coalesced:
                g_conf.set_val("ec_dispatch_batch_max", n_requests)
                g_conf.set_val("ec_dispatch_batch_window_us", 10**7)
            else:
                g_conf.set_val("ec_dispatch_batch_window_us", 0)
            t0 = time.perf_counter()
            for _ in range(rounds):
                one_pass(coalesced)
            dt = time.perf_counter() - t0
            pc.tinc(l_bench_fence_time, dt)
            return rounds * n_requests * object_bytes / dt / (1 << 30)

        return sample

    try:
        results = {}
        flows = {}
        breakdowns = {}
        for mode in ("serial", "coalesced"):
            coalesced = mode == "coalesced"
            # warm the build, then calibrate rounds per sample so the
            # region dwarfs a single fence round trip
            make_sampler(coalesced, 1)()
            t0 = time.perf_counter()
            make_sampler(coalesced, 1)()
            per_pass = max(time.perf_counter() - t0, 1e-6)
            rounds = max(1, min(
                int(max(target_seconds / max(repeats, 1),
                        4.0 * rtt_s) / per_pass), 256))
            flow0 = g_devprof.snapshot()
            stage0 = g_oplat.snapshot()
            wall_t0 = time.perf_counter()
            results[mode] = repeat_measure(
                make_sampler(coalesced, rounds),
                repeats=repeats, warmup=warmup)
            wall_s = time.perf_counter() - wall_t0
            n_ops = rounds * n_requests * (repeats + warmup)
            flows[mode] = _devflow_since(flow0, n_ops)
            breakdowns[mode] = _stage_breakdown_since(stage0, wall_s,
                                                      n_ops)
    finally:
        _restore_dispatch_conf(saved)
        g_dispatcher.flush()
    platform, kind, ndev = _device_info(dev)
    mets = []
    for mode, name in (("coalesced", "ec_dispatch_coalesce_fenced"),
                       ("serial", "ec_dispatch_serial_fenced")):
        st = results[mode]
        rl = validate_reading(st["median"], EC_ENCODE_K8M4, platform,
                              kind, ndev)
        extra = {"n_requests": n_requests, "object_bytes": object_bytes,
                 "platform": platform, "devflow": flows[mode],
                 "stage_breakdown": breakdowns[mode]}
        if mode == "coalesced":
            extra["serial_gibs"] = round(results["serial"]["median"], 4)
            extra["speedup"] = round(
                st["median"] / max(results["serial"]["median"], 1e-9), 3)
            extra["batch_occupancy"] = n_requests
        mets.append(make_metric(name, st["median"], "GiB/s", fenced=True,
                                rtt_s=rtt_s, stats=st, roofline=rl,
                                extra=extra))
    return mets[0], mets[1]


def measure_ec_pipeline(*, n_requests: int = 64,
                        object_bytes: int = 65536, depth: int = 8,
                        target_seconds: float = 0.6,
                        repeats: int = 3, warmup: int = 1,
                        rtt_s: Optional[float] = None, device="cuda"
                        ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """N sequential k=8 m=4 encodes of ``object_bytes`` from ONE
    submitter thread: pipeline depth ``depth`` (non-blocking dispatch
    futures with continuation completion, window drained by a forced
    flush at the depth boundary — the ECBackend backpressure rule) vs
    depth 1 (the synchronous submit → result() per op).  The depth-1 leg
    models why a lone OSD op thread never fills a batch: each op demands
    its result inline, so every encode pays a full dispatch.

    Fencing: completion is a continuation observing the fully
    host-materialized chunk buffers, so the clock stops only after the
    device output crossed back to the host (the drain contract, as in
    measure_dispatch_coalesce); the RTT is measured and reported, never
    subtracted.  Inputs are salted per pass.  The occupancy the pipeline
    achieved is read back from the dispatcher's batch-occupancy
    histogram (``mean_batch_occupancy``); byte-identity of the pipelined
    outputs against the depth-1 path is checked every run
    (``identical``).
    """
    from ..common.config import g_conf
    from ..dispatch import g_dispatcher
    from ..trace import g_perf_histograms, occupancy_axes

    impl, dev, sinfo, want = _dispatch_codec(device, object_bytes)
    rng = np.random.default_rng(20260804)
    base = rng.integers(0, 256, size=(n_requests, object_bytes),
                        dtype=np.uint8)
    if rtt_s is None:
        rtt_s = measure_rtt(device=dev)
    saved = _saved_dispatch_conf()
    pc = bench_perf_counters()
    occ_hist = g_perf_histograms.get(
        "dispatch", "dispatch_batch_occupancy_histogram",
        occupancy_axes)

    def one_pass(d: int, collect: Optional[List] = None) -> None:
        payloads = np.bitwise_xor(base, np.uint8(_next_salt() & 0xFF))
        if d <= 1:
            for i in range(n_requests):
                out = g_dispatcher.encode(sinfo, impl, payloads[i],
                                          want)
                if collect is not None:
                    collect.append(out)
            pc.inc(l_bench_dispatches, n_requests)
        else:
            done = [None] * n_requests
            inflight = [0]
            for i in range(n_requests):
                if inflight[0] >= d:
                    # the per-PG window is full: backpressure drains it
                    # by executing the batch inline (never by waiting)
                    g_dispatcher.flush()
                fut = g_dispatcher.submit_encode(sinfo, impl,
                                                 payloads[i], want)
                inflight[0] += 1

                def on_ready(f, i=i):
                    inflight[0] -= 1
                    done[i] = f.result()    # resolved: host buffers

                fut.add_done_callback(on_ready)
            g_dispatcher.flush()            # completion fence
            if any(r is None for r in done):
                raise RuntimeError("a pipelined encode never resolved")
            if collect is not None:
                collect.extend(done)
            pc.inc(l_bench_dispatches, (n_requests + d - 1) // d)
        pc.inc(l_bench_bytes, n_requests * object_bytes)

    def make_sampler(d: int, rounds: int):
        def sample() -> float:
            g_conf.set_val("ec_dispatch_batch_max", max(d, 1))
            g_conf.set_val("ec_dispatch_batch_window_us", 10**7)
            t0 = time.perf_counter()
            for _ in range(rounds):
                one_pass(d)
            dt = time.perf_counter() - t0
            pc.tinc(l_bench_fence_time, dt)
            return rounds * n_requests * object_bytes / dt / (1 << 30)

        return sample

    try:
        # byte-identity receipt: the same salted payloads through both
        # depths must produce identical chunk buffers
        salt_before = _SALT[0]
        g_conf.set_val("ec_dispatch_batch_max", depth)
        g_conf.set_val("ec_dispatch_batch_window_us", 10**7)
        piped: List = []
        one_pass(depth, collect=piped)
        _SALT[0] = salt_before          # replay the same inputs
        serial: List = []
        one_pass(1, collect=serial)
        identical = all(
            sorted(a) == sorted(b)
            and all(np.asarray(a[i]).tobytes()
                    == np.asarray(b[i]).tobytes() for i in a)
            for a, b in zip(piped, serial))
        results = {}
        flows = {}
        breakdowns = {}
        occupancy = None
        for d in (1, depth):
            make_sampler(d, 1)()        # warm
            t0 = time.perf_counter()
            make_sampler(d, 1)()
            per_pass = max(time.perf_counter() - t0, 1e-6)
            rounds = max(1, min(
                int(max(target_seconds / max(repeats, 1),
                        4.0 * rtt_s) / per_pass), 256))
            if d == depth:
                occ0 = (occ_hist.axis0_sum, occ_hist.total_count)
            flow0 = g_devprof.snapshot()
            stage0 = g_oplat.snapshot()
            wall_t0 = time.perf_counter()
            results[d] = repeat_measure(make_sampler(d, rounds),
                                        repeats=repeats, warmup=warmup)
            wall_s = time.perf_counter() - wall_t0
            n_ops = rounds * n_requests * (repeats + warmup)
            flows[d] = _devflow_since(flow0, n_ops)
            # depth-1's breakdown is device_call-dominated (every op
            # demands its own flush), depth-8 grows a real batch_window
            # share and its coverage approaches the achieved occupancy
            breakdowns[d] = _stage_breakdown_since(stage0, wall_s,
                                                   n_ops)
            if d == depth:
                ds = occ_hist.axis0_sum - occ0[0]
                dn = occ_hist.total_count - occ0[1]
                occupancy = round(ds / dn, 2) if dn else 0.0
    finally:
        _restore_dispatch_conf(saved)
        g_dispatcher.flush()
    platform, kind, ndev = _device_info(dev)
    mets = []
    for d, name in ((depth, "ec_pipeline_fenced"),
                    (1, "ec_pipeline_depth1_fenced")):
        st = results[d]
        rl = validate_reading(st["median"], EC_ENCODE_K8M4, platform,
                              kind, ndev)
        extra = {"n_requests": n_requests, "object_bytes": object_bytes,
                 "pipeline_depth": d, "platform": platform,
                 "devflow": flows[d],
                 "stage_breakdown": breakdowns[d]}
        if d == depth:
            extra["depth1_gibs"] = round(results[1]["median"], 4)
            extra["speedup"] = round(
                st["median"] / max(results[1]["median"], 1e-9), 3)
            extra["mean_batch_occupancy"] = occupancy
            extra["identical"] = bool(identical)
        mets.append(make_metric(name, st["median"], "GiB/s",
                                fenced=True, rtt_s=rtt_s, stats=st,
                                roofline=rl, extra=extra))
    return mets[0], mets[1]


def remap_crush_map(n_osds: int, uniform: bool):
    """``measure_crush_remap``'s map: ``n_osds`` OSDs in hosts of 20,
    straw2, (u) weights 0x10000 or (n) 0x8000 x {1..4} from
    default_rng(7), and one chooseleaf firstn rule over hosts.  Returns
    (CrushWrapper, rule number)."""
    from ..crush import CRUSH_BUCKET_STRAW2, CrushWrapper
    per_host = 20
    cw = CrushWrapper()
    cw.set_type_name(1, "host")
    cw.set_type_name(10, "root")
    hosts = []
    rng_w = np.random.default_rng(7)
    for h in range(n_osds // per_host):
        osds = list(range(h * per_host, (h + 1) * per_host))
        if uniform:
            ws = [0x10000] * per_host
        else:
            # heterogeneous drives: the draws divide by the item weight
            # (K7a's int64 quotient tables or multiply-high), not the
            # uniform level's i32 quotient table
            ws = [int(v) * 0x8000
                  for v in rng_w.integers(1, 5, size=per_host)]
        hosts.append(cw.add_bucket(CRUSH_BUCKET_STRAW2, 1, f"host{h}",
                                   osds, ws, id=-(h + 2)))
    cw.set_max_devices(n_osds)
    cw.add_bucket(CRUSH_BUCKET_STRAW2, 10, "default", hosts,
                  [0x10000 * per_host] * len(hosts), id=-1)
    return cw, cw.add_simple_rule("data", "default", "host", mode="firstn")


def measure_crush_remap(n_osds=1000, n_pgs=100_000, epochs=10,
                        uniform=True, partial=None, infix="",
                        debug=False, device="cuda"):
    """Remap ALL PGs after an epoch change.

    The workload is OSDMapMapping's per-epoch job (OSDMapMapping.h:17):
    the crush topology is unchanged (candidate tables cached on the
    device), one osd flips out per epoch (new weight vector), and the
    resolution re-derives every PG's mapping.  Reported:
      - wall: full ``map_batch`` (K7b and K6 on the card, the K7c delta
        fetch, the host patch) per epoch, median over ``epochs``;
      - device: ``exact_packed`` (K7b, then K6 over the x it flags, so
        every row is exact) launched back to back over ``epochs`` weight
        vectors already on the device, drained by a one-element copy of
        the LAST output (fence.drain's contract) — what a pipelined
        consumer pays per epoch.  The drain RTT is measured and
        reported; the un-subtracted total is also published.

      - host: the native C++ mapper (``native.NativeCrushMapper``) over
        the first 2000 x with every OSD in, extrapolated to all x.

    ``partial`` is the milestone callback: flat keys flush to the caller
    the moment they exist; the port adds ``crush@_host_replayed``, the x
    recomputed on the host (none: K6 finishes them on the device).
    Returns (wall_ms, dev_ms, host_ms, residual_fraction, rtt_ms,
    metrics).  A reading the schema refuses raises, and so does a failed
    build of the native library.
    """
    import sys
    from ..native import NativeCrushMapper
    from ..ops.crush_fast import compile_fast_rule
    dev = resolve_device(device)
    cw, rno = remap_crush_map(n_osds, uniform)
    xs = np.arange(n_pgs, dtype=np.uint32)
    w = np.full(n_osds, 0x10000, dtype=np.uint32)

    tmark = time.monotonic()

    def mark(label: str) -> None:
        nonlocal tmark
        if debug:
            now = time.monotonic()
            print(f"[crush-bench] {label}: {now - tmark:.1f}s",
                  file=sys.stderr)
            tmark = now

    def report(**kv) -> None:
        # *infix* keeps the uniform and nonuniform sections' keys distinct
        if partial is not None:
            partial({k.replace("@", infix): v for k, v in kv.items()})

    metrics = []

    # the native-host baseline first: pure C++ on the host
    nm = NativeCrushMapper(cw.crush)
    sample = 2000
    t0 = time.perf_counter()
    nm.do_rule_batch(rno, list(range(sample)), 3, [0x10000] * n_osds)
    host_ms = (time.perf_counter() - t0) * (n_pgs / sample) * 1000
    if uniform:
        report(crush_remap_native_host_ms=round(host_ms, 2))
    mark("native host baseline")

    fr = compile_fast_rule(cw.crush, rno, 3, device=dev)
    mark("compile_fast_rule (host tables)")
    fr.map_batch(xs, w)     # builds, candidate tables, full fetch
    mark("map_batch warm #1 (candidates + resolve)")
    wwarm = w.copy()
    wwarm[1] = 0
    fr.map_batch(xs, wwarm)  # warm the delta path too
    mark("map_batch warm #2 (delta)")
    # per-epoch wall time: one osd out per epoch.  map_batch's delta
    # path fetches only changed rows, so the wall is one resolve + one
    # small device->host transfer (OSDMapMapping's per-epoch job).
    flow_wall0 = g_devprof.snapshot()
    walls = []
    for e in range(epochs):
        w2 = w.copy()
        w2[(7 * e + 3) % n_osds] = 0
        t0 = time.perf_counter()
        fr.map_batch(xs, w2)
        walls.append((time.perf_counter() - t0) * 1000)
    wall_st = summarize(walls)
    wall_ms = wall_st["median"]
    devflow_wall = _devflow_since(flow_wall0, epochs)
    report(**{"crush_remap@_pgs": n_pgs,
              "crush_remap@_wall_ms": round(wall_ms, 2),
              "crush@_residual_fraction": fr.residual_fraction,
              "crush@_host_replayed": fr.host_replayed})
    mark("per-epoch wall loop")
    rtt_s = measure_rtt(device=dev)
    rtt_ms = rtt_s * 1000
    # sustained device resolve time: back-to-back launches drained by
    # copying one element of the LAST output; the stream runs them in
    # order, so that copy completing means every launch completed
    wds = []
    for e in range(epochs):
        w2 = w.copy()
        w2[(13 * e + 29) % n_osds] = 0
        wds.append(torch.from_numpy(w2.view(np.int32)).to(dev))
    fr.exact_packed(wds[0])[0, 0].cpu()              # warm + drain
    mark("exact_packed warm")
    pc = bench_perf_counters()
    flow_dev0 = g_devprof.snapshot()
    stage_dev0 = g_oplat.snapshot()
    t0 = time.perf_counter()
    with g_devprof.stage("crush.resolve"):
        outs = [fr.exact_packed(wd) for wd in wds]
    t_issued = time.perf_counter()
    outs[-1][0, 0].cpu()
    t_end = time.perf_counter()
    total = (t_end - t0) * 1000
    devflow_dev = _devflow_since(flow_dev0, epochs)
    # stage split of the sustained region: back-to-back launches
    # (device_call) vs the one-element drain copy (d2h)
    g_oplat.record("bench", "device_call", (t_issued - t0) * 1e6)
    g_oplat.record("bench", "d2h", (t_end - t_issued) * 1e6)
    stage_bd_dev = _stage_breakdown_since(stage_dev0, t_end - t0,
                                          epochs)
    pc.inc(l_bench_dispatches, len(wds))
    pc.inc(l_bench_fences)
    pc.tinc(l_bench_fence_time, total / 1000.0)
    mark("sustained resolve loop")
    # The fenced total includes exactly one drain round trip.  Publish
    # BOTH the raw per-epoch figure and the RTT (never silently
    # subtract); the rtt-corrected figure is derived and floored at
    # one launch's worth so "fast" can never read as "didn't run".
    dev_ms_raw = total / len(wds)
    dev_ms = max((total - rtt_ms), 0.0) / len(wds)
    if round(dev_ms * 1000.0, 2) <= 0.0:
        # resolves faster than one round trip: the subtraction is all
        # noise — report the honest upper bound
        dev_ms = dev_ms_raw
    kv = {"crush_remap@_us": round(dev_ms * 1000.0, 2),
          "crush_remap@_us_raw": round(dev_ms_raw * 1000.0, 2)}
    if uniform:
        kv["transport_rtt_ms"] = round(rtt_ms, 2)
    report(**kv)
    name_sfx = infix or ""
    metrics.append(make_metric(
        f"crush_remap{name_sfx}_device", dev_ms, "ms", fenced=True,
        rtt_s=rtt_s,
        stats={"n": len(wds), "median": dev_ms, "iqr": 0.0,
               "min": dev_ms, "max": dev_ms_raw},
        extra={"pgs": n_pgs, "n_osds": n_osds,
               "raw_ms": round(dev_ms_raw, 4),
               "devflow": devflow_dev,
               "stage_breakdown": stage_bd_dev}))
    metrics.append(make_metric(
        f"crush_remap{name_sfx}_wall", wall_ms, "ms", fenced=True,
        rtt_s=rtt_s, stats=wall_st,
        extra={"pgs": n_pgs, "n_osds": n_osds,
               "devflow": devflow_wall}))
    return wall_ms, dev_ms, host_ms, fr.residual_fraction, rtt_ms, metrics


# ---- the cluster workloads (MiniCluster, load/, recovery) -----------------
def measure_traffic(*, n_clients: int = 8, ops_per_client: int = 32,
                    read_fraction: float = 0.5, n_osds: int = 4,
                    pg_num: int = 8, mode: str = "closed",
                    rate_multipliers: Tuple[float, ...] = (),
                    admission_max: int = 0, seed: int = 20260803,
                    keep_completions: bool = False,
                    name: str = "traffic_harness_smoke",
                    progress=None) -> Dict[str, Any]:
    """The traffic-harness workload (load/, docs/QOS.md): N
    synthetic clients over the real messenger/client stack against a
    fresh replicated mini-cluster, per-client p50/p99/p999 out of the
    PerfHistogram machinery, byte-exact verification of every op.

    Fencing: the value is client-observed completions per wall second —
    the clock stops only when every reply's bytes have crossed back to
    the issuing client, which is the drain contract by construction
    (host-side fabric; no device dispatch is in the op path to
    acknowledge early).  No roofline model applies to scheduler
    throughput, so the verdict is ``unknown``, never silently ``ok``.
    The pool is replicated, as in the JAX workload: no kernel runs in
    its op path, so it takes no ``device``.
    """
    from ..cluster import MiniCluster
    from ..common.config import g_conf
    from ..load import TrafficSpec, run_traffic

    cluster = MiniCluster(n_osds=n_osds)
    cluster.create_replicated_pool("load", size=3, pg_num=pg_num)
    saved = g_conf.values.get("osd_op_queue_admission_max")
    saved_ret = g_conf.values.get("mgr_telemetry_retention")
    if admission_max:
        g_conf.set_val("osd_op_queue_admission_max", admission_max)
    # the whole-run rollup below needs the mgr's boot baseline sample
    # to SURVIVE the run's tick count — ring eviction would silently
    # truncate the "whole-run" window to its tail and under-report the
    # wall rates.  10k samples covers any max_rounds/tick_every shape
    # the harness can produce (one sample per cluster tick).
    g_conf.set_val("mgr_telemetry_retention", 10_000)
    flow0 = g_devprof.snapshot()
    stage0 = g_oplat.snapshot()
    try:
        res = run_traffic(cluster, TrafficSpec(
            pool="load", n_clients=n_clients,
            ops_per_client=ops_per_client, read_fraction=read_fraction,
            mode=mode, rate_multipliers=tuple(rate_multipliers),
            seed=seed, keep_completions=keep_completions),
            progress=progress)
        # end-of-run cluster rollup (mgr/telemetry.py): the window
        # spans the whole run — the boot-time baseline isolates this
        # cluster's deltas from earlier workloads' process-global
        # counts — so harness A/B comparisons (mesh dispatch,
        # zero-copy) read ONE cluster tail number per stage instead
        # of N per-daemon dumps
        wall_run_s = max(res.elapsed_s, 1e-3)
        cluster.clock += wall_run_s
        cluster.mgr.telemetry.tick(cluster.mgr, cluster.clock)
        roll = cluster.mgr.telemetry.rollup(
            window_s=cluster.clock + 1.0)
    finally:
        if admission_max:
            if saved is None:
                g_conf.rm_val("osd_op_queue_admission_max")
            else:
                g_conf.set_val("osd_op_queue_admission_max", saved)
        if saved_ret is None:
            g_conf.rm_val("mgr_telemetry_retention")
        else:
            g_conf.set_val("mgr_telemetry_retention", saved_ret)
    pc = bench_perf_counters()
    pc.inc(l_bench_bytes, res.bytes_moved)
    # the rollup window's dt mixes run_traffic's simulated tick
    # seconds with the final wall bump; rescale to WALL rates so the
    # A/B number is a real throughput figure (rate * span = the
    # window's counter delta, so this is exact, not a guess)
    wall_rates = {k: round(v * roll["span_s"] / wall_run_s, 4)
                  for k, v in roll["rates"].items()}
    cluster_rollup = {
        "oplat_p99_usec": roll["oplat_p99_usec"],
        "rates": wall_rates,
        "copies_per_op": roll["copies_per_op"],
        "slo": {check: st["state"]
                for check, st in roll["slo"].items()},
        "samples": roll["samples"],
        "span_s": roll["span_s"],
    }
    v = max(res.ops_per_sec, 1e-6)
    return make_metric(
        name, v, "ops/s", fenced=True,
        stats={"n": 1, "median": v, "iqr": 0.0, "min": v, "max": v},
        roofline={"verdict": "unknown", "suspect": False},
        extra={"n_clients": n_clients, "total_ops": res.total_ops,
               "devflow": _devflow_since(flow0, max(res.completed, 1)),
               # the op-path stage decomposition (admission -> queue
               # tiers -> service -> fan-out -> reply) over the run;
               # queued ops wait concurrently, so coverage can exceed 1
               "stage_breakdown": _stage_breakdown_since(
                   stage0, max(res.elapsed_s, 1e-9),
                   max(res.completed, 1)),
               "cluster_rollup": cluster_rollup,
               "completed": res.completed,
               "byte_exact": bool(res.byte_exact),
               "rounds": res.rounds,
               "elapsed_s": round(res.elapsed_s, 3),
               "throttled_total": res.throttled_total,
               "admission_rejections": res.admission_rejections,
               "max_intake_depth": res.max_intake_depth,
               # per-client percentiles in usec (PerfHistogram bucket
               # upper edges — the same series Prometheus exports)
               "per_client": res.per_client,
               "aggregate": res.aggregate,
               "errors": res.errors[:8]})


def measure_ec_write_zero_copy(*, n_osds: int = 6, k: int = 3,
                               m: int = 2, n_objects: int = 6,
                               stripes_per_object: int = 2,
                               pg_num: int = 8,
                               name: str = "ec_write_zero_copy",
                               device="cuda") -> Dict[str, Any]:
    """The zero-copy write path A/B (docs/DISPATCH.md "Zero-copy write
    path"): the same EC client writes through two fresh mini-clusters —
    device-RESIDENT (``os_memstore_device_bytes_max`` large: fused
    encode+crc, shard bodies stay in HBM as DeviceShard handles, zero
    body d2h) vs the BYTES twin (budget 0: today's host-bytes funnel) —
    with each leg's devflow captured over the write region only.

    The receipt is the ``zero_copy`` block, judged by regress.py's
    ZERO-COPY gate as absolute invariants: the resident leg's write-path
    d2h must stay under the devflow floor (512 B/op — the only fetch is
    the crc scalar), its copies_per_op must be STRICTLY below the bytes
    twin's (the deleted copies are the whole point), residency must have
    actually engaged (shard handles live in the store when the region
    closes), and read-backs — which materialize lazily, AFTER the delta
    capture — must be byte-exact on both legs and equal across them.

    Fencing: the write region's clock stops when every client ack has
    returned on the in-process fabric; the resident leg's encode path
    ends in the crc d2h fetch, which is itself a completion fence for
    the fused kernel (the scalar cannot come back before the shard
    bodies exist).  The pool's codec is the ``cuda`` plugin on the card;
    ``device="cpu"`` gives it ``backend=host`` (the plain versions)."""
    from ..cluster import MiniCluster
    from ..common.config import g_conf
    from ..ops import crc32c_device, fused_encode_crc, gf_pallas
    from ..os_store.device_shard import g_device_budget

    # the kernels' launch counters, read around each leg's write region:
    # the resident leg takes K5, or K1 then K4 where the one-pass form
    # does not fit the shape; the bytes twin takes K1
    kernels = {"gf_bit_matmul": gf_pallas.launches,
               "crc32c": crc32c_device.launches,
               "fused_encode_crc": fused_encode_crc.launches}
    width = k * int(g_conf.get_val("osd_pool_erasure_code_stripe_unit"))
    object_bytes = stripes_per_object * width
    rng = np.random.default_rng(20260807)
    payloads = [rng.integers(0, 256, size=object_bytes,
                             dtype=np.uint8).tobytes()
                for _ in range(n_objects)]
    saved = g_conf.values.get("os_memstore_device_bytes_max")
    pc = bench_perf_counters()
    legs: Dict[str, Dict[str, Any]] = {}
    read_backs: Dict[str, list] = {}
    try:
        for leg, budget in (("resident", 1 << 30), ("bytes_twin", 0)):
            g_conf.set_val("os_memstore_device_bytes_max", budget)
            cluster = MiniCluster(n_osds=n_osds)
            cluster.create_ec_pool("zc", k=k, m=m, pg_num=pg_num,
                                   extra_profile=backend_profile(device))
            cl = cluster.client(f"client.zc_{leg}")
            flow0 = g_devprof.snapshot()
            stage0 = g_oplat.snapshot()
            n0 = {n: c.n for n, c in kernels.items()}
            t0 = time.perf_counter()
            for i, data in enumerate(payloads):
                rc = cl.write_full("zc", f"obj-{i}", data)
                assert rc == 0, f"write_full rc={rc}"
            wall_s = max(time.perf_counter() - t0, 1e-9)
            launched = {n: c.n - n0[n] for n, c in kernels.items()}
            # the gated receipt: flow over the WRITE region only —
            # read-backs (below) materialize resident shards, and that
            # d2h is the read path's to pay, not the write path's
            flow = _devflow_since(flow0, n_objects)
            breakdown = _stage_breakdown_since(stage0, wall_s,
                                               n_objects)
            resident_shards = g_device_budget.resident_shards()
            read_backs[leg] = [cl.read("zc", f"obj-{i}")
                               for i in range(n_objects)]
            legs[leg] = {"devflow": flow, "stage_breakdown": breakdown,
                         "wall_s": wall_s,
                         "resident_shards": resident_shards,
                         "launches": launched,
                         "ops_per_sec": round(n_objects / wall_s, 2)}
            pc.inc(l_bench_bytes, n_objects * object_bytes)
    finally:
        if saved is None:
            g_conf.rm_val("os_memstore_device_bytes_max")
        else:
            g_conf.set_val("os_memstore_device_bytes_max", saved)
    byte_exact = all(
        bytes(read_backs["resident"][i]) == payloads[i]
        and bytes(read_backs["bytes_twin"][i]) == payloads[i]
        for i in range(n_objects))
    res_flow = legs["resident"]["devflow"]
    twin_flow = legs["bytes_twin"]["devflow"]
    zero_copy = {
        "resident": res_flow,
        "bytes_twin": twin_flow,
        "resident_d2h_bytes_per_op": round(
            res_flow["d2h_bytes"] / max(n_objects, 1), 2),
        "resident_copies_per_op": res_flow["copies_per_op"],
        "twin_copies_per_op": twin_flow["copies_per_op"],
        "resident_shards": legs["resident"]["resident_shards"],
        "byte_exact": bool(byte_exact),
        # the port's own receipt (the JAX block has no launch counts):
        # each leg's kernel launches over its write region
        "launches": {leg: legs[leg]["launches"] for leg in legs},
    }
    v = legs["resident"]["ops_per_sec"]
    return make_metric(
        name, v, "ops/s", fenced=True,
        stats={"n": 1, "median": v, "iqr": 0.0, "min": v, "max": v},
        roofline={"verdict": "unknown", "suspect": False},
        extra={"n_objects": n_objects, "object_bytes": object_bytes,
               "k": k, "m": m,
               "devflow": res_flow,
               "stage_breakdown": legs["resident"]["stage_breakdown"],
               "twin_ops_per_sec": legs["bytes_twin"]["ops_per_sec"],
               "twin_devflow": twin_flow,
               "twin_stage_breakdown":
                   legs["bytes_twin"]["stage_breakdown"],
               "zero_copy": zero_copy})


def measure_recovery_storm(*, k: int = 8, m: int = 4, d: int = 10,
                           n_osds: int = 0, pg_num: int = 4,
                           n_objects: int = 8,
                           object_bytes: int = 4096,
                           n_clients: int = 4,
                           ops_per_client: int = 12,
                           seed: int = 20260804,
                           name: str = "ec_recovery_storm",
                           device="cuda") -> Dict[str, Any]:
    """The recovery-storm workload (docs/RECOVERY.md): kill an OSD
    under open-loop harness traffic and measure
    bytes-moved-per-repaired-shard for the regenerating codec family
    vs the RS full-stripe baseline — the repair-bandwidth claim as a
    gated number, with the well-behaved clients' cluster_rollup
    per-stage p99 + SLO state captured DURING the backfill.

    Shape: one cluster, two EC pools over the same object set —
    ``storm_rs`` (cuda plugin, classic RS matrix) and ``storm_regen``
    (product-matrix regenerating, repair via d sub-chunk helper
    contributions).  The traffic harness drives open-loop clients
    against the RS pool while the event schedule kills + outs one
    acting OSD mid-run; backfill to the spare rebuilds its shards on
    BOTH pools through the recovery scheduler, which tallies bytes
    moved per codec family.  Fencing: all figures are client-observed
    or counter deltas on the host-side fabric — no device dispatch can
    acknowledge early — and the byte-exact read-back of every
    pre-populated object after backfill is the correctness receipt.
    Both codecs run on the card; ``device="cpu"`` gives them
    ``backend=host`` (the plain versions).
    """
    from ..cluster import MiniCluster
    from ..common.config import g_conf
    from ..load import TrafficSpec, run_traffic
    from ..recovery import aggregate_families

    if not n_osds:
        n_osds = k + m + 2              # one spare + one margin
    cluster = MiniCluster(n_osds=n_osds)
    cluster.create_ec_pool("storm_rs", k=k, m=m, pg_num=pg_num,
                           plugin="cuda",
                           extra_profile=backend_profile(device))
    cluster.create_ec_pool("storm_regen", k=k, m=m, pg_num=pg_num,
                           plugin="regenerating",
                           extra_profile={"d": str(d),
                                          **backend_profile(device)})
    cl = cluster.client("client.storm")
    rng = np.random.default_rng(seed)
    bodies: Dict[str, bytes] = {}
    for i in range(n_objects):
        body = rng.integers(0, 256, object_bytes,
                            dtype=np.uint8).tobytes()
        bodies[f"storm-{i}"] = body
        for pool in ("storm_rs", "storm_regen"):
            assert cl.write_full(pool, f"storm-{i}", body) == 0
    # victim: an OSD acting for EC PGs in both pools, so ONE failure
    # drives both families' repair paths
    votes: Dict[int, int] = {}
    for _pgid, pg in cluster.primary_pgs():
        if pg.backend is not None:
            for o in pg.acting:
                if o >= 0:
                    votes[o] = votes.get(o, 0) + 1
    victim = max(sorted(votes), key=lambda o: votes[o])
    fam_before = aggregate_families(cluster.osds.values())
    saved_slo = g_conf.values.get("mgr_slo_oplat_p99_usec")
    saved_ret = g_conf.values.get("mgr_telemetry_retention")
    # a generous latency objective makes "no TPU_SLO_OPLAT during the
    # storm" a real (armed) assertion instead of a vacuous one
    g_conf.set_val("mgr_slo_oplat_p99_usec", "reply:2000000")
    g_conf.set_val("mgr_telemetry_retention", 10_000)
    flow0 = g_devprof.snapshot()
    stage0 = g_oplat.snapshot()
    slo_seen: Dict[str, str] = {}
    try:
        spec = TrafficSpec(
            pool="storm_rs", n_clients=n_clients,
            ops_per_client=ops_per_client, read_fraction=0.5,
            mode="open", rate=4.0, seed=seed,
            keep_completions=False,
            events=((2, "osd_kill", victim), (3, "osd_out", victim)))
        res = run_traffic(cluster, spec)
        # drive backfill to completion under the post-storm map
        for _ in range(16):
            cluster.tick(dt=1.0)
            states = set(cluster.pg_states().values())
            if states <= {"active"}:
                break
        wall_run_s = max(res.elapsed_s, 1e-3)
        cluster.clock += wall_run_s
        cluster.mgr.telemetry.tick(cluster.mgr, cluster.clock)
        roll = cluster.mgr.telemetry.rollup(
            window_s=cluster.clock + 1.0)
        slo_seen = {check: st["state"]
                    for check, st in roll["slo"].items()}
    finally:
        if saved_slo is None:
            g_conf.rm_val("mgr_slo_oplat_p99_usec")
        else:
            g_conf.set_val("mgr_slo_oplat_p99_usec", saved_slo)
        if saved_ret is None:
            g_conf.rm_val("mgr_telemetry_retention")
        else:
            g_conf.set_val("mgr_telemetry_retention", saved_ret)
    # byte-exact read-back of every pre-populated object AFTER backfill
    # (both pools) — the storm's correctness receipt
    identical = True
    for oid, body in bodies.items():
        for pool in ("storm_rs", "storm_regen"):
            if cl.read(pool, oid) != body:
                identical = False
    fam_after = aggregate_families(cluster.osds.values())
    # incident forensics receipt: a plain OSD kill raises no mgr
    # health check (health() counts down osds inline), so the storm
    # stamps an operator capture — the bundle still carries the
    # osd_down/osd_out journal events and the post-backfill state
    inc_mgr = cluster.mgr.incident
    if inc_mgr.captures_total == 0:
        inc_mgr.capture("operator", "post-storm forensic snapshot",
                        reason="operator")
    incidents = inc_mgr.receipt()

    from ..recovery.scheduler import FAMILY_KEYS

    def _delta(fam: str) -> Dict[str, float]:
        a = fam_after.get(fam, {})
        b = fam_before.get(fam, {})
        out = {key: a.get(key, 0) - b.get(key, 0)
               for key in FAMILY_KEYS}
        out["bytes_per_repaired_shard"] = round(
            out["bytes_moved"] / max(out["repaired_shards"], 1), 2)
        return out

    regen = _delta("pm-regen")
    rs = _delta("isa-matrix")
    ratio = regen["bytes_per_repaired_shard"] / \
        max(rs["bytes_per_repaired_shard"], 1e-9)
    pc = bench_perf_counters()
    pc.inc(l_bench_bytes, res.bytes_moved)
    wall_rates = {key: round(v * roll["span_s"] / wall_run_s, 4)
                  for key, v in roll["rates"].items()}
    cluster_rollup = {
        "oplat_p99_usec": roll["oplat_p99_usec"],
        "rates": wall_rates,
        "copies_per_op": roll["copies_per_op"],
        "slo": slo_seen,
        "samples": roll["samples"],
        "span_s": roll["span_s"],
    }
    v = max(regen["bytes_per_repaired_shard"], 1e-6)
    return make_metric(
        name, v, "B/shard", fenced=True,
        stats={"n": 1, "median": v, "iqr": 0.0, "min": v, "max": v},
        roofline={"verdict": "unknown", "suspect": False},
        extra={
            "recovery": {
                "bytes_per_repaired_shard_regen":
                    regen["bytes_per_repaired_shard"],
                "bytes_per_repaired_shard_rs":
                    rs["bytes_per_repaired_shard"],
                "regen_vs_rs_ratio": round(ratio, 4),
                "families": {"pm-regen": regen, "isa-matrix": rs},
            },
            "k": k, "m": m, "d": d, "victim_osd": victim,
            "identical": identical,
            "byte_exact_traffic": bool(res.byte_exact),
            "traffic_completed": res.completed,
            "slo": slo_seen,
            "incidents": incidents,
            "cluster_rollup": cluster_rollup,
            "devflow": _devflow_since(
                flow0, max(regen["repaired_shards"]
                           + rs["repaired_shards"], 1)),
            "stage_breakdown": _stage_breakdown_since(
                stage0, wall_run_s,
                max(regen["repaired_shards"]
                    + rs["repaired_shards"], 1)),
            "errors": res.errors[:8],
        })


def _launches() -> Dict[str, int]:
    """K1's and K9x's launch counts so far (the mesh workloads record
    their deltas as a ``launches`` block)."""
    from ..ops import gf_pallas, mesh_xor
    return {"gf_bit_matmul": gf_pallas.launches.n,
            "mesh_xor": mesh_xor.launches.n}


def _launches_since(before: Dict[str, int]) -> Dict[str, int]:
    return {n: v - before[n] for n, v in _launches().items()}


def _mesh_codec(k: int, m: int, device):
    """The reed_sol_van ``cuda`` plugin of the mesh workloads (the JAX
    package's ``tpu``), with ``backend=host`` when the caller asks for
    the CPU: a codec rides the mesh only on its own platform."""
    from ..ec.cuda_plugin import ErasureCodeCuda
    impl = ErasureCodeCuda()
    impl.init({"k": str(k), "m": str(m), "technique": "reed_sol_van",
               **backend_profile(device)})
    return impl


def _mesh_dispatch_receipt(mesh_chips: int, n_requests: int,
                           object_bytes: int, device="cuda"
                           ) -> Dict[str, Any]:
    """The mesh workload's correctness + occupancy receipt, taken
    through the REAL dispatch path: the same coalesced k8m4 encode
    batch through the scheduler with the mesh on vs the single-device
    twin (mesh off), outputs byte-compared shard by shard, per-chip
    stripe deltas read back from the runtime.  Runs outside the timed
    region — receipts must not pollute the fenced numbers."""
    from ..common.config import g_conf
    from ..dispatch import g_dispatcher
    from ..mesh import g_mesh
    from ..ops import gf_pallas

    impl, _dev, sinfo, want = _dispatch_codec(device, object_bytes)
    rng = np.random.default_rng(20260805)
    payloads = [rng.integers(0, 256, size=object_bytes, dtype=np.uint8)
                for _ in range(n_requests)]
    saved = {name: g_conf.values.get(name) for name in
             ("ec_dispatch_batch_max", "ec_dispatch_batch_window_us",
              "ec_mesh_chips")}

    def run_batch():
        futs = [g_dispatcher.submit_encode(sinfo, impl, p, want)
                for p in payloads]
        g_dispatcher.flush()
        return [f.result() for f in futs]

    try:
        g_conf.set_val("ec_dispatch_batch_max", n_requests)
        g_conf.set_val("ec_dispatch_batch_window_us", 10**7)
        g_conf.set_val("ec_mesh_chips", 0)
        single = run_batch()
        g_conf.set_val("ec_mesh_chips", mesh_chips)
        chips0 = {i: v["stripes"] for i, v in g_mesh.per_chip().items()}
        k1_0 = gf_pallas.launches.n
        meshed = run_batch()
        k1_launches = gf_pallas.launches.n - k1_0
        per_chip = {i: v["stripes"] - chips0.get(i, 0)
                    for i, v in g_mesh.per_chip().items()}
        identical = all(
            sorted(a) == sorted(b)
            and all(np.asarray(a[i]).tobytes()
                    == np.asarray(b[i]).tobytes() for i in a)
            for a, b in zip(meshed, single))
        dump = g_mesh.dump()
        return {"identical": bool(identical),
                "per_chip_stripes": per_chip,
                "mesh_size": dump["size"],
                "plan_cache": len(dump["plans"]),
                "pool": dump["pool"],
                "k1_launches": k1_launches}
    finally:
        for name, v in saved.items():
            g_conf.rm_val(name) if v is None else g_conf.set_val(name, v)
        g_dispatcher.flush()


def measure_ec_mesh(matrix: np.ndarray, *, mesh_chips: int = 8,
                    chunk: int = 8192, n_requests: int = 8,
                    object_bytes: int = 65536,
                    target_seconds: float = 0.3, repeats: int = 3,
                    warmup: int = 1, rtt_s: Optional[float] = None,
                    n_steps: Optional[int] = None, device="cuda"
                    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """k=8,m=4 encodes across the dispatch mesh vs a single-device
    twin (``mesh/``, docs/DISPATCH.md "Mesh-sharded dispatch").

    Two legs of the SAME salted GF bit-matmul step: ``ec_mesh_fenced``
    runs it over a 1-D batch-axis mesh of *mesh_chips* members (each
    launching on its own stream), completion-fenced via
    ``drain_sharded`` — one readback from EVERY member, because a mesh
    output is only proven complete per member — and validated by
    ``mesh_roofline`` (chip peaks scaled by distinct devices: members
    sharing one card read 1x);
    ``ec_mesh_single_fenced`` is the identical step on one device
    under the standard drain.  The RTT is measured and reported, never
    subtracted; inputs are salted per dispatch.

    The mesh metric also carries the dispatch-path receipt
    (``_mesh_dispatch_receipt``): byte-identity of a coalesced batch
    through the real scheduler with the mesh on vs off, and the
    per-chip stripe occupancy the flush produced — every chip of the
    smoke mesh must show work.
    """
    from ..mesh.topology import batch_mesh

    dev = resolve_device(device)
    launches0 = _launches()
    mesh = batch_mesh(mesh_chips, platform=dev.type)
    batch_s = 2 * mesh.size
    rng = np.random.default_rng(20260806)
    batch = rng.integers(0, 256, size=(batch_s, K, chunk),
                         dtype=np.uint8)
    bits = encode_bitmatrix(matrix, dev)
    if rtt_s is None:
        rtt_s = measure_rtt(device=dev)
    # a PINNED step count (smoke) keeps the twin's fence-flow per-op
    # figures deterministic round over round; None (full mode)
    # calibrates the region like every other fenced workload
    m_single = _measure_fenced_gf(
        bits, batch, metric_name="ec_mesh_single_fenced",
        workload=EC_ENCODE_K8M4, kernel_name="bench_mesh_single_fenced",
        target_seconds=target_seconds, repeats=repeats, warmup=warmup,
        rtt_s=rtt_s, n_steps=n_steps)
    m_mesh = _measure_fenced_gf(
        bits, batch, metric_name="ec_mesh_fenced",
        workload=EC_ENCODE_K8M4, kernel_name="bench_mesh_fenced",
        target_seconds=target_seconds, repeats=repeats, warmup=warmup,
        rtt_s=rtt_s, mesh=mesh, n_steps=n_steps)
    receipt = _mesh_dispatch_receipt(mesh_chips, n_requests,
                                     object_bytes, device=dev)
    m_mesh["mesh_chips"] = mesh.size
    m_mesh["single_gibs"] = round(m_single["value"], 4)
    m_mesh["speedup"] = round(
        m_mesh["value"] / max(m_single["value"], 1e-9), 3)
    m_mesh.update(receipt)
    m_mesh["launches"] = _launches_since(launches0)
    return m_mesh, m_single


def measure_mesh_skew(*, mesh_chips: int = 8, slow_chip: int = 5,
                      delay_us: int = 30_000, threshold: float = 3.0,
                      healthy_flushes: int = 4, max_probes: int = 10,
                      n_requests: int = 3, chunk: int = 1024, k: int = 4,
                      m: int = 2, n_stripes: int = 2,
                      name: str = "ec_mesh_skew",
                      device="cuda") -> Dict[str, Any]:
    """The straggler ruler (docs/OBSERVABILITY.md "Per-chip timing &
    skew health"): run the mesh twin healthy vs one-chip-slowed and
    measure what the chip-health scoreboard SEES — skew ratio at
    detection, per-chip p99 spread, and detection latency in probes.

    Shape: a mini cluster (the mgr must tick DURING the run — the
    TPU_MESH_SKEW raise/clear is part of the measurement) with an
    8-chip mesh and ``ec_mesh_skew_sample_every=1``; coalesced k4m2
    encode flushes drive the dispatch path directly.  Leg 1 (healthy):
    N flushes, the scoreboard must stay quiet — zero false suspects is
    a gated assertion, not a hope.  Leg 2 (slowed): the fault registry
    arms ``mesh.chip_slowdown`` on exactly *slow_chip* with a
    *delay_us* stall (~10x the healthy CPU probe delta) and the run
    counts flushes until the scoreboard marks a suspect; the suspect
    must be exactly the slowed chip, TPU_MESH_SKEW must raise while
    the mgr ticks, and after the fault clears the check must clear
    again.  Every flush's output is byte-compared against the
    single-request oracle (skew sampling must never touch the data
    path).  bench/regress.py's SKEW GATE enforces the detection
    window, the exact-chip verdict and the quiet healthy twin.

    Members that share one card (or the CPU) share its cores, so the
    HEALTHY per-member spread here is calibration only.
    """
    from ..cluster import MiniCluster
    from ..common.config import g_conf
    from ..dispatch import g_dispatcher
    from ..fault import g_faults
    from ..mesh import g_chipstat, g_mesh
    from ..osd.ecutil import encode as eu_encode, stripe_info_t

    saved = {opt: g_conf.values.get(opt) for opt in
             ("ec_mesh_chips", "ec_dispatch_batch_max",
              "ec_dispatch_batch_window_us",
              "ec_mesh_skew_sample_every", "ec_mesh_skew_threshold")}
    g_conf.set_val("ec_mesh_chips", mesh_chips)
    g_conf.set_val("ec_dispatch_batch_max", 64)
    g_conf.set_val("ec_dispatch_batch_window_us", 10**7)
    g_conf.set_val("ec_mesh_skew_sample_every", 1)
    g_conf.set_val("ec_mesh_skew_threshold", threshold)

    cluster = MiniCluster(n_osds=4)
    impl = _mesh_codec(k, m, device)
    sinfo = stripe_info_t(k, k * chunk)
    want = set(range(k + m))
    rng = np.random.default_rng(20260804)
    flow0 = g_devprof.snapshot()
    launches0 = _launches()
    stage0 = g_oplat.snapshot()
    t_wall0 = time.perf_counter()

    n_flushes = [0]

    def flush_once() -> bool:
        """One coalesced mesh flush, byte-checked vs the oracle."""
        n_flushes[0] += 1
        payloads = [rng.integers(0, 256, size=n_stripes * k * chunk,
                                 dtype=np.uint8)
                    for _ in range(n_requests)]
        oracles = [eu_encode(sinfo, impl, p, want) for p in payloads]
        futs = [g_dispatcher.submit_encode(sinfo, impl, p, want)
                for p in payloads]
        g_dispatcher.flush()
        ok = True
        for f, oracle in zip(futs, oracles):
            res = f.result()
            ok = ok and sorted(res) == sorted(oracle) and all(
                np.asarray(res[i]).tobytes()
                == np.asarray(oracle[i]).tobytes() for i in oracle)
        cluster.tick(dt=1.0)     # the mgr judges DURING the run
        return ok

    def spread(pcts: Dict[int, Dict[str, float]]) -> float:
        # max p99 over the mesh-median p99, with the scoreboard's own
        # median rule so the two surfaces cannot drift
        from ..mesh.chipstat import ChipStat
        p99s = [p["p99"] for p in pcts.values() if p["p99"] > 0]
        if not p99s:
            return 0.0
        med = ChipStat._median(p99s)
        return round(max(p99s) / max(med, 1e-9), 3)

    identical = True
    try:
        identical &= flush_once()          # compile warmup
        g_chipstat.reset()                 # drop compile-era samples
        # ---- leg 1: healthy twin ----------------------------------------
        for _ in range(healthy_flushes):
            identical &= flush_once()
        healthy_false_suspects = len(g_chipstat.suspects())
        healthy_raised = "TPU_MESH_SKEW" in cluster.mgr.health_checks
        healthy_spread = spread(g_chipstat.per_chip_percentiles())
        healthy_max_ratio = max(
            (r["skew_ratio"] for r in
             g_chipstat.summary()["per_chip"].values()), default=0.0)
        # ---- leg 2: one chip slowed -------------------------------------
        g_chipstat.reset()
        g_faults.inject("mesh.chip_slowdown", mode="always",
                        match=f"chip={slow_chip}/", delay_us=delay_us)
        detection_probes = 0
        for i in range(1, max_probes + 1):
            identical &= flush_once()
            if g_chipstat.suspects():
                detection_probes = i
                break
        suspects = g_chipstat.suspects()
        detected_chip = suspects[0]["chip"] if suspects else -1
        skew_ratio_detected = suspects[0]["skew_ratio"] if suspects \
            else 0.0
        raised = "TPU_MESH_SKEW" in cluster.mgr.health_checks
        raised_message = cluster.mgr.health_checks.get(
            "TPU_MESH_SKEW", "")
        slowed_spread = spread(g_chipstat.per_chip_percentiles())
        # ---- leg 3: fault removed, the check must clear -----------------
        g_faults.clear("mesh.chip_slowdown")
        cleared = False
        for _ in range(4 * max_probes):
            identical &= flush_once()
            if not g_chipstat.suspects() \
                    and "TPU_MESH_SKEW" not in \
                    cluster.mgr.health_checks:
                cleared = True
                break
        n_probes_total = g_chipstat.summary()["probes"]
    finally:
        g_faults.clear("mesh.chip_slowdown")
        for opt, v in saved.items():
            g_conf.rm_val(opt) if v is None else g_conf.set_val(opt, v)
        g_dispatcher.flush()
        g_mesh.topology()
        # the scoreboard is process-global: a residual suspect (a run
        # whose clear leg failed) must not raise TPU_MESH_SKEW in the
        # unrelated workloads that follow this one
        g_chipstat.reset()
    wall_s = max(time.perf_counter() - t_wall0, 1e-3)
    # EXACT op count for the gated per-op blocks: the clear leg's
    # flush count varies with how fast the EWMA streaks settle, so
    # reconstructing it would make copies_per_op wobble round-to-round
    n_ops = n_flushes[0] * n_requests
    v = max(skew_ratio_detected, 1e-6)
    return make_metric(
        name, v, "ratio", fenced=True,
        stats={"n": 1, "median": v, "iqr": 0.0, "min": v, "max": v},
        roofline={"verdict": "unknown", "suspect": False},
        extra={
            "skew": {
                "mesh_chips": mesh_chips,
                "slow_chip": slow_chip,
                "delay_us": delay_us,
                "threshold": threshold,
                "detected_chip": detected_chip,
                "skew_ratio_detected": skew_ratio_detected,
                "detection_probes": detection_probes,
                "healthy_false_suspects": healthy_false_suspects,
                "healthy_raised": bool(healthy_raised),
                "healthy_max_ratio": healthy_max_ratio,
                "healthy_p99_spread": healthy_spread,
                "slowed_p99_spread": slowed_spread,
                "raised": bool(raised),
                "cleared": bool(cleared),
                "probes_total": n_probes_total,
            },
            "identical": bool(identical),
            "launches": _launches_since(launches0),
            "raised_message": raised_message,
            "devflow": _devflow_since(flow0, max(n_ops, 1)),
            "stage_breakdown": _stage_breakdown_since(
                stage0, wall_s, max(n_ops, 1)),
        })


def measure_mesh_straggler(*, mesh_chips: int = 8, slow_chip: int = 5,
                           delay_us: int = 30_000, threshold: float = 3.0,
                           n_flushes: int = 24, detect_max: int = 10,
                           n_requests: int = 3, chunk: int = 1024,
                           k: int = 4, m: int = 2, n_stripes: int = 2,
                           unprotected_flushes: int = 6,
                           name: str = "ec_mesh_straggler",
                           device="cuda") -> Dict[str, Any]:
    """The straggler-proof encode A/B (docs/DISPATCH.md "Rateless
    coded encode"): the flagship robustness claim — with one chip
    slowed 10x, the rateless-coded mesh keeps cluster_rollup
    ``device_call`` p999 next to the healthy twin's, where the
    block-sharded path pays the whole delay on every probing flush.

    Four legs on one mini cluster (the mgr ticks after EVERY flush, so
    each phase's cluster_rollup window isolates that phase's
    histogram deltas):

    1. **healthy** (rateless on): N coalesced flushes; phase
       rollup yields the healthy ``device_call`` p999 and the devprof
       site deltas yield the coded-bandwidth overhead the healthy
       twin pays for protection (parity h2d over systematic h2d —
       gated < 2x).
    2. **detect** (``mesh.chip_slowdown`` armed on exactly
       *slow_chip*): flushes until the scoreboard marks the suspect —
       ``skew_ratio_detected`` is the injected-degradation receipt
       the gate requires, ``detection_probes`` bounds the transient.
    3. **protected steady state** (fault still armed, chip now
       SUSPECT): N more flushes; the phase rollup's ``device_call``
       p999 over the healthy twin's is ``protected_p999_ratio`` — the
       gated claim.  Rollup percentiles are log2-bucket edges, so the
       companion ``protected_p999_wall_ratio`` (exact per-flush wall
       times) carries the unquantized figure.
    4. **unprotected twin** (rateless OFF, fault still armed): a few
       flushes through the block-sharded path, whose every-flush
       probe genuinely waits out the delay — the ~10x p999 the fix
       exists to kill, reported for contrast.

    Every flush's outputs are byte-compared against the unprotected
    single-device oracle (subset completion + host re-solves must be
    invisible in the bytes), and the protected legs must record zero
    single-device fallbacks (the port has none; the counter is read as
    the JAX workload reads it) — completion comes from the surviving
    subset.
    """
    from ..cluster import MiniCluster
    from ..common.config import g_conf
    from ..dispatch import g_dispatcher
    from ..fault import g_faults
    from ..mesh import (g_chipstat, g_mesh, rateless_perf_counters)
    from ..mesh.runtime import l_mesh_fallbacks, mesh_perf_counters
    from ..osd.ecutil import encode as eu_encode, stripe_info_t

    saved = {opt: g_conf.values.get(opt) for opt in
             ("ec_mesh_chips", "ec_dispatch_batch_max",
              "ec_dispatch_batch_window_us",
              "ec_mesh_skew_sample_every", "ec_mesh_skew_threshold",
              "ec_mesh_rateless", "ec_mesh_rateless_tasks")}
    g_conf.set_val("ec_mesh_chips", mesh_chips)
    g_conf.set_val("ec_dispatch_batch_max", 64)
    g_conf.set_val("ec_dispatch_batch_window_us", 10**7)
    g_conf.set_val("ec_mesh_skew_sample_every", 1)
    g_conf.set_val("ec_mesh_skew_threshold", threshold)
    g_conf.set_val("ec_mesh_rateless", True)

    cluster = MiniCluster(n_osds=4)
    impl = _mesh_codec(k, m, device)
    sinfo = stripe_info_t(k, k * chunk)
    want = set(range(k + m))
    rng = np.random.default_rng(20260804)
    flow0 = g_devprof.snapshot()
    launches0 = _launches()
    stage0 = g_oplat.snapshot()
    t_wall0 = time.perf_counter()
    n_flushes_total = [0]
    identical = [True]

    def flush_once() -> float:
        """One coalesced mesh flush, byte-checked vs the oracle;
        returns the wall seconds of the submit->resolve section (the
        oracle encode and the byte compare run outside the clock)."""
        n_flushes_total[0] += 1
        payloads = [rng.integers(0, 256, size=n_stripes * k * chunk,
                                 dtype=np.uint8)
                    for _ in range(n_requests)]
        oracles = [eu_encode(sinfo, impl, p, want) for p in payloads]
        t0 = time.perf_counter()
        futs = [g_dispatcher.submit_encode(sinfo, impl, p, want)
                for p in payloads]
        g_dispatcher.flush()
        results = [f.result() for f in futs]
        wall = time.perf_counter() - t0
        for res, oracle in zip(results, oracles):
            ok = sorted(res) == sorted(oracle) and all(
                np.asarray(res[i]).tobytes()
                == np.asarray(oracle[i]).tobytes() for i in oracle)
            identical[0] = identical[0] and ok
        cluster.tick(dt=1.0)     # the mgr rolls up DURING the run
        return wall

    def phase(n: int):
        """Run *n* flushes as one cluster_rollup window; returns
        (device_call percentiles from the phase rollup, wall p999)."""
        cluster.tick(dt=1.0)            # the window's baseline sample
        clock0 = cluster.clock
        walls = [flush_once() for _ in range(n)]
        # window anchored ON the baseline sample: the newest sample at
        # least (span - 0.5) old is exactly the clock0 tick (samples
        # land on 1.0-spaced ticks), so the rollup deltas cover THIS
        # phase's flushes and nothing earlier
        roll = cluster.mgr.telemetry.rollup(
            window_s=cluster.clock - clock0 - 0.5)
        dc = roll.get("oplat", {}).get("device_call", {})
        walls.sort()
        p999_wall = walls[min(int(np.ceil(0.999 * len(walls))) - 1,
                              len(walls) - 1)]
        return dc, p999_wall * 1e6

    def wasted_ratio(c0: Dict[str, int]) -> float:
        c1 = rateless_perf_counters().dump()
        coded = c1["coded_tasks"] - c0["coded_tasks"]
        parity = c1["parity_tasks"] - c0["parity_tasks"]
        return round(coded / max(coded - parity, 1), 4)

    try:
        flush_once()                    # compile warmup
        g_chipstat.reset()
        rl0 = rateless_perf_counters().dump()
        mesh_fb0 = mesh_perf_counters().get(l_mesh_fallbacks)
        # ---- leg 1: healthy twin, rateless on ---------------------------
        sites0 = {s: dict(v) for s, v in
                  g_devprof.dump()["sites"].items()}
        healthy_dc, healthy_wall_p999 = phase(n_flushes)
        sites1 = g_devprof.dump()["sites"]

        def h2d_delta(site: str) -> int:
            return (sites1.get(site, {}).get("h2d_bytes", 0)
                    - sites0.get(site, {}).get("h2d_bytes", 0))

        sys_h2d = h2d_delta("mesh.encode")
        parity_h2d = h2d_delta("mesh.rateless_parity")
        bandwidth_overhead = round(
            (sys_h2d + parity_h2d) / max(sys_h2d, 1), 4)
        healthy_false_suspects = len(g_chipstat.suspects())
        # ---- leg 2: slow one chip, count probes to detection ------------
        g_faults.inject("mesh.chip_slowdown", mode="always",
                        match=f"chip={slow_chip}/", delay_us=delay_us)
        detection_probes = 0
        for i in range(1, detect_max + 1):
            flush_once()
            if g_chipstat.suspects():
                detection_probes = i
                break
        suspects = g_chipstat.suspects()
        detected_chip = suspects[0]["chip"] if suspects else -1
        skew_ratio_detected = suspects[0]["skew_ratio"] if suspects \
            else 0.0
        # ---- leg 3: protected steady state (chip SUSPECT, still slow) --
        slowed_dc, slowed_wall_p999 = phase(n_flushes)
        subset_completions = (rateless_perf_counters().dump()
                              ["subset_completions"]
                              - rl0["subset_completions"])
        chip_failures = (rateless_perf_counters().dump()
                         ["chip_failures"] - rl0["chip_failures"])
        fallbacks = mesh_perf_counters().get(l_mesh_fallbacks) \
            - mesh_fb0
        coded_overhead = wasted_ratio(rl0)
        # ---- leg 4: the unprotected twin (block-sharded SPMD path) ------
        g_conf.set_val("ec_mesh_rateless", False)
        flush_once()       # SPMD plan compile warmup, outside the clock
        unprot_dc, unprot_wall_p999 = phase(unprotected_flushes)
        g_conf.set_val("ec_mesh_rateless", True)
    finally:
        g_faults.clear("mesh.chip_slowdown")
        for opt, v in saved.items():
            g_conf.rm_val(opt) if v is None else g_conf.set_val(opt, v)
        g_dispatcher.flush()
        g_mesh.topology()
        # process-global scoreboard: a leftover suspect must not haunt
        # the workloads that follow (the skew workload's policy)
        g_chipstat.reset()
    # incident forensics receipt: the detect/protected legs raise
    # TPU_MESH_SKEW through the ticked mgr, which auto-captures a
    # bundle; the operator fallback only fires if detection never did
    inc_mgr = cluster.mgr.incident
    if inc_mgr.captures_total == 0:
        inc_mgr.capture("operator", "straggler forensic snapshot",
                        reason="operator")
    incidents = inc_mgr.receipt()
    wall_s = max(time.perf_counter() - t_wall0, 1e-3)
    n_ops = n_flushes_total[0] * n_requests
    healthy_p999 = float(healthy_dc.get("p999", 0.0) or 0.0)
    slowed_p999 = float(slowed_dc.get("p999", 0.0) or 0.0)
    unprot_p999 = float(unprot_dc.get("p999", 0.0) or 0.0)
    ratio = round(slowed_p999 / max(healthy_p999, 1e-9), 4)
    wall_ratio = round(slowed_wall_p999 / max(healthy_wall_p999, 1e-9),
                       4)
    v = max(wall_ratio, 1e-6)
    return make_metric(
        name, v, "ratio", fenced=True,
        stats={"n": 1, "median": v, "iqr": 0.0, "min": v, "max": v},
        roofline={"verdict": "unknown", "suspect": False},
        extra={
            "straggler": {
                "mesh_chips": mesh_chips,
                "slow_chip": slow_chip,
                "delay_us": delay_us,
                "threshold": threshold,
                "detection_probes": detection_probes,
                "detected_chip": detected_chip,
                "skew_ratio_detected": skew_ratio_detected,
                "healthy_false_suspects": healthy_false_suspects,
                "healthy_p999_usec": healthy_p999,
                "slowed_p999_usec": slowed_p999,
                "unprotected_p999_usec": unprot_p999,
                "protected_p999_ratio": ratio,
                "protected_p999_wall_ratio": wall_ratio,
                "healthy_p999_wall_usec": round(healthy_wall_p999, 1),
                "slowed_p999_wall_usec": round(slowed_wall_p999, 1),
                "unprotected_p999_wall_usec": round(unprot_wall_p999,
                                                    1),
                "unprotected_p999_wall_ratio": round(
                    unprot_wall_p999 / max(healthy_wall_p999, 1e-9),
                    4),
                "bandwidth_overhead": bandwidth_overhead,
                "coded_task_overhead": coded_overhead,
                "subset_completions": int(subset_completions),
                "chip_failures": int(chip_failures),
                "single_device_fallbacks": int(fallbacks),
                "byte_identical": bool(identical[0]),
            },
            "identical": bool(identical[0]),
            "launches": _launches_since(launches0),
            "incidents": incidents,
            "devflow": _devflow_since(flow0, max(n_ops, 1)),
            "stage_breakdown": _stage_breakdown_since(
                stage0, wall_s, max(n_ops, 1)),
        })


def measure_degraded_read(*, mesh_chips: int = 8, slow_chip: int = 5,
                          delay_us: int = 30_000, threshold: float = 3.0,
                          n_batches: int = 16, detect_max: int = 10,
                          n_objects: int = 4, object_bytes: int = 4096,
                          k: int = 4, m: int = 2,
                          n_clients: int = 4, ops_per_client: int = 8,
                          meshoff_batches: int = 6,
                          seed: int = 20260807,
                          name: str = "ec_degraded_read",
                          device="cuda") -> Dict[str, Any]:
    """The straggler-proof degraded-read A/B (docs/DISPATCH.md
    "Mesh-sharded degraded reads"): kill a data-shard OSD under
    open-loop harness traffic, then drive every read of the pool
    through the meshed rateless decode path with one chip slowed 10x —
    the read-side twin of ``ec_mesh_straggler``, judged by the same
    STRAGGLER GATE.

    Shape: one pg_num=1 EC pool so a single OSD kill (acting[1] — a
    non-primary DATA shard) degrades every object; the traffic harness
    lands the kill mid-run (open-loop clients stay byte-exact through
    it), after which the cluster never backfills (down, not out) and
    each read is a fresh survivor-sharded decode.  Four legs on the
    degraded cluster, each a cluster_rollup window like the encode
    twin's:

    1. **healthy** (mesh on, rateless on): N read batches; phase
       rollup yields the healthy ``device_call`` p999 and the
       DECODE_SITES h2d deltas yield the coded-bandwidth overhead
       (parity over systematic — gated < 2x).
    2. **detect** (``mesh.chip_slowdown`` armed on *slow_chip*): read
       batches until the scoreboard marks the suspect from decode
       probes alone — no write traffic to help.
    3. **protected steady state** (fault armed, chip SUSPECT): N more
       batches; ``device_call`` p999 over the healthy twin's is the
       gated ``protected_p999_ratio``, wall p999 the unquantized
       companion.
    4. **mesh-off twin** (``ec_mesh_chips=1`` via the checked-set
       membership transition): the single-device decode baseline the
       tentpole replaced, reported as the stage_breakdown A/B
       (``device_call``/``d2h`` per-op, mesh-on vs mesh-off).

    Every read byte-compared against the pre-populated body; the
    protected legs must record zero ``mesh_decode_fallbacks`` (the port
    has no fallback; read as the JAX workload reads it) — completion
    comes from the first spanning subset.
    """
    from ..cluster import MiniCluster
    from ..common.config import g_conf
    from ..fault import g_faults
    from ..load import TrafficSpec, run_traffic
    from ..mesh import g_chipstat, g_mesh, rateless_perf_counters
    from ..mesh.runtime import (l_mdec_fallbacks,
                                mesh_decode_perf_counters)

    saved = {opt: g_conf.values.get(opt) for opt in
             ("ec_mesh_chips", "ec_mesh_skew_sample_every",
              "ec_mesh_skew_threshold", "ec_mesh_rateless",
              "ec_mesh_rateless_tasks")}
    g_conf.set_val("ec_mesh_chips", mesh_chips)
    g_conf.set_val("ec_mesh_skew_sample_every", 1)
    g_conf.set_val("ec_mesh_skew_threshold", threshold)
    g_conf.set_val("ec_mesh_rateless", True)

    cluster = MiniCluster(n_osds=k + m + 2)
    cluster.create_ec_pool("dread", k=k, m=m, pg_num=1, plugin="cuda",
                           extra_profile=backend_profile(device))
    cl = cluster.client("client.dread")
    rng = np.random.default_rng(seed)
    bodies: Dict[str, bytes] = {}
    for i in range(n_objects):
        body = rng.integers(0, 256, object_bytes,
                            dtype=np.uint8).tobytes()
        bodies[f"dread-{i}"] = body
        assert cl.write_full("dread", f"dread-{i}", body) == 0
    pool_id = cluster.mon.osdmap.lookup_pg_pool_name("dread")
    acting = next(pg.acting for pgid, pg in cluster.primary_pgs()
                  if pg.backend is not None and pgid[0] == pool_id)
    victim = acting[1]                  # non-primary DATA shard
    flow0 = g_devprof.snapshot()
    launches0 = _launches()
    stage0 = g_oplat.snapshot()
    t_wall0 = time.perf_counter()
    n_batches_total = [0]
    identical = [True]

    def read_batch() -> float:
        """One batch of degraded reads (every object, byte-compared);
        returns the wall seconds of the read section."""
        n_batches_total[0] += 1
        t0 = time.perf_counter()
        got = [cl.read("dread", oid) for oid in bodies]
        wall = time.perf_counter() - t0
        for g, body in zip(got, bodies.values()):
            identical[0] = identical[0] and g == body
        cluster.tick(dt=1.0)     # the mgr rolls up DURING the run
        return wall

    def phase(n: int):
        """Run *n* read batches as one cluster_rollup window; returns
        (device_call percentiles from the phase rollup, wall p999) —
        the anchored-window pattern of measure_mesh_straggler."""
        cluster.tick(dt=1.0)
        clock0 = cluster.clock
        walls = [read_batch() for _ in range(n)]
        roll = cluster.mgr.telemetry.rollup(
            window_s=cluster.clock - clock0 - 0.5)
        dc = roll.get("oplat", {}).get("device_call", {})
        walls.sort()
        p999_wall = walls[min(int(np.ceil(0.999 * len(walls))) - 1,
                              len(walls) - 1)]
        return dc, p999_wall * 1e6

    def stage_pair(before, wall_s: float, n_ops: int) -> Dict[str, Any]:
        sb = _stage_breakdown_since(before, max(wall_s, 1e-3),
                                    max(n_ops, 1))
        stages = sb.get("stages") or {}
        return {st: stages.get(st, {}) for st in ("device_call", "d2h")}

    try:
        # ---- the storm: open-loop traffic, kill landing mid-run ------
        spec = TrafficSpec(
            pool="dread", n_clients=n_clients,
            ops_per_client=ops_per_client, read_fraction=0.5,
            mode="open", rate=4.0, seed=seed, keep_completions=False,
            events=((1, "osd_kill", victim),))
        res = run_traffic(cluster, spec)
        traffic_byte_exact = bool(res.byte_exact)
        read_batch()                    # decode compile warmup
        g_chipstat.reset()
        mdec0 = mesh_decode_perf_counters().get(l_mdec_fallbacks)
        # ---- leg 1: healthy twin, meshed rateless decode -------------
        sites0 = {s: dict(v) for s, v in
                  g_devprof.dump()["sites"].items()}
        on0 = g_oplat.snapshot()
        t_on0 = time.perf_counter()
        healthy_dc, healthy_wall_p999 = phase(n_batches)
        sites1 = g_devprof.dump()["sites"]

        def h2d_delta(site: str) -> int:
            return (sites1.get(site, {}).get("h2d_bytes", 0)
                    - sites0.get(site, {}).get("h2d_bytes", 0))

        sys_h2d = h2d_delta("mesh.decode")
        parity_h2d = h2d_delta("mesh.decode_parity")
        bandwidth_overhead = round(
            (sys_h2d + parity_h2d) / max(sys_h2d, 1), 4)
        healthy_false_suspects = len(g_chipstat.suspects())
        # ---- leg 2: slow one chip, detect from decode probes alone ---
        rl0 = rateless_perf_counters().dump()
        g_faults.inject("mesh.chip_slowdown", mode="always",
                        match=f"chip={slow_chip}/", delay_us=delay_us)
        detection_probes = 0
        for i in range(1, detect_max + 1):
            read_batch()
            if g_chipstat.suspects():
                detection_probes = i
                break
        suspects = g_chipstat.suspects()
        detected_chip = suspects[0]["chip"] if suspects else -1
        skew_ratio_detected = suspects[0]["skew_ratio"] if suspects \
            else 0.0
        # ---- leg 3: protected steady state (chip SUSPECT, slow) ------
        slowed_dc, slowed_wall_p999 = phase(n_batches)
        n_on_ops = n_batches_total[0] * n_objects
        twin_on = stage_pair(on0, time.perf_counter() - t_on0,
                             n_on_ops)
        subset_completions = (rateless_perf_counters().dump()
                              ["subset_completions"]
                              - rl0["subset_completions"])
        fallbacks = mesh_decode_perf_counters().get(l_mdec_fallbacks) \
            - mdec0
        # ---- leg 4: the mesh-off twin (single-device decode) ---------
        g_conf.set_checked("ec_mesh_chips", 1)
        read_batch()                    # single-device compile warmup
        off0 = g_oplat.snapshot()
        t_off0 = time.perf_counter()
        batches_before = n_batches_total[0]
        unprot_dc, unprot_wall_p999 = phase(meshoff_batches)
        twin_off = stage_pair(
            off0, time.perf_counter() - t_off0,
            (n_batches_total[0] - batches_before) * n_objects)
    finally:
        g_faults.clear("mesh.chip_slowdown")
        for opt, v in saved.items():
            g_conf.rm_val(opt) if v is None else g_conf.set_val(opt, v)
        g_mesh.topology()
        g_chipstat.reset()
    inc_mgr = cluster.mgr.incident
    if inc_mgr.captures_total == 0:
        inc_mgr.capture("operator", "degraded-read forensic snapshot",
                        reason="operator")
    incidents = inc_mgr.receipt()
    wall_s = max(time.perf_counter() - t_wall0, 1e-3)
    n_ops = n_batches_total[0] * n_objects
    healthy_p999 = float(healthy_dc.get("p999", 0.0) or 0.0)
    slowed_p999 = float(slowed_dc.get("p999", 0.0) or 0.0)
    unprot_p999 = float(unprot_dc.get("p999", 0.0) or 0.0)
    ratio = round(slowed_p999 / max(healthy_p999, 1e-9), 4)
    wall_ratio = round(slowed_wall_p999 / max(healthy_wall_p999, 1e-9),
                       4)
    v = max(wall_ratio, 1e-6)
    return make_metric(
        name, v, "ratio", fenced=True,
        stats={"n": 1, "median": v, "iqr": 0.0, "min": v, "max": v},
        roofline={"verdict": "unknown", "suspect": False},
        extra={
            "straggler": {
                "mesh_chips": mesh_chips,
                "slow_chip": slow_chip,
                "delay_us": delay_us,
                "threshold": threshold,
                "detection_probes": detection_probes,
                "detected_chip": detected_chip,
                "skew_ratio_detected": skew_ratio_detected,
                "healthy_false_suspects": healthy_false_suspects,
                "healthy_p999_usec": healthy_p999,
                "slowed_p999_usec": slowed_p999,
                "meshoff_p999_usec": unprot_p999,
                "protected_p999_ratio": ratio,
                "protected_p999_wall_ratio": wall_ratio,
                "healthy_p999_wall_usec": round(healthy_wall_p999, 1),
                "slowed_p999_wall_usec": round(slowed_wall_p999, 1),
                "meshoff_p999_wall_usec": round(unprot_wall_p999, 1),
                "bandwidth_overhead": bandwidth_overhead,
                "subset_completions": int(subset_completions),
                "single_device_fallbacks": int(fallbacks),
                "byte_identical": bool(identical[0]
                                       and traffic_byte_exact),
            },
            "victim_osd": victim,
            "identical": bool(identical[0]),
            "launches": _launches_since(launches0),
            "byte_exact_traffic": traffic_byte_exact,
            "traffic_completed": res.completed,
            "twin": {"mesh_on": twin_on, "mesh_off": twin_off},
            "incidents": incidents,
            "devflow": _devflow_since(flow0, max(n_ops, 1)),
            "stage_breakdown": _stage_breakdown_since(
                stage0, wall_s, max(n_ops, 1)),
            "errors": res.errors[:8],
        })


# ---- the harnesses on the mesh (control/, chaos/) ---------------------------
def measure_slo_autotune(*, mesh_chips: int = 8, slow_chip: int = 5,
                         delay_us: int = 30_000,
                         tick_budget: int = 80,
                         seed: int = 20260807,
                         name: str = "slo_autotune",
                         device="cuda") -> Dict[str, Any]:
    """The closed-loop control-plane workload (docs/CONTROL.md): run
    the policy map's three scenarios — abusive client, recovery storm
    under an SLO burn, straggling chip — on real mini clusters with
    the mgr controller ENABLED and nothing else touching the knobs,
    and record the actuation receipts bench/regress.py's CONTROL GATE
    pins as absolute invariants:

    - each scenario RAISES its SLO/health pressure, the controller
      moves the responsible knob, and the episode CLEARS (knobs back
      at baseline) within *tick_budget* mgr ticks of the pressure
      ending — zero operator action;
    - every move in every ledger stays inside its knob's
      floor/ceiling;
    - a disabled-controller twin of the abusive-client leg makes ZERO
      moves (observe-only mgr by construction);
    - client ops stay byte-exact throughout (the control plane must
      never touch the data path).

    The metric value is the worst (largest) convergence tick count
    across the three scenarios — lower is a snappier control plane,
    and the CONTROL GATE's budget is the hard wall.

    The recovery leg's ``regenerating`` pool and the straggler leg's
    ``cuda`` codec (the JAX package's ``tpu``) run on the card;
    ``device="cpu"`` gives them ``backend=host``, the backend of a CPU
    mesh.  The ``launches`` block holds K1's and K9x's launch counts.
    """
    from ..cluster import MiniCluster
    from ..common.config import g_conf
    from ..dispatch import g_dispatcher
    from ..fault import g_faults
    from ..load import TrafficSpec, run_traffic
    from ..mesh import g_chipstat, g_mesh
    from ..osd.ecutil import encode as eu_encode, stripe_info_t

    saved = {opt: g_conf.values.get(opt) for opt in
             ("mgr_control_enable", "mgr_control_cooldown_ticks",
              "mgr_control_bounds", "mgr_slo_admission_rate_max",
              "mgr_slo_oplat_p99_usec", "mgr_slo_fast_window_s",
              "mgr_slo_slow_window_s", "mgr_telemetry_retention",
              "osd_op_queue_admission_max",
              "osd_mclock_client_overrides",
              "osd_mclock_class_overrides", "osd_recovery_max_active",
              "ec_mesh_chips", "ec_mesh_rateless",
              "ec_mesh_rateless_tasks", "ec_mesh_skew_sample_every",
              "ec_mesh_skew_threshold", "ec_dispatch_batch_max",
              "ec_dispatch_batch_window_us")}
    t_wall0 = time.perf_counter()
    flow0 = g_devprof.snapshot()
    launches0 = _launches()
    stage0 = g_oplat.snapshot()
    byte_exact = True
    receipts: list = []
    incident_blocks: Dict[str, Any] = {}

    def _leg_incidents(leg: str, cluster) -> None:
        # each leg's cluster is discarded on return, so the incident
        # receipt is harvested here; the health raise auto-captures,
        # and the operator fallback only fires if it never raised
        inc_mgr = cluster.mgr.incident
        if inc_mgr.captures_total == 0:
            inc_mgr.capture("operator", f"{leg} leg fallback capture",
                            reason="operator")
        incident_blocks[leg] = inc_mgr.receipt()

    def _slo_windows() -> None:
        g_conf.set_val("mgr_slo_fast_window_s", 6.0)
        g_conf.set_val("mgr_slo_slow_window_s", 12.0)
        g_conf.set_val("mgr_telemetry_retention", 10_000)

    def _in_bounds(ctl) -> bool:
        # pressure-driven moves must land inside [floor, ceiling];
        # restore/teardown moves walk back to the OPERATOR baseline,
        # which may legitimately sit outside the actuation corridor
        # (e.g. cap 0 = uncapped) — their invariant is "cleared"
        knobs = ctl.dump()["knobs"]
        return all(knobs[e["knob"]]["floor"] <= e["to"]
                   <= knobs[e["knob"]]["ceiling"]
                   for e in ctl._ledger
                   if e["reflex"] not in ("restore", "teardown"))

    def _abusive_run(cluster, ops_per_client=96):
        spec = TrafficSpec(pool="abuse", n_clients=4,
                           ops_per_client=ops_per_client,
                           read_fraction=0.25,
                           mode="open", rate=10.0,
                           rate_multipliers=(6.0, 1.0, 1.0, 1.0),
                           tick_every=1, seed=seed,
                           keep_completions=False)
        return run_traffic(cluster, spec)

    def leg_disabled_twin() -> int:
        """The abusive-client drive with the controller OFF: the mgr
        must be observe-only by construction — zero moves."""
        nonlocal byte_exact
        cluster = MiniCluster(n_osds=4)
        cluster.create_replicated_pool("abuse", size=2, pg_num=8)
        _slo_windows()
        g_conf.set_val("mgr_slo_admission_rate_max", 0.001)
        g_conf.set_val("osd_op_queue_admission_max", 4)
        res = _abusive_run(cluster, ops_per_client=48)
        byte_exact &= bool(res.byte_exact)
        for _ in range(8):
            cluster.tick(dt=1.0)
        return cluster.mgr.control.moves_total

    def leg_admission() -> Dict[str, Any]:
        nonlocal byte_exact
        cluster = MiniCluster(n_osds=4)
        cluster.create_replicated_pool("abuse", size=2, pg_num=8)
        g_conf.set_val("mgr_control_enable", True)
        g_conf.set_val("mgr_control_cooldown_ticks", 1)
        _slo_windows()
        g_conf.set_val("mgr_slo_admission_rate_max", 0.001)
        g_conf.set_val("osd_op_queue_admission_max", 4)
        res = _abusive_run(cluster)
        byte_exact &= bool(res.byte_exact)
        ctl = cluster.mgr.control
        tightens = [e for e in ctl._ledger
                    if e["reflex"] == "admission"]
        converge = -1
        for i in range(tick_budget):
            cluster.tick(dt=1.0)
            if "TPU_SLO_ADMISSION" not in cluster.mgr.health_checks \
                    and all(k["baseline"] is None for k in
                            ctl.dump()["knobs"].values()):
                converge = i + 1
                break
        receipts.extend(list(ctl._ledger)[-6:])
        _leg_incidents("admission", cluster)
        return {"raised": bool(tightens),
                "moves": ctl.moves_total,
                "abuser_correct": all("client.abuse.0" in e["reason"]
                                      for e in tightens),
                "cleared": converge >= 0,
                "converge_ticks": converge,
                "in_bounds": _in_bounds(ctl)}

    def leg_recovery() -> Dict[str, Any]:
        nonlocal byte_exact
        # k8m4/d10 mirrors measure_recovery_storm so the smoke tier
        # reuses its compiled encode/decode shapes
        cluster = MiniCluster(n_osds=14)
        cluster.create_ec_pool("rstorm", k=8, m=4, pg_num=4,
                               plugin="regenerating",
                               extra_profile={"d": "10",
                                              **backend_profile(device)})
        cl = cluster.client("client.rstorm")
        rng = np.random.default_rng(seed)
        bodies = {}
        for i in range(10):
            body = rng.integers(0, 256, 4096,
                                dtype=np.uint8).tobytes()
            bodies[f"o{i}"] = body
            assert cl.write_full("rstorm", f"o{i}", body) == 0
        g_conf.set_val("mgr_control_enable", True)
        g_conf.set_val("mgr_control_cooldown_ticks", 1)
        _slo_windows()
        g_conf.set_val("mgr_slo_oplat_p99_usec", "reply:1")
        base_active = int(g_conf.get_val("osd_recovery_max_active"))
        ctl = cluster.mgr.control
        # phase 1: the burn sustains under client IO, no storm yet
        for i in range(6):
            cl.write_full("rstorm", f"pre{i}", b"x" * 4096)
            cluster.tick(dt=1.0)
        raised = "TPU_SLO_OPLAT" in cluster.mgr.health_checks
        quiet_moves = ctl.moves_total        # burn alone: no move
        # phase 2: an OSD dies mid-burn -> the storm
        pid = cluster.mon.osdmap.lookup_pg_pool_name("rstorm")
        victim = next(pg.acting[-1]
                      for pgid, pg in cluster.primary_pgs()
                      if pgid[0] == pid and pg.backend is not None)
        cluster.kill_osd(victim)
        cluster.mark_osd_down(victim)
        cluster.mark_osd_out(victim)
        for i in range(8):
            cl.write_full("rstorm", f"live{i}", b"x" * 4096)
            cluster.tick(dt=1.0)
        storm_moves = [e for e in ctl._ledger
                       if e["reflex"] == "recovery"]
        # phase 3: quiesce -> the burn clears -> restore to baseline
        converge = -1
        for i in range(tick_budget):
            cluster.tick(dt=1.0)
            if "TPU_SLO_OPLAT" not in cluster.mgr.health_checks \
                    and int(g_conf.get_val("osd_recovery_max_active")) \
                    == base_active:
                converge = i + 1
                break
        for oid, body in bodies.items():
            byte_exact &= cl.read("rstorm", oid) == body
        receipts.extend(list(ctl._ledger)[-6:])
        _leg_incidents("recovery", cluster)
        return {"raised": raised,
                "moves": ctl.moves_total,
                "quiet_moves_before_storm": quiet_moves,
                "storm_moves": len(storm_moves),
                "cleared": converge >= 0,
                "converge_ticks": converge,
                "in_bounds": _in_bounds(ctl)}

    def leg_straggler() -> Dict[str, Any]:
        nonlocal byte_exact
        g_conf.set_val("ec_mesh_chips", mesh_chips)
        g_conf.set_val("ec_dispatch_batch_window_us", 10**7)
        g_conf.set_val("ec_dispatch_batch_max", 64)
        g_conf.set_val("ec_mesh_skew_sample_every", 1)
        g_conf.set_val("ec_mesh_skew_threshold", 3.0)
        g_conf.set_val("ec_mesh_rateless", True)
        g_conf.rm_val("ec_mesh_rateless_tasks")
        cluster = MiniCluster(n_osds=4)
        g_conf.set_val("mgr_control_enable", True)
        g_conf.set_val("mgr_control_cooldown_ticks", 1)
        g_conf.set_val("mgr_control_bounds",
                       f"ec_mesh_rateless_tasks:"
                       f"{mesh_chips + 1}:{mesh_chips + 4}")
        # k4m2 x 3-request x 2-stripe x 1KiB chunks mirrors
        # measure_mesh_skew so the smoke tier reuses its compiles
        impl = _mesh_codec(4, 2, device)
        sinfo = stripe_info_t(4, 4 * 1024)
        want = set(range(6))
        rng = np.random.default_rng(seed)

        def flush() -> None:
            nonlocal byte_exact
            payloads = [rng.integers(0, 256, size=2 * 4 * 1024,
                                     dtype=np.uint8)
                        for _ in range(3)]
            oracles = [eu_encode(sinfo, impl, p, want)
                       for p in payloads]
            futs = [g_dispatcher.submit_encode(sinfo, impl, p, want)
                    for p in payloads]
            g_dispatcher.flush()
            for f, oracle in zip(futs, oracles):
                res = f.result()
                byte_exact &= sorted(res) == sorted(oracle) and all(
                    np.asarray(res[i]).tobytes()
                    == np.asarray(oracle[i]).tobytes()
                    for i in oracle)

        flush()                            # compile warmup
        g_chipstat.reset()
        mesh_size = g_mesh.topology().size
        auto_width = mesh_size + 2
        ctl = cluster.mgr.control
        g_faults.inject("mesh.chip_slowdown", mode="always",
                        match=f"chip={slow_chip}/", delay_us=delay_us)
        widened_at, raised = -1, False
        try:
            for i in range(16):
                flush()
                cluster.tick(dt=1.0)
                raised |= "TPU_MESH_SKEW" in cluster.mgr.health_checks
                if int(g_conf.get_val("ec_mesh_rateless_tasks")
                       or 0) > auto_width:
                    widened_at = i + 1
                    break
        finally:
            g_faults.clear("mesh.chip_slowdown")
        peak = int(g_conf.get_val("ec_mesh_rateless_tasks") or 0)
        converge = -1
        for i in range(tick_budget):
            flush()
            cluster.tick(dt=1.0)
            width = int(g_conf.get_val("ec_mesh_rateless_tasks") or 0)
            peak = max(peak, width)
            if "TPU_MESH_SKEW" not in cluster.mgr.health_checks \
                    and width < peak:
                converge = i + 1
                break
        widths_ok = all(
            mesh_size + 1 <= e["to"] <= 2 * mesh_size
            for e in ctl._ledger
            if e["knob"] == "ec_mesh_rateless_tasks")
        receipts.extend(list(ctl._ledger)[-6:])
        _leg_incidents("straggler", cluster)
        return {"raised": raised,
                "moves": ctl.moves_total,
                "widen_ticks": widened_at,
                "peak_width": peak,
                "cleared": converge >= 0,
                "converge_ticks": converge,
                "in_bounds": _in_bounds(ctl) and widths_ok}

    try:
        disabled_moves = leg_disabled_twin()
        admission = leg_admission()
        recovery = leg_recovery()
        straggler = leg_straggler()
    finally:
        g_faults.clear()
        for opt, v in saved.items():
            g_conf.rm_val(opt) if v is None else g_conf.set_val(opt, v)
        g_dispatcher.flush()
        g_mesh.topology()
        g_chipstat.reset()
    wall_s = round(max(time.perf_counter() - t_wall0, 1e-3), 3)
    worst = max(admission["converge_ticks"],
                recovery["converge_ticks"],
                straggler["converge_ticks"])
    v = float(worst if worst > 0 else tick_budget + 1)
    return make_metric(
        name, v, "ticks", fenced=True,
        stats={"n": 1, "median": v, "iqr": 0.0, "min": v, "max": v},
        roofline={"verdict": "unknown", "suspect": False},
        extra={
            "control": {
                "disabled_moves": disabled_moves,
                "byte_exact": byte_exact,
                "tick_budget": tick_budget,
                "scenarios": {"admission": admission,
                              "recovery": recovery,
                              "straggler": straggler},
            },
            "incidents": incident_blocks,
            "receipts": receipts[-18:],
            "launches": _launches_since(launches0),
            "devflow": _devflow_since(flow0, max(len(receipts), 1)),
            "stage_breakdown": _stage_breakdown_since(
                stage0, wall_s, max(len(receipts), 1)),
            "wall_s": wall_s,
        })


def measure_composed_chaos(*, seeds: Tuple[int, ...] = (24, 103),
                           name: str = "composed_chaos",
                           device="cuda") -> Dict[str, Any]:
    """The composed-chaos workload (chaos/, docs/CHAOS.md):
    execute one seeded multi-fault storyline per entry in *seeds* on a
    fresh ticking MiniCluster under open-loop harness traffic, and
    record every receipt for bench/regress.py's CHAOS GATE, which pins
    the universal acceptance as absolute invariants:

    - every client op and every dispatcher oracle stays byte-exact
      through the whole storyline;
    - every health check the storyline promises — and every collateral
      raise — both RAISES and CLEARS with zero operator action;
    - every raise leaves a FINALIZED incident bundle whose gseq-ordered
      timeline tells the injected storyline back (or a journaled
      capture drop when losing the capture was itself the leg);
    - zero wedges (no storyline exhausts its settle budget) and zero
      mesh single-device fallbacks.

    The metric value is aggregate completed client ops/s across the
    seeds — a throughput floor for the whole chaos machinery, with the
    invariants carried in the ``chaos`` block.  The storylines run on
    the card; ``device="cpu"`` gives their codecs ``backend=host``.  The
    ``launches`` block holds K1's and K9x's launch counts.
    """
    from ..chaos import compose_scenario, run_scenario

    t0 = time.perf_counter()
    flow0 = g_devprof.snapshot()
    launches0 = _launches()
    stage0 = g_oplat.snapshot()
    receipts = []
    total_ops = 0
    for seed in seeds:
        r = run_scenario(compose_scenario(int(seed)), device=device)
        receipts.append(r)
        total_ops += int(r["ops_completed"])
    wall_s = round(max(time.perf_counter() - t0, 1e-3), 3)
    v = round(total_ops / wall_s, 2)
    return make_metric(
        name, v, "ops/s", fenced=True,
        stats={"n": len(receipts), "median": v, "iqr": 0.0,
               "min": v, "max": v},
        roofline={"verdict": "unknown", "suspect": False},
        extra={
            "chaos": {
                "seeds": [int(s) for s in seeds],
                "accepted": all(r["accepted"] for r in receipts),
                "receipts": receipts,
            },
            "launches": _launches_since(launches0),
            "devflow": _devflow_since(flow0, max(total_ops, 1)),
            "stage_breakdown": _stage_breakdown_since(
                stage0, wall_s, max(total_ops, 1)),
            "wall_s": wall_s,
        })
