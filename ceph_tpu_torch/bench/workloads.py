"""Measurement bodies of the bench core: EC encode/decode and the CRUSH
remap, all through the fenced harness.

Port of the single-device, cluster-free part of
``ceph_tpu/bench/workloads.py``: ``measure_encode``, ``measure_decode``,
``parity_check`` and ``measure_crush_remap`` with the helpers they share.
Everything here returns schema metrics (schema.py) built from fenced
timings (fence.py), summarized over repeats (stats.py), and stamped with
a roofline verdict (roofline.py).  Per-kernel timings flow through
``common.kernel_trace.g_kernel_timer`` and per-run counters through the
``bench`` perf-counter logger.

Every entry point runs on the card unless the caller passes
``device="cpu"``.  The salted input (no layer can serve a repeat launch
from cache) and the fetch-drain fence are both load-bearing.

Not here yet: the mesh branch of ``_measure_fenced_gf`` (it raises until
the port has its mesh modules), ``measure_host_native`` and the remap's
native host baseline (they wait for the port's native library: the remap
reports ``host_ms`` None, decided before it runs), and the workloads
that need a cluster.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .fence import fenced_time, measure_rtt
from .roofline import (EC_DECODE_K8M4_SALTED, EC_ENCODE_K8M4_SALTED,
                       validate_reading)
from .schema import make_metric
from .stats import repeat_measure, summarize
from ..common.perf_counters import PerfCounters, PerfCountersBuilder
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
    decode differ only in the bitmatrix and the cost model.  The mesh
    form waits for the port's mesh modules and raises."""
    if mesh is not None:
        raise NotImplementedError("the meshed bench path waits for the "
                                  "port's mesh modules")
    dev = bits.device
    data = torch.from_numpy(np.ascontiguousarray(batch)).to(dev)
    step_fn = salted_matmul_step()
    step_fn(data, bits, 0)                       # first launch, builds
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
                                   rtt_s)
    flow0 = g_devprof.snapshot()
    stage0 = g_oplat.snapshot()
    wall_t0 = time.perf_counter()
    st = repeat_measure(
        lambda: _fenced_throughput(step, n_steps, bytes_per_step, rtt_s,
                                   kernel_name)[0],
        repeats=repeats, warmup=warmup)
    wall_s = time.perf_counter() - wall_t0
    n_ops = n_steps * (repeats + warmup)
    devflow = _devflow_since(flow0, n_ops)
    platform, kind, ndev = _device_info(dev)
    rl = validate_reading(st["median"], workload, platform, kind, ndev)
    return make_metric(
        metric_name, st["median"], "GiB/s", fenced=True,
        rtt_s=rtt_s, stats=st, roofline=rl,
        extra={"n_steps": n_steps, "bytes_per_step": bytes_per_step,
               "platform": platform, "n_devices": ndev,
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

    ``partial`` is the milestone callback: flat keys flush to the caller
    the moment they exist; the port adds ``crush@_host_replayed``, the x
    recomputed on the host (none: K6 finishes them on the device).
    Returns (wall_ms, dev_ms, host_ms, residual_fraction, rtt_ms,
    metrics); ``host_ms`` is None until the port has its native mapper.
    A reading the schema refuses raises.
    """
    import sys
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
    host_ms = None          # no native host baseline in the port yet

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
