"""``python -m ceph_tpu_torch.bench`` — run the fenced harness standalone.

Port of ``ceph_tpu/bench/__main__.py``.  Modes:

  --smoke       the CPU (``device="cpu"``, ``backend=host``), the JAX
                smoke shapes, seconds-fast: proves the harness itself
                (fence, stats, roofline, schema, dispatch, gate) end to
                end.  The CRUSH remap is left out here, as in the JAX
                smoke: its plain versions on the CPU blow a seconds-scale
                budget.
  (default)     the card: fenced EC encode and decode of a (64, 8,
                131072) batch, the parity check, the native host coder,
                dispatch coalescing (32 requests), the pipeline (64
                requests, depth 8) and the CRUSH remap (1000 OSDs,
                100000 PGs, 10 epochs, the native host mapper beside
                it).  No card raises.

  --gate off|warn|fail   compare fenced metrics against the archived
                BENCH_r*.json trajectory (regress.py), readings of the
                same platform only; "fail" exits 2 on a regression beyond
                --tolerance.

Output: ONE JSON line on stdout carrying schema-valid metrics; human
progress goes to stderr.  The line's ``not_ported`` names the JAX
bench's mesh and cluster workloads, which this CLI does not run until
the port has a mesh and a cluster.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

# the JAX bench's workloads that need a mesh or a cluster
NOT_PORTED = ("measure_ec_mesh", "measure_mesh_skew",
              "measure_mesh_straggler", "measure_traffic",
              "measure_ec_write_zero_copy", "measure_recovery_storm",
              "measure_degraded_read", "measure_composed_chaos",
              "measure_slo_autotune")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ceph_tpu_torch.bench")
    ap.add_argument("--smoke", action="store_true",
                    help="CPU, tiny shapes, seconds-fast harness check")
    ap.add_argument("--gate", choices=("off", "warn", "fail"),
                    default="warn")
    ap.add_argument("--tolerance", type=float, default=None,
                    help="relative regression tolerance (default 0.30)")
    ap.add_argument("--repeats", type=int, default=None)
    ap.add_argument("--root", default=None,
                    help="repo root holding BENCH_r*.json (default: "
                         "two levels above this package)")
    args = ap.parse_args(argv)

    t0 = time.monotonic()
    import numpy as np

    from . import regress
    from .workloads import (_device_info, bench_perf_counters,
                            measure_crush_remap, measure_decode,
                            measure_dispatch_coalesce, measure_ec_pipeline,
                            measure_encode, measure_host_native,
                            parity_check)
    from ..gf.matrices import gf_gen_rs_matrix

    K, M = 8, 4
    if args.smoke:
        device = "cpu"
        batch_s, chunk = 2, 8192
        target_s, repeats, warmup = 0.3, (args.repeats or 2), 1
    else:
        device = "cuda"
        batch_s, chunk = 64, 1 << 17
        target_s, repeats, warmup = 3.0, (args.repeats or 3), 1
    platform, kind, _ndev = _device_info(device)

    rng = np.random.default_rng(1234)
    matrix = gf_gen_rs_matrix(K + M, K)
    batch = rng.integers(0, 256, size=(batch_s, K, chunk),
                         dtype=np.uint8)

    result = {
        "schema_version": 1,
        "mode": "smoke" if args.smoke else "full",
        "platform": platform,
        "device_kind": kind,
        "metrics": [],
        "not_ported": list(NOT_PORTED),
    }

    def progress(msg: str) -> None:
        print(f"[bench] {msg}", file=sys.stderr)

    progress(f"platform={platform} {kind} batch=({batch_s},{K},{chunk})")
    rc = 0
    try:
        m = measure_encode(matrix, batch, target_seconds=target_s,
                           repeats=repeats, warmup=warmup, device=device)
        result["metrics"].append(m)
        progress(f"encode {m['value']} GiB/s fenced "
                 f"(roofline: {m['roofline']['verdict']})")
        m = measure_decode(matrix, batch, target_seconds=target_s,
                           repeats=repeats, warmup=warmup, device=device)
        result["metrics"].append(m)
        progress(f"decode {m['value']} GiB/s fenced "
                 f"(roofline: {m['roofline']['verdict']})")
        mc, ms = measure_dispatch_coalesce(
            n_requests=8 if args.smoke else 32,
            target_seconds=0.3 if args.smoke else 2.0,
            repeats=repeats, warmup=warmup, device=device)
        result["metrics"] += [mc, ms]
        progress(f"dispatch_coalesce {mc['value']} GiB/s coalesced vs "
                 f"{ms['value']} serial (x{mc['speedup']}, "
                 f"occupancy {mc['batch_occupancy']})")
        mp, mp1 = measure_ec_pipeline(
            n_requests=16 if args.smoke else 64,
            target_seconds=0.3 if args.smoke else 2.0,
            repeats=repeats, warmup=warmup, device=device)
        result["metrics"] += [mp, mp1]
        progress(f"ec_pipeline {mp['value']} GiB/s depth-8 vs "
                 f"{mp1['value']} depth-1 (x{mp['speedup']}, occupancy "
                 f"{mp['mean_batch_occupancy']}, identical "
                 f"{mp['identical']})")
        host = measure_host_native(matrix, batch[0],
                                   target_seconds=0.3 if args.smoke
                                   else 1.5)
        result["metrics"].append(host)
        progress(f"host_native {host['value']} GiB/s")
        if not args.smoke:
            keys: dict = {}
            wall_ms, dev_ms, host_ms, resid, rtt_ms, rm = \
                measure_crush_remap(1000, 100_000, 10, uniform=True,
                                    partial=keys.update, device=device)
            result["metrics"] += rm
            result["crush_remap"] = {
                "wall_ms": wall_ms, "dev_ms": dev_ms,
                "native_host_ms": host_ms, "residual_fraction": resid,
                "rtt_ms": rtt_ms, "keys": keys}
            progress(f"crush_remap wall {wall_ms:.3f} ms, device "
                     f"{dev_ms:.4f} ms, native host {host_ms:.1f} ms per "
                     f"epoch of 100000 PGs")
        result["decode_parity"] = parity_check(matrix, device=device)
        if not result["decode_parity"]:
            rc = 1
    except Exception as e:      # noqa: BLE001 — reported in the line
        traceback.print_exc(file=sys.stderr)
        result["error"] = repr(e)
        rc = 1

    if args.gate != "off":
        root = args.root or os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        traj = regress.load_trajectory(root)
        gate = regress.compare_against_trajectory(
            result["metrics"], traj, result["platform"],
            tolerance=(args.tolerance
                       if args.tolerance is not None
                       else regress.DEFAULT_TOLERANCE))
        result["gate"] = gate
        for r in gate["regressions"]:
            if r.get("unit") == "invariant":
                progress(f"REGRESSION {r['name']}: {r['value']} — "
                         f"{r['baseline']}")
                continue
            pct = f"{r['change']:+.0%}" if r.get("change") is not None \
                else "new-copies"
            progress(f"REGRESSION {r['name']}: {r['value']} vs "
                     f"r{r['baseline_round']} baseline {r['baseline']} "
                     f"({pct})")
        if gate["regressions"] and args.gate == "fail":
            rc = max(rc, 2)

    result["perf"] = bench_perf_counters().dump()
    # the same perf-histogram surface the admin socket's `perf histogram
    # dump` serves, scoped to this bench run
    from ..trace import g_devprof, g_oplat, g_perf_histograms
    result["perf_histograms"] = g_perf_histograms.dump("bench")
    # where the microseconds went, per daemon per stage
    result["oplat"] = g_oplat.dump()
    # which call sites moved how many bytes across the host<->device
    # boundary
    prof = g_devprof.dump()
    result["devprof"] = {"sites": prof["sites"],
                         "totals": prof["totals"]}
    result["elapsed_s"] = round(time.monotonic() - t0, 1)
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
