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

Both modes then run the mesh workloads on 8 mesh members (members per
device from ``CEPH_TPU_TORCH_MESH_MEMBERS`` when it is set, else 8): the
mesh encode against one device, the skew ruler (regress.py's SKEW GATE),
the rateless straggler A/B and the degraded read (the STRAGGLER GATE);
and the three cluster workloads on a ``MiniCluster``: the traffic
harness (8 clients over a replicated pool), the zero-copy write A/B
(resident against the bytes twin, gated by regress.py's ZERO-COPY gate)
and the recovery storm (RS against regenerating, the recovery gate), at
the JAX CLI's shapes; and last the harnesses on top of the mesh: the SLO
autotune (the controller's three closed-loop scenarios, regress.py's
CONTROL GATE) and composed chaos (seeded storylines, the CHAOS GATE:
seed 24 in the smoke, seeds 24, 103, 196 and 20260807 on the card).
Members that share one card give parity and per-member launches, not
scaling.

  --gate off|warn|fail   compare fenced metrics against the archived
                BENCH_r*.json trajectory (regress.py), readings of the
                same platform only; "fail" exits 2 on a regression beyond
                --tolerance.

Output: ONE JSON line on stdout carrying schema-valid metrics; human
progress goes to stderr.  The line's ``not_ported`` names the JAX
bench's workloads this CLI does not run (none).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

# the JAX bench's workloads this CLI does not run
NOT_PORTED: tuple = ()


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
                            measure_composed_chaos,
                            measure_crush_remap, measure_decode,
                            measure_degraded_read,
                            measure_dispatch_coalesce, measure_ec_mesh,
                            measure_ec_pipeline,
                            measure_ec_write_zero_copy, measure_encode,
                            measure_host_native, measure_mesh_skew,
                            measure_mesh_straggler, measure_recovery_storm,
                            measure_slo_autotune, measure_traffic,
                            parity_check)
    from ..gf.matrices import gf_gen_rs_matrix
    from ..mesh import topology

    # the mesh workloads run on 8 members, as the JAX CLI's virtual
    # 8-device mesh does, unless the environment names a member count
    if topology.MEMBERS_ENV not in os.environ:
        topology.set_members_per_device(8)

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
        # the mesh runtime (mesh/): the same salted k8m4 encode step
        # across the batch-axis mesh vs one device, drained per member,
        # plus the dispatch-path identity/occupancy receipt
        mm, mm1 = measure_ec_mesh(
            matrix, mesh_chips=8 if args.smoke else -1,
            target_seconds=0.3 if args.smoke else 2.0,
            repeats=repeats, warmup=warmup,
            n_steps=3 if args.smoke else None, device=device)
        result["metrics"] += [mm, mm1]
        occupied = sum(1 for v in mm["per_chip_stripes"].values()
                       if v > 0)
        progress(f"ec_mesh {mm['value']} GiB/s over {mm['mesh_chips']} "
                 f"members vs {mm1['value']} single (x{mm['speedup']}, "
                 f"identical {mm['identical']}, "
                 f"members occupied {occupied}/{mm['mesh_chips']})")
        # the straggler ruler (mesh/chipstat): mesh twin healthy vs one
        # member slowed, scoreboard detection latency + TPU_MESH_SKEW
        # raise/clear gated by regress.py's SKEW GATE
        msk = measure_mesh_skew(device=device)
        result["metrics"].append(msk)
        sk = msk["skew"]
        progress(f"mesh_skew chip {sk['detected_chip']} at "
                 f"x{sk['skew_ratio_detected']} detected in "
                 f"{sk['detection_probes']} probes (healthy false "
                 f"suspects {sk['healthy_false_suspects']}, raised "
                 f"{sk['raised']}, cleared {sk['cleared']}, identical "
                 f"{msk['identical']})")
        # the straggler-proof encode A/B (mesh/rateless): rateless-coded
        # mesh healthy vs one member slowed 10x, gated by regress.py's
        # STRAGGLER GATE
        mst = measure_mesh_straggler(
            n_flushes=24 if args.smoke else 48, device=device)
        result["metrics"].append(mst)
        st = mst["straggler"]
        progress(f"mesh_straggler protected p999 "
                 f"x{st['protected_p999_ratio']} rollup / "
                 f"x{st['protected_p999_wall_ratio']} wall of healthy "
                 f"(unprotected x{st['unprotected_p999_wall_ratio']}, "
                 f"detected in {st['detection_probes']} probes, "
                 f"bw overhead x{st['bandwidth_overhead']}, "
                 f"subset completions {st['subset_completions']}, "
                 f"identical {mst['identical']})")
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
        # the traffic harness (load/): 8 concurrent synthetic clients
        # over the real client stack; the smoke shape is seconds on the
        # CPU, the full mode drives a deeper closed loop
        mt = measure_traffic(
            n_clients=8,
            ops_per_client=32 if args.smoke else 256,
            name="traffic_harness_smoke" if args.smoke
            else "traffic_harness")
        result["metrics"].append(mt)
        progress(f"traffic {mt['value']} ops/s over "
                 f"{mt['n_clients']} clients ({mt['total_ops']} ops, "
                 f"byte_exact {mt['byte_exact']}, agg p99 "
                 f"{mt['aggregate'].get('p99')}us)")
        roll = mt["cluster_rollup"]
        progress(f"cluster rollup: reply p99 "
                 f"{roll['oplat_p99_usec'].get('reply')}us, "
                 f"{roll['rates'].get('ops')} ops/s, slo {roll['slo']}")
        # the zero-copy write path: the device-resident shard store and
        # the fused encode+crc against the host-bytes twin, the devflow
        # A/B judged by regress.py's ZERO-COPY gate
        mz = measure_ec_write_zero_copy(
            n_objects=6 if args.smoke else 24, device=device)
        result["metrics"].append(mz)
        zc = mz["zero_copy"]
        progress(f"ec_write_zero_copy {mz['value']} ops/s resident vs "
                 f"{mz['twin_ops_per_sec']} bytes-twin "
                 f"(copies/op {zc['resident_copies_per_op']} vs "
                 f"{zc['twin_copies_per_op']}, resident d2h "
                 f"{zc['resident_d2h_bytes_per_op']} B/op, "
                 f"{zc['resident_shards']} shards resident, "
                 f"byte_exact {zc['byte_exact']})")
        # the recovery storm (recovery/): kill an OSD under open-loop
        # traffic, gate bytes-moved-per-repaired-shard for the
        # regenerating family against RS full-stripe
        mr = measure_recovery_storm(
            n_objects=6 if args.smoke else 24,
            ops_per_client=8 if args.smoke else 48, device=device)
        result["metrics"].append(mr)
        rec = mr["recovery"]
        progress(f"recovery_storm {rec['bytes_per_repaired_shard_regen']}"
                 f" B/shard regen vs {rec['bytes_per_repaired_shard_rs']}"
                 f" RS (ratio {rec['regen_vs_rs_ratio']}, identical "
                 f"{mr['identical']}, slo {mr['slo']})")
        # degraded-read A/B (mesh/): shard kill under open-loop traffic,
        # then meshed rateless decode healthy vs one member slowed 10x vs
        # the mesh-off single-device twin (the STRAGGLER GATE)
        md = measure_degraded_read(
            n_batches=10 if args.smoke else 32,
            ops_per_client=6 if args.smoke else 32, device=device)
        result["metrics"].append(md)
        sd = md["straggler"]
        progress(f"degraded_read protected p999 "
                 f"x{sd['protected_p999_ratio']} rollup / "
                 f"x{sd['protected_p999_wall_ratio']} wall of healthy "
                 f"(detected in {sd['detection_probes']} probes, "
                 f"bw overhead x{sd['bandwidth_overhead']}, "
                 f"subset completions {sd['subset_completions']}, "
                 f"fallbacks {sd['single_device_fallbacks']}, "
                 f"identical {md['identical']})")
        # the self-tuning control plane (control/): the three closed-loop
        # scenarios on real clusters, the actuation receipts gated by
        # regress.py's CONTROL GATE
        ma = measure_slo_autotune(device=device)
        result["metrics"].append(ma)
        ctrl = ma["control"]
        scen = ctrl["scenarios"]
        progress(f"slo_autotune worst converge {ma['value']} ticks "
                 f"(admission {scen['admission']['converge_ticks']}, "
                 f"recovery {scen['recovery']['converge_ticks']}, "
                 f"straggler {scen['straggler']['converge_ticks']}; "
                 f"disabled twin moves {ctrl['disabled_moves']}, "
                 f"byte_exact {ctrl['byte_exact']}, "
                 f"launches {ma['launches']}, wall {ma['wall_s']} s)")
        # composed chaos (chaos/): pinned seeded storylines end to end,
        # every receipt judged by regress.py's CHAOS GATE; the smoke runs
        # seed 24 (straggler + chip-fail + elastic membership), the card
        # all four
        mx = measure_composed_chaos(
            seeds=(24,) if args.smoke else (24, 103, 196, 20260807),
            device=device)
        result["metrics"].append(mx)
        chb = mx["chaos"]
        progress(f"composed_chaos {mx['value']} ops/s over "
                 f"{len(chb['receipts'])} storylines (accepted "
                 f"{chb['accepted']}, wedges "
                 f"{sum(1 for r in chb['receipts'] if r['wedged'])}, "
                 f"byte_exact "
                 f"{all(r['byte_exact'] for r in chb['receipts'])}, "
                 f"launches {mx['launches']}, wall {mx['wall_s']} s)")
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
