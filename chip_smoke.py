"""Chip smoke of the PyTorch/CUDA port: build, check and time its kernels,
and drive the erasure-code write and read path at full width.

    python3 chip_smoke.py

Needs one CUDA card (exits non-zero without one) and ``nvcc``.  Phases:

1. device: the ``nvidia-smi`` name/power-limit line and the arch probe;
2. build: every ``ceph_tpu_torch/csrc/*.cu`` with nvcc (in parallel),
   with ptxas' registers/spills and, per kernel, the POPC, LDS and
   instruction counts of its SASS (``cuobjdump -sass``);
3. kernel against its plain PyTorch version on the card, byte-exact, at
   the main path's shapes, at ragged/odd shapes, on random 0/1 matrices
   for k in {1, 9, 32, 256} x r in {1, 5, 8} x C in {1, 15, 4097}, and on
   a data pointer one byte off 16-byte alignment; the first (popcount)
   design of the kernel is held against the same plain outputs at the
   three main-path shapes;
4. main path, k=8 m=4, reed_sol_van and cauchy, stripe unit 4096:
   (a) ``ecutil.encode`` of 64 objects of 4 MiB one by one,
   (b) one ``encode_batch_device`` of all 64 (S=8192, C=4096), and one
   ``decode_batch_device`` of shard 1 from the card-resident survivors,
   (c) ``ecutil.decode_concat`` of every object with shards {1, 9} lost,
   (d) ``ecutil.decode`` of shard 9, (e) one object against the host
   ``MatrixRSCodec``; the kernel's launch count must move;
5. times with CUDA events (medians of >= 10 samples after a warm-up): the
   end-to-end paths, then at encode, decode r=1 and decode r=2 the kernel,
   its first design (``prior_ms``) and a device copy of the same bytes
   read and written (``copy_ms``), in turns, each sample 10 launches back
   to back; and the plain version.

Prints the ``{"kernels": [...]}`` line before the last and, as the last
line, ``{"ok": true, "device": {...}}``.  Full results also go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

K, M = 8, 4
CHUNK = 4096                      # osd_pool_erasure_code_stripe_unit
OBJ_BYTES = 4 << 20
N_OBJ = 64
ERASED = (1, 9)
HBM_BYTES_PER_S = 3.35e12         # H100 SXM
INT8_OPS_PER_S = 1979e12          # H100 SXM dense int8 tensor-core peak
RUNS = 10
REPS = 10                         # back-to-back launches per kernel sample
SEED = 20261016


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, runs: int = RUNS, warmup: int = 2) -> float:
    """Median device time of one call of ``fn`` over ``runs`` calls, by
    CUDA events: the time a caller waits for it, host launch included."""
    return turns_ms([fn], runs, warmup)[0]


def turns_ms(fns, runs: int = RUNS, warmup: int = 2, reps: int = 1):
    """Median device time of each of ``fns``, launched in turns (one
    sample of each per round) so that they share the card's state.  A
    sample times ``reps`` calls back to back and divides: with reps > 1
    the host's launch overhead hides behind the queued launches, and the
    figure is the kernel's own time."""
    for fn in fns:
        for _ in range(warmup):
            fn()
    times = [[] for _ in fns]
    for _ in range(runs):
        for fn, t in zip(fns, times):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            b.synchronize()
            t.append(a.elapsed_time(b) / reps)
    return [statistics.median(t) for t in times]


def sass_counts(so_path, nvcc):
    """{kernel: {"POPC": n, "LDS": n, "instructions": n}} from the SASS of
    a built library (static counts: each instruction once, loops not
    multiplied), or None when the toolkit has no ``cuobjdump``."""
    tool = os.path.join(os.path.dirname(nvcc or ""), "cuobjdump")
    if not os.access(tool, os.X_OK):
        return None
    text = subprocess.run([tool, "-sass", str(so_path)], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            base = re.search(r"gf_\w+?_kernel", m.group(1))
            args = re.findall(r"Li(\d+)E", m.group(1))
            name = (base.group(0) if base else m.group(1)) + (
                "<" + ",".join(args) + ">" if args else "")
            counts[name] = {"POPC": 0, "LDS": 0, "instructions": 0}
        elif name and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            op = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
            if not op:
                continue
            counts[name]["instructions"] += 1
            head = op.group(1).split(".")[0]
            if head in ("POPC", "LDS"):
                counts[name][head] += 1
    return counts


def wall_s(fn, runs: int = RUNS, warmup: int = 1) -> float:
    """Median host time of ``fn`` (ending in a device synchronise)."""
    for _ in range(warmup):
        fn()
        torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def bound_ms(s: int, k: int, r: int, c: int):
    """Least time for the product on this card: each input byte read
    once and each output byte written once over HBM, against the same
    product counted as an int8 matmul (2 * S*C * 8k * 8r) at peak."""
    t_bytes = (s * k * c + s * r * c) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * s * c * (8 * k) * (8 * r) / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ceph_tpu_torch import arch
    from ceph_tpu_torch.ec import create_erasure_code
    from ceph_tpu_torch.gf.matrices import (gf_gen_cauchy1_matrix,
                                            gf_gen_rs_matrix)
    from ceph_tpu_torch.gf.tables import expand_to_bitmatrix
    from ceph_tpu_torch.ops import _build, gf_pallas
    from ceph_tpu_torch.ops.gf_matmul import DeviceRSBackend
    from ceph_tpu_torch.osd import ecutil

    dev = torch.device("cuda")
    results: dict = {}

    # -- 1. device ------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    log(smi)
    probe = arch.probe()
    log("arch " + json.dumps(probe))
    results.update(nvidia_smi=smi, arch=probe)

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"build {sorted(built)} in {build_s:.2f} s")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{name}] {line.strip()}")
    results["build_s"] = build_s
    sass = {n: sass_counts(so, probe["nvcc"]) for n, so in built.items()}
    for name, per_fn in sass.items():
        for fn, c in (per_fn or {}).items():
            log(f"  sass[{name}] {fn} " + json.dumps(c))
    results["sass"] = sass

    # -- 3. kernel against its plain version ----------------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    rs = DeviceRSBackend(gf_gen_rs_matrix(K + M, K), dev)
    enc_bm = rs.enc_bits
    srcs = [i for i in range(K + M) if i not in ERASED][:K]
    dec1 = rs._decode_bits_for(tuple(srcs), (1,))
    dec2 = rs._decode_bits_for(tuple(srcs), (1, 2))
    odd = [((3, 21, 4, 96), gf_gen_rs_matrix),
           ((5, 32, 4, 32), gf_gen_rs_matrix),
           ((2, 2, 1, 33), gf_gen_rs_matrix),
           ((1, 40, 3, 4128), gf_gen_cauchy1_matrix)]
    cases = [("encode", (8192, K, M, CHUNK), enc_bm),
             ("decode_r1", (8192, K, 1, CHUNK), dec1),
             ("decode_r2", (8192, K, 2, CHUNK), dec2)]
    for (s, k, r, c), genm in odd:
        bits = expand_to_bitmatrix(genm(k + r, k)[k:])
        cases.append((f"odd_{s}x{k}x{r}x{c}", (s, k, r, c),
                      gf_pallas.BitMatrix(bits, dev)))
    rng = np.random.default_rng(SEED)
    for k in (1, 9, 32, 256):
        for r in (1, 5, 8):
            bm = gf_pallas.BitMatrix(
                rng.integers(0, 2, (8 * k, 8 * r), dtype=np.uint8), dev)
            for c in (1, 15, 4097):
                cases.append((f"grid_{k}x{r}x{c}", (3, k, r, c), bm))
    cases.append(("misaligned", (64, K, M, CHUNK), enc_bm))
    max_err = 0
    inputs = {}
    for name, (s, k, r, c), bm in cases:
        if name == "misaligned":      # contiguous, one byte off 16-B alignment
            buf = torch.randint(0, 256, (s * k * c + 1,), generator=gen,
                                device=dev, dtype=torch.uint8)
            data = buf[1:].view(s, k, c)
            if data.data_ptr() % 16 != 1 or not data.is_contiguous():
                raise AssertionError("misaligned case is not one byte off")
        else:
            data = torch.randint(0, 256, (s, k, c), generator=gen,
                                 device=dev, dtype=torch.uint8)
        got = gf_pallas.gf_bit_matmul_kernel(data, bm)
        want = gf_pallas.gf_bit_matmul_plain(data, bm.bits)
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max())
        if not name.startswith("grid_") or err:
            log(f"check {name} (S,k,r,C)={(s, k, r, c)} max_abs_err={err}")
        if got.shape != (s, r, c) or err:
            raise AssertionError(f"kernel disagrees with plain at {name}")
        max_err = max(max_err, err)
        if name in ("encode", "decode_r1", "decode_r2"):
            prior = gf_pallas.gf_bit_matmul_popc(data, bm)
            torch.cuda.synchronize()
            if not torch.equal(prior, want):
                raise AssertionError(f"first design disagrees at {name}")
            inputs[name] = (data, bm)
        del got, want
    n_grid = sum(1 for n, _, _ in cases if n.startswith("grid_"))
    log(f"check grid: {n_grid} shapes of random 0/1 matrices, max_abs_err 0")
    log("check first design (popc) at encode, decode_r1, decode_r2: equal")
    results["max_abs_err"] = max_err
    results["checked_shapes"] = len(cases)

    # -- 4. main path ---------------------------------------------------------
    sinfo = ecutil.stripe_info_t(K, K * CHUNK)
    spo = OBJ_BYTES // sinfo.get_stripe_width()          # 128 stripes
    all_shards = set(range(K + M))
    objs_dev = torch.randint(0, 256, (N_OBJ * spo, K, CHUNK), generator=gen,
                             device=dev, dtype=torch.uint8)
    objs = objs_dev.cpu().numpy().reshape(N_OBJ, OBJ_BYTES)
    launches = 0
    e2e = {}
    for tech in ("reed_sol_van", "cauchy"):
        codec = create_erasure_code({"plugin": "cuda", "k": str(K),
                                     "m": str(M), "technique": tech})
        gf_pallas.launches.reset()
        # (a) one object at a time, as the OSD calls it
        shards = [ecutil.encode(sinfo, codec, o, all_shards) for o in objs]
        # (b) the whole batch on the card
        parity = codec.encode_batch_device(objs_dev)
        torch.cuda.synchronize()
        want = torch.from_numpy(np.stack(
            [np.stack([sh[K + j].reshape(spo, CHUNK) for j in range(M)],
                      axis=1) for sh in shards])).to(dev)
        if not torch.equal(parity, want.reshape(N_OBJ * spo, M, CHUNK)):
            raise AssertionError(f"{tech}: batched parity != per-object")
        # ... and its reconstruction twin, survivors already on the card
        del want
        surv_dev = torch.cat([objs_dev[:, [0, 2, 3, 4, 5, 6, 7]],
                              parity[:, :1]], dim=1)
        rec = codec.decode_batch_device(surv_dev, srcs, [1])
        if not torch.equal(rec, objs_dev[:, 1:2]):
            raise AssertionError(f"{tech}: decode_batch_device mismatch")
        del surv_dev, rec, parity
        # (c) degraded read of every object, (d) rebuild of shard 9
        for o, sh in zip(objs, shards):
            surv = {i: b for i, b in sh.items() if i not in ERASED}
            if not np.array_equal(ecutil.decode_concat(sinfo, codec, surv), o):
                raise AssertionError(f"{tech}: decode_concat mismatch")
            if not np.array_equal(
                    ecutil.decode(sinfo, codec, surv, [9])[9], sh[9]):
                raise AssertionError(f"{tech}: rebuilt shard 9 mismatch")
        n = gf_pallas.launches.n
        log(f"main {tech}: (a)-(d) byte-exact, kernel launches {n}")
        if n == 0:
            raise AssertionError(f"{tech}: main path never ran the kernel")
        launches += n
        # (e) one object against the host codec
        flat = objs[0].reshape(spo, K, CHUNK).transpose(1, 0, 2).reshape(
            K, spo * CHUNK)
        host = codec.codec.encode(np.ascontiguousarray(flat))
        for j in range(M):
            if not np.array_equal(
                    host[j].reshape(spo, CHUNK),
                    shards[0][K + j].reshape(spo, CHUNK)):
                raise AssertionError(f"{tech}: host codec mismatch")
        log(f"main {tech}: (e) host MatrixRSCodec agrees")

        # -- 5. end-to-end times (outside the counted run) --------------------
        surv_all = [{i: b for i, b in sh.items() if i not in ERASED}
                    for sh in shards]
        total = N_OBJ * OBJ_BYTES
        ta = wall_s(lambda: [ecutil.encode(sinfo, codec, o, all_shards)
                             for o in objs], runs=RUNS)
        tb = cuda_ms(lambda: codec.encode_batch_device(objs_dev)) / 1e3
        tc = wall_s(lambda: [ecutil.decode_concat(sinfo, codec, sv)
                             for sv in surv_all], runs=RUNS)
        e2e[tech] = {
            "a_encode_per_object_GiBps": total / ta / 2**30,
            "b_encode_batch_device_GiBps": total / tb / 2**30,
            "c_decode_concat_GiBps": total / tc / 2**30,
        }
        log(f"e2e {tech} " + json.dumps(e2e[tech]))
    results["e2e"] = e2e
    results["main_path_launches"] = launches

    # -- 5. kernel times ------------------------------------------------------
    times = {}
    for name in ("encode", "decode_r1", "decode_r2"):
        data, bm = inputs[name]
        s, k, c = data.shape
        half = s * (k + bm.r) * c // 2      # the kernel's bytes, half each way
        src = torch.empty(half, dtype=torch.uint8, device=dev)
        dst = torch.empty_like(src)
        ms, prior, copy = turns_ms([
            lambda: gf_pallas.gf_bit_matmul_kernel(data, bm),
            lambda: gf_pallas.gf_bit_matmul_popc(data, bm),
            lambda: dst.copy_(src)], reps=REPS)
        del src, dst
        plain = cuda_ms(lambda: gf_pallas.gf_bit_matmul_plain(data, bm.bits))
        b_ms, b_by = bound_ms(s, k, bm.r, c)
        times[name] = {"ms": ms, "prior_ms": prior, "copy_ms": copy,
                       "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                       "share_of_bound": b_ms / ms,
                       "GBps": (s * k * c + s * bm.r * c) / ms / 1e6}
        log(f"time {name} " + json.dumps(times[name]))
    results["kernel_times"] = times
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    log(f"after timing: clocks.sm, clocks.max.sm, power.draw, temp: {clocks}")
    results["clocks_after_timing"] = clocks

    enc = times["encode"]
    kernels = {"kernels": [{
        "name": "gf_bit_matmul", "route": "cuda",
        "source": "ceph_tpu_torch/csrc/gf_bit_matmul.cu",
        "replaces": "ceph_tpu/ops/gf_pallas.py:37",
        "launches": launches, "max_abs_err": max_err,
        "ms": enc["ms"], "plain_ms": enc["plain_ms"],
        "bound_ms": enc["bound_ms"], "bound_by": enc["bound_by"],
        "library_ms": None, "prior_ms": enc["prior_ms"],
        "copy_ms": enc["copy_ms"]}]}
    results.update(kernels)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(results, f, indent=1)
    log(smi)
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
