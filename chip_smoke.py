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

The crc32c slice adds, after phase 4 (so that phases 1-4 run as they did
before it):

3b. the crc32c kernel against its plain version on the card, byte-exact:
   every length 0..4097 as one padded batch, 64 rows of 0..41 segments,
   a 1-D view one byte off 16-byte alignment and rows at odd strides;
4r. the device-resident write path, per technique, with the residency
   budget large enough to keep every body: (d) ``encode_resident_shards``
   of each object (S=128, 12 bodies of 512 KiB) and (e) one of all 64 as
   one (8192, 8, 4096) batch on the card, counted alone: the one-pass fused
   kernel (``csrc/fused_encode_crc.cu``) must launch exactly once per call
   and the bit-matmul and crc32c kernels never; then the device verify of
   every stored shard (``crc32c_of_device_array``), counted apart: the
   crc32c kernel must launch.  After the counted runs: every body equals
   the ``ecutil.encode`` shard, every crc equals the device verify and the
   plain crc32c, one object's 12 crcs equal a host ``HashInfo``, a
   ``corrupted()`` data shard fails its verify while its siblings pass and
   ``decode_concat`` of the other 11 returns the object; the crc32c kernel
   on the 12 x 32 MiB bodies and the fused encode at S=8192 against their
   plain versions, the fused call allocating nothing beside its bodies;
5r. times: the crc32c kernel on the 12 bodies of 32 MiB and the fused
   encode at S=8192, each in turns with its first form (``prior_ms``: the
   kernel's per-thread path; the two-launch form, bit-matmul then crc32c
   gather) and a device copy of its bytes, 10 launches per sample; their
   plain versions; (d) and (e) as GiB/s of object data (host clock around
   calls that end in the crc fetch).

The one-pass fused encode adds, after 3b:

3f. the one-pass kernel against ``fused_encode_crc_plain``, byte-exact,
   per technique, at S = 128, 1 and 3, C = 2048 and 6144, (k, m) = (3, 2),
   (10, 4) and (8, 5) (two parity groups); and C = 4099, which takes the
   two-launch form (the one-pass count must stay put there, the bit-matmul
   and crc32c counts move).

The codec-family slice adds, after 5r:

3w. the word-layout kernel K3 (``gfw_bit_matmul_launch``) against
   ``gfw_bit_matmul_plain``, byte-exact, at w = 16 and 32: the path shape
   (S, k, m, C) = (16384, 4, 2, 4096), (5, 3) and (1, 1), k' = k w/8 = 256,
   C = w/8 and 4096 + 3 w/8, random 0/1 matrices, a pointer one byte off
   16-byte alignment (the byte path); and its prior form (torch
   de-interleave, K1, re-interleave) at the path shape;
4j. seven k=4 profiles (jerasure reed_sol_van w=8/16/32, reed_sol_r6_op,
   cauchy_good at packetsize 2048, shec k4m3c2, lrc k4m2l3) on the same 64
   objects of 4 MiB, chunk ``get_chunk_size(4 * 4096)``: (a) ``ecutil.encode``
   per object, (b) one batched encode of all 64 (numpy in and out), (c)
   ``ecutil.decode_concat`` per object with one data and one coding chunk
   lost where the code tolerates it; the batch against the per-object
   shards, object 0 against the host codec, the decoded objects against the
   payloads, byte-exact; K3 must launch and K1 must not on w=16/32, K1 on
   the others; which profiles decode on the host codec is logged;
5w. K3 at the path shape per w in turns with its prior form and a device
   copy of its bytes, its plain version, the (a)/(b)/(c) rates per profile,
   and K1 at cauchy_good's virtual shape (1024, 32, 16, 8192).

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
# H100 SXM 32-bit integer throughput: 132 SMs x 64 lanes x 1.98 GHz
INT32_OPS_PER_S = 132 * 64 * 1.98e9
RESIDENT_BUDGET = 4 << 30         # os_memstore_device_bytes_max for 4r
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
            base = re.search(r"(?:gfw?_\w+?|crc32c\w*?|fused\w*?)_kernel",
                             m.group(1))
            args = re.findall(r"L[ib](\d+)E", m.group(1))
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


def crc_bound_ms(n_bytes: int, n_rows: int):
    """Least time for crc32c of n_bytes in n_rows: every byte read once
    and 4 B written per row over HBM, against one table lookup and one
    XOR per byte at the card's 32-bit integer instruction rate."""
    t_bytes = (n_bytes + 4 * n_rows) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * n_bytes / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fused_bound_ms(s: int, k: int, m: int, c: int):
    """Least time for the fused encode: stripes read once, n bodies and n
    crcs written once, against the product as an int8 matmul plus the
    crc's lookups and XORs over the n bodies."""
    n = k + m
    t_bytes = (s * k * c + n * s * c + 4 * n) / HBM_BYTES_PER_S * 1e3
    t_ops = (2 * s * c * (8 * k) * (8 * m) / INT8_OPS_PER_S
             + 2 * n * s * c / INT32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def int_err(got: torch.Tensor, want: torch.Tensor) -> int:
    """Largest absolute difference of two integer tensors (0 if empty)."""
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not got.numel():
        return 0
    return int((got.long() - want.long()).abs().max())


def crc_checks(gen, rng, dev) -> int:
    """3b: the crc32c kernel against its plain version, byte-exact, at
    the sweep, ragged, misaligned and odd-stride cases; returns the max
    error (0)."""
    from ceph_tpu_torch.ops import crc32c_device
    crc_cases = []
    sweep_len = np.arange(0, 4098)
    rows = torch.randint(0, 256, (4098, 4104), generator=gen, device=dev,
                         dtype=torch.uint8)
    crc_cases.append(("sweep_0_4097", rows, sweep_len))
    rag_len = rng.integers(0, 40 * 4096 + 100, 64)
    rag_len[:4] = (0, 40 * 4096 + 100, 32 * 4096, 4096)
    crc_cases.append(("ragged_0_41_segments", torch.randint(
        0, 256, (64, 40 * 4096 + 104), generator=gen, device=dev,
        dtype=torch.uint8), rag_len))
    buf = torch.randint(0, 256, (1 + (3 << 20) + 7,), generator=gen,
                        device=dev, dtype=torch.uint8)
    one = buf[1:]                       # one byte off 16-byte alignment
    if one.data_ptr() % 16 != 1:
        raise AssertionError("misaligned crc case is not one byte off")
    crc_cases.append(("misaligned_1d", one.view(1, -1), None))
    crc_cases.append(("odd_stride_rows",
                      buf[1:1 + 5 * 4099].view(5, 4099), None))
    crc_err = 0
    for name, rows, lens in crc_cases:
        got = crc32c_device.crc32c_kernel(rows, lens)
        want = crc32c_device.crc32c_plain(
            rows, None if lens is None else torch.from_numpy(lens).to(dev))
        torch.cuda.synchronize()
        err = int_err(got, want)
        log(f"check crc32c {name} rows={rows.shape[0]} "
            f"max_len={rows.shape[1] if lens is None else int(lens.max())} "
            f"max_abs_err={err}")
        if err:
            raise AssertionError(f"crc32c kernel disagrees with plain at "
                                 f"{name}")
        crc_err = max(crc_err, err)
    if crc32c_device.crc32c_of_device_array(one) != int(
            crc32c_device.to_u32(crc32c_device.crc32c_plain(
                one.view(1, -1)))[0]):
        raise AssertionError("crc32c_of_device_array disagrees at a "
                             "misaligned view")
    # the coalesced path (aligned rows, lengths a multiple of 16): runs
    # with zeros in front, empty rows, and a table of 200 rows (two
    # launches of at most 128)
    rows = torch.randint(0, 256, (300, 3 * 4096 + 48), generator=gen,
                         device=dev, dtype=torch.uint8)
    for name, got, want in (
            ("coalesced_rows", crc32c_device.crc32c_kernel(rows),
             crc32c_device.crc32c_plain(rows)),
            ("coalesced_table_200", crc32c_device.crc32c_rows_kernel(
                list(rows[:200])), crc32c_device.crc32c_plain(rows[:200])),
            ("coalesced_empty", crc32c_device.crc32c_kernel(rows[:3, :0]),
             crc32c_device.crc32c_plain(rows[:3, :0]))):
        err = int_err(got, want)
        log(f"check crc32c {name} max_abs_err={err}")
        if err:
            raise AssertionError(f"crc32c kernel disagrees at {name}")
    # the gather mode (copy while hashing): C = 4099 at a pitch of 3 C,
    # one byte off alignment, C = 24 (64 segments), both per-thread, and
    # C = 2048 and 6144 at a pitch of 3 C, coalesced
    for name, src in (("gather_odd", buf[1:1 + 5 * 3 * 4099].view(5, 3, 4099)),
                      ("gather_small", buf[:40 * 3 * 24].view(40, 3, 24)),
                      ("gather_coalesced",
                       buf[:67 * 3 * 2048].view(67, 3, 2048)),
                      ("gather_coalesced_6144",
                       buf[:33 * 3 * 6144].view(33, 3, 6144))):
        s, k, c = src.shape
        bodies = [torch.empty(s * c, dtype=torch.uint8, device=dev)
                  for _ in range(k)]
        got = crc32c_device.crc32c_gather_kernel(
            [src[:, i] for i in range(k)], bodies)
        want = torch.stack([src[:, i].reshape(-1) for i in range(k)])
        err = max(int_err(torch.stack(bodies), want),
                  int_err(got, crc32c_device.crc32c_plain(want)))
        log(f"check crc32c {name} (S,k,C)={(s, k, c)} max_abs_err={err}")
        if err:
            raise AssertionError(f"crc32c gather disagrees at {name}")
    return crc_err


def fused_checks(gen, dev) -> int:
    """3f: the one-pass fused encode against its plain version, byte-exact,
    per technique at the shapes it takes beside the main one, and the
    two-launch form at a tail shape; returns the max error (0)."""
    from ceph_tpu_torch.gf.matrices import (gf_gen_cauchy1_matrix,
                                            gf_gen_rs_matrix)
    from ceph_tpu_torch.gf.tables import expand_to_bitmatrix
    from ceph_tpu_torch.ops import (crc32c_device, fused_encode_crc,
                                    gf_pallas, resident)
    gens = {"reed_sol_van": gf_gen_rs_matrix,
            "cauchy": gf_gen_cauchy1_matrix}
    shapes = [(128, K, M, CHUNK), (1, K, M, CHUNK), (3, K, M, CHUNK),
              (64, K, M, 2048), (64, K, M, 6144), (64, 3, 2, CHUNK),
              (64, 10, 4, CHUNK), (64, K, 5, CHUNK), (64, K, M, 4099)]
    worst = 0
    for tech, genm in gens.items():
        for s, k, m, c in shapes:
            bm = gf_pallas.BitMatrix(
                expand_to_bitmatrix(genm(k + m, k)[k:]), dev)
            data = torch.randint(0, 256, (s, k, c), generator=gen, device=dev,
                                 dtype=torch.uint8)
            one = c % 2048 == 0
            counts = [x.n for x in (fused_encode_crc.launches,
                                    gf_pallas.launches, crc32c_device.launches)]
            bodies, crcs = resident._fused_encode_crc(data, bm)
            moved = [x.n - y for x, y in zip(
                (fused_encode_crc.launches, gf_pallas.launches,
                 crc32c_device.launches), counts)]
            if moved != ([1, 0, 0] if one else [0, 1, 1]):
                raise AssertionError(f"fused {tech} {(s, k, m, c)}: launches "
                                     f"{moved} on the wrong route")
            pb, pcrc = fused_encode_crc.fused_encode_crc_plain(data, bm)
            err = max(int_err(torch.stack(bodies), pb), int_err(crcs, pcrc))
            torch.cuda.synchronize()
            log(f"check fused_encode_crc {tech} (S,k,m,C)={(s, k, m, c)} "
                f"{'one-pass' if one else 'two-launch'} max_abs_err={err}")
            if err:
                raise AssertionError(f"fused encode disagrees with plain at "
                                     f"{tech} {(s, k, m, c)}")
            worst = max(worst, err)
            del bodies, crcs, pb, pcrc, data
    return worst


def resident_phase(tech, codec, objs, objs_dev, shards, sinfo, spo, dev):
    """4r: the device-resident write path of one technique.  Returns its
    launch counts, the batched shards and the max error of its checks."""
    from ceph_tpu_torch.ops import (crc32c_device, fused_encode_crc,
                                    gf_pallas, resident)
    from ceph_tpu_torch.os_store.device_shard import \
        memstore_device_perf_counters
    from ceph_tpu_torch.osd import ecutil
    n = K + M
    pc = memstore_device_perf_counters()
    demotions = pc.get("demotions")
    counters = {"gf_bit_matmul": gf_pallas.launches,
                "crc32c": crc32c_device.launches,
                "fused_encode_crc": fused_encode_crc.launches,
                "resident_calls": resident.launches}
    for c in counters.values():
        c.reset()
    # (d) per object from host memory, (e) the whole batch on the card:
    # one launch of the one-pass kernel per call, no other kernel
    per_obj = [resident.encode_resident_shards(
        codec, o.reshape(spo, K, CHUNK)) for o in objs]
    batch = resident.encode_resident_shards(codec, objs_dev)
    counts = {name: c.n for name, c in counters.items()}
    calls = len(per_obj) + 1
    log(f"resident {tech}: write launches " + json.dumps(counts))
    if counts != {"gf_bit_matmul": 0, "crc32c": 0,
                  "fused_encode_crc": calls, "resident_calls": calls}:
        raise AssertionError(f"{tech}: the resident write is not one "
                             "one-pass launch per call")
    # then the read-side device verify of every stored shard
    crc32c_device.launches.reset()
    verify = [[crc32c_device.crc32c_of_device_array(sh[i].device_array())
               for i in range(n)] for sh in per_obj + [batch]]
    counts["crc32c"] = crc32c_device.launches.n
    log(f"resident {tech}: verify launches crc32c {counts['crc32c']}")
    if counts["crc32c"] == 0:
        raise AssertionError(f"{tech}: the device verify skipped crc32c")
    if pc.get("demotions") != demotions or any(
            not sh[i].is_resident for sh in per_obj + [batch]
            for i in range(n)):
        raise AssertionError(f"{tech}: a body left the card")

    # -- checks, outside the counted run ----------------------------------
    for o, sh in enumerate(per_obj):
        want = torch.from_numpy(np.stack([shards[o][i] for i in range(n)]))
        got = torch.stack([sh[i].device_array() for i in range(n)])
        if not torch.equal(got, want.to(dev)):
            raise AssertionError(f"{tech}: resident body != ecutil.encode "
                                 f"(object {o})")
        if [sh[i].crc for i in range(n)] != verify[o]:
            raise AssertionError(f"{tech}: crc != device verify ({o})")
    stored = np.array([sh[i].crc for sh in per_obj for i in range(n)],
                      dtype=np.uint32)
    plain = crc32c_device.to_u32(crc32c_device.crc32c_plain(torch.stack(
        [sh[i].device_array() for sh in per_obj for i in range(n)])))
    if not np.array_equal(plain, stored):
        raise AssertionError(f"{tech}: crc != plain crc32c")
    hinfo = ecutil.HashInfo(n)
    hinfo.append(0, {i: shards[0][i] for i in range(n)})
    if [hinfo.get_chunk_hash(i) for i in range(n)] != \
            [per_obj[0][i].crc for i in range(n)]:
        raise AssertionError(f"{tech}: crc != host HashInfo")
    for i in range(n):
        want = torch.from_numpy(np.concatenate([sh[i] for sh in shards]))
        if not torch.equal(batch[i].device_array(), want.to(dev)):
            raise AssertionError(f"{tech}: batched body {i} != per-object")
    if [batch[i].crc for i in range(n)] != verify[-1]:
        raise AssertionError(f"{tech}: batched crc != device verify")
    log(f"resident {tech}: (d) {len(per_obj)} x {n} and (e) {n} bodies "
        "equal ecutil.encode; crcs equal the device verify, the plain "
        "crc32c and host HashInfo (object 0)")
    # bitrot on one resident data shard of object 0
    sh, victim = per_obj[0], 2
    sh[victim].corrupted()
    if crc32c_device.crc32c_of_device_array(
            sh[victim].device_array()) == sh[victim].crc:
        raise AssertionError(f"{tech}: corrupted shard passed its verify")
    if any(crc32c_device.crc32c_of_device_array(sh[i].device_array())
           != sh[i].crc for i in range(n) if i != victim):
        raise AssertionError(f"{tech}: a sibling's crc moved")
    surv = {i: np.frombuffer(sh[i].materialize(), dtype=np.uint8)
            for i in range(n) if i != victim}
    if not np.array_equal(ecutil.decode_concat(sinfo, codec, surv), objs[0]):
        raise AssertionError(f"{tech}: reconstruction after bitrot failed")
    log(f"resident {tech}: corrupted shard {victim} fails its verify, "
        "siblings pass, decode_concat of the other 11 is byte-exact")
    del per_obj, sh, surv

    # kernels at full width against their plain versions
    bodies = [batch[i].device_array() for i in range(n)]
    got = crc32c_device.crc32c_rows_kernel(bodies)
    err = int_err(got, crc32c_device.crc32c_plain(torch.stack(bodies)))
    # the one-pass call allocates the bodies and the crcs, nothing more
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fb, fc = resident._fused_encode_crc(objs_dev, codec.device().enc_bits)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base - sum(
        b.untyped_storage().nbytes() for b in fb)
    pb, pcrc = fused_encode_crc.fused_encode_crc_plain(
        objs_dev, codec.device().enc_bits)
    ferr = max(int_err(torch.stack(fb), pb), int_err(fc, pcrc))
    torch.cuda.synchronize()
    log(f"check crc32c {n} x {bodies[0].numel()} B bodies max_abs_err={err}; "
        f"fused_encode_crc S={objs_dev.shape[0]} max_abs_err={ferr}, "
        f"{extra} B allocated beside the bodies")
    if err or ferr:
        raise AssertionError(f"{tech}: kernel disagrees with plain at "
                             "full width")
    if extra > 1 << 20:
        raise AssertionError(f"{tech}: the fused call allocated {extra} B "
                             "beside its bodies")
    del fb, fc, pb, pcrc

    # -- (d), (e): end-to-end times ---------------------------------------
    total = N_OBJ * OBJ_BYTES
    td = wall_s(lambda: [resident.encode_resident_shards(
        codec, o.reshape(spo, K, CHUNK)) for o in objs], runs=RUNS)
    te = wall_s(lambda: resident.encode_resident_shards(codec, objs_dev),
                runs=RUNS)
    e2e = {"d_resident_per_object_GiBps": total / td / 2**30,
           "e_resident_batched_GiBps": total / te / 2**30}
    log(f"e2e {tech} " + json.dumps(e2e))
    return {"launches": counts, "e2e": e2e, "max_abs_err": max(err, ferr),
            "batch": batch}


def resident_times(batch, codec, objs_dev, dev) -> dict:
    """5r: the crc32c kernel on the batched bodies and the fused encode
    of the whole batch, in turns with their first forms (``prior_ms``:
    the kernel's per-thread path; the two-launch form) and with a device
    copy of their bytes; their plain versions."""
    from ceph_tpu_torch.ops import crc32c_device, fused_encode_crc, resident
    bodies = [batch[i].device_array() for i in range(K + M)]
    enc_bits = codec.device().enc_bits
    n_crc = sum(b.numel() for b in bodies)
    s_b = objs_dev.shape[0]
    n_fused = s_b * K * CHUNK + (K + M) * s_b * CHUNK
    copies = []
    for nbytes in (n_crc, n_fused):     # the kernel's bytes, half each way
        src = torch.empty(nbytes // 2, dtype=torch.uint8, device=dev)
        copies.append((src, torch.empty_like(src)))
    check = crc32c_device.crc32c_rows_per_thread(bodies)
    if not torch.equal(check, crc32c_device.crc32c_rows_kernel(bodies)):
        raise AssertionError("crc32c paths disagree")
    one = resident._fused_encode_crc(objs_dev, enc_bits)
    two = resident._fused_encode_crc_two_pass(objs_dev, enc_bits)
    if not (torch.equal(one[1], two[1])
            and torch.equal(torch.stack(one[0]), torch.stack(two[0]))):
        raise AssertionError("fused encode forms disagree")
    del one, two
    ms4, prior4, copy4, ms5, prior5, copy5 = turns_ms([
        lambda: crc32c_device.crc32c_rows_kernel(bodies),
        lambda: crc32c_device.crc32c_rows_per_thread(bodies),
        lambda: copies[0][1].copy_(copies[0][0]),
        lambda: resident._fused_encode_crc(objs_dev, enc_bits),
        lambda: resident._fused_encode_crc_two_pass(objs_dev, enc_bits),
        lambda: copies[1][1].copy_(copies[1][0])], reps=REPS)
    del copies
    stacked = torch.stack(bodies)
    plain4 = cuda_ms(lambda: crc32c_device.crc32c_plain(stacked), runs=3,
                     warmup=1)
    del stacked
    plain5 = cuda_ms(lambda: fused_encode_crc.fused_encode_crc_plain(
        objs_dev, enc_bits), runs=3, warmup=1)
    b4, b4_by = crc_bound_ms(n_crc, K + M)
    b5, b5_by = fused_bound_ms(s_b, K, M, CHUNK)
    times = {}
    times["crc32c"] = {"ms": ms4, "prior_ms": prior4, "copy_ms": copy4,
                       "plain_ms": plain4,
                       "bound_ms": b4, "bound_by": b4_by,
                       "share_of_bound": b4 / ms4,
                       "GBps": n_crc / ms4 / 1e6}
    times["fused_encode_crc"] = {"ms": ms5, "prior_ms": prior5,
                                 "copy_ms": copy5,
                                 "plain_ms": plain5, "bound_ms": b5,
                                 "bound_by": b5_by,
                                 "share_of_bound": b5 / ms5,
                                 "GBps": n_fused / ms5 / 1e6}
    for name in ("crc32c", "fused_encode_crc"):
        log(f"time {name} " + json.dumps(times[name]))
    return times


def word_bound_ms(s: int, k: int, r: int, c: int, w: int):
    """Least time for K3: each input byte read once and each output byte
    written once over HBM, against the product counted as an int8 matmul
    over the words' bits (2 * S*(C/ws) * k*w * r*w) at peak."""
    t_bytes = (s * k * c + s * r * c) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * s * (c // (w // 8)) * (k * w) * (r * w) / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def word_prior(data, bm, w):
    """K3's plain alternative on the card: torch de-interleave to the
    virtual byte layout, K1, re-interleave."""
    from ceph_tpu_torch.ops import gf_pallas
    s, k, c = data.shape
    ws = w // 8
    virt = data.view(s, k, c // ws, ws).permute(0, 1, 3, 2).reshape(
        s, k * ws, c // ws)
    out = gf_pallas.gf_bit_matmul_kernel(virt, bm)
    r = bm.r // ws
    return out.view(s, r, ws, c // ws).permute(0, 1, 3, 2).reshape(s, r, c)


def word_checks(gen, rng, dev):
    """3w: K3 against its plain version on the card, byte-exact, at the
    path shape (16384, 4, 2, 4096), at (5, 3) and (1, 1), at k' = 256, at
    C = w/8 and 4096 + 3 w/8, on random 0/1 matrices and on a pointer one
    byte off 16-byte alignment (the byte path); returns the max error and
    the path-shape inputs for the times."""
    from ceph_tpu_torch.gf.word_codec import reed_sol_van_matrix_w
    from ceph_tpu_torch.ops import gf_pallas
    from ceph_tpu_torch.ops.gf_matmul import expand_to_bitmatrix_w
    worst, inputs = 0, {}
    for w in (16, 32):
        ws = w // 8
        van = {(k, m): gf_pallas.BitMatrix(expand_to_bitmatrix_w(
            reed_sol_van_matrix_w(k, m, w), w), dev)
            for k, m in ((4, 2), (5, 3), (1, 1), (256 // ws, 2))}
        cases = [("path", (16384, 4, 2, 4096), van[4, 2]),
                 ("k5m3", (64, 5, 3, 4096), van[5, 3]),
                 ("k1m1", (64, 1, 1, 4096), van[1, 1]),
                 ("kv256", (8, 256 // ws, 2, 4096), van[256 // ws, 2]),
                 ("one_word", (33, 4, 2, ws), van[4, 2]),
                 ("ragged", (33, 4, 2, 4096 + 3 * ws), van[4, 2])]
        for k, m in ((3, 1), (6, 5), (9, 4)):
            bm = gf_pallas.BitMatrix(
                rng.integers(0, 2, (k * w, m * w), dtype=np.uint8), dev)
            for c in (ws, 200 - 200 % ws, 4096 + ws):
                cases.append((f"random_{k}x{m}x{c}", (5, k, m, c), bm))
        cases.append(("misaligned", (64, 4, 2, 4096), van[4, 2]))
        for name, (s, k, m, c), bm in cases:
            if name == "misaligned":
                buf = torch.randint(0, 256, (s * k * c + 1,), generator=gen,
                                    device=dev, dtype=torch.uint8)
                data = buf[1:].view(s, k, c)
                if data.data_ptr() % 16 != 1:
                    raise AssertionError("misaligned K3 case is not one "
                                         "byte off")
            else:
                data = torch.randint(0, 256, (s, k, c), generator=gen,
                                     device=dev, dtype=torch.uint8)
            got = gf_pallas.gfw_bit_matmul_kernel(data, bm, w)
            want = gf_pallas.gfw_bit_matmul_plain(data, bm.bits, w)
            torch.cuda.synchronize()
            err = int_err(got, want)
            if not name.startswith("random_") or err:
                log(f"check gfw w={w} {name} (S,k,m,C)={(s, k, m, c)} "
                    f"max_abs_err={err}")
            if err:
                raise AssertionError(f"K3 disagrees with plain at w={w} "
                                     f"{name}")
            worst = max(worst, err)
            if name == "path":
                if not torch.equal(word_prior(data, bm, w), got):
                    raise AssertionError(f"K3 prior form disagrees at w={w}")
                inputs[w] = (data, bm)
            del got, want
        log(f"check gfw w={w}: {len(cases)} shapes byte-exact (random 0/1 "
            "matrices included), prior form equal at the path shape")
    return worst, inputs


# 4j: the codec families at full width (k=4 profiles; SURVEY's reference
# profile at three word widths, RAID-6, cauchy_good at jerasure's default
# packet size, and the corpus's shec and lrc profiles)
FAMILY_PROFILES = [
    ("jerasure_van_w8", {"plugin": "jerasure", "technique": "reed_sol_van",
                         "k": "4", "m": "2", "w": "8"}),
    ("jerasure_van_w16", {"plugin": "jerasure", "technique": "reed_sol_van",
                          "k": "4", "m": "2", "w": "16"}),
    ("jerasure_van_w32", {"plugin": "jerasure", "technique": "reed_sol_van",
                          "k": "4", "m": "2", "w": "32"}),
    ("jerasure_r6_op", {"plugin": "jerasure", "technique": "reed_sol_r6_op",
                        "k": "4"}),
    ("jerasure_cauchy_good", {"plugin": "jerasure",
                              "technique": "cauchy_good", "k": "4", "m": "2",
                              "packetsize": "2048"}),
    ("shec_k4m3c2", {"plugin": "shec", "k": "4", "m": "3", "c": "2"}),
    ("lrc_k4m2l3", {"plugin": "lrc", "k": "4", "m": "2", "l": "3"}),
]
FAMILY_RUNS = 3


def host_encode(codec, flat: np.ndarray) -> np.ndarray:
    """All n chunks (physical order) of (k, L) logical data, on the port's
    host codecs: the split-table word codec at w = 16/32, the packet codec
    for bitmatrix codes, the GF(2^8) matvec for shec, layer by layer for
    lrc."""
    from ceph_tpu_torch.ec.rs_codec import gf_matvec_bytes
    k, n = codec.get_data_chunk_count(), codec.get_chunk_count()
    out = np.zeros((n, flat.shape[1]), dtype=np.uint8)
    for i in range(k):
        out[codec.chunk_index(i)] = flat[i]
    if hasattr(codec, "layers"):
        for layer in codec.layers:
            out[layer.coding] = layer.erasure_code.codec.encode(
                out[layer.data])
    elif hasattr(codec, "codec"):
        out[k:] = codec.codec.encode(flat)
    else:
        out[k:] = gf_matvec_bytes(codec.matrix, flat)
    return out


def batch_all(codec, stripes: np.ndarray) -> np.ndarray:
    """(S, k, C) -> (S, n, C) every chunk in physical order through the
    batched API: lrc's encode_batch_full, else data + encode_batch."""
    if hasattr(codec, "encode_batch_full"):
        return codec.encode_batch_full(stripes)
    return np.concatenate([stripes, codec.encode_batch(stripes)], axis=1)


def family_phase(name, prof, objs):
    """4j for one profile: (a) ecutil.encode per object, (b) one batched
    encode of all 64, (c) decode_concat per object with one data and one
    coding chunk lost where the code tolerates it; launches counted from
    just before (a) to just after (c); then the checks and the times."""
    from ceph_tpu_torch.ec import create_erasure_code
    from ceph_tpu_torch.ops import gf_pallas
    from ceph_tpu_torch.osd import ecutil
    codec = create_erasure_code(dict(prof))
    k, n = codec.get_data_chunk_count(), codec.get_chunk_count()
    c = codec.get_chunk_size(k * CHUNK)
    sinfo = ecutil.stripe_info_t(k, k * c)
    spo = OBJ_BYTES // sinfo.get_stripe_width()
    if spo * sinfo.get_stripe_width() != OBJ_BYTES:
        raise AssertionError(f"{name}: 4 MiB is not whole stripes of {c}")
    data_phys = [codec.chunk_index(i) for i in range(k)]
    coding_phys = [p for p in range(n) if p not in data_phys]
    lost = (data_phys[1], coding_phys[0])
    try:
        codec.minimum_to_decode(set(data_phys), set(range(n)) - set(lost))
    except IOError:
        lost = (data_phys[1],)
    host_decoded = not getattr(codec, "_device_decode_supported", True)
    stripes = objs.reshape(-1, k, c)
    counters = {"gf_bit_matmul": gf_pallas.launches,
                "gfw_bit_matmul": gf_pallas.word_launches}
    for ctr in counters.values():
        ctr.reset()
    shards = [ecutil.encode(sinfo, codec, o, set(range(n))) for o in objs]
    full = batch_all(codec, stripes)
    surv = [{i: b for i, b in sh.items() if i not in lost} for sh in shards]
    decoded = [ecutil.decode_concat(sinfo, codec, sv) for sv in surv]
    counts = {cname: ctr.n for cname, ctr in counters.items()}
    log(f"family {name}: chunk {c}, lost {list(lost)}, decode on "
        f"{'the host codec (by technique)' if host_decoded else 'the card'}"
        f", launches " + json.dumps(counts))
    word = prof.get("w") in ("16", "32")
    if word and (counts["gfw_bit_matmul"] == 0 or counts["gf_bit_matmul"]):
        raise AssertionError(f"{name}: the word path did not run on K3 "
                             "alone")
    if not word and (counts["gf_bit_matmul"] == 0
                     or counts["gfw_bit_matmul"]):
        raise AssertionError(f"{name}: the path did not run on K1 alone")
    # -- checks, outside the counted run ----------------------------------
    full = full.reshape(len(objs), spo, n, c)
    for o, sh in enumerate(shards):
        for i in range(n):
            if not np.array_equal(full[o, :, i].reshape(-1), sh[i]):
                raise AssertionError(f"{name}: batched chunk {i} != "
                                     f"per-object (object {o})")
        if not np.array_equal(decoded[o], objs[o]):
            raise AssertionError(f"{name}: decode_concat mismatch ({o})")
    flat = np.ascontiguousarray(
        objs[0].reshape(spo, k, c).transpose(1, 0, 2)).reshape(k, spo * c)
    host = host_encode(codec, flat)
    for i in range(n):
        if not np.array_equal(host[i], shards[0][i]):
            raise AssertionError(f"{name}: host codec disagrees (chunk {i})")
    log(f"family {name}: (a) {len(objs)} objects x {n} shards == (b) "
        f"batch of S={stripes.shape[0]} == host codec (object 0); (c) "
        "decoded objects == payloads")
    del full, decoded
    # -- end-to-end times, fewer runs than phase 5 (host-bound) -----------
    total = len(objs) * OBJ_BYTES
    ta = wall_s(lambda: [ecutil.encode(sinfo, codec, o, set(range(n)))
                         for o in objs], runs=FAMILY_RUNS)
    batch = (codec.encode_batch_full if hasattr(codec, "encode_batch_full")
             else codec.encode_batch)
    tb = wall_s(lambda: batch(stripes), runs=FAMILY_RUNS)
    tc = wall_s(lambda: [ecutil.decode_concat(sinfo, codec, sv)
                         for sv in surv], runs=FAMILY_RUNS)
    e2e = {"chunk": c, "lost": list(lost), "host_decoded": host_decoded,
           "launches": counts,
           "a_encode_per_object_GiBps": total / ta / 2**30,
           "b_encode_batch_GiBps": total / tb / 2**30,
           "c_decode_concat_GiBps": total / tc / 2**30}
    log(f"e2e {name} " + json.dumps(e2e))
    return e2e


def word_times(inputs, dev) -> dict:
    """5w: K3 at the path shape per w, in turns with its prior form and a
    device copy of its bytes, 10 launches per sample; its plain version;
    and K1 at cauchy_good's virtual shape (1024, 32, 16, 8192)."""
    from ceph_tpu_torch.gf.bitmatrix import (cauchy_good_matrix,
                                             matrix_to_bitmatrix)
    from ceph_tpu_torch.gf.tables import expand_to_bitmatrix
    from ceph_tpu_torch.ops import gf_pallas
    times = {}
    for w, (data, bm) in sorted(inputs.items()):
        s, k, c = data.shape
        r = bm.r // (w // 8)
        src = torch.empty(s * (k + r) * c // 2, dtype=torch.uint8, device=dev)
        dst = torch.empty_like(src)
        ms, prior, copy = turns_ms([
            lambda: gf_pallas.gfw_bit_matmul_kernel(data, bm, w),
            lambda: word_prior(data, bm, w),
            lambda: dst.copy_(src)], reps=REPS)
        del src, dst
        plain = cuda_ms(lambda: gf_pallas.gfw_bit_matmul_plain(
            data, bm.bits, w), runs=3, warmup=1)
        b_ms, b_by = word_bound_ms(s, k, r, c, w)
        times[f"w{w}"] = {"ms": ms, "prior_ms": prior, "copy_ms": copy,
                          "plain_ms": plain, "bound_ms": b_ms,
                          "bound_by": b_by, "share_of_bound": b_ms / ms,
                          "GBps": s * (k + r) * c / ms / 1e6}
        log(f"time gfw_bit_matmul w={w} (S,k,m,C)={(s, k, r, c)} "
            + json.dumps(times[f"w{w}"]))
    bits = expand_to_bitmatrix(matrix_to_bitmatrix(
        cauchy_good_matrix(4, 2, 8), 8))
    bm = gf_pallas.BitMatrix(bits, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    virt = torch.randint(0, 256, (1024, 32, 8192), generator=gen, device=dev,
                         dtype=torch.uint8)
    ms = turns_ms([lambda: gf_pallas.gf_bit_matmul_kernel(virt, bm)],
                  reps=REPS)[0]
    b_ms, b_by = bound_ms(1024, 32, 16, 8192)
    times["k1_cauchy_good_virtual"] = {"ms": ms, "bound_ms": b_ms,
                                       "bound_by": b_by}
    log("time gf_bit_matmul cauchy_good virtual (S,k,r,C)=(1024,32,16,8192) "
        + json.dumps(times["k1_cauchy_good_virtual"]))
    return times


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
    from ceph_tpu_torch.common.config import g_conf
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
    del shards, surv_all
    results["main_path_launches"] = launches

    # -- 3b. crc32c kernel against its plain version (after slice 1's phases,
    # which run as they did before this slice) -------------------------------
    crc_err = crc_checks(gen, rng, dev)
    results["crc32c_checks_max_abs_err"] = crc_err
    fused_err = fused_checks(gen, dev)
    results["fused_checks_max_abs_err"] = fused_err

    # -- 4r. the device-resident write path -----------------------------------
    g_conf.set_val("os_memstore_device_bytes_max", RESIDENT_BUDGET)
    res_launches = {"gf_bit_matmul": 0, "crc32c": 0, "fused_encode_crc": 0,
                    "resident_calls": 0}
    res_err = 0
    res_batch = None
    for tech in ("reed_sol_van", "cauchy"):
        codec = create_erasure_code({"plugin": "cuda", "k": str(K),
                                     "m": str(M), "technique": tech})
        shards = [ecutil.encode(sinfo, codec, o, all_shards) for o in objs]
        res = resident_phase(tech, codec, objs, objs_dev, shards, sinfo, spo,
                             dev)
        for name, v in res["launches"].items():
            res_launches[name] += v
        res_err = max(res_err, res["max_abs_err"])
        e2e[tech].update(res["e2e"])
        if res_batch is None:
            res_batch = (res["batch"], codec)
        del res, shards
    results["e2e"] = e2e
    results["resident_path_launches"] = res_launches

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

    # -- 5r. crc32c and fused-encode times -----------------------------------
    times.update(resident_times(*res_batch, objs_dev, dev))
    del res_batch

    # -- 3w. K3 against its plain version (after the earlier slices' phases,
    # which run as they did before this slice) -------------------------------
    word_err, word_inputs = word_checks(gen, rng, dev)
    results["gfw_checks_max_abs_err"] = word_err

    # -- 4j. the codec families at full width ---------------------------------
    del objs_dev
    families = {name: family_phase(name, prof, objs)
                for name, prof in FAMILY_PROFILES}
    results["families"] = families
    word_launches = sum(f["launches"]["gfw_bit_matmul"]
                        for f in families.values())
    family_k1 = sum(f["launches"]["gf_bit_matmul"] for f in families.values())

    # -- 5w. K3 times ---------------------------------------------------------
    wt = word_times(word_inputs, dev)
    del word_inputs
    results["word_kernel_times"] = wt
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    log(f"after timing: clocks.sm, clocks.max.sm, power.draw, temp: {clocks}")
    results["clocks_after_timing"] = clocks

    enc = times["encode"]
    k4, k5 = times["crc32c"], times["fused_encode_crc"]
    k3, k3w32 = wt["w16"], wt["w32"]
    kernels = {"kernels": [{
        "name": "gf_bit_matmul", "route": "cuda",
        "source": "ceph_tpu_torch/csrc/gf_bit_matmul.cu",
        "replaces": "ceph_tpu/ops/gf_pallas.py:37",
        "launches": launches + res_launches["gf_bit_matmul"] + family_k1,
        "max_abs_err": max_err,
        "ms": enc["ms"], "plain_ms": enc["plain_ms"],
        "bound_ms": enc["bound_ms"], "bound_by": enc["bound_by"],
        "library_ms": None, "prior_ms": enc["prior_ms"],
        "copy_ms": enc["copy_ms"]}, {
        "name": "crc32c", "route": "cuda",
        "source": "ceph_tpu_torch/csrc/crc32c.cu",
        "replaces": "ceph_tpu/ops/crc32c_device.py:73",
        "launches": res_launches["crc32c"],
        "max_abs_err": max(crc_err, res_err),
        "ms": k4["ms"], "plain_ms": k4["plain_ms"],
        "bound_ms": k4["bound_ms"], "bound_by": k4["bound_by"],
        "library_ms": None, "prior_ms": k4["prior_ms"],
        "copy_ms": k4["copy_ms"]}, {
        "name": "fused_encode_crc", "route": "cuda",
        "source": "ceph_tpu_torch/csrc/fused_encode_crc.cu",
        "replaces": "ceph_tpu/ops/resident.py:31",
        "launches": res_launches["fused_encode_crc"],
        "max_abs_err": max(res_err, fused_err),
        "ms": k5["ms"], "plain_ms": k5["plain_ms"],
        "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"],
        "library_ms": None, "prior_ms": k5["prior_ms"],
        "copy_ms": k5["copy_ms"]}, {
        "name": "gfw_bit_matmul", "route": "cuda",
        "source": "ceph_tpu_torch/csrc/gf_bit_matmul.cu",
        "replaces": "ceph_tpu/ops/gf_matmul.py:84",
        "launches": word_launches, "max_abs_err": word_err,
        "ms": k3["ms"], "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
        "library_ms": None, "prior_ms": k3["prior_ms"],
        "copy_ms": k3["copy_ms"], "ms_w32": k3w32["ms"],
        "plain_ms_w32": k3w32["plain_ms"],
        "bound_ms_w32": k3w32["bound_ms"],
        "bound_by_w32": k3w32["bound_by"],
        "prior_ms_w32": k3w32["prior_ms"],
        "copy_ms_w32": k3w32["copy_ms"]}]}
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
