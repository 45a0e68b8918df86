"""ceph_erasure_code_benchmark equivalent.

Port of ``ceph_tpu/tools/ec_benchmark.py``.  The CLI mirrors the
reference harness (src/test/erasure-code/ceph_erasure_code_benchmark.cc):
`-p <plugin> -P k=K -P m=M -S <size> -i <iterations> -w encode|decode
[-e erasures] [--erasures-generation exhaustive]`, printing
`<seconds>\t<KiB>` like :187.  Extra knob `--batch S` exercises the
batched device path (S objects per device call) — the mode the
reference cannot express — and `--dispatch N` submits N
objects at once through the dispatch scheduler, which coalesces them into
one device call per flush.  The codec runs on the card unless the
profile asks for the CPU (`-P backend=host`).

    python -m ceph_tpu_torch.tools.ec_benchmark -p cuda -P k=8 -P m=4 \
        -S 4194304 -i 10 --dispatch 64
"""
from __future__ import annotations

import argparse
import itertools
import sys
import time

import numpy as np

from ..ec import create_erasure_code


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="ec_benchmark")
    p.add_argument("-p", "--plugin", default="jerasure")
    p.add_argument("-P", "--parameter", action="append", default=[],
                   help="profile parameter k=v")
    p.add_argument("-S", "--size", type=int, default=1 << 20)
    p.add_argument("-i", "--iterations", type=int, default=1)
    p.add_argument("-w", "--workload", choices=("encode", "decode"),
                   default="encode")
    p.add_argument("-e", "--erasures", type=int, default=1)
    p.add_argument("--erasures-generation", default="random",
                   choices=("random", "exhaustive"))
    p.add_argument("--batch", type=int, default=0,
                   help="objects per batched device call (cuda plugin)")
    p.add_argument("--dispatch", type=int, default=0,
                   help="concurrent objects coalesced per flush through "
                        "the dynamic-batching dispatch scheduler; "
                        "0 = off")
    p.add_argument("--erased", type=int, action="append", default=[])
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    profile = {"plugin": args.plugin}
    for kv in args.parameter:
        k, _, v = kv.partition("=")
        profile[k] = v
    codec = create_erasure_code(profile)
    k = codec.get_data_chunk_count()
    n = codec.get_chunk_count()
    size = args.size
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, size=size, dtype=np.uint8)

    if args.dispatch and args.workload != "encode":
        print("--dispatch only measures the encode workload; refusing "
              "to print an uncoalesced decode as --dispatch output",
              file=sys.stderr)
        return 1

    if args.workload == "encode" and args.dispatch:
        # N concurrent submissions per iteration, coalesced into one
        # padded device call by the scheduler (the cross-PG shape the
        # OSD sees under load; --batch is the within-one-op shape)
        from ..common.config import g_conf
        from ..dispatch import KIND_ENCODE, batchable, g_dispatcher
        from ..osd.ecutil import stripe_info_t
        C = codec.get_chunk_size(size)
        if not batchable(codec, C, KIND_ENCODE):
            print(f"plugin {args.plugin!r} is not dispatch-batchable "
                  f"(no coalescing would happen); refusing to print a "
                  f"serial measurement as --dispatch output",
                  file=sys.stderr)
            return 1
        sinfo = stripe_info_t(k, k * C)
        padded = np.resize(data, k * C)
        want = set(range(n))
        saved = {nm: g_conf.values.get(nm) for nm in
                 ("ec_dispatch_batch_max", "ec_dispatch_batch_window_us")}
        g_conf.set_val("ec_dispatch_batch_max", args.dispatch)
        g_conf.set_val("ec_dispatch_batch_window_us", 10**7)
        try:
            for f in [g_dispatcher.submit_encode(sinfo, codec, padded,
                                                 want)
                      for _ in range(args.dispatch)]:
                f.result()            # warm + compile
            t0 = time.perf_counter()
            for _ in range(args.iterations):
                futs = [g_dispatcher.submit_encode(sinfo, codec, padded,
                                                   want)
                        for _ in range(args.dispatch)]
                for f in futs:
                    f.result()
            dt = time.perf_counter() - t0
        finally:
            for nm, v in saved.items():
                g_conf.rm_val(nm) if v is None else g_conf.set_val(nm, v)
            g_dispatcher.flush()
        kib = args.iterations * args.dispatch * size // 1024
        print(f"{dt:.6f}\t{kib}")
        return 0

    if args.workload == "encode":
        if args.batch and hasattr(codec, "encode_batch"):
            C = codec.get_chunk_size(size)
            stripes = np.ascontiguousarray(
                np.resize(data, (args.batch, k, C)))
            codec.encode_batch(stripes)  # warm + compile
            t0 = time.perf_counter()
            for _ in range(args.iterations):
                codec.encode_batch(stripes)
            dt = time.perf_counter() - t0
            kib = args.iterations * args.batch * size // 1024
        else:
            t0 = time.perf_counter()
            for _ in range(args.iterations):
                codec.encode(set(range(n)), data)
            dt = time.perf_counter() - t0
            kib = args.iterations * size // 1024
        print(f"{dt:.6f}\t{kib}")
        return 0

    # decode workload
    enc = codec.encode(set(range(n)), data)
    if args.erasures_generation == "exhaustive":
        patterns = list(itertools.combinations(range(n), args.erasures))
    elif args.erased:
        patterns = [tuple(args.erased)]
    else:
        patterns = [tuple(sorted(rng.choice(n, size=args.erasures,
                                            replace=False).tolist()))
                    for _ in range(args.iterations)]
    want = set(range(k))
    t0 = time.perf_counter()
    done = 0
    for i in range(args.iterations):
        lost = patterns[i % len(patterns)]
        have = {j: enc[j] for j in range(n) if j not in lost}
        codec.decode(want, have)
        done += 1
    dt = time.perf_counter() - t0
    print(f"{dt:.6f}\t{done * size // 1024}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
