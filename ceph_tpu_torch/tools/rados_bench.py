"""rados bench — end-to-end pool IO benchmark on the vstart-lite cluster.

The reference's qa tier drives `rados bench` against a localhost cluster
(qa/standalone/erasure-code/test-erasure-code.sh:21-53); this tool spins a
MiniCluster with an EC (or replicated) pool and measures full-stack
write/read throughput — client → primary → batched device EC encode →
shard fan-out → memstore and back.

Port of ``ceph_tpu/tools/rados_bench.py``; ``--plugin`` defaults to
``cuda``, and the EC pool's codec runs on the card unless the caller asks
for the CPU (``main(argv, device="cpu")`` gives it ``backend=host``).
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv=None, device="cuda") -> int:
    """rados bench with ``argv`` (default ``sys.argv[1:]``)."""
    p = argparse.ArgumentParser(prog="rados_bench")
    p.add_argument("seconds", type=int, nargs="?", default=5)
    p.add_argument("mode", choices=("write", "seq"), nargs="?",
                   default="write")
    p.add_argument("--osds", type=int, default=7)
    p.add_argument("--pool-type", choices=("ec", "replicated"),
                   default="ec")
    p.add_argument("--plugin", default="cuda")
    p.add_argument("-k", type=int, default=4)
    p.add_argument("-m", type=int, default=2)
    p.add_argument("--object-size", type=int, default=1 << 20)
    p.add_argument("--pg-num", type=int, default=16)
    args = p.parse_args(argv)

    from ..cluster import MiniCluster
    c = MiniCluster(n_osds=args.osds)
    if args.pool_type == "ec":
        c.create_ec_pool("bench", k=args.k, m=args.m, pg_num=args.pg_num,
                         plugin=args.plugin,
                         extra_profile=None if device == "cuda"
                         else {"backend": "host"})
    else:
        c.create_replicated_pool("bench", pg_num=args.pg_num)
    client = c.client("client.bench")
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, size=args.object_size,
                        dtype=np.uint8).tobytes()

    # warm (compiles the device encode path)
    client.write_full("bench", "warm", data)

    n = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < args.seconds:
        assert client.write_full("bench", f"obj{n}", data) == 0
        n += 1
    dt = time.perf_counter() - t0
    wmbs = n * args.object_size / dt / (1 << 20)
    print(f"write: {n} objects x {args.object_size} B in {dt:.2f}s = "
          f"{wmbs:.1f} MB/s")

    if args.mode == "seq" or True:
        t0 = time.perf_counter()
        for i in range(n):
            assert client.read("bench", f"obj{i}") == data
        dt = time.perf_counter() - t0
        rmbs = n * args.object_size / dt / (1 << 20)
        print(f"seq read: {n} objects in {dt:.2f}s = {rmbs:.1f} MB/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
