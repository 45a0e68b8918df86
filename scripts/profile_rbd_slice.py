"""Where a block device on an erasure-coded data pool spends its host
time: ``chip_smoke.rbd_slice`` (the smoke's 4x) under ``cProfile`` on the
card, its functions by own time and by cumulative time written to
``chiprun_out/rbd_prof.txt``.

    python3 scripts/profile_rbd_slice.py

Needs the card; builds the kernels first.  The profiler's own cost is in
every wall this run prints, so read its walls as relative only.
"""
import cProfile
import io
import os
import pstats
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

if __name__ == "__main__":
    import torch

    import chip_smoke
    from ceph_tpu_torch.ops import _build
    _build.build_all()
    prof = cProfile.Profile()
    prof.enable()
    chip_smoke.rbd_slice(torch.device("cuda"))
    prof.disable()
    buf = io.StringIO()
    stats = pstats.Stats(prof, stream=buf)
    stats.sort_stats("tottime").print_stats(40)
    stats.sort_stats("cumtime").print_stats(120)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "rbd_prof.txt"), "w") as f:
        f.write(buf.getvalue())
