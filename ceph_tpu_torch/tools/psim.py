"""psim — placement distribution simulator (src/tools/psim.cc analog).

Builds (or loads) an OSDMap, maps every PG of every pool, and prints the
per-OSD object count histogram — the quick eyeball check for CRUSH weight
fairness the reference ships as a standalone binary.

Port of ``ceph_tpu/tools/psim.py``.  The map is read through
``osdmaptool.load_map`` (which takes only this package's classes), and
every PG is mapped by ``OSDMapMapping`` on ``device`` (the card unless
the caller asks for the CPU); ``--host-mapper`` maps on the host.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..crush.constants import CRUSH_ITEM_NONE
from ..osdmap import OSDMapMapping
from .osdmaptool import load_map


def main(argv=None, device="cuda") -> int:
    """psim with ``argv`` (default ``sys.argv[1:]``)."""
    p = argparse.ArgumentParser(prog="psim")
    p.add_argument("mapfn", help="osdmap file (pickle)")
    p.add_argument("--objects", type=int, default=1024,
                   help="simulated objects per pool")
    p.add_argument("--host-mapper", action="store_true")
    args = p.parse_args(argv)

    with open(args.mapfn, "rb") as f:
        m = load_map(f.read())
    mapping = OSDMapMapping(use_device=not args.host_mapper, device=device)
    mapping.update(m)
    count = np.zeros(m.max_osd, dtype=np.int64)
    for pid, pool in m.pools.items():
        pm = mapping.pools[pid]
        for obj in range(args.objects):
            ps = obj % pool.pg_num
            for o in pm.acting[ps]:
                if o != CRUSH_ITEM_NONE:
                    count[o] += 1
    for o in range(m.max_osd):
        bar = "*" * int(60 * count[o] / max(1, count.max()))
        print(f"osd.{o}\t{count[o]}\t{bar}")
    used = count[count > 0]
    if len(used):
        print(f"avg {used.mean():.1f}  min {used.min()}  max {used.max()}  "
              f"spread {(used.max() - used.min()) / max(1, used.mean()):.2%}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
