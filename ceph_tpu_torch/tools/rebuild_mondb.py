"""rebuild-mondb: reconstruct a LOST monitor store from surviving
OSDs (src/tools/rebuild_mondb.cc update_osdmap / the documented
mon-store disaster-recovery flow).

Every OSD persists each osdmap incremental it applies into its meta
collection (inc_osdmap.<epoch>, osd/osd.py _persist_incremental);
this tool scans every osd store in a checkpoint directory, takes the
UNION of epochs across OSDs (any single OSD may have joined late or
died early), replays them from scratch, and writes a fresh mon.json
the cluster restores from.

usage: rebuild-mondb <checkpoint-dir> [--mon NAME=ADDR ...] [--force]

The port's own copy of ``ceph_tpu/tools/rebuild_mondb.py``: the same argv
gives the same output, exit code and files.
"""
from __future__ import annotations

import glob
import json
import os
import sys
from typing import Dict, List, Optional

USAGE = ("usage: rebuild-mondb <checkpoint-dir> "
         "[--mon NAME=ADDR ...] [--force]\n")


def collect_incrementals(ckpt: str) -> Dict[int, dict]:
    """epoch -> incremental dict, unioned across every osd store."""
    from ..msg.wire import decode_blob
    from ..os_store.memstore import MemStore

    out: Dict[int, dict] = {}
    stores = sorted(glob.glob(os.path.join(ckpt, "osd.*.store")))
    if not stores:
        raise FileNotFoundError(f"no osd stores under {ckpt}")
    for path in stores:
        store = MemStore.load(path)
        if not store.collection_exists("meta"):
            continue
        for ho in store.list_objects("meta"):
            name = ho.oid if isinstance(ho.oid, str) else str(ho.oid)
            if not name.startswith("inc_osdmap."):
                continue
            epoch = int(name.split(".", 1)[1])
            if epoch in out:
                continue
            raw = store.read("meta", ho, 0, 1 << 30)
            out[epoch] = decode_blob(bytes(raw))
    return out


def rebuild(ckpt: str, mons: Optional[List[str]] = None,
            force: bool = False) -> str:
    """Reconstruct <ckpt>/mon.json; returns a summary line."""
    from ..mon.monitor import mon_store_state
    from ..mon.monmap import MonMap
    from ..osdmap.encoding import incremental_from_dict
    from ..osdmap.osdmap import OSDMap

    mon_path = os.path.join(ckpt, "mon.json")
    if os.path.exists(mon_path) and not force:
        raise FileExistsError(
            f"{mon_path} already exists; pass --force to overwrite")

    incs = collect_incrementals(ckpt)
    if not incs:
        raise ValueError("no osdmap incrementals found in any osd "
                         "store — nothing to rebuild from")
    epochs = sorted(incs)
    if epochs[0] != 1:
        raise ValueError(f"history starts at epoch {epochs[0]}, not 1 "
                         "— a full map cannot be reconstructed")
    missing = [e for e in range(1, epochs[-1] + 1) if e not in incs]
    if missing:
        raise ValueError(f"gaps in the recovered history: {missing}")

    m = OSDMap()
    inc_objs = []
    for e in epochs:
        inc = incremental_from_dict(incs[e])
        inc_objs.append(inc)
        m.apply_incremental(inc)

    # the monmap is mon-side state the OSD stores never held; rebuild
    # a fresh epoch-1 map (names from --mon, or the single default)
    mm = MonMap()
    for spec in (mons or ["mon=127.0.0.1:6789"]):
        name, _, addr = spec.partition("=")
        mm.add(name, addr or "127.0.0.1:6789")
    mm.epoch = 1                       # a committed roster, not epoch 0

    state = mon_store_state(m, inc_objs, mm)
    tmp = mon_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(state, f)
    os.replace(tmp, mon_path)
    return (f"rebuilt {mon_path}: epochs 1..{epochs[-1]} from "
            f"{len(epochs)} incrementals")


def main(argv: Optional[List[str]] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if args and args[0] in ("-h", "--help"):
        sys.stdout.write(USAGE)
        return 0
    if not args:
        sys.stderr.write(USAGE)
        return 1
    ckpt = args[0]
    mons: List[str] = []
    force = False
    i = 1
    while i < len(args):
        if args[i] == "--mon":
            if i + 1 >= len(args):
                sys.stderr.write("--mon requires NAME=ADDR\n")
                return 1
            mons.append(args[i + 1])
            i += 2
        elif args[i] == "--force":
            force = True
            i += 1
        else:
            sys.stderr.write(f"unknown argument '{args[i]}'\n{USAGE}")
            return 1
    try:
        print(rebuild(ckpt, mons or None, force))
    except (OSError, ValueError) as e:
        sys.stderr.write(f"rebuild-mondb: {e}\n")
        return 1
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
