"""ceph-monstore-tool: offline monitor-store surgery
(src/tools/ceph_monstore_tool.cc role) over the mon store the
framework persists (mon.json — Monitor.save's authoritative map +
full incremental history + MonMap).

The extraction commands emit artifacts the sibling tools consume
directly: ``get crushmap`` writes the reference-compatible crushmap
binary (crushtool -d readable), ``get monmap`` writes monmaptool's
binary format, ``get osdmap`` writes osdmaptool's map-file format.
``get osdmap --version V`` rebuilds epoch V by replaying the stored
incremental history from scratch (MonitorDBStore's per-version
osdmap keys, reconstructed instead of stored).

The port's own copy of ``ceph_tpu/tools/monstore_tool.py``: the same argv
gives the same output, exit code and files.
"""
from __future__ import annotations

import json
import os
import sys
from typing import List, Optional

USAGE = """usage: ceph-monstore-tool <store-path> <cmd> [args|options]

Commands:
  store-copy PATH                 copies store to PATH
  compact                         compacts the store
  get monmap [-o FILE]            get monmap (last committed)
  get osdmap [-v VER] [-o FILE]   get osdmap (version VER if specified)
                                  (default: last committed)
  get crushmap [-v VER] [-o FILE] get crushmap from that osdmap
  get mdsmap [-o FILE]            get the fsmap (json)
  show-versions                   show the first&last committed version of map
  dump-keys                       dumps store keys to stdout
  dump-paxos [-v VER]             dump committed transactions (json)
  rewrite-crush --crush FILE      add a commit replacing the crush map
"""


class MonStore:
    """One loaded mon store (a mon.json file or a checkpoint dir
    containing one)."""

    def __init__(self, path: str):
        if os.path.isdir(path):
            path = os.path.join(path, "mon.json")
        self.path = path
        with open(path) as f:
            self.state = json.load(f)

    def save(self, path: Optional[str] = None) -> None:
        out = path or self.path
        tmp = out + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.state, f)
        os.replace(tmp, out)

    # ---- map accessors -----------------------------------------------------
    def latest_osdmap(self):
        from ..osdmap.encoding import osdmap_from_dict
        return osdmap_from_dict(self.state["osdmap"])

    def incrementals(self) -> List:
        from ..osdmap.encoding import incremental_from_dict
        return [incremental_from_dict(d)
                for d in self.state["incrementals"]]

    def osdmap_at(self, version: Optional[int]):
        """Rebuild epoch ``version`` by replay; None = last
        committed (served from the stored full map, no history
        decode)."""
        if version is None:
            return self.latest_osdmap()
        incs = self.incrementals()
        last = incs[-1].epoch if incs else 0
        if version < 1 or version > last:
            raise ValueError(f"no osdmap version {version} in store "
                             f"(have 1..{last})")
        if version == last:
            return self.latest_osdmap()
        from ..osdmap.osdmap import OSDMap
        m = OSDMap()
        for inc in incs:
            if inc.epoch > version:
                break
            m.apply_incremental(inc)
        if m.epoch != version:
            raise ValueError(f"no osdmap version {version} in store "
                             f"(have 1..{last})")
        return m

    def monmap(self):
        from ..mon.monmap import MonMap
        return MonMap.from_bytes(
            self.state["monmap"].encode("latin1"))

    def versions(self):
        incs = self.state["incrementals"]
        first = incs[0]["epoch"] if incs else 0
        last = incs[-1]["epoch"] if incs else \
            self.state["osdmap"]["epoch"]
        return first, last


def _write(data: bytes, out: Optional[str], what: str) -> None:
    if out:
        with open(out, "wb") as f:
            f.write(data)
        print(f"wrote {what} ({len(data)} bytes) to {out}")
    else:
        sys.stdout.buffer.write(data)


def main(argv: Optional[List[str]] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if len(args) < 2 or args[0] in ("-h", "--help"):
        sys.stderr.write(USAGE)
        return 1
    store_path, cmd, rest = args[0], args[1], args[2:]
    try:
        st = MonStore(store_path)
    except (OSError, ValueError, KeyError) as e:
        sys.stderr.write(f"error opening store '{store_path}': "
                         f"{e!r}\n")
        return 1

    def opt(name: str, short: str) -> Optional[str]:
        for flag in (name, short):
            if flag in rest:
                i = rest.index(flag)
                if i + 1 < len(rest):
                    return rest[i + 1]
        return None

    ver = opt("--version", "-v")
    out = opt("--out", "-o")

    if cmd == "store-copy":
        if not rest:
            sys.stderr.write(USAGE)
            return 1
        dst = rest[0]
        if os.path.isdir(dst):
            # copying into a directory produces a store the tool can
            # itself reopen (mon.json inside it)
            dst = os.path.join(dst, "mon.json")
        try:
            st.save(dst)
        except OSError as e:
            sys.stderr.write(f"error writing {dst}: {e.strerror}\n")
            return 1
        print(f"copied store to {dst}")
        return 0
    if cmd == "compact":
        st.save()
        return 0
    if cmd == "get":
        if not rest:
            sys.stderr.write(USAGE)
            return 1
        what = rest[0]
        try:
            if what == "monmap":
                _write(st.monmap().to_bytes(), out, "monmap")
            elif what == "osdmap":
                import pickle
                m = st.osdmap_at(int(ver) if ver else None)
                _write(pickle.dumps(m), out, f"osdmap epoch {m.epoch}")
            elif what == "crushmap":
                from ..crush.binfmt import encode_crushmap
                m = st.osdmap_at(int(ver) if ver else None)
                _write(encode_crushmap(m.crush), out,
                       f"crushmap of epoch {m.epoch}")
            elif what == "mdsmap":
                # the fsmap rides the config-kv incrementals; take the
                # last one seen in the history
                fsmap = None
                for d in st.state["incrementals"]:
                    kv = d.get("service_config_kv") or {}
                    if "fsmap" in kv:
                        fsmap = kv["fsmap"]
                if fsmap is None:
                    sys.stderr.write("no fsmap in store\n")
                    return 1
                _write((fsmap + "\n").encode(), out, "fsmap")
            else:
                sys.stderr.write(f"unknown map '{what}'\n")
                return 1
        except ValueError as e:
            sys.stderr.write(f"{e}\n")
            return 1
        return 0
    if cmd == "show-versions":
        first, last = st.versions()
        print(f"first committed:\t{first}")
        print(f"last  committed:\t{last}")
        return 0
    if cmd == "dump-keys":
        for d in st.state["incrementals"]:
            print(f"osdmap\t{d['epoch']}")
        print(f"osdmap\tfull_{st.state['osdmap']['epoch']}")
        print("monmap\tlatest")
        return 0
    if cmd == "dump-paxos":
        incs = st.state["incrementals"]
        if ver:
            if not ver.isdigit():
                sys.stderr.write("dump-paxos: -v requires a numeric "
                                 "version\n")
                return 1
            incs = [d for d in incs if d["epoch"] == int(ver)]
        json.dump(incs, sys.stdout, indent=2, sort_keys=True)
        print()
        return 0
    if cmd == "rewrite-crush":
        crush_file = opt("--crush", "-c")
        if not crush_file:
            sys.stderr.write("rewrite-crush requires --crush FILE\n")
            return 1
        from ..crush.binfmt import decode_crushmap
        from ..osdmap.encoding import incremental_to_dict, \
            osdmap_to_dict
        from ..osdmap.osdmap import Incremental
        with open(crush_file, "rb") as f:
            cw = decode_crushmap(f.read())
        m = st.latest_osdmap()
        inc = Incremental()
        inc.epoch = m.epoch + 1
        inc.crush = cw
        m.apply_incremental(inc)
        st.state["incrementals"].append(incremental_to_dict(inc))
        st.state["osdmap"] = osdmap_to_dict(m)
        st.save()
        print(f"committed epoch {m.epoch} with the new crush map")
        return 0
    sys.stderr.write(f"unknown command '{cmd}'\n")
    sys.stderr.write(USAGE)
    return 1


if __name__ == "__main__":  # pragma: no cover
    try:
        sys.exit(main())
    except BrokenPipeError:
        sys.exit(0)
