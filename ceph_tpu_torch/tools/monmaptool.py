"""monmaptool — build/inspect MonMap files (src/tools/monmaptool.cc).

Output strings, staging order, and exit codes are pinned byte-exact
against the reference's own recorded cram suite
(src/test/cli/monmaptool/*.t): create/clobber, add/rm with their
usage-on-error shapes, --print, and the feature set/unset/list
machinery including unknown(N) rendering.

The port's own copy of ``ceph_tpu/tools/monmaptool.py``: the same argv
gives the same output, exit code and files.
"""
from __future__ import annotations

import os
import sys
import uuid as _uuid

USAGE = """ usage: [--print] [--create [--clobber][--fsid uuid]]
        [--generate] [--set-initial-members]
        [--add name 1.2.3.4:567] [--rm name]
        [--feature-list [plain|parseable]]
        [--feature-set <value> [--optional|--persistent]]
        [--feature-unset <value> [--optional|--persistent]] <mapfilename>"""


def _usage() -> None:
    print(USAGE)


def _parse_feature(val: str):
    from ..mon.monmap import FEATURE_VALUES
    if val in FEATURE_VALUES:
        return FEATURE_VALUES[val]
    try:
        return int(val)
    except ValueError:
        return None


def _fmt_features(bits: int) -> str:
    from ..mon.monmap import FEATURE_NAMES
    if not bits:
        return "[none]"
    parts = []
    b = 1
    while b <= bits:
        if bits & b:
            parts.append(f"{FEATURE_NAMES.get(b, 'unknown')}({b})")
        b <<= 1
    return "[" + ",".join(parts) + "]"


def _feature_list(m, mode: str) -> None:
    from ..mon.monmap import PERSISTENT, SUPPORTED
    req = m.persistent_features | m.optional_features
    if mode == "parseable":
        print(f"monmap:persistent:{_fmt_features(m.persistent_features)}")
        print(f"monmap:optional:{_fmt_features(m.optional_features)}")
        print(f"monmap:required:{_fmt_features(req)}")
        print(f"available:supported:{_fmt_features(SUPPORTED)}")
        print(f"available:persistent:{_fmt_features(PERSISTENT)}")
        return
    print("MONMAP FEATURES:")
    print(f"    persistent: {_fmt_features(m.persistent_features)}")
    print(f"    optional:   {_fmt_features(m.optional_features)}")
    print(f"    required:   {_fmt_features(req)}")
    print("")
    print("AVAILABLE FEATURES:")
    print(f"    supported:  {_fmt_features(SUPPORTED)}")
    print(f"    persistent: {_fmt_features(PERSISTENT)}")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        return _parse_and_run(argv)
    except IndexError:
        # a flag missing its operand (--add name, --fsid, ...)
        _usage()
        return 1


def _parse_and_run(argv) -> int:
    from ..mon.monmap import MonMap
    fname = None
    do_print = create = clobber = False
    fsid = None
    adds = []            # (name, addr)
    rms = []
    # feature ops: (set?, value, which) resolved in argv order — the
    # --optional/--persistent MODIFIER binds to the preceding op
    fops = []
    flists = []          # list-mode strings in argv order
    i = 0
    seen_dashdash = False
    while i < len(argv):
        a = argv[i]
        if a == "--" and not seen_dashdash:
            seen_dashdash = True
        elif not seen_dashdash and a == "--help":
            _usage()
            return 1
        elif not seen_dashdash and a == "--print":
            do_print = True
        elif not seen_dashdash and a == "--create":
            create = True
        elif not seen_dashdash and a == "--clobber":
            clobber = True
        elif not seen_dashdash and a == "--generate":
            pass                               # conf-driven: lite no-op
        elif not seen_dashdash and a == "--set-initial-members":
            pass
        elif not seen_dashdash and a == "--fsid":
            i += 1
            fsid = argv[i]
        elif not seen_dashdash and a == "--add":
            name, addr = argv[i + 1], argv[i + 2]
            i += 2
            adds.append((name, addr))
        elif not seen_dashdash and a == "--rm":
            i += 1
            rms.append(argv[i])
        elif not seen_dashdash and a in ("--feature-set",
                                         "--feature-unset"):
            i += 1
            raw = argv[i] if i < len(argv) else ""
            val = _parse_feature(raw)
            if val is None:
                print(f"unknown features name '{raw}' or unable to "
                      f"parse value: Expected option value to be "
                      f"integer, got '{raw}'")
                _usage()
                return 1
            fops.append([a == "--feature-set", val, "persistent"])
        elif not seen_dashdash and a in ("--optional", "--persistent"):
            if fops:
                fops[-1][2] = a[2:]
        elif not seen_dashdash and a == "--feature-list":
            # optional mode argument
            if i + 1 < len(argv) and argv[i + 1] in ("plain",
                                                     "parseable"):
                i += 1
                flists.append(argv[i])
            else:
                flists.append("plain")
        else:
            fname = a
        i += 1
    if fname is None:
        print("monmaptool: must specify monmap filename")
        _usage()
        return 1
    print(f"monmaptool: monmap file {fname}")
    modified = False
    if create:
        if os.path.exists(fname) and not clobber:
            print(f"monmaptool: {fname} exists, --clobber to "
                  f"overwrite")
            return 255
        m = MonMap(fsid=fsid)
        if fsid is None:
            print(f"monmaptool: generated fsid {m.fsid}")
        else:
            try:
                _uuid.UUID(fsid)
            except ValueError:
                print(f"monmaptool: invalid fsid '{fsid}'")
                return 255
        modified = True
    else:
        try:
            raw = open(fname, "rb").read()
        except FileNotFoundError:
            print(f"monmaptool: couldn't open {fname}: (2) No such "
                  f"file or directory")
            return 255
        try:
            m = MonMap.from_bytes(raw)
        except (ValueError, KeyError):
            print("monmaptool: unable to read monmap file")
            return 255
    for name, addr in adds:
        if ":" not in addr.split("/", 1)[0]:
            addr += ":6789"      # the reference's default mon port
        if m.contains(name):
            print(f"monmaptool: map already contains mon.{name}")
            _usage()
            return 1
        m.add(name, addr)
        modified = True
    for name in rms:
        print(f"monmaptool: removing {name}")
        if not m.contains(name):
            print(f"monmaptool: map does not contain {name}")
            _usage()
            return 1
        m.remove(name)
        modified = True
    for is_set, val, which in fops:
        attr = f"{which}_features"
        cur = getattr(m, attr)
        setattr(m, attr, (cur | val) if is_set else (cur & ~val))
        modified = True
    for mode in flists:
        _feature_list(m, mode)
    if do_print:
        for line in m.print_lines():
            print(line)
    if modified:
        import time as _time
        m.last_changed = _time.time()
        print(f"monmaptool: writing epoch {m.epoch} to {fname} "
              f"({len(m.mons)} monitors)")
        with open(fname, "wb") as f:
            f.write(m.to_bytes())
    return 0


if __name__ == "__main__":
    # die silently on a closed pipe (`tool ... | head`), like the
    # C++ tools' default SIGPIPE disposition
    import signal
    signal.signal(signal.SIGPIPE, signal.SIG_DFL)
    sys.exit(main())
