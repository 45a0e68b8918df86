"""ceph-kvstore-tool: offline key/value store surgery
(src/tools/ceph_kvstore_tool.cc), usage and command surface pinned by
src/test/cli/ceph-kvstore-tool/help.t.

The backing store here is a directory of url-escaped
``<path>/<prefix>/<key>`` files — the KeyValueDB role (leveldb/
rocksdb/bluestore-kv in the reference) for this framework's offline
tooling: durable, inspectable, and transactional enough for a
repair/copy tool (each set/rm is a whole-file atomic rename).

The port's own copy of ``ceph_tpu/tools/kvstore_tool.py``: the same argv
gives the same output, exit code and files.
"""
from __future__ import annotations

import os
import sys
from typing import Iterator, Optional, Tuple

from ..utils.crc32c import crc32c

USAGE = """Usage: ceph-kvstore-tool <leveldb|rocksdb|bluestore-kv> <store path> command [args...]

Commands:
  list [prefix]
  list-crc [prefix]
  exists <prefix> [key]
  get <prefix> <key> [out <file>]
  crc <prefix> <key>
  get-size [<prefix> <key>]
  set <prefix> <key> [ver <N>|in <file>]
  rm <prefix> <key>
  rm-prefix <prefix>
  store-copy <path> [num-keys-per-tx] [leveldb|rocksdb|...] 
  store-crc <path>
  compact
  compact-prefix <prefix>
  compact-range <prefix> <start> <end>
  repair

"""

TYPES = ("leveldb", "rocksdb", "bluestore-kv")


def url_escape(s: str) -> str:
    out = []
    for ch in s.encode():
        if ch <= 0x20 or ch >= 0x7F or ch in (0x25, 0x2F):  # % and /
            out.append("%%%02x" % ch)
        else:
            out.append(chr(ch))
    return "".join(out)


def url_unescape(s: str) -> str:
    out = bytearray()
    i = 0
    hexd = "0123456789abcdefABCDEF"
    while i < len(s):
        if s[i] == "%" and i + 2 < len(s) and s[i + 1] in hexd \
                and s[i + 2] in hexd:
            out.append(int(s[i + 1:i + 3], 16))
            i += 3
        else:
            out.append(ord(s[i]))
            i += 1
    return out.decode()


class DirStore:
    """KeyValueDB-lite over a directory tree."""

    def __init__(self, path: str, create: bool = False):
        self.path = path
        if create:
            os.makedirs(path, exist_ok=True)
        if not os.path.isdir(path):
            raise FileNotFoundError(path)

    def _pdir(self, prefix: str) -> str:
        return os.path.join(self.path, url_escape(prefix))

    def _kfile(self, prefix: str, key: str) -> str:
        return os.path.join(self._pdir(prefix), url_escape(key))

    def iterate(self, prefix: str = ""
                ) -> Iterator[Tuple[str, str, bytes]]:
        for pesc in sorted(os.listdir(self.path)):
            p = url_unescape(pesc)
            if prefix and p != prefix:
                continue
            pdir = os.path.join(self.path, pesc)
            if not os.path.isdir(pdir):
                continue
            for kesc in sorted(os.listdir(pdir)):
                with open(os.path.join(pdir, kesc), "rb") as f:
                    yield p, url_unescape(kesc), f.read()

    def get(self, prefix: str, key: str) -> Optional[bytes]:
        try:
            with open(self._kfile(prefix, key), "rb") as f:
                return f.read()
        except OSError:
            return None

    def set(self, prefix: str, key: str, value: bytes) -> None:
        os.makedirs(self._pdir(prefix), exist_ok=True)
        tmp = self._kfile(prefix, key) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(value)
        os.replace(tmp, self._kfile(prefix, key))

    def rm(self, prefix: str, key: str) -> bool:
        try:
            os.unlink(self._kfile(prefix, key))
            return True
        except OSError:
            return False

    def rm_prefix(self, prefix: str) -> None:
        pdir = self._pdir(prefix)
        if os.path.isdir(pdir):
            for k in os.listdir(pdir):
                os.unlink(os.path.join(pdir, k))
            os.rmdir(pdir)

    def exists_any(self, prefix: str) -> bool:
        pdir = self._pdir(prefix)
        return os.path.isdir(pdir) and bool(os.listdir(pdir))

    def size(self) -> int:
        """Whole-store byte size (StoreTool::get_size role) via stat,
        without reading any values."""
        total = 0
        for pesc in os.listdir(self.path):
            pdir = os.path.join(self.path, pesc)
            if not os.path.isdir(pdir):
                continue
            for kesc in os.listdir(pdir):
                total += os.stat(os.path.join(pdir, kesc)).st_size
        return total


def _pair_crc(prefix: str, key: str, value: bytes,
              seed: int = 0) -> int:
    """crc32c over prefix+key+value concatenated with no separators
    (StoreTool::traverse builds one bufferlist of the three)."""
    return crc32c(prefix.encode() + key.encode() + value, seed)


def _si_t(n: int) -> str:
    """byte count with binary-SI suffix (include/types.h si_t)."""
    for mag, suffix in ((40, "T"), (30, "G"), (20, "M"), (10, "k")):
        if n >= 1 << mag:
            return f"{n >> mag}{suffix}"
    return str(n)


def main(argv: Optional[list] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if len(args) < 3:
        sys.stderr.write(USAGE)
        return 1
    type_, path, cmd, rest = args[0], args[1], args[2], args[3:]
    if type_ not in TYPES:
        sys.stderr.write(f"Unrecognized type: {type_}\n")
        sys.stderr.write(USAGE)
        return 1
    try:
        st = DirStore(path, create=cmd in ("set", "repair"))
    except FileNotFoundError:
        sys.stderr.write(f"failed to open type {type_} path {path}\n")
        return 1

    if cmd == "repair":
        print("repair kvstore successfully")
        return 0
    if cmd in ("list", "list-crc"):
        prefix = url_unescape(rest[0]) if rest else ""
        for p, k, v in st.iterate(prefix):
            line = f"{url_escape(p)}\t{url_escape(k)}"
            if cmd == "list-crc":
                line += f"\t{_pair_crc(p, k, v)}"
            print(line)
        return 0
    if cmd == "exists":
        if not rest:
            sys.stderr.write(USAGE)
            return 1
        prefix = url_unescape(rest[0])
        key = url_unescape(rest[1]) if len(rest) > 1 else ""
        if key:
            found = st.get(prefix, key) is not None
        else:
            found = st.exists_any(prefix)
        print(f"({url_escape(prefix)}, {url_escape(key)}) "
              + ("exists" if found else "does not exist"))
        return 0 if found else 1
    if cmd == "get":
        if len(rest) < 2:
            sys.stderr.write(USAGE)
            return 1
        prefix, key = url_unescape(rest[0]), url_unescape(rest[1])
        v = st.get(prefix, key)
        head = f"({url_escape(prefix)}, {url_escape(key)})"
        if v is None:
            print(head + " does not exist")
            return 1
        print(head)
        if len(rest) >= 3:
            if rest[2] != "out":
                sys.stderr.write(f"unrecognized subcmd '{rest[2]}'\n")
                return 1
            if len(rest) < 4 or not rest[3]:
                sys.stderr.write("output path not specified\n")
                return 1
            with open(rest[3], "wb") as f:
                f.write(v)
            print(f"wrote {len(v)} bytes to {rest[3]}")
        else:
            # hexdump-style preview matching bufferlist::hexdump's role
            for off in range(0, len(v), 16):
                chunk = v[off:off + 16]
                hexs = " ".join(f"{b:02x}" for b in chunk)
                print(f"{off:08x}  {hexs}")
        return 0
    if cmd == "crc":
        if len(rest) < 2:
            sys.stderr.write(USAGE)
            return 1
        prefix, key = url_unescape(rest[0]), url_unescape(rest[1])
        v = st.get(prefix, key)
        if v is None:
            print(f"({url_escape(prefix)}, {url_escape(key)}) "
                  "does not exist")
            return 1
        print(f"({url_escape(prefix)}, {url_escape(key)}) crc "
              f"{_pair_crc(prefix, key, v)}")
        return 0
    if cmd == "get-size":
        # reference shape (ceph_kvstore_tool.cc:446-467): the whole-
        # store estimate always prints first; a lone extra arg is a
        # usage error; prefix+key adds the pair's size line
        print(f"estimated store size: {st.size()}")
        if not rest:
            return 0
        if len(rest) < 2:
            sys.stderr.write(USAGE)
            return 1
        prefix, key = url_unescape(rest[0]), url_unescape(rest[1])
        v = st.get(prefix, key)
        if v is None:
            sys.stderr.write(f"({url_escape(prefix)},"
                             f"{url_escape(key)}) does not exist\n")
            return 1
        print(f"({url_escape(prefix)},{url_escape(key)}) size "
              f"{_si_t(len(v))}")
        return 0
    if cmd == "set":
        if len(rest) < 2:
            sys.stderr.write(USAGE)
            return 1
        prefix, key = url_unescape(rest[0]), url_unescape(rest[1])
        if len(rest) >= 4 and rest[2] == "ver":
            import struct
            val = struct.pack("<Q", int(rest[3]))
        elif len(rest) >= 4 and rest[2] == "in":
            try:
                with open(rest[3], "rb") as f:
                    val = f.read()
            except OSError as e:
                sys.stderr.write(f"error reading file {rest[3]}: "
                                 f"{e.strerror}\n")
                return 1
        else:
            sys.stderr.write(USAGE)
            return 1
        st.set(prefix, key, val)
        return 0
    if cmd == "rm":
        if len(rest) < 2:
            sys.stderr.write(USAGE)
            return 1
        ok = st.rm(url_unescape(rest[0]), url_unescape(rest[1]))
        return 0 if ok else 1
    if cmd == "rm-prefix":
        if not rest:
            sys.stderr.write(USAGE)
            return 1
        st.rm_prefix(url_unescape(rest[0]))
        return 0
    if cmd == "store-copy":
        if not rest:
            sys.stderr.write(USAGE)
            return 1
        dst = DirStore(rest[0], create=True)
        n = 0
        for p, k, v in st.iterate(""):
            dst.set(p, k, v)
            n += 1
        print("summary:")
        print(f"  copied {n} keys")
        return 0
    if cmd == "store-crc":
        # traverse with the dump written to <path> (the reference's
        # ofstream(argv[4])), crc chained with no separators from -1
        if not rest:
            sys.stderr.write(USAGE)
            return 1
        crc = 0xFFFFFFFF
        with open(rest[0], "w") as dump:
            for p, k, v in st.iterate(""):
                dump.write(f"{url_escape(p)}\t{url_escape(k)}\t"
                           f"{_pair_crc(p, k, v)}\n")
                crc = _pair_crc(p, k, v, crc)
        print(f"store at '{rest[0]}' crc {crc}")
        return 0
    if cmd in ("compact", "compact-prefix", "compact-range"):
        return 0        # directory store has nothing to compact
    sys.stderr.write(f"Unrecognized command: {cmd}\n")
    sys.stderr.write(USAGE)
    return 1


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
