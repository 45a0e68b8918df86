"""ceph-dencoder: encode/decode/inspect the framework's wire types
(src/test/encoding/ceph_dencoder.cc role, same command-stream CLI).

One in-memory object + one encoded buffer, driven by a sequence of
commands::

    ceph-dencoder type MOSDOp select_test 1 encode decode dump_json
    ceph-dencoder type OSDMap import mapfile decode dump_json
    ceph-dencoder type MMonPaxos is_deterministic

Registered types: every wire-codable M* message (msg/wire.py's
registry), plus the structured cluster types with their own codecs —
OSDMap and OSDMap.Incremental (osdmap/encoding.py, the mon-store
representation), CrushWrapper (the reference-compatible crushmap
binary, crush/binfmt.py) and MonMap (mon/monmap.py).

This is the encoding non-regression surface the reference drives
with ceph-object-corpus + test/encoding/readable.sh: round-trip
identity and encode-determinism per type (tests/test_dencoder.py
replays both checks over every registered type).

The port's own copy of ``ceph_tpu/tools/dencoder.py``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
from typing import Any, Callable, Dict, List, Optional

USAGE = """usage: ceph-dencoder [commands ...]

  version             print version string (for utility)
  import <encfile>    read encoded data from encfile
  export <outfile>    write encoded data to outfile
  list_types          list supported types
  type <classname>    select in-memory type
  skip <num>          skip <num> leading bytes before decoding
  decode              decode into in-memory object
  encode              encode in-memory object
  dump_json           dump in-memory object as json (to stdout)
  copy                copy object (via operator=)
  copy_ctor           copy object (via copy ctor)
  count_tests         print number of generated test objects
  select_test <n>     select generated test object as in-memory object
  is_deterministic    exit w/ success if type encodes deterministically
"""

VERSION = "ceph-tpu dencoder"


class TypeHandler:
    """One registered type: encode/decode pair + generated test
    instances (the reference's generate_test_instances())."""

    def __init__(self, name: str,
                 encode: Callable[[Any], bytes],
                 decode: Callable[[bytes], Any],
                 tests: Callable[[], List[Any]],
                 to_jsonable: Optional[Callable[[Any], Any]] = None):
        self.name = name
        self.encode = encode
        self.decode = decode
        self.tests = tests
        self.to_jsonable = to_jsonable or _generic_jsonable


def _generic_jsonable(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _generic_jsonable(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {str(k): _generic_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_generic_jsonable(v) for v in obj]
    if isinstance(obj, (bytes, bytearray, memoryview)):
        return bytes(obj).hex()
    if isinstance(obj, (int, float, str, bool)) or obj is None:
        return obj
    return repr(obj)


def _synth(tp: Any, depth: int = 0) -> Any:
    """A filled-in synthetic value for a dataclass field type."""
    import typing
    origin = typing.get_origin(tp)
    if tp is int:
        return 7
    if tp is float:
        return 2.5
    if tp is bool:
        return True
    if tp is str:
        return "t"
    if tp is bytes:
        return b"\x01\x02"
    if origin in (list, typing.List):
        return []
    if origin in (dict, typing.Dict):
        return {}
    if origin in (tuple, typing.Tuple):
        return ()
    return None


def _message_tests(cls: type) -> List[Any]:
    """Two instances per message: all-defaults and synth-filled
    (generate_test_instances(): 'at least two, one default and one
    filled with semi-meaningful values')."""
    default = cls()
    filled = cls()
    hints: Dict[str, Any] = {}
    try:
        import typing
        hints = typing.get_type_hints(cls)
    except Exception:
        pass
    for f in dataclasses.fields(cls):
        cur = getattr(filled, f.name)
        if cur in (0, "", b"", None, False):
            v = _synth(hints.get(f.name, type(cur)))
            if v is not None:
                setattr(filled, f.name, v)
    return [default, filled]


def _checked_decode(buf: bytes, cls: type) -> Any:
    """decode_message dispatches on the class name in the frame; the
    dencoder contract is stricter — the buffer must BE the selected
    type (the reference decodes as the selected type and fails on
    mismatched data)."""
    from ..msg import wire
    msg = wire.decode_message(buf)
    if type(msg) is not cls:
        raise ValueError(f"buffer contains {type(msg).__name__}, "
                         f"not {cls.__name__}")
    return msg


def _registry() -> Dict[str, TypeHandler]:
    from ..msg import wire
    reg: Dict[str, TypeHandler] = {}
    for name, cls in sorted(wire._MSG_CLASSES.items()):
        if name == "Message":
            continue
        reg[name] = TypeHandler(
            name, wire.encode_message,
            (lambda c: (lambda b: _checked_decode(b, c)))(cls),
            (lambda c: (lambda: _message_tests(c)))(cls))

    from ..osdmap import encoding as oenc
    from ..osdmap.simple_build import build_simple

    def osdmap_tests() -> List[Any]:
        return [build_simple(4)]

    reg["OSDMap"] = TypeHandler(
        "OSDMap",
        lambda m: wire.encode_blob(oenc.osdmap_to_dict(m)),
        lambda b: oenc.osdmap_from_dict(wire.decode_blob(b)),
        osdmap_tests,
        lambda m: oenc.osdmap_to_dict(m))

    def inc_tests() -> List[Any]:
        from ..osdmap.osdmap import Incremental
        inc = Incremental(epoch=2)
        inc2 = Incremental(epoch=3)
        inc2.new_weight[0] = 0
        return [inc, inc2]

    reg["OSDMap::Incremental"] = TypeHandler(
        "OSDMap::Incremental",
        lambda i: wire.encode_blob(oenc.incremental_to_dict(i)),
        lambda b: oenc.incremental_from_dict(wire.decode_blob(b)),
        inc_tests,
        lambda i: oenc.incremental_to_dict(i))

    from ..crush import binfmt
    from ..crush.wrapper import CrushWrapper
    from ..crush.constants import CRUSH_BUCKET_STRAW2

    def crush_tests() -> List[Any]:
        cw = CrushWrapper()
        cw.set_type_name(1, "host")
        cw.set_type_name(10, "root")
        h = cw.add_bucket(CRUSH_BUCKET_STRAW2, 1, "host0", [0, 1],
                          [0x10000, 0x10000], id=-2)
        cw.add_bucket(CRUSH_BUCKET_STRAW2, 10, "default", [h],
                      [0x20000], id=-1)
        cw.set_max_devices(2)
        cw.add_simple_rule("data", "default", "host", mode="firstn")
        return [cw]

    from ..crush.dumpfmt import dump_map
    reg["CrushWrapper"] = TypeHandler(
        "CrushWrapper", binfmt.encode_crushmap, binfmt.decode_crushmap,
        crush_tests, lambda cw: dump_map(cw))

    from ..mon.monmap import MonMap

    def monmap_tests() -> List[Any]:
        mm = MonMap(fsid="00000000-1111-2222-3333-444444444444")
        mm.add("a", "127.0.0.1:6789")
        mm.add("b", "127.0.0.1:6790")
        # pin wall-clock fields so the archived corpus regenerates
        # byte-identically (a real diff must mean a codec change)
        mm.created = 1750000000.0
        mm.last_changed = 1750000000.0
        return [mm]

    reg["MonMap"] = TypeHandler(
        "MonMap", lambda m: m.to_bytes(),
        lambda b: MonMap.from_bytes(b), monmap_tests,
        lambda m: {"lines": m.print_lines()})
    return reg


def main(argv: Optional[List[str]] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if not args:
        sys.stderr.write(USAGE)
        return 1
    reg = _registry()
    handler: Optional[TypeHandler] = None
    obj: Any = None
    buf: Optional[bytes] = None
    skip = 0
    i = 0

    def need() -> Optional[str]:
        nonlocal i
        i += 1
        return args[i] if i < len(args) else None

    while i < len(args):
        cmd = args[i]
        if cmd in ("-h", "--help", "usage"):
            sys.stdout.write(USAGE)
            return 0
        elif cmd == "version":
            print(VERSION)
        elif cmd == "list_types":
            for name in reg:
                print(name)
        elif cmd == "type":
            name = need()
            if name not in reg:
                sys.stderr.write(f"class '{name}' unknown\n")
                return 1
            handler = reg[name]
            obj = None
        elif cmd == "skip":
            arg = need()
            if arg is None or not arg.lstrip("-").isdigit():
                sys.stderr.write("skip requires a numeric argument\n")
                return 1
            skip = int(arg)
        elif cmd == "import":
            path = need()
            if path is None:
                sys.stderr.write("import requires a file path\n")
                return 1
            try:
                with open(path, "rb") as f:
                    buf = f.read()
            except OSError as e:
                sys.stderr.write(f"error reading {path}: "
                                 f"{e.strerror}\n")
                return 1
        elif cmd == "export":
            path = need()
            if path is None:
                sys.stderr.write("export requires a file path\n")
                return 1
            if buf is None:
                sys.stderr.write("must first encode something\n")
                return 1
            with open(path, "wb") as f:
                f.write(buf)
        elif cmd == "decode":
            if handler is None:
                sys.stderr.write("must first select type with 'type "
                                 "<name>'\n")
                return 1
            if buf is None:
                sys.stderr.write("must first import data\n")
                return 1
            try:
                obj = handler.decode(buf[skip:])
            except Exception as e:
                sys.stderr.write(f"failed to decode: {e!r}\n")
                return 1
        elif cmd == "encode":
            if handler is None or obj is None:
                sys.stderr.write("must first select and fill an "
                                 "object ('type', then 'decode' or "
                                 "'select_test')\n")
                return 1
            buf = handler.encode(obj)
        elif cmd == "dump_json":
            if handler is None or obj is None:
                sys.stderr.write("must first select and fill an "
                                 "object\n")
                return 1
            print(json.dumps(handler.to_jsonable(obj), indent=4,
                             sort_keys=True, default=repr))
        elif cmd in ("copy", "copy_ctor"):
            if handler is None or obj is None:
                sys.stderr.write("must first select and fill an "
                                 "object\n")
                return 1
            # re-materialize through the codec: the strongest
            # copy-identity check available without C++ ctors
            obj = handler.decode(handler.encode(obj))
        elif cmd == "count_tests":
            if handler is None:
                sys.stderr.write("must first select type\n")
                return 1
            print(len(handler.tests()))
        elif cmd == "select_test":
            arg = need()
            if arg is None or not arg.isdigit():
                sys.stderr.write("select_test requires a test "
                                 "number\n")
                return 1
            n = int(arg)
            if handler is None:
                sys.stderr.write("must first select type\n")
                return 1
            tests = handler.tests()
            if not 1 <= n <= len(tests):
                sys.stderr.write(f"test number {n} out of range "
                                 f"(1..{len(tests)})\n")
                return 1
            obj = tests[n - 1]
        elif cmd == "is_deterministic":
            if handler is None:
                sys.stderr.write("must first select type\n")
                return 1
            for t in handler.tests():
                a = handler.encode(t)
                b = handler.encode(handler.decode(a))
                if a != handler.encode(t) or a != b:
                    print("type is NOT deterministic")
                    return 1
            print("type is deterministic")
        else:
            sys.stderr.write(f"unknown command '{cmd}'\n")
            sys.stderr.write(USAGE)
            return 1
        i += 1
    return 0


if __name__ == "__main__":  # pragma: no cover
    try:
        sys.exit(main())
    except BrokenPipeError:
        # downstream pager/head closed the pipe; not an error
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(0)
