"""Wire format for the message types (src/include/encoding.h role).

Every M* dataclass encodes to a self-describing length-prefixed binary
frame so messages can leave the process (msg/tcp.py's transport, mon/osd
store files).  The value codec is a small tagged TLV scheme — ints,
strs, bytes, bools, floats, lists, tuples, dicts — mirroring how the
reference's encode/decode pairs compose from primitive encoders
(src/msg/Message.h:254 header/payload framing).

OSDMap Incrementals ride inside MOSDMap; they serialize through the
structured dict codecs (osdmap/encoding.py), the same representation the
mon store persists.

The port's own copy of ``ceph_tpu/msg/wire.py``.
"""
from __future__ import annotations

import struct
from typing import Any, Dict

from . import messages as M

_MSG_CLASSES = {
    name: cls for name, cls in vars(M).items()
    if isinstance(cls, type) and issubclass(cls, M.Message)}

# value tags
_T_NONE, _T_INT, _T_FLOAT, _T_TRUE, _T_FALSE = b"N", b"I", b"F", b"T", b"f"
_T_STR, _T_BYTES, _T_LIST, _T_TUPLE, _T_DICT = b"S", b"Y", b"L", b"U", b"D"


def _enc_value(v: Any, out: list) -> None:
    if v is None:
        out.append(_T_NONE)
    elif v is True:
        out.append(_T_TRUE)
    elif v is False:
        out.append(_T_FALSE)
    elif isinstance(v, int):
        out.append(_T_INT)
        out.append(struct.pack("<q", v))
    elif isinstance(v, float):
        out.append(_T_FLOAT)
        out.append(struct.pack("<d", v))
    elif isinstance(v, str):
        b = v.encode()
        out.append(_T_STR)
        out.append(struct.pack("<I", len(b)))
        out.append(b)
    elif isinstance(v, (bytes, bytearray, memoryview)):
        b = bytes(v)
        out.append(_T_BYTES)
        out.append(struct.pack("<I", len(b)))
        out.append(b)
    elif isinstance(v, (list, tuple)):
        out.append(_T_LIST if isinstance(v, list) else _T_TUPLE)
        out.append(struct.pack("<I", len(v)))
        for item in v:
            _enc_value(item, out)
    elif isinstance(v, dict):
        out.append(_T_DICT)
        out.append(struct.pack("<I", len(v)))
        for k in v:
            _enc_value(k, out)
            _enc_value(v[k], out)
    else:
        raise TypeError(f"unencodable value type {type(v)!r}")


def _dec_value(buf: bytes, pos: int):
    tag = buf[pos:pos + 1]
    pos += 1
    if tag == _T_NONE:
        return None, pos
    if tag == _T_TRUE:
        return True, pos
    if tag == _T_FALSE:
        return False, pos
    if tag == _T_INT:
        return struct.unpack_from("<q", buf, pos)[0], pos + 8
    if tag == _T_FLOAT:
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    if tag in (_T_STR, _T_BYTES):
        (n,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        b = buf[pos:pos + n]
        return (b.decode() if tag == _T_STR else b), pos + n
    if tag in (_T_LIST, _T_TUPLE):
        (n,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        items = []
        for _ in range(n):
            v, pos = _dec_value(buf, pos)
            items.append(v)
        return (items if tag == _T_LIST else tuple(items)), pos
    if tag == _T_DICT:
        (n,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        d = {}
        for _ in range(n):
            k, pos = _dec_value(buf, pos)
            v, pos = _dec_value(buf, pos)
            d[k] = v
        return d, pos
    raise ValueError(f"bad wire tag {tag!r} at {pos - 1}")


def encode_blob(value: Any) -> bytes:
    """Plain value -> TLV bytes (auth tickets, small control blobs)."""
    out: list = []
    _enc_value(value, out)
    return b"".join(out)


def decode_blob(buf: bytes) -> Any:
    value, _pos = _dec_value(buf, 0)
    return value


def encode_message(msg: M.Message) -> bytes:
    """Message -> framed bytes (class name + field dict)."""
    fields: Dict[str, Any] = dict(vars(msg))
    if not fields.get("parent_span_id"):
        # optional tracing header: only on the wire when set, so frames
        # with tracing off — and the archived encoding corpus — stay
        # byte-identical to the pre-tracing format (decode fills the
        # dataclass default 0)
        fields.pop("parent_span_id", None)
    if fields.get("repair_for", -1) < 0:
        # optional repair-read selector (MOSDECSubOpRead): only on the
        # wire for sub-chunk repair rounds — plain reads and the
        # archived corpus encode byte-identically (decode fills the
        # dataclass default -1)
        fields.pop("repair_for", None)
    if not fields.get("retry_after"):
        # optional QoS throttle hint (MOSDOpReply): same
        # omitted-when-default contract as parent_span_id — unthrottled
        # replies and the archived corpus encode byte-identically
        fields.pop("retry_after", None)
    # the stage-latency ledger (trace/oplat.py) rides messages as an
    # in-process annotation only: never on the wire, so real-TCP
    # frames and the pinned corpus stay byte-identical (a receiver
    # opens a fresh ledger at intake instead)
    fields.pop("_oplat", None)
    for key, v in fields.items():
        if hasattr(v, "materialize"):
            # device-resident payloads (os_store DeviceShard) leave
            # the process as plain bytes: the handle is an in-process
            # fast path only, frames stay byte-identical either way
            fields[key] = v.materialize()
    if isinstance(msg, M.MOSDMap):
        from ..osdmap.encoding import incremental_to_dict
        fields["incrementals"] = [incremental_to_dict(i)
                                  for i in msg.incrementals]
    if isinstance(msg, M.MOSDOp) and msg.ops:
        fields["ops"] = [dict(vars(o)) for o in msg.ops]
    out: list = []
    name = type(msg).__name__.encode()
    out.append(struct.pack("<H", len(name)))
    out.append(name)
    _enc_value(fields, out)
    return b"".join(out)


def decode_message(buf: bytes) -> M.Message:
    (nlen,) = struct.unpack_from("<H", buf, 0)
    name = buf[2:2 + nlen].decode()
    cls = _MSG_CLASSES.get(name)
    if cls is None:
        raise ValueError(f"unknown message class {name!r}")
    fields, _pos = _dec_value(buf, 2 + nlen)
    if cls is M.MOSDMap:
        from ..osdmap.encoding import incremental_from_dict
        fields["incrementals"] = [incremental_from_dict(d)
                                  for d in fields["incrementals"]]
    if cls is M.MOSDOp and fields.get("ops"):
        fields["ops"] = [M.OSDOp(**d) for d in fields["ops"]]
    msg = cls()
    for k, v in fields.items():
        setattr(msg, k, v)
    return msg
