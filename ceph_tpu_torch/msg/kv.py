"""Length-prefixed key/value and key-list codecs shared by the client
builders and the OSD op interpreter (the bufferlist map encodings of
include/encoding.h used for getxattrs/omap payloads).

The port's own copy of ``ceph_tpu/msg/kv.py``.
"""
from __future__ import annotations

import struct
from typing import Dict, Iterable, List


def pack_kv(kv: Dict[str, bytes]) -> bytes:
    out = []
    for k, v in kv.items():
        kb = k.encode()
        vb = bytes(v)
        out.append(struct.pack("<I", len(kb)) + kb +
                   struct.pack("<I", len(vb)) + vb)
    return b"".join(out)


def unpack_kv(buf: bytes) -> Dict[str, bytes]:
    pos, kv = 0, {}
    while pos < len(buf):
        (n,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        k = buf[pos:pos + n].decode()
        pos += n
        (n,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        kv[k] = buf[pos:pos + n]
        pos += n
    return kv


def pack_keys(keys: Iterable[str]) -> bytes:
    out = []
    for k in keys:
        kb = k.encode()
        out.append(struct.pack("<I", len(kb)) + kb)
    return b"".join(out)


def unpack_keys(buf: bytes) -> List[str]:
    pos, keys = 0, []
    while pos < len(buf):
        (n,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        keys.append(buf[pos:pos + n].decode())
        pos += n
    return keys
