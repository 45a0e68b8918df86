"""MemStore — transactional in-memory ObjectStore.

Mirrors the reference's test backend (src/os/memstore/MemStore.{h,cc}) and
the ObjectStore transaction model (src/os/ObjectStore.h): collections (one
per PG shard) hold objects with byte data, xattrs and omap; mutations are
queued as Transactions whose ops apply atomically and in order.  BlueStore's
block/WAL machinery is host-I/O out of scope for a TPU build (SURVEY.md
§2.9) — this is the durability stand-in that keeps the OSD data path
honest: every shard write and recovery push lands here through the same
Transaction ABI the reference uses.

Device-resident shard bodies: an object's ``data`` may be a
``DeviceShard`` (os_store/device_shard.py) instead of a bytearray — a
whole-body handle written via ``Transaction.write_shard`` that stays in
HBM until a host read materializes it (the accounted
``memstore.fetch_shard`` d2h).  ``stat``/``save`` work unchanged via
``len()``/``bytes()``; any byte-granular mutation (write/zero/truncate)
materializes first, so splicing semantics are identical either way.

The port's own copy of ``ceph_tpu/os_store/memstore.py``.  Resident
bodies are the port's ``DeviceShard`` handles (torch tensors on the card).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
from ..common.lockdep import DebugRLock
from .device_shard import DeviceShard, g_device_budget


@dataclass(frozen=True, order=True)
class hobject_t:
    """Object identity inside a collection (simplified hobject)."""
    oid: str
    shard: int = -1  # EC shard id, -1 = whole/replicated

    def __str__(self):
        return f"{self.oid}" if self.shard < 0 else f"{self.oid}({self.shard})"


class _Object:
    __slots__ = ("data", "attrs", "omap")

    def __init__(self):
        self.data = bytearray()
        self.attrs: Dict[str, bytes] = {}
        self.omap: Dict[str, bytes] = {}


# transaction op codes (subset of ObjectStore::Transaction ops)
OP_TOUCH = "touch"
OP_WRITE = "write"
OP_WRITE_SHARD = "write_shard"  # whole-body replace, handle-typed
OP_ZERO = "zero"
OP_TRUNCATE = "truncate"
OP_REMOVE = "remove"
OP_SETATTR = "setattr"
OP_RMATTR = "rmattr"
OP_OMAP_SETKEYS = "omap_setkeys"
OP_OMAP_RMKEYS = "omap_rmkeys"
OP_MKCOLL = "mkcoll"
OP_RMCOLL = "rmcoll"


class Transaction:
    """Ordered batch of mutations applied atomically
    (os/ObjectStore.h Transaction)."""

    def __init__(self):
        self.ops: List[Tuple] = []

    def touch(self, cid: str, oid: hobject_t):
        self.ops.append((OP_TOUCH, cid, oid))

    def write(self, cid: str, oid: hobject_t, offset: int, data):
        self.ops.append((OP_WRITE, cid, oid, offset, bytes(data)))

    def write_shard(self, cid: str, oid: hobject_t, shard):
        """Replace the whole object body with *shard* (a ``DeviceShard``
        handle or host bytes) without coercing — the zero-copy write
        path's store op: a resident body is queued and applied with no
        byte movement at all."""
        self.ops.append((OP_WRITE_SHARD, cid, oid, shard))

    def zero(self, cid: str, oid: hobject_t, offset: int, length: int):
        self.ops.append((OP_ZERO, cid, oid, offset, length))

    def truncate(self, cid: str, oid: hobject_t, size: int):
        self.ops.append((OP_TRUNCATE, cid, oid, size))

    def remove(self, cid: str, oid: hobject_t):
        self.ops.append((OP_REMOVE, cid, oid))

    def setattr(self, cid: str, oid: hobject_t, name: str, value: bytes):
        self.ops.append((OP_SETATTR, cid, oid, name, bytes(value)))

    def rmattr(self, cid: str, oid: hobject_t, name: str):
        self.ops.append((OP_RMATTR, cid, oid, name))

    def omap_setkeys(self, cid: str, oid: hobject_t,
                     keys: Dict[str, bytes]):
        self.ops.append((OP_OMAP_SETKEYS, cid, oid, dict(keys)))

    def omap_rmkeys(self, cid: str, oid: hobject_t, keys: List[str]):
        self.ops.append((OP_OMAP_RMKEYS, cid, oid, list(keys)))

    def create_collection(self, cid: str):
        self.ops.append((OP_MKCOLL, cid))

    def remove_collection(self, cid: str):
        self.ops.append((OP_RMCOLL, cid))

    def append(self, other: "Transaction"):
        self.ops.extend(other.ops)

    def empty(self) -> bool:
        return not self.ops


_MAGIC = b"CTPUSTOR"
_VERSION = 1


class MemStore:
    def __init__(self):
        self.colls: Dict[str, Dict[hobject_t, _Object]] = {}
        self.committed_txns = 0
        self._write_lock = DebugRLock("MemStore::write_lock")

    # ---- lifecycle / durability -------------------------------------------
    def mount(self) -> None:
        pass

    def umount(self) -> None:
        pass

    def save(self, path: str) -> None:
        """Persist every collection to *path* (length-prefixed binary; the
        BlueStore-durability stand-in: checkpoint = this file, resume =
        ``MemStore.load``)."""
        import struct as _s

        def pstr(b: bytes) -> bytes:
            return _s.pack("<I", len(b)) + b

        out = [_MAGIC, _s.pack("<IQ", _VERSION, self.committed_txns),
               _s.pack("<I", len(self.colls))]
        for cid in sorted(self.colls):
            coll = self.colls[cid]
            out.append(pstr(cid.encode()))
            out.append(_s.pack("<I", len(coll)))
            for ho in sorted(coll):
                o = coll[ho]
                out.append(pstr(ho.oid.encode()))
                out.append(_s.pack("<i", ho.shard))
                out.append(pstr(bytes(o.data)))
                out.append(_s.pack("<I", len(o.attrs)))
                for k in sorted(o.attrs):
                    out.append(pstr(k.encode()))
                    out.append(pstr(o.attrs[k]))
                out.append(_s.pack("<I", len(o.omap)))
                for k in sorted(o.omap):
                    out.append(pstr(k.encode()))
                    out.append(pstr(o.omap[k]))
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(b"".join(out))
        os.replace(tmp, path)  # atomic like a journal commit

    @classmethod
    def load(cls, path: str) -> "MemStore":
        import struct as _s
        with open(path, "rb") as f:
            buf = f.read()
        if buf[:8] != _MAGIC:
            raise ValueError(f"{path}: not a ceph_tpu store file")
        pos = 8
        version, txns = _s.unpack_from("<IQ", buf, pos)
        pos += 12
        if version != _VERSION:
            raise ValueError(f"{path}: store version {version}")

        def rstr() -> bytes:
            nonlocal pos
            (n,) = _s.unpack_from("<I", buf, pos)
            pos += 4
            b = buf[pos:pos + n]
            pos += n
            return b

        store = cls()
        store.committed_txns = txns
        (ncolls,) = _s.unpack_from("<I", buf, pos)
        pos += 4
        for _ in range(ncolls):
            cid = rstr().decode()
            (nobjs,) = _s.unpack_from("<I", buf, pos)
            pos += 4
            coll: Dict[hobject_t, _Object] = {}
            for _o in range(nobjs):
                oid = rstr().decode()
                (shard,) = _s.unpack_from("<i", buf, pos)
                pos += 4
                obj = _Object()
                obj.data = bytearray(rstr())
                (nattrs,) = _s.unpack_from("<I", buf, pos)
                pos += 4
                for _a in range(nattrs):
                    k = rstr().decode()
                    obj.attrs[k] = rstr()
                (nomap,) = _s.unpack_from("<I", buf, pos)
                pos += 4
                for _m in range(nomap):
                    k = rstr().decode()
                    obj.omap[k] = rstr()
                coll[hobject_t(oid, shard)] = obj
            store.colls[cid] = coll
        return store

    # ---- transactions -----------------------------------------------------
    def queue_transaction(self, t: Transaction) -> None:
        """Apply atomically; invalid ops raise before any mutation.

        Thread-safe for writers (the threaded op queue commits from
        worker threads; the reference ObjectStore is too): the whole
        stage-and-swap runs under a mutex, while readers see either the
        old or the new dict via the atomic reference swap."""
        with self._write_lock:
            # stage (deep-clone) only the collections this transaction
            # touches; untouched ones share by reference — the swap
            # below is still one atomic rebind for readers, and the
            # critical section stops scaling with the WHOLE store
            touched = {op[1] for op in t.ops if len(op) > 1}
            staged = dict(self.colls)
            for cid in touched:
                coll = self.colls.get(cid)
                if coll is not None:
                    staged[cid] = {o: self._clone(obj)
                                   for o, obj in coll.items()}
            self._apply(staged, t)
            self.colls = staged
            self.committed_txns += 1

    @staticmethod
    def _clone(obj: _Object) -> _Object:
        c = _Object()
        # a DeviceShard is immutable-by-convention (mutations replace
        # the whole body or materialize first) — clones share the
        # handle so staging a touched collection moves no device bytes
        c.data = obj.data if isinstance(obj.data, DeviceShard) \
            else bytearray(obj.data)
        c.attrs = dict(obj.attrs)
        c.omap = dict(obj.omap)
        return c

    @staticmethod
    def _mutable(o: _Object) -> bytearray:
        """The object's body as a spliceable bytearray; a resident
        shard materializes first (byte-granular edits need bytes)."""
        if isinstance(o.data, DeviceShard):
            o.data = bytearray(o.data.materialize())
        return o.data

    def _apply(self, colls, t: Transaction) -> None:
        def coll(cid):
            if cid not in colls:
                raise KeyError(f"no collection {cid}")
            return colls[cid]

        def obj(cid, oid, create=False):
            c = coll(cid)
            if oid not in c:
                if not create:
                    raise KeyError(f"no object {oid} in {cid}")
                c[oid] = _Object()
            return c[oid]

        for op in t.ops:
            code = op[0]
            if code == OP_MKCOLL:
                colls.setdefault(op[1], {})
            elif code == OP_RMCOLL:
                colls.pop(op[1], None)
            elif code == OP_TOUCH:
                obj(op[1], op[2], create=True)
            elif code == OP_WRITE:
                _, cid, oid, offset, data = op
                o = obj(cid, oid, create=True)
                buf = self._mutable(o)
                end = offset + len(data)
                if len(buf) < end:
                    buf.extend(b"\0" * (end - len(buf)))
                buf[offset:end] = data
            elif code == OP_WRITE_SHARD:
                _, cid, oid, shard = op
                obj(cid, oid, create=True).data = shard
            elif code == OP_ZERO:
                _, cid, oid, offset, length = op
                o = obj(cid, oid, create=True)
                buf = self._mutable(o)
                end = offset + length
                if len(buf) < end:
                    buf.extend(b"\0" * (end - len(buf)))
                buf[offset:end] = b"\0" * length
            elif code == OP_TRUNCATE:
                _, cid, oid, size = op
                o = obj(cid, oid, create=True)
                buf = self._mutable(o)
                if len(buf) > size:
                    del buf[size:]
                else:
                    buf.extend(b"\0" * (size - len(buf)))
            elif code == OP_REMOVE:
                coll(op[1]).pop(op[2], None)
            elif code == OP_SETATTR:
                _, cid, oid, name, value = op
                obj(cid, oid, create=True).attrs[name] = value
            elif code == OP_RMATTR:
                _, cid, oid, name = op
                obj(cid, oid).attrs.pop(name, None)
            elif code == OP_OMAP_SETKEYS:
                _, cid, oid, keys = op
                obj(cid, oid, create=True).omap.update(keys)
            elif code == OP_OMAP_RMKEYS:
                _, cid, oid, keys = op
                o = obj(cid, oid)
                for k in keys:
                    o.omap.pop(k, None)
            else:
                raise ValueError(f"unknown op {code}")

    # ---- reads ------------------------------------------------------------
    def collection_exists(self, cid: str) -> bool:
        return cid in self.colls

    def list_collections(self) -> List[str]:
        return sorted(self.colls)

    def exists(self, cid: str, oid: hobject_t) -> bool:
        return oid in self.colls.get(cid, {})

    def _maybe_corrupt(self, cid: str, oid: hobject_t,
                       o: _Object) -> None:
        """Fault site ``store.shard_corrupt``: flip one stored body
        byte (bitrot) — works on resident handles and host bytes alike
        so the crc EIO path is testable in both representations."""
        from ..fault import g_faults  # lazy: fault imports trace
        if not g_faults.site_armed("store.shard_corrupt"):
            return
        if not g_faults.should_fire("store.shard_corrupt",
                                    f"{cid}/{oid}"):
            return
        d = o.data
        if isinstance(d, DeviceShard):
            d.corrupted()
        elif len(d):
            d[0] ^= 0x01

    def read(self, cid: str, oid: hobject_t, offset: int = 0,
             length: int = 0) -> bytes:
        o = self.colls[cid][oid]
        self._maybe_corrupt(cid, oid, o)
        d = o.data
        if isinstance(d, DeviceShard):
            d = d.materialize()
        if length == 0:
            length = len(d) - offset
        return bytes(d[offset:offset + length])

    def read_shard(self, cid: str, oid: hobject_t):
        """The whole body WITHOUT forcing host bytes: a resident
        ``DeviceShard`` comes back as the handle itself (LRU-touched);
        host-bytes bodies come back as bytes.  The zero-copy read path
        for in-process fabrics."""
        o = self.colls[cid][oid]
        self._maybe_corrupt(cid, oid, o)
        d = o.data
        if isinstance(d, DeviceShard):
            g_device_budget.touch(d)
            return d
        return bytes(d)

    def stat(self, cid: str, oid: hobject_t) -> int:
        return len(self.colls[cid][oid].data)

    def getattr(self, cid: str, oid: hobject_t, name: str) -> bytes:
        return self.colls[cid][oid].attrs[name]

    def getattrs(self, cid: str, oid: hobject_t) -> Dict[str, bytes]:
        return dict(self.colls[cid][oid].attrs)

    def omap_get(self, cid: str, oid: hobject_t) -> Dict[str, bytes]:
        return dict(self.colls[cid][oid].omap)

    def list_objects(self, cid: str) -> List[hobject_t]:
        return sorted(self.colls.get(cid, {}))
