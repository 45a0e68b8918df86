"""RadosStriper — one logical object striped across many rados objects.

The libradosstriper analog (src/libradosstriper/RadosStriperImpl.cc):
a logical "striped object" is RAID0'd over ordinary rados objects with
the reference's layout parameters (stripe_unit, stripe_count,
object_size; ErasureCodeInterface.h:60-78 documents the same
decomposition OSD-side).  Unit u of the logical stream lands in

    column     = u % stripe_count
    object_set = u // (units_per_object * stripe_count)
    objectno   = object_set * stripe_count + column

and backing objects are named ``{soid}.{objectno:016x}`` exactly like
the striper's convention.  The logical size lives in an xattr on the
first object (striper.size), holes read back as zeros (sparse
semantics), and every data op decomposes into ordinary rados ops — so
EC coding, snapshots, scrub, recovery all apply to striped content
with no extra machinery.

This is the client-side face of the framework's batched-stripe design:
large logical writes become many fixed-size object writes the OSD
batches into single device encode calls.

The port's own copy of ``ceph_tpu/client/striper.py``.
"""
from __future__ import annotations

import struct
from typing import List, Tuple

import errno as _errno

from .rados import ObjectOperation, RadosClient

# genuinely missing (vs transient): object or size attr absent
_ABSENT = (_errno.ENOENT, _errno.ENODATA)


def _absent(e: IOError) -> bool:
    return getattr(e, "errno", None) in _ABSENT

SIZE_XATTR = "striper.size"          # reference XATTR_SIZE
TRIM_XATTR = "striper.trim_upto"     # pending-shrink high-water mark


class RadosStriper:
    def __init__(self, client: RadosClient, pool: str,
                 stripe_unit: int = 65536, stripe_count: int = 4,
                 object_size: int = 1 << 20):
        if object_size % stripe_unit:
            raise ValueError("object_size must be a multiple of "
                             "stripe_unit")
        self.client = client
        self.pool = pool
        self.su = stripe_unit
        self.sc = stripe_count
        self.os_ = object_size
        self.upo = object_size // stripe_unit   # units per object

    # ---- layout ------------------------------------------------------------
    def _obj_name(self, soid: str, objectno: int) -> str:
        return f"{soid}.{objectno:016x}"

    def _extents(self, offset: int, length: int
                 ) -> List[Tuple[int, int, int, int]]:
        """(objectno, obj_offset, logical_offset, run_length) covering
        [offset, offset+length): the file_to_extents decomposition."""
        out = []
        pos = offset
        end = offset + length
        while pos < end:
            u = pos // self.su
            within = pos % self.su
            column = u % self.sc
            set_ = u // (self.upo * self.sc)
            row_in_set = (u // self.sc) % self.upo
            objectno = set_ * self.sc + column
            obj_off = row_in_set * self.su + within
            run = min(self.su - within, end - pos)
            out.append((objectno, obj_off, pos, run))
            pos += run
        return out

    # ---- size bookkeeping --------------------------------------------------
    def stat(self, soid: str) -> int:
        v = self.client.getxattr(self.pool, self._obj_name(soid, 0),
                                 SIZE_XATTR)
        return struct.unpack("<Q", v)[0]

    def _grow_size(self, soid: str, new_end: int) -> None:
        first = self._obj_name(soid, 0)
        try:
            cur = self.stat(soid)
        except IOError as e:
            if not _absent(e):
                raise            # transient: never shrink the size
            cur = -1
        if new_end > cur:
            op = (ObjectOperation().create(exclusive=False)
                  .set_xattr(SIZE_XATTR, struct.pack("<Q", new_end)))
            r, _ = self.client.operate(self.pool, first, op)
            if r < 0:
                raise IOError(f"striper size update: {r}")

    # ---- data ops ----------------------------------------------------------
    def write(self, soid: str, data: bytes, offset: int = 0) -> int:
        data = bytes(data)
        for objectno, obj_off, lpos, run in self._extents(offset,
                                                          len(data)):
            chunk = data[lpos - offset:lpos - offset + run]
            r = self.client.write(self.pool,
                                  self._obj_name(soid, objectno),
                                  chunk, obj_off)
            if r < 0:
                return r
        self._grow_size(soid, offset + len(data))
        return 0

    def write_full(self, soid: str, data: bytes) -> int:
        self.remove(soid, _ignore_missing=True)
        return self.write(soid, data, 0)

    def append(self, soid: str, data: bytes) -> int:
        try:
            size = self.stat(soid)
        except IOError as e:
            if not _absent(e):
                raise            # transient: appending at 0 would clobber
            size = 0
        return self.write(soid, data, size)

    def read(self, soid: str, offset: int = 0, length: int = 0) -> bytes:
        size = self.stat(soid)
        end = size if not length else min(offset + length, size)
        if end <= offset:
            return b""
        out = bytearray(end - offset)
        for objectno, obj_off, lpos, run in self._extents(
                offset, end - offset):
            try:
                piece = self.client.read(
                    self.pool, self._obj_name(soid, objectno),
                    offset=obj_off, length=run)
            except IOError as e:
                if not _absent(e):
                    raise        # transient/EIO must surface, not zero-fill
                piece = b""                   # sparse hole reads zeros
            out[lpos - offset:lpos - offset + len(piece)] = piece
        return bytes(out)

    def _kept_in_object(self, objectno: int, size: int) -> int:
        """Bytes of this backing object that lie below the logical
        *size* — contiguous from the object's start because its rows'
        logical offsets increase monotonically."""
        column = objectno % self.sc
        set_ = objectno // self.sc
        kept = 0
        for r in range(self.upo):
            u = set_ * self.upo * self.sc + r * self.sc + column
            kept_r = min(self.su, max(0, size - u * self.su))
            if kept_r == 0:
                break
            kept += kept_r
            if kept_r < self.su:
                break
        return kept

    def _all_objectnos(self, size: int) -> range:
        if size <= 0:
            return range(1)
        last_set = (size - 1) // (self.su * self.upo * self.sc)
        return range((last_set + 1) * self.sc)

    def truncate(self, soid: str, size: int) -> int:
        """Retry-safe two-phase shrink: (1) record the new size AND a
        trim high-water mark covering any previously failed shrink, so
        reads never claim destroyed bytes; (2) trim the backing
        objects over the whole marked span; (3) clear the mark.  A
        failure between phases leaves orphan bytes that the NEXT
        truncate/grow call re-trims (the mark survives)."""
        old = self.stat(soid)
        first = self._obj_name(soid, 0)
        try:
            prev_mark = struct.unpack(
                "<Q", self.client.getxattr(self.pool, first,
                                           TRIM_XATTR))[0]
        except IOError as e:
            if not _absent(e):
                raise
            prev_mark = 0
        span = max(old, prev_mark)
        # bytes above min(size, old) were either destroyed by THIS call
        # or by a previously failed shrink (the mark) — both must trim,
        # even when the new size grows past the old one (those bytes
        # must read as zeros, not resurrect)
        keep_to = min(size, old)
        op = (ObjectOperation().create(exclusive=False)
              .set_xattr(SIZE_XATTR, struct.pack("<Q", size))
              .set_xattr(TRIM_XATTR, struct.pack("<Q", span)))
        r, _ = self.client.operate(self.pool, first, op)
        if r < 0:
            return r
        if keep_to < span:
            for objectno in self._all_objectnos(span):
                kept = self._kept_in_object(objectno, keep_to)
                name = self._obj_name(soid, objectno)
                if kept == 0 and objectno != 0:
                    r2 = self.client.remove(self.pool, name)
                    if r2 not in (0, -2):
                        return r2     # mark persists; retry re-trims
                else:
                    r2 = self.client.truncate(self.pool, name, kept)
                    if r2 not in (0, -2):
                        return r2
        r, _ = self.client.operate(self.pool, first, ObjectOperation()
                                   .set_xattr(TRIM_XATTR,
                                              struct.pack("<Q", keep_to)))
        return r

    def remove(self, soid: str, _ignore_missing: bool = False) -> int:
        try:
            size = self.stat(soid)
        except IOError:
            return 0 if _ignore_missing else -2
        # a shrink that died mid-trim leaves backing objects in
        # (size, mark]; deleting only up to size would orphan them and a
        # recreated striped object could resurrect their bytes as data
        try:
            mark = struct.unpack(
                "<Q", self.client.getxattr(self.pool,
                                           self._obj_name(soid, 0),
                                           TRIM_XATTR))[0]
        except IOError as e:
            if not _absent(e):
                raise
            mark = 0
        for objectno in self._all_objectnos(max(size, mark)):
            self.client.remove(self.pool, self._obj_name(soid, objectno))
        return 0
