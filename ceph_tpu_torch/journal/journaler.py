"""Journaler-lite: ordered append/replay log over rados (src/journal
in the reference — the engine under rbd journaling/mirroring).

Entries are framed and appended round-robin across ``splay_width``
data objects per object set (``journal_data.<id>.<objno>``, objno =
set * splay + tid % splay — the reference's splay layout,
journal/JournalMetadata.cc), so sequential appends spread over
``splay_width`` PGs while replay re-interleaves by tid.  Each frame
carries a crc so replay stops cleanly at a torn tail (Entry.cc uses
the same preamble+crc framing).  Registered clients track commit
positions in the metadata object (cls_journal); trimming deletes
whole object sets once every client has committed past them.

Scope-outs vs the reference: tag-based demultiplexing, prefetch
watermarks, and the librbd integration daemon (rbd-mirror).

Port of ``ceph_tpu/journal/journaler.py``, a copy: host code.  Its
frame crcs are the port's host crc32c (``utils/crc32c.py``).
"""
from __future__ import annotations

import json
import struct
from typing import Iterator, List, Optional, Tuple

from ..client.rados import RadosClient
from ..utils.crc32c import crc32c
from . import cls_journal  # noqa: F401

PREAMBLE = 0x3141_5926            # frame magic (Entry.cc preamble role)
_HDR = struct.Struct("<IQI")      # magic, tid, payload length


def _j(obj) -> bytes:
    return json.dumps(obj, sort_keys=True).encode()


class JournalError(IOError):
    def __init__(self, api: str, result: int):
        super().__init__(f"journal {api}: error {result}")
        self.result = result


def _absent(e: IOError) -> bool:
    return getattr(e, "errno", None) == 2


class Journaler:
    """One journal (create/open + append/replay/commit/trim)."""

    def __init__(self, client: RadosClient, pool: str, journal_id: str,
                 entries_per_object: int = 64):
        self.client = client
        self.pool = pool
        self.jid = journal_id
        self.meta_oid = f"journal.{journal_id}"
        self.entries_per_object = entries_per_object
        self.order = 0
        self.splay = 0
        self._next_tid = 0
        self._pushed_active_set = -1

    # ---- metadata ----------------------------------------------------------
    def _exec(self, method: str, payload=None) -> bytes:
        ret, out = self.client.exec(self.pool, self.meta_oid, "journal",
                                    method, _j(payload or {}))
        if ret < 0:
            raise JournalError(method, ret)
        return out

    def create(self, order: int = 24, splay_width: int = 4) -> None:
        self._exec("create", {"order": order,
                              "splay_width": splay_width})
        self.open()

    def get_metadata(self) -> dict:
        """Decoded journal metadata (shape, watermarks, clients)."""
        return json.loads(self._exec("get_metadata"))

    def open(self) -> dict:
        md = self.get_metadata()
        self.order = md["order"]
        self.splay = md["splay_width"]
        self._next_tid = self._scan_next_tid(md)
        # never try to move the stored watermark backwards: after a
        # crash in the write-ahead window the metadata set can be one
        # AHEAD of where the next append lands (empty set), and
        # set_active_set refuses regressions
        self._pushed_active_set = md["active_set"]
        return md

    def register_client(self, client_id: str, data: str = "") -> None:
        self._exec("client_register", {"id": client_id, "data": data})

    def unregister_client(self, client_id: str) -> None:
        self._exec("client_unregister", {"id": client_id})

    def commit(self, client_id: str, tid: int) -> None:
        self._exec("client_commit", {"id": client_id, "commit_tid": tid})

    # ---- layout ------------------------------------------------------------
    def _entries_per_set(self) -> int:
        return self.splay * self.entries_per_object

    def _objno(self, tid: int) -> int:
        oset = tid // self._entries_per_set()
        return oset * self.splay + tid % self.splay

    def _data_oid(self, objno: int) -> str:
        return f"journal_data.{self.jid}.{objno:x}"

    # ---- append ------------------------------------------------------------
    def append(self, payload: bytes) -> int:
        """Frame + append one entry; returns its tid.  The frame crc
        covers header+payload so a torn tail write is detectable."""
        tid = self._next_tid
        active_set = tid // self._entries_per_set()
        if active_set > self._pushed_active_set:
            # write-AHEAD the watermark (once per object set): if the
            # frame landed first and we crashed before the bump, the
            # entry would be invisible to both replay() and the next-tid
            # scan (both bounded by metadata active_set) — the reused
            # tid could then be applied locally yet never replayed to a
            # mirror.  Bumping first merely costs replay a scan over an
            # empty set on the crash path.
            self._exec("set_active_set", {"set": active_set})
            self._pushed_active_set = active_set
        hdr = _HDR.pack(PREAMBLE, tid, len(payload))
        frame = hdr + payload + struct.pack("<I", crc32c(hdr + payload))
        r = self.client.append(self.pool, self._data_oid(self._objno(tid)),
                               frame)
        if r < 0:
            raise JournalError("append", r)
        self._next_tid = tid + 1
        return tid

    # ---- replay ------------------------------------------------------------
    def _read_object_entries(self, objno: int
                             ) -> List[Tuple[int, bytes]]:
        try:
            blob = self.client.read(self.pool, self._data_oid(objno))
        except IOError as e:
            if _absent(e):
                return []
            raise
        out, off = [], 0
        while off + _HDR.size + 4 <= len(blob):
            magic, tid, ln = _HDR.unpack_from(blob, off)
            if magic != PREAMBLE:
                break                     # torn/garbage tail: stop
            end = off + _HDR.size + ln + 4
            if end > len(blob):
                break                     # truncated tail frame
            body = blob[off:off + _HDR.size + ln]
            (crc,) = struct.unpack_from("<I", blob, off + _HDR.size + ln)
            if crc != crc32c(body):
                break                     # torn write: stop replay here
            out.append((tid, body[_HDR.size:]))
            off = end
        return out

    def replay(self, after_tid: int = -1
               ) -> Iterator[Tuple[int, bytes]]:
        """Yield (tid, payload) in tid order for every intact entry
        after ``after_tid`` (JournalPlayer's committed-position replay).
        Stops at the first gap — entries past a torn/missing tid are
        not safe to apply in order."""
        md = self.get_metadata()
        entries = {}
        for oset in range(md["minimum_set"], md["active_set"] + 1):
            for s in range(self.splay):
                for tid, payload in self._read_object_entries(
                        oset * self.splay + s):
                    entries[tid] = payload
        tid = after_tid + 1
        while tid in entries:
            yield tid, entries[tid]
            tid += 1

    def scan_entries(self):
        """Every intact retained entry, ascending tid, WITHOUT the
        replay gap rule: for membership scans (e.g. dedup-id recovery)
        where ordering safety doesn't apply."""
        md = self.get_metadata()
        out = []
        for oset in range(md["minimum_set"], md["active_set"] + 1):
            for s in range(self.splay):
                out.extend(self._read_object_entries(
                    oset * self.splay + s))
        return sorted(out)

    def _scan_next_tid(self, md: dict) -> int:
        """Highest tid on disk + 1, walking DOWN from active_set until
        a set with entries appears (tids grow with set number, so the
        first non-empty set holds the maximum).  active_set itself can
        be empty — the watermark is written ahead of the first frame —
        and with trimming lagging there can be several live sets, so
        stopping after active_set+minimum_set alone would resurrect a
        stale tid from the bottom of the window."""
        last = -1
        for oset in range(md["active_set"], md["minimum_set"] - 1, -1):
            for s in range(self.splay):
                for tid, _ in self._read_object_entries(
                        oset * self.splay + s):
                    last = max(last, tid)
            if last >= 0:
                break
        return last + 1

    # ---- trim --------------------------------------------------------------
    def committed_tid(self) -> int:
        """min over registered clients (nothing may be trimmed past the
        slowest consumer)."""
        md = self.get_metadata()
        if not md["clients"]:
            return -1
        return min(c["commit_tid"] for c in md["clients"].values())

    def trim(self) -> int:
        """Delete object sets wholly below every client's commit
        position; returns the new minimum set."""
        md = self.get_metadata()
        safe_tid = self.committed_tid()
        eps = self._entries_per_set()
        # a set is trimmable when its LAST tid is committed
        new_min = min((safe_tid + 1) // eps, md["active_set"])
        for oset in range(md["minimum_set"], new_min):
            for s in range(self.splay):
                self.client.remove(self.pool,
                                   self._data_oid(oset * self.splay + s))
        if new_min > md["minimum_set"]:
            self._exec("set_minimum_set", {"set": new_min})
        return new_min

    def remove(self) -> None:
        md = self.get_metadata()
        for oset in range(md["minimum_set"], md["active_set"] + 1):
            for s in range(self.splay):
                self.client.remove(self.pool,
                                   self._data_oid(oset * self.splay + s))
        self.client.remove(self.pool, self.meta_oid)
