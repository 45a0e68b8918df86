"""Snap -> object index driving the snap trimmer (SnapMapper role).

The reference maintains a persistent omap index from snap id to the
objects whose clones contain that snap (``src/osd/SnapMapper.h``: the
``MAP_`` / ``OBJ_`` key families), so `get_next_objects_to_trim`
(`src/osd/SnapMapper.cc`) hands the trimmer exactly the objects that
matter instead of scanning the whole PG.  It pairs the index with
``pg_info_t.purged_snaps`` so a primary that dies mid-trim is resumed
by its successor: at activation the new primary compares the pool's
``removed_snaps`` against what was actually purged and finishes the
difference.

This module is this framework's analog.  Differences from the
reference, on purpose:

- The index is **derived, not persisted**.  Every replica already
  persists the per-head snapsets in its PG meta object; a clone entry
  ``(seq, CLONE)`` with predecessor ``prev`` covers exactly the snap
  ids in ``(prev, seq]``.  Rebuilding the index at PG load is one pass
  over the loaded snapsets — so there is nothing extra to keep
  consistent on disk, and a mapper bug can never strand on-disk state.
- ``purged_snaps`` IS persisted (one omap key in the PG meta object)
  and rides peering (`MOSDPGInfo.purged_snaps`) so the
  primary-died-before-trimming case converges: the reference keeps it
  in ``pg_info_t`` for the same reason (`src/osd/osd_types.h`).

Live AND removed snaps are indexed — deliberately including purged
ones: the index is a truthful "who still references this snap", which
lets the trimmer detect (and redo) a purge whose marker survived a
crash that swallowed the actual trim work.  Snap ids only grow, so a
new snap can never fall inside an existing clone's window — the index
never needs reindexing on map change, only on snapset change.

The port's own copy of ``ceph_tpu/osd/snap_mapper.py``.
"""
from __future__ import annotations

import struct
from typing import Dict, Iterable, List, Set, Tuple

from .pg_log import SNAP_TRIMMED

# omap key in the PG meta object holding the packed purged-snap ids
PURGED_SNAPS_KEY = "purged_snaps"


class SnapMapper:
    """In-memory two-way index: snap id <-> head oids with a clone (or
    whiteout) whose window covers that snap."""

    def __init__(self) -> None:
        self.by_snap: Dict[int, Set[str]] = {}
        self.by_oid: Dict[str, Set[int]] = {}

    # ---- queries -----------------------------------------------------------
    def lookup(self, snap: int) -> Set[str]:
        """Head oids whose snapset still references *snap* (the
        get_next_objects_to_trim role, without the paging)."""
        return set(self.by_snap.get(snap, ()))

    @staticmethod
    def covered_snaps(entries: List[Tuple[int, int]],
                      interesting: Iterable[int]) -> Set[int]:
        """Snap ids from *interesting* covered by any non-tombstone
        entry's window (prev_seq, seq]."""
        out: Set[int] = set()
        if not entries:
            return out
        snaps = sorted(interesting)
        prev = 0
        for seq, kind in entries:
            if kind != SNAP_TRIMMED:
                for sid in snaps:
                    if prev < sid <= seq:
                        out.add(sid)
            prev = seq
        return out

    # ---- maintenance -------------------------------------------------------
    def update_oid(self, oid: str, entries: List[Tuple[int, int]],
                   interesting: Iterable[int]) -> None:
        """Recompute *oid*'s memberships after its snapset changed
        (clone taken, trim applied, peer snapset adopted, delete)."""
        new = self.covered_snaps(entries, interesting)
        old = self.by_oid.get(oid, set())
        for sid in old - new:
            objs = self.by_snap.get(sid)
            if objs is not None:
                objs.discard(oid)
                if not objs:
                    del self.by_snap[sid]
        for sid in new - old:
            self.by_snap.setdefault(sid, set()).add(oid)
        if new:
            self.by_oid[oid] = new
        else:
            self.by_oid.pop(oid, None)

    def rebuild(self, snapsets: Dict[str, List[Tuple[int, int]]],
                interesting: Iterable[int]) -> None:
        """One pass over the loaded snapsets (PG mount)."""
        self.by_snap.clear()
        self.by_oid.clear()
        snaps = set(interesting)
        for oid, entries in snapsets.items():
            self.update_oid(oid, entries, snaps)


# ---- purged_snaps persistence (pg_info_t.purged_snaps role) ----------------

def encode_purged(purged: Set[int]) -> bytes:
    return b"".join(struct.pack("<Q", s) for s in sorted(purged))


def decode_purged(blob: bytes) -> Set[int]:
    return {struct.unpack_from("<Q", blob, off)[0]
            for off in range(0, len(blob), 8)}


def stage_purged(t, cid: str, purged: Set[int]) -> None:
    """Stage the purged-snap set into the PG meta object (same
    transaction as the trim it records)."""
    from .pg_log import PG_META_OID
    from ..os_store import hobject_t
    meta = hobject_t(PG_META_OID)
    t.touch(cid, meta)
    t.omap_setkeys(cid, meta, {PURGED_SNAPS_KEY: encode_purged(purged)})


def load_purged(store, cid: str) -> Set[int]:
    from .pg_log import PG_META_OID
    from ..os_store import hobject_t
    meta = hobject_t(PG_META_OID)
    if not store.collection_exists(cid) or not store.exists(cid, meta):
        return set()
    blob = store.omap_get(cid, meta).get(PURGED_SNAPS_KEY)
    return decode_purged(blob) if blob else set()
