"""rbd-mirror-lite: journal-based one-way image replication
(src/tools/rbd_mirror in the reference).

The reference's rbd-mirror daemon registers as a client on the primary
image's journal, replays its IO events against a secondary cluster's
copy of the image, and advances its commit position so the primary can
trim.  Same shape here: ``ImageMirror`` pulls the source journal's
entries past its own commit position, applies them to the destination
image through the shared event table (``apply_image_event``), and
commits per event — a killed mirror resumes exactly where it stopped,
and the source's trim is gated on the slowest client (the mirror) by
the journal's committed_tid.

Scope-outs: promotion/demotion (two-way failover), the bootstrap
image-sync for pre-existing data (mirrors must attach at create time
or the caller syncs first), and pool-level mirroring policy.

Port of ``ceph_tpu/rbd/mirror.py``, a copy.
"""
from __future__ import annotations

import json

from ..journal import Journaler
from .image import Image, RBD, RBDError, apply_image_event

MIRROR_CLIENT = "mirror"


class ImageMirror:
    """One directed (src image -> dst image) replication relationship."""

    def __init__(self, src_client, src_pool: str, image_name: str,
                 dst_client, dst_pool: str,
                 dst_data_pool: str = None):
        self.src = Image(src_client, src_pool, image_name)
        if not self.src.journaling:
            raise RBDError("mirror", -22)   # journaling required
        self.journal = Journaler(src_client, src_pool, self.src.id)
        self.journal.open()
        md = self.journal.get_metadata()
        if MIRROR_CLIENT not in md["clients"]:
            self.journal.register_client(MIRROR_CLIENT)
        dst_rbd = RBD(dst_client)
        if image_name not in dst_rbd.list(dst_pool):
            dst_rbd.create(dst_pool, image_name, self.src.size(),
                           self.src.order_log2, data_pool=dst_data_pool)
        self.dst = Image(dst_client, dst_pool, image_name)

    def _commit_position(self) -> int:
        md = self.journal.get_metadata()
        return md["clients"][MIRROR_CLIENT]["commit_tid"]

    def run_once(self) -> int:
        """Replay every new source event onto the destination; returns
        the number applied (ImageReplayer::handle_replay_ready)."""
        pos = self._commit_position()
        n = 0
        for tid, payload in self.journal.replay(after_tid=pos):
            apply_image_event(self.dst, json.loads(payload))
            self.journal.commit(MIRROR_CLIENT, tid)
            n += 1
        return n

    def trim_source(self) -> int:
        """Reclaim source journal sets every consumer has passed."""
        return self.journal.trim()


class PoolMirror:
    """Pool-mode mirroring (rbd mirror pool enable + the rbd-mirror
    daemon's pool watcher): every JOURNALED image in the source pool
    gets an ImageMirror to the destination; images that appear later
    are picked up on the next run.  Non-journaled images are skipped,
    like the reference skips images without the journaling feature."""

    def __init__(self, src_client, src_pool: str, dst_client,
                 dst_pool: str, dst_data_pool: str = None):
        self.src_client = src_client
        self.src_pool = src_pool
        self.dst_client = dst_client
        self.dst_pool = dst_pool
        self.dst_data_pool = dst_data_pool
        self.mirrors: dict = {}

    def run_once(self) -> dict:
        """Scan the pool, attach new journaled images, replay every
        mirror; returns {image: events_applied}."""
        import json as _json
        from .cls_rbd import RBD_DIRECTORY
        applied = {}
        for name in RBD(self.src_client).list(self.src_pool):
            m = self.mirrors.get(name)
            if m is not None:
                ret, out = self.src_client.exec(
                    self.src_pool, RBD_DIRECTORY, "rbd", "dir_get_id",
                    _json.dumps({"name": name}).encode())
                cur_id = out.decode() if ret == 0 else None
                if cur_id != m.src.id:
                    # deleted-and-recreated under the same name: the
                    # cached mirror replays a dead journal forever, and
                    # the old-generation DESTINATION must go too or
                    # replaying the new stream onto it leaves offsets
                    # the new generation never wrote reading old bytes
                    del self.mirrors[name]
                    try:
                        RBD(self.dst_client).remove(self.dst_pool,
                                                    name)
                    except RBDError as e:
                        if e.result != -2:
                            raise    # dst has snapshots/children:
                    m = None         # operator must resolve first
            if m is None:
                try:
                    m = ImageMirror(self.src_client, self.src_pool,
                                    name, self.dst_client,
                                    self.dst_pool, self.dst_data_pool)
                except RBDError as e:
                    if e.result == -22:      # journaling off: skip
                        continue
                    raise
                self.mirrors[name] = m
            applied[name] = m.run_once()
        # forget images that vanished from the source
        for name in list(self.mirrors):
            if name not in applied:
                del self.mirrors[name]
        return applied

    def trim_sources(self) -> None:
        for m in self.mirrors.values():
            m.trim_source()
