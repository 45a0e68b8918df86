"""ECBackend — the erasure-coded PG backend (write fan-out, reads, recovery).

Mirrors the reference pipeline shapes (src/osd/ECBackend.{h,cc}):

- full writes: submit_transaction → encode all stripes in ONE batched
  device call (ECUtil/encode over (S, k, C), replacing the per-stripe CPU
  loop at ECUtil.cc:136-148) → MOSDECSubOpWrite to every shard →
  all_commit ack (ECBackend.cc:1459,1793-2101).
- partial writes (rmw): submit_write runs the read-modify-write pipeline
  (start_rmw → try_state_to_reads → try_reads_to_commit,
  ECBackend.cc:1793,1819,1894): read the affected stripe range from the
  cheapest shard set (reconstructing if degraded), splice the new bytes,
  re-encode the whole affected range in one batched device call, and fan
  chunk-granularity deltas to every shard.  Per-object ops are pipelined
  through an ExtentCache (ExtentCache.h:23) so queued overlapping writes
  read projected extents instead of re-fetching shards.
- reads: objects_read_and_reconstruct consults the plugin's
  minimum_to_decode, fans MOSDECSubOpRead to the cheapest shard set, and
  reconstructs via the batched decode (ECBackend.cc:1580-1669,986,1141).
  Ranged reads fetch only the covering chunk range.  (The JAX package
  shards the reconstruct's survivor stack across a mesh inside the
  codec; the port has one card, and a mesh of two or more raises.)
- recovery: RecoveryOp reads k available shards, decodes the missing
  shard's chunks, and pushes them to the replacement OSD
  (ECBackend.cc:535-743).

Chunk placement is positional: acting[i] holds shard i (chunk_mapping
applies inside the codec).  HashInfo crc32c guards every shard read
(ECUtil.cc:161-207; checked like handle_sub_read's crc path,
ECBackend.cc:1022-1066).

Async write pipeline (``ec_pipeline_depth`` > 1): the encode no longer
blocks the op thread on ``future.result()`` — submit enqueues the
encode into the dispatch scheduler and registers a continuation
(``add_done_callback``) that fans out the per-shard sub-op writes when
the batched device call completes, so a SINGLE submitter can keep up
to ``ec_pipeline_depth`` encodes in flight per PG and the scheduler
sees real batches (docs/DISPATCH.md "Async write pipeline").  Per-oid
ordering is untouched (the per-object queue still admits one op at a
time), depth 1 (the default) is exactly the old synchronous path, and
a full window backpressures by force-flushing the scheduler inline —
never by parking the submitter on a cross-thread wait.

Sub-op write retry: every in-flight write remembers its per-shard
messages; the OSD tick (and the deterministic fabric's idle kick)
resends unacked sub-writes after ``ec_subwrite_retry_timeout``, so a
messenger-level drop no longer wedges the per-oid pipeline until
peering.  Shard-side replay is idempotent — ``handle_sub_write``
short-circuits when the stored object version already covers the
message's version and just re-acks.

Port of ``ceph_tpu/osd/ec_backend.py``.  Its device seams: the
resident encode (``_encode_resident``, K5 through ``ops/resident``) raises
on a failed build or launch instead of degrading to the classic path; the
classic and pipelined encodes go through the port's dispatch scheduler
(one K1 launch per flush or inline call); ``_shard_crc`` verifies a
resident body with K4 (``ops/crc32c_device``).  The rest is host logic,
copied.
"""
from __future__ import annotations

import struct
import threading

from ..common.lockdep import DebugLock, DebugRLock
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Set, Tuple

import numpy as np

from ..common.config import g_conf
from ..common.perf_counters import PerfCounters, PerfCountersBuilder
from ..dispatch import g_dispatcher
from ..fault import (fault_perf_counters, g_faults, l_fault_eio_injected,
                     l_fault_eio_reconstructs)
from ..msg import (
    MOSDECSubOpRead, MOSDECSubOpReadReply, MOSDECSubOpWrite,
    MOSDECSubOpWriteReply,
)
from ..trace import (g_devprof, g_oplat, g_perf_histograms, g_tracer,
                     latency_in_bytes_axes, pipeline_axes)
from ..os_store import MemStore, Transaction, hobject_t
from ..os_store.device_shard import (DeviceShard, l_msd_crc_device,
                                     l_msd_crc_host,
                                     memstore_device_perf_counters)
from ..utils.crc32c import crc32c
from .ecutil import HashInfo, stripe_info_t

SIZE_ATTR = "_size"          # logical object size (un-padded)
DIGEST_ATTR = "_data_digest"  # crc32c recorded at full-object write
# (object_info_t::data_digest role, src/osd/osd_types.h): lets scrub
# tell WHICH copy rotted instead of just that copies differ; partial
# overwrites invalidate it (rmattr), exactly like the reference
# clears FLAG_DATA_DIGEST on unaligned writes
HINFO_ATTR = "hinfo_key"     # reference's hinfo xattr name
USER_ATTR_PREFIX = "_u_"     # user xattr namespace in shard/replica attrs

# ---- pipeline perf counters (perf dump / Prometheus) -----------------------
PIPELINE_FIRST = 93000
l_pipeline_inflight = 93001       # gauge: encodes in flight (all PGs)
l_pipeline_submitted = 93002      # ops submitted through the async path
l_pipeline_backpressure = 93003   # full-window force-flushes
l_pipeline_stale_drops = 93004    # continuations dropped by an interval
                                  # change (peering raced the encode)
l_pipeline_errors = 93005         # ops whose encode future carried an
                                  # exception (client answered EIO)
l_pipeline_subwrite_resends = 93006  # unacked sub-op writes resent
PIPELINE_LAST = 93010

_pipeline_pc: Optional[PerfCounters] = None
_pipeline_pc_lock = DebugLock("pipeline_pc::init")


def pipeline_perf_counters() -> PerfCounters:
    """The EC write pipeline's counter logger (perf dump/Prometheus)."""
    global _pipeline_pc
    if _pipeline_pc is not None:
        return _pipeline_pc
    with _pipeline_pc_lock:
        if _pipeline_pc is None:
            b = PerfCountersBuilder("pipeline", PIPELINE_FIRST,
                                    PIPELINE_LAST)
            b.add_u64(l_pipeline_inflight, "pipeline_inflight",
                      "EC write encodes currently in flight in the "
                      "dispatch scheduler (all PGs)")
            b.add_u64_counter(l_pipeline_submitted, "submitted",
                              "EC writes submitted through the async "
                              "pipeline")
            b.add_u64_counter(l_pipeline_backpressure, "backpressure",
                              "full-window force-flushes")
            b.add_u64_counter(l_pipeline_stale_drops, "stale_drops",
                              "continuations dropped by an interval "
                              "change")
            b.add_u64_counter(l_pipeline_errors, "encode_errors",
                              "encode futures resolved with an error")
            b.add_u64_counter(l_pipeline_subwrite_resends,
                              "subwrite_resends",
                              "unacked EC sub-op writes resent")
            _pipeline_pc = b.create_perf_counters()
    return _pipeline_pc


def user_attrs_of(attrs: Dict[str, bytes]) -> Dict[str, bytes]:
    """The user-visible xattrs hiding in a shard's attr dict."""
    n = len(USER_ATTR_PREFIX)
    return {k[n:]: v for k, v in attrs.items()
            if k.startswith(USER_ATTR_PREFIX)}


def stash_pre_write_state(t: Transaction, store: MemStore, pg, oid: str,
                          cid: str, ho, version: int) -> None:
    """Stash the object's pre-write state (body + every attr) into the
    PG meta omap in the same transaction as the write, so peering can
    roll this write back if it proves divergent — the role of the
    reference's append-only writes + rollback info in the PG log
    (ECTransaction.h rollback extents, ecbackend.rst:1-27)."""
    from .pg_log import encode_rollback, load_rollback, stage_rollback
    prior = load_rollback(store, pg.meta_cid(), oid)
    if prior is not None and prior[0] >= version:
        # first-writer-wins per version: a replayed fan-out (resend whose
        # log entry was dropped as stale, so the log dedup can't see it)
        # would re-stash POST-apply state here and peering's rollback
        # would then restore the wrong bytes — keep the original stash
        return
    exists = store.collection_exists(cid) and store.exists(cid, ho)
    data = store.read(cid, ho) if exists else b""
    attrs = dict(store.getattrs(cid, ho)) if exists else {}
    mcid = pg.ensure_meta_collection(t)
    stage_rollback(t, mcid, oid,
                   encode_rollback(version, exists, data, attrs))


class ExtentCache:
    """Projected in-flight object extents (src/osd/ExtentCache.h:23).

    While a per-object write pipeline is non-empty, the logical bytes each
    op produced are cached here so the next queued op's rmw pre-read hits
    memory instead of re-fetching shards.  Extents are stripe-range bytes
    (already padded); the map is trimmed when the object's pipeline drains.
    """

    def __init__(self):
        self._extents: Dict[str, List[Tuple[int, bytearray]]] = {}
        self._sizes: Dict[str, int] = {}

    def projected_size(self, oid: str) -> Optional[int]:
        return self._sizes.get(oid)

    def write(self, oid: str, offset: int, data: bytes,
              new_size: int) -> None:
        """Merge [offset, offset+len) into the extent list (sorted,
        non-overlapping, coalesced)."""
        runs = self._extents.setdefault(oid, [])
        new = (offset, bytearray(data))
        merged: List[Tuple[int, bytearray]] = []
        for off, buf in runs:
            if off + len(buf) < new[0] or new[0] + len(new[1]) < off:
                merged.append((off, buf))
                continue
            # overlap/adjacent: splice the older run around the new bytes
            lo = min(off, new[0])
            hi = max(off + len(buf), new[0] + len(new[1]))
            combined = bytearray(hi - lo)
            combined[off - lo:off - lo + len(buf)] = buf
            combined[new[0] - lo:new[0] - lo + len(new[1])] = new[1]
            new = (lo, combined)
        merged.append(new)
        merged.sort(key=lambda r: r[0])
        self._extents[oid] = merged
        self._sizes[oid] = new_size

    def read(self, oid: str, offset: int, length: int) -> Optional[bytes]:
        """The cached bytes for [offset, offset+length) iff fully covered."""
        for off, buf in self._extents.get(oid, []):
            if off <= offset and offset + length <= off + len(buf):
                return bytes(buf[offset - off:offset - off + length])
        return None

    def replace(self, oid: str, data: bytes, size: int) -> None:
        """Whole-object overwrite: drop stale extents, cache the new body."""
        self._extents[oid] = [(0, bytearray(data))]
        self._sizes[oid] = size

    def clear(self, oid: str) -> None:
        self._extents.pop(oid, None)
        self._sizes.pop(oid, None)


@dataclass
class InflightWrite:
    tid: int
    oid: str
    client_reply: Callable[[int], None]
    pending_shards: Set[int] = field(default_factory=set)
    on_all_commit: Optional[Callable[[], None]] = None
    # sub-write retry state: the exact message sent to each shard (the
    # in-process fabric passes objects by reference, so resending the
    # same object is byte-identical), the destination osd, the cluster
    # clock at the last send, and how many resend rounds have run
    sent_msgs: Dict[int, Tuple[int, object]] = field(default_factory=dict)
    last_send: float = 0.0
    resends: int = 0
    # the submitting op's stage ledger (trace/oplat): the last shard
    # ack stamps its ack_gather boundary
    ledger: object = None


@dataclass
class InflightRead:
    """One fan-out read round over a chunk range.

    ``on_done(result, data, size, attrs)``: data = decoded logical bytes
    for the stripe range covering [chunk_off, chunk_off+chunk_len)
    (padded), size = the object's logical size from shard attrs (-1 if
    unknown), attrs = the object's user xattrs (replicated on every
    shard, so any healthy reply carries them).
    """
    tid: int
    oid: str
    on_done: Callable[[int, bytes, int, Dict[str, bytes]], None]
    chunk_off: int = 0
    chunk_len: int = 0            # 0 = to end of shard
    attrs_only: bool = False
    size: int = -1
    chunks: Dict[int, bytes] = field(default_factory=dict)
    pending: Set[int] = field(default_factory=set)
    failed: Set[int] = field(default_factory=set)
    seen: int = 0                 # shards that answered at all
    saw_eio: bool = False         # any non-ENOENT shard failure (crc etc.)
    raw: bool = False             # recovery mode: deliver raw shard chunks
    repair_for: int = -1          # >=0: sub-chunk repair round for this
                                  # shard — replies carry computed helper
                                  # contributions, and NO reconstruction
                                  # retry fans out (the recovery
                                  # orchestrator owns the fallback)
    user_attrs: Dict[str, bytes] = field(default_factory=dict)
    ledger: object = None         # see InflightWrite.ledger


@dataclass
class RMWOp:
    """One queued partial write (start_rmw state, ECBackend.h:467)."""
    tid: int
    oid: str
    data: bytes
    offset: Optional[int]         # None = append at current size
    on_commit: Callable[[int], None]
    old_size: int = -1
    # the submitting op's span, captured at ENQUEUE time: a queued op
    # starts from _op_done (the sub-write-reply dispatch context, no
    # span active), so reading the thread-current span at start time
    # would trace contended ops — the slow ones — as orphans
    parent_span: object = None
    # the op's stage ledger, captured at enqueue for the same reason
    ledger: object = None


@dataclass
class FullWriteOp:
    tid: int
    oid: str
    data: bytes
    on_commit: Callable[[int], None]
    xattrs: Optional[Dict[str, bytes]] = None   # full user-attr replacement
    snapset_update: Optional[Tuple[str, bytes]] = None
    parent_span: object = None    # see RMWOp.parent_span
    ledger: object = None         # see RMWOp.ledger


@dataclass
class VectorOp:
    """A queued atomic multi-op vector (the interpreter's rmw unit).

    ``run(result, body, size, attrs)`` executes the ops against the
    fetched state and returns a commit spec — None (read-only/aborted;
    reply already sent), ("write", body, attrs, on_commit, omap),
    ("attrs", attrs, on_commit, omap) or ("delete", fan_fn, on_commit).
    Riding the per-oid queue serializes whole vectors against each
    other and the single-op write pipelines (start_rmw's guarantee).
    """
    tid: int
    oid: str
    run: Callable
    meta_only: bool = False   # no body op: fetch attrs from one shard
    parent_span: object = None    # see RMWOp.parent_span
    ledger: object = None         # see RMWOp.ledger


class ECBackend:
    """One per EC PG on its primary; shard handlers run on every OSD."""

    def __init__(self, pg, ec_impl, stripe_width: int):
        self.pg = pg                      # owning PG (provides osd/messenger)
        self.ec_impl = ec_impl
        k = ec_impl.get_data_chunk_count()
        # codecs with their own chunk geometry (product-matrix
        # regenerating codes: stored chunk != stripe_width/k) supply a
        # stripe_info through the plugin hook; classic codes keep the
        # reference shape
        mk_sinfo = getattr(ec_impl, "make_stripe_info", None)
        self.sinfo = mk_sinfo(stripe_width) if mk_sinfo is not None \
            else stripe_info_t(k, stripe_width)
        self.k = k
        self.n = ec_impl.get_chunk_count()
        self.inflight_writes: Dict[int, InflightWrite] = {}
        self.inflight_reads: Dict[int, InflightRead] = {}
        self.extent_cache = ExtentCache()
        self._oid_queues: Dict[str, Deque] = {}
        self._tid = 0
        # async write pipeline (ec_pipeline_depth > 1): encodes this PG
        # currently has in flight in the dispatch scheduler, an RLock
        # because continuations run on whichever thread flushed (the
        # submitter itself under backpressure), and a generation stamp
        # so a continuation resolving AFTER an interval change drops
        # its fan-out instead of writing into a dead acting set
        self.pipeline_inflight = 0
        self._pipeline_futs: Deque = deque()   # oldest-first pending
        self._pipeline_lock = DebugRLock("ECBackend::pipeline_lock")
        self._interval_gen = 0
        # batched-codec latency x bytes distributions, per daemon
        # (dumped under `perf histogram dump` next to the op hists)
        name = pg.osd.name
        self.hist_encode = g_perf_histograms.get(
            name, "ec_encode_latency_in_bytes_histogram",
            latency_in_bytes_axes)
        self.hist_decode = g_perf_histograms.get(
            name, "ec_decode_latency_in_bytes_histogram",
            latency_in_bytes_axes)
        # write-pipeline occupancy at encode-submit time (linear,
        # dimensionless — the mgr renderer exports raw bucket edges
        # like the dispatcher's occupancy family)
        self.hist_pipeline = g_perf_histograms.get(
            name, "pipeline_inflight_histogram", pipeline_axes)
        # pipelined submit->resolve latency (queue wait INCLUDED) —
        # kept apart from hist_encode, whose samples are pure codec
        # calls the slow-op forensics compare against
        self.hist_encode_pipelined = g_perf_histograms.get(
            name, "ec_encode_pipelined_latency_in_bytes_histogram",
            latency_in_bytes_axes)

    # ---- helpers ----------------------------------------------------------
    def next_tid(self) -> int:
        self._tid += 1
        return self._tid

    def on_change(self) -> None:
        """Interval change (new acting set): drop all in-flight state —
        the reference's ECBackend::on_change; clients resend through the
        Objecter, so unanswered ops are safe to forget.  Pipelined
        encodes still queued in the dispatcher are NOT cancelled (their
        device work may be batched with live PGs'); bumping the
        generation makes their continuations complete as no-ops."""
        self.inflight_writes.clear()
        self.inflight_reads.clear()
        self._oid_queues.clear()
        self.extent_cache = ExtentCache()
        with self._pipeline_lock:
            self._interval_gen += 1

    def shard_cid(self, shard: int) -> str:
        return f"{self.pg.pgid[0]}.{self.pg.pgid[1]}s{shard}"

    def shard_oid(self, oid: str, shard: int) -> hobject_t:
        return hobject_t(oid, shard)

    def _pad(self, data: bytes) -> bytes:
        w = self.sinfo.get_stripe_width()
        rem = len(data) % w
        if not rem:
            return data
        # stripe-align pad: the first host-side copy of the write
        # path's ledger (bufferlist bytes -> padded stripe buffer)
        out = data + b"\0" * (w - rem)
        g_devprof.account_host_copy("ec.pad_stripe_align", len(out))
        return out

    # ---- instrumented codec entry points ----------------------------------
    def _encode(self, data: bytes) -> Dict[int, np.ndarray]:
        """The one batched-encode funnel: span (tracer on) + latency x
        bytes histogram (always).  Host-side wall clock only — the
        encode itself already materializes chunks for the wire, so no
        extra device sync is introduced.  Execution goes through the
        dynamic-batching device scheduler (dispatch/), which is
        an exact passthrough at the default window=0 and coalesces
        signature-equal requests from other PGs otherwise."""
        t0 = time.perf_counter()
        want = set(range(self.n))
        if g_tracer.enabled:
            with g_tracer.span("ec_encode") as sp:
                if sp is not None:      # enable() can race the check
                    sp.tags["bytes"] = len(data)
                shards = g_dispatcher.encode(self.sinfo, self.ec_impl,
                                             data, want)
        else:
            shards = g_dispatcher.encode(self.sinfo, self.ec_impl, data,
                                         want)
        self.hist_encode.inc((time.perf_counter() - t0) * 1e6, len(data))
        return shards

    def _encode_resident(self, data: bytes) \
            -> Optional[Dict[int, DeviceShard]]:
        """The zero-copy encode: fused GF matmul + crc32c in one device
        call (K5, ops/resident), shard bodies staying on the card as
        ``DeviceShard`` handles.  None = residency off, a payload that is
        not whole stripes, or a codec whose layout rules the fused kernel
        out: all decided from shape before any launch, and callers then
        take the classic funnel, byte-identical by construction.  A
        failed build or launch raises to the caller."""
        if int(g_conf.get_val("os_memstore_device_bytes_max")) <= 0:
            return None
        w = self.sinfo.get_stripe_width()
        if not data or len(data) % w:
            return None
        from ..ops.resident import encode_resident_shards
        buf = np.frombuffer(bytes(data), dtype=np.uint8) \
            if not isinstance(data, np.ndarray) else data
        stripes = buf.reshape(len(buf) // w, self.k,
                              self.sinfo.get_chunk_size())
        t0 = time.perf_counter()
        if g_tracer.enabled:
            with g_tracer.span("ec_encode") as sp:
                if sp is not None:
                    sp.tags["bytes"] = len(data)
                    sp.tags["resident"] = True
                shards = encode_resident_shards(self.ec_impl, stripes)
        else:
            shards = encode_resident_shards(self.ec_impl, stripes)
        if shards is None:
            return None
        g_oplat.checkpoint("device_call")
        self.hist_encode.inc((time.perf_counter() - t0) * 1e6, len(data))
        return shards

    def _decode_timed(self, nbytes: int, fn, *args):
        """Shared decode instrumentation (concat + shard-recovery)."""
        t0 = time.perf_counter()
        if g_tracer.enabled:
            with g_tracer.span("ec_decode") as sp:
                if sp is not None:      # enable() can race the check
                    sp.tags["bytes"] = nbytes
                out = fn(*args)
        else:
            out = fn(*args)
        self.hist_decode.inc((time.perf_counter() - t0) * 1e6, nbytes)
        return out

    def _encode_pipelined(self, data: bytes, parent_span,
                          then: Callable[[Optional[Dict[int, np.ndarray]],
                                          Optional[BaseException]],
                                         None]) -> None:
        """The write path's encode in continuation-passing style:
        ``then(shards, None)`` on success, ``then(None, exc)`` on a
        (semantic) encode failure.

        Depth <= 1 (the default) is the old synchronous call by
        construction — same funnel, inline continuation.  Depth > 1
        submits the encode as a dispatch future and returns
        immediately; the continuation runs on whichever thread flushes
        the batch (window expiry from the OSD tick, batch_max, another
        submitter's demand, or this PG's own backpressure flush), with
        the submitting op's span re-anchored so the sub_write fan-out
        and the batch_dispatch children stay on the op's trace."""
        depth = int(g_conf.get_val("ec_pipeline_depth"))
        if depth <= 1:
            # device-resident first (os_memstore_device_bytes_max > 0):
            # the fused encode+crc keeps shard bodies in HBM and the
            # fan-out passes handles — zero body d2h on this path
            shards = self._encode_resident(data)
            if shards is not None:
                then(shards, None)
                return
            # today's synchronous path by construction: any encode
            # exception propagates to the submitter exactly as before
            then(self._encode(data), None)
            return
        pc = pipeline_perf_counters()
        # window reservation is atomic with the full-check (a plain
        # check-then-increment would let N concurrent op threads
        # overshoot the depth by N-1).  Backpressure drains the window
        # by EXECUTING pending work inline — force() flushes only the
        # OLDEST request's own queue (its signature-mates, i.e. this
        # PG's backlog) so other PGs' collection windows keep
        # accumulating; a mixed-signature window falls back to the
        # scheduler-wide flush.  A submitter whose window stays full
        # after two rounds (PG-mates mid-execution on ANOTHER thread)
        # proceeds rather than spinning: the overshoot is transient
        # and bounded by the op-thread count.
        rounds = 0
        while True:
            with self._pipeline_lock:
                if self.pipeline_inflight < depth or rounds >= 2:
                    self.pipeline_inflight += 1
                    inflight = self.pipeline_inflight
                    break
                oldest = self._pipeline_futs[0] \
                    if self._pipeline_futs else None
            pc.inc(l_pipeline_backpressure)
            if oldest is not None:
                oldest.force()
            else:
                g_dispatcher.flush()
            rounds += 1
        gen = self._interval_gen
        nbytes = len(data)
        led = g_oplat.current()      # the op's stage ledger, if any
        t0 = time.perf_counter()
        sp = g_tracer.begin("ec_encode") if g_tracer.enabled else None
        if sp is not None:
            sp.tags["bytes"] = nbytes
            sp.tags["pipelined"] = True
        # the gauge counts encodes in flight across ALL PGs, so it must
        # inc/dec — a set() of this PG's count would clobber others'
        pc.inc(l_pipeline_inflight)
        self.hist_pipeline.inc(inflight)
        pc.inc(l_pipeline_submitted)
        want = set(range(self.n))
        # activate the encode span around the submit so the scheduler
        # captures it as the request's parent — batch_dispatch children
        # then hang off the submitting op exactly like the sync path
        with g_tracer.activate(sp):
            fut = g_dispatcher.submit_encode(self.sinfo, self.ec_impl,
                                             data, want)
        with self._pipeline_lock:
            self._pipeline_futs.append(fut)

        def deliver(f) -> None:
            """The PG-state half of the continuation (fan-out, version
            allocation, per-oid queue advance).  Must run under the
            same exclusion as op execution — inline in synchronous
            mode, via the sharded op queue (whose workers take
            pg.op_lock) when an op thread-pool is active."""
            if gen != self._interval_gen:
                # peering raced the encode: the acting set this op was
                # aimed at is gone; the client resends via the Objecter
                pc.inc(l_pipeline_stale_drops)
                return
            err = f.exception()      # resolved — never blocks here
            if err is not None:
                pc.inc(l_pipeline_errors)
            with g_tracer.activate(parent_span), g_oplat.activate(led):
                if err is not None:
                    then(None, err)
                else:
                    then(f.result(), None)

        def on_ready(f) -> None:
            with self._pipeline_lock:
                self.pipeline_inflight -= 1
                try:
                    self._pipeline_futs.remove(f)
                except ValueError:
                    pass
            pc.dec(l_pipeline_inflight)
            g_tracer.finish(sp)
            # submit->resolve wall time INCLUDES the collection-window
            # queue wait, so it must not pollute the sync path's pure
            # codec-latency family — pipelined ops get their own
            self.hist_encode_pipelined.inc(
                (time.perf_counter() - t0) * 1e6, nbytes)
            osd = self.pg.osd
            if getattr(osd, "op_tp", None) is not None:
                # threaded op queue: the flusher thread may hold (or
                # race) another PG's op_lock — taking this PG's lock
                # inline could deadlock AB-BA, and mutating unlocked
                # would race the workers.  Re-enter through the op
                # queue instead; a worker delivers under pg.op_lock.
                from ..common.work_queue import CLASS_CLIENT
                osd.op_wq.enqueue(self.pg.pgid, CLASS_CLIENT,
                                  ("pipeline", self.pg,
                                   lambda: deliver(f)))
            else:
                deliver(f)

        fut.add_done_callback(on_ready)

    # ---- per-object write pipeline ----------------------------------------
    def _enqueue(self, oid: str, op) -> None:
        q = self._oid_queues.setdefault(oid, deque())
        q.append(op)
        if len(q) == 1:
            self._start_op(op)

    def _op_done(self, oid: str) -> None:
        q = self._oid_queues.get(oid)
        if not q:
            return
        q.popleft()
        if q:
            self._start_op(q[0])
        else:
            del self._oid_queues[oid]
            self.extent_cache.clear(oid)

    def _start_op(self, op) -> None:
        # re-enter the submitting op's span context: head-of-queue ops
        # start inline under it anyway, but a QUEUED op starts from
        # _op_done where no (or an unrelated) span is current — the
        # stage ledger re-anchors the same way
        with g_tracer.activate(op.parent_span), \
                g_oplat.activate(op.ledger):
            if isinstance(op, FullWriteOp):
                self._start_full_write(op)
            elif isinstance(op, VectorOp):
                self._start_vector(op)
            else:
                self._start_rmw(op)

    # ---- write path (primary) --------------------------------------------
    def submit_transaction(self, oid: str, data: bytes,
                           on_commit: Callable[[int], None],
                           xattrs: Optional[Dict[str, bytes]] = None,
                           snapset_update: Optional[Tuple[str, bytes]]
                           = None) -> int:
        """Full-object EC write: one batched encode, fan out shards.

        ``xattrs``: full replacement set of user xattrs riding the same
        shard transactions (ECTransaction attr updates); None leaves the
        shards' existing user attrs alone."""
        tid = self.next_tid()
        self._enqueue(oid, FullWriteOp(tid=tid, oid=oid, data=bytes(data),
                                       on_commit=on_commit, xattrs=xattrs,
                                       snapset_update=snapset_update,
                                       parent_span=g_tracer.current(),
                                       ledger=g_oplat.current()))
        return tid

    def submit_vector(self, oid: str, run: Callable,
                      meta_only: bool = False) -> int:
        """Queue an atomic multi-op vector behind this object's other
        writes (see VectorOp)."""
        tid = self.next_tid()
        self._enqueue(oid, VectorOp(tid=tid, oid=oid, run=run,
                                    meta_only=meta_only,
                                    parent_span=g_tracer.current(),
                                    ledger=g_oplat.current()))
        return tid

    def _start_vector(self, op: VectorOp) -> None:
        """Head-of-queue vector execution: fetch state (attrs-only probe
        for pure-metadata vectors; whole-object decode otherwise), run
        the interpreter, start the committed mutation — exactly one
        _op_done fires when the commit (or the read-only reply) lands."""

        def have_state(res: int, body: bytes, size: int,
                       attrs: Dict[str, bytes]) -> None:
            spec = op.run(res, body, size, attrs)
            if spec is None:
                self._op_done(op.oid)
                return
            kind = spec[0]
            if kind == "write":
                _, body2, attrs2, on_commit, _omap = spec
                # _start_full_write's all_commit pops the queue head —
                # which is this VectorOp
                self._start_full_write(FullWriteOp(
                    tid=op.tid, oid=op.oid, data=bytes(body2),
                    on_commit=on_commit, xattrs=attrs2,
                    parent_span=op.parent_span, ledger=op.ledger))
            elif kind == "attrs":
                _, attrs2, on_commit, _omap = spec
                # have_state runs from a read-reply callback: re-anchor
                # the op's ledger so the attr fan's fan_out/ack_gather
                # stages attribute to it
                with g_oplat.activate(op.ledger):
                    self._fan_attrs(op.tid, op.oid, attrs2,
                                    lambda r: (on_commit(r),
                                               self._op_done(op.oid)))
            else:  # ("delete", fan_fn, on_commit)
                _, fan_fn, on_commit = spec
                self.extent_cache.clear(op.oid)
                fan_fn()
                on_commit(0)
                self._op_done(op.oid)

        if op.meta_only:
            self._start_read(
                op.oid, 0, 0, True,
                lambda res, _d, size, attrs: have_state(res, b"", size,
                                                        attrs))
        else:
            self.object_state(op.oid, have_state)

    def _fan_attrs(self, tid: int, oid: str, xattrs: Dict[str, bytes],
                   on_commit: Callable[[int], None]) -> None:
        """Metadata-only mutation: replace the user xattrs on every
        shard without touching the body (a versioned, logged write).
        Only called at the head of the per-oid queue."""
        wr = InflightWrite(tid=tid, oid=oid, client_reply=on_commit,
                           on_all_commit=lambda: on_commit(0),
                           ledger=g_oplat.current())
        acting = self.pg.acting_shards()
        version = self.pg.next_version()
        for shard, osd in acting.items():
            msg = MOSDECSubOpWrite(
                tid=tid, pgid=self.pg.pgid, shard=shard, oid=oid,
                chunk=b"", attr_only=True, xattrs=dict(xattrs),
                version=version)
            wr.pending_shards.add(shard)
            wr.sent_msgs[shard] = (osd, msg)
            self.pg.send_to_osd(osd, msg)
        if wr.ledger is not None:
            wr.ledger.mark("fan_out")
        wr.last_send = self.pg.osd.now
        self.inflight_writes[tid] = wr

    def submit_write(self, oid: str, data: bytes, offset: Optional[int],
                     on_commit: Callable[[int], None]) -> int:
        """Partial write (offset) or append (offset=None): rmw pipeline."""
        tid = self.next_tid()
        self._enqueue(oid, RMWOp(tid=tid, oid=oid, data=bytes(data),
                                 offset=offset, on_commit=on_commit,
                                 parent_span=g_tracer.current(),
                                 ledger=g_oplat.current()))
        return tid

    def _start_full_write(self, op: FullWriteOp) -> None:
        # reached both from _start_op and from a VectorOp's read
        # callback, so re-anchor the span + ledger context here
        with g_tracer.activate(op.parent_span), \
                g_oplat.activate(op.ledger):
            padded = self._pad(op.data)

            def have_shards(shards, err) -> None:
                if err is not None:
                    # the encode future carried an error (semantic —
                    # device failures already degraded to the CPU twin
                    # inside the guard): the client op must still
                    # complete, as EIO
                    op.on_commit(-5)
                    self._op_done(op.oid)
                    return

                def all_commit() -> None:
                    self.extent_cache.replace(op.oid, padded,
                                              len(op.data))
                    op.on_commit(0)
                    self._op_done(op.oid)

                self._fan_out_shards(op.tid, op.oid, shards, chunk_off=0,
                                     partial=False,
                                     new_size=len(op.data),
                                     on_all_commit=all_commit,
                                     client_reply=op.on_commit,
                                     version=self.pg.next_version(),
                                     xattrs=op.xattrs,
                                     snapset_update=op.snapset_update)

            self._encode_pipelined(padded, op.parent_span, have_shards)

    # ---- rmw pipeline (start_rmw, ECBackend.cc:1793) -----------------------
    def _start_rmw(self, op: RMWOp) -> None:
        # 1. learn the object's current (projected) size
        projected = self.extent_cache.projected_size(op.oid)
        if projected is not None:
            self._rmw_have_size(op, projected)
            return
        local = self._local_size(op.oid)
        if local is not None:
            self._rmw_have_size(op, local)
            return
        # degraded primary without its own shard: probe attrs over the wire
        self._start_read(op.oid, 0, 0, True,
                         lambda res, _d, size, _a: self._rmw_have_size(
                             op, max(size, 0) if res in (0, -2) else res,
                             err=res not in (0, -2)))

    def _local_size(self, oid: str) -> Optional[int]:
        """Size from the primary's own shard; None = ask over the wire
        (a fresh primary may not hold its shard yet)."""
        my_shard = self.pg.my_shard()
        if my_shard < 0:
            return None
        store = self.pg.osd.store
        cid = self.shard_cid(my_shard)
        ho = hobject_t(oid, my_shard)
        if not store.collection_exists(cid) or not store.exists(cid, ho):
            return None
        try:
            return struct.unpack("<Q", store.getattr(cid, ho, SIZE_ATTR))[0]
        except KeyError:
            return store.stat(cid, ho) * self.k

    def _rmw_have_size(self, op: RMWOp, old_size: int,
                       err: bool = False) -> None:
        if err:
            op.on_commit(old_size)  # old_size carries the errno here
            self._op_done(op.oid)
            return
        op.old_size = old_size
        offset = old_size if op.offset is None else op.offset
        op.offset = offset
        w = self.sinfo.get_stripe_width()
        a0 = self.sinfo.logical_to_prev_stripe_offset(offset)
        a1 = self.sinfo.logical_to_next_stripe_offset(offset + len(op.data))
        old_aligned = self.sinfo.logical_to_next_stripe_offset(old_size)
        if getattr(self.ec_impl, "requires_whole_object_rw", False):
            # non-systematic codecs: chunk offsets don't map to logical
            # ranges, so an rmw reads and re-encodes the WHOLE object
            a0 = 0
            a1 = max(a1, old_aligned)
        read_end = min(a1, old_aligned)
        if read_end <= a0:
            self._rmw_have_old(op, a0, a1, b"")
            return
        cached = self.extent_cache.read(op.oid, a0, read_end - a0)
        if cached is not None:
            self._rmw_have_old(op, a0, a1, cached)
            return
        c0 = self.sinfo.aligned_logical_offset_to_chunk_offset(a0)
        c1 = self.sinfo.aligned_logical_offset_to_chunk_offset(read_end)
        self._start_read(
            op.oid, c0, c1 - c0, False,
            lambda res, data, _size, _a: (
                self._rmw_have_old(op, a0, a1, data) if res == 0 or
                (res == -2 and old_size == 0)
                else (op.on_commit(res), self._op_done(op.oid))))

    def _rmw_have_old(self, op: RMWOp, a0: int, a1: int,
                      old_bytes: bytes) -> None:
        """Splice + re-encode the affected range in one device call, then
        fan chunk deltas (try_reads_to_commit, ECBackend.cc:1894).
        Runs from a read-reply callback — re-anchor the span and
        ledger contexts."""
        with g_tracer.activate(op.parent_span), \
                g_oplat.activate(op.ledger):
            buf = bytearray(a1 - a0)
            buf[:len(old_bytes)] = old_bytes
            rel = op.offset - a0
            buf[rel:rel + len(op.data)] = op.data
            new_size = max(op.old_size, op.offset + len(op.data))
            c0 = self.sinfo.aligned_logical_offset_to_chunk_offset(a0)

            def have_shards(shards, err) -> None:
                if err is not None:
                    op.on_commit(-5)
                    self._op_done(op.oid)
                    return

                def all_commit() -> None:
                    self.extent_cache.write(op.oid, a0, bytes(buf),
                                            new_size)
                    op.on_commit(0)
                    self._op_done(op.oid)

                self._fan_out_shards(op.tid, op.oid, shards,
                                     chunk_off=c0,
                                     partial=True, new_size=new_size,
                                     on_all_commit=all_commit,
                                     client_reply=op.on_commit,
                                     version=self.pg.next_version())

            self._encode_pipelined(bytes(buf), op.parent_span,
                                   have_shards)

    def _fan_out_shards(self, tid: int, oid: str,
                        shards: Dict[int, np.ndarray], chunk_off: int,
                        partial: bool, new_size: int,
                        on_all_commit: Callable[[], None],
                        client_reply: Callable[[int], None],
                        version: int = 0,
                        xattrs: Optional[Dict[str, bytes]] = None,
                        snapset_update: Optional[Tuple[str, bytes]]
                        = None) -> None:
        wr = InflightWrite(tid=tid, oid=oid, client_reply=client_reply,
                           on_all_commit=on_all_commit,
                           ledger=g_oplat.current())
        acting = self.pg.acting_shards()
        # propagate the op's trace so shard OSDs open child spans
        # (the Message.h:254 slot riding every sub-op)
        cur_trace = g_tracer.current_trace_id() if g_tracer.enabled else 0
        cur_span = g_tracer.current_span_id() if g_tracer.enabled else 0
        msg_bytes = 0
        for shard, osd in acting.items():
            body = shards[shard] if shard in shards else b""
            if isinstance(body, DeviceShard):
                # in-process fabric: the handle itself rides the
                # message — the body never leaves the device here
                chunk = body
            elif isinstance(body, np.ndarray):
                if body.flags["C_CONTIGUOUS"]:
                    # zero-copy view over the one materialized pack
                    # buffer (ecutil.pack_shards accounted that copy)
                    chunk = body.data
                else:
                    chunk = body.tobytes()
                    msg_bytes += len(chunk)
            else:
                chunk = body
                msg_bytes += len(body)
            msg = MOSDECSubOpWrite(
                tid=tid, pgid=self.pg.pgid, shard=shard, oid=oid,
                chunk=chunk, offset=chunk_off, partial=partial,
                at_version=new_size, version=version, xattrs=xattrs,
                snapset_update=snapset_update,
                trace_id=cur_trace, parent_span_id=cur_span)
            wr.pending_shards.add(shard)
            wr.sent_msgs[shard] = (osd, msg)
            self.pg.send_to_osd(osd, msg)
        if msg_bytes:
            # last stage of the write path's copy ledger: shard chunk
            # buffers materialized into per-shard sub-op messages
            g_devprof.account_host_copy("ec.subop_messages", msg_bytes)
        if wr.ledger is not None:
            # time ledger's counterpart: message build + send loop done
            wr.ledger.mark("fan_out")
        wr.last_send = self.pg.osd.now
        self.inflight_writes[tid] = wr

    def push_chunks(self, oid: str, shard_data: Dict[int, bytes],
                    size: int, on_done: Callable[[], None],
                    version: int = 0,
                    xattrs: Optional[Dict[str, bytes]] = None,
                    targets: Optional[Dict[int, int]] = None) -> int:
        """Recovery push: whole-shard writes to specific shards only
        (RecoveryOp pushes, ECBackend.cc:535-743).  is_push: the
        replica's log already carries the entries (activation), but the
        object's version attr must be stamped so staleness checks see
        current data.  ``xattrs`` restores the object's user attrs on
        the rebuilt shard (the reference pushes attrs with the chunks).
        ``targets`` overrides the shard->osd destinations (realign
        pushes go to UP members that are not acting yet)."""
        tid = self.next_tid()
        wr = InflightWrite(tid=tid, oid=oid, client_reply=lambda _r: None,
                           on_all_commit=on_done)
        acting = targets if targets is not None \
            else self.pg.acting_shards()
        for shard, chunk in shard_data.items():
            if shard not in acting:
                continue
            msg = MOSDECSubOpWrite(
                tid=tid, pgid=self.pg.pgid, shard=shard, oid=oid,
                chunk=chunk, offset=0, partial=False, at_version=size,
                version=version, is_push=True, xattrs=xattrs)
            wr.pending_shards.add(shard)
            wr.sent_msgs[shard] = (acting[shard], msg)
            self.pg.send_to_osd(acting[shard], msg)
        if not wr.pending_shards:
            on_done()
            return tid
        wr.last_send = self.pg.osd.now
        self.inflight_writes[tid] = wr
        return tid

    def read_chunks(self, oid: str,
                    on_done: Callable[
                        [int, Dict[int, bytes], int, Dict[str, bytes]],
                        None]) -> int:
        """Recovery read: raw chunks from the cheapest healthy shard set
        (no decode) — on_done(result, {shard: bytes}, logical_size,
        user_attrs)."""
        return self._start_read(oid, 0, 0, False, on_done, raw=True)

    def repair_read(self, oid: str, lost: int,
                    plan: Dict[int, List[Tuple[int, int]]],
                    on_done: Callable[
                        [int, Dict[int, bytes], int, Dict[str, bytes]],
                        None]) -> int:
        """Sub-chunk repair round (docs/RECOVERY.md): fan a
        repair-contribution read to each helper shard in *plan* (the
        codec's ``minimum_to_decode({lost}, avail)`` answer).  Helpers
        reply with their computed β-sub-chunk contribution instead of
        the whole chunk; ``on_done(result, {helper: contribution},
        logical_size, user_attrs)``.  ANY failed helper fails the round
        (result -5) with no reconstruction retry — the recovery
        orchestrator then falls back to the full-stripe decode path."""
        tid = self.next_tid()
        acting = self.pg.acting_shards()
        rd = InflightRead(tid=tid, oid=oid, on_done=on_done, raw=True,
                          repair_for=lost, ledger=g_oplat.current())
        cur_trace = g_tracer.current_trace_id() if g_tracer.enabled else 0
        cur_span = g_tracer.current_span_id() if g_tracer.enabled else 0
        for shard, subs in plan.items():
            osd = acting.get(shard)
            if osd is None:
                on_done(-5, {}, -1, {})
                return tid
            msg = MOSDECSubOpRead(tid=tid, pgid=self.pg.pgid,
                                  shard=shard, oid=oid,
                                  subchunks=list(subs),
                                  repair_for=lost,
                                  trace_id=cur_trace,
                                  parent_span_id=cur_span)
            rd.pending.add(shard)
            self.pg.send_to_osd(osd, msg)
        if rd.ledger is not None:
            rd.ledger.mark("fan_out")
        self.inflight_reads[tid] = rd
        return tid

    def handle_sub_write(self, msg: MOSDECSubOpWrite, store: MemStore,
                         pg=None) -> MOSDECSubOpWriteReply:
        """Shard-side apply (ECBackend.cc:921-983): one transaction with
        chunk data, size attr, the updated HashInfo, and — for versioned
        client writes — the pg_log entry (the reference appends the log
        entry in the same transaction as the data).

        Full writes replace the shard; partial (rmw) writes splice the
        chunk range and recompute the shard crc over the spliced body —
        the reference similarly rewrites hinfo on overwrite
        (ECTransaction.cc generate_transactions hinfo updates).
        """
        cid = f"{msg.pgid[0]}.{msg.pgid[1]}s{msg.shard}"
        ho = hobject_t(msg.oid, msg.shard)
        if msg.version and not msg.is_push and \
                store.collection_exists(cid) and store.exists(cid, ho):
            # resend dedup: the stored version already covers this
            # message — the original apply succeeded and only the ack
            # was lost.  Re-applying would overwrite the rollback stash
            # with POST-write state and duplicate the log entry, so
            # just re-ack (the reference dedups via the pg log's
            # already-applied check in do_request)
            from .pg_log import VERSION_ATTR
            vb = store.getattrs(cid, ho).get(VERSION_ATTR)
            if vb is not None and \
                    struct.unpack("<Q", vb)[0] >= msg.version:
                return MOSDECSubOpWriteReply(tid=msg.tid, pgid=msg.pgid,
                                             shard=msg.shard,
                                             committed=True)
        t = Transaction()
        if not store.collection_exists(cid):
            t.create_collection(cid)
        if pg is not None and msg.version and not msg.is_push:
            stash_pre_write_state(t, store, pg, msg.oid, cid, ho,
                                  msg.version)
        if msg.attr_only:
            # metadata-only mutation: replace user attrs, stamp version,
            # log — leave body/size/hinfo untouched.  A touch that
            # CREATES the object must stamp a zero size so reads/stat
            # see a consistent (empty) object, not a corrupt one.
            t.touch(cid, ho)
            if not (store.collection_exists(cid) and store.exists(cid, ho)):
                t.setattr(cid, ho, SIZE_ATTR, struct.pack("<Q", 0))
            self._apply_user_attrs(t, store, cid, ho, msg.xattrs)
            if msg.version:
                from .pg_log import VERSION_ATTR
                t.setattr(cid, ho, VERSION_ATTR,
                          struct.pack("<Q", msg.version))
            if pg is not None and msg.version and not msg.is_push:
                from .pg_log import LogEntry, OP_MODIFY
                pg.append_log(LogEntry(msg.version, msg.oid, OP_MODIFY), t)
            store.queue_transaction(t)
            return MOSDECSubOpWriteReply(tid=msg.tid, pgid=msg.pgid,
                                         shard=msg.shard, committed=True)
        if not msg.partial and isinstance(msg.chunk, DeviceShard):
            # zero-copy store: the device handle becomes the shard
            # body and the fused encode kernel's crc IS the HashInfo
            # digest — no host bytes move, nothing is hashed on host
            t.write_shard(cid, ho, msg.chunk)
            hinfo = struct.pack("<QI", msg.chunk.length, msg.chunk.crc)
            memstore_device_perf_counters().inc(l_msd_crc_device)
        else:
            if not msg.partial:
                t.truncate(cid, ho, 0)
                t.write(cid, ho, 0, msg.chunk)
                body = msg.chunk
            else:
                existing = store.read(cid, ho) \
                    if store.collection_exists(cid) and \
                    store.exists(cid, ho) else b""
                spliced = bytearray(max(len(existing),
                                        msg.offset + len(msg.chunk)))
                spliced[:len(existing)] = existing
                spliced[msg.offset:msg.offset + len(msg.chunk)] = \
                    msg.chunk
                t.truncate(cid, ho, 0)
                t.write(cid, ho, 0, bytes(spliced))
                body = bytes(spliced)
            hi = HashInfo(1)
            hi.append(0, {0: np.frombuffer(body, dtype=np.uint8)})
            hinfo = struct.pack("<QI", hi.total_chunk_size,
                                hi.get_chunk_hash(0))
            memstore_device_perf_counters().inc(l_msd_crc_host)
        t.setattr(cid, ho, SIZE_ATTR, struct.pack("<Q", msg.at_version))
        self._apply_user_attrs(t, store, cid, ho, msg.xattrs)
        t.setattr(cid, ho, HINFO_ATTR, hinfo)
        if msg.version:
            from .pg_log import VERSION_ATTR
            t.setattr(cid, ho, VERSION_ATTR,
                      struct.pack("<Q", msg.version))
        if pg is not None and msg.version and not msg.is_push:
            from .pg_log import LogEntry, OP_MODIFY
            pg.append_log(LogEntry(msg.version, msg.oid, OP_MODIFY), t)
        if pg is not None and msg.snapset_update is not None:
            pg.apply_snapset_update(tuple(msg.snapset_update), t)
        store.queue_transaction(t)
        if pg is not None and not msg.partial:
            pg.data_received(msg.oid)
        return MOSDECSubOpWriteReply(tid=msg.tid, pgid=msg.pgid,
                                     shard=msg.shard, committed=True)

    @staticmethod
    def _apply_user_attrs(t: Transaction, store: MemStore, cid: str, ho,
                          xattrs: Optional[Dict[str, bytes]]) -> None:
        """Full-replacement user-attr application: drop every existing
        ``_u_*`` attr, set the new set.  None = leave attrs alone."""
        if xattrs is None:
            return
        existing = {}
        if store.collection_exists(cid) and store.exists(cid, ho):
            existing = store.getattrs(cid, ho)
        for k in existing:
            if k.startswith(USER_ATTR_PREFIX):
                t.rmattr(cid, ho, k)
        for name, value in xattrs.items():
            t.setattr(cid, ho, USER_ATTR_PREFIX + name, bytes(value))

    def handle_sub_write_reply(self, msg: MOSDECSubOpWriteReply) -> None:
        wr = self.inflight_writes.get(msg.tid)
        if wr is None:
            return
        wr.pending_shards.discard(msg.shard)
        wr.sent_msgs.pop(msg.shard, None)
        if not wr.pending_shards:
            del self.inflight_writes[msg.tid]
            if wr.ledger is not None:
                # the LAST shard ack closes the gather stage; the
                # reply mark (osd.send_op_reply) is the next boundary
                wr.ledger.mark("ack_gather")
            if wr.on_all_commit is not None:
                wr.on_all_commit()
            else:
                wr.client_reply(0)

    def sweep_inflight(self, now: Optional[float] = None,
                       idle: bool = False) -> int:
        """Resend unacked sub-op writes (the reference's messenger
        retries at the Connection layer; this fabric needs an explicit
        timer).  Two drivers: the OSD tick (``now`` = cluster clock,
        resend after ``ec_subwrite_retry_timeout``) and the
        deterministic fabric's idle kick (``idle=True`` — quiescence
        means the message or its ack is provably lost, resend now).
        Bounded by ``ec_subwrite_retry_max`` per write so a down shard
        cannot spin the fabric; past the cap the write waits for
        peering's on_change, exactly as before the timer existed.
        Returns the number of messages resent."""
        timeout = float(g_conf.get_val("ec_subwrite_retry_timeout"))
        if timeout <= 0:
            return 0
        max_resend = int(g_conf.get_val("ec_subwrite_retry_max"))
        pc = pipeline_perf_counters()
        sent = 0
        for wr in list(self.inflight_writes.values()):
            if not wr.pending_shards or wr.resends >= max_resend:
                continue
            if idle:
                # the idle kick re-fires every time the fabric drains,
                # so an unreachable (down/blackholed) target would burn
                # the whole budget inside ONE pump and leave nothing
                # for the paced tick retries after the outage heals —
                # cap idle-driven rounds at two (enough for a dropped
                # send AND a dropped resend)
                if wr.resends >= min(2, max_resend):
                    continue
            elif now is None or now - wr.last_send < timeout:
                continue
            wr.resends += 1
            wr.last_send = self.pg.osd.now if now is None else now
            for shard in sorted(wr.pending_shards):
                ent = wr.sent_msgs.get(shard)
                if ent is None:
                    continue
                osd, msg = ent
                pc.inc(l_pipeline_subwrite_resends)
                g_tracer.event("subwrite_resend", shard=shard,
                               oid=wr.oid, tid=wr.tid,
                               attempt=wr.resends)
                self.pg.send_to_osd(osd, msg)
                sent += 1
        return sent

    # ---- read path (primary) ---------------------------------------------
    def objects_read_and_reconstruct(
            self, oid: str, on_complete: Callable[[int, bytes], None],
            offset: int = 0, length: int = 0) -> int:
        """Client-facing (ranged) read: decode the covering chunk range,
        slice, trim to logical size (ECBackend.cc:1580-1669).  Codecs
        without a systematic layout (regenerating codes) fetch whole
        shards regardless of range — the decoded object is sliced
        logically instead."""
        whole = getattr(self.ec_impl, "requires_whole_object_rw", False)
        if length == 0 or whole:
            c0, c1 = 0, 0
        else:
            a0 = self.sinfo.logical_to_prev_stripe_offset(offset)
            a1 = self.sinfo.logical_to_next_stripe_offset(offset + length)
            c0 = self.sinfo.aligned_logical_offset_to_chunk_offset(a0)
            c1 = self.sinfo.aligned_logical_offset_to_chunk_offset(a1)

        def done(result: int, data: bytes, size: int, _attrs) -> None:
            if result != 0:
                on_complete(result, b"")
                return
            if length == 0:
                body = data[:size] if size >= 0 else data
                on_complete(0, body[offset:])
                return
            a0 = 0 if whole else \
                self.sinfo.logical_to_prev_stripe_offset(offset)
            end = min(offset + length, size) if size >= 0 \
                else offset + length
            if end <= offset:
                on_complete(0, b"")
                return
            on_complete(0, data[offset - a0:end - a0])

        return self._start_read(oid, c0, max(0, c1 - c0), False, done)

    def object_state(self, oid: str,
                     on_done: Callable[
                         [int, bytes, int, Dict[str, bytes]], None]) -> int:
        """Whole-object fetch for the op interpreter: on_done(result,
        logical_bytes, size, user_attrs); result -2 = object absent."""

        def done(result: int, data: bytes, size: int,
                 attrs: Dict[str, bytes]) -> None:
            if result != 0:
                on_done(result, b"", 0, {})
                return
            body = data[:size] if size >= 0 else data
            on_done(0, body, max(size, 0), attrs)

        return self._start_read(oid, 0, 0, False, done)

    def _start_read(self, oid: str, chunk_off: int, chunk_len: int,
                    attrs_only: bool,
                    on_done: Callable[[int, bytes, int], None],
                    raw: bool = False) -> int:
        """Fan MOSDECSubOpRead for a chunk range to the cheapest shard
        set.  Shards the primary knows are missing this object are
        excluded up front (degraded-read gating)."""
        tid = self.next_tid()
        acting = self.pg.acting_shards()
        avail = set(acting) - self.pg.missing_shards_for(oid)
        rd = InflightRead(tid=tid, oid=oid, on_done=on_done,
                          chunk_off=chunk_off, chunk_len=chunk_len,
                          attrs_only=attrs_only, raw=raw,
                          ledger=g_oplat.current())
        cur_trace = g_tracer.current_trace_id() if g_tracer.enabled else 0
        cur_span = g_tracer.current_span_id() if g_tracer.enabled else 0
        if attrs_only:
            # any single healthy shard knows the size attr
            if not avail:
                on_done(-5, b"", -1, {})
                return tid
            shard = min(avail)
            rd.pending.add(shard)
            self.inflight_reads[tid] = rd
            self.pg.send_to_osd(acting[shard], MOSDECSubOpRead(
                tid=tid, pgid=self.pg.pgid, shard=shard, oid=oid,
                attrs_only=True, trace_id=cur_trace,
                parent_span_id=cur_span))
            if rd.ledger is not None:
                rd.ledger.mark("fan_out")
            return tid
        # want the *physical* positions of the data chunks (chunk_mapping
        # remaps logical->physical for lrc/shec layouts)
        want = {self.ec_impl.chunk_index(i) for i in range(self.k)}
        try:
            minimum = self.ec_impl.minimum_to_decode(want, avail)
        except IOError:
            on_done(-5, b"", -1, {})  # EIO: not enough shards
            return tid
        for shard in minimum:
            msg = MOSDECSubOpRead(tid=tid, pgid=self.pg.pgid, shard=shard,
                                  oid=oid, offset=chunk_off,
                                  length=chunk_len,
                                  subchunks=list(minimum[shard]),
                                  trace_id=cur_trace,
                                  parent_span_id=cur_span)
            rd.pending.add(shard)
            self.pg.send_to_osd(acting[shard], msg)
        if rd.ledger is not None:
            # a read round is a fan-out too: the sub-read sends close
            # the stage; the last reply closes ack_gather
            rd.ledger.mark("fan_out")
        self.inflight_reads[tid] = rd
        return tid

    def handle_sub_read(self, msg: MOSDECSubOpRead, store: MemStore
                        ) -> MOSDECSubOpReadReply:
        """Shard-side read + crc check (ECBackend.cc:986-1066).

        The crc always covers the whole stored shard (hinfo is cumulative,
        ECUtil.cc:161-207), so ranged reads verify the full body before
        slicing out [offset, offset+length)."""
        cid = f"{msg.pgid[0]}.{msg.pgid[1]}s{msg.shard}"
        ho = hobject_t(msg.oid, msg.shard)
        if g_faults.site_armed("osd.shard_read_eio") and \
                g_faults.should_fire(
                    "osd.shard_read_eio",
                    ctx=f"{cid}:{msg.oid}:shard{msg.shard}"):
            # injected media error (bluestore_debug_inject_read_err
            # role): fail THIS shard's read; the primary's reply
            # handler reconstructs from the surviving shards
            fault_perf_counters().inc(l_fault_eio_injected)
            return MOSDECSubOpReadReply(tid=msg.tid, pgid=msg.pgid,
                                        shard=msg.shard, oid=msg.oid,
                                        result=-5)
        if not store.collection_exists(cid) or not store.exists(cid, ho):
            return MOSDECSubOpReadReply(tid=msg.tid, pgid=msg.pgid,
                                        shard=msg.shard, oid=msg.oid,
                                        result=-2)  # ENOENT
        data = store.read_shard(cid, ho)
        attrs = store.getattrs(cid, ho)
        hv = attrs.get(HINFO_ATTR)
        if hv is not None:
            total, expect = struct.unpack("<QI", hv)
            if total == len(data) and self._shard_crc(data) != expect:
                # bit rot: fail the shard read so the primary reconstructs
                return MOSDECSubOpReadReply(tid=msg.tid, pgid=msg.pgid,
                                            shard=msg.shard, oid=msg.oid,
                                            result=-5)
        if msg.repair_for >= 0:
            if isinstance(data, DeviceShard):
                # repair math is host-side numpy: fetch the body
                data = data.materialize()
            # sub-chunk repair helper (docs/RECOVERY.md): compute this
            # shard's β-sub-chunk contribution toward rebuilding shard
            # ``repair_for`` instead of shipping the whole chunk.  The
            # chaos site drops helper fetches so the orchestrator's
            # full-stripe fallback is a tested path, not a hope.
            if g_faults.site_armed("recovery.helper_fetch") and \
                    g_faults.should_fire(
                        "recovery.helper_fetch",
                        ctx=f"{cid}:{msg.oid}:shard{msg.shard}"):
                fault_perf_counters().inc(l_fault_eio_injected)
                return MOSDECSubOpReadReply(tid=msg.tid, pgid=msg.pgid,
                                            shard=msg.shard,
                                            oid=msg.oid, result=-5)
            contribute = getattr(self.ec_impl, "repair_contribution",
                                 None)
            C = self.sinfo.get_chunk_size()
            if contribute is None or not data or len(data) % C:
                # codec can't help (or torn shard): the orchestrator
                # falls back to the full-stripe decode path
                return MOSDECSubOpReadReply(tid=msg.tid, pgid=msg.pgid,
                                            shard=msg.shard,
                                            oid=msg.oid, result=-5)
            body = np.frombuffer(data, dtype=np.uint8).reshape(-1, C)
            contrib = contribute(msg.shard, msg.repair_for, body)
            return MOSDECSubOpReadReply(tid=msg.tid, pgid=msg.pgid,
                                        shard=msg.shard, oid=msg.oid,
                                        data=contrib.tobytes(),
                                        attrs=attrs, result=0)
        if msg.attrs_only:
            data = b""
        elif msg.offset or msg.length:
            if isinstance(data, DeviceShard):
                data = data.materialize()
            end = msg.offset + msg.length if msg.length else len(data)
            data = data[msg.offset:end]
        # a full-body read of a resident shard replies with the HANDLE:
        # on the in-process fabric the body stays in HBM until the
        # primary (or its client) actually touches bytes
        return MOSDECSubOpReadReply(tid=msg.tid, pgid=msg.pgid,
                                    shard=msg.shard, oid=msg.oid,
                                    data=data, attrs=attrs, result=0)

    @staticmethod
    def _shard_crc(data) -> int:
        """crc32c of a stored body in whichever representation it has:
        a still-resident shard verifies on the card (K4,
        ops/crc32c_device, bit-identical to the host crc — the only d2h
        is the 4-byte scalar); host bytes verify through the classic
        path."""
        if isinstance(data, DeviceShard):
            dev = data.device_array()
            if dev is not None:
                from ..ops.crc32c_device import crc32c_of_device_array
                memstore_device_perf_counters().inc(l_msd_crc_device)
                return crc32c_of_device_array(dev)
            data = data.materialize()
        memstore_device_perf_counters().inc(l_msd_crc_host)
        return crc32c(data)

    def handle_sub_read_reply(self, msg: MOSDECSubOpReadReply) -> None:
        """Collect shard replies; reconstruct on completion
        (ECBackend.cc:1141-1281)."""
        rd = self.inflight_reads.get(msg.tid)
        if rd is None:
            return
        rd.pending.discard(msg.shard)
        rd.seen += 1
        if rd.repair_for >= 0:
            # sub-chunk repair round: collect contributions; any
            # failure fails the round (the orchestrator falls back to
            # full-stripe decode — no reconstruction retry here)
            if msg.result == 0:
                rd.chunks[msg.shard] = msg.data
                sz = msg.attrs.get(SIZE_ATTR)
                if sz is not None:
                    rd.size = struct.unpack("<Q", sz)[0]
                if not rd.user_attrs:
                    rd.user_attrs = user_attrs_of(msg.attrs)
            else:
                rd.failed.add(msg.shard)
            if rd.pending:
                return
            del self.inflight_reads[msg.tid]
            if rd.ledger is not None:
                rd.ledger.mark("ack_gather")
            if rd.failed:
                rd.on_done(-5, {}, rd.size, rd.user_attrs)
            else:
                rd.on_done(0, dict(rd.chunks), rd.size, rd.user_attrs)
            return
        if msg.result == 0:
            rd.chunks[msg.shard] = msg.data
            sz = msg.attrs.get(SIZE_ATTR)
            if sz is not None:
                rd.size = struct.unpack("<Q", sz)[0]
            if not rd.user_attrs:
                rd.user_attrs = user_attrs_of(msg.attrs)
        else:
            rd.failed.add(msg.shard)
            if msg.result != -2:
                rd.saw_eio = True
                g_tracer.event("shard_read_eio", shard=msg.shard,
                               oid=rd.oid, result=msg.result)
            # retry with reconstruction from any other healthy shards
            acting = self.pg.acting_shards()
            others = (set(acting) - set(rd.chunks) - rd.failed
                      - rd.pending - self.pg.missing_shards_for(rd.oid))
            for shard in others:
                m2 = MOSDECSubOpRead(tid=rd.tid, pgid=self.pg.pgid,
                                     shard=shard, oid=rd.oid,
                                     offset=rd.chunk_off,
                                     length=rd.chunk_len,
                                     attrs_only=rd.attrs_only)
                rd.pending.add(shard)
                self.pg.send_to_osd(acting[shard], m2)
        if rd.pending:
            return
        del self.inflight_reads[msg.tid]
        if rd.ledger is not None:
            rd.ledger.mark("ack_gather")
        if rd.attrs_only:
            if rd.size >= 0:
                rd.on_done(0, b"", rd.size, rd.user_attrs)
            elif rd.failed and not rd.chunks and not rd.saw_eio:
                # every shard answered a clean ENOENT: object absent
                rd.on_done(-2, b"", 0, {})
            else:
                # crc/EIO failures must surface as EIO, never ENOENT —
                # a corrupt object is not an absent one
                rd.on_done(-5, b"", -1, {})
            return
        if not rd.chunks and rd.failed and not rd.saw_eio:
            # all shards report a clean no-such-object
            rd.on_done(-2, b"", 0, {}) if not rd.raw else \
                rd.on_done(-2, {}, 0, {})
            return
        if len(rd.chunks) < self.k:
            rd.on_done(-5, b"" if not rd.raw else {}, rd.size,
                       rd.user_attrs)
            return
        if rd.saw_eio:
            # the op was served despite >=1 failed shard: EC
            # reconstruction from survivors did its job (the graceful-
            # degradation contract for injected/real media errors)
            fault_perf_counters().inc(l_fault_eio_reconstructs)
        if rd.raw:
            # raw consumers (recovery, realign) slice and splice on
            # host — hand them bytes, not handles
            rd.on_done(0, {i: (b.materialize()
                               if isinstance(b, DeviceShard) else b)
                           for i, b in rd.chunks.items()},
                       rd.size, rd.user_attrs)
            return
        arrays = {i: np.frombuffer(b.materialize()
                                   if isinstance(b, DeviceShard) else b,
                                   dtype=np.uint8)
                  for i, b in rd.chunks.items()}
        try:
            # the decode runs from the sub-read-reply dispatch context:
            # re-anchor the op's ledger so its device stages attribute
            # to the read that needed them
            with g_oplat.activate(rd.ledger):
                data = self._decode_timed(
                    sum(len(b) for b in rd.chunks.values()),
                    g_dispatcher.decode_concat, self.sinfo, self.ec_impl,
                    arrays)
        except IOError:
            rd.on_done(-5, b"", rd.size, rd.user_attrs)
            return
        rd.on_done(0, data.tobytes(), rd.size, rd.user_attrs)

    # ---- recovery (ECBackend.cc:535-743) ----------------------------------
    def recover_object(self, oid: str, missing_shards: Set[int],
                       source_chunks: Dict[int, bytes],
                       logical_size: int) -> Dict[int, bytes]:
        """Decode the missing shards' chunks from k sources."""
        arrays = {i: np.frombuffer(b.materialize()
                                   if isinstance(b, DeviceShard) else b,
                                   dtype=np.uint8)
                  for i, b in source_chunks.items()}
        rec = self._decode_timed(
            sum(len(b) for b in source_chunks.values()),
            g_dispatcher.decode, self.sinfo, self.ec_impl, arrays,
            sorted(missing_shards))
        return {i: rec[i].tobytes() for i in rec}
