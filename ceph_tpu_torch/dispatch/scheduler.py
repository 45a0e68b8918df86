"""DeviceDispatcher — the cross-PG dynamic-batching device scheduler.

Port of ``ceph_tpu/dispatch/scheduler.py``.  Under heavy traffic an OSD
process sees many *concurrent* small EC ops across PGs, each paying a
full device dispatch — the per-call overhead regime of the batched-XOR
literature (arxiv 2108.02692), one level above the reference's
per-stripe loop (osd/ECUtil.cc:120-159).  This scheduler coalesces those
ops: requests queue per codec signature + chunk-size bucket
(signature.py), flush on a size trigger (``ec_dispatch_batch_max``), an
age trigger (``ec_dispatch_batch_window_us``), an explicit ``flush()``,
or a submitter demanding its result — the window is a collection
opportunity, never a latency floor, so ``window=0`` (the default) is an
exact passthrough to the uncoalesced path and any synchronous caller
gets the uncoalesced behavior byte-for-byte.  On ``backend=cuda`` a
coalesced flush is one ``encode_batch`` / ``decode_batch``: one launch
of the GF(2^8) bit-matmul kernel for every request in it.

Backpressure: a bounded total queue (``ec_dispatch_queue_max``)
force-flushes everything when full, so memory is bounded by config and
a stalled consumer cannot pile up unresolved futures.

Request isolation: a batched call that throws is re-run per request on
the same device (the JAX package's isolation, not a CPU route); each
request's future then carries its own result or its own error, and the
re-runs are counted (``batch_fallbacks``, ``dispatch_fallback``,
``request_errors``).

Observability: a ``batch_dispatch`` span whose children are the
coalesced requests, a batch-occupancy PerfHistogram, ``dump()`` (the
admin socket's ``dispatch dump``) and the ``dispatch`` perf counters.
All host-side: with tracing disabled the dispatcher adds no device
synchronisation per op.  ``_execute`` runs outside the queue lock, from
whichever submitter thread flushes, so several threads may launch at
once: the codec's lazy backend, the build and the launch counters take
their own locks.
"""
from __future__ import annotations

import copy
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..common.config import g_conf
from ..common.lockdep import DebugLock, DebugRLock
from ..common.perf_counters import PerfCounters, PerfCountersBuilder
from ..fault import g_faults
from ..trace import (g_devprof, g_oplat, g_perf_histograms, g_tracer,
                     occupancy_axes)
from ..trace.oplat import OpLedger
from .batch import Request, run_group, run_one
from .future import DispatchFuture
from .signature import (KIND_DECODE, KIND_DECODE_CONCAT, KIND_ENCODE,
                        batchable, bucket_chunk_size, codec_signature,
                        stripe_block_of)

# ``dump()["mesh"]``: the JAX package's ``g_mesh.dump()`` with
# ``ec_mesh_chips=0`` (its mesh off), as a constant until the port has
# its mesh modules
MESH_OFF_DUMP = {
    "options": {"ec_mesh_chips": 0, "ec_mesh_pool_buffers": 4,
                "ec_mesh_donate": True},
    "active": False, "size": 0, "axis": "batch", "per_chip": {},
    "plans": [],
    "pool": {"shapes": {}, "hits": 0, "misses": 0, "per_shape": 4},
    "counters": {"dispatches": 0, "reqs": 0, "stripes": 0,
                 "pad_stripes": 0, "bytes": 0, "plan_builds": 0,
                 "plan_hits": 0, "pool_hits": 0, "pool_misses": 0,
                 "fallbacks": 0, "chips": 0},
    "decode": {"inflight": 0,
               "counters": {"dispatches": 0, "stripes": 0,
                            "pad_stripes": 0, "bytes": 0,
                            "plan_builds": 0, "plan_hits": 0,
                            "fallbacks": 0, "repair_solves": 0,
                            "col_folds": 0, "inflight": 0}},
    "membership": {"transitions": 0, "hold": False,
                   "counters": {"transitions": 0, "chip_adds": 0,
                                "chip_retires": 0, "drained_reqs": 0,
                                "plans_dropped": 0, "pool_dropped": 0,
                                "suspect_retires": 0, "target_chips": 0}},
    "rateless": {"options": {"ec_mesh_rateless": False,
                             "ec_mesh_rateless_tasks": 0},
                 "counters": {"flushes": 0, "coded_tasks": 0,
                              "parity_tasks": 0, "wasted_blocks": 0,
                              "subset_completions": 0, "host_resolves": 0,
                              "suspect_deweights": 0, "chip_failures": 0,
                              "insufficient": 0}},
    "skew": {"options": {"ec_mesh_skew_sample_every": 16,
                         "ec_mesh_skew_threshold": 3.0},
             "sustain_probes": 3, "clear_probes": 3, "flushes": 0,
             "probes": 0, "per_chip": {}, "suspects": []},
}

# ---- perf counters ---------------------------------------------------------
DISPATCH_FIRST = 91000
l_dispatch_submitted = 91001      # requests submitted
l_dispatch_passthrough = 91002    # executed inline (window 0 / unbatchable)
l_dispatch_batches = 91003        # coalesced device flushes
l_dispatch_batched_reqs = 91004   # requests through coalesced flushes
l_dispatch_coalesced = 91005      # requests that shared a flush with >=1 mate
l_dispatch_fallbacks = 91006      # batched calls that fell back per-request
l_dispatch_errors = 91007         # requests that resolved with an error
l_dispatch_backpressure = 91008   # forced flushes from a full queue
l_dispatch_stripes = 91009        # stripes through the dispatcher
l_dispatch_bytes = 91010          # payload bytes through the dispatcher
l_dispatch_flush_time = 91011     # time inside flush execution
l_dispatch_fallback_reqs = 91012  # requests re-run alone after a
                                  # batched call fell back
DISPATCH_LAST = 91020

_dispatch_pc: Optional[PerfCounters] = None
_dispatch_pc_lock = DebugLock("dispatch_pc::init")


def dispatch_perf_counters() -> PerfCounters:
    """The dispatcher's counter logger (perf dump / Prometheus)."""
    global _dispatch_pc
    if _dispatch_pc is not None:
        return _dispatch_pc
    with _dispatch_pc_lock:
        if _dispatch_pc is None:
            b = PerfCountersBuilder("dispatch", DISPATCH_FIRST,
                                    DISPATCH_LAST)
            b.add_u64_counter(l_dispatch_submitted, "submitted",
                              "codec requests submitted")
            b.add_u64_counter(l_dispatch_passthrough, "passthrough",
                              "requests executed inline (window 0 or "
                              "unbatchable codec)")
            b.add_u64_counter(l_dispatch_batches, "batches",
                              "coalesced device flushes")
            b.add_u64_counter(l_dispatch_batched_reqs, "batched_reqs",
                              "requests through coalesced flushes")
            b.add_u64_counter(l_dispatch_coalesced, "coalesced_reqs",
                              "requests that shared a flush with a "
                              "batchmate")
            b.add_u64_counter(l_dispatch_fallbacks, "batch_fallbacks",
                              "batched calls that fell back to "
                              "per-request")
            b.add_u64_counter(l_dispatch_errors, "request_errors",
                              "requests resolved with an error")
            b.add_u64_counter(l_dispatch_backpressure,
                              "backpressure_flushes",
                              "forced flushes from a full queue")
            b.add_u64_counter(l_dispatch_stripes, "stripes",
                              "stripes through the dispatcher")
            b.add_u64_counter(l_dispatch_bytes, "bytes",
                              "payload bytes through the dispatcher")
            b.add_u64_counter(l_dispatch_fallback_reqs,
                              "dispatch_fallback",
                              "requests re-executed alone after their "
                              "batched call fell back")
            b.add_time_avg(l_dispatch_flush_time, "flush",
                           "time inside flush execution")
            _dispatch_pc = b.create_perf_counters()
    return _dispatch_pc


class _Queue:
    """Pending requests of one (kind, signature, bucket[, erasure])."""

    __slots__ = ("key", "reqs", "deadline", "bucket_c")

    def __init__(self, key, bucket_c: int, deadline: float):
        self.key = key
        self.reqs: List[Request] = []
        self.deadline = deadline
        self.bucket_c = bucket_c


class DeviceDispatcher:
    def __init__(self):
        self._lock = DebugRLock("DeviceDispatcher::lock")
        self._queues: "OrderedDict[Tuple, _Queue]" = OrderedDict()
        self._pending = 0

    # ---- options (read live so `config set` applies without restart) ------
    @staticmethod
    def _opts() -> Tuple[int, int, int]:
        return (int(g_conf.get_val("ec_dispatch_batch_max")),
                int(g_conf.get_val("ec_dispatch_batch_window_us")),
                int(g_conf.get_val("ec_dispatch_queue_max")))

    @property
    def _hist(self):
        return g_perf_histograms.get(
            "dispatch", "dispatch_batch_occupancy_histogram",
            occupancy_axes)

    # ---- synchronous entry points (the ECBackend funnel) -------------------
    # On the default window=0 these skip future/lambda construction
    # entirely: the hot write path pays one Request object and the same
    # ecutil call it always made, nothing else.
    def encode(self, sinfo, ec_impl, data, want) -> Dict[int, np.ndarray]:
        req = Request(KIND_ENCODE, sinfo, ec_impl, payload=data,
                      want=want)
        if not self._queueable(req):
            return self._run_inline(req)
        return self._submit(req).result()

    def decode_concat(self, sinfo, ec_impl, chunks) -> np.ndarray:
        req = Request(KIND_DECODE_CONCAT, sinfo, ec_impl,
                      chunks=dict(chunks))
        if not self._queueable(req):
            return self._run_inline(req)
        return self._submit(req).result()

    def decode(self, sinfo, ec_impl, chunks, need) -> Dict[int, np.ndarray]:
        req = Request(KIND_DECODE, sinfo, ec_impl, chunks=dict(chunks),
                      need=need)
        if not self._queueable(req):
            return self._run_inline(req)
        return self._submit(req).result()

    # ---- async entry points ------------------------------------------------
    def submit_encode(self, sinfo, ec_impl, data, want) -> DispatchFuture:
        return self._submit(Request(KIND_ENCODE, sinfo, ec_impl,
                                    payload=data, want=want))

    def submit_decode_concat(self, sinfo, ec_impl,
                             chunks) -> DispatchFuture:
        return self._submit(Request(KIND_DECODE_CONCAT, sinfo, ec_impl,
                                    chunks=dict(chunks)))

    def submit_decode(self, sinfo, ec_impl, chunks,
                      need) -> DispatchFuture:
        return self._submit(Request(KIND_DECODE, sinfo, ec_impl,
                                    chunks=dict(chunks), need=need))

    # ---- core --------------------------------------------------------------
    def _queueable(self, req: Request) -> bool:
        _batch_max, window_us, _queue_max = self._opts()
        return (window_us > 0 and req.n_stripes > 0
                and batchable(req.ec_impl, req.chunk_size, req.kind))

    def _account(self, req: Request) -> PerfCounters:
        pc = dispatch_perf_counters()
        pc.inc(l_dispatch_submitted)
        pc.inc(l_dispatch_bytes, req.nbytes)
        pc.inc(l_dispatch_stripes, req.n_stripes)
        return pc

    @staticmethod
    def _req_ledger(req: Request) -> OpLedger:
        """The stage ledger this request's device stages land on: the
        submitting op's (contextvar, like the span capture) or a fresh
        one homed on the ``dispatch`` daemon for op-less submitters
        (bench drivers) — device stages are accounted either way.  An
        op ledger also gets its ``op_service`` boundary stamped here:
        the codec submit ends the op-thread service interval."""
        led = g_oplat.current()
        if led is None:
            led = OpLedger("dispatch")
        else:
            led.mark("op_service")
        req.ledger = led
        return led

    def _run_inline(self, req: Request):
        """Exact passthrough: today's call, inline, no extra spans, no
        future machinery; errors propagate to the caller unchanged."""
        pc = self._account(req)
        pc.inc(l_dispatch_passthrough)
        self._hist.inc(1)
        led = self._req_ledger(req)
        try:
            # no collection window on the passthrough path, so no
            # batch_window stage; ecutil stamps device_call when the
            # codec returns, the d2h mark below closes the fetch
            with g_oplat.activate(led):
                out = run_one(req)
            led.mark("d2h")
            return out
        except Exception:
            pc.inc(l_dispatch_errors)
            raise

    def _submit(self, req: Request) -> DispatchFuture:
        batch_max, window_us, queue_max = self._opts()
        fut = DispatchFuture(flush_fn=lambda: self._force(req))
        req.future = fut
        req.parent_span = g_tracer.current() if g_tracer.enabled else None
        req.trace_id = g_tracer.current_trace_id() if g_tracer.enabled \
            else 0
        pc = self._account(req)
        led = self._req_ledger(req)
        if not self._queueable(req):
            pc.inc(l_dispatch_passthrough)
            self._hist.inc(1)
            try:
                with g_oplat.activate(led):
                    out = run_one(req)
                led.mark("d2h")
                fut.set_result(out)
            except Exception as e:
                pc.inc(l_dispatch_errors)
                fut.set_exception(e)
            return fut
        req.batchable = True
        block = stripe_block_of(req.ec_impl)
        bucket_c = bucket_chunk_size(req.chunk_size, block)
        extra: Tuple = ()
        if req.kind != KIND_ENCODE:
            # the recovery matrix is a function of (survivors, wanted):
            # mixed erasure patterns must not share a matmul
            extra = (tuple(sorted(req.chunks)), tuple(req.need))
        # keyed by the BUCKET, not the exact chunk size: pools whose
        # chunk sizes share a power-of-two bucket coalesce (each request
        # is padded to the bucket width and sliced back to its own)
        req.key = (req.kind, codec_signature(req.ec_impl),
                   bucket_c) + extra
        now = time.monotonic()
        ready: Optional[_Queue] = None
        overflow: List[_Queue] = []
        with self._lock:
            if self._pending >= queue_max:
                pc.inc(l_dispatch_backpressure)
                overflow = list(self._queues.values())
                self._queues.clear()
                self._pending = 0
            q = self._queues.get(req.key)
            if q is None:
                q = _Queue(req.key, bucket_c, now + window_us / 1e6)
                self._queues[req.key] = q
            q.reqs.append(req)
            req.enq_t = now
            self._pending += 1
            if len(q.reqs) >= batch_max:
                ready = self._queues.pop(req.key)
                self._pending -= len(ready.reqs)
        for oq in overflow:
            self._execute(oq.reqs, oq.bucket_c)
        if ready is not None:
            self._execute(ready.reqs, ready.bucket_c)
        else:
            self.poll(now)
        return fut

    def _force(self, req: Request) -> None:
        """A submitter demands its result: flush the owning queue NOW
        (correctness never depends on a timer or on other traffic)."""
        with self._lock:
            q = self._queues.get(req.key) if req.key is not None else None
            if q is None or not any(r is req for r in q.reqs):
                return      # in flight on another thread, or done
            self._queues.pop(req.key)
            self._pending -= len(q.reqs)
        self._execute(q.reqs, q.bucket_c)

    def poll(self, now: Optional[float] = None) -> int:
        """Flush queues whose collection window expired (driven from the
        OSD tick and opportunistically from submit)."""
        if now is None:
            now = time.monotonic()
        expired: List[_Queue] = []
        with self._lock:
            for key in [k for k, q in self._queues.items()
                        if q.deadline <= now]:
                q = self._queues.pop(key)
                self._pending -= len(q.reqs)
                expired.append(q)
        n = 0
        for q in expired:
            n += len(q.reqs)
            self._execute(q.reqs, q.bucket_c)
        return n

    def pending_count(self) -> int:
        """Requests currently queued (cheap probe for idle kickers:
        the mini-cluster fabric flushes on quiescence so pipelined
        submitters never depend on a wall-clock window)."""
        return self._pending

    def flush(self) -> int:
        """Flush everything pending regardless of deadline; returns the
        number of requests executed."""
        with self._lock:
            qs = list(self._queues.values())
            self._queues.clear()
            self._pending = 0
        n = 0
        for q in qs:
            n += len(q.reqs)
            self._execute(q.reqs, q.bucket_c)
        return n

    def _execute(self, reqs: List[Request], bucket_c: int) -> None:
        """Run one coalesced group and resolve every future exactly
        once.  Runs OUTSIDE the queue lock so new submitters keep
        accumulating into fresh queues while the device call is in
        flight — that overlap is where coalescing comes from."""
        if not reqs:
            return
        pc = dispatch_perf_counters()
        t0 = time.perf_counter()
        span = g_tracer.begin("batch_dispatch", daemon="dispatch") \
            if g_tracer.enabled else None
        children = []
        if span is not None:
            span.tags["occupancy"] = len(reqs)
            span.tags["bucket_chunk"] = bucket_c
            for r in reqs:
                ch = g_tracer.begin(
                    f"batched_req:{r.kind}", daemon="dispatch",
                    trace_id=r.trace_id or span.trace_id,
                    parent_id=span.span_id)
                if ch is not None:
                    ch.tags["bytes"] = r.nbytes
                children.append(ch)
        # stage ledger: one flush boundary ends every batched request's
        # batch-window wait (each op in the batch accrues the full
        # window it spent collecting — per-op attribution, docstring of
        # oplat.breakdown_since)
        t_launch = time.perf_counter()
        for r in reqs:
            if r.ledger is not None:
                r.ledger.mark("batch_window", t_launch)
        outcomes: List = []
        with g_tracer.activate(span), g_devprof.stage("dispatch.batch"):
            try:
                if g_faults.site_armed("dispatch.batch"):
                    g_faults.check("dispatch.batch",
                                   ctx=str(reqs[0].key or reqs[0].kind))
                # single-request groups execute via run_one -> ecutil,
                # which stamps device_call on the CURRENT ledger;
                # multi-request groups are stamped inside run_group
                with g_oplat.activate(
                        reqs[0].ledger if len(reqs) == 1 else None):
                    outcomes = [(True, res)
                                for res in run_group(reqs, bucket_c)]
            except Exception as batch_err:   # noqa: BLE001 — isolated
                # fail-fast isolation: re-run each request alone, on the
                # same device, so one bad request cannot poison its
                # batchmates
                pc.inc(l_dispatch_fallbacks)
                if span is not None:
                    span.event("batch_fallback", error=repr(batch_err))
                for r in reqs:
                    pc.inc(l_dispatch_fallback_reqs)
                    if r.parent_span is not None:
                        # surface the degradation on the SUBMITTER's op
                        # span, where slow-op forensics will look
                        r.parent_span.event("dispatch_fallback",
                                            kind=r.kind,
                                            error=repr(batch_err))
                    try:
                        with g_oplat.activate(r.ledger):
                            outcomes.append((True, run_one(r)))
                    except Exception as e:   # noqa: BLE001 — per-req
                        pc.inc(l_dispatch_errors)
                        outcomes.append((False, e))
        t_done = time.perf_counter()
        for r in reqs:
            if r.ledger is not None:
                # outputs are host-materialized by the run: the d2h
                # stage closes each request's device round trip
                r.ledger.mark("d2h", t_done)
        for ch in children:
            g_tracer.finish(ch)
        g_tracer.finish(span)
        # resolve OUTSIDE the execution try: a raising consumer
        # callback must never be mistaken for a device failure and
        # trigger a re-execution of the whole batch
        for r, (ok, val) in zip(reqs, outcomes):
            if ok:
                r.future.set_result(val)
            else:
                r.future.set_exception(val)
        self._hist.inc(len(reqs))
        pc.inc(l_dispatch_batches)
        pc.inc(l_dispatch_batched_reqs, len(reqs))
        if len(reqs) > 1:
            pc.inc(l_dispatch_coalesced, len(reqs))
        pc.tinc(l_dispatch_flush_time, time.perf_counter() - t0)

    # ---- introspection (admin socket `dispatch dump`) ----------------------
    def dump(self) -> Dict:
        batch_max, window_us, queue_max = self._opts()
        now = time.monotonic()
        with self._lock:
            queues = [{
                "kind": q.key[0],
                "signature": list(map(str, q.key[1])),
                "bucket_chunk_size": q.bucket_c,
                "pending": len(q.reqs),
                "age_us": round(max(
                    (now - q.reqs[0].enq_t) * 1e6, 0.0), 1)
                if q.reqs else 0.0,
            } for q in self._queues.values()]
            pending = self._pending
        return {
            "options": {"ec_dispatch_batch_max": batch_max,
                        "ec_dispatch_batch_window_us": window_us,
                        "ec_dispatch_queue_max": queue_max},
            "pending": pending,
            "queues": queues,
            "counters": dispatch_perf_counters().dump(),
            "occupancy_histogram": self._hist.dump(),
            "mesh": copy.deepcopy(MESH_OFF_DUMP),
        }


# process-wide scheduler: one accelerator per process, like g_tracer
# (each reference OSD is its own process; the mini-cluster's daemons
# share one, so one dispatcher coalesces across them the way one chip
# serves them)
g_dispatcher = DeviceDispatcher()
