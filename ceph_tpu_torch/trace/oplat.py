"""Stage-latency ledger — always-on per-stage time attribution for
every op.

Port of ``ceph_tpu/trace/oplat.py``, the same behaviour under the same names.

The device-flow profiler (devprof.py) answers "where did the bytes
go"; this module answers "where did the MICROSECONDS go".  An op's
end-to-end latency decomposes into the handoff boundaries it crosses:

    client submit -> OSD intake -> admission -> mClock class dequeue
    -> client-lane dequeue -> op-thread start -> codec submit ->
    dispatch batch-window expiry -> device call return -> d2h
    materialization -> sub-op fan-out -> last shard ack -> reply

Every boundary stamps a monotonic timestamp on the op's ``OpLedger``;
the interval ending at each stamp is a named STAGE, recorded into a
per-daemon log2 ``PerfHistogram`` family
(``oplat_<stage>_latency_histogram``).  Accounting is pure host-side
counter/timestamp bumps — **zero added device syncs**, mirroring
devprof's discipline (the fence-count test in
tests/test_observability.py enforces it); a mark is one clock read,
one list append, and one histogram increment.

Stage catalog (``STAGES``, canonical write-path order; each name is
the interval that ENDS at that boundary):

- ``client_flight``   client submit -> OSD intake (in-process clock;
                      absent when the op arrived over real TCP)
- ``admission``       intake -> admission-control verdict
- ``class_queue``     queue entry -> the mClock CLASS tier picks this
                      op's class (covers both tiers' queueing)
- ``client_lane``     class pick -> the per-client dmClock lane hands
                      the op over (the lane's own arbitration)
- ``dequeue_handoff`` lane pop -> an op thread starts executing
- ``op_service``      op-thread work up to the codec submit (the
                      write path's "encode enqueue")
- ``batch_window``    dispatch-queue entry -> coalesced flush starts
                      (only exists when a collection window is open)
- ``device_call``     flush start -> the batched device call returns
- ``d2h``             device return -> outputs materialized on host
- ``fan_out``         sub-op fan-out built and sent
- ``ack_gather``      fan-out sent -> last shard ack arrives
- ``reply``           last ack -> client reply sent

Reads mark the same checkpoints in the order THEY cross them (sub-read
``fan_out``/``ack_gather`` precede the decode's device stages), and an
rmw write marks ``fan_out``/``ack_gather`` twice (pre-read round, then
the write round) — a ledger is an append-only record of boundaries
crossed, so stage sums always reconcile with the op's wall time by
construction.

Export surfaces (three of them): admin socket ``latency dump`` /
``latency reset``; mgr Prometheus (the ``oplat_*`` histogram families
render automatically as ``ceph_oplat_<stage>_latency_histogram`` with
a ``daemon`` label); and bench JSON, where every fenced workload
carries a ``stage_breakdown`` block (per-stage share-of-wall, per-op
time, p50/p99) whose ``usec_per_op`` figures are gated by
bench/regress.py's stage-budget gate.  With span tracing on, every
mark also lands on the op's span as a ``stage_ledger`` tag, so one
traced write shows its full time ledger next to its copy ledger.
"""
from __future__ import annotations

import contextlib
import contextvars
import threading

from ..common.lockdep import DebugLock
import time
from typing import Any, Dict, List, Optional, Tuple

from .histogram import (PerfHistogram, decumulate, g_perf_histograms,
                        latency_axes, percentiles_from_counts)
from .span import g_tracer

# canonical write-path stage order (reads/rmw cross a subset, possibly
# repeated — see module docstring); the bench's fenced regions reuse
# device_call/d2h for their dispatch-loop/drain split and add
# host_compute for the native host baseline
STAGES = (
    "client_flight", "admission", "class_queue", "client_lane",
    "dequeue_handoff", "op_service", "batch_window", "device_call",
    "d2h", "fan_out", "ack_gather", "reply",
)

_HIST_PREFIX = "oplat_"
_HIST_SUFFIX = "_latency_histogram"


def stage_hist_name(stage: str) -> str:
    return f"{_HIST_PREFIX}{stage}{_HIST_SUFFIX}"


def stage_of_hist_name(name: str) -> Optional[str]:
    if name.startswith(_HIST_PREFIX) and name.endswith(_HIST_SUFFIX):
        return name[len(_HIST_PREFIX):-len(_HIST_SUFFIX)]
    return None


# ---- perf counters (perf dump / Prometheus ceph_daemon_oplat_*) ------------
OPLAT_FIRST = 97000
l_oplat_ops = 97001            # ops whose ledger reached the reply mark
l_oplat_stage_samples = 97002  # individual stage durations recorded
OPLAT_LAST = 97005

_oplat_pc = None
_oplat_pc_lock = DebugLock("oplat_pc::init")


def oplat_perf_counters():
    """The stage-latency ledger's counter logger (perf dump /
    Prometheus ``ceph_daemon_oplat_*``)."""
    global _oplat_pc
    if _oplat_pc is not None:
        return _oplat_pc
    with _oplat_pc_lock:
        if _oplat_pc is None:
            from ..common.perf_counters import PerfCountersBuilder
            b = PerfCountersBuilder("oplat", OPLAT_FIRST, OPLAT_LAST)
            b.add_u64_counter(l_oplat_ops, "ops",
                              "ops whose stage ledger reached reply")
            b.add_u64_counter(l_oplat_stage_samples, "stage_samples",
                              "per-stage durations recorded")
            _oplat_pc = b.create_perf_counters()
    return _oplat_pc


# the op whose stages the current thread of control is executing
# (contextvars, like the tracer's current span: OSD worker threads and
# dispatch-flush continuations each carry their own)
_current: contextvars.ContextVar[Optional["OpLedger"]] = \
    contextvars.ContextVar("ceph_tpu_torch_oplat_current", default=None)


class OpLedger:
    """One op's append-only record of handoff boundaries.

    ``mark(stage)`` stamps now, records the interval since the previous
    stamp into the per-daemon stage histogram, and — with span tracing
    on — appends the entry to the op's span ``stage_ledger`` tag.
    CPython's GIL makes the append/swap safe for the op path's
    hand-off pattern (one thread of control at a time per op).
    """

    __slots__ = ("daemon", "span", "t0", "_last_t", "marks")

    def __init__(self, daemon: str = "", t0: Optional[float] = None,
                 span=None):
        self.daemon = daemon
        self.span = span
        self.t0 = time.perf_counter() if t0 is None else t0
        self._last_t = self.t0
        # (stage, t, dt_s) in the order the op crossed the boundaries
        self.marks: List[Tuple[str, float, float]] = []

    def mark(self, stage: str, t: Optional[float] = None) -> None:
        if t is None:
            t = time.perf_counter()
        dt = max(t - self._last_t, 0.0)
        self._last_t = max(self._last_t, t)
        self.marks.append((stage, t, dt))
        g_oplat.record(self.daemon or "unattributed", stage, dt * 1e6)
        if g_tracer.enabled and self.span is not None:
            self.span.tags.setdefault("stage_ledger", []).append(
                {"stage": stage, "t": t, "usec": round(dt * 1e6, 1)})

    @property
    def total_s(self) -> float:
        return self._last_t - self.t0

    def dump(self) -> Dict[str, Any]:
        """The per-op breakdown shape dump_historic_slow_ops carries:
        each stage with its duration and its offset from the ledger's
        open (monotone by construction)."""
        return {
            "daemon": self.daemon,
            "total_usec": round(self.total_s * 1e6, 1),
            "stages": [{"stage": s,
                        "at_usec": round((t - self.t0) * 1e6, 1),
                        "usec": round(dt * 1e6, 1)}
                       for s, t, dt in self.marks],
        }


# ---- message plumbing ------------------------------------------------------
# The ledger rides the MOSDOp as a non-wire annotation (``_oplat``):
# the in-process fabric passes message objects by reference, so the
# client's submit stamp reaches the OSD; msg/wire.py pops the key
# before encoding, so real-TCP frames and the pinned corpus are
# byte-identical (the OSD then opens the ledger at intake and
# client_flight is simply absent).

def stamp_client(msg, daemon: str = "") -> "OpLedger":
    """Open an op's ledger at client submit time (attached to the
    message; the receiving OSD re-homes it at intake)."""
    led = OpLedger(daemon)
    if g_tracer.enabled:
        led.span = g_tracer.current()
    msg._oplat = led
    return led


def intake_ledger(msg, daemon: str) -> "OpLedger":
    """The OSD-intake boundary: adopt the client's ledger (recording
    the flight stage) or open a fresh one for ops that arrived without
    a stamp (real TCP, internal senders)."""
    led = getattr(msg, "_oplat", None)
    if led is None:
        led = OpLedger(daemon)
        msg._oplat = led
    else:
        led.daemon = daemon
        led.mark("client_flight")
    return led


def item_ledger(item) -> Optional["OpLedger"]:
    """The ledger riding a work-queue item, if any — queue tiers know
    nothing about op structure, so the lookup lives here: op items are
    ``("op", msg)`` tuples with the ledger on the message."""
    if isinstance(item, tuple):
        if len(item) > 1:
            return getattr(item[1], "_oplat", None)
        return None
    return getattr(item, "_oplat", None)


def mark_item(item, stage: str, t: Optional[float] = None) -> None:
    led = item_ledger(item)
    if led is not None:
        led.mark(stage, t)


# ---- aggregate accumulator -------------------------------------------------
class OpLatAccumulator:
    """Per-daemon per-stage aggregation over the shared PerfHistogram
    registry, plus the contextvar threading that lets deep layers
    (queue tiers, the dispatch scheduler, ecutil's codec funnels) find
    the op they are serving."""

    def __init__(self):
        self._lock = DebugLock("OplatRegistry::lock")
        self._hists: Dict[Tuple[str, str], PerfHistogram] = {}

    # ---- context ----------------------------------------------------------
    def current(self) -> Optional[OpLedger]:
        return _current.get()

    @contextlib.contextmanager
    def activate(self, ledger: Optional[OpLedger]):
        """Make *ledger* the thread's current op (None = no-op)."""
        if ledger is None:
            yield None
            return
        token = _current.set(ledger)
        try:
            yield ledger
        finally:
            _current.reset(token)

    def checkpoint(self, stage: str, t: Optional[float] = None) -> None:
        """Mark *stage* on the thread's current ledger; a no-op when
        no op is active (direct library calls, recovery paths)."""
        led = _current.get()
        if led is not None:
            led.mark(stage, t)

    # ---- recording --------------------------------------------------------
    def _hist(self, daemon: str, stage: str) -> PerfHistogram:
        key = (daemon, stage)
        h = self._hists.get(key)
        if h is None:
            h = g_perf_histograms.get(daemon, stage_hist_name(stage),
                                      latency_axes)
            with self._lock:
                self._hists[key] = h
        return h

    def record(self, daemon: str, stage: str, usec: float) -> None:
        """One stage duration — the always-on aggregate bump every
        ``OpLedger.mark`` (and the bench fence) lands here."""
        self._hist(daemon, stage).inc(usec)
        oplat_perf_counters().inc(l_oplat_stage_samples)

    def note_op(self) -> None:
        """An op's ledger reached its reply mark."""
        oplat_perf_counters().inc(l_oplat_ops)

    # ---- views ------------------------------------------------------------
    def _stage_hists(self):
        """[(daemon, stage, hist)] for every oplat family registered."""
        out = []
        for (logger, name), hist in g_perf_histograms.items():
            stage = stage_of_hist_name(name)
            if stage is not None:
                out.append((logger, stage, hist))
        return out

    def dump(self, daemon: str = "") -> Dict[str, Any]:
        """The ``latency dump`` admin-socket shape: per daemon, each
        stage's count/total/mean/share + p50/p99 from the histogram's
        cumulative series.  The ``ops``/``stage_samples`` header
        counts are process-wide (one counter logger per process), so
        they only appear on the unfiltered dump — a daemon-filtered
        dump must not look like that daemon owns every op."""
        daemons: Dict[str, Dict[str, Any]] = {}
        for lg, stage, hist in self._stage_hists():
            if daemon and lg != daemon:
                continue
            if not hist.total_count:
                continue
            d = daemons.setdefault(lg, {"stages": {}, "total_usec": 0.0})
            pts = hist.cumulative_axis0()
            edges = [e for e, _c in pts]
            ps = percentiles_from_counts(decumulate(pts), edges,
                                         suffix="_usec")
            d["stages"][stage] = {
                "count": hist.total_count,
                "total_usec": round(hist.axis0_sum, 1),
                "avg_usec": round(hist.axis0_sum
                                  / max(hist.total_count, 1), 1),
                **ps,
            }
            d["total_usec"] += hist.axis0_sum
        for d in daemons.values():
            tot = d["total_usec"]
            d["total_usec"] = round(tot, 1)
            for st in d["stages"].values():
                st["share"] = round(st["total_usec"] / tot, 4) \
                    if tot > 0 else 0.0
        out: Dict[str, Any] = {"stage_catalog": list(STAGES),
                               "daemons": daemons}
        if not daemon:
            pc = oplat_perf_counters().dump()
            out["ops"] = pc.get("ops", 0)
            out["stage_samples"] = pc.get("stage_samples", 0)
        return out

    def reset(self) -> None:
        """``latency reset``: zero every oplat stage family and the
        ledger counters (other histogram families untouched)."""
        for _lg, _stage, hist in self._stage_hists():
            hist.reset()
        pc = oplat_perf_counters()
        for idx in (l_oplat_ops, l_oplat_stage_samples):
            pc.set(idx, 0)

    # ---- bench deltas ------------------------------------------------------
    def snapshot(self) -> Dict[str, Tuple[int, float, Tuple[int, ...]]]:
        """Per-stage (count, sum_usec, bucket_counts) collapsed across
        daemons — the before/after handle the bench's
        ``stage_breakdown`` blocks diff against."""
        out: Dict[str, List] = {}
        for _lg, stage, hist in self._stage_hists():
            counts = hist.marginal_axis0()
            cur = out.get(stage)
            if cur is None:
                out[stage] = [hist.total_count, hist.axis0_sum,
                              list(counts)]
            else:
                cur[0] += hist.total_count
                cur[1] += hist.axis0_sum
                cur[2] = [a + b for a, b in zip(cur[2], counts)]
        return {s: (c, t, tuple(b)) for s, (c, t, b) in out.items()}

    def breakdown_since(self, before, wall_s: float,
                        n_ops: int) -> Dict[str, Any]:
        """The bench ``stage_breakdown`` block: per-stage time over a
        measured region, share of total stage time, per-op time, and
        p50/p99 from the bucket-count deltas.

        ``coverage`` is stage-sum over wall: ~1.0 for a serial region
        (the reconciliation receipt), above 1.0 under concurrency —
        N ops waiting on one coalesced device call each accrue the full
        call, so coverage ~ occupancy is the occupancy story in time
        units, not an error.
        """
        after = self.snapshot()
        edges = latency_axes()[0].upper_edges()
        stages: Dict[str, Any] = {}
        total_usec = 0.0
        for stage, (c1, s1, b1) in sorted(after.items()):
            c0, s0, b0 = before.get(stage, (0, 0.0, None))
            dc, ds = c1 - c0, s1 - s0
            if dc <= 0:
                continue
            db = [max(a - b, 0) for a, b in zip(b1, b0)] if b0 \
                else list(b1)
            stages[stage] = {
                "count": dc,
                "total_usec": round(ds, 1),
                "usec_per_op": round(ds / max(n_ops, 1), 2),
                **percentiles_from_counts(db, edges, suffix="_usec"),
            }
            total_usec += ds
        for st in stages.values():
            st["share"] = round(st["total_usec"] / total_usec, 4) \
                if total_usec > 0 else 0.0
        return {
            "wall_s": round(float(wall_s), 4),
            "stage_sum_s": round(total_usec / 1e6, 4),
            "coverage": round(total_usec / 1e6 / wall_s, 3)
            if wall_s > 0 else 0.0,
            "n_ops": int(n_ops),
            "stages": stages,
        }


g_oplat = OpLatAccumulator()
