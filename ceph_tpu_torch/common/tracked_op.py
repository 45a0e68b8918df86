"""OpTracker — in-flight op tracking and historic-op tracing.

Port of ``ceph_tpu/common/tracked_op.py``, the same behaviour under the same names.

Mirrors the reference's op latency surface (src/common/TrackedOp.cc +
the blkin trace slot on every Message, msg/Message.h:254): each op carries
one trace id end to end, records named events with timestamps, and
completed ops land in a bounded history ring dumped via the admin socket
(`dump_historic_ops`, `dump_ops_in_flight`).
"""
from __future__ import annotations

import threading

from .lockdep import DebugLock
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple


class TrackedOp:
    def __init__(self, tracker: "OpTracker", trace_id: int,
                 description: str):
        self.tracker = tracker
        self.trace_id = trace_id
        self.description = description
        self.initiated_at = tracker.now()
        self.events: List[Tuple[float, str]] = []
        self.completed_at: Optional[float] = None
        # observability hooks: the daemon's span for this op (set by the
        # dispatch path when the tracer is on), the flight-recorder
        # entry pinning its span tree once the op proves slow, and the
        # always-on stage-latency ledger (trace/oplat.py) — pinned by
        # reference like the span objects, so a slow op's per-stage
        # breakdown survives without re-running anything
        self.span = None
        self.flight = None
        self.oplat = None

    def mark_event(self, event: str) -> None:
        self.events.append((self.tracker.now(), event))

    def finish(self) -> None:
        self.completed_at = self.tracker.now()
        self.tracker._complete(self)

    @property
    def duration(self) -> float:
        end = self.completed_at if self.completed_at is not None \
            else self.tracker.now()
        return end - self.initiated_at

    def dump(self) -> dict:
        return {
            "description": self.description,
            "trace_id": self.trace_id,
            "initiated_at": self.initiated_at,
            "age": self.duration,
            "type_data": {
                "events": [{"time": t, "event": e}
                           for t, e in self.events],
            },
        }


class OpTracker:
    def __init__(self, history_size: int = 20,
                 history_duration: float = 600.0,
                 clock=time.monotonic, name: str = ""):
        self.history_size = history_size
        self.history_duration = history_duration
        # daemon name for the event journal; empty = generic "osd"
        self.name = name
        self.now = clock
        self._inflight: Dict[int, TrackedOp] = {}
        self._history: Deque[TrackedOp] = deque(maxlen=history_size)
        self._slow: Deque[TrackedOp] = deque(maxlen=history_size)
        self._lock = DebugLock("OpTracker::lock")
        self._complaint_override: Optional[float] = None

    @property
    def complaint_time(self) -> float:
        """Live view of op_complaint_time: a runtime `config set` (or
        injectargs) takes effect on the next completion — no observer
        plumbing per tracker instance needed.  Direct assignment (tests,
        embedders) pins an explicit override."""
        if self._complaint_override is not None:
            return self._complaint_override
        from .config import g_conf
        return float(g_conf.get_val("op_complaint_time"))

    @complaint_time.setter
    def complaint_time(self, v: float) -> None:
        self._complaint_override = float(v)

    def create_request(self, trace_id: int, description: str) -> TrackedOp:
        op = TrackedOp(self, trace_id, description)
        with self._lock:
            self._inflight[trace_id] = op
        op.mark_event("initiated")
        return op

    def _complete(self, op: TrackedOp) -> None:
        with self._lock:
            self._inflight.pop(op.trace_id, None)
            self._history.append(op)
            slow = op.duration > self.complaint_time
            if slow:
                self._slow.append(op)
        if slow:
            # flight-record the span tree NOW: ring eviction in the
            # collector must not be able to dismember a slow op's trace
            # before anyone dumps it.  Span objects are pinned by
            # reference, so spans still open here (the client's root)
            # close in place before a later dump reads them.
            from ..trace import g_flight_recorder, g_tracer
            if g_tracer.enabled and op.trace_id:
                spans = g_tracer.collector.spans_for_trace(op.trace_id)
                if spans:
                    op.flight = g_flight_recorder.record(
                        op.trace_id, op.description, op.duration, spans)
            from ..trace.journal import g_journal
            g_journal.emit(self.name or "osd", "slow_op",
                           description=op.description,
                           duration=round(op.duration, 6))

    def dump_ops_in_flight(self) -> dict:
        with self._lock:
            ops = [o.dump() for o in self._inflight.values()]
        return {"ops": ops, "num_ops": len(ops)}

    def dump_historic_ops(self) -> dict:
        with self._lock:
            ops = [o.dump() for o in self._history]
        return {"size": self.history_size,
                "duration": self.history_duration, "ops": ops}

    def dump_historic_slow_ops(self) -> dict:
        """Slow ops with their flight-recorded span trees (the
        reference's dump_historic_slow_ops, grown the ZTracer view)."""
        with self._lock:
            ops = list(self._slow)
        out = []
        for o in ops:
            d = o.dump()
            if o.flight is not None:
                d["span_tree"] = o.flight.tree()
            if o.oplat is not None:
                # which stage ate the budget — the always-on ledger is
                # already complete, no re-run or tracing required
                d["stage_ledger"] = o.oplat.dump()
            # which COPIES ate the budget: the devprof per-transfer
            # ledger rides the op's pinned spans as a tag, so slow-op
            # forensics shows bytes next to time
            copies: List[dict] = []
            spans = o.flight.spans if o.flight is not None \
                else ([o.span] if o.span is not None else [])
            for s in spans:
                copies.extend(s.tags.get("copy_ledger", ()))
            if spans:
                d["copy_ledger"] = copies
            out.append(d)
        return {"ops": out}

    @property
    def num_slow_ops(self) -> int:
        with self._lock:
            return len(self._slow)
