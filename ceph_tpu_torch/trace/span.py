"""Parent/child spans — the ZTracer/blkin slot, end to end.

Port of ``ceph_tpu/trace/span.py``, the same behaviour under the same names.

The reference threads a blkin trace through every op (the
``ZTracer::Trace`` member on ``msg/Message.h:254``): each daemon opens
child spans off the parent id the message carried, and a collector
reassembles the tree.  Here the same contract rides the mini-cluster
fabric: every message already carries ``trace_id``; this module adds
``parent_span_id`` propagation, per-daemon bounded ring buffers, and
tree reassembly for the admin socket's ``dump_tracing``.

Cost contract (why production can leave this importable): with the
tracer disabled — the default — ``begin()`` is one attribute check and
returns ``None``; no span objects, no clock reads, and critically **no
device syncs** are introduced anywhere.  Device drain time only appears
as child spans when the kernel timer (``tracing_kernels``) is also on,
because only then does a sync exist to measure.
"""
from __future__ import annotations

import contextlib
import contextvars
import itertools
import threading

from ..common.lockdep import DebugLock
import time
from collections import deque
from typing import Deque, Dict, List, Optional

_span_ids = itertools.count(1)

# the active span of this thread of control (contextvars so the OSD's
# worker threads each carry their own chain)
_current: contextvars.ContextVar[Optional["Span"]] = \
    contextvars.ContextVar("ceph_tpu_torch_trace_current", default=None)


class Span:
    """One named interval in one daemon, linked to its parent."""

    __slots__ = ("span_id", "parent_span_id", "trace_id", "name",
                 "daemon", "start", "end", "tags")

    def __init__(self, name: str, daemon: str, trace_id: int,
                 parent_span_id: int):
        self.span_id = next(_span_ids)
        self.parent_span_id = parent_span_id
        self.trace_id = trace_id
        self.name = name
        self.daemon = daemon
        self.start = time.monotonic()
        self.end: Optional[float] = None
        self.tags: Dict[str, object] = {}

    @property
    def duration(self) -> Optional[float]:
        return None if self.end is None else self.end - self.start

    def event(self, name: str, **tags) -> None:
        """Append a timestamped point event (the OpenTracing log slot:
        retries, breaker trips, fallbacks).  Rides the tags dict so the
        dump shape is unchanged for consumers that ignore events."""
        self.tags.setdefault("events", []).append(
            {"event": name, "t": time.monotonic(), **tags})

    def dump(self) -> dict:
        return {
            "span_id": self.span_id,
            "parent_span_id": self.parent_span_id,
            "trace_id": self.trace_id,
            "name": self.name,
            "daemon": self.daemon,
            "start": self.start,
            "end": self.end,
            "duration": self.duration,
            "tags": dict(self.tags),
        }


def build_tree(spans: List[Span]) -> List[dict]:
    """Nest spans by parent_span_id; roots are spans whose parent is
    absent from the set (e.g. 0, or evicted from the ring)."""
    by_id = {s.span_id: s.dump() for s in spans}
    for d in by_id.values():
        d["children"] = []
    roots: List[dict] = []
    for d in sorted(by_id.values(), key=lambda d: d["start"]):
        parent = by_id.get(d["parent_span_id"])
        if parent is not None and parent is not d:
            parent["children"].append(d)
        else:
            roots.append(d)
    return roots


class SpanCollector:
    """Per-daemon bounded ring buffers of recent spans.

    Spans are recorded at ``begin`` time (so in-flight spans are
    dumpable, like ``dump_ops_in_flight``) and mutate in place when
    finished; ring eviction only drops the collector's reference — a
    flight-recorder entry pinning the span keeps its tree intact.
    """

    def __init__(self, ring_size: int = 2048):
        self.ring_size = ring_size
        self._rings: Dict[str, Deque[Span]] = {}
        self._lock = DebugLock("Tracer::lock")

    def record(self, span: Span) -> None:
        with self._lock:
            ring = self._rings.get(span.daemon)
            if ring is None:
                ring = self._rings[span.daemon] = deque(
                    maxlen=self.ring_size)
            ring.append(span)

    def spans_for_trace(self, trace_id: int) -> List[Span]:
        with self._lock:
            return [s for ring in self._rings.values() for s in ring
                    if s.trace_id == trace_id]

    def tree(self, trace_id: int) -> List[dict]:
        return build_tree(self.spans_for_trace(trace_id))

    def dump(self, daemon: str = "") -> Dict[str, List[dict]]:
        with self._lock:
            return {name: [s.dump() for s in ring]
                    for name, ring in self._rings.items()
                    if not daemon or name == daemon}

    def clear(self) -> None:
        with self._lock:
            self._rings.clear()


class Tracer:
    """The process-wide span factory (all mini-cluster daemons share
    one process, so one tracer covers every daemon; spans carry their
    daemon name)."""

    def __init__(self):
        self.enabled = False
        self.collector = SpanCollector()

    def enable(self, on: bool = True) -> None:
        self.enabled = on

    # ---- explicit begin/finish (ops spanning callbacks) -------------------
    def begin(self, name: str, daemon: str = "", trace_id: int = 0,
              parent_id: int = 0) -> Optional[Span]:
        """Open a span, or None when disabled.  Parent resolution:
        explicit *parent_id* (the message header) wins; otherwise the
        thread's current span; trace_id inherits the same way."""
        if not self.enabled:
            return None
        cur = _current.get()
        if not parent_id and cur is not None:
            parent_id = cur.span_id
        if not trace_id and cur is not None:
            trace_id = cur.trace_id
        span = Span(name, daemon, trace_id, parent_id)
        self.collector.record(span)
        return span

    def finish(self, span: Optional[Span]) -> None:
        if span is not None and span.end is None:
            span.end = time.monotonic()

    # ---- context helpers --------------------------------------------------
    @contextlib.contextmanager
    def activate(self, span: Optional[Span]):
        """Make *span* the thread's current span (children attach to it)."""
        if span is None:
            yield None
            return
        token = _current.set(span)
        try:
            yield span
        finally:
            _current.reset(token)

    @contextlib.contextmanager
    def span(self, name: str, daemon: str = "", trace_id: int = 0,
             parent_id: int = 0):
        """begin + activate + finish in one block."""
        sp = self.begin(name, daemon, trace_id, parent_id)
        if sp is None:
            yield None
            return
        token = _current.set(sp)
        try:
            yield sp
        finally:
            _current.reset(token)
            self.finish(sp)

    def current(self) -> Optional[Span]:
        return _current.get()

    def event(self, name: str, **tags) -> None:
        """Record a point event on the thread's current span; a no-op
        when disabled or no span is active (host-side only — the
        degradation machinery calls this from hot paths)."""
        if not self.enabled:
            return
        cur = _current.get()
        if cur is not None:
            cur.event(name, **tags)

    def current_span_id(self) -> int:
        cur = _current.get()
        return cur.span_id if cur is not None else 0

    def current_trace_id(self) -> int:
        cur = _current.get()
        return cur.trace_id if cur is not None else 0


g_tracer = Tracer()
