"""Slow-op flight recorder — span trees pinned past ring eviction.

Port of ``ceph_tpu/trace/flight.py``, the same behaviour under the same names.

When an op exceeds ``complaint_time`` the OpTracker hands its trace's
spans to this recorder.  The entry pins the Span *objects* (not dumps):
spans still open at completion time — e.g. the client's root span,
which only closes after the reply crosses back — finish in place, so a
later ``dump_historic_slow_ops`` shows the complete, closed tree even
after the collector's ring buffers recycled.
"""
from __future__ import annotations

import threading

from ..common.lockdep import DebugLock
from collections import deque
from typing import Deque, List

from .span import Span, build_tree


class FlightEntry:
    __slots__ = ("trace_id", "description", "duration", "spans")

    def __init__(self, trace_id: int, description: str, duration: float,
                 spans: List[Span]):
        self.trace_id = trace_id
        self.description = description
        self.duration = duration
        self.spans = list(spans)

    def tree(self) -> List[dict]:
        return build_tree(self.spans)

    def dump(self) -> dict:
        return {"trace_id": self.trace_id,
                "description": self.description,
                "duration": self.duration,
                "span_tree": self.tree()}


class FlightRecorder:
    def __init__(self, size: int = 64):
        self._ring: Deque[FlightEntry] = deque(maxlen=size)
        self._lock = DebugLock("FlightRecorder::lock")

    def record(self, trace_id: int, description: str, duration: float,
               spans: List[Span]) -> FlightEntry:
        entry = FlightEntry(trace_id, description, duration, spans)
        with self._lock:
            self._ring.append(entry)
        return entry

    def dump(self) -> dict:
        with self._lock:
            entries = list(self._ring)
        return {"slow_ops": [e.dump() for e in entries]}

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


g_flight_recorder = FlightRecorder()
