"""PerfCounters — per-subsystem metric registry.

Port of ``ceph_tpu/common/perf_counters.py``, the same behaviour under the
same names; the port's ``get`` also takes a counter's name.

Mirrors the reference's counters (src/common/perf_counters.{h,cc}): a
builder declares u64 counters / time sums / long-run averages in a
contiguous index range, instances update lock-free-cheap, and a collection
dumps every logger as JSON for the admin socket's `perf dump`.
"""
from __future__ import annotations

import threading

from .lockdep import DebugLock
import time
from typing import Dict, List, Optional, Tuple

PERFCOUNTER_U64 = 1
PERFCOUNTER_TIME = 2
PERFCOUNTER_LONGRUNAVG = 4
PERFCOUNTER_COUNTER = 8


class _Counter:
    __slots__ = ("name", "type", "description", "value", "sum", "count")

    def __init__(self, name: str, type: int, description: str):
        self.name = name
        self.type = type
        self.description = description
        self.value = 0
        self.sum = 0.0
        self.count = 0


class PerfCounters:
    def __init__(self, name: str, lower: int, upper: int):
        self.name = name
        self.lower = lower
        self.upper = upper
        self._by_idx: Dict[int, _Counter] = {}
        self._lock = DebugLock("PerfCounters::lock")

    def _add(self, idx: int, c: _Counter) -> None:
        assert self.lower < idx < self.upper, "index out of declared range"
        self._by_idx[idx] = c

    # ---- updates ----------------------------------------------------------
    def inc(self, idx: int, amount: int = 1) -> None:
        """Bump a counter; ``count`` (the avgcount denominator) only
        moves for LONGRUNAVG counters, matching the reference's inc()
        (perf_counters.cc) — plain u64 counters must keep count == 0 so
        any future average over them isn't skewed by an inc-only,
        dec-never denominator."""
        c = self._by_idx[idx]
        with self._lock:
            c.value += amount
            if c.type & PERFCOUNTER_LONGRUNAVG:
                c.count += 1

    def dec(self, idx: int, amount: int = 1) -> None:
        """Reference semantics: dec() asserts on LONGRUNAVG counters
        and never touches avgcount — symmetric with inc() above."""
        c = self._by_idx[idx]
        assert not (c.type & PERFCOUNTER_LONGRUNAVG), \
            "dec() on a LONGRUNAVG counter (perf_counters.cc asserts)"
        with self._lock:
            c.value -= amount

    def set(self, idx: int, v: int) -> None:
        with self._lock:
            self._by_idx[idx].value = v

    def tinc(self, idx: int, seconds: float) -> None:
        c = self._by_idx[idx]
        with self._lock:
            c.sum += seconds
            c.count += 1

    def hinc(self, idx: int, v: float) -> None:
        """long-run average sample"""
        c = self._by_idx[idx]
        with self._lock:
            c.sum += v
            c.count += 1

    # ---- introspection ----------------------------------------------------
    def get(self, idx) -> int:
        """A counter's value by index or, in the port also, by name."""
        if isinstance(idx, str):
            with self._lock:
                for c in self._by_idx.values():
                    if c.name == idx:
                        return c.value
            raise KeyError(f"no counter {idx!r} in {self.name!r}")
        return self._by_idx[idx].value

    def dump(self) -> Dict[str, object]:
        out: Dict[str, object] = {}
        with self._lock:
            for c in self._by_idx.values():
                if c.type & PERFCOUNTER_LONGRUNAVG:
                    out[c.name] = {"avgcount": c.count, "sum": c.sum}
                elif c.type & PERFCOUNTER_TIME:
                    out[c.name] = {"sum": c.sum, "avgcount": c.count}
                else:
                    out[c.name] = c.value
        return out


class PerfCountersBuilder:
    def __init__(self, name: str, lower: int, upper: int):
        self._pc = PerfCounters(name, lower, upper)

    def add_u64_counter(self, idx: int, name: str,
                        description: str = "") -> "PerfCountersBuilder":
        self._pc._add(idx, _Counter(name, PERFCOUNTER_U64
                                    | PERFCOUNTER_COUNTER, description))
        return self

    def add_u64(self, idx: int, name: str,
                description: str = "") -> "PerfCountersBuilder":
        self._pc._add(idx, _Counter(name, PERFCOUNTER_U64, description))
        return self

    def add_time_avg(self, idx: int, name: str,
                     description: str = "") -> "PerfCountersBuilder":
        self._pc._add(idx, _Counter(name, PERFCOUNTER_TIME
                                    | PERFCOUNTER_LONGRUNAVG, description))
        return self

    def create_perf_counters(self) -> PerfCounters:
        return self._pc


class PerfCountersCollection:
    """Process-wide registry dumped by `perf dump`."""

    def __init__(self):
        self._loggers: Dict[str, PerfCounters] = {}
        self._lock = DebugLock("PerfCountersCollection::lock")

    def add(self, pc: PerfCounters) -> None:
        with self._lock:
            self._loggers[pc.name] = pc

    def remove(self, pc: PerfCounters) -> None:
        with self._lock:
            self._loggers.pop(pc.name, None)

    def dump(self, logger: str = "", counter: str = ""
             ) -> Dict[str, Dict[str, object]]:
        with self._lock:
            out = {}
            for name, pc in self._loggers.items():
                if logger and name != logger:
                    continue
                d = pc.dump()
                if counter:
                    d = {k: v for k, v in d.items() if k == counter}
                out[name] = d
            return out
