"""Per-kernel device timing + profiler hooks — the tracing subsystem.

Port of ``ceph_tpu/common/kernel_trace.py``.  The reference instruments
its hot paths with LTTng tracepoints (src/tracing/*.tp) and threads one
trace id through every op (msg/Message.h:254).  Here:

- ``KernelTimer``: named cumulative timing of device calls.  Off by
  default (timing synchronises the card after every call, which stops
  launches from queueing); flip on via config ``tracing_kernels`` or
  ``KernelTimer.enable()`` when diagnosing.  The sync is
  ``torch.cuda.synchronize`` on the device of a CUDA tensor output; a
  host output (numpy, or a tensor on the CPU) is complete when the call
  returns and needs none.  A failed sync raises: nothing is caught.
- ``annotate(name)``: a ``torch.profiler.record_function`` region, so
  framework phases show up named in a ``torch.profiler`` trace.
- ``start_profiler_trace`` / ``stop_profiler_trace``: one
  ``torch.profiler.profile`` over CPU and, where there is a card, CUDA
  activity, written as a Chrome trace into ``log_dir`` when it stops.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch

from .lockdep import DebugLock

# NOTE: ..trace imports back into common (span/histogram take their
# DebugLocks from common.lockdep), so g_tracer must resolve lazily
# or the two package __init__s deadlock on import order
_g_tracer = None


def _tracer():
    global _g_tracer
    if _g_tracer is None:
        from ..trace import g_tracer
        _g_tracer = g_tracer
    return _g_tracer


def _sync_output(out) -> None:
    """Wait for the card to finish a CUDA tensor output; anything else
    is already complete on the host."""
    if isinstance(out, torch.Tensor) and out.is_cuda:
        torch.cuda.synchronize(out.device)


class KernelTimer:
    """Cumulative wall timing per named kernel.

    Thread-safe: concurrent dispatch threads record into the same stats
    dict, so the read-modify-write in ``_record`` runs under a lock.
    """

    def __init__(self):
        self.enabled = False
        self.stats: Dict[str, Dict[str, float]] = {}
        self._lock = DebugLock("KernelTrace::lock")

    def enable(self, on: bool = True) -> None:
        self.enabled = on

    @contextlib.contextmanager
    def time(self, name: str):
        """Time a host-side block (callers drain device values inside)."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._record(name, time.perf_counter() - t0)

    def timed(self, name: str, fn, *args, **kw):
        """Call fn and, when timing is on, wait for its output: the
        one-shot instrumented dispatch of the device backends.

        With the span tracer active this also emits a ``kernel:<name>``
        child span (and, when timing is on and a sync therefore exists,
        a ``device_drain`` child inside it).  The sync itself is gated
        on ``self.enabled`` alone — spans never add one.
        """
        g_tracer = _tracer()
        if not g_tracer.enabled:
            if not self.enabled:
                return fn(*args, **kw)
            return self._timed_sync(name, fn, args, kw, None)
        with g_tracer.span(f"kernel:{name}") as sp:
            if not self.enabled:
                if sp is not None:
                    sp.tags["dispatch_only"] = True
                return fn(*args, **kw)
            return self._timed_sync(name, fn, args, kw, g_tracer)

    def _timed_sync(self, name: str, fn, args, kw, tracer):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        drain_span = tracer.begin("device_drain") if tracer is not None \
            else None
        _sync_output(out)
        if tracer is not None:
            tracer.finish(drain_span)
        self._record(name, time.perf_counter() - t0)
        return out

    def _record(self, name: str, dt: float) -> None:
        with self._lock:
            s = self.stats.setdefault(
                name, {"calls": 0, "total_s": 0.0, "max_s": 0.0})
            s["calls"] += 1
            s["total_s"] += dt
            s["max_s"] = max(s["max_s"], dt)

    def dump(self) -> Dict[str, Dict[str, float]]:
        out = {}
        with self._lock:
            snap = {name: dict(s) for name, s in self.stats.items()}
        for name, d in sorted(snap.items()):
            if d["calls"]:
                d["avg_ms"] = round(d["total_s"] / d["calls"] * 1e3, 3)
            out[name] = d
        return out

    def reset(self) -> None:
        with self._lock:
            self.stats.clear()


g_kernel_timer = KernelTimer()


@contextlib.contextmanager
def annotate(name: str):
    """Named region in a ``torch.profiler`` trace; costs a record only
    while a profiler is active."""
    with torch.profiler.record_function(name):
        yield


_profile: Optional[torch.profiler.profile] = None
_profile_dir = ""


def start_profiler_trace(log_dir: str) -> bool:
    """Begin a ``torch.profiler`` trace (CPU, and CUDA where there is a
    card).  False when one is already running."""
    global _profile, _profile_dir
    if _profile is not None:
        return False
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    _profile, _profile_dir = prof, log_dir
    return True


def stop_profiler_trace() -> bool:
    """Stop the running trace and write ``<log_dir>/trace.json`` (Chrome
    trace format).  False when none is running."""
    global _profile
    if _profile is None:
        return False
    prof, _profile = _profile, None
    prof.stop()
    os.makedirs(_profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(_profile_dir, "trace.json"))
    return True
