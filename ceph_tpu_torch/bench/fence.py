"""Completion-fenced timing: the clock stops only after outputs exist
on the host.

Port of ``ceph_tpu/bench/fence.py``.  A launch returns before the card
has run it, so a host clock around launches measures the enqueue.  The
fence here is a device-to-host readback: every port kernel launches on
the current stream, and a ``.cpu()`` copy of one element of the LAST
output waits on that stream, so its completion means every launch before
it completed on the card.

Accounting contract: the fenced elapsed time INCLUDES one round trip
(the drain copy).  That RTT is measured separately (``measure_rtt``) and
reported alongside — never silently subtracted — so a reader can bound
the pure compute time as ``elapsed - rtt <= compute <= elapsed``.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import torch

from ..trace.devprof import g_devprof


class FencedTiming:
    """One fenced measurement: N steps dispatched back-to-back, drained,
    timed as a unit."""

    __slots__ = ("elapsed_s", "n_steps", "rtt_s", "fenced")

    def __init__(self, elapsed_s: float, n_steps: int, rtt_s: float):
        self.elapsed_s = elapsed_s
        self.n_steps = n_steps
        self.rtt_s = rtt_s
        self.fenced = True

    @property
    def per_step_s(self) -> float:
        return self.elapsed_s / max(self.n_steps, 1)

    def throughput(self, bytes_per_step: int) -> float:
        """GiB/s of payload through the timed region (fence included)."""
        return self.n_steps * bytes_per_step / self.elapsed_s / (1 << 30)

    def to_dict(self) -> Dict[str, Any]:
        return {"elapsed_s": self.elapsed_s, "n_steps": self.n_steps,
                "rtt_s": self.rtt_s, "fenced": True}


def drain(out: torch.Tensor) -> None:
    """Copy one element of *out* to the host — the completion fence.

    The copy is a blocking device-to-host transfer on the current stream,
    where every port kernel launches.  One element, not the array: the
    fence's own cost stays one round trip.  The copy is accounted at
    ``bench.drain`` like any other transfer.  *out* must be a tensor; an
    object with no ``ravel`` raises.
    """
    one = out.ravel()[:1].cpu()
    g_devprof.account_d2h("bench.drain", one.numel() * one.element_size())


def measure_rtt(make_tiny: Optional[Callable[[], torch.Tensor]] = None,
                repeats: int = 3, device="cuda") -> float:
    """Median device-to-host round trip (seconds) of a tiny tensor on
    *device* (the card unless the caller asks for the CPU).

    This is the fence's own cost, reported next to every fenced elapsed
    time so the reading is interpretable.
    """
    if make_tiny is None:
        dev = torch.device(device)

        def make_tiny():
            t = torch.ones(8, dtype=torch.int32, device=dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return t

    samples = []
    for _ in range(max(repeats, 1)):
        tiny = make_tiny()
        t0 = time.perf_counter()
        tiny.cpu()
        samples.append(time.perf_counter() - t0)
    samples.sort()
    return samples[len(samples) // 2]


def fenced_time(step: Callable[[int], Any], n_steps: int,
                rtt_s: Optional[float] = None,
                kernel_name: Optional[str] = None,
                drain_fn: Optional[Callable[[Any], Any]] = None
                ) -> FencedTiming:
    """Dispatch ``step(i)`` for i in [0, n_steps) back-to-back, fence on
    the LAST output, and time the whole region.

    ``drain_fn`` overrides the fence for outputs whose completion needs
    more than the single-element drain; the default ``drain`` is the
    single-device contract.

    ``step`` must return the launch's output tensor.  Only the LAST
    output is retained: a launched kernel runs whether or not its output
    is kept, and holding all N outputs at the calibrated step count
    could pin gigabytes of device memory.  The caller salts the step
    input by ``i`` so no layer can serve a repeat from cache.
    """
    if n_steps < 1:
        raise ValueError("n_steps must be >= 1")
    if rtt_s is None:
        rtt_s = measure_rtt()
    from ..trace import g_perf_histograms, g_tracer, latency_axes
    span = g_tracer.begin(
        f"bench_fence:{kernel_name or 'fenced'}") if g_tracer.enabled \
        else None
    last: Any = None
    t0 = time.perf_counter()
    with g_tracer.activate(span):
        for i in range(n_steps):
            last = step(i)
        t_issued = time.perf_counter()
        drain_span = g_tracer.begin("drain") if span is not None else None
        (drain_fn or drain)(last)
        g_tracer.finish(drain_span)
    elapsed = time.perf_counter() - t0
    g_tracer.finish(span)
    # stage-latency ledger (trace/oplat.py): a fenced region decomposes
    # into the back-to-back dispatch loop (device_call) and the drain
    # copy that completes it (d2h) — the two stamps sum to the fenced
    # elapsed exactly, so every fenced workload's stage_breakdown
    # reconciles with its wall by construction
    from ..trace.oplat import g_oplat
    g_oplat.record("bench", "device_call", (t_issued - t0) * 1e6)
    g_oplat.record("bench", "d2h", (t0 + elapsed - t_issued) * 1e6)
    timing = FencedTiming(elapsed, n_steps, rtt_s)
    # per-step latency lands in the always-on bench histogram
    g_perf_histograms.get("bench", "fenced_step_latency_histogram",
                          latency_axes).inc(
        elapsed / n_steps * 1e6)
    if kernel_name:
        from ..common.kernel_trace import g_kernel_timer
        if g_kernel_timer.enabled:
            g_kernel_timer._record(kernel_name, elapsed)
    return timing
