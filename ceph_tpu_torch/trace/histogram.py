"""PerfHistogram — log2-bucketed 1D/2D distributions.

Port of ``ceph_tpu/trace/histogram.py``, the same behaviour under the same names.

The reference's 2D latency×bytes surface (src/common/perf_histogram.h,
dumped as ``op_w_latency_in_bytes_histogram`` under ``perf histogram
dump``): each axis declares (name, min, quant_size, buckets,
scale_type), a sample lands in one cell, and the dump carries the axis
configs next to the full count grid so a consumer can reconstruct
bucket bounds without out-of-band knowledge.

Bucketing matches the reference's get_bucket_for_axis: values below
``min`` land in bucket 0; otherwise ``d = (value - min) // quant_size``
and log2 axes place d in bucket ``min(1 + bit_length(d), buckets-1)``
(linear: ``min(1 + d, buckets-1)``).  The last bucket is the overflow.

Histograms are always-on like perf counters: incrementing is host-side
integer math under a lock — no device syncs, no allocation per sample —
so the write path keeps them hot in production.
"""
from __future__ import annotations

import math
import threading

from ..common.lockdep import DebugLock
from typing import Dict, Iterable, List, Optional, Tuple

SCALE_LINEAR = "linear"
SCALE_LOG2 = "log2"


class PerfHistogramAxis:
    __slots__ = ("name", "min", "quant_size", "buckets", "scale_type")

    def __init__(self, name: str, min: int = 0, quant_size: int = 1,
                 buckets: int = 32, scale_type: str = SCALE_LOG2):
        assert buckets >= 2, "need at least an underflow + one bucket"
        assert quant_size >= 1
        self.name = name
        self.min = min
        self.quant_size = quant_size
        self.buckets = buckets
        self.scale_type = scale_type

    def bucket_for(self, value: float) -> int:
        v = int(value)
        if v < self.min:
            return 0
        d = (v - self.min) // self.quant_size
        if self.scale_type == SCALE_LINEAR:
            return min(1 + d, self.buckets - 1)
        return min(1 + int(d).bit_length(), self.buckets - 1)

    def upper_edges(self) -> List[float]:
        """Exclusive upper bound of every bucket, in the axis's raw
        unit; the last bucket's bound is +inf (overflow)."""
        edges: List[float] = [float(self.min)]          # bucket 0: < min
        for b in range(1, self.buckets - 1):
            if self.scale_type == SCALE_LINEAR:
                edges.append(float(self.min + b * self.quant_size))
            else:
                edges.append(float(self.min
                                   + self.quant_size * (1 << (b - 1))))
        edges.append(float("inf"))
        return edges

    def dump_config(self) -> dict:
        return {"name": self.name, "min": self.min,
                "quant_size": self.quant_size, "buckets": self.buckets,
                "scale_type": self.scale_type}


class PerfHistogram:
    """N-dimensional counts grid (1D and 2D used here), thread-safe."""

    def __init__(self, axes: List[PerfHistogramAxis]):
        assert axes, "at least one axis"
        self.axes = list(axes)
        n = 1
        for ax in self.axes:
            n *= ax.buckets
        self._counts = [0] * n
        self._lock = DebugLock("PerfHistogram::lock")
        # axis-0 raw-value accounting for _sum/_count exposition
        self.total_count = 0
        self.axis0_sum = 0.0

    def inc(self, *values: float) -> None:
        assert len(values) == len(self.axes)
        idx = 0
        for ax, v in zip(self.axes, values):
            idx = idx * ax.buckets + ax.bucket_for(v)
        with self._lock:
            self._counts[idx] += 1
            self.total_count += 1
            self.axis0_sum += float(values[0])

    # ---- views ------------------------------------------------------------
    def _grid(self) -> list:
        """Counts as nested lists matching the axis order."""
        with self._lock:
            flat = list(self._counts)
        shape = [ax.buckets for ax in self.axes]

        def nest(offset: int, dims: List[int]):
            if len(dims) == 1:
                return flat[offset:offset + dims[0]]
            stride = 1
            for d in dims[1:]:
                stride *= d
            return [nest(offset + i * stride, dims[1:])
                    for i in range(dims[0])]

        return nest(0, shape)

    def marginal_axis0(self) -> List[int]:
        """Per-bucket counts over axis 0, summed across all other axes."""
        with self._lock:
            flat = list(self._counts)
        b0 = self.axes[0].buckets
        stride = len(flat) // b0
        return [sum(flat[i * stride:(i + 1) * stride]) for i in range(b0)]

    def cumulative_axis0(self) -> List[Tuple[float, int]]:
        """(upper_edge, cumulative_count) per axis-0 bucket — the
        Prometheus ``le`` series shape (monotone by construction)."""
        counts = self.marginal_axis0()
        edges = self.axes[0].upper_edges()
        out: List[Tuple[float, int]] = []
        cum = 0
        for edge, cnt in zip(edges, counts):
            cum += cnt
            out.append((edge, cum))
        return out

    def dump(self) -> dict:
        """The reference's dump shape: axis configs + full count grid."""
        return {"axes": [ax.dump_config() for ax in self.axes],
                "values": self._grid(),
                "count": self.total_count,
                "axis0_sum": self.axis0_sum}

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * len(self._counts)
            self.total_count = 0
            self.axis0_sum = 0.0


class PerfHistogramCollection:
    """(logger, histogram-name) registry dumped by ``perf histogram
    dump`` and scraped by the mgr's Prometheus renderer."""

    def __init__(self):
        self._hists: Dict[Tuple[str, str], PerfHistogram] = {}
        self._lock = DebugLock("PerfHistogramRegistry::lock")

    def get(self, logger: str, name: str,
            axes_factory=None) -> PerfHistogram:
        """Fetch-or-create; *axes_factory* is a zero-arg callable
        returning the axis list (only invoked on first creation, so a
        restarted daemon reattaches to its existing histogram)."""
        key = (logger, name)
        with self._lock:
            hist = self._hists.get(key)
            if hist is None:
                if axes_factory is None:
                    raise KeyError(f"histogram {key!r} not registered")
                hist = self._hists[key] = PerfHistogram(axes_factory())
            return hist

    def items(self) -> List[Tuple[Tuple[str, str], PerfHistogram]]:
        with self._lock:
            return sorted(self._hists.items())

    def dump(self, logger: str = "", name: str = ""
             ) -> Dict[str, Dict[str, dict]]:
        out: Dict[str, Dict[str, dict]] = {}
        for (lg, nm), hist in self.items():
            if (logger and lg != logger) or (name and nm != name):
                continue
            out.setdefault(lg, {})[nm] = hist.dump()
        return out

    def reset(self) -> None:
        for _key, hist in self.items():
            hist.reset()


g_perf_histograms = PerfHistogramCollection()


# ---- percentile helpers (shared by load.traffic and trace.oplat) ----------
def decumulate(pts: List[Tuple[float, int]]) -> List[int]:
    """Cumulative (edge, count) series -> raw per-bucket counts."""
    counts, prev = [], 0
    for _edge, cum in pts:
        counts.append(cum - prev)
        prev = cum
    return counts


def percentiles_from_counts(counts: List[int], edges: List[float],
                            qs=(0.5, 0.99),
                            suffix: str = "") -> Dict[str, float]:
    """``{"p50<suffix>": edge, ...}`` over raw per-bucket counts: each
    value is the EXCLUSIVE upper edge of the bucket the quantile falls
    in; the overflow bucket reports the last finite edge (a lower
    bound).  One implementation for every percentile consumer
    (``latency dump``, the bench stage_breakdown deltas, the traffic
    harness's per-client series) so the quantile rule cannot drift."""
    total = sum(counts)
    finite = [e for e in edges if e != float("inf")]
    out: Dict[str, float] = {}
    for q in qs:
        key = "p" + format(q * 100, "g").replace(".", "") + suffix
        if total <= 0:
            out[key] = 0.0
            continue
        target = math.ceil(q * total)
        cum = 0
        for edge, cnt in zip(edges, counts):
            cum += cnt
            if cum >= target:
                out[key] = edge if edge != float("inf") \
                    else (finite[-1] if finite else 0.0)
                break
    return out


def hist_percentiles(hist, qs=(0.5, 0.99, 0.999)) -> Dict[str, float]:
    """``{"p50": value, ...}`` read from anything exposing the
    ``cumulative_axis0()`` series shape (a PerfHistogram, or a merged
    stand-in).  THE percentile reader every consumer shares — the
    traffic harness's per-client tables, ``latency dump``, the bench
    stage_breakdown deltas, and the mgr telemetry rollup — so the
    quantile rule cannot drift between surfaces."""
    pts = hist.cumulative_axis0()
    return percentiles_from_counts(decumulate(pts),
                                   [e for e, _c in pts], qs)


def merge_axis0(hists) -> Tuple[List[float], List[int]]:
    """The cluster-rollup merge core: per-bucket axis-0 counts summed
    across *hists* (the union distribution).  Every histogram must
    share the axis-0 edge layout — same-named families across daemons
    do by construction (one axes factory per family); a mismatch is a
    programming error and raises rather than silently mis-bucketing.
    Returns ``(upper_edges, summed_counts)``; percentiles of the
    merged series are EXACTLY the percentiles of the union of the
    per-daemon samples (same edges, so no re-bucketing error)."""
    edges: List[float] = []
    counts: List[int] = []
    for h in hists:
        e = h.axes[0].upper_edges()
        c = h.marginal_axis0()
        if not edges:
            edges, counts = e, list(c)
            continue
        if e != edges:
            raise ValueError(
                f"cannot merge histograms with different axis-0 edges "
                f"({h.axes[0].dump_config()})")
        counts = [a + b for a, b in zip(counts, c)]
    return edges, counts


def merged_percentiles(hists, qs=(0.5, 0.99, 0.999),
                       suffix: str = "") -> Dict[str, float]:
    """Percentiles of the union of same-edged histograms (cluster-level
    tail: ONE number per quantile, not one per daemon)."""
    edges, counts = merge_axis0(hists)
    return percentiles_from_counts(counts, edges, qs, suffix=suffix)


# ---- standard axis shapes (the reference's l_osd histogram configs) ------
def latency_in_bytes_axes() -> List[PerfHistogramAxis]:
    """2D latency(usec, log2) x request-size(bytes, log2) — the
    ``op_w_latency_in_bytes_histogram`` shape (OSD.cc histogram setup:
    latency quant 100 usec, size quant 512 B, 32 log2 buckets each)."""
    return [PerfHistogramAxis("latency_usec", min=0, quant_size=100,
                              buckets=32, scale_type=SCALE_LOG2),
            PerfHistogramAxis("request_size_bytes", min=0, quant_size=512,
                              buckets=32, scale_type=SCALE_LOG2)]


def latency_axes() -> List[PerfHistogramAxis]:
    """1D latency(usec, log2) — request-handling paths with no natural
    byte axis (MDS requests, CRUSH batch mapping)."""
    return [PerfHistogramAxis("latency_usec", min=0, quant_size=100,
                              buckets=32, scale_type=SCALE_LOG2)]


def occupancy_axes() -> List[PerfHistogramAxis]:
    """1D batch occupancy (requests per coalesced device flush) —
    linear unit buckets.  Occupancies 0..64 are individually visible
    (value v lands in bucket 1+v, the last bucket is overflow), so a
    FULL default-sized batch (ec_dispatch_batch_max = 64) has its own
    bucket instead of vanishing into +Inf."""
    return [PerfHistogramAxis("batch_occupancy", min=0, quant_size=1,
                              buckets=67, scale_type=SCALE_LINEAR)]


def pipeline_axes() -> List[PerfHistogramAxis]:
    """1D EC write-pipeline occupancy (ops in flight in the per-PG
    window at encode-submit time) — linear unit buckets, dimensionless
    like occupancy_axes (the mgr renderer exports raw bucket edges).
    Depths 0..32 are individually visible; deeper windows overflow into
    the last bucket."""
    return [PerfHistogramAxis("pipeline_inflight", min=0, quant_size=1,
                              buckets=35, scale_type=SCALE_LINEAR)]
