"""Device-flow profiler — host<->device transfer, compile, and memory
accounting with per-call-site resolution.

Port of ``ceph_tpu/trace/devprof.py``.  Bytes moved per op are a
first-class metric: memory movement, not GF math, dominates small-chunk
EC (arxiv 2108.02692), so every host<->device boundary the hot paths
cross is accounted here.

- every boundary is wrapped by a thin accounting call (``account_h2d`` /
  ``account_d2h`` / ``account_host_copy``) recording per call-site
  direction, bytes and count — pure host-side counter bumps, **zero
  added device syncs** (nbytes come from shapes, never from the card);
- a compile is one ``nvcc`` run: ``ops/_build.py::build`` calls
  ``note_compile`` on every cache miss (a cached ``.so`` counts
  nothing), and the compile is attributed to whichever call-site's
  ``stage()`` scope was active (``unattributed`` outside any);
- device-memory high-water is sampled from
  ``torch.cuda.memory_stats`` (``allocated_bytes.all.current`` /
  ``.peak``) at dump time, never on the op path; a process without a
  card reports source ``"none"``;
- when span tracing is on, every accounted copy is also appended to the
  active span's ``copy_ledger`` tag.

Export surfaces: ``dump()`` / ``reset()`` (the admin socket's ``prof
dump`` / ``prof reset`` shape), the ``devprof`` perf-counter logger and
the ``devprof_transfer_size_histogram``, and bench JSON, where every
fenced workload carries a ``devflow`` block (``devflow_delta``).
"""
from __future__ import annotations

import contextlib
import contextvars
import threading

from typing import Any, Dict, List, Optional

import torch

from ..common.lockdep import DebugLock

from .histogram import (PerfHistogramAxis, SCALE_LOG2, g_perf_histograms)
from .span import g_tracer

H2D = "h2d"
D2H = "d2h"
HOST = "host"        # host-side buffer copy (pad/stack/message build)

# calibration-flow sites: accounted like any other boundary crossing
# (they show in `prof dump` and the counter logger), but EXCLUDED from
# the bench `devflow` snapshots the copy-budget gate compares — their
# one-element readbacks are measurement instrumentation, not a per-op
# copy chain, the same policy that keeps the bench drain fences off
# the ledger entirely (parallel/ec.drain_sharded).  The mesh skew
# probe (mesh/chipstat.py) accounts here so the fence-count test can
# assert EXACTLY the probe's per-chip readbacks and nothing else.
CALIBRATION_SITES = frozenset({"mesh.skew_probe"})

# ---- perf counters (perf dump / Prometheus ceph_daemon_devprof_*) ----------
DEVPROF_FIRST = 96000
l_devprof_h2d_bytes = 96001       # bytes moved host -> device
l_devprof_h2d_transfers = 96002   # host -> device transfers
l_devprof_d2h_bytes = 96003       # bytes moved device -> host
l_devprof_d2h_transfers = 96004   # device -> host transfers
l_devprof_compiles = 96005        # fresh kernel builds (nvcc runs)
l_devprof_host_copy_bytes = 96006  # host-side staging copies, bytes
l_devprof_host_copies = 96007     # host-side staging copies
l_devprof_device_mem_highwater = 96008  # gauge: peak device bytes seen
DEVPROF_LAST = 96010

_devprof_pc = None
_devprof_pc_lock = DebugLock("devprof_pc::init")


def devprof_perf_counters():
    """The device-flow profiler's counter logger (perf dump /
    Prometheus ``ceph_daemon_devprof_*``)."""
    global _devprof_pc
    if _devprof_pc is not None:
        return _devprof_pc
    with _devprof_pc_lock:
        if _devprof_pc is None:
            from ..common.perf_counters import PerfCountersBuilder
            b = PerfCountersBuilder("devprof", DEVPROF_FIRST,
                                    DEVPROF_LAST)
            b.add_u64_counter(l_devprof_h2d_bytes, "h2d_bytes",
                              "bytes moved host to device")
            b.add_u64_counter(l_devprof_h2d_transfers, "h2d_transfers",
                              "host to device transfers")
            b.add_u64_counter(l_devprof_d2h_bytes, "d2h_bytes",
                              "bytes moved device to host")
            b.add_u64_counter(l_devprof_d2h_transfers, "d2h_transfers",
                              "device to host transfers")
            b.add_u64_counter(l_devprof_compiles, "compiles",
                              "fresh kernel builds (nvcc runs)")
            b.add_u64_counter(l_devprof_host_copy_bytes,
                              "host_copy_bytes",
                              "host-side staging copy bytes "
                              "(pad/stack/message build)")
            b.add_u64_counter(l_devprof_host_copies, "host_copies",
                              "host-side staging copies")
            b.add_u64(l_devprof_device_mem_highwater,
                      "device_mem_highwater_bytes",
                      "peak device memory observed at sample time")
            _devprof_pc = b.create_perf_counters()
    return _devprof_pc


def transfer_size_axes() -> List[PerfHistogramAxis]:
    """1D transfer-size(bytes, log2) — the distribution of individual
    host↔device transfer sizes.  Dimensionless axis name (no ``_usec``
    suffix), so the mgr renderer exports raw byte edges."""
    return [PerfHistogramAxis("transfer_size_bytes", min=0,
                              quant_size=512, buckets=32,
                              scale_type=SCALE_LOG2)]


# the stage whose device work is currently being attributed (a build
# carries no call-site; the innermost stage() scope claims it)
_stage: contextvars.ContextVar[Optional[str]] = \
    contextvars.ContextVar("ceph_tpu_torch_devprof_stage", default=None)


class DevFlowProfiler:
    """Per-call-site host↔device flow accounting.

    Always-on like perf counters: an account call is dict/int math
    under a lock — no device syncs, no per-sample allocation beyond
    the ledger entry when span tracing is enabled.

    ``mirror_counters``: only the process singleton (``g_devprof``)
    mirrors into the process-wide ``devprof`` perf-counter logger and
    transfer-size histogram; a standalone instance (unit tests) keeps
    its accounting to itself so it cannot pollute the exported
    surfaces, and its ``dump()`` omits the counter block it does not
    own.
    """

    def __init__(self, mirror_counters: bool = False):
        self._lock = DebugLock("DeviceFlowProfiler::lock")
        # site -> {h2d_bytes, h2d_count, d2h_bytes, d2h_count,
        #          host_copy_bytes, host_copies, compiles}
        self._sites: Dict[str, Dict[str, int]] = {}
        self._mem_highwater = 0
        self._mirror = mirror_counters

    # ---- core accounting ---------------------------------------------------
    def _site(self, site: str) -> Dict[str, int]:
        s = self._sites.get(site)
        if s is None:
            s = self._sites[site] = {
                "h2d_bytes": 0, "h2d_count": 0,
                "d2h_bytes": 0, "d2h_count": 0,
                "host_copy_bytes": 0, "host_copies": 0,
                "compiles": 0,
            }
        return s

    @property
    def _hist(self):
        return g_perf_histograms.get(
            "devprof", "devprof_transfer_size_histogram",
            transfer_size_axes)

    def _ledger(self, site: str, direction: str, nbytes: int) -> None:
        """Append a copy-ledger entry to the active span (host-side
        only; a no-op unless the span tracer is enabled)."""
        cur = g_tracer.current()
        if cur is not None:
            cur.tags.setdefault("copy_ledger", []).append(
                {"stage": site, "dir": direction, "bytes": int(nbytes)})

    def account_h2d(self, site: str, nbytes: int) -> None:
        """One host→device transfer of *nbytes* at *site*."""
        nbytes = int(nbytes)
        if self._mirror:
            pc = devprof_perf_counters()
            pc.inc(l_devprof_h2d_bytes, nbytes)
            pc.inc(l_devprof_h2d_transfers)
            self._hist.inc(nbytes)
        with self._lock:
            s = self._site(site)
            s["h2d_bytes"] += nbytes
            s["h2d_count"] += 1
        if g_tracer.enabled:
            self._ledger(site, H2D, nbytes)

    def account_d2h(self, site: str, nbytes: int) -> None:
        """One device→host materialization of *nbytes* at *site*."""
        nbytes = int(nbytes)
        if self._mirror:
            pc = devprof_perf_counters()
            pc.inc(l_devprof_d2h_bytes, nbytes)
            pc.inc(l_devprof_d2h_transfers)
            self._hist.inc(nbytes)
        with self._lock:
            s = self._site(site)
            s["d2h_bytes"] += nbytes
            s["d2h_count"] += 1
        if g_tracer.enabled:
            self._ledger(site, D2H, nbytes)

    def account_host_copy(self, site: str, nbytes: int) -> None:
        """One host-side staging copy (pad, stack, message build) —
        counted toward the per-op copy ledger but not toward transfer
        bytes (nothing crossed the PCIe/tunnel boundary)."""
        nbytes = int(nbytes)
        if self._mirror:
            pc = devprof_perf_counters()
            pc.inc(l_devprof_host_copy_bytes, nbytes)
            pc.inc(l_devprof_host_copies)
        with self._lock:
            s = self._site(site)
            s["host_copy_bytes"] += nbytes
            s["host_copies"] += 1
        if g_tracer.enabled:
            self._ledger(site, HOST, nbytes)

    # ---- compile detection (one nvcc run per build cache miss) ------------
    def note_compile(self) -> None:
        """One fresh kernel build (an ``nvcc`` run), attributed to the
        active ``stage()`` scope; ``ops/_build.py`` calls it on the
        singleton."""
        if self._mirror:
            devprof_perf_counters().inc(l_devprof_compiles)
        site = _stage.get() or "unattributed"
        with self._lock:
            self._site(site)["compiles"] += 1
        if g_tracer.enabled:
            g_tracer.event("nvcc_compile", site=site)

    @contextlib.contextmanager
    def stage(self, site: str):
        """Attribute compiles inside the block to *site* (the compile
        event carries no call-site of its own)."""
        token = _stage.set(site)
        try:
            yield
        finally:
            _stage.reset(token)

    # ---- device memory (sampled at dump/scrape time, never per-op) ---------
    def sample_device_mem(self) -> Dict[str, Any]:
        """Update the high-water gauge from ``torch.cuda.memory_stats``
        of the current card (allocated bytes now and at peak).  A process
        without a card reports source ``"none"``; an error on the card
        raises.  Never syncs."""
        out: Dict[str, Any] = {"source": "none", "bytes_in_use": 0,
                               "peak_bytes_in_use": 0}
        if not torch.cuda.is_available():
            return out
        stats = torch.cuda.memory_stats(torch.cuda.current_device())
        out["source"] = "memory_stats"
        out["bytes_in_use"] = int(stats.get("allocated_bytes.all.current", 0))
        out["peak_bytes_in_use"] = int(stats.get("allocated_bytes.all.peak",
                                                 out["bytes_in_use"]))
        with self._lock:
            self._mem_highwater = max(self._mem_highwater,
                                      out["peak_bytes_in_use"])
            out["highwater_bytes"] = self._mem_highwater
        if self._mirror:
            devprof_perf_counters().set(l_devprof_device_mem_highwater,
                                        self._mem_highwater)
        return out

    # ---- views -------------------------------------------------------------
    @staticmethod
    def _totals_of(sites: Dict[str, Dict[str, int]]) -> Dict[str, int]:
        t = {"h2d_bytes": 0, "h2d_count": 0, "d2h_bytes": 0,
             "d2h_count": 0, "host_copy_bytes": 0, "host_copies": 0,
             "compiles": 0}
        for s in sites.values():
            for k in t:
                t[k] += s[k]
        t["transfers"] = t["h2d_count"] + t["d2h_count"]
        return t

    def totals(self) -> Dict[str, int]:
        with self._lock:
            sites = {k: dict(v) for k, v in self._sites.items()}
        return self._totals_of(sites)

    def snapshot(self) -> Dict[str, int]:
        """Cheap totals snapshot for before/after deltas (the bench
        workloads' devflow blocks).  CALIBRATION_SITES are excluded
        here — and therefore from the copy-budget gate — so a skew
        probe firing inside a measured region cannot read as a new
        per-op copy chain; ``totals()``/``dump()`` keep every site."""
        with self._lock:
            sites = {k: dict(v) for k, v in self._sites.items()
                     if k not in CALIBRATION_SITES}
        return self._totals_of(sites)

    def dump(self) -> Dict[str, Any]:
        """The ``prof dump`` admin-socket shape: per-site table,
        totals, the counter logger, transfer-size summary, and a fresh
        device-memory sample.  The full histogram grid stays on
        ``perf histogram dump`` (logger ``devprof``)."""
        with self._lock:
            sites = {k: dict(v) for k, v in sorted(self._sites.items())}
        # totals derive from the SAME snapshot as the sites table, so
        # one dump is internally consistent under concurrent accounting
        out: Dict[str, Any] = {
            "sites": sites,
            "totals": self._totals_of(sites),
            "device_mem": self.sample_device_mem(),
        }
        if self._mirror:
            # the counter/histogram surfaces are process-wide; only
            # the singleton that feeds them may report them as its own
            hist = self._hist
            out["counters"] = devprof_perf_counters().dump()
            out["transfer_size_histogram"] = {
                "count": hist.total_count, "sum_bytes": hist.axis0_sum}
        return out

    def reset(self) -> None:
        """``prof reset``: zero the per-site table, the counter logger
        and the transfer-size histogram (high-water restarts too)."""
        with self._lock:
            self._sites.clear()
            self._mem_highwater = 0
        if not self._mirror:
            return
        pc = devprof_perf_counters()
        for idx in range(l_devprof_h2d_bytes,
                         l_devprof_device_mem_highwater + 1):
            pc.set(idx, 0)
        self._hist.reset()


g_devprof = DevFlowProfiler(mirror_counters=True)


def devflow_delta(before: Dict[str, int], after: Dict[str, int],
                  n_ops: int) -> Dict[str, Any]:
    """The bench ``devflow`` block: flow deltas over a measured region
    normalized per op.  ``copies_per_op`` counts every accounted copy
    (transfers + host staging copies) — the number the zero-copy
    refactors must drive down; ``bytes_per_op`` counts boundary bytes
    only."""
    d = {k: int(after.get(k, 0)) - int(before.get(k, 0))
         for k in ("h2d_bytes", "d2h_bytes", "h2d_count", "d2h_count",
                   "host_copies", "host_copy_bytes", "compiles")}
    transfers = d["h2d_count"] + d["d2h_count"]
    ops = max(int(n_ops), 1)
    return {
        "h2d_bytes": d["h2d_bytes"],
        "d2h_bytes": d["d2h_bytes"],
        "transfers": transfers,
        "compiles": d["compiles"],
        "host_copies": d["host_copies"],
        "copies_per_op": round((transfers + d["host_copies"]) / ops, 4),
        "bytes_per_op": round(
            (d["h2d_bytes"] + d["d2h_bytes"]) / ops, 2),
    }
