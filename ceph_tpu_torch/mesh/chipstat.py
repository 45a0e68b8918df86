"""Per-chip timing telemetry — the chip-health scoreboard.

The mesh runtime (runtime.py) shards every flushed encode batch across
N chips, but until this module the observability stack stopped at the
device boundary: oplat's ``device_call`` stage is one number for the
whole mesh and ``dispatch_chip_occupancy_histogram`` counts stripes,
not microseconds — a chip running 10x slow was invisible.  The
straggler-proof rateless-coding ROADMAP item (arxiv 1804.10331) needs
exactly that signal, and this repo's discipline is
build-the-ruler-before-the-fix (devprof before zero-copy, oplat before
mesh): this is the chip-level ruler, in the spirit of per-worker
straggler detection in coded-computation systems (arxiv 2108.02692:
movement/imbalance, not math, dominates at small chunks).

Three pieces:

- **Sampled fenced probes**: every Nth mesh flush
  (``ec_mesh_skew_sample_every``; 0 = off) the runtime drains ONE
  element from each chip's shard of the coalesced output — the
  ``parallel/ec.py`` ``drain_sharded`` one-readback-per-shard trick —
  and records each chip's completion delta (launch → that chip's
  readback returning) into the 2-D ``mesh_chip_latency_histogram``
  (usec × chip_index) and the per-chip totals table.  Probe readbacks
  are devprof-accounted under the dedicated ``mesh.skew_probe`` site
  and EXCLUDED from the copy-budget gate (calibration flow, the same
  policy as drain fences — devprof.CALIBRATION_SITES).  The OSD tick
  arms a cadence floor: traffic that flushed since the last probe
  guarantees the NEXT flush probes, so a low flush rate cannot starve
  the signal.
- **Chip-health scoreboard**: an EWMA of each chip's probe delta vs
  the mesh median yields the REPORTED per-chip skew ratio; the
  sustain/clear streaks count each probe's INSTANTANEOUS delta vs
  that probe's median (one spiked probe can never ride a decaying
  EWMA through the sustain window).  A chip breaching
  ``ec_mesh_skew_threshold`` on ``SKEW_SUSTAIN_PROBES`` consecutive
  probes is marked SUSPECT, and clears only after
  ``SKEW_CLEAR_PROBES`` consecutive clean probes — the circuit
  breaker's sustain/clear hysteresis discipline applied to chip
  health.  Surfaces: ``ceph_daemon_mesh_chip_*`` counters, the
  ``mesh skew dump`` asok command, the skew block on
  ``dispatch dump``'s mesh pane, and the hysteretic ``TPU_MESH_SKEW``
  health check the mgr raises (mgr.check_mesh_skew) naming the
  suspect chip and its ratio.
- **The straggler ruler**: the ``ec_mesh_skew`` bench workload runs
  the mesh twin healthy vs one-chip-slowed (fault site
  ``mesh.chip_slowdown``) and bench/regress.py's SKEW GATE asserts
  detection fires within K probes while the healthy run stays quiet —
  the acceptance instrument the rateless straggler PR is gated on.

Probing never changes the data path: the drained elements come from
the same coalesced output the flush materializes anyway, so mesh-on
clusters with sampling enabled stay byte-exact (property-tested).
Port of ``ceph_tpu/mesh/chipstat.py``: the scoreboard (cadence,
``record_deltas``, hysteresis, views, counters) is host code and is
carried whole.  ``probe`` polls each member's CUDA event where JAX polls
``Array.is_ready`` on each shard (on the CPU every piece is ready when
its call returns).  A "chip" here is a mesh member; members that share
one card are probed one by one all the same.
"""
from __future__ import annotations

import time

from ..common.lockdep import DebugLock
from typing import Any, Dict, List, Optional

from ..common.config import g_conf
from ..common.perf_counters import PerfCounters, PerfCountersBuilder
from ..trace.histogram import (PerfHistogramAxis, SCALE_LINEAR,
                               SCALE_LOG2, g_perf_histograms,
                               percentiles_from_counts)
from ..trace.journal import g_journal

# hysteresis discipline (the breaker's sustain/clear shape): a chip
# must breach the threshold on this many CONSECUTIVE probes to be
# marked suspect, and produce this many consecutive clean probes to
# clear — a single slow probe (GC pause, tunnel hiccup) never flaps it
SKEW_SUSTAIN_PROBES = 3
SKEW_CLEAR_PROBES = 3

# EWMA smoothing for per-chip service time: responsive enough that a
# genuinely slow chip dominates its average within the sustain window,
# smooth enough that one outlier probe cannot breach alone
EWMA_ALPHA = 0.4

# ---- perf counters (perf dump / Prometheus ceph_daemon_mesh_chip_*) --------
MESH_CHIP_FIRST = 99000
l_chip_probes = 99001            # probe flushes executed
l_chip_samples = 99002           # per-chip completion deltas recorded
l_chip_slowdowns_injected = 99003  # mesh.chip_slowdown fires observed
l_chip_suspects_marked = 99004   # chips marked suspect (sustained skew)
l_chip_suspects_cleared = 99005  # suspects cleared (sustained clean)
l_chip_suspect_chips = 99006     # gauge: chips currently suspect
l_chip_max_skew_permille = 99007  # gauge: worst chip EWMA/median, 1/1000
MESH_CHIP_LAST = 99010

_chip_pc: Optional[PerfCounters] = None
_chip_pc_lock = DebugLock("mesh_chip_pc::init")


def mesh_chip_perf_counters() -> PerfCounters:
    """The chip-health scoreboard's counter logger (perf dump /
    Prometheus ``ceph_daemon_mesh_chip_*``)."""
    global _chip_pc
    if _chip_pc is not None:
        return _chip_pc
    with _chip_pc_lock:
        if _chip_pc is None:
            b = PerfCountersBuilder("mesh_chip", MESH_CHIP_FIRST,
                                    MESH_CHIP_LAST)
            b.add_u64_counter(l_chip_probes, "probes",
                              "sampled fenced skew probes executed")
            b.add_u64_counter(l_chip_samples, "samples",
                              "per-chip completion deltas recorded")
            b.add_u64_counter(l_chip_slowdowns_injected,
                              "slowdowns_injected",
                              "mesh.chip_slowdown fault fires observed "
                              "during probes")
            b.add_u64_counter(l_chip_suspects_marked, "suspects_marked",
                              "chips marked suspect after sustained "
                              "skew over the threshold")
            b.add_u64_counter(l_chip_suspects_cleared,
                              "suspects_cleared",
                              "suspect chips cleared after sustained "
                              "clean probes")
            b.add_u64(l_chip_suspect_chips, "suspect_chips",
                      "chips currently marked suspect (gauge)")
            b.add_u64(l_chip_max_skew_permille, "max_skew_permille",
                      "worst per-chip EWMA/median skew ratio in "
                      "thousandths (gauge)")
            _chip_pc = b.create_perf_counters()
    return _chip_pc


def chip_latency_axes() -> List[PerfHistogramAxis]:
    """2-D per-chip probe latency: axis 0 = the chip's completion
    delta in usec (log2 — the ``_usec`` suffix makes the mgr renderer
    export the edges scaled to seconds like every latency family),
    axis 1 = the chip's index in the mesh (linear unit buckets,
    dimensionless name so the renderer exports RAW edges — the
    chip-occupancy axis convention)."""
    return [PerfHistogramAxis("probe_usec", min=0, quant_size=2,
                              buckets=32, scale_type=SCALE_LOG2),
            PerfHistogramAxis("chip_index", min=0, quant_size=1,
                              buckets=66, scale_type=SCALE_LINEAR)]


def slowdown_delays(n_chips: int) -> Dict[int, float]:
    """THE ``mesh.chip_slowdown`` decision pass, shared by the SPMD
    probe (ChipStat.probe) and the rateless drain (rateless.py) so
    the ctx format (``chip=<i>/<n>`` — what ``match=`` scopes) and
    the ``slowdowns_injected`` accounting cannot drift: one decision
    per chip per probe/flush, before the clock starts, returning
    chip index -> hold-not-complete-for microseconds."""
    from ..fault import g_faults
    delay_until: Dict[int, float] = {}
    if g_faults.site_armed("mesh.chip_slowdown"):
        spec = g_faults.armed("mesh.chip_slowdown")
        delay_us = spec.delay_us if spec is not None else 0
        pc = mesh_chip_perf_counters()
        for i in range(n_chips):
            if g_faults.should_fire("mesh.chip_slowdown",
                                    ctx=f"chip={i}/{n_chips}"):
                pc.inc(l_chip_slowdowns_injected)
                delay_until[i] = delay_us
    return delay_until


class ChipStat:
    """Per-chip probe recorder + hysteretic skew scoreboard."""

    def __init__(self):
        self._lock = DebugLock("ChipStat::lock")
        self._flushes = 0            # mesh flushes seen (probe cadence)
        self._probes = 0             # probe flushes executed
        self._flushes_since_probe = 0
        self._force_probe = False    # OSD-tick cadence floor
        # chip index -> scoreboard row
        self._chips: Dict[int, Dict[str, Any]] = {}
        # chip index -> per-axis0-bucket counts (per-chip percentiles;
        # the 2-D histogram grid serves the export surfaces)
        self._buckets: Dict[int, List[int]] = {}
        self._axis0 = chip_latency_axes()[0]

    # ---- options (read live so `config set` applies without restart) ------
    @staticmethod
    def _opts() -> tuple:
        return (int(g_conf.get_val("ec_mesh_skew_sample_every") or 0),
                float(g_conf.get_val("ec_mesh_skew_threshold") or 0.0))

    @property
    def _hist(self):
        return g_perf_histograms.get("mesh",
                                     "mesh_chip_latency_histogram",
                                     chip_latency_axes)

    # ---- probe cadence -----------------------------------------------------
    def should_probe(self) -> bool:
        """Called once per mesh flush by the runtime: True when this
        flush should drain per-chip probes.  Cadence is every Nth
        flush (``ec_mesh_skew_sample_every``; 0 = off) plus the OSD
        tick's cadence floor (``tick_kick``)."""
        every, _thr = self._opts()
        with self._lock:
            self._flushes += 1
            if every <= 0:
                self._force_probe = False
                self._flushes_since_probe += 1
                return False
            if self._force_probe or self._flushes % every == 0:
                self._force_probe = False
                return True
            self._flushes_since_probe += 1
            return False

    def tick_kick(self) -> None:
        """The OSD tick's probe-cadence floor: when sampling is on and
        traffic has flushed since the last probe, arm the NEXT flush
        to probe regardless of the Nth-flush counter — a low flush
        rate (long windows, quiet cluster) must not starve the skew
        signal.  Pure int reads; zero cost with sampling off."""
        every, _thr = self._opts()
        if every <= 0:
            return
        with self._lock:
            if self._flushes_since_probe > 0:
                self._force_probe = True

    # polling granularity for the readiness loop: coarse enough that a
    # probe costs microseconds of host time, fine next to the 10x-class
    # deltas the scoreboard exists to catch
    PROBE_POLL_S = 1e-4

    # ---- the probe itself --------------------------------------------------
    def probe(self, out, mesh) -> None:
        """Drain one element from every member's piece of *out* (the
        coalesced ``Sharded`` output, before the full gather) and record
        each member's completion delta.  The fetch from member i's piece
        is the only proof member i finished (drain_sharded's contract),
        but a fixed-order drain would charge a straggler's stall to every
        member drained after it, so the probe POLLS readiness (the
        member's CUDA event, non-blocking) and reads each piece back the
        moment it completes: the delta is launch-to-THAT-member's
        completion, order-free.  Each tiny fetch is accounted under the
        ``mesh.skew_probe`` devprof site, a CALIBRATION site the
        copy-budget gate excludes, like the bench drain fences.

        The ``mesh.chip_slowdown`` fault site fires here, scoped by
        ``match=`` on the ``chip=<i>/<n>`` context: an armed trigger
        holds the matching member "not complete" for ``delay_us`` past
        launch (the probe, and the flush behind it, genuinely waits)."""
        from ..trace.devprof import g_devprof

        shards = getattr(out, "addressable_shards", None)
        if not shards:
            return
        n_shards = len(shards)
        # one injection decision per chip per probe, before the clock
        # starts (a mid-poll re-arm must not split one probe's view)
        delay_until = slowdown_delays(n_shards)
        pending = dict(enumerate(shards))
        deltas: Dict[int, float] = {}
        t0 = time.perf_counter()
        while pending:
            elapsed_us = (time.perf_counter() - t0) * 1e6
            for i in sorted(pending):
                if elapsed_us < delay_until.get(i, 0.0):
                    continue    # injected straggler: not complete yet
                if not pending[i].is_ready():
                    continue
                pending[i].fetch(1)   # THE fence: member i's readback
                g_devprof.account_d2h("mesh.skew_probe", 1)
                deltas[i] = (time.perf_counter() - t0) * 1e6
                del pending[i]
            if pending:
                time.sleep(self.PROBE_POLL_S)
        self._record(deltas)

    def record_deltas(self, deltas: Dict[int, float]) -> None:
        """The rateless drain's probe entry (rateless.py): on probe
        flushes the subset-completion drain measures each chip's
        completion delta itself — same scoreboard, same hysteresis,
        no separate element readbacks (the drain's fetches ARE the
        data path).  Censoring policy lives in the drain: a recorded
        delta is either exact or provably-at-least (never fabricated),
        so the sustain/clear semantics are unchanged."""
        self._record(deltas)

    def suspect_set(self) -> set:
        """Chip indices currently marked suspect — the placement
        feedback the rateless coder deweights by (cheap locked read,
        once per flush)."""
        with self._lock:
            return {i for i, r in self._chips.items() if r["suspect"]}

    def _record(self, deltas: Dict[int, float]) -> None:
        every, threshold = self._opts()
        pc = mesh_chip_perf_counters()
        pc.inc(l_chip_probes)
        pc.inc(l_chip_samples, len(deltas))
        hist = self._hist
        with self._lock:
            self._probes += 1
            self._flushes_since_probe = 0
            probe_seq = self._probes
            for i, usec in deltas.items():
                hist.inc(usec, i)
                row = self._chips.get(i)
                if row is None:
                    row = self._chips[i] = {
                        "probes": 0, "total_usec": 0.0,
                        "last_usec": 0.0, "ewma_usec": 0.0,
                        "skew_ratio": 0.0, "suspect": False,
                        "streak": 0, "clean": 0,
                        "suspect_since_probe": 0}
                row["probes"] += 1
                row["total_usec"] += usec
                row["last_usec"] = round(usec, 1)
                row["ewma_usec"] = usec if row["probes"] == 1 else (
                    EWMA_ALPHA * usec
                    + (1.0 - EWMA_ALPHA) * row["ewma_usec"])
                b = self._axis0.bucket_for(usec)
                counts = self._buckets.get(i)
                if counts is None:
                    counts = self._buckets[i] = \
                        [0] * self._axis0.buckets
                counts[b] += 1
            self._score(probe_seq, threshold, pc, deltas)

    @staticmethod
    def _median(values) -> float:
        vs = sorted(values)
        n = len(vs)
        if not n:
            return 0.0
        return vs[n // 2] if n % 2 \
            else 0.5 * (vs[n // 2 - 1] + vs[n // 2])

    def _score(self, probe_seq: int, threshold: float, pc,
               deltas: Dict[int, float]) -> None:
        """One scoreboard pass (caller holds the lock).

        TWO ratios, two jobs: the REPORTED ``skew_ratio`` is the
        chip's EWMA service time over the mesh's EWMA median (the
        smoothed figure the health check and dumps name); the
        sustain/clear STREAKS count THIS probe's instantaneous delta
        over this probe's median — one spiked probe breaches exactly
        one streak tick and resets on the next clean probe, it can
        never ride a decaying EWMA through the sustain window (the
        breaker's consecutive-failures discipline, counted in
        probes)."""
        rows = [r for r in self._chips.values() if r["probes"] > 0]
        if len(rows) < 2:
            return
        ewma_median = self._median(r["ewma_usec"] for r in rows)
        inst_median = self._median(deltas.values())
        if ewma_median <= 0 or inst_median <= 0:
            return
        worst = 0.0
        for i, row in self._chips.items():
            ratio = row["ewma_usec"] / ewma_median
            row["skew_ratio"] = round(ratio, 3)
            worst = max(worst, ratio)
            if threshold <= 0 or i not in deltas:
                continue
            if deltas[i] / inst_median >= threshold:
                row["streak"] += 1
                row["clean"] = 0
            else:
                row["streak"] = 0
                row["clean"] += 1
            if not row["suspect"] \
                    and row["streak"] >= SKEW_SUSTAIN_PROBES:
                row["suspect"] = True
                row["suspect_since_probe"] = probe_seq
                pc.inc(l_chip_suspects_marked)
                # journal emit takes only the journal's own lock
                # (ChipStat::lock -> EventJournal::lock is the one
                # nesting this module introduces)
                g_journal.emit("mesh", "chip_suspect_mark", chip=i,
                               probe=probe_seq,
                               skew_ratio=row["skew_ratio"])
            elif row["suspect"] and row["clean"] >= SKEW_CLEAR_PROBES:
                row["suspect"] = False
                row["suspect_since_probe"] = 0
                pc.inc(l_chip_suspects_cleared)
                g_journal.emit("mesh", "chip_suspect_clear", chip=i,
                               probe=probe_seq)
        pc.set(l_chip_suspect_chips,
               sum(1 for r in self._chips.values() if r["suspect"]))
        pc.set(l_chip_max_skew_permille, int(worst * 1000))

    # ---- views -------------------------------------------------------------
    def suspects(self) -> List[Dict[str, Any]]:
        """Chips currently marked suspect, worst first — the mgr's
        TPU_MESH_SKEW source and the tpu status pane."""
        with self._lock:
            out = [{"chip": i, "skew_ratio": r["skew_ratio"],
                    "ewma_usec": round(r["ewma_usec"], 1),
                    "since_probe": r["suspect_since_probe"]}
                   for i, r in sorted(self._chips.items())
                   if r["suspect"]]
        out.sort(key=lambda s: -s["skew_ratio"])
        return out

    def per_chip_percentiles(self, qs=(0.5, 0.99)) -> Dict[int, Dict]:
        """Per-chip probe-latency percentiles from the per-chip bucket
        series (same edges as the 2-D histogram's usec axis) — the
        p99-spread figure the skew workload reports."""
        edges = self._axis0.upper_edges()
        with self._lock:
            snap = {i: list(c) for i, c in self._buckets.items()}
        return {i: percentiles_from_counts(c, edges, qs)
                for i, c in sorted(snap.items())}

    def summary(self) -> Dict[str, Any]:
        """The compact scoreboard block (``dispatch dump``'s mesh pane
        and ``tpu status``): options, probe counts, per-chip EWMA /
        ratio / suspect rows, current suspects."""
        every, threshold = self._opts()
        with self._lock:
            per_chip = {
                i: {"probes": r["probes"],
                    "last_usec": r["last_usec"],
                    "ewma_usec": round(r["ewma_usec"], 1),
                    "skew_ratio": r["skew_ratio"],
                    "suspect": r["suspect"]}
                for i, r in sorted(self._chips.items())}
            flushes, probes = self._flushes, self._probes
        return {
            "options": {"ec_mesh_skew_sample_every": every,
                        "ec_mesh_skew_threshold": threshold},
            "sustain_probes": SKEW_SUSTAIN_PROBES,
            "clear_probes": SKEW_CLEAR_PROBES,
            "flushes": flushes,
            "probes": probes,
            "per_chip": per_chip,
            "suspects": self.suspects(),
        }

    def dump(self) -> Dict[str, Any]:
        """The ``mesh skew dump`` admin-socket shape: the summary plus
        per-chip percentiles and the counter logger."""
        out = self.summary()
        out["per_chip_percentiles"] = {
            str(i): p for i, p in self.per_chip_percentiles().items()}
        out["counters"] = mesh_chip_perf_counters().dump()
        return out

    def reset(self) -> None:
        """``mesh skew reset``: drop the scoreboard, the per-chip
        series, the 2-D histogram and the counter logger (probe
        cadence restarts too)."""
        with self._lock:
            self._flushes = 0
            self._probes = 0
            self._flushes_since_probe = 0
            self._force_probe = False
            self._chips.clear()
            self._buckets.clear()
        self._hist.reset()
        pc = mesh_chip_perf_counters()
        for idx in range(MESH_CHIP_FIRST + 1, MESH_CHIP_LAST):
            try:
                pc.set(idx, 0)
            except (KeyError, AssertionError):
                pass


# process-wide scoreboard, like g_mesh: one accelerator complex per
# process, shared by every daemon the mini-cluster hosts
g_chipstat = ChipStat()
