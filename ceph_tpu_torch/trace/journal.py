"""Cluster event journal — the always-on black box.

Port of ``ceph_tpu/trace/journal.py``, the same behaviour under the same names.

Every daemon appends typed structured events (health transitions,
breaker trips, chip SUSPECT verdicts, control actuations, fault
injections, OSD state changes, mon elections, slow ops, SLO streaks)
to a bounded per-daemon ring.  Each event is stamped with the
deterministic cluster clock — set once per mgr tick, never read from
the wall — plus a per-daemon monotone sequence number and a
process-global sequence number ``gseq``.

``gseq`` is the causal merge key: the cluster is a single process, so
emission order IS causal order; the clock is a human-readable stamp,
not the sort key.  ``merged()`` returns one cluster timeline ordered
by ``gseq`` — the same rollup discipline as ``Telemetry.rollup``, but
for discrete events instead of gauges.

Emission is pure host work: one lock (``EventJournal::lock``, taken
last — emitters may hold their own lock, the journal never takes
theirs) and a list append.  Zero device syncs by construction.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from ..common.config import g_conf
from ..common.lockdep import DebugLock
from ..common.perf_counters import PerfCounters, PerfCountersBuilder

# ---------------------------------------------------------------------------
# event catalog — every type the cluster can journal (docs/OBSERVABILITY.md
# "Event journal & incident forensics" documents each one)

EVENT_TYPES = (
    "health_raise",        # mgr: a health check entered health_checks
    "health_clear",        # mgr: a health check left health_checks
    "breaker_trip",        # fault: consecutive failures opened a breaker
    "breaker_half_open",   # fault: half-open probe failed, cooldown re-armed
    "breaker_restore",     # fault: success closed an open breaker
    "chip_suspect_mark",   # mesh: chip crossed the skew streak threshold
    "chip_suspect_clear",  # mesh: chip produced enough clean probes
    "control_actuate",     # mgr: controller applied a knob move
    "control_restore",     # mgr: controller teardown restored a knob to base
    "control_pinned",      # mgr: a reflex wanted to move a hand-pinned knob
    "fault_arm",           # fault: a FaultSpec was injected at a site
    "fault_fire",          # fault: an armed spec fired at its site
    "fault_clear",         # fault: spec(s) cleared from a site
    "osd_up",              # mon: osd marked up
    "osd_down",            # mon: osd marked down
    "osd_out",             # mon: osd marked out
    "osd_in",              # mon: osd marked in
    "mon_election",        # mon: election decided, quorum formed
    "slow_op",             # osd: op exceeded complaint_time
    "slo_streak",          # mgr: SLO sustain/clear streak opened
    "incident_capture",    # mgr: incident bundle captured into the archive
    "incident_drop",       # mgr: capture failed, bundle dropped
    "incident_resolve",    # mgr: open incident's triggering check cleared
    "mesh_chip_add",       # mesh: elastic membership grew the dispatch mesh
    "mesh_chip_retire",    # mesh: elastic membership retired mesh chip(s)
    "mesh_decode_degraded",  # mesh: meshed decode/repair fell back to
                             # the single-device path (guard exhausted)
    "chaos_scenario_start",  # chaos: a composed storyline began executing
    "chaos_event",         # chaos: one scheduled storyline step fired
    "chaos_scenario_end",  # chaos: storyline finished, acceptance judged
)

_EVENT_SET = frozenset(EVENT_TYPES)

# ---------------------------------------------------------------------------
# perf counters — logger "journal" (rendered ceph_daemon_journal_*)

JOURNAL_FIRST = 95100
l_journal_events = 95101       # events appended across all daemon rings
l_journal_evictions = 95102    # events evicted by the bounded ring
l_journal_resets = 95103       # operator journal resets
JOURNAL_LAST = 95110

_journal_pc: Optional[PerfCounters] = None
_journal_pc_lock = DebugLock("journal_pc::init")


def journal_perf_counters() -> PerfCounters:
    global _journal_pc
    if _journal_pc is None:
        with _journal_pc_lock:
            if _journal_pc is None:
                b = PerfCountersBuilder("journal", JOURNAL_FIRST,
                                        JOURNAL_LAST)
                b.add_u64_counter(l_journal_events, "events",
                                  "Events appended to daemon journals")
                b.add_u64_counter(l_journal_evictions, "evictions",
                                  "Events evicted from bounded rings")
                b.add_u64_counter(l_journal_resets, "resets",
                                  "Operator journal resets")
                _journal_pc = b.create_perf_counters()
    return _journal_pc


class EventJournal:
    """Bounded per-daemon rings of typed events, merged on demand.

    The ring bound is read live from ``mgr_journal_ring_size`` on
    every append, so ``injectargs`` takes effect immediately — a
    shrink evicts down to the new bound on the next emit.
    """

    def __init__(self) -> None:
        self._lock = DebugLock("EventJournal::lock")
        self._rings: Dict[str, List[dict]] = {}
        self._seq: Dict[str, int] = {}
        self._gseq = 0
        self._clock = 0.0

    # -- clock ----------------------------------------------------------
    def set_clock(self, now: float) -> None:
        """Stamp clock for subsequent events (mgr tick sets this)."""
        with self._lock:
            self._clock = float(now)

    def clock(self) -> float:
        with self._lock:
            return self._clock

    # -- emission -------------------------------------------------------
    def emit(self, daemon: str, etype: str, **fields: Any) -> dict:
        """Append one typed event to *daemon*'s ring.

        Takes only the journal's own lock — callers may already hold
        theirs (ChipStat::lock, OpTracker::lock, ...).  Never raises
        past a bad event type; unknown types mean a coding error.
        """
        if etype not in _EVENT_SET:
            raise ValueError(f"unknown journal event type '{etype}'")
        cap = int(g_conf.get_val("mgr_journal_ring_size"))
        evicted = 0
        with self._lock:
            self._gseq += 1
            seq = self._seq.get(daemon, 0) + 1
            self._seq[daemon] = seq
            ev = {"gseq": self._gseq, "seq": seq, "daemon": daemon,
                  "clock": round(self._clock, 3), "type": etype}
            ev.update(fields)
            ring = self._rings.setdefault(daemon, [])
            ring.append(ev)
            if cap > 0 and len(ring) > cap:
                evicted = len(ring) - cap
                del ring[:evicted]
        pc = journal_perf_counters()
        pc.inc(l_journal_events)
        if evicted:
            pc.inc(l_journal_evictions, evicted)
        return ev

    # -- read side ------------------------------------------------------
    def merged(self, tail: int = 0) -> List[dict]:
        """One cluster timeline, causally ordered by ``gseq``."""
        with self._lock:
            events: List[dict] = []
            for ring in self._rings.values():
                events.extend(ring)
        events.sort(key=lambda e: e["gseq"])
        if tail > 0:
            events = events[-tail:]
        return [dict(e) for e in events]

    def merged_since(self, gseq: int, tail: int = 0) -> List[dict]:
        """Events with ``gseq`` strictly greater than *gseq*."""
        events = [e for e in self.merged() if e["gseq"] > gseq]
        if tail > 0:
            events = events[-tail:]
        return events

    def last_gseq(self) -> int:
        with self._lock:
            return self._gseq

    def dump(self, daemon: str = "") -> dict:
        """asok ``journal dump`` shape."""
        with self._lock:
            names = [daemon] if daemon else sorted(self._rings)
            out = {
                "clock": round(self._clock, 3),
                "gseq": self._gseq,
                "daemons": {
                    d: {"seq": self._seq.get(d, 0),
                        "events": [dict(e)
                                   for e in self._rings.get(d, [])]}
                    for d in names
                },
            }
        return out

    def reset(self) -> dict:
        """Operator ``journal reset`` — drop all rings, keep sequences
        (they are monotone per daemon for the process lifetime)."""
        with self._lock:
            dropped = sum(len(r) for r in self._rings.values())
            self._rings.clear()
        journal_perf_counters().inc(l_journal_resets)
        return {"dropped": dropped}


# process-wide journal, like g_tracer / g_faults
g_journal = EventJournal()
