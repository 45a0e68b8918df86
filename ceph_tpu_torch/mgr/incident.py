"""Incident forensics — auto-captured diagnostic bundles.

The event journal (trace/journal.py) answers "what happened, in
order"; this module answers "what did the cluster LOOK like at the
moment it went wrong".  On any health-check RAISE the mgr's tick calls
:meth:`IncidentManager.capture`, which snapshots one bundle — the
triggering check and its SLO streak state, the merged timeline tail,
the cluster rollup, the worst historic slow ops with their stage and
copy ledgers, the chip scoreboard, and the control plane's
episode/ledger state — into a bounded archive
(``mgr_incident_retention``).  When the triggering check later CLEARS,
the open incident is finalized: the timeline grows every event since
capture (actuations, restores, the clear itself), so a resolved
bundle tells the whole raise→react→recover story by itself.

Capture runs under the bounded fault site ``mgr.incident_capture``: a
failing capture drops the bundle (counted, journaled) and the tick
proceeds — forensics must never wedge the cluster it is documenting.
Everything here is pure host-side dict assembly: zero device syncs
(fence-count-pinned in tests/test_observability.py).

Port of ``ceph_tpu/mgr/incident.py``.  The JAX bundle also carries
``breakers_open`` (the codec circuit breakers tripped to the CPU path);
the port has no breakers, so its bundle has no such key.  The capture's
broad ``except`` wraps only the bundle's assembly, never device work.
"""
from __future__ import annotations

import weakref
from typing import Any, Callable, Dict, List, Optional

from ..common.config import g_conf
from ..common.lockdep import DebugLock
from ..common.perf_counters import PerfCounters, PerfCountersBuilder
from ..trace.journal import g_journal

# ---- incident perf counters (perf dump / Prometheus
# ceph_daemon_incident_*) --------------------------------------------------
INCIDENT_FIRST = 95200
l_inc_captures = 95201       # bundles captured (any reason)
l_inc_operator = 95202       # captures requested via the asok verb
l_inc_dropped = 95203        # captures dropped by a failure/injection
l_inc_resolved = 95204       # open incidents finalized by their clear
l_inc_pruned = 95205         # bundles evicted by the retention bound
l_inc_open = 95206           # gauge: incidents awaiting their clear
INCIDENT_LAST = 95210

_inc_pc: Optional[PerfCounters] = None
_inc_pc_lock = DebugLock("incident_pc::init")


def incident_perf_counters() -> PerfCounters:
    global _inc_pc
    if _inc_pc is not None:
        return _inc_pc
    with _inc_pc_lock:
        if _inc_pc is None:
            b = PerfCountersBuilder("incident", INCIDENT_FIRST,
                                    INCIDENT_LAST)
            b.add_u64_counter(l_inc_captures, "captures",
                              "incident bundles captured")
            b.add_u64_counter(l_inc_operator, "operator_captures",
                              "captures requested by 'tpu incident "
                              "capture'")
            b.add_u64_counter(l_inc_dropped, "dropped",
                              "captures dropped by a failure or "
                              "injection")
            b.add_u64_counter(l_inc_resolved, "resolved",
                              "incidents finalized by their check's "
                              "clear")
            b.add_u64_counter(l_inc_pruned, "pruned",
                              "bundles evicted by mgr_incident_"
                              "retention")
            b.add_u64(l_inc_open, "open",
                      "incidents awaiting their clear (gauge)")
            _inc_pc = b.create_perf_counters()
    return _inc_pc


# every live archive, so ONE config observer can prune all of them the
# moment an operator shrinks mgr_incident_retention (injectargs-live)
_managers: "weakref.WeakSet[IncidentManager]" = weakref.WeakSet()
_observer_registered = False
_observer_lock = DebugLock("incident_observer::init")


def _on_retention_change(_name: str, _value: Any) -> None:
    for m in list(_managers):
        m.prune()


def _register_observer() -> None:
    global _observer_registered
    with _observer_lock:
        if not _observer_registered:
            g_conf.add_observer("mgr_incident_retention",
                                _on_retention_change)
            _observer_registered = True


class IncidentManager:
    """One mgr's bounded incident archive.

    Per-Manager (not process-global) so every MiniCluster starts with
    a clean archive while the journal singleton keeps the process-wide
    event record the bundles index into.
    """

    def __init__(self, mgr) -> None:
        self._mgr = weakref.ref(mgr)
        self._lock = DebugLock("IncidentManager::lock")
        self._archive: List[dict] = []
        self._next_id = 1
        self._captures_total = 0
        # MiniCluster wires this to the OSDs' trackers; the mgr itself
        # holds no daemon references (it is a map subscriber)
        self.slow_ops_source: Optional[
            Callable[[], Dict[str, dict]]] = None
        _managers.add(self)
        _register_observer()

    # ---- options (read live) -------------------------------------------
    @staticmethod
    def _retention() -> int:
        return int(g_conf.get_val("mgr_incident_retention"))

    @staticmethod
    def _tail() -> int:
        return int(g_conf.get_val("mgr_incident_timeline_tail"))

    # ---- capture --------------------------------------------------------
    def capture(self, trigger: str, message: str = "",
                reason: str = "health_raise") -> Optional[dict]:
        """Snapshot one bundle; returns it, or None when the capture
        was dropped.  Runs under the ``mgr.incident_capture`` fault
        site and a broad except: a failing capture loses THIS bundle,
        never the tick — the next raise captures normally."""
        from ..fault import g_faults
        pc = incident_perf_counters()
        try:
            g_faults.check("mgr.incident_capture", trigger)
            bundle = self._build_bundle(trigger, message, reason)
        except Exception as e:
            pc.inc(l_inc_dropped)
            g_journal.emit("mgr", "incident_drop", trigger=trigger,
                           error=str(e))
            return None
        with self._lock:
            bundle["id"] = self._next_id
            self._next_id += 1
            self._captures_total += 1
            self._archive.append(bundle)
        pc.inc(l_inc_captures)
        if reason == "operator":
            pc.inc(l_inc_operator)
        g_journal.emit("mgr", "incident_capture", id=bundle["id"],
                       trigger=trigger, reason=reason)
        self.prune()
        self._set_open_gauge()
        return bundle

    def _build_bundle(self, trigger: str, message: str,
                      reason: str) -> dict:
        mgr = self._mgr()
        tail = self._tail()
        slow_ops = self._worst_slow_ops()
        from ..mesh import g_chipstat
        bundle: Dict[str, Any] = {
            "id": 0,                       # assigned under the lock
            "clock": g_journal.clock(),
            "state": "open" if reason == "health_raise" else "manual",
            "reason": reason,
            "trigger": {"check": trigger, "message": message},
            "slo": mgr.telemetry.slo_state() if mgr else {},
            "health_checks": dict(mgr.health_checks) if mgr else {},
            "timeline": g_journal.merged(tail=tail),
            "timeline_gseq": g_journal.last_gseq(),
            "rollup": mgr.telemetry.rollup() if mgr else {},
            "slow_ops": slow_ops,
            "chip_scoreboard": g_chipstat.summary(),
            "control": mgr.control.dump() if mgr else {},
        }
        return bundle

    def _worst_slow_ops(self, worst: int = 3) -> List[dict]:
        """The worst historic slow ops across the wired daemons, with
        their stage + copy ledgers (the forensics payload; span trees
        stay behind ``dump_historic_slow_ops`` — bundles index, they
        do not duplicate the whole trace store)."""
        if self.slow_ops_source is None:
            return []
        rows: List[dict] = []
        for daemon, dump in sorted(self.slow_ops_source().items()):
            for op in dump.get("ops", []):
                rows.append({
                    "daemon": daemon,
                    "description": op.get("description", ""),
                    "age": op.get("age", 0.0),
                    "stage_ledger": op.get("stage_ledger"),
                    "copy_ledger": op.get("copy_ledger"),
                })
        rows.sort(key=lambda r: r["age"], reverse=True)
        return rows[:worst]

    # ---- resolve --------------------------------------------------------
    def resolve(self, check: str) -> Optional[dict]:
        """The triggering check cleared: finalize the newest open
        incident for it — grow the timeline with every event since
        capture (the reaction and the clear), mark it resolved."""
        with self._lock:
            target = None
            for bundle in reversed(self._archive):
                if bundle["state"] == "open" \
                        and bundle["trigger"]["check"] == check:
                    target = bundle
                    break
            if target is None:
                return None
            since = g_journal.merged_since(target["timeline_gseq"],
                                           tail=self._tail())
            target["timeline"].extend(since)
            if since:
                target["timeline_gseq"] = since[-1]["gseq"]
            target["state"] = "resolved"
            target["resolved_clock"] = g_journal.clock()
            bid = target["id"]
        incident_perf_counters().inc(l_inc_resolved)
        g_journal.emit("mgr", "incident_resolve", id=bid, trigger=check)
        self._set_open_gauge()
        return target

    # ---- bounds ---------------------------------------------------------
    def prune(self) -> int:
        """Evict past the retention bound (oldest first); called on
        capture and by the config observer so an injectargs shrink
        takes effect immediately."""
        keep = max(self._retention(), 0)
        with self._lock:
            over = len(self._archive) - keep
            if over > 0:
                del self._archive[:over]
        if over > 0:
            incident_perf_counters().inc(l_inc_pruned, over)
            self._set_open_gauge()
        return max(over, 0)

    def _set_open_gauge(self) -> None:
        with self._lock:
            n = sum(1 for b in self._archive if b["state"] == "open")
        incident_perf_counters().set(l_inc_open, n)

    # ---- views ----------------------------------------------------------
    @property
    def captures_total(self) -> int:
        with self._lock:
            return self._captures_total

    def list(self) -> dict:
        """asok ``tpu incident list`` — one row per archived bundle."""
        with self._lock:
            rows = [{"id": b["id"], "clock": b["clock"],
                     "state": b["state"], "reason": b["reason"],
                     "trigger": b["trigger"]["check"],
                     "events": len(b["timeline"])}
                    for b in self._archive]
            total = self._captures_total
        return {"captures_total": total,
                "retention": self._retention(),
                "incidents": rows}

    def dump(self, incident_id: int = 0) -> dict:
        """asok ``tpu incident dump [id]`` — the full bundle (newest
        when *incident_id* is 0)."""
        with self._lock:
            if not self._archive:
                return {"incident": None}
            if incident_id:
                for b in self._archive:
                    if b["id"] == incident_id:
                        return {"incident": dict(b)}
                raise ValueError(f"no incident with id {incident_id}")
            return {"incident": dict(self._archive[-1])}

    def receipt(self) -> dict:
        """The bench workloads' ``incidents`` receipt block: compact
        per-incident rows plus the causal skeleton of the newest
        bundle's timeline (type+daemon only — receipts diff cleanly)."""
        with self._lock:
            rows = [{"id": b["id"], "state": b["state"],
                     "reason": b["reason"],
                     "trigger": b["trigger"]["check"],
                     "events": len(b["timeline"])}
                    for b in self._archive]
            skeleton = [f'{e["daemon"]}:{e["type"]}'
                        for e in self._archive[-1]["timeline"]] \
                if self._archive else []
            total = self._captures_total
        return {"captures_total": total, "incidents": rows,
                "newest_timeline": skeleton}
