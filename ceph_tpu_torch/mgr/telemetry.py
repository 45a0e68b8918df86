"""mgr telemetry rollup — cluster time-series, merged percentiles,
and SLO burn-rate health.

The per-daemon observability layers (trace/: oplat stage histograms,
devprof flow counters, qos admission counters) answer "what is THIS
daemon doing"; nothing answered "is the FLEET inside its latency
budget right now".  Tail effects in distributed work are exactly what
per-daemon views hide (arxiv 1804.10331: the straggler dominates the
job) — the cluster p99 of a stage is the percentile of the UNION of
every daemon's samples, which no individual daemon's histogram shows.
This module is the mgr's DaemonPerfCounters-collection role
(pybind/mgr/: the status/prometheus modules' stats plumbing) over the
process-global registries:

- **Collection** (``collect``, driven from ``Manager.tick`` on the
  cluster's deterministic clock): every histogram family is merged
  across daemons (``trace.histogram.merge_axis0`` — same-edged log2
  series, so cluster percentiles are exact) and snapshotted with the
  relevant counter totals into a bounded, timestamped ring
  (``mgr_telemetry_retention`` samples).  Collection is pure host-side
  reads — zero added device syncs (fence-count enforced).
- **Rollup** (``rollup``, THE shared snapshot function): per-family
  cluster p50/p99/p999 and rates (ops/s, h2d/d2h bytes/s, admission
  rejections/s) derived from ring DELTAS over a window, so every
  surface — ``telemetry dump``, ``tpu status``, the Prometheus
  ``ceph_cluster_*`` families, and the bench ``cluster_rollup``
  block — renders from one function and cannot drift.
- **SLO engine** (``mgr_slo_*`` options): objectives evaluated over a
  fast and a slow burn-rate window.  A check RAISES only after the
  fast-window burn has breached for ``mgr_slo_sustain_ticks``
  consecutive collects AND the slow window confirms (a single-tick
  spike never flaps it); it CLEARS only after
  ``mgr_slo_clear_ticks`` clean collects (hysteresis).  Raise/clear
  transitions ride the same health path as
  ``check_degraded_codecs`` — ``Manager.health_checks`` + the mon
  cluster log — so ``TPU_SLO_*`` shows in ``ceph -s``, ``health()``
  and ``ceph_health_check{check=...}``.

This converts the bench's copy and stage budgets from CI-only
gates into live cluster health: the same per-stage p99s
and copies-per-op figures the gates watch offline are now objectives
a running cluster raises health checks on.
"""
from __future__ import annotations

import threading

from ..common.lockdep import DebugLock
from typing import Any, Dict, List, Optional, Tuple

from ..common.config import g_conf
from ..trace.histogram import (g_perf_histograms, merge_axis0,
                               percentiles_from_counts)
from ..trace.journal import g_journal

# the three SLO health checks (mon health / `ceph -s` / Prometheus
# ceph_health_check{check=...} via Manager.health_checks)
SLO_OPLAT = "TPU_SLO_OPLAT"
SLO_COPY = "TPU_SLO_COPY"
SLO_ADMISSION = "TPU_SLO_ADMISSION"
SLO_CHECKS = (SLO_OPLAT, SLO_COPY, SLO_ADMISSION)

QUANTILES = (0.5, 0.99, 0.999)

# counter catalog sampled into every ring entry; rates derive from
# deltas between entries, never from instantaneous values
RATE_KEYS = ("ops", "h2d_bytes", "d2h_bytes", "admission_rejections")


def _counter_sample() -> Dict[str, float]:
    """Cluster-wide counter totals for the rate/SLO series: op
    completions (oplat), boundary bytes + accounted copies (devprof),
    admission rejections (qos).  Deferred imports keep mgr-only users
    from pulling the whole trace package at module import."""
    from ..common.work_queue import qos_perf_counters
    from ..trace.devprof import devprof_perf_counters
    from ..trace.oplat import oplat_perf_counters
    op = oplat_perf_counters().dump()
    dv = devprof_perf_counters().dump()
    qs = qos_perf_counters().dump()
    return {
        "ops": float(op.get("ops", 0)),
        "h2d_bytes": float(dv.get("h2d_bytes", 0)),
        "d2h_bytes": float(dv.get("d2h_bytes", 0)),
        "copies": float(dv.get("h2d_transfers", 0)
                        + dv.get("d2h_transfers", 0)
                        + dv.get("host_copies", 0)),
        "admission_rejections": float(qs.get("admission_rejections", 0)),
    }


def _oplat_stage(name: str) -> Optional[str]:
    from ..trace.oplat import stage_of_hist_name
    return stage_of_hist_name(name)


class Telemetry:
    """The mgr's cluster telemetry module (ring + rollup + SLO)."""

    def __init__(self):
        self._lock = DebugLock("MgrTelemetry::lock")
        # ring entries: {"t", "counters": {...},
        #                "families": {name: [axis0 counts]}}
        self._ring: List[Dict[str, Any]] = []
        # family name -> axis-0 upper edges (fixed per family)
        self._edges: Dict[str, List[float]] = {}
        # check -> {"active", "streak", "clean", "burn_fast",
        #           "burn_slow", "message"}
        self._slo: Dict[str, Dict[str, Any]] = {}
        # clock of the newest sample the SLO engine has judged — a
        # re-tick at the same clock (repeated `tpu status` calls)
        # must not double-count the sustain/clear streaks
        self._last_eval_t: Optional[float] = None

    # ---- options -----------------------------------------------------------
    @staticmethod
    def objectives() -> Dict[str, Any]:
        """The SLO option table, parsed fresh each evaluation so
        injectargs changes take effect on the next tick."""
        oplat: Dict[str, float] = {}
        raw = str(g_conf.get_val("mgr_slo_oplat_p99_usec") or "")
        for part in raw.split(","):
            stage, _, v = part.strip().partition(":")
            if not stage or not v:
                continue
            try:
                oplat[stage.strip()] = float(v)
            except ValueError:
                continue        # a typo'd pair must not arm garbage
        return {
            "oplat_p99_usec": oplat,
            "copies_per_op_max":
                float(g_conf.get_val("mgr_slo_copies_per_op_max") or 0.0),
            "admission_rate_max":
                float(g_conf.get_val("mgr_slo_admission_rate_max") or 0.0),
            "fast_window_s":
                float(g_conf.get_val("mgr_slo_fast_window_s") or 30.0),
            "slow_window_s":
                float(g_conf.get_val("mgr_slo_slow_window_s") or 300.0),
            "sustain_ticks":
                int(g_conf.get_val("mgr_slo_sustain_ticks") or 2),
            "clear_ticks":
                int(g_conf.get_val("mgr_slo_clear_ticks") or 2),
        }

    # ---- collection --------------------------------------------------------
    def collect(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Snapshot the cluster-merged histogram families + counter
        totals into the ring at clock *now* (monotone; a stale or
        repeated clock value is a no-op so a mid-tick scrape cannot
        add zero-dt samples that blow up rate math).  ``now=None``
        self-advances one second past the newest sample — direct
        callers without a cluster clock stay monotone."""
        with self._lock:
            last_t = self._ring[-1]["t"] if self._ring else None
        if now is None:
            now = 0.0 if last_t is None else last_t + 1.0
        if last_t is not None and now <= last_t:
            with self._lock:
                return self._ring[-1]
        families: Dict[str, List[int]] = {}
        by_name: Dict[str, List] = {}
        for (_logger, name), hist in g_perf_histograms.items():
            by_name.setdefault(name, []).append(hist)
        for name, hists in by_name.items():
            # merge across daemons: same-named families share an axes
            # factory, so the edges agree and the union is exact
            try:
                edges, counts = merge_axis0(hists)
            except ValueError:
                continue        # mismatched edges: skip, never guess
            families[name] = counts
            self._edges.setdefault(name, edges)
        entry = {"t": float(now), "counters": _counter_sample(),
                 "families": families}
        retention = int(g_conf.get_val("mgr_telemetry_retention") or 360)
        with self._lock:
            if self._ring and entry["t"] <= self._ring[-1]["t"]:
                return self._ring[-1]       # lost a race: keep monotone
            self._ring.append(entry)
            del self._ring[:-max(retention, 2)]
        return entry

    def tick(self, mgr, now: Optional[float] = None) -> None:
        """One mgr tick: collect a sample, then run the SLO engine
        against *mgr*'s health surface — once per distinct sample
        (an extra tick at an unmoved clock is a pure no-op, so
        ``tpu status`` calls between cluster ticks cannot
        double-count the streaks)."""
        entry = self.collect(now)
        if entry["t"] == self._last_eval_t:
            return
        self._last_eval_t = entry["t"]
        self.evaluate_slo(mgr)

    def reset(self) -> None:
        """``telemetry reset``: drop the rings and the SLO streaks
        (the underlying per-daemon histograms/counters belong to
        ``latency reset`` / ``prof reset``, not to us)."""
        with self._lock:
            self._ring.clear()
            self._edges.clear()
            self._slo.clear()
            self._last_eval_t = None

    # ---- windows -----------------------------------------------------------
    @staticmethod
    def _delta(start: Dict[str, Any], cur: Dict[str, Any],
               samples: int) -> Dict[str, Any]:
        dt = max(cur["t"] - start["t"], 0.0)
        counters = {k: max(cur["counters"].get(k, 0.0)
                           - start["counters"].get(k, 0.0), 0.0)
                    for k in cur["counters"]}
        fams: Dict[str, List[int]] = {}
        for name, counts in cur["families"].items():
            base = start["families"].get(name)
            if base is None:
                fams[name] = list(counts)
            else:
                # clamp: a `latency reset` mid-window must read as
                # empty, not as negative counts
                fams[name] = [max(a - b, 0)
                              for a, b in zip(counts, base)]
        return {"t": cur["t"], "dt": dt, "counters": counters,
                "families": fams, "samples": samples}

    def _window(self, window_s: float) -> Optional[Dict[str, Any]]:
        """Deltas between the newest sample and the newest sample at
        least *window_s* older (falling back to the OLDEST sample —
        until the ring spans the window, the window is "since the
        first sample", which for a fresh cluster is the mgr's boot
        baseline, i.e. "everything this cluster did")."""
        with self._lock:
            entries = list(self._ring)
        if not entries:
            return None
        cur = entries[-1]
        start = entries[0]
        for e in reversed(entries[:-1]):
            if e["t"] <= cur["t"] - window_s:
                start = e
                break
        return self._delta(start, cur, len(entries))

    def _last_tick(self) -> Optional[Dict[str, Any]]:
        """Delta between the newest two samples — "what happened this
        tick", the signal the SLO sustain/clear streaks count so a
        quiet tick reads as clean even while an old spike still sits
        inside the fast window."""
        with self._lock:
            entries = list(self._ring[-2:])
        if len(entries) < 2:
            return None
        return self._delta(entries[0], entries[1], 2)

    def _family_pcts(self, win: Dict[str, Any],
                     name: str) -> Optional[Dict[str, float]]:
        counts = win["families"].get(name)
        edges = self._edges.get(name)
        if not counts or not edges or not sum(counts):
            return None
        out = percentiles_from_counts(counts, edges, QUANTILES)
        out["count"] = sum(counts)
        return out

    @staticmethod
    def _rates(win: Dict[str, Any]) -> Dict[str, float]:
        dt = win["dt"]
        if dt <= 0:
            return {k: 0.0 for k in RATE_KEYS}
        return {k: round(win["counters"].get(k, 0.0) / dt, 4)
                for k in RATE_KEYS}

    # ---- the shared rollup snapshot ---------------------------------------
    def rollup(self, window_s: Optional[float] = None) -> Dict[str, Any]:
        """THE cluster rollup: every surface (``telemetry dump``,
        ``tpu status``, the Prometheus ``ceph_cluster_*`` families,
        the bench ``cluster_rollup`` block) renders from this one
        function so they cannot drift.  Default window is the SLO
        fast window."""
        obj = self.objectives()
        if window_s is None:
            window_s = obj["fast_window_s"]
        win = self._window(window_s)
        out: Dict[str, Any] = {
            "clock": None, "samples": 0, "window_s": float(window_s),
            "span_s": 0.0, "oplat_p99_usec": {}, "oplat": {},
            "families": {}, "rates": {k: 0.0 for k in RATE_KEYS},
            "copies_per_op": 0.0,
            "slo": self.slo_state(),
            "objectives": {"oplat_p99_usec": obj["oplat_p99_usec"],
                           "copies_per_op_max": obj["copies_per_op_max"],
                           "admission_rate_max":
                               obj["admission_rate_max"]},
        }
        if win is None:
            return out
        out["clock"] = win["t"]
        out["samples"] = win["samples"]
        out["span_s"] = round(win["dt"], 3)
        for name in sorted(win["families"]):
            p = self._family_pcts(win, name)
            if p is None:
                continue
            out["families"][name] = p
            stage = _oplat_stage(name)
            if stage is not None:
                out["oplat"][stage] = p
                out["oplat_p99_usec"][stage] = p["p99"]
        out["rates"] = self._rates(win)
        ops = win["counters"].get("ops", 0.0)
        if ops > 0:
            out["copies_per_op"] = round(
                win["counters"].get("copies", 0.0) / ops, 4)
        return out

    def dump(self) -> Dict[str, Any]:
        """The ``telemetry dump`` admin-socket shape: the shared
        rollup plus ring metadata."""
        out = self.rollup()
        out["retention"] = int(
            g_conf.get_val("mgr_telemetry_retention") or 360)
        return out

    def slo_state(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {check: {
                "state": "breach" if st["active"] else "ok",
                "burn_fast": st["burn_fast"],
                "burn_slow": st["burn_slow"],
                "streak": st["streak"],
                "message": st["message"],
            } for check, st in sorted(self._slo.items())}

    # ---- SLO engine --------------------------------------------------------
    def _oplat_burn(self, win: Optional[Dict[str, Any]],
                    ceilings: Dict[str, float]
                    ) -> Tuple[float, str]:
        """Worst stage burn over one window: max(p99/ceiling)."""
        from ..trace.oplat import stage_hist_name
        worst, msgs = 0.0, []
        if win is None:
            return 0.0, ""
        for stage, ceiling in sorted(ceilings.items()):
            if ceiling <= 0:
                continue
            p = self._family_pcts(win, stage_hist_name(stage))
            if p is None:
                continue
            burn = p["p99"] / ceiling
            if burn > worst:
                worst = burn
            if burn >= 1.0:
                msgs.append(f"{stage} p99 {p['p99']:.0f}us > "
                            f"{ceiling:.0f}us")
        return worst, "; ".join(msgs)

    def _copy_burn(self, win: Optional[Dict[str, Any]],
                   ceiling: float) -> Tuple[float, str]:
        if win is None or ceiling <= 0:
            return 0.0, ""
        ops = win["counters"].get("ops", 0.0)
        if ops <= 0:
            return 0.0, ""      # no ops: nothing to judge
        cpo = win["counters"].get("copies", 0.0) / ops
        return cpo / ceiling, (f"{cpo:.2f} copies/op > "
                               f"{ceiling:.2f}")

    def _admission_burn(self, win: Optional[Dict[str, Any]],
                        ceiling: float) -> Tuple[float, str]:
        if win is None or ceiling <= 0 or win["dt"] <= 0:
            return 0.0, ""
        rate = win["counters"].get("admission_rejections", 0.0) \
            / win["dt"]
        return rate / ceiling, (f"{rate:.2f} rejections/s > "
                                f"{ceiling:.2f}/s")

    def evaluate_slo(self, mgr) -> None:
        """Burn-rate evaluation: the fast/slow windows measure the
        burn (observed/objective), the per-tick delta drives the
        sustain/clear streaks — raise only after
        ``mgr_slo_sustain_ticks`` consecutive breaching ticks with
        both windows confirming, clear only after
        ``mgr_slo_clear_ticks`` consecutive clean ticks (hysteresis).
        A single-tick spike breaches one tick delta, the next is
        clean, the streak resets: it never raises.  Disabled
        objectives tear their check down."""
        obj = self.objectives()
        tick = self._last_tick()
        fast = self._window(obj["fast_window_s"])
        slow = self._window(obj["slow_window_s"])
        verdicts: List[Tuple[str, float, float, float, str]] = []
        if obj["oplat_p99_usec"]:
            bn, _m = self._oplat_burn(tick, obj["oplat_p99_usec"])
            bf, msg = self._oplat_burn(fast, obj["oplat_p99_usec"])
            bs, _m = self._oplat_burn(slow, obj["oplat_p99_usec"])
            verdicts.append((SLO_OPLAT, bn, bf, bs,
                             f"cluster stage p99 over budget: {msg}"))
        if obj["copies_per_op_max"] > 0:
            bn, _m = self._copy_burn(tick, obj["copies_per_op_max"])
            bf, msg = self._copy_burn(fast, obj["copies_per_op_max"])
            bs, _m = self._copy_burn(slow, obj["copies_per_op_max"])
            verdicts.append((SLO_COPY, bn, bf, bs,
                             f"cluster copy budget exceeded: {msg}"))
        if obj["admission_rate_max"] > 0:
            bn, _m = self._admission_burn(tick,
                                          obj["admission_rate_max"])
            bf, msg = self._admission_burn(fast,
                                           obj["admission_rate_max"])
            bs, _m = self._admission_burn(slow,
                                          obj["admission_rate_max"])
            verdicts.append((SLO_ADMISSION, bn, bf, bs,
                             f"admission shedding over budget: {msg}"))
        active_objs = {v[0] for v in verdicts}
        # objectives removed at runtime: drop state + clear the check
        for check in list(self._slo):
            if check not in active_objs:
                with self._lock:
                    st = self._slo.pop(check, None)
                if st and st["active"]:
                    mgr.health_checks.pop(check, None)
                    mgr._cluster_log(
                        "INF", f"Health check cleared: {check} "
                        f"(objective removed)")
        for check, burn_now, burn_fast, burn_slow, message in verdicts:
            with self._lock:
                st = self._slo.setdefault(check, {
                    "active": False, "streak": 0, "clean": 0,
                    "burn_fast": 0.0, "burn_slow": 0.0, "message": ""})
                st["burn_fast"] = round(burn_fast, 3)
                st["burn_slow"] = round(burn_slow, 3)
                if burn_now >= 1.0:
                    st["streak"] += 1
                    st["clean"] = 0
                    streak_opened = st["streak"] == 1
                    clean_opened = False
                else:
                    st["streak"] = 0
                    st["clean"] += 1
                    streak_opened = False
                    clean_opened = st["clean"] == 1 and st["active"]
                raise_now = (not st["active"]
                             and st["streak"] >= obj["sustain_ticks"]
                             and burn_fast >= 1.0
                             and burn_slow >= 1.0)
                clear_now = (st["active"]
                             and st["clean"] >= obj["clear_ticks"])
                if raise_now:
                    st["active"] = True
                    st["message"] = message
                elif clear_now:
                    st["active"] = False
                    st["message"] = ""
                elif st["active"] and burn_fast >= 1.0:
                    # refresh the detail only while the fast window —
                    # which the message's figures come from — still
                    # breaches, so the health text never shows a
                    # "1.50 > 2.00" non-comparison
                    st["message"] = message
            if streak_opened:
                # a sustain streak opened: the first breaching tick of
                # a possible raise — journal it so the incident bundle
                # shows when the pressure began, not just when it won
                g_journal.emit("mgr", "slo_streak", check=check,
                               phase="sustain")
            elif clean_opened:
                g_journal.emit("mgr", "slo_streak", check=check,
                               phase="clean")
            if raise_now:
                mgr.health_checks[check] = message
                mgr._cluster_log(
                    "WRN", f"Health check failed: {check} ({message})")
            elif clear_now:
                mgr.health_checks.pop(check, None)
                mgr._cluster_log(
                    "INF", f"Health check cleared: {check} "
                    f"(burn rate back under budget)")
            elif st["active"]:
                mgr.health_checks[check] = st["message"] or message
        # invariant sweep: a TPU_SLO_* entry in health_checks must be
        # backed by an ACTIVE streak state.  `telemetry reset` and
        # objective disabling can land in any order between ticks —
        # whatever state they erased, a raised check with no active
        # backing must clear here, or health() and slo_state() would
        # disagree forever
        for check in SLO_CHECKS:
            st = self._slo.get(check)
            if (st is None or not st["active"]) \
                    and check in mgr.health_checks:
                mgr.health_checks.pop(check, None)
                mgr._cluster_log(
                    "INF", f"Health check cleared: {check} "
                    f"(telemetry state reset)")
