"""ceph-mgr-lite — the manager daemon's module host.

The reference mgr (src/mgr/, ~9k LoC) subscribes to cluster maps and
hosts python modules (pybind/mgr/: balancer, prometheus, status...).
This is the same shape over the mini-cluster fabric:

- ``balancer``: periodically runs calc_pg_upmaps (the device-batched
  upmap optimizer, osdmap/balancer.py — OSDMap::calc_pg_upmaps role) and
  proposes the resulting pg_upmap_items to the monitor as an
  Incremental, exactly how pybind/mgr/balancer/module.py feeds the mon.
- ``prometheus``: renders cluster gauges + every registered perf counter
  in the Prometheus text exposition format
  (pybind/mgr/prometheus/module.py role).
- ``status``: health / pg / pool summaries for the admin socket.

The mgr is a map subscriber like any daemon: it keeps its own OSDMap
copy current from MOSDMap broadcasts.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from ..msg import Dispatcher, MOSDMap, Message, Network
from ..osdmap import Incremental, OSDMap
from ..osdmap.balancer import calc_pg_upmaps


class Manager(Dispatcher):
    def __init__(self, network: Network, mon, name: str = "mgr",
                 all_mons=None):
        """*mon* is either a Monitor or a zero-arg resolver returning the
        current leader (failover-safe); *all_mons* subscribes the mgr on
        every monitor so map updates keep flowing after an election."""
        self.network = network
        self._mon = mon
        self.name = name
        self.messenger = network.create_messenger(name)
        self.messenger.add_dispatcher_head(self)
        self.osdmap = OSDMap()
        self.modules = ["balancer", "prometheus", "status",
                        "pg_autoscaler"]
        self.balancer_active = False     # 'ceph balancer on' equivalent
        self.last_optimize_result = 0
        # every optimize pass appended here (the restful module's
        # /request history role): (mode, changes_proposed)
        self.proposal_log: List[Dict] = []
        # per-PG usage from primaries' MPGStats reports (newest epoch
        # wins — only the current primary reports a PG, so no double
        # counting):  (pool, ps) -> (epoch, objects, bytes)
        self.pg_stats: Dict[tuple, tuple] = {}
        # osd -> (store_bytes, store_capacity) from MPGStats osd_stat
        self.osd_stats: Dict[int, tuple] = {}
        self.autoscaler_active = False
        self.health_checks: Dict[str, str] = {}
        # cluster telemetry rollup + SLO burn-rate engine
        # (telemetry.py); the boot-time baseline sample makes every
        # window "since this cluster booted" until the ring spans it
        from .telemetry import Telemetry
        self.telemetry = Telemetry()
        self.telemetry.collect(0.0)
        # damped SLO feedback controller (control/,
        # docs/CONTROL.md): steps after telemetry each tick; with
        # mgr_control_enable off (default) it returns before sensing
        from ..control import Controller
        self.control = Controller()
        # incident forensics (incident.py): bundles auto-captured on
        # health raises, finalized on the matching clear.  The diff
        # baseline below is what the tick compares health_checks
        # against to journal raise/clear transitions — it covers every
        # raise path (the check_* methods, the SLO engine, health()
        # between ticks) with one mechanism
        from .incident import IncidentManager
        self.incident = IncidentManager(self)
        self._journal_health: Dict[str, str] = {}
        for m in (all_mons if all_mons is not None else [self.mon]):
            m.subscribe(name)
        self.mon.send_full_map(name)
        network.pump()

    @property
    def mon(self):
        return self._mon() if callable(self._mon) else self._mon

    # ---- dispatch ----------------------------------------------------------
    def ms_fast_dispatch(self, msg: Message) -> None:
        from ..msg.messages import MPGStats
        if isinstance(msg, MOSDMap):
            for inc in msg.incrementals:
                if inc.epoch == self.osdmap.epoch + 1:
                    self.osdmap.apply_incremental(inc)
        elif isinstance(msg, MPGStats):
            for pool, ps, n_obj, n_bytes in msg.pg_stats:
                cur = self.pg_stats.get((pool, ps))
                if cur is not None and cur[0] > msg.epoch:
                    # a map-lagged ex-primary (blackholed from the
                    # mons but not from us) must not clobber the
                    # current primary's numbers
                    continue
                self.pg_stats[(pool, ps)] = (msg.epoch, n_obj, n_bytes)
            if msg.osd >= 0:
                self.osd_stats[msg.osd] = (msg.store_bytes,
                                           msg.store_capacity)

    # ---- balancer module ---------------------------------------------------
    def balancer_optimize(self, max_deviation: float = 0.01,
                          max_iterations: int = 10) -> int:
        """One optimization pass: compute pg_upmap_items on our map copy
        and propose them to the mon (balancer/module.py:optimize ->
        OSDMonitor upmap commands).  Returns the number of changes."""
        import copy
        inc = Incremental()
        work = copy.deepcopy(self.osdmap)
        n = calc_pg_upmaps(work, max_deviation=max_deviation,
                           max_iterations=max_iterations, inc=inc)
        self.last_optimize_result = n
        self.proposal_log.append({"mode": "upmap", "changes": n,
                                  "epoch": self.osdmap.epoch})
        if n:
            self.mon.publish(inc)
            self.network.pump()
        return n

    def balancer_optimize_crush_compat(self, pool_id: int,
                                       max_iterations: int = 30
                                       ) -> "tuple[float, float]":
        """crush-compat mode (balancer/module.py do_crush_compat):
        optimize a per-position weight_set on the MON's map — the
        choose_args ride the crush map, so the change publishes as a
        topology epoch, no upmap entries involved."""
        from ..osdmap.balancer import calc_weight_set
        before, after = calc_weight_set(self.mon.osdmap, pool_id,
                                        max_iterations=max_iterations)
        if after < before:
            self.mon._topology_dirty = True
            self.mon.publish()
            self.network.pump()
        return before, after

    def tick(self, now: Optional[float] = None) -> None:
        """Periodic module work (the mgr's serve loops).  *now* is the
        cluster's deterministic clock (MiniCluster.tick passes it);
        None self-advances the telemetry clock one second per tick."""
        from ..trace.journal import g_journal
        if now is not None:
            # stamp the journal's deterministic clock before any event
            # this tick can emit (no wall clock anywhere in the layer)
            g_journal.set_clock(now)
        if self.balancer_active:
            self.balancer_optimize()
        if self.autoscaler_active:
            self.pg_autoscale(apply=True)
        self.check_quotas_and_fullness()
        self.check_degraded_codecs()
        self.check_mesh_skew()
        # cluster rollup collection + SLO burn-rate evaluation — pure
        # host-side histogram/counter reads, zero added device syncs
        # (the fence-count test in tests/test_observability.py covers
        # this tick)
        self.telemetry.tick(self, now)
        # health transition journal + incident forensics: diff the
        # check set against the last tick's baseline so every raise
        # path lands one health_raise (+ auto-capture) and every clear
        # one health_clear (+ finalize), in tick order.  This runs
        # BEFORE the control step so a raise is journaled ahead of the
        # actuation it provokes — the bundle timeline reads causally
        # (raise -> actuate -> ... -> clear); the actuations land in
        # the bundle when the clear finalizes it
        prev = self._journal_health
        cur = dict(self.health_checks)
        for check in sorted(set(cur) - set(prev)):
            g_journal.emit("mgr", "health_raise", check=check,
                           message=cur[check])
            self.incident.capture(check, cur[check],
                                  reason="health_raise")
        for check in sorted(set(prev) - set(cur)):
            g_journal.emit("mgr", "health_clear", check=check)
            self.incident.resolve(check)
        self._journal_health = cur
        # the control plane closes the loop on the streak state the
        # telemetry tick just refreshed: at most ONE bounded knob step
        # per tick (no-op unless mgr_control_enable)
        self.control.step(self, now if now is not None
                          else self.telemetry._last_eval_t)

    # ---- codec degradation (circuit-breaker board -> health) ---------------
    def check_degraded_codecs(self) -> None:
        """TPU_CODEC_DEGRADED in the JAX package: raised while a codec
        signature's circuit breaker serves it from the CPU matrix path.
        The port has no breaker and no host route for a device request
        (a device error reaches the caller), so no signature is ever
        degraded and this check never raises.  The method stays so that
        ``tick`` and ``health`` keep the reference's shape."""
        self.health_checks.pop("TPU_CODEC_DEGRADED", None)

    # ---- mesh chip skew (chip-health scoreboard -> health) ------------------
    def check_mesh_skew(self) -> None:
        """TPU_MESH_SKEW: raised while the mesh chip-health scoreboard
        (mesh/chipstat) holds any SUSPECT chip — a chip whose
        EWMA probe service time sustained ``ec_mesh_skew_threshold``
        times the mesh median — naming the worst chip and its ratio.
        The hysteresis lives in the scoreboard (the breaker's
        sustain/clear discipline, counted in probes), so this check
        raises the moment a suspect is marked and clears the moment
        the last one sustains clean; transitions ride the same
        health/cluster-log path as check_degraded_codecs."""
        from ..mesh import g_chipstat
        suspects = g_chipstat.suspects()
        had = "TPU_MESH_SKEW" in self.health_checks
        if suspects:
            worst = suspects[0]
            msg = (f"{len(suspects)} mesh chip(s) over the skew "
                   f"threshold: worst chip {worst['chip']} at "
                   f"{worst['skew_ratio']:.1f}x the mesh median "
                   f"service time")
            self.health_checks["TPU_MESH_SKEW"] = msg
            if not had:
                self._cluster_log(
                    "WRN", f"Health check failed: TPU_MESH_SKEW "
                    f"({msg})")
        elif had:
            self.health_checks.pop("TPU_MESH_SKEW", None)
            self._cluster_log(
                "INF", "Health check cleared: TPU_MESH_SKEW (chip "
                "service times back inside the skew threshold)")

    def _cluster_log(self, level: str, message: str) -> None:
        """Best-effort mon cluster-log entry (clog->warn role); a
        mid-election mon must not fail the health pass itself."""
        try:
            self.mon.log_entry(self.name, level, message)
        except (RuntimeError, AttributeError, IndexError):
            pass

    # ---- quota / full-ratio enforcement (the mon's PGMap-driven
    # OSDMonitor::tick role, fed from mgr-side usage digests) --------------
    def check_quotas_and_fullness(self) -> None:
        from ..common.config import g_conf
        from ..osdmap.osdmap import CEPH_OSDMAP_FULL, CEPH_OSDMAP_NEARFULL
        from ..osdmap.types import FLAG_FULL, FLAG_FULL_QUOTA
        mon = self.mon
        if mon is None or not mon.is_leader():
            # only the quorum leader's working map may be staged on —
            # flags pushed at a peon would sit diverged until IT was
            # elected, resurrecting stale state; skip and re-derive
            # from fresh usage next tick instead
            return
        dirty = False
        # pool quotas -> FLAG_FULL_QUOTA|FLAG_FULL (OSDMonitor
        # check_pool_quota semantics: exceed -> full, clear -> unfull)
        usage = self.pool_stats()
        for pid, pool in self.osdmap.pools.items():
            st = usage.get(pid, {"objects": 0, "bytes": 0})
            over = ((pool.quota_max_objects and
                     st["objects"] >= pool.quota_max_objects) or
                    (pool.quota_max_bytes and
                     st["bytes"] >= pool.quota_max_bytes))
            if over:
                dirty |= mon.set_pool_flags(
                    pid, set_mask=FLAG_FULL | FLAG_FULL_QUOTA)
            elif pool.has_flag(FLAG_FULL_QUOTA):
                # only clear FULL we set ourselves (quota-driven)
                dirty |= mon.set_pool_flags(
                    pid, clear_mask=FLAG_FULL | FLAG_FULL_QUOTA)
        # osd fill ratios -> cluster FULL/NEARFULL flags + health
        full_r = float(g_conf.get_val("mon_osd_full_ratio") or 0.95)
        near_r = float(g_conf.get_val("mon_osd_nearfull_ratio") or 0.85)
        full_osds, near_osds = [], []
        for osd, (used, cap) in self.osd_stats.items():
            if not cap:
                continue
            if not self.osdmap.exists(osd) or not self.osdmap.is_up(osd):
                # a dead/removed OSD's last report must not pin the
                # cluster full forever; its data is re-placed anyway
                continue
            ratio = used / cap
            if ratio >= full_r:
                full_osds.append(osd)
            elif ratio >= near_r:
                near_osds.append(osd)
        # both health entries are recomputed every pass so neither can
        # go stale while the other branch is active
        if full_osds:
            dirty |= mon.set_cluster_flags(set_mask=CEPH_OSDMAP_FULL |
                                           CEPH_OSDMAP_NEARFULL)
            self.health_checks["OSD_FULL"] = (
                f"osd(s) {sorted(full_osds)} are full; writes blocked")
        else:
            dirty |= mon.set_cluster_flags(clear_mask=CEPH_OSDMAP_FULL)
            self.health_checks.pop("OSD_FULL", None)
        if near_osds:
            if not full_osds:
                dirty |= mon.set_cluster_flags(
                    set_mask=CEPH_OSDMAP_NEARFULL)
            self.health_checks["OSD_NEARFULL"] = (
                f"osd(s) {sorted(near_osds)} are near full")
        else:
            self.health_checks.pop("OSD_NEARFULL", None)
            if not full_osds:
                dirty |= mon.set_cluster_flags(
                    clear_mask=CEPH_OSDMAP_NEARFULL)
        if dirty:
            try:
                mon.publish()
            except RuntimeError:
                # mid-election / not the leader: flags are staged on
                # this mon's working map; the next elected leader's
                # publish (or our next tick) lands them
                return
            self.network.pump()

    # ---- pg_autoscaler module ----------------------------------------------
    def pool_stats(self) -> Dict[int, Dict[str, int]]:
        """Per-pool usage aggregated from primaries' MPGStats reports
        (the mgr's PGMap-digest role).  Stale entries for PGs a pool no
        longer has (pre-split parents never re-report) are skipped."""
        out: Dict[int, Dict[str, int]] = {}
        stale = []
        for (pool, ps), (_e, n_obj, n_bytes) in self.pg_stats.items():
            p = self.osdmap.pools.get(pool)
            if p is None or ps >= p.pg_num:
                stale.append((pool, ps))   # deleted pool / split parent
                continue
            d = out.setdefault(pool, {"objects": 0, "bytes": 0,
                                      "pgs_reporting": 0})
            d["objects"] += n_obj
            d["bytes"] += n_bytes
            d["pgs_reporting"] += 1
        for key in stale:
            del self.pg_stats[key]
        return out

    def pg_autoscale(self, target_pgs_per_osd: int = 100,
                     threshold: float = 3.0,
                     apply: bool = False) -> List[Dict]:
        """Recommend (and optionally apply) per-pool pg_num targets
        (pybind/mgr/pg_autoscaler/module.py): each pool's share of the
        cluster's used bytes earns it a share of the PG budget
        (target_pgs_per_osd x in-OSDs), divided by its replication
        cost, rounded to a power of two.  A change is recommended only
        when the pool is off by *threshold* in either direction; only
        growth can be applied (splitting exists, merging does not — a
        shrink recommendation is report-only, like the reference's
        warn mode)."""
        m = self.osdmap
        n_in = self.num_in_osds()
        stats = self.pool_stats()
        total_bytes = sum(d["bytes"] for d in stats.values())
        budget = target_pgs_per_osd * max(n_in, 1)
        out: List[Dict] = []
        for pid, pool in sorted(m.pools.items()):
            used = stats.get(pid, {}).get("bytes", 0)
            if total_bytes <= 0:
                # empty cluster: spread the budget evenly
                ratio = 1.0 / max(len(m.pools), 1)
            else:
                ratio = used / total_bytes
            raw = ratio * budget / max(pool.size, 1)
            target = 1
            while target * 2 <= max(raw, 1):
                target *= 2
            target = max(target, 4)      # pg_num_min floor
            action = "ok"
            if target >= pool.pg_num * threshold:
                action = "grow"
            elif target * threshold <= pool.pg_num:
                action = "shrink (report-only)"
            ent = {"pool_id": pid,
                   "pool": m.pool_name.get(pid, str(pid)),
                   "bytes": used, "ratio": round(ratio, 4),
                   "pg_num": pool.pg_num, "target": target,
                   "action": action}
            if apply and action == "grow":
                # grow like an operator would: pg_num first (children
                # split in place), then pgp_num (children spread to
                # their own CRUSH positions, pg_temp-primed)
                name = m.pool_name[pid]
                self.mon.set_pool_pg_num(name, target)
                self.mon.publish()
                self.mon.set_pool_pgp_num(name, target)
                self.mon.publish()
                self.network.pump()
                ent["applied"] = True
            out.append(ent)
        return out

    def num_in_osds(self) -> int:
        m = self.osdmap
        return sum(1 for o in range(m.max_osd)
                   if m.exists(o) and m.osd_weight[o] > 0)

    # ---- status module -----------------------------------------------------
    def status(self) -> Dict:
        m = self.osdmap
        n_up = sum(1 for o in range(m.max_osd) if m.is_up(o))
        n_in = self.num_in_osds()
        return {
            "epoch": m.epoch,
            "num_osds": m.max_osd,
            "num_up_osds": n_up,
            "num_in_osds": n_in,
            "num_pools": len(m.pools),
            "num_pgs": sum(p.pg_num for p in m.pools.values()),
            "num_pg_upmap_items": len(m.pg_upmap_items),
            "balancer_active": self.balancer_active,
            "last_optimize_result": self.last_optimize_result,
            "osdmap_flags": m.flags,
            "health_checks": dict(self.health_checks),
        }

    # ---- prometheus module -------------------------------------------------
    @staticmethod
    def _prom_name(raw: str) -> str:
        """Sanitize to the exposition-format name charset."""
        import re
        return re.sub(r"[^a-zA-Z0-9_:]", "_", raw)

    def prometheus_metrics(self, perf_collection=None, histograms=None,
                           kernel_timer=None, slow_ops=None) -> str:
        """Prometheus text exposition of cluster gauges + perf counters
        (pybind/mgr/prometheus/module.py role), grown the observability
        surfaces: ``histograms`` (a PerfHistogramCollection) renders as
        real ``# TYPE ... histogram`` families with cumulative
        ``_bucket{le=...}`` series over the latency axis (usec buckets
        exported as seconds), ``kernel_timer`` as dispatch-total
        counters, and ``slow_ops`` ({daemon: count}) as gauges.  The
        JAX package's breaker gauges (``ceph_tpu_codec_degraded``,
        ``ceph_tpu_codec_breaker_open``) have no source in the port."""
        s = self.status()
        lines: List[str] = []

        def gauge(name: str, value, help_: str, labels: str = "") -> None:
            lines.append(f"# HELP ceph_{name} {help_}")
            lines.append(f"# TYPE ceph_{name} gauge")
            lines.append(f"ceph_{name}{labels} {value}")

        gauge("osdmap_epoch", s["epoch"], "Current osdmap epoch")
        gauge("osd_up", s["num_up_osds"], "OSDs up")
        gauge("osd_in", s["num_in_osds"], "OSDs in")
        gauge("pools", s["num_pools"], "Pools")
        gauge("pgs", s["num_pgs"], "Placement groups")
        if self.health_checks:
            lines.append("# HELP ceph_health_check active cluster "
                         "health checks (1 = raised)")
            lines.append("# TYPE ceph_health_check gauge")
            for check in sorted(self.health_checks):
                lines.append(f'ceph_health_check'
                             f'{{check="{self._prom_name(check)}"}} 1')
        # the ceph_cluster_* families render from the SAME rollup
        # snapshot function `telemetry dump` and `tpu status` serve
        # (telemetry.rollup), so the scrape surfaces cannot drift
        lines.extend(self._render_cluster_rollup(self.telemetry))
        # control-plane rollup: total actuations this mgr has applied
        # (the per-kind breakdown rides ceph_daemon_control_*)
        lines.append("# HELP ceph_cluster_control_moves knob "
                     "actuations applied by the mgr control plane")
        lines.append("# TYPE ceph_cluster_control_moves gauge")
        lines.append(f"ceph_cluster_control_moves "
                     f"{self.control.moves_total}")
        lines.append("# HELP ceph_cluster_incidents_total incident "
                     "bundles captured by this mgr")
        lines.append("# TYPE ceph_cluster_incidents_total gauge")
        lines.append(f"ceph_cluster_incidents_total "
                     f"{self.incident.captures_total}")
        # chaos rollup: storylines executed / accepted in this process
        # (the full per-scenario breakdown rides the chaos logger below)
        from ..chaos.engine import (chaos_perf_counters,
                                    l_chaos_accept_pass, l_chaos_scenarios)
        cpc = chaos_perf_counters()
        lines.append("# HELP ceph_cluster_chaos_scenarios composed-"
                     "chaos storylines executed end to end")
        lines.append("# TYPE ceph_cluster_chaos_scenarios gauge")
        lines.append(f"ceph_cluster_chaos_scenarios "
                     f"{cpc.get(l_chaos_scenarios)}")
        lines.append("# HELP ceph_cluster_chaos_accepted composed-"
                     "chaos storylines that passed universal acceptance")
        lines.append("# TYPE ceph_cluster_chaos_accepted gauge")
        lines.append(f"ceph_cluster_chaos_accepted "
                     f"{cpc.get(l_chaos_accept_pass)}")
        if perf_collection is not None:
            dump = perf_collection.dump()
            for logger, counters in sorted(dump.items()):
                if not isinstance(counters, dict):
                    continue
                for cname, val in sorted(counters.items()):
                    if not isinstance(val, (int, float)):
                        continue
                    metric = self._prom_name(f"{logger}_{cname}")
                    lines.append(
                        f"ceph_daemon_{metric} {val}")
        if histograms is not None:
            lines.extend(self._render_histograms(histograms))
        if kernel_timer is not None:
            stats = kernel_timer.dump()
            if stats:
                lines.append("# HELP ceph_kernel_dispatch_seconds_total "
                             "cumulative device dispatch wall time")
                lines.append(
                    "# TYPE ceph_kernel_dispatch_seconds_total counter")
                for kname, st in sorted(stats.items()):
                    lines.append(
                        f'ceph_kernel_dispatch_seconds_total'
                        f'{{kernel="{self._prom_name(kname)}"}} '
                        f'{st["total_s"]}')
                lines.append("# HELP ceph_kernel_dispatch_calls_total "
                             "device dispatches timed")
                lines.append(
                    "# TYPE ceph_kernel_dispatch_calls_total counter")
                for kname, st in sorted(stats.items()):
                    lines.append(
                        f'ceph_kernel_dispatch_calls_total'
                        f'{{kernel="{self._prom_name(kname)}"}} '
                        f'{st["calls"]}')
        if slow_ops is not None:
            lines.append("# HELP ceph_daemon_slow_ops ops slower than "
                         "complaint_time in the flight recorder")
            lines.append("# TYPE ceph_daemon_slow_ops gauge")
            for daemon, n in sorted(slow_ops.items()):
                lines.append(f'ceph_daemon_slow_ops'
                             f'{{daemon="{self._prom_name(daemon)}"}} {n}')
        return "\n".join(lines) + "\n"

    def _render_cluster_rollup(self, telemetry) -> List[str]:
        """The ``ceph_cluster_*`` families: per-stage cluster
        percentiles + rates out of THE shared rollup snapshot
        (telemetry.rollup — the same function ``telemetry dump`` and
        ``tpu status`` render from, so the surfaces cannot drift).
        SLO breach state itself rides ``ceph_health_check`` via
        ``health_checks`` like every other check; the burn-rate
        gauges here carry the continuous signal."""
        roll = telemetry.rollup()
        out: List[str] = []
        for q in ("p50", "p99", "p999"):
            fam = f"ceph_cluster_oplat_{q}_usec"
            out.append(f"# HELP {fam} cluster-merged oplat stage "
                       f"{q} (union of every daemon's buckets, "
                       f"rollup window)")
            out.append(f"# TYPE {fam} gauge")
            for stage in sorted(roll["oplat"]):
                out.append(f'{fam}{{stage='
                           f'"{self._prom_name(stage)}"}} '
                           f'{roll["oplat"][stage][q]}')
        for key in sorted(roll["rates"]):
            fam = f"ceph_cluster_rate_{self._prom_name(key)}"
            out.append(f"# HELP {fam} cluster {key} per second over "
                       f"the rollup window")
            out.append(f"# TYPE {fam} gauge")
            out.append(f"{fam} {roll['rates'][key]}")
        slo = roll.get("slo", {})
        if slo:
            out.append("# HELP ceph_cluster_slo_burn SLO burn rate "
                       "(observed/objective) per check and window")
            out.append("# TYPE ceph_cluster_slo_burn gauge")
            for check in sorted(slo):
                c = self._prom_name(check)
                out.append(f'ceph_cluster_slo_burn{{check="{c}",'
                           f'window="fast"}} {slo[check]["burn_fast"]}')
                out.append(f'ceph_cluster_slo_burn{{check="{c}",'
                           f'window="slow"}} {slo[check]["burn_slow"]}')
        return out

    def _render_histograms(self, histograms) -> List[str]:
        """One Prometheus histogram family per histogram NAME, a series
        per daemon (label), buckets cumulative over the latency axis."""
        by_name: Dict[str, List] = {}
        for (logger, hname), hist in histograms.items():
            by_name.setdefault(hname, []).append((logger, hist))
        out: List[str] = []
        for hname in sorted(by_name):
            base = self._prom_name(f"ceph_{hname}")
            # axis-0 unit drives the exported scale: usec axes render
            # as seconds (Prometheus convention); dimensionless axes
            # (e.g. the dispatcher's batch occupancy) render raw
            ax0 = by_name[hname][0][1].axes[0]
            usec = ax0.name.endswith("_usec")
            scale = 1e6 if usec else 1.0
            unit = "seconds" if usec else ax0.name
            out.append(f"# HELP {base} {ax0.name} distribution "
                       f"(axis buckets exported as {unit})")
            out.append(f"# TYPE {base} histogram")
            for logger, hist in sorted(by_name[hname]):
                label = self._prom_name(logger)
                for edge, cum in hist.cumulative_axis0():
                    le = "+Inf" if edge == float("inf") \
                        else repr(edge / scale)
                    out.append(f'{base}_bucket{{daemon="{label}",'
                               f'le="{le}"}} {cum}')
                out.append(f'{base}_sum{{daemon="{label}"}} '
                           f'{hist.axis0_sum / scale}')
                out.append(f'{base}_count{{daemon="{label}"}} '
                           f'{hist.total_count}')
        return out
