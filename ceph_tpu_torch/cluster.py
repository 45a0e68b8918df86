"""vstart-lite: a single-process mini cluster.

The reference's qa tiers spin real daemons on localhost (src/vstart.sh,
qa/standalone/ceph-helpers.sh); the equivalent here is one process
wiring mon + N OSDs + clients over the deterministic messenger fabric, with
the Thrasher controls (qa/tasks/ceph_manager.py:195 kill_osd, :373
revive_osd, :360 blackhole) as first-class methods.  All EC compute inside
the OSDs runs through the device codec.

Port of ``ceph_tpu/cluster.py``.  EC pools default to the ``cuda``
plugin (give the profile ``"backend": "host"`` to run on the CPU).  The
port has no codec circuit breakers, so the ``breaker dump`` command, the
breaker gauges of the Prometheus scrape and ``breakers_open`` in ``tpu
status`` are absent.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from .client import RadosClient
from .common import AdminSocket, PerfCountersCollection
from .common.config import g_conf
from .mon import Monitor
from .msg import Network
from .osd.osd import OSD


class MiniCluster:
    def __init__(self, n_osds: int = 6, osds_per_host: int = 1,
                 n_mons: int = 1,
                 _stores: Optional[Dict[int, object]] = None,
                 _bootstrap: bool = True):
        self.network = Network()
        if n_mons == 1:
            self.mons = [Monitor(self.network)]
        else:
            names = [f"mon.{r}" for r in range(n_mons)]
            self.mons = [
                Monitor(self.network, name=names[r], rank=r,
                        peers=[n for n in names if n != names[r]])
                for r in range(n_mons)]
        if _bootstrap:
            self.mons[0].bootstrap(n_osds, osds_per_host)
        if n_mons > 1:
            # initial election: rank 0 wins; recovery syncs the quorum
            self.mons[0].start_election()
            self.network.pump()
            if _bootstrap:
                # commit the bootstrap topology as epoch 1 so it is
                # replicated — a leader failover before the first pool
                # creation must not lose the cluster topology
                self.mons[0].publish()
                self.network.pump()
        self.osds: Dict[int, OSD] = {}
        self.perf_collection = PerfCountersCollection()
        mon_names = [m.name for m in self.mons]
        for i in range(n_osds):
            store = _stores.get(i) if _stores else None
            osd = OSD(self.network, i, store=store,
                      mon_name=mon_names[0], mon_names=mon_names)
            self.osds[i] = osd
            for m in self.mons:
                m.subscribe(osd.name)
            self.perf_collection.add(osd.perf_counters)
        if n_mons > 1 and _bootstrap:
            # osds subscribed after the bootstrap epoch: catch them up
            for osd in self.osds.values():
                self.mons[0].send_full_map(osd.name)
            self.network.pump()
        self.clock = 0.0
        from .mgr import Manager
        # the mgr always talks to the CURRENT leader (failover-safe)
        self.mgr = Manager(self.network, lambda: self.mon,
                           all_mons=self.mons)
        self.admin_socket = AdminSocket()
        self._register_admin_commands()
        # deterministic-fabric idle kick: once the message queue drains,
        # (1) flush encodes the async EC write pipeline parked in the
        # dispatch scheduler's collection window — their continuations
        # fan out the sub-op writes pump() then delivers — and (2)
        # resend unacked sub-writes (quiescence proves the message or
        # its ack was dropped).  Both are bounded, so pump terminates.
        self.network.add_idle_hook(self._idle_kick)

    def _idle_kick(self) -> bool:
        from .dispatch import g_dispatcher
        did = bool(g_dispatcher.pending_count() and g_dispatcher.flush())
        # threaded op queues defer pipeline continuations back through
        # the sharded wq — flush the pools so their fan-out reaches the
        # wire before pump decides the fabric is quiescent.  With
        # osd_op_queue_batch_intake, synchronous OSDs also leave intake
        # bursts queued until quiescence: drain them here so the mClock
        # tiers arbitrate the whole pump's burst at once (docs/QOS.md)
        for osd in self.osds.values():
            if osd.name in self.network.down:
                continue
            if len(osd.op_wq):
                if osd.op_tp is not None:
                    osd.drain_ops()
                    did = True
                else:
                    # wall-mode rate-blocked ops stay queued (the tick
                    # re-drives them); a zero-handled drain must not
                    # report progress or pump would spin
                    did = bool(osd.drain_ops()) or did
        if did:
            return True     # let pump drain the fan-out first
        for osd in self.osds.values():
            if osd.name in self.network.down:
                continue
            for pg in osd.pgs.values():
                be = pg.backend
                if be is not None and be.inflight_writes:
                    did = bool(be.sweep_inflight(idle=True)) or did
        return did

    @property
    def mon(self) -> Monitor:
        """The current live leader — the mon everything talks to;
        single-mon clusters return the only monitor.  During a failover
        window (no live leader yet) this returns a live mon for reads;
        mutations on it raise until a quorum re-forms (Monitor.publish
        guards), matching the reference's commands-stall-without-quorum
        behavior."""
        live = [m for m in self.mons if m.name not in self.network.down]
        for m in live:
            if m.is_leader():
                return m
        return live[0] if live else self.mons[0]

    # ---- checkpoint / resume (OSD.cc:2469+ init/resume model) --------------
    def checkpoint(self, directory: str) -> None:
        """Persist the whole cluster: mon store + every OSD's object
        store.  Resume with ``MiniCluster.restore``."""
        import os
        os.makedirs(directory, exist_ok=True)
        self.mon.save(os.path.join(directory, "mon.json"))
        meta = {"n_osds": len(self.osds), "n_mons": len(self.mons)}
        for i, osd in self.osds.items():
            osd.store.save(os.path.join(directory, f"osd.{i}.store"))
        import json
        with open(os.path.join(directory, "cluster.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def restore(cls, directory: str) -> "MiniCluster":
        """Cold-start from a checkpoint: mount every store, load the mon
        map history, replay to the current epoch, re-peer; objects come
        back byte-exact."""
        import json
        import os
        from .os_store import MemStore
        with open(os.path.join(directory, "cluster.json")) as f:
            meta = json.load(f)
        n = meta["n_osds"]
        n_mons = meta.get("n_mons", 1)
        stores = {i: MemStore.load(os.path.join(directory, f"osd.{i}.store"))
                  for i in range(n)}
        c = cls(n_osds=n, n_mons=n_mons, _stores=stores, _bootstrap=False)
        c.mons[0].load(os.path.join(directory, "mon.json"))
        if n_mons > 1:
            # re-elect so the collect/last recovery replays the loaded
            # history onto the (empty) peons
            c.mons[0].start_election()
            c.network.pump()
        # boot: every osd catches up on the full map history and re-peers
        for osd in c.osds.values():
            c.mons[0].send_full_map(osd.name)
        c.network.pump()
        c.run_recovery()
        return c

    def _register_admin_commands(self) -> None:
        asok = self.admin_socket
        asok.register("perf dump",
                      lambda c, a: self.perf_collection.dump(
                          a.get("logger", ""), a.get("counter", "")),
                      "dump perfcounters")
        asok.register("config show", lambda c, a: g_conf.show_config(),
                      "show config values")

        def _config_set(c, a):
            # runtime reconfiguration with observer notification — the
            # `ceph daemon X config set` / `ceph tell ... injectargs`
            # role (md_config_t::set_val + apply_changes); validation
            # lives in ConfigProxy.set_checked, shared with the OSD's
            # wire MCommand handler
            out = g_conf.set_checked(a.get("name", ""),
                                     a.get("value", ""))
            out["success"] = True
            return out

        asok.register("config set", _config_set,
                      "set a config option at runtime")
        asok.register("config get",
                      lambda c, a: g_conf.get_checked(
                          a.get("name", "")),
                      "get one config value")
        asok.register("status",
                      lambda c, a: {"health": self.health(),
                                    "epoch": self.mon.osdmap.epoch,
                                    "num_osds": len(self.osds),
                                    "pg_states": self.pg_states()},
                      "cluster status")
        asok.register(
            "dump_historic_ops",
            lambda c, a: {o.name: o.op_tracker.dump_historic_ops()
                          for o in self.osds.values()},
            "recent completed ops with event timelines")
        asok.register(
            "dump_historic_slow_ops",
            lambda c, a: {o.name: o.op_tracker.dump_historic_slow_ops()
                          for o in self.osds.values()},
            "ops over complaint_time, with flight-recorded span trees")
        asok.register(
            "dump_ops_in_flight",
            lambda c, a: {o.name: o.op_tracker.dump_ops_in_flight()
                          for o in self.osds.values()},
            "in-flight ops")
        asok.register("mgr status", lambda c, a: self.mgr.status(),
                      "manager module status")
        asok.register(
            "balancer optimize",
            lambda c, a: {"changes": self.mgr.balancer_optimize()},
            "run one upmap balancer pass")
        from .common import g_kernel_timer
        from .trace import (devprof_perf_counters, g_devprof,
                            g_flight_recorder, g_perf_histograms,
                            g_tracer)
        def _prometheus(c, a):
            # refresh the devprof device-memory high-water gauge so
            # the scrape carries a current sample (scrape-time only —
            # never on the op path)
            g_devprof.sample_device_mem()
            return self.mgr.prometheus_metrics(
                self.perf_collection,
                histograms=g_perf_histograms,
                kernel_timer=g_kernel_timer,
                slow_ops={o.name: o.op_tracker.num_slow_ops
                          for o in self.osds.values()})

        asok.register("prometheus metrics", _prometheus,
                      "prometheus text exposition")
        asok.register(
            "perf histogram dump",
            lambda c, a: g_perf_histograms.dump(
                a.get("logger", ""), a.get("name", "")),
            "dump 1D/2D perf histograms (axes + count grids)")
        asok.register(
            "dump_tracing",
            lambda c, a: {"enabled": g_tracer.enabled,
                          "spans": g_tracer.collector.dump(
                              a.get("daemon", "")),
                          "flight_recorder": g_flight_recorder.dump()},
            "recent spans per daemon + slow-op flight recorder")
        asok.register(
            "span tracing",
            lambda c, a: (g_tracer.enable(
                str(a.get("on", "1")).lower() in ("1", "true", "on")),
                {"enabled": g_tracer.enabled})[1],
            "enable/disable span tracing (host-side; zero device syncs)")
        asok.register(
            "pg_autoscale status",
            lambda c, a: self.mgr.pg_autoscale(apply=False),
            "per-pool pg_num recommendations (dry run)")
        from .common import g_kernel_timer, get_log, \
            register_config_observers
        register_config_observers(g_conf)
        asok.register(
            "log dump",
            lambda c, a: {"lines": get_log().dump_recent(
                int(a.get("n", 0) or 0), a.get("subsys", ""))},
            "dump the recent in-memory log ring")
        asok.register(
            "log set",
            lambda c, a: (g_conf.set_val(f"debug_{a['subsys']}",
                                         a["level"]),
                          {"ok": True})[1],
            "set debug_<subsys> level (log/gather)")
        asok.register(
            "kernel timings",
            lambda c, a: g_kernel_timer.dump(),
            "cumulative per-kernel device dispatch timings")
        asok.register(
            "kernel tracing",
            lambda c, a: (g_kernel_timer.enable(
                str(a.get("on", "1")).lower() in ("1", "true", "on")),
                {"enabled": g_kernel_timer.enabled})[1],
            "enable/disable per-kernel timing (adds a sync per call)")
        asok.register(
            "dump_op_pq_state",
            lambda c, a: {o.name: o.op_wq.dump()
                          for o in self.osds.values()},
            "per-shard op queue sizes and mclock tags")
        from .dispatch import dispatch_perf_counters, g_dispatcher
        self.perf_collection.add(dispatch_perf_counters())
        from .mesh import (g_chipstat, membership_perf_counters,
                           mesh_chip_perf_counters,
                           mesh_decode_perf_counters, mesh_perf_counters,
                           rateless_perf_counters)
        self.perf_collection.add(mesh_perf_counters())
        self.perf_collection.add(mesh_chip_perf_counters())
        self.perf_collection.add(rateless_perf_counters())
        self.perf_collection.add(membership_perf_counters())
        self.perf_collection.add(mesh_decode_perf_counters())
        asok.register(
            "mesh skew dump",
            lambda c, a: g_chipstat.dump(),
            "mesh chip-health scoreboard: per-chip probe EWMAs, skew "
            "ratios, suspects, per-chip latency percentiles")
        asok.register(
            "mesh skew reset",
            lambda c, a: (g_chipstat.reset(), {"reset": True})[1],
            "zero the chip-health scoreboard, its per-chip latency "
            "histogram and counters")
        from .osd.ec_backend import pipeline_perf_counters
        self.perf_collection.add(pipeline_perf_counters())
        from .common.work_queue import qos_perf_counters
        self.perf_collection.add(qos_perf_counters())
        asok.register(
            "dispatch dump",
            lambda c, a: g_dispatcher.dump(),
            "EC dispatch scheduler state: options, per-signature "
            "queues, counters, batch-occupancy histogram")
        asok.register(
            "dispatch flush",
            lambda c, a: {"flushed": g_dispatcher.flush()},
            "flush every pending EC dispatch queue now")
        from .trace import g_oplat, oplat_perf_counters
        self.perf_collection.add(oplat_perf_counters())
        asok.register(
            "latency dump",
            lambda c, a: g_oplat.dump(a.get("daemon", "")),
            "stage-latency ledger: per-daemon per-stage time "
            "attribution (count/total/share/p50/p99) for every op")
        asok.register(
            "latency reset",
            lambda c, a: (g_oplat.reset(), {"reset": True})[1],
            "zero the stage-latency ledger's histograms and counters")
        self.perf_collection.add(devprof_perf_counters())
        from .os_store import memstore_device_perf_counters
        self.perf_collection.add(memstore_device_perf_counters())
        asok.register(
            "prof dump",
            lambda c, a: g_devprof.dump(),
            "device-flow profiler: per-call-site host<->device "
            "transfers, compiles, host staging copies, device-memory "
            "high-water")
        asok.register(
            "prof reset",
            lambda c, a: (g_devprof.reset(), {"reset": True})[1],
            "zero the device-flow profiler's sites, counters and "
            "transfer-size histogram")
        from .recovery import aggregate_families, recovery_perf_counters
        self.perf_collection.add(recovery_perf_counters())
        asok.register(
            "recovery dump",
            lambda c, a: {
                "counters": recovery_perf_counters().dump(),
                "families": aggregate_families(self.osds.values()),
                "per_osd": {o.name: o.recovery_sched.dump()
                            for o in self.osds.values()},
            },
            "recovery scheduler state: pacing, per-codec-family "
            "bytes-moved-per-repaired-shard, repair vs full-stripe "
            "accounting")
        from .fault import fault_perf_counters, g_faults
        self.perf_collection.add(fault_perf_counters())

        def _fault_inject(c, a):
            # arm a site: fault inject name=<site> mode=prob|nth|once|
            # always [p=] [n=] [seed=] [count=] [error=device|timeout]
            # [match=]; validation errors surface as JSON like
            # every other asok hook
            casts = (("mode", str), ("p", float), ("n", int),
                     ("seed", int), ("count", int), ("error", str),
                     ("match", str), ("delay_us", int))
            unknown = set(a) - {"name"} - {k for k, _ in casts}
            if unknown:
                # a typo'd trigger key must not silently arm a very
                # different fault (mdoe=prob -> mode=always)
                raise ValueError(
                    f"unknown argument(s) {sorted(unknown)}; expected "
                    f"name, mode, p, n, seed, count, error, match, "
                    f"delay_us")
            kw = {}
            for key, cast in casts:
                if key in a:
                    try:
                        kw[key] = cast(a[key])
                    except (TypeError, ValueError):
                        raise ValueError(
                            f"invalid value '{a[key]}' for '{key}'")
            spec = g_faults.inject(a.get("name", ""), **kw)
            return {"site": spec.site, "armed": spec.dump()}

        asok.register(
            "fault inject", _fault_inject,
            "arm a fault-injection site (mode=prob|nth|once|always, "
            "p=, n=, seed=, count=, error=, match=, delay_us=)")
        asok.register(
            "fault list",
            lambda c, a: g_faults.list_sites()
            if a.get("format") == "json" else g_faults.dump(),
            "fault-injection site catalog + armed triggers "
            "(format=json for the machine-readable site list)")
        asok.register(
            "fault clear",
            lambda c, a: {"cleared": g_faults.clear(a.get("name", ""))},
            "disarm one site (name=) or every armed site")
        asok.register(
            "tpu status", lambda c, a: self.tpu_status(),
            "single-pane cluster status: health, cluster-merged "
            "per-stage p99s, rates, SLO state")
        asok.register(
            "telemetry dump",
            lambda c, a: self.mgr.telemetry.dump(),
            "mgr telemetry rollup: cluster-merged family percentiles, "
            "rates and SLO burn state over the fast window")
        asok.register(
            "telemetry reset",
            lambda c, a: (self.mgr.telemetry.reset(),
                          {"reset": True})[1],
            "drop the telemetry rings and SLO streaks (per-daemon "
            "histograms/counters untouched)")
        from .control import control_perf_counters
        self.perf_collection.add(control_perf_counters())
        asok.register(
            "tpu control dump",
            lambda c, a: self.mgr.control.dump(),
            "control-plane pane: enable/bounds/cooldown state per "
            "knob, the active abuser, and the actuation ledger")

        def _control_enable(c, a, value):
            from .common.config import g_conf
            g_conf.set_checked("mgr_control_enable", value)
            if not value:
                # a disable must tear the episode down NOW, not at
                # the next tick (no half-applied knob survives)
                self.mgr.control.teardown(
                    self.mgr, reason="control disable")
            return {"enabled": value}

        asok.register(
            "control enable",
            lambda c, a: _control_enable(c, a, True),
            "turn the mgr feedback controller on "
            "(mgr_control_enable = true)")
        asok.register(
            "control disable",
            lambda c, a: _control_enable(c, a, False),
            "turn the controller off and restore every engaged knob "
            "to its episode baseline immediately")
        asok.register(
            "control reset",
            lambda c, a: {"reset": True,
                          "restored": self.mgr.control.reset(self.mgr)},
            "tear down any episode, then drop the ledger, tick count "
            "and sense caches")
        from .mgr.incident import incident_perf_counters
        from .trace.journal import g_journal, journal_perf_counters
        self.perf_collection.add(journal_perf_counters())
        self.perf_collection.add(incident_perf_counters())
        # the mgr is a map subscriber with no daemon references; the
        # cluster wires the forensic slow-op source where the OSDs live
        self.mgr.incident.slow_ops_source = lambda: {
            o.name: o.op_tracker.dump_historic_slow_ops()
            for o in self.osds.values()}
        asok.register(
            "journal dump",
            lambda c, a: g_journal.dump(a.get("daemon", "")),
            "cluster event journal: bounded per-daemon rings of typed "
            "events on the deterministic clock (daemon= for one ring)")
        asok.register(
            "journal reset",
            lambda c, a: g_journal.reset(),
            "drop every journal ring (per-daemon sequence numbers "
            "keep counting)")
        asok.register(
            "tpu incident list",
            lambda c, a: self.mgr.incident.list(),
            "archived incident bundles: id, clock, state, trigger, "
            "timeline size")
        asok.register(
            "tpu incident dump",
            lambda c, a: self.mgr.incident.dump(
                int(a.get("id", 0) or 0)),
            "one incident bundle in full (newest unless id=)")

        def _incident_capture(c, a):
            bundle = self.mgr.incident.capture(
                "operator", "operator-requested capture",
                reason="operator")
            if bundle is None:
                return {"captured": False}
            return {"captured": True, "id": bundle["id"],
                    "events": len(bundle["timeline"])}

        asok.register(
            "tpu incident capture", _incident_capture,
            "snapshot an incident bundle now (same payload as an "
            "auto-capture; drops, never fails, under an injected "
            "mgr.incident_capture fault)")

        from .chaos import chaos_perf_counters
        self.perf_collection.add(chaos_perf_counters())

        def _chaos_compose(c, a):
            # compose-only: sample the storyline a seed deterministically
            # maps to, without executing it (legs= narrows the catalog:
            # comma-separated leg names)
            from .chaos import compose_scenario
            try:
                seed = int(a.get("seed", ""))
            except (TypeError, ValueError):
                raise ValueError("chaos compose requires seed=<int>")
            legs = None
            if a.get("legs"):
                legs = tuple(
                    s for s in str(a["legs"]).split(",") if s)
            return compose_scenario(seed, legs=legs).dump()

        asok.register(
            "chaos compose", _chaos_compose,
            "deterministically sample the composed-chaos storyline for "
            "seed=<int> (legs= to force the leg set) without running it")

        def _chaos_dump(c, a):
            from .chaos import engine_dump
            return engine_dump()

        asok.register(
            "chaos dump", _chaos_dump,
            "chaos engine pane: leg catalog, fault-site inventory, "
            "composer options, scenario counters")
        asok.register(
            "arch probe",
            lambda c, a: __import__("ceph_tpu_torch.arch", fromlist=["probe"])
            .probe(),
            "accelerator/host feature probe")

    # ---- pools ------------------------------------------------------------
    def create_ec_pool(self, name: str, k: int = 4, m: int = 2,
                       pg_num: int = 32, plugin: str = "cuda",
                       extra_profile: Optional[Dict[str, str]] = None,
                       failure_domain: str = "host",
                       ec_overwrites: bool = True) -> int:
        profile = {"plugin": plugin, "k": str(k), "m": str(m),
                   "crush-failure-domain": failure_domain}
        if extra_profile:
            profile.update(extra_profile)
        pname = f"{name}_profile"
        self.mon.create_ec_profile(pname, profile)
        pid = self.mon.create_ec_pool(name, pname, pg_num,
                                      ec_overwrites=ec_overwrites)
        self.publish()
        return pid

    def pool_snap_create(self, pool: str, snap: str) -> int:
        sid = self.mon.pool_snap_create(pool, snap)
        self.publish()
        return sid

    def pool_snap_rm(self, pool: str, snap: str) -> int:
        sid = self.mon.pool_snap_rm(pool, snap)
        self.publish()
        return sid

    def create_replicated_pool(self, name: str, size: int = 3,
                               pg_num: int = 32) -> int:
        pid = self.mon.create_replicated_pool(name, size, pg_num)
        self.publish()
        return pid

    def delete_pool(self, name: str) -> int:
        pid = self.mon.delete_pool(name)
        self.publish()
        return pid

    # ---- control ----------------------------------------------------------
    def publish(self) -> None:
        self.mon.publish()
        self.network.pump()
        self.run_recovery()

    def client(self, name: str = "client.0") -> RadosClient:
        return RadosClient(self.network, self.mon, name)

    def tick(self, dt: float = 1.0, rounds: int = 1) -> None:
        """Advance time: heartbeats fire, failures get detected, mon
        elections resolve."""
        for _ in range(rounds):
            self.clock += dt
            for m in self.mons:
                if m.name not in self.network.down:
                    m.tick(self.clock)
            for i, osd in self.osds.items():
                if osd.name not in self.network.down:
                    osd.tick(self.clock)
            self.network.pump()
            self.mgr.tick(self.clock)
        self.run_recovery()

    # ---- mon thrashing ------------------------------------------------------
    def kill_mon(self, rank: int) -> None:
        self.network.set_down(self.mons[rank].name, True)

    def revive_mon(self, rank: int) -> None:
        mon = self.mons[rank]
        self.network.set_down(mon.name, False)
        mon.start_election()  # rejoin: triggers re-election + catch-up
        self.network.pump()

    def scrub(self, deep: bool = True) -> None:
        """Background consistency pass over every PG (qa deep-scrub
        role): primaries collect shard scrub maps, inconsistencies become
        missing entries, recovery repairs them by decode — no client
        reads involved.  deep=False runs the metadata-only shallow
        variant (sizes + attr/omap digests, no data reads)."""
        for osd in self.osds.values():
            if osd.name in self.network.down:
                continue
            for pg in osd.pgs.values():
                if pg.is_primary():
                    pg.start_scrub(deep=deep)
        self.network.pump()
        self.run_recovery()

    def run_recovery(self, max_rounds: int = 4) -> int:
        total = 0
        for _ in range(max_rounds):
            pushed = 0
            for osd in self.osds.values():
                if osd.name not in self.network.down:
                    pushed += osd.run_recovery()
            self.network.pump()
            total += pushed
            if not pushed:
                break
        return total

    def restart_osd(self, osd_id: int) -> None:
        """Simulate a daemon restart: a fresh OSD process mounts the same
        object store — in-memory state (pg logs, inflight ops) must come
        back from disk (OSD::init, OSD.cc:2469+)."""
        old = self.osds[osd_id]
        old.shutdown()
        self.network.set_down(old.name, False)
        osd = OSD(self.network, osd_id, store=old.store,
                  mon_name=old.mon_name, mon_names=old.mon_names)
        self.osds[osd_id] = osd
        self.perf_collection.add(osd.perf_counters)  # replaces by name
        if not self.mon.osdmap.is_up(osd_id):
            self.mon.mark_osd_up(osd_id)
        self.mon.send_full_map(osd.name)
        self.network.pump()
        self.run_recovery()

    # ---- thrasher API ------------------------------------------------------
    def kill_osd(self, osd_id: int) -> None:
        """Hard-kill: the daemon stops answering anything
        (ceph_manager.py:195)."""
        self.network.set_down(f"osd.{osd_id}", True)

    def revive_osd(self, osd_id: int) -> None:
        """Bring the daemon back and let it catch up on maps
        (ceph_manager.py:373)."""
        self.network.set_down(f"osd.{osd_id}", False)
        osd = self.osds[osd_id]
        self.mon.mark_osd_up(osd_id)
        self.mon.send_full_map(osd.name)
        self.network.pump()
        self.run_recovery()

    def blackhole_osd(self, osd_id: int, on: bool = True) -> None:
        """Drop all traffic to the osd without killing it
        (ceph_manager.py:360)."""
        for name in list(self.network.endpoints):
            self.network.blackhole(name, f"osd.{osd_id}", on)

    def mark_osd_down(self, osd_id: int) -> None:
        self.mon.mark_osd_down(osd_id)
        self.network.pump()
        self.run_recovery()

    def mark_osd_out(self, osd_id: int) -> None:
        self.mon.mark_osd_out(osd_id)
        self.network.pump()
        self.run_recovery()

    def mark_osd_in(self, osd_id: int) -> None:
        self.mon.mark_osd_in(osd_id)
        self.network.pump()
        self.run_recovery()

    # ---- introspection -----------------------------------------------------
    def pg_states(self) -> Dict[str, str]:
        return {f"{pgid[0]}.{pgid[1]:x}": pg.state
                for pgid, pg in self.primary_pgs()}

    def primary_pgs(self):
        """(pgid, pg) for each PG's live primary — THE pg scan used by
        pg_states/health/CLIs so their accounting cannot drift."""
        seen = set()
        for osd in self.osds.values():
            if osd.name in self.network.down:
                continue
            for pgid, pg in osd.pgs.items():
                if pgid in seen or not pg.is_primary():
                    continue
                seen.add(pgid)
                yield pgid, pg

    def tpu_status(self) -> Dict:
        """The ``tpu status`` single pane (admin socket / ``ceph
        daemon``): one answer to "is the fleet inside its latency
        budget right now" — health (TPU_SLO_* checks included), the
        cluster-merged per-stage p99s, rates and SLO burn state, all from the mgr telemetry rollup's
        shared snapshot (telemetry.rollup) so this pane, ``telemetry
        dump`` and the Prometheus scrape cannot disagree."""
        from .mesh import g_chipstat
        tel = self.mgr.telemetry
        # freshen if the clock moved since the last mgr tick (a stale
        # or equal clock is a no-op, so this never skews rate windows)
        tel.tick(self.mgr, self.clock)
        roll = tel.rollup()
        skew = g_chipstat.summary()
        return {
            "health": self.health(),
            "samples": roll["samples"],
            "window_s": roll["window_s"],
            "cluster_p99_usec": roll["oplat_p99_usec"],
            "rates": roll["rates"],
            "copies_per_op": roll["copies_per_op"],
            "slo": {check: st["state"]
                    for check, st in roll["slo"].items()},
            # the chip-health scoreboard's verdict pane: suspects name
            # the chip and its skew ratio (TPU_MESH_SKEW's figures)
            "mesh_skew": {"probes": skew["probes"],
                          "suspects": skew["suspects"]},
            "objectives": roll["objectives"],
        }

    def health(self) -> str:
        """HEALTH_OK / HEALTH_WARN with reasons (mon health checks):
        down osds, degraded/peering pgs, pinned pg_temp remaps, the
        mgr's checks (TPU_CODEC_DEGRADED never raises in the port)."""
        # refresh the mgr's checks so health() is current even between
        # mgr ticks (tests and CLIs call it directly); the chip-skew
        # check's hysteresis lives in the scoreboard, so re-reading it
        # never flaps
        self.mgr.check_degraded_codecs()
        self.mgr.check_mesh_skew()
        reasons = []
        n_down = sum(1 for o in range(self.mon.osdmap.max_osd)
                     if not self.mon.osdmap.is_up(o))
        if n_down:
            reasons.append(f"{n_down} osds down")
        states = {}
        for _pgid, pg in self.primary_pgs():
            states[pg.state] = states.get(pg.state, 0) + 1
        bad = {st: n for st, n in states.items() if st != "active"}
        if bad:
            reasons.append("pgs " + ", ".join(
                f"{n} {st}" for st, n in sorted(bad.items())))
        if self.mon.osdmap.pg_temp:
            reasons.append(
                f"{len(self.mon.osdmap.pg_temp)} pgs remapped (pg_temp)")
        from .osdmap.osdmap import CEPH_OSDMAP_FULL, CEPH_OSDMAP_NEARFULL
        if self.mon.osdmap.flags & CEPH_OSDMAP_FULL:
            reasons.append("cluster is FULL; writes blocked")
        elif self.mon.osdmap.flags & CEPH_OSDMAP_NEARFULL:
            reasons.append("cluster is nearfull")
        for check, msg in sorted(self.mgr.health_checks.items()):
            reasons.append(f"{check}: {msg}")
        return "HEALTH_OK" if not reasons else \
            "HEALTH_WARN " + "; ".join(reasons)
