"""Typed option registry + config proxy.

Port of ``ceph_tpu/common/config.py``, the same behaviour under the same names.

Mirrors the reference's central option table and md_config_t semantics
(src/common/options.cc — ~7k typed options with levels/defaults/
descriptions; src/common/config.{h,cc} with change observers): options are
declared once with type/default/description, values resolve
override → default, and observers get notified on runtime changes
(`ceph tell ... injectargs` analog).  Only the options this framework
actually consumes are declared; the mechanism matches.
"""
from __future__ import annotations

import configparser
from typing import Any, Callable, Dict, List, Optional

OPT_INT = "int"
OPT_STR = "str"
OPT_FLOAT = "float"
OPT_DOUBLE = "double"
OPT_BOOL = "bool"

LEVEL_BASIC = "basic"
LEVEL_ADVANCED = "advanced"
LEVEL_DEV = "dev"


class Option:
    def __init__(self, name: str, type: str, level: str = LEVEL_ADVANCED):
        self.name = name
        self.type = type
        self.level = level
        self.default: Any = None
        self.description = ""
        self.long_description = ""

    def set_default(self, v) -> "Option":
        self.default = v
        return self

    def set_description(self, d: str) -> "Option":
        self.description = d
        return self

    def set_long_description(self, d: str) -> "Option":
        self.long_description = d
        return self

    def cast(self, v):
        if self.type == OPT_INT:
            return int(v)
        if self.type in (OPT_FLOAT, OPT_DOUBLE):
            return float(v)
        if self.type == OPT_BOOL:
            return v if isinstance(v, bool) \
                else str(v).lower() in ("true", "1", "yes", "on")
        return str(v)


def _subsys_defaults():
    from .dout import SUBSYS_DEFAULTS
    return sorted(SUBSYS_DEFAULTS.items())


def build_options() -> List[Option]:
    """The option table (subset of src/common/options.cc this build uses)."""
    return [
        Option("osd_pool_default_size", OPT_INT).set_default(3)
        .set_description("the number of copies of an object"),
        Option("osd_pool_default_min_size", OPT_INT).set_default(0)
        .set_description("minimum replicas before a write is acked"),
        Option("osd_pool_default_pg_num", OPT_INT).set_default(32)
        .set_description("number of PGs for new pools"),
        Option("osd_pool_erasure_code_stripe_unit", OPT_INT)
        .set_default(4096)
        .set_description("stripe unit (bytes) for EC pool chunks"),
        Option("osd_heartbeat_interval", OPT_FLOAT).set_default(6.0)
        .set_description("seconds between peer heartbeats"),
        Option("osd_heartbeat_grace", OPT_FLOAT).set_default(20.0)
        .set_description("seconds of silence before reporting a peer"),
        Option("osd_erasure_code_plugins", OPT_STR)
        .set_default("tpu isa jerasure lrc shec")
        .set_description("EC plugins to preload at start"),
        Option("erasure_code_dir", OPT_STR).set_default("")
        .set_description("plugin directory (reference options.cc:311; "
                         "python registry needs none)"),
        Option("mon_max_pg_per_osd", OPT_INT).set_default(250),
        Option("crush_device_fast_mapper", OPT_BOOL).set_default(True)
        .set_description("use the device candidate-table CRUSH mapper"),
        Option("crush_fast_tries_cap", OPT_INT).set_default(4)
        .set_description("retries materialized on device before host "
                         "residual fallback"),
        Option("ec_device_batch", OPT_INT).set_default(64)
        .set_description("stripes per batched device encode call"),
        Option("ec_dispatch_batch_max", OPT_INT).set_default(64)
        .set_description("EC dispatch scheduler: requests per codec "
                         "signature that trigger an immediate coalesced "
                         "flush (ceph_tpu/dispatch)"),
        Option("ec_dispatch_batch_window_us", OPT_INT).set_default(0)
        .set_description("EC dispatch scheduler: collection window in "
                         "microseconds before a queued request's batch "
                         "flushes; 0 = exact passthrough to the "
                         "uncoalesced per-op device call"),
        Option("ec_dispatch_queue_max", OPT_INT).set_default(1024)
        .set_description("EC dispatch scheduler: total pending requests "
                         "across all queues before a forced "
                         "backpressure flush"),
        Option("ec_mesh_chips", OPT_INT).set_default(0)
        .set_description("devices in the dispatch mesh runtime "
                         "(ceph_tpu/mesh): flushed encode batches "
                         "shard their stripe rows across a 1-D batch-"
                         "axis mesh of this many chips.  0 = mesh off "
                         "(single-device dispatch, the existing path "
                         "by construction); -1 = all addressable "
                         "devices; N > 1 = the first N (clamped to "
                         "what the process can see)"),
        Option("ec_mesh_pool_buffers", OPT_INT).set_default(4)
        .set_description("padded staging buffers the mesh runtime "
                         "retains per batch shape for reuse across "
                         "flushes (ceph_tpu/mesh/pool)"),
        Option("ec_mesh_donate", OPT_BOOL).set_default(True)
        .set_description("donate the sharded batch buffer to the mesh "
                         "encode (donate_argnums) so the device "
                         "recycles it into the output; ignored on "
                         "backends without buffer aliasing (cpu)"),
        Option("ec_mesh_rateless", OPT_BOOL).set_default(False)
        .set_description("rateless coded mesh encode "
                         "(ceph_tpu/mesh/rateless): over-decompose "
                         "each flushed encode batch into more coded "
                         "row-blocks than chips and complete the "
                         "flush from the FIRST sufficient subset of "
                         "chips — a slow or dead chip costs "
                         "bandwidth, never latency.  Off (default) = "
                         "the block-sharded SPMD mesh path"),
        Option("ec_mesh_rateless_tasks", OPT_INT).set_default(0)
        .set_description("total coded row-blocks per rateless mesh "
                         "flush (systematic blocks — one per chip — "
                         "plus GF(2^8) random-combination parity "
                         "blocks).  0 = auto (mesh size + 2 parity "
                         "blocks); values are clamped to at least "
                         "mesh size + 1 so every flush carries "
                         "redundancy"),
        Option("ec_mesh_skew_sample_every", OPT_INT).set_default(16)
        .set_description("sampled per-chip skew probes: every Nth mesh "
                         "flush drains one element per chip shard and "
                         "records per-chip completion deltas on the "
                         "chip-health scoreboard "
                         "(ceph_tpu/mesh/chipstat).  0 = probing off; "
                         "the OSD tick additionally guarantees the "
                         "next flush after quiet traffic probes "
                         "(cadence floor)"),
        Option("ec_mesh_skew_threshold", OPT_FLOAT).set_default(3.0)
        .set_description("per-chip probe service time over the mesh "
                         "median at or above this ratio on 3 "
                         "consecutive probes marks the chip SUSPECT "
                         "(clears after 3 clean probes) and raises "
                         "TPU_MESH_SKEW; <= 0 disables the "
                         "scoreboard verdicts (probes still record)"),
        Option("chaos_storyline_legs_max", OPT_INT).set_default(3)
        .set_description("composed-chaos scenario engine "
                         "(ceph_tpu/chaos): maximum primitive legs "
                         "one seeded storyline samples on top of its "
                         "always-on traffic phase; read at compose "
                         "time, so runtime changes shape the NEXT "
                         "composed scenario"),
        Option("chaos_settle_ticks_max", OPT_INT).set_default(64)
        .set_description("composed-chaos settle budget: mgr ticks "
                         "(with synthetic clean flushes in between) "
                         "the engine grants every expected health "
                         "check to clear after its fault is disarmed "
                         "before declaring the scenario WEDGED"),
        Option("ec_pipeline_depth", OPT_INT).set_default(1)
        .set_description("EC write pipeline: encodes a single PG may "
                         "keep in flight in the dispatch scheduler "
                         "before backpressure force-flushes "
                         "(osd/ec_backend).  1 = today's synchronous "
                         "submit->encode->fan-out per op; >1 converts "
                         "the write path to non-blocking dispatch "
                         "futures with continuation fan-out"),
        Option("ec_subwrite_retry_timeout", OPT_FLOAT).set_default(3.0)
        .set_description("seconds before an unacked EC sub-op write is "
                         "resent to its shard (messenger-level drops "
                         "no longer wedge the per-oid write pipeline); "
                         "0 disables the resend timer"),
        Option("ec_subwrite_retry_max", OPT_INT).set_default(6)
        .set_description("resend attempts per in-flight EC sub-op "
                         "write before giving up (peering's on_change "
                         "then owns the cleanup, as before the timer)"),
        Option("ec_device_retry_max", OPT_INT).set_default(2)
        .set_description("retries (after the first attempt) for a "
                         "transient device codec-call failure before "
                         "the call degrades to the CPU matrix path "
                         "(ceph_tpu/fault guard)"),
        Option("ec_device_retry_backoff_us", OPT_INT).set_default(200)
        .set_description("base backoff between device-call retries, "
                         "doubled per attempt (exponential)"),
        Option("ec_device_watchdog_ms", OPT_FLOAT).set_default(0.0)
        .set_description("per-call watchdog deadline for device codec "
                         "calls; a call exceeding it counts as a "
                         "failure (result discarded).  0 = disabled"),
        Option("ec_breaker_threshold", OPT_INT).set_default(3)
        .set_description("consecutive device-call failures that trip a "
                         "codec signature's circuit breaker onto the "
                         "CPU path (TPU_CODEC_DEGRADED)"),
        Option("ec_breaker_cooldown_s", OPT_FLOAT).set_default(30.0)
        .set_description("seconds an open breaker refuses the device "
                         "before half-open probing it to auto-restore"),
        Option("os_memstore_device_bytes_max", OPT_INT).set_default(0)
        .set_description("device-resident shard store byte budget "
                         "(os_store/device_shard): > 0 lets the EC "
                         "write path store encoded shard bodies as "
                         "HBM handles (zero d2h on the encode->store "
                         "path, crc fused into the encode kernel) and "
                         "LRU-demotes the coldest resident shards to "
                         "host bytes past the budget.  0 (default) = "
                         "residency off, host-bytes store by "
                         "construction"),
        Option("osd_recovery_repair_reads", OPT_BOOL).set_default(True)
        .set_description("repair a single lost shard of a "
                         "regenerating-code pool from d sub-chunk "
                         "helper contributions instead of k whole "
                         "chunks (ceph_tpu/recovery; off = always "
                         "full-stripe decode)"),
        Option("osd_recovery_max_active", OPT_INT).set_default(8)
        .set_description("sub-chunk repair rounds in flight per OSD; "
                         "excess rounds park and drain as slots free "
                         "(reference osd_recovery_max_active role)"),
        Option("ec_regen_subchunk_unit", OPT_INT).set_default(512)
        .set_description("default sub-chunk width (bytes) for "
                         "regenerating-code pools whose profile omits "
                         "subchunk=; stripe width is B x unit, stored "
                         "chunk alpha x unit per stripe "
                         "(docs/RECOVERY.md)"),
        Option("osd_scrub_min_interval", OPT_FLOAT).set_default(86400.0)
        .set_description("seconds between periodic background scrubs "
                         "of a PG (reference osd_scrub_min_interval)"),
        Option("osd_scrub_auto", OPT_BOOL).set_default(True)
        .set_description("schedule background scrubs from the OSD tick"),
        Option("osd_deep_scrub_interval", OPT_FLOAT).set_default(604800.0)
        .set_description("seconds between deep (data-checksumming) "
                         "scrubs of a PG; shallow scrubs in between "
                         "compare metadata only (reference "
                         "osd_deep_scrub_interval)"),
        Option("osd_op_num_threads", OPT_INT).set_default(0)
        .set_description("worker threads draining the sharded op queue "
                         "(reference osd_op_num_threads_per_shard x "
                         "shards; 0 = drain synchronously)"),
        Option("osd_op_queue_mclock_wall", OPT_BOOL).set_default(False)
        .set_description("enforce mclock reservation/limit in ops per "
                         "REAL second (src/dmclock role) instead of "
                         "the deterministic virtual clock"),
        Option("osd_mclock_client_reservation", OPT_FLOAT)
        .set_default(0.0)
        .set_description("per-client dmClock reservation inside the "
                         "client op class, in ops per 1000 client-tier "
                         "dequeues (docs/QOS.md); 0 = no floor"),
        Option("osd_mclock_client_weight", OPT_FLOAT).set_default(1.0)
        .set_description("per-client dmClock weight inside the client "
                         "op class: backlogged clients share dequeues "
                         "proportionally to their weights"),
        Option("osd_mclock_client_limit", OPT_FLOAT).set_default(0.0)
        .set_description("per-client dmClock limit inside the client "
                         "op class, in ops per 1000 client-tier "
                         "dequeues; 0 = uncapped"),
        Option("osd_mclock_client_overrides", OPT_STR).set_default("")
        .set_description("per-entity (res, weight, limit) overrides: "
                         "'entity:res:weight:limit[,entity:...]' — "
                         "entities not listed use the "
                         "osd_mclock_client_* defaults"),
        Option("osd_mclock_class_overrides", OPT_STR).set_default("")
        .set_description("class-tier dmClock tag overrides: "
                         "'class:res:weight:limit[,class:...]' over "
                         "the op classes (client, recovery, scrub, "
                         "snaptrim) — layered over the constructor "
                         "tags at every arbitration, so injectargs "
                         "re-weights a running queue (docs/QOS.md; "
                         "the control plane's recovery-vs-client "
                         "actuator)"),
        Option("osd_op_queue_admission_max", OPT_INT).set_default(0)
        .set_description("op-queue depth at which client-op intake "
                         "sheds load: new client ops are answered "
                         "EAGAIN with a retry_after hint instead of "
                         "growing the queue (docs/QOS.md admission "
                         "control); 0 = disabled"),
        Option("osd_op_queue_throttle_window", OPT_FLOAT)
        .set_default(0.0)
        .set_description("seconds a shed client stays throttled after "
                         "tripping admission control (on top of the "
                         "depth hysteresis: a throttled client is "
                         "re-admitted only once the queue drains below "
                         "half of osd_op_queue_admission_max); also "
                         "the retry_after hint floor sent to clients"),
        Option("osd_op_queue_batch_intake", OPT_BOOL).set_default(False)
        .set_description("do not drain the sharded op queue inline at "
                         "every intake: ops accumulate across one fabric "
                         "pump and drain at quiescence, so bursts see "
                         "real mClock arbitration (the traffic "
                         "harness's intake mode; default preserves "
                         "the synchronous drain)"),
        Option("osd_capacity_bytes", OPT_INT).set_default(0)
        .set_description("logical capacity per OSD for full-ratio "
                         "accounting (osd_stat_t kb role); 0 = "
                         "unlimited, never full"),
        Option("mon_osd_full_ratio", OPT_FLOAT).set_default(0.95)
        .set_description("OSD fill ratio at which the cluster FULL "
                         "flag blocks writes (common/options.cc "
                         "mon_osd_full_ratio)"),
        Option("mon_osd_nearfull_ratio", OPT_FLOAT).set_default(0.85)
        .set_description("OSD fill ratio raising the NEARFULL health "
                         "warning (mon_osd_nearfull_ratio)"),
        Option("mgr_telemetry_retention", OPT_INT).set_default(360)
        .set_description("samples kept in the mgr telemetry rollup's "
                         "time-series rings (one sample per mgr tick; "
                         "keep >= mgr_slo_slow_window_s / tick dt or "
                         "the slow burn window silently truncates to "
                         "the ring span; docs/OBSERVABILITY.md "
                         "cluster rollup)"),
        Option("mgr_slo_fast_window_s", OPT_FLOAT).set_default(30.0)
        .set_description("fast SLO burn-rate window (seconds of the "
                         "cluster clock) — the responsive window a "
                         "breach must sustain in before a TPU_SLO_* "
                         "health check raises"),
        Option("mgr_slo_slow_window_s", OPT_FLOAT).set_default(300.0)
        .set_description("slow SLO burn-rate window (seconds) — the "
                         "confirming window; a spike that breaches "
                         "the fast window but dilutes below the "
                         "objective here never raises"),
        Option("mgr_slo_sustain_ticks", OPT_INT).set_default(2)
        .set_description("consecutive mgr ticks the fast-window burn "
                         "must breach before a TPU_SLO_* check "
                         "raises (a single-tick spike never flaps it)"),
        Option("mgr_slo_clear_ticks", OPT_INT).set_default(2)
        .set_description("consecutive clean mgr ticks before an "
                         "active TPU_SLO_* check clears (hysteresis)"),
        Option("mgr_slo_oplat_p99_usec", OPT_STR).set_default("")
        .set_description("per-stage cluster-p99 latency objectives, "
                         "'stage:usec[,stage:usec]' over the oplat "
                         "stage catalog (e.g. 'device_call:50000,"
                         "class_queue:100000'); breaching raises "
                         "TPU_SLO_OPLAT.  Empty = disabled"),
        Option("mgr_slo_copies_per_op_max", OPT_FLOAT).set_default(0.0)
        .set_description("cluster copies-per-op ceiling (devprof "
                         "transfers + host copies over completed "
                         "ops); breaching raises TPU_SLO_COPY — the "
                         "bench copy budget as live health.  0 = "
                         "disabled"),
        Option("mgr_slo_admission_rate_max", OPT_FLOAT).set_default(0.0)
        .set_description("admission-control rejection-rate ceiling "
                         "(rejections per second of the cluster "
                         "clock); breaching raises TPU_SLO_ADMISSION."
                         "  0 = disabled"),
        Option("mgr_control_enable", OPT_BOOL).set_default(False)
        .set_description("master enable for the mgr's damped SLO "
                         "feedback controller (docs/CONTROL.md); off "
                         "= today's observe-only mgr by construction "
                         "— the controller never senses, moves, or "
                         "logs"),
        Option("mgr_control_bounds", OPT_STR).set_default("")
        .set_description("operator floors/ceilings per controlled "
                         "knob, 'knob:floor:ceiling[,knob:...]' — "
                         "layered over the built-in bounds; the "
                         "controller never steps a knob outside "
                         "[floor, ceiling] (docs/CONTROL.md)"),
        Option("mgr_control_cooldown_ticks", OPT_INT).set_default(2)
        .set_description("mgr ticks a knob rests after an actuation "
                         "before the controller may step it again — "
                         "one bounded step per cooldown window makes "
                         "oscillation structurally impossible"),
        Option("mgr_control_damping", OPT_FLOAT).set_default(0.5)
        .set_description("geometric step damping: each successive "
                         "same-direction move on a knob scales its "
                         "step by this factor (0 < d <= 1), so a "
                         "persistent breach converges instead of "
                         "slamming between bounds"),
        Option("mgr_control_ledger_size", OPT_INT).set_default(128)
        .set_description("actuation-ledger ring size ('tpu control "
                         "dump'): every move keeps knob, from/to, "
                         "reflex and reason until overwritten"),
        Option("mgr_control_actuate_retries", OPT_INT).set_default(2)
        .set_description("bounded re-attempts of one actuation within "
                         "a tick when the config injection fails "
                         "(fault site control.actuate); past the "
                         "budget the move is dropped and retried "
                         "whole next tick — the controller never "
                         "wedges"),
        Option("mgr_journal_ring_size", OPT_INT).set_default(256)
        .set_description("events kept per daemon in the cluster event "
                         "journal's bounded rings (trace/journal.py); "
                         "read live on every emit, so an injectargs "
                         "shrink evicts down on the next event"),
        Option("mgr_incident_retention", OPT_INT).set_default(16)
        .set_description("incident bundles kept in the mgr's archive "
                         "(mgr/incident.py); a runtime shrink prunes "
                         "the archive immediately via the config "
                         "observer, oldest bundles first"),
        Option("mgr_incident_timeline_tail", OPT_INT).set_default(64)
        .set_description("merged-timeline events snapshotted into an "
                         "incident bundle at capture, and again per "
                         "finalize when the triggering check clears"),
        Option("tracing_kernels", OPT_BOOL).set_default(False)
        .set_description("time every device kernel dispatch (adds a "
                         "sync per call; diagnosis only)"),
        Option("tracing_spans", OPT_BOOL).set_default(False)
        .set_description("collect parent/child op spans end to end "
                         "(trace/ package; host-side only, adds zero "
                         "device syncs — safe to leave on)"),
        Option("op_complaint_time", OPT_FLOAT).set_default(30.0)
        .set_description("ops slower than this land in the slow-op "
                         "history + flight recorder (reference "
                         "osd_op_complaint_time, options.cc)"),
        # daemon-identity path options (reference options.cc defaults,
        # with the same $cluster/$name metavariables -- ceph-conf
        # expands them per name; pinned by src/test/cli/ceph-conf)
        Option("log_file", OPT_STR, LEVEL_BASIC)
        .set_default("/var/log/ceph/$cluster-$name.log")
        .set_description("path to log file"),
        Option("admin_socket", OPT_STR)
        .set_default("/var/run/ceph/$cluster-$name.asok")
        .set_description("path for the runtime control socket"),
        Option("mon_debug_dump_location", OPT_STR)
        .set_default("/var/log/ceph/$cluster-$name.tdump")
        .set_description("file to dump paxos transactions to"),
        Option("fsid", OPT_STR, LEVEL_BASIC).set_default("")
        .set_description("cluster fsid (uuid)"),
        Option("mon_host", OPT_STR, LEVEL_BASIC).set_default("")
        .set_description("list of hosts or addresses for monitors"),
        Option("public_network", OPT_STR).set_default("")
        .set_description("network(s) for public traffic"),
        Option("pid_file", OPT_STR).set_default("")
        .set_description("path to write the daemon's pid to"),
        Option("host", OPT_STR, LEVEL_BASIC).set_default("")
        .set_description("local hostname"),
        # debug_<subsys> levels, "log" or "log/gather" — one schema entry
        # per dout subsystem (single source of truth: SUBSYS_DEFAULTS)
        *[Option(f"debug_{s}", OPT_STR).set_default(f"{lg}/{gt}")
          .set_description(f"{s} debug level (log/gather)")
          for s, (lg, gt) in _subsys_defaults()],
    ]


class ConfigProxy:
    """md_config_t analog: values + observers."""

    def __init__(self):
        self.schema: Dict[str, Option] = {o.name: o for o in build_options()}
        self.values: Dict[str, Any] = {}
        self.observers: Dict[str, List[Callable[[str, Any], None]]] = {}

    def get_val(self, name: str):
        if name in self.values:
            return self.values[name]
        return self.schema[name].default

    def set_val(self, name: str, v) -> None:
        opt = self.schema[name]
        self.values[name] = opt.cast(v)
        for cb in self.observers.get(name, []):
            cb(name, self.values[name])

    def rm_val(self, name: str) -> None:
        self.values.pop(name, None)

    # the validated set/get path shared by every admin surface (asok
    # 'config set', 'ceph tell ... injectargs', MCommand handlers):
    # one place owns the schema check, cast-error wording, and
    # observer notification
    def set_checked(self, name: str, value) -> Dict[str, Any]:
        if name not in self.schema:
            raise ValueError(f"unrecognized config option '{name}'")
        try:
            self.set_val(name, value)
        except (TypeError, ValueError):
            raise ValueError(f"invalid value '{value}' for option "
                             f"'{name}'")
        return {name: self.get_val(name)}

    def get_checked(self, name: str) -> Dict[str, Any]:
        if name not in self.schema:
            raise ValueError(f"unrecognized config option '{name}'")
        return {name: self.get_val(name)}

    def handle_config_command(self, cmd: str,
                              args: Dict[str, Any]
                              ) -> Optional[Dict[str, Any]]:
        """The config subset of the daemon-command vocabulary
        ('ceph tell <daemon> ...'), shared by every MCommand handler:
        returns the reply data, or None when *cmd* is not a config
        command (the daemon adds its own).  injectargs validates
        EVERY name and value before applying anything — an error must
        mean nothing changed."""
        if cmd == "injectargs":
            opts = dict(args.get("opts", {}))
            for name, val in opts.items():
                if name not in self.schema:
                    raise ValueError(
                        f"unrecognized config option '{name}'")
                try:
                    self.schema[name].cast(val)
                except (TypeError, ValueError):
                    raise ValueError(f"invalid value '{val}' for "
                                     f"option '{name}'")
            out: Dict[str, Any] = {}
            for name, val in opts.items():
                out.update(self.set_checked(name, val))
            return out
        if cmd == "config show":
            return self.show_config()
        if cmd == "config get":
            return self.get_checked(args.get("name", ""))
        return None

    def run_daemon_command(self, cmd: str, args: Dict[str, Any],
                           extras: Dict[str, Callable[[], Any]]
                           ) -> "tuple[int, Dict[str, Any]]":
        """The full MCommand handler body shared by every daemon:
        config vocabulary first, then the daemon's *extras* (zero-arg
        callables by command name), with the reference's -EINVAL
        error shape.  Returns (result, data)."""
        try:
            handled = self.handle_config_command(cmd, args)
            if handled is not None:
                return 0, handled
            if cmd in extras:
                return 0, extras[cmd]()
            return -22, {"error": f"unknown command '{cmd}'"}
        except (TypeError, ValueError) as e:
            return -22, {"error": str(e)}

    def add_observer(self, name: str,
                     cb: Callable[[str, Any], None]) -> None:
        self.observers.setdefault(name, []).append(cb)

    def parse_ini(self, text: str, section: str = "global") -> None:
        """ceph.conf-style ini source."""
        cp = configparser.ConfigParser()
        cp.read_string(text)
        if cp.has_section(section):
            for k, v in cp.items(section):
                key = k.replace(" ", "_")
                if key in self.schema:
                    self.set_val(key, v)

    def show_config(self) -> Dict[str, Any]:
        return {name: self.get_val(name) for name in sorted(self.schema)}


# process-wide config, like g_conf
g_conf = ConfigProxy()
