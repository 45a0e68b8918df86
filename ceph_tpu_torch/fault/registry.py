"""Fault-injection registry — named sites, armed triggers, zero-cost off.

Port of ``ceph_tpu/fault/registry.py`` (the registry only: the JAX
package's retry guard, circuit breaker and host fallback are not carried,
since the port never answers a device request from the CPU).  Code
declares named injection sites in a catalog, operators arm them at
runtime (admin socket ``fault inject|list|clear``), and the armed trigger
decides per check whether the fault fires.  The catalog is the JAX
package's, so both packages accept the same site names; the dispatch
scheduler's ``dispatch.batch`` is the site the port checks today.

Triggers:

- ``mode=prob p=0.2 [seed=N]``: fire with probability p, from a
  per-site ``random.Random(seed)`` so runs are reproducible.
- ``mode=nth n=3``: fire on every Nth matching check (3, 6, 9, ...).
- ``mode=once``: fire on the first matching check, then disarm.
- ``mode=always``: fire on every matching check.
- ``count=K``: disarm after K fires (any mode).
- ``match=substr``: only checks whose context string contains *substr*
  participate.

Cost contract: with NO site armed, ``should_fire`` is one truthiness
test of an empty dict — no locks, no RNG, no counters — so production
paths can consult sites unconditionally.
"""
from __future__ import annotations

import random
import zlib
from typing import Dict, Optional, Tuple

from ..common.lockdep import DebugLock
from ..common.perf_counters import PerfCounters, PerfCountersBuilder
from ..trace.journal import g_journal

# ---- injected error kinds --------------------------------------------------


class InjectedFault(RuntimeError):
    """Base of every injected error; carries the site that fired."""

    def __init__(self, site: str, detail: str = ""):
        super().__init__(f"injected fault at {site}"
                         + (f": {detail}" if detail else ""))
        self.site = site


class InjectedDeviceError(InjectedFault):
    """A transient device-dispatch failure (the retry/backoff and
    circuit-breaker target)."""


class InjectedTimeout(InjectedFault):
    """A wedged device call — what the per-call watchdog deadline
    converts a silent hang into."""


ERROR_KINDS = {"device": InjectedDeviceError,
               "timeout": InjectedTimeout}

# ---- the site catalog ------------------------------------------------------
# One place so `fault list` enumerates every site the build understands
# (docs/ROBUSTNESS.md mirrors this table).
SITE_CATALOG: Dict[str, str] = {
    "control.actuate":
        "mgr control-plane config injection (ceph_tpu/control): a "
        "firing fails ONE knob actuation; the controller retries "
        "mgr_control_actuate_retries times within the tick, then "
        "drops the move and re-derives it next tick — context is "
        "'<knob>=<value> (<option>)' for match= scoping",
    "device.encode_batch":
        "batched EC encode device call (matrix_plugin.encode_batch)",
    "device.decode_batch":
        "batched EC decode/reconstruct device call "
        "(matrix_plugin.decode_batch)",
    "device.encode_chunks":
        "per-stripe encode device call (matrix_plugin.encode_chunks)",
    "tpu.encode_batch_device":
        "device-resident encode entry point (tpu_plugin, mesh/bench)",
    "tpu.decode_batch_device":
        "device-resident decode entry point (tpu_plugin, mesh/bench)",
    "dispatch.batch":
        "coalesced flush execution (scheduler._execute run_group) — "
        "exercises the per-request fallback isolation",
    "mesh.encode_batch":
        "mesh-sharded flush execution (ceph_tpu/mesh runtime) — "
        "exhaustion degrades the flush to the single-device path",
    "mesh.decode_batch":
        "mesh-sharded decode/reconstruct/repair execution "
        "(ceph_tpu/mesh runtime decode_stacked) — exhaustion degrades "
        "the group to the single-device path and journals "
        "mesh_decode_degraded",
    "mesh.chip_slowdown":
        "per-chip straggler injection (ceph_tpu/mesh/chipstat): delays "
        "the matching chip's probe readback by delay_us; context is "
        "'chip=<i>/<mesh size>' so match='chip=3/' scopes one chip",
    "mesh.chip_fail":
        "hard per-chip failure mid-flush (ceph_tpu/mesh/rateless): the "
        "matching chip's coded blocks become erasures the subset "
        "completion re-solves around; context is 'chip=<i>/<mesh "
        "size>' for match= scoping, count= bounds the failed flushes",
    "mgr.incident_capture":
        "incident bundle snapshot on a health-check raise "
        "(ceph_tpu/mgr/incident): a firing drops that bundle — the "
        "raise is journaled, the tick proceeds, and the NEXT raise "
        "captures normally; context is the triggering check name",
    "osd.shard_read_eio":
        "shard-side EC read returns EIO (bluestore_debug_inject_read_err "
        "role) — the primary must reconstruct from surviving shards",
    "store.shard_corrupt":
        "flip one byte of a stored shard body at read time (memstore) — "
        "the shard-side crc32c verify must catch it and return EIO, "
        "whether the body is host bytes or a device-resident handle; "
        "context is '<coll>/<oid>' for match= scoping",
    "recovery.repair_read":
        "sub-chunk repair round start (recovery scheduler) — firing "
        "degrades the repair to the full-stripe decode path",
    "recovery.helper_fetch":
        "helper-side repair contribution read (handle_sub_read) — a "
        "dropped helper fails the round and the orchestrator falls "
        "back to full-stripe decode",
    "msg.drop":
        "drop a fabric message (ms inject socket failures role); "
        "context is '<MsgType> <src>><dst>' for match= scoping",
}

# ---- fault perf counters ---------------------------------------------------
FAULT_FIRST = 92000
l_fault_injected = 92001          # armed-site fires, all sites
l_fault_device_errors = 92002     # failed device attempts (any cause)
l_fault_device_retries = 92003    # attempts retried after backoff
l_fault_watchdog_timeouts = 92004  # calls past the watchdog deadline
l_fault_cpu_fallbacks = 92005     # device calls served by the CPU twin
l_fault_breaker_trips = 92006     # signature breakers tripped open
l_fault_breaker_restores = 92007  # breakers restored via half-open probe
l_fault_eio_injected = 92008      # shard reads failed by injection
l_fault_eio_reconstructs = 92009  # reads recovered by EC reconstruct
l_fault_msg_drops = 92010         # messages dropped by the msg.drop site
l_fault_degraded = 92011          # gauge: codec signatures currently open
FAULT_LAST = 92020

_fault_pc: Optional[PerfCounters] = None
_fault_pc_lock = DebugLock("fault_pc::init")


def fault_perf_counters() -> PerfCounters:
    """The robustness layer's counter logger (perf dump / Prometheus
    `ceph_daemon_fault_*`)."""
    global _fault_pc
    if _fault_pc is not None:
        return _fault_pc
    with _fault_pc_lock:
        if _fault_pc is None:
            b = PerfCountersBuilder("fault", FAULT_FIRST, FAULT_LAST)
            b.add_u64_counter(l_fault_injected, "injected",
                              "armed injection sites fired")
            b.add_u64_counter(l_fault_device_errors, "device_errors",
                              "failed device-call attempts")
            b.add_u64_counter(l_fault_device_retries, "device_retries",
                              "device attempts retried after backoff")
            b.add_u64_counter(l_fault_watchdog_timeouts,
                              "watchdog_timeouts",
                              "device calls past the watchdog deadline")
            b.add_u64_counter(l_fault_cpu_fallbacks, "cpu_fallbacks",
                              "device calls served by the CPU matrix "
                              "path instead")
            b.add_u64_counter(l_fault_breaker_trips, "breaker_trips",
                              "codec-signature circuit breakers tripped")
            b.add_u64_counter(l_fault_breaker_restores,
                              "breaker_restores",
                              "breakers closed again by a half-open "
                              "probe")
            b.add_u64_counter(l_fault_eio_injected, "eio_injected",
                              "shard reads failed by injection")
            b.add_u64_counter(l_fault_eio_reconstructs,
                              "eio_reconstructs",
                              "client reads served by EC reconstruction "
                              "after a shard EIO")
            b.add_u64_counter(l_fault_msg_drops, "msg_drops",
                              "fabric messages dropped by the msg.drop "
                              "site")
            b.add_u64(l_fault_degraded, "degraded",
                      "codec signatures currently tripped to the CPU "
                      "path (gauge)")
            _fault_pc = b.create_perf_counters()
    return _fault_pc


# ---- armed trigger ---------------------------------------------------------


class FaultSpec:
    """One armed site: trigger mode + bookkeeping."""

    __slots__ = ("site", "mode", "p", "n", "seed", "count", "error",
                 "match", "delay_us", "fires", "checks", "_rng")

    def __init__(self, site: str, mode: str = "always", p: float = 1.0,
                 n: int = 1, seed: Optional[int] = None, count: int = 0,
                 error: str = "device", match: str = "",
                 delay_us: int = 0):
        if mode not in ("prob", "nth", "once", "always"):
            raise ValueError(f"unknown fault mode '{mode}'")
        if error not in ERROR_KINDS:
            # reply-shaping sites (osd.shard_read_eio, msg.drop) never
            # consult the error kind — their effect IS the EIO/drop —
            # so only the check-style kinds are valid here
            raise ValueError(f"unknown fault error kind '{error}'")
        self.site = site
        self.mode = mode
        self.p = float(p)
        self.n = max(int(n), 1)
        self.seed = None if seed is None else int(seed)
        # once = a count-limited always
        self.count = 1 if mode == "once" else max(int(count), 0)
        self.error = error
        self.match = match
        # delay-shaping sites (mesh.chip_slowdown): how long the
        # matching check stalls when the trigger fires; check-style
        # sites ignore it
        self.delay_us = max(int(delay_us), 0)
        self.fires = 0
        self.checks = 0
        # deterministic per-site stream, cross-process: an explicit
        # seed (0 included) is honored, the default derives from a
        # STABLE digest of the site name (str hash() is salted per
        # process and would break run-to-run reproducibility)
        self._rng = random.Random(
            self.seed if self.seed is not None
            else zlib.crc32(site.encode()))

    def decide(self) -> bool:
        """One matching check: does the fault fire?  Caller holds the
        registry lock."""
        self.checks += 1
        if self.mode == "prob":
            fire = self._rng.random() < self.p
        elif self.mode == "nth":
            fire = self.checks % self.n == 0
        else:                      # once / always
            fire = True
        if fire:
            self.fires += 1
        return fire

    def exhausted(self) -> bool:
        return bool(self.count) and self.fires >= self.count

    def dump(self) -> dict:
        return {"mode": self.mode, "p": self.p, "n": self.n,
                "seed": self.seed, "count": self.count,
                "error": self.error, "match": self.match,
                "delay_us": self.delay_us,
                "fires": self.fires, "checks": self.checks}


class FaultRegistry:
    """Process-wide site catalog + armed triggers (like g_conf)."""

    def __init__(self):
        self._armed: Dict[str, FaultSpec] = {}
        self._lock = DebugLock("FaultRegistry::lock")

    # ---- hot path ---------------------------------------------------------
    def site_armed(self, site: str) -> bool:
        """Lock-free armed probe for hot paths that would otherwise pay
        to BUILD the context string (message pump, shard reads): dict
        membership is atomic in CPython, and a racing inject/clear just
        moves the decision to the next check."""
        return bool(self._armed) and site in self._armed

    def _decide(self, site: str, ctx: str) -> Tuple[bool, str]:
        """One locked fire decision; returns (fired, error kind) from
        the SAME spec so a concurrent re-arm cannot split the decision
        from the error it raises."""
        with self._lock:
            spec = self._armed.get(site)
            if spec is None:
                return False, ""
            if spec.match and spec.match not in ctx:
                return False, ""
            fired = spec.decide()
            error = spec.error
            if spec.exhausted():
                del self._armed[site]
        if fired:
            fault_perf_counters().inc(l_fault_injected)
            g_journal.emit("fault", "fault_fire", site=site)
        return fired, error

    def should_fire(self, site: str, ctx: str = "") -> bool:
        """True when *site* is armed and its trigger fires for this
        check.  The nothing-armed fast path is one dict truthiness
        test — the production cost of carrying injection sites."""
        if not self._armed:
            return False
        return self._decide(site, ctx)[0]

    def check(self, site: str, ctx: str = "") -> None:
        """Raise the armed error kind when the site fires (device-path
        sites); sites that shape a reply instead (EIO, drops) use
        ``should_fire`` directly."""
        if not self._armed:
            return
        fired, error = self._decide(site, ctx)
        if fired:
            raise ERROR_KINDS.get(error, InjectedDeviceError)(site, ctx)

    # ---- control surface (admin socket `fault ...`) ------------------------
    def inject(self, name: str, **kw) -> FaultSpec:
        if name not in SITE_CATALOG:
            raise ValueError(f"unknown fault site '{name}' (see "
                             f"'fault list')")
        spec = FaultSpec(name, **kw)
        with self._lock:
            self._armed[name] = spec
        g_journal.emit("fault", "fault_arm", site=name, mode=spec.mode)
        return spec

    def clear(self, name: str = "") -> int:
        with self._lock:
            if name:
                cleared = 1 if self._armed.pop(name, None) is not None \
                    else 0
            else:
                cleared = len(self._armed)
                self._armed.clear()
        if cleared:
            g_journal.emit("fault", "fault_clear", site=name or "*",
                           cleared=cleared)
        return cleared

    def armed(self, site: str) -> Optional[FaultSpec]:
        with self._lock:
            return self._armed.get(site)

    def sites(self) -> Dict[str, str]:
        """Machine-readable site catalog (name -> description) — the
        enumeration surface the chaos composer samples primitives from
        (ceph_tpu/chaos/scenario.py); a copy, so callers cannot mutate
        the build's catalog."""
        return dict(SITE_CATALOG)

    def list_sites(self) -> list:
        """Structured per-site records, sorted by name — the ``fault
        list format=json`` shape: one row per registered site with its
        armed trigger (or null), so tooling iterates a stable list
        instead of string-keyed prose."""
        with self._lock:
            armed = {s: spec.dump() for s, spec in self._armed.items()}
        return [{"name": name, "description": desc,
                 "armed": armed.get(name)}
                for name, desc in sorted(SITE_CATALOG.items())]

    def dump(self) -> dict:
        with self._lock:
            armed = {s: spec.dump() for s, spec in self._armed.items()}
        return {"sites": dict(SITE_CATALOG), "armed": armed}


# process-wide registry, like g_conf / g_tracer
g_faults = FaultRegistry()
