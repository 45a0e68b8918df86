"""Composed-chaos execution engine + the universal acceptance oracle.

``run_scenario(spec)`` executes one :class:`ScenarioSpec` end to end:

1. **base knobs** — an 8-chip mesh with the rateless coder on, the
   skew scoreboard probing every flush, the SLO controller live, and a
   journal ring / incident timeline long enough that the whole
   storyline stays in the black box;
2. **compile** — the declarative schedule becomes ``TrafficSpec``
   machinery: osd/membership steps ride ``TrafficSpec.events`` (the
   first-class topology events), fault arm/clear and conf flips become
   ``TrafficSpec.hooks`` (each fire journals a ``chaos_event``, so the
   executed storyline is itself on the timeline);
3. **run** — open-loop harness traffic over a real EC pool on a
   ticking MiniCluster; every read byte-verifies against the client's
   committed payload;
4. **settle** — synthetic oracle flushes + ticks on the cluster clock
   until every expected health check RAISED (the phased clears for
   hysteretic checks disarm only after detection), then until every
   raise CLEARED, bounded by ``chaos_settle_ticks_max`` (budget
   exhausted = WEDGED, an acceptance failure, never a hang);
5. **judge** — the UNIVERSAL acceptance: every op byte-exact, every
   expected check raised AND cleared, zero wedges, and every raise
   yields a finalized incident bundle whose gseq-ordered timeline
   tells the injected storyline back (the hand-built twin of this
   oracle is pinned in tests/test_incident.py).

Everything runs on the deterministic cluster clock (harness rounds +
``cluster.tick``); wall time appears only inside measured latencies.
This module imports numpy for the settle-phase oracle flushes;
composing and judging are host work (the fence-count extension in
tests/test_observability.py pins zero device syncs).

Port of ``ceph_tpu/chaos/engine.py``.  A storyline runs on an 8-member
mesh (``BASE_MESH_CHIPS``).  The storyline's EC pool and the settle
phase's oracle codec are the ``cuda`` plugin on the card, or
``backend=host`` when the caller asks for the CPU (``device="cpu"``): a
codec rides the mesh only on its own platform.  Two things of the JAX
engine are not here by design: the port has no codec breakers, so there
is no ``g_breakers.reset()``; and the port's mesh has no single-device
fallback, so the receipt's ``mesh_fallbacks`` is 0 by construction.
The ``device_error`` leg arms ``device.encode_batch``, a site the port
lists but no code checks (it has no fault guard): the leg journals its
arm and clear and never fires (ROADMAP Queue 3).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

from ..common.config import g_conf
from ..common.lockdep import DebugLock
from ..common.perf_counters import PerfCounters, PerfCountersBuilder
from ..trace.journal import g_journal
from .scenario import BASE_MESH_CHIPS, ScenarioSpec, compose_scenario

# ---- perf counters (perf dump / Prometheus ceph_daemon_chaos_*) ------------
CHAOS_FIRST = 90100
l_chaos_scenarios = 90101      # storylines executed end to end
l_chaos_legs = 90102           # legs across all executed storylines
l_chaos_events = 90103         # scheduled storyline steps fired
l_chaos_faults_armed = 90104   # fault arms performed by storylines
l_chaos_faults_cleared = 90105  # fault clears performed by storylines
l_chaos_checks_raised = 90106  # health raises observed under storylines
l_chaos_checks_cleared = 90107  # health clears observed under storylines
l_chaos_accept_pass = 90108    # storylines that passed universal acceptance
l_chaos_accept_fail = 90109    # storylines that failed universal acceptance
l_chaos_wedges = 90110         # storylines that exhausted the settle budget
l_chaos_active = 90111         # gauge: a storyline is executing right now
CHAOS_LAST = 90120

_chaos_pc: Optional[PerfCounters] = None
_chaos_pc_lock = DebugLock("chaos_pc::init")


def chaos_perf_counters() -> PerfCounters:
    """The scenario engine's counter logger (perf dump / Prometheus)."""
    global _chaos_pc
    if _chaos_pc is not None:
        return _chaos_pc
    with _chaos_pc_lock:
        if _chaos_pc is None:
            b = PerfCountersBuilder("chaos", CHAOS_FIRST, CHAOS_LAST)
            b.add_u64_counter(l_chaos_scenarios, "scenarios",
                              "composed storylines executed end to end")
            b.add_u64_counter(l_chaos_legs, "legs",
                              "legs across all executed storylines")
            b.add_u64_counter(l_chaos_events, "events",
                              "scheduled storyline steps fired")
            b.add_u64_counter(l_chaos_faults_armed, "faults_armed",
                              "fault arms performed by storylines")
            b.add_u64_counter(l_chaos_faults_cleared, "faults_cleared",
                              "fault clears performed by storylines")
            b.add_u64_counter(l_chaos_checks_raised, "checks_raised",
                              "health raises observed under storylines")
            b.add_u64_counter(l_chaos_checks_cleared, "checks_cleared",
                              "health clears observed under storylines")
            b.add_u64_counter(l_chaos_accept_pass, "accept_pass",
                              "storylines that passed the universal "
                              "acceptance")
            b.add_u64_counter(l_chaos_accept_fail, "accept_fail",
                              "storylines that failed the universal "
                              "acceptance")
            b.add_u64_counter(l_chaos_wedges, "wedges",
                              "storylines that exhausted the settle "
                              "budget")
            b.add_u64(l_chaos_active, "active",
                      "a storyline is executing right now")
            _chaos_pc = b.create_perf_counters()
    return _chaos_pc


# conf the engine pins for a run and restores after (mirrors the
# hand-built twin's TOUCHED list in tests/test_incident.py)
TOUCHED = (
    "ec_mesh_chips", "ec_mesh_rateless", "ec_mesh_rateless_tasks",
    "ec_mesh_skew_sample_every", "ec_mesh_skew_threshold",
    "ec_dispatch_batch_max", "ec_dispatch_batch_window_us",
    "mgr_control_enable", "mgr_control_cooldown_ticks",
    "mgr_incident_timeline_tail", "mgr_journal_ring_size",
)

# per-check causal chains the finalized bundle must tell back, in
# strictly increasing gseq order (the storyline-told oracle)
CHECK_CHAINS: Dict[str, Tuple[Tuple[str, Dict[str, Any]], ...]] = {
    "TPU_MESH_SKEW": (
        ("fault_fire", {"site": "mesh.chip_slowdown"}),
        ("chip_suspect_mark", {}),
        ("health_raise", {"check": "TPU_MESH_SKEW"}),
        ("health_clear", {"check": "TPU_MESH_SKEW"}),
    ),
}


def _compile(spec: ScenarioSpec, pool: str, n_clients: int,
             ops_per_client: int, rate: float):
    """Declarative schedule -> TrafficSpec: topology/membership steps
    become first-class ``events``, fault and conf steps become
    ``hooks`` (each fire journals a chaos_event so the executed
    storyline rides the same causally-ordered timeline it is judged
    against)."""
    from ..fault import g_faults
    from ..load import TrafficSpec
    events: List[Tuple[int, str, int]] = []
    hooks: List[Tuple[int, Callable]] = []
    pc = chaos_perf_counters()
    for ev in spec.events:
        d = dict(ev.detail)
        if ev.action in ("osd_kill", "osd_down", "osd_out",
                         "osd_revive", "osd_in"):
            events.append((ev.round, ev.action, int(d["osd"])))
        elif ev.action in ("mesh_chip_add", "mesh_chip_retire"):
            events.append((ev.round, ev.action, int(d["chips"])))
        elif ev.action == "fault_arm":
            def arm(cluster, d=d, rnd=ev.round):
                kw = {k: v for k, v in d.items() if k != "site"}
                g_journal.emit("chaos", "chaos_event", step="fault_arm",
                               site=d["site"], round=rnd)
                g_faults.inject(d["site"], **kw)
                pc.inc(l_chaos_events)
                pc.inc(l_chaos_faults_armed)
            hooks.append((ev.round, arm))
        elif ev.action == "fault_clear":
            def clear(cluster, d=d, rnd=ev.round):
                g_journal.emit("chaos", "chaos_event",
                               step="fault_clear", site=d["site"],
                               round=rnd)
                g_faults.clear(d["site"])
                pc.inc(l_chaos_events)
                pc.inc(l_chaos_faults_cleared)
            hooks.append((ev.round, clear))
        elif ev.action == "conf_set":
            def flip(cluster, d=d, rnd=ev.round):
                g_journal.emit("chaos", "chaos_event", step="conf_set",
                               option=d["option"], value=d["value"],
                               round=rnd)
                g_conf.set_checked(d["option"], d["value"])
                pc.inc(l_chaos_events)
            hooks.append((ev.round, flip))
        elif ev.action == "traffic_abuse":
            pass        # compose-time traffic shape (rate_multipliers)
        else:
            raise ValueError(
                f"unknown storyline action '{ev.action}'")
    return TrafficSpec(
        pool=pool, n_clients=n_clients, ops_per_client=ops_per_client,
        read_fraction=0.4, keys_per_client=8, mode="open", rate=rate,
        rate_multipliers=spec.rate_multipliers, seed=spec.seed,
        tick_every=8, events=tuple(events), hooks=tuple(hooks))


def _oracle_flush_fn(device="cuda"):
    """A synthetic byte-exact flush for the settle phase: every call
    submits payloads through the dispatch/mesh path and compares the
    coding against the pure host oracle — the same per-flush receipt
    the hand-built twin uses, so settling doubles as a byte-exactness
    probe while the health machinery converges."""
    import numpy as np
    from ..dispatch import g_dispatcher
    from ..ec.cuda_plugin import ErasureCodeCuda, backend_profile
    from ..osd.ecutil import encode as eu_encode, stripe_info_t
    impl = ErasureCodeCuda()
    impl.init({"k": "4", "m": "2", "technique": "reed_sol_van",
               **backend_profile(device)})
    sinfo = stripe_info_t(4, 4 * 1024)
    want = set(range(6))
    rng = np.random.default_rng(20260807)

    def flush() -> bool:
        payloads = [rng.integers(0, 256, size=2 * 4 * 1024,
                                 dtype=np.uint8) for _ in range(3)]
        oracles = [eu_encode(sinfo, impl, p, want) for p in payloads]
        futs = [g_dispatcher.submit_encode(sinfo, impl, p, want)
                for p in payloads]
        g_dispatcher.flush()
        for f, oracle in zip(futs, oracles):
            res = f.result()
            if sorted(res) != sorted(oracle):
                return False
        return True

    return flush


def _settle(c, spec: ScenarioSpec, gseq0: int, flush) -> Dict[str, Any]:
    """Drive oracle flushes + cluster ticks until every expected check
    raised, disarm the phased clears, then until every raise cleared
    and the health board is empty — bounded by the settle budget."""
    from ..fault import g_faults
    budget = max(int(g_conf.get_val("chaos_settle_ticks_max")), 1)
    disarmed = False
    oracles_ok = True
    wedged = True
    ticks = 0
    for _ in range(budget):
        ticks += 1
        oracles_ok = flush() and oracles_ok
        c.tick(dt=1.0)
        since = g_journal.merged_since(gseq0)
        raised = {e.get("check") for e in since
                  if e["type"] == "health_raise"}
        cleared = {e.get("check") for e in since
                   if e["type"] == "health_clear"}
        if not disarmed and all(chk in raised
                                for chk in spec.expected_checks):
            for site in spec.settle_clears:
                g_journal.emit("chaos", "chaos_event",
                               step="settle_clear", site=site)
            # disarm EVERYTHING: detection happened, nothing may stay
            # armed into the clear phase (scheduled clears already
            # fired during traffic; this catches phased stragglers)
            g_faults.clear()
            disarmed = True
        if disarmed and raised <= cleared and not c.mgr.health_checks:
            wedged = False
            break
    return {"ticks": ticks, "oracles_ok": oracles_ok, "wedged": wedged,
            "disarmed": disarmed}


def _bundle_ok(c, check: str, spec: ScenarioSpec, since: List[dict],
               chain: bool = True, gseq0: int = -1) -> bool:
    """One raise's forensic receipt: a FINALIZED bundle exists for
    *check*, its timeline is strictly gseq-ordered, and (for checks
    with a pinned chain) it tells the injected storyline back in
    causal order.  A missing bundle passes only when the storyline
    armed ``mgr.incident_capture`` AND the drop was journaled."""
    listing = c.admin_socket.execute("tpu incident list")["incidents"]
    rows = [r for r in listing if r["trigger"] == check]
    if not rows:
        return (spec.tolerates_missing_bundle
                and any(e["type"] == "incident_drop" for e in since))
    b = c.admin_socket.execute(
        "tpu incident dump", {"id": str(rows[-1]["id"])})["incident"]
    if b["state"] != "resolved":
        return False
    tl = b["timeline"]
    gseqs = [e["gseq"] for e in tl]
    if gseqs != sorted(gseqs) or len(set(gseqs)) != len(gseqs):
        return False
    if chain and check in CHECK_CHAINS:
        # forward-scanning subsequence match anchored at the
        # scenario's journal watermark: each stage must be told by an
        # event AFTER the previous stage (a bundle timeline tail may
        # legitimately carry pre-scenario events of the same types)
        last = gseq0
        for etype, match in CHECK_CHAINS[check]:
            g = next((e["gseq"] for e in tl
                      if e["gseq"] > last and e["type"] == etype
                      and all(e.get(k) == v
                              for k, v in match.items())), None)
            if g is None:
                return False
            last = g
    return True


def _acceptance(c, spec: ScenarioSpec, res, settle: Dict[str, Any],
                gseq0: int) -> Dict[str, Any]:
    """The universal acceptance judgment — one receipt per storyline."""
    pc = chaos_perf_counters()
    since = g_journal.merged_since(gseq0)
    present = {e["type"] for e in since}
    raises = [e for e in since if e["type"] == "health_raise"]
    cleared = {e.get("check") for e in since
               if e["type"] == "health_clear"}
    pc.inc(l_chaos_checks_raised, len(raises))
    pc.inc(l_chaos_checks_cleared, len(cleared))
    checks: Dict[str, Dict[str, bool]] = {}
    checks_ok = True
    for chk in spec.expected_checks:
        row = {"raised": any(e.get("check") == chk for e in raises),
               "cleared": chk in cleared,
               "bundle_ok": _bundle_ok(c, chk, spec, since,
                                       gseq0=gseq0)}
        checks[chk] = row
        checks_ok = checks_ok and all(row.values())
    # EVERY raise — expected or collateral — must clear and leave a
    # finalized bundle (or a journaled drop when capture was the leg)
    all_raises_ok = True
    for e in raises:
        chk = e.get("check")
        if chk not in cleared or not _bundle_ok(c, chk, spec, since,
                                                chain=False):
            all_raises_ok = False
    storyline_ok = all(t in present for t in spec.journal_expect)
    byte_exact = bool(res.byte_exact) and settle["oracles_ok"]
    wedged = settle["wedged"] or res.rounds >= res.spec.max_rounds
    if wedged:
        pc.inc(l_chaos_wedges)
    accepted = (byte_exact and not wedged and checks_ok
                and all_raises_ok and storyline_ok)
    listing = c.admin_socket.execute("tpu incident list")
    return {
        "seed": spec.seed,
        "legs": list(spec.legs),
        "accepted": accepted,
        "byte_exact": byte_exact,
        "wedged": wedged,
        "checks": checks,
        "all_raises_resolved": all_raises_ok,
        "storyline_told": storyline_ok,
        "rounds": res.rounds,
        "ops_completed": res.completed,
        "settle_ticks": settle["ticks"],
        "mesh_fallbacks": 0,
        "journal_events": len(since),
        "incidents": {"captures_total": listing["captures_total"],
                      "bundles": [{"id": r["id"],
                                   "trigger": r["trigger"],
                                   "state": r["state"]}
                                  for r in listing["incidents"]]},
    }


def run_scenario(spec: ScenarioSpec, n_osds: int = 6, k: int = 3,
                 m: int = 2, n_clients: int = 6,
                 ops_per_client: int = 12, rate: float = 3.0,
                 progress=None, device="cuda") -> Dict[str, Any]:
    """Execute one composed storyline end to end; returns the
    universal-acceptance receipt.  Owns the cluster and every process
    singleton it touches (conf saved/restored, faults/dispatcher/mesh/
    scoreboard reset after), so scenarios compose into soaks without
    bleeding state.  The pool's and the oracle's codecs run on the card;
    ``device="cpu"`` gives them ``backend=host``."""
    from ..cluster import MiniCluster
    from ..dispatch import g_dispatcher
    from ..ec.cuda_plugin import backend_profile
    from ..fault import g_faults
    from ..mesh import g_chipstat, g_mesh
    pc = chaos_perf_counters()
    saved = {n: g_conf.values.get(n) for n in TOUCHED}
    pc.set(l_chaos_active, 1)
    try:
        g_conf.set_val("ec_mesh_chips", BASE_MESH_CHIPS)
        g_conf.set_val("ec_mesh_rateless", True)
        g_conf.rm_val("ec_mesh_rateless_tasks")
        g_conf.set_val("ec_mesh_skew_sample_every", 1)
        g_conf.set_val("ec_mesh_skew_threshold", 3.0)
        # a non-zero window routes encodes through the coalescing +
        # mesh path (window=0 is the exact passthrough); correctness
        # never waits on the timer — result() force-flushes its queue
        g_conf.set_val("ec_dispatch_batch_window_us", 10_000_000)
        g_conf.set_val("ec_dispatch_batch_max", 64)
        g_conf.set_val("mgr_incident_timeline_tail", 512)
        g_conf.set_val("mgr_journal_ring_size", 2048)
        g_faults.clear()
        g_dispatcher.flush()
        g_mesh.topology()
        c = MiniCluster(n_osds=n_osds)
        c.create_ec_pool("chaos", k=k, m=m, pg_num=8,
                         extra_profile=backend_profile(device))
        g_conf.set_val("mgr_control_enable", True)
        g_conf.set_val("mgr_control_cooldown_ticks", 1)
        flush = _oracle_flush_fn(device)
        flush()                          # warmup off the clock
        g_chipstat.reset()
        gseq0 = g_journal.last_gseq()
        pc.inc(l_chaos_scenarios)
        pc.inc(l_chaos_legs, len(spec.legs))
        g_journal.emit("chaos", "chaos_scenario_start", seed=spec.seed,
                       legs=list(spec.legs), events=len(spec.events))
        from ..load import run_traffic
        tspec = _compile(spec, "chaos", n_clients, ops_per_client,
                         rate)
        res = run_traffic(c, tspec, progress=progress)
        settle = _settle(c, spec, gseq0, flush)
        receipt = _acceptance(c, spec, res, settle, gseq0)
        g_journal.emit("chaos", "chaos_scenario_end", seed=spec.seed,
                       accepted=receipt["accepted"],
                       byte_exact=receipt["byte_exact"],
                       wedged=receipt["wedged"])
        pc.inc(l_chaos_accept_pass if receipt["accepted"]
               else l_chaos_accept_fail)
        return receipt
    finally:
        pc.set(l_chaos_active, 0)
        for name, v in saved.items():
            if v is None:
                g_conf.rm_val(name)
            else:
                g_conf.set_val(name, v)
        g_faults.clear()
        g_dispatcher.flush()
        g_mesh.topology()
        g_chipstat.reset()


def run_seed(seed: int, legs: Tuple[str, ...] = None,
             **kw) -> Dict[str, Any]:
    """Compose + execute in one call — the bench / asok entry point."""
    return run_scenario(compose_scenario(seed, legs=legs), **kw)


def dump() -> Dict[str, Any]:
    """`chaos dump` asok pane: the composable primitive catalog (legs
    + fault sites) and the engine counters."""
    from ..fault import g_faults
    from .scenario import leg_names
    return {
        "legs": leg_names(),
        "fault_sites": g_faults.sites(),
        "options": {
            "chaos_storyline_legs_max":
                int(g_conf.get_val("chaos_storyline_legs_max")),
            "chaos_settle_ticks_max":
                int(g_conf.get_val("chaos_settle_ticks_max")),
        },
        "counters": chaos_perf_counters().dump(),
    }
