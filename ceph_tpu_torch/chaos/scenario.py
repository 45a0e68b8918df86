"""Seeded composed-chaos storylines (docs/CHAOS.md).

Every hostile scenario before this subsystem was hand-built and
singular — one recovery storm (tests/test_chaos.py), one chip
straggler (tests/test_incident.py), one abusive client
(docs/QOS.md).  Production failure is combinatorial, so this module
COMPOSES the existing primitive inventory into multi-fault storylines:
the fault-site catalog (``FaultRegistry.sites()``), the traffic
harness's first-class topology events (``TrafficSpec.events`` — OSD
kill/out/revive and the elastic-membership mesh_chip_add/retire), the
abusive-client rate dial (``TrafficSpec.rate_multipliers``), and the
mgr control plane's enable knob.

Determinism is the whole contract:

- ``compose_scenario(seed)`` consumes exactly one ``random.Random
  (seed)`` stream plus the ``chaos_storyline_legs_max`` option — same
  seed, same conf => an IDENTICAL :class:`ScenarioSpec` (dataclass
  equality over the full schedule; pinned in
  tests/test_chaos_composer.py).
- Storylines schedule on harness ROUNDS — the deterministic cluster
  clock surface (one ``network.pump`` per round, ``cluster.tick``
  every ``tick_every`` rounds).  No event ever consults the wall
  clock; wall time only ever appears inside measured latencies.
- The spec is DECLARATIVE — tuples of :class:`ScenarioEvent`, no
  callables — so two specs can be compared, dumped over the admin
  socket (``chaos compose``), and replayed byte-for-byte.  The engine
  (engine.py) compiles it into ``TrafficSpec.events`` + ``hooks``.

This module is pure host Python: no jax, no numpy — composing a
scenario allocates nothing on any device (the fence-count extension
in tests/test_observability.py pins that).
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Tuple

from ..common.config import g_conf

# base mesh the engine runs storylines on (ec_mesh_chips at scenario
# boot); legs that name chips sample inside this bound
BASE_MESH_CHIPS = 8


@dataclass(frozen=True)
class ScenarioEvent:
    """One declarative storyline step: *round* is the harness round it
    fires at (passed-round semantics, like ``TrafficSpec.events``);
    *detail* is a sorted tuple of (key, value) pairs so the event is
    hashable and two schedules compare by value."""
    round: int
    action: str
    detail: Tuple[Tuple[str, Any], ...] = ()

    def dump(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"round": self.round, "action": self.action}
        d.update(dict(self.detail))
        return d


@dataclass(frozen=True)
class ScenarioSpec:
    """One composed storyline — the unit of determinism and equality.

    ``expected_checks`` are the health checks the storyline MUST raise
    AND clear (universal acceptance); ``settle_clears`` are the fault
    sites the engine disarms only AFTER the expected raise (phased
    clear — the hysteresis needs the fault live until detection);
    ``journal_expect`` are the event types the injected storyline must
    leave in the causally-ordered journal."""
    seed: int
    legs: Tuple[str, ...]
    events: Tuple[ScenarioEvent, ...]
    expected_checks: Tuple[str, ...]
    settle_clears: Tuple[str, ...]
    journal_expect: Tuple[str, ...]
    rate_multipliers: Tuple[float, ...]
    tolerates_missing_bundle: bool

    def dump(self) -> Dict[str, Any]:
        return {
            "seed": self.seed,
            "legs": list(self.legs),
            "events": [e.dump() for e in self.events],
            "expected_checks": list(self.expected_checks),
            "settle_clears": list(self.settle_clears),
            "journal_expect": list(self.journal_expect),
            "rate_multipliers": list(self.rate_multipliers),
            "tolerates_missing_bundle": self.tolerates_missing_bundle,
        }


# ---------------------------------------------------------------------------
# the leg catalog — each builder consumes the shared seeded rng and
# returns the leg's declarative contribution.  Phases are sampled in
# rounds 1..~12, inside the window open-loop traffic is guaranteed to
# span (the run loops empty rounds until every scheduled step fired).

def _leg_recovery_storm(rng: random.Random) -> Dict[str, Any]:
    """An OSD dies and is marked out mid-traffic (backfill to a spare
    starts under load), then revives and rejoins — the full storm
    cycle from docs/RECOVERY.md as one leg."""
    osd = rng.randrange(3)
    r0 = 1 + rng.randrange(3)
    dur = 6 + rng.randrange(6)
    return {
        "events": [
            ScenarioEvent(r0, "osd_kill", (("osd", osd),)),
            ScenarioEvent(r0 + 1, "osd_out", (("osd", osd),)),
            ScenarioEvent(r0 + dur, "osd_revive", (("osd", osd),)),
            ScenarioEvent(r0 + dur + 1, "osd_in", (("osd", osd),)),
        ],
        "journal_expect": ("osd_down", "osd_out", "osd_in"),
    }


def _leg_chip_straggler(rng: random.Random) -> Dict[str, Any]:
    """One mesh chip serves 10x slow (the skew scoreboard's SUSPECT
    shape): TPU_MESH_SKEW must raise while the fault is live and clear
    after the settle-phase disarm — the only leg with a deterministic
    health-check contract, so it anchors the bundle oracle."""
    chip = 1 + rng.randrange(BASE_MESH_CHIPS - 2)
    r0 = 1 + rng.randrange(3)
    return {
        "events": [
            ScenarioEvent(r0, "fault_arm", (
                ("delay_us", 30_000),
                ("match", f"chip={chip}/"),
                ("mode", "always"),
                ("site", "mesh.chip_slowdown"))),
        ],
        "expected_checks": ("TPU_MESH_SKEW",),
        "settle_clears": ("mesh.chip_slowdown",),
        "journal_expect": ("fault_arm", "fault_fire",
                           "chip_suspect_mark"),
    }


def _leg_abusive_client(rng: random.Random) -> Dict[str, Any]:
    """One tenant turns its arrival rate up 8-12x (docs/QOS.md's
    saturation dial).  Compose-time traffic shape, not a scheduled
    step — recorded at round 0 so the storyline dump tells it."""
    mult = float(rng.choice((8, 10, 12)))
    return {
        "events": [
            ScenarioEvent(0, "traffic_abuse", (
                ("client", 0), ("multiplier", mult))),
        ],
        "rate_multipliers": (mult,),
    }


def _leg_chip_fail(rng: random.Random) -> Dict[str, Any]:
    """A bounded burst of hard per-chip failures: with the rateless
    coder on (engine base knobs) the flush completes from the first
    sufficient subset, so this leg must cost bandwidth, never an op."""
    chip = rng.randrange(BASE_MESH_CHIPS)
    r0 = 1 + rng.randrange(3)
    dur = 4 + rng.randrange(5)
    count = 2 + rng.randrange(3)
    return {
        "events": [
            ScenarioEvent(r0, "fault_arm", (
                ("count", count),
                ("match", f"chip={chip}/"),
                ("mode", "always"),
                ("site", "mesh.chip_fail"))),
            ScenarioEvent(r0 + dur, "fault_clear", (
                ("site", "mesh.chip_fail"),)),
        ],
        # NOT fault_clear: count=K self-disarms after K fires, so the
        # scheduled clear is usually a journal-silent no-op — the
        # storyline is told by the arm and the fires themselves
        "journal_expect": ("fault_arm", "fault_fire"),
    }


def _leg_degraded_read_straggler(rng: random.Random) -> Dict[str, Any]:
    """A data shard dies while one mesh chip serves 10x slow: the
    open-loop reads that land on the dead shard reconstruct through
    the MESHED decode path (the mesh's decode_stacked) with the
    straggler live — the rateless drain completes each group from the
    first spanning subset, so every read stays byte-exact with zero
    single-device fallbacks (the straggler-proof read PR's composed
    shape).  TPU_MESH_SKEW must raise while the slowdown is armed and
    clear after the settle-phase disarm, like the chip_straggler leg;
    the OSD revives before settle so acceptance judges a whole
    degrade/recover cycle."""
    osd = rng.randrange(3)
    chip = 1 + rng.randrange(BASE_MESH_CHIPS - 2)
    r0 = 1 + rng.randrange(3)
    dur = 5 + rng.randrange(5)
    return {
        "events": [
            ScenarioEvent(r0, "osd_kill", (("osd", osd),)),
            ScenarioEvent(r0, "fault_arm", (
                ("delay_us", 30_000),
                ("match", f"chip={chip}/"),
                ("mode", "always"),
                ("site", "mesh.chip_slowdown"))),
            ScenarioEvent(r0 + dur, "osd_revive", (("osd", osd),)),
        ],
        "expected_checks": ("TPU_MESH_SKEW",),
        "settle_clears": ("mesh.chip_slowdown",),
        "journal_expect": ("osd_down", "fault_arm", "fault_fire",
                           "chip_suspect_mark"),
    }


def _leg_msg_drop(rng: random.Random) -> Dict[str, Any]:
    """Seeded probabilistic loss of EC sub-op WRITES (``match=
    "MOSDECSubOpWrite "``): the pipeline's inflight sweep resends
    unacked sub-writes after ``ec_subwrite_retry_timeout`` on the
    deterministic tick clock, and shard-side replay is version-deduped,
    so every dropped message is recovered by design.  Client REQUESTS
    (``MOSDOp``) are deliberately NOT in scope: the open-loop harness
    client resends only on a reply, so a silently dropped request would
    hang the op to max_rounds — unrecoverable, hence un-composable."""
    r0 = 1 + rng.randrange(3)
    dur = 4 + rng.randrange(5)
    p = round(0.03 + 0.03 * rng.random(), 3)
    return {
        "events": [
            ScenarioEvent(r0, "fault_arm", (
                ("match", "MOSDECSubOpWrite "),
                ("mode", "prob"),
                ("p", p),
                ("seed", rng.randrange(1 << 16)),
                ("site", "msg.drop"))),
            ScenarioEvent(r0 + dur, "fault_clear", (
                ("site", "msg.drop"),)),
        ],
        "journal_expect": ("fault_arm", "fault_clear"),
    }


def _leg_shard_eio(rng: random.Random) -> Dict[str, Any]:
    """Every Nth shard read fails EIO: reads reconstruct from
    survivors (never more than m failures per read by construction —
    the n >= 4 bound from tests/test_chaos.py's determinism notes)."""
    r0 = 1 + rng.randrange(3)
    dur = 4 + rng.randrange(5)
    n = 4 + rng.randrange(4)
    return {
        "events": [
            ScenarioEvent(r0, "fault_arm", (
                ("mode", "nth"), ("n", n),
                ("site", "osd.shard_read_eio"))),
            ScenarioEvent(r0 + dur, "fault_clear", (
                ("site", "osd.shard_read_eio"),)),
        ],
        "journal_expect": ("fault_arm", "fault_clear"),
    }


def _leg_device_error(rng: random.Random) -> Dict[str, Any]:
    """Transient device-call failures on the batched encode path: the
    bounded retry absorbs them below the breaker threshold."""
    r0 = 1 + rng.randrange(3)
    dur = 4 + rng.randrange(5)
    n = 3 + rng.randrange(3)
    return {
        "events": [
            ScenarioEvent(r0, "fault_arm", (
                ("mode", "nth"), ("n", n),
                ("site", "device.encode_batch"))),
            ScenarioEvent(r0 + dur, "fault_clear", (
                ("site", "device.encode_batch"),)),
        ],
        "journal_expect": ("fault_arm", "fault_clear"),
    }


def _leg_capture_drop(rng: random.Random) -> Dict[str, Any]:
    """The forensics pipeline itself fails once (`mgr.incident_capture`
    once-shot): a raise during the armed window drops ITS bundle —
    journaled as incident_drop — and must never wedge the mgr tick, so
    acceptance tolerates a missing bundle IFF the drop was journaled."""
    r0 = 1 + rng.randrange(3)
    return {
        "events": [
            ScenarioEvent(r0, "fault_arm", (
                ("mode", "once"),
                ("site", "mgr.incident_capture"))),
        ],
        "journal_expect": ("fault_arm",),
        "tolerates_missing_bundle": True,
    }


def _leg_mesh_membership(rng: random.Random) -> Dict[str, Any]:
    """Elastic membership as just another fault: retire 1-2 chips
    mid-traffic (drain on the old mesh, scoreboard-informed retire),
    add them back later (real stripes within one flush of the plan
    rebuild) — the injectargs-live ``ec_mesh_chips`` path."""
    k = 1 + rng.randrange(2)
    r0 = 2 + rng.randrange(3)
    dur = 4 + rng.randrange(5)
    return {
        "events": [
            ScenarioEvent(r0, "mesh_chip_retire", (("chips", k),)),
            ScenarioEvent(r0 + dur, "mesh_chip_add", (("chips", k),)),
        ],
        "journal_expect": ("mesh_chip_retire", "mesh_chip_add"),
    }


def _leg_control_flap(rng: random.Random) -> Dict[str, Any]:
    """The SLO controller goes away and comes back mid-storyline: the
    cluster must hold every invariant with and without the feedback
    loop (the controller is an optimisation, never a crutch)."""
    r0 = 1 + rng.randrange(3)
    dur = 3 + rng.randrange(4)
    return {
        "events": [
            ScenarioEvent(r0, "conf_set", (
                ("option", "mgr_control_enable"), ("value", False))),
            ScenarioEvent(r0 + dur, "conf_set", (
                ("option", "mgr_control_enable"), ("value", True))),
        ],
    }


LEG_BUILDERS: Dict[str, Callable[[random.Random], Dict[str, Any]]] = {
    "abusive_client": _leg_abusive_client,
    "capture_drop": _leg_capture_drop,
    "chip_fail": _leg_chip_fail,
    "chip_straggler": _leg_chip_straggler,
    "control_flap": _leg_control_flap,
    "degraded_read_straggler": _leg_degraded_read_straggler,
    "device_error": _leg_device_error,
    "mesh_membership": _leg_mesh_membership,
    "msg_drop": _leg_msg_drop,
    "recovery_storm": _leg_recovery_storm,
    "shard_eio": _leg_shard_eio,
}


def leg_names() -> List[str]:
    """The composable leg catalog, sorted — the `chaos dump` pane."""
    return sorted(LEG_BUILDERS)


def compose_scenario(seed: int,
                     legs: Tuple[str, ...] = None) -> ScenarioSpec:
    """Sample one multi-fault storyline from *seed*.

    With *legs* None the storyline samples 1..``chaos_storyline_legs_
    max`` distinct legs from the catalog; passing *legs* pins WHICH
    primitives compose while the seed still shapes every phase (the
    tier-1 acceptance smoke pins storm+straggler+abusive this way).
    Pure and deterministic: same (seed, legs, conf) => equal spec.
    """
    rng = random.Random(int(seed))
    names = leg_names()
    if legs is None:
        legs_max = max(int(g_conf.get_val("chaos_storyline_legs_max")),
                       1)
        n = 1 + rng.randrange(min(legs_max, len(names)))
        legs = tuple(sorted(rng.sample(names, n)))
    else:
        legs = tuple(legs)
        for name in legs:
            if name not in LEG_BUILDERS:
                raise ValueError(f"unknown storyline leg '{name}' "
                                 f"(catalog: {names})")
    events: List[ScenarioEvent] = []
    expected_checks: List[str] = []
    settle_clears: List[str] = []
    journal_expect: List[str] = []
    rate_multipliers: Tuple[float, ...] = ()
    tolerates = False
    for name in legs:           # build order = leg order = rng order
        leg = LEG_BUILDERS[name](rng)
        events.extend(leg["events"])
        expected_checks.extend(leg.get("expected_checks", ()))
        settle_clears.extend(leg.get("settle_clears", ()))
        journal_expect.extend(leg.get("journal_expect", ()))
        rate_multipliers = rate_multipliers + tuple(
            leg.get("rate_multipliers", ()))
        tolerates = tolerates or leg.get("tolerates_missing_bundle",
                                         False)
    _validate_fault_sites(events)
    events.sort(key=lambda e: (e.round, e.action, e.detail))
    return ScenarioSpec(
        seed=int(seed), legs=legs, events=tuple(events),
        expected_checks=tuple(sorted(set(expected_checks))),
        settle_clears=tuple(sorted(set(settle_clears))),
        journal_expect=tuple(sorted(set(journal_expect))),
        rate_multipliers=rate_multipliers,
        tolerates_missing_bundle=tolerates)


def _validate_fault_sites(events: List[ScenarioEvent]) -> None:
    """Every fault-backed step must name a REGISTERED site — the
    composer enumerates primitives from the machine-readable catalog,
    it never invents them (satellite contract: `FaultRegistry.sites()`
    is the enumeration surface, and every site is documented in
    docs/ROBUSTNESS.md by the tier-1 lint)."""
    from ..fault import g_faults
    catalog = g_faults.sites()
    for ev in events:
        if ev.action in ("fault_arm", "fault_clear"):
            site = dict(ev.detail)["site"]
            if site not in catalog:
                raise ValueError(
                    f"storyline names unregistered fault site "
                    f"'{site}' (see `fault list format=json`)")
