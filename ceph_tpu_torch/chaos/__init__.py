"""The seeded composed-chaos scenario engine; port of ``ceph_tpu/chaos``.

Deterministic multi-fault storylines sampled over the cluster's
primitive inventory (fault sites, topology events, the abusive-client
dial, elastic mesh membership, controller flips), executed on a
ticking MiniCluster under open-loop harness traffic and judged against
the UNIVERSAL acceptance: byte-exact ops, raise-and-clear health, a
finalized incident bundle that tells the storyline back, zero wedges.
See docs/CHAOS.md.
"""
from .engine import (CHECK_CHAINS, chaos_perf_counters, run_scenario,
                     run_seed)
from .engine import dump as engine_dump
from .scenario import (BASE_MESH_CHIPS, LEG_BUILDERS, ScenarioEvent,
                       ScenarioSpec, compose_scenario, leg_names)

__all__ = [
    "BASE_MESH_CHIPS", "CHECK_CHAINS", "LEG_BUILDERS", "ScenarioEvent",
    "ScenarioSpec", "chaos_perf_counters", "compose_scenario",
    "engine_dump", "leg_names", "run_scenario", "run_seed",
]
