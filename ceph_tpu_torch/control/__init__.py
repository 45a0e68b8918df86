"""The damped SLO-driven self-tuning control plane; port of
``ceph_tpu/control``.

See controller.py (docs/CONTROL.md for the policy map and runbook).
"""
from .controller import (CONTROL_KNOBS, Controller, control_perf_counters,
                         l_ctl_enabled, l_ctl_engaged, l_ctl_episodes,
                         l_ctl_failures, l_ctl_moves, l_ctl_pinned,
                         l_ctl_restores, l_ctl_retries, l_ctl_reverts,
                         l_ctl_skipped_cooldown, l_ctl_ticks,
                         l_ctl_tightens)

__all__ = [
    "CONTROL_KNOBS", "Controller", "control_perf_counters",
    "l_ctl_enabled", "l_ctl_engaged", "l_ctl_episodes", "l_ctl_failures",
    "l_ctl_moves", "l_ctl_pinned", "l_ctl_restores", "l_ctl_retries",
    "l_ctl_reverts", "l_ctl_skipped_cooldown", "l_ctl_ticks",
    "l_ctl_tightens",
]
