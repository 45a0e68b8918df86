"""Recovery orchestration — paced, observable, QoS-classed repair.

See scheduler.py.  Port of ``ceph_tpu/recovery/``, exporting the same
names.
"""
from .scheduler import (RecoveryScheduler, aggregate_families,
                        recovery_perf_counters,
                        l_recovery_active, l_recovery_deferrals,
                        l_recovery_fallbacks, l_recovery_fullstripe_bytes,
                        l_recovery_fullstripe_rounds,
                        l_recovery_helper_bytes, l_recovery_helper_reads,
                        l_recovery_push_bytes, l_recovery_repair_rounds,
                        l_recovery_repaired_shards)

__all__ = [
    "RecoveryScheduler", "aggregate_families", "recovery_perf_counters",
    "l_recovery_active", "l_recovery_deferrals", "l_recovery_fallbacks",
    "l_recovery_fullstripe_bytes", "l_recovery_fullstripe_rounds",
    "l_recovery_helper_bytes", "l_recovery_helper_reads",
    "l_recovery_push_bytes", "l_recovery_repair_rounds",
    "l_recovery_repaired_shards",
]
