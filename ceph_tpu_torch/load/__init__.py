"""The million-op traffic harness (docs/QOS.md); port of ``ceph_tpu/load``.

Open/closed-loop multi-client workload generation over the real
messenger/client stack, with per-client latency percentiles out of the
PerfHistogram machinery.  The load every QoS / perf PR is measured
under; exposed to ``python -m ceph_tpu_torch.bench`` via
``bench.workloads.measure_traffic``.
"""
from .traffic import (
    MAX_OP_ATTEMPTS, MAX_THROTTLE_RESENDS, PendingOp, SyntheticClient,
    TrafficResult, TrafficSpec, hist_percentiles, run_traffic,
)

__all__ = [
    "MAX_OP_ATTEMPTS", "MAX_THROTTLE_RESENDS", "PendingOp",
    "SyntheticClient", "TrafficResult", "TrafficSpec",
    "hist_percentiles", "run_traffic",
]
