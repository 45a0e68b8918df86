"""Device-path fault injection: the site registry.

Port of ``ceph_tpu/fault/`` without its ``guard`` (retry, backoff and
watchdog around device calls) and ``breaker`` (circuit breakers that
trip a codec signature onto the CPU path): the port has no host route
for a device request, so a device error propagates to the caller.  What
remains is the registry of named injection sites with the admin
socket's ``fault inject|list|clear`` surface; the dispatch scheduler
checks its ``dispatch.batch`` site before every coalesced flush.
"""
from .registry import (FaultRegistry, FaultSpec, InjectedDeviceError,
                       InjectedFault, InjectedTimeout, SITE_CATALOG,
                       fault_perf_counters, g_faults, l_fault_cpu_fallbacks,
                       l_fault_eio_injected, l_fault_eio_reconstructs,
                       l_fault_msg_drops)

__all__ = [
    "FaultRegistry", "FaultSpec", "InjectedDeviceError", "InjectedFault",
    "InjectedTimeout", "SITE_CATALOG", "fault_perf_counters", "g_faults",
    "l_fault_cpu_fallbacks", "l_fault_eio_injected",
    "l_fault_eio_reconstructs", "l_fault_msg_drops",
]
