"""Process-wide runtime services of the port: the option table and
config proxy, perf counters, the admin socket, op tracking, lockdep,
leveled logging and kernel timing.

Port of ``ceph_tpu/common/``, exporting the same names.
"""
from .config import Option, ConfigProxy, OPT_INT, OPT_STR, OPT_FLOAT, \
    OPT_BOOL, OPT_DOUBLE
from .perf_counters import (
    PerfCounters, PerfCountersBuilder, PerfCountersCollection,
)
from .admin_socket import AdminSocket
from .tracked_op import OpTracker, TrackedOp
from .lockdep import (DebugLock, DebugRLock, LockOrderError,
                      lockdep_enable, lockdep_reset)
from .dout import Dout, Log, dlog, get_log, register_config_observers
from .kernel_trace import (
    KernelTimer, annotate, g_kernel_timer, start_profiler_trace,
    stop_profiler_trace,
)

__all__ = [
    "Option", "ConfigProxy", "OPT_INT", "OPT_STR", "OPT_FLOAT", "OPT_BOOL",
    "OPT_DOUBLE", "PerfCounters", "PerfCountersBuilder",
    "PerfCountersCollection", "AdminSocket", "OpTracker", "TrackedOp",
    "DebugLock", "DebugRLock", "LockOrderError", "lockdep_enable",
    "lockdep_reset",
    "Dout", "Log", "dlog", "get_log", "register_config_observers",
    "KernelTimer", "annotate", "g_kernel_timer", "start_profiler_trace",
    "stop_profiler_trace",
]
