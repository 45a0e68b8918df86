"""Unified observability layer: spans, perf histograms, flight recorder,
the device-flow profiler, the stage-latency ledger and the event journal.

Port of ``ceph_tpu/trace/``, exporting the same names.  Everything here
is sync-free by construction: spans, histogram increments and the
accounting calls never touch the device, so the default-off tracer adds
no ``torch.cuda.synchronize`` and no device-to-host copy to any hot path.
"""
from .span import Span, SpanCollector, Tracer, build_tree, g_tracer
from .histogram import (
    PerfHistogram, PerfHistogramAxis, PerfHistogramCollection,
    SCALE_LINEAR, SCALE_LOG2, g_perf_histograms, latency_axes,
    latency_in_bytes_axes, occupancy_axes, pipeline_axes,
)
from .flight import FlightEntry, FlightRecorder, g_flight_recorder
from .devprof import (DevFlowProfiler, devflow_delta,
                      devprof_perf_counters, g_devprof,
                      transfer_size_axes)
from .oplat import (OpLedger, OpLatAccumulator, STAGES, g_oplat,
                    oplat_perf_counters)
from .journal import (EVENT_TYPES, EventJournal, g_journal,
                      journal_perf_counters)

__all__ = [
    "Span", "SpanCollector", "Tracer", "build_tree", "g_tracer",
    "PerfHistogram", "PerfHistogramAxis", "PerfHistogramCollection",
    "SCALE_LINEAR", "SCALE_LOG2", "g_perf_histograms", "latency_axes",
    "latency_in_bytes_axes", "occupancy_axes", "pipeline_axes",
    "FlightEntry", "FlightRecorder", "g_flight_recorder",
    "DevFlowProfiler", "devflow_delta", "devprof_perf_counters",
    "g_devprof", "transfer_size_axes",
    "OpLedger", "OpLatAccumulator", "STAGES", "g_oplat",
    "oplat_perf_counters",
    "EVENT_TYPES", "EventJournal", "g_journal",
    "journal_perf_counters",
]
