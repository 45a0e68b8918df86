"""Performance measurement core of the port — completion-fenced timing,
roofline validation, statistics and the versioned metric schema.

Port of ``ceph_tpu/bench/`` without its regression comparator
(``regress.py``) and CLI (``__main__.py``), whose gates and ``--smoke``
drive workloads that need a cluster or a mesh.

- ``fence``     — timers that stop only once the last output's first
                  element has been copied to the host, with the copy's
                  round trip measured separately and reported, never
                  silently subtracted.
- ``roofline``  — chip peaks (the H100's among them) against which each
                  reading's implied op and byte rates are checked; a
                  reading above peak is stamped ``suspect``.
- ``stats``     — warmup discard, N repeats, median/IQR/min.
- ``schema``    — the versioned metric record; validation refuses
                  malformed or impossible fields (e.g. a time of 0.0).
- ``workloads`` — the EC encode/decode and CRUSH remap measurements.
"""
from .fence import (FencedTiming, drain, fenced_time, measure_rtt)
from .roofline import (chip_spec, validate_reading, EC_ENCODE_K8M4,
                       EC_DECODE_K8M4, EC_ENCODE_K8M4_SALTED,
                       EC_DECODE_K8M4_SALTED)
from .schema import (SCHEMA_VERSION, make_metric, validate_metric,
                     SchemaError)
from .stats import summarize, repeat_measure

__all__ = [
    "FencedTiming", "drain", "fenced_time", "measure_rtt",
    "chip_spec", "validate_reading", "EC_ENCODE_K8M4", "EC_DECODE_K8M4",
    "EC_ENCODE_K8M4_SALTED", "EC_DECODE_K8M4_SALTED",
    "SCHEMA_VERSION", "make_metric", "validate_metric", "SchemaError",
    "summarize", "repeat_measure",
]
