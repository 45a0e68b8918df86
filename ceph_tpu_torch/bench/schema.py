"""Versioned metric record — the one shape every published number takes.

Port of ``ceph_tpu/bench/schema.py``, the same behaviour under the same names.

A metric dict carries: what was measured (name/unit/value), how (fenced
flag, RTT, statistics), and whether physics believes it (roofline
verdict).  ``validate_metric`` enforces the contract, including the
round-5 lesson that a device-time field of exactly 0.0 means "didn't
run", never "fast" (VERDICT Weak #3: a 100k-PG resolve published as
0.0 us because a fallback guard failed silently).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

SCHEMA_VERSION = 1

_REQUIRED = ("schema_version", "name", "value", "unit", "fenced")


class SchemaError(ValueError):
    """A metric record violates the schema contract."""


def make_metric(name: str, value: float, unit: str, *,
                fenced: bool,
                rtt_s: Optional[float] = None,
                stats: Optional[Dict[str, Any]] = None,
                roofline: Optional[Dict[str, Any]] = None,
                extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Assemble and validate one metric record."""
    m: Dict[str, Any] = {
        "schema_version": SCHEMA_VERSION,
        "name": name,
        "value": round(float(value), 4),
        "unit": unit,
        "fenced": bool(fenced),
    }
    if rtt_s is not None:
        m["rtt_ms"] = round(float(rtt_s) * 1e3, 3)
    if stats is not None:
        m["stats"] = {k: (round(v, 4) if isinstance(v, float) else v)
                      for k, v in stats.items()
                      if k not in ("samples", "warmup_samples")}
        for k in ("samples", "warmup_samples"):
            if k in stats:
                m["stats"][k] = [round(float(x), 4) for x in stats[k]]
    if roofline is not None:
        m["roofline"] = dict(roofline)
        m["suspect"] = bool(roofline.get("suspect", False))
    if extra:
        for k, v in extra.items():
            if k in m:
                raise SchemaError(f"extra field {k!r} collides with "
                                  "a schema field")
            m[k] = v
    validate_metric(m)
    return m


def validate_metric(m: Dict[str, Any]) -> None:
    """Raise SchemaError unless *m* is a well-formed metric record."""
    for k in _REQUIRED:
        if k not in m:
            raise SchemaError(f"metric missing required field {k!r}")
    if m["schema_version"] != SCHEMA_VERSION:
        raise SchemaError(f"unknown schema_version {m['schema_version']!r}")
    if not isinstance(m["name"], str) or not m["name"]:
        raise SchemaError("metric name must be a non-empty string")
    if not isinstance(m["fenced"], bool):
        raise SchemaError("fenced must be a bool")
    v = m["value"]
    if not isinstance(v, (int, float)) or isinstance(v, bool):
        raise SchemaError(f"value must be numeric, got {type(v).__name__}")
    if v < 0:
        raise SchemaError("value must be non-negative")
    # "fast" and "didn't run" must be distinguishable: an exact 0.0 in
    # a timing/throughput metric is always the latter (Weak #3).
    if v == 0.0 and m["unit"] in ("GiB/s", "ms", "us", "s"):
        raise SchemaError(
            f"metric {m['name']!r} is exactly 0.0 {m['unit']} — a zero "
            "reading means the measurement did not run; refuse to "
            "publish it as a number")
    st = m.get("stats")
    if st is not None:
        for k in ("n", "median", "iqr", "min"):
            if k not in st:
                raise SchemaError(f"stats missing {k!r}")
        if st["n"] < 1:
            raise SchemaError("stats.n must be >= 1")
        if st["min"] > st["median"]:
            raise SchemaError("stats.min exceeds stats.median")
    rl = m.get("roofline")
    if rl is not None:
        if "verdict" not in rl or rl["verdict"] not in (
                "ok", "suspect", "unknown"):
            raise SchemaError("roofline.verdict must be ok|suspect|unknown")
        if "suspect" not in m or m["suspect"] != (rl["verdict"] == "suspect"):
            raise SchemaError("top-level suspect must mirror the "
                              "roofline verdict")
