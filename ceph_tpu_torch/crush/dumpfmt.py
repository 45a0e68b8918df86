"""`crushtool --dump` — the reference's JSON map dump, byte-exact.

Mirrors CrushWrapper::dump (src/crush/CrushWrapper.cc): devices,
types, buckets (every slot, shadows included), rules with symbolic
step ops, the tunables block with profile / minimum-required-version
detection, and choose_args.  The emitter reproduces the reference
Formatter's pretty-JSON shape: 4-space indent and printf-%f floats
(weight_set weights print as 1.000000), which stock json.dumps cannot
produce.

The port's own copy of ``ceph_tpu/crush/dumpfmt.py``.
"""
from __future__ import annotations

from typing import Any, Dict, List

from .constants import (
    CRUSH_BUCKET_LIST, CRUSH_BUCKET_STRAW, CRUSH_BUCKET_STRAW2,
    CRUSH_BUCKET_TREE, CRUSH_BUCKET_UNIFORM,
    CRUSH_RULE_CHOOSELEAF_FIRSTN, CRUSH_RULE_CHOOSELEAF_INDEP,
    CRUSH_RULE_CHOOSE_FIRSTN, CRUSH_RULE_CHOOSE_INDEP, CRUSH_RULE_EMIT,
    CRUSH_RULE_SET_CHOOSELEAF_STABLE, CRUSH_RULE_SET_CHOOSELEAF_TRIES,
    CRUSH_RULE_SET_CHOOSELEAF_VARY_R,
    CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
    CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES, CRUSH_RULE_SET_CHOOSE_TRIES,
    CRUSH_RULE_TAKE,
)

ALG_NAMES = {CRUSH_BUCKET_UNIFORM: "uniform", CRUSH_BUCKET_LIST: "list",
             CRUSH_BUCKET_TREE: "tree", CRUSH_BUCKET_STRAW: "straw",
             CRUSH_BUCKET_STRAW2: "straw2"}
LEGACY_ALGS = (1 << CRUSH_BUCKET_UNIFORM) | (1 << CRUSH_BUCKET_LIST) \
    | (1 << CRUSH_BUCKET_STRAW)
HAMMER_ALGS = LEGACY_ALGS | (1 << CRUSH_BUCKET_STRAW2)


class _F:
    """A float that prints like printf %f (Formatter::dump_float)."""

    def __init__(self, v: float):
        self.v = v


def _tunables_match(m, local, fallback, total, once, vary, stable,
                    algs) -> bool:
    return (m.choose_local_tries == local
            and m.choose_local_fallback_tries == fallback
            and m.choose_total_tries == total
            and m.chooseleaf_descend_once == once
            and m.chooseleaf_vary_r == vary
            and m.chooseleaf_stable == stable
            and m.allowed_bucket_algs == algs)


def _profile(m) -> str:
    if _tunables_match(m, 0, 0, 50, 1, 1, 1, HAMMER_ALGS):
        return "jewel"
    if _tunables_match(m, 0, 0, 50, 1, 1, 0, HAMMER_ALGS):
        return "hammer"
    if _tunables_match(m, 0, 0, 50, 1, 1, 0, LEGACY_ALGS):
        return "firefly"
    if _tunables_match(m, 0, 0, 50, 1, 0, 0, LEGACY_ALGS):
        return "bobtail"
    if _tunables_match(m, 2, 5, 19, 0, 0, 0, LEGACY_ALGS):
        return "argonaut"
    return "unknown"


def _has_v2_rules(m) -> bool:
    v2 = {CRUSH_RULE_CHOOSE_INDEP, CRUSH_RULE_CHOOSELEAF_INDEP,
          CRUSH_RULE_SET_CHOOSE_TRIES, CRUSH_RULE_SET_CHOOSELEAF_TRIES}
    return any(s.op in v2 for r in m.rules if r is not None
               for s in r.steps)


def _has_step(m, op) -> bool:
    return any(s.op == op for r in m.rules if r is not None
               for s in r.steps)


def _min_required_version(m) -> str:
    if _has_step(m, CRUSH_RULE_SET_CHOOSELEAF_STABLE) or \
            m.chooseleaf_stable != 0:
        return "jewel"
    if any(b is not None and b.alg == CRUSH_BUCKET_STRAW2
           for b in m.buckets):
        return "hammer"
    if m.chooseleaf_vary_r != 0:
        return "firefly"
    if m.chooseleaf_descend_once != 0 or m.choose_local_tries != 2 \
            or m.choose_local_fallback_tries != 5 \
            or m.choose_total_tries != 19:
        return "bobtail"
    return "argonaut"


def dump_map(cw) -> Dict[str, Any]:
    """The dict CrushWrapper::dump builds, in emission order."""
    m = cw.crush
    out: Dict[str, Any] = {}
    devices = []
    for d in range(m.max_devices):
        dev = {"id": d, "name": cw.name_map.get(d, f"device{d}")}
        if d in cw.item_class:
            dev["class"] = cw.class_map[cw.item_class[d]]
        devices.append(dev)
    out["devices"] = devices
    types = []
    if cw.type_map and 0 not in cw.type_map:
        types.append({"type_id": 0, "name": "device"})
    for t in sorted(cw.type_map):
        types.append({"type_id": t, "name": cw.type_map[t]})
    out["types"] = types
    buckets = []
    for b in m.buckets:
        if b is None:
            continue
        entry: Dict[str, Any] = {"id": b.id}
        if b.id in cw.name_map:
            entry["name"] = cw.name_map[b.id]
        entry["type_id"] = b.type
        if b.type in cw.type_map:
            entry["type_name"] = cw.type_map[b.type]
        entry["weight"] = b.weight
        entry["alg"] = ALG_NAMES.get(b.alg, str(b.alg))
        entry["hash"] = "rjenkins1" if getattr(b, "hash", 0) == 0 \
            else "unknown"
        entry["items"] = [
            {"id": it, "weight": cw._bucket_item_weight(b, j),
             "pos": j} for j, it in enumerate(b.items)]
        buckets.append(entry)
    out["buckets"] = buckets
    rules = []
    for rno, r in enumerate(m.rules):
        if r is None:
            continue
        rd: Dict[str, Any] = {"rule_id": rno}
        if rno in cw.rule_name_map:
            rd["rule_name"] = cw.rule_name_map[rno]
        rd["ruleset"] = r.ruleset
        rd["type"] = r.type
        rd["min_size"] = r.min_size
        rd["max_size"] = r.max_size
        steps = []
        opname = {CRUSH_RULE_CHOOSE_FIRSTN: "choose_firstn",
                  CRUSH_RULE_CHOOSE_INDEP: "choose_indep",
                  CRUSH_RULE_CHOOSELEAF_FIRSTN: "chooseleaf_firstn",
                  CRUSH_RULE_CHOOSELEAF_INDEP: "chooseleaf_indep"}
        # ONLY these two set_* steps have symbolic names in the
        # reference's dump_rule; every other op falls to the raw
        # opcode/arg1/arg2 default branch
        setname = {
            CRUSH_RULE_SET_CHOOSE_TRIES: "set_choose_tries",
            CRUSH_RULE_SET_CHOOSELEAF_TRIES: "set_chooseleaf_tries"}
        for s in r.steps:
            if s.op == CRUSH_RULE_TAKE:
                steps.append({"op": "take", "item": s.arg1,
                              "item_name":
                              cw.name_map.get(s.arg1, "")})
            elif s.op == CRUSH_RULE_EMIT:
                steps.append({"op": "emit"})
            elif s.op in opname:
                steps.append({"op": opname[s.op], "num": s.arg1,
                              "type": cw.type_map.get(s.arg2, "")})
            elif s.op in setname:
                steps.append({"op": setname[s.op], "num": s.arg1})
            elif s.op == 0:
                steps.append({"op": "noop"})
            else:
                steps.append({"opcode": s.op, "arg1": s.arg1,
                              "arg2": s.arg2})
        rd["steps"] = steps
        rules.append(rd)
    out["rules"] = rules
    tun: Dict[str, Any] = {
        "choose_local_tries": m.choose_local_tries,
        "choose_local_fallback_tries": m.choose_local_fallback_tries,
        "choose_total_tries": m.choose_total_tries,
        "chooseleaf_descend_once": m.chooseleaf_descend_once,
        "chooseleaf_vary_r": m.chooseleaf_vary_r,
        "chooseleaf_stable": m.chooseleaf_stable,
        "straw_calc_version": m.straw_calc_version,
        "allowed_bucket_algs": m.allowed_bucket_algs,
        "profile": _profile(m),
        "optimal_tunables": int(_profile(m) == "jewel"),
        "legacy_tunables": int(_profile(m) == "argonaut"),
        "minimum_required_version": _min_required_version(m),
        "require_feature_tunables": int(
            m.choose_local_tries != 2
            or m.choose_local_fallback_tries != 5
            or m.choose_total_tries != 19),
        "require_feature_tunables2": int(
            m.chooseleaf_descend_once != 0),
        "has_v2_rules": int(_has_v2_rules(m)),
        "require_feature_tunables3": int(m.chooseleaf_vary_r != 0),
        "has_v3_rules": int(_has_step(
            m, CRUSH_RULE_SET_CHOOSELEAF_VARY_R)),
        "has_v4_buckets": int(any(
            b is not None and b.alg == CRUSH_BUCKET_STRAW2
            for b in m.buckets)),
        "require_feature_tunables5": int(m.chooseleaf_stable != 0),
        "has_v5_rules": int(_has_step(
            m, CRUSH_RULE_SET_CHOOSELEAF_STABLE)),
    }
    out["tunables"] = tun
    cargs: Dict[str, Any] = {}
    for key in sorted(m.choose_args):
        entries = []
        for bi, arg in enumerate(m.choose_args[key]):
            if arg is None or (not arg.ids and not arg.weight_set):
                continue
            e: Dict[str, Any] = {"bucket_id": -1 - bi}
            if arg.weight_set:
                import numpy as _np
                # the reference divides in FLOAT32 before printf %f
                e["weight_set"] = [
                    [_F(float(_np.float32(w) / _np.float32(0x10000)))
                     for w in ws.weights]
                    for ws in arg.weight_set]
            if arg.ids:
                e["ids"] = list(arg.ids)
            entries.append(e)
        cargs[str(key)] = entries
    out["choose_args"] = cargs
    return out


def _emit(v: Any, indent: int) -> str:
    sp = " " * indent
    inner = " " * (indent + 4)
    if isinstance(v, _F):
        return f"{v.v:f}"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, str):
        import json as _json
        return _json.dumps(v)
    if isinstance(v, list):
        if not v:
            return "[]"
        body = ",\n".join(inner + _emit(x, indent + 4) for x in v)
        return "[\n" + body + "\n" + sp + "]"
    if isinstance(v, dict):
        if not v:
            return "{}"
        import json as _json
        body = ",\n".join(
            f"{inner}{_json.dumps(str(k))}: {_emit(x, indent + 4)}"
            for k, x in v.items())
        return "{\n" + body + "\n" + sp + "}"
    raise TypeError(type(v))


def dump_json(cw) -> str:
    """The `crushtool --dump` stdout (the reference Formatter's flush
    leaves a blank line after the closing brace)."""
    return _emit(dump_map(cw), 0) + "\n\n"
