"""CrushCompiler — crushmap text format ⇄ CrushWrapper.

Implements the reference's textual map grammar (src/crush/CrushCompiler.cc,
grammar in src/crush/grammar.h): tunable lines, device lines (with device
class), type lines, bucket blocks (id/alg/hash/item weight), and rule
blocks (ruleset/type/min_size/max_size/step...).  compile() parses text
into a CrushWrapper; decompile() emits text that re-compiles to the same
map — the crushtool -c/-d round-trip contract.

The port's own copy of ``ceph_tpu/crush/compiler.py``, its text byte for
byte.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, TextIO

from .constants import (
    CRUSH_BUCKET_LIST, CRUSH_BUCKET_STRAW, CRUSH_BUCKET_STRAW2,
    CRUSH_BUCKET_TREE, CRUSH_BUCKET_UNIFORM,
    CRUSH_RULE_CHOOSELEAF_FIRSTN, CRUSH_RULE_CHOOSELEAF_INDEP,
    CRUSH_RULE_CHOOSE_FIRSTN, CRUSH_RULE_CHOOSE_INDEP, CRUSH_RULE_EMIT,
    CRUSH_RULE_SET_CHOOSELEAF_STABLE, CRUSH_RULE_SET_CHOOSELEAF_TRIES,
    CRUSH_RULE_SET_CHOOSELEAF_VARY_R,
    CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
    CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES, CRUSH_RULE_SET_CHOOSE_TRIES,
    CRUSH_RULE_TAKE, PG_POOL_TYPE_ERASURE, PG_POOL_TYPE_REPLICATED,
)
from .types import Rule, RuleStep
from .wrapper import CrushWrapper

ALG_NAMES = {
    CRUSH_BUCKET_UNIFORM: "uniform",
    CRUSH_BUCKET_LIST: "list",
    CRUSH_BUCKET_TREE: "tree",
    CRUSH_BUCKET_STRAW: "straw",
    CRUSH_BUCKET_STRAW2: "straw2",
}
ALG_IDS = {v: k for k, v in ALG_NAMES.items()}

RULE_TYPE_NAMES = {PG_POOL_TYPE_REPLICATED: "replicated",
                   PG_POOL_TYPE_ERASURE: "erasure"}
RULE_TYPE_IDS = {v: k for k, v in RULE_TYPE_NAMES.items()}

STEP_SET_OPS = {
    "set_choose_tries": CRUSH_RULE_SET_CHOOSE_TRIES,
    "set_chooseleaf_tries": CRUSH_RULE_SET_CHOOSELEAF_TRIES,
    "set_choose_local_tries": CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES,
    "set_choose_local_fallback_tries":
        CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
    "set_chooseleaf_vary_r": CRUSH_RULE_SET_CHOOSELEAF_VARY_R,
    "set_chooseleaf_stable": CRUSH_RULE_SET_CHOOSELEAF_STABLE,
}
STEP_SET_NAMES = {v: k for k, v in STEP_SET_OPS.items()}

TUNABLES = ("choose_local_tries", "choose_local_fallback_tries",
            "choose_total_tries", "chooseleaf_descend_once",
            "chooseleaf_vary_r", "chooseleaf_stable", "straw_calc_version",
            "allowed_bucket_algs")


class CrushCompiler:
    def __init__(self, crush: Optional[CrushWrapper] = None):
        self.crush = crush or CrushWrapper()

    # ---- decompile ---------------------------------------------------------
    def decompile(self) -> str:
        """Reference-exact text form (CrushCompiler::decompile): the
        tunable lines appear only when they differ from LEGACY
        defaults, weights print at the reference's 3-decimal
        fixedpoint, buckets carry the advisory comments, rules use the
        'id N' header — recorded reference decompiles (multitype.after,
        add-item.t) and ours compare byte-for-byte."""
        cw = self.crush
        m = cw.crush
        out: List[str] = ["# begin crush map"]
        legacy = {"choose_local_tries": 2,
                  "choose_local_fallback_tries": 5,
                  "choose_total_tries": 19,
                  "chooseleaf_descend_once": 0,
                  "chooseleaf_vary_r": 0,
                  "chooseleaf_stable": 0,
                  "straw_calc_version": 0,
                  # CRUSH_LEGACY_ALLOWED_BUCKET_ALGS (crush.h:198)
                  "allowed_bucket_algs": (1 << 1) | (1 << 2) | (1 << 4)}
        for t in TUNABLES:
            v = getattr(m, t, legacy[t])
            if v != legacy[t]:
                out.append(f"tunable {t} {v}")
        out.append("")
        out.append("# devices")
        for d in range(m.max_devices):
            name = cw.name_map.get(d)
            if name is None:
                continue
            cls = cw.item_class.get(d)
            suffix = f" class {cw.class_map[cls]}" \
                if cls is not None else ""
            out.append(f"device {d} {name}{suffix}")
        out.append("")
        out.append("# types")
        if cw.type_map and 0 not in cw.type_map:
            out.append("type 0 osd")
        for t in sorted(cw.type_map):
            out.append(f"type {t} {cw.type_map[t]}")
        out.append("")
        out.append("# buckets")

        def item_name(it: int) -> str:
            return cw.name_map.get(
                it, f"device{it}" if it >= 0 else f"bucket{-1 - it}")

        emitted = set()

        def emit_bucket(bid: int):
            if bid in emitted:
                return
            b = m.bucket(bid)
            if b is None:
                return
            emitted.add(bid)
            if "~" in cw.name_map.get(bid, ""):
                return              # shadow trees are implementation
            for it in b.items:
                if it < 0:
                    emit_bucket(it)
            tname = cw.type_map.get(b.type, f"type{b.type}")
            out.append(f"{tname} {item_name(bid)} {{")
            out.append(f"\tid {bid}\t\t# do not change unnecessarily")
            for cls, cid in sorted(
                    cw.class_bucket.get(bid, {}).items()):
                out.append(f"\tid {cid} class {cw.class_map[cls]}"
                           f"\t\t# do not change unnecessarily")
            out.append(f"\t# weight {b.weight / 0x10000:.3f}")
            alg = ALG_NAMES.get(b.alg, str(b.alg))
            note = ""
            dopos = False
            from .constants import (
                CRUSH_BUCKET_LIST, CRUSH_BUCKET_TREE,
                CRUSH_BUCKET_UNIFORM)
            if b.alg == CRUSH_BUCKET_UNIFORM:
                note = ("\t# do not change bucket size "
                        f"({b.size}) unnecessarily")
                dopos = True
            elif b.alg == CRUSH_BUCKET_LIST:
                note = ("\t# add new items at the end; "
                        "do not change order unnecessarily")
            elif b.alg == CRUSH_BUCKET_TREE:
                note = ("\t# do not change pos for existing "
                        "items unnecessarily")
                dopos = True
            out.append(f"\talg {alg}{note}")
            out.append("\thash 0\t# rjenkins1")
            ws = getattr(b, "item_weights", None)
            for i, it in enumerate(b.items):
                if b.alg == CRUSH_BUCKET_UNIFORM:
                    w = b.item_weight
                elif b.alg == CRUSH_BUCKET_TREE:
                    # tree stores weights at the leaf NODES
                    # (crush_calc_tree_node)
                    w = b.node_weights[((i + 1) << 1) - 1]
                elif ws is not None and i < len(ws):
                    w = ws[i]
                else:
                    w = 0
                pos = f" pos {i}" if dopos else ""
                out.append(f"\titem {item_name(it)} weight "
                           f"{w / 0x10000:.3f}{pos}")
            out.append("}")

        for b in m.buckets:
            if b is not None:
                emit_bucket(b.id)
        out.append("")
        out.append("# rules")
        for rno, rule in enumerate(m.rules):
            if rule is None:
                continue
            rname = cw.rule_name_map.get(rno, f"rule-{rno}")
            out.append(f"rule {rname} {{")
            out.append(f"\tid {rno}")
            if rule.ruleset != rno:
                out.append(f"\t# WARNING: ruleset {rule.ruleset} != "
                           f"id {rno}; this will not recompile to the "
                           f"same map")
            out.append(f"\ttype "
                       f"{RULE_TYPE_NAMES.get(rule.type, rule.type)}")
            out.append(f"\tmin_size {rule.min_size}")
            out.append(f"\tmax_size {rule.max_size}")
            for step in rule.steps:
                out.append("\t" + self._step_text(step))
            out.append("}")
        if m.choose_args:
            out.append("")
            out.append("# choose_args")
            for key in sorted(m.choose_args):
                out.append(f"choose_args {key} {{")
                args = m.choose_args[key]
                for bi, arg in enumerate(args):
                    if arg is None or (not arg.ids
                                       and not arg.weight_set):
                        continue
                    out.append("  {")
                    out.append(f"    bucket_id {-1 - bi}")
                    if arg.weight_set:
                        out.append("    weight_set [")
                        for ws in arg.weight_set:
                            # .3f matches the reference's
                            # print_fixedpoint exactly (and shares its
                            # round-trip granularity limit)
                            row = " ".join(f"{w / 0x10000:.3f}"
                                           for w in ws.weights)
                            out.append(f"      [ {row} ]")
                        out.append("    ]")
                    if arg.ids:
                        row = " ".join(str(x) for x in arg.ids)
                        out.append(f"    ids [ {row} ]")
                    out.append("  }")
                out.append("}")
        out.append("")
        out.append("# end crush map")
        return "\n".join(out) + "\n"

    def _step_text(self, step: RuleStep) -> str:
        cw = self.crush
        op = step.op
        if op == CRUSH_RULE_TAKE:
            orig, c = cw.split_id_class(step.arg1)
            if c is not None:
                return (f"step take {cw.name_map.get(orig, orig)} "
                        f"class {cw.class_map[c]}")
            return f"step take {cw.name_map.get(step.arg1, step.arg1)}"
        if op == CRUSH_RULE_EMIT:
            return "step emit"
        if op in STEP_SET_NAMES:
            return f"step {STEP_SET_NAMES[op]} {step.arg1}"
        mode = {
            CRUSH_RULE_CHOOSE_FIRSTN: "choose firstn",
            CRUSH_RULE_CHOOSE_INDEP: "choose indep",
            CRUSH_RULE_CHOOSELEAF_FIRSTN: "chooseleaf firstn",
            CRUSH_RULE_CHOOSELEAF_INDEP: "chooseleaf indep",
        }.get(op)
        if mode is None:
            return f"step op{op} {step.arg1} {step.arg2}"
        tname = cw.type_map.get(step.arg2, f"type{step.arg2}")
        return f"step {mode} {step.arg1} type {tname}"

    # ---- compile -----------------------------------------------------------
    def compile(self, text: str) -> CrushWrapper:
        cw = CrushWrapper()
        cw.type_map = {}
        # "always start with legacy tunables, so that the compiled result
        # of a given crushmap is fixed" (CrushCompiler.cc:1205-1207) —
        # including straw_calc_version=0; tunable lines in the text
        # override from there
        cw.crush.set_tunables_profile("legacy")
        lines = []
        for raw in text.splitlines():
            line = raw.split("#", 1)[0].strip()
            if line:
                lines.append(line)
        i = 0
        pending_buckets: List[dict] = []
        self._pending_choose_args: List = []
        rule_starts: List[int] = []
        max_dev = 0
        while i < len(lines):
            line = lines[i]
            toks = line.split()
            if toks[0] == "tunable":
                setattr(cw.crush, toks[1], int(toks[2]))
                i += 1
            elif toks[0] == "device":
                dev = int(toks[1])
                cw.set_item_name(dev, toks[2])
                max_dev = max(max_dev, dev + 1)
                if len(toks) >= 5 and toks[3] == "class":
                    cw.set_item_class(dev, toks[4])
                i += 1
            elif toks[0] == "type":
                cw.set_type_name(int(toks[1]), toks[2])
                i += 1
            elif toks[0] == "rule":
                # rules reference bucket names: parse after buckets build
                rule_starts.append(i)
                while i < len(lines) and lines[i] != "}":
                    i += 1
                i += 1
            elif toks[0] == "choose_args":
                i = self._parse_choose_args(cw, lines, i)
            elif len(toks) == 3 and toks[2] == "{":
                i = self._parse_bucket(cw, lines, i, pending_buckets)
            else:
                raise ValueError(f"cannot parse line: {line!r}")
        cw.set_max_devices(max_dev)
        self._build_buckets(cw, pending_buckets)
        if cw.item_class:
            # shadow class trees exist from the moment the map is
            # complete (finalize/rebuild_roots_with_classes): rules
            # may 'take X class Y' and the binary carries the shadows.
            # Decompiled maps pin their shadow ids in 'id N class C'
            # lines; honor them so the round-trip keeps ids stable.
            pins = {}
            for spec in pending_buckets:
                for cname, sid in spec.get("class_ids", {}).items():
                    pins[(spec["name"], cname)] = sid
            cw.rebuild_roots_with_classes(pins)
        for start in rule_starts:
            self._parse_rule(cw, lines, start)
        self._install_choose_args(cw)
        self.crush = cw
        return cw

    def _parse_choose_args(self, cw: CrushWrapper, lines: List[str],
                           i: int) -> int:
        """choose_args <key> { { bucket_id N [weight_set [...]]
        [ids [...]] } ... }  (CrushCompiler.cc parse_choose_args)."""
        from .types import ChooseArg, WeightSet
        key = int(lines[i].split()[1])
        i += 1
        entries = []
        while i < len(lines) and lines[i].split()[0] != "}":
            t = lines[i].split()
            if t[0] != "{":
                raise ValueError(f"choose_args: bad line {lines[i]!r}")
            i += 1
            arg = ChooseArg(ids=None, weight_set=None)
            bucket_id = None
            while i < len(lines) and lines[i].split()[0] != "}":
                t = lines[i].split()
                if t[0] == "bucket_id":
                    bucket_id = int(t[1])
                elif t[0] == "ids":
                    arg.ids = [int(x) for x in t[2:-1]]
                elif t[0] == "weight_set":
                    i += 1
                    arg.weight_set = []
                    while i < len(lines) and \
                            lines[i].split()[0] == "[":
                        ws = lines[i].split()[1:-1]
                        arg.weight_set.append(WeightSet(
                            weights=[int(round(float(x) * 0x10000))
                                     for x in ws]))
                        i += 1
                    if i >= len(lines) or lines[i].split()[0] != "]":
                        raise ValueError("choose_args: unterminated "
                                         "weight_set")
                else:
                    raise ValueError(
                        f"choose_args: bad line {lines[i]!r}")
                i += 1
            if bucket_id is None or bucket_id >= 0:
                raise ValueError("choose_args: entry needs a negative "
                                 "bucket_id")
            entries.append((bucket_id, arg))
            i += 1
        # arg maps are positional over max_buckets: installed after the
        # buckets exist (compile() defers to _install_choose_args)
        self._pending_choose_args.append((key, entries))
        return i + 1

    def _install_choose_args(self, cw: CrushWrapper) -> None:
        for key, entries in self._pending_choose_args:
            args = [None] * len(cw.crush.buckets)
            for bucket_id, arg in entries:
                bi = -1 - bucket_id
                if bi >= len(args):
                    raise ValueError(
                        f"choose_args: no bucket {bucket_id}")
                args[bi] = arg
            cw.crush.choose_args[key] = args

    def _parse_bucket(self, cw: CrushWrapper, lines: List[str], i: int,
                      pending: List[dict]) -> int:
        toks = lines[i].split()
        btype, name = toks[0], toks[1]
        if "~" in name:
            # the reference grammar rejects '~' in names — it marks
            # shadow (per-class) buckets, which are never declared
            raise ValueError(f"invalid crush name '{name}'")
        spec = {"type": btype, "name": name, "id": None,
                "alg": "straw2", "items": []}
        i += 1
        while i < len(lines) and lines[i] != "}":
            t = lines[i].split()
            if t[0] == "id":
                if len(t) >= 4 and t[2] == "class":
                    # a decompiled shadow-id pin: 'id -4 class ssd'
                    spec.setdefault("class_ids", {})[t[3]] = int(t[1])
                else:
                    spec["id"] = int(t[1])
            elif t[0] == "alg":
                spec["alg"] = t[1]
            elif t[0] == "hash":
                pass
            elif t[0] == "item":
                w = 0x10000
                if "weight" in t:
                    w = int(round(float(t[t.index("weight") + 1]) * 0x10000))
                spec["items"].append((t[1], w))
            else:
                raise ValueError(f"bucket {name}: bad line {lines[i]!r}")
            i += 1
        pending.append(spec)
        return i + 1

    def _build_buckets(self, cw: CrushWrapper, pending: List[dict]) -> None:
        # leaves first: a bucket can be built once all its items exist
        remaining = list(pending)
        while remaining:
            progressed = False
            for spec in list(remaining):
                try:
                    items = [cw.get_item_id(n) if not n.startswith("osd.")
                             else int(n[4:]) for n, _ in spec["items"]]
                except KeyError:
                    continue
                weights = [w for _, w in spec["items"]]
                tid = cw.get_type_id(spec["type"])
                if tid < 0:
                    raise ValueError(f"unknown type {spec['type']!r}")
                cw.add_bucket(ALG_IDS[spec["alg"]], tid, spec["name"],
                              items, weights,
                              id=spec["id"] if spec["id"] is not None else 0)
                remaining.remove(spec)
                progressed = True
            if not progressed:
                names = [s["name"] for s in remaining]
                raise ValueError(f"unresolvable bucket items in {names}")

    def _parse_rule(self, cw: CrushWrapper, lines: List[str],
                    i: int) -> int:
        toks = lines[i].split()
        name = toks[1]
        self._rule_name = name
        ruleset = -1
        rtype = PG_POOL_TYPE_REPLICATED
        min_size, max_size = 1, 10
        steps: List[RuleStep] = []
        i += 1
        while i < len(lines) and lines[i] != "}":
            t = lines[i].split()
            if t[0] == "ruleset" or t[0] == "id":
                ruleset = int(t[1])
            elif t[0] == "type":
                rtype = RULE_TYPE_IDS.get(t[1], int(t[1])
                                          if t[1].isdigit() else 1)
            elif t[0] == "min_size":
                min_size = int(t[1])
            elif t[0] == "max_size":
                max_size = int(t[1])
            elif t[0] == "step":
                steps.append(self._parse_step(cw, t[1:]))
            else:
                raise ValueError(f"rule {name}: bad line {lines[i]!r}")
            i += 1
        rule = Rule(steps=steps, ruleset=ruleset, type=rtype,
                    min_size=min_size, max_size=max_size)
        try:
            rno = cw.add_rule(rule, name,
                              ruleno=ruleset if ruleset >= 0 else -1)
        except ValueError:
            # the reference's parse_rule diagnostic
            raise ValueError(f"rule {ruleset} already exists") from None
        rule.ruleset = rno if ruleset < 0 else ruleset
        return i + 1

    def _parse_step(self, cw: CrushWrapper, t: List[str]) -> RuleStep:
        if t[0] == "take":
            if t[1].startswith("osd."):
                item = int(t[1][4:])
            else:
                try:
                    item = cw.get_item_id(t[1])
                except KeyError:
                    # the reference's diagnostic, verbatim
                    # (CrushCompiler::parse_step_take)
                    raise ValueError(
                        f"in rule '{self._rule_name}' item "
                        f"'{t[1]}' not defined") from None
            if len(t) >= 4 and t[2] == "class":
                cls = t[3]
                if not cw.class_exists(cls):
                    raise ValueError(
                        f"in rule '{self._rule_name}' class "
                        f"'{cls}' not defined")
                c = cw.get_or_create_class_id(cls)
                shadow = cw.class_bucket.get(item, {}).get(c)
                if shadow is None:
                    raise ValueError(
                        f"in rule '{self._rule_name}' no class "
                        f"'{cls}' tree under '{t[1]}'")
                item = shadow
            return RuleStep(CRUSH_RULE_TAKE, item, 0)
        if t[0] == "emit":
            return RuleStep(CRUSH_RULE_EMIT, 0, 0)
        if t[0] in STEP_SET_OPS:
            return RuleStep(STEP_SET_OPS[t[0]], int(t[1]), 0)
        if t[0] in ("choose", "chooseleaf"):
            mode = t[1]  # firstn | indep
            n = int(t[2])
            assert t[3] == "type"
            tid = cw.get_type_id(t[4])
            if tid < 0:
                raise ValueError(f"unknown type {t[4]!r}")
            op = {
                ("choose", "firstn"): CRUSH_RULE_CHOOSE_FIRSTN,
                ("choose", "indep"): CRUSH_RULE_CHOOSE_INDEP,
                ("chooseleaf", "firstn"): CRUSH_RULE_CHOOSELEAF_FIRSTN,
                ("chooseleaf", "indep"): CRUSH_RULE_CHOOSELEAF_INDEP,
            }[(t[0], mode)]
            return RuleStep(op, n, tid)
        raise ValueError(f"unknown step {' '.join(t)!r}")
