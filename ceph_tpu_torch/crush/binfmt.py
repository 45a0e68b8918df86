"""Binary crushmap codec — the reference's on-disk/wire map format.

Implements CrushWrapper::encode/decode (src/crush/CrushWrapper.cc:2160,
:2335) byte-compatibly: magic 0x00010000, per-slot buckets with per-alg
payloads, rules (4-byte mask + 12-byte steps), the three name maps
(tolerating the historical 32-or-64-bit key encoding on decode), the
progressively-appended tunables tail, and the luminous section (device
classes + choose_args).  This is what lets our crushtool consume binary
maps produced by the reference crushtool (the src/test/cli/crushtool
fixtures decode directly) and emit maps the reference could read back.

The port's own copy of ``ceph_tpu/crush/binfmt.py``: a map encoded by
either package decodes in the other into the same ``CrushMap`` and
re-encodes to the same bytes.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional

from .constants import (
    CRUSH_BUCKET_LIST, CRUSH_BUCKET_STRAW, CRUSH_BUCKET_STRAW2,
    CRUSH_BUCKET_TREE, CRUSH_BUCKET_UNIFORM,
)
from .types import (
    ChooseArg, CrushMap, ListBucket, Rule, RuleStep, StrawBucket,
    Straw2Bucket, TreeBucket, UniformBucket, WeightSet,
)
from .wrapper import CrushWrapper

CRUSH_MAGIC = 0x00010000


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def _unpack(self, fmt: str):
        v = struct.unpack_from(fmt, self.buf, self.pos)[0]
        self.pos += struct.calcsize(fmt)
        return v

    def u8(self): return self._unpack("<B")
    def u16(self): return self._unpack("<H")
    def u32(self): return self._unpack("<I")
    def s32(self): return self._unpack("<i")
    def s64(self): return self._unpack("<q")

    def raw(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            # the reference decoder throws buffer::end_of_buffer here —
            # a silently truncated read would fall back to legacy
            # tunables and produce wrong placements from a corrupt file
            raise ValueError(
                f"truncated crushmap: need {n} bytes at {self.pos}, "
                f"have {len(self.buf) - self.pos}")
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b

    def end(self) -> bool:
        return self.pos >= len(self.buf)

    def str_map(self) -> Dict[int, str]:
        """decode_32_or_64_string_map: keys may be 32 OR 64 bits (an old
        encoding bug); a zero 'strlen' means the key was 64-bit and the
        real length follows (strings are never empty)."""
        out: Dict[int, str] = {}
        n = self.u32()
        for _ in range(n):
            key = self.s32()
            strlen = self.u32()
            if strlen == 0:
                strlen = self.u32()
            out[key] = self.raw(strlen).decode()
        return out

    def s32_map(self) -> Dict[int, int]:
        n = self.u32()
        return {self.s32(): self.s32() for _ in range(n)}


class _Writer:
    def __init__(self):
        self.parts: List[bytes] = []

    def _pack(self, fmt: str, v) -> None:
        self.parts.append(struct.pack(fmt, v))

    def u8(self, v): self._pack("<B", v)
    def u16(self, v): self._pack("<H", v)
    def u32(self, v): self._pack("<I", v & 0xFFFFFFFF)
    def s32(self, v): self._pack("<i", v)
    def s64(self, v): self._pack("<q", v)

    def raw(self, b: bytes) -> None:
        self.parts.append(b)

    def str_map(self, m: Dict[int, str]) -> None:
        self.u32(len(m))
        for k in sorted(m):
            self.s32(k)
            b = m[k].encode()
            if not b:
                # strlen=0 is the decoder's 64-bit-key marker (the
                # historical encoding bug tolerance); the format cannot
                # represent empty names
                raise ValueError(f"empty name for id {k} is not "
                                 "representable in the crushmap format")
            self.u32(len(b))
            self.raw(b)

    def s32_map(self, m: Dict[int, int]) -> None:
        self.u32(len(m))
        for k in sorted(m):
            self.s32(k)
            self.s32(m[k])

    def getvalue(self) -> bytes:
        return b"".join(self.parts)


def decode_crushmap(data: bytes) -> CrushWrapper:
    r = _Reader(data)
    if r.u32() != CRUSH_MAGIC:
        raise ValueError("bad crush magic")
    cw = CrushWrapper()
    m = cw.crush
    max_buckets = r.s32()
    max_rules = r.u32()
    m.max_devices = r.s32()
    # re-encode exactly what was stored (round-trip byte identity),
    # whatever slot-count policy the producer used
    m.exact_bucket_slots = True
    # "legacy tunables, unless we decode something newer"
    m.set_tunables_profile("legacy")

    m.buckets = []
    for _ in range(max_buckets):
        alg = r.u32()
        if alg == 0:
            m.buckets.append(None)
            continue
        bid = r.s32()
        btype = r.u16()
        alg2 = r.u8()
        bhash = r.u8()
        weight = r.u32()
        size = r.u32()
        items = [r.s32() for _ in range(size)]
        common = dict(id=bid, type=btype, alg=alg2, items=items,
                      weight=weight, hash=bhash)
        if alg2 == CRUSH_BUCKET_UNIFORM:
            b = UniformBucket(**common)
            b.item_weight = r.u32()
        elif alg2 == CRUSH_BUCKET_LIST:
            b = ListBucket(**common)
            for _j in range(size):
                b.item_weights.append(r.u32())
                b.sum_weights.append(r.u32())
        elif alg2 == CRUSH_BUCKET_TREE:
            b = TreeBucket(**common)
            b.num_nodes = r.u8()
            b.node_weights = [r.u32() for _j in range(b.num_nodes)]
        elif alg2 == CRUSH_BUCKET_STRAW:
            b = StrawBucket(**common)
            for _j in range(size):
                b.item_weights.append(r.u32())
                b.straws.append(r.u32())
        elif alg2 == CRUSH_BUCKET_STRAW2:
            b = Straw2Bucket(**common)
            b.item_weights = [r.u32() for _j in range(size)]
        else:
            raise ValueError(f"unknown bucket alg {alg2}")
        m.buckets.append(b)

    m.rules = []
    for _ in range(max_rules):
        if r.u32() == 0:
            m.rules.append(None)
            continue
        length = r.u32()
        ruleset, rtype, min_size, max_size = (r.u8(), r.u8(), r.u8(),
                                              r.u8())
        steps = [RuleStep(r.u32(), r.s32(), r.s32())
                 for _j in range(length)]
        m.rules.append(Rule(steps=steps, ruleset=ruleset, type=rtype,
                            min_size=min_size, max_size=max_size))

    cw.type_map = r.str_map()
    cw.name_map = r.str_map()
    cw.rule_name_map = r.str_map()

    # tunables tail (progressively appended across versions)
    if not r.end():
        m.choose_local_tries = r.u32()
        m.choose_local_fallback_tries = r.u32()
        m.choose_total_tries = r.u32()
    if not r.end():
        m.chooseleaf_descend_once = r.u32()
    if not r.end():
        m.chooseleaf_vary_r = r.u8()
    if not r.end():
        m.straw_calc_version = r.u8()
    if not r.end():
        m.allowed_bucket_algs = r.u32()
    if not r.end():
        m.chooseleaf_stable = r.u8()
    if not r.end():
        # luminous: device classes
        cw.item_class = r.s32_map()
        cw.class_map = r.str_map()
        n = r.u32()
        cw.class_bucket = {}
        for _ in range(n):
            root = r.s32()
            cw.class_bucket[root] = r.s32_map()
    if not r.end():
        # choose_args
        n_maps = r.u32()
        for _ in range(n_maps):
            key = r.s64()
            args: List[Optional[ChooseArg]] = [None] * max_buckets
            n_args = r.u32()
            for _j in range(n_args):
                bi = r.u32()
                arg = ChooseArg(ids=None, weight_set=None)
                ws_size = r.u32()
                if ws_size:
                    arg.weight_set = []
                    for _k in range(ws_size):
                        sz = r.u32()
                        arg.weight_set.append(WeightSet(
                            weights=[r.u32() for _l in range(sz)]))
                ids_size = r.u32()
                if ids_size:
                    arg.ids = [r.s32() for _k in range(ids_size)]
                args[bi] = arg
            m.choose_args[key] = args
    return cw


def encode_crushmap(cw: CrushWrapper) -> bytes:
    m = cw.crush
    w = _Writer()
    w.u32(CRUSH_MAGIC)
    # max_buckets carries the builder's allocation high-water: the
    # bucket array starts at 8 slots and doubles (builder.c
    # crush_add_bucket:150-156), so a reference-built 3-bucket map
    # stores 5 empty slots.  Stored maps already carry this padding
    # (decode preserves the None slots); maps built in-memory pad
    # here so our encodings are byte-identical to the reference's.
    slots = len(m.buckets)
    if slots and not getattr(m, "exact_bucket_slots", False):
        # decoded maps re-encode their stored slot count verbatim
        # (exact_bucket_slots); only in-memory-built maps pad here
        policy = 8
        while policy < slots:
            policy *= 2
        slots = max(slots, policy)
    w.s32(slots)
    w.u32(len(m.rules))
    w.s32(m.max_devices)

    for b in list(m.buckets) + [None] * (slots - len(m.buckets)):
        if b is None:
            w.u32(0)
            continue
        w.u32(b.alg)
        w.s32(b.id)
        w.u16(b.type)
        w.u8(b.alg)
        w.u8(b.hash)
        w.u32(b.weight)
        w.u32(b.size)
        for it in b.items:
            w.s32(it)
        if b.alg == CRUSH_BUCKET_UNIFORM:
            w.u32(b.item_weight)
        elif b.alg == CRUSH_BUCKET_LIST:
            for iw, sw in zip(b.item_weights, b.sum_weights):
                w.u32(iw)
                w.u32(sw)
        elif b.alg == CRUSH_BUCKET_TREE:
            w.u8(b.num_nodes)
            for nw in b.node_weights:
                w.u32(nw)
        elif b.alg == CRUSH_BUCKET_STRAW:
            for iw, st in zip(b.item_weights, b.straws):
                w.u32(iw)
                w.u32(st)
        elif b.alg == CRUSH_BUCKET_STRAW2:
            for iw in b.item_weights:
                w.u32(iw)
        else:
            raise ValueError(f"bucket alg {b.alg}")

    for rule in m.rules:
        if rule is None:
            w.u32(0)
            continue
        w.u32(1)
        w.u32(len(rule.steps))
        w.u8(rule.ruleset)
        w.u8(rule.type)
        w.u8(rule.min_size)
        w.u8(rule.max_size)
        for s in rule.steps:
            w.u32(s.op)
            w.s32(s.arg1)
            w.s32(s.arg2)

    w.str_map(cw.type_map)
    w.str_map(cw.name_map)
    w.str_map(cw.rule_name_map)

    w.u32(m.choose_local_tries)
    w.u32(m.choose_local_fallback_tries)
    w.u32(m.choose_total_tries)
    w.u32(m.chooseleaf_descend_once)
    w.u8(m.chooseleaf_vary_r)
    w.u8(m.straw_calc_version)
    w.u32(m.allowed_bucket_algs)
    w.u8(m.chooseleaf_stable)

    # luminous: device classes
    w.s32_map(cw.item_class)
    w.str_map(cw.class_map)
    w.u32(len(cw.class_bucket))
    for root in sorted(cw.class_bucket):
        w.s32(root)
        w.s32_map(cw.class_bucket[root])

    # choose_args
    w.u32(len(m.choose_args))
    for key in sorted(m.choose_args):
        w.s64(key)
        args = m.choose_args[key]
        present = [(i, a) for i, a in enumerate(args)
                   if a is not None and (a.weight_set or a.ids)]
        w.u32(len(present))
        for i, a in present:
            w.u32(i)
            w.u32(len(a.weight_set) if a.weight_set else 0)
            for ws in a.weight_set or []:
                w.u32(len(ws.weights))
                for wt in ws.weights:
                    w.u32(wt)
            w.u32(len(a.ids) if a.ids else 0)
            for i2 in a.ids or []:
                w.s32(i2)
    return w.getvalue()
