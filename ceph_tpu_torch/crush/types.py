"""CRUSH data model: buckets, rules, tunables, the map.

Structure mirrors the reference's (src/crush/crush.h) because crush maps are
defined by it: buckets are uniform/list/tree/straw/straw2 (:123-191) holding
16.16 fixed-point weights; rules are short step programs (:52-70); tunables
gate retry semantics (:354-461); choose_args supply per-position replacement
weights for straw2 (:273, the upmap balancer's lever).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .constants import (
    CRUSH_BUCKET_UNIFORM, CRUSH_BUCKET_LIST, CRUSH_BUCKET_TREE,
    CRUSH_BUCKET_STRAW, CRUSH_BUCKET_STRAW2, CRUSH_HASH_RJENKINS1,
    TUNABLE_PROFILES,
)


@dataclass
class Bucket:
    id: int                      # negative, unique
    type: int                    # user-defined type (host/rack/root/...)
    alg: int
    items: List[int] = field(default_factory=list)
    weight: int = 0              # 16.16 cumulative
    hash: int = CRUSH_HASH_RJENKINS1

    @property
    def size(self) -> int:
        return len(self.items)


@dataclass
class UniformBucket(Bucket):
    alg: int = CRUSH_BUCKET_UNIFORM
    item_weight: int = 0x10000


@dataclass
class ListBucket(Bucket):
    alg: int = CRUSH_BUCKET_LIST
    item_weights: List[int] = field(default_factory=list)
    sum_weights: List[int] = field(default_factory=list)  # cumulative [0..i]


@dataclass
class TreeBucket(Bucket):
    alg: int = CRUSH_BUCKET_TREE
    num_nodes: int = 0
    node_weights: List[int] = field(default_factory=list)


@dataclass
class StrawBucket(Bucket):
    alg: int = CRUSH_BUCKET_STRAW
    item_weights: List[int] = field(default_factory=list)
    straws: List[int] = field(default_factory=list)  # 16.16 scalers


@dataclass
class Straw2Bucket(Bucket):
    alg: int = CRUSH_BUCKET_STRAW2
    item_weights: List[int] = field(default_factory=list)


@dataclass
class RuleStep:
    op: int
    arg1: int = 0
    arg2: int = 0


@dataclass
class Rule:
    steps: List[RuleStep]
    ruleset: int = 0
    type: int = 1                # pool type mask
    min_size: int = 1
    max_size: int = 10


@dataclass
class WeightSet:
    weights: List[int]           # 16.16, one per bucket item


@dataclass
class ChooseArg:
    """Per-bucket straw2 replacements (crush.h crush_choose_arg)."""
    ids: Optional[List[int]] = None
    weight_set: Optional[List[WeightSet]] = None  # indexed by position


class CrushMap:
    """The placement map: buckets + rules + tunables (+ choose_args)."""

    def __init__(self):
        self.buckets: List[Optional[Bucket]] = []   # index b holds id -1-b
        self.rules: List[Optional[Rule]] = []
        self.max_devices = 0
        # tunables: default profile == jewel/optimal (CrushWrapper.h:208)
        for k, v in TUNABLE_PROFILES["default"].items():
            setattr(self, k, v)
        self.straw_calc_version = 1
        # choose_args sets keyed by an id (OSDMap stores them per map)
        self.choose_args: Dict[int, List[ChooseArg]] = {}

    # -- buckets ------------------------------------------------------------
    @property
    def max_buckets(self) -> int:
        return len(self.buckets)

    def bucket(self, item_id: int) -> Optional[Bucket]:
        bno = -1 - item_id
        if 0 <= bno < len(self.buckets):
            return self.buckets[bno]
        return None

    def add_bucket(self, bucket: Bucket, id: Optional[int] = None) -> int:
        if id is not None:
            bucket.id = id
        if bucket.id == 0:  # allocate lowest free
            bno = next((i for i, b in enumerate(self.buckets) if b is None),
                       len(self.buckets))
            bucket.id = -1 - bno
        bno = -1 - bucket.id
        while len(self.buckets) <= bno:
            self.buckets.append(None)
        if self.buckets[bno] is not None:
            raise ValueError(f"bucket id {bucket.id} already in use")
        self.buckets[bno] = bucket
        return bucket.id

    def set_tunables_profile(self, profile: str) -> None:
        for k, v in TUNABLE_PROFILES[profile].items():
            setattr(self, k, v)
        self.straw_calc_version = 0 if profile == "legacy" else 1

    # -- rules --------------------------------------------------------------
    def add_rule(self, rule: Rule, ruleno: int = -1) -> int:
        if ruleno < 0:
            ruleno = next((i for i, r in enumerate(self.rules) if r is None),
                          len(self.rules))
        while len(self.rules) <= ruleno:
            self.rules.append(None)
        if self.rules[ruleno] is not None:
            raise ValueError(f"rule {ruleno} already in use")
        self.rules[ruleno] = rule
        return ruleno

    @property
    def max_rules(self) -> int:
        return len(self.rules)
