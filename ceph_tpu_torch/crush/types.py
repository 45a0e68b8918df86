"""CRUSH rules: a rule is a short program of steps (src/crush/crush.h
:52-70).  Own copy of the ``Rule``/``RuleStep`` part of
``ceph_tpu/crush/types.py``; buckets and the map come with the CRUSH
slice of the port."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List


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
