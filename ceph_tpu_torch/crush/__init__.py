"""CRUSH placement of the port: the data model, the exact host
interpreter (``crush_do_rule``), ``CrushWrapper`` and (``tester``)
``CrushTester``; the mappers on the card are ``ops/crush_fast.py`` and
``ops/crush_kernels.py``."""
from .constants import *  # noqa: F401,F403
from .types import (  # noqa: F401
    Bucket, UniformBucket, ListBucket, TreeBucket, StrawBucket, Straw2Bucket,
    Rule, RuleStep, CrushMap, ChooseArg, WeightSet,
)
from .mapper import crush_do_rule, crush_find_rule  # noqa: F401
from .wrapper import CrushWrapper  # noqa: F401
from . import builder  # noqa: F401
