"""CRUSH placement of the port: the data model, the exact host
interpreter (``crush_do_rule``) and ``CrushWrapper``; the candidate-table
mapper on the card is ``ops/crush_fast.py``."""
from .constants import *  # noqa: F401,F403
from .types import (  # noqa: F401
    Bucket, UniformBucket, ListBucket, TreeBucket, StrawBucket, Straw2Bucket,
    Rule, RuleStep, CrushMap, ChooseArg, WeightSet,
)
from .mapper import crush_do_rule, crush_find_rule  # noqa: F401
from .wrapper import CrushWrapper  # noqa: F401
from . import builder  # noqa: F401
