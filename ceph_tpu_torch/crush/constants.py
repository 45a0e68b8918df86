"""CRUSH constants: rule opcodes and pool types.

Own copy of the part of ``ceph_tpu/crush/constants.py`` that lrc's rule
steps need; values match the reference data model (src/crush/crush.h),
because crush maps and their evaluation are defined in terms of them.
"""

# rule opcodes (crush.h:52-70)
CRUSH_RULE_NOOP = 0
CRUSH_RULE_TAKE = 1
CRUSH_RULE_CHOOSE_FIRSTN = 2
CRUSH_RULE_CHOOSE_INDEP = 3
CRUSH_RULE_EMIT = 4
CRUSH_RULE_CHOOSELEAF_FIRSTN = 6
CRUSH_RULE_CHOOSELEAF_INDEP = 7
CRUSH_RULE_SET_CHOOSE_TRIES = 8
CRUSH_RULE_SET_CHOOSELEAF_TRIES = 9

# pool/rule types (osd_types pg_pool_t)
PG_POOL_TYPE_REPLICATED = 1
PG_POOL_TYPE_ERASURE = 3
