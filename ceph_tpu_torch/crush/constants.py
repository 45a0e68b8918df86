"""CRUSH constants — opcodes, bucket algorithms, tunable profiles.

Values match the reference data model (src/crush/crush.h) because crush maps
and their evaluation semantics are defined in terms of them.
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
CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES = 10
CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES = 11
CRUSH_RULE_SET_CHOOSELEAF_VARY_R = 12
CRUSH_RULE_SET_CHOOSELEAF_STABLE = 13

# bucket algorithms (crush.h crush_algorithm)
CRUSH_BUCKET_UNIFORM = 1
CRUSH_BUCKET_LIST = 2
CRUSH_BUCKET_TREE = 3
CRUSH_BUCKET_STRAW = 4
CRUSH_BUCKET_STRAW2 = 5

CRUSH_HASH_RJENKINS1 = 0

# sentinel outputs (crush.h)
CRUSH_ITEM_UNDEF = 0x7FFFFFFE  # choose_indep: placeholder pre-assignment
CRUSH_ITEM_NONE = 0x7FFFFFFF   # no result

CRUSH_MAX_DEPTH = 10
CRUSH_MAX_RULESET = 256

# pool/rule types (osd_types pg_pool_t)
PG_POOL_TYPE_REPLICATED = 1
PG_POOL_TYPE_ERASURE = 3

ALL_BUCKET_ALGS = ((1 << CRUSH_BUCKET_UNIFORM) | (1 << CRUSH_BUCKET_LIST) |
                   (1 << CRUSH_BUCKET_TREE) | (1 << CRUSH_BUCKET_STRAW) |
                   (1 << CRUSH_BUCKET_STRAW2))
LEGACY_ALLOWED_BUCKET_ALGS = ((1 << CRUSH_BUCKET_UNIFORM) |
                              (1 << CRUSH_BUCKET_LIST) |
                              (1 << CRUSH_BUCKET_STRAW))
HAMMER_ALLOWED_BUCKET_ALGS = ((1 << CRUSH_BUCKET_UNIFORM) |
                              (1 << CRUSH_BUCKET_LIST) |
                              (1 << CRUSH_BUCKET_STRAW) |
                              (1 << CRUSH_BUCKET_STRAW2))

# tunable profiles (CrushWrapper.h:140-212)
TUNABLE_PROFILES = {
    "argonaut": dict(choose_local_tries=2, choose_local_fallback_tries=5,
                     choose_total_tries=19, chooseleaf_descend_once=0,
                     chooseleaf_vary_r=0, chooseleaf_stable=0,
                     allowed_bucket_algs=LEGACY_ALLOWED_BUCKET_ALGS),
    "bobtail": dict(choose_local_tries=0, choose_local_fallback_tries=0,
                    choose_total_tries=50, chooseleaf_descend_once=1,
                    chooseleaf_vary_r=0, chooseleaf_stable=0,
                    allowed_bucket_algs=LEGACY_ALLOWED_BUCKET_ALGS),
    "firefly": dict(choose_local_tries=0, choose_local_fallback_tries=0,
                    choose_total_tries=50, chooseleaf_descend_once=1,
                    chooseleaf_vary_r=1, chooseleaf_stable=0,
                    allowed_bucket_algs=LEGACY_ALLOWED_BUCKET_ALGS),
    "hammer": dict(choose_local_tries=0, choose_local_fallback_tries=0,
                   choose_total_tries=50, chooseleaf_descend_once=1,
                   chooseleaf_vary_r=1, chooseleaf_stable=0,
                   allowed_bucket_algs=HAMMER_ALLOWED_BUCKET_ALGS),
    "jewel": dict(choose_local_tries=0, choose_local_fallback_tries=0,
                  choose_total_tries=50, chooseleaf_descend_once=1,
                  chooseleaf_vary_r=1, chooseleaf_stable=1,
                  allowed_bucket_algs=HAMMER_ALLOWED_BUCKET_ALGS),
}
TUNABLE_PROFILES["optimal"] = TUNABLE_PROFILES["jewel"]
TUNABLE_PROFILES["default"] = TUNABLE_PROFILES["jewel"]
TUNABLE_PROFILES["legacy"] = TUNABLE_PROFILES["argonaut"]

S64_MIN = -(1 << 63)
