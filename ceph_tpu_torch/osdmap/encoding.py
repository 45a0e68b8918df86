"""Structured encode/decode for the cluster-map types.

The reference gives every map type a versioned encode/decode pair
(include/encoding.h; OSDMap::encode, CrushWrapper::encode) so maps can be
persisted in the mon store and shipped on the wire.  Here the same role is
filled by explicit dict codecs (JSON-serializable, debuggable like
`osdmaptool --dump json`) for CrushWrapper, pg_pool_t, OSDMap and
Incremental — used by the durability layer (mon store files, OSD
superblocks) and the cross-process messenger's wire format.

The port's own copy of ``ceph_tpu/osdmap/encoding.py``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from ..crush.constants import (
    CRUSH_BUCKET_LIST, CRUSH_BUCKET_STRAW, CRUSH_BUCKET_STRAW2,
    CRUSH_BUCKET_TREE, CRUSH_BUCKET_UNIFORM, TUNABLE_PROFILES,
)
from ..crush.types import (
    Bucket, ChooseArg, CrushMap, ListBucket, Rule, RuleStep, StrawBucket,
    Straw2Bucket, TreeBucket, UniformBucket, WeightSet,
)
from ..crush.wrapper import CrushWrapper
from .types import pg_pool_t, pg_t

_TUNABLE_KEYS = sorted(TUNABLE_PROFILES["default"])

_BUCKET_CLS = {
    CRUSH_BUCKET_UNIFORM: UniformBucket,
    CRUSH_BUCKET_LIST: ListBucket,
    CRUSH_BUCKET_TREE: TreeBucket,
    CRUSH_BUCKET_STRAW: StrawBucket,
    CRUSH_BUCKET_STRAW2: Straw2Bucket,
}


# ---- crush -----------------------------------------------------------------

def bucket_to_dict(b: Optional[Bucket]) -> Optional[Dict[str, Any]]:
    if b is None:
        return None
    d: Dict[str, Any] = {"id": b.id, "type": b.type, "alg": b.alg,
                         "items": list(b.items), "weight": b.weight,
                         "hash": b.hash}
    if isinstance(b, UniformBucket):
        d["item_weight"] = b.item_weight
    elif isinstance(b, ListBucket):
        d["item_weights"] = list(b.item_weights)
        d["sum_weights"] = list(b.sum_weights)
    elif isinstance(b, TreeBucket):
        d["num_nodes"] = b.num_nodes
        d["node_weights"] = list(b.node_weights)
    elif isinstance(b, StrawBucket):
        d["item_weights"] = list(b.item_weights)
        d["straws"] = list(b.straws)
    elif isinstance(b, Straw2Bucket):
        d["item_weights"] = list(b.item_weights)
    return d


def bucket_from_dict(d: Optional[Dict[str, Any]]) -> Optional[Bucket]:
    if d is None:
        return None
    cls = _BUCKET_CLS[d["alg"]]
    b = cls(id=d["id"], type=d["type"], alg=d["alg"],
            items=list(d["items"]), weight=d["weight"], hash=d["hash"])
    for k in ("item_weight", "num_nodes"):
        if k in d:
            setattr(b, k, d[k])
    for k in ("item_weights", "sum_weights", "node_weights", "straws"):
        if k in d:
            setattr(b, k, list(d[k]))
    return b


def crushmap_to_dict(m: CrushMap) -> Dict[str, Any]:
    return {
        "buckets": [bucket_to_dict(b) for b in m.buckets],
        "rules": [None if r is None else {
            "ruleset": r.ruleset, "type": r.type, "min_size": r.min_size,
            "max_size": r.max_size,
            "steps": [[s.op, s.arg1, s.arg2] for s in r.steps],
        } for r in m.rules],
        "max_devices": m.max_devices,
        "tunables": {k: getattr(m, k) for k in _TUNABLE_KEYS},
        "straw_calc_version": m.straw_calc_version,
        "choose_args": {
            str(key): [None if a is None else {
                "ids": list(a.ids) if a.ids else None,
                "weight_set": None if a.weight_set is None else
                [list(ws.weights) for ws in a.weight_set],
            } for a in args]
            for key, args in m.choose_args.items()},
    }


def crushmap_from_dict(d: Dict[str, Any]) -> CrushMap:
    m = CrushMap()
    m.buckets = [bucket_from_dict(b) for b in d["buckets"]]
    m.rules = [None if r is None else Rule(
        steps=[RuleStep(*s) for s in r["steps"]], ruleset=r["ruleset"],
        type=r["type"], min_size=r["min_size"], max_size=r["max_size"])
        for r in d["rules"]]
    m.max_devices = d["max_devices"]
    for k, v in d["tunables"].items():
        setattr(m, k, v)
    m.straw_calc_version = d["straw_calc_version"]
    m.choose_args = {
        int(key): [None if a is None else ChooseArg(
            ids=list(a["ids"]) if a["ids"] else None,
            weight_set=None if a["weight_set"] is None else
            [WeightSet(weights=list(w)) for w in a["weight_set"]])
            for a in args]
        for key, args in d["choose_args"].items()}
    return m


def crush_to_dict(cw: CrushWrapper) -> Dict[str, Any]:
    return {
        "map": crushmap_to_dict(cw.crush),
        "type_map": {str(k): v for k, v in cw.type_map.items()},
        "name_map": {str(k): v for k, v in cw.name_map.items()},
        "rule_name_map": {str(k): v for k, v in cw.rule_name_map.items()},
        "class_map": {str(k): v for k, v in cw.class_map.items()},
        "item_class": {str(k): v for k, v in cw.item_class.items()},
        "class_bucket": {str(r): {str(c): b for c, b in cb.items()}
                         for r, cb in cw.class_bucket.items()},
    }


def crush_from_dict(d: Dict[str, Any]) -> CrushWrapper:
    cw = CrushWrapper()
    cw.crush = crushmap_from_dict(d["map"])
    cw.type_map = {int(k): v for k, v in d["type_map"].items()}
    cw.name_map = {int(k): v for k, v in d["name_map"].items()}
    cw.rule_name_map = {int(k): v for k, v in d["rule_name_map"].items()}
    cw.class_map = {int(k): v for k, v in d["class_map"].items()}
    cw.item_class = {int(k): v for k, v in d["item_class"].items()}
    cw.class_bucket = {int(r): {int(c): b for c, b in cb.items()}
                       for r, cb in d["class_bucket"].items()}
    return cw


# ---- pools / osdmap --------------------------------------------------------

_POOL_FIELDS = ("type", "size", "min_size", "crush_rule", "object_hash",
                "pg_num", "pgp_num", "flags", "last_change",
                "erasure_code_profile", "stripe_width")
# tiering fields ride with defaults so old checkpoints keep decoding
_POOL_TIER_FIELDS = ("tier_of", "read_tier", "write_tier", "cache_mode",
                     "hit_set_period", "hit_set_count",
                     "target_max_objects")


def pool_to_dict(p: pg_pool_t) -> Dict[str, Any]:
    d = {k: getattr(p, k) for k in _POOL_FIELDS}
    for k in _POOL_TIER_FIELDS:
        d[k] = getattr(p, k)
    d["snap_seq"] = p.snap_seq
    d["snaps"] = {str(k): v for k, v in p.snaps.items()}
    d["removed_snaps"] = list(p.removed_snaps)
    if p.selfmanaged:
        d["selfmanaged"] = True
    if p.quota_max_objects or p.quota_max_bytes:
        d["quota_max_objects"] = p.quota_max_objects
        d["quota_max_bytes"] = p.quota_max_bytes
    d["flags_versioned"] = True   # marks flags as post-ec_overwrites-gate
    return d


def pool_from_dict(d: Dict[str, Any]) -> pg_pool_t:
    p = pg_pool_t(**{k: d[k] for k in _POOL_FIELDS})
    for k in _POOL_TIER_FIELDS:
        if k in d:
            setattr(p, k, d[k])
    p.snap_seq = int(d.get("snap_seq", 0))
    p.snaps = {int(k): v for k, v in d.get("snaps", {}).items()}
    p.removed_snaps = [int(x) for x in d.get("removed_snaps", [])]
    p.selfmanaged = bool(d.get("selfmanaged", False))
    p.quota_max_objects = int(d.get("quota_max_objects", 0))
    p.quota_max_bytes = int(d.get("quota_max_bytes", 0))
    if p.is_erasure() and not d.get("flags_versioned"):
        # checkpoints written before the overwrites gate existed always
        # allowed rmw; restoring them must not break their workloads
        from .types import FLAG_EC_OVERWRITES
        p.flags |= FLAG_EC_OVERWRITES
    return p


def _pgid_key(pg: pg_t) -> str:
    return f"{pg.pool}.{pg.ps}"


def _pgid_from_key(s: str) -> pg_t:
    pool, ps = s.split(".")
    return pg_t(int(pool), int(ps))


def osdmap_to_dict(m) -> Dict[str, Any]:
    return {
        "epoch": m.epoch,
        "flags": m.flags,
        "max_osd": m.max_osd,
        "osd_state": list(m.osd_state),
        "osd_weight": list(m.osd_weight),
        "osd_primary_affinity": None if m.osd_primary_affinity is None
        else list(m.osd_primary_affinity),
        "pools": {str(k): pool_to_dict(p) for k, p in m.pools.items()},
        "pool_name": {str(k): v for k, v in m.pool_name.items()},
        "pool_max": m.pool_max,
        "pg_upmap": {_pgid_key(k): list(v) for k, v in m.pg_upmap.items()},
        "pg_upmap_items": {_pgid_key(k): [list(t) for t in v]
                           for k, v in m.pg_upmap_items.items()},
        "pg_temp": {_pgid_key(k): list(v) for k, v in m.pg_temp.items()},
        "primary_temp": {_pgid_key(k): v
                         for k, v in m.primary_temp.items()},
        "osd_old_weight": {str(k): v
                           for k, v in m.osd_old_weight.items()},
        "erasure_code_profiles": {k: dict(v) for k, v in
                                  m.erasure_code_profiles.items()},
        "crush": crush_to_dict(m.crush),
    }


def osdmap_from_dict(d: Dict[str, Any]):
    from .osdmap import OSDMap
    m = OSDMap()
    m.epoch = d["epoch"]
    m.flags = int(d.get("flags", 0))
    m.max_osd = d["max_osd"]
    m.osd_state = list(d["osd_state"])
    m.osd_weight = list(d["osd_weight"])
    m.osd_primary_affinity = None if d["osd_primary_affinity"] is None \
        else list(d["osd_primary_affinity"])
    m.pools = {int(k): pool_from_dict(p) for k, p in d["pools"].items()}
    m.pool_name = {int(k): v for k, v in d["pool_name"].items()}
    m.pool_max = d["pool_max"]
    m.pg_upmap = {_pgid_from_key(k): list(v)
                  for k, v in d["pg_upmap"].items()}
    m.pg_upmap_items = {_pgid_from_key(k): [tuple(t) for t in v]
                        for k, v in d["pg_upmap_items"].items()}
    m.pg_temp = {_pgid_from_key(k): list(v)
                 for k, v in d["pg_temp"].items()}
    m.primary_temp = {_pgid_from_key(k): v
                      for k, v in d["primary_temp"].items()}
    m.osd_old_weight = {int(k): v for k, v in
                        d.get("osd_old_weight", {}).items()}
    m.erasure_code_profiles = {k: dict(v) for k, v in
                               d["erasure_code_profiles"].items()}
    m.crush = crush_from_dict(d["crush"])
    return m


def incremental_to_dict(inc) -> Dict[str, Any]:
    return {
        "epoch": inc.epoch,
        "new_max_osd": inc.new_max_osd,
        "new_pools": {str(k): pool_to_dict(p)
                      for k, p in inc.new_pools.items()},
        "new_pool_names": {str(k): v
                           for k, v in inc.new_pool_names.items()},
        "old_pools": list(inc.old_pools),
        "new_up": {str(k): v for k, v in inc.new_up.items()},
        "new_weight": {str(k): v for k, v in inc.new_weight.items()},
        "new_old_weight": {str(k): v
                           for k, v in inc.new_old_weight.items()},
        "new_primary_affinity": {str(k): v for k, v in
                                 inc.new_primary_affinity.items()},
        "new_pg_upmap": {_pgid_key(k): list(v)
                         for k, v in inc.new_pg_upmap.items()},
        "old_pg_upmap": [_pgid_key(k) for k in inc.old_pg_upmap],
        "new_pg_upmap_items": {_pgid_key(k): [list(t) for t in v]
                               for k, v in inc.new_pg_upmap_items.items()},
        "old_pg_upmap_items": [_pgid_key(k)
                               for k in inc.old_pg_upmap_items],
        "new_pg_temp": {_pgid_key(k): list(v)
                        for k, v in inc.new_pg_temp.items()},
        "new_primary_temp": {_pgid_key(k): v
                             for k, v in inc.new_primary_temp.items()},
        "new_erasure_code_profiles": {
            k: dict(v) for k, v in inc.new_erasure_code_profiles.items()},
        "crush": None if inc.crush is None else crush_to_dict(inc.crush),
        "service_log": [list(e) for e in inc.service_log],
        "service_config_kv": dict(inc.service_config_kv),
    }


def incremental_from_dict(d: Dict[str, Any]):
    from .osdmap import Incremental
    inc = Incremental()
    inc.epoch = d["epoch"]
    inc.new_max_osd = d["new_max_osd"]
    inc.new_pools = {int(k): pool_from_dict(p)
                     for k, p in d["new_pools"].items()}
    inc.new_pool_names = {int(k): v
                          for k, v in d["new_pool_names"].items()}
    inc.old_pools = list(d["old_pools"])
    inc.new_up = {int(k): v for k, v in d["new_up"].items()}
    inc.new_weight = {int(k): v for k, v in d["new_weight"].items()}
    inc.new_old_weight = {int(k): v for k, v in
                          d.get("new_old_weight", {}).items()}
    inc.new_primary_affinity = {int(k): v for k, v in
                                d["new_primary_affinity"].items()}
    inc.new_pg_upmap = {_pgid_from_key(k): list(v)
                        for k, v in d["new_pg_upmap"].items()}
    inc.old_pg_upmap = [_pgid_from_key(k) for k in d["old_pg_upmap"]]
    inc.new_pg_upmap_items = {
        _pgid_from_key(k): [tuple(t) for t in v]
        for k, v in d["new_pg_upmap_items"].items()}
    inc.old_pg_upmap_items = [_pgid_from_key(k)
                              for k in d["old_pg_upmap_items"]]
    inc.new_pg_temp = {_pgid_from_key(k): list(v)
                       for k, v in d["new_pg_temp"].items()}
    inc.new_primary_temp = {_pgid_from_key(k): v
                            for k, v in d["new_primary_temp"].items()}
    inc.new_erasure_code_profiles = {
        k: dict(v) for k, v in d["new_erasure_code_profiles"].items()}
    inc.crush = None if d["crush"] is None \
        else crush_from_dict(d["crush"])
    inc.service_log = [tuple(e) for e in d.get("service_log", [])]
    inc.service_config_kv = dict(d.get("service_config_kv", {}))
    return inc
