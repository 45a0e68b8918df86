"""Simple-map builders — OSDMap::build_simple_with_pool equivalents.

Reproduces the reference's bootstrap-map construction byte-for-byte so
the osdmaptool golden tests replay its recorded outputs:

- ``build_from_conf``: parse a ceph.conf, create one osd per [osd.N]
  section at its host/rack location (OSDMap::build_simple_crush_map_
  from_conf, src/osd/OSDMap.cc:3587).  Sections iterate in
  LEXICOGRAPHIC order (the reference's ConfFile stores sections in a
  std::map<string,...>), which fixes the bucket-id allocation order —
  and bucket ids feed the straw2 hashes, so this is mapping-critical.
- ``insert_item``: CrushWrapper::insert_item's exact creation order —
  walk types ASCENDING from the device up, creating each missing
  ancestor as a straw2 bucket CONTAINING the current cursor (so a
  host gets a lower bucket id than its rack), stopping at the first
  existing ancestor; then propagate the device weight up the chain.
- the default pool: 'rbd', replicated size 3, pg_num = max_osd <<
  pg_bits, hashpspool, crush rule 0 = [take default, chooseleaf_firstn
  0 host, emit] (add_simple_rule_at), jewel tunables.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from ..crush import CrushWrapper
from ..crush.constants import CRUSH_BUCKET_STRAW2
from .osdmap import OSDMap
from .types import FLAG_HASHPSPOOL, TYPE_REPLICATED, pg_pool_t

# OSDMap::_build_crush_types
CRUSH_TYPES = [(0, "osd"), (1, "host"), (2, "chassis"), (3, "rack"),
               (4, "row"), (5, "pdu"), (6, "pod"), (7, "room"),
               (8, "datacenter"), (9, "region"), (10, "root")]


def parse_conf_sections(text: str) -> Dict[str, Dict[str, str]]:
    """Minimal ceph.conf parser: section -> {key: value} with the
    reference's key normalization (spaces == underscores).  Returned
    dict preserves insertion order, but callers must iterate sections
    LEXICOGRAPHICALLY to match ConfFile's std::map."""
    sections: Dict[str, Dict[str, str]] = {}
    cur: Optional[Dict[str, str]] = None
    for line in text.splitlines():
        line = line.split("#", 1)[0].split(";", 1)[0].strip()
        if not line:
            continue
        msec = re.match(r"\[(.+)\]$", line)
        if msec:
            cur = sections.setdefault(msec.group(1).strip(), {})
            continue
        if cur is None or "=" not in line:
            continue
        k, _, v = line.partition("=")
        cur[k.strip().replace(" ", "_")] = v.strip()
    return sections


def _subtree_contains(cw: CrushWrapper, root: int, item: int) -> bool:
    if root == item:
        return True
    if root >= 0:
        return False
    b = cw.crush.bucket(root)
    return b is not None and any(_subtree_contains(cw, it, item)
                                 for it in b.items)


def insert_item(cw: CrushWrapper, item: int, weight: int, name: str,
                loc: Dict[str, str]) -> None:
    """CrushWrapper::insert_item at 16.16 fixed weight.  Walks the
    map's OWN type table ascending (the reference iterates type_map);
    missing ancestors are created with the map's default bucket alg
    (straw2 under jewel+, straw on legacy maps)."""
    alg = cw.get_default_bucket_alg()
    if not cw.name_exists(name):
        cw.set_item_name(item, name)
    cur = item
    device_parent = None
    for t in sorted(cw.type_map):
        tname = cw.type_map[t]
        if t == 0:
            continue
        bname = loc.get(tname)
        if bname is None:
            continue
        if not cw.name_exists(bname):
            # create the ancestor CONTAINING the cursor, weight 0
            newid = cw.add_bucket(alg, t, bname,
                                  [cur], [0])
            if cur == item:
                device_parent = newid
            cur = newid
            continue
        bid = cw.get_item_id(bname)
        b = cw.crush.bucket(bid)
        if b is None or b.type != t:
            raise ValueError(f"bucket {bname!r} type mismatch")
        if _subtree_contains(cw, bid, cur):
            # CrushWrapper.cc:901-905: re-inserting an item already
            # beneath the target location is -EINVAL, not a dup link
            raise ValueError(
                f"insert_item item {cur} already exists beneath {bid}")
        cw._bucket_link(bid, cur, 0)
        if cur == item:
            device_parent = bid
        break
    else:
        raise ValueError(f"nowhere to add item {item} in {loc}")
    # adjust_item_weightf_in_loc: set the device's weight in THE
    # LOCATION JUST PLACED (a device may live in several locations —
    # the first parent found is not necessarily this one), rebuilding
    # derived arrays and rippling the actual delta upward
    delta = cw._set_item_weight_in(device_parent, item, weight)
    cw._propagate_above(device_parent, delta)
    if item >= cw.crush.max_devices:
        cw.crush.max_devices = item + 1


def _add_default_pool(m: OSDMap, pg_bits: int, pgp_bits: int,
                      rule: int) -> None:
    if pgp_bits > pg_bits:
        pgp_bits = pg_bits
    poolbase = m.max_osd if m.max_osd else 1
    pool = pg_pool_t(type=TYPE_REPLICATED, size=3, min_size=2,
                     crush_rule=rule, pg_num=poolbase << pg_bits,
                     pgp_num=poolbase << pgp_bits,
                     flags=FLAG_HASHPSPOOL, application="rbd")
    m.add_pool("rbd", pool, pool_id=1)


def _finish_crush(cw: CrushWrapper) -> int:
    """build_simple_crush_rules: replicated_rule at id 0, chooseleaf
    over osd_crush_chooseleaf_type (host)."""
    rno = cw.add_simple_rule("replicated_rule", root_name="default",
                             failure_domain_name="host", mode="firstn",
                             ruleno=0)
    return rno


def build_from_conf(conf_text: str, with_default_pool: bool = True,
                    pg_bits: int = 6, pgp_bits: int = 6) -> OSDMap:
    """OSDMap::build_simple_with_pool(nosd=-1) + build_simple_crush_
    map_from_conf.  OSDs are NOT marked up/in (osdmaptool does that
    with --mark-up-in)."""
    sections = parse_conf_sections(conf_text)
    osd_ids: List[Tuple[str, int]] = []
    for sec in sections:
        msec = re.match(r"osd\.(\d+)$", sec)
        if msec:
            osd_ids.append((sec, int(msec.group(1))))

    m = OSDMap()
    maxosd = max((o for _, o in osd_ids), default=-1)
    m.set_max_osd(maxosd + 1)

    cw = m.crush
    for t, name in CRUSH_TYPES:
        cw.set_type_name(t, name)
    cw.set_tunables_profile("jewel")
    root = cw.add_bucket(CRUSH_BUCKET_STRAW2, 10, "default", [], [])
    assert root == -1

    # ConfFile sections iterate lexicographically (std::map<string,..>)
    for sec in sorted(s for s, _ in osd_ids):
        o = int(sec.split(".", 1)[1])
        kv = sections[sec]
        host = kv.get("host", "") or "unknownhost"
        rack = kv.get("rack", "") or "unknownrack"
        loc = {"host": host, "rack": rack, "root": "default"}
        for extra in ("row", "room", "datacenter"):
            if kv.get(extra):
                loc[extra] = kv[extra]
        insert_item(cw, o, 0x10000, sec, loc)

    rule = _finish_crush(cw)
    if with_default_pool:
        _add_default_pool(m, pg_bits, pgp_bits, rule)
    m.epoch = 1
    import time as _time
    m.created = m.modified = _time.time()
    return m


def build_simple(n_osds: int, with_default_pool: bool = True,
                 pg_bits: int = 6, pgp_bits: int = 6) -> OSDMap:
    """OSDMap::build_simple_with_pool(nosd=N): every osd at the fixed
    localhost/localrack location under the default root
    (build_simple_crush_map, OSDMap.cc:3556-3580 — localhost id -2,
    localrack -3, pinned by create-print.t's recorded decompile)."""
    import time as _time
    m = OSDMap()
    m.set_max_osd(n_osds)
    m.created = m.modified = _time.time()
    cw = m.crush
    for t, name in CRUSH_TYPES:
        cw.set_type_name(t, name)
    cw.set_tunables_profile("jewel")
    root = cw.add_bucket(CRUSH_BUCKET_STRAW2, 10, "default", [], [])
    assert root == -1
    for o in range(n_osds):
        insert_item(cw, o, 0x10000, f"osd.{o}",
                    {"host": "localhost", "rack": "localrack",
                     "root": "default"})
    rule = _finish_crush(cw)
    if with_default_pool:
        _add_default_pool(m, pg_bits, pgp_bits, rule)
    m.epoch = 1
    return m


def mark_up_in(m: OSDMap) -> None:
    """osdmaptool --mark-up-in."""
    for i in range(m.max_osd):
        m.set_osd(i, up=True)
        m.osd_weight[i] = 0x10000


def mark_out(m: OSDMap, osd: int) -> None:
    """osdmaptool --mark-out N: up but OUT (weight 0); crush weight
    stays, so placement rejects it via the is_out draw."""
    if 0 <= osd < m.max_osd:
        m.set_osd(osd, up=True)
        m.osd_weight[osd] = 0
