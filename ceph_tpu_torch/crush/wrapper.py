"""CrushWrapper — the named, user-facing façade over the raw map.

Semantics follow the reference C++ façade (src/crush/CrushWrapper.{h,cc}):
type/bucket/rule name registries, hierarchy construction, add_simple_rule
("firstn"/"indep" step templates incl. the indep SET_CHOOSELEAF_TRIES=5 /
SET_CHOOSE_TRIES=100 preamble, CrushWrapper.cc add_simple_rule_at), tunable
profiles, per-map choose_args, and the batch do_rule entry used by OSDMap.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from .constants import (
    CRUSH_RULE_CHOOSELEAF_FIRSTN, CRUSH_RULE_CHOOSELEAF_INDEP,
    CRUSH_RULE_CHOOSE_FIRSTN, CRUSH_RULE_CHOOSE_INDEP, CRUSH_RULE_EMIT,
    CRUSH_RULE_SET_CHOOSELEAF_TRIES, CRUSH_RULE_SET_CHOOSE_TRIES,
    CRUSH_RULE_TAKE, PG_POOL_TYPE_REPLICATED,
)
from . import builder
from .mapper import crush_do_rule, crush_find_rule
from .types import Bucket, ChooseArg, CrushMap, Rule, RuleStep


class CrushWrapper:
    def __init__(self):
        self.crush = CrushMap()
        self.type_map: Dict[int, str] = {0: "osd"}
        self.name_map: Dict[int, str] = {}       # item id -> name
        self.rule_name_map: Dict[int, str] = {}
        self.class_map: Dict[int, str] = {}      # class id -> name
        self.item_class: Dict[int, int] = {}     # device id -> class id
        # root bucket id -> class id -> shadow bucket id
        self.class_bucket: Dict[int, Dict[int, int]] = {}

    # ---- names ------------------------------------------------------------
    def set_type_name(self, t: int, name: str) -> None:
        self.type_map[t] = name

    def get_type_id(self, name: str) -> int:
        for t, n in self.type_map.items():
            if n == name:
                return t
        return -1

    def get_type_name(self, t: int) -> str:
        return self.type_map.get(t, f"type{t}")

    def set_item_name(self, item: int, name: str) -> None:
        self.name_map[item] = name

    def get_item_name(self, item: int) -> str:
        return self.name_map.get(
            item, f"osd.{item}" if item >= 0 else f"bucket{item}")

    def name_exists(self, name: str) -> bool:
        return name in self.name_map.values()

    def get_item_id(self, name: str) -> int:
        for i, n in self.name_map.items():
            if n == name:
                return i
        raise KeyError(name)

    def rule_exists(self, name_or_no) -> bool:
        if isinstance(name_or_no, str):
            return name_or_no in self.rule_name_map.values()
        return (0 <= name_or_no < self.crush.max_rules
                and self.crush.rules[name_or_no] is not None)

    def get_rule_id(self, name: str) -> int:
        for i, n in self.rule_name_map.items():
            if n == name:
                return i
        return -1

    def ruleset_exists(self, ruleset: int) -> bool:
        return any(r is not None and r.ruleset == ruleset
                   for r in self.crush.rules)

    # ---- device classes ---------------------------------------------------
    def get_or_create_class_id(self, name: str) -> int:
        for c, n in self.class_map.items():
            if n == name:
                return c
        c = max(self.class_map, default=-1) + 1
        self.class_map[c] = name
        return c

    def class_exists(self, name: str) -> bool:
        return name in self.class_map.values()

    def set_item_class(self, item: int, cls: str) -> int:
        c = self.get_or_create_class_id(cls)
        self.item_class[item] = c
        return c

    # ---- construction -----------------------------------------------------
    # ---- crush locations (crush/CrushLocation.cc + CrushWrapper
    # insert_item/create_or_move_item, CrushWrapper.cc) -------------------
    @staticmethod
    def parse_loc(spec) -> list:
        """"root=default host=h1" or dict -> [(type_name, name), ...]
        (the osd_crush_location config format)."""
        if isinstance(spec, dict):
            return list(spec.items())
        out = []
        for tok in str(spec).split():
            t, _, n = tok.partition("=")
            if not n:
                raise ValueError(f"bad crush location token {tok!r}")
            out.append((t, n))
        return out

    def _loc_chain(self, loc) -> int:
        """Ensure the bucket chain described by *loc* exists (creating
        straw2 buckets as needed, highest type first); returns the
        LEAF-most bucket id items should land in."""
        from .constants import CRUSH_BUCKET_STRAW2
        pairs = self.parse_loc(loc)
        typed = []
        for tname, name in pairs:
            t = self.get_type_id(tname)
            if t <= 0:
                raise ValueError(f"unknown crush type {tname!r}")
            typed.append((t, tname, name))
        typed.sort(reverse=True)           # root first
        parent = None
        for t, _tname, name in typed:
            if self.name_exists(name):
                bid = self.get_item_id(name)
                if bid >= 0:
                    raise ValueError(f"{name!r} names a device")
                # an existing but PARENTLESS bucket attaches under the
                # chain (insert_item's behavior); one already homed
                # elsewhere stays put — re-homing is move_bucket's job
                if parent is not None and self._parent_of(bid) is None:
                    self._bucket_link(parent, bid,
                                      self.crush.bucket(bid).weight)
            else:
                bid = self.add_bucket(CRUSH_BUCKET_STRAW2, t, name,
                                      [], [])
                if parent is not None:
                    self._bucket_link(parent, bid, 0)
            parent = bid
        if parent is None:
            raise ValueError("empty crush location")
        return parent

    def _parent_of(self, item: int):
        for b in self.crush.buckets:
            if b is not None and item in b.items:
                return b
        return None

    def _bucket_link(self, parent_id: int, item: int, weight: int) -> None:
        """Append an item and REBUILD the bucket: every alg's derived
        structure (list sums, straw scalers, tree nodes) must track the
        membership change or the binary codec writes inconsistent
        arrays (caught by add-item.t on a straw-v1 map)."""
        b = self.crush.bucket(parent_id)
        before = b.weight
        ws = self._bucket_weights(b)
        self.rebuild_bucket(parent_id, list(b.items) + [item],
                            ws + [weight])
        # uniform parents derive their weight from item_weight*size,
        # not the requested weight: ripple what actually changed
        self._propagate_above(
            parent_id, self.crush.bucket(parent_id).weight - before)

    def _bucket_unlink(self, item: int) -> int:
        """Detach *item* from its parent; returns its weight there."""
        p = self._parent_of(item)
        if p is None:
            return 0
        idx = p.items.index(item)
        before = p.weight
        ws = self._bucket_weights(p)
        w = ws[idx]
        items = list(p.items)
        del items[idx]
        del ws[idx]
        self.rebuild_bucket(p.id, items, ws)
        self._propagate_above(p.id,
                              self.crush.bucket(p.id).weight - before)
        return w

    def _propagate_above(self, bucket_id: int, delta: int) -> None:
        """Apply a weight delta to every ANCESTOR of bucket_id (its own
        weight was already re-derived by rebuild_bucket)."""
        p = self._parent_of(bucket_id)
        if p is None or not delta:
            return
        idx = p.items.index(bucket_id)
        ws = self._bucket_weights(p)
        ws[idx] += delta
        self.rebuild_bucket(p.id, list(p.items), ws)
        self._propagate_above(p.id, delta)

    def create_or_move_item(self, item: int, weight: int, name: str,
                            loc) -> None:
        """Place a DEVICE at the crush location, creating intermediate
        buckets and unlinking any previous position — the OSD-boot
        'ceph osd crush create-or-move' semantics
        (CrushWrapper::create_or_move_item)."""
        if item < 0:
            raise ValueError("devices only; use move_bucket for buckets")
        leaf = self._loc_chain(loc)
        self._bucket_unlink(item)
        self._bucket_link(leaf, item, weight)
        self.set_item_name(item, name)
        if item >= self.crush.max_devices:
            self.crush.max_devices = item + 1
        if self.item_class:
            self.rebuild_roots_with_classes()

    def move_bucket(self, name: str, loc) -> None:
        """Re-home an existing bucket under a new location chain
        (CrushWrapper::move_bucket)."""
        if not self.name_exists(name):
            raise ValueError(f"no bucket named {name!r}")
        bid = self.get_item_id(name)
        if bid >= 0:
            raise ValueError(f"{name!r} names a device, not a bucket")
        leaf = self._loc_chain(loc)
        # cycle guard (the reference returns -EINVAL): the destination
        # must not be the bucket itself or anything inside its subtree
        probe = leaf
        while probe is not None:
            if probe == bid:
                raise ValueError(
                    f"cannot move {name!r} under its own subtree")
            parent = self._parent_of(probe)
            probe = parent.id if parent is not None else None
        w = self.crush.bucket(bid).weight
        self._bucket_unlink(bid)
        self._bucket_link(leaf, bid, w)
        if self.item_class:
            self.rebuild_roots_with_classes()

    def get_default_bucket_alg(self) -> int:
        """Preference order over allowed_bucket_algs
        (CrushWrapper::get_default_bucket_alg)."""
        from .constants import (
            CRUSH_BUCKET_LIST, CRUSH_BUCKET_STRAW, CRUSH_BUCKET_STRAW2,
            CRUSH_BUCKET_TREE, CRUSH_BUCKET_UNIFORM)
        allowed = getattr(self.crush, "allowed_bucket_algs", 0)
        for alg in (CRUSH_BUCKET_STRAW2, CRUSH_BUCKET_STRAW,
                    CRUSH_BUCKET_TREE, CRUSH_BUCKET_LIST,
                    CRUSH_BUCKET_UNIFORM):
            if allowed & (1 << alg):
                return alg
        return CRUSH_BUCKET_STRAW2

    def _bucket_item_weight(self, b, idx: int) -> int:
        from .constants import CRUSH_BUCKET_TREE, CRUSH_BUCKET_UNIFORM
        if b.alg == CRUSH_BUCKET_UNIFORM:
            return b.item_weight
        if b.alg == CRUSH_BUCKET_TREE:
            return b.node_weights[((idx + 1) << 1) - 1]
        return b.item_weights[idx]

    def _bucket_weights(self, b) -> list:
        return [self._bucket_item_weight(b, i)
                for i in range(len(b.items))]

    def _set_item_weight_in(self, bid: int, item: int,
                            weight: int) -> int:
        """Set *item*'s weight inside bucket *bid*, REBUILDING the
        bucket so every alg's derived structure (list sums, straw
        scalers, tree nodes) stays consistent; returns the bucket's
        weight delta.  Uniform buckets reweight EVERY item (the
        reference's crush_adjust_uniform_bucket_item_weight returns
        diff * size)."""
        from .constants import CRUSH_BUCKET_UNIFORM
        b = self.crush.bucket(bid)
        idx = b.items.index(item)
        if b.alg == CRUSH_BUCKET_UNIFORM:
            old_w = b.item_weight
            self.rebuild_bucket(bid, list(b.items),
                                [weight] * len(b.items))
            return (weight - old_w) * len(b.items)
        ws = self._bucket_weights(b)
        delta = weight - ws[idx]
        ws[idx] = weight
        self.rebuild_bucket(bid, list(b.items), ws)
        return delta

    def adjust_item_weight(self, item: int, weight: int) -> int:
        """Adjust *item*'s weight wherever it lives and propagate the
        change up EVERY ancestor chain — recursively over all buckets
        containing each changed bucket, so multi-root maps (an item
        linked under several trees) update every copy
        (CrushWrapper::adjust_item_weight's recursion,
        CrushWrapper.cc).  Ancestors are REBUILT too, so straw
        scalers and tree nodes re-derive.  Returns buckets changed."""
        changed = 0
        for b in list(self.crush.buckets):
            if b is None or item not in b.items:
                continue
            self._set_item_weight_in(b.id, item, weight)
            changed += 1
            # the recursion's count is NOT accumulated (reference
            # counts direct containments only) and an unlinked item
            # is -ENOENT, not a silent no-op
            self.adjust_item_weight(b.id,
                                    self.crush.bucket(b.id).weight)
        return changed if changed else -2

    def reweight(self) -> None:
        """Recalculate every bucket weight bottom-up from the leaf
        item weights (CrushWrapper::reweight -> crush_reweight_bucket
        recursion), rebuilding straw scalers along the way."""
        def rw(bid: int) -> int:
            b = self.crush.bucket(bid)
            ws = [rw(it) if it < 0 else b.item_weights[i]
                  for i, it in enumerate(b.items)]
            self.rebuild_bucket(bid, list(b.items), ws)
            return self.crush.bucket(bid).weight
        for b in list(self.crush.buckets):
            if b is not None and self._parent_of(b.id) is None:
                rw(b.id)

    def remove_item(self, item: int) -> None:
        """Detach a device from every bucket (+ ancestor reweight) and
        drop its name (CrushWrapper::remove_item)."""
        while self._parent_of(item) is not None:
            self._bucket_unlink(item)
        self.name_map.pop(item, None)
        if self.item_class:
            self.item_class.pop(item, None)
            self.rebuild_roots_with_classes()

    def rebuild_roots_with_classes(self, pins=None) -> None:
        """(Re)build the per-class SHADOW trees (CrushWrapper::
        rebuild_roots_with_classes): for every non-shadow root and
        every device class, clone the tree keeping only that class's
        devices.  Shadow buckets are named '<orig>~<class>' (invalid
        crush names, so decompile hides them as 'id N class C'
        comments) and recorded in class_bucket[orig][class] — the take
        target for class-scoped rules."""
        # destroy existing shadows first (idempotent rebuild)
        for b in list(self.crush.buckets):
            if b is None:
                continue
            if "~" in self.name_map.get(b.id, ""):
                self.crush.buckets[-1 - b.id] = None
                self.name_map.pop(b.id, None)
        self.class_bucket = {}
        if not self.item_class or not self.class_map:
            return
        roots = sorted(
            b.id for b in self.crush.buckets if b is not None
            and self._parent_of(b.id) is None)
        self._shadow_pins = pins or {}
        for r in roots:                      # set<int> ascending
            for c in sorted(self.class_map):  # class id ascending
                self._device_class_clone(r, c)
        self._shadow_pins = {}

    def _device_class_clone(self, oid: int, c: int) -> int:
        """DFS child-first clone (CrushWrapper::device_class_clone):
        devices of other classes are dropped; child BUCKET clones are
        kept even when empty; ids take the lowest free slots in
        creation order (which the recorded goldens pin)."""
        name = f"{self.name_map[oid]}~{self.class_map[c]}"
        if self.name_exists(name):
            return self.get_item_id(name)
        b = self.crush.bucket(oid)
        items: list = []
        weights: list = []
        for i, it in enumerate(b.items):
            w = self._bucket_item_weight(b, i)
            if it >= 0:
                if self.item_class.get(it) == c:
                    items.append(it)
                    weights.append(w)
            else:
                cid = self._device_class_clone(it, c)
                items.append(cid)
                weights.append(self.crush.bucket(cid).weight)
        # a decompiled text map pins shadow ids in its 'id N class C'
        # lines: honor them so class-bearing maps round-trip with
        # stable ids (the reference parses those lines the same way)
        pin = getattr(self, "_shadow_pins", {}).get(
            (self.name_map[oid], self.class_map[c]), 0)
        nid = self.add_bucket(b.alg, b.type, name, items, weights,
                              id=pin)
        self.class_bucket.setdefault(oid, {})[c] = nid
        return nid

    def split_id_class(self, bid: int):
        """Shadow id -> (original id, class id); (bid, None) when not
        a shadow (CrushWrapper::split_id_class)."""
        for orig, per_class in self.class_bucket.items():
            for c, shadow in per_class.items():
                if shadow == bid:
                    return orig, c
        return bid, None

    def get_loc(self, item: int) -> list:
        """[(type_name, bucket_name), ...] from the item up to its root
        (CrushLocation lookup)."""
        out = []
        p = self._parent_of(item)
        while p is not None:
            out.append((self.get_type_name(p.type),
                        self.get_item_name(p.id)))
            p = self._parent_of(p.id)
        return out

    def add_bucket(self, alg: int, type: int, name: str,
                   items: Sequence[int] = (), weights: Sequence[int] = (),
                   id: int = 0) -> int:
        b = builder.make_bucket(alg, type, items, weights, id,
                                self.crush.straw_calc_version)
        bid = self.crush.add_bucket(b, None if id == 0 else id)
        self.set_item_name(bid, name)
        return bid

    def get_bucket(self, id: int) -> Bucket:
        b = self.crush.bucket(id)
        if b is None:
            raise KeyError(f"no bucket {id}")
        return b

    def rebuild_bucket(self, id: int, items: Sequence[int],
                       weights: Sequence[int]) -> None:
        """Replace a bucket's items/weights in place (reweight/add/remove)."""
        old = self.get_bucket(id)
        b = builder.make_bucket(old.alg, old.type, items, weights, id,
                                self.crush.straw_calc_version)
        self.crush.buckets[-1 - id] = b

    def get_max_devices(self) -> int:
        return self.crush.max_devices

    def set_max_devices(self, n: int) -> None:
        self.crush.max_devices = n

    # ---- rules ------------------------------------------------------------
    def add_rule(self, rule: Rule, name: str, ruleno: int = -1) -> int:
        rno = self.crush.add_rule(rule, ruleno)
        self.rule_name_map[rno] = name
        return rno

    def remove_rule(self, ruleno: int) -> int:
        """CrushWrapper::remove_rule: drop the rule slot + its name."""
        if ruleno < 0 or ruleno >= len(self.crush.rules) \
                or self.crush.rules[ruleno] is None:
            return -2
        self.crush.rules[ruleno] = None
        self.rule_name_map.pop(ruleno, None)
        return 0

    def add_simple_rule(self, name: str, root_name: str,
                        failure_domain_name: str = "",
                        device_class: str = "",
                        mode: str = "firstn",
                        rule_type: int = PG_POOL_TYPE_REPLICATED,
                        ruleno: int = -1) -> int:
        if self.rule_exists(name):
            return -17  # EEXIST
        if not self.name_exists(root_name):
            return -2   # ENOENT
        root = self.get_item_id(root_name)
        ftype = 0
        if failure_domain_name:
            ftype = self.get_type_id(failure_domain_name)
            if ftype < 0:
                return -22  # EINVAL
        if device_class:
            if not self.class_exists(device_class):
                return -22
            c = self.get_or_create_class_id(device_class)
            shadow = self.class_bucket.get(root, {}).get(c)
            if shadow is None:
                return -22
            root = shadow
        if mode not in ("firstn", "indep"):
            return -22
        if ruleno < 0:
            ruleno = next(
                (i for i in range(self.crush.max_rules + 1)
                 if not self.rule_exists(i) and not self.ruleset_exists(i)))
        steps: List[RuleStep] = []
        if mode == "indep":
            steps.append(RuleStep(CRUSH_RULE_SET_CHOOSELEAF_TRIES, 5, 0))
            steps.append(RuleStep(CRUSH_RULE_SET_CHOOSE_TRIES, 100, 0))
        steps.append(RuleStep(CRUSH_RULE_TAKE, root, 0))
        if ftype:
            steps.append(RuleStep(
                CRUSH_RULE_CHOOSELEAF_FIRSTN if mode == "firstn"
                else CRUSH_RULE_CHOOSELEAF_INDEP, 0, ftype))
        else:
            steps.append(RuleStep(
                CRUSH_RULE_CHOOSE_FIRSTN if mode == "firstn"
                else CRUSH_RULE_CHOOSE_INDEP, 0, 0))
        steps.append(RuleStep(CRUSH_RULE_EMIT, 0, 0))
        rule = Rule(steps=steps, ruleset=ruleno, type=rule_type,
                    min_size=1 if mode == "firstn" else 3,
                    max_size=10 if mode == "firstn" else 20)
        return self.add_rule(rule, name, ruleno)

    def set_rule_mask_max_size(self, ruleno: int, max_size: int) -> None:
        self.crush.rules[ruleno].max_size = max_size

    def find_rule(self, ruleset: int, type: int, size: int) -> int:
        return crush_find_rule(self.crush, ruleset, type, size)

    # ---- tunables ---------------------------------------------------------
    def set_tunables_profile(self, profile: str) -> None:
        self.crush.set_tunables_profile(profile)

    # ---- choose args ------------------------------------------------------
    def choose_args_create(self, key: int = 0) -> List[ChooseArg]:
        args = [ChooseArg() for _ in range(self.crush.max_buckets)]
        self.crush.choose_args[key] = args
        return args

    def choose_args_get(self, key: int = 0) -> Optional[List[ChooseArg]]:
        return self.crush.choose_args.get(key)

    # ---- mapping ----------------------------------------------------------
    def do_rule(self, ruleno: int, x: int, maxout: int,
                weight: Sequence[int],
                choose_args_index: Optional[int] = None) -> List[int]:
        ca = None
        if choose_args_index is not None:
            ca = self.crush.choose_args.get(choose_args_index)
        return crush_do_rule(self.crush, ruleno, x, maxout, weight, ca)

    # ---- introspection ----------------------------------------------------
    def get_children(self, id: int) -> List[int]:
        b = self.crush.bucket(id)
        return list(b.items) if b else []

    def get_full_location(self, item: int) -> Dict[str, str]:
        """Walk up the tree: type name -> bucket name for each ancestor."""
        loc = {}
        cur = item
        found = True
        while found:
            found = False
            for b in self.crush.buckets:
                if b is not None and cur in b.items:
                    loc[self.get_type_name(b.type)] = self.get_item_name(b.id)
                    cur = b.id
                    found = True
                    break
        return loc
