"""LRC — layered locally-repairable erasure code.

Port of ``ceph_tpu/ec/lrc.py``; semantics of the reference plugin
(src/erasure-code/lrc/ErasureCodeLrc.{h,cc}): a code is a stack of layers,
each a chunks_map string over the global chunk positions ('D' data, 'c'
coding, '_' absent) plus a sub-profile instantiating a delegate codec
from the registry (default jerasure reed_sol_van) over just that layer's
chunks.  Encode runs the layers bottom up from the first layer containing
all wanted chunks (ErasureCodeLrc.cc:744-780); decode walks layers in
reverse, each layer repairing what it can and feeding recovered chunks to
the layers above (:783-869); minimum_to_decode prefers cheap local-layer
repair before global (:571-742).  The simple k/m/l form generates the
mapping/layers/crush-steps as parse_kml does (:294-400).  The parent's
``backend`` flows into every layer, so on ``backend=cuda`` every layer's
encode and decode run the bit-matmul kernel on the card.

``create_rule`` adds the crush-steps rule to a CrushWrapper;
``rule_for`` builds the same rule from resolved ids without a map.
"""
from __future__ import annotations

import json
from typing import Callable, Dict, List, Optional, Set

import numpy as np

from ..crush.constants import (
    CRUSH_RULE_CHOOSELEAF_INDEP, CRUSH_RULE_CHOOSE_INDEP, CRUSH_RULE_EMIT,
    CRUSH_RULE_SET_CHOOSELEAF_TRIES, CRUSH_RULE_SET_CHOOSE_TRIES,
    CRUSH_RULE_TAKE, PG_POOL_TYPE_ERASURE,
)
from ..crush.types import Rule, RuleStep
from .base import ErasureCode
from .interface import ErasureCodeProfile

DEFAULT_KML = -1


class Layer:
    def __init__(self, chunks_map: str):
        self.chunks_map = chunks_map
        self.profile: ErasureCodeProfile = {}
        self.data: List[int] = []
        self.coding: List[int] = []
        self.chunks: List[int] = []
        self.chunks_as_set: Set[int] = set()
        self.erasure_code = None


class RuleStepSpec:
    def __init__(self, op: str, type: str, n: int):
        self.op = op
        self.type = type
        self.n = n


class ErasureCodeLrc(ErasureCode):
    def __init__(self):
        super().__init__()
        self.layers: List[Layer] = []
        self.chunk_count_ = 0
        self.data_chunk_count_ = 0
        self.rule_steps: List[RuleStepSpec] = \
            [RuleStepSpec("chooseleaf", "host", 0)]

    # ---- profile parsing --------------------------------------------------
    def init(self, profile: ErasureCodeProfile) -> None:
        profile = dict(profile)
        self._backend_name = profile.get("backend", "")
        self._parse_kml(profile)
        self._parse_rule(profile)
        layers_str = profile.get("layers")
        if not layers_str:
            raise ValueError(f"could not find 'layers' in {profile}")
        try:
            description = json.loads(layers_str)
        except json.JSONDecodeError as e:
            raise ValueError(f"failed to parse layers={layers_str!r}: {e}")
        if not isinstance(description, list):
            raise ValueError(f"layers={layers_str!r} must be a JSON array")
        self._layers_parse(description)
        mapping = profile.get("mapping")
        if not mapping:
            raise ValueError("the 'mapping' profile is missing")
        self.data_chunk_count_ = sum(1 for c in mapping if c == "D")
        self.chunk_count_ = len(mapping)
        self._layers_init()
        self._layers_sanity_checks()
        # kml-generated parameters are not exposed to the caller
        # (ErasureCodeLrc.cc:543-549)
        if profile.get("l") and profile["l"] != str(DEFAULT_KML):
            public = dict(profile)
            public.pop("mapping", None)
            public.pop("layers", None)
        else:
            public = profile
        super().init(public)
        self.parse_mapping(profile)

    def _parse_kml(self, profile: Dict[str, str]) -> None:
        k = self.to_int("k", profile, DEFAULT_KML)
        m = self.to_int("m", profile, DEFAULT_KML)
        l = self.to_int("l", profile, DEFAULT_KML)
        if k == DEFAULT_KML and m == DEFAULT_KML and l == DEFAULT_KML:
            return
        if DEFAULT_KML in (k, m, l):
            raise ValueError("all of k, m, l must be set or none of them")
        for generated in ("mapping", "layers", "crush-steps"):
            if generated in profile:
                raise ValueError(
                    f"the {generated} parameter cannot be set "
                    "when k, m, l are set")
        if (k + m) % l:
            raise ValueError("k + m must be a multiple of l")
        groups = (k + m) // l
        if k % groups:
            raise ValueError("k must be a multiple of (k + m) / l")
        if m % groups:
            raise ValueError("m must be a multiple of (k + m) / l")
        kg, mg = k // groups, m // groups
        profile["mapping"] = ("D" * kg + "_" * mg + "_") * groups
        layers = []
        # global layer
        layers.append([("D" * kg + "c" * mg + "_") * groups, ""])
        # local layers
        for i in range(groups):
            s = ""
            for j in range(groups):
                s += ("D" * l + "c") if i == j else ("_" * (l + 1))
            layers.append([s, ""])
        profile["layers"] = json.dumps(layers)
        locality = profile.get("crush-locality", "")
        failure_domain = profile.get("crush-failure-domain", "host")
        if locality:
            self.rule_steps = [RuleStepSpec("choose", locality, groups),
                               RuleStepSpec("chooseleaf", failure_domain,
                                            l + 1)]
        elif failure_domain:
            self.rule_steps = [RuleStepSpec("chooseleaf", failure_domain, 0)]

    def _parse_rule(self, profile: Dict[str, str]) -> None:
        self.rule_root = profile.get("crush-root", "default")
        self.rule_device_class = profile.get("crush-device-class", "")
        steps = profile.get("crush-steps")
        if steps:
            try:
                arr = json.loads(steps)
            except json.JSONDecodeError as e:
                raise ValueError(f"failed to parse crush-steps: {e}")
            self.rule_steps = [RuleStepSpec(op, t, int(n))
                               for op, t, n in arr]

    def _layers_parse(self, description) -> None:
        self.layers = []
        for pos, entry in enumerate(description):
            if not isinstance(entry, list) or not entry:
                raise ValueError(
                    f"element {pos} of layers must be a JSON array")
            if not isinstance(entry[0], str):
                raise ValueError(
                    f"the first element of entry {pos} must be a string")
            layer = Layer(entry[0])
            if len(entry) > 1:
                cfg = entry[1]
                if isinstance(cfg, str):
                    layer.profile = dict(
                        kv.split("=", 1) for kv in cfg.split() if "=" in kv)
                elif isinstance(cfg, dict):
                    layer.profile = {k: str(v) for k, v in cfg.items()}
                else:
                    raise ValueError(
                        f"entry {pos} config must be a string or object")
            self.layers.append(layer)

    def _layers_init(self) -> None:
        from .registry import instance as registry
        for layer in self.layers:
            for position, c in enumerate(layer.chunks_map):
                if c == "D":
                    layer.data.append(position)
                if c == "c":
                    layer.coding.append(position)
                if c in ("c", "D"):
                    layer.chunks_as_set.add(position)
            layer.chunks = layer.data + layer.coding
            layer.profile.setdefault("k", str(len(layer.data)))
            layer.profile.setdefault("m", str(len(layer.coding)))
            layer.profile.setdefault("plugin", "jerasure")
            layer.profile.setdefault("technique", "reed_sol_van")
            # the parent's backend choice flows into every layer
            if self._backend_name:
                layer.profile.setdefault("backend", self._backend_name)
            layer.erasure_code = registry.factory(
                layer.profile["plugin"], layer.profile)

    def _layers_sanity_checks(self) -> None:
        if len(self.layers) < 1:
            raise ValueError("layers parameter needs at least one layer")
        for layer in self.layers:
            if len(layer.chunks_map) != self.chunk_count_:
                raise ValueError(
                    f"chunks_map {layer.chunks_map!r} must be "
                    f"{self.chunk_count_} characters long")

    # ---- interface --------------------------------------------------------
    def get_chunk_count(self) -> int:
        return self.chunk_count_

    def get_data_chunk_count(self) -> int:
        return self.data_chunk_count_

    def get_chunk_size(self, object_size: int) -> int:
        return self.layers[0].erasure_code.get_chunk_size(object_size)

    def rule_for(self, root: int,
                 type_id: Callable[[str], int]) -> Optional[Rule]:
        """The rule ``create_rule`` adds (ErasureCodeLrc.cc:46-115), given
        the root's item id (its device-class shadow where one is set) and
        a lookup of type ids by name; None where a type is unknown (the
        reference's -EINVAL)."""
        steps = [RuleStep(CRUSH_RULE_SET_CHOOSELEAF_TRIES, 5, 0),
                 RuleStep(CRUSH_RULE_SET_CHOOSE_TRIES, 100, 0),
                 RuleStep(CRUSH_RULE_TAKE, root, 0)]
        for s in self.rule_steps:
            op = CRUSH_RULE_CHOOSELEAF_INDEP if s.op == "chooseleaf" \
                else CRUSH_RULE_CHOOSE_INDEP
            t = type_id(s.type)
            if t < 0:
                return None
            steps.append(RuleStep(op, s.n, t))
        steps.append(RuleStep(CRUSH_RULE_EMIT, 0, 0))
        return Rule(steps=steps, ruleset=-1, type=PG_POOL_TYPE_ERASURE,
                    min_size=3, max_size=self.get_chunk_count())

    def create_rule(self, name: str, crush) -> int:
        """Add ``rule_for``'s rule to ``crush`` (a ``CrushWrapper``) under
        ``name``; the reference's negative errno where it cannot."""
        if crush.rule_exists(name):
            return -17  # EEXIST
        if not crush.name_exists(self.rule_root):
            return -2   # ENOENT
        root = crush.get_item_id(self.rule_root)
        if self.rule_device_class:
            if not crush.class_exists(self.rule_device_class):
                return -2
            c = crush.get_or_create_class_id(self.rule_device_class)
            shadow = crush.class_bucket.get(root, {}).get(c)
            if shadow is None:
                return -22
            root = shadow
        rule = self.rule_for(root, crush.get_type_id)
        if rule is None:
            return -22  # EINVAL
        rno = crush.add_rule(rule, name)
        rule.ruleset = rno
        return rno

    # ---- minimum_to_decode (the local-repair search) ----------------------
    def _minimum_to_decode(self, want_to_read: Set[int],
                           available_chunks: Set[int]) -> Set[int]:
        erasures_total = set()
        erasures_not_recovered = set()
        erasures_want = set()
        for i in range(self.get_chunk_count()):
            if i not in available_chunks:
                erasures_total.add(i)
                erasures_not_recovered.add(i)
                if i in want_to_read:
                    erasures_want.add(i)

        # case 1: nothing wanted is missing
        if not erasures_want:
            return set(want_to_read)

        # case 2: recover wanted erasures with as few chunks as possible,
        # scanning layers bottom-up (local layers first)
        minimum: Set[int] = set()
        for layer in reversed(self.layers):
            layer_want = want_to_read & layer.chunks_as_set
            if not layer_want:
                continue
            layer_erasures = layer_want & erasures_want
            if not layer_erasures:
                layer_minimum = layer_want
            else:
                erasures = layer.chunks_as_set & erasures_not_recovered
                if len(erasures) > \
                        layer.erasure_code.get_coding_chunk_count():
                    # too many erasures for this layer: hope upper layers help
                    continue
                layer_minimum = layer.chunks_as_set - erasures_not_recovered
                for j in erasures:
                    erasures_not_recovered.discard(j)
                    erasures_want.discard(j)
            minimum |= layer_minimum
        if not erasures_want:
            minimum |= set(want_to_read)
            minimum -= erasures_total
            return minimum

        # case 3: recover everything recoverable, hoping it unlocks uppers
        erasures_total = {i for i in range(self.get_chunk_count())
                          if i not in available_chunks}
        for layer in reversed(self.layers):
            layer_erasures = layer.chunks_as_set & erasures_total
            if not layer_erasures:
                continue
            if len(layer_erasures) <= \
                    layer.erasure_code.get_coding_chunk_count():
                erasures_total -= layer_erasures
        if not erasures_total:
            return set(available_chunks)

        raise IOError(
            f"not enough chunks in {sorted(available_chunks)} to read "
            f"{sorted(want_to_read)}")

    # ---- encode/decode ----------------------------------------------------
    def encode_chunks(self, want_to_encode: Set[int], encoded) -> None:
        top = len(self.layers)
        for layer in reversed(self.layers):
            top -= 1
            if want_to_encode <= layer.chunks_as_set:
                break
        for layer in self.layers[top:]:
            layer_want: Set[int] = set()
            layer_encoded: Dict[int, np.ndarray] = {}
            for j, c in enumerate(layer.chunks):
                layer_encoded[j] = encoded[c]
                if c in want_to_encode:
                    layer_want.add(j)
            layer.erasure_code.encode_chunks(layer_want, layer_encoded)
            for j, c in enumerate(layer.chunks):
                encoded[c] = layer_encoded[j]

    def encode_batch_full(self, stripes: np.ndarray) -> np.ndarray:
        """(S, k, C) logical data stripes -> (S, n, C) ALL chunks in
        physical position order, every layer's coding computed in one
        batched call of its delegate (the ECUtil batch entry for mapped
        codes)."""
        s, k, c = stripes.shape
        if k != self.data_chunk_count_:
            raise ValueError(f"stripes hold {k} data chunks, the code "
                             f"{self.data_chunk_count_}")
        n = self.chunk_count_
        buf = np.zeros((s, n, c), dtype=np.uint8)
        for i in range(k):
            buf[:, self.chunk_index(i), :] = stripes[:, i, :]
        for layer in self.layers:
            data = np.ascontiguousarray(buf[:, layer.data, :])
            coding = layer.erasure_code.encode_batch(data)
            for idx, pos in enumerate(layer.coding):
                buf[:, pos, :] = coding[:, idx, :]
        return buf

    def decode_batch(self, chunks, want) -> Dict[int, np.ndarray]:
        """Batched layer-walking recovery (chunks: physical id -> (S, C));
        each layer repairs what it can through its delegate's batched
        decode and feeds recovered chunks upward: the decode_chunks walk
        (ErasureCodeLrc.cc:783-869) over all stripes at once."""
        n = self.get_chunk_count()
        full: Dict[int, Optional[np.ndarray]] = {
            i: chunks.get(i) for i in range(n)}
        erasures = {i for i in range(n) if full[i] is None}
        want_missing = erasures & set(want)
        if not want_missing:
            return {i: full[i] for i in want}
        for layer in reversed(self.layers):
            layer_erasures = layer.chunks_as_set & erasures
            if not layer_erasures:
                continue
            if len(layer_erasures) > \
                    layer.erasure_code.get_coding_chunk_count():
                continue
            delegate = layer.erasure_code
            layer_chunks = {j: full[cpos]
                            for j, cpos in enumerate(layer.chunks)
                            if cpos not in erasures}
            want_js = [j for j, cpos in enumerate(layer.chunks)
                       if cpos in erasures]
            try:
                got = delegate.decode_batch(layer_chunks, want_js)
            except IOError:
                continue
            for j, cpos in enumerate(layer.chunks):
                if cpos in erasures and j in got:
                    full[cpos] = got[j]
                    erasures.discard(cpos)
            want_missing = erasures & set(want)
            if not want_missing:
                break
        if want_missing:
            raise IOError(f"unable to read {sorted(want_missing)}")
        return {i: full[i] for i in want}

    def decode_chunks(self, want_to_read: Set[int], chunks,
                      decoded) -> None:
        erasures = {i for i in range(self.get_chunk_count())
                    if i not in chunks}
        # start from the actual outstanding erasures so a decode where every
        # layer skips (insufficient chunks) fails loudly instead of passing
        # zero-filled buffers through
        want_to_read_erasures: Set[int] = erasures & set(want_to_read)
        for layer in reversed(self.layers):
            layer_erasures = layer.chunks_as_set & erasures
            if len(layer_erasures) > \
                    layer.erasure_code.get_coding_chunk_count():
                continue  # too many erasures for this layer
            if not layer_erasures:
                continue  # all available already
            layer_want: Set[int] = set()
            layer_chunks: Dict[int, np.ndarray] = {}
            layer_decoded: Dict[int, np.ndarray] = {}
            for j, c in enumerate(layer.chunks):
                # chunks recovered by previous layers flow in via *decoded*
                if c not in erasures:
                    layer_chunks[j] = decoded[c]
                if c in want_to_read:
                    layer_want.add(j)
                layer_decoded[j] = decoded[c]
            layer.erasure_code.decode_chunks(layer_want, layer_chunks,
                                             layer_decoded)
            for j, c in enumerate(layer.chunks):
                decoded[c] = layer_decoded[j]
                erasures.discard(c)
            want_to_read_erasures = erasures & want_to_read
            if not want_to_read_erasures:
                break
        if want_to_read_erasures:
            raise IOError(
                f"unable to read {sorted(want_to_read_erasures)}")
