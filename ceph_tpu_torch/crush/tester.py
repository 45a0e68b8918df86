"""CrushTester — the crushtool --test engine.

Port of ``ceph_tpu/crush/tester.py``, its text and CSV output byte for
byte.  Mirrors the reference harness (src/crush/CrushTester.{h,cc}: test()
at :472): sweep x over [min_x, max_x] for each rule and numrep in the
rule's mask range, with per-device utilization statistics (float32
expected-object math like the reference's `vector<float>`), bad-mapping
detection, adjustable device weights (--weight), the choose-tries
histogram (mapper profile), and the --output-csv data files.

The sweep runs on ``compile_fast_rule(..., device=...).map_batch`` (the
candidate-table kernels, and K6 for the x they flag), on the card unless
the caller asks for the CPU.  A rule that cannot compile for it (its
``UnsupportedRule`` or ``compile_map``'s ValueError, raised before any
launch) and ``--output-choose-tries`` (which needs per-x try counts) map
on the host ``crush_do_rule``.  A failed build or launch raises.
"""
from __future__ import annotations

import sys
from collections import defaultdict
from typing import Dict, List, Optional, TextIO

import numpy as np

from ..ops.crush_fast import compile_fast_rule
from .constants import CRUSH_ITEM_NONE
from .hash import crush_hash32_2
from .mapper import crush_do_rule
from .wrapper import CrushWrapper


class CrushTester:
    def __init__(self, crush: CrushWrapper, out: TextIO = sys.stdout,
                 device="cuda"):
        self.crush = crush
        self.out = out
        self.device = device
        self.min_rule = -1
        self.max_rule = -1
        self.min_x = -1
        self.max_x = -1
        self.min_rep = -1
        self.max_rep = -1
        self.ruleset = -1
        self.device_weight: Dict[int, int] = {}
        self.output_statistics = False
        self.output_mappings = False
        self.output_bad_mappings = False
        self.output_utilization = False
        self.output_utilization_all = False
        self.output_choose_tries = False
        self.output_csv = False
        self.output_name = ""
        self.use_device = True
        self.bad_mappings = 0
        self.pool_id = -1          # --pool-id: real_x = H(x, pool)
        self.num_batches = 1       # --batches (batch CSV rounds)
        self.simulate = False      # --simulate: RNG placement

    # ---- knobs (crushtool flags) ------------------------------------------
    def set_output_statistics(self, b: bool) -> None:
        self.output_statistics = b

    def set_output_mappings(self, b: bool) -> None:
        self.output_mappings = b

    def set_output_bad_mappings(self, b: bool) -> None:
        self.output_bad_mappings = b

    def set_output_utilization(self, b: bool) -> None:
        self.output_utilization = b

    def set_output_utilization_all(self, b: bool) -> None:
        self.output_utilization_all = b

    def set_output_choose_tries(self, b: bool) -> None:
        self.output_choose_tries = b

    def set_output_csv(self, b: bool, name: str = "") -> None:
        self.output_csv = b
        self.output_name = name

    def set_pool_id(self, pid: int) -> None:
        self.pool_id = pid

    def set_batches(self, n: int) -> None:
        self.num_batches = max(1, n)

    def set_simulate(self, b: bool) -> None:
        self.simulate = b

    def set_min_x(self, x: int) -> None:
        self.min_x = x

    def set_max_x(self, x: int) -> None:
        self.max_x = x

    def set_num_rep(self, n: int) -> None:
        self.min_rep = self.max_rep = n

    def set_rule(self, r: int) -> None:
        self.min_rule = self.max_rule = r

    def set_min_rule(self, r: int) -> None:
        self.min_rule = r

    def set_max_rule(self, r: int) -> None:
        self.max_rule = r

    def set_ruleset(self, rs: int) -> None:
        self.ruleset = rs

    def set_device_weight(self, dev: int, weight_f: float) -> None:
        w = int(weight_f * 0x10000)
        self.device_weight[dev] = max(0, min(0x10000, w))

    def _weights(self) -> List[int]:
        weight = []
        present = set()
        for b in self.crush.crush.buckets:
            if b is not None:
                present.update(i for i in b.items if i >= 0)
        for o in range(self.crush.get_max_devices()):
            if o in self.device_weight:
                weight.append(self.device_weight[o])
            elif o in present:
                weight.append(0x10000)
            else:
                weight.append(0)
        return weight

    def _map_batch(self, ruleno: int, xs, numrep: int, weight) -> np.ndarray:
        if self.pool_id >= 0:
            # CrushTester.cc:614-617: the tested input is the pool-
            # salted hash of x, like real PG placement seeds
            xs = [crush_hash32_2(int(x), self.pool_id) for x in xs]
        if self.simulate:
            # random_placement: weighted draws without replacement —
            # the RNG baseline the reference compares CRUSH against
            rng = np.random.default_rng()
            w = np.asarray(weight, dtype=np.float64)
            out = np.full((len(xs), numrep), CRUSH_ITEM_NONE,
                          dtype=np.int32)
            cnt = np.zeros(len(xs), dtype=np.int32)
            p = w / w.sum() if w.sum() else None
            for i in range(len(xs)):
                k = min(numrep, int((w > 0).sum()))
                picks = rng.choice(len(w), size=k, replace=False, p=p)
                out[i, :k] = picks
                cnt[i] = k
            return out, cnt
        if self.use_device and not self.output_choose_tries:
            try:
                fr = compile_fast_rule(self.crush.crush, ruleno, numrep,
                                       device=self.device)
            except ValueError:      # UnsupportedRule, compile_map's scope
                fr = None
            if fr is not None:
                return fr.map_batch(np.asarray(xs, dtype=np.uint32),
                                    np.asarray(weight, dtype=np.uint32))
        out = np.full((len(xs), numrep), CRUSH_ITEM_NONE, dtype=np.int32)
        cnt = np.zeros(len(xs), dtype=np.int32)
        for i, x in enumerate(xs):
            r = crush_do_rule(self.crush.crush, ruleno, int(x), numrep,
                              weight)
            out[i, :len(r)] = r
            cnt[i] = len(r)
        return out, cnt

    def _max_affected_by_rule(self, ruleno: int) -> int:
        """CrushTester::get_maximum_affected_by_rule (:34): the
        smallest bucket-type population a choose step constrains the
        result to."""
        cw = self.crush
        rule = cw.crush.rules[ruleno]
        affected: List[int] = []
        reps: Dict[int, int] = {}
        for step in rule.steps:
            if step.op >= 2 and step.op != 4:    # choose* ops
                affected.append(step.arg2)
                reps[step.arg2] = step.arg1
        count: Dict[int, int] = defaultdict(int)
        for t in affected:
            for item in cw.name_map:
                btype = cw.crush.bucket(item).type if item < 0 else 0
                if btype == t:
                    count[t] += 1
        for t in affected:
            if 0 < reps.get(t, 0) < count[t]:
                count[t] = reps[t]
        max_affected = max(len(cw.crush.buckets),
                           cw.get_max_devices())
        for t in affected:
            if 0 < count[t] < max_affected:
                max_affected = count[t]
        return max_affected

    # ---- the sweep --------------------------------------------------------
    def test(self) -> int:
        crush = self.crush
        min_rule = self.min_rule if self.min_rule >= 0 else 0
        max_rule = self.max_rule if self.max_rule >= 0 \
            else crush.crush.max_rules - 1
        min_x = self.min_x if self.min_x >= 0 else 0
        max_x = self.max_x if self.max_x >= 0 else 1023
        weight = self._weights()
        total_weight = sum(weight)
        xs = list(range(min_x, max_x + 1))
        num_objects = len(xs)
        self.bad_mappings = 0
        if self.output_choose_tries:
            # start_choose_profile: tries histogram, +1 for the
            # off-by-one retries->tries adjustment
            crush.crush.choose_tries = \
                [0] * (crush.crush.choose_total_tries + 1)

        for r in range(min_rule, max_rule + 1):
            if not crush.rule_exists(r):
                if self.output_statistics:
                    print(f"rule {r} dne", file=self.out)
                continue
            rule = crush.crush.rules[r]
            if self.ruleset >= 0 and rule.ruleset != self.ruleset:
                continue
            if self.min_rep < 0 or self.max_rep < 0:
                minr, maxr = rule.min_size, rule.max_size
            else:
                minr, maxr = self.min_rep, self.max_rep
            if self.output_statistics:
                print(f"rule {r} ({crush.rule_name_map.get(r, r)}), "
                      f"x = {min_x}..{max_x}, numrep = {minr}..{maxr}",
                      file=self.out)
            for nr in range(minr, maxr + 1):
                res, cnt = self._map_batch(r, xs, nr, weight)
                per = np.zeros(crush.get_max_devices(), dtype=np.int64)
                sizes: Dict[int, int] = defaultdict(int)
                placement: List[List[int]] = []
                for i, x in enumerate(xs):
                    # the RAW result vector, CRUSH_ITEM_NONE slots
                    # included — indep holes print as 2147483647,
                    # count toward out.size(), and flag bad mappings
                    # (CrushTester.cc:631-646)
                    raw = [int(o) for o in res[i, :cnt[i]]]
                    row = [o for o in raw if o != CRUSH_ITEM_NONE]
                    placement.append(raw)
                    sizes[len(raw)] += 1
                    vec = "[" + ",".join(str(o) for o in raw) + "]"
                    bad = len(raw) != nr or len(row) != len(raw)
                    if bad and self.output_bad_mappings:
                        print(f"bad mapping rule {r} x {x} num_rep "
                              f"{nr} result {vec}", file=self.out)
                    if bad:
                        self.bad_mappings += 1
                    for o in row:
                        per[o] += 1
                    if self.output_mappings:
                        print(f"CRUSH rule {r} x {x} {vec}",
                              file=self.out)
                # expected-objects math in float32, like the
                # reference's vector<float> (CrushTester.cc:562-593)
                expected_objects = np.float32(
                    min(nr, self._max_affected_by_rule(r))
                    * num_objects)
                prop = np.zeros(len(per), dtype=np.float32)
                if total_weight:
                    prop = (np.asarray(weight, dtype=np.float32)
                            / np.float32(total_weight))
                n_expected = prop * expected_objects
                if (self.output_utilization
                        and not self.output_statistics):
                    for o in range(len(per)):
                        print(f"  device {o}:\t{per[o]}",
                              file=self.out)
                if self.output_statistics:
                    for sz in sorted(sizes):
                        n = sizes[sz]
                        print(f"rule {r} ({crush.rule_name_map.get(r, r)})"
                              f" num_rep {nr} result size == {sz}:\t"
                              f"{n}/{len(xs)}", file=self.out)
                if self.output_statistics:
                    for o in range(len(per)):
                        e = float(n_expected[o])
                        if self.output_utilization:
                            if e > 0 and per[o] > 0:
                                print(f"  device {o}:\t\t stored "
                                      f": {per[o]}\t expected : {e:g}",
                                      file=self.out)
                        elif self.output_utilization_all:
                            print(f"  device {o}:\t\t stored "
                                  f": {per[o]}\t expected : {e:g}",
                                  file=self.out)
                if self.output_csv:
                    batch_per = None
                    if self.num_batches > 1:
                        # per-round device counts (batch_per), split
                        # the way the reference's batch loop does
                        opb = max(1, num_objects // self.num_batches)
                        batch_per = []
                        for bi in range(self.num_batches):
                            lo = bi * opb
                            hi = num_objects if \
                                bi == self.num_batches - 1 \
                                else (bi + 1) * opb
                            bp = np.zeros(len(per), dtype=np.int64)
                            for row in placement[lo:hi]:
                                for o in row:
                                    if o != CRUSH_ITEM_NONE:
                                        bp[o] += 1
                            batch_per.append(bp)
                    self._write_csv(
                        self.output_name
                        + crush.rule_name_map.get(r, str(r)),
                        nr, per, n_expected, prop, placement, min_x,
                        weight, batch_per)
        if self.output_choose_tries:
            prof = crush.crush.choose_tries or []
            # get_choose_profile returns choose_total_tries entries
            for i in range(crush.crush.choose_total_tries):
                v = prof[i] if i < len(prof) else 0
                print(f"{i:>2}: {v:>9}", file=self.out)
            crush.crush.choose_tries = None
        return 0

    def _write_csv(self, tag: str, nr: int, per, n_expected, prop,
                   placement, min_x: int, weight,
                   batch_per=None) -> None:
        """write_data_set_to_csv (CrushTester.h:104): the six
        non-batch data files with the reference's headers.  (The
        batch files require --batches > 1, like the reference.)"""
        hdr_util = ("Device ID, Number of Objects Stored, "
                    "Number of Objects Expected\n")
        with open(f"{tag}-device_utilization_all.csv", "w") as f:
            f.write(hdr_util)
            for o in range(len(per)):
                f.write(f"{o},{per[o]},{float(n_expected[o]):g}\n")
        with open(f"{tag}-device_utilization.csv", "w") as f:
            f.write(hdr_util)
            for o in range(len(per)):
                if n_expected[o] > 0 and per[o] > 0:
                    f.write(f"{o},{per[o]},"
                            f"{float(n_expected[o]):g}\n")
        with open(f"{tag}-placement_information.csv", "w") as f:
            f.write("Input" + "".join(f", OSD{i}" for i in range(nr))
                    + "\n")
            for i, row in enumerate(placement):
                f.write(f"{min_x + i},"
                        + ",".join(str(o) for o in row) + "\n")
        with open(f"{tag}-proportional_weights.csv", "w") as f:
            f.write("Device ID, Proportional Weight\n")
            for o in range(len(prop)):
                if prop[o] > 0:
                    f.write(f"{o},{float(prop[o]):g}\n")
        with open(f"{tag}-proportional_weights_all.csv", "w") as f:
            f.write("Device ID, Proportional Weight\n")
            for o in range(len(prop)):
                f.write(f"{o},{float(prop[o]):g}\n")
        with open(f"{tag}-absolute_weights.csv", "w") as f:
            f.write("Device ID, Absolute Weight\n")
            for o in range(len(weight)):
                f.write(f"{o},{weight[o] / 0x10000:g}\n")
        if batch_per is not None:
            # the two batch files exist only with --batches > 1
            # (write_data_set_to_csv's num_batches guard)
            nd = len(per)
            hdr = "Batch Round" + "".join(
                f", Objects Stored on OSD{i}" for i in range(nd))
            with open(f"{tag}-batch_device_utilization_all.csv",
                      "w") as f:
                f.write(hdr + "\n")
                for bi, bp in enumerate(batch_per):
                    f.write(f"{bi},"
                            + ",".join(str(v) for v in bp) + "\n")
            hdr = "Batch Round" + "".join(
                f", Objects Expected on OSD{i}" for i in range(nd))
            with open(
                    f"{tag}-batch_device_expected_utilization_all"
                    f".csv", "w") as f:
                f.write(hdr + "\n")
                for bi, bp in enumerate(batch_per):
                    f.write(f"{bi},"
                            + ",".join(str(v) for v in bp) + "\n")

    def check_overlapped_rules(self) -> int:
        """Warn when rulesets overlap (crushtool --check analog)."""
        seen = {}
        overlaps = 0
        for i, rule in enumerate(self.crush.crush.rules):
            if rule is None:
                continue
            key = (rule.ruleset, rule.type)
            prev = seen.get(key)
            if prev is not None:
                pr = self.crush.crush.rules[prev]
                if not (rule.min_size > pr.max_size
                        or rule.max_size < pr.min_size):
                    print(f"overlapped rules {prev} and {i} in ruleset "
                          f"{rule.ruleset}", file=self.out)
                    overlaps += 1
            else:
                seen[key] = i
        return -22 if overlaps else 0
