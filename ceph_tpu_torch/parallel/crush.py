"""Multi-member CRUSH: the whole-cluster remap with its PG axis split over
a mesh.

Port of ``ceph_tpu/parallel/crush.py``.  Each member maps its slice of
the x: K7a builds its candidate tables once per batch of x, and every
epoch K7b resolves them against the weights and K6 finishes the x that
K7b flagged, on the member that holds them (the JAX rule replays flagged
x on the host; the port has none).  Placement is embarrassingly
parallel per PG, so members exchange nothing; only the (X,
result_max+1) rows come back.  This is OSDMapMapping's ParallelPGMapper
with mesh members in place of CPU worker threads.  Members that share a
device share one compiled rule (its tables), each with candidate tables
of its own.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..crush.types import CrushMap
from ..mesh.topology import Mesh, Shard, Sharded
from ..ops.crush_fast import FastRule, compile_fast_rule
from .mesh import SHARD_AXIS, STRIPE_AXIS


class ShardedFastRule:
    """A FastRule whose PG axis is split over every member of *mesh*."""

    def __init__(self, m: CrushMap, ruleno: int, result_max: int,
                 mesh: Mesh, **kw):
        self.mesh = mesh
        self.n_devices = mesh.size
        self._rules: Dict[torch.device, FastRule] = {
            dev: compile_fast_rule(m, ruleno, result_max, device=dev, **kw)
            for dev in mesh.distinct_devices}
        self.fr: FastRule = self._rules[mesh.members[0].device]
        # per member: (member, rule, x on its device, candidate tables)
        self._cand: Optional[List[Tuple]] = None
        self._cand_key: Optional[bytes] = None
        self._flagged: List[Tuple[torch.Tensor, torch.Tensor]] = []
        self._residual_frac = 0.0

    @property
    def result_max(self) -> int:
        return self.fr.result_max

    @property
    def residual_fraction(self) -> float:
        """Share of the last ``map_batch``'s x that K7b flagged, all
        finished by K6 on their member."""
        return self._residual_frac

    def prepare_candidates(self, xs_padded: np.ndarray) -> None:
        """K7a's candidate tables for each member's slice of
        *xs_padded* (a multiple of the member count), cached by the
        batch of x."""
        xs_padded = np.ascontiguousarray(xs_padded, dtype=np.uint32)
        key = hashlib.sha1(xs_padded.tobytes()).digest()
        if self._cand_key == key:
            return
        per = xs_padded.shape[0] // self.n_devices
        cands, events = [], []
        for i, mem in enumerate(self.mesh.members):
            fr = self._rules[mem.device]
            sl = np.ascontiguousarray(xs_padded[i * per:(i + 1) * per])
            with mem.launching():
                xd = torch.from_numpy(sl.view(np.int32)).to(mem.device)
                cand = fr._candidates(xd)
                events.append(mem.record())
            cands.append((mem, fr, xd, cand))
        for ev in events:
            if ev is not None:
                ev.synchronize()
        self._cand = cands
        self._cand_key = key

    def resolve_device(self, weight) -> Sharded:
        """Each member's exact packed rows for *weight* (K7b, then K6 on
        its flagged x), as per-member pieces of (X_padded, R+1) rows."""
        if self._cand is None:
            raise RuntimeError("no candidate tables; call "
                               "prepare_candidates(xs) first")
        w32 = np.ascontiguousarray(weight, dtype=np.uint32).view(np.int32)
        R = self.fr.result_max
        per = self._cand[0][2].shape[0]
        shards, flagged = [], []
        for i, (mem, fr, xd, cand) in enumerate(self._cand):
            with mem.launching():
                wd = torch.from_numpy(w32).to(mem.device)
                packed, n_fl, idx = fr.exact_rows(cand, xd, wd)
                ev = mem.record()
            shards.append(Shard(mem, packed,
                                (slice(i * per, (i + 1) * per),
                                 slice(0, R + 1)), ev))
            flagged.append((n_fl, idx))
        self._flagged = flagged
        return Sharded((per * len(shards), R + 1), shards,
                       ((STRIPE_AXIS, SHARD_AXIS), None))

    def map_batch(self, xs: np.ndarray, weight: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact whole-map mapping, PGs split across the members."""
        xs = np.asarray(xs, dtype=np.uint32)
        X = xs.shape[0]
        pad = (-X) % self.n_devices
        xs_p = np.concatenate([xs, np.repeat(xs[:1], pad)]) if pad else xs
        self.prepare_candidates(xs_p)
        R = self.fr.result_max
        packed = self.resolve_device(weight)
        full = packed.numpy()[:X]
        out = full[:, :R].copy()
        counts = (full[:, R] & 0xFFFF).astype(np.int32)
        per = packed.shape[0] // self.n_devices
        n_res = 0
        for i, ((n_fl, idx), sh) in enumerate(zip(self._flagged,
                                                  packed.addressable_shards)):
            with sh.member.launching():
                n = int(n_fl.cpu()[0])
                rows = idx[:n].cpu().numpy()
            n_res += int(np.count_nonzero(rows + i * per < X))
        self._residual_frac = n_res / X if X else 0.0
        return out, counts


def sharded_fast_rule(m: CrushMap, ruleno: int, result_max: int,
                      mesh: Mesh, **kw) -> ShardedFastRule:
    return ShardedFastRule(m, ruleno, result_max, mesh, **kw)
