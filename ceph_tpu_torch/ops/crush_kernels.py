"""The dense form of a straw2 CRUSH map for the card, and rjenkins in torch.

Port of the part of ``ceph_tpu/ops/crush_kernels.py`` that the
candidate-table mapper (ops/crush_fast.py) uses: ``CompiledCrushMap`` /
``compile_map`` and the hashes ``hash32_2`` / ``hash32_3``.  The JAX
module's loop mapper (``DeviceCrushMapper``) and its device ``crush_ln``
are not part of the port yet.

The hashes are the plain torch versions of the ones in
``csrc/crush_fast.cu``: torch has no full uint32 arithmetic on the CPU, so
they run in int64 with every step masked to 32 bits (``>>`` of a
non-negative int64 is the logical shift the reference uses).  Inputs are
integer tensors holding u32 values or their int32 bits; the result is an
int64 tensor in [0, 2^32).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..crush.constants import CRUSH_BUCKET_STRAW2, CRUSH_ITEM_NONE
from ..crush.types import CrushMap
from .gf_matmul import resolve_device

M32 = 0xFFFFFFFF
_SEED = 1315423911
_PAD1 = 231232
_PAD2 = 1232


# ---- rjenkins (crush/hash.c) in int64 lanes masked to 32 bits --------------

def _mix(a, b, c):
    a = (a - b - c) & M32; a = a ^ (c >> 13)
    b = (b - c - a) & M32; b = b ^ ((a << 8) & M32)
    c = (c - a - b) & M32; c = c ^ (b >> 13)
    a = (a - b - c) & M32; a = a ^ (c >> 12)
    b = (b - c - a) & M32; b = b ^ ((a << 16) & M32)
    c = (c - a - b) & M32; c = c ^ (b >> 5)
    a = (a - b - c) & M32; a = a ^ (c >> 3)
    b = (b - c - a) & M32; b = b ^ ((a << 10) & M32)
    c = (c - a - b) & M32; c = c ^ (b >> 15)
    return a, b, c


def _u32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int64) & M32


def hash32_2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(_u32(a), _u32(b))
    h = a ^ b ^ _SEED
    x = torch.full_like(h, _PAD1)
    y = torch.full_like(h, _PAD2)
    a, b, h = _mix(a, b, h)
    x, a, h = _mix(x, a, h)
    b, y, h = _mix(b, y, h)
    return h


def hash32_3(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
             ) -> torch.Tensor:
    a, b, c = torch.broadcast_tensors(_u32(a), _u32(b), _u32(c))
    h = a ^ b ^ c ^ _SEED
    x = torch.full_like(h, _PAD1)
    y = torch.full_like(h, _PAD2)
    a, b, h = _mix(a, b, h)
    c, x, h = _mix(c, x, h)
    y, a, h = _mix(y, a, h)
    b, x, h = _mix(b, x, h)
    y, c, h = _mix(y, c, h)
    return h


# ---- compiled map -----------------------------------------------------------

class CompiledCrushMap:
    """Dense-tensor form of a straw2 CrushMap (+choose_args) on ``device``.

    Buckets are indexed by ``-1 - id``; rows are padded to the largest
    bucket (``max_size``) with CRUSH_ITEM_NONE.  ``weights`` (npos, nb, S)
    carries the per-position straw2 weight sets (crush.h:273
    crush_choose_arg) as the int32 bits of their u32 values; position 0 is
    the plain item_weights when no choose_args are attached.  ``hash_ids``
    differ from ``items`` where a choose_arg sets ``ids``.
    """

    def __init__(self, m: CrushMap, choose_args: Optional[Sequence] = None,
                 device="cuda"):
        dev = resolve_device(device)
        nb = len(m.buckets)
        S = max((b.size for b in m.buckets if b is not None), default=1)
        S = max(S, 1)
        items = np.full((nb, S), CRUSH_ITEM_NONE, dtype=np.int32)
        hash_ids = np.zeros((nb, S), dtype=np.int32)
        sizes = np.zeros(nb, dtype=np.int32)
        npos = 1
        if choose_args is not None:
            for arg in choose_args:
                if arg is not None and arg.weight_set:
                    npos = max(npos, len(arg.weight_set))
        weights = np.zeros((npos, nb, S), dtype=np.uint32)
        for bi, b in enumerate(m.buckets):
            if b is None:
                continue
            if b.size and b.alg != CRUSH_BUCKET_STRAW2:
                raise ValueError("device mapper supports straw2 buckets only")
            sizes[bi] = b.size
            items[bi, :b.size] = b.items
            hash_ids[bi, :b.size] = b.items
            for it in b.items:
                if it >= 0 and it >= m.max_devices:
                    raise ValueError("bucket item beyond max_devices")
                if it < 0 and m.bucket(it) is None:
                    raise ValueError("dangling bucket reference")
            w = np.asarray(b.item_weights, dtype=np.uint32)
            weights[:, bi, :b.size] = w[None, :]
            arg = None
            if choose_args is not None and bi < len(choose_args):
                arg = choose_args[bi]
            if arg is not None:
                if arg.weight_set:
                    for p in range(npos):
                        ws = arg.weight_set[min(p, len(arg.weight_set) - 1)]
                        weights[p, bi, :b.size] = np.asarray(
                            ws.weights, dtype=np.uint32)
                if arg.ids:
                    hash_ids[bi, :b.size] = arg.ids
        if m.choose_local_tries or m.choose_local_fallback_tries:
            raise ValueError("device mapper requires bobtail+ tunables "
                             "(choose_local_*_tries == 0)")
        self.map = m
        self.device = dev
        self.nbuckets = nb
        self.max_size = S
        self.npos = npos
        self.items = torch.from_numpy(items).to(dev)
        self.hash_ids = torch.from_numpy(hash_ids).to(dev)
        self.sizes = torch.from_numpy(sizes).to(dev)
        self.weights = torch.from_numpy(weights.view(np.int32)).to(dev)


def compile_map(m: CrushMap, choose_args=None,
                device="cuda") -> CompiledCrushMap:
    """Host-side compilation; raises ValueError if the map is not one the
    card's mapper takes (straw2 only, bobtail+ tunables)."""
    return CompiledCrushMap(m, choose_args, device)
