"""The fused device step: one write batch, end to end on the mesh.

Port of ``ceph_tpu/parallel/step.py``, the analog of ECBackend's write
pipeline: for a batch of S stripes it produces every shard chunk (data
pass-through + GF coding product) and a per-shard digest folded over
all stripes (a cheap FNV-style fingerprint; the byte-exact crc32c
belongs to the host path).

With a (stripe, shard) mesh each member (a, b) runs K1 for stripe block
a and coding-row block b (``ShardedRS``'s layout); each stripe block's
digests are folded on its first member's device and the blocks' digests
summed, the one reduction of the step.

The digest sums ``chunks * w`` in wrapping uint32.  torch's uint32 has
few CUDA ops, so it runs in int64 and masks with ``& 0xFFFFFFFF``: a
byte times a w below 2**32 is below 2**40, so one row's sum over C bytes
stays below 2**63 for C < 2**23, and it is masked before the stripes are
summed (S < 2**31 masked terms).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..gf.matrices import gf_gen_rs_matrix
from ..gf.tables import expand_to_bitmatrix
from ..mesh.topology import Mesh
from ..ops.gf_pallas import BitMatrix, gf_bit_matmul_kernel
from .mesh import STRIPE_AXIS

MASK32 = 0xFFFFFFFF


def _weights(c: int, device) -> torch.Tensor:
    c_idx = torch.arange(c, dtype=torch.int64, device=device)
    return (c_idx * 0x01000193 + 0x811C9DC5) & MASK32


def _digest(chunks: torch.Tensor) -> torch.Tensor:
    """(S, n, C) uint8 -> (n,) int64 holding the uint32 digests."""
    w = _weights(chunks.shape[2], chunks.device)
    rows = (chunks.to(torch.int64) * w).sum(dim=2) & MASK32   # (S, n)
    return rows.sum(dim=0) & MASK32


def pipeline_step(data: torch.Tensor, enc_bits,
                  mesh: Optional[Mesh] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """data (S, k, C) uint8, enc_bits (8k, 8m) 0/1 ->
    (chunks (S, k+m, C) uint8, shard_digests (k+m,) int64 of uint32
    values) on the first member's device (data's device without a mesh).

    chunks = [data | coding] as they would fan out to k+m OSDs;
    shard_digests = per-shard fingerprint folded over all stripes."""
    bits = enc_bits.bits.cpu().numpy() if isinstance(enc_bits, BitMatrix) \
        else np.asarray(enc_bits)
    if mesh is None:
        bm = enc_bits if isinstance(enc_bits, BitMatrix) \
            else BitMatrix(bits, data.device)
        chunks = torch.cat([data, gf_bit_matmul_kernel(data, bm)], dim=1)
        return chunks, _digest(chunks)
    from .ec import axis_sizes, sharded_product
    dp, _tp = axis_sizes(mesh)
    s, k, c = data.shape
    if s % dp:
        raise ValueError(f"{s} stripes not divisible by {STRIPE_AXIS} "
                         f"axis size {dp}")
    root = mesh.members[0].device
    coding = sharded_product(mesh, data, "step", bits, {})
    m = coding.shape[1]
    chunks = torch.empty((s, k + m, c), dtype=torch.uint8, device=root)
    chunks[:, :k] = data.to(root)
    digests = torch.zeros(k + m, dtype=torch.int64, device=root)
    sr = s // dp
    grid = mesh.devices.reshape(dp, -1)
    cur = torch.cuda.current_stream(root) if root.type == "cuda" else None

    def handed_over(t: torch.Tensor, ev) -> torch.Tensor:
        # a member's output, read next on the current stream: wait for
        # the member's launch and keep the memory alive until the read
        if cur is not None:
            cur.wait_event(ev)
            t.record_stream(cur)
        return t.to(root)

    for sh in coding.addressable_shards:
        srows, orows, _ = sh.index
        chunks[srows, k + orows.start:k + orows.stop] = \
            handed_over(sh.data, sh.event)
    for a in range(dp):
        mem = grid[a, 0]
        block = chunks[a * sr:(a + 1) * sr]
        with mem.launching(block):
            part = _digest(block.to(mem.device))
            ev = mem.record()
        digests = (digests + handed_over(part, ev)) & MASK32
    return chunks, digests


def example_pipeline_args(mesh: Mesh, s: int = 8, k: int = 8, m: int = 4,
                          c: int = 256) -> Tuple[torch.Tensor, np.ndarray]:
    """Tiny example inputs: the JAX package's (seed 0) data on the first
    member's device and the RS(k+m, k) coding bit-matrix."""
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, size=(s, k, c), dtype=np.uint8)
    mat = gf_gen_rs_matrix(k + m, k)
    bits = expand_to_bitmatrix(mat[k:]).astype(np.uint8)
    return torch.from_numpy(data).to(mesh.members[0].device), bits
