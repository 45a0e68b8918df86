"""Sharded GF(2^8) erasure coding over a mesh of members.

Port of ``ceph_tpu/parallel/ec.py``.  The encode product ``bits(S, C,
k*8) @ B(k*8, m*8)`` splits S over the ``stripe`` axis and the m coding
rows over the ``shard`` axis: every member launches K1 once, on its own
stream, for its stripe slice and its rows, with no exchange between
members (the contraction stays whole).  Decode is the same product with
the host-inverted survivor matrix.  Where the rows do not divide over
the shard axis, the stripes split over every member instead.

The survivor-sharded decode splits the k survivors over the shard axis:
each member runs K1 on its k-slice with the matching ``8·k/tp`` rows of
the decode bit-matrix, which gives a u8 partial product, and the K9x
kernel (``ops/mesh_xor.py``) XOR-reduces the partials.  Over GF(2) that
equals JAX's parity of the ``lax.psum`` of int32 accumulators, byte for
byte; it moves one byte per output byte where the JAX collective moves
32 (an int32 per output bit).

``reshard_stripes_to_chunks`` (JAX's ``all_to_all``) is index and copy
work.  Outputs are ``Sharded`` (``mesh/topology.py``): per-member
tensors with a CUDA event each; ``drain_sharded`` is the per-member
fence.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..gf.tables import expand_to_bitmatrix
from ..mesh.topology import Mesh, Shard, Sharded
from ..ops.gf_matmul import DeviceRSBackend
from ..ops.gf_pallas import BitMatrix, gf_bit_matmul_kernel
from ..ops.mesh_xor import xor_reduce
from ..trace.devprof import g_devprof
from .mesh import SHARD_AXIS, STRIPE_AXIS

__all__ = ["Shard", "Sharded", "ShardedRS", "drain_sharded",
           "mesh_roofline", "axis_sizes"]


def axis_sizes(mesh: Mesh) -> Tuple[int, int]:
    """(stripe, shard) sizes of *mesh*; a 1-D mesh is all stripe."""
    if STRIPE_AXIS in mesh.shape:
        return mesh.shape[STRIPE_AXIS], mesh.shape.get(SHARD_AXIS, 1)
    return mesh.size, 1


def drain_sharded(out) -> int:
    """Completion fence for a mesh-sharded output: fetch one element from
    EVERY member's piece of *out*, each on its member's stream; returns
    the number of pieces drained.  A tensor or host value takes the
    single-device drain and counts 1.

    Deliberately not accounted on the devflow ledger (n one-element
    fetches are calibration noise), as in the JAX package."""
    shards = getattr(out, "addressable_shards", None)
    if not shards:
        from ..bench.fence import drain
        drain(out if isinstance(out, torch.Tensor)
              else torch.as_tensor(np.asarray(out)))
        return 1
    for sh in shards:
        sh.fetch(1)
    return len(shards)


def mesh_roofline(gibs: float, workload, mesh: Mesh,
                  platform: str = "", device_kind: str = ""):
    """Roofline verdict for a mesh-wide throughput reading: the chip
    peaks scale by the mesh's DISTINCT devices (members that share a
    card share its peaks), which equals JAX's ``mesh.size`` on any mesh
    of one member per device."""
    from ..bench.roofline import validate_reading
    devs = mesh.distinct_devices
    plat = platform or ("gpu" if mesh.platform == "cuda" else "cpu")
    kind = device_kind
    if not kind and mesh.platform == "cuda":
        kind = torch.cuda.get_device_name(devs[0])
    return validate_reading(gibs, workload, plat, kind,
                            n_devices=len(devs))


def _bitmatrix(cache: Dict[Tuple, BitMatrix], key, bits: np.ndarray,
               rows: slice, cols: slice, device: torch.device) -> BitMatrix:
    """The BitMatrix of ``bits[rows, cols]`` on *device*, cached in
    *cache* under the matrix's *key*."""
    ck = (key, rows.start, rows.stop, cols.start, cols.stop, device)
    bm = cache.get(ck)
    if bm is None:
        bm = cache[ck] = BitMatrix(bits[rows, cols], device)
    return bm


def product_layout(mesh: Mesh, s: int, r: int) -> List[Tuple]:
    """(member, stripe slice, output-row slice) for every member: the
    stripes over the stripe axis and the rows over the shard axis, or,
    where the rows do not divide, the stripes over every member."""
    dp, tp = axis_sizes(mesh)
    if r % tp == 0 and s % dp == 0:
        sr, rr = s // dp, r // tp
        grid = mesh.devices.reshape(dp, tp)
        return [(grid[a, b], slice(a * sr, (a + 1) * sr),
                 slice(b * rr, (b + 1) * rr))
                for a in range(dp) for b in range(tp)]
    n = mesh.size
    if s % n:
        raise ValueError(f"{s} stripes do not divide over {dp} x {tp} "
                         f"members")
    sr = s // n
    return [(mem, slice(i * sr, (i + 1) * sr), slice(0, r))
            for i, mem in enumerate(mesh.members)]


def sharded_product(mesh: Mesh, data: torch.Tensor, key, bits: np.ndarray,
                    cache: Dict[Tuple, BitMatrix]) -> Sharded:
    """K1 of *data* (S, k, C) with *bits* (8k, 8r) over *mesh*: one launch
    per member, on its stream, for its piece of ``product_layout``."""
    s, _k, c = data.shape
    r = bits.shape[1] // 8
    shards = []
    for mem, srows, orows in product_layout(mesh, s, r):
        bm = _bitmatrix(cache, key, bits, slice(None),
                        slice(8 * orows.start, 8 * orows.stop), mem.device)
        src = data[srows]
        with mem.launching(src):
            out = gf_bit_matmul_kernel(src.to(mem.device), bm)
            ev = mem.record()
        shards.append(Shard(mem, out, (srows, orows, slice(0, c)), ev))
    return Sharded((s, r, c), shards, (STRIPE_AXIS, SHARD_AXIS, None))


class ShardedRS:
    """Mesh-wide executor for one (k+m, k) systematic code.

    Wraps :class:`~ceph_tpu_torch.ops.gf_matmul.DeviceRSBackend` (on the
    first member's device) with a split of the work over the members; a
    mesh of one member is the single-device path."""

    def __init__(self, encode_matrix: np.ndarray, mesh: Mesh):
        self.mesh = mesh
        self.root = mesh.members[0].device
        self.backend = DeviceRSBackend(encode_matrix, self.root)
        self.k = self.backend.k
        self.m = self.backend.m
        self._enc_bits = expand_to_bitmatrix(self.backend.matrix[self.k:])
        # per (matrix key, row or column slice, device) BitMatrix
        self._bm: Dict[Tuple, BitMatrix] = {}
        # sharded decode bit-matrices: bounded LRU mirroring the backend's
        # host-side cache so device memory cannot grow without bound
        self._dev_decode_bits: "OrderedDict[Tuple, np.ndarray]" = \
            OrderedDict()
        self._dev_decode_cap = 2516

    # -- completion fence ----------------------------------------------------
    def drain(self, out) -> int:
        """Prove *out* complete on EVERY member (one-element fetch per
        piece, on its stream); returns the pieces drained."""
        return drain_sharded(out)

    def roofline(self, gibs: float, workload):
        """Physics verdict for a mesh-wide reading, peaks scaled by the
        mesh's distinct devices."""
        return mesh_roofline(gibs, workload, self.mesh)

    # -- encode ---------------------------------------------------------------
    def encode_device(self, data: torch.Tensor) -> Sharded:
        """(S, k, C) uint8 -> (S, m, C) as per-member pieces; the stripe
        axis must divide S."""
        return sharded_product(self.mesh, data, "encode", self._enc_bits,
                               self._bm)

    def encode(self, data: np.ndarray) -> np.ndarray:
        g_devprof.account_h2d("parallel.encode", data.nbytes)
        with g_devprof.stage("parallel.encode"):
            out = self.encode_device(
                torch.from_numpy(np.ascontiguousarray(data))).numpy()
        g_devprof.account_d2h("parallel.encode", out.nbytes)
        return out

    # -- decode ---------------------------------------------------------------
    def decode_bits(self, srcs: Tuple[int, ...],
                    want_rows: Tuple[int, ...]) -> np.ndarray:
        """The (8k, 8r) decode bit-matrix for (srcs, want_rows); the
        backend's cache accounts its upload at ``gf_matmul.decode_bits``
        on a miss, as in the JAX package."""
        key = (tuple(srcs), tuple(want_rows))
        hit = self._dev_decode_bits.get(key)
        if hit is not None:
            self._dev_decode_bits.move_to_end(key)
            return hit
        bits = self.backend._decode_bits_for(*key).bits.cpu().numpy()
        self._dev_decode_bits[key] = bits
        if len(self._dev_decode_bits) > self._dev_decode_cap:
            old, _ = self._dev_decode_bits.popitem(last=False)
            self._bm = {ck: bm for ck, bm in self._bm.items()
                        if ck[0] != ("decode", old)}
        return bits

    def decode_data(self, survivors: np.ndarray, srcs: Sequence[int],
                    want_rows: Sequence[int]) -> np.ndarray:
        key = (tuple(srcs), tuple(want_rows))
        bits = self.decode_bits(*key)
        g_devprof.account_h2d("parallel.decode", survivors.nbytes)
        with g_devprof.stage("parallel.decode"):
            out = sharded_product(
                self.mesh, torch.from_numpy(np.ascontiguousarray(survivors)),
                ("decode", key), bits, self._bm).numpy()
        g_devprof.account_d2h("parallel.decode", out.nbytes)
        return out

    # -- contraction-sharded decode -------------------------------------------
    def decode_data_survivor_sharded(self, survivors: np.ndarray,
                                     srcs: Sequence[int],
                                     want_rows: Sequence[int]
                                     ) -> np.ndarray:
        """Decode with the SURVIVORS split over the ``shard`` axis: the
        degraded-read case where no single member holds all k survivors.
        Member (a, b) runs K1 on stripe block a of its k-slice b with rows
        ``8·k/tp·b ..`` of the decode bit-matrix, writing a u8 partial
        product; K9x XOR-reduces the tp partials on the first member's
        device, once per call."""
        dp, tp = axis_sizes(self.mesh)
        s, k, c = survivors.shape
        if k % tp:
            raise ValueError(f"k={k} not divisible by shard axis "
                             f"size {tp}")
        if s % dp:
            raise ValueError(f"{s} stripes not divisible by stripe axis "
                             f"size {dp}")
        key = (tuple(srcs), tuple(want_rows))
        bits = self.decode_bits(*key)
        r = bits.shape[1] // 8
        kk, sr = k // tp, s // dp
        root = self.root
        g_devprof.account_h2d("parallel.decode_sharded", survivors.nbytes)
        with g_devprof.stage("parallel.decode_sharded"):
            sv = torch.from_numpy(np.ascontiguousarray(survivors))
            partials = torch.empty((tp, s, r, c), dtype=torch.uint8,
                                   device=root)
            grid = self.mesh.devices.reshape(dp, tp)
            pending = []
            for a in range(dp):
                for b in range(tp):
                    mem = grid[a, b]
                    bm = _bitmatrix(self._bm, ("decode", key), bits,
                                         slice(8 * kk * b, 8 * kk * (b + 1)),
                                         slice(None), mem.device)
                    src = sv[a * sr:(a + 1) * sr, b * kk:(b + 1) * kk]
                    dst = partials[b, a * sr:(a + 1) * sr]
                    with mem.launching(partials):
                        x = src.contiguous().to(mem.device)
                        if mem.device == root:
                            gf_bit_matmul_kernel(x, bm, out=dst)
                            part = None
                        else:
                            part = gf_bit_matmul_kernel(x, bm)
                        ev = mem.record()
                    pending.append((ev, part, dst))
            if root.type == "cuda":
                cur = torch.cuda.current_stream(root)
                for ev, part, dst in pending:
                    cur.wait_event(ev)
                    if part is not None:
                        dst.copy_(part)
            out = xor_reduce(partials).cpu().numpy()
        g_devprof.account_d2h("parallel.decode_sharded", out.nbytes)
        return out

    # -- layout conversion ----------------------------------------------------
    def reshard_stripes_to_chunks(self, chunks) -> Sharded:
        """(S, k+m, C) stripe-split -> chunk-split over the stripe axis.

        Encode produces stripe-parallel output (each member holds ALL
        chunks of ITS stripes); distribution to OSD shards wants
        chunk-parallel layout (each member holds ONE chunk slice of ALL
        stripes, the k+m fan-out).  JAX does it with one ``all_to_all``;
        here member (a, b) copies chunk slice a of every stripe to its
        device.  Values are identical, only the layout moves."""
        dp, _tp = axis_sizes(self.mesh)
        t = chunks if isinstance(chunks, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(chunks))
        s, r, c = t.shape
        if r % dp or s % dp:
            raise ValueError(f"shape ({s}, {r}, ...) not divisible "
                             f"by stripe axis size {dp}")
        rr = r // dp
        grid = self.mesh.devices.reshape(dp, -1)
        shards = []
        for a in range(dp):
            rows = slice(a * rr, (a + 1) * rr)
            for mem in grid[a]:
                src = t[:, rows]
                with mem.launching(src):
                    piece = src.to(mem.device).contiguous()
                    ev = mem.record()
                shards.append(Shard(mem, piece,
                                    (slice(0, s), rows, slice(0, c)), ev))
        return Sharded((s, r, c), shards, (None, STRIPE_AXIS, None))
