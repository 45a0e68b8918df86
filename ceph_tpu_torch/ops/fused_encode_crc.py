"""The fused resident encode in one pass: the hand-written kernel, its
wrapper and its plain PyTorch version.

Port of the XLA function ``ceph_tpu/ops/resident.py::_fused_encode_crc``
(K5).  The kernel, ``csrc/fused_encode_crc.cu``, reads the (S, k, C)
stripes once and writes the n = k + r shard bodies (body i = chunk i of
every stripe: data chunks copied, parity chunks formed by the bit-matmul's
nibble tables) while it hashes them with crc32c's coalesced scheme; no
(S, r, C) intermediate exists.

- ``one_pass(s, k, r, c, addrs)``: whether the kernel takes a shape, from
  the shape and the stripes' and bodies' addresses alone: C a positive
  multiple of ITER (2048), every address 16-byte aligned, n <= 128 and
  tables that fit in a block's shared memory.  ``ops/resident.py`` routes
  by it before any launch; the CPU can call it.
- ``fused_encode_crc_kernel(stripes, bm, bodies)`` fills the bodies and
  returns their (n,) int32 CRC bits.  A CPU tensor takes the plain
  version; a CUDA tensor launches the kernel on the current stream or
  raises.  ``launches.n`` counts kernel launches.
- ``fused_encode_crc_plain(stripes, bm)`` is the reference: the plain
  bit-matmul, the bodies of ``concat([stripes, coding], 1)`` transposed,
  and the plain crc32c of each.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import _build
from .crc32c_device import (ITER, MAX_RUN_ITERS, _apply_np,
                            _pow2_matrices_np, crc32c_plain, device_advance,
                            device_coalesced_tables)
from .gf_pallas import BitMatrix, LaunchCounter, gf_bit_matmul_plain

_SIGNATURES = {
    "fused_encode_crc_launch": (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_longlong,
         ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_uint,
         ctypes.c_void_p, ctypes.c_void_p],
        ctypes.c_int),
}

MAX_BODIES = 128                 # body addresses the kernel takes by value
THREADS = 256                    # the kernel's block
# warps resident at once on an H100: 132 SMs x 2 blocks of 8 warps (the
# kernel's 95 registers a thread allow two blocks per SM)
RESIDENT_WARPS = 132 * 2 * 8
SMEM_MAX = 232448                # shared memory one block may use (sm_90)
# shared words besides the product tables and the accumulators: the crc
# nibble tables (CHUNKS * 32 + 8 of 16 words) and the padded lane matrices
_CRC_WORDS = (4 * 32 + 8) * 16 + 32 * 33

launches = LaunchCounter()


def smem_bytes(k: int, r: int) -> int:
    """The kernel's shared memory for k data and r parity rows: product
    tables (ceil(r/4) groups of ceil(k/2)*2 rows of 128 B), the crc
    tables, and one accumulator word per body and thread."""
    group = (k + 1) // 2 * 2 * 32
    return 4 * (-(-r // 4) * group + _CRC_WORDS + (k + r) * THREADS)


def one_pass(s: int, k: int, r: int, c: int, addrs: Sequence[int]) -> bool:
    """True when the one-pass kernel takes (S, k, C) stripes with r
    parity rows, the stripes and bodies at ``addrs``."""
    return (s >= 1 and c > 0 and c % ITER == 0 and k + r <= MAX_BODIES
            and smem_bytes(k, r) <= SMEM_MAX
            and all(a % 16 == 0 for a in addrs))


def run_bytes(length: int) -> int:
    """Bytes per warp run: ITER times the smallest power of two (up to
    MAX_RUN_ITERS) that keeps the runs within one wave of resident warps,
    so that no second, partial wave trails the first."""
    iters = max(1, -(-length // ITER))
    per = 1
    while per < MAX_RUN_ITERS and -(-iters // per) > RESIDENT_WARPS:
        per *= 2
    return ITER * per


@functools.lru_cache(maxsize=64)
def seed_term(length: int) -> int:
    """M_L 0xFFFFFFFF: the seed's share of the crc of L bytes."""
    pow2 = _pow2_matrices_np()
    x = np.array(0xFFFFFFFF, dtype=np.uint32)
    for e in range(length.bit_length()):
        if length >> e & 1:
            x = _apply_np(pow2[e], x)
    return int(x)


def fused_encode_crc_plain(stripes: torch.Tensor, bm: BitMatrix) \
        -> Tuple[torch.Tensor, torch.Tensor]:
    """(S, k, C) uint8 -> ((n, S*C) bodies, (n,) int32 CRC bits), as the
    JAX function writes it, on ``stripes``' device."""
    coding = gf_bit_matmul_plain(stripes, bm.bits.to(stripes.device))
    allsh = torch.cat([stripes, coding], dim=1)            # (S, n, C)
    bodies = allsh.transpose(0, 1).reshape(allsh.shape[1], -1)
    return bodies, crc32c_plain(bodies)


def fused_encode_crc_kernel(stripes: torch.Tensor, bm: BitMatrix,
                            bodies: List[torch.Tensor]) -> torch.Tensor:
    """Fill ``bodies`` (n = k + r contiguous 1-D uint8 tensors of S*C
    bytes) from contiguous (S, k, C) uint8 stripes and return their
    (n,) int32 CRC bits.  A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel or raises, also for a shape that
    ``one_pass`` refuses."""
    if stripes.dim() != 3 or stripes.dtype != torch.uint8:
        raise ValueError(f"stripes must be (S, k, C) uint8, got "
                         f"{tuple(stripes.shape)} {stripes.dtype}")
    s, k, c = stripes.shape
    if k != bm.k or len(bodies) != k + bm.r:
        raise ValueError(f"k={k} stripes and {len(bodies)} bodies for a "
                         f"k={bm.k} r={bm.r} bit matrix")
    for b in bodies:
        if b.dim() != 1 or b.dtype != torch.uint8 or b.numel() != s * c \
                or b.device != stripes.device or not b.is_contiguous():
            raise ValueError(f"bodies must be contiguous 1-D uint8 tensors "
                             f"of {s * c} bytes on {stripes.device}")
    if stripes.device.type == "cpu":
        plain, crcs = fused_encode_crc_plain(stripes, bm)
        for b, p in zip(bodies, plain):
            b.copy_(p)
        return crcs
    if stripes.device.type != "cuda":
        raise RuntimeError(f"fused_encode_crc: no kernel for device "
                           f"{stripes.device}")
    if bm.tables.device != stripes.device:
        raise ValueError(f"bit matrix on {bm.tables.device}, stripes on "
                         f"{stripes.device}")
    if not stripes.is_contiguous():
        raise ValueError("stripes must be contiguous")
    ptrs = [b.data_ptr() for b in bodies]
    if not one_pass(s, k, bm.r, c, [stripes.data_ptr()] + ptrs):
        raise ValueError(f"the one-pass kernel does not take (S, k, r, C) = "
                         f"{(s, k, bm.r, c)} at these addresses")
    dev = stripes.device
    out = torch.zeros(len(bodies), dtype=torch.int32, device=dev)
    ws = run_bytes(s * c)
    lib = _build.load("fused_encode_crc", _SIGNATURES)
    rc = lib.fused_encode_crc_launch(
        stripes.data_ptr(), bm.tables.data_ptr(),
        device_coalesced_tables(dev).data_ptr(),
        device_advance(dev, ws).data_ptr(),
        (ctypes.c_longlong * len(ptrs))(*ptrs), len(ptrs), s, k, c, ws,
        seed_term(s * c), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_encode_crc_launch failed: cudaError {rc}")
    launches.add(1)
    return out
