"""XOR all-reduce of partial products (K9x): the CUDA kernel, its wrapper
and its plain PyTorch version.

Port of the collective in ``ceph_tpu/parallel/ec.py::_collective_decode_jit``
(``lax.psum`` of int32 bit-accumulators over the shard axis, then
``acc & 1``).  The port's survivor-sharded decode gives each member a u8
partial product instead (K1 on its k-slice), and over GF(2) the parity of
the summed accumulators is the XOR of the partials, so the reduction moves
one byte per output byte where the JAX collective moves 32 (an int32 per
output bit).  The kernel is ``csrc/mesh_xor.cu``.

- ``xor_reduce(partials)`` takes (n, ...) uint8 and returns the XOR over
  the first axis.  A CUDA tensor launches the kernel on the current
  stream or raises; only a tensor that lies on the CPU takes the plain
  version.  ``launches.n`` counts kernel launches.
- ``xor_reduce_plain(partials)`` is chained ``torch.bitwise_xor``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .gf_pallas import LaunchCounter

_SIGNATURES = {
    "mesh_xor_launch": (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
         ctypes.c_void_p],
        ctypes.c_int),
}

launches = LaunchCounter()          # K9x


def xor_reduce_plain(partials: torch.Tensor) -> torch.Tensor:
    """(n, ...) uint8 -> the XOR of the n partials, chained
    ``torch.bitwise_xor`` on the tensor's device."""
    acc = partials[0].clone()
    for p in range(1, partials.shape[0]):
        torch.bitwise_xor(acc, partials[p], out=acc)
    return acc


def xor_reduce(partials: torch.Tensor, out: torch.Tensor = None
               ) -> torch.Tensor:
    """(n, ...) uint8 -> the XOR over the first axis, into *out* when
    given.  A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel on the current stream or raises."""
    if partials.dtype != torch.uint8 or partials.dim() < 1 \
            or partials.shape[0] < 1:
        raise ValueError(f"partials must be (n>=1, ...) uint8, got "
                         f"{tuple(partials.shape)} {partials.dtype}")
    if partials.device.type == "cpu":
        res = xor_reduce_plain(partials)
        if out is None:
            return res
        out.copy_(res)
        return out
    if partials.device.type != "cuda":
        raise RuntimeError(f"xor_reduce: no kernel for device "
                           f"{partials.device}")
    if not partials.is_contiguous():
        raise ValueError("partials must be contiguous")
    if out is None:
        out = torch.empty(partials.shape[1:], dtype=torch.uint8,
                          device=partials.device)
    elif (out.shape != partials.shape[1:] or out.dtype != torch.uint8
          or out.device != partials.device or not out.is_contiguous()):
        raise ValueError("out must be a contiguous uint8 tensor of the "
                         "partials' shape on their device")
    nbytes = out.numel()
    if nbytes == 0:
        return out
    lib = _build.load("mesh_xor", _SIGNATURES)
    stream = torch.cuda.current_stream(partials.device).cuda_stream
    rc = lib.mesh_xor_launch(partials.data_ptr(), out.data_ptr(), nbytes,
                             int(partials.shape[0]), stream)
    if rc != 0:
        raise RuntimeError(f"mesh_xor_launch failed: cudaError {rc}")
    launches.add(1)
    return out
