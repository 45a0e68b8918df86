"""Fused device-resident EC encode: GF matmul + body layout + crc32c.

Port of ``ceph_tpu/ops/resident.py`` (K5, ``_fused_encode_crc``).  One
call takes the (S, k, C) stripe batch and produces both the per-shard
concatenated bodies, still on the card, and their crc32c digests
(``ops/crc32c_device.py``, bit-identical to ``utils/crc32c.py``).  The
only device->host traffic of the whole encode->store path is the 4*n
bytes of CRCs, and that copy is also the encode's completion fence.
Body i is chunk i of every stripe concatenated (``allsh[:, i, :]``
flattened), as on the host path, so stored bytes and HashInfo digests
equal a residency-off twin's by construction.

On the card the fused call is one launch of the one-pass kernel
(``ops/fused_encode_crc.py``, ``csrc/fused_encode_crc.cu``) wherever it
takes the shape: C a multiple of 2048, 16-byte aligned stripes and
bodies, n <= 128.  ``one_pass`` decides that from shape and addresses
before any launch.  Other shapes take the two-launch form
(``_fused_encode_crc_two_pass``): the GF(2^8) bit-matmul
(``gf_pallas.gf_bit_matmul_kernel``) into its own (S, m, C) output, then
one crc32c launch (``crc32c_gather_kernel``) that reads chunk column i of
the stripes or of the coding output, writes it into body i and hashes it.
A failed build or launch raises in either form; neither falls back to
the other.  Each body is its own allocation, so that the residency
budget's byte count is what the card frees when a shard goes
(``os_store/device_shard.py``).  On the CPU the same routes run the
kernels' plain versions.  ``launches.n`` counts fused calls on the card
in either form; ``fused_encode_crc.fused_encode_crc_plain`` is the
reference the card's result is held against.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..os_store.device_shard import DeviceShard
from .crc32c_device import crc32c_gather_kernel, to_u32
from .fused_encode_crc import fused_encode_crc_kernel, one_pass
from .gf_matmul import DeviceRSBackend
from .gf_pallas import BitMatrix, LaunchCounter, gf_bit_matmul_kernel

launches = LaunchCounter()


def _bodies(stripes: torch.Tensor, n: int) -> List[torch.Tensor]:
    s, _, c = stripes.shape
    return [torch.empty(s * c, dtype=torch.uint8, device=stripes.device)
            for _ in range(n)]


def _fused_encode_crc_two_pass(stripes: torch.Tensor, enc_bits: BitMatrix,
                               bodies: Optional[List[torch.Tensor]] = None) \
        -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The two-launch form: K1 into an (S, m, C) intermediate, then the
    crc32c gather of every chunk column into its body.  Uncounted in
    ``launches`` (its kernels count their own)."""
    coding = gf_bit_matmul_kernel(stripes, enc_bits)     # (S, m, C)
    k = stripes.shape[1]
    pieces = [stripes[:, i] for i in range(k)] + \
        [coding[:, j] for j in range(coding.shape[1])]
    if bodies is None:
        bodies = _bodies(stripes, len(pieces))
    return bodies, crc32c_gather_kernel(pieces, bodies)


def _fused_encode_crc(stripes: torch.Tensor, enc_bits: BitMatrix) \
        -> Tuple[List[torch.Tensor], torch.Tensor]:
    """(S, k, C) uint8 -> (n bodies of S*C bytes, (n,) int32 CRC bits),
    all on ``stripes``' device: one launch of the one-pass kernel where
    ``one_pass`` takes the shape, the two-launch form elsewhere."""
    s, k, c = stripes.shape
    bodies = _bodies(stripes, k + enc_bits.r)
    if one_pass(s, k, enc_bits.r, c,
                [stripes.data_ptr()] + [b.data_ptr() for b in bodies]):
        crcs = fused_encode_crc_kernel(stripes, enc_bits, bodies)
    else:
        crcs = _fused_encode_crc_two_pass(stripes, enc_bits, bodies)[1]
    if stripes.device.type == "cuda":
        launches.n += 1
    return bodies, crcs


def resident_capable(ec_impl) -> bool:
    """True when ``ec_impl``'s device path is the plain row-independent
    matrix matmul on raw chunks, the only layout the fused call models:
    no chunk mapping, ``mesh_row_shardable``, and a ``DeviceRSBackend``
    behind ``device()``."""
    if ec_impl.get_chunk_mapping():
        return False
    if not getattr(ec_impl, "mesh_row_shardable", False):
        return False
    if not hasattr(ec_impl, "device"):
        return False
    return isinstance(ec_impl.device(), DeviceRSBackend)


def encode_resident_shards(ec_impl, stripes: Union[np.ndarray, torch.Tensor]) \
        -> Optional[Dict[int, DeviceShard]]:
    """Encode a (S, k, C) stripe batch into device-resident shards.

    ``stripes`` is host numpy (uploaded to the codec's device) or a
    tensor already on that device.  Returns shard id -> ``DeviceShard``
    for all n shards, or None when the codec's layout rules the fused
    call out."""
    if not resident_capable(ec_impl):
        return None
    backend: DeviceRSBackend = ec_impl.device()
    if isinstance(stripes, np.ndarray):
        data = torch.from_numpy(np.ascontiguousarray(stripes, dtype=np.uint8))
        data = data.to(backend.device)
    else:
        data = stripes
        if data.device != backend.device and not (
                data.device.type == backend.device.type == "cuda"
                and backend.device.index is None):
            raise ValueError(f"stripes on {data.device}, codec on "
                             f"{backend.device}")
    if data.dim() != 3 or data.dtype != torch.uint8:
        raise ValueError(f"stripes must be (S, k, C) uint8, got "
                         f"{tuple(data.shape)} {data.dtype}")
    bodies, crcs = _fused_encode_crc(data.contiguous(), backend.enc_bits)
    crcs_np = to_u32(crcs)                 # the 4*n-byte fetch and fence
    length = data.shape[0] * data.shape[2]
    return {i: DeviceShard(body, length, int(crcs_np[i]))
            for i, body in enumerate(bodies)}
