"""'cuda' plugin — ErasureCodeCuda: the port's device codec.

Port of ``ceph_tpu/ec/tpu_plugin.py``.  isa-matrix semantics (chunks
match the reference isa plugin bit for bit) with the CUDA backend on by
default: encode()/decode() and the batched stripe entry points
``encode_batch`` / ``decode_batch`` (numpy in and out) run the GF(2^8)
bit-matmul kernel on the card.  ``encode_batch_device`` /
``decode_batch_device`` (ec/matrix_plugin.py) take and return tensors
that are already on the card, with no host copy.
"""
from __future__ import annotations

from .isa import ErasureCodeIsa


class ErasureCodeCuda(ErasureCodeIsa):
    """isa-matrix semantics with ``backend=cuda`` by default."""

    def init(self, profile) -> None:
        profile = dict(profile)
        profile.setdefault("backend", "cuda")
        super().init(profile)
