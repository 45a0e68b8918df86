"""'cuda' plugin — ErasureCodeCuda: the port's device codec.

Port of ``ceph_tpu/ec/tpu_plugin.py``.  isa-matrix semantics (chunks
match the reference isa plugin bit for bit) with the CUDA backend on by
default: encode()/decode() and the batched stripe entry points
``encode_batch`` / ``decode_batch`` (numpy in and out) run the GF(2^8)
bit-matmul kernel on the card.  ``encode_batch_device`` /
``decode_batch_device`` take and return tensors that are already on the
card, with no host copy.
"""
from __future__ import annotations

from typing import Sequence

import torch

from .isa import ErasureCodeIsa


class ErasureCodeCuda(ErasureCodeIsa):
    """isa-matrix semantics with ``backend=cuda`` by default."""

    def init(self, profile) -> None:
        profile = dict(profile)
        profile.setdefault("backend", "cuda")
        super().init(profile)

    def encode_batch_device(self, data: torch.Tensor) -> torch.Tensor:
        """(S, k, C) uint8 tensor on the backend's device -> (S, m, C)."""
        return self.device().encode_device(data)

    def decode_batch_device(self, survivors: torch.Tensor,
                            srcs: Sequence[int],
                            want_rows: Sequence[int]) -> torch.Tensor:
        """*survivors* (S, len(srcs), C) stacked in ``srcs`` order (logical
        chunk ids) -> the data rows ``want_rows``, (S, len(want_rows), C)."""
        return self.device().decode_data_device(survivors, tuple(srcs),
                                                tuple(want_rows))
