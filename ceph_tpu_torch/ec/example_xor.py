"""Minimal XOR-parity plugin — test fixture.

Port of ``ceph_tpu/ec/example_xor.py``, the analog of the reference's
ErasureCodeExample fixture (src/test/erasure-code/ErasureCodeExample.h):
k data chunks + one XOR parity chunk, used to exercise the registry and
the base-class plumbing.
"""
from __future__ import annotations

import numpy as np

from .matrix_plugin import ErasureCodeMatrixRS
from .rs_codec import MatrixRSCodec


class ErasureCodeExampleXor(ErasureCodeMatrixRS):
    def init(self, profile) -> None:
        super().init(profile)
        self.k = self.to_int("k", profile, 2)
        self.m = 1
        self.sanity_check_k(self.k)
        self._init_backend(profile)
        matrix = np.zeros((self.k + 1, self.k), dtype=np.uint8)
        matrix[:self.k] = np.eye(self.k, dtype=np.uint8)
        matrix[self.k, :] = 1
        self.codec = MatrixRSCodec(matrix)
