"""'isa' plugin: RS codec with isa-l matrix semantics.

Port of ``ceph_tpu/ec/isa.py``.  Reproduces the reference isa plugin's
coding matrices and parameter rules (src/erasure-code/isa/ErasureCodeIsa.cc):
technique=reed_sol_van selects the isa-l Vandermonde generator
(gf_gen_rs_matrix, :383-386) with the MDS safety clamps (k<=32, m<=4,
k<=21 when m=4; :330-361); technique=cauchy selects gf_gen_cauchy1_matrix.
Alignment = EC_ISA_ADDRESS_ALIGNMENT (32, src/erasure-code/isa/xor_op.h:28).
"""
from __future__ import annotations

import logging

from ..gf.matrices import gf_gen_rs_matrix, gf_gen_cauchy1_matrix
from .matrix_plugin import ErasureCodeMatrixRS
from .rs_codec import MatrixRSCodec

log = logging.getLogger(__name__)

DEFAULT_K = 7
DEFAULT_M = 3


class ErasureCodeIsa(ErasureCodeMatrixRS):
    # the isa and cuda plugins share matrix semantics by construction, so
    # their requests of one (technique, k, m) share a dispatch flush
    signature_family = "isa-matrix"

    def __init__(self):
        super().__init__()
        self.technique = "reed_sol_van"

    def init(self, profile) -> None:
        super().init(profile)
        self.parse_mapping(profile)
        self.technique = profile.get("technique", "reed_sol_van")
        if self.technique not in ("reed_sol_van", "cauchy"):
            raise ValueError(f"technique={self.technique} must be "
                             "reed_sol_van or cauchy")
        self.k = self.to_int("k", profile, DEFAULT_K)
        self.m = self.to_int("m", profile, DEFAULT_M)
        self.sanity_check_k(self.k)
        if self.technique == "reed_sol_van":
            # MDS safety clamps, mirroring ErasureCodeIsa.cc:330-361
            if self.k > 32:
                log.warning("Vandermonde: k=%d > 32, reverting to k=32", self.k)
                self.k = 32
            if self.m > 4:
                log.warning("Vandermonde: m=%d > 4, reverting to m=4", self.m)
                self.m = 4
            if self.m == 4 and self.k > 21:
                log.warning("Vandermonde: k=%d > 21 with m=4, reverting to "
                            "k=21", self.k)
                self.k = 21
        self._init_backend(profile)
        if self.technique == "cauchy":
            matrix = gf_gen_cauchy1_matrix(self.k + self.m, self.k)
        else:
            matrix = gf_gen_rs_matrix(self.k + self.m, self.k)
        self.codec = MatrixRSCodec(matrix)
        self._profile.update({"k": str(self.k), "m": str(self.m),
                              "technique": self.technique})
