"""'jerasure' plugin: RS/Cauchy matrix and bitmatrix-schedule techniques.

Port of ``ceph_tpu/ec/jerasure.py``, the reference jerasure plugin's
technique set (src/erasure-code/jerasure/ErasureCodeJerasure.h:82-258;
defaults k=7 m=3 w=8 at :90-92):

- reed_sol_van: Vandermonde-derived systematic matrix
  (reed_sol_vandermonde_coding_matrix; ErasureCodeJerasure.cc:155).
- reed_sol_r6_op: RAID6 coding rows [1,1,..] and [1,2,4,..] (m forced to 2).
- cauchy_orig / cauchy_good: Cauchy coefficient matrices run as bitmatrix
  packet codes (ErasureCodeJerasure.cc:259-269, jerasure_schedule_encode).
- liberation / blaum_roth / liber8tion: minimal-density RAID-6 bitmatrix
  codes (m=2), same packet execution (ErasureCodeJerasure.cc:340-348).

On the device: reed_sol_* at w=8 run the GF(2^8) bit-matmul kernel (K1)
on whole chunks; at w=16/32 the word-layout kernel (K3,
``DeviceWordRSBackend``); the bitmatrix family runs K1 over the virtual
packet layout, which ``encode_batch_device`` builds with a torch permute
on the device (a layout change, not the code's arithmetic).  Word and
bitmatrix codes decode on the host codec, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from ..gf.bitmatrix import (
    BitmatrixPacketCodec, _is_prime, blaum_roth_bitmatrix,
    cauchy_good_matrix, cauchy_original_matrix, liber8tion_bitmatrix,
    liberation_bitmatrix, matrix_to_bitmatrix,
)
from ..gf.matrices import jerasure_reed_sol_van_matrix
from ..gf.tables import gf_pow
from ..gf.word_codec import (WordMatrixCodec, reed_sol_r6_matrix_w,
                             reed_sol_van_matrix_w)
from .matrix_plugin import ErasureCodeMatrixRS
from .rs_codec import MatrixRSCodec

DEFAULT_K = 7
DEFAULT_M = 3
DEFAULT_W = 8
DEFAULT_PACKETSIZE = 2048  # ErasureCodeJerasure.h:141 DEFAULT_PACKETSIZE

TECHNIQUES = ("reed_sol_van", "reed_sol_r6_op", "cauchy_orig", "cauchy_good",
              "liberation", "blaum_roth", "liber8tion")
BITMATRIX_TECHNIQUES = ("cauchy_orig", "cauchy_good", "liberation",
                        "blaum_roth", "liber8tion")


def reed_sol_r6_matrix(k: int) -> np.ndarray:
    """RAID6 coding rows: parity row of ones, Q row of powers of 2."""
    m = np.zeros((2, k), dtype=np.uint8)
    m[0, :] = 1
    for j in range(k):
        m[1, j] = gf_pow(2, j)
    return m


def _systematic(coding: np.ndarray, dtype=np.uint8) -> np.ndarray:
    m, k = coding.shape
    full = np.zeros((k + m, k), dtype=dtype)
    full[:k] = np.eye(k, dtype=dtype)
    full[k:] = coding
    return full


class ErasureCodeJerasure(ErasureCodeMatrixRS):

    def __init__(self, technique: str = "reed_sol_van"):
        super().__init__()
        self.technique = technique
        self.w = DEFAULT_W
        self.packetsize = 0
        self.per_chunk_alignment = False

    @property
    def is_bitmatrix(self) -> bool:
        return self.technique in BITMATRIX_TECHNIQUES

    @property
    def is_word_code(self) -> bool:
        return isinstance(self.codec, WordMatrixCodec)

    def init(self, profile) -> None:
        super().init(profile)
        self.parse_mapping(profile)
        self.technique = profile.get("technique", self.technique)
        if self.technique not in TECHNIQUES:
            raise ValueError(f"technique={self.technique} not in {TECHNIQUES}")
        # per-technique defaults (ErasureCodeJerasure.h constructors)
        def_k, def_m, def_w = DEFAULT_K, DEFAULT_M, DEFAULT_W
        if self.technique == "liberation":
            def_k, def_m, def_w = 2, 2, 7
        elif self.technique in ("blaum_roth", "liber8tion"):
            def_k, def_m, def_w = 2, 2, 8 if self.technique == "liber8tion" \
                else 6
        self.k = self.to_int("k", profile, def_k)
        self.m = self.to_int("m", profile, def_m)
        self.w = self.to_int("w", profile, def_w)
        self.packetsize = self.to_int("packetsize", profile,
                                      DEFAULT_PACKETSIZE
                                      if self.is_bitmatrix else 0)
        self.per_chunk_alignment = self.to_bool(
            "jerasure-per-chunk-alignment", profile, False)
        self.sanity_check_k(self.k)
        self._init_backend(profile)
        if self.technique in ("reed_sol_van", "reed_sol_r6_op"):
            if self.technique == "reed_sol_r6_op":
                self.m = 2
            if self.w not in (8, 16, 32):
                raise ValueError(f"{self.technique}: w={self.w} not in "
                                 "8|16|32")
            if self.technique == "reed_sol_r6_op":
                coding = (reed_sol_r6_matrix(self.k) if self.w == 8
                          else reed_sol_r6_matrix_w(self.k, self.w))
            else:
                coding = (jerasure_reed_sol_van_matrix(self.k, self.m)
                          if self.w == 8
                          else reed_sol_van_matrix_w(self.k, self.m, self.w))
            if self.w == 8:
                self.codec = MatrixRSCodec(_systematic(coding))
            else:
                # LE-word layout codec (jerasure_matrix_encode role)
                self.codec = WordMatrixCodec(
                    _systematic(coding, np.int64), self.w)
        else:
            self._init_bitmatrix()
        self._profile.update({"k": str(self.k), "m": str(self.m),
                              "w": str(self.w),
                              "technique": self.technique})
        if self.is_bitmatrix:
            self._profile["packetsize"] = str(self.packetsize)

    def _init_bitmatrix(self) -> None:
        if self.packetsize <= 0:
            raise ValueError(
                f"technique={self.technique} requires packetsize > 0")
        if self.packetsize % 4:
            # ErasureCodeJerasure.cc:390-397 check_packetsize
            raise ValueError("packetsize must be a multiple of 4")
        if self.technique == "cauchy_orig":
            bm = matrix_to_bitmatrix(
                cauchy_original_matrix(self.k, self.m, self.w), self.w)
        elif self.technique == "cauchy_good":
            bm = matrix_to_bitmatrix(
                cauchy_good_matrix(self.k, self.m, self.w), self.w)
        elif self.technique == "liberation":
            self.m = 2
            if self.k > self.w or not _is_prime(self.w):
                raise ValueError(
                    f"liberation needs prime w >= k (k={self.k} w={self.w})")
            bm = liberation_bitmatrix(self.k, self.w)
        elif self.technique == "blaum_roth":
            self.m = 2
            if self.k > self.w or not _is_prime(self.w + 1):
                raise ValueError(
                    f"blaum_roth needs w+1 prime, w >= k "
                    f"(k={self.k} w={self.w})")
            bm = blaum_roth_bitmatrix(self.k, self.w)
        else:  # liber8tion
            self.m = 2
            self.w = 8
            if self.k > 8:
                raise ValueError("liber8tion needs k <= 8")
            bm = liber8tion_bitmatrix(self.k)
        self.codec = BitmatrixPacketCodec(bm, self.k, self.m, self.w,
                                          self.packetsize)

    # -- device layout ------------------------------------------------------
    def device(self):
        if self.is_word_code:
            if self._device is None:
                from ..ops.gf_matmul import DeviceWordRSBackend
                self._device = DeviceWordRSBackend(
                    self.codec.matrix, self.w, self.torch_device)
            return self._device
        return super().device()

    def _stripe_block(self) -> int:
        if self.is_bitmatrix:
            return self.w * self.packetsize
        if self.is_word_code:
            return self.w // 8
        return 1

    @property
    def mesh_row_shardable(self) -> bool:
        # bitmatrix/word layouts change the data layout before the
        # product, which the fused resident encode does not model
        return not (self.is_bitmatrix or self.is_word_code)

    @property
    def _device_decode_supported(self) -> bool:
        # bitmatrix/word layouts decode through the host codec (their
        # device backends consume virtual/word layouts, not whole chunks)
        return not (self.is_bitmatrix or self.is_word_code)

    def encode_batch_device(self, data: torch.Tensor) -> torch.Tensor:
        """(S, k, C) uint8 tensor on the backend's device -> (S, m, C).
        Bitmatrix codes go through the virtual packet layout
        (S, k, C) -> (S, k*w, C/w), reshaped on the device."""
        if not self.is_bitmatrix:
            return super().encode_batch_device(data)
        self._check_stripe(data.shape[2])
        s, k, c = data.shape
        w, ps, m = self.w, self.packetsize, self.m
        nb = c // (w * ps)
        dv = data.reshape(s, k, nb, w, ps).permute(0, 1, 3, 2, 4).reshape(
            s, k * w, nb * ps)
        cv = self.device().encode_device(dv)           # (S, m*w, C/w)
        return cv.reshape(s, m, w, nb, ps).permute(0, 1, 3, 2, 4).reshape(
            s, m, c)

    # -- sizing -------------------------------------------------------------
    def get_alignment(self) -> int:
        if self.is_bitmatrix:
            # ErasureCodeJerasureCauchy::get_alignment
            # (ErasureCodeJerasure.cc:272-283): per-chunk = w*packetsize;
            # whole-object = k*w*packetsize*sizeof(int), widened to the
            # vector word size when misaligned
            if self.per_chunk_alignment:
                return self.w * self.packetsize
            alignment = self.k * self.w * self.packetsize * 4
            if (self.w * self.packetsize * 4) % 16:
                alignment = self.k * self.w * self.packetsize * 16
            return alignment
        # ErasureCodeJerasureReedSolomonVandermonde::get_alignment:
        # k*w*sizeof(int) when not per-chunk (w=8 => 32k), else
        # w*LARGEST_VECTOR_WORDSIZE (=16) per chunk
        if self.per_chunk_alignment:
            return self.w * 16
        return self.k * self.w * 4

    def get_chunk_size(self, object_size: int) -> int:
        # jerasure semantics (ErasureCodeJerasure.cc get_chunk_size): pad the
        # whole object to alignment, then divide by k (unlike isa)
        alignment = self.get_alignment()
        if self.per_chunk_alignment:
            chunk_size = (object_size + self.k - 1) // self.k
            modulo = chunk_size % alignment
            if modulo:
                chunk_size += alignment - modulo
            return chunk_size
        tail = object_size % alignment
        padded = object_size + (alignment - tail if tail else 0)
        return padded // self.k
