"""GF(2^8) arithmetic core.

The field is GF(2^8) with the primitive polynomial x^8+x^4+x^3+x^2+1 (0x11d)
and generator element 2 — the same field used by both native EC libraries the
reference builds on (isa-l and jerasure/gf-complete, w=8), so chunk bytes
produced here are comparable byte-for-byte with the reference CPU paths
(reference: src/erasure-code/isa/ErasureCodeIsa.cc, jerasure plugin w=8).

Everything here is host-side numpy, a copy of the JAX package's
``gf/tables.py`` so that this package imports nothing of it.  The CUDA
path consumes only ``expand_to_bitmatrix`` output (GF(2) bit-matrices
that turn the GF(2^8) matrix multiply into a GF(2) bit product — see
ceph_tpu_torch/ops/gf_matmul.py).
"""
from __future__ import annotations

import numpy as np

GF_POLY = 0x11D  # x^8 + x^4 + x^3 + x^2 + 1, primitive over GF(2)


def _build_tables():
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= GF_POLY
    # replicate so exp[log a + log b] needs no mod
    for i in range(255, 512):
        exp[i] = exp[i - 255]
    log[0] = -1  # sentinel; never a valid index
    return exp, log


gf_exp, gf_log = _build_tables()


def gf_mul(a: int, b: int) -> int:
    """Scalar GF(2^8) multiply."""
    if a == 0 or b == 0:
        return 0
    return int(gf_exp[int(gf_log[a]) + int(gf_log[b])])


def gf_pow(a: int, n: int) -> int:
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(gf_exp[(int(gf_log[a]) * n) % 255])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("gf_inv(0)")
    return int(gf_exp[255 - int(gf_log[a])])


def gf_div(a: int, b: int) -> int:
    if b == 0:
        raise ZeroDivisionError("gf_div by 0")
    if a == 0:
        return 0
    return int(gf_exp[int(gf_log[a]) - int(gf_log[b]) + 255])


def _build_mul_table():
    t = np.zeros((256, 256), dtype=np.uint8)
    la = gf_log.copy()
    for a in range(1, 256):
        idx = int(la[a]) + la[1:256]
        t[a, 1:256] = gf_exp[idx]
    return t


# MUL_TABLE[a][b] = a*b in GF(2^8).  64 KiB; the host codec's workhorse.
MUL_TABLE = _build_mul_table()


def gf_mul_scalar(coeff: int, data: np.ndarray) -> np.ndarray:
    """Multiply every byte of ``data`` (uint8 ndarray) by ``coeff``."""
    if coeff == 0:
        return np.zeros_like(data)
    if coeff == 1:
        return data.copy()
    return MUL_TABLE[coeff][data]


def gf_mult_bitmatrix(c: int) -> np.ndarray:
    """8x8 GF(2) matrix M such that bits(c*x) = M @ bits(x) (mod 2).

    Multiplication by a constant is GF(2)-linear; column j holds the bits of
    c * 2^j.  Bit order: index 0 = LSB.
    """
    m = np.zeros((8, 8), dtype=np.uint8)
    for j in range(8):
        p = gf_mul(c, 1 << j)
        for i in range(8):
            m[i, j] = (p >> i) & 1
    return m


def expand_to_bitmatrix(coding: np.ndarray) -> np.ndarray:
    """Expand an (m, k) GF(2^8) coefficient matrix to an (k*8, m*8) GF(2)
    matrix B so that for data-bit row vectors d (length k*8, LSB-first per
    byte), the coding bits are ``(d @ B) mod 2``.

    This is the bridge from GF(2^8) RS coding to a plain 0/1 product:
    the CUDA kernel packs its columns into 64-bit masks, the plain
    PyTorch version runs it as a float32 matmul + parity.
    """
    mm, kk = coding.shape
    out = np.zeros((kk * 8, mm * 8), dtype=np.uint8)
    for r in range(mm):
        for c in range(kk):
            bm = gf_mult_bitmatrix(int(coding[r, c]))  # bits(out) = bm @ bits(in)
            # out_bit[r*8+i] += in_bit[c*8+j] * bm[i, j]
            out[c * 8:(c + 1) * 8, r * 8:(r + 1) * 8] = bm.T
    return out
