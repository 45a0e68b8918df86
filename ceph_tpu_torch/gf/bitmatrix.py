"""GF(2) bitmatrix machinery for jerasure's scheduled-XOR code family.

A copy of ``ceph_tpu/gf/bitmatrix.py`` for the port.  The reference's
jerasure plugin runs cauchy_orig/cauchy_good/liberation/blaum_roth/
liber8tion as *bitmatrix* codes (src/erasure-code/jerasure/
ErasureCodeJerasure.cc:259-269,340-348: encode = jerasure_schedule_encode
over an (m*w x k*w) 0/1 matrix); the constructions follow the published
algorithm definitions (J. Plank's jerasure 2.0, the Liberation and
Blaum-Roth code papers).

Semantics: each chunk is a sequence of super-blocks of w *packets*
(packetsize bytes each); coding packet (i, l) is the XOR of every data
packet (j, x) whose bitmatrix entry [i*w+l, j*w+x] is 1.  XOR of byte
packets with 0/1 coefficients is GF(2^8)-linear, so the whole family runs
on the GF(2^8) matrix codec and the bit-matmul kernel over *virtual packet
chunks*: chunk j contributes rows j*w..j*w+w-1.

GF(2^w) scalar arithmetic (matrix construction only; never on the data
path) uses the jerasure/gf-complete default primitive polynomials so the
coefficient matrices match the reference's field choices.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

# jerasure/gf-complete default primitive polynomials (galois.c prim_poly_*)
PRIM_POLY = {4: 0x13, 8: 0x11D, 16: 0x1100B, 32: 0x100400007}


def gfw_mul(a: int, b: int, w: int) -> int:
    """Shift-and-xor GF(2^w) multiply (construction-time only)."""
    poly = PRIM_POLY[w]
    top = 1 << w
    r = 0
    while b:
        if b & 1:
            r ^= a
        b >>= 1
        a <<= 1
        if a & top:
            a ^= poly
    return r


def gfw_pow(a: int, n: int, w: int) -> int:
    r = 1
    base = a
    while n:
        if n & 1:
            r = gfw_mul(r, base, w)
        base = gfw_mul(base, base, w)
        n >>= 1
    return r


def gfw_inv(a: int, w: int) -> int:
    if a == 0:
        raise ZeroDivisionError("gfw_inv(0)")
    return gfw_pow(a, (1 << w) - 2, w)


def gfw_div(a: int, b: int, w: int) -> int:
    return gfw_mul(a, gfw_inv(b, w), w)


def element_bitmatrix(e: int, w: int) -> np.ndarray:
    """w x w GF(2) matrix M with M[l, x] = bit l of e * 2^x: the companion
    representation jerasure_matrix_to_bitmatrix uses per element."""
    m = np.zeros((w, w), dtype=np.uint8)
    v = e
    for x in range(w):
        for l in range(w):
            m[l, x] = (v >> l) & 1
        v = gfw_mul(v, 2, w)
    return m


def n_ones(e: int, w: int) -> int:
    """Ones in the element's bitmatrix (cauchy_n_ones role)."""
    total = 0
    v = e
    for _ in range(w):
        total += bin(v).count("1")
        v = gfw_mul(v, 2, w)
    return total


def matrix_to_bitmatrix(matrix: np.ndarray, w: int) -> np.ndarray:
    """(m, k) GF(2^w) coefficients -> (m*w, k*w) GF(2) bitmatrix
    (jerasure_matrix_to_bitmatrix semantics)."""
    m, k = matrix.shape
    out = np.zeros((m * w, k * w), dtype=np.uint8)
    for i in range(m):
        for j in range(k):
            out[i * w:(i + 1) * w, j * w:(j + 1) * w] = \
                element_bitmatrix(int(matrix[i, j]), w)
    return out


def gf2_invert(mat: np.ndarray) -> np.ndarray:
    """Invert a square 0/1 matrix over GF(2) (Gaussian elimination)."""
    n = mat.shape[0]
    a = mat.astype(np.uint8).copy()
    inv = np.eye(n, dtype=np.uint8)
    for col in range(n):
        piv = None
        for r in range(col, n):
            if a[r, col]:
                piv = r
                break
        if piv is None:
            raise np.linalg.LinAlgError("GF(2) matrix is singular")
        if piv != col:
            a[[col, piv]] = a[[piv, col]]
            inv[[col, piv]] = inv[[piv, col]]
        rows = np.nonzero(a[:, col])[0]
        rows = rows[rows != col]
        a[rows] ^= a[col]
        inv[rows] ^= inv[col]
    return inv


# ---- coefficient-matrix constructions --------------------------------------

def cauchy_original_matrix(k: int, m: int, w: int) -> np.ndarray:
    """cauchy_original_coding_matrix: row i col j = 1/(i ^ (m+j)) over
    GF(2^w); requires k + m <= 2^w."""
    if k + m > (1 << w):
        raise ValueError(f"k+m={k + m} > 2^w for w={w}")
    a = np.zeros((m, k), dtype=np.int64)
    for i in range(m):
        for j in range(k):
            a[i, j] = gfw_inv(i ^ (m + j), w)
    return a


def cauchy_good_matrix(k: int, m: int, w: int) -> np.ndarray:
    """cauchy_good_general_coding_matrix: the original Cauchy matrix
    improved to minimize bitmatrix density (cauchy.c
    cauchy_improve_coding_matrix semantics): normalize row 0 to all ones
    by column division, then divide each later row by whichever of its
    elements minimizes the row's total bitmatrix ones."""
    mat = cauchy_original_matrix(k, m, w)
    # column scaling: make row 0 all ones
    for j in range(k):
        e = int(mat[0, j])
        if e != 1:
            inv = gfw_inv(e, w)
            for i in range(m):
                mat[i, j] = gfw_mul(int(mat[i, j]), inv, w)
    # row scaling: greedily minimize ones
    for i in range(1, m):
        best = sum(n_ones(int(e), w) for e in mat[i])
        best_div = None
        for j in range(k):
            e = int(mat[i, j])
            if e != 1:
                inv = gfw_inv(e, w)
                tot = sum(n_ones(gfw_mul(int(x), inv, w), w)
                          for x in mat[i])
                if tot < best:
                    best = tot
                    best_div = inv
        if best_div is not None:
            for j in range(k):
                mat[i, j] = gfw_mul(int(mat[i, j]), best_div, w)
    return mat


def liberation_bitmatrix(k: int, w: int) -> np.ndarray:
    """Liberation RAID-6 bitmatrix (Plank, 'The RAID-6 Liberation Codes';
    liberation.c liberation_coding_bitmatrix semantics): m=2, w prime,
    k <= w.  Row block 0: identities (parity).  Row block 1, column j: the
    identity shifted down by j, plus for j > 0 one extra 1 at row
    i = (j*(w-1)/2) mod w, column (i+j-1) mod w."""
    if k > w:
        raise ValueError("liberation needs k <= w")
    if not _is_prime(w):
        raise ValueError("liberation needs prime w")
    bm = np.zeros((2 * w, k * w), dtype=np.uint8)
    for j in range(k):
        bm[np.arange(w), j * w + np.arange(w)] = 1            # parity I
        for i in range(w):
            bm[w + i, j * w + (j + i) % w] = 1                # shifted I
        if j > 0:
            i = (j * ((w - 1) // 2)) % w
            bm[w + i, j * w + (i + j - 1) % w] = 1            # extra bit
    return bm


def blaum_roth_bitmatrix(k: int, w: int) -> np.ndarray:
    """Blaum-Roth RAID-6 bitmatrix: m=2, w+1 prime, k <= w.

    Over the ring F2[x]/M_p(x) with M_p = 1 + x + ... + x^w (p = w+1
    prime), the Q row's block for column j is the matrix of
    multiplication by x^j; multiplication by x maps coefficient vector v
    to (v_{w-1}, v_0 + v_{w-1}, ..., v_{w-2} + v_{w-1})."""
    if k > w:
        raise ValueError("blaum_roth needs k <= w")
    if not _is_prime(w + 1):
        raise ValueError("blaum_roth needs w+1 prime")
    T = np.zeros((w, w), dtype=np.uint8)
    for i in range(1, w):
        T[i, i - 1] = 1
    T[:, w - 1] ^= 1  # x^w = 1 + x + ... + x^{w-1}
    bm = np.zeros((2 * w, k * w), dtype=np.uint8)
    blk = np.eye(w, dtype=np.uint8)
    for j in range(k):
        bm[:w, j * w:(j + 1) * w] = np.eye(w, dtype=np.uint8)
        bm[w:, j * w:(j + 1) * w] = blk
        blk = (blk @ T) % 2
    return bm


def liber8tion_bitmatrix(k: int) -> np.ndarray:
    """liber8tion-class RAID-6 bitmatrix for w=8, k <= 8, m=2.

    As in the JAX package: P row = XOR of all columns, Q block for column
    j = the companion matrix of multiplication by 2^j in GF(2^8), i.e.
    the RAID-6 [1..1; 1,2,4,..] matrix as a bitmatrix (MDS for any two
    erasures; denser than Plank's searched optimum, byte-stable and
    corpus-pinned)."""
    w = 8
    if k > 8:
        raise ValueError("liber8tion needs k <= 8")
    mat = np.zeros((2, k), dtype=np.int64)
    mat[0, :] = 1
    for j in range(k):
        mat[1, j] = gfw_pow(2, j, w)
    return matrix_to_bitmatrix(mat, w)


def _is_prime(v: int) -> bool:
    if v < 2:
        return False
    for d in range(2, int(v ** 0.5) + 1):
        if v % d == 0:
            return False
    return True


# ---- packet-layout codec ---------------------------------------------------

class BitmatrixPacketCodec:
    """Chunk-level executor for a (m*w, k*w) bitmatrix with jerasure's
    packet layout (jerasure_schedule_encode semantics).

    Exposes the MatrixRSCodec surface (``matrix``, ``encode``, ``decode``)
    over whole chunks; internally chunks are reshaped into virtual packet
    chunks and run through a GF(2^8) matrix codec whose coefficients are
    the 0/1 bitmatrix (XOR of byte packets).  ``matrix`` is the virtual
    systematic matrix, so the device backend (ops/gf_matmul.DeviceRSBackend)
    runs the same code on the bit-matmul kernel.
    """

    def __init__(self, coding_bitmatrix: np.ndarray, k: int, m: int,
                 w: int, packetsize: int):
        from ..ec.rs_codec import MatrixRSCodec
        mw, kw = coding_bitmatrix.shape
        if (mw, kw) != (m * w, k * w):
            raise ValueError(f"bitmatrix {coding_bitmatrix.shape} is not "
                             f"({m * w}, {k * w})")
        self.k, self.m, self.w = k, m, w
        self.packetsize = packetsize
        full = np.zeros(((k + m) * w, k * w), dtype=np.uint8)
        full[:k * w] = np.eye(k * w, dtype=np.uint8)
        full[k * w:] = coding_bitmatrix
        self.matrix = full
        self.inner = MatrixRSCodec(full)

    # -- layout -------------------------------------------------------------
    def to_virtual(self, chunks: np.ndarray) -> np.ndarray:
        """(n, C) chunks -> (n*w, C//w) virtual packet chunks."""
        n, C = chunks.shape
        w, ps = self.w, self.packetsize
        if C % (w * ps):
            raise ValueError(f"chunk size {C} is not a multiple of "
                             f"w*packetsize={w * ps}")
        nb = C // (w * ps)
        v = chunks.reshape(n, nb, w, ps).transpose(0, 2, 1, 3)
        return np.ascontiguousarray(v).reshape(n * w, nb * ps)

    def from_virtual(self, virt: np.ndarray, n: int) -> np.ndarray:
        """(n*w, C//w) virtual chunks -> (n, C)."""
        w, ps = self.w, self.packetsize
        nw, cv = virt.shape
        if nw != n * w or cv % ps:
            raise ValueError(f"virtual chunks {virt.shape} do not hold {n} "
                             f"chunks of packet size {ps}")
        nb = cv // ps
        c = virt.reshape(n, w, nb, ps).transpose(0, 2, 1, 3)
        return np.ascontiguousarray(c).reshape(n, nb * w * ps)

    # -- chunk-level MatrixRSCodec surface -----------------------------------
    def encode(self, data: np.ndarray) -> np.ndarray:
        """(k, C) -> (m, C) coding chunks (host XOR path)."""
        dv = self.to_virtual(data)
        cv = self.inner.encode(dv)
        return self.from_virtual(cv, self.m)

    def decode(self, chunks: Dict[int, np.ndarray],
               want: Sequence[int]) -> Dict[int, np.ndarray]:
        if len(chunks) < self.k:
            raise IOError(
                f"need at least k={self.k} chunks, have {len(chunks)}")
        w = self.w
        virt: Dict[int, np.ndarray] = {}
        for cid, buf in chunks.items():
            rows = self.to_virtual(buf[None, :])
            for l in range(w):
                virt[cid * w + l] = rows[l]
        want_rows = [c * w + l for c in want for l in range(w)]
        out_rows = self.inner.decode(virt, want_rows)
        out: Dict[int, np.ndarray] = {}
        for c in want:
            stack = np.stack([out_rows[c * w + l] for l in range(w)])
            out[c] = self.from_virtual(stack, 1)[0]
        return out
