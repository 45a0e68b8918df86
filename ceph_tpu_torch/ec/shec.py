"""SHEC — shingled erasure code (k, m, c).

Port of ``ceph_tpu/ec/shec.py``; semantics of the reference plugin
(src/erasure-code/shec/ErasureCodeShec.{h,cc}): the coding matrix is a
Vandermonde RS matrix with shingled zero runs so each parity covers only a
sliding window of the data chunks (shec_reedsolomon_coding_matrix,
:456-523).  The MULTIPLE technique splits parities into two shingle groups
chosen to minimize the average recovery cost
(shec_calc_recovery_efficiency1, :416-455); SINGLE keeps one group.

Decode searches all 2^m parity subsets for the smallest invertible
recovery system (shec_make_decoding_matrix, :524-700), memoized like the
reference's ErasureCodeShecTableCache; minimum_to_decode runs the same
search and returns exactly the chunks that system reads.

On the backend's device: encode runs ``DeviceRSBackend`` (the GF(2^8)
bit-matmul kernel); ``decode_batch`` runs the recovery subsystem through
the same kernel with a per-signature ``BitMatrix`` cache.  As in the JAX
package, ``decode_chunks`` and the re-encode of erased parities in
``decode_batch`` run on the host.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..gf.matrices import gf_invert_matrix, jerasure_reed_sol_van_matrix
from ..gf.tables import expand_to_bitmatrix, gf_mul_scalar
from .base import ErasureCode
from .interface import ErasureCodeProfile

SINGLE = 1
MULTIPLE = 0

DEFAULT_K, DEFAULT_M, DEFAULT_C, DEFAULT_W = 4, 3, 2, 8

# reference cache bound, and the per-codec bound of recovery bit matrices
DECODE_CACHE_ENTRIES = 2516
SYS_BITS_ENTRIES = 256


def _recovery_efficiency1(k: int, m1: int, m2: int, c1: int, c2: int
                          ) -> float:
    """Average chunks read per single-chunk recovery (reference
    shec_calc_recovery_efficiency1)."""
    if m1 < c1 or m2 < c2:
        return -1.0
    if (m1 == 0 and c1 != 0) or (m2 == 0 and c2 != 0):
        return -1.0
    r_eff_k = [100000000] * k
    r_e1 = 0.0
    for group_m, group_c in ((m1, c1), (m2, c2)):
        for rr in range(group_m):
            start = ((rr * k) // group_m) % k
            end = (((rr + group_c) * k) // group_m) % k
            cost = ((rr + group_c) * k) // group_m - (rr * k) // group_m
            cc = start
            first = True
            while first or cc != end:
                first = False
                r_eff_k[cc] = min(r_eff_k[cc], cost)
                cc = (cc + 1) % k
            r_e1 += cost
    r_e1 += sum(r_eff_k)
    return r_e1 / (k + m1 + m2)


def shec_coding_matrix(k: int, m: int, c: int,
                       technique: int) -> np.ndarray:
    """Vandermonde rows with shingled zero windows
    (shec_reedsolomon_coding_matrix)."""
    if technique == SINGLE:
        m1, c1 = 0, 0
    else:
        best = (-1, -1)
        min_r = 100.0
        for c1_try in range(c // 2 + 1):
            for m1_try in range(m + 1):
                c2t, m2t = c - c1_try, m - m1_try
                if m1_try < c1_try or m2t < c2t:
                    continue
                if (m1_try == 0) != (c1_try == 0):
                    continue
                if (m2t == 0) != (c2t == 0):
                    continue
                r = _recovery_efficiency1(k, m1_try, m2t, c1_try, c2t)
                if min_r - r > np.finfo(float).eps and r < min_r:
                    min_r = r
                    best = (c1_try, m1_try)
        c1, m1 = best
    m2, c2 = m - m1, c - c1
    matrix = jerasure_reed_sol_van_matrix(k, m).astype(np.int64)
    for group_m, group_c, base in ((m1, c1, 0), (m2, c2, m1)):
        for rr in range(group_m):
            end = ((rr * k) // group_m) % k
            start = (((rr + group_c) * k) // group_m) % k
            cc = start
            while cc != end:
                matrix[base + rr, cc] = 0
                cc = (cc + 1) % k
    return matrix.astype(np.uint8)


class ErasureCodeShec(ErasureCode):
    """ErasureCodeShecReedSolomonVandermonde equivalent (w=8 lanes)."""

    _table_cache: Dict[Tuple, np.ndarray] = {}
    _decode_cache: Dict[Tuple, Tuple] = {}
    _cache_lock = threading.Lock()

    def __init__(self):
        super().__init__()
        self.k = DEFAULT_K
        self.m = DEFAULT_M
        self.c = DEFAULT_C
        self.w = DEFAULT_W
        self.technique = MULTIPLE
        self.matrix: Optional[np.ndarray] = None
        self._device = None
        self._sys_bits: "OrderedDict[tuple, object]" = OrderedDict()

    # ---- profile ----------------------------------------------------------
    def init(self, profile: ErasureCodeProfile) -> None:
        self._parse(profile)
        self._prepare()
        super().init(profile)
        self.parse_mapping(profile)

    def _parse(self, profile: ErasureCodeProfile) -> None:
        self._init_backend(profile)
        technique = profile.get("technique", "multiple")
        if technique not in ("single", "multiple"):
            raise ValueError(f"technique={technique} must be single or "
                             "multiple")
        self.technique = SINGLE if technique == "single" else MULTIPLE
        has = [x in profile and profile[x] != "" for x in ("k", "m", "c")]
        if not any(has):
            k, m, c = DEFAULT_K, DEFAULT_M, DEFAULT_C
        elif not all(has):
            raise ValueError("(k, m, c) must all be chosen")
        else:
            k = self.to_int("k", profile, DEFAULT_K)
            m = self.to_int("m", profile, DEFAULT_M)
            c = self.to_int("c", profile, DEFAULT_C)
        # reference MDS-safety limits (ErasureCodeShec.cc:309-333)
        if k <= 0 or m <= 0 or c <= 0:
            raise ValueError(f"(k={k}, m={m}, c={c}) must be positive")
        if m < c:
            raise ValueError(f"c={c} must be <= m={m}")
        if k > 12:
            raise ValueError(f"k={k} must be <= 12")
        if k + m > 20:
            raise ValueError(f"k+m={k+m} must be <= 20")
        if k < m:
            raise ValueError(f"m={m} must be <= k={k}")
        self.k, self.m, self.c = k, m, c
        w = self.to_int("w", profile, DEFAULT_W)
        self.w = w if w in (8, 16, 32) else DEFAULT_W
        if self.w != 8:
            raise ValueError("only w=8 is supported (GF(2^8) lanes)")

    def _prepare(self) -> None:
        key = (self.technique, self.k, self.m, self.c, self.w)
        with self._cache_lock:
            mat = self._table_cache.get(key)
            if mat is None:
                mat = shec_coding_matrix(self.k, self.m, self.c,
                                         self.technique)
                self._table_cache[key] = mat
        self.matrix = mat

    # ---- interface --------------------------------------------------------
    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_alignment(self) -> int:
        return self.k * self.w * 4  # get_alignment (ErasureCodeShec.cc:266)

    def get_chunk_size(self, object_size: int) -> int:
        alignment = self.get_alignment()
        tail = object_size % alignment
        padded = object_size + (alignment - tail if tail else 0)
        return padded // self.k

    # ---- decoding-system search (shec_make_decoding_matrix) ---------------
    def _make_decoding_system(self, want: List[int], avails: List[int]):
        """Returns (decoding_matrix, dm_row, dm_column, minimum_mask).

        Searches parity subsets (smallest invertible system wins) as the
        reference does, including the want-propagation for erased
        parities and the minimum-chunk accounting.
        """
        k, m = self.k, self.m
        matrix = self.matrix
        want = list(want)
        # an erased wanted parity needs its whole window of data chunks
        for i in range(m):
            if want[k + i] and not avails[k + i]:
                for j in range(k):
                    if matrix[i, j] > 0:
                        want[j] = 1
        ckey = (self.technique, self.k, self.m, self.c, self.w,
                tuple(want), tuple(avails))
        with self._cache_lock:
            hit = self._decode_cache.get(ckey)
        if hit is not None:
            return hit

        mindup = k + 1
        minp = k + 1
        best = None
        for pp in range(1 << m):
            p = [i for i in range(m) if pp & (1 << i)]
            if len(p) > minp:
                continue
            if any(not avails[k + i] for i in p):
                continue
            tmprow = [0] * (k + m)
            tmpcolumn = [0] * k
            for i in range(k):
                if want[i] and not avails[i]:
                    tmpcolumn[i] = 1
            for i in p:
                tmprow[k + i] = 1
                for j in range(k):
                    if matrix[i, j] != 0:
                        tmpcolumn[j] = 1
                        if avails[j] == 1:
                            tmprow[j] = 1
            dup_row = sum(tmprow)
            dup_column = sum(tmpcolumn)
            if dup_row != dup_column:
                continue
            dup = dup_row
            if dup == 0:
                mindup = 0
                best = (np.zeros((0, 0), np.uint8), [], [])
                break
            if dup < mindup:
                rows = [i for i in range(k + m) if tmprow[i]]
                cols = [j for j in range(k) if tmpcolumn[j]]
                tmpmat = np.zeros((dup, dup), dtype=np.uint8)
                for ri, i in enumerate(rows):
                    for ci, j in enumerate(cols):
                        tmpmat[ri, ci] = (1 if i == j else 0) if i < k \
                            else matrix[i - k, j]
                try:
                    inv = gf_invert_matrix(tmpmat)
                except (ValueError, ZeroDivisionError, np.linalg.LinAlgError):
                    continue  # singular: det == 0
                mindup = dup
                minp = len(p)
                best = (inv, rows, cols)
        if best is None:
            raise IOError("shec: can't find recovery matrix")

        inv, rows, cols = best
        minimum = [0] * (k + m)
        for r in rows:
            minimum[r] = 1
        for i in range(k):
            if want[i] and avails[i]:
                minimum[i] = 1
        for i in range(m):
            if want[k + i] and avails[k + i] and not minimum[k + i]:
                if any(matrix[i, j] > 0 and not want[j] for j in range(k)):
                    minimum[k + i] = 1
        result = (inv, rows, cols, minimum)
        with self._cache_lock:
            self._decode_cache[ckey] = result
            if len(self._decode_cache) > DECODE_CACHE_ENTRIES:
                self._decode_cache.pop(next(iter(self._decode_cache)))
        return result

    def _minimum_to_decode(self, want_to_read: Set[int],
                           available_chunks: Set[int]) -> Set[int]:
        n = self.k + self.m
        for i in want_to_read | available_chunks:
            if i < 0 or i >= n:
                raise ValueError(f"chunk id {i} out of range")
        want = [1 if i in want_to_read else 0 for i in range(n)]
        avails = [1 if i in available_chunks else 0 for i in range(n)]
        *_, minimum = self._make_decoding_system(want, avails)
        return {i for i in range(n) if minimum[i] == 1}

    # ---- device backend ---------------------------------------------------
    def device(self):
        """DeviceRSBackend over the shingled systematic matrix on the
        backend's device: the GF(2^8) bit-matmul kernel."""
        if self._device is None:
            from ..ops.gf_matmul import DeviceRSBackend
            full = np.zeros((self.k + self.m, self.k), dtype=np.uint8)
            full[:self.k] = np.eye(self.k, dtype=np.uint8)
            full[self.k:] = self.matrix
            self._device = DeviceRSBackend(full, self.torch_device)
        return self._device

    def _decode_sys_bits(self, key, rows_matrix: np.ndarray):
        """Per-signature ``BitMatrix`` of a recovery subsystem (LRU)."""
        from ..ops.gf_pallas import BitMatrix
        with self._cache_lock:
            hit = self._sys_bits.get(key)
            if hit is not None:
                self._sys_bits.move_to_end(key)
                return hit
        hit = BitMatrix(expand_to_bitmatrix(rows_matrix),
                        self.device().device)
        with self._cache_lock:
            self._sys_bits[key] = hit
            if len(self._sys_bits) > SYS_BITS_ENTRIES:
                self._sys_bits.popitem(last=False)
        return hit

    # ---- encode/decode ----------------------------------------------------
    def encode_chunks(self, want_to_encode: Set[int], encoded) -> None:
        k, m = self.k, self.m
        data = np.stack([encoded[self.chunk_index(i)] for i in range(k)])
        coding = self.device().encode(data[None])[0]
        for i in range(m):
            encoded[self.chunk_index(k + i)][...] = coding[i]

    def encode_batch(self, data: np.ndarray) -> np.ndarray:
        """(S, k, C) -> (S, m, C): one device call for all stripes."""
        return self.device().encode(np.ascontiguousarray(data))

    def decode_batch(self, chunks, want) -> dict:
        """Batched recovery: one signature search, one device product for
        all stripes (chunks: *physical* id -> (S, C))."""
        from ..ops.gf_pallas import gf_bit_matmul_kernel
        k, m = self.k, self.m
        n = k + m
        # translate physical ids to logical matrix rows (mapping= profiles)
        p2l = {self.chunk_index(i): i for i in range(n)}
        l2p = {l: p for p, l in p2l.items()}
        chunks = {p2l[p]: b for p, b in chunks.items()}
        want = [p2l[p] for p in want]
        erased = [1 if (i not in chunks and i in want) else 0
                  for i in range(n)]
        avails = [1 if i in chunks else 0 for i in range(n)]
        out = {i: chunks[i] for i in want if i in chunks}
        if not any(erased):
            return {l2p[i]: b for i, b in out.items()}
        inv, rows, cols, _ = self._make_decoding_system(erased, avails)
        some = next(iter(chunks.values()))
        s, c = some.shape
        full = {i: chunks.get(i) for i in range(n)}
        missing_cols = [i for i in range(len(cols))
                        if not avails[cols[i]]]
        if missing_cols:
            src = np.stack([full[r] for r in rows], axis=1)  # (S, dup, C)
            key = ("d", tuple(rows), tuple(cols), tuple(missing_cols),
                   tuple(erased))
            bits = self._decode_sys_bits(key, inv[missing_cols, :])
            rec = gf_bit_matmul_kernel(
                torch.from_numpy(src).to(bits.device), bits).cpu().numpy()
            for idx, ci in enumerate(missing_cols):
                full[cols[ci]] = rec[:, idx]
        # re-encode erased parities from their (recovered) windows only —
        # non-window data may legitimately remain unrecovered
        for i in range(m):
            if not erased[k + i]:
                continue
            acc = np.zeros((s, c), dtype=np.uint8)
            for j in range(k):
                coeff = int(self.matrix[i, j])
                if coeff:
                    acc ^= gf_mul_scalar(coeff, full[j])
            full[k + i] = acc
        for i in want:
            if full[i] is None:
                raise IOError(f"shec: chunk {i} unrecoverable")
            out[i] = full[i]
        return {l2p[i]: b for i, b in out.items()}

    def decode_chunks(self, want_to_read: Set[int], chunks,
                      decoded) -> None:
        k, m = self.k, self.m
        n = k + m
        # buffers arrive keyed by physical id; the matrix works in logical
        # rows — shared ndarrays keep in-place writes visible to the caller
        p2l = {self.chunk_index(i): i for i in range(n)}
        chunks = {p2l[p]: b for p, b in chunks.items()}
        decoded = {p2l[p]: b for p, b in decoded.items()}
        want_to_read = {p2l[p] for p in want_to_read}
        erased = [1 if (i not in chunks and i in want_to_read) else 0
                  for i in range(n)]
        avails = [1 if i in chunks else 0 for i in range(n)]
        if not any(erased):
            return
        inv, rows, cols, _ = self._make_decoding_system(erased, avails)
        dm_size = len(cols)
        # recover erased data chunks in the subsystem
        for i in range(dm_size):
            if not avails[cols[i]]:
                acc = np.zeros_like(decoded[0])
                for j in range(dm_size):
                    coeff = int(inv[i, j])
                    if coeff:
                        acc ^= gf_mul_scalar(coeff, decoded[rows[j]])
                decoded[cols[i]][...] = acc
        # re-encode erased parities from (now complete) data
        for i in range(m):
            if erased[k + i] and not avails[k + i]:
                acc = np.zeros_like(decoded[0])
                for j in range(k):
                    coeff = int(self.matrix[i, j])
                    if coeff:
                        acc ^= gf_mul_scalar(coeff, decoded[j])
                decoded[k + i][...] = acc
