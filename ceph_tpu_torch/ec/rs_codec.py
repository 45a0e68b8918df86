"""Matrix-RS codec over GF(2^8): host (numpy) execution engine.

A copy of ``ceph_tpu/ec/rs_codec.py`` for the port.  It is the host
oracle of the device path (ops/gf_matmul.py), used where the JAX package
uses it: ``decode_chunks`` of the matrix plugins, and ``decode_batch`` of
the codecs whose device layout is not whole chunks (jerasure word and
bitmatrix codes).  Both consume the same
coding matrices (gf/matrices.py) and agree byte for byte.

Decode strategy (semantics of isa-l matrix decoding as used by the
reference plugin, src/erasure-code/isa/ErasureCodeIsa.cc:217-303): pick the
first k surviving chunks in index order, build the k x k sub-matrix of the
encode matrix, invert it, recover missing data rows, and re-encode missing
coding rows.  Decode matrices are cached per erasure signature, mirroring
ErasureCodeIsaTableCache (LRU under mutex, ErasureCodeIsaTableCache.h:48).
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..gf.tables import MUL_TABLE
from ..gf.matrices import gf_invert_matrix

# Reference cache bound (ErasureCodeIsaTableCache.h:48)
DECODE_CACHE_ENTRIES = 2516


def plan_decode(k: int, available: Sequence[int], want: Sequence[int]):
    """Shared reconstruction plan used by both host and device executors.

    Returns (srcs, want_data, want_coding, missing_data):
    - srcs: the k survivor chunk ids to invert against
    - want_data / want_coding: requested-and-missing chunk ids by kind
    - missing_data: data rows the matvec must recover (includes data rows
      needed solely to re-encode missing coding chunks)
    """
    have = set(available)
    srcs = sorted(have)[:k]
    want_data = [i for i in want if i < k and i not in have]
    want_coding = [i for i in want if i >= k and i not in have]
    missing_data = sorted(
        set(want_data) |
        ({i for i in range(k) if i not in have} if want_coding else set()))
    return srcs, want_data, want_coding, missing_data


def gf_matvec_bytes(matrix_rows: np.ndarray, data: np.ndarray) -> np.ndarray:
    """rows (r, k) x data (k, C) -> (r, C) over GF(2^8), via 64KiB mul table."""
    r, k = matrix_rows.shape
    kk, c = data.shape
    if k != kk:
        raise ValueError(f"matrix has {k} columns, data has {kk} rows")
    out = np.zeros((r, c), dtype=np.uint8)
    for i in range(r):
        acc = out[i]
        for j in range(k):
            coeff = int(matrix_rows[i, j])
            if coeff == 0:
                continue
            if coeff == 1:
                acc ^= data[j]
            else:
                acc ^= MUL_TABLE[coeff][data[j]]
    return out


class MatrixRSCodec:
    """Systematic (k+m, k) matrix code executor with signature-cached
    decode.  Subclasses for other fields/layouts (gf/word_codec.py
    GF(2^w) words) override the ``_matvec``/``_invert`` primitives and
    inherit the encode/decode scaffolding unchanged."""

    _matrix_dtype = np.uint8

    def __init__(self, encode_matrix: np.ndarray):
        rows, k = encode_matrix.shape
        self.k = k
        self.m = rows - k
        self.matrix = encode_matrix.astype(self._matrix_dtype)
        self.coding_rows = self.matrix[k:, :]
        self._decode_cache: "OrderedDict[Tuple[int, ...], np.ndarray]" = \
            OrderedDict()
        self._lock = threading.Lock()

    # -- field/layout primitives (override points) ---------------------------
    def _matvec(self, rows: np.ndarray, data: np.ndarray) -> np.ndarray:
        return gf_matvec_bytes(rows, data)

    def _invert(self, sub: np.ndarray) -> np.ndarray:
        return gf_invert_matrix(sub)

    # -- encode -------------------------------------------------------------
    def encode(self, data: np.ndarray) -> np.ndarray:
        """data (k, C) uint8 -> coding (m, C) uint8."""
        return self._matvec(self.coding_rows, data)

    # -- decode -------------------------------------------------------------
    def decode_matrix_for(
            self, available: Sequence[int]) -> Tuple[np.ndarray, List[int]]:
        """Recovery matrix for data chunks given available chunk ids.

        Returns (inv, rows_used): inv (k, k) such that
        data = inv @ stack(chunks[rows_used]).
        """
        srcs = sorted(available)[:self.k]
        key = tuple(srcs)
        with self._lock:
            hit = self._decode_cache.get(key)
            if hit is not None:
                self._decode_cache.move_to_end(key)
                return hit, list(key)
        inv = self._invert(self.matrix[list(srcs), :])
        with self._lock:
            self._decode_cache[key] = inv
            if len(self._decode_cache) > DECODE_CACHE_ENTRIES:
                self._decode_cache.popitem(last=False)
        return inv, list(srcs)

    def decode(
        self, chunks: Dict[int, np.ndarray], want: Sequence[int]
    ) -> Dict[int, np.ndarray]:
        """Reconstruct chunk ids in *want* from available *chunks*."""
        if len(chunks) < self.k:
            raise IOError(
                f"need at least k={self.k} chunks, have {len(chunks)}")
        inv, srcs = self.decode_matrix_for(list(chunks))
        src_stack = np.stack([chunks[i] for i in srcs])
        out: Dict[int, np.ndarray] = {}
        _, want_data, want_coding, missing_data = plan_decode(
            self.k, chunks, want)
        if want_data or want_coding:
            # only the data rows actually missing need the matvec; surviving
            # data rows come straight from chunks
            rec = self._matvec(inv[missing_data, :], src_stack)
            data_by_id = dict(zip(missing_data, rec))
            for i in want_data:
                out[i] = data_by_id[i]
            if want_coding:
                data_full = np.stack([
                    chunks[i] if i in chunks else data_by_id[i]
                    for i in range(self.k)])
                cod = self._matvec(self.matrix[want_coding, :], data_full)
                for idx, i in enumerate(want_coding):
                    out[i] = cod[idx]
        for i in want:
            if i in chunks:
                out[i] = chunks[i]
        return out
