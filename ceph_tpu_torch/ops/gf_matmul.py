"""GF(2^8) Reed-Solomon coding as a GF(2) bit-matrix product on the card.

Port of ``ceph_tpu/ops/gf_matmul.py`` (the isa-matrix byte layout).
GF(2^8) multiplication by a constant is linear over GF(2), so an (r x k)
GF(2^8) matrix expands to an (8k x 8r) 0/1 matrix B
(gf/tables.expand_to_bitmatrix), and coding a batch of S stripes is one
call of the bit-matmul kernel (ops/gf_pallas.py).  Decode runs the same
kernel: the host inverts the k x k survivor matrix, expands the wanted
rows to bits, and the device runs the identical product.

``DeviceRSBackend`` lives on one explicit ``device``: ``"cuda"`` (the
kernel) or ``"cpu"`` (the plain PyTorch version, for tests and for a
caller that asks for the CPU).  Asking for CUDA without a CUDA device
raises; nothing falls back.

jerasure's reed_sol codes at w = 16/32 work on little-endian w-bit words:
``expand_to_bitmatrix_w`` gives their (k*w, m*w) companion bitmatrix,
``gfw_bit_matmul`` is the contract of the JAX function of that name, and
``DeviceWordRSBackend`` encodes with it through the K3 kernel.

The numpy entry points (``encode``, ``decode_data``) are the host<->device
boundary of the EC path, and the device-flow profiler accounts both legs
at the JAX package's sites (``gf_matmul.encode``, ``.decode``,
``.encode_w``; counter bumps only, no sync).  Uploading a decode matrix
is accounted at ``gf_matmul.decode_bits`` as the bytes the port moves:
the 0/1 matrix and the kernel's nibble tables (the JAX package moves the
int8 matrix alone).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from ..common.kernel_trace import g_kernel_timer
from ..common.lockdep import DebugLock
from ..ec.rs_codec import DECODE_CACHE_ENTRIES
from ..gf.bitmatrix import element_bitmatrix
from ..gf.matrices import gf_invert_matrix
from ..gf.tables import expand_to_bitmatrix
from ..trace.devprof import g_devprof
from .gf_pallas import (WORD_WIDTHS, BitMatrix, gf_bit_matmul_kernel,
                        gfw_bit_matmul_kernel)


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    this process has no CUDA device."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda is not "
                           "available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {dev} is neither cuda nor cpu")
    return dev


def device_round_trip(site: str, fn, data: np.ndarray,
                      device) -> np.ndarray:
    """numpy ``data`` up to ``device``, ``fn`` on the tensor there, the
    result back as numpy: the EC path's host<->device boundary.  Both
    legs are accounted at ``site`` (counter bumps, no sync) and the call
    runs inside that site's devprof stage."""
    g_devprof.account_h2d(site, data.nbytes)
    with g_devprof.stage(site):
        t = torch.from_numpy(np.ascontiguousarray(data)).to(device)
        out = fn(t).cpu().numpy()
    g_devprof.account_d2h(site, out.nbytes)
    return out


def gf_bit_matmul(data: torch.Tensor,
                  bitmat: Union[BitMatrix, np.ndarray]) -> torch.Tensor:
    """data (S, k, C) uint8, bitmat (8k, 8r) 0/1 -> (S, r, C) uint8.

    The contract of the JAX package's ``gf_bit_matmul`` (``ceph_tpu/ops/
    gf_matmul.py``); a numpy
    bit matrix is moved to ``data``'s device first (pass a ``BitMatrix``
    to reuse one)."""
    if not isinstance(bitmat, BitMatrix):
        bitmat = BitMatrix(bitmat, data.device)
    return gf_bit_matmul_kernel(data, bitmat)


def gfw_bit_matmul(data: torch.Tensor,
                   bitmat: Union[BitMatrix, np.ndarray], w: int) -> torch.Tensor:
    """data (S, k, C) uint8 read as LE w-bit words, bitmat (k*w, r*w) 0/1
    -> (S, r, C) uint8: the contract of the JAX package's
    ``gfw_bit_matmul`` (``ceph_tpu/ops/gf_matmul.py``) for w = 16, 32."""
    if not isinstance(bitmat, BitMatrix):
        bitmat = BitMatrix(bitmat, data.device)
    return gfw_bit_matmul_kernel(data, bitmat, w)


def expand_to_bitmatrix_w(coding: np.ndarray, w: int) -> np.ndarray:
    """(m, k) GF(2^w) coefficients -> (k*w, m*w) 0/1 matrix in the
    d @ B convention ``gfw_bit_matmul`` consumes (gf/tables.py
    expand_to_bitmatrix generalized via the companion representation)."""
    mm, kk = coding.shape
    out = np.zeros((kk * w, mm * w), dtype=np.uint8)
    for r in range(mm):
        for c in range(kk):
            bm = element_bitmatrix(int(coding[r, c]), w)
            out[c * w:(c + 1) * w, r * w:(r + 1) * w] = bm.T
    return out


class DeviceWordRSBackend:
    """Encoder for one (k+m, k) GF(2^w) word-layout code on one device.

    Decode of these codes runs on the host codec (gf/word_codec.py), as
    in the JAX package: the backend encodes only."""

    def __init__(self, encode_matrix: np.ndarray, w: int, device="cuda"):
        if w not in WORD_WIDTHS:
            raise ValueError(f"w={w} not in {WORD_WIDTHS}")
        rows, k = encode_matrix.shape
        self.device = resolve_device(device)
        self.k = k
        self.m = rows - k
        self.w = w
        self.matrix = np.asarray(encode_matrix).astype(np.int64)
        self._enc = BitMatrix(expand_to_bitmatrix_w(self.matrix[k:], w),
                              self.device)

    def encode(self, data: np.ndarray) -> np.ndarray:
        """(S, k, C) uint8 numpy -> (S, m, C) coding chunks (numpy)."""
        return device_round_trip("gf_matmul.encode_w", self.encode_device,
                                 data, self.device)

    def encode_device(self, data: torch.Tensor) -> torch.Tensor:
        """(S, k, C) uint8 tensor on this device -> (S, m, C) tensor."""
        return gfw_bit_matmul_kernel(data, self._enc, self.w)


class DeviceRSBackend:
    """Executor for one (k+m, k) systematic code on one device."""

    def __init__(self, encode_matrix: np.ndarray, device="cuda"):
        rows, k = encode_matrix.shape
        self.device = resolve_device(device)
        self.k = k
        self.m = rows - k
        self.matrix = np.asarray(encode_matrix).astype(np.uint8)
        self._enc = BitMatrix(expand_to_bitmatrix(self.matrix[k:]),
                              self.device)
        # bounded like the host codec's signature cache (mirrors
        # ErasureCodeIsaTableCache's 2516-entry LRU)
        self._decode_bits_cache: "OrderedDict[tuple, BitMatrix]" = \
            OrderedDict()
        self._cache_lock = DebugLock("gf_matmul::decode_bits_cache")

    # -- encode -------------------------------------------------------------
    def encode(self, data: np.ndarray) -> np.ndarray:
        """(S, k, C) uint8 numpy -> (S, m, C) coding chunks (numpy): the
        whole batch crosses up, the coding chunks cross back, both legs
        accounted at ``gf_matmul.encode``."""
        return g_kernel_timer.timed(
            "gf_encode", device_round_trip, "gf_matmul.encode",
            self.encode_device, data, self.device)

    def encode_device(self, data: torch.Tensor) -> torch.Tensor:
        """(S, k, C) uint8 tensor on this device -> (S, m, C) tensor."""
        return gf_bit_matmul_kernel(data, self._enc)

    @property
    def enc_bits(self) -> BitMatrix:
        return self._enc

    # -- decode -------------------------------------------------------------
    def _decode_bits_for(self, srcs: Tuple[int, ...],
                         want_rows: Tuple[int, ...]) -> BitMatrix:
        key = (srcs, want_rows)
        with self._cache_lock:
            hit = self._decode_bits_cache.get(key)
            if hit is not None:
                self._decode_bits_cache.move_to_end(key)
                return hit
        sub = self.matrix[list(srcs), :]
        inv = gf_invert_matrix(sub)              # data = inv @ survivors
        bits = BitMatrix(expand_to_bitmatrix(inv[list(want_rows), :]),
                         self.device)
        g_devprof.account_h2d("gf_matmul.decode_bits", bits.nbytes)
        with self._cache_lock:
            self._decode_bits_cache[key] = bits
            if len(self._decode_bits_cache) > DECODE_CACHE_ENTRIES:
                self._decode_bits_cache.popitem(last=False)
        return bits

    def decode_data(self, survivors: np.ndarray, srcs: Sequence[int],
                    want_rows: Sequence[int]) -> np.ndarray:
        """survivors (S, k, C) stacked in ``srcs`` order -> the requested
        data rows (S, len(want_rows), C), numpy in and out."""
        # a cache miss accounts the matrix upload first, as in JAX
        self._decode_bits_for(tuple(srcs), tuple(want_rows))
        return device_round_trip(
            "gf_matmul.decode",
            lambda t: self.decode_data_device(t, srcs, want_rows),
            survivors, self.device)

    def decode_data_device(self, survivors: torch.Tensor,
                           srcs: Sequence[int],
                           want_rows: Sequence[int]) -> torch.Tensor:
        bits = self._decode_bits_for(tuple(srcs), tuple(want_rows))
        return gf_bit_matmul_kernel(survivors, bits)


def backend_from_matrix(encode_matrix: np.ndarray, device="cuda",
                        w: int = 8):
    """The port's backend for a (k+m, k) coding matrix taken from
    elsewhere, e.g. ``codec.matrix`` of an initialised JAX-side plugin: in
    erasure coding the matrix is the whole of the weights.  ``w`` = 8
    takes GF(2^8) entries (isa, tpu, jerasure at w=8, or the 0/1 virtual
    matrix of a jerasure bitmatrix code) and gives a ``DeviceRSBackend``;
    ``w`` = 16 or 32 takes GF(2^w) entries (jerasure reed_sol at that w)
    and gives a ``DeviceWordRSBackend``."""
    m = np.asarray(encode_matrix)
    if w not in (8,) + WORD_WIDTHS:
        raise ValueError(f"w={w} not in 8|16|32")
    if m.ndim != 2 or m.shape[0] <= m.shape[1]:
        raise ValueError(f"encode matrix {m.shape} is not (k+m, k)")
    if m.size and (int(m.min()) < 0 or int(m.max()) >= 1 << w):
        raise ValueError(f"encode matrix entries outside GF(2^{w})")
    if not np.array_equal(m[:m.shape[1]], np.eye(m.shape[1])):
        raise ValueError("encode matrix is not systematic (top k rows "
                         "are not the identity)")
    if w == 8:
        return DeviceRSBackend(m.astype(np.uint8), device)
    return DeviceWordRSBackend(m.astype(np.int64), w, device)
