"""GF(2^8) bit-matmul: the hand-written CUDA kernel, its wrapper and its
plain PyTorch version.

Port of the TPU kernel ``ceph_tpu/ops/gf_pallas.py::_kernel`` (K1).  The
file keeps its name so that each counterpart is easy to find; the kernel
itself is ``csrc/gf_bit_matmul.cu`` (sm_90a, loaded through ctypes), and
computes what K1 computes without K1's C % 128 restriction, by lookups
into per-row nibble tables held in shared memory.

- ``BitMatrix`` holds one (8k, 8r) 0/1 matrix on one device, both as
  0/1 bytes (for the plain version) and as the nibble tables the kernel
  reads (``pack_tables``).  Build it once per coding or decode matrix and
  reuse it.
- ``gf_bit_matmul_kernel(data, bm)`` launches the kernel for a CUDA
  tensor, or raises.  Only a tensor that lies on the CPU takes the plain
  version.  ``launches.n`` counts kernel launches.
- ``gf_bit_matmul_plain(data, bitmat)`` is the reference: unpack bits,
  matmul, ``& 1``, pack.
- ``gf_bit_matmul_popc(data, bm)`` launches the first design of the
  kernel (a masked popcount per output bit, ``pack_masks``) on a CUDA
  tensor; it is kept only as the baseline of chip_smoke.py's A/B.
- ``gfw_bit_matmul_kernel(data, bm, w)`` is K3, the GF(2^w) word layout
  (w = 16, 32) of ``ceph_tpu/ops/gf_matmul.py::gfw_bit_matmul``: ``bm``
  holds the (k*w, r*w) companion bitmatrix, which is K1's matrix over k*w/8
  virtual data rows, so its tables are ``pack_tables`` unchanged; the
  kernel is ``gfw_bit_matmul_launch`` in the same source.  Same rules as
  K1; ``word_launches.n`` counts its launches, ``gfw_bit_matmul_plain``
  is its plain version.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import threading

from typing import Tuple

import numpy as np
import torch

from . import _build

_SIGNATURES = {
    "gf_bit_matmul_launch": (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
         ctypes.c_void_p],
        ctypes.c_int),
    "gf_bit_matmul_popc_launch": (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
         ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int),
    "gfw_bit_matmul_launch": (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
         ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int),
}

# word widths K3 takes, and its limit on virtual data rows (k * w / 8)
WORD_WIDTHS = (16, 32)
MAX_VIRTUAL_ROWS = 256

# float32 unpacked planes the plain version materialises per chunk of
# stripes (the whole smoke batch would be 8 GiB at once)
_PLAIN_CHUNK_BYTES = 256 << 20


class LaunchCounter:
    """Kernel launches since the last ``reset()``.  Wrappers count with
    ``add``, under a lock: the dispatch scheduler launches from whichever
    submitter thread flushes, and ``n += 1`` from two threads can lose a
    launch."""

    def __init__(self):
        self.n = 0
        self._lock = threading.Lock()

    def add(self, k: int = 1) -> None:
        with self._lock:
            self.n += int(k)

    def reset(self) -> None:
        with self._lock:
            self.n = 0


launches = LaunchCounter()          # K1
word_launches = LaunchCounter()     # K3


def pack_masks(bits: np.ndarray) -> np.ndarray:
    """(8k, 8r) 0/1 -> (8r, ceil(k/8)) int64 words: bit t of word w of row
    j is bits[64*w + t, j] (the column vector of output bit j)."""
    k8, r8 = bits.shape
    nw = (k8 // 8 + 7) // 8
    cols = np.zeros((r8, nw * 64), dtype=np.uint8)
    cols[:, :k8] = bits.T
    packed = np.packbits(cols, axis=1, bitorder="little")   # (8r, nw*8)
    return np.ascontiguousarray(packed).view("<u8").view(np.int64)


def pack_tables(bits: np.ndarray) -> np.ndarray:
    """(8k, 8r) 0/1 -> (ceil(r/4), k, 32) uint32 nibble tables.

    Entry [g, i, n] (n < 16) is the XOR, over the set bits t of n, of row
    8i + t of the matrix, and [g, i, 16 + n] the same over rows 8i + 4 + t;
    each row is taken on output columns 32g .. 32g + 31 and packed LSB
    first, so bit 8q + b of an entry is bit b of output row 4g + q.  The
    product for data byte x of row i is then
    ``[g, i, x & 15] ^ [g, i, 16 + (x >> 4)]``, and an output column is
    the XOR of that over the k rows."""
    k8, r8 = bits.shape
    k, groups = k8 // 8, (r8 // 8 + 3) // 4
    cols = np.zeros((k8, groups * 32), dtype=np.uint8)
    cols[:, :r8] = bits
    packed = np.packbits(cols.reshape(k8, groups, 32), axis=-1,
                         bitorder="little")                  # (8k, g, 4)
    rows = np.ascontiguousarray(packed).view("<u4")[..., 0].astype(np.uint32)
    rows = rows.reshape(k, 2, 4, groups)                     # row 8i + 4h + t
    pick = ((np.arange(16)[:, None] >> np.arange(4)) & 1).astype(bool)
    terms = np.where(pick[None, None, :, :, None], rows[:, :, None],
                     np.uint32(0))                           # (k, 2, 16, 4, g)
    tab = np.bitwise_xor.reduce(terms, axis=3)               # (k, 2, 16, g)
    return np.ascontiguousarray(
        tab.transpose(3, 0, 1, 2).reshape(groups, k, 32), dtype=np.uint32)


class BitMatrix:
    """A (8k, 8r) GF(2) matrix on one device, ready for either version."""

    def __init__(self, bits: np.ndarray, device):
        bits = np.asarray(bits)
        if bits.ndim != 2 or bits.shape[0] % 8 or bits.shape[1] % 8 or \
                not bits.size:
            raise ValueError(f"bit matrix shape {bits.shape} is not (8k, 8r)")
        if np.any((bits != 0) & (bits != 1)):
            raise ValueError("bit matrix holds values other than 0 and 1")
        self.device = torch.device(device)
        self.k = bits.shape[0] // 8
        self.r = bits.shape[1] // 8
        self.bits = torch.as_tensor(bits.astype(np.uint8), device=self.device)
        self.tables = torch.as_tensor(pack_tables(bits).view(np.int32),
                                      device=self.device)

    @property
    def nbytes(self) -> int:
        """Bytes this matrix holds on its device (0/1 bytes and tables)."""
        return (self.bits.numel() * self.bits.element_size()
                + self.tables.numel() * self.tables.element_size())

    @functools.cached_property
    def masks(self) -> torch.Tensor:
        """The first design's (8r, ceil(k/8)) u64 column masks, built on
        first use: only the A/B baseline reads them."""
        return torch.as_tensor(pack_masks(self.bits.cpu().numpy()),
                               device=self.device)


@contextlib.contextmanager
def _full_float32():
    """float32 matmuls without TF32 inside, the caller's setting after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def gf_bit_matmul_plain(data: torch.Tensor,
                        bitmat: torch.Tensor) -> torch.Tensor:
    """data (S, k, C) uint8, bitmat (8k, 8r) 0/1 -> (S, r, C) uint8.

    The product runs in float32 on either device: 0/1 sums of at most 8k
    terms are exact there, which int8 (wraps on the CPU) and int32 (no
    CUDA matmul) are not.  Stripes are walked in chunks so the unpacked
    planes (32x the data in float32) stay bounded."""
    s, k, c = data.shape
    r = bitmat.shape[1] // 8
    w = bitmat.to(device=data.device, dtype=torch.float32)
    shifts = torch.arange(8, dtype=torch.uint8, device=data.device)
    weights = (1 << torch.arange(8, dtype=torch.int32, device=data.device))
    out = torch.empty((s, r, c), dtype=torch.uint8, device=data.device)
    step = max(1, _PLAIN_CHUNK_BYTES // max(1, c * k * 8 * 4))
    # The check of the kernel rests on this product being exact.  Full
    # float32 is (integer sums < 2^24); TF32 mode hands the product to
    # tensor-core paths whose rounding PyTorch does not specify, so keep
    # it off explicitly rather than trust the default, and give the
    # caller's setting back afterwards.
    with _full_float32():
        for s0 in range(0, s, step):
            d = data[s0:s0 + step].transpose(1, 2)         # (n, C, k)
            n = d.shape[0]
            bits = ((d.unsqueeze(-1) >> shifts) & 1).reshape(n, c, k * 8)
            acc = bits.to(torch.float32) @ w               # (n, C, 8r)
            par = acc.to(torch.int32) & 1
            packed = (par.reshape(n, c, r, 8) * weights).sum(-1)
            out[s0:s0 + n] = packed.to(torch.uint8).transpose(1, 2)
    return out


def _check(data: torch.Tensor, bm: BitMatrix) -> None:
    if data.dim() != 3 or data.dtype != torch.uint8:
        raise ValueError(f"data must be (S, k, C) uint8, got "
                         f"{tuple(data.shape)} {data.dtype}")
    if data.shape[1] != bm.k:
        raise ValueError(f"data has k={data.shape[1]}, bit matrix has "
                         f"k={bm.k}")


def _launch(entry: str, data: torch.Tensor, r: int,
            table: torch.Tensor, *extra) -> Tuple[torch.Tensor, bool]:
    """Launch ``entry`` of the CUDA source on a CUDA tensor into a new
    (S, r, C) output, or raise.  Returns the output and whether a kernel
    ran (not for an empty one)."""
    if data.device.type != "cuda":
        raise RuntimeError(f"gf_bit_matmul: no kernel for device "
                           f"{data.device}")
    if table.device != data.device:
        raise ValueError(f"bit matrix on {table.device}, data on "
                         f"{data.device}")
    if not data.is_contiguous():
        raise ValueError("data must be contiguous")
    s, k, c = data.shape
    out = torch.empty((s, r, c), dtype=torch.uint8, device=data.device)
    if out.numel() == 0:
        return out, False
    lib = _build.load("gf_bit_matmul", _SIGNATURES)
    stream = torch.cuda.current_stream(data.device).cuda_stream
    rc = getattr(lib, entry)(data.data_ptr(), table.data_ptr(),
                             out.data_ptr(), s, k, r, c, *extra, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} failed: cudaError {rc}")
    return out, True


def gf_bit_matmul_kernel(data: torch.Tensor, bm: BitMatrix) -> torch.Tensor:
    """data (S, k, C) uint8 -> (S, r, C) uint8 through the CUDA kernel.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel on the current stream or raises; any other device raises."""
    _check(data, bm)
    if data.device.type == "cpu":
        return gf_bit_matmul_plain(data, bm.bits.cpu())
    out, launched = _launch("gf_bit_matmul_launch", data, bm.r, bm.tables)
    launches.add(launched)
    return out


def gf_bit_matmul_popc(data: torch.Tensor, bm: BitMatrix) -> torch.Tensor:
    """The first design of the kernel on a CUDA tensor, for the A/B; no
    plain version here and no launch count."""
    _check(data, bm)
    return _launch("gf_bit_matmul_popc_launch", data, bm.r, bm.masks,
                   bm.masks.shape[1])[0]


# -- K3: the GF(2^w) word layout ---------------------------------------------

def gfw_bit_matmul_plain(data: torch.Tensor, bitmat: torch.Tensor,
                         w: int) -> torch.Tensor:
    """data (S, k, C) uint8 read as little-endian w-bit words, bitmat
    (k*w, r*w) 0/1 -> (S, r, C) uint8 of the same words.

    Each word unpacks to its w bits (LE: word bit 8b + i is bit i of byte
    b), the float32 product with TF32 off runs over k*w bit lanes, and the
    parity packs back into words, stripes walked in chunks as in
    ``gf_bit_matmul_plain``."""
    s, k, c = data.shape
    ws = w // 8
    nw = c // ws
    r = bitmat.shape[1] // w
    wt = bitmat.to(device=data.device, dtype=torch.float32)
    shifts = torch.arange(8, dtype=torch.uint8, device=data.device)
    weights = (1 << torch.arange(8, dtype=torch.int32, device=data.device))
    out = torch.empty((s, r, c), dtype=torch.uint8, device=data.device)
    step = max(1, _PLAIN_CHUNK_BYTES // max(1, c * k * 8 * 4))
    with _full_float32():
        for s0 in range(0, s, step):
            d = data[s0:s0 + step]
            n = d.shape[0]
            words = d.reshape(n, k, nw, ws).permute(0, 2, 1, 3)   # (n, W, k, ws)
            bits = ((words.unsqueeze(-1) >> shifts) & 1).reshape(n, nw, k * w)
            acc = bits.to(torch.float32) @ wt                    # (n, W, r*w)
            par = acc.to(torch.int32) & 1
            packed = (par.reshape(n, nw, r * ws, 8) * weights).sum(-1)
            out[s0:s0 + n] = packed.to(torch.uint8).reshape(
                n, nw, r, ws).permute(0, 2, 1, 3).reshape(n, r, c)
    return out


def _check_word(data: torch.Tensor, bm: BitMatrix, w: int) -> int:
    """Validate K3's contract; returns the word's bytes ws = w / 8."""
    if w not in WORD_WIDTHS:
        raise ValueError(f"w={w} not in {WORD_WIDTHS}")
    if data.dim() != 3 or data.dtype != torch.uint8:
        raise ValueError(f"data must be (S, k, C) uint8, got "
                         f"{tuple(data.shape)} {data.dtype}")
    ws = w // 8
    if data.shape[1] * ws != bm.k or bm.r % ws:
        raise ValueError(f"data has k={data.shape[1]}, bit matrix is "
                         f"({8 * bm.k}, {8 * bm.r}): not (k*{w}, r*{w})")
    if bm.k > MAX_VIRTUAL_ROWS:
        raise ValueError(f"k*w/8 = {bm.k} virtual rows > {MAX_VIRTUAL_ROWS}")
    if data.shape[2] % ws:
        raise ValueError(f"chunk size {data.shape[2]} is not whole "
                         f"{w}-bit words")
    return ws


def gfw_bit_matmul_kernel(data: torch.Tensor, bm: BitMatrix,
                          w: int) -> torch.Tensor:
    """data (S, k, C) uint8 of LE w-bit words -> (S, r, C) through K3.

    ``bm`` is the (k*w, r*w) bitmatrix as a ``BitMatrix``.  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel on the
    current stream or raises; any other device raises."""
    ws = _check_word(data, bm, w)
    if data.device.type == "cpu":
        return gfw_bit_matmul_plain(data, bm.bits.cpu(), w)
    out, launched = _launch("gfw_bit_matmul_launch", data, bm.r // ws,
                            bm.tables, ws)
    word_launches.add(launched)
    return out
