"""crc32c (Castagnoli) on the card: the hand-written kernel, its wrappers
and its plain PyTorch version.

Port of ``ceph_tpu/ops/crc32c_device.py`` (K4).  Bit-identical to
``utils/crc32c.py`` (Ceph's conventions: seed -1, no final inversion), so
a digest taken on the card can be compared with a stored HashInfo digest
or re-checked on the host at any time.

The JAX form is one sequential slicing-by-8 loop per row.  The kernel,
``csrc/crc32c.cu``, cuts every row into 4096-byte segments, hashes them
in parallel and combines them by the linearity of the CRC:
``crc(c, A || B) = crc(0, B) ^ M_|B| crc(c, A)``, with ``M_L`` the GF(2)
matrix that advances the register over L zero bytes.  Both the slicing
tables and the advance matrices ``M_{seg * 2^b}`` are built here on the
host (``device_tables``, ``device_advance``) and uploaded once per
device.

On the card a CRC is an int32 tensor holding the u32's bits (torch has
no full uint32 arithmetic); the host entry points return numpy uint32.

- ``crc32c_kernel(rows, lengths)``: (n, W) uint8 rows (row stride free,
  bytes contiguous) -> (n,) CRCs of each row's first ``lengths[i]``
  bytes (all W when None).  A CUDA tensor launches the kernel or raises;
  only a tensor that lies on the CPU takes ``crc32c_plain``.
  ``crc32c_rows_kernel(list_of_1d)`` does the same for rows in separate
  allocations, and ``crc32c_gather_kernel(pieces, bodies)`` copies
  strided (S, C) sources into contiguous bodies while it hashes them
  (the body layout of the fused resident encode).  ``launches.n`` counts
  wrapper calls that launched the kernel.
- ``crc_core``, ``crc32c_device_batch``, ``crc32c_of_device_array``,
  ``crc32c_device_padded`` and ``device_crc_available``: the JAX
  module's entry points, same contracts.
- ``crc32c_plain``: the reference, vectorised over rows and segments in
  int64 with ``& 0xFFFFFFFF`` masks (the CPU has no uint32 shifts).
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..trace.devprof import g_devprof
from ..utils.crc32c import _TABLE
from . import _build
from .gf_matmul import resolve_device
from .gf_pallas import LaunchCounter

_LL = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES = {
    "crc32c_launch": (
        [_LL, _LL, _LL, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
         ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
        ctypes.c_int),
}

N_POW2 = 48                  # matrices M_{2^e}, e < N_POW2 (lengths < 2^47)
MAX_LEN = 1 << (N_POW2 - 1)
KERNEL_SEG = 4096            # the kernel's segment of a contiguous row (bytes)
CHUNKS = 4                   # coalesced path: 16-byte chunks per lane and
ITER = 32 * 16 * CHUNKS      # iteration, and bytes per warp and iteration
MAX_RUN_ITERS = 32           # coalesced path: most iterations per warp run
_TARGET_WARPS = 132 * 16     # coalesced path: warps to aim for (16 per SM)
_PLAIN_SEG = 256             # the plain version's segment (bytes)
# int64 words the plain version expands at once (8 bytes per data byte)
_PLAIN_CHUNK_BYTES = 256 << 20

launches = LaunchCounter()


@functools.lru_cache(maxsize=1)
def _slicing16_np() -> np.ndarray:
    """(16, 256) uint32: row 0 is the byte table, row k advances k+1
    bytes (slicing by 16)."""
    t = np.zeros((16, 256), dtype=np.uint32)
    t[0] = _TABLE
    for k in range(1, 16):
        t[k] = t[0][t[k - 1] & 0xFF] ^ (t[k - 1] >> np.uint32(8))
    return t


def _slicing_tables_np() -> np.ndarray:
    """(8, 256) uint32: the slicing-by-8 tables (JAX's layout)."""
    return _slicing16_np()[:8]


def _apply_np(cols: np.ndarray, x: np.ndarray) -> np.ndarray:
    """x (any shape, uint32) times the GF(2) matrix with columns cols."""
    bits = (x[..., None] >> np.arange(32, dtype=np.uint32)) & np.uint32(1)
    return np.bitwise_xor.reduce(np.where(bits == 1, cols, np.uint32(0)),
                                 axis=-1).astype(np.uint32)


@functools.lru_cache(maxsize=1)
def _pow2_matrices_np() -> np.ndarray:
    """(N_POW2, 32) uint32: row e holds the columns of M_{2^e}, i.e.
    column q is register ``1 << q`` advanced over 2^e zero bytes."""
    unit = np.uint32(1) << np.arange(32, dtype=np.uint32)
    m = np.zeros((N_POW2, 32), dtype=np.uint32)
    m[0] = _TABLE[unit & np.uint32(0xFF)] ^ (unit >> np.uint32(8))
    for e in range(1, N_POW2):
        m[e] = _apply_np(m[e - 1], m[e - 1])        # M_{2^e} = M_{2^(e-1)}^2
    return m


@functools.lru_cache(maxsize=None)
def advance_cols_np(seg: int) -> np.ndarray:
    """(N_POW2, 32) uint32: row b holds the columns of M_{seg * 2^b}, the
    kernel's advance over 2^b whole segments of ``seg`` bytes."""
    if not 0 < seg < MAX_LEN:
        raise ValueError(f"segment of {seg} bytes")
    pow2 = _pow2_matrices_np()
    m = np.uint32(1) << np.arange(32, dtype=np.uint32)      # identity
    for e in range(seg.bit_length()):
        if seg >> e & 1:
            m = _apply_np(pow2[e], m)
    out = np.zeros((N_POW2, 32), dtype=np.uint32)
    out[0] = m
    for b in range(1, N_POW2):
        out[b] = _apply_np(out[b - 1], out[b - 1])
    return out


@functools.lru_cache(maxsize=1)
def coalesced_tables_np() -> np.ndarray:
    """The coalesced path's tables, as uint32.

    First CHUNKS * 32 + 8 nibble tables of 16 words: table
    u * 32 + 2p + h holds M_{512 (CHUNKS-1-u)} T_{15-p}[v] for the low
    (h = 0, v = n) or high (h = 1, v = n << 4) nibble n of byte p of
    chunk u; table CHUNKS * 32 + q holds M_ITER (n << 4q).  Then the lane
    matrices M_{16 (31 - l)} (32 x 32 columns), then the M_{2^e}
    (N_POW2 x 32) for the seed."""
    t16 = _slicing16_np()
    nib_n = np.arange(16, dtype=np.uint32)
    nib = np.zeros((CHUNKS * 32 + 8, 16), dtype=np.uint32)
    for u in range(CHUNKS):
        ahead = 512 * (CHUNKS - 1 - u)
        for p in range(16):
            for h, idx in ((0, nib_n), (1, nib_n << np.uint32(4))):
                v = t16[15 - p][idx]
                if ahead:
                    v = _apply_np(advance_cols_np(ahead)[0], v)
                nib[u * 32 + 2 * p + h] = v
    jump = advance_cols_np(ITER)[0]
    for q in range(8):
        nib[CHUNKS * 32 + q] = _apply_np(jump, nib_n << np.uint32(4 * q))
    step = advance_cols_np(16)[0]
    lanes = np.zeros((32, 32), dtype=np.uint32)
    m = np.uint32(1) << np.arange(32, dtype=np.uint32)      # lane 31: identity
    for l in range(31, -1, -1):
        lanes[l] = m
        m = _apply_np(step, m)
    return np.concatenate([nib.reshape(-1), lanes.reshape(-1),
                           _pow2_matrices_np().reshape(-1)])


def _run_bytes(n: int, length: int) -> int:
    """Bytes per warp run on the coalesced path: ITER times a power of
    two up to MAX_RUN_ITERS, as large as keeps ~_TARGET_WARPS warps
    busy (a run's own work is then large beside its combine)."""
    iters = max(1, -(-length // ITER))
    per = MAX_RUN_ITERS
    while per > 1 and n * -(-iters // per) < _TARGET_WARPS:
        per //= 2
    return ITER * per


_dev_cache: Dict[tuple, torch.Tensor] = {}
_dev_lock = threading.Lock()


def _on_device(key: tuple, device: torch.device, make) -> torch.Tensor:
    """``make()`` (uint32 numpy) as an int32 tensor on ``device``,
    uploaded once per key and device and accounted at ``crc32c.tables``
    (the port uploads the slicing, advance and coalesced tables; the JAX
    package the slicing tables alone)."""
    with _dev_lock:
        t = _dev_cache.get((key, device))
        if t is None:
            host = make()
            g_devprof.account_h2d("crc32c.tables", host.nbytes)
            t = torch.as_tensor(host.view(np.int32), device=device)
            _dev_cache[(key, device)] = t
    return t


def device_tables(device) -> torch.Tensor:
    """The 8 x 256 slicing words on ``device``."""
    return _on_device(("slicing",), torch.device(device),
                      lambda: _slicing_tables_np().reshape(-1))


def device_advance(device, seg: int) -> torch.Tensor:
    """``advance_cols_np(seg)`` on ``device``."""
    return _on_device(("advance", seg), torch.device(device),
                      lambda: advance_cols_np(seg).reshape(-1))


def device_coalesced_tables(device) -> torch.Tensor:
    """``coalesced_tables_np()`` on ``device``."""
    return _on_device(("coalesced",), torch.device(device),
                      coalesced_tables_np)


def device_crc_available() -> bool:
    """True when this process has a CUDA card for the kernel."""
    return torch.cuda.is_available()


def to_u32(crcs: torch.Tensor) -> np.ndarray:
    """Int32 CRC bits on any device -> numpy uint32 on the host."""
    return crcs.cpu().numpy().view(np.uint32)


# ---- plain version ----------------------------------------------------------
def _as_int32(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _apply(cols: Sequence[int], x: torch.Tensor) -> torch.Tensor:
    y = torch.zeros_like(x)
    for q, col in enumerate(cols):
        y ^= ((x >> q) & 1) * col
    return y


def _advance(x: torch.Tensor, count: torch.Tensor, e0: int) -> torch.Tensor:
    """x (int64 registers) advanced over ``count * 2^e0`` zero bytes,
    element-wise, by the set bits of count."""
    mats = _pow2_matrices_np()
    top = int(count.max()) if count.numel() else 0
    for b in range(top.bit_length()):
        cols = [int(v) for v in mats[e0 + b]]
        x = torch.where(((count >> b) & 1) == 1, _apply(cols, x), x)
    return x


def _segment_crcs(segs: torch.Tensor) -> torch.Tensor:
    """(N, SEG) uint8 -> (N,) int64 raw CRCs from register 0, slicing by
    8: the lookups of the four bytes that do not meet the register are
    taken for all words at once, the register's chain word by word."""
    tabs = torch.as_tensor(_slicing_tables_np().astype(np.int64),
                           device=segs.device)
    n, seg = segs.shape
    out = torch.empty(n, dtype=torch.int64, device=segs.device)
    step = max(1, _PLAIN_CHUNK_BYTES // (seg * 8))
    for s0 in range(0, n, step):
        w = segs[s0:s0 + step].reshape(-1, seg // 8, 8).to(torch.int64)
        lo = w[..., 0] | (w[..., 1] << 8) | (w[..., 2] << 16) | \
            (w[..., 3] << 24)
        hi = tabs[3][w[..., 4]] ^ tabs[2][w[..., 5]] ^ tabs[1][w[..., 6]] ^ \
            tabs[0][w[..., 7]]
        c = torch.zeros(w.shape[0], dtype=torch.int64, device=segs.device)
        for i in range(seg // 8):
            x = c ^ lo[:, i]
            c = tabs[7][x & 0xFF] ^ tabs[6][(x >> 8) & 0xFF] ^ \
                tabs[5][(x >> 16) & 0xFF] ^ tabs[4][x >> 24] ^ hi[:, i]
        out[s0:s0 + w.shape[0]] = c
    return out


def crc32c_plain(rows: torch.Tensor,
                 lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """rows (n, W) uint8, lengths (n,) ints <= W (all W when None) ->
    (n,) int32 CRC bits of each row's first lengths[i] bytes.

    Each row is right-aligned in a buffer of whole segments (zeros in
    front do not move a CRC that starts from register 0), the segments
    are hashed from 0 and advanced over the segments after them, XORed
    per row, and the seed's term ``M_L 0xFFFFFFFF`` is XORed in last."""
    n, w = rows.shape
    dev = rows.device
    if lengths is None:
        lens = torch.full((n,), w, dtype=torch.int64, device=dev)
    else:
        lens = lengths.to(device=dev, dtype=torch.int64)
    top = int(lens.max()) if n else 0
    nseg = max(1, -(-top // _PLAIN_SEG))
    width = nseg * _PLAIN_SEG
    buf = torch.zeros((n, width), dtype=torch.uint8, device=dev)
    if lengths is None:
        buf[:, width - w:] = rows
    elif w:         # per-row right alignment as one gather
        src = torch.arange(width, device=dev) - (width - lens[:, None])
        buf = torch.where(src >= 0, rows.gather(1, src.clamp(0, w - 1)), buf)
    c = _segment_crcs(buf.view(n * nseg, _PLAIN_SEG)).view(n, nseg)
    after = (nseg - 1 - torch.arange(nseg, device=dev)).expand(n, nseg)
    c = _advance(c, after, _PLAIN_SEG.bit_length() - 1)
    while c.shape[1] > 1:
        if c.shape[1] % 2:
            c = torch.cat([c, torch.zeros_like(c[:, :1])], dim=1)
        half = c.shape[1] // 2
        c = c[:, :half] ^ c[:, half:]
    seed = torch.full((n,), 0xFFFFFFFF, dtype=torch.int64, device=dev)
    return _as_int32(c[:, 0] ^ _advance(seed, lens, 0))


# ---- the kernel -------------------------------------------------------------
def _check_rows(rows: torch.Tensor) -> None:
    if rows.dim() != 2 or rows.dtype != torch.uint8:
        raise ValueError(f"rows must be (n, W) uint8, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    if rows.shape[1] > 1 and rows.stride(1) != 1:
        raise ValueError("the bytes of each row must be contiguous")


def _launch(device: torch.device, n: int, *, src=None, dst=None,
            pitch=None, base: int = 0, stride: int = 0, lengths=None,
            length: int = 0, max_len: int, seg: int = KERNEL_SEG,
            per_thread: bool = False, count: bool = True) -> torch.Tensor:
    """Launch the kernel on CUDA ``device`` or raise; returns (n,) int32.
    ``src`` / ``pitch`` / ``dst``, when given, are host lists of the
    rows' addresses and piece pitches (passed by value, nothing is
    copied to the card); otherwise row i is at base + i * stride.  Rows
    that allow it (one length, a multiple of 16, 16-byte aligned
    addresses, pieces a multiple of ITER) take the coalesced path unless
    ``per_thread`` asks for the other.  ``count`` adds the launch to
    ``launches``."""
    if device.type != "cuda":
        raise RuntimeError(f"crc32c: no kernel for device {device}")
    if max_len >= MAX_LEN:
        raise ValueError(f"row length {max_len} >= {MAX_LEN}")
    out = torch.zeros(n, dtype=torch.int32, device=device)
    if n == 0:
        return out
    lib = _build.load("crc32c", _SIGNATURES)
    stream = torch.cuda.current_stream(device).cuda_stream
    addrs = [base, stride] if src is None else list(src) + list(pitch)
    pieces = src is not None and any(p != seg for p in pitch)
    coalesced = (not per_thread and lengths is None and length % 16 == 0
                 and all(a % 16 == 0 for a in addrs + list(dst or []))
                 and (not pieces or seg % ITER == 0))
    ws = _run_bytes(n, length) if coalesced else 0

    def table(vals):
        return None if vals is None else (ctypes.c_longlong * n)(*vals)
    rc = lib.crc32c_launch(
        table(src), table(dst), table(pitch), base, stride,
        None if lengths is None else lengths.data_ptr(), length, max_len,
        seg, ws, n, device_tables(device).data_ptr(),
        device_advance(device, ws or seg).data_ptr(),
        device_coalesced_tables(device).data_ptr(), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"crc32c_launch failed: cudaError {rc}")
    launches.add(count)
    return out


def crc32c_kernel(rows: torch.Tensor,
                  lengths: Optional[np.ndarray] = None) -> torch.Tensor:
    """(n, W) uint8 -> (n,) int32 CRC bits through the CUDA kernel.

    ``lengths`` (n,) host ints in 0..W pick each row's prefix (all W
    when None).  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel on the current stream or raises; any other
    device raises."""
    _check_rows(rows)
    n, w = rows.shape
    lens = None
    if lengths is not None:
        lengths = np.asarray(lengths, dtype=np.int64)
        if lengths.shape != (n,):
            raise ValueError(f"{lengths.shape} lengths for {n} rows")
        if n and (lengths.max() > w or lengths.min() < 0):
            raise ValueError(f"lengths outside 0..{w}")
        lens = torch.from_numpy(lengths).to(rows.device)
    if rows.device.type == "cpu":
        return crc32c_plain(rows, lens)
    if lens is None:
        return _launch(rows.device, n, base=rows.data_ptr(),
                       stride=rows.stride(0), length=w, max_len=w)
    return _launch(rows.device, n, base=rows.data_ptr(), stride=rows.stride(0),
                   lengths=lens, max_len=int(lengths.max()) if n else 0)


def _check_bodies(bodies: List[torch.Tensor]) -> None:
    if not bodies:
        raise ValueError("no rows")
    dev, length = bodies[0].device, bodies[0].numel()
    for b in bodies:
        if b.dim() != 1 or b.dtype != torch.uint8 or b.device != dev or \
                b.numel() != length or not b.is_contiguous():
            raise ValueError("rows must be contiguous 1-D uint8 tensors of "
                             "one length on one device")


def crc32c_rows_kernel(rows: List[torch.Tensor]) -> torch.Tensor:
    """CRCs of 1-D uint8 rows of one length in separate allocations: one
    launch per 128 rows, their addresses passed by value.  CPU rows take
    the plain version."""
    _check_bodies(rows)
    dev, length = rows[0].device, rows[0].numel()
    if dev.type == "cpu":
        return crc32c_plain(torch.stack(rows))
    return _launch(dev, len(rows), src=[r.data_ptr() for r in rows],
                   pitch=[KERNEL_SEG] * len(rows), length=length,
                   max_len=length)


def crc32c_rows_per_thread(rows: List[torch.Tensor]) -> torch.Tensor:
    """``crc32c_rows_kernel`` through the per-thread path on CUDA rows,
    for chip_smoke's A/B only: no plain version and no launch count."""
    _check_bodies(rows)
    return _launch(rows[0].device, len(rows),
                   src=[r.data_ptr() for r in rows],
                   pitch=[KERNEL_SEG] * len(rows), length=rows[0].numel(),
                   max_len=rows[0].numel(), per_thread=True, count=False)


def crc32c_gather_kernel(pieces: List[torch.Tensor],
                         bodies: List[torch.Tensor]) -> torch.Tensor:
    """Copy each (S, C) uint8 source (rows at any pitch, bytes
    contiguous) into its body of S*C bytes and return the bodies' CRCs,
    in one pass: the kernel reads each source once, writes its body and
    hashes it (segments of C bytes).  CPU tensors take a plain copy and
    the plain CRC."""
    _check_bodies(bodies)
    if len(pieces) != len(bodies):
        raise ValueError(f"{len(pieces)} sources for {len(bodies)} bodies")
    s, c = pieces[0].shape
    dev = bodies[0].device
    for p in pieces:
        if p.shape != (s, c) or p.dtype != torch.uint8 or p.device != dev \
                or (c > 1 and p.stride(1) != 1):
            raise ValueError("sources must be (S, C) uint8 with contiguous "
                             "rows, one shape, on the bodies' device")
    if bodies[0].numel() != s * c:
        raise ValueError(f"bodies of {bodies[0].numel()} bytes for "
                         f"({s}, {c}) sources")
    if dev.type == "cpu":
        for p, b in zip(pieces, bodies):
            b.view(s, c).copy_(p)
        return crc32c_plain(torch.stack(bodies))
    if s * c == 0:
        return _launch(dev, len(bodies), src=[b.data_ptr() for b in bodies],
                       pitch=[KERNEL_SEG] * len(bodies), max_len=0)
    return _launch(dev, len(bodies), src=[p.data_ptr() for p in pieces],
                   dst=[b.data_ptr() for b in bodies],
                   pitch=[p.stride(0) if s > 1 else c for p in pieces],
                   length=s * c, max_len=s * c, seg=c)


# ---- the JAX module's entry points ------------------------------------------
def crc_core(bodies: torch.Tensor) -> torch.Tensor:
    """(n, L) uint8 bodies -> (n,) int32 CRC bits on the same device."""
    return crc32c_kernel(bodies)


def _host_rows(arr2d, device) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(arr2d, dtype=np.uint8))
    if a.ndim != 2:
        raise ValueError(f"expected (n, L) bytes, got shape {a.shape}")
    return torch.from_numpy(a).to(resolve_device(device))


def crc32c_device_batch(arr2d, device="cuda") -> np.ndarray:
    """Host entry: (n, L) uint8 -> (n,) numpy uint32 CRCs, computed on
    ``device`` (the card unless the caller asks for the CPU)."""
    return to_u32(crc32c_kernel(_host_rows(arr2d, device)))


def crc32c_of_device_array(dev: torch.Tensor) -> int:
    """CRC of a 1-D uint8 tensor where it lies: only the 4-byte result
    comes back.  Any offset into a buffer is taken (the scrub and
    read-verify path of still-resident shards)."""
    if dev.dim() != 1:
        raise ValueError(f"expected a 1-D tensor, got {tuple(dev.shape)}")
    out = to_u32(crc32c_kernel(dev.view(1, -1)))
    g_devprof.account_d2h("crc32c.verify_fetch", out.nbytes)
    return int(out[0])


def crc32c_device_padded(padded2d, lengths, device="cuda") -> np.ndarray:
    """Property-test entry: (n, L8) uint8 (L8 a multiple of 8) with
    per-row lengths -> (n,) numpy uint32, computed on ``device``."""
    rows = _host_rows(padded2d, device)
    if rows.shape[1] % 8:
        raise ValueError(f"padded width {rows.shape[1]} is not a multiple "
                         "of 8")
    return to_u32(crc32c_kernel(rows, lengths))
