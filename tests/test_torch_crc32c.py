"""The port's crc32c (host, plain device version, kernel scheme) and
HashInfo against the JAX package's, byte-exact.

Port side: ``ceph_tpu_torch.utils.crc32c`` (host) and
``ceph_tpu_torch.ops.crc32c_device`` with ``device="cpu"`` (the plain
PyTorch version of the CUDA kernel).  Reference side:
``ceph_tpu.utils.crc32c`` and ``ceph_tpu.ops.crc32c_device`` (its XLA
function on the CPU).  Inputs are seeded numpy bytes; the tolerance is
exact: these are integer functions.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ceph_tpu.ops import crc32c_device as jax_crc
from ceph_tpu.osd import ecutil as jax_ecutil
from ceph_tpu.utils.crc32c import crc32c as jax_host_crc
from ceph_tpu.utils.crc32c import _TABLE as JAX_TABLE

from ceph_tpu_torch.ops import crc32c_device as port_crc
from ceph_tpu_torch.osd import ecutil as port_ecutil
from ceph_tpu_torch.utils.crc32c import _TABLE, crc32c, crc32c_sw


def _sweep(seed=20260807):
    """Every length 0..4097 in one padded (4098, 4104) batch."""
    rng = np.random.default_rng(seed)
    lengths = np.arange(0, 4098, dtype=np.uint32)
    padded = np.zeros((len(lengths), 4104), dtype=np.uint8)
    for i, n in enumerate(lengths):
        padded[i, :n] = rng.integers(0, 256, size=int(n), dtype=np.uint8)
    return padded, lengths


@pytest.fixture(scope="module")
def sweep():
    return _sweep()


def test_tables_match_jax():
    np.testing.assert_array_equal(_TABLE, JAX_TABLE)
    np.testing.assert_array_equal(port_crc._slicing_tables_np(),
                                  jax_crc._slicing_tables_np())


def test_host_sweep_matches_jax(sweep):
    """Port host crc32c_sw = JAX host crc32c at every length 0..4097."""
    padded, lengths = sweep
    for i, n in enumerate(lengths):
        assert crc32c_sw(padded[i, :n]) == jax_host_crc(padded[i, :n]), n


def test_padded_sweep_matches_jax(sweep):
    """Port crc32c_device_padded (plain, CPU) = JAX crc32c_device_padded
    = the host CRC, for every length 0..4097 in one call."""
    padded, lengths = sweep
    got = port_crc.crc32c_device_padded(padded, lengths, device="cpu")
    want = jax_crc.crc32c_device_padded(padded, lengths)
    assert got.dtype == np.uint32 and got.shape == (len(lengths),)
    np.testing.assert_array_equal(got, np.asarray(want))
    for i in (0, 1, 7, 8, 9, 255, 256, 257, 4095, 4096, 4097):
        assert int(got[i]) == crc32c(padded[i, :lengths[i]])


@pytest.mark.parametrize("width", [0, 1, 9, 4096, 12289])
def test_batch_and_single_match_jax(width):
    rng = np.random.default_rng(width + 7)
    rows = rng.integers(0, 256, size=(5, width), dtype=np.uint8)
    got = port_crc.crc32c_device_batch(rows, device="cpu")
    # the JAX device entries cannot index empty rows: the host CRC there
    np.testing.assert_array_equal(got, np.asarray(
        jax_crc.crc32c_device_batch(rows)) if width else
        [jax_host_crc(r) for r in rows])
    for i in range(rows.shape[0]):
        want = jax_crc.crc32c_of_device_array(jnp.asarray(rows[i])) \
            if width else jax_host_crc(rows[i])
        assert port_crc.crc32c_of_device_array(
            torch.from_numpy(rows[i])) == want == int(got[i])


def test_misaligned_view_and_row_stride():
    """A 1-D view one byte into its buffer, and rows whose stride is not
    their width, hash as their bytes."""
    rng = np.random.default_rng(5)
    buf = rng.integers(0, 256, size=(4, 9000), dtype=np.uint8)
    t = torch.from_numpy(buf)
    flat = t.reshape(-1)[1:8193]
    assert flat.storage_offset() == 1
    assert port_crc.crc32c_of_device_array(flat) == \
        jax_host_crc(buf.reshape(-1)[1:8193])
    view = t[:, 3:4100]
    got = port_crc.to_u32(port_crc.crc32c_kernel(view))
    for i in range(4):
        assert int(got[i]) == jax_host_crc(buf[i, 3:4100])


def test_seed_convention_matches_ceph():
    """Seed -1, no final inversion: the empty buffer hashes to the seed."""
    assert crc32c(b"") == 0xFFFFFFFF == jax_host_crc(b"")
    got = port_crc.crc32c_device_padded(np.zeros((1, 8), dtype=np.uint8),
                                        np.zeros(1, dtype=np.uint32),
                                        device="cpu")
    assert int(got[0]) == 0xFFFFFFFF
    empty = port_crc.crc32c_device_batch(np.zeros((3, 0), np.uint8),
                                         device="cpu")
    assert list(empty) == [0xFFFFFFFF] * 3
    # the standard check value is the inverted register
    assert crc32c(b"123456789") ^ 0xFFFFFFFF == 0xE3069283


def _advance_np(x: int, nbytes: int) -> int:
    """Register x advanced over nbytes zero bytes by the M_{2^e}."""
    mats = port_crc._pow2_matrices_np()
    v = np.uint32(x)
    for e in range(nbytes.bit_length()):
        if nbytes >> e & 1:
            v = port_crc._apply_np(mats[e], np.array(v, np.uint32))
    return int(v)


@pytest.mark.parametrize("split", [0, 1, 7, 8, 4095, 4096, 4097, 8192,
                                   12288, 12289])
def test_combine_identity(split):
    """crc(c, A || B) = crc(0, B) ^ M_|B| crc(c, A) at split points."""
    data = np.random.default_rng(split).integers(0, 256, 12289, np.uint8)
    a, b = data[:split], data[split:]
    for seed in (0xFFFFFFFF, 0, 0x12345678):
        whole = crc32c(data, seed)
        assert whole == jax_host_crc(data, seed)
        assert whole == crc32c(b, 0) ^ _advance_np(crc32c(a, seed), len(b))


def _kernel_scheme(row: np.ndarray, seg: int = 4096) -> int:
    """numpy emulation of csrc/crc32c.cu: segments of ``seg`` bytes
    aligned to the row's end, the first from the seed and the rest from
    0, each advanced over the whole segments after it with the kernel's
    matrices ``advance_cols_np(seg)``, XORed together."""
    adv = port_crc.advance_cols_np(seg)
    length = len(row)
    nseg = (length + seg - 1) // seg if length else 1
    l0 = length - (nseg - 1) * seg
    out = 0
    for j in range(nseg):
        v = crc32c(row[:l0]) if j == 0 else \
            crc32c(row[l0 + (j - 1) * seg:l0 + j * seg], 0)
        r, b = nseg - 1 - j, 0
        while r:
            if r & 1:
                v = int(port_crc._apply_np(adv[b], np.array(v, np.uint32)))
            r, b = r >> 1, b + 1
        out ^= v
    return out


@pytest.mark.parametrize("length", [0, 1, 15, 4095, 4096, 4097, 8192,
                                    12289, 5 * 4096 + 3])
def test_kernel_scheme_matches_jax(length):
    row = np.random.default_rng(length).integers(0, 256, length, np.uint8)
    assert _kernel_scheme(row) == jax_host_crc(row)


@pytest.mark.parametrize("seg", [1, 100, 4096, 5000])
def test_kernel_scheme_any_segment(seg):
    """The gather mode hashes rows of S pieces with seg = C."""
    row = np.random.default_rng(seg).integers(0, 256, 7 * seg, np.uint8)
    assert _kernel_scheme(row, seg) == jax_host_crc(row)


def _nib_word(x: int, k: int, nib: np.ndarray) -> int:
    """The kernel's nib_word: tables k + 2b / k + 2b + 1 at the low /
    high nibble of byte b of x."""
    r = 0
    for b in range(4):
        byte = x >> 8 * b & 255
        r ^= int(nib[k + 2 * b][byte & 15]) ^ \
            int(nib[k + 2 * b + 1][byte >> 4])
    return r


def _coalesced_scheme(buf: np.ndarray, length: int, ws: int,
                      piece: int = 0, pitch: int = 0) -> int:
    """numpy emulation of the coalesced path of csrc/crc32c.cu, index
    arithmetic and table layout included: a row of ``length`` bytes at
    the start of ``buf`` (contiguous, or pieces of ``piece`` bytes
    ``pitch`` apart) is taken with zeros in front up to whole runs of
    ``ws`` bytes; in iteration i lane l takes the chunks at
    i * ITER + 512 u + 16 l and keeps acc <- M_ITER acc ^ sum_u
    M_{512 (3-u)} crc(0, chunk_u), all by nibble-table lookups; the run
    is sum_l M_{16 (31 - l)} acc_l, advanced over the runs after it; the
    seed enters as M_L 0xFFFFFFFF."""
    it, nch = port_crc.ITER, port_crc.CHUNKS
    tabs = port_crc.coalesced_tables_np()
    ntab = nch * 32 + 8
    nib = tabs[:ntab * 16].reshape(ntab, 16)
    lanes = tabs[ntab * 16:ntab * 16 + 1024].reshape(32, 32)
    pow2 = tabs[ntab * 16 + 1024:].reshape(-1, 32)
    adv = port_crc.advance_cols_np(ws)
    runs = max(1, -(-length // ws))
    z = runs * ws - length
    out = 0
    for w in range(runs):
        o = w * ws - z
        pidx, within = (o // piece, o % piece) if piece and o > 0 else (0, 0)
        accs = [0] * 32
        for _ in range(ws // it):
            for lane in range(32):
                a = _nib_word(accs[lane], nch * 32, nib)
                for u in range(nch):
                    co = o + 512 * u + 16 * lane
                    at = pidx * pitch + within + 512 * u + 16 * lane \
                        if piece else co
                    chunk = bytes(buf[at:at + 16]) if co >= 0 else bytes(16)
                    words = np.frombuffer(chunk, "<u4")
                    for q in range(4):
                        a ^= _nib_word(int(words[q]), u * 32 + 8 * q, nib)
                accs[lane] = a
            o += it
            if piece and o > 0:
                within += it
                if within == piece:
                    within, pidx = 0, pidx + 1
        x = 0
        for lane in range(32):
            x ^= int(port_crc._apply_np(lanes[lane],
                                        np.array(accs[lane], np.uint32)))
        r, b = runs - 1 - w, 0
        while r:
            if r & 1:
                x = int(port_crc._apply_np(adv[b], np.array(x, np.uint32)))
            r, b = r >> 1, b + 1
        out ^= x
    seed = np.array(0xFFFFFFFF, np.uint32)
    for e in range(length.bit_length()):
        if length >> e & 1:
            seed = port_crc._apply_np(pow2[e], seed)
    return out ^ int(seed)


@pytest.mark.parametrize("length,ws", [(0, 2048), (16, 2048), (2048, 2048),
                                       (2064, 2048), (6144, 4096),
                                       (3 * 4096 + 48, 4096)])
def test_coalesced_scheme_matches_jax(length, ws):
    row = np.random.default_rng(length + ws).integers(0, 256, length,
                                                      np.uint8)
    assert _coalesced_scheme(row, length, ws) == jax_host_crc(row)


@pytest.mark.parametrize("s,ws", [(1, 2048), (3, 4096), (5, 4096)])
def test_coalesced_scheme_pieces(s, ws):
    """Rows of pieces (chunk 1 of s stripes of k=3 chunks of 2048 B)."""
    c, k = 2048, 3
    stripes = np.random.default_rng(s).integers(0, 256, (s, k, c), np.uint8)
    flat = stripes.reshape(-1)[c:]               # chunk 1 of stripe 0 on
    want = jax_host_crc(stripes[:, 1].reshape(-1))
    assert _coalesced_scheme(flat, s * c, ws, piece=c, pitch=k * c) == want


def test_coalesced_run_sizes():
    """Runs shrink until there are warps for the card, never below one
    iteration, and stay a power of two times ITER."""
    assert port_crc._run_bytes(12, 32 << 20) == 32 * port_crc.ITER
    assert port_crc._run_bytes(12, 512 << 10) == port_crc.ITER
    assert port_crc._run_bytes(1, 16) == port_crc.ITER


def test_advance_matrices():
    """M_{4096 * 2^b} is M_{2^(12 + b)}; advancing by seg then by seg
    again is advancing by 2 seg."""
    pow2 = port_crc._pow2_matrices_np()
    np.testing.assert_array_equal(port_crc.advance_cols_np(4096)[:36],
                                  pow2[12:])
    a = port_crc.advance_cols_np(100)
    np.testing.assert_array_equal(port_crc._apply_np(a[0], a[0]),
                                  port_crc.advance_cols_np(200)[0])
    with pytest.raises(ValueError):
        port_crc.advance_cols_np(0)


def test_gather_plain_copies_and_hashes():
    """The plain side of the gather: each strided (S, C) source lands in
    its body and the CRCs are the bodies' host CRCs."""
    rng = np.random.default_rng(12)
    stripes = torch.from_numpy(rng.integers(0, 256, (5, 3, 77), np.uint8))
    pieces = [stripes[:, i] for i in range(3)]
    bodies = [torch.empty(5 * 77, dtype=torch.uint8) for _ in range(3)]
    got = port_crc.to_u32(port_crc.crc32c_gather_kernel(pieces, bodies))
    for i in range(3):
        want = stripes[:, i].numpy().reshape(-1)
        np.testing.assert_array_equal(bodies[i].numpy(), want)
        assert int(got[i]) == jax_host_crc(want)
    with pytest.raises(ValueError):
        port_crc.crc32c_gather_kernel(pieces, bodies[:2])
    with pytest.raises(ValueError):
        port_crc.crc32c_gather_kernel(
            pieces, [torch.empty(5, dtype=torch.uint8)] * 3)


def test_plain_handles_crcs_above_2_31():
    """CRC bits travel as int32 on the device; to_u32 gives them back."""
    rng = np.random.default_rng(11)
    rows = rng.integers(0, 256, size=(64, 33), dtype=np.uint8)
    got = port_crc.crc32c_device_batch(rows, device="cpu")
    assert (got >= 1 << 31).any() and (got < 1 << 31).any()
    np.testing.assert_array_equal(got, np.asarray(
        jax_crc.crc32c_device_batch(rows)))


def test_lengths_validated():
    with pytest.raises(ValueError):
        port_crc.crc32c_device_padded(np.zeros((2, 7), np.uint8), [1, 2],
                                      device="cpu")
    with pytest.raises(ValueError):
        port_crc.crc32c_device_padded(np.zeros((2, 8), np.uint8), [1, 9],
                                      device="cpu")
    with pytest.raises(ValueError):
        port_crc.crc32c_device_padded(np.zeros((2, 8), np.uint8), [1],
                                      device="cpu")


def test_hashinfo_matches_jax():
    """Two cumulative appends of k+m shard buffers: dump() equal."""
    n = 6
    rng = np.random.default_rng(3)
    port, ref = port_ecutil.HashInfo(n), jax_ecutil.HashInfo(n)
    assert port.has_chunk_hash() and port.dump() == ref.dump()
    size = 0
    for step, chunk in enumerate((4096, 1000)):
        bufs = {i: rng.integers(0, 256, chunk, np.uint8) for i in range(n)}
        port.append(size, bufs)
        ref.append(size, bufs)
        size += chunk
        assert port.dump() == ref.dump(), step
    assert port.get_total_chunk_size() == size == ref.get_total_chunk_size()
    for i in range(n):
        assert port.get_chunk_hash(i) == ref.get_chunk_hash(i)
    assert not port_ecutil.HashInfo().has_chunk_hash()


@pytest.mark.parametrize("make", [
    lambda rng: np.arange(64, dtype=np.uint8)[::2],
    lambda rng: rng.integers(0, 256, (7, 33), dtype=np.uint8),
    lambda rng: rng.integers(0, 1 << 16, 41, dtype=np.uint16),
], ids=["strided_view", "u8_2d", "u16"])
def test_host_crc_semantics_pinned_to_crc32c_sw(make):
    """The port's host crc32c of a strided view, a 2-D array and a u16
    array is the JAX ``crc32c_sw`` of the same array: the array's elements
    as uint8 in C order (a u16 element keeps its low byte), not its raw
    memory."""
    from ceph_tpu.utils.crc32c import crc32c_sw as jax_sw
    arr = make(np.random.default_rng(99))
    assert crc32c(arr) == jax_sw(arr)
    assert crc32c(arr) == crc32c(np.ascontiguousarray(arr, dtype=np.uint8)
                                 .tobytes())
    if arr.ndim == 1 and arr.dtype == np.uint8:
        assert crc32c(arr) == 3894026348
