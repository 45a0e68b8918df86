"""The port's GF(2^w) word-layout bit-matmul (K3) against the JAX package,
byte-exact (tolerance 0: every value is a GF(2^w) word).

The port runs on the CPU here (``gfw_bit_matmul_plain`` behind the
wrapper); the CUDA kernel is held against the same plain version on the
card by chip_smoke.py.  What the kernel computes from the host's tables
(``pack_tables`` of the (k*w, r*w) matrix over k*w/8 virtual rows) is
pinned by ``_word_scheme``, a numpy emulation of the kernel's index
arithmetic: the byte-permute split of 16 words into virtual rows, the
nibble lookups, the join back into words and the tail.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.gf.word_codec import reed_sol_van_matrix_w as jax_van_w
from ceph_tpu.ops.gf_matmul import DeviceWordRSBackend as JaxWordBackend
from ceph_tpu.ops.gf_matmul import expand_to_bitmatrix_w as jax_expand_w
from ceph_tpu.ops.gf_matmul import gfw_bit_matmul as jax_gfw_bit_matmul

from ceph_tpu_torch.gf.word_codec import reed_sol_van_matrix_w
from ceph_tpu_torch.ops import gf_matmul as tgm
from ceph_tpu_torch.ops import gf_pallas as tgp

SHAPES = [(4, 2), (5, 3), (1, 1)]


def _bits(k, m, w):
    return tgm.expand_to_bitmatrix_w(reed_sol_van_matrix_w(k, m, w), w)


def _jax(data, bits, w):
    return np.asarray(jax_gfw_bit_matmul(
        jnp.asarray(data), jnp.asarray(bits.astype(np.int8)), w))


def _port(data, bits, w):
    return tgm.gfw_bit_matmul(torch.from_numpy(data), bits, w).numpy()


@pytest.mark.parametrize("w", [16, 32])
@pytest.mark.parametrize("k,m", SHAPES)
def test_plain_matches_jax(w, k, m):
    """jerasure reed_sol_van's companion bitmatrix and a random 0/1 one,
    whole and ragged chunks (C a multiple of w/8 only)."""
    rng = np.random.default_rng(w * 100 + k * 10 + m)
    ws = w // 8
    for bits in (_bits(k, m, w),
                 rng.integers(0, 2, (k * w, m * w), dtype=np.uint8)):
        for c in (96, 13 * ws):
            data = rng.integers(0, 256, (3, k, c), dtype=np.uint8)
            got = _port(data, bits, w)
            assert got.shape == (3, m, c)
            np.testing.assert_array_equal(got, _jax(data, bits, w))


@pytest.mark.parametrize("w", [8, 16, 32])
def test_expand_to_bitmatrix_w_matches_jax(w):
    coding = jax_van_w(5, 3, w) if w > 8 else jax_van_w(5, 3, 8)
    np.testing.assert_array_equal(tgm.expand_to_bitmatrix_w(coding, w),
                                  jax_expand_w(coding, w))
    if w > 8:
        np.testing.assert_array_equal(reed_sol_van_matrix_w(5, 3, w), coding)


def _virtual(data: np.ndarray, ws: int) -> np.ndarray:
    """(S, k, C) words -> (S, k*ws, C/ws): virtual row j*ws + b is byte b
    of every word of row j."""
    s, k, c = data.shape
    return np.ascontiguousarray(
        data.reshape(s, k, c // ws, ws).transpose(0, 1, 3, 2)).reshape(
            s, k * ws, c // ws)


@pytest.mark.parametrize("w", [16, 32])
@pytest.mark.parametrize("k,m", SHAPES)
def test_virtual_layout_identity(w, k, m):
    """K3 is K1's product over the virtual byte layout: the (k*w, m*w)
    matrix is K1's (8k', 8r') matrix with k' = k*w/8, r' = m*w/8, its
    tables are pack_tables unchanged, and K1 over the de-interleaved data,
    re-interleaved, gives the word product."""
    ws = w // 8
    bits = _bits(k, m, w)
    tab = tgp.pack_tables(bits)
    assert tab.shape == ((m * ws + 3) // 4, k * ws, 32)
    rng = np.random.default_rng(w + k)
    data = rng.integers(0, 256, (2, k, 40 * ws), dtype=np.uint8)
    virt = tgp.gf_bit_matmul_plain(torch.from_numpy(_virtual(data, ws)),
                                   torch.from_numpy(bits)).numpy()
    back = virt.reshape(2, m, ws, 40).transpose(0, 1, 3, 2).reshape(
        2, m, 40 * ws)
    np.testing.assert_array_equal(back, _port(data, bits, w))


def _prmt(a: np.ndarray, b: np.ndarray, sel: int) -> np.ndarray:
    """__byte_perm(a, b, sel) on u32 arrays: byte i of the result is byte
    (sel >> 4i) & 7 of the eight bytes a, b (a's first)."""
    by = np.stack([(a >> (8 * i)) & 0xFF for i in range(4)]
                  + [(b >> (8 * i)) & 0xFF for i in range(4)])
    out = np.zeros_like(a)
    for i in range(4):
        out |= by[(sel >> (4 * i)) & 7] << np.uint32(8 * i)
    return out


def _transpose4(a):
    """lookup.cuh transpose() on one group of four words: o[q][c] byte b
    is byte q of a[4c + b]."""
    o = [[None] * 4 for _ in range(4)]
    for c in range(4):
        x = a[4 * c:4 * c + 4]
        t0, t1 = _prmt(x[0], x[1], 0x5140), _prmt(x[0], x[1], 0x7362)
        t2, t3 = _prmt(x[2], x[3], 0x5140), _prmt(x[2], x[3], 0x7362)
        o[0][c], o[1][c] = _prmt(t0, t2, 0x5410), _prmt(t0, t2, 0x7632)
        o[2][c], o[3][c] = _prmt(t1, t3, 0x5410), _prmt(t1, t3, 0x7632)
    return o


def _word_scheme(data: np.ndarray, tables: np.ndarray, r: int,
                 ws: int) -> np.ndarray:
    """The K3 kernel's arithmetic in numpy, over all items at once.  An
    item is 16 words (16*ws bytes) of every row of one stripe, the tail
    read as zeros (the byte path); load_words splits a row's 4*ws u32
    into ws virtual 16-byte rows; the lookups are K1's; store_words joins
    each group's four virtual output rows into 4/ws real rows and stores
    the item's valid bytes."""
    s, k, c = data.shape
    kb = 16 * ws
    items = -(-c // kb)
    pad = np.zeros((s, k, items * kb), dtype=np.uint8)
    pad[..., :c] = data
    x = np.ascontiguousarray(pad).view("<u4").reshape(s, k, items, 4 * ws)
    x = [x[..., i].astype(np.uint32) for i in range(4 * ws)]
    if ws == 2:        # split[b][c]: word c of virtual row j*ws + b
        split = [[_prmt(x[2 * c_], x[2 * c_ + 1], sel) for c_ in range(4)]
                 for sel in (0x6420, 0x7531)]
    else:
        split = _transpose4(x)
    virt = np.stack([np.stack(split[b], axis=-1) for b in range(ws)],
                    axis=2)                    # (S, k, ws, items, 4)
    virt = virt.reshape(s, k * ws, items, 4)
    vbytes = virt.view(np.uint8).reshape(s, k * ws, items, 16)  # column v
    out = np.zeros((s, r, items * kb), dtype=np.uint8)
    for g in range(tables.shape[0]):
        acc = np.zeros((s, items, 16), dtype=np.uint32)
        for i in range(k * ws):
            col = vbytes[:, i]                 # (S, items, 16)
            acc ^= tables[g, i, col & 15] ^ tables[g, i, 16 + (col >> 4)]
        row0 = g * 4 // ws
        for t in range(4 // ws):
            if row0 + t >= r:
                break
            if ws == 4:
                o = [acc[..., c_] for c_ in range(16)]
            else:
                o = [_prmt(acc[..., 2 * c_], acc[..., 2 * c_ + 1],
                           0x7632 if t else 0x5410) for c_ in range(8)]
            words = np.stack(o, axis=-1).astype("<u4")  # (S, items, 4ws)
            out[:, row0 + t] = words.view(np.uint8).reshape(s, items * kb)
    return out[..., :c]


@pytest.mark.parametrize("w", [16, 32])
@pytest.mark.parametrize("k,m,c", [(4, 2, 4096), (5, 3, 4096 + 12),
                                   (1, 1, 4), (3, 1, 100), (6, 5, 200)])
def test_word_scheme_matches_plain(w, k, m, c):
    """The kernel's emulation against the plain version and the JAX
    function: whole items, a ragged tail, C = w/8 (one word), odd r at
    w = 16 (a half group), several groups; random 0/1 matrices too."""
    ws = w // 8
    c -= c % ws
    rng = np.random.default_rng(w * 1000 + k * 10 + m + c)
    data = rng.integers(0, 256, (2, k, c), dtype=np.uint8)
    for bits in (_bits(k, m, w),
                 rng.integers(0, 2, (k * w, m * w), dtype=np.uint8)):
        got = _word_scheme(data, tgp.pack_tables(bits), m, ws)
        want = _port(data, bits, w)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, _jax(data, bits, w))


@pytest.mark.parametrize("w,k", [(16, 128), (32, 64)])
def test_word_scheme_at_256_virtual_rows(w, k):
    """k' = k*w/8 = 256, the most the kernel takes."""
    ws = w // 8
    rng = np.random.default_rng(k)
    bits = rng.integers(0, 2, (k * w, 2 * w), dtype=np.uint8)
    data = rng.integers(0, 256, (1, k, 20 * ws), dtype=np.uint8)
    got = _word_scheme(data, tgp.pack_tables(bits), 2, ws)
    np.testing.assert_array_equal(got, _port(data, bits, w))


def test_word_wrapper_validates():
    bm16 = tgp.BitMatrix(_bits(4, 2, 16), "cpu")
    ok = torch.zeros((1, 4, 8), dtype=torch.uint8)
    assert tgp.gfw_bit_matmul_kernel(ok, bm16, 16).shape == (1, 2, 8)
    for data, bm, w in (
            (ok, bm16, 8),                                     # w
            (ok, bm16, 32),                                    # k*w != rows
            (torch.zeros((1, 3, 8), dtype=torch.uint8), bm16, 16),
            (torch.zeros((1, 4, 7), dtype=torch.uint8), bm16, 16),  # C
            (ok.to(torch.int16), bm16, 16),
            (torch.zeros((1, 129, 8), dtype=torch.uint8),
             tgp.BitMatrix(np.zeros((129 * 16, 16), np.uint8), "cpu"), 16),
            (ok, tgp.BitMatrix(np.zeros((64, 24), np.uint8), "cpu"), 16)):
        with pytest.raises(ValueError):
            tgp.gfw_bit_matmul_kernel(data, bm, w)


@pytest.mark.parametrize("w", [16, 32])
def test_word_backend_matches_jax(w):
    """DeviceWordRSBackend on the CPU encodes as the JAX backend does, and
    backend_from_matrix of the JAX jerasure plugin's int64 matrix gives
    the same backend."""
    from ceph_tpu.ec import create_erasure_code as jax_create
    jc = jax_create({"plugin": "jerasure", "k": "4", "m": "2",
                     "w": str(w), "backend": "host"})
    mat = jc.codec.matrix
    assert mat.dtype == np.int64
    be = tgm.backend_from_matrix(mat, "cpu", w=w)
    assert isinstance(be, tgm.DeviceWordRSBackend) and be.w == w
    rng = np.random.default_rng(w)
    data = rng.integers(0, 256, (3, 4, 64), dtype=np.uint8)
    want = JaxWordBackend(mat, w).encode(data)
    np.testing.assert_array_equal(be.encode(data), want)
    flat = np.ascontiguousarray(data.transpose(1, 0, 2)).reshape(4, -1)
    np.testing.assert_array_equal(
        jc.codec.encode(flat).reshape(2, 3, 64).transpose(1, 0, 2), want)
    with pytest.raises(ValueError):
        tgm.backend_from_matrix(mat, "cpu")               # entries > 255
    with pytest.raises(ValueError):
        tgm.backend_from_matrix(mat, "cpu", w=12)


def test_backend_from_bitmatrix_virtual_matrix():
    """The virtual 0/1 packet matrix of a JAX cauchy_good plugin carries
    over as a GF(2^8) matrix: the port's backend encodes the virtual
    layout as the JAX backend does."""
    from ceph_tpu.ec import create_erasure_code as jax_create
    from ceph_tpu.ops.gf_matmul import DeviceRSBackend as JaxBackend
    jc = jax_create({"plugin": "jerasure", "technique": "cauchy_good",
                     "k": "4", "m": "2", "packetsize": "8",
                     "backend": "host"})
    mat = jc.codec.matrix
    assert mat.shape == (48, 32)
    be = tgm.backend_from_matrix(mat, "cpu")
    assert isinstance(be, tgm.DeviceRSBackend)
    data = np.random.default_rng(3).integers(0, 256, (2, 32, 16),
                                             dtype=np.uint8)
    np.testing.assert_array_equal(be.encode(data),
                                  JaxBackend(mat).encode(data))
