"""The port's GF(2^8) bit-matmul and its host tables against the JAX
package, byte-exact (tolerance 0: every value is an element of GF(2^8)).

The port runs on the CPU here (its plain PyTorch version, ``device="cpu"``);
the CUDA kernel is held against the same plain version on the card by
chip_smoke.py.  Inputs come from numpy and go to both sides.  What the host
hands the kernel (the nibble tables of ``pack_tables``) is pinned here by a
numpy emulation of the kernel's lookups.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.gf import matrices as jmat
from ceph_tpu.gf import tables as jtab
from ceph_tpu.ops.gf_matmul import DeviceRSBackend as JaxBackend
from ceph_tpu.ops.gf_matmul import gf_bit_matmul as jax_gf_bit_matmul
from ceph_tpu.ops.gf_pallas import gf_bit_matmul_pallas

from ceph_tpu_torch.gf import matrices as tmat
from ceph_tpu_torch.gf import tables as ttab
from ceph_tpu_torch.ops import gf_matmul as tgm
from ceph_tpu_torch.ops import gf_pallas as tgp

GENS = {"reed_sol_van": (jmat.gf_gen_rs_matrix, tmat.gf_gen_rs_matrix),
        "cauchy": (jmat.gf_gen_cauchy1_matrix, tmat.gf_gen_cauchy1_matrix)}


def _port(data: np.ndarray, bits: np.ndarray) -> np.ndarray:
    return tgm.gf_bit_matmul(torch.from_numpy(data), bits).numpy()


def _jax(data: np.ndarray, bits: np.ndarray) -> np.ndarray:
    return np.asarray(jax_gf_bit_matmul(jnp.asarray(data),
                                        jnp.asarray(bits.astype(np.int8))))


def test_tables_equal_jax():
    np.testing.assert_array_equal(ttab.gf_exp, jtab.gf_exp)
    np.testing.assert_array_equal(ttab.gf_log, jtab.gf_log)
    np.testing.assert_array_equal(ttab.MUL_TABLE, jtab.MUL_TABLE)
    rng = np.random.default_rng(0)
    for a, b in rng.integers(1, 256, (64, 2)):
        a, b = int(a), int(b)
        assert ttab.gf_mul(a, b) == jtab.gf_mul(a, b)
        assert ttab.gf_div(a, b) == jtab.gf_div(a, b)
        assert ttab.gf_inv(a) == jtab.gf_inv(a)
        assert ttab.gf_pow(a, b) == jtab.gf_pow(a, b)
        np.testing.assert_array_equal(ttab.gf_mult_bitmatrix(a),
                                      jtab.gf_mult_bitmatrix(a))


@pytest.mark.parametrize("tech", sorted(GENS))
@pytest.mark.parametrize("k,m", [(2, 1), (4, 2), (8, 4), (21, 4), (32, 3)])
def test_matrices_equal_jax(tech, k, m):
    jgen, tgen = GENS[tech]
    a = jgen(k + m, k)
    b = tgen(k + m, k)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ttab.expand_to_bitmatrix(b[k:]),
                                  jtab.expand_to_bitmatrix(a[k:]))
    sub = a[list(range(m, k + m))]
    np.testing.assert_array_equal(tmat.gf_invert_matrix(sub),
                                  jmat.gf_invert_matrix(sub))
    np.testing.assert_array_equal(tmat.gf_matmul(a[k:], sub),
                                  jmat.gf_matmul(a[k:], sub))


@pytest.mark.parametrize("s,k,m,c", [(4, 8, 4, 512), (1, 4, 2, 128),
                                     (3, 6, 3, 1152)])
def test_plain_matches_jax_and_pallas(s, k, m, c):
    """The shapes of tests/test_gf_matmul_device.py's Pallas parity test;
    the Pallas kernel interprets on the CPU as it does there."""
    rng = np.random.default_rng(9)
    data = rng.integers(0, 256, (s, k, c), dtype=np.uint8)
    bits = jtab.expand_to_bitmatrix(jmat.gf_gen_rs_matrix(k + m, k)[k:])
    got = _port(data, bits)
    np.testing.assert_array_equal(got, _jax(data, bits))
    pallas = np.asarray(gf_bit_matmul_pallas(
        jnp.asarray(data), jnp.asarray(bits.astype(np.int8))))
    np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("s,k,r,c,tech", [
    (2, 4, 2, 32, "reed_sol_van"), (3, 8, 4, 33, "reed_sol_van"),
    (2, 21, 4, 96, "reed_sol_van"), (1, 2, 1, 1, "reed_sol_van"),
    (2, 40, 3, 65, "cauchy"), (5, 8, 4, 96, "cauchy")])
def test_plain_matches_jax_ragged(s, k, r, c, tech):
    """Shapes the Pallas kernel refuses (C % 128 != 0) but the XLA
    function and the port's kernel take."""
    rng = np.random.default_rng(s * 1000 + k * 10 + c)
    data = rng.integers(0, 256, (s, k, c), dtype=np.uint8)
    bits = jtab.expand_to_bitmatrix(GENS[tech][0](k + r, k)[k:])
    np.testing.assert_array_equal(_port(data, bits), _jax(data, bits))


def test_plain_walks_stripes_in_chunks(monkeypatch):
    """A batch larger than one chunk of unpacked planes gives the same
    bytes as one pass."""
    rng = np.random.default_rng(4)
    data = rng.integers(0, 256, (7, 4, 64), dtype=np.uint8)
    bits = jtab.expand_to_bitmatrix(jmat.gf_gen_rs_matrix(6, 4)[4:])
    whole = _port(data, bits)
    monkeypatch.setattr(tgp, "_PLAIN_CHUNK_BYTES", 2 * 64 * 4 * 8 * 4)
    np.testing.assert_array_equal(_port(data, bits), whole)
    np.testing.assert_array_equal(whole, _jax(data, bits))


@pytest.mark.parametrize("k,r", [(2, 1), (8, 4), (9, 2), (21, 4), (40, 3)])
def test_pack_masks_columns(k, r):
    """Word w bit t of mask j is bits[64w + t, j] — the layout the CUDA
    kernel reads; recomputing the product from the masks gives the
    plain version's bytes."""
    rng = np.random.default_rng(k * 7 + r)
    bits = rng.integers(0, 2, (8 * k, 8 * r), dtype=np.uint8)
    masks = tgp.pack_masks(bits).view(np.uint64)
    assert masks.shape == (8 * r, (k + 7) // 8)
    data = rng.integers(0, 256, (2, k, 5), dtype=np.uint8)
    vec = np.unpackbits(data.transpose(0, 2, 1), axis=-1,
                        bitorder="little")                    # (2, 5, 8k)
    pad = np.zeros((2, 5, masks.shape[1] * 64), dtype=np.uint8)
    pad[..., :8 * k] = vec
    words = np.packbits(pad, axis=-1, bitorder="little").view("<u8")
    par = np.zeros((2, 5, 8 * r), dtype=np.uint8)
    for j in range(8 * r):
        x = np.bitwise_xor.reduce(words & masks[j], axis=-1)
        par[..., j] = np.array([bin(int(v)).count("1") & 1
                                for v in x.ravel()]).reshape(x.shape)
    want = np.packbits(par, axis=-1, bitorder="little").transpose(0, 2, 1)
    got = tgp.gf_bit_matmul_plain(torch.from_numpy(data),
                                  torch.from_numpy(bits)).numpy()
    np.testing.assert_array_equal(got, want)


def _emulate_kernel(data: np.ndarray, tables: np.ndarray, r: int) -> np.ndarray:
    """The CUDA kernel's arithmetic in numpy: per group of four output
    rows, XOR over the data rows of L[x & 15] ^ H[x >> 4], one u32 per
    column whose byte q is output row 4g + q."""
    acc = np.zeros((tables.shape[0],) + data[:, 0].shape, dtype=np.uint32)
    for i in range(data.shape[1]):
        x = data[:, i]
        acc ^= tables[:, i, x & 15] ^ tables[:, i, 16 + (x >> 4)]
    by = acc.view(np.uint8).reshape(acc.shape + (4,))      # (g, S, C, 4)
    s, c = data.shape[0], data.shape[2]
    return by.transpose(1, 0, 3, 2).reshape(s, -1, c)[:, :r]


@pytest.mark.parametrize("k,r", [(1, 1), (2, 1), (8, 4), (9, 2), (21, 4),
                                 (40, 3), (8, 5), (256, 8)])
def test_pack_tables_layout(k, r):
    """Random 0/1 matrices (not only GF(2^8) expansions): entry [g, i, n]
    for a one-bit n is row 8i + log2(n) of the matrix on output columns
    32g.. (H: rows 8i + 4 + t), every entry is the XOR of its one-bit
    entries, and the kernel's lookups over the tables give the plain
    version's bytes and the JAX function's."""
    rng = np.random.default_rng(k * 31 + r)
    bits = rng.integers(0, 2, (8 * k, 8 * r), dtype=np.uint8)
    tab = tgp.pack_tables(bits)
    groups = (r + 3) // 4
    assert tab.shape == (groups, k, 32) and tab.dtype == np.uint32
    pad = np.zeros((8 * k, 32 * groups), dtype=np.uint64)
    pad[:, :8 * r] = bits
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
    rows = (pad.reshape(8 * k, groups, 32) * weights).sum(-1)  # (8k, g)
    for h in range(2):
        for t in range(4):
            np.testing.assert_array_equal(
                tab[:, :, 16 * h + (1 << t)],
                rows[8 * np.arange(k) + 4 * h + t].T)
    for n in range(16):
        want = np.zeros((groups, k, 2), dtype=np.uint32)
        for t in range(4):
            if n >> t & 1:
                want ^= tab[:, :, [1 << t, 16 + (1 << t)]]
        np.testing.assert_array_equal(tab[:, :, [n, 16 + n]], want)
    data = rng.integers(0, 256, (2, k, 37), dtype=np.uint8)
    got = _emulate_kernel(data, tab, r)
    np.testing.assert_array_equal(got, tgp.gf_bit_matmul_plain(
        torch.from_numpy(data), torch.from_numpy(bits)).numpy())
    np.testing.assert_array_equal(got, _jax(data, bits))


def test_pack_tables_matches_pallas():
    """At the Pallas parity shape, the kernel's lookups over the tables
    equal the Pallas kernel (interpreted on the CPU) and the port."""
    rng = np.random.default_rng(9)
    data = rng.integers(0, 256, (4, 8, 512), dtype=np.uint8)
    bits = jtab.expand_to_bitmatrix(jmat.gf_gen_rs_matrix(12, 8)[8:])
    got = _emulate_kernel(data, tgp.pack_tables(bits), 4)
    pallas = np.asarray(gf_bit_matmul_pallas(
        jnp.asarray(data), jnp.asarray(bits.astype(np.int8))))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, _port(data, bits))


def test_tables_built_once_per_bitmatrix(monkeypatch):
    """The tables are packed when a BitMatrix is made and ride with it:
    a decode signature costs one packing on its miss and none on its
    hits through the LRU; the first design's masks are not built."""
    calls = []
    real = tgp.pack_tables

    def counting(bits):
        calls.append(bits.shape)
        return real(bits)
    monkeypatch.setattr(tgp, "pack_tables", counting)
    be = tgm.DeviceRSBackend(tmat.gf_gen_rs_matrix(12, 8), "cpu")
    assert calls == [(64, 32)]
    srcs = (0, 2, 3, 4, 5, 6, 7, 8)
    first = be._decode_bits_for(srcs, (1,))
    assert calls == [(64, 32), (64, 8)]
    again = be._decode_bits_for(srcs, (1,))
    assert again is first and again.tables is first.tables
    assert len(calls) == 2
    np.testing.assert_array_equal(
        first.tables.numpy().view(np.uint32),
        real(first.bits.numpy()))
    assert "masks" not in vars(first)


@pytest.mark.parametrize("flag", [True, False])
def test_plain_leaves_tf32_flag(flag):
    """The plain version turns TF32 off for its product and gives the
    caller's setting back."""
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = flag
        with tgp._full_float32():
            assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is flag
        data = np.random.default_rng(2).integers(0, 256, (2, 4, 16),
                                                 dtype=np.uint8)
        bits = jtab.expand_to_bitmatrix(jmat.gf_gen_rs_matrix(6, 4)[4:])
        np.testing.assert_array_equal(_port(data, bits), _jax(data, bits))
        assert torch.backends.cuda.matmul.allow_tf32 is flag
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


@pytest.mark.parametrize("tech", sorted(GENS))
def test_backend_from_jax_matrix(tech):
    """The coding matrix of an initialised JAX-side plugin carries over:
    the port's backend built from it encodes as the JAX backend does,
    and equals the port's own generator's matrix."""
    from ceph_tpu.ec import create_erasure_code as jax_create
    jc = jax_create({"plugin": "tpu", "k": "8", "m": "4",
                     "technique": tech})
    mat = jc.codec.matrix
    np.testing.assert_array_equal(mat, GENS[tech][1](12, 8))
    be = tgm.backend_from_matrix(mat, "cpu")
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, (3, 8, 96), dtype=np.uint8)
    np.testing.assert_array_equal(be.encode(data),
                                  JaxBackend(mat).encode(data))


def test_backend_from_matrix_rejects():
    with pytest.raises(ValueError):
        tgm.backend_from_matrix(np.zeros((4, 4), np.uint8), "cpu")
    with pytest.raises(ValueError):
        tgm.backend_from_matrix(np.ones((6, 4), np.uint8), "cpu")


@pytest.mark.parametrize("tech", sorted(GENS))
def test_decode_bits_every_two_erasures(tech):
    """Decode bit-matrices and the decoded rows for every 2-erasure
    signature of k=4, m=2, against the JAX backend."""
    k, m = 4, 2
    mat = GENS[tech][0](k + m, k)
    port = tgm.DeviceRSBackend(mat, "cpu")
    ref = JaxBackend(mat)
    rng = np.random.default_rng(6)
    data = rng.integers(0, 256, (3, k, 64), dtype=np.uint8)
    full = np.concatenate([data, port.encode(data)], axis=1)
    for gone in itertools.combinations(range(k + m), 2):
        srcs = tuple(sorted(set(range(k + m)) - set(gone))[:k])
        want = tuple(i for i in gone if i < k) or (0,)
        np.testing.assert_array_equal(
            port._decode_bits_for(srcs, want).bits.numpy(),
            np.asarray(ref._decode_bits_for(srcs, want)).astype(np.uint8))
        got = port.decode_data(full[:, list(srcs)], srcs, want)
        np.testing.assert_array_equal(
            got, ref.decode_data(full[:, list(srcs)], srcs, want))
        np.testing.assert_array_equal(got, data[:, list(want)])


def test_decode_bits_lru_bound(monkeypatch):
    from ceph_tpu_torch.ops import gf_matmul
    monkeypatch.setattr(gf_matmul, "DECODE_CACHE_ENTRIES", 3)
    be = tgm.DeviceRSBackend(tmat.gf_gen_rs_matrix(6, 4), "cpu")
    sigs = [tuple(sorted(set(range(6)) - set(g)))[:4]
            for g in itertools.combinations(range(6), 2)]
    first = be._decode_bits_for(sigs[0], (0,))
    assert be._decode_bits_for(sigs[0], (0,)) is first      # a hit
    for s in sigs[1:5]:
        be._decode_bits_for(s, (0,))
    assert len(be._decode_bits_cache) == 3
    assert (sigs[0], (0,)) not in be._decode_bits_cache     # evicted
    assert list(be._decode_bits_cache)[-1] == (sigs[4], (0,))


def test_decode_cache_bound_matches_jax():
    from ceph_tpu.ec.rs_codec import DECODE_CACHE_ENTRIES as jax_bound
    from ceph_tpu_torch.ec.rs_codec import DECODE_CACHE_ENTRIES
    assert DECODE_CACHE_ENTRIES == jax_bound == 2516
