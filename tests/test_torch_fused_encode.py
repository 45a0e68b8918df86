"""The one-pass fused resident encode (K5): a numpy emulation of the
kernel's scheme against the JAX package's fused encode and the port's plain
version, byte-exact, and the route between the one-pass kernel and the
two-launch form.

Port side: ``ceph_tpu_torch.ops.fused_encode_crc`` (the scheme's tables,
the plain version, the route predicate ``one_pass``) and
``ceph_tpu_torch.ops.resident`` on CPU tensors.  Reference side:
``ceph_tpu.ops.resident._fused_encode_crc`` (its XLA function on the CPU).
Inputs are seeded numpy bytes; the tolerance is exact: bodies and CRCs are
integers.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ceph_tpu.gf import matrices as jmat
from ceph_tpu.gf import tables as jtab
from ceph_tpu.ops.crc32c_device import _tables as jax_crc_tables
from ceph_tpu.ops.resident import _fused_encode_crc as jax_fused
from ceph_tpu.utils.crc32c import crc32c as jax_host_crc

from ceph_tpu_torch.ops import crc32c_device as port_crc
from ceph_tpu_torch.ops import fused_encode_crc as fec
from ceph_tpu_torch.ops import resident
from ceph_tpu_torch.ops.gf_pallas import BitMatrix, pack_tables

GENS = {"reed_sol_van": jmat.gf_gen_rs_matrix,
        "cauchy": jmat.gf_gen_cauchy1_matrix}
KMS = [(3, 2), (8, 4), (10, 4), (8, 5)]


def _bits(tech: str, k: int, m: int) -> np.ndarray:
    return jtab.expand_to_bitmatrix(GENS[tech](k + m, k)[k:])


def _stripes(s: int, k: int, c: int) -> np.ndarray:
    return np.random.default_rng(s * 1000 + k * 10 + c).integers(
        0, 256, (s, k, c), dtype=np.uint8)


def _fused_scheme(stripes: np.ndarray, bits: np.ndarray, ws: int = 0):
    """numpy emulation of csrc/fused_encode_crc.cu, index arithmetic and
    table layouts included, vectorised over the 32 lanes of a warp.

    The flattened (stripe, column) space of L = S*C bytes is cut into runs
    of ``ws`` bytes (``run_bytes(L)`` unless given), one per warp, as
    if preceded by zeros up to whole runs; a warp skips those zero
    iterations.  In each iteration of ITER bytes lane l takes the 16-byte
    chunk u at 512 u + 16 l of its stripe; per chunk and group of four
    parity rows it loads the k data rows (storing and hashing them in the
    first group), forms the group's four parity chunks by the nibble tables
    of ``pack_tables`` and stores and hashes them.  A body's accumulator
    per lane follows acc <- M_ITER acc ^ sum_u M_{512 (3-u)} crc(0,
    chunk_u), all by nibble lookups; a run's crc is sum_l M_{16 (31-l)}
    acc_l, advanced over the runs after it; the seed term M_L 0xFFFFFFFF
    enters on the first run."""
    s, k, c = stripes.shape
    r = bits.shape[1] // 8
    n, length, it = k + r, s * c, port_crc.ITER
    ptab = pack_tables(bits)                       # (groups, k, 32)
    tabs = port_crc.coalesced_tables_np()
    ntab = port_crc.CHUNKS * 32 + 8
    nib = tabs[:ntab * 16].reshape(ntab, 16)
    lanem = tabs[ntab * 16:ntab * 16 + 1024].reshape(32, 32)
    ws = ws or fec.run_bytes(length)
    adv = port_crc.advance_cols_np(ws)
    runs = -(-length // ws)
    flat = stripes.reshape(-1)
    bodies = np.zeros((n, length), dtype=np.uint8)
    crcs = np.zeros(n, dtype=np.uint32)
    lane16 = 16 * np.arange(32)
    cols16 = np.arange(16)

    def emit(acc, body, du, v, u):
        bodies[body][du[:, None] + cols16] = v
        lo = nib[u * 32 + 2 * cols16][cols16, v & 15]
        hi = nib[u * 32 + 2 * cols16 + 1][cols16, v >> 4]
        t = np.bitwise_xor.reduce(lo ^ hi, axis=1)
        if u == 0:                                 # the register's M_ITER
            a = acc[body]
            for q in range(8):
                t ^= nib[port_crc.CHUNKS * 32 + q][(a >> np.uint32(4 * q)) & 15]
            acc[body] = t
        else:
            acc[body] ^= t

    for w in range(runs):
        o = w * ws - (runs * ws - length)
        iters = ws // it
        if o < 0:                                  # zeros in front: skipped
            iters += o // it
            o = 0
        col = o % c
        src = (o // c) * k * c + col + lane16
        d = o + lane16
        acc = np.zeros((n, 32), dtype=np.uint32)
        for _ in range(iters):
            for u in range(port_crc.CHUNKS):
                p, du = src + 512 * u, d + 512 * u
                for g in range(ptab.shape[0]):
                    par = np.zeros((32, 16), dtype=np.uint32)
                    for i in range(k):
                        v = flat[(p + i * c)[:, None] + cols16]
                        if g == 0:
                            emit(acc, i, du, v, u)
                        par ^= ptab[g, i][v & 15] ^ ptab[g, i][16 + (v >> 4)]
                    for q in range(4):              # byte q: parity row 4g + q
                        if 4 * g + q < r:
                            row = ((par >> np.uint32(8 * q)) & 255).astype(
                                np.uint8)
                            emit(acc, k + 4 * g + q, du, row, u)
            src += it
            d += it
            col += it
            if col == c:                           # on to the next stripe
                col = 0
                src += (k - 1) * c
        for b in range(n):
            x = np.bitwise_xor.reduce(port_crc._apply_np(lanem, acc[b]))
            after, e = runs - 1 - w, 0
            while after:
                if after & 1:
                    x = port_crc._apply_np(adv[e], np.array(x, np.uint32))
                after, e = after >> 1, e + 1
            if w == 0:
                x ^= np.uint32(fec.seed_term(length))
            crcs[b] ^= np.uint32(x)
    return bodies, crcs


def _jax_ref(stripes: np.ndarray, bits: np.ndarray):
    bodies, crcs = jax_fused(jnp.asarray(stripes),
                             jnp.asarray(bits.astype(np.int8)),
                             jax_crc_tables())
    return np.asarray(bodies), np.asarray(crcs).astype(np.uint32)


@pytest.mark.parametrize("tech", sorted(GENS))
@pytest.mark.parametrize("k,m", KMS)
@pytest.mark.parametrize("c", [2048, 4096, 6144])
@pytest.mark.parametrize("s", [1, 3, 16])
def test_scheme_matches_jax_and_plain(s, c, k, m, tech):
    """The kernel's scheme = the JAX fused encode = the port's plain
    version (bodies and CRCs), at the shapes the one-pass kernel takes."""
    stripes = _stripes(s, k, c)
    bits = _bits(tech, k, m)
    got_b, got_c = _fused_scheme(stripes, bits)
    want_b, want_c = _jax_ref(stripes, bits)
    np.testing.assert_array_equal(got_b, want_b)
    np.testing.assert_array_equal(got_c, want_c)
    plain_b, plain_c = fec.fused_encode_crc_plain(
        torch.from_numpy(stripes), BitMatrix(bits, "cpu"))
    np.testing.assert_array_equal(plain_b.numpy(), want_b)
    np.testing.assert_array_equal(port_crc.to_u32(plain_c), want_c)


@pytest.mark.parametrize("s,c,ws", [(3, 2048, 4096), (3, 6144, 8192),
                                    (5, 2048, 8192), (16, 4096, 16384)])
def test_scheme_runs_across_stripes(s, c, ws):
    """Runs longer than a stripe's chunk, zeros in front of the first,
    stripe boundaries inside a run: the crcs are the bodies' host crcs."""
    k, m = 8, 4
    stripes = _stripes(s, k, c)
    bits = _bits("reed_sol_van", k, m)
    got_b, got_c = _fused_scheme(stripes, bits, ws)
    want_b, want_c = _jax_ref(stripes, bits)
    np.testing.assert_array_equal(got_b, want_b)
    np.testing.assert_array_equal(got_c, want_c)
    assert int(got_c[0]) == jax_host_crc(stripes[:, 0].reshape(-1))


@pytest.mark.parametrize("length", [0, 1, 2048, 6144 * 3, 65537])
def test_seed_term_is_the_crc_of_zeros(length):
    """M_L 0xFFFFFFFF is crc32c(0xFFFFFFFF, L zero bytes)."""
    assert fec.seed_term(length) == jax_host_crc(np.zeros(length, np.uint8))


def test_run_sizes_at_the_main_shapes():
    """Runs of 8 iterations at S=8192 (2048 warps, one wave), one
    iteration per run at S=128 (256 warps); never beyond MAX_RUN_ITERS."""
    it = port_crc.ITER
    assert fec.run_bytes(8192 * 4096) == 8 * it
    assert 8192 * 4096 // fec.run_bytes(8192 * 4096) <= fec.RESIDENT_WARPS
    assert fec.run_bytes(128 * 4096) == it
    assert fec.run_bytes(2048) == it
    assert fec.run_bytes(1 << 40) == port_crc.MAX_RUN_ITERS * it


@pytest.mark.parametrize("s,k,r,c,addrs,want", [
    (8192, 8, 4, 4096, [0, 16, 4096], True),
    (128, 8, 4, 4096, [512] * 13, True),
    (1, 3, 2, 2048, [0] * 6, True),
    (3, 10, 4, 6144, [256] * 15, True),
    (3, 8, 5, 2048, [0] * 14, True),
    (3, 8, 4, 4099, [0] * 13, False),         # C not a multiple of 2048
    (3, 8, 4, 1024, [0] * 13, False),
    (3, 8, 4, 0, [0] * 13, False),
    (0, 8, 4, 4096, [0] * 13, False),         # no stripes
    (3, 8, 4, 4096, [1] + [0] * 12, False),   # stripes off alignment
    (3, 8, 4, 4096, [0] * 12 + [8], False),   # a body off alignment
    (3, 100, 29, 2048, [0] * 130, False),     # more than 128 bodies
    (3, 64, 64, 2048, [0] * 129, False),      # tables beyond shared memory
])
def test_route_predicate(s, k, r, c, addrs, want):
    assert fec.one_pass(s, k, r, c, addrs) is want


def test_shared_memory_of_the_main_shape():
    """k=8 r=4: 1 KiB of product tables, 12.6 KiB of crc tables and
    12 KiB of accumulators."""
    assert fec.smem_bytes(8, 4) == 4 * (8 * 32 + 136 * 16 + 32 * 33 + 12 * 256)
    assert fec.smem_bytes(64, 64) > fec.SMEM_MAX


def _spy_routes(monkeypatch):
    taken = []
    one, two = resident.fused_encode_crc_kernel, \
        resident._fused_encode_crc_two_pass

    def one_spy(*a, **kw):
        taken.append("one_pass")
        return one(*a, **kw)

    def two_spy(*a, **kw):
        taken.append("two_pass")
        return two(*a, **kw)
    monkeypatch.setattr(resident, "fused_encode_crc_kernel", one_spy)
    monkeypatch.setattr(resident, "_fused_encode_crc_two_pass", two_spy)
    return taken


@pytest.mark.parametrize("c,offset,route", [
    (2048, 0, "one_pass"), (4096, 0, "one_pass"), (4099, 0, "two_pass"),
    (100, 0, "two_pass"), (2048, 1, "two_pass"), (2048, 16, "one_pass")])
def test_resident_route_by_shape_and_address(monkeypatch, c, offset, route):
    """``_fused_encode_crc`` takes the one-pass route exactly where
    ``one_pass`` holds (here on CPU tensors, through the plain versions),
    and both routes give the JAX bytes and CRCs."""
    k, m, s = 4, 2, 3
    taken = _spy_routes(monkeypatch)
    stripes = _stripes(s, k, c)
    buf = torch.zeros(offset + stripes.size, dtype=torch.uint8)
    data = buf[offset:].view(s, k, c)
    data.copy_(torch.from_numpy(stripes))
    assert buf.data_ptr() % 16 == 0 and data.data_ptr() % 16 == offset % 16
    bits = _bits("cauchy", k, m)
    bodies, crcs = resident._fused_encode_crc(data, BitMatrix(bits, "cpu"))
    assert taken == [route]
    want_b, want_c = _jax_ref(stripes, bits)
    np.testing.assert_array_equal(torch.stack(bodies).numpy(), want_b)
    np.testing.assert_array_equal(port_crc.to_u32(crcs), want_c)
    assert len({b.untyped_storage().data_ptr() for b in bodies}) == k + m


def test_kernel_wrapper_validates():
    bm = BitMatrix(_bits("reed_sol_van", 4, 2), "cpu")
    data = torch.zeros((2, 4, 2048), dtype=torch.uint8)
    bodies = [torch.empty(2 * 2048, dtype=torch.uint8) for _ in range(6)]
    crcs = fec.fused_encode_crc_kernel(data, bm, bodies)
    assert [int(x) for x in port_crc.to_u32(crcs)] == \
        [jax_host_crc(np.zeros(4096, np.uint8))] * 6
    with pytest.raises(ValueError):
        fec.fused_encode_crc_kernel(data, bm, bodies[:5])
    with pytest.raises(ValueError):
        fec.fused_encode_crc_kernel(data[:, :3], bm, bodies)
    with pytest.raises(ValueError):
        fec.fused_encode_crc_kernel(
            data, bm, bodies[:5] + [torch.empty(7, dtype=torch.uint8)])
