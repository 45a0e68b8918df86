"""The port's jerasure plugin against the JAX package's, byte-exact.

Port side: ``ceph_tpu_torch`` plugin ``jerasure`` with ``backend=host``
(the plain PyTorch versions of K1 and K3 on the CPU for encode; the host
codecs for the decodes the JAX package runs there).  Reference side:
``ceph_tpu``'s ``jerasure`` with ``backend=host`` and, where its own tests
use it, ``backend=tpu`` (its XLA device path, on the CPU here).  Every
technique at every w it takes; tolerance 0, chunks are bytes.
"""
import itertools

import numpy as np
import pytest

from ceph_tpu.ec import create_erasure_code as jax_create
from ceph_tpu.osd import ecutil as jax_ecutil

from ceph_tpu_torch.ec import create_erasure_code as port_create
from ceph_tpu_torch.osd import ecutil as port_ecutil

# (technique, k, m, w, packetsize) — every technique x w, small k
PROFILES = {
    "van_w8": ("reed_sol_van", 4, 2, 8, None),
    "van_w16": ("reed_sol_van", 4, 2, 16, None),
    "van_w32": ("reed_sol_van", 3, 3, 32, None),
    "r6_w8": ("reed_sol_r6_op", 4, 2, 8, None),
    "r6_w16": ("reed_sol_r6_op", 3, 2, 16, None),
    "r6_w32": ("reed_sol_r6_op", 4, 2, 32, None),
    "cauchy_orig": ("cauchy_orig", 3, 2, 8, 8),
    "cauchy_good": ("cauchy_good", 4, 2, 8, 8),
    "cauchy_good_w4": ("cauchy_good", 3, 2, 4, 4),
    "liberation": ("liberation", 3, 2, 5, 4),
    "blaum_roth": ("blaum_roth", 3, 2, 4, 4),
    "liber8tion": ("liber8tion", 3, 2, 8, 4),
}


def _prof(name, **extra):
    tech, k, m, w, ps = PROFILES[name]
    p = {"plugin": "jerasure", "technique": tech, "k": str(k), "m": str(m),
         "w": str(w)}
    if ps:
        p["packetsize"] = str(ps)
    p.update(extra)
    return p


def _pair(name, **extra):
    return (port_create(_prof(name, backend="host", **extra)),
            jax_create(_prof(name, backend="host", **extra)))


def _payload(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


def _patterns(n, m):
    for e in range(1, m + 1):
        yield from itertools.combinations(range(n), e)


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_init_profile_and_sizing_match_jax(name):
    """Parameters, profile, matrix, alignment and chunk sizes, with and
    without jerasure-per-chunk-alignment."""
    for extra in ({}, {"jerasure-per-chunk-alignment": "true"}):
        port, ref = _pair(name, **extra)
        assert (port.k, port.m, port.w, port.packetsize) == \
            (ref.k, ref.m, ref.w, ref.packetsize)
        assert port.get_profile() == ref.get_profile()
        assert port.get_alignment() == ref.get_alignment()
        np.testing.assert_array_equal(port.codec.matrix, ref.codec.matrix)
        for size in (1, 1000, 4096, 12345, 65536):
            assert port.get_chunk_size(size) == ref.get_chunk_size(size)
        assert port.mesh_row_shardable == ref.mesh_row_shardable
        assert port._device_decode_supported == \
            ref._device_decode_supported
        assert port._stripe_block() == ref._stripe_block()


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_encode_decode_every_pattern(name):
    """encode, then decode and decode_concat of every erasure pattern the
    code tolerates, against the JAX plugin and the payload."""
    port, ref = _pair(name)
    n, k = port.get_chunk_count(), port.get_data_chunk_count()
    payload = _payload(3 * port.get_alignment() - 5, n)
    enc = port.encode(set(range(n)), payload)
    ref_enc = ref.encode(set(range(n)), payload)
    for i in range(n):
        np.testing.assert_array_equal(enc[i], ref_enc[i])
    for gone in _patterns(n, n - k):
        chunks = {i: enc[i] for i in range(n) if i not in gone}
        got = port.decode(set(gone), chunks)
        want = ref.decode(set(gone), chunks)
        for i in gone:
            np.testing.assert_array_equal(got[i], enc[i])
            np.testing.assert_array_equal(got[i], want[i])
        assert port.decode_concat(chunks)[:len(payload)] == payload


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_batch_every_pattern(name):
    """encode_batch, then decode_batch of every tolerated pattern (the
    word and bitmatrix codes decode on the host codec, as the JAX package
    does)."""
    port, ref = _pair(name)
    n, k = port.get_chunk_count(), port.get_data_chunk_count()
    c = 2 * port.get_chunk_size(k * port.get_alignment())
    data = np.random.default_rng(n * 7).integers(0, 256, (3, k, c),
                                                 dtype=np.uint8)
    coding = port.encode_batch(data)
    np.testing.assert_array_equal(coding, ref.encode_batch(data))
    full = {i: (data[:, i] if i < k else coding[:, i - k]) for i in range(n)}
    for gone in _patterns(n, n - k):
        chunks = {i: full[i] for i in range(n) if i not in gone}
        got = port.decode_batch(chunks, list(gone))
        want = ref.decode_batch(chunks, list(gone))
        assert sorted(got) == sorted(gone)
        for i in gone:
            np.testing.assert_array_equal(got[i], full[i])
            np.testing.assert_array_equal(got[i], want[i])


@pytest.mark.parametrize("name", ["van_w16", "van_w32", "cauchy_good",
                                  "liber8tion"])
def test_encode_matches_jax_device_path(name):
    """Against the JAX plugin's device path (``backend=tpu``: XLA on the
    CPU), as the JAX package's own device-parity tests use it."""
    port = port_create(_prof(name, backend="host"))
    ref = jax_create(_prof(name, backend="tpu"))
    n, k = port.get_chunk_count(), port.get_data_chunk_count()
    payload = _payload(5000, 5)
    enc = port.encode(set(range(n)), payload)
    ref_enc = ref.encode(set(range(n)), payload)
    for i in range(n):
        np.testing.assert_array_equal(enc[i], ref_enc[i])
    c = port.get_chunk_size(k * port.get_alignment())
    data = np.random.default_rng(6).integers(0, 256, (2, k, c),
                                             dtype=np.uint8)
    np.testing.assert_array_equal(port.encode_batch(data),
                                  ref.encode_batch(data))


@pytest.mark.parametrize("name", ["van_w8", "van_w32", "cauchy_good"])
def test_ecutil_whole_objects(name):
    port, ref = _pair(name)
    n, k = port.get_chunk_count(), port.get_data_chunk_count()
    chunk = port.get_chunk_size(k * port.get_alignment())
    sp = port_ecutil.stripe_info_t(k, k * chunk)
    sj = jax_ecutil.stripe_info_t(k, k * chunk)
    obj = np.random.default_rng(n).integers(0, 256, 3 * k * chunk,
                                            dtype=np.uint8)
    sh = port_ecutil.encode(sp, port, obj, set(range(n)))
    ref_sh = jax_ecutil.encode(sj, ref, obj, set(range(n)))
    for i in range(n):
        np.testing.assert_array_equal(sh[i], ref_sh[i])
    surv = {i: sh[i] for i in range(n) if i not in (1, k)}
    np.testing.assert_array_equal(
        port_ecutil.decode_concat(sp, port, surv), obj)
    got = port_ecutil.decode(sp, port, surv, [1, k])
    for i in (1, k):
        np.testing.assert_array_equal(got[i], sh[i])


@pytest.mark.parametrize("name", ["van_w8", "van_w16", "liberation"])
def test_minimum_to_decode_matches_jax(name):
    port, ref = _pair(name)
    n, k = port.get_chunk_count(), port.get_data_chunk_count()
    rng = np.random.default_rng(11)
    for _ in range(30):
        avail = set(rng.choice(n, int(rng.integers(k, n + 1)),
                               replace=False).tolist())
        want = set(rng.choice(n, int(rng.integers(1, n + 1)),
                              replace=False).tolist())
        assert port.minimum_to_decode(want, avail) == \
            ref.minimum_to_decode(want, avail)


def test_stripe_block_is_checked():
    """A stripe chunk that is not a whole number of code blocks is
    refused, not flattened across stripes (cauchy_good at packetsize
    2048 needs 65536-byte chunks at k=4; the JAX package agrees)."""
    port = port_create({"plugin": "jerasure", "technique": "cauchy_good",
                        "k": "4", "m": "2", "backend": "host"})
    ref = jax_create({"plugin": "jerasure", "technique": "cauchy_good",
                      "k": "4", "m": "2", "backend": "host"})
    assert port.packetsize == 2048
    assert port.get_chunk_size(4 * 4096) == ref.get_chunk_size(4 * 4096) \
        == 65536
    with pytest.raises(ValueError):
        port.encode_batch(np.zeros((2, 4, 8192), np.uint8))
    with pytest.raises(ValueError):
        ref.encode_batch(np.zeros((2, 4, 8192), np.uint8))
    w16 = port_create(_prof("van_w16", backend="host"))
    with pytest.raises(ValueError):
        w16.encode_batch(np.zeros((2, 4, 33), np.uint8))


@pytest.mark.parametrize("bad", [
    {"technique": "nope"},
    {"technique": "reed_sol_van", "w": "9"},
    {"technique": "reed_sol_r6_op", "w": "12"},
    {"technique": "cauchy_good", "packetsize": "6"},
    {"technique": "cauchy_good", "packetsize": "0"},
    {"technique": "liberation", "k": "5", "w": "4"},
    {"technique": "blaum_roth", "k": "4", "w": "5"},
    {"technique": "liber8tion", "k": "9"},
    {"technique": "reed_sol_van", "k": "1"},
    {"technique": "reed_sol_van", "k": "x"},
    {"backend": "tpu"},
])
def test_bad_profiles_raise(bad):
    prof = {"plugin": "jerasure", "backend": "host", **bad}
    with pytest.raises(ValueError):
        port_create(prof)
    if bad.get("backend") != "tpu":
        with pytest.raises(ValueError):
            jax_create(prof)


@pytest.mark.parametrize("tech", ["reed_sol_van", "liberation", "liber8tion",
                                  "blaum_roth"])
def test_technique_defaults_match_jax(tech):
    port = port_create({"plugin": "jerasure", "technique": tech,
                        "backend": "host"})
    ref = jax_create({"plugin": "jerasure", "technique": tech,
                      "backend": "host"})
    assert (port.k, port.m, port.w, port.packetsize) == \
        (ref.k, ref.m, ref.w, ref.packetsize)
    assert port.get_profile() == ref.get_profile()


def test_default_plugin_is_jerasure():
    """With no ``plugin`` the port builds jerasure, as the JAX package
    does, and its chunks equal the JAX default's; the default backend
    stays ``cuda``."""
    port = port_create({"k": "4", "m": "2", "backend": "host"})
    ref = jax_create({"k": "4", "m": "2"})
    assert type(port).__name__ == type(ref).__name__ == "ErasureCodeJerasure"
    payload = _payload(10000, 1)
    enc = port.encode(set(range(6)), payload)
    ref_enc = ref.encode(set(range(6)), payload)
    for i in range(6):
        np.testing.assert_array_equal(enc[i], ref_enc[i])
    assert port_create({"backend": "host"}).get_profile() == \
        jax_create({"backend": "host"}).get_profile()
