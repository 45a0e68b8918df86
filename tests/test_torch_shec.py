"""The port's shec plugin against the JAX package's, byte-exact.

Port side: ``ceph_tpu_torch`` plugin ``shec`` with ``backend=host`` (the
plain PyTorch bit-matmul on the CPU for encode and the batched recovery,
the host loops where the JAX package runs them).  Reference side:
``ceph_tpu``'s ``shec`` with ``backend=host``, and ``backend=tpu`` (XLA on
the CPU) for the device paths.  Tolerance 0.
"""
import itertools

import numpy as np
import pytest

from ceph_tpu.ec import create_erasure_code as jax_create
from ceph_tpu.osd import ecutil as jax_ecutil

from ceph_tpu_torch.ec import create_erasure_code as port_create
from ceph_tpu_torch.osd import ecutil as port_ecutil

SHAPES = [(4, 3, 2, "multiple"), (6, 4, 3, "multiple"), (5, 2, 1, "single"),
          (4, 2, 2, "single")]


def _prof(k, m, c, tech, backend):
    return {"plugin": "shec", "k": str(k), "m": str(m), "c": str(c),
            "technique": tech, "backend": backend}


def _pair(k, m, c, tech, ref_backend="host"):
    return (port_create(_prof(k, m, c, tech, "host")),
            jax_create(_prof(k, m, c, tech, ref_backend)))


def _recoverable(ref, n, e):
    """Erasure patterns of size e the code recovers (its own search)."""
    for gone in itertools.combinations(range(n), e):
        try:
            ref._minimum_to_decode(set(gone), set(range(n)) - set(gone))
        except IOError:
            continue
        yield gone


@pytest.mark.parametrize("k,m,c,tech", SHAPES)
def test_matrix_profile_sizing(k, m, c, tech):
    port, ref = _pair(k, m, c, tech)
    np.testing.assert_array_equal(port.matrix, ref.matrix)
    assert port.get_profile() == ref.get_profile()
    assert port.get_alignment() == ref.get_alignment()
    for size in (1, 999, 4096, 65536):
        assert port.get_chunk_size(size) == ref.get_chunk_size(size)


@pytest.mark.parametrize("k,m,c,tech", SHAPES)
def test_encode_decode_every_recoverable_pattern(k, m, c, tech):
    """encode, then decode of every pattern of up to c erasures (all
    recoverable by construction) and of the larger ones the search
    accepts, against the JAX plugin and the original chunks."""
    port, ref = _pair(k, m, c, tech)
    n = k + m
    payload = np.random.default_rng(n).integers(
        0, 256, 3 * port.get_alignment() - 7, dtype=np.uint8).tobytes()
    enc = port.encode(set(range(n)), payload)
    ref_enc = ref.encode(set(range(n)), payload)
    for i in range(n):
        np.testing.assert_array_equal(enc[i], ref_enc[i])
    for e in range(1, m + 1):
        for gone in _recoverable(ref, n, e):
            chunks = {i: enc[i] for i in range(n) if i not in gone}
            got = port.decode(set(gone), chunks)
            want = ref.decode(set(gone), chunks)
            for i in gone:
                np.testing.assert_array_equal(got[i], enc[i])
                np.testing.assert_array_equal(got[i], want[i])


@pytest.mark.parametrize("k,m,c,tech", SHAPES)
def test_batch_every_recoverable_pattern(k, m, c, tech):
    """encode_batch and decode_batch (the recovery product through the
    bit-matmul wrapper) against the JAX device path and host path."""
    port, ref = _pair(k, m, c, tech, "tpu")
    host = jax_create(_prof(k, m, c, tech, "host"))
    n = k + m
    data = np.random.default_rng(k * m).integers(0, 256, (3, k, 64),
                                                 dtype=np.uint8)
    coding = port.encode_batch(data)
    np.testing.assert_array_equal(coding, ref.encode_batch(data))
    np.testing.assert_array_equal(coding, host.encode_batch(data))
    full = {i: (data[:, i] if i < k else coding[:, i - k]) for i in range(n)}
    for e in range(1, c + 1):
        for gone in _recoverable(host, n, e):
            chunks = {i: full[i] for i in range(n) if i not in gone}
            got = port.decode_batch(chunks, list(gone))
            want = ref.decode_batch(chunks, list(gone))
            for i in gone:
                np.testing.assert_array_equal(got[i], full[i])
                np.testing.assert_array_equal(got[i], want[i])


@pytest.mark.parametrize("k,m,c,tech", SHAPES[:2])
def test_minimum_to_decode_matches_jax(k, m, c, tech):
    port, ref = _pair(k, m, c, tech)
    n = k + m
    for want_n in (1, 2):
        for want in itertools.combinations(range(n), want_n):
            for gone_n in range(0, c + 1):
                for gone in itertools.combinations(range(n), gone_n):
                    avail = set(range(n)) - set(gone)
                    try:
                        want_ref = ref.minimum_to_decode(set(want), avail)
                    except IOError:
                        with pytest.raises(IOError):
                            port.minimum_to_decode(set(want), avail)
                        continue
                    assert port.minimum_to_decode(set(want), avail) == \
                        want_ref
    with pytest.raises(ValueError):
        port.minimum_to_decode({n}, set(range(n)))


def test_ecutil_whole_objects():
    port, ref = _pair(4, 3, 2, "multiple")
    chunk = port.get_chunk_size(4 * 4096)
    sp = port_ecutil.stripe_info_t(4, 4 * chunk)
    sj = jax_ecutil.stripe_info_t(4, 4 * chunk)
    obj = np.random.default_rng(2).integers(0, 256, 3 * 4 * chunk,
                                            dtype=np.uint8)
    sh = port_ecutil.encode(sp, port, obj, set(range(7)))
    ref_sh = jax_ecutil.encode(sj, ref, obj, set(range(7)))
    for i in range(7):
        np.testing.assert_array_equal(sh[i], ref_sh[i])
    surv = {i: sh[i] for i in range(7) if i not in (1, 5)}
    np.testing.assert_array_equal(
        port_ecutil.decode_concat(sp, port, surv), obj)
    got = port_ecutil.decode(sp, port, surv, [1, 5])
    for i in (1, 5):
        np.testing.assert_array_equal(got[i], sh[i])


@pytest.mark.parametrize("bad", [
    {"k": "4", "m": "3"}, {"k": "4", "m": "3", "c": "4"},
    {"k": "13", "m": "3", "c": "2"}, {"k": "12", "m": "9", "c": "2"},
    {"k": "3", "m": "4", "c": "2"}, {"k": "0", "m": "1", "c": "1"},
    {"technique": "double"}, {"w": "16"}, {"backend": "tpu"},
])
def test_bad_profiles_raise(bad):
    prof = {"plugin": "shec", "backend": "host", **bad}
    with pytest.raises(ValueError):
        port_create(prof)
    if bad.get("backend") != "tpu":
        with pytest.raises(ValueError):
            jax_create(prof)


def test_defaults_match_jax():
    port = port_create({"plugin": "shec", "backend": "host"})
    ref = jax_create({"plugin": "shec", "backend": "host"})
    assert (port.k, port.m, port.c, port.w) == (ref.k, ref.m, ref.c, ref.w)
    assert port.get_profile() == ref.get_profile()
