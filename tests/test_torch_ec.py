"""The port's EC plugins and ECUtil against the JAX package's, byte-exact.

Port side: ``ceph_tpu_torch`` plugins ``cuda`` and ``isa`` with
``backend=host`` (the plain PyTorch bit-matmul on the CPU, plus the host
MatrixRSCodec where the JAX package uses it).  Reference side:
``ceph_tpu``'s ``tpu`` plugin (its XLA device path, on the CPU here) and
``isa`` with ``backend=host``.  Tolerance 0: chunks are bytes.
"""
import hashlib
import itertools
import json
import os

import numpy as np
import pytest

from ceph_tpu.ec import create_erasure_code as jax_create
from ceph_tpu.osd import ecutil as jax_ecutil

from ceph_tpu_torch.ec import create_erasure_code as port_create
from ceph_tpu_torch.osd import ecutil as port_ecutil

SHAPES = [(4, 2), (8, 4)]
TECHS = ["reed_sol_van", "cauchy"]
CORPUS = os.path.join(os.path.dirname(__file__), "corpus", "ec_chunks.json")


def _prof(k, m, tech, **extra):
    return {"k": str(k), "m": str(m), "technique": tech, **extra}


def _port(plugin, k, m, tech, **extra):
    return port_create({"plugin": plugin, "backend": "host",
                        **_prof(k, m, tech, **extra)})


def _jax(plugin, k, m, tech, **extra):
    p = {"plugin": plugin, **_prof(k, m, tech, **extra)}
    if plugin == "isa":
        p["backend"] = "host"
    return jax_create(p)


def _erasures(n, m):
    for e in range(1, m + 1):
        yield from itertools.combinations(range(n), e)


@pytest.mark.parametrize("tech", TECHS)
@pytest.mark.parametrize("k,m", SHAPES)
@pytest.mark.parametrize("size", [1, 1000, 4096, 12345])
def test_encode_matches_jax(k, m, tech, size):
    """Single-object encode, odd sizes included (zero padding of the
    tail chunks), for both port plugins against both JAX plugins."""
    payload = np.random.default_rng(size).integers(
        0, 256, size, dtype=np.uint8).tobytes()
    want = set(range(k + m))
    ref = _jax("tpu", k, m, tech).encode(want, payload)
    ref_isa = _jax("isa", k, m, tech).encode(want, payload)
    for plugin in ("cuda", "isa"):
        codec = _port(plugin, k, m, tech)
        assert codec.get_chunk_size(size) == len(ref[0])
        got = codec.encode(want, payload)
        assert sorted(got) == sorted(ref)
        for i in want:
            np.testing.assert_array_equal(got[i], ref[i])
            np.testing.assert_array_equal(got[i], ref_isa[i])


@pytest.mark.parametrize("tech", TECHS)
@pytest.mark.parametrize("k,m", SHAPES)
def test_decode_every_erasure_pattern(k, m, tech):
    """decode and decode_concat for every pattern of <= m erasures."""
    n = k + m
    payload = np.random.default_rng(k).integers(
        0, 256, 64 * k - 7, dtype=np.uint8).tobytes()
    port = _port("cuda", k, m, tech)
    ref = _jax("tpu", k, m, tech)
    enc = port.encode(set(range(n)), payload)
    for gone in _erasures(n, m):
        chunks = {i: enc[i] for i in range(n) if i not in gone}
        got = port.decode(set(gone), chunks)
        want = ref.decode(set(gone), chunks)
        for i in gone:
            np.testing.assert_array_equal(got[i], enc[i])
            np.testing.assert_array_equal(got[i], want[i])
        cat = port.decode_concat(chunks)
        assert cat == ref.decode_concat(chunks)
        assert cat[:len(payload)] == payload


@pytest.mark.parametrize("k,m", SHAPES)
def test_minimum_to_decode_matches_jax(k, m):
    n = k + m
    port = _port("cuda", k, m, "reed_sol_van")
    ref = _jax("tpu", k, m, "reed_sol_van")
    rng = np.random.default_rng(11)
    for _ in range(40):
        avail = set(rng.choice(n, int(rng.integers(k, n + 1)),
                               replace=False).tolist())
        want = set(rng.choice(n, int(rng.integers(1, n + 1)),
                              replace=False).tolist())
        assert port.minimum_to_decode(want, avail) == \
            ref.minimum_to_decode(want, avail)
        assert port.minimum_to_decode_with_cost(
            want, {i: 1 for i in avail}) == \
            ref.minimum_to_decode_with_cost(want, {i: 1 for i in avail})
    with pytest.raises(IOError):
        port.minimum_to_decode({0}, set(range(1, k)))


@pytest.mark.parametrize("tech", TECHS)
@pytest.mark.parametrize("k,m", SHAPES)
def test_batch_every_erasure_pattern(k, m, tech):
    """encode_batch, then decode_batch of every <= m erasure pattern
    (data and coding shards lost), against the JAX tpu plugin."""
    n = k + m
    port = _port("cuda", k, m, tech)
    ref = _jax("tpu", k, m, tech)
    data = np.random.default_rng(k + m).integers(
        0, 256, (3, k, 64), dtype=np.uint8)
    coding = port.encode_batch(data)
    np.testing.assert_array_equal(coding, ref.encode_batch(data))
    full = {i: (data[:, i] if i < k else coding[:, i - k]) for i in range(n)}
    for gone in _erasures(n, m):
        chunks = {i: full[i] for i in range(n) if i not in gone}
        got = port.decode_batch(chunks, list(gone))
        want = ref.decode_batch(chunks, list(gone))
        assert sorted(got) == sorted(gone)
        for i in gone:
            np.testing.assert_array_equal(got[i], full[i])
            np.testing.assert_array_equal(got[i], want[i])


def test_decode_batch_needs_k_chunks():
    port = _port("cuda", 4, 2, "reed_sol_van")
    data = np.zeros((1, 4, 32), dtype=np.uint8)
    with pytest.raises(IOError):
        port.decode_batch({i: data[:, i] for i in range(3)}, [3])


@pytest.mark.parametrize("mapping", ["DD__DD", "_DDD_D"])
def test_mapping_profile_matches_jax(mapping):
    """mapping= permutes logical rows onto physical chunk ids; encode,
    decode, decode_batch and ECUtil all follow it as the JAX isa plugin
    does."""
    k, m = 4, 2
    port = _port("isa", k, m, "reed_sol_van", mapping=mapping)
    ref = _jax("isa", k, m, "reed_sol_van", mapping=mapping)
    assert list(port.get_chunk_mapping()) == list(ref.get_chunk_mapping())
    payload = np.random.default_rng(3).integers(
        0, 256, 999, dtype=np.uint8).tobytes()
    enc = port.encode(set(range(6)), payload)
    ref_enc = ref.encode(set(range(6)), payload)
    for i in range(6):
        np.testing.assert_array_equal(enc[i], ref_enc[i])
    for gone in _erasures(6, 2):
        chunks = {i: enc[i] for i in range(6) if i not in gone}
        assert port.decode_concat(chunks) == ref.decode_concat(chunks)
        got = port.decode_batch({i: b[None] for i, b in chunks.items()},
                                list(gone))
        for i in gone:
            np.testing.assert_array_equal(got[i][0], enc[i])
    sinfo_p = port_ecutil.stripe_info_t(k, k * 64)
    sinfo_j = jax_ecutil.stripe_info_t(k, k * 64)
    obj = np.random.default_rng(4).integers(0, 256, 3 * k * 64,
                                            dtype=np.uint8)
    sh = port_ecutil.encode(sinfo_p, port, obj, set(range(6)))
    ref_sh = jax_ecutil.encode(sinfo_j, ref, obj, set(range(6)))
    for i in range(6):
        np.testing.assert_array_equal(sh[i], ref_sh[i])
    surv = {i: sh[i] for i in range(6) if i not in (0, 5)}
    np.testing.assert_array_equal(
        port_ecutil.decode_concat(sinfo_p, port, surv), obj)


@pytest.mark.parametrize("tech", TECHS)
@pytest.mark.parametrize("k,m", SHAPES)
def test_ecutil_whole_objects(k, m, tech):
    """ecutil.encode / decode / decode_concat of multi-stripe objects."""
    n = k + m
    chunk = 96
    port = _port("cuda", k, m, tech)
    ref = _jax("tpu", k, m, tech)
    sp = port_ecutil.stripe_info_t(k, k * chunk)
    sj = jax_ecutil.stripe_info_t(k, k * chunk)
    obj = np.random.default_rng(n).integers(0, 256, 5 * k * chunk,
                                            dtype=np.uint8)
    sh = port_ecutil.encode(sp, port, obj, set(range(n)))
    ref_sh = jax_ecutil.encode(sj, ref, obj, set(range(n)))
    for i in range(n):
        np.testing.assert_array_equal(sh[i], ref_sh[i])
    gone = (1, n - 3)
    surv = {i: sh[i] for i in range(n) if i not in gone}
    np.testing.assert_array_equal(
        port_ecutil.decode_concat(sp, port, surv), obj)
    np.testing.assert_array_equal(
        port_ecutil.decode_concat(sp, port, surv),
        jax_ecutil.decode_concat(sj, ref, surv))
    got = port_ecutil.decode(sp, port, surv, list(gone))
    want = jax_ecutil.decode(sj, ref, surv, list(gone))
    for i in gone:
        np.testing.assert_array_equal(got[i], sh[i])
        np.testing.assert_array_equal(got[i], want[i])
    assert port_ecutil.encode(sp, port, np.zeros(0, np.uint8), {0}) == {}
    with pytest.raises(ValueError):
        port_ecutil.encode(sp, port, obj[:-1], {0})


with open(CORPUS) as _f:
    CORPUS_PROFILES = json.load(_f)["profiles"]


@pytest.mark.parametrize("name", sorted(CORPUS_PROFILES))
def test_corpus_replay(name):
    """The pinned chunk sha256s of every entry of
    tests/corpus/ec_chunks.json, through the port (the ``tpu`` entry
    replays on the port's ``cuda`` plugin; every entry on
    ``backend=host``)."""
    entry = CORPUS_PROFILES[name]
    prof = dict(entry["profile"])
    if prof["plugin"] == "tpu":
        prof["plugin"] = "cuda"
    prof["backend"] = "host"
    codec = port_create(prof)
    n = codec.get_chunk_count()
    payload = hashlib.shake_128(b"ceph-tpu-corpus-v1").digest(65536)
    enc = codec.encode(set(range(n)), payload)
    assert len(enc) == len(entry["chunk_sha256"])
    for i in range(n):
        assert len(enc[i]) == entry["chunk_size"]
        assert hashlib.sha256(bytes(enc[i])).hexdigest() == \
            entry["chunk_sha256"][str(i)], f"{name} chunk {i}"


def test_profile_and_clamps_match_jax():
    for prof in ({"k": "40", "m": "2"}, {"k": "25", "m": "4"},
                 {"k": "8", "m": "6"}, {"k": "40", "m": "3",
                                        "technique": "cauchy"}):
        port = port_create({"plugin": "isa", "backend": "host", **prof})
        ref = jax_create({"plugin": "isa", "backend": "host", **prof})
        assert (port.k, port.m) == (ref.k, ref.m)
        np.testing.assert_array_equal(port.codec.matrix, ref.codec.matrix)
    with pytest.raises(ValueError):
        port_create({"plugin": "isa", "backend": "host",
                     "technique": "liberation"})
    with pytest.raises(ValueError):
        port_create({"plugin": "isa", "backend": "tpu"})
    with pytest.raises(ValueError):
        port_create({"plugin": "isa", "backend": "host", "k": "1"})
    with pytest.raises(KeyError):
        port_create({"plugin": "no_such_plugin", "backend": "host"})
    # regenerating is in the port's registry, with the JAX defaults
    port = port_create({"plugin": "regenerating", "backend": "host"})
    ref = jax_create({"plugin": "regenerating", "backend": "host"})
    assert port.get_profile() == ref.get_profile()


@pytest.mark.parametrize("k", [2, 5])
def test_example_xor_matches_jax(k):
    """The XOR-parity fixture: one parity chunk, every single erasure."""
    port = port_create({"plugin": "example_xor", "k": str(k),
                        "backend": "host"})
    ref = jax_create({"plugin": "example_xor", "k": str(k),
                      "backend": "host"})
    assert port.get_profile() == ref.get_profile()
    assert port.get_chunk_count() == ref.get_chunk_count() == k + 1
    payload = np.random.default_rng(k).integers(
        0, 256, 1234, dtype=np.uint8).tobytes()
    enc = port.encode(set(range(k + 1)), payload)
    ref_enc = ref.encode(set(range(k + 1)), payload)
    for i in range(k + 1):
        np.testing.assert_array_equal(enc[i], ref_enc[i])
    np.testing.assert_array_equal(
        enc[k], np.bitwise_xor.reduce(np.stack([enc[i] for i in range(k)])))
    for gone in range(k + 1):
        chunks = {i: enc[i] for i in range(k + 1) if i != gone}
        assert port.decode_concat(chunks) == ref.decode_concat(chunks)
        got = port.decode_batch({i: b[None] for i, b in chunks.items()},
                                [gone])
        np.testing.assert_array_equal(got[gone][0], enc[gone])
