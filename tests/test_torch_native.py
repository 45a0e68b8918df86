"""The port's native host library against the JAX package's, exactly.

Port side: ``ceph_tpu_torch.native`` (its own copies of the C++ sources,
built with g++ into ``build/ceph_tpu_torch/``) and the host crc32c that
runs it, ``ceph_tpu_torch.utils.crc32c``.  Reference side:
``ceph_tpu.native`` (``native/libceph_tpu_native.so``) and
``ceph_tpu.utils.crc32c``.  Inputs are seeded numpy bytes and maps built
through both packages' ``CrushWrapper``; every comparison is exact
equality: these are integer functions.
"""
import threading
from pathlib import Path

import numpy as np
import pytest

import ceph_tpu.crush as jc
import ceph_tpu_torch.crush as tc
from ceph_tpu import native as jax_native
from ceph_tpu.gf.tables import gf_mul
from ceph_tpu.utils.crc32c import crc32c as jax_crc32c
from ceph_tpu.utils.crc32c import crc32c_sw as jax_crc32c_sw

import ceph_tpu_torch
from ceph_tpu_torch import native
from ceph_tpu_torch.gf.matrices import gf_gen_rs_matrix
from ceph_tpu_torch.ops import _build, _build_host
from ceph_tpu_torch.utils.crc32c import crc32c, crc32c_sw

import test_crush_device
from test_torch_crush_host import _rule_styles, build_map

REPO = Path(ceph_tpu_torch.__file__).resolve().parent.parent


def test_library_builds_under_build_not_native():
    """The port's library is its own g++ build of ``csrc_host/`` under
    ``build/ceph_tpu_torch/``; the JAX package's ``native/`` is neither
    read nor written."""
    lib = native.get_lib()
    path = Path(lib._name).resolve()
    assert path.parent == _build.BUILD_DIR.resolve()
    assert path.parent == REPO / "build" / "ceph_tpu_torch"
    assert path.name.startswith(native.LIB_NAME + "-")
    for src in native.SOURCES:
        assert (_build_host.CSRC_HOST / src).is_file()
    assert native.native_available() is True


@pytest.mark.parametrize("seed", range(4))
def test_crc32c_matches_sw_and_jax(seed):
    rng = np.random.default_rng(seed)
    for n in (0, 1, 7, 64, 4095, 65537):
        data = rng.integers(0, 256, size=n, dtype=np.uint8)
        crc = int(rng.integers(0, 1 << 32))
        want = crc32c_sw(data, crc)
        assert crc32c(data, crc) == want
        assert crc32c(data.tobytes(), crc) == want
        assert native.crc32c(bytearray(data.tobytes()), crc) == want
        assert jax_crc32c(data.tobytes(), crc) == want
        assert crc32c(data) == jax_crc32c(data)


def test_crc32c_reference_vectors():
    """The reference's test/common/test_crc32c.cc golden vectors."""
    assert crc32c(b"foo bar baz", 0) == 4119623852
    assert crc32c(b"foo bar baz", 1234) == 881700046
    assert crc32c(b"whiz bang boom", 0) == 2360230088
    assert crc32c(b"\x01" * 4096000, 1234) == 1400919119
    assert crc32c(b"", -1) == 0xFFFFFFFF


@pytest.mark.parametrize("make", [
    lambda rng: np.arange(64, dtype=np.uint8)[::2],
    lambda rng: rng.integers(0, 256, (33, 40), dtype=np.uint8)[:, 3:29],
    lambda rng: rng.integers(0, 256, (5, 7), dtype=np.uint8).T,
    lambda rng: rng.integers(0, 1 << 16, 300, dtype=np.uint16),
], ids=["stride2", "2d_slice", "transposed", "u16"])
def test_strided_input_pinned_to_crc32c_sw(make):
    """The native path hashes an array's elements as uint8 in C order,
    as ``crc32c_sw`` (both packages') does, never the raw memory under
    its base pointer."""
    arr = make(np.random.default_rng(5))
    want = jax_crc32c_sw(arr)
    assert crc32c_sw(arr) == want
    assert crc32c(arr) == want
    if arr.dtype == np.uint8 and arr.ndim == 1:
        assert want == 3894026348


def test_crc32c_threads_agree():
    """Eight threads hashing at once (the library releases the GIL in
    ctypes) each get the single-threaded answer."""
    rng = np.random.default_rng(11)
    bufs = [rng.integers(0, 256, 50_000, dtype=np.uint8) for _ in range(8)]
    want = [crc32c_sw(b) for b in bufs]
    got = [[] for _ in bufs]

    def work(i):
        for _ in range(20):
            got[i].append(crc32c(bufs[i]))

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert got == [[w] * 20 for w in want]


def test_gf_mul_matches_jax():
    rng = np.random.default_rng(0)
    lib = jax_native.get_lib()
    for a, b in rng.integers(0, 256, (500, 2)):
        a, b = int(a), int(b)
        assert native.gf_mul_c(a, b) == lib.gf_mul_c(a, b) == gf_mul(a, b)


@pytest.mark.parametrize("k,m,n", [(8, 4, 4096), (4, 2, 1000), (10, 4, 1)])
def test_rs_encode_matches_jax(k, m, n):
    matrix = gf_gen_rs_matrix(k + m, k)
    data = np.random.default_rng(k * n).integers(0, 256, (k, n),
                                                 dtype=np.uint8)
    got = native.native_rs_encode(matrix[k:], data)
    assert got.dtype == np.uint8 and got.shape == (m, n)
    np.testing.assert_array_equal(
        got, jax_native.native_rs_encode(matrix[k:], data))


def _random_map(pkg, rng, n_hosts, osds_per_host, algs):
    """``test_native_parity._random_map`` through ``pkg``."""
    cw = pkg.CrushWrapper()
    n = n_hosts * osds_per_host
    cw.set_max_devices(n)
    cw.set_type_name(1, "host")
    cw.set_type_name(10, "root")
    host_ids, host_weights = [], []
    for h in range(n_hosts):
        osds = list(range(h * osds_per_host, (h + 1) * osds_per_host))
        weights = [int(rng.integers(1, 4)) * 0x10000 for _ in osds]
        alg = algs[int(rng.integers(len(algs)))]
        alg = getattr(pkg, f"CRUSH_BUCKET_{alg}")
        host_ids.append(cw.add_bucket(alg, 1, f"host{h}", osds, weights,
                                      id=-(h + 2)))
        host_weights.append(sum(weights))
    cw.add_bucket(pkg.CRUSH_BUCKET_STRAW2, 10, "default", host_ids,
                  host_weights, id=-1)
    return cw


@pytest.mark.parametrize("mode,rule_type", [("firstn", 1), ("indep", 3)])
@pytest.mark.parametrize("algs", [
    ("STRAW2",), ("UNIFORM", "LIST", "STRAW", "STRAW2", "TREE")],
    ids=["straw2", "all_algs"])
def test_mapper_matches_jax_random_maps(mode, rule_type, algs):
    """``NativeCrushMapper`` rows of the port equal the JAX package's and
    the port's ``crush_do_rule``, one x at a time and in a batch."""
    seed = len(algs) * 10 + (1 if mode == "firstn" else 2)
    rng = np.random.default_rng(seed)
    for trial in range(3):
        n_hosts = int(rng.integers(3, 8))
        oph = int(rng.integers(2, 5))
        ref = _random_map(jc, np.random.default_rng([seed, trial]),
                          n_hosts, oph, algs)
        port = _random_map(tc, np.random.default_rng([seed, trial]),
                           n_hosts, oph, algs)
        rno = ref.add_simple_rule("r", "default", "host", mode=mode,
                                  rule_type=rule_type)
        assert port.add_simple_rule("r", "default", "host", mode=mode,
                                    rule_type=rule_type) == rno
        n = n_hosts * oph
        weight = [0x10000] * n
        for i in rng.integers(0, n, size=max(1, n // 4)):
            weight[int(i)] = int(rng.integers(0, 2)) * 0x8000
        blob = native.serialize_map(port.crush)
        np.testing.assert_array_equal(blob,
                                      jax_native.serialize_map(ref.crush))
        nm = native.NativeCrushMapper(port.crush)
        jm = jax_native.NativeCrushMapper(ref.crush)
        xs = list(range(300))
        out, lens = nm.do_rule_batch(rno, xs, 3, weight)
        jout, jlens = jm.do_rule_batch(rno, xs, 3, weight)
        np.testing.assert_array_equal(out, jout)
        np.testing.assert_array_equal(lens, jlens)
        for x in xs:
            row = out[x, :lens[x]].tolist()
            assert nm.do_rule(rno, x, 3, weight) == row
            assert tc.crush_do_rule(port.crush, rno, x, 3, weight) == row, \
                (trial, x)


@pytest.mark.parametrize("style", [s for s in _rule_styles()
                                   if s[0] in ("chooseleaf_firstn",
                                               "firstn_out_devices",
                                               "chooseleaf_indep_uneven",
                                               "chained")],
                         ids=lambda s: s[0])
def test_mapper_matches_jax_rule_styles(style):
    """The port's CRUSH test maps (``test_torch_crush_host``'s rule
    styles): port native rows = JAX native rows = port ``crush_do_rule``."""
    _, kw, add, result_max, edit = style
    ref, n = test_crush_device.build_map(**kw)
    port, _ = build_map(tc, **kw)
    rno = add(jc, ref)
    assert add(tc, port) == rno
    weight = [0x10000] * n
    if edit:
        weight = edit(weight)
    xs = list(range(200))
    out, lens = native.NativeCrushMapper(port.crush).do_rule_batch(
        rno, xs, result_max, weight)
    jout, jlens = jax_native.NativeCrushMapper(ref.crush).do_rule_batch(
        rno, xs, result_max, weight)
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(lens, jlens)
    for x in xs:
        assert out[x, :lens[x]].tolist() == tc.crush_do_rule(
            port.crush, rno, x, result_max, weight), x


def test_failed_build_raises(monkeypatch, tmp_path):
    """A source g++ rejects raises with the compiler's output; nothing
    is loaded in its place."""
    (tmp_path / "bad.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_build_host, "CSRC_HOST", tmp_path)
    monkeypatch.setattr(_build_host, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        _build_host.build("bad", ["bad.cpp"])
    assert not any((tmp_path / "out").glob("*.so"))


def test_missing_compiler_raises(monkeypatch):
    monkeypatch.setattr(_build_host.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        _build_host.build(native.LIB_NAME, native.SOURCES)


def test_build_key_tracks_source(monkeypatch, tmp_path):
    """An edited source gets a new library path; an unchanged one the
    same."""
    src = tmp_path / "x.cpp"
    src.write_text('extern "C" int f() { return 1; }\n')
    monkeypatch.setattr(_build_host, "CSRC_HOST", tmp_path)
    cxx = _build_host.find_cxx()
    a = _build_host.library_path("x", ["x.cpp"], cxx)
    assert _build_host.library_path("x", ["x.cpp"], cxx) == a
    src.write_text('extern "C" int f() { return 2; }\n')
    assert _build_host.library_path("x", ["x.cpp"], cxx) != a
