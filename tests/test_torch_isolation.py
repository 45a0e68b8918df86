"""The port stands alone and never hides the device.

- importing every module of ``ceph_tpu_torch`` in a fresh interpreter
  leaves ``jax`` and ``ceph_tpu`` out of ``sys.modules``;
- no source file of the port imports ``jax`` or ``ceph_tpu``;
- asking for CUDA where there is none raises, and a tensor on a device
  other than the CPU never reaches the plain version.
"""
import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import ceph_tpu_torch
from ceph_tpu_torch.gf.matrices import gf_gen_rs_matrix
from ceph_tpu_torch.gf.tables import expand_to_bitmatrix
from ceph_tpu_torch.gf.word_codec import reed_sol_van_matrix_w
from ceph_tpu_torch.ops import (_build, crc32c_device, fused_encode_crc,
                                gf_pallas, resident)
from ceph_tpu_torch.ops.gf_matmul import (DeviceRSBackend,
                                          DeviceWordRSBackend,
                                          expand_to_bitmatrix_w)

PKG = Path(ceph_tpu_torch.__file__).parent
REPO = PKG.parent


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [str(PKG)], prefix="ceph_tpu_torch."))


def test_fresh_import_leaves_jax_out():
    mods = _modules()
    assert "ceph_tpu_torch.ops.gf_pallas" in mods
    assert "ceph_tpu_torch.osd.ecutil" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'ceph_tpu' or "
        "m.startswith('ceph_tpu.'))\n"
        "print(repr(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_walk_sees_the_crc_slice():
    """The package walk above reaches the crc32c / resident-write modules."""
    mods = _modules()
    for m in ("utils.crc32c", "ops.crc32c_device", "ops.resident",
              "os_store.device_shard", "common.config"):
        assert f"ceph_tpu_torch.{m}" in mods
    assert "ceph_tpu_torch/ops/resident.py" in {
        str(p.relative_to(REPO)) for p in PKG.rglob("*.py")}


def test_walk_sees_the_one_pass_kernel():
    """The package walk reaches the one-pass fused encode's module, and
    its CUDA source is among the sources the build knows."""
    assert "ceph_tpu_torch.ops.fused_encode_crc" in _modules()
    assert (PKG / "csrc" / "fused_encode_crc.cu").is_file()
    assert "fused_encode_crc" in _build.sources()


def test_walk_sees_the_codec_families():
    """The package walk reaches the jerasure, shec, lrc and example_xor
    plugins, their GF(2^w) and bitmatrix modules and the crush types lrc
    builds its rule from; K3 lives in the bit-matmul source."""
    mods = _modules()
    for m in ("ec.jerasure", "ec.shec", "ec.lrc", "ec.example_xor",
              "gf.bitmatrix", "gf.word_codec", "crush.constants",
              "crush.types"):
        assert f"ceph_tpu_torch.{m}" in mods
    src = (PKG / "csrc" / "gf_bit_matmul.cu").read_text()
    assert 'extern "C" int gfw_bit_matmul_launch(' in src
    assert "gfw_bit_matmul_launch" in gf_pallas._SIGNATURES


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in PKG.rglob("*.cu*")))
def test_cuda_source_includes_no_jax(path):
    """The CUDA sources include the toolkit's headers and the package's
    shared header only: nothing of JAX, XLA or the JAX package."""
    for line in (REPO / path).read_text().splitlines():
        if line.lstrip().startswith("#include"):
            assert line.split()[1].strip('<>"') in (
                "cuda_runtime.h", "stdint.h", "lookup.cuh"), (path, line)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in PKG.rglob("*.py")))
def test_source_imports_no_jax(path):
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for n in names:
            root = n.split(".")[0]
            assert root not in ("jax", "jaxlib", "ceph_tpu"), (path, n)


def test_chip_smoke_imports_no_jax():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else [node.module or ""])
            for n in names:
                assert n.split(".")[0] not in ("jax", "ceph_tpu"), n


def test_cuda_backend_without_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    from ceph_tpu_torch.ec import create_erasure_code
    with pytest.raises(RuntimeError, match="cuda"):
        create_erasure_code({"plugin": "cuda"})
    with pytest.raises(RuntimeError, match="cuda"):
        create_erasure_code({"plugin": "isa", "k": "4", "m": "2"})
    with pytest.raises(RuntimeError):
        DeviceRSBackend(gf_gen_rs_matrix(6, 4), "cuda")


def test_non_cpu_tensor_never_takes_plain(monkeypatch):
    """A tensor off the CPU goes to the kernel or raises: the plain
    version is not called, and no launch is counted."""
    def boom(*a, **kw):
        raise AssertionError("plain version called for a device tensor")
    monkeypatch.setattr(gf_pallas, "gf_bit_matmul_plain", boom)
    bm = gf_pallas.BitMatrix(
        expand_to_bitmatrix(gf_gen_rs_matrix(6, 4)[4:]), "cpu")
    before = gf_pallas.launches.n
    data = torch.empty((2, 4, 32), dtype=torch.uint8, device="meta")
    with pytest.raises((RuntimeError, ValueError)):
        gf_pallas.gf_bit_matmul_kernel(data, bm)
    assert gf_pallas.launches.n == before


def test_codec_families_without_device_raise():
    """The new plugins default to backend=cuda as the others do, and the
    word-layout backend asks for CUDA: without a card each raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    from ceph_tpu_torch.ec import create_erasure_code
    for prof in ({}, {"plugin": "jerasure", "w": "16"},
                 {"plugin": "jerasure", "technique": "cauchy_good"},
                 {"plugin": "shec"}, {"plugin": "example_xor"},
                 {"plugin": "lrc", "k": "4", "m": "2", "l": "3"}):
        with pytest.raises(RuntimeError, match="cuda"):
            create_erasure_code(prof)
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceWordRSBackend(np.eye(6, 4, dtype=np.int64) + 1, 16, "cuda")


def test_word_non_cpu_tensor_never_takes_plain(monkeypatch):
    """K3's wrapper sends a tensor off the CPU to the kernel or raises:
    neither plain version is called and no launch is counted."""
    def boom(*a, **kw):
        raise AssertionError("plain version called for a device tensor")
    monkeypatch.setattr(gf_pallas, "gfw_bit_matmul_plain", boom)
    monkeypatch.setattr(gf_pallas, "gf_bit_matmul_plain", boom)
    bm = gf_pallas.BitMatrix(
        expand_to_bitmatrix_w(reed_sol_van_matrix_w(4, 2, 16), 16), "cpu")
    before = (gf_pallas.launches.n, gf_pallas.word_launches.n)
    data = torch.empty((2, 4, 64), dtype=torch.uint8, device="meta")
    with pytest.raises((RuntimeError, ValueError)):
        gf_pallas.gfw_bit_matmul_kernel(data, bm, 16)
    assert (gf_pallas.launches.n, gf_pallas.word_launches.n) == before


@pytest.mark.parametrize("prof", [
    {"w": "16"}, {"w": "32"}, {"technique": "cauchy_good"},
    {"technique": "liber8tion", "k": "4"}])
def test_host_decoded_codecs_offer_no_device_decode(prof):
    """Word and bitmatrix codes decode on the host codec (chosen by
    technique, as the JAX package does); their decode_batch_device
    raises instead of going through the host, while a reed_sol w=8 code
    keeps it."""
    from ceph_tpu_torch.ec import create_erasure_code
    codec = create_erasure_code({"plugin": "jerasure", "backend": "host",
                                 **prof})
    assert not codec._device_decode_supported
    surv = torch.zeros((1, codec.k, 64), dtype=torch.uint8)
    with pytest.raises(NotImplementedError):
        codec.decode_batch_device(surv, list(range(codec.k)), [0])
    plain = create_erasure_code({"plugin": "jerasure", "backend": "host",
                                 "k": "4", "m": "2"})
    got = plain.decode_batch_device(torch.zeros((1, 4, 64),
                                                dtype=torch.uint8),
                                    [1, 2, 3, 4], [0])
    assert got.shape == (1, 1, 64)


def test_crc_non_cpu_tensor_never_takes_plain(monkeypatch):
    """The crc32c wrappers send a tensor off the CPU to the kernel or
    raise: the plain version is not called and no launch is counted."""
    def boom(*a, **kw):
        raise AssertionError("plain version called for a device tensor")
    monkeypatch.setattr(crc32c_device, "crc32c_plain", boom)
    before = crc32c_device.launches.n
    rows = torch.empty((3, 64), dtype=torch.uint8, device="meta")
    with pytest.raises(RuntimeError):
        crc32c_device.crc_core(rows)
    with pytest.raises(RuntimeError):
        crc32c_device.crc32c_kernel(rows, np.array([1, 2, 3]))
    with pytest.raises(RuntimeError):
        crc32c_device.crc32c_rows_kernel([rows[0], rows[1]])
    with pytest.raises(RuntimeError):
        crc32c_device.crc32c_gather_kernel(
            [rows[:2, :32], rows[:2, 32:]],
            [torch.empty(64, dtype=torch.uint8, device="meta")] * 2)
    assert crc32c_device.launches.n == before


def test_resident_non_cpu_tensor_never_takes_plain(monkeypatch):
    """The fused encode on a tensor off the CPU reaches neither plain
    version and counts no launch."""
    def boom(*a, **kw):
        raise AssertionError("plain version called for a device tensor")
    monkeypatch.setattr(gf_pallas, "gf_bit_matmul_plain", boom)
    monkeypatch.setattr(crc32c_device, "crc32c_plain", boom)
    monkeypatch.setattr(fused_encode_crc, "fused_encode_crc_plain", boom)
    bm = gf_pallas.BitMatrix(
        expand_to_bitmatrix(gf_gen_rs_matrix(6, 4)[4:]), "cpu")
    before = (resident.launches.n, gf_pallas.launches.n,
              crc32c_device.launches.n, fused_encode_crc.launches.n)
    data = torch.empty((2, 4, 32), dtype=torch.uint8, device="meta")
    with pytest.raises((RuntimeError, ValueError)):
        resident._fused_encode_crc(data, bm)
    assert (resident.launches.n, gf_pallas.launches.n,
            crc32c_device.launches.n, fused_encode_crc.launches.n) == before


def test_one_pass_non_cpu_tensor_never_takes_plain(monkeypatch):
    """At a shape the one-pass kernel takes (C = 2048), a tensor off the
    CPU goes to that kernel or raises: no plain version, no launch
    counted, the two-launch form not tried."""
    def boom(*a, **kw):
        raise AssertionError("plain version or two-pass form called")
    monkeypatch.setattr(fused_encode_crc, "fused_encode_crc_plain", boom)
    monkeypatch.setattr(gf_pallas, "gf_bit_matmul_plain", boom)
    monkeypatch.setattr(crc32c_device, "crc32c_plain", boom)
    monkeypatch.setattr(resident, "_fused_encode_crc_two_pass", boom)
    bm = gf_pallas.BitMatrix(
        expand_to_bitmatrix(gf_gen_rs_matrix(6, 4)[4:]), "cpu")
    before = (resident.launches.n, gf_pallas.launches.n,
              crc32c_device.launches.n, fused_encode_crc.launches.n)
    data = torch.empty((2, 4, 2048), dtype=torch.uint8, device="meta")
    bodies = [torch.empty(4096, dtype=torch.uint8, device="meta")] * 6
    assert fused_encode_crc.one_pass(2, 4, 2, 2048, [data.data_ptr()])
    with pytest.raises(RuntimeError, match="meta"):
        resident._fused_encode_crc(data, bm)
    with pytest.raises(RuntimeError, match="meta"):
        fused_encode_crc.fused_encode_crc_kernel(data, bm, bodies)
    assert (resident.launches.n, gf_pallas.launches.n,
            crc32c_device.launches.n, fused_encode_crc.launches.n) == before


def test_crc_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    assert not crc32c_device.device_crc_available()
    rows = np.zeros((2, 16), dtype=np.uint8)
    with pytest.raises(RuntimeError, match="CUDA"):
        crc32c_device.crc32c_device_batch(rows)
    with pytest.raises(RuntimeError, match="CUDA"):
        crc32c_device.crc32c_device_padded(rows, [3, 16])


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build("gf_bit_matmul")
    with pytest.raises(FileNotFoundError):
        _build.build("no_such_kernel")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build("fused_encode_crc")
    assert _build.sources() == ["crc32c", "fused_encode_crc",
                                "gf_bit_matmul"]


def test_build_path_tracks_source(monkeypatch, tmp_path):
    """The library name hashes the source and flags: an edited source
    gets a new build, an unchanged one reuses the old."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text("// a\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    a = _build.library_path("k")
    assert a == _build.library_path("k")
    (src / "k.cu").write_text("// b\n")
    assert _build.library_path("k") != a
    b = _build.library_path("k")
    (src / "shared.cuh").write_text("// c\n")          # a header counts too
    assert _build.library_path("k") != b
    a.parent.mkdir(parents=True)
    _build.library_path("k").write_bytes(b"")
    assert _build.build("k") == _build.library_path("k")   # reused


def test_bitmatrix_validates():
    with pytest.raises(ValueError):
        gf_pallas.BitMatrix(np.zeros((7, 8), np.uint8), "cpu")
    with pytest.raises(ValueError):
        gf_pallas.BitMatrix(np.full((8, 8), 2, np.uint8), "cpu")
    bm = gf_pallas.BitMatrix(np.eye(16, 8, dtype=np.uint8), "cpu")
    with pytest.raises(ValueError):
        gf_pallas.gf_bit_matmul_kernel(
            torch.zeros((1, 3, 8), dtype=torch.uint8), bm)
    with pytest.raises(ValueError):
        gf_pallas.gf_bit_matmul_kernel(
            torch.zeros((1, 2, 8), dtype=torch.int16), bm)
