"""The port stands alone and never hides the device.

- importing every module of ``ceph_tpu_torch`` in a fresh interpreter
  leaves ``jax`` and ``ceph_tpu`` out of ``sys.modules``;
- no source file of the port imports ``jax`` or ``ceph_tpu``;
- asking for CUDA where there is none raises, and a tensor on a device
  other than the CPU never reaches the plain version.
"""
import ast
import pkgutil
import re
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
from ceph_tpu_torch.ops import (_build, crc32c_device, crush_fast,
                                crush_legacy, fused_encode_crc, gf_pallas,
                                resident)
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
                "cuda_runtime.h", "stdint.h", "lookup.cuh",
                "crush_common.cuh"), (path, line)


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
    assert _build.sources() == ["crc32c", "crush_fast", "crush_legacy",
                                "crush_probe", "fused_encode_crc",
                                "gf_bit_matmul", "mesh_xor"]


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


def test_walk_sees_the_crush_slice():
    """The package walk reaches the CRUSH and OSDMap modules of the port,
    and K7a/K7b live in the source the build knows."""
    mods = _modules()
    for m in ("crush.hash", "crush.ln", "crush._ln_table_data",
              "crush.mapper", "crush.builder", "crush.wrapper",
              "ops.crush_kernels", "ops.crush_fast", "utils.str_hash",
              "osdmap.types", "osdmap.osdmap", "osdmap.mapping",
              "osdmap.simple_build"):
        assert f"ceph_tpu_torch.{m}" in mods
    src = (PKG / "csrc" / "crush_fast.cu").read_text()
    for entry in ("crush_descend_launch", "crush_resolve_launch"):
        assert f'extern "C" int {entry}(' in src
        assert entry in crush_fast._SIGNATURES
    assert "crush_fast" in _build.sources()


def test_walk_sees_the_placement_and_store_slice():
    """The package walk reaches the upmap, balancer, osdmaptool, message,
    monmap, dencoder, store and PG-log modules of the port."""
    mods = _modules()
    for m in ("crush.remap", "osdmap.encoding", "osdmap.upmap",
              "osdmap.balancer", "tools.osdmaptool", "msg.messages",
              "msg.kv", "msg.wire", "msg.messenger", "mon.monmap",
              "tools.dencoder", "os_store.memstore", "os_store.walstore",
              "osd.pg_log"):
        assert f"ceph_tpu_torch.{m}" in mods
    assert "ceph_tpu_torch.msg.tcp" in mods       # since the process slice


def test_upmap_raw_all_catches_nothing():
    """``upmap._raw_all`` picks the native mapper or the host
    ``crush_do_rule`` before it maps and has no exception handler."""
    from ceph_tpu_torch.osdmap import upmap
    tree = ast.parse((PKG / "osdmap" / "upmap.py").read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "_raw_all")
    assert not [n for n in ast.walk(fn) if isinstance(n, ast.Try)]
    assert upmap.NativeCrushMapper.__module__ == "ceph_tpu_torch.native"


def _small_rule():
    from ceph_tpu_torch.crush import CRUSH_BUCKET_STRAW2, CrushWrapper
    cw = CrushWrapper()
    cw.set_type_name(1, "host")
    cw.set_type_name(10, "root")
    hosts = [cw.add_bucket(CRUSH_BUCKET_STRAW2, 1, f"h{h}",
                           [2 * h, 2 * h + 1], [0x10000] * 2, id=-(h + 2))
             for h in range(4)]
    cw.set_max_devices(8)
    cw.add_bucket(CRUSH_BUCKET_STRAW2, 10, "default", hosts, [0x20000] * 4,
                  id=-1)
    return cw, cw.add_simple_rule("d", "default", "host", mode="firstn")


def test_crush_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    from ceph_tpu_torch.osdmap import OSDMapMapping
    cw, rno = _small_rule()
    with pytest.raises(RuntimeError, match="CUDA"):
        crush_fast.compile_fast_rule(cw.crush, rno, 3, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        crush_fast.compile_fast_rule(cw.crush, rno, 3)     # the default
    with pytest.raises(RuntimeError, match="CUDA"):
        OSDMapMapping()


def test_crush_non_cpu_tensor_never_takes_plain(monkeypatch):
    """K7a and K7b on a tensor off the CPU go to the kernel or raise: no
    plain version, no launch counted."""
    def boom(*a, **kw):
        raise AssertionError("plain version called for a device tensor")
    cw, rno = _small_rule()
    fr = crush_fast.compile_fast_rule(cw.crush, rno, 3, device="cpu")
    monkeypatch.setattr(crush_fast, "crush_descend_plain", boom)
    monkeypatch.setattr(crush_fast, "crush_resolve_plain", boom)
    before = (crush_fast.descend_launches.n, crush_fast.resolve_launches.n)
    lanes = [torch.empty(16, dtype=torch.int32, device="meta")] * 2
    with pytest.raises(RuntimeError, match="meta"):
        crush_fast.crush_descend(*lanes, fr.tables, fr.descent_spec())
    R = fr.numrep + fr.n_rounds - 1
    cand = torch.empty((R, 1, 16), dtype=torch.int32, device="meta")
    leaf = torch.empty((R, fr.n_leaf, 1, 16), dtype=torch.int32,
                       device="meta")
    flags = torch.empty(16, dtype=torch.bool, device="meta")
    with pytest.raises(RuntimeError, match="meta"):
        crush_fast.crush_resolve(fr.spec, cand, leaf, lanes[0], flags, flags,
                                 lanes[1][:8], 1, 3)
    assert (crush_fast.descend_launches.n,
            crush_fast.resolve_launches.n) == before


def test_osdmap_mapping_routes_only_compile_errors_to_host(monkeypatch):
    """OSDMapMapping._raw_batch maps a pool on the host only when its rule
    fails to compile (UnsupportedRule, compile_map's ValueError), before
    any launch; an error of map_batch itself propagates."""
    from ceph_tpu_torch.osdmap import (OSDMap, OSDMapMapping, TYPE_REPLICATED,
                                       pg_pool_t)
    from ceph_tpu_torch.osdmap import mapping as mapping_mod
    m = OSDMap()
    m.set_max_osd(8)
    cw, rno = _small_rule()
    m.crush = cw
    for i in range(8):
        m.set_osd(i, up=True)
    pid = m.add_pool("p", pg_pool_t(type=TYPE_REPLICATED, size=3,
                                    min_size=2, crush_rule=rno, pg_num=16,
                                    pgp_num=16))

    def unsupported(*a, **kw):
        raise crush_fast.UnsupportedRule("out of scope")
    monkeypatch.setattr(mapping_mod, "compile_fast_rule", unsupported)
    mm = OSDMapMapping(device="cpu")
    mm.update(m)
    assert mm.last_backend[pid] == "host"

    def failing_map_batch(self, xs, weight):
        raise ValueError("launch failed")
    monkeypatch.setattr(mapping_mod, "compile_fast_rule",
                        crush_fast.compile_fast_rule)
    monkeypatch.setattr(crush_fast.FastRule, "map_batch", failing_map_batch)
    with pytest.raises(ValueError, match="launch failed"):
        OSDMapMapping(device="cpu").update(m)
    for exc in (RuntimeError, ImportError):
        def broken(*a, exc=exc, **kw):
            raise exc("no device")
        monkeypatch.setattr(mapping_mod, "compile_fast_rule", broken)
        with pytest.raises(exc):
            OSDMapMapping(device="cpu").update(m)


def test_walk_sees_the_legacy_slice():
    """The package walk reaches crushtool's text and binary forms, its
    dumps, the legacy mapper and crushtool itself, and K8 lives in a
    source the build knows."""
    mods = _modules()
    for m in ("crush.compiler", "crush.binfmt", "crush.dumpfmt",
              "crush.treedump", "ops.crush_legacy", "tools.crushtool"):
        assert f"ceph_tpu_torch.{m}" in mods
    src = (PKG / "csrc" / "crush_legacy.cu").read_text()
    assert 'extern "C" int crush_legacy_launch(' in src
    assert '#include "crush_common.cuh"' in src
    assert "crush_legacy_launch" in crush_legacy._SIGNATURES
    assert "crush_legacy" in _build.sources()


def _legacy_map():
    import chip_smoke
    from ceph_tpu_torch.crush.compiler import CrushCompiler
    text, _ = chip_smoke.legacy_small_maps()["rack3x3x4"]
    return CrushCompiler().compile(text).crush


def test_legacy_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    m = _legacy_map()
    with pytest.raises(RuntimeError, match="CUDA"):
        crush_legacy.LegacyFastRule(m, 0, 3, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        crush_legacy.LegacyFastRule(m, 0, 3)               # the default


def test_legacy_non_cpu_tensor_never_takes_plain(monkeypatch):
    """K8's wrapper on a tensor off the CPU goes to the kernel or raises:
    no plain version, no launch counted."""
    def boom(*a, **kw):
        raise AssertionError("plain version called for a device tensor")
    rule = crush_legacy.LegacyFastRule(_legacy_map(), 0, 3, device="cpu")
    monkeypatch.setattr(crush_legacy, "crush_legacy_plain", boom)
    before = crush_legacy.launches.n
    x = torch.empty(16, dtype=torch.int32, device="meta")
    w = torch.empty(36, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="meta"):
        crush_legacy.crush_legacy(rule, x, w)
    assert crush_legacy.launches.n == before


def test_walk_sees_the_dispatch_slice():
    """The package walk reaches the dispatch scheduler, the fault
    registry, the native library's bindings, the bench's gate and CLI
    and ec_benchmark; the native C++ copies are the port's own."""
    mods = _modules()
    for m in ("dispatch", "dispatch.signature", "dispatch.future",
              "dispatch.batch", "dispatch.scheduler", "fault",
              "fault.registry", "native", "ops._build_host",
              "bench.regress", "bench.__main__", "tools.ec_benchmark"):
        assert f"ceph_tpu_torch.{m}" in mods
    from ceph_tpu_torch import native
    from ceph_tpu_torch.ops import _build_host
    assert _build_host.CSRC_HOST == PKG / "csrc_host"
    for src in native.SOURCES:
        assert (PKG / "csrc_host" / src).is_file()
    for path in (PKG / "csrc_host").iterdir():
        for line in path.read_text().splitlines():
            if line.lstrip().startswith("#include"):
                assert line.split()[1].startswith("<"), (path, line)


def _code_strings(tree):
    """Every string constant of a module that is not a docstring."""
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(
                    getattr(first, "value", None), ast.Constant):
                docs.add(id(first.value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in PKG.rglob("*.py")))
def test_source_names_no_path_under_native(path):
    """No port file builds, loads or names a path under the repo's
    ``native/`` (the JAX package's library lives there)."""
    for s in _code_strings(ast.parse((REPO / path).read_text())):
        parts = s.replace("\\", "/").split("/")
        assert "native" not in parts, (path, s)
        assert "libceph_tpu_native" not in s, (path, s)


def test_bench_cli_and_dispatch_workloads_need_the_card():
    """Without a card the bench's default (card) mode and the dispatch
    workloads raise; only ``--smoke`` / ``device="cpu"`` run here."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    from ceph_tpu_torch.bench import __main__ as cli
    from ceph_tpu_torch.bench import workloads
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--gate", "off"])
    with pytest.raises(RuntimeError, match="CUDA"):
        workloads.measure_dispatch_coalesce(n_requests=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        workloads.measure_ec_pipeline(n_requests=2)


def test_walk_sees_the_osd_data_path():
    """The package walk reaches the op queue, ``ECBackend``, the PG, the
    OSD and its helpers, recovery, the monitor, the client and the
    regenerating codec; the registry knows ``regenerating``."""
    mods = _modules()
    for m in ("common.work_queue", "osd.hit_set", "osd.snap_mapper",
              "osd.cls", "osd.cls_lock", "osd.tier", "osd.ec_backend",
              "osd.pg", "osd.osd", "recovery", "recovery.scheduler",
              "mon.monitor", "client", "client.mon_client",
              "client.rados", "client.striper", "ec.regenerating"):
        assert f"ceph_tpu_torch.{m}" in mods
    from ceph_tpu_torch.ec.registry import instance
    assert "regenerating" in instance.names()
    assert "ceph_tpu_torch.cluster" in mods


def _function(path, name, cls=None):
    tree = ast.parse((PKG / path).read_text())
    scope = tree
    if cls is not None:
        scope = next(n for n in ast.walk(tree)
                     if isinstance(n, ast.ClassDef) and n.name == cls)
    return next(n for n in ast.walk(scope)
                if isinstance(n, ast.FunctionDef) and n.name == name)


def _catch_alls(fn):
    """The handlers of ``fn`` that catch ``Exception`` or everything."""
    out = []
    for node in ast.walk(fn):
        if isinstance(node, ast.ExceptHandler):
            names = ([node.type] if not isinstance(node.type, ast.Tuple)
                     else node.type.elts) if node.type else [None]
            if any(n is None or (isinstance(n, ast.Name) and n.id in (
                    "Exception", "BaseException")) for n in names):
                out.append(node.lineno)
    return out


def test_device_seams_hold_no_catch_all():
    """``ECBackend._encode_resident`` (K5) and the recovery scheduler's
    sub-chunk repair round catch nothing: a failed build or launch
    reaches the caller.  The repair round checks the codec's refusals
    before the call instead."""
    enc = _function("osd/ec_backend.py", "_encode_resident")
    assert not [n for n in ast.walk(enc) if isinstance(n, ast.Try)]
    rnd = _function("recovery/scheduler.py", "_start_round")
    assert not _catch_alls(rnd)
    assert not [n for n in ast.walk(rnd) if isinstance(n, ast.Try)]


def test_regenerating_carries_no_guard():
    """The regenerating codec has no fault guard, breaker or host
    fallback; its decode and repair solves reach the mesh through
    ``g_mesh.decode_stacked``, the JAX package's hook."""
    tree = ast.parse((PKG / "ec" / "regenerating.py").read_text())
    used = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.Attribute):
            used.add(node.attr)
        elif isinstance(node, ast.alias):
            used.add(node.name)
        elif isinstance(node, ast.ImportFrom):
            used.add(node.module or "")
    for name in ("run_device_call", "_note_cpu_fallback",
                 "DeviceUnavailable", "_mesh_active"):
        assert name not in used, name
    assert {"g_mesh", "decode_stacked"} <= used
    for fn in ("encode_batch", "decode_batch", "repair"):
        assert not _catch_alls(_function("ec/regenerating.py", fn,
                                         "ErasureCodeRegenerating"))


def test_walk_sees_the_cluster_slice():
    """The package walk reaches ``MiniCluster``, the mgr chain, the mesh
    (with its chip scoreboard), the traffic harness and the cluster
    tools."""
    mods = _modules()
    for m in ("cluster", "mgr", "mgr.mgr", "mgr.telemetry", "mgr.incident",
              "mgr.http", "common.http_serve", "control",
              "control.controller", "chaos", "chaos.scenario",
              "chaos.engine", "mesh", "mesh.chipstat", "load",
              "load.traffic", "tools.rados", "tools.rados_bench",
              "tools.ceph_cli", "tools.psim"):
        assert f"ceph_tpu_torch.{m}" in mods
    assert sorted(m for m in mods if m.startswith("ceph_tpu_torch.mesh")) \
        == ["ceph_tpu_torch.mesh", "ceph_tpu_torch.mesh.chipstat",
            "ceph_tpu_torch.mesh.pool", "ceph_tpu_torch.mesh.rateless",
            "ceph_tpu_torch.mesh.runtime", "ceph_tpu_torch.mesh.topology"]
    from ceph_tpu import mesh as jax_mesh_pkg
    from ceph_tpu_torch import mesh
    assert set(jax_mesh_pkg.__all__) <= set(mesh.__all__)


def test_cluster_slice_carries_no_breaker():
    """No module of the cluster slice reads a breaker: the port has
    none, so ``g_breakers`` is named nowhere in their code."""
    for path in ("cluster.py", "mgr/mgr.py", "mgr/http.py",
                 "mgr/incident.py", "chaos/engine.py"):
        tree = ast.parse((PKG / path).read_text())
        names = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
        names |= {a.name for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) for a in n.names}
        assert "g_breakers" not in names, path
        assert "breakers" not in {a.arg for n in ast.walk(tree)
                                  if isinstance(n, ast.FunctionDef)
                                  for a in n.args.args}, path


def test_cluster_slice_device_seams_hold_no_catch_all():
    """Nothing added by the cluster slice wraps device work in a catch-
    all: the only broad ``except`` is the incident capture's, around the
    bundle's assembly."""
    for path in ("cluster.py", "mgr/mgr.py", "mgr/telemetry.py",
                 "mgr/http.py", "control/controller.py", "chaos/engine.py",
                 "chaos/scenario.py", "load/traffic.py", "tools/rados.py",
                 "tools/rados_bench.py", "tools/ceph_cli.py",
                 "tools/psim.py", "mesh/chipstat.py"):
        tree = ast.parse((PKG / path).read_text())
        for fn in ast.walk(tree):
            if isinstance(fn, ast.FunctionDef):
                assert not _catch_alls(fn), (path, fn.name)
    cap = _function("mgr/incident.py", "capture", "IncidentManager")
    assert len(_catch_alls(cap)) == 1
    tries = [n for n in ast.walk(cap) if isinstance(n, ast.Try)]
    assert len(tries) == 1
    called = {n.func.attr for n in ast.walk(tries[0].body[-1])
              if isinstance(n, ast.Call) and isinstance(n.func,
                                                        ast.Attribute)}
    assert called == {"_build_bundle"}


_JAX_MODULE_PATH = re.compile(r"(?<![\w.])ceph_tpu\.[A-Za-z_]")


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in PKG.rglob("*.py")) + ["chip_smoke.py"])
def test_source_names_no_jax_module_or_platform(path):
    """No text of the port (code, comment or docstring) names a module of
    the JAX package by its dotted path (``ceph_tpu_torch.`` is the port's
    own), or sets JAX's platform variables: a daemon it spawns is the
    port's, on the device the caller chose."""
    text = (REPO / path).read_text()
    assert not _JAX_MODULE_PATH.search(text), (
        path, _JAX_MODULE_PATH.search(text))
    for name in ("JAX_PLATFORMS", "XLA_FLAGS"):
        assert name not in text, (path, name)


def test_walk_sees_the_process_slice():
    """The package walk reaches the compressors, cephx, the TCP
    messenger, vstart and the offline tools."""
    mods = _modules()
    for m in ("compressor", "compressor.registry", "auth", "auth.crypto",
              "auth.keyring", "auth.cephx", "msg.tcp", "vstart",
              "tools.authtool", "tools.monmaptool", "tools.ceph_conf",
              "tools.kvstore_tool", "tools.monstore_tool",
              "tools.objectstore_tool", "tools.rebuild_mondb"):
        assert f"ceph_tpu_torch.{m}" in mods


def test_process_cluster_on_cuda_without_card_raises(monkeypatch):
    """``ProcessCluster(device="cuda")`` (the default) needs the card
    before it builds or spawns anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    from ceph_tpu_torch import vstart

    def boom(*a, **kw):
        raise AssertionError("spawned or built without a card")
    monkeypatch.setattr(vstart.subprocess, "Popen", boom)
    monkeypatch.setattr(_build, "build", boom)
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="CUDA"):
            vstart.ProcessCluster(n_osds=3, **kw)
    with pytest.raises(ValueError, match="neither cuda nor cpu"):
        vstart.ProcessCluster(n_osds=3, device="tpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        vstart._open_device("cuda")


def test_vstart_daemons_hold_no_catch_all():
    """Opening the card and the daemon mains catch nothing: a missing
    card or a failed build ends the OSD process before READY."""
    for fn in ("_open_device", "osd_main", "mon_main", "_daemon_start"):
        f = _function("vstart.py", fn)
        assert not [n for n in ast.walk(f) if isinstance(n, ast.Try)], fn


# ---- the mesh slice ---------------------------------------------------------

def test_walk_sees_the_mesh_slice():
    """The package walk reaches the mesh and ``parallel/`` with the JAX
    package's module names, and K9x's source is among the build's."""
    mods = _modules()
    for m in ("mesh.topology", "mesh.pool", "mesh.runtime", "mesh.rateless",
              "mesh.chipstat", "parallel", "parallel.mesh", "parallel.step",
              "parallel.ec", "parallel.crush", "ops.mesh_xor"):
        assert f"ceph_tpu_torch.{m}" in mods
    assert "mesh_xor" in _build.sources()


MESH_FILES = sorted(str(p.relative_to(PKG)) for d in ("mesh", "parallel")
                    for p in (PKG / d).glob("*.py"))


@pytest.mark.parametrize("path", MESH_FILES)
def test_mesh_slice_imports_no_jax_and_holds_no_guard(path):
    """Nothing under ``mesh/`` or ``parallel/`` imports ``jax`` or
    ``ceph_tpu``, names ``run_device_call`` or ``DeviceUnavailable``, or
    catches ``RuntimeError`` or everything around a launch."""
    tree = ast.parse((PKG / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                assert a.name.split(".")[0] not in ("jax", "ceph_tpu"), path
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            assert node.module.split(".")[0] not in ("jax", "ceph_tpu"), path
    names = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    names |= {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
    names |= {a.name for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) for a in n.names}
    for name in ("run_device_call", "DeviceUnavailable"):
        assert name not in names, (path, name)
    for node in ast.walk(tree):
        if isinstance(node, ast.ExceptHandler):
            caught = ([node.type] if not isinstance(node.type, ast.Tuple)
                      else node.type.elts) if node.type else [None]
            for c in caught:
                assert c is None or getattr(c, "id", None) not in (
                    "RuntimeError", "Exception", "BaseException"), \
                    (path, node.lineno)
                assert c is not None, (path, node.lineno)


def test_batch_mesh_stays_on_its_platform():
    """``batch_mesh(-1)`` holds members of one platform only, the CPU's
    here, and clamps an over-ask; a mesh on ``cuda`` with no card
    raises."""
    from ceph_tpu_torch.mesh import (addressable_devices, batch_mesh,
                                     members_per_device,
                                     set_members_per_device)
    from ceph_tpu_torch.parallel import make_mesh
    set_members_per_device(8)
    mesh = batch_mesh(-1)
    assert {m.device.type for m in mesh.members} == {"cpu"}
    assert mesh.size == 8 == members_per_device()
    assert batch_mesh(64).size == 8
    assert batch_mesh(-1, platform="cpu").size == 8
    if not torch.cuda.is_available():
        for call in (lambda: batch_mesh(-1, platform="cuda"),
                     lambda: addressable_devices(platform="cuda"),
                     lambda: make_mesh(8, platform="cuda")):
            with pytest.raises(RuntimeError, match="cuda"):
                call()
    with pytest.raises(ValueError):
        set_members_per_device(0)


def test_xor_reduce_non_cpu_tensor_never_takes_plain(monkeypatch):
    """K9x's wrapper takes its plain version only for a CPU tensor: a
    tensor on another device launches or raises."""
    from ceph_tpu_torch.ops import mesh_xor

    def boom(*a, **kw):
        raise AssertionError("plain version reached")
    monkeypatch.setattr(mesh_xor, "xor_reduce_plain", boom)
    with pytest.raises(RuntimeError, match="no kernel"):
        mesh_xor.xor_reduce(torch.zeros((2, 4), dtype=torch.uint8,
                                        device="meta"))


# ---- the harnesses on the mesh, journal/, rbd/ and the rbd tools -------------

RBD_SLICE_FILES = sorted(
    [str(p.relative_to(PKG)) for d in ("journal", "rbd")
     for p in (PKG / d).glob("*.py")]
    + [f"tools/{t}.py" for t in ("rbd_optfmt", "rbd_specs", "rbd_shell",
                                 "rbd_cli")])


def test_walk_sees_the_rbd_slice():
    """The package walk reaches ``journal/``, ``rbd/`` and the four rbd
    tools under the JAX package's module names, and the bench CLI runs
    every JAX workload."""
    mods = _modules()
    for m in ("journal", "journal.journaler", "journal.cls_journal", "rbd",
              "rbd.cls_rbd", "rbd.image", "rbd.mirror", "tools.rbd_optfmt",
              "tools.rbd_specs", "tools.rbd_shell", "tools.rbd_cli"):
        assert f"ceph_tpu_torch.{m}" in mods
    assert len(RBD_SLICE_FILES) == 11
    from ceph_tpu_torch.bench import __main__ as bench_cli
    from ceph_tpu_torch.bench import workloads
    assert bench_cli.NOT_PORTED == ()
    assert callable(workloads.measure_slo_autotune)
    assert callable(workloads.measure_composed_chaos)


@pytest.mark.parametrize("path", RBD_SLICE_FILES)
def test_rbd_slice_imports_no_jax_and_holds_no_catch_all(path):
    """Nothing of ``journal/``, ``rbd/`` or the rbd tools imports ``jax``
    or ``ceph_tpu``, or catches ``Exception`` or everything."""
    tree = ast.parse((PKG / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                assert a.name.split(".")[0] not in ("jax", "ceph_tpu"), path
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            assert node.module.split(".")[0] not in ("jax", "ceph_tpu"), path
    for fn in ast.walk(tree):
        if isinstance(fn, ast.FunctionDef):
            assert not _catch_alls(fn), (path, fn.name)


# ---- the cephfs slice -------------------------------------------------------

CEPHFS_SLICE_FILES = sorted(
    [str(p.relative_to(PKG)) for d in ("cephfs", "mds")
     for p in (PKG / d).glob("*.py")] + ["tools/cephfs_cli.py"])


def test_walk_sees_the_cephfs_slice():
    """The package walk reaches ``cephfs/``, ``mds/`` and ``cephfs_cli``
    under the JAX package's module names, and the OSD loads ``fs`` (and,
    since the rgw slice, ``rgw``)."""
    mods = _modules()
    for m in ("cephfs", "cephfs.client", "cephfs.cls_fs",
              "cephfs.mds_client", "mds", "mds.server", "tools.cephfs_cli"):
        assert f"ceph_tpu_torch.{m}" in mods
    assert len(CEPHFS_SLICE_FILES) == 7
    from ceph_tpu_torch.osd.cls import load_builtin_classes, lookup
    load_builtin_classes()
    assert lookup("fs", "mkfs") is not None
    assert lookup("rgw", "bucket_list") is not None


def _reroutes(handler):
    """A catch-all handler that does not end by re-raising what it
    caught."""
    last = handler.body[-1]
    return not (isinstance(last, ast.Raise) and last.exc is None)


@pytest.mark.parametrize("path", CEPHFS_SLICE_FILES)
def test_cephfs_slice_imports_no_jax_and_holds_no_catch_all(path):
    """Nothing of ``cephfs/``, ``mds/`` or ``cephfs_cli`` imports ``jax``
    or ``ceph_tpu``, or catches ``Exception`` or everything and carries
    on: the one catch-all (``RemoteCephFS.write`` releasing its caps on
    any error) re-raises, and the handlers inside it catch ``IOError``."""
    tree = ast.parse((PKG / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                assert a.name.split(".")[0] not in ("jax", "ceph_tpu"), path
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            assert node.module.split(".")[0] not in ("jax", "ceph_tpu"), path
    handlers = {h.lineno: h for h in ast.walk(tree)
                if isinstance(h, ast.ExceptHandler)}
    for fn in ast.walk(tree):
        if isinstance(fn, ast.FunctionDef):
            for line in _catch_alls(fn):
                assert not _reroutes(handlers[line]), (path, fn.name, line)
    if path == "cephfs/mds_client.py":
        write = _function(path, "write", cls="RemoteCephFS")
        assert len(_catch_alls(write)) == 1


def test_vstart_mds_path_holds_no_catch_all_and_no_card():
    """The MDS process and its harness methods catch nothing broadly
    and never open the card: ``mds_main`` starts like every daemon
    (``_daemon_start``) and codes nothing."""
    for fn in ("mds_main", "_spawn_mds", "kill_mds", "restart_mds"):
        f = _function("vstart.py", fn)
        assert not _catch_alls(f), fn
    main = _function("vstart.py", "mds_main")
    called = {n.func.id for n in ast.walk(main) if isinstance(n, ast.Call)
              and isinstance(n.func, ast.Name)}
    assert "_daemon_start" in called and "_open_device" not in called
    names = {n.attr for n in ast.walk(main) if isinstance(n, ast.Attribute)}
    assert "cuda" not in names


def test_harnesses_hold_no_catch_all_and_no_guard():
    """``run_scenario``, ``run_seed`` and the two harness workloads catch
    nothing (their ``finally`` restores state and lets a failure out),
    name no breaker, and the storyline's codecs follow the caller's
    device."""
    for path, fn in (("chaos/engine.py", "run_scenario"),
                     ("chaos/engine.py", "run_seed"),
                     ("chaos/engine.py", "_oracle_flush_fn"),
                     ("bench/workloads.py", "measure_slo_autotune"),
                     ("bench/workloads.py", "measure_composed_chaos")):
        f = _function(path, fn)
        assert not _catch_alls(f), (path, fn)
        names = {n.id for n in ast.walk(f) if isinstance(n, ast.Name)}
        names |= {a.name for n in ast.walk(f)
                  if isinstance(n, ast.ImportFrom) for a in n.names}
        assert not names & {"g_breakers", "ErasureCodeTpu",
                            "run_device_call"}, (path, fn)
    from ceph_tpu_torch.ec.cuda_plugin import backend_profile
    assert backend_profile("cpu") == {"backend": "host"}
    if torch.cuda.is_available():
        assert backend_profile("cuda") == {}
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            backend_profile("cuda")


def test_harnesses_need_the_card_by_default():
    """The storyline and the autotune ask for the card unless the caller
    passes ``device="cpu"``; without one they raise, and every option
    they set is restored."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    from ceph_tpu_torch.bench import workloads
    from ceph_tpu_torch.chaos import run_seed
    from ceph_tpu_torch.chaos.engine import TOUCHED
    from ceph_tpu_torch.common.config import g_conf
    before = {n: g_conf.values.get(n) for n in TOUCHED}
    with pytest.raises(RuntimeError, match="cuda"):
        run_seed(24)
    assert {n: g_conf.values.get(n) for n in TOUCHED} == before
    with pytest.raises(RuntimeError, match="cuda"):
        workloads.measure_composed_chaos(seeds=(24,))
    assert {n: g_conf.values.get(n) for n in TOUCHED} == before


# ---- the rgw slice and the analyzer ----------------------------------------

RGW_SLICE_FILES = sorted(
    [str(p.relative_to(PKG)) for d in ("rgw", "analysis")
     for p in (PKG / d).glob("*.py")]
    + ["tools/rgw_admin.py", "tools/rgw_admin_usage.py"])


def test_walk_sees_the_rgw_slice():
    """The package walk reaches ``rgw/``, ``analysis/`` and the two
    ``radosgw-admin`` modules under the JAX package's module names, and
    the port now has every JAX module but the three left out by design."""
    mods = _modules()
    for m in ("rgw", "rgw.acl_xml", "rgw.cls_rgw", "rgw.gateway",
              "rgw.http", "tools.rgw_admin", "tools.rgw_admin_usage",
              "analysis", "analysis.core", "analysis.rules",
              "analysis.__main__"):
        assert f"ceph_tpu_torch.{m}" in mods
    assert len(RGW_SLICE_FILES) == 11
    assert (PKG / "analysis" / "wire_manifest.json").is_file()
    jax_pkg = REPO / "ceph_tpu"
    missing = sorted(str(p.relative_to(jax_pkg)) for p in
                     jax_pkg.rglob("*.py")
                     if not (PKG / p.relative_to(jax_pkg)).is_file())
    assert missing == ["ec/tpu_plugin.py", "fault/breaker.py",
                       "fault/guard.py"]


def _reply_status(node):
    """The status of the reply a handler returns: ``_err(500, ...)`` or
    a ``(500, ...)`` tuple."""
    if not isinstance(node, ast.Return):
        return None
    v = node.value
    if isinstance(v, ast.Call) and v.args:
        v = v.args[0]
    elif isinstance(v, ast.Tuple):
        v = v.elts[0]
    return v.value if isinstance(v, ast.Constant) else None


@pytest.mark.parametrize("path", RGW_SLICE_FILES)
def test_rgw_slice_imports_no_jax_and_holds_no_catch_all(path):
    """Nothing of ``rgw/``, ``analysis/`` or ``radosgw-admin`` imports
    ``jax`` or ``ceph_tpu``, or catches ``Exception`` or everything and
    carries on, but for the reference's three sites: ``put_object``
    cancels its index op and re-raises (as ``RemoteCephFS.write``
    does), and the S3 and Swift handlers each turn any other error
    into a 5xx reply (a handler thread must always reply), which
    reroutes no work."""
    tree = ast.parse((PKG / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                assert a.name.split(".")[0] not in ("jax", "ceph_tpu"), path
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            assert node.module.split(".")[0] not in ("jax", "ceph_tpu"), path
    handlers = {h.lineno: h for h in ast.walk(tree)
                if isinstance(h, ast.ExceptHandler)}
    replies = []
    for fn in ast.walk(tree):
        if isinstance(fn, ast.FunctionDef):
            for line in _catch_alls(fn):
                h = handlers[line]
                if _reroutes(h):
                    assert path == "rgw/http.py", (path, fn.name, line)
                    assert len(h.body) == 1, (fn.name, line)
                    replies.append((fn.name, _reply_status(h.body[0])))
    if path == "rgw/http.py":
        assert sorted(replies) == [("handle", 500), ("handle", 500)]
    if path == "rgw/gateway.py":
        put = _function(path, "put_object", cls="RGWLite")
        assert len(_catch_alls(put)) == 1


def test_rgw_cuda_data_pool_without_card_raises():
    """Nothing in ``rgw/`` chooses a device: a ``cuda`` EC data pool
    with no card raises when its codec is made, before any gateway
    write, as rbd's and cephfs's data pools do."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    from ceph_tpu_torch.cluster import MiniCluster
    c = MiniCluster(n_osds=3)
    c.create_replicated_pool("rgwmeta", size=2, pg_num=8)
    with pytest.raises(RuntimeError, match="cuda"):
        c.create_ec_pool("rgwdata", k=2, m=1, plugin="isa", pg_num=8)
