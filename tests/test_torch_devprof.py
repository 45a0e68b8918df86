"""The port's device-flow profiler and its call sites against the JAX
package's, on the CPU.

Port side: ``ceph_tpu_torch.trace.devprof`` and the accounting sites in
``ops/gf_matmul``, ``ops/resident``, ``ops/crc32c_device``,
``ops/crush_fast`` and ``os_store/device_shard`` (CPU tensors, the
kernels' plain versions).  Reference side: the same modules of
``ceph_tpu`` on the CPU.  Each test runs the same call sequence on the
same seeded numpy inputs with a fresh ``DevFlowProfiler`` in place of
each module's ``g_devprof``, and compares per-site bytes and counts
exactly.  Compiles are not compared: the reference counts XLA compiles,
the port nvcc builds, and the CPU runs neither.

Sites where the port moves different bytes by design are pinned to the
port's figure (ROADMAP Queue 3):
- ``gf_matmul.decode_bits``: the port uploads the 0/1 matrix and the
  kernel's nibble tables, the reference the int8 matrix alone;
- ``crc32c.tables``: the port uploads its tables on the card only (the
  plain CPU version reads host tables), the reference on any backend;
- ``crush.map_batch``'s full fetch: the port fetches the flagged count
  in front of the rows, 4 bytes more.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import ceph_tpu.ops.crc32c_device as jcrc
import ceph_tpu.ops.crush_fast as jfast
import ceph_tpu.ops.gf_matmul as jgf
import ceph_tpu.ops.resident as jres
import ceph_tpu.os_store.device_shard as jshard
import ceph_tpu.trace.devprof as jdevprof
from ceph_tpu.crush import CRUSH_BUCKET_STRAW2 as J_STRAW2
from ceph_tpu.crush import CrushWrapper as JCrushWrapper
from ceph_tpu.ec import create_erasure_code as jax_create
from ceph_tpu.gf.matrices import gf_gen_rs_matrix

import ceph_tpu_torch.ops.crc32c_device as pcrc
import ceph_tpu_torch.ops.crush_fast as pfast
import ceph_tpu_torch.ops.gf_matmul as pgf
import ceph_tpu_torch.ops.resident as pres
import ceph_tpu_torch.os_store.device_shard as pshard
import ceph_tpu_torch.trace.devprof as pdevprof
from ceph_tpu_torch.common.config import g_conf
from ceph_tpu_torch.crush import CRUSH_BUCKET_STRAW2 as P_STRAW2
from ceph_tpu_torch.crush import CrushWrapper as PCrushWrapper
from ceph_tpu_torch.ec import create_erasure_code as port_create

SITE_KEYS = ("h2d_bytes", "h2d_count", "d2h_bytes", "d2h_count",
             "host_copy_bytes", "host_copies")


def _sites(prof):
    return {site: {k: v[k] for k in SITE_KEYS}
            for site, v in prof.dump()["sites"].items()}


@pytest.fixture
def fresh(monkeypatch):
    """A fresh profiler in place of ``g_devprof`` in every listed module
    of one package; returns it."""
    def install(devprof_mod, *mods):
        prof = devprof_mod.DevFlowProfiler()
        for m in mods:
            monkeypatch.setattr(m, "g_devprof", prof)
        return prof
    return install


def test_gf_matmul_sites(fresh):
    rng = np.random.default_rng(21)
    data = rng.integers(0, 256, (3, 8, 512), dtype=np.uint8)
    mat = gf_gen_rs_matrix(12, 8)
    srcs, lost = (2, 3, 4, 5, 6, 7, 8, 9), (0, 1)

    def run(gf, prof, be):
        coding = be.encode(data)
        surv = np.concatenate([data[:, 2:], coding[:, :2]], axis=1)
        got = be.decode_data(surv, srcs, lost)
        be.decode_data(surv, srcs, lost)        # cached matrix: no upload
        assert np.array_equal(got, data[:, :2])
        return _sites(prof)

    j = run(jgf, fresh(jdevprof, jgf), jgf.DeviceRSBackend(mat))
    p_prof = fresh(pdevprof, pgf)
    be = pgf.DeviceRSBackend(mat, "cpu")
    p = run(pgf, p_prof, be)
    bits = be._decode_bits_for(srcs, lost)
    j_bits, p_bits = j.pop("gf_matmul.decode_bits"), \
        p.pop("gf_matmul.decode_bits")
    assert p == j
    assert j_bits["h2d_count"] == p_bits["h2d_count"] == 1
    assert j_bits["h2d_bytes"] == 64 * 16
    assert p_bits["h2d_bytes"] == bits.nbytes == 64 * 16 + 4 * 8 * 32


def test_word_encode_site(fresh):
    rng = np.random.default_rng(22)
    data = rng.integers(0, 256, (2, 4, 64), dtype=np.uint8)
    coding = np.array([[1, 1, 1, 1], [1, 2, 4, 8]], dtype=np.int64)
    mat = np.vstack([np.eye(4, dtype=np.int64), coding])
    jp = fresh(jdevprof, jgf)
    jout = jgf.DeviceWordRSBackend(mat, 16).encode(data)
    pp = fresh(pdevprof, pgf)
    pout = pgf.DeviceWordRSBackend(mat, 16, "cpu").encode(data)
    assert np.array_equal(pout, jout)
    assert _sites(pp) == _sites(jp)


def test_resident_and_shard_sites(fresh, monkeypatch):
    monkeypatch.setitem(g_conf.values, "os_memstore_device_bytes_max", 0)
    rng = np.random.default_rng(23)
    stripes = rng.integers(0, 256, (4, 8, 2048), dtype=np.uint8)

    def run(res, shard, devprof, codec):
        prof = fresh(devprof, res, shard)
        shards = res.encode_resident_shards(codec, stripes)
        bytes(shards[0])
        bytes(shards[0])                       # later reads are free
        shards[5].demote()
        shards[5].demote()
        return _sites(prof), [shards[i].crc for i in range(12)]

    j = run(jres, jshard, jdevprof,
            jax_create({"plugin": "tpu", "k": "8", "m": "4"}))
    p = run(pres, pshard, pdevprof,
            port_create({"plugin": "cuda", "k": "8", "m": "4",
                         "backend": "host"}))
    assert p == j
    assert set(p[0]) == {"ec.encode_resident", "ec.crc_fetch",
                         "memstore.fetch_shard", "memstore.demote_shard"}


def test_crc32c_sites(fresh, monkeypatch):
    rng = np.random.default_rng(24)
    body = rng.integers(0, 256, 3000, dtype=np.uint8)
    monkeypatch.setattr(jcrc, "_tables_dev", None)
    jp = fresh(jdevprof, jcrc)
    jcrc_v = jcrc.crc32c_of_device_array(jcrc.jnp.asarray(body))
    monkeypatch.setattr(pcrc, "_dev_cache", {})
    pp = fresh(pdevprof, pcrc)
    pcrc_v = pcrc.crc32c_of_device_array(torch.from_numpy(body))
    assert pcrc_v == jcrc_v
    j, p = _sites(jp), _sites(pp)
    assert p["crc32c.verify_fetch"] == j["crc32c.verify_fetch"] == {
        **dict.fromkeys(SITE_KEYS, 0), "d2h_bytes": 4, "d2h_count": 1}
    # the reference uploads its 8 x 256 slicing tables on first use; the
    # port's plain CPU version reads host tables and uploads nothing
    assert j["crc32c.tables"]["h2d_bytes"] == 8 * 256 * 4
    assert "crc32c.tables" not in p
    # on the card the port uploads once per table and device, accounted
    before = pp.totals()["h2d_count"]
    pcrc.device_tables("cpu")
    pcrc.device_tables("cpu")
    assert pp.totals()["h2d_count"] == before + 1
    assert _sites(pp)["crc32c.tables"]["h2d_bytes"] == 8 * 256 * 4


def _map(cw_cls, straw2, n_hosts=6, per_host=4):
    cw = cw_cls()
    cw.set_type_name(1, "host")
    cw.set_type_name(10, "root")
    hosts = []
    for h in range(n_hosts):
        osds = list(range(h * per_host, (h + 1) * per_host))
        hosts.append(cw.add_bucket(straw2, 1, f"host{h}", osds,
                                   [0x10000] * per_host, id=-(h + 2)))
    cw.set_max_devices(n_hosts * per_host)
    cw.add_bucket(straw2, 10, "default", hosts,
                  [0x10000 * per_host] * n_hosts, id=-1)
    return cw, cw.add_simple_rule("data", "default", "host", mode="firstn")


def test_crush_fast_sites(fresh):
    xs = np.arange(300, dtype=np.uint32)
    n = 24

    def run(fast, devprof, fr):
        prof = fresh(devprof, fast)
        w = np.full(n, 0x10000, np.uint32)
        rows = [fr.map_batch(xs, w)]           # candidates + full fetch
        for e in range(3):                     # delta fetches
            w2 = w.copy()
            w2[(7 * e + 3) % n] = 0
            rows.append(fr.map_batch(xs, w2))
        fr.delta_cap = 1                       # overflow: a full fetch
        w3 = w.copy()
        w3[:3] = 0
        rows.append(fr.map_batch(xs, w3))
        return _sites(prof), rows

    jcw, jr = _map(JCrushWrapper, J_STRAW2)
    pcw, pr = _map(PCrushWrapper, P_STRAW2)
    j, jrows = run(jfast, jdevprof, jfast.compile_fast_rule(jcw.crush, jr, 3))
    p, prows = run(pfast, pdevprof,
                   pfast.compile_fast_rule(pcw.crush, pr, 3, device="cpu"))
    for (ja, jc), (pa, pc) in zip(jrows, prows):
        assert np.array_equal(jc, pc)
        cols = np.arange(3)[None, :]
        assert np.array_equal(np.where(cols < jc[:, None], ja, -1),
                              np.where(cols < pc[:, None], pa, -1))
    assert p["crush.candidates"] == j["crush.candidates"]
    jm, pm = j.pop("crush.map_batch"), p.pop("crush.map_batch")
    assert {k: v for k, v in pm.items() if k != "d2h_bytes"} == \
        {k: v for k, v in jm.items() if k != "d2h_bytes"}
    # two full fetches, each with the 4-byte flagged count in front
    assert pm["d2h_bytes"] == jm["d2h_bytes"] + 2 * 4


def test_compile_hook_attributes_to_the_active_stage(monkeypatch, tmp_path):
    """An nvcc run counts one compile in the singleton's active stage; a
    cached build counts nothing.  The compiler is stood in for by a
    script that writes the library, since this host has no nvcc."""
    import ceph_tpu_torch.ops._build as build
    prof = pdevprof.DevFlowProfiler()
    monkeypatch.setattr(build, "g_devprof", prof)
    monkeypatch.setattr(build, "find_nvcc", lambda: "nvcc")
    written = []

    class Done:
        returncode, stdout, stderr = 0, "", ""

    def fake_run(cmd, **kw):
        out = cmd[cmd.index("-o") + 1]
        open(out, "wb").close()
        written.append(out)
        return Done()

    monkeypatch.setattr(build, "subprocess", SimpleNamespace(run=fake_run))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "build_logs", {})
    with prof.stage("bench.encode"):
        build.build("crc32c")
        build.build("crc32c")                  # cached: no nvcc run
    build.build("crush_probe")
    assert len(written) == 2
    sites = prof.dump()["sites"]
    assert sites["bench.encode"]["compiles"] == 1
    assert sites["unattributed"]["compiles"] == 1
    assert prof.totals()["compiles"] == 2
    # build_all's worker threads take the caller's stage with them
    for so in tmp_path.glob("*.so"):
        so.unlink()
    with prof.stage("smoke.build"):
        built = build.build_all()
    assert sorted(built) == build.sources()
    sites = prof.dump()["sites"]
    assert sites["smoke.build"]["compiles"] == len(build.sources())
    assert sites["unattributed"]["compiles"] == 1


def test_singleton_mirrors_counters_and_device_mem_on_cpu():
    g = pdevprof.g_devprof
    pc = pdevprof.devprof_perf_counters()
    b0 = pc.get("h2d_bytes")
    g.account_h2d("test.site", 1000)
    assert pc.get("h2d_bytes") == b0 + 1000
    d = g.dump()
    assert d["device_mem"] == {"source": "none", "bytes_in_use": 0,
                               "peak_bytes_in_use": 0}
    assert "counters" in d and "transfer_size_histogram" in d
    assert "counters" not in pdevprof.DevFlowProfiler().dump()
    delta = pdevprof.devflow_delta({"h2d_bytes": 0}, {"h2d_bytes": 10,
                                                      "h2d_count": 2}, 4)
    assert delta == jdevprof.devflow_delta({"h2d_bytes": 0},
                                           {"h2d_bytes": 10,
                                            "h2d_count": 2}, 4)
