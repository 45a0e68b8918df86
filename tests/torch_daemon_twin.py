"""Shared pieces of the daemon twin tests (``test_torch_*`` files that
hold the port's OSD data path, monitor and client to the JAX package's).

Both packages' daemons are built by the one helper, ``chip_smoke.Daemons``
(mon + OSDs + client over one in-process ``Network``, as the JAX
``MiniCluster`` assembles them without its ``Manager``), with the same
seeds and sizes.  The JAX side runs ``plugin=tpu`` on its CPU platform;
the port side ``plugin=cuda, backend=host`` (the kernels' plain PyTorch
versions on CPU tensors).
"""
import contextlib
import gc
import struct

import numpy as np
import pytest

import chip_smoke
from ceph_tpu.common.config import g_conf as jax_conf
from ceph_tpu.dispatch import g_dispatcher as jax_dispatcher
from ceph_tpu.fault import g_breakers as jax_breakers
from ceph_tpu.fault import g_faults as jax_faults
from ceph_tpu.mesh import g_chipstat as jax_chipstat
from ceph_tpu.mesh import g_mesh as jax_mesh
from ceph_tpu.trace.journal import g_journal as jax_journal

from ceph_tpu_torch.common.config import g_conf
from ceph_tpu_torch.dispatch import g_dispatcher
from ceph_tpu_torch.fault import g_faults
from ceph_tpu_torch.mesh import g_chipstat, g_mesh
from ceph_tpu_torch.trace.journal import g_journal

JAX, PORT = "ceph_tpu", "ceph_tpu_torch"
PLUGIN = {JAX: {"plugin": "tpu"},
          PORT: {"plugin": "cuda", "backend": "host"}}


def reset_both(collect: bool = True) -> None:
    """Both packages at their defaults: dispatchers drained, every
    option unset, no fault armed, both event journals and chip
    scoreboards empty, both meshes down and the JAX breakers empty.

    The journals are process-global and no cluster clears them: an
    incident bundle's timeline is the merged tail of every event the
    worker emitted, so a JAX-only cluster test earlier in the same
    worker would put its ``osd_down`` events in one side only.  For the
    same reason the garbage of earlier tests is collected first: the
    device-shard budgets count every resident shard alive in the process
    (``test_device_crc.py`` leaves 89 in reference cycles); a caller
    whose clusters hold no resident shard passes ``collect=False``."""
    if collect:
        gc.collect()
    g_dispatcher.flush()
    jax_dispatcher.flush()
    g_faults.clear()
    jax_faults.clear()
    for conf in (g_conf, jax_conf):
        for name in list(conf.values):
            conf.rm_val(name)
    jax_mesh.topology()
    g_mesh.topology()
    g_journal.reset()
    jax_journal.reset()
    g_chipstat.reset()
    jax_chipstat.reset()
    jax_breakers.reset()


MESH_LOGGERS = ("mesh_perf_counters", "mesh_decode_perf_counters",
                "rateless_perf_counters", "membership_perf_counters",
                "mesh_chip_perf_counters")


@contextlib.contextmanager
def fresh_mesh_counters():
    """Both packages' mesh counter loggers (process-global, never reset by
    a cluster) at zero for the body, as a fresh process has them, and
    back to their values afterwards.  A twin's JAX side runs JAX code: a
    degraded-read fallback it counts would otherwise stay in the worker,
    where a later JAX case (``test_counter_coverage.py``'s canary:
    ``mesh_decode`` ``fallbacks == 0``) reads it."""
    from importlib import import_module
    saved = []
    for pkg in ("ceph_tpu", "ceph_tpu_torch"):
        mesh = import_module(pkg + ".mesh")
        for name in MESH_LOGGERS:
            pc = getattr(mesh, name)()
            saved.append((pc, {i: (c.value, c.sum, c.count)
                               for i, c in pc._by_idx.items()}))
    try:
        for pc, _ in saved:
            for c in pc._by_idx.values():
                c.value, c.sum, c.count = 0, 0.0, 0
        yield
    finally:
        for pc, values in saved:
            for i, (v, sm, n) in values.items():
                c = pc._by_idx[i]
                c.value, c.sum, c.count = v, sm, n


@pytest.fixture
def clean():
    """Reset before and after each test: a file that ran earlier in the
    same worker may have left options set or faults armed; the mesh
    counters start at zero and are left as they were found
    (``fresh_mesh_counters``)."""
    reset_both()
    with fresh_mesh_counters():
        yield
        reset_both()


@pytest.fixture
def one_thread():
    """torch on one intra-op thread, as each daemon of the process cluster
    runs it (``vstart._daemon_start``).  The mesh's CPU members then serve
    a flush in well under a millisecond even while other test workers
    load every core, so a member slowed by 30 ms stands out to the
    scoreboard as it does on the card; with torch's default pool a member
    waits on threads that other processes hold."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def set_both(name, value) -> None:
    g_conf.set_val(name, value)
    jax_conf.set_val(name, value)


def profile(pkg, k=4, m=2, **extra):
    return {**PLUGIN[pkg], "k": str(k), "m": str(m),
            "crush-failure-domain": "host", **extra}


def boot(pkg, n_osds=7, pool="ecpool", pg_num=16, n_mons=1, **prof):
    """The daemons of ``pkg`` with one EC pool; returns (daemons,
    client)."""
    d = chip_smoke.Daemons(pkg, n_osds, n_mons=n_mons)
    d.create_ec_pool(pool, profile(pkg, **prof), pg_num)
    return d, d.client()


def payloads(n, seed, base=20000, step=997):
    rng = np.random.default_rng(seed)
    return {f"obj{i}": rng.integers(0, 256, base + i * step,
                                    dtype=np.uint8).tobytes()
            for i in range(n)}


def store_state(d, with_meta=False):
    """Everything the OSDs store: (osd, collection, object) -> (body,
    attrs, omap).  The PG log lives in the PG meta objects' omap.  The
    OSD-map history collection ``meta`` holds the encoded incrementals,
    whose profiles name each package's plugin, and is left out unless
    asked for."""
    out = {}
    for i, osd in d.osds.items():
        st = osd.store
        for cid in st.list_collections():
            if cid == "meta" and not with_meta:
                continue
            for ho in st.list_objects(cid):
                out[(i, cid, ho.oid, ho.shard)] = (
                    bytes(st.read(cid, ho)), dict(st.getattrs(cid, ho)),
                    dict(st.omap_get(cid, ho)))
    return out


def assert_same_state(a, b):
    """Two ``store_state`` snapshots are equal, key by key."""
    assert a.keys() == b.keys()
    for key in a:
        body_a, attrs_a, omap_a = a[key]
        body_b, attrs_b, omap_b = b[key]
        assert body_a == body_b, key
        assert attrs_a == attrs_b, key
        assert omap_a == omap_b, key


def shard_holders(d, cl, pool, oid):
    """shard -> OSD id of ``oid``'s PG, from the client's map."""
    pgid, _primary = cl._calc_target(cl.lookup_pool(pool), oid)
    from importlib import import_module
    pg_t = import_module(d.pkg + ".osdmap").pg_t
    acting = d.mon.osdmap.pg_to_up_acting_osds(pg_t(*pgid))[2]
    return {s: int(o) for s, o in enumerate(acting)}


def size_attr(store, cid, ho, name):
    return struct.unpack("<Q", store.getattr(cid, ho, name))[0]
