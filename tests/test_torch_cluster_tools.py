"""The port's cluster tools (``rados``, ``ceph``, ``rados_bench``,
``psim``) against the JAX package's, on the CPU.

``rados`` and ``ceph`` act on a checkpoint directory
(``MiniCluster.checkpoint``); each package's tool runs on its own
package's checkpoint of the same cluster (8 OSDs, an EC pool of k=4, m=2
with 8 PGs, KiB objects; the port's pool with ``backend=host``), and their
outputs are equal verb by verb.  ``rados_bench`` runs one second on each
package (the counts are wall-clock; the lines' form and the exit code are
compared).  ``psim`` maps every PG of equal maps, each written as its own
package's pickle, and prints the same histogram.
"""
import contextlib
import io
import pickle
import re
import shutil

import pytest

from ceph_tpu.cluster import MiniCluster as JaxCluster
from ceph_tpu.osdmap.simple_build import build_simple as jax_build
from ceph_tpu.osdmap.simple_build import mark_up_in as jax_up
from ceph_tpu.tools import ceph_cli as jax_ceph
from ceph_tpu.tools import psim as jax_psim
from ceph_tpu.tools import rados as jax_rados
from ceph_tpu.tools import rados_bench as jax_bench

from ceph_tpu_torch.cluster import MiniCluster as PortCluster
from ceph_tpu_torch.osdmap.simple_build import build_simple
from ceph_tpu_torch.osdmap.simple_build import mark_up_in
from ceph_tpu_torch.tools import ceph_cli, psim, rados, rados_bench

from torch_daemon_twin import (JAX, PORT, clean, payloads,  # noqa: F401
                               reset_both)

TOOLS = {JAX: {"rados": jax_rados, "ceph": jax_ceph},
         PORT: {"rados": rados, "ceph": ceph_cli}}


def run(mod, argv, **kw):
    """(exit code, stdout text, stderr text); stdout has a byte buffer,
    as the tools write object bodies there."""
    raw, err = io.BytesIO(), io.StringIO()
    out = io.TextIOWrapper(raw, encoding="utf-8", errors="replace",
                           write_through=True)
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = mod.main(argv, **kw)
    out.flush()
    return rc, raw.getvalue().decode("utf-8", "replace"), err.getvalue()


@pytest.fixture(scope="module")
def pristine(tmp_path_factory):
    """pkg -> a checkpoint directory of that package's cluster, shared by
    the module's read-only cases (inspection verbs never write it)."""
    reset_both()
    tmp_path = tmp_path_factory.mktemp("checkpoints")
    objs = payloads(3, seed=1603, base=2000, step=1500)
    dirs = {}
    for pkg, cls, prof in ((JAX, JaxCluster, {"plugin": "tpu"}),
                           (PORT, PortCluster,
                            {"extra_profile": {"backend": "host"}})):
        c = cls(n_osds=8)
        c.create_ec_pool("ec", k=4, m=2, pg_num=8, **prof)
        c.create_replicated_pool("rep", size=3, pg_num=8)
        cl = c.client()
        for oid, body in objs.items():
            assert cl.write_full("ec", oid, body) == 0
        d = tmp_path / pkg
        c.checkpoint(str(d))
        dirs[pkg] = d
    reset_both()
    return dirs


@pytest.fixture
def checkpoints(clean, pristine):
    return pristine


@pytest.fixture
def writable(clean, pristine, tmp_path):
    """A copy of each checkpoint for the cases that write it back."""
    out = {}
    for pkg, d in pristine.items():
        out[pkg] = tmp_path / pkg
        shutil.copytree(d, out[pkg])
    return out


def both(checkpoints, tool, argv_of):
    got = {}
    for pkg, d in checkpoints.items():
        got[pkg] = run(TOOLS[pkg][tool],
                       ["--cluster", str(d)] + argv_of(pkg))
    return got[PORT], got[JAX]


@pytest.mark.parametrize("verb", [
    ["df"], ["ls", "ec"], ["stat", "ec", "obj1"], ["lssnap", "rep"],
    ["listxattr", "ec", "obj0"], ["get", "ec", "nosuch", "x"]],
    ids=lambda v: "_".join(v[:2]))
def test_rados_read_verbs_equal(checkpoints, verb):
    p, j = both(checkpoints, "rados", lambda pkg: list(verb))
    assert p == j


def test_rados_mutations_equal(writable, tmp_path):
    src = tmp_path / "in.bin"
    src.write_bytes(bytes(range(256)) * 37)
    steps = [["put", "ec", "new", str(src)],
             ["setxattr", "ec", "new", "color", "blue"],
             ["getxattr", "ec", "new", "color"],
             ["mksnap", "rep", "s1"], ["lssnap", "rep"],
             ["ls", "ec"], ["rm", "ec", "obj2"], ["ls", "ec"], ["df"]]
    for step in steps:
        p, j = both(writable, "rados", lambda pkg: list(step))
        assert p[0] == 0, (step, p)
        assert p == j, step
    outs = {}
    for pkg, d in writable.items():
        dst = tmp_path / f"out-{pkg}.bin"
        assert run(TOOLS[pkg]["rados"], ["--cluster", str(d), "get", "ec",
                                         "new", str(dst)])[0] == 0
        outs[pkg] = dst.read_bytes()
    assert outs[PORT] == outs[JAX] == src.read_bytes()


@pytest.mark.parametrize("verb", [
    ["status"], ["health"], ["df"], ["osd", "tree"], ["osd", "df"],
    ["osd", "pool", "ls"], ["osd", "pool", "ls", "detail"],
    ["pg", "stat"], ["pg", "dump"], ["pg", "1.3", "query"],
    ["log", "last", "5"], ["config-key", "dump"], ["mon", "dump"],
    ["pg", "deep-scrub"]], ids=lambda v: "_".join(v))
def test_ceph_verbs_equal(checkpoints, verb):
    p, j = both(checkpoints, "ceph", lambda pkg: list(verb))
    if verb == ["mon", "dump"]:
        # the monmap's created / last_changed stamps are each cluster's
        # own wall clock
        stamp = re.compile(r"\d{4}-\d\d-\d\d \d\d:\d\d:[\d.]+")
        p, j = [(r[0], stamp.sub("<stamp>", r[1]), r[2]) for r in (p, j)]
        assert "<stamp>" in p[1]
    assert p == j
    assert p[0] == 0


def test_ceph_admin_verbs_equal(writable):
    steps = [["osd", "out", "3"], ["osd", "out", "3"],
             ["osd", "pool", "set", "rep", "size", "2"],
             ["osd", "pool", "create", "more", "4", "replicated"],
             ["osd", "pool", "rm", "more", "more",
              "--yes-i-really-really-mean-it"],
             ["osd", "pool", "ls", "detail"],
             ["tell", "osd.0", "injectargs", "--debug_osd", "7"]]
    for step in steps:
        p, j = both(writable, "ceph", lambda pkg: list(step))
        assert p == j, step
        assert p[0] == 0, step


def test_rados_bench_runs_on_both(clean):
    forms = [r"write: (\d+) objects x 4096 B in [\d.]+s = [\d.]+ MB/s",
             r"seq read: (\d+) objects in [\d.]+s = [\d.]+ MB/s"]
    argv = ["1", "--osds", "7", "-k", "4", "-m", "2", "--object-size",
            "4096", "--pg-num", "8"]
    for mod, kw in ((jax_bench, {}), (rados_bench, {"device": "cpu"})):
        rc, out, _ = run(mod, argv, **kw)
        lines = out.splitlines()
        assert rc == 0 and len(lines) == 2
        counts = [int(re.fullmatch(f, ln).group(1))
                  for f, ln in zip(forms, lines)]
        assert counts[0] == counts[1] > 0
    rc, out, _ = run(rados_bench, argv[:1] + ["--pool-type", "replicated",
                                               "--object-size", "4096"],
                     device="cpu")
    assert rc == 0 and out.startswith("write: ")


def test_rados_bench_needs_the_card_by_default(clean):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    with pytest.raises(RuntimeError, match="cuda"):
        run(rados_bench, ["1", "--object-size", "4096"])


def test_psim_histogram_equal(tmp_path):
    """Each package's map (16 OSDs, a pool of 16 PGs, all up and in)
    pickled by that package; the port reads it through
    ``osdmaptool.load_map`` and maps on the plain versions, the JAX tool
    on its CPU platform.  Both with ``--host-mapper`` too."""
    maps = {}
    for pkg, build, up in ((JAX, jax_build, jax_up),
                           (PORT, build_simple, mark_up_in)):
        m = build(16, pg_bits=0, pgp_bits=0)
        up(m)
        fn = tmp_path / f"om-{pkg}"
        fn.write_bytes(pickle.dumps(m))
        maps[pkg] = str(fn)
    for extra in ([], ["--host-mapper"]):
        j = run(jax_psim, [maps[JAX], "--objects", "400"] + extra)
        p = run(psim, [maps[PORT], "--objects", "400"] + extra,
                device="cpu")
        assert p == j
        assert p[0] == 0 and len(p[1].splitlines()) == 17


def test_psim_refuses_a_bare_pickle(tmp_path):
    """The port's psim reads only this package's map classes."""
    fn = tmp_path / "evil"
    fn.write_bytes(pickle.dumps({"not": "a map"}))
    with pytest.raises(pickle.UnpicklingError):
        run(psim, [str(fn)], device="cpu")
