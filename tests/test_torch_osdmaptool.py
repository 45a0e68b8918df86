"""The port's osdmaptool against the JAX package's, on the CPU.

Each package's ``main(argv)`` runs the same argv in its own directory
(relative file names, so the printed names agree) and writes its own map
pickles: a map written by one package's tool names that package's
classes, so neither tool reads the other's maps.  The port's tool runs
with ``device="cpu"``; its ``--test-map-pgs`` maps through
``OSDMapMapping`` on the plain versions of the card's kernels, while the
JAX side adds ``--host-mapper`` (its host ``crush_do_rule``: the same
rows, without compiling its XLA mapper here).

Compared: exit codes, stdout and stderr, equal except the trailing
``mapped N pgs in T ms (backend: ...)`` line of ``--test-map-pgs``
(a wall time and a backend name); the clock is pinned
(``time.time``, which ``build_simple`` / ``build_from_conf`` stamp into
``created`` / ``modified``, so ``--print`` compares whole).  Upmap
command files and exported crush maps are compared byte for byte.
``--upmap-save`` exists in the port only (the JAX tool refuses the
flag): its saved map is checked against the upmap file it wrote and
against the scalar ``pg_to_up_acting_osds``.
"""
import pickle
import re
import time

import numpy as np
import pytest

from ceph_tpu.osdmap import pg_t as jpg_t
from ceph_tpu.tools import osdmaptool as josdmaptool
from ceph_tpu_torch.osdmap import pg_t
from ceph_tpu_torch.tools import osdmaptool as tosdmaptool

from test_torch_upmap import rack_conf

CLOCK = 1750000000.25
MAPPED = re.compile(r"^mapped \d+ pgs in [0-9.]+ ms \(backend: [a-z,]+\)$")


@pytest.fixture
def tools(tmp_path, monkeypatch, capsys):
    """run(argv) -> ((rc, out, err) of JAX, (rc, out, err) of the port)."""
    monkeypatch.setattr(time, "time", lambda: CLOCK)
    dirs = {"jax": tmp_path / "jax", "torch": tmp_path / "torch"}
    for d in dirs.values():
        d.mkdir()
        (d / "racks.conf").write_text(rack_conf())

    def one(pkg, argv):
        monkeypatch.chdir(dirs[pkg])
        if pkg == "jax":
            if "--test-map-pgs" in argv and "--host-mapper" not in argv:
                argv = argv + ["--host-mapper"]
            rc = josdmaptool.main(argv)
        else:
            rc = tosdmaptool.main(argv, device="cpu")
        out, err = capsys.readouterr()
        return rc, out, err

    def run(argv, check=True):
        j, t = one("jax", list(argv)), one("torch", list(argv))
        if check:
            assert t == j, argv
        return j, t

    run.dirs = dirs
    run.one = one
    return run


def _strip_mapped(out):
    lines = out.splitlines()
    assert MAPPED.match(lines[-1]), lines[-1]
    return lines[:-1], lines[-1]


def test_createsimple_and_print(tools):
    tools(["--createsimple", "16", "om", "--with-default-pool",
           "--pg_bits", "4"])
    j, _ = tools(["om", "--print"])
    assert "created 20" in j[1] and "pool 1 'rbd' replicated" in j[1]
    tools(["--createsimple", "16", "om"])                 # exists
    tools(["--createsimple", "0", "om2"])                  # count > 0
    tools(["--createsimple", "12", "om3", "--pg-num", "64"])  # legacy
    tools(["om3", "--tree", "plain"])
    tools(["om3", "--tree", "json"])
    tools([])
    tools(["missing"])
    tools(["om", "--bogus"])
    tools(["om", "--upmap-max", "x"])
    tools(["om"])


def test_create_from_conf_tree_and_maps(tools):
    tools(["--create-from-conf", "om", "-c", "racks.conf",
           "--with-default-pool", "--pg_bits", "3"])
    tools(["om", "--print"])
    tools(["om", "--tree", "plain"])
    tools(["om", "--mark-up-in", "--tree", "json-pretty"])
    tools(["om", "--mark-up-in", "--test-map-pg", "1.1a"])
    tools(["om", "--mark-up-in", "--test-map-pg", "1.zz"])
    tools(["om", "--mark-up-in", "--test-map-object", "foo", "--pool",
           "1"])
    tools(["om", "--mark-up-in", "--test-map-object", "bar"])
    tools(["om", "--test-map-object", "bar", "--pool", "9"])


@pytest.mark.parametrize("extra", [[], ["--mark-out", "5"],
                                   ["--host-mapper"]],
                         ids=["all-in", "mark-out", "host-mapper"])
def test_test_map_pgs(tools, extra):
    tools(["--create-from-conf", "om", "-c", "racks.conf",
           "--with-default-pool", "--pg_bits", "3"])
    j, t = tools(["om", "--mark-up-in", "--test-map-pgs"] + extra,
                 check=False)
    assert t[0] == j[0] == 0 and t[2] == j[2]
    jl, _ = _strip_mapped(j[1])
    tl, tlast = _strip_mapped(t[1])
    assert tl == jl
    assert "pool 1 pg_num 384" in jl
    want = "host" if extra == ["--host-mapper"] else "cpu"
    assert tlast.endswith(f"(backend: {want})")
    # --pool restricts the sweep to one pool; a missing pool is refused
    j, t = tools(["om", "--mark-up-in", "--test-map-pgs", "--pool", "1"]
                 + extra, check=False)
    assert _strip_mapped(t[1])[0] == _strip_mapped(j[1])[0]
    tools(["om", "--test-map-pgs", "--pool", "4"] + extra)


@pytest.mark.parametrize("mark_out,dev,umax", [
    (None, ".01", "100"), ("7", ".01", "100"), ("7", ".05", "9")])
def test_upmap(tools, mark_out, dev, umax):
    tools(["--create-from-conf", "om", "-c", "racks.conf",
           "--with-default-pool", "--pg_bits", "3"])
    argv = ["om", "--mark-up-in"]
    if mark_out:
        argv += ["--mark-out", mark_out]
    argv += ["--upmap", "up.txt", "--upmap-max", umax,
             "--upmap-deviation", dev]
    tools(argv)
    jtext = (tools.dirs["jax"] / "up.txt").read_bytes()
    assert (tools.dirs["torch"] / "up.txt").read_bytes() == jtext
    assert jtext.count(b"pg-upmap-items") > 0
    # '-' writes the commands to stdout
    tools(argv[:-5] + ["--upmap", "-", "--upmap-max", umax,
                       "--upmap-deviation", dev])


def test_upmap_save_port(tools):
    """--upmap-save writes the map with the items of the upmap file; its
    rows then equal the scalar pipeline's with those items applied."""
    tools(["--create-from-conf", "om", "-c", "racks.conf",
           "--with-default-pool", "--pg_bits", "3"])
    j = tools.one("jax", ["om", "--upmap-save"])
    assert j[0] == 1 and "unrecognized arg --upmap-save" in j[2]
    rc, out, _ = tools.one("torch", [
        "om", "--mark-up-in", "--mark-out", "7", "--upmap", "up.txt",
        "--upmap-max", "30", "--upmap-deviation", ".01", "--upmap-save"])
    assert rc == 0 and "osdmaptool: writing epoch 3 to om" in out
    d = tools.dirs["torch"]
    cmds = (d / "up.txt").read_text().splitlines()
    m = tosdmaptool.load_map((d / "om").read_bytes())
    want = {}
    for line in cmds:
        f = line.split()
        pool, ps = f[3].split(".")
        pairs = list(map(int, f[4:]))
        want[(int(pool), int(ps, 16))] = list(zip(pairs[::2], pairs[1::2]))
    assert len(want) == 30
    assert {(pg.pool, pg.ps): [tuple(p) for p in v]
            for pg, v in m.pg_upmap_items.items()} == want
    rc, out, _ = tools.one("torch", ["om", "--print"])
    assert out.count("pg_upmap_items ") == 30
    from ceph_tpu_torch.osdmap import OSDMapMapping
    mm = OSDMapMapping(device="cpu")
    mm.update(m)
    for ps in range(m.pools[1].pg_num):
        assert mm.get(pg_t(1, ps)) == tuple(m.pg_to_up_acting_osds(
            pg_t(1, ps)))


def test_export_import_crush_and_clear_temp(tools):
    tools(["--create-from-conf", "om", "-c", "racks.conf",
           "--with-default-pool", "--pg_bits", "3"])
    tools(["--createsimple", "64", "big", "--with-default-pool"])
    tools(["om", "--export-crush", "crush.bin"])
    jbin = (tools.dirs["jax"] / "crush.bin").read_bytes()
    assert (tools.dirs["torch"] / "crush.bin").read_bytes() == jbin
    tools(["big", "--import-crush", "crush.bin"])
    tools(["big", "--print", "--tree", "plain"])
    tools(["big", "--import-crush", "nothere.bin"])
    tools(["--createsimple", "8", "small"])
    tools(["small", "--import-crush", "crush.bin"])     # too many osds
    # a pg_temp entry, written into each package's own pickle
    for pkg, d in tools.dirs.items():
        path = d / "om"
        if pkg == "jax":
            m, key = pickle.loads(path.read_bytes()), jpg_t(1, 0x1a)
        else:
            m, key = tosdmaptool.load_map(path.read_bytes()), pg_t(1, 0x1a)
        m.pg_temp[key] = [3, 2, 1]
        m.primary_temp[key] = 2
        path.write_bytes(pickle.dumps(m))
    j, _ = tools(["om", "--mark-up-in", "--test-map-pg", "1.1a"])
    assert "acting ([3,2,1], p2)" in j[1]
    j, _ = tools(["om", "--mark-up-in", "--clear-temp", "--test-map-pg",
                  "1.1a"])
    assert "clearing pg/primary temp" in j[1]
    assert "acting ([3,2,1]" not in j[1]


def test_port_refuses_a_jax_map(tools):
    tools(["--createsimple", "4", "om"])
    jmap = (tools.dirs["jax"] / "om").read_bytes()
    (tools.dirs["torch"] / "jaxmap").write_bytes(jmap)
    rc, out, err = tools.one("torch", ["jaxmap", "--print"])
    assert rc == 255
    assert "error decoding osdmap 'jaxmap'" in err
    with pytest.raises(pickle.UnpicklingError):
        tosdmaptool.load_map(jmap)
    with pytest.raises(pickle.UnpicklingError):
        tosdmaptool.load_map(pickle.dumps(np.arange(3).tolist()))


def test_default_device_is_the_card(tools):
    """Without a card the default ``device="cuda"`` raises; it does not
    map on the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    tools.one("torch", ["--createsimple", "4", "om", "--with-default-pool"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tosdmaptool.main(["om", "--test-map-pgs"])
