"""The port's offline tools (``authtool``, ``monmaptool``, ``ceph_conf``,
``kvstore_tool``, ``monstore_tool``, ``objectstore_tool``,
``rebuild_mondb``) against the JAX package's, on the CPU.

Each case is a transcript: a list of argv lines run in order through one
package's tool, in a directory of that package's own, with the same
entropy (``os.urandom`` a seeded stream, ``uuid.uuid4`` and
``time.time`` pinned).  Both transcripts must give the same exit codes,
standard output and standard error line by line, and leave the same
files.  The store tools act on each package's checkpoint
(``MiniCluster.checkpoint``) of the same cluster; a written OSD map is a
pickle of its own package's classes, so it is compared by its decoded
form.  The cases cover ``test_monmaptool_golden.py``,
``test_ceph_conf_cram.py``, ``test_monstore_tool.py``,
``test_rebuild_mondb.py``, ``test_tools.py::test_objectstore_tool_surgery``
and ``test_tool_compress_scrub.py``'s objectstore-tool cases.
"""
import contextlib
import io
import json
import os
import pickle
import re
import shutil
import time
import uuid
from pathlib import Path

import numpy as np
import pytest

from ceph_tpu.cluster import MiniCluster as JaxCluster
from ceph_tpu.osdmap.encoding import osdmap_to_dict as jax_to_dict
from ceph_tpu.tools import authtool as j_authtool
from ceph_tpu.tools import ceph_conf as j_ceph_conf
from ceph_tpu.tools import kvstore_tool as j_kvstore_tool
from ceph_tpu.tools import monmaptool as j_monmaptool
from ceph_tpu.tools import monstore_tool as j_monstore_tool
from ceph_tpu.tools import objectstore_tool as j_objectstore_tool
from ceph_tpu.tools import rebuild_mondb as j_rebuild_mondb

from ceph_tpu_torch.cluster import MiniCluster as PortCluster
from ceph_tpu_torch.osdmap.encoding import osdmap_to_dict
from ceph_tpu_torch.tools import (authtool, ceph_conf, kvstore_tool,
                                  monmaptool, monstore_tool,
                                  objectstore_tool, rebuild_mondb)

from torch_daemon_twin import JAX, PORT, reset_both

NOW = 1_700_000_000.25
TOOLS = {
    "authtool": {JAX: j_authtool, PORT: authtool},
    "monmaptool": {JAX: j_monmaptool, PORT: monmaptool},
    "ceph_conf": {JAX: j_ceph_conf, PORT: ceph_conf},
    "kvstore_tool": {JAX: j_kvstore_tool, PORT: kvstore_tool},
    "monstore_tool": {JAX: j_monstore_tool, PORT: monstore_tool},
    "objectstore_tool": {JAX: j_objectstore_tool, PORT: objectstore_tool},
    "rebuild_mondb": {JAX: j_rebuild_mondb, PORT: rebuild_mondb},
}
STAMP = re.compile(r"^\d{4}-\d\d-\d\d \d\d:\d\d:\d\d\.\d{6} ", re.M)


class Entropy:
    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def __call__(self, n):
        return self.rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def run(mod, argv):
    """(exit code, stdout text, stderr text) of one tool call."""
    raw, err = io.BytesIO(), io.StringIO()
    out = io.TextIOWrapper(raw, encoding="utf-8", errors="replace",
                           write_through=True)
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = mod.main(list(argv))
        except SystemExit as e:
            rc = e.code
    out.flush()
    return rc, raw.getvalue().decode("utf-8", "replace"), \
        STAMP.sub("<stamp> ", err.getvalue())


def files(root):
    """relative path -> bytes of every file under ``root``."""
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(Path(root).rglob("*")) if p.is_file()}


def transcript(tool, steps, tmp_path, monkeypatch, seed=5, setup=None,
               skip_files=(), norm=lambda text: text):
    """Run ``steps`` (argv lists) through each package's ``tool`` in
    ``tmp_path/<pkg>`` (``setup(pkg, dir)`` fills it first); returns
    (port results, jax results) and asserts the files left are equal
    (but ``skip_files``) and the outputs too (after ``norm``)."""
    got, left = {}, {}
    for pkg in (JAX, PORT):
        d = tmp_path / pkg
        d.mkdir()
        if setup is not None:
            setup(pkg, d)
        monkeypatch.chdir(d)
        ent = Entropy(seed)
        ids = iter(range(1, 1000))
        monkeypatch.setattr(os, "urandom", ent)
        monkeypatch.setattr(time, "time", lambda: NOW)
        monkeypatch.setattr(uuid, "uuid4",
                            lambda: uuid.UUID(int=next(ids) * 7919))
        got[pkg] = [tuple(norm(x) if isinstance(x, str) else x
                          for x in run(TOOLS[tool][pkg], step))
                    for step in steps]
        left[pkg] = {k: v for k, v in files(d).items()
                     if k not in skip_files}
    assert left[PORT] == left[JAX]
    for step, p, j in zip(steps, got[PORT], got[JAX]):
        assert p == j, step
    return got[PORT], got[JAX]


# ---- monmaptool --------------------------------------------------------

MONMAP_STEPS = [
    ["--create", "--fsid", "9b1f3c2e-7d4a-4f5b-8c6d-1e2f3a4b5c6d",
     "--add", "a", "10.0.0.1:6789", "--add", "b", "10.0.0.2", "mm"],
    ["--print", "mm"],
    ["--add", "a", "10.0.0.3:6789", "mm"],
    ["--rm", "b", "--print", "mm"],
    ["--rm", "nosuch", "mm"],
    ["--feature-set", "kraken", "--feature-set", "luminous",
     "--optional", "--feature-list", "mm"],
    ["--feature-unset", "kraken", "--feature-list", "parseable", "mm"],
    ["--feature-set", "bogus", "mm"],
    ["--create", "mm"],
    ["--create", "--clobber", "mm2"],
    ["--create", "--fsid", "not-a-uuid", "mm3"],
    ["--print", "missing"],
    ["--help"],
    [],
    ["--add", "c"],
]


def test_monmaptool_transcript(tmp_path, monkeypatch):
    p, _j = transcript("monmaptool", MONMAP_STEPS, tmp_path, monkeypatch)
    assert [r[0] for r in p] == [0, 0, 1, 0, 1, 0, 0, 1, 255, 0, 255,
                                 255, 1, 1, 1]
    assert "monmaptool: writing epoch" in p[0][1]


def test_monmaptool_reads_the_other_packages_map(tmp_path, monkeypatch):
    """A monmap written by either package prints the same in both."""
    monkeypatch.setattr(time, "time", lambda: NOW)
    path = str(tmp_path / "mm")
    assert run(j_monmaptool, ["--create", "--fsid",
                              "9b1f3c2e-7d4a-4f5b-8c6d-1e2f3a4b5c6d",
                              "--add", "a", "10.0.0.1", path])[0] == 0
    assert run(monmaptool, ["--print", path]) == \
        run(j_monmaptool, ["--print", path])


# ---- authtool ----------------------------------------------------------

def _caps_file(pkg, d):
    (d / "caps").write_text('mon = "allow *"\nosd = "allow rw"\n')
    (d / "bad.keyring").write_text("[client.bad]\n\tkey = @@@\n")


AUTH_STEPS = [
    ["kr", "-C", "-g", "-n", "client.admin"],
    ["kr", "-g", "-n", "osd.0", "--cap", "osd", "allow *",
     "--cap", "mon", "allow profile osd"],
    ["kr", "-l"],
    ["kr", "-p", "-n", "osd.0"],
    ["kr", "-p", "-n", "client.nosuch"],
    ["kr", "-n", "client.admin", "--caps", "caps"],
    ["kr", "-n", "client.admin", "--cap", "mds", "allow"],
    ["kr", "-n", "client.x", "-a", "AQBm2fFlAAAAABAAQnw4b4kcAcAJYlVkxSaH6w=="],
    ["kr", "-n", "client.y", "-a", "not*base64"],
    ["kr", "-n", "client.x", "-u", "42"],
    ["kr2", "-C", "--import-keyring", "kr"],
    ["kr2", "-l"],
    ["--gen-print-key"],
    ["missing.keyring", "-l"],
    ["kr", "--cap", "osd"],
    ["bad.keyring", "-l"],
    [],
]


def test_authtool_transcript(tmp_path, monkeypatch):
    p, _j = transcript("authtool", AUTH_STEPS, tmp_path, monkeypatch,
                       setup=_caps_file)
    assert p[0][0] == 0 and p[2][0] == 0
    assert "[osd.0]" in p[2][1]


def test_authtool_keyring_loads_in_cephx(tmp_path, monkeypatch):
    """The tool's keyring feeds either package's ``Keyring.load``."""
    import ceph_tpu.auth as jauth
    import ceph_tpu_torch.auth as pauth
    path = str(tmp_path / "kr")
    assert run(authtool, [path, "-C", "-g", "-n", "osd.3"])[0] == 0
    assert pauth.Keyring.load(path).keys == jauth.Keyring.load(path).keys


# ---- ceph_conf ---------------------------------------------------------

CONF = """[global]
    fsid = 11111111-2222-3333-4444-555555555555
    log file = /var/log/ceph/$cluster-$name.log
    loop = $loop2
    loop2 = $loop
[osd]
    osd data = /var/lib/ceph/osd/$cluster-$id
    osd heartbeat grace = 33
[osd.0]
    host = node0
[mon.a]
    mon addr = 10.0.0.1:6789
"""


def _conf_file(pkg, d):
    (d / "ceph.conf").write_text(CONF)


CONF_STEPS = [
    ["-c", "ceph.conf", "--lookup", "fsid"],
    ["-c", "ceph.conf", "-n", "osd.0", "host"],
    ["-c", "ceph.conf", "-n", "osd.1", "host"],
    ["-c", "ceph.conf", "-n", "osd.0", "osd data"],
    ["-c", "ceph.conf", "-n", "osd.0", "log file"],
    ["-c", "ceph.conf", "loop"],
    ["-c", "ceph.conf", "-s", "mon.a", "-s", "global", "mon addr"],
    ["-c", "ceph.conf", "-L"],
    ["-c", "ceph.conf", "-l", "osd"],
    ["-c", "ceph.conf", "-n", "osd.0", "-r", "--lookup", "host"],
    ["-c", "ceph.conf", "-n", "osd.0", "--show-config-value",
     "osd_heartbeat_grace"],
    ["-c", "ceph.conf", "--show-config-value", "no_such_option"],
    ["-c", "ceph.conf", "--filter-key", "host"],
    ["-c", "ceph.conf", "--filter-key-value", "host=node0"],
    ["-n", "osd.0", "-D", "-c", "/dev/null"],
    ["-n", "osd.0", "-D", "--format", "json", "-c", "/dev/null"],
    ["-n", "osd.0", "-D", "--format", "json-pretty", "-c", "/dev/null"],
    ["-n", "osd.0", "-D", "--format", "xml", "-c", "/dev/null"],
    ["-D", "--format", "table-kv", "-c", "/dev/null"],
    ["-D", "--format", "yaml", "-c", "/dev/null"],
    ["-n", "bogus", "fsid"],
    ["-c", "missing.conf", "fsid"],
    ["-c", "ceph.conf"],
    ["-c"],
    ["--help"],
]


def test_ceph_conf_transcript(tmp_path, monkeypatch):
    monkeypatch.delenv("CEPH_CONF", raising=False)
    monkeypatch.delenv("CEPH_ARGS", raising=False)
    p, _j = transcript("ceph_conf", CONF_STEPS, tmp_path, monkeypatch,
                       setup=_conf_file)
    assert p[0] == (0, "11111111-2222-3333-4444-555555555555\n", "")
    assert p[2][0] == 1


def test_ceph_conf_environment(tmp_path, monkeypatch):
    """CEPH_CONF (a search list that degrades to defaults) and CEPH_ARGS
    (tokens prepended to argv)."""
    monkeypatch.setenv("CEPH_CONF", "missing.conf,ceph.conf")
    monkeypatch.setenv("CEPH_ARGS", "-n osd.0")
    transcript("ceph_conf", [["host"], ["osd data"]], tmp_path,
               monkeypatch, setup=_conf_file)
    monkeypatch.setenv("CEPH_CONF", "missing.conf")
    monkeypatch.delenv("CEPH_ARGS")
    (tmp_path / "again").mkdir()
    p, _j = transcript("ceph_conf", [["fsid"]], tmp_path / "again",
                       monkeypatch)
    assert "<stamp> " in p[0][2]


# ---- kvstore_tool ------------------------------------------------------

def _blob(pkg, d):
    (d / "blob").write_bytes(b"hello kv")


KV_STEPS = [
    ["bluestore-kv", "db", "set", "p", "k", "in", "blob"],
    ["bluestore-kv", "db", "set", "p", "ver", "ver", "7"],
    ["bluestore-kv", "db", "list"],
    ["bluestore-kv", "db", "list", "p"],
    ["bluestore-kv", "db", "exists", "p", "k"],
    ["bluestore-kv", "db", "exists", "p"],
    ["bluestore-kv", "db", "exists", "q", "k"],
    ["bluestore-kv", "db", "get", "p", "k", "out", "back"],
    ["bluestore-kv", "db", "get", "p", "ver"],
    ["bluestore-kv", "db", "crc", "p", "k"],
    ["bluestore-kv", "db", "list-crc"],
    ["bluestore-kv", "db", "store-copy", "copy"],
    ["bluestore-kv", "db", "rm", "p", "k"],
    ["bluestore-kv", "db", "exists", "p", "k"],
    ["bluestore-kv", "copy", "exists", "p", "k"],
    ["bluestore-kv", "db", "set", "pre/fix", "k y%", "in", "blob"],
    ["bluestore-kv", "db", "get", "pre/fix", "k y%"],
    ["bluestore-kv", "db", "rm-prefix", "pre/fix"],
    ["bluestore-kv", "db", "list"],
    ["bluestore-kv", "db", "stats"],
    ["bluestore-kv", "db", "compact"],
    ["bluestore-kv", "db", "repair"],
    ["bluestore-kv", "db", "destructive-repair"],
    ["leveldb", "nosuch", "list"],
    ["wat", "db", "list"],
    ["bluestore-kv", "db"],
    ["bluestore-kv", "db", "get", "p"],
]


def test_kvstore_tool_transcript(tmp_path, monkeypatch):
    p, _j = transcript("kvstore_tool", KV_STEPS, tmp_path, monkeypatch,
                       setup=_blob)
    assert p[2] == (0, "p\tk\np\tver\n", "")
    assert p[4][1] == "(p, k) exists\n"


# ---- the store tools, on each package's checkpoint ---------------------

def _cluster(pkg):
    """4 OSDs, replicated pools p1 and p2 (p2 after osd.2 is out), an
    isa k=2 m=1 pool (``backend=host`` in both packages, so the profiles
    and the maps that carry them are equal) with an object carrying an
    xattr."""
    c = (JaxCluster if pkg == JAX else PortCluster)(n_osds=4)
    c.create_ec_pool("os", k=2, m=1, plugin="isa", pg_num=4,
                     extra_profile={"backend": "host"})
    c.create_replicated_pool("p1", pg_num=8)
    cl = c.client("client.t")
    assert cl.write_full("p1", "obj", b"survives the mon-store loss") == 0
    assert cl.write_full("os", "alpha", b"alpha-bytes" * 100) == 0
    assert cl.setxattr("os", "alpha", "k", b"v") == 0
    c.mark_osd_out(2)
    c.create_replicated_pool("p2", pg_num=8)
    return c


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """pkg -> a pristine checkpoint directory of that package."""
    reset_both()
    root = tmp_path_factory.mktemp("offline_ck")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(time, "time", lambda: NOW)
        for pkg in (JAX, PORT):
            out[pkg] = root / pkg
            _cluster(pkg).checkpoint(str(out[pkg]))
    reset_both()
    return out


def _copy_checkpoint(checkpoints):
    def setup(pkg, d):
        shutil.copytree(checkpoints[pkg], d / "ck")
    return setup


def test_checkpoints_are_byte_equal(checkpoints):
    """The two checkpoints are the same cluster, file for file: the mon
    store, every OSD store and the cluster's layout."""
    j, p = files(checkpoints[JAX]), files(checkpoints[PORT])
    assert sorted(j) == sorted(p) and "osd.3.store" in p
    assert p == j


MONSTORE_STEPS = [
    ["ck", "show-versions"],
    ["ck", "dump-keys"],
    ["ck", "get", "monmap", "-o", "monmap.bin"],
    ["ck", "get", "crushmap", "-o", "crush.bin"],
    ["ck", "get", "osdmap", "-o", "osd.map"],
    ["ck", "get", "osdmap", "--version", "1", "-o", "osd1.map"],
    ["ck", "get", "osdmap", "--version", "9999"],
    ["ck", "get", "wat"],
    ["ck", "rewrite-crush"],
    ["ck", "rewrite-crush", "--crush", "crush.bin"],
    ["ck", "show-versions"],
    ["nope", "show-versions"],
    [],
    ["--help"],
]


def _pickle_size(text):
    """An OSD map file is a pickle of its package's classes: its size
    differs by the module names, its decoded form must not."""
    return re.sub(r"(wrote osdmap epoch \d+) \(\d+ bytes\)",
                  r"\1 (<n> bytes)", text)


def _osdmap_dict(pkg, raw):
    m = pickle.loads(raw)
    return (jax_to_dict if pkg == JAX else osdmap_to_dict)(m)


def test_monstore_tool_transcript(checkpoints, tmp_path, monkeypatch):
    p, _j = transcript("monstore_tool", MONSTORE_STEPS, tmp_path,
                       monkeypatch, setup=_copy_checkpoint(checkpoints),
                       skip_files=("osd.map", "osd1.map"),
                       norm=_pickle_size)
    assert [r[0] for r in p[:6]] == [0] * 6
    assert "epoch" in p[9][1]
    for name in ("osd.map", "osd1.map"):
        assert _osdmap_dict(PORT, (tmp_path / PORT / name).read_bytes()) \
            == _osdmap_dict(JAX, (tmp_path / JAX / name).read_bytes())


REBUILD_STEPS = [
    ["ck"],
    ["ck", "--force"],
    ["ck", "--mon", "alpha=127.0.0.1:6800", "--force"],
    ["empty"],
    [],
    ["ck", "--bogus"],
]


def test_rebuild_mondb_transcript(checkpoints, tmp_path, monkeypatch):
    def setup(pkg, d):
        _copy_checkpoint(checkpoints)(pkg, d)
        os.unlink(d / "ck" / "mon.json")
    steps = [["ck"]] + REBUILD_STEPS
    p, _j = transcript("rebuild_mondb", steps, tmp_path, monkeypatch,
                       setup=setup)
    assert [r[0] for r in p] == [0, 1, 0, 0, 1, 1, 1]


def _first_object(pkg, store):
    """The first record ``--op list`` prints."""
    _rc, out, _ = run(TOOLS["objectstore_tool"][pkg],
                      ["--data-path", store, "--op", "list"])
    return json.loads(out.splitlines()[0])


def _empty_store(pkg):
    if pkg == JAX:
        from ceph_tpu.os_store import MemStore as M
    else:
        from ceph_tpu_torch.os_store import MemStore as M
    return M()


def test_objectstore_tool_transcript(checkpoints, tmp_path, monkeypatch):
    """Read and write surgery on osd.0's store: list, info, list-pgs,
    get-bytes, attrs and omap, set-bytes, remove, export and import into
    an empty store."""
    store = "ck/osd.0.store"
    rec = _first_object(PORT, str(checkpoints[PORT] / "osd.0.store"))
    assert rec == _first_object(JAX, str(checkpoints[JAX] / "osd.0.store"))
    sel = ["--cid", rec["cid"], "--oid", rec["oid"],
           "--shard", str(rec["shard"])]

    def setup(pkg, d):
        _copy_checkpoint(checkpoints)(pkg, d)
        (d / "blob").write_bytes(b"surgically replaced")
        _empty_store(pkg).save(str(d / "empty.store"))

    def op(*args):
        return ["--data-path", store, "--op", *args]

    steps = [
        op("list"), op("info"), op("list-pgs"),
        op("get-bytes", *sel, "--out", "bytes.bin"),
        op("list-attrs", *sel), op("get-omap", *sel),
        op("set-bytes", *sel, "--in", "blob"),
        op("get-bytes", *sel, "--out", "back.bin"),
        op("set-attr", *sel, "--key", "_t", "--value", "zz"),
        op("set-attr", *sel, "--key", "_t", "--value", b"hello".hex()),
        op("get-attr", *sel, "--key", "_t"),
        op("rm-attr", *sel, "--key", "_t"),
        op("get-attr", *sel, "--key", "_t"),
        op("set-omap", *sel, "--key", "ok", "--value", b"ov".hex()),
        op("get-omap", *sel),
        op("rm-omap", *sel, "--key", "ok"),
        op("export", "--cid", rec["cid"], "--out", "coll.export"),
        ["--data-path", "empty.store", "--op", "import", "--in",
         "coll.export"],
        ["--data-path", "empty.store", "--op", "list"],
        op("remove", *sel),
        op("get-bytes", *sel),
        op("get-bytes", "--cid", rec["cid"]),
        op("export", "--cid", rec["cid"]),
        op("bogus"),
    ]
    p, _j = transcript("objectstore_tool", steps, tmp_path, monkeypatch,
                       setup=setup)
    assert [r[0] for r in p[:8]] == [0] * 8
    assert (tmp_path / PORT / "back.bin").read_bytes() == \
        b"surgically replaced"
    assert bytes.fromhex(p[10][1].strip()) == b"hello"
    assert p[17][0] == 0 and rec["cid"] in p[18][1]
    assert p[20][0] == 1
