"""The port's rbd tools (``rbd_optfmt``, ``rbd_specs``, ``rbd_shell``,
``rbd_cli``) against the JAX package's, on the CPU.

- the help corpus: the command list and every action's help page (each
  spec and alias of ``rbd_specs``), byte for byte;
- argument errors: each action with no arguments, with too many, and
  with a snapshot where none belongs — exit code, stdout and stderr
  equal;
- the verbs through ``--checkpoint``: a cluster with a replicated
  ``rbd`` pool and an EC ``ecdata`` pool (the port's ``backend=host``),
  checkpointed by each package, then ``create`` (also ``--data-pool
  ecdata``), ``ls``, ``info``, ``du``, ``snap``, ``clone``, ``export``,
  ``import``, ``export-diff`` / ``import-diff``, ``lock`` and ``rm``
  through both tools — outputs, exported files and the restored
  clusters' stores equal, with ``uuid.uuid4`` seeded;
- ``rbd bench``: its lines compared by format (they carry wall-clock
  rates), everything else of ``test_rbd_cram.py``'s bench flow equal.
"""
import io
import re
from contextlib import redirect_stderr, redirect_stdout

import pytest

import test_rbd_cram
from ceph_tpu.tools import rbd_cli as j_cli
from ceph_tpu.tools import rbd_optfmt as j_optfmt
from ceph_tpu.tools import rbd_shell as j_shell
from ceph_tpu.tools import rbd_specs as j_specs
from ceph_tpu_torch.tools import rbd_cli as p_cli
from ceph_tpu_torch.tools import rbd_optfmt as p_optfmt
from ceph_tpu_torch.tools import rbd_shell as p_shell
from ceph_tpu_torch.tools import rbd_specs as p_specs

from torch_daemon_twin import reset_both, store_state
from torch_rbd_twin import JAX, PORT, port_module, run_one, seeded_uuid4

SHELL = {JAX: j_shell, PORT: p_shell}
CLI = {JAX: j_cli, PORT: p_cli}
SPECS = [tuple(e["spec"]) for e in j_specs.SPECS]
ALIASES = [tuple(e["alias"]) for e in j_specs.SPECS if e["alias"]]


def _run(fn, argv):
    """(exit code, stdout, stderr); an exception the tool lets out
    stands in for the exit code as (its type's name, its message)."""
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        try:
            rc = fn(list(argv))
        except Exception as e:      # noqa: BLE001 — compared, not hidden
            rc = (type(e).__name__, str(e))
    return rc, out.getvalue(), err.getvalue()


def _both(argv, mods=SHELL):
    return {pkg: _run(mods[pkg].main, argv) for pkg in (JAX, PORT)}


def test_spec_table_and_formatter_equal():
    assert p_specs.SPECS == j_specs.SPECS
    assert len(SPECS) >= 80
    for name in ("LINE_WIDTH", "MIN_NAME_WIDTH", "MAX_DESCRIPTION_OFFSET"):
        assert getattr(p_optfmt, name) == getattr(j_optfmt, name)
    assert p_shell.FEATURE_NAMES == j_shell.FEATURE_NAMES
    assert p_shell.READONLY_SPECS == j_shell.READONLY_SPECS


@pytest.mark.parametrize("argv", [[], ["help"], ["--help"],
                                  ["help", "no-such-command"],
                                  ["no-such-command"]],
                         ids=["bare", "help", "dash_help", "help_unknown",
                              "unknown"])
def test_command_list_equal(argv):
    r = _both(argv)
    assert r[PORT] == r[JAX]
    assert "Command-line interface for managing Ceph RBD images." in \
        r[PORT][1]


@pytest.mark.parametrize("spec", SPECS + ALIASES,
                         ids=[" ".join(s) for s in SPECS + ALIASES])
def test_help_page_equal(spec):
    r = _both(["help", *spec])
    assert r[PORT] == r[JAX]
    assert r[PORT][0] == 0 and r[PORT][1].startswith("usage: rbd ")


@pytest.mark.parametrize("spec", SPECS, ids=[" ".join(s) for s in SPECS])
def test_argument_errors_equal(spec):
    """No arguments, too many, and a snapshot spec where the action may
    not take one: each ends at the same stage with the same words."""
    for argv in ([*spec],
                 [*spec, "p/a@s", "b", "c", "d", "e", "f", "g"],
                 [*spec, "img@snap"],
                 [*spec, "--image", "img", "--snap", "s", "--bogus"]):
        r = _both(argv)
        assert r[PORT] == r[JAX], argv


def _checkpoint(pkg, path):
    from importlib import import_module
    c = import_module(pkg + ".cluster").MiniCluster(n_osds=4)
    c.create_replicated_pool("rbd", size=3, pg_num=8)
    c.create_ec_pool("ecdata", k=2, m=1, plugin="isa", pg_num=8,
                     extra_profile={"backend": "host"} if pkg == PORT
                     else None)
    c.checkpoint(str(path))


def _verbs(d):
    """(tool, argv) of the checkpoint flow; ``d`` is the package's own
    scratch directory."""
    ck = str(d / "ck")
    size = str(64 << 12)
    return [
        ("shell", ["--checkpoint", ck, "create", "img", "--size", "1M"]),
        ("cli", ["--checkpoint", ck, "create", "vm", "--size", size,
                 "--order", "12", "--data-pool", "ecdata",
                 "--journaling"]),
        ("shell", ["--checkpoint", ck, "ls"]),
        ("shell", ["--checkpoint", ck, "info", "img"]),
        ("cli", ["--checkpoint", ck, "info", "vm"]),
        ("shell", ["--checkpoint", ck, "bench", "vm", "--io-type",
                   "write", "--io-size", "4K", "--io-total", "64K",
                   "--io-pattern", "rand"]),
        ("shell", ["--checkpoint", ck, "snap", "create", "vm@s1"]),
        ("shell", ["--checkpoint", ck, "snap", "protect", "vm@s1"]),
        ("shell", ["--checkpoint", ck, "snap", "list", "vm"]),
        ("shell", ["--checkpoint", ck, "clone", "vm@s1", "child"]),
        ("shell", ["--checkpoint", ck, "disk-usage", "vm"]),
        ("shell", ["--checkpoint", ck, "export", "vm", str(d / "vm.raw")]),
        ("shell", ["--checkpoint", ck, "export", "vm@s1",
                   str(d / "s1.raw")]),
        ("shell", ["--checkpoint", ck, "import", str(d / "vm.raw"),
                   "copy"]),
        ("cli", ["--checkpoint", ck, "export-diff", "vm",
                 str(d / "vm.diff"), "--snap", "s1"]),
        ("cli", ["--checkpoint", ck, "create", "twin", "--size", size,
                 "--order", "12"]),
        ("cli", ["--checkpoint", ck, "import-diff", str(d / "vm.diff"),
                 "twin"]),
        ("shell", ["--checkpoint", ck, "lock", "add", "img", "c1"]),
        ("shell", ["--checkpoint", ck, "lock", "list", "img"]),
        ("shell", ["--checkpoint", ck, "lock", "add", "img", "c2"]),
        ("shell", ["--checkpoint", ck, "resize", "img", "--size", "2M"]),
        ("shell", ["--checkpoint", ck, "rm", "copy"]),
        ("shell", ["--checkpoint", ck, "ls"]),
        ("shell", ["--checkpoint", ck, "info", "gone"]),
    ]


# a number and the padding before it (its width follows its value)
_RATES = re.compile(r" *\d+(\.\d+)?")


def test_checkpoint_verbs_equal(tmp_path, monkeypatch):
    import uuid
    runs = {}
    for pkg in (JAX, PORT):
        reset_both(collect=False)
        monkeypatch.setattr(uuid, "uuid4", seeded_uuid4())
        d = tmp_path / pkg
        d.mkdir()
        _checkpoint(pkg, d / "ck")
        outs = []
        for tool, argv in _verbs(d):
            mod = SHELL[pkg] if tool == "shell" else CLI[pkg]
            rc, out, err = _run(mod.main, argv)
            out, err = (s.replace(str(d), "<d>") for s in (out, err))
            if argv[2] == "bench":
                # the report's header and summary, numbers masked; the
                # per-second progress lines come as the wall clock ticks
                out = _RATES.sub(" N", "".join(
                    ln for ln in out.splitlines(True)
                    if not ln.startswith(" ") or "SEC" in ln))
            outs.append((tool, [a.replace(str(d), "<d>")
                                for a in argv[2:4]], rc, out, err))
        files = {p.name: p.read_bytes()
                 for p in sorted(d.iterdir()) if p.is_file()}
        from importlib import import_module
        c = import_module(pkg + ".cluster").MiniCluster.restore(
            str(d / "ck"))
        runs[pkg] = (outs, files, store_state(c))
        reset_both(collect=False)
    (jo, jf, js), (po, pf, ps) = runs[JAX], runs[PORT]
    for a, b in zip(jo, po):
        assert b == a
    assert len(po) == len(jo)
    assert pf == jf and set(pf) == {"vm.raw", "s1.raw", "vm.diff"}
    assert pf["vm.raw"] != bytes(len(pf["vm.raw"]))   # bench wrote
    assert ps == js
    assert [o[2] for o in po].count(0) >= len(po) - 3


def test_bench_flows_by_format(tmp_path, capsys):
    """``test_rbd_cram.py``'s ``rbd bench`` flow on each package; the
    report lines carry wall-clock rates, so they are compared with the
    numbers masked."""
    j = run_one(test_rbd_cram, "test_rbd_bench_flows", JAX, tmp_path,
                capsys)
    p = run_one(port_module(test_rbd_cram), "test_rbd_bench_flows", PORT,
                tmp_path, capsys)
    assert [store_state(c) for c in p.clusters] == \
        [store_state(c) for c in j.clusters]
