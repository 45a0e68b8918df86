"""The port's invariant analyzer (``ceph_tpu_torch/analysis``) against the
JAX package's, on the CPU.

1. **The catalog is live**: each rule flags a seeded-violation snippet
   and passes its clean twin.  The rules that name device calls are fed
   torch snippets (``torch.cuda.synchronize``, ``.item()``,
   ``torch.compile``, CUDA-graph capture, ``ctypes.CDLL``).
2. **The package-agnostic rules agree**: ``no-bare-lock``,
   ``no-wall-clock``, the pragmas and the from-import aliases give the
   same violations from both analyzers on the same snippets.
3. **The catalog is the reference's**: the same rule ids in the same
   order, the same allowlists, the same wire manifest, byte for byte.
4. **The port's tree is clean**: zero violations over
   ``ceph_tpu_torch/``, which holds the named locks and the memoized
   library loads.
"""
import ast
import json
import os
import subprocess
import sys

import pytest

from ceph_tpu.analysis import core as j_core
from ceph_tpu.analysis import rules as j_rules
from ceph_tpu_torch.analysis import run_analysis
from ceph_tpu_torch.analysis import core as p_core
from ceph_tpu_torch.analysis import rules as p_rules
from ceph_tpu_torch.analysis.core import REPO_ROOT, AnalysisContext
from ceph_tpu_torch.analysis.rules import (
    ALL_RULES, OPTIONS_DOC_ALLOW, JitCacheHygieneRule, NoBareLockRule,
    NoUntrackedSyncRule, NoWallClockRule, NoWireDriftRule,
    OptionsDocCoverageRule, collect_wire_fields, load_wire_manifest,
    rule_by_id,
)

PKG_DIR = os.path.join(REPO_ROOT, "ceph_tpu_torch")


def _check(rule, source, relpath="dispatch/snippet.py"):
    ctx = AnalysisContext(os.path.join(PKG_DIR, relpath), source=source,
                          relpath=relpath)
    return rule.run(ctx)


# ---- each rule fires on its seeded violation, not on its clean twin -------

def test_no_bare_lock_fires_and_clean_twin_passes():
    rule = NoBareLockRule()
    assert [v.line for v in _check(
        rule, "import threading\nlock = threading.Lock()\n")] == [2]
    assert len(_check(rule, "import threading\nl = threading.RLock()\n")) == 1
    assert len(_check(rule,
                      "import threading\ncv = threading.Condition()\n")) == 1
    clean = ("from ceph_tpu_torch.common.lockdep import DebugLock\n"
             'lock = DebugLock("Snippet::lock")\n')
    assert _check(rule, clean) == []
    clean_c = ("import threading\n"
               "from ceph_tpu_torch.common.lockdep import DebugLock\n"
               'cv = threading.Condition(DebugLock("S::l"))\n')
    assert _check(rule, clean_c) == []
    # the witness's own internals, relative to the port's package
    assert _check(rule, "import threading\nlock = threading.Lock()\n",
                  relpath="common/lockdep.py") == []


SYNC_SEEDED = [
    ("import torch\ndef f():\n    torch.cuda.synchronize()\n", [3]),
    ("import torch\ndef f(d):\n    torch.cuda.synchronize(d)\n", [3]),
    ("def f(ev):\n    ev.synchronize()\n", [2]),
    ("import torch\ndef f():\n"
     "    torch.cuda.current_stream().synchronize()\n", [3]),
    ("import torch\ndef f(t):\n    return t.item()\n", [3]),
    ("import torch\ndef f(t):\n    return t.cpu()\n", [3]),
    ("import torch\ndef f(t):\n    return t.tolist()\n", [3]),
    ("import torch\ndef f(t):\n    return t.sum().numpy()\n", [3]),
    ("def f(t):\n    import torch\n    return t.item()\n", [3]),
]


@pytest.mark.parametrize("src,lines", SYNC_SEEDED)
def test_no_untracked_sync_fires_on_torch_syncs(src, lines):
    rule = NoUntrackedSyncRule()
    assert [v.line for v in _check(rule, src)] == lines
    # an allowlisted call-site module: the same source is clean
    assert _check(rule, src, relpath="ops/snippet.py") == []


def test_no_untracked_sync_clean_twins_pass():
    rule = NoUntrackedSyncRule()
    # host fetches are suspect only in a torch-importing module
    host_only = ("import numpy as np\n"
                 "def pack(xs):\n"
                 "    return np.asarray(xs).tolist()\n")
    assert _check(rule, host_only) == []
    # a torch module that fetches nothing
    clean = ("import torch\n"
             "def f(t):\n"
             "    return t.to(torch.uint8).view(-1)\n")
    assert _check(rule, clean) == []
    for rel in ("parallel/x.py", "mesh/x.py", "bench/x.py",
                "dispatch/batch.py", "trace/devprof.py", "arch.py",
                "ec/shec.py", "osdmap/mapping.py"):
        assert _check(rule, SYNC_SEEDED[4][0], relpath=rel) == [], rel
    assert p_rules.SYNC_ALLOWED == j_rules.SYNC_ALLOWED


def test_no_wall_clock_fires_and_clean_twin_passes():
    rule = NoWallClockRule()
    seeded = "import time\ndef tick_self():\n    return time.monotonic()\n"
    assert [v.line for v in _check(rule, seeded,
                                   relpath="mon/snippet.py")] == [3]
    assert len(_check(rule, "import time\nt = time.time()\n",
                      relpath="osd/snippet.py")) == 1
    assert _check(rule, "def tick(now):\n    return now + 1.0\n",
                  relpath="mon/snippet.py") == []
    assert _check(rule, seeded, relpath="tools/snippet.py") == []
    assert _check(rule, seeded, relpath="msg/tcp.py") == []


JIT_SEEDED = [
    "import torch\ndef hot(x):\n    return torch.compile(lambda a: a)(x)\n",
    "import torch\ndef hot(f):\n    return torch.jit.script(f)\n",
    "import torch\ndef hot():\n    return torch.cuda.CUDAGraph()\n",
    ("import torch\ndef hot(g):\n    with torch.cuda.graph(g):\n"
     "        pass\n"),
    "import ctypes\ndef launch(so):\n    return ctypes.CDLL(so)\n",
    ("from torch import compile as tc\ndef hot(x):\n"
     "    return tc(lambda a: a)(x)\n"),
    ("import torch\ndef hot(x):\n    @torch.compile\n    def k(a):\n"
     "        return a\n    return k(x)\n"),
    ("import torch\ndef hot(x):\n    cache = {}\n"
     "    cache[1] = torch.compile(lambda a: a)\n    return cache[1](x)\n"),
]


@pytest.mark.parametrize("src", JIT_SEEDED)
def test_jit_cache_hygiene_fires_on_per_call_builds(src):
    assert len(_check(JitCacheHygieneRule(), src)) == 1


@pytest.mark.parametrize("src", [
    "import torch\nf = torch.compile(lambda a: a)\n",
    ("import torch\nclass C:\n    def __init__(self):\n"
     "        self._g = torch.cuda.CUDAGraph()\n"),
    ("import torch\nclass C:\n    def _build_plan(self):\n"
     "        return torch.compile(lambda a: a)\n"),
    ("import torch\nclass C:\n    def encode(self, x):\n"
     "        fn = self._fn = torch.compile(lambda a: a)\n"
     "        return fn(x)\n"),
    ("import ctypes\n_libs = {}\ndef load(name, so):\n"
     "    lib = _libs.get(name)\n    if lib is None:\n"
     "        lib = _libs[name] = ctypes.CDLL(so)\n    return lib\n"),
    # no torch and no ctypes: the rule does not apply
    "def hot(x):\n    return compile(x, 'f', 'exec')\n",
])
def test_jit_cache_hygiene_clean_twins_pass(src):
    assert _check(JitCacheHygieneRule(), src) == []


def test_pragma_suppresses_exactly_the_named_rule():
    rule = NoUntrackedSyncRule()
    src = ("import torch\n"
           "torch.cuda.synchronize()  # lint: allow[no-untracked-sync]\n")
    assert _check(rule, src) == []
    src2 = ("import torch\n# lint: allow[no-untracked-sync] one-shot\n"
            "torch.cuda.synchronize()\n")
    assert _check(rule, src2) == []
    src3 = ("import torch\n"
            "torch.cuda.synchronize()  # lint: allow[no-bare-lock]\n")
    assert len(_check(rule, src3)) == 1


# ---- the package-agnostic rules agree with the reference's ----------------

AGNOSTIC = [
    ("no-bare-lock", "dispatch/s.py",
     "import threading\nlock = threading.Lock()\n"),
    ("no-bare-lock", "dispatch/s.py",
     "import threading\nlock = threading.RLock()\n"),
    ("no-bare-lock", "dispatch/s.py",
     "import threading\ncv = threading.Condition()\n"),
    ("no-bare-lock", "dispatch/s.py",
     "from threading import Lock\nx = Lock()\n"),
    ("no-bare-lock", "dispatch/s.py",
     "import threading as th\nx = th.RLock()\n"),
    ("no-bare-lock", "common/lockdep.py",
     "import threading\nlock = threading.Lock()\n"),
    ("no-bare-lock", "dispatch/s.py",
     "import threading\n"
     "lock = threading.Lock()  # lint: allow[no-bare-lock]\n"),
    ("no-bare-lock", "dispatch/s.py",
     "import threading\n# lint: allow[no-bare-lock]\n"
     "lock = threading.Lock()\n"),
    ("no-bare-lock", "dispatch/s.py",
     "import threading\n"
     "lock = threading.Lock()  # lint: allow[no-wall-clock]\n"),
    ("no-bare-lock", "dispatch/s.py",
     "import threading\nlock = threading.Lock()  # lint: allow[*]\n"),
    ("no-wall-clock", "mon/s.py",
     "import time\ndef f():\n    return time.monotonic()\n"),
    ("no-wall-clock", "osd/s.py", "import time\nt = time.time()\n"),
    ("no-wall-clock", "msg/s.py",
     "import datetime\nt = datetime.datetime.now()\n"),
    ("no-wall-clock", "mon/s.py",
     "from time import monotonic\nt = monotonic()\n"),
    ("no-wall-clock", "cluster.py", "import time\nt = time.time()\n"),
    ("no-wall-clock", "msg/tcp.py", "import time\nt = time.time()\n"),
    ("no-wall-clock", "tools/s.py", "import time\nt = time.time()\n"),
    ("no-wall-clock", "mon/s.py",
     "import time\nt = time.time()  # lint: allow[no-wall-clock]\n"),
]


@pytest.mark.parametrize("rule_id,relpath,src", AGNOSTIC)
def test_agnostic_rules_agree_with_the_reference(rule_id, relpath, src):
    def run(core, rules, pkg):
        ctx = core.AnalysisContext(
            os.path.join(REPO_ROOT, pkg, relpath), source=src,
            relpath=relpath)
        return [(v.rule, v.line, v.message)
                for v in rules.rule_by_id(rule_id).run(ctx)]
    assert run(p_core, p_rules, "ceph_tpu_torch") == \
        run(j_core, j_rules, "ceph_tpu")


def test_relpath_drops_the_ports_prefix():
    """A file of the port is matched on its package-relative path, as
    the reference's are on theirs."""
    ctx = AnalysisContext(os.path.join(PKG_DIR, "common", "lockdep.py"))
    assert ctx.relpath == os.path.join("common", "lockdep.py")
    assert ctx.path == os.path.join("ceph_tpu_torch", "common", "lockdep.py")


# ---- the catalog is the reference's ---------------------------------------

def test_rule_ids_equal_the_reference():
    ids = [cls.id for cls in ALL_RULES]
    assert ids == [cls.id for cls in j_rules.ALL_RULES]
    assert len(ids) == len(set(ids))
    for i in ids:
        assert rule_by_id(i).id == i
    with pytest.raises(KeyError):
        rule_by_id("nonsense-rule")


def test_allowlists_equal_the_reference():
    assert p_rules.BARE_LOCK_ALLOWED == j_rules.BARE_LOCK_ALLOWED
    assert p_rules.WALL_CLOCK_SCOPE == j_rules.WALL_CLOCK_SCOPE
    assert p_rules.WALL_CLOCK_ALLOWED == j_rules.WALL_CLOCK_ALLOWED
    assert OPTIONS_DOC_ALLOW == j_rules.OPTIONS_DOC_ALLOW == set()


def test_wire_manifest_is_the_references():
    """The port's manifest is a byte copy of the reference's: the port's
    messages are held to the reference's wire format."""
    with open(p_rules.WIRE_MANIFEST_PATH, "rb") as f:
        port = f.read()
    with open(j_rules.WIRE_MANIFEST_PATH, "rb") as f:
        jax = f.read()
    assert port == jax
    assert p_rules.WIRE_MANIFEST_PATH != j_rules.WIRE_MANIFEST_PATH


# ---- no-wire-drift on the port's messages ---------------------------------

def _messages_source():
    with open(os.path.join(PKG_DIR, "msg", "messages.py")) as f:
        return f.read()


def test_wire_manifest_matches_the_ports_messages():
    assert _check(NoWireDriftRule(), _messages_source(),
                  relpath="msg/messages.py") == []
    fields = collect_wire_fields(ast.parse(_messages_source()))
    assert set(fields) == set(load_wire_manifest())
    assert "MOSDOp" in fields and "trace_id" in fields["Message"]


def test_wire_drift_is_flagged():
    rule = NoWireDriftRule()
    src = _messages_source()
    drifted = src.replace(
        "class MOSDPing(Message):",
        "class MOSDPing(Message):\n    sneaky_new_field: int = 0", 1)
    assert drifted != src
    viol = _check(rule, drifted, relpath="msg/messages.py")
    assert any("MOSDPing.sneaky_new_field" in v.message for v in viol)
    renamed = src.replace("class MOSDPing(Message):",
                          "class MOSDPingRenamed(Message):", 1)
    msgs = "\n".join(v.message for v in
                     _check(rule, renamed, relpath="msg/messages.py"))
    assert "MOSDPing" in msgs and "disappeared" in msgs


# ---- options-doc-coverage -------------------------------------------------

def test_options_doc_rule_fires_on_undocumented_option():
    rule = OptionsDocCoverageRule()
    src = ('Option = object\n'
           'opts = [Option("zz_surely_undocumented_option_xq")]\n')
    viol = _check(rule, src, relpath="common/config.py")
    assert len(viol) == 1
    assert "zz_surely_undocumented_option_xq" in viol[0].message
    src2 = 'Option = object\nopts = [Option("mgr_slo_fast_window_s")]\n'
    assert _check(rule, src2, relpath="common/config.py") == []


def test_every_port_option_is_seen_statically():
    from ceph_tpu_torch.common.config import g_conf
    with open(os.path.join(PKG_DIR, "common", "config.py")) as f:
        tree = ast.parse(f.read())
    static = {n.args[0].value for n in ast.walk(tree)
              if isinstance(n, ast.Call)
              and getattr(n.func, "id", "") == "Option" and n.args
              and isinstance(n.args[0], ast.Constant)
              and isinstance(n.args[0].value, str)}
    runtime = {n for n in g_conf.schema if not n.startswith("debug_")}
    assert not runtime - static


# ---- the port's tree ------------------------------------------------------

def test_ports_tree_is_clean():
    """Zero violations over ``ceph_tpu_torch/``: every lock is a named
    ``DebugLock``, no sync outside the audited modules but the one
    pragma'd context warm-up, every library load memoized, the wire
    format the reference's, every option documented."""
    viol = run_analysis()
    assert viol == [], "\n" + "\n".join(str(v) for v in viol)


NAMED_LOCKS = [
    ("ec/registry.py", "ec_registry::plugins", True),
    ("ec/rs_codec.py", "rs_codec::decode_cache", True),
    ("ec/shec.py", "shec::table_cache", True),
    ("ops/gf_matmul.py", "gf_matmul::decode_bits_cache", True),
    ("ec/matrix_plugin.py", "matrix_plugin::device", False),
    ("mesh/topology.py", "mesh_topology::members", False),
    ("ops/_build.py", "build::libs", False),
    ("ops/_build_host.py", "build_host::libs", False),
    ("ops/crc32c_device.py", "crc32c_device::tables", False),
    ("ops/gf_pallas.py", "gf_pallas::launch_counter", False),
]


@pytest.mark.parametrize("path,name,in_jax", NAMED_LOCKS)
def test_locks_are_named_as_the_reference_names_them(path, name, in_jax):
    """The ten locks the reference's rule would flag in the port are
    named ``DebugLock``s; the four that the reference also has carry
    its names."""
    call = f'DebugLock("{name}")'
    with open(os.path.join(PKG_DIR, path)) as f:
        assert call in f.read()
    if in_jax:
        with open(os.path.join(REPO_ROOT, "ceph_tpu", path)) as f:
            assert call in f.read()


def test_cli_json_and_exit_codes(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import torch\ndef f(t):\n    return t.item()\n")
    proc = subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.analysis", "--json",
         "--rule", "no-untracked-sync", str(bad)],
        capture_output=True, text=True, cwd=REPO_ROOT, timeout=120)
    assert proc.returncode == 1, proc.stderr
    data = json.loads(proc.stdout)
    assert len(data) == 1 and data[0]["rule"] == "no-untracked-sync"
    good = tmp_path / "good.py"
    good.write_text("x = 1\n")
    proc = subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.analysis", str(good)],
        capture_output=True, text=True, cwd=REPO_ROOT, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    proc = subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.analysis", "--rule",
         "nonsense-rule", str(good)],
        capture_output=True, text=True, cwd=REPO_ROOT, timeout=120)
    assert proc.returncode == 2
    proc = subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.analysis", "--list-rules"],
        capture_output=True, text=True, cwd=REPO_ROOT, timeout=120)
    assert proc.returncode == 0
    assert [ln.split()[0] for ln in proc.stdout.splitlines()] == \
        [cls.id for cls in ALL_RULES]
