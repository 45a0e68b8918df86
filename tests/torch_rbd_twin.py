"""Runs a JAX-package test case on both packages and compares what they
stored (the rbd, journal and rbd tool twin tests).

``port_module(mod)`` is the JAX test module ``mod`` with every
``ceph_tpu`` import turned into ``ceph_tpu_torch``: the same cases, the
same inputs, on the port.  ``run_both(mod, name, tmp_path, capsys)`` runs
the case ``name`` (its module fixtures, ``tmp_path`` and ``capsys``
supplied, with ``monkeypatch``, ``request`` and the module's
autouse and chained fixtures, and the values of one parametrised
variant from ``case_variants``) once on each package with:

- ``uuid.uuid4`` drawn from one seeded sequence, restarted for each
  package, so image ids and lock cookies agree;
- ``secrets.randbits`` drawn from another, so the clients' request id
  bases (which the MDS journals) agree;
- ``secrets.token_hex`` drawn from a third, so the gateway's keys,
  bucket ids, index tags, version ids and upload ids agree;
- ``time.time`` read by the filesystem (``cephfs/`` and ``mds/``) from
  one fake clock, restarted for each package, so the mtimes and snapshot
  stamps it stores agree; ``time.time`` read by the gateway (``rgw/``)
  and by the case itself from another, which starts at the real time
  read once when ``run_both`` begins, so the bucket and object mtimes
  agree and stay on the case's own clock (its lifecycle cases age
  objects from its own ``time.time()``); every other caller reads the
  real clock;
- the port's EC pools given ``backend=host`` (its codecs' default
  ``cuda`` backend asks for the card; the JAX pools run ``tpu`` or
  ``isa`` on its CPU), and every codec the port's registry makes: a
  profile that names the JAX plugin ``tpu`` gets the port's ``cuda``,
  and one that names no backend, or JAX's ``tpu``, gets ``host``, so a
  case's own
  ``create_erasure_code`` and profile tables run as they do in JAX;
- the port's mesh given ``MESH_MEMBERS`` members on the CPU, as many
  as JAX's virtual devices (``tests/conftest.py``);
- both packages' mesh counters at zero, as in a fresh process, and
  restored afterwards (``fresh_mesh_counters``);
- every ``MiniCluster`` the case builds recorded, so that afterwards
  each cluster's stores (bodies, xattrs, omaps of every object on every
  OSD) can be compared with its twin's.

It returns ``(jax_run, port_run)``, each with the case's captured
stdout/stderr and the clusters' store states in creation order.
"""
import inspect
import random
import re
import secrets
import sys
import time
import types
import uuid

import pytest
from _pytest.fixtures import FixtureFunctionDefinition
from _pytest.mark.structures import ParameterSet

from torch_daemon_twin import fresh_mesh_counters, reset_both, store_state

JAX, PORT = "ceph_tpu", "ceph_tpu_torch"
UUID_SEED = 20260807
FS_CLOCK_START = 1786000000.0      # the fake clock's first second
FS_CLOCK_STEP = 0.001
MESH_MEMBERS = 8                   # JAX's virtual CPU devices


def port_module(mod, without=(), edits=()):
    """``mod``'s source with the JAX package's imports made the port's.
    The import lines of the JAX subpackages named in ``without`` (not
    ported yet) are left out, and with them the cases that use them.
    Each ``(old, new)`` of ``edits`` replaces text that must be in the
    source (a JAX default the port asks for by name)."""
    src = inspect.getsource(mod)
    for old, new in edits:
        assert old in src, (mod.__name__, old)
        src = src.replace(old, new)
    for sub in without:
        src = re.sub(rf"^from ceph_tpu\.{sub}\b.*\n", "", src,
                     flags=re.M)
    src = re.sub(r"\bceph_tpu\b", PORT, src)
    port = types.ModuleType(mod.__name__ + "_port")
    port.__file__ = mod.__file__
    exec(compile(src, mod.__file__, "exec"), port.__dict__)
    return port


def seeded_uuid4():
    rng = random.Random(UUID_SEED)
    return lambda: uuid.UUID(int=rng.getrandbits(128), version=4)


def seeded_randbits():
    return random.Random(UUID_SEED + 1).getrandbits


def seeded_token_hex():
    rng = random.Random(UUID_SEED + 2)

    def token_hex(nbytes=32):
        return rng.getrandbits(8 * nbytes).to_bytes(nbytes, "little").hex()
    return token_hex


def fs_clock(real=time.time, rgw_start=None, case=()):
    """``time.time`` that gives the filesystem's modules one step of a
    fake clock per call, the gateway's modules and the modules named in
    ``case`` one step of another that starts at ``rgw_start`` (when
    given), and any other caller the real time."""
    now = [FS_CLOCK_START]
    rgw_now = [rgw_start]

    def clock():
        caller = sys._getframe(1).f_globals.get("__name__", "")
        sub = caller.split(".")[1:2]
        if sub in (["cephfs"], ["mds"]):
            now[0] += FS_CLOCK_STEP
            return now[0]
        if rgw_start is not None and (sub == ["rgw"] or caller in case):
            rgw_now[0] += FS_CLOCK_STEP
            return rgw_now[0]
        return real()
    return clock


class Run:
    def __init__(self, pkg):
        self.pkg = pkg
        self.clusters = []
        self.out = ""
        self.err = ""

    def states(self):
        return [store_state(c) for c in self.clusters]


def _patch(mp, pkg, run, rgw_start=None, case=()):
    from importlib import import_module
    cluster_cls = import_module(pkg + ".cluster").MiniCluster
    init = cluster_cls.__init__

    def recording_init(self, *a, **kw):
        init(self, *a, **kw)
        run.clusters.append(self)

    mp.setattr(cluster_cls, "__init__", recording_init)
    if pkg == PORT:
        create_ec_pool = cluster_cls.create_ec_pool

        def host_ec_pool(self, *a, extra_profile=None, **kw):
            return create_ec_pool(
                self, *a, extra_profile={**(extra_profile or {}),
                                         "backend": "host"}, **kw)

        mp.setattr(cluster_cls, "create_ec_pool", host_ec_pool)
        registry = import_module(pkg + ".ec.registry").instance
        factory = registry.factory

        def host_factory(name, profile):
            if name == "tpu":
                name = "cuda"
                profile = {**profile, "plugin": "cuda"}
            if profile.get("backend", "tpu") == "tpu":
                profile = {**profile, "backend": "host"}
            return factory(name, profile)

        mp.setattr(registry, "factory", host_factory)
    mp.setattr(uuid, "uuid4", seeded_uuid4())
    mp.setattr(secrets, "randbits", seeded_randbits())
    mp.setattr(secrets, "token_hex", seeded_token_hex())
    mp.setattr(time, "time", fs_clock(rgw_start=rgw_start, case=case))


class _Request:
    """The ``request`` fixture as the cases use it."""

    def __init__(self, resolve):
        self.getfixturevalue = resolve


def _fixtures(mod):
    return {n: v for n, v in vars(mod).items()
            if isinstance(v, FixtureFunctionDefinition)}


def _call(mod, name, tmp_path, capsys, params=None):
    """The case ``name`` with its fixtures: the module's own (autouse
    ones first, each chained to the fixtures it takes, each made once),
    ``tmp_path``, ``capsys``, ``monkeypatch`` (undone afterwards),
    ``request`` and the parametrised values ``params``.  Generator
    fixtures finish in reverse order."""
    fn = getattr(mod, name)
    fixtures = _fixtures(mod)
    params = dict(params or {})
    made, gens = {}, []
    mp = pytest.MonkeyPatch()

    def resolve(arg):
        if arg in made:
            return made[arg]
        if arg in params:
            value = params[arg]
        elif arg == "tmp_path":
            value = tmp_path
        elif arg == "capsys":
            value = capsys
        elif arg == "monkeypatch":
            value = mp
        elif arg == "request":
            value = _Request(resolve)
        else:
            f = fixtures[arg]._get_wrapped_function()
            value = f(**{a: resolve(a) for a in _arg_names(f)})
            if inspect.isgenerator(value):
                gens.append(value)
                value = next(value)
        made[arg] = value
        return value

    try:
        for n, fix in fixtures.items():
            if fix._fixture_function_marker.autouse:
                resolve(n)
        fn(**{a: resolve(a) for a in _arg_names(fn)})
    finally:
        for g in reversed(gens):
            next(g, None)
        mp.undo()


def _arg_names(fn):
    """The parameters pytest fills: those without a default."""
    return [n for n, p in inspect.signature(fn).parameters.items()
            if p.default is inspect.Parameter.empty]


def case_variants(mod, name):
    """``[(id, params)]`` of the case ``name``: one per combination of
    its ``parametrize`` marks (``[("", {})]`` when it has none)."""
    out = [("", {})]
    for mark in getattr(getattr(mod, name), "pytestmark", ()):
        if mark.name != "parametrize":
            continue
        names, values = mark.args[:2]
        names = [n.strip() for n in names.split(",")] \
            if isinstance(names, str) else list(names)
        ids = mark.kwargs.get("ids")
        rows = []
        for i, v in enumerate(values):
            v = v.values if isinstance(v, ParameterSet) else (
                (v,) if len(names) == 1 else tuple(v))
            rid = ids[i] if ids else "-".join(
                str(x) if isinstance(x, (str, int, float, bool)) or
                x is None else f"{n}{i}" for n, x in zip(names, v))
            rows.append((str(rid), dict(zip(names, v))))
        out = [(f"{rid}-{oid}" if oid else rid, {**p, **op})
               for oid, op in out for rid, p in rows]
    return out


def run_one(mod, name, pkg, tmp_path, capsys, rgw_start=None,
            params=None, torch_threads=None):
    """The case ``name`` of ``mod`` (already the ``pkg`` package's) with
    the parametrised values ``params``; the gateway's and the case's
    clock starts at ``rgw_start`` (default: now).  ``torch_threads``
    sets torch's intra-op threads for the port's run, as each daemon of
    the process cluster sets them (``vstart._daemon_start``), and
    ``OMP_NUM_THREADS`` for the processes it starts: a mesh member slowed
    on purpose then stands out to the scoreboard while other test
    workers load every core."""
    import torch
    from ceph_tpu_torch.mesh import members_per_device, \
        set_members_per_device
    run = Run(pkg)
    members = members_per_device()
    threads = torch.get_num_threads()
    if pkg == PORT:
        set_members_per_device(MESH_MEMBERS)
        if torch_threads:
            torch.set_num_threads(torch_threads)
    reset_both(collect=False)
    d = tmp_path / pkg
    d.mkdir()
    capsys.readouterr()
    if rgw_start is None:
        rgw_start = time.time()
    try:
        with pytest.MonkeyPatch.context() as mp, fresh_mesh_counters():
            _patch(mp, pkg, run, rgw_start, case=(mod.__name__,))
            if pkg == PORT and torch_threads:
                # and the processes the case starts (the bench CLI's
                # ``--smoke``): with torch's default pool, beside the other
                # test workers, the port's smoke took 109 s, one thread 13
                mp.setenv("OMP_NUM_THREADS", str(torch_threads))
            try:
                _call(mod, name, d, capsys, params)
            finally:
                cap = capsys.readouterr()
                run.out, run.err = cap.out, cap.err
        reset_both(collect=False)
    finally:
        set_members_per_device(members)
        torch.set_num_threads(threads)
    return run


def run_both(mod, name, tmp_path, capsys, port=None, params=None,
             torch_threads=None):
    """``mod``'s case ``name`` (with the parametrised values ``params``)
    on the JAX package, then on the port (``port`` is
    ``port_module(mod)`` when the caller holds one; ``torch_threads`` as
    ``run_one`` takes it)."""
    start = time.time()
    j = run_one(mod, name, JAX, tmp_path, capsys, start, params)
    p = run_one(port or port_module(mod), name, PORT, tmp_path, capsys,
                start, params, torch_threads)
    return j, p


def assert_same_runs(j, p):
    """Equal output and, cluster by cluster, equal stores."""
    assert p.out.replace(str(PORT), JAX) == j.out
    assert p.err.replace(str(PORT), JAX) == j.err
    assert len(p.clusters) == len(j.clusters)
    for a, b in zip(j.states(), p.states()):
        assert a.keys() == b.keys()
        for key in a:
            assert a[key] == b[key], key


def case_names(mod):
    return [n for n, v in vars(mod).items()
            if n.startswith("test_") and callable(v)]
