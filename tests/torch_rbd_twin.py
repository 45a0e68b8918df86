"""Runs a JAX-package test case on both packages and compares what they
stored (the rbd, journal and rbd tool twin tests).

``port_module(mod)`` is the JAX test module ``mod`` with every
``ceph_tpu`` import turned into ``ceph_tpu_torch``: the same cases, the
same inputs, on the port.  ``run_both(mod, name, tmp_path, capsys)`` runs
the case ``name`` (its module fixtures, ``tmp_path`` and ``capsys``
supplied) once on each package with:

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
  ``isa`` on its CPU);
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

from torch_daemon_twin import reset_both, store_state

JAX, PORT = "ceph_tpu", "ceph_tpu_torch"
UUID_SEED = 20260807
FS_CLOCK_START = 1786000000.0      # the fake clock's first second
FS_CLOCK_STEP = 0.001


def port_module(mod, without=()):
    """``mod``'s source with the JAX package's imports made the port's.
    The import lines of the JAX subpackages named in ``without`` (not
    ported yet) are left out, and with them the cases that use them."""
    src = inspect.getsource(mod)
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
    mp.setattr(uuid, "uuid4", seeded_uuid4())
    mp.setattr(secrets, "randbits", seeded_randbits())
    mp.setattr(secrets, "token_hex", seeded_token_hex())
    mp.setattr(time, "time", fs_clock(rgw_start=rgw_start, case=case))


def _call(mod, name, tmp_path, capsys):
    fn = getattr(mod, name)
    kwargs, gens = {}, []
    for arg in inspect.signature(fn).parameters:
        if arg == "tmp_path":
            kwargs[arg] = tmp_path
        elif arg == "capsys":
            kwargs[arg] = capsys
        else:
            value = getattr(mod, arg)._get_wrapped_function()()
            if inspect.isgenerator(value):
                gens.append(value)
                value = next(value)
            kwargs[arg] = value
    try:
        fn(**kwargs)
    finally:
        for g in gens:
            next(g, None)


def run_one(mod, name, pkg, tmp_path, capsys, rgw_start=None):
    """The case ``name`` of ``mod`` (already the ``pkg`` package's); the
    gateway's and the case's clock starts at ``rgw_start`` (default:
    now)."""
    run = Run(pkg)
    reset_both(collect=False)
    d = tmp_path / pkg
    d.mkdir()
    capsys.readouterr()
    if rgw_start is None:
        rgw_start = time.time()
    with pytest.MonkeyPatch.context() as mp:
        _patch(mp, pkg, run, rgw_start, case=(mod.__name__,))
        try:
            _call(mod, name, d, capsys)
        finally:
            cap = capsys.readouterr()
            run.out, run.err = cap.out, cap.err
    reset_both(collect=False)
    return run


def run_both(mod, name, tmp_path, capsys, port=None):
    """``mod``'s case ``name`` on the JAX package, then on the port
    (``port`` is ``port_module(mod)`` when the caller holds one)."""
    start = time.time()
    j = run_one(mod, name, JAX, tmp_path, capsys, start)
    p = run_one(port or port_module(mod), name, PORT, tmp_path, capsys,
                start)
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
