"""The port's mgr chain (telemetry, incidents, the controller, the
Prometheus exposition) against the JAX package's, on the CPU.

Both packages get the same clusters, options and traffic seeds.  Where a
reading is a wall-clock latency it is compared by its keys; the counters
the SLO engine and the controller act on (admission rejections on the
cluster's clock) are deterministic and compared by value.  The
exposition is compared family by family in a fresh interpreter, so that
no earlier test's process-global histograms reach either side; the
families the port leaves out by design (ROADMAP Queue 3) are the JAX
mesh's four counter families and the breaker gauge.
"""
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from ceph_tpu.cluster import MiniCluster as JaxCluster
from ceph_tpu.common.config import g_conf as jax_conf
from ceph_tpu.control import Controller as JaxController
from ceph_tpu.load import TrafficSpec as JaxSpec
from ceph_tpu.load import run_traffic as jax_run
from ceph_tpu.mgr.telemetry import SLO_ADMISSION as J_SLO_ADMISSION

from ceph_tpu_torch.cluster import MiniCluster as PortCluster
from ceph_tpu_torch.common.config import g_conf
from ceph_tpu_torch.control import Controller as PortController
from ceph_tpu_torch.load import TrafficSpec as PortSpec
from ceph_tpu_torch.load import run_traffic as port_run
from ceph_tpu_torch.mgr.telemetry import SLO_ADMISSION

from torch_daemon_twin import JAX, PORT, clean, set_both  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
SIDES = {JAX: (JaxCluster, JaxSpec, jax_run),
         PORT: (PortCluster, PortSpec, port_run)}


def saturate(pkg):
    """The SLO lifecycle of ``test_telemetry.py``'s load case, admission
    objective only: an abusive open-loop run raises TPU_SLO_ADMISSION
    while the mgr ticks, quiet ticks clear it."""
    cluster, spec, run = SIDES[pkg]
    c = cluster(n_osds=4)
    c.create_replicated_pool("load", size=3, pg_num=8)
    res = run(c, spec(n_clients=8, ops_per_client=16, mode="open",
                      rate=4.0, rate_multipliers=(10.0,), tick_every=4))
    raised = (c.health(), c.mgr.telemetry.slo_state(),
              sorted(c.admin_socket.execute("telemetry dump")),
              sorted(c.admin_socket.execute("tpu status")),
              c.mgr.telemetry.rollup()["rates"]["admission_rejections"])
    for _ in range(10):
        c.tick(dt=2.0)
        if "TPU_SLO" not in c.health():
            break
    return res, raised, (c.health(), c.mgr.telemetry.slo_state())


def test_slo_states_and_rollup_keys_equal(clean):
    set_both("osd_op_queue_admission_max", 8)
    set_both("mgr_slo_admission_rate_max", 0.1)
    set_both("mgr_slo_fast_window_s", 4.0)
    set_both("mgr_slo_slow_window_s", 16.0)
    assert SLO_ADMISSION == J_SLO_ADMISSION
    jr, jraise, jclear = saturate(JAX)
    pr, praise, pclear = saturate(PORT)
    assert pr.byte_exact and jr.byte_exact
    assert pr.admission_rejections == jr.admission_rejections > 0
    assert (pr.completed, pr.rounds) == (jr.completed, jr.rounds)
    # health text and SLO state (streaks, burns) at the raise
    assert praise[0] == jraise[0]
    assert SLO_ADMISSION in praise[0]
    assert praise[1] == jraise[1]
    assert praise[1][SLO_ADMISSION]["state"] == "breach"
    assert praise[2] == jraise[2]
    assert set(jraise[3]) - set(praise[3]) == {"breakers_open"}
    assert praise[4] == jraise[4] > 0.1
    # and after the quiet ticks
    assert pclear == jclear
    assert SLO_ADMISSION not in pclear[0]
    assert pclear[1][SLO_ADMISSION]["state"] == "ok"


def test_incident_bundle_keys_equal_but_breakers(clean):
    seen = {}
    for pkg, (cluster, _spec, _run) in SIDES.items():
        c = cluster(n_osds=4)
        c.create_replicated_pool("load", size=3, pg_num=8)
        c.kill_osd(2)
        c.tick(dt=6.0, rounds=6)
        cap = c.admin_socket.execute("tpu incident capture")
        listing = c.admin_socket.execute("tpu incident list")
        bundle = c.admin_socket.execute("tpu incident dump")["incident"]
        seen[pkg] = (sorted(cap), sorted(listing), bundle,
                     [e["type"] for e in bundle["timeline"]
                      if e["type"] in ("osd_down", "incident_capture")])
    (jc, jl, jb, jt), (pc, pl, pb, pt) = seen[JAX], seen[PORT]
    assert (pc, pl) == (jc, jl)
    assert set(jb) - set(pb) == {"breakers_open"}
    assert set(pb) <= set(jb)
    assert pb["trigger"] == jb["trigger"]
    assert pb["state"] == jb["state"] == "manual"
    assert pb["health_checks"] == jb["health_checks"]
    assert pb["chip_scoreboard"].keys() == jb["chip_scoreboard"].keys()
    assert pb["control"].keys() == jb["control"].keys()
    assert pt == jt == ["osd_down"]


class ScriptedMgr:
    """The surfaces the controller reads and writes, with the SLO states
    scripted tick by tick."""

    def __init__(self, states):
        self.states = list(states)
        self.health_checks = {}
        self.log = []
        self.telemetry = SimpleNamespace(slo_state=self._slo)

    def _slo(self):
        return self.states[0] if self.states else {}

    def _cluster_log(self, level, message):
        self.log.append((level, message))


def drive(controller, states):
    mgr = ScriptedMgr(states)
    dumps = []
    for t in range(len(states)):
        controller.step(mgr, now=float(t))
        mgr.states.pop(0)
        dumps.append(controller.dump())
    return dumps, mgr.log


def test_controller_moves_equal_from_the_same_slo_inputs(clean):
    """The controller's ledger, knob states and cluster-log lines from a
    scripted admission breach, its clear and the walk back."""
    set_both("mgr_control_enable", True)
    set_both("mgr_control_cooldown_ticks", 1)
    set_both("osd_op_queue_admission_max", 64)
    breach = {SLO_ADMISSION: {"state": "breach"}}
    ok = {SLO_ADMISSION: {"state": "ok"}}
    script = [ok, breach, breach, breach, breach, breach] + [ok] * 10
    jd, jlog = drive(JaxController(), script)
    pd, plog = drive(PortController(), script)
    assert pd == jd
    assert plog == jlog
    assert pd[-1]["moves_total"] > 2
    reflexes = {e["reflex"] for e in pd[-1]["ledger"]}
    assert {"admission", "restore"} <= reflexes
    assert g_conf.get_val("osd_op_queue_admission_max") == \
        jax_conf.get_val("osd_op_queue_admission_max") == 64


def test_controller_rateless_knob_has_no_mesh(clean):
    """The rateless width's bounds read the port's mesh switch: no mesh
    for 0 or 1 chips, a raise for a mesh of 2 or more."""
    ctl = PortController()
    knobs = ctl.dump()["knobs"]["ec_mesh_rateless_tasks"]
    assert knobs["floor"] is None and knobs["ceiling"] is None
    g_conf.set_val("ec_mesh_chips", 2)
    with pytest.raises(NotImplementedError, match="mesh"):
        ctl.dump()


def test_check_degraded_codecs_never_raises(clean):
    c = PortCluster(n_osds=4)
    for _ in range(3):
        c.mgr.check_degraded_codecs()
        c.tick(dt=1.0)
    assert "TPU_CODEC_DEGRADED" not in c.mgr.health_checks
    assert c.health() == "HEALTH_OK"


EXPOSITION = r"""
import json, re, sys
import numpy as np
sys.path.insert(0, {repo!r})
from ceph_tpu.cluster import MiniCluster as J
from ceph_tpu_torch.cluster import MiniCluster as P

def run(C, prof):
    c = C(n_osds=8)
    c.create_ec_pool("ec", k=4, m=2, pg_num=8, **prof)
    cl = c.client()
    rng = np.random.default_rng(3)
    for i in range(4):
        body = rng.integers(0, 256, 5000 + i, dtype=np.uint8).tobytes()
        assert cl.write_full("ec", "o%d" % i, body) == 0
        assert cl.read("ec", "o%d" % i) == body
    c.tick(dt=1.0, rounds=2)
    return c.admin_socket.execute("prometheus metrics")

def families(text):
    fam = {{}}
    for ln in text.splitlines():
        if ln.startswith("# TYPE"):
            _, _, name, kind = ln.split()
            fam[name] = kind
        elif ln and not ln.startswith("#"):
            fam.setdefault(re.split(r"[{{ ]", ln)[0], "untyped")
    return fam

print(json.dumps([families(run(J, {{"plugin": "tpu"}})),
                  families(run(P, {{"extra_profile": {{"backend": "host"}}}}))]))
"""


def test_prometheus_exposition_equal_but_queue3_families():
    """Every family the port exposes, the JAX package exposes with the
    same type; the JAX-only families are exactly the mesh's four counter
    loggers and the breaker gauge."""
    out = subprocess.run(
        [sys.executable, "-c", EXPOSITION.format(repo=str(REPO))],
        cwd=str(REPO), capture_output=True, text=True, timeout=300,
        env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    jfam, pfam = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(pfam) <= set(jfam)
    assert {n: jfam[n] for n in pfam} == pfam
    extra = set(jfam) - set(pfam)
    mesh = ("ceph_daemon_mesh_", "ceph_daemon_mesh_decode_",
            "ceph_daemon_mesh_membership_", "ceph_daemon_mesh_rateless_")
    assert "ceph_tpu_codec_degraded" in extra
    rest = extra - {"ceph_tpu_codec_degraded"}
    assert rest and all(n.startswith(mesh) for n in rest)
    assert not any(n.startswith("ceph_daemon_mesh_chip_") for n in extra)
    assert any(n.startswith("ceph_daemon_mesh_chip_") for n in pfam)
    assert "ceph_cluster_control_moves" in pfam
    assert any(n.startswith("ceph_oplat_") for n in pfam)
