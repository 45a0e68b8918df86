"""The port's monitor against the JAX package's, on the CPU.

Both packages' daemons are built by ``chip_smoke.Daemons``.  The
monitors must commit the same epochs and the same incrementals (compared
as ``incremental_to_dict``) for bootstrap, EC profile and pool creation,
mark down / out / in, the config-key and fsmap services and a 3-mon
quorum that loses its leader.  The EC profiles name each package's
plugin (``tpu`` there, ``cuda`` with ``backend=host`` here): that is the
only difference allowed.  ``save`` / ``load`` round-trip the port's map
history.
"""
import importlib
import json

from torch_daemon_twin import clean  # noqa: F401 (a fixture)
from torch_daemon_twin import JAX, PLUGIN, PORT, boot, payloads


POOL = "ecpool"


def _unplug(obj):
    """A dict tree with every EC profile's plugin and backend keys
    taken out (the one place the two packages differ by design)."""
    if isinstance(obj, dict):
        if "plugin" in obj and obj.get("plugin") in ("tpu", "cuda"):
            obj = {k: v for k, v in obj.items()
                   if k not in ("plugin", "backend")}
        return {k: _unplug(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_unplug(v) for v in obj]
    return obj


def _incs(d):
    enc = importlib.import_module(d.pkg + ".osdmap.encoding")
    return [_unplug(enc.incremental_to_dict(i))
            for i in d.mon.incrementals]


def _map(d):
    enc = importlib.import_module(d.pkg + ".osdmap.encoding")
    return _unplug(enc.osdmap_to_dict(d.mon.osdmap))


def test_bootstrap_pool_and_marks_commit_what_jax_commits(clean):
    out = {}
    for pkg in (JAX, PORT):
        d, cl = boot(pkg)
        assert cl.write_full(POOL, "o", b"x" * 5000) == 0
        steps = [d.mon.osdmap.epoch]
        d.mark_osd_down(3)
        steps.append(d.mon.osdmap.epoch)
        d.mark_osd_out(3)
        steps.append(d.mon.osdmap.epoch)
        d.mark_osd_in(3)
        steps.append(d.mon.osdmap.epoch)
        d.revive_osd(3)
        steps.append(d.mon.osdmap.epoch)
        cl.mon_command("config_key_set", key="k1", value="v1")
        assert cl.mon_command("config_key_get", key="k1") == "v1"
        fs = cl.mon_command("fs_status")
        out[pkg] = (steps, _incs(d), _map(d), fs,
                    d.mon.config_key_dump(), d.mon.quorum_status())
        assert d.osds[0].osdmap.epoch == d.mon.osdmap.epoch
        d.shutdown()
    assert out[JAX][0] == out[PORT][0]
    assert len(set(out[PORT][0])) == len(out[PORT][0])   # each step commits
    assert out[JAX][1] == out[PORT][1]
    assert out[JAX][2] == out[PORT][2]
    assert out[JAX][3:] == out[PORT][3:]


def test_three_mons_lose_their_leader_as_jax_does(clean):
    """A 3-mon quorum elects rank 0, replicates every epoch, and after
    rank 0 dies elects rank 1, which goes on committing; a client of the
    new leader writes, and both objects read back."""
    objs = payloads(2, seed=11)
    out = {}
    for pkg in (JAX, PORT):
        d, cl = boot(pkg, n_mons=3)
        assert d.mon.name == "mon.0" and d.mon.quorum == {0, 1, 2}
        for m in d.mons:
            assert m.osdmap.epoch == d.mons[0].osdmap.epoch
        assert cl.write_full(POOL, "obj0", objs["obj0"]) == 0
        before = d.mon.osdmap.epoch
        d.kill_mon(0)
        for _ in range(6):
            d.tick(6.0)
        leader = d.mon
        assert leader.name == "mon.1" and leader.is_leader()
        d.mark_osd_out(5)
        d.tick(1.0, rounds=2)
        assert leader.osdmap.epoch > before
        cl = d.client("client.1")          # bound to the new leader
        assert cl.write_full(POOL, "obj1", objs["obj1"]) == 0
        for oid, body in objs.items():
            assert cl.read(POOL, oid) == body, (pkg, oid)
        out[pkg] = (leader.name, sorted(leader.quorum),
                    [m.osdmap.epoch for m in d.mons], _incs(d), _map(d))
        d.shutdown()
    assert out[JAX] == out[PORT]


def test_save_load_round_trip(clean, tmp_path):
    """``save`` writes the map history; a fresh monitor's ``load``
    replays it to the same map.  The saved history equals the JAX
    monitor's but for the plugin names and the MonMap's creation
    stamps."""
    saved = {}
    for pkg in (JAX, PORT):
        d, _cl = boot(pkg)
        d.mark_osd_out(2)
        path = tmp_path / f"{pkg}.json"
        d.mon.save(str(path))
        msg = importlib.import_module(pkg + ".msg")
        mon_mod = importlib.import_module(pkg + ".mon.monitor")
        fresh = mon_mod.Monitor(msg.Network())
        fresh.load(str(path))
        enc = importlib.import_module(pkg + ".osdmap.encoding")
        assert enc.osdmap_to_dict(fresh.osdmap) == \
            enc.osdmap_to_dict(d.mon.osdmap)
        saved[pkg] = _unplug(json.loads(path.read_text()))
        d.shutdown()
    # the MonMap stamps its wall-clock creation time: compare the rest
    monmaps = [json.loads(saved[p].pop("monmap").split("\x01", 1)[1])
               for p in (JAX, PORT)]
    for m in monmaps:
        m.pop("created")
        m.pop("last_changed")
    assert monmaps[0] == monmaps[1]
    assert saved[JAX] == saved[PORT]


def test_monitor_validates_the_port_profile(clean):
    """The monitor instantiates the codec to validate a profile: the
    port's registry answers for ``cuda`` (with ``backend=host`` here)
    and for ``regenerating``, whose pool takes the codec's stripe width
    as the JAX monitor's does."""
    widths = {}
    for pkg in (JAX, PORT):
        d, _cl = boot(pkg)
        d.mon.create_ec_profile("regen", {
            **PLUGIN[pkg], "plugin": "regenerating", "k": "4", "m": "2",
            "d": "5", "crush-failure-domain": "host"})
        pid = d.mon.create_ec_pool("rp", "regen", 8)
        widths[pkg] = d.mon.osdmap.pools[pid].stripe_width
        d.shutdown()
    assert widths[JAX] == widths[PORT]
