"""A replaced disk's rebuild makes the same codec calls in both packages.

The daemons of each package (``chip_smoke.Daemons``: 12 OSDs, one per
host, an EC pool of k=8, m=4 with 16 PGs) hold 16 objects; the OSDs at
shards 1 and 9 of obj0's PG go down, and one of them gets an empty disk
under the same id.  Recovery rebuilds its shard of every object: one
``decode_batch`` per object, and inside it one survivor-matrix decode
(``decode_data``, K1 once on the card) where a data row is lost and one
re-encode (``encode``, K1 once) where a parity shard is rebuilt.  With the
second OSD still down a rebuilt parity shard needs both, so a rebuild
launches K1 once or twice per object; the counts are equal between the
packages call for call.
"""
import collections
import importlib

import numpy as np

import chip_smoke

from torch_daemon_twin import JAX, PORT, clean, profile  # noqa: F401

N_OBJ, OBJ_BYTES = 16, 1 << 14
COUNTED = {"ec.matrix_plugin": ("ErasureCodeMatrixRS", ("decode_batch",)),
           "ops.gf_matmul": ("DeviceRSBackend", ("decode_data", "encode"))}


def rebuild_calls(pkg, monkeypatch):
    calls = collections.Counter()
    for mod, (cls_name, meths) in COUNTED.items():
        cls = getattr(importlib.import_module(f"{pkg}.{mod}"), cls_name)
        for meth in meths:
            orig = getattr(cls, meth)

            def counted(*a, _orig=orig, _name=f"{cls_name}.{meth}", **kw):
                calls[_name] += 1
                return _orig(*a, **kw)
            monkeypatch.setattr(cls, meth, counted)
    d = chip_smoke.Daemons(pkg, 12)
    d.create_ec_pool("ec", profile(pkg, k=8, m=4), 16)
    cl = d.client()
    rng = np.random.default_rng(1616)
    objs = {f"obj{i}": rng.integers(0, 256, OBJ_BYTES,
                                    dtype=np.uint8).tobytes()
            for i in range(N_OBJ)}
    for oid, body in objs.items():
        assert cl.write_full("ec", oid, body) == 0
    acting = chip_smoke.acting_of(d, cl, "ec", "obj0")
    victims = [acting[1], acting[9]]
    for o in victims:
        d.kill_osd(o)
    for _ in range(10):
        d.tick(6.0)
        if all(not d.mon.osdmap.is_up(o) for o in victims):
            break
    calls.clear()
    d.replace_osd(victims[0])
    for _ in range(4):
        d.tick(1.0)
    rebuilt = chip_smoke.stored_bodies(d, d.mon.osdmap.lookup_pg_pool_name(
        "ec"), keys_only=True)
    d.shutdown()
    monkeypatch.undo()
    return dict(calls), sum(1 for o in objs for s in range(12)
                            if (o, s) in rebuilt)


def test_replaced_disk_rebuild_makes_the_same_codec_calls(clean,
                                                          monkeypatch):
    port, port_held = rebuild_calls(PORT, monkeypatch)
    jax, jax_held = rebuild_calls(JAX, monkeypatch)
    assert port == jax
    assert port_held == jax_held == N_OBJ * 11     # all but the down OSD's
    assert port["ErasureCodeMatrixRS.decode_batch"] == N_OBJ
    k1 = port["DeviceRSBackend.decode_data"] + port["DeviceRSBackend.encode"]
    assert N_OBJ <= k1 <= 2 * N_OBJ
