"""The port's encodings against the archived corpus and the JAX package.

- Every blob under ``tests/corpus/encodings/`` (each ``M*`` message,
  ``OSDMap``, ``OSDMap::Incremental``, ``CrushWrapper`` and ``MonMap``)
  decodes through the port's dencoder registry and re-encodes byte for
  byte, as ``tests/test_encoding_corpus.py`` holds the JAX package's.
- The generated test objects of every registered type, built in each
  package by its own registry (the clock pinned, since ``build_simple``
  stamps ``created`` / ``modified``), encode to equal bytes, and each
  package decodes the other's bytes to an object that re-encodes alike.
- The dencoder's command stream gives equal output, errors and exit
  codes, and
  exported files are byte-equal.
- The TLV blob codec, the key/value codecs, ``MonMap`` and the messenger
  fabric (deliveries, drops by blackhole, drop hook and the ``msg.drop``
  fault site) agree with the JAX package's.

Tolerance: exact equality.
"""
import glob
import io
import os
import time
from contextlib import redirect_stderr, redirect_stdout

import pytest

from ceph_tpu.fault import g_faults as jfaults
from ceph_tpu.mon import monmap as jmonmap
from ceph_tpu.msg import kv as jkv
from ceph_tpu.msg import messages as jM
from ceph_tpu.msg import messenger as jmsgr
from ceph_tpu.msg import wire as jwire
from ceph_tpu.tools import dencoder as jden

from ceph_tpu_torch.fault import g_faults as tfaults
from ceph_tpu_torch.mon import monmap as tmonmap
from ceph_tpu_torch.msg import kv as tkv
from ceph_tpu_torch.msg import messages as tM
from ceph_tpu_torch.msg import messenger as tmsgr
from ceph_tpu_torch.msg import wire as twire
from ceph_tpu_torch.tools import dencoder as tden

DIR = os.path.join(os.path.dirname(__file__), "corpus", "encodings")
BLOBS = sorted(glob.glob(os.path.join(DIR, "*.bin")))
REG = tden._registry()
JREG = jden._registry()
CLOCK = 1750000000.5


def _type_for(path):
    stem = os.path.basename(path).rsplit(".", 2)[0]
    for name in REG:
        if name.replace(":", "_") == stem:
            return name
    return None


def test_registry_names_equal():
    assert sorted(REG) == sorted(JREG)
    assert len(BLOBS) >= 60
    assert {_type_for(p) for p in BLOBS} >= {
        "OSDMap", "OSDMap::Incremental", "CrushWrapper", "MonMap",
        "MOSDOp", "MOSDMap", "MOSDECSubOpWrite"}


@pytest.mark.parametrize("path", BLOBS,
                         ids=[os.path.basename(p) for p in BLOBS])
def test_archived_blob_round_trips(path):
    name = _type_for(path)
    assert name is not None, f"no registered type for {path}"
    h = REG[name]
    blob = open(path, "rb").read()
    obj = h.decode(blob)
    assert type(obj).__module__.startswith("ceph_tpu_torch.")
    assert h.encode(obj) == blob


@pytest.mark.parametrize("name", sorted(JREG))
def test_generated_objects_encode_alike(name, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: CLOCK)
    th, jh = REG[name], JREG[name]
    tt, jt = th.tests(), jh.tests()
    assert len(tt) == len(jt) > 0
    for a, b in zip(tt, jt):
        enc = th.encode(a)
        assert enc == jh.encode(b)
        assert th.encode(th.decode(enc)) == enc
        assert jh.encode(jh.decode(enc)) == enc


def _run(main, args):
    buf, err = io.StringIO(), io.StringIO()
    with redirect_stdout(buf), redirect_stderr(err):
        rc = main(list(args))
    return rc, buf.getvalue(), err.getvalue()


@pytest.mark.parametrize("args", [
    ["version"], ["list_types"], [],
    ["type", "MOSDOp", "count_tests"],
    ["type", "MOSDOp", "select_test", "2", "encode", "decode",
     "dump_json"],
    ["type", "CrushWrapper", "select_test", "1", "encode", "decode",
     "dump_json"],
    ["type", "MonMap", "select_test", "1", "encode", "copy", "encode",
     "dump_json"],
    ["type", "OSDMap::Incremental", "select_test", "2", "encode",
     "copy_ctor", "dump_json"],
    ["type", "MMonPaxos", "is_deterministic"],
    ["type", "NoSuchType"], ["decode"], ["type", "MOSDOp", "decode"],
    ["bogus-command"], ["type", "MOSDOp", "import"],
    ["type", "MOSDOp", "select_test", "foo"], ["skip", "abc"],
])
def test_dencoder_cli_equal(args):
    assert _run(tden.main, args) == _run(jden.main, args)


def test_dencoder_export_import_equal(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: CLOCK)
    out = {}
    for pkg, main in (("jax", jden.main), ("torch", tden.main)):
        enc = str(tmp_path / f"{pkg}.enc")
        osd = str(tmp_path / f"{pkg}.osdmap")
        assert _run(main, ["type", "MOSDECSubOpWrite", "select_test", "2",
                           "encode", "export", enc])[0] == 0
        assert _run(main, ["type", "OSDMap", "select_test", "1", "encode",
                           "export", osd])[0] == 0
        r = _run(main, ["type", "MOSDECSubOpWrite", "import", enc,
                        "decode", "dump_json"])
        wrong = _run(main, ["type", "MOSDOp", "import", enc, "decode"])
        out[pkg] = (open(enc, "rb").read(), open(osd, "rb").read(), r,
                    wrong[0])
    assert out["torch"] == out["jax"]
    assert out["torch"][3] == 1


def test_blob_and_kv_codecs_equal():
    values = [None, True, False, 0, -1, 2 ** 62, 1.5, "", "ä-ß",
              b"\x00\xff", bytearray(b"ab"), [1, [2, (3, "x")]],
              {"a": {1: [b"z", None]}, 7: (True, 0.25)}]
    for v in values:
        b = twire.encode_blob(v)
        assert b == jwire.encode_blob(v)
        assert twire.decode_blob(b) == jwire.decode_blob(b)
    kv = {"user.a": b"1", "": b"", "k" * 40: bytes(range(256))}
    assert tkv.pack_kv(kv) == jkv.pack_kv(kv)
    assert tkv.unpack_kv(tkv.pack_kv(kv)) == kv
    keys = ["a", "", "ä" * 3]
    assert tkv.pack_keys(keys) == jkv.pack_keys(keys)
    assert tkv.unpack_keys(tkv.pack_keys(keys)) == keys
    with pytest.raises(TypeError):
        twire.encode_blob(object())


def test_message_classes_equal():
    assert sorted(twire._MSG_CLASSES) == sorted(jwire._MSG_CLASSES)
    m = tM.MOSDOp(tid=7, oid="obj", pool=2)
    j = jM.MOSDOp(tid=7, oid="obj", pool=2)
    assert twire.encode_message(m) == jwire.encode_message(j)
    m.parent_span_id = 99
    assert twire.decode_message(twire.encode_message(m)).parent_span_id \
        == 99


def test_monmap_equal():
    maps = []
    for mod in (jmonmap, tmonmap):
        mm = mod.MonMap(fsid="00000000-1111-2222-3333-444444444444")
        for name, addr in (("c", "10.0.0.3:6789"), ("a", "10.0.0.1:6789"),
                           ("b", "10.0.0.1:6790")):
            mm.add(name, addr)
        mm.remove("c")
        mm.add("d", "10.0.0.2:3300")
        mm.created = mm.last_changed = CLOCK
        maps.append(mm)
    jm, tm = maps
    assert tm.to_bytes() == jm.to_bytes()
    assert tm.ranks() == jm.ranks()
    assert tm.print_lines() == jm.print_lines()
    back = tmonmap.MonMap.from_bytes(jm.to_bytes())
    assert back.to_bytes() == jm.to_bytes()


def _fabric(msgr, M, faults):
    """Six sends over a fabric with a blackholed link, a drop hook and the
    ``msg.drop`` site armed on every second ping; returns what each
    endpoint saw and the counters."""
    class Sink(msgr.Dispatcher):
        def __init__(self):
            self.got = []

        def ms_fast_dispatch(self, msg):
            self.got.append((type(msg).__name__, msg.src,
                             getattr(msg, "tid", None),
                             getattr(msg, "epoch", None)))
            if isinstance(msg, M.MOSDOp) and msg.tid == 1:
                # a reply sent from inside dispatch drains in the same pump
                self.reply.send_message(M.MOSDOpReply(tid=100 + msg.tid))

    net = msgr.Network()
    sinks = {}
    for name in ("osd.0", "osd.1", "client.0"):
        sinks[name] = Sink()
        net.create_messenger(name).add_dispatcher_head(sinks[name])
    sinks["osd.0"].reply = net.endpoints["osd.0"].get_connection("client.0")
    net.blackhole("client.0", "osd.1")
    net.drop_hook = lambda s, d, m: isinstance(m, M.MOSDOp) and m.tid == 3
    faults.inject("msg.drop", mode="nth", n=2, match="MOSDPing")
    try:
        c = net.endpoints["client.0"]
        for tid in range(1, 5):
            c.send_message(M.MOSDOp(tid=tid), "osd.0")
        c.send_message(M.MOSDOp(tid=9), "osd.1")
        for epoch in range(4):
            net.endpoints["osd.1"].send_message(M.MOSDPing(epoch=epoch),
                                                "osd.0")
        net.endpoints["osd.1"].send_message(M.MOSDPing(epoch=5), "mon.x")
        n = net.pump()
    finally:
        faults.clear()
    return ({k: s.got for k, s in sinks.items()}, n, net.delivered,
            net.dropped)


def test_messenger_fabric_equal():
    got = _fabric(tmsgr, tM, tfaults)
    assert got == _fabric(jmsgr, jM, jfaults)
    assert got[3] >= 4 and got[2] > 0
