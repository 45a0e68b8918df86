"""The port's object stores and PG log against the JAX package's, on the
CPU.

- ``WALStore``: the transaction sequences of ``tests/test_walstore.py``
  (replay after a kill, a clean unmount, a torn tail, a corrupt record,
  a checkpoint roll, an append after a torn tail, a failed apply, an
  unmounted store) through both packages, each in its own directory:
  equal final state (collections, objects, bodies, attrs, omaps, the
  committed count), equal ``fsck`` reports and byte-equal
  ``superblock.json``, ``checkpoint.bin`` and ``wal.bin`` after replay.
  The transaction codec gives equal bytes for every op.
- ``MemStore``: ``save`` files byte-equal; ``load`` round trips.
- A resident body: the port's ``DeviceShard`` on a CPU tensor, written
  with ``write_shard``, reads back byte-equal to the JAX store's
  ``DeviceShard`` (a jax array on its CPU platform); ``read_shard``
  returns the handle with no device-to-host copy accounted; the
  ``store.shard_corrupt`` fault flips the same byte in both; and a
  mounted ``WALStore`` refuses a ``write_shard`` in both packages
  (``KeyError``: the WAL's op codes have none) with nothing journaled.
- ``PGLog``: appends with trimming, ``rewind_to``, ``merge_authoritative``,
  ``split_into`` and ``load`` give equal entries and byte-equal staged
  transactions; the rollback and snapset codecs give equal bytes.

Tolerance: exact equality.
"""
import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.fault import g_faults as jfaults
from ceph_tpu.os_store import device_shard as jds
from ceph_tpu.os_store import memstore as jmem
from ceph_tpu.os_store import walstore as jwal
from ceph_tpu.osd import pg_log as jlog

from ceph_tpu_torch.fault import g_faults as tfaults
from ceph_tpu_torch.os_store import device_shard as tds
from ceph_tpu_torch.os_store import memstore as tmem
from ceph_tpu_torch.os_store import parse_pg_from_cid
from ceph_tpu_torch.os_store import walstore as twal
from ceph_tpu_torch.osd import pg_log as tlog
from ceph_tpu_torch.trace import g_devprof as tdevprof

PKG = {"jax": (jmem, jwal), "torch": (tmem, twal)}


def _txn(mem, i):
    """``tests/test_walstore.py``'s transaction."""
    t = mem.Transaction()
    cid = "0.0s0"
    oid = mem.hobject_t(f"obj{i}", 0)
    t.create_collection(cid)
    t.write(cid, oid, 0, bytes([i % 256]) * 64)
    t.setattr(cid, oid, "v", struct.pack("<Q", i))
    t.omap_setkeys(cid, oid, {f"k{i}": b"val"})
    return t


def _all_ops(mem):
    t = mem.Transaction()
    t.create_collection("1.2s3")
    o = mem.hobject_t("x", 3)
    t.touch("1.2s3", o)
    t.write("1.2s3", o, 7, b"hello")
    t.zero("1.2s3", o, 2, 3)
    t.truncate("1.2s3", o, 9)
    t.setattr("1.2s3", o, "a", b"\x00\xff")
    t.rmattr("1.2s3", o, "a")
    t.omap_setkeys("1.2s3", o, {"k2": b"", "k1": b"v1"})
    t.omap_rmkeys("1.2s3", o, ["k1"])
    t.remove("1.2s3", o)
    t.remove_collection("1.2s3")
    return t


def state(s):
    """Everything a store holds, as plain values."""
    out = {}
    for cid in s.list_collections():
        objs = {}
        for ho in s.list_objects(cid):
            objs[(ho.oid, ho.shard)] = (s.read(cid, ho),
                                        sorted(s.getattrs(cid, ho).items()),
                                        sorted(s.omap_get(cid, ho).items()))
        out[cid] = objs
    return s.committed_txns, out


def files(d):
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d))}


# ---- WAL sequences ----------------------------------------------------------

def seq_replay(mem, wal, d):
    s = wal.mount_store(d)
    for i in range(10):
        s.queue_transaction(_txn(mem, i))
    s._wal_f.close()                    # kill -9: no umount
    return wal.mount_store(d)


def seq_umount(mem, wal, d):
    s = wal.mount_store(d)
    for i in range(5):
        s.queue_transaction(_txn(mem, i))
    s.umount()
    return wal.mount_store(d)


def seq_torn(mem, wal, d):
    s = wal.mount_store(d)
    for i in range(6):
        s.queue_transaction(_txn(mem, i))
    s._wal_f.close()
    p = os.path.join(d, "wal.bin")
    with open(p, "r+b") as f:
        f.truncate(os.path.getsize(p) - 11)
    return wal.mount_store(d)


def seq_corrupt(mem, wal, d):
    s = wal.mount_store(d)
    for i in range(4):
        s.queue_transaction(_txn(mem, i))
    s._wal_f.close()
    p = os.path.join(d, "wal.bin")
    buf = bytearray(open(p, "rb").read())
    _magic, _seq, ln, _crc = wal._HDR.unpack_from(buf, 0)
    buf[wal._HDR.size + ln + wal._HDR.size + 5] ^= 0xFF
    open(p, "wb").write(bytes(buf))
    seq_corrupt.fsck = wal.WALStore(d).fsck()
    return wal.mount_store(d)


def seq_roll(mem, wal, d):
    s = wal.WALStore(d, wal_max_bytes=2048)
    s.mount()
    for i in range(40):
        s.queue_transaction(_txn(mem, i))
    s._wal_f.close()
    return wal.mount_store(d)


def seq_torn_then_append(mem, wal, d):
    s = seq_torn(mem, wal, d)
    s.queue_transaction(_txn(mem, 100))
    s.queue_transaction(_txn(mem, 101))
    s._wal_f.close()
    return wal.mount_store(d)


def seq_failed_apply(mem, wal, d):
    s = wal.mount_store(d)
    s.queue_transaction(_txn(mem, 0))
    bad = mem.Transaction()
    bad.rmattr("no_such_coll", mem.hobject_t("x"), "a")
    with pytest.raises(KeyError):
        s.queue_transaction(bad)
    s.queue_transaction(_txn(mem, 1))
    s._wal_f.close()
    return wal.mount_store(d)


def seq_unmounted(mem, wal, d):
    s = wal.WALStore(d)
    s.queue_transaction(_txn(mem, 0))
    os.makedirs(d, exist_ok=True)
    return s


SEQS = [seq_replay, seq_umount, seq_torn, seq_corrupt, seq_roll,
        seq_torn_then_append, seq_failed_apply, seq_unmounted]


@pytest.mark.parametrize("seq", SEQS, ids=[f.__name__[4:] for f in SEQS])
def test_wal_sequences_equal(seq, tmp_path):
    got = {}
    for pkg, (mem, wal) in PKG.items():
        d = str(tmp_path / pkg)
        s = seq(mem, wal, d)
        fsck = getattr(seq, "fsck", None)
        got[pkg] = (state(s), s.fsck(), fsck, files(d))
        if s._wal_f is not None:
            s._wal_f.close()
    assert got["torch"] == got["jax"]
    (n, colls), report, _pre, blobs = got["torch"]
    assert n > 0 and colls
    assert report["ok"] is not False or seq is seq_corrupt


def test_txn_codec_bytes_equal():
    jb = jwal.encode_txn(_all_ops(jmem))
    assert twal.encode_txn(_all_ops(tmem)) == jb
    assert twal.decode_txn(jb).ops == _all_ops(tmem).ops
    assert twal.encode_txn(twal.decode_txn(jb)) == jb


def test_memstore_save_load_equal(tmp_path):
    blobs = {}
    for pkg, (mem, _wal) in PKG.items():
        s = mem.MemStore()
        for i in range(6):
            s.queue_transaction(_txn(mem, i))
        t = mem.Transaction()
        t.truncate("0.0s0", mem.hobject_t("obj2", 0), 10)
        t.zero("0.0s0", mem.hobject_t("obj3", 0), 60, 10)
        t.remove("0.0s0", mem.hobject_t("obj4", 0))
        s.queue_transaction(t)
        p = str(tmp_path / f"{pkg}.bin")
        s.save(p)
        blobs[pkg] = open(p, "rb").read()
        assert state(mem.MemStore.load(p)) == state(s)
    assert blobs["torch"] == blobs["jax"]


def test_parse_pg_from_cid_equal():
    from ceph_tpu.os_store import parse_pg_from_cid as jparse
    for cid in ("1.2", "1.2s3", "1.2s3_meta", "12.ff_meta", "meta",
                "a.b", "1.2.3", "3.7s0"):
        assert parse_pg_from_cid(cid) == jparse(cid)


# ---- resident bodies --------------------------------------------------------

BODY = np.random.default_rng(3).integers(0, 256, 4096, dtype=np.uint8)


def _shards():
    crc = 0x1234
    return (jds.DeviceShard(jnp.asarray(BODY), BODY.size, crc),
            tds.DeviceShard(torch.from_numpy(BODY.copy()), BODY.size, crc))


def _store_with(mem, shard):
    s = mem.MemStore()
    t = mem.Transaction()
    t.create_collection("2.5s1")
    t.write_shard("2.5s1", mem.hobject_t("obj", 1), shard)
    t.setattr("2.5s1", mem.hobject_t("obj", 1), "hinfo", b"h")
    s.queue_transaction(t)
    return s


def _d2h(devprof, site):
    return devprof.dump()["sites"].get(site, {}).get("d2h_bytes", 0)


def test_resident_body_read_and_read_shard():
    jsh, tsh = _shards()
    js, ts = _store_with(jmem, jsh), _store_with(tmem, tsh)
    ho = tmem.hobject_t("obj", 1)
    before = _d2h(tdevprof, "memstore.fetch_shard")
    h = ts.read_shard("2.5s1", ho)
    assert h is tsh and h.is_resident
    assert _d2h(tdevprof, "memstore.fetch_shard") == before
    assert ts.stat("2.5s1", ho) == js.stat("2.5s1", jmem.hobject_t("obj", 1))
    # a ranged read materializes: one accounted copy, then host bytes
    assert ts.read("2.5s1", ho, 100, 50) == \
        js.read("2.5s1", jmem.hobject_t("obj", 1), 100, 50) == \
        BODY[100:150].tobytes()
    assert _d2h(tdevprof, "memstore.fetch_shard") == before + BODY.size
    assert not tsh.is_resident
    assert isinstance(ts.read_shard("2.5s1", ho), tds.DeviceShard)
    # a byte-granular write materializes the body first
    for mem, s in ((jmem, js), (tmem, ts)):
        t = mem.Transaction()
        t.write("2.5s1", mem.hobject_t("obj", 1), 10, b"xyz")
        s.queue_transaction(t)
    assert state(ts) == state(js)


def test_shard_corrupt_fault_on_resident_body():
    jsh, tsh = _shards()
    js, ts = _store_with(jmem, jsh), _store_with(tmem, tsh)
    try:
        for faults in (jfaults, tfaults):
            faults.inject("store.shard_corrupt", mode="once",
                          match="2.5s1/obj(1)")
        h = ts.read_shard("2.5s1", tmem.hobject_t("obj", 1))
        jh = js.read_shard("2.5s1", jmem.hobject_t("obj", 1))
        assert h.is_resident
        assert bytes(h) == bytes(jh) != BODY.tobytes()
        assert bytes(h)[0] == BODY[0] ^ 1 and bytes(h)[1:] == \
            BODY[1:].tobytes()
        # once: the next read sees the same (already rotted) body
        assert ts.read("2.5s1", tmem.hobject_t("obj", 1)) == bytes(h)
    finally:
        jfaults.clear()
        tfaults.clear()


def test_mounted_walstore_refuses_write_shard(tmp_path):
    """The WAL's op codes have no entry for a resident body, in both
    packages: the commit raises before anything is journaled."""
    jsh, tsh = _shards()
    got = {}
    for (pkg, (mem, wal)), shard in zip(PKG.items(), (jsh, tsh)):
        d = str(tmp_path / pkg)
        s = wal.mount_store(d)
        s.queue_transaction(_txn(mem, 0))
        t = mem.Transaction()
        t.write_shard("0.0s0", mem.hobject_t("res", 0), shard)
        with pytest.raises(KeyError):
            s.queue_transaction(t)
        s._wal_f.close()
        got[pkg] = (state(wal.mount_store(d)), files(d))
    assert got["torch"] == got["jax"]
    assert got["torch"][0][0] == 1


# ---- PG log -----------------------------------------------------------------

def _log_run(mem, log):
    """A PG log's life on one store; returns what to compare."""
    s = mem.MemStore()
    cid, ccid = "1.0s0", "1.4s0"
    t = mem.Transaction()
    t.create_collection(cid)
    t.create_collection(ccid)
    s.queue_transaction(t)
    pl = log.PGLog(max_entries=8)
    staged = []
    for v in range(1, 15):
        t = mem.Transaction()
        op = log.OP_DELETE if v % 5 == 0 else log.OP_MODIFY
        pl.append(log.LogEntry(v, f"o{v % 6}", op), t, cid)
        if v % 4 == 0:
            log.stage_rollback(t, cid, f"o{v % 6}", log.encode_rollback(
                v - 1, v % 3 == 0, bytes([v]) * v, {"a": b"1", "bb": b""}))
        if v % 7 == 0:
            log.stage_snapset(t, cid, f"o{v % 6}", log.encode_snapset(
                [(v, log.SNAP_CLONE), (v + 1, log.SNAP_WHITEOUT)]))
        staged.append(t)
        s.queue_transaction(t)
    t = mem.Transaction()
    dropped = pl.rewind_to(12, t, cid)
    log.clear_rollback(t, cid, "o0")
    log.stage_snapset(t, cid, "o0", b"")
    staged.append(t)
    s.queue_transaction(t)
    t = mem.Transaction()
    pl.merge_authoritative([log.LogEntry(v, f"p{v}", log.OP_MODIFY)
                            for v in range(11, 16)], t, cid)
    staged.append(t)
    s.queue_transaction(t)
    child = log.PGLog(max_entries=8)
    tp, tc = mem.Transaction(), mem.Transaction()
    pl.split_into(child, {"o1", "o3", "p14"}, tp, cid, tc, ccid)
    staged += [tp, tc]
    s.queue_transaction(tp)
    s.queue_transaction(tc)
    loaded, cloaded = log.PGLog(), log.PGLog()
    loaded.load(s, cid)
    cloaded.load(s, ccid)
    enc = (jwal if mem is jmem else twal).encode_txn
    return {
        "staged": [enc(t) for t in staged],
        "dropped": [(e.version, e.oid, e.op) for e in dropped],
        "logs": [[(e.version, e.oid, e.op) for e in g.entries]
                 + [g.head, g.tail] for g in (pl, child, loaded, cloaded)],
        "missing": [pl.missing_after(v) for v in (0, 9, 13)],
        "rollback": [log.load_rollback(s, cid, f"o{i}") for i in range(6)],
        "snapsets": log.load_snapsets(s, cid),
        "state": state(s),
    }


def test_pg_log_equal():
    got = _log_run(tmem, tlog)
    assert got == _log_run(jmem, jlog)
    assert got["dropped"] and got["logs"][1][:-2]
    assert any(r is not None for r in got["rollback"])


@pytest.mark.parametrize("exists", [True, False])
def test_rollback_and_snapset_codecs_equal(exists):
    attrs = {"_size": struct.pack("<Q", 77), "user.x": b"\x00" * 5, "e": b""}
    blob = tlog.encode_rollback(42, exists, bytes(range(77)), attrs)
    assert blob == jlog.encode_rollback(42, exists, bytes(range(77)), attrs)
    assert tlog.decode_rollback(blob) == jlog.decode_rollback(blob) == \
        (42, exists, bytes(range(77)), attrs)
    ents = [(1, tlog.SNAP_CLONE), (5, tlog.SNAP_WHITEOUT),
            (2 ** 40, tlog.SNAP_TRIMMED)]
    sb = tlog.encode_snapset(ents)
    assert sb == jlog.encode_snapset(ents)
    assert tlog.decode_snapset(sb) == jlog.decode_snapset(sb) == ents
    e = tlog.LogEntry(2 ** 33, "obj/ä", tlog.OP_DELETE)
    assert e.encode() == jlog.LogEntry(2 ** 33, "obj/ä",
                                       jlog.OP_DELETE).encode()
    assert tlog.LogEntry.decode(e.encode()) == e
