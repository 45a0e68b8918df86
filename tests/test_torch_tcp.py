"""The port's TCP messenger against the JAX package's, on the CPU.

- the lossless-peer cases of ``test_tcp_lossless.py`` and the frame
  compression case of ``test_tool_compress_scrub.py``, on the port;
- the bytes on the wire: one message sequence sent by each package's
  ``TcpNetwork`` through a recording relay, with ``os.urandom`` pinned to
  one seeded stream and ``time.time`` to one instant, equal byte for
  byte (lossy, lossless with compression, and cephx-signed);
- a JAX ``TcpNetwork`` and a port ``TcpNetwork`` exchanging messages both
  ways across a link reset, exactly once and in order, with and without
  cephx (either package hosting the KDC).
"""
from __future__ import annotations

import os
import queue
import socket
import threading
import time

import numpy as np
import pytest

import ceph_tpu.auth as jauth
import ceph_tpu.msg.messages as jmsg
import ceph_tpu.msg.tcp as jtcp

import ceph_tpu_torch.auth as pauth
import ceph_tpu_torch.msg.messages as pmsg
import ceph_tpu_torch.msg.tcp as ptcp
from ceph_tpu_torch.msg.messenger import Dispatcher

NOW = 1_700_000_000.25
PKG = {"jax": (jtcp, jmsg, jauth), "port": (ptcp, pmsg, pauth)}


class _Sink(Dispatcher):
    def __init__(self):
        self.got = []

    def ms_fast_dispatch(self, msg):
        self.got.append(msg)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


class _Server:
    """Pump a net from a dedicated thread (it owns the net's fds);
    ``call`` runs a function there between two pumps."""

    def __init__(self, net):
        self.net = net
        self.stop = threading.Event()
        self.calls = queue.Queue()
        self.t = threading.Thread(target=self._run, daemon=True)
        self.t.start()

    def _run(self):
        while not self.stop.is_set():
            while not self.calls.empty():
                fn, done = self.calls.get()
                fn()
                done.set()
            self.net.pump(quiesce=0.01, deadline=0.1)

    def call(self, fn):
        done = threading.Event()
        self.calls.put((fn, done))
        assert done.wait(10.0)

    def close(self):
        self.stop.set()
        self.t.join(10.0)
        assert not self.t.is_alive()


def _kill_outbound(net):
    """Hard-close every outbound socket (TCP reset analog)."""
    for addr in list(net._conns):
        net._drop_conn(addr)


def _wait(cond, seconds, pump=None):
    end = time.monotonic() + seconds
    while time.monotonic() < end and not cond():
        if pump is not None:
            pump.pump(quiesce=0.02, deadline=0.3)
        else:
            time.sleep(0.02)
    return cond()


def _keyring(tmp_path, auth_mod, entities):
    kr = auth_mod.Keyring()
    for e in entities:
        kr.create(e)
    path = str(tmp_path / "keyring")
    kr.save(path)
    return path


# ---- the reference's cases, on the port --------------------------------

def test_daemon_links_are_lossless_across_resets():
    pa, pb = _free_port(), _free_port()
    directory = {"osd.0": ("127.0.0.1", pa), "osd.1": ("127.0.0.1", pb)}
    a = ptcp.TcpNetwork(("127.0.0.1", pa), directory, entity="osd.0")
    b = ptcp.TcpNetwork(("127.0.0.1", pb), directory, entity="osd.1")
    sink = _Sink()
    b.create_messenger("osd.1").add_dispatcher_head(sink)
    srv = _Server(b)
    try:
        for i in range(20):
            a.send("osd.0", "osd.1", pmsg.MMonPing(rank=i))
        a.pump(quiesce=0.02, deadline=2.0)
        _kill_outbound(a)                   # reset mid-stream
        for i in range(20, 40):
            a.send("osd.0", "osd.1", pmsg.MMonPing(rank=i))
        _wait(lambda: len(sink.got) >= 40, 15, a)
    finally:
        srv.close()
        a.close()
        b.close()
    assert [m.rank for m in sink.got] == list(range(40))


def test_unacked_resend_does_not_duplicate():
    pa, pb = _free_port(), _free_port()
    directory = {"mon": ("127.0.0.1", pa), "osd.1": ("127.0.0.1", pb)}
    a = ptcp.TcpNetwork(("127.0.0.1", pa), directory, entity="mon")
    b = ptcp.TcpNetwork(("127.0.0.1", pb), directory, entity="osd.1")
    sink = _Sink()
    b.create_messenger("osd.1").add_dispatcher_head(sink)
    srv = _Server(b)
    try:
        for round_no in range(5):
            base = round_no * 10
            for i in range(base, base + 10):
                a.send("mon", "osd.1", pmsg.MMonPing(rank=i))
            _wait(lambda: len(sink.got) >= base + 10, 10, a)
            _kill_outbound(a)               # without waiting for acks
        _wait(lambda: len(sink.got) >= 50, 10, a)
    finally:
        srv.close()
        a.close()
        b.close()
    assert [m.rank for m in sink.got] == list(range(50))


def test_client_links_stay_lossy():
    pa, dead = _free_port(), _free_port()
    directory = {"client.x": ("127.0.0.1", pa),
                 "osd.0": ("127.0.0.1", dead)}
    a = ptcp.TcpNetwork(("127.0.0.1", pa), directory, entity="client.x")
    try:
        before = a.dropped
        for i in range(5):
            a.send("client.x", "osd.0", pmsg.MMonPing(rank=i))
        a.pump(quiesce=0.01, deadline=2.0)
        assert a.dropped == before + 5
        assert not a._sess_tx
    finally:
        a.close()


def test_lossless_with_auth_signing(tmp_path):
    path = _keyring(tmp_path, pauth, ("mon", "osd.0", "osd.1"))
    pm, pa, pb = _free_port(), _free_port(), _free_port()
    directory = {"mon": ("127.0.0.1", pm), "osd.0": ("127.0.0.1", pa),
                 "osd.1": ("127.0.0.1", pb)}
    mon = ptcp.TcpNetwork(("127.0.0.1", pm), directory,
                          auth=ptcp.TcpAuth("mon", path, kdc=True))
    a = ptcp.TcpNetwork(("127.0.0.1", pa), directory,
                        auth=ptcp.TcpAuth("osd.0", path))
    b = ptcp.TcpNetwork(("127.0.0.1", pb), directory,
                        auth=ptcp.TcpAuth("osd.1", path))
    sink = _Sink()
    b.create_messenger("osd.1").add_dispatcher_head(sink)
    srv_mon, srv_b = _Server(mon), _Server(b)
    try:
        assert a.authenticate()
        assert b.authenticate()
        for i in range(15):
            a.send("osd.0", "osd.1", pmsg.MMonPing(rank=i))
        _wait(lambda: len(sink.got) >= 15, 10, a)
        _kill_outbound(a)
        for i in range(15, 30):
            a.send("osd.0", "osd.1", pmsg.MMonPing(rank=i))
        _wait(lambda: len(sink.got) >= 30, 15, a)
    finally:
        srv_mon.close()
        srv_b.close()
        for n in (mon, a, b):
            n.close()
    assert [m.rank for m in sink.got] == list(range(30))
    assert b.auth_rejects == 0


def test_rebooted_peer_seq_space_resets():
    pa, pb = _free_port(), _free_port()
    directory = {"osd.0": ("127.0.0.1", pa), "mon": ("127.0.0.1", pb)}
    mon_net = ptcp.TcpNetwork(("127.0.0.1", pb), directory, entity="mon")
    sink = _Sink()
    mon_net.create_messenger("mon").add_dispatcher_head(sink)
    srv = _Server(mon_net)
    a = ptcp.TcpNetwork(("127.0.0.1", pa), directory, entity="osd.0")
    try:
        for i in range(5):
            a.send("osd.0", "mon", pmsg.MMonPing(rank=i))
        a.pump(quiesce=0.02, deadline=2.0)
        assert _wait(lambda: len(sink.got) >= 5, 5)
        a.close()
        a = ptcp.TcpNetwork(("127.0.0.1", pa), directory, entity="osd.0")
        for i in range(5, 9):
            a.send("osd.0", "mon", pmsg.MMonPing(rank=i))
        a.pump(quiesce=0.02, deadline=2.0)
        _wait(lambda: len(sink.got) >= 9, 5, a)
        assert [m.rank for m in sink.got] == list(range(9))
    finally:
        srv.close()
        a.close()
        mon_net.close()


def test_tcp_frame_compression_roundtrip():
    """zlib frames flow between two port nets, one side compressing
    only: the receiver decodes by the frame's algorithm id."""
    pa, pb = _free_port(), _free_port()
    directory = {"a": ("127.0.0.1", pa), "b": ("127.0.0.1", pb)}
    na = ptcp.TcpNetwork(("127.0.0.1", pa), directory,
                         compression="zlib", compress_min=16)
    nb = ptcp.TcpNetwork(("127.0.0.1", pb), directory)
    try:
        ma, mb = na.create_messenger("a"), nb.create_messenger("b")
        got = []

        class Sink:
            def ms_fast_dispatch(self, m):
                got.append(m)

        mb.add_dispatcher_head(Sink())
        ma.add_dispatcher_head(Sink())
        big = b"x" * 4096
        ma.send_message(pmsg.MOSDOp(tid=1, oid="o", data=big), "b")
        for _ in range(20):
            na.pump(deadline=0.3)
            nb.pump(deadline=0.3)
            if got:
                break
        assert got and got[0].data == big
        got.clear()
        mb.send_message(pmsg.MOSDOpReply(tid=1, data=big), "a")
        for _ in range(20):
            nb.pump(deadline=0.3)
            na.pump(deadline=0.3)
            if got:
                break
        assert got and got[0].data == big
    finally:
        na.close()
        nb.close()


def test_frame_ids_and_sentinels_equal():
    for name in ("_AUTH_DLEN", "_SEQ_DLEN", "_ACK_DLEN", "_SESS_DLEN",
                 "_A_KDC_HELLO", "_A_KDC_CHALLENGE", "_A_KDC_PROVE",
                 "_A_KDC_REPLY", "_A_AUTHORIZER", "_A_AUTH_REPLY",
                 "_A_AUTH_HELLO", "_A_AUTH_CHALLENGE", "_S_HELLO",
                 "_S_HELLO_ACK", "_SIG_LEN", "_COMP_IDS",
                 "_DAEMON_SERVICES", "MAX_UNACKED"):
        assert getattr(ptcp, name) == getattr(jtcp, name), name
    assert ptcp._HDR.format == jtcp._HDR.format


# ---- the bytes on the wire ---------------------------------------------

class _Relay:
    """A TCP relay in front of ``target`` that records, per accepted
    connection, the bytes of each direction."""

    def __init__(self, target):
        self.target = target
        self.lsock = socket.socket()
        self.lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.lsock.bind(("127.0.0.1", 0))
        self.lsock.listen(4)
        self.port = self.lsock.getsockname()[1]
        self.conns = []                 # [{"up": bytearray, "down": ...}]
        self.socks = []
        self.threads = []
        self.t = threading.Thread(target=self._accept, daemon=True)
        self.t.start()

    def _accept(self):
        while True:
            try:
                c, _ = self.lsock.accept()
            except OSError:
                return
            u = socket.create_connection(self.target)
            rec = {"up": bytearray(), "down": bytearray()}
            self.conns.append(rec)
            self.socks += [c, u]
            for src, dst, key in ((c, u, "up"), (u, c, "down")):
                t = threading.Thread(target=self._copy,
                                     args=(src, dst, rec[key]),
                                     daemon=True)
                t.start()
                self.threads.append(t)

    @staticmethod
    def _copy(src, dst, buf):
        while True:
            try:
                data = src.recv(1 << 16)
            except OSError:
                data = b""
            if not data:
                try:
                    dst.shutdown(socket.SHUT_WR)
                except OSError:
                    pass
                return
            buf.extend(data)
            try:
                dst.sendall(data)
            except OSError:
                return

    def close(self):
        # shutdown, not close alone, wakes a thread blocked in accept
        # or recv on the socket
        for s in [self.lsock, *self.socks]:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            s.close()
        for t in self.threads + [self.t]:
            t.join(5.0)
            assert not t.is_alive()


def _frames(buf, signed):
    """Split a recorded stream into frames; acks (whose count depends
    on how the receiver's reads fell) are left out."""
    out, off, hdr = [], 0, jtcp._HDR
    while off + hdr.size <= len(buf):
        plen, dlen, op = hdr.unpack_from(buf, off)
        if dlen in (jtcp._AUTH_DLEN, jtcp._SESS_DLEN, jtcp._ACK_DLEN):
            n = hdr.size + plen
        elif dlen == jtcp._SEQ_DLEN:
            n = hdr.size + plen + (jtcp._SIG_LEN if signed else 0)
        else:
            n = hdr.size + dlen + plen + (jtcp._SIG_LEN if signed else 0)
        if dlen != jtcp._ACK_DLEN:
            out.append(bytes(buf[off:off + n]))
        off += n
    assert off == len(buf)
    return out


def _traffic(pkg, tmp_path, mode, seed=2024):
    """Send one fixed message sequence from ``pkg``'s net ``a`` to its
    net ``b`` through a relay; returns the relay's frames of each
    connection, per direction."""
    tcp, msg, auth_mod = PKG[pkg]
    ent = np.random.default_rng(seed)
    names = {"lossy": ("client.x", "osd.1"), "lossless": ("osd.0", "osd.1"),
             "signed": ("osd.0", "osd.1")}[mode]
    pm, pa, pb = _free_port(), _free_port(), _free_port()
    real = {"mon": ("127.0.0.1", pm), names[0]: ("127.0.0.1", pa),
            names[1]: ("127.0.0.1", pb)}
    relay = _Relay(real[names[1]])
    via = dict(real, **{names[1]: ("127.0.0.1", relay.port)})
    nets, servers = [], []
    orig_urandom = os.urandom
    os.urandom = lambda n: ent.integers(0, 256, n, dtype=np.uint8).tobytes()
    try:
        kw_a, kw_b = {"entity": names[0]}, {"entity": names[1]}
        if mode == "signed":
            path = _keyring(tmp_path, auth_mod, ("mon", *names))
            mon = tcp.TcpNetwork(real["mon"], real,
                                 auth=tcp.TcpAuth("mon", path, kdc=True))
            nets.append(mon)
            servers.append(_Server(mon))
            kw_a = {"auth": tcp.TcpAuth(names[0], path)}
            kw_b = {"auth": tcp.TcpAuth(names[1], path)}
        comp = {"compression": "zlib", "compress_min": 64} \
            if mode == "lossless" else {}
        a = tcp.TcpNetwork(real[names[0]], via, **comp, **kw_a)
        b = tcp.TcpNetwork(real[names[1]], real, **kw_b)
        nets += [a, b]
        sink = _Sink()
        b.create_messenger(names[1]).add_dispatcher_head(sink)
        if mode == "signed":
            assert b.authenticate() and a.authenticate()
        servers.append(_Server(b))
        sent = [msg.MMonPing(rank=i) for i in range(6)]
        sent += [msg.MOSDOp(tid=7 + i, oid=f"obj{i}",
                            data=bytes(range(256)) * (i + 1))
                 for i in range(3)]
        for m in sent:
            a.send(names[0], names[1], m)
        assert _wait(lambda: len(sink.got) >= len(sent), 15, a)
        a.pump(quiesce=0.05, deadline=1.0)
    finally:
        os.urandom = orig_urandom
        for s in servers:
            s.close()
        for n in nets:
            n.close()
        relay.close()
    assert [type(m).__name__ for m in sink.got] == \
        [type(m).__name__ for m in sent]
    signed = mode == "signed"
    return [{"up": _frames(c["up"], signed),
             "down": _frames(c["down"], signed)} for c in relay.conns]


@pytest.mark.parametrize("mode", ["lossy", "lossless", "signed"])
def test_frames_byte_equal(tmp_path, monkeypatch, mode):
    monkeypatch.setattr(time, "time", lambda: NOW)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    j = _traffic("jax", tmp_path / "jax", mode)
    p = _traffic("port", tmp_path / "port", mode)
    assert len(p) == len(j) == 1
    assert p == j
    ups = p[0]["up"]
    want = 9 + (mode != "lossy") + 2 * (mode == "signed")
    assert len(ups) == want
    if mode == "lossless":
        # the 4 KiB-plus payloads went compressed (comp id 1 = zlib)
        assert {jtcp._HDR.unpack_from(f, 0)[2] for f in ups[-3:]} == {1}


# ---- the two packages on one link --------------------------------------

def _both_ways(tmp_path, kdc=None):
    """JAX ``osd.0`` and port ``osd.1`` send 40 pings each way with a
    reset of each side's outbound link halfway; with ``kdc`` set, that
    package's mon hosts cephx and every frame is signed."""
    pm, pa, pb = _free_port(), _free_port(), _free_port()
    directory = {"mon": ("127.0.0.1", pm), "osd.0": ("127.0.0.1", pa),
                 "osd.1": ("127.0.0.1", pb)}
    nets, servers = [], []
    try:
        if kdc is not None:
            path = _keyring(tmp_path, PKG[kdc][2], ("mon", "osd.0", "osd.1"))
            mon = PKG[kdc][0].TcpNetwork(
                directory["mon"], directory,
                auth=PKG[kdc][0].TcpAuth("mon", path, kdc=True))
            nets.append(mon)
            servers.append(_Server(mon))
            kw = {n: {"auth": PKG[pkg][0].TcpAuth(n, path)}
                  for n, pkg in (("osd.0", "jax"), ("osd.1", "port"))}
        else:
            kw = {n: {"entity": n} for n in ("osd.0", "osd.1")}
        a = jtcp.TcpNetwork(directory["osd.0"], directory, **kw["osd.0"])
        b = ptcp.TcpNetwork(directory["osd.1"], directory, **kw["osd.1"])
        nets += [a, b]
        sinks = {"osd.0": _Sink(), "osd.1": _Sink()}
        a.create_messenger("osd.0").add_dispatcher_head(sinks["osd.0"])
        b.create_messenger("osd.1").add_dispatcher_head(sinks["osd.1"])
        if kdc is not None:
            assert a.authenticate() and b.authenticate()
        sa, sb = _Server(a), _Server(b)
        servers += [sa, sb]
        for half in (range(0, 20), range(20, 40)):
            for i in half:
                a.send("osd.0", "osd.1", jmsg.MMonPing(rank=i))
                b.send("osd.1", "osd.0", pmsg.MMonPing(rank=100 + i))
            assert _wait(lambda: len(sinks["osd.0"].got) >= half[-1] + 1
                         and len(sinks["osd.1"].got) >= half[-1] + 1, 20)
            if half[0] == 0:
                sa.call(lambda: _kill_outbound(a))
                sb.call(lambda: _kill_outbound(b))
    finally:
        for s in servers:
            s.close()
        for n in nets:
            n.close()
    assert [m.rank for m in sinks["osd.1"].got] == list(range(40))
    assert [m.rank for m in sinks["osd.0"].got] == list(range(100, 140))
    assert isinstance(sinks["osd.1"].got[0], pmsg.MMonPing)
    assert isinstance(sinks["osd.0"].got[0], jmsg.MMonPing)
    return a, b


@pytest.mark.parametrize("kdc", [None, "jax", "port"])
def test_jax_and_port_nets_share_a_link(tmp_path, kdc):
    a, b = _both_ways(tmp_path, kdc)
    assert a.auth_rejects == b.auth_rejects == 0
    if kdc is not None:
        assert a.auth.client.authenticated()
        assert b.auth.client.authenticated()
