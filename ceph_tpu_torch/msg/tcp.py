"""TCP messenger — the cross-process transport (AsyncMessenger role).

The reference runs epoll-driven AsyncMessengers speaking a framed wire
protocol between daemon processes (src/msg/async/AsyncMessenger.h:74);
this is the equivalent thin shim: a ``TcpNetwork`` extends the in-process
fabric so entities living in *other* processes are reachable through
length-prefixed wire frames (msg/wire.py) over plain sockets.

Topology is static like a mon map: every process knows the
entity -> (host, port) directory.  Local sends short-circuit through the
in-process queue; remote sends frame and ship.  ``pump()`` drains both
the local queue and any readable sockets until traffic quiesces, so the
callers' deterministic pump loops keep working across processes.

The port's own copy of ``ceph_tpu/msg/tcp.py``.  Its frames are
byte-equal with the JAX messenger's, so daemons of either package can
share a socket.
"""
from __future__ import annotations

import os
import socket
import struct
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from .messenger import Network
from .messages import Message
from .wire import decode_blob, decode_message, encode_blob, encode_message

_HDR = struct.Struct("<I H B")   # frame length, dst-name length, comp algo

# auth control frames reuse the MSG header with a dst-name-length
# sentinel no real name can reach; the comp byte carries the opcode
_AUTH_DLEN = 0xFFFF
_A_KDC_HELLO, _A_KDC_CHALLENGE, _A_KDC_PROVE, _A_KDC_REPLY = 1, 2, 3, 4
_A_AUTHORIZER, _A_AUTH_REPLY = 5, 6
_A_AUTH_HELLO, _A_AUTH_CHALLENGE = 7, 8
_SIG_LEN = 8                     # per-frame HMAC trailer when authed

# lossless-session frames (Messenger Policy lossless_peer role):
# 0xFFFD = seq-wrapped message, 0xFFFC = ack, 0xFFFB = session hello
_SEQ_DLEN, _ACK_DLEN, _SESS_DLEN = 0xFFFD, 0xFFFC, 0xFFFB
_S_HELLO, _S_HELLO_ACK = 1, 2
_DAEMON_SERVICES = ("mon", "osd", "mgr")
MAX_UNACKED = 10000              # per-peer resend-queue bound


class _AuthFailed(Exception):
    pass


class TcpAuth:
    """Per-process auth state for a TcpNetwork (cephx on the wire).

    ``entity`` is the process's principal; its secret comes from the
    keyring file.  The mon process passes ``kdc=True`` and the FULL
    keyring — it hosts the CephxServer and answers KDC frames on its
    unauthenticated inbound sockets (the cephx bootstrap path).
    Daemons/clients hold only their own entry.

    Caveat vs the reference: a process authenticates as ONE principal,
    so inbound src names are enforced at service granularity
    (client.* may not claim osd.*), not per-entity.

    The mons of a multi-mon cluster pass their roster as ``quorum``: every
    one of them is a KDC, and they share the rotating service secrets, as
    the reference's AuthMonitor replicates them through paxos; here each
    derives them from the roster's mon keys, which the full keyring holds.
    So a ticket any of them issues verifies on every daemon, whichever mon
    leads.
    """

    def __init__(self, entity: str, keyring_path: str, kdc: bool = False,
                 quorum: Tuple[str, ...] = ()):
        from ..auth import (CephxClient, CephxServer,
                            CephxServiceVerifier, Keyring, entity_service)
        keyring = Keyring.load(keyring_path)
        secret = keyring.get(entity)
        if secret is None:
            raise ValueError(f"keyring has no key for {entity!r}")
        self.entity = entity
        self.service = entity_service(entity)
        self.client = CephxClient(entity, secret)
        self.server: Optional[CephxServer] = None
        self.verifier: Optional[CephxServiceVerifier] = None
        if kdc:
            self.server = CephxServer(keyring)
            if quorum:
                from ..auth.crypto import SECRET_LEN, hmac_tag
                seed = b"".join(keyring.get(m) for m in sorted(quorum))
                for svc, secrets in self.server.rotating.items():
                    for sid, (_sec, exp) in list(secrets.items()):
                        secrets[sid] = (hmac_tag(seed, svc.encode(),
                                                 SECRET_LEN), exp)
            # the mon authenticates itself against its own KDC in-memory
            ch = self.server.get_challenge(entity)
            cch, proof = self.client.make_proof(ch)
            self.client.handle_reply(
                self.server.authenticate(entity, ch, cch, proof))
            self.ensure_verifier()

    def ensure_verifier(self) -> None:
        """Build (or refresh) the service verifier from the latest
        rotating keys the KDC handed us."""
        if self.service not in self.client.rotating:
            return
        from ..auth import CephxServiceVerifier
        if self.verifier is None:
            self.verifier = CephxServiceVerifier(
                self.service, self.client.rotating[self.service])
        else:
            self.verifier.update_rotating(
                self.client.rotating[self.service])

# frame compression algorithm ids (Compressor::COMP_ALG_* role); the
# receiver decodes by the frame's id, so peers may use different configs
_COMP_IDS = {"none": 0, "zlib": 1, "snappy": 2, "zstd": 3, "lz4": 4}
_COMP_NAMES = {v: k for k, v in _COMP_IDS.items()}


class TcpNetwork(Network):
    """One per process: hosts local entities, routes to remote ones.

    ``compression`` compresses outbound frame payloads at least
    ``compress_min`` bytes long (ms_compress role; BlueStore-style
    plugin via the port's compressor/)."""

    def __init__(self, listen_addr: Tuple[str, int],
                 directory: Dict[str, Tuple[str, int]],
                 compression: str = "none", compress_min: int = 1024,
                 auth: Optional[TcpAuth] = None,
                 entity: Optional[str] = None):
        super().__init__()
        from ..compressor import create_compressor
        self.auth = auth
        # outbound socket -> session key; inbound socket -> state dict
        self._out_sk: Dict[socket.socket, bytes] = {}
        self._in_auth: Dict[socket.socket, Dict] = {}
        self.auth_rejects = 0
        # ---- lossless-peer session state (msg/Messenger.h Policy) ----------
        # the process principal decides the policy: daemon<->daemon
        # links are lossless (seq + ack + reconnect-resend), anything
        # involving a client stays lossy (drop on broken socket)
        self.local_entity = entity or (auth.entity if auth else None)
        # dst -> {next_seq, unacked deque[(seq, frame)], sock, retry_at,
        #         backoff}
        self._sess_tx: Dict[str, Dict] = {}
        # peer entity -> highest seq delivered (survives reconnects)
        self._sess_rx: Dict[str, int] = {}
        # this process's session incarnation.  A rebooted daemon restarts
        # its send seqs at 1; without an incarnation check the old
        # session's high-water mark at the receiver silently swallows
        # every post-reboot frame as a duplicate, AND the stale hello
        # ack makes the newcomer trim its queue as already-delivered.
        # The reference detects this as a peer reset in the connect
        # handshake (msg/simple/Pipe.cc "existing connection reset",
        # addr nonce + connect_seq) and zeroes in_seq the same way.
        import os as _os
        # 63 bits: the wire TLV int is signed 64-bit
        self._sess_nonce = (int.from_bytes(_os.urandom(8), "little")
                            >> 1) | 1
        # peer entity -> the incarnation its _sess_rx entry belongs to
        self._sess_rx_nonce: Dict[str, int] = {}
        # inbound socket -> peer entity (from session hello)
        self._sess_peer: Dict[socket.socket, str] = {}
        # outbound socket -> dst name (for routing acks back to tx state)
        self._sock_dst: Dict[socket.socket, str] = {}
        # sockets mid-handshake: _poll_sockets must not read them
        self._handshaking: set = set()
        # outbound socket -> rx buffer (ack frames from the peer)
        self._obuf: Dict[socket.socket, bytearray] = {}
        self.dup_dropped = 0
        self.resent = 0
        self.compression = compression
        self.compress_min = compress_min
        self._comp = create_compressor(compression)
        self._comp_id = _COMP_IDS[compression]
        self._decomps = {0: create_compressor("none")}
        self.directory = dict(directory)
        self.listen_addr = listen_addr
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(listen_addr)
        self._listener.listen(16)
        self._listener.setblocking(False)
        self._conns: Dict[Tuple[str, int], socket.socket] = {}
        self._accepted: list = []
        self._rxbuf: Dict[socket.socket, bytearray] = {}

    # ---- sending -----------------------------------------------------------
    # Network.send enqueues everything; pump() applies the fault-injection
    # filters and calls _route_remote for non-local destinations, so
    # down/blackhole/drop semantics are identical across the boundary.
    def _encode_payload(self, msg: Message) -> Tuple[bytes, int]:
        payload = encode_message(msg)
        comp_id = 0
        if self._comp_id and len(payload) >= self.compress_min:
            compressed = self._comp.compress(payload)
            # keep the raw buffer when compression doesn't help
            # (incompressible EC shard data expands under zlib)
            if len(compressed) < len(payload):
                payload = compressed
                comp_id = self._comp_id
        return payload, comp_id

    def _lossless(self, dst: str) -> bool:
        if self.local_entity is None:
            return False
        from ..auth import entity_service
        return entity_service(self.local_entity) in _DAEMON_SERVICES \
            and entity_service(dst) in _DAEMON_SERVICES

    def _route_remote(self, src: str, dst: str, msg: Message) -> bool:
        addr = self.directory.get(dst)
        if addr is None or tuple(addr) == tuple(self.listen_addr):
            return False  # unknown, or points back here with no endpoint
        payload, comp_id = self._encode_payload(msg)
        dname = dst.encode()
        if self._lossless(dst):
            wrapped = struct.pack("<Q H", 0, len(dname)) + dname + payload
            return self._send_lossless(dst, tuple(addr), comp_id, wrapped)
        frame = _HDR.pack(len(payload), len(dname), comp_id) \
            + dname + payload
        addr = tuple(addr)
        try:
            s = self._peer(addr, dst)
            self._transmit(s, frame)
            return True
        except Exception:
            # OSError / _AuthFailed / malformed peer handshake bytes
            # (struct.error, bad TLV): drop the connection, never die
            self._drop_conn(addr)
            return False

    def _transmit(self, s: socket.socket, frame: bytes) -> None:
        if self.auth is not None:
            from ..auth import hmac_tag
            frame += hmac_tag(self._out_sk[s], frame, _SIG_LEN)
        s.sendall(frame)

    def _drop_conn(self, addr: Tuple[str, int]) -> None:
        s = self._conns.pop(addr, None)
        if s is not None:
            self._out_sk.pop(s, None)
            self._sock_dst.pop(s, None)
            self._obuf.pop(s, None)
            try:
                s.close()
            except OSError:
                pass

    # ---- lossless-peer sessions (reconnect + resend, exactly-once) ---------
    def _send_lossless(self, dst: str, addr: Tuple[str, int],
                       comp_id: int, wrapped: bytes) -> bool:
        """Queue a seq-wrapped frame for *dst* and try to ship it; a
        broken socket keeps the frame queued for reconnect-resend
        instead of dropping it (Policy lossless_peer)."""
        tx = self._sess_tx.setdefault(
            dst, {"next_seq": 1, "unacked": deque(),
                  "retry_at": 0.0, "backoff": 0.25})
        if len(tx["unacked"]) >= MAX_UNACKED:
            from ..common.dout import dlog
            dlog("msg", 0, f"lossless queue to {dst} overflowed "
                 f"({MAX_UNACKED}); dropping message")
            return False
        seq = tx["next_seq"]
        tx["next_seq"] = seq + 1
        # stamp the real seq into the wrapper built by the caller
        wrapped = struct.pack("<Q", seq) + wrapped[8:]
        frame = _HDR.pack(len(wrapped), _SEQ_DLEN, comp_id) + wrapped
        tx["unacked"].append((seq, frame))
        self._flush_dst(dst, addr)
        return True

    def _flush_dst(self, dst: str, addr: Tuple[str, int]) -> None:
        """(Re)connect to *dst* if needed and push every unacked frame
        the current socket hasn't carried yet."""
        tx = self._sess_tx[dst]
        now = time.monotonic()
        if self._conns.get(addr) is None and now < tx["retry_at"]:
            return                       # in reconnect backoff
        try:
            s = self._peer(addr, dst)
            if tx.get("sock") is not s:
                # fresh socket: session hello tells the peer who we
                # are and returns its delivered high-water mark
                acked = self._session_hello(s, dst)
                while tx["unacked"] and tx["unacked"][0][0] <= acked:
                    tx["unacked"].popleft()
                for _seq, frame in list(tx["unacked"]):
                    self._transmit(s, frame)
                    self.resent += 1
                tx["sock"] = s
                self._sock_dst[s] = dst
            else:
                _seq, frame = tx["unacked"][-1]
                self._transmit(s, frame)
            tx["backoff"] = 0.25
        except Exception:
            self._drop_conn(addr)
            tx["sock"] = None
            tx["retry_at"] = now + tx["backoff"]
            tx["backoff"] = min(tx["backoff"] * 2, 5.0)

    def _session_hello(self, s: socket.socket, dst: str) -> int:
        """-> peer's last delivered seq from us (for resend trimming)."""
        body = encode_blob({"entity": self.local_entity,
                            "nonce": self._sess_nonce})
        s.sendall(_HDR.pack(len(body), _SESS_DLEN, _S_HELLO) + body)
        op, reply = self._read_ctrl_frame(s, _SESS_DLEN)
        if op != _S_HELLO_ACK or "last_seq" not in reply:
            raise _AuthFailed(reply.get("error", "bad session hello ack"))
        return int(reply["last_seq"])

    def _flush_lossless(self) -> None:
        """Retry peers with backlogged unacked frames (called from
        pump); reconnection does the resend."""
        for dst, tx in list(self._sess_tx.items()):
            if not tx["unacked"]:
                continue
            addr = self.directory.get(dst)
            if addr is None:
                continue
            addr = tuple(addr)
            # resend when disconnected OR when the live socket never
            # ran this session's hello/resend (e.g. a fresh connection
            # made for ticket renewal replaced the session socket)
            if self._conns.get(addr) is not tx.get("sock") or \
                    tx.get("sock") is None:
                self._flush_dst(dst, addr)

    def _peer(self, addr: Tuple[str, int],
              dst: str = "") -> socket.socket:
        s = self._conns.get(addr)
        if s is None:
            s = socket.create_connection(addr, timeout=5.0)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            try:
                if self.auth is not None:
                    self._auth_outbound(s, addr, dst)
            except Exception:
                try:
                    s.close()
                except OSError:
                    pass
                raise
            self._conns[addr] = s
        return s

    # ---- auth handshakes ---------------------------------------------------
    def _send_auth_frame(self, s: socket.socket, op: int,
                         body: Dict) -> None:
        payload = encode_blob(body)
        s.sendall(_HDR.pack(len(payload), _AUTH_DLEN, op) + payload)

    def _read_auth_frame(self, s: socket.socket) -> Tuple[int, Dict]:
        return self._read_ctrl_frame(s, _AUTH_DLEN)

    def _read_ctrl_frame(self, s: socket.socket,
                         want_dlen: int) -> Tuple[int, Dict]:
        """Read one control frame (auth or session handshake), serving
        OUR inbound sockets while waiting — two daemons handshaking
        with each other concurrently would otherwise deadlock until
        both time out."""
        buf = b""
        deadline = time.monotonic() + 5.0
        s.settimeout(0.05)
        self._handshaking.add(s)
        try:
            while time.monotonic() < deadline:
                try:
                    chunk = s.recv(1 << 16)
                    if not chunk:
                        raise _AuthFailed("peer closed during handshake")
                    buf += chunk
                except socket.timeout:
                    self._poll_sockets(0.0)
                    continue
                if len(buf) < _HDR.size:
                    continue
                plen, dlen, op = _HDR.unpack_from(buf, 0)
                if dlen != want_dlen:
                    raise _AuthFailed("unexpected frame during handshake")
                if len(buf) >= _HDR.size + plen:
                    return op, decode_blob(buf[_HDR.size:_HDR.size + plen])
            raise _AuthFailed("handshake timed out")
        finally:
            self._handshaking.discard(s)
            try:
                s.settimeout(5.0)
            except OSError:
                pass

    def _auth_outbound(self, s: socket.socket, addr: Tuple[str, int],
                       dst: str) -> None:
        """Authenticate a fresh outbound connection: bootstrap with the
        KDC if needed, then present an authorizer for dst's service."""
        from ..auth import AuthError, entity_service
        a = self.auth
        kdcs = self._kdc_names()
        if a.client.needs_renewal():
            # missing OR near-expiry tickets: (re)run the KDC exchange
            # — on this socket if it goes to a mon, else over a fresh
            # mon connection (expired tickets would otherwise lock the
            # daemon out of every reconnect forever)
            if addr not in [tuple(self.directory[n]) for n in kdcs]:
                self._kdc_connect(kdcs)
            else:
                self._kdc_exchange(s)
        service = entity_service(dst) if dst else "mon"
        # fetch the connection-bound server challenge first, so a
        # recorded authorizer can't re-authenticate a new connection
        self._send_auth_frame(s, _A_AUTH_HELLO, {})
        op, body = self._read_auth_frame(s)
        if op != _A_AUTH_CHALLENGE or "challenge" not in body:
            raise _AuthFailed(body.get("error", "no authorizer challenge"))
        try:
            auth_msg, sk, nonce = a.client.build_authorizer(
                service, body["challenge"])
        except AuthError as e:
            raise _AuthFailed(str(e))
        self._send_auth_frame(s, _A_AUTHORIZER, auth_msg)
        op, reply = self._read_auth_frame(s)
        if op != _A_AUTH_REPLY or not reply.get("ok") or \
                not a.client.check_authorizer_reply(
                    sk, nonce, reply.get("reply", b"")):
            from ..common.dout import dlog
            dlog("msg", 0, f"authorizer for {dst!r} rejected: "
                 f"{reply.get('error', 'bad reply proof')}")
            raise _AuthFailed("authorizer rejected")
        self._out_sk[s] = sk

    def _kdc_exchange(self, s: socket.socket) -> None:
        """cephx bootstrap on an un-authed mon connection."""
        a = self.auth
        self._send_auth_frame(s, _A_KDC_HELLO, {"entity": a.entity})
        op, body = self._read_auth_frame(s)
        if op != _A_KDC_CHALLENGE or "challenge" not in body:
            raise _AuthFailed(body.get("error", "no KDC challenge"))
        cch, proof = a.client.make_proof(body["challenge"])
        self._send_auth_frame(s, _A_KDC_PROVE, {
            "entity": a.entity, "server_challenge": body["challenge"],
            "client_challenge": cch, "proof": proof})
        op, body = self._read_auth_frame(s)
        if op != _A_KDC_REPLY or not body.get("ok"):
            from ..common.dout import dlog
            dlog("msg", 0, "KDC rejected "
                 f"{a.entity!r}: {body.get('error', '?')}")
            raise _AuthFailed("KDC rejected credentials")
        a.client.handle_reply(body["blob"])
        a.ensure_verifier()

    def _kdc_names(self) -> List[str]:
        """The mons that answer a KDC exchange: ``mon``, or each
        ``mon.<rank>`` of a multi-mon cluster in rank order."""
        if "mon" in self.directory:
            return ["mon"]
        return sorted((n for n in self.directory if n.startswith("mon.")),
                      key=lambda n: int(n.split(".", 1)[1]))

    def _kdc_connect(self, kdcs: List[str]) -> None:
        """A fresh connection to the first of ``kdcs`` that answers (the
        MonClient's hunt), which runs the KDC exchange; the last error
        when none does."""
        err: Exception = _AuthFailed("no mon in the directory")
        for name in kdcs:
            addr = tuple(self.directory[name])
            self._drop_conn(addr)
            try:
                self._peer(addr, name)
                return
            except (_AuthFailed, OSError) as e:
                err = e
        raise err

    def authenticate(self) -> bool:
        """Force the KDC exchange now (daemon boot path), so inbound
        authorizers can be verified before any outbound traffic."""
        if self.auth is None or self.auth.client.authenticated():
            return True
        try:
            self._kdc_connect(self._kdc_names())
            return True
        except (_AuthFailed, OSError, KeyError):
            return False

    # ---- receiving ---------------------------------------------------------
    def _poll_sockets(self, wait: float) -> int:
        import select
        outbound = [s for s in self._conns.values()
                    if s not in self._handshaking]
        socks = [self._listener] + self._accepted + outbound
        try:
            readable, _, _ = select.select(socks, [], [], wait)
        except OSError:
            return 0
        n = 0
        for s in readable:
            if s is self._listener:
                try:
                    conn, _peer = self._listener.accept()
                    conn.setblocking(False)
                    self._accepted.append(conn)
                    self._rxbuf[conn] = bytearray()
                except OSError:
                    pass
                continue
            if s in self._handshaking:
                continue          # the blocking exchange owns this fd
            is_outbound = s not in self._rxbuf and s in outbound
            try:
                data = s.recv(1 << 20)
            except (OSError, socket.timeout):
                data = b""
            if not data:
                if is_outbound:
                    # peer closed our outbound connection: drop it so
                    # the next send (or lossless flush) reconnects
                    for addr, c in list(self._conns.items()):
                        if c is s:
                            self._drop_conn(addr)
                    continue
                self._accepted.remove(s)
                self._rxbuf.pop(s, None)
                self._in_auth.pop(s, None)
                self._sess_peer.pop(s, None)
                continue
            if is_outbound:
                buf = self._obuf.setdefault(s, bytearray())
                buf.extend(data)
                self._drain_outbound(s, buf)
                continue
            buf = self._rxbuf[s]
            buf.extend(data)
            n += self._drain_frames(s, buf)
        return n

    def _drain_outbound(self, s: socket.socket, buf: bytearray) -> None:
        """Outbound sockets only carry session ACK frames inbound."""
        while len(buf) >= _HDR.size:
            plen, dlen, _op = _HDR.unpack_from(buf, 0)
            total = _HDR.size + plen
            if len(buf) < total:
                break
            payload = bytes(buf[_HDR.size:total])
            del buf[:total]
            if dlen != _ACK_DLEN or plen != 8:
                continue          # stray frame: ignore
            (acked,) = struct.unpack("<Q", payload)
            dst = self._sock_dst.get(s)
            tx = self._sess_tx.get(dst) if dst else None
            if tx is not None:
                while tx["unacked"] and tx["unacked"][0][0] <= acked:
                    tx["unacked"].popleft()

    def _handle_auth_frame(self, s: socket.socket, op: int,
                           payload: bytes) -> None:
        """Inbound auth control frame on an accepted socket."""
        from ..auth import AuthError
        a = self.auth
        state = self._in_auth.setdefault(s, {"authed": False})
        try:
            body = decode_blob(payload)
            if op == _A_KDC_HELLO:
                if a is None or a.server is None:
                    self._send_auth_frame(s, _A_KDC_CHALLENGE,
                                          {"error": "not a KDC"})
                    return
                try:
                    ch = a.server.get_challenge(body["entity"])
                except AuthError as e:
                    self.auth_rejects += 1
                    self._send_auth_frame(s, _A_KDC_CHALLENGE,
                                          {"error": str(e)})
                    return
                self._send_auth_frame(s, _A_KDC_CHALLENGE,
                                      {"challenge": ch})
            elif op == _A_KDC_PROVE:
                if a is None or a.server is None:
                    self._send_auth_frame(s, _A_KDC_REPLY,
                                          {"ok": False,
                                           "error": "not a KDC"})
                    return
                try:
                    blob = a.server.authenticate(
                        body["entity"], body.get("server_challenge", b""),
                        body["client_challenge"], body["proof"])
                    self._send_auth_frame(s, _A_KDC_REPLY,
                                          {"ok": True, "blob": blob})
                except AuthError as e:
                    self.auth_rejects += 1
                    self._send_auth_frame(s, _A_KDC_REPLY,
                                          {"ok": False, "error": str(e)})
            elif op == _A_AUTH_HELLO:
                ch = os.urandom(16)
                state["challenge"] = ch
                self._send_auth_frame(s, _A_AUTH_CHALLENGE,
                                      {"challenge": ch})
            elif op == _A_AUTHORIZER:
                if a is None:
                    self._send_auth_frame(
                        s, _A_AUTH_REPLY,
                        {"ok": False, "error": "auth disabled here"})
                    return
                a.ensure_verifier()
                if a.verifier is None:
                    self._send_auth_frame(
                        s, _A_AUTH_REPLY,
                        {"ok": False, "error": "no rotating keys yet"})
                    return
                ch = state.pop("challenge", None)
                if ch is None:
                    self.auth_rejects += 1
                    self._send_auth_frame(
                        s, _A_AUTH_REPLY,
                        {"ok": False, "error": "no challenge issued on "
                         "this connection"})
                    return
                try:
                    entity, sk, reply = \
                        a.verifier.verify_authorizer(body, ch)
                except AuthError as e:
                    self.auth_rejects += 1
                    self._send_auth_frame(s, _A_AUTH_REPLY,
                                          {"ok": False, "error": str(e)})
                    return
                state.update(authed=True, sk=sk, entity=entity)
                self._send_auth_frame(s, _A_AUTH_REPLY,
                                      {"ok": True, "reply": reply})
        except Exception as e:
            # malformed payloads (struct.error, UnicodeDecodeError, bad
            # TLV...) come straight off the network: drop, never die
            self.auth_rejects += 1
            from ..common.dout import dlog
            dlog("msg", 0, f"auth frame error: {e!r}")

    def _handle_session_frame(self, s: socket.socket, op: int,
                              payload: bytes) -> None:
        """Session hello on an accepted socket: bind the peer entity
        (for seq bookkeeping) and return its delivered high-water mark
        so a reconnecting sender can trim its resend queue."""
        try:
            if op != _S_HELLO:
                return
            body = decode_blob(payload)
            entity = body.get("entity")
            err = None
            if not isinstance(entity, str) or not entity:
                err = "session hello without entity"
            elif self.auth is not None:
                st = self._in_auth.get(s)
                if st is None or not st.get("authed") or \
                        st.get("entity") != entity:
                    err = "session hello does not match " \
                          "authenticated principal"
            if err:
                self.auth_rejects += 1
                out = encode_blob({"error": err})
            else:
                self._sess_peer[s] = entity
                nonce = int(body.get("nonce", 0))
                if self._sess_rx_nonce.get(entity) != nonce:
                    # new incarnation of this peer: its seq space
                    # restarted, so the old high-water mark is void
                    self._sess_rx_nonce[entity] = nonce
                    self._sess_rx[entity] = 0
                out = encode_blob(
                    {"last_seq": self._sess_rx.get(entity, 0)})
            s.sendall(_HDR.pack(len(out), _SESS_DLEN, _S_HELLO_ACK)
                      + out)
        except Exception as e:
            from ..common.dout import dlog
            dlog("msg", 0, f"session frame error: {e!r}")

    def _drain_frames(self, s: socket.socket, buf: bytearray) -> int:
        n = 0
        trailer = _SIG_LEN if self.auth is not None else 0
        ack_entity = None
        while len(buf) >= _HDR.size:
            plen, dlen, comp_id = _HDR.unpack_from(buf, 0)
            if dlen in (_AUTH_DLEN, _SESS_DLEN, _ACK_DLEN):
                # control frames: no dst name, no signature trailer
                total = _HDR.size + plen
                if len(buf) < total:
                    break
                payload = bytes(buf[_HDR.size:total])
                del buf[:total]
                if dlen == _AUTH_DLEN:
                    self._handle_auth_frame(s, comp_id, payload)
                elif dlen == _SESS_DLEN:
                    self._handle_session_frame(s, comp_id, payload)
                # _ACK_DLEN rides outbound sockets; ignore here
                continue
            seq_wrapped = dlen == _SEQ_DLEN
            body_len = plen if seq_wrapped else dlen + plen
            total = _HDR.size + body_len + trailer
            if len(buf) < total:
                break
            frame_bytes = bytes(buf[:total - trailer])
            body = frame_bytes[_HDR.size:]
            sig = bytes(buf[total - trailer:total])
            del buf[:total]
            # auth gate FIRST: nothing from an unauthenticated or
            # forged frame (including its dst name) gets interpreted
            if trailer:
                state = self._in_auth.get(s)
                if state is None or not state.get("authed"):
                    self.auth_rejects += 1
                    self.dropped += 1
                    from ..common.dout import dlog
                    dlog("msg", 0, "dropping frame: "
                         "connection not authenticated")
                    continue
                from ..auth import hmac_tag
                if sig != hmac_tag(state["sk"], frame_bytes, _SIG_LEN):
                    self.auth_rejects += 1
                    self.dropped += 1
                    from ..common.dout import dlog
                    dlog("msg", 0, "dropping frame: "
                         "bad frame signature")
                    continue
            seq = 0
            if seq_wrapped:
                if len(body) < 10:
                    self.dropped += 1
                    continue
                seq, ndlen = struct.unpack_from("<Q H", body, 0)
                dst_raw = body[10:10 + ndlen]
                payload = body[10 + ndlen:]
            else:
                dst_raw = body[:dlen]
                payload = body[dlen:]
            try:
                dst = dst_raw.decode()
            except UnicodeDecodeError as e:
                self.dropped += 1
                from ..common.dout import dlog
                dlog("msg", 0, f"dropped frame with undecodable dst "
                     f"name: {e!r}")
                continue
            if seq_wrapped:
                # seq bookkeeping BEFORE decode: an undecodable payload
                # (codec mismatch, corrupt TLV) must still advance the
                # ack high-water mark — resending it forever would
                # wedge the session head-of-line; the loss is counted
                # and logged below instead of silently un-acked
                ent = self._sess_peer.get(s)
                if ent is None:
                    # no session hello on this connection yet
                    self.dropped += 1
                    continue
                if seq <= self._sess_rx.get(ent, 0):
                    self.dup_dropped += 1      # reconnect resend overlap
                    ack_entity = ent
                    continue
                self._sess_rx[ent] = seq
                ack_entity = ent
            try:
                if comp_id:
                    dec = self._decomps.get(comp_id)
                    if dec is None:
                        from ..common.dout import dlog
                        from ..compressor import create_compressor
                        try:
                            dec = create_compressor(
                                _COMP_NAMES.get(comp_id, f"#{comp_id}"))
                        except KeyError:
                            # peer uses a codec this environment lacks:
                            # dropping silently would hang its ops with
                            # zero diagnostics — log loudly every time
                            dlog("msg", 0,
                                 f"dropping frame for {dst}: peer codec "
                                 f"id {comp_id} unavailable here")
                            self.dropped += 1
                            continue
                        self._decomps[comp_id] = dec
                    payload = dec.decompress(payload)
                msg = decode_message(payload)
            except Exception as e:  # corrupt frame or codec error
                                # (zlib.error etc. — each codec raises
                                # its own type)
                # count it dropped and keep pumping, but make sustained
                # failure streams (e.g. a peer speaking an older frame
                # layout) discoverable: log the first drop and then
                # every 100th
                self.dropped += 1
                if self.dropped == 1 or self.dropped % 100 == 0:
                    from ..common.dout import dlog
                    dlog("msg", 0,
                         f"dropped undecodable frame for {dst} "
                         f"({self.dropped} total; possible peer wire-"
                         f"format mismatch): {e!r}")
                continue
            if not isinstance(getattr(msg, "src", None), str):
                # src drives hashed routing/filter lookups everywhere;
                # a non-string here is a malformed/hostile frame
                self.dropped += 1
                continue
            if trailer:
                # the signature binds the frame to the connection's
                # authenticated principal; spoofed src names (a client
                # key claiming to be an osd/mon) get dropped here
                from ..auth import entity_service
                state = self._in_auth.get(s) or {}
                if entity_service(msg.src) != \
                        entity_service(state.get("entity", "")):
                    self.auth_rejects += 1
                    self.dropped += 1
                    from ..common.dout import dlog
                    dlog("msg", 0,
                         f"dropping frame: src {msg.src!r} outside "
                         f"authenticated service of "
                         f"{state.get('entity')!r}")
                    continue
            # enqueue like a local delivery (fault injection still applies)
            self.queue.append((msg.src, dst, msg))
            n += 1
        if ack_entity is not None:
            try:
                s.sendall(_HDR.pack(8, _ACK_DLEN, 0)
                          + struct.pack("<Q", self._sess_rx[ack_entity]))
            except OSError:
                pass
        return n

    # ---- pumping -----------------------------------------------------------
    def pump(self, max_msgs: int = 100000, quiesce: float = 0.05,
             deadline: float = 5.0) -> int:
        """Drain local queue + sockets until no traffic arrives for
        *quiesce* seconds (bounded by *deadline*)."""
        total = 0
        t_end = time.monotonic() + deadline
        idle_since = None
        while time.monotonic() < t_end:
            self._flush_lossless()
            moved = super().pump(max_msgs)
            moved += self._poll_sockets(0.005)
            total += moved
            if moved:
                idle_since = None
                continue
            if idle_since is None:
                idle_since = time.monotonic()
            elif time.monotonic() - idle_since >= quiesce:
                break
        return total

    def close(self) -> None:
        for s in [self._listener, *self._accepted,
                  *self._conns.values()]:
            try:
                s.close()
            except OSError:
                pass
