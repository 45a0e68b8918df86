"""cephx-style protocol: KDC, tickets, authorizers, rotating keys.

Shape mirrors the reference (src/auth/cephx/CephxProtocol.h,
CephxKeyServer in src/auth/cephx/CephxKeyServer.cc):

1. **Authenticate to the mon (KDC).**  Challenge/response: the client
   proves knowledge of its keyring secret with
   ``proof = HMAC(secret, server_challenge || client_challenge)``
   (CEPHX_GET_AUTH_SESSION_KEY role).  The reply — encrypted with the
   entity secret — carries the mon session key, one (session_key,
   ticket) pair per reachable service, and, for daemon entities, the
   rotating per-service secrets (so an OSD can verify tickets minted
   for the "osd" service without calling home).
2. **Connect to a service.**  The connector presents an authorizer:
   the opaque ticket (encrypted with the service's rotating secret —
   the connector cannot read or forge it) plus a nonce proof under the
   ticket's session key.  The service decrypts the ticket, checks the
   proof and expiry, and answers ``HMAC(session_key, nonce+1)`` so the
   connector knows the service really holds the rotating secret
   (mutual auth, CephxAuthorizeHandler role).
3. Every subsequent wire frame is HMAC-signed with the connection's
   session key (cephx_sign_messages; applied in msg/tcp.py).

Rotating secrets follow KeyServer's current/next pair per service and
carry numeric ids so tickets survive one rotation.

The port's own copy of ``ceph_tpu/auth/cephx.py``.
"""
from __future__ import annotations

import os
import struct
import time
from typing import Dict, Optional, Tuple

from ..msg.wire import decode_blob, encode_blob
from .crypto import AuthError, decrypt, encrypt, hmac_tag, make_secret
from .keyring import Keyring

TICKET_TTL = 3600.0          # auth_service_ticket_ttl
ROTATION_PERIOD = 3600.0     # auth_rotating_secrets period
CHALLENGE_TTL = 60.0
MAX_CHALLENGES = 1024        # un-authed HELLO floods evict the oldest
RENEW_MARGIN = 60.0          # re-run the KDC exchange this early
# "client" is a ticket-bearing service here (unlike the reference)
# because replies flow over daemon->client connections in this
# transport, so clients must verify inbound connecting daemons too.
SERVICES = ("mon", "osd", "mgr", "client")


def entity_service(entity: str) -> str:
    """osd.3 -> osd; client.x -> client."""
    return entity.split(".", 1)[0]


def _nonce_reply(n: int) -> bytes:
    return struct.pack("<Q", (n + 1) & 0xFFFFFFFFFFFFFFFF)


class CephxServer:
    """The KDC, hosted by the monitor's transport (AuthMonitor +
    CephxKeyServer role).  Holds the full keyring and mints tickets."""

    def __init__(self, keyring: Keyring,
                 rotation_period: float = ROTATION_PERIOD,
                 ticket_ttl: float = TICKET_TTL):
        self.keyring = keyring
        self.rotation_period = rotation_period
        self.ticket_ttl = ticket_ttl
        # service -> {secret_id: (secret, expires)}; current = max id
        self.rotating: Dict[str, Dict[int, Tuple[bytes, float]]] = {}
        self._challenges: Dict[bytes, Tuple[str, float]] = {}
        now = time.time()
        for svc in SERVICES:
            self.rotating[svc] = {1: (make_secret(),
                                      now + 2 * rotation_period)}

    # ---- rotating secrets (KeyServer::_rotate_secret) ----------------------
    def current_secret(self, service: str) -> Tuple[int, bytes]:
        sid = max(self.rotating[service])
        return sid, self.rotating[service][sid][0]

    def rotate(self, now: Optional[float] = None) -> None:
        """Mint the next secret per service; drop fully expired ones."""
        now = time.time() if now is None else now
        for svc, secrets in self.rotating.items():
            sid = max(secrets) + 1
            secrets[sid] = (make_secret(), now + 2 * self.rotation_period)
            for old in [i for i, (_, exp) in secrets.items() if exp <= now]:
                del secrets[old]

    def rotating_bundle(self, service: str) -> Dict:
        """The secrets a daemon of *service* needs to verify tickets."""
        return {sid: [sec, exp]
                for sid, (sec, exp) in self.rotating[service].items()}

    # ---- phase 1: challenge ------------------------------------------------
    def get_challenge(self, entity: str,
                      now: Optional[float] = None) -> bytes:
        """Raises AuthError for entities not in the keyring, and sweeps
        expired challenges, so un-authed HELLO floods can't grow state."""
        now = time.time() if now is None else now
        if self.keyring.get(entity) is None:
            raise AuthError(f"unknown entity {entity!r}")
        for stale in [c for c, (_, exp) in self._challenges.items()
                      if exp < now]:
            del self._challenges[stale]
        # hard cap: a flood inside the TTL evicts its own oldest
        # entries instead of growing mon memory (legit exchanges
        # complete in milliseconds and are unaffected)
        while len(self._challenges) >= MAX_CHALLENGES:
            del self._challenges[next(iter(self._challenges))]
        ch = os.urandom(16)
        self._challenges[ch] = (entity, now + CHALLENGE_TTL)
        return ch

    # ---- phase 2: proof -> session key + tickets ---------------------------
    def authenticate(self, entity: str, server_challenge: bytes,
                     client_challenge: bytes, proof: bytes,
                     now: Optional[float] = None) -> bytes:
        """Verify the proof; return the encrypted auth reply blob.

        Raises AuthError on unknown entity, stale/foreign challenge, or
        a proof that doesn't match the keyring secret.
        """
        now = time.time() if now is None else now
        secret = self.keyring.get(entity)
        if secret is None:
            raise AuthError(f"unknown entity {entity!r}")
        known = self._challenges.pop(server_challenge, None)
        if known is None or known[0] != entity or known[1] < now:
            raise AuthError("stale or foreign server challenge")
        expect = hmac_tag(secret, server_challenge + client_challenge)
        if proof != expect:
            raise AuthError(f"bad proof for {entity!r}")
        # mint per-service session keys + tickets
        tickets: Dict[str, Dict] = {}
        for svc in SERVICES:
            session_key = make_secret()
            sid, svc_secret = self.current_secret(svc)
            ticket = encrypt(svc_secret, encode_blob({
                "entity": entity,
                "session_key": session_key,
                "expires": now + self.ticket_ttl,
            }))
            # "expires" rides in the clear too so the CLIENT knows
            # when to renew (the authoritative copy stays encrypted)
            tickets[svc] = {"session_key": session_key,
                            "secret_id": sid, "ticket": ticket,
                            "expires": now + self.ticket_ttl}
        reply: Dict = {"tickets": tickets}
        svc = entity_service(entity)
        if svc in SERVICES:   # daemons get their service's rotating keys
            reply["rotating"] = {svc: self.rotating_bundle(svc)}
        return encrypt(secret, encode_blob(reply))


class CephxClient:
    """Per-entity client state: proves itself to the KDC, builds
    authorizers for service connections (CephxClientHandler role)."""

    def __init__(self, entity: str, secret: bytes):
        self.entity = entity
        self.secret = secret
        self.tickets: Dict[str, Dict] = {}
        self.rotating: Dict[str, Dict[int, Tuple[bytes, float]]] = {}
        self._client_challenge: Optional[bytes] = None

    # ---- KDC exchange ------------------------------------------------------
    def make_proof(self, server_challenge: bytes) -> Tuple[bytes, bytes]:
        """-> (client_challenge, proof) for the server's challenge."""
        self._client_challenge = os.urandom(16)
        proof = hmac_tag(self.secret,
                         server_challenge + self._client_challenge)
        return self._client_challenge, proof

    def handle_reply(self, blob: bytes) -> None:
        reply = decode_blob(decrypt(self.secret, blob))
        self.tickets = reply["tickets"]
        for svc, bundle in reply.get("rotating", {}).items():
            self.rotating[svc] = {int(sid): (sec, exp)
                                  for sid, (sec, exp) in bundle.items()}

    def authenticated(self) -> bool:
        return bool(self.tickets)

    def needs_renewal(self, now: Optional[float] = None) -> bool:
        """True when any held ticket is at/near expiry — time to re-run
        the KDC exchange (RotatingKeyRing renewal role)."""
        if not self.tickets:
            return True
        now = time.time() if now is None else now
        return any(t.get("expires", 0.0) <= now + RENEW_MARGIN
                   for t in self.tickets.values())

    # ---- service connections ----------------------------------------------
    def build_authorizer(self, service: str,
                         challenge: bytes = b"") -> Tuple[Dict, bytes, int]:
        """-> (authorizer dict, session_key, nonce).

        *challenge* is the connection-specific server challenge mixed
        into the proof so a recorded authorizer cannot re-authenticate
        a new connection (the CVE-2018-1128 fix in real cephx).  The
        caller checks the service's reply via
        ``check_authorizer_reply``."""
        t = self.tickets.get(service)
        if t is None:
            raise AuthError(f"no ticket for service {service!r}")
        # 63-bit so the nonce survives the signed-int64 wire codec
        nonce = struct.unpack("<Q", os.urandom(8))[0] >> 1
        sk = t["session_key"]
        auth = {
            "entity": self.entity,
            "service": service,
            "secret_id": t["secret_id"],
            "ticket": t["ticket"],
            "nonce": nonce,
            "proof": hmac_tag(sk, struct.pack("<Q", nonce) + challenge),
        }
        return auth, sk, nonce

    @staticmethod
    def check_authorizer_reply(session_key: bytes, nonce: int,
                               reply: bytes) -> bool:
        return reply == hmac_tag(session_key, _nonce_reply(nonce))


class CephxServiceVerifier:
    """Service-side ticket verification from rotating secrets
    (CephxAuthorizeHandler::verify_authorizer role)."""

    def __init__(self, service: str,
                 rotating: Dict[int, Tuple[bytes, float]]):
        self.service = service
        self.rotating = dict(rotating)

    def update_rotating(self,
                        rotating: Dict[int, Tuple[bytes, float]]) -> None:
        self.rotating.update(rotating)

    def verify_authorizer(self, auth: Dict,
                          challenge: bytes = b"",
                          now: Optional[float] = None
                          ) -> Tuple[str, bytes, bytes]:
        """-> (entity, session_key, reply_proof); raises AuthError.

        *challenge* must be the value this service issued for THIS
        connection; a replayed authorizer fails the proof check."""
        now = time.time() if now is None else now
        if auth.get("service") != self.service:
            raise AuthError("authorizer for a different service")
        entry = self.rotating.get(int(auth.get("secret_id", -1)))
        if entry is None:
            raise AuthError("unknown rotating secret id "
                            f"{auth.get('secret_id')!r}")
        ticket = decode_blob(decrypt(entry[0], auth["ticket"]))
        if ticket["expires"] < now:
            raise AuthError(f"expired ticket for {ticket['entity']!r}")
        sk = ticket["session_key"]
        nonce = int(auth["nonce"])
        expect = hmac_tag(sk, struct.pack("<Q", nonce) + challenge)
        if auth.get("proof") != expect:
            raise AuthError("authorizer proof mismatch")
        return ticket["entity"], sk, hmac_tag(sk, _nonce_reply(nonce))
