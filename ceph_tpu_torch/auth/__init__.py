"""Authentication (src/auth/ cephx role).

Two-tier shared-secret auth mirroring cephx's shape:

- the monitor is the KDC (``CephxServer``): entities prove knowledge of
  their keyring secret via challenge/response and receive a session key
  plus *service tickets* (blobs encrypted with rotating per-service
  secrets), so services can verify clients without asking the mon;
- peers present an authorizer (ticket + session-key proof) when they
  connect (``CephxClient`` / ``CephxServiceVerifier``), and every
  subsequent wire frame is HMAC-signed with the connection's session key
  (cephx_sign_messages role).

Secrets never cross the wire in the clear; the ciphers are built from
hashlib-only primitives (see crypto.py) since this environment carries
no AES bindings.

The port's own copy of ``ceph_tpu/auth/``: the same keyring file
format, ciphers and protocol, so either package's keyring, tickets and
authorizers are accepted by the other.
"""
from .crypto import AuthError, decrypt, encrypt, hmac_tag, make_secret
from .keyring import Keyring
from .cephx import (
    CephxClient,
    CephxServer,
    CephxServiceVerifier,
    entity_service,
)

__all__ = [
    "AuthError", "decrypt", "encrypt", "hmac_tag", "make_secret",
    "Keyring", "CephxClient", "CephxServer", "CephxServiceVerifier",
    "entity_service",
]
