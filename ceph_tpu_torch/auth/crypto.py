"""Symmetric crypto for the auth tier, from hashlib primitives only.

The reference's cephx uses AES-CBC via its crypto plugins
(src/auth/Crypto.cc); this environment ships no AES bindings, so the
equivalent here is a SHA-256 keystream cipher with encrypt-then-MAC:

    ct  = nonce || (plaintext XOR keystream(key, nonce))
    tag = HMAC-SHA256(key, ct)[:16]

The keystream blocks are SHA256(key || nonce || counter); the MAC makes
the blob tamper-evident, which is the property every protocol check in
cephx.py rests on (a forged or bit-flipped ticket fails decrypt()).

The port's own copy of ``ceph_tpu/auth/crypto.py``.
"""
from __future__ import annotations

import hashlib
import hmac as _hmac
import os
import struct


class AuthError(Exception):
    """Authentication failure (EACCES role)."""


SECRET_LEN = 16
NONCE_LEN = 16
TAG_LEN = 16


def make_secret() -> bytes:
    return os.urandom(SECRET_LEN)


def hmac_tag(key: bytes, data: bytes, n: int = TAG_LEN) -> bytes:
    return _hmac.new(key, data, hashlib.sha256).digest()[:n]


def _keystream(key: bytes, nonce: bytes, n: int) -> bytes:
    out = bytearray()
    ctr = 0
    while len(out) < n:
        out.extend(hashlib.sha256(
            key + nonce + struct.pack("<Q", ctr)).digest())
        ctr += 1
    return bytes(out[:n])


def encrypt(key: bytes, plaintext: bytes) -> bytes:
    nonce = os.urandom(NONCE_LEN)
    ct = nonce + bytes(a ^ b for a, b in
                       zip(plaintext, _keystream(key, nonce,
                                                 len(plaintext))))
    return ct + hmac_tag(key, ct)


def decrypt(key: bytes, blob: bytes) -> bytes:
    if len(blob) < NONCE_LEN + TAG_LEN:
        raise AuthError("auth blob truncated")
    ct, tag = blob[:-TAG_LEN], blob[-TAG_LEN:]
    if not _hmac.compare_digest(hmac_tag(key, ct), tag):
        raise AuthError("auth blob failed integrity check")
    nonce, body = ct[:NONCE_LEN], ct[NONCE_LEN:]
    return bytes(a ^ b for a, b in
                 zip(body, _keystream(key, nonce, len(body))))
