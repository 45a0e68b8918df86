"""Object-name hashes (reference src/common/ceph_hash.cc).

``ceph_str_hash_rjenkins`` is the object→ps hash (12-byte block Jenkins mix
seeded with the golden ratio, length folded into c); ``ceph_str_hash_linux``
is the legacy dcache hash.  Both are host-side — object-name hashing is cheap
and happens at the client/PG boundary, never in the device hot loop.
"""
from __future__ import annotations

from ..crush.hash import M32, _mix

CEPH_STR_HASH_LINUX = 0x1
CEPH_STR_HASH_RJENKINS = 0x2


def ceph_str_hash_rjenkins(data) -> int:
    k = bytes(data, "utf-8") if isinstance(data, str) else bytes(data)
    length = len(k)
    a = b = 0x9E3779B9
    c = 0
    i = 0
    n = length
    while n >= 12:
        a = (a + (k[i] | k[i+1] << 8 | k[i+2] << 16 | k[i+3] << 24)) & M32
        b = (b + (k[i+4] | k[i+5] << 8 | k[i+6] << 16 | k[i+7] << 24)) & M32
        c = (c + (k[i+8] | k[i+9] << 8 | k[i+10] << 16 | k[i+11] << 24)) & M32
        a, b, c = _mix(a, b, c)
        i += 12
        n -= 12
    c = (c + length) & M32
    # tail bytes; byte 0 of c is reserved for the length
    if n >= 11: c = (c + (k[i+10] << 24)) & M32
    if n >= 10: c = (c + (k[i+9] << 16)) & M32
    if n >= 9:  c = (c + (k[i+8] << 8)) & M32
    if n >= 8:  b = (b + (k[i+7] << 24)) & M32
    if n >= 7:  b = (b + (k[i+6] << 16)) & M32
    if n >= 6:  b = (b + (k[i+5] << 8)) & M32
    if n >= 5:  b = (b + k[i+4]) & M32
    if n >= 4:  a = (a + (k[i+3] << 24)) & M32
    if n >= 3:  a = (a + (k[i+2] << 16)) & M32
    if n >= 2:  a = (a + (k[i+1] << 8)) & M32
    if n >= 1:  a = (a + k[i]) & M32
    a, b, c = _mix(a, b, c)
    return c


def ceph_str_hash_linux(data) -> int:
    k = bytes(data, "utf-8") if isinstance(data, str) else bytes(data)
    h = 0
    for ch in k:
        h = ((h + (ch << 4) + (ch >> 4)) * 11) & M32
    return h


def ceph_str_hash(type: int, data) -> int:
    if type == CEPH_STR_HASH_LINUX:
        return ceph_str_hash_linux(data)
    if type == CEPH_STR_HASH_RJENKINS:
        return ceph_str_hash_rjenkins(data)
    raise ValueError(f"unknown hash type {type}")
