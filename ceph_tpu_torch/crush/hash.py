"""rjenkins 32-bit hash family used by CRUSH.

Bit-exact with the reference (src/crush/hash.c): the Jenkins mix with seed
1315423911 and pad constants 231232/1232, in 1..5-argument variants.  The
scalar versions use masked Python ints (the oracle); the numpy versions are
vectorized for the batch host mapper; the torch versions (int64 masked to
32 bits) live in ops/crush_kernels.py and the CUDA ones in
csrc/crush_fast.cu, with the same structure.
"""
from __future__ import annotations

import numpy as np

M32 = 0xFFFFFFFF
CRUSH_HASH_SEED = 1315423911


def _mix(a: int, b: int, c: int):
    a = (a - b) & M32; a = (a - c) & M32; a ^= c >> 13
    b = (b - c) & M32; b = (b - a) & M32; b ^= (a << 8) & M32
    c = (c - a) & M32; c = (c - b) & M32; c ^= b >> 13
    a = (a - b) & M32; a = (a - c) & M32; a ^= c >> 12
    b = (b - c) & M32; b = (b - a) & M32; b ^= (a << 16) & M32
    c = (c - a) & M32; c = (c - b) & M32; c ^= b >> 5
    a = (a - b) & M32; a = (a - c) & M32; a ^= c >> 3
    b = (b - c) & M32; b = (b - a) & M32; b ^= (a << 10) & M32
    c = (c - a) & M32; c = (c - b) & M32; c ^= b >> 15
    return a, b, c


def crush_hash32(a: int) -> int:
    a &= M32
    h = (CRUSH_HASH_SEED ^ a) & M32
    b, x, y = a, 231232, 1232
    b, x, h = _mix(b, x, h)
    y, a, h = _mix(y, a, h)
    return h


def crush_hash32_2(a: int, b: int) -> int:
    a &= M32; b &= M32
    h = (CRUSH_HASH_SEED ^ a ^ b) & M32
    x, y = 231232, 1232
    a, b, h = _mix(a, b, h)
    x, a, h = _mix(x, a, h)
    b, y, h = _mix(b, y, h)
    return h


def crush_hash32_3(a: int, b: int, c: int) -> int:
    a &= M32; b &= M32; c &= M32
    h = (CRUSH_HASH_SEED ^ a ^ b ^ c) & M32
    x, y = 231232, 1232
    a, b, h = _mix(a, b, h)
    c, x, h = _mix(c, x, h)
    y, a, h = _mix(y, a, h)
    b, x, h = _mix(b, x, h)
    y, c, h = _mix(y, c, h)
    return h


def crush_hash32_4(a: int, b: int, c: int, d: int) -> int:
    a &= M32; b &= M32; c &= M32; d &= M32
    h = (CRUSH_HASH_SEED ^ a ^ b ^ c ^ d) & M32
    x, y = 231232, 1232
    a, b, h = _mix(a, b, h)
    c, d, h = _mix(c, d, h)
    a, x, h = _mix(a, x, h)
    y, b, h = _mix(y, b, h)
    c, x, h = _mix(c, x, h)
    y, d, h = _mix(y, d, h)
    return h


def crush_hash32_5(a: int, b: int, c: int, d: int, e: int) -> int:
    a &= M32; b &= M32; c &= M32; d &= M32; e &= M32
    h = (CRUSH_HASH_SEED ^ a ^ b ^ c ^ d ^ e) & M32
    x, y = 231232, 1232
    a, b, h = _mix(a, b, h)
    c, d, h = _mix(c, d, h)
    e, x, h = _mix(e, x, h)
    y, a, h = _mix(y, a, h)
    b, x, h = _mix(b, x, h)
    y, c, h = _mix(y, c, h)
    d, x, h = _mix(d, x, h)
    y, e, h = _mix(y, e, h)
    return h


# ---- numpy vectorized (uint32 lanes) --------------------------------------

def _mix_np(a, b, c):
    a = a - b; a = a - c; a = a ^ (c >> np.uint32(13))
    b = b - c; b = b - a; b = b ^ (a << np.uint32(8))
    c = c - a; c = c - b; c = c ^ (b >> np.uint32(13))
    a = a - b; a = a - c; a = a ^ (c >> np.uint32(12))
    b = b - c; b = b - a; b = b ^ (a << np.uint32(16))
    c = c - a; c = c - b; c = c ^ (b >> np.uint32(5))
    a = a - b; a = a - c; a = a ^ (c >> np.uint32(3))
    b = b - c; b = b - a; b = b ^ (a << np.uint32(10))
    c = c - a; c = c - b; c = c ^ (b >> np.uint32(15))
    return a, b, c


def crush_hash32_2_np(a, b):
    a = np.asarray(a, dtype=np.uint32)
    b = np.asarray(b, dtype=np.uint32)
    h = np.uint32(CRUSH_HASH_SEED) ^ a ^ b
    x = np.uint32(231232) * np.ones_like(a)
    y = np.uint32(1232) * np.ones_like(a)
    a, b, h = _mix_np(a, b, h)
    x, a, h = _mix_np(x, a, h)
    b, y, h = _mix_np(b, y, h)
    return h


def crush_hash32_3_np(a, b, c):
    a = np.asarray(a, dtype=np.uint32)
    b = np.asarray(b, dtype=np.uint32)
    c = np.asarray(c, dtype=np.uint32)
    a, b, c = np.broadcast_arrays(a, b, c)
    h = np.uint32(CRUSH_HASH_SEED) ^ a ^ b ^ c
    x = np.full_like(a, 231232)
    y = np.full_like(a, 1232)
    a, b, h = _mix_np(a.copy(), b.copy(), h)
    c, x, h = _mix_np(c.copy(), x, h)
    y, a, h = _mix_np(y, a, h)
    b, x, h = _mix_np(b, x, h)
    y, c, h = _mix_np(y, c, h)
    return h
