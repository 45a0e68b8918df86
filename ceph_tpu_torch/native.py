"""ctypes bindings to the port's host C++ library.

Port of ``ceph_tpu/native.py``.  The library supplies:

- an independent CRUSH map evaluator (cross-validates the Python mapper
  and the card's kernels, and is the threaded CPU batch baseline, the
  ParallelPGMapper analog);
- GF(2^8) region encode (the isa-l ec_encode_data-class CPU path, the
  bench's host baseline);
- crc32c for chunk HashInfo (``utils/crc32c.py``).

The sources are the port's own copies (``csrc_host/crush_mapper.cpp``,
``csrc_host/gf_rs.cpp``), built on first use by ``ops/_build_host.py``
(g++ -O3 -march=native) into the git-ignored ``build/ceph_tpu_torch/``.
There is no software route: a missing compiler or a failed build raises
from ``get_lib`` and from every entry point here.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import numpy as np

from .common.lockdep import DebugLock
from .crush.constants import (
    CRUSH_BUCKET_LIST, CRUSH_BUCKET_STRAW, CRUSH_BUCKET_STRAW2,
    CRUSH_BUCKET_TREE, CRUSH_BUCKET_UNIFORM,
)
from .crush.types import CrushMap
from .ops import _build_host

LIB_NAME = "ceph_host_native"
SOURCES = ("crush_mapper.cpp", "gf_rs.cpp")

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_u8p = ctypes.POINTER(ctypes.c_uint8)

# argtypes are mandatory: passing python ints for int64_t params without
# them leaves the upper register bits undefined (SysV ABI)
_SIGNATURES = {
    "crush_set_ln_tables": ([_i64p, _i64p], None),
    "crush_do_rule_c": ([_i64p, ctypes.c_int64, ctypes.c_int,
                         ctypes.c_int64, _i64p, ctypes.c_int, _u32p,
                         ctypes.c_int64], ctypes.c_int),
    "crush_do_rule_batch": ([_i64p, ctypes.c_int64, ctypes.c_int, _i64p,
                             ctypes.c_int64, _i64p, ctypes.c_int, _i32p,
                             _u32p, ctypes.c_int64], ctypes.c_int),
    "gf_rs_encode": ([_u8p, ctypes.c_int, ctypes.c_int, _u8p, _u8p,
                      ctypes.c_int64], None),
    "gf_region_xor": ([_u8p, _u8p, _u8p, ctypes.c_int64], None),
    "ceph_crc32c": ([ctypes.c_uint32, _u8p, ctypes.c_int64],
                    ctypes.c_uint32),
    "gf_mul_c": ([ctypes.c_uint8, ctypes.c_uint8], ctypes.c_uint8),
}

_lock = DebugLock("native::load")
_lib: Optional[ctypes.CDLL] = None


def get_lib() -> ctypes.CDLL:
    """The loaded library, built on first use; raises if it cannot be."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = _build_host.load(LIB_NAME, SOURCES, _SIGNATURES)
        # inject the ln tables once
        from .crush.ln import LL_NP, RH_LH_NP
        rh = RH_LH_NP.astype(np.int64)
        llt = LL_NP.astype(np.int64)
        lib.crush_set_ln_tables(rh.ctypes.data_as(_i64p),
                                llt.ctypes.data_as(_i64p))
        # the GF(2^8) and crc32c tables fill lazily on their first call:
        # fill them here, under the load lock, before any two threads can
        # race on them
        lib.gf_mul_c(1, 1)
        lib.ceph_crc32c(0, None, 0)
        _lib = lib
        return lib


def native_available() -> bool:
    """True once the library is built and loaded; a failed build raises
    (no caller treats it as absent)."""
    get_lib()
    return True


# ---- crush ----------------------------------------------------------------

def serialize_map(m: CrushMap, choose_args=None) -> np.ndarray:
    """Flatten a CrushMap into the int64 blob the native parser reads.

    ``choose_args`` (crush.h crush_choose_arg: per-bucket id overrides
    for hashing plus per-position weight_set replacements) serialize as
    a trailing section; absent section == no overrides."""
    out: List[int] = [
        m.max_devices, m.choose_local_tries, m.choose_local_fallback_tries,
        m.choose_total_tries, m.chooseleaf_descend_once,
        m.chooseleaf_vary_r, m.chooseleaf_stable,
        m.max_buckets, m.max_rules,
    ]
    for b in m.buckets:
        if b is None:
            out.append(0)
            continue
        out += [1, b.id, b.alg, b.type, b.size]
        out += list(b.items)
        if b.alg == CRUSH_BUCKET_UNIFORM:
            out.append(b.item_weight)
        elif b.alg == CRUSH_BUCKET_LIST:
            out += list(b.item_weights) + list(b.sum_weights)
        elif b.alg == CRUSH_BUCKET_TREE:
            out.append(b.num_nodes)
            out += list(b.node_weights)
        elif b.alg == CRUSH_BUCKET_STRAW:
            out += list(b.item_weights) + list(b.straws)
        elif b.alg == CRUSH_BUCKET_STRAW2:
            out += list(b.item_weights)
        else:
            raise ValueError(f"bucket alg {b.alg}")
    for r in m.rules:
        if r is None:
            out.append(0)
            continue
        out += [1, r.ruleset, r.type, r.min_size, r.max_size, len(r.steps)]
        for s in r.steps:
            out += [s.op, s.arg1, s.arg2]
    entries = []
    if choose_args is not None:
        for bno, arg in enumerate(choose_args):
            if arg is None or (not arg.ids and not arg.weight_set):
                continue
            b = m.buckets[bno] if bno < len(m.buckets) else None
            if b is None:
                continue
            # the C++ parser advances by b.size per row: a mismatched arg
            # (e.g. from an externally decoded binary map) must fail here,
            # not parse misaligned and return wrong placements
            if arg.ids and len(arg.ids) != b.size:
                raise ValueError(
                    f"choose_args ids len {len(arg.ids)} != bucket "
                    f"size {b.size} (bucket index {bno})")
            for ws in arg.weight_set or []:
                if len(ws.weights) != b.size:
                    raise ValueError(
                        f"choose_args weight_set row len "
                        f"{len(ws.weights)} != bucket size {b.size} "
                        f"(bucket index {bno})")
            ent = [bno, 1 if arg.ids else 0, b.size]
            if arg.ids:
                ent += list(arg.ids)
            npos = len(arg.weight_set) if arg.weight_set else 0
            ent.append(npos)
            for ws in arg.weight_set or []:
                ent += list(ws.weights)
            entries.append(ent)
    out.append(len(entries))
    for ent in entries:
        out += ent
    return np.array(out, dtype=np.int64)


class NativeCrushMapper:
    """Batch CRUSH evaluation through the C++ engine."""

    def __init__(self, m: CrushMap, choose_args=None):
        self.lib = get_lib()
        self.blob = serialize_map(m, choose_args)

    def do_rule(self, ruleno: int, x: int, result_max: int,
                weight: Sequence[int]) -> List[int]:
        res = np.zeros(result_max, dtype=np.int64)
        w = np.ascontiguousarray(weight, dtype=np.uint32)
        n = self.lib.crush_do_rule_c(
            self.blob.ctypes.data_as(_i64p), len(self.blob), ruleno, x,
            res.ctypes.data_as(_i64p), result_max,
            w.ctypes.data_as(_u32p), len(w))
        if n < 0:
            raise RuntimeError("native map parse failed")
        return res[:n].tolist()

    def do_rule_batch(self, ruleno: int, xs: Sequence[int], result_max: int,
                      weight: Sequence[int]):
        """Returns (out (nx, result_max) int64 NONE-padded, lens (nx,))."""
        xs = np.ascontiguousarray(xs, dtype=np.int64)
        out = np.zeros((len(xs), result_max), dtype=np.int64)
        lens = np.zeros(len(xs), dtype=np.int32)
        w = np.ascontiguousarray(weight, dtype=np.uint32)
        rc = self.lib.crush_do_rule_batch(
            self.blob.ctypes.data_as(_i64p), len(self.blob), ruleno,
            xs.ctypes.data_as(_i64p), len(xs),
            out.ctypes.data_as(_i64p), result_max,
            lens.ctypes.data_as(_i32p), w.ctypes.data_as(_u32p), len(w))
        if rc < 0:
            raise RuntimeError("native map parse failed")
        return out, lens


# ---- gf -------------------------------------------------------------------

def native_rs_encode(matrix_rows: np.ndarray, data: np.ndarray) -> np.ndarray:
    """rows (r, k) x data (k, n) -> (r, n) over GF(2^8), C++ path."""
    lib = get_lib()
    r, k = matrix_rows.shape
    kk, n = data.shape
    if k != kk:
        raise ValueError(f"matrix has k={k}, data has {kk} rows")
    mat = np.ascontiguousarray(matrix_rows, dtype=np.uint8)
    dat = np.ascontiguousarray(data, dtype=np.uint8)
    out = np.zeros((r, n), dtype=np.uint8)
    lib.gf_rs_encode(mat.ctypes.data_as(_u8p), r, k,
                     dat.ctypes.data_as(_u8p), out.ctypes.data_as(_u8p),
                     n)
    return out


def gf_mul_c(a: int, b: int) -> int:
    """a * b in GF(2^8) (polynomial 0x11d), from the library's table."""
    return int(get_lib().gf_mul_c(a, b))


def crc32c(data, crc: int = 0xFFFFFFFF) -> int:
    """Ceph-convention crc32c: raw castagnoli update, no pre/post inversion
    (reference include/crc32c.h); Ceph callers seed with -1.

    Hashes the logical bytes, as ``utils/crc32c.crc32c_sw`` does: an
    array is taken as ``np.ascontiguousarray(a.astype(np.uint8))`` in C
    order (a strided or 2-D view hashes its elements, not the memory
    under its base pointer); anything else as ``bytes(data)``."""
    lib = get_lib()
    if isinstance(data, np.ndarray):
        buf = np.ascontiguousarray(data.astype(np.uint8, copy=False))
    elif isinstance(data, (bytes, bytearray)):
        buf = np.frombuffer(data, dtype=np.uint8)
    else:
        buf = np.frombuffer(bytes(data), dtype=np.uint8)
    return int(lib.ceph_crc32c(crc & 0xFFFFFFFF, buf.ctypes.data_as(_u8p),
                               buf.size))
