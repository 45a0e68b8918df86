"""Batch assembly: many queued codec requests -> ONE padded device call.

Port of ``ceph_tpu/dispatch/batch.py``.  The shape the codec exploits
*within* one op (all stripes of one object in a single kernel launch)
applied one level up: all stripes of all queued ops of one codec
signature.  Assembly is numpy reshaping on the host; the single device
call goes through the codec's own batched entry points (``encode_batch``
/ ``decode_batch``), so on ``backend=cuda`` a flush is one launch of the
GF(2^8) bit-matmul kernel and the kernel timer sees it as the
uncoalesced path would.

Correctness contract: for every request in a group, slicing its
rows/columns back out of the coalesced result is byte-identical to
running the request alone.  This holds because (a) stripes are
independent — concatenating along S changes nothing, and (b) the
zero-pad from C to the bucket width is whole code blocks, and blocks are
columnwise independent (signature.batchable enforces it).

Requests are executed via the exact ecutil entry points when alone
(``run_one`` IS the passthrough path — not a reimplementation of it), so
window=0 behavior is the uncoalesced behavior by construction.

With a mesh up (``mesh/``, ``ec_mesh_chips``), encode groups execute
through the mesh runtime, one K1 launch per member; a codec whose
backend does not live on the mesh's platform, or whose layout is not
row-shardable, is declined and runs the single-device path.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from ..trace.devprof import g_devprof
from .signature import KIND_DECODE_CONCAT, KIND_ENCODE, next_pow2


class Request:
    """One queued codec work item (encode / decode / reconstruct)."""

    __slots__ = ("kind", "sinfo", "ec_impl", "payload", "chunks", "need",
                 "want", "future", "parent_span", "trace_id", "nbytes",
                 "n_stripes", "chunk_size", "enq_t", "batchable", "key",
                 "ledger")

    def __init__(self, kind: str, sinfo, ec_impl, *, payload=None,
                 chunks=None, need=None, want=None):
        self.kind = kind
        self.sinfo = sinfo
        self.ec_impl = ec_impl
        self.payload = payload            # np.uint8 1D (encode)
        self.chunks = chunks              # {chunk id: np.uint8 1D}
        self.need = tuple(need) if need is not None else ()
        self.want = set(want) if want is not None else set()
        self.future = None                # bound by the scheduler
        self.parent_span = None
        self.trace_id = 0
        self.chunk_size = sinfo.get_chunk_size()
        if kind == KIND_ENCODE:
            self.nbytes = len(payload)
            self.n_stripes = (len(payload)
                              // max(sinfo.get_stripe_width(), 1))
        else:
            total = len(next(iter(chunks.values()))) if chunks else 0
            self.nbytes = sum(len(b) for b in chunks.values())
            self.n_stripes = total // max(self.chunk_size, 1)
        self.enq_t = 0.0
        self.batchable = False
        self.key = None
        self.ledger = None       # stage-latency ledger (trace/oplat)


def _ecutil():
    # deferred, as in the JAX package: the OSD's ECBackend imports the
    # dispatcher, and ecutil sits under the same osd package
    from ..osd import ecutil
    return ecutil


def _mark_device_call(reqs: List["Request"]) -> None:
    """One batched codec call just returned: stamp every batchmate's
    stage ledger (each op waited on the SAME call — per-op attribution,
    like the batch_window stamp in scheduler._execute)."""
    t = time.perf_counter()
    for r in reqs:
        if r.ledger is not None:
            r.ledger.mark("device_call", t)


def _use_device(ec_impl) -> bool:
    return bool(getattr(ec_impl, "_use_device", lambda: False)())


def run_one(req: Request):
    """Exact per-request execution — the window=0 passthrough path and
    the re-run when a batched call throws.  Calls the SAME ecutil entry
    points ECBackend calls, so outputs are identical to the uncoalesced
    code by construction."""
    eu = _ecutil()
    if req.kind == KIND_ENCODE:
        return eu.encode(req.sinfo, req.ec_impl, req.payload, req.want)
    arrays = {i: np.asarray(b, dtype=np.uint8)
              for i, b in req.chunks.items()}
    if req.kind == KIND_DECODE_CONCAT:
        return eu.decode_concat(req.sinfo, req.ec_impl, arrays)
    return eu.decode(req.sinfo, req.ec_impl, arrays, list(req.need))


def _pad_cols(a: np.ndarray, cb: int) -> np.ndarray:
    """Zero-pad the last (byte-column) axis to the bucket width.  A
    real pad is a whole-buffer host copy — accounted on the device-flow
    profiler so the copy ledger shows what bucket padding costs."""
    c = a.shape[-1]
    if c == cb:
        return a
    width = [(0, 0)] * (a.ndim - 1) + [(0, cb - c)]
    out = np.pad(a, width)
    g_devprof.account_host_copy("dispatch.pad_cols", out.nbytes)
    return out


def _pad_stripes(big: np.ndarray, use_device: bool) -> np.ndarray:
    """Pad the stripe axis to a power of two on the device path, as the
    JAX package does (there it bounds the jit cache to O(log S) batch
    shapes).  Zero stripes encode/decode independently and are sliced
    off.  The host path (``backend=host``) never pads."""
    s = big.shape[0]
    if not use_device:
        return big
    st = next_pow2(s)
    if st == s:
        return big
    width = [(0, st - s)] + [(0, 0)] * (big.ndim - 1)
    out = np.pad(big, width)
    g_devprof.account_host_copy("dispatch.pad_stripes", out.nbytes)
    return out


def run_group(reqs: List[Request], bucket_c: int) -> List:
    """One coalesced device call for a signature/bucket group; returns
    per-request results aligned with *reqs*.  Any failure propagates to
    the caller, which re-runs each request alone so one bad request
    cannot poison its batchmates.

    With a mesh up encode groups — including single-request flushes,
    whose stripes alone can span the members — execute through the mesh
    runtime; mesh off (the default) or size 1 is the existing path by
    construction.  Decode groups ride the mesh one level down: every
    path here funnels into the codec's ``decode_batch``, whose mesh hook
    (matrix_plugin.py / regenerating.py -> ``decode_stacked``) shards
    the survivor stack across the members."""
    leader = reqs[0].ec_impl
    kind = reqs[0].kind
    use_device = _use_device(leader)
    if kind == KIND_ENCODE:
        if len(reqs) > 1 or _mesh_active():
            return _run_group_encode(reqs, bucket_c, leader, use_device)
        return [run_one(reqs[0])]
    if len(reqs) == 1:
        return [run_one(reqs[0])]
    return _run_group_decode(reqs, bucket_c, leader, use_device, kind)


def _mesh_active() -> bool:
    from ..mesh import g_mesh
    return g_mesh.active()


def _run_group_encode(reqs, bucket_c, leader, use_device):
    # requests may carry different pool chunk sizes within one bucket:
    # each is zero-padded to the bucket width and sliced back to its own
    # width (columnwise independence makes the pad invisible)
    k = leader.get_data_chunk_count()
    # full-output codecs (product-matrix regenerating): the payload
    # assembles into message matrices via the codec's own hook, and
    # encode_batch yields every shard row — the post-matmul slice takes
    # all rows from the coalesced result, none from the input
    prepare = getattr(leader, "regen_prepare_batch", None)
    full_out = bool(getattr(leader, "dispatch_full_output", False))
    raw, offsets, s0 = [], [], 0
    for r in reqs:
        if prepare is not None:
            stripes = prepare(r.payload, r.n_stripes)
        else:
            stripes = np.frombuffer(bytes(r.payload), dtype=np.uint8) \
                if not isinstance(r.payload, np.ndarray) else r.payload
            stripes = stripes.reshape(r.n_stripes, k, r.chunk_size)
        raw.append(stripes)
        offsets.append((s0, stripes))
        s0 += r.n_stripes
    # mesh path: the runtime assembles straight into its pooled padded
    # staging buffer and splits the batch axis over the members; None
    # means mesh down or the codec declined (not row-shardable, or its
    # backend is not on the mesh's platform)
    from ..mesh import g_mesh
    coding = g_mesh.encode_stacked(leader, raw, bucket_c)
    if coding is None:
        stacks = [_pad_cols(st, bucket_c) for st in raw]
        if len(stacks) == 1:
            # a single-request flush only reaches here when the mesh
            # declined it: run the exact per-request path
            return [run_one(reqs[0])]
        stacked = np.ascontiguousarray(np.concatenate(stacks))
        g_devprof.account_host_copy("dispatch.stack", stacked.nbytes)
        big = _pad_stripes(stacked, use_device)
        coding = leader.encode_batch(big)      # (S_total[, pad], m, Cb)
    _mark_device_call(reqs)
    coding = np.asarray(coding)
    out: List[Dict[int, np.ndarray]] = []
    for r, (off, stripes) in zip(reqs, offsets):
        # one contiguous pack per request, shard outputs as row views
        # (the same idiom as ecutil._pack_rows)
        want_l = sorted(r.want)
        pack = np.empty((len(want_l), r.n_stripes * r.chunk_size),
                        dtype=np.uint8)
        for j, i in enumerate(want_l):
            dst = pack[j].reshape(r.n_stripes, r.chunk_size)
            if full_out:
                dst[:] = coding[off:off + r.n_stripes, i, :r.chunk_size]
            elif i < k:
                dst[:] = stripes[:, i, :]
            else:
                dst[:] = coding[off:off + r.n_stripes, i - k,
                                :r.chunk_size]
        g_devprof.account_host_copy("dispatch.pack_shards", pack.nbytes)
        out.append({i: pack[j] for j, i in enumerate(want_l)})
    return out


def _run_group_decode(reqs, bucket_c, leader, use_device, kind):
    k = leader.get_data_chunk_count()
    ids = sorted(reqs[0].chunks)
    stacked: Dict[int, np.ndarray] = {}
    for cid in ids:
        parts = [_pad_cols(np.asarray(r.chunks[cid], dtype=np.uint8)
                           .reshape(r.n_stripes, r.chunk_size), bucket_c)
                 for r in reqs]
        joined = np.ascontiguousarray(np.concatenate(parts))
        g_devprof.account_host_copy("dispatch.stack", joined.nbytes)
        stacked[cid] = _pad_stripes(joined, use_device)
    if kind == KIND_DECODE_CONCAT:
        want_phys = [leader.chunk_index(i) for i in range(k)]
    else:
        want_phys = list(reqs[0].need)
    got = leader.decode_batch(stacked, want_phys)
    _mark_device_call(reqs)
    got = {i: np.asarray(b) for i, b in got.items()}
    out: List = []
    s0 = 0
    for r in reqs:
        s1, c = s0 + r.n_stripes, r.chunk_size
        if kind == KIND_DECODE_CONCAT:
            data = np.stack([got[want_phys[i]][s0:s1, :c]
                             for i in range(k)], axis=1)   # (S, k, C)
            out.append(np.ascontiguousarray(data).reshape(-1))
        else:
            out.append({i: np.ascontiguousarray(
                got[i][s0:s1, :c]).reshape(-1) for i in r.need})
        s0 = s1
    return out
