"""Codec signatures and chunk-size bucketing — the batching key.

Port of ``ceph_tpu/dispatch/signature.py``.

Two requests may share one device call only when the math guarantees
the coalesced output is byte-identical to running them alone:

1. Same *codec signature*: ``(family, k, m, technique, w, packetsize,
   chunk_mapping)``.  Codec instances are deterministic functions of
   this tuple (the encode matrix is derived from it), so requests from
   different pools — and even different plugin instances, e.g. the cuda
   and isa plugins which share matrix semantics by construction — can
   ride one call.  Codecs that don't opt in (``codec_signature``
   returning an identity-unique tuple) never group.
2. Same *chunk-size bucket*: chunk sizes are rounded up to the next
   power of two and requests padded with zero columns to the bucket
   width, so a flush sees O(log C) shapes per signature instead of one
   per distinct pool chunk size.  Zero-padding is
   output-preserving because the codes are columnwise independent:
   pointwise byte codes (RS/cauchy matrices) treat every byte column
   separately, and block-structured codes (jerasure bitmatrix packets)
   treat every ``stripe_block`` of columns separately — so the pad is
   only legal when it is a whole number of blocks (checked here; a
   misaligned codec falls back to uncoalesced execution, which is
   always correct).

Decode requests additionally key on (available chunk ids, wanted
chunk ids): the recovery matrix is a function of the survivor set, so
mixed erasure patterns cannot share a matmul.
"""
from __future__ import annotations

from typing import Tuple

# kinds of work the scheduler understands
KIND_ENCODE = "encode"
KIND_DECODE = "decode"           # reconstruct specific shards (recovery)
KIND_DECODE_CONCAT = "decode_concat"  # rebuild the logical payload (reads)


def codec_signature(ec_impl) -> Tuple:
    """The impl's grouping signature; falls back to an identity-unique
    tuple for codecs that don't declare one (never grouped, always
    executed alone — correct by construction)."""
    sig = getattr(ec_impl, "codec_signature", None)
    if sig is not None:
        return sig()
    return (type(ec_impl).__name__, id(ec_impl))


def stripe_block_of(ec_impl) -> int:
    """Columnwise-independence granularity (1 = pointwise byte codes;
    jerasure packet/word layouts override ``_stripe_block``)."""
    fn = getattr(ec_impl, "_stripe_block", None)
    return int(fn()) if fn is not None else 1


def next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def bucket_chunk_size(chunk_size: int, block: int = 1) -> int:
    """Power-of-two bucket for a chunk size, rounded up to a whole
    number of code blocks so the zero-pad never splits a block."""
    b = next_pow2(max(chunk_size, 1))
    if block > 1 and b % block:
        b += block - (b % block)
    return b


def batchable(ec_impl, chunk_size: int, kind: str) -> bool:
    """May requests of this (impl, chunk size, kind) coalesce with
    signature-mates?  False routes the request through the exact
    per-request path inside its flush — always correct, never faster."""
    if not getattr(ec_impl, "dispatch_batchable", False):
        return False
    if kind == KIND_ENCODE:
        if not hasattr(ec_impl, "encode_batch"):
            return False
        # mapped layouts (lrc-style) take the encode_batch_full /
        # per-stripe route in ecutil.encode; keep them uncoalesced
        if ec_impl.get_chunk_mapping():
            return False
    elif not hasattr(ec_impl, "decode_batch"):
        return False
    elif getattr(ec_impl, "dispatch_full_output", False):
        # full-output codecs' below-d decode interprets sub-chunk
        # positions, which bucket padding would shift — decode kinds
        # run uncoalesced (still through the dispatcher accounting,
        # still fault-guarded inside the codec)
        return False
    # the pad from chunk_size to its bucket must be whole blocks:
    # chunk_size % block == 0 here plus bucket_chunk_size rounding the
    # bucket up to a block multiple together guarantee it
    return chunk_size % stripe_block_of(ec_impl) == 0
