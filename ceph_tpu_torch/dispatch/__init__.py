"""Cross-PG dynamic-batching device scheduler for EC codec work.

Port of ``ceph_tpu/dispatch/``: concurrent encode/decode/reconstruct
requests from every PG on an OSD coalesce into one padded batched codec
call per flush — on the card, one launch of the GF(2^8) bit-matmul
kernel.  ``window=0`` (the default) is an exact passthrough to the
uncoalesced ``osd/ecutil.py`` calls.
"""
from .batch import Request, run_group, run_one
from .future import DispatchFuture
from .scheduler import (DeviceDispatcher, dispatch_perf_counters,
                        g_dispatcher)
from .signature import (KIND_DECODE, KIND_DECODE_CONCAT, KIND_ENCODE,
                        batchable, bucket_chunk_size, codec_signature)

__all__ = [
    "Request", "run_group", "run_one",
    "DispatchFuture",
    "DeviceDispatcher", "dispatch_perf_counters", "g_dispatcher",
    "KIND_DECODE", "KIND_DECODE_CONCAT", "KIND_ENCODE",
    "batchable", "bucket_chunk_size", "codec_signature",
]
