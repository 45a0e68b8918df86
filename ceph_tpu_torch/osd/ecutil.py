"""ECUtil — stripe bookkeeping between the object store and the EC codec.

Port of ``ceph_tpu/osd/ecutil.py:28-224`` for the matrix codecs.  The
reference loops stripes one at a time through the plugin
(src/osd/ECUtil.cc:120-159 encode, :9-45 decode); here a multi-stripe
payload is reshaped into one (S, k, C) uint8 array and handed to the
codec's batched entry points (one kernel launch for all S stripes; lrc's
``encode_batch_full``, one per layer).  Any other encode with a
``mapping=`` profile goes through the per-stripe loop of the reference
instead; results are identical either way, and each
shard's buffer is its stripe-concatenated chunks.  Decodes always take
``decode_batch``, which handles the mapping itself.

``HashInfo`` (``ceph_tpu/osd/ecutil.py:227-262``) keeps the cumulative
per-shard crc32c, hashed with the port's host ``utils/crc32c.py``.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Set

import numpy as np

from ..trace.devprof import g_devprof
from ..trace.oplat import g_oplat
from ..utils.crc32c import crc32c


class stripe_info_t:
    """(stripe_size=k, stripe_width=k*chunk_size) (ECUtil.h:31-76)."""

    def __init__(self, stripe_size: int, stripe_width: int):
        if stripe_width % stripe_size:
            raise ValueError(f"stripe width {stripe_width} is not a "
                             f"multiple of {stripe_size}")
        self.stripe_width = stripe_width
        self.chunk_size = stripe_width // stripe_size

    def logical_offset_is_stripe_aligned(self, logical: int) -> bool:
        return logical % self.stripe_width == 0

    def get_stripe_width(self) -> int:
        return self.stripe_width

    def get_chunk_size(self) -> int:
        return self.chunk_size

    def logical_to_prev_chunk_offset(self, offset: int) -> int:
        return (offset // self.stripe_width) * self.chunk_size

    def logical_to_next_chunk_offset(self, offset: int) -> int:
        return ((offset + self.stripe_width - 1)
                // self.stripe_width) * self.chunk_size

    def logical_to_prev_stripe_offset(self, offset: int) -> int:
        return offset - (offset % self.stripe_width)

    def logical_to_next_stripe_offset(self, offset: int) -> int:
        rem = offset % self.stripe_width
        return offset if not rem else offset - rem + self.stripe_width

    def aligned_logical_offset_to_chunk_offset(self, offset: int) -> int:
        assert offset % self.stripe_width == 0
        return (offset // self.stripe_width) * self.chunk_size

    def aligned_chunk_offset_to_logical_offset(self, offset: int) -> int:
        assert offset % self.chunk_size == 0
        return (offset // self.chunk_size) * self.stripe_width

    def offset_len_to_stripe_bounds(self, offset: int, length: int):
        start = self.logical_to_prev_stripe_offset(offset)
        end = self.logical_to_next_stripe_offset(offset + length)
        return start, end - start


def _pack_rows(want_l, rows) -> Dict[int, np.ndarray]:
    """Every wanted shard's body lands in one contiguous (n_want, S*C)
    buffer; the per-shard outputs are row views of it."""
    rows = list(rows)
    S, C = rows[0].shape
    pack = np.empty((len(want_l), S * C), dtype=np.uint8)
    for j, src in enumerate(rows):
        pack[j].reshape(S, C)[:] = src
    g_devprof.account_host_copy("ecutil.pack_shards", pack.nbytes)
    return {i: pack[j] for j, i in enumerate(want_l)}


def encode(sinfo: stripe_info_t, ec_impl, data,
           want: Set[int]) -> Dict[int, np.ndarray]:
    """Erasure-code a stripe-aligned payload; returns shard id -> buffer."""
    buf = np.frombuffer(bytes(data), dtype=np.uint8) \
        if not isinstance(data, np.ndarray) else data
    logical_size = len(buf)
    if logical_size % sinfo.get_stripe_width():
        raise ValueError(f"payload of {logical_size} bytes is not stripe "
                         f"aligned ({sinfo.get_stripe_width()})")
    if logical_size == 0:
        return {}
    S = logical_size // sinfo.get_stripe_width()
    k = ec_impl.get_data_chunk_count()
    C = sinfo.get_chunk_size()
    want_l = sorted(want)

    prepare = getattr(ec_impl, "regen_prepare_batch", None)
    if prepare is not None:
        # product-matrix regenerating codes (ec/regenerating.py): the
        # payload assembles into batched message matrices first, and one
        # Ψ projection yields every shard row (a full-output codec: no
        # shard holds raw payload bytes)
        allc = ec_impl.encode_batch(prepare(buf, S))     # (S, n, C)
        g_oplat.checkpoint("device_call")
        return _pack_rows(want_l, (allc[:, i, :] for i in want_l))
    if hasattr(ec_impl, "encode_batch_full"):
        # mapped layered codes (lrc): one batched call per layer yields
        # every physical chunk directly
        allc = ec_impl.encode_batch_full(buf.reshape(S, k, C))  # (S, n, C)
        # stage ledger: the codec call returned; the submitting op's d2h
        # stage (stamped by the dispatcher) covers the pack below
        g_oplat.checkpoint("device_call")
        return _pack_rows(want_l, (allc[:, i, :] for i in want_l))
    if hasattr(ec_impl, "encode_batch") and not ec_impl.get_chunk_mapping():
        stripes = buf.reshape(S, k, C)
        coding = ec_impl.encode_batch(stripes)        # (S, m, C)
        g_oplat.checkpoint("device_call")
        return _pack_rows(want_l,
                          (stripes[:, i, :] if i < k
                           else coding[:, i - k, :] for i in want_l))

    out_parts: Dict[int, List[np.ndarray]] = {i: [] for i in want}
    w = sinfo.get_stripe_width()
    for s in range(S):
        encoded = ec_impl.encode(want, buf[s * w:(s + 1) * w])
        for i, chunk in encoded.items():
            out_parts[i].append(chunk)
    # host-only codec loop: the "device_call" stage is the codec call
    g_oplat.checkpoint("device_call")
    return _pack_rows(want_l, (np.stack(out_parts[i]) for i in want_l))


def decode_concat(sinfo: stripe_info_t, ec_impl,
                  to_decode: Dict[int, np.ndarray]) -> np.ndarray:
    """Rebuild the full logical payload from whole-object shards
    (ECUtil.cc:9-45)."""
    if not to_decode:
        raise ValueError("no shards to decode from")
    total = len(next(iter(to_decode.values())))
    C = sinfo.get_chunk_size()
    if total % C or any(len(b) != total for b in to_decode.values()):
        raise ValueError("shards differ in length or are not chunk aligned")
    if total == 0:
        return np.zeros(0, dtype=np.uint8)
    S = total // C
    k = ec_impl.get_data_chunk_count()
    chunks2d = {i: np.asarray(b, dtype=np.uint8).reshape(S, C)
                for i, b in to_decode.items()}
    if hasattr(ec_impl, "decode_payload_batch"):
        # non-systematic regenerating codes: the codec rebuilds the
        # logical payload from any k shard chunks (structured decode)
        data = ec_impl.decode_payload_batch(chunks2d)    # (S, width)
        g_oplat.checkpoint("device_call")
        return np.ascontiguousarray(data).reshape(-1)
    # decode_batch is keyed by *physical* chunk ids; logical data row
    # i lives at chunk_index(i) for mapped codes
    want_phys = [ec_impl.chunk_index(i) for i in range(k)]
    got = ec_impl.decode_batch(chunks2d, want_phys)
    g_oplat.checkpoint("device_call")
    data = np.stack([got[want_phys[i]] for i in range(k)],
                    axis=1)  # (S, k, C)
    return data.reshape(-1)


def decode(sinfo: stripe_info_t, ec_impl,
           to_decode: Dict[int, np.ndarray],
           need: Sequence[int]) -> Dict[int, np.ndarray]:
    """Reconstruct specific shards across all stripes (ECUtil.cc:47-118),
    e.g. recovery of a failed OSD's chunk for a whole object."""
    if not to_decode:
        raise ValueError("no shards to decode from")
    total = len(next(iter(to_decode.values())))
    C = sinfo.get_chunk_size()
    if total == 0:
        return {i: np.zeros(0, dtype=np.uint8) for i in need}
    S = total // C
    chunks2d = {i: np.asarray(b, dtype=np.uint8).reshape(S, C)
                for i, b in to_decode.items()}
    got = ec_impl.decode_batch(chunks2d, list(need))
    g_oplat.checkpoint("device_call")
    return {i: np.ascontiguousarray(got[i]).reshape(-1) for i in need}


class HashInfo:
    """Cumulative per-shard crc32c (ECUtil.cc:161-207)."""

    def __init__(self, num_chunks: int = 0):
        self.total_chunk_size = 0
        self.cumulative_shard_hashes = [0xFFFFFFFF] * num_chunks
        self.projected_total_chunk_size = 0

    def has_chunk_hash(self) -> bool:
        return bool(self.cumulative_shard_hashes)

    def append(self, old_size: int,
               to_append: Dict[int, np.ndarray]) -> None:
        assert old_size == self.total_chunk_size
        size = len(next(iter(to_append.values())))
        if self.has_chunk_hash():
            assert len(to_append) == len(self.cumulative_shard_hashes)
            for i, buf in to_append.items():
                assert len(buf) == size
                self.cumulative_shard_hashes[i] = crc32c(
                    buf, self.cumulative_shard_hashes[i])
        self.total_chunk_size += size

    def get_chunk_hash(self, shard: int) -> int:
        return self.cumulative_shard_hashes[shard]

    def get_total_chunk_size(self) -> int:
        return self.total_chunk_size

    def dump(self) -> dict:
        return {
            "total_chunk_size": self.total_chunk_size,
            "cumulative_shard_hashes": [
                {"shard": i, "hash": h}
                for i, h in enumerate(self.cumulative_shard_hashes)],
        }
