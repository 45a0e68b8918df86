"""Shared base for matrix-RS erasure-code plugins (isa / cuda / jerasure).

Port of ``ceph_tpu/ec/matrix_plugin.py``.  Wires a ``MatrixRSCodec``
(host oracle, used by ``decode_chunks``) and the device backend
(ops/gf_matmul.DeviceRSBackend, the GF(2^8) bit-matmul kernel) into the
ErasureCode ABI.  ``encode_batch``, ``decode_batch`` and
``encode_chunks`` run on the backend's device: the CUDA kernel for
``backend=cuda``, its plain PyTorch version for ``backend=host``.

Codecs whose device layout is not whole chunks (jerasure's word and
bitmatrix codes) override the hooks, as in the JAX package:
``encode_batch_device`` (the layout change and the kernel on tensors on
the device), ``_stripe_block`` (the code block a stripe's chunk must be
a whole number of) and ``_device_decode_supported``; where the latter is
False, ``decode_batch`` decodes on the host codec, chosen by technique
before any device call (``ceph_tpu/ec/jerasure.py:203-207``), and
``decode_batch_device`` raises.

Deliberately not carried over from the JAX package: the fault guard
(injection, retry, watchdog), the circuit breaker and the host fallback
on ``DeviceUnavailable``.  A CUDA error propagates to the caller; the
port never answers a device request from the CPU.  The mesh hook is
carried: with a mesh up, ``decode_batch``'s survivor matmul runs across
the mesh members (``g_mesh.decode_stacked``).
"""
from __future__ import annotations

from typing import Dict, Sequence, Set

import numpy as np
import torch

from ..common.kernel_trace import g_kernel_timer
from ..common.lockdep import DebugLock
from .base import ErasureCode
from .rs_codec import MatrixRSCodec, plan_decode


class ErasureCodeMatrixRS(ErasureCode):
    """A systematic matrix code with k data + m coding chunks."""

    # True when encode_batch IS the plain row-independent bit-matmul on
    # raw (S, k, C) chunks; the fused resident encode (ops/resident.py)
    # models only that layout.  The JAX package's name is kept; codecs
    # that transform the layout first (jerasure word/bitmatrix codes)
    # override it to False.
    @property
    def mesh_row_shardable(self) -> bool:
        return True

    # False when the device backend's data layout differs from whole
    # chunks (jerasure word/bitmatrix codes): decode uses the host codec
    _device_decode_supported = True

    # matrix codes are stripe- and block-independent, so the dispatch
    # scheduler (dispatch/) may coalesce signature-equal requests into
    # one padded device call
    dispatch_batchable = True
    # codecs with byte-identical matrix semantics share a family so their
    # requests group across plugins (cuda == isa by construction); None =
    # the concrete class name
    signature_family: "str | None" = None

    # the mesh may shard this codec's decode: true when decode_batch's
    # device path is the plain inverted-survivor-matrix bit-matmul on raw
    # (S, n_src, C) stacks
    @property
    def mesh_decode_shardable(self) -> bool:
        return self.mesh_row_shardable and self._device_decode_supported

    def codec_signature(self):
        """The dispatcher's grouping key: everything the coding matrix is
        derived from.  Two codecs with equal signatures encode and decode
        byte-identically, so their requests may share a call."""
        return (self.signature_family or type(self).__name__,
                self.k, self.m,
                getattr(self, "technique", ""),
                getattr(self, "w", 0),
                getattr(self, "packetsize", 0),
                tuple(self.chunk_mapping))

    def __init__(self):
        super().__init__()
        self.k = 0
        self.m = 0
        self.codec: MatrixRSCodec | None = None
        self._device = None  # lazy DeviceRSBackend
        # the dispatcher runs flushes from whichever submitter thread
        # flushes, so two threads may ask for the backend at once
        self._device_lock = DebugLock("matrix_plugin::device")

    # -- sizing -------------------------------------------------------------
    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_alignment(self) -> int:
        return 32

    def get_chunk_size(self, object_size: int) -> int:
        # isa-style: ceil(object_size / k) rounded up to alignment
        # (reference ErasureCodeIsa.cc:65-78)
        alignment = self.get_alignment()
        chunk_size = (object_size + self.k - 1) // self.k
        modulo = chunk_size % alignment
        if modulo:
            chunk_size += alignment - modulo
        return chunk_size

    # -- backend ------------------------------------------------------------
    def device(self):
        with self._device_lock:
            if self._device is None:
                from ..ops.gf_matmul import DeviceRSBackend
                self._device = DeviceRSBackend(self.codec.matrix,
                                               self.torch_device)
            return self._device

    def _stripe_block(self) -> int:
        """Per-stripe chunk-size granularity (1 = pointwise byte codes;
        jerasure overrides for packet/word layouts whose blocks must not
        span stripe boundaries)."""
        return 1

    def _check_stripe(self, c: int) -> None:
        if c % self._stripe_block():
            # ECUtil's get_chunk_size always gives aligned stripes; S*C
            # flattening would hide a misaligned one, so reject it
            raise ValueError(
                f"stripe chunk size {c} is not a multiple of the code "
                f"block ({self._stripe_block()} bytes)")

    # -- batched stripe API on tensors already on the backend's device ------
    def encode_batch_device(self, data: torch.Tensor) -> torch.Tensor:
        """(S, k, C) uint8 tensor on the backend's device -> (S, m, C)."""
        self._check_stripe(data.shape[2])
        return self.device().encode_device(data)

    def decode_batch_device(self, survivors: torch.Tensor,
                            srcs: Sequence[int],
                            want_rows: Sequence[int]) -> torch.Tensor:
        """*survivors* (S, len(srcs), C) stacked in ``srcs`` order (logical
        chunk ids) -> the data rows ``want_rows``, (S, len(want_rows), C).
        Raises for a codec whose decode runs on the host codec."""
        if not self._device_decode_supported:
            raise NotImplementedError(
                f"{type(self).__name__} decodes on the host codec "
                "(device layout is not whole chunks): use decode_batch")
        return self.device().decode_data_device(survivors, tuple(srcs),
                                                tuple(want_rows))

    # -- batched stripe API (ECUtil striping, osd/ECUtil.cc:120-159) --------
    def _device_encode_batch(self, data: np.ndarray) -> np.ndarray:
        """(S, k, C) numpy -> (S, m, C) numpy on the backend's device.  The
        upload and the fetch are accounted where the JAX package's device
        route accounts them (``gf_matmul.encode``, or
        ``gf_matmul.encode_w`` for the word codes), on the CPU too, as
        the JAX route on its CPU device does."""
        from ..ops.gf_matmul import device_round_trip
        site = "gf_matmul.encode_w" if getattr(self, "is_word_code", False) \
            else "gf_matmul.encode"
        return device_round_trip(site, self.encode_batch_device, data,
                                 self.torch_device)

    def _device_encode(self, data: np.ndarray) -> np.ndarray:
        """(k, C) -> (m, C) on the backend's device."""
        return self._device_encode_batch(data[None])[0]

    def encode_batch(self, data: np.ndarray) -> np.ndarray:
        """(S, k, C) uint8 -> (S, m, C) coding chunks; ONE device call for
        all S stripes.  ``g_kernel_timer`` times it as ``ec_encode_batch``
        on the card and ``ec_encode_batch_host`` for ``backend=host``, the
        JAX package's names for its device and host routes."""
        self._check_stripe(data.shape[2])
        name = "ec_encode_batch" if self.torch_device == "cuda" \
            else "ec_encode_batch_host"
        return g_kernel_timer.timed(name, self._device_encode_batch, data)

    def decode_batch(self, chunks: Dict[int, np.ndarray],
                     want) -> Dict[int, np.ndarray]:
        """Reconstruct chunk ids in *want* for a whole batch.

        chunks maps physical chunk id -> (S, C); all stripes share one
        erasure signature (the recovery shape: one failed shard, many
        stripes).  Missing data rows come from one survivor-matrix call,
        missing coding rows from one re-encode.
        """
        if len(chunks) < self.k:
            raise IOError(
                f"need at least k={self.k} chunks, have {len(chunks)}")
        # callers key by physical chunk id; the codec works in logical rows
        n = self.k + self.m
        p2l = {self.chunk_index(i): i for i in range(n)}
        l2p = {l: p for p, l in p2l.items()}
        chunks = {p2l[p]: b for p, b in chunks.items()}
        want = [p2l[p] for p in want]
        if not self._device_decode_supported:
            return {l2p[i]: b for i, b in self._host_decode_batch(
                chunks, want).items()}
        srcs, want_data, want_coding, missing_data = plan_decode(
            self.k, chunks, want)
        out: Dict[int, np.ndarray] = {i: chunks[i] for i in want
                                      if i in chunks}
        dev = self.device()
        by_id: Dict[int, np.ndarray] = {}
        if missing_data:
            survivors = np.stack([chunks[i] for i in srcs], axis=1)
            # meshed degraded read: the survivor matmul splits across the
            # mesh members (rateless-protected when that is on); None
            # (mesh off, or the codec declined) keeps the single device
            from ..mesh import g_mesh
            rec = g_mesh.decode_stacked(self, survivors, srcs,
                                        missing_data)
            if rec is None:
                rec = dev.decode_data(survivors, srcs, missing_data)
            by_id = {i: rec[:, idx] for idx, i in enumerate(missing_data)}
            for i in want_data:
                out[i] = by_id[i]
        if want_coding:
            data_full = np.stack(
                [chunks[i] if i in chunks else by_id[i]
                 for i in range(self.k)], axis=1)
            coding = dev.encode(data_full)
            for i in want_coding:
                out[i] = coding[:, i - self.k]
        return {l2p[i]: b for i, b in out.items()}

    def _host_decode_batch(self, chunks: Dict[int, np.ndarray],
                           want) -> Dict[int, np.ndarray]:
        """decode_batch on the host codec (logical ids): stripes flatten
        into the byte axis, which is exact because each stripe's C is a
        whole number of code blocks."""
        some = next(iter(chunks.values()))
        s, c = some.shape
        self._check_stripe(c)
        flat = {i: np.ascontiguousarray(b).reshape(s * c)
                for i, b in chunks.items()}
        dec = self.codec.decode(flat, list(want))
        return {i: (chunks[i] if i in chunks
                    else np.ascontiguousarray(dec[i]).reshape(s, c))
                for i in want}

    # -- encode/decode ------------------------------------------------------
    def encode_chunks(self, want_to_encode: Set[int],
                      encoded: Dict[int, np.ndarray]) -> None:
        # buffers are keyed by *physical* index (chunk_index); the codec works
        # in logical rows.  mapping= profiles permute the two.
        data = np.stack([encoded[self.chunk_index(i)] for i in range(self.k)])
        coding = self._device_encode(data)
        for i in range(self.m):
            # fill in place so callers holding references see the parity
            encoded[self.chunk_index(self.k + i)][...] = coding[i]

    def decode_chunks(self, want_to_read: Set[int],
                      chunks: Dict[int, np.ndarray],
                      decoded: Dict[int, np.ndarray]) -> None:
        n = self.k + self.m
        phys_to_logical = {self.chunk_index(i): i for i in range(n)}
        logical_chunks = {phys_to_logical[p]: buf
                          for p, buf in chunks.items()}
        want = sorted(phys_to_logical[p] for p in range(n)
                      if p in want_to_read or p not in chunks)
        out = self.codec.decode(logical_chunks, want)
        for i, buf in out.items():
            decoded[self.chunk_index(i)][...] = buf
