"""ErasureCode base class: padding, chunk mapping, default minimum_to_decode.

Port of ``ceph_tpu/ec/base.py``; the semantics follow the reference base
class (src/erasure-code/ErasureCode.cc):

- ``encode_prepare`` splits an object into k chunks of
  ``get_chunk_size(len)`` bytes, zero-padding the tail chunks
  (ErasureCode.cc:138-173, SIMD_ALIGN=32 at :29).
- ``encode`` = prepare -> encode_chunks -> prune unwanted
  (ErasureCode.cc:175-191).
- ``_decode`` passes through when everything wanted is available, otherwise
  allocates missing buffers and calls decode_chunks (ErasureCode.cc:199-232).
- default ``_minimum_to_decode`` = wanted set if fully available, else the
  first k available chunks in ascending order (ErasureCode.cc:90-124).
- ``chunk_index`` applies the optional ``mapping=`` profile permutation
  (ErasureCode.cc:258-277).

The execution backend is the profile key ``backend=cuda|host`` (default
``cuda``): ``cuda`` runs the device path on the CUDA card and raises at
init when there is none; ``host`` is the caller's explicit request for
the CPU.  ``create_rule`` comes with the CRUSH slice of the port.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Set, Tuple

import numpy as np
import torch

from .interface import ErasureCodeInterface, ErasureCodeProfile

SIMD_ALIGN = 32

DEFAULT_RULE_ROOT = "default"
DEFAULT_RULE_FAILURE_DOMAIN = "host"

BACKENDS = ("cuda", "host")


def as_chunk(buf) -> np.ndarray:
    if isinstance(buf, np.ndarray):
        if buf.dtype != np.uint8:
            raise TypeError(f"chunk dtype {buf.dtype} is not uint8")
        return buf
    return np.frombuffer(bytes(buf), dtype=np.uint8)


class ErasureCode(ErasureCodeInterface):
    def __init__(self):
        self._profile: ErasureCodeProfile = {}
        self.chunk_mapping: List[int] = []
        self.rule_root = DEFAULT_RULE_ROOT
        self.rule_failure_domain = DEFAULT_RULE_FAILURE_DOMAIN
        self.rule_device_class = ""
        self.backend_name = "cuda"

    # ---- profile handling -------------------------------------------------
    def init(self, profile: ErasureCodeProfile) -> None:
        self.rule_root = profile.get("crush-root", DEFAULT_RULE_ROOT)
        self.rule_failure_domain = profile.get(
            "crush-failure-domain", DEFAULT_RULE_FAILURE_DOMAIN)
        self.rule_device_class = profile.get("crush-device-class", "")
        self._profile = dict(profile)

    # ---- execution backend selection (cuda | host) -------------------------
    def _init_backend(self, profile: ErasureCodeProfile) -> None:
        name = profile.get("backend", "cuda")
        if name not in BACKENDS:
            raise ValueError(f"backend={name} not in {'|'.join(BACKENDS)}")
        if name == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("backend=cuda but torch.cuda is not "
                                   "available (use backend=host for the "
                                   "CPU)")
        self.backend_name = name

    @property
    def torch_device(self) -> str:
        """The torch device of the chosen backend."""
        return "cuda" if self.backend_name == "cuda" else "cpu"

    def get_profile(self) -> ErasureCodeProfile:
        return self._profile

    @staticmethod
    def to_int(name: str, profile: ErasureCodeProfile, default: int) -> int:
        v = profile.get(name, None)
        if v is None or v == "":
            return int(default)
        try:
            return int(v)
        except ValueError as e:
            raise ValueError(f"{name}={v} is not a valid number") from e

    @staticmethod
    def to_bool(name: str, profile: ErasureCodeProfile,
                default: bool) -> bool:
        v = profile.get(name, None)
        if v is None or v == "":
            return default
        return str(v).lower() in ("true", "1", "yes", "on")

    def parse_mapping(self, profile: ErasureCodeProfile) -> None:
        m = profile.get("mapping")
        if m:
            # mapping string like "DD_D...": logical data chunks land on the
            # 'D' positions, logical coding chunks on the remaining positions
            # in order (reference ErasureCode.cc to_mapping)
            data_pos = [i for i, c in enumerate(m) if c == "D"]
            other_pos = [i for i, c in enumerate(m) if c != "D"]
            self.chunk_mapping = data_pos + other_pos

    def chunk_index(self, i: int) -> int:
        return self.chunk_mapping[i] if len(self.chunk_mapping) > i else i

    def get_chunk_mapping(self) -> Sequence[int]:
        return self.chunk_mapping

    def create_rule(self, name: str, crush) -> int:
        raise NotImplementedError("create_rule comes with the CRUSH port")

    @staticmethod
    def sanity_check_k(k: int) -> None:
        if k < 2:
            raise ValueError(f"k={k} must be >= 2")

    # ---- minimum_to_decode ------------------------------------------------
    def _minimum_to_decode(
        self, want_to_read: Set[int], available_chunks: Set[int]
    ) -> Set[int]:
        if want_to_read <= available_chunks:
            return set(want_to_read)
        k = self.get_data_chunk_count()
        if len(available_chunks) < k:
            raise IOError("not enough chunks to decode")
        return set(sorted(available_chunks)[:k])

    def minimum_to_decode(
        self, want_to_read: Set[int], available: Set[int]
    ) -> Dict[int, List[Tuple[int, int]]]:
        ids = self._minimum_to_decode(want_to_read, available)
        sub = [(0, self.get_sub_chunk_count())]
        return {i: list(sub) for i in sorted(ids)}

    def minimum_to_decode_with_cost(
        self, want_to_read: Set[int], available: Dict[int, int]
    ) -> Set[int]:
        return self._minimum_to_decode(want_to_read, set(available))

    # ---- encode -----------------------------------------------------------
    def encode_prepare(self, raw: np.ndarray) -> Dict[int, np.ndarray]:
        k = self.get_data_chunk_count()
        m = self.get_coding_chunk_count()
        blocksize = self.get_chunk_size(len(raw))
        if blocksize == 0:  # empty object: k+m empty chunks
            return {self.chunk_index(i): np.zeros(0, dtype=np.uint8)
                    for i in range(k + m)}
        padded_chunks = k - len(raw) // blocksize
        encoded: Dict[int, np.ndarray] = {}
        for i in range(k - padded_chunks):
            encoded[self.chunk_index(i)] = np.array(
                raw[i * blocksize:(i + 1) * blocksize])
        if padded_chunks:
            remainder = len(raw) - (k - padded_chunks) * blocksize
            buf = np.zeros(blocksize, dtype=np.uint8)
            buf[:remainder] = raw[(k - padded_chunks) * blocksize:]
            encoded[self.chunk_index(k - padded_chunks)] = buf
            for i in range(k - padded_chunks + 1, k):
                encoded[self.chunk_index(i)] = np.zeros(blocksize,
                                                        dtype=np.uint8)
        for i in range(k, k + m):
            encoded[self.chunk_index(i)] = np.zeros(blocksize, dtype=np.uint8)
        return encoded

    def encode(self, want_to_encode: Set[int], data) -> Dict[int, np.ndarray]:
        raw = as_chunk(data)
        encoded = self.encode_prepare(raw)
        self.encode_chunks(want_to_encode, encoded)
        for i in range(self.get_chunk_count()):
            if i not in want_to_encode:
                encoded.pop(i, None)
        return encoded

    # ---- decode -----------------------------------------------------------
    def _decode(
        self, want_to_read: Set[int], chunks: Dict[int, np.ndarray]
    ) -> Dict[int, np.ndarray]:
        have = set(chunks)
        if want_to_read <= have:
            return {i: chunks[i] for i in want_to_read}
        k = self.get_data_chunk_count()
        m = self.get_coding_chunk_count()
        if not chunks:
            raise IOError("no chunks to decode from")
        blocksize = len(next(iter(chunks.values())))
        decoded: Dict[int, np.ndarray] = {}
        for i in range(k + m):
            if i in chunks:
                decoded[i] = np.array(chunks[i])
            else:
                decoded[i] = np.zeros(blocksize, dtype=np.uint8)
        self.decode_chunks(want_to_read, chunks, decoded)
        return decoded

    def decode(
        self, want_to_read: Set[int], chunks: Dict[int, np.ndarray],
        chunk_size: int = 0
    ) -> Dict[int, np.ndarray]:
        return self._decode(want_to_read,
                            {i: as_chunk(c) for i, c in chunks.items()})

    def decode_concat(self, chunks: Dict[int, np.ndarray]) -> bytes:
        k = self.get_data_chunk_count()
        want = {self.chunk_index(i) for i in range(k)}
        decoded = self.decode(want, chunks)
        return b"".join(
            decoded[self.chunk_index(i)].tobytes() for i in range(k))

    # subclasses must implement:
    #   get_chunk_count / get_data_chunk_count / get_chunk_size
    #   encode_chunks / decode_chunks
    def encode_chunks(self, want_to_encode, encoded):
        raise NotImplementedError

    def decode_chunks(self, want_to_read, chunks, decoded):
        raise NotImplementedError
