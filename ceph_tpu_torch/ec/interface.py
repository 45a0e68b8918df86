"""ErasureCodeInterface — the plugin ABI.

Semantic contract mirrors the reference's abstract interface
(src/erasure-code/ErasureCodeInterface.h:170): systematic codes over
k data + m coding chunks, optional sub-chunks (array codes), chunk
remapping, and minimum_to_decode returning per-shard (offset, count)
sub-chunk lists.

Buffers are numpy uint8 arrays (or bytes) instead of bufferlists; profiles
are plain ``dict[str, str]``.
"""
from __future__ import annotations

import abc
from typing import Dict, List, Sequence, Set, Tuple

ErasureCodeProfile = Dict[str, str]


class ErasureCodeInterface(abc.ABC):
    """Abstract erasure-code codec.

    Chunk/stripe model (reference ErasureCodeInterface.h:39-78): an object is
    split into k equally-sized data chunks; encode() produces m additional
    coding chunks; any k of the k+m chunks suffice to reconstruct.  All codes
    are systematic.
    """

    @abc.abstractmethod
    def init(self, profile: ErasureCodeProfile) -> None:
        """Initialize from profile; raises ValueError on bad parameters."""

    @abc.abstractmethod
    def get_profile(self) -> ErasureCodeProfile: ...

    @abc.abstractmethod
    def create_rule(self, name: str, crush) -> int:
        """Create a crush rule for this code in *crush* and return rule id."""

    @abc.abstractmethod
    def get_chunk_count(self) -> int:
        """k + m."""

    @abc.abstractmethod
    def get_data_chunk_count(self) -> int:
        """k."""

    def get_coding_chunk_count(self) -> int:
        return self.get_chunk_count() - self.get_data_chunk_count()

    def get_sub_chunk_count(self) -> int:
        """Number of sub-chunks per chunk (array codes; 1 for MDS RS)."""
        return 1

    @abc.abstractmethod
    def get_chunk_size(self, object_size: int) -> int:
        """Chunk size for an object of *object_size* bytes (incl. padding)."""

    @abc.abstractmethod
    def minimum_to_decode(
        self, want_to_read: Set[int], available: Set[int]
    ) -> Dict[int, List[Tuple[int, int]]]:
        """Chunks (and per-chunk (sub-chunk offset, count) lists) to retrieve
        in order to reconstruct *want_to_read* from *available*.
        Raises IOError if reconstruction is impossible."""

    @abc.abstractmethod
    def minimum_to_decode_with_cost(
        self, want_to_read: Set[int], available: Dict[int, int]
    ) -> Set[int]:
        """Like minimum_to_decode but with per-chunk retrieval costs."""

    @abc.abstractmethod
    def encode(self, want_to_encode: Set[int], data) -> Dict[int, "np.ndarray"]:
        """Split+pad *data*, compute coding chunks, return the requested ones."""

    @abc.abstractmethod
    def encode_chunks(self, want_to_encode: Set[int], encoded) -> None: ...

    @abc.abstractmethod
    def decode(
        self, want_to_read: Set[int], chunks: Dict[int, "np.ndarray"], chunk_size: int = 0
    ) -> Dict[int, "np.ndarray"]: ...

    @abc.abstractmethod
    def decode_chunks(self, want_to_read, chunks, decoded) -> None: ...

    @abc.abstractmethod
    def get_chunk_mapping(self) -> Sequence[int]:
        """Permutation of logical->physical chunk indices (empty = identity)."""

    @abc.abstractmethod
    def decode_concat(self, chunks: Dict[int, "np.ndarray"]) -> bytes:
        """Reconstruct and concatenate the data chunks (trailing pad kept)."""
