"""Topology discovery: ONE 1-D batch-axis mesh over the process's members.

Port of ``ceph_tpu/mesh/topology.py``.  A mesh is an ordered list of
members; each member is one ``torch.device`` with a CUDA stream of its
own (none on the CPU).  One process drives every member, as JAX's
single-controller mesh does: nothing here uses ``torch.distributed``.

Discovery returns each distinct device of the chosen platform
(``"cuda"`` or ``"cpu"``; by default the card when torch sees one, else
the CPU) and never puts a member on another platform.  The stand-in for
JAX's ``--xla_force_host_platform_device_count`` is a count of members
per device: ``CEPH_TPU_TORCH_MESH_MEMBERS`` read once at first use, or
``set_members_per_device`` (the tests call it with 8).  It applies to
the CPU and the card alike and is never inferred; the default is one.
Members that share a device give byte-identical results and real
per-member launches, but no scaling: ``parallel.mesh_roofline`` scales
by distinct devices, not members.

Requests beyond what the process can see CLAMP (``batch_mesh``), as in
the JAX package: capacity is an operator knob (``ec_mesh_chips``).
"""
from __future__ import annotations

import contextlib
import os
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common.lockdep import DebugLock

BATCH_AXIS = "batch"
MEMBERS_ENV = "CEPH_TPU_TORCH_MESH_MEMBERS"

_lock = DebugLock("mesh_topology::members")
_members_per_device: Optional[int] = None
# (platform, members per device) -> members, so a rebuilt mesh keeps its
# members' streams
_member_cache: Dict[Tuple[str, int], List["Member"]] = {}


def members_per_device() -> int:
    """Members each device carries: ``set_members_per_device``'s value,
    else ``CEPH_TPU_TORCH_MESH_MEMBERS`` (read once), else 1."""
    global _members_per_device
    with _lock:
        if _members_per_device is None:
            raw = os.environ.get(MEMBERS_ENV, "1")
            n = int(raw)
            if n < 1:
                raise ValueError(f"{MEMBERS_ENV}={raw!r}: need >= 1")
            _members_per_device = n
        return _members_per_device


def set_members_per_device(n: int) -> None:
    """Set the members each device carries (>= 1).  A mesh built before
    keeps its members; the runtime rebuilds on its next flush."""
    global _members_per_device
    if int(n) < 1:
        raise ValueError(f"members per device must be >= 1, got {n}")
    with _lock:
        _members_per_device = int(n)


def default_platform() -> str:
    """The default backend's platform: the card when torch sees one,
    else the CPU (JAX's ``jax.devices()`` default backend)."""
    return "cuda" if torch.cuda.is_available() else "cpu"


class Member:
    """One mesh member: a device and the stream its launches run on."""

    __slots__ = ("index", "device", "stream", "slot")

    def __init__(self, index: int, device: torch.device, slot: int):
        self.index = index
        self.device = device
        self.slot = slot            # the member's index on its device
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)

    @property
    def platform(self) -> str:
        return self.device.type

    def __repr__(self) -> str:
        return f"{self.device}/member{self.slot}"

    __str__ = __repr__

    @contextlib.contextmanager
    def launching(self, *inputs: torch.Tensor):
        """Run the body on this member's stream.  The stream first waits
        for the work already queued on the device's current stream, and
        each CUDA input is recorded as used by it, so the allocator keeps
        the input alive until the member's work is done."""
        if self.stream is None:
            yield
            return
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        for t in inputs:
            if t.device.type == "cuda":
                t.record_stream(self.stream)
        with torch.cuda.stream(self.stream):
            yield

    def record(self):
        """A CUDA event recorded on this member's stream after the work
        queued so far (None on the CPU, where every call is complete when
        it returns)."""
        if self.stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record(self.stream)
        return ev


class Mesh:
    """Members laid out on named axes (row-major over ``shape``)."""

    def __init__(self, members: Sequence[Member], shape: Tuple[int, ...],
                 axis_names: Tuple[str, ...]):
        if int(np.prod(shape)) != len(members):
            raise ValueError(f"{len(members)} members do not fill {shape}")
        self.members: List[Member] = list(members)
        self.axis_names = tuple(axis_names)
        self.shape = OrderedDict(zip(self.axis_names, shape))
        arr = np.empty(len(members), dtype=object)
        arr[:] = self.members
        self.devices = arr.reshape(shape)

    @property
    def size(self) -> int:
        return len(self.members)

    @property
    def platform(self) -> str:
        return self.members[0].platform

    @property
    def distinct_devices(self) -> List[torch.device]:
        seen: List[torch.device] = []
        for m in self.members:
            if m.device not in seen:
                seen.append(m.device)
        return seen

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, {self.platform}, "
                f"{len(self.distinct_devices)} device(s))")


def addressable_devices(n: Optional[int] = None,
                        platform: Optional[str] = None) -> List[Member]:
    """Every member the process may put in a mesh on *platform*: each
    distinct device of it, ``members_per_device()`` times, in device
    order.  Asking for ``"cuda"`` with no card raises.  *n* is a clamp
    bound for the caller, not a growth target."""
    del n
    platform = platform or default_platform()
    if platform == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a mesh on cuda needs a CUDA device; "
                               "torch.cuda is not available")
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    elif platform == "cpu":
        devs = [torch.device("cpu")]
    else:
        raise ValueError(f"platform {platform!r} is neither cuda nor cpu")
    per = members_per_device()
    with _lock:
        members = _member_cache.get((platform, per))
        if members is None:
            members = [Member(i * per + s, d, s)
                       for i, d in enumerate(devs) for s in range(per)]
            _member_cache[(platform, per)] = members
    return list(members)


def batch_mesh(n: Optional[int] = None,
               platform: Optional[str] = None) -> Mesh:
    """A 1-D ``("batch",)`` mesh over *n* members (``None``/-1 = all
    addressable).  Requests beyond what the process can see CLAMP to the
    available member count rather than raising."""
    want = None if n is None or n < 0 else max(int(n), 1)
    members = addressable_devices(want, platform)
    if want is not None:
        members = members[:want]
    return Mesh(members, (len(members),), (BATCH_AXIS,))


class Shard:
    """One member's piece of a sharded array: ``data`` holds the global
    array's ``index`` (a tuple of slices); ``event`` is recorded on the
    member's stream after the piece's launch (None on the CPU)."""

    __slots__ = ("member", "data", "index", "event")

    def __init__(self, member: Member, data: torch.Tensor, index,
                 event=None):
        self.member = member
        self.data = data
        self.index = tuple(index)
        self.event = event

    def is_ready(self) -> bool:
        """Non-blocking: has the member's launch of this piece finished?
        (JAX's ``Array.is_ready`` on the shard.)"""
        return self.event is None or bool(self.event.query())

    def fetch(self, n: int = None) -> np.ndarray:
        """The piece (or its first *n* elements) on the host, copied on
        the member's stream, so the copy waits for the member's launch."""
        with self.member.launching():
            t = self.data if n is None else self.data.reshape(-1)[:n]
            return t.cpu().numpy()


class Sharded:
    """A global array of ``shape`` held as per-member ``Shard`` pieces;
    pieces with equal indices are replicas.  ``spec`` names the mesh axis
    each array axis is split over (None = not split), as a JAX
    ``PartitionSpec`` does."""

    def __init__(self, shape, shards: Sequence[Shard], spec=()):
        self.shape = tuple(int(d) for d in shape)
        self.addressable_shards: List[Shard] = list(shards)
        self.spec = tuple(spec)

    def numpy(self) -> np.ndarray:
        """The whole array on the host: every distinct piece fetched on
        its member's stream (each fetch is that member's fence)."""
        first = self.addressable_shards[0].data
        out = np.empty(self.shape,
                       dtype=torch.empty(0, dtype=first.dtype).numpy().dtype)
        seen = set()
        for sh in self.addressable_shards:
            key = tuple((s.start, s.stop) for s in sh.index)
            if key in seen:
                continue
            seen.add(key)
            out[sh.index] = sh.fetch()
        return out
