"""Mesh construction helpers.

Port of ``ceph_tpu/parallel/mesh.py``.  A 2-D ``(stripe, shard)`` mesh
over the process's members (``mesh/topology.py``).  The shard axis is
kept small (it shards the coding rows of the GF matmul, or the k
survivors of the survivor-sharded decode), the stripe axis takes the
rest: stripes are the abundant dimension in a storage workload, as PGs
are for placement.

Where JAX's ``make_mesh`` takes the virtual host CPUs when the default
backend has too few devices, the port raises: a mesh never moves to
another platform.  More members come from ``CEPH_TPU_TORCH_MESH_MEMBERS``
or ``mesh.topology.set_members_per_device``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

from ..mesh.topology import MEMBERS_ENV, Mesh, addressable_devices

STRIPE_AXIS = "stripe"
SHARD_AXIS = "shard"


def mesh_shape_for(n: int, max_shard: int = 2) -> Tuple[int, int]:
    """Factor n devices into (stripe, shard) with shard | n and small."""
    shard = 1
    for cand in range(min(max_shard, n), 0, -1):
        if n % cand == 0:
            shard = cand
            break
    return n // shard, shard


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None,
              max_shard: int = 2, platform: Optional[str] = None) -> Mesh:
    """A (stripe, shard) mesh over *n_devices* members (all when None) of
    *platform* (the default backend when None), or over *devices*."""
    if devices is None:
        devices = addressable_devices(platform=platform)
    devices = list(devices)
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"need {n_devices} devices, have {len(devices)}; for more "
                f"members per device set {MEMBERS_ENV}={n_devices} at "
                "process start or call mesh.topology."
                "set_members_per_device")
        devices = devices[:n_devices]
    dp, tp = mesh_shape_for(len(devices), max_shard)
    return Mesh(devices, (dp, tp), (STRIPE_AXIS, SHARD_AXIS))
