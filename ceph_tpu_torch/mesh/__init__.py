"""Mesh execution runtime: one dispatch scheduler feeding N mesh members.

Port of ``ceph_tpu/mesh/``.  See runtime.py for the runtime's design.

The design on one card.  JAX's mesh is single-controller: one process
sees every chip and ``jax.sharding`` places the shards.  The port keeps
that model: a mesh is an ordered list of members, each a
``torch.device`` with a CUDA stream of its own, all driven by one
process (topology.py).  It does not use ``torch.distributed``: NCCL
will not put two ranks of one communicator on the same GPU, so on a
one-card machine it cannot form a group larger than 1; NCCL has no XOR
reduction (``ReduceOp.BXOR`` is gloo and MPI only); and a multi-process
gloo group on the CPU would cost the tests processes for nothing.

- Members.  Discovery (``addressable_devices``, ``batch_mesh(-1)``)
  returns each distinct device of the chosen platform and clamps, as
  JAX does, and never puts a member on another platform; asking for
  ``cuda`` with no card raises.  The stand-in for JAX's
  ``--xla_force_host_platform_device_count`` is a count of members per
  device, set once through ``CEPH_TPU_TORCH_MESH_MEMBERS`` or
  ``topology.set_members_per_device`` (never inferred; default 1).  The
  tests use 8 CPU members; ``chip_smoke.py`` uses 8 members on
  ``cuda:0``.  With the default, ``batch_mesh(-1)`` on one card has one
  member and the dispatcher runs the single-device path.
- What members on one card measure: byte-identical results and real
  per-member launches, not scaling.  ``parallel.mesh_roofline`` scales
  the chip's peaks by the distinct devices, so one card reads 1x.
- Readiness.  JAX's ``is_ready()`` on a block output becomes a CUDA
  event the member's stream records after the launch;
  ``parallel.drain_sharded`` fetches one element of each member's piece
  on its stream.  On the CPU every piece is ready when its call returns.
- No guard, no fallback.  The injection sites ``mesh.encode_batch`` and
  ``mesh.decode_batch`` raise to the caller, as does a failed launch;
  the ``fallbacks`` counters stay in the dumps and never move.  Kept:
  ``mesh.chip_fail`` (chosen before the clock) erases its chip's
  rateless blocks, and ``mesh.chip_slowdown`` delays readiness.
- Donation.  torch has no ``donate_argnums``; ``donate`` stays in the
  plan key and the dump as JAX computes it (``ec_mesh_donate`` and a
  platform that is not the CPU), and where it is true the plan writes
  K1's output into pooled device buffers of its own.
"""
from .chipstat import (ChipStat, chip_latency_axes, g_chipstat,
                       mesh_chip_perf_counters)
from .pool import StagingPool
from .rateless import (RatelessCoder, RatelessPlan,
                       rateless_perf_counters)
from .runtime import (DecodeShardingPlan, MeshRuntime, ShardingPlan,
                      chip_occupancy_axes, g_mesh,
                      membership_perf_counters,
                      mesh_decode_perf_counters, mesh_perf_counters)
from .topology import (BATCH_AXIS, MEMBERS_ENV, Member, Mesh, Shard,
                       Sharded, addressable_devices, batch_mesh,
                       members_per_device, set_members_per_device)

__all__ = [
    "BATCH_AXIS", "ChipStat", "DecodeShardingPlan", "MEMBERS_ENV",
    "Member", "Mesh", "MeshRuntime", "RatelessCoder", "RatelessPlan",
    "Shard", "Sharded", "ShardingPlan", "StagingPool",
    "addressable_devices", "batch_mesh", "chip_latency_axes",
    "chip_occupancy_axes", "g_chipstat", "g_mesh",
    "members_per_device", "membership_perf_counters",
    "mesh_chip_perf_counters", "mesh_decode_perf_counters",
    "mesh_perf_counters", "rateless_perf_counters",
    "set_members_per_device",
]
