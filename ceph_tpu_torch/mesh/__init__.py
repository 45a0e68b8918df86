"""The mesh's chip-health scoreboard.

Port of ``ceph_tpu/mesh/`` so far: only ``chipstat`` (the scoreboard
the mgr's ``TPU_MESH_SKEW`` check, ``tpu status`` and the OSD tick
read).  The mesh runtime, its staging pool, the rateless coder and the
topology come with the mesh (ROADMAP Queue 1, the mesh).
"""
from .chipstat import (ChipStat, chip_latency_axes, g_chipstat,
                       mesh_chip_perf_counters)

__all__ = ["ChipStat", "chip_latency_axes", "g_chipstat",
           "mesh_chip_perf_counters"]
