"""Device-mesh parallelism for the port's data path.

Port of ``ceph_tpu/parallel/``.  Ceph's distribution axes map onto a
2-D mesh of members (``mesh/topology.py``):

- ``stripe``: the data-parallel axis.  Batches of EC stripes (and
  batches of PGs in the placement kernels) split across members, the
  analog of object->PG sharding and ParallelPGMapper's thread fan-out.
- ``shard``: the model-parallel axis.  The coding rows of the GF matmul
  split across members, or, in the survivor-sharded decode, the k
  survivors, whose u8 partial products the K9x kernel XOR-reduces.

One process drives every member, each on its own CUDA stream; nothing
here uses ``torch.distributed``.
"""
from .mesh import make_mesh, mesh_shape_for
from .ec import Sharded, ShardedRS, drain_sharded, mesh_roofline
from .step import pipeline_step, example_pipeline_args
from .crush import ShardedFastRule, sharded_fast_rule

__all__ = [
    "make_mesh", "mesh_shape_for", "Sharded", "ShardedRS",
    "drain_sharded", "mesh_roofline",
    "pipeline_step", "ShardedFastRule", "sharded_fast_rule",
    "example_pipeline_args",
]
