"""Monitor side of the port: the ``Monitor`` (Paxos, elections, the
OSDMap service) and the ``MonMap``.

Port of ``ceph_tpu/mon/``, exporting the same names."""
from .monitor import Monitor

__all__ = ["Monitor"]
