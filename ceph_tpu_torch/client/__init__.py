"""Client side of the port: ``RadosClient`` (librados), its
``ObjectOperation`` vectors and the striper.

Port of ``ceph_tpu/client/``, exporting the same names."""
from .rados import ObjectOperation, RadosClient
from .striper import RadosStriper

__all__ = ["ObjectOperation", "RadosClient", "RadosStriper"]
