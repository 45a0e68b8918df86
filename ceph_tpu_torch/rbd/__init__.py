"""librbd-lite: rados block images (src/librbd + src/cls/rbd).

Importing the package registers the ``rbd`` object class so any OSD in
the process can execute header methods, mirroring how the reference
loads libcls_rbd.so into every OSD.

Port of ``ceph_tpu/rbd``: host code, a copy of the JAX package's.  An
image whose data pool is erasure-coded (``data_pool``) writes and reads
its data objects through ``ECBackend``, which encodes and decodes on
the card (K1).
"""
from . import cls_rbd  # noqa: F401  (registers the cls methods)
from .image import Image, RBD, RBDError, apply_image_event
from .mirror import ImageMirror, PoolMirror

__all__ = ["Image", "ImageMirror", "PoolMirror", "RBD", "RBDError",
           "apply_image_event"]
