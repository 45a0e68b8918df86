"""rgw-lite: S3-shaped object gateway (src/rgw + src/cls/rgw at lite
scale).

Importing registers the ``rgw`` object class (two-phase bucket-index
methods); ``gateway.RGWLite`` is the RGWRados-role core and
``http.S3Frontend``/``http.serve`` the path-style S3 REST frontend.

Port of ``ceph_tpu/rgw/``, a copy: nothing here chooses a device.  The
data pool's codec does, so on a ``cuda`` EC data pool every chunk and
part written reaches K1 in the OSD, and a missing card raises there.
"""
from . import cls_rgw  # noqa: F401  (registers the cls methods)
from .gateway import RGWError, RGWLite
from .http import S3Frontend, SwiftFrontend, serve

__all__ = ["RGWError", "RGWLite", "S3Frontend", "SwiftFrontend",
           "serve"]
