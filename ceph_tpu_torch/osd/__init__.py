"""OSD side of the port: stripe bookkeeping (``ecutil``), the PG log,
``ECBackend``, the PG, the OSD daemon and its helpers (object classes,
cache tiering, hit sets, the snap mapper).

Port of ``ceph_tpu/osd/``, exporting the same names."""
from .ecutil import HashInfo, stripe_info_t, encode as ecutil_encode, \
    decode as ecutil_decode, decode_concat as ecutil_decode_concat

__all__ = ["HashInfo", "stripe_info_t", "ecutil_encode", "ecutil_decode",
           "ecutil_decode_concat"]
