"""journal-lite: ordered append/replay log over rados (src/journal +
src/cls/journal at lite scale — the engine under rbd mirroring).

Port of ``ceph_tpu/journal``: host code, a copy of the JAX package's.
"""
from . import cls_journal  # noqa: F401  (registers the cls methods)
from .journaler import Journaler, JournalError

__all__ = ["Journaler", "JournalError"]
