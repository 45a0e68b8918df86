"""cephfs-lite: POSIX-shaped filesystem over rados (src/mds +
src/client at lite scale).

Importing registers the ``fs`` object class; see ``cls_fs`` for the
storage layout (reference-identical dir/file object naming) and the
design note on collapsing the MDS serialization point into PG-atomic
class methods.
"""
from . import cls_fs  # noqa: F401  (registers the cls methods)
from .client import CephFS, FsError
from .cls_fs import FS_SNAPS_OID, ROOT_INO, dir_oid, file_oid

__all__ = ["CephFS", "FsError", "ROOT_INO", "dir_oid", "file_oid"]
