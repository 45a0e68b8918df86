"""Messages of the port: the ``M*`` types, their wire codec and the
in-process messenger fabric.  The TCP transport is ``msg.tcp``, which the
package does not import here, as the JAX package's ``msg`` does not."""
from .messages import (
    MOSDECSubOpRead, MOSDECSubOpReadReply, MOSDECSubOpWrite,
    MOSDECSubOpWriteReply, MOSDMap, MOSDOp, MOSDOpReply, MOSDPGInfo,
    MOSDPGNotify, MOSDPGQuery, MOSDPGRemove, MOSDPGScan,
    MOSDPGScanReply, MOSDPing, MOSDRepScrub,
    MOSDRepScrubMap, Message,
    MOSDFailure, CEPH_OSD_OP_READ, CEPH_OSD_OP_WRITE, CEPH_OSD_OP_WRITEFULL,
    CEPH_OSD_OP_APPEND, CEPH_OSD_OP_DELETE, CEPH_OSD_OP_STAT,
)
from .messenger import Connection, Dispatcher, Messenger, Network

__all__ = [
    "MOSDECSubOpRead", "MOSDECSubOpReadReply", "MOSDECSubOpWrite",
    "MOSDECSubOpWriteReply", "MOSDMap", "MOSDOp", "MOSDOpReply",
    "MOSDPGInfo", "MOSDPGNotify", "MOSDPGQuery", "MOSDPGRemove",
    "MOSDPGScan", "MOSDPGScanReply",
    "MOSDPing", "MOSDRepScrub", "MOSDRepScrubMap",
    "Message", "MOSDFailure", "Connection", "Dispatcher",
    "Messenger", "Network", "CEPH_OSD_OP_READ", "CEPH_OSD_OP_WRITE",
    "CEPH_OSD_OP_WRITEFULL", "CEPH_OSD_OP_APPEND", "CEPH_OSD_OP_DELETE",
    "CEPH_OSD_OP_STAT",
]
