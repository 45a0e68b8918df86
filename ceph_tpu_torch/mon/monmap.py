"""MonMap — the epoched monitor roster as a first-class map
(src/mon/MonMap.h role at lite scale).

Holds epoch, fsid, creation/change stamps, the name -> address
roster with ranks calculated by ADDRESS ORDER (MonMap::calc_ranks
sorts the addr map), and the persistent/optional feature sets
(mon/mon_types.h mon_feature_t).  Serialized as a magic-tagged JSON
blob — our own container format; the reference's wire encoding is a
non-goal, the TOOL surface (monmaptool) is pinned byte-exact against
src/test/cli/monmaptool instead.

The port's own copy of ``ceph_tpu/mon/monmap.py``.
"""
from __future__ import annotations

import json
import time
import uuid as _uuid
from typing import Dict, List, Optional, Tuple

MAGIC = b"CEPHTPU_MONMAP\x01"

# ceph::features::mon (mon/mon_types.h): the vintage's named persistent
# feature bits
FEATURE_NAMES = {1: "kraken", 2: "luminous", 4: "mimic"}
FEATURE_VALUES = {v: k for k, v in FEATURE_NAMES.items()}
SUPPORTED = 1 | 2 | 4
PERSISTENT = 1 | 2 | 4


def _stamp(t: float) -> str:
    lt = time.localtime(t)
    frac = int((t % 1) * 1_000_000)
    return time.strftime("%Y-%m-%d %H:%M:%S", lt) + f".{frac:06d}"


class MonMap:
    def __init__(self, fsid: Optional[str] = None):
        self.epoch = 0
        self.fsid = fsid or str(_uuid.uuid4())
        # cosmetic map-birth stamp in dumps; never compared
        # against fabric time
        self.created = time.time()  # lint: allow[no-wall-clock]
        self.last_changed = self.created
        self.mons: Dict[str, str] = {}       # name -> "ip:port/nonce"
        self.persistent_features = 0
        self.optional_features = 0

    # ---- roster ------------------------------------------------------------
    @staticmethod
    def _addr_key(addr: str) -> Tuple:
        hostport = addr.split("/", 1)[0]
        host, sep, port = hostport.rpartition(":")
        if not sep:                  # port-less address
            host, port = hostport, "0"
        try:
            ip = (0, tuple(int(x) for x in host.split(".")))
        except ValueError:
            ip = (1, (host,))        # hostnames sort after numerics
        return (ip, int(port) if port.isdigit() else 0)

    def add(self, name: str, addr: str) -> None:
        if name in self.mons:
            raise KeyError(name)
        if "/" not in addr:
            addr += "/0"
        self.mons[name] = addr

    def remove(self, name: str) -> None:
        del self.mons[name]

    def contains(self, name: str) -> bool:
        return name in self.mons

    def ranks(self) -> List[Tuple[str, str]]:
        """[(name, addr)] in rank order — by address, like
        MonMap::calc_ranks."""
        return sorted(self.mons.items(),
                      key=lambda kv: self._addr_key(kv[1]))

    # ---- io ----------------------------------------------------------------
    def to_bytes(self) -> bytes:
        return MAGIC + json.dumps({
            "epoch": self.epoch, "fsid": self.fsid,
            "created": self.created,
            "last_changed": self.last_changed, "mons": self.mons,
            "persistent_features": self.persistent_features,
            "optional_features": self.optional_features,
        }, sort_keys=True).encode()

    @classmethod
    def from_bytes(cls, raw: bytes) -> "MonMap":
        if not raw.startswith(MAGIC):
            raise ValueError("not a monmap")
        d = json.loads(raw[len(MAGIC):])
        m = cls(fsid=d["fsid"])
        m.epoch = d["epoch"]
        m.created = d["created"]
        m.last_changed = d["last_changed"]
        m.mons = dict(d["mons"])
        m.persistent_features = d.get("persistent_features", 0)
        m.optional_features = d.get("optional_features", 0)
        return m

    # ---- print (MonMap::print, pinned by monmaptool cram) ------------------
    def print_lines(self) -> List[str]:
        out = [f"epoch {self.epoch}",
               f"fsid {self.fsid}",
               f"last_changed {_stamp(self.last_changed)}",
               f"created {_stamp(self.created)}"]
        for rank, (name, addr) in enumerate(self.ranks()):
            out.append(f"{rank}: {addr} mon.{name}")
        return out
