"""MonClient — the client's mon stub for cross-process clusters.

RadosClient drives its monitor through two calls (subscribe +
send_full_map).  In-process clusters hand it the Monitor object; across
process boundaries this stub speaks MMonSubscribe over the wire instead
(src/mon/MonClient.h role: the client-side session with the mon).

The port's own copy of ``ceph_tpu/client/mon_client.py``.
"""
from __future__ import annotations

from ..msg.messages import MMonSubscribe


class MonClient:
    def __init__(self, network, mon_name: str = "mon",
                 mon_names=None):
        self.network = network
        self.mon_name = mon_name
        # the full roster for hunting (MonClient::_reopen_session /
        # hunt): when the bound mon goes silent, rotate to the next
        self.mon_names = list(mon_names or [mon_name])

    def hunt(self) -> str:
        """Rotate to the next monitor in the roster (the reference's
        hunting when the current mon connection goes dead)."""
        if len(self.mon_names) > 1:
            i = self.mon_names.index(self.mon_name) \
                if self.mon_name in self.mon_names else -1
            self.mon_name = self.mon_names[(i + 1)
                                           % len(self.mon_names)]
        return self.mon_name

    def subscribe(self, name: str) -> None:
        """Subscribe and fetch are ONE wire operation here: the mon
        answers every MMonSubscribe with the full history."""
        self.network.send(name, self.mon_name, MMonSubscribe())

    # RadosClient calls both on its monitor handle; over the wire they
    # are the same request
    send_full_map = subscribe
