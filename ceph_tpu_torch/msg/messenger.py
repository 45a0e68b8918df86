"""In-process messenger fabric for the vstart-lite cluster.

The reference runs seven epoll-driven AsyncMessengers per OSD
(src/msg/async/, src/ceph_osd.cc:476-501); for a single-process TPU-side
cluster the equivalent is a deterministic dispatch fabric: entities
register Dispatchers by name, sends enqueue onto one FIFO, and pump()
drains it to quiescence.  Determinism is what the test tiers need (SURVEY
§4); fault injection (down entities, blackholed links, drop hooks) hangs
off the fabric exactly where the Thrasher kills sockets in the reference
(qa/tasks/ceph_manager.py:195,360).

The port's own copy of ``ceph_tpu/msg/messenger.py``.  Its ``msg.drop``
site is the port's fault registry (``ceph_tpu_torch/fault``).
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Dict, List, Optional, Set, Tuple

from .messages import Message


_g_faults = None


def _faults():
    # deferred: the fault registry is dependency-light, but importing it
    # at module load would couple msg/ to common/ for every consumer of
    # the wire types; the first check pays the import once
    global _g_faults
    if _g_faults is None:
        from ..fault import g_faults
        _g_faults = g_faults
    return _g_faults


class Dispatcher:
    """Receiver interface (msg/Dispatcher.h)."""

    def ms_fast_dispatch(self, msg: Message) -> None:
        raise NotImplementedError

    def ms_handle_reset(self, peer: str) -> None:
        pass


class Connection:
    """Send handle pinned to a destination (msg/Connection.h)."""

    def __init__(self, network: "Network", src: str, dst: str):
        self.network = network
        self.src = src
        self.dst = dst

    def send_message(self, msg: Message) -> None:
        self.network.send(self.src, self.dst, msg)


class Messenger:
    """Per-entity endpoint (Messenger::create analog)."""

    def __init__(self, network: "Network", name: str):
        self.network = network
        self.name = name
        self.dispatcher: Optional[Dispatcher] = None

    def add_dispatcher_head(self, d: Dispatcher) -> None:
        self.dispatcher = d

    def get_connection(self, dst: str) -> Connection:
        return Connection(self.network, self.name, dst)

    def send_message(self, msg: Message, dst: str) -> None:
        self.network.send(self.name, dst, msg)


class Network:
    """The single-process cluster fabric with fault injection."""

    def __init__(self):
        self.endpoints: Dict[str, Messenger] = {}
        self.queue: deque = deque()
        self.down: Set[str] = set()
        self.blackholed: Set[Tuple[str, str]] = set()
        self.drop_hook: Optional[Callable[[str, str, Message], bool]] = None
        self.delivered = 0
        self.dropped = 0
        self.pumping = False
        # idle kickers: called when the queue drains; a hook returning
        # True did deferred work (flushed a dispatch batch, resent a
        # lost sub-write) and pump loops to deliver what it enqueued.
        # This is how "drain to quiescence" stays true once the EC
        # write path is continuation-driven: an encode parked in the
        # dispatch scheduler's collection window is not quiescent.
        self.idle_hooks: List[Callable[[], bool]] = []

    def create_messenger(self, name: str) -> Messenger:
        m = Messenger(self, name)
        self.endpoints[name] = m
        return m

    # ---- fault injection (Thrasher hooks) ---------------------------------
    def set_down(self, name: str, down: bool = True) -> None:
        if down:
            self.down.add(name)
        else:
            self.down.discard(name)

    def blackhole(self, src: str, dst: str, on: bool = True) -> None:
        if on:
            self.blackholed.add((src, dst))
        else:
            self.blackholed.discard((src, dst))

    # ---- delivery ---------------------------------------------------------
    def send(self, src: str, dst: str, msg: Message) -> None:
        msg.src = src
        self.queue.append((src, dst, msg))

    def add_idle_hook(self, hook: Callable[[], bool]) -> None:
        self.idle_hooks.append(hook)

    def pump(self, max_msgs: int = 100000) -> int:
        """Deliver queued messages until quiescent — including deferred
        work the idle hooks surface (pipelined dispatch flushes,
        sub-write resends); returns the delivery count."""
        if self.pumping:
            return 0  # re-entrant sends drain in the outer pump
        self.pumping = True
        n = 0
        try:
            while n < max_msgs:
                if not self.queue:
                    # quiescent: give the idle kickers one round; any
                    # that did work may have enqueued messages (hook
                    # bounds — resend caps, finite dispatch queues —
                    # guarantee this terminates)
                    if not any([h() for h in self.idle_hooks]):
                        break
                    continue
                src, dst, msg = self.queue.popleft()
                n += 1
                if (src in self.down or dst in self.down
                        or (src, dst) in self.blackholed):
                    self.dropped += 1
                    continue
                if self.drop_hook and self.drop_hook(src, dst, msg):
                    self.dropped += 1
                    continue
                if _faults().site_armed("msg.drop") and \
                        _faults().should_fire(
                            "msg.drop",
                            ctx=f"{type(msg).__name__} {src}>{dst}"):
                    # the `ms inject socket failures` analog: the armed
                    # trigger (prob/nth/once, match=-scoped) decides
                    from ..fault import (fault_perf_counters,
                                         l_fault_msg_drops)
                    fault_perf_counters().inc(l_fault_msg_drops)
                    self.dropped += 1
                    continue
                ep = self.endpoints.get(dst)
                if ep is None or ep.dispatcher is None:
                    # non-local destination: transports (msg/tcp.py) route
                    # it onward; the base fabric drops it
                    if self._route_remote(src, dst, msg):
                        self.delivered += 1
                    else:
                        self.dropped += 1
                    continue
                self.delivered += 1
                ep.dispatcher.ms_fast_dispatch(msg)
        finally:
            self.pumping = False
        return n

    def _route_remote(self, src: str, dst: str, msg: Message) -> bool:
        """Hook for cross-process transports; False = undeliverable.
        Runs AFTER the down/blackhole/drop filters, so fault injection
        applies identically to local and remote peers."""
        return False
