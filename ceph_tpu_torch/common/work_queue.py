"""Sharded op queue + mClock QoS scheduling — the OSD's op intake.

Two reference mechanisms reproduced with honest semantics:

- ``ShardedOpWQ`` (common/WorkQueue.h:618, osd/OSD.cc:2008): client ops
  land in one of N shards keyed by PG id, so one PG's ops stay strictly
  FIFO while different PGs interleave fairly.  The reference drains
  shards with a thread pool; this single-threaded runtime drains them
  explicitly (``drain``), preserving the ordering/fairness contract the
  threads would give.
- ``MClockQueue`` (osd/mClockOpClassQueue.h over src/dmclock): QoS
  arbitration between op classes (client / recovery / scrub / snaptrim)
  by (reservation, weight, limit) tags.  Classes below their
  reservation are served first (most-behind first); the rest share by
  weight (lowest virtual finish tag wins); classes at their limit wait.

The scheduler decides ORDER whenever more ops are queued than drained
in one step — exactly the burst case QoS exists for.

Per-client dmClock (docs/QOS.md): inside each class queue, ops that
carry a client entity are arbitrated by a second dmClock tier keyed by
that entity — (reservation, weight, limit) per client, defaults from
the ``osd_mclock_client_*`` options, overrides from
``osd_mclock_client_overrides``.  The class tier stays the OUTER
arbiter (recovery/scrub arbitration is unchanged); the client tier
only decides WHICH client's op goes when the class tier picks that
class.  The client tier always runs the deterministic virtual clock
(one tick per pop): its reservation/limit are shares of the class's
dequeues (ops per 1000 client-tier pops), not wall rates — wall-rate
enforcement stays a class-tier (WallMClockQueue) property.

The port's own copy of ``ceph_tpu/common/work_queue.py``.
"""
from __future__ import annotations

import threading

from .lockdep import DebugLock
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

from ..trace.oplat import mark_item

# op classes (mClockOpClassQueue's osd_op_queue_mclock_* option groups)
CLASS_CLIENT = "client"
CLASS_RECOVERY = "recovery"
CLASS_SCRUB = "scrub"
CLASS_SNAPTRIM = "snaptrim"

# (reservation, weight, limit) per class, in ops per virtual second;
# defaults shaped like the reference's mclock option defaults: clients
# get most of the weight, background work is reservation-guaranteed but
# limited so it cannot starve clients
DEFAULT_TAGS: Dict[str, Tuple[float, float, float]] = {
    CLASS_CLIENT: (100.0, 500.0, 0.0),      # limit 0 = unlimited
    CLASS_RECOVERY: (50.0, 100.0, 200.0),
    CLASS_SCRUB: (10.0, 50.0, 100.0),
    CLASS_SNAPTRIM: (10.0, 50.0, 100.0),
}


# ---- qos perf counters (perf dump / Prometheus) ----------------------------
QOS_FIRST = 95000
l_qos_dequeue_client = 95001     # client-class ops dequeued
l_qos_dequeue_recovery = 95002
l_qos_dequeue_scrub = 95003
l_qos_dequeue_snaptrim = 95004
l_qos_admission_rejections = 95005  # ops refused at intake (EAGAIN)
l_qos_throttle_events = 95006    # clients newly entering throttle
l_qos_queue_depth = 95007        # gauge: op-queue depth at last intake
QOS_LAST = 95010

_CLASS_DEQ_IDX = {
    CLASS_CLIENT: l_qos_dequeue_client,
    CLASS_RECOVERY: l_qos_dequeue_recovery,
    CLASS_SCRUB: l_qos_dequeue_scrub,
    CLASS_SNAPTRIM: l_qos_dequeue_snaptrim,
}

_qos_pc = None
_qos_pc_lock = DebugLock("qos_pc::init")


def qos_perf_counters():
    """The op-queue QoS counter logger (perf dump / Prometheus)."""
    global _qos_pc
    if _qos_pc is not None:
        return _qos_pc
    with _qos_pc_lock:
        if _qos_pc is None:
            from .perf_counters import PerfCountersBuilder
            b = PerfCountersBuilder("qos", QOS_FIRST, QOS_LAST)
            b.add_u64_counter(l_qos_dequeue_client, "dequeues_client",
                              "client-class ops dequeued")
            b.add_u64_counter(l_qos_dequeue_recovery, "dequeues_recovery",
                              "recovery-class ops dequeued")
            b.add_u64_counter(l_qos_dequeue_scrub, "dequeues_scrub",
                              "scrub-class ops dequeued")
            b.add_u64_counter(l_qos_dequeue_snaptrim, "dequeues_snaptrim",
                              "snaptrim-class ops dequeued")
            b.add_u64_counter(l_qos_admission_rejections,
                              "admission_rejections",
                              "client ops shed at intake "
                              "(osd_op_queue_admission_max)")
            b.add_u64_counter(l_qos_throttle_events, "throttle_events",
                              "clients newly entering the admission "
                              "throttle window")
            b.add_u64(l_qos_queue_depth, "queue_depth",
                      "op-queue depth observed at the last intake")
            _qos_pc = b.create_perf_counters()
    return _qos_pc


def _note_class_dequeue(op_class: str) -> None:
    idx = _CLASS_DEQ_IDX.get(op_class)
    if idx is not None:
        qos_perf_counters().inc(idx)


class DmClockArbiter:
    """The dmclock-lite three-phase arbitration core, generalized over
    an abstract ENTITY key with pluggable tag lookup — one
    implementation shared by both virtual-clock tiers (the class tier
    arbitrates op classes in :class:`MClockQueue`, the client tier
    arbitrates client entities in :class:`ClientDmClock`) so the tiers
    cannot drift (the ROADMAP residual-debt item; the self-tuning
    control plane will turn tags through this one core).

    Tags are (reservation, weight, limit) shares per 1000 dequeues of
    the owning queue's virtual clock — one tick per pop, deterministic,
    no wall time in the decision path (wall-rate enforcement is
    :class:`WallMClockQueue`'s separate job).  The three phases:

    - **reservation**: entities behind their guaranteed share go
      first, most-behind-its-floor first;
    - **weight**: among entities under their limit, the lowest
      NORMALIZED virtual finish tag (``w_tag / weight``) wins;
    - **limit**: ``w_tag >= now * limit / 1000`` stands an entity
      aside in the weight phase — unless every candidate is at its
      limit (work conservation: an idle server never refuses work).

    Idle->active re-clamping (``activate``) keeps the dmclock
    invariants: no hoarded reservation credit, and the weight tag
    starts at the most-behind ACTIVE entity's normalized finish.  The
    tiers differ only in the clamp's default when NOTHING else is
    active: ``track_floor=True`` (client tier) remembers the last
    served finish tag so a newcomer to an empty lane set cannot starve
    entities with history; ``False`` (class tier) leaves the tag
    untouched, the class tier's historical rule.
    """

    __slots__ = ("r_tags", "w_tags", "now", "w_floor", "track_floor")

    def __init__(self, track_floor: bool = False):
        self.r_tags: Dict[str, float] = {}
        self.w_tags: Dict[str, float] = {}
        self.now = 0.0
        self.w_floor = 0.0          # last served normalized finish tag
        self.track_floor = track_floor

    def tick(self) -> None:
        """Advance the virtual clock: one unit per dequeue attempt."""
        self.now += 1.0

    def activate(self, entity: str, res: float, weight: float,
                 active: List[str],
                 weight_of: Callable[[str], float]) -> None:
        """Idle->active tag re-clamp for *entity*; *active* is the set
        of entities with queued work (the activating entity's queue is
        still empty when this runs)."""
        if res > 0:
            self.r_tags[entity] = max(self.r_tags.get(entity, 0.0),
                                      self.now * res / 1000.0)
        floors = [self.w_tags.get(c, 0.0) / max(weight_of(c), 1e-9)
                  for c in active]
        if floors:
            floor = min(floors)
        elif self.track_floor:
            floor = self.w_floor
        else:
            return
        self.w_tags[entity] = max(self.w_tags.get(entity, 0.0),
                                  floor * max(weight, 1e-9))

    def pick(self, candidates: List[str],
             tags: Dict[str, Tuple[float, float, float]]) -> str:
        """The three-phase choice among non-empty *candidates*."""
        if len(candidates) == 1:
            return candidates[0]
        # phase 1: reservations — most-behind-its-floor first
        best, best_deficit = None, 0.0
        for c in candidates:
            res = tags[c][0]
            if res <= 0:
                continue
            deficit = self.now * res / 1000.0 - self.r_tags.get(c, 0.0)
            if deficit > best_deficit:
                best, best_deficit = c, deficit
        if best is not None:
            return best

        # phase 2: weight shares — lowest normalized finish tag wins;
        # entities at their limit stand aside unless all are (phase 3)
        def finish(c: str) -> float:
            return self.w_tags.get(c, 0.0) / max(tags[c][1], 1e-9)

        under = [c for c in candidates
                 if not self.at_limit(c, tags[c][2])]
        return min(under or candidates, key=finish)

    def at_limit(self, entity: str, lim: float) -> bool:
        if lim <= 0:
            return False
        return self.w_tags.get(entity, 0.0) >= self.now * lim / 1000.0

    def serve(self, entity: str, weight: float) -> None:
        """Account one dequeue against *entity*'s tags."""
        self.r_tags[entity] = self.r_tags.get(entity, 0.0) + 1.0
        self.w_tags[entity] = self.w_tags.get(entity, 0.0) + 1.0
        if self.track_floor:
            self.w_floor = max(
                self.w_floor,
                self.w_tags[entity] / max(weight, 1e-9))

    def forget(self, entity: str) -> None:
        """Drop an evicted entity's tag state (bounded memory under
        entity churn; a returner is re-clamped like any newcomer)."""
        self.r_tags.pop(entity, None)
        self.w_tags.pop(entity, None)


class ClientDmClock:
    """The per-client dmClock lane INSIDE one op class's queue.

    Deque-compatible container (``push``/``pop``/``__len__``) so the
    class-tier arbiters need not know clients exist: when the class
    tier picks this class, ``pop`` runs a second (reservation, weight,
    limit) arbitration across the client entities queued here.  Ops
    enqueued with no client share the ``""`` lane (pure FIFO among
    themselves — exactly the pre-client behavior).

    Virtual clock: one tick per pop, so reservation/limit read as ops
    per 1000 client-tier dequeues — deterministic, like MClockQueue.
    The arbitration itself is :class:`DmClockArbiter` — the SAME core
    the class tier runs, parameterized only by this tier's tag lookup
    and floor policy.  Per-client tags resolve override ->
    ``osd_mclock_client_*`` defaults; ``osd_mclock_client_overrides``
    is parsed lazily ("entity:res:weight:limit[,entity:...]") and
    re-parsed whenever the option string changes, so injectargs takes
    effect immediately.
    """

    __slots__ = ("_queues", "_arb", "_size",
                 "_dequeues", "_override_src", "_overrides",
                 "_local_tags", "_defaults", "_resolved")

    def __init__(self):
        self._queues: Dict[str, Deque] = {}
        self._arb = DmClockArbiter(track_floor=True)
        self._size = 0
        self._dequeues: Dict[str, int] = {}
        self._override_src: Optional[str] = None
        self._overrides: Dict[str, Tuple[float, float, float]] = {}
        self._local_tags: Dict[str, Tuple[float, float, float]] = {}
        self._defaults: Optional[Tuple[float, float, float]] = None
        self._resolved: Dict[str, Tuple[float, float, float]] = {}

    # ---- tags --------------------------------------------------------------
    def set_client_tags(self, client: str, res: float, weight: float,
                        limit: float) -> None:
        self._local_tags[client] = (float(res), float(weight),
                                    float(limit))

    def _refresh_tag_sources(self) -> None:
        """Re-read the osd_mclock_client_* options ONCE per arbitration
        (pop / idle->active push), not once per candidate: any change
        to the overrides string or the three defaults drops the
        per-client resolved cache, so injectargs stays live while a
        steady-state pop costs one dict lookup per candidate."""
        from .config import g_conf
        src = str(g_conf.get_val("osd_mclock_client_overrides") or "")
        defaults = (
            float(g_conf.get_val("osd_mclock_client_reservation")),
            float(g_conf.get_val("osd_mclock_client_weight")),
            float(g_conf.get_val("osd_mclock_client_limit")))
        if src == self._override_src and defaults == self._defaults:
            return
        self._override_src = src
        self._defaults = defaults
        self._resolved = {}
        self._overrides = {}
        for part in src.replace(";", ",").split(","):
            part = part.strip()
            if not part:
                continue
            bits = part.rsplit(":", 3)
            if len(bits) != 4:
                continue     # malformed entry: fall to defaults
            try:
                self._overrides[bits[0]] = (float(bits[1]),
                                            float(bits[2]),
                                            float(bits[3]))
            except ValueError:
                continue

    def _tags_for(self, client: str) -> Tuple[float, float, float]:
        t = self._local_tags.get(client)
        if t is not None:
            return t
        t = self._resolved.get(client)
        if t is None:
            if self._defaults is None:
                self._refresh_tag_sources()
            t = self._resolved[client] = self._overrides.get(
                client, self._defaults)
        return t

    # ---- deque-compatible container API ------------------------------------
    def __len__(self) -> int:
        return self._size

    def push(self, client: str, item) -> None:
        q = self._queues.get(client)
        if q is None:
            q = self._queues[client] = deque()
        if not q:
            # idle -> active re-clamp (DmClockArbiter.activate): no
            # hoarded reservation credit, weight tag floored at the
            # most-behind ACTIVE client's normalized finish (or the
            # last served finish when alone — track_floor)
            self._refresh_tag_sources()
            res, weight, _lim = self._tags_for(client)
            active = [c for c, aq in self._queues.items() if aq]
            self._arb.activate(client, res, weight, active,
                               lambda c: self._tags_for(c)[1])
        q.append(item)
        self._size += 1

    def pop(self):
        """QoS-chosen item; None when empty."""
        candidates = [c for c, q in self._queues.items() if q]
        if not candidates:
            return None
        self._arb.tick()
        # one option-change check per pop; per-candidate resolution is
        # then a cached dict lookup (nothing can change mid-decision)
        self._refresh_tag_sources()
        tags = {c: self._tags_for(c) for c in candidates}
        best = self._arb.pick(candidates, tags)
        item = self._queues[best].popleft()
        self._size -= 1
        self._arb.serve(best, tags[best][1])
        self._dequeues[best] = self._dequeues.get(best, 0) + 1
        if not self._queues[best] and len(self._queues) > 64:
            # bound per-client memory under churn ("millions of
            # users"): evict the drained lane AND its tag/accounting
            # state — a returning client is re-clamped by push() like
            # any newcomer, so dropped history is safe by construction
            del self._queues[best]
            self._arb.forget(best)
            self._dequeues.pop(best, None)
            self._resolved.pop(best, None)
        return item

    def dump(self) -> Dict:
        return {
            "queued": {c: len(q) for c, q in self._queues.items() if q},
            "dequeues": dict(self._dequeues),
            "w_tags": {c: round(v, 3)
                       for c, v in self._arb.w_tags.items()},
        }


class _LiveClassTags:
    """Live ``osd_mclock_class_overrides`` overlay for the class-tier
    queues: the constructor tags are kept as a base, and every
    arbitration entry point re-checks the option string (cached-source
    idiom, like ``ClientDmClock._refresh_tag_sources``) so injectargs
    re-weights a RUNNING queue without daemon restart — the controller
    plane's recovery-vs-client actuator depends on this.  Classes not
    present in the base tag set are ignored (an override cannot invent
    an op class), malformed entries fall through to the base tags."""

    def _init_live_tags(self, tags: Optional[Dict[str, Tuple[
            float, float, float]]]) -> None:
        self._base_tags = dict(tags or DEFAULT_TAGS)
        self.tags = dict(self._base_tags)
        self._class_src: Optional[str] = None
        # apply the overlay NOW so an unchanged option string never
        # rebuilds self.tags later — direct pokes at a live queue's
        # tags (the test idiom) survive until the option changes
        self._refresh_class_tags()

    def _refresh_class_tags(self) -> None:
        from .config import g_conf
        src = str(g_conf.get_val("osd_mclock_class_overrides") or "")
        if src == self._class_src:
            return
        self._class_src = src
        merged = dict(self._base_tags)
        for part in src.replace(";", ",").split(","):
            part = part.strip()
            if not part:
                continue
            bits = part.rsplit(":", 3)
            if len(bits) != 4 or bits[0] not in merged:
                continue     # malformed / unknown class: base tags
            try:
                merged[bits[0]] = (float(bits[1]), float(bits[2]),
                                   float(bits[3]))
            except ValueError:
                continue
        self.tags = merged


class MClockQueue(_LiveClassTags):
    """dmclock-lite over a virtual clock that advances one unit per
    dequeue (deterministic; no wall time in the decision path).

    The arbitration is :class:`DmClockArbiter` over op-class entity
    keys with ``self.tags`` as the tag lookup — the SAME core the
    per-client lanes inside each class run, so the two tiers cannot
    drift apart.  ``self.tags`` is the constructor base overlaid live
    with ``osd_mclock_class_overrides`` (:class:`_LiveClassTags`)."""

    def __init__(self, tags: Optional[Dict[str, Tuple[float, float,
                                                      float]]] = None):
        self._init_live_tags(tags)
        self._queues: Dict[str, ClientDmClock] = {}
        self._arb = DmClockArbiter(track_floor=False)
        self._size = 0

    def enqueue(self, op_class: str, item, client: str = "") -> None:
        self._refresh_class_tags()
        if op_class not in self.tags:
            op_class = CLASS_CLIENT
        q = self._queues.get(op_class)
        if q is None:
            q = self._queues[op_class] = ClientDmClock()
        if not q:
            # idle -> active re-clamp (DmClockArbiter.activate): a
            # long-idle class cannot cash in an unbounded reservation
            # deficit or dodge its limit
            res, weight, _lim = self.tags[op_class]
            active = [c for c, aq in self._queues.items() if aq]
            self._arb.activate(op_class, res, weight, active,
                               lambda c: self.tags[c][1])
        q.push(client, item)
        self._size += 1

    def __len__(self) -> int:
        return self._size

    def dequeue(self):
        """Pop the QoS-chosen item; None when empty."""
        self._arb.tick()
        self._refresh_class_tags()
        candidates = [c for c, q in self._queues.items() if q]
        if not candidates:
            return None
        best = self._arb.pick(candidates, self.tags)
        # stage ledger: the class tier picked this class NOW; the lane
        # pop below is the client tier's own arbitration (oplat stages
        # class_queue / client_lane — host-side stamps only)
        t_pick = time.perf_counter()
        item = self._queues[best].pop()
        self._size -= 1
        self._arb.serve(best, self.tags[best][1])
        _note_class_dequeue(best)
        mark_item(item, "class_queue", t_pick)
        mark_item(item, "client_lane")
        return item

    def dump(self) -> Dict:
        return {
            "queued": {c: len(q) for c, q in self._queues.items() if q},
            "vclock": self._arb.now,
            "r_tags": dict(self._arb.r_tags),
            "w_tags": dict(self._arb.w_tags),
            # client-tier accounting survives a drained queue: the
            # dequeue history is exactly what an operator inspects
            # AFTER a burst
            "clients": {c: q.dump() for c, q in self._queues.items()},
        }

    def _at_limit(self, c: str) -> bool:
        return self._arb.at_limit(c, self.tags[c][2])


class WallMClockQueue(_LiveClassTags):
    """dmclock against WALL time — a real rate enforcer, not just an
    ordering arbiter (src/dmclock dmc::PriorityQueue semantics).

    Tags are per-class times in seconds: the reservation tag is when
    the class's next guaranteed-credit falls due (1/res apart), the
    limit tag is when it is next allowed a weight-phase dequeue (1/lim
    apart).  ``dequeue(now)``:

    - reservation phase: any class whose reservation tag <= now is owed
      service; most-overdue first.  Floors are therefore honored in
      real ops/sec, and an idle class cannot hoard credit (tags clamp
      to now on idle->active, dmclock's tag re-clamping).
    - weight phase: among classes under their limit (limit tag <= now),
      lowest virtual finish tag wins; serving pushes the limit tag
      forward by 1/lim, so a class can NEVER exceed limit ops/sec over
      any window, even on an otherwise idle OSD.
    - neither ready: returns (None, next_due) so the caller can sleep
      until credit accrues instead of spinning.

    (res, weight, limit) keep the DEFAULT_TAGS shapes but are read as
    ops per REAL second here.
    """

    def __init__(self, tags: Optional[Dict[str, Tuple[float, float,
                                                      float]]] = None,
                 clock: Optional[Callable[[], float]] = None):
        import time as _time
        self._init_live_tags(tags)
        self.clock = clock or _time.monotonic
        self._queues: Dict[str, ClientDmClock] = {}
        self._r_next: Dict[str, float] = {}   # next reservation due
        self._l_next: Dict[str, float] = {}   # next limit-allowed slot
        self._w_tags: Dict[str, float] = {}   # virtual weight finish
        self._w_floor = 0.0                   # last served finish tag
        self._size = 0

    def enqueue(self, op_class: str, item, client: str = "") -> None:
        self._refresh_class_tags()
        if op_class not in self.tags:
            op_class = CLASS_CLIENT
        q = self._queues.get(op_class)
        if q is None:
            q = self._queues[op_class] = ClientDmClock()
        if not q:
            now = self.clock()
            # idle -> active: no hoarded reservation credit, no limit
            # debt from the idle past
            self._r_next[op_class] = max(
                self._r_next.get(op_class, 0.0), now)
            self._l_next[op_class] = max(
                self._l_next.get(op_class, 0.0), now)
            # clamp the weight tag to the virtual present: a fresh
            # class entering an EMPTY queue starts at the last served
            # finish tag (not 0, which would starve any class with
            # history), and a returning class starts no better than
            # the most-behind active class
            active = [c for c, aq in self._queues.items() if aq]
            floor = min((self._w_tags.get(c, 0.0) for c in active),
                        default=self._w_floor)
            self._w_tags[op_class] = max(
                self._w_tags.get(op_class, 0.0), floor)
        q.push(client, item)
        self._size += 1

    def __len__(self) -> int:
        return self._size

    def dequeue(self, now: Optional[float] = None):
        """-> (item, 0.0) or (None, next_due_time); next_due is 0.0
        when the queue is empty."""
        now = self.clock() if now is None else now
        self._refresh_class_tags()
        candidates = [c for c, q in self._queues.items() if q]
        if not candidates:
            return None, 0.0
        # ---- reservation phase (floors) --------------------------------
        best, best_overdue = None, 0.0
        for c in candidates:
            res = self.tags[c][0]
            if res <= 0:
                continue
            overdue = now - self._r_next.get(c, 0.0)
            if overdue >= 0 and (best is None or overdue > best_overdue):
                best, best_overdue = c, overdue
        if best is not None:
            return self._serve(best, now, reserved=True), 0.0
        # ---- weight phase (shares under ceilings) ----------------------
        under = [c for c in candidates
                 if self.tags[c][2] <= 0
                 or self._l_next.get(c, 0.0) <= now]
        if under:
            best = min(under, key=lambda c: self._w_tags.get(c, 0.0))
            return self._serve(best, now, reserved=False), 0.0
        # everyone is rate-blocked: report when the earliest credit
        # (reservation or limit slot) falls due
        nxt = min(min((self._r_next.get(c, now) for c in candidates
                       if self.tags[c][0] > 0), default=float("inf")),
                  min(self._l_next.get(c, now) for c in candidates))
        return None, nxt

    def _serve(self, c: str, now: float, reserved: bool):
        t_pick = time.perf_counter()
        item = self._queues[c].pop()
        self._size -= 1
        _note_class_dequeue(c)
        mark_item(item, "class_queue", t_pick)
        mark_item(item, "client_lane")
        res, weight, lim = self.tags[c]
        if res > 0:
            # served work counts toward the floor whatever phase it
            # used (dmclock advances the reservation tag on any serve)
            self._r_next[c] = max(self._r_next.get(c, 0.0), now) \
                + (1.0 / res)
        if lim > 0:
            self._l_next[c] = max(self._l_next.get(c, 0.0), now) \
                + (1.0 / lim)
        self._w_tags[c] = self._w_tags.get(c, 0.0) \
            + 1.0 / max(weight, 1e-9)
        self._w_floor = self._w_tags[c]
        return item

    def has_ready(self, now: Optional[float] = None) -> bool:
        """True when some queued op is dispatchable right now (not
        rate-blocked) — the drain/flush boundary must not wait out the
        rate limiter itself."""
        now = self.clock() if now is None else now
        for c, q in self._queues.items():
            if not q:
                continue
            res, _w, lim = self.tags[c]
            if res > 0 and self._r_next.get(c, 0.0) <= now:
                return True
            if lim <= 0 or self._l_next.get(c, 0.0) <= now:
                return True
        return False

    def dump(self) -> Dict:
        return {
            "queued": {c: len(q) for c, q in self._queues.items() if q},
            "mode": "wall",
            "r_next": dict(self._r_next),
            "l_next": dict(self._l_next),
            "w_tags": dict(self._w_tags),
            "clients": {c: q.dump() for c, q in self._queues.items()},
        }


class ShardedOpWQ:
    """PG-sharded front queues feeding per-shard mClock arbiters."""

    def __init__(self, n_shards: int = 5,
                 tags: Optional[Dict] = None, wall: bool = False):
        self.n_shards = n_shards
        self.wall = wall
        cls = WallMClockQueue if wall else MClockQueue
        self.shards: List = [cls(tags) for _ in range(n_shards)]
        # one PG's ops must stay FIFO: the shard index is a pure
        # function of the pgid (OSD.cc shard = pgid.hash % num_shards)
        self._rr = 0

    def _deq(self, shard):
        """Uniform dequeue across clock modes; wall mode records when
        the next rate credit falls due so drainers can sleep exactly
        that long instead of a fixed poll interval."""
        if not self.wall:
            return shard.dequeue()
        item, nxt = shard.dequeue()
        if item is None and nxt:
            cur = getattr(self, "next_due", 0.0)
            self.next_due = nxt if not cur else min(cur, nxt)
        return item

    def take_next_due(self) -> float:
        """Earliest rate-credit time seen since the last call (0 =
        none); wall mode only."""
        nd = getattr(self, "next_due", 0.0)
        self.next_due = 0.0
        return nd

    def ready(self) -> bool:
        """Is there work dispatchable NOW?  In wall mode rate-blocked
        ops don't count: flush()/drain boundaries must not block on the
        rate limiter's schedule."""
        if not self.wall:
            return len(self) > 0
        return any(sh.has_ready() for sh in self.shards)

    def shard_of(self, pgid: Tuple[int, int]) -> int:
        return hash(pgid) % self.n_shards

    def enqueue(self, pgid: Tuple[int, int], op_class: str, item,
                client: str = "") -> None:
        pool = getattr(self, "_pool", None)
        if pool is not None:
            # threaded mode: the per-shard queues are shared with the
            # workers; serialize on the pool's condition lock and wake
            with pool._cv:
                self.shards[self.shard_of(pgid)].enqueue(op_class, item,
                                                         client)
                pool._cv.notify_all()
        else:
            self.shards[self.shard_of(pgid)].enqueue(op_class, item,
                                                     client)

    def __len__(self) -> int:
        return sum(len(s) for s in self.shards)

    def dump(self) -> Dict:
        """Introspection for the admin socket (dump_op_pq_state role)."""
        return {f"shard_{i}": sh.dump()
                for i, sh in enumerate(self.shards)}

    def drain(self, handler: Callable, max_ops: int = 0) -> int:
        """Round-robin the shards, QoS-dequeue within each; returns the
        number of ops handled."""
        done = 0
        idle_rounds = 0
        while idle_rounds < self.n_shards:
            if max_ops and done >= max_ops:
                break
            shard = self.shards[self._rr]
            self._rr = (self._rr + 1) % self.n_shards
            item = self._deq(shard)
            if item is None:
                idle_rounds += 1
                continue
            idle_rounds = 0
            handler(item)
            done += 1
        return done


class ShardedThreadPool:
    """Real worker threads draining the sharded queues — the reference's
    ShardedThreadPool (common/WorkQueue.h:618, started by the OSD at
    OSD.cc:2008 as osd_op_tp).

    Each worker owns a subset of shards (shard i -> worker i % n) so a
    PG's ops stay FIFO within their shard while different shards run
    GENUINELY concurrently; the handler is responsible for taking the
    locks its shared state needs (the reference's dequeue_op takes the
    PG lock the same way), which is exactly what puts lockdep and the
    mClock arbiters under real contention.
    """

    def __init__(self, wq: "ShardedOpWQ", handler: Callable,
                 n_threads: int = 2):
        import threading
        self.wq = wq
        self.handler = handler
        self.n_threads = max(1, n_threads)
        self._lock = DebugLock("ThreadPool::lock")
        self._cv = threading.Condition(self._lock)
        self._stopping = False
        self._active = 0
        wq._pool = self
        self._threads = [
            threading.Thread(target=self._worker, args=(i,),
                             name=f"osd-op-tp-{i}", daemon=True)
            for i in range(self.n_threads)]
        for t in self._threads:
            t.start()

    def _my_shards(self, i: int) -> List[int]:
        return [s for s in range(self.wq.n_shards)
                if s % self.n_threads == i]

    def _worker(self, i: int) -> None:
        shards = self._my_shards(i)
        while True:
            item = None
            with self._cv:
                while True:
                    if self._stopping:
                        return
                    for s in shards:
                        item = self.wq._deq(self.wq.shards[s])
                        if item is not None:
                            break
                    if item is not None:
                        self._active += 1
                        break
                    timeout = 0.05
                    if self.wq.wall:
                        nd = self.wq.take_next_due()
                        if nd:
                            import time as _time
                            timeout = max(0.001,
                                          min(0.05,
                                              nd - _time.monotonic()))
                    self._cv.wait(timeout=timeout)
            try:
                self.handler(item)
            except Exception:
                # a poisoned op must not kill the worker: its shards
                # are statically partitioned with no takeover, so a
                # dead thread would strand every future op hashed to
                # them (and hang flush callers)
                import traceback
                traceback.print_exc()
            finally:
                with self._cv:
                    self._active -= 1
                    self._cv.notify_all()

    def kick(self) -> None:
        """Wake workers after an enqueue."""
        with self._cv:
            self._cv.notify_all()

    def flush(self, timeout: float = 60.0) -> None:
        """Block until every queued op has been HANDLED (drain + join
        in-flight handlers) — the synchronous boundary the in-process
        fabric's pump loops rely on."""
        import time as _time
        end = _time.monotonic() + timeout
        with self._cv:
            self._cv.notify_all()
            while (self.wq.ready() or self._active) and \
                    _time.monotonic() < end:
                self._cv.wait(timeout=0.05)
                self._cv.notify_all()
        if self.wq.ready() or self._active:
            raise TimeoutError("op thread pool failed to drain")

    def stop(self) -> None:
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=5.0)
