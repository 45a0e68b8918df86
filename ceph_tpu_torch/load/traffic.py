"""Traffic generator — N synthetic clients over the real client stack.

The "heavy traffic" half of the north star (ROADMAP): nothing else in
the repo generates sustained concurrent multi-client load — tests drive
a handful of ops and every bench workload uses one submitter.  This
module drives a MiniCluster with N :class:`SyntheticClient`\\ s, each a
real ``RadosClient`` (own messenger endpoint, own Objecter-style tid
space, own map subscription) submitting ops WITHOUT blocking on each
reply, so one fabric pump carries a genuine burst of concurrent client
traffic into the OSDs' sharded op queues — exactly the case the
per-client dmClock tier and overload admission control exist for
(docs/QOS.md).

Determinism: the fabric is single-threaded; a run is a sequence of
*rounds*.  Each round every client issues ops per its arrival process
(interleaved round-robin across clients so arrival order is fair), then
one ``network.pump()`` delivers the burst; with
``osd_op_queue_batch_intake`` the OSDs accumulate the whole burst and
drain it through the mClock tiers at quiescence.  Completion *rounds*
are therefore deterministic (seeded RNGs, no wall time in any decision
path); wall-clock latencies feed the per-client PerfHistograms the
percentiles are read from.

Workload shape knobs (:class:`TrafficSpec`): arrival process (closed
loop with a per-client in-flight window, or open loop with a Poisson
per-round rate and per-client rate multipliers — the abusive-client
dial), read/write mix, object-size distribution, and Zipfian hot-key
skew over each client's key space.  Clients own disjoint key spaces and
serialize per key, so every read is verifiable byte-exact against the
client's last committed payload — "every op completes byte-exact" is an
assertable property, not a hope.

Port of ``ceph_tpu/load/traffic.py``.  Every event and both loops are
host code; the elastic-membership events (``mesh_chip_add`` /
``mesh_chip_retire``) change ``ec_mesh_chips`` through the mesh
runtime's observer, as in the JAX package.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..client.rados import RadosClient
from ..common.config import g_conf
from ..common.work_queue import (
    l_qos_admission_rejections, l_qos_queue_depth, l_qos_throttle_events,
    qos_perf_counters,
)
from ..msg.messages import (
    CEPH_OSD_OP_READ, CEPH_OSD_OP_WRITEFULL, MOSDOp, MOSDOpReply,
    new_trace_id,
)
from ..trace import g_perf_histograms, latency_axes
from ..trace.oplat import stamp_client

# retryable resend caps: an op survives this many peering/silent-primary
# rounds (throttle resends are budgeted separately — backpressure is
# not an error and under saturation legitimately recurs for a while)
MAX_OP_ATTEMPTS = 64
MAX_THROTTLE_RESENDS = 4096


@dataclass
class TrafficSpec:
    """One workload's shape (see module docstring)."""
    pool: str = "load"
    n_clients: int = 8
    ops_per_client: int = 64
    read_fraction: float = 0.5
    # (size_bytes, weight) choices for write payloads
    object_sizes: Tuple[Tuple[int, float], ...] = (
        (512, 0.50), (4096, 0.35), (16384, 0.15))
    keys_per_client: int = 16
    zipf_theta: float = 0.99      # hot-key skew; 0 = uniform
    mode: str = "closed"          # "closed" | "open"
    window: int = 4               # closed loop: ops in flight per client
    rate: float = 8.0             # open loop: mean issues per round
    # per-client multiplier on ``rate`` (pad with 1.0); (10, 1, 1, ...)
    # is the abusive-client saturation shape
    rate_multipliers: Tuple[float, ...] = ()
    seed: int = 20260803
    max_rounds: int = 100000
    tick_every: int = 32          # cluster.tick cadence (retry sweeps)
    keep_completions: bool = True  # False for soaks: aggregate only
    # first-class cluster events scheduled mid-run (the recovery-storm
    # shape, docs/RECOVERY.md): (round, action, arg) with action in
    # osd_kill | osd_down | osd_out | osd_revive | osd_in (arg = osd
    # id) or mesh_chip_add | mesh_chip_retire (arg = CHIP COUNT delta
    # applied to the live ec_mesh_chips target; docs/CHAOS.md) — fired
    # at the START of that round, so the remaining traffic runs
    # against the changed topology.  "osd_kill" is the full storm
    # trigger (network down + mon mark-down); pair it with "osd_out"
    # to start backfill to a spare while clients keep running.
    events: Tuple[Tuple[int, str, int], ...] = ()
    # scheduled callables (round, fn) fired at the START of that round
    # with the cluster as the only argument, same passed-round
    # semantics as ``events`` — the chaos composer compiles fault
    # arm/clear legs into these (the declarative ScenarioSpec stays
    # the unit of determinism; chaos/engine.py compiles it)
    hooks: Tuple[Tuple[int, Callable], ...] = ()


@dataclass
class PendingOp:
    kind: str                     # "write" | "read"
    oid: str
    payload: bytes                # write body / expected read body
    expect_absent: bool = False
    t0: float = 0.0               # perf_counter at FIRST issue
    round0: int = 0               # round of first issue
    attempts: int = 0
    throttle_resends: int = 0


class SyntheticClient(RadosClient):
    """A RadosClient that submits without blocking on replies.

    ``step(round)`` (re)sends per the arrival process; replies are
    consumed in ``ms_fast_dispatch`` during the pump, where wall
    latency lands in this client's PerfHistogram
    (``client_op_latency_histogram``, logger = client name) and
    completion rounds in the deterministic round-latency tally.
    """

    def __init__(self, network, mon, name: str, spec: TrafficSpec,
                 index: int):
        super().__init__(network, mon, name)
        self.spec = spec
        self.index = index
        self.rng = np.random.default_rng(spec.seed * 1009 + index)
        self.pool_id = self.lookup_pool(spec.pool)
        self.issued = 0
        self.completed = 0
        self.throttled = 0
        self.errors: List[str] = []
        self.completions: List[Tuple[str, int, int, float]] = []
        self.round_latency_max = 0
        self.pending: Dict[int, PendingOp] = {}
        self._resend: List[PendingOp] = []
        self._inflight_oids: set = set()
        self._committed: Dict[str, bytes] = {}
        self._gen: Dict[str, int] = {}
        self.hist = g_perf_histograms.get(
            name, "client_op_latency_histogram", latency_axes)
        # the registry is process-global and a later run may reuse this
        # entity name: this run's percentiles must be THIS run's
        # distribution, not the process's
        self.hist.reset()
        self.bytes_moved = 0
        # zipf CDF over the client's key space: p(k) ~ 1/(k+1)^theta
        w = np.arange(1, spec.keys_per_client + 1,
                      dtype=np.float64) ** -max(spec.zipf_theta, 0.0)
        self._zipf_cdf = np.cumsum(w / w.sum())
        sizes = np.asarray([s for s, _w in spec.object_sizes])
        sw = np.asarray([w for _s, w in spec.object_sizes],
                        dtype=np.float64)
        self._sizes, self._size_cdf = sizes, np.cumsum(sw / sw.sum())

    # ---- arrival process ---------------------------------------------------
    def done(self) -> bool:
        return (self.issued >= self.spec.ops_per_client
                and not self.pending and not self._resend)

    def ops_to_issue(self) -> int:
        """How many NEW ops this round's arrival process asks for."""
        sp = self.spec
        budget = sp.ops_per_client - self.issued
        if budget <= 0:
            return 0
        if sp.mode == "open":
            mult = sp.rate_multipliers[self.index] \
                if self.index < len(sp.rate_multipliers) else 1.0
            n = int(self.rng.poisson(max(sp.rate * mult, 0.0)))
        else:
            n = sp.window - len(self.pending) - len(self._resend)
        return max(0, min(n, budget))

    def _pick_key(self) -> str:
        k = int(np.searchsorted(self._zipf_cdf, self.rng.random()))
        return f"{self.name}-k{k}"

    def _pick_size(self) -> int:
        return int(self._sizes[int(np.searchsorted(
            self._size_cdf, self.rng.random()))])

    def make_op(self) -> Optional[PendingOp]:
        """Draw the next op: a read hits a committed key byte-exactly
        (falling back to a write while nothing is committed yet); a
        client never races itself on one oid, so "expected bytes" stays
        well-defined under concurrency."""
        want_read = (self.rng.random() < self.spec.read_fraction
                     and bool(self._committed))
        if want_read:
            oid = self._pick_key()     # zipf skew first...
            if oid not in self._committed or oid in self._inflight_oids:
                ks = [k for k in self._committed
                      if k not in self._inflight_oids]
                if not ks:
                    want_read = False  # every committed key is busy
                else:                  # ...uniform over committed else
                    oid = ks[int(self.rng.integers(len(ks)))]
            if want_read:
                # reserve at DRAW time: a later draw this same round
                # must not put a write on this oid, or the expected
                # bytes go stale if the ops retry in throttle cycles
                self._inflight_oids.add(oid)
                return PendingOp("read", oid, self._committed[oid])
        for _try in range(8):
            oid = self._pick_key()
            if oid in self._inflight_oids:
                continue
            gen = self._gen.get(oid, 0) + 1
            self._gen[oid] = gen
            body = np.random.default_rng(
                (hash(oid) & 0xFFFFFFFF) * 131 + gen).integers(
                    0, 256, self._pick_size(), dtype=np.uint8).tobytes()
            self._inflight_oids.add(oid)
            return PendingOp("write", oid, body)
        return None

    # ---- send / resend -----------------------------------------------------
    def _send(self, op: PendingOp, round_no: int) -> None:
        pgid, primary = self._calc_target(self.pool_id, op.oid)
        self._tid += 1
        tid = self._tid
        if op.attempts == 0 and op.throttle_resends == 0:
            op.t0 = time.perf_counter()
            op.round0 = round_no
        self.pending[tid] = op
        self._inflight_oids.add(op.oid)
        if primary < 0:
            # no primary yet (peering): park for the next round, under
            # the same attempt cap as reply-path retries — a PG that
            # never elects a primary must fail fast as "retries
            # exhausted", not spin the run to max_rounds
            del self.pending[tid]
            op.attempts += 1
            if op.attempts > MAX_OP_ATTEMPTS:
                self._inflight_oids.discard(op.oid)
                self.errors.append(
                    f"{op.kind} {op.oid}: retries exhausted (no primary)")
                return
            self.mon.send_full_map(self.name)
            self._resend.append(op)
            return
        msg = MOSDOp(
            tid=tid, pool=pgid[0], oid=op.oid, pgid=pgid,
            op=CEPH_OSD_OP_WRITEFULL if op.kind == "write"
            else CEPH_OSD_OP_READ,
            data=op.payload if op.kind == "write" else b"",
            epoch=self.osdmap.epoch,
            trace_id=new_trace_id())
        # stage-latency ledger submit stamp (trace/oplat.py): harness
        # traffic decomposes like any client's — the OSD-side
        # client_flight stage shows pump-cycle transit under load
        stamp_client(msg, self.name)
        self.messenger.send_message(msg, f"osd.{primary}")

    def collect_sends(self, round_no: int) -> List[PendingOp]:
        """This round's sends, IN ORDER (resends first — throttled /
        peering replays — then new ops per the arrival process) but not
        yet sent: the generator interleaves the per-client batches
        round-robin so one client's burst cannot monopolize arrival
        order (independent clients' packets interleave on a real
        network; without this the abusive client would always win the
        admission race simply by being enumerated first)."""
        self._round = round_no
        # window accounting BEFORE the resend swap: throttled/parked
        # ops already left self.pending, so the closed-loop window
        # must count them via _resend or a throttled client would
        # stack a full window of NEW ops on top of its replays
        n_new = self.ops_to_issue()
        out, self._resend = self._resend, []
        # NOTE: resend ops keep their _inflight_oids reservation — a
        # throttled read must not race a new write to its oid, or the
        # expected bytes become ambiguous (per-oid serialization is
        # what makes byte-exact verification sound)
        for _ in range(n_new):
            op = self.make_op()
            if op is None:
                break
            self.issued += 1
            out.append(op)
        return out

    # ---- completion --------------------------------------------------------
    def ms_fast_dispatch(self, msg) -> None:
        if isinstance(msg, MOSDOpReply) and msg.tid in self.pending:
            self._complete(msg.tid, msg)
            return
        super().ms_fast_dispatch(msg)

    def _complete(self, tid: int, reply: MOSDOpReply) -> None:
        op = self.pending.pop(tid)
        if reply.result == -11:
            # retryable: the op stays logically in flight — its
            # _inflight_oids reservation is NOT released, so no new op
            # can race it on the same oid while it waits to resend
            if getattr(reply, "retry_after", 0.0) > 0:
                # admission throttle: resend next round (the pump in
                # between is what drains the OSD's queue)
                self.throttled += 1
                op.throttle_resends += 1
                if op.throttle_resends <= MAX_THROTTLE_RESENDS:
                    self._resend.append(op)
                    return
            else:
                op.attempts += 1
                if op.attempts <= MAX_OP_ATTEMPTS:
                    # peering/misroute: refresh the map, retry
                    self.mon.send_full_map(self.name)
                    self._resend.append(op)
                    return
            self._inflight_oids.discard(op.oid)
            self.errors.append(f"{op.kind} {op.oid}: retries exhausted")
            return
        self._inflight_oids.discard(op.oid)
        round_no = getattr(self, "_round", op.round0)
        if op.kind == "write":
            if reply.result != 0:
                self.errors.append(
                    f"write {op.oid}: {reply.result}")
                return
            self._committed[op.oid] = op.payload
        else:
            if op.expect_absent:
                if reply.result != -2:
                    self.errors.append(
                        f"read {op.oid}: expected ENOENT, "
                        f"got {reply.result}")
                    return
            elif reply.result != 0:
                self.errors.append(f"read {op.oid}: {reply.result}")
                return
            elif bytes(reply.data) != op.payload:
                self.errors.append(f"read {op.oid}: BYTES DIVERGED "
                                   f"({len(reply.data)} vs "
                                   f"{len(op.payload)})")
                return
        self.completed += 1
        self.bytes_moved += len(op.payload)
        lat_us = (time.perf_counter() - op.t0) * 1e6
        self.hist.inc(lat_us)
        rl = round_no - op.round0
        self.round_latency_max = max(self.round_latency_max, rl)
        if self.spec.keep_completions:
            self.completions.append((op.kind, op.round0, round_no,
                                     lat_us))


# ---- percentiles out of the PerfHistogram machinery ------------------------
# ONE percentile implementation for every consumer: the quantile rule
# lives in trace.histogram (hist_percentiles / merged_percentiles,
# shared with `latency dump`, the bench stage_breakdown deltas and the
# mgr telemetry rollup's cluster merge) and is re-exported here for the
# harness's historical import path.
from ..trace.histogram import hist_percentiles, merged_percentiles  # noqa: E402


def _apply_event(cluster, action: str, osd_id: int) -> None:
    """One scheduled topology event (TrafficSpec.events)."""
    if action == "osd_kill":
        cluster.kill_osd(osd_id)
        cluster.mark_osd_down(osd_id)
    elif action == "osd_down":
        cluster.mark_osd_down(osd_id)
    elif action == "osd_out":
        cluster.mark_osd_out(osd_id)
    elif action == "osd_revive":
        cluster.revive_osd(osd_id)
    elif action == "osd_in":
        cluster.mark_osd_in(osd_id)
    elif action in ("mesh_chip_add", "mesh_chip_retire"):
        # elastic membership as a first-class storyline step: the arg
        # is a CHIP COUNT delta (not an osd id) applied to the live
        # ec_mesh_chips target.  set_checked fires the MeshRuntime
        # observer, so the drain-on-old-mesh + plan-cache rebuild run
        # right here, between rounds, under open traffic.
        from ..mesh import g_mesh
        cur = int(g_conf.get_val("ec_mesh_chips"))
        if cur < 0:         # -1 = all devices: resolve to the live size
            mesh = g_mesh.topology()
            cur = 0 if mesh is None else mesh.size
        delta = int(osd_id)
        if action == "mesh_chip_retire":
            delta = -delta
        g_conf.set_checked("ec_mesh_chips", max(cur + delta, 1))
    else:
        raise ValueError(f"unknown traffic event action '{action}'")


@dataclass
class TrafficResult:
    spec: TrafficSpec
    rounds: int = 0
    elapsed_s: float = 0.0
    total_ops: int = 0
    completed: int = 0
    bytes_moved: int = 0          # payload bytes of completed ops
    errors: List[str] = field(default_factory=list)
    byte_exact: bool = False
    throttled_total: int = 0
    admission_rejections: int = 0
    throttle_events: int = 0
    max_intake_depth: int = 0
    per_client: Dict[str, Dict] = field(default_factory=dict)
    aggregate: Dict[str, float] = field(default_factory=dict)

    @property
    def ops_per_sec(self) -> float:
        # client-observed completions, never issue rate: an op that
        # exhausted retries must not inflate a fenced throughput figure
        return self.completed / self.elapsed_s if self.elapsed_s else 0.0


def run_traffic(cluster, spec: TrafficSpec,
                progress=None) -> TrafficResult:
    """Drive *cluster* (pool ``spec.pool`` must exist) with the traffic
    shape in *spec*; returns per-client + aggregate stats.  Batch
    intake is enabled for the run (and restored after) so each round's
    burst sees real mClock arbitration."""
    qos = qos_perf_counters()
    rej0 = qos.get(l_qos_admission_rejections)
    thr0 = qos.get(l_qos_throttle_events)
    # the depth gauge is only written at admission-checked intakes: a
    # previous run's high-water must not leak into this run's report
    qos.set(l_qos_queue_depth, 0)
    saved = g_conf.values.get("osd_op_queue_batch_intake")
    g_conf.set_val("osd_op_queue_batch_intake", True)
    res = TrafficResult(spec=spec)
    t_start = time.perf_counter()
    try:
        clients = [SyntheticClient(cluster.network, cluster.mon,
                                   f"client.{spec.pool}.{i}", spec, i)
                   for i in range(spec.n_clients)]
        rnd = 0
        fired: set = set()
        hooks_fired: set = set()
        while rnd < spec.max_rounds:
            for i, (r_ev, action, osd_id) in enumerate(spec.events):
                # events fire when their round arrives (or is passed —
                # a run can complete rounds faster than scheduled)
                if i not in fired and rnd >= r_ev:
                    fired.add(i)
                    _apply_event(cluster, action, osd_id)
            for i, (r_hk, fn) in enumerate(spec.hooks):
                if i not in hooks_fired and rnd >= r_hk:
                    hooks_fired.add(i)
                    fn(cluster)
            if all(cl.done() for cl in clients) and \
                    len(fired) == len(spec.events) and \
                    len(hooks_fired) == len(spec.hooks):
                break
            batches = [cl.collect_sends(rnd) for cl in clients]
            sent = sum(len(b) for b in batches)
            # fair arrival order: round-robin one op per client until
            # every batch drains (per-client order preserved)
            while any(batches):
                for cl, batch in zip(clients, batches):
                    if batch:
                        cl._send(batch.pop(0), rnd)
            cluster.network.pump()
            res.max_intake_depth = max(res.max_intake_depth,
                                       qos.get(l_qos_queue_depth))
            if spec.tick_every and rnd % spec.tick_every == \
                    spec.tick_every - 1:
                # drive retry sweeps / heartbeats like a live cluster
                cluster.tick(dt=0.5)
            if progress is not None and rnd % 256 == 255:
                progress(rnd, sum(cl.completed for cl in clients))
            if sent == 0 and not any(cl.pending or cl._resend
                                     for cl in clients) and \
                    len(fired) == len(spec.events) and \
                    len(hooks_fired) == len(spec.hooks) and \
                    all(cl.issued >= spec.ops_per_client
                        for cl in clients):
                # truly drained: budgets spent AND nothing in flight.
                # An all-zero Poisson round with budget remaining must
                # NOT end the run — later rounds draw again.
                break
            rnd += 1
        res.rounds = rnd
    finally:
        if saved is None:
            g_conf.rm_val("osd_op_queue_batch_intake")
        else:
            g_conf.set_val("osd_op_queue_batch_intake", saved)
    res.elapsed_s = time.perf_counter() - t_start
    res.total_ops = sum(cl.issued for cl in clients)
    res.completed = sum(cl.completed for cl in clients)
    res.bytes_moved = sum(cl.bytes_moved for cl in clients)
    res.throttled_total = sum(cl.throttled for cl in clients)
    res.admission_rejections = \
        qos.get(l_qos_admission_rejections) - rej0
    res.throttle_events = qos.get(l_qos_throttle_events) - thr0
    for cl in clients:
        res.errors.extend(f"{cl.name}: {e}" for e in cl.errors)
        res.per_client[cl.name] = {
            "issued": cl.issued,
            "completed": cl.completed,
            "throttled": cl.throttled,
            "round_latency_max": cl.round_latency_max,
            **hist_percentiles(cl.hist),
        }
    res.byte_exact = (not res.errors
                      and res.completed == res.total_ops
                      and res.total_ops
                      == spec.n_clients * spec.ops_per_client)
    # aggregate percentiles over the union of the per-client
    # distributions — the telemetry rollup's merge core (same edges,
    # so the cluster tail is exact, not an approximation)
    res.aggregate = merged_percentiles([cl.hist for cl in clients])
    return res
