"""Per-OSD recovery scheduler — backfill/repair as a paced, observable,
QoS-classed workload (docs/RECOVERY.md).

Before this subsystem recovery was a side effect: ``run_recovery``
fanned full-stripe reads (k whole chunks per repaired shard) directly
from the cluster tick, invisible to the QoS tiers and unaccounted
beyond a push counter.  This scheduler makes the repair path a
first-class workload:

- **Repair-optimal rounds**: when the pool's codec exposes the
  regenerating repair surface (``minimum_to_decode`` answering a
  single-shard query with d helper sub-chunk requirements,
  ``repair_contribution`` / ``repair``), a lost shard rebuilds from
  d β-sub-chunk helper contributions instead of k whole chunks —
  ~d·chunk/α bytes moved instead of k·chunk.  Any helper failure (or
  the armed ``recovery.repair_read`` chaos site) degrades the round to
  the existing full-stripe decode path: repair optimality costs
  bandwidth to lose, never an object.  With a mesh up, both the
  regenerating repair solve and the full-stripe reconstruct execute
  as survivor-sharded meshed GF matmuls inside the codec's
  ``repair`` / ``decode_batch`` in the JAX package; the port has no
  mesh yet (ROADMAP Queue 1, the mesh), so both run on the one card.
  A helper set the codec would refuse (``_repairable``) sends a round
  to the full-stripe path before the call; nothing is caught around the
  call, so a device error propagates.
- **QoS classing**: each repair round is enqueued on the sharded op
  queue under ``CLASS_RECOVERY``, so the unified ``DmClockArbiter``
  arbitrates recovery against client work in ONE place — the
  recovery-storm scenario's "well-behaved clients stay inside SLO"
  guarantee is the mClock reservation/weight math, not luck.
- **Pacing**: at most ``osd_recovery_max_active`` repair rounds in
  flight per OSD; excess rounds queue and drain as rounds complete
  (deferrals counted).
- **Accounting**: a ``recovery`` perf-counter logger (helper vs
  full-stripe bytes, repaired shards, fallbacks, pacing) +
  ``ceph_daemon_recovery_*`` Prometheus families + per-codec-family
  bytes-moved-per-repaired-shard on ``recovery dump`` — the figure the
  ``ec_recovery_storm`` bench gate watches.  Each round carries a
  ``recovery``-homed stage ledger (helper-read fan → device repair
  call → d2h → shard-write fan → push ack), so `latency dump` shows
  where repair microseconds go exactly like client ops.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..common.lockdep import DebugLock
from ..common.perf_counters import PerfCounters, PerfCountersBuilder
from ..common.work_queue import CLASS_RECOVERY
from ..fault import g_faults
from ..trace import g_oplat, g_perf_histograms, transfer_size_axes
from ..trace.oplat import OpLedger

# ---- recovery perf counters (perf dump / Prometheus) -----------------------
RECOVERY_FIRST = 98000
l_recovery_repair_rounds = 98001      # sub-chunk repair rounds completed
l_recovery_repaired_shards = 98002    # shards rebuilt (both paths)
l_recovery_helper_reads = 98003       # helper contributions fetched
l_recovery_helper_bytes = 98004       # contribution bytes moved
l_recovery_fullstripe_rounds = 98005  # full-stripe decode rounds
l_recovery_fullstripe_bytes = 98006   # full-stripe source bytes moved
l_recovery_push_bytes = 98007         # rebuilt shard bytes pushed
l_recovery_fallbacks = 98008          # repair rounds degraded to
                                      # full-stripe decode
l_recovery_deferrals = 98009          # rounds parked by pacing
l_recovery_active = 98010             # gauge: rounds in flight
RECOVERY_LAST = 98020

_recovery_pc: Optional[PerfCounters] = None
_recovery_pc_lock = DebugLock("recovery_pc::init")


def recovery_perf_counters() -> PerfCounters:
    """The recovery scheduler's counter logger (perf dump /
    Prometheus ``ceph_daemon_recovery_*``)."""
    global _recovery_pc
    if _recovery_pc is not None:
        return _recovery_pc
    with _recovery_pc_lock:
        if _recovery_pc is None:
            b = PerfCountersBuilder("recovery", RECOVERY_FIRST,
                                    RECOVERY_LAST)
            b.add_u64_counter(l_recovery_repair_rounds, "repair_rounds",
                              "sub-chunk repair rounds completed")
            b.add_u64_counter(l_recovery_repaired_shards,
                              "repaired_shards",
                              "shards rebuilt (repair + full-stripe)")
            b.add_u64_counter(l_recovery_helper_reads, "helper_reads",
                              "helper repair contributions fetched")
            b.add_u64_counter(l_recovery_helper_bytes, "helper_bytes",
                              "repair contribution bytes moved")
            b.add_u64_counter(l_recovery_fullstripe_rounds,
                              "fullstripe_rounds",
                              "full-stripe decode recovery rounds")
            b.add_u64_counter(l_recovery_fullstripe_bytes,
                              "fullstripe_bytes",
                              "full-stripe recovery source bytes moved")
            b.add_u64_counter(l_recovery_push_bytes, "push_bytes",
                              "rebuilt shard bytes pushed to targets")
            b.add_u64_counter(l_recovery_fallbacks, "repair_fallbacks",
                              "repair rounds degraded to full-stripe "
                              "decode")
            b.add_u64_counter(l_recovery_deferrals, "paced_deferrals",
                              "repair rounds parked by "
                              "osd_recovery_max_active pacing")
            b.add_u64(l_recovery_active, "active",
                      "repair rounds currently in flight (gauge)")
            _recovery_pc = b.create_perf_counters()
    return _recovery_pc


def _family_of(ec_impl) -> str:
    sig = getattr(ec_impl, "codec_signature", None)
    if sig is not None:
        return str(sig()[0])
    return type(ec_impl).__name__


# the per-codec-family ledger's key set — ONE definition shared by the
# scheduler's ledger, the cluster aggregation and the bench workload's
# deltas, so a new stat cannot silently drop out of any of them
def _repairable(ec_impl, lost: int, contribs: Dict[int, bytes],
                L: int) -> bool:
    """Whether ``ec_impl.repair`` takes this helper set: exactly ``d``
    helpers, the lost shard not among them, and contributions of one
    size in whole sub-chunk rows of ``L`` bytes.  The JAX package tries
    the repair and answers any exception with a full-stripe round; the
    port checks the codec's refusals first and catches nothing around
    the device call."""
    sizes = {len(b) for b in contribs.values()}
    return (len(contribs) == ec_impl.d and lost not in contribs
            and len(sizes) == 1 and L > 0 and sizes.pop() % L == 0)


FAMILY_KEYS = ("repaired_shards", "helper_bytes", "fullstripe_bytes",
               "bytes_moved", "repair_rounds", "fullstripe_rounds",
               "repair_fallbacks")


def derive_bytes_per_shard(ent: Dict[str, float]) -> None:
    """Stamp the storm metric on a family ledger entry in place."""
    shards = max(ent.get("repaired_shards", 0), 1)
    ent["bytes_moved_per_repaired_shard"] = round(
        ent.get("bytes_moved", 0) / shards, 2)


def aggregate_families(osds) -> Dict[str, Dict[str, float]]:
    """Cluster-wide per-codec-family recovery totals (bench/CLI view):
    merge every OSD scheduler's family ledger and derive
    bytes_moved_per_repaired_shard."""
    out: Dict[str, Dict[str, float]] = {}
    for osd in osds:
        sched = getattr(osd, "recovery_sched", None)
        if sched is None:
            continue
        for fam, ent in sched.families().items():
            tgt = out.setdefault(fam, {k: 0 for k in FAMILY_KEYS})
            for key in FAMILY_KEYS:
                tgt[key] += ent.get(key, 0)
    for ent in out.values():
        derive_bytes_per_shard(ent)
    return out


class RecoveryScheduler:
    """One per OSD (``osd.recovery_sched``); drives sub-chunk repair
    rounds and accounts both recovery paths."""

    def __init__(self, osd):
        self.osd = osd
        self._lock = DebugLock(f"RecoveryScheduler::{osd.name}")
        self._active = 0
        self._parked: deque = deque()
        # in-flight round tokens -> start (cluster clock): a helper
        # dying mid-round would otherwise leak its pacing slot forever
        # (its reply never arrives); the tick reaps stale tokens and
        # the claim-once discipline keeps a late reply from double-
        # releasing the slot
        self._tokens: Dict[int, float] = {}
        self._token_seq = 0
        # per-codec-family ledger: bytes moved per repaired shard is
        # THE storm metric (docs/RECOVERY.md)
        self._families: Dict[str, Dict[str, float]] = {}
        self.hist_bytes = g_perf_histograms.get(
            "recovery", "recovery_bytes_per_shard_histogram",
            transfer_size_axes)

    # ---- options -----------------------------------------------------------
    @staticmethod
    def _opts() -> Tuple[bool, int]:
        from ..common.config import g_conf
        return (bool(g_conf.get_val("osd_recovery_repair_reads")),
                int(g_conf.get_val("osd_recovery_max_active")))

    # ---- per-family ledger -------------------------------------------------
    def _fam(self, family: str) -> Dict[str, float]:
        with self._lock:
            ent = self._families.get(family)
            if ent is None:
                ent = {k: 0 for k in FAMILY_KEYS}
                self._families[family] = ent
            return ent

    def families(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {f: dict(e) for f, e in self._families.items()}

    def note_fullstripe(self, ec_impl, src_bytes: int,
                        n_shards: int) -> None:
        """A full-stripe decode round moved *src_bytes* of source
        chunks to rebuild *n_shards* shards (the classic path — and
        the repair path's fallback)."""
        pc = recovery_perf_counters()
        pc.inc(l_recovery_fullstripe_rounds)
        pc.inc(l_recovery_fullstripe_bytes, src_bytes)
        pc.inc(l_recovery_repaired_shards, n_shards)
        fam = self._fam(_family_of(ec_impl))
        with self._lock:
            fam["fullstripe_rounds"] += 1
            fam["fullstripe_bytes"] += src_bytes
            fam["bytes_moved"] += src_bytes
            fam["repaired_shards"] += n_shards
        self.hist_bytes.inc(src_bytes / max(n_shards, 1))

    def note_push(self, nbytes: int) -> None:
        recovery_perf_counters().inc(l_recovery_push_bytes, nbytes)

    # ---- repair entry point ------------------------------------------------
    def try_repair(self, pg, oid: str,
                   targets: Dict[int, Tuple[int, str]],
                   needed: List[int]) -> bool:
        """Attempt a sub-chunk repair round for *oid*; False means the
        caller must run the full-stripe path (codec without a repair
        surface, multi-shard loss, not enough helpers, repair disabled,
        or the armed ``recovery.repair_read`` chaos site)."""
        enabled, _max_active = self._opts()
        if not enabled or len(needed) != 1:
            return False
        be = pg.backend
        if be is None:
            return False
        impl = be.ec_impl
        if not hasattr(impl, "repair_contribution") or \
                not hasattr(impl, "repair"):
            return False
        lost = needed[0]
        pc = recovery_perf_counters()
        if g_faults.site_armed("recovery.repair_read") and \
                g_faults.should_fire("recovery.repair_read",
                                     ctx=f"{pg.pgid}:{oid}"):
            pc.inc(l_recovery_fallbacks)
            fam = self._fam(_family_of(impl))
            with self._lock:
                fam["repair_fallbacks"] += 1
            return False
        acting = pg.acting_shards()
        # helpers must be up AND hold the object: a down-but-not-yet-
        # remapped member would wedge the round until the reap
        avail = {s for s in acting
                 if s != lost and oid not in pg.missing.get(s, {})
                 and self.osd.osdmap.is_up(acting[s])}
        try:
            plan = impl.minimum_to_decode({lost}, avail)
        except IOError:
            return False
        # a REPAIR plan excludes the lost shard and asks each helper
        # for fewer sub-chunks than a whole chunk; a full-k fetch
        # answer means the codec wants the classic path
        alpha = impl.get_sub_chunk_count()
        if lost in plan or any(
                sum(cnt for _off, cnt in subs) >= alpha
                for subs in plan.values()):
            return False
        self._admit(pg, oid, lost, dict(plan), targets)
        return True

    # ---- pacing ------------------------------------------------------------
    def _admit(self, pg, oid, lost, plan, targets) -> None:
        _enabled, max_active = self._opts()
        pc = recovery_perf_counters()

        def run() -> None:
            self._start_round(pg, oid, lost, plan, targets)

        with self._lock:
            if self._active >= max(max_active, 1):
                self._parked.append((pg, run))
                pc.inc(l_recovery_deferrals)
                return
            self._active += 1
        pc.inc(l_recovery_active)
        self._submit(pg, run)

    def _submit(self, pg, fn: Callable[[], None]) -> None:
        """Route the round through the sharded op queue under the
        recovery dmClock class, so client vs repair ordering is the
        arbiter's decision — never FIFO luck."""
        from ..common.config import g_conf
        osd = self.osd
        osd.op_wq.enqueue(pg.pgid, CLASS_RECOVERY, ("recovery", pg, fn))
        if bool(g_conf.get_val("osd_op_queue_batch_intake")):
            if osd.op_tp is not None:
                osd.op_tp.kick()
            return
        osd.drain_ops()

    def _round_done(self) -> None:
        pc = recovery_perf_counters()
        nxt = None
        with self._lock:
            self._active -= 1
            if self._parked and self._active < max(self._opts()[1], 1):
                nxt = self._parked.popleft()
                self._active += 1
        if nxt is None:
            pc.dec(l_recovery_active)
            return
        # a parked round takes the freed slot: gauge unchanged; it
        # re-enters through the recovery-class queue like any round
        self._submit(*nxt)

    def _open_token(self) -> int:
        with self._lock:
            self._token_seq += 1
            token = self._token_seq
            self._tokens[token] = self.osd.now
        return token

    def _claim(self, token: int) -> bool:
        """Exactly-once round completion: the first of {reply path,
        fallback, stale reap} to claim the token owns the slot
        release; later claimants see False and do nothing."""
        with self._lock:
            return self._tokens.pop(token, None) is not None

    # a wedged round (helper died; its reply will never come) frees
    # its slot after this many cluster-clock seconds — past the OSD's
    # own RECOVERY_RETRY re-kick, so the re-driven recovery owns the
    # object by the time the slot recycles
    ROUND_REAP_S = 30.0

    def kick(self) -> None:
        """Tick-driven nudge: reap wedged rounds, then drain parked
        rounds when slots freed up outside the completion path."""
        now = self.osd.now
        with self._lock:
            stale = [t for t, t0 in self._tokens.items()
                     if now - t0 > self.ROUND_REAP_S]
        for t in stale:
            if self._claim(t):
                self._round_done()
        while True:
            nxt = None
            with self._lock:
                if self._parked and \
                        self._active < max(self._opts()[1], 1):
                    nxt = self._parked.popleft()
                    self._active += 1
                    recovery_perf_counters().inc(l_recovery_active)
            if nxt is None:
                return
            self._submit(*nxt)

    # ---- one repair round --------------------------------------------------
    def _start_round(self, pg, oid: str, lost: int, plan,
                     targets) -> None:
        be = pg.backend
        impl = be.ec_impl
        pc = recovery_perf_counters()
        family = _family_of(impl)
        # the round's stage ledger: helper fan -> gather -> device
        # repair call -> d2h -> shard-write fan -> push ack, under the
        # `recovery` daemon in `latency dump` / oplat histograms
        led = OpLedger("recovery")
        token = self._open_token()

        def fallback() -> None:
            pc.inc(l_recovery_fallbacks)
            fam = self._fam(family)
            with self._lock:
                fam["repair_fallbacks"] += 1
            self._round_done()
            self.osd._recover_ec_oid_fullstripe(pg, oid, targets,
                                                [lost])

        def on_contribs(res: int, contribs: Dict[int, bytes],
                        size: int, attrs: Dict[str, bytes]) -> None:
            if res != 0 or len(contribs) != len(plan) or size < 0:
                if self._claim(token):
                    fallback()
                return
            moved = sum(len(b) for b in contribs.values())
            C = be.sinfo.get_chunk_size()
            L = C // impl.get_sub_chunk_count() \
                if impl.get_sub_chunk_count() else C
            if not _repairable(impl, lost, contribs, L):
                if self._claim(token):
                    fallback()
                return
            arrays = {h: np.frombuffer(b, dtype=np.uint8).reshape(-1, L)
                      for h, b in contribs.items()}
            # nothing is caught here: a failed build or launch reaches
            # the caller
            with g_oplat.activate(led):
                chunk = impl.repair(lost, arrays)
                led.mark("device_call")
                chunk_bytes = chunk.tobytes()
                led.mark("d2h")
            pc.inc(l_recovery_repair_rounds)
            pc.inc(l_recovery_repaired_shards)
            pc.inc(l_recovery_helper_reads, len(contribs))
            pc.inc(l_recovery_helper_bytes, moved)
            self.hist_bytes.inc(moved)
            fam = self._fam(family)
            with self._lock:
                fam["repair_rounds"] += 1
                fam["repaired_shards"] += 1
                fam["helper_bytes"] += moved
                fam["bytes_moved"] += moved
            version = max(v for (v, _op) in targets.values())

            def pushed() -> None:
                led.mark("ack_gather")
                self.osd.dout(
                    5, f"repair push of {oid} shard {lost} acked "
                    f"({moved}B helper bytes vs "
                    f"{be.sinfo.get_chunk_size()}B chunk)")
                from ..osd.osd import L_OSD_RECOVERY_PUSH
                pg.missing.get(lost, {}).pop(oid, None)
                if not pg.missing.get(lost):
                    pg.send_backfill_complete(lost)
                self.osd.perf_counters.inc(L_OSD_RECOVERY_PUSH)
                pg.recovery_done_for(oid)
                if self._claim(token):
                    self._round_done()

            self.note_push(len(chunk_bytes))
            with g_oplat.activate(led):
                be.push_chunks(oid, {lost: chunk_bytes}, size, pushed,
                               version=version,
                               xattrs=attrs if attrs else None)
                led.mark("fan_out")

        self.osd.dout(5, f"repair round {oid} shard {lost} via "
                      f"{sorted(plan)} (pg {pg.pgid})")
        with g_oplat.activate(led):
            be.repair_read(oid, lost, plan, on_contribs)

    # ---- introspection (`recovery dump`) -----------------------------------
    def dump(self) -> Dict:
        enabled, max_active = self._opts()
        with self._lock:
            fams = {f: dict(e) for f, e in self._families.items()}
            active, parked = self._active, len(self._parked)
        for ent in fams.values():
            derive_bytes_per_shard(ent)
        return {
            "options": {"osd_recovery_repair_reads": enabled,
                        "osd_recovery_max_active": max_active},
            "active_rounds": active,
            "parked_rounds": parked,
            "families": fams,
        }
