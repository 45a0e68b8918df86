"""Monitor — the cluster control plane, electable and replicated.

Stand-in for the reference's paxos-replicated OSDMonitor
(src/mon/OSDMonitor.cc): the leader owns the authoritative OSDMap, stages
changes in an Incremental, replicates committed epochs to its quorum
(MMonPaxos begin/accept/commit — src/mon/Paxos.cc phases, leader-driven
and simplified), and publishes to every subscriber (MOSDMap).  Leadership
comes from an election among reachable monitors — lowest rank wins
(src/mon/Elector.cc) — driven by keepalive pings; a dead leader is
detected by grace timeout and a surviving quorum re-elects and continues
from its last committed epoch (the collect/last recovery phase syncs
whoever is behind).  A single monitor (the default) is its own quorum
and behaves exactly like the round-1 monitor-lite.

Pool/EC-profile management mirrors the mon flow: a profile is stored in
the map, the plugin is instantiated to validate it and to create the crush
rule (OSDMonitor.cc:5335 get_erasure_code, :5298 crush_rule_create_erasure),
and the pool's stripe_width comes from the plugin's chunk math.  Failure
reports (quorum of 2 reporters) mark OSDs down and publish a new epoch;
peons forward reports to the leader.

The port's own copy of ``ceph_tpu/mon/monitor.py``.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional, Set, Tuple

from ..crush.constants import CRUSH_BUCKET_STRAW2
from ..ec import create_erasure_code
from ..msg import Dispatcher, MOSDFailure, MOSDMap, Message, Network
from ..msg.messages import (
    MLog, MMDSBeacon, MMonElection, MMonPaxos, MMonPing, MMonSubscribe,
    MOSDBoot, MOSDPGTemp,
)
from ..osdmap import (
    CEPH_OSD_IN, Incremental, OSDMap, TYPE_ERASURE, TYPE_REPLICATED,
    pg_pool_t,
)
from ..trace.journal import g_journal

DEFAULT_STRIPE_UNIT = 4096  # osd_pool_erasure_code_stripe_unit
MON_PING_GRACE = 15.0       # leader silent this long -> re-elect
MDS_BEACON_GRACE = 15.0     # active mds silent this long -> failover


class Monitor(Dispatcher):
    def __init__(self, network: Network, name: str = "mon",
                 rank: int = 0, peers: Optional[List[str]] = None,
                 monmap=None):
        self.network = network
        self.name = name
        self.rank = rank
        self.peers = list(peers or [])       # other mon names
        # the epoched mon roster as a first-class map (MonMap.h):
        # built from the quorum membership when not handed one (in-
        # process fabrics have no addresses; ranks synthesize stable
        # loopback ports)
        if monmap is None:
            import uuid as _uuid
            from .monmap import MonMap
            roster = sorted({name, *self.peers})
            # deterministic fsid from the roster: every mon of one
            # cluster derives the SAME cluster identity (the JAX
            # package's URL prefix, so a roster gets the same fsid there)
            monmap = MonMap(fsid=str(_uuid.uuid5(
                _uuid.NAMESPACE_URL,
                "ceph-tpu://" + ",".join(roster))))
            monmap.epoch = 1
            for i, n in enumerate(roster):
                monmap.add(n, f"127.0.0.1:{6789 + i}/0")
        self.monmap = monmap
        self.messenger = network.create_messenger(name)
        self.messenger.add_dispatcher_head(self)
        self.osdmap = OSDMap()
        self.osdmap.epoch = 0
        self.incrementals: List[Incremental] = []
        self.subscribers: List[str] = []
        self._topology_dirty = False  # crush/pools changed since last epoch
        # pg_temp pins primed by placement changes, folded into the
        # next topology publish (snapshot incs don't carry pg_temp)
        self._primed_pg_temp: Dict = {}
        # failure reports per target (mon_osd_min_down_reporters=2 —
        # a single partitioned reporter can't take the cluster down)
        self._failure_reports: Dict[int, set] = {}
        # down->out auto-eviction (mon_osd_down_out_interval, 600 s
        # default): a dead osd is marked out so CRUSH re-places its
        # data; a mere flap that reboots in time keeps its weight
        self.down_out_interval = 600.0
        self._down_stamps: Dict[int, float] = {}
        # ---- election / quorum state (Elector.cc role) --------------------
        self.election_epoch = 0
        self.leader_rank = 0 if not self.peers else -1
        self.quorum: Set[int] = {rank} if not self.peers else set()
        self._election_acks: Set[int] = set()
        self._peer_ranks: Dict[str, int] = {}
        self._last_peer_seen: Dict[int, float] = {}
        self.now = 0.0
        self._last_tick: Optional[float] = None
        # consecutive compensated stalls per liveness stamp since that
        # peer last actually spoke (bounds the compensation)
        self._grace_credit: Dict[int, int] = {}
        self._mds_grace_credit: Dict[str, int] = {}
        # ---- paxos state (Paxos.cc begin/accept/commit) -------------------
        # leader: the value currently awaiting an accept quorum, plus
        # proposals queued behind it (Paxos allows one in flight)
        self._inflight: Optional[Dict] = None
        self._pending_proposals: List[Dict] = []
        # any replica: a value staged at BEGIN but not yet known
        # committed: (pn, epoch, value_dict, locally_prematerialized)
        self._uncommitted: Optional[tuple] = None
        # leader recovery (collect/last): acks seen + best uncommitted
        self._collect_acks: Set[int] = set()
        self._collect_pn = -1
        self._collect_uncommitted: Optional[tuple] = None
        # ---- paxos services sharing the one consensus ---------------------
        # cluster log (LogMonitor role): committed entries, newest last;
        # bounded like the reference's in-memory summary
        self.cluster_log: List[Tuple[float, str, str, str]] = []
        self.cluster_log_max = 10000
        # replicated key-value store (ConfigKeyService role)
        self.config_kv: Dict[str, str] = {}
        # leader: log entries awaiting the next committed epoch, plus
        # recently seen daemon-entry identities (the broadcast fan-in
        # dedup — cleared wholesale when it grows, a cheap rolling set)
        self._pending_log: List[Tuple[float, str, str, str]] = []
        self._recent_log_keys: Set[Tuple[float, str, str, str]] = set()

    # ---- roles -------------------------------------------------------------
    def is_leader(self) -> bool:
        return self.leader_rank == self.rank

    def is_peon(self) -> bool:
        return self.leader_rank >= 0 and not self.is_leader()

    def n_mons(self) -> int:
        return len(self.peers) + 1

    def _majority(self) -> int:
        return self.n_mons() // 2 + 1

    def _peer_name(self, rank: int) -> Optional[str]:
        for name, r in self._peer_ranks.items():
            if r == rank:
                return name
        # fall back to the conventional naming
        cand = f"mon.{rank}"
        return cand if cand in self.peers else None

    # ---- election (Elector.cc: lowest reachable rank wins) ----------------
    def start_election(self) -> None:
        if not self.peers:
            self.leader_rank = self.rank
            self.quorum = {self.rank}
            return
        self._demote_inflight()
        self.election_epoch += 1
        if self.election_epoch % 2 == 0:
            self.election_epoch += 1      # odd = electing
        self.leader_rank = -1
        self._election_acks = {self.rank}
        for p in self.peers:
            self.messenger.send_message(MMonElection(
                op=MMonElection.OP_PROPOSE, epoch=self.election_epoch,
                rank=self.rank), p)

    def _handle_election(self, msg: MMonElection) -> None:
        self._peer_ranks[msg.src] = msg.rank
        if msg.op == MMonElection.OP_PROPOSE:
            if msg.epoch > self.election_epoch:
                self.election_epoch = msg.epoch
            if msg.rank < self.rank:
                # defer to the lower rank — and HOLD OFF our own
                # tick-driven retry while their round runs (Elector.cc
                # defer(): re-proposing the instant after acking storms
                # the election with ever-higher epochs; real processes
                # on a loaded host can storm for dozens of rounds)
                self.leader_rank = -1
                self._election_defer_until = self.now + \
                    max(MON_PING_GRACE / 2.0, 1.0)
                self.messenger.send_message(MMonElection(
                    op=MMonElection.OP_ACK, epoch=msg.epoch,
                    rank=self.rank), msg.src)
            else:
                # we outrank them: counter-propose
                self.start_election()
        elif msg.op == MMonElection.OP_ACK:
            if self.is_leader() and msg.epoch == self.election_epoch - 1:
                # straggler ack for the election we just won: widen the
                # quorum and bring the peer in (Elector expand behavior)
                if msg.rank not in self.quorum:
                    self.quorum.add(msg.rank)
                    self.messenger.send_message(MMonElection(
                        op=MMonElection.OP_VICTORY,
                        epoch=self.election_epoch, rank=self.rank,
                        quorum=sorted(self.quorum)), msg.src)
                    self.messenger.send_message(MMonPaxos(
                        op=MMonPaxos.OP_COLLECT, rank=self.rank,
                        pn=self.election_epoch,
                        last_committed=self.osdmap.epoch), msg.src)
                return
            if msg.epoch != self.election_epoch or self.leader_rank >= 0:
                return
            self._election_acks.add(msg.rank)
            if len(self._election_acks) >= self._majority():
                self._declare_victory()
        elif msg.op == MMonElection.OP_VICTORY:
            if msg.rank > self.rank:
                # lowest-rank-wins: a HIGHER rank declaring victory
                # while we are alive means our own proposal raced its
                # round (our acks were dropped once we "had a leader").
                # Serving under it would deadlock — we'd never propose
                # again (the leader looks alive) and it would keep a
                # quorum excluding us.  Counter-propose instead; the
                # new round converges on us (Elector.cc classic mode:
                # the leader is the lowest live rank).
                if msg.epoch > self.election_epoch:
                    self.election_epoch = msg.epoch
                self.start_election()
                return
            if msg.rank != self.rank:
                self._demote_inflight()
            self.election_epoch = msg.epoch
            self.leader_rank = msg.rank
            self.quorum = set(msg.quorum)
            self._last_peer_seen[msg.rank] = self.now
            self._grace_credit.pop(msg.rank, None)

    def _declare_victory(self) -> None:
        self.election_epoch += 1          # even = decided
        self.leader_rank = self.rank
        self.quorum = set(self._election_acks)
        g_journal.emit(self.name, "mon_election",
                       leader=self.rank, epoch=self.election_epoch,
                       quorum=sorted(self.quorum))
        for p in self.peers:
            self.messenger.send_message(MMonElection(
                op=MMonElection.OP_VICTORY, epoch=self.election_epoch,
                rank=self.rank, quorum=sorted(self.quorum)), p)
        # recovery (collect/last): learn whatever the quorum committed
        # that we missed, and surface any staged-but-uncommitted value —
        # starting with our own — so a possibly-majority-accepted
        # proposal gets finished (Paxos.cc leader recovery)
        self._collect_acks = {self.rank}
        self._collect_pn = self.election_epoch
        self._collect_uncommitted = self._uncommitted
        self._uncommitted = None
        # down->out bookkeeping is leader-local: rebuild it from the
        # map so eviction survives leadership changes (the reference
        # reconstructs down_pending_out the same way)
        for o in range(self.osdmap.max_osd):
            if not self.osdmap.is_up(o) and self.osdmap.osd_weight[o]:
                self._down_stamps.setdefault(o, self.now)
        for r in self.quorum - {self.rank}:
            name = self._peer_name(r)
            if name:
                self.messenger.send_message(MMonPaxos(
                    op=MMonPaxos.OP_COLLECT, rank=self.rank,
                    pn=self.election_epoch,
                    last_committed=self.osdmap.epoch), name)

    # ---- paxos replication (Paxos.cc begin/accept/commit) -----------------
    #
    # A value is committed only after a majority ACCEPTs it: the leader
    # stages it in _inflight and ships OP_BEGIN; peons STAGE it (no map
    # mutation) and ACCEPT; the leader applies + broadcasts OP_COMMIT
    # once accepts (incl. its own) reach a majority.  A leader
    # partitioned mid-BEGIN therefore never exposes the value anywhere;
    # a value a majority staged survives leader death via the
    # collect/LAST recovery re-proposal.

    def _demote_inflight(self) -> None:
        """Leadership lost (or contested): our in-flight proposal is no
        longer ours to commit — keep it staged like a peon would, so
        collect recovery can surface it.  Queued proposals are simply
        dropped; any topology state they materialized in the working map
        must be purged with them (their value can never commit)."""
        fl = self._inflight
        if fl is not None:
            self._inflight = None
            self._uncommitted = (fl["pn"], fl["epoch"], fl["value"],
                                 fl["topology"])
        pending_topology = any(p["topology"]
                               for p in self._pending_proposals)
        self._pending_proposals.clear()
        if pending_topology:
            self._rebuild_from_incrementals()
            if self._uncommitted is not None:
                # the rebuild also reverted the demoted value's own
                # in-place state; its VALUE is a full snapshot dict, so
                # a later re-proposal re-applies it cleanly — the map is
                # no longer dirty with it
                u = self._uncommitted
                self._uncommitted = (u[0], u[1], u[2], False)

    def _discard_uncommitted(self) -> None:
        """Drop the staged value; if it was our own topology proposal
        the working map was mutated in place before the commit — rebuild
        it from the committed history so the ghost state vanishes."""
        u = self._uncommitted
        self._uncommitted = None
        if u is not None and u[3]:
            self._rebuild_from_incrementals()

    def _rebuild_from_incrementals(self) -> None:
        m = OSDMap()
        m.epoch = 0
        self.cluster_log = []
        self.config_kv = {}
        for inc in self.incrementals:
            m.apply_incremental(inc)
            self._apply_service(inc)
        self.osdmap = m
        self._topology_dirty = False

    def _apply_service(self, inc: Incremental) -> None:
        """Fold a committed epoch's service payloads into the local
        LogMonitor/ConfigKeyService state (every mon, every commit path
        — the services are exactly as replicated as the map)."""
        if inc.service_log:
            self.cluster_log.extend(inc.service_log)
            if len(self.cluster_log) > self.cluster_log_max:
                del self.cluster_log[:-self.cluster_log_max]
        for k, v in inc.service_config_kv.items():
            if v is None:
                self.config_kv.pop(k, None)
            else:
                self.config_kv[k] = v

    def _apply_committed_values(self, values: List) -> None:
        from ..osdmap.encoding import incremental_from_dict
        for d in values:
            inc = incremental_from_dict(d)
            if inc.epoch != self.osdmap.epoch + 1:
                continue
            if self._uncommitted is not None and \
                    inc.epoch >= self._uncommitted[1]:
                # the round our staged value hoped to win is decided
                self._discard_uncommitted()
            self.osdmap.apply_incremental(inc)
            self.incrementals.append(inc)
            self._apply_service(inc)

    def _handle_paxos(self, msg: MMonPaxos) -> None:
        from ..osdmap.encoding import incremental_from_dict, \
            incremental_to_dict
        if msg.op == MMonPaxos.OP_COLLECT:
            # new leader asks what we committed past its epoch — a
            # higher proposal number also supersedes our own leadership
            if msg.pn >= self.election_epoch:
                self._demote_inflight()
            deltas = [incremental_to_dict(i) for i in self.incrementals
                      if i.epoch > msg.last_committed]
            u = self._uncommitted
            self.messenger.send_message(MMonPaxos(
                op=MMonPaxos.OP_LAST, rank=self.rank,
                pn=msg.pn, last_committed=self.osdmap.epoch,
                values=deltas,
                uncommitted_pn=u[0] if u else -1,
                uncommitted_value=list(u[1:3]) if u else None), msg.src)
        elif msg.op == MMonPaxos.OP_LAST:
            if not self.is_leader():
                return
            self._apply_committed_values(msg.values)
            # push our surplus back so the peon catches up (these are
            # committed epochs: OP_COMMIT, not a new proposal)
            self._send_commit_surplus(msg.last_committed,
                                      self._peer_name(msg.rank)
                                      or msg.src)
            if msg.pn != getattr(self, "_collect_pn", -1):
                return      # straggler from a superseded collect round
            self._collect_acks.add(msg.rank)
            if msg.uncommitted_value is not None:
                best = self._collect_uncommitted
                if best is None or msg.uncommitted_pn > best[0]:
                    if best is not None and best[3]:
                        # our own superseded topology proposal: purge
                        # its in-place map mutations before replacing
                        self._rebuild_from_incrementals()
                    ep, val = msg.uncommitted_value
                    self._collect_uncommitted = (msg.uncommitted_pn,
                                                 ep, val, False)
            if len(self._collect_acks) >= self._majority():
                self._finish_collect()
        elif msg.op == MMonPaxos.OP_BEGIN:
            # peon: STAGE the proposed value and accept — commitment is
            # the leader's call once a majority accepted.  A stale
            # proposal number (superseded leader) gets no promise.
            if msg.pn < self.election_epoch:
                return
            if msg.values:
                d = msg.values[-1]
                inc = incremental_from_dict(d)
                if inc.epoch > self.osdmap.epoch:
                    if self._uncommitted is not None and \
                            self._uncommitted[0] <= msg.pn:
                        self._discard_uncommitted()
                    self._uncommitted = (msg.pn, inc.epoch, d, False)
            self.messenger.send_message(MMonPaxos(
                op=MMonPaxos.OP_ACCEPT, rank=self.rank, pn=msg.pn,
                last_committed=self.osdmap.epoch), msg.src)
        elif msg.op == MMonPaxos.OP_ACCEPT:
            fl = self._inflight
            if self.is_leader() and fl is not None and msg.pn == fl["pn"]:
                fl["accepts"].add(msg.rank)
                # a lagging accepter also gets the committed surplus
                self._send_commit_surplus(msg.last_committed, msg.src)
                self._maybe_commit()
        elif msg.op == MMonPaxos.OP_COMMIT:
            self._apply_committed_values(msg.values)

    def _send_commit_surplus(self, peer_committed: int,
                             dst: Optional[str]) -> None:
        """Catch a lagging peer up with committed epochs (OP_COMMIT —
        these are decided values, not a proposal)."""
        if dst is None or peer_committed >= self.osdmap.epoch:
            return
        from ..osdmap.encoding import incremental_to_dict
        deltas = [incremental_to_dict(i) for i in self.incrementals
                  if i.epoch > peer_committed]
        self.messenger.send_message(MMonPaxos(
            op=MMonPaxos.OP_COMMIT, rank=self.rank,
            pn=self.election_epoch,
            last_committed=self.osdmap.epoch, values=deltas), dst)

    def _finish_collect(self) -> None:
        """A majority answered the collect: finish any surfaced
        uncommitted value whose round is still undecided by re-proposing
        it under our proposal number (Paxos.cc begin after collect)."""
        cu = self._collect_uncommitted
        self._collect_uncommitted = None
        if cu is None:
            return
        if cu[3]:
            # our own demoted topology proposal mutated the working map
            # in place; revert to the committed history first — if the
            # value still wins, the commit below re-applies it cleanly
            self._rebuild_from_incrementals()
        if cu[1] == self.osdmap.epoch + 1:
            from ..osdmap.encoding import incremental_from_dict
            inc = incremental_from_dict(cu[2])
            self._propose(inc, topology=False)

    # ---- proposal machinery (leader) --------------------------------------
    def _propose(self, inc: Incremental, topology: bool) -> None:
        self._pending_proposals.append({"inc": inc,
                                        "topology": topology})
        self._try_begin()

    def _try_begin(self) -> None:
        from ..osdmap.encoding import incremental_to_dict
        if self._inflight is not None or not self._pending_proposals:
            return
        p = self._pending_proposals.pop(0)
        epoch = self.osdmap.epoch + 1
        p["inc"].epoch = epoch
        if self._pending_log:
            # queued clog entries ride whatever epoch commits next
            # (LogMonitor batching onto the shared paxos round)
            p["inc"].service_log = list(p["inc"].service_log) + \
                self._pending_log
            self._pending_log = []
        d = incremental_to_dict(p["inc"])
        self._inflight = {"pn": self.election_epoch, "epoch": epoch,
                          "inc": p["inc"], "value": d,
                          "topology": p["topology"],
                          "accepts": {self.rank}}
        for r in self.quorum - {self.rank}:
            name = self._peer_name(r)
            if name:
                self.messenger.send_message(MMonPaxos(
                    op=MMonPaxos.OP_BEGIN, rank=self.rank,
                    pn=self.election_epoch,
                    last_committed=self.osdmap.epoch, values=[d]), name)
        self._maybe_commit()   # a self-quorum commits immediately

    def _maybe_commit(self) -> None:
        from ..osdmap.encoding import incremental_to_dict
        fl = self._inflight
        if fl is None or len(fl["accepts"]) < self._majority():
            return
        self._inflight = None
        inc = fl["inc"]
        if fl["topology"]:
            # the working map already holds the topology state (mutated
            # in place by create_*): commitment = the epoch bump, plus
            # any up/weight delta that was folded into the snapshot
            # (applied field-wise — apply_incremental would alias the
            # snapshot's crush/pool objects into the working map)
            from ..osdmap.osdmap import CEPH_OSD_EXISTS, CEPH_OSD_UP
            m = self.osdmap
            m.epoch = fl["epoch"]
            for osd, up in inc.new_up.items():
                st = m.osd_state[osd] | CEPH_OSD_EXISTS
                m.osd_state[osd] = \
                    (st | CEPH_OSD_UP) if up else (st & ~CEPH_OSD_UP)
            for osd, w in inc.new_weight.items():
                m.osd_state[osd] |= CEPH_OSD_EXISTS
                m.osd_weight[osd] = w
            for osd, a in inc.new_primary_affinity.items():
                m.set_primary_affinity(osd, a)
            for pg, osds in inc.new_pg_temp.items():
                if osds:
                    m.pg_temp[pg] = list(osds)
                else:
                    m.pg_temp.pop(pg, None)
            for pg, p in inc.new_primary_temp.items():
                if p >= 0:
                    m.primary_temp[pg] = p
                else:
                    m.primary_temp.pop(pg, None)
            for pg in inc.old_pg_upmap:
                m.pg_upmap.pop(pg, None)
            for pg in inc.old_pg_upmap_items:
                m.pg_upmap_items.pop(pg, None)
            m.pg_upmap.update(inc.new_pg_upmap)
            m.pg_upmap_items.update(inc.new_pg_upmap_items)
        else:
            self.osdmap.apply_incremental(inc)
        self.incrementals.append(inc)
        self._apply_service(inc)
        for r in self.quorum - {self.rank}:
            name = self._peer_name(r)
            if name:
                self.messenger.send_message(MMonPaxos(
                    op=MMonPaxos.OP_COMMIT, rank=self.rank,
                    pn=fl["pn"], last_committed=self.osdmap.epoch,
                    values=[fl["value"]]), name)
        for sub in self.subscribers:
            self.messenger.send_message(
                MOSDMap(first=inc.epoch, last=inc.epoch,
                        incrementals=[inc]), sub)
        self._try_begin()

    # ---- liveness (elector keepalives) ------------------------------------
    def tick(self, now: float) -> None:
        # Starvation compensation (Monitor.cc's clock-jump sanity on
        # the same check): when OUR OWN tick cadence stalled — an
        # oversubscribed host descheduled the process, a long pump —
        # the silence since the last tick measures local scheduling,
        # not peer death.  Comparing a grace window against it starts
        # spurious elections that churn quorum exactly when the box is
        # loaded (the two loadflaky vstart tests' election-timing
        # sensitivity; ROADMAP residual debt 2).  Credit every
        # liveness stamp with the stall so grace windows restart from
        # a tick cadence we actually sustained; a genuinely dead peer
        # still times out, one grace period of real ticks later.
        stall = (now - self._last_tick
                 if self._last_tick is not None else 0.0)
        self._last_tick = now
        if stall > MON_PING_GRACE / 2.0:
            # BOUNDED per silent stretch: at most two consecutive
            # stalls are compensated before the peer must actually
            # speak (any real ping/victory resets its ledger).  A
            # single long deschedule restarts the grace window in
            # full — no spurious election on wake — while a HOST that
            # stays slow against a genuinely dead peer stops earning
            # credit after two stalls, so failover is delayed by a
            # bounded amount, never postponed indefinitely.
            for r in self._last_peer_seen:
                n_stalls = self._grace_credit.get(r, 0)
                if n_stalls < 2:
                    self._grace_credit[r] = n_stalls + 1
                    self._last_peer_seen[r] = min(
                        now, self._last_peer_seen[r] + stall)
        if stall > MDS_BEACON_GRACE / 2.0:
            # same class of false positive, gated on ITS OWN grace
            # (mds_grace is configured independently of mon_grace): a
            # starved leader must not fail over a live MDS whose
            # beacons it never drained
            beacons = getattr(self, "_mds_last_beacon", {})
            for n in beacons:
                n_stalls = self._mds_grace_credit.get(n, 0)
                if n_stalls < 2:
                    self._mds_grace_credit[n] = n_stalls + 1
                    beacons[n] = min(now, beacons[n] + stall)
        self.now = now
        if self.is_leader() or not self.peers:
            # down->out eviction (OSDMonitor::tick down_pending_out)
            for osd, t0 in list(self._down_stamps.items()):
                if self.osdmap.is_up(osd) or \
                        self.osdmap.osd_weight[osd] == 0:
                    del self._down_stamps[osd]   # revived, or already out
                elif now - t0 >= self.down_out_interval:
                    del self._down_stamps[osd]
                    # remember the pre-out weight IN THE MAP so a later
                    # boot restores it on any leader, across failovers
                    # (osd_xinfo_t::old_weight, OSDMonitor::tick)
                    inc = Incremental()
                    inc.new_old_weight[osd] = self.osdmap.osd_weight[osd]
                    inc.new_weight[osd] = 0
                    self.log_entry("mon", "WRN",
                                   f"osd.{osd} marked out after "
                                   f"{self.down_out_interval:.0f}s down")
                    self.publish(inc)
            # clog entries with no epoch to ride commit on their own
            self.flush_log()
            self._check_mds_failover(now)
        if not self.peers:
            return
        for p in self.peers:
            self.messenger.send_message(MMonPing(
                op=MMonPing.PING, rank=self.rank, stamp=now), p)
        if self.leader_rank >= 0 and not self.is_leader():
            last = self._last_peer_seen.get(self.leader_rank, now)
            self._last_peer_seen.setdefault(self.leader_rank, now)
            if now - last > MON_PING_GRACE:
                self.start_election()
        elif self.is_leader() and len(self.quorum) > 1:
            # a leader losing quorum peons must re-elect (lease timeout,
            # Paxos::lease_timeout): a stale quorum would let a minority
            # keep committing
            for r in self.quorum - {self.rank}:
                last = self._last_peer_seen.get(r, now)
                self._last_peer_seen.setdefault(r, now)
                if now - last > MON_PING_GRACE:
                    self.start_election()
                    break
        elif self.leader_rank < 0:
            # election stalled (e.g. proposed to dead peers): retry —
            # but not while we just deferred to a lower rank whose
            # round is still in flight
            if now >= getattr(self, "_election_defer_until", 0.0):
                self.start_election()

    def _handle_mon_ping(self, msg: MMonPing) -> None:
        self._peer_ranks[msg.src] = msg.rank
        if msg.op == MMonPing.PING:
            self.messenger.send_message(MMonPing(
                op=MMonPing.REPLY, rank=self.rank, stamp=msg.stamp),
                msg.src)
        self._last_peer_seen[msg.rank] = self.now
        self._grace_credit.pop(msg.rank, None)
        # a LIVE mon pinging us while outside our quorum must be
        # brought back in (its election ack straggled past the window):
        # without this it never sees another BEGIN/COMMIT and its
        # committed history freezes (Monitor.cc quorum expand on
        # probe).  Damped: one rejoin election per grace period.
        if self.is_leader() and len(self.quorum) < self.n_mons() and \
                msg.rank not in self.quorum:
            last = getattr(self, "_last_rejoin_election", -1e9)
            if self.now - last > MON_PING_GRACE:
                self._last_rejoin_election = self.now
                self.start_election()

    # ---- cluster bootstrap -------------------------------------------------
    def bootstrap(self, n_osds: int, osds_per_host: int = 1) -> None:
        """Build the initial map: straw2 host tree, all osds up+in."""
        m = self.osdmap
        m.set_max_osd(n_osds)
        cw = m.crush
        cw.set_type_name(1, "host")
        cw.set_type_name(10, "root")
        hosts = []
        n_hosts = (n_osds + osds_per_host - 1) // osds_per_host
        for h in range(n_hosts):
            osds = list(range(h * osds_per_host,
                              min((h + 1) * osds_per_host, n_osds)))
            hid = cw.add_bucket(CRUSH_BUCKET_STRAW2, 1, f"host{h}", osds,
                                [0x10000] * len(osds), id=-(h + 2))
            hosts.append((hid, len(osds)))
        cw.add_bucket(CRUSH_BUCKET_STRAW2, 10, "default",
                      [h for h, _ in hosts],
                      [0x10000 * n for _, n in hosts], id=-1)
        for i in range(n_osds):
            m.set_osd(i, up=True, weight=CEPH_OSD_IN)
            cw.set_item_name(i, f"osd.{i}")
        self._topology_dirty = True

    def subscribe(self, name: str) -> None:
        if name not in self.subscribers:
            self.subscribers.append(name)

    def quorum_status(self) -> dict:
        """This mon's view of the election ('ceph quorum_status',
        mon/MonCommands.h): rank, election epoch (odd = electing, even
        = decided), leader rank (-1 mid-election) and quorum set."""
        return {"rank": self.rank,
                "election_epoch": self.election_epoch,
                "leader_rank": self.leader_rank,
                "is_leader": self.is_leader(),
                "quorum": sorted(self.quorum)}

    # ---- cluster log (LogMonitor, src/mon/LogMonitor.cc) -------------------
    def log_entry(self, who: str, level: str, message: str) -> None:
        """Queue a cluster-log entry; it commits with the next epoch
        (immediately if the log is the only pending state — see tick)."""
        self._pending_log.append((self.now, who, level, message))

    def flush_log(self) -> None:
        """Commit queued log entries on their own no-op epoch."""
        if self._pending_log and (not self.peers or
                                  (self.is_leader() and
                                   len(self.quorum) >= self._majority())):
            self.publish(Incremental())

    def log_last(self, n: int = 20, level: Optional[str] = None
                 ) -> List[Tuple[float, str, str, str]]:
        ents = self.cluster_log
        if level is not None:
            ents = [e for e in ents if e[2] == level]
        return ents[-n:]

    # ---- config-key store (ConfigKeyService, mon/ConfigKeyService.cc) ------
    def config_key_set(self, key: str, value: str) -> None:
        """Replicate a key-value pair through paxos (ceph config-key
        set).  Leader-only, like every other mutation."""
        inc = Incremental()
        inc.service_config_kv[key] = value
        self.publish(inc)

    def config_key_rm(self, key: str) -> None:
        inc = Incremental()
        inc.service_config_kv[key] = None
        self.publish(inc)

    def config_key_get(self, key: str) -> Optional[str]:
        return self.config_kv.get(key)

    def config_key_dump(self) -> Dict[str, str]:
        return dict(self.config_kv)

    # ---- fsmap (MDSMonitor role, src/mon/MDSMonitor.cc at lite scale) ------
    #
    # The map of MDS daemons and their states rides the replicated
    # config-key store (one paxos service reused, like LogMonitor): the
    # FIRST daemon to beacon becomes active, later ones stand by, and
    # an active whose beacons go stale is failed over to the
    # longest-waiting live standby.  Beacon liveness itself is
    # leader-local RAM — a new leader re-learns it from the next
    # beacons, restarting the grace window.
    def _fsmap(self) -> Dict:
        import json as _json
        raw = self.config_key_get("fsmap")
        fsmap = _json.loads(raw) if raw else {"mds": {}}
        fsmap.setdefault("max_mds", 1)
        # rank back-fill for maps persisted before multi-active: a
        # rankless active is rank 0
        for e in fsmap["mds"].values():
            if e.get("state") == "active":
                e.setdefault("rank", 0)
        return fsmap

    def _save_fsmap(self, fsmap: Dict) -> None:
        import json as _json
        self.config_key_set("fsmap", _json.dumps(fsmap,
                                                 sort_keys=True))

    @staticmethod
    def _fsmap_ranks(fsmap: Dict) -> Dict[int, str]:
        """rank -> holder name, actives only."""
        return {int(e["rank"]): n for n, e in fsmap["mds"].items()
                if e.get("state") == "active"
                and e.get("rank") is not None}

    def fs_status(self) -> Dict:
        """Read-only fsmap view ('ceph mds stat' / 'ceph fs status'):
        answerable by any mon — the fsmap is paxos-replicated.
        ``active`` is ordered by RANK (active[0] == rank 0, which is
        what pre-multi-active clients expect)."""
        fsmap = self._fsmap()
        ranks = self._fsmap_ranks(fsmap)
        active = [ranks[r] for r in sorted(ranks)]
        standby = sorted(n for n, e in fsmap["mds"].items()
                         if e["state"] == "standby")
        return {"mds": fsmap["mds"], "active": active,
                "standby": standby, "max_mds": fsmap["max_mds"],
                "ranks": {str(r): n for r, n in sorted(ranks.items())}}

    def fs_set_max_mds(self, n: int) -> Dict:
        """'ceph fs set <fs> max_mds <n>' (MDSMonitor::filesystem_set):
        grow the active-rank count; live standbys are promoted into
        the new ranks immediately.  Shrinking deactivates the excess
        ranks (their daemons see the fsmap and respawn as standby)."""
        n = int(n)
        if n < 1:
            raise ValueError("max_mds must be >= 1")
        fsmap = self._fsmap()
        fsmap["max_mds"] = n
        for name, e in sorted(fsmap["mds"].items()):
            if e.get("state") == "active" and e.get("rank", 0) >= n:
                fsmap["mds"][name] = {"state": "standby",
                                      "rank": None}
                self.log_entry("mon", "INF",
                               f"mds {name} deactivated "
                               f"(max_mds={n})")
        self._fill_ranks(fsmap)
        self._save_fsmap(fsmap)
        return {"max_mds": n}

    def _fill_ranks(self, fsmap: Dict) -> None:
        """Promote LIVE standbys into unheld ranks < max_mds
        (MDSMonitor::maybe_promote_standby)."""
        beacons = getattr(self, "_mds_last_beacon", {})
        held = set(self._fsmap_ranks(fsmap))
        for rank in range(fsmap["max_mds"]):
            if rank in held:
                continue
            live = sorted(
                (n for n, e in fsmap["mds"].items()
                 if e["state"] == "standby"
                 and self.now - beacons.get(n, -1e18)
                 <= MDS_BEACON_GRACE))
            if not live:
                continue
            pick = live[0]
            fsmap["mds"][pick] = {"state": "active", "rank": rank}
            held.add(rank)
            self.log_entry("mon", "INF",
                           f"mds {pick} is now active rank {rank}")

    def _handle_mds_beacon(self, msg: MMDSBeacon) -> None:
        if self.peers and not self.is_leader():
            name = self._peer_name(self.leader_rank) \
                if self.leader_rank >= 0 else None
            if name:
                self.messenger.send_message(MMDSBeacon(
                    name=msg.name, state=msg.state, seq=msg.seq), name)
            return
        if not hasattr(self, "_mds_last_beacon"):
            self._mds_last_beacon = {}
        self._mds_last_beacon[msg.name] = self.now
        self._mds_grace_credit.pop(msg.name, None)
        fsmap = self._fsmap()
        cur = fsmap["mds"].get(msg.name)
        if cur is not None and cur["state"] == "standby":
            # a known standby beaconing while ranks sit unheld (e.g.
            # it was momentarily stale when fs_set_max_mds ran): seat
            # it now — without this, nothing would ever re-run the
            # promotion for an idle-but-healthy standby
            held = self._fsmap_ranks(fsmap)
            if len(held) < fsmap["max_mds"]:
                self._fill_ranks(fsmap)
                if fsmap["mds"][msg.name]["state"] != "standby" or \
                        self._fsmap_ranks(fsmap) != held:
                    self._save_fsmap(fsmap)
            return
        if cur is None or cur["state"] == "failed":
            # new daemon — or a FAILED one beaconing again (restarted
            # after the grace window): it rejoins as standby and takes
            # any unheld rank (MDSMonitor re-admitting a formerly-
            # laggy daemon)
            fsmap["mds"][msg.name] = {"state": "standby",
                                      "rank": None}
            self._fill_ranks(fsmap)
            st = fsmap["mds"][msg.name]
            joined = f"active rank {st['rank']}" \
                if st["state"] == "active" else "standby"
            self.log_entry("mon", "INF",
                           f"mds {msg.name} joined as {joined}")
            self._save_fsmap(fsmap)

    def _check_mds_failover(self, now: float) -> None:
        """Leader tick: fail a silent active and promote a LIVE
        standby into ITS rank (MDSMonitor::tick beacon grace).
        Failover is per-rank: other actives are untouched."""
        beacons = getattr(self, "_mds_last_beacon", None)
        if not beacons:
            return
        fsmap = self._fsmap()
        changed = False
        for name, e in sorted(fsmap["mds"].items()):
            if e["state"] != "active":
                continue
            last = beacons.get(name, now)
            beacons.setdefault(name, now)
            if now - last <= MDS_BEACON_GRACE:
                continue
            rank = e.get("rank", 0)
            fsmap["mds"][name] = {"state": "failed", "rank": None}
            changed = True
            self.log_entry("mon", "WRN",
                           f"mds {name} (rank {rank}) failed")
        if changed:
            self._fill_ranks(fsmap)
            self._save_fsmap(fsmap)

    # ---- pools -------------------------------------------------------------
    def create_replicated_pool(self, name: str, size: int = 3,
                               pg_num: int = 32) -> int:
        rno = self.osdmap.crush.get_rule_id("replicated_rule")
        if rno < 0:
            rno = self.osdmap.crush.add_simple_rule(
                "replicated_rule", "default", "host", mode="firstn")
        pool = pg_pool_t(type=TYPE_REPLICATED, size=size,
                         min_size=max(1, size - 1), crush_rule=rno,
                         pg_num=pg_num, pgp_num=pg_num)
        self._topology_dirty = True
        self.log_entry("mon", "INF",
                       f"pool '{name}' created (replicated size={size})")
        return self.osdmap.add_pool(name, pool)

    def set_pool_pg_num(self, name: str, pg_num: int) -> None:
        """Grow a pool's pg_num (PG splitting; OSDMonitor 'osd pool set
        pg_num').  pgp_num is left alone so children colocate with
        their parents (placement uses pgp_num) — raise pgp_num
        afterwards to actually spread them, like the reference."""
        pid = self.osdmap.lookup_pg_pool_name(name)
        if pid < 0:
            raise KeyError(f"no pool named {name!r}")
        pool = self.osdmap.pools[pid]
        if pg_num < pool.pg_num:
            raise ValueError("pg_num can only grow (no PG merging)")
        pool.set_pg_num(pg_num)
        self._topology_dirty = True

    def set_pool_pgp_num(self, name: str, pgp_num: int) -> None:
        """Spread split children to their own CRUSH positions
        (OSDMonitor 'osd pool set pgp_num'); bounded by pg_num.

        Placement changes are PRIMED (OSDMonitor::maybe_prime_pg_temp):
        every PG whose acting set would move to different OSDs gets
        pg_temp pinned to its OLD acting, so the data-bearing members
        keep serving while the realign machinery copies shards to the
        new CRUSH positions and then drops the pin — without this, a
        PG remapped to entirely fresh OSDs has no acting member holding
        its data and reads go EIO forever."""
        from ..crush.constants import CRUSH_ITEM_NONE
        from ..osdmap import pg_t as _pg_t
        pid = self.osdmap.lookup_pg_pool_name(name)
        if pid < 0:
            raise KeyError(f"no pool named {name!r}")
        pool = self.osdmap.pools[pid]
        if pgp_num > pool.pg_num:
            raise ValueError("pgp_num cannot exceed pg_num")
        old_acting = {}
        for ps in range(pool.pg_num):
            pg = _pg_t(pid, ps)
            if pg not in self.osdmap.pg_temp:   # existing pins win
                old_acting[ps] = list(
                    self.osdmap.pg_to_up_acting_osds(pg)[2])
        pool.set_pgp_num(pgp_num)
        for ps, olda in old_acting.items():
            pg = _pg_t(pid, ps)
            newa = list(self.osdmap.pg_to_up_acting_osds(pg)[2])
            if newa != olda and \
                    any(o != CRUSH_ITEM_NONE for o in olda):
                self.osdmap.pg_temp[pg] = [int(o) for o in olda]
                self._primed_pg_temp[pg] = [int(o) for o in olda]
        self._topology_dirty = True

    def create_ec_profile(self, name: str, profile: Dict[str, str]) -> None:
        # instantiating validates the profile (OSDMonitor get_erasure_code)
        create_erasure_code(dict(profile))
        self.osdmap.erasure_code_profiles[name] = dict(profile)

    def create_ec_pool(self, name: str, profile_name: str,
                       pg_num: int = 32,
                       ec_overwrites: bool = True) -> int:
        profile = self.osdmap.erasure_code_profiles[profile_name]
        ec = create_erasure_code(dict(profile))
        rule_name = f"{name}_rule"
        rno = ec.create_rule(rule_name, self.osdmap.crush)
        if rno < 0:
            raise RuntimeError(f"create_rule failed: {rno}")
        k = ec.get_data_chunk_count()
        stripe_unit = int(profile.get("stripe_unit", DEFAULT_STRIPE_UNIT))
        stripe_width = k * stripe_unit
        psw = getattr(ec, "preferred_stripe_width", None)
        if psw is not None:
            # codec-geometry pools (regenerating codes): the plugin
            # dictates the stripe width (one message matrix per stripe)
            stripe_width = psw()
        from ..osdmap.types import FLAG_EC_OVERWRITES, FLAG_HASHPSPOOL
        flags = FLAG_HASHPSPOOL | (FLAG_EC_OVERWRITES if ec_overwrites
                                   else 0)
        pool = pg_pool_t(type=TYPE_ERASURE, size=ec.get_chunk_count(),
                         min_size=k + 1, crush_rule=rno,
                         pg_num=pg_num, pgp_num=pg_num,
                         erasure_code_profile=profile_name,
                         stripe_width=stripe_width, flags=flags)
        self._topology_dirty = True
        self.log_entry("mon", "INF",
                       f"pool '{name}' created (erasure "
                       f"profile={profile_name})")
        return self.osdmap.add_pool(name, pool)

    # ---- cache tiering (OSDMonitor "osd tier add/cache-mode") --------------
    def add_cache_tier(self, base_name: str, cache_name: str,
                       mode: str = "writeback",
                       hit_set_period: float = 60.0,
                       hit_set_count: int = 4,
                       target_max_objects: int = 0) -> None:
        """Overlay *cache_name* (replicated) on *base_name*: clients
        redirect to the cache; the cache PGs promote/flush/evict
        (OSDMonitor::prepare_command 'osd tier add' + 'cache-mode' +
        'set-overlay')."""
        base_id = self.osdmap.lookup_pg_pool_name(base_name)
        cache_id = self.osdmap.lookup_pg_pool_name(cache_name)
        if base_id < 0 or cache_id < 0:
            raise KeyError("unknown pool")
        cache = self.osdmap.pools[cache_id]
        if cache.type != TYPE_REPLICATED:
            raise ValueError("cache tier pool must be replicated")
        if mode != "writeback":
            raise ValueError("only writeback cache-mode is implemented")
        cache.tier_of = base_id
        cache.cache_mode = mode
        cache.hit_set_period = hit_set_period
        cache.hit_set_count = hit_set_count
        cache.target_max_objects = target_max_objects
        base = self.osdmap.pools[base_id]
        base.read_tier = cache_id
        base.write_tier = cache_id
        self._topology_dirty = True

    def remove_cache_tier(self, base_name: str) -> None:
        base_id = self.osdmap.lookup_pg_pool_name(base_name)
        base = self.osdmap.pools[base_id]
        if base.read_tier >= 0:
            cache = self.osdmap.pools.get(base.read_tier)
            if cache is not None:
                cache.tier_of = -1
                cache.cache_mode = ""
        base.read_tier = -1
        base.write_tier = -1
        self._topology_dirty = True

    # ---- pool snapshots (OSDMonitor pool mksnap/rmsnap) --------------------
    def pool_snap_create(self, pool_name: str, snap_name: str) -> int:
        """Allocate the next snap id on the pool; publish via the next
        epoch (pg_pool_t::add_snap role)."""
        pid = self.osdmap.lookup_pg_pool_name(pool_name)
        if pid < 0:
            raise KeyError(f"no pool {pool_name!r}")
        pool = self.osdmap.pools[pid]
        if pool.selfmanaged:
            raise ValueError(
                f"pool {pool_name!r} is in selfmanaged snap mode")
        if snap_name in pool.snaps.values():
            raise ValueError(f"snap {snap_name!r} exists")
        sid = pool.snap_seq + 1
        pool.snaps[sid] = snap_name
        pool.snap_seq = sid
        self._topology_dirty = True
        return sid

    def pool_snap_rm(self, pool_name: str, snap_name: str) -> int:
        pid = self.osdmap.lookup_pg_pool_name(pool_name)
        if pid < 0:
            raise KeyError(f"no pool {pool_name!r}")
        pool = self.osdmap.pools[pid]
        for sid, n in list(pool.snaps.items()):
            if n == snap_name:
                del pool.snaps[sid]
                pool.removed_snaps.append(sid)
                self._topology_dirty = True
                return sid
        raise KeyError(f"no snap {snap_name!r} on {pool_name!r}")

    # ---- self-managed snaps (OSDMonitor "osd pool mksnap" unmanaged twin:
    # librados selfmanaged_snap_create/remove -> mon snapid allocation;
    # pg_pool_t::add_unmanaged_snap, src/osd/osd_types.cc) ------------------
    def selfmanaged_snap_create(self, pool_name: str) -> int:
        """Allocate the next snap id; the snapshot itself lives only in
        the client's SnapContext.  Commits the pool to selfmanaged mode."""
        pid = self.osdmap.lookup_pg_pool_name(pool_name)
        if pid < 0:
            raise KeyError(f"no pool {pool_name!r}")
        pool = self.osdmap.pools[pid]
        if pool.snaps:
            raise ValueError(
                f"pool {pool_name!r} already has pool snapshots")
        pool.selfmanaged = True
        sid = pool.snap_seq + 1
        pool.snap_seq = sid
        self._topology_dirty = True
        return sid

    def selfmanaged_snap_remove(self, pool_name: str, snapid: int) -> None:
        """Mark an allocated id removed so PGs trim its clones."""
        pid = self.osdmap.lookup_pg_pool_name(pool_name)
        if pid < 0:
            raise KeyError(f"no pool {pool_name!r}")
        pool = self.osdmap.pools[pid]
        if not pool.selfmanaged:
            # retiring a live pool-mode snapshot id here would corrupt
            # it (the reference returns EINVAL unless the pool is in
            # unmanaged snaps mode, pg_pool_t::remove_unmanaged_snap)
            raise ValueError(
                f"pool {pool_name!r} is not in selfmanaged snap mode")
        if not (0 < snapid <= pool.snap_seq):
            raise KeyError(f"snap id {snapid} never allocated")
        if snapid not in pool.removed_snaps:
            pool.removed_snaps.append(snapid)
            self._topology_dirty = True

    # ---- pool deletion (OSDMonitor "osd pool delete") ---------------------
    def delete_pool(self, pool_name: str) -> int:
        """Remove a pool from the map; OSDs purge its PGs and data on
        consuming the epoch (OSD 'PG removed' / PG::on_removal).  A
        pool participating in a cache tier must be detached first,
        like the reference refuses (EBUSY)."""
        pid = self.osdmap.lookup_pg_pool_name(pool_name)
        if pid < 0:
            raise KeyError(f"no pool {pool_name!r}")
        pool = self.osdmap.pools[pid]
        if pool.tier_of >= 0 or pool.read_tier >= 0:
            raise ValueError(
                f"pool {pool_name!r} is part of a cache tier")
        del self.osdmap.pools[pid]
        del self.osdmap.pool_name[pid]
        if not hasattr(self, "_pending_pool_deletes"):
            self._pending_pool_deletes = []
        self._pending_pool_deletes.append(pid)
        self._topology_dirty = True
        return pid

    # ---- pool quotas + full flags (OSDMonitor "osd pool set-quota",
    # "osd set full"; flag values from osd_types.h:1148-1158) --------------
    def set_pool_quota(self, pool_name: str, max_objects: int = 0,
                       max_bytes: int = 0) -> None:
        pid = self.osdmap.lookup_pg_pool_name(pool_name)
        if pid < 0:
            raise KeyError(f"no pool {pool_name!r}")
        pool = self.osdmap.pools[pid]
        pool.quota_max_objects = int(max_objects)
        pool.quota_max_bytes = int(max_bytes)
        self._topology_dirty = True

    def set_pool_flags(self, pool_id: int, set_mask: int = 0,
                       clear_mask: int = 0) -> bool:
        """Set/clear pg_pool_t flags (the mgr drives FULL_QUOTA from
        usage); returns whether anything changed."""
        pool = self.osdmap.pools.get(pool_id)
        if pool is None:
            return False
        new = (pool.flags | set_mask) & ~clear_mask
        if new == pool.flags:
            return False
        pool.flags = new
        self._topology_dirty = True
        return True

    def set_cluster_flags(self, set_mask: int = 0,
                          clear_mask: int = 0) -> bool:
        """Cluster-wide CEPH_OSDMAP_* flags (full/nearfull/pausewr)."""
        new = (self.osdmap.flags | set_mask) & ~clear_mask
        if new == self.osdmap.flags:
            return False
        self.osdmap.flags = new
        self._topology_dirty = True
        return True

    def _maybe_remove_pg_upmaps(self) -> None:
        """Drop upmap entries that reference deleted pools or
        nonexistent OSDs (OSDMonitor::maybe_remove_pg_upmaps) — stale
        entries would silently distort placement forever."""
        m = self.osdmap

        def stale(pg, osds) -> bool:
            if pg.pool not in m.pools or pg.ps >= m.pools[pg.pool].pg_num:
                return True
            return any(o >= m.max_osd or not m.exists(o) for o in osds)

        for pg in [pg for pg, v in m.pg_upmap.items() if stale(pg, v)]:
            del m.pg_upmap[pg]
            self._topology_dirty = True
        for pg in [pg for pg, v in m.pg_upmap_items.items()
                   if stale(pg, [o for pair in v for o in pair])]:
            del m.pg_upmap_items[pg]
            self._topology_dirty = True
        for store in (m.pg_temp, m.primary_temp):
            for pg in [pg for pg in store if pg.pool not in m.pools]:
                del store[pg]
                self._topology_dirty = True

    # ---- wire commands (MMonCommand -> handle_command, the
    # 'ceph tell mon' / librados mon_command surface) ----------------------
    def _handle_command(self, msg) -> None:
        from ..msg.messages import MMonCommand, MMonCommandAck
        # ack cache: a lossy client link may replay the same command
        # tid after a dropped ack — non-idempotent commands (snap id
        # allocation!) must not run twice (the reference's mon session
        # dedups by (client, tid) the same way).  Keyed by the ORIGIN
        # client, which for a peon-relayed command is reply_to, so a
        # replay arriving by a different route still dedups.
        from collections import OrderedDict
        cache = getattr(self, "_cmd_ack_cache", None)
        if cache is None:
            cache = self._cmd_ack_cache = OrderedDict()
        origin = msg.reply_to or msg.src
        key = (origin, msg.tid)
        hit = cache.get(key)
        if hit is not None:
            cache.move_to_end(key)
            self.messenger.send_message(MMonCommandAck(
                tid=hit.tid, result=hit.result, data=hit.data,
                reply_to=msg.reply_to), msg.src)
            return

        def reply(result: int, data: dict, cacheable: bool) -> None:
            ack = MMonCommandAck(tid=msg.tid, result=result, data=data,
                                 reply_to=msg.reply_to)
            if cacheable:
                # bounded LRU: evict the coldest single entries instead
                # of a wholesale clear (which would discard live acks
                # and let a delayed replay re-run a non-idempotent
                # command).  LRU also ages out an entry whose (client,
                # tid) could collide after a client restart resets tids.
                cache[key] = ack
                cache.move_to_end(key)
                while len(cache) > 1024:
                    cache.popitem(last=False)
            self.messenger.send_message(ack, msg.src)

        # read-only commands: no mutation, no publish, answerable on
        # ANY mon from replicated state — handled before the leader
        # relay so a client bound to a peon gets its answer even
        # mid-election
        if msg.cmd == "fs_status":
            reply(0, {"value": self.fs_status()}, cacheable=False)
            return
        if msg.cmd == "quorum_status":
            # election/quorum introspection ('ceph quorum_status'):
            # answerable mid-election on any mon, never relayed — the
            # vstart tests poll it to wait for a NEW leader after a
            # SIGKILL instead of guessing with fixed pump counts
            reply(0, {"value": self.quorum_status()}, cacheable=False)
            return

        # peons never mutate: relay to the leader (Monitor::
        # forward_request_leader, src/mon/Monitor.cc) and let the ack
        # route back through us.  A mutation here would diverge this
        # mon's working map from quorum AND publish() would refuse.
        if self.peers and not self.is_leader():
            leader = (self._peer_name(self.leader_rank)
                      if self.leader_rank >= 0 else None)
            if leader is None or msg.reply_to:
                # electing, or a stale forward that landed on a non-
                # leader: transient — tell the client to retry (-EAGAIN,
                # never cached so the retry re-resolves the leader)
                reply(-11, {"error": "mon not quorum leader"},
                      cacheable=False)
                return
            self.messenger.send_message(MMonCommand(
                tid=msg.tid, cmd=msg.cmd, args=dict(msg.args),
                reply_to=origin), leader)
            return

        allowed = {"pool_snap_create", "pool_snap_rm",
                   "selfmanaged_snap_create", "selfmanaged_snap_remove",
                   "set_pool_quota", "create_replicated_pool",
                   "create_ec_profile", "create_ec_pool",
                   "delete_pool", "fs_set_max_mds"}
        if msg.cmd not in allowed:
            reply(-22, {"error": f"unknown command {msg.cmd!r}"},
                  cacheable=True)
            return
        try:
            value = getattr(self, msg.cmd)(**msg.args)
        except (KeyError, ValueError, TypeError, RuntimeError) as e:
            # the command's own failure is permanent: cache it so a
            # replay gets the same answer instead of re-executing
            reply(-22, {"error": str(e)}, cacheable=True)
            return
        try:
            self.publish()
        except RuntimeError as e:
            # lost leadership between the check above and publish():
            # the local mutation will be rebuilt from committed history
            # on the next election; the client must retry at the new
            # leader.  Not cached — the retry must re-execute there.
            # (Scoped to publish() alone: a RuntimeError raised by the
            # command itself is a real error, not a leadership signal.)
            reply(-11, {"error": f"leadership lost: {e}"},
                  cacheable=False)
            return
        reply(0, {"value": value}, cacheable=True)

    def _relay_command_ack(self, msg) -> None:
        """Ack for a command this peon forwarded to the leader: route it
        to the waiting client (Monitor::route_message role)."""
        from ..msg.messages import MMonCommandAck
        if msg.reply_to:
            self.messenger.send_message(MMonCommandAck(
                tid=msg.tid, result=msg.result, data=msg.data),
                msg.reply_to)

    # ---- epoch publication -------------------------------------------------
    def _snapshot_inc(self) -> Incremental:
        """Full-state Incremental (crush/pools/osd states deep-copied so
        later mon mutations can't leak into published epochs)."""
        m = self.osdmap
        inc = Incremental()
        inc.new_flags = m.flags
        # full-state incs only REPLACE listed pools on consumers;
        # deletions must travel explicitly.  Filter against the WORKING
        # map: a paxos demotion can rebuild it from committed history
        # and resurrect a pool whose delete never got quorum — shipping
        # that stale pid would purge a live pool's data on every OSD
        # (pids are never reused, so absence == genuinely deleted)
        inc.old_pools = [pid for pid in
                         getattr(self, "_pending_pool_deletes", [])
                         if pid not in m.pools]
        self._pending_pool_deletes = []
        inc.crush = copy.deepcopy(m.crush)
        inc.new_pools = copy.deepcopy(m.pools)
        inc.new_pool_names = dict(m.pool_name)
        inc.new_max_osd = m.max_osd
        for o in range(m.max_osd):
            inc.new_up[o] = m.is_up(o)
            inc.new_weight[o] = m.osd_weight[o]
            inc.new_old_weight[o] = m.osd_old_weight.get(o, 0)
        inc.new_erasure_code_profiles = copy.deepcopy(
            m.erasure_code_profiles)
        return inc

    def publish(self, inc: Optional[Incremental] = None) -> None:
        """Commit a new epoch and broadcast it (mon → MOSDMap).

        Topology changes (crush/pools) publish as a full-state snapshot
        Incremental; osd up/weight deltas publish as true diffs which the
        mon also applies to its own map.

        Multi-mon: only the quorum leader may commit — a partitioned
        minority mutating its private map would diverge from the quorum
        (real paxos makes this impossible; we make it loud).
        """
        if self.peers and (not self.is_leader()
                           or len(self.quorum) < self._majority()):
            raise RuntimeError(
                f"{self.name}: not the quorum leader "
                f"(leader_rank={self.leader_rank}, quorum={self.quorum})")
        if self._topology_dirty:
            self._maybe_remove_pg_upmaps()
            delta = inc
            inc = self._snapshot_inc()
            # the snapshot reads the WORKING map, which does not yet
            # reflect deferred (in-flight/queued) delta proposals that
            # will commit before this epoch — fold their overrides in,
            # or the snapshot would silently revert them at commit
            deferred = ([self._inflight["inc"]] if self._inflight
                        else []) + \
                [p["inc"] for p in self._pending_proposals]
            for src in deferred + ([delta] if delta is not None else []):
                inc.new_up.update(src.new_up)
                inc.new_weight.update(src.new_weight)
                inc.new_old_weight.update(src.new_old_weight)
                inc.new_primary_affinity.update(src.new_primary_affinity)
                inc.new_pg_temp.update(src.new_pg_temp)
                inc.new_primary_temp.update(src.new_primary_temp)
                inc.new_pg_upmap.update(src.new_pg_upmap)
                inc.new_pg_upmap_items.update(src.new_pg_upmap_items)
                inc.old_pg_upmap.extend(src.old_pg_upmap)
                inc.old_pg_upmap_items.extend(src.old_pg_upmap_items)
            if self._primed_pg_temp:
                inc.new_pg_temp.update(self._primed_pg_temp)
                self._primed_pg_temp = {}
            if delta is not None:
                # service payloads fold from the DIRECT delta only:
                # deferred proposals commit on their own, and unlike
                # the idempotent map-field folding above, log entries
                # and kv mutations must apply exactly once
                inc.service_log.extend(delta.service_log)
                inc.service_config_kv.update(delta.service_config_kv)
            self._topology_dirty = False
            topology = True
        else:
            inc = inc if inc is not None else Incremental()
            topology = False
        # commitment is deferred to the accept quorum: a single mon (its
        # own majority) commits inline, a multi-mon cluster commits when
        # the peon ACCEPTs drain (the next network pump)
        self._propose(inc, topology)

    def send_full_map(self, dst: str) -> None:
        self.messenger.send_message(
            MOSDMap(first=1, last=self.osdmap.epoch,
                    incrementals=list(self.incrementals)), dst)

    # ---- osd state changes -------------------------------------------------
    def mark_osd_down(self, osd: int) -> None:
        inc = Incremental()
        inc.new_up[osd] = False
        # a down osd's past failure reports no longer count
        reporter = f"osd.{osd}"
        for reps in self._failure_reports.values():
            reps.discard(reporter)
        self._down_stamps.setdefault(osd, self.now)
        self.log_entry("mon", "WRN", f"osd.{osd} marked down")
        g_journal.emit(self.name, "osd_down", osd=osd)
        self.publish(inc)

    def mark_osd_up(self, osd: int) -> None:
        inc = Incremental()
        inc.new_up[osd] = True
        # a boot reverses an AUTOMATIC out (operator outs stay out):
        # mon_osd_auto_mark_auto_out_in, OSDMonitor::prepare_boot.
        # The memo rides the replicated map, so any leader can restore
        old_w = self.osdmap.osd_old_weight.get(osd)
        if old_w:
            if self.osdmap.osd_weight[osd] == 0:
                inc.new_weight[osd] = old_w
            inc.new_old_weight[osd] = 0
        # recovery voids any partial reports against this osd
        self._failure_reports.pop(osd, None)
        self._down_stamps.pop(osd, None)
        self.log_entry("mon", "INF", f"osd.{osd} boot")
        g_journal.emit(self.name, "osd_up", osd=osd)
        self.publish(inc)

    def mark_osd_out(self, osd: int) -> None:
        inc = Incremental()
        inc.new_weight[osd] = 0
        cur = self.osdmap.osd_weight[osd] \
            if osd < len(self.osdmap.osd_weight) else 0
        if 0 < cur < CEPH_OSD_IN:
            # memo a reweight override so a later 'in' restores it
            # (osd_xinfo_t::old_weight, OSDMonitor operator out/in)
            inc.new_old_weight[osd] = cur
        g_journal.emit(self.name, "osd_out", osd=osd)
        self.publish(inc)

    def handle_pg_temp(self, msg: MOSDPGTemp) -> None:
        """OSDMonitor pg_temp handling: pin/clear the PG's acting set
        (OSDMonitor::preprocess_pgtemp role)."""
        from ..osdmap import pg_t as _pg_t
        pg = _pg_t(msg.pgid[0], msg.pgid[1])
        want = [int(o) for o in msg.temp]
        cur = self.osdmap.pg_temp.get(pg, [])
        if want == list(cur):
            return
        inc = Incremental()
        inc.new_pg_temp[pg] = want      # [] clears the pin
        self.publish(inc)

    def mark_osd_in(self, osd: int) -> None:
        inc = Incremental()
        old = self.osdmap.osd_old_weight.get(osd, 0)
        inc.new_weight[osd] = old if old > 0 else CEPH_OSD_IN
        if old:
            inc.new_old_weight[osd] = 0      # memo consumed
        g_journal.emit(self.name, "osd_in", osd=osd)
        self.publish(inc)

    # ---- durability (mon store, src/mon/MonitorDBStore.h role) -------------
    def save(self, path: str) -> None:
        """Persist the authoritative map + full epoch history to a JSON
        file (the mon store: resume = load + replay)."""
        import json
        import os as _os
        state = mon_store_state(self.osdmap, self.incrementals,
                                self.monmap)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
        _os.replace(tmp, path)

    def load(self, path: str) -> None:
        import json
        from ..osdmap.encoding import incremental_from_dict, \
            osdmap_from_dict
        with open(path) as f:
            state = json.load(f)
        self.osdmap = osdmap_from_dict(state["osdmap"])
        self.incrementals = [incremental_from_dict(i)
                             for i in state["incrementals"]]
        if "monmap" in state:
            from .monmap import MonMap
            self.monmap = MonMap.from_bytes(
                state["monmap"].encode("latin1"))
        self.cluster_log = []
        self.config_kv = {}
        for inc in self.incrementals:
            self._apply_service(inc)
        self._topology_dirty = False

    # ---- dispatch ----------------------------------------------------------
    def min_down_reporters(self) -> int:
        n_up = sum(1 for o in range(self.osdmap.max_osd)
                   if self.osdmap.is_up(o))
        return 2 if n_up > 2 else 1

    def ms_fast_dispatch(self, msg: Message) -> None:
        from ..msg.messages import MMonCommand, MMonCommandAck
        if isinstance(msg, MMonSubscribe):
            # cross-process clients/daemons subscribe over the wire
            # (the in-process ones call subscribe() directly)
            self.subscribe(msg.src)
            self.send_full_map(msg.src)
        elif isinstance(msg, MMonCommand):
            self._handle_command(msg)
        elif isinstance(msg, MMonCommandAck):
            self._relay_command_ack(msg)
        elif isinstance(msg, MMonElection):
            self._handle_election(msg)
        elif isinstance(msg, MMonPaxos):
            self._handle_paxos(msg)
        elif isinstance(msg, MMonPing):
            self._handle_mon_ping(msg)
        elif isinstance(msg, MMDSBeacon):
            self._handle_mds_beacon(msg)
        elif isinstance(msg, MOSDPGTemp):
            if self.is_leader() or not self.peers:
                self.handle_pg_temp(msg)
            elif self.is_peon():
                name = self._peer_name(self.leader_rank)
                if name:
                    self.messenger.send_message(MOSDPGTemp(
                        pgid=msg.pgid, epoch=msg.epoch,
                        temp=list(msg.temp)), name)
        elif isinstance(msg, MOSDBoot):
            # a live osd the map calls down asks back in
            # (OSDMonitor::preprocess_boot/prepare_boot)
            if self.is_leader() or not self.peers:
                if 0 <= msg.osd < self.osdmap.max_osd and \
                        not self.osdmap.is_up(msg.osd):
                    self.mark_osd_up(msg.osd)
            elif self.is_peon():
                name = self._peer_name(self.leader_rank)
                if name:
                    self.messenger.send_message(MOSDBoot(
                        osd=msg.osd, epoch=msg.epoch), name)
        elif isinstance(msg, MLog):
            # daemons' clog entries: the leader queues (committed with
            # the next epoch / tick flush); peons forward.  Daemons
            # broadcast to every mon so the entry survives any single
            # mon death — the leader therefore sees the same entry
            # several times (direct + forwarded) and dedups by its
            # (stamp, who, level, message) identity
            if self.is_leader() or not self.peers:
                stamp = msg.stamp if msg.stamp >= 0 else self.now
                ent = (stamp, msg.who or msg.src,
                       msg.level, msg.message)
                if ent not in self._recent_log_keys:
                    if len(self._recent_log_keys) > 512:
                        # rolling reset — but keep the entry being
                        # admitted, or its own in-flight forwarded
                        # duplicates would slip past the dedup
                        self._recent_log_keys.clear()
                    self._recent_log_keys.add(ent)
                    self._pending_log.append(ent)
            elif self.is_peon():
                name = self._peer_name(self.leader_rank)
                if name:
                    self.messenger.send_message(MLog(
                        who=msg.who or msg.src, level=msg.level,
                        message=msg.message, stamp=msg.stamp), name)
        elif isinstance(msg, MOSDFailure):
            if not self.is_leader():
                # peons forward to the leader (Monitor::forward_request);
                # a mon mid-election drops the report — OSDs re-send
                # every tick, so the eventual leader still hears it
                if self.is_peon():
                    name = self._peer_name(self.leader_rank)
                    if name:
                        self.messenger.send_message(MOSDFailure(
                            target_osd=msg.target_osd,
                            failed_since=msg.failed_since,
                            epoch=msg.epoch,
                            reporter=msg.reporter or msg.src), name)
                return
            # OSDMonitor::check_failure quorum: distinct reporters must
            # agree before the mark (mon_osd_min_down_reporters)
            if not self.osdmap.is_up(msg.target_osd):
                return
            reporters = self._failure_reports.setdefault(
                msg.target_osd, set())
            reporters.add(msg.reporter or msg.src)
            if len(reporters) >= self.min_down_reporters():
                del self._failure_reports[msg.target_osd]
                self.mark_osd_down(msg.target_osd)


def mon_store_state(osdmap, incrementals, monmap) -> dict:
    """The mon store's on-disk shape — ONE writer definition shared by
    Monitor.save and the DR rebuild (tools/rebuild_mondb.py), so the
    two can never drift; Monitor.load is the reader."""
    from ..osdmap.encoding import incremental_to_dict, osdmap_to_dict
    return {
        "osdmap": osdmap_to_dict(osdmap),
        "incrementals": [incremental_to_dict(i) for i in incrementals],
        "monmap": monmap.to_bytes().decode("latin1"),
    }
