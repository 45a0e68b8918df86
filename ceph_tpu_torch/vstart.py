"""vstart-lite: a REAL multi-process cluster on localhost TCP sockets.

The reference's integration tier runs mon/mgr/osd daemons as separate
processes on localhost ports (src/vstart.sh;
qa/standalone/ceph-helpers.sh run_mon/run_osd) and thrashes them with
kill -9 (qa/tasks/ceph_manager.py:195 kill_osd).  This module is that
tier for the port: ``python -m ceph_tpu_torch.vstart mon|osd ...``
daemon entrypoints over the TCP messenger (msg/tcp.py), plus a
``ProcessCluster`` harness that spawns one mon process and N OSD
processes, hands out wire-connected clients, and SIGKILLs daemons.

Every byte — client ops, EC sub-writes, peering queries, heartbeats,
failure reports, map publications — crosses real process boundaries
through the framed wire codec; nothing shortcuts through shared memory.

The port's own copy of ``ceph_tpu/vstart.py``.  Each OSD process runs
its pool's erasure code itself, on the card unless it is started with
``--device cpu`` (``ProcessCluster(device="cpu")``); the pool's profile
must then say ``backend=host``.  With ``--device cuda`` the OSD opens the
card and loads K1's library before it reports READY, and
``ProcessCluster`` builds K1 once in the parent before it spawns any
daemon.  An MDS process (``mds``, ``ProcessCluster(n_mds=...)``) codes
nothing and never opens the card.
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


DEVICES = ("cuda", "cpu")


def _daemon_start() -> None:
    """Arm the lock-order witness as the reference's vstart.sh runs
    every daemon with lockdep=1 (CEPH_TPU_LOCKDEP=0 opts a run out), and
    give the daemon's host tensor work one intra-op thread: the daemons
    of a cluster share one host, and with torch's default pool (a
    thread per core) in each of them a 30 KB host decode in an OSD took
    80 ms instead of 2-5 ms on an 8-core host (6 OSDs and a mon)."""
    import torch
    torch.set_num_threads(1)
    if os.environ.get("CEPH_TPU_LOCKDEP", "1") != "0":
        from .common.lockdep import lockdep_enable
        lockdep_enable(True)


def _open_device(device: str) -> None:
    """Before an OSD serves: with ``cuda``, create the CUDA context and
    load K1's library, so the first write does not stall the single-
    threaded daemon loop past its peers' heartbeat grace.  A missing
    card or a failed build raises.  With ``cpu`` nothing touches CUDA."""
    if device == "cpu":
        return
    import torch

    from .ops import _build, gf_pallas
    from .ops.gf_matmul import resolve_device
    dev = resolve_device(device)
    torch.zeros(1, device=dev)
    # lint: allow[no-untracked-sync] one-shot: the new context is ready
    torch.cuda.synchronize(dev)
    _build.load("gf_bit_matmul", gf_pallas._SIGNATURES)


# ---- daemon mains ----------------------------------------------------------

def mon_main(args) -> None:
    """Monitor daemon: bootstrap the map, create the requested pool,
    serve subscriptions/failure reports forever.

    Multi-mon (--peers): rank 0 bootstraps, wins the initial election
    (lowest rank, Elector.cc), commits the initial epochs through paxos
    and only then reports READY; peons serve elections/replication from
    boot.  Any mon may later lead — all of them register the osd
    subscriptions so a post-failover leader publishes to everyone."""
    _daemon_start()
    from .mon import Monitor
    from .mon import monitor as monitor_mod
    from .msg.tcp import TcpNetwork

    directory = json.loads(args.directory)
    peers = [p for p in args.peers.split(",") if p]
    auth = None
    if args.keyring:
        from .msg.tcp import TcpAuth
        auth = TcpAuth(args.name, args.keyring, kdc=True,
                       quorum=tuple(sorted({args.name, *peers}))
                       if peers else ())
    net = TcpNetwork(("127.0.0.1", args.port),
                     {k: tuple(v) for k, v in directory.items()},
                     auth=auth, entity=args.name)
    if args.mon_grace:
        monitor_mod.MON_PING_GRACE = args.mon_grace
    if args.mds_grace:
        monitor_mod.MDS_BEACON_GRACE = args.mds_grace
    # real addresses -> a real MonMap (the roster as a first-class
    # epoched map, not just config; mon/MonMap.h role)
    import uuid as _uuid

    from .mon.monmap import MonMap
    roster = sorted({args.name, *peers})
    addrs = {n: directory.get(n, ("127.0.0.1", 0)) for n in roster}
    # deterministic over the roster+addresses: every mon process of
    # this cluster computes the SAME fsid
    monmap = MonMap(fsid=str(_uuid.uuid5(
        _uuid.NAMESPACE_URL, "ceph-tpu://" + ",".join(
            f"{n}={h}:{p}" for n, (h, p) in sorted(addrs.items())))))
    monmap.epoch = 1
    for n, (host, port) in addrs.items():
        monmap.add(n, f"{host}:{port}/0")
    mon = Monitor(net, name=args.name, rank=args.rank, peers=peers,
                  monmap=monmap)
    if args.down_out_interval:
        mon.down_out_interval = args.down_out_interval
    for i in range(args.n_osds):
        mon.subscribe(f"osd.{i}")
    if args.rank == 0 and not args.rejoin:
        mon.bootstrap(args.n_osds, osds_per_host=1)
        if peers:
            # win the initial election and seat the full quorum before
            # committing anything (peons were spawned first)
            mon.start_election()
            deadline = time.monotonic() + 60.0
            while not (mon.is_leader()
                       and len(mon.quorum) == len(peers) + 1):
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"initial mon quorum never formed: "
                        f"ee={mon.election_epoch} lr={mon.leader_rank} "
                        f"q={sorted(mon.quorum)}")
                net.pump(quiesce=0.02, deadline=0.2)
                mon.tick(time.monotonic())
        if args.pool:
            spec = json.loads(args.pool)
            if spec.get("type") == "replicated":
                mon.create_replicated_pool(spec["name"], size=spec["size"],
                                           pg_num=spec["pg_num"])
            else:
                mon.create_ec_profile("vprof", spec["profile"])
                mon.create_ec_pool(spec["name"], "vprof",
                                   pg_num=spec["pg_num"])
        mon.publish()
        net.pump()
        if peers:
            # drain the paxos pipeline: READY must mean the initial
            # epochs are COMMITTED quorum-wide, not merely proposed
            deadline = time.monotonic() + 60.0
            while mon._inflight is not None or mon._pending_proposals:
                if time.monotonic() > deadline:
                    raise RuntimeError("initial epochs never committed")
                net.pump(quiesce=0.02, deadline=0.2)
                mon.tick(time.monotonic())
        for i in range(args.n_osds):
            mon.send_full_map(f"osd.{i}")
    if args.rejoin:
        # a RESTARTED mon (mon_thrash revival): boot empty and force
        # an election — the collect/LAST recovery teaches whichever
        # side is behind (an empty rank-0 leader pulls the peers'
        # full committed history via OP_LAST deltas)
        mon.start_election()
    print("READY", flush=True)
    trace = os.environ.get("VSTART_MON_TRACE")
    last_trace = 0.0
    while True:
        net.pump(quiesce=0.02, deadline=0.5)
        mon.tick(time.monotonic())
        if trace and time.monotonic() - last_trace > 1.0:
            last_trace = time.monotonic()
            print(f"TRACE {mon.name} ee={mon.election_epoch} "
                  f"lr={mon.leader_rank} q={sorted(mon.quorum)} "
                  f"ep={mon.osdmap.epoch} ninc={len(mon.incrementals)} "
                  f"unc={mon._uncommitted is not None} "
                  f"infl={mon._inflight is not None} "
                  f"pend={len(mon._pending_proposals)}",
                  file=sys.stderr, flush=True)


def osd_main(args) -> None:
    """OSD daemon: dispatch loop + heartbeat ticks + recovery rounds.
    Its codec runs on ``args.device``, opened before READY."""
    _daemon_start()
    _open_device(args.device)
    from .msg.tcp import TcpNetwork
    from .osd import osd as osd_mod

    if args.heartbeat_grace:
        osd_mod.HEARTBEAT_GRACE = args.heartbeat_grace
    if args.debug:
        from .common.config import g_conf
        from .common.dout import _log
        for s in ("osd", "pg", "recovery"):
            g_conf.set_val(f"debug_{s}", f"{args.debug}/{args.debug}")
        _log.stderr_level = args.debug
    directory = json.loads(args.directory)
    auth = None
    if args.keyring:
        from .msg.tcp import TcpAuth
        auth = TcpAuth(f"osd.{args.id}", args.keyring)
    net = TcpNetwork(("127.0.0.1", args.port),
                     {k: tuple(v) for k, v in directory.items()},
                     auth=auth, entity=f"osd.{args.id}")
    if auth is not None:
        # fetch tickets + rotating keys BEFORE serving, so inbound
        # authorizers (peer OSDs, the mon) can be verified from boot
        for _ in range(50):
            if net.authenticate():
                break
            time.sleep(0.2)
    store = None
    if args.data_dir:
        # durable boot (OSD::init, osd/OSD.cc:2469): mount the WAL
        # store — a rebooted daemon replays its journal and resumes
        # with its PG logs/data intact, so recovery is log-based
        from .os_store.walstore import mount_store
        store = mount_store(args.data_dir)
    mon_names = [m for m in (args.mon_names or "mon").split(",") if m]
    daemon = osd_mod.OSD(net, args.id, mon_name=mon_names[0],
                         store=store, mon_names=mon_names)
    # boot subscription: the mon's startup map pushes predate this
    # process's listener, so ask for the full history explicitly
    # (MonClient::sub_want("osdmap") at OSD::init) — from EVERY mon,
    # so a post-failover leader keeps publishing to us
    from .msg.messages import MMonSubscribe
    for m in mon_names:
        net.send(daemon.name, m, MMonSubscribe())
    print("READY", flush=True)
    interval = args.heartbeat_interval or osd_mod.HEARTBEAT_INTERVAL
    # warm-up: the first tick waits one full interval so sibling
    # daemons still booting don't read as silent peers
    last_tick = time.monotonic()
    while True:
        net.pump(quiesce=0.02, deadline=0.5)
        now = time.monotonic()
        if now - last_tick >= interval:
            daemon.tick(now)
            last_tick = now
        daemon.run_recovery()


def mds_main(args) -> None:
    """MDS daemon: metadata authority over the wire (mds/server.py).
    Creates the fs pools through mon wire commands on first boot; a
    rebooted daemon finds them and REPLAYS its journal.  It codes
    nothing, so it never touches CUDA: the file data's erasure code runs
    in the OSD processes, on their ``--device``."""
    _daemon_start()
    from .client.mon_client import MonClient
    from .client.rados import RadosClient
    from .msg.tcp import TcpNetwork

    directory = json.loads(args.directory)
    auth = None
    if args.keyring:
        from .msg.tcp import TcpAuth
        auth = TcpAuth(args.name, args.keyring)
    net = TcpNetwork(("127.0.0.1", args.port),
                     {k: tuple(v) for k, v in directory.items()},
                     auth=auth, entity=args.name)
    mon_names = [m for m in (args.mon_names or "mon").split(",") if m]
    # the FULL roster: an mds must keep reading the fsmap (its
    # promotion/fencing signal) across mon failures, hunting like the
    # reference MonClient
    rados = RadosClient(net, MonClient(net, mon_names[0],
                                       mon_names=mon_names),
                        args.name)
    # wait for a map with every osd up before touching pools
    deadline = time.monotonic() + 120.0
    while True:
        net.pump(quiesce=0.05, deadline=0.3)
        rados.mon.send_full_map(args.name)
        net.pump(quiesce=0.05, deadline=0.3)
        m = rados.osdmap
        if m.max_osd >= args.n_osds and \
                all(m.is_up(o) for o in range(args.n_osds)):
            break
        if time.monotonic() > deadline:
            raise RuntimeError("mds never saw a healthy map")
        time.sleep(0.2)
    for pool in (args.metadata_pool, args.data_pool):
        try:
            rados.mon_command("create_replicated_pool", name=pool,
                              size=min(3, args.n_osds), pg_num=8)
        except (ValueError, IOError):
            pass                    # exists (reboot) — reuse it
    from .cephfs.cls_fs import ROOT_INO, dir_oid
    from .mds import MDSDaemon
    # the fresh pools' PGs keep settling for a while after creation:
    # wait until the metadata pool actually ANSWERS (ENOENT or data —
    # either means servable).  Freshness is decided AFTER promotion:
    # another mds may create the fs while we stand by.
    deadline = time.monotonic() + 120.0
    while True:
        try:
            rados.stat(args.metadata_pool, dir_oid(ROOT_INO))
            break
        except IOError as e:
            if getattr(e, "errno", None) == 2:
                break               # pool serves, no fs yet
            if time.monotonic() > deadline:
                raise RuntimeError("fs pools never became servable")
            net.pump(quiesce=0.05, deadline=0.3)
            time.sleep(0.3)
    # ---- fsmap membership: beacon as standby until the MDSMonitor
    # names us active (first joiner activates immediately; later ones
    # stand by and take over on the active's beacon-grace failover) ----
    from .msg.messages import MMDSBeacon

    def beacon(state: str) -> None:
        for m in mon_names:
            net.send(args.name, m, MMDSBeacon(name=args.name,
                                              state=state))

    def fs_state():
        """(my_rank or None, rank->name) from the replicated fsmap."""
        try:
            st = rados.mon_command("fs_status")
        except (IOError, ValueError):
            return None, {}
        if not st:
            return None, {}
        ranks = {int(r): n for r, n in
                 (st.get("ranks") or {}).items()}
        e = (st.get("mds") or {}).get(args.name)
        if e and e.get("state") == "active" \
                and e.get("rank") is not None:
            return int(e["rank"]), ranks
        return None, ranks

    beacon("standby")
    print("READY", flush=True)
    last_beacon = 0.0
    my_rank = None
    while my_rank is None:
        my_rank, _ranks = fs_state()
        if my_rank is not None:
            break
        net.pump(quiesce=0.05, deadline=0.3)
        if time.monotonic() - last_beacon > 1.0:
            beacon("standby")
            last_beacon = time.monotonic()
        time.sleep(0.2)

    # promoted (or first): initialize and serve.  Probe freshness NOW —
    # if another mds was active before us, IT created the fs and we
    # must open + REPLAY, not mkfs.  Transient errors retry (a stale
    # False would journal.open() a journal that never existed).
    # Rank 0 is the fs creator; a promoted rank > 0 WAITS for the fs
    # (rank 0's mkfs) and never creates it.
    fresh = None
    deadline = time.monotonic() + 120.0
    last_slide = 0.0

    def keepalive() -> None:
        # EVERY promoted daemon (rank 0 doing mkfs included) must
        # keep beaconing while it initializes — a silent active is
        # grace-failed by the mon and its rank reseated under it,
        # which on a slow host means dual mkfs writers
        nonlocal last_beacon
        if time.monotonic() - last_beacon > 1.0:
            beacon("active")
            last_beacon = time.monotonic()

    while fresh is None:
        keepalive()
        try:
            rados.stat(args.metadata_pool, dir_oid(ROOT_INO))
            fresh = False
        except IOError as e:
            if getattr(e, "errno", None) == 2:
                if my_rank == 0:
                    fresh = True
                    continue
                # a promoted rank > 0 must outwait a SLOW rank 0, not
                # just a dead one: while the fsmap still shows a
                # rank-0 incumbent its mkfs is in progress somewhere,
                # so the deadline keeps sliding (loaded-host runs
                # exceeded a fixed 120 s before rank 0 finished).
                # The status poll rides the same 1 s cadence as the
                # beacons — the slide needs no finer granularity.
                if time.monotonic() - last_slide > 1.0:
                    last_slide = time.monotonic()
                    _r, ranks = fs_state()
                    if 0 in ranks:
                        deadline = max(deadline, last_slide + 120.0)
                if time.monotonic() > deadline:
                    raise RuntimeError("rank 0 never created the fs")
                else:
                    net.pump(quiesce=0.05, deadline=0.3)
                    time.sleep(0.3)
            elif time.monotonic() > deadline:
                raise
            else:
                net.pump(quiesce=0.05, deadline=0.3)
                time.sleep(0.3)
    mds = None
    while mds is None:
        keepalive()
        try:
            mds = MDSDaemon(net, rados, args.name,
                            metadata_pool=args.metadata_pool,
                            data_pool=args.data_pool, mkfs=fresh,
                            rank=my_rank)
        except IOError:
            # some PG of the fresh pools still settling; mkfs/journal
            # creation is idempotent, so just try again
            if time.monotonic() > deadline:
                raise
            net.pump(quiesce=0.05, deadline=0.3)
            time.sleep(0.5)
    # seed the rank map BEFORE serving — with an empty map a freshly
    # promoted rank treats other ranks' subtrees as its own and
    # answers ENOENT where it must FORWARD, so a transient fs_status
    # failure here cannot be shrugged off; a SEPARATE loop from the
    # construction retry so an IOError mid-seed cannot skip it
    seeded = False
    while not seeded:
        keepalive()
        try:
            _r, ranks0 = fs_state()
            if ranks0:
                mds.set_mds_map(ranks0)
                seeded = True
                continue
        except IOError:
            pass
        if time.monotonic() > deadline:
            raise RuntimeError("fsmap never readable before serving")
        net.pump(quiesce=0.05, deadline=0.3)
        time.sleep(0.3)
    last_beacon = 0.0
    last_fence_check = time.monotonic()
    while True:
        net.pump(quiesce=0.02, deadline=0.3)
        mds.process()
        now = time.monotonic()
        if now - last_beacon > 1.0:
            mds.beacon(mon_names)
            last_beacon = now
        if now - last_fence_check > 2.0:
            last_fence_check = now
            rank_now, ranks = fs_state()
            if ranks:
                mds.set_mds_map(ranks)
            # FENCED whenever a REAL fsmap read no longer shows us
            # holding our rank — reassigned (beacon-grace failover),
            # demoted (max_mds shrink), or dropped.  Two writers on
            # one rank journal would corrupt it — suicide and let the
            # harness restart us as a standby (MDSDaemon::respawn).
            # An empty ranks dict is a transient mon read failure,
            # never a fence signal.
            if ranks and ranks.get(my_rank) != args.name:
                print(f"fenced: rank {my_rank} is now "
                      f"{ranks.get(my_rank) or 'unheld'}; exiting",
                      file=sys.stderr, flush=True)
                os._exit(0)
        mds.tick(now)


# ---- harness ---------------------------------------------------------------

def _free_ports(n: int) -> List[int]:
    import socket
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


class ProcessCluster:
    """Spawn mon + N OSDs as real processes; clients live in the
    calling process and speak TCP like everyone else.

    ``device`` is where every OSD process runs its codec: ``cuda`` (the
    default) needs a card here, and K1 is built once in this process
    before any daemon starts; ``cpu`` keeps the daemons off CUDA, and
    the pool's profile then says ``backend=host``."""

    def __init__(self, n_osds: int = 6, pool: Optional[dict] = None,
                 heartbeat_interval: float = 1.0,
                 heartbeat_grace: float = 4.0,
                 down_out_interval: float = 5.0,
                 client_names: Tuple[str, ...] = ("client.x",),
                 auth: bool = False,
                 data_root: Optional[str] = None,
                 n_mons: int = 1,
                 mon_grace: float = 4.0,
                 n_mds: int = 0,
                 mds_grace: float = 5.0,
                 device: str = "cuda"):
        if device not in DEVICES:
            raise ValueError(f"device {device!r} is neither cuda nor cpu")
        if device == "cuda":
            # one nvcc here instead of one per daemon on a cold build
            # directory; the daemons load the same library (_build keys
            # it by source hash and writes it through os.replace)
            from .ops import _build
            from .ops.gf_matmul import resolve_device
            resolve_device(device)
            _build.build("gf_bit_matmul")
        self.device = device
        self.n_osds = n_osds
        self.n_mons = n_mons
        self.mon_grace = mon_grace
        self.n_mds = n_mds
        self.mds_grace = mds_grace
        # single-mon clusters keep the historical name "mon"
        self.mon_names = (["mon"] if n_mons == 1
                          else [f"mon.{r}" for r in range(n_mons)])
        self.data_root = data_root
        if data_root:
            os.makedirs(data_root, exist_ok=True)
        self.keyring_path: Optional[str] = None
        self._tmpdir: Optional[str] = None
        if auth:
            import tempfile
            from .auth import Keyring
            self._tmpdir = tempfile.mkdtemp(prefix="ceph_tpu_auth_")
            kr = Keyring()
            for m in self.mon_names:
                kr.create(m)
            for i in range(n_osds):
                kr.create(f"osd.{i}")
            for i in range(n_mds):
                kr.create(f"mds.{i}")
            for name in client_names:
                kr.create(name)
            self.keyring_path = os.path.join(self._tmpdir, "keyring")
            kr.save(self.keyring_path)
        self.client_names = client_names
        env = dict(os.environ)
        self.procs: Dict[str, subprocess.Popen] = {}
        self.network = None
        # the reserve-then-close port probe (_free_ports) races other
        # processes between close() and the daemon's rebind; a loser
        # dies instantly with EADDRINUSE, so ONE respawn with fresh
        # ports absorbs the collision without masking slow failures
        for attempt in (0, 1):
            ports = _free_ports(n_osds + n_mons + n_mds + 1)
            self.mon_ports = ports[:n_mons]
            self.mon_port = self.mon_ports[0]
            self.client_port = ports[n_mons]
            self.osd_ports = ports[n_mons + 1:n_mons + 1 + n_osds]
            self.mds_ports = ports[n_mons + 1 + n_osds:]
            directory: Dict[str, Tuple[str, int]] = {}
            for r, m in enumerate(self.mon_names):
                directory[m] = ("127.0.0.1", self.mon_ports[r])
            for name in client_names:
                directory[name] = ("127.0.0.1", self.client_port)
            for i in range(n_osds):
                directory[f"osd.{i}"] = ("127.0.0.1", self.osd_ports[i])
            for i in range(n_mds):
                directory[f"mds.{i}"] = ("127.0.0.1", self.mds_ports[i])
            self.directory = directory
            dir_json = json.dumps({k: list(v)
                                   for k, v in directory.items()})
            try:
                self._spawn(n_osds, dir_json, env, pool,
                            heartbeat_interval, heartbeat_grace,
                            down_out_interval)
                break
            except Exception as e:
                # a bind-race loser DIES (its traceback is on our
                # inherited stderr); a daemon that is alive but
                # unready timed out instead — that is a genuine
                # failure a respawn would only mask, so don't retry it
                a_daemon_died = any(p.poll() is not None
                                    for p in self.procs.values())
                if attempt or not a_daemon_died:
                    self.close()
                    raise
                print(f"ProcessCluster: spawn attempt failed with a "
                      f"dead daemon ({e}); retrying once on fresh "
                      f"ports (EADDRINUSE port-probe race)",
                      file=sys.stderr, flush=True)
                # kill whatever booted and retry on fresh ports
                for p in self.procs.values():
                    try:
                        p.kill()
                        p.wait(timeout=5)
                    except Exception:
                        pass
                self.procs.clear()
                if self.network is not None:
                    self.network.close()
                    self.network = None

    def _spawn(self, n_osds, dir_json, env, pool, heartbeat_interval,
               heartbeat_grace, down_out_interval) -> None:
        keyring_args = (["--keyring", self.keyring_path]
                        if self.keyring_path else [])
        peers_of = {m: ",".join(n for n in self.mon_names if n != m)
                    for m in self.mon_names}
        self._mon_args = {"dir_json": dir_json, "env": env,
                          "pool": pool, "n_osds": n_osds,
                          "down_out_interval": down_out_interval,
                          "keyring_args": keyring_args,
                          "peers_of": peers_of}
        # peons first (they serve the election rank 0 must win); rank 0
        # reports READY only after the initial epochs are committed
        # quorum-wide
        for r in range(1, self.n_mons):
            self._spawn_mon(r, with_pool=False)
        for r in range(1, self.n_mons):
            self._await_ready(self.mon_names[r])
        self._spawn_mon(0, with_pool=True)
        self._await_ready(self.mon_names[0])
        # spawn every osd CONCURRENTLY: a sequential boot staggers the
        # daemons' first heartbeats past the grace window and the
        # cluster marks itself down before it finishes starting
        self._osd_args = {"dir_json": dir_json, "env": env,
                          "heartbeat_interval": heartbeat_interval,
                          "heartbeat_grace": heartbeat_grace,
                          "keyring_args": keyring_args}
        for i in range(n_osds):
            self._spawn_osd(i)
        for i in range(n_osds):
            self._await_ready(f"osd.{i}")
        for i in range(self.n_mds):
            self._spawn_mds(i)
        for i in range(self.n_mds):
            # the mds waits for a healthy map + creates/opens the fs
            # pools before READY, which can take a while
            self._await_ready(f"mds.{i}", timeout=240.0)
        from .msg.tcp import TcpNetwork
        cl_auth = None
        if self.keyring_path:
            from .msg.tcp import TcpAuth
            cl_auth = TcpAuth(self.client_names[0], self.keyring_path)
        self.network = TcpNetwork(("127.0.0.1", self.client_port),
                                  self.directory, auth=cl_auth)

    def _spawn_mds(self, i: int) -> None:
        a = self._osd_args
        self.procs[f"mds.{i}"] = subprocess.Popen(
            [sys.executable, "-m", "ceph_tpu_torch.vstart", "mds",
             "--name", f"mds.{i}", "--port", str(self.mds_ports[i]),
             "--directory", a["dir_json"],
             "--mon-names", ",".join(self.mon_names),
             "--n-osds", str(self.n_osds),
             *a["keyring_args"]],
            stdout=subprocess.PIPE, text=True, cwd=REPO, env=a["env"])

    def kill_mds(self, i: int = 0) -> None:
        """kill -9 the mds daemon (the MDS failover drill)."""
        p = self.procs[f"mds.{i}"]
        p.send_signal(signal.SIGKILL)
        p.wait()

    def restart_mds(self, i: int = 0) -> None:
        """Fresh mds process on the same port: it finds the existing
        pools and REPLAYS the MDS journal."""
        old = self.procs.get(f"mds.{i}")
        if old is not None and old.poll() is None:
            raise RuntimeError(f"mds.{i} is still running")
        self._spawn_mds(i)
        self._await_ready(f"mds.{i}", timeout=240.0)

    def _await_ready(self, name: str, timeout: float = 120.0) -> None:
        import select
        proc = self.procs[name]
        r, _, _ = select.select([proc.stdout], [], [], timeout)
        if not r:
            raise RuntimeError(f"{name} did not report READY in "
                               f"{timeout}s")
        line = proc.stdout.readline()
        if line.strip() != "READY":
            raise RuntimeError(f"{name} failed to start: {line!r}")

    def client(self, name: str = "client.x",
               mon_name: Optional[str] = None):
        """Wire client; ``mon_name`` picks which mon it is bound to
        (subscriptions + wire commands — commands relay to the leader
        from any mon, so binding to a peon is fine)."""
        from .client.mon_client import MonClient
        from .client.rados import RadosClient
        return RadosClient(
            self.network,
            MonClient(self.network, mon_name or self.mon_names[0]), name)

    def _spawn_mon(self, rank: int, with_pool: bool,
                   rejoin: bool = False) -> None:
        a = self._mon_args
        name = self.mon_names[rank]
        pool = a["pool"]
        self.procs[name] = subprocess.Popen(
            [sys.executable, "-m", "ceph_tpu_torch.vstart", "mon",
             "--port", str(self.mon_ports[rank]),
             "--n-osds", str(a["n_osds"]),
             "--directory", a["dir_json"],
             "--name", name, "--rank", str(rank),
             "--peers", a["peers_of"][name],
             "--mon-grace", str(self.mon_grace),
             "--mds-grace", str(self.mds_grace),
             "--down-out-interval", str(a["down_out_interval"]),
             "--pool", json.dumps(pool) if (pool and with_pool)
             else "",
             *(["--rejoin"] if rejoin else []),
             *a["keyring_args"]],
            stdout=subprocess.PIPE, text=True, cwd=REPO,
            env=a["env"])

    def restart_mon(self, rank: int) -> None:
        """Fresh mon process on the same port: boots EMPTY, rejoins
        the quorum, and is taught the committed history through the
        collect/LAST recovery (mon_thrash's revive step)."""
        old = self.procs.get(self.mon_names[rank])
        if old is not None and old.poll() is None:
            old.kill()
            old.wait()
        self._spawn_mon(rank, with_pool=False, rejoin=True)
        self._await_ready(self.mon_names[rank], timeout=120.0)

    def kill_mon(self, rank: int) -> None:
        """kill -9 a monitor daemon (the leader-failure drill)."""
        p = self.procs[self.mon_names[rank]]
        p.send_signal(signal.SIGKILL)
        p.wait()

    def wait_healthy(self, cl, timeout: float = 60.0) -> None:
        """Block until the map shows every osd up (daemons can still be
        booting/re-booting when the first client appears)."""
        end = time.monotonic() + timeout
        while time.monotonic() < end:
            self.network.pump(quiesce=0.05, deadline=0.3)
            cl.mon.send_full_map(cl.name)
            self.network.pump(quiesce=0.05, deadline=0.3)
            m = cl.osdmap
            if m.max_osd == self.n_osds and \
                    all(m.is_up(o) for o in range(self.n_osds)):
                return
            time.sleep(0.2)
        raise RuntimeError("cluster never became healthy")

    def osd_argv(self, i: int) -> List[str]:
        """The daemon arguments of ``osd.<i>`` (after the program)."""
        a = self._osd_args
        data_args = ([]
                     if not self.data_root else
                     ["--data-dir",
                      os.path.join(self.data_root, f"osd.{i}")])
        return ["osd", "--id", str(i), "--port", str(self.osd_ports[i]),
                "--directory", a["dir_json"],
                "--mon-names", ",".join(self.mon_names),
                "--heartbeat-interval", str(a["heartbeat_interval"]),
                "--heartbeat-grace", str(a["heartbeat_grace"]),
                "--device", self.device,
                *a["keyring_args"], *data_args]

    def _spawn_osd(self, i: int) -> None:
        self.procs[f"osd.{i}"] = subprocess.Popen(
            [sys.executable, "-m", "ceph_tpu_torch.vstart",
             *self.osd_argv(i)],
            stdout=subprocess.PIPE, text=True, cwd=REPO,
            env=self._osd_args["env"])

    def kill_osd(self, osd_id: int) -> None:
        """kill -9 the daemon process (ceph_manager.py:195)."""
        p = self.procs[f"osd.{osd_id}"]
        p.send_signal(signal.SIGKILL)
        p.wait()

    def restart_osd(self, osd_id: int) -> None:
        """Boot a fresh daemon process on the same port + data dir
        (ceph_manager.py:373 revive_osd): with a data_root, the new
        process remounts its WALStore and rejoins with its history."""
        old = self.procs.get(f"osd.{osd_id}")
        if old is not None and old.poll() is None:
            raise RuntimeError(f"osd.{osd_id} is still running")
        self._spawn_osd(osd_id)
        self._await_ready(f"osd.{osd_id}")

    def pump_for(self, seconds: float) -> None:
        """Keep the client-side socket drained while the daemons work."""
        end = time.monotonic() + seconds
        while time.monotonic() < end:
            self.network.pump(quiesce=0.05, deadline=0.3)

    def close(self) -> None:
        for p in self.procs.values():
            try:
                p.kill()
            except OSError:
                pass
        for p in self.procs.values():
            try:
                p.wait(timeout=5)
            except Exception:
                pass
        if self.network is not None:
            self.network.close()
        if self._tmpdir:
            import shutil
            shutil.rmtree(self._tmpdir, ignore_errors=True)


def main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser(prog="ceph_tpu_torch.vstart")
    sub = ap.add_subparsers(dest="role", required=True)
    pm = sub.add_parser("mon")
    pm.add_argument("--port", type=int, required=True)
    pm.add_argument("--n-osds", type=int, required=True)
    pm.add_argument("--directory", required=True)
    pm.add_argument("--name", default="mon")
    pm.add_argument("--rank", type=int, default=0)
    pm.add_argument("--peers", default="")
    pm.add_argument("--mon-grace", type=float, default=0.0)
    pm.add_argument("--mds-grace", type=float, default=0.0)
    pm.add_argument("--pool", default="")
    pm.add_argument("--rejoin", action="store_true")
    pm.add_argument("--down-out-interval", type=float, default=0.0)
    pm.add_argument("--keyring", default="")
    po = sub.add_parser("osd")
    po.add_argument("--id", type=int, required=True)
    po.add_argument("--port", type=int, required=True)
    po.add_argument("--directory", required=True)
    po.add_argument("--mon-names", default="mon")
    po.add_argument("--heartbeat-interval", type=float, default=0.0)
    po.add_argument("--heartbeat-grace", type=float, default=0.0)
    po.add_argument("--keyring", default="")
    po.add_argument("--data-dir", default="")
    po.add_argument("--device", choices=DEVICES, default="cuda")
    po.add_argument("--debug", type=int,
                    default=int(os.environ.get("VSTART_DEBUG", "0")))
    pd = sub.add_parser("mds")
    pd.add_argument("--name", default="mds.0")
    pd.add_argument("--port", type=int, required=True)
    pd.add_argument("--directory", required=True)
    pd.add_argument("--mon-names", default="mon")
    pd.add_argument("--n-osds", type=int, required=True)
    pd.add_argument("--metadata-pool", default="fsmeta")
    pd.add_argument("--data-pool", default="fsdata")
    pd.add_argument("--keyring", default="")
    args = ap.parse_args(argv)
    if args.role == "mon":
        mon_main(args)
    elif args.role == "mds":
        mds_main(args)
    else:
        osd_main(args)


if __name__ == "__main__":
    main()
