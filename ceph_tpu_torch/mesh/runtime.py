"""MeshRuntime — one scheduler feeding N mesh members.

Port of ``ceph_tpu/mesh/runtime.py``.  The dispatch scheduler
(``dispatch/``) coalesces concurrent EC requests into one padded device
call; the runtime threads a mesh layer between the batch assembler and
the codec backends:

- **topology**: a 1-D ``("batch",)`` mesh of members
  (``mesh/topology.py``; ``ec_mesh_chips``).  Mesh size 1 — or
  ``ec_mesh_chips=0``, the default — is the existing single-device path
  BY CONSTRUCTION: ``encode_stacked`` returns None and the assembler runs
  today's code.  A codec rides the mesh only when its backend lives on
  the mesh's platform (``backend=cuda`` on the card, ``backend=host`` on
  a CPU mesh); any other codec is declined, like a codec whose layout is
  not row-shardable.
- **sharding-plan cache**: keyed by (codec signature, chunk bucket) —
  the same key space the dispatch queues use — each plan holds the
  encode bit-matrix on every device of the mesh and runs K1 once per
  member, on the member's stream, for an equal row slice of the batch.
  The batch (stripe) axis pads to the next power of two rounded up to a
  mesh-size multiple, as in the JAX package.
- **staging pool**: the padded batch buffer is acquired from a per-shape
  pool (pool.py).  Where ``donate`` is true (``ec_mesh_donate`` on a
  device that is not the CPU, as JAX computes it) the plan writes K1's
  output into pooled device buffers of its own instead of allocating new
  ones per flush; torch has no ``donate_argnums``.
- **accounting**: per-chip occupancy (stripes of real work each member
  received per flush) lands in the 2-D
  ``dispatch_chip_occupancy_histogram`` and a per-chip totals table;
  the ``mesh`` perf counters ride perf dump / Prometheus
  (``ceph_daemon_mesh_*``) and ``dispatch dump`` carries the whole
  runtime state.

Failure policy: no guard and no fallback.  The injection sites
``mesh.encode_batch`` and ``mesh.decode_batch`` are checked before the
sharded call and raise to the caller, as ``dispatch.batch`` does, and a
failed launch raises.  The ``fallbacks`` counters stay in the dumps (so
the dumps keep their keys) and never move.

Scope: BOTH matmul kinds ride the mesh.  The write path shards flushed
encode groups (``encode_stacked``); the READ path shards decode and
reconstruct groups and the product-matrix repair solve
(``decode_stacked``) — decode is the same bit-matmul with the
host-inverted survivor matrix.  A repair solve's single stripe folds
its byte axis into extra batch rows first (GF matmuls are columnwise
independent) so even S=1 work spreads across the members.  Decode plans
live in the SAME ``_plans`` dict as encode plans, so an elastic-
membership transition invalidates both; the transition additionally
waits out IN-FLIGHT decode/repair calls before the rebuild.
"""
from __future__ import annotations

from ..common.lockdep import DebugLock, DebugRLock
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..common.config import g_conf
from ..common.perf_counters import PerfCounters, PerfCountersBuilder
from ..trace.devprof import g_devprof
from ..trace.journal import g_journal
from ..trace.histogram import (PerfHistogramAxis, SCALE_LINEAR,
                               g_perf_histograms)
from .pool import StagingPool
from .topology import (BATCH_AXIS, Mesh, Shard, Sharded, batch_mesh,
                       default_platform, members_per_device)

# ---- perf counters (perf dump / Prometheus ceph_daemon_mesh_*) -------------
MESH_FIRST = 98000
l_mesh_dispatches = 98001      # flushes executed through the mesh
l_mesh_reqs = 98002            # coalesced requests through mesh flushes
l_mesh_stripes = 98003         # real (non-pad) stripes sharded
l_mesh_pad_stripes = 98004     # zero-pad lanes added for divisibility
l_mesh_bytes = 98005           # payload bytes through mesh flushes
l_mesh_plan_builds = 98006     # sharding plans compiled (cache misses)
l_mesh_plan_hits = 98007       # sharding-plan cache hits
l_mesh_pool_hits = 98008       # staging buffers served from the pool
l_mesh_pool_misses = 98009     # staging buffers freshly allocated
l_mesh_fallbacks = 98010       # flushes degraded to the single-device path
l_mesh_chips = 98011           # gauge: current mesh size
MESH_LAST = 98020

_mesh_pc: Optional[PerfCounters] = None
_mesh_pc_lock = DebugLock("mesh_pc::init")


def mesh_perf_counters() -> PerfCounters:
    """The mesh runtime's counter logger (perf dump / Prometheus)."""
    global _mesh_pc
    if _mesh_pc is not None:
        return _mesh_pc
    with _mesh_pc_lock:
        if _mesh_pc is None:
            b = PerfCountersBuilder("mesh", MESH_FIRST, MESH_LAST)
            b.add_u64_counter(l_mesh_dispatches, "dispatches",
                              "flushes executed through the mesh")
            b.add_u64_counter(l_mesh_reqs, "reqs",
                              "coalesced requests through mesh flushes")
            b.add_u64_counter(l_mesh_stripes, "stripes",
                              "real stripes sharded across the mesh")
            b.add_u64_counter(l_mesh_pad_stripes, "pad_stripes",
                              "zero-pad stripe lanes added for batch-"
                              "axis divisibility")
            b.add_u64_counter(l_mesh_bytes, "bytes",
                              "payload bytes through mesh flushes")
            b.add_u64_counter(l_mesh_plan_builds, "plan_builds",
                              "sharding plans built (cache misses)")
            b.add_u64_counter(l_mesh_plan_hits, "plan_hits",
                              "sharding-plan cache hits")
            b.add_u64_counter(l_mesh_pool_hits, "pool_hits",
                              "staging buffers reused from the pool")
            b.add_u64_counter(l_mesh_pool_misses, "pool_misses",
                              "staging buffers freshly allocated")
            b.add_u64_counter(l_mesh_fallbacks, "fallbacks",
                              "mesh flushes degraded to the single-"
                              "device path")
            b.add_u64(l_mesh_chips, "chips",
                      "devices in the active dispatch mesh")
            _mesh_pc = b.create_perf_counters()
    return _mesh_pc


# ---- decode-path counters (ceph_daemon_mesh_decode_*) ----------------------
MESH_DECODE_FIRST = 98300
l_mdec_dispatches = 98301    # decode/reconstruct/repair groups meshed
l_mdec_stripes = 98302       # real (non-pad) decode rows sharded
l_mdec_pad_stripes = 98303   # zero-pad decode rows for divisibility
l_mdec_bytes = 98304         # survivor bytes through meshed decodes
l_mdec_plan_builds = 98305   # decode sharding plans built (cache misses)
l_mdec_plan_hits = 98306     # decode sharding-plan cache hits
l_mdec_fallbacks = 98307     # meshed decodes degraded to single-device
l_mdec_repair_solves = 98308  # regenerating repair solves meshed
l_mdec_col_folds = 98309     # byte-axis folds applied to thin batches
l_mdec_inflight = 98310      # gauge: mesh calls executing right now
MESH_DECODE_LAST = 98320

_mdec_pc: Optional[PerfCounters] = None
_mdec_pc_lock = DebugLock("mesh_decode_pc::init")


def mesh_decode_perf_counters() -> PerfCounters:
    """The meshed READ path's counter logger (perf dump / Prometheus
    ``ceph_daemon_mesh_decode_*``): decode/reconstruct groups and
    product-matrix repair solves sharded across the chips."""
    global _mdec_pc
    if _mdec_pc is not None:
        return _mdec_pc
    with _mdec_pc_lock:
        if _mdec_pc is None:
            b = PerfCountersBuilder("mesh_decode", MESH_DECODE_FIRST,
                                    MESH_DECODE_LAST)
            b.add_u64_counter(l_mdec_dispatches, "dispatches",
                              "decode/reconstruct/repair groups "
                              "executed across the mesh")
            b.add_u64_counter(l_mdec_stripes, "stripes",
                              "real decode rows sharded across the "
                              "mesh")
            b.add_u64_counter(l_mdec_pad_stripes, "pad_stripes",
                              "zero-pad decode rows added for batch-"
                              "axis divisibility")
            b.add_u64_counter(l_mdec_bytes, "bytes",
                              "survivor bytes through meshed decodes")
            b.add_u64_counter(l_mdec_plan_builds, "plan_builds",
                              "decode sharding plans built (cache "
                              "misses)")
            b.add_u64_counter(l_mdec_plan_hits, "plan_hits",
                              "decode sharding-plan cache hits")
            b.add_u64_counter(l_mdec_fallbacks, "fallbacks",
                              "meshed decodes degraded to the single-"
                              "device path")
            b.add_u64_counter(l_mdec_repair_solves, "repair_solves",
                              "regenerating repair solves executed "
                              "across the mesh")
            b.add_u64_counter(l_mdec_col_folds, "col_folds",
                              "byte-axis folds applied so thin decode "
                              "batches still spread across the chips")
            b.add_u64(l_mdec_inflight, "inflight",
                      "mesh device calls executing right now (the "
                      "membership drain waits this to zero)")
            _mdec_pc = b.create_perf_counters()
    return _mdec_pc


# ---- elastic-membership counters (ceph_daemon_mesh_membership_*) ----------
MEMBER_FIRST = 98200
l_member_transitions = 98201     # applied ec_mesh_chips topology changes
l_member_chip_adds = 98202       # chips added across all transitions
l_member_chip_retires = 98203    # chips retired across all transitions
l_member_drained_reqs = 98204    # queued requests drained on the OLD mesh
l_member_plans_dropped = 98205   # sharding plans invalidated by transitions
l_member_pool_dropped = 98206    # staging buffers released by transitions
l_member_suspect_retires = 98207  # retired chips the scoreboard had SUSPECT
l_member_target_chips = 98208    # gauge: configured ec_mesh_chips target
MEMBER_LAST = 98220

_member_pc: Optional[PerfCounters] = None
_member_pc_lock = DebugLock("mesh_membership_pc::init")


def membership_perf_counters() -> PerfCounters:
    """The elastic-membership counter logger: every injectargs-driven
    ``ec_mesh_chips`` transition (drain, invalidation, add/retire
    accounting) lands here, so a chaos storyline's mesh_chip_add /
    mesh_chip_retire legs are visible on perf dump and Prometheus."""
    global _member_pc
    if _member_pc is not None:
        return _member_pc
    with _member_pc_lock:
        if _member_pc is None:
            b = PerfCountersBuilder("mesh_membership", MEMBER_FIRST,
                                    MEMBER_LAST)
            b.add_u64_counter(l_member_transitions, "transitions",
                              "applied ec_mesh_chips topology changes")
            b.add_u64_counter(l_member_chip_adds, "chip_adds",
                              "chips added across membership "
                              "transitions")
            b.add_u64_counter(l_member_chip_retires, "chip_retires",
                              "chips retired across membership "
                              "transitions")
            b.add_u64_counter(l_member_drained_reqs, "drained_reqs",
                              "queued requests drained on the old "
                              "mesh before a rebuild")
            b.add_u64_counter(l_member_plans_dropped, "plans_dropped",
                              "sharding plans invalidated by "
                              "membership transitions")
            b.add_u64_counter(l_member_pool_dropped, "pool_dropped",
                              "staging buffers released by "
                              "membership transitions")
            b.add_u64_counter(l_member_suspect_retires,
                              "suspect_retires",
                              "retired chips the skew scoreboard "
                              "held SUSPECT at retire time")
            b.add_u64(l_member_target_chips, "target_chips",
                      "configured ec_mesh_chips target")
            _member_pc = b.create_perf_counters()
    return _member_pc


def chip_occupancy_axes() -> List[PerfHistogramAxis]:
    """2-D per-chip occupancy: axis 0 = real stripes a chip received
    in one mesh flush (linear unit buckets, 0..64 individually visible
    like the batch-occupancy axis), axis 1 = the chip's index in the
    mesh (linear, chips 0..63 individually visible — a pod-slice-sized
    bound; larger meshes merge the tail into the overflow bucket, and
    the exact per-chip totals stay on ``dispatch dump``'s per_chip
    table either way).  Both axes are dimensionless, so the mgr
    renderer exports raw edges."""
    return [PerfHistogramAxis("chip_stripes", min=0, quant_size=1,
                              buckets=67, scale_type=SCALE_LINEAR),
            PerfHistogramAxis("chip_index", min=0, quant_size=1,
                              buckets=66, scale_type=SCALE_LINEAR)]


class _MemberPlan:
    """What both plan kinds share: a (8k, 8r) bit-matrix on every device
    of the mesh, and K1 once per member over its row slice of a padded
    host batch.  With ``donated`` the members write into a pooled device
    output of the plan's own (one per concurrent flush), not a new
    allocation per flush."""

    def _setup(self, mesh: Mesh, bits_np: np.ndarray, donate: bool):
        from ..ops.gf_pallas import BitMatrix
        self.mesh = mesh
        self.bits_np = bits_np
        self.bits = {dev: BitMatrix(bits_np, dev)
                     for dev in mesh.distinct_devices}
        self.donated = bool(donate)
        self._outs: Dict[Tuple, List[Dict]] = {}
        self._outs_lock = DebugLock("MeshPlan::outs")
        self.hits = 0
        self.rateless = None     # (n_parity, RatelessPlan), lazy

    def _acquire_out(self, shape) -> Dict:
        with self._outs_lock:
            free = self._outs.setdefault(tuple(shape), [])
            if free:
                return free.pop()
        return {dev: torch.empty(shape, dtype=torch.uint8, device=dev)
                for dev in self.mesh.distinct_devices}

    def _release_out(self, shape, outs: Dict) -> None:
        with self._outs_lock:
            self._outs.setdefault(tuple(shape), []).append(outs)

    def launch(self, buf: np.ndarray, out_bufs: Optional[Dict] = None
               ) -> Sharded:
        """K1 over *buf* (S_pad, k, Cb): member i takes rows
        [i*rows, (i+1)*rows) on its stream and records its event."""
        from ..ops.gf_pallas import gf_bit_matmul_kernel
        s_pad, _k, cb = buf.shape
        r = self.bits_np.shape[1] // 8
        n = self.mesh.size
        rows = s_pad // n
        shards = []
        for i, mem in enumerate(self.mesh.members):
            sl = slice(i * rows, (i + 1) * rows)
            src = torch.from_numpy(buf[sl])
            dst = None if out_bufs is None else out_bufs[mem.device][sl]
            with mem.launching(*(() if dst is None else (dst,))):
                out = gf_bit_matmul_kernel(src.to(mem.device),
                                           self.bits[mem.device], out=dst)
                ev = mem.record()
            shards.append(Shard(mem, out, (sl, slice(0, r), slice(0, cb)),
                                ev))
        return Sharded((s_pad, r, cb), shards, (BATCH_AXIS, None, None))

    def run(self, buf: np.ndarray, probe: bool) -> np.ndarray:
        """One flush: launch every member, probe on probe flushes, then
        gather every member's rows to the host (each fetch runs on its
        member's stream: the gather is the completion fence)."""
        shape = (buf.shape[0], self.bits_np.shape[1] // 8, buf.shape[2])
        outs = self._acquire_out(shape) if self.donated else None
        try:
            out = self.launch(buf, outs)
            if probe:
                from .chipstat import g_chipstat
                g_chipstat.probe(out, self.mesh)
            return out.numpy()
        finally:
            if outs is not None:
                self._release_out(shape, outs)


class ShardingPlan(_MemberPlan):
    """One placement for a (codec signature, chunk bucket): input rows
    split over the batch axis, the encode bit-matrix on every device,
    output rows in place.  ``rateless`` holds the lazily-built coding
    geometry for the rateless path (rateless.py) — same cache entry,
    same lifetime."""

    def __init__(self, mesh, backend, donate: bool):
        from ..gf.tables import expand_to_bitmatrix
        self._setup(mesh, expand_to_bitmatrix(
            backend.matrix[backend.k:]).astype(np.uint8), donate)


class DecodeShardingPlan(_MemberPlan):
    """One placement for a decode-kind matmul: the bit-matrix is the
    host-INVERTED survivor matrix, keyed by the erasure signature
    (srcs, want_rows) on top of the codec signature — the recovery
    shape repeats one erasure across many stripes, so the key space
    stays as small as the decode-bits LRU's.  Everything else mirrors
    ShardingPlan, and the ``rateless`` slot carries the decode-bits
    coding geometry for the rateless path."""

    def __init__(self, key, mesh, bits_np, donate: bool):
        self.key = key
        self._setup(mesh, np.asarray(bits_np, dtype=np.uint8), donate)


class MeshRuntime:
    """The dispatch scheduler's device back end when a mesh is up."""

    def __init__(self):
        from .rateless import RatelessCoder
        self._lock = DebugRLock("MeshRuntime::lock")
        self._mesh = None
        self._mesh_n = None          # ec_mesh_chips the mesh was built for
        self._plans: Dict[Tuple, ShardingPlan] = {}
        self._pool = StagingPool()
        self._chips: Dict[int, Dict[str, int]] = {}
        self._rateless = RatelessCoder()
        # mesh device calls currently executing (encode AND decode/
        # repair): the membership drain waits this to zero after the
        # dispatcher flush, because repair solves enter decode_stacked
        # directly — they are never queued, so flush() cannot see them
        self._inflight = 0
        # while held, topology() keeps serving the CURRENT mesh even if
        # ec_mesh_chips changed underneath — the membership transition
        # sets this so the dispatcher drain completes every in-flight
        # flush against the mesh it was admitted under
        self._hold = False
        self._transitions = 0
        # injectargs-live membership: the observer fires synchronously
        # from config set / injectargs, drains, and rebuilds eagerly
        g_conf.add_observer("ec_mesh_chips", self._on_chips_changed)

    # ---- options (read live so `config set` applies without restart) ------
    @staticmethod
    def _opts() -> Tuple[int, int, bool]:
        return (int(g_conf.get_val("ec_mesh_chips")),
                int(g_conf.get_val("ec_mesh_pool_buffers")),
                bool(g_conf.get_val("ec_mesh_donate")))

    @property
    def _hist(self):
        return g_perf_histograms.get(
            "dispatch", "dispatch_chip_occupancy_histogram",
            chip_occupancy_axes)

    # ---- topology ----------------------------------------------------------
    def topology(self):
        """The current batch mesh, rebuilt when ``ec_mesh_chips``
        changes (plans are placement-bound, so they drop with it).

        While ``_hold`` is set (a membership transition is draining the
        dispatcher) the EXISTING mesh keeps being served, so every
        queued flush completes against the topology it was admitted
        under; the rebuild happens when the transition releases the
        hold and calls back in."""
        chips, pool_cap, _donate = self._opts()
        # a change of members per device rebuilds like one of the count
        want = (chips, members_per_device(), default_platform())
        transition = None
        with self._lock:
            if self._mesh is not None and (self._mesh_n == want
                                           or self._hold):
                # ec_mesh_pool_buffers stays live even when the
                # topology is unchanged (guarded: one unlocked read
                # per flush, the trim only runs on an actual change)
                if self._pool._per_shape != max(int(pool_cap), 1):
                    self._pool.set_capacity(pool_cap)
                return self._mesh
            prev_n = self._mesh_n
            prev_size = 0 if self._mesh is None else self._mesh.size
            plans_dropped = len(self._plans)
            self._plans.clear()
            pool_dropped = self._pool.clear()
            self._pool.set_capacity(pool_cap)
            self._chips.clear()
            if chips == 0:
                self._mesh, self._mesh_n = None, (0,) + want[1:]
            else:
                self._mesh = batch_mesh(chips)
                self._mesh_n = want
            new_size = 0 if self._mesh is None else self._mesh.size
            mesh_perf_counters().set(l_mesh_chips, new_size)
            if (prev_n is not None and prev_size > 0 and new_size > 0
                    and prev_size != new_size):
                # a live mesh changed size — a membership transition
                # (mesh up 0->N and mesh down N->0 are lifecycle, not
                # membership).  Stash the facts, account outside the
                # lock (journal and scoreboard take their own locks).
                self._transitions += 1
                transition = (prev_size, new_size, plans_dropped,
                              pool_dropped)
            mesh = self._mesh
        if transition is not None:
            self._member_transition(*transition)
        return mesh

    def _on_chips_changed(self, _name: str, value) -> None:
        """``ec_mesh_chips`` config observer (registered at
        construction): makes membership injectargs-live.  Drain first —
        hold the old topology so ``g_dispatcher.flush()`` completes
        every queued request (encode AND decode groups share the
        dispatcher queues) on the mesh it was admitted under (the
        rateless path finishes from the first sufficient subset, so a
        retiring chip that is already failing costs bandwidth, never a
        flush), then wait out IN-FLIGHT mesh calls — repair solves and
        direct decodes enter ``decode_stacked`` without queuing, so
        the flush cannot see them — and only then release and rebuild
        eagerly via ``topology()``, which does the invalidation (both
        plan kinds live in ``_plans``) + add/retire accounting."""
        try:
            target = int(value)
        except (TypeError, ValueError):
            return
        membership_perf_counters().set(l_member_target_chips,
                                       max(target, 0))
        with self._lock:
            if self._mesh_n is None or self._mesh_n[0] == target:
                return          # never built, or an idempotent re-set
            self._hold = True
        try:
            from ..dispatch import g_dispatcher
            drained = g_dispatcher.flush()
            self._wait_inflight()
        finally:
            with self._lock:
                self._hold = False
        if drained:
            membership_perf_counters().inc(l_member_drained_reqs,
                                           int(drained))
        self.topology()

    # bound on the in-flight wait: generous next to any real device
    # call (the JAX package's value)
    INFLIGHT_DRAIN_S = 5.0

    def _wait_inflight(self) -> None:
        """Poll the in-flight gauge to zero (bounded) while ``_hold``
        keeps the old topology alive: every admitted call completes on
        the mesh it started on, so a membership flip mid-decode can
        never reshard half an erasure group."""
        import time
        from .chipstat import ChipStat
        deadline = time.perf_counter() + self.INFLIGHT_DRAIN_S
        while time.perf_counter() < deadline:
            with self._lock:
                if self._inflight <= 0:
                    return
            time.sleep(ChipStat.PROBE_POLL_S)

    def _inflight_add(self, delta: int) -> None:
        with self._lock:
            self._inflight += delta
            n = max(self._inflight, 0)
        mesh_decode_perf_counters().set(l_mdec_inflight, n)

    def _member_transition(self, prev_size: int, new_size: int,
                           plans_dropped: int, pool_dropped: int
                           ) -> None:
        """Post-rebuild accounting for one membership transition:
        counters, the mesh_chip_add / mesh_chip_retire journal events
        (the composable storyline steps, docs/CHAOS.md), and the
        scoreboard epoch roll — chip indices re-map with the topology,
        so a retired chip's skew streak must not indict its successor.
        Runs OUTSIDE MeshRuntime::lock."""
        from .chipstat import g_chipstat
        pc = membership_perf_counters()
        pc.inc(l_member_transitions)
        if plans_dropped:
            pc.inc(l_member_plans_dropped, plans_dropped)
        if pool_dropped:
            pc.inc(l_member_pool_dropped, pool_dropped)
        if new_size > prev_size:
            pc.inc(l_member_chip_adds, new_size - prev_size)
            g_journal.emit("mesh", "mesh_chip_add",
                           chips_from=prev_size, chips_to=new_size,
                           added=new_size - prev_size,
                           plans_dropped=plans_dropped)
        elif new_size < prev_size:
            retired = list(range(new_size, prev_size))
            suspects = sorted(g_chipstat.suspect_set()
                              & set(retired))
            pc.inc(l_member_chip_retires, prev_size - new_size)
            if suspects:
                pc.inc(l_member_suspect_retires, len(suspects))
            g_journal.emit("mesh", "mesh_chip_retire",
                           chips_from=prev_size, chips_to=new_size,
                           retired=retired, suspects_retired=suspects,
                           plans_dropped=plans_dropped)
        g_chipstat.reset()

    def active(self) -> bool:
        """True when flushes should shard: a mesh of >= 2 devices is
        up.  ``ec_mesh_chips=0`` (default) or a 1-device topology keeps
        the single-device path by construction."""
        mesh = self.topology()
        return mesh is not None and mesh.size > 1

    # ---- the flush entry point (dispatch/batch.py assembly) ---------------
    def encode_stacked(self, leader, stripes_list: List[np.ndarray],
                       bucket_c: int) -> Optional[np.ndarray]:
        """Shard one flushed encode group across the mesh.

        *stripes_list* holds each request's (S_i, k, C_i) uint8 view
        (C_i <= *bucket_c*; the assembler's column-pad contract).
        Returns the coalesced coding rows (S_pad, m, bucket_c) — the
        caller slices each request's rows/columns back out exactly as
        on the single-device path — or None when the mesh is down,
        or the codec has no plain bit-matrix backend on the mesh's
        platform (the caller then runs the single-device path).  The
        ``mesh.encode_batch`` injection site is checked first and raises
        to the caller; so does a failed launch."""
        if not self.active():
            return None
        backend = self._bit_backend(leader)
        if backend is None:
            return None
        from ..dispatch.signature import codec_signature
        from ..fault import g_faults
        sig = codec_signature(leader)
        g_faults.check("mesh.encode_batch", ctx=str(sig))
        self._inflight_add(1)
        try:
            return self._encode(sig, backend, stripes_list, bucket_c)
        finally:
            self._inflight_add(-1)

    # ---- the decode entry point (plugin decode_batch / repair) -------------
    def decode_stacked(self, leader, survivors: np.ndarray,
                       srcs, want_rows,
                       repair: bool = False) -> Optional[np.ndarray]:
        """Shard one decode-kind matmul across the mesh.

        *survivors* is the (S, n_src, C) uint8 stack in *srcs* order —
        exactly what ``DeviceRSBackend.decode_data`` consumes — and
        the return is the requested rows (S, len(want_rows), C),
        byte-identical to the single-device call.  *srcs*/*want_rows*
        index the leader backend's full (k+m, k)-style matrix, so the
        same entry serves plain-RS reconstruct (matrix rows), the
        regenerating ≥d decode (Ψ rows) and the d×d repair solve
        (*repair* marks the latter for the counters).

        Returns None — the caller then runs the existing single-device
        path — when the mesh is off/size-1 (BY CONSTRUCTION nothing
        changes) or when the codec's decode is not mesh-shardable on the
        mesh's platform.  The ``mesh.decode_batch`` injection site is
        checked first and raises to the caller; so does a failed
        launch."""
        if not self.active():
            return None
        backend = self._decode_backend(leader)
        if backend is None:
            return None
        if survivors.size == 0 or not want_rows:
            return None
        from ..dispatch.signature import codec_signature
        from ..fault import g_faults
        sig = codec_signature(leader)
        srcs = tuple(int(i) for i in srcs)
        want_rows = tuple(int(i) for i in want_rows)
        g_faults.check("mesh.decode_batch", ctx=str(sig))
        self._inflight_add(1)
        try:
            return self._decode(sig, backend, survivors, srcs, want_rows,
                                repair)
        finally:
            self._inflight_add(-1)

    def _bit_backend(self, leader):
        """The leader's plain GF(2^8) bit-matmul backend, or None for
        codecs whose device layout is not row-shardable by this plan
        shape.  THREE gates, all required: the codec must declare
        ``mesh_row_shardable`` (its encode_batch is the plain matmul
        on raw chunks — jerasure's bitmatrix/word layouts transform
        the data first and override it to False), the backend must be
        a plain :class:`DeviceRSBackend` (word codes ride
        DeviceWordRSBackend), and it must live on the mesh's platform
        (a ``backend=host`` codec never rides a mesh on the card)."""
        if not getattr(leader, "mesh_row_shardable", False):
            return None
        return self._platform_backend(leader)

    def _platform_backend(self, leader):
        from ..ops.gf_matmul import DeviceRSBackend
        dev_fn = getattr(leader, "device", None)
        mesh = self.topology()
        if dev_fn is None or mesh is None:
            return None
        if getattr(leader, "torch_device", None) != mesh.platform:
            return None
        backend = dev_fn()
        return backend if type(backend) is DeviceRSBackend else None

    def _decode_backend(self, leader):
        """The leader's backend when its DECODE is mesh-shardable.
        Same two gates as ``_bit_backend`` but on the codec's
        ``mesh_decode_shardable`` declaration: decode is the plain
        inverted-matrix matmul for RS-matrix codes AND for the
        regenerating family (whose encode is not row-shardable, but
        whose ≥d decode and repair solve are plain survivor matmuls
        over [[I],[Ψ]] rows)."""
        if not getattr(leader, "mesh_decode_shardable", False):
            return None
        return self._platform_backend(leader)

    def _decode(self, sig: Tuple, backend, survivors: np.ndarray,
                srcs: Tuple[int, ...], want_rows: Tuple[int, ...],
                repair: bool) -> np.ndarray:
        from .rateless import DECODE_SITES, rateless_opts
        mesh = self.topology()
        s_orig, n_src, c_orig = survivors.shape
        pc = mesh_decode_perf_counters()
        # byte-axis folding: GF matmuls are columnwise independent, so
        # a batch thinner than the mesh (the repair solve is S=1 by
        # shape) folds chunk bytes into extra rows and every chip
        # still gets real work; non-divisible widths just ride the row
        # pad (correct, some chips idle on pad lanes)
        fold = 1
        if s_orig < mesh.size and c_orig % mesh.size == 0:
            fold = mesh.size
            survivors = np.ascontiguousarray(
                survivors
                .reshape(s_orig, n_src, fold, c_orig // fold)
                .transpose(0, 2, 1, 3)
                .reshape(s_orig * fold, n_src, c_orig // fold))
            pc.inc(l_mdec_col_folds)
        s_total, _n, cb = survivors.shape
        s_pad = self._pad_rows(s_total, mesh.size)
        plan = self._decode_plan(sig, cb, srcs, want_rows, backend,
                                 mesh)
        mpc = mesh_perf_counters()
        buf, pooled = self._pool.acquire((s_pad, n_src, cb))
        mpc.inc(l_mesh_pool_hits if pooled else l_mesh_pool_misses)
        chip_real = None
        try:
            buf[:s_total] = survivors
            g_devprof.account_host_copy("mesh.decode_assemble",
                                        buf.nbytes)
            from ..common.kernel_trace import g_kernel_timer
            from .chipstat import g_chipstat
            probe = g_chipstat.should_probe()
            if rateless_opts()[0]:
                # the encode engine verbatim — it reads the bit-matrix
                # only out of the RatelessPlan, and GF-linearity makes
                # parity combinations valid for ANY bit-matrix; the
                # DECODE_SITES triple keeps the bandwidth separable
                rplan = self._decode_rateless_plan(plan, mesh)
                with g_devprof.stage("mesh.decode"):
                    rec, chip_real = g_kernel_timer.timed(
                        "ec_decode_batch_mesh_rateless",
                        lambda: self._rateless.encode(
                            plan, rplan, buf, mesh, probe, s_total,
                            sites=DECODE_SITES))
            else:
                g_devprof.account_h2d("mesh.decode", buf.nbytes)
                with g_devprof.stage("mesh.decode"):
                    rec = g_kernel_timer.timed(
                        "ec_decode_batch_mesh", plan.run, buf, probe)
                g_devprof.account_d2h("mesh.decode", rec.nbytes)
        finally:
            self._pool.release(buf)
        self._account_decode(mesh, s_total, s_pad,
                             int(survivors.nbytes), chip_real, repair)
        rec = rec[:s_total]
        if fold > 1:
            w = rec.shape[1]
            rec = np.ascontiguousarray(
                rec.reshape(s_orig, fold, w, cb)
                .transpose(0, 2, 1, 3)
                .reshape(s_orig, w, c_orig))
        return rec

    def _decode_plan(self, sig: Tuple, cb: int,
                     srcs: Tuple[int, ...], want_rows: Tuple[int, ...],
                     backend, mesh) -> DecodeShardingPlan:
        _chips, _cap, donate_opt = self._opts()
        donate = donate_opt and mesh.platform != "cpu"
        key = ("decode", sig, cb, srcs, want_rows, donate)
        pc = mesh_decode_perf_counters()
        with self._lock:
            plan = self._plans.get(key)
            if plan is not None and plan.mesh is mesh:
                plan.hits += 1
                pc.inc(l_mdec_plan_hits)
                return plan
        from ..gf.matrices import gf_invert_matrix
        from ..gf.tables import expand_to_bitmatrix
        inv = gf_invert_matrix(backend.matrix[list(srcs), :])
        bits_np = expand_to_bitmatrix(
            inv[list(want_rows), :]).astype(np.uint8)
        plan = DecodeShardingPlan(key, mesh, bits_np, donate)
        with self._lock:
            self._plans[key] = plan
        pc.inc(l_mdec_plan_builds)
        return plan

    def _decode_rateless_plan(self, plan: DecodeShardingPlan, mesh):
        """The decode plan's rateless geometry — the decode bit-matrix
        in a RatelessPlan, cached on the plan entry like the encode
        twin (same lifetime, same membership invalidation)."""
        from .rateless import RatelessCoder, RatelessPlan
        n_sys, n_parity = RatelessCoder.tasks_for(mesh.size)
        with self._lock:
            cached = plan.rateless
            if cached is not None and cached[0] == n_parity:
                return cached[1]
        rplan = RatelessPlan(plan.key, n_sys, n_parity, plan.bits_np)
        with self._lock:
            plan.rateless = (n_parity, rplan)
        return rplan

    def _account_decode(self, mesh, s_total: int, s_pad: int,
                        nbytes: int,
                        chip_real: Optional[Dict[int, int]],
                        repair: bool) -> None:
        """Decode-side occupancy: the ``mesh_decode_*`` counters plus
        the 2-D ``mesh_decode_chip_occupancy_histogram`` and the
        per-chip table's decode columns — the same receipt surfaces
        the encode path feeds, kept separable so a degraded-read storm
        is visible as READ work."""
        pc = mesh_decode_perf_counters()
        pc.inc(l_mdec_dispatches)
        pc.inc(l_mdec_stripes, s_total)
        pc.inc(l_mdec_pad_stripes, s_pad - s_total)
        pc.inc(l_mdec_bytes, nbytes)
        if repair:
            pc.inc(l_mdec_repair_solves)
        rows = s_pad // mesh.size
        hist = g_perf_histograms.get(
            "mesh", "mesh_decode_chip_occupancy_histogram",
            chip_occupancy_axes)
        devices = mesh.members
        with self._lock:
            for i in range(mesh.size):
                if chip_real is not None:
                    real = int(chip_real.get(i, 0))
                else:
                    real = min(max(s_total - i * rows, 0), rows)
                hist.inc(real, i)
                c = self._chips.get(i)
                if c is None:
                    c = self._chips[i] = self._chip_row(devices[i])
                c["decode_stripes"] += real
                c["decode_dispatches"] += 1

    @staticmethod
    def _chip_row(device) -> Dict[str, int]:
        """One per-chip totals row: encode and decode columns side by
        side, so the occupancy receipt shows BOTH kinds of work a chip
        carried."""
        return {"stripes": 0, "dispatches": 0,
                "decode_stripes": 0, "decode_dispatches": 0,
                "device": str(device)}

    def _encode(self, sig: Tuple, backend, stripes_list, bucket_c: int
                ) -> np.ndarray:
        from .rateless import rateless_opts
        mesh = self.topology()
        plan = self._plan(sig, bucket_c, backend, mesh)
        k = backend.k
        s_total = sum(int(st.shape[0]) for st in stripes_list)
        s_pad = self._pad_rows(s_total, mesh.size)
        pc = mesh_perf_counters()
        buf, pooled = self._pool.acquire((s_pad, k, bucket_c))
        pc.inc(l_mesh_pool_hits if pooled else l_mesh_pool_misses)
        chip_real = None
        try:
            # assembly: every request's rows land directly in the
            # padded staging buffer — the old path's pad_cols + stack
            # + pad_stripes chain (up to three accounted copies)
            # collapses into ONE
            off = 0
            nbytes = 0
            for st in stripes_list:
                s_i, _k, c_i = st.shape
                buf[off:off + s_i, :, :c_i] = st
                off += s_i
                nbytes += st.nbytes
            g_devprof.account_host_copy("mesh.assemble", buf.nbytes)
            from ..common.kernel_trace import g_kernel_timer
            from .chipstat import g_chipstat
            # sampled fenced probe (chipstat.py): every Nth flush the
            # coalesced output is drained one element per chip BEFORE
            # the full materialization, so each chip's completion
            # delta lands on the skew scoreboard; off (the default
            # cadence counter not due) this is one int check
            probe = g_chipstat.should_probe()
            if rateless_opts()[0]:
                # rateless coded path (rateless.py): over-decomposed
                # per-chip block calls, subset completion, h2d/d2h
                # accounted per block inside the coder; on probe
                # flushes the drain itself feeds the scoreboard
                rplan = self._rateless_plan(sig, bucket_c, plan,
                                            backend, mesh)
                with g_devprof.stage("mesh.encode"):
                    coding, chip_real = g_kernel_timer.timed(
                        "ec_encode_batch_mesh_rateless",
                        lambda: self._rateless.encode(
                            plan, rplan, buf, mesh, probe, s_total))
            else:
                g_devprof.account_h2d("mesh.encode", buf.nbytes)
                with g_devprof.stage("mesh.encode"):
                    # the gather of every member's rows to the host is
                    # the completion fence (the bench twin drains per
                    # member via parallel.drain_sharded)
                    coding = g_kernel_timer.timed(
                        "ec_encode_batch_mesh", plan.run, buf, probe)
                g_devprof.account_d2h("mesh.encode", coding.nbytes)
        finally:
            # release on failure too: a failed flush must not leak its
            # staging buffer
            self._pool.release(buf)
        self._account_chips(mesh, s_total, s_pad,
                            len(stripes_list), nbytes,
                            chip_real=chip_real)
        return coding

    def _rateless_plan(self, sig: Tuple, bucket_c: int, plan, backend,
                       mesh):
        """The plan-cache entry's rateless geometry, (re)built when
        ``ec_mesh_rateless_tasks`` changes the block count — built
        alongside the encode bit-matrix, same lifetime."""
        from ..gf.tables import expand_to_bitmatrix
        from .rateless import RatelessCoder, RatelessPlan
        n_sys, n_parity = RatelessCoder.tasks_for(mesh.size)
        with self._lock:
            cached = plan.rateless
            if cached is not None and cached[0] == n_parity:
                return cached[1]
        bits_np = expand_to_bitmatrix(
            backend.matrix[backend.k:]).astype(np.uint8)
        rplan = RatelessPlan((sig, bucket_c), n_sys, n_parity, bits_np)
        with self._lock:
            plan.rateless = (n_parity, rplan)
        return rplan

    @staticmethod
    def _pad_rows(s: int, mesh_size: int) -> int:
        """Batch-axis pad target: the next power of two (O(log S) jit
        cache, like the single-device stripe pad) rounded up to a
        mesh-size multiple (equal row slices per chip)."""
        from ..dispatch.signature import next_pow2
        p = max(next_pow2(max(s, 1)), mesh_size)
        return ((p + mesh_size - 1) // mesh_size) * mesh_size

    def _plan(self, sig: Tuple, bucket_c: int, backend, mesh
              ) -> ShardingPlan:
        _chips, _cap, donate_opt = self._opts()
        donate = donate_opt and mesh.platform != "cpu"
        # the donate flag is part of the key, so toggling
        # ec_mesh_donate takes effect on the next flush instead of
        # waiting for a topology rebuild
        key = (sig, bucket_c, donate)
        with self._lock:
            plan = self._plans.get(key)
            if plan is not None and plan.mesh is mesh:
                plan.hits += 1
                mesh_perf_counters().inc(l_mesh_plan_hits)
                return plan
        plan = ShardingPlan(mesh, backend, donate)
        with self._lock:
            self._plans[key] = plan
        mesh_perf_counters().inc(l_mesh_plan_builds)
        return plan

    def _account_chips(self, mesh, s_total: int, s_pad: int,
                       n_reqs: int, nbytes: int,
                       chip_real: Optional[Dict[int, int]] = None
                       ) -> None:
        """Per-chip occupancy: *chip_real* (the rateless path's
        scoreboard-weighted placement) when given, else the SPMD
        path's contiguous block-sharded layout."""
        pc = mesh_perf_counters()
        pc.inc(l_mesh_dispatches)
        pc.inc(l_mesh_reqs, n_reqs)
        pc.inc(l_mesh_stripes, s_total)
        pc.inc(l_mesh_pad_stripes, s_pad - s_total)
        pc.inc(l_mesh_bytes, nbytes)
        rows = s_pad // mesh.size
        hist = self._hist
        devices = mesh.members
        with self._lock:
            for i in range(mesh.size):
                if chip_real is not None:
                    real = int(chip_real.get(i, 0))
                else:
                    real = min(max(s_total - i * rows, 0), rows)
                hist.inc(real, i)
                c = self._chips.get(i)
                if c is None:
                    c = self._chips[i] = self._chip_row(devices[i])
                c["stripes"] += real
                c["dispatches"] += 1

    # ---- introspection -----------------------------------------------------
    def per_chip(self) -> Dict[int, Dict[str, int]]:
        """Per-chip totals (copy) — the occupancy receipt the bench and
        the tier-1 mesh smoke read before/after a batched write."""
        with self._lock:
            return {i: dict(v) for i, v in sorted(self._chips.items())}

    def dump(self) -> Dict:
        chips, pool_cap, donate = self._opts()
        mesh = self.topology()
        with self._lock:
            plans = []
            for key, p in sorted(self._plans.items(),
                                 key=lambda kv: str(kv[0])):
                if key[0] == "decode":
                    plans.append({"kind": "decode",
                                  "signature": list(map(str, key[1])),
                                  "bucket_chunk_size": key[2],
                                  "srcs": list(key[3]),
                                  "want_rows": list(key[4]),
                                  "donated": p.donated,
                                  "hits": p.hits})
                else:
                    plans.append({"kind": "encode",
                                  "signature": list(map(str, key[0])),
                                  "bucket_chunk_size": key[1],
                                  "donated": p.donated,
                                  "hits": p.hits})
            transitions, hold = self._transitions, self._hold
            inflight = self._inflight
        from .chipstat import g_chipstat
        return {
            "options": {"ec_mesh_chips": chips,
                        "ec_mesh_pool_buffers": pool_cap,
                        "ec_mesh_donate": donate},
            "active": self.active(),
            "size": 0 if mesh is None else mesh.size,
            "axis": BATCH_AXIS,
            "per_chip": self.per_chip(),
            "plans": plans,
            "pool": self._pool.dump(),
            "counters": mesh_perf_counters().dump(),
            # the meshed READ path (decode/reconstruct/repair):
            # in-flight gauge the membership drain waits on, plus the
            # mesh_decode_* counter family
            "decode": {"inflight": inflight,
                       "counters": mesh_decode_perf_counters().dump()},
            # elastic membership (injectargs-live ec_mesh_chips):
            # transition count, the drain hold flag, and the
            # mesh_membership counter family
            "membership": {"transitions": transitions, "hold": hold,
                           "counters":
                               membership_perf_counters().dump()},
            # the rateless coded-encode pane (rateless.py): options,
            # coding geometry for the live mesh, and the
            # mesh_rateless_* counter family
            "rateless": self._rateless.dump(
                0 if mesh is None else mesh.size),
            # the chip-health scoreboard (chipstat.py): per-chip probe
            # EWMAs, skew ratios and suspects — the full table with
            # percentiles lives on `mesh skew dump`
            "skew": g_chipstat.summary(),
        }


# process-wide runtime, like g_dispatcher: one accelerator complex per
# process, shared by every daemon the mini-cluster hosts
g_mesh = MeshRuntime()
