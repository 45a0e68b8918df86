"""Rateless coded mesh encode — straggler-proof flushes.

Port of ``ceph_tpu/mesh/rateless.py``.  Each coded block is one K1
launch on its member's stream, and a block is complete when the CUDA
event its member recorded after the launch has fired (JAX's
``Array.is_ready``); on the CPU every block is ready when its call
returns.  The GF(2) solve over the first spanning blocks and the host
parity blocks are carried unchanged.  Not carried: the catch of a
failed launch or fetch (JAX erases the block); here it raises, and a
flush whose surviving blocks cannot span raises ``Insufficient`` to the
caller (JAX degrades the group to the single-device path).
``mesh.chip_fail``, chosen before the clock, still erases its chip's
blocks: an injected erasure is the algorithm's own input.

The block-sharded SPMD path (runtime.py) gives every chip exactly one
row slice of the flushed batch, so the SLOWEST chip gates the whole
flush: at production scale the p999 IS the straggler, and the
chip-health scoreboard (chipstat.py) is the ruler that proves it.
This module is the fix named in PAPERS.md — rateless codes for
near-perfect load balancing in distributed matrix-vector
multiplication (arXiv 1804.10331): over-decompose the coded work so a
slow or dead chip costs bandwidth, never latency; the XOR-EC
program-optimization results (arXiv 2108.02692) price the extra coded
rows as cheap next to the data movement the flush already pays.

How one flush runs (``ec_mesh_rateless``; off = the SPMD path):

- **over-decomposition**: the padded (S_pad, k, Cb) batch splits along
  the stripe axis into ``n_sys`` = mesh-size SYSTEMATIC row-blocks
  plus ``n_parity`` PARITY blocks (``ec_mesh_rateless_tasks`` total;
  0 = auto, mesh size + 2).  Each parity block is a GF(2^8)
  random-combination of the systematic blocks with nonzero
  coefficients drawn from a per-plan deterministic stream — and
  because the GF bit-matmul is GF(2^8)-linear, ``encode(Σ cᵢ⊗Xᵢ) =
  Σ cᵢ⊗encode(Xᵢ)``: a parity INPUT block's coding rows are the same
  combination of the systematic OUTPUT blocks, byte-exactly.
- **scoreboard-weighted placement**: blocks are assigned per chip
  using the chip-health scoreboard — SUSPECT chips get at most one parity
  block (parity-only keeps them probed so they can clear; zero
  critical blocks means their loss costs nothing) and never a
  systematic block; the telemetry finally actuates
  (``suspect_deweights``).
- **subset completion**: every chip launches, and the flush completes
  from the FIRST subset of blocks that spans the systematic space
  (incremental GF Gaussian elimination decides spanning as blocks
  complete, via the readiness-POLLING drain of chipstat.py — each
  member's CUDA event, order-free, no blocking wait).
  Missing systematic blocks are re-solved on the host from the coded
  blocks (``gf_invert_matrix`` over the chosen coefficient rows) —
  byte-identical by construction, GF arithmetic is exact.
- **failure = erasure**: a chip that fails mid-flush (fault site
  ``mesh.chip_fail``) just erases its blocks; the flush still
  completes whenever the surviving blocks span.  Only when they cannot
  does the encode raise.

Probe semantics (the ruler keeps working WITH the fix active): on
probe flushes the drain itself is the probe — each chip's completion
delta feeds the scoreboard through ``chipstat.record_deltas``.  A
chip still pending once the subset completed is polled a little
longer, up to ``CENSOR_MARGIN × threshold × median`` past launch:
completing inside that cap records its exact delta, still pending at
the cap records a CENSORED breach (the delta is provably at least the
cap — no fabricated breach can ever hit a merely-last healthy chip,
and no straggler escapes by being abandoned).  Chips already SUSPECT
are never waited for (their absence records nothing; clearing rides
the exact deltas their parity block produces once they heal), so the
cap-wait is paid only during the sustain window — the bounded
detection transient the straggler workload receipts.

``mesh.chip_slowdown`` gates real completion here (not just the probe
view): an armed delay holds the matching chip's blocks not-complete
until ``delay_us`` past launch, so the flush either routes around the
straggler (enough parity) or genuinely waits (not enough) — exactly
the production choice the over-decomposition knob buys.
"""
from __future__ import annotations

import time
import zlib

from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..common.config import g_conf
from ..common.lockdep import DebugLock
from ..common.perf_counters import PerfCounters, PerfCountersBuilder
from ..gf.matrices import gf_invert_matrix
from ..gf.tables import gf_mul_scalar
from ..trace.devprof import g_devprof
# the drain shares the probe's readiness-polling granularity
# (ChipStat.PROBE_POLL_S) and median rule — one tuning point, the two
# surfaces cannot drift
from .chipstat import ChipStat

# censored-breach margin: a chip still pending this far past
# threshold x the probe median has PROVEN its delta breaches with
# slack (the recorded EWMA ratio clears the threshold instead of
# riding its boundary); it also bounds the detection-window cap-wait
CENSOR_MARGIN = 1.25

# devprof call-sites for one rateless execution: (block h2d/d2h,
# parity assembly+h2d, host re-solve).  The coder is GF-matmul-generic
# — the SAME engine runs the encode bit-matrix and the inverted
# survivor (decode) bit-matrix — so the runtime passes the site triple
# matching the kind of work, keeping encode and decode bandwidth
# separable on the devflow ledger (the degraded-read workload's
# bandwidth_overhead reads the decode sites alone)
ENCODE_SITES = ("mesh.encode", "mesh.rateless_parity",
                "mesh.rateless_solve")
DECODE_SITES = ("mesh.decode", "mesh.decode_parity",
                "mesh.decode_solve")


# ---- perf counters (perf dump / Prometheus ceph_daemon_mesh_rateless_*) ----
RATELESS_FIRST = 98100
l_rl_flushes = 98101             # rateless-coded mesh flushes executed
l_rl_coded_tasks = 98102         # coded row-blocks launched (sys + parity)
l_rl_parity_tasks = 98103        # parity row-blocks launched
l_rl_wasted_blocks = 98104       # launched blocks never consumed
l_rl_subset_completions = 98105  # flushes completed before every block
l_rl_host_resolves = 98106       # systematic blocks re-solved on host
l_rl_suspect_deweights = 98107   # placement decisions that deweighted
                                 # a SUSPECT chip
l_rl_chip_failures = 98108       # chips erased mid-flush (fault/error)
l_rl_insufficient = 98109        # flushes whose survivors could not span
RATELESS_LAST = 98120

_rl_pc: Optional[PerfCounters] = None
_rl_pc_lock = DebugLock("mesh_rateless_pc::init")


def rateless_perf_counters() -> PerfCounters:
    """The rateless coder's counter logger (perf dump / Prometheus
    ``ceph_daemon_mesh_rateless_*``)."""
    global _rl_pc
    if _rl_pc is not None:
        return _rl_pc
    with _rl_pc_lock:
        if _rl_pc is None:
            b = PerfCountersBuilder("mesh_rateless", RATELESS_FIRST,
                                    RATELESS_LAST)
            b.add_u64_counter(l_rl_flushes, "flushes",
                              "rateless-coded mesh flushes executed")
            b.add_u64_counter(l_rl_coded_tasks, "coded_tasks",
                              "coded row-blocks launched (systematic "
                              "plus parity)")
            b.add_u64_counter(l_rl_parity_tasks, "parity_tasks",
                              "GF random-combination parity row-blocks "
                              "launched")
            b.add_u64_counter(l_rl_wasted_blocks, "wasted_blocks",
                              "launched blocks the subset completion "
                              "never consumed (the bandwidth price of "
                              "straggler protection)")
            b.add_u64_counter(l_rl_subset_completions,
                              "subset_completions",
                              "flushes completed from a strict subset "
                              "of their coded blocks")
            b.add_u64_counter(l_rl_host_resolves, "host_resolves",
                              "systematic output blocks re-solved on "
                              "the host from coded blocks")
            b.add_u64_counter(l_rl_suspect_deweights,
                              "suspect_deweights",
                              "placement decisions that gave a SUSPECT "
                              "chip parity-only or no blocks")
            b.add_u64_counter(l_rl_chip_failures, "chip_failures",
                              "chips whose blocks became erasures "
                              "mid-flush (mesh.chip_fail or a real "
                              "device error)")
            b.add_u64_counter(l_rl_insufficient, "insufficient",
                              "flushes whose surviving blocks could "
                              "not span (degraded to the single-"
                              "device path)")
            _rl_pc = b.create_perf_counters()
    return _rl_pc


def rateless_opts() -> Tuple[bool, int]:
    """(enabled, total coded tasks; 0 = auto) read live."""
    return (bool(g_conf.get_val("ec_mesh_rateless")),
            int(g_conf.get_val("ec_mesh_rateless_tasks") or 0))


class _GFBasis:
    """Incremental GF(2^8) Gaussian elimination over block coefficient
    vectors: decides — as blocks complete, in completion order —
    whether a block adds rank, and when the collected set spans the
    systematic space."""

    def __init__(self, n: int):
        self.n = n
        # pivot column -> row reduced+normalized to pivot coefficient 1
        self._rows: Dict[int, np.ndarray] = {}

    def _reduce(self, vec: np.ndarray) -> np.ndarray:
        v = vec.copy()
        for pivot, row in self._rows.items():
            c = int(v[pivot])
            if c:
                v ^= gf_mul_scalar(c, row)
        return v

    def admits(self, vec: np.ndarray) -> bool:
        """True when *vec* would increase the rank (pure check — an
        erased fetch must leave the basis untouched)."""
        return bool(self._reduce(vec).any())

    def add(self, vec: np.ndarray) -> bool:
        v = self._reduce(vec)
        nz = np.flatnonzero(v)
        if nz.size == 0:
            return False
        pivot = int(nz[0])
        from ..gf.tables import gf_inv
        self._rows[pivot] = gf_mul_scalar(gf_inv(int(v[pivot])), v)
        return True

    @property
    def rank(self) -> int:
        return len(self._rows)

    def spans(self) -> bool:
        return len(self._rows) >= self.n


class RatelessPlan:
    """The coding geometry for one sharding-plan cache entry: the
    parity coefficient matrix (deterministic per plan — the same
    stream every run, like the fault registry's seeded triggers) and
    the per-device replicas of the encode bit-matrix."""

    __slots__ = ("n_sys", "n_parity", "coeffs", "vectors", "_dev_bits",
                 "_bits_np", "_lock")

    def __init__(self, key, n_sys: int, n_parity: int, bits_np):
        self.n_sys = n_sys
        self.n_parity = n_parity
        rng = np.random.default_rng(
            zlib.crc32(repr((key, n_sys, n_parity)).encode()))
        # nonzero coefficients: every parity block touches every
        # systematic block, so any single missing systematic block is
        # recoverable from any surviving parity block
        self.coeffs = rng.integers(1, 256, size=(n_parity, n_sys),
                                   dtype=np.uint8)
        # block id -> coefficient vector over the systematic space
        eye = np.eye(n_sys, dtype=np.uint8)
        self.vectors = [eye[i] for i in range(n_sys)] + \
            [self.coeffs[j] for j in range(n_parity)]
        self._bits_np = bits_np
        self._dev_bits: Dict[int, object] = {}
        self._lock = DebugLock("RatelessPlan::dev_bits")

    def bits_for(self, device):
        """The bit-matrix on *device* (cached: one upload per device per
        plan; members that share a device share it)."""
        with self._lock:
            hit = self._dev_bits.get(device)
        if hit is not None:
            return hit
        from ..ops.gf_pallas import BitMatrix
        bits = BitMatrix(self._bits_np, device)
        with self._lock:
            self._dev_bits[device] = bits
        return bits


class _Block:
    """One coded row-block in flight on one chip."""

    __slots__ = ("bid", "chip", "vec", "out", "event", "member",
                 "erased", "systematic", "t_launch", "t_done", "t_ready")

    def __init__(self, bid: int, chip: int, vec: np.ndarray,
                 systematic: bool):
        self.bid = bid
        self.chip = chip
        self.vec = vec
        self.out = None          # the launched tensor, then its host copy
        self.event = None        # recorded on the member's stream
        self.member = None
        self.erased = False
        self.systematic = systematic
        self.t_launch = 0.0      # stamped at THIS block's dispatch
        self.t_done = None       # the CPU route: launch + its call's CPU time
        self.t_ready = 0.0       # stamped at readiness observation

    def elapsed_us(self, now: float) -> float:
        return (now - self.t_launch) * 1e6

    def ready_at(self, now: float, delay_until: Dict[int, float]) -> float:
        """When this block, observed ready at ``now``, completed: on the
        card the observation itself (its event fired since the last
        poll); on the CPU, where the launch loop runs each call to its
        end on the host thread before the drain polls, the later of its
        launch plus the CPU time its call took and the end of an
        injected hold.  Stamping the observation there would charge
        every block the launch loop's later calls, and stamping the
        call's return would charge it the time a loaded host gave other
        processes."""
        if self.t_done is None:
            return now
        return max(self.t_done,
                   self.t_launch + delay_until.get(self.chip, 0.0) / 1e6)


class RatelessCoder:
    """The mesh runtime's rateless execution engine (one per runtime;
    plans ride the runtime's sharding-plan cache entries)."""

    class Insufficient(RuntimeError):
        """Fewer than a sufficient subset of chips answered: raised to
        the caller (the port has no single-device fallback)."""

    @staticmethod
    def tasks_for(mesh_size: int) -> Tuple[int, int]:
        """(n_sys, n_parity) for the live options: n_sys is always the
        mesh size (same row granularity as the SPMD path, so S_pad
        needs no new padding rule), parity is the over-decomposition.
        Auto (tasks=0) adds 2 parity blocks — any single chip's loss
        is coverable even when one parity block rode the lost chip,
        at 1 + 2/mesh-size bandwidth overhead."""
        _enabled, tasks = rateless_opts()
        n_sys = mesh_size
        if tasks <= 0:
            n_parity = 2
        else:
            n_parity = max(int(tasks) - n_sys, 1)
        return n_sys, n_parity

    # ---- placement ---------------------------------------------------------
    @staticmethod
    def assign(n_sys: int, n_parity: int, n_chips: int,
               suspects: Set[int], rotation: int) -> Dict[int, int]:
        """block id -> chip.  Healthy chips share the systematic
        blocks round-robin (rotated per flush so any extra load
        spreads); SUSPECT chips get at most ONE parity block each —
        parity-only keeps a suspect probed (it can prove itself clean
        and clear) while its loss costs nothing — and remaining parity
        lands on healthy chips as the actual redundancy."""
        healthy = [c for c in range(n_chips) if c not in suspects]
        if not healthy:          # every chip suspect: nothing to avoid
            healthy = list(range(n_chips))
        owner: Dict[int, int] = {}
        for b in range(n_sys):
            owner[b] = healthy[(b + rotation) % len(healthy)]
        sus = sorted(c for c in suspects if c < n_chips)
        slots: List[int] = [sus[(rotation + i) % len(sus)]
                            for i in range(min(len(sus), n_parity))]
        i = 0
        while len(slots) < n_parity:
            slots.append(healthy[(rotation + n_sys + i) % len(healthy)])
            i += 1
        for j in range(n_parity):
            owner[n_sys + j] = slots[j]
        return owner

    # ---- the flush ---------------------------------------------------------
    def encode(self, plan, rplan: RatelessPlan, buf: np.ndarray, mesh,
               probe: bool, s_total: int,
               sites: Tuple[str, str, str] = ENCODE_SITES
               ) -> Tuple[np.ndarray, Dict[int, int]]:
        """Run one rateless-coded flush over *buf* (S_pad, k, Cb);
        returns the coalesced coding rows (S_pad, m, Cb) —
        byte-identical to the single-device call — plus each chip's
        real (non-pad) systematic stripe count for the occupancy
        surfaces.  Raises Insufficient when the surviving blocks
        cannot span.

        The engine never reads the bit-matrix out of *plan* — only out
        of *rplan* — so it is generic over WHICH GF matmul it protects:
        the runtime's decode path hands it an inverted-survivor-matrix
        RatelessPlan plus the DECODE_SITES triple and gets the same
        subset-completion semantics on reconstruct/repair work."""
        import torch
        from ..fault import g_faults
        from ..ops.gf_pallas import gf_bit_matmul_kernel
        from .chipstat import g_chipstat, slowdown_delays

        pc = rateless_perf_counters()
        devices = mesh.members
        n_chips = len(devices)
        n_sys, n_parity = rplan.n_sys, rplan.n_parity
        rows = buf.shape[0] // n_sys
        suspects = g_chipstat.suspect_set()
        pc.inc(l_rl_flushes)
        if suspects:
            pc.inc(l_rl_suspect_deweights,
                   len([c for c in suspects if c < n_chips]))
        owner = self.assign(n_sys, n_parity, n_chips, suspects,
                            rotation=pc.get(l_rl_flushes) % max(n_chips,
                                                                1))
        # ---- per-chip fault decisions, once, before the clock starts ------
        # (slowdown decisions via chipstat's shared pass — the ctx
        # format and slowdowns_injected accounting cannot drift from
        # the SPMD probe's); chip_fail consults only chips that OWN
        # blocks this flush, so a deweighted chip never burns the
        # trigger's count= budget on a no-op
        delay_until = slowdown_delays(n_chips)
        failed: Set[int] = set()
        if g_faults.site_armed("mesh.chip_fail"):
            for c in sorted(set(owner.values())):
                if g_faults.should_fire("mesh.chip_fail",
                                        ctx=f"chip={c}/{n_chips}"):
                    failed.add(c)
        # ---- launch: suspects first (their parity is the clear probe),
        # then everything else in block order.  Each block stamps its
        # OWN launch time: per-chip service deltas must not charge one
        # chip the host parity-assembly time spent launching another
        blocks = [_Block(b, owner[b], rplan.vectors[b], b < n_sys)
                  for b in sorted(owner)]
        blocks.sort(key=lambda bl: (0 if bl.chip in suspects else 1,
                                    bl.bid))
        for bl in blocks:
            if bl.chip in failed:
                bl.erased = True
                continue
            if bl.systematic:
                src = buf[bl.bid * rows:(bl.bid + 1) * rows]
                g_devprof.account_h2d(sites[0], src.nbytes)
            else:
                src = self._parity_block(buf, rplan,
                                         bl.bid - n_sys, rows,
                                         sites[1])
                g_devprof.account_h2d(sites[1], src.nbytes)
            mem = devices[bl.chip]
            bl.member = mem
            with mem.launching():
                dev_in = torch.from_numpy(src).to(mem.device)
                bl.t_launch = time.perf_counter()
                cpu0 = time.thread_time()
                bl.out = gf_bit_matmul_kernel(
                    dev_in, rplan.bits_for(mem.device))
                bl.event = mem.record()
                if bl.event is None:
                    bl.t_done = bl.t_launch + (time.thread_time() - cpu0)
        # chip_failures counts CHIPS (the counter's contract); the
        # drain adds fetch-time failures for chips not already counted
        counted_chips = failed | {bl.chip for bl in blocks
                                  if bl.erased}
        if counted_chips:
            pc.inc(l_rl_chip_failures, len(counted_chips))
        pc.inc(l_rl_coded_tasks,
               sum(1 for bl in blocks if not bl.erased))
        pc.inc(l_rl_parity_tasks,
               sum(1 for bl in blocks
                   if not bl.erased and not bl.systematic))
        out = self._drain(blocks, n_sys, rows, buf.shape, probe,
                          suspects, delay_until, pc, counted_chips,
                          sites)
        # occupancy: real (non-pad) stripes per chip from the
        # scoreboard-weighted placement — the deweighting is visible
        # on the same per-chip surfaces the SPMD layout fed.  Erased
        # blocks credit nothing: a dead chip must read as idle on the
        # very surface that shows the flush routed around it
        chip_real = {c: 0 for c in range(n_chips)}
        for bl in blocks:
            if bl.systematic and not bl.erased:
                real = min(max(s_total - bl.bid * rows, 0), rows)
                chip_real[bl.chip] += real
        return out, chip_real

    @staticmethod
    def _parity_block(buf: np.ndarray, rplan: RatelessPlan, j: int,
                      rows: int, site: str) -> np.ndarray:
        """Parity input block j = Σᵢ cⱼᵢ ⊗ sys-blockᵢ on the host —
        the extra coded rows the over-decomposition pays for (h2d +
        one host pass; arXiv 2108.02692's accounting says this is the
        cheap part)."""
        acc = None
        for i in range(rplan.n_sys):
            term = gf_mul_scalar(int(rplan.coeffs[j, i]),
                                 buf[i * rows:(i + 1) * rows])
            acc = term if acc is None else acc ^ term
        g_devprof.account_host_copy(site, acc.nbytes)
        return acc

    # ---- the readiness-polling drain ---------------------------------------
    @staticmethod
    def _block_ready(bl: _Block, now: float,
                     delay_until: Dict[int, float]) -> bool:
        if bl.elapsed_us(now) < delay_until.get(bl.chip, 0.0):
            return False         # injected straggler: not complete yet
        return bl.event is None or bool(bl.event.query())

    def _drain(self, blocks: List[_Block], n_sys: int,
               rows: int, in_shape, probe: bool, suspects: Set[int],
               delay_until: Dict[int, float], pc,
               counted_chips: Set[int],
               sites: Tuple[str, str, str] = ENCODE_SITES
               ) -> np.ndarray:
        from .chipstat import g_chipstat

        basis = _GFBasis(n_sys)
        chosen: List[_Block] = []
        pending = [bl for bl in blocks if not bl.erased]
        # per-chip service bookkeeping (probe flushes feed the
        # scoreboard): a chip's delta is the LARGEST per-block
        # launch→ready time over its blocks, stamped at readiness
        # observation — BEFORE any fetch, so one chip's delta never
        # carries another block's d2h time or the launch loop's host
        # parity-assembly time (the order-free discipline the SPMD
        # probe polls for)
        chip_pending: Dict[int, int] = {}
        for bl in pending:
            chip_pending[bl.chip] = chip_pending.get(bl.chip, 0) + 1
        chip_done_us: Dict[int, float] = {}

        def sweep() -> None:
            # pass 1: stamp readiness (cheap polls, no fetches)
            ready: List[_Block] = []
            for bl in list(pending):
                now = time.perf_counter()
                if not self._block_ready(bl, now, delay_until):
                    continue
                bl.t_ready = bl.ready_at(now, delay_until)
                pending.remove(bl)
                ready.append(bl)
                chip_pending[bl.chip] -= 1
                if chip_pending[bl.chip] == 0:
                    chip_done_us[bl.chip] = max(
                        b.elapsed_us(b.t_ready) for b in blocks
                        if b.chip == bl.chip and not b.erased)
            # pass 2: fetch the rank-increasing completions
            for bl in ready:
                if basis.spans() or not basis.admits(bl.vec):
                    continue
                with bl.member.launching():
                    bl.out = bl.out.cpu().numpy()
                g_devprof.account_d2h(sites[0], bl.out.nbytes)
                basis.add(bl.vec)
                chosen.append(bl)

        # ---- phase 1: poll until the completed blocks span ----------------
        while True:
            sweep()
            if basis.spans() or not pending:
                break
            time.sleep(ChipStat.PROBE_POLL_S)
        if not basis.spans():
            pc.inc(l_rl_insufficient)
            if probe:
                g_chipstat.record_deltas(dict(chip_done_us))
            raise self.Insufficient(
                f"{basis.rank}/{n_sys} independent blocks from "
                f"surviving chips")
        # a subset completion is any flush that did not need every
        # coded block it assigned: blocks still in flight at spanning
        # (the straggler case) OR blocks erased outright (the dead-chip
        # case — whose survivors may well all be done by now)
        subset = bool(pending) or any(bl.erased for bl in blocks)
        if subset:
            pc.inc(l_rl_subset_completions)
        pc.inc(l_rl_wasted_blocks,
               sum(1 for bl in blocks if not bl.erased
                   and bl not in chosen))
        out = self._solve(chosen, n_sys, rows, in_shape, pc, sites[2])
        # ---- phase 2 (probe flushes): finish the per-chip observation -----
        if probe:
            self._observe_stragglers(pending, suspects, delay_until,
                                     chip_done_us)
            g_chipstat.record_deltas(chip_done_us)
        return out

    def _observe_stragglers(self, pending: List[_Block],
                            suspects: Set[int],
                            delay_until: Dict[int, float],
                            chip_done_us: Dict[int, float]) -> None:
        """Bounded post-subset observation, probe flushes only: chips
        completing inside CENSOR_MARGIN × threshold × median record
        exact per-block service deltas; a NON-suspect chip whose every
        pending block has waited past that cap records a censored
        breach (its delta is provably >= the cap); suspect chips are
        never waited for — no record, stickiness by absence, clearing
        rides the exact deltas their parity block produces once they
        heal."""
        from .chipstat import g_chipstat

        if not pending:
            return
        _every, threshold = g_chipstat._opts()
        med = ChipStat._median(chip_done_us.values())
        if threshold <= 0 or med <= 0:
            return
        cap_us = CENSOR_MARGIN * threshold * med
        while True:
            for bl in list(pending):
                now = time.perf_counter()
                if self._block_ready(bl, now, delay_until):
                    bl.t_ready = bl.ready_at(now, delay_until)
                    pending.remove(bl)
                    if all(p.chip != bl.chip for p in pending):
                        chip_done_us.setdefault(
                            bl.chip, bl.elapsed_us(bl.t_ready))
            waiting = {bl.chip for bl in pending} - suspects
            if not waiting:
                break
            # censor once every waiting chip's LEAST-waited pending
            # block has provably breached the cap
            now = time.perf_counter()
            floors = {chip: min(bl.elapsed_us(now) for bl in pending
                                if bl.chip == chip)
                      for chip in waiting}
            if all(v >= cap_us for v in floors.values()):
                for chip, v in floors.items():
                    chip_done_us[chip] = max(v, cap_us)
                break
            time.sleep(ChipStat.PROBE_POLL_S)

    # ---- the host twin re-solve --------------------------------------------
    @staticmethod
    def _solve(chosen: List[_Block], n_sys: int, rows: int, in_shape,
               pc, site: str = ENCODE_SITES[2]) -> np.ndarray:
        """Reassemble the (S_pad, m, Cb) coding rows from the chosen
        spanning set: present systematic blocks land directly, missing
        ones are re-solved as E = A⁻¹ Y over GF(2^8) — exact
        arithmetic, so byte-identical to the single-device call by
        construction."""
        s_pad = in_shape[0]
        m = chosen[0].out.shape[1]
        cb = chosen[0].out.shape[2]
        out = np.empty((s_pad, m, cb), dtype=np.uint8)
        present = {bl.bid for bl in chosen if bl.systematic}
        for bl in chosen:
            if bl.systematic:
                out[bl.bid * rows:(bl.bid + 1) * rows] = bl.out
        missing = [i for i in range(n_sys) if i not in present]
        if missing:
            a = np.stack([bl.vec for bl in chosen])
            inv = gf_invert_matrix(a)
            for i in missing:
                acc = None
                for b, bl in enumerate(chosen):
                    c = int(inv[i, b])
                    if c == 0:
                        continue
                    term = gf_mul_scalar(c, bl.out)
                    acc = term if acc is None else acc ^ term
                out[i * rows:(i + 1) * rows] = acc
                g_devprof.account_host_copy(site, acc.nbytes)
            pc.inc(l_rl_host_resolves, len(missing))
        return out

    # ---- introspection -----------------------------------------------------
    @staticmethod
    def dump(mesh_size: int = 0) -> Dict:
        enabled, tasks = rateless_opts()
        out: Dict = {
            "options": {"ec_mesh_rateless": enabled,
                        "ec_mesh_rateless_tasks": tasks},
            "counters": rateless_perf_counters().dump(),
        }
        if mesh_size > 1:
            n_sys, n_parity = RatelessCoder.tasks_for(mesh_size)
            out["n_sys"] = n_sys
            out["n_parity"] = n_parity
        return out
