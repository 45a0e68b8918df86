"""The mgr's damped feedback controller: SLO streaks in, ONE bounded
knob step out (docs/CONTROL.md).

The observability layers built both halves of a control loop and
never connected them: the telemetry SLO burn-rate engine
(``TPU_SLO_*`` sustain/clear hysteresis) is a sensor, and the QoS/recovery/mesh options —
``osd_mclock_*``, ``osd_op_queue_admission_max``,
``osd_recovery_max_active``, ``ec_mesh_rateless_tasks`` — are
actuators that all take live config injection.  This module is the
wire between them: :meth:`Controller.step` runs once per mgr tick
(after ``Telemetry.tick`` so the streak state is fresh) and actuates
AT MOST one bounded step per tick on the one knob its policy map
holds responsible, through the SAME ``set_checked`` path injectargs
uses, so every daemon sees the move exactly as if an operator typed
it.

Stability is structural, not tuned:

- every knob has a floor and a ceiling (built-in, operator-overridable
  via ``mgr_control_bounds``) and a move is clamped into them;
- a knob rests ``mgr_control_cooldown_ticks`` after any move —
  at most one step per cooldown window per knob;
- successive same-direction steps shrink geometrically
  (``mgr_control_damping``), so a persistent breach converges on a
  value instead of slamming between bounds;
- a step clamped into the value it started from is NOT a move
  (anti-windup: a breach pinning a knob at its bound accrues no
  ledger entries, no cooldowns, no state);
- the first tighten on a knob records the pre-episode baseline; when
  the pressure clears (the check's own clear hysteresis) the
  controller walks the knob back toward that baseline, and disabling
  the controller mid-episode restores every engaged knob immediately
  (tear-down) — no half-applied knob survives ``mgr_control_enable
  = false``.

With ``mgr_control_enable`` off (the default) :meth:`Controller.step`
returns before sensing anything: the mgr is today's observer by
construction, not by configuration distance.

Port of ``ceph_tpu/control/controller.py``.  The mesh reads (the
rateless knob's bounds, the rateless sense and the straggler reflex)
read the port's mesh runtime (``mesh/``) as the JAX controller reads
its own.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from ..common.config import g_conf
from ..common.lockdep import DebugLock
from ..common.perf_counters import PerfCounters, PerfCountersBuilder
from ..trace.journal import g_journal

# wasted coded blocks per launched block (per sense window) above
# which the rateless width is judged uneconomical while skew is quiet;
# the healthy parity fraction at the auto width (~2/(size+2)) sits
# below it, so narrowing only triggers on widened-but-idle protection
WASTE_RATIO_MAX = 0.30
# consecutive controller ticks a skew / waste signal must hold before
# the straggler reflex moves (its own sustain hysteresis — the mesh
# health check flaps more than a width decision should)
STRAGGLER_STREAK = 2

# ---- perf counters (perf dump / Prometheus ceph_daemon_control_*) ----
CONTROL_FIRST = 94000
l_ctl_ticks = 94001              # enabled controller evaluations
l_ctl_moves = 94002              # actuations applied (any direction)
l_ctl_tightens = 94003           # breach-direction moves
l_ctl_restores = 94004           # toward-baseline moves (episode decay)
l_ctl_pinned = 94005             # steps suppressed at a bound
l_ctl_retries = 94006            # actuation re-attempts within a tick
l_ctl_failures = 94007           # actuations dropped past the retry budget
l_ctl_episodes = 94008           # episodes opened (first tighten on a knob)
l_ctl_reverts = 94009            # knobs restored by disable/reset tear-down
l_ctl_skipped_cooldown = 94010   # reflex wishes parked by a resting knob
l_ctl_engaged = 94011            # gauge: knobs currently off-baseline
l_ctl_enabled = 94012            # gauge: master enable as last evaluated
CONTROL_LAST = 94020

_ctl_pc: Optional[PerfCounters] = None
_ctl_pc_lock = DebugLock("control_pc::init")


def control_perf_counters() -> PerfCounters:
    """The control plane's counter logger (perf dump / Prometheus
    ``ceph_daemon_control_*``)."""
    global _ctl_pc
    if _ctl_pc is not None:
        return _ctl_pc
    with _ctl_pc_lock:
        if _ctl_pc is None:
            b = PerfCountersBuilder("control", CONTROL_FIRST,
                                    CONTROL_LAST)
            b.add_u64_counter(l_ctl_ticks, "ticks",
                              "controller evaluations while enabled")
            b.add_u64_counter(l_ctl_moves, "moves",
                              "bounded knob actuations applied")
            b.add_u64_counter(l_ctl_tightens, "tightens",
                              "breach-direction moves")
            b.add_u64_counter(l_ctl_restores, "restores",
                              "toward-baseline moves after a clear")
            b.add_u64_counter(l_ctl_pinned, "pinned",
                              "steps suppressed because the knob sits "
                              "at its bound (anti-windup)")
            b.add_u64_counter(l_ctl_retries, "actuate_retries",
                              "actuation re-attempts within one tick "
                              "(fault site control.actuate)")
            b.add_u64_counter(l_ctl_failures, "actuate_failures",
                              "actuations dropped after the bounded "
                              "retry budget")
            b.add_u64_counter(l_ctl_episodes, "episodes",
                              "control episodes opened (first tighten "
                              "records the baseline)")
            b.add_u64_counter(l_ctl_reverts, "teardown_reverts",
                              "knobs restored to baseline by disable/"
                              "reset tear-down")
            b.add_u64_counter(l_ctl_skipped_cooldown, "skipped_cooldown",
                              "reflex wishes parked because the "
                              "responsible knob was resting")
            b.add_u64(l_ctl_engaged, "engaged_knobs",
                      "knobs currently moved off their episode "
                      "baseline")
            b.add_u64(l_ctl_enabled, "enabled",
                      "master enable as last evaluated by a tick")
            _ctl_pc = b.create_perf_counters()
    return _ctl_pc


class _Move:
    __slots__ = ("knob", "cur", "new", "restore", "reflex", "reason")

    def __init__(self, knob: str, cur: float, new: float, restore: bool,
                 reflex: str, reason: str):
        self.knob = knob
        self.cur = cur
        self.new = new
        self.restore = restore
        self.reflex = reflex
        self.reason = reason


class _Knob:
    """One controlled dial: how to read its live value, how to encode
    a new value into a config injection, its built-in bounds, and its
    step shape.  ``kind``:

    - ``"int"`` / ``"float"``: multiplicative half-steps
      (``cur * 0.5 * scale`` with the episode's damping scale);
    - ``"unit"``: +-1 per move (the rateless width — already minimal);
    - ``"cap"``: like ``float`` but 0 means uncapped, and the first
      tighten IMPOSES the cap at the ceiling.
    """

    __slots__ = ("name", "kind", "floor", "ceiling", "get", "encode")

    def __init__(self, name: str, kind: str,
                 floor: Callable[["Controller"], Optional[float]],
                 ceiling: Callable[["Controller"], Optional[float]],
                 get: Callable[["Controller"], Optional[float]],
                 encode: Callable[["Controller", float],
                                  Tuple[str, Any]]):
        self.name = name
        self.kind = kind
        self.floor = floor
        self.ceiling = ceiling
        self.get = get
        self.encode = encode


def _parse_triples(src: str) -> Dict[str, Tuple[float, float, float]]:
    """'key:a:b:c[,key:...]' -> {key: (a, b, c)}; malformed entries
    are dropped (the same tolerance the dmClock parsers apply)."""
    out: Dict[str, Tuple[float, float, float]] = {}
    for part in str(src or "").replace(";", ",").split(","):
        part = part.strip()
        if not part:
            continue
        bits = part.rsplit(":", 3)
        if len(bits) != 4:
            continue
        try:
            out[bits[0]] = (float(bits[1]), float(bits[2]),
                            float(bits[3]))
        except ValueError:
            continue
    return out


def _encode_triples(d: Dict[str, Tuple[float, float, float]]) -> str:
    return ",".join(f"{k}:{v[0]:g}:{v[1]:g}:{v[2]:g}"
                    for k, v in sorted(d.items()))


def _client_defaults() -> Tuple[float, float, float]:
    return (float(g_conf.get_val("osd_mclock_client_reservation")),
            float(g_conf.get_val("osd_mclock_client_weight")),
            float(g_conf.get_val("osd_mclock_client_limit")))


def _client_overrides() -> Dict[str, Tuple[float, float, float]]:
    return _parse_triples(g_conf.get_val("osd_mclock_client_overrides"))


def _abuser_lane(ctrl: "Controller") -> Optional[str]:
    return ctrl._abuser


def _get_lane_field(ctrl: "Controller", field: int) -> Optional[float]:
    lane = _abuser_lane(ctrl)
    if lane is None:
        return None
    return _client_overrides().get(lane, _client_defaults())[field]


def _encode_lane_field(ctrl: "Controller", field: int,
                       value: float) -> Tuple[str, Any]:
    lane = _abuser_lane(ctrl)
    ov = _client_overrides()
    cur = list(ov.get(lane, _client_defaults()))
    cur[field] = value
    ov[lane] = (cur[0], cur[1], cur[2])
    return "osd_mclock_client_overrides", _encode_triples(ov)


def _recovery_class_tags() -> Tuple[float, float, float]:
    from ..common.work_queue import CLASS_RECOVERY, DEFAULT_TAGS
    ov = _parse_triples(g_conf.get_val("osd_mclock_class_overrides"))
    return ov.get(CLASS_RECOVERY, DEFAULT_TAGS[CLASS_RECOVERY])


def _encode_recovery_weight(ctrl: "Controller",
                            value: float) -> Tuple[str, Any]:
    from ..common.work_queue import CLASS_RECOVERY
    ov = _parse_triples(g_conf.get_val("osd_mclock_class_overrides"))
    res, _w, lim = _recovery_class_tags()
    ov[CLASS_RECOVERY] = (res, value, lim)
    return "osd_mclock_class_overrides", _encode_triples(ov)


def _mesh_size() -> Optional[int]:
    from ..mesh import g_mesh
    mesh = g_mesh.topology()
    return mesh.size if mesh is not None else None


def _get_rateless_tasks(ctrl: "Controller") -> Optional[float]:
    opt = int(g_conf.get_val("ec_mesh_rateless_tasks") or 0)
    if opt > 0:
        return float(opt)
    size = _mesh_size()
    return float(size + 2) if size else None


def _opt_get(name: str) -> Callable[["Controller"], Optional[float]]:
    return lambda _ctrl: float(g_conf.get_val(name) or 0)


def _opt_encode(name: str, cast) -> Callable[["Controller", float],
                                             Tuple[str, Any]]:
    return lambda _ctrl, v: (name, cast(v))


CONTROL_KNOBS: Dict[str, _Knob] = {
    # -- admission / abusive-client reflex --------------------------------
    "client_lane_weight": _Knob(
        "client_lane_weight", "float",
        floor=lambda _c: 0.05, ceiling=lambda _c: 100.0,
        get=lambda c: _get_lane_field(c, 1),
        encode=lambda c, v: _encode_lane_field(c, 1, v)),
    "client_lane_limit": _Knob(
        "client_lane_limit", "cap",
        floor=lambda _c: 20.0, ceiling=lambda _c: 500.0,
        get=lambda c: _get_lane_field(c, 2),
        encode=lambda c, v: _encode_lane_field(c, 2, v)),
    "osd_op_queue_admission_max": _Knob(
        "osd_op_queue_admission_max", "int",
        floor=lambda _c: 8, ceiling=lambda _c: 4096,
        get=_opt_get("osd_op_queue_admission_max"),
        encode=_opt_encode("osd_op_queue_admission_max", int)),
    # -- recovery-vs-client reflex ----------------------------------------
    "osd_recovery_max_active": _Knob(
        "osd_recovery_max_active", "int",
        floor=lambda _c: 1, ceiling=lambda _c: 64,
        get=_opt_get("osd_recovery_max_active"),
        encode=_opt_encode("osd_recovery_max_active", int)),
    "recovery_class_weight": _Knob(
        "recovery_class_weight", "float",
        floor=lambda _c: 10.0, ceiling=lambda _c: 400.0,
        get=lambda _c: _recovery_class_tags()[1],
        encode=_encode_recovery_weight),
    # -- straggler economics reflex ---------------------------------------
    "ec_mesh_rateless_tasks": _Knob(
        "ec_mesh_rateless_tasks", "unit",
        floor=lambda _c: (lambda s: s + 1 if s else None)(_mesh_size()),
        ceiling=lambda _c: (lambda s: 2 * s if s else None)(_mesh_size()),
        get=_get_rateless_tasks,
        encode=_opt_encode("ec_mesh_rateless_tasks", int)),
}

# deterministic evaluation/restore order: the reflex priority order
KNOB_ORDER = ("client_lane_weight", "client_lane_limit",
              "osd_op_queue_admission_max", "osd_recovery_max_active",
              "recovery_class_weight", "ec_mesh_rateless_tasks")

# which pressure signal must be CLEAR before a knob restores toward
# its baseline (the rateless width has no restore: the waste-economics
# narrowing is its decay path)
_CLEAR_GROUP = {
    "client_lane_weight": "adm_breach",
    "client_lane_limit": "adm_breach",
    "osd_op_queue_admission_max": "adm_breach",
    "osd_recovery_max_active": "oplat_breach",
    "recovery_class_weight": "oplat_breach",
}


class Controller:
    """The damped SLO feedback controller driven off ``Manager.tick``.

    One instance per Manager; all state is in-memory and resets with
    the mgr (a restored cluster starts with a quiet controller — the
    config it would have restored is already persisted in g_conf)."""

    def __init__(self):
        self._tick = 0
        self._knobs: Dict[str, Dict[str, Any]] = {}
        self._ledger: Deque[Dict[str, Any]] = deque()
        self._abuser: Optional[str] = None
        self._last_qw: Optional[Dict[str, int]] = None
        self._last_recovery: Optional[int] = None
        self._last_rateless: Optional[Tuple[int, int]] = None
        self._skew_streak = 0
        self._waste_streak = 0
        self._moves_total = 0

    # ---- options --------------------------------------------------------
    def _opts(self) -> Dict[str, Any]:
        return {
            "enable": bool(g_conf.get_val("mgr_control_enable")),
            "cooldown": max(0, int(
                g_conf.get_val("mgr_control_cooldown_ticks"))),
            "damping": min(1.0, max(0.01, float(
                g_conf.get_val("mgr_control_damping")))),
            "ledger": max(1, int(
                g_conf.get_val("mgr_control_ledger_size"))),
            "retries": max(0, int(
                g_conf.get_val("mgr_control_actuate_retries"))),
            "bounds": _parse_bounds(
                g_conf.get_val("mgr_control_bounds")),
        }

    def _bounds(self, knob: str,
                opts: Dict[str, Any]) -> Tuple[Optional[float],
                                               Optional[float]]:
        spec = CONTROL_KNOBS[knob]
        floor, ceiling = spec.floor(self), spec.ceiling(self)
        op = opts["bounds"].get(knob)
        if op is not None:
            floor = op[0] if op[0] is not None else floor
            ceiling = op[1] if op[1] is not None else ceiling
        return floor, ceiling

    def _state(self, knob: str) -> Dict[str, Any]:
        st = self._knobs.get(knob)
        if st is None:
            st = self._knobs[knob] = {"cooldown": 0, "scale": 1.0,
                                      "dir": 0, "baseline": None,
                                      "moves": 0}
        return st

    # ---- the tick -------------------------------------------------------
    def step(self, mgr, now: float = 0.0) -> None:
        """Runs every mgr tick, after Telemetry.tick.  Disabled =
        return before sensing (the twin-cluster property: an off
        controller is bit-identical to no controller), except that a
        disable LANDING mid-episode tears the episode down first."""
        opts = self._opts()
        if not opts["enable"]:
            if any(st["baseline"] is not None
                   for st in self._knobs.values()):
                self.teardown(mgr, reason="mgr_control_enable off")
            return
        pc = control_perf_counters()
        pc.set(l_ctl_enabled, 1)
        self._tick += 1
        pc.inc(l_ctl_ticks)
        for st in self._knobs.values():
            if st["cooldown"] > 0:
                st["cooldown"] -= 1
        sig = self._sense(mgr)
        move = None
        for reflex in (self._admission_reflex, self._recovery_reflex,
                       self._straggler_reflex, self._restore_reflex):
            move = reflex(sig, opts)
            if move is not None:
                break
        if move is not None:
            self._actuate(mgr, move, opts, now)
        pc.set(l_ctl_engaged,
               sum(1 for st in self._knobs.values()
                   if st["baseline"] is not None))

    # ---- sensors --------------------------------------------------------
    def _sense(self, mgr) -> Dict[str, Any]:
        slo = mgr.telemetry.slo_state()

        def breach(check: str) -> bool:
            st = slo.get(check)
            return bool(st and st.get("state") == "breach")

        from ..mgr.telemetry import SLO_ADMISSION, SLO_OPLAT
        sig: Dict[str, Any] = {
            "adm_breach": breach(SLO_ADMISSION),
            "oplat_breach": breach(SLO_OPLAT),
        }
        # recovery storm: repair activity since the last tick, or
        # rounds in flight right now
        from ..recovery import recovery_perf_counters
        rd = recovery_perf_counters().dump()
        rsum = int(rd.get("repair_rounds", 0)) \
            + int(rd.get("fullstripe_rounds", 0)) \
            + int(rd.get("push_bytes", 0))
        sig["storm"] = bool(rd.get("active", 0)) or (
            self._last_recovery is not None
            and rsum > self._last_recovery)
        self._last_recovery = rsum
        # straggler economics: mesh skew health vs wasted-block ratio
        from ..mesh import rateless_perf_counters
        rl = rateless_perf_counters().dump()
        wasted = int(rl.get("wasted_blocks", 0))
        coded = int(rl.get("coded_tasks", 0))
        waste_ratio = None
        if self._last_rateless is not None:
            dc = coded - self._last_rateless[1]
            if dc > 0:
                waste_ratio = (wasted - self._last_rateless[0]) / dc
        self._last_rateless = (wasted, coded)
        skew = "TPU_MESH_SKEW" in getattr(mgr, "health_checks", {})
        if skew:
            self._skew_streak += 1
            self._waste_streak = 0
        else:
            self._skew_streak = 0
            if waste_ratio is None:
                pass              # no coded traffic this tick: hold
            elif waste_ratio >= WASTE_RATIO_MAX:
                self._waste_streak += 1
            else:
                self._waste_streak = 0
        sig["skew_streak"] = self._skew_streak
        sig["waste_streak"] = self._waste_streak
        sig["abuser"] = self._sense_abuser()
        return sig

    def _sense_abuser(self) -> Optional[str]:
        """The client lane whose queue-wait histogram grew the most
        since the last tick — the dmClock tier's own per-entity ledger
        (osd.py registers one histogram per client lane).  Sticky: an
        episode keeps its abuser until its knobs restore.  The first
        enabled tick only BASELINES the counts (like the recovery and
        rateless sensors): history predating the controller must not
        read as one giant delta."""
        from ..trace import g_perf_histograms
        counts: Dict[str, int] = {}
        for (logger, name), h in g_perf_histograms.items():
            if name == "client_queue_wait_latency_histogram" \
                    and logger.startswith("client"):
                counts[logger] = counts.get(logger, 0) + h.total_count
        if self._last_qw is None:
            self._last_qw = counts
            return None
        best, best_delta = None, 0
        for lane in sorted(counts):
            delta = counts[lane] - self._last_qw.get(lane, 0)
            if delta > best_delta:
                best, best_delta = lane, delta
        self._last_qw = counts
        return best

    # ---- reflexes -------------------------------------------------------
    def _admission_reflex(self, sig, opts) -> Optional[_Move]:
        if not sig["adm_breach"]:
            return None
        if self._abuser is None:
            self._abuser = sig["abuser"]
        why = "TPU_SLO_ADMISSION burning"
        if self._abuser is not None:
            why += f"; abuser {self._abuser}"
            mv = self._tighten("client_lane_weight", "admission",
                               why, opts)
            if mv is not None:
                return mv
            mv = self._tighten("client_lane_limit", "admission",
                               why, opts)
            if mv is not None:
                return mv
        return self._tighten("osd_op_queue_admission_max", "admission",
                             why, opts)

    def _recovery_reflex(self, sig, opts) -> Optional[_Move]:
        if not (sig["oplat_breach"] and sig["storm"]):
            return None
        why = "TPU_SLO_OPLAT burning during a recovery storm"
        mv = self._tighten("osd_recovery_max_active", "recovery",
                           why, opts)
        if mv is not None:
            return mv
        return self._tighten("recovery_class_weight", "recovery",
                             why, opts)

    def _straggler_reflex(self, sig, opts) -> Optional[_Move]:
        from ..mesh.rateless import rateless_opts
        if not rateless_opts()[0]:
            return None
        if sig["skew_streak"] >= STRAGGLER_STREAK:
            return self._step("ec_mesh_rateless_tasks", +1, False,
                              "straggler",
                              f"TPU_MESH_SKEW sustained "
                              f"{sig['skew_streak']} ticks: widen",
                              opts)
        if sig["waste_streak"] >= STRAGGLER_STREAK:
            return self._step("ec_mesh_rateless_tasks", -1, False,
                              "straggler",
                              f"wasted_blocks ratio >= "
                              f"{WASTE_RATIO_MAX:g} with skew quiet "
                              f"{sig['waste_streak']} ticks: narrow",
                              opts)
        return None

    def _restore_reflex(self, sig, opts) -> Optional[_Move]:
        for knob in KNOB_ORDER:
            st = self._knobs.get(knob)
            if st is None or st["baseline"] is None:
                continue
            group = _CLEAR_GROUP.get(knob)
            if group is None or sig[group]:
                continue
            if st["cooldown"] > 0:
                control_perf_counters().inc(l_ctl_skipped_cooldown)
                continue
            spec = CONTROL_KNOBS[knob]
            cur = spec.get(self)
            if cur is None:
                continue
            base = st["baseline"]
            if cur == base:
                self._close_episode(knob)
                continue
            new = _halfway(spec.kind, cur, base)
            check = "TPU_SLO_ADMISSION" if group == "adm_breach" \
                else "TPU_SLO_OPLAT"
            return _Move(knob, cur, new, True, "restore",
                         f"{check} clear: restoring toward {base:g}")
        return None

    # ---- stepping -------------------------------------------------------
    def _tighten(self, knob: str, reflex: str, reason: str,
                 opts) -> Optional[_Move]:
        return self._step(knob, -1, False, reflex, reason, opts)

    def _step(self, knob: str, direction: int, restore: bool,
              reflex: str, reason: str, opts) -> Optional[_Move]:
        pc = control_perf_counters()
        st = self._state(knob)
        if st["cooldown"] > 0:
            pc.inc(l_ctl_skipped_cooldown)
            return None
        spec = CONTROL_KNOBS[knob]
        cur = spec.get(self)
        if cur is None:
            return None           # knob not actuatable right now
        floor, ceiling = self._bounds(knob, opts)
        if floor is None or ceiling is None:
            return None
        new = _stepped(spec.kind, cur, direction, st["scale"], ceiling)
        new = min(max(new, floor), ceiling)
        if spec.kind in ("int", "unit"):
            new = float(int(new))
        elif abs(new - cur) < 0.01 * max(abs(cur), 1e-9) \
                and not (spec.kind == "cap" and cur <= 0):
            # a float knob damped below a 1% step has converged: treat
            # it as pinned so the reflex escalates to its next knob
            # instead of micro-stepping forever
            pc.inc(l_ctl_pinned)
            g_journal.emit("mgr", "control_pinned", knob=knob,
                           reflex=reflex)
            return None
        if new == cur:
            pc.inc(l_ctl_pinned)
            g_journal.emit("mgr", "control_pinned", knob=knob,
                           reflex=reflex)
            return None           # anti-windup: pinned at a bound
        return _Move(knob, cur, new, restore, reflex, reason)

    # ---- actuation ------------------------------------------------------
    def _actuate(self, mgr, move: _Move, opts, now: float) -> bool:
        from ..fault import InjectedFault, g_faults
        pc = control_perf_counters()
        spec = CONTROL_KNOBS[move.knob]
        opt_name, opt_value = spec.encode(self, move.new)
        attempts = 0
        while True:
            try:
                g_faults.check("control.actuate",
                               f"{move.knob}={move.new:g} ({opt_name})")
                g_conf.set_checked(opt_name, opt_value)
                break
            except (InjectedFault, ValueError) as e:
                attempts += 1
                if attempts > opts["retries"]:
                    # bounded: drop the whole move; no cooldown is
                    # charged, so the next tick re-derives and retries
                    # — the controller cannot wedge on a dead path
                    pc.inc(l_ctl_failures)
                    mgr._cluster_log(
                        "WRN",
                        f"control: actuation dropped after "
                        f"{attempts} attempts: {move.knob} "
                        f"{move.cur:g} -> {move.new:g} ({e})")
                    return False
                pc.inc(l_ctl_retries)
        st = self._state(move.knob)
        if st["baseline"] is None and not move.restore:
            st["baseline"] = move.cur
            pc.inc(l_ctl_episodes)
        direction = 1 if move.new > move.cur else -1
        st["scale"] = st["scale"] * opts["damping"] \
            if direction == st["dir"] else 1.0
        st["dir"] = direction
        st["cooldown"] = opts["cooldown"]
        st["moves"] += 1
        self._moves_total += 1
        pc.inc(l_ctl_moves)
        pc.inc(l_ctl_restores if move.restore else l_ctl_tightens)
        if move.restore and st["baseline"] is not None \
                and move.new == st["baseline"]:
            self._close_episode(move.knob)
        self._ledger.append({
            "tick": self._tick, "clock": round(float(now), 3),
            "knob": move.knob, "option": opt_name,
            "reflex": move.reflex, "from": move.cur, "to": move.new,
            "reason": move.reason})
        while len(self._ledger) > opts["ledger"]:
            self._ledger.popleft()
        mgr._cluster_log(
            "INF", f"control: {move.reflex}: {move.knob} "
                   f"{move.cur:g} -> {move.new:g} ({move.reason})")
        g_journal.emit("mgr", "control_actuate", knob=move.knob,
                       option=opt_name, reflex=move.reflex,
                       restore=move.restore,
                       **{"from": move.cur, "to": move.new})
        return True

    def _close_episode(self, knob: str) -> None:
        st = self._state(knob)
        st["baseline"] = None
        st["dir"] = 0
        st["scale"] = 1.0
        if knob in ("client_lane_weight", "client_lane_limit") and \
                all(self._knobs.get(k, {}).get("baseline") is None
                    for k in ("client_lane_weight",
                              "client_lane_limit")):
            self._abuser = None

    # ---- tear-down / reset ----------------------------------------------
    def teardown(self, mgr, reason: str = "disabled") -> int:
        """Restore every engaged knob to its episode baseline NOW (one
        direct injection each — no fault gate, no cooldown: a disable
        must always land) and drop all episode state.  Returns the
        number of knobs restored."""
        pc = control_perf_counters()
        restored = 0
        for knob in KNOB_ORDER:
            st = self._knobs.get(knob)
            if st is None or st["baseline"] is None:
                continue
            spec = CONTROL_KNOBS[knob]
            base = st["baseline"]
            was = spec.get(self)
            try:
                opt_name, opt_value = spec.encode(self, base)
                g_conf.set_checked(opt_name, opt_value)
            except (ValueError, KeyError):
                opt_name = "?"
            self._ledger.append({
                "tick": self._tick, "clock": 0.0, "knob": knob,
                "option": opt_name, "reflex": "teardown",
                "from": was, "to": base,
                "reason": reason})
            mgr._cluster_log(
                "INF", f"control: teardown: {knob} restored to "
                       f"{base:g} ({reason})")
            pc.inc(l_ctl_reverts)
            g_journal.emit("mgr", "control_restore", knob=knob,
                           to=base, reason=reason)
            restored += 1
            st.update(baseline=None, dir=0, scale=1.0, cooldown=0)
        self._abuser = None
        self._skew_streak = self._waste_streak = 0
        pc.set(l_ctl_engaged, 0)
        pc.set(l_ctl_enabled,
               1 if bool(g_conf.get_val("mgr_control_enable")) else 0)
        return restored

    def reset(self, mgr) -> int:
        """Tear down any episode, then forget history: ledger, tick
        count, sense caches.  The asok ``control reset`` verb."""
        restored = self.teardown(mgr, reason="reset")
        self._ledger.clear()
        self._tick = 0
        self._last_qw = None
        self._last_recovery = None
        self._last_rateless = None
        return restored

    # ---- observability --------------------------------------------------
    @property
    def moves_total(self) -> int:
        return self._moves_total

    def dump(self) -> Dict[str, Any]:
        """The ``tpu control dump`` asok pane."""
        opts = self._opts()
        knobs: Dict[str, Any] = {}
        for name in KNOB_ORDER:
            spec = CONTROL_KNOBS[name]
            st = self._knobs.get(name, {"cooldown": 0, "scale": 1.0,
                                        "dir": 0, "baseline": None,
                                        "moves": 0})
            floor, ceiling = self._bounds(name, opts)
            knobs[name] = {
                "value": spec.get(self),
                "baseline": st["baseline"],
                "floor": floor, "ceiling": ceiling,
                "cooldown": st["cooldown"],
                "step_scale": st["scale"],
                "moves": st["moves"],
            }
        return {
            "enabled": opts["enable"],
            "tick": self._tick,
            "abuser": self._abuser or "",
            "moves_total": self._moves_total,
            "options": {
                "cooldown_ticks": opts["cooldown"],
                "damping": opts["damping"],
                "ledger_size": opts["ledger"],
                "actuate_retries": opts["retries"],
                "bounds": str(g_conf.get_val("mgr_control_bounds")
                              or ""),
            },
            "knobs": knobs,
            "ledger": list(self._ledger),
        }


def _parse_bounds(src) -> Dict[str, Tuple[Optional[float],
                                          Optional[float]]]:
    """'knob:floor:ceiling[,knob:...]' -> {knob: (floor, ceiling)};
    an empty field keeps the built-in bound, malformed entries drop."""
    out: Dict[str, Tuple[Optional[float], Optional[float]]] = {}
    for part in str(src or "").replace(";", ",").split(","):
        part = part.strip()
        if not part:
            continue
        bits = part.rsplit(":", 2)
        if len(bits) != 3 or bits[0] not in CONTROL_KNOBS:
            continue
        try:
            floor = float(bits[1]) if bits[1] else None
            ceiling = float(bits[2]) if bits[2] else None
        except ValueError:
            continue
        out[bits[0]] = (floor, ceiling)
    return out


def _stepped(kind: str, cur: float, direction: int, scale: float,
             ceiling: float) -> float:
    """One damped step from *cur*.  Multiplicative half-steps scaled
    by the episode's geometric damping; ``unit`` knobs move one."""
    if kind == "unit":
        return cur + direction
    if kind == "cap" and cur <= 0 and direction < 0:
        return ceiling            # impose the cap at the ceiling
    if kind == "int":
        step = max(1.0, float(int(abs(cur) * 0.5 * scale)))
        return cur + direction * step
    return cur * (1.0 + direction * 0.5 * scale)


def _halfway(kind: str, cur: float, base: float) -> float:
    """One restore step: half the remaining gap toward *base*, with a
    snap when the gap is small — restores converge in O(log) moves and
    can never overshoot the baseline."""
    gap = base - cur
    if kind in ("int", "unit"):
        if abs(gap) <= 1:
            return float(base)
        return float(int(cur + (1 if gap > 0 else -1)
                         * max(1, abs(int(gap)) // 2)))
    if kind == "cap" and base <= 0:
        return float(base)        # un-impose the cap in one move
    if abs(gap) * 0.5 <= max(abs(base) * 0.05, 1e-9):
        return float(base)
    return cur + gap * 0.5
