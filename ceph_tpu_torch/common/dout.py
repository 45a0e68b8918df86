"""Leveled per-subsystem debug logging — the dout/ldout analog.

Port of ``ceph_tpu/common/dout.py``, the same behaviour under the same names.

Mirrors the reference's logging split (common/dout.h macros +
log/Log.cc collector):

- every subsystem has a pair of levels ``log/gather`` (common/subsys.h):
  entries at or below *gather* are collected into a bounded in-memory
  ring (log/Log.cc m_recent, default 10000), and the subset at or below
  *log* goes to the sink (file/stderr).  The ring makes recent low-level
  detail available after the fact ("log dump" on the admin socket —
  the reference dumps it on crash) without paying the IO for it.
- levels are runtime-tunable per subsystem via config options
  ``debug_<subsys> = "log/gather"`` with observer-driven updates
  (md_config_t observers, common/config_obs.h).

Python-idiomatic surface: module-level ``dlog(subsys, level, msg)``
plus per-owner ``Dout`` handles that carry the ``who`` prefix.  The
disabled path is one dict lookup and an int compare.
"""
from __future__ import annotations

import sys
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

# default log/gather per subsystem (subset of common/subsys.h with the
# reference's "1/5"-style defaults)
SUBSYS_DEFAULTS: Dict[str, Tuple[int, int]] = {
    "osd": (1, 5),
    "mon": (1, 5),
    "pg": (1, 5),
    "crush": (1, 1),
    "ec": (1, 5),       # the reference's "osd" covers ECBackend; split out
    "msg": (0, 5),
    "client": (0, 5),
    "recovery": (1, 5),
    "scrub": (1, 5),
    "config": (0, 5),
}

MAX_RECENT = 10000      # log/Log.cc m_max_recent default


class LogEntry:
    __slots__ = ("stamp", "subsys", "level", "who", "msg")

    def __init__(self, stamp: float, subsys: str, level: int, who: str,
                 msg: str):
        self.stamp = stamp
        self.subsys = subsys
        self.level = level
        self.who = who
        self.msg = msg

    def format(self) -> str:
        return (f"{self.stamp:.6f} {self.who or '-'} "
                f"{self.level:2d} {self.subsys}: {self.msg}")


class Log:
    """The collector: bounded recent ring + optional sink."""

    def __init__(self):
        self.levels: Dict[str, Tuple[int, int]] = dict(SUBSYS_DEFAULTS)
        self.recent: Deque[LogEntry] = deque(maxlen=MAX_RECENT)
        self.sink = None                 # file object or None
        self.stderr_level = -1           # also mirror <= this to stderr

    # ---- levels -----------------------------------------------------------
    def set_level(self, subsys: str, log_level: int,
                  gather_level: Optional[int] = None) -> None:
        if gather_level is None:
            gather_level = max(log_level,
                               self.levels.get(subsys, (0, 5))[1])
        self.levels[subsys] = (log_level, gather_level)

    def parse_level(self, subsys: str, spec: str) -> None:
        """"3" or "3/10" like the reference's debug_<subsys> values."""
        parts = str(spec).split("/")
        lg = int(parts[0])
        gt = int(parts[1]) if len(parts) > 1 else lg
        self.levels[subsys] = (lg, max(lg, gt))

    def gather_level(self, subsys: str) -> int:
        return self.levels.get(subsys, (0, 0))[1]

    # ---- submission -------------------------------------------------------
    def submit(self, subsys: str, level: int, who: str, msg: str) -> None:
        lg, gt = self.levels.get(subsys, (0, 0))
        if level > gt:
            return
        e = LogEntry(time.time(), subsys, level, who, msg)
        self.recent.append(e)
        if level <= lg and self.sink is not None:
            self.sink.write(e.format() + "\n")
        if level <= self.stderr_level:
            sys.stderr.write(e.format() + "\n")

    # ---- draining ---------------------------------------------------------
    def dump_recent(self, n: int = 0, subsys: str = "") -> List[str]:
        entries = [e for e in self.recent
                   if not subsys or e.subsys == subsys]
        if n:
            entries = entries[-n:]
        return [e.format() for e in entries]

    def open_file(self, path: str) -> None:
        self.sink = open(path, "a")

    def flush(self) -> None:
        if self.sink is not None:
            self.sink.flush()

    def clear(self) -> None:
        self.recent.clear()


_log = Log()


def get_log() -> Log:
    return _log


def dlog(subsys: str, level: int, msg: str, who: str = "") -> None:
    """The dout(level) << ... analog; cheap when gathered off."""
    lv = _log.levels.get(subsys)
    if lv is None or level > lv[1]:
        return
    _log.submit(subsys, level, who, msg)


class Dout:
    """Per-owner handle carrying the ``who`` prefix (each daemon's
    dout context)."""

    def __init__(self, subsys: str, who: str):
        self.subsys = subsys
        self.who = who

    def __call__(self, level: int, msg: str) -> None:
        dlog(self.subsys, level, msg, self.who)

    def enabled(self, level: int) -> bool:
        return level <= _log.gather_level(self.subsys)


def register_config_observers(config) -> None:
    """Wire debug_<subsys> config options to live level updates
    (``ceph tell ... injectargs --debug-osd 20`` behavior)."""
    for subsys in list(_log.levels):
        config.add_observer(f"debug_{subsys}",
                            lambda _n, v, _s=subsys:
                            _log.parse_level(_s, v))
    from .kernel_trace import g_kernel_timer
    config.add_observer("tracing_kernels",
                        lambda _n, v: g_kernel_timer.enable(bool(v)))
    from ..trace import g_tracer
    config.add_observer("tracing_spans",
                        lambda _n, v: g_tracer.enable(bool(v)))
