"""lockdep — runtime lock-ordering checker (src/common/lockdep.cc role).

Port of ``ceph_tpu/common/lockdep.py``, the same behaviour under the same names.

The reference registers every named mutex and records, per acquisition,
which locks the thread already holds; observing A-before-B and later
B-before-A is a potential deadlock and aborts with both backtraces.
This is the same design over ``threading``: ``DebugLock`` wraps a lock
with a name, a global order graph accumulates (holder -> acquired)
edges, and an inversion raises ``LockOrderError`` with the two orders'
stacks.  Enabled via ``lockdep_enable()`` (tests / vstart-style debug
runs — the reference gates it behind the ``lockdep`` option too,
src/vstart.sh); disabled it costs one attribute check per acquire.
"""
from __future__ import annotations

import threading
import traceback
from typing import Dict, List, Optional, Set, Tuple

_enabled = False
_registry_lock = threading.Lock()
# (before, after) -> formatted stack that first established the order
_orders: Dict[Tuple[str, str], str] = {}
_held = threading.local()


class LockOrderError(RuntimeError):
    pass


def lockdep_enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


def lockdep_reset() -> None:
    with _registry_lock:
        _orders.clear()


def _held_stack() -> List[str]:
    st = getattr(_held, "stack", None)
    if st is None:
        st = _held.stack = []
    return st


def _reaches(src: str, dst: str) -> Optional[str]:
    """First recorded stack on a path src ->* dst in the order graph
    (the reference lockdep's recursive ``does_follow`` check)."""
    seen = {src}
    frontier = [src]
    while frontier:
        cur = frontier.pop()
        for (a, b), stack in _orders.items():
            if a != cur or b in seen:
                continue
            if b == dst:
                return stack
            seen.add(b)
            frontier.append(b)
    return None


def _will_lock(name: str) -> None:
    held = _held_stack()
    if not held:
        return
    # the stack string only matters the FIRST time an edge is
    # recorded; format it lazily so steady-state nested acquires
    # (every edge already known) skip the traceback walk — this runs
    # on the per-op hot path of every witness-armed daemon
    stack = None
    with _registry_lock:
        for h in held:
            if h == name:
                raise LockOrderError(f"recursive acquire of {name!r}")
            # transitive check: any existing name ->* h path plus the
            # new h -> name edge closes a cycle
            prior = _reaches(name, h)
            if prior is not None:
                raise LockOrderError(
                    f"lock order inversion: acquiring {name!r} while "
                    f"holding {h!r}, but an order {name!r} ->* {h!r} "
                    f"was established here:\n{prior}")
            if (h, name) not in _orders:
                if stack is None:
                    stack = "".join(traceback.format_stack(limit=8)[:-2])
                _orders[(h, name)] = stack


class DebugLock:
    """Named lock participating in ordering checks when lockdep is on.

    Also implements the ``threading.Condition`` owner protocol
    (``_release_save`` / ``_acquire_restore`` / ``_is_owned``) so a
    ``Condition(DebugLock(...))`` wait/notify round keeps the held
    stack honest instead of tripping a false recursive-acquire via
    Condition's default ``acquire(False)`` ownership probe.
    """

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()  # lint: allow[no-bare-lock]

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if _enabled:
            _will_lock(self.name)
        got = self._lock.acquire(blocking, timeout)
        if got and _enabled:
            _held_stack().append(self.name)
        return got

    def release(self) -> None:
        self._lock.release()
        # pop the held stack even when the witness is off: a lock
        # acquired while enabled and released after lockdep_enable(False)
        # must not strand its name (a later re-enable would see a
        # phantom hold and report a false recursive acquire)
        st = _held_stack()
        if self.name in st:
            st.remove(self.name)

    def __enter__(self) -> "DebugLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._lock.locked()

    # ---- threading.Condition owner protocol ---------------------------
    def _release_save(self):
        self.release()

    def _acquire_restore(self, _state) -> None:
        self.acquire()

    def _is_owned(self) -> bool:
        if _enabled and self.name in _held_stack():
            return True
        # Condition's stock probe, against the RAW lock so lockdep
        # never sees it as an ordering event
        if self._lock.acquire(False):
            self._lock.release()
            return False
        return True


class DebugRLock:
    """Named reentrant lock under the same witness.

    Same-instance re-acquisition by the owning thread is legal RLock
    semantics and records no ordering event; only the OUTERMOST
    acquire/release participates in the order graph, exactly like the
    reference's recursive ``ceph::make_recursive_mutex`` registration.
    """

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.RLock()  # lint: allow[no-bare-lock]
        self._owner: int = 0
        self._count = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        me = threading.get_ident()
        outermost = self._owner != me
        if _enabled and outermost:
            _will_lock(self.name)
        got = self._lock.acquire(blocking, timeout)
        if got:
            # safe unlocked writes: we hold the lock
            self._owner = me
            self._count += 1
            if _enabled and outermost:
                _held_stack().append(self.name)
        return got

    def release(self) -> None:
        outermost = self._count == 1
        self._count -= 1
        if self._count == 0:
            self._owner = 0
        self._lock.release()
        # see DebugLock.release: unconditional so toggling the witness
        # mid-hold can never strand a held-stack entry
        if outermost:
            st = _held_stack()
            if self.name in st:
                st.remove(self.name)

    def __enter__(self) -> "DebugRLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def _is_owned(self) -> bool:
        return self._owner == threading.get_ident()
