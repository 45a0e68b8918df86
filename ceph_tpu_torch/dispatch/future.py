"""DispatchFuture — the handle a submitter holds while its request
waits in a batch.

Port of ``ceph_tpu/dispatch/future.py``.

The serving-stack analog: dynamic batching decouples *submission* from
*execution*, so every submit returns a future that resolves when the
flush containing the request lands.  Two consumption styles:

- ``result()``: the synchronous OSD paths (ec_backend's encode funnel)
  call it immediately — if the request is still queued this forces the
  owning queue to flush, so correctness NEVER depends on a timer or on
  other traffic arriving.  Coalescing happens when it can (concurrent
  submitters, batch_max triggers), never at the price of a stall.
- ``add_done_callback()``: async consumers (bench drivers, the EC
  write pipeline's continuation fan-out) get called on the flusher's
  thread.  Callback execution context: whichever thread resolves the
  future runs the callbacks inline — the submitter itself when the
  request executed inline or a backpressure ``force()``/``flush()``
  ran there, the OSD tick thread when the collection window expired,
  or another submitter whose demand flushed the shared queue.
  Consumers that touch shared state must therefore take their own
  locks (ec_backend's pipeline window does) and re-anchor their trace
  context (``g_tracer.activate``) — the thread-current span at
  callback time belongs to whoever flushed, not to the submitter.
- ``force()``: flush-on-demand WITHOUT blocking — runs the owning
  queue's flush inline (resolving this future and its batchmates via
  their callbacks) but never waits on another thread.  The write
  pipeline's backpressure forces its oldest pending future (falling
  back to the scheduler-wide ``flush()`` for mixed-signature
  windows): a full window empties by running the work, not by
  parking the submitter.

Error isolation contract: a future carries ITS request's exception
only.  One malformed or undecodable request in a batch must resolve
its own future with the error and leave every batchmate's bytes
untouched (scheduler._execute falls back to per-request execution when
a batched call throws).
"""
from __future__ import annotations

import logging
import threading
from typing import Any, Callable, List, Optional

from ..common.lockdep import DebugLock


class DispatchFuture:
    """Resolves exactly once with a value or an exception."""

    __slots__ = ("_event", "_value", "_exc", "_callbacks", "_lock",
                 "_flush_fn")

    def __init__(self, flush_fn: Optional[Callable[[], None]] = None):
        self._event = threading.Event()
        self._value: Any = None
        self._exc: Optional[BaseException] = None
        self._callbacks: List[Callable[["DispatchFuture"], None]] = []
        self._lock = DebugLock("DispatchFuture::lock")
        # bound by the scheduler: forces the owning queue's flush so a
        # lone synchronous submitter can never deadlock on its own batch
        self._flush_fn = flush_fn

    # ---- producer side (scheduler) ----------------------------------------
    def set_result(self, value: Any) -> None:
        with self._lock:
            if self._event.is_set():
                return
            self._value = value
            self._event.set()
            cbs = self._drop_producer_refs()
        self._run_callbacks(cbs)

    def set_exception(self, exc: BaseException) -> None:
        with self._lock:
            if self._event.is_set():
                return
            self._exc = exc
            self._event.set()
            cbs = self._drop_producer_refs()
        self._run_callbacks(cbs)

    def _drop_producer_refs(self) -> List:
        # the flush closure captures the Request (payload/chunk buffers,
        # codec) and the request points back here — clear both so a
        # consumer holding resolved futures doesn't pin dead payloads
        # until cyclic GC
        cbs = self._callbacks
        self._callbacks = []
        self._flush_fn = None
        return cbs

    def _run_callbacks(self, cbs) -> None:
        # concurrent.futures semantics: a raising consumer callback is
        # the consumer's bug, never the batch's — it must not abort the
        # resolution of batchmates or masquerade as a device failure
        for cb in cbs:
            try:
                cb(self)
            except Exception:               # noqa: BLE001
                logging.getLogger(__name__).exception(
                    "dispatch future callback raised")

    # ---- consumer side -----------------------------------------------------
    def done(self) -> bool:
        return self._event.is_set()

    def force(self) -> None:
        """Flush-on-demand: execute the owning queue's flush inline if
        this request is still queued.  Unlike ``result()`` this never
        waits — when the request is already executing on another
        thread the call returns immediately and completion arrives via
        ``add_done_callback``."""
        if not self._event.is_set() and self._flush_fn is not None:
            self._flush_fn()

    def result(self, timeout: Optional[float] = None) -> Any:
        """The request's own outcome; forces a flush when still queued."""
        if not self._event.is_set() and self._flush_fn is not None:
            self._flush_fn()
        if not self._event.wait(timeout):
            raise TimeoutError("dispatch request did not complete")
        if self._exc is not None:
            raise self._exc
        return self._value

    def exception(self, timeout: Optional[float] = None
                  ) -> Optional[BaseException]:
        if not self._event.is_set() and self._flush_fn is not None:
            self._flush_fn()
        if not self._event.wait(timeout):
            raise TimeoutError("dispatch request did not complete")
        return self._exc

    def add_done_callback(self,
                          cb: Callable[["DispatchFuture"], None]) -> None:
        with self._lock:
            if not self._event.is_set():
                self._callbacks.append(cb)
                return
        self._run_callbacks([cb])
