"""Background-thread input prefetcher: batches prepared and placed ahead of
the step that consumes them.

Port of ``galvatron_tpu/runtime/prefetch.py``. :class:`PrefetchIterator`
moves the host work off the critical path: a daemon thread pulls from the
underlying iterator, applies ``place_fn`` and parks up to ``depth`` placed
batches in a bounded queue, so preparing batch N+1..N+depth overlaps the
step of batch N. On ``cuda`` the train loop's ``place_fn`` is
:class:`DevicePlacer`: the copy runs from pinned host memory with
``non_blocking=True`` on a side stream and the batch carries that stream's
event, which :func:`consume` makes the consumer's stream wait on (and
``record_stream`` keeps the buffers alive for it) before the step reads a
token.

Contract:

- **Ordering**: batches come out in exactly the order the source yields
  them (single worker, FIFO queue), so losses equal the synchronous loop's
  bit for bit.
- **Bounded**: at most ``depth`` placed batches are buffered (plus the one
  the worker is preparing); a slow consumer back-pressures the producer.
- **Exceptions propagate**: an exception in the source iterator or in
  ``place_fn`` is re-raised from :meth:`__next__` in the training thread.
- **Stalls surface**: with ``stall_timeout`` a live producer that yields
  nothing in time raises :class:`PrefetchStalledError` with diagnostics.
- **Clean shutdown**: :meth:`close` (also via context manager and the train
  train loop's ``finally``) unblocks and joins the worker (bounded), so
  preemption, rollback and exit never hang on a thread.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, Iterator, Optional

import torch

__all__ = ["DevicePlacer", "PrefetchIterator", "PrefetchStalledError", "consume"]

_ITEM, _DONE, _ERROR = "item", "done", "error"


class PrefetchStalledError(RuntimeError):
    """The producer thread is alive but produced nothing within the stall
    timeout — a wedged ``place_fn`` (a host-to-device copy stuck behind a
    sick device) or a hung source iterator. Carries the producer's
    diagnostics; raising (instead of blocking forever) is what
    lets the train loop surface the stall instead of silently hanging."""

    def __init__(self, message: str, diagnostics: Optional[Dict] = None):
        super().__init__(message)
        self.diagnostics = dict(diagnostics or {})


class PrefetchIterator:
    """Wrap ``source`` so host batch prep + device placement run ahead of
    the consumer on a background thread. Iterator protocol + context
    manager; ``close()`` is idempotent.

    `stall_timeout` (seconds) bounds how long :meth:`get`/``__next__`` will
    wait on a live-but-unproductive worker before raising
    :class:`PrefetchStalledError` (None = wait forever, the pre-watchdog
    behavior)."""

    def __init__(
        self,
        source: Iterator,
        depth: int = 2,
        place_fn: Optional[Callable] = None,
        name: str = "galvatron-prefetch",
        stall_timeout: Optional[float] = None,
    ):
        if depth < 1:
            raise ValueError("prefetch depth must be >= 1, got %d" % depth)
        self._source = source
        self._place_fn = place_fn
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exhausted = False
        self._error: Optional[BaseException] = None
        self._closed = False
        self._stall_timeout = stall_timeout
        self._produced = 0  # items the worker finished placing
        self._consumed = 0  # items handed to the consumer
        self._busy_since: Optional[float] = None  # worker inside next()/place_fn
        self._thread = threading.Thread(target=self._worker, name=name, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- producer
    def _put(self, entry) -> bool:
        """Blocking put that stays responsive to close(); False if closing."""
        while not self._stop.is_set():
            try:
                self._queue.put(entry, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            while not self._stop.is_set():
                self._busy_since = time.monotonic()
                try:
                    item = next(self._source)
                except StopIteration:
                    self._busy_since = None
                    self._put((_DONE, None))
                    return
                if self._place_fn is not None:
                    item = self._place_fn(item)
                self._busy_since = None
                self._produced += 1
                if not self._put((_ITEM, item)):
                    return
        except BaseException as e:  # noqa: BLE001 — relayed to the consumer
            self._busy_since = None
            self._put((_ERROR, e))

    # ------------------------------------------------------------- consumer
    def __iter__(self):
        return self

    def diagnostics(self) -> Dict:
        """Producer-side state for the watchdog's stall report."""
        busy = self._busy_since
        return {
            "worker_alive": self._thread.is_alive(),
            "produced": self._produced,
            "consumed": self._consumed,
            "buffered": self._queue.qsize(),
            "busy_for_s": (time.monotonic() - busy) if busy is not None else None,
            "stall_timeout_s": self._stall_timeout,
        }

    def get(self, timeout: Optional[float] = None):
        """Next placed batch, waiting at most `timeout` seconds (default:
        the constructor's `stall_timeout`). A live worker that produces
        nothing within the budget raises :class:`PrefetchStalledError`
        with diagnostics instead of hanging the training thread."""
        if self._closed:
            raise RuntimeError("PrefetchIterator used after close()")
        if self._error is not None:
            raise self._error
        if self._exhausted:
            raise StopIteration
        timeout = self._stall_timeout if timeout is None else timeout
        deadline = (time.monotonic() + timeout) if timeout is not None else None
        while True:
            try:
                tag, payload = self._queue.get(timeout=0.1)
            except queue.Empty:
                if not self._thread.is_alive() and self._queue.empty():
                    # worker died without posting a marker (should not
                    # happen; defensive against a killed interpreter)
                    self._exhausted = True
                    raise StopIteration
                if deadline is not None and time.monotonic() > deadline:
                    diag = self.diagnostics()
                    raise PrefetchStalledError(
                        "prefetch producer yielded nothing for %.1fs "
                        "(worker alive, %d produced / %d buffered%s)"
                        % (timeout, diag["produced"], diag["buffered"],
                           ", busy in source/place_fn for %.1fs"
                           % diag["busy_for_s"] if diag["busy_for_s"] else ""),
                        diagnostics=diag,
                    )
                continue
            if tag == _ITEM:
                self._consumed += 1
                return payload
            if tag == _DONE:
                self._exhausted = True
                raise StopIteration
            self._error = payload
            raise payload

    def __next__(self):
        return self.get()

    # ------------------------------------------------------------- shutdown
    def close(self, timeout: float = 5.0):
        """Stop the worker and join it (bounded). Buffered batches are
        dropped (the rollback path rebuilds the stream at a different step
        anyway). A worker wedged inside ``place_fn`` cannot be joined — the
        bounded join returns anyway (daemon thread, cannot block exit) and
        the leak is reported as a warning event rather than a deadlock."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        # drain so a worker blocked in put() sees the stop event promptly
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            from galvatron_tpu_torch.obs import telemetry

            telemetry.runtime_log(
                "prefetch close: worker did not exit within %.1fs (wedged "
                "in source/place_fn?); leaking the daemon thread" % timeout
            )

    def __enter__(self):
        return self

    def __exit__(self, *exc_info):
        self.close()
        return False

    def __del__(self):  # pragma: no cover — best-effort
        try:
            self.close(timeout=0.1)
        except Exception:
            pass


# ---------------------------------------------------------- device placement
class DevicePlacer:
    """``place_fn`` for a CUDA device: copies a batch of CPU tensors through
    pinned host memory with ``non_blocking=True`` on a side stream (the
    prefetch thread's), and returns ``(batch, event)`` with the event
    recorded on that stream after the copies. On the CPU it returns the
    batch as it is. Pass the result through :func:`consume` on the thread
    that runs the step."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    def __call__(self, batch: Dict[str, torch.Tensor]):
        if self.stream is None:
            return batch, None
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            # contiguous first: an expanded view (the positions) cannot be pinned
            out = {k: v.contiguous().pin_memory().to(self.device, non_blocking=True)
                   for k, v in batch.items()}
            event = torch.cuda.Event()
            event.record(self.stream)
        return out, event


def consume(placed) -> Dict[str, torch.Tensor]:
    """The batch of a `DevicePlacer` result, safe to read on the current
    stream: the stream waits for the side stream's copies, and each tensor
    is recorded as in use there so the caching allocator does not hand its
    memory back to the side stream while the step still reads it."""
    batch, event = placed
    if event is not None:
        stream = torch.cuda.current_stream()
        stream.wait_event(event)
        for t in batch.values():
            t.record_stream(stream)
    return batch
