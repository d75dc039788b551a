"""Async input pipeline: background host prefetch and device placement
kept ahead of the consumer.

Port of the JAX package's ``data/prefetch.py``.  Two composable stages,
neither of which changes a batch:

- :class:`PrefetchIterator` pulls the wrapped iterator (dataset
  iteration and collate, the host-latency part) on ONE background thread
  into a bounded depth-N queue.  One producer and a FIFO queue keep the
  source's order; shutdown is explicit (``close()`` stops and joins the
  thread; the thread is non-daemon, so a leak is a bug) and a
  producer-side exception is raised again on the consumer with its type
  and traceback, at its position in the stream.
- :class:`DevicePrefetcher` keeps up to N device-placed batches in flight
  ahead of the consumer.  Placement runs on the CONSUMER thread, in
  stream order.  On a CUDA device each placement is issued on a side
  stream from pinned host memory (``to_device(pin=True)``), so the copy
  overlaps the step running on the consumer's stream; handing a batch
  over makes the consumer's stream wait on that batch's event and marks
  each of its tensors used on the consumer's stream (``record_stream``),
  so the caching allocator cannot reuse a buffer still in flight.  A
  placement that yields a CUDA tensor without a CUDA device raises:
  there is no synchronous fallback.

``prefetch_pipeline`` composes the two; the Trainer wires it through
fit / eval / predict behind ``Trainer(prefetch_batches=N)``, with no
producer thread over a loader the native engine feeds (its C++ threads
already gather ahead, off the GIL).  Each
object counts what the JAX profiler hooks record: ``starved_steps``
(batches the consumer found the ring empty for, after the first) and
``depth_seen`` (the ring plus queue depth left after each hand-over).
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Any, Callable, Iterable, Iterator, List, Optional

import numpy as np
import torch

from ..telemetry import recorder as telemetry
from ..utils.logging import log

# producer stop-check cadence while blocked on a full queue: close()
# latency is bounded by ~2 polls
_PUT_POLL_S = 0.05
# consumer poll while blocked on an empty queue: each timeout re-checks
# that the producer thread is still alive
_GET_POLL_S = 0.5

# queue records: ("item", payload) | ("raise", exc) | ("end", None)
_ITEM, _RAISE, _END = "item", "raise", "end"


class PrefetchClosed(RuntimeError):
    """Iteration attempted on a pipeline after ``close()``."""


class PrefetchIterator:
    """Iterate ``source`` on a background thread into a bounded queue.

    One producer thread and one FIFO queue reproduce the source's order.
    ``depth`` bounds host memory (at most ``depth`` batches buffered)
    and how far a stateful source runs ahead of consumption.  Exceptions
    raised by the source surface on the consumer at the failing
    element's position, with their type and traceback.  ``close()``
    (idempotent, also the context-manager exit) stops and joins the
    thread; iteration past ``close()`` raises :class:`PrefetchClosed`.
    """

    def __init__(self, source: Iterable[Any], depth: int,
                 name: str = "rla-prefetch"):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._source = iter(source)
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._closed = False
        self._finished = False
        # non-daemon on purpose: every exit path must close() this
        self._thread = threading.Thread(target=self._produce, name=name,
                                        daemon=False)
        self._thread.start()

    # -- producer ------------------------------------------------------ #
    def _put(self, record) -> bool:
        """Stop-aware blocking put; False when close() interrupted it."""
        while not self._stop.is_set():
            try:
                self._queue.put(record, timeout=_PUT_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self) -> None:
        try:
            while not self._stop.is_set():
                try:
                    item = next(self._source)
                except StopIteration:
                    break
                if not self._put((_ITEM, item)):
                    return
            if not self._stop.is_set():
                self._put((_END, None))
        except BaseException as e:  # noqa: BLE001 - carried to consumer
            self._put((_RAISE, e))

    # -- consumer ------------------------------------------------------ #
    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self) -> Any:
        if self._closed:
            raise PrefetchClosed("prefetch iterator used after close()")
        if self._finished:
            raise StopIteration
        while True:
            try:
                kind, payload = self._queue.get(timeout=_GET_POLL_S)
                break
            except queue.Empty:
                if not self._thread.is_alive():
                    # one last non-blocking drain: the producer may have
                    # put its final record between the timeout and the
                    # liveness check
                    try:
                        kind, payload = self._queue.get_nowait()
                        break
                    except queue.Empty:
                        self._finished = True
                        raise RuntimeError(
                            "prefetch producer thread died without a "
                            "final record") from None
        if kind == _ITEM:
            return payload
        self._finished = True
        self._thread.join()
        if kind == _END:
            raise StopIteration
        raise payload  # the original exception: type and traceback kept

    def qsize(self) -> int:
        """Batches currently buffered (ready without blocking)."""
        return self._queue.qsize()

    # -- lifecycle ----------------------------------------------------- #
    def close(self, timeout: float = 5.0) -> None:
        """Stop and join the producer, then close the source (a generator
        chain runs its ``finally`` blocks here, on this thread).
        Idempotent; safe mid-iteration."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        deadline = time.monotonic() + timeout
        while self._thread.is_alive() and time.monotonic() < deadline:
            try:  # unblock a producer stuck in put() on a full queue
                self._queue.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=_PUT_POLL_S)
        if self._thread.is_alive():  # pragma: no cover - defensive
            log.warning("prefetch producer %s did not stop within %.1fs",
                        self._thread.name, timeout)
            return
        close = getattr(self._source, "close", None)
        if close is not None:
            close()
        self._source = iter(())

    def __enter__(self) -> "PrefetchIterator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _tensors(tree: Any) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def to_device(tree: Any, device: torch.device, pin: bool = False) -> Any:
    """A host batch (a numpy or tensor pytree) as tensors on ``device``;
    tensors already there pass through.  With ``pin`` and a CUDA device a
    host leaf is copied into pinned memory first, so the non-blocking
    copy really runs asynchronously on the current stream."""
    device = torch.device(device)

    def one(x):
        if isinstance(x, torch.Tensor) and x.device == device:
            return x
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x))
        if pin and device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory()
        return t.to(device, non_blocking=True)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v) for v in node)
        if node is None or isinstance(node, (str, bytes, int, float, bool)):
            return node
        return one(node)

    return walk(tree)


class DevicePrefetcher:
    """Keep up to ``depth`` device-placed batches in flight ahead of the
    consumer (the double buffer generalized to depth N).

    Each ``__next__`` (1) blocks only if no placed batch is ready,
    (2) tops the ring back up by placing every batch the host stage
    already has waiting, and (3) returns the oldest placed batch.  Errors
    from the source or from ``place_fn`` are stashed and raised at their
    position in the stream, so the batches before a failure are still
    consumed.  ``device`` (a CUDA device) puts the placements on a side
    stream as the module docstring says; None or a CPU device places on
    the calling thread's default path.
    """

    def __init__(self, inner, depth: int,
                 place_fn: Optional[Callable[[Any], Any]] = None,
                 device: Any = None, pull_ahead: bool = False):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._inner = inner
        self._iter = iter(inner)
        self._depth = depth
        self._place = place_fn
        self._device = torch.device(device) if device is not None else None
        self._stream = None
        if self._device is not None and self._device.type == "cuda":
            self._stream = torch.cuda.Stream(device=self._device)
        # top the ring up from a plain iterator too (its next() is cheap:
        # the batch was gathered ahead), not only from a queue's backlog
        self._pull_ahead = pull_ahead
        self._ring: collections.deque = collections.deque()
        self._exhausted = False
        self._pending_exc: Optional[BaseException] = None
        self._started = False
        self.starved_steps = 0
        self.depth_seen: List[int] = []

    def _advance(self) -> bool:
        """Pull and place ONE batch into the ring.  The end and errors are
        stashed (not raised) so they surface in stream order."""
        if self._exhausted or self._pending_exc is not None:
            return False
        try:
            item = next(self._iter)
            event = None
            if self._place is None:
                placed = item
            elif self._stream is None:
                placed = self._place(item)
                if any(t.is_cuda for t in _tensors(placed)):
                    raise ValueError(
                        "a prefetch placement produced a CUDA tensor "
                        "without a CUDA device: give DevicePrefetcher the "
                        "device, so the copy runs on its stream")
            else:
                # the buffers are allocated on the side stream; the
                # consumer's use of them is recorded at the hand-over, so
                # the allocator reuses none before that use ends
                with torch.cuda.stream(self._stream):
                    placed = self._place(item)
                event = torch.cuda.Event()
                event.record(self._stream)
            self._ring.append((placed, event))
            return True
        except StopIteration:
            self._exhausted = True
        except BaseException as e:  # noqa: BLE001 - surfaced in order
            self._pending_exc = e
        return False

    def _ready(self) -> bool:
        """Does the host stage have a batch waiting (no blocking)?"""
        if self._pull_ahead:
            return True
        qsize = getattr(self._inner, "qsize", None)
        return qsize is not None and qsize() > 0

    def _hand_over(self, placed: Any, event: Any) -> Any:
        if event is None:
            return placed
        consumer = torch.cuda.current_stream(self._device)
        consumer.wait_event(event)
        for t in _tensors(placed):
            if t.is_cuda:
                t.record_stream(consumer)
        return placed

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self) -> Any:
        t0 = time.perf_counter()
        # the first batch of a stream waits (nothing was in flight yet):
        # warm-up, not starvation
        starved = self._started and not self._ring
        if not self._ring:
            self._advance()  # blocking pull
        wait = time.perf_counter() - t0
        # top up: issue the placements of everything already collated, up
        # to depth; these copies run while the consumer computes
        while len(self._ring) < self._depth and self._ready():
            if not self._advance():
                break
        if self._ring:
            if starved:
                self.starved_steps += 1
                telemetry.emit("prefetch_starved",
                               wait_ms=round(wait * 1e3, 3))
            self.depth_seen.append(
                len(self._ring) - 1 + (self._inner.qsize()
                                       if hasattr(self._inner, "qsize")
                                       else 0))
            self._started = True
            return self._hand_over(*self._ring.popleft())
        if self._pending_exc is not None:
            exc, self._pending_exc = self._pending_exc, None
            raise exc
        raise StopIteration

    def close(self, timeout: float = 5.0) -> None:
        if isinstance(self._inner, PrefetchIterator):
            self._inner.close(timeout=timeout)
        else:
            # plain iterators (generators) take no timeout; a bare
            # iterable may have no close() at all
            close = getattr(self._inner, "close", None)
            if close is not None:
                close()
        self._ring.clear()

    def __enter__(self) -> "DevicePrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def prefetch_pipeline(source: Iterable[Any], depth: int,
                      place_fn: Optional[Callable[[Any], Any]] = None,
                      device: Any = None,
                      name: str = "rla-prefetch",
                      host_thread: bool = True) -> DevicePrefetcher:
    """The full async input pipeline: host iteration and collate on a
    background thread (:class:`PrefetchIterator`), device placement
    ``depth`` ahead (:class:`DevicePrefetcher`).  ``close()`` on the
    returned object stops and joins the thread.  ``host_thread=False``
    (a source that already gathers ahead off the GIL: the native
    engine's threads) pulls on the consumer thread and keeps only the
    placement ``depth`` ahead: a Python producer thread would add
    nothing but its turns at the GIL, which an eager step's dispatch
    holds."""
    if not host_thread:
        return DevicePrefetcher(iter(source), depth, place_fn,
                                device=device, pull_ahead=True)
    host = PrefetchIterator(source, depth, name=name)
    return DevicePrefetcher(host, depth, place_fn, device=device)
