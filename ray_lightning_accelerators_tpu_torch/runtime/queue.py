"""TrampolineQueue and the driver's result pump.

Port of the JAX package's ``runtime/queue.py``: ``TrampolineQueue`` (the
thread-safe queue the serve batcher stores requests in, and the driver
side of the workers' ``put_queue``) and ``process_results``, which polls
the workers' futures while it runs the callables the workers ship home.
``shutdown()`` is an idempotent close that drains what is still enqueued
WITHOUT executing it, so the batcher can cancel each drained request
typed; a ``put`` after shutdown raises ``QueueShutdown`` instead of
silently losing the item.

The workers of an ``ActorPool`` reach the driver through the pool's
``multiprocessing`` channel (``runtime/actors.py``); ``process_results``
moves what arrives there into the queue and runs it.  The TCP
``QueueServer`` / ``QueueClient`` for workers on other hosts come with
the runtime slice.
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time
from concurrent.futures import Future
from typing import Any, List, Optional


class QueueShutdown(RuntimeError):
    """Typed rejection for ``put()`` on a shut-down queue: the item would
    never be drained or executed, so silently accepting it loses work."""


class TrampolineQueue:
    """Thread-safe FIFO with an idempotent draining shutdown."""

    def __init__(self):
        self._q = queue_mod.Queue()
        self._lock = threading.Lock()
        self._closed = False

    def put(self, item: Any) -> None:
        with self._lock:
            if self._closed:
                raise QueueShutdown(
                    "TrampolineQueue is shut down; the item would never "
                    "be drained")
            self._q.put(item)

    def get_nowait(self):
        try:
            return self._q.get_nowait()
        except queue_mod.Empty:
            return None

    def shutdown(self) -> List[Any]:
        """Mark closed and drain everything still enqueued without
        executing it; later calls return []."""
        with self._lock:
            first, self._closed = not self._closed, True
        drained: List[Any] = []
        if first:
            while True:
                item = self.get_nowait()
                if item is None:
                    break
                drained.append(item)
        return drained


def drain_queue(q: Optional[TrampolineQueue], channel: Any = None) -> int:
    """Move what the workers wrote to ``channel`` into ``q``, then run
    every queued ``(rank, callable)`` in this process; returns how many
    ran."""
    if q is None:
        return 0
    while channel is not None and not channel.empty():
        q.put(channel.get())
    n = 0
    while True:
        item = q.get_nowait()
        if item is None:
            return n
        _rank, fn = item
        fn()
        n += 1


def process_results(futures: List[Future], q: Optional[TrampolineQueue],
                    poll_s: float = 0.01,
                    deadline_s: Optional[float] = None,
                    channel: Any = None) -> List[Any]:
    """Poll the workers' futures while running what they ship home; a
    final drain after the last future closes the race between a
    worker's last ``put_queue`` and its result.

    Fails fast on the first future that failed: in a collective job one
    crashed rank leaves its peers blocked in a collective, so waiting for
    every future would hang with the failure already in hand.
    ``deadline_s`` bounds the whole set: past it, ``TimeoutError`` (the
    futures stay unresolved; the caller kills the workers)."""
    pending = list(futures)
    deadline = (time.monotonic() + deadline_s
                if deadline_s is not None else None)
    while pending:
        drain_queue(q, channel)
        still = []
        for f in pending:
            if not f.done():
                still.append(f)
            elif f.exception() is not None:
                drain_queue(q, channel)
                f.result()  # re-raise
        pending = still
        if pending and deadline is not None \
                and time.monotonic() >= deadline:
            drain_queue(q, channel)
            raise TimeoutError(
                f"process_results: {len(pending)} of {len(futures)} "
                f"futures unresolved past the {deadline_s:.1f} s deadline")
        if pending:
            time.sleep(poll_s)
    drain_queue(q, channel)
    return [f.result() for f in futures]
