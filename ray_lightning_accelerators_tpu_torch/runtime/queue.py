"""TrampolineQueue: the thread-safe queue the serve batcher stores
requests in.

Port of ``TrampolineQueue`` from the JAX package's ``runtime/queue.py``.
``shutdown()`` is an idempotent close that drains what is still enqueued
WITHOUT executing it, so the batcher can cancel
each drained request typed; a ``put`` after shutdown raises
``QueueShutdown`` instead of silently losing the item.  The TCP
server/client and the result pump come with the runtime slice.
"""

from __future__ import annotations

import queue as queue_mod
import threading
from typing import Any, List


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
