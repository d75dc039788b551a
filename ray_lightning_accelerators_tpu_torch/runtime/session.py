"""Per-worker session: this rank and its channel to the driver.

Port of the JAX package's ``runtime/session.py``: a process-global
singleton that gives worker-side code (callbacks) its global rank and a
way to ship zero-argument callables to the driver, which runs them while
the work goes on (``runtime.queue.process_results``).  Each run of a
``DistributedWorld`` binds a fresh session in every rank; a tune trial
binds one in the driver (``tune/run.py``).  A thread-local overlay
(``bind_session_to_thread``) wins over the process global, so
concurrent tune trials each see their own session on their threads.

A callable crosses to the driver with the standard ``pickle``: it must
be a module-level function, or a ``functools.partial`` of one over
picklable arguments; a closure or a lambda raises here, in the rank.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Optional


class Session:
    def __init__(self, rank: int, queue: Optional[Any] = None):
        self._rank = rank
        self._queue = queue

    @property
    def rank(self) -> int:
        return self._rank

    def put_queue(self, item: Callable[[], Any]) -> None:
        if self._queue is None:
            raise ValueError(
                "this session has no queue attached -- it was not launched "
                "under a driver that drains one")
        self._queue.put((self._rank, item))


_session: Optional[Session] = None
# thread-local overlay: concurrent tune trials each bind their own session
# on their trial and trainable threads without touching the process global
_tls = threading.local()


def _current() -> Optional[Session]:
    return getattr(_tls, "session", None) or _session


def init_session(rank: int, queue: Optional[Any] = None) -> None:
    install_session(Session(rank, queue))


def install_session(session: Session) -> None:
    """Set an existing session object as the process global (so a caller
    that also binds it to a thread keeps one session object)."""
    global _session
    if _session is not None:
        raise ValueError("a session already exists in this process; "
                         "call shutdown_session() first")
    _session = session


def bind_session_to_thread(session: Optional[Session]) -> None:
    """Attach (or clear, with None) a session for the current thread only;
    it shadows the process-global one."""
    _tls.session = session


def get_session() -> Session:
    s = _current()
    if s is None:
        raise ValueError("no session initialized in this process")
    return s


def shutdown_session() -> None:
    global _session
    _session = None


def session_exists() -> bool:
    return _current() is not None


def get_actor_rank() -> int:
    """Rank of this worker process."""
    return get_session().rank


def put_queue(item: Callable[[], Any]) -> None:
    """Ship a zero-argument callable to the driver, which runs it."""
    get_session().put_queue(item)
