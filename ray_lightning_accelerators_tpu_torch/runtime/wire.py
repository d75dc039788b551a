"""The wire-exception registry: typed errors that survive the worker pipe.

Port of the JAX package's ``runtime/wire.py``.  A worker's exception
crosses the pipe as ``(type name, message, traceback)``
(``runtime/actors.py``).  The retry layers need the types they branch on
rebuilt on the driver: ``Preempted`` resumes without charging the
failure budget, ``WorkerWedged`` is a retryable hang,
``NumericAnomaly`` is a rewind, ``PipelineHandoffTimeout`` names the
stage it waited on, ``CollectiveMismatch``
(``testing/spmd_sanitizer.py``) names the first divergent collective
call.  ``rebuild_remote`` is the one place they are rebuilt
(``actors.Worker._collect``); anything unregistered stays a
``RemoteError``.

``WIRE_EXCEPTION_NAMES`` is a literal set, so the lint's
``wire-exception`` rule reads it without importing the runtime.

A class with structured fields carries them in its message (a JSON
marker) and rebuilds with ``from_message``; the plain ones rebuild from
the message alone.
"""

from __future__ import annotations

from typing import Callable, Dict

WIRE_EXCEPTION_NAMES = frozenset({
    "WorkerWedged",
    "Preempted",
    "ElasticResizeError",
    "QueueShutdown",
    "ObjectStoreError",
    "CollectiveMismatch",
    "PipelineHandoffTimeout",
    "NumericAnomaly",
})


def _rebuilders() -> Dict[str, Callable[[str], BaseException]]:
    # imported here: every runtime module may import this one
    from ..parallel.mpmd.handoff import PipelineHandoffTimeout
    from ..testing.spmd_sanitizer import CollectiveMismatch
    from .elastic import ElasticResizeError
    from .guardian import NumericAnomaly
    from .object_store import ObjectStoreError
    from .preemption import Preempted
    from .queue import QueueShutdown
    from .watchdog import WorkerWedged

    return {
        "WorkerWedged": WorkerWedged.from_message,
        "Preempted": Preempted.from_message,
        "ElasticResizeError": ElasticResizeError,
        "QueueShutdown": QueueShutdown,
        "ObjectStoreError": ObjectStoreError,
        "CollectiveMismatch": CollectiveMismatch.from_message,
        "PipelineHandoffTimeout": PipelineHandoffTimeout.from_message,
        "NumericAnomaly": NumericAnomaly.from_message,
    }


def rebuild_remote(name: str, message: str,
                   remote_traceback: str) -> BaseException:
    """The typed exception of a wire tuple, or ``RemoteError`` for
    anything unregistered.  A rebuilt exception carries ``remote_typed =
    True`` (the dispatched code raised it, not the driver's
    supervision)."""
    from .actors import RemoteError

    rebuild = _rebuilders().get(name)
    if rebuild is not None:
        try:
            exc = rebuild(message)
            exc.remote_typed = True
            return exc
        except Exception:  # a malformed payload must not hide the error
            pass
    return RemoteError(name, message, remote_traceback)
