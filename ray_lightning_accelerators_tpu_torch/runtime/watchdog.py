"""Liveness: find the workers that stopped making progress.

Port of the JAX package's ``runtime/watchdog.py``.  A dead worker fails
its futures ("worker died", ``runtime/actors.py``); a worker wedged
inside its work (a broken collective, a hung kernel, a deadlocked data
pipeline) never does, and the driver would wait forever.  Three pieces:

- **HeartbeatChannel**: shared memory between a worker process and the
  driver, made from the pool's ``spawn`` context.  A worker thread
  (``WorkerBeat``) stamps a beat every ``RLA_TPU_WORKER_HEARTBEAT_S``;
  the dispatch loop brackets each call with a busy-since marker and a
  dispatch count.  ``CLOCK_MONOTONIC`` is system-wide, so the driver
  reads ages with no clock agreement.
- **Watchdog**: a driver thread classifying each rank ``ok | slow |
  wedged | dead`` from its liveness, beat age and busy time.  A rank is
  wedged when its beat is staler than ``RLA_TPU_WEDGE_TIMEOUT_S`` (a
  frozen process), or a dispatch overran the dispatch deadline (hung
  work); before its first beat a worker is judged against the boot
  grace.  Wedged ranks are reaped (``Worker.reap``), so their futures
  fail with ``WorkerWedged`` carrying the diagnosis.
- **Diagnosis records**: every reap leaves a dict (``error`` /
  ``detail`` and the beat, busy and dispatch context, with the rank's
  flight-recorder tail) on the exception and in ``Watchdog.reaped``;
  ``stall_record`` flattens an exception into the same shape.

Transitions are condition-signalled (``wait_for_state``), and each one
is a ``watchdog_transition`` event of ``telemetry/recorder.py``.
"""

from __future__ import annotations

import json
import multiprocessing as mp
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..analysis import knobs
from ..telemetry import recorder as telemetry
from ..utils.logging import log

HEARTBEAT_ENV = "RLA_TPU_WORKER_HEARTBEAT_S"
WEDGE_ENV = "RLA_TPU_WEDGE_TIMEOUT_S"
DEFAULT_HEARTBEAT_S = 1.0
DEFAULT_WEDGE_TIMEOUT_S = 60.0
# how long a rank that never beat may boot before it reads wedged
DEFAULT_BOOT_GRACE_S = 120.0

STATE_OK = "ok"
STATE_SLOW = "slow"
STATE_WEDGED = "wedged"
STATE_DEAD = "dead"


def heartbeat_interval_s(env: Optional[Dict[str, str]] = None) -> float:
    """The beat interval (a worker's env overlay over the process env);
    ``<= 0`` turns the channel off."""
    return knobs.get_float(HEARTBEAT_ENV, DEFAULT_HEARTBEAT_S, env=env)


def wedge_timeout_from_env() -> Optional[float]:
    """The configured wedge threshold, or None when unset."""
    return knobs.get_float(WEDGE_ENV, None)


class WorkerWedged(RuntimeError):
    """A rank was alive but stopped making progress, and the watchdog
    killed it.  Retry layers treat it as a retryable failure of the
    whole attempt."""

    _MARKER = "| diagnosis="

    def __init__(self, message: str, rank: Optional[int] = None,
                 diagnosis: Optional[Dict[str, Any]] = None):
        super().__init__(message)
        self.rank = rank
        self.diagnosis = dict(diagnosis or {})

    @classmethod
    def for_rank(cls, rank: int,
                 diagnosis: Dict[str, Any]) -> "WorkerWedged":
        diagnosis = dict(diagnosis)
        diagnosis.setdefault("rank", rank)
        detail = diagnosis.get("detail", "stopped making progress")
        msg = (f"worker {rank} wedged (killed by watchdog): {detail} "
               f"{cls._MARKER}"
               f"{json.dumps(diagnosis, sort_keys=True, default=str)}")
        return cls(msg, rank=rank, diagnosis=diagnosis)

    @classmethod
    def from_message(cls, message: str) -> "WorkerWedged":
        """Rebuild from a message that crossed a pipe, with the diagnosis
        it carries."""
        diagnosis: Dict[str, Any] = {}
        i = message.find(cls._MARKER)
        if i >= 0:
            try:
                diagnosis = json.loads(message[i + len(cls._MARKER):])
            except ValueError:
                pass
        return cls(message, rank=diagnosis.get("rank"), diagnosis=diagnosis)


# --------------------------------------------------------------------- #
# Heartbeat channel (shared memory, driver <-> worker process)           #
# --------------------------------------------------------------------- #
class HeartbeatChannel:
    """Four shared scalars: the last beat, the busy-since marker (0 =
    idle), the dispatch count and a started flag.  Made on the driver
    with the pool's context, so it ships in the spawn ``Process`` args;
    stamped in the worker; read on the driver as ages."""

    def __init__(self, ctx: Optional[Any] = None):
        ctx = ctx or mp.get_context("spawn")
        now = time.monotonic()
        self._beat = ctx.Value("d", now)
        self._busy_since = ctx.Value("d", 0.0)
        self._dispatches = ctx.Value("L", 0)
        # set at the worker's first stamp: until then it is booting (an
        # interpreter and its imports), judged against the boot grace
        self._started = ctx.Value("b", 0)

    # -- worker side --------------------------------------------------- #
    def stamp(self) -> None:
        self._beat.value = time.monotonic()
        self._started.value = 1

    def begin_dispatch(self) -> None:
        now = time.monotonic()
        with self._dispatches.get_lock():
            self._dispatches.value += 1
        self._busy_since.value = now
        self._beat.value = now
        self._started.value = 1

    def end_dispatch(self) -> None:
        self._busy_since.value = 0.0
        self._beat.value = time.monotonic()

    # -- driver side --------------------------------------------------- #
    def snapshot(self) -> Dict[str, Any]:
        """Ages, not absolute times."""
        now = time.monotonic()
        beat = self._beat.value
        busy = self._busy_since.value
        return {
            "beat_age_s": max(0.0, now - beat),
            "busy_s": max(0.0, now - busy) if busy > 0.0 else None,
            "dispatches": int(self._dispatches.value),
            "started": bool(self._started.value),
        }


class WorkerBeat:
    """The worker side: a daemon thread stamping the channel every
    ``interval_s``.  ``freeze()`` stops the stamps for good (chaos's
    ``hang``: a frozen process stops beating)."""

    def __init__(self, channel: HeartbeatChannel, interval_s: float):
        self.channel = channel
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._frozen = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self.channel.stamp()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="rla-torch-heartbeat")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            if not self._frozen.is_set():
                self.channel.stamp()

    def begin_dispatch(self) -> None:
        if not self._frozen.is_set():
            self.channel.begin_dispatch()

    def end_dispatch(self) -> None:
        if not self._frozen.is_set():
            self.channel.end_dispatch()

    def freeze(self) -> None:
        self._frozen.set()

    def stop(self) -> None:
        self._stop.set()


# --------------------------------------------------------------------- #
# Watchdog (driver side)                                                 #
# --------------------------------------------------------------------- #
class Watchdog:
    """Classify every rank of a pool ``ok | slow | wedged | dead`` and
    (by default) reap the wedged ones.

    ``wedge_timeout_s``: a beat staler than this is a frozen process
    (default ``RLA_TPU_WEDGE_TIMEOUT_S``, else 60 s).
    ``dispatch_deadline_s``: one dispatch busy longer than this is hung
    work; None lets a dispatch run as long as it likes (a fit is one
    dispatch).  ``slow_after_s``: busy past this is ``slow``, a
    straggler, never killed (default half the trigger).  ``auto_reap``:
    kill wedged ranks through ``worker.reap`` and record a diagnosis.
    ``boot_grace_s``: the staleness allowed a worker that has never
    beaten (interpreter start and imports).  ``workers`` is a pool or a
    list; a pool is listed again at every sweep, so ranks added or
    dropped between polls enter or leave supervision."""

    def __init__(self, workers: Any,
                 wedge_timeout_s: Optional[float] = None,
                 dispatch_deadline_s: Optional[float] = None,
                 slow_after_s: Optional[float] = None,
                 poll_s: Optional[float] = None,
                 auto_reap: bool = True,
                 boot_grace_s: float = DEFAULT_BOOT_GRACE_S,
                 on_transition: Optional[
                     Callable[[int, Optional[str], str], None]] = None):
        self._source = workers
        self.workers = list(getattr(workers, "workers", workers))
        if wedge_timeout_s is None:
            wedge_timeout_s = wedge_timeout_from_env()
        if wedge_timeout_s is None:
            wedge_timeout_s = DEFAULT_WEDGE_TIMEOUT_S
        self.wedge_timeout_s = float(wedge_timeout_s)
        self.dispatch_deadline_s = dispatch_deadline_s
        trigger = (dispatch_deadline_s if dispatch_deadline_s is not None
                   else self.wedge_timeout_s)
        self.slow_after_s = (slow_after_s if slow_after_s is not None
                             else trigger / 2.0)
        if poll_s is None:
            candidates = [self.wedge_timeout_s / 4.0]
            if dispatch_deadline_s is not None:
                candidates.append(dispatch_deadline_s / 4.0)
            poll_s = min(1.0, max(0.02, min(candidates)))
        self.poll_s = poll_s
        self.auto_reap = auto_reap
        self.boot_grace_s = max(boot_grace_s, self.wedge_timeout_s)
        self.on_transition = on_transition
        self.reaped: List[Dict[str, Any]] = []
        self._states: Dict[int, str] = {
            w.rank: STATE_OK for w in self.workers}
        self._cond = threading.Condition()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- classification ------------------------------------------------ #
    def classify(self, worker: Any) -> Tuple[str, Dict[str, Any]]:
        """One worker's state from its current snapshot."""
        try:
            alive = worker.is_alive
        except BaseException:
            alive = False
        if not alive:
            return STATE_DEAD, {
                "detail": "process dead "
                          f"(exitcode={getattr(worker, 'exitcode', None)})"}
        hb = getattr(worker, "heartbeat", None)
        snap = None
        if hb is not None:
            try:
                snap = hb.snapshot()
            except BaseException:
                snap = None
        if snap is None:
            # no channel (heartbeats off): liveness only, never a false
            # kill
            return STATE_OK, {}
        info = dict(snap)
        busy = snap.get("busy_s")
        started = snap.get("started", True)
        stale_after = (self.wedge_timeout_s if started
                       else self.boot_grace_s)
        if snap["beat_age_s"] > stale_after:
            what = "wedge timeout" if started else "boot grace"
            info["detail"] = (f"heartbeat stale {snap['beat_age_s']:.2f}s "
                              f"> {what} {stale_after:.2f}s")
            return STATE_WEDGED, info
        if (busy is not None and self.dispatch_deadline_s is not None
                and busy > self.dispatch_deadline_s):
            info["detail"] = (f"dispatch busy {busy:.2f}s > deadline "
                              f"{self.dispatch_deadline_s:.2f}s")
            return STATE_WEDGED, info
        if busy is not None and busy > self.slow_after_s:
            info["detail"] = (f"dispatch busy {busy:.2f}s "
                              f"(straggler past {self.slow_after_s:.2f}s)")
            return STATE_SLOW, info
        return STATE_OK, info

    def _diagnosis(self, worker: Any,
                   info: Dict[str, Any]) -> Dict[str, Any]:
        diagnosis = {
            "error": "worker wedged",
            "rank": worker.rank,
            "state": STATE_WEDGED,
            "detail": info.get("detail", "stopped making progress"),
            "beat_age_s": info.get("beat_age_s"),
            "busy_s": info.get("busy_s"),
            "dispatches": info.get("dispatches"),
            "wedge_timeout_s": self.wedge_timeout_s,
            "dispatch_deadline_s": self.dispatch_deadline_s,
        }
        # the wedged rank's last flight-recorder events, read from its
        # spill file (a frozen process cannot answer; the file can)
        try:
            tail_fn = getattr(worker, "telemetry_tail", None)
            snap = tail_fn() if tail_fn is not None else None
            if snap:
                diagnosis["events"] = telemetry.tail_events(snap)
                if snap.get("trace_id"):
                    diagnosis["trace_id"] = snap["trace_id"]
        except BaseException:
            pass  # a postmortem garnish never blocks the reap
        return diagnosis

    # -- polling ------------------------------------------------------- #
    def poll_once(self) -> Dict[int, str]:
        """One sweep; reaps newly wedged ranks when ``auto_reap``.
        Returns ``{rank: state}``."""
        self.workers = list(getattr(self._source, "workers",
                                    self._source))
        new_states: Dict[int, str] = {}
        to_reap: List[Tuple[Any, Dict[str, Any]]] = []
        for w in self.workers:
            state, info = self.classify(w)
            if state == STATE_WEDGED and self.auto_reap \
                    and self._states.get(w.rank) != STATE_WEDGED:
                to_reap.append((w, info))
            new_states[w.rank] = state
        for w, info in to_reap:
            diagnosis = self._diagnosis(w, info)
            self.reaped.append(diagnosis)
            log.error("watchdog reaping wedged worker %d: %s", w.rank,
                      json.dumps(diagnosis, sort_keys=True, default=str))
            try:
                w.reap(diagnosis)
            except BaseException as e:
                log.warning("reap of worker %d failed: %s", w.rank, e)
        transitions: List[Tuple[int, Optional[str], str]] = []
        with self._cond:
            for rank, state in new_states.items():
                old = self._states.get(rank)
                if old != state:
                    transitions.append((rank, old, state))
                    if self.on_transition is not None:
                        try:
                            self.on_transition(rank, old, state)
                        except BaseException:
                            pass
            self._states = new_states
            self._cond.notify_all()
        # outside the lock: a recorder spill is disk I/O
        for rank, old, state in transitions:
            try:
                telemetry.emit("watchdog_transition", rank=rank,
                               prev=old, state=state)
            except BaseException:
                pass
        return dict(new_states)

    def states(self) -> Dict[int, str]:
        with self._cond:
            return dict(self._states)

    def report(self) -> Dict[str, Any]:
        """The states and the reap records."""
        return {"states": self.states(), "reaped": list(self.reaped),
                "wedge_timeout_s": self.wedge_timeout_s,
                "dispatch_deadline_s": self.dispatch_deadline_s}

    def wait_for(self, predicate: Callable[[Dict[int, str]], bool],
                 timeout: float) -> bool:
        """Block until ``predicate(states)`` holds, or ``timeout``."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while not predicate(dict(self._states)):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(remaining)
            return True

    def wait_for_state(self, rank: int, state: str, timeout: float) -> bool:
        return self.wait_for(lambda s: s.get(rank) == state, timeout)

    # -- lifecycle ----------------------------------------------------- #
    def start(self) -> "Watchdog":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="rla-torch-watchdog")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.poll_once()
            except BaseException as e:
                # supervision never takes the driver down
                log.warning("watchdog poll failed: %s", e)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def __enter__(self) -> "Watchdog":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


def stall_record(exc: BaseException, stage: str) -> Dict[str, Any]:
    """A flat diagnosis of a failed run: ``error`` / ``detail`` plus
    ``stall_*`` keys from the wedge diagnosis.  A drained preemption is
    ``"preempted"``, a resume point, not a stall."""
    from .preemption import is_preemption
    if is_preemption(exc):
        error = "preempted"
    elif isinstance(exc, WorkerWedged):
        error = "worker wedged"
    elif isinstance(exc, TimeoutError):
        error = "attempt deadline exceeded"
    else:
        error = "worker died"
    record: Dict[str, Any] = {
        "metric": "worker_stall", "value": 0, "unit": "alive",
        "error": error, "stage": stage,
        "detail": str(exc)[-500:],
        "rank": getattr(exc, "rank", None),
    }
    for k, v in getattr(exc, "diagnosis", {}).items():
        record[f"stall_{k}"] = v
    return record
