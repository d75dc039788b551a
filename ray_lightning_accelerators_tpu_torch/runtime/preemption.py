"""Preemption drain: a termination notice becomes a clean save-and-exit.

Port of the JAX package's ``runtime/preemption.py``.  A spot or
preemptible reservation ends with a SIGTERM and a short grace window,
not a crash; this module makes that a first-class outcome:

- **PreemptionNotice**: a per-process flag (``get_notice``).
  ``install()`` hooks SIGTERM (a worker installs it when
  ``RLA_TPU_PREEMPT_GRACE_S`` is in its env, ``runtime/actors.py``); a
  notice can also be raised by ``request_local`` or, across ranks,
  through a flag file in the shared run directory (every rank's handler
  writes it, every rank's fit loop polls it), so one rank's SIGTERM
  drains the whole job.
- **The drain**: the training loop polls ``requested()`` at step
  boundaries, writes an emergency checkpoint and raises ``Preempted``,
  a typed outcome apart from a crash (``RemoteError``, "worker died")
  and a hang (``WorkerWedged``).  ``ElasticRunner`` resumes it without
  charging the failure budget; ``Trainer.fit(ckpt_path="last")`` resumes
  at the saved step.
- **The grace budget**: ``RLA_TPU_PREEMPT_GRACE_S`` seconds from the
  notice to a forced exit.  In a worker a timer enforces it; an idle
  worker (no dispatch running) exits at once on SIGTERM, so a pool's
  shutdown stays fast.
- **consensus_requested**: over a ``torch.distributed`` group the ranks
  max-reduce their flags (one int32: on the rank's card under NCCL, on
  the CPU under gloo), so every rank stops at the same step boundary.
  The trainer calls it every ``RLA_TPU_PREEMPT_CONSENSUS_EVERY`` steps
  (JAX: a process all-gather on the same schedule).

``Preempted`` carries its fields in its message (``_MARKER``), so a
worker's drain crossing the pipe as ``(name, message, traceback)`` is
rebuilt typed (``runtime/wire.py``).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Optional

from ..analysis import knobs
from ..utils.logging import log

PREEMPT_GRACE_ENV = "RLA_TPU_PREEMPT_GRACE_S"
# multi-process fits run the drain consensus every N steps (the same
# schedule on every rank, so the collective has full participation)
PREEMPT_CONSENSUS_EVERY_ENV = "RLA_TPU_PREEMPT_CONSENSUS_EVERY"
DEFAULT_GRACE_S = 30.0
# exit code of a worker's hard-exit timer (grace expired mid-drain) and
# of an idle worker exiting on SIGTERM with the handler installed
PREEMPT_EXIT_CODE = 45
FLAG_FILENAME = ".rla_preempt_notice"


def grace_from_env() -> Optional[float]:
    """The configured grace budget, or None when preemption handling is
    off (SIGTERM keeps its default: a kill).  A malformed value still
    turns it on, at the default budget."""
    return knobs.get_float(PREEMPT_GRACE_ENV, None,
                           malformed=DEFAULT_GRACE_S)


class Preempted(RuntimeError):
    """The run was preempted and drained: its state is checkpointed and
    it should be resumed (``fit(ckpt_path="last")``), not retried as a
    failure."""

    _MARKER = "| preempted="

    def __init__(self, message: str, step: Optional[int] = None,
                 ckpt_path: Optional[str] = None,
                 info: Optional[Dict[str, Any]] = None):
        super().__init__(message)
        self.step = step
        self.ckpt_path = ckpt_path
        self.info = dict(info or {})

    @classmethod
    def at_step(cls, step: int, ckpt_path: Optional[str] = None,
                source: str = "notice") -> "Preempted":
        info = {"step": int(step), "ckpt_path": ckpt_path,
                "source": source}
        msg = (f"preemption notice ({source}): drained at step {step}"
               + (f", emergency checkpoint at {ckpt_path}" if ckpt_path
                  else ", no emergency checkpoint written")
               + f" {cls._MARKER}{json.dumps(info, sort_keys=True)}")
        return cls(msg, step=step, ckpt_path=ckpt_path, info=info)

    @classmethod
    def from_message(cls, message: str) -> "Preempted":
        """Rebuild from a message that crossed a pipe, with the step and
        checkpoint it carries."""
        info: Dict[str, Any] = {}
        i = message.find(cls._MARKER)
        if i >= 0:
            tail = message[i + len(cls._MARKER):].splitlines()[0]
            try:
                info = json.loads(tail)
            except ValueError:
                pass
        return cls(message, step=info.get("step"),
                   ckpt_path=info.get("ckpt_path"), info=info)


def is_preemption(exc: BaseException) -> bool:
    """A ``Preempted``, or any exception whose message carries its marker
    (a ``RemoteError`` wraps the original as ``'Preempted: <message>'``)."""
    if isinstance(exc, Preempted):
        return True
    return Preempted._MARKER in str(exc)


def as_preempted(exc: BaseException) -> Preempted:
    """The typed form of a preemption-classified exception."""
    if isinstance(exc, Preempted):
        return exc
    return Preempted.from_message(str(exc))


class PreemptionNotice:
    """This process's preemption flag and its SIGTERM plumbing.

    ``requested()`` is true once a notice arrived by signal, by
    ``request_local()`` or through the attached flag file; it stays
    raised until ``clear()``."""

    def __init__(self):
        self._event = threading.Event()
        self._installed = False
        self._prev_handler = None
        self._worker_mode = False
        self._flag_dir: Optional[str] = None
        self._deadline: Optional[float] = None
        self._timer: Optional[threading.Timer] = None
        self.source: Optional[str] = None
        # in a worker: a dispatch is running.  An idle worker dies on
        # SIGTERM as before; only a busy one drains
        self.busy = False

    # -- state ---------------------------------------------------------- #
    def enabled(self) -> bool:
        """A handler is installed, a grace budget is configured, or a
        notice was raised."""
        return (self._installed or grace_from_env() is not None
                or self._event.is_set())

    def requested(self) -> bool:
        if self._event.is_set():
            return True
        path = self._flag_path()
        if path is not None and os.path.exists(path):
            # another rank's handler raised the notice in the shared dir
            self._event.set()
            if self.source is None:
                self.source = "flag-file"
            self._arm_deadline()
            return True
        return False

    def grace_s(self) -> float:
        g = grace_from_env()
        return DEFAULT_GRACE_S if g is None else g

    def remaining_s(self) -> Optional[float]:
        """Seconds left of the grace budget; None before any notice."""
        if self._deadline is None:
            return None
        return max(0.0, self._deadline - time.monotonic())

    def _flag_path(self) -> Optional[str]:
        if self._flag_dir is None:
            return None
        return os.path.join(self._flag_dir, FLAG_FILENAME)

    def attach_flag_dir(self, directory: str) -> None:
        """Carry notices through ``directory`` (the shared run dir): this
        process's handler writes the flag file there and ``requested()``
        polls it."""
        self._flag_dir = directory

    def clear_stale_flag(self) -> None:
        """Remove a flag file a previous drain left, so a resumed fit on
        the same directory does not drain again at its first step; never
        while this process holds a live notice."""
        if self._event.is_set():
            return
        path = self._flag_path()
        if path is None:
            return
        try:
            os.unlink(path)
            log.warning("cleared stale preemption flag file %s (left by "
                        "a previous drain)", path)
        except OSError:
            pass

    # -- raising a notice ----------------------------------------------- #
    def request_local(self, source: str = "manual") -> None:
        """Raise the notice in this process only."""
        first = not self._event.is_set()
        self._event.set()
        if first:
            self.source = source
            self._arm_deadline()

    def request(self, source: str = "manual") -> None:
        """Raise the notice and write the flag file (when a flag dir is
        attached), so every rank of the job drains."""
        self.request_local(source)
        path = self._flag_path()
        if path is None:
            return
        try:
            os.makedirs(self._flag_dir, exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump({"source": source, "pid": os.getpid(),
                           "grace_s": self.grace_s()}, f)
            os.replace(tmp, path)
        except OSError as e:
            log.warning("could not write preemption flag file %s: %s",
                        path, e)

    def _arm_deadline(self) -> None:
        if self._deadline is None:
            self._deadline = time.monotonic() + self.grace_s()
        if self._worker_mode and self._timer is None:
            # the host goes at the deadline whether or not the drain
            # finished; a stuck drain must not wedge the pool
            t = threading.Timer(self.grace_s(), os._exit,
                                args=(PREEMPT_EXIT_CODE,))
            t.daemon = True
            t.start()
            self._timer = t

    # -- signal plumbing ------------------------------------------------- #
    def _handle_sigterm(self, signum, frame) -> None:
        if not self.busy and self._worker_mode:
            # an idle worker has nothing to drain: it dies as under the
            # default SIGTERM
            os._exit(PREEMPT_EXIT_CODE)
        if self._event.is_set():
            # a second SIGTERM asks for termination, not another drain:
            # restore the previous disposition and deliver it again
            import signal
            try:
                signal.signal(signal.SIGTERM,
                              self._prev_handler or signal.SIG_DFL)
                self._installed = False
            except ValueError:
                pass
            os.kill(os.getpid(), signum)
            return
        self.request(source=f"signal-{signum}")

    def install(self, worker_mode: bool = False,
                flag_dir: Optional[str] = None) -> bool:
        """Hook SIGTERM as a preemption notice.  False (and nothing
        installed) outside the main thread; ``request_local`` and the
        flag file still work there."""
        import signal
        if flag_dir is not None:
            self.attach_flag_dir(flag_dir)
        if self._installed:
            self._worker_mode = self._worker_mode or worker_mode
            return True
        try:
            self._prev_handler = signal.signal(signal.SIGTERM,
                                               self._handle_sigterm)
        except ValueError:
            log.warning("preemption notice handler not installed (not in "
                        "the main thread); SIGTERM keeps its default, the "
                        "flag file and manual notices still work")
            return False
        self._installed = True
        self._worker_mode = worker_mode
        return True

    def uninstall(self) -> None:
        """Restore the previous SIGTERM handler."""
        if not self._installed:
            return
        import signal
        try:
            signal.signal(signal.SIGTERM,
                          self._prev_handler or signal.SIG_DFL)
        except ValueError:
            pass
        self._installed = False
        self._prev_handler = None

    def clear(self) -> None:
        """Drop a raised notice and its flag file."""
        self._event.clear()
        self.source = None
        self._deadline = None
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        path = self._flag_path()
        if path is not None:
            try:
                os.unlink(path)
            except OSError:
                pass


_notice: Optional[PreemptionNotice] = None


def get_notice() -> PreemptionNotice:
    global _notice
    if _notice is None:
        _notice = PreemptionNotice()
    return _notice


def install_from_env(worker_mode: bool = False,
                     flag_dir: Optional[str] = None
                     ) -> Optional[PreemptionNotice]:
    """Install the SIGTERM handler when ``RLA_TPU_PREEMPT_GRACE_S`` is
    configured; the notice, or None when preemption handling is off."""
    if grace_from_env() is None:
        return None
    notice = get_notice()
    notice.install(worker_mode=worker_mode, flag_dir=flag_dir)
    return notice


def consensus_requested(local: bool, device: Any = None) -> bool:
    """The drain decision every rank agrees on: outside a
    ``torch.distributed`` group of more than one rank the local flag;
    inside one, the max over the ranks of one int32 (on ``device`` when
    the backend is NCCL, else on the CPU)."""
    import torch
    import torch.distributed as dist
    if not dist.is_available() or not dist.is_initialized() \
            or dist.get_world_size() < 2:
        return local
    dev = torch.device("cpu")
    if dist.get_backend() == "nccl":
        dev = torch.device(device) if device is not None else \
            torch.device("cuda", torch.cuda.current_device())
    flag = torch.tensor([1 if local else 0], dtype=torch.int32, device=dev)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag.item())
