"""Elastic execution: per-worker work retried across worker failures.

Port of the JAX package's ``runtime/elastic.py``.  ``ElasticRunner``
dispatches a function to every worker of an ``ActorPool`` until one
attempt succeeds on all of them, on the runtime's primitives:

- **detection**: a dead worker fails its futures ("worker died"); a hung
  one is reaped by a per-attempt ``runtime.watchdog.Watchdog`` (stale
  heartbeat or overrun dispatch deadline) and fails with
  ``WorkerWedged``, retried as a crash is;
- **restart**: every rank restarts between attempts
  (``pool.restart_all``), since the peers of a broken collective are
  alive but stuck;
- **preemption** (``runtime/preemption.py``): a drained ``Preempted``
  resumes without charging the failure budget, bounded by
  ``max_preemptions``; a preempted driver hands it up;
- **scale-down**: with ``allow_shrink`` a rank whose host never comes
  back (``pool.find_lost``; chaos ``lost@rankN``) is dropped and the
  next attempt dispatches at the surviving world size
  (``args_per_worker(attempt, world_size)``), floored by
  ``min_workers``;
- **rewind** (``runtime/guardian.py``): a typed ``NumericAnomaly``
  resumes without charging the failure budget (the fit body rewinds to
  the last verified checkpoint and skips the quarantined window),
  bounded by ``max_rewinds`` (``RLA_TPU_GUARD_MAX_REWINDS``); a
  data-blamed step that trips again after its quarantine is terminal;
  an SDC verdict naming a rank demotes it through the shrink path.

Recovery is checkpoint-based: each attempt re-runs the whole function
on every rank, which resumes from the latest verified checkpoint
(``Trainer.fit(ckpt_path="last")``).  ``attempts_used``, the event lists
and the goodput ledger (``telemetry/perf.py``) record the run; with
``report_dir`` every failed attempt and every terminal exit writes
``run_report.json`` (``telemetry/registry.py``).

``resize_in_memory=True``: the survivors of a failed attempt keep their
processes and whatever live state their body retained (the in-memory
alternative to the checkpoint round trip, e.g. a body around
``Trainer.resize_in_memory`` and ``fit(ckpt_path="live")``).  Between
attempts the pool grows back first (``pool.revive`` of the dropped ranks
whose host answers again), the dead ranks respawn in place
(``restart_dead``), and with ``allow_shrink`` ``find_lost(classify=True)``
tells a revivable host from a gone one, whose rank is dropped (floored by
``min_workers``); ``init_hook`` runs only on the fresh processes.  The
pause is the goodput ledger's ``resize`` phase, bracketed by
``resize_begin`` / ``resize_end``; ``grow_events`` records the grows.  A
body keeps the checkpoint chain as its fallback: when no survivor holds
usable state, an attempt resumes from disk, charging the failure budget
once.

**Collective mismatch** (``testing/spmd_sanitizer.py``, opt-in through
``RLA_TPU_SPMD_SANITIZER`` with a telemetry dir): a hang-shaped failure
(``WorkerWedged``, ``TimeoutError``) whose rank spills diverge raises
the typed ``CollectiveMismatch`` at once, after one attempt: a
divergent collective is deterministic, and a retry would hang again.
A crash is never decoded (its spill is cut off mid-run).  The spills
are cleared at run entry and before each retry's restart.
"""

from __future__ import annotations

import inspect
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..analysis import knobs
from ..telemetry import perf as perf_lib
from ..telemetry import recorder as telemetry
from ..utils.backoff import DEFAULT_BACKOFF_CAP_S, backoff_delay_s
from ..utils.logging import log
from . import guardian as guardian_lib
from . import preemption as preempt_lib
from .actors import ActorPool
from .queue import TrampolineQueue, process_results
from .watchdog import Watchdog, WorkerWedged, wedge_timeout_from_env

BACKOFF_BASE_ENV = "RLA_TPU_ELASTIC_BACKOFF_S"
BACKOFF_CAP_ENV = "RLA_TPU_ELASTIC_BACKOFF_CAP_S"

__all__ = ["ElasticResizeError", "ElasticRunner", "backoff_delay_s",
           "DEFAULT_BACKOFF_CAP_S"]


class ElasticResizeError(ValueError):
    """Resuming at another world size is impossible (a divisibility
    contract breaks): "pick a compatible size", not a crash."""


class ElasticRunner:
    """Run per-worker callables with restart-and-resume on failure."""

    def __init__(self, pool: ActorPool, max_failures: int = 3,
                 backoff_s: float = 0.0,
                 on_failure: Optional[Callable[[int, BaseException], None]]
                 = None,
                 init_hook: Optional[Callable[[], None]] = None,
                 wedge_timeout_s: Optional[float] = None,
                 dispatch_deadline_s: Optional[float] = None,
                 watchdog_poll_s: Optional[float] = None,
                 allow_shrink: bool = False,
                 resize_in_memory: bool = False,
                 min_workers: int = 1,
                 probe_timeout_s: float = 120.0,
                 max_preemptions: int = 3,
                 max_rewinds: Optional[int] = None,
                 backoff_cap_s: float = DEFAULT_BACKOFF_CAP_S,
                 report_dir: Optional[str] = None,
                 guard_root_dir: Optional[str] = None):
        """``max_failures``: attempts beyond the first before giving up.
        ``on_failure(attempt, exc)``: called for each charged failure.
        ``init_hook``: run on the restarted workers before a retry.
        ``backoff_s``: the base of the exponential backoff with
        half-jitter, capped at ``backoff_cap_s`` (the knobs
        ``RLA_TPU_ELASTIC_BACKOFF_S`` / ``_CAP_S`` override both); 0
        sleeps not at all.  ``wedge_timeout_s`` (stale-heartbeat
        threshold), ``dispatch_deadline_s`` (one attempt's budget) or
        ``RLA_TPU_WEDGE_TIMEOUT_S`` arm a watchdog for each attempt.
        ``allow_shrink`` / ``min_workers`` / ``probe_timeout_s``: the
        scale-down (``args_per_worker`` must then take ``(attempt,
        world_size)``).  ``max_preemptions`` and ``max_rewinds`` (None:
        ``RLA_TPU_GUARD_MAX_REWINDS``) bound the resumes that charge
        nothing.  ``report_dir``: where failures write
        ``run_report.json``.  ``guard_root_dir``: the fit's root, where
        a rewind's anchor is looked up for ``anomaly_events``."""
        self.pool = pool
        self.resize_in_memory = resize_in_memory
        self.report_dir = report_dir
        self.guard_root_dir = guard_root_dir
        self.max_failures = max_failures
        self.backoff_s = knobs.get_float(BACKOFF_BASE_ENV, backoff_s)
        self.backoff_cap_s = knobs.get_float(BACKOFF_CAP_ENV,
                                             backoff_cap_s)
        self.on_failure = on_failure
        self.init_hook = init_hook
        self.wedge_timeout_s = wedge_timeout_s
        self.dispatch_deadline_s = dispatch_deadline_s
        self.watchdog_poll_s = watchdog_poll_s
        self.allow_shrink = allow_shrink
        self.min_workers = max(1, min_workers)
        self.probe_timeout_s = probe_timeout_s
        self.max_preemptions = max_preemptions
        self.max_rewinds = (max_rewinds if max_rewinds is not None
                            else guardian_lib.max_rewinds_from_env())
        self.attempts_used = 0
        # one reap record per wedged rank, across attempts
        self.wedge_events: List[Dict[str, Any]] = []
        # the drains resumed, and the scale-downs ({"dropped", ...})
        self.preempt_events: List[preempt_lib.Preempted] = []
        self.shrink_events: List[Dict[str, Any]] = []
        # the in-memory grows ({"revived", "world_size", "attempt"})
        self.grow_events: List[Dict[str, Any]] = []
        # the rewinds resumed: each anomaly's diagnosis (with the anchor
        # when guard_root_dir is given)
        self.anomaly_events: List[Dict[str, Any]] = []
        # a driver notice (with a grace budget): a preempted driver ends
        # the loop instead of respawning workers on a host that goes
        self._notice = preempt_lib.install_from_env()
        # the overheads only the driver sees (restart and boot, backoff,
        # the wait before a wedge was reaped)
        self.goodput = perf_lib.GoodputLedger()

    def _write_report(self, exc: BaseException) -> None:
        """``run_report.json`` for a failed or preempted attempt (nothing
        without ``report_dir``); never hides ``exc``."""
        if not self.report_dir:
            return
        try:
            from ..telemetry import registry as treg
            stall = getattr(exc, "diagnosis", None) or (
                self.wedge_events[-1] if self.wedge_events else None)
            treg.write_run_report(
                self.report_dir, error=exc,
                rank_events=treg.gather_worker_tails(self.pool.workers),
                stall_diagnosis=stall,
                extra={"attempts_used": self.attempts_used,
                       "world_size": len(self.pool)})
        except BaseException as e:
            log.warning("elastic run-report write failed: %s", e)

    def _collective_mismatch(self, exc: BaseException):
        """The sanitizer's verdict on a failed attempt (None unless
        ``RLA_TPU_SPMD_SANITIZER`` and a telemetry dir are set): the
        typed ``CollectiveMismatch`` when the rank spills diverge.  Only
        hang-shaped failures are decoded; never hides ``exc``."""
        if not isinstance(exc, (WorkerWedged, TimeoutError)):
            return None
        try:
            from ..testing import spmd_sanitizer
            return spmd_sanitizer.check_world_collectives(
                raise_on_mismatch=False)
        except Exception:
            return None

    def _reset_collectives(self) -> None:
        """Clear the rank spills (same gating): an attempt is never
        diffed against an earlier attempt's or run's sequences.
        Restarted ranks spill again at their boot install."""
        try:
            from ..testing import spmd_sanitizer
            spmd_sanitizer.reset_world_collectives()
        except Exception:
            pass

    def _supervised(self) -> bool:
        return (self.wedge_timeout_s is not None
                or self.dispatch_deadline_s is not None
                or wedge_timeout_from_env() is not None)

    def _shrink(self, ranks: List[int], attempt: int,
                **extra: Any) -> None:
        dropped = self.pool.drop(ranks)
        event = {"dropped": dropped, "world_size": len(self.pool),
                 "attempt": attempt + 1, **extra}
        self.shrink_events.append(event)
        telemetry.emit("elastic_shrink", **event)
        log.warning("elastic scale-down: %s", event)

    def _demote_suspect(self, anomaly: Any, attempt: int) -> None:
        """An SDC verdict naming a rank: with ``allow_shrink`` the rank
        is dropped as a lost host is (floored by ``min_workers``);
        without it the rewind alone is the recovery."""
        suspect = guardian_lib.demotion_target(anomaly)
        if not self.allow_shrink or suspect is None:
            return
        if not any(w.rank == suspect for w in self.pool.workers):
            return
        if len(self.pool) - 1 < self.min_workers:
            log.warning("elastic SDC demotion skipped: dropping rank %d "
                        "would leave %d < min_workers=%d", suspect,
                        len(self.pool) - 1, self.min_workers)
            return
        self._shrink([suspect], attempt, blame=anomaly.blame)

    def _build_args(self, args_per_worker, attempt: int) -> Sequence[tuple]:
        """The per-rank argument tuples; a builder with a required second
        positional parameter gets the current world size."""
        try:
            params = [
                p for p in
                inspect.signature(args_per_worker).parameters.values()
                if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
            # a defaulted second parameter, **opts, *args or keyword-only
            # extras keep the one-argument call
            takes_world = (len(params) >= 2
                           and params[1].default is inspect.Parameter.empty)
        except (TypeError, ValueError):
            takes_world = False
        if takes_world:
            args = args_per_worker(attempt, len(self.pool))
        else:
            args = args_per_worker(attempt)
        if len(args) != len(self.pool):
            raise ValueError(
                f"args_per_worker built {len(args)} argument tuples for a "
                f"pool of {len(self.pool)} workers; under allow_shrink it "
                "must accept (attempt, world_size) and size its output to "
                "the current world")
        return args

    def _prepare_retry(self, attempt: int, failures: int) -> None:
        """Between attempts: backoff, restart every rank, drop the ranks
        whose host never came back, run the init hook."""
        delay = backoff_delay_s(failures, self.backoff_s,
                                self.backoff_cap_s)
        if delay > 0:
            log.warning("elastic backoff %.2fs before attempt %d",
                        delay, attempt + 1)
            time.sleep(delay)
        # cleared before the restart: each respawned rank spills again
        # at its boot install, so the retry diffs only its own calls
        self._reset_collectives()
        if self.resize_in_memory:
            self._prepare_retry_in_memory(attempt)
            return
        restarted = self.pool.restart_all(
            init_hook=None if self.allow_shrink else self.init_hook)
        log.warning("elastic attempt %d (restarted ranks %s)",
                    attempt + 1, restarted)
        if not self.allow_shrink:
            return
        lost = self.pool.find_lost(timeout_s=self.probe_timeout_s)
        if lost:
            survivors = len(self.pool) - len(lost)
            if survivors < self.min_workers:
                raise RuntimeError(
                    f"elastic scale-down impossible: ranks {lost} are "
                    f"gone, leaving {survivors} < min_workers="
                    f"{self.min_workers}")
            self._shrink(lost, attempt)
        if self.init_hook is not None:
            for f in self.pool.execute_all(self.init_hook):
                f.result()

    def _prepare_retry_in_memory(self, attempt: int) -> None:
        """Between attempts under ``resize_in_memory``: no
        ``restart_all``, the survivors keep their processes.  In order:
        grow (``revive`` each dropped rank whose host answers again),
        respawn the dead ranks in place (``restart_dead``), shrink (with
        ``allow_shrink``, ``find_lost(classify=True)``'s gone ranks are
        dropped, floored by ``min_workers``), then ``init_hook`` on the
        fresh processes only (on a survivor it would wipe the live
        state)."""
        fresh: List[int] = []
        for rank in self.pool.dropped_ranks():
            if self.pool.revive(rank, probe_timeout_s=self.probe_timeout_s) \
                    is not None:
                fresh.append(rank)
        if fresh:
            event = {"revived": sorted(fresh),
                     "world_size": len(self.pool), "attempt": attempt + 1}
            self.grow_events.append(event)
            telemetry.emit("elastic_grow", **event)
            log.warning("elastic grow: %s", event)
        fresh.extend(self.pool.restart_dead())
        log.warning("elastic attempt %d (in-memory resize; respawned "
                    "ranks %s)", attempt + 1, sorted(fresh))
        if self.allow_shrink:
            verdict = self.pool.find_lost(timeout_s=self.probe_timeout_s,
                                          classify=True)
            fresh.extend(verdict["revived"])
            gone = verdict["gone"]
            if gone:
                survivors = len(self.pool) - len(gone)
                if survivors < self.min_workers:
                    raise RuntimeError(
                        f"elastic scale-down impossible: ranks {gone} "
                        f"are gone, leaving {survivors} < min_workers="
                        f"{self.min_workers}")
                self._shrink(gone, attempt)
        if self.init_hook is not None and fresh:
            targets = [w for w in self.pool.workers if w.rank in set(fresh)]
            for f in [w.execute(self.init_hook) for w in targets]:
                f.result()

    def run(self, fn: Callable,
            args_per_worker: Optional[Callable[..., Sequence[tuple]]]
            = None,
            queue: Optional[TrampolineQueue] = None) -> List[Any]:
        """Dispatch ``fn`` to every worker until one attempt succeeds on
        all of them; per-rank results.  ``args_per_worker(attempt)`` (or
        ``(attempt, world_size)``) builds each attempt's arguments;
        ``fn`` must be re-runnable from a checkpoint."""
        last_exc: Optional[BaseException] = None
        attempt = 0
        failures = 0
        preemptions = 0
        rewinds = 0
        # data-blamed steps quarantined once: a second trip at one of
        # them means the quarantine did not clear it
        quarantined_steps: set = set()
        self.goodput.run_begin()
        # a fresh run is never diffed against an earlier run's sequences
        self._reset_collectives()
        while True:
            self.attempts_used = attempt + 1
            self.goodput.note_attempt()
            telemetry.emit("elastic_attempt", attempt=attempt + 1,
                           world_size=len(self.pool))
            if attempt > 0:
                # under resize_in_memory the survivors keep their
                # processes: the pause is an in-memory resize, accounted
                # and bracketed as one
                old_world = len(self.pool)
                if self.resize_in_memory:
                    telemetry.emit("resize_begin", old_world=old_world,
                                   attempt=attempt + 1)
                t_prep = time.monotonic()
                with self.goodput.measure(
                        "resize" if self.resize_in_memory else "restart"):
                    self._prepare_retry(attempt, failures)
                if self.resize_in_memory:
                    telemetry.emit("resize_end", old_world=old_world,
                                   new_world=len(self.pool),
                                   attempt=attempt + 1,
                                   seconds=time.monotonic() - t_prep)
            watchdog: Optional[Watchdog] = None
            # built outside the try: a mis-sized builder is a
            # configuration error, not a retryable failure
            args = (self._build_args(args_per_worker, attempt)
                    if args_per_worker is not None else None)
            try:
                if args is not None:
                    futures = self.pool.execute_per_worker(fn, args)
                else:
                    futures = self.pool.execute_all(fn)
                hard_deadline = None
                if self._supervised():
                    # per attempt: started after the dispatch, stopped
                    # before any restart touches the pool
                    watchdog = Watchdog(
                        self.pool,
                        wedge_timeout_s=self.wedge_timeout_s,
                        dispatch_deadline_s=self.dispatch_deadline_s,
                        poll_s=self.watchdog_poll_s).start()
                    if self.dispatch_deadline_s is not None:
                        # the backstop, padded past the watchdog's
                        # trigger so the typed WorkerWedged wins
                        hard_deadline = self.dispatch_deadline_s + max(
                            30.0, watchdog.wedge_timeout_s)
                results = process_results(futures, queue,
                                          deadline_s=hard_deadline,
                                          channel=self.pool.channel)
                self.goodput.run_end()
                return results
            except BaseException as e:  # noqa: BLE001 -- resurfaced below
                last_exc = e
                anomaly = guardian_lib.anomaly_of(e)
                if preempt_lib.is_preemption(e):
                    # a drain resumes; the budget stays whole
                    preempted = preempt_lib.as_preempted(e)
                    self.goodput.note_preemption()
                    self.preempt_events.append(preempted)
                    telemetry.emit("elastic_preempt_resume",
                                   attempt=attempt + 1,
                                   step=getattr(preempted, "step", None))
                    if (self._notice is not None
                            and self._notice.requested()):
                        # the driver is preempted too: hand it up
                        self._write_report(preempted)
                        raise preempted from e
                    preemptions += 1
                    if preemptions > self.max_preemptions:
                        self._write_report(preempted)
                        raise RuntimeError(
                            f"elastic run preempted {preemptions} times "
                            f"(max_preemptions={self.max_preemptions})"
                        ) from e
                    log.warning("attempt %d preempted (%s); resuming "
                                "from the emergency checkpoint",
                                attempt + 1, preempted)
                elif anomaly is not None:
                    # a rewind: the retry resumes from the last verified
                    # checkpoint and skips the quarantined window
                    event = dict(anomaly.diagnosis)
                    if self.guard_root_dir:
                        event["anchor"] = guardian_lib.rewind_anchor(
                            self.guard_root_dir)
                    self.anomaly_events.append(event)
                    telemetry.emit("rewind", attempt=attempt + 1,
                                   step=anomaly.step, blame=anomaly.blame,
                                   suspect_rank=anomaly.suspect_rank)
                    if guardian_lib.is_terminal_repeat(anomaly,
                                                       quarantined_steps):
                        self._write_report(anomaly)
                        raise RuntimeError(
                            f"numeric anomaly at step {anomaly.step} "
                            "recurred after its data window was "
                            "quarantined — not a data fault; refusing "
                            "to rewind again") from e
                    if anomaly.blame == guardian_lib.BLAME_DATA \
                            and anomaly.step is not None:
                        quarantined_steps.add(anomaly.step)
                    rewinds += 1
                    if rewinds > self.max_rewinds:
                        self._write_report(anomaly)
                        raise RuntimeError(
                            f"elastic run tripped the numeric guard "
                            f"{rewinds} times (max_rewinds="
                            f"{self.max_rewinds})") from e
                    self._demote_suspect(anomaly, attempt)
                    log.warning("attempt %d tripped the numeric guard "
                                "(%s); rewinding to the last verified "
                                "checkpoint", attempt + 1, anomaly)
                else:
                    mismatch = self._collective_mismatch(e)
                    if mismatch is not None:
                        # deterministic: a retry would issue the same
                        # divergent sequence and hang again
                        self._write_report(mismatch)
                        raise mismatch from e
                    failures += 1
                    telemetry.emit("elastic_failure",
                                   attempt=attempt + 1,
                                   error=type(e).__name__)
                    if self.on_failure is not None:
                        self.on_failure(attempt, e)
                    self._write_report(e)
                    if failures > self.max_failures:
                        break
            finally:
                if watchdog is not None:
                    watchdog.stop()
                    self.wedge_events.extend(watchdog.reaped)
                    for rec in watchdog.reaped:
                        # the run sat behind a frozen rank from its last
                        # progress to the reap
                        self.goodput.account(
                            "wedge_wait",
                            rec.get("beat_age_s")
                            or watchdog.wedge_timeout_s or 0.0)
            attempt += 1
        self.goodput.run_end()
        raise RuntimeError(
            f"elastic run failed after {self.max_failures + 1} attempts"
        ) from last_exc
