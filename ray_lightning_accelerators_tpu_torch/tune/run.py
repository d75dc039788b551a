"""tune.run: multi-trial hyperparameter search.

Port of the JAX package's ``tune/run.py``, with its three executors:

- sequential thread trials (the default): each trial's trainable runs in
  a worker thread while this thread drains the trial's trampoline queue;
- concurrent thread trials (``max_concurrent_trials > 1``) over disjoint
  leases of the device pool, claimed with ``tune.trial_devices()``:
  ``cuda:0..n-1`` on the card, and on the CPU a fixed pool of 8 indexed
  entries ``cpu:0..7`` (a tensor made on ``cpu:3`` lands on the CPU; the
  index lets a lease be told apart from another);
- process trials (``trial_executor="process"``): one fresh subprocess a
  trial, reporting over a ``QueueServer``; a trial that dies (``os._exit``,
  a fatal CUDA error) is ERROR and the experiment goes on.  The trial
  worker is forked from a forkserver that imported this module once (a
  trial starts with a fork, not with an interpreter and a torch import;
  no CUDA context exists there before the fork); it is no daemon, so its
  fit may spawn ranks, and it is killed when its trial ends.

Every fit of the port spawns ranks, so a tune callback runs in another
process than its trial: ``report``, ``checkpoint_payload`` and
``trial_should_stop`` inside a rank cross the world's query channel
(``runtime/bootstrap.py``) synchronously, so the scheduler has decided
before the rank's next line runs.  The worlds a trial forms are shut
when the trial ends (``bootstrap.world_scope``).

A trainable of the process executor is sent by the standard ``pickle``:
it must be a module-level function the trial subprocess can import by
name.  ``device=`` (None: the card) picks the pool of the concurrent
executor; ``run`` keeps the JAX signature otherwise.  With
``trial_executor="process"``, ``agents=`` (default ``RLA_TPU_AGENTS``)
places the trial subprocesses round-robin on host agents
(``runtime/agent.py``), their reports and stop polls crossing the queue
server, which then binds as ``queue_bind_for_agents`` says.
"""

from __future__ import annotations

import atexit
import functools
import math
import multiprocessing as mp
import os
import pickle
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..core.module import resolve_device
from ..runtime import bootstrap
from ..runtime import session as session_lib
from ..runtime.queue import TrampolineQueue, process_results
from ..utils import checkpoint as ckpt_lib
from ..utils.logging import log
from .search import generate_trial_configs

# the CPU's device pool: 8 indexed entries, as the JAX package's tests
# give JAX 8 host devices
CPU_POOL_SIZE = 8


class Trial:
    def __init__(self, trial_id: str, config: Dict[str, Any], local_dir: str):
        self.trial_id = trial_id
        self.config = config
        self.logdir = os.path.join(local_dir, trial_id)
        os.makedirs(self.logdir, exist_ok=True)
        self.results: List[Dict[str, Any]] = []
        self.checkpoints: List[Tuple[int, str]] = []  # (step, path)
        self.status = "PENDING"
        self.error: Optional[BaseException] = None
        self.should_stop = False  # set by a scheduler's STOP decision

    @property
    def last_result(self) -> Dict[str, Any]:
        return self.results[-1] if self.results else {}

    @property
    def training_iteration(self) -> int:
        return len(self.results)

    def report(self, metrics: Dict[str, Any]) -> None:
        row = dict(metrics)
        row["training_iteration"] = self.training_iteration + 1
        row["trial_id"] = self.trial_id
        self.results.append(row)

    def create_checkpoint(self, payload: Dict[str, Any], step: int,
                          filename: str) -> str:
        cdir = os.path.join(self.logdir, f"checkpoint_{step:06d}")
        path = os.path.join(cdir, filename)
        ckpt_lib.atomic_save(payload, path)
        self.checkpoints.append((step, path))
        return path

    def best_checkpoint_path(self) -> Optional[str]:
        return self.checkpoints[-1][1] if self.checkpoints else None


class _TrialSession:
    """Driver-side marker that a trial is active (probed by
    ``is_session_enabled``)."""

    def __init__(self, trial: Trial, scheduler=None, devices=None):
        self.trial = trial
        self.scheduler = scheduler
        self.devices = devices  # this trial's device lease (or None)
        self._lock = threading.Lock()

    def report(self, **metrics) -> None:
        with self._lock:
            self.trial.report(metrics)
            if self.scheduler is not None and not self.trial.should_stop:
                # schedulers hold cross-trial state: serialize their
                # decisions across concurrent trials
                with _scheduler_lock:
                    decision = self.scheduler.on_result(
                        self.trial, self.trial.last_result)
                if decision == self.scheduler.STOP:
                    self.trial.should_stop = True


_scheduler_lock = threading.Lock()

_trial_session: Optional[_TrialSession] = None
# thread-local overlay for concurrent trials (each trial's driver and
# trainable threads bind their own session; sequential trials use the
# process global)
_tls = threading.local()


def _current_session() -> Optional[_TrialSession]:
    return getattr(_tls, "session", None) or _trial_session


def _bind_trial_session(session: Optional[_TrialSession]) -> None:
    _tls.session = session


def is_session_enabled() -> bool:
    return _current_session() is not None


def get_trial_session() -> _TrialSession:
    s = _current_session()
    if s is None:
        raise RuntimeError("tune.report()/checkpointing used outside a "
                           "tune.run() trial")
    return s


def _session_query():
    """This process's session queue when it can query the driver (a rank
    inside a trial, a process trial), else None."""
    if not session_lib.session_exists():
        return None, None
    sess = session_lib.get_session()
    q = getattr(sess, "_queue", None)
    return (sess, q) if hasattr(q, "query") else (sess, None)


def trial_should_stop() -> bool:
    """True when the active trial was STOPped by a scheduler; the tune
    callbacks poll this and end training cleanly via
    ``trainer.should_stop``.  Where there is no local trial session (a
    rank, a process trial) the poll crosses the query channel."""
    s = _current_session()
    if s is not None:
        return s.trial.should_stop
    sess, q = _session_query()
    if q is not None:
        try:
            return bool(q.query("should_stop", sess.rank))
        except (ConnectionError, OSError):
            return False  # driver gone; the trial will fail on its own
    return False


def dispatch_trial_query(name: str, payload,
                         lookup: Callable[[int], Optional[_TrialSession]]):
    """Driver-side dispatch of the query channel, shared by the tune
    driver's ``QueueServer`` and a world's (``runtime/bootstrap.py``).
    ``lookup(rank)`` resolves the owning trial session.  None for
    anything unresolvable: the caller then falls back to a thunk."""
    if name == "should_stop":
        s = lookup(payload)
        return bool(s is not None and s.trial.should_stop)
    if name == "report":
        rank, metrics = payload
        s = lookup(rank)
        if s is None:
            return None
        s.report(**metrics)
        return bool(s.trial.should_stop)
    if name == "checkpoint":
        rank, pl, step, filename = payload
        s = lookup(rank)
        if s is None:
            return None
        return s.trial.create_checkpoint(pl, step, filename)
    return None


def trial_devices() -> Optional[list]:
    """The device lease of the current trial, or None when trials own
    every device (sequential mode).  Pass it to an accelerator:
    ``RayTPUAccelerator(devices=tune.trial_devices())``."""
    s = _current_session()
    return None if s is None else s.devices


def report(**metrics) -> None:
    """Report metrics for the current trial: directly under a local trial
    session, else as a synchronous query (the driver records the report
    and runs the scheduler before this returns), else as a thunk through
    the session queue."""
    if _current_session() is None and session_lib.session_exists():
        sess, q = _session_query()
        if q is not None and q.query(
                "report", (sess.rank, dict(metrics))) is not None:
            return
        # no handler up the chain could resolve the trial: the thunk runs
        # where the trial session is bound
        session_lib.put_queue(functools.partial(report, **metrics))
        return
    get_trial_session().report(**metrics)


def checkpoint_payload(payload: Dict[str, Any], step: int,
                       filename: str = "checkpoint") -> str:
    """Write ``payload`` as the current trial's checkpoint, routed like
    ``report`` (synchronous, so the checkpoint is registered before the
    report that follows it)."""
    if _current_session() is None and session_lib.session_exists():
        sess, q = _session_query()
        if q is not None:
            path = q.query("checkpoint", (sess.rank, payload, step,
                                          filename))
            if path is not None:
                return path
        session_lib.put_queue(functools.partial(
            checkpoint_payload, payload, step, filename))
        return ""
    return get_trial_session().trial.create_checkpoint(payload, step,
                                                       filename)


class ExperimentAnalysis:
    """The trials and the best of them by ``metric`` / ``mode``."""

    def __init__(self, trials: List[Trial], metric: Optional[str],
                 mode: str = "min"):
        self.trials = trials
        self.metric = metric
        self.mode = mode

    def _score(self, trial: Trial) -> Optional[float]:
        if self.metric is None or self.metric not in trial.last_result:
            return None
        return float(trial.last_result[self.metric])

    @property
    def best_trial(self) -> Trial:
        scored = [(self._score(t), t) for t in self.trials
                  if self._score(t) is not None]
        if not scored:
            if self.metric is not None:
                raise ValueError(
                    f"no trial reported metric {self.metric!r}")
            return self.trials[0]
        pick = min if self.mode == "min" else max
        return pick(scored, key=lambda st: st[0])[1]

    @property
    def best_config(self) -> Dict[str, Any]:
        return self.best_trial.config

    @property
    def best_result(self) -> Dict[str, Any]:
        return self.best_trial.last_result

    @property
    def best_checkpoint(self) -> Optional[str]:
        return self.best_trial.best_checkpoint_path()

    @property
    def results_df(self):
        """A pandas DataFrame of the final results, one row per trial,
        with ``config.*`` columns (pandas is imported here only)."""
        import pandas as pd
        rows = []
        for t in self.trials:
            row = dict(t.last_result)
            for k, v in t.config.items():
                row[f"config.{k}"] = v
            rows.append(row)
        return pd.DataFrame(rows)


def _scoped(trainable, config):
    """The trainable inside a world scope: the worlds it forms end with
    it."""
    with bootstrap.world_scope():
        return trainable(config)


def _execute_trial(trainable, trial: Trial, scheduler, devices,
                   raise_on_failed_trial: bool, verbose: int,
                   set_global: bool) -> None:
    """Run one trial on the current thread: bind the sessions
    (thread-local, and the process globals in sequential mode), run the
    trainable in a worker thread, and drain the trampoline queue until it
    ends."""
    global _trial_session
    q = TrampolineQueue()
    tsess = _TrialSession(trial, scheduler, devices=devices)
    rt = session_lib.Session(0, q)
    _bind_trial_session(tsess)
    session_lib.bind_session_to_thread(rt)
    if set_global:
        _trial_session = tsess
        session_lib.install_session(rt)

    def _bind_worker():  # on the pool's worker thread
        _bind_trial_session(tsess)
        session_lib.bind_session_to_thread(rt)

    trial.status = "RUNNING"
    try:
        with ThreadPoolExecutor(max_workers=1,
                                initializer=_bind_worker) as pool:
            fut = pool.submit(_scoped, trainable, trial.config)
            process_results([fut], q)
        trial.status = "STOPPED" if trial.should_stop else "TERMINATED"
    except BaseException as e:  # noqa: BLE001 - fail fast, like ray.get
        trial.status = "ERROR"
        trial.error = e
        log.warning("trial %s failed: %s", trial.trial_id, e)
        if raise_on_failed_trial:
            raise
    finally:
        _bind_trial_session(None)
        session_lib.bind_session_to_thread(None)
        if set_global:
            session_lib.shutdown_session()
            _trial_session = None
    if verbose:
        log.warning("trial %s finished: %s", trial.trial_id,
                    trial.last_result)


def _process_trial_main(trainable, config, queue_address, trial_rank):
    """Body of a process trial, in its own subprocess: reports and
    checkpoints reach the driver over the queue under this trial's
    rank; the worlds its fit forms end with it."""
    from ..runtime.queue import QueueClient

    client = QueueClient(queue_address)
    session_lib.init_session(trial_rank, client)
    try:
        return _scoped(trainable, config)
    finally:
        # the result travels the worker pipe and could outrun the last
        # reports: flush first.  A dead driver must not mask the
        # trainable's own exception.
        try:
            client.flush()
        except (ConnectionError, OSError):
            pass


def _check_importable(trainable) -> None:
    try:
        pickle.dumps(trainable)
    except (pickle.PicklingError, AttributeError, TypeError) as e:
        raise TypeError(
            f"trainable {trainable!r} cannot be sent to a trial subprocess "
            f"({e}); the port ships work with the standard pickle: make it "
            "a module-level function the subprocess can import by name") \
            from e


def _trial_context():
    """The start method of trial workers: a forkserver that preloaded this
    module (and with it torch and the port)."""
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload([__name__])
    return ctx


def _run_trials_in_processes(trainable, trials, scheduler,
                             max_concurrent: int,
                             raise_on_failed_trial: bool, verbose: int,
                             trial_env: Optional[Dict[str, str]],
                             agents: Optional[List[str]] = None):
    """One fresh worker subprocess per trial (on the host agents
    round-robin, where given).  A trial that hard-crashes is ERROR; the
    experiment goes on.  Thunks carry the trial's rank, and the drain
    binds that trial's session before running them, so concurrent trials
    cannot cross-report."""
    from ..runtime.actors import Worker
    from ..runtime.agent import (RemoteWorker, parse_agent_spec,
                                 queue_bind_for_agents)
    from ..runtime.queue import QueueServer

    sessions = {i: _TrialSession(t, scheduler) for i, t in enumerate(trials)}
    q = TrampolineQueue()
    # report / checkpoint are answered before the query returns, so the
    # decision for report k is visible to the trial's next poll; the
    # server binds loopback unless an agent is on another machine
    server = QueueServer(q, bind=queue_bind_for_agents(agents),
                         query_handler=functools.partial(
                             dispatch_trial_query, lookup=sessions.get))
    failures: List[BaseException] = []
    ctx = _trial_context()

    def drain() -> None:
        while True:
            item = q.get_nowait()
            if item is None:
                return
            rank, thunk = item
            _bind_trial_session(sessions.get(rank))
            try:
                thunk()
            except Exception as e:
                # a failing thunk is recorded on its trial; it aborts the
                # experiment only where failures are not tolerated
                if rank in sessions:
                    sessions[rank].trial.error = e
                log.warning("trial thunk failed (trial %s): %s",
                            sessions[rank].trial.trial_id
                            if rank in sessions else rank, e)
                if raise_on_failed_trial:
                    failures.append(e)
            finally:
                _bind_trial_session(None)

    pending: Dict[int, tuple] = {}  # idx -> (worker, future)
    queue_idx = list(range(len(trials)))
    try:
        while queue_idx or pending:
            while queue_idx and len(pending) < max_concurrent:
                i = queue_idx.pop(0)
                trials[i].status = "RUNNING"
                # non-daemon: a trial's fit spawns ranks
                if agents:
                    w = RemoteWorker(
                        parse_agent_spec(agents[i % len(agents)])[0], i,
                        dict(trial_env or {}), daemon=False)
                else:
                    w = Worker(i, dict(trial_env or {}), ctx=ctx,
                               daemon=False)
                atexit.register(w.kill)
                fut = w.execute(_process_trial_main, trainable,
                                trials[i].config, server.address, i)
                pending[i] = (w, fut)
            drain()
            for i, (w, fut) in list(pending.items()):
                if not fut.done():
                    continue
                drain()  # what was enqueued before the end lands first
                trial = trials[i]
                err = fut.exception()
                if err is not None:
                    trial.status = "ERROR"
                    trial.error = err
                    log.warning("trial %s failed: %s", trial.trial_id, err)
                    if raise_on_failed_trial:
                        failures.append(err)
                else:
                    trial.status = ("STOPPED" if trial.should_stop
                                    else "TERMINATED")
                    if verbose:
                        log.warning("trial %s finished: %s", trial.trial_id,
                                    trial.last_result)
                w.kill()
                atexit.unregister(w.kill)
                del pending[i]
                if failures:
                    queue_idx.clear()
            if failures:
                break
            time.sleep(0.01)
        drain()
    finally:
        for w, _f in pending.values():
            w.kill()
            atexit.unregister(w.kill)
        server.close()
    if failures:
        raise failures[0]


def _device_pool(device: torch.device) -> List[torch.device]:
    """The devices concurrent trials lease: the visible cards, or the
    CPU's indexed pool."""
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu", i) for i in range(CPU_POOL_SIZE)]


# the default train-step autotuning space: what the rematerialized
# backward keeps, the flash tile shapes and how the FSDP compute view is
# gathered.  In the port ``flash_block_q`` leaves the kernels as they are,
# ``flash_block_k`` picks K4 (keys <= block) or K3a + K3b, and
# ``gather_mode="scan"`` trains as the tree gather wherever the JAX
# Trainer falls back (a finite score); only the engaged compressed-FSDP
# case raises ``not_ported`` (4e), which autotune_step scores inf
def default_step_space() -> Dict[str, Any]:
    from .search import choice
    return {
        "remat_policy": choice(["none", "nothing", "dots",
                                "dots_with_no_batch_dims"]),
        "flash_block_q": choice([128, 256, 512, 1024]),
        "flash_block_k": choice([128, 256, 512, 1024]),
        "gather_mode": choice(["tree", "scan"]),
    }


def autotune_step(measure: Callable[[Dict[str, Any]], float],
                  space: Optional[Dict[str, Any]] = None,
                  default_config: Optional[Dict[str, Any]] = None,
                  n_trials: int = 12,
                  searcher=None,
                  seed: int = 0,
                  verbose: int = 0) -> Dict[str, Any]:
    """Closed-loop train-step autotuning: the TPE searcher drives the
    step-shape knobs against a measured step time.

    ``measure(config) -> step_time_seconds`` measures a train step under
    ``config``; a measurement that raises records ``inf`` and the search
    moves on.  The default config is measured first, as trial 0, so the
    returned ``best_config`` is never slower than it.  Returns
    ``{"best_config", "best_step_time_s", "default_step_time_s",
    "speedup_vs_default", "n_trials", "trials": [{"config",
    "step_time_s"}, ...]}``."""
    from .search import TPESearcher

    space = dict(space or default_step_space())
    default_config = dict(default_config or {
        "remat_policy": "none", "flash_block_q": 512,
        "flash_block_k": 512, "gather_mode": "tree"})
    searcher = searcher or TPESearcher(
        n_startup=max(2, min(8, n_trials // 2)), seed=seed)
    searcher.set_search_properties("step_time_s", "min")

    trials: List[Dict[str, Any]] = []

    def one(config: Dict[str, Any]) -> float:
        try:
            dt = float(measure(dict(config)))
        except Exception as e:  # an untunable config is a data point,
            log.warning("autotune_step: config %s failed (%s: %s)",
                        config, type(e).__name__, e)  # not an abort
            dt = float("inf")
        trials.append({"config": dict(config), "step_time_s": dt})
        if math.isfinite(dt):
            searcher.record(config, dt)
        if verbose:
            log.warning("autotune_step trial %d: %.2f ms  %s",
                        len(trials), dt * 1e3, config)
        return dt

    default_dt = one(default_config)
    for _ in range(max(0, n_trials - 1)):
        one(searcher.suggest(dict(space)))
    best = min(trials, key=lambda t: t["step_time_s"])
    # None rather than inf / NaN when either side failed to measure (JSON
    # has no Infinity)
    speedup = (default_dt / best["step_time_s"]
               if math.isfinite(default_dt)
               and math.isfinite(best["step_time_s"])
               and best["step_time_s"] > 0 else None)
    return {
        "best_config": dict(best["config"]),
        "best_step_time_s": best["step_time_s"],
        "default_step_time_s": default_dt,
        "speedup_vs_default": speedup,
        "n_trials": len(trials),
        "trials": trials,
    }


def run(trainable: Callable[[Dict[str, Any]], Any],
        config: Optional[Dict[str, Any]] = None,
        num_samples: int = 1,
        metric: Optional[str] = None,
        mode: str = "min",
        name: Optional[str] = None,
        local_dir: Optional[str] = None,
        resources_per_trial: Optional[Dict[str, Any]] = None,
        seed: int = 0,
        raise_on_failed_trial: bool = True,
        verbose: int = 0,
        scheduler=None,
        search_alg=None,
        max_concurrent_trials: int = 1,
        devices_per_trial: Optional[int] = None,
        trial_executor: str = "thread",
        trial_env: Optional[Dict[str, str]] = None,
        agents: Optional[List[str]] = None,
        device=None,
        **_compat_kwargs) -> ExperimentAnalysis:
    """Run ``trainable(config)`` for every sampled or grid config.

    ``trial_executor``: "thread" (trials share this process) or
    "process" (a fresh subprocess a trial; ``trial_env`` is its env
    overlay, applied before the trainable runs and before CUDA starts
    there).
    ``resources_per_trial`` caps process-trial concurrency at
    ``os.cpu_count() // (cpu + extra_cpu)``.  ``scheduler`` (a
    ``TrialScheduler``) sees every reported result; its STOP ends the
    trial at its next report boundary and marks it STOPPED.
    ``search_alg`` (``TPESearcher``) suggests each config from the
    finished trials (sequential thread trials only).
    ``max_concurrent_trials > 1`` runs thread trials in parallel over
    disjoint leases of ``devices_per_trial`` devices (default: an equal
    split) of ``device``'s pool (None: the cards; "cpu": 8 indexed CPU
    entries), claimed with ``tune.trial_devices()``.
    ``agents``: with ``trial_executor="process"``, HostAgent addresses
    (default ``RLA_TPU_AGENTS``) the trial subprocesses are placed on,
    round-robin."""
    dev = resolve_device(device)
    name = name or f"tune_{int(time.time())}"
    local_dir = local_dir or os.path.join(os.getcwd(), "rla_tpu_results")
    exp_dir = os.path.join(local_dir, name)
    os.makedirs(exp_dir, exist_ok=True)

    if trial_executor not in ("thread", "process"):
        raise ValueError(f"trial_executor must be 'thread' or 'process', "
                         f"got {trial_executor!r}")
    if scheduler is not None:
        scheduler.set_search_properties(metric, mode)
    if search_alg is not None:
        if max_concurrent_trials > 1 or trial_executor == "process":
            raise ValueError(
                "search_alg suggests each trial from completed-trial "
                "history and requires sequential in-process trials "
                "(max_concurrent_trials=1, trial_executor='thread')")
        search_alg.set_search_properties(metric, mode)
        configs = [None] * num_samples
    else:
        configs = generate_trial_configs(config, num_samples, seed)

    if trial_executor == "process":
        if agents is None:
            from ..runtime.agent import agents_from_env
            agents = agents_from_env()
        _check_importable(trainable)
        trials = [Trial(f"trial_{i:05d}", cfg, exp_dir)
                  for i, cfg in enumerate(configs)]
        concurrent = max(1, max_concurrent_trials)
        if resources_per_trial:
            per = (int(resources_per_trial.get("cpu", 1))
                   + int(resources_per_trial.get("extra_cpu", 0)))
            cap = max(1, (os.cpu_count() or 1) // max(1, per))
            if cap < concurrent:
                log.warning("resources_per_trial caps concurrency at %d "
                            "(%d host cpus / %d per trial)", cap,
                            os.cpu_count() or 1, per)
            concurrent = min(concurrent, cap)
        _run_trials_in_processes(trainable, trials, scheduler, concurrent,
                                 raise_on_failed_trial, verbose, trial_env,
                                 agents=agents)
        return ExperimentAnalysis(trials, metric, mode)

    if max_concurrent_trials > 1:
        import queue as queue_mod

        devs = _device_pool(dev)
        per = devices_per_trial or max(1, len(devs) // max_concurrent_trials)
        n_groups = min(max_concurrent_trials, len(devs) // per)
        if n_groups < 1:
            raise ValueError(
                f"devices_per_trial={per} exceeds the {len(devs)} visible "
                f"devices")
        free: "queue_mod.Queue" = queue_mod.Queue()
        for g in range(n_groups):
            free.put(devs[g * per:(g + 1) * per])
        trials = [Trial(f"trial_{i:05d}", cfg, exp_dir)
                  for i, cfg in enumerate(configs)]

        def _leased(trial):
            group = free.get()
            try:
                _execute_trial(trainable, trial, scheduler, group,
                               raise_on_failed_trial, verbose,
                               set_global=False)
            finally:
                free.put(group)

        outer = ThreadPoolExecutor(max_workers=n_groups)
        try:
            futures = [outer.submit(_leased, t) for t in trials]
            for f in futures:
                f.result()  # propagate raise_on_failed_trial errors
        except BaseException:
            # fail fast as the sequential mode does: trials not started
            # are cancelled (running ones finish their lease)
            outer.shutdown(wait=True, cancel_futures=True)
            raise
        outer.shutdown(wait=True)
        return ExperimentAnalysis(trials, metric, mode)

    trials = []
    for i, cfg in enumerate(configs):
        if search_alg is not None:
            cfg = search_alg.suggest(dict(config or {}))
        trial = Trial(f"trial_{i:05d}", cfg, exp_dir)
        trials.append(trial)
        _execute_trial(trainable, trial, scheduler, None,
                       raise_on_failed_trial, verbose, set_global=True)
        if search_alg is not None and metric is not None and \
                trial.last_result.get(metric) is not None:
            search_alg.record(cfg, float(trial.last_result[metric]))
    return ExperimentAnalysis(trials, metric, mode)
