"""PipelineRunner: S stage groups over one ActorPool, driven in 1F1B.

Driver side of the MPMD pipeline; port of the JAX package's
``parallel/mpmd/driver.py``.  The runner carves ``W`` pool workers into
``S`` contiguous stage groups of ``G = W / S`` lanes (a lane is a
data-parallel replica of the whole pipeline handling a contiguous
microbatch block), then per optimizer step publishes the microbatch
refs once into the driver's object store, dispatches one
``mpmd_stage_step`` per member, and waits for every future: the
pipeline overlap happens inside the step, between stage processes.

- **tracing**: one trace id minted at construction rides the worker env
  overlay, so every stage's ``pipeline_tick`` events and the driver's
  ``pipeline_step`` rows read as one timeline in ``run_report.json``;
- **the bubble**: each step row holds the mean per-member busy time
  and ``bubble_frac = 1 - busy_avg / wall``; the summary's
  ``measured_bubble_fraction`` (steps after the first) stands beside the
  analytic ``(S-1)/(M+S-1)``;
- **fault domains**: a failed step names a *suspect stage*.  A worker's
  registered exception comes home typed (``runtime/wire.py``), anything
  else as a ``RemoteError``; failures are classified by type name (the
  worker's, for a ``RemoteError``): the first failure that is not a
  handoff timeout (a raise in a stage, a dead or reaped worker, a missed
  step deadline) names its rank's stage; when every failure is a
  ``PipelineHandoffTimeout``, the timeout's diagnosis names the sender it
  waited on.  Only the suspect stage's failure budget is charged (a
  ``Preempted`` failure never is), every worker restarts, the mailbox
  clears, and training replays from the latest verified checkpoint,
  re-running the batches since.

On the card every stage worker uses the same device (``cuda:0`` on a
machine with one card).

``fsdp = F > 1`` shards each stage lane's params over a group of F
worker processes (``stage.py``): the runner spawns ``stages x lanes x
F`` workers, rank ``((stage * lanes) + lane) * F + j`` holding fsdp rank
j.  Each group rendezvouses on a port of its own, over gloo (every
worker shares the one device, and NCCL refuses two ranks on one card),
with the step deadline as the timeout of its rendezvous and of every
collective, so a member hung inside a collective cannot outlive the
step.  A replay restarts every worker and every group meets again on
fresh ports.  Checkpoints keep the ``fsdp=1`` layout (each stage's whole
params and moments, gathered to the group's first member), so a
checkpoint written at one F restores at another.  A microbatch whose
rows the group cannot split raises ``ValueError`` before any worker
starts (the JAX stage's XLA splits any batch).

A hang is caught by the handoff timeout and the step deadline, four
times the handoff timeout the workers use (``handoff_timeout_s``, else
``RLA_TPU_PIPELINE_HANDOFF_TIMEOUT_S``, 60 s by default) unless
``RLA_TPU_PIPELINE_STEP_DEADLINE_S`` is set; with ``wedge_timeout_s``
(``Trainer(worker_deadline_s=)``) a ``runtime/watchdog.py`` watchdog
over the pool (boot grace 60 s, as JAX's) reaps a worker whose heartbeat
went stale sooner, and its ``WorkerWedged`` names its stage.  Every
worker's overlay holds its stage as ``RLA_TPU_PIPELINE_STAGE``, which
chaos's ``stageN`` target reads (``testing/chaos.py``).
"""

from __future__ import annotations

import os
import tempfile
import time
from concurrent.futures import TimeoutError as FutureTimeoutError
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ...analysis import knobs
from ...core.module import TorchModule, resolve_device
from ...core.optim import tree_leaves
from ...runtime import bootstrap, object_store
from ...runtime.actors import ActorPool
from ...runtime.preemption import Preempted
from ...telemetry import recorder
from ...telemetry import registry as registry_lib
from ...utils import checkpoint as ckpt_lib
from . import handoff, stage as stage_lib
from .handoff import Mailbox, PipelineHandoffTimeout
from .schedule import (analytic_bubble_fraction, build_programs,
                       program_fingerprint)

CKPT_EVERY_ENV = "RLA_TPU_PIPELINE_CKPT_EVERY"
MAX_FAILURES_ENV = "RLA_TPU_PIPELINE_MAX_FAILURES"
STEP_DEADLINE_ENV = "RLA_TPU_PIPELINE_STEP_DEADLINE_S"
HANDOFF_TIMEOUT_ENV = "RLA_TPU_PIPELINE_HANDOFF_TIMEOUT_S"
STAGE_ENV = "RLA_TPU_PIPELINE_STAGE"

# how long the step gather keeps waiting for healthy stragglers after a
# hard failure already decided the step's fate (their results are
# discarded by the replay; restart_all reclaims the processes)
_ABANDON_GRACE_S = 2.0


class PipelineConfigError(ValueError):
    """Typed refusal for a pipeline configuration that cannot run:
    indivisible worker/microbatch/layer counts, or a module missing the
    pipeline hooks.  Raised at construction, never mid-training."""


class PipelineStageFailed(RuntimeError):
    """Terminal: a stage group exhausted its failure budget.  Carries
    the attributed stage, the budget ledger, and the last cause."""

    def __init__(self, message: str, *, stage: Optional[int] = None,
                 rank: Optional[int] = None,
                 budget_used: Optional[List[int]] = None):
        super().__init__(message)
        self.stage = stage
        self.rank = rank
        self.budget_used = list(budget_used or [])
        self.diagnosis = {"stage": stage, "rank": rank,
                          "budget_used": self.budget_used}


class _StepFailures(Exception):
    """Internal: one step's per-rank failures, gathered past the first
    (recovery needs the full set to attribute a suspect stage)."""

    def __init__(self, failures: List[Tuple[int, BaseException]]):
        super().__init__(f"{len(failures)} rank failure(s)")
        self.failures = failures


def _type_name(exc: BaseException) -> str:
    """The exception's type name, the worker's for a ``RemoteError``
    (a registered type arrives typed and names itself)."""
    return getattr(exc, "remote_type", None) or type(exc).__name__


def _typed(exc: BaseException) -> BaseException:
    """A worker's ``PipelineHandoffTimeout`` rebuilt from its message
    (diagnosis intact); any other exception as it came."""
    if not isinstance(exc, PipelineHandoffTimeout) and \
            _type_name(exc) == PipelineHandoffTimeout.__name__:
        return PipelineHandoffTimeout.from_message(
            getattr(exc, "remote_message", str(exc)))
    return exc


def _module_overrides(module: Any, name: str) -> bool:
    return getattr(type(module), name, None) \
        is not getattr(TorchModule, name, None)


class PipelineRunner:
    """Run a TorchModule as S pipeline stage groups over an ActorPool.

    ``device`` (None = the CUDA device) is where every stage worker
    runs; ``num_workers`` (default S) is the number of stage group
    members, ``fsdp`` the workers each one spans; ``wedge_timeout_s``
    arms the watchdog over the pool."""

    def __init__(self, module: Any, *, num_stages: int,
                 num_workers: Optional[int] = None,
                 schedule: str = "1f1b", num_microbatches: int = 4,
                 fsdp: int = 1, seed: int = 0,
                 workdir: Optional[str] = None,
                 worker_env: Optional[Dict[str, str]] = None,
                 handoff_timeout_s: Optional[float] = None,
                 wedge_timeout_s: Optional[float] = None,
                 max_stage_failures: Optional[int] = None,
                 ckpt_every: Optional[int] = None,
                 device: Any = None):
        if num_stages < 2:
            raise PipelineConfigError(
                f"pipeline_stages={num_stages}: MPMD needs >= 2 stages "
                "(1 stage IS the plain Trainer path — drop the kwarg)")
        num_workers = num_workers if num_workers is not None else num_stages
        if num_workers % num_stages != 0:
            raise PipelineConfigError(
                f"{num_workers} workers do not divide into {num_stages} "
                f"stage groups — num_workers must be a multiple of "
                f"pipeline_stages")
        self.num_lanes = num_workers // num_stages
        if num_microbatches % self.num_lanes != 0:
            raise PipelineConfigError(
                f"num_microbatches={num_microbatches} not divisible by "
                f"the {self.num_lanes} lanes per stage group "
                f"({num_workers} workers / {num_stages} stages) — each "
                "lane owns a contiguous equal microbatch block")
        for hook in ("pipeline_stage_params", "pipeline_stage_forward",
                     "pipeline_loss"):
            if not _module_overrides(module, hook):
                raise PipelineConfigError(
                    f"{type(module).__name__} does not override "
                    f"TorchModule.{hook} — the MPMD pipeline needs all of "
                    "pipeline_stage_params / pipeline_stage_forward / "
                    "pipeline_loss")
        if not isinstance(fsdp, int) or fsdp < 1:
            raise PipelineConfigError(f"fsdp must be an int >= 1, got "
                                      f"{fsdp!r}")
        # audits the whole program set (deadlock-freedom) and validates
        # the schedule name — PipelineScheduleError is its own refusal
        self.programs = build_programs(schedule, num_stages,
                                       num_microbatches // self.num_lanes)
        self.device = resolve_device(device)
        self.module = module
        self.num_stages = num_stages
        self.num_workers = num_workers
        self.schedule = schedule
        self.num_microbatches = num_microbatches
        self.m_lane = num_microbatches // self.num_lanes
        self.fsdp = fsdp
        # the processes: every member of a stage group spans fsdp workers
        self.num_procs = num_workers * fsdp
        # the stage groups' collectives: every worker shares the one
        # device, and NCCL refuses two ranks on one card
        self.fsdp_backend = "gloo" if fsdp > 1 else None
        self.seed = seed
        self.worker_env = dict(worker_env or {})
        self.handoff_timeout_s = handoff_timeout_s
        self.wedge_timeout_s = wedge_timeout_s
        self._watchdog = None
        self.max_stage_failures = (
            max_stage_failures if max_stage_failures is not None
            else knobs.get_int(MAX_FAILURES_ENV, 2))
        self.ckpt_every = (ckpt_every if ckpt_every is not None
                           else knobs.get_int(CKPT_EVERY_ENV, 1))
        self.workdir = workdir or tempfile.mkdtemp(prefix="rla-mpmd-")
        self.mailbox_root = os.path.join(self.workdir, "mailbox")
        self.ckpt_dir = os.path.join(self.workdir, "ckpt")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.mailbox = Mailbox(self.mailbox_root)
        self.trace_id = recorder.mint_trace_id()
        self.budget_used = [0] * num_stages
        self.replays = 0
        self.pool: Optional[ActorPool] = None
        self._store = object_store.global_store()
        self._fingerprints: Dict[str, str] = {
            str(s): program_fingerprint(p)
            for s, p in enumerate(self.programs)}
        self._rows: List[Dict[str, Any]] = []
        self._ckpt_step = 0

    # ------------------------------------------------------------------ #
    def _stage_of(self, rank: int) -> int:
        return rank // (self.num_lanes * self.fsdp)

    def _lane_of(self, rank: int) -> int:
        return (rank // self.fsdp) % self.num_lanes

    def _fsdp_rank_of(self, rank: int) -> int:
        return rank % self.fsdp

    def _rank(self, stage: int, lane: int, fsdp_rank: int = 0) -> int:
        return (stage * self.num_lanes + lane) * self.fsdp + fsdp_rank

    def _step_deadline_s(self) -> float:
        """The step deadline: ``RLA_TPU_PIPELINE_STEP_DEADLINE_S``, else
        four handoff timeouts of the workers, the backstop so a wedged
        member can never block the gather loop past the point its
        peers' handoff timeouts fired."""
        deadline = knobs.get_float(STEP_DEADLINE_ENV, None)
        if deadline is None:
            deadline = self._worker_handoff_timeout_s() * 4.0
        return deadline

    def _check_rows(self, batches: Sequence[Any]) -> None:
        """Refuse, before any worker starts, a microbatch whose rows the
        fsdp group cannot split into equal contiguous parts."""
        if self.fsdp == 1:
            return
        for i, batch in enumerate(batches):
            mb = handoff.split_microbatches(batch, self.num_microbatches)[0]
            rows = _first_rows(mb)
            if rows % self.fsdp:
                raise ValueError(
                    f"batch {i}: a microbatch of {rows} rows does not split "
                    f"over the fsdp group of {self.fsdp} workers; each "
                    f"member takes an equal contiguous part of every "
                    f"microbatch (rows per batch must divide by "
                    f"num_microbatches x fsdp = "
                    f"{self.num_microbatches * self.fsdp})")

    def setup(self) -> None:
        """Spawn the pool, build every stage, write the step-0
        checkpoint (the replay floor)."""
        if self.pool is not None:
            return
        recorder.set_trace_id(self.trace_id)
        tele_dir = knobs.get_str(recorder.DIR_ENV) \
            or os.path.join(self.workdir, "telemetry")
        env = {recorder.TRACE_ENV: self.trace_id, recorder.DIR_ENV: tele_dir}
        self.pool = ActorPool(self.num_procs, env_per_worker=[
            {**env, STAGE_ENV: str(self._stage_of(rank)), **self._overlay()}
            for rank in range(self.num_procs)])
        if self.wedge_timeout_s is not None:
            self._watchdog = self.pool.watch(
                wedge_timeout_s=self.wedge_timeout_s, boot_grace_s=60.0)
        self._init_workers(stage_states=None)
        self._save_checkpoint(step=0, states=self._initial_states())

    def _initial_states(self) -> Dict[str, Any]:
        """Step-0 checkpoint states built driver-side: an optimizer's
        init is a function of the parameter tree, so this equals what
        lane 0 would report."""
        tx = self.module.configure_optimizers()
        states = {}
        for s, p in enumerate(self._stage_parameters()):
            leaves = [torch.from_numpy(a) for a in tree_leaves(p)]
            states[str(s)] = {"stage": s, "lane": 0, "params": p,
                              "opt_state": ckpt_lib._to_host(
                                  tx.init(leaves))}
        return states

    def _stage_parameters(self) -> List[Any]:
        """Each stage's parameter tree on the host (the module may build
        them on the card)."""
        params = self.module.init_params(self.seed)
        out = []
        for s in range(self.num_stages):
            try:
                out.append(ckpt_lib._to_host(
                    self.module.pipeline_stage_params(
                        params, s, self.num_stages)))
            except PipelineConfigError:
                raise
            except Exception as e:
                # indivisible layer counts etc. surface as config
                # refusals with the module's own message attached
                raise PipelineConfigError(
                    f"pipeline_stage_params(stage={s}, "
                    f"num_stages={self.num_stages}) failed: "
                    f"{type(e).__name__}: {e}") from e
        return out

    def _overlay(self) -> Dict[str, str]:
        """What the runner's arguments put in every worker's env
        overlay: the handoff timeout, with ``worker_env`` over it."""
        env = {}
        if self.handoff_timeout_s is not None:
            env[HANDOFF_TIMEOUT_ENV] = str(self.handoff_timeout_s)
        env.update(self.worker_env)
        return env

    def _worker_handoff_timeout_s(self) -> float:
        """The handoff timeout the stage workers' mailboxes read."""
        return knobs.get_float(HANDOFF_TIMEOUT_ENV,
                               handoff.DEFAULT_TIMEOUT_S,
                               env=self._overlay())

    def _init_workers(self, stage_states: Optional[Dict[str, Any]]) -> None:
        """Dispatch mpmd_stage_init to every member: from fresh module
        params, or from checkpointed per-stage state on replay."""
        if stage_states is None:
            per_stage = [(p, None) for p in self._stage_parameters()]
        else:
            per_stage = [(stage_states[str(s)]["params"],
                          stage_states[str(s)]["opt_state"])
                         for s in range(self.num_stages)]
        init_refs = []
        for params, opt in per_stage:
            init_refs.append((self._store.put(params),
                              self._store.put(opt) if opt is not None
                              else None))
        dev = str(self.device)
        if self.device.type == "cuda" and self.device.index is None:
            dev = "cuda:0"
        # each stage lane's fsdp group meets on a fresh port of its own
        addresses = {(s, lane): bootstrap.pick_coordinator_address()
                     for s in range(self.num_stages)
                     for lane in range(self.num_lanes)} \
            if self.fsdp > 1 else {}
        futs = []
        for rank in range(self.num_procs):
            s, lane = self._stage_of(rank), self._lane_of(rank)
            spec = {"module": self.module, "stage": s,
                    "num_stages": self.num_stages, "lane": lane,
                    "num_lanes": self.num_lanes,
                    "schedule": self.schedule,
                    "microbatches_per_lane": self.m_lane,
                    "mailbox_root": self.mailbox_root, "fsdp": self.fsdp,
                    "fsdp_rank": self._fsdp_rank_of(rank),
                    "fsdp_address": addresses.get((s, lane)),
                    "fsdp_backend": self.fsdp_backend,
                    "fsdp_timeout_s": self._step_deadline_s(),
                    "device": dev}
            futs.append(self.pool.workers[rank].execute(
                stage_lib.mpmd_stage_init, init_refs[s][0],
                init_refs[s][1], spec))
        try:
            infos = [f.result() for f in futs]
        finally:
            for params_ref, opt_ref in init_refs:
                self._store.delete(params_ref)
                if opt_ref is not None:
                    self._store.delete(opt_ref)
        self.owned_param_bytes = [info["owned_param_bytes"]
                                  for info in infos]
        self.owned_shapes = [info["owned_shapes"] for info in infos]
        for info in infos:
            expect = self._fingerprints[str(info["stage"])]
            if info["fingerprint"] != expect:
                raise PipelineConfigError(
                    f"stage {info['stage']} built a program that diverges "
                    "from the driver's schedule — driver/worker version "
                    "skew")

    # ------------------------------------------------------------------ #
    def _run_step(self, step: int, batch: Any) -> Dict[str, Any]:
        """One optimizer step across all stage groups."""
        t0 = time.perf_counter()
        microbatches = handoff.split_microbatches(batch,
                                                  self.num_microbatches)
        refs = [self._store.put(handoff.to_wire(mb)) for mb in microbatches]
        deadline = self._step_deadline_s()
        futs = []
        for rank in range(self.num_procs):
            s, lane = self._stage_of(rank), self._lane_of(rank)
            if s == 0 or s == self.num_stages - 1:
                lo = lane * self.m_lane
                input_refs = refs[lo:lo + self.m_lane]
            else:
                input_refs = None
            futs.append(self.pool.workers[rank].execute(
                stage_lib.mpmd_stage_step, step, input_refs))
        # event-driven gather: once a hard (non-timeout) failure is in
        # hand, attribution is decided and every remaining result will
        # be discarded by the replay — wait only a short grace for
        # stragglers instead of sitting out their handoff timeouts
        by_rank: Dict[int, Dict[str, Any]] = {}
        failures: List[Tuple[int, BaseException]] = []
        pending = dict(enumerate(futs))
        gather_t0 = time.monotonic()
        hard_since: Optional[float] = None
        while pending:
            for rank in sorted(pending):
                try:
                    by_rank[rank] = pending.pop(rank).result(timeout=0.05)
                except FutureTimeoutError:
                    pending[rank] = futs[rank]  # not done yet
                except BaseException as e:
                    e = _typed(e)
                    failures.append((rank, e))
                    if (hard_since is None
                            and not isinstance(e, PipelineHandoffTimeout)):
                        hard_since = time.monotonic()
            now = time.monotonic()
            if pending and hard_since is not None \
                    and now - hard_since > _ABANDON_GRACE_S:
                break  # stragglers are healthy-but-doomed: replay anyway
            if pending and deadline is not None \
                    and now - gather_t0 > deadline:
                for rank in sorted(pending):
                    failures.append((rank, TimeoutError(
                        f"rank {rank} missed the step deadline "
                        f"({deadline:.1f}s)")))
                break
        results = [by_rank[r] for r in sorted(by_rank)]
        for ref in refs:
            self._store.delete(ref)
        if failures:
            raise _StepFailures(failures)
        wall = time.perf_counter() - t0
        busy_avg = sum(r["busy_s"] for r in results) / len(results)
        losses = [r["loss"] for r in results if r["loss"] is not None]
        loss = sum(losses) / len(losses) if losses else None
        bubble = max(0.0, 1.0 - busy_avg / wall) if wall > 0 else 0.0
        row = {"step": step, "loss": loss, "wall_s": wall,
               "busy_avg_s": busy_avg, "bubble_frac": bubble,
               "compiles": max(r["compiles"] for r in results),
               "per_stage": {
                   f"{r['stage']}/{r['lane']}" + (
                       f"/{r['fsdp_rank']}" if self.fsdp > 1 else ""): {
                       "busy_s": r["busy_s"], "wall_s": r["wall_s"],
                       "collective_s": r["collective_s"],
                       "ticks": r["ticks"]}
                   for r in results}}
        if self.fsdp > 1:
            # the slowest member's seconds in its group's collectives
            row["fsdp_collective_s"] = max(r["collective_s"]
                                           for r in results)
        recorder.emit("pipeline_step", step=step, loss=loss, wall_s=wall,
                      busy_avg_s=busy_avg, bubble_frac=bubble)
        return row

    # ------------------------------------------------------------------ #
    def _attribute(self, failures: List[Tuple[int, BaseException]]
                   ) -> Tuple[int, int, BaseException]:
        """(suspect stage, rank, cause).  Hard failures outrank
        timeouts; an all-timeout step indicts the sender the first
        waiter named, not the waiter."""
        for rank, exc in failures:
            if not isinstance(exc, PipelineHandoffTimeout):
                return self._stage_of(rank), rank, exc
        rank, exc = failures[0]
        diag = getattr(exc, "diagnosis", None) or {}
        src = diag.get("src")
        if isinstance(src, int) and 0 <= src < self.num_stages:
            return src, rank, exc
        return self._stage_of(rank), rank, exc

    def _handle_failures(self, sf: _StepFailures, step: int) -> None:
        suspect, rank, cause = self._attribute(sf.failures)
        # a preemption is never charged
        charged = not any(isinstance(e, Preempted)
                          or _type_name(e) == Preempted.__name__
                          for _, e in sf.failures)
        if charged:
            self.budget_used[suspect] += 1
        recorder.emit("pipeline_replay", step=step, stage=suspect,
                      rank=rank, cause=_type_name(cause),
                      charged=charged,
                      budget_used=list(self.budget_used))
        if self.budget_used[suspect] > self.max_stage_failures:
            err = PipelineStageFailed(
                f"stage {suspect} exhausted its failure budget "
                f"({self.budget_used[suspect]} > "
                f"{self.max_stage_failures}); last cause at step {step}: "
                f"{_type_name(cause)}: {cause}",
                stage=suspect, rank=rank, budget_used=self.budget_used)
            # the surviving stages wait on dead edges: end them now, not
            # after shutdown's grace (their spills stay readable)
            self.pool.kill()
            if self._write_report(error=err) is not None:
                # the runner's report (with the pipeline's summary) is
                # the one a failed Trainer.fit keeps
                err._rla_report_written = True
            raise err from cause
        self.replays += 1
        self._recover()

    def _recover(self) -> None:
        """Restart every stage group and replay forward from the latest
        verified checkpoint (surviving stages wait on dead edges, so a
        partial restart cannot converge)."""
        self.pool.restart_all()
        self.mailbox.clear()  # after the kill: no survivor re-publishes
        path = ckpt_lib.latest_checkpoint(self.ckpt_dir)
        if path is None:
            raise PipelineStageFailed(
                "no verified checkpoint to replay from (the step-0 "
                "checkpoint should always exist)",
                budget_used=self.budget_used)
        payload = ckpt_lib.read_checkpoint(path)
        self._init_workers(payload["pipeline_stage_states"])
        self._ckpt_step = int(payload.get("global_step") or 0)

    def _save_checkpoint(self, step: int,
                         states: Optional[Dict[str, Any]] = None) -> str:
        """Per-stage state from lane 0 of each group (lanes are
        identical by the ordered lane-grad sum); ``states``
        short-circuits the gather when the driver already holds them
        (the step-0 floor)."""
        if states is None:
            # every member of lane 0's group gathers (a collective); the
            # first one's copy is kept
            futs = {s: [self.pool.workers[self._rank(s, 0, j)].execute(
                stage_lib.mpmd_stage_state) for j in range(self.fsdp)]
                for s in range(self.num_stages)}
            states = {str(s): [f.result() for f in fs][0]
                      for s, fs in futs.items()}
        payload = ckpt_lib.build_checkpoint(
            state=None, epoch=0, global_step=step,
            extra={"pipeline_stage_states": states,
                   "pipeline": {"schedule": self.schedule,
                                "num_stages": self.num_stages,
                                "trace_id": self.trace_id}})
        path = os.path.join(self.ckpt_dir, f"pipeline-step{step:06d}.ckpt")
        ckpt_lib.atomic_save(payload, path)
        self._ckpt_step = step
        return path

    # ------------------------------------------------------------------ #
    def run(self, batches: Sequence[Any]) -> Dict[str, Any]:
        """Train over ``batches`` (one optimizer step each), recovering
        through stage failures; returns the summary also written to
        ``run_report.json`` under the runner's workdir."""
        batches = list(batches)
        self._check_rows(batches)
        self.setup()
        i = self._ckpt_step
        while i < len(batches):
            step = i + 1
            try:
                row = self._run_step(step, batches[i])
            except _StepFailures as sf:
                self._handle_failures(sf, step)  # may raise terminal
                # replay floor: re-run every step after the checkpoint
                del self._rows[self._ckpt_step:]
                i = self._ckpt_step
                continue
            self._rows.append(row)
            if step % self.ckpt_every == 0:
                self._save_checkpoint(step)
            i += 1
        summary = self._summary()
        self._write_report(error=None)
        return summary

    def _summary(self) -> Dict[str, Any]:
        # steady-state bubble: skip the first row (warm-up dominated)
        rows = self._rows[1:] if len(self._rows) > 1 else self._rows
        measured = (sum(r["bubble_frac"] for r in rows) / len(rows)
                    if rows else None)
        return {
            "trace_id": self.trace_id,
            "schedule": self.schedule,
            "num_stages": self.num_stages,
            "num_lanes": self.num_lanes,
            "num_microbatches": self.num_microbatches,
            "fsdp": self.fsdp,
            "fsdp_backend": self.fsdp_backend,
            "losses": [r["loss"] for r in self._rows],
            "measured_bubble_fraction": measured,
            "analytic_bubble_fraction": analytic_bubble_fraction(
                self.num_stages, self.m_lane),
            "stage_failure_budget_used": list(self.budget_used),
            "replays": self.replays,
            # the watchdog's reap records (wedge_timeout_s)
            "reaped": (list(self._watchdog.reaped)
                       if self._watchdog is not None else []),
            "steps": self._rows,
            "fingerprints": self._fingerprints,
        }

    def _write_report(self, error: Optional[BaseException]) -> Optional[str]:
        tails = {}
        if self.pool is not None:
            tails = registry_lib.gather_worker_tails(self.pool.workers)
        return registry_lib.write_run_report(
            self.workdir, error=error, trace_id=self.trace_id,
            rank_events=tails,
            extra={"pipeline": self._summary()})

    def shutdown(self) -> None:
        if self._watchdog is not None:
            self._watchdog.stop()
            self._watchdog = None
        if self.pool is not None:
            self.pool.shutdown()
            self.pool = None

    def __enter__(self) -> "PipelineRunner":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()


def _first_rows(tree: Any) -> int:
    """The leading size of a batch tree's first array leaf."""
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) \
            else tree[0]
    return int(tree.shape[0])
