"""Trainer: the fit / validate / test / predict loops on one device.

Port of the JAX package's ``core/trainer.py`` for a single card:
``fit`` follows ``_fit_local`` and ``_fit_step`` (loaders or a
``datamodule`` whose ``setup`` gets the stage, as there; epochs,
``max_steps``, ``max_time``, ``limit_train_batches``,
``val_check_interval``, ``check_val_every_n_epoch``,
``callback_metrics``, checkpoint restore and the default
``ModelCheckpoint(monitor=None)``), the optimizer step
follows ``_build_tx`` (``core/optim.py``), and the evaluation loops
average per-batch metrics weighted by batch size.

Where the JAX trainer compiles one step and donates its state, this one
runs the step eagerly: ``module.training_step`` under autograd, the
gradients of every f32 parameter leaf by ``torch.autograd.grad``, then the
in-place AdamW update.  Metrics stay tensors on the device and are read
at log and epoch boundaries only.

``ema_decay`` keeps an exponential moving average of the parameters in
the optimizer's state (``core/optim.py``), moved once per optimizer
update; ``ema_eval`` evaluates on it and ``ema_params()`` returns it.
``int8_matmul`` sets the module's flag, so a GPT's dense MLP products run
the int8 kernel in the training forward.

``device`` (None = the CUDA device) is where the step runs.  With an
``accelerator`` (``RayTPUAccelerator(N)``, ``RayAccelerator``,
``HorovodRayAccelerator``) every entry point fans out over N spawned
ranks, one device each, as the JAX trainer's launcher fans out over
host agents (``_fit_via_launcher``): a persistent ``DistributedWorld``
over a ``torch.distributed`` group (NCCL on the card, gloo on the
CPU), kept across fit -> validate -> test -> predict until
``shutdown_workers()``.  Inside the ranks the loader's ``batch_size``
is the global batch, each rank takes its ``batch_size / N`` rows
(``ShardedSampler``), the step averages the gradients and its scalar
metrics across the ranks before clipping, so every rank logs and
decides on the global batch's numbers, and only rank 0 writes
checkpoints and logs.  Rank 0's weights, counters, metrics, callback
states and log rows come home to the driver's module and trainer.

Sharded data parallelism follows the JAX package's plan
(``parallel/plan.py`` ``build_plan``, resolved at fit start in each
rank):
- ``shard_optimizer_state=True`` (ZeRO-1): the exact gradient mean as
  above, each rank updates the dim-0 slice of each divisible leaf (its
  moments hold only that slice), and the slices are all-gathered: bit
  for bit the replicated run;
- ``RayTPUAccelerator(N, use_fsdp=True)``: each large leaf is split over
  the ranks on one dim (the module's ``param_logical_axes()`` or the
  heuristic); the step all-gathers the f32 slices into the compute view,
  takes the local gradients of that view, reduce-scatters their mean
  into the owners and runs the optimizer on the owned slices;
- ``grad_compression="int8" | "bf16"``: the gradients cross the ranks
  quantized, with error-feedback residuals in ``TrainState.residual``
  (under FSDP the compute view is a bf16 all-gather and each rank keeps
  the residual of the chunk it owns); with ``accumulate_grad_batches >
  1`` the local gradients (plain) or the exchanged owned slices (FSDP)
  sum in ``TrainState.grad_accum`` and the update runs once a window.
The clip and ``log_grad_norm`` see the global norm.  ``comms_per_step``
is the analytic wire report.  ``checkpoint_format="sharded"`` /
``"sharded-async"`` writes each rank's own parts
(``utils/sharded_checkpoint.py``); ``"pickle"`` gathers the whole state
on rank 0.  A checkpoint restores onto another world size: params and
moments by their global shapes, residuals and accumulators reset.
The model axes (``RayTPUAccelerator(N, tensor=, sequence=, expert=)``,
``Accelerator(MeshConfig(...))``, ``Trainer(seq_parallel=,
seq_parallel_mode=)``) follow the JAX package on one host: each rank
builds its ``RankMesh`` (``parallel/mesh.py``: coordinates, one group
per axis and one for the batch axes) and hands it to the module
(``module.mesh``); the sampler splits the batch over the batch axes
only; the masters hold the rank's tensor / expert slices; the step sums
the gradients over the sequence group, then averages them over the batch
group (a tensor- or expert-split leaf is never averaged with another
rank's slice); dropout is keyed by the (batch, sequence) coordinates;
the clip and the logged norm sum each split leaf's squares over its
groups; the driver, the pickle checkpoints and ``predict`` get whole
tensors.  The layouts compose in two dimensions: under fsdp with the
tensor or expert axis a rank holds its fsdp slice of its model part,
gathers the compute view over the fsdp group of its model coordinate
and reduce-scatters the mean back over it (after the sequence sum and
the expert mean); the norm sums each owned slice's squares over the
batch group and the model axes that split its leaf.  ZeRO-1 applies
where the layouts leave every leaf replicated (as the JAX
``build_plan`` decides), and is skipped with its warning otherwise.
The sharded checkpoints record each part as a rectangle of its leaf
(``utils/sharded_checkpoint.py`` format 2).  The pipeline axis
(``RayTPUAccelerator(N, pipeline=S)``, alone or with the batch, tensor
and expert axes) splits the GPT's layers in S stages
(``parallel/pipeline.py``): the stages' parts of each leaf they share
are summed over the pipeline group before the batch mean.  A module
whose forward runs no pipeline schedule (``runs_pipeline_schedule``
False: ViT, the MNIST MLP, ResNet-18) runs its whole forward on every
stage, on the same rows; its layer stack (ViT's) is stored split over
the stages and gathered for the forward, and the stages' whole
gradients of the leaves they share are averaged instead.
``pipeline_stages > 1`` routes ``fit`` to the MPMD runner
(``parallel/mpmd``, as the JAX ``_fit_mpmd``): S stage groups of
spawned workers (``num_workers`` from the accelerator, else S) run the
``pipeline_schedule`` ("1f1b" or "gpipe") over
``pipeline_microbatches`` microbatches a batch, on the trainer's device,
with activations crossing the shm object store, per-stage failure
budgets and checkpoint replay under ``default_root_dir``; the module
overrides ``pipeline_stage_params`` / ``pipeline_stage_forward`` /
``pipeline_loss``.  ``trainer.pipeline_summary`` then holds the losses,
the measured and analytic bubble and the budgets.  ``gather_mode=
"scan"`` resolves as the JAX ``_resolve_gather_mode`` does: it engages
only in the compressed-FSDP regime for a module declaring
``scanned_param_subtrees`` with an fsdp-sharded scanned leaf and no
sequence axis, and that case raises ``NotImplementedError`` naming its
later slice (4e); everywhere else it trains as the tree gather, with
the JAX package's fall-back warning where that one warns (once a fit,
from the driver).  The pipeline axis with the sequence axis is refused,
as the JAX package's GPT raises on that mesh.

Telemetry (the JAX ``Trainer``'s): ``profiler=`` (``utils/profiler.py``)
takes spans ``data_fetch``, ``h2d``, ``train_step`` and ``validation``
(plus the prefetch pipeline's ``data_fetch`` / ``h2d_wait``, its
``prefetch_depth`` gauge and ``prefetch_starved_steps`` counter), the
``fsdp_fallback`` counter and the exchange's wire record;
``perf_observatory=`` (True builds one, ``telemetry/perf.py``) brackets
every optimizer step for the phase timeline (``h2d``, ``compute``,
``validation``, ``ckpt``, ``drain``, ``compile``, ``other``), registers
the HBM pools ``params``, ``opt_state``, ``exchange_buffers``,
``device_cache`` and ``prefetch`` and samples them off the hot path.
The flight recorder gets the JAX trainer's events (``fit_start``,
``train_step``, ``validation``, ``epoch_end``, ``fit_end``, ...).
``build_metrics_registry()`` merges the driver's profiler, every rank's
shipped export and event tail, the compile count and the ledgers; a
failed fit, validate, test or predict writes ``run_report.json`` under
``default_root_dir`` with the registry embedded (the driver only).
With ``RLA_TPU_METRICS_PORT`` set (``telemetry/live.py``) a fit serves
its registry live on the process's ``/metrics``; a fit over ranks also
runs a ``ClusterView`` over them (each rank serves its own endpoints),
merges it into the registry and puts its last view in the failure
report as ``cluster_view``.

The recovery layer (``runtime/``, the JAX ``Trainer``'s):
- ``worker_deadline_s``: a fit, validate, test or predict over the
  ranks runs under the watchdog (``DistributedWorld.run(deadline_s=)``;
  also armed by ``RLA_TPU_WEDGE_TIMEOUT_S``): a rank that stops making
  progress is reaped and the entry point raises ``WorkerWedged``, its
  flat diagnosis in ``last_stall_diagnosis``.  The MPMD runner takes it
  as its ``wedge_timeout_s``.
- The preemption drain: with ``RLA_TPU_PREEMPT_GRACE_S`` set, SIGTERM
  (or ``runtime.preemption.get_notice().request_local()``, or the flag
  file another rank wrote in ``default_root_dir``) drains the fit at the
  next step boundary: ``preempt-step{N}.ckpt`` is written (every rank
  waits at a barrier until it is) and ``Preempted`` is raised with step
  N; ``fit(ckpt_path="last")`` resumes there.  Over ranks the decision
  is a max all-reduce every ``RLA_TPU_PREEMPT_CONSENSUS_EVERY`` steps.
- Numeric chaos (``testing/chaos.py``): ``nanloss``, ``gradspike`` and
  ``bitflip`` are applied in the step, ``badbatch`` poisons the host
  batch of its step (beside the quarantine's skip seam); each is claimed
  once a fit.

The single-card defaults are the JAX package's:
- ``guard="auto"`` (``runtime/guardian.py``; ``GuardConfig.from_env``,
  off with ``RLA_TPU_GUARD=0``; None turns it off, a ``GuardConfig`` is
  used as is): every step folds the loss, the global gradient norm, the
  update / parameter norm ratio and, under the compressed exchange, each
  rank's local gradient health (one small gather a step) into
  ``TrainState.guard_ema``, on the device; ``metrics["guard"]`` is read
  with the log cadence's readback on every rank, at a mid-epoch
  validation and at the epoch's end before any callback, and a trip
  raises ``NumericAnomaly`` with its blame after the evidence is OR-ed
  over the ranks; a data-blamed batch is quarantined (rank 0 writes the
  ledger) and skipped by a later fit on the same root.  The guard only
  observes: a guarded fit is bitwise the unguarded one.
- ``prefetch_batches=2`` (``data/prefetch.py``): the next batches are
  placed on the device ahead of the step (from pinned memory on a side
  CUDA stream on the card), in fit, evaluation and predict, with the
  loader on a producer thread unless the native engine feeds it (its own
  threads gather ahead, off the GIL); cached rows need no placement.
  Every pipeline is closed on every way out.
- ``cache_dataset_on_device="auto"``: an array-backed training set of up
  to 1 GiB (any size with ``True``; never on the CPU under "auto") is
  placed on the device once and each step gathers its rows there; an
  epoch with no per-step host needs (no mid-epoch validation, no
  ``max_time``, no quarantine, no callback overriding
  ``on_train_batch_end``) runs its steps with no host readback and reads
  the stacked metrics back once at its end.
Over an accelerator's ranks the loaders and the datamodule cross once
per world (``DistributedWorld.ship_value``): a later entry point over
the same bytes sends their key.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import itertools
import json
import math
import os
import time
import types
import uuid
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..accelerators.base import Accelerator
from ..analysis import knobs
from ..data import prefetch as prefetch_lib
from ..data.loader import DataLoader, default_collate, rank_batch_size
from ..parallel import collectives as collectives_lib
from ..parallel import mesh as mesh_lib
from ..parallel import plan as plan_lib
from ..parallel import sharding as sharding_lib
from ..parallel.collectives import (MODEL_COMMS, GradExchange,
                                    any_across_ranks, sum_across_ranks,
                                    world_and_rank)
from ..runtime import guardian as guardian_lib
from ..telemetry import live as live_lib
from ..telemetry import perf as perf_lib
from ..telemetry import recorder
from ..utils import checkpoint as ckpt_lib
from ..utils import sharded_checkpoint as sharded_lib
from ..utils.logging import CSVLogger, InMemoryLogger, Logger, log
from ..utils.profiler import Profiler
from ..utils.seed import generator_from_seed, seed_everything
from .callbacks import Callback, ModelCheckpoint
from .module import DeviceLike, TorchModule, not_ported, resolve_device
from .optim import (AdamW, Optimizer, global_norm, state_layouts,
                    tree_leaves, tree_like)
from .state import TrainState

_PRECISION_DTYPES = {
    "bf16": torch.bfloat16, "bf16-mixed": torch.bfloat16,
    "f32": torch.float32, "32": torch.float32, 32: torch.float32,
}


# dump_checkpoint's default: the fit's live state
_LIVE = object()


def _tree_map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


class Trainer:
    def __init__(self,
                 max_epochs: Optional[int] = None,
                 max_steps: Optional[int] = None,
                 max_time: Optional[float] = None,
                 device: DeviceLike = None,
                 callbacks: Optional[Sequence[Callback]] = None,
                 logger: Optional[Logger] = None,
                 default_root_dir: Optional[str] = None,
                 limit_train_batches: Optional[int] = None,
                 limit_val_batches: Optional[int] = None,
                 check_val_every_n_epoch: int = 1,
                 val_check_interval: Optional[int] = None,
                 log_every_n_steps: int = 50,
                 precision: Any = "bf16",
                 accumulate_grad_batches: int = 1,
                 gradient_clip_val: Optional[float] = None,
                 log_grad_norm: bool = False,
                 enable_checkpointing: bool = True,
                 checkpoint_format: str = "pickle",
                 num_sanity_val_steps: int = 0,
                 enable_progress_bar: bool = False,
                 cache_dataset_on_device: Any = "auto",
                 prefetch_batches: int = 2,
                 guard: Any = "auto",
                 seed: Optional[int] = None,
                 accelerator: Any = None,
                 grad_compression: Optional[str] = None,
                 shard_optimizer_state: bool = False,
                 gather_mode: str = "tree",
                 pipeline_stages: int = 1,
                 pipeline_schedule: str = "1f1b",
                 pipeline_microbatches: int = 4,
                 seq_parallel: int = 1,
                 seq_parallel_mode: Optional[str] = None,
                 profiler: Optional[Profiler] = None,
                 perf_observatory: Any = None,
                 ema_decay: Optional[float] = None,
                 ema_eval: bool = False,
                 int8_matmul: bool = False,
                 worker_deadline_s: Optional[float] = None):
        if accelerator is not None and not isinstance(accelerator,
                                                      Accelerator):
            raise TypeError(f"accelerator must be an Accelerator (e.g. "
                            f"RayAccelerator(num_workers=2)), got "
                            f"{type(accelerator).__name__}")
        # the JAX package's refusals, with its exception types and text
        self._exchange_cfg = collectives_lib.ExchangeConfig(
            mode=grad_compression)  # validates the mode string
        if checkpoint_format not in ("pickle", "sharded", "sharded-async"):
            raise ValueError(
                f"unknown checkpoint_format {checkpoint_format!r}")
        if gather_mode not in collectives_lib.GATHER_MODES:
            raise ValueError(
                f"gather_mode must be one of "
                f"{collectives_lib.GATHER_MODES}, got {gather_mode!r}")
        if grad_compression is not None and accelerator is not None:
            cfg = accelerator.mesh_config
            collectives_lib.validate_mesh_for_compression(mesh_lib.Mesh({
                mesh_lib.PIPELINE_AXIS: accelerator.pipeline_size,
                mesh_lib.EXPERT_AXIS: cfg.expert,
                mesh_lib.SEQUENCE_AXIS: cfg.sequence,
                mesh_lib.TENSOR_AXIS: cfg.tensor}))
        accelerator = self._seq_parallel_accelerator(
            accelerator, seq_parallel, seq_parallel_mode, pipeline_stages,
            grad_compression)
        refused = (accelerator.unported() if accelerator is not None
                   else [])
        for bad, what, slice_name in refused:
            if bad:
                raise (NotImplementedError(what) if slice_name is None
                       else not_ported(what, slice_name))
        self._validate_mpmd(pipeline_stages, pipeline_schedule,
                            pipeline_microbatches, grad_compression,
                            shard_optimizer_state, accumulate_grad_batches)
        self.pipeline_stages = pipeline_stages
        self.pipeline_schedule = pipeline_schedule
        self.pipeline_microbatches = pipeline_microbatches
        # the last MPMD fit's summary (losses, bubble, budgets, steps)
        # and its trace id
        self.pipeline_summary: Optional[Dict[str, Any]] = None
        self.trace_id: Optional[str] = None
        # spans, counters and gauges of the hot phases (None: none taken)
        self.profiler = profiler
        # the perf observatory: True builds one, or pass a PerfObservatory
        if perf_observatory is True:
            perf_observatory = perf_lib.PerfObservatory()
        self.perf = perf_observatory or None
        # each rank's shipped telemetry of the last fan-out (its profiler
        # export and event tail), merged by build_metrics_registry()
        self._rank_telemetry: Dict[Any, Optional[Dict[str, Any]]] = {}
        # the live plane (telemetry/live.py): this process's server
        # (started at fit when RLA_TPU_METRICS_PORT is set) and, for a
        # fan-out, the ClusterView over the ranks, whose last view the
        # failure report keeps
        self._live_server = None
        self._cluster_view = None
        if precision not in _PRECISION_DTYPES:
            raise ValueError(
                f"unsupported precision {precision!r}; choose from "
                f"{sorted(str(k) for k in _PRECISION_DTYPES)}")
        if ema_decay is not None and not 0.0 < ema_decay < 1.0:
            raise ValueError(f"ema_decay must be in (0, 1), got {ema_decay}")
        if ema_eval and ema_decay is None:
            raise ValueError("ema_eval=True requires ema_decay")
        self.ema_decay = ema_decay
        self.ema_eval = ema_eval
        self.int8_matmul = int8_matmul
        # the watchdog's per-run deadline over the ranks (and the MPMD
        # runner's wedge timeout); the flat record of the last stall
        self.worker_deadline_s = worker_deadline_s
        self.last_stall_diagnosis: Optional[Dict[str, Any]] = None
        # the preemption notice of a fit with a grace budget, and the
        # numeric chaos faults this fit parsed and claimed
        self._preempt_notice = None
        self._preempt_check_every = 1
        self._chaos_numeric: tuple = ()
        self._chaos_step: tuple = ()
        if max_epochs is None and max_steps is None:
            max_epochs = 1000
        self.max_epochs = max_epochs
        self.max_steps = max_steps
        self.max_time = max_time
        self.device = resolve_device(device)
        self.accelerator = accelerator
        if accelerator is not None:
            accelerator.bind_device(self.device)
        self._world = None          # the spawned ranks (DistributedWorld)
        self.train_dataloader = None  # the loader fit() iterates
        # rank 0's report of the last fit over an accelerator's ranks
        # (device, backend, all-reduces and their ms, kernel launches)
        self.rank_report: Optional[Dict[str, Any]] = None
        self._exchange: Optional[GradExchange] = None
        # this rank's place on the mesh axes and their groups (a single
        # process's mesh outside a world)
        self._rank_mesh: mesh_lib.RankMesh = mesh_lib.local_mesh()
        self._model_layouts: List[Any] = []
        self._model_sharded = False
        self.callbacks: List[Callback] = list(callbacks or [])
        self.default_root_dir = default_root_dir or os.path.join(
            os.getcwd(), "rla_tpu_logs")
        self.logger = logger if logger is not None else InMemoryLogger()
        self.limit_train_batches = limit_train_batches
        self.limit_val_batches = limit_val_batches
        self.check_val_every_n_epoch = max(1, check_val_every_n_epoch)
        self.val_check_interval = val_check_interval
        self.log_every_n_steps = log_every_n_steps
        self.precision = precision
        self.compute_dtype = _PRECISION_DTYPES[precision]
        self.accumulate_grad_batches = max(1, accumulate_grad_batches)
        self.gradient_clip_val = gradient_clip_val
        # "grad_norm": the global norm of each micro-batch's gradients
        self.log_grad_norm = log_grad_norm
        self.enable_checkpointing = enable_checkpointing
        # "pickle": one file, the whole state gathered on rank 0;
        # "sharded": every rank writes its own parts; "sharded-async": the
        # same, written from a background thread
        self.checkpoint_format = checkpoint_format
        # compressed gradient exchange ("int8" | "bf16" | None), ZeRO-1,
        # and how the FSDP compute view is gathered (asked for, and what
        # the last fit resolved it to: "tree" wherever it falls back)
        self.grad_compression = grad_compression
        self.shard_optimizer_state = shard_optimizer_state
        self.gather_mode = gather_mode
        self._gather_mode_eff = "tree"
        # the analytic bytes on the wire of one exchange (the last fit's,
        # under grad_compression)
        self.comms_per_step: Optional[Dict[str, Any]] = None
        # the last fit's sharding plan (``ShardingPlan``; its describe()
        # comes home from the ranks in ``rank_report["plan"]``)
        self._plan: Optional[plan_lib.ShardingPlan] = None
        self.num_sanity_val_steps = num_sanity_val_steps
        self.enable_progress_bar = enable_progress_bar
        # the device dataset cache: "auto" caches array-backed datasets up
        # to _CACHE_MAX_BYTES on a card; True forces it, False disables
        self.cache_dataset_on_device = cache_dataset_on_device
        self._device_cache: Optional[tuple] = None
        # the async input pipeline's depth (0: a synchronous loop)
        if not isinstance(prefetch_batches, int) or prefetch_batches < 0:
            raise ValueError(
                f"prefetch_batches must be an int >= 0, got "
                f"{prefetch_batches!r}")
        self.prefetch_batches = prefetch_batches
        # the numeric guardian: "auto" reads the guard knobs, None turns
        # it off, a GuardConfig is used as is
        if guard == "auto":
            guard = guardian_lib.GuardConfig.from_env()
        if guard is not None and not isinstance(guard,
                                                guardian_lib.GuardConfig):
            raise ValueError(
                f"guard must be 'auto', None, or a GuardConfig, got "
                f"{guard!r}")
        self.guard = guard
        # the host companion, bound at fit start
        self._guardian: Optional[guardian_lib.Guardian] = None
        self.seed = seed_everything(seed)
        if enable_checkpointing and not any(
                isinstance(c, ModelCheckpoint) for c in self.callbacks):
            self.callbacks.append(ModelCheckpoint(monitor=None))

        self.current_epoch = 0
        self.epochs_completed = 0
        self.global_step = 0
        self.should_stop = False
        self.sanity_checking = False
        self.fitting = False
        self.callback_metrics: Dict[str, float] = {}
        self.module: Optional[TorchModule] = None
        self._state: Optional[TrainState] = None
        self._val_loader = None
        # the live state: the ranks keep theirs between dispatches under
        # this run's key (``_LIVE_RUNS``); the driver's record of it
        self._run_key = uuid.uuid4().hex
        self._live: Optional[Dict[str, Any]] = None
        # the overheads only the driver sees (the live resize's pause)
        self.goodput = perf_lib.GoodputLedger()

    def _validate_mpmd(self, pipeline_stages, pipeline_schedule,
                       pipeline_microbatches, grad_compression,
                       shard_optimizer_state,
                       accumulate_grad_batches) -> None:
        """The JAX Trainer's checks of the MPMD pipeline arguments, with
        its types and text."""
        if not isinstance(pipeline_stages, int) or pipeline_stages < 1:
            raise ValueError(
                f"pipeline_stages must be an int >= 1, got "
                f"{pipeline_stages!r}")
        if pipeline_stages == 1:
            return
        from ..parallel.mpmd import schedule as mpmd_schedule_lib
        if pipeline_schedule not in mpmd_schedule_lib.SCHEDULES:
            raise ValueError(
                f"pipeline_schedule must be one of "
                f"{mpmd_schedule_lib.SCHEDULES}, got "
                f"{pipeline_schedule!r}")
        if not isinstance(pipeline_microbatches, int) or \
                pipeline_microbatches < 1:
            raise ValueError(
                f"pipeline_microbatches must be an int >= 1, got "
                f"{pipeline_microbatches!r}")
        if grad_compression is not None:
            raise ValueError(
                "grad_compression composes with the compiled SPMD "
                "gradient exchange, not with pipeline_stages > 1: "
                "MPMD lane gradients cross the object store in fp32 "
                "by design (exact parity with the single-group "
                "baseline)")
        if shard_optimizer_state:
            raise ValueError(
                "shard_optimizer_state=True (ZeRO-1) is an SPMD-mesh "
                "feature; under pipeline_stages > 1 each stage group "
                "shards within its stage instead — pass fsdp>1 "
                "through the pipeline runner")
        if accumulate_grad_batches > 1:
            raise ValueError(
                "accumulate_grad_batches > 1 is redundant under "
                "pipeline_stages > 1: the pipeline schedule already "
                "accumulates pipeline_microbatches gradients per "
                "optimizer step")

    def _seq_parallel_accelerator(self, accelerator, seq_parallel,
                                  seq_parallel_mode, pipeline_stages,
                                  grad_compression):
        """``seq_parallel`` / ``seq_parallel_mode`` as the JAX Trainer
        reads them: the int and the mode validated (the mode defaults to
        the ``RLA_TPU_SEQ_PARALLEL_MODE`` knob, else ``"ulysses"``), the
        combinations it refuses refused with its types and text, and the
        accelerator returned with the sequence axis injected (a copy: the
        caller's is left as it was; without one, a world of
        ``seq_parallel`` ranks over the sequence axis)."""
        if not isinstance(seq_parallel, int) or seq_parallel < 1:
            raise ValueError(
                f"seq_parallel must be an int >= 1, got {seq_parallel!r}")
        self.seq_parallel = seq_parallel
        if seq_parallel_mode is None:
            seq_parallel_mode = knobs.get_str("RLA_TPU_SEQ_PARALLEL_MODE",
                                              "ulysses")
        if seq_parallel_mode not in ("ulysses", "ring"):
            raise ValueError(
                f"seq_parallel_mode must be 'ulysses' or 'ring', got "
                f"{seq_parallel_mode!r}")
        self.seq_parallel_mode = seq_parallel_mode
        if seq_parallel == 1:
            return accelerator
        if pipeline_stages > 1:
            raise ValueError(
                "seq_parallel > 1 composes with the SPMD data×fsdp "
                "mesh, not with pipeline_stages > 1: the MPMD stage "
                "groups split layers across processes while the "
                "sequence axis splits activations within one program "
                "— shard sequence inside a stage via the stage "
                "group's own mesh instead")
        if grad_compression is not None:
            raise ValueError(
                "grad_compression wraps the forward in a full-manual "
                "shard_map (parallel/collectives.py "
                "build_local_grads), which cannot nest the "
                "ulysses/ring attention shard_map; run seq_parallel "
                "with the implicit fp32 exchange")
        if accelerator is None:
            return Accelerator(mesh_lib.MeshConfig(sequence=seq_parallel))
        mesh_cfg = accelerator.mesh_config
        if mesh_cfg.sequence not in (1, seq_parallel):
            raise ValueError(
                f"seq_parallel={seq_parallel} conflicts with the "
                f"accelerator's mesh_config.sequence="
                f"{mesh_cfg.sequence}; pass one or the other")
        if mesh_cfg.sequence != seq_parallel:
            accelerator = copy.copy(accelerator)
            accelerator.mesh_config = dataclasses.replace(
                mesh_cfg, sequence=seq_parallel)
        return accelerator

    def _apply_seq_parallel(self, module: TorchModule, seq: int) -> None:
        """The JAX Trainer's refusals for a sequence axis, and the mode
        written onto the module's config (``GPT._attention`` dispatches
        on ``cfg.context_parallel``): the module must be
        context-parallel-aware, its sequence length must divide by the
        axis and, for Ulysses, its head count too."""
        cfg = getattr(module, "cfg", None)
        if cfg is None or not hasattr(cfg, "context_parallel"):
            raise ValueError(
                f"seq_parallel={seq} needs a context-parallel-aware "
                f"module (one whose config carries `context_parallel`, "
                f"e.g. models.GPT); {type(module).__name__} cannot "
                f"shard its attention over a sequence axis")
        max_seq = getattr(cfg, "max_seq_len", None)
        if max_seq is not None and max_seq % seq != 0:
            raise ValueError(
                f"sequence length ({max_seq}) is not divisible by the "
                f"sequence axis size ({seq}); pad max_seq_len or change "
                f"seq_parallel")
        n_heads = getattr(cfg, "n_heads", None)
        if (self.seq_parallel_mode == "ulysses" and n_heads is not None
                and n_heads % seq != 0):
            raise ValueError(
                f"ulysses needs heads ({n_heads}) divisible by the "
                f"sequence axis size ({seq}); use "
                f"seq_parallel_mode='ring' instead")
        cfg.context_parallel = self.seq_parallel_mode

    def _apply_pipeline(self, module: TorchModule, stages: int,
                        fitting: bool) -> None:
        """The JAX GPT's refusals under the pipeline axis, with its types
        and text, raised in the launching process before any rank starts:
        MoE layers, dropout in a fit, a layer count the stages cannot
        split.  A module whose forward runs no pipeline schedule (ViT, the
        MNIST MLP, ResNet-18) trains as in the JAX package: every stage
        runs the whole forward on the same rows."""
        if not getattr(module, "runs_pipeline_schedule", False):
            return
        from ..parallel import pipeline as pipeline_lib
        cfg = module.cfg
        if cfg.num_experts > 1:
            raise NotImplementedError(pipeline_lib.MOE_REFUSAL)
        if fitting and cfg.dropout > 0:
            raise NotImplementedError(pipeline_lib.DROPOUT_REFUSAL)
        pipeline_lib.check_layers(cfg.n_layers, stages)

    def _mesh_seq(self) -> int:
        """The sequence axis's size of the accelerator's world."""
        return (self.accelerator.mesh_config.sequence
                if self.accelerator is not None else 1)

    @property
    def world_size(self) -> int:
        """Ranks of the data-parallel world this trainer runs in (1 on the
        driver and without an accelerator)."""
        return world_and_rank()[0]

    @property
    def global_rank(self) -> int:
        return world_and_rank()[1]

    def __getstate__(self) -> Dict[str, Any]:
        """What ships to the ranks: no live world, state or module (the
        module ships beside the trainer and is rebound there)."""
        state = dict(self.__dict__)
        state.update(_world=None, _state=None, module=None,
                     _val_loader=None, _exchange=None,
                     train_dataloader=None, _plan=None, _guardian=None,
                     _device_cache=None, _preempt_notice=None,
                     goodput=None, _rank_telemetry={},
                     # sockets and threads: a rank starts its own server
                     # at boot and binds its copy of the trainer at fit
                     _live_server=None, _cluster_view=None)
        return state

    # ------------------------------------------------------------------ #
    # Checkpoints                                                        #
    # ------------------------------------------------------------------ #
    @property
    def checkpoint_callback(self) -> Optional[ModelCheckpoint]:
        for c in self.callbacks:
            if isinstance(c, ModelCheckpoint):
                return c
        return None

    def dump_checkpoint(self, state: Any = _LIVE) -> Dict[str, Any]:
        """The checkpoint payload of ``state`` (the fit's by default; None
        for the sharded formats' ``meta.json``, which holds no tensors)."""
        state = self._state if state is _LIVE else state
        cb_states = {c.state_key: c.state_dict() for c in self.callbacks
                     if c.state_dict()}
        n = self._rank_mesh.batch_size
        plan = self._plan
        # the world record: a resume at another world size resets the
        # per-rank buffers and redistributes the rest by global shape
        world = {"dp": n, "fsdp": plan.fsdp if plan is not None else 1,
                 "processes": world_and_rank()[0]}
        # the stored epoch counts COMPLETED epochs, so a resumed run neither
        # repeats the epoch that produced the save nor skips ahead
        payload = ckpt_lib.build_checkpoint(
            state, self.epochs_completed, self.global_step,
            hparams=getattr(self.module, "hparams", {}), callbacks=cb_states,
            extra={"world": world})
        if self.module is not None:
            self.module.on_save_checkpoint(payload)
        for c in self.callbacks:
            c.on_save_checkpoint(self, self.module, payload)
        return payload

    def save_checkpoint(self, filepath: str,
                        async_save: Optional[bool] = None) -> None:
        """``pickle``: rank 0 writes the whole state (gathered from the
        ranks' parts when sharded), the others wait at a barrier.  The
        sharded formats: every rank writes its own parts, from a
        background thread under ``"sharded-async"`` unless ``async_save``
        says otherwise."""
        with self._perf_phase("ckpt"):   # the timeline: a save is a phase
            self._save_checkpoint(filepath, async_save)

    def _save_checkpoint(self, filepath: str,
                         async_save: Optional[bool]) -> None:
        n, rank = world_and_rank()
        if async_save is None:
            async_save = self.checkpoint_format == "sharded-async"
        barrier = torch.distributed.barrier if n > 1 else None
        if self.checkpoint_format != "pickle":
            meta = self.dump_checkpoint(state=None)
            meta["scalars"] = _state_scalars(self._state)
            if self._state.guard_ema is not None:
                meta["guard_ema"] = self._state.guard_ema.tolist()
            # every rank of the world: the first rank holding each part
            # writes it
            sharded_lib.save_sharded(
                filepath, self._checkpoint_entries(self._state), meta,
                async_save=async_save,
                rank=rank, world=n, barrier=barrier,
                shape=dict(self._rank_mesh.shape),
                order=self._rank_mesh.order)
            return
        state = self._whole_state()
        if rank == 0:
            ckpt_lib.atomic_save(self.dump_checkpoint(state), filepath)
        if barrier is not None:
            barrier()

    # ---- the preemption drain (JAX ``:513-607``) ----------------------- #
    def _bind_preemption(self) -> None:
        """Arm the drain for this fit when a grace budget is configured:
        the process's notice, with the run directory as the flag dir (one
        rank's SIGTERM drains every rank), a stale flag of an earlier
        drain cleared.  Otherwise ``_preempt_notice`` stays None and the
        step loop pays nothing."""
        from ..runtime import preemption as preempt_lib
        notice = preempt_lib.get_notice()
        if preempt_lib.grace_from_env() is None and not notice.enabled():
            self._preempt_notice = None
            return
        notice.install(flag_dir=self.default_root_dir)
        notice.clear_stale_flag()
        # over ranks the decision is a collective: on the same schedule
        # on every rank, so it always has full participation
        self._preempt_check_every = max(1, knobs.get_int(
            preempt_lib.PREEMPT_CONSENSUS_EVERY_ENV, 8))
        self._preempt_notice = notice

    def _maybe_drain_preemption(self, every_step: bool = False) -> None:
        """The step-boundary poll: on a notice the ranks agree on, write
        the emergency checkpoint and raise ``Preempted``.  ``every_step``
        skips the consensus schedule (epoch boundaries of the
        whole-epoch path, rare and the same on every rank)."""
        notice = self._preempt_notice
        if notice is None:
            return
        from ..runtime import preemption as preempt_lib
        if not every_step and self.world_size > 1 \
                and self.global_step % self._preempt_check_every != 0:
            return
        if not preempt_lib.consensus_requested(notice.requested(),
                                               self.device):
            return
        log.warning(
            "preemption notice (%s): draining at step %d (grace %.1fs, "
            "%.1fs remaining)", notice.source, self.global_step,
            notice.grace_s(), notice.remaining_s() or 0.0)
        recorder.emit("preempt_drain", step=self.global_step,
                      source=notice.source)
        with self._perf_phase("drain"):   # the drain with its save
            path = self._emergency_checkpoint()
        recorder.emit("emergency_checkpoint", step=self.global_step,
                      path=path)
        self.fitting = False
        raise preempt_lib.Preempted.at_step(
            self.global_step, path, source=notice.source or "notice")

    def _emergency_checkpoint(self) -> Optional[str]:
        """``preempt-step{N}.ckpt`` under the checkpoint directory,
        written synchronously (an in-flight async save is fenced first),
        then a barrier of every rank: none raises ``Preempted`` before the
        file is whole."""
        if self._state is None or not self.enable_checkpointing:
            return None
        cb = self.checkpoint_callback
        dirpath = (cb.dirpath if cb is not None and cb.dirpath
                   else os.path.join(self.default_root_dir, "checkpoints"))
        path = os.path.join(dirpath,
                            f"preempt-step{self.global_step}.ckpt")
        if self.checkpoint_format != "pickle":
            sharded_lib.wait_until_finished()
        self.save_checkpoint(path, async_save=False)
        if self.world_size > 1:
            torch.distributed.barrier()
        log.warning("emergency checkpoint written: %s", path)
        return path

    def _whole_state(self) -> Any:
        """The fit's state with the ranks' parts gathered to whole tensors
        (a collective in a world: every rank calls it), for
        ``dump_checkpoint``; None outside a fit."""
        state = self._state
        return None if state is None else self._global_host_state(state)

    def _restore(self, ckpt_path: str, state: TrainState) -> TrainState:
        if sharded_lib.is_sharded_checkpoint(ckpt_path):
            payload = sharded_lib.read_metadata(ckpt_path)
            self._load_globals(state, sharded_lib.restore_sharded(ckpt_path),
                               payload.get("scalars", {}), payload)
        else:
            payload = ckpt_lib.read_checkpoint(ckpt_path)
            st = payload["state"]
            self._load_globals(state, _payload_globals(payload),
                               _scalars(st["step"], st["rng_seed"],
                                        st["opt_state"]), payload)
        self.current_epoch = payload["epoch"]
        self.epochs_completed = payload["epoch"]
        self.global_step = payload["global_step"]
        for c in self.callbacks:
            if c.state_key in payload.get("callbacks", {}):
                c.load_state_dict(payload["callbacks"][c.state_key])
            c.on_load_checkpoint(self, self.module, payload)
        if self.module is not None:
            self.module.on_load_checkpoint(payload)
        if state.guard_ema is not None:
            # a restore restarts the guard fresh: a sticky trip that was
            # checkpointed must not raise again on the first readback (a
            # checkpoint without the vector loads the same way)
            state.guard_ema = guardian_lib.fresh_state(self.device)
        return state

    # ---- the state by name (every checkpoint format) ----------------- #
    def _state_entries(self, state: TrainState,
                       model: bool = False) -> List[tuple]:
        """Every tensor of ``state`` as ``(name, local tensor, layout)``:
        ``params/<path>``, ``opt/<kind>/<moment>/<path>``,
        ``opt/ema/<path>``, ``opt/acc/<path>``, ``residual/<path>``,
        ``grad_accum/<path>``.  A layout is None (whole), the dim split
        over the batch axes, or ``PER_REPLICA`` (this rank's row); with
        ``model`` it is the tensor / expert pairs of the leaf's layout
        instead (None for the per-rank buffers)."""
        paths = _leaf_paths(state.params)
        out = [(f"params/{p}", t, d) for p, t, d in zip(
            paths, tree_leaves(state.params),
            self._model_layouts if model else self._param_layouts)]
        owned = self._model_layouts if model else self._owned_layouts
        for key, value in state.opt.state.items():
            if isinstance(value, dict):
                for name, lst in value.items():
                    if isinstance(lst, list):
                        out += [(f"opt/{key}/{name}/{p}", t, d)
                                for p, t, d in zip(paths, lst, owned)]
            elif isinstance(value, list):
                out += [(f"opt/{key}/{p}", t, d)
                        for p, t, d in zip(paths, value, owned)]
        per = None if model else plan_lib.PER_REPLICA
        if state.residual is not None:
            out += [(f"residual/{p}", t, per) for p, t in zip(
                paths, tree_leaves(state.residual))]
        if state.grad_accum is not None:
            acc_l = (self._param_layouts if self._fsdp and not model
                     else [per] * len(paths))
            out += [(f"grad_accum/{p}", t, d) for p, t, d in zip(
                paths, tree_leaves(state.grad_accum), acc_l)]
        return out

    def _checkpoint_entries(self, state: TrainState) -> List[tuple]:
        """``_state_entries`` with each leaf's whole layout, as the
        sharded checkpoint records it: its model axes' pairs, then
        ``("batch", dim)`` for the batch axes' split of the model part
        (a per-rank buffer keeps ``PER_REPLICA``)."""
        out = []
        for (name, t, d), (_, _, m) in zip(
                self._state_entries(state),
                self._state_entries(state, model=True)):
            if d == plan_lib.PER_REPLICA:
                out.append((name, t, d))
                continue
            pairs = tuple(m or ()) + (
                ((sharded_lib.BATCH, d),) if d is not None else ())
            out.append((name, t, pairs or None))
        return out

    def _global_host_state(self, state: TrainState) -> Any:
        """The whole state on the host, in the pickle payload's shape
        (a collective: every rank calls it; per-rank buffers stacked as
        the JAX package's ``[n, ...]``)."""
        entries = self._state_entries(state)
        n = self._rank_mesh.batch_size
        # the batch axes' slices first (each rank's slice of its model
        # part), then the model axes' (exact, over their groups); a
        # per-rank row is gathered as a [1, ...] slice of dim 0
        models = [d for _, _, d in self._state_entries(state, model=True)]
        parts = [(t.detach().unsqueeze(0), 0) if d == plan_lib.PER_REPLICA
                 else (t.detach(), d) for _, t, d in entries]
        split = [i for i, (_, d) in enumerate(parts) if d is not None]
        full = [t for t, _ in parts]
        if split:
            fulls = (self._exchange.gather_params([parts[i] for i in split])
                     if n > 1 else [parts[i][0] for i in split])
            for i, f in zip(split, fulls):
                full[i] = f
        full = [self._gather_model(t, m) for t, m in zip(full, models)]
        by_name = {name: t for (name, _, _), t in zip(entries, full)}
        return _HostState(state, by_name)

    def _load_globals(self, state: TrainState, saved: Dict[str, Any],
                      scalars: Dict[str, int], payload: Dict[str, Any]
                      ) -> None:
        """Copy a checkpoint's global tensors into this rank's parts.  A
        save from another world size (or another exchange layout) resets
        the residuals and accumulators, as the JAX package does."""
        n, rank = self._rank_mesh.batch_size, self._rank_mesh.batch_rank
        saved_world = (payload.get("world") or {}).get("dp")
        resized = saved_world is not None and saved_world != n
        if resized:
            log.warning(
                "resuming a checkpoint saved at data-parallel world size %d "
                "(fsdp %s) onto %d (fsdp %d): ZeRO-1/optimizer shards "
                "redistribute via their global shapes; per-replica "
                "error-feedback residuals and gradient accumulators reset "
                "to zero (replica-local semantics cannot cross world "
                "layouts)", saved_world,
                (payload.get("world") or {}).get("fsdp"), n,
                self._plan.fsdp if self._plan is not None else 1)
        reset = []
        models = [d for _, _, d in self._state_entries(state, model=True)]
        with torch.no_grad():
            for (name, local, layout), model in zip(
                    self._state_entries(state), models):
                buf = name.startswith(("residual/", "grad_accum/"))
                g = saved.get(name)
                if g is not None:
                    g = torch.as_tensor(g)
                if buf and (resized or g is None):
                    local.zero_()
                    continue
                if g is None:
                    if name.startswith("opt/ema/"):
                        # saved without an EMA: the shadow starts at the
                        # restored params (copied below, in order)
                        reset.append(name)
                        continue
                    if name.startswith("opt/acc/"):
                        local.zero_()
                        continue
                    raise ValueError(f"checkpoint holds no {name}")
                part = sharded_lib.local_part(
                    sharding_lib.local_part(g, model, self._rank_mesh),
                    layout, rank, n)
                if tuple(part.shape) != tuple(local.shape):
                    if buf:
                        log.warning(
                            "restored %s does not match this run's "
                            "exchange layout; resetting it to zero", name)
                        local.zero_()
                        continue
                    raise ValueError(
                        f"checkpoint {name}: shape {tuple(part.shape)}, "
                        f"expected {tuple(local.shape)}")
                local.copy_(part.to(local.dtype))
            if reset:
                owned = dict(zip(_leaf_paths(state.params),
                                 state.opt.params))
                for name, local, _ in self._state_entries(state):
                    if name in reset:
                        local.copy_(owned[name[len("opt/ema/"):]])
        _apply_scalars(state, scalars)

    # ------------------------------------------------------------------ #
    # State and the step                                                 #
    # ------------------------------------------------------------------ #
    def _bind(self, module: TorchModule) -> None:
        self.module = module
        module.trainer = self
        module.compute_dtype = self.compute_dtype
        module.device = self.device

    def _master_params(self, module: TorchModule) -> Any:
        """f32 leaf tensors on the device, with ``requires_grad``: a copy
        of ``module.params`` when it is set (a module that already carries
        weights continues from them), else fresh ``init_params``."""
        src = module.params if module.params is not None \
            else module.init_params(self.seed)
        return _tree_map(lambda t: torch.as_tensor(t).detach().to(
            self.device, torch.float32).clone().requires_grad_(True), src)

    def _mesh(self) -> mesh_lib.Mesh:
        """The axis sizes of the world this fit runs in: the
        accelerator's inside its ranks, one rank otherwise."""
        if self.accelerator is not None and _in_world():
            return self.accelerator.build_mesh()
        return mesh_lib.build_mesh(mesh_lib.MeshConfig(data=1), 1)

    def _build_state(self, module: TorchModule) -> TrainState:
        """The fit's state, laid out by the sharding plan: this rank's
        slice of each sharded param (f32 masters), the optimizer over the
        owned parts (FSDP slices; ZeRO-1's dim-0 slices of the replicated
        params), and under compression the residuals and accumulators."""
        tx = module.configure_optimizers()
        if tx is None:
            tx = AdamW(1e-3, weight_decay=0.0)
        full = self._master_params(module)
        rmesh = self._rank_mesh
        n, rank = rmesh.batch_size, rmesh.batch_rank
        mesh = self._mesh()
        cfg = self._exchange_cfg
        compressed = cfg.mode is not None
        opt_accumulate = self._opt_accumulate()
        plan = self._build_plan(mesh, self.accelerator or Accelerator(),
                                module, full, tx)
        from ..parallel.sharding import validate_shardings
        validate_shardings(full, plan.param_layouts, mesh)
        self._plan = plan
        # the driver warned (or refused) before spawning; a rank resolves
        # quietly
        self._gather_mode_eff = self._resolve_gather_mode(
            module, full, plan, mesh, quiet=_in_world())
        if self.profiler is not None:
            # leaves use_fsdp had to keep replicated (each warned at
            # resolution), counted into the merged registry's export
            n_fb = len(getattr(self.accelerator, "last_fsdp_fallbacks",
                               ()) or ())
            if n_fb:
                self.profiler.incr("fsdp_fallback", n_fb)
        full_leaves = tree_leaves(full)
        (self._param_layouts, self._model_layouts, self._zero1,
         self._owned_layouts) = _plan_layouts(plan)
        self._model_sharded = any(m is not None for m in self._model_layouts)
        self._fsdp = any(d is not None for d in self._param_layouts)
        if compressed:
            self.comms_per_step = collectives_lib.wire_bytes_per_step(
                full, n, cfg, param_shardings=plan.fsdp_param_layouts)
            if self.profiler is not None:
                self.profiler.record_comms(self.comms_per_step)
            if self.perf is not None:
                # the timeline states the analytic exposed / hidden wire
                # split beside the measured phases
                self.perf.timeline.attach_comms(self.comms_per_step)
        full_leaves = [sharding_lib.local_part(t, m, rmesh)
                       for t, m in zip(full_leaves, self._model_layouts)]
        masters = [(t if d is None else _slice(t, d, rank, n))
                   .clone().requires_grad_(True)
                   if d is not None or m is not None else t
                   for t, d, m in zip(full_leaves, self._param_layouts,
                                      self._model_layouts)]
        params = tree_like(full, masters)
        with torch.no_grad():
            owned = ([_slice(t, z, rank, n) if z is not None else t
                      for t, z in zip(masters, self._zero1)]
                     if self._zero1 is not None else masters)
        opt = Optimizer(tx, owned, clip_norm=self.gradient_clip_val,
                        accumulate=opt_accumulate, ema_decay=self.ema_decay,
                        norm_fn=self._owned_norm)
        residual = grad_accum = None
        if compressed:
            if self._fsdp:
                residual = collectives_lib.fsdp_residual_zeros(
                    full, plan.param_layouts, cfg, n)
                if self.accumulate_grad_batches > 1:
                    grad_accum = tree_like(full, [
                        torch.zeros_like(m, dtype=torch.float32).detach()
                        for m in masters])
            else:
                residual = collectives_lib.residual_zeros(full, cfg)
                if self.accumulate_grad_batches > 1:
                    grad_accum = tree_like(full, [
                        torch.zeros_like(t, dtype=torch.float32).detach()
                        for t in full_leaves])
        del full, full_leaves
        guard = (guardian_lib.fresh_state(self.device)
                 if self.guard is not None else None)
        return TrainState(step=0, params=params, opt=opt,
                          rng=generator_from_seed(self.seed),
                          residual=residual, grad_accum=grad_accum,
                          guard_ema=guard)

    def _resolve_gather_mode(self, module: TorchModule, params: Any,
                             plan: plan_lib.ShardingPlan,
                             mesh: mesh_lib.Mesh,
                             quiet: bool = False) -> str:
        """The gather mode this fit runs (JAX ``_resolve_gather_mode``,
        ``:867``, with its reasons and warning).  ``"scan"`` engages only
        when it was asked for under the compressed-FSDP regime, the
        module declares ``scanned_param_subtrees`` (top-level keys of the
        params), no scanned leaf is split on its layer dim, the mesh has
        no sequence axis and a scanned leaf is fsdp-sharded; that case
        raises ``not_ported`` (4e).  Anything else is the tree gather,
        with the JAX package's warning (unless ``quiet``) where it warns:
        outside the compressed-FSDP regime it falls back silently, as
        JAX resolves the mode only there."""
        if self.gather_mode != "scan" or plan.fsdp_param_layouts is None:
            return "tree"
        layouts = plan.fsdp_param_layouts
        scanned = tuple(getattr(module, "scanned_param_subtrees",
                                lambda: ())())
        reason = None
        if not scanned:
            reason = ("module declares no scanned param subtrees "
                      "(scanned_param_subtrees)")
        elif not isinstance(params, dict) \
                or any(k not in params for k in scanned):
            reason = (f"scanned keys {scanned} are not top-level keys "
                      f"of the param tree")
        else:
            for k in scanned:
                if any(collectives_lib.fsdp_shard_dim(x) == 0
                       for x in plan_lib._leaves(layouts[k])):
                    reason = (
                        f"gather_mode='scan': a leaf of scanned subtree "
                        f"{k!r} is fsdp-sharded on dim 0 (the stacked "
                        f"layer dim); the layer scan needs every device to "
                        f"hold ALL layers of its shard — shard a non-layer "
                        f"dim or use gather_mode='tree'")
                    break
        if reason is None and \
                mesh.shape.get(mesh_lib.SEQUENCE_AXIS, 1) > 1:
            reason = ("mesh has a sequence axis: the in-scan gather's "
                      "full-manual shard_map cannot nest the "
                      "ulysses/ring attention shard_map")
        if reason is None and not any(
                collectives_lib.fsdp_shard_dim(x) is not None
                for k in scanned for x in plan_lib._leaves(layouts[k])):
            reason = ("no scanned leaf is fsdp-sharded — nothing to "
                      "gather inside the scan")
        if reason is not None:
            if not quiet:
                log.warning("gather_mode='scan' falls back to 'tree': %s",
                            reason)
            return "tree"
        raise not_ported(
            "gather_mode='scan' in the compressed-FSDP regime (the "
            "per-layer all-gather inside the layer loop; the reference "
            "gives nothing to hold it to: the JAX GPT does not train under "
            "grad_compression on jax 0.9.0)", "multi-GPU 4e (scan-gather)")

    def _check_gather_mode(self, module: TorchModule) -> None:
        """The driver's resolution of ``gather_mode="scan"`` before the
        ranks start: the engaged case raises here, a fall-back warns here
        once (the ranks resolve quietly).  Only a compressed fit can
        engage it, so only that one builds the plan on the driver."""
        if self.gather_mode != "scan" or self._exchange_cfg.mode is None:
            return
        tx = module.configure_optimizers()
        if tx is None:
            tx = AdamW(1e-3, weight_decay=0.0)
        full = (_tree_map(torch.as_tensor, module.params)
                if module.params is not None
                else module.init_params(self.seed))
        mesh = self.accelerator.build_mesh()
        plan = self._build_plan(mesh, self.accelerator, module, full, tx,
                                report_fallbacks=False)
        self._resolve_gather_mode(module, full, plan, mesh)

    def _opt_accumulate(self) -> int:
        """The optimizer's accumulation: under compression the trainer
        accumulates (once a window), so the optimizer does not (the JAX
        package drops MultiSteps there)."""
        return (1 if self._exchange_cfg.mode is not None
                else self.accumulate_grad_batches)

    def _build_plan(self, mesh: mesh_lib.Mesh, accelerator: Accelerator,
                    module: TorchModule, full: Any, tx: Any,
                    report_fallbacks: bool = True
                    ) -> plan_lib.ShardingPlan:
        """The sharding plan of ``full`` (whole params) over ``mesh``."""
        opt_layouts = functools.partial(state_layouts, tx,
                                        accumulate=self._opt_accumulate(),
                                        ema=self.ema_decay is not None)
        return plan_lib.build_plan(
            mesh, accelerator, module, full, opt_layouts,
            grad_compression=self.grad_compression,
            shard_optimizer_state=self.shard_optimizer_state,
            accumulate=self.accumulate_grad_batches,
            report_fallbacks=report_fallbacks)

    def _put_batch(self, batch: Any) -> Any:
        """A host batch (numpy pytree) as tensors on the device (tensors
        already there pass through)."""
        return prefetch_lib.to_device(batch, self.device)

    # ---- the parts of a sharded state --------------------------------- #
    def _sharded_state(self) -> bool:
        return any(d is not None for d in getattr(self, "_owned_layouts",
                                                  ()) or ())

    def _owned_norm(self, owned: List[torch.Tensor]) -> torch.Tensor:
        """The global L2 norm of gradients held as owned parts: each
        rank's squares of its slices, plus the whole leaves once (rank 0),
        summed over the ranks.  Over the model axes the squares of each
        tensor- or expert-split leaf are summed over its groups and a
        replicated leaf counts once.  Without sharded parts, the plain
        norm."""
        if self._model_sharded:
            return self._model_norm(owned)
        if not self._sharded_state():
            return global_norm(owned)
        rank = self._exchange.rank
        sq = sum((g.float() * g.float()).sum()
                 for g, d in zip(owned, self._owned_layouts)
                 if d is not None or rank == 0)
        return torch.sqrt(self._exchange.sum_scalar(sq))

    def _model_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The global L2 norm of owned gradient parts split over the model
        axes: the squares summed per set of axes that split the leaf --
        its model axes (tensor, expert, pipeline) and, for a slice of the
        batch axes' split (fsdp), the batch group -- each sum all-reduced
        over those axes' groups, so a leaf no axis splits counts once."""
        by_axes: Dict[tuple, torch.Tensor] = {}
        for g, m, d in zip(grads, self._model_layouts, self._owned_layouts):
            key = tuple(a for a, _ in m or ()) + (
                ("batch",) if d is not None else ())
            sq = (g.float() * g.float()).sum()
            by_axes[key] = by_axes[key] + sq if key in by_axes else sq
        total = torch.zeros((), device=self.device)
        for axes, sq in by_axes.items():
            # the leaf's layout axes from the plan, plus the batch group
            # graftlint: ok(spmd-collective) — mesh-declared by construction
            total = total + collectives_lib.all_reduce_value(
                sq, [self._rank_mesh.group(a) for a in axes])
        return torch.sqrt(total)

    def _gather_model(self, t: torch.Tensor, model: Any) -> torch.Tensor:
        """A whole leaf from this rank's model-axes part (exact, over the
        axes' groups; a collective of those groups)."""
        for axis, dim in model or ():
            t = collectives_lib.all_gather_dim(
                t, dim, self._rank_mesh.group(axis), kind="param_gather")
        return t

    def _gather_owned(self, owned: List[torch.Tensor],
                      layouts: List[Any]) -> List[torch.Tensor]:
        """Whole leaves from owned parts (exact, in their dtype; a
        collective: every rank calls it)."""
        idx = [i for i, d in enumerate(layouts) if d is not None]
        if not idx:
            return list(owned)
        fulls = self._exchange.gather_params(
            [(owned[i].detach(), layouts[i]) for i in idx])
        out = list(owned)
        for i, f in zip(idx, fulls):
            out[i] = f
        return out

    def _full_params(self, state: TrainState) -> Any:
        """The whole parameter tree (exact f32, gathered over the batch
        and the model axes; ``state.params`` itself when nothing is
        sharded)."""
        if not any(d is not None for d in self._param_layouts) \
                and not self._model_sharded:
            return state.params
        leaves = self._gather_owned(tree_leaves(state.params),
                                    self._param_layouts)
        leaves = [self._gather_model(t, m)
                  for t, m in zip(leaves, self._model_layouts)]
        return tree_like(state.params, leaves)

    def _view_params(self, state: TrainState) -> Any:
        """The parameters a rank evaluates on: its model-axes parts, each
        gathered whole over the batch axes."""
        if not self._model_sharded:
            return self._full_params(state)
        return tree_like(state.params, self._gather_owned(
            tree_leaves(state.params), self._param_layouts))

    def _compute_leaves(self, state: TrainState) -> List[torch.Tensor]:
        """The leaves the step differentiates: the masters, or under FSDP
        the all-gathered slices (f32, exact; bf16 on the wire under
        compression, as the JAX package's compressed FSDP)."""
        masters = tree_leaves(state.params)
        if not self._fsdp:
            return masters
        idx = [i for i, d in enumerate(self._param_layouts) if d is not None]
        wire = (collectives_lib.PARAM_GATHER_DTYPE
                if self._exchange_cfg.mode is not None else None)
        with self._exchange.span("param_gather"):
            fulls = self._exchange.gather_params(
                [(masters[i].detach(), self._param_layouts[i]) for i in idx],
                wire_dtype=wire)
        out = list(masters)
        for i, f in zip(idx, fulls):
            out[i] = f.requires_grad_(True)
        return out

    def _train_step(self, state: TrainState, batch: Any
                    ) -> Dict[str, torch.Tensor]:
        module = self.module
        sched = module.lr_schedule
        # accumulation advances the schedule once per window: index it by
        # optimizer updates, not micro-steps
        lr_now = (float(sched(state.step // self.accumulate_grad_batches))
                  if callable(sched) else None)
        params = tree_leaves(state.params)
        compute = self._compute_leaves(state)
        out = module.training_step(
            tree_like(state.params, compute), batch,
            state.step_generator(self.device, self._dropout_key()))
        loss, metrics = (out if isinstance(out, tuple) else (out, {}))
        metrics = dict(metrics)
        metrics.setdefault("train_loss", loss)
        grads = torch.autograd.grad(loss, compute, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(compute, grads)]
        names = [k for k, v in metrics.items()
                 if isinstance(v, torch.Tensor) and v.numel() == 1]
        if self._exchange_cfg.mode is not None:
            self._compressed_update(state, grads, metrics, names)
        else:
            self._exact_update(state, params, grads, metrics, names)
        state.step += 1
        metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
                   for k, v in metrics.items()}
        if lr_now is not None:
            metrics["lr"] = lr_now
        return metrics

    def _exact_update(self, state: TrainState, params: List[torch.Tensor],
                      grads: List[torch.Tensor], metrics: Dict[str, Any],
                      names: List[str]) -> None:
        """The f32 mean over the ranks, then the update: replicated
        gradients and the scalar metrics ride one all-reduce bucket; under
        FSDP the sharded leaves' gradients are reduce-scattered into their
        owners.  ZeRO-1 updates the owned dim-0 slices, then gathers."""
        ex = self._exchange
        layouts = self._param_layouts
        seq_group = self._rank_mesh.group(mesh_lib.SEQUENCE_AXIS)
        if seq_group is not None:
            # each rank's gradients are partial over its chunk of the
            # sequence: summed over the sequence group first
            with ex.span("seq_sum"):
                grads = self._group_sum(grads, seq_group)
        ep = self._rank_mesh.group(mesh_lib.EXPERT_AXIS)
        if ep is not None:
            # the expert ranks compute the replicated leaves' gradients
            # apart, and the card's atomics (the embedding's backward,
            # K4's dq) can round them apart in the last bits: their mean
            # keeps the replicas equal bit for bit
            rep_e = [i for i, m in enumerate(self._model_layouts)
                     if sharding_lib.layout_dim(
                         m, mesh_lib.EXPERT_AXIS) is None]
            with ex.span("expert_mean"):
                summed = self._group_sum([grads[i] for i in rep_e], ep)
            n_ep = self._rank_mesh.size(mesh_lib.EXPERT_AXIS)
            grads = list(grads)
            for i, g in zip(rep_e, summed):
                grads[i] = collectives_lib._div(g, n_ep)
        pp = self._rank_mesh.group(mesh_lib.PIPELINE_AXIS)
        rep_p = [i for i, m in enumerate(self._model_layouts)
                 if sharding_lib.layout_dim(m, mesh_lib.PIPELINE_AXIS)
                 is None] if pp is not None else []
        if rep_p:
            # the GPT's schedule leaves on each stage a part of a
            # pipeline-replicated leaf's gradient (the embedding lookup's
            # on the first stage, the final norm's and the head's on the
            # last, zeros elsewhere: ``GPT.forward``): their sum is the one
            # gradient of the one loss.  A module without a schedule ran
            # its whole forward on every stage, on the same rows, so each
            # stage holds the whole gradient (of a layer-stack leaf, its
            # slice: ``collectives.gather_whole``): their mean keeps the
            # replicas equal bit for bit where the card's atomics round
            # the stages' copies apart
            schedule = getattr(self.module, "runs_pipeline_schedule", False)
            with ex.span("pipeline_sum" if schedule else "pipeline_mean"):
                summed = self._group_sum([grads[i] for i in rep_p], pp)
            n_pp = 1 if schedule else self._rank_mesh.size(
                mesh_lib.PIPELINE_AXIS)
            grads = list(grads)
            for i, g in zip(rep_p, summed):
                grads[i] = g if n_pp == 1 else collectives_lib._div(g, n_pp)
        if ex is not None:
            # the mean over the ranks, before clipping and the logged
            # norm; the step's scalar metrics ride the same bucket
            rep = [i for i, d in enumerate(layouts) if d is None]
            shd = [i for i, d in enumerate(layouts) if d is not None]
            with ex.span("exchange"):
                reduced = ex.mean([grads[i] for i in rep]
                                  + [metrics[k] for k in names])
                mean = list(grads)
                for i, g in zip(rep, reduced):
                    mean[i] = g
                if shd:
                    for i, g in zip(shd, ex.reduce_scatter_mean(
                            [(grads[i], layouts[i]) for i in shd])):
                        mean[i] = g
            grads = mean
            metrics.update(zip(names, reduced[len(rep):]))
        grads = self._apply_chaos(state, metrics, grads, local=False)
        if self.log_grad_norm:
            metrics["grad_norm"] = (
                self._owned_norm(grads)
                if self._fsdp or self._model_sharded
                else global_norm(grads))
        probe = {} if self.guard is not None else None
        self._apply(state, params, grads, probe)
        if probe is not None:
            self._guard_tail(state, metrics, probe, grads=grads)

    # ---- the numeric guardian's step half ----------------------------- #
    def _guard_norms(self, parts: List[tuple]) -> torch.Tensor:
        """``[len(parts)]`` global L2 norms, one of each part: a list of
        per-leaf squared norms with the layouts of the parts they were
        taken of (leaves in param order).  The squares are summed per set
        of axes that split the leaf, as ``_model_norm`` does, and each sum
        is all-reduced over those axes' groups once for every part
        together (no collective where nothing is split)."""
        by_axes: Dict[tuple, List[list]] = {}
        for j, (sqs, layouts) in enumerate(parts):
            for sq, m, d in zip(sqs, self._model_layouts, layouts):
                key = tuple(a for a, _ in m or ()) + (
                    ("batch",) if d is not None else ())
                by_axes.setdefault(key, [[] for _ in parts])[j].append(sq)
        total = None
        for axes, cols in by_axes.items():
            # every part's squares in one vector, summed part by part
            flat = torch.stack([sq for c in cols for sq in c])
            ends = list(itertools.accumulate(len(c) for c in cols))
            vec = torch.stack([flat[a:b].sum() for a, b in
                               zip([0] + ends[:-1], ends)])
            groups = collectives_lib._groups(
                [self._rank_mesh.group(a) for a in axes])
            if groups:
                vec = collectives_lib._all_reduce(vec, groups, "guard_norm")
            total = vec if total is None else total + vec
        if total is None:
            return torch.zeros(len(parts), dtype=torch.float32,
                               device=self.device)
        return torch.sqrt(total)

    @staticmethod
    def _sq_norms(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each tensor's squared L2 norm, in f32."""
        if not tensors:
            return []
        with torch.no_grad():
            norms = torch._foreach_norm(tensors, 2, torch.float32)
            return list(torch._foreach_mul(norms, norms))

    def _guard_tail(self, state: TrainState, metrics: Dict[str, Any],
                    probe: Dict[str, Any], grads=None, gnorm=None,
                    rank_bad=None) -> None:
        """Fold this step's health into ``state.guard_ema`` and put the
        guard row in ``metrics["guard"]`` (JAX ``_guard_tail``): the
        reduced loss, the global gradient norm (the logged one, or the
        norm of ``grads``), the update / parameter norm ratio from the
        optimizer's update (``probe``: the owned parts' norms before it
        and of what it moved; 0 when the step updated nothing) and, under
        the compressed exchange, the ranks' badness.  On the device: no
        host read."""
        owned = self._owned_layouts
        deltas = probe.get("delta") or []
        parts = [(probe.get("old_sq", []), owned),
                 (list(torch._foreach_mul(deltas, deltas)) if deltas
                  else [], owned)]
        if gnorm is None:
            gnorm = metrics.get("grad_norm")
        if gnorm is None:
            parts.append((self._sq_norms(grads), self._param_layouts))
        norms = self._guard_norms(parts)
        ratio = norms[1] / (norms[0] + 1e-12)
        if gnorm is None:
            gnorm = norms[2]
        loss = metrics.get("train_loss", 0.0)
        state.guard_ema, metrics["guard"] = guardian_lib.update(
            self.guard, state.guard_ema, state.step, loss, gnorm, ratio,
            rank_bad)

    def _guard_ranks(self, grads: List[torch.Tensor]):
        """Under the compressed exchange: every rank's local gradient
        health gathered over the batch group (one small gather), as
        ``(rank_bad, gnorm)``: the per-rank badness vector and the RMS
        over the ranks of the local norms (NaN when any rank's gradient
        is not finite)."""
        stats = guardian_lib.local_stats(grads)
        group = self._rank_mesh.group("batch")
        every = (collectives_lib._gather_stack(stats, group, "guard_gather")
                 if group is not None else stats[None])
        rank_bad = guardian_lib.replica_bad(every, self.guard.spike_factor)
        gnorm = torch.where(every[:, 1].min() > 0,
                            torch.sqrt(every[:, 0].mean()),
                            torch.full_like(every[0, 0], float("nan")))
        return rank_bad, gnorm

    @staticmethod
    def _group_sum(grads: List[torch.Tensor], group: Any
                   ) -> List[torch.Tensor]:
        """The gradients summed over ``group`` in one f32 bucket."""
        bucket = torch.cat([g.detach().reshape(-1).to(torch.float32)
                            for g in grads])
        bucket = collectives_lib.all_reduce_value(bucket, group)
        out, offset = [], 0
        for g in grads:
            out.append(bucket[offset:offset + g.numel()].view(g.shape)
                       .to(g.dtype))
            offset += g.numel()
        return out

    def _dropout_key(self) -> int:
        """The dropout generator's key: this rank's (batch, sequence)
        coordinates, never its tensor or expert one, so the ranks that
        hold one activation replicated draw one mask."""
        m = self._rank_mesh
        return (m.batch_rank * m.size(mesh_lib.SEQUENCE_AXIS)
                + m.coord(mesh_lib.SEQUENCE_AXIS))

    def _apply(self, state: TrainState, params: List[torch.Tensor],
               grads: List[torch.Tensor],
               probe: Optional[Dict[str, Any]] = None) -> None:
        """The optimizer step on the owned parts.  ZeRO-1: the clip's norm
        from the whole gradients (each rank holds them), the update of the
        owned slices, then the slices all-gathered into the params.  With
        a ``probe`` (the guard on) it gets the owned parts' squared norms
        before the step (``old_sq``) and the norms of what the update
        moved (``delta``)."""
        opt = state.opt
        deltas = None
        if probe is not None:
            # the squared norms of the parameters before the update
            probe["old_sq"] = self._sq_norms(opt.params)
            deltas = probe["delta"] = []
        if self._zero1 is None:
            opt.step(grads, delta_norms=deltas)
            return
        n, rank = self._rank_mesh.batch_size, self._rank_mesh.batch_rank
        norm = (global_norm(grads) if opt.clip_norm
                and opt.accumulate == 1 else None)
        owned = [_slice(g, z, rank, n) if z is not None else g
                 for g, z in zip(grads, self._zero1)]
        if opt.step(owned, norm=norm, delta_norms=deltas):
            idx = [i for i, z in enumerate(self._zero1) if z is not None]
            with self._exchange.span("zero1_gather"):
                self._exchange.gather_zero1([params[i] for i in idx],
                                            [opt.params[i] for i in idx])

    def _compressed_update(self, state: TrainState,
                           grads: List[torch.Tensor],
                           metrics: Dict[str, Any],
                           names: List[str]) -> None:
        """``grad_compression``: the metrics' mean (and the RMS over the
        ranks of the local gradient norm) in one exact all-reduce; the
        gradients quantized through the exchange with error feedback.
        Plain data parallelism accumulates the local gradients and
        exchanges their window mean once, on the window's last step;
        FSDP exchanges every step and accumulates the owned slices.  The
        guard gathers each rank's local gradient health first."""
        grads = self._apply_chaos(state, metrics, grads, local=True)
        if self.guard is None:
            self._compressed_apply(state, grads, metrics, names, None)
            return
        rank_bad, gnorm = self._guard_ranks(grads)
        probe: Dict[str, Any] = {}
        self._compressed_apply(state, grads, metrics, names, probe)
        self._guard_tail(state, metrics, probe,
                         gnorm=metrics.get("grad_norm", gnorm),
                         rank_bad=rank_bad)

    def _compressed_apply(self, state: TrainState,
                          grads: List[torch.Tensor],
                          metrics: Dict[str, Any], names: List[str],
                          probe: Optional[Dict[str, Any]]) -> None:
        ex = self._exchange
        cfg = self._exchange_cfg
        k = self.accumulate_grad_batches
        vals = [metrics[k_] for k_ in names]
        if self.log_grad_norm:
            vals.append(sum((g.float() * g.float()).sum() for g in grads))
        with ex.span("metrics_mean"):
            reduced = ex.mean(vals)
        metrics.update(zip(names, reduced[:len(names)]))
        if self.log_grad_norm:
            metrics["grad_norm"] = torch.sqrt(reduced[-1])
        residual = tree_leaves(state.residual)
        params = tree_leaves(state.params)
        boundary = (state.step % k) == (k - 1)
        if not self._fsdp:
            if k > 1:
                acc = tree_leaves(state.grad_accum)
                with torch.no_grad():
                    for a, g in zip(acc, grads):
                        a.add_(g.float())
                if not boundary:
                    return
                # the applied gradient is the window's mean
                grads = [collectives_lib._div(a, k) for a in acc]
            with ex.span("exchange"):
                exchanged, new_res = self._exchange_leaves(grads, residual)
        else:
            with ex.span("exchange"):
                exchanged, new_res = self._exchange_leaves(grads, residual)
            if k > 1:
                acc = tree_leaves(state.grad_accum)
                with torch.no_grad():
                    for a, g in zip(acc, exchanged):
                        a.add_(g.float())
                if not boundary:
                    self._set_residual(state, new_res)
                    return
                exchanged = [collectives_lib._div(a, k).to(p.dtype)
                             for a, p in zip(acc, params)]
        self._set_residual(state, new_res)
        if k > 1:
            for a in tree_leaves(state.grad_accum):
                a.zero_()
        self._apply(state, params, exchanged, probe)

    def _exchange_leaves(self, grads: List[torch.Tensor],
                         residual: List[torch.Tensor]):
        """Each leaf's mean through its regime (``_leaf_regime``): the
        quantized reduce-scatter into the owner for a sharded large leaf,
        the two-phase exchange for a replicated large one, the exact mean
        (one bucket; sliced to the owner when sharded) for the rest."""
        ex = self._exchange
        cfg = self._exchange_cfg
        layouts = self._param_layouts
        out = list(grads)
        new_res = list(residual)
        exact_rep, exact_shd = [], []
        for i, (g, d) in enumerate(zip(grads, layouts)):
            regime = collectives_lib._leaf_regime(g, d, cfg)
            if regime == "rs":
                out[i], new_res[i] = ex.exchange_rs_leaf(g, residual[i], d,
                                                         cfg)
            elif regime == "allreduce":
                out[i], new_res[i] = ex.exchange_leaf(g, residual[i], cfg)
            elif d is None:
                exact_rep.append(i)
            else:
                exact_shd.append(i)
        if exact_rep:
            for i, g in zip(exact_rep, ex.mean([grads[i]
                                                for i in exact_rep])):
                out[i] = g
        if exact_shd:
            for i, g in zip(exact_shd, ex.reduce_scatter_mean(
                    [(grads[i], layouts[i]) for i in exact_shd])):
                out[i] = g
        return out, new_res

    @staticmethod
    def _set_residual(state: TrainState, new_res: List[torch.Tensor]
                      ) -> None:
        with torch.no_grad():
            for r, nr in zip(tree_leaves(state.residual), new_res):
                if r is not nr:
                    r.copy_(nr)

    # ------------------------------------------------------------------ #
    # fit                                                                #
    # ------------------------------------------------------------------ #
    def fit(self, module: TorchModule, train_dataloaders=None,
            val_dataloaders=None, datamodule=None,
            ckpt_path: Optional[str] = None) -> None:
        try:
            # bound before anything can raise: a failure is reported
            # under this run's trace, not the previous fit's
            self._bind_trace()
            if self.pipeline_stages > 1:
                return self._fit_mpmd(module, train_dataloaders,
                                      datamodule, ckpt_path)
            plan = self._launch_plan()
            if plan is not None:
                return self._fit_via_launcher(plan, module,
                                              train_dataloaders,
                                              val_dataloaders, datamodule,
                                              ckpt_path)
            return self._fit_local(module, train_dataloaders,
                                   val_dataloaders, datamodule, ckpt_path)
        except BaseException as e:
            # the postmortem: run_report.json under default_root_dir (the
            # driver only; a report already written is not written again)
            self._write_failure_report(e)
            raise

    def _bind_trace(self) -> None:
        """One fit, one trace id.  In a rank the driver's id (stamped
        from the shipped trainer) stays ambient; the driver mints a fresh
        one and makes it ambient for everything it emits meanwhile."""
        if _in_world():
            self.trace_id = (recorder.current_trace_id() or self.trace_id
                             or recorder.mint_trace_id())
        else:
            self.trace_id = recorder.mint_trace_id()
            # one run, one registry: an earlier fan-out's rank telemetry
            # does not belong under the fresh id
            self._rank_telemetry = {}
        recorder.set_trace_id(self.trace_id)

    def _write_failure_report(self, exc: BaseException) -> None:
        """``run_report.json`` under ``default_root_dir`` for a failed
        entry point: the typed error, every rank's spilled tail, the
        stall diagnosis and the metrics registry.  The driver only (a
        rank's failure reaches it typed over the pipe); never raises
        over the real exception, and writes each failure once."""
        if _in_world() or getattr(exc, "_rla_report_written", False):
            return
        try:
            from ..telemetry import registry as treg
            extra: Dict[str, Any] = {"global_step": self.global_step,
                                     "epoch": self.current_epoch}
            if self._cluster_view is not None:
                # the last live view before the death: each rank's
                # health, step and serve rows, which no spill carries
                try:
                    extra["cluster_view"] = self._cluster_view.last_view()
                except Exception:
                    pass
            treg.write_run_report(
                os.path.join(self.default_root_dir, "run_report.json"),
                error=exc, trace_id=self.trace_id,
                rank_events=treg.gather_spill_dir(),
                stall_diagnosis=self.last_stall_diagnosis,
                registry=self.build_metrics_registry(),
                extra=extra)
            try:
                exc._rla_report_written = True
            except Exception:
                pass   # a __slots__ exception: worst case a second write
        except Exception as e:
            log.warning("failed to write fit run report: %s", e)

    def build_metrics_registry(self) -> Any:
        """This run's :class:`~..telemetry.registry.MetricsRegistry`:
        the driver's profiler (or the wire record alone without one),
        every rank's shipped profiler export and event tail, this
        process's events, the compile count, the perf observatory's
        ledgers and the ClusterView's ranks (their status rows always,
        their profilers and events only where none shipped home).  Serve
        metrics join by ``registry.add_serve(...)``."""
        from ..telemetry.registry import MetricsRegistry
        reg = MetricsRegistry(trace_id=self.trace_id)
        if self.profiler is not None:
            reg.add_profiler(self.profiler, rank="driver")
        elif self.comms_per_step:
            # the analytic wire record belongs in the export regardless
            p = Profiler()
            p.record_comms(self.comms_per_step)
            reg.add_profiler(p, rank="driver")
        for rank, snap in self._rank_telemetry.items():
            if not snap:
                continue
            if snap.get("profiler"):
                reg.add_profiler(snap["profiler"], rank=rank)
            if snap.get("events"):
                reg.add_events(snap["events"], rank=rank)
        reg.add_events(recorder.get_recorder().events(), rank="driver")
        reg.add_compile_count(rank="driver")
        if self.perf is not None:
            self.perf.register(reg)
        if self._cluster_view is not None:
            try:
                self._cluster_view.merge_into(
                    reg, skip_mergeables=[
                        k for k, v in self._rank_telemetry.items() if v])
            except Exception as e:
                log.warning("cluster-view merge failed: %s", e)
        return reg

    def _fit_local(self, module: TorchModule, train_dataloaders=None,
                   val_dataloaders=None, datamodule=None,
                   ckpt_path: Optional[str] = None) -> None:
        if datamodule is not None:
            datamodule.setup("fit")
            train_dataloaders = (train_dataloaders
                                 or datamodule.train_dataloader())
            val_dataloaders = val_dataloaders or datamodule.val_dataloader()
        if train_dataloaders is None:
            raise ValueError("fit() needs train_dataloaders or a datamodule")
        live = ckpt_path == "live"
        if live and self._state is None:
            raise ValueError(
                "ckpt_path='live' continues from in-memory state; call "
                "fit() (and optionally resize_in_memory()) first")
        t0 = time.perf_counter()
        self.fitting = True
        self.should_stop = False
        if live:
            # the counters go on, and like a checkpoint restore the fit
            # re-enters the epoch that was cut short: only completed
            # epochs count, so the sampler replays its permutation
            self.current_epoch = self.epochs_completed
        else:
            self.current_epoch = 0
            self.epochs_completed = 0
            self.global_step = 0
        self._last_val_step = -1
        self._bind(module)
        if self.int8_matmul:
            module.int8_matmul = True
        train_loader = train_dataloaders
        self._val_loader = val_dataloaders
        self._exchange = None
        MODEL_COMMS.reset()
        self._enter_mesh(module)
        if _in_world():
            # this rank's rows of every global batch; the gradient mean
            train_loader = self._rank_source(
                train_loader, getattr(train_loader, "shuffle", False))
            self._val_loader = self._rank_source(self._val_loader, False)
        if _in_world() or self._exchange_cfg.mode is not None:
            self._exchange = GradExchange(self.device, self._rank_mesh)
        self.train_dataloader = train_loader

        if live:
            # the live state (a prior fit's, perhaps resized): no fresh
            # state, no checkpoint read
            state = self._state
            state.opt.norm_fn = self._owned_norm
        else:
            state = self._build_state(module)
        self._state = state
        self._bind_preemption()
        self._bind_chaos()
        # the guardian's host half; rank 0 alone writes the ledger
        self._guardian = (guardian_lib.Guardian(
            self.guard, self.default_root_dir,
            writer=self.global_rank == 0) if self.guard is not None
            else None)
        # the live plane: this process's server starts once (a rank's
        # started at boot) and this fit's trainer becomes its source, so
        # /metrics shows the run's registry while it steps
        self._live_server = live_lib.maybe_start_from_env()
        if self._live_server is not None:
            self._live_server.sources.bind_trainer(self)
        recorder.emit("fit_start", step=self.global_step,
                      processes=world_and_rank()[0])
        for c in self.callbacks:
            c.setup(self, module, "fit")
        if ckpt_path == "last":
            ckpt_path = ckpt_lib.latest_checkpoint(self.default_root_dir)
            if ckpt_path is None:
                log.warning("ckpt_path='last': no checkpoint under %s; "
                            "starting fresh", self.default_root_dir)
        if ckpt_path is not None and not live:
            with self._perf_phase("ckpt"):   # a restore is a phase
                state = self._restore(ckpt_path, state)
        for c in self.callbacks:
            c.on_fit_start(self, module)
        if self.num_sanity_val_steps and self._val_loader is not None:
            self.sanity_checking = True
            self._run_eval(self._val_loader, module.validation_step,
                           state.params, limit=self.num_sanity_val_steps)
            self.sanity_checking = False

        self._build_device_cache(train_loader)
        if self.perf is not None:
            self._register_hbm_pools()
        train_metrics: Dict[str, Any] = {}
        use_scan = self._can_scan_epoch()
        while not self._done():
            for c in self.callbacks:
                c.on_train_epoch_start(self, module)
            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(self.current_epoch)
            if use_scan:
                train_metrics, complete = self._run_scanned_epoch(
                    state, train_loader)
                if complete:
                    self.epochs_completed = self.current_epoch + 1
                self._after_train_epoch(module, train_metrics)
                # the whole-epoch path drains at epoch boundaries
                self._maybe_drain_preemption(every_step=True)
                continue
            train_metrics = self._run_epoch(module, state, train_loader, t0)
            if (self.limit_train_batches is not None
                    and not self.should_stop):
                self.epochs_completed = self.current_epoch + 1
            self._after_train_epoch(module, train_metrics)

        module.params = _tree_map(lambda t: t.detach(),
                                  self._full_params(state))
        for c in self.callbacks:
            c.on_fit_end(self, module)
        if self.checkpoint_format == "sharded-async":
            with self._perf_phase("ckpt"):   # the checkpoint fence
                sharded_lib.wait_until_finished()   # in-flight saves
        if self._guardian is not None:
            # the fit ran clean to its end: newer verified checkpoints
            # cover the quarantined window, so the rewind anchor's prune
            # protection goes (the skip entries stay: the data is bad)
            self._guardian.release_anchor()
        self.fitting = False
        if isinstance(self.logger, CSVLogger):
            self.logger.finalize()
        self.fit_duration_s = time.perf_counter() - t0
        recorder.emit("fit_end", step=self.global_step,
                      epochs=self.epochs_completed,
                      duration_s=round(self.fit_duration_s, 3))

    def _register_hbm_pools(self) -> None:
        """Bind the observatory's HBM ledger to this fit: readers over the
        live state (params, optimizer state, exchange buffers) and the
        device dataset cache, the fit's device as the ground truth, and
        one eager sample of the post-placement watermark.  A reader of
        released state reads 0; a later fit re-binds them."""
        hbm = self.perf.hbm
        tree_nbytes = perf_lib.tree_nbytes

        def field_bytes(*fields):
            def read():
                st = self._state
                if st is None:
                    return 0
                return sum(tree_nbytes(getattr(st, f, None))
                           for f in fields)
            return read

        hbm.register_pool("params", field_bytes("params"))
        hbm.register_pool(
            "opt_state", lambda: tree_nbytes(self._state.opt.state)
            if self._state is not None else 0)
        hbm.register_pool("exchange_buffers",
                          field_bytes("residual", "grad_accum"))
        hbm.register_pool("device_cache",
                          lambda: tree_nbytes(self._device_cache))
        device = self.device
        hbm.set_total_fn(lambda: perf_lib.placed_bytes_total(
            device, pools_total=hbm.pools_total))
        hbm.sample()

    def _out_of_time(self, t0: float) -> bool:
        late = time.perf_counter() - t0 >= self.max_time
        # ranks must stop at the same step, or the others hang in the
        # next step's all-reduce
        return any_across_ranks(late, self.device) \
            if self.world_size > 1 else late

    def _enter_mesh(self, module: TorchModule) -> None:
        """Inside a world: this rank's ``RankMesh`` (its coordinates and
        the axes' groups, made once per world) for the accelerator's
        mesh, handed to the module as ``module.mesh``; a sequence axis
        first passes ``_apply_seq_parallel``."""
        if not _in_world():
            self._rank_mesh = mesh_lib.local_mesh()
            return
        # without an accelerator the world is data parallel; a hybrid
        # mesh's layout (order) places each rank
        mesh = (self.accelerator.build_mesh() if self.accelerator
                is not None else mesh_lib.build_mesh(
                    mesh_lib.MeshConfig(), world_and_rank()[0]))
        seq = mesh.shape.get(mesh_lib.SEQUENCE_AXIS, 1)
        if seq > 1:
            self._apply_seq_parallel(module, seq)
        self._rank_mesh = mesh_lib.build_rank_mesh(mesh.shape, mesh.order)
        module.mesh = self._rank_mesh

    def _rank_source(self, loader, shuffle: bool):
        """This rank's rows of each global batch: a ``DataLoader`` gets
        its sampler shard (``_inject_sampler``, which leaves a sampler the
        caller set alone); any other iterable of global batches is cut to
        the same rows, ``rank::world``.  The batch is split over the
        batch axes only: ranks that differ in a model coordinate read the
        same rows."""
        if loader is None:
            return None
        n, rank = self._rank_mesh.batch_size, self._rank_mesh.batch_rank
        if isinstance(loader, DataLoader):
            loader._inject_sampler(n, rank, shuffle=shuffle)
            return loader
        return _RankRows(loader, n, rank)

    def _run_epoch(self, module: TorchModule, state: TrainState,
                   train_loader, t0: float) -> Dict[str, Any]:
        """One epoch of the step loop (JAX ``_fit_local``'s): the source
        (cached index rows, or the loader's host batches), the
        quarantine's skip seam, the prefetch pipeline bounded at
        ``limit_train_batches``, closed on every way out.  Returns the
        last step's metrics."""
        if self._device_cache is not None:
            source = self._cached_epoch_source(train_loader)
        elif self.prefetch_batches:
            # the pipeline times the fetch on its own thread
            source = (("host", b) for b in train_loader)
        else:
            source = (("host", b)
                      for b in self._iter_profiled(train_loader))
        # quarantined batch indices become ("skip", None) items: a pure
        # function of the ledger, the same on every rank and restart;
        # badbatch chaos poisons the host batch of its global step
        skip = (self._guardian.skip_set(self.current_epoch)
                if self._guardian is not None else set())
        badbatch = tuple(f for f in self._chaos_numeric
                         if f.kind == "badbatch")
        if skip or badbatch:
            source = self._wrap_fit_source(source, skip, badbatch,
                                           self.global_step)
        if self.limit_train_batches is not None:
            # the producer never pulls (or places) past the limit
            source = itertools.islice(source, self.limit_train_batches)
        pf = None
        if self.prefetch_batches and self._device_cache is None:
            # (the cached rows are on the device already: nothing to
            # place ahead)
            pf = prefetch_lib.prefetch_pipeline(
                source, self.prefetch_batches, self._place_train_item,
                device=self.device, name="rla-prefetch-fit",
                host_thread=not _engine_fed(train_loader),
                profiler=self.profiler)
            source = pf
            if self.perf is not None:
                # the placed batches in flight are device bytes too (the
                # pipeline is rebuilt each epoch; a closed one reads 0)
                self.perf.hbm.register_pool("prefetch", pf.placed_bytes)
        train_metrics: Dict[str, Any] = {}
        try:
            for batch_idx, (kind, payload) in enumerate(source):
                if kind == "skip":
                    # the batch never runs and global_step stays; batch_idx
                    # keeps counting, so the epoch's enumeration is the
                    # clean run's
                    continue
                train_metrics = self._fit_step(state, kind, payload,
                                               batch_idx, placed=pf
                                               is not None)
                if (self.val_check_interval and self._val_loader is not None
                        and self.global_step % self.val_check_interval == 0):
                    self._guard_flush(train_metrics)
                    self._validation_pass(module)
                    self._last_val_step = self.global_step
                # the step-boundary drain poll (nothing without a grace
                # budget)
                self._maybe_drain_preemption()
                if self.max_steps and self.global_step >= self.max_steps:
                    self.should_stop = True
                    break
                if self.max_time is not None and self._out_of_time(t0):
                    self.should_stop = True
                    break
            else:
                # the epoch ran to the end of its loader (a max_steps break
                # leaves it incomplete for checkpoint accounting)
                self.epochs_completed = self.current_epoch + 1
        finally:
            # every way out (limits, max_steps, max_time, a guard trip, an
            # exception) stops and joins the producer thread
            if pf is not None:
                pf.close()
        return train_metrics

    def _place_train_item(self, item):
        """Place one fit-source item (on the consumer thread, in stream
        order, on the pipeline's stream): host batches from pinned
        memory; index rows and skips pass through."""
        kind, payload = item
        if kind == "host":
            payload = prefetch_lib.to_device(payload, self.device, pin=True)
        return kind, payload

    def _fit_step(self, state: TrainState, kind: str, payload: Any,
                  batch_idx: int, placed: bool = False
                  ) -> Dict[str, torch.Tensor]:
        """One optimizer step: note the batch for the guardian, place the
        batch (unless the pipeline did) or gather a cached one, run the
        step, fire the per-batch callbacks, read the metrics back on the
        log cadence (the guard row on every rank) and log on rank 0.
        The observatory's step bracket and its throttled HBM sample are
        host scalars only."""
        tl = self.perf.timeline if self.perf is not None else None
        if tl is not None:
            tl.step_begin()
        try:
            if kind == "cached":
                with self._span("train_step", phase="compute") as h:
                    metrics = self._step_cached(state, payload, batch_idx)
                    if h is not None:
                        h.set(metrics)
            else:
                if placed:
                    batch = payload
                else:
                    with self._span("h2d", phase="h2d"):
                        batch = self._put_batch(payload)
                if self._guardian is not None:
                    # references only: what the step about to run consumes
                    self._guardian.note_step(self.global_step,
                                             self.current_epoch, batch_idx,
                                             "host", batch)
                with self._span("train_step", phase="compute") as h:
                    metrics = self._train_step(state, batch)
                    if h is not None:
                        h.set(metrics)
            self.global_step += 1
            recorder.emit("train_step", step=self.global_step,
                          batch=batch_idx, epoch=self.current_epoch)
            for c in self.callbacks:
                c.on_train_batch_end(self, self.module, metrics, batch_idx)
            if self.global_step % self.log_every_n_steps == 0:
                self._guard_flush(metrics)
                if self.global_rank == 0:
                    self._log_now({k: float(v) for k, v in metrics.items()
                                   if k != "guard"})
            return metrics
        finally:
            if tl is not None:
                tl.step_end()
            if self.perf is not None:
                self.perf.hbm.maybe_sample()

    def _span(self, name: str, phase: Optional[str] = None):
        """A profiler span, or a null context without a profiler;
        ``phase`` also feeds the observatory's step timeline (one more
        perf_counter pair)."""
        tl = self.perf.timeline if self.perf is not None else None
        if tl is None or phase is None:
            if self.profiler is not None:
                return self.profiler.span(name)
            return contextlib.nullcontext()
        return self._phased_span(name, tl, phase)

    @contextlib.contextmanager
    def _phased_span(self, name: str, tl, phase: str):
        t0 = time.perf_counter()
        try:
            if self.profiler is not None:
                with self.profiler.span(name) as h:
                    yield h
            else:
                yield None
        finally:
            tl.observe(phase, time.perf_counter() - t0)

    def _perf_phase(self, phase: str):
        """A timeline-only phase (checkpoint saves and restores, the
        preemption drain); nothing without an observatory."""
        if self.perf is not None:
            return self.perf.timeline.phase(phase)
        return contextlib.nullcontext()

    def _iter_profiled(self, loader):
        """Iterate a loader, each fetch timed under a ``data_fetch``
        span."""
        if self.profiler is None:
            yield from loader
            return
        it = iter(loader)
        while True:
            with self.profiler.span("data_fetch"):
                try:
                    batch = next(it)
                except StopIteration:
                    return
            yield batch

    def _step_cached(self, state: TrainState, idx: torch.Tensor,
                     batch_idx: int) -> Dict[str, torch.Tensor]:
        """The step loop's cached step: this rank's rows gathered on the
        device (``idx`` is its index row), noted for the guardian, then
        the step."""
        batch = self._gather_cached(idx)
        if self._guardian is not None:
            self._guardian.note_step(self.global_step, self.current_epoch,
                                     batch_idx, "host", batch)
        return self._train_step(state, batch)

    # ---- numeric chaos (testing/chaos.py) ---------------------------- #
    def _bind_chaos(self) -> None:
        """Parse this fit's numeric faults and claim the step faults
        (``nanloss``, ``gradspike``, ``bitflip``) once: a fit retried
        after a rewind runs the window clean."""
        from ..testing import chaos as chaos_lib
        self._chaos_numeric = chaos_lib.numeric_faults()
        # each rank claims its own token: every rank of a world applies
        # the fault to its share of the step
        self._chaos_step = tuple(
            f for f in self._chaos_numeric
            if f.kind in ("nanloss", "gradspike", "bitflip")
            and chaos_lib.claim_numeric(f, rank=self.global_rank))

    def _apply_chaos(self, state: TrainState, metrics: Dict[str, Any],
                     grads: List[torch.Tensor], local: bool
                     ) -> List[torch.Tensor]:
        """The claimed step faults on this step's metrics and gradients:
        the global mean (``local`` False) or, under the compressed
        exchange, this rank's local gradients (a ranked fault then hits
        only its replica, as JAX's stacked local gradients)."""
        if not self._chaos_step:
            return grads
        from ..testing import chaos as chaos_lib
        grads = list(grads)
        rank = self._rank_mesh.batch_rank if local else None
        for fault in self._chaos_step:
            chaos_lib.apply_numeric(fault, state.step, metrics, grads,
                                    rank=rank)
        return grads

    def _wrap_fit_source(self, source, skip, badbatch_faults,
                         start_step: int):
        """The guardian's and chaos's wrap of the host-order fit source
        (before placement): quarantined batch indices become ``("skip",
        None)``, and ``badbatch`` poisons the host batch that runs as its
        1-based global step (claimed once, so the retry runs clean).
        Over ranks only the rank holding the global batch's first row
        poisons its rows: the global batch carries one NaN, as JAX's."""
        from ..testing import chaos as chaos_lib
        holds_row0 = self._rank_mesh.batch_rank == 0

        def gen():
            dispatched = 0
            for i, item in enumerate(source):
                if i in skip:
                    yield ("skip", None)
                    continue
                dispatched += 1
                kind, payload = item
                if kind == "host":
                    for f in badbatch_faults:
                        if (f.step or 1) == start_step + dispatched \
                                and holds_row0 and chaos_lib.claim_numeric(
                                    f, rank=self.global_rank):
                            payload = chaos_lib.poison_batch(payload)
                yield (kind, payload)

        return gen()

    # ---- the guardian's host seams ----------------------------------- #
    def _any_rank(self, flag: bool) -> bool:
        return (any_across_ranks(flag, self.device)
                if self.world_size > 1 else flag)

    def _guard_check(self, guard_row: Any) -> None:
        """Hand one host guard row to the guardian (no-op while healthy;
        raises ``NumericAnomaly`` on a sticky trip).  Every rank calls it
        at the same points with the same row."""
        if self._guardian is None or guard_row is None:
            return
        self._guardian.check(
            guard_row, replay=self._build_guard_replay(),
            compression_active=(self.grad_compression is not None
                                or self.int8_matmul),
            any_fn=self._any_rank)

    def _guard_flush(self, metrics: Any) -> None:
        """Read back only the guard row and check it: the fence before a
        log row, a mid-epoch validation or an epoch end can act on
        post-anomaly state."""
        if self._guardian is None or not isinstance(metrics, dict):
            return
        g = metrics.get("guard")
        if g is not None:
            # graftlint: ok(host-sync) — validation-boundary fence
            self._guard_check(g.detach().cpu().numpy()
                              if isinstance(g, torch.Tensor) else g)

    def _build_guard_replay(self):
        """The guardian's blame replay (cold path, on a trip only): the
        loss and gradients of the suspect batch recomputed eagerly on the
        current parameters with no compressed exchange and the int8
        matmuls off; this rank's rows (the guardian ORs the verdict over
        the ranks)."""
        module, state = self.module, self._state
        if module is None or state is None:
            return None

        def replay(payload):
            int8_prev = getattr(module, "int8_matmul", False)
            module.int8_matmul = False
            try:
                compute = self._compute_leaves(state)
                out = module.training_step(
                    tree_like(state.params, compute),
                    self._put_batch(payload),
                    state.step_generator(self.device, self._dropout_key()))
                loss = out[0] if isinstance(out, tuple) else out
                grads = [g for g in torch.autograd.grad(
                    loss, compute, allow_unused=True) if g is not None]
                gn = global_norm(grads) if grads else loss.new_zeros(())
                # graftlint: ok(host-sync) — post-trip cold path
                loss_ok = bool(torch.isfinite(loss.detach()))
                # graftlint: ok(host-sync) — post-trip cold path
                gn_ok = bool(torch.isfinite(gn))
            finally:
                module.int8_matmul = int8_prev
            return {"loss_nonfinite": not loss_ok,
                    "grad_nonfinite": not gn_ok}

        return replay

    # ---- the device dataset cache ------------------------------------- #
    _CACHE_MAX_BYTES = 1 << 30  # "auto" caches datasets up to 1 GiB
    # "auto" engages only where a batch's host-to-device copy costs (a
    # card); on the CPU the cache's gather costs more than it saves
    _CACHE_AUTO_ON_CPU = False

    def _build_device_cache(self, loader) -> bool:
        """Place an array-backed dataset on the device once; each step's
        input becomes an index row gathered there.  Every rank holds the
        whole dataset (the sampler, not the dataset, is what is
        sharded)."""
        self._device_cache = None
        mode = self.cache_dataset_on_device
        if mode is False or not isinstance(loader, DataLoader) \
                or loader.sampler is None:
            return False
        arrays = getattr(loader.dataset, "_native_arrays", lambda: None)()
        if not arrays or any(np.asarray(a).dtype.hasobject
                             for a in arrays):
            return False
        if loader.collate_fn is not default_collate:
            return False
        total = sum(np.asarray(a).nbytes for a in arrays)
        if mode == "auto":
            if total > self._CACHE_MAX_BYTES:
                return False
            if self.device.type == "cpu" and not self._CACHE_AUTO_ON_CPU:
                return False
        self._device_cache = tuple(
            torch.as_tensor(np.ascontiguousarray(a)).to(self.device)
            for a in arrays)
        return True

    def _gather_cached(self, idx: torch.Tensor) -> Any:
        """The batch of index row ``idx``, gathered on the device (the
        default collate's shape: one array alone, or a tuple)."""
        batch = tuple(torch.index_select(a, 0, idx)
                      for a in self._device_cache)
        return batch[0] if len(batch) == 1 else batch

    def _can_scan_epoch(self) -> bool:
        """The whole-epoch path is eligible when nothing needs the host
        between steps: the cache active, no mid-epoch validation, no
        ``max_time``, no profiler spans, no active quarantine, and no
        callback overriding ``on_train_batch_end``."""
        if self._device_cache is None:
            return False
        if self.val_check_interval or self.max_time is not None:
            return False
        # per-step profiler spans need the step loop
        if self.profiler is not None:
            return False
        # an active quarantine needs the step loop's per-batch skip seam;
        # badbatch chaos the host path
        if self._guardian is not None and self._guardian.has_quarantine():
            return False
        if any(f.kind == "badbatch" for f in self._chaos_numeric):
            return False

        def overrides_batch_end(c) -> bool:
            fn = getattr(c, "on_train_batch_end", None)
            # __func__ also catches instance-attribute hooks
            return getattr(fn, "__func__", None) \
                is not Callback.on_train_batch_end

        return not any(overrides_batch_end(c) for c in self.callbacks)

    @staticmethod
    def _epoch_index_plan(loader):
        """(this rank's permutation, rows a batch, full batches)."""
        perm = np.fromiter(loader.sampler, np.int64)
        bs = loader._rank_batch
        return perm, bs, len(perm) // bs

    @staticmethod
    def _tail_host_batch(loader, perm, full_nb):
        """The trailing partial batch (``drop_last=False``), or None."""
        tail = perm[full_nb * loader._rank_batch:]
        if not len(tail) or loader.drop_last:
            return None
        # graftlint: ok(host-sync) — host arrays: the dataset's own numpy
        batch = tuple(np.asarray(a)[tail]  # columns, no device value
                      for a in loader.dataset._native_arrays())
        return batch[0] if len(batch) == 1 else batch

    def _cached_epoch_source(self, loader):
        """The epoch's items in the sampler's order: ("cached", index row)
        for each full batch (the index matrix placed once, here, on the
        consumer thread), then ("host", the trailing partial batch)."""
        perm, bs, nb = self._epoch_index_plan(loader)
        idx_mat = (torch.as_tensor(perm[:nb * bs].reshape(nb, bs))
                   .to(self.device) if nb else None)
        tail = self._tail_host_batch(loader, perm, nb)

        def gen():
            for i in range(nb):
                yield ("cached", idx_mat[i])
            if tail is not None:
                yield ("host", tail)

        return gen()

    def _run_scanned_epoch(self, state: TrainState, loader):
        """The whole-epoch path (JAX ``_run_scanned_epoch``; one
        ``lax.scan`` dispatch there): the epoch's index matrix placed
        once, its full-batch steps run back to back with no host readback
        between them, the metrics stacked on the device and read back
        once after the epoch, which serves the cadence's log rows and the
        guard's last row.  The trailing partial batch runs through the
        host path.  Returns (last-step metrics, epoch complete)."""
        perm, bs, full_nb = self._epoch_index_plan(loader)
        nb_epoch = full_nb
        if self.limit_train_batches is not None:
            nb_epoch = min(nb_epoch, self.limit_train_batches)
        nb = nb_epoch
        if self.max_steps:
            nb = min(nb, max(0, self.max_steps - self.global_step))
        budget_cut = nb < nb_epoch  # max_steps ends the epoch early
        train_metrics: Dict[str, Any] = {}
        if nb:
            idx_mat = torch.as_tensor(
                perm[:nb * bs].reshape(nb, bs)).to(self.device)
            first_step, first_state_step = self.global_step, state.step
            t_scan = time.perf_counter()
            rows = []
            for i in range(nb):
                rows.append(self._train_step(
                    state, self._gather_cached(idx_mat[i])))
                self.global_step += 1
            stacked = _stack_metrics(rows)
            # graftlint: ok(host-sync) — the one readback of the epoch
            host = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                        else v) for k, v in stacked.items()}
            if self.perf is not None:
                # no per-step phases here: one coarse nb-step row (up to
                # the readback, so the device's work is in it) and the
                # ledger's throttled sample
                self.perf.timeline.observe_scan_epoch(
                    time.perf_counter() - t_scan, nb)
                self.perf.hbm.maybe_sample()
            g_stack = host.pop("guard", None)
            cadence = self.log_every_n_steps
            if self.global_rank == 0:
                for i in range(nb):
                    if (first_step + i + 1) % cadence == 0:
                        self._log_now({k: float(v[i])
                                       for k, v in host.items()},
                                      step=first_step + i + 1)
            train_metrics = {k: v[-1] for k, v in host.items()}
            if g_stack is not None:
                # the sticky last row carries any trip of the epoch
                # graftlint: ok(host-sync) — already on host (the
                last = np.asarray(g_stack)[-1]  # readback above)
                i = int(last[guardian_lib.I_TRIP_STEP]) - first_state_step
                if last[guardian_lib.I_TRIPPED] and 0 <= i < nb \
                        and self._guardian is not None:
                    # the trip's batch, gathered again for the blame
                    self._guardian.note_step(
                        first_state_step + i, self.current_epoch, i,
                        "host", self._gather_cached(idx_mat[i]))
                self._guard_check(last)

        def budget_hit() -> bool:
            return bool(self.max_steps
                        and self.global_step >= self.max_steps)

        tail = self._tail_host_batch(loader, perm, full_nb)
        if (tail is not None and not budget_hit() and nb == full_nb
                and (self.limit_train_batches is None
                     or full_nb < self.limit_train_batches)):
            batch = self._put_batch(tail)
            if self._guardian is not None:
                self._guardian.note_step(self.global_step,
                                         self.current_epoch, full_nb,
                                         "host", batch)
            train_metrics = self._train_step(state, batch)
            self.global_step += 1
        if budget_hit():
            # the step loop's parity: it breaks on the budget check after
            # the batch, leaving the epoch incomplete
            self.should_stop = True
        return train_metrics, not (budget_cut or budget_hit())

    def _validation_pass(self, module: TorchModule,
                         emit: bool = False) -> None:
        """A validation pass (``emit``: the epoch-boundary one, which
        emits the ``validation`` event as the JAX trainer's does)."""
        for c in self.callbacks:
            c.on_validation_start(self, module)
        with self._span("validation", phase="validation"):
            val_metrics = self._run_eval(self._val_loader,
                                         module.validation_step,
                                         self._state.params,
                                         limit=self.limit_val_batches)
        self.callback_metrics.update(val_metrics)
        self._log_now(val_metrics)
        module.on_validation_epoch_end()
        for c in self.callbacks:
            c.on_validation_end(self, module)
        if emit:
            recorder.emit("validation", step=self.global_step,
                          epoch=self.current_epoch)

    def _after_train_epoch(self, module: TorchModule,
                           train_metrics: Dict[str, Any]) -> None:
        """Epoch epilogue: harvest metrics, run epoch-boundary validation,
        fire callbacks, advance the epoch counter.  The guard row is
        checked first: a sticky trip raises before a checkpoint or
        early-stopping callback can act on post-anomaly state."""
        self._guard_flush(train_metrics)
        self.callback_metrics.update(
            {k: float(v) for k, v in train_metrics.items() if k != "guard"})
        run_val = (self._val_loader is not None and
                   (self.current_epoch + 1) % self.check_val_every_n_epoch
                   == 0)
        if run_val and self._last_val_step == self.global_step:
            # a val_check_interval pass just ran at this step: don't
            # validate the same params twice
            run_val = False
        if run_val:
            self._validation_pass(module, emit=True)
        for c in self.callbacks:
            c.on_train_epoch_end(self, module)
        if not run_val and self._val_loader is None:
            # checkpoint / early-stop callbacks keyed on validation_end
            # still fire once per epoch, on the train metrics
            for c in self.callbacks:
                c.on_validation_end(self, module)
        self.current_epoch += 1
        recorder.emit("epoch_end", epoch=self.current_epoch,
                      step=self.global_step)
        if self.enable_progress_bar and self.global_rank == 0:
            log.warning("epoch %d done (step %d) metrics=%s",
                        self.current_epoch, self.global_step,
                        {k: round(v, 5) for k, v in
                         self.callback_metrics.items()})

    def _done(self) -> bool:
        if self.should_stop:
            return True
        if self.max_epochs is not None and \
                self.current_epoch >= self.max_epochs:
            return True
        return self.max_steps is not None and \
            self.global_step >= self.max_steps

    def _log_now(self, metrics: Dict[str, float],
                 step: Optional[int] = None) -> None:
        if self.logger is not None and metrics and self.global_rank == 0:
            self.logger.log_metrics(metrics, self.global_step
                                    if step is None else step)

    # ------------------------------------------------------------------ #
    # Evaluation                                                         #
    # ------------------------------------------------------------------ #
    def ema_params(self) -> Any:
        """The parameter EMA (a tree like the params), or None when
        ``ema_decay`` is not set or nothing was fitted."""
        if self._state is None or "ema" not in self._state.opt.state:
            return None
        return tree_like(self._state.params, self._gather_owned(
            self._state.opt.state["ema"], self._owned_layouts))

    @torch.no_grad()
    def _run_eval(self, loader, step_fn, params: Any,
                  limit: Optional[int] = None) -> Dict[str, float]:
        """Batch-size-weighted means of ``step_fn(params, batch)``'s
        metrics, read off the device once at the end; across the ranks of
        a world, the weighted sums and the row counts are summed first, so
        every rank reads the global batches' means.  Under ``ema_eval``
        the fit's weights are replaced by their EMA."""
        if self._state is not None and params is self._state.params:
            params = (self.ema_params() if self.ema_eval
                      else self._view_params(self._state))
        def place(batch):
            # the batch's weight from the host batch, then the placement
            return (np.shape(_first_leaf(batch))[0],
                    prefetch_lib.to_device(batch, self.device,
                                           pin=bool(self.prefetch_batches)))

        per_batch = []
        with self._input_pipeline(loader, place, limit,
                                  "rla-prefetch-eval") as source:
            for n, batch in source:
                per_batch.append((n, step_fn(params, batch)))
        sums: Dict[str, float] = {}
        weights = 0.0
        for n, m in per_batch:
            for k, v in m.items():
                sums[k] = sums.get(k, 0.0) + float(v) * n
            weights += n
        if self._rank_mesh.batch_size > 1:
            # every rank holds the same metric keys (one step function);
            # the ranks of one batch shard hold the same sums
            keys = sorted(sums)
            *vals, weights = sum_across_ranks(
                [sums[k] for k in keys] + [weights], self.device,
                group=self._rank_mesh.group("batch"))
            sums = dict(zip(keys, vals))
        return {k: v / max(weights, 1.0) for k, v in sums.items()}

    def _eval_params(self, module: TorchModule, stage: str) -> Any:
        """The weights to evaluate ``module`` on: the fit's live state for
        the fitted module, else ``module.params`` on the device."""
        if self._state is not None and module is self.module:
            return self._state.params
        if module.params is None:
            raise RuntimeError(f"{stage}() before fit(): module has no "
                               "params")
        self._bind(module)
        self._state = None
        params = _tree_map(lambda t: torch.as_tensor(t).to(self.device),
                           module.params)
        if _in_world():
            self._enter_mesh(module)
        if _in_world() and self.accelerator is not None:
            # this rank's model-axes parts of the whole weights
            layouts = self.accelerator.param_shardings(
                self.accelerator.build_mesh(), params, module=module,
                report_fallbacks=False)
            params = sharding_lib.tree_map_with_path(
                lambda _p, t, lay: sharding_lib.local_part(
                    t, lay, self._rank_mesh), params, layouts)
        return params

    def _eval_entry(self, module: TorchModule, dataloaders, step_fn,
                    stage: str) -> List[Dict[str, float]]:
        params = self._eval_params(module, stage)
        if _in_world():
            dataloaders = self._rank_source(dataloaders, False)
        if stage == "validate":
            for c in self.callbacks:
                c.on_validation_start(self, module)
        limit = self.limit_val_batches if stage != "test" else None
        metrics = self._run_eval(dataloaders, step_fn(module), params,
                                 limit=limit)
        self.callback_metrics.update(metrics)
        for c in self.callbacks:
            if stage == "test":
                c.on_test_end(self, module)
            else:
                c.on_validation_end(self, module)
        recorder.emit("validation", stage=stage, step=self.global_step)
        return [metrics]

    def validate(self, module: TorchModule, dataloaders=None,
                 datamodule=None) -> List[Dict[str, float]]:
        plan = self._launch_plan()
        if plan is not None:
            return self._eval_via_launcher(plan, module, dataloaders,
                                           datamodule, "validate")
        if datamodule is not None:
            datamodule.setup("validate")
            dataloaders = dataloaders or datamodule.val_dataloader()
        return self._eval_entry(module, dataloaders,
                                lambda m: m.validation_step, "validate")

    def test(self, module: TorchModule, dataloaders=None,
             datamodule=None) -> List[Dict[str, float]]:
        plan = self._launch_plan()
        if plan is not None:
            return self._eval_via_launcher(plan, module, dataloaders,
                                           datamodule, "test")
        if datamodule is not None:
            datamodule.setup("test")
            dataloaders = dataloaders or datamodule.test_dataloader()
        return self._eval_entry(module, dataloaders, lambda m: m.test_step,
                                "test")

    @torch.no_grad()
    def predict(self, module: TorchModule, dataloaders=None,
                datamodule=None) -> List[Any]:
        """``predict_step`` of every batch, as tensors on the host.  Over
        an accelerator's ranks each rank predicts its rows of every batch
        and the driver puts them back in the dataset's order."""
        plan = self._launch_plan()
        if plan is not None:
            return self._eval_via_launcher(plan, module, dataloaders,
                                           datamodule, "predict")
        if datamodule is not None:
            datamodule.setup("predict")
            dataloaders = dataloaders or datamodule.predict_dataloader()
        params = self._eval_params(module, "predict")
        if self._state is not None and params is self._state.params:
            params = self._view_params(self._state)
        if _in_world():
            dataloaders = self._rank_source(dataloaders, False)
        with self._input_pipeline(
                dataloaders,
                lambda b: prefetch_lib.to_device(
                    b, self.device, pin=bool(self.prefetch_batches)),
                None, "rla-prefetch-predict") as source:
            return [_tree_map(lambda t: t.cpu(),
                              module.predict_step(params, batch))
                    for batch in source]

    @contextlib.contextmanager
    def _input_pipeline(self, loader, place, limit: Optional[int],
                        name: str):
        """The evaluation / predict input: ``place`` of each of the
        loader's batches (bounded at ``limit`` at the source, so the
        producer never pulls past it), through the prefetch pipeline when
        ``prefetch_batches`` is set, which is closed on the way out."""
        source = iter(loader)
        if limit is not None:
            source = itertools.islice(source, limit)
        if not self.prefetch_batches:
            yield map(lambda b: place(b), source)
            return
        pf = prefetch_lib.prefetch_pipeline(
            source, self.prefetch_batches, place, device=self.device,
            name=name, host_thread=not _engine_fed(loader),
            profiler=self.profiler)
        try:
            yield pf
        finally:
            pf.close()

    def _fit_mpmd(self, module: TorchModule, train_dataloaders=None,
                  datamodule=None, ckpt_path: Optional[str] = None) -> None:
        """The MPMD pipeline fit (JAX ``_fit_mpmd``): a
        ``parallel/mpmd`` :class:`PipelineRunner` owns the training loop
        -- S stage groups of worker processes on this trainer's device
        running the 1F1B/GPipe tick program, activations crossing stages
        through the shm object store, failures attributed to (and
        replayed within) the faulting stage's budget.  The trainer
        collects the batches and surfaces the runner's summary through
        ``pipeline_summary``, ``trace_id`` and ``callback_metrics``."""
        from ..parallel.mpmd.driver import PipelineRunner
        if ckpt_path is not None:
            raise ValueError(
                "ckpt_path is not supported with pipeline_stages > 1: the "
                "pipeline runner manages its own per-stage checkpoints "
                "(and replay) under default_root_dir")
        if datamodule is not None:
            datamodule.setup("fit")
            train_dataloaders = (train_dataloaders
                                 or datamodule.train_dataloader())
        if train_dataloaders is None:
            raise ValueError("fit() needs train_dataloaders or a datamodule")
        self.fitting = True
        self.module = module
        module.trainer = self
        # one pass per epoch over the loader, bounded as the local loop
        # is: limit_train_batches per epoch, max_steps overall
        batches: List[Any] = []
        for _ in range(self.max_epochs or 1):
            for i, batch in enumerate(train_dataloaders):
                if (self.limit_train_batches is not None
                        and i >= self.limit_train_batches):
                    break
                batches.append(batch)
                if (self.max_steps is not None
                        and len(batches) >= self.max_steps):
                    break
            if self.max_steps is not None and len(batches) >= self.max_steps:
                break
        runner = PipelineRunner(
            module, num_stages=self.pipeline_stages,
            num_workers=getattr(self.accelerator, "num_workers", None),
            schedule=self.pipeline_schedule,
            num_microbatches=self.pipeline_microbatches,
            seed=self.seed, workdir=self.default_root_dir,
            wedge_timeout_s=self.worker_deadline_s, device=self.device)
        try:
            summary = runner.run(batches)
        finally:
            runner.shutdown()
        self.pipeline_summary = summary
        self.trace_id = summary["trace_id"]
        self.global_step = len(summary["steps"])
        if summary["losses"]:
            self.callback_metrics["train_loss"] = float(
                summary["losses"][-1])
        self.fitting = False

    # ------------------------------------------------------------------ #
    # Fan-out over an accelerator's ranks                                #
    # ------------------------------------------------------------------ #
    def _launch_plan(self) -> Optional[Dict[str, Any]]:
        if self.accelerator is None or _in_world():
            return None  # no accelerator, or already one of the ranks
        return self.accelerator.launch_spec()

    def _acquire_world(self, spec: Dict[str, Any]):
        """The persistent world for ``spec``: spawned once and reused by
        fit / validate / test / predict; respawned when the spec changed
        or a failed run killed it.  Acquired before
        ``_strip_for_shipment``, so a world that cannot form raises while
        the driver's module is intact."""
        from ..runtime.bootstrap import DistributedWorld
        world = self._world
        if world is not None and (world.devices != spec["devices"]
                                  or world.agents != spec.get("agents")
                                  or not world.alive()):
            world.shutdown()
            world = self._world = None
            self._live = None   # the ranks that held it are gone
        if world is None:
            world = self._world = DistributedWorld(
                spec["num_processes"], spec["devices"],
                agents=spec.get("agents"))
        return world

    def _strip_for_shipment(self, module: TorchModule) -> Any:
        """Make the module and trainer picklable for the ranks: the
        module's weights as CPU tensors, no live state.  Returns the
        weights to put back afterwards."""
        kept = module.params
        if kept is not None:
            module.params = _tree_map(
                lambda t: torch.as_tensor(t).detach().cpu(), kept)
        module.trainer = None
        self._state = None
        self._val_loader = None
        return kept

    def _run_in_world(self, world, module: TorchModule, body,
                      kept: Any, stage: str = "fit") -> List[Any]:
        """One entry-point run over the world; the ranks' ``put_queue``
        callables run here meanwhile, under the watchdog when
        ``worker_deadline_s`` (or ``RLA_TPU_WEDGE_TIMEOUT_S``) is set.  A
        failed run has killed the world; a stalled one leaves its flat
        diagnosis in ``last_stall_diagnosis``.  The driver's module gets
        its weights and trainer back either way.

        With the SPMD sanitizer on (``RLA_TPU_SPMD_SANITIZER`` and a
        telemetry dir) the rank spills are cleared at entry; a stall
        whose spills diverge raises the typed ``CollectiveMismatch``
        (chained to the stall), a completed run is still checked (and
        its world ended on a mismatch), and a crash is not decoded."""
        from ..runtime.queue import TrampolineQueue
        from ..runtime.watchdog import WorkerWedged, stall_record
        from ..testing import spmd_sanitizer
        self.last_stall_diagnosis = None
        # this run is diffed only against the sequences its ranks issue
        spmd_sanitizer.reset_world_collectives()
        try:
            results = world.run(body, queue=TrampolineQueue(),
                                deadline_s=self.worker_deadline_s)
        except BaseException as e:
            self._world = None
            self._live = None
            self.fitting = False
            if isinstance(e, (WorkerWedged, TimeoutError)):
                record = stall_record(e, stage)
                reaps = list(world.last_stall)
                if reaps and record.get("rank") is None:
                    record["rank"] = reaps[0].get("rank")
                record["reaped"] = reaps
                self.last_stall_diagnosis = record
                log.error("stall diagnosis: %s",
                          json.dumps(record, sort_keys=True, default=str))
                # a stall whose cause is a rank-divergent collective
                # surfaces as the typed mismatch naming the call
                mismatch = None
                try:
                    mismatch = spmd_sanitizer.check_world_collectives(
                        raise_on_mismatch=False)
                except Exception:  # the postmortem must not hide e
                    pass
                if mismatch is not None:
                    self._write_failure_report(mismatch)
                    raise mismatch from e
            # the postmortem: the world is gone, so the ranks' timelines
            # come from their spill files
            self._write_failure_report(e)
            raise
        finally:
            module.params = kept
            module.trainer = self
            self.module = module
        # a completed run may still have issued divergent sequences (a
        # divergence hangs only where the odd call meets no partner):
        # its world is alive and poisoned, so end it before raising
        mismatch = spmd_sanitizer.check_world_collectives(
            raise_on_mismatch=False)
        if mismatch is not None:
            try:
                world.shutdown()
            except Exception:
                pass
            self._world = None
            self._live = None
            self.fitting = False
            self._write_failure_report(mismatch)
            raise mismatch
        return results

    def shutdown_workers(self) -> None:
        """End the spawned ranks and their process group (and with them
        the live state they kept); an idle world otherwise lives until
        the driver exits."""
        self._live = None
        if self._world is not None:
            self._world.shutdown()
            self._world = None

    def teardown(self) -> None:
        """Release the fit's state and end the ranks, so fit and test can
        run again from one script."""
        self._state = None
        self.shutdown_workers()
        if self.accelerator is not None:
            self.accelerator.teardown()

    # ------------------------------------------------------------------ #
    # The live resize                                                     #
    # ------------------------------------------------------------------ #
    def resize_in_memory(self, num_workers: int, *,
                         max_bytes: Optional[int] = None) -> Dict[str, Any]:
        """Resize the fitted world to ``num_workers`` batch shards and move
        its live state there in memory, with no checkpoint (JAX
        ``Trainer.resize_in_memory``).  In the port the live state lives
        in the ranks, so the world itself is resized
        (``DistributedWorld.resize``).

        Everything that can refuse is decided first, on the driver,
        against temporaries: no live state ("live"), the fsdp axis's
        divisibility, ``plan.build_plan`` on the new mesh and the global
        batch's divisibility by the new batch shards; a refusal raises
        ``ElasticResizeError`` and leaves the params, the world and the
        next legal resize as they were.  A shrink then moves the state
        over the old group (``parallel/redistribute.py``, waves under
        ``max_bytes``), keeps ranks ``0..n-1`` and forms the group again
        at ``n``; a grow spawns the new ranks (through the agents where
        the world has them), forms the new group and moves the survivors'
        parts over it.  The per-replica buffers (``residual``,
        ``grad_accum``) come back as zeros and the device dataset cache
        goes.  ``fit(ckpt_path="live")`` continues from there.  Emits
        ``resize_begin`` / ``resize_end``, accounts the pause as
        ``goodput``'s ``resize`` phase, and returns JAX's stats
        (``bytes_moved`` the bytes whose owner rank changed) with
        ``old_world`` and ``new_world``."""
        from ..parallel import redistribute as rd
        from ..runtime.elastic import ElasticResizeError

        world, module = self._world, self.module
        if (self._live is None or world is None or not world.alive()
                or module is None or module.params is None):
            raise ElasticResizeError(
                "resize_in_memory needs a fitted trainer with live state "
                "in its ranks (call fit() over an accelerator first)")
        acc = self.accelerator
        cfg = acc.mesh_config
        if acc.dcn_size > 1:
            # the JAX resize rebuilds the hybrid mesh over every device,
            # which a new batch count cannot fill: it refuses the same
            raise ElasticResizeError(
                "resize_in_memory cannot re-plan a multi-slice mesh "
                f"(dcn_data={acc.dcn_data}, dcn_pipeline="
                f"{acc.dcn_pipeline}): the DCN groups fix the world")
        old_mesh = acc.build_mesh()
        old_dp = mesh_lib.data_parallel_size(old_mesh)
        t0 = time.perf_counter()

        # -- plan the new world against temporaries ------------------
        n_fsdp = cfg.fsdp if cfg.fsdp and cfg.fsdp > 0 else 1
        if num_workers < 1 or num_workers % n_fsdp:
            raise ElasticResizeError(
                f"cannot resize to {num_workers} batch shards: not "
                f"divisible by the mesh's fsdp={n_fsdp} axis")
        new_acc = copy.copy(acc)
        new_acc.mesh_config = dataclasses.replace(
            cfg, data=num_workers // n_fsdp)
        if getattr(new_acc, "num_workers", None) is not None:
            new_acc.num_workers = num_workers
        if getattr(new_acc, "num_hosts", 1) > 1 or getattr(
                new_acc, "_placed_agents", None):
            # the resized world keeps its agents, whatever the count
            new_acc.num_hosts = 1
            new_acc.agents = getattr(acc, "_placed_agents", None)
        tx = module.configure_optimizers()
        if tx is None:
            tx = AdamW(1e-3, weight_decay=0.0)
        full = module.params
        try:
            if world.agents:
                # the survivors stay on their hosts
                new_acc._placement = None
                new_acc._placement = world.plan_placement(
                    len(new_acc.select_devices()))
            new_mesh = new_acc.build_mesh()
            old_plan = self._build_plan(old_mesh, acc, module, full, tx,
                                        report_fallbacks=False)
            new_plan = self._build_plan(new_mesh, new_acc, module, full,
                                        tx, report_fallbacks=False)
        except ValueError as e:
            raise ElasticResizeError(
                f"cannot re-plan the live state onto a {num_workers}-wide "
                f"mesh: {e}") from e
        new_dp = mesh_lib.data_parallel_size(new_mesh)
        rows = self._live.get("batch_rows")
        if rows and rows % new_dp:
            raise ElasticResizeError(
                f"per-process batch dim {rows} is not divisible by the "
                f"resized local data-parallel size {new_dp} (dp "
                f"{old_dp}→{new_dp}); this run cannot continue at that "
                f"world size")
        leaves = _resize_leaves(self, full, tx, _plan_layouts(old_plan),
                                _plan_layouts(new_plan))
        max_bytes = rd.DEFAULT_WAVE_BYTES if max_bytes is None \
            else int(max_bytes)
        old_shape, new_shape = dict(old_mesh.shape), dict(new_mesh.shape)
        n_old = world.num_processes
        n_new = math.prod(new_shape.values())
        spec = {"key": self._run_key, "leaves": leaves,
                "old_shape": old_shape, "new_shape": new_shape,
                "max_bytes": max_bytes, "grow": n_new >= n_old}

        # -- commit ---------------------------------------------------
        recorder.emit("resize_begin", old_world=old_dp, new_world=new_dp,
                      step=self.global_step)
        try:
            if n_new < n_old:
                # the old group moves the state to the ranks that stay
                world.run(functools.partial(_resize_stage, spec))
            if n_new != n_old:
                world.resize(n_new, [str(d) for d in
                                     new_acc.select_devices()])
        except BaseException:
            self._world = None
            self._live = None
            raise
        self.accelerator = new_acc
        kept = self._strip_for_shipment(module)
        self._run_in_world(world, module, functools.partial(
            _resize_adopt, self, module, spec), kept, "resize")
        self._live["world"] = n_new
        self._device_cache = None

        seconds = time.perf_counter() - t0
        sizes = [x.nbytes for x in leaves]
        stats = {"bytes_moved": rd.resharding_bytes(leaves, old_shape,
                                                    new_shape),
                 "bytes_total": sum(sizes), "leaves": len(leaves),
                 "waves": len(rd.wave_schedule(sizes, max_bytes)),
                 "max_wave_bytes": max_bytes, "seconds": seconds,
                 "old_world": old_dp, "new_world": new_dp}
        self.goodput.account("resize", seconds)
        recorder.emit("resize_end", old_world=old_dp, new_world=new_dp,
                      bytes_moved=stats["bytes_moved"],
                      waves=stats["waves"], seconds=seconds)
        log.warning("in-memory resize dp %d→%d: %d bytes moved in %d "
                    "wave(s), %.3fs", old_dp, new_dp, stats["bytes_moved"],
                    stats["waves"], seconds)
        return stats

    def _fit_via_launcher(self, spec, module: TorchModule, train_dataloaders,
                          val_dataloaders, datamodule, ckpt_path) -> None:
        if ckpt_path == "live" and (self._live is None
                                    or self._world is None
                                    or not self._world.alive()):
            # refused before any rank starts
            raise ValueError(
                "ckpt_path='live' continues from the live state the ranks "
                "kept; call fit() (and optionally resize_in_memory()) "
                "first")
        n = mesh_lib.data_parallel_size(self.accelerator.build_mesh())
        for loader in (train_dataloaders, val_dataloaders):
            # refuse a global batch the ranks cannot split before spawning
            if isinstance(loader, DataLoader) and \
                    not loader._user_set_sampler:
                rank_batch_size(loader.batch_size, n)
        seq = self._mesh_seq()
        if seq > 1:
            # the JAX Trainer's fit-time refusals, raised here before the
            # ranks start; the mode travels on the module's config
            self._apply_seq_parallel(module, seq)
        stages = self.accelerator.pipeline_size
        if stages > 1:
            self._apply_pipeline(module, stages, fitting=True)
        self._check_gather_mode(module)
        t0 = time.perf_counter()
        # the trace was minted at fit() entry and rides the shipped
        # trainer, so every rank's events and the driver's share one id
        recorder.emit("fit_start", fanout=spec["num_processes"])
        world = self._acquire_world(spec)
        # the live plane: the driver's server and a ClusterView over the
        # ranks (a local worker's endpoint scraped through its portfile,
        # an agent's worker through the agent's live op), merged
        # rank-labeled into the driver's /metrics while the fit runs
        self._live_server = live_lib.maybe_start_from_env()
        if self._live_server is not None:
            self._live_server.sources.bind_trainer(self)
            self._cluster_view = live_lib.ClusterView(
                workers=list(world.pool.workers)).start()
            self._live_server.sources.bind_cluster_view(self._cluster_view)
        kept = self._strip_for_shipment(module)
        # the data crosses once a world: a later entry point over the same
        # bytes sends their key
        body = functools.partial(_remote_fit_worker, self, module,
                                 world.ship_value(train_dataloaders),
                                 world.ship_value(val_dataloaders),
                                 world.ship_value(datamodule), ckpt_path)
        try:
            results = self._run_in_world(world, module, body, kept)
            if self._cluster_view is not None:
                # one sweep while the world is up: a fit shorter than the
                # cadence must not end with an empty view (a failure
                # keeps the thread's last good view instead)
                try:
                    self._cluster_view.refresh()
                except Exception:
                    pass
        finally:
            if self._cluster_view is not None:
                self._cluster_view.stop()
        # every rank's profiler export and event tail, for the registry
        self._rank_telemetry = {i: (r or {}).get("telemetry")
                                for i, r in enumerate(results)}
        recorder.emit("fit_end", fanout=spec["num_processes"])
        r0 = results[0]
        module.params = _tree_map(
            lambda a: torch.from_numpy(a).to(self.device), r0["params"])
        self.global_step = r0["global_step"]
        self.current_epoch = r0["current_epoch"]
        self.epochs_completed = r0["epochs_completed"]
        self.callback_metrics = dict(r0["metrics"])
        for c in self.callbacks:
            st = r0["callbacks"].get(c.state_key)
            if st:
                c.load_state_dict(st)
        cb = self.checkpoint_callback
        if cb is not None and r0["best_model_path"]:
            cb.best_model_path = r0["best_model_path"]
        if isinstance(self.logger, InMemoryLogger):
            self.logger.history.extend(r0["log_rows"])
        self.rank_report = r0["report"]
        self.comms_per_step = r0["comms_per_step"]
        # the ranks keep their state for fit(ckpt_path="live") and
        # resize_in_memory
        self._live = {"world": world.num_processes,
                      "batch_rows": r0["batch_rows"]}
        self._device_cache = None
        self.fitting = False
        self.fit_duration_s = time.perf_counter() - t0

    def _eval_via_launcher(self, spec, module: TorchModule, dataloaders,
                           datamodule, stage: str):
        """validate / test / predict over the ranks: rank 0's metrics come
        home; predictions from every rank are put back in dataset order."""
        if module.params is None:
            raise RuntimeError(f"{stage}() before fit(): module has no "
                               "params")
        stages = self.accelerator.pipeline_size
        if stages > 1:
            self._apply_pipeline(module, stages, fitting=False)
        # an evaluation over the ranks is a run of its own: its failure
        # report carries its own trace id
        self._bind_trace()
        world = self._acquire_world(spec)
        kept = self._strip_for_shipment(module)
        body = functools.partial(_remote_eval_worker, self, module,
                                 world.ship_value(dataloaders),
                                 world.ship_value(datamodule), stage)
        results = self._run_in_world(world, module, body, kept, stage)
        self._rank_telemetry = {i: (r or {}).get("telemetry")
                                for i, r in enumerate(results)}
        if stage == "predict":
            # one rank speaks for each batch shard (its model
            # coordinates 0), in batch-shard order
            leads = sorted((r for r in results if r["lead"]),
                           key=lambda r: r["batch_rank"])
            return _interleave_predictions(
                [r["outputs"] for r in leads],
                total=results[0]["dataset_len"])
        self.callback_metrics.update(results[0]["metrics"])
        return results[0]["results"]


def _plan_layouts(plan: plan_lib.ShardingPlan) -> tuple:
    """A plan's per-leaf layouts as the trainer keeps them: the batch
    axes' dim of each param (fsdp), its model axes' pairs (tensor, expert,
    pipeline), ZeRO-1's dims (None without), and the part of each leaf
    the optimizer holds.  An axis of one rank splits nothing: a world of
    one has only None.  The exchange follows the batch dims, the model's
    forward the model pairs."""
    layouts = plan_lib._leaves(plan.param_layouts)
    param = [sharding_lib.batch_dim(x) for x in layouts]
    model = [sharding_lib.model_layout(x) for x in layouts]
    zero1 = plan.zero1_update_layouts
    zero1 = ([sharding_lib.batch_dim(z) for z in plan_lib._leaves(zero1)]
             if zero1 is not None else None)
    if zero1 is not None and all(z is None for z in zero1):
        zero1 = None
    return param, model, zero1, (zero1 if zero1 is not None else param)


def _slice(t: torch.Tensor, dim: int, rank: int, n: int) -> torch.Tensor:
    """Rank ``rank``'s contiguous slice of ``dim`` (a view)."""
    size = t.shape[dim] // n
    return t.narrow(dim, rank * size, size)


def _leaf_paths(tree: Any, prefix: str = "") -> List[str]:
    """The ``a/b/c`` path of each leaf, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _leaf_paths(tree[k], f"{prefix}{k}/")]
    return [prefix.rstrip("/")]


class _HostState:
    """A state's whole tensors (by ``_state_entries`` name) in the shape
    ``utils/checkpoint.build_checkpoint`` reads."""

    def __init__(self, state: TrainState, by_name: Dict[str, Any]):
        paths = _leaf_paths(state.params)

        def tree(field):
            return tree_like(state.params,
                             [by_name[f"{field}/{p}"] for p in paths])

        self.step, self.rng = state.step, state.rng
        self.params = tree("params")
        opt: Dict[str, Any] = {}
        for key, value in state.opt.state.items():
            if isinstance(value, dict):
                opt[key] = {name: ([by_name[f"opt/{key}/{name}/{p}"]
                                    for p in paths]
                                   if isinstance(v, list) else v)
                            for name, v in value.items()}
            elif isinstance(value, list):
                opt[key] = [by_name[f"opt/{key}/{p}"] for p in paths]
            else:
                opt[key] = value
        self.opt = types.SimpleNamespace(state=opt)
        self.residual = (tree("residual") if state.residual is not None
                         else None)
        self.grad_accum = (tree("grad_accum")
                           if state.grad_accum is not None else None)
        self.guard_ema = state.guard_ema


def _payload_globals(payload: Dict[str, Any]) -> Dict[str, Any]:
    """A pickle payload's arrays by ``_state_entries`` name."""
    st = payload["state"]
    paths = _leaf_paths(st["params"])
    out = dict(zip((f"params/{p}" for p in paths),
                   tree_leaves(st["params"])))
    for key, value in st["opt_state"].items():
        if isinstance(value, dict):
            for name, v in value.items():
                if isinstance(v, list):
                    out.update((f"opt/{key}/{name}/{p}", a)
                               for p, a in zip(paths, v))
        elif isinstance(value, list):
            out.update((f"opt/{key}/{p}", a) for p, a in zip(paths, value))
    for field in ("residual", "grad_accum"):
        if st.get(field) is not None:
            out.update((f"{field}/{p}", a) for p, a in zip(
                paths, tree_leaves(st[field])))
    return out


def _scalars(step: int, rng_seed: int, opt_state: Dict[str, Any]
             ) -> Dict[str, int]:
    """A state's integers by name: the step, the generator's seed, each
    optimizer count and the accumulation window's position."""
    out = {"step": int(step), "rng_seed": int(rng_seed)}
    for key, value in opt_state.items():
        if isinstance(value, dict) and "count" in value:
            out[f"opt/{key}/count"] = int(value["count"])
        elif isinstance(value, int):
            out[f"opt/{key}"] = int(value)
    return out


def _state_scalars(state: TrainState) -> Dict[str, int]:
    return _scalars(state.step, state.rng.initial_seed(), state.opt.state)


def _apply_scalars(state: TrainState, scalars: Dict[str, int]) -> None:
    """Set a state's integers from ``_scalars``' names (a missing count
    restarts at 0)."""
    state.step = int(scalars.get("step", state.step))
    if "rng_seed" in scalars:
        state.rng.manual_seed(int(scalars["rng_seed"]))
    for key, value in state.opt.state.items():
        if isinstance(value, dict) and "count" in value:
            value["count"] = int(scalars.get(f"opt/{key}/count", 0))
        elif isinstance(value, int):
            state.opt.state[key] = int(scalars.get(f"opt/{key}", 0))


def _engine_fed(loader) -> bool:
    """Whether ``loader``'s batches come from the native engine, which
    gathers ahead on its own threads."""
    return isinstance(loader, DataLoader) and loader.engine_fed


def _stack_metrics(rows: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Per-step metric dicts as one dict of per-step stacks: tensors
    stacked on their device, host numbers as lists."""
    out: Dict[str, Any] = {}
    for k in rows[0]:
        vals = [r[k] for r in rows]
        out[k] = (torch.stack([v.detach() for v in vals])
                  if isinstance(vals[0], torch.Tensor) else list(vals))
    return out


def _first_leaf(tree: Any) -> Any:
    while isinstance(tree, (dict, tuple, list)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) \
            else tree[0]
    return tree


# rank side: the live state of each trainer's run, kept between
# dispatches (fit(ckpt_path="live"), resize_in_memory); a fresh fit of the
# run replaces it and the process takes it with it when the world ends
_LIVE_RUNS: Dict[str, Dict[str, Any]] = {}
_LIVE_ATTRS = ("_state", "_plan", "_param_layouts", "_model_layouts",
               "_model_sharded", "_fsdp", "_zero1", "_owned_layouts",
               "comms_per_step", "global_step", "current_epoch",
               "epochs_completed")


def _in_world() -> bool:
    """True inside a rank of a formed process group."""
    return torch.distributed.is_available() and \
        torch.distributed.is_initialized()


class _RankRows:
    """Rows ``rank::world`` of each global batch an iterable yields: what
    an injected ``ShardedSampler`` gives a ``DataLoader``'s rank."""

    def __init__(self, source, num_replicas: int, rank: int):
        self.source = source
        self.num_replicas = num_replicas
        self.rank = rank
        self.global_rows: Optional[int] = None

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.source, "set_epoch"):
            self.source.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.source)

    def __iter__(self):
        for batch in self.source:
            self.global_rows = np.shape(_first_leaf(batch))[0]
            rank_batch_size(self.global_rows, self.num_replicas)
            yield _tree_map(lambda x: x[self.rank::self.num_replicas],
                            batch)


def _kernel_launches() -> Dict[str, int]:
    """The port's kernel launch counters in this process."""
    from ..ops import attention, norms, quant
    fns = (norms.rms_norm, norms.layer_norm, attention.flash_forward,
           attention.flash_backward_dq, attention.flash_backward_dkv,
           attention.flash_backward_fused, quant.int8_matmul,
           quant.int8_matmul_nt)
    return {f.__name__: f.launches for f in fns}


def _host_floats(metrics: Dict[str, Any]) -> Dict[str, float]:
    out = {}
    for k, v in metrics.items():
        try:
            out[k] = float(v)
        except (TypeError, ValueError):
            pass
    return out


def _enter_rank(trainer: Trainer, rank: int) -> None:
    """A shipped trainer takes its rank's device, checks the world
    against its accelerator and runs the accelerator's ``init_hook``;
    the driver's trace id (on the shipped trainer) becomes the rank's
    ambient one, so its events correlate with the driver's."""
    trainer.device = trainer.accelerator.select_devices()[rank]
    trainer.accelerator.validate_process_topology()
    trainer.accelerator.setup_environment()
    if trainer.trace_id:
        recorder.set_trace_id(trainer.trace_id)


def _rank_telemetry(trainer: Trainer, rank: int) -> Dict[str, Any]:
    """What a rank ships home for the driver's registry: its profiler's
    export (raw reservoirs, so the merge stays exact) and its events."""
    return {"rank": rank,
            "profiler": (trainer.profiler.export_state()
                         if trainer.profiler is not None else None),
            "events": recorder.get_recorder().events()}


def _remote_fit_worker(trainer: Trainer, module: TorchModule,
                       train_dataloaders, val_dataloaders, datamodule,
                       ckpt_path, rank: int) -> Optional[Dict[str, Any]]:
    """``fit`` inside rank ``rank`` of the world.  Every rank fits; rank 0
    returns what the driver loads: its weights (numpy), counters, metrics,
    callback states, best checkpoint and log rows, and a report of the
    rank (device, backend, the gradient all-reduces and their ms, the
    kernels it launched)."""
    import torch.distributed as dist

    from ..runtime.bootstrap import resolve_shipped
    t0 = time.perf_counter()
    train_dataloaders = resolve_shipped(train_dataloaders)
    val_dataloaders = resolve_shipped(val_dataloaders)
    datamodule = resolve_shipped(datamodule)
    _enter_rank(trainer, rank)
    if ckpt_path == "live":
        # this rank's live state, kept since the last fit or resize
        live = _LIVE_RUNS.get(trainer._run_key)
        if live is None:
            raise ValueError("ckpt_path='live': this rank holds no live "
                             "state for the run")
        for name, value in live.items():
            setattr(trainer, name, value)
    else:
        _LIVE_RUNS.pop(trainer._run_key, None)
    launches0 = _kernel_launches()
    rows0 = len(getattr(trainer.logger, "history", []))
    trainer.fit(module, train_dataloaders, val_dataloaders,
                datamodule=datamodule, ckpt_path=ckpt_path)
    _LIVE_RUNS[trainer._run_key] = {
        name: getattr(trainer, name) for name in _LIVE_ATTRS}
    launches = {k: v - launches0[k] for k, v in _kernel_launches().items()}
    # a collective: every rank
    model_report = _model_axes_report(trainer, launches)
    telemetry = _rank_telemetry(trainer, rank)
    if rank != 0:
        # every rank's profiler and events reach the driver's registry
        return {"telemetry": telemetry}
    best = getattr(trainer.checkpoint_callback, "best_model_path", None)
    params = _tree_map(lambda t: t.detach().cpu().numpy(), module.params)
    return {
        "params": params,
        "global_step": trainer.global_step,
        "current_epoch": trainer.current_epoch,
        "epochs_completed": trainer.epochs_completed,
        "metrics": _host_floats(trainer.callback_metrics),
        "callbacks": {c.state_key: c.state_dict()
                      for c in trainer.callbacks if c.state_dict()},
        "best_model_path": best,
        "log_rows": list(getattr(trainer.logger, "history", [])[rows0:]),
        "comms_per_step": trainer.comms_per_step,
        "telemetry": telemetry,
        "batch_rows": _global_batch_rows(trainer.train_dataloader),
        "report": {"device": str(trainer.device),
                   "backend": dist.get_backend(),
                   "world_size": dist.get_world_size(),
                   "mesh": dict(trainer._rank_mesh.shape),
                   # the rank at each mesh position (a hybrid mesh's
                   # layout; None: rank order) and this rank's place
                   "mesh_order": (list(trainer._rank_mesh.order)
                                  if trainer._rank_mesh.order is not None
                                  else None),
                   "coords": dict(trainer._rank_mesh.coords),
                   "model_comms": MODEL_COMMS.stats(),
                   **model_report,
                   **trainer._exchange.stats(),
                   **_state_report(trainer),
                   "launches": launches,
                   # the rank's own fit, and its whole run up to here
                   "fit_s": trainer.fit_duration_s,
                   "run_s": time.perf_counter() - t0},
    }


def _resize_leaves(trainer: Trainer, full: Any, tx: Any, old: tuple,
                   new: tuple) -> List[Any]:
    """The tree a resize moves, in the JAX package's leaf order (the step,
    the params, optax's state, the generator's key), each tensor leaf with
    its whole layout (model pairs, then ``("batch", dim)``) before and
    after; ``old`` / ``new`` are ``_plan_layouts``.  The port's state
    outside it starts fresh: the residuals and accumulators (zeros, as
    JAX's), and SGD's trace without momentum (optax keeps none)."""
    from ..parallel.redistribute import Leaf
    paths = _leaf_paths(full)
    shapes = [tuple(t.shape) for t in tree_leaves(full)]

    def pairs(model, dim):
        return (tuple(model or ()) + (((sharded_lib.BATCH, dim),)
                                      if dim is not None else ())) or None

    def tensors(prefix, which):
        return [Leaf(f"{prefix}/{p}", sh, 4, pairs(mo, do), pairs(mn, dn))
                for p, sh, mo, do, mn, dn in zip(
                    paths, shapes, old[1], old[which], new[1], new[which])]

    def scalar(name, shape=()):
        return Leaf(name, shape, 4, tensor=False)

    key = tx.state_key
    if isinstance(tx, AdamW):
        inner = ([scalar(f"opt/{key}/count")] + tensors(f"opt/{key}/mu", 3)
                 + tensors(f"opt/{key}/nu", 3))
    else:
        inner = tensors(f"opt/{key}/trace", 3) if tx.momentum else []
    if callable(tx.lr):   # scale_by_learning_rate's schedule count
        inner.append(scalar(f"opt/{key}/schedule_count"))
    if trainer.ema_decay is not None:
        inner += tensors("opt/ema", 3) + [scalar("opt/ema/count")]
    if trainer._opt_accumulate() > 1:   # MultiSteps
        inner = ([scalar("opt/mini_step"), scalar("opt/gradient_step")]
                 + inner + tensors("opt/acc", 3))
    return ([scalar("step")] + tensors("params", 0) + inner
            + [scalar("rng", (2,))])


def _named_parts(live: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A live record's state tensors by ``_state_entries`` name."""
    holder = object.__new__(Trainer)
    holder.__dict__.update(live)
    return {name: t.detach()
            for name, t, _ in holder._state_entries(live["_state"])}


# rank side: the parts a shrink moved to a rank that stays, until the
# group re-forms and the rank builds its new state
_STAGED: Dict[str, Dict[str, Any]] = {}


def _resize_stage(spec: Dict[str, Any], rank: int) -> Optional[Dict]:
    """A shrink's move, over the old group: every rank's parts go to the
    new layouts of ranks ``0..n-1``, who keep them staged (with the
    state's integers and guard vector); the others free theirs."""
    from ..parallel import redistribute as rd
    live = _LIVE_RUNS.pop(spec["key"])
    state = live["_state"]
    parts = _named_parts(live)
    device = next(iter(parts.values())).device
    scalars = _state_scalars(state)
    guard = state.guard_ema
    del live, state
    with torch.no_grad():
        new_parts, stats = rd.redistribute_tree(
            spec["leaves"], parts, spec["old_shape"], spec["new_shape"],
            rank=rank, device=device,
            dtypes={k: v.dtype for k, v in parts.items()},
            max_bytes=spec["max_bytes"], donate=True)
    if rank < math.prod(spec["new_shape"].values()):
        _STAGED[spec["key"]] = {"parts": new_parts, "scalars": scalars,
                                "guard": guard}
    return stats if rank == 0 else None


def _resize_adopt(trainer: Trainer, module: TorchModule,
                  spec: Dict[str, Any], rank: int) -> Optional[Dict]:
    """In the resized world: this rank's state for the new layouts (the
    residuals and accumulators zero), filled from what a shrink staged,
    or on a grow by moving the survivors' parts over this group (a new
    rank holds none); rank 0's integers and guard vector reach every
    rank.  The result is this rank's live state for the run."""
    import torch.distributed as dist

    from ..parallel import redistribute as rd
    _enter_rank(trainer, rank)
    trainer._bind(module)
    trainer._enter_mesh(module)
    state = trainer._build_state(module)
    entries = {name: t for name, t, _ in trainer._state_entries(state)}
    key = spec["key"]
    stats = None
    with torch.no_grad():
        if spec["grow"]:
            live = _LIVE_RUNS.pop(key, None)
            parts = _named_parts(live) if live is not None else {}
            scalars = (_state_scalars(live["_state"]) if live is not None
                       else _state_scalars(state))
            guard = live["_state"].guard_ema if live is not None else None
            del live
            _, stats = rd.redistribute_tree(
                spec["leaves"], parts, spec["old_shape"], spec["new_shape"],
                rank=rank, device=trainer.device,
                dtypes={k: v.dtype for k, v in entries.items()},
                out={k: v.detach() for k, v in entries.items()},
                max_bytes=spec["max_bytes"], donate=True)
            del parts
        else:
            staged = _STAGED.pop(key)
            for name, t in staged["parts"].items():
                entries[name].copy_(t)
            scalars, guard = staged["scalars"], staged["guard"]
            del staged
        # rank 0 (a survivor) holds the run's integers and guard vector
        names = sorted(scalars)
        vals = torch.tensor([scalars[n] for n in names], dtype=torch.int64,
                            device=trainer.device)
        dist.broadcast(vals, 0)
        _apply_scalars(state, dict(zip(names, vals.tolist())))
        if state.guard_ema is not None:
            if guard is not None:
                state.guard_ema.copy_(guard)
            dist.broadcast(state.guard_ema, 0)
    trainer._state = state
    _LIVE_RUNS[key] = {name: getattr(trainer, name) for name in _LIVE_ATTRS}
    return stats if rank == 0 else None


def _global_batch_rows(loader) -> Optional[int]:
    """The global batch's rows of a rank's training source: a loader's
    ``batch_size``, or the last global batch a ``_RankRows`` cut."""
    if isinstance(loader, DataLoader):
        return loader.batch_size
    return getattr(loader, "global_rows", None)


def _state_report(trainer: Trainer) -> Dict[str, Any]:
    """The rank's sharding plan and what its state holds: the plan's
    ``describe()`` and param layouts, each state tensor's local shape
    (by ``_state_entries`` name) and the bytes a field holds."""
    state = trainer._state
    if state is None or trainer._plan is None:
        return {}
    entries = trainer._state_entries(state)
    owned: Dict[str, int] = {}
    for name, t, _ in entries:
        field = {"params": "params", "opt": "opt_state"}.get(
            name.split("/")[0], name.split("/")[0])
        owned[field] = owned.get(field, 0) + t.numel() * t.element_size()
    return {"plan": trainer._plan.describe(),
            "param_layouts": trainer._plan.param_layouts,
            "state_shapes": {name: list(t.shape) for name, t, _ in entries},
            "owned_bytes": owned}


def _model_axes_report(trainer: Trainer,
                       launches: Dict[str, int]) -> Dict[str, Any]:
    """What every rank holds, gathered to each (a collective over the
    world): each rank's state bytes by field (``owned_bytes_by_rank``)
    and kernel launches (``launches_by_rank``), the groups of this rank's
    mesh (``mesh_groups``: name -> members and backend) and whether each
    parameter is bit for bit the same on every rank of each tensor,
    expert or pipeline group that does not split it
    (``replicated_bitwise_equal``, None without such an axis)."""
    import torch.distributed as dist
    state = trainer._state
    if state is None:
        return {}
    owned = _state_report(trainer).get("owned_bytes", {})
    fields, kernels = sorted(owned), sorted(launches)
    mine = torch.tensor([owned[f] for f in fields]
                        + [launches[k] for k in kernels],
                        dtype=torch.float64, device=trainer.device)
    every = collectives_lib._gather_stack(mine, dist.group.WORLD, "report")
    rmesh = trainer._rank_mesh
    mesh_groups = {name: [ranks, dist.get_backend(rmesh.groups[name])
                          if rmesh.groups.get(name) is not None
                          else dist.get_backend()]
                   for name, ranks in rmesh.members.items()}
    axes = [a for a in (mesh_lib.TENSOR_AXIS, mesh_lib.EXPERT_AXIS,
                        mesh_lib.PIPELINE_AXIS) if rmesh.group(a) is not None]
    equal = None
    if axes:
        equal = True
        for t, m in zip(tree_leaves(state.params), trainer._model_layouts):
            # each group over which the leaf is replicated (the embedding
            # under pipeline x tensor: its pipeline group)
            for a in axes:
                if sharding_lib.layout_dim(m, a) is not None:
                    continue
                g = rmesh.group(a)
                parts = collectives_lib.all_gather_dim(
                    t.detach()[None], 0, g, kind="report")
                equal = equal and all(torch.equal(parts[0], p)
                                      for p in parts[1:])
    rows = [row.tolist() for row in every]
    return {"owned_bytes_by_rank": [
                {f: int(v) for f, v in zip(fields, row)} for row in rows],
            "launches_by_rank": [
                {k: int(v) for k, v in zip(kernels, row[len(fields):])}
                for row in rows],
            "mesh_groups": mesh_groups,
            "replicated_bitwise_equal": equal}


def _remote_eval_worker(trainer: Trainer, module: TorchModule, dataloaders,
                        datamodule, stage: str, rank: int) -> Dict[str, Any]:
    """validate / test / predict inside rank ``rank``: the metrics are
    the global batches' on every rank (``_run_eval``); predict returns
    this rank's rows for the driver to interleave."""
    from ..runtime.bootstrap import resolve_shipped
    dataloaders = resolve_shipped(dataloaders)
    datamodule = resolve_shipped(datamodule)
    _enter_rank(trainer, rank)
    if stage == "predict":
        if datamodule is not None:
            datamodule.setup("predict")
            dataloaders = dataloaders or datamodule.predict_dataloader()
        outs = trainer.predict(module, dataloaders)
        sized = isinstance(dataloaders, DataLoader) and \
            dataloaders.sampler is not None
        return {"outputs": outs,
                "lead": trainer._rank_mesh.model_lead,
                "batch_rank": trainer._rank_mesh.batch_rank,
                # the strided sampler wrap-pads: the driver cuts the
                # interleaved stream back to the dataset's length
                "dataset_len": len(dataloaders.dataset) if sized else None,
                "telemetry": _rank_telemetry(trainer, rank)}
    entry = trainer.validate if stage == "validate" else trainer.test
    results = entry(module, dataloaders, datamodule=datamodule)
    return {"metrics": _host_floats(trainer.callback_metrics),
            "results": results,
            "telemetry": _rank_telemetry(trainer, rank)}


def _stack_rows(*leaves):
    """Per-rank leaves of one batch, ``(b, ...)`` each, back in global
    order: rank r's row j is global row ``j * world + r``."""
    stacked = torch.stack([torch.as_tensor(x) for x in leaves], dim=1)
    return stacked.reshape((-1,) + tuple(stacked.shape[2:]))


def _interleave_predictions(per_rank: List[List[Any]],
                            total: Optional[int] = None) -> List[Any]:
    """Merge the ranks' predict outputs back into dataset order, one
    batch per global batch, and drop the sampler's wrap-padding past
    ``total`` rows (when every leaf has a per-row leading axis)."""
    merged = [_tree_map_n(_stack_rows, parts) for parts in zip(*per_rank)]
    if total is None:
        return merged
    out: List[Any] = []
    seen = 0
    for batch in merged:
        n = np.shape(_first_leaf(batch))[0]
        take = min(n, total - seen)
        if take <= 0:
            break
        out.append(batch if take == n
                   else _tree_map(lambda x: x[:take], batch))
        seen += take
    return out


def _tree_map_n(fn, trees: Sequence[Any]) -> Any:
    """``fn`` over the matching leaves of several trees of one structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map_n(fn, [t[k] for t in trees]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_tree_map_n(fn, list(col))
                           for col in zip(*trees))
    return fn(*trees)
