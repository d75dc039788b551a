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

``device`` (None = the CUDA device) takes the place of ``accelerator``.
What the JAX trainer does across devices and processes comes with later
slices and raises ``NotImplementedError`` naming its slice.  Three
defaults differ from the JAX package's until their slices land:
``guard=None``, ``prefetch_batches=0`` and
``cache_dataset_on_device=False``.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..utils import checkpoint as ckpt_lib
from ..utils.logging import CSVLogger, InMemoryLogger, Logger, log
from ..utils.seed import generator_from_seed, seed_everything
from .callbacks import Callback, ModelCheckpoint
from .module import DeviceLike, TorchModule, not_ported, resolve_device
from .optim import AdamW, Optimizer, global_norm, tree_leaves, tree_like
from .state import TrainState

_PRECISION_DTYPES = {
    "bf16": torch.bfloat16, "bf16-mixed": torch.bfloat16,
    "f32": torch.float32, "32": torch.float32, 32: torch.float32,
}


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
                 cache_dataset_on_device: Any = False,
                 prefetch_batches: int = 0,
                 guard: Any = None,
                 seed: Optional[int] = None,
                 accelerator: Any = None,
                 grad_compression: Optional[str] = None,
                 shard_optimizer_state: bool = False,
                 pipeline_stages: int = 1,
                 seq_parallel: int = 1,
                 perf_observatory: Any = None,
                 ema_decay: Optional[float] = None,
                 ema_eval: bool = False,
                 int8_matmul: bool = False):
        refused = [
            (accelerator is not None, "Trainer(accelerator=...) (pass "
             "device=)", "multi-GPU"),
            (grad_compression is not None, "grad_compression", "multi-GPU"),
            (shard_optimizer_state, "shard_optimizer_state", "multi-GPU"),
            (pipeline_stages != 1, "pipeline_stages > 1", "multi-GPU"),
            (seq_parallel != 1, "seq_parallel > 1", "multi-GPU"),
            (perf_observatory not in (None, False), "perf_observatory",
             "runtime"),
            (checkpoint_format != "pickle",
             f"checkpoint_format={checkpoint_format!r}", "multi-GPU"),
            (guard is not None, "the numeric guardian's training half "
             "(guard=)", "runtime"),
            (prefetch_batches != 0, "prefetch_batches > 0", "runtime"),
            (cache_dataset_on_device is not False,
             "cache_dataset_on_device", "runtime"),
        ]
        for bad, what, slice_name in refused:
            if bad:
                raise not_ported(what, slice_name)
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
        if max_epochs is None and max_steps is None:
            max_epochs = 1000
        self.max_epochs = max_epochs
        self.max_steps = max_steps
        self.max_time = max_time
        self.device = resolve_device(device)
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
        self.checkpoint_format = checkpoint_format
        self.num_sanity_val_steps = num_sanity_val_steps
        self.enable_progress_bar = enable_progress_bar
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

    # ------------------------------------------------------------------ #
    # Checkpoints                                                        #
    # ------------------------------------------------------------------ #
    @property
    def checkpoint_callback(self) -> Optional[ModelCheckpoint]:
        for c in self.callbacks:
            if isinstance(c, ModelCheckpoint):
                return c
        return None

    def dump_checkpoint(self) -> Dict[str, Any]:
        cb_states = {c.state_key: c.state_dict() for c in self.callbacks
                     if c.state_dict()}
        # the stored epoch counts COMPLETED epochs, so a resumed run neither
        # repeats the epoch that produced the save nor skips ahead
        payload = ckpt_lib.build_checkpoint(
            self._state, self.epochs_completed, self.global_step,
            hparams=getattr(self.module, "hparams", {}), callbacks=cb_states)
        if self.module is not None:
            self.module.on_save_checkpoint(payload)
        for c in self.callbacks:
            c.on_save_checkpoint(self, self.module, payload)
        return payload

    def save_checkpoint(self, filepath: str) -> None:
        ckpt_lib.atomic_save(self.dump_checkpoint(), filepath)

    def _restore(self, ckpt_path: str, state: TrainState) -> TrainState:
        payload = ckpt_lib.read_checkpoint(ckpt_path)
        state = ckpt_lib.restore_state(payload, state)
        self.current_epoch = payload["epoch"]
        self.epochs_completed = payload["epoch"]
        self.global_step = payload["global_step"]
        for c in self.callbacks:
            if c.state_key in payload.get("callbacks", {}):
                c.load_state_dict(payload["callbacks"][c.state_key])
            c.on_load_checkpoint(self, self.module, payload)
        if self.module is not None:
            self.module.on_load_checkpoint(payload)
        return state

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

    def _build_state(self, module: TorchModule) -> TrainState:
        tx = module.configure_optimizers()
        if tx is None:
            tx = AdamW(1e-3, weight_decay=0.0)
        params = self._master_params(module)
        opt = Optimizer(tx, tree_leaves(params),
                        clip_norm=self.gradient_clip_val,
                        accumulate=self.accumulate_grad_batches,
                        ema_decay=self.ema_decay)
        return TrainState(step=0, params=params, opt=opt,
                          rng=generator_from_seed(self.seed))

    def _put_batch(self, batch: Any) -> Any:
        """A host batch (numpy pytree) as tensors on the device."""
        return _tree_map(lambda x: torch.as_tensor(np.asarray(x)).to(
            self.device, non_blocking=True), batch)

    def _train_step(self, state: TrainState, batch: Any
                    ) -> Dict[str, torch.Tensor]:
        module = self.module
        opt = state.opt
        sched = module.lr_schedule
        # accumulation advances the schedule once per window: index it by
        # optimizer updates, not micro-steps
        lr_now = (float(sched(state.step // self.accumulate_grad_batches))
                  if callable(sched) else None)
        out = module.training_step(state.params, batch,
                                   state.step_generator(self.device))
        loss, metrics = (out if isinstance(out, tuple) else (out, {}))
        metrics = dict(metrics)
        metrics.setdefault("train_loss", loss)
        grads = torch.autograd.grad(loss, opt.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(opt.params, grads)]
        if self.log_grad_norm:
            metrics["grad_norm"] = global_norm(grads)
        opt.step(grads)
        state.step += 1
        metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
                   for k, v in metrics.items()}
        if lr_now is not None:
            metrics["lr"] = lr_now
        return metrics

    # ------------------------------------------------------------------ #
    # fit                                                                #
    # ------------------------------------------------------------------ #
    def fit(self, module: TorchModule, train_dataloaders=None,
            val_dataloaders=None, datamodule=None,
            ckpt_path: Optional[str] = None) -> None:
        if datamodule is not None:
            datamodule.setup("fit")
            train_dataloaders = (train_dataloaders
                                 or datamodule.train_dataloader())
            val_dataloaders = val_dataloaders or datamodule.val_dataloader()
        if train_dataloaders is None:
            raise ValueError("fit() needs train_dataloaders or a datamodule")
        t0 = time.perf_counter()
        self.fitting = True
        self.should_stop = False
        self.current_epoch = 0
        self.epochs_completed = 0
        self.global_step = 0
        self._last_val_step = -1
        self._bind(module)
        if self.int8_matmul:
            module.int8_matmul = True
        train_loader = train_dataloaders
        self._val_loader = val_dataloaders

        state = self._build_state(module)
        self._state = state
        for c in self.callbacks:
            c.setup(self, module, "fit")
        if ckpt_path == "last":
            ckpt_path = ckpt_lib.latest_checkpoint(self.default_root_dir)
            if ckpt_path is None:
                log.warning("ckpt_path='last': no checkpoint under %s; "
                            "starting fresh", self.default_root_dir)
        if ckpt_path is not None:
            state = self._restore(ckpt_path, state)
        for c in self.callbacks:
            c.on_fit_start(self, module)
        if self.num_sanity_val_steps and self._val_loader is not None:
            self.sanity_checking = True
            self._run_eval(self._val_loader, module.validation_step,
                           state.params, limit=self.num_sanity_val_steps)
            self.sanity_checking = False

        train_metrics: Dict[str, Any] = {}
        while not self._done():
            for c in self.callbacks:
                c.on_train_epoch_start(self, module)
            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(self.current_epoch)
            for batch_idx, batch in enumerate(train_loader):
                if (self.limit_train_batches is not None
                        and batch_idx >= self.limit_train_batches):
                    break
                train_metrics = self._fit_step(state, batch, batch_idx)
                if (self.val_check_interval and self._val_loader is not None
                        and self.global_step % self.val_check_interval == 0):
                    self._validation_pass(module)
                    self._last_val_step = self.global_step
                if self.max_steps and self.global_step >= self.max_steps:
                    self.should_stop = True
                    break
                if self.max_time is not None and \
                        time.perf_counter() - t0 >= self.max_time:
                    self.should_stop = True
                    break
            else:
                # the epoch ran to the end of its loader (a max_steps break
                # leaves it incomplete for checkpoint accounting)
                self.epochs_completed = self.current_epoch + 1
            if (self.limit_train_batches is not None
                    and not self.should_stop):
                self.epochs_completed = self.current_epoch + 1
            self._after_train_epoch(module, train_metrics)

        module.params = _tree_map(lambda t: t.detach(), state.params)
        for c in self.callbacks:
            c.on_fit_end(self, module)
        self.fitting = False
        if isinstance(self.logger, CSVLogger):
            self.logger.finalize()
        self.fit_duration_s = time.perf_counter() - t0

    def _fit_step(self, state: TrainState, batch: Any,
                  batch_idx: int) -> Dict[str, torch.Tensor]:
        """One optimizer step: place the batch, run the step, fire the
        per-batch callbacks, log on the cadence."""
        metrics = self._train_step(state, self._put_batch(batch))
        self.global_step += 1
        for c in self.callbacks:
            c.on_train_batch_end(self, self.module, metrics, batch_idx)
        if self.global_step % self.log_every_n_steps == 0:
            self._log_now({k: float(v) for k, v in metrics.items()})
        return metrics

    def _validation_pass(self, module: TorchModule) -> None:
        for c in self.callbacks:
            c.on_validation_start(self, module)
        val_metrics = self._run_eval(self._val_loader,
                                     module.validation_step,
                                     self._state.params,
                                     limit=self.limit_val_batches)
        self.callback_metrics.update(val_metrics)
        self._log_now(val_metrics)
        module.on_validation_epoch_end()
        for c in self.callbacks:
            c.on_validation_end(self, module)

    def _after_train_epoch(self, module: TorchModule,
                           train_metrics: Dict[str, Any]) -> None:
        """Epoch epilogue: harvest metrics, run epoch-boundary validation,
        fire callbacks, advance the epoch counter."""
        self.callback_metrics.update(
            {k: float(v) for k, v in train_metrics.items()})
        run_val = (self._val_loader is not None and
                   (self.current_epoch + 1) % self.check_val_every_n_epoch
                   == 0)
        if run_val and self._last_val_step == self.global_step:
            # a val_check_interval pass just ran at this step: don't
            # validate the same params twice
            run_val = False
        if run_val:
            self._validation_pass(module)
        for c in self.callbacks:
            c.on_train_epoch_end(self, module)
        if not run_val and self._val_loader is None:
            # checkpoint / early-stop callbacks keyed on validation_end
            # still fire once per epoch, on the train metrics
            for c in self.callbacks:
                c.on_validation_end(self, module)
        self.current_epoch += 1
        if self.enable_progress_bar:
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

    def _log_now(self, metrics: Dict[str, float]) -> None:
        if self.logger is not None and metrics:
            self.logger.log_metrics(metrics, self.global_step)

    # ------------------------------------------------------------------ #
    # Evaluation                                                         #
    # ------------------------------------------------------------------ #
    def ema_params(self) -> Any:
        """The parameter EMA (a tree like the params), or None when
        ``ema_decay`` is not set or nothing was fitted."""
        if self._state is None or "ema" not in self._state.opt.state:
            return None
        return tree_like(self._state.params, self._state.opt.state["ema"])

    @torch.no_grad()
    def _run_eval(self, loader, step_fn, params: Any,
                  limit: Optional[int] = None) -> Dict[str, float]:
        """Batch-size-weighted means of ``step_fn(params, batch)``'s
        metrics, read off the device once at the end.  Under ``ema_eval``
        the fit's weights are replaced by their EMA."""
        if self.ema_eval and self._state is not None \
                and params is self._state.params:
            params = self.ema_params()
        per_batch = []
        for i, batch in enumerate(loader):
            if limit is not None and i >= limit:
                break
            n = np.shape(_first_leaf(batch))[0]
            per_batch.append((n, step_fn(params, self._put_batch(batch))))
        sums: Dict[str, float] = {}
        weights = 0.0
        for n, m in per_batch:
            for k, v in m.items():
                sums[k] = sums.get(k, 0.0) + float(v) * n
            weights += n
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
        return _tree_map(lambda t: torch.as_tensor(t).to(self.device),
                         module.params)

    def _eval_entry(self, module: TorchModule, dataloaders, step_fn,
                    stage: str) -> List[Dict[str, float]]:
        params = self._eval_params(module, stage)
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
        return [metrics]

    def validate(self, module: TorchModule, dataloaders=None,
                 datamodule=None) -> List[Dict[str, float]]:
        if datamodule is not None:
            datamodule.setup("validate")
            dataloaders = dataloaders or datamodule.val_dataloader()
        return self._eval_entry(module, dataloaders,
                                lambda m: m.validation_step, "validate")

    def test(self, module: TorchModule, dataloaders=None,
             datamodule=None) -> List[Dict[str, float]]:
        if datamodule is not None:
            datamodule.setup("test")
            dataloaders = dataloaders or datamodule.test_dataloader()
        return self._eval_entry(module, dataloaders, lambda m: m.test_step,
                                "test")

    @torch.no_grad()
    def predict(self, module: TorchModule, dataloaders=None,
                datamodule=None) -> List[Any]:
        """``predict_step`` of every batch, as tensors on the host."""
        if datamodule is not None:
            datamodule.setup("predict")
            dataloaders = dataloaders or datamodule.predict_dataloader()
        params = self._eval_params(module, "predict")
        return [_tree_map(lambda t: t.cpu(),
                          module.predict_step(params,
                                              self._put_batch(batch)))
                for batch in dataloaders]


def _first_leaf(tree: Any) -> Any:
    while isinstance(tree, (dict, tuple, list)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) \
            else tree[0]
    return tree
