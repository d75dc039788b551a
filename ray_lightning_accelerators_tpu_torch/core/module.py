"""TorchModule: the user-facing model container.

Port of the JAX package's ``core/module.py`` (``TpuModule``).  As there,
the step methods are functions of ``(params, batch)``: ``params`` is a
nested dict of leaf tensors that the trainer owns (f32 masters with
``requires_grad``), and ``training_step`` returns ``loss`` or ``(loss,
metrics)``.  ``configure_optimizers`` returns a ``core.optim.AdamW``
(the port's stand-in for an optax transformation).

Beyond the JAX module it carries an explicit device: entry points run on
the card, ``device=None`` means CUDA, and without a CUDA device that is
an error, not a quiet move to the CPU.  Tests pass ``device="cpu"`` and
get the kernels' plain versions.  ``compute_dtype`` is the dtype
activations are carried in and weights are cast to where they are used
(float32 by default; the trainer sets it from its precision).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

DeviceLike = Union[None, str, torch.device]
StepOutput = Union[torch.Tensor, Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the CUDA device; a CUDA request without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port runs on the GPU by "
            "default; pass device='cpu' to run its plain PyTorch versions "
            "on the CPU")
    return dev


def not_ported(what: str, slice_name: str) -> NotImplementedError:
    """The error a later slice's feature raises in this one."""
    return NotImplementedError(
        f"{what} is not ported yet: it comes with the {slice_name} slice of "
        "the PyTorch port (ROADMAP.md lists the slices in order)")


class TorchModule:
    """Base class for the port's models: device, compute dtype, and the
    trainer-facing hooks of the JAX package's ``TpuModule``."""

    # int8 forward matmuls inside the train step (set by
    # Trainer(int8_matmul=True), as the JAX Trainer sets it)
    int8_matmul: bool = False
    # the RankMesh of the ranks' model axes (set by the Trainer inside a
    # world of ranks, as the JAX Trainer sets ``module.mesh``)
    mesh: Any = None
    # True where the forward runs the pipeline schedule over the pipeline
    # axis (``parallel/pipeline.py``, the GPT): each stage then holds a
    # part of a pipeline-replicated leaf's gradient, which the trainer
    # sums over the stages.  Any other module runs its whole forward on
    # every stage, on the same rows, and the trainer averages the stages'
    # whole gradients instead
    runs_pipeline_schedule: bool = False

    def __init__(self, device: DeviceLike = None,
                 compute_dtype: torch.dtype = torch.float32):
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.hparams: Dict[str, Any] = {}
        self.params: Any = None          # populated by Trainer after fit()
        self.trainer = None              # backref set by Trainer
        # optional lr schedule (step -> lr): the trainer logs it as "lr"
        self.lr_schedule = None

    # ------------------------------------------------------------------ #
    # Methods the user overrides.                                        #
    # ------------------------------------------------------------------ #
    def init_params(self, seed: int = 0) -> Any:
        """Build and return the parameter tree (dicts of tensors)."""
        raise NotImplementedError

    def scanned_param_subtrees(self) -> Tuple[str, ...]:
        """Top-level param keys holding layer-stacked leaves that the
        forward runs a layer at a time (the GPT: ``("layers",)``).  The
        scan gather (``Trainer(gather_mode="scan")``) keeps them this
        rank's fsdp slices and gathers each layer inside the layer loop;
        a module without a layer stack returns ``()`` and falls back to
        the whole-tree gather."""
        return ()

    def configure_optimizers(self):
        """The optimizer; the JAX package's default is ``optax.adam(1e-3)``."""
        from .optim import AdamW
        return AdamW(1e-3, weight_decay=0.0)

    def training_step(self, params: Any, batch: Any,
                      generator: Optional[torch.Generator]) -> StepOutput:
        """Return loss, or (loss, metrics-dict).  ``generator`` seeds this
        step's randomness (dropout)."""
        raise NotImplementedError

    def validation_step(self, params: Any, batch: Any
                        ) -> Dict[str, torch.Tensor]:
        """Return a dict of per-batch metrics (means)."""
        raise NotImplementedError

    def test_step(self, params: Any, batch: Any) -> Dict[str, torch.Tensor]:
        return self.validation_step(params, batch)

    def predict_step(self, params: Any, batch: Any) -> Any:
        return self.forward(params, batch)

    def forward(self, params: Any, batch: Any) -> Any:
        raise NotImplementedError

    def on_validation_epoch_end(self) -> None:
        """Host-side hook after each validation pass."""

    # ------------------------------------------------------------------ #
    # MPMD pipeline hooks (parallel/mpmd): override all three to run     #
    # with Trainer(pipeline_stages=S).  The PipelineRunner refuses a     #
    # module missing any of them with a typed PipelineConfigError.       #
    # ------------------------------------------------------------------ #
    def pipeline_stage_params(self, params: Any, stage: int,
                              num_stages: int) -> Any:
        """Carve the full parameter tree into the subtree stage
        ``stage`` owns.  Raise (e.g. for an indivisible layer count) to
        refuse: the driver wraps it into a typed config refusal."""
        raise NotImplementedError(
            f"{type(self).__name__}.pipeline_stage_params is required "
            "for Trainer(pipeline_stages=...)")

    def pipeline_stage_forward(self, stage_params: Any, x: Any,
                               stage: int, num_stages: int) -> Any:
        """One stage's forward ``stage_params, x -> y``, differentiable
        by autograd.  Stage 0 receives the microbatch (as the loader
        yields it, on the stage's device) and extracts its own inputs;
        later stages receive the upstream activation (one floating
        tensor)."""
        raise NotImplementedError(
            f"{type(self).__name__}.pipeline_stage_forward is required "
            "for Trainer(pipeline_stages=...)")

    def pipeline_loss(self, y: Any, batch: Any) -> StepOutput:
        """Last stage only: loss (or ``(loss, metrics)``) from the final
        activation and the microbatch (labels)."""
        raise NotImplementedError(
            f"{type(self).__name__}.pipeline_loss is required for "
            "Trainer(pipeline_stages=...)")

    def on_save_checkpoint(self, checkpoint: Dict[str, Any]) -> None:
        pass

    def on_load_checkpoint(self, checkpoint: Dict[str, Any]) -> None:
        pass

    # ------------------------------------------------------------------ #
    # Conveniences.                                                      #
    # ------------------------------------------------------------------ #
    def save_hyperparameters(self, **kwargs) -> None:
        self.hparams.update(kwargs)

    @staticmethod
    def coerce_checkpoint_lr(lr, default: float, model_name: str):
        """An lr schedule checkpoints as its repr string (callables are not
        serializable); rebuilt by ``load_from_checkpoint`` that string
        arrives as the constructor's ``lr``.  Warn and fall back to
        ``default`` unless the caller overrides."""
        if not isinstance(lr, str):
            return lr
        from ..utils.logging import log
        log.warning(
            "%s: checkpointed lr schedule %s is not reconstructable; "
            "falling back to constant lr=%g -- pass an explicit lr/schedule "
            "override to load_from_checkpoint to silence this",
            model_name, lr, default)
        return default

    @classmethod
    def load_from_checkpoint(cls, checkpoint_path: str,
                             module: Optional["TorchModule"] = None,
                             **init_kwargs) -> "TorchModule":
        """Rebuild a module (``cls(**hparams)``, explicit kwargs winning,
        e.g. ``device=``) and install the checkpointed params into it."""
        from ..utils import checkpoint as ckpt_lib
        from ..utils import sharded_checkpoint as sharded_lib
        sharded = sharded_lib.is_sharded_checkpoint(checkpoint_path)
        payload = (sharded_lib.read_metadata(checkpoint_path) if sharded
                   else ckpt_lib.read_checkpoint(checkpoint_path))
        ctor_kwargs = dict(payload.get("hparams") or {})
        ctor_kwargs.update(init_kwargs)
        mod = module if module is not None else cls(**ctor_kwargs)
        if sharded:
            mod.params = sharded_lib.restore_params(checkpoint_path,
                                                    mod.device)
        else:
            mod.params = ckpt_lib.restore_params(payload, mod.device)
        mod.on_load_checkpoint(payload)
        return mod
