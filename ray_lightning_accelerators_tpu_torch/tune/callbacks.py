"""Tune callbacks: report and checkpoint from training into the trial.

Port of the JAX package's ``tune/callbacks.py`` (``TuneReportCallback``,
``_TuneCheckpointCallback``, ``TuneReportCheckpointCallback``), with its
hook map and metric forms (a name, a list of names, or a dict from the
reported name to the trainer's).

Every fit of the port runs in spawned ranks, so these callbacks run in a
rank, in another process than the trial: rank 0 reports through
``tune.report`` / ``tune.checkpoint_payload``, which cross the world's
query channel synchronously (``runtime/bootstrap.py``), and rank 0's stop
verdict is broadcast over the rank group, so every rank leaves the epoch
loop at the same boundary.  ``trainer.callback_metrics`` holds host
floats, so reading it forces no device sync.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import torch

from ..core.callbacks import Callback
from ..utils.logging import log
from . import run as run_lib


def _actor_rank() -> int:
    """This process's rank in the training world (0 outside one): the
    ``torch.distributed`` rank, not the session rank (a process trial's
    session rank is its trial index, and it must still report)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _world_consistent(stop: bool) -> bool:
    """Rank 0's stop verdict, the same on every rank of a distributed fit:
    a one-element broadcast over the rank group (a CUDA tensor under NCCL,
    a CPU tensor under gloo)."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() <= 1:
        return stop
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    flag = torch.tensor([1 if stop else 0], dtype=torch.int32, device=device)
    dist.broadcast(flag, src=0)
    return bool(flag.item())


_HOOK_MAP = {
    "validation_end": "on_validation_end",
    "train_epoch_end": "on_train_epoch_end",
    "fit_end": "on_fit_end",
    "train_end": "on_fit_end",
    "batch_end": "on_train_batch_end",
    "train_batch_end": "on_train_batch_end",
}


class TuneCallback(Callback):
    """Dispatch base: fires ``_handle`` on the configured hook(s)."""

    def __init__(self, on: Union[str, List[str]] = "validation_end"):
        if isinstance(on, str):
            on = [on]
        unknown = [h for h in on if h not in _HOOK_MAP]
        if unknown:
            raise ValueError(
                f"unsupported hook(s) {unknown}; choose from "
                f"{sorted(_HOOK_MAP)}")
        self._on = [_HOOK_MAP[h] for h in on]

    def _handle(self, trainer, module) -> None:
        raise NotImplementedError

    def _dispatch(self, hook: str, trainer, module) -> None:
        if hook in self._on:
            self._handle(trainer, module)

    def on_validation_end(self, trainer, module) -> None:
        self._dispatch("on_validation_end", trainer, module)

    def on_train_epoch_end(self, trainer, module) -> None:
        self._dispatch("on_train_epoch_end", trainer, module)

    def on_fit_end(self, trainer, module) -> None:
        self._dispatch("on_fit_end", trainer, module)

    def on_train_batch_end(self, trainer, module, metrics, batch_idx) -> None:
        self._dispatch("on_train_batch_end", trainer, module)


class TuneReportCallback(TuneCallback):
    """Report ``metrics`` from ``trainer.callback_metrics`` to the current
    trial (None: all of them)."""

    def __init__(self,
                 metrics: Union[None, str, List[str], Dict[str, str]] = None,
                 on: Union[str, List[str]] = "validation_end"):
        super().__init__(on)
        if isinstance(metrics, str):
            metrics = [metrics]
        self._metrics = metrics

    def _get_report_dict(self, trainer, module) -> Optional[Dict[str, float]]:
        if trainer.sanity_checking:
            return None
        if not self._metrics:
            return dict(trainer.callback_metrics)
        report = {}
        if isinstance(self._metrics, dict):
            items = self._metrics.items()
        else:
            items = [(m, m) for m in self._metrics]
        for tune_key, pl_key in items:
            if pl_key in trainer.callback_metrics:
                report[tune_key] = float(trainer.callback_metrics[pl_key])
            else:
                log.warning("metric %r not found in callback_metrics %s",
                            pl_key, sorted(trainer.callback_metrics))
        return report

    def _handle(self, trainer, module) -> None:
        # rank 0 reports: every rank runs this callback on the same
        # (all-reduced) metrics, and a boundary is one report
        if _actor_rank() == 0:
            report = self._get_report_dict(trainer, module)
            if report:
                # synchronous: the scheduler has decided before the next
                # line runs
                run_lib.report(**report)
        # rank 0's view of the decision, broadcast, so every rank leaves
        # the loop together (a per-rank poll could diverge and hang a
        # collective)
        if _world_consistent(run_lib.trial_should_stop()
                             if _actor_rank() == 0 else False):
            trainer.should_stop = True


class _TuneCheckpointCallback(TuneCallback):
    """Ship the trainer's whole checkpoint to the trial's checkpoint
    directory, written driver-side."""

    def __init__(self, filename: str = "checkpoint",
                 on: Union[str, List[str]] = "validation_end"):
        super().__init__(on)
        self._filename = filename

    def _handle(self, trainer, module) -> None:
        if trainer.sanity_checking:
            return
        # a collective in a world (the ranks' parts gathered to whole
        # tensors); rank 0 dumps and ships it
        state = trainer._whole_state()
        if _actor_rank() != 0:
            return
        run_lib.checkpoint_payload(trainer.dump_checkpoint(state),
                                   trainer.global_step, self._filename)


class TuneReportCheckpointCallback(TuneCallback):
    """Checkpoint, then report, so the trial registers the checkpoint with
    the metric."""

    def __init__(self,
                 metrics: Union[None, str, List[str], Dict[str, str]] = None,
                 filename: str = "checkpoint",
                 on: Union[str, List[str]] = "validation_end"):
        super().__init__(on)
        self._checkpoint = _TuneCheckpointCallback(filename, on)
        self._report = TuneReportCallback(metrics, on)

    def _handle(self, trainer, module) -> None:
        self._checkpoint._handle(trainer, module)
        self._report._handle(trainer, module)
