"""Callback system: EarlyStopping, ModelCheckpoint, and the hook surface.

Port of the JAX package's ``core/callbacks.py``: the same hooks, the
same patience and top-k bookkeeping.  Over data-parallel ranks every
rank keeps the same bookkeeping (its metrics are the global batch's) and
only rank 0 writes, evicts and prunes files.  ``keep_last_k`` prunes
the checkpoint directory with ``utils.checkpoint.prune_checkpoints``; the
numeric guardian's rewind anchor, which the JAX callback also protects,
comes with the guardian's training half.
"""

from __future__ import annotations

import math
import operator
import os
from typing import Any, Dict, Optional

from ..utils.checkpoint import remove_checkpoint
from ..utils.logging import log


class Callback:
    """Hook surface (the subset of Lightning's that the trainer calls)."""

    def setup(self, trainer, module, stage: str) -> None: ...
    def on_fit_start(self, trainer, module) -> None: ...
    def on_fit_end(self, trainer, module) -> None: ...
    def on_train_epoch_start(self, trainer, module) -> None: ...
    def on_train_epoch_end(self, trainer, module) -> None: ...
    def on_train_batch_end(self, trainer, module, metrics, batch_idx: int) -> None: ...
    def on_validation_start(self, trainer, module) -> None: ...
    def on_validation_end(self, trainer, module) -> None: ...
    def on_test_end(self, trainer, module) -> None: ...
    def on_save_checkpoint(self, trainer, module, checkpoint: Dict[str, Any]) -> None: ...
    def on_load_checkpoint(self, trainer, module, checkpoint: Dict[str, Any]) -> None: ...

    def state_dict(self) -> Dict[str, Any]:
        return {}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        pass

    @property
    def state_key(self) -> str:
        return type(self).__name__


def _mode_ops(mode: str):
    # operator functions, not lambdas: callbacks travel to data-parallel
    # ranks with the standard pickle
    if mode == "min":
        return operator.lt, math.inf
    if mode == "max":
        return operator.gt, -math.inf
    raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")


class EarlyStopping(Callback):
    """Stop training when ``monitor`` stops improving: patience counted in
    validation rounds, ``min_delta`` slack, sets ``trainer.should_stop``."""

    def __init__(self, monitor: str = "val_loss", patience: int = 3,
                 mode: str = "min", min_delta: float = 0.0,
                 verbose: bool = False):
        self.monitor = monitor
        self.patience = patience
        self.mode = mode
        self.min_delta = abs(min_delta)
        self.verbose = verbose
        self._is_better, self.best_score = _mode_ops(mode)
        self.wait_count = 0
        self.stopped_epoch: Optional[int] = None

    def on_validation_end(self, trainer, module) -> None:
        if trainer.sanity_checking or not trainer.fitting:
            return
        current = trainer.callback_metrics.get(self.monitor)
        if current is None:
            log.warning("EarlyStopping: monitored metric %r not found in %s",
                        self.monitor, sorted(trainer.callback_metrics))
            return
        current = float(current)
        threshold = (self.best_score - self.min_delta if self.mode == "min"
                     else self.best_score + self.min_delta)
        if self._is_better(current, threshold):
            self.best_score = current
            self.wait_count = 0
        else:
            self.wait_count += 1
            if self.wait_count >= self.patience:
                trainer.should_stop = True
                self.stopped_epoch = trainer.current_epoch
                if self.verbose:
                    log.warning("EarlyStopping: stopping at epoch %d (best "
                                "%s=%.5f)", trainer.current_epoch,
                                self.monitor, self.best_score)

    def state_dict(self) -> Dict[str, Any]:
        return {"best_score": self.best_score, "wait_count": self.wait_count,
                "stopped_epoch": self.stopped_epoch}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.best_score = state["best_score"]
        self.wait_count = state["wait_count"]
        self.stopped_epoch = state.get("stopped_epoch")


class ModelCheckpoint(Callback):
    """Save checkpoints, tracking the best by ``monitor`` (``None``: keep
    the ``save_top_k`` most recent).  ``best_model_path`` names the best."""

    def __init__(self, dirpath: Optional[str] = None,
                 monitor: Optional[str] = "val_loss", mode: str = "min",
                 save_top_k: int = 1, save_last: bool = False,
                 filename: str = "epoch={epoch}-step={step}.ckpt",
                 every_n_epochs: int = 1,
                 keep_last_k: Optional[int] = None):
        self.dirpath = dirpath
        self.monitor = monitor
        self.mode = mode
        self.save_top_k = save_top_k
        self.save_last = save_last
        self.filename = filename
        self.every_n_epochs = max(1, every_n_epochs)
        if keep_last_k is not None and keep_last_k < 1:
            raise ValueError(f"keep_last_k must be >= 1, got {keep_last_k}")
        self.keep_last_k = keep_last_k
        self._is_better, self.best_model_score = _mode_ops(mode)
        self.best_model_path: str = ""
        self.last_model_path: str = ""
        self._saved: list = []  # (score, path), best first
        self._writer = True     # rank 0 (or no ranks): touches the files

    def setup(self, trainer, module, stage: str) -> None:
        self._writer = trainer.global_rank == 0
        if self.dirpath is None:
            self.dirpath = os.path.join(trainer.default_root_dir,
                                        "checkpoints")

    def _format_name(self, trainer) -> str:
        return self.filename.format(epoch=trainer.current_epoch,
                                    step=trainer.global_step)

    def _prune(self) -> None:
        """``keep_last_k`` retention over the whole directory, with every
        path this callback still tracks protected."""
        if self.keep_last_k is None or self.dirpath is None \
                or not self._writer:
            return
        from ..utils import checkpoint as ckpt_lib
        protect = [self.best_model_path, self.last_model_path]
        protect += [p for _score, p in self._saved]
        ckpt_lib.prune_checkpoints(self.dirpath, self.keep_last_k,
                                   protect=protect)

    def _remove(self, path: str) -> None:
        if self._writer:
            remove_checkpoint(path)

    def on_validation_end(self, trainer, module) -> None:
        if trainer.sanity_checking or not trainer.fitting \
                or self.save_top_k == 0:
            return
        if (trainer.current_epoch + 1) % self.every_n_epochs != 0:
            return
        path = os.path.join(self.dirpath, self._format_name(trainer))
        if self.monitor is None:
            trainer.save_checkpoint(path)
            if self.best_model_path and self.best_model_path != path:
                self._saved.append((0.0, self.best_model_path))
                while len(self._saved) > max(0, self.save_top_k - 1):
                    _, evicted = self._saved.pop(0)
                    self._remove(evicted)
            self.best_model_path = path
            self._prune()
            return
        current = trainer.callback_metrics.get(self.monitor)
        if current is None:
            log.warning("ModelCheckpoint: monitored metric %r not found",
                        self.monitor)
            return
        current = float(current)
        if len(self._saved) < self.save_top_k or self._is_better(
                current, self._saved[-1][0]):
            trainer.save_checkpoint(path)
            self._saved.append((current, path))
            self._saved.sort(key=lambda t: t[0],
                             reverse=(self.mode == "max"))
            while len(self._saved) > self.save_top_k:
                _, evicted = self._saved.pop()
                if evicted != path:
                    self._remove(evicted)
            if self._is_better(current, self.best_model_score):
                self.best_model_score = current
                self.best_model_path = path
            self._prune()

    def on_fit_end(self, trainer, module) -> None:
        if self.save_last:
            self.last_model_path = os.path.join(self.dirpath, "last.ckpt")
            trainer.save_checkpoint(self.last_model_path)
            self._prune()

    def state_dict(self) -> Dict[str, Any]:
        return {"best_model_score": self.best_model_score,
                "best_model_path": self.best_model_path,
                "saved": list(self._saved)}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.best_model_score = state["best_model_score"]
        self.best_model_path = state["best_model_path"]
        self._saved = list(state.get("saved", []))
