"""The optimizers: AdamW and SGD with optax's arithmetic, global-norm
clipping and gradient accumulation.

The JAX package builds its update with optax (``Trainer._build_tx``,
``core/trainer.py:818``): ``module.configure_optimizers()`` (GPT:
``optax.adamw(lr, weight_decay=0.01)``; ViT: ``adamw(lr,
weight_decay=0.05)``; MNIST: ``optax.adam(lr)``; ResNet-18:
``chain(add_decayed_weights(wd), sgd(lr, momentum, nesterov=True))``),
chained after
``optax.clip_by_global_norm`` when ``gradient_clip_val`` is set, wrapped in
``optax.MultiSteps`` when ``accumulate_grad_batches > 1``.  This module
repeats that arithmetic element for element on the port's parameter
trees (nested dicts of tensors), updating the parameters in place:

- AdamW (``scale_by_adam``, ``add_decayed_weights`` on every leaf,
  ``scale_by_learning_rate``): ``mu = (1-b1) g + b1 mu``,
  ``nu = (1-b2) g^2 + b2 nu``, bias corrections at ``count + 1``,
  ``u = mu_hat / (sqrt(nu_hat) + eps) + wd p``, ``p += -lr(count) u``.
  A schedule is evaluated at the update count BEFORE its increment:
  update k (0-based) uses ``lr(k)``.
- SGD (``add_decayed_weights``, then ``trace`` and
  ``scale_by_learning_rate``): ``g' = g + wd p``, ``t = g' + m t_prev``,
  ``u = g' + m t`` with nesterov (else ``u = t``), ``p += -lr(count) u``.
- clipping: ``g <- g / ||g|| * max_norm`` when ``||g|| >= max_norm``
  (``||.||`` the global L2 norm over every leaf).
- accumulation (``MultiSteps``, mean of the micro-grads): ``acc += (g -
  acc) / (mini_step + 1)``; every ``k``-th call applies the clipped AdamW
  update to ``acc`` and resets it; the other calls leave the parameters
  untouched.
- EMA of the parameters (``Trainer(ema_decay=)``; ``utils/ema.py``, the
  JAX ``ema_tracker`` chained inside ``MultiSteps``): after each applied
  update, so an accumulation micro-step leaves the shadow where it was.
  The shadow is part of ``Optimizer.state``, so a checkpoint carries it.

Over sharded data parallelism the optimizer holds this rank's part of
each leaf (an FSDP slice, or ZeRO-1's dim-0 slice) and its state is
sized from those parts, so moments, the accumulator and the shadow are
sharded as their parameters are.  The clip's norm must then be global:
the trainer passes ``norm_fn`` (the squares of the owned parts summed
over the ranks) or, where each rank holds the whole gradient, the norm
itself to ``step``.  ``state_layouts`` maps parameter layouts onto the
state's leaves in optax's order, for the sharding plan.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Union

import torch

from ..utils.ema import EmaTracker

LR = Union[float, Callable[[int], float]]


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a nested dict, in sorted-key order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    return [tree]


def tree_like(tree: Any, leaves: List[torch.Tensor]) -> Any:
    """``leaves`` (in ``tree_leaves`` order) nested as ``tree`` is."""
    return _nest(tree, iter(leaves))


def _nest(node: Any, it) -> Any:
    # a module-level recursion: a nested function that calls itself is a
    # reference cycle (the function, its closure cell), which would hold
    # the leaves until the cyclic collector ran
    if isinstance(node, dict):
        return {k: _nest(node[k], it) for k in sorted(node)}
    return next(it)


def _lr_at(lr: LR, count: int) -> float:
    """The learning rate of update ``count`` (0-based)."""
    return float(lr(count)) if callable(lr) else float(lr)


def _add_update(p: torch.Tensor, d: torch.Tensor,
                delta_norms: Optional[List[torch.Tensor]]) -> None:
    """``p += d``; with ``delta_norms``, ``d``'s L2 norm appended (the
    numeric guardian's update ratio: the norm of what this update moved,
    taken while ``d`` is live, so no copy of the parameters is kept)."""
    p.add_(d)
    if delta_norms is not None:
        delta_norms.append(torch.linalg.vector_norm(d))


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element (optax.global_norm)."""
    return torch.sqrt(sum((t.float() * t.float()).sum() for t in tensors))


class AdamW:
    """``optax.adamw(lr, b1, b2, eps, weight_decay)``; ``weight_decay=0``
    is ``optax.adam``.  ``lr``: a float or a schedule ``step -> lr``."""

    state_key = "adam"   # its state's key in ``Optimizer.state``

    def __init__(self, lr: LR, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 1e-4):
        self.lr, self.b1, self.b2 = lr, b1, b2
        self.eps, self.weight_decay = eps, weight_decay

    def init(self, params: List[torch.Tensor]) -> Dict[str, Any]:
        return {"count": 0,
                "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def apply(self, params: List[torch.Tensor], grads: List[torch.Tensor],
              state: Dict[str, Any],
              delta_norms: Optional[List[torch.Tensor]] = None) -> None:
        count = state["count"] + 1
        c1 = 1.0 - self.b1 ** count
        c2 = 1.0 - self.b2 ** count
        step = -_lr_at(self.lr, state["count"])
        for p, g, mu, nu in zip(params, grads, state["mu"], state["nu"]):
            g = g.float()
            mu.mul_(self.b1).add_((1.0 - self.b1) * g)
            nu.mul_(self.b2).add_((1.0 - self.b2) * (g * g))
            u = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p
            _add_update(p, u * step, delta_norms)
        state["count"] = count


class SGD:
    """``optax.chain(add_decayed_weights(weight_decay), sgd(lr, momentum,
    nesterov))``; ``weight_decay=0`` is ``optax.sgd`` alone.  ``lr``: a
    float or a schedule ``step -> lr``."""

    state_key = "sgd"

    def __init__(self, lr: LR, momentum: float = 0.0, nesterov: bool = False,
                 weight_decay: float = 0.0):
        self.lr, self.momentum, self.nesterov = lr, momentum, nesterov
        self.weight_decay = weight_decay

    def init(self, params: List[torch.Tensor]) -> Dict[str, Any]:
        return {"count": 0, "trace": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def apply(self, params: List[torch.Tensor], grads: List[torch.Tensor],
              state: Dict[str, Any],
              delta_norms: Optional[List[torch.Tensor]] = None) -> None:
        step = -_lr_at(self.lr, state["count"])
        m = self.momentum
        for p, g, t in zip(params, grads, state["trace"]):
            g = g.float()
            if self.weight_decay:
                g = g + self.weight_decay * p
            t.mul_(m).add_(g)
            u = g + m * t if self.nesterov else t
            _add_update(p, u * step, delta_norms)
        state["count"] += 1


def state_layouts(tx: Union[AdamW, SGD], param_layouts: List[Any],
                  accumulate: int = 1, ema: bool = False) -> List[Any]:
    """The layout of each leaf of optax's state for the same update, in
    optax's leaf order: a param-shaped leaf (moment, momentum trace,
    ``MultiSteps`` accumulator, EMA shadow) takes its param's layout; a
    counter is replicated (None)."""
    if isinstance(tx, AdamW):
        inner = [None] + list(param_layouts) + list(param_layouts)
    else:
        inner = list(param_layouts) if tx.momentum else []
    if callable(tx.lr):   # scale_by_learning_rate's schedule count
        inner.append(None)
    if ema:
        inner += list(param_layouts) + [None]
    if accumulate > 1:    # MultiSteps: mini_step, gradient_step, ..., acc
        return [None, None] + inner + list(param_layouts)
    return inner


class Optimizer:
    """An AdamW or SGD update with the trainer's clipping, accumulation
    and parameter EMA, over a fixed list of parameter leaves; ``state`` is
    what a checkpoint keeps."""

    def __init__(self, tx: Union[AdamW, SGD], params: List[torch.Tensor],
                 clip_norm: Optional[float] = None,
                 accumulate: int = 1, ema_decay: Optional[float] = None,
                 norm_fn: Optional[Callable[[List[torch.Tensor]],
                                            torch.Tensor]] = None):
        self.tx, self.clip_norm, self.accumulate = tx, clip_norm, accumulate
        self.params = params
        # the global norm of the gradients this optimizer holds
        self.norm_fn = norm_fn or global_norm
        self.ema = None if ema_decay is None else EmaTracker(ema_decay)
        self.state: Dict[str, Any] = {tx.state_key: tx.init(params)}
        if accumulate > 1:
            self.state["mini_step"] = 0
            self.state["acc"] = [torch.zeros_like(p, dtype=torch.float32)
                                 for p in params]
        if self.ema is not None:
            self.state["ema"] = self.ema.init(params)

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor],
             norm: Optional[torch.Tensor] = None,
             delta_norms: Optional[List[torch.Tensor]] = None) -> bool:
        """One call per micro-step; True when it updated the parameters.
        ``norm``: the clip's norm of these gradients when the caller has
        it (unused under accumulation, which clips the window's mean).
        ``delta_norms``: a list that gets the L2 norm of each leaf's
        update (left empty when nothing is updated)."""
        if self.accumulate > 1:
            n = self.state["mini_step"]
            for acc, g in zip(self.state["acc"], grads):
                acc.add_((g.float() - acc) / (n + 1))
            if n + 1 < self.accumulate:
                self.state["mini_step"] = n + 1
                return False
            grads = self.state["acc"]
            norm = None
        if self.clip_norm:
            # a select on the card, not a host sync
            if norm is None:
                norm = self.norm_fn(grads)
            keep = norm < self.clip_norm
            grads = [torch.where(keep, g, g / norm * self.clip_norm)
                     for g in grads]
        self.tx.apply(self.params, grads, self.state[self.tx.state_key],
                      delta_norms)
        if self.ema is not None:
            self.ema.update(self.state["ema"], self.params)
        if self.accumulate > 1:
            self.state["mini_step"] = 0
            for acc in self.state["acc"]:
                acc.zero_()
        return True
