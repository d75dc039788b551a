"""Learning-rate schedules: plain Python functions ``step -> lr``.

Port of the JAX package's ``utils/schedules.py`` with the same formulas
(optax's schedules there).  Pass one as a model's ``lr``; the optimizer
evaluates it at the update count before its increment, so update k
(0-based) uses ``sched(k)``, as optax does, and the trainer logs it as
``lr``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

Schedule = Callable[[int], float]


def constant(lr: float) -> Schedule:
    return lambda step: lr


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule: init -> end over ``steps``, then end."""
    def sched(step):
        frac = 1.0 - min(max(step, 0), steps) / steps
        return (init - end) * frac + end
    return sched


def warmup_cosine(peak_lr: float, total_steps: int, warmup_steps: int = 0,
                  end_lr: float = 0.0) -> Schedule:
    """Linear warmup from 0 to ``peak_lr`` then cosine decay to ``end_lr``
    at ``total_steps`` (optax.warmup_cosine_decay_schedule)."""
    decay_steps = total_steps - warmup_steps
    if decay_steps <= 0:
        raise ValueError(f"warmup_cosine: total_steps ({total_steps}) must "
                         f"exceed warmup_steps ({warmup_steps})")
    warm = _linear(0.0, peak_lr, max(warmup_steps, 1))
    alpha = end_lr / peak_lr if peak_lr else 0.0

    def sched(step):
        if step < warmup_steps:
            return warm(step)
        frac = min(step - warmup_steps, decay_steps) / decay_steps
        cosine = 0.5 * (1.0 + math.cos(math.pi * frac))
        return peak_lr * ((1.0 - alpha) * cosine + alpha)
    return sched


def warmup_linear(peak_lr: float, total_steps: int, warmup_steps: int = 0,
                  end_lr: float = 0.0) -> Schedule:
    """Linear warmup then linear decay to ``end_lr`` at ``total_steps``."""
    warm = _linear(0.0, peak_lr, max(warmup_steps, 1))
    decay = _linear(peak_lr, end_lr, max(total_steps - warmup_steps, 1))
    return lambda step: (warm(step) if step < warmup_steps
                         else decay(step - warmup_steps))


def step_decay(init_lr: float,
               boundaries_and_scales: Dict[int, float]) -> Schedule:
    """Piecewise constant: multiply by ``scale`` once ``step`` passes each
    boundary (optax.piecewise_constant_schedule)."""
    def sched(step):
        lr = init_lr
        for boundary, scale in sorted(boundaries_and_scales.items()):
            if step >= boundary:
                lr *= scale
        return lr
    return sched


def inverse_sqrt(peak_lr: float, warmup_steps: int) -> Schedule:
    """Noam schedule: linear warmup then 1/sqrt(step) decay."""
    w = max(warmup_steps, 1)

    def sched(step):
        s = float(max(step, 1))
        return peak_lr * min(s / w, math.sqrt(w / s))
    return sched


def wsd(peak_lr: float, total_steps: int, warmup_steps: int = 0,
        decay_steps: int = 0, end_lr: float = 0.0) -> Schedule:
    """Warmup-stable-decay: ramp up, hold ``peak_lr``, decay linearly over
    the final ``decay_steps`` to ``end_lr``."""
    w = max(warmup_steps, 0)
    d = max(decay_steps, 0)
    stable_end = max(total_steps - d, w)

    def sched(step):
        s = float(step)
        if s < w:
            return peak_lr * (s / max(w, 1) if w > 0 else 1.0)
        if s < stable_end:
            return peak_lr
        decay = 1.0 - (s - stable_end) / max(d, 1) * (1.0 - end_lr / peak_lr)
        return peak_lr * min(max(decay, end_lr / peak_lr), 1.0)
    return sched
