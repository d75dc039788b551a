"""Learning-rate schedules: plain Python functions ``step -> lr``.

Port of the JAX package's ``utils/schedules.py`` with the same formulas
(optax's schedules there).  Pass one as a model's ``lr``; the optimizer
evaluates it at the update count before its increment, so update k
(0-based) uses ``sched(k)``, as optax does, and the trainer logs it as
``lr``.  Each schedule is a ``functools.partial`` of a module-level
function, so it travels to data-parallel ranks with the standard
``pickle``.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict

Schedule = Callable[[int], float]


def _constant_at(lr: float, step: int) -> float:
    return lr


def constant(lr: float) -> Schedule:
    return functools.partial(_constant_at, lr)


def _linear_at(init: float, end: float, steps: int, step: int) -> float:
    """optax.linear_schedule: init -> end over ``steps``, then end."""
    frac = 1.0 - min(max(step, 0), steps) / steps
    return (init - end) * frac + end


def _warmup_cosine_at(peak_lr: float, warmup_steps: int, decay_steps: int,
                      alpha: float, step: int) -> float:
    if step < warmup_steps:
        return _linear_at(0.0, peak_lr, max(warmup_steps, 1), step)
    frac = min(step - warmup_steps, decay_steps) / decay_steps
    cosine = 0.5 * (1.0 + math.cos(math.pi * frac))
    return peak_lr * ((1.0 - alpha) * cosine + alpha)


def warmup_cosine(peak_lr: float, total_steps: int, warmup_steps: int = 0,
                  end_lr: float = 0.0) -> Schedule:
    """Linear warmup from 0 to ``peak_lr`` then cosine decay to ``end_lr``
    at ``total_steps`` (optax.warmup_cosine_decay_schedule)."""
    decay_steps = total_steps - warmup_steps
    if decay_steps <= 0:
        raise ValueError(f"warmup_cosine: total_steps ({total_steps}) must "
                         f"exceed warmup_steps ({warmup_steps})")
    alpha = end_lr / peak_lr if peak_lr else 0.0
    return functools.partial(_warmup_cosine_at, peak_lr, warmup_steps,
                             decay_steps, alpha)


def _warmup_linear_at(peak_lr: float, total_steps: int, warmup_steps: int,
                      end_lr: float, step: int) -> float:
    if step < warmup_steps:
        return _linear_at(0.0, peak_lr, max(warmup_steps, 1), step)
    return _linear_at(peak_lr, end_lr, max(total_steps - warmup_steps, 1),
                      step - warmup_steps)


def warmup_linear(peak_lr: float, total_steps: int, warmup_steps: int = 0,
                  end_lr: float = 0.0) -> Schedule:
    """Linear warmup then linear decay to ``end_lr`` at ``total_steps``."""
    return functools.partial(_warmup_linear_at, peak_lr, total_steps,
                             warmup_steps, end_lr)


def _step_decay_at(init_lr: float, boundaries_and_scales: Dict[int, float],
                   step: int) -> float:
    lr = init_lr
    for boundary, scale in sorted(boundaries_and_scales.items()):
        if step >= boundary:
            lr *= scale
    return lr


def step_decay(init_lr: float,
               boundaries_and_scales: Dict[int, float]) -> Schedule:
    """Piecewise constant: multiply by ``scale`` once ``step`` passes each
    boundary (optax.piecewise_constant_schedule)."""
    return functools.partial(_step_decay_at, init_lr,
                             dict(boundaries_and_scales))


def _inverse_sqrt_at(peak_lr: float, w: int, step: int) -> float:
    s = float(max(step, 1))
    return peak_lr * min(s / w, math.sqrt(w / s))


def inverse_sqrt(peak_lr: float, warmup_steps: int) -> Schedule:
    """Noam schedule: linear warmup then 1/sqrt(step) decay."""
    return functools.partial(_inverse_sqrt_at, peak_lr,
                             max(warmup_steps, 1))


def _wsd_at(peak_lr: float, w: int, d: int, stable_end: int, end_lr: float,
            step: int) -> float:
    s = float(step)
    if s < w:
        return peak_lr * (s / max(w, 1) if w > 0 else 1.0)
    if s < stable_end:
        return peak_lr
    decay = 1.0 - (s - stable_end) / max(d, 1) * (1.0 - end_lr / peak_lr)
    return peak_lr * min(max(decay, end_lr / peak_lr), 1.0)


def wsd(peak_lr: float, total_steps: int, warmup_steps: int = 0,
        decay_steps: int = 0, end_lr: float = 0.0) -> Schedule:
    """Warmup-stable-decay: ramp up, hold ``peak_lr``, decay linearly over
    the final ``decay_steps`` to ``end_lr``."""
    w = max(warmup_steps, 0)
    d = max(decay_steps, 0)
    return functools.partial(_wsd_at, peak_lr, w, d,
                             max(total_steps - d, w), end_lr)
