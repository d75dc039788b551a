"""Training state: everything a step mutates.

Port of the JAX package's ``core/state.py`` (``TrainState``).  Where the
JAX state is one immutable pytree donated to the compiled step, the port's
is a plain object whose tensors the step updates in place: the step
counter, the parameter tree (f32 leaf tensors with ``requires_grad``), the
optimizer (its state: AdamW moments and count, the accumulation buffer)
and a ``torch.Generator`` in place of the PRNG key.  A step's randomness
comes from a generator seeded with ``rng.initial_seed() + step``, the
counterpart of ``fold_in(rng, step)``: a resumed run draws the same
numbers at the same step.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .optim import Optimizer


@dataclasses.dataclass
class TrainState:
    step: int                  # optimizer steps taken (micro-steps too)
    params: Any                # parameter tree: dicts of leaf tensors
    opt: Optimizer             # update rule + its state (opt.state)
    rng: torch.Generator       # base generator; per-step seeds fold in step

    def step_generator(self, device: torch.device) -> torch.Generator:
        return torch.Generator(device=device).manual_seed(
            self.rng.initial_seed() + self.step)
