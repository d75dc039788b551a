"""Training state: everything a step mutates.

Port of the JAX package's ``core/state.py`` (``TrainState``).  Where the
JAX state is one immutable pytree donated to the compiled step, the port's
is a plain object whose tensors the step updates in place: the step
counter, the parameter tree (f32 leaf tensors with ``requires_grad``), the
optimizer (its state: AdamW moments and count, the accumulation buffer)
and a ``torch.Generator`` in place of the PRNG key.  A step's randomness
comes from a generator seeded with ``rng.initial_seed() + step``, the
counterpart of ``fold_in(rng, step)``: a resumed run draws the same
numbers at the same step.  Data-parallel rank r adds ``r << 32``, so
the ranks draw independent masks for their rows.

Under ``Trainer(grad_compression=...)`` two more trees ride the state,
as in the JAX package (None otherwise): ``residual``, this rank's
error-feedback residuals (one f32 buffer per leaf: the whole leaf, the
owned chunk under FSDP, or a ``[1]`` placeholder), and ``grad_accum``
for ``accumulate_grad_batches > 1`` (the local gradients' window sum
under plain data parallelism, the owned slices' sum of the exchanged
gradients under FSDP).  Under FSDP ``params`` holds this rank's slice of
each sharded leaf.

With the numeric guardian on (``Trainer(guard=...)``, the default),
``guard_ema`` holds the guard vector (``runtime/guardian.py``): f32
``[GUARD_WIDTH]`` on the rank's device, folded by every step; None with
``guard=None``.
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
    residual: Any = None       # per-rank error-feedback residuals
    grad_accum: Any = None     # per-rank gradient accumulators
    guard_ema: Any = None      # the guard vector (None: guard off)

    def step_generator(self, device: torch.device,
                       rank: int = 0) -> torch.Generator:
        return torch.Generator(device=device).manual_seed(
            self.rng.initial_seed() + self.step + (rank << 32))
