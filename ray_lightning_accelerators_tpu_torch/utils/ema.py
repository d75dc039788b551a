"""Exponential moving average of the parameters.

Port of the JAX package's ``utils/ema.py``.  There the tracker is an optax
transformation chained after the optimizer, inside ``MultiSteps``, whose
state shadows the updated parameters.  Here ``EmaTracker`` is the same
arithmetic over the port's parameter leaves, and ``core.optim.Optimizer``
applies it after each optimizer update (never on an accumulation
micro-step), keeping the shadow in ``Optimizer.state["ema"]`` so that a
checkpoint carries it.  The shadow starts as a copy of the parameters
(not zeros with a bias correction), so reading it is a plain state read.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch


class EmaTracker:
    """``ema = decay * ema + (1 - decay) * p`` after every update, with
    ``decay`` and ``1 - decay`` rounded to f32 as the JAX tracker rounds
    them: two f32 products and one f32 sum a leaf."""

    def __init__(self, decay: float = 0.999):
        self.decay = float(decay)

    @staticmethod
    def init(params: List[torch.Tensor]) -> List[torch.Tensor]:
        # a real copy: the shadow must not alias the parameters
        return [p.detach().clone() for p in params]

    @torch.no_grad()
    def update(self, ema: List[torch.Tensor],
               params: List[torch.Tensor]) -> None:
        """Move the shadow ``ema`` towards ``params``, in place."""
        d = np.float32(self.decay)
        c = float(np.float32(1.0) - d)
        for e, p in zip(ema, params):
            e.mul_(float(d)).add_(p.float() * c)
