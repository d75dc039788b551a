"""Deterministic seeding.

Port of the JAX package's ``utils/seed.py``: ``seed_everything`` seeds
Python's and numpy's generators (and torch's) and exports the seed for
child processes; where the JAX package returns a PRNG key
(``rng_from_seed``), the port returns a ``torch.Generator``.
"""

from __future__ import annotations

import os
import random
from typing import Optional

import numpy as np
import torch

from .logging import log

SEED_ENV_VARS = ("RLA_TPU_GLOBAL_SEED", "PL_GLOBAL_SEED")


def seed_everything(seed: Optional[int] = None) -> int:
    """Seed python/numpy/torch RNGs and export the seed.  ``None`` reads
    ``RLA_TPU_GLOBAL_SEED``, then ``PL_GLOBAL_SEED`` (a malformed value
    warns and counts as 0), else 0."""
    if seed is None:
        for var in SEED_ENV_VARS:
            raw = os.environ.get(var)
            if raw:
                try:
                    seed = int(raw)
                except ValueError:
                    log.warning("bad %s=%r; using 0", var, raw)
                    seed = 0
                break
        else:
            seed = 0
    random.seed(seed)
    np.random.seed(seed % (2 ** 32))
    torch.manual_seed(seed)
    for var in SEED_ENV_VARS:
        os.environ[var] = str(seed)
    return seed


def generator_from_seed(seed: int, device=None) -> torch.Generator:
    """The port's counterpart of ``rng_from_seed``: a seeded generator on
    ``device`` (the CPU when None)."""
    return torch.Generator(device=device or "cpu").manual_seed(int(seed))
