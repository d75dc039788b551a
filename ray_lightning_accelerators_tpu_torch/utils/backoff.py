"""Exponential backoff with half-jitter.

Port of the JAX package's ``utils/backoff.py``: the one backoff of the
retry layers (``runtime/elastic.py``'s between-attempt restarts; the
serve tier's retries when it is ported).  The delay is ``min(cap, base *
2**(attempt-1))`` scaled by a uniform factor in ``[0.5, 1.0)``: it never
drops below half the deterministic schedule, and runners restarting off
one sick host still spread apart.  The jitter comes from ``rng``, a
zero-argument callable returning floats in ``[0, 1)``, by default the
``random`` module's; pass ``random.Random(seed).random`` for a seeded
sequence.

A dependency leaf: stdlib only.
"""

from __future__ import annotations

import random
from typing import Callable

DEFAULT_BACKOFF_CAP_S = 60.0


def backoff_delay_s(attempt: int, base_s: float,
                    cap_s: float = DEFAULT_BACKOFF_CAP_S,
                    rng: Callable[[], float] = random.random) -> float:
    """``min(cap, base * 2**(attempt-1))`` scaled by a uniform factor in
    [0.5, 1.0); ``attempt`` is 1-based (the first retry).  0 when
    ``base_s <= 0`` or ``attempt < 1``."""
    if base_s <= 0 or attempt < 1:
        return 0.0
    d = min(cap_s, base_s * (2.0 ** (attempt - 1)))
    return d * (0.5 + 0.5 * rng())
