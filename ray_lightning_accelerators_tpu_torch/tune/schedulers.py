"""Trial schedulers: early-stopping policies over reported results.

Port of the JAX package's ``tune/schedulers.py``, decision for decision:

- ``FIFOScheduler`` runs every trial to completion;
- ``ASHAScheduler``, asynchronous successive halving: rungs at
  ``grace_period * reduction_factor^k``; a trial reaching a rung stops
  unless its metric is in the best ``1/reduction_factor`` of everything
  recorded at that rung so far (it continues while the rung holds fewer
  than ``reduction_factor`` results);
- ``MedianStoppingRule`` stops a trial whose metric is worse than the
  median of all metrics recorded at the same iteration.

Stopping is cooperative: ``tune.run`` marks the trial, and the tune
callbacks set ``trainer.should_stop`` at the next report boundary, so
training ends cleanly (checkpoints and results intact), in the ranks
too (``tune/callbacks.py``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional


class TrialScheduler:
    CONTINUE = "CONTINUE"
    STOP = "STOP"

    metric: Optional[str] = None
    mode: str = "min"

    def set_search_properties(self, metric: Optional[str],
                              mode: Optional[str]) -> None:
        """Inherit metric/mode from tune.run when not set explicitly."""
        if self.metric is None and metric is not None:
            self.metric = metric
        if mode:
            self.mode = mode

    def on_result(self, trial, result: Dict[str, Any]) -> str:
        return self.CONTINUE


class FIFOScheduler(TrialScheduler):
    """Run every trial to completion (Ray Tune's default policy)."""


class ASHAScheduler(TrialScheduler):
    def __init__(self, metric: Optional[str] = None, mode: str = "min",
                 max_t: int = 100, grace_period: int = 1,
                 reduction_factor: int = 4):
        if reduction_factor < 2:
            raise ValueError("reduction_factor must be >= 2")
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.grace_period = max(1, grace_period)
        self.rf = reduction_factor
        # rung iteration levels: grace, grace*rf, grace*rf^2, ... < max_t
        self.rungs: List[int] = []
        t = self.grace_period
        while t < max_t:
            self.rungs.append(t)
            t *= self.rf
        self._recorded: Dict[int, List[float]] = {r: [] for r in self.rungs}

    def _better(self, a: float, b: float) -> bool:
        return a > b if self.mode == "max" else a < b

    def on_result(self, trial, result: Dict[str, Any]) -> str:
        if self.metric is None or self.metric not in result:
            return self.CONTINUE
        t = result.get("training_iteration", 0)
        if t >= self.max_t:
            return self.STOP
        if t not in self._recorded:
            return self.CONTINUE
        score = float(result[self.metric])
        scores = self._recorded[t]
        scores.append(score)
        # keep the best 1/rf fraction at this rung; judge optimistically
        # while the rung holds fewer than rf results (standard async ASHA)
        if len(scores) < self.rf:
            return self.CONTINUE
        ranked = sorted(scores, reverse=(self.mode == "max"))
        k = max(1, int(math.floor(len(ranked) / self.rf)))
        cutoff = ranked[k - 1]
        if self._better(score, cutoff) or score == cutoff:
            return self.CONTINUE
        return self.STOP


class MedianStoppingRule(TrialScheduler):
    def __init__(self, metric: Optional[str] = None, mode: str = "min",
                 grace_period: int = 1):
        self.metric = metric
        self.mode = mode
        self.grace_period = max(1, grace_period)
        self._by_iter: Dict[int, List[float]] = {}

    def on_result(self, trial, result: Dict[str, Any]) -> str:
        if self.metric is None or self.metric not in result:
            return self.CONTINUE
        t = result.get("training_iteration", 0)
        score = float(result[self.metric])
        history = self._by_iter.setdefault(t, [])
        history.append(score)
        if t <= self.grace_period or len(history) < 3:
            return self.CONTINUE
        ranked = sorted(history)
        median = ranked[len(ranked) // 2]
        worse = score > median if self.mode == "min" else score < median
        return self.STOP if worse else self.CONTINUE
