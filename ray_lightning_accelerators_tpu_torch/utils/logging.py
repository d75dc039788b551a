"""Loggers: metric sinks for the trainer.

Port of the JAX package's ``utils/logging.py`` (``Logger``,
``InMemoryLogger``, ``CSVLogger`` and the package logger ``log``; the
rank-stamped formatter and its knobs come with the runtime slice).  Values
arriving here are host floats: the trainer reads metrics off the card at
log boundaries only.
"""

from __future__ import annotations

import csv
import logging
import os
from typing import Dict, List

log = logging.getLogger("ray_lightning_accelerators_tpu_torch")


class Logger:
    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        raise NotImplementedError

    def finalize(self) -> None:
        pass


class InMemoryLogger(Logger):
    def __init__(self):
        self.history: List[Dict[str, float]] = []

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        row = dict(metrics)
        row["step"] = step
        self.history.append(row)


class CSVLogger(Logger):
    """metrics.csv under ``save_dir``, written at ``finalize`` (the schema
    grows as keys appear)."""

    def __init__(self, save_dir: str, name: str = "metrics.csv"):
        self.save_dir = save_dir
        self.path = os.path.join(save_dir, name)
        self._rows: List[Dict[str, float]] = []
        self._keys: List[str] = ["step"]

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        row = {"step": step, **metrics}
        for k in row:
            if k not in self._keys:
                self._keys.append(k)
        self._rows.append(row)

    def finalize(self) -> None:
        if not self._rows:
            return
        os.makedirs(self.save_dir, exist_ok=True)
        with open(self.path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self._keys)
            writer.writeheader()
            writer.writerows(self._rows)
