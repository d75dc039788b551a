"""Loggers: metric sinks for the trainer, and the package's log format.

Port of the JAX package's ``utils/logging.py``: ``Logger``,
``InMemoryLogger``, ``CSVLogger``, the package logger ``log`` and its
rank-stamped formatter (``configure_logging``: the ``RLA_TPU_LOG_JSON``
and ``RLA_TPU_LOG_LEVEL`` knobs).  Values arriving at a logger are host
floats: the trainer reads metrics off the card at log boundaries only.
"""

from __future__ import annotations

import csv
import json as _json
import logging
import os
from typing import Dict, List, Optional

from ..analysis import knobs


class _RankFormatter(logging.Formatter):
    """Rank- and pid-stamped formatter.  The rank is the flight
    recorder's process identity (telemetry/recorder.py, configured when a
    worker boots), so in a fanned-out run every line says which rank said
    it.  ``json_mode`` (``RLA_TPU_LOG_JSON``) renders one JSON object per
    line (ts / level / logger / rank / pid / msg) for log shippers."""

    def __init__(self, json_mode: bool = False):
        super().__init__()
        self.json_mode = json_mode

    @staticmethod
    def _rank() -> str:
        try:
            # lazy: the recorder imports knobs, never this module
            from ..telemetry.recorder import current_rank
            rank = current_rank()
        except Exception:
            rank = None
        return "driver" if rank is None else str(rank)

    def format(self, record: logging.LogRecord) -> str:
        rank = self._rank()
        if self.json_mode:
            out = {"ts": round(record.created, 3),
                   "level": record.levelname,
                   "logger": record.name,
                   "rank": rank,
                   "pid": record.process,
                   "msg": record.getMessage()}
            if record.exc_info:
                out["exc"] = self.formatException(record.exc_info)
            if record.stack_info:
                out["stack"] = self.formatStack(record.stack_info)
            return _json.dumps(out)
        msg = (f"[{record.levelname} rla-tpu {rank}:{record.process}] "
               f"{record.getMessage()}")
        if record.exc_info:
            msg = f"{msg}\n{self.formatException(record.exc_info)}"
        if record.stack_info:
            msg = f"{msg}\n{self.formatStack(record.stack_info)}"
        return msg


log = logging.getLogger("ray_lightning_accelerators_tpu_torch")


def configure_logging(json_mode: Optional[bool] = None) -> None:
    """(Re)install the package handler and formatter.  ``json_mode``
    None reads the ``RLA_TPU_LOG_JSON`` knob; runs once at import and
    again whenever a caller flips the knob."""
    if json_mode is None:
        json_mode = knobs.get_bool("RLA_TPU_LOG_JSON", False)
    handler = next((h for h in log.handlers
                    if isinstance(h, logging.StreamHandler)), None)
    if handler is None:
        handler = logging.StreamHandler()
        log.addHandler(handler)
    handler.setFormatter(_RankFormatter(json_mode=json_mode))
    level = knobs.get_str("RLA_TPU_LOG_LEVEL", "WARNING").upper()
    if not isinstance(logging.getLevelName(level), int):
        # a mistyped level must not crash at import or boot
        log.setLevel("WARNING")
        log.warning("bad RLA_TPU_LOG_LEVEL=%r; using WARNING", level)
    else:
        log.setLevel(level)


if not log.handlers:
    configure_logging()


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
