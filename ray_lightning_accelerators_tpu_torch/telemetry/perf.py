"""The goodput ledger: where a retrying run's wall time went.

Port of ``GoodputLedger`` from the JAX package's ``telemetry/perf.py``
(its ``:477``), which ``runtime/elastic.py`` feeds.  The rest of that
file (``StepTimeline``, ``HbmLedger``, ``PerfObservatory``) comes with
the telemetry slice 5d.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Mapping, Optional


class GoodputLedger:
    """A run's wall time split into productive step time and what a
    retrying, checkpointing, preemptible run spends around it.

    The driver (``ElasticRunner``) accounts what it sees: the restart
    and boot (or ``resize``), the backoff, the wait before a wedge was
    detected.  A worker's fit may report its interior split:
    ``absorb_timeline`` maps a step timeline snapshot's phases to
    categories, ``absorb_profiler`` a profiler's exported spans,
    ``absorb_events`` a flight-recorder timeline's drains.
    ``goodput_fraction`` is productive / wall; what nothing accounted is
    ``unattributed_s``, never folded into the goodput."""

    # timeline phase / profiler span -> goodput category
    _PHASE_MAP = {"h2d": "productive", "compute": "productive",
                  "other": "productive", "compile": "compile",
                  "ckpt": "checkpoint", "drain": "drain",
                  "validation": "productive"}
    _SPAN_MAP = {"train_step": "productive", "h2d": "productive",
                 "data_fetch": "productive", "validation": "productive",
                 "ckpt": "checkpoint", "drain": "drain"}

    def __init__(self):
        self._lock = threading.Lock()
        self._t0: Optional[float] = None
        self._wall: Optional[float] = None
        self._seconds: Dict[str, float] = {}
        self._preemptions = 0
        self._attempts = 0

    def run_begin(self) -> None:
        """Stamp the run's start.  After a finished run it starts a new
        one (everything reset); while a run is open it does nothing."""
        with self._lock:
            if self._t0 is not None and self._wall is None:
                return
            if self._wall is not None:
                self._seconds = {}
                self._attempts = 0
                self._preemptions = 0
            self._t0 = time.monotonic()
            self._wall = None

    def run_end(self) -> None:
        with self._lock:
            if self._t0 is not None:
                self._wall = time.monotonic() - self._t0

    def account(self, category: str, seconds: float) -> None:
        with self._lock:
            self._seconds[category] = self._seconds.get(category, 0.0) \
                + max(0.0, float(seconds))

    @contextmanager
    def measure(self, category: str):
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.account(category, time.monotonic() - t0)

    def note_attempt(self) -> None:
        with self._lock:
            self._attempts += 1

    def note_preemption(self) -> None:
        with self._lock:
            self._preemptions += 1

    def absorb_timeline(self, snapshot: Mapping[str, Any]) -> None:
        """Fold a step timeline snapshot's phase totals (in-step and
        between steps) into categories."""
        for fam in ("phases", "between_step_phases"):
            for name, row in (snapshot.get(fam) or {}).items():
                cat = self._PHASE_MAP.get(name)
                if cat:
                    self.account(cat, float(row.get("total_s", 0.0)))

    def absorb_profiler(self, profiler: Any) -> None:
        """Fold a profiler's (or its ``export_state()`` dict's) span
        totals into categories."""
        state = profiler.export_state() if hasattr(profiler,
                                                   "export_state") \
            else profiler
        for name, row in (state.get("stats") or {}).items():
            cat = self._SPAN_MAP.get(name.split("/")[-1])
            if cat:
                self.account(cat, float(row.get("total", 0.0)))

    def absorb_events(self, events: Any) -> None:
        """A drain from a flight-recorder timeline: a ``preempt_drain``
        event and the ``emergency_checkpoint`` after it bound it."""
        t_drain = None
        for e in events or ():
            kind = e.get("kind")
            if kind == "preempt_drain":
                t_drain = e.get("ts")
            elif kind == "emergency_checkpoint" and t_drain is not None:
                ts = e.get("ts")
                if ts is not None and ts >= t_drain:
                    self.account("drain", ts - t_drain)
                t_drain = None

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            wall = self._wall
            if wall is None and self._t0 is not None:
                wall = time.monotonic() - self._t0
            wall = wall or 0.0
            seconds = {k: round(v, 6)
                       for k, v in sorted(self._seconds.items())}
            attempts, preemptions = self._attempts, self._preemptions
        accounted = sum(seconds.values())
        productive = seconds.get("productive", 0.0)
        return {
            "wall_s": round(wall, 6),
            "seconds": seconds,
            "unattributed_s": round(max(0.0, wall - accounted), 6),
            # clamped: N ranks' interior seconds against one driver wall
            # can pass 1.0; productive_s stays raw
            "goodput_fraction": round(min(1.0, productive / wall), 4)
            if wall > 0 else 0.0,
            "productive_s": round(productive, 6),
            "attempts": attempts,
            "preemptions": preemptions,
        }
