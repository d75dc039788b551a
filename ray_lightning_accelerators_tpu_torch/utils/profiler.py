"""Latency reservoirs with percentile summaries.

Port of the part of the JAX package's ``utils/profiler.py``
that ``serve.metrics.ServeMetrics`` uses: ``Profiler.observe`` records an
externally timed duration under a name, and ``summary`` reports count,
total, mean, p50/p95/p99 from a uniform reservoir plus the exact running
max (a tail is judged on its worst request, which the reservoir may have
evicted).  Spans, device traces and the cross-process merge come with the
telemetry slice, where CUDA events and ``torch.profiler`` replace XPlane.
"""

from __future__ import annotations

import math
import random
import threading
from typing import Dict, List


class _SpanStat:
    __slots__ = ("count", "total", "samples", "maxv", "_rng")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.samples: List[float] = []  # uniform reservoir for percentiles
        self.maxv = 0.0
        self._rng = random.Random(0x5EED)

    def add(self, dt: float, cap: int = 4096) -> None:
        self.count += 1
        self.total += dt
        if dt > self.maxv:
            self.maxv = dt
        # reservoir sampling: every observation has equal probability of
        # being in the percentile sample
        if len(self.samples) < cap:
            self.samples.append(dt)
        else:
            j = self._rng.randrange(self.count)
            if j < cap:
                self.samples[j] = dt


class Profiler:
    """Named duration statistics (host clock)."""

    def __init__(self):
        self._stats: Dict[str, _SpanStat] = {}
        self._lock = threading.Lock()

    def observe(self, name: str, dt_s: float) -> None:
        """Record an externally timed duration under ``name``."""
        with self._lock:
            self._stats.setdefault(name, _SpanStat()).add(dt_s)

    def summary(self) -> Dict[str, Dict[str, float]]:
        """name -> {count, total_s, mean_s, p50_s, p95_s, p99_s, max_s}."""
        out: Dict[str, Dict[str, float]] = {}
        with self._lock:
            items = [(name, st.count, st.total, sorted(st.samples),
                      st.maxv) for name, st in self._stats.items()]
        for name, count, total, xs, maxv in items:
            pick = (lambda q: xs[min(len(xs) - 1,
                                     int(math.ceil(q * len(xs))) - 1)]
                    if xs else 0.0)
            out[name] = {
                "count": count,
                "total_s": total,
                "mean_s": total / max(count, 1),
                "p50_s": pick(0.50),
                "p95_s": pick(0.95),
                "p99_s": pick(0.99),
                "max_s": maxv,
            }
        return out

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()
