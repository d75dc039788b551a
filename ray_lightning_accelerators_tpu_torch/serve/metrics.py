"""Serving metrics: throughput, queue depth, and tail latency.

Port of ``ServeMetrics`` from the JAX package's ``serve/metrics.py``:
the counters and gauges of the engine (the decode loop, the speculative
lane, the KV handoff, the SLO tracker's gauges) and of the replica tier
(requeues, wedges, hedges, brownout sheds, revivals, scale moves, prefix
routes and the per-lane gauges the controller binds).  Every
latency family reports p50/p95/p99/max from ``utils.profiler``'s
reservoirs (the exact max survives eviction):

- **ttft** (time to first token): submit -> first token, queue wait
  included (the admission/backpressure signal);
- **queue_wait**: submit -> the moment prefill starts
  (``ttft = queue_wait + prefill``);
- **token_latency**: gap between a request's consecutive tokens;
- **decode_step** / **prefill**: engine phase timings.

All times are host clock around work that ended in a device sync.
Counters are exactly-once by construction, so ``completed + failed +
cancelled`` accounts for every admitted request.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

from ..utils.profiler import Profiler


class ServeMetrics:
    """Counters + latency reservoirs for one engine (or replica tier)."""

    TTFT = "serve/ttft"
    TOKEN = "serve/token_latency"
    STEP = "serve/decode_step"
    PREFILL = "serve/prefill"
    QUEUE = "serve/queue_wait"

    _COUNTERS = ("submitted", "completed", "failed", "cancelled",
                 "rejected", "requeued", "prefills", "tokens_generated",
                 "steps", "steps_batch_gt1", "wedge_events",
                 "pool_exhausted", "prefix_lookups", "prefix_hits",
                 "prefix_hit_blocks", "speculative_requests",
                 "speculative_rounds", "speculative_tokens_accepted",
                 "slo_violations", "slo_deadline_shed",
                 # the replica tier (serve/controller.py): re-dispatches
                 # of a slow replica's oldest chunk, those whose copy
                 # answered first, typed brownout sheds, breaker
                 # revivals and the autoscaler's replica count moves
                 "hedged", "hedge_wins", "brownout_shed", "revived",
                 "scale_ups", "scale_downs",
                 # tier routes that did / did not land a request on a
                 # replica holding its prefix run (hedges are misses)
                 "prefix_route_hits", "prefix_route_misses",
                 # prefill -> decode block handoffs completed, and the KV
                 # bytes they shipped through the object store
                 "kv_handoffs", "kv_handoff_bytes",
                 # one per decode_chunk_paged call (a streamed long prompt
                 # counts each of its chunks; a whole-prompt prefill 1)
                 "prefill_chunks",
                 # decode steps whose logits came back non-finite for a
                 # slot (that request fails typed and counts as failed)
                 "numeric_anomalies")

    # the fields the metrics registry types as gauges (live levels, not
    # monotone counters), the JAX package's lists
    POOL_GAUGES = ("block_pool_total", "block_pool_used",
                   "block_pool_cached", "block_pool_free",
                   "block_pool_occupancy", "block_len",
                   "hbm_cache_bytes", "hbm_used_bytes",
                   "dense_equivalent_bytes", "cache_waste_ratio",
                   "peak_used_blocks", "peak_concurrent")
    SLO_GAUGES = ("slo_burn_rate", "slo_window_observations")
    LANE_GAUGES = ("lane_prefill_replicas", "lane_decode_replicas",
                   "lane_prefill_inflight", "lane_decode_inflight")
    CHUNK_GAUGES = ("active_long_prefills", "longest_prefill_tokens")

    def __init__(self, profiler: Optional[Profiler] = None):
        self.profiler = profiler or Profiler()
        self._lock = threading.Lock()
        self._c: Dict[str, int] = {k: 0 for k in self._COUNTERS}
        self._max_batch = 0
        self._peak_used_blocks = 0
        self._peak_concurrent = 0
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None
        self._longest_prefill = 0
        self._queue_depth: Callable[[], int] = lambda: 0
        self._pool_gauges: Optional[Callable[[], Dict[str, Any]]] = None
        self._chunk_gauges: Optional[Callable[[], Dict[str, Any]]] = None
        self._slo_gauges: Optional[Callable[[], Dict[str, Any]]] = None
        self._lane_gauges: Optional[Callable[[], Dict[str, Any]]] = None

    # ------------------------------------------------------------------ #
    def bind_queue(self, depth_fn: Callable[[], int]) -> None:
        """Wire the live queue-depth gauge (the batcher owns the number)."""
        self._queue_depth = depth_fn

    def bind_pool(self, gauges_fn: Callable[[], Dict[str, Any]]) -> None:
        """Wire the paged engine's live block-pool gauges, merged into
        every snapshot."""
        self._pool_gauges = gauges_fn

    def bind_slo(self, gauges_fn: Callable[[], Dict[str, Any]]) -> None:
        """Wire the live SLO gauges (``SloTracker.gauges``:
        ``slo_burn_rate`` and the window size), merged into every
        snapshot.  Engines without an SLO policy never bind."""
        self._slo_gauges = gauges_fn

    def bind_lanes(self, gauges_fn: Callable[[], Dict[str, Any]]) -> None:
        """Wire the live per-lane occupancy gauges
        (``ReplicaController.lane_gauges``).  Merged outside the metrics
        lock like every bound gauge source, so the controller's lock never
        nests inside this one."""
        self._lane_gauges = gauges_fn

    def bind_chunks(self, gauges_fn: Callable[[], Dict[str, Any]]) -> None:
        """Wire the live chunked-prefill occupancy gauge."""
        self._chunk_gauges = gauges_fn

    def observe_long_prefill(self, prompt_tokens: int) -> None:
        """Record an admitted prompt length (high-watermark kept)."""
        with self._lock:
            self._longest_prefill = max(self._longest_prefill,
                                        int(prompt_tokens))

    def observe_pool(self, used_blocks: int, concurrent: int) -> None:
        """Pool-occupancy observation at every admit/retire: the snapshot
        keeps the peaks."""
        with self._lock:
            self._peak_used_blocks = max(self._peak_used_blocks,
                                         used_blocks)
            self._peak_concurrent = max(self._peak_concurrent, concurrent)

    # Every observe_* holds self._lock around both its reservoir write and
    # its counter update, and snapshot() reads under the same lock, so a
    # concurrent reader never sees one without the other.
    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._c[name] = self._c.get(name, 0) + n

    def observe_ttft(self, dt_s: float) -> None:
        with self._lock:
            self.profiler.observe(self.TTFT, dt_s)

    def observe_queue_wait(self, dt_s: float) -> None:
        with self._lock:
            self.profiler.observe(self.QUEUE, dt_s)

    def observe_token_latency(self, dt_s: float) -> None:
        with self._lock:
            self.profiler.observe(self.TOKEN, dt_s)

    def observe_prefill(self, dt_s: float) -> None:
        """One admission prefill; counts the request's first token and
        extends the busy window."""
        now = time.monotonic()
        with self._lock:
            self.profiler.observe(self.PREFILL, dt_s)
            self._c["prefills"] += 1
            self._c["tokens_generated"] += 1
            if self._t_first is None:
                self._t_first = now - dt_s
            self._t_last = now

    def observe_spec_round(self, dt_s: float, tokens: int) -> None:
        """One speculative draft/verify round that emitted ``tokens``
        tokens in one target pass: extends the busy window and the token
        count, counted under ``speculative_rounds`` rather than
        ``steps``."""
        now = time.monotonic()
        with self._lock:
            self.profiler.observe(self.STEP, dt_s)
            self._c["speculative_rounds"] += 1
            self._c["tokens_generated"] += tokens
            if self._t_first is None:
                self._t_first = now - dt_s
            self._t_last = now

    def observe_step(self, dt_s: float, active: int) -> None:
        """One continuous-batching decode step over ``active`` live slots."""
        now = time.monotonic()
        with self._lock:
            self.profiler.observe(self.STEP, dt_s)
            self._c["steps"] += 1
            if active > 1:
                self._c["steps_batch_gt1"] += 1
            self._c["tokens_generated"] += active
            self._max_batch = max(self._max_batch, active)
            if self._t_first is None:
                self._t_first = now - dt_s
            self._t_last = now

    # ------------------------------------------------------------------ #
    def snapshot(self) -> Dict[str, Any]:
        """Flat, JSON-able report.  ``throughput_tok_s`` divides generated
        tokens by the busy window (first step start -> last step end)."""

        def pct(name: str) -> Optional[Dict[str, float]]:
            row = s.get(name)
            if row is None:
                return None
            return {k: row[k] for k in ("count", "mean_s", "p50_s",
                                        "p95_s", "p99_s", "max_s")}

        with self._lock:
            s = self.profiler.summary()
            counters = dict(self._c)
            max_batch = self._max_batch
            peak_used = self._peak_used_blocks
            peak_conc = self._peak_concurrent
            longest_prefill = self._longest_prefill
            busy_s = ((self._t_last - self._t_first)
                      if self._t_first is not None
                      and self._t_last is not None else 0.0)
        out: Dict[str, Any] = dict(counters)
        out["max_batch"] = max_batch
        out["queue_depth"] = self._queue_depth()
        out["busy_s"] = busy_s
        if self._pool_gauges is not None:
            out.update(self._pool_gauges())
            out["peak_used_blocks"] = peak_used
            out["peak_concurrent"] = peak_conc
        if self._slo_gauges is not None:
            out.update(self._slo_gauges())
        if self._lane_gauges is not None:
            out.update(self._lane_gauges())
        if self._chunk_gauges is not None:
            out.update(self._chunk_gauges())
            out["longest_prefill_tokens"] = longest_prefill
        out["throughput_tok_s"] = (
            counters["tokens_generated"] / busy_s if busy_s > 0 else 0.0)
        out["ttft_s"] = pct(self.TTFT)
        out["queue_wait_s"] = pct(self.QUEUE)
        out["token_latency_s"] = pct(self.TOKEN)
        out["decode_step_s"] = pct(self.STEP)
        out["prefill_s"] = pct(self.PREFILL)
        return out

    def reset(self) -> None:
        """Clear every accumulated structure (counters, watermarks, busy
        window, latency reservoirs)."""
        with self._lock:
            self._c = {k: 0 for k in self._COUNTERS}
            self._max_batch = 0
            self._peak_used_blocks = 0
            self._peak_concurrent = 0
            self._longest_prefill = 0
            self._t_first = None
            self._t_last = None
            self.profiler.reset()

    def describe(self) -> str:
        """Human-readable snapshot and the profiler's latency table."""
        snap = self.snapshot()
        head = ", ".join(
            f"{k}={snap[k]}" for k in
            ("submitted", "completed", "failed", "cancelled", "rejected",
             "requeued", "steps", "steps_batch_gt1", "max_batch",
             "queue_depth"))
        tput = f"throughput={snap['throughput_tok_s']:.1f} tok/s"
        return f"{head}, {tput}\n{self.profiler.describe()}"
