"""Perf observatory: where each millisecond and each device byte went.

Port of the JAX package's ``telemetry/perf.py``.  Three ledgers, all
exported through :class:`~.registry.MetricsRegistry` (JSON and
Prometheus) and embedded in ``run_report.json``:

- :class:`StepTimeline`: each step's host wall time split into named
  phases (``h2d``, ``compile``, ``compute``, ``validation``, ``ckpt``,
  ``drain``, ...) by hooks in ``core/trainer.py`` and
  ``serve/engine.py``, the remainder reported as ``other``.  The eager
  step is one phase from the host; the analytic wire split of the
  gradient exchange rides along in the snapshot, and
  :func:`exposed_comm_crosscheck` turns a tree-vs-scan A/B measurement
  into a measured exposed-comm fraction beside the analytic one.
- :class:`HbmLedger`: per-pool device-memory attribution (params,
  optimizer state, exchange buffers, device dataset cache, prefetch
  buffers, the object store's shm) against the process's total, with
  watermarks sampled off the hot path (throttled) and a leak alarm that
  emits one ``hbm_leak`` flight-recorder event per growth streak.
- :class:`GoodputLedger`: wall time across ``ElasticRunner`` attempts,
  productive step time against compile, checkpoint, drain, restart and
  wedge-detection wait.

Host scalars only, bounded memory (aggregates and a fixed ring of recent
steps), and a per-observation cost in the flight recorder's <50 us
budget.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Mapping, Optional

from ..analysis import knobs
from . import recorder as recorder_lib

HBM_SAMPLE_S_ENV = "RLA_TPU_PERF_HBM_SAMPLE_S"
LEAK_SAMPLES_ENV = "RLA_TPU_PERF_LEAK_SAMPLES"
LEAK_MIN_BYTES_ENV = "RLA_TPU_PERF_LEAK_MIN_BYTES"
TIMELINE_RING_ENV = "RLA_TPU_PERF_TIMELINE_RING"

DEFAULT_HBM_SAMPLE_S = 2.0
DEFAULT_LEAK_SAMPLES = 8
DEFAULT_LEAK_MIN_BYTES = 32 * 1024 * 1024
DEFAULT_TIMELINE_RING = 64

# the phase vocabulary: everything the framework itself observes, so
# dashboards have one name list to key on (emit sites may add phases)
PHASE_KINDS = frozenset({
    # trainer fit loop (core/trainer.py)
    "h2d", "compute", "compile", "ckpt", "drain", "validation", "other",
    # serve engine loop (serve/engine.py)
    "prefill", "decode",
    # MPMD pipeline driver (parallel/mpmd/driver.py): step wall minus
    # mean per-member busy, the schedule's idle fraction as a phase
    "pipeline_bubble",
})

GOODPUT_CATEGORIES = ("productive", "compile", "checkpoint", "drain",
                      "restart", "wedge_wait")


def tree_nbytes(tree: Any) -> int:
    """Total bytes of the tensors (and numpy arrays) in a nested
    dict / list / tuple, read from their shapes: never a device sync.
    Other leaves count 0."""
    if tree is None:
        return 0
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    nbytes = getattr(tree, "nbytes", None)
    if nbytes is not None:
        try:
            return int(nbytes)
        except (TypeError, ValueError):
            return 0
    numel = getattr(tree, "numel", None)
    size = getattr(tree, "element_size", None)
    if callable(numel) and callable(size):
        return int(numel()) * int(size())
    return 0


def placed_bytes_total(device: Any = None,
                       pools_total: Optional[Callable[[], int]] = None
                       ) -> int:
    """The process's placed device bytes for a fit on ``device``.  On a
    card, the caching allocator's allocated bytes there
    (``torch.cuda.memory_allocated``), never read off the CPU.  On the
    CPU PyTorch keeps no list of live tensors (the JAX package sums
    ``jax.live_arrays()`` there), so the total is what the registered
    pools hold (``pools_total``, the ledger's own sum) and ``other``
    reads 0; ``gc`` is not walked on the hot path.  0 without either."""
    import torch

    if device is None and torch.cuda.is_available() \
            and torch.cuda.is_initialized():
        device = torch.device("cuda", torch.cuda.current_device())
    if device is not None and torch.device(device).type == "cuda":
        return int(torch.cuda.memory_allocated(torch.device(device)))
    return int(pools_total()) if pools_total is not None else 0


# --------------------------------------------------------------------- #
# Step timeline                                                          #
# --------------------------------------------------------------------- #
class StepTimeline:
    """Per-step phase decomposition of a host-driven loop (the JAX
    package's, line for line).

    One driving thread brackets each step with ``step_begin()`` /
    ``step_end()`` and wraps its phases in ``phase(name)`` (or reports
    externally timed durations via ``observe``).  ``step_end`` computes
    the step's wall time and attributes the un-covered remainder to
    ``other`` — so in-step phases sum to the measured step wall by
    construction, and a growing ``other`` means the hooks are missing
    something, visibly.  Phases observed OUTSIDE a step bracket
    (checkpoint saves at epoch boundaries, preemption drains) accumulate
    in the same totals under ``in_step=False``.

    ``compile_seconds_fn`` (``analysis.compile_guard.compile_seconds``:
    the port's nvcc and g++ builds) is snapshotted at each step
    boundary; build time landing inside a step is split out of the
    containing measured phase (a first-use step reads as compile +
    compute, not one opaque blob).  Memory is bounded: per-phase aggregates plus a fixed ring
    of the most recent per-step rows.
    """

    def __init__(self, ring: Optional[int] = None,
                 compile_seconds_fn: Optional[Callable[[], float]] = None):
        if ring is None:
            ring = knobs.get_int(TIMELINE_RING_ENV, DEFAULT_TIMELINE_RING)
        self.ring_capacity = max(1, int(ring))
        self._compile_fn = compile_seconds_fn
        self._lock = threading.Lock()
        # phase -> [count, total_s]; in-step and out-of-step tracked
        # separately so the sum-to-wall invariant stays checkable
        self._phases: Dict[str, List[float]] = {}
        self._out_phases: Dict[str, List[float]] = {}
        self._recent: List[Dict[str, Any]] = []
        self._steps = 0
        self._wall_total = 0.0
        self._comms: Optional[Dict[str, Any]] = None
        # live step bracket: owned by the thread that called
        # step_begin — foreign threads (a serve loop sharing the
        # timeline) must not write into an open train step
        self._t_step: Optional[float] = None
        self._step_thread: Optional[int] = None
        self._step_phases: Dict[str, float] = {}
        self._compile_at_begin = 0.0

    def __getstate__(self):
        """Ship-able across processes (the Trainer pickles itself into
        workers): locks and accumulated state stay behind."""
        return {"ring": self.ring_capacity}

    def __setstate__(self, state):
        self.__init__(ring=state["ring"])

    # -- hooks ----------------------------------------------------------- #
    def step_begin(self) -> None:
        self._step_phases = {}
        self._step_thread = threading.get_ident()
        self._t_step = time.perf_counter()
        if self._compile_fn is not None:
            self._compile_at_begin = self._compile_fn()

    def observe(self, name: str, dt_s: float) -> None:
        """Report one externally timed phase duration — attributed to
        the open step only from the thread that OPENED it; any other
        thread (a serve loop sharing the timeline with a fitting
        trainer) lands in the between-step totals instead of corrupting
        the open step's row."""
        if self._t_step is not None \
                and self._step_thread == threading.get_ident():
            # bracket-owner fast path: single-threaded by construction,
            # so the dict update needs no lock
            self._step_phases[name] = self._step_phases.get(name, 0.0) \
                + dt_s
            return
        with self._lock:
            row = self._out_phases.setdefault(name, [0, 0.0])
            row[0] += 1
            row[1] += dt_s

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(name, time.perf_counter() - t0)

    def step_end(self) -> None:
        t0 = self._t_step
        if t0 is None or self._step_thread != threading.get_ident():
            return  # no open bracket, or not the thread that opened it
        wall = time.perf_counter() - t0
        phases = self._step_phases
        self._t_step = None
        self._step_thread = None
        if self._compile_fn is not None:
            dc = self._compile_fn() - self._compile_at_begin
            if dc > 0:
                # compile happened inside one of the measured phases
                # (warmup dispatch): split it out so the phase reads as
                # what it was, never double-counted past the wall
                host = max(phases, key=phases.get) if phases else None
                dc = min(dc, phases.get(host, wall)) if host else \
                    min(dc, wall)
                if host:
                    phases[host] = phases[host] - dc
                phases["compile"] = phases.get("compile", 0.0) + dc
        other = wall - sum(phases.values())
        if other > 0:
            phases["other"] = phases.get("other", 0.0) + other
        with self._lock:
            self._steps += 1
            self._wall_total += wall
            for name, dt in phases.items():
                row = self._phases.setdefault(name, [0, 0.0])
                row[0] += 1
                row[1] += dt
            self._recent.append(
                {"step": self._steps, "wall_s": round(wall, 6),
                 "phases": {k: round(v, 6) for k, v in phases.items()}})
            if len(self._recent) > self.ring_capacity:
                del self._recent[0]

    def observe_scan_epoch(self, wall_s: float, n_steps: int) -> None:
        """The whole-epoch path runs its steps with no host work between
        them, so per-step phases are not taken there: the epoch's wall
        is attributed to ``compute`` across ``n_steps`` equal steps (one
        coarse ring row marks the batch)."""
        n = max(1, int(n_steps))
        with self._lock:
            self._steps += n
            self._wall_total += wall_s
            row = self._phases.setdefault("compute", [0, 0.0])
            row[0] += n
            row[1] += wall_s
            self._recent.append(
                {"step": self._steps, "wall_s": round(wall_s, 6),
                 "scanned_steps": n,
                 "phases": {"compute": round(wall_s, 6)}})
            if len(self._recent) > self.ring_capacity:
                del self._recent[0]

    def attach_comms(self, report: Optional[Mapping[str, Any]]) -> None:
        """Carry the analytic wire split (``wire_bytes_per_step``) in
        the snapshot, so the exported timeline states the exchange's
        exposed/hidden byte claim next to the measured phase times."""
        with self._lock:
            self._comms = dict(report) if report else None

    # -- export ---------------------------------------------------------- #
    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            phases = {k: {"count": int(c), "total_s": round(t, 6)}
                      for k, (c, t) in sorted(self._phases.items())}
            out_phases = {k: {"count": int(c), "total_s": round(t, 6)}
                          for k, (c, t) in
                          sorted(self._out_phases.items())}
            steps, wall = self._steps, self._wall_total
            recent = list(self._recent)
            comms = dict(self._comms) if self._comms else None
        in_step_total = sum(p["total_s"] for p in phases.values())
        attributed = sum(p["total_s"] for k, p in phases.items()
                         if k != "other")
        snap: Dict[str, Any] = {
            "steps": steps,
            "step_wall_total_s": round(wall, 6),
            "mean_step_ms": round(wall / steps * 1e3, 3) if steps else 0.0,
            "phases": phases,
            "between_step_phases": out_phases,
            # phases sum to wall by construction (`other` absorbs the
            # remainder); both fractions exported so a drifting hook
            # shows up as coverage loss, not silence
            "phase_sum_over_wall": round(in_step_total / wall, 4)
            if wall else 0.0,
            "attributed_fraction": round(attributed / wall, 4)
            if wall else 0.0,
            "recent_steps": recent,
        }
        if comms is not None:
            snap["comms_per_step"] = comms
            exch = comms.get("exchange_bytes_per_step") or 0
            if exch:
                snap["analytic_exposed_comm_fraction"] = round(
                    (comms.get("exposed_bytes_per_step", exch)) / exch, 4)
        return snap


# --------------------------------------------------------------------- #
# HBM ledger                                                             #
# --------------------------------------------------------------------- #
class HbmLedger:
    """Per-pool device-memory attribution with watermarks + leak alarm.

    Pools register a zero-argument ``bytes_fn`` returning their current
    bytes (``tree_nbytes`` over the pool's tensors: shapes only, never a
    sync).  ``maybe_sample()`` is the hot-path seam: a
    monotonic-clock throttle makes it a no-op most steps, and a real
    sample walks the registered pools, takes ``total_bytes_fn`` (the
    fit's ``placed_bytes_total``) as ground truth, attributes the
    remainder to ``other``, advances
    per-pool peaks, and feeds the leak detector — ``leak_samples``
    consecutive total-growth samples adding up to at least
    ``leak_min_bytes`` emit ONE typed ``hbm_leak`` flight-recorder
    event per growth streak (the alarm re-arms when the growth stops).
    """

    def __init__(self, sample_min_s: Optional[float] = None,
                 leak_samples: Optional[int] = None,
                 leak_min_bytes: Optional[int] = None,
                 total_bytes_fn: Optional[Callable[[], int]] = None):
        if sample_min_s is None:
            sample_min_s = knobs.get_float(HBM_SAMPLE_S_ENV,
                                           DEFAULT_HBM_SAMPLE_S)
        if leak_samples is None:
            leak_samples = knobs.get_int(LEAK_SAMPLES_ENV,
                                         DEFAULT_LEAK_SAMPLES)
        if leak_min_bytes is None:
            leak_min_bytes = knobs.get_int(LEAK_MIN_BYTES_ENV,
                                           DEFAULT_LEAK_MIN_BYTES)
        self.sample_min_s = max(0.0, float(sample_min_s))
        self.leak_samples = max(2, int(leak_samples))
        self.leak_min_bytes = max(1, int(leak_min_bytes))
        # the default follows the card in use, else the pools' own sum
        self._total_fn = total_bytes_fn or (
            lambda: placed_bytes_total(pools_total=self.pools_total))
        self._lock = threading.Lock()
        self._pools: Dict[str, Callable[[], int]] = {}
        self._last: Dict[str, int] = {}
        self._peaks: Dict[str, int] = {}
        self._last_total = 0
        self._peak_total = 0
        self._n_samples = 0
        self._last_sample_t = float("-inf")
        # leak streak: consecutive growth samples, values at streak
        # start (for growth attribution), one alarm per streak
        self._prev_total: Optional[int] = None
        self._prev_pools: Dict[str, int] = {}
        self._growth_run = 0
        self._growth_base_total = 0
        self._growth_base_pools: Dict[str, int] = {}
        self._alarmed = False
        self._leak_events = 0

    def __getstate__(self):
        return {"sample_min_s": self.sample_min_s,
                "leak_samples": self.leak_samples,
                "leak_min_bytes": self.leak_min_bytes}

    def __setstate__(self, state):
        self.__init__(**state)

    def pools_total(self) -> int:
        """The registered pools' current bytes, summed (a dead reader
        counts 0): the ground truth where no card reports one."""
        with self._lock:
            readers = list(self._pools.values())
        total = 0
        for fn in readers:
            try:
                total += int(fn() or 0)
            except Exception:
                pass
        return total

    def set_total_fn(self, total_bytes_fn: Callable[[], int]) -> None:
        """The ground truth a sample compares the pools with (the trainer
        binds its fit's device here)."""
        self._total_fn = total_bytes_fn

    def register_pool(self, name: str,
                      bytes_fn: Callable[[], int]) -> None:
        """(Re)register one attribution pool.  Re-registering replaces
        the reader — a second fit on one trainer re-binds its state."""
        with self._lock:
            self._pools[str(name)] = bytes_fn

    def unregister_pool(self, name: str) -> None:
        with self._lock:
            self._pools.pop(str(name), None)
            self._last.pop(str(name), None)

    # -- sampling -------------------------------------------------------- #
    def maybe_sample(self) -> Optional[Dict[str, int]]:
        """Throttled sample — the per-step seam.  Costs one monotonic
        read when inside the throttle window."""
        if time.monotonic() - self._last_sample_t < self.sample_min_s:
            return None
        return self.sample()

    def sample(self) -> Dict[str, int]:
        """Walk the pools now.  Returns {pool: bytes} including the
        derived ``other`` and ``total``."""
        self._last_sample_t = time.monotonic()
        with self._lock:
            readers = list(self._pools.items())
        pools: Dict[str, int] = {}
        for name, fn in readers:
            try:
                pools[name] = int(fn() or 0)
            except Exception:  # a dead reader reports 0, never crashes
                pools[name] = 0  # the loop it samples from
        try:
            total = int(self._total_fn() or 0)
        except Exception:
            total = 0
        attributed = sum(pools.values())
        # a backend whose ground truth under-reports the attribution
        # (device stats lag a placement) still renders coherently:
        # other is the non-negative remainder
        pools["other"] = max(0, total - attributed)
        with self._lock:
            self._n_samples += 1
            self._last = dict(pools)
            self._last_total = total
            self._peak_total = max(self._peak_total, total)
            for name, b in pools.items():
                self._peaks[name] = max(self._peaks.get(name, 0), b)
            self._feed_leak_detector(total, pools)
        out = dict(pools)
        out["total"] = total
        return out

    def _feed_leak_detector(self, total: int,
                            pools: Dict[str, int]) -> None:
        # called under self._lock.  A "leak streak" is a run of
        # consecutive samples where the total strictly grew; the base
        # values (from the sample BEFORE the streak) attribute the
        # growth to a suspect pool when the alarm fires.
        prev, prev_pools = self._prev_total, self._prev_pools
        self._prev_total, self._prev_pools = total, dict(pools)
        if prev is None:
            return
        if total > prev:
            if self._growth_run == 0:
                self._growth_base_total = prev
                self._growth_base_pools = prev_pools
            self._growth_run += 1
        else:
            self._growth_run = 0
            self._alarmed = False
            return
        growth = total - self._growth_base_total
        if (not self._alarmed and self._growth_run >= self.leak_samples
                and growth >= self.leak_min_bytes):
            self._alarmed = True
            self._leak_events += 1
            deltas = {k: pools.get(k, 0) - self._growth_base_pools.get(k, 0)
                      for k in pools}
            top = max(deltas, key=deltas.get) if deltas else None
            recorder_lib.emit(
                "hbm_leak", total_bytes=total, growth_bytes=int(growth),
                samples=int(self._growth_run),
                suspect_pool=top,
                suspect_growth_bytes=int(deltas.get(top, 0)) if top
                else 0)

    # -- export ---------------------------------------------------------- #
    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            pools = {name: {"bytes": int(self._last.get(name, 0)),
                            "peak_bytes": int(self._peaks.get(name, 0))}
                     for name in sorted(set(self._last)
                                        | set(self._peaks))}
            total = self._last_total
            snap = {
                "samples": self._n_samples,
                "total_bytes": int(total),
                "peak_total_bytes": int(self._peak_total),
                "pools": pools,
                "attributed_bytes": int(sum(
                    v["bytes"] for k, v in pools.items() if k != "other")),
                "leak_alarms": int(self._leak_events),
                "leak_streak_samples": int(self._growth_run),
            }
        snap["attributed_fraction"] = round(
            snap["attributed_bytes"] / total, 4) if total else 0.0
        return snap


# --------------------------------------------------------------------- #
# Goodput ledger                                                         #
# --------------------------------------------------------------------- #
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


# --------------------------------------------------------------------- #
# Composite + crosscheck                                                 #
# --------------------------------------------------------------------- #
class PerfObservatory:
    """The three ledgers as one attachable unit: pass to
    ``Trainer(perf_observatory=...)`` (timeline + HBM wired into the fit
    loop) and feed ``goodput`` from an ``ElasticRunner`` or a probe.
    ``register()`` on a :class:`~.registry.MetricsRegistry` exports all
    three."""

    def __init__(self, timeline: Optional[StepTimeline] = None,
                 hbm: Optional[HbmLedger] = None,
                 goodput: Optional[GoodputLedger] = None):
        if timeline is None:
            from ..analysis import compile_guard
            timeline = StepTimeline(
                compile_seconds_fn=compile_guard.compile_seconds)
        self.timeline = timeline
        self.hbm = hbm if hbm is not None else HbmLedger()
        self.goodput = goodput if goodput is not None else GoodputLedger()
        # host-side shm owned by this process's object store (the KV
        # handoff and pipeline transport) as an attribution pool: the
        # reader returns 0 until a store exists and never builds one
        from ..runtime.object_store import global_shm_bytes
        self.hbm.register_pool("object_store_shm", global_shm_bytes)

    def __getstate__(self):
        return {}

    def __setstate__(self, state):
        self.__init__()

    def register(self, registry: Any) -> Any:
        registry.add_step_timeline(self.timeline)
        registry.add_hbm(self.hbm)
        if self.goodput.snapshot()["wall_s"] > 0:
            registry.add_goodput(self.goodput)
        return registry


def exposed_comm_crosscheck(
        measured_step_s: Mapping[str, float],
        wire_reports: Mapping[str, Mapping[str, Any]]) -> Dict[str, Any]:
    """Measured vs analytic exposed-comm accounting over an A/B of
    gather modes (a tree-vs-scan pair of step times).

    The step cannot be split from the host, so the MEASURED
    exposed-comm estimate is differential: the best-overlapped mode's
    step time is the compute floor, and each mode's excess over it is
    comm that mode exposes (a lower bound — the floor mode's own exposed
    comm is invisible to this measurement, which is exactly why the
    analytic split rides alongside).  The ANALYTIC share is
    ``exposed_bytes / exchange_bytes`` per ``wire_bytes_per_step``.
    Both directions and the per-mode discrepancy are exported; nothing
    is asserted away — a direction disagreement is a finding, not an
    error."""
    modes = [m for m in measured_step_s if m in wire_reports]
    if len(modes) < 2:
        raise ValueError(
            "exposed_comm_crosscheck needs >= 2 modes present in both "
            f"measured_step_s and wire_reports, got {modes!r}")
    floor = min(measured_step_s[m] for m in modes)
    out: Dict[str, Any] = {"modes": {}}
    for m in modes:
        step = float(measured_step_s[m])
        rep = wire_reports[m]
        exch = float(rep.get("exchange_bytes_per_step") or 0)
        exposed = float(rep.get("exposed_bytes_per_step", exch))
        analytic = (exposed / exch) if exch else 0.0
        measured = ((step - floor) / step) if step > 0 else 0.0
        out["modes"][m] = {
            "step_s": round(step, 6),
            "measured_exposed_s": round(step - floor, 6),
            "measured_exposed_fraction": round(measured, 4),
            "analytic_exposed_bytes": int(exposed),
            "analytic_exposed_fraction": round(analytic, 4),
            "discrepancy": round(measured - analytic, 4),
        }
    by_measured = sorted(modes, key=lambda m: measured_step_s[m])
    by_analytic = sorted(
        modes, key=lambda m: wire_reports[m].get(
            "exposed_bytes_per_step",
            wire_reports[m].get("exchange_bytes_per_step", 0)))
    out["measured_order"] = by_measured
    out["analytic_order"] = by_analytic
    out["direction_agrees"] = by_measured == by_analytic
    return out
