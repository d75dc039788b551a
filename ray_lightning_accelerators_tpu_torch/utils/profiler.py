"""Profiling and tracing: spans, counters, device traces, memory, FLOPs.

Port of the JAX package's ``utils/profiler.py`` with PyTorch's means.
Three layers:

- **Span timing** (`Profiler.span`): nested host wall-clock spans on a
  thread-local stack.  Each span also opens a
  ``torch.profiler.record_function`` range, so the same names line up in
  a device trace.  ``sync=True`` spans wait for the CUDA tensors set on
  their handle (the current stream of each tensor's device is
  synchronised), so a step span measures the work, not its launch; on
  the CPU nothing is waited for (the work has run when the call returns).
  ``observe`` records an externally timed duration (serve latencies).
- **Device traces** (`start_trace` / `stop_trace` / `trace`): a
  ``torch.profiler.profile`` over the CPU and, when the card is in use,
  CUDA activity, written as a Chrome trace (``*.pt.trace.json``) under
  ``log_dir``.  `trace_events` reads the device's kernel, memcpy and
  memset events back in the JAX package's row shape and
  `trace_op_summary` aggregates their exclusive times.
- **Device memory** (`device_memory_stats`): the caching allocator's
  counters under the JAX package's key names.

Counters (``incr``), gauges, the analytic comms record and the
cross-process merge (``export_state`` / ``merge``, reservoirs merged
count-weighted) are the JAX package's, number for number.  The Trainer
takes ``profiler=`` and wraps its hot phases (data fetch, h2d, the train
step, validation) in spans; see core/trainer.py.
"""

from __future__ import annotations

import glob
import gzip
import json
import math
import os
import random
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

# the card's peak dense rate for its matmul type (bf16), by the name
# torch.cuda.get_device_name gives; an unknown card has no peak (mfu 0.0)
PEAK_FLOPS = {"H100": 989e12}

# the Chrome trace categories of work that ran on the device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


class _SpanHandle:
    """Mutable holder for a span's device outputs (see Profiler.span)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = None

    def set(self, value: Any) -> None:
        self.value = value


class _SpanStat:
    __slots__ = ("count", "total", "samples", "maxv", "_rng")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.samples: List[float] = []  # uniform reservoir for percentiles
        # the exact running max: a tail is judged on its worst request,
        # which the reservoir may have evicted
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

    def merge(self, count: int, total: float, samples: List[float],
              maxv: float, cap: int = 4096) -> None:
        """Fold another stat's (count, total, reservoir, max) into this
        one.  Count, total and max are exact.  When the two reservoirs
        fit the cap both are kept whole; otherwise A-Res weighted
        sampling keeps each sample with the weight of the observations
        it stands for (``count / len(samples)`` on its side), so a
        reservoir of 10k spans dominates one of 10."""
        if count <= 0:
            return
        mine_n, mine = self.count, self.samples
        self.count += int(count)
        self.total += float(total)
        if maxv > self.maxv:
            self.maxv = float(maxv)
        union = list(mine) + list(samples)
        if len(union) <= cap:
            self.samples = union
            return
        weighted = []
        for src_samples, src_count in ((mine, mine_n), (samples, count)):
            if not src_samples:
                continue
            w = max(1.0, src_count / len(src_samples))
            weighted += [(s, w) for s in src_samples]
        # A-Res: key = u^(1/w); the cap largest keys are a weighted sample
        # without replacement, seeded so a merge order gives one result
        rng = random.Random(0xC0FFEE ^ self.count)
        keyed = sorted(((rng.random() ** (1.0 / w), s)
                        for s, w in weighted), reverse=True)
        self.samples = [s for _k, s in keyed[:cap]]


def _cuda_tensors(value: Any):
    """The CUDA tensors of a (nested) span output."""
    import torch

    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            yield value
    elif isinstance(value, dict):
        for v in value.values():
            yield from _cuda_tensors(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _cuda_tensors(v)


def _sync_outputs(value: Any) -> None:
    """Wait for the current stream of every device holding one of
    ``value``'s CUDA tensors (nothing for CPU tensors)."""
    import torch

    devices = {t.device for t in _cuda_tensors(value)}
    for d in devices:
        # graftlint: ok(host-sync) — opt-in sync=True mode: measure compute
        torch.cuda.current_stream(d).synchronize()


class Profiler:
    """Named nested wall-clock spans, counters and gauges, with
    ``torch.profiler`` ranges."""

    def __init__(self, sync: bool = False):
        """``sync=True``: a span whose handle holds CUDA tensors waits for
        them before closing, so it measures the work, not its launch."""
        self.sync = sync
        self._stats: Dict[str, _SpanStat] = {}
        self._tls = threading.local()
        self._lock = threading.Lock()
        self._trace_dir: Optional[str] = None
        self._trace_prof: Any = None
        self._comms: Optional[Dict[str, Any]] = None
        self._counters: Dict[str, int] = {}
        # gauge -> [count, sum, min, max, last]
        self._gauges: Dict[str, List[float]] = {}

    def __getstate__(self):
        """What crosses to a rank: ``sync`` only.  A rank builds its own
        clean profile, so the driver's merge sees every rank once."""
        return {"sync": self.sync}

    def __setstate__(self, state):
        self.__init__(sync=state["sync"])

    # ------------------------------------------------------------------ #
    def _stack(self) -> List[str]:
        if not hasattr(self._tls, "stack"):
            self._tls.stack = []
        return self._tls.stack

    @contextmanager
    def span(self, name: str):
        """Time a block under ``name``, nested as parent/child in the
        report.  Yields a handle: ``handle.set(outputs)`` with the
        block's device outputs makes a sync-mode profiler wait for them
        before the span closes."""
        import torch

        handle = _SpanHandle()
        stack = self._stack()
        full = "/".join(stack + [name])
        stack.append(name)
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(name):
                yield handle
                if self.sync and handle.value is not None:
                    _sync_outputs(handle.value)
        finally:
            dt = time.perf_counter() - t0
            stack.pop()
            with self._lock:
                self._stats.setdefault(full, _SpanStat()).add(dt)

    def observe(self, name: str, dt_s: float) -> None:
        """Record an externally timed duration under ``name``: the same
        statistics as a span without entering one (a request's submit ->
        first token is not one with-block on one thread)."""
        with self._lock:
            self._stats.setdefault(name, _SpanStat()).add(dt_s)

    # ------------------------------------------------------------------ #
    # Counters and gauges (the input pipeline's accounting)               #
    # ------------------------------------------------------------------ #
    def incr(self, name: str, n: int = 1) -> None:
        """Bump a monotonic counter (``prefetch_starved_steps``: steps
        that found no batch ready; nonzero means the run is input-bound)."""
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def gauge(self, name: str, value: float) -> None:
        """Sample a level (``prefetch_depth``: batches ready ahead of the
        consumer); keeps count / mean / min / max / last."""
        v = float(value)
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                self._gauges[name] = [1, v, v, v, v]
            else:
                g[0] += 1
                g[1] += v
                g[2] = min(g[2], v)
                g[3] = max(g[3], v)
                g[4] = v

    def gauges(self) -> Dict[str, Dict[str, float]]:
        """name -> {count, mean, min, max, last}."""
        with self._lock:
            items = {k: list(v) for k, v in self._gauges.items()}
        return {k: {"count": int(c), "mean": s / max(c, 1), "min": lo,
                    "max": hi, "last": last}
                for k, (c, s, lo, hi, last) in items.items()}

    # ------------------------------------------------------------------ #
    # The gradient exchange's bytes on the wire                            #
    # ------------------------------------------------------------------ #
    def record_comms(self, per_step: Dict[str, Any]) -> None:
        """Attach the exchange's analytic bytes-on-wire record
        (``collectives.wire_bytes_per_step``'s shape), computed once per
        fit: a step's collective payloads do not change."""
        with self._lock:
            self._comms = dict(per_step)

    def comms(self) -> Optional[Dict[str, Any]]:
        """The last recorded wire record (None without one)."""
        with self._lock:
            return dict(self._comms) if self._comms is not None else None

    # ------------------------------------------------------------------ #
    # Cross-process merge (telemetry/registry.py)                         #
    # ------------------------------------------------------------------ #
    def export_state(self) -> Dict[str, Any]:
        """A picklable, JSON-able snapshot: span stats with their raw
        reservoirs (a percentile merge needs samples, not quantiles),
        counters, gauges and the comms record.  A rank ships this home
        for the driver's ``merge``."""
        with self._lock:
            return {
                "stats": {name: {"count": st.count, "total": st.total,
                                 "samples": list(st.samples),
                                 "max": st.maxv}
                          for name, st in self._stats.items()},
                "counters": dict(self._counters),
                "gauges": {k: list(v) for k, v in self._gauges.items()},
                "comms": (dict(self._comms) if self._comms is not None
                          else None),
            }

    def merge(self, other: Any) -> "Profiler":
        """Fold another profiler (or its ``export_state()`` dict) into
        this one: span counts, totals and maxes exact, reservoirs merged
        count-weighted (``_SpanStat.merge``), counters summed, gauges
        combined with the other side's ``last`` winning (merge order is
        recency order), the comms record adopted when this one has none.
        Returns self."""
        state = other.export_state() if isinstance(other, Profiler) \
            else other
        if not isinstance(state, dict):
            raise TypeError(
                f"Profiler.merge takes a Profiler or export_state() "
                f"dict, got {type(other).__name__}")
        with self._lock:
            for name, row in (state.get("stats") or {}).items():
                st = self._stats.setdefault(name, _SpanStat())
                st.merge(int(row.get("count", 0)),
                         float(row.get("total", 0.0)),
                         list(row.get("samples") or ()),
                         float(row.get("max", 0.0)))
            for name, n in (state.get("counters") or {}).items():
                self._counters[name] = self._counters.get(name, 0) + int(n)
            for name, g in (state.get("gauges") or {}).items():
                c, s, lo, hi, last = g
                mine = self._gauges.get(name)
                if mine is None:
                    self._gauges[name] = [int(c), float(s), float(lo),
                                          float(hi), float(last)]
                else:
                    mine[0] += int(c)
                    mine[1] += float(s)
                    mine[2] = min(mine[2], float(lo))
                    mine[3] = max(mine[3], float(hi))
                    if c:
                        mine[4] = float(last)
            if self._comms is None and state.get("comms") is not None:
                self._comms = dict(state["comms"])
        return self

    # ------------------------------------------------------------------ #
    def summary(self) -> Dict[str, Dict[str, float]]:
        """name -> {count, total_s, mean_s, p50_s, p95_s, p99_s, max_s}:
        percentiles from the reservoir, ``max_s`` the exact maximum."""
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

    def describe(self) -> str:
        """Human-readable table, longest total first."""
        rows = sorted(self.summary().items(),
                      key=lambda kv: -kv[1]["total_s"])
        lines = [f"{'span':<40} {'count':>7} {'total':>9} {'mean':>9} "
                 f"{'p50':>9} {'p95':>9} {'p99':>9} {'max':>9}"]
        for name, s in rows:
            lines.append(
                f"{name:<40} {s['count']:>7d} {s['total_s']:>8.3f}s "
                f"{s['mean_s'] * 1e3:>7.2f}ms {s['p50_s'] * 1e3:>7.2f}ms "
                f"{s['p95_s'] * 1e3:>7.2f}ms {s['p99_s'] * 1e3:>7.2f}ms "
                f"{s['max_s'] * 1e3:>7.2f}ms")
        for name, n in sorted(self.counters().items()):
            lines.append(f"counter {name:<32} {n:>7d}")
        for name, g in sorted(self.gauges().items()):
            lines.append(
                f"gauge   {name:<32} last={g['last']:g} "
                f"mean={g['mean']:.2f} min={g['min']:g} max={g['max']:g}")
        starved = self.counters().get("prefetch_starved_steps", 0)
        if starved:
            steps = self.summary().get("h2d_wait", {}).get("count", 0)
            lines.append(
                f"input pipeline: {starved}/{steps} steps found the "
                "prefetch queue empty — run is input-bound (raise "
                "prefetch_batches or cheapen the host pipeline)")
        c = self.comms()
        if c is not None:
            lines.append(
                f"grad exchange [{c.get('mode')}]: "
                f"{c.get('exchange_bytes_per_step', 0) / 1e6:.2f} MB/step "
                f"on wire vs {c.get('baseline_fp32_bytes_per_step', 0) / 1e6:.2f}"
                f" MB fp32 ({c.get('compression_ratio')}x overall, "
                f"{c.get('compressed_ratio')}x on compressed leaves)")
        return "\n".join(lines)

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()
            self._comms = None
            self._counters.clear()
            self._gauges.clear()

    # ------------------------------------------------------------------ #
    # Device traces (torch.profiler, Chrome trace format)                  #
    # ------------------------------------------------------------------ #
    def start_trace(self, log_dir: str) -> None:
        """Begin a ``torch.profiler`` trace: the CPU, and CUDA activity
        when the card is in use.  A second start raises.

        On the H100 machine (torch 2.11) the trace dropped the first
        kernels of a burst that began on an idle card, more the older the
        process (of 100 short ones: none 10 s into the process, 4 after a
        minute, 56 after 12); work queued behind other device work kept
        every kernel.  ``chip_smoke.py`` 18b leads its traced steps with short
        spin kernels for that reason."""
        import torch

        if self._trace_dir is not None:
            raise RuntimeError(f"trace already running -> {self._trace_dir}")
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        self._trace_prof = prof
        self._trace_dir = log_dir

    def stop_trace(self) -> Optional[str]:
        """End the trace (after the device finished the work launched in
        it) and write it as ``<log_dir>/rla_<pid>_<ns>.pt.trace.json``;
        returns ``log_dir`` (None when no trace runs)."""
        if self._trace_dir is None:
            return None
        import torch

        prof, d = self._trace_prof, self._trace_dir
        self._trace_prof = self._trace_dir = None
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()   # the work launched in the window
        prof.stop()
        os.makedirs(d, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            d, f"rla_{os.getpid()}_{time.time_ns()}.pt.trace.json"))
        return d

    @contextmanager
    def trace(self, log_dir: str):
        self.start_trace(log_dir)
        try:
            yield
        finally:
            self.stop_trace()


def _newest_trace(trace_dir: str) -> str:
    files = [f for pat in ("*.trace.json", "*.trace.json.gz")
             for f in glob.glob(os.path.join(trace_dir, "**", pat),
                                recursive=True)]
    if not files:
        raise FileNotFoundError(f"no *.trace.json(.gz) under {trace_dir}")
    return max(files, key=os.path.getmtime)


def trace_events(trace_dir: str) -> List[Dict[str, Any]]:
    """The device's events from the newest Chrome trace under
    ``trace_dir`` (written by ``Profiler.start_trace``): the kernel,
    memcpy and memset events of the card's stream rows, as the JAX
    package's rows ``{name, ts_us, dur_us, end_us, pid, tid, category,
    bytes, flops}``.  ``ts`` and ``dur`` are the trace's microseconds on
    the device's timeline; ``category`` is the event's ``cat``.  ``bytes``
    and ``flops`` are the counts the event's ``args`` carry (a memcpy's
    ``bytes``), else 0: never estimated.  Host rows (CPU ops, runtime
    calls, user ranges) are left out, so none can be taken for a
    kernel's parent."""
    path = _newest_trace(trace_dir)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        t = json.load(f)
    out: List[Dict[str, Any]] = []
    for e in t.get("traceEvents", []):
        cat = str(e.get("cat", "")).lower()
        if e.get("ph") != "X" or cat not in DEVICE_CATEGORIES:
            continue
        a = e.get("args") or {}
        ts = float(e.get("ts", 0.0))
        dur = float(e.get("dur", 0.0))
        out.append({
            "name": e["name"], "ts_us": ts, "dur_us": dur,
            "end_us": ts + dur,
            # timeline identity: events nest only within one device
            "pid": e.get("pid"), "tid": e.get("tid"),
            "category": cat,
            "bytes": int(a.get("bytes", 0) or 0),
            "flops": int(a.get("flops", 0) or 0),
        })
    out.sort(key=lambda ev: (ev["ts_us"], -ev["dur_us"]))
    return out


def trace_op_summary(trace_dir: str, top: int = 0) -> Dict[str, Any]:
    """Exclusive (self) time per op and per category of a device trace,
    with achieved GB/s and TF/s where the trace carries byte and flop
    counts.  Nesting is resolved by interval containment on one stack per
    ``pid`` (device), as in the JAX package.  Returns ``{"total_ms",
    "by_category": {cat: {self_ms, gbps, tfs, pct}}, "ops": [top-N rows
    {category, name, self_ms, count, pct, gbps, tfs}]}``."""
    evs = trace_events(trace_dir)
    stacks: Dict[Any, List[Dict[str, Any]]] = {}
    for e in evs:
        stack = stacks.setdefault(e["pid"], [])
        while stack and stack[-1]["end_us"] <= e["ts_us"] + 1e-6:
            stack.pop()
        e["_child_dur"] = 0.0
        if stack:
            stack[-1]["_child_dur"] += e["dur_us"]
        stack.append(e)
    agg: Dict[Any, List[float]] = {}
    for e in evs:
        key = (e["category"], e["name"])
        row = agg.setdefault(key, [0.0, 0, 0, 0])
        row[0] += max(0.0, e["dur_us"] - e["_child_dur"])
        row[1] += 1
        row[2] += e["bytes"]
        row[3] += e["flops"]
    total_us = sum(v[0] for v in agg.values())

    def rates(dur_us: float, nbytes: int, nflops: int) -> Dict[str, float]:
        secs = dur_us * 1e-6
        return {"gbps": nbytes / secs / 1e9 if secs else 0.0,
                "tfs": nflops / secs / 1e12 if secs else 0.0}

    cats: Dict[str, List[float]] = {}
    for (cat, _name), (dur, _n, b, fl) in agg.items():
        c = cats.setdefault(cat, [0.0, 0, 0])
        c[0] += dur
        c[1] += b
        c[2] += fl
    by_category = {
        cat: {"self_ms": dur / 1e3,
              "pct": 100.0 * dur / total_us if total_us else 0.0,
              **rates(dur, b, fl)}
        for cat, (dur, b, fl) in cats.items()}
    rows = sorted(agg.items(), key=lambda kv: -kv[1][0])
    if top:
        rows = rows[:top]
    ops = [{"category": cat, "name": name, "self_ms": dur / 1e3,
            "count": n,
            "pct": 100.0 * dur / total_us if total_us else 0.0,
            **rates(dur, b, fl)}
           for (cat, name), (dur, n, b, fl) in rows]
    return {"total_ms": total_us / 1e3, "by_category": by_category,
            "ops": ops}


def device_memory_stats() -> List[Dict[str, Any]]:
    """Per-card memory counters under the JAX package's names:
    ``bytes_in_use`` and ``peak_bytes_in_use`` (the caching allocator's
    allocated bytes, ``torch.cuda.memory_stats``), ``bytes_reserved``,
    and ``bytes_limit`` (the card's total, ``torch.cuda.mem_get_info``).
    ``[{}]`` without a card, as the JAX CPU backend's empty stats."""
    import torch

    if not torch.cuda.is_available():
        return [{}]
    out = []
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        _free, total = torch.cuda.mem_get_info(i)
        out.append({
            "bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak", 0)),
            "bytes_reserved": int(s.get("reserved_bytes.all.current", 0)),
            "bytes_limit": int(total),
        })
    return out


def device_bytes_in_use() -> Optional[int]:
    """Summed ``bytes_in_use`` over the cards, or None without a card."""
    vals = [s.get("bytes_in_use") for s in device_memory_stats()
            if s.get("bytes_in_use")]
    return int(sum(vals)) if vals else None


# --------------------------------------------------------------------- #
# FLOPs and MFU                                                          #
# --------------------------------------------------------------------- #
def flops_estimate(fn, *args, **kwargs) -> Optional[float]:
    """FLOPs of one call of ``fn(*args, **kwargs)``, counted by
    ``torch.utils.flop_counter.FlopCounterMode`` (the matmuls,
    convolutions and attention it knows).  PyTorch runs eagerly, so the
    call executes.  None when nothing was counted."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    flops = counter.get_total_flops()
    return float(flops) if flops else None


def mfu(flops_per_step: float, step_time_s: float,
        peak_flops: Optional[float] = None) -> float:
    """Model FLOPs utilization, achieved over peak.  ``peak_flops``
    defaults to the card's bf16 dense peak (``PEAK_FLOPS``, matched on
    ``torch.cuda.get_device_name``); 0.0 on an unknown card or without
    one, so callers can gate on it."""
    if peak_flops is None:
        import torch

        if not torch.cuda.is_available():
            return 0.0
        name = torch.cuda.get_device_name(0)
        peak_flops = next((v for k, v in PEAK_FLOPS.items() if k in name),
                          0.0)
        if not peak_flops:
            return 0.0
    return flops_per_step / (step_time_s * peak_flops)
