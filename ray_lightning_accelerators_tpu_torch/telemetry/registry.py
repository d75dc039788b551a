"""Driver-side metrics registry and the run report.

Port of the JAX package's ``telemetry/registry.py``.  Every per-process
island (the trainer's Profiler spans, the prefetch counters, the
exchange's wire record, ServeMetrics, compile counts, flight-recorder
events, the perf observatory's ledgers) lands in one
:class:`MetricsRegistry` and renders two ways, with the JAX package's
metric names:

- ``to_json()``: the machine-readable snapshot;
- ``prometheus_text()``: the Prometheus exposition format (span families
  as summaries with ``quantile`` labels, counters as ``_total``, gauges
  as gauges).

``write_run_report`` is the postmortem: on a failed fit the driver
writes ``run_report.json`` with every rank's flight-recorder tail (the
driver's ring and each worker's spill), the typed error, the stall
diagnosis, the compile count (the port's nvcc and g++ builds,
``analysis/compile_guard.py``) and the registry's snapshot.
"""

from __future__ import annotations

import json
import logging
import os
import re
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence

from ..utils.profiler import Profiler
from . import recorder as recorder_lib

log = logging.getLogger("rla_tpu_torch")

REPORT_SCHEMA = 1
REPORT_BASENAME = "run_report.json"

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(name: str) -> str:
    """Prometheus-legal metric-name fragment."""
    clean = _NAME_RE.sub("_", str(name)).strip("_")
    return clean or "unnamed"


class MetricsRegistry:
    """Accumulates per-rank telemetry into one mergeable view.

    ``add_profiler`` takes a live :class:`~..utils.profiler.Profiler`
    or its ``export_state()`` dict (the wire shape workers ship home);
    all profilers merge into ONE (``Profiler.merge`` reservoir
    semantics), so the exported percentiles summarize the whole run,
    not one lucky rank.  Serve snapshots, compile counts and event
    tallies are kept per rank label (``"driver"``, ``"0"``, ...).
    """

    def __init__(self, trace_id: Optional[str] = None):
        self.trace_id = trace_id
        self._profiler = Profiler()
        self._profiler_ranks: List[str] = []
        self._serve: Dict[str, Dict[str, Any]] = {}
        self._compile: Dict[str, int] = {}
        self._event_counts: Dict[str, int] = {}
        self._extra: Dict[str, float] = {}
        # perf-observatory ledgers (telemetry/perf.py snapshots)
        self._perf: Dict[str, Dict[str, Any]] = {}
        # the live plane's per-rank status rows
        self._ranks: Dict[str, Dict[str, Any]] = {}
        # the serve replica controller's snapshot
        self._replica_controller: Optional[Dict[str, Any]] = None

    @staticmethod
    def _label(rank: Any) -> str:
        return "driver" if rank is None else str(rank)

    # ------------------------------------------------------------------ #
    def add_profiler(self, profiler: Any, rank: Any = None) -> None:
        """Merge one rank's profiler (object or export_state dict)."""
        if profiler is None:
            return
        self._profiler.merge(profiler)
        self._profiler_ranks.append(self._label(rank))

    def add_serve(self, metrics: Any, rank: Any = None) -> None:
        """One rank's ServeMetrics — the object (its latency reservoirs
        merge into the shared profiler) or a ``snapshot()`` dict."""
        if metrics is None:
            return
        snap = metrics
        if hasattr(metrics, "snapshot"):
            snap = metrics.snapshot()
            prof = getattr(metrics, "profiler", None)
            if prof is not None:
                self.add_profiler(prof, rank=rank)
        self._serve[self._label(rank)] = dict(snap)

    def add_compile_count(self, n: Optional[int] = None,
                          rank: Any = None) -> None:
        """A rank's compile total; ``None`` reads this process's
        ``analysis.compile_guard.compile_count()`` (nvcc and g++ runs)."""
        if n is None:
            from ..analysis import compile_guard
            n = compile_guard.compile_count()
        self._compile[self._label(rank)] = int(n)

    def add_events(self, events: Sequence[Mapping[str, Any]],
                   rank: Any = None) -> None:
        """Tally a rank's flight-recorder events into per-kind counts —
        the registry is a METRICS surface, so rank granularity is
        deliberately dropped here; full per-rank timelines belong in the
        run report.  The first traced event seeds ``trace_id`` when the
        registry was built without one."""
        del rank  # accepted for signature symmetry with the other adds
        for e in events or ():
            kind = e.get("kind", "?")
            self._event_counts[kind] = self._event_counts.get(kind, 0) + 1
            if self.trace_id is None and e.get("trace"):
                self.trace_id = e["trace"]

    def add_scalar(self, name: str, value: float) -> None:
        """A free-form run-level scalar (probe extras)."""
        self._extra[str(name)] = float(value)

    def add_rank_status(self, rank: Any,
                        status: Mapping[str, Any]) -> None:
        """One rank's live status row (the live plane's ``rank_status``
        shape, ``telemetry/live.py``): kept per rank label so
        ``rla_tpu_rank_healthy``, ``rla_tpu_rank_global_step`` and
        ``rla_tpu_rank_events_per_second`` render one sample per rank."""
        if status:
            self._ranks[self._label(rank)] = dict(status)

    def add_replica_controller(self, snapshot: Any) -> None:
        """The serve tier's replica-controller snapshot (an object with
        ``snapshot()`` or its dict, ``serve/controller.py``): per-replica state/load rows rendered as the
        ``rla_tpu_serve_replica_*`` gauge family (one sample per
        replica label) plus tier-level queue/brownout gauges."""
        if snapshot is None:
            return
        if hasattr(snapshot, "snapshot"):
            snapshot = snapshot.snapshot()
        self._replica_controller = dict(snapshot)

    # -- perf-observatory ledgers (telemetry/perf.py) ------------------- #
    @staticmethod
    def _snap(obj: Any) -> Dict[str, Any]:
        return dict(obj.snapshot()) if hasattr(obj, "snapshot") \
            else dict(obj)

    def add_step_timeline(self, timeline: Any) -> None:
        """A :class:`~.perf.StepTimeline` (or its snapshot dict): the
        per-step phase decomposition of the run's hot loop."""
        if timeline is not None:
            self._perf["step_timeline"] = self._snap(timeline)

    def add_hbm(self, ledger: Any) -> None:
        """A :class:`~.perf.HbmLedger` (or snapshot): per-pool device
        memory attribution + watermarks + leak-alarm count."""
        if ledger is not None:
            self._perf["hbm"] = self._snap(ledger)

    def add_goodput(self, ledger: Any) -> None:
        """A :class:`~.perf.GoodputLedger` (or snapshot): the run's
        wall-time partition and goodput fraction."""
        if ledger is not None:
            self._perf["goodput"] = self._snap(ledger)

    def merged_profiler(self) -> Profiler:
        return self._profiler

    # ------------------------------------------------------------------ #
    # Exports                                                             #
    # ------------------------------------------------------------------ #
    def to_json(self) -> Dict[str, Any]:
        """Flat JSON snapshot: merged spans/counters/gauges/comms, serve
        per rank, compile counts, event tallies."""
        prof = self._profiler
        out: Dict[str, Any] = {
            "schema": REPORT_SCHEMA,
            "trace_id": self.trace_id,
            "profiler_ranks": list(self._profiler_ranks),
            "spans": prof.summary(),
            "counters": prof.counters(),
            "gauges": prof.gauges(),
            "comms": prof.comms(),
            "serve": {k: dict(v) for k, v in self._serve.items()},
            "compile": {"per_rank": dict(self._compile),
                        "total_backend_compiles": sum(
                            self._compile.values())},
            "events": dict(self._event_counts),
        }
        if self._ranks:
            out["ranks"] = {k: dict(v) for k, v in self._ranks.items()}
        if self._replica_controller:
            out["replica_controller"] = dict(self._replica_controller)
        if self._perf:
            out["perf"] = {k: dict(v) for k, v in self._perf.items()}
        if self._extra:
            out["extra"] = dict(self._extra)
        return out

    def prometheus_text(self) -> str:
        """Prometheus exposition text.  Span families are summaries
        (``quantile`` labels + ``_sum``/``_count``/``_max``); profiler
        counters and serve counters are ``_total`` counters; gauges and
        comms fields are gauges.  Rank granularity: serve metrics carry
        a ``rank`` label; merged profiler families describe the run."""
        lines: List[str] = []
        typed: set = set()

        def add(name: str, value: Any, labels: str = "",
                mtype: Optional[str] = None) -> None:
            if value is None:
                return
            if mtype is not None and name not in typed:
                # one TYPE line per metric name: exposition parsers
                # reject duplicates (rank-labeled families repeat names)
                typed.add(name)
                lines.append(f"# TYPE {name} {mtype}")
            lines.append(f"{name}{labels} {float(value):g}")

        spans = self._profiler.summary()
        if spans:
            lines.append("# TYPE rla_tpu_span_seconds summary")
        for span, s in sorted(spans.items()):
            lab = f'{{span="{_prom_name(span)}"}}'
            for q, key in (("0.5", "p50_s"), ("0.95", "p95_s"),
                           ("0.99", "p99_s")):
                lines.append(
                    f'rla_tpu_span_seconds{{span="{_prom_name(span)}",'
                    f'quantile="{q}"}} {s[key]:g}')
            lines.append(f"rla_tpu_span_seconds_sum{lab} {s['total_s']:g}")
            lines.append(f"rla_tpu_span_seconds_count{lab} "
                         f"{s['count']:g}")
            lines.append(f"rla_tpu_span_seconds_max{lab} {s['max_s']:g}")
        for name, n in sorted(self._profiler.counters().items()):
            add(f"rla_tpu_{_prom_name(name)}_total", n, mtype="counter")
        for name, g in sorted(self._profiler.gauges().items()):
            add(f"rla_tpu_{_prom_name(name)}", g["last"], mtype="gauge")
        comms = self._profiler.comms()
        if comms:
            for key in ("exchange_bytes_per_step",
                        "baseline_fp32_bytes_per_step",
                        "compression_ratio"):
                if isinstance(comms.get(key), (int, float)):
                    add(f"rla_tpu_comms_{_prom_name(key)}", comms[key],
                        mtype="gauge")
        # key-major: all of a family's rank-labeled samples must be
        # contiguous — the exposition format forbids interleaving
        # metric families, and a rank-major loop would split e.g.
        # serve_completed_total across two rank blocks
        serve_keys = sorted({k for snap in self._serve.values()
                             for k, v in snap.items()
                             if isinstance(v, (int, float))})
        # lazy import: the serve package imports telemetry.recorder
        from ..serve.metrics import ServeMetrics as _SM
        for key in serve_keys:
            gauge = key in ("queue_depth", "busy_s", "throughput_tok_s",
                            "max_batch") or key in _SM.POOL_GAUGES \
                or key in _SM.SLO_GAUGES or key in _SM.LANE_GAUGES \
                or key in _SM.CHUNK_GAUGES
            name = f"rla_tpu_serve_{_prom_name(key)}"
            if not gauge:
                name = f"{name}_total"
            for rank, snap in sorted(self._serve.items()):
                val = snap.get(key)
                if isinstance(val, (int, float)):
                    add(name, val, f'{{rank="{rank}"}}',
                        mtype="gauge" if gauge else "counter")
        if self._compile:
            add("rla_tpu_backend_compiles_total",
                sum(self._compile.values()), mtype="counter")
        for kind, n in sorted(self._event_counts.items()):
            add("rla_tpu_events_total", n,
                f'{{kind="{_prom_name(kind)}"}}', mtype="counter")
        # live-plane rank rows: key-major like the serve block (one
        # contiguous family per metric name, one sample per rank)
        for key, fam in (("healthy", "rla_tpu_rank_healthy"),
                         ("global_step", "rla_tpu_rank_global_step"),
                         ("events_per_second",
                          "rla_tpu_rank_events_per_second")):
            for rank, row in sorted(self._ranks.items()):
                val = row.get(key)
                if isinstance(val, (int, float)):
                    add(fam, val, f'{{rank="{rank}"}}', mtype="gauge")
        # the serve replica controller's rows: one
        # sample per replica label, key-major per family; monotone
        # per-replica tallies are counters, load/health levels gauges
        rc = self._replica_controller
        if rc:
            replicas = sorted((rc.get("replicas") or {}).items(),
                              key=lambda kv: kv[0])
            add("rla_tpu_serve_replica_count", len(replicas),
                mtype="gauge")
            for key, kind in (("inflight_requests", "gauge"),
                              ("inflight_chunks", "gauge"),
                              ("slo_burn", "gauge"),
                              ("p99_step_ms", "gauge"),
                              ("dispatched_chunks", "counter"),
                              ("completed_chunks", "counter"),
                              ("infra_failures", "counter"),
                              ("app_failures", "counter"),
                              ("retries", "counter"),
                              ("hedges", "counter"),
                              ("revivals", "counter"),
                              ("prefix_hits", "counter"),
                              ("prefix_misses", "counter"),
                              ("prefix_hit_rate", "gauge")):
                name = f"rla_tpu_serve_replica_{_prom_name(key)}"
                if kind == "counter":
                    name += "_total"
                for label, row in replicas:
                    val = row.get(key)
                    if isinstance(val, (int, float)):
                        add(name, val, f'{{replica="{label}"}}',
                            mtype=kind)
            # state one-hot: dashboards key on the label pair
            for label, row in replicas:
                state = row.get("state")
                if state:
                    add("rla_tpu_serve_replica_state", 1,
                        f'{{replica="{label}",'
                        f'state="{_prom_name(state)}"}}',
                        mtype="gauge")
            # lane one-hot (disaggregated prefill/decode lanes): same
            # label-pair pattern as state, its own contiguous family
            for label, row in replicas:
                lane = row.get("lane")
                if lane:
                    add("rla_tpu_serve_replica_lane", 1,
                        f'{{replica="{label}",'
                        f'lane="{_prom_name(lane)}"}}',
                        mtype="gauge")
            for key in ("queue_depth", "queue_cap",
                        "brownout_watermark", "max_burn"):
                if isinstance(rc.get(key), (int, float)):
                    add(f"rla_tpu_serve_tier_{_prom_name(key)}",
                        rc[key], mtype="gauge")
        # perf-observatory ledgers: phase seconds, HBM pools, goodput —
        # each family key-major like the serve block (exposition format
        # forbids interleaved families)
        tl = self._perf.get("step_timeline")
        if tl:
            add("rla_tpu_steps_total", tl.get("steps"), mtype="counter")
            add("rla_tpu_step_wall_seconds_total",
                tl.get("step_wall_total_s"), mtype="counter")
            for fam in ("phases", "between_step_phases"):
                suffix = "" if fam == "phases" else "_between_step"
                for phase, row in sorted((tl.get(fam) or {}).items()):
                    add(f"rla_tpu_step_phase{suffix}_seconds_total",
                        row.get("total_s"),
                        f'{{phase="{_prom_name(phase)}"}}',
                        mtype="counter")
            add("rla_tpu_step_phase_attributed_fraction",
                tl.get("attributed_fraction"), mtype="gauge")
            add("rla_tpu_step_exposed_comm_fraction_analytic",
                tl.get("analytic_exposed_comm_fraction"), mtype="gauge")
        hbm = self._perf.get("hbm")
        if hbm:
            for pool, row in sorted((hbm.get("pools") or {}).items()):
                add("rla_tpu_hbm_pool_bytes", row.get("bytes"),
                    f'{{pool="{_prom_name(pool)}"}}', mtype="gauge")
            for pool, row in sorted((hbm.get("pools") or {}).items()):
                add("rla_tpu_hbm_pool_peak_bytes", row.get("peak_bytes"),
                    f'{{pool="{_prom_name(pool)}"}}', mtype="gauge")
            add("rla_tpu_hbm_total_bytes", hbm.get("total_bytes"),
                mtype="gauge")
            add("rla_tpu_hbm_peak_total_bytes",
                hbm.get("peak_total_bytes"), mtype="gauge")
            add("rla_tpu_hbm_attributed_fraction",
                hbm.get("attributed_fraction"), mtype="gauge")
            add("rla_tpu_hbm_leak_alarms_total", hbm.get("leak_alarms"),
                mtype="counter")
        gp = self._perf.get("goodput")
        if gp:
            for cat, secs in sorted((gp.get("seconds") or {}).items()):
                add("rla_tpu_goodput_seconds_total", secs,
                    f'{{category="{_prom_name(cat)}"}}', mtype="counter")
            add("rla_tpu_goodput_wall_seconds", gp.get("wall_s"),
                mtype="gauge")
            add("rla_tpu_goodput_fraction", gp.get("goodput_fraction"),
                mtype="gauge")
        for name, v in sorted(self._extra.items()):
            add(f"rla_tpu_{_prom_name(name)}", v, mtype="gauge")
        return "\n".join(lines) + ("\n" if lines else "")


# --------------------------------------------------------------------- #
# Cross-rank event gathering                                             #
# --------------------------------------------------------------------- #
def gather_worker_tails(workers: Sequence[Any]) -> Dict[str, Dict[str, Any]]:
    """Each worker's spilled flight-recorder snapshot, keyed by rank
    label.  Works on local ``Worker``s and agent ``RemoteWorker``s (both
    expose ``telemetry_tail``); a rank with no spill (telemetry dir
    unset, never emitted, host gone with its disk) is simply absent."""
    out: Dict[str, Dict[str, Any]] = {}
    for w in workers or ():
        tail_fn = getattr(w, "telemetry_tail", None)
        if tail_fn is None:
            continue
        try:
            snap = tail_fn()
        except Exception:
            snap = None
        if snap:
            out[str(getattr(w, "rank", "?"))] = snap
    return out


def gather_spill_dir(tdir: Optional[str] = None) -> Dict[str, Dict[str, Any]]:
    """Every rank snapshot spilled under the telemetry dir (default: the
    ``RLA_TPU_TELEMETRY_DIR`` knob).  It needs no live world, so it
    still works after a failed run killed the ranks, which is when the
    run report is written."""
    from ..analysis import knobs
    if tdir is None:
        tdir = knobs.get_str(recorder_lib.DIR_ENV, None)
    if not tdir or not os.path.isdir(tdir):
        return {}
    out: Dict[str, Dict[str, Any]] = {}
    for fname in sorted(os.listdir(tdir)):
        if not fname.endswith(".events.json"):
            continue
        snap = recorder_lib.read_spill(os.path.join(tdir, fname))
        if snap is not None:
            label = fname[:-len(".events.json")]
            out[label.replace("rank", "", 1) if label.startswith("rank")
                else label] = snap
    return out


def probe_snapshot_record(probe: str, *, profiler: Any = None,
                          serve: Any = None,
                          **extra: Any) -> Dict[str, Any]:
    """A probe's trailing ``kind="telemetry"`` stdout record: driver
    events and the compile count (and optionally profiler / serve
    metrics) as one MetricsRegistry snapshot.  The record stays
    value-less (no ``value`` key, enforced here), so a parser that takes
    the newest line with a ``value`` keeps reading the probe's own
    metric record."""
    reg = MetricsRegistry()
    if profiler is not None:
        reg.add_profiler(profiler, rank="driver")
    if serve is not None:
        reg.add_serve(serve, rank="driver")
    reg.add_events(recorder_lib.get_recorder().events(), rank="driver")
    reg.add_compile_count(rank="driver")
    if "value" in extra:
        raise ValueError(
            "a telemetry snapshot record must stay value-less (a "
            "'value'-keyed line is read as the probe's metric)")
    rec: Dict[str, Any] = {"probe": probe, "kind": "telemetry",
                           "snapshot": reg.to_json(),
                           "prometheus_lines": len(
                               reg.prometheus_text().splitlines())}
    rec.update(extra)
    return rec


# --------------------------------------------------------------------- #
# Run report (crash postmortem artifact)                                 #
# --------------------------------------------------------------------- #
def build_run_report(*, error: Optional[BaseException] = None,
                     trace_id: Optional[str] = None,
                     rank_events: Optional[Mapping[str, Any]] = None,
                     stall_diagnosis: Optional[Mapping[str, Any]] = None,
                     registry: Optional[MetricsRegistry] = None,
                     include_driver: bool = True,
                     extra: Optional[Mapping[str, Any]] = None
                     ) -> Dict[str, Any]:
    """The ``run_report.json`` payload.  ``rank_events`` maps rank labels
    to spill/wire snapshots (or bare event lists); the driver's own ring
    is added automatically.  Every field is best-effort — a postmortem
    writer must not raise past the error it documents."""
    ranks: Dict[str, Dict[str, Any]] = {}
    if include_driver:
        rec = recorder_lib.get_recorder()
        ranks["driver"] = rec.snapshot()
        if trace_id is None:
            trace_id = rec.trace_id
    for label, snap in (rank_events or {}).items():
        if str(label) in ranks:
            # the live driver ring already landed; a spill of the same
            # rank is up to one throttle tick stale — never clobber the
            # crash-adjacent events with it
            continue
        if isinstance(snap, (list, tuple)):
            snap = {"events": list(snap)}
        ranks[str(label)] = dict(snap)
    err = None
    if error is not None:
        err = {"type": type(error).__name__,
               "message": str(error)[:2000],
               "rank": getattr(error, "rank", None)}
        diag = getattr(error, "diagnosis", None)
        if diag:
            err["diagnosis"] = dict(diag)
    compiles = None
    try:
        from ..analysis import compile_guard
        compiles = compile_guard.compile_count()
    except Exception:  # the report still writes
        pass
    report: Dict[str, Any] = {
        "schema": REPORT_SCHEMA,
        "kind": "run_report",
        "trace_id": trace_id,
        "written_unix": time.time(),
        "error": err,
        "stall_diagnosis": (dict(stall_diagnosis)
                            if stall_diagnosis else None),
        "compile": {"driver_backend_compiles": compiles},
        "ranks": ranks,
        "metrics": registry.to_json() if registry is not None else None,
    }
    if extra:
        report["extra"] = dict(extra)
    return report


def write_run_report(path: str, **kwargs: Any) -> Optional[str]:
    """Write ``build_run_report(**kwargs)`` to ``path`` (a directory gets
    ``run_report.json`` appended).  Atomic tmp+rename; returns the final
    path, or None on failure — a postmortem write error is logged, never
    raised over the run's real exception."""
    try:
        report = build_run_report(**kwargs)
        if os.path.isdir(path) or not path.endswith(".json"):
            path = os.path.join(path, REPORT_BASENAME)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(report, f, default=str)
        os.replace(tmp, path)
        log.warning("run report written: %s", path)
        return path
    except Exception as e:
        log.warning("failed to write run report to %s: %s", path, e)
        return None
