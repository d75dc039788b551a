"""Telemetry: the flight recorder, trace ids, the metrics registry, the
perf observatory and the run report.

- :mod:`.recorder`: the bounded per-process event ring, with trace-id
  propagation and crash-observable spill files;
- :mod:`.registry`: the driver-side :class:`MetricsRegistry` (merged
  Profiler / ServeMetrics / compile counts / ledgers as JSON and
  Prometheus text) and the ``run_report.json`` writer;
- :mod:`.perf`: :class:`StepTimeline` (per-step phases),
  :class:`HbmLedger` (per-pool device bytes and the leak alarm) and
  :class:`GoodputLedger` (a run's wall-time partition);
- :mod:`.live`: the live plane, a loopback :class:`TelemetryServer` a
  process (``/metrics``, ``/statusz``, ``/healthz``, ``/snapshot``,
  started by ``RLA_TPU_METRICS_PORT``) and the driver's
  :class:`ClusterView` over the ranks.
"""

from .live import (ClusterView, LiveSources, TelemetryServer,
                   classify_health, get_server, maybe_start_from_env,
                   portfile_for, read_portfile, scrape_rank,
                   shutdown_server)
from .perf import (GOODPUT_CATEGORIES, PHASE_KINDS, GoodputLedger,
                   HbmLedger, PerfObservatory, StepTimeline,
                   exposed_comm_crosscheck, placed_bytes_total,
                   tree_nbytes)
from .recorder import (EMBED_TAIL_N, EVENT_KINDS, FlightRecorder,
                       configure, current_rank, current_trace_id, emit,
                       get_recorder, mint_trace_id, read_spill,
                       set_trace_id, spill_path_for, tail_events)
from .registry import (MetricsRegistry, build_run_report,
                       gather_spill_dir, gather_worker_tails,
                       probe_snapshot_record, write_run_report)

__all__ = [
    "FlightRecorder", "EVENT_KINDS", "EMBED_TAIL_N",
    "get_recorder", "configure", "emit",
    "mint_trace_id", "set_trace_id", "current_trace_id", "current_rank",
    "spill_path_for", "read_spill", "tail_events",
    "MetricsRegistry", "gather_worker_tails", "gather_spill_dir",
    "build_run_report", "write_run_report", "probe_snapshot_record",
    "PerfObservatory", "StepTimeline", "HbmLedger", "GoodputLedger",
    "PHASE_KINDS", "GOODPUT_CATEGORIES", "exposed_comm_crosscheck",
    "tree_nbytes", "placed_bytes_total",
    "TelemetryServer", "LiveSources", "ClusterView", "classify_health",
    "maybe_start_from_env", "get_server", "shutdown_server",
    "portfile_for", "read_portfile", "scrape_rank",
]
