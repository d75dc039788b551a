"""Live telemetry plane: per-rank HTTP endpoints and a driver ClusterView.

Port of the JAX package's ``telemetry/live.py``, with its constants,
thresholds, endpoint codes and payload keys.  The registry, the event
ring and the perf ledgers are end-of-run or post-crash reads; this
module serves the same ledgers while the run is still going:

- **TelemetryServer**: one stdlib ``ThreadingHTTPServer`` a process,
  bound to loopback only (a remote read rides the host agent's ``live``
  op, never an open port), serving

  - ``/metrics``: Prometheus text built at scrape time from the
    process's live sources (the trainer's profiler, the perf
    observatory, every running engine's ``ServeMetrics``, the event
    tallies, the compile count) through ``MetricsRegistry``;
  - ``/statusz``: JSON: the event tail, recent step-timeline rows, the
    HBM pools, goodput, ``global_step``, the trace id, the serve and
    SLO gauges (what ``scripts/rla_top.py`` renders);
  - ``/healthz``: ``ok | slow | wedged`` from this rank's own heartbeat
    with the thresholds of ``runtime/watchdog.py`` (a hung rank's
    ``/healthz`` reads wedged before the watchdog reaps it); HTTP 503
    when wedged;
  - ``/snapshot``: the mergeable shape (profiler ``export_state``,
    events, serve snapshots, perf ledgers) the ClusterView folds.

  The server starts only with ``RLA_TPU_METRICS_PORT`` set (0 =
  ephemeral).  A worker always binds an ephemeral port and publishes it
  in an atomic portfile under ``RLA_TPU_TELEMETRY_DIR``
  (``rank<i>.port.json``, ``driver.port.json``).  It is started on the
  driver by ``Trainer.fit`` and ``ServeEngine.start``, and in each
  worker by ``runtime.actors._worker_main`` after the fork (a thread or
  socket opened before the fork would be inherited dead).

- **ClusterView**: the driver's aggregator.  It collects every rank's
  ``/snapshot`` (a local ``Worker`` scrapes its portfile's endpoint, a
  ``RemoteWorker`` relays the agent's ``live`` op so the scrape happens
  on the rank's host) into one rank-labeled ``MetricsRegistry``, shown
  on the driver's ``/metrics`` and kept in ``run_report.json`` as the
  last view before a death.

A scrape reads host values only: profiler exports, the event ring,
ledger snapshots and byte counts from tensor metadata.  Nothing reached
from ``LiveHandler.do_GET`` or ``ClusterView.refresh`` calls ``.item()``,
``tolist()``, ``Event.elapsed_time`` or a synchronize, so a scrape never
stalls the CUDA stream of the step it observes.  The module imports no
torch.
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Mapping, Optional
from urllib.request import ProxyHandler, build_opener

from ..analysis import knobs
from . import recorder as recorder_lib
from .registry import MetricsRegistry

PORT_ENV = "RLA_TPU_METRICS_PORT"
REFRESH_ENV = "RLA_TPU_LIVE_REFRESH_S"

DEFAULT_REFRESH_S = 2.0
# the Prometheus text exposition content type (its version is part of
# the scrape contract)
PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
# /statusz carries a bounded tail, never the whole ring
STATUSZ_TAIL_N = 32
FETCH_TIMEOUT_S = 2.0

log = recorder_lib.log

HEALTH_OK = "ok"
HEALTH_SLOW = "slow"
HEALTH_WEDGED = "wedged"


def classify_health(beat: Optional[Mapping[str, Any]],
                    wedge_timeout_s: Optional[float] = None,
                    boot_grace_s: Optional[float] = None,
                    dispatch_deadline_s: Optional[float] = None
                    ) -> Dict[str, Any]:
    """``ok | slow | wedged`` from a heartbeat snapshot, by the driver
    watchdog's rules: a beat older than ``RLA_TPU_WEDGE_TIMEOUT_S`` (the
    boot grace while the rank never beat) or busy past a dispatch
    deadline is wedged; busy past half the trigger is slow.  The
    defaults are ``runtime/watchdog.py``'s, so ``/healthz`` and the
    reaper agree.  ``beat=None`` (no channel: the driver, or heartbeats
    off) is liveness only and reads ``ok``.

    ``dispatch_deadline_s`` is ``Watchdog(dispatch_deadline_s=)``, a
    driver-side argument with no knob: a rank's own ``/healthz`` applies
    the staleness and straggler rules only."""
    # imported here: the watchdog imports the telemetry package
    from ..runtime import watchdog
    if beat is None:
        return {"status": HEALTH_OK,
                "detail": "no heartbeat channel (liveness-only)"}
    if wedge_timeout_s is None:
        wedge_timeout_s = knobs.get_float(watchdog.WEDGE_ENV,
                                          watchdog.DEFAULT_WEDGE_TIMEOUT_S)
    if boot_grace_s is None:
        boot_grace_s = watchdog.DEFAULT_BOOT_GRACE_S
    boot_grace_s = max(boot_grace_s, wedge_timeout_s)
    out: Dict[str, Any] = dict(beat)
    out["wedge_timeout_s"] = wedge_timeout_s
    started = beat.get("started", True)
    stale_after = wedge_timeout_s if started else boot_grace_s
    age = float(beat.get("beat_age_s") or 0.0)
    busy = beat.get("busy_s")
    # the slow trigger is the watchdog's: half the dispatch deadline when
    # one is set, else half the wedge timeout
    trigger = (dispatch_deadline_s if dispatch_deadline_s is not None
               else wedge_timeout_s)
    if age > stale_after:
        what = "wedge timeout" if started else "boot grace"
        out["status"] = HEALTH_WEDGED
        out["detail"] = (f"heartbeat stale {age:.2f}s > {what} "
                         f"{stale_after:.2f}s")
    elif busy is not None and dispatch_deadline_s is not None \
            and busy > dispatch_deadline_s:
        out["status"] = HEALTH_WEDGED
        out["detail"] = (f"dispatch busy {busy:.2f}s > deadline "
                         f"{dispatch_deadline_s:.2f}s")
    elif busy is not None and busy > trigger / 2.0:
        out["status"] = HEALTH_SLOW
        out["detail"] = (f"dispatch busy {busy:.2f}s (straggler past "
                         f"{trigger / 2.0:.2f}s)")
    else:
        out["status"] = HEALTH_OK
    return out


# --------------------------------------------------------------------- #
# Live sources (what the endpoints read at scrape time)                   #
# --------------------------------------------------------------------- #
class LiveSources:
    """The bindings the server reads at each scrape; nothing is copied
    at bind time, so the endpoints show the process's current state.
    ``bind_trainer`` wires a fitting trainer (profiler, perf
    observatory, global step), ``add_serve`` a running engine's
    ``ServeMetrics`` and SLO tracker, ``bind_cluster_view`` the driver's
    merged view of the ranks."""

    def __init__(self, rank: Optional[int] = None,
                 beat_snapshot_fn: Optional[Callable[[], Any]] = None,
                 dispatch_deadline_s: Optional[float] = None):
        self.rank = rank
        self.beat_snapshot_fn = beat_snapshot_fn
        # the watchdog's per-dispatch deadline (see classify_health)
        self.dispatch_deadline_s = dispatch_deadline_s
        self._lock = threading.Lock()
        self._trainer: Any = None
        self._serve: Dict[str, Any] = {}
        self._slo: Dict[str, Any] = {}
        self._cluster_view: Any = None
        # the serve tier's replica controller (ServeReplicas binds it):
        # its per-replica table rides /statusz and the replica gauges
        self._replica_controller: Any = None

    # -- binds ---------------------------------------------------------- #
    def bind_trainer(self, trainer: Any) -> None:
        with self._lock:
            self._trainer = trainer

    def add_serve(self, label: str, metrics: Any, slo: Any = None) -> None:
        with self._lock:
            self._serve[str(label)] = metrics
            if slo is not None:
                self._slo[str(label)] = slo

    def remove_serve(self, label: str) -> None:
        with self._lock:
            self._serve.pop(str(label), None)
            self._slo.pop(str(label), None)

    def bind_cluster_view(self, view: Any) -> None:
        with self._lock:
            self._cluster_view = view

    def bind_replica_controller(self, controller: Any) -> None:
        """Wire (None: unwire) a replica controller, so its per-replica
        table is scrapeable (``/statusz`` ``replica_controller`` and the
        ``rla_tpu_serve_replica_*`` gauges).  The last bound wins; a
        group that shuts down uses ``unbind_replica_controller``."""
        with self._lock:
            self._replica_controller = controller

    def unbind_replica_controller(self, controller: Any) -> None:
        """Unwire ``controller`` only if it is the one bound (a group
        that shut down must not unbind a sibling bound after it)."""
        with self._lock:
            if self._replica_controller is controller:
                self._replica_controller = None

    def _bound(self):
        with self._lock:
            return (self._trainer, dict(self._serve), dict(self._slo),
                    self._cluster_view)

    def _controller(self) -> Any:
        with self._lock:
            return self._replica_controller

    # -- reads ---------------------------------------------------------- #
    @property
    def rank_label(self) -> str:
        return "driver" if self.rank is None else str(self.rank)

    def _beat(self) -> Optional[Dict[str, Any]]:
        fn = self.beat_snapshot_fn
        if fn is None:
            return None
        try:
            snap = fn()
        except Exception:
            return None
        return dict(snap) if snap else None

    def health(self) -> Dict[str, Any]:
        out = classify_health(
            self._beat(), dispatch_deadline_s=self.dispatch_deadline_s)
        out["rank"] = self.rank_label
        return out

    def rank_status(self) -> Dict[str, Any]:
        """The compact per-rank row the ClusterView and rla_top key on."""
        trainer, serve, _slo, _cv = self._bound()
        rec = recorder_lib.get_recorder()
        health = self.health()
        row: Dict[str, Any] = {
            "rank": self.rank_label,
            "pid": os.getpid(),
            "trace_id": rec.trace_id,
            "health": health,
            "healthy": 1.0 if health["status"] in (HEALTH_OK, HEALTH_SLOW)
            else 0.0,
            "events_per_second": round(rec.events_per_second(), 4),
        }
        if trainer is not None:
            row["global_step"] = int(getattr(trainer, "global_step", 0))
            row["epoch"] = int(getattr(trainer, "current_epoch", 0))
        if serve:
            row["serve_engines"] = sorted(serve)
        return row

    def build_registry(self) -> MetricsRegistry:
        """The registry behind ``/metrics``: the bound trainer's
        (``build_metrics_registry``, the end-of-run export's code) or a
        recorder-only base, plus every bound engine's ``ServeMetrics``,
        this rank's status row and, on the driver, the ClusterView's
        ranks."""
        trainer, serve, _slo, cv = self._bound()
        reg: Optional[MetricsRegistry] = None
        if trainer is not None:
            try:
                reg = trainer.build_metrics_registry()
            except Exception as e:  # a scrape degrades, never 500s
                log.warning("live registry build via trainer failed: %s", e)
                reg = None
        if reg is None:
            reg = MetricsRegistry(
                trace_id=recorder_lib.current_trace_id())
            reg.add_events(recorder_lib.get_recorder().events(),
                           rank=self.rank_label)
            try:
                reg.add_compile_count(rank=self.rank_label)
            except Exception:
                pass
        for label, m in serve.items():
            reg.add_serve(m, rank=label)
        rc = self._controller()
        if rc is not None:
            try:
                reg.add_replica_controller(rc.snapshot())
            except Exception as e:  # a scrape degrades, never 500s
                log.warning("replica-controller export failed: %s", e)
        reg.add_rank_status(self.rank_label, self.rank_status())
        reg.add_scalar("events_per_second",
                       recorder_lib.get_recorder().events_per_second())
        if cv is not None \
                and getattr(trainer, "_cluster_view", None) is not cv:
            # a trainer that owns this view merged it already; merging
            # twice would count its ranks twice
            try:
                cv.merge_into(reg)
            except Exception as e:
                log.warning("cluster-view merge failed: %s", e)
        return reg

    def statusz(self) -> Dict[str, Any]:
        """The human- and CLI-facing JSON: identity, health and the
        recent slices of every live ledger (bounded: the whole ring and
        reservoirs stay behind ``/snapshot``)."""
        trainer, serve, slo, cv = self._bound()
        rec = recorder_lib.get_recorder()
        out: Dict[str, Any] = self.rank_status()
        out["ts"] = round(time.monotonic(), 6)
        out["flight_tail"] = rec.tail(STATUSZ_TAIL_N)
        if trainer is not None:
            perf = getattr(trainer, "perf", None)
            if perf is not None:
                tl = perf.timeline.snapshot()
                out["step_timeline"] = {
                    k: tl.get(k) for k in
                    ("steps", "mean_step_ms", "phase_sum_over_wall",
                     "attributed_fraction")}
                out["recent_steps"] = tl.get("recent_steps", [])[-8:]
                hbm = perf.hbm.snapshot()
                out["hbm"] = {"total_bytes": hbm["total_bytes"],
                              "attributed_fraction":
                                  hbm["attributed_fraction"],
                              "pools": {k: v["bytes"] for k, v in
                                        hbm["pools"].items()},
                              "leak_alarms": hbm["leak_alarms"]}
                gp = perf.goodput.snapshot()
                if gp["wall_s"] > 0:
                    out["goodput"] = gp
        if serve:
            out["serve"] = {label: m.snapshot()
                            for label, m in serve.items()}
        if slo:
            out["slo"] = {label: t.snapshot() for label, t in slo.items()}
        rc = self._controller()
        if rc is not None:
            try:
                out["replica_controller"] = rc.snapshot()
            except Exception:
                pass
        if cv is not None:
            out["cluster"] = cv.last_view()
        return out

    def snapshot(self) -> Dict[str, Any]:
        """The mergeable shape ``ClusterView.refresh`` collects: what
        ``MetricsRegistry`` folds (profiler ``export_state``, the events,
        serve snapshots, perf ledgers, the compile count) and the status
        row."""
        trainer, serve, _slo, _cv = self._bound()
        rec = recorder_lib.get_recorder()
        out: Dict[str, Any] = {
            "rank": self.rank_label,
            "status": self.rank_status(),
            "events": rec.events(),
        }
        if trainer is not None:
            prof = getattr(trainer, "profiler", None)
            if prof is not None:
                out["profiler"] = prof.export_state()
            perf = getattr(trainer, "perf", None)
            if perf is not None:
                out["perf"] = {
                    "step_timeline": perf.timeline.snapshot(),
                    "hbm": perf.hbm.snapshot()}
        if serve:
            out["serve"] = {label: m.snapshot()
                            for label, m in serve.items()}
        rc = self._controller()
        if rc is not None:
            try:
                out["replica_controller"] = rc.snapshot()
            except Exception:
                pass
        try:
            from ..analysis import compile_guard
            out["compile"] = compile_guard.compile_count()
        except Exception:
            pass
        return out


# --------------------------------------------------------------------- #
# HTTP server                                                             #
# --------------------------------------------------------------------- #
class _LiveHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    # the sources the handler reads (set by TelemetryServer.start)
    rla_sources: LiveSources = None  # type: ignore[assignment]


class LiveHandler(BaseHTTPRequestHandler):
    """The four endpoints.  Each GET builds its payload from the live
    sources: no cache to go stale, and nothing runs unless someone
    looks."""

    server_version = "rla-tpu-live/1"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # the stdlib default spams stderr
        pass

    def do_GET(self) -> None:  # noqa: N802 (the stdlib handler contract)
        sources: LiveSources = self.server.rla_sources
        path = self.path.split("?", 1)[0]
        try:
            if path == "/metrics":
                body = sources.build_registry().prometheus_text()
                self._reply(200, PROM_CONTENT_TYPE, body.encode())
            elif path == "/statusz":
                self._json(200, sources.statusz())
            elif path == "/healthz":
                health = sources.health()
                code = 200 if health["status"] != HEALTH_WEDGED else 503
                self._json(code, health)
            elif path == "/snapshot":
                self._json(200, sources.snapshot())
            else:
                self._json(404, {"error": f"unknown path {path!r}",
                                 "paths": ["/metrics", "/statusz",
                                           "/healthz", "/snapshot"]})
        except Exception as e:  # a broken source must not kill the server
            try:
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
            except Exception:
                pass

    def _json(self, code: int, payload: Mapping[str, Any]) -> None:
        self._reply(code, "application/json",
                    json.dumps(payload, default=str).encode())

    def _reply(self, code: int, ctype: str, body: bytes) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def portfile_for(rank: Optional[int],
                 env: Optional[Mapping[str, str]] = None) -> Optional[str]:
    """Where ``rank``'s server publishes its port under
    ``RLA_TPU_TELEMETRY_DIR`` (None without a directory)."""
    tdir = knobs.get_str(recorder_lib.DIR_ENV, None, env=env)
    if not tdir:
        return None
    label = "driver" if rank is None else f"rank{int(rank)}"
    return os.path.join(tdir, f"{label}.port.json")


def read_portfile(path: Optional[str]) -> Optional[Dict[str, Any]]:
    """A published port record, or None (a missing or torn file is a
    normal state around process churn, never an error)."""
    if not path:
        return None
    try:
        with open(path) as f:
            rec = json.load(f)
    except (OSError, ValueError):
        return None
    return rec if isinstance(rec, dict) and rec.get("port") else None


# no proxies: every fetch of the plane goes to loopback, and a host's
# http_proxy would route 127.0.0.1 through the proxy
_OPENER = build_opener(ProxyHandler({}))


def fetch_json(url: str,
               timeout: float = FETCH_TIMEOUT_S) -> Optional[Dict[str, Any]]:
    """GET ``url`` (no proxies) and parse the JSON; None on any failure
    (an unreachable rank is a fact to report, not an exception)."""
    try:
        with _OPENER.open(url, timeout=timeout) as resp:
            payload = json.loads(resp.read().decode())
    except Exception:
        return None
    return payload if isinstance(payload, dict) else None


def scrape_rank(rank: Optional[int],
                env: Optional[Mapping[str, str]] = None,
                path: str = "/snapshot") -> Optional[Dict[str, Any]]:
    """One local rank's endpoint, found through its portfile: the
    driver's half of ``Worker.live_snapshot`` (a remote rank goes
    through the agent's ``live`` op, which calls this on its host)."""
    rec = read_portfile(portfile_for(rank, env=env))
    if rec is None:
        return None
    return fetch_json(f"http://127.0.0.1:{rec['port']}{path}")


class TelemetryServer:
    """One process's live-telemetry HTTP server, bound to loopback.

    ``port``: the bind port; 0 = ephemeral; None reads
    ``RLA_TPU_METRICS_PORT``.  ``start()`` binds, publishes the portfile
    (with a telemetry directory) and serves from a daemon thread;
    ``shutdown()`` unbinds and removes the portfile."""

    def __init__(self, sources: Optional[LiveSources] = None,
                 port: Optional[int] = None,
                 rank: Optional[int] = None,
                 env: Optional[Mapping[str, str]] = None):
        self.sources = sources or LiveSources(rank=rank)
        if port is None:
            port = knobs.get_int(PORT_ENV, None, env=env)
        self._requested_port = int(port or 0)
        self.rank = rank if rank is not None else self.sources.rank
        self._env = dict(env) if env else None
        self._httpd: Optional[_LiveHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._portfile: Optional[str] = None

    @property
    def port(self) -> Optional[int]:
        return (self._httpd.server_address[1]
                if self._httpd is not None else None)

    @property
    def url(self) -> Optional[str]:
        p = self.port
        return f"http://127.0.0.1:{p}" if p else None

    def start(self) -> "TelemetryServer":
        if self._httpd is not None:
            return self
        httpd = _LiveHTTPServer(("127.0.0.1", self._requested_port),
                                LiveHandler)
        httpd.rla_sources = self.sources
        self._httpd = httpd
        self._thread = threading.Thread(
            target=httpd.serve_forever, kwargs={"poll_interval": 0.2},
            daemon=True, name="rla-tpu-live-telemetry")
        self._thread.start()
        self._publish_portfile()
        log.warning("live telemetry serving on %s (rank %s)",
                    self.url, self.sources.rank_label)
        return self

    def _publish_portfile(self) -> None:
        path = portfile_for(self.rank, env=self._env)
        if path is None:
            return
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(tmp, "w") as f:
                json.dump({"rank": self.sources.rank_label,
                           "pid": os.getpid(), "port": self.port,
                           "url": self.url}, f)
            os.replace(tmp, path)
            self._portfile = path
        except OSError as e:  # discovery degrades; the server still runs
            try:
                os.unlink(tmp)
            except OSError:
                pass
            log.warning("live telemetry portfile %s failed: %s", path, e)

    def shutdown(self) -> None:
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self._portfile:
            try:
                os.unlink(self._portfile)
            except OSError:
                pass
            self._portfile = None

    def __enter__(self) -> "TelemetryServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()


# --------------------------------------------------------------------- #
# The process's server                                                    #
# --------------------------------------------------------------------- #
_server: Optional[TelemetryServer] = None
_server_lock = threading.Lock()


def get_server() -> Optional[TelemetryServer]:
    return _server


def maybe_start_from_env(rank: Optional[int] = None,
                         env: Optional[Mapping[str, str]] = None,
                         beat_snapshot_fn: Optional[Callable[[], Any]]
                         = None) -> Optional[TelemetryServer]:
    """Start this process's server (once) when ``RLA_TPU_METRICS_PORT``
    is set; None when it is unset or the bind failed.  A worker
    (``rank`` given) always binds an ephemeral port: a fixed one would
    collide between the ranks of a host; the portfile is the discovery
    channel either way.  A failure warns and leaves no server: the plane
    observes a run and never takes one down."""
    global _server
    port = knobs.get_int(PORT_ENV, None, env=env)
    if port is None:
        return _server
    with _server_lock:
        if _server is not None:
            return _server
        try:
            srv = TelemetryServer(
                sources=LiveSources(rank=rank,
                                    beat_snapshot_fn=beat_snapshot_fn),
                port=0 if rank is not None else port,
                rank=rank, env=env)
            _server = srv.start()
        except Exception as e:
            log.warning("live telemetry server failed to start: %s", e)
            _server = None
        return _server


def shutdown_server() -> None:
    global _server
    with _server_lock:
        srv, _server = _server, None
    if srv is not None:
        srv.shutdown()


def _reset_for_tests() -> None:
    shutdown_server()


# --------------------------------------------------------------------- #
# ClusterView (the driver's aggregator)                                   #
# --------------------------------------------------------------------- #
class ClusterView:
    """Collects every rank's live ``/snapshot`` into one rank-labeled
    view, now (``refresh``) or every ``RLA_TPU_LIVE_REFRESH_S`` from a
    thread (``start``).

    ``workers``: pool workers with ``live_snapshot()`` (a ``Worker``
    scrapes its rank's portfile endpoint; a ``RemoteWorker`` relays the
    agent's ``live`` op, so the scrape happens on the rank's host).
    Without workers the telemetry directory's portfiles are scanned:
    the pool-free mode of rla_top and serving.  A dead or unreachable
    rank drops out of a sweep, and its last good snapshot stays in the
    view: what the run report keeps after a crash."""

    def __init__(self, workers: Optional[List[Any]] = None,
                 refresh_s: Optional[float] = None,
                 env: Optional[Mapping[str, str]] = None):
        if refresh_s is None:
            refresh_s = knobs.get_float(REFRESH_ENV, DEFAULT_REFRESH_S,
                                        env=env)
        self.refresh_s = max(0.05, float(refresh_s))
        self.workers = list(workers) if workers is not None else None
        self._env = dict(env) if env else None
        self._lock = threading.Lock()
        self._view: Dict[str, Dict[str, Any]] = {}
        self._refreshed_at: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- collection ----------------------------------------------------- #
    def _scan_portfiles(self) -> Dict[str, Dict[str, Any]]:
        tdir = knobs.get_str(recorder_lib.DIR_ENV, None, env=self._env)
        if not tdir or not os.path.isdir(tdir):
            return {}
        out: Dict[str, Dict[str, Any]] = {}
        for fname in sorted(os.listdir(tdir)):
            if not fname.endswith(".port.json"):
                continue
            label = fname[:-len(".port.json")]
            if label == "driver":
                continue  # the driver's own sources are local
            rec = read_portfile(os.path.join(tdir, fname))
            if rec is None:
                continue
            snap = fetch_json(f"http://127.0.0.1:{rec['port']}/snapshot")
            if snap:
                out[label.replace("rank", "", 1)
                    if label.startswith("rank") else label] = snap
        return out

    def refresh(self) -> Dict[str, Dict[str, Any]]:
        """One sweep; returns {rank label: snapshot}.  A rank that did
        not answer is absent from this sweep's result, and the view
        keeps its last good snapshot."""
        snaps: Dict[str, Dict[str, Any]] = {}
        if self.workers is not None:
            for w in self.workers:
                fn = getattr(w, "live_snapshot", None)
                if fn is None:
                    continue
                try:
                    snap = fn()
                except Exception:
                    snap = None
                if snap:
                    snaps[str(getattr(w, "rank", "?"))] = snap
        else:
            snaps = self._scan_portfiles()
        with self._lock:
            self._view.update(snaps)
            self._refreshed_at = time.monotonic()
        return snaps

    # -- export --------------------------------------------------------- #
    def view(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {k: dict(v) for k, v in self._view.items()}

    def last_view(self) -> Dict[str, Any]:
        """The compact JSON form for ``/statusz`` and the run report:
        each rank's status row and serve gauges (profiler reservoirs and
        event rings stay out; the spill files carry the timelines)."""
        with self._lock:
            view = {k: dict(v) for k, v in self._view.items()}
            refreshed = self._refreshed_at
        ranks: Dict[str, Any] = {}
        for label, snap in view.items():
            row = dict(snap.get("status") or {})
            if snap.get("serve"):
                row["serve"] = snap["serve"]
            if snap.get("compile") is not None:
                row["compile"] = snap["compile"]
            ranks[label] = row
        return {
            "refreshed_age_s": (round(time.monotonic() - refreshed, 3)
                                if refreshed is not None else None),
            "ranks": ranks,
        }

    def merge_into(self, reg: MetricsRegistry,
                   skip_mergeables: Any = ()) -> MetricsRegistry:
        """Fold the last view into ``reg`` rank-labeled: profilers merge
        reservoir-correct, events tally, serve snapshots and status rows
        keep their rank labels.  ``skip_mergeables``: rank labels whose
        profiler, events and serve data are in the registry already
        (the fan-out's telemetry shipped home): only their status rows
        are added, so nothing counts twice."""
        skip = {str(s) for s in skip_mergeables}
        for label, snap in self.view().items():
            if snap.get("status"):
                reg.add_rank_status(label, snap["status"])
            if label in skip:
                continue
            if snap.get("profiler"):
                reg.add_profiler(snap["profiler"], rank=label)
            if snap.get("events"):
                reg.add_events(snap["events"], rank=label)
            for slabel, s in (snap.get("serve") or {}).items():
                reg.add_serve(s, rank=f"{label}:{slabel}")
            if snap.get("compile") is not None:
                reg.add_compile_count(int(snap["compile"]), rank=label)
        return reg

    def merged_registry(self) -> MetricsRegistry:
        return self.merge_into(MetricsRegistry())

    # -- background refresh --------------------------------------------- #
    def start(self) -> "ClusterView":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, daemon=True,
                name="rla-tpu-cluster-view")
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.refresh_s):
            try:
                self.refresh()
            except Exception as e:  # observation never crashes
                log.warning("cluster-view refresh failed: %s", e)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "ClusterView":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
