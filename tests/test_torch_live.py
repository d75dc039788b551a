"""The live telemetry plane of the PyTorch port (``telemetry/live.py``,
``SloTracker.burn_rate`` / ``snapshot``), held against the JAX package's
on the CPU, test by test from tests/test_live.py (the replica tier's
tests wait for its slice).  Tolerances:

- exact: ``classify_health``'s dict, the portfile's path and keys, each
  endpoint's code and key set, the ClusterView's Prometheus text line
  for line, the run report's ``cluster_view`` keys;
- 1e-12: the SLO burn rate and the snapshot's rates.

Multi-process tests run 2 layers at d 128 or the boring model, at most
2 ranks, torch threads capped at 2 in the workers, and bound every wait.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from ray_lightning_accelerators_tpu.serve.slo import SloPolicy as JaxPolicy
from ray_lightning_accelerators_tpu.serve.slo import SloTracker as JaxTracker
from ray_lightning_accelerators_tpu.telemetry import live as jax_live
from ray_lightning_accelerators_tpu.telemetry import recorder as jax_rec
from ray_lightning_accelerators_tpu.telemetry.registry import (
    MetricsRegistry as JaxRegistry)
from ray_lightning_accelerators_tpu_torch import (DataLoader,
                                                  HorovodRayAccelerator,
                                                  RayTPUAccelerator, Trainer)
from ray_lightning_accelerators_tpu_torch.data.loader import (ArrayDataset,
                                                              RandomDataset)
from ray_lightning_accelerators_tpu_torch.runtime import agent, bootstrap
from ray_lightning_accelerators_tpu_torch.runtime.actors import (ActorPool,
                                                                 Worker)
from ray_lightning_accelerators_tpu_torch.runtime.watchdog import (
    Watchdog, WorkerWedged)
from ray_lightning_accelerators_tpu_torch.serve.metrics import ServeMetrics
from ray_lightning_accelerators_tpu_torch.serve.slo import (SloPolicy,
                                                            SloTracker)
from ray_lightning_accelerators_tpu_torch.telemetry import live
from ray_lightning_accelerators_tpu_torch.telemetry import recorder as R
from ray_lightning_accelerators_tpu_torch.telemetry.registry import (
    MetricsRegistry)
from ray_lightning_accelerators_tpu_torch.utils.profiler import Profiler

from . import torch_boring
from .torch_boring import BoringModel
from .utils import assert_prometheus_exposition

pytestmark = pytest.mark.live
torch.set_num_threads(2)

HB = 0.05
WAIT = 60


@pytest.fixture(autouse=True)
def _fresh_live_plane(monkeypatch):
    """Each test gets a clean process server and recorder, in both
    packages, and bounded worlds."""
    monkeypatch.setattr(bootstrap, "DEFAULT_TIMEOUT_S", 60.0)
    for mod in (live, R, jax_live, jax_rec):
        mod._reset_for_tests()
    yield
    for mod in (live, R, jax_live, jax_rec):
        mod._reset_for_tests()


def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read().decode()


def _code_and_body(url):
    try:
        return _get(url)
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _until(pred, timeout=WAIT, every=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out = pred()
        if out:
            return out
        time.sleep(every)
    return pred()


# --------------------------------------------------------------------- #
# classify_health and the SLO tracker, against the JAX package's          #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("beat,kw", [
    (None, {}),
    ({"beat_age_s": 0.1, "busy_s": None, "started": True},
     {"wedge_timeout_s": 1.0}),
    ({"beat_age_s": 0.1, "busy_s": 0.8, "started": True},     # slow
     {"wedge_timeout_s": 1.0}),
    ({"beat_age_s": 1.5, "busy_s": None, "started": True},    # stale
     {"wedge_timeout_s": 1.0}),
    ({"beat_age_s": 1.5, "busy_s": None, "started": False},   # booting
     {"wedge_timeout_s": 1.0, "boot_grace_s": 60.0}),
    ({"beat_age_s": 200.0, "busy_s": None, "started": False}, {}),
    ({"beat_age_s": 0.1, "busy_s": 40.0, "started": True},    # deadline
     {"wedge_timeout_s": 60.0, "dispatch_deadline_s": 30.0}),
    ({"beat_age_s": 0.1, "busy_s": 20.0, "started": True},
     {"wedge_timeout_s": 60.0, "dispatch_deadline_s": 30.0}),
    ({"beat_age_s": 61.0, "busy_s": None, "started": True}, {}),
    ({"beat_age_s": 0.2, "busy_s": 31.0, "started": True, "dispatches": 3},
     {}),
])
def test_classify_health_matches_jax(beat, kw, monkeypatch):
    """The exact dict, with the default thresholds (the watchdog's 60 s
    wedge timeout and 120 s boot grace) and with the knob set."""
    monkeypatch.delenv("RLA_TPU_WEDGE_TIMEOUT_S", raising=False)
    assert live.classify_health(beat, **kw) == \
        jax_live.classify_health(beat, **kw)
    monkeypatch.setenv("RLA_TPU_WEDGE_TIMEOUT_S", "30")
    assert live.classify_health(beat, **kw) == \
        jax_live.classify_health(beat, **kw)


@pytest.mark.parametrize("policy", [
    dict(ttft_target_s=0.1, target_fraction=0.9),
    dict(ttft_target_s=0.1, token_cadence_target_s=0.01,
         deadline_s=1.0, target_fraction=0.99),
])
def test_slo_burn_rate_and_snapshot_match_jax(policy):
    """One observation sequence through both trackers: the burn rate and
    each family's rates within 1e-12, the snapshot's keys and policy
    equal."""
    trackers = [SloTracker(SloPolicy(**policy), window_s=60.0),
                JaxTracker(JaxPolicy(**policy), window_s=60.0)]
    rng = np.random.default_rng(0)
    obs = [(rng.choice(["ttft", "token", "deadline", "met"]),
            float(rng.uniform(0, 0.3))) for _ in range(60)]
    for t in trackers:
        assert t.burn_rate() == 0.0
        for kind, v in obs:
            if kind == "ttft":
                t.observe_ttft(v)
            elif kind == "token":
                t.observe_token(v)
            elif kind == "deadline":
                t.shed(None, v)
            else:
                t.observe_deadline_met()
    port, ref = (t.snapshot() for t in trackers)
    assert abs(trackers[0].burn_rate() - trackers[1].burn_rate()) <= 1e-12
    assert trackers[0].burn_rate() > 0
    assert set(port) == set(ref) and port["policy"] == ref["policy"]
    assert port["window_s"] == ref["window_s"]
    assert abs(port["burn_rate"] - ref["burn_rate"]) <= 1e-12
    for fam, row in ref["families"].items():
        assert port["families"][fam]["observations"] == row["observations"]
        assert port["families"][fam]["violations"] == row["violations"]
        assert abs(port["families"][fam]["violation_fraction"]
                   - row["violation_fraction"]) <= 1e-12


# --------------------------------------------------------------------- #
# The server: endpoints, codes, the portfile                              #
# --------------------------------------------------------------------- #
def test_server_endpoints_and_portfile_match_jax(tmp_path, monkeypatch):
    """Both packages' servers in this process, over one recorder history:
    each endpoint's code and key set, the 404's paths, the portfile's
    path (the JAX name) and keys; shutdown removes the portfile."""
    monkeypatch.setenv("RLA_TPU_METRICS_PORT", "0")
    seen = {}
    for name, mod, rec, sub in (("port", live, R, "p"),
                                ("jax", jax_live, jax_rec, "j")):
        monkeypatch.setenv("RLA_TPU_TELEMETRY_DIR", str(tmp_path / sub))
        rec.configure(trace_id="t-live")
        rec.emit("fit_start", step=0)
        srv = mod.maybe_start_from_env()
        assert srv is not None and srv.port and srv.url
        assert mod.maybe_start_from_env() is srv     # once a process
        out = {}
        for path in ("/metrics", "/statusz", "/healthz", "/snapshot",
                     "/nope"):
            out[path] = _code_and_body(srv.url + path)
        path = mod.portfile_for(None)
        out["portfile"] = (os.path.basename(path),
                           sorted(mod.read_portfile(path)))
        assert mod.read_portfile(path)["port"] == srv.port
        assert mod.scrape_rank(None)["rank"] == "driver"
        mod.shutdown_server()
        assert mod.read_portfile(path) is None
        seen[name] = out
    port, ref = seen["port"], seen["jax"]
    assert port["portfile"] == ref["portfile"] == (
        "driver.port.json", ["pid", "port", "rank", "url"])
    for path in ("/metrics", "/statusz", "/healthz", "/snapshot", "/nope"):
        assert port[path][0] == ref[path][0], path
    assert port["/nope"][0] == 404
    assert json.loads(port["/nope"][1]) == json.loads(ref["/nope"][1])
    for path in ("/statusz", "/healthz", "/snapshot"):
        p, j = json.loads(port[path][1]), json.loads(ref[path][1])
        assert set(p) == set(j), path
    status = json.loads(port["/statusz"][1])
    assert status["rank"] == "driver" and status["trace_id"] == "t-live"
    assert status["flight_tail"][-1]["kind"] == "fit_start"
    assert set(status["health"]) == set(
        json.loads(ref["/statusz"][1])["health"])
    body = port["/metrics"][1]
    assert_prometheus_exposition(body)
    assert 'rla_tpu_events_total{kind="fit_start"} 1' in body
    assert 'rla_tpu_rank_healthy{rank="driver"} 1' in body
    snap = json.loads(port["/snapshot"][1])
    assert [e["kind"] for e in snap["events"]] == ["fit_start"]


def test_server_disabled_without_knob(monkeypatch):
    monkeypatch.delenv("RLA_TPU_METRICS_PORT", raising=False)
    assert live.maybe_start_from_env() is None
    assert live.get_server() is None


class _Broken:
    global_step = 0

    def build_metrics_registry(self):
        raise RuntimeError("broken source")

    @property
    def perf(self):
        raise RuntimeError("broken source")


def test_wedged_503_and_broken_source_500_keep_serving():
    """A wedged beat answers 503 with the health dict; a source that
    raises answers 500 naming it, /metrics degrades to the recorder-only
    registry, and the server keeps serving."""
    beat = {"beat_age_s": 99.0, "busy_s": None, "started": True}
    sources = live.LiveSources(rank=3, beat_snapshot_fn=lambda: beat)
    with live.TelemetryServer(sources=sources, port=0) as srv:
        code, body = _code_and_body(srv.url + "/healthz")
        assert code == 503 and json.loads(body)["status"] == "wedged"
        sources.beat_snapshot_fn = None
        sources.bind_trainer(_Broken())
        code, body = _code_and_body(srv.url + "/statusz")
        assert code == 500 and "broken source" in json.loads(body)["error"]
        code, body = _code_and_body(srv.url + "/metrics")
        assert code == 200 and 'rla_tpu_rank_healthy{rank="3"} 1' in body
        assert _code_and_body(srv.url + "/healthz")[0] == 200


def test_a_scrape_reads_no_device_value(tmp_path, monkeypatch):
    """Every source a scrape touches (the profiler's export, the step
    timeline, the HBM ledger, the goodput ledger, ServeMetrics, the SLO
    tracker) is read without ``.item()``, ``tolist()``, a CUDA event's
    ``elapsed_time`` or a synchronize: counted over the three scrape
    bodies after an in-process fit with all of them bound."""
    from ray_lightning_accelerators_tpu_torch.telemetry.perf import (
        PerfObservatory)
    perf = PerfObservatory()
    perf.goodput.run_begin()
    t = Trainer(device="cpu", max_steps=3, seed=0, guard=None,
                enable_checkpointing=False, profiler=Profiler(),
                perf_observatory=perf, log_every_n_steps=10 ** 9,
                default_root_dir=str(tmp_path))
    train, _ = torch_boring.boring_loaders()
    t.fit(BoringModel(), train)
    m = ServeMetrics()
    slo = SloTracker(SloPolicy(ttft_target_s=0.1), metrics=m)
    m.bind_slo(slo.gauges)
    m.observe_prefill(0.01)
    slo.observe_ttft(0.5)
    sources = live.LiveSources(rank=0)
    sources.bind_trainer(t)
    sources.add_serve("engine0", m, slo=slo)
    calls = []

    def spy(name):
        def f(*a, **k):
            calls.append(name)
            raise AssertionError(f"a scrape called {name}")
        return f

    monkeypatch.setattr(torch.Tensor, "item", spy("item"))
    monkeypatch.setattr(torch.Tensor, "tolist", spy("tolist"))
    monkeypatch.setattr(torch.cuda, "synchronize", spy("synchronize"))
    monkeypatch.setattr(torch.cuda.Event, "elapsed_time",
                        spy("elapsed_time"))
    text = sources.build_registry().prometheus_text()
    status = sources.statusz()
    snap = sources.snapshot()
    assert calls == []
    assert "rla_tpu_step_phase_seconds_total" in text
    assert "rla_tpu_hbm_total_bytes" in text
    assert status["slo"]["engine0"]["burn_rate"] > 0
    assert status["global_step"] == 3 and snap["profiler"]["stats"]


# --------------------------------------------------------------------- #
# ServeMetrics under concurrent writers (tests/test_live.py:160)          #
# --------------------------------------------------------------------- #
def test_serve_metrics_snapshot_never_tears_under_concurrent_writers():
    """A snapshot racing observe_* calls sees each reservoir count move
    with its counter, and tokens equal prefills + steps (active 1)."""
    m = ServeMetrics()
    stop = threading.Event()
    n = 3000
    tears = []

    def prefiller():
        for _ in range(n):
            m.observe_prefill(1e-6)

    def stepper():
        for _ in range(n):
            m.observe_step(1e-6, active=1)

    def reader():
        while not stop.is_set():
            snap = m.snapshot()
            pf = snap["prefill_s"]["count"] if snap["prefill_s"] else 0
            st = (snap["decode_step_s"]["count"]
                  if snap["decode_step_s"] else 0)
            if pf != snap["prefills"] or st != snap["steps"]:
                tears.append((pf, snap["prefills"], st, snap["steps"]))
            if snap["tokens_generated"] != snap["prefills"] + snap["steps"]:
                tears.append(("tokens", snap["tokens_generated"]))

    writers = [threading.Thread(target=prefiller),
               threading.Thread(target=stepper)]
    rd = threading.Thread(target=reader)
    rd.start()
    for w in writers:
        w.start()
    for w in writers:
        w.join()
    stop.set()
    rd.join()
    assert not tears, f"snapshot tore {len(tears)}x, e.g. {tears[:3]}"
    final = m.snapshot()
    assert final["prefills"] == n and final["steps"] == n
    assert final["prefill_s"]["count"] == n
    assert final["decode_step_s"]["count"] == n


# --------------------------------------------------------------------- #
# ClusterView: the merged text against the JAX package's                  #
# --------------------------------------------------------------------- #
class _StubWorker:
    def __init__(self, rank, snap):
        self.rank, self._snap = rank, snap

    def live_snapshot(self):
        return self._snap


def _synthetic_snapshots():
    m = ServeMetrics()
    for _ in range(3):
        m.observe_prefill(0.004)
        m.observe_step(0.002, active=2)
    serve = json.loads(json.dumps(m.snapshot()))
    out = {}
    for rank in (0, 1):
        out[rank] = {
            "rank": str(rank),
            "status": {"rank": str(rank), "pid": 100 + rank,
                       "trace_id": "t-cv", "healthy": 1.0 - rank,
                       "health": {"status": "ok" if rank == 0
                                  else "wedged"},
                       "events_per_second": 2.5 + rank,
                       "global_step": 7 + rank, "epoch": 1},
            "events": [{"ts": 1.0, "rank": rank, "kind": "train_step",
                        "trace": "t-cv", "data": {"step": i}}
                       for i in range(3 + rank)],
            "profiler": {"stats": {"train_step": {
                "count": 3, "total": 0.3 + rank,
                "samples": [0.1, 0.1, 0.1 + rank], "max": 0.1 + rank}},
                "counters": {"prefetch_hits": 4 + rank}, "gauges": {},
                "comms": None},
            "serve": {"engine0": serve},
            "compile": 2 + rank}
    return out


@pytest.mark.parametrize("skip", [(), ("1",)])
def test_cluster_view_merge_text_matches_jax(skip):
    """The same synthetic per-rank snapshots through stub workers: the
    merged registry's Prometheus text equal line for line, with and
    without ranks whose telemetry already shipped home, and the
    last_view equal but for its age."""
    snaps = _synthetic_snapshots()
    texts, views = [], []
    for mod, reg in ((live, MetricsRegistry), (jax_live, JaxRegistry)):
        cv = mod.ClusterView(
            workers=[_StubWorker(r, s) for r, s in snaps.items()],
            refresh_s=10.0)
        assert sorted(cv.refresh()) == ["0", "1"]
        texts.append(cv.merge_into(reg(trace_id="t-cv"),
                                   skip_mergeables=skip)
                     .prometheus_text().splitlines())
        view = cv.last_view()
        view.pop("refreshed_age_s")
        views.append(view)
    assert texts[0] == texts[1]
    assert views[0] == views[1]
    assert 'rla_tpu_rank_healthy{rank="1"} 0' in texts[0]
    assert_prometheus_exposition("\n".join(texts[0]))


def test_cluster_view_keeps_a_dead_ranks_last_snapshot():
    class Flaky(_StubWorker):
        alive = True

        def live_snapshot(self):
            if not self.alive:
                raise ConnectionError("gone")
            return self._snap

    w = Flaky(0, {"rank": "0", "status": {"rank": "0", "healthy": 1.0}})
    cv = live.ClusterView(workers=[w], refresh_s=10.0)
    assert "0" in cv.refresh()
    w.alive = False
    assert cv.refresh() == {}
    assert cv.view()["0"]["status"]["healthy"] == 1.0


# --------------------------------------------------------------------- #
# Worker endpoints: the pool, the portfile scan, the agent's live op      #
# --------------------------------------------------------------------- #
def _plane_env(tmp_path):
    return {"RLA_TPU_TELEMETRY_DIR": str(tmp_path),
            "RLA_TPU_METRICS_PORT": "0",
            "RLA_TPU_WORKER_HEARTBEAT_S": str(HB)}


def test_cluster_view_over_a_pool_and_the_portfile_scan(tmp_path):
    """Two workers serve their own endpoints (portfiles rank0, rank1):
    the ClusterView over the pool and the pool-free portfile scan both
    see them, rank-labeled; a killed rank's last snapshot survives."""
    env = _plane_env(tmp_path)
    pool = ActorPool(2, env_per_worker=[dict(env), dict(env)])
    try:
        for f in pool.execute_all(torch_boring.emit_steps, 5):
            assert f.result(timeout=WAIT) == 5
        assert {"rank0.port.json", "rank1.port.json"} <= set(
            os.listdir(tmp_path))
        cv = live.ClusterView(workers=list(pool.workers), refresh_s=0.2)
        assert _until(lambda: len(cv.refresh()) == 2 or None)
        txt = cv.merged_registry().prometheus_text()
        assert_prometheus_exposition(txt)
        for r in ("0", "1"):
            assert f'rla_tpu_rank_healthy{{rank="{r}"}} 1' in txt
            assert f'rla_tpu_rank_events_per_second{{rank="{r}"}}' in txt
        assert cv.merged_registry().to_json()["events"]["train_step"] >= 10
        view = cv.last_view()
        assert sorted(view["ranks"]) == ["0", "1"]
        assert view["ranks"]["1"]["health"]["status"] == "ok"
        scan = live.ClusterView(env=env)
        assert _until(lambda: sorted(scan.refresh()) == ["0", "1"] or None)
        pool.workers[1].kill()
        cv.refresh()
        assert "1" in cv.view()
    finally:
        pool.shutdown()


def test_live_wire_op_over_a_loopback_agent(tmp_path):
    """``RemoteWorker.live_snapshot`` rides the agent's ``live`` op: the
    scrape happens on the worker's host."""
    host = agent.HostAgent(port=0)
    host.serve_in_background()
    w = None
    try:
        w = agent.RemoteWorker(f"127.0.0.1:{host.port}", 1,
                               _plane_env(tmp_path))
        assert w.execute(torch_boring.emit_steps, 4).result(
            timeout=WAIT) == 4
        snap = _until(w.live_snapshot)
        assert snap is not None and snap["rank"] == "1"
        assert snap["status"]["health"]["status"] == "ok"
        assert [e["kind"] for e in snap["events"]].count("train_step") == 4
        cv = live.ClusterView(workers=[w], refresh_s=0.2)
        assert "1" in cv.refresh()
    finally:
        if w is not None:
            w.kill()
        host.shutdown()


@pytest.mark.chaos
def test_chaos_hang_flips_worker_healthz_before_watchdog_reap(tmp_path):
    """A chaos hang freezes the rank's beat: its own /healthz reads
    wedged (503) with no watchdog running; the watchdog then reaps."""
    env = dict(_plane_env(tmp_path), RLA_TPU_CHAOS="hang@rank0",
               RLA_TPU_WEDGE_TIMEOUT_S="0.6")
    w = Worker(0, env=env)
    wd = None
    try:
        fut = w.execute(torch_boring.ok)

        def wedged():
            rec = live.read_portfile(live.portfile_for(0, env=env))
            if rec is None:
                return None
            code, body = _code_and_body(
                f"http://127.0.0.1:{rec['port']}/healthz")
            return json.loads(body) if code == 503 else None

        status = _until(wedged, every=HB)
        assert status is not None, "healthz never read wedged"
        assert status["status"] == "wedged" and status["beat_age_s"] > 0.6
        assert status["rank"] == "0"
        wd = Watchdog([w], wedge_timeout_s=0.6, poll_s=HB).start()
        with pytest.raises(WorkerWedged):
            fut.result(timeout=WAIT)
    finally:
        if wd is not None:
            wd.stop()
        w.kill()


# --------------------------------------------------------------------- #
# Fits: in process, over gloo ranks, over an agent; the failure report   #
# --------------------------------------------------------------------- #
def test_in_process_fit_serves_its_registry(tmp_path, monkeypatch):
    """An in-process fit binds itself to the process's server: /metrics
    and /statusz show its registry and step after it returned."""
    monkeypatch.setenv("RLA_TPU_METRICS_PORT", "0")
    monkeypatch.setenv("RLA_TPU_TELEMETRY_DIR", str(tmp_path / "t"))
    t = Trainer(device="cpu", max_steps=4, seed=0, guard=None,
                enable_checkpointing=False, profiler=Profiler(),
                perf_observatory=True, log_every_n_steps=10 ** 9,
                default_root_dir=str(tmp_path))
    train, _ = torch_boring.boring_loaders()
    t.fit(BoringModel(), train)
    srv = live.get_server()
    assert srv is not None and t._live_server is srv
    _, body = _get(srv.url + "/metrics")
    assert_prometheus_exposition(body)
    for needle in ('rla_tpu_span_seconds{span="train_step"',
                   "rla_tpu_hbm_total_bytes",
                   "rla_tpu_step_phase_seconds_total",
                   'rla_tpu_rank_global_step{rank="driver"} 4',
                   'rla_tpu_events_total{kind="train_step"}'):
        assert needle in body, needle
    status = json.loads(_get(srv.url + "/statusz")[1])
    assert status["global_step"] == 4 and status["recent_steps"]


def _rank_steps(text):
    out = {}
    for line in text.splitlines():
        if line.startswith("rla_tpu_rank_global_step{"):
            label = line.split('rank="', 1)[1].split('"', 1)[0]
            out[label] = float(line.rsplit(" ", 1)[1])
    return out


def test_midfit_scrape_over_two_gloo_ranks(tmp_path, monkeypatch):
    """While a fit over 2 gloo ranks steps, the driver's /metrics carries
    rank-labeled series for both ranks (the ClusterView over the pool),
    and their global_step advances between scrapes; each rank's portfile
    appears and its /healthz reads ok."""
    tdir = tmp_path / "t"
    monkeypatch.setenv("RLA_TPU_METRICS_PORT", "0")
    monkeypatch.setenv("RLA_TPU_TELEMETRY_DIR", str(tdir))
    monkeypatch.setenv("RLA_TPU_LIVE_REFRESH_S", "0.1")
    x = np.random.default_rng(0).normal(size=(160, 32)).astype(np.float32)
    t = Trainer(device="cpu", max_epochs=1, seed=0, guard=None,
                enable_checkpointing=False, log_every_n_steps=10 ** 9,
                callbacks=[torch_boring.SlowSteps(0.15)],
                default_root_dir=str(tmp_path),
                accelerator=RayTPUAccelerator(2))
    box = {}

    def fit():
        try:
            t.fit(BoringModel(), DataLoader(ArrayDataset(x), batch_size=8))
        except BaseException as e:
            box["error"] = e

    runner = threading.Thread(target=fit)
    runner.start()
    scrapes, health = [], {}
    try:
        srv = _until(live.get_server)
        deadline = time.monotonic() + WAIT
        while runner.is_alive() and time.monotonic() < deadline:
            steps = _rank_steps(_get(srv.url + "/metrics")[1])
            if {"0", "1"} <= set(steps):
                scrapes.append(steps)
                for r in (0, 1):
                    rec = live.read_portfile(str(tdir / f"rank{r}.port.json"))
                    if rec is not None:
                        health[r] = _code_and_body(
                            f"http://127.0.0.1:{rec['port']}/healthz")
            time.sleep(0.3)
    finally:
        runner.join(timeout=WAIT)
        t.shutdown_workers()
    assert "error" not in box, box
    assert t.global_step == 20
    assert len(scrapes) >= 2, scrapes
    assert scrapes[-1]["0"] > scrapes[0]["0"]
    for r in (0, 1):
        code, body = health[r]
        assert code == 200 and json.loads(body)["status"] == "ok"
    assert sorted(t._cluster_view.last_view()["ranks"]) == ["0", "1"]


def test_fanned_out_fit_wires_the_cluster_view(tmp_path, monkeypatch):
    """A fit fanned out over a loopback agent starts the driver's server,
    collects its rank through the agent's live op, shows it rank-labeled
    on the driver's /metrics and keeps the last view."""
    monkeypatch.setenv("RLA_TPU_TELEMETRY_DIR", str(tmp_path / "t"))
    monkeypatch.setenv("RLA_TPU_METRICS_PORT", "0")
    monkeypatch.setenv("RLA_TPU_LIVE_REFRESH_S", "0.2")
    host = agent.HostAgent(port=0)
    host.serve_in_background()
    t = None
    try:
        x = np.random.default_rng(0).normal(size=(32, 32)).astype(
            np.float32)
        t = Trainer(device="cpu", max_epochs=2, seed=0, guard=None,
                    enable_checkpointing=False,
                    default_root_dir=str(tmp_path),
                    accelerator=HorovodRayAccelerator(
                        num_hosts=1, num_slots=1,
                        agents=[f"127.0.0.1:{host.port}"]))
        t.fit(BoringModel(), DataLoader(ArrayDataset(x), batch_size=8))
        srv = live.get_server()
        assert srv is not None and t._cluster_view is not None
        view = t._cluster_view.last_view()
        assert "0" in view["ranks"], view
        assert view["ranks"]["0"]["global_step"] == 8
        _, body = _get(srv.url + "/metrics")
        assert_prometheus_exposition(body)
        assert 'rla_tpu_rank_healthy{rank="driver"}' in body
        assert 'rla_tpu_rank_healthy{rank="0"}' in body
    finally:
        if t is not None:
            t.shutdown_workers()
        host.shutdown()


class _Poison(Exception):
    pass


class _Bomb:
    def __init__(self, inner):
        self.inner = inner

    def __iter__(self):
        yield from list(self.inner)[:2]
        raise _Poison("poisoned batch 3")

    def __len__(self):
        return len(self.inner)


def test_failed_fit_report_carries_the_cluster_view(tmp_path):
    """A failed fit's run_report.json embeds the ClusterView's last view
    under ``extra.cluster_view``, with the JAX ClusterView's keys and
    rows for the same view, and the merged metrics' status row."""
    rows = {"0": {"status": {"rank": "0", "healthy": 1.0,
                             "global_step": 7,
                             "health": {"status": "ok"}}}}
    t = Trainer(device="cpu", max_steps=8, seed=0, guard=None,
                enable_checkpointing=False, prefetch_batches=0,
                log_every_n_steps=10 ** 9, default_root_dir=str(tmp_path))
    cv = live.ClusterView(workers=[], refresh_s=10.0)
    cv._view, cv._refreshed_at = dict(rows), time.monotonic()
    t._cluster_view = cv
    with pytest.raises(_Poison):
        t.fit(BoringModel(), _Bomb(DataLoader(RandomDataset(32, 64),
                                              batch_size=8)))
    with open(tmp_path / "run_report.json") as f:
        rep = json.load(f)
    view = rep["extra"]["cluster_view"]
    ref = jax_live.ClusterView(workers=[], refresh_s=10.0)
    ref._view, ref._refreshed_at = dict(rows), time.monotonic()
    want = ref.last_view()
    assert set(view) == set(want)
    assert view["ranks"] == want["ranks"]
    assert view["ranks"]["0"]["global_step"] == 7
    assert rep["metrics"]["ranks"]["0"]["healthy"] == 1.0


# --------------------------------------------------------------------- #
# The serve engine on the plane                                           #
# --------------------------------------------------------------------- #
def _tiny_gpt():
    from ray_lightning_accelerators_tpu_torch.models.transformer import (
        GPT, TransformerConfig)
    model = GPT(TransformerConfig(vocab_size=61, d_model=128, n_heads=2,
                                  d_ff=256, n_layers=2, max_seq_len=64),
                device="cpu")
    return model, model.init_params(seed=0)


@pytest.mark.serve
def test_engine_burn_rate_overloaded_nonzero_light_zero(monkeypatch):
    """Tight targets give a non-zero burn rate and every TTFT violated;
    loose ones give 0.  While it serves, the engine is on the process's
    /statusz as ``engine<N>`` with the burn rate, and its series on
    /metrics; ``stop()`` takes it off."""
    from ray_lightning_accelerators_tpu_torch.serve import ServeEngine
    monkeypatch.setenv("RLA_TPU_METRICS_PORT", "0")
    model, params = _tiny_gpt()
    rng = np.random.default_rng(0)

    def run(policy):
        with ServeEngine(model, params, max_slots=2, slo=policy) as eng:
            hs = [eng.submit(rng.integers(0, 61, size=(5,))
                             .astype(np.int32), 4) for _ in range(4)]
            for h in hs:
                h.result(timeout=120)
            srv = live.get_server()
            label = eng._live_label
            status = json.loads(_get(srv.url + "/statusz")[1])
            text = _get(srv.url + "/metrics")[1]
            snap = eng.metrics.snapshot()
        assert label not in json.loads(
            _get(srv.url + "/statusz")[1]).get("serve", {})
        return label, status, text, snap

    label, status, text, hot = run(
        SloPolicy(ttft_target_s=1e-6, token_cadence_target_s=1e-6))
    assert label.startswith("engine") and label in status["serve_engines"]
    assert status["slo"][label]["burn_rate"] > 0
    assert status["serve"][label]["completed"] == 4
    assert f'rla_tpu_serve_slo_burn_rate{{rank="{label}"}}' in text
    assert hot["slo_burn_rate"] > 0 and hot["slo_violations"] >= 4
    assert hot["completed"] == 4
    label, status, _, cold = run(
        SloPolicy(ttft_target_s=300.0, token_cadence_target_s=300.0))
    assert status["slo"][label]["burn_rate"] == 0.0
    assert cold["slo_burn_rate"] == 0.0 and cold["slo_violations"] == 0


def test_rla_top_renders_the_ports_statusz(tmp_path, monkeypatch):
    """``scripts/rla_top.py --once --dir`` (stdlib only) finds the
    driver's portfile and renders the port's /statusz: a row for the
    driver and one for each rank of its ClusterView."""
    import subprocess
    import sys
    monkeypatch.setenv("RLA_TPU_METRICS_PORT", "0")
    monkeypatch.setenv("RLA_TPU_TELEMETRY_DIR", str(tmp_path))
    srv = live.maybe_start_from_env()
    cv = live.ClusterView(workers=[_StubWorker(r, s) for r, s in
                                   _synthetic_snapshots().items()],
                          refresh_s=10.0)
    cv.refresh()
    srv.sources.bind_cluster_view(cv)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, os.path.join(repo, "scripts", "rla_top.py"),
         "--once", "--dir", str(tmp_path)], capture_output=True,
        text=True, timeout=WAIT, env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr
    rows = [line.split()[0] for line in out.stdout.splitlines()[1:]
            if line.strip() and not line.startswith("-")]
    assert {"driver", "0", "1"} <= set(rows), out.stdout
