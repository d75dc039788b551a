"""The port's telemetry (``telemetry/``, ``utils/logging.py``, the
trainer's and the serve engine's emit sites) against the JAX package's:

- the flight recorder's vocabulary (``EVENT_KINDS`` equal) and reads
  (``tail``, ``events_per_second``, ``clear``, ``current_rank``);
- a ``MetricsRegistry`` fed the same exports, events, serve and ledger
  snapshots gives the same ``to_json()`` and ``prometheus_text()``, and
  ``build_run_report(registry=...)`` the same report (timing fields and
  each process's own ring excluded by name);
- one tiny fit (2 epochs, validation on, the prefetch pipeline on) on
  both Trainers gives equal span names with their counts, equal counter
  and gauge names, equal event kinds in order with their step fields,
  and equal ``params`` pool bytes;
- a failed fit writes ``run_report.json`` with the registry embedded,
  a spawned 2-rank fit ships both ranks' exports home under the fit's
  trace, and an evaluation over the ranks does so under its own;
- ``configure_logging``'s JSON lines carry the JAX formatter's fields;
- the serve engine emits JAX's kinds in JAX's order with JAX's fields
  for the same requests, and the SLO tracker its ``slo_violation``;
- ``compile_count()`` reads 0 in a fresh process on the CPU.
"""

import json
import logging
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax

from ray_lightning_accelerators_tpu import Accelerator as JaxAccelerator
from ray_lightning_accelerators_tpu import MeshConfig as JaxMeshConfig
from ray_lightning_accelerators_tpu import Trainer as JaxTrainer
from ray_lightning_accelerators_tpu.data.loader import (
    ArrayDataset as JaxArrayDataset, DataLoader as JaxDataLoader)
from ray_lightning_accelerators_tpu.models.transformer import (
    GPT as JaxGPT, TransformerConfig as JaxConfig)
from ray_lightning_accelerators_tpu.serve import ServeEngine as JaxEngine
from ray_lightning_accelerators_tpu.serve import slo as jax_slo
from ray_lightning_accelerators_tpu.telemetry import recorder as jax_rec
from ray_lightning_accelerators_tpu.telemetry import (
    registry as jax_registry)
from ray_lightning_accelerators_tpu.utils import logging as jax_logging
from ray_lightning_accelerators_tpu.utils import profiler as jax_prof
from ray_lightning_accelerators_tpu_torch import (DataLoader,
                                                  RayTPUAccelerator, Trainer)
from ray_lightning_accelerators_tpu_torch.data.loader import ArrayDataset
from ray_lightning_accelerators_tpu_torch.models.transformer import (
    GPT, TransformerConfig)
from ray_lightning_accelerators_tpu_torch.runtime import bootstrap
from ray_lightning_accelerators_tpu_torch.runtime.bootstrap import (
    DistributedWorld)
from ray_lightning_accelerators_tpu_torch.serve import ServeEngine, slo
from ray_lightning_accelerators_tpu_torch.telemetry import recorder
from ray_lightning_accelerators_tpu_torch.telemetry import registry
from ray_lightning_accelerators_tpu_torch.utils import logging as port_logging
from ray_lightning_accelerators_tpu_torch.utils import profiler as port_prof
from ray_lightning_accelerators_tpu_torch.utils.profiler import Profiler
from ray_lightning_accelerators_tpu_torch.utils.weights import (
    params_from_jax)

from .torch_boring import BoringModel, boring_loaders

pytestmark = pytest.mark.telemetry
torch.set_num_threads(2)

VOCAB, SEQ = 128, 64
# tests/test_torch_training.py's dense GPT: 2 layers, d 128
CFG = dict(vocab_size=VOCAB, d_model=128, n_heads=2, d_ff=256, n_layers=2,
           max_seq_len=SEQ, loss_chunk_rows=100)


@pytest.fixture(autouse=True)
def _fresh_recorders():
    recorder._reset_for_tests()
    jax_rec._reset_for_tests()
    yield
    recorder._reset_for_tests()
    jax_rec._reset_for_tests()


def _tokens(n, seed=0):
    starts = np.random.default_rng(seed).integers(0, VOCAB, n)
    return ((starts[:, None] + np.arange(SEQ)[None]) % VOCAB).astype(np.int32)


# --------------------------------------------------------------------- #
# The recorder                                                           #
# --------------------------------------------------------------------- #
def test_event_vocabulary_and_reads_match_jax():
    assert recorder.EVENT_KINDS == jax_rec.EVENT_KINDS
    assert recorder.EMBED_TAIL_N == jax_rec.EMBED_TAIL_N
    assert recorder.current_rank() is None
    rows = []
    for mod in (recorder, jax_rec):
        rec = mod.configure(rank=2, trace_id="t-1")
        for i in range(5):
            rec.emit("train_step" if i % 2 else "validation", step=i)
        rows.append(([{k: v for k, v in e.items() if k != "ts"}
                      for e in rec.tail(3)],
                     [e["data"] for e in rec.tail(2, kind="validation")],
                     rec.tail(0), mod.current_rank(),
                     rec.events_per_second() > 0))
        rec.clear()
        assert rec.events() == [] and rec.events_per_second() == 0.0
    assert rows[0] == rows[1]
    assert rows[0][1] == [{"step": 2}, {"step": 4}]


# --------------------------------------------------------------------- #
# The registry and the run report                                        #
# --------------------------------------------------------------------- #
def _profiler(mod, seed):
    rng = np.random.default_rng(seed)
    prof = mod.Profiler()
    for dt in rng.exponential(0.01, size=300):
        prof.observe("train_step", float(dt))
    prof.observe("h2d_wait", 0.002)
    prof.incr("prefetch_starved_steps", 2)
    prof.gauge("prefetch_depth", 1)
    prof.record_comms({"mode": "int8", "compression_ratio": 3.9,
                       "exchange_bytes_per_step": 1000,
                       "baseline_fp32_bytes_per_step": 3900})
    return prof


SERVE = {"completed": 4, "failed": 0, "queue_depth": 0,
         "throughput_tok_s": 12.5, "block_pool_used": 3,
         "slo_burn_rate": 0.25, "prefix_hits": 2}
TIMELINE = {"steps": 3, "step_wall_total_s": 0.3, "mean_step_ms": 100.0,
            "phases": {"compute": {"count": 3, "total_s": 0.25},
                       "other": {"count": 3, "total_s": 0.05}},
            "between_step_phases": {"ckpt": {"count": 1, "total_s": 0.1}},
            "phase_sum_over_wall": 1.0, "attributed_fraction": 0.8333,
            "recent_steps": [], "analytic_exposed_comm_fraction": 0.5}
HBM = {"samples": 2, "total_bytes": 100, "peak_total_bytes": 120,
       "pools": {"params": {"bytes": 80, "peak_bytes": 80},
                 "other": {"bytes": 20, "peak_bytes": 40}},
       "attributed_bytes": 80, "leak_alarms": 0, "leak_streak_samples": 0,
       "attributed_fraction": 0.8}
GOODPUT = {"wall_s": 2.0, "seconds": {"productive": 1.5, "restart": 0.2},
           "unattributed_s": 0.3, "goodput_fraction": 0.75,
           "productive_s": 1.5, "attempts": 2, "preemptions": 0}
EVENTS = [{"kind": "train_step", "trace": "abc"},
          {"kind": "train_step", "trace": "abc"},
          {"kind": "serve_admit", "trace": "r1"}]
REPLICAS = {"replicas": {"r0": {"state": "ok", "lane": "decode",
                                "inflight_requests": 2, "retries": 1},
                         "r1": {"state": "slow", "prefix_hit_rate": 0.5}},
            "queue_depth": 3, "max_burn": 1.5}


def _registry(mod, prof_mod):
    reg = mod.MetricsRegistry(trace_id=None)
    reg.add_profiler(_profiler(prof_mod, 0), rank="driver")
    reg.add_profiler(_profiler(prof_mod, 1).export_state(), rank=0)
    reg.add_serve(dict(SERVE), rank=0)
    reg.add_compile_count(7, rank="driver")
    reg.add_compile_count(2, rank=0)
    reg.add_events(EVENTS, rank="driver")
    reg.add_scalar("probe_ratio", 1.25)
    reg.add_rank_status(0, {"healthy": 1, "global_step": 12,
                            "events_per_second": 3.5})
    reg.add_replica_controller(dict(REPLICAS))
    reg.add_step_timeline(dict(TIMELINE))
    reg.add_hbm(dict(HBM))
    reg.add_goodput(dict(GOODPUT))
    return reg


def test_registry_json_and_prometheus_match_jax():
    ours = _registry(registry, port_prof)
    theirs = _registry(jax_registry, jax_prof)
    assert ours.to_json() == theirs.to_json()
    txt = ours.prometheus_text()
    assert txt == theirs.prometheus_text()
    j = ours.to_json()
    assert j["trace_id"] == "abc"      # seeded from the first traced event
    assert j["profiler_ranks"] == ["driver", "0"]
    assert j["spans"]["train_step"]["count"] == 600
    assert j["compile"]["total_backend_compiles"] == 9
    for needle in ('rla_tpu_span_seconds{span="train_step",quantile="0.5"}',
                   "rla_tpu_prefetch_starved_steps_total 4",
                   'rla_tpu_serve_completed_total{rank="0"} 4',
                   'rla_tpu_serve_block_pool_used{rank="0"} 3',
                   "rla_tpu_backend_compiles_total 9",
                   'rla_tpu_events_total{kind="train_step"} 2',
                   'rla_tpu_rank_global_step{rank="0"} 12',
                   'rla_tpu_serve_replica_state{replica="r1",state="slow"}',
                   'rla_tpu_hbm_pool_bytes{pool="params"} 80',
                   "rla_tpu_goodput_fraction 0.75"):
        assert needle in txt, needle
    from tests.utils import assert_prometheus_exposition
    assert_prometheus_exposition(txt)
    assert ours.merged_profiler().counters() == {
        "prefetch_starved_steps": 4}


def _report(mod, reg, tdir):
    err = RuntimeError("boom")
    err.rank = 1
    err.diagnosis = {"detail": "stale"}
    rep = mod.build_run_report(
        error=err, trace_id="tr-9",
        rank_events={"1": [{"kind": "dispatch_begin", "trace": "tr-9"}],
                     **mod.gather_spill_dir(str(tdir))},
        stall_diagnosis={"error": "worker wedged"}, registry=reg,
        include_driver=False, extra={"attempt": 2})
    for key in ("written_unix", "compile"):   # this process's, by name
        rep.pop(key)
    return rep


def test_run_report_with_registry_matches_jax(tmp_path):
    """``build_run_report(registry=...)`` embeds the registry's JSON (the
    port refused it before); the rest of the report, spill gathering
    included, is the JAX package's."""
    snap = {"rank": 0, "pid": 1, "trace_id": "tr-9", "ts": 1.0,
            "events": [{"kind": "train_step", "trace": "tr-9"}]}
    (tmp_path / "rank0.events.json").write_text(json.dumps(snap))
    (tmp_path / "junk.txt").write_text("x")
    ours = _report(registry, _registry(registry, port_prof), tmp_path)
    theirs = _report(jax_registry, _registry(jax_registry, jax_prof),
                     tmp_path)
    assert ours == theirs
    assert ours["metrics"]["spans"]["train_step"]["count"] == 600
    assert ours["ranks"]["0"]["events"][0]["kind"] == "train_step"
    rec = registry.probe_snapshot_record("p", profiler=_profiler(
        port_prof, 0), extra_field=3)
    assert rec["kind"] == "telemetry" and rec["extra_field"] == 3
    assert rec["snapshot"]["spans"]["train_step"]["count"] == 300
    with pytest.raises(ValueError, match="value-less"):
        registry.probe_snapshot_record("p", value=1.0)


# --------------------------------------------------------------------- #
# One fit on both Trainers                                               #
# --------------------------------------------------------------------- #
COMMON = dict(max_epochs=2, precision="f32", log_every_n_steps=1,
              enable_checkpointing=False, seed=0, guard=None,
              prefetch_batches=2, cache_dataset_on_device=False,
              perf_observatory=True)
DATA = _tokens(24, seed=3)


def _fit_record(trainer, prof, rec_mod):
    """What the fit comparison reads: span names with counts, counter
    and gauge names, the event kinds in order with their step fields
    (the pipeline's timing-dependent ``prefetch_starved`` left out) and
    the params pool's bytes."""
    events = [(e["kind"], {k: v for k, v in (e.get("data") or {}).items()
                           if k in ("step", "epoch", "batch", "epochs",
                                    "processes", "stage")})
              for e in rec_mod.get_recorder().events()
              if e["kind"] != "prefetch_starved"]
    counters = set(prof.counters()) - {"prefetch_starved_steps"}
    hbm = trainer.build_metrics_registry().to_json()["perf"]["hbm"]
    return {"spans": {k: v["count"] for k, v in prof.summary().items()},
            "counters": counters, "gauges": set(prof.gauges()),
            "events": events,
            "params_bytes": hbm["pools"]["params"]["bytes"]}


@pytest.fixture(scope="module")
def jax_fit_record(tmp_path_factory):
    jax_rec._reset_for_tests()
    prof = jax_prof.Profiler()
    jm = JaxGPT(JaxConfig(**CFG), lr=3e-3)
    jt = JaxTrainer(accelerator=JaxAccelerator(JaxMeshConfig(data=1)),
                    profiler=prof,
                    default_root_dir=str(tmp_path_factory.mktemp("jax")),
                    **COMMON)
    jt.fit(jm, JaxDataLoader(JaxArrayDataset(DATA[:16]), batch_size=4,
                             use_native=False),
           JaxDataLoader(JaxArrayDataset(DATA[16:]), batch_size=4,
                         use_native=False))
    out = _fit_record(jt, prof, jax_rec)
    jax_rec._reset_for_tests()
    return out


def test_fit_telemetry_matches_jax_trainer(jax_fit_record, tmp_path):
    prof = Profiler()
    tm = GPT(TransformerConfig(**CFG), device="cpu", lr=3e-3)
    tt = Trainer(device="cpu", profiler=prof,
                 default_root_dir=str(tmp_path), **COMMON)
    tt.fit(tm, DataLoader(ArrayDataset(DATA[:16]), batch_size=4),
           DataLoader(ArrayDataset(DATA[16:]), batch_size=4))
    ours = _fit_record(tt, prof, recorder)
    assert ours == jax_fit_record
    assert ours["spans"]["train_step"] == 8
    assert ours["gauges"] == {"prefetch_depth"}
    kinds = [k for k, _ in ours["events"]]
    assert kinds[0] == "fit_start" and kinds[-1] == "fit_end"
    assert kinds.count("validation") == kinds.count("epoch_end") == 2
    assert all(e[1]["processes"] == 1 for e in ours["events"][:1])
    # the trace minted at fit() is ambient: every event carries it
    assert {e["trace"] for e in recorder.get_recorder().events()} == \
        {tt.trace_id}


class _Exploding(BoringModel):
    def training_step(self, params, batch, rng=None):
        if self.trainer.global_step >= 2:
            raise RuntimeError("exploded at step 2")
        return super().training_step(params, batch, rng)


def test_failed_fit_writes_the_report_with_the_registry(tmp_path):
    prof = Profiler()
    train, val = boring_loaders()
    t = Trainer(device="cpu", precision="f32", max_epochs=1, profiler=prof,
                perf_observatory=True, enable_checkpointing=False,
                prefetch_batches=0, default_root_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="exploded"):
        t.fit(_Exploding(), train, val)
    rep = json.loads((tmp_path / "run_report.json").read_text())
    assert rep["error"]["type"] == "RuntimeError"
    assert rep["trace_id"] == t.trace_id
    assert rep["extra"] == {"global_step": 2, "epoch": 0}
    m = rep["metrics"]
    assert m["spans"]["train_step"]["count"] == 3
    assert m["events"]["train_step"] == 2 and m["events"]["fit_start"] == 1
    assert m["perf"]["step_timeline"]["steps"] == 3
    assert [e["kind"] for e in rep["ranks"]["driver"]["events"]][:1] == \
        ["fit_start"]
    # a clean fit writes none
    ok = tmp_path / "ok"
    Trainer(device="cpu", precision="f32", max_epochs=1,
            enable_checkpointing=False,
            default_root_dir=str(ok)).fit(BoringModel(), *boring_loaders())
    assert not (ok / "run_report.json").exists()


@pytest.fixture(scope="module")
def world():
    saved = bootstrap.DEFAULT_TIMEOUT_S
    bootstrap.DEFAULT_TIMEOUT_S = 60.0
    w = DistributedWorld(2, devices=["cpu", "cpu"], timeout_s=60.0)
    try:
        yield w
    finally:
        w.shutdown()
        bootstrap.DEFAULT_TIMEOUT_S = saved


def test_spawned_ranks_ship_their_telemetry_home(world, tmp_path):
    """Each rank of a 2-rank fit builds its own profiler (only ``sync``
    crosses) and ships its export and events home under the fit's
    trace; the driver's registry merges the driver and both ranks.  A
    validation over the ranks is a run of its own: a fresh trace."""
    train, val = boring_loaders()
    t = Trainer(device="cpu", precision="f32", max_epochs=1,
                profiler=Profiler(), enable_checkpointing=False,
                accelerator=RayTPUAccelerator(2),
                default_root_dir=str(tmp_path))
    t._world = world
    try:
        t.fit(BoringModel(), train, val)
        fit_trace = t.trace_id
        assert sorted(t._rank_telemetry) == [0, 1]
        for rank, snap in t._rank_telemetry.items():
            assert snap["rank"] == rank
            assert snap["profiler"]["stats"]["train_step"]["count"] == 8
            kinds = [e["kind"] for e in snap["events"]
                     if e["trace"] == fit_trace]
            assert kinds.count("train_step") == 8 and "fit_end" in kinds
        j = t.build_metrics_registry().to_json()
        assert j["profiler_ranks"] == ["driver", "0", "1"]
        assert j["spans"]["train_step"]["count"] == 16
        assert j["events"]["fit_start"] >= 3   # the driver's and each rank's
        t.validate(t.module, val)
        assert t.trace_id != fit_trace
        for snap in t._rank_telemetry.values():
            assert [e["kind"] for e in snap["events"]
                    if e["trace"] == t.trace_id] == ["validation"]
    finally:
        t._world = None


# --------------------------------------------------------------------- #
# Logging                                                                #
# --------------------------------------------------------------------- #
def test_json_log_lines_carry_the_jax_fields(monkeypatch):
    rows = []
    created = time.time()
    for mod, rec in ((port_logging, recorder), (jax_logging, jax_rec)):
        record = mod.log.makeRecord(mod.log.name, logging.WARNING, "f.py",
                                    1, "hello %s", ("world",), None)
        # one creation time for both records: two clock reads can straddle
        # the millisecond the "ts" field rounds to
        record.created = created
        plain = mod._RankFormatter(json_mode=False).format(record)
        assert plain == f"[WARNING rla-tpu driver:{os.getpid()}] " \
                        "hello world"
        rec.configure(rank=3)
        row = json.loads(mod._RankFormatter(json_mode=True).format(record))
        row.pop("logger")
        rows.append(row)
    assert rows[0] == rows[1]
    assert rows[0]["rank"] == "3" and rows[0]["pid"] == os.getpid()
    try:
        monkeypatch.setenv("RLA_TPU_LOG_JSON", "1")
        port_logging.configure_logging()
        h = next(h for h in port_logging.log.handlers
                 if isinstance(h, logging.StreamHandler))
        assert h.formatter.json_mode is True
    finally:
        port_logging.configure_logging(json_mode=False)


# --------------------------------------------------------------------- #
# Serving                                                                #
# --------------------------------------------------------------------- #
SERVE_CFG = dict(vocab_size=256, d_model=128, n_heads=2, d_ff=256,
                 n_layers=2, max_seq_len=64)
# the fields of each serve event that do not depend on the clock, the
# process or the payload's layout
_TIMING = {"ttft_ms", "step_ms", "request_id", "bytes"}


def _serve_events(engine_cls, model, params, rec_mod):
    """The same requests, one at a time (so the order is the requests'):
    a seeding request, a prefix hit, a prompt streamed in chunks, one
    finished at prefill, and a KV handoff exported, imported and
    released on the same engine."""
    rng = np.random.default_rng(11)
    sysp = rng.integers(0, 256, 12).astype(np.int32)
    reqs = [(np.concatenate([sysp, rng.integers(0, 256, 3)]).astype(
                np.int32), 4),
            (np.concatenate([sysp, rng.integers(0, 256, 2)]).astype(
                np.int32), 3),
            (rng.integers(0, 256, 21).astype(np.int32), 3),
            (rng.integers(0, 256, 3).astype(np.int32), 1)]
    rec_mod._reset_for_tests()
    with engine_cls(model, params, max_slots=2, queue_depth=8,
                    block_len=4) as eng:
        for p, n in reqs:
            eng.submit(p, n).result(timeout=300)
        desc = eng.submit_handoff(rng.integers(0, 256, 9).astype(np.int32),
                                  3).result(timeout=300)
        eng.submit_import(desc).result(timeout=300)
        assert eng.release_handoff(desc["handoff_id"])
    return [(e["kind"], {k: v for k, v in (e.get("data") or {}).items()
                         if k not in _TIMING})
            for e in rec_mod.get_recorder().events()]


def test_serve_engine_emits_the_jax_kinds_in_order(monkeypatch):
    monkeypatch.setenv("RLA_TPU_SERVE_CHUNK_BLOCKS", "2")
    jm = JaxGPT(JaxConfig(**SERVE_CFG))
    jp = jax.device_get(jm.init_params(jax.random.PRNGKey(1)))
    model = GPT(TransformerConfig(**SERVE_CFG), device="cpu")
    ours = _serve_events(ServeEngine, model,
                         params_from_jax(jp, device="cpu"), recorder)
    theirs = _serve_events(JaxEngine, jm, jp, jax_rec)
    assert ours == theirs
    kinds = [k for k, _ in ours]
    for kind in ("serve_admit", "serve_prefill", "serve_prefill_start",
                 "serve_decode_step", "serve_respond", "serve_kv_export",
                 "serve_kv_import", "serve_kv_release"):
        assert kind in kinds, kind


def test_slo_violation_event_matches_jax():
    class Req:
        trace_id, request_id = "t-7", 7

    rows = []
    for mod, rec in ((slo, recorder), (jax_slo, jax_rec)):
        tracker = mod.SloTracker(mod.SloPolicy(ttft_target_s=0.1,
                                               token_cadence_target_s=0.01,
                                               deadline_s=1.0))
        assert tracker.observe_ttft(0.25, Req()) is True
        assert tracker.observe_ttft(0.05, Req()) is False
        tracker.observe_token(0.02, Req())
        tracker.shed(Req(), 1.5)
        rows.append([(e["kind"], e["trace"], e["data"])
                     for e in rec.get_recorder().events()])
    assert rows[0] == rows[1]
    assert [r[2]["family"] for r in rows[0]] == ["ttft", "token_cadence",
                                                 "deadline"]


# --------------------------------------------------------------------- #
# Compile count                                                          #
# --------------------------------------------------------------------- #
def test_compile_count_reads_zero_in_a_fresh_cpu_process():
    """The port's compiles are its own builds: nvcc (never here: no card)
    and g++ (only once the shm store or the batch engine is first used),
    counted per process.  A fresh process that built nothing reads 0."""
    code = ("from ray_lightning_accelerators_tpu_torch.analysis import "
            "compile_guard as g\n"
            "import ray_lightning_accelerators_tpu_torch\n"
            "print(g.compile_count(), g.compile_seconds())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["0", "0.0"]


def test_fsdp_fallback_event_matches_jax():
    """A leaf ``use_fsdp`` has to keep replicated (no dim divisible by
    the fsdp axis) emits the JAX package's ``fsdp_fallback`` event with
    the same fields."""
    from ray_lightning_accelerators_tpu import RayTPUAccelerator as JaxAcc
    from ray_lightning_accelerators_tpu.parallel import mesh as jax_mesh
    from ray_lightning_accelerators_tpu_torch.parallel import mesh as mesh_lib

    params = {"odd": np.zeros((4097, 3), np.float32),
              "even": np.zeros((64, 64), np.float32)}
    RayTPUAccelerator(2, use_fsdp=True).param_shardings(
        mesh_lib.build_mesh(mesh_lib.MeshConfig(data=1, fsdp=2), 2),
        {k: torch.from_numpy(v) for k, v in params.items()})
    JaxAcc(2, use_fsdp=True).param_shardings(
        jax_mesh.build_mesh(jax_mesh.MeshConfig(data=1, fsdp=2),
                            devices=jax.devices()[:2]), params)
    ours, theirs = ([(e["kind"], e["data"]) for e in rec.get_recorder()
                     .events()] for rec in (recorder, jax_rec))
    assert ours == theirs == [("fsdp_fallback",
                               {"param": "['odd']", "shape": [4097, 3]})]
