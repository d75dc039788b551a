"""The port's perf observatory (``telemetry/perf.py``) against the JAX
package's on the same inputs: the step timeline's snapshots under one
scripted clock (phases, the ring, between-step phases, the compile
split, the whole-epoch rows, the wire record, a foreign thread's
observation), the HBM ledger's attribution, throttle and leak alarm
(one ``hbm_leak`` event a growth streak, with the same fields), the
goodput ledger, the exposed-comm crosscheck and the registry's export
of the three; then the trainer integration on the CPU (the timeline's
phases against the step wall, the pools against the state's bytes, no
build after the first step) and the bounded cost of a step bracket.
The benchmark gate's tests (``test_gate_*``) belong to the benchmark
and are not mirrored here."""

import threading
import time

import numpy as np
import pytest
import torch

from ray_lightning_accelerators_tpu.telemetry import perf as jax_perf
from ray_lightning_accelerators_tpu.telemetry import recorder as jax_rec
from ray_lightning_accelerators_tpu.telemetry import (
    registry as jax_registry)
from ray_lightning_accelerators_tpu_torch.telemetry import perf
from ray_lightning_accelerators_tpu_torch.telemetry import recorder
from ray_lightning_accelerators_tpu_torch.telemetry import registry

torch.set_num_threads(2)

WIRE = {"mode": "int8", "exchange_bytes_per_step": 1000,
        "exposed_bytes_per_step": 250, "baseline_fp32_bytes_per_step": 4000}


class _Clock:
    """A scripted clock: each read advances by the next of a seeded
    sequence of increments, so both packages see the same times."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.t = 1000.0

    def __call__(self):
        self.t += float(self.rng.uniform(1e-4, 5e-3))
        return self.t


def _drive_timeline(mod, monkeypatch, seed=0):
    """The same bracket sequence on one package's StepTimeline, under a
    scripted perf_counter: steps with phases, a compile inside a step,
    a between-step checkpoint, a whole-epoch row, a foreign thread's
    observation during an open step, and the wire record."""
    monkeypatch.setattr(time, "perf_counter", _Clock(seed))
    compiles = {"s": 0.0}
    tl = mod.StepTimeline(ring=4, compile_seconds_fn=lambda: compiles["s"])
    for i in range(6):
        tl.step_begin()
        with tl.phase("h2d"):
            pass
        with tl.phase("compute"):
            if i == 0:
                compiles["s"] += 0.002   # a build inside the first step
        tl.observe("validation", 0.001 * i)
        if i == 3:
            th = threading.Thread(target=lambda: tl.observe("decode", 0.5))
            th.start()
            th.join()
        tl.step_end()
    with tl.phase("ckpt"):
        pass
    tl.observe_scan_epoch(0.8, 16)
    tl.attach_comms(WIRE)
    tl.step_end()   # no open bracket: nothing happens
    return tl.snapshot()


def test_timeline_snapshot_matches_jax(monkeypatch):
    ours = _drive_timeline(perf, monkeypatch)
    theirs = _drive_timeline(jax_perf, monkeypatch)
    assert ours == theirs
    assert ours["steps"] == 6 + 16
    assert len(ours["recent_steps"]) == 4
    assert ours["recent_steps"][-1]["scanned_steps"] == 16
    assert "compile" in ours["phases"] and "decode" not in ours["phases"]
    assert ours["between_step_phases"]["decode"]["total_s"] == 0.5
    assert ours["between_step_phases"]["ckpt"]["count"] == 1
    assert ours["analytic_exposed_comm_fraction"] == 0.25
    assert ours["phase_sum_over_wall"] == pytest.approx(1.0, abs=1e-3)


def test_timeline_phases_sum_to_step_wall():
    tl = perf.StepTimeline(ring=8)
    for _ in range(5):
        tl.step_begin()
        with tl.phase("h2d"):
            time.sleep(0.001)
        with tl.phase("compute"):
            time.sleep(0.004)
        tl.step_end()
    snap = tl.snapshot()
    assert snap["steps"] == 5
    assert snap["phase_sum_over_wall"] == pytest.approx(1.0, abs=1e-6)
    assert snap["attributed_fraction"] > 0.9


def test_timeline_overhead_bounded():
    """A step bracket with two phases stays under the recorder's 50 us
    budget.  Under load (a shared host, several test workers) one slow
    block says nothing of the code: the bound holds for the best of
    several blocks of brackets, so the machine's noise does not decide
    it."""
    tl = perf.StepTimeline(ring=64)
    n, best = 500, float("inf")
    for _ in range(8):
        t0 = time.perf_counter()
        for _ in range(n):
            tl.step_begin()
            with tl.phase("h2d"):
                pass
            with tl.phase("compute"):
                pass
            tl.step_end()
        best = min(best, (time.perf_counter() - t0) / n)
    assert best < 50e-6, f"{best * 1e6:.1f}us per step bracket"


def _drive_hbm(mod, rec):
    """Attribution, watermarks, a dead reader, the throttle and two leak
    streaks on one package's HbmLedger; returns its samples, snapshot
    and the hbm_leak events its recorder saw."""
    rec.configure()
    state = {"params": 1000, "opt": 2000, "grow": 0}
    led = mod.HbmLedger(sample_min_s=0.0, leak_samples=3,
                        leak_min_bytes=500,
                        total_bytes_fn=lambda: sum(state.values()) + 300)
    led.register_pool("params", lambda: state["params"])
    led.register_pool("opt", lambda: state["opt"])
    led.register_pool("grow", lambda: state["grow"])
    led.register_pool("dead", lambda: (_ for _ in ()).throw(
        RuntimeError("dead")))
    samples = [led.sample()]
    state["opt"] = 100           # a shrink keeps the watermark
    samples.append(led.sample())
    for _ in range(6):           # a growth streak past both thresholds
        state["grow"] += 300
        samples.append(led.sample())
    state["grow"] -= 500         # growth stops: the alarm re-arms
    samples.append(led.sample())
    for _ in range(5):
        state["grow"] += 400
        samples.append(led.sample())
    led.unregister_pool("dead")
    samples.append(led.sample())
    throttled = mod.HbmLedger(sample_min_s=3600.0, total_bytes_fn=lambda: 9)
    throttled.sample()
    events = [e["data"] for e in rec.get_recorder().events()
              if e["kind"] == "hbm_leak"]
    return (samples, led.snapshot(), events, throttled.maybe_sample(),
            throttled.snapshot())


def test_hbm_ledger_matches_jax_and_alarms_once_per_streak():
    ours = _drive_hbm(perf, recorder)
    theirs = _drive_hbm(jax_perf, jax_rec)
    assert ours == theirs
    samples, snap, events, throttled, tsnap = ours
    assert samples[0]["other"] == 300 and samples[0]["dead"] == 0
    assert snap["pools"]["opt"]["peak_bytes"] == 2000
    assert snap["attributed_bytes"] + snap["pools"]["other"]["bytes"] == \
        snap["total_bytes"]
    assert len(events) == snap["leak_alarms"] == 2
    assert events[0]["suspect_pool"] == "grow"
    assert throttled is None and tsnap["samples"] == 1
    recorder.configure()


def test_hbm_default_total_is_the_pools_on_the_cpu():
    """Without a card the ground truth is the registered pools' sum
    (PyTorch keeps no list of live tensors), so ``other`` reads 0."""
    led = perf.HbmLedger(sample_min_s=0.0)
    led.register_pool("params", lambda: 1234)
    out = led.sample()
    assert out == {"params": 1234, "other": 0, "total": 1234}
    t = torch.zeros(10, 4)
    assert perf.tree_nbytes({"a": [t, (t, None)], "b": np.zeros(3)}) == \
        2 * 160 + 24
    assert perf.placed_bytes_total("cpu") == 0


def _drive_goodput(mod, monkeypatch):
    monkeypatch.setattr(time, "monotonic", _Clock(3))
    gl = mod.GoodputLedger()
    gl.run_begin()
    gl.note_attempt()
    with gl.measure("restart"):
        pass
    gl.account("productive", 0.03)
    gl.absorb_timeline({
        "phases": {"compute": {"total_s": 2.0}, "h2d": {"total_s": 0.5},
                   "compile": {"total_s": 1.0}},
        "between_step_phases": {"ckpt": {"total_s": 0.25}}})
    gl.absorb_events([{"kind": "preempt_drain", "ts": 10.0},
                      {"kind": "emergency_checkpoint", "ts": 10.4}])
    gl.note_preemption()
    gl.run_end()
    first = gl.snapshot()
    gl.run_begin()   # a reused ledger starts a fresh run
    gl.account("productive", 0.01)
    gl.run_end()
    return first, gl.snapshot()


def test_goodput_matches_jax(monkeypatch):
    ours = _drive_goodput(perf, monkeypatch)
    theirs = _drive_goodput(jax_perf, monkeypatch)
    assert ours == theirs
    first, second = ours
    assert first["seconds"]["drain"] == pytest.approx(0.4)
    assert first["attempts"] == 1 and first["preemptions"] == 1
    assert second["attempts"] == 0
    assert second["seconds"] == {"productive": 0.01}


@pytest.mark.parametrize("steps", [{"tree": 0.40, "scan": 0.30},
                                   {"tree": 0.30, "scan": 0.40}])
def test_exposed_comm_crosscheck_matches_jax(steps):
    wires = {"tree": {"exchange_bytes_per_step": 100,
                      "exposed_bytes_per_step": 100},
             "scan": {"exchange_bytes_per_step": 100,
                      "exposed_bytes_per_step": 10}}
    ours = perf.exposed_comm_crosscheck(steps, wires)
    assert ours == jax_perf.exposed_comm_crosscheck(steps, wires)
    assert ours["direction_agrees"] == (steps["scan"] < steps["tree"])
    with pytest.raises(ValueError, match=">= 2 modes"):
        perf.exposed_comm_crosscheck({"tree": 0.1}, {"tree": {}})


def test_registry_exports_the_three_ledgers_as_jax(monkeypatch):
    """The same three snapshots through each package's registry give the
    same JSON and the same Prometheus text (JAX's metric names)."""
    snaps = (_drive_timeline(perf, monkeypatch),
             _drive_hbm(perf, recorder)[1],
             _drive_goodput(perf, monkeypatch)[0])
    regs = []
    for mod in (registry, jax_registry):
        reg = mod.MetricsRegistry(trace_id="t0")
        reg.add_step_timeline(snaps[0])
        reg.add_hbm(snaps[1])
        reg.add_goodput(snaps[2])
        regs.append(reg)
    assert regs[0].to_json() == regs[1].to_json()
    txt = regs[0].prometheus_text()
    assert txt == regs[1].prometheus_text()
    for needle in ("rla_tpu_steps_total",
                   'rla_tpu_step_phase_seconds_total{phase="compute"}',
                   'rla_tpu_hbm_pool_bytes{pool="params"}',
                   'rla_tpu_goodput_seconds_total{category="productive"}',
                   "rla_tpu_step_exposed_comm_fraction_analytic"):
        assert needle in txt, needle
    recorder.configure()


def _mnist_fit(tmp_path, obs, **kw):
    from ray_lightning_accelerators_tpu_torch import DataLoader, Trainer
    from ray_lightning_accelerators_tpu_torch.data.loader import (
        ArrayDataset)
    from ray_lightning_accelerators_tpu_torch.models.mnist import (
        MNISTClassifier, synthetic_mnist)
    x, y = synthetic_mnist(256, seed=0)
    model = MNISTClassifier({"layer_1": 32, "layer_2": 32, "lr": 1e-3,
                             "batch_size": 64}, device="cpu")
    t = Trainer(device="cpu", max_epochs=3, precision="f32", seed=0,
                log_every_n_steps=10 ** 9, perf_observatory=obs,
                default_root_dir=str(tmp_path), **kw)
    t.fit(model, DataLoader(ArrayDataset(x, y), batch_size=64))
    return t, model


def test_trainer_observatory_timeline_pools_and_report(tmp_path):
    """12 steps of the MNIST MLP with the observatory: the in-step
    phases sum to the step wall, named phases cover most of it, the
    checkpoint saves are between-step ``ckpt``; the ``params`` and
    ``opt_state`` pools hold the state's bytes (f32 masters, two Adam
    moments), other pools 0 on the CPU; the registry exports both."""
    obs = perf.PerfObservatory(hbm=perf.HbmLedger(sample_min_s=0.0))
    t, model = _mnist_fit(tmp_path, obs)
    tl = obs.timeline.snapshot()
    assert tl["steps"] == t.global_step == 12
    assert tl["phase_sum_over_wall"] == pytest.approx(1.0, abs=1e-6)
    assert tl["attributed_fraction"] >= 0.9, tl["phases"]
    assert tl["between_step_phases"]["ckpt"]["total_s"] > 0
    n_params = sum(v.numel() for layer in model.params.values()
                   for v in layer.values())
    hbm = obs.hbm.snapshot()
    assert hbm["pools"]["params"]["bytes"] == 4 * n_params
    assert hbm["pools"]["opt_state"]["bytes"] == 2 * 4 * n_params
    assert hbm["pools"]["other"]["bytes"] == 0
    assert hbm["attributed_bytes"] == hbm["total_bytes"]
    j = t.build_metrics_registry().to_json()
    assert {"step_timeline", "hbm"} <= set(j["perf"])


def test_trainer_builds_nothing_after_the_first_step(tmp_path):
    """The observatory on the hot loop costs no build: the compile count
    (the port's nvcc and g++ runs) is the same after every step."""
    from ray_lightning_accelerators_tpu_torch.analysis import compile_guard
    from ray_lightning_accelerators_tpu_torch.core.callbacks import Callback

    counts = []

    class Snap(Callback):
        def on_train_batch_end(self, trainer, module, metrics, idx):
            counts.append(compile_guard.compile_count())

    _mnist_fit(tmp_path, True, callbacks=[Snap()])
    assert len(counts) == 12 and len(set(counts)) == 1
