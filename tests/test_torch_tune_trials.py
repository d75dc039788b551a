"""Concurrent and process tune trials in the PyTorch port, on the CPU:
the port of tests/test_parallel_trials.py (trials over disjoint leases
of the device pool, here 2-slot leases of the CPU's 8 indexed entries,
so two trials make 4 ranks) and tests/test_process_trials.py (a fresh
subprocess a trial; a crash is ERROR and the experiment completes), with
a scheduler's STOP reaching a fit nested in a process trial through two
query hops, and no child process left after ``tune.run``.

The trainables of process trials are module-level functions in
tests/torch_boring.py: the trial subprocess imports them by name."""

import importlib
import multiprocessing
import os
import threading
import time

import numpy as np
import pytest

from ray_lightning_accelerators_tpu_torch import (DataLoader,
                                                  RayTPUAccelerator, Trainer,
                                                  TuneReportCallback, tune)
from ray_lightning_accelerators_tpu_torch.data.loader import ArrayDataset
from ray_lightning_accelerators_tpu_torch.runtime import bootstrap

from . import torch_boring
from .torch_boring import BoringModel, ScoredModel, two_threads

# the module (the package re-exports its function ``run`` under its name)
tune_run_mod = importlib.import_module(
    "ray_lightning_accelerators_tpu_torch.tune.run")


@pytest.fixture(autouse=True)
def bounded_worlds(monkeypatch):
    monkeypatch.setattr(bootstrap, "DEFAULT_TIMEOUT_S", 60.0)


# --------------------------------------------------------------------- #
# tests/test_parallel_trials.py                                          #
# --------------------------------------------------------------------- #
def test_parallel_trials_partition_devices(tmp_path):
    seen = {}
    lock = threading.Lock()
    active = {"now": 0, "peak": 0}

    def trainable(config):
        devices = tune.trial_devices()
        with lock:
            active["now"] += 1
            active["peak"] = max(active["peak"], active["now"])
        try:
            assert devices is not None and len(devices) == 2
            x = np.random.default_rng(0).normal(
                size=(32, 32)).astype(np.float32)
            trainer = Trainer(
                max_epochs=1, device="cpu", precision="f32", seed=0,
                accelerator=RayTPUAccelerator(devices=devices,
                                              init_hook=two_threads),
                enable_checkpointing=False,
                default_root_dir=str(tmp_path / f"t{config['i']}"))
            trainer.fit(BoringModel(), DataLoader(ArrayDataset(x),
                                                  batch_size=8))
            # the lease placed the ranks: one on each of its entries
            assert trainer.rank_report["world_size"] == 2
            assert trainer.rank_report["device"] == str(devices[0])
            with lock:
                seen[config["i"]] = tuple(d.index for d in devices)
            tune.report(loss=float(config["i"]))
        finally:
            with lock:
                active["now"] -= 1

    analysis = tune.run(trainable,
                        config={"i": tune.grid_search([0, 1, 2, 3])},
                        num_samples=1, metric="loss", mode="min",
                        max_concurrent_trials=2, devices_per_trial=2,
                        local_dir=str(tmp_path), device="cpu")
    assert len(analysis.trials) == 4
    assert all(t.status == "TERMINATED" for t in analysis.trials)
    assert analysis.best_result["loss"] == 0.0
    # two distinct 2-entry leases were used, never overlapping
    partitions = set(seen.values())
    assert len(partitions) == 2
    a, b = partitions
    assert set(a) & set(b) == set()
    assert active["peak"] == 2  # the trials overlapped


def test_sequential_mode_has_no_partition(tmp_path):
    def trainable(config):
        assert tune.trial_devices() is None
        tune.report(x=1.0)

    analysis = tune.run(trainable, config={}, num_samples=2,
                        metric="x", mode="max", local_dir=str(tmp_path),
                        device="cpu")
    assert all(t.status == "TERMINATED" for t in analysis.trials)


def test_search_alg_rejects_concurrency(tmp_path):
    with pytest.raises(ValueError, match="sequential"):
        tune.run(lambda c: None, config={"x": tune.uniform(0, 1)},
                 num_samples=2, metric="m", mode="min",
                 search_alg=tune.TPESearcher(), max_concurrent_trials=2,
                 local_dir=str(tmp_path), device="cpu")


def test_oversized_partition_rejected(tmp_path):
    with pytest.raises(ValueError, match="exceeds"):
        tune.run(lambda c: None, config={}, num_samples=1,
                 max_concurrent_trials=2, devices_per_trial=64,
                 local_dir=str(tmp_path), device="cpu")


def test_scheduler_with_concurrent_trials(tmp_path):
    """ASHA decisions across overlapping trials keep their state."""
    def trainable(config):
        for step in range(6):
            tune.report(score=config["v"] + step * 0.01)
            if tune.trial_should_stop():
                return

    analysis = tune.run(
        trainable, config={"v": tune.grid_search([0.1, 0.2, 0.9, 1.0])},
        num_samples=1, metric="score", mode="max",
        scheduler=tune.ASHAScheduler(max_t=6, grace_period=2,
                                     reduction_factor=2),
        max_concurrent_trials=2, devices_per_trial=2,
        local_dir=str(tmp_path), device="cpu")
    assert analysis.best_result["score"] >= 1.0
    assert all(t.status in ("TERMINATED", "STOPPED")
               for t in analysis.trials)


def test_concurrent_fail_fast_cancels_pending(tmp_path):
    def trainable(config):
        if config["i"] == 0:
            raise RuntimeError("boom")
        time.sleep(0.4)
        tune.report(x=1.0)

    with pytest.raises(RuntimeError, match="boom"):
        tune.run(trainable,
                 config={"i": tune.grid_search(list(range(8)))},
                 num_samples=1, metric="x", mode="max",
                 max_concurrent_trials=2, devices_per_trial=2,
                 local_dir=str(tmp_path), device="cpu")


def test_concurrent_trials_over_ranks_report_to_their_own_trial(tmp_path):
    """Two concurrent thread trials, each fitting over its own ranks: the
    ranks' reports and the STOP come back through each world's query
    handler, which answers from the trial of the thread that ran the fit,
    so neither trial sees the other's rows.  No rank outlives the run."""
    before = set(multiprocessing.active_children())

    class StopSecond(tune.TrialScheduler):
        def on_result(self, trial, result):
            return (self.STOP if result["training_iteration"] == 2
                    and trial.config["score"] > 0.5 else self.CONTINUE)

    def trainable(config):
        x = np.random.default_rng(0).normal(size=(16, 32)).astype("float32")
        trainer = Trainer(
            max_epochs=4, device="cpu", precision="f32", seed=0,
            enable_checkpointing=False,
            accelerator=RayTPUAccelerator(devices=tune.trial_devices(),
                                          init_hook=two_threads),
            callbacks=[TuneReportCallback({"score": "score"},
                                          on="train_epoch_end")],
            default_root_dir=str(tmp_path / str(config["score"])))
        trainer.fit(ScoredModel(config["score"]),
                    DataLoader(ArrayDataset(x), batch_size=8))
        return trainer.epochs_completed

    analysis = tune.run(
        trainable, config={"score": tune.grid_search([0.25, 0.75])},
        metric="score", mode="min", scheduler=StopSecond(),
        max_concurrent_trials=2, devices_per_trial=2,
        local_dir=str(tmp_path), device="cpu")
    by = {t.config["score"]: t for t in analysis.trials}
    assert by[0.25].status == "TERMINATED"
    assert by[0.75].status == "STOPPED"
    assert [r["score"] for r in by[0.25].results] == [0.25] * 4
    assert [r["score"] for r in by[0.75].results] == [0.75] * 2
    assert set(multiprocessing.active_children()) - before == set()


# --------------------------------------------------------------------- #
# tests/test_process_trials.py                                           #
# --------------------------------------------------------------------- #
def test_process_trials_isolated(tmp_path):
    analysis = tune.run(torch_boring.report_pid,
                        config={"x": tune.grid_search([1.0, 2.0, 3.0])},
                        num_samples=1, metric="loss", mode="min",
                        local_dir=str(tmp_path), trial_executor="process",
                        device="cpu")
    assert len(analysis.trials) == 3
    pids = {t.last_result["pid"] for t in analysis.trials}
    assert len(pids) == 3  # one fresh process per trial
    assert os.getpid() not in {int(p) for p in pids}
    assert analysis.best_config["x"] == 1.0
    assert all(t.status == "TERMINATED" for t in analysis.trials)


def test_crashed_trial_is_error_and_experiment_completes(tmp_path):
    analysis = tune.run(torch_boring.crash_or_report,
                        config={"x": tune.grid_search([1.0, 2.0, 0.5])},
                        num_samples=1, metric="loss", mode="min",
                        local_dir=str(tmp_path),
                        raise_on_failed_trial=False,
                        trial_executor="process", device="cpu")
    by_x = {t.config["x"]: t for t in analysis.trials}
    assert by_x[2.0].status == "ERROR"
    assert by_x[2.0].error is not None
    assert by_x[1.0].status == "TERMINATED"
    assert by_x[0.5].status == "TERMINATED"
    assert analysis.best_config["x"] == 0.5  # the survivors are ranked


def test_crashed_trial_raises_when_requested(tmp_path):
    with pytest.raises(Exception, match="died|exit"):
        tune.run(torch_boring.crash_or_report,
                 config={"x": tune.grid_search([2.0])}, num_samples=1,
                 metric="loss", mode="min", local_dir=str(tmp_path),
                 raise_on_failed_trial=True, trial_executor="process",
                 device="cpu")


@pytest.mark.slow
def test_trainer_with_checkpoint_callback_in_process_trial(tmp_path):
    """Report and checkpoint cross the process boundary: the metrics land
    in trial.results and the checkpoint is written under the driver's
    trial directory."""
    analysis = tune.run(torch_boring.trainer_trial,
                        config={"lr": tune.grid_search([0.05, 0.1]),
                                "root": str(tmp_path / "fit")},
                        num_samples=1, metric="loss", mode="min",
                        local_dir=str(tmp_path), trial_executor="process",
                        device="cpu")
    assert len(analysis.trials) == 2
    for t in analysis.trials:
        assert t.status == "TERMINATED"
        assert t.training_iteration == 2  # one report an epoch
        assert np.isfinite(t.last_result["loss"])
    best = analysis.best_checkpoint
    assert best is not None and os.path.exists(best)
    assert str(tmp_path) in best


def test_scheduler_stop_ends_process_trial_early(tmp_path):
    """An ASHA STOP ends a process trial at the report it decides on: the
    bad trial reaches the rung-2 cutoff (the good trial's 0.1 recorded
    there) and sees the decision at its very next poll."""
    sched = tune.ASHAScheduler(metric="loss", mode="min",
                               grace_period=2, reduction_factor=2)
    analysis = tune.run(torch_boring.loopy_trial,
                        config={"loss": tune.grid_search([0.1, 1.0])},
                        num_samples=1, metric="loss", mode="min",
                        local_dir=str(tmp_path), scheduler=sched,
                        trial_executor="process", device="cpu")
    by_loss = {t.config["loss"]: t for t in analysis.trials}
    good, bad = by_loss[0.1], by_loss[1.0]
    assert good.status == "TERMINATED"
    assert good.training_iteration == 12
    assert bad.status == "STOPPED"
    assert bad.training_iteration == 2


@pytest.mark.parametrize("how", ["argument", "env"])
def test_process_trials_over_agents_are_refused(tmp_path, how,
                                                monkeypatch):
    """Trial subprocesses on host agents (``agents=`` or RLA_TPU_AGENTS),
    refused before the host agents were ported, now reach the process
    executor with their agents (tests/test_torch_agent_fit.py runs a trial
    on a loopback agent)."""
    kw = {}
    if how == "argument":
        kw["agents"] = ["127.0.0.1:7777"]
    else:
        monkeypatch.setenv("RLA_TPU_AGENTS", "127.0.0.1:7777")
    seen = []
    monkeypatch.setattr(
        tune_run_mod, "_run_trials_in_processes",
        lambda *a, agents=None, **k: seen.append(agents))
    tune.run(torch_boring.crash_or_report,
             config={"x": tune.grid_search([1.0])}, num_samples=1,
             local_dir=str(tmp_path), trial_executor="process",
             device="cpu", **kw)
    assert seen == [["127.0.0.1:7777"]]


def test_resources_per_trial_caps_concurrency(tmp_path):
    # a cpu request beyond the host caps concurrency at 1; still completes
    analysis = tune.run(torch_boring.report_pid,
                        config={"x": tune.grid_search([1.0, 2.0])},
                        num_samples=1, metric="loss", mode="min",
                        local_dir=str(tmp_path),
                        max_concurrent_trials=8,
                        resources_per_trial={"cpu": 10 ** 6},
                        trial_executor="process", device="cpu")
    assert all(t.status == "TERMINATED" for t in analysis.trials)


def test_process_trainable_must_be_importable(tmp_path):
    def closure(config):
        pass

    with pytest.raises(TypeError, match="module-level function"):
        tune.run(closure, config={}, local_dir=str(tmp_path),
                 trial_executor="process", device="cpu")


def _nested(tmp_path, accelerator):
    before = set(multiprocessing.active_children())
    sched = tune.ASHAScheduler(metric="score", mode="min",
                               grace_period=2, reduction_factor=2)
    analysis = tune.run(
        torch_boring.nested_fit_trial,
        config={"score": tune.grid_search([0.1, 1.0]),
                "accelerator": accelerator, "root": str(tmp_path / "fit")},
        num_samples=1, metric="score", mode="min",
        local_dir=str(tmp_path), scheduler=sched,
        trial_executor="process", device="cpu")
    by = {t.config["score"]: t for t in analysis.trials}
    good, bad = by[0.1], by[1.0]
    assert good.status == "TERMINATED"
    assert good.training_iteration == 6   # one report an epoch
    assert bad.status == "STOPPED"
    # stopped at the rung-2 decision: two reports, the fit ended at that
    # epoch boundary
    assert bad.training_iteration == 2
    assert set(multiprocessing.active_children()) - before == set()


def test_scheduler_stop_reaches_a_rank_of_a_process_trial(tmp_path):
    """A process trial whose fit runs over a spawned rank
    (``RayAccelerator(1)``): the rank's reports reach the tune driver
    through two query hops (rank -> the trial's world -> the driver), and
    the STOP comes back the same way to end the fit."""
    _nested(tmp_path, "ray")


@pytest.mark.slow
def test_scheduler_stop_reaches_fit_nested_in_process_trial(tmp_path):
    """The same over two ranks (``HorovodRayAccelerator(2, 1)``, on this
    host without agents): reports arrive once an epoch (rank 0 reports)
    and the STOP ends every rank at the same boundary."""
    _nested(tmp_path, "horovod")


def test_no_child_outlives_thread_trials_over_ranks(tmp_path):
    """Each thread trial's fit spawns its own ranks; the trial ends its
    worlds, so tune.run leaves no child process behind."""
    before = set(multiprocessing.active_children())
    pids = []

    def trainable(config):
        x = np.random.default_rng(0).normal(size=(16, 32)).astype("float32")
        trainer = Trainer(
            max_epochs=1, device="cpu", precision="f32", seed=0,
            enable_checkpointing=False,
            accelerator=RayTPUAccelerator(1, init_hook=two_threads),
            default_root_dir=str(tmp_path))
        trainer.fit(BoringModel(), DataLoader(ArrayDataset(x), batch_size=8))
        pids.extend(w.pid for w in trainer._world.pool.workers)
        tune.report(loss=float(trainer.callback_metrics["train_loss"]))

    analysis = tune.run(trainable, config={"i": tune.grid_search([0, 1])},
                        metric="loss", mode="min", local_dir=str(tmp_path),
                        device="cpu")
    assert all(t.status == "TERMINATED" for t in analysis.trials)
    assert len(set(pids)) == 2  # a world per trial
    assert set(multiprocessing.active_children()) - before == set()
