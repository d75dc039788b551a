"""Tune in the PyTorch port, on the CPU: the port of tests/test_tune.py
(the reference's Tune suite: iteration counts and checkpoints through the
report callbacks over DDP and Horovod ranks), tests/test_tpe.py and
tests/test_schedulers.py, with DDP as ``RayTPUAccelerator(2)`` and
Horovod as ``HorovodRayAccelerator(1, 2)`` over spawned gloo ranks, and
the runtime pieces tune stands on (thread-bound sessions, the queue
server's query channel and its token check).

Every fit of the port runs in spawned ranks, so the tune callbacks run
in a rank and reach the trial over the world's query channel.  The
trials that fit over two ranks share one module world (a world formed
outside a trial is not shut at its end); the scheduler's stop through a
rank spawns its own."""

import multiprocessing
import os
import threading

import numpy as np
import pytest

from ray_lightning_accelerators_tpu_torch import (HorovodRayAccelerator,
                                                  RayTPUAccelerator, Trainer,
                                                  TuneReportCallback,
                                                  TuneReportCheckpointCallback,
                                                  tune)
from ray_lightning_accelerators_tpu_torch.runtime import agent, bootstrap
from ray_lightning_accelerators_tpu_torch.runtime import session as session_lib
from ray_lightning_accelerators_tpu_torch.runtime.queue import (
    QueueClient, QueueServer, TrampolineQueue, drain_queue)
from ray_lightning_accelerators_tpu_torch.tune.schedulers import (
    ASHAScheduler, MedianStoppingRule)
from ray_lightning_accelerators_tpu_torch.tune.search import (
    TPESearcher, generate_trial_configs)

from .torch_boring import (BoringModel, boring_loaders, get_trainer,
                           two_threads)


@pytest.fixture(autouse=True)
def bounded_worlds(monkeypatch):
    monkeypatch.setattr(bootstrap, "DEFAULT_TIMEOUT_S", 60.0)


@pytest.fixture(scope="module")
def world():
    """Two gloo ranks on the CPU, shared by the trials that fit over two
    ranks (each trainer takes it as its world)."""
    with bootstrap.DistributedWorld(2, devices=["cpu", "cpu"],
                                    timeout_s=60.0) as w:
        yield w


def train_func(dir, accelerator_factory, callbacks=None, world=None):
    def _inner_train(config):
        trainer = get_trainer(dir, accelerator=accelerator_factory(),
                              callbacks=list(callbacks or []), **config)
        trainer._world = world
        trainer.fit(BoringModel(), *boring_loaders())

    return _inner_train


def tune_test(dir, accelerator_factory, world):
    callbacks = [TuneReportCallback(on="validation_end")]
    analysis = tune.run(
        train_func(dir, accelerator_factory, callbacks=callbacks,
                   world=world),
        config={"max_epochs": tune.choice([1, 2, 3])},
        num_samples=2, local_dir=str(dir), device="cpu")
    df = analysis.results_df
    assert all(df["training_iteration"] == df["config.max_epochs"])
    assert world.alive()  # a world formed outside the trials stays open


def test_tune_iteration_ddp(tmp_path, world):
    tune_test(tmp_path, lambda: RayTPUAccelerator(2, init_hook=two_threads),
              world)


def test_tune_iteration_horovod(tmp_path, world):
    tune_test(tmp_path, lambda: HorovodRayAccelerator(
        num_hosts=1, num_slots=2, init_hook=two_threads), world)


def checkpoint_test(dir, accelerator_factory, world):
    callbacks = [TuneReportCheckpointCallback(on="validation_end")]
    analysis = tune.run(
        train_func(dir, accelerator_factory, callbacks=callbacks,
                   world=world),
        config={"max_epochs": 2},
        num_samples=1, local_dir=str(dir),
        metric="val_loss", mode="min", device="cpu")
    assert analysis.best_checkpoint and os.path.exists(
        analysis.best_checkpoint)
    # the whole state, written driver-side under the trial's directory
    from ray_lightning_accelerators_tpu_torch.utils import checkpoint
    payload = checkpoint.read_checkpoint(analysis.best_checkpoint)
    assert str(dir) in analysis.best_checkpoint
    assert payload["global_step"] == 16 and payload["state"]["params"]


def test_checkpoint_ddp(tmp_path, world):
    checkpoint_test(tmp_path, lambda: RayTPUAccelerator(
        2, init_hook=two_threads), world)


def test_checkpoint_horovod(tmp_path, world):
    checkpoint_test(tmp_path, lambda: HorovodRayAccelerator(
        1, 2, init_hook=two_threads), world)


def test_best_config_metric_selection(tmp_path):
    def trainable(config):
        tune.report(score=config["x"] ** 2)

    analysis = tune.run(trainable, config={"x": tune.grid_search([3, -1, 2])},
                        metric="score", mode="min", local_dir=str(tmp_path),
                        device="cpu")
    assert analysis.best_config["x"] == -1
    assert analysis.best_result["score"] == 1


def test_metric_mapping(tmp_path):
    """dict-form metrics map the tune name to the trainer's; one rank."""
    callbacks = [TuneReportCallback({"loss": "val_loss"},
                                    on="validation_end")]
    analysis = tune.run(
        train_func(tmp_path, lambda: RayTPUAccelerator(
            1, init_hook=two_threads), callbacks=callbacks),
        config={"max_epochs": 1}, local_dir=str(tmp_path),
        metric="loss", mode="min", device="cpu")
    assert analysis.best_result["loss"] == 1.0


def test_grid_and_samples_expansion():
    cfgs = generate_trial_configs(
        {"a": tune.grid_search([1, 2]), "b": tune.choice([7]), "c": 5},
        num_samples=3)
    assert len(cfgs) == 6
    assert all(c["b"] == 7 and c["c"] == 5 for c in cfgs)
    assert sorted(c["a"] for c in cfgs) == [1, 1, 1, 2, 2, 2]


def test_loguniform_bounds():
    cfgs = generate_trial_configs({"lr": tune.loguniform(1e-4, 1e-1)}, 50)
    vals = [c["lr"] for c in cfgs]
    assert all(1e-4 <= v <= 1e-1 for v in vals)
    assert np.std(np.log(vals)) > 0.5  # spread in log space


def test_failed_trial_raises(tmp_path):
    def bad(config):
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        tune.run(bad, config={}, local_dir=str(tmp_path), device="cpu")
    analysis = tune.run(bad, config={}, local_dir=str(tmp_path),
                        raise_on_failed_trial=False, device="cpu")
    assert analysis.trials[0].status == "ERROR"


def test_queue_trampoline_order():
    q = TrampolineQueue()
    out = []
    q.put((0, lambda: out.append(1)))
    q.put((1, lambda: out.append(2)))
    assert drain_queue(q) == 2 and out == [1, 2]


def test_session_lifecycle():
    assert not session_lib.session_exists()
    session_lib.init_session(rank=3)
    assert session_lib.get_actor_rank() == 3
    with pytest.raises(ValueError):
        session_lib.init_session(rank=0)
    with pytest.raises(ValueError):  # no queue attached
        session_lib.put_queue(lambda: None)
    session_lib.shutdown_session()
    assert not session_lib.session_exists()


def test_thread_bound_session_wins_over_the_global():
    """A session bound to a thread shadows the process global there and
    nowhere else (concurrent trials bind one each)."""
    session_lib.install_session(session_lib.Session(1))
    seen = {}

    def other():
        session_lib.bind_session_to_thread(session_lib.Session(7))
        seen["bound"] = session_lib.get_actor_rank()

    try:
        t = threading.Thread(target=other)
        t.start()
        t.join()
        assert seen["bound"] == 7 and session_lib.get_actor_rank() == 1
    finally:
        session_lib.shutdown_session()
    assert not session_lib.session_exists()


@pytest.mark.parametrize("token", [None, "s3cret"])
def test_queue_server_put_flush_query_and_token(token, monkeypatch):
    """A client's puts are enqueued in order before its flush returns, a
    query is answered by the handler; with a token, a client without it
    is dropped before anything it sent is unpickled."""
    if token is not None:
        monkeypatch.setenv(agent.TOKEN_ENV, token)
    q = TrampolineQueue()
    server = QueueServer(q, query_handler=lambda name, payload:
                         (name, payload * 2))
    try:
        assert server.address.startswith("127.0.0.1:")
        client = QueueClient(server.address)
        client.put((0, "a"))
        client.put((1, "b"))
        client.flush()
        assert [q.get_nowait(), q.get_nowait()] == [(0, "a"), (1, "b")]
        assert client.query("double", 21) == ("double", 42)
        client.shutdown()
        if token is not None:
            monkeypatch.delenv(agent.TOKEN_ENV)
            intruder = QueueClient(server.address)
            with pytest.raises((ConnectionError, OSError)):
                intruder.put((0, "x"))
                intruder.flush()
            intruder.shutdown()
            assert q.get_nowait() is None
    finally:
        server.close()


def test_loopback_and_tokenless_wide_bind(monkeypatch):
    """Literal addresses by ``ipaddress``; a hostname by what it resolves
    to (resolution stubbed here: a name that starts with "127." but
    resolves to a public address is not loopback)."""
    assert agent.is_loopback("127.0.0.1") and agent.is_loopback("::1")
    assert agent.is_loopback("localhost") and agent.is_loopback("127.8.9.1")
    assert not agent.is_loopback("0.0.0.0")
    resolved = {"127.evil.example": "203.0.113.7", "db.example": "127.0.0.2"}
    monkeypatch.setattr(agent.socket, "getaddrinfo", lambda host, port: [
        (None, None, None, "", (resolved[host], 0))])
    assert not agent.is_loopback("127.evil.example")
    assert agent.is_loopback("db.example")
    monkeypatch.delenv(agent.TOKEN_ENV, raising=False)
    monkeypatch.delenv("RLA_TPU_ALLOW_TOKENLESS_BIND", raising=False)
    with pytest.raises(RuntimeError, match="refuses to bind"):
        agent.check_tokenless_wide_bind("QueueServer", "0.0.0.0", None)
    agent.check_tokenless_wide_bind("QueueServer", "0.0.0.0", "tok")
    agent.check_tokenless_wide_bind("QueueServer", "127.0.0.1", None)


# --------------------------------------------------------------------- #
# tests/test_tpe.py                                                      #
# --------------------------------------------------------------------- #
def test_tpe_concentrates_on_optimum():
    """Minimize (x-0.3)^2 over uniform(0,1): the suggestions after
    startup concentrate near 0.3 and beat the startup phase."""
    searcher = TPESearcher(n_startup=8, seed=0)
    searcher.set_search_properties("loss", "min")
    spec = {"x": tune.uniform(0.0, 1.0)}
    xs = []
    for _ in range(40):
        cfg = searcher.suggest(spec)
        searcher.record(cfg, (cfg["x"] - 0.3) ** 2)
        xs.append(cfg["x"])
    startup_err = np.mean(np.abs(np.asarray(xs[:8]) - 0.3))
    late_err = np.mean(np.abs(np.asarray(xs[-10:]) - 0.3))
    assert late_err < startup_err
    assert late_err < 0.12
    assert min((x - 0.3) ** 2 for x in xs) < 1e-3


def test_tpe_loguniform_and_randint():
    """Optimum at lr=1e-2, width=7; both dims converge."""
    searcher = TPESearcher(n_startup=8, seed=1)
    searcher.set_search_properties("loss", "min")
    spec = {"lr": tune.loguniform(1e-4, 1.0), "width": tune.randint(1, 16)}
    for _ in range(50):
        cfg = searcher.suggest(spec)
        loss = (np.log10(cfg["lr"]) + 2) ** 2 + 0.1 * (cfg["width"] - 7) ** 2
        searcher.record(cfg, loss)
    best_cfg = min(searcher._history, key=lambda t: t[1])[0]
    assert 1e-3 < best_cfg["lr"] < 1e-1
    assert 4 <= best_cfg["width"] <= 10
    assert isinstance(best_cfg["width"], int)


def test_tpe_categorical_prefers_good_choice():
    searcher = TPESearcher(n_startup=6, seed=2)
    searcher.set_search_properties("score", "max")
    spec = {"opt": tune.choice(["a", "b", "c"])}
    for _ in range(40):
        cfg = searcher.suggest(spec)
        searcher.record(cfg, {"a": 0.1, "b": 1.0, "c": 0.2}[cfg["opt"]])
    late = [searcher.suggest(spec)["opt"] for _ in range(20)]
    assert late.count("b") > 10


def test_tpe_static_values_pass_through():
    searcher = TPESearcher(n_startup=2, seed=0)
    cfg = searcher.suggest({"x": tune.uniform(0, 1), "epochs": 5})
    assert cfg["epochs"] == 5


def test_tune_run_with_search_alg(tmp_path):
    def trainable(config):
        tune.report(loss=(config["x"] - 0.7) ** 2)

    analysis = tune.run(trainable, config={"x": tune.uniform(0.0, 1.0)},
                        num_samples=25, metric="loss", mode="min",
                        search_alg=TPESearcher(n_startup=6, seed=0),
                        local_dir=str(tmp_path), device="cpu")
    assert abs(analysis.best_config["x"] - 0.7) < 0.15
    assert analysis.best_result["loss"] < 0.02


# --------------------------------------------------------------------- #
# tests/test_schedulers.py                                               #
# --------------------------------------------------------------------- #
class _T:
    """A trial stand-in for scheduler calls."""
    trial_id = "t"


def _res(it, loss):
    return {"training_iteration": it, "loss": loss}


def test_asha_rungs_and_cutoffs():
    s = ASHAScheduler(metric="loss", mode="min", max_t=16, grace_period=1,
                      reduction_factor=4)
    assert s.rungs == [1, 4]
    # the first rf-1 results at a rung continue optimistically
    assert s.on_result(_T(), _res(1, 5.0)) == s.CONTINUE
    assert s.on_result(_T(), _res(1, 1.0)) == s.CONTINUE
    assert s.on_result(_T(), _res(1, 4.0)) == s.CONTINUE
    # the 4th: cutoff = best 1/4 of [5, 1, 4, x]
    assert s.on_result(_T(), _res(1, 0.5)) == s.CONTINUE  # a new best
    assert s.on_result(_T(), _res(1, 9.0)) == s.STOP      # the worst
    # iterations off the rungs never stop
    assert s.on_result(_T(), _res(2, 99.0)) == s.CONTINUE
    # max_t always stops
    assert s.on_result(_T(), _res(16, 0.0)) == s.STOP


def test_asha_max_mode():
    s = ASHAScheduler(metric="acc", mode="max", max_t=8, grace_period=1,
                      reduction_factor=2)
    for v in (0.1, 0.9):
        s.on_result(_T(), {"training_iteration": 1, "acc": v})
    assert s.on_result(
        _T(), {"training_iteration": 1, "acc": 0.95}) == s.CONTINUE
    assert s.on_result(
        _T(), {"training_iteration": 1, "acc": 0.05}) == s.STOP


def test_median_stopping_rule():
    s = MedianStoppingRule(metric="loss", mode="min", grace_period=1)
    for v in (1.0, 2.0, 3.0):
        s.on_result(_T(), _res(2, v))
    assert s.on_result(_T(), _res(2, 10.0)) == s.STOP
    assert s.on_result(_T(), _res(2, 0.1)) == s.CONTINUE


def test_tune_run_with_asha_stops_bad_trials(tmp_path):
    """A trainable reporting its config value 6 times; with the grid
    [0.1, 5.0, 6.0, 7.0] and rungs at 1, 2, 4 the bad configs stop early
    and the best runs to the end."""
    def trainable(config):
        for _ in range(6):
            tune.report(loss=config["lr"])
            if tune.trial_should_stop():
                return

    analysis = tune.run(
        trainable,
        config={"lr": tune.grid_search([0.1, 5.0, 6.0, 7.0])},
        metric="loss", mode="min",
        scheduler=ASHAScheduler(max_t=6, grace_period=1,
                                reduction_factor=2),
        local_dir=str(tmp_path), name="asha_unit", device="cpu")
    iters = {t.config["lr"]: t.training_iteration for t in analysis.trials}
    assert analysis.best_config["lr"] == 0.1
    assert iters[0.1] == 6
    assert iters[6.0] < 6 and iters[7.0] < 6
    assert all(t.status in ("STOPPED", "TERMINATED")
               for t in analysis.trials)
    assert analysis.trials[2].status == "STOPPED"


class StopAll(tune.TrialScheduler):
    metric = "val_loss"

    def on_result(self, trial, result):
        return self.STOP


def test_scheduler_stops_trainer_via_callback(tmp_path):
    """The query channel: a Trainer fitting over a spawned rank, whose
    TuneReportCallback reports to the trial and reads the scheduler's
    STOP back; the fit ends at that epoch boundary, long before its 50
    epochs, and the trial's world ends with the trial."""
    before = set(multiprocessing.active_children())

    def trainable(config):
        train, val = boring_loaders()
        trainer = Trainer(max_epochs=50, device="cpu",
                          accelerator=RayTPUAccelerator(
                              init_hook=two_threads),
                          precision="f32", enable_checkpointing=False,
                          callbacks=[TuneReportCallback(["val_loss"])],
                          seed=0, default_root_dir=str(tmp_path))
        trainer.fit(BoringModel(), train, val)
        assert trainer.rank_report["world_size"] == 1
        return trainer.current_epoch

    analysis = tune.run(trainable, config={"x": 1}, metric="val_loss",
                        mode="min", scheduler=StopAll(),
                        local_dir=str(tmp_path), name="stopall",
                        device="cpu")
    t = analysis.trials[0]
    assert t.status == "STOPPED"
    assert t.training_iteration == 1
    assert set(multiprocessing.active_children()) - before == set()
