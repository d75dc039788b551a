"""Fits placed through host agents in the PyTorch port, on two loopback
``HostAgent``s in this process (port of tests/test_agent.py's launch
tests and tests/test_fault_tolerance.py's agents test):

- ``HorovodRayAccelerator(num_hosts=2, num_slots=1, agents=...)`` fits,
  validates, tests and predicts over one rank on each agent, against the
  JAX ``Trainer`` on a 2-device mesh from the same numpy weights (params
  within 1e-5); the world persists across the entry points, so each
  agent spawned one worker; the ship-once store goes through one worker
  per host;
- the ``num_hosts`` contract: an agent count other than ``num_hosts``
  raises before any rank starts;
- ``tune.run(agents=)`` runs a process trial on an agent;
- the CLI: ``launch`` exports ``RLA_TPU_AGENTS`` for its script, ``agent
  --port 0`` prints its port, ``trace`` names its slice;
- (slow, as JAX's) an elastic fit recovers over the agents."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_lightning_accelerators_tpu import RayTPUAccelerator as JaxRayTPU
from ray_lightning_accelerators_tpu import Trainer as JaxTrainer
from ray_lightning_accelerators_tpu.data.loader import (
    ArrayDataset as JaxArrayDataset, DataLoader as JaxDataLoader)
from ray_lightning_accelerators_tpu_torch import (DataLoader,
                                                  HorovodRayAccelerator,
                                                  RayTPUAccelerator, Trainer,
                                                  tune)
from ray_lightning_accelerators_tpu_torch.data.loader import ArrayDataset
from ray_lightning_accelerators_tpu_torch import cli
from ray_lightning_accelerators_tpu_torch.runtime import agent, bootstrap
from ray_lightning_accelerators_tpu_torch.runtime.actors import ActorPool
from ray_lightning_accelerators_tpu_torch.runtime.elastic import (
    ElasticRunner)

from . import torch_boring
from .torch_boring import BoringModel
from .utils import BoringModel as JaxBoring

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def bounded_worlds(monkeypatch):
    monkeypatch.setattr(bootstrap, "DEFAULT_TIMEOUT_S", 60.0)


@pytest.fixture(scope="module")
def agents():
    hosts = [agent.HostAgent(port=0) for _ in range(2)]
    for h in hosts:
        h.serve_in_background()
    try:
        yield hosts, [f"127.0.0.1:{h.port}" for h in hosts]
    finally:
        for h in hosts:
            h.shutdown()


def test_fit_over_two_agents_matches_jax(agents, tmp_path):
    """Two epochs of 8 shuffled global batches of 8 rows (4 a rank), SGD
    0.1, f32, from the JAX BoringModel's weights; then validate, test and
    predict in the same world."""
    hosts, addrs = agents
    init = jax.tree.map(np.asarray, jax.device_get(
        JaxBoring().init_params(jax.random.PRNGKey(0))))
    data = np.random.default_rng(0).normal(size=(64, 32)).astype(np.float32)
    common = dict(max_epochs=2, precision="f32", seed=0, guard=None,
                  prefetch_batches=0, cache_dataset_on_device=False,
                  enable_checkpointing=False, log_every_n_steps=1)
    jm = JaxBoring()
    jm.params = jax.tree.map(jnp.asarray, init)
    jt = JaxTrainer(accelerator=JaxRayTPU(2),
                    default_root_dir=str(tmp_path / "jax"), **common)
    jt.fit(jm, JaxDataLoader(JaxArrayDataset(data), batch_size=8,
                             shuffle=True, use_native=False))
    jax_eval = JaxDataLoader(JaxArrayDataset(data[:24]), batch_size=8,
                             use_native=False)
    want_test = jt.test(jm, jax_eval)
    want_pred = jt.predict(jm, jax_eval)

    before = [h.spawn_count for h in hosts]
    tm = BoringModel()
    tm.params = {"layer": {k: torch.from_numpy(np.array(v))
                           for k, v in init["layer"].items()}}
    tt = Trainer(device="cpu", default_root_dir=str(tmp_path / "port"),
                 accelerator=HorovodRayAccelerator(num_hosts=2, num_slots=1,
                                                   agents=addrs), **common)
    try:
        tt.fit(tm, DataLoader(ArrayDataset(data), batch_size=8,
                              shuffle=True))
        assert tt.global_step == 16
        for k in ("kernel", "bias"):
            np.testing.assert_allclose(tm.params["layer"][k].numpy(),
                                       np.asarray(jm.params["layer"][k]),
                                       rtol=0, atol=1e-5)
        world = tt._world
        assert world.placement == addrs and world.devices == ["cpu"] * 2
        pids = [w.execute(torch_boring.pid_and_rank).result(timeout=60)[0]
                for w in world.pool.workers]
        evaluation = DataLoader(ArrayDataset(data[:24]), batch_size=8)
        tt.validate(tm, evaluation)
        got_test = tt.test(tm, evaluation)
        got_pred = tt.predict(tm, evaluation)
        assert tt._world is world
        assert [w.execute(torch_boring.pid_and_rank).result(
            timeout=60)[0] for w in world.pool.workers] == pids
        # one worker spawned on each agent across the four entry points
        assert [h.spawn_count - b for h, b in zip(hosts, before)] == [1, 1]
        assert got_test[0]["y"] == pytest.approx(
            float(want_test[0]["y"]), abs=1e-5)
        assert len(got_pred) == len(want_pred) == 3
        for g, w in zip(got_pred, want_pred):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
        # ship-once went through a worker of each host (two loopback
        # agents are one host), never from the driver; the evaluation
        # loader crossed once for three entry points
        stats = world.ship_stats
        assert stats["via"] == "workers" and stats["hosts"] == 1
        assert stats["sent"] == 2 and stats["reused"] == 2
    finally:
        tt.shutdown_workers()


def test_num_hosts_contract(agents, caplog):
    _hosts, addrs = agents
    with pytest.raises(ValueError, match="num_hosts=2 but 1 agent"):
        Trainer(device="cpu", accelerator=HorovodRayAccelerator(
            num_hosts=2, agents=addrs[:1])).fit(
                BoringModel(), torch_boring.boring_loaders()[0])
    acc = RayTPUAccelerator(3, num_hosts=2, agents=addrs)
    Trainer(device="cpu", accelerator=acc)
    with pytest.raises(ValueError, match="must be divisible by"):
        acc.launch_spec()
    # without agents num_hosts > 1 warns and runs on this host
    acc = HorovodRayAccelerator(num_hosts=2, num_slots=1)
    Trainer(device="cpu", accelerator=acc)
    with caplog.at_level("WARNING"):
        spec = acc.launch_spec()
    assert "agents" not in spec and spec["num_processes"] == 2
    assert "no host agents" in caplog.text


def test_tune_process_trial_on_an_agent(agents, tmp_path):
    hosts, addrs = agents
    before = hosts[1].spawn_count
    analysis = tune.run(torch_boring.report_pid,
                        config={"x": tune.grid_search([2.0])},
                        num_samples=1, metric="loss", mode="min",
                        local_dir=str(tmp_path), trial_executor="process",
                        device="cpu", agents=[addrs[1]])
    (trial,) = analysis.trials
    assert trial.status == "TERMINATED"
    assert trial.last_result["loss"] == 4.0
    assert trial.last_result["pid"] != os.getpid()
    assert hosts[1].spawn_count == before + 1


def test_cli_launch_exports_the_agents(tmp_path, monkeypatch):
    """``launch`` runs the script as ``__main__`` with the agents in
    ``RLA_TPU_AGENTS`` and its own argv (in this process: the env and
    argv are put back after); ``trace`` reads a trace directory and
    names what is missing from one that holds none."""
    out = tmp_path / "seen.json"
    script = tmp_path / "driver.py"
    script.write_text(
        "import sys\n"
        "from tests.torch_boring import write_launch_env\n"
        "if __name__ == '__main__':\n"
        "    write_launch_env(sys.argv[1])\n")
    monkeypatch.setenv("RLA_TPU_AGENTS", "")
    monkeypatch.setattr(sys, "argv", list(sys.argv))
    cli.main(["launch", "--agents", "127.0.0.1:7001,127.0.0.1:7002",
              str(script), str(out)])
    seen = json.loads(out.read_text())
    assert seen["agents"] == "127.0.0.1:7001,127.0.0.1:7002"
    assert seen["argv"] == [str(script), str(out)]
    with pytest.raises(FileNotFoundError, match="trace.json"):
        cli.main(["trace", str(tmp_path)])


def test_cli_agent_prints_its_port():
    proc = subprocess.Popen(
        [sys.executable, "-m", "ray_lightning_accelerators_tpu_torch.cli",
         "agent", "--port", "0"], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        port = int(proc.stdout.readline())
        conn = agent.AgentConnection(f"127.0.0.1:{port}", timeout=30)
        assert conn.call("ping", timeout=30) == "pong"
        conn.close()
    finally:
        proc.kill()
        proc.wait(timeout=30)


@pytest.mark.slow
def test_elastic_fit_recovers_over_agents(agents, tmp_path):
    """tests/test_fault_tolerance.py's agents test: rank 1 on its agent
    dies mid-fit, the runner restarts every rank through the agents, a
    fresh group forms on agent 0's host, and training resumes from the
    last checkpoint to the end."""
    _hosts, addrs = agents
    root = str(tmp_path / "elastic_run")
    pool = ActorPool(2, agents=addrs)
    try:
        runner = ElasticRunner(pool, max_failures=2)

        def args_for(attempt):
            # a fresh rendezvous each attempt: the old one died with
            # rank 0's restart
            coord = agent.coordinator_address_on(addrs[0], loopback=True)
            return [(coord, attempt, r, root) for r in range(2)]

        results = runner.run(torch_boring.elastic_fit_body,
                             args_per_worker=args_for)
        assert runner.attempts_used == 2
        by_rank = {r[0]: r for r in results}
        for rank in (0, 1):
            _, epoch, step, _ = by_rank[rank]
            assert epoch == 3
            assert step == 12
        assert by_rank[0][3] == pytest.approx(by_rank[1][3], rel=1e-6)
    finally:
        pool.kill()
