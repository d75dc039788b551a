"""Host agents of the PyTorch port (``runtime/agent.py``): the protocol
and the pool's placement through it, on loopback agents in this process.
Port of tests/test_agent.py's protocol tests:

- the pure functions against the JAX package's on the same inputs:
  ``assign_agents`` (even, 3 over 2, ``host:port*N``, mixed specs
  refused), ``parse_agent_spec``, ``queue_bind_for_agents``,
  ``is_loopback`` (literal addresses only: a hostname would be resolved);
- the auth handshake, checked on the raw frame before anything is
  unpickled, a tokened client against an open agent, and the tokenless
  wide bind's refusal; ``coordinator_address_on``;
- over two ``HostAgent``s: ``RemoteWorker`` execute, the remote
  traceback, death -> failed future -> restart; the pool's contiguous
  blocks, env and health; the heartbeat snapshot and a wedge reaped
  through the agent; the ``live`` op naming its slice; an unreachable
  agent failing a fit before the driver's module is touched, with the
  worker already placed on the healthy agent killed.

Every wait is bounded; a spawned worker imports the port (~2 s)."""

import multiprocessing
import pickle
import socket
import time

import pytest
import torch

from ray_lightning_accelerators_tpu.runtime import agent as jax_agent
from ray_lightning_accelerators_tpu_torch import RayTPUAccelerator, Trainer
from ray_lightning_accelerators_tpu_torch.runtime import agent, bootstrap
from ray_lightning_accelerators_tpu_torch.runtime.actors import (
    ActorPool, RemoteError)
from ray_lightning_accelerators_tpu_torch.runtime.watchdog import (
    WorkerWedged)

from . import torch_boring
from .torch_boring import BoringModel, boring_loaders

WAIT = 60


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


def _closed_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# --------------------------------------------------------------------- #
# Pure functions, against the JAX package's                              #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("specs,n", [
    (["a:1", "b:2"], 4),                 # even
    (["a:1", "b:2"], 3),                 # 3 over 2: 2 + 1
    (["a:1", "b:2", "c:3"], 2),          # fewer workers than hosts
    (["a:1*3", "b:2*1"], 4),             # pinned counts
    (["a:1*0", "b:2*2"], 2),
    (["a:1*2", "b:2"], 3),               # mixed: refused
    (["a:1*2", "b:2*2"], 3),             # counts not summing: refused
    (["a:1*-1", "b:2*4"], 3),            # negative: refused
    ([], 2),                             # no agent: refused
])
def test_assign_agents_matches_jax(specs, n):
    try:
        want = jax_agent.assign_agents(specs, n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            agent.assign_agents(specs, n)
        assert str(got.value) == str(e)
        return
    assert agent.assign_agents(specs, n) == want


@pytest.mark.parametrize("spec", ["10.0.0.1:7777", "h:1*3", " h:2 * 4 ",
                                  "host"])
def test_parse_agent_spec_matches_jax(spec):
    assert agent.parse_agent_spec(spec) == jax_agent.parse_agent_spec(spec)
    addr = agent.parse_agent_spec(spec)[0]
    assert agent.parse_address(addr) == jax_agent.parse_address(addr)


@pytest.mark.parametrize("agents_", [
    None, [], ["127.0.0.1:1", "localhost:2*2"], ["127.0.0.1:1", "10.1.2.3:7"],
    ["[::1]:5"], ["0.0.0.0:1"]])
def test_queue_bind_for_agents_matches_jax(agents_):
    assert agent.queue_bind_for_agents(agents_) == \
        jax_agent.queue_bind_for_agents(agents_)


@pytest.mark.parametrize("host", ["127.0.0.1", "127.8.9.10", "::1", "[::1]",
                                  "localhost", "10.0.0.1", "0.0.0.0",
                                  "fe80::1"])
def test_is_loopback_matches_jax(host):
    assert agent.is_loopback(host) == jax_agent.is_loopback(host)


def test_local_indices_follow_the_blocks():
    assert agent.local_indices(agent.assign_agents(["a:1", "b:2"], 5)) == \
        [0, 1, 2, 0, 1]


# --------------------------------------------------------------------- #
# The handshake                                                          #
# --------------------------------------------------------------------- #
class _Tripwire:
    """Unpickling one writes a file: proof that a frame was unpickled."""

    def __init__(self, path):
        self.path = path

    def __reduce__(self):
        return (open, (self.path, "w"))


def test_auth_handshake(tmp_path, monkeypatch):
    tokened = agent.HostAgent(port=0, token="s3cret")
    tokened.serve_in_background()
    open_agent = agent.HostAgent(port=0)
    open_agent.serve_in_background()
    try:
        addr = f"127.0.0.1:{tokened.port}"
        # a data frame without the auth frame: closed, never unpickled
        trip = tmp_path / "unpickled"
        with socket.create_connection(("127.0.0.1", tokened.port),
                                      timeout=10) as s:
            agent.send_msg(s, (0, "ping", _Tripwire(str(trip))))
            s.settimeout(10)
            assert s.recv(1) == b""
        assert not trip.exists()
        # a wrong token: the first op fails on the closed connection
        bad = agent.AgentConnection(addr, token="wrong")
        with pytest.raises(ConnectionError):
            bad.call("ping", timeout=10)
        bad.close()
        good = agent.AgentConnection(addr, token="s3cret")
        assert good.call("ping", timeout=10) == "pong"
        good.close()
        # a tokened client against an open agent: the auth frame is
        # consumed and the connection serves
        client = agent.AgentConnection(f"127.0.0.1:{open_agent.port}",
                                       token="s3cret")
        assert client.call("ping", timeout=10) == "pong"
        client.close()
    finally:
        tokened.shutdown()
        open_agent.shutdown()
    # a tokenless bind the network can reach is refused before binding
    monkeypatch.delenv("RLA_TPU_AGENT_TOKEN", raising=False)
    monkeypatch.delenv("RLA_TPU_ALLOW_TOKENLESS_BIND", raising=False)
    with pytest.raises(RuntimeError, match="RLA_TPU_AGENT_TOKEN"):
        agent.HostAgent(port=0, bind="0.0.0.0")


def test_coordinator_address_on(agents):
    _hosts, addrs = agents
    host, port = agent.coordinator_address_on(addrs[0],
                                              loopback=True).split(":")
    assert host == "127.0.0.1" and 0 < int(port) < 65536
    from ray_lightning_accelerators_tpu_torch.runtime.net import node_ip
    host, port = agent.coordinator_address_on(addrs[1]).split(":")
    assert host == node_ip() and int(port) > 0


# --------------------------------------------------------------------- #
# Remote workers over two agents                                         #
# --------------------------------------------------------------------- #
def test_remote_worker_execute_traceback_death_and_restart(agents):
    hosts, addrs = agents
    spawned = hosts[1].spawn_count
    w = agent.RemoteWorker(addrs[1], 0)
    try:
        assert hosts[1].spawn_count == spawned + 1
        assert w.execute(torch_boring.ok, 21).result(timeout=WAIT) == 42
        with pytest.raises(RemoteError) as err:
            w.execute(torch_boring.raise_value_error,
                      "boom").result(timeout=WAIT)
        assert err.value.remote_type == "ValueError"
        assert "raise_value_error" in err.value.remote_traceback
        # death: the future fails, the worker reads dead, a restart on
        # its agent serves again
        with pytest.raises(RuntimeError, match="died"):
            w.execute(torch_boring.crash, 5).result(timeout=WAIT)
        assert not w.is_alive and w.exitcode == -1
        w.restart()
        assert w.is_alive
        assert w.execute(torch_boring.ok, 1).result(timeout=WAIT) == 2
        from ray_lightning_accelerators_tpu_torch.runtime.net import node_ip
        assert w.get_node_ip() == node_ip()
        # the wire is the standard pickle: a lambda is refused at execute
        with pytest.raises((pickle.PicklingError, AttributeError)):
            w.execute(lambda: 1)
        # the live op comes with the telemetry slice
        with pytest.raises(RemoteError, match="runtime 5d") as err:
            w._conn.call("live", timeout=10)
        assert err.value.remote_type == "NotImplementedError"
    finally:
        w.kill()


def test_pool_places_blocks_env_and_health(agents):
    hosts, addrs = agents
    before = [h.spawn_count for h in hosts]
    pool = ActorPool(3, env_per_worker=[{"RLA_X": str(i)} for i in range(3)],
                     agents=addrs)
    try:
        assert [w.address for w in pool.workers] == \
            [addrs[0], addrs[0], addrs[1]]
        assert [h.spawn_count - b for h, b in zip(hosts, before)] == [2, 1]
        assert [f.result(timeout=WAIT) for f in pool.execute_all(
            torch_boring.env_value, "RLA_X")] == ["0", "1", "2"]
        pool.set_env_vars({"RLA_Y": "y"})
        assert [f.result(timeout=WAIT) for f in pool.execute_all(
            torch_boring.env_value, "RLA_Y")] == ["y"] * 3
        assert pool.health_check() == [True] * 3
        # every loopback agent answers with this host's address
        assert len(set(pool.node_ips())) == 1
        assert pool.local_ranks() == [0, 1, 2]
        # an agent-backed pool places no worker of its own
        with pytest.raises(RuntimeError, match="local subprocess pools"):
            pool.add_worker()
        pool.drop([2])
        assert pool.dropped_ranks() == [2]
        assert pool.revive(2) is None
    finally:
        pool.shutdown()


def test_heartbeat_and_wedge_reap_through_the_agent(agents):
    _hosts, addrs = agents
    pool = ActorPool(1, env_per_worker=[{"RLA_TPU_WORKER_HEARTBEAT_S":
                                         "0.1"}], agents=addrs[:1])
    try:
        w = pool.workers[0]
        assert w.execute(torch_boring.ok).result(timeout=WAIT) == 2
        snap = w.heartbeat.snapshot()
        assert set(snap) >= {"beat_age_s", "busy_s", "dispatches"}
        assert snap["dispatches"] >= 1 and snap["beat_age_s"] < 5.0
        fut = w.execute(torch_boring.hang_frozen)
        watchdog = pool.watch(wedge_timeout_s=1.5, poll_s=0.1)
        try:
            with pytest.raises(WorkerWedged) as err:
                fut.result(timeout=WAIT)
        finally:
            watchdog.stop()
        assert err.value.rank == 0
        assert [r["rank"] for r in watchdog.reaped] == [0]
        # the slot stays restartable through its agent
        w.restart()
        assert w.execute(torch_boring.ok, 3).result(timeout=WAIT) == 6
    finally:
        pool.shutdown()


def _new_children(before):
    return [p for p in multiprocessing.active_children()
            if p.pid not in before]


def test_unreachable_agent_leaves_the_driver_module_intact(
        agents, tmp_path, monkeypatch):
    """One agent down: the world fails to form before the module is
    stripped for shipment, and the worker already placed on the healthy
    agent is killed."""
    hosts, addrs = agents
    monkeypatch.setenv("RLA_TPU_AGENT_CONNECT_TIMEOUT", "0.5")
    before = {p.pid for p in multiprocessing.active_children()}
    spawned = hosts[0].spawn_count
    model = BoringModel()
    model.params = model.init_params(0)
    kept = model.params
    snapshot = {k: v.clone() for k, v in kept["layer"].items()}
    trainer = Trainer(device="cpu", max_steps=1, enable_checkpointing=False,
                      default_root_dir=str(tmp_path),
                      accelerator=RayTPUAccelerator(
                          2, agents=[addrs[0], f"127.0.0.1:{_closed_port()}"]))
    train, _ = boring_loaders()
    with pytest.raises(ConnectionRefusedError):
        trainer.fit(model, train)
    assert hosts[0].spawn_count == spawned + 1
    assert model.params is kept and model.trainer is None
    for k, v in snapshot.items():
        assert torch.equal(model.params["layer"][k], v)
    assert trainer._world is None
    deadline = time.monotonic() + 20
    while _new_children(before) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert _new_children(before) == []
