"""The live resize of the PyTorch port (``parallel/redistribute.py``,
``Trainer.resize_in_memory`` with ``fit(ckpt_path="live")``,
``ElasticRunner(resize_in_memory=True)``), against the JAX package's
(port of tests/test_resize.py):

- ``leaf_moved_bytes`` / ``resharding_bytes`` equal the JAX functions'
  for ZeRO-1's dim-0 slice at dp 4 -> 2 and 2 -> 4, replicated leaves,
  and an fsdp x data layout;
- in one 4-rank world under ZeRO-1 (Adam moments sliced over the
  ranks): 2 steps; ``resize_in_memory(3)`` refused before any change
  (the params bitwise, the same 4 processes); 4 -> 2 and a live fit to
  step 4; 2 -> 4 under a small ``max_bytes`` and a live fit to step 6.
  Each stage is held against the JAX ``Trainer`` doing the same on 4 host
  devices: params within atol 1e-5 (JAX's own bound in
  ``test_resize_in_memory_matches_checkpoint_restore``), ``bytes_moved``
  and ``waves`` equal to JAX's; no ``.ckpt`` file anywhere;
- the refusals without live state;
- the ElasticRunner loops: shrink-then-rejoin (bit-equal trajectory,
  the ``resize`` goodput phase, ``resize_end``) and the fallback when
  every rank dies mid-attempt (the budget charged once)."""

import json
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ray_lightning_accelerators_tpu import ElasticResizeError as JaxResizeErr
from ray_lightning_accelerators_tpu import RayTPUAccelerator as JaxRayTPU
from ray_lightning_accelerators_tpu import Trainer as JaxTrainer
from ray_lightning_accelerators_tpu.data.loader import (
    ArrayDataset as JaxArrayDataset, DataLoader as JaxDataLoader)
from ray_lightning_accelerators_tpu.parallel import mesh as jax_mesh
from ray_lightning_accelerators_tpu.parallel import redistribute as jax_rd
from ray_lightning_accelerators_tpu_torch import (DataLoader,
                                                  ElasticResizeError,
                                                  RayTPUAccelerator, Trainer)
from ray_lightning_accelerators_tpu_torch.data.loader import ArrayDataset
from ray_lightning_accelerators_tpu_torch.parallel import redistribute as rd
from ray_lightning_accelerators_tpu_torch.runtime import bootstrap
from ray_lightning_accelerators_tpu_torch.runtime.actors import ActorPool
from ray_lightning_accelerators_tpu_torch.runtime.elastic import (
    ElasticRunner)
from ray_lightning_accelerators_tpu_torch.telemetry import recorder

from . import torch_boring
from .torch_boring import AdamBoringModel
from .utils import BoringModel as JaxBoring

pytestmark = pytest.mark.resize

HB = "0.1"


@pytest.fixture(autouse=True)
def bounded_worlds(monkeypatch):
    monkeypatch.setattr(bootstrap, "DEFAULT_TIMEOUT_S", 60.0)


class JaxAdamBoring(JaxBoring):
    def configure_optimizers(self):
        return optax.adam(0.1)


# --------------------------------------------------------------------- #
# The analytic bytes, against the JAX functions                          #
# --------------------------------------------------------------------- #
def _jax_leaf(shape, cfg, spec):
    n = int(np.prod([v for v in cfg.values()]))
    mesh = jax_mesh.build_mesh(jax_mesh.MeshConfig(**cfg),
                               devices=jax.devices()[:n])
    return mesh, jax.device_put(jnp.zeros(shape, jnp.float32),
                                NamedSharding(mesh, spec))


BATCH = P(("data", "fsdp"))


@pytest.mark.parametrize("shape,old,old_spec,new,new_spec", [
    # ZeRO-1's dim-0 slice, dp 4 -> 2 and 2 -> 4
    ((16, 4), {"data": 4}, BATCH, {"data": 2}, BATCH),
    ((16, 4), {"data": 2}, BATCH, {"data": 4}, BATCH),
    # a replicated leaf: nothing moves on a shrink, whole copies on a grow
    ((16, 4), {"data": 4}, P(), {"data": 2}, P()),
    ((16, 4), {"data": 2}, P(), {"data": 4}, P()),
    # replicated at dp 4 (2 rows do not divide), sliced at dp 2
    ((2,), {"data": 4}, P(), {"data": 2}, BATCH),
    ((2,), {"data": 2}, BATCH, {"data": 4}, P()),
    # fsdp x data: split over fsdp, replicated over data
    ((16, 4), {"data": 2, "fsdp": 2}, P("fsdp"), {"data": 4, "fsdp": 2},
     P("fsdp")),
    ((16, 4), {"data": 2, "fsdp": 2}, P("fsdp"), {"data": 1, "fsdp": 2},
     P("fsdp")),
    ((8, 6), {"data": 2, "fsdp": 2}, P(None, "fsdp"), {"data": 1,
                                                      "fsdp": 4}, BATCH),
])
def test_moved_bytes_match_jax(shape, old, old_spec, new, new_spec):
    _, leaf = _jax_leaf(shape, old, old_spec)
    new_mesh, _ = _jax_leaf(shape, new, new_spec)
    want = jax_rd.leaf_moved_bytes(leaf, NamedSharding(new_mesh, new_spec))

    def pairs(spec):
        out = []
        for d, axes in enumerate(spec):
            if axes is None:
                continue
            if isinstance(axes, tuple):
                out.append(("batch", d))
            else:
                out.append((axes, d))
        return tuple(out) or None

    port_leaf = rd.Leaf("x", shape, 4, pairs(old_spec), pairs(new_spec))
    old_shape = {"data": 1, "fsdp": 1, **old}
    new_shape = {"data": 1, "fsdp": 1, **new}
    assert rd.leaf_moved_bytes(port_leaf, old_shape, new_shape) == want
    assert rd.resharding_bytes([port_leaf, port_leaf], old_shape,
                               new_shape) == 2 * want
    # a host value has no old placement: all of it moves, as a JAX numpy
    # leaf does
    assert rd.leaf_moved_bytes(port_leaf, None, new_shape) == \
        jax_rd.leaf_moved_bytes(np.zeros(shape, np.float32),
                                NamedSharding(new_mesh, new_spec))


def test_wave_schedule_matches_jax():
    for sizes, cap in (([100, 100, 100], 250), ([300, 10, 10], 250), ([], 9),
                       ([200, 100, 100], 250), ([4, 256, 8], 1)):
        assert rd.wave_schedule(sizes, cap) == jax_rd.wave_schedule(sizes,
                                                                    cap)


# --------------------------------------------------------------------- #
# Trainer.resize_in_memory in one 4-rank world                           #
# --------------------------------------------------------------------- #
def _ckpts(root):
    return [n for _, _, names in os.walk(str(root)) for n in names
            if n.endswith(".ckpt")]


def _assert_params(port_params, jax_params):
    for k in ("kernel", "bias"):
        np.testing.assert_allclose(port_params["layer"][k].numpy(),
                                   np.asarray(jax_params["layer"][k]),
                                   rtol=0, atol=1e-5)


def test_resize_shrink_and_grow_match_jax(tmp_path):
    init = jax.tree.map(np.asarray, jax.device_get(
        JaxBoring().init_params(jax.random.PRNGKey(0))))
    data = np.random.default_rng(1).normal(size=(64, 32)).astype(np.float32)
    common = dict(max_epochs=100, max_steps=2, precision="f32", seed=0,
                  guard=None, prefetch_batches=0,
                  cache_dataset_on_device=False, enable_checkpointing=False,
                  log_every_n_steps=10 ** 9, shard_optimizer_state=True)

    jm = JaxAdamBoring()
    jm.params = jax.tree.map(jnp.asarray, init)
    jt = JaxTrainer(accelerator=JaxRayTPU(4),
                    default_root_dir=str(tmp_path / "jax"), **common)
    jtrain = JaxDataLoader(JaxArrayDataset(data), batch_size=8, shuffle=True,
                           use_native=False)
    tm = AdamBoringModel()
    tm.params = {"layer": {k: torch.from_numpy(np.array(v))
                           for k, v in init["layer"].items()}}
    tt = Trainer(device="cpu", accelerator=RayTPUAccelerator(4),
                 default_root_dir=str(tmp_path / "port"), **common)
    train = DataLoader(ArrayDataset(data), batch_size=8, shuffle=True)
    try:
        jt.fit(jm, jtrain)
        tt.fit(tm, train)
        _assert_params(tm.params, jax.device_get(jt._state.params))
        pids = [w.pid for w in tt._world.pool.workers]

        # 4 -> 3: the global batch of 8 does not split in 3; refused
        # before any change, in both
        before = {k: v.clone() for k, v in tm.params["layer"].items()}
        with pytest.raises(JaxResizeErr, match="divisible"):
            jt.resize_in_memory(3)
        with pytest.raises(ElasticResizeError, match="divisible"):
            tt.resize_in_memory(3)
        assert tt._world.num_processes == 4
        assert [w.pid for w in tt._world.pool.workers] == pids
        for k, v in before.items():
            assert torch.equal(tm.params["layer"][k], v)

        # 4 -> 2, then a live fit to step 4
        want = jt.resize_in_memory(2)
        got = tt.resize_in_memory(2)
        for key in ("bytes_moved", "bytes_total", "leaves", "waves",
                    "old_world", "new_world"):
            assert got[key] == want[key], key
        assert got["bytes_moved"] > 0
        assert [w.pid for w in tt._world.pool.workers] == pids[:2]
        jt.max_steps = tt.max_steps = 4
        jt.fit(jm, jtrain, ckpt_path="live")
        tt.fit(tm, train, ckpt_path="live")
        assert tt.global_step == jt.global_step == 4
        assert tt.rank_report["world_size"] == 2
        _assert_params(tm.params, jax.device_get(jt._state.params))

        # 2 -> 4 in waves of at most 300 bytes (one leaf a wave but the
        # scalars'), then a live fit to step 6
        want = jt.resize_in_memory(4, max_bytes=300)
        got = tt.resize_in_memory(4, max_bytes=300)
        for key in ("bytes_moved", "bytes_total", "leaves", "waves",
                    "max_wave_bytes", "old_world", "new_world"):
            assert got[key] == want[key], key
        assert got["waves"] > 1
        jt.max_steps = tt.max_steps = 6
        jt.fit(jm, jtrain, ckpt_path="live")
        tt.fit(tm, train, ckpt_path="live")
        assert tt.global_step == jt.global_step == 6
        assert tt.rank_report["world_size"] == 4
        assert [w.pid for w in tt._world.pool.workers][:2] == pids[:2]
        _assert_params(tm.params, jax.device_get(jt._state.params))
        assert tt.goodput.snapshot()["seconds"]["resize"] > 0
        assert _ckpts(tmp_path) == []
    finally:
        tt.shutdown_workers()


def test_refusals_without_live_state(tmp_path):
    trainer = Trainer(device="cpu", accelerator=RayTPUAccelerator(2),
                      max_steps=1, enable_checkpointing=False,
                      default_root_dir=str(tmp_path))
    with pytest.raises(ElasticResizeError, match="live"):
        trainer.resize_in_memory(1)
    with pytest.raises(ValueError, match="live"):
        trainer.fit(AdamBoringModel(), torch_boring.boring_loaders()[0],
                    ckpt_path="live")
    assert trainer._world is None  # refused before any rank started
    local = Trainer(device="cpu", max_steps=1, enable_checkpointing=False,
                    default_root_dir=str(tmp_path))
    with pytest.raises(ValueError, match="live"):
        local.fit(AdamBoringModel(), torch_boring.boring_loaders()[0],
                  ckpt_path="live")


# --------------------------------------------------------------------- #
# ElasticRunner(resize_in_memory=True)                                  #
# --------------------------------------------------------------------- #
@pytest.mark.chaos
@pytest.mark.preempt
def test_chaos_shrink_then_rejoin_grows_back_without_checkpoints(tmp_path):
    """``lost@rank1:step2:once`` shrinks the world 2 -> 1 in memory (the
    survivor keeps its process and state), ``rejoin@rank1:step3`` brings
    the host back on its third respawn and ``revive`` grows the world
    back to 2; the fresh rank joins from the survivor's published state.
    The descent continues bit-equal to an uninterrupted run, and no
    checkpoint file exists."""
    ns = str(tmp_path / "chaos_ns")
    wire = str(tmp_path / "wire")
    os.makedirs(wire)
    env = {"RLA_TPU_CHAOS": "lost@rank1:step2:once,rejoin@rank1:step3",
           "RLA_TPU_CHAOS_NS": ns, "RLA_TPU_WORKER_HEARTBEAT_S": HB}
    pool = ActorPool(2, env_per_worker=[dict(env), dict(env)])
    failures = []
    try:
        for f in pool.execute_per_worker(
                torch_boring.mem_world_body,
                [(r, 2, wire, 3) for r in range(2)]):
            f.result(timeout=120)
        runner = ElasticRunner(pool, max_failures=2, allow_shrink=True,
                               resize_in_memory=True, min_workers=1,
                               probe_timeout_s=120.0,
                               on_failure=lambda a, e: failures.append(e))
        out = runner.run(
            torch_boring.mem_world_body,
            args_per_worker=lambda a, world: [(r, world, wire, 6)
                                              for r in range(world)])
        assert runner.attempts_used == 3
        assert len(failures) == 2
        assert runner.shrink_events == [
            {"dropped": [1], "world_size": 1, "attempt": 2}]
        assert runner.grow_events == [
            {"revived": [1], "world_size": 2, "attempt": 3}]
        assert len(pool) == 2
        by_rank = {r[0]: r for r in out}
        assert by_rank[0][1] == "mem"
        assert by_rank[1][1] == "wire"
        assert by_rank[0][5] == [2, 2, 2, 1, 2, 2]
        w = 1.0
        for _ in range(6):
            w = w - 0.1 * (2.0 * w)
        assert by_rank[0][4] == pytest.approx(w, abs=0.0)
        assert by_rank[1][4] == by_rank[0][4]
        assert _ckpts(tmp_path) == []
        assert runner.goodput.snapshot()["seconds"].get("resize", 0) > 0
        ends = [e for e in recorder.get_recorder().events()
                if e.get("kind") == "resize_end"]
        assert any(e.get("data", {}).get("new_world") == 2 for e in ends)
    finally:
        pool.shutdown()


@pytest.mark.chaos
@pytest.mark.preempt
def test_mid_resize_death_falls_back_to_checkpoint_charging_once(tmp_path):
    """Every rank dies mid-attempt: no process holds live state, the
    retry's fresh processes resume from the checkpoint chain, and the
    episode charges the failure budget once."""
    ns = str(tmp_path / "chaos_ns")
    ckpt = str(tmp_path / "ckpt")
    os.makedirs(ckpt)
    env = {"RLA_TPU_CHAOS":
           "crash@rank0:step2:once,crash@rank1:step2:once",
           "RLA_TPU_CHAOS_NS": ns, "RLA_TPU_WORKER_HEARTBEAT_S": HB}
    pool = ActorPool(2, env_per_worker=[dict(env), dict(env)])
    failures = []
    try:
        for f in pool.execute_per_worker(
                torch_boring.ckpt_fallback_body,
                [(r, 2, ckpt, 3) for r in range(2)]):
            f.result(timeout=120)
        runner = ElasticRunner(pool, max_failures=1, allow_shrink=True,
                               resize_in_memory=True, min_workers=1,
                               probe_timeout_s=120.0,
                               on_failure=lambda a, e: failures.append(e))
        out = runner.run(
            torch_boring.ckpt_fallback_body,
            args_per_worker=lambda a, world: [(r, world, ckpt, 6)
                                              for r in range(world)])
        assert len(failures) == 1
        assert runner.attempts_used == 2
        assert runner.shrink_events == [] and runner.grow_events == []
        assert {r[1] for r in out} == {"ckpt"}
        with open(os.path.join(ckpt, "state.json")) as f:
            assert json.load(f)["step"] == 6
        assert runner.goodput.snapshot()["seconds"].get("resize", 0) > 0
    finally:
        pool.shutdown()
