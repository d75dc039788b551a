"""The recovery layer through the port's ``Trainer`` and MPMD runner,
against the JAX package where a trajectory is compared:

- ``Trainer(accelerator=RayAccelerator(num_workers=2),
  worker_deadline_s=30)`` with ``hang@rank1:step2:once`` in the ranks'
  env (dispatch 1 of a rank is the world's rendezvous, 2 the fit): the
  watchdog reaps rank 1 on its stale heartbeat, ``fit`` raises
  ``WorkerWedged`` naming rank 1 well inside the deadline plus 20 s,
  ``last_stall_diagnosis`` holds the reap, and a second fit on the same
  trainer forms a new world and runs to its end;
- ``Trainer(pipeline_stages=2, worker_deadline_s=2.0)``, the runner's
  ``wedge_timeout_s``, with ``hang@stage1:step2:once``: the watchdog
  reaps stage 1's worker, stage 1 alone is charged, and the replay ends
  on the clean trajectory (the JAX one-process baseline, rtol 1e-6);
- ``badbatch@step3`` through ``ElasticRunner(max_rewinds=2)`` over 2
  gloo ranks: the guard trips on batch 2 of epoch 0, the typed
  ``NumericAnomaly`` (blame "data") rewinds once with no failure
  charged, the window is quarantined, and the retried fit (15 steps)
  ends on the params of a clean JAX ``Trainer`` run on 2 devices that
  skips the same batch (1e-5).

Chaos specs reach the workers through their env (a chaos-marked test's
monkeypatched environment, which the spawned ranks inherit)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_lightning_accelerators_tpu import RayTPUAccelerator as JaxRayTPU
from ray_lightning_accelerators_tpu import Trainer as JaxTrainer
from ray_lightning_accelerators_tpu.data.loader import (
    ArrayDataset as JaxArrayDataset, DataLoader as JaxDataLoader)
from ray_lightning_accelerators_tpu.runtime import guardian as jg
from ray_lightning_accelerators_tpu_torch import (DataLoader, RayAccelerator,
                                                  Trainer, WorkerWedged)
from ray_lightning_accelerators_tpu_torch.data.loader import ArrayDataset
from ray_lightning_accelerators_tpu_torch.runtime import bootstrap
from ray_lightning_accelerators_tpu_torch.runtime import guardian as tg
from ray_lightning_accelerators_tpu_torch.runtime.actors import ActorPool
from ray_lightning_accelerators_tpu_torch.runtime.elastic import (
    ElasticRunner)

from .torch_boring import (BoringModel, PipelineBoringModel,
                           badbatch_fit_body)
from .utils import BoringModel as JaxBoring
from .utils import PipelineBoringModel as JaxPipelineBoringModel

pytestmark = pytest.mark.chaos


def _chaos_env(monkeypatch, tmp_path, spec, wedge=None):
    monkeypatch.setenv("RLA_TPU_CHAOS", spec)
    monkeypatch.setenv("RLA_TPU_CHAOS_NS", str(tmp_path / "ns"))
    monkeypatch.setenv("RLA_TPU_WORKER_HEARTBEAT_S", "0.1")
    if wedge is not None:
        monkeypatch.setenv("RLA_TPU_WEDGE_TIMEOUT_S", str(wedge))


def test_worker_deadline_reaps_a_hung_rank(tmp_path, monkeypatch):
    import time
    _chaos_env(monkeypatch, tmp_path, "hang@rank1:step2:once", wedge=1.5)
    monkeypatch.setattr(bootstrap, "DEFAULT_TIMEOUT_S", 60.0)
    data = np.random.default_rng(0).normal(size=(32, 32)).astype(np.float32)
    deadline = 30.0
    t = Trainer(device="cpu", precision="f32", max_epochs=1, seed=0,
                accelerator=RayAccelerator(num_workers=2),
                worker_deadline_s=deadline, enable_checkpointing=False,
                default_root_dir=str(tmp_path / "run"))
    try:
        t0 = time.monotonic()
        with pytest.raises(WorkerWedged) as ei:
            t.fit(BoringModel(), DataLoader(ArrayDataset(data), batch_size=8))
        assert time.monotonic() - t0 < deadline + 20.0
        assert ei.value.rank == 1
        assert "stale" in ei.value.diagnosis["detail"]
        rec = t.last_stall_diagnosis
        assert rec["error"] == "worker wedged" and rec["rank"] == 1
        assert [r["rank"] for r in rec["reaped"]] == [1]
        assert t._world is None
        # the claim is spent: a second fit forms a new world and ends
        t.fit(BoringModel(), DataLoader(ArrayDataset(data), batch_size=8))
        assert t.global_step == 4 and t.last_stall_diagnosis is None
    finally:
        t.shutdown_workers()


def _clean_losses(batches, weights):
    """The unfaulted pipeline (the JAX package's one-process baseline)."""
    mod = JaxPipelineBoringModel()
    params = jax.tree.map(jnp.asarray, weights)
    tx = mod.configure_optimizers()
    opt = tx.init(params)
    losses = []
    for batch in batches:
        g_acc = jax.tree.map(jnp.zeros_like, params)
        loss_sum = 0.0
        for mb in np.split(batch, 4):
            loss, g = jax.value_and_grad(
                lambda p, xb: mod.training_step(p, xb, None)[0])(params, mb)
            g_acc = jax.tree.map(jnp.add, g_acc, g)
            loss_sum += float(loss)
        updates, opt = tx.update(
            jax.tree.map(lambda a: a / 4, g_acc), opt, params)
        params = optax.apply_updates(params, updates)
        losses.append(loss_sum / 4)
    return losses


@pytest.mark.pipeline_mpmd
def test_pipeline_watchdog_reaps_stage1_and_replays(tmp_path, monkeypatch):
    """Stage 1 hangs at its first step (dispatch 2: 1 is the stage init);
    its stale heartbeat is reaped after 2 s, long before the 12 s handoff
    timeout, and the step is replayed to the clean trajectory."""
    _chaos_env(monkeypatch, tmp_path, "hang@stage1:step2:once")
    monkeypatch.setenv("RLA_TPU_PIPELINE_HANDOFF_TIMEOUT_S", "12")
    rng = np.random.default_rng(0)
    batches = [rng.standard_normal((8, 8)).astype(np.float32)
               for _ in range(2)]
    weights = jax.device_get(
        JaxPipelineBoringModel().init_params(jax.random.PRNGKey(0)))
    t = Trainer(device="cpu", precision="f32", max_steps=2,
                default_root_dir=str(tmp_path / "run"), pipeline_stages=2,
                pipeline_microbatches=4, enable_checkpointing=False, seed=0,
                worker_deadline_s=2.0)
    t.fit(PipelineBoringModel(weights=weights), train_dataloaders=batches)
    summary = t.pipeline_summary
    assert summary["replays"] == 1
    assert summary["stage_failure_budget_used"] == [0, 1]
    (reap,) = summary["reaped"]
    assert reap["rank"] == 1 and "stale" in reap["detail"]
    np.testing.assert_allclose(summary["losses"],
                               _clean_losses(batches, weights), rtol=1e-6)


def test_badbatch_rewinds_over_two_ranks_to_jax_params(tmp_path):
    """``badbatch@step3`` over 2 gloo ranks under ``ElasticRunner``: one
    rewind, no failure charged, the window quarantined, and the retried
    fit's params those of a clean JAX run skipping the same batch."""
    from ray_lightning_accelerators_tpu_torch.runtime.bootstrap import (
        pick_coordinator_address)
    root = str(tmp_path / "run")
    data = np.random.default_rng(0).normal(size=(64, 32)).astype(np.float32)
    init = jax.tree.map(np.asarray, jax.device_get(
        JaxBoring().init_params(jax.random.PRNGKey(0))))
    env = {"RLA_TPU_CHAOS": "badbatch@step3",
           "RLA_TPU_CHAOS_NS": str(tmp_path / "ns"),
           "RLA_TPU_WORKER_HEARTBEAT_S": "0.1"}
    pool = ActorPool(2, env_per_worker=[dict(env), dict(env)])
    charged = []
    try:
        runner = ElasticRunner(pool, max_failures=0, max_rewinds=2,
                               guard_root_dir=root,
                               on_failure=lambda a, e: charged.append(e))

        def args(attempt):
            coord = pick_coordinator_address()
            return [(coord, r, root, data, init) for r in range(2)]

        (steps, loss, params), _ = runner.run(badbatch_fit_body,
                                              args_per_worker=args)
    finally:
        pool.kill()
    assert runner.attempts_used == 2 and charged == []
    (ev,) = runner.anomaly_events
    assert ev["blame"] == "data" and ev["batch_idx"] == 2 and ev["epoch"] == 0
    assert steps == 15 and np.isfinite(loss)
    assert tg.skip_set(root, 0) == {2}

    jroot = str(tmp_path / "jax")
    jg.add_quarantine(jroot, 0, 2, 2)
    m = JaxBoring()
    m.params = jax.tree.map(jnp.asarray, init)
    jt = JaxTrainer(precision="f32", seed=0, max_epochs=2,
                    enable_checkpointing=False, log_every_n_steps=1,
                    default_root_dir=jroot,
                    accelerator=JaxRayTPU(num_workers=2))
    jt.fit(m, JaxDataLoader(JaxArrayDataset(data), batch_size=8))
    assert jt.global_step == 15
    for name in ("kernel", "bias"):
        np.testing.assert_allclose(params["layer"][name],
                                   np.asarray(m.params["layer"][name]),
                                   rtol=1e-5, atol=1e-30)
