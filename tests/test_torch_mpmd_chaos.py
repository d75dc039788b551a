"""Per-stage fault domains of the port's MPMD runner (port of
tests/test_mpmd_chaos.py): a fault of stage 1 -- its worker process
ending (crash) or its stage hook sleeping (hang) at one optimizer step
-- is attributed to stage 1, charged to its budget only, and replayed
from the last checkpoint to the clean trajectory (the JAX package's
one-process baseline, rtol 1e-6), through the runner and through
``Trainer.fit``; a fault that fires on every attempt
exhausts the budget and fails typed, recorded in run_report.json.  The
port has no chaos injector yet (the runtime slice), so the fault lives
in the test module's own stage hook (tests/torch_boring.py
``FaultyPipelineModel``), firing once through a claim file."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from ray_lightning_accelerators_tpu_torch import Trainer
from ray_lightning_accelerators_tpu_torch.parallel.mpmd.driver import (
    PipelineRunner, PipelineStageFailed)
from tests.torch_boring import FaultyPipelineModel
from tests.utils import PipelineBoringModel as JaxPipelineBoringModel

pytestmark = pytest.mark.pipeline_mpmd


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(0)
    return [rng.standard_normal((8, 8)).astype(np.float32)
            for _ in range(3)]


@pytest.fixture(scope="module")
def jax_weights():
    return jax.device_get(
        JaxPipelineBoringModel().init_params(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def clean_losses(batches, jax_weights):
    """What the unfaulted pipeline produces (the JAX package's
    one-process trajectory): replay must reproduce it."""
    mod = JaxPipelineBoringModel()
    params = jax.tree.map(jnp.asarray, jax_weights)
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


def _claims(tmpdir):
    path = os.path.join(str(tmpdir), "claims")
    os.makedirs(path, exist_ok=True)
    return path


def test_crash_at_stage1_replays_within_stage_budget(tmpdir, batches,
                                                     jax_weights,
                                                     clean_losses):
    """Stage 1's worker ends at step 2: the run completes by replay from
    the step-1 checkpoint, stage 1 is charged and stage 0 is not, and
    the replayed trajectory is exact."""
    model = FaultyPipelineModel("crash", stage=1, step=2,
                                claim_dir=_claims(tmpdir),
                                weights=jax_weights)
    runner = PipelineRunner(model, num_stages=2, num_microbatches=4, seed=0,
                            workdir=str(tmpdir), device="cpu")
    try:
        summary = runner.run(batches)
    finally:
        runner.shutdown()
    assert summary["replays"] == 1
    assert summary["stage_failure_budget_used"] == [0, 1]
    np.testing.assert_allclose(summary["losses"], clean_losses, rtol=1e-6)
    report = json.load(open(os.path.join(str(tmpdir), "run_report.json")))
    assert report["error"] is None
    replays = [e for e in report["ranks"]["driver"]["events"]
               if e["kind"] == "pipeline_replay"]
    assert [e["data"]["stage"] for e in replays] == [1]


def test_hang_at_stage1_attributed_and_replayed(tmpdir, batches,
                                                jax_weights, clean_losses):
    """Stage 1 hangs at step 2: stage 0 only sees a handoff timeout
    (4 s), which must not win attribution; the step deadline (4 x 4 s)
    names the hung stage 1, and the run completes by replay.  The
    replay's healthy stages start in fresh processes (their boot is
    awaited before the step), and their first step under a loaded suite
    can outlast 2 s: 4 s is the window such a step meets."""
    model = FaultyPipelineModel("hang", stage=1, step=2,
                                claim_dir=_claims(tmpdir),
                                weights=jax_weights)
    runner = PipelineRunner(model, num_stages=2, num_microbatches=4, seed=0,
                            workdir=str(tmpdir), handoff_timeout_s=4.0,
                            device="cpu")
    try:
        summary = runner.run(batches[:2])
    finally:
        runner.shutdown()
    assert summary["replays"] == 1
    assert summary["stage_failure_budget_used"] == [0, 1]
    np.testing.assert_allclose(summary["losses"], clean_losses[:2],
                               rtol=1e-6)


def test_hang_through_the_trainer_ends_at_the_knobs_deadline(
        tmpdir, monkeypatch, batches, jax_weights, clean_losses):
    """The Trainer passes no handoff timeout: the step deadline comes
    from the knob the workers' mailboxes read (4 x 4 s here), so a
    stage-1 hang under ``fit`` is attributed and replayed, not waited
    on forever.  The replay's healthy stages start in fresh processes
    (their boot is awaited before the step, not charged to a handoff),
    and their first step under a loaded suite can outlast 2 s: 4 s is
    the window such a step meets."""
    monkeypatch.setenv("RLA_TPU_PIPELINE_HANDOFF_TIMEOUT_S", "4")
    model = FaultyPipelineModel("hang", stage=1, step=2,
                                claim_dir=_claims(tmpdir),
                                weights=jax_weights)
    trainer = Trainer(device="cpu", precision="f32", max_steps=2,
                      default_root_dir=str(tmpdir), pipeline_stages=2,
                      pipeline_microbatches=4, enable_checkpointing=False,
                      seed=0)
    trainer.fit(model, train_dataloaders=batches)
    summary = trainer.pipeline_summary
    assert summary["replays"] == 1
    assert summary["stage_failure_budget_used"] == [0, 1]
    np.testing.assert_allclose(summary["losses"], clean_losses[:2],
                               rtol=1e-6)


def test_exhausted_stage_budget_fails_typed_with_attribution(
        tmpdir, batches, jax_weights):
    """Without a claim the fault fires on every replayed attempt; past
    max_stage_failures the run fails as PipelineStageFailed naming the
    faulting stage group, and the report records it."""
    model = FaultyPipelineModel("crash", stage=1, step=2,
                                weights=jax_weights)
    runner = PipelineRunner(model, num_stages=2, num_microbatches=4, seed=0,
                            workdir=str(tmpdir), max_stage_failures=1,
                            device="cpu")
    with pytest.raises(PipelineStageFailed) as exc_info:
        try:
            runner.run(batches)
        finally:
            runner.shutdown()
    err = exc_info.value
    assert err.stage == 1
    assert err.budget_used == [0, 2]  # stage 0 never cross-charged
    report = json.load(open(os.path.join(str(tmpdir), "run_report.json")))
    assert report["error"]["type"] == "PipelineStageFailed"
    assert report["error"]["diagnosis"]["stage"] == 1
    assert report["error"]["diagnosis"]["budget_used"] == [0, 2]
    assert report["extra"]["pipeline"]["stage_failure_budget_used"] == [0, 2]
