"""The port's MPMD pipeline runner (``parallel/mpmd``) against the JAX
package's one-process baseline: 1F1B, GPipe and two lanes over spawned
stage workers on the CPU reproduce the JAX trajectory (rtol 1e-6, f32),
keep a constant kernel-build count after step 1, and leave one trace id
on the driver and on every rank's ``pipeline_tick`` events in
``run_report.json``; the refusals of tests/test_mpmd_pipeline.py and the
Trainer wiring, with the port's own (the watchdog); the wire format of
activations.  FSDP inside a stage: tests/test_torch_mpmd_fsdp.py."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_lightning_accelerators_tpu_torch import Trainer
from ray_lightning_accelerators_tpu_torch.parallel.mpmd import handoff
from ray_lightning_accelerators_tpu_torch.parallel.mpmd.driver import (
    PipelineConfigError, PipelineRunner, _typed)
from ray_lightning_accelerators_tpu_torch.runtime.actors import RemoteError
from ray_lightning_accelerators_tpu_torch.runtime.object_store import (
    ObjectStore)
from ray_lightning_accelerators_tpu_torch.utils import checkpoint as ckpt_lib
from tests.torch_boring import BoringModel, PipelineBoringModel
from tests.utils import PipelineBoringModel as JaxPipelineBoringModel

pytestmark = pytest.mark.pipeline_mpmd

M = 4


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(0)
    return [rng.standard_normal((8, 8)).astype(np.float32)
            for _ in range(4)]


@pytest.fixture(scope="module")
def jax_weights():
    return jax.device_get(
        JaxPipelineBoringModel().init_params(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def baseline(batches, jax_weights):
    """The JAX package's one-process reference (tests/test_mpmd_pipeline.py
    ``baseline``): the same microbatch split, the accumulated mean
    gradient, one optax apply per batch.  Returns the losses and the
    params after each step."""
    mod = JaxPipelineBoringModel()
    params = jax.tree.map(jnp.asarray, jax_weights)
    tx = mod.configure_optimizers()
    opt = tx.init(params)

    def loss_fn(p, xb):
        return mod.training_step(p, xb, None)[0]

    losses, history = [], []
    for batch in batches:
        g_acc = jax.tree.map(jnp.zeros_like, params)
        loss_sum = 0.0
        for mb in np.split(batch, M):
            loss, g = jax.value_and_grad(loss_fn)(params, mb)
            g_acc = jax.tree.map(jnp.add, g_acc, g)
            loss_sum += float(loss)
        grads = jax.tree.map(lambda a: a / M, g_acc)
        updates, opt = tx.update(grads, opt, params)
        params = optax.apply_updates(params, updates)
        losses.append(loss_sum / M)
        history.append(jax.device_get(params))
    return losses, history


def _model(jax_weights, **kw):
    return PipelineBoringModel(weights=jax_weights, **kw)


def _assert_checkpoint_params(tmpdir, want, step):
    """The latest replay checkpoint is step ``step`` and its per-stage
    params are ``want``'s, sliced by the module's own stage hook."""
    payload = ckpt_lib.read_checkpoint(
        ckpt_lib.latest_checkpoint(os.path.join(str(tmpdir), "ckpt")))
    assert payload["global_step"] == step
    mod = JaxPipelineBoringModel()
    for s in (0, 1):
        got = payload["pipeline_stage_states"][str(s)]["params"]
        stage_want = mod.pipeline_stage_params(want, s, 2)
        assert sorted(got) == sorted(stage_want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(stage_want)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-6, atol=1e-7)


def _run(tmpdir, model, batches, **kw):
    runner = PipelineRunner(model, num_microbatches=M, seed=0,
                            workdir=str(tmpdir), device="cpu", **kw)
    try:
        return runner.run(batches)
    finally:
        runner.shutdown()


def test_1f1b_matches_the_jax_baseline(tmpdir, batches, jax_weights,
                                       baseline):
    base_losses, base_params = baseline
    summary = _run(tmpdir, _model(jax_weights), batches, num_stages=2,
                   ckpt_every=4)
    np.testing.assert_allclose(summary["losses"], base_losses, rtol=1e-6)
    # the final per-stage params of the replay checkpoint
    _assert_checkpoint_params(tmpdir, base_params[-1], len(batches))

    # no kernel build after the first step (none at all on the CPU)
    compiles = [row["compiles"] for row in summary["steps"]]
    assert len(set(compiles[1:])) == 1, compiles

    # one trace id stitches the driver's rows and every stage's ticks
    report = json.load(open(os.path.join(str(tmpdir), "run_report.json")))
    assert report["error"] is None
    assert report["trace_id"] == summary["trace_id"]
    assert report["ranks"]["driver"]["trace_id"] == summary["trace_id"]
    pipe = report["extra"]["pipeline"]
    assert pipe["analytic_bubble_fraction"] == pytest.approx(1 / 5)
    assert pipe["stage_failure_budget_used"] == [0, 0]
    assert 0.0 <= pipe["measured_bubble_fraction"] < 1.0
    for rank in ("0", "1"):
        events = report["ranks"][rank]["events"]
        ticks = [e for e in events if e.get("kind") == "pipeline_tick"]
        assert ticks, f"rank {rank} recorded no pipeline ticks"
        assert all(t["trace"] == summary["trace_id"] for t in ticks)
        assert {t["data"]["step"] for t in ticks} >= {len(batches)}


def test_gpipe_matches_the_jax_baseline(tmpdir, batches, jax_weights,
                                        baseline):
    base_losses, base_params = baseline
    summary = _run(tmpdir, _model(jax_weights), batches[:2], num_stages=2,
                   schedule="gpipe")
    np.testing.assert_allclose(summary["losses"], base_losses[:2],
                               rtol=1e-6)
    assert summary["schedule"] == "gpipe"
    _assert_checkpoint_params(tmpdir, base_params[1], 2)


def test_two_lanes_match_the_jax_baseline(tmpdir, batches, jax_weights,
                                          baseline):
    """2 stages x 2 data-parallel lanes (4 workers): the lane-grad
    exchange sums in lane order, so the trajectory is still exact."""
    base_losses, base_params = baseline
    summary = _run(tmpdir, _model(jax_weights), batches[:2], num_stages=2,
                   num_workers=4)
    assert summary["num_lanes"] == 2
    np.testing.assert_allclose(summary["losses"], base_losses[:2],
                               rtol=1e-6)
    # lane 0's state, which every lane shares by the ordered lane sum
    _assert_checkpoint_params(tmpdir, base_params[1], 2)


def test_bf16_tree_survives_the_wire_bitwise():
    """bf16 has no numpy dtype: it crosses the store as its int16 words
    beside a tag, and comes back bit for bit, f32 and ints unchanged."""
    g = torch.Generator().manual_seed(0)
    tree = {"act": torch.randn(4, 64, 96, generator=g).to(torch.bfloat16),
            "grads": [torch.randn(300, 300, generator=g),
                      torch.randn(5, generator=g).to(torch.bfloat16)],
            "ids": torch.arange(12, dtype=torch.int32), "step": 3}
    wire = handoff.to_wire(tree)
    with ObjectStore(threshold=1024) as store:
        ref = store.put(wire)
        assert ref.segments  # the large leaves rode shared memory
        back = handoff.from_wire(store.get(ref, copy=False), "cpu")
        store.release(ref)
    assert back["step"] == 3
    for a, b in ((tree["act"], back["act"]),
                 (tree["grads"][0], back["grads"][0]),
                 (tree["grads"][1], back["grads"][1]),
                 (tree["ids"], back["ids"])):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b)
    # a received input owns its memory: it may be written in place
    back["act"].add_(1)


def test_a_remote_handoff_timeout_names_its_sender():
    """A worker's PipelineHandoffTimeout comes home as a RemoteError;
    the driver rebuilds it with its diagnosis, so attribution names the
    sender (stage 1), not the waiter (stage 0)."""
    exc = handoff.PipelineHandoffTimeout.for_wait(
        stage=0, kind="grad", src=1, microbatch=2, lane=0, step=3,
        timeout_s=2.0)
    remote = RemoteError(type(exc).__name__, str(exc), "Traceback ...")
    typed = _typed(remote)
    assert isinstance(typed, handoff.PipelineHandoffTimeout)
    assert typed.diagnosis["src"] == 1 and typed.diagnosis["step"] == 3
    other = RemoteError("ValueError", "boom", "Traceback ...")
    assert _typed(other) is other


class TestRefusals:
    def test_single_stage_refused(self, tmpdir):
        with pytest.raises(PipelineConfigError, match="pipeline_stages"):
            PipelineRunner(PipelineBoringModel(), num_stages=1,
                           workdir=str(tmpdir), device="cpu")

    def test_workers_not_multiple_of_stages(self, tmpdir):
        with pytest.raises(PipelineConfigError, match="multiple"):
            PipelineRunner(PipelineBoringModel(), num_stages=2,
                           num_workers=3, workdir=str(tmpdir), device="cpu")

    def test_microbatches_not_divisible_by_lanes(self, tmpdir):
        with pytest.raises(PipelineConfigError, match="microbatch"):
            PipelineRunner(PipelineBoringModel(), num_stages=2,
                           num_workers=6, num_microbatches=4,
                           workdir=str(tmpdir), device="cpu")

    def test_module_without_stage_hooks_refused(self, tmpdir):
        with pytest.raises(PipelineConfigError, match="pipeline_stage"):
            PipelineRunner(BoringModel(), num_stages=2,
                           workdir=str(tmpdir), device="cpu")

    def test_indivisible_layer_count_refused(self, tmpdir):
        # 4 layers over 3 stages: the module's own ValueError surfaces
        # as a config refusal, not a worker-side crash
        with pytest.raises(PipelineConfigError, match="divide"):
            PipelineRunner(PipelineBoringModel(), num_stages=3,
                           workdir=str(tmpdir),
                           device="cpu")._stage_parameters()

    def test_the_watchdog_names_its_slice(self, tmpdir):
        with pytest.raises(NotImplementedError, match="runtime"):
            PipelineRunner(PipelineBoringModel(), num_stages=2,
                           wedge_timeout_s=4.0, workdir=str(tmpdir),
                           device="cpu")


class TestTrainerWiring:
    def test_fit_routes_through_pipeline_runner(self, tmpdir, batches,
                                                jax_weights, baseline):
        base_losses, _ = baseline
        trainer = Trainer(device="cpu", precision="f32", max_steps=2,
                          default_root_dir=str(tmpdir), pipeline_stages=2,
                          pipeline_microbatches=M,
                          enable_checkpointing=False, seed=0)
        trainer.fit(_model(jax_weights), train_dataloaders=batches)
        assert trainer.global_step == 2
        np.testing.assert_allclose(
            trainer.pipeline_summary["losses"], base_losses[:2], rtol=1e-6)
        assert trainer.callback_metrics["train_loss"] == pytest.approx(
            base_losses[1], rel=1e-6)
        assert trainer.trace_id == trainer.pipeline_summary["trace_id"]

    def test_ctor_refusals(self):
        with pytest.raises(ValueError, match="pipeline_schedule"):
            Trainer(device="cpu", pipeline_stages=2,
                    pipeline_schedule="zigzag")
        with pytest.raises(ValueError, match="pipeline_stages"):
            Trainer(device="cpu", pipeline_stages=0)
        with pytest.raises(ValueError, match="pipeline_microbatches"):
            Trainer(device="cpu", pipeline_stages=2,
                    pipeline_microbatches=0)
        with pytest.raises(ValueError, match="grad_compression"):
            Trainer(device="cpu", pipeline_stages=2,
                    grad_compression="int8")
        with pytest.raises(ValueError, match="ZeRO-1"):
            Trainer(device="cpu", pipeline_stages=2,
                    shard_optimizer_state=True)
        with pytest.raises(ValueError, match="accumulate"):
            Trainer(device="cpu", pipeline_stages=2,
                    accumulate_grad_batches=2)

    def test_ckpt_path_refused(self, tmpdir):
        trainer = Trainer(device="cpu", max_steps=1,
                          default_root_dir=str(tmpdir), pipeline_stages=2)
        with pytest.raises(ValueError, match="ckpt_path"):
            trainer.fit(PipelineBoringModel(), train_dataloaders=[],
                        ckpt_path="last.ckpt")
