"""FSDP inside an MPMD stage (``PipelineRunner(fsdp=2)``) against the
JAX package's one-process baseline with the stage params placed as the
JAX stage places them (``plan_lib.fsdp_leaf_spec`` on a 2-device mesh):
1F1B and GPipe over 2 stages x 2 fsdp workers (and 2 lanes of them) on
the CPU reproduce the JAX trajectory (rtol 1e-6, f32), each member
owning half of each split leaf; a crash of one stage-1 member replays
to the clean trajectory; a checkpoint written at ``fsdp=2`` restores at
``fsdp=1``; a microbatch the group cannot split is refused before any
worker starts.

``PipelineBoringModel(dim=64, hidden=128)`` on both sides: at the
default dim 8 / hidden 16 no leaf reaches ``FSDP_MIN_LEAF_SIZE`` (4096)
and nothing would be split."""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from ray_lightning_accelerators_tpu import MeshConfig as JaxMeshConfig
from ray_lightning_accelerators_tpu.parallel import mesh as jax_mesh
from ray_lightning_accelerators_tpu.parallel import plan as jax_plan
from ray_lightning_accelerators_tpu_torch.parallel.mpmd import (
    stage as stage_lib)
from ray_lightning_accelerators_tpu_torch.parallel.mpmd.driver import (
    PipelineRunner)
from ray_lightning_accelerators_tpu_torch.telemetry import recorder
from ray_lightning_accelerators_tpu_torch.utils import checkpoint as ckpt_lib
from tests.torch_boring import FaultyPipelineModel, PipelineBoringModel
from tests.utils import PipelineBoringModel as JaxPipelineBoringModel

pytestmark = pytest.mark.pipeline_mpmd

M = 4
DIMS = dict(dim=64, hidden=128)


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(0)
    return [rng.standard_normal((16, 64)).astype(np.float32)
            for _ in range(4)]


@pytest.fixture(scope="module")
def jax_weights():
    return jax.device_get(JaxPipelineBoringModel(**DIMS).init_params(
        jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def jax_mesh2():
    return jax_mesh.build_mesh(JaxMeshConfig(data=1, fsdp=2),
                               devices=jax.devices()[:2])


def _jax_spec(mesh, leaf):
    spec = jax_plan.fsdp_leaf_spec(mesh, leaf)
    return jax_plan.replicated_spec() if spec is None else spec


@pytest.fixture(scope="module")
def baseline(batches, jax_weights, jax_mesh2):
    """The JAX one-process reference with the params placed over the
    2-device fsdp mesh, as the JAX stage places them
    (``parallel/mpmd/stage.py``): the same microbatch split, the
    accumulated mean gradient, one optax apply per batch.  Returns the
    losses and the params after each step."""
    mod = JaxPipelineBoringModel(**DIMS)
    params = jax.tree.map(
        lambda a: jax.device_put(jnp.asarray(a), jax.sharding.NamedSharding(
            jax_mesh2, _jax_spec(jax_mesh2, a))), jax_weights)
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


def _stage_params(tree, stage):
    return JaxPipelineBoringModel(**DIMS).pipeline_stage_params(tree, stage,
                                                                2)


def _assert_checkpoint_params(workdir, want, step):
    """The latest replay checkpoint is step ``step`` and holds each
    stage's whole params (the ``fsdp=1`` layout), ``want``'s."""
    payload = ckpt_lib.read_checkpoint(
        ckpt_lib.latest_checkpoint(os.path.join(str(workdir), "ckpt")))
    assert payload["global_step"] == step
    for s in (0, 1):
        got = payload["pipeline_stage_states"][str(s)]["params"]
        stage_want = _stage_params(want, s)
        assert sorted(got) == sorted(stage_want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(stage_want)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-6, atol=1e-7)


def _runner(workdir, model, **kw):
    return PipelineRunner(model, num_stages=2, num_microbatches=M, seed=0,
                          workdir=str(workdir), device="cpu", **kw)


def _run(runner, batches):
    try:
        return runner.run(batches)
    finally:
        runner.shutdown()


@pytest.mark.parametrize("schedule,steps", [("1f1b", 4), ("gpipe", 2)])
def test_fsdp_stages_match_the_jax_fsdp_baseline(tmpdir, batches,
                                                 jax_weights, jax_mesh2,
                                                 baseline, schedule, steps):
    """2 stages x ``fsdp=2`` (4 workers, 2 gloo groups): the losses and
    the checkpointed whole params within rtol 1e-6 of the JAX fsdp
    baseline.  Each member owns half of each leaf the JAX stage splits
    (the layers' kernels, 8192 to 16384 elements) and the whole of the
    others (the biases), and the owned bytes sum to the stage's over its
    two members.  The rows of each microbatch are split over the group,
    and the group's loss is the whole microbatch's."""
    base_losses, base_params = baseline
    runner = _runner(tmpdir, PipelineBoringModel(weights=jax_weights,
                                                 **DIMS),
                     schedule=schedule, fsdp=2)
    summary = _run(runner, batches[:steps])
    np.testing.assert_allclose(summary["losses"], base_losses[:steps],
                               rtol=1e-6)
    _assert_checkpoint_params(tmpdir, base_params[steps - 1], steps)
    assert summary["fsdp"] == 2 and summary["fsdp_backend"] == "gloo"
    assert summary["schedule"] == schedule
    for row in summary["steps"]:
        assert row["fsdp_collective_s"] > 0.0
        assert sorted(row["per_stage"]) == ["0/0/0", "0/0/1", "1/0/0",
                                            "1/0/1"]
    # the owned slices, rank ((stage * lanes) + lane) * fsdp + j
    assert len(runner.owned_shapes) == 4
    for rank, shapes in enumerate(runner.owned_shapes):
        stage = rank // 2
        whole = jax.tree.leaves(_stage_params(jax_weights, stage))
        assert len(shapes) == len(whole)
        for leaf, got in zip(whole, shapes):
            spec = tuple(_jax_spec(jax_mesh2, leaf))
            want = [n // 2 if i < len(spec) and spec[i] == "fsdp" else n
                    for i, n in enumerate(leaf.shape)]
            assert got == want
            assert (want != list(leaf.shape)) == (leaf.size >= 4096)
        stage_bytes = sum(leaf.nbytes for leaf in whole)
        split_bytes = sum(leaf.nbytes for leaf in whole if leaf.size >= 4096)
        assert runner.owned_param_bytes[rank] == stage_bytes - \
            split_bytes // 2
    # the port's dims are the JAX placement's
    for s in (0, 1):
        leaves = jax.tree.leaves(_stage_params(jax_weights, s))
        dims = stage_lib.fsdp_dims([np.asarray(a) for a in leaves], 2)
        assert dims == [tuple(_jax_spec(jax_mesh2, a)).index("fsdp")
                        if "fsdp" in tuple(_jax_spec(jax_mesh2, a))
                        else None for a in leaves]


def test_two_lanes_of_fsdp_groups_match_the_jax_fsdp_baseline(
        tmpdir, batches, jax_weights, baseline):
    """2 stages x 2 lanes x ``fsdp=2`` (8 workers, 4 gloo groups): the
    lanes sum the owned slices of the members of one fsdp rank, so the
    trajectory is still the JAX fsdp baseline's (rtol 1e-6), and lane 0's
    checkpoint holds the whole stage."""
    base_losses, base_params = baseline
    runner = _runner(tmpdir, PipelineBoringModel(weights=jax_weights,
                                                 **DIMS),
                     fsdp=2, num_workers=4)
    summary = _run(runner, batches[:2])
    assert summary["num_lanes"] == 2
    np.testing.assert_allclose(summary["losses"], base_losses[:2],
                               rtol=1e-6)
    _assert_checkpoint_params(tmpdir, base_params[1], 2)
    assert sorted(summary["steps"][0]["per_stage"]) == [
        f"{s}/{lane}/{j}" for s in (0, 1) for lane in (0, 1)
        for j in (0, 1)]


@pytest.fixture
def own_recorder():
    """The driver's flight recorder is the process's: every runner run in
    this test process leaves its events in its ring, and a run report
    holds the whole ring.  The replay this test causes is dropped with a
    fresh recorder afterwards, so a later test in the same process (the
    chaos tests count their replay events) reads only its own."""
    yield
    recorder.configure()


def test_crash_of_one_fsdp_member_replays_to_the_clean_trajectory(
        tmpdir, batches, jax_weights, baseline, own_recorder):
    """One stage-1 member's process ends at step 2 (its fsdp peer is left
    inside the group's collectives): stage 1 is charged, every worker
    restarts, both groups meet again on fresh ports, and the replay from
    the step-1 checkpoint reproduces the clean trajectory (rtol 1e-6)."""
    base_losses, _ = baseline
    claims = os.path.join(str(tmpdir), "claims")
    os.makedirs(claims)
    model = FaultyPipelineModel("crash", stage=1, step=2, claim_dir=claims,
                                weights=jax_weights, **DIMS)
    summary = _run(_runner(tmpdir, model, fsdp=2), batches[:3])
    assert summary["replays"] == 1
    assert summary["stage_failure_budget_used"] == [0, 1]
    np.testing.assert_allclose(summary["losses"], base_losses[:3],
                               rtol=1e-6)
    report = json.load(open(os.path.join(str(tmpdir), "run_report.json")))
    assert report["error"] is None


def test_checkpoint_written_at_fsdp2_resumes_at_fsdp1(tmpdir, batches,
                                                      jax_weights, baseline):
    """Two steps at ``fsdp=2`` write their checkpoints in the ``fsdp=1``
    layout; a runner at ``fsdp=1`` given the step-2 one takes it through
    its replay path and trains steps 3 and 4 onto the JAX trajectory
    (rtol 1e-6)."""
    base_losses, base_params = baseline
    model = PipelineBoringModel(weights=jax_weights, **DIMS)
    first, second = tmpdir.join("fsdp2"), tmpdir.join("fsdp1")
    _run(_runner(first, model, fsdp=2), batches[:2])
    saved = ckpt_lib.latest_checkpoint(os.path.join(str(first), "ckpt"))
    assert ckpt_lib.read_checkpoint(saved)["global_step"] == 2
    runner = _runner(second, model, fsdp=1)
    try:
        runner.setup()      # writes its own step-0 checkpoint
        shutil.copy(saved, os.path.join(str(second), "ckpt"))
        runner._recover()   # the newest verified checkpoint: step 2
        summary = runner.run(batches)
    finally:
        runner.shutdown()
    np.testing.assert_allclose(summary["losses"], base_losses[2:],
                               rtol=1e-6)
    _assert_checkpoint_params(second, base_params[3], 4)


def test_rows_the_group_cannot_split_are_refused(tmpdir, batches):
    """4 microbatches of 3 rows cannot split over 2 members: the runner
    raises ``ValueError`` before it spawns a worker."""
    runner = _runner(tmpdir, PipelineBoringModel(**DIMS), fsdp=2)
    with pytest.raises(ValueError, match="does not split over the fsdp "
                                         "group of 2 workers"):
        runner.run([batches[0][:12]])
    assert runner.pool is None
