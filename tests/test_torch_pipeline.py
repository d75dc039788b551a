"""The SPMD pipeline axis (parallel/pipeline.py) over gloo ranks on the
CPU, against the JAX package on tests/conftest.py's 8 CPU devices:

- ``pipeline_apply`` against the sequential stack, forward and
  gradients, at (stages, microbatches) = (2, 4), (4, 2), (4, 8), as
  tests/test_pipeline.py;
- the GPT at ``pipeline=2``, ``data=2 x pipeline=2`` and
  ``RayTPUAccelerator(2, use_fsdp=True, pipeline=2)`` against the JAX
  Trainer on the same mesh: loss, grad norm and final params, each rank
  holding its stage's layers;
- the refusals: MoE and dropout (the JAX GPT's texts), a batch the
  microbatches do not divide, a layer count the stages do not divide,
  and the composition with the sequence axis (a reference caveat).

Two worlds (2 and 4 ranks) serve the module; rank bodies come from
tests/torch_boring.py (no JAX)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_lightning_accelerators_tpu import RayTPUAccelerator as JaxRayTPU
from ray_lightning_accelerators_tpu import Trainer as JaxTrainer
from ray_lightning_accelerators_tpu.data.loader import (
    ArrayDataset as JaxArrayDataset, DataLoader as JaxDataLoader)
from ray_lightning_accelerators_tpu.models.transformer import (
    GPT as JaxGPT, TransformerConfig as JaxConfig)
from ray_lightning_accelerators_tpu_torch import (DataLoader,
                                                  RayTPUAccelerator, Trainer)
from ray_lightning_accelerators_tpu_torch.data.loader import ArrayDataset
from ray_lightning_accelerators_tpu_torch.models.transformer import (
    GPT, TransformerConfig)
from ray_lightning_accelerators_tpu_torch.parallel import mesh as mesh_lib
from ray_lightning_accelerators_tpu_torch.parallel import (
    pipeline as pipeline_lib)
from ray_lightning_accelerators_tpu_torch.runtime import bootstrap
from ray_lightning_accelerators_tpu_torch.runtime.bootstrap import (
    DistributedWorld)
from ray_lightning_accelerators_tpu_torch.utils.weights import (
    params_from_jax)

from . import torch_boring

pytestmark = pytest.mark.fsdp
torch.backends.cuda.matmul.allow_tf32 = False

VOCAB, SEQ = 256, 32
CFG = dict(vocab_size=VOCAB, d_model=64, n_heads=4, d_ff=128, n_layers=2,
           max_seq_len=SEQ, loss_chunk_rows=64, pipeline_microbatches=2)
COMMON = dict(max_epochs=1, precision="f32", log_every_n_steps=1,
              gradient_clip_val=0.5, log_grad_norm=True,
              enable_checkpointing=False, seed=0)


def _world(n):
    saved = bootstrap.DEFAULT_TIMEOUT_S
    bootstrap.DEFAULT_TIMEOUT_S = 60.0
    w = DistributedWorld(n, devices=["cpu"] * n, timeout_s=60.0)
    try:
        yield w
    finally:
        w.shutdown()
        bootstrap.DEFAULT_TIMEOUT_S = saved


@pytest.fixture(scope="module")
def world2():
    yield from _world(2)


@pytest.fixture(scope="module")
def world4():
    yield from _world(4)


def _tokens(n, seed=0):
    starts = np.random.default_rng(seed).integers(0, VOCAB, n)
    return ((starts[:, None] + np.arange(SEQ)[None]) % VOCAB).astype(np.int32)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree.detach().cpu().numpy()
                               if isinstance(tree, torch.Tensor) else tree)}


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _history(trainer, key):
    return [r[key] for r in trainer.logger.history if key in r]


DATA = _tokens(24, seed=5)


# --------------------------------------------------------------------- #
# pipeline_apply                                                         #
# --------------------------------------------------------------------- #
def _layers_params(n_layers=4, d=16, seed=0):
    """tests/test_pipeline.py's stack, from numpy."""
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((n_layers, d, d)) * 0.3)
            .astype(np.float32),
            "b": (rng.standard_normal((n_layers, d)) * 0.1)
            .astype(np.float32)}


def _jax_stage(params, x):
    def one(carry, lp):
        return jnp.tanh(carry @ lp["w"] + lp["b"]), None

    out, _ = jax.lax.scan(one, x, params)
    return out


@pytest.mark.parametrize("stages,microbatches", [(2, 4), (4, 2), (4, 8)])
def test_pipeline_matches_sequential(world4, stages, microbatches):
    """The GPipe schedule over ``stages`` ranks (a data axis of the rest:
    its rows are the same) equals the sequential stack forward to 1e-5
    and in the gradients of ``sum(out**2)`` to 1e-4, as
    tests/test_pipeline.py bounds the JAX schedule (measured on an x86
    CPU: 3.0e-7 and 2.9e-6 absolute at most); each stage's gradients are
    its own layers', and the activations hop ``M + S - 2`` times a step
    each way."""
    params = _layers_params()
    x = np.random.default_rng(1).standard_normal((16, 16)).astype(
        np.float32)
    jp = jax.tree.map(jnp.asarray, params)
    ref = np.asarray(_jax_stage(jp, jnp.asarray(x)))
    grads = jax.grad(lambda p: jnp.sum(_jax_stage(p, jnp.asarray(x))
                                       ** 2))(jp)
    shape = {"data": 4 // stages, "pipeline": stages}
    ranks = world4.run(functools.partial(
        torch_boring.pipeline_body, params=params, x=x, shape=shape,
        microbatches=microbatches))
    per = 4 // stages
    for r in ranks:
        np.testing.assert_allclose(r["out"], ref, atol=1e-5, rtol=1e-5)
        s = r["stage"]
        for k in ("w", "b"):
            np.testing.assert_allclose(
                r[f"d{k}"], np.asarray(grads[k])[s * per:(s + 1) * per],
                atol=1e-4, rtol=1e-4)
        hops = r["comms"]["counts"]["ppermute"]
        assert hops == 2 * (microbatches + stages - 2)
        # the last stage's buffer broadcast by a masked all-reduce
        assert r["comms"]["counts"]["g_all_reduce"] == 1


# --------------------------------------------------------------------- #
# the GPT over the pipeline axis                                         #
# --------------------------------------------------------------------- #
MESHES = {"pp2": ((1, {}), "world2"),
          "dp2_pp2_remat": ((2, {}), "world4"),
          "fsdp2_pp2": ((2, dict(use_fsdp=True)), "world4")}


@pytest.mark.parametrize("axes", sorted(MESHES))
def test_gpt_pipeline_fit_matches_jax_trainer(request, tmp_path, axes):
    """6 steps (24 shuffled rows, global batch 4, 2 microbatches,
    clipping at 0.5) at ``pipeline=2`` alone, with ``data=2`` (and remat,
    which runs inside the stage) and with fsdp 2, against the JAX Trainer
    on the same mesh: the loss and the
    global grad norm within 1e-4 relative at every step and the final
    params within 1e-3 relative L2 per leaf (measured on an x86 CPU over
    the three meshes: loss 2.7e-7, norm 7.5e-7, params 3.9e-6).  Each
    rank holds its stage's layer (``[L/2, ...]``, under fsdp its half of
    d_model too); the pipeline-replicated leaves (the embedding, the
    final norm) stay bitwise equal across the stages; the fitted module
    gets the whole stack.  At ``pipeline=2`` ``validate`` over the stages
    then equals the JAX Trainer's to 1e-4 (measured 1.2e-6)."""
    (dp, kw), world_name = MESHES[axes]
    world = request.getfixturevalue(world_name)
    cfg = dict(CFG, remat=axes.endswith("remat"))
    init = jax.device_get(JaxGPT(JaxConfig(**cfg)).init_params(
        jax.random.PRNGKey(0)))
    jm = JaxGPT(JaxConfig(**cfg), lr=3e-3)
    jm.params = jax.tree.map(jnp.asarray, init)
    jt = JaxTrainer(accelerator=JaxRayTPU(dp, pipeline=2, **kw), guard=None,
                    prefetch_batches=0, cache_dataset_on_device=False,
                    default_root_dir=str(tmp_path / "jax"), **COMMON)
    jt.fit(jm, JaxDataLoader(JaxArrayDataset(DATA), batch_size=4,
                             shuffle=True, use_native=False))
    tm = GPT(TransformerConfig(**cfg), device="cpu", lr=3e-3)
    tm.params = params_from_jax(init, device="cpu")
    tt = Trainer(device="cpu",
                 accelerator=RayTPUAccelerator(dp, pipeline=2, **kw),
                 default_root_dir=str(tmp_path / "port"), **COMMON)
    tt._world = world
    tt.fit(tm, DataLoader(ArrayDataset(DATA), batch_size=4, shuffle=True))
    tt._world = None
    for key in ("train_loss", "grad_norm"):
        jh, th = _history(jt, key), _history(tt, key)
        assert len(th) == len(jh) == 6, key
        for a, b in zip(th, jh):
            assert a == pytest.approx(b, rel=1e-4), key
    jp, tp = _flat(jax.device_get(jm.params)), _flat(tm.params)
    assert jp.keys() == tp.keys()
    for name in jp:
        assert tp[name].shape == jp[name].shape, name
        assert _rel_l2(tp[name], jp[name]) <= 1e-3, name
    rep = tt.rank_report
    assert rep["plan"] == jt._plan.describe()
    d = 64 // (2 if kw else 1)
    assert rep["state_shapes"]["params/layers/attn/wq"] == [1, d, 4, 16]
    assert rep["state_shapes"]["params/layers/ln1"] == [1, 64]
    assert rep["state_shapes"]["params/ln_f"] == [64]
    assert rep["replicated_bitwise_equal"] is True
    comms = rep["model_comms"]["counts"]
    # per step, each way: M + S - 2 hops of the activations
    assert comms["ppermute"] == 6 * 2 * (2 + 2 - 2)
    if axes == "pp2":
        val = _tokens(8, seed=9)
        (jv,) = jt.validate(jm, JaxDataLoader(
            JaxArrayDataset(val), batch_size=4, use_native=False))
        tt._world = world
        (tv,) = tt.validate(tm, DataLoader(ArrayDataset(val), batch_size=4))
        tt._world = None
        assert jv.keys() == tv.keys()
        for k in jv:
            assert tv[k] == pytest.approx(float(jv[k]), rel=1e-4), k


# --------------------------------------------------------------------- #
# refusals                                                               #
# --------------------------------------------------------------------- #
def _pipeline_mesh():
    """A rank's mesh at pipeline = 2, without groups: the refusals fire
    before any collective."""
    shape = {a: 1 for a in mesh_lib.AXIS_ORDER}
    shape["pipeline"] = 2
    return mesh_lib.RankMesh(shape, rank=0, coords={
        a: 0 for a in mesh_lib.AXIS_ORDER})


def _jax_refusal(cfg, dropout_rng=None):
    mesh = JaxRayTPU(1, pipeline=2).build_mesh()
    model = JaxGPT(JaxConfig(**cfg))
    model.mesh = mesh
    params = model.init_params(jax.random.PRNGKey(0))
    with pytest.raises(NotImplementedError) as e:
        model.forward(params, jnp.asarray(DATA[:4]),
                      dropout_rng=dropout_rng)
    return str(e.value)


@pytest.mark.parametrize("case", ["moe", "dropout"])
def test_gpt_refuses_moe_and_dropout_under_pipeline(case, tmp_path):
    """MoE layers and dropout under the pipeline axis raise the JAX GPT's
    ``NotImplementedError``, text for text: in the forward, and from the
    Trainer before any rank starts."""
    cfg = (dict(CFG, num_experts=4) if case == "moe"
           else dict(CFG, dropout=0.1))
    key = jax.random.PRNGKey(1) if case == "dropout" else None
    want = _jax_refusal(cfg, key)
    model = GPT(TransformerConfig(**cfg), device="cpu", mesh=_pipeline_mesh())
    params = model.init_params(0)
    with pytest.raises(NotImplementedError) as e:
        model.forward(params, torch.from_numpy(DATA[:4]),
                      dropout_rng=torch.Generator().manual_seed(0)
                      if case == "dropout" else None)
    assert str(e.value) == want
    t = Trainer(device="cpu", accelerator=RayTPUAccelerator(1, pipeline=2),
                default_root_dir=str(tmp_path), **COMMON)
    with pytest.raises(NotImplementedError) as e:
        t.fit(GPT(TransformerConfig(**cfg), device="cpu"),
              DataLoader(ArrayDataset(DATA), batch_size=4))
    assert str(e.value) == want
    assert t._world is None


def test_pipeline_refuses_indivisible_batch_and_layers(tmp_path):
    """A batch the microbatches do not divide and a layer count the
    stages do not divide raise the JAX ``pipeline_apply``'s
    ``ValueError``s (the second from the Trainer, before any rank
    starts)."""
    with pytest.raises(ValueError, match=r"batch 6 % microbatches 4 != 0"):
        pipeline_lib.pipeline_apply(torch_boring._tanh_stage, {},
                                    torch.zeros(6, 16), _pipeline_mesh(), 4)
    t = Trainer(device="cpu", accelerator=RayTPUAccelerator(1, pipeline=2),
                default_root_dir=str(tmp_path), **COMMON)
    with pytest.raises(ValueError, match="layer count 3 not divisible by 2 "
                       "pipeline stages"):
        t.fit(GPT(TransformerConfig(**dict(CFG, n_layers=3)), device="cpu"),
              DataLoader(ArrayDataset(DATA), batch_size=4))


@pytest.mark.parametrize("kwargs", [
    dict(accelerator=RayTPUAccelerator(1, pipeline=2, sequence=2,
                                       tensor=2)),
    dict(accelerator=RayTPUAccelerator(1, pipeline=2, sequence=2,
                                       expert=2)),
    dict(accelerator=RayTPUAccelerator(1, pipeline=2), seq_parallel=2),
])
def test_pipeline_with_a_model_axis_is_refused(kwargs):
    """The pipeline axis composes with every axis but the sequence axis
    (also when ``seq_parallel`` injects it, and beside the tensor or
    expert axis): the refusal names the reference caveat, since the JAX
    package's GPT raises on that mesh."""
    with pytest.raises(NotImplementedError,
                       match="the JAX package's GPT raises on this mesh"):
        Trainer(device="cpu", **kwargs)
