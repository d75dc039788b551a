"""The SPMD pipeline axis with a model axis, and the modules that run no
pipeline schedule under it, over gloo ranks on the CPU, against the JAX
``Trainer`` on the same mesh of tests/conftest.py's CPU devices:

- the GPT at ``pipeline=2 x tensor=2`` and ``pipeline=2 x expert=2``
  (dense): loss and grad norm at every step, final params, the plan and
  the state shapes, the replicas bitwise equal over every group that
  does not split a leaf;
- ViT at ``pipeline=2`` and ``pipeline=2 x tensor=2``, and the MNIST MLP
  at ``pipeline=2``: every stage runs the whole forward on the same rows,
  ViT's layer stack stored split over the stages;
- a sharded checkpoint of the 4 ranks at ``pipeline=2 x tensor=2``
  (each layer part a rectangle on two dims), restored into one process
  bit for bit, and the pickle gather;
- without ranks, the port's plan at ``fsdp=2 x pipeline=2 x tensor=2``
  and ``data=2 x pipeline=2 x tensor=2`` against the JAX plan's.

Two worlds (2 and 4 ranks) serve the module."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ray_lightning_accelerators_tpu import Accelerator as JaxAccelerator
from ray_lightning_accelerators_tpu import MeshConfig as JaxMeshConfig
from ray_lightning_accelerators_tpu import RayTPUAccelerator as JaxRayTPU
from ray_lightning_accelerators_tpu import Trainer as JaxTrainer
from ray_lightning_accelerators_tpu.core.state import TrainState as JaxState
from ray_lightning_accelerators_tpu.data.loader import (
    ArrayDataset as JaxArrayDataset, DataLoader as JaxDataLoader)
from ray_lightning_accelerators_tpu.models.mnist import (
    MNISTClassifier as JaxMNIST, synthetic_mnist as jax_synthetic_mnist)
from ray_lightning_accelerators_tpu.models.transformer import (
    GPT as JaxGPT, TransformerConfig as JaxConfig)
from ray_lightning_accelerators_tpu.models.vit import (
    ViT as JaxViT, ViTConfig as JaxViTConfig)
from ray_lightning_accelerators_tpu.parallel import mesh as jax_mesh
from ray_lightning_accelerators_tpu.parallel import plan as jax_plan
from ray_lightning_accelerators_tpu_torch import (Accelerator, DataLoader,
                                                  MeshConfig,
                                                  RayTPUAccelerator, Trainer)
from ray_lightning_accelerators_tpu_torch.core.optim import state_layouts
from ray_lightning_accelerators_tpu_torch.data.loader import ArrayDataset
from ray_lightning_accelerators_tpu_torch.models.mnist import MNISTClassifier
from ray_lightning_accelerators_tpu_torch.models.resnet import (
    synthetic_cifar10)
from ray_lightning_accelerators_tpu_torch.models.transformer import (
    GPT, TransformerConfig)
from ray_lightning_accelerators_tpu_torch.models.vit import ViT, ViTConfig
from ray_lightning_accelerators_tpu_torch.parallel import mesh as mesh_lib
from ray_lightning_accelerators_tpu_torch.parallel import plan as plan_lib
from ray_lightning_accelerators_tpu_torch.runtime import bootstrap
from ray_lightning_accelerators_tpu_torch.runtime.bootstrap import (
    DistributedWorld)
from ray_lightning_accelerators_tpu_torch.utils import checkpoint as ckpt_lib
from ray_lightning_accelerators_tpu_torch.utils import (
    sharded_checkpoint as sc)
from ray_lightning_accelerators_tpu_torch.utils.weights import (
    params_from_jax)

pytestmark = pytest.mark.fsdp
torch.backends.cuda.matmul.allow_tf32 = False

VOCAB, SEQ = 256, 32
CFG = dict(vocab_size=VOCAB, d_model=64, n_heads=4, d_ff=128, n_layers=2,
           max_seq_len=SEQ, loss_chunk_rows=64, pipeline_microbatches=2)
VIT_CFG = dict(image_size=16, patch_size=4, channels=3, d_model=32,
               n_heads=4, d_ff=64, n_layers=2, n_classes=10)
MNIST_CFG = {"layer_1": 64, "layer_2": 64, "lr": 1e-3, "batch_size": 16}
COMMON = dict(max_epochs=1, precision="f32", log_every_n_steps=1,
              gradient_clip_val=0.5, log_grad_norm=True,
              enable_checkpointing=False, seed=0)
JAX_ONLY = dict(guard=None, prefetch_batches=0,
                cache_dataset_on_device=False)


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


def _fit_both(tmp_path, world, jax_module, port_module, jax_acc, port_acc,
              arrays, batch_size, **kw):
    """The JAX Trainer and the port's over ``world`` on the same weights
    and shuffled rows."""
    jt = JaxTrainer(accelerator=jax_acc, default_root_dir=str(
        tmp_path / "jax"), **JAX_ONLY, **{**COMMON, **kw})
    jt.fit(jax_module, JaxDataLoader(JaxArrayDataset(*arrays),
                                     batch_size=batch_size, shuffle=True,
                                     use_native=False))
    tt = Trainer(device="cpu", accelerator=port_acc,
                 default_root_dir=str(tmp_path / "port"), **{**COMMON, **kw})
    tt._world = world
    tt.fit(port_module, DataLoader(ArrayDataset(*arrays),
                                   batch_size=batch_size, shuffle=True))
    tt._world = None    # the module's fixture ends the world
    return jt, tt


def _assert_trajectories(jt, jm, tt, tm, steps,
                         keys=("train_loss", "grad_norm")):
    """Every step's loss and global grad norm within 1e-4 relative, the
    final params within 1e-3 relative L2 per leaf, the plan JAX's."""
    for key in keys:
        jh, th = _history(jt, key), _history(tt, key)
        assert len(th) == len(jh) == steps, key
        for a, b in zip(th, jh):
            assert a == pytest.approx(b, rel=1e-4), key
    jp, tp = _flat(jax.device_get(jm.params)), _flat(tm.params)
    assert jp.keys() == tp.keys()
    for name in jp:
        assert tp[name].shape == jp[name].shape, name
        assert _rel_l2(tp[name], jp[name]) <= 1e-3, name
    assert tt.rank_report["plan"] == jt._plan.describe()


def _gpt_init(cfg=CFG):
    return jax.device_get(JaxGPT(JaxConfig(**cfg)).init_params(
        jax.random.PRNGKey(0)))


def _gpt_pair(cfg=CFG):
    init = _gpt_init(cfg)
    jm = JaxGPT(JaxConfig(**cfg), lr=3e-3)
    jm.params = jax.tree.map(jnp.asarray, init)
    tm = GPT(TransformerConfig(**cfg), device="cpu", lr=3e-3)
    tm.params = params_from_jax(init, device="cpu")
    return jm, tm


# --------------------------------------------------------------------- #
# the GPT's schedule with a model axis                                   #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("axis", ["tensor", "expert"])
def test_gpt_pipeline_with_a_model_axis_matches_jax_trainer(world4,
                                                            tmp_path, axis):
    """6 steps (24 shuffled rows, global batch 4, 2 microbatches,
    clipping at 0.5) at ``pipeline=2 x tensor=2`` and at ``pipeline=2 x
    expert=2`` on the dense GPT, against the JAX Trainer on the same
    mesh: the loss and the global grad norm within 1e-4 relative at
    every step, the final params within 1e-3 relative L2 per leaf
    (measured on an x86 CPU over both meshes: loss 3.6e-7, norm 1.3e-6,
    params 6.1e-6).  The stage body runs the tensor group's *f* / *g*
    in every tick, the hops pair within each tensor (or expert)
    coordinate's pipeline group, and the vocab-parallel loss runs on
    every stage.  Under tensor each rank holds its stage's layer and its
    heads (``wq`` ``[L/2, d, H/2, hd]``), the embedding its vocabulary
    rows; every leaf is bitwise equal over each group that does not
    split it (the stages' parts summed, the expert replicas averaged)."""
    jm, tm = _gpt_pair()
    jt, tt = _fit_both(tmp_path, world4, jm, tm,
                       JaxRayTPU(1, pipeline=2, **{axis: 2}),
                       RayTPUAccelerator(1, pipeline=2, **{axis: 2}),
                       (DATA,), 4)
    _assert_trajectories(jt, jm, tt, tm, steps=6)
    rep = tt.rank_report
    shapes = rep["state_shapes"]
    heads = 2 if axis == "tensor" else 4
    assert shapes["params/layers/attn/wq"] == [1, 64, heads, 16]
    assert shapes["opt/adam/mu/layers/mlp/wi"] == [
        1, 64, 64 if axis == "tensor" else 128]
    assert shapes["params/embed"] == [VOCAB // (2 if axis == "tensor"
                                                else 1), 64]
    assert shapes["params/ln_f"] == [64]
    assert rep["replicated_bitwise_equal"] is True
    comms = rep["model_comms"]["counts"]
    # per step, each way: M + S - 2 hops within the pipeline group
    assert comms["ppermute"] == 6 * 2 * (2 + 2 - 2)
    groups = rep["mesh_groups"]
    assert groups["pipeline"][0] == [0, 2]
    assert groups[axis][0] == [0, 1]


# --------------------------------------------------------------------- #
# modules without a pipeline schedule                                    #
# --------------------------------------------------------------------- #
def _vit_data():
    x, y = synthetic_cifar10(40, 1)
    return np.ascontiguousarray(x[:, 8:24, 8:24]), y


@pytest.mark.parametrize("tensor", [1, 2])
def test_vit_under_the_pipeline_axis_matches_jax_trainer(
        request, tmp_path, tensor):
    """5 steps of the ViT (16x16 crops of the synthetic CIFAR-10, global
    batch 8, clipping at 0.5) at ``pipeline=2`` and at ``pipeline=2 x
    tensor=2``: the loss and the grad norm within 1e-4 relative at every
    step, the final params within 1e-3 relative L2 per leaf (measured on
    an x86 CPU over both meshes: loss 9.0e-7, norm 1.1e-6, params
    2.6e-6).  ViT runs no
    schedule: every stage runs the whole forward on the same rows, its
    layer stack stored split over the stages (``wi`` ``[L/2, d, f/T]``)
    and gathered whole before the layer loop.  Each stage's slice takes
    its part of the one gradient (a sum over the stages would double it),
    and the replicated leaves take the stages' mean."""
    world = request.getfixturevalue("world4" if tensor == 2 else "world2")
    init = jax.device_get(JaxViT(JaxViTConfig(**VIT_CFG)).init_params(
        jax.random.PRNGKey(0)))
    jm = JaxViT(JaxViTConfig(**VIT_CFG), lr=3e-3)
    jm.params = jax.tree.map(jnp.asarray, init)
    tm = ViT(ViTConfig(**VIT_CFG), lr=3e-3, device="cpu")
    tm.params = params_from_jax(init, device="cpu")
    jt, tt = _fit_both(tmp_path, world, jm, tm,
                       JaxRayTPU(1, pipeline=2, tensor=tensor),
                       RayTPUAccelerator(1, pipeline=2, tensor=tensor),
                       _vit_data(), 8)
    _assert_trajectories(jt, jm, tt, tm, steps=5)
    rep = tt.rank_report
    shapes = rep["state_shapes"]
    assert shapes["params/layers/mlp/wi"] == [1, 32, 64 // tensor]
    assert shapes["params/layers/attn/wq"] == [1, 32, 4 // tensor, 8]
    assert shapes["params/head"] == [32, 10]
    assert rep["replicated_bitwise_equal"] is True
    # no schedule: the stack gathered once a step, no activation hops
    comms = rep["model_comms"]["counts"]
    assert "ppermute" not in comms
    assert comms["all_gather"] == 5 * 8


def test_mnist_mlp_under_the_pipeline_axis_matches_jax_trainer(world2,
                                                               tmp_path):
    """The MNIST MLP (no logical axes: every leaf replicated) at
    ``pipeline=2``, 5 steps of global batch 16: the loss and the grad
    norm within 1e-4 relative at every step and the final params within
    1e-3 relative L2 of the JAX Trainer's (measured on an x86 CPU: loss
    1.8e-6, norm 1.8e-6, params 7.2e-6).  The pipeline axis is not a
    batch axis: both stages train on the same rows, so the fit is one
    process's (loss within 1e-6 relative, params 1e-5 relative L2;
    measured 6.7e-8 and 3.1e-7: the ranks' 2 threads sum in another
    order)."""
    x, y = (np.asarray(a) for a in jax_synthetic_mnist(80, seed=0))
    init = jax.device_get(JaxMNIST(MNIST_CFG).init_params(
        jax.random.PRNGKey(0)))
    jm = JaxMNIST(MNIST_CFG)
    jm.params = jax.tree.map(jnp.asarray, init)
    tm = MNISTClassifier(MNIST_CFG, device="cpu")
    tm.params = params_from_jax(init, device="cpu")
    jt, tt = _fit_both(tmp_path, world2, jm, tm, JaxRayTPU(1, pipeline=2),
                       RayTPUAccelerator(1, pipeline=2), (x, y), 16)
    _assert_trajectories(jt, jm, tt, tm, steps=5)
    one = MNISTClassifier(MNIST_CFG, device="cpu")
    one.params = params_from_jax(init, device="cpu")
    t1 = Trainer(device="cpu", default_root_dir=str(tmp_path / "one"),
                 **COMMON)
    t1.fit(one, DataLoader(ArrayDataset(x, y), batch_size=16, shuffle=True))
    for a, b in zip(_history(tt, "train_loss"), _history(t1, "train_loss")):
        assert a == pytest.approx(b, rel=1e-6)
    for k, v in _flat(one.params).items():
        assert _rel_l2(_flat(tm.params)[k], v) <= 1e-5, k
    assert tt.rank_report["replicated_bitwise_equal"] is True
    assert tt.rank_report["plan"]["dp"] == 1


# --------------------------------------------------------------------- #
# checkpoints over two model axes                                        #
# --------------------------------------------------------------------- #
def test_checkpoints_of_a_pipeline_tensor_world(world4, tmp_path):
    """``pipeline=2 x tensor=2`` writes a ``"sharded"`` checkpoint after
    its epoch: a layer leaf is split on ``(pipeline, 0)`` and ``(tensor,
    d)`` at once, so each of its four parts is a rectangle on two dims,
    and the embedding's two parts are its vocabulary halves.  Restored in
    one process it gives the fitted params bit for bit, and a second
    epoch resumed there ends within 1e-5 relative L2 per leaf of the
    4-rank uninterrupted run (another reduction order).  A ``"pickle"``
    checkpoint holds the whole tensors, gathered over both axes."""
    jm, tm = _gpt_pair()
    t = Trainer(device="cpu", accelerator=RayTPUAccelerator(
        1, pipeline=2, tensor=2), default_root_dir=str(tmp_path / "a"),
        **{**COMMON, "enable_checkpointing": True,
           "checkpoint_format": "sharded"})
    t._world = world4
    t.fit(tm, DataLoader(ArrayDataset(DATA), batch_size=4, shuffle=True))
    t._world = None
    best = t.checkpoint_callback.best_model_path
    assert sc.verify_checkpoint(best) == (True, "ok")
    leaves = sc.read_manifest(best)["leaves"]
    wq = leaves["params/layers/attn/wq"]
    assert wq["shape"] == [2, 64, 4, 16]
    assert wq["layout"] == [["pipeline", 0], ["tensor", 2]]
    assert sorted((p["start"], p["length"]) for p in wq["parts"]) == [
        ([0, 0, 0, 0], [1, 64, 2, 16]), ([0, 0, 2, 0], [1, 64, 2, 16]),
        ([1, 0, 0, 0], [1, 64, 2, 16]), ([1, 0, 2, 0], [1, 64, 2, 16])]
    assert len(leaves["opt/adam/nu/layers/mlp/wo"]["parts"]) == 4
    assert len(leaves["params/embed"]["parts"]) == 2
    assert len(leaves["params/ln_f"]["parts"]) == 1
    loaded = GPT.load_from_checkpoint(best, device="cpu")
    for k, v in _flat(tm.params).items():
        np.testing.assert_array_equal(_flat(loaded.params)[k], v, k)

    _, full = _gpt_pair()
    t2 = Trainer(device="cpu", accelerator=RayTPUAccelerator(
        1, pipeline=2, tensor=2), default_root_dir=str(tmp_path / "b"),
        **{**COMMON, "max_epochs": 2})
    t2._world = world4
    t2.fit(full, DataLoader(ArrayDataset(DATA), batch_size=4, shuffle=True))
    t2._world = None
    one = GPT(TransformerConfig(**CFG), device="cpu", lr=3e-3)
    t3 = Trainer(device="cpu", default_root_dir=str(tmp_path / "c"),
                 **{**COMMON, "max_epochs": 2})
    t3.fit(one, DataLoader(ArrayDataset(DATA), batch_size=4, shuffle=True),
           ckpt_path=best)
    assert t3.global_step == t2.global_step == 12
    for k, v in _flat(full.params).items():
        assert _rel_l2(_flat(one.params)[k], v) <= 1e-5, k

    _, pm = _gpt_pair()
    t4 = Trainer(device="cpu", accelerator=RayTPUAccelerator(
        1, pipeline=2, tensor=2), default_root_dir=str(tmp_path / "d"),
        **{**COMMON, "enable_checkpointing": True, "max_steps": 2})
    t4._world = world4
    t4.fit(pm, DataLoader(ArrayDataset(DATA), batch_size=4, shuffle=True))
    t4._world = None
    st = ckpt_lib.read_checkpoint(
        t4.checkpoint_callback.best_model_path)["state"]
    for k, v in _flat(pm.params).items():
        np.testing.assert_array_equal(_flat(st["params"])[k], v, k)
    assert st["opt_state"]["adam"]["mu"][0].shape == (VOCAB, 64)


# --------------------------------------------------------------------- #
# the 8-rank plans, without ranks                                        #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("spelling", ["fsdp", "data"])
def test_eight_rank_pipeline_tensor_plans_match_jax(spelling):
    """The port's plan for ``RayTPUAccelerator(2, use_fsdp=True,
    pipeline=2, tensor=2)`` and for ``data=2 x pipeline=2 x tensor=2``
    equals the JAX plan's ``describe()`` on 8 devices, and each layer
    leaf is split on the pipeline dim and its tensor dim (under fsdp on
    d_model too)."""
    if spelling == "fsdp":
        jacc = JaxRayTPU(2, use_fsdp=True, pipeline=2, tensor=2)
        pacc = RayTPUAccelerator(2, use_fsdp=True, pipeline=2, tensor=2)
    else:
        jacc = JaxAccelerator(JaxMeshConfig(data=2, pipeline=2, tensor=2))
        pacc = Accelerator(MeshConfig(data=2, pipeline=2, tensor=2))
    pacc.device_type = "cpu"
    jmodel = JaxGPT(JaxConfig(**CFG))
    pmodel = GPT(TransformerConfig(**CFG), device="cpu")
    key = jax.random.PRNGKey(0)
    jparams = jmodel.init_params(key)
    jmesh = jacc.build_mesh()
    tx = jmodel.configure_optimizers()
    if not isinstance(tx, optax.GradientTransformation):
        tx = optax.adamw(1e-3)
    jp = jax_plan.build_plan(jmesh, jacc, jmodel,
                             JaxState.create(jparams, tx, key), tx)
    pmesh = pacc.build_mesh()
    assert pmesh.shape == dict(jmesh.shape)
    pp = plan_lib.build_plan(
        pmesh, pacc, pmodel, params_from_jax(jax.device_get(jparams),
                                             device="cpu"),
        functools.partial(state_layouts, pmodel.configure_optimizers()))
    assert pp.describe() == jp.describe()
    wq = pp.param_layouts["layers"]["attn"]["wq"]
    want = (("pipeline", 0),) + ((("fsdp", 1),) if spelling == "fsdp"
                                 else ()) + (("tensor", 2),)
    assert wq == want
    assert jax_mesh.mesh_axis_size(jmesh, "pipeline") == \
        mesh_lib.mesh_axis_size(pmesh, "pipeline") == 2
