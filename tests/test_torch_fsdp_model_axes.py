"""The 2-D layouts over gloo ranks on the CPU: FSDP, ZeRO-1, the sharded
checkpoints and int8 training under the tensor or expert axis, against
the JAX package's GSPMD on tests/conftest.py's 8 CPU devices:

- the global gradient norm where fsdp meets the tensor axis (summed over
  the fsdp group too; it read 27% low before), and the GPT at fsdp 2 x
  tensor 2 in both spellings (``Accelerator(MeshConfig(...))`` and
  ``RayTPUAccelerator(2, use_fsdp=True, tensor=2)``);
- ViT at fsdp 2 x tensor 2 and the MoE GPT at fsdp 2 x expert 2;
- ``shard_optimizer_state=True`` under the tensor axis (JAX's warning,
  skipped: bitwise the run without) and with the expert axis on a dense
  GPT, whose leaves the expert axis does not split (ZeRO-1 applies);
- ``int8_matmul=True`` under the tensor axis, and the scales of a
  row-split ``wo`` bitwise the whole weight's;
- a ``"sharded"`` checkpoint of a 2 x 2 world restored into one process
  and into another mesh, resumed trajectories equal to the
  uninterrupted one, a ``"pickle"`` one holding whole tensors, and a
  format-1 checkpoint.

One world of 4 ranks serves the module; rank bodies come from
tests/torch_boring.py (no JAX)."""

import functools
import json
import logging
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_lightning_accelerators_tpu import Accelerator as JaxAccelerator
from ray_lightning_accelerators_tpu import MeshConfig as JaxMeshConfig
from ray_lightning_accelerators_tpu import RayTPUAccelerator as JaxRayTPU
from ray_lightning_accelerators_tpu import Trainer as JaxTrainer
from ray_lightning_accelerators_tpu.data.loader import (
    ArrayDataset as JaxArrayDataset, DataLoader as JaxDataLoader)
from ray_lightning_accelerators_tpu.models import transformer as jax_tf
from ray_lightning_accelerators_tpu.models.transformer import (
    GPT as JaxGPT, TransformerConfig as JaxConfig)
from ray_lightning_accelerators_tpu.models.vit import (
    ViT as JaxViT, ViTConfig as JaxViTConfig)
from ray_lightning_accelerators_tpu_torch import (Accelerator, DataLoader,
                                                  MeshConfig,
                                                  RayTPUAccelerator, Trainer)
from ray_lightning_accelerators_tpu_torch.data.loader import ArrayDataset
from ray_lightning_accelerators_tpu_torch.models import transformer as tf
from ray_lightning_accelerators_tpu_torch.models.resnet import (
    synthetic_cifar10)
from ray_lightning_accelerators_tpu_torch.models.transformer import (
    GPT, TransformerConfig)
from ray_lightning_accelerators_tpu_torch.models.vit import ViT, ViTConfig
from ray_lightning_accelerators_tpu_torch.runtime import bootstrap
from ray_lightning_accelerators_tpu_torch.runtime.bootstrap import (
    DistributedWorld)
from ray_lightning_accelerators_tpu_torch.utils import checkpoint as ckpt_lib
from ray_lightning_accelerators_tpu_torch.utils import (
    sharded_checkpoint as sc)
from ray_lightning_accelerators_tpu_torch.utils.weights import (
    params_from_jax)

from . import torch_boring

pytestmark = pytest.mark.fsdp
torch.backends.cuda.matmul.allow_tf32 = False

VOCAB, SEQ = 256, 32
CFG = dict(vocab_size=VOCAB, d_model=64, n_heads=4, d_ff=128, n_layers=2,
           max_seq_len=SEQ, loss_chunk_rows=64)
COMMON = dict(max_epochs=1, precision="f32", log_every_n_steps=1,
              gradient_clip_val=0.5, log_grad_norm=True,
              enable_checkpointing=False, seed=0)


@pytest.fixture(scope="module")
def world():
    saved = bootstrap.DEFAULT_TIMEOUT_S
    bootstrap.DEFAULT_TIMEOUT_S = 60.0
    w = DistributedWorld(4, devices=["cpu"] * 4, timeout_s=60.0)
    try:
        yield w
    finally:
        w.shutdown()
        bootstrap.DEFAULT_TIMEOUT_S = saved


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


def _init(cfg=CFG):
    return jax.device_get(JaxGPT(JaxConfig(**cfg)).init_params(
        jax.random.PRNGKey(0)))


def _jax_fit(root, acc, cfg=CFG, **kw):
    jm = JaxGPT(JaxConfig(**cfg), lr=3e-3)
    jm.params = jax.tree.map(jnp.asarray, _init(cfg))
    jt = JaxTrainer(accelerator=acc, guard=None, prefetch_batches=0,
                    cache_dataset_on_device=False,
                    default_root_dir=str(root), **{**COMMON, **kw})
    jt.fit(jm, JaxDataLoader(JaxArrayDataset(DATA), batch_size=4,
                             shuffle=True, use_native=False))
    return jt, jm


def _port_fit(world, root, acc, cfg=CFG, params=None, ckpt_path=None,
              **kw):
    tm = GPT(TransformerConfig(**cfg), device="cpu", lr=3e-3)
    if ckpt_path is None:
        tm.params = (params_from_jax(_init(cfg), device="cpu")
                     if params is None else params)
    t = Trainer(device="cpu", accelerator=acc, default_root_dir=str(root),
                **{**COMMON, **kw})
    t._world = world
    t.fit(tm, DataLoader(ArrayDataset(DATA), batch_size=4, shuffle=True),
          ckpt_path=ckpt_path)
    t._world = None     # the module's fixture ends the world
    return t, tm


def _assert_trajectories(jt, jm, tt, tm, keys=("train_loss", "grad_norm"),
                         steps=6):
    for key in keys:
        jh, th = _history(jt, key), _history(tt, key)
        assert len(th) == len(jh) == steps, key
        for a, b in zip(th, jh):
            assert a == pytest.approx(b, rel=1e-4), key
    jp, tp = _flat(jax.device_get(jm.params)), _flat(tm.params)
    assert jp.keys() == tp.keys()
    for name in jp:
        assert _rel_l2(tp[name], jp[name]) <= 1e-3, name


# --------------------------------------------------------------------- #
# fsdp x tensor, fsdp x expert                                           #
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def jax_fsdp_tensor(tmp_path_factory):
    """The JAX Trainer at fsdp 2 x tensor 2 (``data=1, fsdp=2, tensor=2``:
    both spellings of the mesh below build this one)."""
    return _jax_fit(tmp_path_factory.mktemp("jax"), JaxAccelerator(
        JaxMeshConfig(data=1, fsdp=2, tensor=2)))


@pytest.mark.parametrize("spelling", ["mesh_config", "use_fsdp"])
def test_fsdp_tensor_norm_and_fit_match_jax_trainer(world, tmp_path,
                                                    jax_fsdp_tensor,
                                                    spelling):
    """fsdp 2 x tensor 2, 6 steps (24 shuffled rows, global batch 4,
    clipping at 0.5): the logged global grad norm and the loss within
    1e-4 relative of the JAX Trainer's at every step, the final params
    within 1e-3 relative L2 per leaf (measured on an x86 CPU: norm
    1.5e-6, loss 4.6e-7, params 7.4e-6).  The norm sums each leaf's
    squares over every axis that splits it, fsdp included: summed over
    the tensor group alone it read 27% low at every step (0.956 against
    1.314 at step 1) and the clip moved ``/embed`` 1.5e-3 from JAX.  Each
    rank holds its fsdp slice of its tensor part (``wi`` ``[2, d/2,
    f/2]``), the plan is JAX's."""
    pacc = (Accelerator(MeshConfig(data=1, fsdp=2, tensor=2))
            if spelling == "mesh_config"
            else RayTPUAccelerator(2, use_fsdp=True, tensor=2))
    jt, jm = jax_fsdp_tensor
    tt, tm = _port_fit(world, tmp_path / "port", pacc)
    _assert_trajectories(jt, jm, tt, tm)
    rep = tt.rank_report
    assert rep["plan"] == jt._plan.describe()
    shapes = rep["state_shapes"]
    assert shapes["params/layers/mlp/wi"] == [2, 32, 64]
    assert shapes["opt/adam/mu/layers/mlp/wo"] == [2, 64, 32]
    assert shapes["params/embed"] == [VOCAB // 2, 32]
    assert shapes["params/layers/attn/wq"] == [2, 32, 2, 16]
    assert shapes["params/layers/ln1"] == [2, 64]
    assert rep["replicated_bitwise_equal"] is True


def test_vit_fsdp_tensor_fit_matches_jax_trainer(world, tmp_path):
    """5 steps of the ViT (16x16 crops of the synthetic CIFAR-10, global
    batch 8) at fsdp 2 x tensor 2 through ``param_logical_axes()``: the
    loss within 1e-4 relative at every step, the final params within
    1e-3 relative L2 per leaf (measured 9.0e-7 and 2.6e-6); the plan is
    JAX's, ``wi`` is ``[2, d/2, f/2]``."""
    vcfg = dict(image_size=16, patch_size=4, channels=3, d_model=32,
                n_heads=4, d_ff=64, n_layers=2, n_classes=10)
    x, y = synthetic_cifar10(40, 1)
    x = np.ascontiguousarray(x[:, 8:24, 8:24])
    init = jax.device_get(JaxViT(JaxViTConfig(**vcfg)).init_params(
        jax.random.PRNGKey(0)))
    common = dict(max_epochs=1, precision="f32", log_every_n_steps=1,
                  enable_checkpointing=False, seed=0)
    jm = JaxViT(JaxViTConfig(**vcfg), lr=3e-3)
    jm.params = jax.tree.map(jnp.asarray, init)
    jt = JaxTrainer(accelerator=JaxRayTPU(2, use_fsdp=True, tensor=2),
                    guard=None, prefetch_batches=0,
                    cache_dataset_on_device=False,
                    default_root_dir=str(tmp_path / "jax"), **common)
    jt.fit(jm, JaxDataLoader(JaxArrayDataset(x, y), batch_size=8,
                             shuffle=True, use_native=False))
    tm = ViT(ViTConfig(**vcfg), lr=3e-3, device="cpu")
    tm.params = params_from_jax(init, device="cpu")
    tt = Trainer(device="cpu",
                 accelerator=RayTPUAccelerator(2, use_fsdp=True, tensor=2),
                 default_root_dir=str(tmp_path / "port"), **common)
    tt._world = world
    tt.fit(tm, DataLoader(ArrayDataset(x, y), batch_size=8, shuffle=True))
    tt._world = None
    jl, tl = _history(jt, "train_loss"), _history(tt, "train_loss")
    assert len(tl) == len(jl) == 5
    for a, b in zip(tl, jl):
        assert a == pytest.approx(b, rel=1e-4)
    jp, tp = _flat(jax.device_get(jm.params)), _flat(tm.params)
    for name in jp:
        assert _rel_l2(tp[name], jp[name]) <= 1e-3, name
    assert tt.rank_report["plan"] == jt._plan.describe()
    shapes = tt.rank_report["state_shapes"]
    assert shapes["params/layers/mlp/wi"] == [2, 16, 32]
    assert shapes["params/layers/attn/wq"] == [2, 16, 2, 8]


def test_moe_fsdp_expert_fit_matches_jax_trainer(world, tmp_path):
    """The MoE GPT (4 experts, top-2) at fsdp 2 x expert 2, 6 steps: the
    loss, the aux loss (its fractions over the batch axes) and the grad
    norm within 1e-4 relative at every step, the final params within
    1e-3 relative L2 per leaf (measured 2.7e-7, 1.7e-6, 1.2e-6 and
    6.6e-6); the expert leaves hold their experts' fsdp slice."""
    cfg = dict(CFG, num_experts=4, moe_top_k=2)
    acc = dict(use_fsdp=True, expert=2)
    jt, jm = _jax_fit(tmp_path / "jax", JaxRayTPU(2, **acc), cfg)
    tt, tm = _port_fit(world, tmp_path / "port", RayTPUAccelerator(2, **acc),
                       cfg)
    _assert_trajectories(jt, jm, tt, tm,
                         keys=("train_loss", "moe_aux_loss", "grad_norm"))
    rep = tt.rank_report
    assert rep["plan"] == jt._plan.describe()
    assert rep["state_shapes"]["params/layers/mlp/wi"] == [2, 2, 32, 128]
    assert rep["state_shapes"]["opt/adam/nu/layers/mlp/wo"] == \
        [2, 2, 128, 32]


# --------------------------------------------------------------------- #
# ZeRO-1 under a model axis                                              #
# --------------------------------------------------------------------- #
def test_zero1_under_tensor_is_skipped_bitwise(world, tmp_path, caplog):
    """``shard_optimizer_state=True`` at data 2 x tensor 2: the params are
    sharded, so the plan logs the JAX package's warning and skips the
    ZeRO-1 re-sharding; the fit is bit for bit the one without."""
    acc = lambda: RayTPUAccelerator(2, tensor=2)  # noqa: E731
    t0, m0 = _port_fit(world, tmp_path / "a", acc())
    caplog.set_level(logging.WARNING)
    t1, m1 = _port_fit(world, tmp_path / "b", acc(),
                       shard_optimizer_state=True)
    assert t1.rank_report["plan"]["regime"] == "dp"
    assert _history(t1, "train_loss") == _history(t0, "train_loss")
    for k, v in _flat(m0.params).items():
        np.testing.assert_array_equal(_flat(m1.params)[k], v, k)
    # the plan resolved in this process logs it (the ranks' logs stay
    # in the ranks)
    from ray_lightning_accelerators_tpu_torch.parallel import plan
    from ray_lightning_accelerators_tpu_torch.core.optim import (
        state_layouts)
    model = GPT(TransformerConfig(**CFG), device="cpu")
    p = acc()
    p.device_type = "cpu"
    plan.build_plan(p.build_mesh(), p, model, model.init_params(0),
                    functools.partial(state_layouts,
                                      model.configure_optimizers()),
                    shard_optimizer_state=True)
    assert ("shard_optimizer_state=True with sharded params: the "
            "optimizer state already inherits the FSDP/TP layout; ZeRO-1 "
            "re-sharding is skipped") in caplog.text


def test_zero1_with_expert_axis_on_a_dense_gpt(world, tmp_path):
    """A dense GPT at data 2 x expert 2: the expert axis splits no leaf,
    so, as the JAX ``build_plan`` decides from the actual layouts,
    ZeRO-1 applies (each rank's moments hold its dim-0 slice over the
    batch axes) and the fit matches the JAX Trainer's (loss and norm
    1e-4 relative, params 1e-3 relative L2; measured 2.7e-7, 1.0e-6 and
    3.9e-6)."""
    acc = dict(expert=2)
    jt, jm = _jax_fit(tmp_path / "jax", JaxRayTPU(2, **acc),
                      shard_optimizer_state=True)
    tt, tm = _port_fit(world, tmp_path / "port", RayTPUAccelerator(2, **acc),
                       shard_optimizer_state=True)
    _assert_trajectories(jt, jm, tt, tm)
    rep = tt.rank_report
    assert rep["plan"] == jt._plan.describe()
    assert rep["plan"]["regime"] == "zero1"
    assert rep["state_shapes"]["params/embed"] == [VOCAB, 64]
    assert rep["state_shapes"]["opt/adam/mu/embed"] == [VOCAB // 2, 64]
    assert rep["state_shapes"]["opt/adam/nu/layers/mlp/wi"] == [1, 64, 128]


# --------------------------------------------------------------------- #
# int8 training under the tensor axis                                    #
# --------------------------------------------------------------------- #
def test_int8_matmul_under_tensor_matches_jax_trainer(world, tmp_path):
    """``int8_matmul=True`` at data 2 x tensor 2, 6 steps.  Each rank
    runs the int8 product (its plain version here) on its rows of ``wo``
    with the whole weight's scales (one max all-reduce per layer a step),
    so the fit is the data-parallel int8 fit's: the loss and the norm
    within 1e-5 relative at every step of the port's own ``data=4`` run,
    the params within 1e-5 relative L2 (measured 9.1e-8, 9.1e-8 and
    2.1e-6).  Against the JAX Trainer (its int8-rounded XLA product under
    GSPMD) the bound is the int8 parity's of
    tests/test_torch_training_extras.py, 2e-4 relative on the loss and
    the norm, 1e-3 relative L2 on the params (measured 4.7e-6, 1.5e-4
    and 1.3e-4): a weight that rounds to the other int8 step moves the
    straight-through gradients, in JAX's data-parallel int8 run and the
    port's alike."""
    acc = dict(tensor=2)
    jt, jm = _jax_fit(tmp_path / "jax", JaxRayTPU(2, **acc),
                      int8_matmul=True)
    tt, tm = _port_fit(world, tmp_path / "port", RayTPUAccelerator(2, **acc),
                       int8_matmul=True)
    td, tdm = _port_fit(world, tmp_path / "dp", RayTPUAccelerator(4),
                        int8_matmul=True)
    for key in ("train_loss", "grad_norm"):
        th, dh, jh = (_history(t, key) for t in (tt, td, jt))
        assert len(th) == len(dh) == len(jh) == 6, key
        for a, b, c in zip(th, dh, jh):
            assert a == pytest.approx(b, rel=1e-5), key
            assert a == pytest.approx(c, rel=2e-4), key
    jp = _flat(jax.device_get(jm.params))
    tp, dp = _flat(tm.params), _flat(tdm.params)
    for name in jp:
        assert _rel_l2(tp[name], dp[name]) <= 1e-5, name
        assert _rel_l2(tp[name], jp[name]) <= 1e-3, name
    comms = tt.rank_report["model_comms"]["counts"]
    # a step: the vocab-parallel loss's two row maxima, and wo's column
    # maxima in each layer
    assert comms["max_all_reduce"] == 6 * (2 + CFG["n_layers"])


def test_row_split_int8_scales_are_the_whole_weights(world):
    """The scales of a ``wo [f, d]`` whose rows (the contraction) are split
    over tensor 4 are the maxima over the group: every rank holds the
    whole weight's scales and its rows' int8 values, bit for bit the
    port's and the JAX package's ``_channel_quant`` of the whole
    weight."""
    w = np.random.default_rng(3).standard_normal((128, 64)).astype(
        np.float32)
    w[5, :] *= 40.0     # one rank's rows hold every column's maximum
    ranks = world.run(functools.partial(
        torch_boring.int8_scale_body, w=w, shape={"tensor": 4}))
    ranks.sort(key=lambda r: r["tensor"])
    q8, scale, _ = tf._channel_quant(torch.from_numpy(w))
    jq8, jscale, _ = jax_tf._channel_quant(jnp.asarray(w))
    np.testing.assert_array_equal(np.asarray(jq8), q8.numpy())
    np.testing.assert_array_equal(np.asarray(jscale), scale.numpy())
    np.testing.assert_array_equal(
        np.concatenate([r["q8"] for r in ranks]), q8.numpy())
    for r in ranks:
        np.testing.assert_array_equal(r["scale"], scale.numpy())


# --------------------------------------------------------------------- #
# sharded checkpoints over two axes                                      #
# --------------------------------------------------------------------- #
def test_sharded_checkpoint_of_a_2x2_world(world, tmp_path):
    """fsdp 2 x tensor 2 writes a ``"sharded"`` checkpoint after epoch 1
    (format 2: each part a rectangle of its leaf; ``wi``'s four parts,
    one a rank).  Restored in one process it gives the fitted params
    bit for bit; resumed for epoch 2 on the same mesh it ends bit for bit
    where the uninterrupted 2-epoch fit does, in one process and on data
    2 x tensor 2 within 1e-5 relative L2 per leaf (measured 8.3e-8 and
    6.4e-8: other reduction orders)."""
    acc = lambda: RayTPUAccelerator(2, use_fsdp=True, tensor=2)  # noqa
    t1, m1 = _port_fit(world, tmp_path / "a", acc(),
                       enable_checkpointing=True,
                       checkpoint_format="sharded")
    best = t1.checkpoint_callback.best_model_path
    assert sc.verify_checkpoint(best) == (True, "ok")
    manifest = sc.read_manifest(best)
    assert manifest["format"] == 2
    wi = manifest["leaves"]["params/layers/mlp/wi"]
    assert wi["shape"] == [2, 64, 128]
    assert wi["layout"] == [["tensor", 2], ["batch", 1]]
    assert sorted((p["start"], p["length"]) for p in wi["parts"]) == [
        ([0, 0, 0], [2, 32, 64]), ([0, 0, 64], [2, 32, 64]),
        ([0, 32, 0], [2, 32, 64]), ([0, 32, 64], [2, 32, 64])]
    assert len(manifest["leaves"]["params/ln_f"]["parts"]) == 1
    loaded = GPT.load_from_checkpoint(best, device="cpu")
    for k, v in _flat(m1.params).items():
        np.testing.assert_array_equal(_flat(loaded.params)[k], v, k)

    t2, m2 = _port_fit(world, tmp_path / "b", acc(), max_epochs=2)
    t3, m3 = _port_fit(world, tmp_path / "c", acc(), max_epochs=2,
                       ckpt_path=best)
    assert t3.global_step == t2.global_step == 12
    for k, v in _flat(m2.params).items():
        np.testing.assert_array_equal(_flat(m3.params)[k], v, k)
    t4, m4 = _port_fit(world, tmp_path / "d", RayTPUAccelerator(2, tensor=2),
                       max_epochs=2, ckpt_path=best)
    one = GPT(TransformerConfig(**CFG), device="cpu", lr=3e-3)
    t5 = Trainer(device="cpu", default_root_dir=str(tmp_path / "e"),
                 **{**COMMON, "max_epochs": 2})
    t5.fit(one, DataLoader(ArrayDataset(DATA), batch_size=4, shuffle=True),
           ckpt_path=best)
    for k, v in _flat(m2.params).items():
        assert _rel_l2(_flat(m4.params)[k], v) <= 1e-5, k
        assert _rel_l2(_flat(one.params)[k], v) <= 1e-5, k


def test_pickle_checkpoint_of_a_2x2_world_is_whole(world, tmp_path):
    """A ``"pickle"`` checkpoint at fsdp 2 x tensor 2 holds whole tensors:
    rank 0 writes what the ranks' parts gather to over the fsdp group,
    then the tensor group; the params are the fitted ones bit for bit and
    each moment has its leaf's whole shape."""
    t, m = _port_fit(world, tmp_path, RayTPUAccelerator(2, use_fsdp=True,
                                                        tensor=2),
                     enable_checkpointing=True, max_steps=2)
    payload = ckpt_lib.read_checkpoint(t.checkpoint_callback.best_model_path)
    st = payload["state"]
    for k, v in _flat(m.params).items():
        np.testing.assert_array_equal(_flat(st["params"])[k], v, k)
    assert st["opt_state"]["adam"]["mu"][0].shape == (VOCAB, 64)
    assert payload["world"] == {"dp": 2, "fsdp": 2, "processes": 4}


def test_format1_checkpoint_still_restores(tmp_path):
    """A checkpoint in format 1 (one split dim, parts at ``r * n``
    offsets, a per-rank buffer stacked) still assembles, whole and cut to
    another world's slices."""
    path = tmp_path / "v1"
    state = path / sc.STATE_DIR
    os.makedirs(state)
    w = torch.arange(32, dtype=torch.float32).reshape(8, 4)
    res = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    for r in range(2):
        part = {"params/w": w[4 * r:4 * r + 4].clone(),
                "residual/w": res[r].clone()}
        if r == 0:
            part["params/b"] = torch.ones(4)
        torch.save(part, state / sc.rank_file(r))
    manifest = {"format": 1, "world": 2, "leaves": {
        "params/w": {"shape": [8, 4], "dtype": "float32", "layout": 0,
                     "parts": [{"file": sc.rank_file(r), "offset": 4 * r,
                                "length": 4} for r in range(2)]},
        "params/b": {"shape": [4], "dtype": "float32", "layout": None,
                     "parts": [{"file": sc.rank_file(0), "offset": 0}]},
        "residual/w": {"shape": [2, 3], "dtype": "float32",
                       "layout": "per_replica",
                       "parts": [{"file": sc.rank_file(r), "offset": r}
                                 for r in range(2)]}}}
    with open(state / sc.MANIFEST_FILE, "w") as f:
        json.dump(manifest, f)
    with open(path / sc.META_FILE, "w") as f:
        json.dump({"epoch": 1}, f)
    whole = sc.restore_sharded(str(path))
    np.testing.assert_array_equal(whole["params/w"].numpy(), w.numpy())
    np.testing.assert_array_equal(whole["params/b"].numpy(), np.ones(4))
    np.testing.assert_array_equal(whole["residual/w"].numpy(), res.numpy())
    for rank in range(4):
        out = sc.restore_sharded(str(path), layouts={"params/w": 0},
                                 rank=rank, world=4)
        np.testing.assert_array_equal(out["params/w"].numpy(),
                                      w[2 * rank:2 * rank + 2].numpy())
    assert sc.restore_params(str(path))["w"].shape == (8, 4)
