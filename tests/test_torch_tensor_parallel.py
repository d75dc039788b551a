"""Tensor parallelism (Megatron column / row splits) over gloo ranks on
the CPU, against the JAX package's GSPMD on tests/conftest.py's 8 CPU
devices:

- the GPT at tensor = 2, data = 2 x tensor = 2 and sequence = 2 x
  tensor = 2 (both modes), each against the JAX Trainer on the same
  mesh: loss trajectory and final params, each rank holding only its
  slices;
- label smoothing and z-loss at tensor = 2;
- ``vocab_parallel_cross_entropy``'s sums, gradient and accuracy with
  argmax ties planted across the two vocabulary shards (the lowest
  global index wins, as ``jnp.argmax``);
- the replicated leaves bitwise equal across the tensor ranks after 3
  steps with dropout 0.1;
- validate and predict outputs, and ``generate`` after the fit;
- a 5-step ViT fit at tensor = 2.

Two worlds (2 and 4 ranks) serve the module; models come from
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
from ray_lightning_accelerators_tpu.models.vit import (
    ViT as JaxViT, ViTConfig as JaxViTConfig)
from ray_lightning_accelerators_tpu_torch import (DataLoader,
                                                  RayTPUAccelerator, Trainer)
from ray_lightning_accelerators_tpu_torch.data.loader import ArrayDataset
from ray_lightning_accelerators_tpu_torch.models.resnet import (
    synthetic_cifar10)
from ray_lightning_accelerators_tpu_torch.models.transformer import (
    GPT, TransformerConfig)
from ray_lightning_accelerators_tpu_torch.models.vit import ViT, ViTConfig
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
           max_seq_len=SEQ, loss_chunk_rows=64)
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


def _jax_gpt_fit(root, acc, cfg=CFG, **kw):
    jm = JaxGPT(JaxConfig(**cfg), lr=3e-3)
    jm.params = JaxGPT(JaxConfig(**cfg)).init_params(jax.random.PRNGKey(0))
    jt = JaxTrainer(accelerator=acc, guard=None, prefetch_batches=0,
                    cache_dataset_on_device=False,
                    default_root_dir=str(root), **{**COMMON, **kw})
    jt.fit(jm, JaxDataLoader(JaxArrayDataset(DATA), batch_size=4,
                             shuffle=True, use_native=False))
    return jt, jm


def _port_gpt_fit(world, root, acc, cfg=CFG, **kw):
    init = jax.device_get(JaxGPT(JaxConfig(**cfg)).init_params(
        jax.random.PRNGKey(0)))
    tm = GPT(TransformerConfig(**cfg), device="cpu", lr=3e-3)
    tm.params = params_from_jax(init, device="cpu")
    t = Trainer(device="cpu", accelerator=acc, default_root_dir=str(root),
                **{**COMMON, **kw})
    t._world = world
    t.fit(tm, DataLoader(ArrayDataset(DATA), batch_size=4, shuffle=True))
    t._world = None     # the module's fixtures end the worlds
    return t, tm


def _assert_trajectories(jt, jm, tt, tm, loss_rel=1e-4, param_rel=1e-3):
    jl, tl = _history(jt, "train_loss"), _history(tt, "train_loss")
    assert len(tl) == len(jl) == 6
    for a, b in zip(tl, jl):
        assert a == pytest.approx(b, rel=loss_rel)
    for a, b in zip(_history(tt, "grad_norm"), _history(jt, "grad_norm")):
        assert a == pytest.approx(b, rel=loss_rel)
    jp, tp = _flat(jax.device_get(jm.params)), _flat(tm.params)
    assert jp.keys() == tp.keys()
    for name in jp:
        assert _rel_l2(tp[name], jp[name]) <= param_rel, name


@pytest.mark.parametrize("extra", ["plain", "smoothing_zloss"])
def test_tensor2_fit_matches_jax_trainer(world2, tmp_path, extra):
    """6 steps (24 shuffled rows, global batch 4, clipping at 0.5) at
    tensor = 2: the loss and the global grad norm within 1e-4 relative
    at every step, the final params within 1e-3 relative L2 per leaf
    (measured on an x86 CPU: loss 1.8e-7, norm 8.5e-7, params 4.2e-6);
    with ``label_smoothing=0.1, z_loss=1e-3`` too (2.7e-7, 1.1e-6,
    3.8e-6).  Each rank's masters hold
    half the heads, d_ff and vocabulary; the norm scales whole."""
    cfg = CFG if extra == "plain" else dict(CFG, label_smoothing=0.1,
                                            z_loss=1e-3)
    jt, jm = _jax_gpt_fit(tmp_path / "jax", JaxRayTPU(1, tensor=2), cfg)
    tt, tm = _port_gpt_fit(world2, tmp_path / "port",
                           RayTPUAccelerator(1, tensor=2), cfg)
    _assert_trajectories(jt, jm, tt, tm)
    shapes = tt.rank_report["state_shapes"]
    assert shapes["params/embed"] == [VOCAB // 2, 64]
    assert shapes["params/layers/attn/wq"] == [2, 64, 2, 16]
    assert shapes["params/layers/mlp/wi"] == [2, 64, 64]
    assert shapes["opt/adam/mu/layers/mlp/wo"] == [2, 64, 64]
    assert shapes["params/layers/ln1"] == [2, 64]
    assert tt.rank_report["plan"] == jt._plan.describe()
    comms = tt.rank_report["model_comms"]["counts"]
    # per step: f before q/k/v, the MLP and the head; g after attention
    # wo, the MLP wo and the embedding, and the loss's three sums
    assert comms["f_all_reduce"] == 6 * (2 * 2 + 1)
    assert comms["g_all_reduce"] >= 6 * (2 * 2 + 1)


def test_vocab_parallel_loss_and_planted_argmax_ties(world2):
    """The vocab-split loss against the JAX GPT's materialised formula on
    the whole logits (12 rows over V = 16, label smoothing 0.1, z-loss
    1e-3, two masked rows): the loss sum and each shard's gradient to
    1e-5 (measured 1.5e-7 and 1.2e-7), the correct count exact.  Rows 0 and 1 tie their maximum
    between column 3 (shard 0) and column 11 (shard 1): the lowest index
    wins, so row 0 (target 3) is correct and row 1 (target 11) is not;
    row 2 ties within shard 1 (columns 9 and 13, target 9)."""
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((12, 16)).astype(np.float32)
    targets = rng.integers(0, 16, 12)
    for r, cols, t in ((0, (3, 11), 3), (1, (3, 11), 11), (2, (9, 13), 9)):
        logits[r, list(cols)] = 9.0
        targets[r] = t
    targets[[5, 7]] = -1
    eps, z = 0.1, 1e-3

    def jax_sums(lg):
        valid = targets >= 0
        tgt = jnp.where(valid, targets, 0)
        lse = jax.nn.logsumexp(lg, axis=-1)
        tl = jnp.take_along_axis(lg, tgt[:, None], axis=-1)[:, 0]
        row = lse - (1 - eps) * tl - (eps / lg.shape[-1]) * lg.sum(-1) \
            + z * lse * lse
        return jnp.sum(jnp.where(valid, row, 0.0))

    want = float(jax_sums(jnp.asarray(logits)))
    want_grad = np.asarray(jax.grad(jax_sums)(jnp.asarray(logits)))
    correct = int(np.sum((np.asarray(jnp.argmax(jnp.asarray(logits), -1))
                          == targets) & (targets >= 0)))
    ranks = world2.run(functools.partial(
        torch_boring.vocab_loss_body, logits=logits, targets=targets,
        shape={"tensor": 2}, label_smoothing=eps, z_loss=z))
    for r in ranks:
        assert r["loss"] == pytest.approx(want, rel=1e-5)
        assert r["correct"] == correct and r["n"] == 10
        np.testing.assert_allclose(
            r["grad"], want_grad[:, 8 * r["tensor"]:8 * r["tensor"] + 8],
            atol=1e-5)
    # the planted ties resolve to the lowest global index
    np.testing.assert_array_equal(np.argmax(logits[:3], -1), [3, 3, 9])


def test_replicated_leaves_bitwise_equal_with_dropout(world2, tmp_path):
    """3 steps with dropout 0.1 at tensor = 2: the dropout generator is
    keyed by the (batch, sequence) coordinates, so both tensor ranks drop
    the same elements of the replicated activations and every replicated
    leaf (the norm scales) stays bit for bit equal across them."""
    cfg = dict(CFG, dropout=0.1)
    tt, _ = _port_gpt_fit(world2, tmp_path, RayTPUAccelerator(1, tensor=2),
                          cfg, max_steps=3)
    assert tt.global_step == 3
    assert tt.rank_report["replicated_bitwise_equal"] is True
    owned = tt.rank_report["owned_bytes_by_rank"]
    assert len(owned) == 2 and owned[0] == owned[1]


def test_validate_predict_and_generate_after_a_tensor_fit(world2, tmp_path):
    """After a tensor = 2 fit: ``validate`` and ``predict`` over the ranks
    (each on its slices, the logits gathered whole, in the dataset's
    order) equal the JAX Trainer's on its tensor mesh to 1e-4 (measured:
    the metrics 7.3e-7 relative, the logits 1.2e-5 absolute); the
    driver's module holds the whole params, and ``generate`` on them
    (replicated, as the JAX GPT clears the training mesh for decode)
    equals the JAX GPT's greedy tokens."""
    jt, jm = _jax_gpt_fit(tmp_path / "jax", JaxRayTPU(1, tensor=2))
    tt, tm = _port_gpt_fit(world2, tmp_path / "port",
                           RayTPUAccelerator(1, tensor=2))
    tt._world = world2
    val = _tokens(8, seed=9)
    (jv,) = jt.validate(jm, JaxDataLoader(JaxArrayDataset(val),
                                          batch_size=4, use_native=False))
    (tv,) = tt.validate(tm, DataLoader(ArrayDataset(val), batch_size=4))
    assert jv.keys() == tv.keys()
    for k in jv:
        assert tv[k] == pytest.approx(float(jv[k]), rel=1e-4), k
    jpred = jt.predict(jm, JaxDataLoader(JaxArrayDataset(val),
                                         batch_size=4, use_native=False))
    tpred = tt.predict(tm, DataLoader(ArrayDataset(val), batch_size=4))
    tt._world = None
    assert len(tpred) == len(jpred) == 2
    for a, b in zip(tpred, jpred):
        assert tuple(a.shape) == (4, SEQ, VOCAB)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    assert tuple(tm.params["embed"].shape) == (VOCAB, 64)
    prompt = val[:2, :8]
    want = np.asarray(jm.generate(jm.params, jnp.asarray(prompt), 6))
    got = tm.generate(tm.params, torch.from_numpy(prompt), 6)
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("axes", ["data2_tensor2", "seq2_tensor2_ring",
                                  "seq2_tensor2_ulysses"])
def test_four_rank_compositions_match_jax_trainer(world4, tmp_path, axes):
    """data = 2 x tensor = 2 and sequence = 2 x tensor = 2 (ring and
    Ulysses; the JAX package's fsdp2-sp2-tp2 without fsdp, which the
    port refuses with tensor), 6 steps against the JAX Trainer on the
    same mesh, the bounds of the tensor = 2 test (measured: loss <=
    3.7e-7, norm <= 1.5e-6, params <= 5.6e-6)."""
    if axes == "data2_tensor2":
        jacc, pacc, kw = JaxRayTPU(2, tensor=2), \
            RayTPUAccelerator(2, tensor=2), {}
    else:
        mode = axes.rsplit("_", 1)[1]
        jacc, pacc = JaxRayTPU(1, tensor=2), RayTPUAccelerator(1, tensor=2)
        kw = dict(seq_parallel=2, seq_parallel_mode=mode)
    jt, jm = _jax_gpt_fit(tmp_path / "jax", jacc, **kw)
    tt, tm = _port_gpt_fit(world4, tmp_path / "port", pacc, **kw)
    _assert_trajectories(jt, jm, tt, tm)
    assert tt.rank_report["plan"] == jt._plan.describe()
    assert tt.rank_report["state_shapes"]["params/layers/mlp/wo"] == \
        [2, 64, 64]


def test_vit_tensor2_fit_matches_jax_trainer(world2, tmp_path):
    """5 steps of the ViT (16x16 crops of the synthetic CIFAR-10, global
    batch 8) at tensor = 2 against the JAX Trainer on its tensor mesh:
    the loss within 1e-4 relative at every step and the final params
    within 1e-3 relative L2 per leaf (measured 9.0e-7 and 2.6e-6); the
    heads and d_ff split, the head and the position embedding whole."""
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
    jt = JaxTrainer(accelerator=JaxRayTPU(1, tensor=2), guard=None,
                    prefetch_batches=0, cache_dataset_on_device=False,
                    default_root_dir=str(tmp_path / "jax"), **common)
    jt.fit(jm, JaxDataLoader(JaxArrayDataset(x, y), batch_size=8,
                             shuffle=True, use_native=False))
    tm = ViT(ViTConfig(**vcfg), lr=3e-3, device="cpu")
    tm.params = params_from_jax(init, device="cpu")
    tt = Trainer(device="cpu", accelerator=RayTPUAccelerator(1, tensor=2),
                 default_root_dir=str(tmp_path / "port"), **common)
    tt._world = world2
    tt.fit(tm, DataLoader(ArrayDataset(x, y), batch_size=8, shuffle=True))
    tt._world = None
    jl, tl = _history(jt, "train_loss"), _history(tt, "train_loss")
    assert len(tl) == len(jl) == 5
    for a, b in zip(tl, jl):
        assert a == pytest.approx(b, rel=1e-4)
    jp, tp = _flat(jax.device_get(jm.params)), _flat(tm.params)
    for name in jp:
        assert _rel_l2(tp[name], jp[name]) <= 1e-3, name
    shapes = tt.rank_report["state_shapes"]
    assert shapes["params/layers/attn/wq"] == [2, 32, 2, 8]
    assert shapes["params/layers/mlp/wi"] == [2, 32, 32]
    assert shapes["params/head"] == [32, 10]


def test_pickle_checkpoint_is_whole_and_resumes(world2, tmp_path):
    """A ``"pickle"`` checkpoint at tensor = 2 holds whole tensors (rank 0
    writes what every rank's slices gather to): ``load_from_checkpoint``
    gives the driver's params bit for bit, and a tensor = 2 fit resumed
    from it for a second epoch ends where an uninterrupted 2-epoch fit
    does, bit for bit (params and the moments restored from their whole
    tensors, each rank cutting its slices)."""
    acc = lambda: RayTPUAccelerator(1, tensor=2)  # noqa: E731
    t1, m1 = _port_gpt_fit(world2, tmp_path / "a", acc(),
                           enable_checkpointing=True)
    best = t1.checkpoint_callback.best_model_path
    loaded = GPT.load_from_checkpoint(best, device="cpu")
    for k, v in _flat(m1.params).items():
        np.testing.assert_array_equal(_flat(loaded.params)[k], v, k)
    t2, m2 = _port_gpt_fit(world2, tmp_path / "b", acc(), max_epochs=2)
    resumed = GPT(TransformerConfig(**CFG), device="cpu", lr=3e-3)
    t3 = Trainer(device="cpu", accelerator=acc(), max_epochs=2,
                 default_root_dir=str(tmp_path / "c"),
                 **{k: v for k, v in COMMON.items() if k != "max_epochs"})
    t3._world = world2
    t3.fit(resumed, DataLoader(ArrayDataset(DATA), batch_size=4,
                               shuffle=True), ckpt_path=best)
    t3._world = None
    assert t3.global_step == t2.global_step == 12
    for k, v in _flat(m2.params).items():
        np.testing.assert_array_equal(_flat(resumed.params)[k], v, k)


def test_trainer_without_accelerator_in_a_world_is_data_parallel(world2):
    """A ``Trainer`` with no accelerator fitting inside each rank of a
    formed world (``chip_smoke.py`` 9b's shape): the world is one data
    axis, each rank its own batch shard, one exchange a step, and both
    ranks end on the same weights."""
    r0, r1 = world2.run(torch_boring.dp_fit_body)
    assert r0["mesh"]["data"] == r1["mesh"]["data"] == 2
    assert (r0["batch_rank"], r1["batch_rank"]) == (0, 1)
    assert r0["all_reduces"] == r1["all_reduces"] == 2
    np.testing.assert_array_equal(r0["kernel"], r1["kernel"])
