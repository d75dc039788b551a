"""Port parity for the training extras on the CPU, where the port takes its
kernels' plain versions: int8 training matmuls (``_Int8SteMatmul`` and
``Trainer(int8_matmul=True)``), layer rematerialisation (``cfg.remat``
under each ``remat_policy``, with dropout, and ViT's), and the parameter
EMA (``utils/ema.py``, ``Trainer(ema_decay=, ema_eval=)``, checkpoints).
The same seeded numpy inputs and JAX-initialised weights
(``params_from_jax``) go through the JAX package and the port.  Everything
is float32; each tolerance is stated beside its check."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ray_lightning_accelerators_tpu import Accelerator, MeshConfig
from ray_lightning_accelerators_tpu import Trainer as JaxTrainer
from ray_lightning_accelerators_tpu.data.loader import (
    ArrayDataset as JaxArrayDataset, DataLoader as JaxDataLoader)
from ray_lightning_accelerators_tpu.models import vit as jvit
from ray_lightning_accelerators_tpu.models.transformer import (
    GPT as JaxGPT, TransformerConfig as JaxConfig,
    _int8_ste_matmul as jax_ste)
from ray_lightning_accelerators_tpu.utils.ema import (
    ema_params as jax_ema_params, ema_tracker as jax_ema_tracker)
from ray_lightning_accelerators_tpu_torch import (
    DataLoader, ModelCheckpoint, Trainer)
from ray_lightning_accelerators_tpu_torch.core.optim import (
    SGD, AdamW, Optimizer)
from ray_lightning_accelerators_tpu_torch.data.loader import ArrayDataset
from ray_lightning_accelerators_tpu_torch.models import vit
from ray_lightning_accelerators_tpu_torch.models.transformer import (
    GPT, TransformerConfig, _Int8SteMatmul)
from ray_lightning_accelerators_tpu_torch.utils import checkpoint as ckpt_lib
from ray_lightning_accelerators_tpu_torch.utils.weights import (
    params_from_jax)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

VOCAB, SEQ = 128, 32
CFG = dict(vocab_size=VOCAB, d_model=64, n_heads=2, d_ff=128, n_layers=2,
           max_seq_len=SEQ, loss_chunk_rows=40)
POLICIES = ["nothing", "dots", "dots_with_no_batch_dims", "everything"]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _tokens(n, seed=0):
    starts = np.random.default_rng(seed).integers(0, VOCAB, n)
    return ((starts[:, None] + np.arange(SEQ)[None]) % VOCAB).astype(np.int32)


@pytest.fixture(scope="module")
def jax_init():
    return jax.device_get(JaxGPT(JaxConfig(**CFG)).init_params(
        jax.random.PRNGKey(0)))


# ---------------------------------------------------------------------- #
# int8 training matmuls                                                   #
# ---------------------------------------------------------------------- #
def test_int8_ste_matmul_matches_jax():
    """Forward and both cotangents of ``_Int8SteMatmul`` against the JAX
    ``_int8_ste_matmul`` with its kernel (interpret mode) on the same x,
    w and cotangent.  Both compute ``(x @ q8) * scale`` with an f32 sum
    in other orders, and plain f32 products backward: 1e-5 relative L2
    on each."""
    rng = np.random.default_rng(3)
    w = rng.normal(size=(128, 256)).astype(np.float32)
    x = rng.normal(size=(8, 128)).astype(np.float32)
    g = rng.normal(size=(8, 256)).astype(np.float32)
    out, vjp = jax.vjp(lambda a, b: jax_ste("interpret", a, b),
                       jnp.asarray(x), jnp.asarray(w))
    jgx, jgw = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tout = _Int8SteMatmul.apply(tx, tw)
    gx, gw = torch.autograd.grad(tout, (tx, tw), torch.from_numpy(g))
    assert tout.dtype == torch.float32 and gw.dtype == torch.float32
    for a, b in ((tout, out), (gx, jgx), (gw, jgw)):
        assert _rel_l2(_np(a), np.asarray(b)) <= 1e-5
    # the forward's values are the int8-rounded weights', not w's
    assert _rel_l2(tout.detach().numpy(), x @ w) > 1e-4


def test_int8_training_forward_uses_the_ste_on_the_dense_mlp_only():
    """With ``int8_matmul`` the dense MLP's two products go through the
    straight-through product (the loss moves off the f32 one by the int8
    rounding, and every parameter still gets a gradient); an MoE model's
    experts stay dense, as in the JAX package."""
    toks = torch.from_numpy(_tokens(2, seed=1))
    for cfg, moves in ((CFG, True), ({**CFG, "num_experts": 4}, False)):
        m = GPT(TransformerConfig(**cfg), device="cpu")
        p = m.init_params(0)
        base = m.training_step(p, toks)[0].item()
        m.int8_matmul = True
        leaves = [t.requires_grad_() for t in _flat(p).values()]
        loss = m.training_step(p, toks)[0]
        assert (abs(loss.item() - base) > 1e-7) == moves
        grads = torch.autograd.grad(loss, leaves)
        assert all(float(g.abs().sum()) > 0 for g in grads)


def test_int8_trainer_matches_jax_trainer(jax_init, tmp_path):
    """5 optimizer steps of ``Trainer(int8_matmul=True)`` from the same
    weights against the JAX Trainer with the same flag (one device, f32,
    guard off): the 10-step parity's tolerances, the loss within 2e-4
    relative at every step and the final params within 1e-3 relative L2
    per leaf (int8-rounded products summed in other orders)."""
    data = _tokens(20, seed=5)
    common = dict(max_epochs=1, precision="f32", log_every_n_steps=1,
                  enable_checkpointing=False, seed=0, int8_matmul=True)
    jm = JaxGPT(JaxConfig(**CFG), lr=3e-3)
    jm.params = jax.tree.map(jnp.asarray, jax_init)
    jt = JaxTrainer(accelerator=Accelerator(MeshConfig(data=1)), guard=None,
                    prefetch_batches=0, cache_dataset_on_device=False,
                    default_root_dir=str(tmp_path / "jax"), **common)
    jt.fit(jm, JaxDataLoader(JaxArrayDataset(data), batch_size=4,
                             shuffle=True, use_native=False))
    tm = GPT(TransformerConfig(**CFG), device="cpu", lr=3e-3)
    tm.params = params_from_jax(jax_init, device="cpu")
    tt = Trainer(device="cpu", default_root_dir=str(tmp_path / "port"),
                 **common)
    tt.fit(tm, DataLoader(ArrayDataset(data), batch_size=4, shuffle=True))
    assert tm.int8_matmul and jm.int8_matmul
    jh = [r["train_loss"] for r in jt.logger.history if "train_loss" in r]
    th = [r["train_loss"] for r in tt.logger.history if "train_loss" in r]
    assert len(th) == len(jh) == 5
    for a, b in zip(th, jh):
        assert a == pytest.approx(b, rel=2e-4)
    jp = {k: np.asarray(v) for k, v in _flat(jax.device_get(jm.params)
                                             ).items()}
    for name, v in _flat(tm.params).items():
        assert _rel_l2(_np(v), jp[name]) <= 1e-3, name


# ---------------------------------------------------------------------- #
# remat                                                                   #
# ---------------------------------------------------------------------- #
def _loss_and_grads(cfg, params, toks, seed=1):
    m = GPT(TransformerConfig(**cfg), device="cpu")
    p = {k: v for k, v in params.items()}
    p = jax.tree.map(lambda t: t.detach().clone().requires_grad_(), p)
    leaves = _flat(p)
    loss, _ = m.training_step(p, toks, torch.Generator().manual_seed(seed))
    return loss.item(), torch.autograd.grad(loss, list(leaves.values()))


@pytest.mark.parametrize("moe", [False, True])
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_policies_match_no_remat(moe, policy):
    """The loss and every gradient under ``remat`` with each policy equal
    the run without it (tests/test_transformer.py:93), dense and with 4
    experts: the recompute repeats the forward's ops on the same inputs,
    so 1e-6 relative on the loss and 1e-6 absolute on the gradients."""
    cfg = {**CFG, **({"num_experts": 4} if moe else {})}
    params = GPT(TransformerConfig(**cfg), device="cpu").init_params(0)
    toks = torch.from_numpy(_tokens(2, seed=2))
    base_loss, base = _loss_and_grads(cfg, params, toks)
    loss, grads = _loss_and_grads(
        {**cfg, "remat": True, "remat_policy": policy}, params, toks)
    assert loss == pytest.approx(base_loss, rel=1e-6)
    for a, b in zip(grads, base):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


@pytest.mark.parametrize("policy,calls", [
    ("nothing", 4), ("dots", 4), ("dots_with_no_batch_dims", 4),
    ("everything", 2)])
def test_remat_recomputes_the_attention(monkeypatch, policy, calls):
    """Under "nothing" and the dots policies the backward reruns each
    layer's attention (the flash kernel on the card: it is not a product
    the policy keeps), so 2 layers call it 4 times a step; under
    "everything" twice."""
    seen = []
    real = GPT._attention

    def counting(self, q, k, v):
        seen.append(q.shape)
        return real(self, q, k, v)

    monkeypatch.setattr(GPT, "_attention", counting)
    cfg = {**CFG, "remat": True, "remat_policy": policy}
    params = GPT(TransformerConfig(**CFG), device="cpu").init_params(0)
    _loss_and_grads(cfg, params, torch.from_numpy(_tokens(2, seed=2)))
    assert len(seen) == calls


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_remat_with_dropout_matches_no_remat(policy):
    """Dropout 0.5 draws from the step's generator, which the
    checkpoint's RNG stash does not cover: the recompute must see the
    forward's masks.  Same generator seed, remat and no remat: the loss
    and every gradient within 1e-6 (an other mask would move them by
    ~1e-1)."""
    cfg = {**CFG, "dropout": 0.5, "num_experts": 4}
    params = GPT(TransformerConfig(**cfg), device="cpu").init_params(0)
    toks = torch.from_numpy(_tokens(2, seed=3))
    base_loss, base = _loss_and_grads(cfg, params, toks, seed=5)
    loss, grads = _loss_and_grads(
        {**cfg, "remat": True, "remat_policy": policy}, params, toks,
        seed=5)
    assert loss == pytest.approx(base_loss, rel=1e-6)
    for a, b in zip(grads, base):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    other, _ = _loss_and_grads(cfg, params, toks, seed=6)
    assert abs(other - base_loss) > 1e-4


def test_unknown_remat_policy_raises():
    m = GPT(TransformerConfig(**CFG, remat=True, remat_policy="bogus"),
            device="cpu")
    with pytest.raises(ValueError, match="remat_policy"):
        m.training_step(m.init_params(0), torch.from_numpy(_tokens(1)))


def test_remat_gpt_matches_jax(jax_init):
    """``remat`` with "dots" against the JAX GPT with the same policy, same
    weights: loss 1e-5 relative, each gradient leaf 1e-4 relative L2 (the
    no-remat parity's tolerances)."""
    cfg = {**CFG, "remat": True, "remat_policy": "dots"}
    toks = _tokens(4, seed=3)
    jm = JaxGPT(JaxConfig(**cfg))
    jl, jg = jax.value_and_grad(lambda p: jm.training_step(
        p, jnp.asarray(toks), jax.random.PRNGKey(0))[0])(
        jax.tree.map(jnp.asarray, jax_init))
    loss, grads = _loss_and_grads(cfg, params_from_jax(jax_init,
                                                       device="cpu"),
                                  torch.from_numpy(toks))
    assert loss == pytest.approx(float(jl), rel=1e-5)
    jflat = {k: np.asarray(v) for k, v in _flat(jax.device_get(jg)).items()}
    for name, g in zip(_flat(jax_init), grads):
        assert _rel_l2(g.numpy(), jflat[name]) <= 1e-4, name


def test_vit_remat_matches_vit_without_and_jax():
    """ViT with ``remat`` (every block checkpointed, nothing saved):
    logits and gradients equal the run without it (1e-6), and the logits
    the JAX ViT's with remat (1e-5, summation order)."""
    kw = dict(image_size=16, patch_size=4, channels=3, d_model=64,
              n_heads=2, d_ff=128, n_layers=2, n_classes=10)
    jp = jax.device_get(jvit.ViT(jvit.ViTConfig(**kw)).init_params(
        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 16, 16, 3)).astype(np.float32)
    y = rng.integers(0, 10, 4).astype(np.int32)
    out = {}
    for remat in (False, True):
        m = vit.ViT(vit.ViTConfig(**kw, remat=remat), device="cpu")
        p = jax.tree.map(lambda t: t.requires_grad_(),
                         params_from_jax(jp, device="cpu"))
        loss, _ = m.training_step(p, (torch.from_numpy(x),
                                      torch.from_numpy(y)))
        out[remat] = (m.forward(p, torch.from_numpy(x)).detach(),
                      torch.autograd.grad(loss, list(_flat(p).values())))
    np.testing.assert_allclose(out[True][0].numpy(), out[False][0].numpy(),
                               atol=1e-6)
    for a, b in zip(out[True][1], out[False][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    jl = jvit.ViT(jvit.ViTConfig(**kw, remat=True)).forward(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    np.testing.assert_allclose(out[True][0].numpy(), np.asarray(jl),
                               atol=1e-5)


# ---------------------------------------------------------------------- #
# EMA                                                                     #
# ---------------------------------------------------------------------- #
def test_ema_tracker_math_matches_optax():
    """tests/test_ema.py:17: sgd(0.5) then the tracker at decay 0.5 moves
    w 1 -> 0.5 and the shadow 1 -> 0.75, the same in both packages."""
    jtx = optax.chain(optax.sgd(0.5), jax_ema_tracker(decay=0.5))
    jparams = {"w": jnp.ones((4,))}
    jst = jtx.init(jparams)
    _, jst = jtx.update({"w": jnp.ones((4,))}, jst, jparams)
    p = [torch.ones(4)]
    opt = Optimizer(SGD(0.5), p, ema_decay=0.5)
    opt.step([torch.ones(4)])
    np.testing.assert_allclose(p[0].numpy(), 0.5)
    np.testing.assert_array_equal(opt.state["ema"][0].numpy(),
                                  np.asarray(jax_ema_params(jst)["w"]))
    np.testing.assert_allclose(opt.state["ema"][0].numpy(), 0.75)


@pytest.mark.parametrize("clip,accumulate", [(None, 1), (0.05, 1), (None, 2),
                                             (0.05, 3)])
def test_ema_shadow_matches_optax_over_steps(clip, accumulate):
    """Six steps of AdamW with the trainer's clipping, accumulation and
    the tracker (decay 0.9) against ``MultiSteps(chain(clip, adamw,
    ema_tracker))``: an accumulation micro-step leaves the shadow where
    it was (tests/test_ema.py:31), a window commit moves it.  f32
    elementwise in the same order: 1e-6 (as the optimizer parity)."""
    rng = np.random.default_rng(4)
    p0 = [rng.standard_normal((5, 3)).astype(np.float32),
          rng.standard_normal(7).astype(np.float32)]
    grads = [[rng.standard_normal(a.shape).astype(np.float32) for a in p0]
             for _ in range(6)]
    tx = optax.adamw(1e-2, weight_decay=0.01)
    if clip:
        tx = optax.chain(optax.clip_by_global_norm(clip), tx)
    tx = optax.chain(tx, jax_ema_tracker(0.9))
    if accumulate > 1:
        tx = optax.MultiSteps(tx, accumulate)
    jp = [jnp.asarray(a) for a in p0]
    st = tx.init(jp)
    tp = [torch.from_numpy(a.copy()) for a in p0]
    opt = Optimizer(AdamW(1e-2, weight_decay=0.01), tp, clip_norm=clip,
                    accumulate=accumulate, ema_decay=0.9)
    for i, g in enumerate(grads):
        before = [e.clone() for e in opt.state["ema"]]
        upd, st = tx.update([jnp.asarray(a) for a in g], st, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([torch.from_numpy(a) for a in g])
        moved = (i + 1) % accumulate == 0
        assert all(not torch.equal(a, b) for a, b in
                   zip(before, opt.state["ema"])) == moved
        for a, b in zip(opt.state["ema"], jax_ema_params(st)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)


def test_ema_eval_matches_jax_trainer(jax_init, tmp_path):
    """``Trainer(ema_decay=0.9, ema_eval=True)``: 10 steps with validation
    after each epoch, from the same weights, on both Trainers.  The
    shadow within 1e-3 relative L2 per leaf of the JAX one's (as the
    params in the 10-step parity), val_loss within 2e-4 relative, and
    val_loss is the shadow's: validating the raw params gives another."""
    data, val = _tokens(20, seed=5), _tokens(8, seed=6)
    common = dict(max_epochs=2, precision="f32", log_every_n_steps=1,
                  enable_checkpointing=False, seed=0, ema_decay=0.9,
                  ema_eval=True)
    jm = JaxGPT(JaxConfig(**CFG), lr=3e-3)
    jm.params = jax.tree.map(jnp.asarray, jax_init)
    jt = JaxTrainer(accelerator=Accelerator(MeshConfig(data=1)), guard=None,
                    prefetch_batches=0, cache_dataset_on_device=False,
                    default_root_dir=str(tmp_path / "jax"), **common)
    jt.fit(jm, JaxDataLoader(JaxArrayDataset(data), batch_size=4,
                             shuffle=True, use_native=False),
           JaxDataLoader(JaxArrayDataset(val), batch_size=4,
                         use_native=False))
    tm = GPT(TransformerConfig(**CFG), device="cpu", lr=3e-3)
    tm.params = params_from_jax(jax_init, device="cpu")
    tt = Trainer(device="cpu", default_root_dir=str(tmp_path / "port"),
                 **common)
    vl = DataLoader(ArrayDataset(val), batch_size=4)
    tt.fit(tm, DataLoader(ArrayDataset(data), batch_size=4, shuffle=True),
           vl)
    jema = {k: np.asarray(v) for k, v in _flat(jax.device_get(
        jt.ema_params())).items()}
    tema = _flat(tt.ema_params())
    assert jema.keys() == tema.keys()
    for name, v in tema.items():
        assert _rel_l2(_np(v), jema[name]) <= 1e-3, name
        assert not torch.equal(v, _flat(tt._state.params)[name]), name
    assert tt.callback_metrics["val_loss"] == pytest.approx(
        float(jt.callback_metrics["val_loss"]), rel=2e-4)
    raw = tt._run_eval(vl, tm.validation_step,
                       {k: v for k, v in tt.ema_params().items()})
    assert raw["val_loss"] == pytest.approx(
        tt.callback_metrics["val_loss"], rel=1e-6)
    tt.ema_eval = False
    raw = tt._run_eval(vl, tm.validation_step, tt._state.params)
    assert abs(raw["val_loss"] - tt.callback_metrics["val_loss"]) > 1e-4


def test_ema_checkpoint_round_trip_keeps_the_shadow(jax_init, tmp_path):
    """The shadow rides in the checkpoint's optimizer state: a fit resumed
    from the epoch-1 checkpoint ends with the same shadow as an
    uninterrupted 2-epoch fit (1e-5 relative L2: two identical CPU fits
    differ by threaded-reduction ulps), and a checkpoint without a shadow
    restores into an EMA trainer with the shadow at the restored
    params."""
    data = _tokens(16, seed=6)

    def loader():
        return DataLoader(ArrayDataset(data), batch_size=4, shuffle=True)

    def model():
        m = GPT(TransformerConfig(**CFG), device="cpu")
        m.params = params_from_jax(jax_init, device="cpu")
        return m

    kw = dict(device="cpu", precision="f32", ema_decay=0.8)
    full = Trainer(max_epochs=2, default_root_dir=str(tmp_path / "full"),
                   **kw)
    full.fit(model(), loader())
    ckpt = ModelCheckpoint(monitor=None)
    first = Trainer(max_epochs=1, callbacks=[ckpt],
                    default_root_dir=str(tmp_path / "a"), **kw)
    first.fit(model(), loader())
    payload = ckpt_lib.read_checkpoint(ckpt.best_model_path)
    assert len(payload["state"]["opt_state"]["ema"]) == len(
        _flat(jax_init))
    resumed = Trainer(max_epochs=2, default_root_dir=str(tmp_path / "b"),
                      **kw)
    resumed.fit(model(), loader(), ckpt_path=ckpt.best_model_path)
    want = _flat(full.ema_params())
    for name, v in _flat(resumed.ema_params()).items():
        assert _rel_l2(_np(v), _np(want[name])) <= 1e-5, name

    plain = Trainer(max_epochs=1, device="cpu", precision="f32",
                    callbacks=[ModelCheckpoint(monitor=None)],
                    default_root_dir=str(tmp_path / "plain"))
    plain.fit(model(), loader())
    later = Trainer(max_epochs=1, default_root_dir=str(tmp_path / "c"),
                    **kw)
    later.fit(model(), loader(),
              ckpt_path=plain.checkpoint_callback.best_model_path)
    for name, v in _flat(later.ema_params()).items():
        assert torch.equal(v, _flat(plain.module.params)[name]), name


def test_ema_arguments_validate_as_jax():
    with pytest.raises(ValueError, match="ema_decay"):
        Trainer(device="cpu", ema_eval=True)
    for bad in (0.0, 1.0, -0.5, 1.5):
        with pytest.raises(ValueError, match="ema_decay"):
            Trainer(device="cpu", ema_decay=bad)
    assert Trainer(device="cpu").ema_params() is None
