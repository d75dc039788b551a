"""Port parity for single-card GPT training on the CPU, where the port
takes its kernels' plain versions: the same seeded numpy inputs and the
same JAX-initialised weights (``params_from_jax``) go through the JAX
package and the PyTorch port.  Covered: ``rms_norm``'s gradients, the
streaming fused LM-head loss (loss, accuracy, dh, dw with label smoothing,
z-loss and masked targets), GPT's ``_lm_loss`` and its gradients, the
optimizer (AdamW, clipping, accumulation), the schedules, the shuffled
loader, a 10-step ``Trainer.fit`` trajectory against the JAX ``Trainer``,
and the checkpoint round trip.  Everything is float32; each tolerance is
stated beside its check."""

import time

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
from ray_lightning_accelerators_tpu.models.transformer import (
    GPT as JaxGPT, TransformerConfig as JaxConfig)
from ray_lightning_accelerators_tpu.ops import losses as jax_losses
from ray_lightning_accelerators_tpu.ops.norms import rms_norm as jax_rms
from ray_lightning_accelerators_tpu.utils import schedules as jax_sched
from ray_lightning_accelerators_tpu_torch import (
    DataLoader, EarlyStopping, ModelCheckpoint, RayTPUAccelerator, Trainer)
from ray_lightning_accelerators_tpu_torch.core.optim import (
    AdamW, Optimizer)
from ray_lightning_accelerators_tpu_torch.data.loader import ArrayDataset
from ray_lightning_accelerators_tpu_torch.models.transformer import (
    GPT, TransformerConfig)
from ray_lightning_accelerators_tpu_torch.ops import losses, norms
from ray_lightning_accelerators_tpu_torch.utils import schedules
from ray_lightning_accelerators_tpu_torch.utils.weights import (
    params_from_jax)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

VOCAB, SEQ = 128, 64
# 2 layers, d 128, head_dim 64; loss chunks of 100 rows, so the 4 x 63
# target rows of a batch stream as 3 chunks, the last one ragged
CFG = dict(vocab_size=VOCAB, d_model=128, n_heads=2, d_ff=256, n_layers=2,
           max_seq_len=SEQ, loss_chunk_rows=100)


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree.detach().numpy()
                               if isinstance(tree, torch.Tensor) else tree)}


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def jax_init():
    return jax.device_get(JaxGPT(JaxConfig(**CFG)).init_params(
        jax.random.PRNGKey(0)))


def _tokens(n, seed=0):
    """A learnable pattern: each row counts up from a random start."""
    starts = np.random.default_rng(seed).integers(0, VOCAB, n)
    return ((starts[:, None] + np.arange(SEQ)[None]) % VOCAB).astype(np.int32)


# ---------------------------------------------------------------------- #
# ops                                                                     #
# ---------------------------------------------------------------------- #
def test_rms_norm_grads_match_jax():
    """dx and dscale of the port's rms_norm against the VJP of the JAX
    rms_norm, same seeded inputs and cotangent.  f32 on both sides:
    summation order only; 1e-5 relative and absolute."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 128)).astype(np.float32)
    s = (1 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    g = rng.standard_normal((3, 5, 128)).astype(np.float32)
    _, vjp = jax.vjp(jax_rms, jnp.asarray(x), jnp.asarray(s))
    jdx, jds = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    ts = torch.from_numpy(s).requires_grad_()
    dx, ds = torch.autograd.grad(norms.rms_norm(tx, ts), (tx, ts),
                                 torch.from_numpy(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ds.numpy(), np.asarray(jds), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("label_smoothing,z_loss,masked", [
    (0.0, 0.0, False), (0.1, 0.0, True), (0.0, 1e-3, True),
    (0.1, 1e-3, False)])
def test_fused_loss_matches_jax(label_smoothing, z_loss, masked):
    """Loss, accuracy, dh and dw of the streaming loss (chunks of 48 over
    200 rows: the last chunk ragged) against the JAX op.  f32: both sides
    reduce the same f32 logits in different orders; 1e-5 relative on the
    loss, 2e-5 on the gradients (absolute, against entries of ~1e-3), and
    the accuracy equal."""
    rng = np.random.default_rng(2)
    h = rng.standard_normal((200, 128)).astype(np.float32)
    w = (0.1 * rng.standard_normal((128, VOCAB))).astype(np.float32)
    t = rng.integers(0, VOCAB, 200).astype(np.int32)
    if masked:
        t[::7] = -1

    def jloss(hh, ww):
        return jax_losses.fused_linear_cross_entropy(
            hh, ww, jnp.asarray(t), 48, label_smoothing=label_smoothing,
            z_loss=z_loss)

    (jl, ja), (jdh, jdw) = jax.value_and_grad(jloss, argnums=(0, 1),
                                              has_aux=True)(
        jnp.asarray(h), jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tl, ta = losses.fused_linear_cross_entropy(
        th, tw, torch.from_numpy(t), 48, label_smoothing=label_smoothing,
        z_loss=z_loss)
    dh, dw = torch.autograd.grad(tl, (th, tw))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    assert ta.item() == pytest.approx(float(ja), abs=1e-7)
    np.testing.assert_allclose(dh.numpy(), np.asarray(jdh), atol=2e-5)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), atol=2e-5)
    if not (label_smoothing or z_loss):
        # the materialised reference gives the same loss and accuracy
        rl, ra = losses.linear_cross_entropy_reference(
            th.detach(), tw.detach(), torch.from_numpy(t))
        jrl, jra = jax_losses.linear_cross_entropy_reference(
            jnp.asarray(h), jnp.asarray(w), jnp.asarray(t))
        np.testing.assert_allclose(rl.item(), float(jrl), rtol=1e-5)
        np.testing.assert_allclose(rl.item(), tl.item(), rtol=1e-5)
        assert ra.item() == pytest.approx(float(jra), abs=1e-7)


def test_fused_loss_takes_a_batch_axes_mesh():
    """``mesh=`` with only batch (and expert) axes is the rank's local
    call, as the JAX package's batch-axes path; a tensor or sequence axis
    takes the vocab-parallel materialised loss instead."""
    from ray_lightning_accelerators_tpu_torch.parallel.mesh import Mesh
    rng = np.random.default_rng(3)
    h = torch.from_numpy(rng.standard_normal((6, 4)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 5)).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, 5, 6))
    want = losses.fused_linear_cross_entropy(h, w, t, 4)
    for axes in ({"data": 2}, {"fsdp": 2, "expert": 2}):
        got = losses.fused_linear_cross_entropy(h, w, t, 4, mesh=Mesh(axes))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    for axes in ({"tensor": 2}, {"data": 2, "sequence": 2}):
        with pytest.raises(ValueError, match="vocab_parallel"):
            losses.fused_linear_cross_entropy(h, w, t, 4, mesh=Mesh(axes))


# ---------------------------------------------------------------------- #
# model                                                                   #
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("fused_loss", [True, False])
def test_gpt_lm_loss_and_grads_match_jax(jax_init, fused_loss):
    """GPT's training loss and the gradient of every parameter leaf, from
    the same JAX-initialised weights and tokens.  f32 through 2 layers:
    summation order only; loss 1e-5 relative, each gradient leaf 1e-4
    relative L2."""
    cfg = {**CFG, "fused_loss": fused_loss}
    toks = _tokens(4, seed=3)
    jm = JaxGPT(JaxConfig(**cfg))
    (jl, jmet), jg = jax.value_and_grad(
        lambda p: jm.training_step(p, jnp.asarray(toks),
                                   jax.random.PRNGKey(0)),
        has_aux=True)(jax.tree.map(jnp.asarray, jax_init))
    tm = GPT(TransformerConfig(**cfg), device="cpu")
    tp = jax.tree.map(lambda a: a, params_from_jax(jax_init, device="cpu"))
    leaves = {k: v.requires_grad_() for k, v in _flat_tensors(tp).items()}
    tl, tmet = tm.training_step(tp, torch.from_numpy(toks))
    grads = torch.autograd.grad(tl, list(leaves.values()))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    assert tmet["accuracy"].item() == pytest.approx(
        float(jmet["accuracy"]), abs=1e-6)
    jflat = _flat(_tree_np(jg))
    for (name, _), g in zip(leaves.items(), grads):
        assert _rel_l2(g.numpy(), jflat[name]) <= 1e-4, name


def _flat_tensors(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_tensors(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_gpt_training_refusals_and_dropout():
    cfg = TransformerConfig(**CFG)
    m = GPT(cfg, device="cpu")
    p = m.init_params(0)
    toks = torch.from_numpy(_tokens(2))
    # remat and int8 training matmuls run (tests/test_torch_training_
    # extras.py holds them against the JAX package); an unknown remat
    # policy is a ValueError, as there
    assert torch.equal(GPT(TransformerConfig(**CFG, remat=True),
                           device="cpu").forward(p, toks),
                       m.forward(p, toks))
    m.int8_matmul = True
    assert torch.isfinite(m.forward(p, toks)).all()
    m.int8_matmul = False
    with pytest.raises(ValueError, match="remat_policy"):
        GPT(TransformerConfig(**CFG, remat=True, remat_policy="bogus"),
            device="cpu").forward(p, toks)
    # dropout draws from the step's generator: same seed, same output
    dm = GPT(TransformerConfig(**CFG, dropout=0.5), device="cpu")
    runs = [dm.forward(p, toks, dropout_rng=torch.Generator().manual_seed(s))
            for s in (1, 1, 2)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    assert torch.equal(dm.forward(p, toks), m.__class__(
        cfg, device="cpu").forward(p, toks))


# ---------------------------------------------------------------------- #
# optimizer, schedules, loader                                            #
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("clip,accumulate", [(None, 1), (0.05, 1), (1e3, 2),
                                             (0.05, 3)])
def test_optimizer_matches_optax(clip, accumulate):
    """Six steps of AdamW (weight decay 0.01, a warmup-cosine schedule)
    with the trainer's clipping and accumulation against optax's
    ``MultiSteps(chain(clip_by_global_norm, adamw))``: f32 elementwise
    arithmetic in the same order, the bias corrections and the lr rounded
    differently (f64 here, f32 there): 1e-6 absolute and relative on
    entries of order 1."""
    rng = np.random.default_rng(4)
    p0 = [rng.standard_normal((5, 3)).astype(np.float32),
          rng.standard_normal(7).astype(np.float32)]
    grads = [[rng.standard_normal(a.shape).astype(np.float32) for a in p0]
             for _ in range(6)]
    sched_kw = dict(peak_lr=1e-2, total_steps=10, warmup_steps=2)
    tx = optax.adamw(jax_sched.warmup_cosine(**sched_kw), weight_decay=0.01)
    if clip:
        tx = optax.chain(optax.clip_by_global_norm(clip), tx)
    if accumulate > 1:
        tx = optax.MultiSteps(tx, accumulate)
    jp = [jnp.asarray(a) for a in p0]
    st = tx.init(jp)
    tp = [torch.from_numpy(a.copy()) for a in p0]
    opt = Optimizer(AdamW(schedules.warmup_cosine(**sched_kw),
                          weight_decay=0.01), tp, clip_norm=clip,
                    accumulate=accumulate)
    for g in grads:
        upd, st = tx.update([jnp.asarray(a) for a in g], st, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([torch.from_numpy(a) for a in g])
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("name,args", [
    ("warmup_cosine", (1e-3, 20, 5, 1e-5)), ("warmup_linear", (1e-3, 20, 5)),
    ("step_decay", (1e-3, {5: 0.5, 10: 0.1})), ("inverse_sqrt", (1e-3, 5)),
    ("wsd", (1e-3, 20, 3, 5, 1e-5)), ("constant", (3e-4,))])
def test_schedules_match_jax(name, args):
    """Each schedule at steps 0..24 against the JAX package's (f32 there,
    f64 here): 1e-6 relative."""
    j, t = getattr(jax_sched, name)(*args), getattr(schedules, name)(*args)
    for s in range(25):
        assert t(s) == pytest.approx(float(j(jnp.int32(s))), rel=1e-6,
                                     abs=1e-12)


def test_shuffled_loader_matches_jax():
    """The shuffled batches, epoch by epoch, equal the JAX loader's."""
    data = _tokens(20)
    ours = DataLoader(ArrayDataset(data), batch_size=6, shuffle=True, seed=3)
    theirs = JaxDataLoader(JaxArrayDataset(data), batch_size=6, shuffle=True,
                           seed=3, use_native=False)
    for epoch in range(3):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        a, b = list(ours), list(theirs)
        assert len(a) == len(b) == len(ours) == 3
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------- #
# the slice: Trainer.fit against the JAX Trainer                          #
# ---------------------------------------------------------------------- #
def test_fit_trajectory_matches_jax_trainer(jax_init, tmp_path):
    """10 optimizer steps (2 epochs of 5 shuffled batches of 4) from the
    same weights, with a warmup-cosine schedule and gradient clipping, on
    the JAX Trainer (one device, f32, guard off) and the port's.  f32:
    the two differ by summation order, compounding over the steps;
    measured ~1e-6.  Limits: the loss within 2e-4 relative at every
    step, the final params within 1e-3 relative L2 per leaf."""
    data = _tokens(20, seed=5)
    sched_kw = dict(peak_lr=3e-3, total_steps=10, warmup_steps=3)
    common = dict(max_epochs=2, precision="f32", log_every_n_steps=1,
                  gradient_clip_val=0.5, log_grad_norm=True,
                  enable_checkpointing=False, seed=0)

    jm = JaxGPT(JaxConfig(**CFG), lr=jax_sched.warmup_cosine(**sched_kw))
    jm.params = jax.tree.map(jnp.asarray, jax_init)
    jt = JaxTrainer(accelerator=Accelerator(MeshConfig(data=1)), guard=None,
                    prefetch_batches=0, cache_dataset_on_device=False,
                    default_root_dir=str(tmp_path / "jax"), **common)
    jt.fit(jm, JaxDataLoader(JaxArrayDataset(data), batch_size=4,
                             shuffle=True, use_native=False))

    tm = GPT(TransformerConfig(**CFG), device="cpu",
             lr=schedules.warmup_cosine(**sched_kw))
    tm.params = params_from_jax(jax_init, device="cpu")
    tt = Trainer(device="cpu", default_root_dir=str(tmp_path / "port"),
                 **common)
    tt.fit(tm, DataLoader(ArrayDataset(data), batch_size=4, shuffle=True))

    jh = [r for r in jt.logger.history if "train_loss" in r]
    th = [r for r in tt.logger.history if "train_loss" in r]
    assert [r["step"] for r in th] == [r["step"] for r in jh] == \
        list(range(1, 11))
    for a, b in zip(th, jh):
        assert a["train_loss"] == pytest.approx(b["train_loss"], rel=2e-4)
        assert a["lr"] == pytest.approx(b["lr"], rel=1e-6)
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=1e-3)
    assert th[-1]["train_loss"] < th[0]["train_loss"]
    jp, tp = _flat(_tree_np(jm.params)), _flat(tm.params)
    assert jp.keys() == tp.keys()
    for name in jp:
        assert _rel_l2(tp[name], jp[name]) <= 1e-3, name


def test_checkpoint_round_trip_and_resume(jax_init, tmp_path):
    """ModelCheckpoint -> load_from_checkpoint -> validate gives the fitted
    module's metrics; fit(ckpt_path=...) resumed from the epoch-1
    checkpoint ends on the same params as an uninterrupted 2-epoch fit
    (same batches, same restored optimizer state).  Two identical fits on
    the CPU already differ by a few ulps (threaded reductions: measured
    3e-8 on entries of ~1e-2), so the limit is 1e-5 relative L2."""
    data, val = _tokens(16, seed=6), _tokens(8, seed=7)

    def loader():
        return DataLoader(ArrayDataset(data), batch_size=4, shuffle=True)

    def model():
        m = GPT(TransformerConfig(**CFG), device="cpu")
        m.params = params_from_jax(jax_init, device="cpu")
        return m

    full = model()
    Trainer(device="cpu", precision="f32", max_epochs=2,
            default_root_dir=str(tmp_path / "full")).fit(full, loader())

    first = model()
    ckpt = ModelCheckpoint(monitor="val_loss", save_top_k=2)
    t1 = Trainer(device="cpu", precision="f32", max_epochs=1,
                 callbacks=[ckpt, EarlyStopping(patience=5)],
                 default_root_dir=str(tmp_path / "a"))
    t1.fit(first, loader(), DataLoader(ArrayDataset(val), batch_size=4))
    assert ckpt.best_model_path.endswith("epoch=0-step=4.ckpt")
    loaded = GPT.load_from_checkpoint(ckpt.best_model_path, device="cpu")
    assert loaded.cfg == first.cfg and loaded.lr == first.lr
    evaluator = Trainer(device="cpu", precision="f32")
    (metrics,) = evaluator.validate(
        loaded, DataLoader(ArrayDataset(val), batch_size=4))
    assert metrics["val_loss"] == pytest.approx(
        t1.callback_metrics["val_loss"], rel=1e-6)
    (tested,) = evaluator.test(loaded, DataLoader(ArrayDataset(val),
                                                  batch_size=4))
    assert tested.keys() == metrics.keys()
    for k, v in metrics.items():
        assert tested[k] == pytest.approx(v, rel=1e-6), k
    preds = evaluator.predict(loaded, DataLoader(ArrayDataset(val),
                                                 batch_size=4))
    assert [tuple(p.shape) for p in preds] == [(4, SEQ, VOCAB)] * 2

    resumed = model()
    t2 = Trainer(device="cpu", precision="f32", max_epochs=2,
                 default_root_dir=str(tmp_path / "b"))
    t2.fit(resumed, loader(), ckpt_path=ckpt.best_model_path)
    assert t2.global_step == 8 and t2.epochs_completed == 2
    for name, a in _flat(full.params).items():
        assert _rel_l2(_flat(resumed.params)[name], a) <= 1e-5, name
    # "last" resumes from the newest checkpoint under the run dir
    t3 = Trainer(device="cpu", precision="f32", max_epochs=3,
                 default_root_dir=str(tmp_path / "b"))
    t3.fit(model(), loader(), ckpt_path="last")
    assert t3.global_step == 12


@pytest.mark.parametrize("kwargs,slice_name", [
    pytest.param(dict(accelerator=RayTPUAccelerator(2, pipeline=2,
                                                    expert=2, sequence=2)),
                 "GPT raises on this mesh", id="kwargs0-multi-GPU 4c-ii"),
    pytest.param(dict(accelerator=RayTPUAccelerator(2, pipeline=2,
                                                    tensor=2, sequence=2)),
                 "GPT raises on this mesh", id="kwargs2-multi-GPU 4c-ii"),
    pytest.param(dict(accelerator=RayTPUAccelerator(1, pipeline=2,
                                                    sequence=2)),
                 "GPT raises on this mesh", id="kwargs3-multi-GPU"),
    pytest.param(dict(accelerator=RayTPUAccelerator(2, dcn_data=2)),
                 None, id="kwargs4-multi-GPU 4c-ii"),
    pytest.param(dict(accelerator=RayTPUAccelerator(2, pipeline=2),
                      seq_parallel=2), "GPT raises on this mesh",
                 id="kwargs5-multi-GPU"),
    pytest.param(dict(accelerator=RayTPUAccelerator(2, dcn_pipeline=2)),
                 None, id="kwargs6-multi-GPU 4c-ii"),
])
def test_trainer_refuses_later_slices(kwargs, slice_name):
    """The pipeline axis with the sequence axis stays refused (the JAX
    GPT raises on that mesh).  Multi-slice meshes (``dcn_data`` /
    ``dcn_pipeline``) are accepted; without host agents the world is one
    granule, so the mesh of two DCN groups raises ``ValueError``, as the
    JAX package's ``build_hybrid_mesh`` does."""
    if slice_name is None:
        t = Trainer(device="cpu", **kwargs)
        assert t.accelerator.world_size == 4
        with pytest.raises(ValueError, match="slices 1"):
            t.accelerator.build_mesh()
        return
    with pytest.raises(NotImplementedError, match=slice_name):
        Trainer(device="cpu", **kwargs)


# gather_mode="scan" resolves as the JAX Trainer's _resolve_gather_mode:
# the engaged case (below) trains the per-layer gather; the fall-backs
# train as the tree gather (tests/test_torch_fsdp.py holds them against
# the JAX Trainer and the tree run over 2 ranks; tests/test_torch_scan_
# gather.py the engaged case against JAX's builders and Trainer);
# autotune_step scores them finite (below)
@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_engaged_scan_gather_raises_naming_4e(tmp_path, mode):
    """(The name is the refusal this test held until 4e was ported.)
    The compressed-FSDP regime with the GPT's fsdp-sharded layer stack
    (``scanned_param_subtrees``) is the one case the JAX Trainer engages
    the in-scan gather; the port's fit runs it over 2 ranks: the wire
    report says ``"scan"``, each rank gathered and reduce-scattered each
    of the 2 layers once a step, and the loss is finite."""
    t = Trainer(device="cpu", accelerator=RayTPUAccelerator(2, use_fsdp=True),
                grad_compression=mode, gather_mode="scan", precision="f32",
                max_steps=2, enable_checkpointing=False,
                default_root_dir=str(tmp_path))
    try:
        t.fit(GPT(TransformerConfig(**CFG), device="cpu"),
              DataLoader(ArrayDataset(_tokens(8)), batch_size=4))
    finally:
        t.shutdown_workers()
    assert t.comms_per_step["gather_mode"] == "scan"
    assert t.rank_report["layer_collectives"] == {"all_gather": 4,
                                                  "reduce_scatter": 4}
    assert np.isfinite(float(t.callback_metrics["train_loss"]))


def test_autotune_scores_a_fallen_back_scan_config_finite(tmp_path):
    """A scan config the JAX Trainer trains as the tree gather (here a
    one-device fit: no compressed-FSDP regime) now fits in the port, so
    ``autotune_step`` scores it finite, as JAX's does."""
    from ray_lightning_accelerators_tpu_torch import tune
    from ray_lightning_accelerators_tpu_torch.tune.search import choice

    data = _tokens(8)

    def measure(config):
        t = Trainer(device="cpu", precision="f32", max_steps=2,
                    gather_mode=config["gather_mode"],
                    enable_checkpointing=False, prefetch_batches=0,
                    default_root_dir=str(tmp_path))
        t0 = time.perf_counter()
        t.fit(GPT(TransformerConfig(**CFG), device="cpu"),
              DataLoader(ArrayDataset(data), batch_size=4))
        assert t._gather_mode_eff == "tree"
        return time.perf_counter() - t0

    out = tune.autotune_step(measure, space={"gather_mode": choice(["scan"])},
                             default_config={"gather_mode": "tree"},
                             n_trials=2, seed=0)
    modes = [r["config"]["gather_mode"] for r in out["trials"]]
    assert modes == ["tree", "scan"]
    assert all(np.isfinite(r["step_time_s"]) for r in out["trials"])


def test_trainer_attaches_the_perf_observatory():
    """``perf_observatory=True`` builds one (timeline, HBM ledger,
    goodput); an observatory object is taken as given; a profiler is
    kept as the trainer's."""
    from ray_lightning_accelerators_tpu_torch.telemetry.perf import (
        PerfObservatory)
    from ray_lightning_accelerators_tpu_torch.utils.profiler import Profiler
    t = Trainer(device="cpu", perf_observatory=True)
    assert isinstance(t.perf, PerfObservatory)
    obs, prof = PerfObservatory(), Profiler()
    t2 = Trainer(device="cpu", perf_observatory=obs, profiler=prof)
    assert t2.perf is obs and t2.profiler is prof
    assert Trainer(device="cpu").perf is None


def test_trainer_takes_host_agents():
    """Host agents are ported: ``agents=`` with ``num_hosts == 1`` still
    fans out over them (the launch plan names the agents and places the
    ranks in contiguous blocks, each on its index among its host's
    ranks)."""
    acc = RayTPUAccelerator(3, agents=["127.0.0.1:7001", "127.0.0.1:7002"])
    Trainer(device="cpu", accelerator=acc)
    spec = acc.launch_spec()
    assert spec["agents"] == ["127.0.0.1:7001", "127.0.0.1:7002"]
    assert spec["num_processes"] == 3
    assert acc.placement() == ["127.0.0.1:7001"] * 2 + ["127.0.0.1:7002"]
    acc.device_type = "cuda"
    assert acc.select_devices() == [torch.device("cuda", i)
                                    for i in (0, 1, 0)]


def test_trainer_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer()
