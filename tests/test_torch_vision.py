"""Port parity for the vision model families on the CPU, where the port
takes its kernels' plain versions: the MNIST MLP, CIFAR ResNet-18 and
ViT, their data (the IDX and CIFAR-10 parsers, the synthetic sets), the
SGD optimizer, and a 5-step ``Trainer.fit(datamodule=...)`` per model
against the JAX ``Trainer``.  The same seeded numpy inputs and the same
JAX-initialised weights (``params_from_jax``) go through both packages.
Everything is float32; each tolerance is stated beside its check."""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
import optax

from ray_lightning_accelerators_tpu import Accelerator, MeshConfig
from ray_lightning_accelerators_tpu import Trainer as JaxTrainer
from ray_lightning_accelerators_tpu.data import vision as jvision
from ray_lightning_accelerators_tpu.models import mnist as jmnist
from ray_lightning_accelerators_tpu.models import resnet as jresnet
from ray_lightning_accelerators_tpu.models import vit as jvit
from ray_lightning_accelerators_tpu_torch import ModelCheckpoint, Trainer
from ray_lightning_accelerators_tpu_torch.core.optim import SGD, Optimizer
from ray_lightning_accelerators_tpu_torch.data import vision
from ray_lightning_accelerators_tpu_torch.models import mnist, resnet, vit
from ray_lightning_accelerators_tpu_torch.utils.weights import (
    params_from_jax)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

MNIST_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                         "mnist")
MNIST_CFG = {"layer_1": 32, "layer_2": 64, "lr": 1e-3}
# lr 0.01, bench.py bench_cifar's: at 0.05 a 5-step SGD run of this tiny
# net is unstable (loss 4.0 -> 8.4 -> 1.9) and amplifies f32 rounding
# differences between any two implementations 500x in two steps
RESNET_CFG = {"width": 8, "lr": 0.01}
VIT_CFG = dict(image_size=16, patch_size=4, d_model=64, n_heads=2, d_ff=128,
               n_layers=2, n_classes=10)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().numpy()
    return {prefix: np.asarray(tree)}


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _models(name):
    """(JAX module, port module on the CPU, JAX-initialised numpy params)."""
    if name == "mnist":
        jm = jmnist.MNISTClassifier(MNIST_CFG)
        tm = mnist.MNISTClassifier(MNIST_CFG, device="cpu")
    elif name == "resnet":
        jm = jresnet.ResNet18(RESNET_CFG)
        tm = resnet.ResNet18(RESNET_CFG, device="cpu")
    else:
        jm = jvit.ViT(jvit.ViTConfig(**VIT_CFG))
        tm = vit.ViT(vit.ViTConfig(**VIT_CFG), device="cpu")
    return jm, tm, _np_tree(jm.init_params(jax.random.PRNGKey(0)))


def _batch(name, n=8, seed=0):
    if name == "mnist":
        return mnist.synthetic_mnist(n, seed)
    x, y = resnet.synthetic_cifar10(n, seed)
    return (x[:, 8:24, 8:24] if name == "vit" else x), y


# ---------------------------------------------------------------------- #
# data                                                                    #
# ---------------------------------------------------------------------- #
def test_load_mnist_matches_jax_bitwise():
    """The committed real-MNIST subset parses to the same arrays, both
    splits, in both packages."""
    for split in ("train", "test"):
        (x, y), (jx, jy) = (vision.load_mnist(MNIST_DIR, split),
                            jvision.load_mnist(MNIST_DIR, split))
        assert x.dtype == jx.dtype == np.float32 and y.dtype == jy.dtype
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
    assert vision.load_mnist(os.path.dirname(MNIST_DIR)) is None


def test_cifar_binary_parser_matches_jax_bitwise(tmp_path):
    """A CIFAR-10 binary batch (random records in the real layout)
    parses to the same NHWC arrays in both packages; a torn file raises
    in both."""
    rng = np.random.default_rng(0)
    recs = rng.integers(0, 256, (7, 3073)).astype(np.uint8)
    recs[:, 0] %= 10
    d = tmp_path / "cifar-10-batches-bin"
    d.mkdir()
    for name in ("data_batch_1.bin", "data_batch_2.bin", "test_batch.bin"):
        recs.tofile(d / name)
    for split in ("train", "test"):
        (x, y), (jx, jy) = (vision.load_cifar10(str(tmp_path), split),
                            jvision.load_cifar10(str(tmp_path), split))
        assert x.shape == jx.shape and x.shape[1:] == (32, 32, 3)
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
    recs.reshape(-1)[:-5].tofile(d / "data_batch_1.bin")
    for mod in (vision, jvision):
        with pytest.raises(ValueError, match="not a multiple"):
            mod.read_cifar_batch(str(d / "data_batch_1.bin"))


def test_synthetic_sets_match_jax_bitwise():
    for ours, theirs in ((mnist.synthetic_mnist, jmnist.synthetic_mnist),
                         (resnet.synthetic_cifar10,
                          jresnet.synthetic_cifar10)):
        for seed in (0, 3):
            (x, y), (jx, jy) = ours(64, seed), theirs(64, seed)
            np.testing.assert_array_equal(x, jx)
            np.testing.assert_array_equal(y, jy)


# ---------------------------------------------------------------------- #
# forward and gradients                                                   #
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("name,layout", [("mnist", "nhwc"),
                                         ("resnet", "nhwc"),
                                         ("resnet", "nchw"), ("vit", "nhwc")])
def test_forward_and_loss_grads_match_jax(name, layout):
    """f32 logits of the same weights and images, and the gradient of
    the training loss for every parameter leaf against ``jax.grad``.
    Summation order only: MNIST and ViT logits 1e-5 absolute, ResNet's
    (eight conv blocks, GroupNorm) 1e-5 relative L2; every gradient leaf
    1e-4 relative L2; the loss 1e-5 relative."""
    jm, tm, init = _models(name)
    x, y = _batch(name)
    if layout == "nchw":
        x = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
    jp = jax.tree.map(jnp.asarray, init)
    jlogits = np.asarray(jax.jit(jm.forward)(jp, jnp.asarray(x)))
    tp = params_from_jax(init, device="cpu")
    leaves = _flat_leaves(tp)
    for t in leaves.values():
        t.requires_grad_()
    logits = tm.forward(tp, torch.from_numpy(x))
    assert logits.dtype == torch.float32 and logits.shape == (8, 10)
    if name == "resnet":
        assert _rel_l2(logits.detach().numpy(), jlogits) <= 1e-5
    else:
        np.testing.assert_allclose(logits.detach().numpy(), jlogits,
                                   atol=1e-5, rtol=0)

    def jloss(p):
        return jm.training_step(p, (jnp.asarray(x), jnp.asarray(y)),
                                jax.random.PRNGKey(0))[0]

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp)
    tl, _ = tm.training_step(tp, (torch.from_numpy(x), torch.from_numpy(y)))
    grads = torch.autograd.grad(tl, list(leaves.values()))
    assert tl.item() == pytest.approx(float(jl), rel=1e-5)
    jflat = _flat(_np_tree(jg))
    assert jflat.keys() == leaves.keys()
    for (key, _), g in zip(leaves.items(), grads):
        assert _rel_l2(g.numpy(), jflat[key]) <= 1e-4, key


def _flat_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_resnet_same_padding_is_asymmetric_at_stride_2():
    """XLA's SAME padding of a 3x3 stride-2 conv on an even input is
    (0 before, 1 after); ``F.conv2d(padding=1)`` pads (1, 1) and shifts
    the map a pixel.  The port's ``_conv`` agrees with the JAX conv
    (f32, 1e-5 absolute); the symmetric pad does not (the check fails on
    it by far more than the tolerance)."""
    assert resnet._same_pads(32, 3, 2) == (0, 1)
    assert resnet._same_pads(32, 1, 2) == (0, 0)
    assert resnet._same_pads(32, 3, 1) == (1, 1)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)     # NHWC
    for kh, stride in ((3, 2), (1, 2), (3, 1)):
        k = rng.standard_normal((kh, kh, 4, 6)).astype(np.float32)  # HWIO
        ref = np.asarray(jresnet._conv(jnp.asarray(x), jnp.asarray(k),
                                       stride)).transpose(0, 3, 1, 2)
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        got = resnet._conv(xt, torch.from_numpy(k), stride).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
        if kh == 3 and stride == 2:
            sym = F.conv2d(xt, torch.from_numpy(k).permute(3, 2, 0, 1),
                           stride=2, padding=1).numpy()
            assert sym.shape == ref.shape
            assert np.abs(sym - ref).max() > 1e-1


def test_group_norm_matches_jax():
    """GroupNorm at widths that are and are not multiples of 32 (the
    group count falls to the largest divisor <= 32), f32 and bf16
    activations: f32 1e-5 absolute; bf16 output within one bf16 rounding
    (2^-8 relative of the largest entry)."""
    rng = np.random.default_rng(6)
    for c in (24, 64, 48):
        x = (rng.standard_normal((2, 4, 4, c)) * 3 + 1).astype(np.float32)
        s = rng.standard_normal(c).astype(np.float32)
        b = rng.standard_normal(c).astype(np.float32)
        for jdt, tdt, tol in ((jnp.float32, torch.float32, 1e-5),
                              (jnp.bfloat16, torch.bfloat16, None)):
            ref = np.asarray(jresnet._group_norm(
                jnp.asarray(x).astype(jdt), jnp.asarray(s), jnp.asarray(b)
            ).astype(jnp.float32)).transpose(0, 3, 1, 2)
            xt = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2)
            got = resnet._group_norm(xt, torch.from_numpy(s),
                                     torch.from_numpy(b))
            assert got.dtype == tdt
            got = got.float().numpy()
            atol = tol if tol else 2.0 ** -8 * np.abs(ref).max()
            np.testing.assert_allclose(got, ref, atol=atol, rtol=0)


def test_vit_patchify_order_and_remat_refusal():
    """Patch p covers rows 4*(p // 4).. and cols 4*(p % 4).., pixels
    row-major with channels last, as the JAX ``_patchify``."""
    m = vit.ViT(vit.ViTConfig(image_size=16, patch_size=4, channels=2),
                device="cpu")
    x = np.arange(2 * 16 * 16 * 2, dtype=np.float32).reshape(2, 16, 16, 2)
    jm = jvit.ViT(jvit.ViTConfig(image_size=16, patch_size=4, channels=2))
    got = m._patchify(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jm._patchify(
        jnp.asarray(x))))
    np.testing.assert_array_equal(got[1, 5], x[1, 4:8, 4:8].reshape(-1))
    # remat runs (tests/test_torch_training_extras.py holds its
    # gradients): the same logits as without it
    rm = vit.ViT(vit.ViTConfig(**VIT_CFG, remat=True), device="cpu")
    p = rm.init_params(0)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 16, 16, 3)).astype(np.float32))
    assert torch.equal(rm.forward(p, x), vit.ViT(vit.ViTConfig(**VIT_CFG),
                                                device="cpu").forward(p, x))


def test_params_from_jax_keeps_the_trees():
    """All three trees cross unchanged in leaf names, shapes and values:
    ViT's stacked [L, ...] leaves, ResNet's HWIO kernels (permuted to
    OIHW only where used) and nested {scale, bias} norms; the port's own
    init builds the same tree."""
    for name in ("mnist", "resnet", "vit"):
        _, tm, init = _models(name)
        tp = _flat(params_from_jax(init, device="cpu"))
        ji = _flat(init)
        assert tp.keys() == ji.keys()
        for k in ji:
            np.testing.assert_array_equal(tp[k], ji[k])
        own = _flat(tm.init_params(0))
        assert {k: v.shape for k, v in own.items()} == \
            {k: v.shape for k, v in ji.items()}
    assert tp["/layers/attn/wo"].shape == (2, 2, 32, 64)
    _, _, rinit = _models("resnet")
    assert rinit["stage1_block0"]["conv1"].shape == (3, 3, 8, 16)
    assert rinit["stage1_block0"]["proj"].shape == (1, 1, 8, 16)


# ---------------------------------------------------------------------- #
# optimizer                                                               #
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("momentum,nesterov,wd", [(0.9, True, 5e-4),
                                                  (0.9, False, 0.0),
                                                  (0.0, True, 1e-2)])
def test_sgd_matches_optax(momentum, nesterov, wd):
    """Five steps of ``chain(add_decayed_weights(wd), sgd(lr, momentum,
    nesterov))`` (ResNet-18's optimizer) against optax: f32 elementwise
    arithmetic in the same order; 1e-6 absolute and relative."""
    rng = np.random.default_rng(4)
    p0 = [rng.standard_normal((5, 3)).astype(np.float32),
          rng.standard_normal(7).astype(np.float32)]
    grads = [[rng.standard_normal(a.shape).astype(np.float32) for a in p0]
             for _ in range(5)]
    tx = optax.chain(optax.add_decayed_weights(wd),
                     optax.sgd(0.05, momentum=momentum, nesterov=nesterov))
    jp = [jnp.asarray(a) for a in p0]
    st = tx.init(jp)
    tp = [torch.from_numpy(a.copy()) for a in p0]
    opt = Optimizer(SGD(0.05, momentum=momentum, nesterov=nesterov,
                        weight_decay=wd), tp)
    for g in grads:
        upd, st = tx.update([jnp.asarray(a) for a in g], st, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([torch.from_numpy(a) for a in g])
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


# ---------------------------------------------------------------------- #
# the slice: Trainer.fit(datamodule=...) against the JAX Trainer          #
# ---------------------------------------------------------------------- #
def _datamodules(name, batch):
    """(JAX, port) data modules over the same arrays: 5 training batches
    and 2 validation batches."""
    if name == "mnist":
        kw = dict(batch_size=batch, n_train=5 * batch, n_val=2 * batch,
                  seed=1)
        return jmnist.MNISTDataModule(**kw), mnist.MNISTDataModule(**kw)
    kw = dict(batch_size=batch, n_train=5 * batch, n_val=2 * batch, seed=1)
    jdm, tdm = jresnet.CIFAR10DataModule(**kw), \
        resnet.CIFAR10DataModule(**kw)
    if name == "vit":  # 16x16 crops for the small ViT
        for dm in (jdm, tdm):
            dm.setup("fit")
            dm._train = (dm._train[0][:, 8:24, 8:24], dm._train[1])
            dm._val = (dm._val[0][:, 8:24, 8:24], dm._val[1])
    return jdm, tdm


@pytest.mark.parametrize("name", ["mnist", "resnet", "vit"])
def test_fit_with_datamodule_matches_jax_trainer(name, tmp_path):
    """5 optimizer steps (one epoch of 5 shuffled batches of 8) from the
    same weights, f32, on the JAX Trainer (one device, guard off) and
    the port's, both through ``fit(datamodule=...)``, then
    ``validate(datamodule=...)``.  f32 differs by summation order,
    compounding over the steps.  Limits: the loss within 2e-4 relative at
    every step; params within 1e-3 relative L2 per leaf; the validate
    metrics with the same names and within 1e-5."""
    jm, tm, init = _models(name)
    jdm, tdm = _datamodules(name, 8)
    common = dict(max_epochs=1, precision="f32", log_every_n_steps=1,
                  enable_checkpointing=False, seed=0)
    jm.params = jax.tree.map(jnp.asarray, init)
    jt = JaxTrainer(accelerator=Accelerator(MeshConfig(data=1)), guard=None,
                    prefetch_batches=0, cache_dataset_on_device=False,
                    default_root_dir=str(tmp_path / "jax"), **common)
    jt.fit(jm, datamodule=jdm)
    tm.params = params_from_jax(init, device="cpu")
    tt = Trainer(device="cpu", default_root_dir=str(tmp_path / "port"),
                 **common)
    tt.fit(tm, datamodule=tdm)

    jh = [r for r in jt.logger.history if "train_loss" in r]
    th = [r for r in tt.logger.history if "train_loss" in r]
    assert [r["step"] for r in th] == [r["step"] for r in jh] == \
        list(range(1, 6))
    for a, b in zip(th, jh):
        assert a["train_loss"] == pytest.approx(b["train_loss"], rel=2e-4)
    jp, tp = _flat(_np_tree(jm.params)), _flat(tm.params)
    assert jp.keys() == tp.keys()
    for key in jp:
        assert _rel_l2(tp[key], jp[key]) <= 1e-3, key
    (jv,), (tv,) = (jt.validate(jm, datamodule=jdm),
                    tt.validate(tm, datamodule=tdm))
    assert jv.keys() == tv.keys()
    for key in jv:
        assert tv[key] == pytest.approx(float(jv[key]), rel=1e-5,
                                        abs=1e-5), key


def test_mnist_datamodule_real_split_test_and_predict(tmp_path):
    """``MNISTDataModule(data_dir=tests/data/mnist)``: real source, val
    the held-out tail of train, ``test(datamodule=)`` on the t10k split;
    ``predict(datamodule=)`` gives f32 logits per t10k batch."""
    dm = mnist.MNISTDataModule(batch_size=64, n_train=512, n_val=128,
                               data_dir=MNIST_DIR)
    model = mnist.MNISTClassifier({"lr": 3e-3}, device="cpu")
    tr = Trainer(device="cpu", precision="f32", max_epochs=2,
                 enable_checkpointing=False,
                 default_root_dir=str(tmp_path))
    tr.fit(model, datamodule=dm)
    assert dm.source == "real" and len(dm._train[0]) == 512
    assert tr.global_step == 16
    (tested,) = tr.test(model, datamodule=dm)
    assert set(tested) == {"ptl/val_loss", "ptl/val_accuracy", "val_loss",
                           "val_accuracy"}
    # 1024 real digits, 16 steps: well above chance (0.1)
    assert tested["val_accuracy"] > 0.5
    preds = tr.predict(model, datamodule=dm)
    n_test = len(vision.load_mnist(MNIST_DIR, "test")[0])
    assert [tuple(p.shape) for p in preds] == [(64, 10)] * (n_test // 64)
    assert all(p.dtype == torch.float32 for p in preds)


def test_resnet_sgd_checkpoint_resume(tmp_path):
    """A ResNet-18 fit (SGD with momentum: the checkpoint carries the
    momentum trace) resumed from its epoch-1 checkpoint ends on the same
    params as an uninterrupted 2-epoch fit.  Two identical CPU fits differ
    by a few ulps (threaded reductions), so 1e-5 relative L2."""
    x, y = resnet.synthetic_cifar10(16, seed=2)

    def dm():
        d = resnet.CIFAR10DataModule(batch_size=8, n_train=16, n_val=8)
        d._train, d._val = (x, y), (x[:8], y[:8])
        return d

    def model():
        m = resnet.ResNet18({"width": 4, "lr": 0.05}, device="cpu")
        m.params = m.init_params(3)
        return m

    full = model()
    Trainer(device="cpu", precision="f32", max_epochs=2,
            default_root_dir=str(tmp_path / "full")).fit(full, datamodule=dm())
    first = model()
    ckpt = ModelCheckpoint(monitor="val_loss")
    Trainer(device="cpu", precision="f32", max_epochs=1, callbacks=[ckpt],
            default_root_dir=str(tmp_path / "a")).fit(first, datamodule=dm())
    loaded = resnet.ResNet18.load_from_checkpoint(ckpt.best_model_path,
                                                  device="cpu")
    assert loaded.width == 4 and loaded.lr == 0.05
    resumed = model()
    t2 = Trainer(device="cpu", precision="f32", max_epochs=2,
                 default_root_dir=str(tmp_path / "b"))
    t2.fit(resumed, datamodule=dm(), ckpt_path=ckpt.best_model_path)
    assert t2.global_step == 4
    for key, a in _flat(full.params).items():
        assert _rel_l2(_flat(resumed.params)[key], a) <= 1e-5, key
