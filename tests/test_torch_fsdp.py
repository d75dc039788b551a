"""Sharded data parallelism through the port's Trainer over 2 gloo ranks
on the CPU, against the JAX Trainer on a 2-device mesh in one process
(tests/conftest.py gives it 8 CPU devices) and against the port's own
replicated runs:

- ``RayTPUAccelerator(2, use_fsdp=True)``: the loss trajectory and final
  params of a 10-step GPT fit against the JAX Trainer's;
- ``shard_optimizer_state=True`` (ZeRO-1): bit for bit the port's 2-rank
  data parallelism;
- ``grad_compression="int8" | "bf16"``, plain and FSDP, with and without
  ``accumulate_grad_batches=2``, against the JAX Trainer's trajectories
  (the MNIST MLP, as the JAX package's own compression tests);
- the clip under FSDP sees the global norm: the port's clipped FSDP step
  equals its clipped replicated step;
- each rank's state holds only its parts (the shapes the ranks report),
  and a sharded checkpoint of 2 ranks resumes on 1.

The ranks share one world per module (``_fit`` binds it to each
trainer); models come from tests/torch_boring.py (no JAX).  The world's
rendezvous and collectives fail after ``bootstrap.DEFAULT_TIMEOUT_S``
(60 s here)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_lightning_accelerators_tpu import RayTPUAccelerator as JaxRayTPU
from ray_lightning_accelerators_tpu import Trainer as JaxTrainer
from ray_lightning_accelerators_tpu.data.loader import (
    ArrayDataset as JaxArrayDataset, DataLoader as JaxDataLoader)
from ray_lightning_accelerators_tpu.models.mnist import (
    MNISTClassifier as JaxMNIST, synthetic_mnist as jax_synthetic_mnist)
from ray_lightning_accelerators_tpu.models.transformer import (
    GPT as JaxGPT, TransformerConfig as JaxConfig)
from ray_lightning_accelerators_tpu_torch import (DataLoader,
                                                  RayTPUAccelerator, Trainer)
from ray_lightning_accelerators_tpu_torch.data.loader import ArrayDataset
from ray_lightning_accelerators_tpu_torch.models.mnist import (
    MNISTClassifier, synthetic_mnist)
from ray_lightning_accelerators_tpu_torch.models.transformer import (
    GPT, TransformerConfig)
from ray_lightning_accelerators_tpu_torch.runtime import bootstrap
from ray_lightning_accelerators_tpu_torch.runtime.bootstrap import (
    DistributedWorld)
from ray_lightning_accelerators_tpu_torch.utils import (
    sharded_checkpoint as sharded_lib)
from ray_lightning_accelerators_tpu_torch.utils.weights import (
    params_from_jax)

from .torch_boring import WideModel, boring_loaders

pytestmark = pytest.mark.fsdp
torch.backends.cuda.matmul.allow_tf32 = False

VOCAB, SEQ = 128, 64
# tests/test_torch_training.py's dense GPT: 2 layers, d 128
CFG = dict(vocab_size=VOCAB, d_model=128, n_heads=2, d_ff=256, n_layers=2,
           max_seq_len=SEQ, loss_chunk_rows=100)
COMMON = dict(max_epochs=2, precision="f32", log_every_n_steps=1,
              gradient_clip_val=0.5, log_grad_norm=True,
              enable_checkpointing=False, seed=0)


@pytest.fixture(scope="module")
def world():
    saved = bootstrap.DEFAULT_TIMEOUT_S
    bootstrap.DEFAULT_TIMEOUT_S = 60.0
    w = DistributedWorld(2, devices=["cpu", "cpu"], timeout_s=60.0)
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


@pytest.fixture(scope="module")
def jax_init():
    return jax.device_get(JaxGPT(JaxConfig(**CFG)).init_params(
        jax.random.PRNGKey(0)))


DATA = _tokens(20, seed=5)


def _jax_fit(jax_init, root, use_fsdp=False, **kw):
    jm = JaxGPT(JaxConfig(**CFG), lr=3e-3)
    jm.params = jax.tree.map(jnp.asarray, jax_init)
    jt = JaxTrainer(accelerator=JaxRayTPU(2, use_fsdp=use_fsdp), guard=None,
                    prefetch_batches=0, cache_dataset_on_device=False,
                    default_root_dir=str(root), **{**COMMON, **kw})
    jt.fit(jm, JaxDataLoader(JaxArrayDataset(DATA), batch_size=4,
                             shuffle=True, use_native=False))
    return jt, jm


def _fit(world, root, model, loader, acc, **kw):
    """A port fit over the module's world (bound to the trainer)."""
    t = Trainer(device="cpu", accelerator=acc, default_root_dir=str(root),
                **kw)
    t._world = world
    t.fit(model, loader)
    t._world = None     # the module's fixture ends the world
    return t


def _port_fit(world, jax_init, root, use_fsdp=False, **kw):
    tm = GPT(TransformerConfig(**CFG), device="cpu", lr=3e-3)
    tm.params = params_from_jax(jax_init, device="cpu")
    t = _fit(world, root, tm,
             DataLoader(ArrayDataset(DATA), batch_size=4, shuffle=True),
             RayTPUAccelerator(2, use_fsdp=use_fsdp), **{**COMMON, **kw})
    return t, tm


def _history(trainer, key):
    return [r[key] for r in trainer.logger.history if key in r]


@pytest.mark.parametrize("accumulate", [1, 2])
def test_fsdp_fit_matches_jax_trainer(world, jax_init, tmp_path,
                                      accumulate):
    """10 micro-steps (2 epochs of 5 shuffled global batches of 4,
    clipping at 0.5) of ``use_fsdp``, with and without accumulation
    (``optax.MultiSteps`` over the sharded accumulator; the clip at the
    window's end sees the global norm): the JAX Trainer shards the GPT's
    ``embed`` dims over a 2-device fsdp axis, the port over 2 ranks.
    f32 sums in other
    orders, so the bounds are the replicated parity test's
    (tests/test_torch_accelerators.py): the loss within 2e-4 relative
    and the (global) grad norm within 1e-3 at every step, the final
    params within 1e-3 relative L2 per leaf (measured: 3.3e-6, 2.5e-6,
    5.2e-6; with accumulation 1.3e-6, 3.1e-6, 6.4e-6)."""
    kw = dict(accumulate_grad_batches=accumulate)
    jt, jm = _jax_fit(jax_init, tmp_path / "jax", use_fsdp=True, **kw)
    tt, tm = _port_fit(world, jax_init, tmp_path / "port", use_fsdp=True,
                       **kw)
    jl, tl = _history(jt, "train_loss"), _history(tt, "train_loss")
    assert len(tl) == len(jl) == 10
    for a, b in zip(tl, jl):
        assert a == pytest.approx(b, rel=2e-4)
    for a, b in zip(_history(tt, "grad_norm"), _history(jt, "grad_norm")):
        assert a == pytest.approx(b, rel=1e-3)
    jp, tp = _flat(jax.device_get(jm.params)), _flat(tm.params)
    assert jp.keys() == tp.keys()
    for name in jp:
        assert _rel_l2(tp[name], jp[name]) <= 1e-3, name
    rep = tt.rank_report
    assert rep["plan"]["fields"]["params"] == {"leaves": 10, "replicated": 3,
                                              "sharded": 7}
    # the masters of the embedding hold half of d_model on each rank
    assert rep["state_shapes"]["params/embed"] == [VOCAB, 64]
    assert rep["state_shapes"]["opt/adam/mu/embed"] == [VOCAB, 64]
    if accumulate > 1:
        assert rep["state_shapes"]["opt/acc/embed"] == [VOCAB, 64]
    assert rep["collectives"]["reduce_scatter"] == 10
    assert rep["collectives"]["all_gather"] == 10 + 1   # + the final gather


@pytest.mark.parametrize("kw", [
    dict(), dict(accumulate_grad_batches=2, gradient_clip_val=None)])
def test_zero1_is_bitwise_the_port_data_parallelism(world, jax_init,
                                                    tmp_path, kw):
    """ZeRO-1 changes where the update runs, not its arithmetic: the same
    exact all-reduce, the clip's norm over the whole gradients, AdamW
    (and the EMA, and the accumulator's running mean) on each rank's
    dim-0 slices, the slices all-gathered.  Every loss, grad norm and
    final parameter equals the replicated run's bit for bit; the moments
    of divisible leaves hold half their rows.  (Under accumulation the
    clip's norm would be a sum over the ranks' slices, equal only to f32
    rounding, so that case runs unclipped.)"""
    ta, ma = _port_fit(world, jax_init, tmp_path / "dp", ema_decay=0.9,
                       **kw)
    tb, mb = _port_fit(world, jax_init, tmp_path / "z1", ema_decay=0.9,
                       shard_optimizer_state=True, **kw)
    assert _history(ta, "train_loss") == _history(tb, "train_loss")
    assert _history(ta, "grad_norm") == _history(tb, "grad_norm")
    for name, a in _flat(ma.params).items():
        np.testing.assert_array_equal(_flat(mb.params)[name], a, name)
    rep = tb.rank_report
    assert rep["plan"]["regime"] == "zero1"
    assert rep["state_shapes"]["params/embed"] == [VOCAB, 128]
    assert rep["state_shapes"]["opt/adam/mu/embed"] == [VOCAB // 2, 128]
    assert rep["state_shapes"]["opt/ema/embed"] == [VOCAB // 2, 128]
    assert rep["owned_bytes"]["opt_state"] < \
        0.55 * ta.rank_report["owned_bytes"]["opt_state"]


MNIST_CFG = {"layer_1": 64, "layer_2": 64, "lr": 1e-3, "batch_size": 16}


def _replica_rows(n_rows: int, batch: int, n: int = 2) -> np.ndarray:
    """The JAX dataset order whose replicas see the port's ranks' rows.
    The port's rank r takes rows ``r::n`` of each global batch (the
    loader's ``ShardedSampler``), a JAX replica a contiguous block; the
    exact mean is the same either way, but a compressed exchange
    quantizes each replica's own gradient, so the parity runs give both
    sides the same rows."""
    return np.concatenate([
        np.concatenate([np.arange(k + r, k + batch, n) for r in range(n)])
        for k in range(0, n_rows, batch)])


_REPLICA_ROWS = _replica_rows(80, 16)


@pytest.fixture(scope="module")
def mnist_init():
    jm = JaxMNIST(MNIST_CFG)
    return jax.device_get(jm.init_params(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("mode,use_fsdp,accumulate", [
    ("int8", False, 1), ("bf16", False, 1), ("int8", True, 1),
    ("bf16", True, 1), ("int8", False, 2), ("int8", True, 2)])
def test_compressed_fit_matches_jax_trainer(world, mnist_init, tmp_path,
                                            mode, use_fsdp, accumulate):
    """10 micro-steps of ``grad_compression`` over the MNIST MLP (the JAX
    package's own compression tests train it; its GPT's sharding
    constraints do not trace inside the exchange's manual ``shard_map``),
    plain or FSDP, with or without accumulation, against the JAX
    Trainer's.  The quantization is the same function on both sides
    (tests/test_torch_exchange.py), so the runs agree to f32 rounding
    until a value a few ulps apart lands on the other side of a rounding
    boundary (the int8 grid, or FSDP's bf16 compute view): a flip, after
    which that step's update differs by one grid step.  Limits at every
    step: the loss 2e-4 relative and the grad norm (the RMS over the
    ranks of the local norms, as the JAX package logs it) 1e-3.  Before
    the first flip (the first step whose grad norm differs by more than
    1e-4) both within 1e-4; the final params within 1e-3 relative L2 per
    leaf without a flip, 1e-2 after one.  Measured over the six cases:
    before a flip the loss within 2.2e-5 and the norm 3.4e-5, final
    params 6.8e-5; int8 FSDP with accumulation flips at step 8 (its norm
    6.8e-4 apart there, its final params 1.7e-3)."""
    x, y = (np.asarray(a) for a in jax_synthetic_mnist(80, seed=0))
    kw = dict(grad_compression=mode, accumulate_grad_batches=accumulate)
    jm = JaxMNIST(MNIST_CFG)
    jm.params = jax.tree.map(jnp.asarray, mnist_init)
    jt = JaxTrainer(accelerator=JaxRayTPU(2, use_fsdp=use_fsdp), guard=None,
                    prefetch_batches=0, cache_dataset_on_device=False,
                    default_root_dir=str(tmp_path / "jax"), **COMMON, **kw)
    # the same rows on each side's replica (see _replica_rows)
    jt.fit(jm, JaxDataLoader(JaxArrayDataset(x[_REPLICA_ROWS],
                                             y[_REPLICA_ROWS]),
                             batch_size=16, shuffle=False, use_native=False))
    tm = MNISTClassifier(MNIST_CFG, device="cpu")
    tm.params = params_from_jax(mnist_init, device="cpu")
    tt = _fit(world, tmp_path / "port", tm,
              DataLoader(ArrayDataset(x, y), batch_size=16, shuffle=False),
              RayTPUAccelerator(2, use_fsdp=use_fsdp), **COMMON, **kw)
    jl, tl = _history(jt, "train_loss"), _history(tt, "train_loss")
    jn, tn = _history(jt, "grad_norm"), _history(tt, "grad_norm")
    assert len(tl) == len(jl) == len(tn) == len(jn) == 10
    gap_l = [abs(a - b) / abs(b) for a, b in zip(tl, jl)]
    gap_n = [abs(a - b) / abs(b) for a, b in zip(tn, jn)]
    assert max(gap_l) <= 2e-4 and max(gap_n) <= 1e-3, (gap_l, gap_n)
    flip = next((i for i, g in enumerate(gap_n) if g > 1e-4), None)
    assert max(gap_l[:flip] + gap_n[:flip]) <= 1e-4, (gap_l, gap_n)
    assert tl[-1] < tl[0]
    jp, tp = _flat(jax.device_get(jm.params)), _flat(tm.params)
    for name in jp:
        assert _rel_l2(tp[name], jp[name]) <= (1e-3 if flip is None
                                               else 1e-2), name
    assert tt.comms_per_step == jt.comms_per_step
    rep = tt.rank_report
    n_large = 2   # dense_0 and dense_1's kernels: 2048 elements or more
    assert rep["compressed_exchanges"] == n_large * (
        10 if use_fsdp else 10 // accumulate)
    fields = rep["plan"]["fields"]
    assert fields["residual"]["leaves"] == 6
    assert ("grad_accum" in fields) == (accumulate > 1)
    shapes = rep["state_shapes"]
    if use_fsdp:
        # the residual of a reduce-scattered leaf is the owned chunk,
        # padded to a whole block under int8
        chunk = 784 * 64 // 2
        assert shapes["residual/dense_0/kernel"] == [
            chunk + (-chunk) % 256 if mode == "int8" else chunk]
        if accumulate > 1:
            assert shapes["grad_accum/dense_0/kernel"] == [392, 64]
    else:
        assert shapes["residual/dense_0/kernel"] == [784 * 64]
        if accumulate > 1:
            assert shapes["grad_accum/dense_0/kernel"] == [784, 64]


def test_fsdp_clip_equals_the_replicated_clipped_step(world, jax_init,
                                                      tmp_path):
    """The clip under FSDP sees the global norm (each rank's squares of
    its slices, the replicated leaves once, summed over the ranks): with
    a clip far below the gradients' norm (every step clipped), FSDP's
    losses and params equal the replicated run's to f32 summation order
    (1e-5 relative; measured: losses equal, norms 8.2e-8, params
    1.7e-7)."""
    kw = dict(gradient_clip_val=0.05, max_epochs=1)
    ta, ma = _port_fit(world, jax_init, tmp_path / "dp", **kw)
    tb, mb = _port_fit(world, jax_init, tmp_path / "fsdp", use_fsdp=True,
                       **kw)
    assert min(_history(ta, "grad_norm")) > 0.05 * 10
    for a, b in zip(_history(tb, "train_loss"), _history(ta, "train_loss")):
        assert a == pytest.approx(b, rel=1e-5)
    for a, b in zip(_history(tb, "grad_norm"), _history(ta, "grad_norm")):
        assert a == pytest.approx(b, rel=1e-5)
    for name, a in _flat(ma.params).items():
        assert _rel_l2(_flat(mb.params)[name], a) <= 1e-5, name


def test_fsdp_state_is_sharded(world, tmp_path):
    """tests/test_accelerators.py:109: use_fsdp shards the large kernel
    (the heuristic's largest divisible dim, 0) and leaves the bias
    whole."""
    t = _fit(world, tmp_path, WideModel(), boring_loaders(batch_size=8)[0],
             RayTPUAccelerator(2, use_fsdp=True), max_epochs=1,
             precision="f32", seed=0, limit_train_batches=4,
             enable_checkpointing=False)
    shapes = t.rank_report["state_shapes"]
    assert shapes["params/layer/kernel"] == [128, 256]
    assert shapes["params/layer/bias"] == [256]
    assert t.rank_report["param_layouts"] == {
        "layer": {"kernel": (("fsdp", 0),), "bias": None}}
    # the launching process's module gets the whole (gathered) weights
    assert tuple(t.module.params["layer"]["kernel"].shape) == (256, 256)


def test_fsdp_with_grad_accum_shards_moments(world, tmp_path):
    """tests/test_accelerators.py:163: accumulation (optax.MultiSteps's
    accumulator in the optimizer state) keeps the FSDP layout: the
    accumulator of the sharded kernel holds half its rows."""
    t = _fit(world, tmp_path, WideModel(), boring_loaders(batch_size=8)[0],
             RayTPUAccelerator(2, use_fsdp=True), max_epochs=1,
             precision="f32", seed=0, limit_train_batches=4,
             accumulate_grad_batches=2, enable_checkpointing=False)
    shapes = t.rank_report["state_shapes"]
    assert shapes["opt/acc/layer/kernel"] == [128, 256]
    assert shapes["opt/acc/layer/bias"] == [256]


def _mnist(n=256, bs=64):
    x, y = synthetic_mnist(n, seed=0)
    return DataLoader(ArrayDataset(x, y), batch_size=bs, shuffle=True)


def _mnist_model():
    return MNISTClassifier({"layer_1": 64, "layer_2": 64, "lr": 1e-3,
                            "batch_size": 64}, device="cpu")


def test_fsdp_trainer_state_is_shard_local_and_resumes_on_fewer_shards(
        world, tmp_path):
    """tests/test_fsdp_exchange.py:223: int8 FSDP with accumulation keeps
    every buffer shard-local: the kernel (784, 64) on dim 0, its Adam
    moments, its residual (the owned chunk padded to a block) and its
    accumulator (param-shaped, so 1/N too); the wire report says
    reduce-scatter / all-gather.  The sharded checkpoint of the 2 ranks
    resumes on 1 rank: params and moments arrive by their global shapes,
    the residuals and accumulators reset, and training continues."""
    t = _fit(world, tmp_path / "f2", _mnist_model(), _mnist(),
             RayTPUAccelerator(2, use_fsdp=True), max_epochs=1,
             precision="f32", seed=0, grad_compression="int8",
             accumulate_grad_batches=2, checkpoint_format="sharded")
    shapes = t.rank_report["state_shapes"]
    assert shapes["params/dense_0/kernel"] == [784 // 2, 64]
    assert shapes["opt/adam/mu/dense_0/kernel"] == [784 // 2, 64]
    assert shapes["opt/adam/nu/dense_0/kernel"] == [784 // 2, 64]
    chunk = 784 * 64 // 2
    assert shapes["residual/dense_0/kernel"] == [chunk + (-chunk) % 256]
    assert shapes["grad_accum/dense_0/kernel"] == [784 // 2, 64]
    assert t.comms_per_step["regime"] == "reduce_scatter_all_gather"
    assert t.comms_per_step["param_allgather_bytes_per_step"] > 0
    path = t.checkpoint_callback.best_model_path
    assert sharded_lib.verify_checkpoint(path) == (True, "ok")
    saved = sharded_lib.restore_sharded(path)
    assert list(saved["params/dense_0/kernel"].shape) == [784, 64]
    assert list(saved["residual/dense_0/kernel"].shape) == \
        [2, chunk + (-chunk) % 256]

    # one rank (fewer shards), in this process: the fit's state is here
    t1 = Trainer(device="cpu", max_epochs=2, precision="f32", seed=0,
                 grad_compression="int8", accumulate_grad_batches=2,
                 checkpoint_format="sharded", enable_checkpointing=False,
                 default_root_dir=str(tmp_path / "f1"))
    model = _mnist_model()
    t1._bind(model)
    state = t1._build_state(model)
    t1._state = state
    state.residual["dense_0"]["kernel"].fill_(1.0)
    t1._restore(path, state)
    for name, local, _ in t1._state_entries(state):
        if name.startswith(("residual/", "grad_accum/")):
            assert not local.any(), name          # reset for this world
        else:
            np.testing.assert_array_equal(local.detach().numpy(),
                                          saved[name].numpy(), name)
    t1.fit(model, _mnist(), ckpt_path=path)
    assert t1.global_step > t.global_step
    assert np.isfinite(t1.callback_metrics["train_loss"])


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_int8_exchange_gap_to_exact_training(precision):
    """How far int8 compression moves a GPT fit from the exact one: 8
    steps of the same weights and batches on one rank (a world of one:
    the exchange still quantizes and re-quantizes every large leaf, with
    error feedback).  chip_smoke.py's 10a holds its int8 fit to the
    exact in-process fit with a bound set from this gap.  Measured: the
    loss at every step within 4.2e-6 (f32) and 1.3e-5 (bf16) relative;
    limit 1e-4."""
    vocab, seq = 512, 128
    cfg = dict(vocab_size=vocab, d_model=128, n_heads=2, d_ff=512,
               n_layers=2, max_seq_len=seq)
    starts = np.random.default_rng(0).integers(0, vocab, 16 * 8)
    data = ((starts[:, None] + np.arange(seq)[None]) % vocab).astype(
        np.int32)
    losses = {}
    # two threads: the suite's other workers share the cores, and this
    # fit slows down 30-fold when all of them oversubscribe them
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        for mode in (None, "int8"):
            losses[mode] = _fit_gpt_one_rank(cfg, data, precision, mode)
    finally:
        torch.set_num_threads(threads)
    gap = [abs(a - b) / b for a, b in zip(losses["int8"], losses[None])]
    assert len(gap) == 8 and max(gap) <= 1e-4, gap


def _fit_gpt_one_rank(cfg, data, precision, mode):
    """8 steps of the GPT on one rank; the loss at each step."""
    t = Trainer(device="cpu", max_epochs=1, precision=precision, seed=0,
                grad_compression=mode, log_every_n_steps=1,
                enable_checkpointing=False)
    t.fit(GPT(TransformerConfig(**cfg), device="cpu", lr=3e-4),
          DataLoader(ArrayDataset(data), batch_size=16, shuffle=True,
                     seed=0))
    if mode is not None:
        # the 7 leaves of 2048 elements or more, every step
        assert t._exchange.compressed_exchanges == 7 * 8
    return _history(t, "train_loss")
