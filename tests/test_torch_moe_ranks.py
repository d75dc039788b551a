"""The MoE GPT over 2 data-parallel gloo ranks against the JAX Trainer on
a 2-device mesh (tests/conftest.py gives it 8 CPU devices).

The load-balance loss ``aux = E * sum(frac_tokens * frac_probs)`` is a
product of two means over the GLOBAL batch in the JAX package (under
GSPMD a data-sharded batch is one array).  The port used to take it on
each rank's rows and average the ranks' gradients: a mean of products,
not a product of means, so the port minimised another auxiliary loss.
``ops/moe.py`` now averages the fractions over the batch axes first
(``mean_identity_grad``: its backward passes the gradient on, so the
trainer's mean of the ranks' gradients is the gradient of the one global
loss).  The test measures the gap both ways: with the fix against JAX,
and with the fractions taken per rank again (a patch planted in the
ranks, removed afterwards), which must miss JAX by far more than the
test's bound."""

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
from ray_lightning_accelerators_tpu_torch.runtime import bootstrap
from ray_lightning_accelerators_tpu_torch.runtime.bootstrap import (
    DistributedWorld)
from ray_lightning_accelerators_tpu_torch.utils.weights import (
    params_from_jax)

from . import torch_boring

pytestmark = pytest.mark.fsdp
torch.backends.cuda.matmul.allow_tf32 = False

VOCAB, SEQ = 128, 32
# tests/test_torch_moe.py's MoE GPT: 4 experts, top-2, capacity 1.25
CFG = dict(vocab_size=VOCAB, d_model=64, n_heads=2, d_ff=128, n_layers=2,
           max_seq_len=SEQ, num_experts=4, moe_top_k=2, loss_chunk_rows=40)
COMMON = dict(max_epochs=1, precision="f32", log_every_n_steps=1,
              enable_checkpointing=False, seed=0)
# the fractions taken on each rank's rows again
_PER_RANK = ("from ray_lightning_accelerators_tpu_torch.ops import moe\n"
             "moe._fixed = getattr(moe, '_fixed', moe.top_k_routing)\n"
             "moe.top_k_routing = lambda lg, k, cap, mesh=None: "
             "moe._fixed(lg, k, cap)\n")
_RESTORE = ("from ray_lightning_accelerators_tpu_torch.ops import moe\n"
            "moe.top_k_routing = getattr(moe, '_fixed', "
            "moe.top_k_routing)\n")


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


def _history(trainer, key):
    return [r[key] for r in trainer.logger.history if key in r]


DATA = _tokens(24, seed=3)


def _port_fit(world, jax_init, root, init_hook=None):
    tm = GPT(TransformerConfig(**CFG), device="cpu", lr=3e-3)
    tm.params = params_from_jax(jax_init, device="cpu")
    t = Trainer(device="cpu", default_root_dir=str(root),
                accelerator=RayTPUAccelerator(2, init_hook=init_hook),
                **COMMON)
    t._world = world
    t.fit(tm, DataLoader(ArrayDataset(DATA), batch_size=4, shuffle=True))
    t._world = None
    return t, tm


def test_moe_aux_over_data_ranks_matches_jax_trainer(world, tmp_path):
    """6 steps (24 shuffled rows, global batch 4) from the same weights.
    The aux loss at every step and the loss within 1e-5 relative, the
    final params within 1e-4 relative L2 per leaf (measured on an x86
    CPU: aux 3.6e-6, loss 6.1e-7, params 1.6e-5 at /embed; no token's
    routing flips between the packages in these 6 steps, so the bounds of
    test_torch_moe.py's trajectory test before a flip apply).  With the
    fractions per rank, the gap the fix closes: the step-1 aux loss
    misses JAX's by 6.0e-2 relative, the aux loss by up to 0.24 over the
    6 steps, the router's final weights by 2.6e-2 relative L2 and /embed
    by 6.8e-2 (measured)."""
    jax_init = jax.device_get(JaxGPT(JaxConfig(**CFG)).init_params(
        jax.random.PRNGKey(0)))
    jm = JaxGPT(JaxConfig(**CFG), lr=3e-3)
    jm.params = jax.tree.map(jnp.asarray, jax_init)
    jt = JaxTrainer(accelerator=JaxRayTPU(2), guard=None,
                    prefetch_batches=0, cache_dataset_on_device=False,
                    default_root_dir=str(tmp_path / "jax"), **COMMON)
    jt.fit(jm, JaxDataLoader(JaxArrayDataset(DATA), batch_size=4,
                             shuffle=True, use_native=False))
    tt, tm = _port_fit(world, jax_init, tmp_path / "port")
    jp, tp = _flat(jax.device_get(jm.params)), _flat(tm.params)
    ja, ta = _history(jt, "moe_aux_loss"), _history(tt, "moe_aux_loss")
    assert len(ta) == len(ja) == 6
    for a, b in zip(ta, ja):
        assert a == pytest.approx(b, rel=1e-5)
    for a, b in zip(_history(tt, "train_loss"), _history(jt, "train_loss")):
        assert a == pytest.approx(b, rel=1e-5)
    for name in jp:
        assert _rel_l2(tp[name], jp[name]) <= 1e-4, name
    try:
        ut, um = _port_fit(world, jax_init, tmp_path / "per_rank",
                           init_hook=functools.partial(
                               torch_boring.run_code, _PER_RANK, 0))
    finally:
        world.run(functools.partial(torch_boring.run_code, _RESTORE))
    gap = abs(_history(ut, "moe_aux_loss")[0] / ja[0] - 1.0)
    router = _rel_l2(_flat(um.params)["/layers/mlp/router"],
                     jp["/layers/mlp/router"])
    assert gap > 1e-3 and router > 1e-3, (gap, router)
