"""Expert parallelism over gloo ranks on the CPU, against the JAX
package on tests/conftest.py's 8 CPU devices:

- the MoE GPT (4 experts, top-2, capacity 1.25) at expert = 2, data = 2
  x expert = 2 and expert = 2 x tensor = 2, each against the JAX Trainer
  on the same mesh (tests/test_moe.py:80's meshes, cut to 4 ranks):
  loss, aux loss, grad norm and final params, each rank holding its
  experts (and, under tensor, its ``d_ff`` slice);
- ``moe_mlp`` under sequence = 2 against the JAX ``moe_mlp`` over the
  global sequence at a capacity that drops tokens: the output, the aux
  loss and the gradients of x and of every param.  Routing each chunk on
  its own would drop other tokens; the test shows that it would miss.

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
from ray_lightning_accelerators_tpu.ops import moe as jax_moe
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

VOCAB, SEQ = 256, 32
CFG = dict(vocab_size=VOCAB, d_model=64, n_heads=4, d_ff=128, n_layers=2,
           max_seq_len=SEQ, loss_chunk_rows=64, num_experts=4, moe_top_k=2)
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


def _flat_layouts(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_layouts(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _history(trainer, key):
    return [r[key] for r in trainer.logger.history if key in r]


DATA = _tokens(24, seed=5)
MESHES = {"ep2": ((1, dict(expert=2)), "world2"),
          "dp2_ep2": ((2, dict(expert=2)), "world4"),
          "ep2_tp2": ((1, dict(expert=2, tensor=2)), "world4")}


@pytest.mark.parametrize("axes", sorted(MESHES))
def test_moe_expert_parallel_fit_matches_jax_trainer(request, tmp_path,
                                                     axes):
    """6 steps (24 shuffled rows, global batch 4, clipping at 0.5): the
    loss, the aux loss and the global grad norm within 1e-4 relative at
    every step, the final params within 1e-3 relative L2 per leaf
    (measured on an x86 CPU over the three meshes: loss 4.5e-7, aux
    1.6e-6, norm 1.2e-6, params 6.5e-6).  No token's routing flips
    between the packages in these 6 steps (the bounds of
    tests/test_torch_moe.py's trajectory test before a flip)."""
    (dp, kw), world_name = MESHES[axes]
    world = request.getfixturevalue(world_name)
    init = jax.device_get(JaxGPT(JaxConfig(**CFG)).init_params(
        jax.random.PRNGKey(0)))
    jm = JaxGPT(JaxConfig(**CFG), lr=3e-3)
    jm.params = jax.tree.map(jnp.asarray, init)
    jt = JaxTrainer(accelerator=JaxRayTPU(dp, **kw), guard=None,
                    prefetch_batches=0, cache_dataset_on_device=False,
                    default_root_dir=str(tmp_path / "jax"), **COMMON)
    jt.fit(jm, JaxDataLoader(JaxArrayDataset(DATA), batch_size=4,
                             shuffle=True, use_native=False))
    tm = GPT(TransformerConfig(**CFG), device="cpu", lr=3e-3)
    tm.params = params_from_jax(init, device="cpu")
    tt = Trainer(device="cpu", accelerator=RayTPUAccelerator(dp, **kw),
                 default_root_dir=str(tmp_path / "port"), **COMMON)
    tt._world = world
    tt.fit(tm, DataLoader(ArrayDataset(DATA), batch_size=4, shuffle=True))
    tt._world = None
    for key in ("train_loss", "moe_aux_loss", "grad_norm"):
        jh, th = _history(jt, key), _history(tt, key)
        assert len(th) == len(jh) == 6, key
        for a, b in zip(th, jh):
            assert a == pytest.approx(b, rel=1e-4), key
    jp, tp = _flat(jax.device_get(jm.params)), _flat(tm.params)
    for name in jp:
        assert _rel_l2(tp[name], jp[name]) <= 1e-3, name
    rep = tt.rank_report
    assert rep["plan"] == jt._plan.describe()
    f = 128 // kw.get("tensor", 1)
    assert rep["state_shapes"]["params/layers/mlp/wi"] == [2, 2, 64, f]
    assert rep["state_shapes"]["opt/adam/nu/layers/mlp/wo"] == [2, 2, f, 64]
    assert rep["state_shapes"]["params/layers/mlp/router"] == [2, 64, 4]
    # every rank holds its experts' (and d_ff's) share of each split
    # leaf, every replicated leaf whole, and Adam's two moments of each
    split = {a: n for a, n in rep["mesh"].items() if n > 1}
    layouts = _flat_layouts(rep["param_layouts"])
    want = sum(v.size // int(np.prod([split[a] for a, _ in
                                      layouts[k] or ()])) * 4
               for k, v in jp.items())
    for owned in rep["owned_bytes_by_rank"]:
        assert owned == {"params": want, "opt_state": 2 * want}
    assert rep["replicated_bitwise_equal"] is True


def test_moe_under_sequence_routes_the_global_sequence(request):
    """``moe_mlp`` on a sequence = 2 world (its chunk of [2, 16, 32] x
    each rank), 4 experts top-2 at capacity factor 1.0: equal to the JAX
    ``moe_mlp`` over the whole sequence -- output and x's gradient
    chunks to 1e-5, the aux loss to 1e-6 relative, each param's gradient
    (the ranks' partials summed) to 1e-5 (measured on an x86 CPU: output
    3.6e-7, x 4.8e-7, aux 1.2e-7, params 2.9e-6).  The capacity drops
    tokens there, and routing each chunk on its own budget gives another
    output (it misses by 1.1: the check of the test's power)."""
    world = request.getfixturevalue("world2")
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 16, 32)).astype(np.float32)
    g = rng.standard_normal((2, 16, 32)).astype(np.float32)
    params = jax.device_get(jax_moe.init_moe_params(
        jax.random.PRNGKey(3), 32, 64, 4))
    kw = dict(top_k=2, capacity_factor=1.0)

    def loss(x_, p_):
        y, aux = jax_moe.moe_mlp(x_, p_, compute_dtype=jnp.float32, **kw)
        return jnp.sum(y * g) + aux

    jy, jaux = jax_moe.moe_mlp(jnp.asarray(x), params,
                               compute_dtype=jnp.float32, **kw)
    jdx, jdp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), params)
    cap = jax_moe.expert_capacity(16, 4, 2, 1.0)
    dispatch, _, _ = jax_moe.top_k_routing(
        jnp.einsum("bsd,de->bse", x, params["router"]), 2, cap)
    assert float(np.asarray(dispatch).sum()) < 2 * 16 * 2   # drops
    per_chunk = np.concatenate([np.asarray(jax_moe.moe_mlp(
        jnp.asarray(x[:, 8 * c:8 * c + 8]), params,
        compute_dtype=jnp.float32, **kw)[0]) for c in (0, 1)], axis=1)
    assert np.abs(per_chunk - np.asarray(jy)).max() > 1e-2
    ranks = sorted(world.run(functools.partial(
        torch_boring.moe_seq_body, x=x, params=params, g=g,
        shape={"sequence": 2}, **kw)), key=lambda r: r["seq"])
    y = np.concatenate([r["y"] for r in ranks], axis=1)
    np.testing.assert_allclose(y, np.asarray(jy), atol=1e-5)
    dx = np.concatenate([r["dx"] for r in ranks], axis=1)
    np.testing.assert_allclose(dx, np.asarray(jdx), atol=1e-5)
    for r in ranks:
        assert r["aux"] == pytest.approx(float(jaux), rel=1e-6)
    for k in params:
        np.testing.assert_allclose(sum(r[f"d{k}"] for r in ranks),
                                   np.asarray(jdp[k]), atol=1e-5)
