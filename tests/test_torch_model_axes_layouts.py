"""The port's sharding plan on the model axes against the JAX package's
(no processes): for the GPT (tied and untied embeddings), the MoE GPT
and the ViT on the meshes (tensor=2), (tensor=4), (expert=2, tensor=2)
and (fsdp=2, sequence=2), every parameter's and optimizer moment's
layout -- the ``(mesh axis, dim)`` pairs that split it -- equals the
JAX plan's ``NamedSharding``, and ``describe()`` is equal dict for dict
(ports of tests/test_transformer.py::test_gpt_params_sharded_by_rules
and tests/test_moe.py::test_moe_expert_weights_sharded_on_expert_axis).
A GQA model whose kv heads do not divide the tensor axis is refused
with the JAX plan's ``ValueError``; ``RankMesh`` coordinates follow the
JAX device order."""

import functools

import numpy as np
import pytest

import jax
import optax

from ray_lightning_accelerators_tpu import Accelerator as JaxAccelerator
from ray_lightning_accelerators_tpu import MeshConfig as JaxMeshConfig
from ray_lightning_accelerators_tpu.core.state import TrainState as JaxState
from ray_lightning_accelerators_tpu.models.transformer import (
    GPT as JaxGPT, TransformerConfig as JaxConfig)
from ray_lightning_accelerators_tpu.models.vit import (
    ViT as JaxViT, ViTConfig as JaxViTConfig)
from ray_lightning_accelerators_tpu.parallel import mesh as jax_mesh
from ray_lightning_accelerators_tpu.parallel import plan as jax_plan
from ray_lightning_accelerators_tpu.parallel import sharding as jax_sharding
from ray_lightning_accelerators_tpu_torch import Accelerator, MeshConfig
from ray_lightning_accelerators_tpu_torch.core.optim import state_layouts
from ray_lightning_accelerators_tpu_torch.models.transformer import (
    GPT, TransformerConfig)
from ray_lightning_accelerators_tpu_torch.models.vit import ViT, ViTConfig
from ray_lightning_accelerators_tpu_torch.parallel import mesh as mesh_lib
from ray_lightning_accelerators_tpu_torch.parallel import plan as plan_lib
from ray_lightning_accelerators_tpu_torch.parallel import sharding
from ray_lightning_accelerators_tpu_torch.utils.weights import params_from_jax

GPT_CFG = dict(vocab_size=256, d_model=64, n_heads=4, d_ff=128,
               n_layers=2, max_seq_len=32)
VIT_CFG = dict(image_size=8, patch_size=4, channels=3, d_model=32,
               n_heads=4, d_ff=64, n_layers=2, n_classes=10)
MODELS = {
    "gpt": (lambda: JaxGPT(JaxConfig(**GPT_CFG)),
            lambda: GPT(TransformerConfig(**GPT_CFG), device="cpu")),
    "gpt_untied": (
        lambda: JaxGPT(JaxConfig(**GPT_CFG, tie_embeddings=False)),
        lambda: GPT(TransformerConfig(**GPT_CFG, tie_embeddings=False),
                    device="cpu")),
    "moe": (lambda: JaxGPT(JaxConfig(**GPT_CFG, num_experts=4)),
            lambda: GPT(TransformerConfig(**GPT_CFG, num_experts=4),
                        device="cpu")),
    "vit": (lambda: JaxViT(JaxViTConfig(**VIT_CFG)),
            lambda: ViT(ViTConfig(**VIT_CFG), device="cpu")),
}
MESHES = {"tp2": dict(data=1, tensor=2), "tp4": dict(data=1, tensor=4),
          "ep2_tp2": dict(data=1, expert=2, tensor=2),
          "fsdp2_sp2": dict(data=1, fsdp=2, sequence=2)}


def _jax_layout(sh):
    """A NamedSharding in the port's layout form."""
    pairs = tuple((a, d) for d, e in enumerate(sh.spec) if e is not None
                  for a in (e if isinstance(e, tuple) else (e,))
                  if jax_mesh.mesh_axis_size(sh.mesh, a) > 1)
    return pairs or None


def _plans(kind, axes):
    jm, pm = MODELS[kind][0](), MODELS[kind][1]()
    key = jax.random.PRNGKey(0)
    jparams = jm.init_params(key)
    n = int(np.prod(list(axes.values())))
    jmesh = jax_mesh.build_mesh(JaxMeshConfig(**axes),
                                devices=jax.devices()[:n])
    tx = jm.configure_optimizers()
    if not isinstance(tx, optax.GradientTransformation):
        tx = optax.adamw(1e-3)
    state = JaxState.create(jparams, tx, key)
    jp = jax_plan.build_plan(jmesh, JaxAccelerator(JaxMeshConfig(**axes)),
                             jm, state, tx)
    pparams = params_from_jax(jax.device_get(jparams), device="cpu")
    pmesh = mesh_lib.build_mesh(MeshConfig(**axes), n)
    pp = plan_lib.build_plan(
        pmesh, Accelerator(MeshConfig(**axes)), pm, pparams,
        functools.partial(state_layouts, pm.configure_optimizers()))
    return jp, pp, jparams, pparams, jmesh, pmesh


@pytest.mark.parametrize("axes", sorted(MESHES))
@pytest.mark.parametrize("kind", sorted(MODELS))
def test_model_axes_layouts_and_describe_match_jax(kind, axes):
    jp, pp, jparams, pparams, jmesh, pmesh = _plans(kind, MESHES[axes])
    jl = [_jax_layout(s) for s in jax.tree.leaves(jp.state_shardings.params)]
    assert plan_lib._leaves(pp.param_layouts) == jl
    jo = [_jax_layout(s) for s in jax.tree.leaves(
        jp.state_shardings.opt_state)]
    assert pp.state_layouts["opt_state"] == jo
    assert pp.describe() == jp.describe()
    # the same divisibility verdict on the params
    sharding.validate_shardings(pparams, pp.param_layouts, pmesh)
    jax_sharding.validate_shardings(jparams, jp.state_shardings.params,
                                    jmesh)


def test_rules_split_the_named_leaves():
    """The GPT at (fsdp=2, tensor=4): ``wi`` on (fsdp, tensor) as in
    test_gpt_params_sharded_by_rules; the MoE ``wi`` at (data=2,
    expert=4) on the expert dim, as test_moe_expert_weights_sharded_on_
    expert_axis; the norm scales and the router replicated."""
    _, pp, *_ = _plans("gpt", dict(data=1, fsdp=2, tensor=4))
    lay = pp.param_layouts["layers"]
    assert lay["mlp"]["wi"] == (("fsdp", 1), ("tensor", 2))
    assert lay["attn"]["wq"] == (("fsdp", 1), ("tensor", 2))
    assert lay["ln1"] is None and pp.param_layouts["ln_f"] is None
    assert pp.param_layouts["embed"] == (("tensor", 0), ("fsdp", 1))
    _, pp, *_ = _plans("moe", dict(data=2, expert=4))
    lay = pp.param_layouts["layers"]["mlp"]
    assert lay["wi"] == (("expert", 1),) and lay["router"] is None


def test_gqa_kv_heads_indivisible_by_tensor_raises_the_jax_error():
    cfg = dict(GPT_CFG, n_heads=4, n_kv_heads=1)
    jm = JaxGPT(JaxConfig(**cfg))
    pm = GPT(TransformerConfig(**cfg), device="cpu")
    jparams = jm.init_params(jax.random.PRNGKey(0))
    jmesh = jax_mesh.build_mesh(JaxMeshConfig(data=1, tensor=2),
                                devices=jax.devices()[:2])
    jsh = JaxAccelerator(JaxMeshConfig(data=1, tensor=2)).param_shardings(
        jmesh, jparams, module=jm)
    with pytest.raises(ValueError) as want:
        jax_sharding.validate_shardings(jparams, jsh, jmesh)
    pparams = params_from_jax(jax.device_get(jparams), device="cpu")
    pmesh = mesh_lib.build_mesh(MeshConfig(data=1, tensor=2), 2)
    psh = Accelerator(MeshConfig(data=1, tensor=2)).param_shardings(
        pmesh, pparams, module=pm)
    with pytest.raises(ValueError) as got:
        sharding.validate_shardings(pparams, psh, pmesh)
    assert str(got.value) == str(want.value)
    assert "['wk']" in str(got.value)


@pytest.mark.parametrize("axes", [dict(data=2, tensor=2),
                                  dict(data=1, fsdp=2, sequence=2),
                                  dict(data=2, expert=2, sequence=2)])
def test_rank_coordinates_follow_the_jax_device_order(axes):
    """Rank r sits where the JAX mesh puts device r: its coordinates are
    the device's index in ``mesh.devices``; the groups of an axis are
    the ranks that differ only along it."""
    n = int(np.prod(list(axes.values())))
    jmesh = jax_mesh.build_mesh(JaxMeshConfig(**axes),
                                devices=jax.devices()[:n])
    shape = mesh_lib.build_mesh(MeshConfig(**axes), n).shape
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    for r in range(n):
        c = mesh_lib.rank_coords(shape, r)
        assert ids[tuple(c[a] for a in jmesh.axis_names)] == \
            jax.devices()[r].id
        assert mesh_lib.coords_rank(shape, c) == r
    for axis in mesh_lib.AXIS_ORDER:
        groups = mesh_lib.axis_groups(shape, (axis,))
        assert sorted(r for g in groups for r in g) == list(range(n))
        for g in groups:
            cs = [mesh_lib.rank_coords(shape, r) for r in g]
            assert [c[axis] for c in cs] == list(range(shape[axis]))
            assert all({k: v for k, v in c.items() if k != axis}
                       == {k: v for k, v in cs[0].items() if k != axis}
                       for c in cs)
