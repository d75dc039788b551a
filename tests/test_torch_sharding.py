"""The port's sharding plan against the JAX package's (no processes): for
the 2-layer d-128 GPT, the MNIST MLP and a wide linear model at 2, 4 and
8 ranks, the per-leaf layout the port's plan gives each parameter and
optimizer moment equals the JAX plan's ``NamedSharding`` (the ``(mesh
axis, dim)`` pairs over the fsdp or, for ZeRO-1, the batch axes);
``describe()`` is equal
dict for dict; the leaves the FSDP heuristic could not shard are the
same; an indivisible logical dim raises the same ``ValueError``; and
``wire_bytes_per_step`` returns the same report.  The JAX side builds
its plans on meshes over ``tests/conftest.py``'s 8 CPU devices."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

from ray_lightning_accelerators_tpu import RayTPUAccelerator as JaxRayTPU
from ray_lightning_accelerators_tpu import Trainer as JaxTrainer
from ray_lightning_accelerators_tpu.core.state import TrainState as JaxState
from ray_lightning_accelerators_tpu.models.mnist import (
    MNISTClassifier as JaxMNIST)
from ray_lightning_accelerators_tpu.models.transformer import (
    GPT as JaxGPT, TransformerConfig as JaxConfig)
from ray_lightning_accelerators_tpu.parallel import collectives as jax_coll
from ray_lightning_accelerators_tpu.parallel import mesh as jax_mesh
from ray_lightning_accelerators_tpu.parallel import plan as jax_plan
from ray_lightning_accelerators_tpu.parallel import sharding as jax_sharding
from ray_lightning_accelerators_tpu_torch import RayTPUAccelerator
from ray_lightning_accelerators_tpu_torch.core.optim import (
    SGD, state_layouts)
from ray_lightning_accelerators_tpu_torch.models.mnist import MNISTClassifier
from ray_lightning_accelerators_tpu_torch.models.transformer import (
    GPT, TransformerConfig)
from ray_lightning_accelerators_tpu_torch.parallel import collectives
from ray_lightning_accelerators_tpu_torch.parallel import mesh as mesh_lib
from ray_lightning_accelerators_tpu_torch.parallel import plan as plan_lib
from ray_lightning_accelerators_tpu_torch.parallel import sharding
from ray_lightning_accelerators_tpu_torch.utils.weights import params_from_jax

from .torch_boring import BoringModel

pytestmark = pytest.mark.fsdp

GPT_CFG = dict(vocab_size=128, d_model=128, n_heads=2, d_ff=256, n_layers=2,
               max_seq_len=64)
WORLDS = [2, 4, 8]


class _Plain:
    """A module with no logical axes (the heuristic decides)."""


def _jax_gpt():
    m = JaxGPT(JaxConfig(**GPT_CFG))
    return m, m.init_params(jax.random.PRNGKey(0)), optax.adamw(
        1e-3, weight_decay=0.01)


def _jax_mnist():
    m = JaxMNIST({"layer_1": 64, "layer_2": 64, "lr": 1e-3})
    return m, m.init_params(jax.random.PRNGKey(0)), optax.adam(1e-3)


def _jax_wide():
    # tests/test_accelerators.py's WideModel, plus a leaf no dim of which
    # divides the ranks (the FSDP heuristic's fallback)
    params = {"layer": {"kernel": jnp.zeros((256, 256)),
                        "bias": jnp.zeros((256,))},
              "odd": jnp.zeros((1001, 63))}
    return _Plain(), params, optax.sgd(0.1)


def _port(kind):
    if kind == "gpt":
        m = GPT(TransformerConfig(**GPT_CFG), device="cpu", lr=1e-3)
        return m, m.configure_optimizers()
    if kind == "mnist":
        m = MNISTClassifier({"layer_1": 64, "layer_2": 64, "lr": 1e-3},
                            device="cpu")
        return m, m.configure_optimizers()
    return _Plain(), SGD(0.1)


MODELS = {"gpt": _jax_gpt, "mnist": _jax_mnist, "wide": _jax_wide}


def _jax_mesh(n, fsdp):
    cfg = (jax_mesh.MeshConfig(data=1, fsdp=n) if fsdp
           else jax_mesh.MeshConfig(data=n))
    return jax_mesh.build_mesh(cfg, devices=jax.devices()[:n])


def _port_mesh(n, fsdp):
    cfg = (mesh_lib.MeshConfig(data=1, fsdp=n) if fsdp
           else mesh_lib.MeshConfig(data=n))
    return mesh_lib.build_mesh(cfg, n)


def _jax_dim(sh):
    """A NamedSharding in the port's layout form: the ``(mesh axis,
    dim)`` pairs of its spec's axes of size > 1, or None."""
    if sh.is_fully_replicated:
        return None
    pairs = tuple((a, d) for d, e in enumerate(sh.spec) if e is not None
                  for a in (e if isinstance(e, tuple) else (e,))
                  if jax_mesh.mesh_axis_size(sh.mesh, a) > 1)
    assert pairs, sh
    return pairs


def _flat_layouts(tree):
    return plan_lib._leaves(tree)


def _plans(kind, n, fsdp, compression=None, zero1=False, accumulate=1):
    """(JAX plan, JAX accelerator, port plan, port accelerator, port
    params) for one configuration.  A layout is compared in the port's
    form (``_jax_dim``)."""
    jmodule, jparams, _ = MODELS[kind]()
    jacc = JaxRayTPU(n, use_fsdp=fsdp)
    jmesh = _jax_mesh(n, fsdp)
    jt = JaxTrainer(accelerator=JaxRayTPU(n, use_fsdp=fsdp),
                    grad_compression=compression,
                    accumulate_grad_batches=accumulate, guard=None,
                    prefetch_batches=0, cache_dataset_on_device=False)
    jt.module = jmodule
    jmodule_tx = getattr(jmodule, "configure_optimizers", None)
    if jmodule_tx is None:
        jmodule.configure_optimizers = lambda: optax.sgd(0.1)
    tx = jt._build_tx(jmodule)
    state = JaxState.create(jparams, tx, jax.random.PRNGKey(0))
    if compression is not None:
        jt.accelerator = jacc
        res, acc = jt._fresh_exchange_buffers(jmodule, jparams, jmesh)
        state = state.replace(residual=res, grad_accum=acc)
    jp = jax_plan.build_plan(jmesh, jacc, jmodule, state, tx,
                             grad_compression=compression,
                             shard_optimizer_state=zero1)
    pmodule, ptx = _port(kind)
    pparams = params_from_jax(jax.device_get(jparams), device="cpu")
    pacc = RayTPUAccelerator(n, use_fsdp=fsdp)
    opt_layouts = functools.partial(
        state_layouts, ptx, accumulate=1 if compression else accumulate)
    pp = plan_lib.build_plan(_port_mesh(n, fsdp), pacc, pmodule, pparams,
                             opt_layouts, grad_compression=compression,
                             shard_optimizer_state=zero1,
                             accumulate=accumulate)
    if not zero1:
        # the accelerator's own view of the same layouts
        assert pacc.state_shardings(_port_mesh(n, fsdp), pparams,
                                    opt_layouts, module=pmodule) == {
            "params": pp.param_layouts,
            "opt_state": pp.state_layouts["opt_state"]}
    return jp, jacc, pp, pacc, pparams


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("kind", ["gpt", "mnist", "wide"])
def test_fsdp_layouts_describe_and_fallbacks_match_jax(kind, n):
    jp, jacc, pp, pacc, _ = _plans(kind, n, fsdp=True)
    jax_params = [_jax_dim(s) for s in jax.tree.leaves(
        jp.state_shardings.params)]
    assert _flat_layouts(pp.param_layouts) == jax_params
    jax_opt = [_jax_dim(s) for s in jax.tree.leaves(
        jp.state_shardings.opt_state)]
    assert pp.state_layouts["opt_state"] == jax_opt
    assert pp.describe() == jp.describe()
    assert pacc.last_fsdp_fallbacks == jacc.last_fsdp_fallbacks
    if kind == "wide":
        assert [f["param"] for f in pacc.last_fsdp_fallbacks] == \
            ["['odd']"]


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("kind", ["gpt", "mnist", "wide"])
def test_zero1_layouts_match_jax(kind, n):
    jp, _, pp, _, _ = _plans(kind, n, fsdp=False, zero1=True)
    jax_opt = [_jax_dim(s) for s in jax.tree.leaves(
        jp.state_shardings.opt_state)]
    assert pp.state_layouts["opt_state"] == jax_opt
    jax_upd = [_jax_dim(s) for s in jax.tree.leaves(
        jp.zero1_update_shardings)]
    assert _flat_layouts(pp.zero1_update_layouts) == jax_upd
    assert pp.describe() == jp.describe()


@pytest.mark.parametrize("compression,fsdp,accumulate", [
    ("int8", False, 1), ("int8", True, 1), ("bf16", False, 2),
    ("bf16", True, 2)])
def test_compressed_plan_describe_matches_jax(compression, fsdp,
                                              accumulate):
    """With the exchange's per-rank buffers: residuals (and, under
    accumulation, accumulators) in the schema, the regime named."""
    jp, _, pp, _, _ = _plans("gpt", 2, fsdp=fsdp, compression=compression,
                             accumulate=accumulate)
    assert pp.describe() == jp.describe()
    assert pp.describe()["regime"] == ("compressed_fsdp" if fsdp else "dp")


def test_fsdp_with_zero1_keeps_the_fsdp_layout(caplog):
    with caplog.at_level("WARNING"):
        jp, _, pp, _, _ = _plans("gpt", 2, fsdp=True, zero1=True)
    assert "ZeRO-1 re-sharding is skipped" in caplog.text
    assert pp.describe() == jp.describe()
    assert pp.zero1_update_layouts is None


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_wire_bytes_match_jax(mode, n):
    jmodule, jparams, _ = _jax_gpt()
    pmodule, _ = _port("gpt")
    pparams = params_from_jax(jax.device_get(jparams), device="cpu")
    jcfg, pcfg = jax_coll.ExchangeConfig(mode=mode), \
        collectives.ExchangeConfig(mode=mode)
    assert collectives.wire_bytes_per_step(pparams, n, pcfg) == \
        jax_coll.wire_bytes_per_step(jparams, n, jcfg)
    jmesh = _jax_mesh(n, True)
    jsh = JaxRayTPU(n, use_fsdp=True).param_shardings(jmesh, jparams,
                                                      module=jmodule)
    psh = RayTPUAccelerator(n, use_fsdp=True).param_shardings(
        _port_mesh(n, True), pparams, module=pmodule)
    want = jax_coll.wire_bytes_per_step(jparams, n, jcfg,
                                        param_shardings=jsh)
    got = collectives.wire_bytes_per_step(pparams, n, pcfg,
                                          param_shardings=psh)
    assert got == want and got["regime"] == "reduce_scatter_all_gather"


def test_indivisible_logical_dim_raises_the_jax_error():
    """A module whose ``embed`` dim (6) does not divide 4 ranks."""
    class Jax6:
        def param_logical_axes(self):
            return {"w": ("embed", None)}

    class Port6(BoringModel):
        def param_logical_axes(self):
            return {"w": ("embed", None)}

    params = {"w": np.zeros((6, 8), np.float32)}
    jmesh = _jax_mesh(4, True)
    jsh = JaxRayTPU(4, use_fsdp=True).param_shardings(jmesh, params,
                                                      module=Jax6())
    with pytest.raises(ValueError) as want:
        jax_sharding.validate_shardings(params, jsh, jmesh)
    mesh = _port_mesh(4, True)
    layouts = RayTPUAccelerator(4, use_fsdp=True).param_shardings(
        mesh, params, module=Port6())
    with pytest.raises(ValueError) as got:
        sharding.validate_shardings(params, layouts, mesh)
    assert str(got.value) == str(want.value)
    assert "not divisible by mesh axes ('fsdp',)" in str(got.value)


def test_logical_rules_and_leaf_authors_match_jax():
    assert sharding.DEFAULT_RULES == jax_sharding.DEFAULT_RULES
    for axes in [("layers", "embed", "heads", "kv"), ("vocab", "embed"),
                 ("embed", "embed"), (None,)]:
        assert sharding.logical_to_spec(axes) == \
            tuple(jax_sharding.logical_to_spec(axes))
    assert plan_lib.FSDP_MIN_LEAF_SIZE == jax_plan.FSDP_MIN_LEAF_SIZE
    jmesh, mesh = _jax_mesh(4, True), _port_mesh(4, True)
    for shape in [(64, 64), (4095,), (1001, 63), (12, 4096), (8, 8)]:
        leaf = np.zeros(shape, np.float32)
        want = jax_plan.fsdp_leaf_spec(jmesh, leaf)
        got = plan_lib.fsdp_leaf_spec(mesh, leaf)
        if want is None:
            assert got == plan_lib.FSDP_FALLBACK
        else:
            dims = [d for d, e in enumerate(want) if e is not None]
            assert got == (dims[0] if dims else None), shape
    dmesh, pmesh = _jax_mesh(4, False), _port_mesh(4, False)
    for shape in [(8, 3), (6,), (12, 4)]:
        leaf = np.zeros(shape, np.float32)
        want = jax_plan.zero1_spec(dmesh, leaf)
        assert plan_lib.zero1_spec(pmesh, leaf) == (0 if len(want) else None)


def test_mesh_sizes_match_jax():
    for n in WORLDS:
        for fsdp in (False, True):
            jm, pm = _jax_mesh(n, fsdp), _port_mesh(n, fsdp)
            assert mesh_lib.data_parallel_size(pm) == \
                jax_mesh.data_parallel_size(jm) == n
            assert mesh_lib.mesh_axis_size(pm, mesh_lib.FSDP_AXIS) == \
                jax_mesh.mesh_axis_size(jm, jax_mesh.FSDP_AXIS)
    assert mesh_lib.BATCH_AXES == jax_mesh.BATCH_AXES


@pytest.mark.parametrize("jax_kwargs,port_kwargs", [
    (dict(grad_compression="int4"), dict(grad_compression="int4")),
    (dict(gather_mode="layer"), dict(gather_mode="layer")),
    (dict(checkpoint_format="msgpack"), dict(checkpoint_format="msgpack")),
])
def test_trainer_refusals_match_jax(jax_kwargs, port_kwargs):
    """A combination the JAX Trainer refuses, the port refuses with the
    same exception type and message."""
    from ray_lightning_accelerators_tpu_torch import Trainer
    with pytest.raises(ValueError) as want:
        JaxTrainer(guard=None, prefetch_batches=0,
                   cache_dataset_on_device=False, **jax_kwargs)
    with pytest.raises(ValueError) as got:
        Trainer(device="cpu", **port_kwargs)
    assert str(got.value) == str(want.value)


def test_compression_with_model_axes_refused_as_jax():
    """grad_compression over a model-parallel axis: the JAX package's
    ``validate_mesh_for_compression`` text (the port refuses it when the
    Trainer is built, before the axis's own not-ported refusal)."""
    from ray_lightning_accelerators_tpu_torch import Trainer
    jmesh = jax_mesh.build_mesh(jax_mesh.MeshConfig(data=2, tensor=2),
                                devices=jax.devices()[:4])
    with pytest.raises(ValueError) as want:
        jax_coll.validate_mesh_for_compression(jmesh)
    with pytest.raises(ValueError) as got:
        Trainer(device="cpu", grad_compression="int8",
                accelerator=RayTPUAccelerator(2, tensor=2))
    assert str(got.value) == str(want.value)
    assert "pure data-parallel" in str(got.value)
