"""Sequence parallelism (ring and Ulysses attention) over gloo ranks on
the CPU, against the JAX package on tests/conftest.py's 8 CPU devices:

- ``ring_attention_sharded`` / ``ulysses_attention_sharded`` at S = 2,
  causal and not, on the same global arrays as the JAX entries: each
  rank's output chunk and its gradients of q, k and v (the ranks'
  partial gradients summed);
- their typed refusals and the S = 1 passthrough to flash attention
  (tests/test_seq_parallel.py, tests/test_ulysses.py);
- ``Trainer(seq_parallel=2)`` in both modes against the JAX Trainer with
  the same settings: data = 2 x sequence = 2 (ring and Ulysses) and
  fsdp = 2 x sequence = 2 (Ulysses), loss trajectories and final params;
- the JAX Trainer's init and fit refusals, and the mode knob's default.

The ranks share one world of 4 (``_fit`` binds it to each trainer);
models come from tests/torch_boring.py (no JAX)."""

import functools

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
from ray_lightning_accelerators_tpu.models.transformer import (
    GPT as JaxGPT, TransformerConfig as JaxConfig)
from ray_lightning_accelerators_tpu.ops.attention import (
    flash_attention as jax_flash)
from ray_lightning_accelerators_tpu.parallel import mesh as jax_mesh
from ray_lightning_accelerators_tpu.parallel.ring_attention import (
    ring_attention_sharded as jax_ring)
from ray_lightning_accelerators_tpu.parallel.ulysses import (
    ulysses_attention_sharded as jax_ulysses)
from ray_lightning_accelerators_tpu_torch import (
    Accelerator, DataLoader, MeshConfig, RayTPUAccelerator, Trainer,
    ring_attention_sharded, ulysses_attention_sharded)
from ray_lightning_accelerators_tpu_torch.data.loader import ArrayDataset
from ray_lightning_accelerators_tpu_torch.models.transformer import (
    GPT, TransformerConfig)
from ray_lightning_accelerators_tpu_torch.ops.attention import (
    flash_attention)
from ray_lightning_accelerators_tpu_torch.parallel import mesh as mesh_lib
from ray_lightning_accelerators_tpu_torch.runtime import bootstrap
from ray_lightning_accelerators_tpu_torch.runtime.bootstrap import (
    DistributedWorld)
from ray_lightning_accelerators_tpu_torch.utils.weights import (
    params_from_jax)

from . import torch_boring
from .torch_boring import BoringModel, boring_loaders

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


# --------------------------------------------------------------------- #
# The sharded attention entries                                          #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_sharded_attention_matches_jax(world, mode, causal):
    """[2, 4, 16, 8] global q, k, v on a data=2 x sequence=2 world (both
    data replicas compute the same): the chunks of the output gathered
    equal the JAX entry's on a sequence=2 mesh, and the ranks' gradients
    of ``sum(out * g)`` summed equal JAX's, to 2e-5 / 1e-4 absolute
    (f32; the online softmax sums in another order; measured 4.8e-7 and
    6.0e-7 on an x86 CPU).  The ring's ppermute runs point to point on the CPU."""
    rng = np.random.default_rng(7)
    q, k, v, g = (rng.standard_normal((2, 4, 16, 8)).astype(np.float32)
                  for _ in range(4))
    jmesh = jax_mesh.build_mesh(JaxMeshConfig(data=1, sequence=2),
                                devices=jax.devices()[:2])
    entry = jax_ring if mode == "ring" else jax_ulysses

    def loss(q_, k_, v_):
        return jnp.sum(entry(q_, k_, v_, jmesh, causal=causal) * g)

    want = entry(*(jnp.asarray(a) for a in (q, k, v)), jmesh, causal=causal)
    jgrads = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    ranks = world.run(functools.partial(
        torch_boring.seq_attention_body, mode=mode, causal=causal, q=q,
        k=k, v=v, g=g, shape={"data": 2, "sequence": 2}))
    for b in (0, 1):
        mine = sorted((r for r in ranks if r["batch"] == b),
                      key=lambda r: r["seq"])
        out = np.concatenate([r["out"] for r in mine], axis=2)
        np.testing.assert_allclose(out, np.asarray(want), atol=2e-5)
        for name, jg in zip(("dq", "dk", "dv"), jgrads):
            np.testing.assert_allclose(sum(r[name] for r in mine),
                                       np.asarray(jg), atol=1e-4)
    comms = ranks[0]["comms"]
    if mode == "ring":
        assert comms["ppermute_via"] == "p2p"
        assert comms["counts"]["ppermute"] == 4      # k, v; forward, back
    else:
        assert comms["counts"]["all_to_all"] == 8    # q, k, v, o; and back


def test_sharded_attention_refusals_and_seq1_passthrough():
    """tests/test_seq_parallel.py:101 and tests/test_ulysses.py:62: an
    indivisible sequence and, for Ulysses, indivisible heads refuse with
    the JAX text; without a sequence axis both entries ARE flash
    attention."""
    rng = np.random.default_rng(9)
    mesh = mesh_lib.Mesh({"data": 2, "fsdp": 2, "sequence": 2})
    jmesh = jax_mesh.build_mesh(JaxMeshConfig(data=2, fsdp=2, sequence=2))
    bad_seq = rng.standard_normal((4, 4, 9, 8)).astype(np.float32)
    bad_heads = rng.standard_normal((4, 3, 16, 8)).astype(np.float32)
    cases = [(ulysses_attention_sharded, jax_ulysses, bad_seq),
             (ring_attention_sharded, jax_ring, bad_seq),
             (ulysses_attention_sharded, jax_ulysses, bad_heads)]
    for port_fn, jax_fn, x in cases:
        with pytest.raises(ValueError) as want:
            jax_fn(*(jnp.asarray(x),) * 3, jmesh)
        t = torch.from_numpy(x)
        with pytest.raises(ValueError) as got:
            port_fn(t, t, t, mesh)
        assert str(got.value) == str(want.value)
    flat = mesh_lib.Mesh({"data": 4, "fsdp": 2})
    q = torch.from_numpy(rng.standard_normal((4, 4, 16, 8))
                         .astype(np.float32))
    ref = flash_attention(q, q, q, True, None)
    assert torch.equal(ulysses_attention_sharded(q, q, q, flat), ref)
    assert torch.equal(ring_attention_sharded(q, q, q, flat), ref)
    np.testing.assert_allclose(
        ref.numpy(), np.asarray(jax_flash(*(jnp.asarray(q.numpy()),) * 3,
                                          True, None)), atol=2e-6)


# --------------------------------------------------------------------- #
# Trainer(seq_parallel=2)                                                #
# --------------------------------------------------------------------- #
DATA = _tokens(24, seed=5)


@pytest.fixture(scope="module")
def jax_init():
    return jax.device_get(JaxGPT(JaxConfig(**CFG)).init_params(
        jax.random.PRNGKey(0)))


def _jax_fit(jax_init, root, mode, use_fsdp):
    jm = JaxGPT(JaxConfig(**CFG), lr=3e-3)
    jm.params = jax.tree.map(jnp.asarray, jax_init)
    jt = JaxTrainer(accelerator=JaxRayTPU(2, use_fsdp=use_fsdp),
                    seq_parallel=2, seq_parallel_mode=mode, guard=None,
                    prefetch_batches=0, cache_dataset_on_device=False,
                    default_root_dir=str(root), **COMMON)
    jt.fit(jm, JaxDataLoader(JaxArrayDataset(DATA), batch_size=4,
                             shuffle=True, use_native=False))
    return jt, jm


def _fit(world, root, model, loader, acc, **kw):
    t = Trainer(device="cpu", accelerator=acc, default_root_dir=str(root),
                **kw)
    t._world = world
    t.fit(model, loader)
    t._world = None
    return t


@pytest.mark.parametrize("mode,use_fsdp", [("ring", False),
                                           ("ulysses", False),
                                           ("ulysses", True)])
def test_seq_parallel_fit_matches_jax_trainer(world, jax_init, tmp_path,
                                              mode, use_fsdp):
    """6 steps (24 shuffled rows, global batch 4, clipping at 0.5) on
    data = 2 (or fsdp = 2) x sequence = 2: the loss and the global grad
    norm within 1e-4 relative at every step (JAX's
    test_loss_parity_ulysses_and_ring_on_seq_axis bound), the final
    params within 1e-3 relative L2 per leaf (measured on an x86 CPU:
    loss 2.7e-7, norm 1.7e-6, params 8.9e-6).  The module runs the requested mode, the plan
    carries the axis, and each rank read its batch shard's rows whole
    (its chunk cut in the model)."""
    jt, jm = _jax_fit(jax_init, tmp_path / "jax", mode, use_fsdp)
    tm = GPT(TransformerConfig(**CFG), device="cpu", lr=3e-3)
    tm.params = params_from_jax(jax_init, device="cpu")
    acc = RayTPUAccelerator(2, use_fsdp=use_fsdp)
    tt = _fit(world, tmp_path / "port", tm,
              DataLoader(ArrayDataset(DATA), batch_size=4, shuffle=True),
              acc, seq_parallel=2, seq_parallel_mode=mode, **COMMON)
    assert acc.mesh_config.sequence == 1     # the caller's is untouched
    assert tt.accelerator.mesh_config.sequence == 2
    jl, tl = _history(jt, "train_loss"), _history(tt, "train_loss")
    assert len(tl) == len(jl) == 6
    for a, b in zip(tl, jl):
        assert a == pytest.approx(b, rel=1e-4)
    for a, b in zip(_history(tt, "grad_norm"), _history(jt, "grad_norm")):
        assert a == pytest.approx(b, rel=1e-4)
    jp, tp = _flat(jax.device_get(jm.params)), _flat(tm.params)
    for name in jp:
        assert _rel_l2(tp[name], jp[name]) <= 1e-3, name
    rep = tt.rank_report
    assert rep["plan"]["seq"] == jt._plan.describe()["seq"] == 2
    assert rep["plan"] == jt._plan.describe()
    assert tm.cfg.context_parallel == mode
    key = "ppermute" if mode == "ring" else "all_to_all"
    assert rep["model_comms"]["counts"][key] > 0


def test_init_refusals_match_jax(monkeypatch):
    """tests/test_seq_parallel.py:156: the JAX Trainer's types and
    messages; the mode knob's default (``ulysses``) and its env value."""
    jax_acc = lambda: JaxAccelerator(JaxMeshConfig(data=2))  # noqa: E731
    cases = [
        (dict(seq_parallel=0), dict(seq_parallel=0)),
        (dict(seq_parallel_mode="flash"), dict(seq_parallel_mode="flash")),
        (dict(seq_parallel=2, pipeline_stages=2, accelerator=jax_acc()),
         dict(seq_parallel=2, pipeline_stages=2,
              accelerator=Accelerator(MeshConfig(data=2)))),
        (dict(seq_parallel=2, grad_compression="int8",
              accelerator=jax_acc()),
         dict(seq_parallel=2, grad_compression="int8",
              accelerator=Accelerator(MeshConfig(data=2)))),
        (dict(seq_parallel=2, accelerator=JaxAccelerator(
            JaxMeshConfig(data=2, sequence=4))),
         dict(seq_parallel=2, accelerator=Accelerator(
             MeshConfig(data=2, sequence=4)))),
    ]
    for jkw, pkw in cases:
        with pytest.raises(ValueError) as want:
            JaxTrainer(guard=None, prefetch_batches=0,
                       cache_dataset_on_device=False, **jkw)
        with pytest.raises(ValueError) as got:
            Trainer(device="cpu", **pkw)
        assert str(got.value) == str(want.value)
    monkeypatch.delenv("RLA_TPU_SEQ_PARALLEL_MODE", raising=False)
    assert Trainer(device="cpu", seq_parallel=2).seq_parallel_mode == \
        "ulysses"
    monkeypatch.setenv("RLA_TPU_SEQ_PARALLEL_MODE", "ring")
    t = Trainer(device="cpu", seq_parallel=2,
                accelerator=Accelerator(MeshConfig(data=2)))
    assert t.seq_parallel_mode == "ring"
    assert t.accelerator.mesh_config.sequence == 2
    monkeypatch.setenv("RLA_TPU_SEQ_PARALLEL_MODE", "flash")
    with pytest.raises(ValueError, match="'ulysses' or 'ring'"):
        Trainer(device="cpu", seq_parallel=2)


def test_fit_refusals_match_jax(tmp_path):
    """tests/test_seq_parallel.py:182: raised by fit before any rank
    starts: a max_seq_len the axis does not divide, Ulysses heads (naming
    ring), a module without a context-parallel dispatch."""
    def port_fit(mode, model, loader):
        t = Trainer(device="cpu", accelerator=Accelerator(
            MeshConfig(data=1)), seq_parallel=4, seq_parallel_mode=mode,
            max_epochs=1, precision="f32", enable_checkpointing=False,
            default_root_dir=str(tmp_path))
        with pytest.raises(ValueError) as e:
            t.fit(model, loader)
        assert t._world is None      # nothing was spawned
        return str(e.value)

    tokens = DataLoader(ArrayDataset(_tokens(8)), batch_size=4)
    m30 = GPT(TransformerConfig(**{**CFG, "max_seq_len": 30}), device="cpu")
    assert "not divisible" in port_fit("ring", m30, tokens)
    m2 = GPT(TransformerConfig(**{**CFG, "n_heads": 2}), device="cpu")
    assert "seq_parallel_mode='ring'" in port_fit("ulysses", m2, tokens)
    text = port_fit("ring", BoringModel(), boring_loaders()[0])
    assert "context-parallel-aware" in text
    jt = JaxTrainer(guard=None, prefetch_batches=0,
                    cache_dataset_on_device=False,
                    accelerator=JaxAccelerator(JaxMeshConfig(data=1)),
                    seq_parallel=4, seq_parallel_mode="ring")
    with pytest.raises(ValueError) as want:
        jt._apply_seq_parallel(type("M", (), {})(), 4)
    assert text == str(want.value).replace("M cannot", "BoringModel cannot")
