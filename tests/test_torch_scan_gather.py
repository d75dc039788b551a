"""The scan gather (``Trainer(gather_mode="scan")``, the port's
``parallel/collectives.py`` ``build_scan_param_gather`` /
``build_scan_local_grads``): each layer's bf16 slices all-gathered at the
top of that layer, the backward's bf16 reduce-scatter into the owner,
over 4 gloo ranks on the CPU, against the JAX package:

- the hook and the finished gradients against JAX's builders on meshes of
  4 host devices (``fsdp=4`` and ``data=2 x fsdp=2``);
- the port's Trainer against the JAX Trainer on a small scanned module
  (JAX's GPT does not train under ``grad_compression`` on this jax: its
  own scan tests in tests/test_overlap_gather.py fail there), both
  meshes;
- the port's GPT at tests/test_overlap_gather.py's config, scan against
  tree: the step-1 loss, the trajectory, the layouts and residuals, the
  wire report, remat with dropout and accumulation, a checkpoint across
  the mode change, no builds once warm;
- ``validate_scan_gather``'s refusals and ``wire_bytes_per_step`` key for
  key against JAX's, and the FSDP layout on a mesh with a data axis (F2:
  the port split fsdp leaves over data x fsdp, where JAX splits them over
  fsdp alone).

The ranks share one world of 4 (``_fit`` binds it to each trainer); the
models live in tests/torch_boring.py."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from ray_lightning_accelerators_tpu import RayTPUAccelerator as JaxRayTPU
from ray_lightning_accelerators_tpu import TpuModule
from ray_lightning_accelerators_tpu import Trainer as JaxTrainer
from ray_lightning_accelerators_tpu.accelerators.base import (
    Accelerator as JaxAccelerator)
from ray_lightning_accelerators_tpu.data.loader import (
    ArrayDataset as JaxArrayDataset, DataLoader as JaxDataLoader)
from ray_lightning_accelerators_tpu.parallel import collectives as JC
from ray_lightning_accelerators_tpu.parallel import mesh as jax_mesh
from ray_lightning_accelerators_tpu_torch import (DataLoader,
                                                  RayTPUAccelerator, Trainer)
from ray_lightning_accelerators_tpu_torch.accelerators.base import (
    Accelerator)
from ray_lightning_accelerators_tpu_torch.data.loader import ArrayDataset
from ray_lightning_accelerators_tpu_torch.models.transformer import (
    GPT, TransformerConfig)
from ray_lightning_accelerators_tpu_torch.parallel import collectives as C
from ray_lightning_accelerators_tpu_torch.parallel import mesh as mesh_lib
from ray_lightning_accelerators_tpu_torch.runtime import bootstrap
from ray_lightning_accelerators_tpu_torch.runtime.bootstrap import (
    DistributedWorld)
from ray_lightning_accelerators_tpu_torch.utils import (
    sharded_checkpoint as sharded_lib)

from . import torch_boring
from .test_torch_fsdp import _replica_rows
from .torch_boring import (BuildCounts, ScannedMLP, scan_gather_body,
                           scanned_data, scanned_mlp_init, two_threads)

pytestmark = pytest.mark.fsdp
torch.backends.cuda.matmul.allow_tf32 = False

MESHES = {"fsdp4": dict(data=1, fsdp=4), "data2_fsdp2": dict(data=2, fsdp=2)}


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


def _fit(world, root, model, loader, acc, **kw):
    """A port fit over the module's world (bound to the trainer)."""
    t = Trainer(device="cpu", accelerator=acc, default_root_dir=str(root),
                **kw)
    t._world = world
    try:
        t.fit(model, loader)
    finally:
        t._world = None     # the module's fixture ends the world
    return t


def _port_acc(mesh: str):
    if mesh == "fsdp4":
        return RayTPUAccelerator(4, use_fsdp=True, init_hook=two_threads)
    return Accelerator(mesh_lib.MeshConfig(**MESHES[mesh]), use_fsdp=True,
                       init_hook=two_threads)


def _jax_acc(mesh: str):
    if mesh == "fsdp4":
        return JaxRayTPU(4, use_fsdp=True)
    return JaxAccelerator(jax_mesh.MeshConfig(**MESHES[mesh]), use_fsdp=True,
                          devices=jax.devices()[:4])


def _jax_mesh(mesh: str) -> JaxMesh:
    sizes = jax_mesh.MeshConfig(**MESHES[mesh]).axis_sizes(4)
    shape = tuple(sizes[a] for a in jax_mesh.AXIS_ORDER)
    return JaxMesh(np.asarray(jax.devices()[:4], dtype=object).reshape(shape),
                   jax_mesh.AXIS_ORDER)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _history(trainer, key):
    return [r[key] for r in trainer.logger.history if key in r]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree.detach().cpu().numpy()
                               if isinstance(tree, torch.Tensor) else tree)}


class JaxScannedMLP(TpuModule):
    """tests/torch_boring.py ``ScannedMLP`` for the JAX Trainer: the layer
    stack through ``jax.lax.scan``, the in-scan gather at the top of its
    body (the JAX GPT's pattern)."""

    def init_params(self, rng):
        return jax.tree.map(jnp.asarray, scanned_mlp_init(0))

    def scanned_param_subtrees(self):
        return ("layers",)

    def forward(self, params, x):
        gather = JC.current_layer_gather("layers")

        def body(h, lp):
            if gather is not None:
                lp = gather(lp)
            return jnp.tanh((h @ lp["w"]) * lp["s"]), None

        h, _ = jax.lax.scan(body, x, params["layers"])
        return h @ params["head"]

    def training_step(self, params, batch, rng):
        x, y = batch
        loss = optax.softmax_cross_entropy_with_integer_labels(
            self.forward(params, x), y).mean()
        return loss, {"loss": loss}

    def configure_optimizers(self):
        return optax.adam(1e-2)


# --------------------------------------------------------------------- #
# (a) the hook and the finished gradients against JAX's builders         #
# --------------------------------------------------------------------- #
def _jax_scan_grads(mesh_name, params, layouts, x, y):
    """JAX ``build_scan_param_gather`` / ``build_scan_local_grads`` on a
    mesh of 4 host devices: layer 1 through the hook, then the gradients
    of the scanned module's loss (each replica its contiguous block)."""
    mesh = _jax_mesh(mesh_name)

    def spec(d, ndim):
        if d is None:
            return P()
        return P(*[jax_mesh.FSDP_AXIS if i == d else None
                   for i in range(ndim)])

    shardings = jax.tree.map(
        lambda a, d: NamedSharding(mesh, spec(d, a.ndim)), params,
        layouts, is_leaf=lambda v: v is None)
    scanned = ("layers",)
    prelude, hooks = JC.build_scan_param_gather(mesh, shardings, scanned)
    model = JaxScannedMLP()

    def vag(p, batch, rng):
        return jax.value_and_grad(
            lambda q: model.training_step(q, batch, rng), has_aux=True)(p)

    local = JC.build_scan_local_grads(mesh, vag, P(jax_mesh.BATCH_AXES),
                                      shardings, scanned, hooks)
    placed = jax.device_put(jax.tree.map(jnp.asarray, params), shardings)
    batch = jax.device_put((jnp.asarray(x), jnp.asarray(y)),
                           NamedSharding(mesh, P(jax_mesh.BATCH_AXES)))
    metrics, grads = jax.jit(lambda p, b: local(prelude(p), b,
                                                jax.random.PRNGKey(0)))(
        placed, batch)
    one = shard_map(
        lambda s, w: hooks["layers"]({"s": s[1], "w": w[1]})["w"],
        mesh=mesh, in_specs=(P(), shardings["layers"]["w"].spec),
        out_specs=P(), check_rep=False)(placed["layers"]["s"],
                                        placed["layers"]["w"])
    return (np.asarray(one), float(metrics["loss"]),
            jax.tree.map(np.asarray, jax.device_get(grads)))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_scan_hook_and_local_grads_match_jax_builders(world, mesh):
    """The scanned module's params (``layers.w`` split on dim 1, the
    replicated ``layers.s``, ``head`` split on dim 0 outside the scan)
    through the port's prelude, hook and finish on 4 gloo ranks and
    through JAX's builders on 4 host devices, the same rows on each
    replica.  The gathered layer is bitwise (bf16 on the wire both ways);
    the ``scan_repl`` mean (``layers.s``) and each replica's raw ``rest``
    gradient (``head``) within 1e-6; ``layers.w``'s ``scan_rs`` gradient,
    a sum of bf16 cotangents rounded in bf16 in the wire's own order
    (gloo's and XLA's orders differ): each element within 2^-6 of the
    largest (two bf16 rounding steps at its magnitude) and 4e-3 relative
    L2.  The port made 4 gathers (the layer-1 probe and 3 layers) and
    3 reduce-scatters on each rank."""
    params = scanned_mlp_init(0)
    layouts = {"layers": {"s": None, "w": 1}, "head": 0}
    x, y = scanned_data(32)
    jone, jloss, jgrads = _jax_scan_grads(mesh, params, layouts, x, y)
    np.testing.assert_array_equal(
        jone, params["layers"]["w"][1].astype(jnp.bfloat16)
        .astype(np.float32))
    ranks = world.run(functools.partial(
        scan_gather_body, shape=MESHES[mesh], params=params,
        layouts=layouts, x=x, y=y))
    names = ["head", "layers/s", "layers/w"]
    jg = [jgrads["head"], jgrads["layers"]["s"], jgrads["layers"]["w"]]
    nf = MESHES[mesh]["fsdp"]
    for r, out in enumerate(ranks):
        assert out["kinds"] == ["rest", "scan_repl", "scan_rs"]
        assert out["layer_collectives"] == {"all_gather": 4,
                                            "reduce_scatter": 3}
        np.testing.assert_array_equal(out["gathered"], jone)
        head, s, w = out["grads"]
        # rest: this replica's whole local gradient (JAX stacks [n, ...])
        np.testing.assert_allclose(head, jg[0][r], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(s, jg[1], rtol=1e-6, atol=1e-6)
        f = out["coords"]["fsdp"]
        k = jg[2].shape[1] // nf
        want = jg[2][:, f * k:(f + 1) * k]
        assert w.shape == want.shape, names
        gap = np.abs(w - want).max() / np.abs(jg[2]).max()
        print(f"scan_rs gap {mesh} rank {r}: max {gap:.3g}, "
              f"rel L2 {_rel_l2(w, want):.3g}")
        assert gap <= 2 ** -6 and _rel_l2(w, want) <= 4e-3
    # the mean of the replicas' losses is JAX's pmean'd loss
    assert np.mean([o["loss"] for o in ranks]) == pytest.approx(jloss,
                                                                rel=1e-6)


# --------------------------------------------------------------------- #
# (b) the Trainer on the scanned module against the JAX Trainer          #
# --------------------------------------------------------------------- #
COMMON = dict(max_epochs=2, precision="f32", log_every_n_steps=1,
              log_grad_norm=True, enable_checkpointing=False, seed=0)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_scanned_module_fit_matches_jax_trainer(world, tmp_path, mesh):
    """``grad_compression="int8"``, ``gather_mode="scan"``, ``use_fsdp``
    on 4 ranks, 8 Adam steps (128 rows, batch 32) over the scanned module
    against the JAX Trainer on the same mesh, rows aligned as in
    tests/test_torch_fsdp.py (``_replica_rows``).  Both engage the scan
    gather: ``comms_per_step`` equal key for key.  The limits are the
    compressed parity tests' (tests/test_torch_fsdp.py) scaled to this
    module's Adam learning rate, 1e-2 against their 1e-3 (a gradient
    element near 0 moves its parameter by up to the learning rate
    whatever its last bits, so the trajectories part ten times faster):
    the loss and the logged grad norm 2e-3 relative at every step, the
    final params 1e-2 relative L2 per leaf (after a flip: here a
    ``layers.w`` gradient element rounded to the other bf16 neighbour,
    the wire's sums taken in another order, gloo's against XLA's, from
    the first step).  Measured: fsdp 4 loss 1.4e-3, norm 9.3e-4, params
    2.0e-3; data 2 x fsdp 2 loss 2.2e-4, norm 1.8e-4, params 2.1e-4.  Each rank holds its fsdp slice of
    ``layers.w`` with a placeholder residual and made one gather and one
    reduce-scatter a layer a step."""
    x, y = scanned_data(128)
    rows = _replica_rows(128, 32, n=4)
    kw = dict(grad_compression="int8", gather_mode="scan", **COMMON)
    jm = JaxScannedMLP()
    jt = JaxTrainer(accelerator=_jax_acc(mesh), guard=None,
                    prefetch_batches=0, cache_dataset_on_device=False,
                    default_root_dir=str(tmp_path / "jax"), **kw)
    jt.fit(jm, JaxDataLoader(JaxArrayDataset(x[rows], y[rows]),
                             batch_size=32, shuffle=False, use_native=False))
    tm = ScannedMLP()
    tt = _fit(world, tmp_path / "port", tm,
              DataLoader(ArrayDataset(x, y), batch_size=32, shuffle=False),
              _port_acc(mesh), **kw)
    assert jt.comms_per_step["gather_mode"] == "scan"
    assert tt.comms_per_step == jt.comms_per_step
    jl, tl = _history(jt, "train_loss"), _history(tt, "train_loss")
    jn, tn = _history(jt, "grad_norm"), _history(tt, "grad_norm")
    assert len(tl) == len(jl) == len(tn) == len(jn) == 8
    gap_l = [abs(a - b) / abs(b) for a, b in zip(tl, jl)]
    gap_n = [abs(a - b) / abs(b) for a, b in zip(tn, jn)]
    assert max(gap_l) <= 2e-3 and max(gap_n) <= 2e-3, (gap_l, gap_n)
    assert tl[-1] < tl[0]
    jp, tp = _flat(jax.device_get(jm.params)), _flat(tm.params)
    assert jp.keys() == tp.keys()
    for name in jp:
        assert _rel_l2(tp[name], jp[name]) <= 1e-2, name
    rep = tt.rank_report
    nf = MESHES[mesh]["fsdp"]
    shapes = rep["state_shapes"]
    assert shapes["params/layers/w"] == [3, 64 // nf, 64]
    assert shapes["residual/layers/w"] == [1]
    assert rep["layer_collectives"] == {"all_gather": 3 * 8,
                                        "reduce_scatter": 3 * 8}


# --------------------------------------------------------------------- #
# (c) the port's GPT: scan against tree                                  #
# --------------------------------------------------------------------- #
VOCAB = 256
GPT_CFG = dict(vocab_size=VOCAB, d_model=64, n_heads=4, d_ff=128,
               n_layers=4, max_seq_len=32, fused_loss=True,
               loss_chunk_rows=64)


def _gpt(n_layers=4, **over):
    return GPT(TransformerConfig(**{**GPT_CFG, "n_layers": n_layers,
                                    **over}), device="cpu", lr=1e-3)


def _loader(n=64, bs=16):
    toks = np.random.default_rng(0).integers(
        0, VOCAB, size=(n, 32)).astype(np.int32)
    return DataLoader(ArrayDataset(toks), batch_size=bs, shuffle=False)


def _gpt_fit(world, root, mode, model=None, **kw):
    kw = {"max_epochs": 2, "enable_checkpointing": False, **kw}
    return _fit(world, root, model or _gpt(), _loader(),
                RayTPUAccelerator(4, use_fsdp=True, init_hook=two_threads),
                precision="f32", seed=0, log_every_n_steps=1,
                grad_compression="int8", gather_mode=mode, **kw)


@pytest.fixture(scope="module")
def gpt_fits(world, tmp_path_factory):
    """The GPT fit under each mode (tests/test_overlap_gather.py's
    ``_fit``: 64 rows, batch 16, 2 epochs, f32, Adam 1e-3)."""
    root = tmp_path_factory.mktemp("gpt")
    out = {}
    for mode in ("tree", "scan"):
        model = _gpt()
        out[mode] = (_gpt_fit(world, root / mode, mode, model), model)
    return out


def test_gpt_scan_matches_tree_gather_over_adam_run(gpt_fits):
    """tests/test_overlap_gather.py:58 against the port: the first step's
    loss is bitwise (both forwards see the same bf16-rounded weights and
    nothing has been exchanged yet); the final params within 2e-2
    relative L2 per leaf and the last loss within 2e-2 (JAX's bound: the
    tree run quantizes the layer stack's gradients to int8, the scan run
    reduce-scatters them exactly in bf16)."""
    (tt, tm), (st, sm) = gpt_fits["tree"], gpt_fits["scan"]
    assert st.comms_per_step["gather_mode"] == "scan"
    assert tt.comms_per_step["gather_mode"] == "tree"
    lt, ls = _history(tt, "train_loss"), _history(st, "train_loss")
    assert len(lt) == len(ls) == 8
    assert ls[0] == lt[0]
    pt, ps = _flat(tm.params), _flat(sm.params)
    for name in pt:
        assert _rel_l2(ps[name], pt[name]) < 2e-2, name
    assert abs(ls[-1] - lt[-1]) / lt[-1] < 2e-2, (lt, ls)


def test_gpt_scan_state_layouts_and_wire_report(gpt_fits):
    """tests/test_overlap_gather.py:81 against the port: the layer stack
    stays this rank's 1/4 slice, its residuals are ``[1]`` placeholders,
    the embedding (gathered up front, quantized reduce-scatter) keeps a
    real owned-chunk residual; the wire report prices the per-layer
    traffic as hidden, exposed + hidden is the exchange, and the exposed
    bytes drop against the tree run's.  Each rank made one gather and
    one reduce-scatter a layer a step (4 x 8)."""
    (tt, _), (st, _) = gpt_fits["tree"], gpt_fits["scan"]
    shapes = st.rank_report["state_shapes"]
    assert shapes["params/layers/attn/wq"] == [4, 64 // 4, 4, 16]
    assert shapes["residual/layers/attn/wq"] == [1]
    assert shapes["residual/layers/ln1"] == [1]
    assert shapes["residual/embed"][0] > 1
    comms, tree = st.comms_per_step, tt.comms_per_step
    assert comms["hidden_bytes_per_step"] > 0
    assert (comms["exposed_bytes_per_step"] + comms["hidden_bytes_per_step"]
            == comms["exchange_bytes_per_step"])
    assert tree["hidden_bytes_per_step"] == 0
    assert comms["exposed_bytes_per_step"] < tree["exposed_bytes_per_step"]
    assert st.rank_report["layer_collectives"] == {"all_gather": 32,
                                                   "reduce_scatter": 32}
    assert tt.rank_report["layer_collectives"] == {"all_gather": 0,
                                                   "reduce_scatter": 0}


def test_gpt_scan_composes_with_remat_dropout_and_accumulation(world,
                                                               tmp_path):
    """tests/test_overlap_gather.py:110 against the port: remat
    ``"nothing"`` (the gather inside the checkpointed layer: the
    recompute re-gathers, 8 gathers and 4 reduce-scatters a step), dropout
    0.1 and ``accumulate_grad_batches=2`` train to a finite loss, and the
    accumulator of a scanned leaf is its param's shape (the 1/4 slice)."""
    model = _gpt(remat=True, remat_policy="nothing", dropout=0.1)
    t = _gpt_fit(world, tmp_path, "scan", model, accumulate_grad_batches=2)
    assert t.global_step > 0
    assert np.isfinite(float(t.callback_metrics["train_loss"]))
    shapes = t.rank_report["state_shapes"]
    assert shapes["grad_accum/layers/attn/wq"] == \
        shapes["params/layers/attn/wq"] == [4, 16, 4, 16]
    assert t.rank_report["layer_collectives"] == {"all_gather": 8 * 8,
                                                  "reduce_scatter": 4 * 8}


@pytest.mark.parametrize("first,second", [("tree", "scan"),
                                          ("scan", "tree")])
def test_checkpoint_resumes_across_gather_mode_change(world, tmp_path,
                                                      first, second):
    """tests/test_overlap_gather.py:128 against the port, both ways: a
    sharded checkpoint of a fit under one mode resumes under the other
    (params and moments by their global shapes; the layer stack's
    residuals, real under "tree" and placeholders under "scan", reset to
    the new layout) and trains on from the saved step."""
    t1 = _gpt_fit(world, tmp_path / "a", first, enable_checkpointing=True,
                  checkpoint_format="sharded")
    path = t1.checkpoint_callback.best_model_path
    assert sharded_lib.verify_checkpoint(path) == (True, "ok")
    model = _gpt()
    t2 = Trainer(device="cpu", default_root_dir=str(tmp_path / "b"),
                 accelerator=RayTPUAccelerator(4, use_fsdp=True,
                                               init_hook=two_threads),
                 precision="f32", seed=0, log_every_n_steps=1,
                 grad_compression="int8", gather_mode=second, max_epochs=3,
                 enable_checkpointing=False, checkpoint_format="sharded")
    t2._world = world
    try:
        t2.fit(model, _loader(), ckpt_path=path)
    finally:
        t2._world = None
    assert t2.global_step > t1.global_step == 8
    assert t2.comms_per_step["gather_mode"] == second
    shapes = t2.rank_report["state_shapes"]
    chunk = 4 * 64 * 4 * 16 // 4
    assert shapes["residual/layers/attn/wq"] == (
        [1] if second == "scan" else [chunk])
    assert np.isfinite(float(t2.callback_metrics["train_loss"]))


def test_gpt_scan_no_builds_after_warmup(world, tmp_path):
    """tests/test_overlap_gather.py:155 against the port: 12 steps of a
    2-layer GPT under the scan gather make no kernel or library build
    after the first step on any rank (``compile_count``)."""
    torch_boring.REPORTS.clear()
    toks = np.random.default_rng(0).integers(
        0, VOCAB, size=(96, 32)).astype(np.int32)
    t = Trainer(device="cpu", default_root_dir=str(tmp_path),
                accelerator=RayTPUAccelerator(4, use_fsdp=True,
                                              init_hook=two_threads),
                max_steps=12, max_epochs=6, precision="f32", seed=0,
                enable_checkpointing=False, log_every_n_steps=4,
                grad_compression="int8", gather_mode="scan",
                callbacks=[BuildCounts()])
    t._world = world
    try:
        t.fit(_gpt(n_layers=2), DataLoader(ArrayDataset(toks), batch_size=8,
                                           shuffle=False))
    finally:
        t._world = None
    assert t.comms_per_step["gather_mode"] == "scan"
    builds = [r for r in torch_boring.REPORTS if r[0] == "builds"]
    assert sorted(r[1] for r in builds) == [0, 1, 2, 3]
    for _, _, counts in builds:
        assert len(counts) == 12
        assert counts[1:] == [counts[0]] * 11, counts


def _small_scan_trainer(root, max_steps):
    return Trainer(device="cpu", default_root_dir=str(root),
                   accelerator=RayTPUAccelerator(4, use_fsdp=True,
                                                 init_hook=two_threads),
                   max_steps=max_steps, max_epochs=4, precision="f32",
                   seed=0, enable_checkpointing=False, log_every_n_steps=1,
                   grad_compression="int8", gather_mode="scan")


def test_gpt_scan_live_continuation_keeps_the_scan_gather(world, tmp_path):
    """``fit(ckpt_path="live")`` after an engaged scan fit over the shared
    world: the shipped trainer carries the driver's unresolved mode, and
    the ranks restore the resolved mode and the scanned keys with the
    live state, so the continuation runs the per-layer gather over the
    scan layout's ``[1]`` placeholder residuals (one gather and one
    reduce-scatter a layer a step) and steps on from step 2 to step 4."""
    model = _gpt(n_layers=2)
    t = _small_scan_trainer(tmp_path, max_steps=2)
    t._world = world
    try:
        t.fit(model, _loader(n=32, bs=8))
        assert t.comms_per_step["gather_mode"] == "scan"
        t.max_steps = 4
        t.fit(model, _loader(n=32, bs=8), ckpt_path="live")
    finally:
        t._world = None
    assert t.global_step == 4
    assert t.comms_per_step["gather_mode"] == "scan"
    assert t.rank_report["state_shapes"]["residual/layers/attn/wq"] == [1]
    assert t.rank_report["layer_collectives"] == {"all_gather": 2 * 2,
                                                  "reduce_scatter": 2 * 2}
    losses = _history(t, "train_loss")
    assert len(losses) == 4 and np.all(np.isfinite(losses)), losses


def test_another_fit_frees_the_earlier_runs_live_state(world, tmp_path):
    """A rank keeps one run's live state: a second trainer's fit over
    the shared world frees the first's (which a fit of the first can
    then not continue: typed, naming the cause), and a fit of the same
    run replaces its own."""
    first = _small_scan_trainer(tmp_path / "a", max_steps=1)
    second = _small_scan_trainer(tmp_path / "b", max_steps=1)
    first._world = second._world = world
    try:
        first.fit(_gpt(n_layers=2), _loader(n=32, bs=8))
        assert world.run(torch_boring.live_run_keys) == \
            [[first._run_key]] * 4
        second.fit(_gpt(n_layers=2), _loader(n=32, bs=8))
        assert world.run(torch_boring.live_run_keys) == \
            [[second._run_key]] * 4
        second.fit(_gpt(n_layers=2), _loader(n=32, bs=8))
        assert world.run(torch_boring.live_run_keys) == \
            [[second._run_key]] * 4
        first.max_steps = 2
        with pytest.raises(Exception, match="holds no live state"):
            first.fit(_gpt(n_layers=2), _loader(n=32, bs=8),
                      ckpt_path="live")
    finally:
        first._world = second._world = None


def test_sanitized_scan_fit_records_the_layer_collectives(tmp_path,
                                                         monkeypatch):
    """A 2-step scan fit of a 2-layer GPT over 2 ranks with the SPMD
    sanitizer on (the workers inherit the driver's environment): the
    ranks' sequences agree, and each rank recorded one all-gather of a
    layer's bf16 slices (16384 elements: ``wq`` / ``wk`` / ``wv`` / ``wo``
    2048 each, ``wi`` / ``wo`` 4096 each) and one reduce-scatter of its
    bf16 gradient (the whole layer, 32768) a layer a step, both over
    the fsdp group's axes."""
    from ray_lightning_accelerators_tpu_torch.testing import (
        spmd_sanitizer as S)
    tdir = tmp_path / "telemetry"
    monkeypatch.setattr(bootstrap, "DEFAULT_TIMEOUT_S", 60.0)
    monkeypatch.setenv(S.SANITIZER_ENV, "1")
    monkeypatch.setenv("RLA_TPU_TELEMETRY_DIR", str(tdir))
    t = Trainer(device="cpu", default_root_dir=str(tmp_path),
                accelerator=RayTPUAccelerator(2, use_fsdp=True,
                                              init_hook=two_threads),
                grad_compression="int8", gather_mode="scan", max_steps=2,
                precision="f32", enable_checkpointing=False)
    try:
        t.fit(_gpt(n_layers=2), _loader(n=16, bs=8))
    finally:
        t.shutdown_workers()
    assert t.comms_per_step["gather_mode"] == "scan"
    assert S.check_collective_sequences(str(tdir)) is None
    snaps = S.gather_sequences(str(tdir))
    assert set(snaps) == {"rank0", "rank1"}
    for snap in snaps.values():
        events = snap["events"]
        # torch's newer names where it has them (the port's ``_new_api``)
        gathers = [e for e in events if e["op"] in (
            "all_gather_single", "all_gather_into_tensor")
            and e["shape"] == [16384]]
        scatters = [e for e in events if e["op"] in (
            "reduce_scatter_single", "reduce_scatter_tensor")]
        assert len(gathers) == len(scatters) == 2 * 2
        for e in gathers + scatters:
            assert e["axes"] == ["fsdp"] and "bfloat16" in e["dtype"]
        assert all(e["shape"] == [32768] for e in scatters)


# --------------------------------------------------------------------- #
# (d) validation, the wire report, the layout on data x fsdp (F2)        #
# --------------------------------------------------------------------- #
def test_validate_scan_gather_refusals_match_jax():
    """tests/test_overlap_gather.py:185: a good layout passes; a missing
    scanned key, a scanned leaf split on its layer dim and a tree that
    is not a dict raise ``TensorShardedParamsError`` with JAX's text."""
    mesh = jax_mesh.build_mesh(jax_mesh.MeshConfig(data=1, fsdp=8))
    jgood = {"layers": {"w": NamedSharding(mesh, P(None, "fsdp"))},
             "embed": NamedSharding(mesh, P("fsdp", None))}
    good = {"layers": {"w": (("fsdp", 1),)}, "embed": (("fsdp", 0),)}
    JC.validate_scan_gather(jgood, ("layers",))
    C.validate_scan_gather(good, ("layers",))
    cases = [
        (jgood, good, ("missing",)),
        ({"layers": {"w": NamedSharding(mesh, P("fsdp", None))}},
         {"layers": {"w": (("fsdp", 0),)}}, ("layers",)),
        ([jgood], [good], ("layers",)),
    ]
    for jl, pl, scanned in cases:
        with pytest.raises(JC.TensorShardedParamsError) as want:
            JC.validate_scan_gather(jl, scanned)
        with pytest.raises(C.TensorShardedParamsError) as got:
            C.validate_scan_gather(pl, scanned)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("mode", ["tree", "scan"])
@pytest.mark.parametrize("mesh", ["data1_fsdp8", "data2_fsdp4"])
def test_wire_report_matches_jax(mesh, mode):
    """tests/test_overlap_gather.py:238's params on both of its meshes,
    in both modes: the port's report (``nf`` from the plan's mesh) equals
    JAX's key for key; ``exposed + hidden == exchange``; an unknown mode
    raises JAX's ``ValueError``."""
    data, fsdp = (1, 8) if mesh == "data1_fsdp8" else (2, 4)
    jmesh = jax_mesh.build_mesh(jax_mesh.MeshConfig(data=data, fsdp=fsdp))
    pmesh = mesh_lib.build_mesh(mesh_lib.MeshConfig(data=data, fsdp=fsdp), 8)
    params = {"layers": {"w": np.zeros((4, 1024, 64), np.float32)},
              "embed": np.zeros((1024, 64), np.float32)}
    jsh = {"layers": {"w": NamedSharding(jmesh, P(None, "fsdp", None))},
           "embed": NamedSharding(jmesh, P("fsdp", None))}
    psh = {"layers": {"w": (("fsdp", 1),)}, "embed": (("fsdp", 0),)}
    for cmode in ("int8", "bf16"):
        jcfg, pcfg = (JC.ExchangeConfig(mode=cmode),
                      C.ExchangeConfig(mode=cmode))
        want = JC.wire_bytes_per_step(params, 8, jcfg, param_shardings=jsh,
                                      gather_mode=mode, scanned=("layers",))
        got = C.wire_bytes_per_step(params, 8, pcfg, param_shardings=psh,
                                    gather_mode=mode, scanned=("layers",),
                                    mesh=pmesh)
        assert got == want
        assert (got["exposed_bytes_per_step"] + got["hidden_bytes_per_step"]
                == got["exchange_bytes_per_step"])
    with pytest.raises(ValueError) as want:
        JC.wire_bytes_per_step(params, 8, jcfg, gather_mode="sideways")
    with pytest.raises(ValueError) as got:
        C.wire_bytes_per_step(params, 8, pcfg, gather_mode="sideways")
    assert str(got.value) == str(want.value)


def test_fsdp_on_data_x_fsdp_splits_over_fsdp_only(world, tmp_path):
    """F2: on a ``data=2 x fsdp=2`` mesh the JAX Trainer splits an fsdp
    leaf over the fsdp axis alone (the data replicas hold the same
    slice) and prices the data axis's f32 all-reduce in its wire report;
    the port split it over all 4 batch ranks and reported ``fsdp`` 4.
    The scanned module under the tree gather with int8 compression: the
    wire report equals JAX's, each rank holds a half of ``layers.w``
    (``[3, 32, 64]``) with its residual the owned chunk, and the
    trajectory follows the JAX Trainer's within the limits of
    ``test_scanned_module_fit_matches_jax_trainer`` (the loss and grad
    norm 2e-3 at every step; params 1e-3 relative L2 per leaf without a
    flip, the first step whose norm differs by more than 1e-4, here at
    an int8 rounding, 1e-2 after one).  Measured: loss 4.2e-4, norm
    6.1e-4 (its first flip at step 6), params 4.6e-4."""
    x, y = scanned_data(128)
    rows = _replica_rows(128, 32, n=4)
    kw = dict(grad_compression="int8", **COMMON)
    jm = JaxScannedMLP()
    jt = JaxTrainer(accelerator=_jax_acc("data2_fsdp2"), guard=None,
                    prefetch_batches=0, cache_dataset_on_device=False,
                    default_root_dir=str(tmp_path / "jax"), **kw)
    jt.fit(jm, JaxDataLoader(JaxArrayDataset(x[rows], y[rows]),
                             batch_size=32, shuffle=False, use_native=False))
    tm = ScannedMLP()
    tt = _fit(world, tmp_path / "port", tm,
              DataLoader(ArrayDataset(x, y), batch_size=32, shuffle=False),
              _port_acc("data2_fsdp2"), **kw)
    assert tt.comms_per_step == jt.comms_per_step
    assert tt.comms_per_step["fsdp"] == 2
    shapes = tt.rank_report["state_shapes"]
    assert shapes["params/layers/w"] == [3, 32, 64]
    chunk = 3 * 64 * 64 // 2
    assert shapes["residual/layers/w"] == [chunk]
    jl, tl = _history(jt, "train_loss"), _history(tt, "train_loss")
    jn, tn = _history(jt, "grad_norm"), _history(tt, "grad_norm")
    assert len(tl) == len(jl) == 8
    gap_l = [abs(a - b) / abs(b) for a, b in zip(tl, jl)]
    gap_n = [abs(a - b) / abs(b) for a, b in zip(tn, jn)]
    assert max(gap_l) <= 2e-3 and max(gap_n) <= 2e-3, (gap_l, gap_n)
    flip = next((i for i, g in enumerate(gap_n) if g > 1e-4), None)
    jp, tp = _flat(jax.device_get(jm.params)), _flat(tm.params)
    for name in jp:
        assert _rel_l2(tp[name], jp[name]) <= (1e-3 if flip is None
                                               else 1e-2), name
