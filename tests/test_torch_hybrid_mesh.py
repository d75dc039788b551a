"""Multi-slice meshes of the PyTorch port (``parallel/mesh.py``
``hybrid_rank_array`` / ``build_hybrid_mesh``, ``dcn_data`` /
``dcn_pipeline`` on the accelerators), held against the JAX package's
``hybrid_device_array`` / ``build_hybrid_mesh`` and its ``Trainer``.

A JAX granule is a slice (or a process); a port granule is a host
agent's ranks.  Tolerances:

- the rank array equal to ``[d.id for d in hybrid_device_array(...).flat]``
  over the same fake granules, and a ``ValueError`` wherever JAX raises
  one;
- fits over two loopback agents against the JAX ``Trainer`` on the flat
  mesh of the same sizes: losses within 1e-5 relative, params within
  1e-5 (absolute for the boring model, relative L2 a leaf for the GPT).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_accelerators_tpu import RayTPUAccelerator as JaxRayTPU
from ray_lightning_accelerators_tpu import Trainer as JaxTrainer
from ray_lightning_accelerators_tpu.data.loader import (
    ArrayDataset as JaxArrayDataset, DataLoader as JaxDataLoader)
from ray_lightning_accelerators_tpu.models.transformer import (
    GPT as JaxGPT, TransformerConfig as JaxConfig)
from ray_lightning_accelerators_tpu.parallel import mesh as jax_mesh
from ray_lightning_accelerators_tpu_torch import (DataLoader,
                                                  RayTPUAccelerator, Trainer)
from ray_lightning_accelerators_tpu_torch.data.loader import ArrayDataset
from ray_lightning_accelerators_tpu_torch.models.transformer import (
    GPT, TransformerConfig)
from ray_lightning_accelerators_tpu_torch.parallel import mesh as mesh_lib
from ray_lightning_accelerators_tpu_torch.runtime import agent, bootstrap
from ray_lightning_accelerators_tpu_torch.utils.weights import (
    params_from_jax)

from .test_hybrid_mesh import _fake_slices
from .torch_boring import BoringModel
from .utils import BoringModel as JaxBoring

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def bounded_worlds(monkeypatch):
    monkeypatch.setattr(bootstrap, "DEFAULT_TIMEOUT_S", 60.0)


@pytest.fixture(scope="module")
def agents():
    hosts = [agent.HostAgent(port=0) for _ in range(2)]
    for h in hosts:
        h.serve_in_background()
    try:
        yield hosts, [f"127.0.0.1:{h.port}" for h in hosts]
    finally:
        for h in hosts:
            h.shutdown()


# --------------------------------------------------------------------- #
# The rank array against hybrid_device_array                             #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("n_slices,per_slice,ici,dcn", [
    (2, 4, (4, 1, 1, 1, 1, 1), (2, 1, 1, 1, 1, 1)),   # data over DCN
    (2, 4, (2, 1, 1, 1, 1, 2), (1, 1, 2, 1, 1, 1)),   # pipeline over DCN
    (2, 4, (2, 1, 1, 1, 1, 2), (2, 1, 1, 1, 1, 1)),   # data x tensor ICI
    (2, 2, (1, 1, 1, 1, 1, 2), (2, 1, 1, 1, 1, 1)),   # tensor ICI
    (2, 4, (1, 2, 1, 1, 1, 2), (1, 1, 2, 1, 1, 1)),   # fsdp x tensor ICI
    (4, 2, (1, 1, 1, 1, 1, 2), (2, 1, 2, 1, 1, 1)),   # both DCN axes
    (4, 1, (1, 1, 1, 1, 1, 1), (2, 1, 2, 1, 1, 1)),
])
def test_rank_array_matches_hybrid_device_array(n_slices, per_slice, ici,
                                                dcn):
    devs = _fake_slices(n_slices, per_slice)
    want = [d.id for d in jax_mesh.hybrid_device_array(ici, dcn, devs).flat]
    granules = [d.slice_index for d in devs]
    assert mesh_lib.hybrid_rank_array(ici, dcn, granules) == want
    # granule keys are sorted, not taken in rank order
    relabeled = [10 - g for g in granules]
    rev = [d.id for d in jax_mesh.hybrid_device_array(
        ici, dcn, [_Relabeled(d) for d in devs]).flat]
    assert mesh_lib.hybrid_rank_array(ici, dcn, relabeled) == rev


class _Relabeled:
    """A fake device whose slice index counts down."""

    def __init__(self, d):
        self.id, self.slice_index = d.id, 10 - d.slice_index
        self.process_index = self.slice_index
        self.platform, self.device_kind, self.coords = "cpu", "fake-cpu", None


@pytest.mark.parametrize("n_slices,per_slice,ici,dcn", [
    (3, 2, (2, 1, 1, 1, 1, 1), (2, 1, 1, 1, 1, 1)),   # 3 granules for 2
    (1, 4, (2, 1, 1, 1, 1, 1), (2, 1, 1, 1, 1, 1)),   # one granule
    (2, 4, (2, 1, 1, 1, 1, 1), (2, 1, 1, 1, 1, 1)),   # granule too large
])
def test_granule_mismatch_raises_as_jax(n_slices, per_slice, ici, dcn):
    devs = _fake_slices(n_slices, per_slice)
    with pytest.raises(ValueError):
        jax_mesh.hybrid_device_array(ici, dcn, devs)
    with pytest.raises(ValueError):
        mesh_lib.hybrid_rank_array(ici, dcn,
                                   [d.slice_index for d in devs])


def test_build_hybrid_mesh_sizes_and_refusals():
    """Each axis is ICI x DCN (the JAX mesh's shape over 8 devices in
    2 granules); one DCN group is the plain mesh; an indivisible count
    raises as JAX's does."""
    jm = jax_mesh.build_hybrid_mesh(jax_mesh.MeshConfig(data=-1, tensor=2),
                                    dcn_data=2,
                                    devices=_fake_slices(2, 4))
    m = mesh_lib.build_hybrid_mesh(mesh_lib.MeshConfig(data=-1, tensor=2),
                                   8, [0] * 4 + [1] * 4, dcn_data=2)
    assert m.shape == dict(jm.shape)
    assert list(m.order) == [d.id for d in jm.devices.flat]
    assert mesh_lib.data_parallel_size(m) == 4
    plain = mesh_lib.build_hybrid_mesh(mesh_lib.MeshConfig(data=-1), 4,
                                       [0] * 4)
    assert plain.order is None and plain.shape["data"] == 4
    with pytest.raises(ValueError, match="divisible"):
        jax_mesh.build_hybrid_mesh(jax_mesh.MeshConfig(data=-1),
                                   dcn_data=3)
    with pytest.raises(ValueError, match="divisible"):
        mesh_lib.build_hybrid_mesh(mesh_lib.MeshConfig(data=-1), 8,
                                   [0] * 8, dcn_data=3)


def test_rank_coords_and_groups_follow_the_order():
    """With pipeline over DCN and data inside a granule, the rank at each
    position is the hybrid array's: coordinates and axis groups follow
    it, not the plain rank order."""
    m = mesh_lib.build_hybrid_mesh(
        mesh_lib.MeshConfig(data=2), 4, [0, 0, 1, 1], dcn_pipeline=2)
    assert m.shape["data"] == 2 and m.shape["pipeline"] == 2
    assert list(m.order) == [0, 2, 1, 3]
    assert m.coords_of(1)["data"] == 1 and m.coords_of(1)["pipeline"] == 0
    assert m.coords_of(2)["data"] == 0 and m.coords_of(2)["pipeline"] == 1
    assert mesh_lib.axis_groups(m.shape, ("pipeline",), m.order) == [
        [0, 2], [1, 3]]
    assert mesh_lib.axis_groups(m.shape, ("data",), m.order) == [
        [0, 1], [2, 3]]


def test_accelerator_granules_follow_the_agents():
    acc = RayTPUAccelerator(1, tensor=2, dcn_data=2,
                            agents=["127.0.0.1:1", "127.0.0.1:2"])
    acc.bind_device(torch.device("cpu"))
    assert acc.world_size == 4 and acc.granules() == [0, 0, 1, 1]
    mesh = acc.build_mesh()
    assert mesh.shape["data"] == 2 and mesh.shape["tensor"] == 2
    assert acc.distributed_sampler_kwargs() == {"num_replicas": 1,
                                                "rank": 0}
    assert "dcn_data" in repr(acc)
    # one agent for two DCN groups: one granule
    one = RayTPUAccelerator(1, dcn_data=2, agents=["127.0.0.1:1"])
    one.bind_device(torch.device("cpu"))
    with pytest.raises(ValueError, match="slices 1"):
        one.build_mesh()


# --------------------------------------------------------------------- #
# Fits over two loopback agents against the JAX Trainer                  #
# --------------------------------------------------------------------- #
COMMON = dict(precision="f32", seed=0, guard=None, prefetch_batches=0,
              cache_dataset_on_device=False, enable_checkpointing=False,
              log_every_n_steps=1)


def _history(trainer, key):
    return [r[key] for r in trainer.logger.history if key in r]


def test_dcn_data_fit_over_two_agents_matches_jax(agents, tmp_path):
    """One rank on each agent, the data axis over DCN, against the JAX
    Trainer at data=2: two epochs of 8 shuffled global batches of 8,
    SGD 0.1; the losses within 1e-5 relative, the params within 1e-5."""
    hosts, addrs = agents
    init = jax.tree.map(np.asarray, jax.device_get(
        JaxBoring().init_params(jax.random.PRNGKey(0))))
    data = np.random.default_rng(0).normal(size=(64, 32)).astype(np.float32)
    jm = JaxBoring()
    jm.params = jax.tree.map(jnp.asarray, init)
    jt = JaxTrainer(accelerator=JaxRayTPU(2), max_epochs=2,
                    default_root_dir=str(tmp_path / "jax"), **COMMON)
    jt.fit(jm, JaxDataLoader(JaxArrayDataset(data), batch_size=8,
                             shuffle=True, use_native=False))
    before = [h.spawn_count for h in hosts]
    tm = BoringModel()
    tm.params = {"layer": {k: torch.from_numpy(np.array(v))
                           for k, v in init["layer"].items()}}
    acc = RayTPUAccelerator(1, agents=addrs, dcn_data=2)
    tt = Trainer(device="cpu", accelerator=acc, max_epochs=2,
                 default_root_dir=str(tmp_path / "port"), **COMMON)
    try:
        tt.fit(tm, DataLoader(ArrayDataset(data), batch_size=8,
                              shuffle=True))
        assert tt._world.placement == addrs
    finally:
        tt.shutdown_workers()
    assert [h.spawn_count - b for h, b in zip(hosts, before)] == [1, 1]
    assert tt.global_step == 16
    assert tt.rank_report["world_size"] == 2
    assert tt.rank_report["mesh_groups"]["batch"][0] == [0, 1]
    jl, tl = _history(jt, "train_loss"), _history(tt, "train_loss")
    assert len(tl) == len(jl) == 16
    for a, b in zip(tl, jl):
        assert a == pytest.approx(float(b), rel=1e-5)
    for k in ("kernel", "bias"):
        np.testing.assert_allclose(tm.params["layer"][k].numpy(),
                                   np.asarray(jm.params["layer"][k]),
                                   rtol=0, atol=1e-5)


VOCAB, SEQ = 256, 32
GPT_CFG = dict(vocab_size=VOCAB, d_model=64, n_heads=4, d_ff=128,
               n_layers=2, max_seq_len=SEQ, loss_chunk_rows=64,
               pipeline_microbatches=2)


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


def _gpt_pair(tmp_path, jax_acc, port_acc, steps_data):
    """The tiny GPT fitted for one epoch of global batches of 4 by the
    JAX Trainer (``jax_acc``) and the port's (``port_acc``) from the
    same weights; returns both trainers and modules."""
    init = jax.device_get(JaxGPT(JaxConfig(**GPT_CFG)).init_params(
        jax.random.PRNGKey(0)))
    jm = JaxGPT(JaxConfig(**GPT_CFG), lr=3e-3)
    jm.params = jax.tree.map(jnp.asarray, init)
    common = dict(COMMON, max_epochs=1, gradient_clip_val=0.5)
    jt = JaxTrainer(accelerator=jax_acc, default_root_dir=str(
        tmp_path / "jax"), **common)
    jt.fit(jm, JaxDataLoader(JaxArrayDataset(steps_data), batch_size=4,
                             shuffle=True, use_native=False))
    tm = GPT(TransformerConfig(**GPT_CFG), device="cpu", lr=3e-3)
    tm.params = params_from_jax(init, device="cpu")
    tt = Trainer(device="cpu", accelerator=port_acc,
                 default_root_dir=str(tmp_path / "port"), **common)
    try:
        tt.fit(tm, DataLoader(ArrayDataset(steps_data), batch_size=4,
                              shuffle=True))
    finally:
        tt.shutdown_workers()
    return jt, jm, tt, tm


def _assert_gpt_parity(jt, jm, tt, tm, steps):
    jl, tl = _history(jt, "train_loss"), _history(tt, "train_loss")
    assert len(tl) == len(jl) == steps
    for a, b in zip(tl, jl):
        assert a == pytest.approx(float(b), rel=1e-5)
    jp, tp = _flat(jax.device_get(jm.params)), _flat(tm.params)
    assert jp.keys() == tp.keys()
    for name in jp:
        assert tp[name].shape == jp[name].shape, name
        assert _rel_l2(tp[name], jp[name]) <= 1e-5, name


@pytest.mark.parametrize("dp", [1, 2], ids=["pp_dcn2", "dp2_pp_dcn2"])
def test_dcn_pipeline_fit_over_two_agents_matches_jax(agents, tmp_path, dp):
    """The pipeline axis over DCN, one stage an agent (``dp`` ranks on
    each), against the JAX Trainer at ``data=dp, pipeline=2``: 4 steps,
    clipping at 0.5.  At ``dp=2`` the hybrid order is not the plain one
    (ranks 0, 1 are stage 0): each rank's stage and its pipeline group
    cross the agents."""
    _hosts, addrs = agents
    acc = RayTPUAccelerator(dp, agents=addrs, dcn_pipeline=2)
    jt, jm, tt, tm = _gpt_pair(tmp_path, JaxRayTPU(dp, pipeline=2), acc,
                               _tokens(16, seed=5))
    _assert_gpt_parity(jt, jm, tt, tm, 4)
    groups = tt.rank_report["mesh_groups"]
    assert groups["pipeline"][0] == [0, dp]       # across the agents
    placement = acc.placement()
    assert placement[0] != placement[dp]
    assert tt.rank_report["replicated_bitwise_equal"] is True


def test_tensor_groups_stay_on_one_agent(agents, tmp_path):
    """4 ranks on 2 agents at ICI ``tensor=2`` and ``dcn_data=2``: every
    tensor group is one agent's ranks and every data group crosses the
    agents; the fit matches the JAX Trainer at ``data=2, tensor=2``."""
    _hosts, addrs = agents
    acc = RayTPUAccelerator(1, tensor=2, agents=addrs, dcn_data=2)
    jt, jm, tt, tm = _gpt_pair(tmp_path, JaxRayTPU(2, tensor=2), acc,
                               _tokens(16, seed=6))
    _assert_gpt_parity(jt, jm, tt, tm, 4)
    placement = acc.placement()
    mesh = acc.build_mesh()
    assert placement == [addrs[0]] * 2 + [addrs[1]] * 2
    for g in mesh_lib.axis_groups(mesh.shape, ("tensor",), mesh.order):
        assert len({placement[r] for r in g}) == 1, g
    for g in mesh_lib.axis_groups(mesh.shape, ("data",), mesh.order):
        assert len({placement[r] for r in g}) == 2, g
    assert tt.rank_report["mesh_groups"]["tensor"][0] == [0, 1]
