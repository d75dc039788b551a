"""Data parallelism over spawned ranks in the PyTorch port, on the CPU
over gloo: the port of tests/test_accelerators.py (the reference's DDP
suite), then parity with the JAX package, whose ``RayTPUAccelerator(N)``
is SPMD over an N-device mesh in one process (tests/conftest.py gives it
8 CPU devices).  The loader's ``batch_size`` is the global batch in both:
each of N ranks trains on ``batch_size / N`` of its rows and the
gradients are averaged, so a port step sees the rows of the JAX step.

The models, callbacks and queue callables the ranks unpickle live in
tests/torch_boring.py, which imports no JAX.  Every world here is bounded:
its rendezvous and collectives fail after ``bootstrap.DEFAULT_TIMEOUT_S``
(set to 60 s below), and a dead rank fails the run at once."""

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
from ray_lightning_accelerators_tpu.utils import schedules as jax_sched
from ray_lightning_accelerators_tpu_torch import (
    DataLoader, EarlyStopping, HorovodRayAccelerator, RayAccelerator,
    RayTPUAccelerator, Trainer)
from ray_lightning_accelerators_tpu_torch.data.loader import (
    ArrayDataset, RandomDataset)
from ray_lightning_accelerators_tpu_torch.models.transformer import (
    GPT, TransformerConfig)
from ray_lightning_accelerators_tpu_torch.parallel import mesh as mesh_lib
from ray_lightning_accelerators_tpu_torch.runtime import bootstrap
from ray_lightning_accelerators_tpu_torch.utils import schedules
from ray_lightning_accelerators_tpu_torch.utils.weights import (
    params_from_jax)

from . import torch_boring
from .torch_boring import (BlobsDataModule, BoringModel, CountingStream,
                           LinearClassifier, SamplerProbe, boring_loaders,
                           get_trainer, load_test, predict_test, train_test)

torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(autouse=True)
def bounded_worlds(monkeypatch):
    monkeypatch.setattr(bootstrap, "DEFAULT_TIMEOUT_S", 60.0)


def _alive(trainer):
    world = trainer._world
    return [] if world is None else [w for w in world.pool.workers
                                     if w.is_alive]


# --------------------------------------------------------------------- #
# The reference's DDP suite (tests/test_accelerators.py)                 #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("num_workers", [1, 2])
def test_mesh_device_count(num_workers, monkeypatch):
    """The accelerator engages exactly num_workers ranks: on the CPU all
    on the CPU, on the card rank i on cuda:i."""
    acc = RayTPUAccelerator(num_workers=num_workers)
    Trainer(device="cpu", accelerator=acc)
    assert acc.select_devices() == [torch.device("cpu")] * num_workers
    assert acc.world_size == num_workers
    assert acc.launch_spec()["num_processes"] == num_workers
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    acc.device_type = "cuda"
    assert acc.select_devices() == [torch.device("cuda", i)
                                    for i in range(num_workers)]


def test_horovod_topology(caplog):
    acc = HorovodRayAccelerator(num_hosts=2, num_slots=4)
    Trainer(device="cpu", accelerator=acc)
    assert acc.world_size == 8
    with caplog.at_level("WARNING"):
        assert acc.launch_spec()["num_processes"] == 8
    assert "no host agents" in caplog.text


def test_too_many_workers_raises(monkeypatch):
    """More ranks than visible cards raise, as select_devices does in the
    JAX package; the CPU has no device limit."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="only 1 are visible"):
        Trainer(accelerator=RayTPUAccelerator(num_workers=64))
    Trainer(device="cpu", accelerator=RayTPUAccelerator(num_workers=64))


@pytest.mark.parametrize("num_workers", [1, 2])
def test_train(tmp_path, num_workers):
    trainer = get_trainer(tmp_path, RayTPUAccelerator(num_workers))
    train_test(trainer, BoringModel())
    report = trainer.rank_report
    assert report["world_size"] == num_workers
    assert report["backend"] == "gloo" and report["device"] == "cpu"
    assert report["all_reduces"] == trainer.global_step == 8
    trainer.shutdown_workers()


def test_train_parity_alias(tmp_path):
    """RayAccelerator keeps its reference signature; its init_hook runs
    on every rank; use_gpu=True contradicts a CPU trainer."""
    torch_boring.REPORTS.clear()
    acc = RayAccelerator(num_workers=2, num_cpus_per_worker=1, use_gpu=False,
                         init_hook=torch_boring.report_hook)
    trainer = get_trainer(tmp_path, acc)
    train_test(trainer, BoringModel())
    trainer.shutdown_workers()
    assert sorted(torch_boring.REPORTS) == [("init_hook", 0),
                                            ("init_hook", 1)]
    with pytest.raises(ValueError, match="use_gpu"):
        Trainer(device="cpu", accelerator=RayAccelerator(2, use_gpu=True))


def test_train_horovod_shape(tmp_path):
    trainer = get_trainer(tmp_path, HorovodRayAccelerator(num_hosts=2,
                                                          num_slots=2))
    train_test(trainer, BoringModel())
    assert trainer.rank_report["world_size"] == 4
    trainer.shutdown_workers()


@pytest.mark.parametrize("num_workers", [1, 2])
def test_load(tmp_path, num_workers):
    """The best checkpoint round trip, and every rank resuming a fit from
    it: one more epoch runs after the restored one."""
    trainer = get_trainer(tmp_path, RayTPUAccelerator(num_workers))
    load_test(trainer, BoringModel())
    trainer.shutdown_workers()
    resumed = get_trainer(tmp_path / "resumed",
                          RayTPUAccelerator(num_workers), max_epochs=2)
    resumed.fit(BoringModel(), *boring_loaders(),
                ckpt_path=trainer.checkpoint_callback.best_model_path)
    assert resumed.global_step == 16 and resumed.epochs_completed == 2
    assert resumed.rank_report["all_reduces"] == 8
    resumed.shutdown_workers()


@pytest.mark.parametrize("num_workers", [1, 2])
def test_predict(tmp_path, num_workers):
    """Accuracy >= 0.5 on held-out blobs after fitting through the
    ranks (2 epochs of 24 steps; the JAX test fits 10, which on a loaded
    CPU costs a minute of gloo round trips here)."""
    dm = BlobsDataModule(batch_size=16)
    trainer = get_trainer(tmp_path, RayTPUAccelerator(num_workers),
                          max_epochs=2, limit_train_batches=None,
                          limit_val_batches=None)
    predict_test(trainer, LinearClassifier(), dm)
    trainer.shutdown_workers()


def test_early_stop(tmp_path):
    """A constant val_loss stops after patience validations on every rank
    (their metrics are the global batch's, so they decide alike)."""
    patience = 2
    stopper = EarlyStopping(monitor="val_loss", patience=patience)
    trainer = get_trainer(tmp_path, RayTPUAccelerator(2), max_epochs=500,
                          callbacks=[stopper])
    trainer.fit(BoringModel(), *boring_loaders())
    # one improvement round + `patience` non-improving rounds
    assert trainer.current_epoch == trainer.epochs_completed == \
        patience + 1
    assert stopper.wait_count == patience
    trainer.shutdown_workers()


def test_sampler_injection(tmp_path):
    """Each rank's samplers (read inside the ranks and sent home through
    put_queue): shuffle on for train and off for val, replicas = the world
    size, rank = the rank; each rank takes batch_size / N rows."""
    torch_boring.REPORTS.clear()
    trainer = get_trainer(tmp_path, RayTPUAccelerator(2),
                          callbacks=[SamplerProbe()])
    trainer.fit(BoringModel(), *boring_loaders(batch_size=8))
    trainer.shutdown_workers()
    reports = sorted(torch_boring.REPORTS, key=lambda r: r["rank"])
    assert [r["rank"] for r in reports] == [0, 1]
    for r in reports:
        assert r["train"] == {"shuffle": True, "num_replicas": 2,
                              "rank": r["rank"]}
        assert r["val"] == {"shuffle": False, "num_replicas": 2,
                            "rank": r["rank"]}
        assert r["rows"] == 4


def test_batch_divisibility_check(tmp_path):
    """A global batch the ranks cannot split is refused before anything
    is spawned."""
    trainer = get_trainer(tmp_path, RayTPUAccelerator(8))
    train, val = boring_loaders(batch_size=6)  # 6 % 8 != 0
    with pytest.raises(ValueError, match="not divisible"):
        trainer.fit(BoringModel(), train, val)
    assert trainer._world is None


def test_fit_twice_and_test(tmp_path):
    """fit then test reuse one world (same worker processes); a second
    trainer fits again; no worker outlives shutdown_workers()."""
    model = BoringModel()
    trainer = get_trainer(tmp_path, RayTPUAccelerator(2))
    train, val = boring_loaders()
    trainer.fit(model, train, val)
    first = dict(trainer.callback_metrics)
    pids = [w.pid for w in _alive(trainer)]
    results = trainer.test(model, val)
    assert "y" in results[0]
    # a plain iterable of global batches: each rank cuts its rows out
    (as_list,) = trainer.test(model, list(val))
    assert as_list["y"] == pytest.approx(results[0]["y"], rel=1e-6)
    assert [w.pid for w in _alive(trainer)] == pids and len(pids) == 2
    procs = [w._proc for w in trainer._world.pool.workers]
    trainer.shutdown_workers()
    assert not any(p.is_alive() for p in procs)
    trainer2 = get_trainer(tmp_path, RayTPUAccelerator(2), max_epochs=2)
    trainer2.fit(model, train, val)
    assert trainer2.current_epoch == 2
    assert first  # the first run's metrics came home
    trainer2.teardown()
    assert trainer2._world is None


def test_mesh_config_inference():
    cfg = mesh_lib.MeshConfig(data=-1, tensor=2)
    assert cfg.axis_sizes(8)[mesh_lib.DATA_AXIS] == 4
    with pytest.raises(ValueError):
        mesh_lib.MeshConfig(data=3, tensor=2).axis_sizes(8)


@pytest.mark.parametrize("acc,slice_name", [
    pytest.param(lambda: RayTPUAccelerator(2, pipeline=2, sequence=2),
                 "GPT raises on this mesh", id="<lambda>-4d"),
    pytest.param(lambda: RayTPUAccelerator(2, dcn_data=2), None,
                 id="<lambda>-4c-ii0"),
])
def test_later_slices_are_refused(acc, slice_name):
    """The pipeline axis with the sequence axis stays refused (the JAX
    package's GPT raises on that mesh).  A multi-slice mesh is accepted
    and, as the JAX package's ``test_accelerator_exposes_dcn_axes``,
    fails loudly with ``ValueError`` when the world is one granule (no
    host agents) for two DCN groups.  The model axes, the 2-D FSDP
    layouts (``use_fsdp`` with the tensor or expert axis) and the
    pipeline axis with the batch, tensor and expert axes are
    accepted."""
    if slice_name is None:
        a = acc()
        assert Trainer(device="cpu", accelerator=a).accelerator is a
        assert a.dcn_data == 2 and a.world_size == 4
        with pytest.raises(ValueError, match="slices 1"):
            a.build_mesh()
    else:
        with pytest.raises(NotImplementedError, match=slice_name):
            Trainer(device="cpu", accelerator=acc())
    for ok in (RayTPUAccelerator(2, tensor=2), RayTPUAccelerator(
            2, sequence=2), RayTPUAccelerator(2, expert=2, tensor=2),
               RayTPUAccelerator(2, sequence=2, use_fsdp=True),
               RayTPUAccelerator(2, tensor=2, use_fsdp=True),
               RayTPUAccelerator(2, expert=2, use_fsdp=True),
               RayTPUAccelerator(2, pipeline=2),
               RayTPUAccelerator(2, pipeline=2, use_fsdp=True),
               RayTPUAccelerator(1, pipeline=2, tensor=2),
               RayTPUAccelerator(1, pipeline=2, expert=2),
               RayTPUAccelerator(2, use_fsdp=True, pipeline=2, tensor=2)):
        assert Trainer(device="cpu", accelerator=ok).accelerator is ok


@pytest.mark.parametrize("devices,num_workers", [
    (["cpu:0", "cpu:1"], None), (["cpu:4", "cpu:5", "cpu:6"], 2)])
def test_devices_subset_places_the_ranks(devices, num_workers):
    """``devices=`` (a tune trial's lease) places rank i on entry i, as
    many ranks as the mesh takes of it (all of it when the batch axis is
    -1); the subset travels to the ranks with the accelerator, so a rank
    counts the same world.  Entries of another device type than the
    trainer's raise."""
    import pickle
    acc = RayTPUAccelerator(num_workers,
                            devices=[torch.device(d) for d in devices])
    Trainer(device="cpu", accelerator=acc)
    want = [torch.device(d) for d in devices[:2]]
    assert acc.select_devices() == want and acc.world_size == 2
    assert acc.launch_spec() == {"num_processes": 2,
                                 "devices": devices[:2]}
    shipped = pickle.loads(pickle.dumps(acc))
    assert shipped.select_devices() == want and shipped.world_size == 2
    with pytest.raises(ValueError, match="trainer runs on 'cpu'"):
        Trainer(device="cpu", accelerator=RayTPUAccelerator(
            devices=["cuda:0", "cuda:1"]))


def test_devices_subset_fit(tmp_path):
    """A fit over ``devices=[cpu:0, cpu:1]`` runs its 2 ranks on those
    entries (rank 0 on cpu:0) over gloo."""
    acc = RayTPUAccelerator(devices=[torch.device("cpu", 0),
                                     torch.device("cpu", 1)],
                            init_hook=torch_boring.two_threads)
    trainer = get_trainer(tmp_path, acc)
    train_test(trainer, BoringModel())
    report = trainer.rank_report
    assert report["world_size"] == 2 and report["device"] == "cpu:0"
    assert report["backend"] == "gloo"
    assert trainer._world.devices == ["cpu:0", "cpu:1"]
    trainer.shutdown_workers()


def _module_level_hook():
    pass


def test_init_hook_must_travel_by_pickle():
    def closure():
        pass
    import pickle
    pickle.dumps(RayTPUAccelerator(2, init_hook=_module_level_hook))
    with pytest.raises(TypeError, match="module-level function"):
        pickle.dumps(RayTPUAccelerator(2, init_hook=closure))


# --------------------------------------------------------------------- #
# Parity with the JAX Trainer on a 2-device mesh                         #
# --------------------------------------------------------------------- #
VOCAB, SEQ = 128, 64
# tests/test_torch_training.py's dense GPT: 2 layers, d 128
CFG = dict(vocab_size=VOCAB, d_model=128, n_heads=2, d_ff=256, n_layers=2,
           max_seq_len=SEQ, loss_chunk_rows=100)


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


def test_two_rank_fit_matches_jax_two_device_mesh(jax_init, tmp_path):
    """(a) 10 optimizer steps (2 epochs of 5 shuffled global batches of
    4, a warmup-cosine schedule, clipping at 0.5) from the same weights:
    the JAX Trainer on a 2-device mesh in one process, the port's over 2
    spawned gloo ranks of 2 rows each.  f32: the two sum in other orders
    (the port's mean of two half-batch means is exact in value, not in
    rounding), as in the one-device parity (test_torch_training.py).
    Limits: the loss within 2e-4 relative and the grad norm within 1e-3
    at every step; the final params in the driver's module (rank 0's)
    within 1e-3 relative L2 per leaf.
    (b) Predictions of 11 rows in global batches of 4 (the last ragged,
    so the ranks' sampler wrap-pads) from the same weights, put back in
    dataset order: equal to the JAX Trainer's within 1e-5."""
    data = _tokens(20, seed=5)
    sched_kw = dict(peak_lr=3e-3, total_steps=10, warmup_steps=3)
    common = dict(max_epochs=2, precision="f32", log_every_n_steps=1,
                  gradient_clip_val=0.5, log_grad_norm=True,
                  enable_checkpointing=False, seed=0)
    jm = JaxGPT(JaxConfig(**CFG), lr=jax_sched.warmup_cosine(**sched_kw))
    jm.params = jax.tree.map(jnp.asarray, jax_init)
    jt = JaxTrainer(accelerator=JaxRayTPU(2), guard=None,
                    prefetch_batches=0, cache_dataset_on_device=False,
                    default_root_dir=str(tmp_path / "jax"), **common)
    jt.fit(jm, JaxDataLoader(JaxArrayDataset(data), batch_size=4,
                             shuffle=True, use_native=False))

    tm = GPT(TransformerConfig(**CFG), device="cpu",
             lr=schedules.warmup_cosine(**sched_kw))
    tm.params = params_from_jax(jax_init, device="cpu")
    tt = Trainer(device="cpu", accelerator=RayTPUAccelerator(2),
                 default_root_dir=str(tmp_path / "port"), **common)
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
    assert tt.rank_report["all_reduces"] == 10
    jp, tp = _flat(jax.device_get(jm.params)), _flat(tm.params)
    assert jp.keys() == tp.keys()
    for name in jp:
        assert _rel_l2(tp[name], jp[name]) <= 1e-3, name

    # (b) predictions through the same world, from the initial weights
    # (fresh modules: the JAX trainer predicts a fitted module on its fit
    # state)
    val = _tokens(11, seed=9)
    jm = JaxGPT(JaxConfig(**CFG))
    jm.params = jax.tree.map(jnp.asarray, jax_init)
    tm = GPT(TransformerConfig(**CFG), device="cpu")
    tm.params = params_from_jax(jax_init, device="cpu")
    want = jt.predict(jm, JaxDataLoader(JaxArrayDataset(val), batch_size=4,
                                        drop_last=False, use_native=False))
    pids = [w.pid for w in _alive(tt)]
    got = tt.predict(tm, DataLoader(ArrayDataset(val), batch_size=4,
                                    drop_last=False))
    assert [w.pid for w in _alive(tt)] == pids
    assert [tuple(g.shape) for g in got] == \
        [tuple(np.shape(w)) for w in want] == \
        [(4, SEQ, VOCAB), (4, SEQ, VOCAB), (3, SEQ, VOCAB)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    tt.shutdown_workers()


def test_stream_ranks_yield_equal_batch_counts(tmp_path):
    """(c) A ragged stream of 23 rows in global batches of 4 over 2 ranks:
    each rank yields 5 batches of 2 (the tail block of 3 is dropped), the
    ranks' batches k together are the JAX loader's batch k, and a fit over
    the stream takes 5 steps an epoch on both ranks (no rank waits on a
    step the other never takes)."""
    from ray_lightning_accelerators_tpu.data.loader import (
        IterableDataset as JaxIterableDataset)

    class JaxStream(JaxIterableDataset):
        def __iter__(self):
            return iter(CountingStream(23))

    want = list(JaxDataLoader(JaxStream(), batch_size=4))
    per_rank = []
    for rank in range(2):
        loader = DataLoader(CountingStream(23), batch_size=4)
        loader._inject_sampler(2, rank, shuffle=False)
        per_rank.append(list(loader))
    assert [len(b) for b in per_rank] == [5, 5] and len(want) == 5
    for k, batch in enumerate(want):
        joined = np.stack([per_rank[0][k], per_rank[1][k]], 1).reshape(
            -1, 32)
        np.testing.assert_array_equal(joined, batch)

    # rows filled with their index drive the SGD step to an infinite
    # gradient at step 8: the guard trips there, as the JAX Trainer's on
    # the same stream (blame "data", epoch 1, batch 3); this test counts
    # steps, so it runs unguarded
    trainer = get_trainer(tmp_path, RayTPUAccelerator(2), max_epochs=2,
                          limit_train_batches=None, guard=None)
    trainer.fit(BoringModel(), DataLoader(CountingStream(23), batch_size=4),
                DataLoader(RandomDataset(32, 8), batch_size=4))
    assert trainer.global_step == 10
    assert trainer.rank_report["all_reduces"] == 10
    trainer.shutdown_workers()
