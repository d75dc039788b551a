"""The port's device dataset cache (``Trainer(cache_dataset_on_device=)``)
and its whole-epoch path, forced on the CPU with ``True`` ("auto" stays
off there): the JAX package's ``tests/test_device_cache.py`` cases on
the port, the cached fits bitwise the port's host-fed ones and within
1e-5 of the JAX Trainer's cached fit, and 2 gloo ranks cached against
host-fed."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_accelerators_tpu import RayTPUAccelerator as JaxRayTPU
from ray_lightning_accelerators_tpu import Trainer as JaxTrainer
from ray_lightning_accelerators_tpu.data.loader import (
    ArrayDataset as JaxArrayDataset, DataLoader as JaxDataLoader)
from ray_lightning_accelerators_tpu_torch import (Callback, DataLoader,
                                                  Trainer)
from ray_lightning_accelerators_tpu_torch.data.loader import ArrayDataset
from ray_lightning_accelerators_tpu_torch.runtime import bootstrap
from ray_lightning_accelerators_tpu_torch.runtime.bootstrap import (
    DistributedWorld)
from ray_lightning_accelerators_tpu_torch.runtime.guardian import (
    NumericAnomaly)
from ray_lightning_accelerators_tpu_torch.utils.logging import (
    InMemoryLogger)

from .torch_boring import BoringModel, boring_loaders, guard_trip_body
from .utils import BoringModel as JaxBoring


def _x(rows, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (rows, 32)).astype(np.float32)


def _trainer(cache, **kw):
    kw.setdefault("max_epochs", 1)
    return Trainer(device="cpu", precision="f32", enable_checkpointing=False,
                   seed=0, cache_dataset_on_device=cache, **kw)


def _fit(cache, max_epochs=2, drop_last=True, rows=70, params=None, **kw):
    train = DataLoader(ArrayDataset(_x(rows)), batch_size=8, shuffle=True,
                       drop_last=drop_last)
    model = BoringModel()
    model.params = params
    trainer = _trainer(cache, max_epochs=max_epochs,
                       log_every_n_steps=10 ** 9, **kw)
    trainer.fit(model, train)
    return trainer, model


@pytest.fixture(scope="module")
def init():
    return jax.device_get(JaxBoring().init_params(jax.random.PRNGKey(0)))


def _torch_params(init):
    return {k: {n: torch.tensor(np.asarray(v)) for n, v in leaf.items()}
            for k, leaf in init.items()}


def test_cached_matches_host_fed_and_jax(init):
    """Two shuffled epochs (the sampler reshuffles per epoch) with the
    trailing partial batch on the host path: the cached fit's parameters
    equal the host-fed fit's bit for bit and the JAX Trainer's cached
    fit's within 1e-5."""
    t_host, m_host = _fit(False, drop_last=False,
                          params=_torch_params(init))
    t_cached, m_cached = _fit(True, drop_last=False,
                              params=_torch_params(init))
    assert t_cached._device_cache is not None
    assert t_host._device_cache is None
    assert t_cached.global_step == t_host.global_step == 18
    for name in ("kernel", "bias"):
        assert torch.equal(m_cached.params["layer"][name],
                           m_host.params["layer"][name])
    jm = JaxBoring()
    jm.params = jax.tree.map(jnp.asarray, init)
    # one device: the 6-row trailing batch cannot split over 8
    jt = JaxTrainer(max_epochs=2, precision="f32", enable_checkpointing=False,
                    seed=0, cache_dataset_on_device=True,
                    log_every_n_steps=10 ** 9,
                    accelerator=JaxRayTPU(num_workers=1))
    jt.fit(jm, JaxDataLoader(JaxArrayDataset(_x(70)), batch_size=8,
                             shuffle=True, drop_last=False))
    assert jt.global_step == 18
    for name in ("kernel", "bias"):
        np.testing.assert_allclose(
            m_cached.params["layer"][name].numpy(),
            np.asarray(jm.params["layer"][name]), rtol=1e-5, atol=1e-6)


def test_partial_trailing_batch_uses_host_path():
    # 72 rows, batch 16: 4 cached steps + 1 host-fed partial of 8
    train = DataLoader(ArrayDataset(_x(72)), batch_size=16,
                       drop_last=False)
    trainer = _trainer(True)
    trainer.fit(BoringModel(), train)
    assert trainer.global_step == 5


def test_auto_respects_size_threshold_and_the_cpu(monkeypatch):
    t_auto, _ = _fit("auto")
    assert t_auto._device_cache is None  # the CPU: "auto" stays off
    monkeypatch.setattr(Trainer, "_CACHE_AUTO_ON_CPU", True)
    monkeypatch.setattr(Trainer, "_CACHE_MAX_BYTES", 64)
    t_auto, _ = _fit("auto")
    assert t_auto._device_cache is None  # over the cap
    monkeypatch.setattr(Trainer, "_CACHE_MAX_BYTES", 1 << 30)
    t_auto2, _ = _fit("auto")
    assert t_auto2._device_cache is not None
    t_forced, _ = _fit(True)
    assert t_forced._device_cache is not None


def test_ineligible_datasets_fall_back():
    train, val = boring_loaders()  # RandomDataset exposes its array
    trainer = _trainer(True)
    trainer.fit(BoringModel(), train, val)
    assert trainer._device_cache is not None

    class NoArrays:
        def __len__(self):
            return 64

        def __getitem__(self, i):
            return np.zeros(32, np.float32)

    t2 = _trainer(True)
    t2.fit(BoringModel(), DataLoader(NoArrays(), batch_size=8))
    assert t2._device_cache is None and t2.global_step == 8


def test_whole_epoch_path_engages_without_the_per_step_function():
    """No per-step host needs: every epoch runs on the whole-epoch path
    and the step loop's cached step is never called."""
    train = DataLoader(ArrayDataset(_x(64)), batch_size=8, shuffle=True)
    trainer = _trainer(True, max_epochs=2, log_every_n_steps=10 ** 9)
    calls = []
    trainer._step_cached = lambda *a: calls.append(1)
    trainer.fit(BoringModel(), train)
    assert trainer.global_step == 16 and calls == []
    assert trainer._can_scan_epoch()


def test_whole_epoch_path_respects_max_steps():
    train = DataLoader(ArrayDataset(_x(64)), batch_size=8)
    trainer = _trainer(True, max_epochs=None, max_steps=11)
    trainer.fit(BoringModel(), train)
    assert trainer.global_step == 11   # 8 + 3 of the cut second epoch
    assert trainer.epochs_completed == 1


def test_max_steps_at_the_last_full_batch_matches_the_host_path():
    """max_steps on the last full batch: the trailing partial batch does
    not run and the epoch is not complete, as in the step loop."""
    def run(cache):
        train = DataLoader(ArrayDataset(_x(68)), batch_size=8,
                           drop_last=False)
        trainer = _trainer(cache, max_epochs=None, max_steps=8)
        trainer.fit(BoringModel(), train)
        return (trainer.global_step, trainer.epochs_completed,
                trainer.should_stop)

    assert run(True) == run(False) == (8, 0, True)


def test_batch_end_callbacks_fall_back_to_the_step_loop():
    class PerStep(Callback):
        def __init__(self):
            self.n = 0

        def on_train_batch_end(self, trainer, module, metrics, batch_idx):
            self.n += 1

    cb = PerStep()
    trainer = _trainer(True, callbacks=[cb])
    calls = []
    step = trainer._step_cached
    trainer._step_cached = lambda *a: calls.append(1) or step(*a)
    trainer.fit(BoringModel(), DataLoader(ArrayDataset(_x(32)),
                                          batch_size=8))
    assert not trainer._can_scan_epoch()
    assert cb.n == 4 and len(calls) == 4  # the cached step, per step
    # an instance-attribute hook stands the whole-epoch path down too
    hits = []
    plain = Callback()
    plain.on_train_batch_end = \
        lambda trainer, module, metrics, batch_idx: hits.append(batch_idx)
    trainer = _trainer(True, callbacks=[plain])
    trainer.fit(BoringModel(), DataLoader(ArrayDataset(_x(32)),
                                          batch_size=8))
    assert hits == [0, 1, 2, 3]


def test_whole_epoch_path_logs_on_cadence():
    logger = InMemoryLogger()
    trainer = _trainer(True, logger=logger, log_every_n_steps=3)
    trainer.fit(BoringModel(), DataLoader(ArrayDataset(_x(64)),
                                          batch_size=8))
    steps = [row["step"] for row in logger.history if "train_loss" in row]
    assert steps == [3, 6]  # 8 steps, cadence 3
    # the logged losses are the host-fed run's
    host_logger = InMemoryLogger()
    host = _trainer(False, logger=host_logger, log_every_n_steps=3)
    host.fit(BoringModel(), DataLoader(ArrayDataset(_x(64)), batch_size=8))
    assert [r["train_loss"] for r in logger.history] == \
        [r["train_loss"] for r in host_logger.history]


def test_guard_trip_on_the_whole_epoch_path_blames_the_batch(tmp_path):
    """A NaN row in batch 2: the whole-epoch path's one readback finds
    the trip, gathers the tripped batch again, and raises the host
    path's verdict."""
    x = _x(64)
    x[20, 3] = np.nan
    verdicts = []
    for cache in (True, False):
        trainer = _trainer(cache, default_root_dir=str(tmp_path / str(cache)),
                           log_every_n_steps=10 ** 9)
        with pytest.raises(NumericAnomaly) as ei:
            trainer.fit(BoringModel(), DataLoader(ArrayDataset(x),
                                                  batch_size=8))
        e = ei.value
        verdicts.append((e.step, e.epoch, e.batch_idx, e.blame))
    assert verdicts[0] == verdicts[1] == (2, 0, 2, "data")


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


def test_two_ranks_cached_match_host_fed(world, init, tmp_path):
    """Each rank caches the whole dataset and gathers its strided rows:
    the same 8 steps and the same weights, bit for bit, as the host-fed
    ranks."""
    init_np = jax.tree.map(np.asarray, init)
    runs = {}
    for cache in (True, False):
        runs[cache] = world.run(functools.partial(
            guard_trip_body, data=_x(64), init=init_np,
            root=str(tmp_path / str(cache)), cache=cache), deadline_s=120.0)
    for r_c, r_h in zip(runs[True], runs[False]):
        assert r_c["global_step"] == r_h["global_step"] == 8
        np.testing.assert_array_equal(r_c["kernel"], r_h["kernel"])
