"""The port's native batch engine (``native/data_engine.cc`` through
``DataLoader(use_native=)``) and the launcher's ship-once cache
(``DistributedWorld.ship_value``):

- the engine's batches are bitwise the port's Python loader's (shuffled,
  partial, rank shards, a break mid-epoch then a new pass) and the JAX
  package's ``DataEngine``'s at one replica;
- ineligible datasets take the Python path; a failed g++ build raises
  ``NativeBuildError`` (no fallback);
- fit -> test -> predict over 2 gloo ranks in one world ship the data
  once (``ship_stats``: ``sent`` and ``reused``), a loader whose engine
  is live crosses to the ranks, and ``teardown()`` removes the store."""

import os
import pickle

import numpy as np
import pytest
import torch

from ray_lightning_accelerators_tpu import native as jax_native
from ray_lightning_accelerators_tpu_torch import (DataLoader,
                                                  RayTPUAccelerator, Trainer)
from ray_lightning_accelerators_tpu_torch import native
from ray_lightning_accelerators_tpu_torch.data.loader import (
    ArrayDataset, RandomDataset)
from ray_lightning_accelerators_tpu_torch.runtime import bootstrap

from .torch_boring import BoringModel


def _arrays(n=70, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3, 4)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int64))


def _pairs(loader_a, loader_b):
    a, b = list(loader_a), list(loader_b)
    assert len(a) == len(b) > 0
    for (xa, ya), (xb, yb) in zip(a, b):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
    return a


def test_engine_builds_from_the_repo_source():
    lib = native.engine_lib()
    path = native.library_path(native.ENGINE_SRC)
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.name.startswith("data_engine-")
    assert lib.rla_engine_create is not None


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (True, False),
                                               (False, False)])
def test_engine_batches_are_the_python_loaders(shuffle, drop_last):
    x, y = _arrays()
    kw = dict(batch_size=8, shuffle=shuffle, drop_last=drop_last, seed=3)
    eng = DataLoader(ArrayDataset(x, y), **kw)
    py = DataLoader(ArrayDataset(x, y), use_native=False, **kw)
    for epoch in (0, 1):
        eng.set_epoch(epoch)
        py.set_epoch(epoch)
        got = _pairs(eng, py)
        assert len(got) == (8 if drop_last else 9)
    assert eng._engine is not None and py._engine is None


def test_engine_matches_the_jax_engine_at_one_replica():
    x, y = _arrays()
    ref = jax_native.DataEngine([x, y], batch_size=8, shuffle=True,
                                drop_last=False, seed=5)
    loader = DataLoader(ArrayDataset(x, y), batch_size=8, shuffle=True,
                        drop_last=False, seed=5)
    try:
        for epoch in (0, 2):
            loader.set_epoch(epoch)
            _pairs(loader, ref.epoch(epoch))
    finally:
        ref.close()


def test_rank_shards_are_the_python_paths_strided_rows():
    """Under 2 ranks each engine gathers its batch_size // 2 strided rows
    of every global batch, as the Python path does; the two shards of a
    batch are the global batch's rows."""
    x, y = _arrays(64)
    whole = list(DataLoader(ArrayDataset(x, y), batch_size=8, shuffle=True,
                            use_native=False))
    for rank in (0, 1):
        eng = DataLoader(ArrayDataset(x, y), batch_size=8, shuffle=True)
        py = DataLoader(ArrayDataset(x, y), batch_size=8, shuffle=True,
                        use_native=False)
        for loader in (eng, py):
            loader._inject_sampler(2, rank, shuffle=True)
        got = _pairs(eng, py)
        for (xs, _), (xw, _) in zip(got, whole):
            np.testing.assert_array_equal(xs, xw[rank::2])
        assert eng._engine.batch_size == 4


def test_break_mid_epoch_then_a_new_pass():
    x, y = _arrays()
    loader = DataLoader(ArrayDataset(x, y), batch_size=8, shuffle=True)
    py = DataLoader(ArrayDataset(x, y), batch_size=8, shuffle=True,
                    use_native=False)
    for i, _ in enumerate(loader):
        if i == 1:
            break
    assert not loader._engine_busy  # the abandoned pass let go
    _pairs(loader, py)
    # a second pass while one is live takes the Python path
    it = iter(loader)
    next(it)
    assert loader._native_engine() is None
    inner = list(loader)
    it.close()
    assert len(inner) == 8 and not loader._engine_busy


def test_ineligible_datasets_take_the_python_path():
    class NoArrays:
        def __len__(self):
            return 16

        def __getitem__(self, i):
            return np.full(3, i, np.float32)

    loader = DataLoader(NoArrays(), batch_size=4)
    assert len(list(loader)) == 4 and loader._engine is None
    with pytest.raises(RuntimeError, match="use_native=True"):
        list(DataLoader(NoArrays(), batch_size=4, use_native=True))
    objs = ArrayDataset(np.array([{"a": i} for i in range(8)], object))
    assert len(list(DataLoader(objs, batch_size=4))) == 2
    custom = DataLoader(RandomDataset(3, 8), batch_size=4,
                        collate_fn=lambda s: np.stack(s))
    assert len(list(custom)) == 2 and custom._engine is None


def test_a_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "torch_native")
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native.shutil, "which", lambda _name: None)
    with pytest.raises(native.NativeBuildError, match="no C"):
        native.engine_lib()
    x, y = _arrays(16)
    with pytest.raises(native.NativeBuildError):
        list(DataLoader(ArrayDataset(x, y), batch_size=4))


def test_fit_test_predict_ship_the_data_once(tmp_path):
    """One world of 2 gloo ranks: fit ships the training loader (its
    engine live on the driver: the pickle leaves it behind), test ships
    the evaluation loader, and predict over the same loader sends only
    its key; the ranks' results are the data's, and ``teardown()``
    removes the store."""
    saved = bootstrap.DEFAULT_TIMEOUT_S
    bootstrap.DEFAULT_TIMEOUT_S = 60.0
    x = np.random.default_rng(0).normal(size=(64, 32)).astype(np.float32)
    train = DataLoader(ArrayDataset(x), batch_size=8, shuffle=True)
    next(iter(train))
    assert train._engine is not None
    assert pickle.loads(pickle.dumps(train))._engine is None
    evaluation = DataLoader(ArrayDataset(x[:32]), batch_size=8)
    t = Trainer(device="cpu", accelerator=RayTPUAccelerator(2),
                max_epochs=1, precision="f32", enable_checkpointing=False,
                default_root_dir=str(tmp_path), seed=0)
    try:
        model = BoringModel()
        t.fit(model, train)
        assert t.global_step == 8
        (tested,) = t.test(model, evaluation)
        preds = t.predict(model, evaluation)
        world = t._world
        stats = dict(world.ship_stats)
        store = world.ship_dir()
        assert stats["sent"] == 2 and stats["reused"] == 1, stats
        assert stats["bytes"] > x.nbytes
        assert os.path.isdir(store) and len(os.listdir(store)) == 2
    finally:
        t.teardown()
        bootstrap.DEFAULT_TIMEOUT_S = saved
    assert not os.path.exists(store)
    want = torch.from_numpy(x[:32]) @ model.params["layer"]["kernel"] + \
        model.params["layer"]["bias"]
    got = torch.cat([torch.as_tensor(p) for p in preds])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert tested["y"] == pytest.approx(
        float(torch.mean((want - 1.0) ** 2)), rel=1e-5)
