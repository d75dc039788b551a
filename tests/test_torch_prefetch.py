"""The port's async input pipeline (``data/prefetch.py``) and its wiring
through ``Trainer.fit`` / ``validate`` / ``predict``: the JAX package's
``tests/test_prefetch.py`` cases that need no profiler, run on the
port's classes, plus the JAX ``Trainer``'s prefetched MNIST trajectory
against the port's.  Bitwise where the pipeline only moves host work
(prefetch on against off); the JAX trajectory's first epoch within the
MNIST fit's parity bound of tests/test_torch_vision.py (2e-4)."""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from ray_lightning_accelerators_tpu import Trainer as JaxTrainer
from ray_lightning_accelerators_tpu.data.loader import (
    ArrayDataset as JaxArrayDataset, DataLoader as JaxDataLoader)
from ray_lightning_accelerators_tpu.models.mnist import (
    MNISTClassifier as JaxMNIST)
from ray_lightning_accelerators_tpu_torch import (Callback, DataLoader,
                                                  Trainer)
from ray_lightning_accelerators_tpu_torch.data.loader import (
    ArrayDataset, IterableDataset)
from ray_lightning_accelerators_tpu_torch.data.prefetch import (
    DevicePrefetcher, PrefetchClosed, PrefetchIterator, prefetch_pipeline,
    to_device)
from ray_lightning_accelerators_tpu_torch.models.mnist import (
    MNISTClassifier, synthetic_mnist)
from ray_lightning_accelerators_tpu_torch.utils.weights import (
    params_from_jax)

from .torch_boring import BoringModel

pytestmark = pytest.mark.prefetch


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("rla-prefetch") and t.is_alive()]


# --------------------------------------------------------------------- #
# PrefetchIterator / DevicePrefetcher                                   #
# --------------------------------------------------------------------- #
def test_order_preserved_and_thread_joined():
    it = PrefetchIterator(iter(range(100)), depth=3)
    assert list(it) == list(range(100))
    assert not _prefetch_threads()  # exhaustion joins the producer


def test_depth_bounds_producer_runahead():
    pulled = []

    def source():
        for i in range(50):
            pulled.append(i)
            yield i

    it = PrefetchIterator(source(), depth=3)
    try:
        consumed = 0
        for _ in it:
            time.sleep(0.01)  # slow consumer: the producer races ahead
            consumed += 1
            # at most depth queued + 1 in the producer's hand
            assert len(pulled) <= consumed + 3 + 1
            if consumed == 20:
                break
    finally:
        it.close()
    assert not _prefetch_threads()


def test_close_mid_iteration_is_idempotent_and_final():
    closed = []

    def source():
        try:
            yield from range(1000)
        finally:
            closed.append(True)

    it = PrefetchIterator(source(), depth=2)
    assert next(it) == 0
    it.close()
    it.close()  # idempotent
    assert not _prefetch_threads()
    assert closed == [True]  # the source's finally ran at close()
    with pytest.raises(PrefetchClosed):
        next(it)


def test_worker_exception_is_typed_and_in_order():
    def source():
        yield from (0, 1)
        raise ValueError("collate exploded")

    it = PrefetchIterator(source(), depth=4)
    assert next(it) == 0
    assert next(it) == 1
    with pytest.raises(ValueError, match="collate exploded"):
        next(it)  # the original type and message
    assert not _prefetch_threads()


def test_device_prefetcher_place_error_surfaces_at_its_position():
    def place(i):
        if i == 3:
            raise RuntimeError("bad placement")
        return i * 10

    pipe = prefetch_pipeline(iter(range(6)), depth=4, place_fn=place)
    try:
        assert [next(pipe) for _ in range(3)] == [0, 10, 20]
        with pytest.raises(RuntimeError, match="bad placement"):
            next(pipe)  # items 0..2 consumed first, then the failure
    finally:
        pipe.close()
    assert not _prefetch_threads()


def test_device_prefetcher_runs_ahead_and_counts_starvation():
    placed = []
    pipe = prefetch_pipeline(iter(range(10)), depth=3,
                             place_fn=lambda i: placed.append(i) or i)
    try:
        got = [next(pipe) for _ in range(3)]
        time.sleep(0.3)  # let the host stage fill its queue
        next(pipe)
        # after 4 consumed, placement was issued past the consumer
        assert got == [0, 1, 2] and len(placed) >= 5
        assert len(pipe.depth_seen) == 4
    finally:
        pipe.close()

    def slow():
        for i in range(4):
            time.sleep(0.05)
            yield i

    pipe = prefetch_pipeline(slow(), depth=2)
    try:
        assert list(pipe) == [0, 1, 2, 3]
        # the first batch is warm-up; the three after found the ring empty
        assert pipe.starved_steps == 3
    finally:
        pipe.close()


def test_device_prefetcher_close_handles_plain_iterators():
    d = DevicePrefetcher((i for i in range(5)), depth=2)
    assert next(d) == 0
    d.close()
    with DevicePrefetcher(iter([1, 2, 3]), depth=2) as d2:
        assert next(d2) == 1


def test_cpu_placement_refuses_cuda_tensors_and_passes_through():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    out = to_device({"x": x, "n": 3}, torch.device("cpu"), pin=True)
    assert torch.equal(out["x"], torch.from_numpy(x)) and out["n"] == 3
    t = torch.ones(2)
    assert to_device(t, "cpu") is t

    class FakeCuda(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    d = DevicePrefetcher(iter([0]), depth=1,
                         place_fn=lambda _: torch.ones(1).as_subclass(
                             FakeCuda))
    with pytest.raises(ValueError, match="without a CUDA device"):
        next(d)
    d.close()


def test_depth_validation():
    with pytest.raises(ValueError, match="depth"):
        PrefetchIterator(iter(()), depth=0)
    with pytest.raises(ValueError, match="prefetch_batches"):
        Trainer(device="cpu", prefetch_batches=-1)


class _EpochStream(IterableDataset):
    """A deterministic epoch-reshuffled stream of scalar rows."""

    def __init__(self, n: int):
        self.n = n
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self):
        order = np.random.default_rng((99, self.epoch)).permutation(self.n)
        for i in order:
            yield np.asarray([i], np.float32)


def test_iterable_round_robin_shards_survive_prefetch():
    """Prefetch reproduces each rank's round-robin slices of a stream,
    per epoch; the ranks stay disjoint."""
    n, replicas, bs = 48, 2, 4
    for epoch in (0, 1):
        flat = []
        for rank in range(replicas):
            def batches(prefetch: bool):
                loader = DataLoader(_EpochStream(n), batch_size=bs)
                loader._inject_sampler(replicas, rank, shuffle=False)
                loader.set_epoch(epoch)
                if not prefetch:
                    return list(loader)
                with PrefetchIterator(iter(loader), depth=2) as it:
                    return list(it)

            plain, pref = batches(False), batches(True)
            assert len(plain) == len(pref) > 0
            for a, b in zip(plain, pref):
                np.testing.assert_array_equal(a, b)
            flat.append(np.concatenate(pref).ravel())
        flat = np.concatenate(flat)
        assert len(set(flat.tolist())) == len(flat)
    assert not _prefetch_threads()


# --------------------------------------------------------------------- #
# The Trainer                                                           #
# --------------------------------------------------------------------- #
class _LossTrace(Callback):
    def __init__(self):
        self.losses = []

    def on_train_batch_end(self, trainer, module, metrics, batch_idx):
        self.losses.append(float(metrics["ptl/train_loss"]))


HP = {"layer_1": 32, "layer_2": 32, "lr": 1e-3, "batch_size": 64}


def _mnist_fit(prefetch: int, params=None, use_native=None, **kwargs):
    x, y = synthetic_mnist(64 * 6, seed=0)
    loader = DataLoader(ArrayDataset(x, y), batch_size=64, shuffle=True,
                        use_native=use_native)
    model = MNISTClassifier(HP, device="cpu")
    model.params = params
    trace = _LossTrace()
    trainer = Trainer(max_epochs=2, device="cpu", precision="f32",
                      enable_checkpointing=False, log_every_n_steps=10 ** 9,
                      seed=0, prefetch_batches=prefetch, callbacks=[trace],
                      **kwargs)
    trainer.fit(model, loader)
    return trainer, trace.losses


def test_train_loss_bitwise_prefetch_on_off_and_jax():
    """12 MNIST steps: the same losses bit for bit with prefetch 0 and 2;
    the JAX Trainer's prefetched run from the same weights within 2e-4
    relative over the first epoch."""
    jm = JaxMNIST(HP)
    init = jax.device_get(jm.init_params(jax.random.PRNGKey(0)))
    t0, losses0 = _mnist_fit(0, params_from_jax(init, device="cpu"))
    t2, losses2 = _mnist_fit(2, params_from_jax(init, device="cpu"))
    assert t0.global_step == t2.global_step == 12
    assert losses0 == losses2
    jm.params = init
    x, y = synthetic_mnist(64 * 6, seed=0)
    jlog = []

    from ray_lightning_accelerators_tpu.core.callbacks import (
        Callback as JaxCallback)

    class Trace(JaxCallback):
        def on_train_batch_end(self, trainer, module, metrics, batch_idx):
            jlog.append(float(jax.device_get(metrics["ptl/train_loss"])))

    JaxTrainer(max_epochs=2, precision="f32", enable_checkpointing=False,
               log_every_n_steps=10 ** 9, seed=0, prefetch_batches=2,
               callbacks=[Trace()]).fit(
        jm, JaxDataLoader(JaxArrayDataset(x, y), batch_size=64,
                          shuffle=True))
    # the first epoch at tests/test_torch_vision.py's MNIST fit bound
    # (2e-4 a step; f32 sums in other orders compound over the steps:
    # measured 1e-6 at step 6, 3.7e-4 at step 12)
    assert len(jlog) == 12
    np.testing.assert_allclose(losses2[:6], jlog[:6], rtol=2e-4)
    assert not _prefetch_threads()


@pytest.mark.parametrize("use_native", [None, False])
def test_early_stops_join_thread_and_match_unprefetched(use_native):
    """``limit_train_batches`` and a ``max_steps`` break mid-epoch, with
    the engine feeding the placement directly (None) and with the Python
    loader on the producer thread (False)."""
    t0, l0 = _mnist_fit(0, limit_train_batches=3, use_native=use_native)
    t2, l2 = _mnist_fit(2, limit_train_batches=3, use_native=use_native)
    assert t0.global_step == t2.global_step == 6
    assert l0 == l2
    t0, l0 = _mnist_fit(0, max_steps=4, use_native=use_native)
    t2, l2 = _mnist_fit(2, max_steps=4, use_native=use_native)
    assert t0.global_step == t2.global_step == 4
    assert l0 == l2
    assert not _prefetch_threads()


def test_pipeline_without_a_host_thread_places_ahead_in_order():
    """``host_thread=False`` (a source that gathers ahead itself): no
    producer thread, the placements still run ``depth`` ahead of the
    consumer, in order, with a failure raised at its position."""
    placed = []

    def place(i):
        if i == 7:
            raise RuntimeError("bad placement")
        placed.append(i)
        return i * 10

    pipe = prefetch_pipeline(iter(range(10)), depth=3, place_fn=place,
                             host_thread=False)
    try:
        assert not _prefetch_threads()
        assert next(pipe) == 0 and placed == [0, 1, 2]
        assert [next(pipe) for _ in range(6)] == [10, 20, 30, 40, 50, 60]
        with pytest.raises(RuntimeError, match="bad placement"):
            next(pipe)
    finally:
        pipe.close()


class _PoisonDataset(ArrayDataset):
    """Raises on one sample index, mid-epoch."""

    def __init__(self, *arrays, poison_idx: int):
        super().__init__(*arrays)
        self.poison_idx = poison_idx

    def __getitem__(self, idx):
        if idx == self.poison_idx:
            raise ValueError("poisoned sample 42")
        return super().__getitem__(idx)

    def _native_arrays(self):
        return None  # the Python path


def test_mid_epoch_error_surfaces_typed_at_the_consuming_step():
    """A dataset failure at batch 3 surfaces as the original error after
    exactly 3 steps, as the unprefetched loop."""
    bs, n = 8, 64
    x = np.random.default_rng(0).standard_normal((n, 32)).astype(np.float32)
    steps = {}
    for prefetch in (0, 2):
        loader = DataLoader(_PoisonDataset(x, poison_idx=3 * bs),
                            batch_size=bs)
        trainer = Trainer(max_epochs=1, device="cpu", precision="f32",
                          enable_checkpointing=False,
                          log_every_n_steps=10 ** 9, seed=0,
                          prefetch_batches=prefetch)
        with pytest.raises(ValueError, match="poisoned sample 42"):
            trainer.fit(BoringModel(), loader)
        steps[prefetch] = trainer.global_step
    assert steps[0] == steps[2] == 3
    assert not _prefetch_threads()


def test_eval_and_predict_prefetch_parity():
    x = np.random.default_rng(3).standard_normal((44, 32)).astype(np.float32)
    model = BoringModel()
    model.params = model.init_params(0)
    results = {}
    for prefetch in (0, 2):
        trainer = Trainer(max_epochs=1, device="cpu", precision="f32",
                          enable_checkpointing=False, seed=0,
                          prefetch_batches=prefetch)
        metrics = trainer.test(model, DataLoader(ArrayDataset(x),
                                                 batch_size=8))[0]
        preds = trainer.predict(model, DataLoader(
            ArrayDataset(x), batch_size=8, drop_last=False))
        results[prefetch] = (metrics, preds)
    (m0, p0), (m2, p2) = results[0], results[2]
    assert m0 == m2
    assert len(p0) == len(p2) == 6
    for a, b in zip(p0, p2):
        assert torch.equal(a, b)
    assert sum(len(p) for p in p2) == len(x)
    assert not _prefetch_threads()
