"""Fixtures of the port's data-parallel tests, in a module that imports
no JAX: spawned ranks import it to unpickle the models, callbacks and
queue callables the tests ship them.  Port of tests/utils.py's
BoringModel, LinearClassifier, BlobsDataModule and helpers."""

from __future__ import annotations

import functools

import numpy as np
import torch

from ray_lightning_accelerators_tpu_torch import (Callback, DataLoader,
                                                  DataModule,
                                                  ModelCheckpoint,
                                                  TorchModule, Trainer,
                                                  get_actor_rank, put_queue)
from ray_lightning_accelerators_tpu_torch.core.optim import SGD, AdamW
from ray_lightning_accelerators_tpu_torch.data.loader import (
    ArrayDataset, IterableDataset, RandomDataset)


class BoringModel(TorchModule):
    """One linear layer whose loss moves the weights, a constant
    val_loss of 1.0, and a val_epoch counter kept in checkpoints."""

    def __init__(self, device="cpu"):
        super().__init__(device=device)
        self.val_epoch = 0

    def init_params(self, seed=0):
        g = torch.Generator().manual_seed(seed)
        return {"layer": {"kernel": torch.randn(32, 2, generator=g) * 0.5,
                          "bias": torch.zeros(2)}}

    def forward(self, params, x):
        x = torch.as_tensor(x, dtype=torch.float32)
        return x @ params["layer"]["kernel"] + params["layer"]["bias"]

    def training_step(self, params, batch, generator):
        loss = torch.mean((self.forward(params, batch) - 1.0) ** 2)
        return loss, {"loss": loss}

    def validation_step(self, params, batch):
        self.forward(params, batch)
        return {"val_loss": torch.tensor(1.0)}

    def test_step(self, params, batch):
        return {"y": torch.mean((self.forward(params, batch) - 1.0) ** 2)}

    def on_validation_epoch_end(self):
        self.val_epoch += 1

    def configure_optimizers(self):
        return SGD(0.1)

    def on_save_checkpoint(self, checkpoint):
        checkpoint["val_epoch"] = self.val_epoch

    def on_load_checkpoint(self, checkpoint):
        self.val_epoch = checkpoint.get("val_epoch", self.val_epoch)


def boring_loaders(batch_size: int = 8):
    return (DataLoader(RandomDataset(32, 64), batch_size=batch_size,
                       shuffle=True),
            DataLoader(RandomDataset(32, 64), batch_size=batch_size))


class BlobsDataModule(DataModule):
    """Linearly separable 4-class blobs."""

    def __init__(self, n: int = 512, dim: int = 32, classes: int = 4,
                 batch_size: int = 16, seed: int = 0):
        rng = np.random.default_rng(seed)
        centers = rng.standard_normal((classes, dim)).astype(np.float32) * 4
        y = rng.integers(0, classes, size=n)
        x = centers[y] + rng.standard_normal((n, dim)).astype(np.float32)
        split = int(n * 0.75)
        self._train = (x[:split], y[:split].astype(np.int64))
        self._test = (x[split:], y[split:].astype(np.int64))
        self.batch_size = batch_size

    def train_dataloader(self):
        return DataLoader(ArrayDataset(*self._train),
                          batch_size=self.batch_size, shuffle=True)

    def val_dataloader(self):
        return DataLoader(ArrayDataset(*self._test),
                          batch_size=self.batch_size)

    def test_dataloader(self):
        return DataLoader(ArrayDataset(*self._test),
                          batch_size=self.batch_size, drop_last=False)


class LinearClassifier(TorchModule):
    def __init__(self, dim: int = 32, classes: int = 4, lr: float = 0.05,
                 device="cpu"):
        super().__init__(device=device)
        self.save_hyperparameters(dim=dim, classes=classes, lr=lr)
        self.dim, self.classes, self.lr = dim, classes, lr

    def init_params(self, seed=0):
        g = torch.Generator().manual_seed(seed)
        return {"w": torch.randn(self.dim, self.classes, generator=g) * 0.01,
                "b": torch.zeros(self.classes)}

    def forward(self, params, x):
        return torch.as_tensor(x) @ params["w"] + params["b"]

    def _loss(self, params, batch):
        x, y = batch
        logits = self.forward(params, x)
        loss = torch.nn.functional.cross_entropy(logits, y.long())
        return loss, torch.mean((logits.argmax(-1) == y).float())

    def training_step(self, params, batch, generator):
        loss, acc = self._loss(params, batch)
        return loss, {"loss": loss, "acc": acc}

    def validation_step(self, params, batch):
        loss, acc = self._loss(params, batch)
        return {"val_loss": loss, "val_accuracy": acc}

    def predict_step(self, params, batch):
        x = batch[0] if isinstance(batch, (tuple, list)) else batch
        return self.forward(params, x)

    def configure_optimizers(self):
        return AdamW(self.lr, weight_decay=0.0)


def get_trainer(dir, accelerator, max_epochs: int = 1,
                limit_train_batches: int = 10, limit_val_batches: int = 10,
                callbacks=None, **kwargs) -> Trainer:
    callbacks = list(callbacks or [])
    if not any(isinstance(c, ModelCheckpoint) for c in callbacks):
        callbacks.append(ModelCheckpoint(monitor="val_loss"))
    return Trainer(device="cpu", default_root_dir=str(dir),
                   max_epochs=max_epochs,
                   limit_train_batches=limit_train_batches,
                   limit_val_batches=limit_val_batches,
                   accelerator=accelerator, callbacks=callbacks,
                   precision="f32", seed=0, **kwargs)


def _abs_sums(params):
    return np.array([float(params["layer"][k].abs().sum())
                     for k in ("bias", "kernel")])


def train_test(trainer, model, train_loader=None, val_loader=None):
    """The weights the driver's module holds after fit moved."""
    if train_loader is None:
        train_loader, val_loader = boring_loaders()
    initial = _abs_sums(model.init_params(trainer.seed))
    trainer.fit(model, train_loader, val_loader)
    assert model.params is not None, "trainer failed"
    assert np.linalg.norm(initial - _abs_sums(model.params)) > 0.1, \
        "model unchanged post-training"


def load_test(trainer, model, cls=BoringModel):
    """The best checkpoint round trip."""
    train_loader, val_loader = boring_loaders()
    trainer.fit(model, train_loader, val_loader)
    best = trainer.checkpoint_callback.best_model_path
    assert best, "no best_model_path recorded"
    trained = cls.load_from_checkpoint(best)
    assert trained is not None and trained.params is not None


def predict_test(trainer, model, dm):
    """Accuracy >= 0.5 on held-out blobs with the driver's weights."""
    trainer.fit(model, datamodule=dm)
    dm.setup("test")
    correct = total = 0
    for x, y in dm.test_dataloader():
        y_hat = model.forward(model.params, torch.from_numpy(x)).cpu()
        correct += int((y_hat.argmax(-1).numpy() == y).sum())
        total += len(y)
    assert correct / total >= 0.5, f"accuracy {correct / total}"


# ------------------------------------------------------------------ #
# Reporting from inside the ranks through put_queue                   #
# ------------------------------------------------------------------ #
REPORTS: list = []


def record(item) -> None:
    """Runs in the driver: a rank's report."""
    REPORTS.append(item)


def report_hook() -> None:
    """An accelerator's init_hook: each rank reports that it ran it."""
    put_queue(functools.partial(record, ("init_hook", get_actor_rank())))


class SamplerProbe(Callback):
    """Sends each rank's injected samplers home at fit start."""

    def on_fit_start(self, trainer, module):
        val = trainer._val_loader
        put_queue(functools.partial(record, {
            "rank": get_actor_rank(),
            "train": _sampler_fields(trainer.train_dataloader.sampler),
            "val": _sampler_fields(val.sampler),
            "rows": next(iter(trainer.train_dataloader)).shape[0]}))


def _sampler_fields(s):
    return {"shuffle": s.shuffle, "num_replicas": s.num_replicas,
            "rank": s.rank}


class CountingStream(IterableDataset):
    """A ragged stream: ``n`` rows of 32 features, row i filled with i."""

    def __init__(self, n: int):
        self.n = n

    def __iter__(self):
        for i in range(self.n):
            yield np.full(32, i, np.float32)
