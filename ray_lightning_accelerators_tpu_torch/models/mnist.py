"""MNISTClassifier: the MNIST MLP model family.

Port of the JAX package's ``models/mnist.py``: a 3-layer MLP over
flattened 28x28 images, configured by a dict (``layer_1``, ``layer_2``,
``lr``, ``batch_size``), compute in the trainer's precision (the bias is
added in the compute dtype, as there), logits, loss and accuracy in f32.
The optimizer is ``optax.adam(lr)``: ``AdamW(lr, weight_decay=0)``.

``MNISTDataModule(data_dir=...)`` reads real MNIST IDX files when they
are present (``data/vision.py``) and otherwise makes the JAX package's
deterministic synthetic MNIST (class-conditional glyphs + noise, the
same numpy generator and seed, so the same arrays); ``source`` says which
one backed a run.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.module import DeviceLike, TorchModule
from ..core.optim import AdamW
from ..data.datamodule import DataModule
from ..data.loader import ArrayDataset, DataLoader

Params = Dict[str, Any]


def softmax_xent_acc(logits: torch.Tensor, labels: torch.Tensor):
    """``optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()``
    on f32 logits, and the accuracy ``mean(argmax == y)``."""
    labels = labels.long()
    loss = F.cross_entropy(logits.float(), labels)
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, acc


class MNISTClassifier(TorchModule):
    """3-layer MLP over flattened 28x28 inputs (config keys: layer_1,
    layer_2, lr, batch_size).  ``device`` None = the CUDA device."""

    def __init__(self, config: Optional[Dict[str, Any]] = None,
                 data_dir: Optional[str] = None, device: DeviceLike = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(device=device, compute_dtype=compute_dtype)
        config = dict(config or {})
        self.layer_1 = int(config.get("layer_1", 128))
        self.layer_2 = int(config.get("layer_2", 256))
        self.lr = float(config.get("lr", 1e-3))
        self.batch_size = int(config.get("batch_size", 128))
        self.num_classes = 10
        self.in_dim = 28 * 28
        self.data_dir = data_dir
        self.save_hyperparameters(config=config, data_dir=data_dir)

    def init_params(self, seed: int = 0) -> Params:
        """He-normal kernels and zero biases in the JAX init's shapes,
        drawn from a ``torch.Generator`` (other numbers than
        ``jax.random``'s; parity tests carry JAX weights over with
        ``utils.weights.params_from_jax``)."""
        dev = self.device
        g = torch.Generator(device=dev).manual_seed(int(seed))
        dims = [self.in_dim, self.layer_1, self.layer_2, self.num_classes]
        params = {}
        for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
            params[f"dense_{i}"] = {
                "kernel": torch.randn((d_in, d_out), generator=g, device=dev)
                * (2.0 / d_in) ** 0.5,
                "bias": torch.zeros((d_out,), device=dev),
            }
        return params

    def forward(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = torch.as_tensor(x, device=self.device)
        x = x.reshape(x.shape[0], -1).to(dt)
        for i in range(3):
            layer = params[f"dense_{i}"]
            x = x @ layer["kernel"].to(dt) + layer["bias"].to(dt)
            if i < 2:
                x = torch.relu(x)
        return x.float()

    def _loss_acc(self, params: Params, batch: Any):
        x, y = batch
        return softmax_xent_acc(self.forward(params, x),
                                torch.as_tensor(y, device=self.device))

    def training_step(self, params: Params, batch: Any,
                      generator: Optional[torch.Generator] = None):
        loss, acc = self._loss_acc(params, batch)
        return loss, {"ptl/train_loss": loss, "ptl/train_accuracy": acc}

    def validation_step(self, params: Params, batch: Any):
        loss, acc = self._loss_acc(params, batch)
        return {"ptl/val_loss": loss, "ptl/val_accuracy": acc,
                "val_loss": loss, "val_accuracy": acc}

    def predict_step(self, params: Params, batch: Any):
        x = batch[0] if isinstance(batch, (tuple, list)) else batch
        return self.forward(params, x)

    def configure_optimizers(self) -> AdamW:
        return AdamW(self.lr, weight_decay=0.0)


def synthetic_mnist(n: int, seed: int = 0):
    """Digit-like class-conditional patterns + pixel noise, shapes
    [n,28,28]; the JAX package's generator, array for array."""
    # fixed-rng prototypes: every seed samples the same underlying task, so
    # train/val splits drawn with different seeds still generalize
    protos = np.random.default_rng(1234).random(
        (10, 28, 28), dtype=np.float32) > 0.75  # sparse glyphs
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 10, size=n)
    x = protos[y].astype(np.float32)
    x += rng.standard_normal((n, 28, 28), dtype=np.float32) * 0.35
    return np.clip(x, 0.0, 1.0), y.astype(np.int32)


class MNISTDataModule(DataModule):
    """Real MNIST when IDX files exist under ``data_dir`` (val = the
    held-out tail of train, test = the t10k split), synthetic otherwise.
    ``source`` reports which one backed this run."""

    def __init__(self, batch_size: int = 128, n_train: int = 55000,
                 n_val: int = 5000, seed: int = 0,
                 data_dir: Optional[str] = None):
        self.batch_size = batch_size
        self.n_train, self.n_val, self.seed = n_train, n_val, seed
        self.data_dir = data_dir
        self.source = "synthetic"
        self._train = self._val = self._test = None

    def setup(self, stage: str) -> None:
        if self._train is not None:
            return
        if self.data_dir is not None:
            from ..data import vision
            real = vision.load_mnist(self.data_dir, "train")
            if real is not None:
                x, y = real
                n_train = min(self.n_train, len(x) - 1)
                self._train = (x[:n_train], y[:n_train])
                self._val = (x[n_train:n_train + self.n_val],
                             y[n_train:n_train + self.n_val])
                self._test = vision.load_mnist(self.data_dir, "test")
                self.source = "real"
                return
        x, y = synthetic_mnist(self.n_train + self.n_val, self.seed)
        self._train = (x[:self.n_train], y[:self.n_train])
        self._val = (x[self.n_train:], y[self.n_train:])
        self._test = None

    def train_dataloader(self):
        return DataLoader(ArrayDataset(*self._train),
                          batch_size=self.batch_size, shuffle=True)

    def val_dataloader(self):
        return DataLoader(ArrayDataset(*self._val),
                          batch_size=self.batch_size)

    def test_dataloader(self):
        arrays = self._test if self._test is not None else self._val
        return DataLoader(ArrayDataset(*arrays),
                          batch_size=self.batch_size)
