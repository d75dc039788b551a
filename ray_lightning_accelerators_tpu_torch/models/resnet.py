"""CIFAR-10 ResNet-18: the convolutional model family.

Port of the JAX package's ``models/resnet.py``: BasicBlock x [2,2,2,2],
a 3x3 stride-1 stem without max-pool, GroupNorm (per-example statistics,
so the step is a function of ``(params, batch)`` alone), global average
pooling and an f32 head.  Convolutions go to ``F.conv2d`` (cuDNN on the
card) and GroupNorm to plain PyTorch, as both are plain XLA in the JAX
package; there is no hand-written kernel on this model's path.

Layouts are the JAX package's at the public surface: parameters keep
their leaf names, conv kernels are stored HWIO ``[kh, kw, c_in, c_out]``
and permuted to PyTorch's OIHW where they are used, and ``forward``
takes NHWC images (or NCHW ``[n, 3, h, w]``, as there).  Inside, the
activations are NCHW tensors; on the card their memory is channels-last
(NHWC), the layout cuDNN's fastest convolutions take.

Two details carry the reference's numbers exactly:

- ``padding="SAME"`` pads ``total = max((ceil(n/s) - 1) s + k - n, 0)``
  per spatial dim, ``total // 2`` before and the rest after: a 3x3
  stride-2 conv on an even input pads (0 before, 1 after), which
  ``F.conv2d(padding=1)`` would not (it shifts every downsampled map by
  a pixel), so an asymmetric pad goes through ``F.pad`` first;
- GroupNorm takes the largest divisor of ``c`` that is <= 32 as its group
  count, f32 statistics with the biased variance and ``eps = 1e-5``, the
  affine in f32, and casts back to the compute dtype.

The optimizer is the JAX package's: ``chain(add_decayed_weights(wd),
sgd(lr, momentum, nesterov=True))``, or ``adamw(lr, weight_decay=wd)``
with ``config["optimizer"] == "adam"``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.module import DeviceLike, TorchModule
from ..core.optim import SGD, AdamW
from ..data.datamodule import DataModule
from ..data.loader import ArrayDataset, DataLoader
from .mnist import softmax_xent_acc

Params = Dict[str, Any]


def _same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial dim: (before, after)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _layout(x: torch.Tensor) -> torch.memory_format:
    """The activations' memory layout: channels-last (NHWC memory seen
    as an NCHW tensor) on the card; plain NCHW on the CPU, since torch
    2.11's CPU build corrupts its heap in the oneDNN backward of a
    channels-last convolution.  On an H100 at ``bench_cifar``'s config
    NCHW saves about a tenth of the step's device time but not its wall
    time, which the host sets, and it moves the card's f32 trajectory
    off the CPU port's where that trajectory turns on rounding
    (``chip_smoke.py`` phases 7b and 7d measure both)."""
    return torch.channels_last if x.is_cuda else torch.contiguous_format


def _conv(x: torch.Tensor, kernel_hwio: torch.Tensor,
          stride: int) -> torch.Tensor:
    """``conv_general_dilated(x, kernel, stride, "SAME", NHWC/HWIO/NHWC)``
    on an NCHW-shaped (channels-last) x with an HWIO kernel."""
    kh, kw = kernel_hwio.shape[:2]
    # HWIO -> OIHW, in the activations' memory layout
    w = kernel_hwio.permute(3, 2, 0, 1).contiguous(
        memory_format=_layout(x))
    (ht, hb), (wl, wr) = (_same_pads(x.shape[2], kh, stride),
                          _same_pads(x.shape[3], kw, stride))
    if ht == hb and wl == wr:
        return F.conv2d(x, w, stride=stride, padding=(ht, wl))
    return F.conv2d(F.pad(x, (wl, wr, ht, hb)), w, stride=stride)


def _group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """Per-example group normalization over (H, W, C/groups), f32 math,
    cast back to x's dtype.  x: [n, c, h, w]."""
    c = x.shape[1]
    g = min(groups, c)
    while c % g:  # widths need not be multiples of 32; largest divisor wins
        g -= 1
    return F.group_norm(x.float(), g, scale.float(), bias.float(),
                        eps).to(x.dtype)


class ResNet18(TorchModule):
    """CIFAR ResNet-18 (BasicBlock x [2,2,2,2]), GroupNorm.

    Config keys (a dict, as in the JAX package): ``lr``, ``batch_size``,
    ``num_classes``, ``width`` (stem channels, default 64),
    ``weight_decay``, ``momentum``, ``optimizer`` ("sgd" or "adam").
    ``device`` None = the CUDA device.
    """

    STAGES: Sequence[int] = (2, 2, 2, 2)

    def __init__(self, config: Optional[Dict[str, Any]] = None,
                 device: DeviceLike = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(device=device, compute_dtype=compute_dtype)
        config = dict(config or {})
        self.lr = float(config.get("lr", 0.1))
        self.momentum = float(config.get("momentum", 0.9))
        self.weight_decay = float(config.get("weight_decay", 5e-4))
        self.num_classes = int(config.get("num_classes", 10))
        self.width = int(config.get("width", 64))
        self.batch_size = int(config.get("batch_size", 256))
        self.save_hyperparameters(config=config)

    # ---------------------------------------------------------------- #
    # parameters                                                       #
    # ---------------------------------------------------------------- #
    def init_params(self, seed: int = 0) -> Params:
        """He-normal HWIO conv kernels, unit/zero norm scales and biases
        and a 1/sqrt(fan_in) head, in the JAX init's shapes and tree,
        drawn from a ``torch.Generator`` (other numbers than
        ``jax.random``'s; parity tests carry JAX weights over with
        ``utils.weights.params_from_jax``)."""
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(int(seed))

        def conv(kh, kw, c_in, c_out):
            return torch.randn((kh, kw, c_in, c_out), generator=gen,
                               device=dev) * (2.0 / (kh * kw * c_in)) ** 0.5

        def norm(c):
            return {"scale": torch.ones((c,), device=dev),
                    "bias": torch.zeros((c,), device=dev)}

        w = self.width
        widths = [w, 2 * w, 4 * w, 8 * w]
        params: Params = {"stem": {"conv": conv(3, 3, 3, w), "norm": norm(w)}}
        c_in = w
        for s, (n_blocks, c_out) in enumerate(zip(self.STAGES, widths)):
            for b in range(n_blocks):
                stride = 2 if (s > 0 and b == 0) else 1
                p = {"conv1": conv(3, 3, c_in, c_out), "norm1": norm(c_out),
                     "conv2": conv(3, 3, c_out, c_out), "norm2": norm(c_out)}
                if stride != 1 or c_in != c_out:
                    p["proj"] = conv(1, 1, c_in, c_out)
                params[f"stage{s}_block{b}"] = p
                c_in = c_out
        params["head"] = {
            "kernel": torch.randn((c_in, self.num_classes), generator=gen,
                                  device=dev) * (1.0 / c_in) ** 0.5,
            "bias": torch.zeros((self.num_classes,), device=dev),
        }
        return params

    # ---------------------------------------------------------------- #
    # forward                                                          #
    # ---------------------------------------------------------------- #
    def _block(self, p: Params, x: torch.Tensor, stride: int) -> torch.Tensor:
        dt = x.dtype
        h = _conv(x, p["conv1"].to(dt), stride)
        h = _group_norm(h, p["norm1"]["scale"], p["norm1"]["bias"])
        h = torch.relu(h)
        h = _conv(h, p["conv2"].to(dt), 1)
        h = _group_norm(h, p["norm2"]["scale"], p["norm2"]["bias"])
        if "proj" in p:
            x = _conv(x, p["proj"].to(dt), stride)
        return torch.relu(x + h)

    def forward(self, params: Params, x: Any) -> torch.Tensor:
        """f32 logits [n, num_classes] of NHWC images [n, 32, 32, 3] (or
        NCHW [n, 3, 32, 32])."""
        x = torch.as_tensor(x, device=self.device)
        if x.ndim == 4 and x.shape[1] == 3 and x.shape[-1] != 3:
            x = x.permute(0, 2, 3, 1)                  # NCHW -> NHWC
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=_layout(x))
        stem = params["stem"]
        x = _conv(x, stem["conv"].to(x.dtype), 1)
        x = _group_norm(x, stem["norm"]["scale"], stem["norm"]["bias"])
        x = torch.relu(x)
        for s, n_blocks in enumerate(self.STAGES):
            for b in range(n_blocks):
                stride = 2 if (s > 0 and b == 0) else 1
                x = self._block(params[f"stage{s}_block{b}"], x, stride)
        x = torch.mean(x, dim=(2, 3))     # global average pool -> [n, 8w]
        head = params["head"]
        return x.float() @ head["kernel"] + head["bias"]

    # ---------------------------------------------------------------- #
    # steps                                                            #
    # ---------------------------------------------------------------- #
    def _loss_acc(self, params: Params, batch: Any):
        x, y = batch
        return softmax_xent_acc(self.forward(params, x),
                                torch.as_tensor(y, device=self.device))

    def training_step(self, params: Params, batch: Any,
                      generator: Optional[torch.Generator] = None):
        loss, acc = self._loss_acc(params, batch)
        return loss, {"train_loss": loss, "train_accuracy": acc}

    def validation_step(self, params: Params, batch: Any):
        loss, acc = self._loss_acc(params, batch)
        return {"val_loss": loss, "val_accuracy": acc}

    def predict_step(self, params: Params, batch: Any):
        x = batch[0] if isinstance(batch, (tuple, list)) else batch
        return self.forward(params, x)

    def configure_optimizers(self):
        opt = str(self.hparams["config"].get("optimizer", "sgd"))
        if opt == "adam":
            return AdamW(self.lr, weight_decay=self.weight_decay)
        return SGD(self.lr, momentum=self.momentum, nesterov=True,
                   weight_decay=self.weight_decay)


def synthetic_cifar10(n: int, seed: int = 0):
    """Class-conditional 32x32x3 textures + noise, NHWC; the JAX package's
    generator, array for array: learnable from low-frequency class
    patterns, not trivial."""
    # class prototypes come from a FIXED rng so every seed samples the same
    # underlying task (train/val splits generalize across seeds)
    protos = np.random.default_rng(1234).standard_normal(
        (10, 8, 8, 3)).astype(np.float32)
    protos = np.kron(protos, np.ones((1, 4, 4, 1), dtype=np.float32))
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 10, size=n)
    x = protos[y] * 0.5
    x += rng.standard_normal((n, 32, 32, 3), dtype=np.float32) * 0.5
    return x.astype(np.float32), y.astype(np.int32)


class CIFAR10DataModule(DataModule):
    """Real CIFAR-10 when the binary batches exist under ``data_dir``
    (``data/vision.py``), synthetic otherwise; ``source`` reports which
    one backed this run."""

    def __init__(self, batch_size: int = 256, n_train: int = 50000,
                 n_val: int = 10000, seed: int = 0,
                 data_dir: Optional[str] = None):
        self.batch_size = batch_size
        self.n_train, self.n_val, self.seed = n_train, n_val, seed
        self.data_dir = data_dir
        self.source = "synthetic"
        self._train = self._val = None

    def setup(self, stage: str) -> None:
        if self._train is not None:
            return
        if self.data_dir is not None:
            from ..data import vision
            real = vision.load_cifar10(self.data_dir, "train")
            if real is not None:
                x, y = real
                test = vision.load_cifar10(self.data_dir, "test")
                if test is not None:
                    n_train = min(self.n_train, len(x))
                    tx, ty = test
                    self._val = (tx[:self.n_val], ty[:self.n_val])
                else:  # no test batch: hold out a tail of train for val
                    n_train = min(self.n_train, len(x) - 1)
                    self._val = (x[n_train:n_train + self.n_val],
                                 y[n_train:n_train + self.n_val])
                self._train = (x[:n_train], y[:n_train])
                self.source = "real"
                return
        x, y = synthetic_cifar10(self.n_train + self.n_val, self.seed)
        self._train = (x[:self.n_train], y[:self.n_train])
        self._val = (x[self.n_train:], y[self.n_train:])

    def train_dataloader(self):
        return DataLoader(ArrayDataset(*self._train),
                          batch_size=self.batch_size, shuffle=True)

    def val_dataloader(self):
        return DataLoader(ArrayDataset(*self._val),
                          batch_size=self.batch_size)

    def test_dataloader(self):
        return DataLoader(ArrayDataset(*self._val),
                          batch_size=self.batch_size)
