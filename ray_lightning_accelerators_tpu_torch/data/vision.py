"""Vision datasets on disk: MNIST IDX and CIFAR-10 binary parsers.

Port of the JAX package's ``data/vision.py``, numpy only and line for
line, so both packages read the same files into the same arrays.  The
parsers read the standard formats directly when the files are present
(no torchvision, no downloads); the data modules fall back to
shape-identical synthetic data otherwise (``models/mnist.py``,
``models/resnet.py``).

Formats:

- **MNIST IDX**: big-endian magic 0x00000803 (images, [n, 28, 28] u8) /
  0x00000801 (labels, [n] u8), optionally ``.gz``-compressed.  Standard
  names: ``train-images-idx3-ubyte``, ``train-labels-idx1-ubyte``,
  ``t10k-images-idx3-ubyte``, ``t10k-labels-idx1-ubyte`` (also the
  ``.idx3-ubyte`` dotted variants), directly under the data directory or
  under ``MNIST/raw``.
- **CIFAR-10 binary**: ``data_batch_{1..5}.bin`` + ``test_batch.bin``,
  3073-byte records (1 label byte + 3072 RGB bytes, channel-major 32x32),
  possibly under a ``cifar-10-batches-bin/`` subdirectory.

Both loaders return float32 images scaled to [0, 1] (NHWC for CIFAR) and
int32 labels, the dtypes the models' forward paths expect.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Optional, Tuple

import numpy as np

Arrays = Tuple[np.ndarray, np.ndarray]

_IDX_IMAGES_MAGIC = 0x00000803
_IDX_LABELS_MAGIC = 0x00000801


def _open_maybe_gz(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def _find(data_dir: str, stem: str) -> Optional[str]:
    """Locate ``stem`` under data_dir, tolerating the dotted IDX naming and
    gzip: train-images-idx3-ubyte / train-images.idx3-ubyte / +.gz."""
    candidates = [stem, stem.replace("-idx", ".idx")]
    candidates += [c + ".gz" for c in candidates]
    for sub in ("", "MNIST/raw"):
        for c in candidates:
            p = os.path.join(data_dir, sub, c)
            if os.path.exists(p):
                return p
    return None


def read_idx_images(path: str) -> np.ndarray:
    """Parse an IDX3 image file -> float32 [n, rows, cols] in [0, 1]."""
    with _open_maybe_gz(path) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != _IDX_IMAGES_MAGIC:
            raise ValueError(
                f"{path}: bad IDX image magic 0x{magic:08x} "
                f"(want 0x{_IDX_IMAGES_MAGIC:08x})")
        buf = f.read(n * rows * cols)
    if len(buf) != n * rows * cols:
        raise ValueError(f"{path}: truncated ({len(buf)} bytes for "
                         f"{n}x{rows}x{cols})")
    x = np.frombuffer(buf, dtype=np.uint8).reshape(n, rows, cols)
    return x.astype(np.float32) / 255.0


def read_idx_labels(path: str) -> np.ndarray:
    """Parse an IDX1 label file -> int32 [n]."""
    with _open_maybe_gz(path) as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != _IDX_LABELS_MAGIC:
            raise ValueError(
                f"{path}: bad IDX label magic 0x{magic:08x} "
                f"(want 0x{_IDX_LABELS_MAGIC:08x})")
        buf = f.read(n)
    if len(buf) != n:
        raise ValueError(f"{path}: truncated ({len(buf)} bytes for {n})")
    return np.frombuffer(buf, dtype=np.uint8).astype(np.int32)


def load_mnist(data_dir: str, split: str = "train") -> Optional[Arrays]:
    """(images [n,28,28] f32, labels [n] i32) or None when files absent.
    ``split``: "train" or "test" (the t10k files)."""
    stem = "train" if split == "train" else "t10k"
    xp = _find(data_dir, f"{stem}-images-idx3-ubyte")
    yp = _find(data_dir, f"{stem}-labels-idx1-ubyte")
    if xp is None or yp is None:
        return None
    x, y = read_idx_images(xp), read_idx_labels(yp)
    if len(x) != len(y):
        raise ValueError(f"MNIST {split}: {len(x)} images vs {len(y)} labels")
    return x, y


# --------------------------------------------------------------------- #
# CIFAR-10 binary                                                        #
# --------------------------------------------------------------------- #
_CIFAR_RECORD = 1 + 32 * 32 * 3


def read_cifar_batch(path: str) -> Arrays:
    """One CIFAR-10 .bin batch -> (f32 NHWC [n,32,32,3] in [0,1], i32 [n])."""
    raw = np.fromfile(path, dtype=np.uint8)
    if raw.size % _CIFAR_RECORD:
        raise ValueError(f"{path}: size {raw.size} is not a multiple of the "
                         f"{_CIFAR_RECORD}-byte CIFAR-10 record")
    rec = raw.reshape(-1, _CIFAR_RECORD)
    y = rec[:, 0].astype(np.int32)
    # stored channel-major [3, 32, 32]; the models are NHWC end-to-end
    x = rec[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return np.ascontiguousarray(x).astype(np.float32) / 255.0, y


def _cifar_dir(data_dir: str) -> Optional[str]:
    for sub in ("", "cifar-10-batches-bin"):
        d = os.path.join(data_dir, sub)
        if os.path.exists(os.path.join(d, "data_batch_1.bin")):
            return d
    return None


def load_cifar10(data_dir: str, split: str = "train") -> Optional[Arrays]:
    """(images NHWC f32, labels i32) or None when the binaries are absent."""
    d = _cifar_dir(data_dir)
    if d is None:
        return None
    if split == "train":
        parts = [read_cifar_batch(os.path.join(d, f"data_batch_{i}.bin"))
                 for i in range(1, 6)
                 if os.path.exists(os.path.join(d, f"data_batch_{i}.bin"))]
        if not parts:
            return None
        xs, ys = zip(*parts)
        return np.concatenate(xs), np.concatenate(ys)
    test = os.path.join(d, "test_batch.bin")
    if not os.path.exists(test):
        return None
    return read_cifar_batch(test)
