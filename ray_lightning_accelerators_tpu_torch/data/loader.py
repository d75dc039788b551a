"""Data pipeline: datasets, the sampler, batching.

Port of the JAX package's ``data/loader.py`` for one process: batches are
numpy pytrees (dicts / tuples of arrays with a common leading batch dim)
and the trainer owns device placement.  The shuffle is the JAX package's
permutation, ``np.random.default_rng((seed, epoch))``, so a shuffled run
sees the same batches in the same order in both packages.  An
``IterableDataset`` (a stream, e.g. ``data/lm.py``'s
``StreamingLMDataset``) is batched as it arrives, in stream order.
Sharding over replicas (the sampler's and the stream's round robin)
comes with the multi-GPU slice; the native batch engine is not ported.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Iterator, Sequence

import numpy as np


class Dataset:
    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, idx: int) -> Any:
        raise NotImplementedError


class IterableDataset:
    """Stream-style dataset: yields examples, with no length and no random
    access (corpora that do not fit in memory).  Optional hook:
    ``set_epoch(epoch)`` for epoch-varying streams."""

    def __iter__(self) -> Iterator[Any]:
        raise NotImplementedError


class RandomDataset(Dataset):
    """Fixed random-tensor dataset (standard normal, from ``seed``)."""

    def __init__(self, size: int, length: int, seed: int = 0):
        self.length = length
        self.data = np.random.default_rng(seed).standard_normal(
            (length, size), dtype=np.float32)

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, idx: int):
        return self.data[idx]


class ArrayDataset(Dataset):
    """Zips equal-length arrays into (a[i], b[i], ...) examples."""

    def __init__(self, *arrays: np.ndarray):
        if not arrays or any(len(a) != len(arrays[0]) for a in arrays):
            raise ValueError("ArrayDataset needs one or more arrays of equal "
                             "length")
        self.arrays = tuple(np.asarray(a) for a in arrays)

    def __len__(self) -> int:
        return len(self.arrays[0])

    def __getitem__(self, idx: int):
        items = tuple(a[idx] for a in self.arrays)
        return items if len(items) > 1 else items[0]


class ShardedSampler:
    """Deterministic index order for one replica: the whole dataset,
    permuted per epoch when ``shuffle`` (``set_epoch``)."""

    def __init__(self, dataset_len: int, shuffle: bool = True,
                 seed: int = 0):
        self.dataset_len = dataset_len
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.dataset_len

    def __iter__(self) -> Iterator[int]:
        if self.shuffle:
            order = np.random.default_rng(
                (self.seed, self.epoch)).permutation(self.dataset_len)
        else:
            order = np.arange(self.dataset_len)
        return iter(order.tolist())


def default_collate(samples: Sequence[Any]) -> Any:
    """Stack a list of example pytrees into one batch pytree of arrays."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: default_collate([s[k] for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(default_collate(col) for col in zip(*samples))
    return np.stack([np.asarray(s) for s in samples])


class DataLoader:
    """Minimal numpy dataloader: ``batch_size`` examples per batch in the
    sampler's order (an ``IterableDataset``: in stream order), the ragged
    tail dropped when ``drop_last``."""

    def __init__(self, dataset: Any, batch_size: int = 32,
                 shuffle: bool = False, drop_last: bool = True,
                 collate_fn: Callable[[Sequence[Any]], Any] = default_collate,
                 seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.collate_fn = collate_fn
        self.seed = seed
        self.sampler = None     # an IterableDataset is read in order
        if not isinstance(dataset, IterableDataset):
            self.sampler = ShardedSampler(len(dataset), shuffle=shuffle,
                                          seed=seed)
        elif shuffle:
            raise ValueError(
                "shuffle=True is undefined for an IterableDataset; "
                "shuffle in the stream itself")

    def set_epoch(self, epoch: int) -> None:
        if self.sampler is not None:
            self.sampler.set_epoch(epoch)
        elif hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self) -> int:
        if self.sampler is None:
            raise TypeError("an IterableDataset loader has no length")
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else math.ceil(
            n / self.batch_size)

    def __iter__(self) -> Iterator[Any]:
        source = iter(self.dataset) if self.sampler is None else (
            self.dataset[idx] for idx in self.sampler)
        buf = []
        for example in source:
            buf.append(example)
            if len(buf) == self.batch_size:
                yield self.collate_fn(buf)
                buf = []
        if buf and not self.drop_last:
            yield self.collate_fn(buf)
