"""Data pipeline: datasets, the replica-sharded sampler, batching.

Port of the JAX package's ``data/loader.py``: batches are numpy pytrees
(dicts / tuples of arrays with a common leading batch dim) and the
trainer owns device placement.  The shuffle is the JAX package's
permutation, ``np.random.default_rng((seed, epoch))``, so a shuffled run
sees the same batches in the same order in both packages.

Over N data-parallel ranks the trainer injects ``ShardedSampler(
num_replicas=N, rank=r)`` into each rank's loader, and ``batch_size``
keeps the JAX package's meaning, the GLOBAL batch: rank r yields
``batch_size // N`` rows, and its batch k is ``order[kB + r : (k+1)B :
N]`` of the epoch's order, so the N ranks' batches k together are the
JAX package's batch k.  An ``IterableDataset`` (a stream, e.g.
``data/lm.py``'s ``StreamingLMDataset``) is dealt round robin, element i
to rank ``i % N``, in global blocks of ``batch_size`` elements, so every
rank yields the same number of batches.  The native batch engine is not
ported.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Iterator, Optional, Sequence

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
    """Deterministic disjoint index shards, one per replica: the epoch's
    order (permuted per ``set_epoch`` when ``shuffle``), wrap-padded to a
    multiple of ``num_replicas`` unless ``drop_last``, and every
    ``num_replicas``-th index from ``rank`` on."""

    def __init__(self, dataset_len: int, num_replicas: int = 1,
                 rank: int = 0, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0):
        if rank >= num_replicas:
            raise ValueError(f"rank {rank} >= num_replicas {num_replicas}")
        self.dataset_len = dataset_len
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        if drop_last:
            self.num_samples = dataset_len // num_replicas
        else:
            self.num_samples = math.ceil(dataset_len / num_replicas)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.num_samples

    def __iter__(self) -> Iterator[int]:
        if self.shuffle:
            order = np.random.default_rng(
                (self.seed, self.epoch)).permutation(self.dataset_len)
        else:
            order = np.arange(self.dataset_len)
        total = self.num_samples * self.num_replicas
        if total > len(order):  # pad by wrapping, like torch's sampler
            order = np.concatenate([order, order[:total - len(order)]])
        return iter(order[self.rank:total:self.num_replicas].tolist())


def rank_batch_size(batch_size: int, num_replicas: int) -> int:
    """The rows each of ``num_replicas`` ranks takes of a global batch."""
    if batch_size % num_replicas:
        raise ValueError(
            f"global batch dim {batch_size} not divisible by data-parallel "
            f"size {num_replicas}; adjust batch_size or the number of "
            f"workers")
    return batch_size // num_replicas


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
    tail dropped when ``drop_last``.  Under N ranks (``_inject_sampler``)
    each rank yields its ``batch_size // N`` rows of every global batch.
    A sampler the caller passed is left alone: it then decides what each
    rank reads, ``batch_size`` rows a batch."""

    def __init__(self, dataset: Any, batch_size: int = 32,
                 shuffle: bool = False,
                 sampler: Optional[ShardedSampler] = None,
                 drop_last: bool = True,
                 collate_fn: Callable[[Sequence[Any]], Any] = default_collate,
                 seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.collate_fn = collate_fn
        self.seed = seed
        self._iterable = isinstance(dataset, IterableDataset)
        self._user_set_sampler = sampler is not None
        self._shard = (1, 0)          # (num_replicas, rank)
        self._rank_batch = batch_size
        if self._iterable:
            if shuffle:
                raise ValueError(
                    "shuffle=True is undefined for an IterableDataset; "
                    "shuffle in the stream itself")
            if sampler is not None:
                raise ValueError("IterableDataset takes no sampler")
            self.sampler = None   # an IterableDataset is read in order
        else:
            self.sampler = sampler or ShardedSampler(
                len(dataset), shuffle=shuffle, drop_last=drop_last,
                seed=seed)

    def _inject_sampler(self, num_replicas: int, rank: int,
                        shuffle: bool) -> None:
        """Shard this loader for rank ``rank`` of ``num_replicas``."""
        if self._user_set_sampler:
            return
        self._rank_batch = rank_batch_size(self.batch_size, num_replicas)
        self._shard = (num_replicas, rank)
        if not self._iterable:
            self.sampler = ShardedSampler(
                len(self.dataset), num_replicas, rank, shuffle=shuffle,
                drop_last=self.drop_last, seed=self.seed)

    def set_epoch(self, epoch: int) -> None:
        if self.sampler is not None:
            self.sampler.set_epoch(epoch)
        elif hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self) -> int:
        if self.sampler is None:
            raise TypeError("an IterableDataset loader has no length")
        n = len(self.sampler)
        return n // self._rank_batch if self.drop_last else math.ceil(
            n / self._rank_batch)

    def _iter_stream(self) -> Iterator[Any]:
        """Batch boundaries align to global blocks of ``batch_size``
        elements, so every rank yields exactly one batch per complete
        block: per-rank batch counts are equal by construction (a rank
        with one extra step would hang the others' collectives).  The
        ragged tail block is dropped under several replicas for the same
        reason."""
        replicas, rank = self._shard
        block = replicas * self._rank_batch
        buf = []
        for i, example in enumerate(self.dataset):
            if i % replicas == rank:
                buf.append(example)
            if (i + 1) % block == 0:
                yield self.collate_fn(buf)
                buf = []
        if buf and not self.drop_last and replicas == 1:
            yield self.collate_fn(buf)

    def __iter__(self) -> Iterator[Any]:
        if self._iterable:
            yield from self._iter_stream()
            return
        buf = []
        for idx in self.sampler:
            buf.append(self.dataset[idx])
            if len(buf) == self._rank_batch:
                yield self.collate_fn(buf)
                buf = []
        if buf and not self.drop_last:
            yield self.collate_fn(buf)
