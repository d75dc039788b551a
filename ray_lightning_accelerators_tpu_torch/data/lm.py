"""Language-model data: tokenizers and sequence packing.

The port's own copy of the JAX package's ``data/lm.py`` (numpy only, the
same arithmetic, so both packages make the same token rows bit for bit):
``CharTokenizer`` and the byte-level ``BPETokenizer`` (ids 0 / 1 are pad
/ end-of-text), ``pack_sequences`` (documents joined with an end-of-text
separator and cut into fixed ``[N, seq_len]`` rows), ``lm_dataset`` (a
corpus split on blank lines into an ``ArrayDataset`` of packed rows),
``pack_stream`` and ``StreamingLMDataset`` (the same rows from a
document stream, holding at most one partial row) and
``synthetic_corpus``.  Fixed-length rows keep every training step one
shape, with no padding wasted on short documents.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Iterator, List, Optional, \
    Sequence

import numpy as np

from .loader import ArrayDataset, IterableDataset


class CharTokenizer:
    """Character-level tokenizer with a corpus-derived vocabulary.

    Deterministic (sorted vocab), dependency-free, reversible.  Reserves
    id 0 for padding and id 1 for end-of-text.
    """

    PAD_ID = 0
    EOS_ID = 1

    def __init__(self, corpus: str):
        chars = sorted(set(corpus))
        self._to_id: Dict[str, int] = {c: i + 2 for i, c in enumerate(chars)}
        self._to_char: Dict[int, str] = {i: c for c, i in self._to_id.items()}

    @property
    def vocab_size(self) -> int:
        return len(self._to_id) + 2

    def encode(self, text: str) -> List[int]:
        try:
            return [self._to_id[c] for c in text]
        except KeyError as e:
            raise ValueError(f"character {e.args[0]!r} not in vocabulary")

    def decode(self, ids: Sequence[int]) -> str:
        return "".join(self._to_char.get(int(i), "") for i in ids)


class BPETokenizer:
    """Byte-level byte-pair encoding, trained on a corpus; no external
    dependencies.

    Ids 0/1 reserved for pad/eos (shared convention with CharTokenizer);
    base ids 2..257 are the 256 byte values; merges extend upward.  Any
    input text round-trips exactly (byte fallback), unlike CharTokenizer
    which rejects unseen characters.
    """

    PAD_ID = 0
    EOS_ID = 1
    _BASE = 2

    def __init__(self, corpus: str, vocab_size: int = 512):
        if vocab_size < self._BASE + 256:
            raise ValueError(f"vocab_size must be >= {self._BASE + 256}")
        self.merges: Dict[tuple, int] = {}  # (id, id) -> merged id
        data = list(corpus.encode("utf-8"))
        ids = [b + self._BASE for b in data]
        next_id = self._BASE + 256
        while next_id < vocab_size:
            counts: Dict[tuple, int] = {}
            for a, b in zip(ids, ids[1:]):
                counts[(a, b)] = counts.get((a, b), 0) + 1
            if not counts:
                break
            pair = max(counts, key=counts.get)
            if counts[pair] < 2:
                break  # nothing left worth merging
            self.merges[pair] = next_id
            ids = self._merge(ids, pair, next_id)
            next_id += 1
        self.vocab_size = vocab_size
        # decode table: id -> bytes
        self._bytes: Dict[int, bytes] = {
            b + self._BASE: bytes([b]) for b in range(256)}
        for (a, b), m in self.merges.items():
            self._bytes[m] = self._bytes[a] + self._bytes[b]

    @staticmethod
    def _merge(ids: List[int], pair: tuple, new_id: int) -> List[int]:
        out, i = [], 0
        while i < len(ids):
            if i + 1 < len(ids) and (ids[i], ids[i + 1]) == pair:
                out.append(new_id)
                i += 2
            else:
                out.append(ids[i])
                i += 1
        return out

    def encode(self, text: str) -> List[int]:
        ids = [b + self._BASE for b in text.encode("utf-8")]
        # apply merges in training order (ranks): repeatedly merge the
        # lowest-rank pair present
        while len(ids) >= 2:
            ranked = [(self.merges[p], p) for p in zip(ids, ids[1:])
                      if p in self.merges]
            if not ranked:
                break
            _, pair = min(ranked)
            ids = self._merge(ids, pair, self.merges[pair])
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        chunks = [self._bytes.get(int(i), b"") for i in ids]
        return b"".join(chunks).decode("utf-8", errors="replace")


def pack_sequences(docs: Sequence[Sequence[int]], seq_len: int,
                   eos_id: Optional[int] = CharTokenizer.EOS_ID,
                   drop_remainder: bool = True,
                   pad_id: int = CharTokenizer.PAD_ID) -> np.ndarray:
    """Concatenate token documents (with an ``eos_id`` separator after each
    unless None) and slice into fixed [N, seq_len] rows.

    ``drop_remainder=False`` pads the final partial row with ``pad_id``
    (mask pad targets downstream; ops/losses.py treats negative targets as
    masked, so shift-pad accordingly).  Packing wastes no tokens on
    per-document padding.
    """
    stream: List[int] = []
    for d in docs:
        stream.extend(int(t) for t in d)
        if eos_id is not None:
            stream.append(eos_id)
    n_full = len(stream) // seq_len
    if drop_remainder or len(stream) % seq_len == 0:
        arr = np.asarray(stream[:n_full * seq_len], np.int32)
        return arr.reshape(n_full, seq_len)
    pad = (n_full + 1) * seq_len - len(stream)
    arr = np.asarray(stream + [pad_id] * pad, np.int32)
    return arr.reshape(n_full + 1, seq_len)


def lm_dataset(text: str, seq_len: int,
               tokenizer: Optional[CharTokenizer] = None):
    """(ArrayDataset of packed [N, seq_len] rows, tokenizer) for a corpus.

    Documents are split on blank lines; each gets an EOS separator.
    """
    tokenizer = tokenizer or CharTokenizer(text)
    docs = [tokenizer.encode(d) for d in text.split("\n\n") if d]
    packed = pack_sequences(docs, seq_len)
    if not len(packed):
        raise ValueError(
            f"corpus too small for even one row of seq_len={seq_len}")
    return ArrayDataset(packed), tokenizer


def pack_stream(docs: Iterable[Sequence[int]], seq_len: int,
                eos_id: Optional[int] = CharTokenizer.EOS_ID
                ) -> Iterator[np.ndarray]:
    """Streaming packer: yields [seq_len] int32 rows as tokens arrive,
    holding at most one partial row — O(seq_len) memory even when a single
    document is itself huge (tokens drain into rows chunk by chunk rather
    than absorbing the whole document first).  The trailing remainder is
    dropped, as in pack_sequences(drop_remainder=True)."""
    buf: List[int] = []

    def drain(tokens) -> Iterator[np.ndarray]:
        for t in tokens:
            buf.append(int(t))
            if len(buf) == seq_len:
                yield np.asarray(buf, np.int32)
                buf.clear()

    for d in docs:
        yield from drain(d)
        if eos_id is not None:
            yield from drain((eos_id,))


class StreamingLMDataset(IterableDataset):
    """Pack an unbounded document stream into fixed rows on the fly.

    ``doc_factory`` is called once per epoch (with the epoch number) and
    must return an iterable of token sequences, e.g. a generator reading
    shards off disk.  Memory stays O(seq_len) whatever the corpus size.
    """

    def __init__(self, doc_factory: Callable[[int], Iterable[Sequence[int]]],
                 seq_len: int,
                 eos_id: Optional[int] = CharTokenizer.EOS_ID):
        self.doc_factory = doc_factory
        self.seq_len = seq_len
        self.eos_id = eos_id
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __iter__(self) -> Iterator[np.ndarray]:
        return pack_stream(self.doc_factory(self._epoch), self.seq_len,
                           self.eos_id)


def synthetic_corpus(n_sentences: int = 200, seed: int = 0) -> str:
    """Tiny grammar-driven corpus with learnable structure (for examples,
    tests, and benches — no downloads in this environment)."""
    rng = np.random.default_rng(seed)
    subjects = ["the pod", "a chip", "the mesh", "an actor", "the trainer",
                "a worker"]
    verbs = ["shards", "compiles", "reduces", "gathers", "schedules",
             "restores"]
    objects = ["the batch", "every gradient", "a checkpoint", "the ring",
               "its state", "the queue"]
    sents = []
    for _ in range(n_sentences):
        s = (f"{subjects[rng.integers(len(subjects))]} "
             f"{verbs[rng.integers(len(verbs))]} "
             f"{objects[rng.integers(len(objects))]}.")
        sents.append(s)
    # paragraphs of ~5 sentences = documents for the packer
    paras = [" ".join(sents[i:i + 5]) for i in range(0, len(sents), 5)]
    return "\n\n".join(paras)
