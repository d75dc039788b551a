"""Port parity for the language-model data path (``data/lm.py`` and the
streaming half of ``data/loader.py`` in the PyTorch port): the tokenizers,
the packers, ``lm_dataset``, ``StreamingLMDataset`` and the loader's
batches over an ``IterableDataset``, bit for bit against the JAX package
on the same text and document streams.  All numpy, on the CPU."""

import os

import numpy as np
import pytest

from ray_lightning_accelerators_tpu.data import lm as jlm
from ray_lightning_accelerators_tpu.data.loader import (
    DataLoader as JaxDataLoader)
from ray_lightning_accelerators_tpu_torch import DataLoader, Trainer
from ray_lightning_accelerators_tpu_torch.data import lm
from ray_lightning_accelerators_tpu_torch.models.transformer import (
    GPT, TransformerConfig)

CORPUS = os.path.join(os.path.dirname(__file__), "data", "text",
                      "corpus.txt")


@pytest.fixture(scope="module")
def text():
    # the first ~6 KB of the committed real-text corpus: BPE training is
    # quadratic-ish in pure Python, and this is enough for 300 merges
    with open(CORPUS, encoding="utf-8") as f:
        return f.read()[:6000]


def test_char_tokenizer_matches_jax():
    corpus = lm.synthetic_corpus(40, seed=3)
    assert corpus == jlm.synthetic_corpus(40, seed=3)
    ours, theirs = lm.CharTokenizer(corpus), jlm.CharTokenizer(corpus)
    assert ours.vocab_size == theirs.vocab_size
    assert ours.encode(corpus) == theirs.encode(corpus)
    assert ours.decode(ours.encode(corpus)) == corpus
    with pytest.raises(ValueError, match="not in vocabulary"):
        ours.encode("~")


def test_bpe_tokenizer_matches_jax(text):
    ours, theirs = lm.BPETokenizer(text, 300), jlm.BPETokenizer(text, 300)
    assert ours.merges == theirs.merges and len(ours.merges) == 300 - 258
    probe = text[1000:2500] + " ünïcödé"
    assert ours.encode(probe) == theirs.encode(probe)
    assert ours.decode(ours.encode(probe)) == probe
    with pytest.raises(ValueError, match="vocab_size"):
        lm.BPETokenizer(text, 100)


@pytest.mark.parametrize("kw", [dict(), dict(drop_remainder=False),
                                dict(eos_id=None), dict(
                                    drop_remainder=False, pad_id=7)])
def test_pack_sequences_matches_jax(kw):
    rng = np.random.default_rng(0)
    docs = [rng.integers(2, 90, rng.integers(1, 30)).tolist()
            for _ in range(13)]
    got = lm.pack_sequences(docs, 16, **kw)
    want = jlm.pack_sequences(docs, 16, **kw)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_lm_dataset_and_pack_stream_match_jax(text):
    tok = lm.BPETokenizer(text, 300)
    ds, _ = lm.lm_dataset(text, 64, tokenizer=tok)
    jds, _ = jlm.lm_dataset(text, 64, tokenizer=jlm.BPETokenizer(text, 300))
    np.testing.assert_array_equal(ds.arrays[0], jds.arrays[0])
    docs = [tok.encode(d) for d in text.split("\n\n") if d]
    rows = np.stack(list(lm.pack_stream(iter(docs), 64)))
    np.testing.assert_array_equal(rows, np.stack(list(
        jlm.pack_stream(iter(docs), 64))))
    np.testing.assert_array_equal(rows, ds.arrays[0])
    with pytest.raises(ValueError, match="too small"):
        lm.lm_dataset("ab", 64)


def _doc_factory(epoch):
    rng = np.random.default_rng(epoch)
    for _ in range(30):
        yield rng.integers(2, 60, size=rng.integers(5, 30)).tolist()


@pytest.mark.parametrize("drop_last", [True, False])
def test_streaming_loader_batches_match_jax(drop_last):
    """``StreamingLMDataset`` through each package's DataLoader, epoch by
    epoch (``set_epoch`` reaches the stream): the same batches, bitwise,
    the ragged tail kept only without ``drop_last``."""
    ours = DataLoader(lm.StreamingLMDataset(_doc_factory, seq_len=16),
                      batch_size=5, drop_last=drop_last)
    theirs = JaxDataLoader(jlm.StreamingLMDataset(_doc_factory, seq_len=16),
                           batch_size=5, drop_last=drop_last)
    epochs = []
    for epoch in range(3):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        a, b = list(ours), list(theirs)
        assert len(a) == len(b) > 1
        for x, y in zip(a, b):
            assert x.dtype == np.int32 and x.shape[1] == 16
            np.testing.assert_array_equal(x, y)
        assert (a[-1].shape[0] == 5) == (drop_last or a[-1].shape[0] == 5)
        epochs.append(np.concatenate(a))
    assert not np.array_equal(epochs[0][:5], epochs[1][:5])


def test_streaming_loader_has_no_length_and_no_shuffle():
    ds = lm.StreamingLMDataset(lambda e: iter([]), seq_len=8)
    loader = DataLoader(ds, batch_size=2)
    with pytest.raises(TypeError, match="no length"):
        len(loader)
    with pytest.raises(ValueError, match="shuffle"):
        DataLoader(ds, batch_size=2, shuffle=True)
    assert list(loader) == []


def test_pack_stream_holds_one_row_of_a_generator_document():
    def one_huge_doc():
        yield (x % 250 + 2 for x in range(10_000))

    rows = list(lm.pack_stream(one_huge_doc(), seq_len=128, eos_id=None))
    assert len(rows) == 10_000 // 128
    assert rows[0][0] == 2 and rows[1][0] == (128 % 250) + 2


def test_streaming_dataset_trains_through_the_trainer(tmp_path):
    """A document stream -> StreamingLMDataset -> DataLoader ->
    ``Trainer.fit(GPT)`` on the CPU: two epochs of batches, the loss
    falling from the first epoch's to the second's."""
    def factory(epoch):
        for i in range(24):
            yield [(i + t) % 60 + 2 for t in range(40)]

    loader = DataLoader(lm.StreamingLMDataset(factory, seq_len=32),
                        batch_size=4)
    model = GPT(TransformerConfig(vocab_size=64, d_model=32, n_heads=2,
                                  d_ff=64, n_layers=1, max_seq_len=32),
                device="cpu", lr=1e-2)
    trainer = Trainer(device="cpu", precision="f32", max_epochs=2,
                      log_every_n_steps=1, enable_checkpointing=False,
                      default_root_dir=str(tmp_path))
    trainer.fit(model, loader)
    losses = [r["train_loss"] for r in trainer.logger.history
              if "train_loss" in r]
    per_epoch = len(losses) // 2
    assert per_epoch == 24 * 41 // 32 // 4
    assert np.mean(losses[per_epoch:]) < np.mean(losses[:per_epoch])
