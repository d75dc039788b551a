"""Port parity for generation (models/transformer.py and
models/speculative.py of the PyTorch port) on the CPU: JAX-made weights
go through ``params_from_jax`` so both packages compute with identical
weights, and seeded numpy prompts go through both.  The whole-prompt
prefill's hidden state and cache are compared in f32; greedy, beam and
speculative decoding must give identical tokens, with dense, int8
weight-only (the JAX side routing its q8 decode projections through the
Pallas kernels in interpret mode) and grouped-query weights and with a
sliding window.  Sampling cannot reproduce jax.random's stream, so it is
held to what is deterministic: the filters' supports, greedy limits and
seed reproducibility."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_lightning_accelerators_tpu.models.speculative import (
    speculative_generate as jax_speculative_generate)
from ray_lightning_accelerators_tpu.models.transformer import (
    GPT as JaxGPT, TransformerConfig as JaxConfig, _rope as jax_rope,
    _rope_rows as jax_rope_rows)
from ray_lightning_accelerators_tpu_torch.models.speculative import (
    serve_speculative, speculative_generate)
from ray_lightning_accelerators_tpu_torch.models.transformer import (
    GPT, TransformerConfig, _rope, _rope_grid, _rope_rows)
from ray_lightning_accelerators_tpu_torch.serve import (
    RequestRejected, ServeEngine)
from ray_lightning_accelerators_tpu_torch.utils.weights import (
    params_from_jax)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CFG = dict(vocab_size=256, d_model=128, n_heads=2, d_ff=256, n_layers=2,
           max_seq_len=64)
# f32 on the CPU on both sides, different summation orders: hidden
# states and cache entries agree to ~2e-6 (tests/test_torch_transformer.py
# measures the same on the paged path); 2e-5 leaves 10x headroom.
ATOL = 2e-5


def _pair(seed=0, **cfg):
    """(JAX model, JAX params as numpy, port model, port params)."""
    jm = JaxGPT(JaxConfig(**{**CFG, **cfg}))
    jp = jax.device_get(jm.init_params(jax.random.PRNGKey(seed)))
    tm = GPT(TransformerConfig(**{**CFG, **cfg}), device="cpu")
    return jm, jp, tm, params_from_jax(jp, device="cpu")


@pytest.fixture(scope="module")
def dense():
    return _pair()


def _prompt(b, s, seed):
    return np.random.default_rng(seed).integers(
        0, CFG["vocab_size"], (b, s)).astype(np.int32)


def _jax_generate(jm, jp, prompt, n, q8=False, **kw):
    jm._force_q8_kernel = "interpret" if q8 else None
    try:
        return np.asarray(jm.generate(jp, jnp.asarray(prompt), n, **kw))
    finally:
        jm._force_q8_kernel = None


def test_rope_variants_match_jax_element_for_element():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 2, 6, 64)).astype(np.float32)
    pos = np.arange(3, 9, dtype=np.int32)
    got = _rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    ref = jax_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    rows = np.array([5, 17], np.int32)
    x1 = x[:, :, :1]
    got_r = _rope_rows(torch.from_numpy(x1), torch.from_numpy(rows), 1e4)
    ref_r = jax_rope_rows(jnp.asarray(x1), jnp.asarray(rows), 1e4)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(ref_r), rtol=1e-5,
                               atol=1e-5)
    # the three port variants agree exactly at equal positions
    grid = _rope_grid(torch.from_numpy(x1), torch.from_numpy(rows)[:, None],
                      1e4)
    assert torch.equal(grid, got_r)
    same = _rope_grid(torch.from_numpy(x), torch.from_numpy(
        np.broadcast_to(pos, (2, 6)).copy()), 10000.0)
    assert torch.equal(same, got)
    # bf16 in, bf16 out (the f32 angles promote, then cast back)
    assert _rope(torch.from_numpy(x).bfloat16(), torch.from_numpy(pos),
                 1e4).dtype == torch.bfloat16


@pytest.mark.parametrize("mode", ["linear", "rolling", "last_index"])
def test_prefill_matches_jax(dense, mode):
    jm, jp, tm, tp = dense
    prompt = _prompt(2, 12, seed=4)
    cache_len = {"linear": 20, "rolling": 5, "last_index": 12}[mode]
    last = np.array([7, 11], np.int32) if mode == "last_index" else None
    jh, jc = jm._prefill(jp, jnp.asarray(prompt), cache_len,
                         last_index=None if last is None
                         else jnp.asarray(last))
    th, tc = tm._prefill(tp, torch.from_numpy(prompt), cache_len,
                         last_index=None if last is None
                         else torch.from_numpy(last))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=ATOL)
    for name in ("k", "v"):
        assert tuple(tc[name].shape) == jc[name].shape
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   rtol=1e-5, atol=ATOL)


@pytest.mark.parametrize("weights", ["dense", "q8", "gqa"])
def test_greedy_generate_matches_jax(dense, weights):
    if weights == "gqa":
        jm, jp, tm, tp = _pair(n_kv_heads=1)
        assert tp["layers"]["attn"]["wk"].shape[2] == 1
    else:
        jm, jp, tm, tp = dense
    if weights == "q8":
        jp = jax.device_get(JaxGPT.quantize_weights(jp))
        tp = params_from_jax(jp, device="cpu")
    prompt = _prompt(2, 9, seed=6)
    ref = _jax_generate(jm, jp, prompt, 14, q8=weights == "q8")
    got = tm.generate(tp, torch.from_numpy(prompt), 14)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 23)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_sliding_window_generate_matches_jax():
    """The rolling cache (a 10-token prompt scattered to the ring slots
    p % 4 of a window-4 cache, then a ring decode that wraps five times),
    against the JAX package (tests/test_generation.py's deep-wrap case)."""
    jm, jp, tm, tp = _pair(sliding_window=4)
    prompt = _prompt(2, 10, seed=4)
    _, cache = tm._prefill(tp, torch.from_numpy(prompt), 4)
    assert cache["k"].shape[3] == 4
    np.testing.assert_array_equal(tm.generate(tp, prompt, 20).numpy(),
                                  _jax_generate(jm, jp, prompt, 20))


def test_sliding_window_prompt_shorter_than_window():
    """A prompt shorter than the window, decoded until the ring wraps:
    every token equals the greedy choice of a whole-sequence forward
    (the windowed flash attention over the full prefix)."""
    tm = GPT(TransformerConfig(**{**CFG, "sliding_window": 16}),
             device="cpu")
    tp = tm.init_params(seed=3)
    out = tm.generate(tp, _prompt(1, 4, seed=16), 24).long()
    for t in range(4, out.shape[1]):
        h, _ = tm._prefill(tp, out[:, :t], t)
        nxt = tm._unembed_matmul(h, tp, torch.float32).argmax(-1)
        assert int(nxt[0]) == int(out[0, t]), t


def test_repetition_penalty_greedy_matches_jax(dense):
    jm, jp, tm, tp = dense
    prompt = _prompt(2, 6, seed=8)
    np.testing.assert_array_equal(
        tm.generate(tp, prompt, 12, repetition_penalty=1.3).numpy(),
        _jax_generate(jm, jp, prompt, 12, repetition_penalty=1.3))
    # an extreme penalty forbids reuse: no generated token repeats
    gen = tm.generate(tp, prompt, 12, repetition_penalty=1e6).numpy()
    for row in gen[:, 6:]:
        assert len(set(row.tolist())) == len(row)


@pytest.mark.parametrize("beam", [1, 3])
def test_generate_beam_matches_jax(dense, beam):
    jm, jp, tm, tp = dense
    prompt = _prompt(1, 6, seed=10)
    ref = np.asarray(jm.generate_beam(jp, jnp.asarray(prompt), 8,
                                      beam_size=beam))
    got = tm.generate_beam(tp, prompt, 8, beam_size=beam)
    np.testing.assert_array_equal(got.numpy(), ref)
    if beam == 1:
        np.testing.assert_array_equal(got.numpy(),
                                      tm.generate(tp, prompt, 8).numpy())
    with pytest.raises(ValueError, match="batch size 1"):
        tm.generate_beam(tp, _prompt(2, 6, seed=10), 4)


def _allowed(logits, temperature, top_k, top_p):
    """The support of the JAX package's filtered distribution
    (transformer.py _sample), computed in numpy: a bool mask [B, V]."""
    lg = logits / temperature
    if top_k:
        kth = np.sort(lg, -1)[:, -top_k][:, None]
        lg = np.where(lg < kth, -1e30, lg)
    if top_p < 1.0:
        srt = np.sort(lg, -1)[:, ::-1]
        e = np.exp(srt - srt[:, :1])
        probs = e / e.sum(-1, keepdims=True)
        cum = np.cumsum(probs, -1) - probs
        idx = np.maximum((cum < top_p).sum(-1) - 1, 0)
        cutoff = np.take_along_axis(srt, idx[:, None], -1)
        lg = np.where(lg < cutoff, -1e30, lg)
    return lg > -1e29


@pytest.mark.parametrize("top_k,top_p", [(5, 1.0), (0, 0.6), (8, 0.8)])
def test_sample_stays_in_filtered_support(top_k, top_p):
    rng = np.random.default_rng(12)
    logits = rng.standard_normal((4, 64)).astype(np.float32)
    allowed = _allowed(logits, 0.7, top_k, top_p)
    assert (allowed.sum(-1) > 1).all()     # the filters keep a choice
    g = torch.Generator().manual_seed(0)
    draws = np.stack([GPT._sample(torch.from_numpy(logits), 0.7, top_k,
                                  top_p, g).numpy() for _ in range(200)])
    assert allowed[np.arange(4)[None], draws].all()
    assert all(len(set(draws[:, r])) > 1 for r in range(4))


def test_sampled_generate_limits_and_reproducibility(dense):
    jm, jp, tm, tp = dense
    prompt = _prompt(2, 5, seed=14)
    greedy = tm.generate(tp, prompt, 10).numpy()
    for kw in ({"top_k": 1}, {"top_p": 0.0}):
        np.testing.assert_array_equal(
            tm.generate(tp, prompt, 10, temperature=0.8, **kw).numpy(),
            greedy)

    def sampled(seed):
        return tm.generate(tp, prompt, 10, temperature=0.9, top_k=4,
                           generator=torch.Generator().manual_seed(seed)
                           ).numpy()

    a, b, c = sampled(7), sampled(7), sampled(8)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    # every sampled token lies in the top 4 of the JAX model's logits for
    # the prefix before it
    logits = np.asarray(jm.forward(jp, jnp.asarray(a)))
    allowed = _allowed(logits[:, 4:-1].reshape(-1, CFG["vocab_size"]),
                       0.9, 4, 1.0)
    assert allowed[np.arange(allowed.shape[0]), a[:, 5:].reshape(-1)].all()


@pytest.fixture(scope="module")
def draft():
    return _pair(seed=1, n_layers=1)


@pytest.mark.parametrize("draft_layers,k", [(1, 1), (1, 4), (2, 4)])
def test_speculative_generate_matches_greedy_and_jax(dense, draft,
                                                     draft_layers, k):
    jm, jp, tm, tp = dense
    if draft_layers == 2:        # the target drafts for itself
        jd, jdp, td, tdp = jm, jp, tm, tp
    else:
        jd, jdp, td, tdp = draft
    prompt = _prompt(1, 7, seed=16)
    got, stats = speculative_generate(tm, tp, td, tdp, prompt, 14, k=k)
    np.testing.assert_array_equal(got.numpy(),
                                  tm.generate(tp, prompt, 14).numpy())
    if draft_layers == 1 and k == 4:   # the JAX side compiles per call
        ref, jstats = jax_speculative_generate(jm, jp, jd, jdp,
                                               jnp.asarray(prompt), 14, k=k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        assert stats["rounds"] == jstats["rounds"]
        assert stats["accept_rate"] == pytest.approx(jstats["accept_rate"])
    if draft_layers == 2:
        # a self-draft is accepted wherever the budget lets the target
        # check it: every round but the last accepts all k drafts
        assert stats["accepted"] == stats["checked"]
        assert stats["rounds"] == -(-13 // k)


def test_speculative_rejects_batch_window_and_serving(dense):
    jm, jp, tm, tp = dense
    with pytest.raises(ValueError, match=r"\[1, prompt_len\]"):
        speculative_generate(tm, tp, tm, tp, _prompt(2, 4, 0), 4)
    swm = GPT(TransformerConfig(**{**CFG, "sliding_window": 8}),
              device="cpu")
    swp = swm.init_params(seed=0)
    with pytest.raises(NotImplementedError, match="sliding_window"):
        speculative_generate(swm, swp, tm, tp, _prompt(1, 4, 0), 4)
    # serving: an engine without a draft refuses the lane typed
    with pytest.raises(RequestRejected, match="draft model"):
        serve_speculative(ServeEngine(tm, tp, block_len=4),
                          _prompt(1, 4, 0)[0], 4)


def test_generation_budget_and_cache_bounds(dense):
    _, _, tm, tp = dense
    with pytest.raises(ValueError, match="max_seq_len"):
        tm.generate(tp, _prompt(1, 60, 0), 10)
    with pytest.raises(ValueError, match="max_new_tokens"):
        tm.generate(tp, _prompt(1, 4, 0), 0)
    # an out-of-range cache write raises instead of clamping (JAX's
    # dynamic_update_slice clamps)
    cache = tm.decode_cache_alloc(1, 8)
    with pytest.raises(IndexError, match="outside the cache"):
        tm._decode_chunk(tp, cache, torch.zeros(1, 3, dtype=torch.long), 6)
    with pytest.raises(IndexError, match="outside the cache"):
        tm.decode_step_rows(tp, cache, [0], [8])
    row = tm.decode_cache_alloc(1, 4)
    with pytest.raises(IndexError, match="does not fit"):
        GPT.cache_join(cache, row, 1)
