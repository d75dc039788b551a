"""The PyTorch port's paged serve engine (serve/ of the port): the block
allocator and admission math mirror tests/test_paged_serve.py, and the
engine is held to the JAX package's ServeEngine on the same weights and
the same seeded, staggered requests -- greedy tokens identical, through a
prefix hit, block growth and a prompt streamed in more than one chunk.
All on the CPU (``device="cpu"``: the kernels' plain versions)."""

import threading
import time

import numpy as np
import pytest
import torch

import jax

from ray_lightning_accelerators_tpu.models.transformer import (
    GPT as JaxGPT, TransformerConfig as JaxConfig)
from ray_lightning_accelerators_tpu.serve import ServeEngine as JaxEngine
from ray_lightning_accelerators_tpu_torch.models.transformer import (
    GPT, TransformerConfig)
from ray_lightning_accelerators_tpu_torch.runtime.guardian import (
    NumericAnomaly)
from ray_lightning_accelerators_tpu_torch.serve import (
    BlockAllocator, PoolExhausted, QueueFull, RequestRejected,
    ServeCancelled, ServeEngine, blocks_for_request, chain_prefix_keys)
from ray_lightning_accelerators_tpu_torch.utils.weights import (
    params_from_jax)

pytestmark = [pytest.mark.serve, pytest.mark.paged]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CFG = dict(vocab_size=256, d_model=128, n_heads=2, d_ff=256, n_layers=2,
           max_seq_len=64)


@pytest.fixture(scope="module")
def weights():
    jm = JaxGPT(JaxConfig(**CFG))
    return jm, jax.device_get(jm.init_params(jax.random.PRNGKey(1)))


def _port(weights, **cfg):
    _, jp = weights
    model = GPT(TransformerConfig(**{**CFG, **cfg}), device="cpu")
    return model, params_from_jax(jp, device="cpu")


# --------------------------------------------------------------------- #
# BlockAllocator and admission math (tests/test_paged_serve.py:44-105)  #
# --------------------------------------------------------------------- #
def test_block_allocator_alloc_release_refcount():
    a = BlockAllocator(n_blocks=6, block_len=4)  # 5 usable (0 reserved)
    got = a.alloc(3)
    assert len(got) == 3 and 0 not in got
    assert a.stats() == {"total": 5, "used": 3, "cached": 0, "free": 2}
    assert a.alloc(3) is None                    # nothing evictable
    assert a.stats()["free"] == 2
    for b in got:
        a.release(b)
    assert a.stats() == {"total": 5, "used": 0, "cached": 0, "free": 5}
    assert len(a.alloc(5)) == 5


def test_block_allocator_prefix_sharing_and_lru_eviction():
    a = BlockAllocator(n_blocks=5, block_len=4)   # 4 usable
    b1, b2 = a.alloc(2)
    a.register("k1", b1)
    a.register("k2", b2)
    assert a.lookup_run(["k1", "k2", "k-miss"], max_blocks=8) == [b1, b2]
    assert a.stats()["used"] == 2
    a.release(b1), a.release(b2)                  # owner: sharer holds on
    assert a.stats()["used"] == 2
    a.release(b1), a.release(b2)                  # registered -> cached
    assert a.stats() == {"total": 4, "used": 0, "cached": 2, "free": 2}
    got = a.alloc(3)                              # evicts the LRU block
    assert len(got) == 3
    st = a.stats()
    assert st["cached"] == 1 and st["used"] == 3
    hits = a.lookup_run(["k1"], max_blocks=8)
    rem = a.lookup_run(["k2"], max_blocks=8)
    assert (len(hits), len(rem)) in ((0, 1), (1, 0))
    assert a.alloc(2) is None                     # referenced: never evicted


def test_block_allocator_first_registration_wins():
    a = BlockAllocator(n_blocks=5, block_len=4)
    b1, b2 = a.alloc(2)
    assert a.register("k", b1) is True
    assert a.register("k", b2) is False
    assert a.lookup_run(["k"], 8) == [b1]


@pytest.mark.parametrize("args,want", [((3, 1, 4), 1), ((4, 1, 4), 1),
                                       ((4, 2, 4), 2), ((3, 6, 4), 2),
                                       ((3, 7, 4), 3), ((3, 6, 4, 4), 3)])
def test_blocks_for_request_math(args, want):
    from ray_lightning_accelerators_tpu.serve import (
        blocks_for_request as jax_blocks)
    assert blocks_for_request(*args) == want == jax_blocks(*args)


def test_chain_prefix_keys_match_jax():
    from ray_lightning_accelerators_tpu.serve.batcher import (
        chain_prefix_keys as jax_keys)
    p = np.random.default_rng(0).integers(0, 256, 37).astype(np.int32)
    assert chain_prefix_keys(p, 8) == jax_keys(p, 8)
    assert len(chain_prefix_keys(p, 8)) == 4
    assert chain_prefix_keys(p, 8, limit=2) == jax_keys(p, 8, limit=2)


# --------------------------------------------------------------------- #
# Engine against the JAX engine                                         #
# --------------------------------------------------------------------- #
def _workload():
    rng = np.random.default_rng(11)
    sysp = rng.integers(0, 256, 12).astype(np.int32)     # 3 full blocks
    first = (np.concatenate([sysp, rng.integers(0, 256, 3).astype(
        np.int32)]), 6)
    wave = [
        (np.concatenate([sysp, rng.integers(0, 256, 2).astype(np.int32)]),
         9),                                             # prefix hit
        (rng.integers(0, 256, 5).astype(np.int32), 11),  # grows 2 blocks
        (rng.integers(0, 256, 21).astype(np.int32), 7),  # 3 chunks of 8
        (rng.integers(0, 256, 3).astype(np.int32), 1),   # done at prefill
        (np.concatenate([sysp, rng.integers(0, 256, 6).astype(np.int32)]),
         8),                                             # prefix hit
        (rng.integers(0, 256, 7).astype(np.int32), 10),
    ]
    return first, wave


def _serve(engine_cls, model, params, first, wave):
    """Same traffic on either engine: one request seeds the prefix index,
    then a staggered wave over 3 slots."""
    with engine_cls(model, params, max_slots=3, queue_depth=16,
                    block_len=4) as eng:
        outs = [eng.submit(*first).result(timeout=300)]
        resps = []
        for i, (p, n) in enumerate(wave):
            resps.append(eng.submit(p, n))
            if i % 2 == 1:
                time.sleep(0.02)
        outs += [r.result(timeout=300) for r in resps]
    return outs, eng.stats()


@pytest.mark.parametrize("kind", ["dense", "q8"])
def test_engine_tokens_match_jax_engine(weights, monkeypatch, kind):
    """Greedy tokens identical to the JAX engine's on the same f32 weights
    (dense, or int8 weight-only: the JAX engine's dequantized products
    against the port's plain int8 products, equal up to f32 rounding).
    RLA_TPU_SERVE_CHUNK_BLOCKS=2 (8 tokens at block_len 4) makes the
    21-token prompt stream in through chunked prefill on both engines."""
    monkeypatch.setenv("RLA_TPU_SERVE_CHUNK_BLOCKS", "2")
    jm, jp = weights
    if kind == "q8":
        jp = jax.device_get(JaxGPT.quantize_weights(jp))
    model = GPT(TransformerConfig(**CFG), device="cpu")
    params = params_from_jax(jp, device="cpu")
    first, wave = _workload()
    jouts, jstats = _serve(JaxEngine, jm, jp, first, wave)
    touts, tstats = _serve(ServeEngine, model, params, first, wave)
    assert len(touts) == len(jouts) == len(wave) + 1
    for t, j, (p, n) in zip(touts, jouts, [first] + wave):
        assert t.dtype == np.int32 and t.shape == (p.size + n,)
        np.testing.assert_array_equal(t, np.asarray(j))
    for st in (tstats, jstats):
        assert st["completed"] == len(wave) + 1
        assert st["prefix_hits"] >= 2
        assert st["steps_batch_gt1"] >= 1
        assert st["longest_prefill_tokens"] == 21
        # the 21-token prompt alone takes >= 2 chunk calls
        assert st["prefill_chunks"] >= len(wave) + 2
    assert tstats["prefix_hit_blocks"] == jstats["prefix_hit_blocks"]
    assert tstats["block_pool_used"] == 0       # every block came back
    assert tstats["peak_concurrent"] >= 2


def test_engine_rejects_and_backpressures_typed(weights):
    model, params = _port(weights)
    eng = ServeEngine(model, params, max_slots=2, queue_depth=8,
                      max_total_len=32, block_len=8, n_blocks=5)
    try:
        with pytest.raises(RequestRejected, match="max_seq_len"):
            eng.submit(np.arange(60, dtype=np.int32), 10)
        with pytest.raises(RequestRejected, match="empty prompt"):
            eng.submit(np.zeros((0,), np.int32), 3)
        r1 = eng.submit(np.asarray([1, 2, 3], np.int32), 10)  # 2 blocks
        r2 = eng.submit(np.asarray([4, 5], np.int32), 12)     # 2 blocks
        with pytest.raises(PoolExhausted) as ei:
            eng.submit(np.asarray([6], np.int32), 10)         # +2 > 4
        assert ei.value.needed == 2 and ei.value.total == 4
        assert isinstance(ei.value, QueueFull)
        assert eng.stats()["pool_exhausted"] == 1
        eng.start()
        assert r1.result(timeout=300).shape == (13,)
        assert r2.result(timeout=300).shape == (14,)
    finally:
        eng.stop()
    assert eng.stats()["rejected"] == 3


def test_engine_stop_joins_daemon_thread_and_cancels_queue(weights):
    model, params = _port(weights)
    eng = ServeEngine(model, params, max_slots=1, queue_depth=8,
                      block_len=4)
    queued = [eng.submit(np.asarray([1, 2, 3], np.int32), 4)
              for _ in range(3)]
    eng.start()
    thread = eng._thread
    assert thread.daemon
    eng.stop(cancel_active=True)
    assert not thread.is_alive() and eng._thread is None
    for r in queued:
        exc = r.exception(timeout=60)
        assert exc is None or isinstance(exc, ServeCancelled)
    assert not any(t.name == "rla-torch-serve-engine"
                   for t in threading.enumerate())


def test_decode_guard_fails_nonfinite_rows_typed(weights):
    """Non-finite decode logits fail that request with NumericAnomaly
    (the JAX engine's per-slot finite guard)."""
    model, params = _port(weights)
    params["ln_f"] = torch.full_like(params["ln_f"], float("nan"))
    with ServeEngine(model, params, max_slots=2, block_len=4) as eng:
        r = eng.submit(np.asarray([1, 2, 3], np.int32), 5)
        with pytest.raises(NumericAnomaly, match="non-finite"):
            r.result(timeout=300)
    st = eng.stats()
    assert st["numeric_anomalies"] == 1 and st["failed"] == 1
    assert st["block_pool_used"] == 0


@pytest.mark.parametrize("kwargs,match", [
    ({"paged": False}, "paged=False"),
    ({"draft_model": object()}, "speculative lane"),
    ({"slo": object()}, "SLO engine"),
    ({"perf_timeline": object()}, "perf_timeline"),
])
def test_engine_later_slices_raise(weights, kwargs, match):
    model, params = _port(weights)
    with pytest.raises(NotImplementedError, match=match):
        ServeEngine(model, params, **kwargs)


def test_engine_speculative_and_handoff_raise(weights):
    model, params = _port(weights)
    eng = ServeEngine(model, params, block_len=4)
    with pytest.raises(NotImplementedError, match="speculative"):
        eng.submit(np.asarray([1, 2], np.int32), 3, speculative=True)
    with pytest.raises(NotImplementedError, match="KV handoff"):
        eng.submit_handoff(np.asarray([1, 2], np.int32), 3)
    with pytest.raises(NotImplementedError, match="KV handoff"):
        eng.submit_import({})
