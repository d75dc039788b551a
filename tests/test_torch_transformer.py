"""Port parity for the GPT serving half (models/transformer.py of the
PyTorch port): weights made by the JAX package go through
``params_from_jax`` so both packages compute with identical weights, and
the paged decode functions' logits and pool contents are compared in f32
on the CPU, with dense and with int8 weight-only parameters (the JAX side
routing its q8 projections through the Pallas kernels in interpret mode,
as tests/test_quant.py does)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_lightning_accelerators_tpu.models.transformer import (
    GPT as JaxGPT, TransformerConfig as JaxConfig, _rope_grid as jax_rope)
from ray_lightning_accelerators_tpu_torch.models.transformer import (
    GPT, TransformerConfig, _rope_grid)
from ray_lightning_accelerators_tpu_torch.utils.weights import (
    params_from_jax)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# 2 layers at widths the JAX int8 kernels' supported() accepts (K, N
# multiples of 128), so their interpret path really runs
CFG = dict(vocab_size=256, d_model=128, n_heads=2, d_ff=256, n_layers=2,
           max_seq_len=64)
# f32 on the CPU on both sides, different summation orders: measured max
# |logit diff| ~5e-7 against logits of magnitude ~0.8, and pool k/v
# entries within ~2e-6 (dense and q8 alike).  1e-5 absolute (logits) and
# 2e-5 (k/v) leave about 10x headroom.
LOGIT_ATOL = 1e-5
POOL_ATOL = 2e-5


@pytest.fixture(scope="module")
def models():
    jm = JaxGPT(JaxConfig(**CFG))
    jp = jax.device_get(jm.init_params(jax.random.PRNGKey(0)))
    tm = GPT(TransformerConfig(**CFG), device="cpu")
    return jm, jp, tm


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_params_from_jax_round_trip(models):
    _, jp, _ = models
    tp = params_from_jax(jp, device="cpu")
    jl, tl = dict(_leaves(jp)), dict(_leaves(tp))
    assert jl.keys() == tl.keys()
    for name, arr in jl.items():
        t = tl[name]
        assert tuple(t.shape) == arr.shape, name
        np.testing.assert_array_equal(t.numpy(), np.asarray(arr))
    # bf16 storage: dense floats cast, bit-exact against JAX's own cast
    tb = params_from_jax(jp, device="cpu", dtype=torch.bfloat16)
    jb = jax.device_get(jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                     jp))
    tb2 = params_from_jax(jb, device="cpu")
    for (name, a), (_, b) in zip(_leaves(tb), _leaves(tb2)):
        assert a.dtype == torch.bfloat16 and b.dtype == torch.bfloat16, name
        assert torch.equal(a, b), name


def test_quantize_weights_bit_identical(models):
    _, jp, _ = models
    jq = jax.device_get(JaxGPT.quantize_weights(jp))
    tq = GPT.quantize_weights(params_from_jax(jp, device="cpu"))
    jl, tl = dict(_leaves(jq)), dict(_leaves(tq))
    assert jl.keys() == tl.keys()
    assert "/layers/attn/wq/scale" in tl and "/embed/q8" in tl
    for name, arr in jl.items():
        t = tl[name]
        assert tuple(t.shape) == np.asarray(arr).shape, name
        assert str(t.dtype).split(".")[-1] == np.asarray(arr).dtype.name
        np.testing.assert_array_equal(t.numpy(), np.asarray(arr),
                                      err_msg=name)
    # a q8 tree carried across keeps int8 weights and f32 scales even when
    # the dense leaves are cast
    tq2 = params_from_jax(jq, device="cpu", dtype=torch.bfloat16)
    assert tq2["embed"]["q8"].dtype == torch.int8
    assert tq2["embed"]["scale"].dtype == torch.float32
    assert tq2["ln_f"].dtype == torch.bfloat16


def test_rope_grid_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 2, 5, 64)).astype(np.float32)
    pos = rng.integers(0, 60, (2, 5)).astype(np.int32)
    got = _rope_grid(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    ref = np.asarray(jax_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def _paged_run(model, params, pool, table, tables, toks, steps, to_arr):
    """Prefill one row by chunks, then batched steps over three rows (the
    third inactive: all-zero table, position 0).  Returns every logits
    array and the final pool."""
    outs = []
    logits, pool = model.decode_chunk_paged(params, pool, to_arr(table),
                                            to_arr(toks[:, :8]), 0,
                                            last_index=7)
    outs.append(logits)
    logits, pool = model.decode_chunk_paged(params, pool, to_arr(table),
                                            to_arr(toks[:, 8:]), 8)
    outs.append(logits)                                   # [1, n, V]
    for tk, ps in steps:
        logits, pool = model.decode_step_rows_paged(
            params, pool, to_arr(tables), to_arr(tk), to_arr(ps))
        outs.append(logits)
    return outs, pool


@pytest.mark.parametrize("weights", ["dense", "q8"])
def test_paged_decode_matches_jax(models, weights):
    jm, jp, tm = models
    if weights == "q8":
        jp = jax.device_get(JaxGPT.quantize_weights(jp))
    tp = params_from_jax(jp, device="cpu")
    rng = np.random.default_rng(5)
    bl, nb, M = 4, 12, 16
    table = np.zeros((M,), np.int32)
    table[:4] = [3, 1, 7, 2]                       # non-contiguous blocks
    toks = rng.integers(0, 256, (1, 14)).astype(np.int32)
    tables = np.zeros((3, M), np.int32)
    tables[0, :4] = table[:4]
    tables[1, :2] = [5, 6]
    steps = [(np.array([11, 40, 0], np.int32), np.array([14, 2, 0], np.int32)),
             (np.array([99, 17, 0], np.int32), np.array([15, 3, 0], np.int32))]
    jm._force_q8_kernel = "interpret"              # the Pallas kernels
    try:
        jout, jpool = _paged_run(jm, jp, jm.paged_cache_alloc(nb, bl), table,
                                 tables, toks, steps, jnp.asarray)
    finally:
        jm._force_q8_kernel = None
    tout, tpool = _paged_run(tm, tp, tm.paged_cache_alloc(nb, bl), table,
                             tables, toks, steps, torch.from_numpy)
    assert [tuple(t.shape) for t in tout] == [j.shape for j in jout]
    for j, t in zip(jout, tout):
        assert t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=LOGIT_ATOL)
    for kv in ("k", "v"):
        np.testing.assert_allclose(tpool[kv].numpy(), np.asarray(jpool[kv]),
                                   rtol=1e-5, atol=POOL_ATOL)
    # the live rows' greedy choices agree (rows 0, 1; row 2 is garbage)
    for j, t in zip(jout[2:], tout[2:]):
        assert (np.argmax(np.asarray(j)[:2], -1)
                == t[:2].argmax(-1).numpy()).all()


def test_init_params_shapes_and_seed(models):
    jm, jp, tm = models
    a = tm.init_params(seed=7)
    b = tm.init_params(seed=7)
    for (name, x), (_, y) in zip(_leaves(a), _leaves(b)):
        assert torch.equal(x, y), name
    jl = dict(_leaves(jp))
    for name, x in _leaves(a):
        assert tuple(x.shape) == jl[name].shape, name
        assert x.dtype == torch.float32
    # same init scale as the JAX package (0.02 embedding, 1/sqrt(fan_in))
    assert abs(a["embed"].std().item() - 0.02) < 2e-3
    wq = a["layers"]["attn"]["wq"]
    assert abs(wq.std().item() - CFG["d_model"] ** -0.5) < 0.01


def test_gpt_takes_a_mesh():
    """``GPT(mesh=)`` holds the mesh of its training forward: a single
    process's mesh computes what no mesh does, and a sliding window over
    a sequence axis is refused with the JAX package's text (the axes over
    ranks: tests/test_torch_tensor_parallel.py, _seq_parallel.py)."""
    from ray_lightning_accelerators_tpu_torch.parallel.mesh import (
        Mesh, local_mesh)
    m = GPT(TransformerConfig(**CFG), device="cpu")
    p = m.init_params(0)
    tokens = torch.arange(16).reshape(2, 8) % CFG["vocab_size"]
    mm = GPT(TransformerConfig(**CFG), device="cpu", mesh=local_mesh())
    assert mm.mesh is not None
    assert torch.equal(mm.forward(p, tokens), m.forward(p, tokens))
    w = GPT(TransformerConfig(**CFG, sliding_window=4), device="cpu",
            mesh=Mesh({"sequence": 2}))
    with pytest.raises(NotImplementedError, match="sliding_window"):
        w._sequence_attention(*(torch.zeros(1, 2, 4, 8),) * 3, w.mesh)
