"""The PyTorch port's CUDA kernels on the card, each held to its plain
PyTorch version (ops/norms.py, ops/quant.py).  The kernels have no CPU
mode, so every test here needs an NVIDIA GPU and skips without one.
This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \
        tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from ray_lightning_accelerators_tpu_torch.ops import norms, quant

pytestmark = pytest.mark.cuda

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture
def cuda_device():
    """The CUDA device, or a skip: decided inside the test run, never at
    import or collection (every xdist worker must collect the same set)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _q8_operands(m, k, n, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    wq = rng.integers(-127, 128, (k, n)).astype(np.int8)
    scale = (rng.random(n).astype(np.float32) + 0.1) / 127.0
    return x, wq, scale


@pytest.mark.parametrize("rows,d,dtype", [(16, 768, torch.bfloat16),
                                          (5, 100, torch.float32),
                                          (3, 768, torch.float16)])
def test_cuda_rms_norm_matches_plain(cuda_device, rows, d, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(rows, d, device=cuda_device, generator=g).to(dtype)
    s = torch.randn(d, device=cuda_device, generator=g)
    before = norms.rms_norm.launches
    got = norms.rms_norm(x, s)
    torch.cuda.synchronize()
    assert norms.rms_norm.launches == before + 1
    ref = norms.rms_norm_reference(x, s)
    # one rounding of the output in its dtype on each side
    tol = {torch.bfloat16: 2e-2, torch.float16: 2e-3, torch.float32: 1e-5}
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol[dtype],
                               atol=tol[dtype])


@pytest.mark.parametrize("m,k,n", [(16, 768, 768), (128, 3072, 768),
                                   (3, 40, 20)])
def test_cuda_int8_matmul_matches_plain(cuda_device, m, k, n):
    x, wq, scale = (torch.from_numpy(a).to(cuda_device)
                    for a in _q8_operands(m, k, n))
    got = quant.int8_matmul(x, wq, scale)
    torch.cuda.synchronize()
    ref = quant.int8_matmul_reference(x, wq, scale)
    # f32 in, f32 accumulation on both sides, summed in different orders
    # over K <= 3072: a few f32 ulps of the result; 1e-4 is ~100x that
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("m,k,n", [(16, 768, 50304), (1, 40, 33)])
def test_cuda_int8_matmul_nt_matches_plain(cuda_device, m, k, n):
    x, wq, _ = _q8_operands(m, k, n)
    x = torch.from_numpy(x).to(cuda_device)
    w_nt = torch.from_numpy(np.ascontiguousarray(wq.T)).to(cuda_device)
    got = quant.int8_matmul_nt(x, w_nt)
    torch.cuda.synchronize()
    ref = quant.int8_matmul_nt_reference(x, w_nt)
    # as above, with the absolute part scaled to the outputs' magnitude
    # (products of int8 weights up to 127 with unit-scale x)
    torch.testing.assert_close(got, ref, rtol=1e-4,
                               atol=1e-5 * ref.abs().max().item())


@pytest.mark.parametrize("weights", ["dense", "q8"])
def test_cuda_paged_decode_matches_cpu(cuda_device, weights):
    """The whole paged decode path on the card in f32 (kernels for the
    norms and q8 projections, CUDA index_put for the pool scatter) against
    the CPU port (plain versions), same weights and tokens."""
    from ray_lightning_accelerators_tpu_torch.models.transformer import (
        GPT, TransformerConfig)
    cfg = TransformerConfig(vocab_size=256, d_model=128, n_heads=2,
                            d_ff=256, n_layers=2, max_seq_len=64)
    cpu = GPT(cfg, device="cpu")
    gpu = GPT(cfg, device=cuda_device)
    params = cpu.init_params(seed=3)
    if weights == "q8":
        params = GPT.quantize_weights(params)

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        return tree.to(dev)

    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(0, 256, (1, 10)))
    table = torch.zeros(16, dtype=torch.long)
    table[:3] = torch.tensor([2, 5, 1])
    tables = torch.zeros(3, 16, dtype=torch.long)
    tables[0] = table
    step = (torch.tensor([7, 3, 0]), torch.tensor([10, 0, 0]))
    outs = {}
    for name, model, p in (("cpu", cpu, params),
                           ("gpu", gpu, to(params, cuda_device))):
        pool = model.paged_cache_alloc(8, 4)
        lc, pool = model.decode_chunk_paged(p, pool, table, toks, 0)
        ls, pool = model.decode_step_rows_paged(p, pool, tables, *step)
        outs[name] = (lc.cpu(), ls[:1].cpu(), pool["k"].cpu())
    for a, b in zip(outs["gpu"], outs["cpu"]):
        # f32 both sides (no TF32), different summation orders through 2
        # layers: the CPU-side parity tests measure ~5e-7 on logits of
        # magnitude ~1; 1e-4 leaves headroom for the card's cuBLAS order
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
