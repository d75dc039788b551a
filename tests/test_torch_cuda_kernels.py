"""The PyTorch port's CUDA kernels on the card, each held to its plain
PyTorch version (ops/norms.py, ops/quant.py, ops/attention.py), and the
model paths that run them (GPT, ResNet-18, ViT) against the CPU port.
The kernels have no CPU mode, so every test here needs an NVIDIA GPU and
skips without one.
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


def _ulp(v, bits):
    """One ulp at |v| for a float with ``bits`` significant bits."""
    mag = v.float().abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - (bits - 1))


def _assert_within_an_ulp(got, ref):
    """K7's tolerance: bf16 and f16 within one ulp of each plain output
    plus 1e-5 of the largest output, f32 within 1e-5 absolute."""
    err = (got.float() - ref.float()).abs()
    if got.dtype == torch.float32:
        assert err.max().item() <= 1e-5
    else:
        bits = 8 if got.dtype == torch.bfloat16 else 11
        lim = _ulp(ref, bits) + 1e-5 * ref.float().abs().max()
        assert bool((err <= lim).all()), (err - lim).max().item()


def _bits(t):
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
# K1 (rows, d, x dtype, scale dtype): the serve path (bf16 scale at 1-128
# rows, 17 leaving one warp of a block alone), the training steps (GPT
# [16384, 768] and ViT [16384, 256], f32 scale), every register count of
# the cached path (d 256 .. 2048 bf16: 1, 2, 3, 4, 6, 8 vectors a lane;
# d 200: a ragged last vector group), and the general path: d 100 and
# 1030 (not a multiple of the 16-byte vector), d 4096 (wider than the
# register cache).  The first three cases draw their data from seed 0,
# the others from rows + d.
RMS_CASES = [
    (16, 768, bf16, f32), (5, 100, f32, f32), (3, 768, f16, f32),
    (1, 768, bf16, bf16), (16, 768, bf16, bf16), (17, 768, bf16, bf16),
    (128, 768, bf16, bf16), (16384, 256, bf16, f32),
    (16384, 768, bf16, f32), (16384, 768, bf16, bf16),
    (300, 512, bf16, f32), (64, 1024, bf16, bf16), (40, 1536, bf16, f32),
    (33, 2048, bf16, f32), (1000, 200, bf16, bf16), (7, 100, bf16, f32),
    (9, 1030, f32, f32), (8, 4096, bf16, bf16), (64, 384, f16, f16),
    (512, 768, f32, f32), (2048, 768, f16, f32),
]


@pytest.mark.parametrize("rows,d,dtype,sdtype", RMS_CASES)
def test_cuda_rms_norm_matches_plain(cuda_device, rows, d, dtype, sdtype):
    seed = 0 if (rows, d, dtype, sdtype) in RMS_CASES[:3] else rows + d
    g = torch.Generator(device=cuda_device).manual_seed(seed)
    x = torch.randn(rows, d, device=cuda_device, generator=g).to(dtype)
    s = torch.randn(d, device=cuda_device, generator=g).to(sdtype)
    before = norms.rms_norm.launches
    got = norms.rms_norm(x, s)
    torch.cuda.synchronize()
    assert norms.rms_norm.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    ref = norms.rms_norm_reference(x, s)
    # one rounding of the output in its dtype on each side
    tol = {torch.bfloat16: 2e-2, torch.float16: 2e-3, torch.float32: 1e-5}
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol[dtype],
                               atol=tol[dtype])
    _assert_within_an_ulp(got, ref)


def _norm_call(op, x, s, b):
    return norms.rms_norm(x, s) if op == "rms_norm" \
        else norms.layer_norm(x, s, b)


def _norm_ref(op, x, s, b):
    return norms.rms_norm_reference(x, s) if op == "rms_norm" \
        else norms.layer_norm_reference(x, s, b)


# The persistent grid's row stride is 4 warps x its blocks: at least
# 132 x 4 = 528 rows on an H100 and at most 132 SMs x 16 blocks x 4 =
# 8448 (2048 threads an SM), whatever the occupancy.
GRID_WALK_ROWS = [528, 8449, 16383, 16385, 2 * 8448 + 1, 3 * 8448 + 1]


@pytest.mark.parametrize("op", ["rms_norm", "layer_norm"])
@pytest.mark.parametrize("d,pdtype", [(768, f32), (256, f32), (768, bf16)])
@pytest.mark.parametrize("rows", GRID_WALK_ROWS)
def test_cuda_norms_walk_rows_on_the_persistent_grid(cuda_device, op, d,
                                                     pdtype, rows):
    """Row counts at which, at any occupancy, every warp takes one row
    (528), some warp walks a second row from its second register buffer
    (8449, 16383, 16385), a third (16897) and a fourth (25345), against
    the plain version."""
    g = torch.Generator(device=cuda_device).manual_seed(rows)
    x = (torch.randn(rows, d, device=cuda_device, generator=g) * 2 + 1
         ).to(bf16)
    s, b = (torch.randn(d, device=cuda_device, generator=g).to(pdtype)
            for _ in range(2))
    got = _norm_call(op, x, s, b)
    _assert_within_an_ulp(got, _norm_ref(op, x, s, b))


@pytest.mark.parametrize("op", ["rms_norm", "layer_norm"])
@pytest.mark.parametrize("dtype,pdtype", [(bf16, f32), (bf16, bf16),
                                          (f32, f32)])
@pytest.mark.parametrize("where", ["x", "params"])
def test_cuda_norms_misaligned_view_gives_the_aligned_bits(
        cuda_device, op, dtype, pdtype, where):
    """A view one element off 16-byte alignment (x, or scale and bias)
    takes the general path and gives the bits an aligned copy gets from
    the register-cached path: both sum each lane's elements in one order.
    Enough rows that a sum taken in another order, a last-bit change of
    the f32 factor, flips some bf16 output."""
    rows, d = 1031, 768
    g = torch.Generator(device=cuda_device).manual_seed(3)
    xb = (torch.randn(rows * d + 1, device=cuda_device, generator=g) * 2
          + 1).to(dtype)
    sb, bb = (torch.randn(d + 1, device=cuda_device, generator=g).to(pdtype)
              for _ in range(2))
    x, s, b = xb[1:].view(rows, d), sb[1:], bb[1:]
    if where == "x":
        s, b = s.clone(), b.clone()
    else:
        x = x.clone()
    off = x if where == "x" else s
    assert off.data_ptr() % 16 != 0
    aligned = [t.clone() for t in (x, s, b)]
    assert all(t.data_ptr() % 16 == 0 for t in aligned)
    before = getattr(norms, op).launches
    got = _norm_call(op, x, s, b)
    want = _norm_call(op, *aligned)
    torch.cuda.synchronize()
    assert getattr(norms, op).launches == before + 2
    assert torch.equal(_bits(got), _bits(want))
    _assert_within_an_ulp(got, _norm_ref(op, *aligned))


@pytest.mark.parametrize("op", ["rms_norm", "layer_norm"])
@pytest.mark.parametrize("rows,d", [(16384, 768), (16, 768), (9, 1030)])
def test_cuda_norms_repeat_bitwise(cuda_device, op, rows, d):
    """Two calls on the same inputs give the same bits (no atomics, no
    order that depends on scheduling)."""
    g = torch.Generator(device=cuda_device).manual_seed(rows)
    x = torch.randn(rows, d, device=cuda_device, generator=g).to(bf16)
    s, b = (torch.randn(d, device=cuda_device, generator=g)
            for _ in range(2))
    one, two = _norm_call(op, x, s, b), _norm_call(op, x, s, b)
    assert torch.equal(_bits(one), _bits(two))


# K7 at the shapes of chip_smoke.py's phase 2d, smaller, plus the widths
# that leave the register-cached path: (rows, d, dtype, param dtype)
LN_CASES = [
    (16, 768, torch.bfloat16, torch.bfloat16),
    (4096, 256, torch.bfloat16, torch.float32),
    (1000, 200, torch.bfloat16, torch.bfloat16),   # ragged d, vector path
    (37, 100, torch.bfloat16, torch.float32),      # d % 8 != 0: scalar path
    (8, 4096, torch.bfloat16, torch.bfloat16),     # wider than the cache
    (512, 768, torch.float32, torch.float32),
    (9, 1030, torch.float32, torch.float32),       # wider than the cache
    (64, 384, torch.float16, torch.float16),
    # the cached path's other register counts and row counts: one row, a
    # block with one busy warp, the GPT training rows, and 6 and 8
    # vectors a lane, where the f32 parameters are read again per row
    (1, 768, torch.bfloat16, torch.bfloat16),
    (17, 768, torch.bfloat16, torch.bfloat16),
    (16384, 768, torch.bfloat16, torch.float32),
    (40, 1536, torch.bfloat16, torch.float32),
    (33, 2048, torch.bfloat16, torch.float32),
]


@pytest.mark.parametrize("rows,d,dtype,pdtype", LN_CASES)
def test_cuda_layer_norm_matches_plain(cuda_device, rows, d, dtype, pdtype):
    """K7 against its plain version on the same inputs (a mean of 5
    against a spread of 2).  Both compute in f32 and round once to the output dtype; they differ
    by summation order and rsqrt's last bits, which can flip that
    rounding: bf16 and f16 within one ulp of each plain output, plus
    1e-5 of the largest output where ``y * scale`` and ``bias`` cancel
    (near 0 an f32 rounding of those terms exceeds a bf16 ulp); f32
    1e-5 absolute."""
    g = torch.Generator(device=cuda_device).manual_seed(rows + d)
    x = (torch.randn(rows, d, device=cuda_device, generator=g) * 2 + 5
         ).to(dtype)
    s, b = (torch.randn(d, device=cuda_device, generator=g).to(pdtype)
            for _ in range(2))
    before = norms.layer_norm.launches
    got = norms.layer_norm(x, s, b)
    torch.cuda.synchronize()
    assert norms.layer_norm.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    _assert_within_an_ulp(got, norms.layer_norm_reference(x, s, b))


def test_cuda_layer_norm_two_pass_variance(cuda_device):
    """At a mean of 10 against a spread of 1 (f32, parameters near 1 and
    0) a one-pass variance E[x^2] - mu^2 misses the 1e-5 limit and the
    two-pass one the kernel must compute stays inside it."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    x = torch.randn(512, 768, device=cuda_device, generator=g) + 10
    s = 1 + 0.1 * torch.randn(768, device=cuda_device, generator=g)
    b = 0.1 * torch.randn(768, device=cuda_device, generator=g)
    ref = norms.layer_norm_reference(x, s, b)
    mu = x.mean(-1, keepdim=True)
    var = ((x * x).mean(-1, keepdim=True) - mu * mu).clamp_min(0)
    one_pass = (x - mu) * torch.rsqrt(var + 1e-6) * s + b
    assert (one_pass - ref).abs().max().item() > 1e-5
    assert (norms.layer_norm(x, s, b) - ref).abs().max().item() <= 1e-5


def test_cuda_layer_norm_edges_and_grad(cuda_device):
    """0 rows launch nothing; a bad scale shape raises ValueError; mixed
    parameter dtypes run (cast to f32); the gradient through K7 equals the
    plain version's autograd (the backward is that VJP, f32: 1e-5)."""
    x = torch.randn(0, 256, device=cuda_device)
    before = norms.layer_norm.launches
    assert norms.layer_norm(x, torch.ones(256, device=cuda_device),
                            torch.zeros(256, device=cuda_device)
                            ).shape == (0, 256)
    assert norms.layer_norm.launches == before
    x = torch.randn(3, 5, 256, device=cuda_device)
    with pytest.raises(ValueError, match="scale must have shape"):
        norms.layer_norm(x, torch.ones(128, device=cuda_device),
                         torch.zeros(256, device=cuda_device))
    mixed = norms.layer_norm(x.bfloat16(), torch.ones(256, device=cuda_device),
                             torch.zeros(256, device=cuda_device,
                                         dtype=torch.bfloat16))
    assert mixed.dtype == torch.bfloat16
    xg, sg, bg = (t.requires_grad_() for t in (
        x.clone(), torch.randn(256, device=cuda_device),
        torch.randn(256, device=cuda_device)))
    do = torch.randn_like(x)
    got = torch.autograd.grad(norms.layer_norm(xg, sg, bg), (xg, sg, bg), do)
    assert norms.layer_norm.launches == before + 2
    want = torch.autograd.grad(norms.layer_norm_reference(xg, sg, bg),
                               (xg, sg, bg), do)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)


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


# K5 and K6 in bf16 and f16, the tensor-core bodies.  Tolerance: both
# sides sum exact products in f32 and round once to x's dtype; the sums
# run in another order over K <= 6000, which can flip that rounding: one
# ulp of x's dtype of each plain output, plus 1e-5 of the largest output
# (outputs near 0 after cancellation).
def _q8_half_operands(m, k, n, dtype, device, seed=5):
    g = torch.Generator(device=device).manual_seed(seed + m + k + n)
    x = torch.randn(m, k, device=device, generator=g).to(dtype)
    wq = torch.randint(-128, 128, (k, n), device=device, generator=g,
                       dtype=torch.int8)
    scale = (torch.rand(n, device=device, generator=g) + 0.1) / 127.0
    return x, wq, scale


# the serve path's projections (q/k/v/o, MLP up, MLP down) at decode and
# prefill row counts: one row, a ragged m tile, one tile, one row over,
# the engine's 128-token chunks and a 400-token prompt (4 rounds of 8 m
# tiles)
K5_SHAPES = [(m, k, n) for m in (1, 15, 16, 17, 128, 400)
             for k, n in ((768, 768), (768, 3072), (3072, 768))]
# ragged edges: N not a multiple of 16 or 64 (element loads of w), K not
# a multiple of 32 or 16 or 8 (element loads of x), a k range of one
# chunk, and a K that needs segments (wider than shared memory at 400
# rows)
K5_RAGGED = [(3, 40, 20), (5, 40, 33), (17, 200, 96), (16, 100, 64),
             (33, 1000, 130), (2, 8, 8), (20, 24600, 64), (400, 6000, 200)]


@pytest.mark.parametrize("dtype", [bf16, f16])
@pytest.mark.parametrize("m,k,n", K5_SHAPES + K5_RAGGED)
def test_cuda_int8_matmul_half_matches_plain(cuda_device, m, k, n, dtype):
    x, wq, scale = _q8_half_operands(m, k, n, dtype, cuda_device)
    before = quant.int8_matmul.launches
    got = quant.int8_matmul(x, wq, scale)
    torch.cuda.synchronize()
    assert quant.int8_matmul.launches == before + 1
    assert got.dtype == dtype and got.shape == (m, n)
    _assert_within_an_ulp(got, quant.int8_matmul_reference(x, wq, scale))


# the tied unembedding at decode (N = 50304) at 1, 16 and 17 rows; ragged
# N and K; more rows than one round holds (128, 400); a K whose x rows
# do not fit beside the ring (x rides in the stages)
K6_SHAPES = [(1, 768, 50304), (16, 768, 50304), (17, 768, 50304),
             (3, 40, 33), (16, 100, 1000), (5, 200, 77), (2, 8, 8),
             (128, 768, 4096), (400, 768, 1000), (5, 6000, 300)]


@pytest.mark.parametrize("dtype", [bf16, f16])
@pytest.mark.parametrize("m,k,n", K6_SHAPES)
def test_cuda_int8_matmul_nt_half_matches_plain(cuda_device, m, k, n,
                                                dtype):
    x, wq, _ = _q8_half_operands(m, k, n, dtype, cuda_device)
    x = (x.float() * 0.05).to(dtype)   # contraction scales folded into x
    w_nt = wq.T.contiguous()
    before = quant.int8_matmul_nt.launches
    got = quant.int8_matmul_nt(x, w_nt)
    torch.cuda.synchronize()
    assert quant.int8_matmul_nt.launches == before + 1
    assert got.dtype == dtype and got.shape == (m, n)
    _assert_within_an_ulp(got, quant.int8_matmul_nt_reference(x, w_nt))


@pytest.mark.parametrize("op", ["int8_matmul", "int8_matmul_nt"])
@pytest.mark.parametrize("where", ["x", "w"])
def test_cuda_int8_misaligned_view_gives_the_aligned_bits(cuda_device, op,
                                                          where):
    """A view one element off 16-byte alignment (x or w) takes element
    loads into the same shared layout and gives an aligned copy's bits."""
    m, k, n = (17, 768, 3072) if op == "int8_matmul" else (16, 768, 4096)
    x, wq, scale = _q8_half_operands(m, k, n, bf16, cuda_device)
    w = wq if op == "int8_matmul" else wq.T.contiguous()
    if where == "x":
        buf = torch.empty(x.numel() + 1, dtype=bf16, device=cuda_device)
        buf[1:] = x.reshape(-1)
        x = buf[1:].view(x.shape)
    else:
        buf = torch.empty(w.numel() + 1, dtype=torch.int8,
                          device=cuda_device)
        buf[1:] = w.reshape(-1)
        w = buf[1:].view(w.shape)
    off = x if where == "x" else w
    assert off.data_ptr() % 16 != 0
    if op == "int8_matmul":
        got = quant.int8_matmul(x, w, scale)
        want = quant.int8_matmul(x.clone(), w.clone(), scale)
        ref = quant.int8_matmul_reference(x, w, scale)
    else:
        got = quant.int8_matmul_nt(x, w)
        want = quant.int8_matmul_nt(x.clone(), w.clone())
        ref = quant.int8_matmul_nt_reference(x, w)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(want))
    _assert_within_an_ulp(got, ref)


@pytest.mark.parametrize("op,m,k,n", [
    ("int8_matmul", 16, 3072, 768), ("int8_matmul", 128, 768, 3072),
    ("int8_matmul", 400, 768, 768), ("int8_matmul_nt", 16, 768, 50304),
    ("int8_matmul_nt", 128, 768, 4096)])
def test_cuda_int8_repeat_bitwise(cuda_device, op, m, k, n):
    """Two calls give the same bits: the cluster's ranks and the k halves
    are summed in one fixed order, with no atomics."""
    x, wq, scale = _q8_half_operands(m, k, n, bf16, cuda_device)
    if op == "int8_matmul":
        one, two = (quant.int8_matmul(x, wq, scale) for _ in range(2))
    else:
        w = wq.T.contiguous()
        one, two = (quant.int8_matmul_nt(x, w) for _ in range(2))
    assert torch.equal(_bits(one), _bits(two))


# K2 at the prefill shapes of chip_smoke.py's phase 2 with a smaller bh:
# (bh, seq, head_dim, causal, window, dtype)
FLASH_CASES = [
    (8, 128, 64, True, None, torch.bfloat16),
    (4, 400, 64, True, None, torch.bfloat16),     # ragged last tile
    (4, 512, 64, True, None, torch.bfloat16),
    (4, 400, 64, True, 256, torch.bfloat16),      # window tile skipping
    (4, 256, 128, True, None, torch.bfloat16),
    (4, 128, 64, False, None, torch.bfloat16),
    (64, 64, 64, False, None, torch.bfloat16),    # ViT's 64 patches
    (2, 200, 64, True, None, torch.float32),
    (2, 130, 128, False, 40, torch.float16),
]


@pytest.mark.parametrize("bh,s,d,causal,window,dtype", FLASH_CASES)
def test_cuda_flash_attention_matches_plain(cuda_device, bh, s, d, causal,
                                            window, dtype):
    from ray_lightning_accelerators_tpu_torch.ops import attention
    g = torch.Generator(device=cuda_device).manual_seed(bh * s + d)
    q, k, v = (torch.randn(bh, s, d, device=cuda_device, generator=g
                           ).to(dtype) for _ in range(3))
    before = attention.flash_forward.launches
    out, lse = attention.flash_forward(q, k, v, causal=causal,
                                       window=window)
    torch.cuda.synchronize()
    assert attention.flash_forward.launches == before + 1
    ref, ref_lse = attention.attention_reference_lse(q, k, v, causal,
                                                     window=window)
    assert out.dtype == dtype and lse.dtype == torch.float32
    # both sides: f32 products and sums, p rounded to v's dtype, the
    # output rounded once; they differ by summation order and by where a
    # rounding of p or of the output falls: bf16 rtol 2e-2 with an atol of
    # 2e-2 of the largest |out|, f16 4x finer, f32 1e-4, and a relative
    # L2 of the same size over the whole output.  lse is f32 on both
    # sides: 1e-3 absolute.
    tol = {torch.bfloat16: 2e-2, torch.float16: 5e-3, torch.float32: 1e-4}
    t = tol[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=t,
                               atol=t * ref.float().abs().max().item())
    assert _rel_l2(out, ref) <= t, _rel_l2(out, ref)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-3)


# (bh, q_len, k_len, head_dim, causal, window, dtype): lengths that cross
# the tensor-core bodies' 64-row tiles and 16-wide products (1, 63, 64,
# 65, 129), q_len != k_len, and windows under which the rows past
# k_len + window - 1 see no key at all
FLASH_LENGTHS = [
    (2, 1, 1, 64, True, None, torch.bfloat16),
    (2, 63, 63, 64, True, None, torch.bfloat16),
    (2, 64, 64, 128, True, None, torch.float16),
    (2, 65, 65, 64, False, None, torch.bfloat16),
    (2, 129, 129, 64, True, None, torch.bfloat16),
    (2, 129, 129, 128, True, None, torch.float32),
    (2, 100, 37, 128, True, None, torch.bfloat16),
    (2, 37, 300, 64, True, 50, torch.bfloat16),
    (2, 70, 200, 64, False, None, torch.float32),
    (2, 300, 77, 64, True, 50, torch.bfloat16),    # rows 126.. see no key
    (2, 300, 77, 64, True, 50, torch.float32),
    (1, 256, 100, 128, True, 30, torch.float16),   # rows 129.. see no key
]


@pytest.mark.parametrize("bh,q_len,k_len,d,causal,window,dtype",
                         FLASH_LENGTHS)
def test_cuda_flash_attention_at_any_lengths(cuda_device, bh, q_len, k_len,
                                             d, causal, window, dtype):
    """K2 (out, lse) and K3a (dq, called directly from the plain forward's
    out and lse) against their plain versions at tile-edge lengths; a row
    that sees no key gets the mean of v, as the plain softmax over its
    -1e30 scores gives.  Tolerances as the tests above; out is also held
    to a relative L2 of the same size, which a wrong value tile in the
    rows that attend to many keys (each |out| far below the elementwise
    atol, a fraction of the largest |out|) cannot pass."""
    from ray_lightning_accelerators_tpu_torch.ops import attention as A
    g = torch.Generator(device=cuda_device).manual_seed(q_len * k_len + d)
    q, do = (torch.randn(bh, q_len, d, device=cuda_device, generator=g
                         ).to(dtype) for _ in range(2))
    k, v = (torch.randn(bh, k_len, d, device=cuda_device, generator=g
                        ).to(dtype) for _ in range(2))
    kw = dict(causal=causal, window=window)
    out, lse = A.flash_forward(q, k, v, **kw)
    ref, ref_lse = A.attention_reference_lse(q, k, v, causal, None, window)
    delta = (do.float() * ref.float()).sum(-1)
    dq = A.flash_backward_dq(q, k, v, do, ref_lse, delta, **kw)
    torch.cuda.synchronize()
    tol = {torch.bfloat16: 2e-2, torch.float16: 5e-3, torch.float32: 1e-4}
    t = tol[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=t,
                               atol=t * ref.float().abs().max().item())
    assert _rel_l2(out, ref) <= t, _rel_l2(out, ref)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-3)
    if window is not None and q_len > k_len + window - 1:
        blind = out[:, k_len + window - 1:].float()
        mean_v = v.float().mean(1, keepdim=True).expand_as(blind)
        torch.testing.assert_close(blind, mean_v, rtol=t,
                                   atol=t * mean_v.abs().max().item())
    ref_dq = A.flash_backward_reference(q, k, v, ref, ref_lse, do, **kw)[0]
    assert dq.dtype == dtype and bool(torch.isfinite(dq).all())
    if ref_dq.float().norm() == 0:
        # one key: dP - delta cancels to 0 in the plain version's order
        # and to f32 rounding in the kernel's (as the backward test below)
        assert dq.float().abs().max().item() <= 1e-5
    else:
        bwd_tol = {torch.bfloat16: 2e-2, torch.float16: 5e-3,
                   torch.float32: 1e-5}
        assert _rel_l2(dq, ref_dq) <= bwd_tol[dtype], _rel_l2(dq, ref_dq)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_flash_forward_and_dq_repeat_bitwise(cuda_device, dtype):
    """K2 and K3a twice on the same inputs: every output element is
    written once by one thread (no atomics), so both repeat bitwise."""
    from ray_lightning_accelerators_tpu_torch.ops import attention as A
    g = torch.Generator(device=cuda_device).manual_seed(13)
    q, k, v, do = (torch.randn(4, 300, 64, device=cuda_device, generator=g
                               ).to(dtype) for _ in range(4))
    runs = []
    for _ in range(2):
        out, lse = A.flash_forward(q, k, v, causal=True)
        delta = (do.float() * out.float()).sum(-1)
        runs.append((out, lse, A.flash_backward_dq(q, k, v, do, lse, delta,
                                                   causal=True)))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_cuda_flash_attention_typed_errors(cuda_device):
    """An unsupported head dim is a ValueError forward and backward; inputs
    that require grad run K2 forward and, by the k_len <= block_k rule,
    K4 (or K3a + K3b) backward, with grads equal to the plain version's."""
    from ray_lightning_accelerators_tpu_torch.ops import attention
    q = torch.randn(2, 16, 32, device=cuda_device)
    with pytest.raises(ValueError, match=r"head_dim in \(64, 128\)"):
        attention.flash_forward(q, q, q, causal=True)
    lse = torch.zeros(2, 16, device=cuda_device)
    with pytest.raises(ValueError, match=r"head_dim in \(64, 128\)"):
        attention.flash_backward(q, q, q, q, lse, q, causal=True)
    g = torch.Generator(device=cuda_device).manual_seed(9)
    q, k, v = (torch.randn(1, 2, 48, 64, device=cuda_device, generator=g
                           ).requires_grad_() for _ in range(3))
    do = torch.randn(1, 2, 48, 64, device=cuda_device, generator=g)
    for block_k, kernels in ((None, (0, 0, 1)), (32, (1, 1, 0))):
        counts = _bwd_counts()
        out = attention.flash_attention(q, k, v, causal=True,
                                        block_k=block_k)
        grads = torch.autograd.grad(out, (q, k, v), do)
        torch.cuda.synchronize()
        assert tuple(b - a for a, b in zip(counts, _bwd_counts())) == kernels
        ref = attention.attention_reference(q, k, v, causal=True)
        for got, want in zip(grads, torch.autograd.grad(ref, (q, k, v), do)):
            # f32: summation order only (K4's dq also the atomic order)
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def _bwd_counts():
    from ray_lightning_accelerators_tpu_torch.ops import attention
    return (attention.flash_backward_dq.launches,
            attention.flash_backward_dkv.launches,
            attention.flash_backward_fused.launches)


# K3a + K3b and K4 at small versions of chip_smoke.py's phase 2c shapes:
# (bh, seq, head_dim, causal, window, dtype)
FLASH_BWD_CASES = [
    (4, 256, 64, True, None, torch.bfloat16),
    (4, 200, 64, True, None, torch.bfloat16),     # ragged last tiles
    (4, 256, 128, True, None, torch.bfloat16),
    (4, 400, 64, True, 256, torch.bfloat16),      # window tile skipping
    (4, 128, 64, False, None, torch.float16),
    (64, 64, 64, False, None, torch.bfloat16),    # ViT's 64 patches
    (2, 130, 128, False, 40, torch.float32),
    (2, 200, 64, True, None, torch.float32),
    # the tensor-core kv kernel's tile edges (128 keys a block, 64-query
    # tiles in a two-stage ring, 16-wide products)
    (3, 17, 64, True, None, torch.bfloat16),      # lengths not a multiple
    (2, 130, 128, False, 40, torch.bfloat16),     # of 16, a window
    (2, 200, 128, True, None, torch.float16),
    (8, 1024, 64, True, None, torch.bfloat16),    # the ring turns 16 times
]


def _rel_l2(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("bh,s,d,causal,window,dtype", FLASH_BWD_CASES)
def test_cuda_flash_backward_matches_plain(cuda_device, bh, s, d, causal,
                                           window, dtype, fused):
    """dq, dk and dv of K4 (fused) or K3a + K3b (split) against the plain
    backward on the same inputs and the same forward out/lse.  Both sides
    compute in f32 and round P and dS to the inputs' dtype at the same
    places; they differ by summation order, which can flip a rounding of
    P or dS: relative L2 <= 2e-2 in bf16, 5e-3 in f16, 1e-5 in f32 (K4's
    dq, summed by atomics in no fixed order, 1e-4)."""
    from ray_lightning_accelerators_tpu_torch.ops import attention
    g = torch.Generator(device=cuda_device).manual_seed(bh * s + d)
    q, k, v, do = (torch.randn(bh, s, d, device=cuda_device, generator=g
                               ).to(dtype) for _ in range(4))
    out, lse = attention.flash_forward(q, k, v, causal=causal, window=window)
    block_k = s if fused else min(64, s - 1)
    counts = _bwd_counts()
    got = attention.flash_backward(q, k, v, out, lse, do, causal=causal,
                                   window=window, block_k=block_k)
    torch.cuda.synchronize()
    assert tuple(b - a for a, b in zip(counts, _bwd_counts())) == \
        ((0, 0, 1) if fused else (1, 1, 0))
    ref = attention.flash_backward_reference(q, k, v, out, lse, do,
                                             causal=causal, window=window)
    tol = {torch.bfloat16: 2e-2, torch.float16: 5e-3, torch.float32: 1e-5}
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == dtype and a.shape == b.shape
        t = 1e-4 if (fused and name == "dq" and dtype == torch.float32) \
            else tol[dtype]
        assert bool(torch.isfinite(a).all()), name
        assert _rel_l2(a, b) <= t, (name, _rel_l2(a, b))


# (bh, q_len, k_len, head_dim, causal, window, dtype): a length of 1 and
# q_len != k_len, which the routing through flash_backward cannot send to
# both branches (a one-key split needs block_k 0, which means the default)
FLASH_BWD_LENGTHS = [
    (2, 1, 1, 64, True, None, torch.bfloat16),
    (2, 1, 77, 64, False, None, torch.bfloat16),
    (2, 100, 37, 128, True, None, torch.float16),
    (2, 37, 300, 64, True, 50, torch.bfloat16),
    (2, 70, 200, 64, False, None, torch.float32),
    # rows that see no key (q >= k_len + window - 1) take P = 1 over every
    # key, so every key block walks on to the last query tile
    (2, 300, 77, 64, True, 50, torch.bfloat16),
    (2, 300, 77, 64, True, 50, torch.float32),
    (1, 256, 100, 128, True, 30, torch.float16),
]


@pytest.mark.parametrize("bh,q_len,k_len,d,causal,window,dtype",
                         FLASH_BWD_LENGTHS)
def test_cuda_flash_backward_kernels_at_any_lengths(cuda_device, bh, q_len,
                                                    k_len, d, causal, window,
                                                    dtype):
    """K4 and K3a + K3b called directly against the plain backward, from
    the plain forward's out and lse; tolerances as above."""
    from ray_lightning_accelerators_tpu_torch.ops import attention as A
    g = torch.Generator(device=cuda_device).manual_seed(q_len * k_len + d)
    q, do = (torch.randn(bh, q_len, d, device=cuda_device, generator=g
                         ).to(dtype) for _ in range(2))
    k, v = (torch.randn(bh, k_len, d, device=cuda_device, generator=g
                        ).to(dtype) for _ in range(2))
    out, lse = A.attention_reference_lse(q, k, v, causal, None, window)
    delta = (do.float() * out.float()).sum(-1)
    kw = dict(causal=causal, window=window)
    fused = A.flash_backward_fused(q, k, v, do, lse, delta, **kw)
    split = (A.flash_backward_dq(q, k, v, do, lse, delta, **kw),
             *A.flash_backward_dkv(q, k, v, do, lse, delta, **kw))
    torch.cuda.synchronize()
    ref = A.flash_backward_reference(q, k, v, out, lse, do, **kw)
    tol = {torch.bfloat16: 2e-2, torch.float16: 5e-3, torch.float32: 1e-5}
    for label, got in (("K4", fused), ("K3", split)):
        for name, a, b in zip(("dq", "dk", "dv"), got, ref):
            assert a.dtype == dtype and a.shape == b.shape
            assert bool(torch.isfinite(a).all()), (label, name)
            if b.float().norm() == 0:
                # one key: the softmax has no gradient, and dP - delta
                # cancels to 0 in the plain version's order and to f32
                # rounding (~1e-7 of |dP| ~ 30) in the kernel's
                assert a.float().abs().max().item() <= 1e-5, (label, name)
                continue
            t = 1e-4 if (label, name, dtype) == ("K4", "dq", torch.float32) \
                else tol[dtype]
            assert _rel_l2(a, b) <= t, (label, name, _rel_l2(a, b))


def test_cuda_flash_backward_fused_repeats(cuda_device):
    """K4 twice on the same inputs: dk and dv are written by one block
    each, so they repeat bitwise; dq is summed by atomic adds over four
    key blocks in no fixed order, so it repeats within the atomic-order
    tolerance (relative L2 1e-4) and each element within one rounding of
    its dtype."""
    from ray_lightning_accelerators_tpu_torch.ops import attention as A
    g = torch.Generator(device=cuda_device).manual_seed(11)
    q, k, v, do = (torch.randn(4, 512, 64, device=cuda_device, generator=g
                               ).bfloat16() for _ in range(4))
    out, lse = A.flash_forward(q, k, v, causal=True)
    delta = (do.float() * out.float()).sum(-1)
    first = A.flash_backward_fused(q, k, v, do, lse, delta, causal=True)
    second = A.flash_backward_fused(q, k, v, do, lse, delta, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(first[1], second[1]) and torch.equal(first[2],
                                                            second[2])
    dq1, dq2 = first[0].float(), second[0].float()
    assert _rel_l2(dq1, dq2) <= 1e-4
    torch.testing.assert_close(dq1, dq2, rtol=2 ** -7,
                               atol=1e-5 * dq2.abs().max().item())


def test_cuda_flash_backward_unaligned_operands(cuda_device):
    """Operands that are not 16-byte aligned (views one element into a
    buffer) take the bf16 kernels' element-load staging instead of
    cp.async: K2's out and lse, K3a's dq, and K4's and K3b's grads are the
    same bits as from aligned copies of the same values (one key block,
    so K4's dq gets one atomic add per element)."""
    from ray_lightning_accelerators_tpu_torch.ops import attention as A
    bh, s, d = 2, 100, 64
    n = bh * s * d
    g = torch.Generator(device=cuda_device).manual_seed(5)
    buf = torch.randn(4 * n + 1, device=cuda_device, generator=g).bfloat16()
    views = [buf[1 + i * n:1 + (i + 1) * n].view(bh, s, d) for i in range(4)]
    assert all(x.data_ptr() % 16 for x in views)
    copies = [x.clone() for x in views]
    out, lse = A.attention_reference_lse(*copies[:3], causal=True)
    delta = (copies[3].float() * out.float()).sum(-1)
    runs = []
    for q, k, v, do in (views, copies):
        runs.append((*A.flash_backward_fused(q, k, v, do, lse, delta,
                                             causal=True),
                     *A.flash_backward_dkv(q, k, v, do, lse, delta,
                                           causal=True),
                     A.flash_backward_dq(q, k, v, do, lse, delta,
                                         causal=True),
                     *A.flash_forward(q, k, v, causal=True)))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


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


@pytest.mark.parametrize("weights,window", [("dense", None), ("q8", None),
                                            ("dense", 8)])
def test_cuda_generate_matches_cpu(cuda_device, weights, window):
    """Prefill (K2 in f32) and greedy generate() on the card against the
    CPU port, same weights and prompt: f32 on both sides, so the hidden
    states agree to summation-order noise (1e-4) and the tokens match."""
    from ray_lightning_accelerators_tpu_torch.models.transformer import (
        GPT, TransformerConfig)
    from ray_lightning_accelerators_tpu_torch.ops import attention
    cfg = TransformerConfig(vocab_size=256, d_model=128, n_heads=2,
                            d_ff=256, n_layers=2, max_seq_len=64,
                            sliding_window=window)
    cpu = GPT(cfg, device="cpu")
    gpu = GPT(cfg, device=cuda_device)
    params = cpu.init_params(seed=5)
    if weights == "q8":
        params = GPT.quantize_weights(params)

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        return tree.to(dev)

    prompt = np.random.default_rng(6).integers(0, 256, (2, 20))
    gp = to(params, cuda_device)
    before = attention.flash_forward.launches
    h_gpu, c_gpu = gpu._prefill(gp, prompt, 30)
    assert attention.flash_forward.launches == before + cfg.n_layers
    h_cpu, c_cpu = cpu._prefill(params, prompt, 30)
    torch.testing.assert_close(h_gpu.cpu(), h_cpu, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(c_gpu["k"].cpu(), c_cpu["k"], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(gpu.generate(gp, prompt, 10).cpu().numpy(),
                                  cpu.generate(params, prompt, 10).numpy())


def test_cuda_speculative_and_dense_engine_match_generate(cuda_device):
    """In f32 on the card, greedy speculative decoding (the model drafting
    for itself) and the dense engine give generate()'s tokens exactly."""
    from ray_lightning_accelerators_tpu_torch.models.speculative import (
        speculative_generate)
    from ray_lightning_accelerators_tpu_torch.models.transformer import (
        GPT, TransformerConfig)
    from ray_lightning_accelerators_tpu_torch.serve import ServeEngine
    cfg = TransformerConfig(vocab_size=256, d_model=128, n_heads=2,
                            d_ff=256, n_layers=2, max_seq_len=64)
    gpu = GPT(cfg, device=cuda_device)
    params = gpu.init_params(seed=7)
    rng = np.random.default_rng(8)
    prompt = rng.integers(0, 256, (1, 12))
    ref = gpu.generate(params, prompt, 20).cpu().numpy()
    spec, stats = speculative_generate(gpu, params, gpu, params, prompt, 20,
                                       k=4)
    np.testing.assert_array_equal(spec.cpu().numpy(), ref)
    assert stats["accepted"] == stats["checked"]
    reqs = [(rng.integers(0, 256, s0).astype(np.int32), n)
            for s0, n in ((9, 7), (17, 12), (4, 1), (12, 9))]
    with ServeEngine(gpu, params, max_slots=2, paged=False,
                     max_total_len=40) as eng:
        outs = [r.result(timeout=300)
                for r in [eng.submit(p, n) for p, n in reqs]]
    for out, (p, n) in zip(outs, reqs):
        np.testing.assert_array_equal(
            out, gpu.generate(params, p[None], n).cpu().numpy()[0])


def test_cuda_trainer_fit_f32_matches_cpu(cuda_device):
    """Three f32 Trainer.fit steps on the card (K1, K2 and K4 forward and
    backward, cuBLAS products without TF32) against the same steps of the
    CPU port from the same weights on the same batches: per-step loss
    within 1e-3 relative, final params within 1e-3 relative L2 (f32 on
    both sides, summed in other orders)."""
    from ray_lightning_accelerators_tpu_torch import DataLoader, Trainer
    from ray_lightning_accelerators_tpu_torch.data.loader import (
        ArrayDataset)
    from ray_lightning_accelerators_tpu_torch.models.transformer import (
        GPT, TransformerConfig)
    from ray_lightning_accelerators_tpu_torch.ops import attention
    cfg = TransformerConfig(vocab_size=256, d_model=128, n_heads=2,
                            d_ff=256, n_layers=2, max_seq_len=64,
                            loss_chunk_rows=100)
    init = GPT(cfg, device="cpu").init_params(seed=11)
    starts = np.random.default_rng(12).integers(0, 256, 12)
    data = ((starts[:, None] + np.arange(64)[None]) % 256).astype(np.int32)
    runs = {}
    for dev in (cuda_device, "cpu"):
        model = GPT(cfg, device=dev, lr=1e-3)
        model.params = init
        trainer = Trainer(max_epochs=1, device=dev, precision="f32",
                          log_every_n_steps=1, enable_checkpointing=False)
        before = attention.flash_backward_fused.launches
        trainer.fit(model, DataLoader(ArrayDataset(data), batch_size=4))
        if dev != "cpu":
            assert attention.flash_backward_fused.launches == before + 6
        runs[str(dev)] = ([r["train_loss"] for r in trainer.logger.history],
                          model.params)
    (lg, pg), (lc, pc) = runs[str(cuda_device)], runs["cpu"]
    np.testing.assert_allclose(lg, lc, rtol=1e-3)

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: v for key, sub in tree.items()
                    for k, v in flat(sub, f"{prefix}/{key}").items()}
        return {prefix: tree}

    for name, want in flat(pc).items():
        assert _rel_l2(flat(pg)[name].cpu(), want) <= 1e-3, name


@pytest.mark.parametrize("name", ["resnet", "vit"])
def test_cuda_vision_fit_f32_matches_cpu(cuda_device, name):
    """Three f32 Trainer.fit steps of ResNet-18 (width 8: cuDNN
    convolutions, TF32 off) or a small ViT (d 128, 2 heads: head dim 64,
    so K1, K2 and K4 run) on the card against the same steps of the CPU
    port from the same weights on the same batches: per-step loss within
    1e-3 relative, final params within 1e-3 relative L2 (f32 on both
    sides, summed in other orders)."""
    from ray_lightning_accelerators_tpu_torch import DataLoader, Trainer
    from ray_lightning_accelerators_tpu_torch.data.loader import (
        ArrayDataset)
    from ray_lightning_accelerators_tpu_torch.models import resnet, vit
    from ray_lightning_accelerators_tpu_torch.ops import attention
    x, y = resnet.synthetic_cifar10(12, seed=13)

    def make(dev):
        if name == "resnet":
            return resnet.ResNet18({"width": 8, "lr": 0.01}, device=dev)
        return vit.ViT(vit.ViTConfig(image_size=16, d_model=128, n_heads=2,
                                     d_ff=256, n_layers=2), device=dev)

    if name == "vit":
        x = np.ascontiguousarray(x[:, 8:24, 8:24])
    init = make("cpu").init_params(14)
    runs = {}
    for dev in (cuda_device, "cpu"):
        model = make(dev)
        model.params = init
        trainer = Trainer(max_epochs=1, device=dev, precision="f32",
                          log_every_n_steps=1, enable_checkpointing=False)
        before = (attention.flash_forward.launches,
                  attention.flash_backward_fused.launches)
        trainer.fit(model, DataLoader(ArrayDataset(x, y), batch_size=4))
        if dev != "cpu" and name == "vit":
            assert (attention.flash_forward.launches - before[0],
                    attention.flash_backward_fused.launches - before[1]) \
                == (6, 6)
        runs[str(dev)] = ([r["train_loss"] for r in trainer.logger.history],
                          model.params)
    (lg, pg), (lc, pc) = runs[str(cuda_device)], runs["cpu"]
    assert len(lg) == 3
    np.testing.assert_allclose(lg, lc, rtol=1e-3)

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: v for key, sub in tree.items()
                    for k, v in flat(sub, f"{prefix}/{key}").items()}
        return {prefix: tree}

    for key, want in flat(pc).items():
        assert _rel_l2(flat(pg)[key].cpu(), want) <= 1e-3, key


# K5 at the training forward's rows (Trainer(int8_matmul=True)): the GPT
# MLP's two products at 1, 4 and 16 sequences of 1024 tokens (16384 rows
# is the bench config's batch 16)
K5_TRAIN_SHAPES = [(m, k, n) for m in (1024, 4096, 16384)
                   for k, n in ((768, 3072), (3072, 768))]


@pytest.mark.parametrize("m,k,n", K5_TRAIN_SHAPES)
def test_cuda_int8_matmul_at_training_rows(cuda_device, m, k, n):
    x, wq, scale = _q8_half_operands(m, k, n, bf16, cuda_device)
    before = quant.int8_matmul.launches
    got = quant.int8_matmul(x, wq, scale)
    torch.cuda.synchronize()
    assert quant.int8_matmul.launches == before + 1
    assert got.dtype == bf16 and got.shape == (m, n)
    _assert_within_an_ulp(got, quant.int8_matmul_reference(x, wq, scale))


def test_cuda_int8_ste_matches_cpu(cuda_device):
    """The straight-through product of the int8 training forward on the
    card (bf16 x, f32 master, K5 forward, cuBLAS f32 backward without
    TF32) against the same function on the CPU (the plain product): the
    forward within one bf16 ulp of each output plus 1e-5 of the largest
    (K5's tolerance), both cotangents within 1e-4 relative L2 (f32
    products summed in other orders; gx rounded to bf16 on both
    sides)."""
    from ray_lightning_accelerators_tpu_torch.models.transformer import (
        _Int8SteMatmul)
    g = torch.Generator().manual_seed(7)
    x = torch.randn(2048, 768, generator=g).to(bf16)
    w = torch.randn(768, 3072, generator=g) * 768 ** -0.5
    dy = torch.randn(2048, 3072, generator=g).to(bf16)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        xd = x.to(dev).requires_grad_()
        wd = w.to(dev).requires_grad_()
        before = quant.int8_matmul.launches
        y = _Int8SteMatmul.apply(xd, wd)
        gx, gw = torch.autograd.grad(y, (xd, wd), dy.to(dev))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert quant.int8_matmul.launches == before + 1
        out[dev.type] = [t.detach().cpu() for t in (y, gx, gw)]
    (y, gx, gw), (yc, gxc, gwc) = out["cuda"], out["cpu"]
    assert y.dtype == gx.dtype == bf16 and gw.dtype == f32
    _assert_within_an_ulp(y, yc)
    for a, b in ((gx, gxc), (gw, gwc)):
        assert _rel_l2(a.float(), b.float()) <= 1e-4


@pytest.mark.parametrize("experts", [1, 4])
def test_cuda_quantize_weights_matches_cpu_bitwise(cuda_device, experts):
    """``quantize_weights`` (and the training forward's per-channel
    quantization) on the card gives the CPU's int8 weights and scales
    bit for bit: the scale is ``amax / 127`` rounded once on both (a CUDA
    tensor divided by a Python scalar would be multiplied by its
    reciprocal, an ulp off on some columns)."""
    from ray_lightning_accelerators_tpu_torch.models.transformer import (
        GPT, TransformerConfig, _channel_quant)
    cfg = TransformerConfig(vocab_size=512, d_model=256, n_heads=4,
                            d_ff=1024, n_layers=2, num_experts=experts)
    params = GPT(cfg, device="cpu").init_params(seed=5)

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: v for key, sub in tree.items()
                    for k, v in flat(sub, f"{prefix}/{key}").items()}
        return {prefix: tree}

    def to_card(tree):
        if isinstance(tree, dict):
            return {k: to_card(v) for k, v in tree.items()}
        return tree.to(cuda_device)

    cpu = flat(GPT.quantize_weights(params))
    card = flat(GPT.quantize_weights(to_card(params)))
    assert cpu.keys() == card.keys()
    for name, t in cpu.items():
        assert torch.equal(card[name].cpu(), t), name
    w = params["layers"]["mlp"]["wi"][0].reshape(256, -1)
    for a, b in zip(_channel_quant(w), _channel_quant(w.to(cuda_device))):
        assert torch.equal(a, b.cpu())


@pytest.mark.parametrize("extra,k2_per_step", [
    (dict(num_experts=4), 2), (dict(remat=True, remat_policy="dots"), 4),
    (dict(remat=True, remat_policy="everything"), 2)])
def test_cuda_moe_and_remat_fit_f32_matches_cpu(cuda_device, extra,
                                                k2_per_step):
    """Three f32 Trainer.fit steps of a 2-layer MoE GPT and of remat
    under two policies on the card against the CPU port (the dense f32
    parity's tolerances: per-step loss 1e-3 relative, params 1e-3
    relative L2), with K2's launches a step: one a layer, two a layer
    when the backward recomputes the layer."""
    from ray_lightning_accelerators_tpu_torch import DataLoader, Trainer
    from ray_lightning_accelerators_tpu_torch.data.loader import (
        ArrayDataset)
    from ray_lightning_accelerators_tpu_torch.models.transformer import (
        GPT, TransformerConfig)
    from ray_lightning_accelerators_tpu_torch.ops import attention
    cfg = TransformerConfig(vocab_size=256, d_model=128, n_heads=2,
                            d_ff=256, n_layers=2, max_seq_len=64,
                            loss_chunk_rows=100, **extra)
    init = GPT(cfg, device="cpu").init_params(seed=11)
    starts = np.random.default_rng(12).integers(0, 256, 12)
    data = ((starts[:, None] + np.arange(64)[None]) % 256).astype(np.int32)
    runs = {}
    for dev in (cuda_device, "cpu"):
        model = GPT(cfg, device=dev, lr=1e-3)
        model.params = init
        trainer = Trainer(max_epochs=1, device=dev, precision="f32",
                          log_every_n_steps=1, enable_checkpointing=False)
        before = attention.flash_forward.launches
        trainer.fit(model, DataLoader(ArrayDataset(data), batch_size=4))
        if dev != "cpu":
            assert attention.flash_forward.launches == before + \
                3 * k2_per_step
        runs[str(dev)] = ([r["train_loss"] for r in trainer.logger.history],
                          model.params)
    (lg, pg), (lc, pc) = runs[str(cuda_device)], runs["cpu"]
    np.testing.assert_allclose(lg, lc, rtol=1e-3)

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: v for key, sub in tree.items()
                    for k, v in flat(sub, f"{prefix}/{key}").items()}
        return {prefix: tree}

    for name, want in flat(pc).items():
        assert _rel_l2(flat(pg)[name].cpu(), want) <= 1e-3, name


# --------------------------------------------------------------------- #
# The compressed gradient exchange's arithmetic (parallel/collectives.py) #
# --------------------------------------------------------------------- #
def _exchange_inputs(seed=3):
    rng = np.random.default_rng(seed)
    ties = np.array([127.0, 2.5, 3.5, -0.5, 0.5, -2.5, 1.5, -126.5] * 32,
                    np.float32)
    return np.concatenate([rng.normal(size=8192).astype(np.float32),
                           np.zeros(256, np.float32), ties,
                           (rng.normal(size=256) * 1e-30).astype(np.float32),
                           (rng.normal(size=512) * 3e4).astype(np.float32)])


def test_cuda_quantize_blocks_matches_cpu_bitwise(cuda_device):
    """The block quantizer decides a discrete outcome (the int8 value), so
    the card must round as the CPU port does: q, the scales (``maxabs /
    127`` divided by a tensor, never multiplied by a reciprocal) and the
    dequantized values bitwise, on random blocks, an all-zero block, exact
    .5 ties, denormal-scale and large blocks."""
    from ray_lightning_accelerators_tpu_torch.parallel import collectives
    v = torch.from_numpy(_exchange_inputs())
    q, s = collectives.quantize_blocks(v, 256)
    gq, gs = collectives.quantize_blocks(v.to(cuda_device), 256)
    assert torch.equal(gq.cpu(), q)
    assert torch.equal(gs.cpu().view(torch.int32), s.view(torch.int32))
    assert torch.equal(collectives.dequantize_blocks(gq, gs).cpu(),
                       collectives.dequantize_blocks(q, s))


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_cuda_exchange_arithmetic_matches_cpu_bitwise(cuda_device, mode):
    """The two-phase exchange's arithmetic on the card against the CPU
    port, bitwise: a world of one rank (its collectives are copies) runs
    quantize -> dequantize and sum -> divide -> re-quantize ->
    dequantize with error feedback for a replicated leaf and the owner's
    chunk of a sharded one; then phase 1's sum of two ranks' blocks and
    its division by 2, as rank 0 of two does it."""
    from ray_lightning_accelerators_tpu_torch.parallel import collectives
    cfg = collectives.ExchangeConfig(mode=mode)
    rng = np.random.default_rng(5)
    g = rng.normal(size=(300, 64)).astype(np.float32)
    r = (rng.normal(size=300 * 64) * 1e-3).astype(np.float32)
    out = {}
    for dev in (torch.device("cpu"), cuda_device):
        ex = collectives.GradExchange(dev)
        gt, rt = torch.from_numpy(g).to(dev), torch.from_numpy(r).to(dev)
        mean, res = ex.exchange_leaf(gt, rt, cfg)
        _, chunk_pad = collectives._fsdp_chunk_elems(g.shape, 0, 1, cfg)
        rs = torch.zeros(chunk_pad, device=dev)
        rs[:r.size] = rt
        shard, res_rs = ex.exchange_rs_leaf(gt, rs, 0, cfg)
        out[dev.type] = [t.cpu() for t in (mean, res, shard, res_rs)]
        assert ex.stats()["compressed_exchanges"] == 2
    for a, b in zip(out["cpu"], out["cuda"]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    # phase 1 of two ranks: the peers' dequantized blocks summed, halved
    two = torch.from_numpy(_exchange_inputs()[:8192].reshape(2, -1))
    sums = {}
    for dev in (torch.device("cpu"), cuda_device):
        q, s = collectives.quantize_blocks(two.to(dev).reshape(-1), 256)
        own = collectives._div((q.float().reshape(2, -1, 256)
                                * s.reshape(2, -1, 1)).sum(0), 2)
        sums[dev.type] = [t.cpu() for t in collectives.quantize_blocks(
            own.reshape(-1), 256)]
    assert torch.equal(sums["cpu"][0], sums["cuda"][0])
    assert torch.equal(sums["cpu"][1].view(torch.int32),
                       sums["cuda"][1].view(torch.int32))


def _card_world(n):
    """``n`` gloo ranks sharing the card (NCCL refuses two ranks on one
    device), each failing within 60 s."""
    from ray_lightning_accelerators_tpu_torch.runtime.bootstrap import (
        DistributedWorld)
    return DistributedWorld(n, devices=["cuda:0"] * n, backend="gloo",
                            timeout_s=60.0)


def test_cuda_row_split_int8_scales_match_cpu_bitwise(cuda_device):
    """``int8_matmul`` under the tensor axis: two ranks on the card each
    hold half the rows of a ``wo [f, d]`` (the split contraction); the
    column maxima cross the tensor group (gloo on CUDA tensors) and each
    rank divides by 127 and rounds on the card.  Every rank's scales and
    its rows' int8 values equal the CPU port's quantization of the whole
    weight bit for bit (a card that multiplied by 1/127 instead would
    move a scale by an ulp and a weight by a step)."""
    from ray_lightning_accelerators_tpu_torch.models.transformer import (
        _channel_quant)
    from . import torch_boring
    import functools
    w = (np.random.default_rng(9).standard_normal((3072, 768))
         * 3072 ** -0.5).astype(np.float32)
    w[17] *= 30.0       # rank 0's rows hold every column's maximum
    w[2000, ::2] *= 60.0  # rank 1's rows hold half of them
    world = _card_world(2)
    try:
        ranks = world.run(functools.partial(
            torch_boring.int8_scale_body, w=w, shape={"tensor": 2},
            device="cuda:0"))
    finally:
        world.shutdown()
    ranks.sort(key=lambda r: r["tensor"])
    q8, scale, _ = _channel_quant(torch.from_numpy(w))
    np.testing.assert_array_equal(
        np.concatenate([r["q8"] for r in ranks]), q8.numpy())
    for r in ranks:
        np.testing.assert_array_equal(r["scale"].view(np.int32),
                                      scale.numpy().view(np.int32))


def test_cuda_pipeline_gradients_match_sequential(cuda_device):
    """The GPipe schedule over two ranks sharing the card (4 ``tanh``
    layers, 4 microbatches, f32): the output equals the sequential stack
    on the card to 1e-5 and each stage's layer gradients of
    ``sum(out**2)`` equal the sequential ones to 1e-4, the bounds of
    tests/test_pipeline.py.  Gloo has no point-to-point path for CUDA
    tensors, so the activations hop by all-gather and select."""
    from . import torch_boring
    import functools
    rng = np.random.default_rng(0)
    params = {"w": (rng.standard_normal((4, 64, 64)) * 0.15)
              .astype(np.float32),
              "b": (rng.standard_normal((4, 64)) * 0.1).astype(np.float32)}
    x = rng.standard_normal((32, 64)).astype(np.float32)
    world = _card_world(2)
    try:
        ranks = world.run(functools.partial(
            torch_boring.pipeline_body, params=params, x=x,
            shape={"pipeline": 2}, microbatches=4, device="cuda:0"))
    finally:
        world.shutdown()
    ref = {k: torch.from_numpy(v).to(cuda_device).requires_grad_(True)
           for k, v in params.items()}
    out = torch_boring._tanh_stage(ref, torch.from_numpy(x).to(cuda_device))
    (out ** 2).sum().backward()
    for r in ranks:
        np.testing.assert_allclose(r["out"], out.detach().cpu().numpy(),
                                   atol=1e-5, rtol=1e-5)
        s = r["stage"]
        for k in ("w", "b"):
            np.testing.assert_allclose(
                r[f"d{k}"], ref[k].grad[2 * s:2 * s + 2].cpu().numpy(),
                atol=1e-4, rtol=1e-4)
        assert r["comms"]["ppermute_via"] == "all_gather"


def test_cuda_activation_tree_crosses_the_object_store_bitwise(cuda_device):
    """The MPMD handoff of activations on the card: a bf16 CUDA tree goes
    to_wire -> the shm store -> from_wire and comes back on the card bit
    for bit (bf16 as its int16 words), f32 and ints unchanged."""
    from ray_lightning_accelerators_tpu_torch.parallel.mpmd import handoff
    from ray_lightning_accelerators_tpu_torch.runtime.object_store import (
        ObjectStore)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    tree = {"act": torch.randn(2, 1024, 768, device=cuda_device,
                               generator=g).to(bf16),
            "grad": [torch.randn(2, 1024, 768, device=cuda_device,
                                 generator=g).to(bf16),
                     torch.randn(300, 300, device=cuda_device, generator=g)],
            "ids": torch.arange(12, dtype=torch.int32, device=cuda_device)}
    wire = handoff.to_wire(tree)
    with ObjectStore() as store:
        ref = store.put(wire)
        assert len(ref.segments) == 3  # the three large leaves in shm
        back = handoff.from_wire(store.get(ref, copy=False), cuda_device)
        store.release(ref)
    pairs = [(tree["act"], back["act"]), (tree["grad"][0], back["grad"][0]),
             (tree["grad"][1], back["grad"][1]), (tree["ids"], back["ids"])]
    for a, b in pairs:
        assert b.device.type == "cuda" and b.dtype == a.dtype
        assert torch.equal(_bits(a) if a.is_floating_point() else a,
                           _bits(b) if b.is_floating_point() else b)


# --------------------------------------------------------------------- #
# The single-card defaults on the card: the prefetch pipeline's stream,   #
# the guard vector, the device dataset cache                              #
# --------------------------------------------------------------------- #
def test_cuda_device_prefetcher_is_bitwise_a_synchronous_copy(cuda_device):
    """50 batches through the pipeline (pinned host memory, a side stream,
    the consumer's stream waiting on each batch's event) while a long
    product runs on the default stream before each hand-over: every
    placed batch equals a synchronous ``.to()`` of the same host batch,
    also after the ring's buffers were freed and reused."""
    from ray_lightning_accelerators_tpu_torch.data.prefetch import (
        prefetch_pipeline, to_device)
    rng = np.random.default_rng(0)
    host = [{"x": rng.standard_normal((256, 1024)).astype(np.float32),
             "y": rng.integers(0, 1000, 256)} for _ in range(50)]
    a = torch.randn(2048, 2048, device=cuda_device)
    pipe = prefetch_pipeline(iter(host), 2,
                             lambda b: to_device(b, cuda_device, pin=True),
                             device=cuda_device)
    got = []
    try:
        for placed in pipe:
            for _ in range(4):
                a = torch.tanh(a @ a) * 0.5   # keeps the stream busy
            # a consumer-side use, then a copy kept past the ring's reuse
            got.append({k: (v + 0).clone() for k, v in placed.items()})
    finally:
        pipe.close()
    torch.cuda.synchronize()
    assert len(got) == 50
    for g, h in zip(got, host):
        assert torch.equal(g["x"], torch.from_numpy(h["x"]).to(cuda_device))
        assert torch.equal(g["y"], torch.from_numpy(h["y"]).to(cuda_device))


def _guarded_boring_fit(device):
    from ray_lightning_accelerators_tpu_torch import DataLoader, Trainer
    from ray_lightning_accelerators_tpu_torch.data.loader import (
        ArrayDataset)
    from tests.torch_boring import BoringModel
    x = np.random.default_rng(0).standard_normal((64, 32)).astype(
        np.float32)
    model = BoringModel(device=device)
    t = Trainer(device=device, precision="f32", max_epochs=3, seed=0,
                enable_checkpointing=False, log_every_n_steps=1,
                cache_dataset_on_device=False)
    t.fit(model, DataLoader(ArrayDataset(x), batch_size=8, shuffle=True))
    return t


def test_cuda_guard_vector_matches_cpu(cuda_device):
    """24 guarded f32 steps on the card and on the CPU port: the guard
    vectors within 1e-5 relative, the healthy count exact."""
    card = _guarded_boring_fit("cuda")._state.guard_ema.cpu()
    cpu = _guarded_boring_fit("cpu")._state.guard_ema
    torch.testing.assert_close(card, cpu, rtol=1e-5, atol=1e-7)
    assert float(card[1]) == 24.0 and float(card[2]) == 0.0


def test_cuda_cached_gather_equals_host_placement(cuda_device):
    """Every batch the cache gathers on the card equals the host-fed
    batch placed there, bit for bit (two arrays, shuffled, the rows of
    rank 1 of 2)."""
    from ray_lightning_accelerators_tpu_torch import DataLoader, Trainer
    from ray_lightning_accelerators_tpu_torch.data.loader import (
        ArrayDataset)
    from ray_lightning_accelerators_tpu_torch.data.prefetch import (
        to_device)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((96, 3, 8)).astype(np.float32)
    y = rng.integers(0, 10, 96)
    loader = DataLoader(ArrayDataset(x, y), batch_size=16, shuffle=True)
    loader._inject_sampler(2, 1, shuffle=True)
    t = Trainer(device="cuda", cache_dataset_on_device="auto")
    assert t._build_device_cache(loader)
    src = t._cached_epoch_source(loader)
    host = list(loader)
    for (kind, idx), hb in zip(src, host):
        assert kind == "cached"
        for got, want in zip(t._gather_cached(idx),
                             to_device(hb, torch.device("cuda"))):
            assert torch.equal(got, want)


def test_cuda_sync_span_waits_for_the_card(cuda_device):
    """A ``sync=True`` span whose handle holds a CUDA tensor closes only
    after the card finished it: a long chain of matmuls enqueued inside
    takes the span past its launch time, and the result is ready at
    exit (the stream has nothing left)."""
    from ray_lightning_accelerators_tpu_torch.utils.profiler import Profiler
    x = torch.randn(2048, 2048, device=cuda_device) * 1e-3
    for _ in range(3):   # cuBLAS's first calls, outside the spans
        x @ x
    torch.cuda.synchronize()
    prof, lazy = Profiler(sync=True), Profiler(sync=False)
    for p in (lazy, prof):
        with p.span("chain") as h:
            y = x
            for _ in range(40):
                y = y @ x
            h.set({"y": y})
        if p is prof:
            assert torch.cuda.current_stream().query()
        torch.cuda.synchronize()
    assert prof.summary()["chain"]["total_s"] > \
        lazy.summary()["chain"]["total_s"]


def test_cuda_device_memory_stats_keys(cuda_device):
    """The card's allocator counters under the JAX package's names: a
    fresh 64 MiB tensor shows in ``bytes_in_use`` and its peak, and the
    limit is the card's memory."""
    from ray_lightning_accelerators_tpu_torch.utils import profiler
    before = profiler.device_bytes_in_use() or 0
    t = torch.empty(64 << 20, dtype=torch.uint8, device=cuda_device)
    stats = profiler.device_memory_stats()
    assert len(stats) == torch.cuda.device_count()
    s = stats[torch.cuda.current_device()]
    assert {"bytes_in_use", "peak_bytes_in_use", "bytes_limit",
            "bytes_reserved"} <= set(s)
    assert s["bytes_in_use"] >= before + (64 << 20)
    assert s["peak_bytes_in_use"] >= s["bytes_in_use"]
    assert s["bytes_limit"] == torch.cuda.get_device_properties(
        cuda_device).total_memory
    del t


def test_cuda_sanitizer_records_and_leaves_cuda_tensors_alone(cuda_device,
                                                             tmp_path,
                                                             monkeypatch):
    """The SPMD sanitizer over a one-rank gloo world holding CUDA
    tensors: each call records the tensor's shape and dtype (metadata:
    no copy, no sync), spills before the call, and the collective's
    result is bitwise what it is without the sanitizer."""
    import torch.distributed as dist

    from ray_lightning_accelerators_tpu_torch.testing import spmd_sanitizer
    monkeypatch.setenv("RLA_TPU_TELEMETRY_DIR", str(tmp_path))
    x = torch.randn(3, 5, device=cuda_device).to(torch.bfloat16)
    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1,
                            rank=0)
    try:
        plain = x.clone()
        dist.all_reduce(plain)
        san = spmd_sanitizer.install(rank=0)
        try:
            watched = x.clone()
            dist.all_reduce(watched)
            dist.broadcast(watched, 0)
        finally:
            spmd_sanitizer.uninstall()
    finally:
        dist.destroy_process_group()
    assert torch.equal(watched, plain) and watched.is_cuda
    seq = san.sequence()
    assert [(e["op"], e["shape"], e["dtype"]) for e in seq] == [
        ("all_reduce", [3, 5], "bfloat16"), ("broadcast", [3, 5], "bfloat16")]
    assert spmd_sanitizer.gather_sequences(str(tmp_path))["rank0"]["n"] == 2
