"""Port parity for flash attention, forward and backward (ops/attention.py of the
PyTorch port) on the CPU, where the port takes its plain version: the
same seeded numpy inputs go through the JAX package's TPU kernel in
interpret mode (``_flash_forward(..., interpret=True)``, 128-multiple
lengths) or its ``attention_reference`` (ragged lengths), and through the
port's ``flash_forward`` / ``flash_attention``.  f32 with TF32 off: the
two sides differ only by summation order, measured at ~6e-7 on outputs
of magnitude ~1 and lse of magnitude ~5; the stated tolerance is 1e-5
relative plus 1e-5 absolute."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ray_lightning_accelerators_tpu.ops.attention import (
    _flash_forward as jax_flash_forward, attention_reference as jax_ref,
    flash_attention_grads_interpret as jax_grads_interpret,
    flash_attention_interpret as jax_flash_interpret)
from ray_lightning_accelerators_tpu_torch.ops import attention

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RTOL = ATOL = 1e-5


def _qkv(bh, s, d=64, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((bh, s, d)).astype(dtype)
                 for _ in range(3))


def _np_lse(q, k, causal, window, scale):
    """Log-sum-exp of the masked scores in f64 (the -1e30 mask)."""
    s = np.einsum("bqd,bkd->bqk", q.astype(np.float64),
                  k.astype(np.float64)) * scale
    if causal or window is not None:
        qi = np.arange(q.shape[1])[:, None]
        ki = np.arange(k.shape[1])[None, :]
        mask = qi >= ki
        if window is not None:
            mask &= (qi - ki) < window
        s = np.where(mask[None], s, -1e30)
    m = s.max(-1, keepdims=True)
    return (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("s,causal,window", [
    (128, True, None), (128, False, None), (256, True, None),
    (256, False, None), (128, True, 64), (256, True, 64),
    (256, True, 100), (256, False, 100)])
def test_flash_forward_matches_jax_kernel(s, causal, window):
    """Out and lse against the TPU kernel in interpret mode (128-blocks,
    so S = 256 walks two k blocks with causal/window block skipping)."""
    q, k, v = _qkv(4, s, seed=s + (window or 0))
    jo, jl = jax_flash_forward(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), 64 ** -0.5, causal, 128, 128,
                               interpret=True, window=window)
    before = attention.flash_forward.launches
    to, tl = attention.flash_forward(torch.from_numpy(q),
                                     torch.from_numpy(k),
                                     torch.from_numpy(v), causal=causal,
                                     window=window)
    assert attention.flash_forward.launches == before   # plain version
    assert to.dtype == torch.float32 and tuple(tl.shape) == (4, s)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl)[:, 0], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 64), (False, 100)])
def test_flash_forward_ragged_matches_reference(causal, window):
    """S = 200 (not a tile multiple): out against the JAX package's
    attention_reference, lse against a float64 numpy log-sum-exp."""
    q, k, v = _qkv(4, 200, seed=7)
    ref = jax_ref(jnp.asarray(q)[None], jnp.asarray(k)[None],
                  jnp.asarray(v)[None], causal=causal, window=window)[0]
    to, tl = attention.flash_forward(torch.from_numpy(q),
                                     torch.from_numpy(k),
                                     torch.from_numpy(v), causal=causal,
                                     window=window)
    np.testing.assert_allclose(to.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tl.numpy(),
                               _np_lse(q, k, causal, window, 64 ** -0.5),
                               rtol=RTOL, atol=ATOL)


def test_flash_attention_4d_matches_jax_interpret():
    """The [b, h, s, d] entry with an explicit scale; block_q/block_k are
    accepted and change nothing."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 3, 128, 64)).astype(np.float32)
               for _ in range(3))
    ref = jax_flash_interpret(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=True, scale=0.1)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    a = attention.flash_attention(tq, tk, tv, causal=True, scale=0.1)
    b = attention.flash_attention(tq, tk, tv, causal=True, scale=0.1,
                                  block_q=16, block_k=512)
    assert torch.equal(a, b)
    np.testing.assert_allclose(a.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_plain_version_rounds_p_to_v_dtype_as_jax():
    """bf16 inputs: the probabilities are rounded to bf16 before the PV
    product and the output is bf16, as the JAX reference does.  The two
    sides round the same f32 values, so they agree to within one bf16
    rounding of the output (2^-8 relative): rtol 1e-2."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((1, 2, 96, 64)).astype(np.float32)
               for _ in range(3))
    ref = jax_ref(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                  causal=True)
    got = attention.attention_reference(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)
    # the f32 product of bf16-rounded p is what a bf16 kernel computes;
    # an unrounded p differs measurably
    unrounded = torch.softmax(attention._masked_logits(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k)), True,
        None, None), -1) @ torch.from_numpy(v).to(torch.bfloat16).float()
    assert (unrounded - got.float()).abs().max() > 0


def test_flash_forward_typed_errors_on_cpu():
    q = torch.zeros(2, 8, 64)
    with pytest.raises(ValueError, match=r"\[bh, q_len, d\]"):
        attention.flash_forward(q, torch.zeros(2, 8, 32), torch.zeros(2, 8, 32))
    with pytest.raises(TypeError, match="dtypes differ"):
        attention.flash_forward(q, q.double(), q)
    with pytest.raises(ValueError, match="window must be >= 1"):
        attention.flash_forward(q, q, q, causal=True, window=0)
    with pytest.raises(ValueError, match="unsupported device"):
        attention.flash_forward(q.to("meta"), q.to("meta"), q.to("meta"))


@pytest.mark.parametrize("s,causal,window", [
    (256, True, None), (256, False, None), (256, True, 100),
    (128, True, None), (128, False, None), (128, True, 64)])
def test_flash_backward_matches_jax_kernels(s, causal, window):
    """dq, dk and dv against the TPU backward kernels in interpret mode
    with 128 blocks: seq 256 runs the split pair (``_flash_bwd_dq_kernel``
    and ``_flash_bwd_dkv_kernel``), seq 128 the fused kernel
    (``block_k == k_len``).  The port's side is its plain version
    (``flash_backward`` on CPU tensors) and the autograd of
    ``flash_attention``.  f32, summation order only: atol 2e-5 on
    gradients of magnitude ~1."""
    rng = np.random.default_rng(s + (window or 0) + causal)
    q, k, v, g = (rng.standard_normal((1, 4, s, 64)).astype(np.float32)
                  for _ in range(4))
    want = jax_grads_interpret(*(jnp.asarray(a) for a in (q, k, v, g)),
                               causal=causal, block_q=128, block_k=128,
                               window=window)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = attention.flash_attention(tq, tk, tv, causal=causal, window=window,
                                    block_k=128)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    o3, lse = attention.flash_forward(*(torch.from_numpy(a[0]) for a in
                                        (q, k, v)), causal=causal,
                                      window=window)
    direct = attention.flash_backward(*(torch.from_numpy(a[0]) for a in
                                        (q, k, v)), o3, lse,
                                      torch.from_numpy(g[0]), causal=causal,
                                      window=window)
    for a, b, w in zip(got, direct, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=2e-5)
        np.testing.assert_allclose(b.numpy(), np.asarray(w)[0], atol=2e-5)


def test_flash_backward_typed_errors_on_cpu():
    q = torch.zeros(2, 8, 64)
    lse = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="expected out and grad"):
        attention.flash_backward(q, q, q, q, torch.zeros(2, 9), q)
    with pytest.raises(ValueError, match="window must be >= 1"):
        attention.flash_backward(q, q, q, q, lse, q, window=0)
    with pytest.raises(ValueError, match="unsupported device"):
        attention.flash_backward_dq(*(t.to("meta") for t in
                                      (q, q, q, q, lse, lse)))


def _c_entry_call(monkeypatch, name, *args, **kw):
    """Call the wrapper ``name`` with the card stubbed out (device checks,
    stream, loaded library); returns its one C entry call and checks the
    one counted launch."""
    from ray_lightning_accelerators_tpu_torch.ops import _build
    calls = []

    class FakeLibrary:
        def __getattr__(self, entry):
            return lambda *a: calls.append((entry, a)) or 0

    monkeypatch.setattr(attention, "_cuda_checks", lambda what, *t: 1)
    monkeypatch.setattr(_build, "library", lambda stem: FakeLibrary())
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    fn = getattr(attention, name)
    monkeypatch.setattr(fn, "launches", 0)
    fn(*args, **kw)
    assert fn.launches == 1
    (call,) = calls
    return call


def _assert_matches_signature(entry, args):
    from ray_lightning_accelerators_tpu_torch.ops import _build
    sig = _build.SIGNATURES[entry]
    assert len(args) == len(sig), (entry, len(args), len(sig))
    kinds = {_build._P: int, _build._I: int, _build._F: float}
    for i, (a, t) in enumerate(zip(args, sig)):
        assert isinstance(a, kinds[t]), (entry, i, a, t)


@pytest.mark.parametrize("name", ["flash_backward_dq", "flash_backward_dkv",
                                  "flash_backward_fused"])
def test_backward_wrappers_pass_their_c_signatures(monkeypatch, name):
    """What a backward wrapper hands its kernel's C entry, with the card
    stubbed out: exactly the argument count and types
    ``_build.SIGNATURES`` declares, and one counted launch.  The kernels
    themselves run only on the card."""
    q, lse = torch.zeros(2, 8, 64), torch.zeros(2, 8)
    entry, args = _c_entry_call(monkeypatch, name, q, q, q, q, lse, lse,
                                causal=True, window=4)
    _assert_matches_signature(entry, args)


def test_forward_wrapper_passes_its_c_signature(monkeypatch):
    """The same for ``flash_forward`` and ``rla_flash_attention``: meta
    tensors take it past its CPU branch (the plain version) to the
    launch, with the head dim, lengths, scale and window in their
    slots."""
    q = torch.zeros(2, 8, 64, device="meta")
    k = torch.zeros(2, 5, 64, device="meta")
    entry, args = _c_entry_call(monkeypatch, "flash_forward", q, k, k,
                                scale=0.5, causal=True, window=4)
    assert entry == "rla_flash_attention"
    _assert_matches_signature(entry, args)
    assert args[5:12] == (2, 8, 5, 64, 0.5, 1, 4)


@pytest.mark.parametrize("q_len,k_len,window,kernel", [
    (256, 128, 64, True), (300, 77, 50, False)])
def test_flash_forward_rows_that_see_no_key(q_len, k_len, window, kernel):
    """A window with q_len > k_len + window: rows q >= k_len + window - 1
    see no key, so every score of theirs is -1e30 and the softmax is
    uniform: out is the mean of v over all keys and lse is -1e30 (log
    k_len is below its ulp).  The port's plain version against the JAX
    package's attention_reference and, at 128-multiple lengths, against
    the TPU kernel in interpret mode (128 blocks: query block 1 still
    needs key block 0, so it walks every key).  Tolerance as above."""
    rng = np.random.default_rng(q_len + k_len)
    q = rng.standard_normal((2, q_len, 64)).astype(np.float32)
    k, v = (rng.standard_normal((2, k_len, 64)).astype(np.float32)
            for _ in range(2))
    to, tl = attention.flash_forward(torch.from_numpy(q),
                                     torch.from_numpy(k),
                                     torch.from_numpy(v), causal=True,
                                     window=window)
    ref = jax_ref(jnp.asarray(q)[None], jnp.asarray(k)[None],
                  jnp.asarray(v)[None], causal=True, window=window)[0]
    np.testing.assert_allclose(to.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    blind = k_len + window - 1
    np.testing.assert_allclose(
        to.numpy()[:, blind:],
        np.broadcast_to(v.mean(1, keepdims=True), (2, q_len - blind, 64)),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tl.numpy(),
                               _np_lse(q, k, True, window, 64 ** -0.5),
                               rtol=RTOL, atol=ATOL)
    assert np.all(tl.numpy()[:, blind:] == np.float32(-1e30))
    if kernel:
        jo, jl = jax_flash_forward(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), 64 ** -0.5, True, 128,
                                   128, interpret=True, window=window)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl)[:, 0],
                                   rtol=RTOL, atol=ATOL)
