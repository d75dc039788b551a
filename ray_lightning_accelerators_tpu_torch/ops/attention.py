"""Flash attention: the hand-written CUDA kernels and their plain PyTorch
versions, forward and backward.

Port of the JAX package's ``ops/attention.py`` (``attention_reference``,
``flash_attention`` with its custom VJP, ``_flash_forward``,
``_flash_backward``, ``_flash_backward_fused``).  The forward kernel
replaces the TPU kernel ``_flash_kernel`` (that file, line 83; source and
design note in ``csrc/attention.cu``); the backward kernels replace
``_flash_bwd_dq_kernel`` (:226), ``_flash_bwd_dkv_kernel`` (:256) and
``_flash_bwd_fused_kernel`` (:290) (``csrc/attention_bwd.cu``).

``flash_forward`` and ``flash_backward`` take their plain versions for
tensors on the CPU and launch the kernels for CUDA tensors; there is no
fallback between the two, and no shape the kernels decline: every
``q_len, k_len >= 1`` runs, the ragged tail of the last tile masked.  The
kernels take head dims 64 and 128 and float32, bfloat16 and float16
inputs; another head dim on the card is a ``ValueError``.  The route is
the dtype: bfloat16 and float16 run every kernel on the tensor cores
(``flash_fwd_kernel_tc``, ``flash_bwd_dq_kernel_tc``,
``flash_bwd_kv_kernel_tc``: wgmma with f32 accumulators), float32 on the
scalar CUDA-core bodies (``*_f32``), which keep full f32 products.  A
row that sees no key at all (a window with ``q >= k_len + window - 1``)
gets the mean of v and lse -1e30 in both the kernel and the plain
version, as the softmax over its -1e30 scores gives; every backward
kernel, as the plain backward, then takes its P as 1 over every key.

``flash_attention`` is differentiable: its backward recomputes the
probabilities from the saved log-sum-exp.  On the card it runs the fused
one-pass kernel (K4) when the key length fits one key block
(``k_len <= block_k``, the JAX package's ``block_k == k_len`` case for
128-aligned lengths) and the split pair (K3a for dq, K3b for dk and dv)
otherwise; ``block_k`` is the config's ``flash_block_k`` or 512.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

_NEG_INF = -1e30
SUPPORTED_HEAD_DIMS = (64, 128)
# the JAX package's default key block (``_default_blocks``): the backward
# takes the fused kernel when the whole key length fits one block
DEFAULT_BLOCK_K = 512


def _masked_logits(q: torch.Tensor, k: torch.Tensor, causal: bool,
                   scale: Optional[float],
                   window: Optional[int]) -> torch.Tensor:
    """f32 scores ``q k^T * scale`` over ``[..., q_len, k_len]`` with the
    causal (top-left aligned) and window masks set to -1e30."""
    q_len, d = q.shape[-2], q.shape[-1]
    k_len = k.shape[-2]
    scale = scale if scale is not None else d ** -0.5
    logits = torch.einsum("...qd,...kd->...qk", q.float(), k.float()) * scale
    if causal or window is not None:
        qi = torch.arange(q_len, device=q.device)[:, None]
        ki = torch.arange(k_len, device=q.device)[None, :]
        mask = qi >= ki
        if window is not None:
            mask &= (qi - ki) < window
        logits = logits.masked_fill(~mask, _NEG_INF)
    return logits


def _probs_times_v(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    # probabilities rounded to v's dtype before the product, the product
    # accumulated in f32 and rounded once to v's dtype
    return torch.einsum("...qk,...kd->...qd", probs.to(v.dtype).float(),
                        v.float()).to(v.dtype)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False, scale: Optional[float] = None,
                        window: Optional[int] = None) -> torch.Tensor:
    """Plain attention.  q, k, v: ``[..., seq, head_dim]``.  ``window``:
    sliding-window causal attention, query i sees keys
    ``[i - window + 1, i]`` (it implies the causal mask)."""
    probs = torch.softmax(_masked_logits(q, k, causal, scale, window), -1)
    return _probs_times_v(probs, v)


def attention_reference_lse(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool = False,
                            scale: Optional[float] = None,
                            window: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version that also returns the per-row log-sum-exp of the
    masked scores (f32, ``[..., q_len]``): what the kernel computes."""
    logits = _masked_logits(q, k, causal, scale, window)
    probs = torch.softmax(logits, -1)
    return _probs_times_v(probs, v), torch.logsumexp(logits, -1)


def _check_qkv(what: str, q3: torch.Tensor, k3: torch.Tensor,
               v3: torch.Tensor, window: Optional[int]) -> None:
    if q3.ndim != 3 or k3.shape != v3.shape or k3.ndim != 3 \
            or k3.shape[0] != q3.shape[0] or k3.shape[2] != q3.shape[2]:
        raise ValueError(
            f"{what}: expected q [bh, q_len, d] and k, v [bh, k_len, d], "
            f"got q {tuple(q3.shape)}, k {tuple(k3.shape)}, "
            f"v {tuple(v3.shape)}")
    if not (q3.dtype == k3.dtype == v3.dtype):
        raise TypeError(f"{what}: q, k, v dtypes differ: {q3.dtype}, "
                        f"{k3.dtype}, {v3.dtype}")
    if q3.shape[1] < 1 or k3.shape[1] < 1:
        raise ValueError(f"{what}: q_len {q3.shape[1]} and k_len "
                         f"{k3.shape[1]} must be >= 1")
    if window is not None and window < 1:
        raise ValueError(f"{what}: window must be >= 1, got {window}")


def _cuda_checks(what: str, *tensors: torch.Tensor) -> int:
    """Device, head dim, dtype and layout checks before a launch; returns
    the kernels' dtype code."""
    q3 = tensors[0]
    if q3.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q3.device}")
    if q3.shape[-1] not in SUPPORTED_HEAD_DIMS:
        raise ValueError(
            f"{what}: the CUDA kernel takes head_dim in "
            f"{SUPPORTED_HEAD_DIMS}, got {q3.shape[-1]}")
    code = _build.dtype_code(q3, what)
    _build.check_operands(what, *tensors)
    return code


def flash_forward(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
                  scale: Optional[float] = None, causal: bool = False,
                  window: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q3 ``[bh, q_len, d]``, k3 and v3 ``[bh, k_len, d]`` (batch and
    heads folded) -> (out ``[bh, q_len, d]`` in q's dtype, lse
    ``[bh, q_len]`` f32).  On the card K2: bf16 and f16 on the tensor
    cores, f32 on the scalar body."""
    _check_qkv("flash_forward", q3, k3, v3, window)
    bh, q_len, d = q3.shape
    k_len = k3.shape[1]
    if q3.device.type == "cpu":
        return attention_reference_lse(q3, k3, v3, causal, scale, window)
    code = _cuda_checks("flash_forward", q3, k3, v3)
    out = torch.empty_like(q3)
    lse = torch.empty((bh, q_len), dtype=torch.float32, device=q3.device)
    scale_v = scale if scale is not None else d ** -0.5
    lib = _build.library("attention")
    err = lib.rla_flash_attention(
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), out.data_ptr(),
        lse.data_ptr(), bh, q_len, k_len, d, float(scale_v), int(causal),
        int(window) if window is not None else -1, code,
        _build.stream_of(q3))
    _build.check(err, "flash_forward", "attention")
    flash_forward.launches += 1
    return out, lse


def flash_backward_reference(q3: torch.Tensor, k3: torch.Tensor,
                             v3: torch.Tensor, o3: torch.Tensor,
                             lse: torch.Tensor, g3: torch.Tensor,
                             scale: Optional[float] = None,
                             causal: bool = False,
                             window: Optional[int] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Plain backward: (dq, dk, dv) for cotangent ``g3`` of the output
    ``o3``, recomputing ``P = exp(S - lse)`` from the saved f32 log-sum-exp
    ``lse [bh, q_len]`` with the arithmetic of the TPU kernels' shared
    ``_bwd_block``: -1e30 masks, ``dS = P (dP - delta) scale`` with
    ``delta = rowsum(dO O)`` in f32, P rounded to dO's dtype before
    ``P^T dO``, dS rounded to q's / k's dtype before ``dS^T q`` /
    ``dS k``, f32 sums, outputs in the inputs' dtype."""
    scale = scale if scale is not None else q3.shape[-1] ** -0.5
    s = _masked_logits(q3, k3, causal, scale, window)
    p = torch.exp(s - lse[..., None])
    gf = g3.float()
    dp = torch.einsum("...qd,...kd->...qk", gf, v3.float())
    delta = (gf * o3.float()).sum(-1)
    ds = p * (dp - delta[..., None]) * scale
    dv = torch.einsum("...qk,...qd->...kd", p.to(g3.dtype).float(), gf)
    dk = torch.einsum("...qk,...qd->...kd", ds.to(q3.dtype).float(),
                      q3.float())
    dq = torch.einsum("...qk,...kd->...qd", ds.to(k3.dtype).float(),
                      k3.float())
    return dq.to(q3.dtype), dk.to(k3.dtype), dv.to(v3.dtype)


def _bwd_args(what, q3, k3, v3, g3, lse, delta, scale, causal, window):
    """Checks before a backward launch; returns the dtype code, the
    operand pointers and the sizes."""
    code = _cuda_checks(what, q3, k3, v3, g3, lse, delta)
    if g3.dtype != q3.dtype or g3.shape != q3.shape:
        raise TypeError(f"{what}: grad {g3.dtype} {tuple(g3.shape)} does "
                        f"not match q {q3.dtype} {tuple(q3.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != tuple(q3.shape[:2]):
            raise TypeError(f"{what}: {name} must be f32 "
                            f"{tuple(q3.shape[:2])}, got {t.dtype} "
                            f"{tuple(t.shape)}")
    bh, q_len, d = q3.shape
    scale_v = scale if scale is not None else d ** -0.5
    ptrs = (q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), g3.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    sizes = (bh, q_len, k3.shape[1], d, float(scale_v), int(causal),
             int(window) if window is not None else -1)
    return code, ptrs, sizes


def flash_backward_dq(q3, k3, v3, g3, lse, delta, scale=None, causal=False,
                      window=None) -> torch.Tensor:
    """K3a on the card: dq for CUDA operands (``delta = rowsum(dO O)``,
    ``[bh, q_len]`` f32, as ``lse``); bf16 and f16 run on the tensor
    cores, f32 on the scalar body."""
    code, ptrs, sizes = _bwd_args("flash_backward_dq", q3, k3, v3, g3, lse,
                                  delta, scale, causal, window)
    dq = torch.empty_like(q3)
    err = _build.library("attention_bwd").rla_flash_bwd_dq(
        *ptrs, dq.data_ptr(), *sizes, code, _build.stream_of(q3))
    _build.check(err, "flash_backward_dq", "attention_bwd")
    flash_backward_dq.launches += 1
    return dq


def flash_backward_dkv(q3, k3, v3, g3, lse, delta, scale=None, causal=False,
                       window=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3b on the card: (dk, dv) for CUDA operands; bf16 and f16 run on
    the tensor cores, f32 on the scalar body."""
    code, ptrs, sizes = _bwd_args("flash_backward_dkv", q3, k3, v3, g3,
                                  lse, delta, scale, causal, window)
    dk, dv = torch.empty_like(k3), torch.empty_like(v3)
    err = _build.library("attention_bwd").rla_flash_bwd_dkv(
        *ptrs, dk.data_ptr(), dv.data_ptr(), *sizes, code,
        _build.stream_of(q3))
    _build.check(err, "flash_backward_dkv", "attention_bwd")
    flash_backward_dkv.launches += 1
    return dk, dv


def flash_backward_fused(q3, k3, v3, g3, lse, delta, scale=None,
                         causal=False, window=None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4 on the card: (dq, dk, dv) in one pass for CUDA operands (bf16
    and f16 on the tensor cores, f32 on the scalar body); dq is summed in
    an f32 buffer by atomic adds and cast to q's dtype."""
    code, ptrs, sizes = _bwd_args("flash_backward_fused", q3, k3, v3, g3,
                                  lse, delta, scale, causal, window)
    dq32 = torch.zeros(q3.shape, dtype=torch.float32, device=q3.device)
    dk, dv = torch.empty_like(k3), torch.empty_like(v3)
    err = _build.library("attention_bwd").rla_flash_bwd_fused(
        *ptrs, dq32.data_ptr(), dk.data_ptr(), dv.data_ptr(), *sizes, code,
        _build.stream_of(q3))
    _build.check(err, "flash_backward_fused", "attention_bwd")
    flash_backward_fused.launches += 1
    return dq32.to(q3.dtype), dk, dv


def flash_backward(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
                   o3: torch.Tensor, lse: torch.Tensor, g3: torch.Tensor,
                   scale: Optional[float] = None, causal: bool = False,
                   window: Optional[int] = None,
                   block_k: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of attention over folded ``[bh, seq, d]`` operands,
    from the forward's output ``o3`` and f32 ``lse [bh, q_len]`` and the
    cotangent ``g3``.  The plain version on the CPU; on the card the fused
    kernel (K4) when ``k_len <= block_k`` (default 512), else K3a + K3b."""
    _check_qkv("flash_backward", q3, k3, v3, window)
    if o3.shape != q3.shape or g3.shape != q3.shape \
            or tuple(lse.shape) != tuple(q3.shape[:2]):
        raise ValueError(
            f"flash_backward: expected out and grad {tuple(q3.shape)} and "
            f"lse {tuple(q3.shape[:2])}, got {tuple(o3.shape)}, "
            f"{tuple(g3.shape)}, {tuple(lse.shape)}")
    if q3.device.type == "cpu":
        return flash_backward_reference(q3, k3, v3, o3, lse, g3, scale,
                                        causal, window)
    # delta_i = rowsum(dO * O): a small elementwise pass outside the
    # kernels, as in the JAX package (plain XLA there)
    delta = (g3.float() * o3.float()).sum(-1)
    lse = lse.contiguous()
    if k3.shape[1] <= (block_k or DEFAULT_BLOCK_K):
        return flash_backward_fused(q3, k3, v3, g3, lse, delta, scale,
                                    causal, window)
    dq = flash_backward_dq(q3, k3, v3, g3, lse, delta, scale, causal, window)
    dk, dv = flash_backward_dkv(q3, k3, v3, g3, lse, delta, scale, causal,
                                window)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The forward kernel, saving its output and lse; the backward kernels
    (the JAX package's ``_fa_fwd`` / ``_fa_bwd``)."""

    @staticmethod
    def forward(ctx, q3, k3, v3, scale, causal, window, block_k):
        out, lse = flash_forward(q3, k3, v3, scale=scale, causal=causal,
                                 window=window)
        ctx.save_for_backward(q3, k3, v3, out, lse)
        ctx.args = (scale, causal, window, block_k)
        return out

    @staticmethod
    def backward(ctx, g):
        q3, k3, v3, out, lse = ctx.saved_tensors
        scale, causal, window, block_k = ctx.args
        dq, dk, dv = flash_backward(q3, k3, v3, out, lse, g.contiguous(),
                                    scale, causal, window, block_k)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """Fused attention.  q, k, v: ``[batch, heads, seq, head_dim]`` (k and
    v with full heads: a GQA caller repeats its kv heads first).
    ``window`` enables sliding-window causal attention (see
    :func:`attention_reference`).

    Differentiable in q, k and v.  ``block_k`` picks the backward kernel
    (see :func:`flash_backward`); ``block_q`` is accepted for signature
    parity with the JAX package, where it sizes the TPU kernel's tiles.
    The CUDA kernels' tiles are fixed by the head dim."""
    del block_q
    b, h, q_len, d = q.shape
    k_len = k.shape[2]
    q3 = q.reshape(b * h, q_len, d).contiguous()
    k3 = k.reshape(b * h, k_len, d).contiguous()
    v3 = v.reshape(b * h, k_len, d).contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out = _FlashAttention.apply(q3, k3, v3, scale, causal, window,
                                    block_k)
    else:
        out, _ = flash_forward(q3, k3, v3, scale=scale, causal=causal,
                               window=window)
    return out.reshape(b, h, q_len, d)


# kernel launches since the last reset (chip_smoke.py reads them to prove
# a path went through the kernels)
flash_forward.launches = 0
flash_backward_dq.launches = 0
flash_backward_dkv.launches = 0
flash_backward_fused.launches = 0
