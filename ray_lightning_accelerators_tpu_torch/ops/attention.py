"""Flash attention forward: the hand-written CUDA kernel and its plain
PyTorch versions.

Port of the forward half of the JAX package's ``ops/attention.py``
(``attention_reference``, ``flash_attention``, ``_flash_forward``).  The
kernel replaces the TPU kernel ``_flash_kernel`` (that file, line 83);
its source and design note are in ``csrc/attention.cu``.  At the GPT
prefill shapes it is bound by reading q, k, v and writing the output once.

``flash_forward`` takes its plain version for tensors on the CPU and
launches the kernel for CUDA tensors; there is no fallback between the
two, and no shape the kernel declines: every ``q_len, k_len >= 1`` runs,
the ragged tail of the last tile masked.  The kernel takes head dims 64
and 128 and float32, bfloat16 and float16 inputs; another head dim on the
card is a ``ValueError``.  The backward (the TPU's ``_flash_bwd_*``
kernels) comes with the training slice, so a CUDA call whose inputs
require grad raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.module import not_ported
from . import _build

_NEG_INF = -1e30
SUPPORTED_HEAD_DIMS = (64, 128)


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


def flash_forward(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
                  scale: Optional[float] = None, causal: bool = False,
                  window: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q3 ``[bh, q_len, d]``, k3 and v3 ``[bh, k_len, d]`` (batch and
    heads folded) -> (out ``[bh, q_len, d]`` in q's dtype, lse
    ``[bh, q_len]`` f32)."""
    if q3.ndim != 3 or k3.shape != v3.shape or k3.ndim != 3 \
            or k3.shape[0] != q3.shape[0] or k3.shape[2] != q3.shape[2]:
        raise ValueError(
            f"flash_forward: expected q [bh, q_len, d] and k, v "
            f"[bh, k_len, d], got q {tuple(q3.shape)}, k {tuple(k3.shape)}, "
            f"v {tuple(v3.shape)}")
    if not (q3.dtype == k3.dtype == v3.dtype):
        raise TypeError(f"flash_forward: q, k, v dtypes differ: {q3.dtype}, "
                        f"{k3.dtype}, {v3.dtype}")
    bh, q_len, d = q3.shape
    k_len = k3.shape[1]
    if q_len < 1 or k_len < 1:
        raise ValueError(f"flash_forward: q_len {q_len} and k_len {k_len} "
                         "must be >= 1")
    if window is not None and window < 1:
        raise ValueError(f"flash_forward: window must be >= 1, got {window}")
    if q3.device.type == "cpu":
        return attention_reference_lse(q3, k3, v3, causal, scale, window)
    if q3.device.type != "cuda":
        raise ValueError(f"flash_forward: unsupported device {q3.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q3, k3, v3)):
        raise not_ported("the flash-attention backward (gradients through "
                         "the CUDA kernel)", "training")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(
            f"flash_forward: the CUDA kernel takes head_dim in "
            f"{SUPPORTED_HEAD_DIMS}, got {d}")
    code = _build.dtype_code(q3, "flash_forward")
    _build.check_operands("flash_forward", q3, k3, v3)
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """Fused attention.  q, k, v: ``[batch, heads, seq, head_dim]`` (k and
    v with full heads: a GQA caller repeats its kv heads first).
    ``window`` enables sliding-window causal attention (see
    :func:`attention_reference`).

    ``block_q`` / ``block_k`` are accepted for signature parity with the
    JAX package, where they size the TPU kernel's tiles; they do not steer
    the CUDA kernel, whose tiles are fixed by its head dim."""
    del block_q, block_k
    b, h, q_len, d = q.shape
    k_len = k.shape[2]
    out, _ = flash_forward(q.reshape(b * h, q_len, d).contiguous(),
                           k.reshape(b * h, k_len, d).contiguous(),
                           v.reshape(b * h, k_len, d).contiguous(),
                           scale=scale, causal=causal, window=window)
    return out.reshape(b, h, q_len, d)


# kernel launches since the last reset (chip_smoke.py reads it to prove
# the prefill path went through the kernel)
flash_forward.launches = 0
