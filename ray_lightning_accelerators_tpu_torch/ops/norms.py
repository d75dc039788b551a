"""RMSNorm: the hand-written CUDA kernel and its plain PyTorch version.

Port of the JAX package's ``ops/norms.py`` (``rms_norm``,
``rms_norm_reference``).  The kernel replaces the TPU kernel
``_rms_kernel`` (that file, line 50); its source and design note are in
``csrc/norms.cu``.  It is bound by device memory at large row counts and
by launch cost at the serve engine's decode sizes.

``rms_norm`` takes its plain version for a tensor on the CPU and launches
the kernel for a CUDA tensor; there is no fallback between the two.  It
is differentiable: as the JAX package's ``_rms_bwd`` takes the VJP of
``rms_norm_reference``, the backward recomputes the plain version under
autograd (plain PyTorch on either device; the TPU has no backward kernel
for it either).  ``LayerNorm`` (the TPU's ``_ln_kernel``) has no model caller yet and is
ported in a later slice.
"""

from __future__ import annotations

import torch

from . import _build


def rms_norm_reference(x: torch.Tensor, scale: torch.Tensor,
                       eps: float = 1e-6) -> torch.Tensor:
    """Plain version: f32 mean of squares over the last axis, then
    ``x * rsqrt(ms + eps) * scale``, cast back to x's dtype."""
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


def _rms_norm_forward(x: torch.Tensor, scale: torch.Tensor,
                      eps: float) -> torch.Tensor:
    d = x.shape[-1]
    if x.device.type == "cpu":
        return rms_norm_reference(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm: unsupported device {x.device}")
    code = _build.dtype_code(x, "rms_norm")
    if scale.dtype not in (torch.float32, x.dtype):
        scale = scale.float()
    _build.check_operands("rms_norm", x, scale)
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return out
    lib = _build.library("norms")
    err = lib.rla_rms_norm(x.data_ptr(), scale.data_ptr(), out.data_ptr(),
                           rows, d, float(eps), code,
                           int(scale.dtype == torch.float32),
                           _build.stream_of(x))
    _build.check(err, "rms_norm", "norms")
    rms_norm.launches += 1
    return out


class _RmsNorm(torch.autograd.Function):
    """The kernel forward; the backward is the VJP of the plain version."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _rms_norm_forward(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        with torch.enable_grad():
            xd = x.detach().requires_grad_()
            sd = scale.detach().requires_grad_()
            gx, gs = torch.autograd.grad(
                rms_norm_reference(xd, sd, ctx.eps), (xd, sd), g)
        return gx, gs, None


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis.  x: [..., d], scale: [d].
    Differentiable in x and scale."""
    d = x.shape[-1]
    if tuple(scale.shape) != (d,):
        raise ValueError(f"rms_norm: scale must have shape ({d},), got "
                         f"{tuple(scale.shape)}")
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RmsNorm.apply(x, scale, eps)
    return _rms_norm_forward(x, scale, eps)


# kernel launches since the last reset (chip_smoke.py reads it to prove
# the serve path went through the kernel)
rms_norm.launches = 0
