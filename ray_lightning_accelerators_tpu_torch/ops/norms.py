"""RMSNorm and LayerNorm: the hand-written CUDA kernels and their plain
PyTorch versions.

Port of the JAX package's ``ops/norms.py`` (``rms_norm``,
``rms_norm_reference``, ``layer_norm``, ``layer_norm_reference``).  The
kernels replace the TPU kernels ``_rms_kernel`` (K1, that file, line 50)
and ``_ln_kernel`` (K7, line 57); their source and design note are in
``csrc/norms.cu``.  Both are bound by device memory at large row counts
(a persistent grid streams the rows) and by the launch and one trip to
memory at the serve engine's decode sizes (every load of a row is issued
before its first reduction).

``rms_norm`` and ``layer_norm`` take their plain versions for a tensor on
the CPU and launch their kernels for a CUDA tensor; there is no fallback
between the two.  Both are differentiable: as the JAX package's
``_rms_bwd`` and ``_ln_bwd`` take the VJP of the plain versions, the
backward recomputes the plain version under autograd (plain PyTorch on
either device; the TPU has no backward kernel for them either).  No model
of the JAX package calls ``layer_norm``; its path is the public op.
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
    if x.is_cuda:
        return _rms_norm_cuda(x, scale, eps)
    if x.device.type == "cpu":
        return rms_norm_reference(x, scale, eps)
    raise ValueError(f"rms_norm: unsupported device {x.device}")


def _rms_norm_cuda(x: torch.Tensor, scale: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """Launch K1 on x's stream (x: [..., d] on the card)."""
    d = x.shape[-1]
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


def layer_norm_reference(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, eps: float = 1e-6
                         ) -> torch.Tensor:
    """Plain version: f32 mean, then the f32 two-pass variance
    ``mean((x - mu)^2)``, ``(x - mu) * rsqrt(var + eps) * scale + bias``,
    cast back to x's dtype."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def _layer_norm_forward(x: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, eps: float) -> torch.Tensor:
    if x.is_cuda:
        return _layer_norm_cuda(x, scale, bias, eps)
    if x.device.type == "cpu":
        return layer_norm_reference(x, scale, bias, eps)
    raise ValueError(f"layer_norm: unsupported device {x.device}")


def _layer_norm_cuda(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, eps: float) -> torch.Tensor:
    """Launch K7 on x's stream (x: [..., d] on the card)."""
    d = x.shape[-1]
    code = _build.dtype_code(x, "layer_norm")
    # the kernel reads scale and bias in one type: both x's dtype, else
    # both f32 (an f32 copy is exact for any float input)
    if not (scale.dtype == bias.dtype and
            scale.dtype in (torch.float32, x.dtype)):
        scale, bias = scale.float(), bias.float()
    _build.check_operands("layer_norm", x, scale, bias)
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return out
    lib = _build.library("norms")
    err = lib.rla_layer_norm(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                             out.data_ptr(), rows, d, float(eps), code,
                             int(scale.dtype == torch.float32),
                             _build.stream_of(x))
    _build.check(err, "layer_norm", "norms")
    layer_norm.launches += 1
    return out


class _LayerNorm(torch.autograd.Function):
    """The kernel forward; the backward is the VJP of the plain version."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale, bias)
        ctx.eps = eps
        return _layer_norm_forward(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias = ctx.saved_tensors
        with torch.enable_grad():
            xd, sd, bd = (t.detach().requires_grad_()
                          for t in (x, scale, bias))
            gx, gs, gb = torch.autograd.grad(
                layer_norm_reference(xd, sd, bd, ctx.eps), (xd, sd, bd), g)
        return gx, gs, gb, None


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis.  x: [..., d], scale and bias: [d].
    Differentiable in x, scale and bias."""
    d = x.shape[-1]
    for name, p in (("scale", scale), ("bias", bias)):
        if tuple(p.shape) != (d,):
            raise ValueError(f"layer_norm: {name} must have shape ({d},), "
                             f"got {tuple(p.shape)}")
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return _LayerNorm.apply(x, scale, bias, eps)
    return _layer_norm_forward(x, scale, bias, eps)


# kernel launches since the last reset (chip_smoke.py reads them to prove
# a path went through the kernel)
rms_norm.launches = 0
layer_norm.launches = 0
