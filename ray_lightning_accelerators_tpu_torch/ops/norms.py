"""RMSNorm: the hand-written CUDA kernel and its plain PyTorch version.

Port of the JAX package's ``ops/norms.py`` (``rms_norm``,
``rms_norm_reference``).  The kernel replaces the TPU kernel
``_rms_kernel`` (that file, line 50); its source and design note are in
``csrc/norms.cu``.  It is bound by device memory at large row counts and
by launch cost at the serve engine's decode sizes.

``rms_norm`` takes its plain version for a tensor on the CPU and launches
the kernel for a CUDA tensor; there is no fallback between the two.
``LayerNorm`` (the TPU's ``_ln_kernel``) has no model caller yet and is
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


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis.  x: [..., d], scale: [d]."""
    d = x.shape[-1]
    if tuple(scale.shape) != (d,):
        raise ValueError(f"rms_norm: scale must have shape ({d},), got "
                         f"{tuple(scale.shape)}")
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


# kernel launches since the last reset (chip_smoke.py reads it to prove
# the serve path went through the kernel)
rms_norm.launches = 0
