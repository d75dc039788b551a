"""int8 weight-only matrix products: the CUDA kernels and their plain
PyTorch versions.

Port of the JAX package's ``ops/quant.py``.  Two layouts,
matching how per-out-channel scales fall out of ``GPT.quantize_weights``:

- ``int8_matmul(x [M,K], wq [K,N], scale [N]) -> [M,N]``: contraction
  over the leading weight dim, scales on the output channels -- the
  q/k/v/o and MLP projections.  Replaces the TPU kernel ``_mm_kernel``
  (that file, line 55).
- ``int8_matmul_nt(x [M,K], wq [N,K]) -> [M,N]``: weight stored
  transposed (the tied-embedding unembedding ``W[V,d]``), whose scales
  vary along the contraction dim -- the caller folds them into ``x``, so
  the kernel takes no scale.  Replaces ``_mm_nt_kernel`` (line 78).

Both accumulate in f32 and return x's dtype.  Decode reads every weight
once per token, so both are bound by streaming the int8 weight from
device memory; the kernels (``csrc/quant.cu``, with their design notes)
widen int8 in registers and never write a dequantized copy.

The TPU kernels decline shapes their tiling cannot take (``supported``);
these take every ``M >= 1`` and every ``K``/``N``, masking the ragged
edges, so a q8 leaf on the card always goes through the kernel.  A
tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build

# enough blocks to give each of the H100's 132 SMs two: the K split of
# int8_matmul is sized against it
_TARGET_BLOCKS = 264
_MM_COLS, _MM_ROWS, _MM_KSTEP = 128, 16, 64   # csrc/quant.cu tile


def _check_2d(fn: str, x: torch.Tensor, wq: torch.Tensor) -> None:
    if x.ndim != 2 or wq.ndim != 2:
        raise ValueError(f"{fn}: x and wq must be 2-D, got x "
                         f"{tuple(x.shape)} and wq {tuple(wq.shape)}")
    if x.shape[0] < 1:
        raise ValueError(f"{fn}: m={x.shape[0]} rows; need m >= 1")


def int8_matmul_reference(x: torch.Tensor, wq: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """Plain version: ``(x @ wq) * scale`` in f32, cast to x's dtype."""
    return ((x.float() @ wq.float()) * scale.float()).to(x.dtype)


def int8_matmul_nt_reference(x: torch.Tensor,
                             wq: torch.Tensor) -> torch.Tensor:
    """Plain version: ``x @ wq.T`` in f32, cast to x's dtype."""
    return (x.float() @ wq.float().T).to(x.dtype)


def split_plan(m: int, k: int, n: int) -> Tuple[int, int]:
    """(splits, k_per_split) for int8_matmul: split K across the grid's z
    dimension until about ``_TARGET_BLOCKS`` blocks run, in whole k steps
    and with no empty split."""
    tiles = -(-n // _MM_COLS) * -(-m // _MM_ROWS)
    steps = -(-k // _MM_KSTEP)
    want = max(1, min(steps, -(-_TARGET_BLOCKS // tiles)))
    per = -(-steps // want)
    return -(-steps // per), per * _MM_KSTEP


def int8_matmul(x: torch.Tensor, wq: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x [M,K] (f32/bf16/f16) @ dequant(wq [K,N] int8, scale [N]) -> [M,N].

    ``scale`` is per-out-channel -- exactly
    ``x @ (wq.float() * scale[None, :])``, accumulated in f32."""
    _check_2d("int8_matmul", x, wq)
    m, k = x.shape
    k2, n = wq.shape
    if k != k2:
        raise ValueError(
            f"int8_matmul: x contraction dim {k} != wq leading dim {k2} "
            f"(x {tuple(x.shape)} @ wq {tuple(wq.shape)})")
    if tuple(scale.shape) != (n,):
        raise ValueError(
            f"int8_matmul: scale must be per-out-channel with shape "
            f"({n},), got {tuple(scale.shape)}")
    if x.device.type == "cpu":
        return int8_matmul_reference(x, wq, scale)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    code = _build.dtype_code(x, "int8_matmul")
    if wq.dtype != torch.int8:
        raise TypeError(f"int8_matmul: wq must be int8, got {wq.dtype}")
    scale = scale.float()
    _build.check_operands("int8_matmul", x, wq, scale)
    splits, per = split_plan(m, k, n)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    partial = (torch.empty((splits, m, n), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    lib = _build.library("quant")
    err = lib.rla_int8_matmul(
        x.data_ptr(), wq.data_ptr(), scale.data_ptr(), out.data_ptr(),
        partial.data_ptr() if partial is not None else None,
        m, k, n, splits, per, code, _build.stream_of(x))
    _build.check(err, "int8_matmul", "quant")
    int8_matmul.launches += 1
    return out


def int8_matmul_nt(x: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """x [M,K] @ wq[N,K]^T -> [M,N], weight int8, no scale (fold
    contraction-dim scales into x first)."""
    _check_2d("int8_matmul_nt", x, wq)
    m, k = x.shape
    n, k2 = wq.shape
    if k != k2:
        raise ValueError(
            f"int8_matmul_nt: x contraction dim {k} != wq trailing dim "
            f"{k2} (x {tuple(x.shape)} @ wq {tuple(wq.shape)}^T)")
    if x.device.type == "cpu":
        return int8_matmul_nt_reference(x, wq)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul_nt: unsupported device {x.device}")
    code = _build.dtype_code(x, "int8_matmul_nt")
    if wq.dtype != torch.int8:
        raise TypeError(f"int8_matmul_nt: wq must be int8, got {wq.dtype}")
    _build.check_operands("int8_matmul_nt", x, wq)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = _build.library("quant")
    err = lib.rla_int8_matmul_nt(x.data_ptr(), wq.data_ptr(),
                                 out.data_ptr(), m, k, n, code,
                                 _build.stream_of(x))
    _build.check(err, "int8_matmul_nt", "quant")
    int8_matmul_nt.launches += 1
    return out


# kernel launches since the last reset (chip_smoke.py reads them to prove
# the serve path went through the kernels)
int8_matmul.launches = 0
int8_matmul_nt.launches = 0
