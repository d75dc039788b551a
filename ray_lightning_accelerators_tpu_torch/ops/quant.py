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
widen int8 in registers and never write a dequantized copy.  bf16 and
f16 x run on the tensor cores, f32 x on the CUDA cores.  ``int8_matmul``
is one launch: a thread-block cluster splits K (:func:`launch_plan`) and
sums its ranks' partial tiles in shared memory.

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

# one block for each of the H100's 132 SMs: the K split of int8_matmul
# is sized against it (scripts/torch_int8_plan_sweep.py times the others)
_TARGET_BLOCKS = 132
# csrc/quant.cu: a block's columns (tensor-core body, f32 body), k step
_TILE_COLS, _F32_TILE_COLS, _K_CHUNK = 64, 128, 32
_MAX_CLUSTER = 8                # the portable thread-block cluster size


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


def launch_plan(k: int, n: int,
                tile_cols: int = _TILE_COLS) -> Tuple[int, int]:
    """(cluster, k_per_rank) for int8_matmul: the blocks of a cluster
    split K in whole 32-k chunks, as many (1-8) as bring the grid of
    ``tile_cols``-column tiles near ``_TARGET_BLOCKS``, with no empty
    rank.  The same for every M: each rank holds its k range of the
    weight and loops over every row tile of x."""
    tiles = -(-n // tile_cols)
    chunks = -(-k // _K_CHUNK)
    want = max(1, min(_MAX_CLUSTER, chunks, -(-_TARGET_BLOCKS // tiles)))
    per = -(-chunks // want)
    return -(-chunks // per), per * _K_CHUNK


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
    return _int8_matmul_cuda(x, wq, scale)


def _int8_matmul_cuda(x: torch.Tensor, wq: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """Launch K5 on x's stream: one launch, a cluster splitting K."""
    m, k = x.shape
    n = wq.shape[1]
    code = _build.dtype_code(x, "int8_matmul")
    if wq.dtype != torch.int8:
        raise TypeError(f"int8_matmul: wq must be int8, got {wq.dtype}")
    scale = scale.float()
    _build.check_operands("int8_matmul", x, wq, scale)
    cluster, per = launch_plan(
        k, n, _F32_TILE_COLS if x.dtype == torch.float32 else _TILE_COLS)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = _build.library("quant")
    err = lib.rla_int8_matmul(
        x.data_ptr(), wq.data_ptr(), scale.data_ptr(), out.data_ptr(),
        m, k, n, cluster, per, code, _build.stream_of(x))
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
    return _int8_matmul_nt_cuda(x, wq)


def _int8_matmul_nt_cuda(x: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Launch K6 on x's stream: a persistent grid over column tiles."""
    m, k = x.shape
    n = wq.shape[0]
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
