"""Fused linear + softmax-cross-entropy for language-model heads.

Port of the JAX package's ``ops/losses.py`` (``linear_cross_entropy_reference``,
``fused_linear_cross_entropy``, ``_streamed_sums`` with its custom VJP).
The naive head materialises ``[rows, V]`` logits and keeps the softmax for
the backward: at the GPT bench shape (16 x 1023 rows, V 50304) that is
3.3 GB of f32 that exists only to be reduced to one scalar.
``fused_linear_cross_entropy`` streams ``chunk_rows`` row chunks through
the unembedding product instead: each chunk's logits live only while the
chunk is reduced to its loss / correct / valid sums, and the backward
recomputes each chunk's softmax and contracts it at once into dH and dW.
Peak extra memory is O(chunk_rows x V).

The chunk products are ``torch`` matrix products (plain XLA in the JAX
package, not Pallas kernels): bf16 operands with f32 accumulation and an
f32 result, as XLA's ``preferred_element_type=f32`` gives.  Negative
targets are masked out.

Over ranks: ``fused_linear_cross_entropy(mesh=)`` takes a mesh without
a sequence, tensor or pipeline axis, as the JAX package's batch-axes
``shard_map`` path does (an expert axis holds the same rows on each of
its ranks); each rank then streams its own rows (the local call), and
the trainer averages the ranks' means.  A tensor or sequence axis takes
``vocab_parallel_cross_entropy`` instead (the JAX GPT's materialised
loss, whose logits are split over the vocabulary): the logsumexp from an
all-reduced max and sum, the target logit and the smoothing's row sum
from all-reduces of each shard's part, the accuracy from the global
argmax with the lowest index winning a tie.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from ..parallel import collectives as coll
from ..parallel import mesh as mesh_lib

DEFAULT_CHUNK_ROWS = 1024


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with f32 accumulation and an f32 result.  bf16/f16
    operands on the card keep their type in the product (tensor cores);
    elsewhere both sides are widened first, which computes the same exact
    products of the narrow values."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16) \
            and b.dtype == a.dtype:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def linear_cross_entropy_reference(h: torch.Tensor, w: torch.Tensor,
                                   targets: torch.Tensor
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Naive path: materialises logits.  h: [rows, d], w: [d, V], targets:
    [rows] int (negative = masked out).  Returns (mean loss over valid
    rows, accuracy over valid rows)."""
    valid = targets >= 0
    tgt = torch.where(valid, targets, 0).long()
    logits = h.float() @ w.float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt_logit = logits.gather(-1, tgt[:, None])[:, 0]
    losses = torch.where(valid, lse - tgt_logit, 0.0)
    correct = valid & (logits.argmax(-1) == tgt)
    n = valid.sum().clamp(min=1)
    return losses.sum() / n, correct.sum() / n


def _chunk_stats(h_c, w, tgt_c, label_smoothing, z_loss):
    """Per-chunk forward: (sum loss, sum correct, n valid), f32.

    Per row: ``lse - (1-eps) tgt_logit - (eps/V) sum(logits)`` (cross
    entropy against the eps-smoothed target) plus ``z_loss * lse**2``."""
    valid = tgt_c >= 0
    tgt = torch.where(valid, tgt_c, 0).long()
    logits = _mm_f32(h_c, w)
    lse = torch.logsumexp(logits, dim=-1)
    # the target logit from the gathered weight columns, f32 products of
    # the operands (a [chunk] row-wise dot, not a pick from the logits)
    tgt_logit = (h_c.float() * w[:, tgt].T.float()).sum(-1)
    row_loss = lse - (1.0 - label_smoothing) * tgt_logit
    if label_smoothing:
        row_loss = row_loss - (label_smoothing / w.shape[1]) * logits.sum(-1)
    if z_loss:
        row_loss = row_loss + z_loss * lse * lse
    loss_sum = torch.where(valid, row_loss, 0.0).sum()
    correct = (valid & (logits.argmax(-1) == tgt)).sum().float()
    return loss_sum, correct, valid.sum().float()


class _StreamedSums(torch.autograd.Function):
    """(loss_sum, correct_sum, n_valid) streamed over row chunks; only
    loss_sum carries a gradient (the JAX package's ``_streamed_sums``)."""

    @staticmethod
    def forward(ctx, h, w, targets, chunk_rows, label_smoothing, z_loss):
        sums = [_chunk_stats(h[i:i + chunk_rows], w,
                             targets[i:i + chunk_rows], label_smoothing,
                             z_loss)
                for i in range(0, h.shape[0], chunk_rows)]
        ls, cs, n = (torch.stack(x).sum() for x in zip(*sums))
        ctx.save_for_backward(h, w, targets)
        ctx.args = (chunk_rows, label_smoothing, z_loss)
        ctx.mark_non_differentiable(cs, n)
        return ls, cs, n

    @staticmethod
    def backward(ctx, g, _g_correct, _g_n):
        h, w, targets = ctx.saved_tensors
        chunk_rows, eps, z = ctx.args
        scale = g.float()
        V = w.shape[1]
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        dh = torch.empty_like(h)
        for i in range(0, h.shape[0], chunk_rows):
            h_c, t_c = h[i:i + chunk_rows], targets[i:i + chunk_rows]
            valid = t_c >= 0
            tgt = torch.where(valid, t_c, 0).long()
            logits = _mm_f32(h_c, w)
            # d row_loss / d logits = p (1 + 2 z lse) - (1-eps) onehot - eps/V
            gl = torch.softmax(logits, dim=-1)
            if z:
                gl = gl * (1.0 + 2.0 * z * torch.logsumexp(
                    logits, dim=-1, keepdim=True))
            rows = torch.arange(gl.shape[0], device=gl.device)
            gl[rows, tgt] -= 1.0 - eps
            if eps:
                gl = gl - eps / V
            gl = torch.where(valid[:, None], gl, 0.0) * scale
            glc = gl.to(h.dtype)  # the products run in the compute dtype
            dh[i:i + chunk_rows] = _mm_f32(glc, w.T).to(h.dtype)
            dw += _mm_f32(h_c.T, glc)
        return dh, dw.to(w.dtype), None, None, None, None


def fused_linear_cross_entropy(h: torch.Tensor, w: torch.Tensor,
                               targets: torch.Tensor,
                               chunk_rows: int = DEFAULT_CHUNK_ROWS,
                               mesh=None, label_smoothing: float = 0.0,
                               z_loss: float = 0.0
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming LM-head loss.  h: [rows, d], w: [d, V], targets: [rows]
    int (negative entries masked).  Returns (mean_loss f32, accuracy f32);
    only ``mean_loss`` is differentiable.  ``chunk_rows`` bounds the live
    logits block [chunk_rows, V]."""
    if any(mesh_lib.mesh_axis_size(mesh, a) > 1 for a in (
            mesh_lib.SEQUENCE_AXIS, mesh_lib.TENSOR_AXIS,
            mesh_lib.PIPELINE_AXIS)):
        raise ValueError(
            "fused_linear_cross_entropy streams whole-vocabulary rows "
            "split over the batch axes only; a mesh with a sequence, "
            f"tensor or pipeline axis > 1 ({dict(mesh.shape)}) takes the "
            "materialised vocab-parallel loss "
            "(vocab_parallel_cross_entropy)")
    if h.ndim != 2 or w.ndim != 2 or h.shape[1] != w.shape[0] \
            or tuple(targets.shape) != (h.shape[0],):
        raise ValueError(
            f"fused_linear_cross_entropy: expected h [rows, d], w [d, V], "
            f"targets [rows], got {tuple(h.shape)}, {tuple(w.shape)}, "
            f"{tuple(targets.shape)}")
    if chunk_rows < 1:
        raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
    ls, cs, n = _StreamedSums.apply(h, w, targets, int(chunk_rows),
                                    float(label_smoothing), float(z_loss))
    n = n.clamp(min=1.0)
    return ls / n, cs / n


def vocab_parallel_cross_entropy(logits: torch.Tensor,
                                 targets: torch.Tensor, mesh: Any,
                                 label_smoothing: float = 0.0,
                                 z_loss: float = 0.0
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """The materialised LM loss's sums over logits split on the
    vocabulary over the tensor axis of ``mesh`` (a ``RankMesh``; rank t
    holds the columns ``[t V/T, (t+1) V/T)``).  logits: ``[rows, V/T]``
    f32; targets: ``[rows]`` global ids (negative = masked).  Returns
    ``(loss sum, correct count, valid count)`` over these rows, the same
    on every tensor rank; only the loss sum is differentiable.  Per row,
    as the JAX GPT's: ``lse - (1-eps) tgt_logit - (eps/V) sum(logits) +
    z lse**2``."""
    group = mesh.group(mesh_lib.TENSOR_AXIS)
    vl = logits.shape[-1]
    start = mesh.coord(mesh_lib.TENSOR_AXIS) * vl
    vocab = vl * mesh.size(mesh_lib.TENSOR_AXIS)
    m = coll.all_reduce_value(logits.detach().amax(-1), group, "max")
    se = coll.reduce_from_model(torch.exp(logits - m[:, None]).sum(-1),
                                group)
    lse = m + torch.log(se)
    valid = targets >= 0
    local = targets - start
    mine = valid & (local >= 0) & (local < vl)
    picked = logits.gather(-1, torch.where(mine, local, 0).long()[:, None])
    tgt = coll.reduce_from_model(
        torch.where(mine, picked[:, 0], 0.0), group)
    row = lse - (1.0 - label_smoothing) * tgt
    if label_smoothing:
        row = row - (label_smoothing / vocab) * coll.reduce_from_model(
            logits.sum(-1), group)
    if z_loss:
        row = row + z_loss * lse * lse
    loss_sum = torch.where(valid, row, 0.0).sum()
    # the global argmax: the largest value, the lowest index of a tie
    with torch.no_grad():
        lmax = logits.amax(-1)
        gmax = coll.all_reduce_value(lmax, group, "max")
        cand = torch.where(lmax == gmax, logits.argmax(-1) + start,
                           torch.full_like(targets, vocab))
        arg = coll.all_reduce_value(cand, group, "min")
        correct = (valid & (arg == targets)).sum().float()
    return loss_sum, correct, valid.sum().float()
