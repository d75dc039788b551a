"""Ring attention: exact attention over sequence chunks, the K/V chunks
rotating around the ranks of the sequence axis (context parallelism).

Port of the JAX package's ``parallel/ring_attention.py``.  Each rank
holds a contiguous chunk of the sequence of Q, K and V; the K/V chunks
travel around the ring by ``ppermute`` (``parallel/collectives.py``:
rank i sends to ``(i + 1) % S``, the backward sends the gradient back
the other way) while every rank folds each visiting chunk into an
online-softmax accumulator (running max m, denominator l, weighted sum
acc) in f32.  As in the JAX package this is plain framework code
(einsums in a loop, which autograd differentiates as JAX differentiates
through the ``fori_loop``), not a kernel: the flash kernels do not run
on this path.

- ``ring_attention``: the per-rank body over this rank's chunks;
- ``ring_attention_sharded``: the entry over the GLOBAL arrays, which
  cuts this rank's chunk and returns this rank's chunk of the output
  (the sequence stays split, as the JAX entry's ``out_specs``); without
  a sequence axis it is ``flash_attention``.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import collectives as coll
from . import mesh as mesh_lib

_NEG_INF = -1e30


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: mesh_lib.RankMesh, causal: bool = True,
                   scale: Optional[float] = None) -> torch.Tensor:
    """q, k, v: ``[batch, heads, seq_local, head_dim]``, this rank's
    chunk of the sequence axis of ``mesh``.  Returns the attention output
    of the local queries over the whole sequence."""
    b, h, s_local, d = q.shape
    scale_v = scale if scale is not None else d ** -0.5
    axis = mesh_lib.SEQUENCE_AXIS
    n, me = mesh.size(axis), mesh.coord(axis)
    group, members = mesh.group(axis), mesh.members.get(axis, [mesh.rank])
    q32 = q.float() * scale_v
    rows = torch.arange(s_local, device=q.device)[:, None]
    cols = torch.arange(s_local, device=q.device)[None, :]
    m = torch.full((b, h, s_local, 1), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, s_local, 1), dtype=torch.float32,
                    device=q.device)
    acc = torch.zeros((b, h, s_local, d), dtype=torch.float32,
                      device=q.device)
    k_cur, v_cur = k, v
    for i in range(n):
        src = (me - i) % n      # the rank whose chunk is visiting
        s = torch.einsum("bhqd,bhkd->bhqk", q32, k_cur.float())
        if causal:
            # global causal mask: query me*s_local+r vs key src*s_local+c
            mask = (me * s_local + rows) >= (src * s_local + cols)
            s = torch.where(mask[None, None], s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p,
                                         v_cur.float())
        m = m_new
        if i < n - 1:
            k_cur = coll.ppermute(k_cur, group, members)
            v_cur = coll.ppermute(v_cur, group, members)
    l = torch.where(l == 0.0, torch.ones_like(l), l)  # no visible keys
    return (acc / l).to(q.dtype)


def seq_chunk(x: torch.Tensor, mesh: mesh_lib.RankMesh,
              dim: int = 2) -> torch.Tensor:
    """This rank's contiguous chunk of ``dim`` along the sequence axis."""
    n = mesh.size(mesh_lib.SEQUENCE_AXIS)
    c = x.shape[dim] // n
    return x.narrow(dim, mesh.coord(mesh_lib.SEQUENCE_AXIS) * c, c)


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, mesh: mesh_lib.Mesh,
                           causal: bool = True,
                           scale: Optional[float] = None) -> torch.Tensor:
    """q, k, v: ``[batch, heads, seq, head_dim]`` GLOBAL arrays (each
    rank holds them whole).  Returns this rank's chunk of the output,
    ``[batch, heads, seq / S, head_dim]``; with no sequence axis (S = 1)
    the whole output of ``flash_attention``."""
    seq_size = mesh_lib.mesh_axis_size(mesh, mesh_lib.SEQUENCE_AXIS)
    if seq_size == 1:
        from ..ops.attention import flash_attention
        return flash_attention(q, k, v, causal, scale)
    if q.shape[2] % seq_size != 0:
        raise ValueError(
            f"ring attention needs the sequence length ({q.shape[2]}) "
            f"divisible by the sequence axis size ({seq_size}); pad the "
            f"sequence or change the mesh")
    return ring_attention(seq_chunk(q, mesh), seq_chunk(k, mesh),
                          seq_chunk(v, mesh), mesh, causal=causal,
                          scale=scale)
