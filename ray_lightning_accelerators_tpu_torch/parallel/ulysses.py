"""Ulysses sequence parallelism: all-to-all head / sequence re-sharding.

Port of the JAX package's ``parallel/ulysses.py``.  The activations
arrive split over the sequence axis; one ``all_to_all``
(``parallel/collectives.py``) scatters the heads and gathers the
sequence, so each rank holds every position of ``heads / S`` heads;
``flash_attention`` runs unchanged on the whole sequence (the flash
kernels K2 forward and K4 or K3a + K3b backward on the card); a second
``all_to_all`` restores the sequence split.  Both all-to-alls are
differentiable (the backward is the inverse all-to-all).  Needs ``heads
% S == 0``: ring attention has no such constraint.

- ``ulysses_attention``: the per-rank body over this rank's chunks;
- ``ulysses_attention_sharded``: the entry over the GLOBAL arrays, which
  cuts this rank's chunk and returns this rank's chunk of the output;
  without a sequence axis it is ``flash_attention``.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import collectives as coll
from . import mesh as mesh_lib
from ..ops.attention import flash_attention
from .ring_attention import seq_chunk


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh: mesh_lib.RankMesh, causal: bool = True,
                      scale: Optional[float] = None,
                      block_k: Optional[int] = None) -> torch.Tensor:
    """q, k, v: ``[batch, heads, seq_local, head_dim]``, this rank's
    chunk of the sequence with every head.  Returns the local chunk of
    the output, equal to attention over the whole sequence.
    ``block_k`` picks the flash backward (``ops/attention.py``)."""
    axis = mesh_lib.SEQUENCE_AXIS
    n = mesh.size(axis)
    h = q.shape[1]
    if h % n != 0:
        raise ValueError(
            f"ulysses needs heads ({h}) divisible by the sequence axis "
            f"size ({n}); use ring attention instead")
    group = mesh.group(axis)

    def seq_to_heads(x):
        # [b, h, s/n, d] -> [b, h/n, s, d]: scatter heads, gather seq
        return coll.all_to_all(x, group, split_dim=1, concat_dim=2)

    out = flash_attention(seq_to_heads(q), seq_to_heads(k),
                          seq_to_heads(v), causal, scale, block_k=block_k)
    return coll.all_to_all(out, group, split_dim=2, concat_dim=1)


def ulysses_attention_sharded(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, mesh: mesh_lib.Mesh,
                              causal: bool = True,
                              scale: Optional[float] = None
                              ) -> torch.Tensor:
    """q, k, v: ``[batch, heads, seq, head_dim]`` GLOBAL arrays (each
    rank holds them whole).  Returns this rank's chunk of the output,
    ``[batch, heads, seq / S, head_dim]``; with no sequence axis the
    whole output of ``flash_attention``."""
    seq_size = mesh_lib.mesh_axis_size(mesh, mesh_lib.SEQUENCE_AXIS)
    if seq_size == 1:
        return flash_attention(q, k, v, causal, scale)
    if q.shape[2] % seq_size != 0:
        raise ValueError(
            f"ulysses needs the sequence length ({q.shape[2]}) divisible by "
            f"the sequence axis size ({seq_size}); pad the sequence or "
            f"change the mesh")
    if q.shape[1] % seq_size != 0:
        raise ValueError(
            f"ulysses needs heads ({q.shape[1]}) divisible by the sequence "
            f"axis size ({seq_size}); use ring attention instead")
    return ulysses_attention(seq_chunk(q, mesh), seq_chunk(k, mesh),
                             seq_chunk(v, mesh), mesh, causal=causal,
                             scale=scale)
