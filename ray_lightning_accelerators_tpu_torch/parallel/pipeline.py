"""Pipeline parallelism: the GPipe microbatch schedule over the
``pipeline`` axis.

Port of the JAX package's ``parallel/pipeline.py`` (``pipeline_apply``).
There a partial-manual ``shard_map`` over the pipeline axis runs the
schedule as one ``lax.scan`` and autodiff derives the backward pipeline;
here each rank of the pipeline group is one stage and holds its
``L / S`` contiguous layers (the rules lay every ``layers`` leaf out as
``(("pipeline", 0),)``), and the schedule is a Python loop under autograd:

- ``M + S - 1`` ticks; at tick ``t`` stage 0 feeds microbatch
  ``clip(t, 0, M - 1)``, every other stage the activation its
  predecessor produced at tick ``t - 1``;
- the activations hop stage -> stage + 1 through the differentiable
  ``ppermute`` of ``parallel/collectives.py`` (its backward sends the
  cotangents back a stage), a cyclic shift whose wrap-around (the last
  stage's output to stage 0) stage 0 never selects;
- the last stage keeps its outputs of ticks ``S - 1 .. M + S - 2``, the
  M microbatches in order; the buffer reaches every stage as a masked
  all-reduce (the other stages add zeros), whose backward is the
  identity: every stage computes the same loss from it, and only the last
  stage's cotangent enters the schedule, so each layer's gradient counts
  once;
- bubble ticks compute on stale inputs and their outputs are masked out,
  GPipe's (S - 1) / (M + S - 1) utilization cost.

Every rank builds the same graph -- the stage's input and the buffer
are selected by ``torch.where`` on a rank-dependent condition, never by a
Python branch -- so the backward reaches every ``ppermute`` on every
rank, in one order, and the collectives pair up.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from . import collectives as coll
from . import mesh as mesh_lib

# the JAX GPT's refusals under the pipeline axis, text for text
MOE_REFUSAL = ("MoE layers under pipeline parallelism are not supported "
               "yet; use expert/tensor/data axes (set pipeline=1)")
DROPOUT_REFUSAL = ("dropout under pipeline parallelism is not supported "
                   "(per-stage rng would correlate masks); set dropout=0")


def check_layers(n_layers: int, stages: int) -> None:
    """The JAX ``pipeline_apply``'s refusal of a layer count the stages
    cannot split."""
    if n_layers % stages != 0:
        raise ValueError(
            f"layer count {n_layers} not divisible by {stages} pipeline "
            f"stages; choose n_layers as a multiple of the pipeline axis "
            f"size")


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x: torch.Tensor, mesh: Any,
                   num_microbatches: int) -> torch.Tensor:
    """Run ``x`` through every pipeline stage.

    ``stage_fn(stage_params, x_mb)`` applies this rank's stage (its
    ``L / S`` layers) to one microbatch; ``stage_params`` is this rank's
    part of the layer stack, passed through as it is; ``x`` is the whole
    batch ``[B, ...]`` (``B % num_microbatches == 0``), the same on every
    stage; ``mesh`` is the ``RankMesh``.  Returns ``[B, ...]``, the same
    on every stage of the group."""
    stages = mesh_lib.mesh_axis_size(mesh, mesh_lib.PIPELINE_AXIS)
    if stages == 1:
        return stage_fn(stage_params, x)
    m = num_microbatches
    b = x.shape[0]
    if b % m != 0:
        raise ValueError(f"batch {b} % microbatches {m} != 0")
    group = mesh.group(mesh_lib.PIPELINE_AXIS)
    members = mesh.members[mesh_lib.PIPELINE_AXIS]
    stage = mesh.coord(mesh_lib.PIPELINE_AXIS)
    first = torch.tensor(stage == 0, device=x.device)
    last = torch.tensor(stage == stages - 1, device=x.device)
    x_mb = x.reshape((m, b // m) + tuple(x.shape[1:]))
    cur = torch.zeros_like(x_mb[0])
    outs = []
    ticks = m + stages - 1
    for t in range(ticks):
        inp = torch.where(first, x_mb[min(t, m - 1)], cur)
        y = stage_fn(stage_params, inp)
        if t >= stages - 1:
            outs.append(y)
        if t < ticks - 1:
            cur = coll.ppermute(y, group, members)
    buf = torch.where(last, torch.stack(outs), torch.zeros_like(outs[0]))
    # *g*: the masked buffers summed, the gradient passed on as it is
    return coll.reduce_from_model(buf, group).reshape(
        (b,) + tuple(x.shape[1:]))
