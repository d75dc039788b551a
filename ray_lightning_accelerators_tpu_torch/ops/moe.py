"""Mixture-of-experts feed-forward: top-k routing, dispatch, per-expert
GELU MLP, combine.

Port of the JAX package's ``ops/moe.py`` (``expert_capacity``,
``top_k_routing``, ``moe_mlp``, ``init_moe_params``).  As there, the layer
is GShard / Switch-shaped and written as fixed-shape products over a
``[batch, seq, experts, capacity]`` dispatch tensor: no gather or scatter
with data-dependent shapes.  Tokens over an expert's capacity are dropped
(their combine weight is 0) and ride the residual connection; the
load-balancing auxiliary loss (Switch eq. 4) is returned beside the
output for the caller to add as ``aux_weight * aux``.

The arithmetic is the JAX package's step for step, since which tokens an
expert takes depends on it: the router runs in f32; top-k is ``k``
argmax rounds over ``remaining *= 1 - onehot`` (both frameworks take the
first maximum); capacity slots go by a cumulative count per batch row,
earlier rounds and earlier positions winning; the gates are renormalised
only for ``top_k > 1``; the four einsums run in ``compute_dtype``.  The
JAX package has no Pallas kernel here (plain XLA einsums), so neither has
the port: the products are PyTorch's.

Over a ``RankMesh`` (``moe_mlp(mesh=)``) the layer computes the JAX
package's function on the ranks' parts:
- the expert axis splits ``wi`` / ``wo`` on the expert dim (and the
  tensor axis on ``d_ff``); every expert rank routes the same rows alike
  (the router is replicated), runs its local experts and combines them,
  and a sum over the expert and tensor groups (*g*) adds the partial
  outputs.  The experts' input and the gates pass *f* (the gates are
  ``[top_k, b, s]``, far smaller than the combine tensor they weigh), so
  the replicated router and the input get whole gradients on every
  rank;
- under a sequence axis the chunk is all-gathered first, so the capacity
  and the routing's running counts run over the global sequence (routing
  each chunk on its own budget would drop other tokens), and the rank's
  chunk of the output is cut back out;
- the load-balance loss's fractions are means over the global batch:
  each rank's means over its rows are averaged over the batch axes, and
  the product is taken once.  The mean's backward passes the gradient on
  as is (divided by S under a sequence axis, whose ranks each compute
  the whole sequence's value): the trainer's average of the ranks'
  gradients is then the gradient of the one global loss, as the JAX
  package takes it.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel import collectives as coll
from ..parallel import mesh as mesh_lib


def expert_capacity(seq_len: int, num_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    """Per-expert token budget of one batch row (at least 1)."""
    cap = int(math.ceil(seq_len * top_k * capacity_factor / num_experts))
    return max(cap, 1)


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: ``idx[..., None] == arange(n)``, so an index
    outside ``[0, n)`` gives a row of zeros.  A comparison, not
    ``F.one_hot``, which validates its indices on the host."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax``'s formula over the last axis: ``exp(x - max) /
    sum``, so both packages route on the same probabilities."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def top_k_routing(router_logits: torch.Tensor, top_k: int, capacity: int,
                  mesh: Optional[Any] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dispatch and combine tensors from router logits.

    ``router_logits`` ``[b, s, e]``.  Returns ``dispatch`` ``[b, s, e, c]``
    (1 where token (b, s) holds slot c of expert e), ``combine`` (the
    dispatch weighted by the gate) and the scalar load-balance loss, whose
    fractions are means over the global batch when ``mesh`` (a
    ``RankMesh``) splits it."""
    probs = _softmax(router_logits.float())
    b, s, e = probs.shape
    if top_k > e:
        raise ValueError(f"moe top_k={top_k} exceeds num_experts={e}; a "
                         "token cannot route to more experts than exist")
    masks, gates = [], []
    remaining = probs
    for _ in range(top_k):
        m = _one_hot(torch.argmax(remaining, dim=-1), e, probs.dtype)
        masks.append(m)
        gates.append(torch.sum(probs * m, dim=-1))                # [b, s]
        remaining = remaining * (1.0 - m)

    # the Switch aux loss uses the first-choice assignment fractions
    frac_tokens = torch.mean(masks[0], dim=(0, 1))
    frac_probs = torch.mean(probs, dim=(0, 1))
    if mesh is not None:
        group = mesh.group("batch")
        seq = mesh_lib.mesh_axis_size(mesh, mesh_lib.SEQUENCE_AXIS)
        if group is not None:
            frac_tokens = coll.mean_identity_grad(frac_tokens.detach(),
                                                  group)
        frac_probs = coll.mean_identity_grad(frac_probs, group,
                                             scale=1.0 / seq)
    aux = e * torch.sum(frac_tokens * frac_probs)

    if mesh is not None:
        # each rank's experts see part of the gates' gradient: summed
        groups = [mesh.group(mesh_lib.EXPERT_AXIS),
                  mesh.group(mesh_lib.TENSOR_AXIS)]
        gates = list(coll.copy_to_model(torch.stack(gates), groups)
                     .unbind(0))

    # top_k == 1 keeps the raw gate (Switch): a renormalised single gate
    # is ~1 and would starve the router of the task loss's gradient
    if top_k > 1:
        gate_sum = sum(gates) + 1e-9
        gates = [g / gate_sum for g in gates]

    counts = torch.zeros((b, e), dtype=probs.dtype, device=probs.device)
    dispatch = torch.zeros((b, s, e, capacity), dtype=probs.dtype,
                           device=probs.device)
    combine = torch.zeros_like(dispatch)
    for m, g in zip(masks, gates):
        pos = counts[:, None, :] + torch.cumsum(m, dim=1) - m     # [b, s, e]
        keep = m * (pos < capacity)
        counts = counts + torch.sum(keep, dim=1)
        slots = _one_hot(pos.long(), capacity, probs.dtype) * keep[..., None]
        dispatch = dispatch + slots
        combine = combine + g[..., None, None] * slots
    return dispatch, combine, aux


def moe_mlp(x: torch.Tensor, params: Dict[str, torch.Tensor], *,
            top_k: int = 2, capacity_factor: float = 1.25,
            compute_dtype: torch.dtype = torch.bfloat16,
            mesh: Optional[Any] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route -> dispatch -> per-expert GELU MLP -> combine.

    ``x`` ``[b, s, d]``; ``params``: ``router [d, e]``, ``wi [e, d, f]``,
    ``wo [e, f, d]`` (over a ``mesh``: this rank's parts, ``wi [e/E, d,
    f/T]``).  Returns ``(y [b, s, d] in x's dtype, aux)``.  The capacity
    comes from the sequence length (over a sequence axis, the global
    one), so a sequence fed in chunks to separate calls routes each chunk
    on its own budget."""
    seq_group = None if mesh is None else mesh.group(mesh_lib.SEQUENCE_AXIS)
    x_local = x
    if seq_group is not None:
        x = coll.gather_dim(x, 1, seq_group)
    e = params["router"].shape[1]
    cap = expert_capacity(x.shape[1], e, top_k, capacity_factor)
    dt = compute_dtype
    logits = torch.einsum("bsd,de->bse", x.float(), params["router"].float())
    dispatch, combine, aux = (
        top_k_routing(logits, top_k, cap) if mesh is None
        else top_k_routing(logits, top_k, cap, mesh=mesh))
    model = ([] if mesh is None else
             [g for g in (mesh.group(mesh_lib.EXPERT_AXIS),
                          mesh.group(mesh_lib.TENSOR_AXIS)) if g is not None])
    e_local = params["wi"].shape[0]
    if e_local != e:
        # this rank's experts
        first = mesh.coord(mesh_lib.EXPERT_AXIS) * e_local
        dispatch = dispatch.narrow(2, first, e_local)
        combine = combine.narrow(2, first, e_local)
    # over ranks the partial sums over the experts cross in f32 and
    # round once, as a single rank's products accumulate in f32 and
    # round once (the dispatch selects rows: its product is exact)
    if model:
        xe = torch.einsum("bsec,bsd->becd", dispatch,
                          coll.copy_to_model(x.float(), model)).to(dt)
    else:
        xe = torch.einsum("bsec,bsd->becd", dispatch.to(dt), x.to(dt))
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(torch.einsum("becd,edf->becf", xe, params["wi"].to(dt)),
               approximate="tanh")
    ye = torch.einsum("becf,efd->becd", h, params["wo"].to(dt))
    if model:
        y = coll.reduce_from_model(torch.einsum(
            "becd,bsec->bsd", ye.float(), combine.to(dt).float()), model)
    else:
        y = torch.einsum("becd,bsec->bsd", ye, combine.to(dt))
    if seq_group is not None:
        n = x_local.shape[1]
        y = y.narrow(1, mesh.coord(mesh_lib.SEQUENCE_AXIS) * n, n)
    return y.to(x_local.dtype), aux


def init_moe_params(generator: torch.Generator, d_model: int, d_ff: int,
                    num_experts: int) -> Dict[str, torch.Tensor]:
    """One layer's random f32 expert weights in the JAX init's shapes and
    scales, drawn from ``generator`` on its device (other numbers than
    ``jax.random``'s)."""
    dev = generator.device

    def normal(shape, fan_in):
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=torch.float32) * fan_in ** -0.5

    return {"router": normal((d_model, num_experts), d_model),
            "wi": normal((num_experts, d_model, d_ff), d_model),
            "wo": normal((num_experts, d_ff, d_model), d_ff)}


def moe_logical_axes() -> Dict[str, Any]:
    """Logical axis names for an ``init_moe_params`` tree (one layer)."""
    return {
        "router": (None, None),               # tiny; replicate
        "wi": ("expert", "embed", "mlp"),
        "wo": ("expert", "mlp", "embed"),
    }
