"""Sharding plans: one producer for every state layout.

Port of the JAX package's ``parallel/plan.py``.  A layout is a plain
value per leaf (``parallel/sharding.py``): ``None`` for a leaf every
rank holds whole, a tuple of ``(mesh axis, dim)`` pairs for the dims
split in equal contiguous slices over the axes of size > 1 (the fsdp
axis; ZeRO-1's data axis; the tensor and expert axes), or
``PER_REPLICA`` for the per-rank buffers of the compressed exchange
(error-feedback residuals, local-gradient accumulators), which the JAX
package stacks over a leading replica axis and the port keeps one row of
in each rank.

- the leaf-level authors: ``replicated_spec``, ``stacked_replica_spec``,
  ``zero1_spec`` (dim 0 when it divides the ranks) and ``fsdp_leaf_spec``
  (the largest divisible dim of a leaf of ``FSDP_MIN_LEAF_SIZE`` elements
  or more), both answering with the dim;
- ``ShardingPlan`` (from ``build_plan``): the layouts of one run's
  state, field by field (``params``, ``opt_state`` in optax's leaf order,
  ``residual``, ``grad_accum``), plus the compressed-FSDP and ZeRO-1
  layouts the trainer's step follows; ``describe()`` returns the JAX
  package's schema.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import mesh as mesh_lib
from ..utils.logging import log

# leaves below this size stay replicated under the FSDP heuristic
FSDP_MIN_LEAF_SIZE = 2 ** 12

# the layout of a per-rank buffer (the JAX package's [n, ...] stack)
PER_REPLICA = "per_replica"
# fsdp_leaf_spec's answer for a leaf large enough to want sharding whose
# dims all fail to divide (the JAX package returns None there)
FSDP_FALLBACK = "fallback"


def _numel(leaf: Any) -> int:
    n = 1
    for s in leaf.shape:
        n *= int(s)
    return n


def replicated_spec() -> None:
    """A leaf every rank holds whole."""
    return None


def stacked_replica_spec() -> str:
    """A per-rank buffer (residuals, accumulators)."""
    return PER_REPLICA


def zero1_spec(mesh: mesh_lib.Mesh, leaf: Any) -> Optional[int]:
    """ZeRO-1 layout for one param-shaped leaf: dim 0 over the ranks when
    it divides, replicated otherwise."""
    n = mesh_lib.data_parallel_size(mesh)
    if (hasattr(leaf, "shape") and len(leaf.shape) >= 1 and n > 1
            and leaf.shape[0] % n == 0):
        return 0
    return replicated_spec()


def fsdp_leaf_spec(mesh: mesh_lib.Mesh, leaf: Any,
                   min_size: int = FSDP_MIN_LEAF_SIZE):
    """Heuristic FSDP layout for one leaf: the largest fsdp-divisible dim
    (the first of equal sizes).  ``None`` when the mesh has no fsdp axis
    or the leaf is small; ``FSDP_FALLBACK`` when it is large enough to
    want sharding but no dim divides."""
    fsdp = mesh_lib.mesh_axis_size(mesh, mesh_lib.FSDP_AXIS)
    if fsdp == 1 or not hasattr(leaf, "shape") or _numel(leaf) < min_size:
        return replicated_spec()
    ndim = len(leaf.shape)
    for d in sorted(range(ndim), key=lambda d: -leaf.shape[d]):
        if leaf.shape[d] % fsdp == 0:
            return d
    return FSDP_FALLBACK


def _leaves(tree: Any) -> List[Any]:
    """The leaves of a nested dict in sorted-key order (``jax.tree.leaves``
    order for dicts), lists flattened in place."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@dataclasses.dataclass
class ShardingPlan:
    """The resolved layouts of one run.

    ``state_layouts``: ``{"params": tree, "opt_state": [leaf layouts in
    optax's order], "residual": tree or None, "grad_accum": tree or
    None}``.  ``fsdp_param_layouts`` is the param tree when the
    compressed exchange runs in the FSDP (reduce-scatter / all-gather)
    regime, else None; ``zero1_update_layouts`` the param-shaped tree of
    ZeRO-1's update slices, else None.  ``per_replica_fields`` name the
    fields that do not carry over to another world size."""

    mesh: mesh_lib.Mesh
    dp: int
    fsdp: int
    state_layouts: Dict[str, Any]
    fsdp_param_layouts: Any = None
    zero1_update_layouts: Any = None
    seq: int = 1
    per_replica_fields: Tuple[str, ...] = ("residual", "grad_accum")

    def describe(self) -> dict:
        """World sizes and per-field leaf layout counts (the JAX
        package's schema)."""
        out = {"dp": self.dp, "fsdp": self.fsdp, "seq": self.seq,
               "per_replica_fields": list(self.per_replica_fields),
               "fields": {}}
        sharded_world = self.mesh.size > 1
        for field in ("params", "opt_state", "residual", "grad_accum"):
            tree = self.state_layouts.get(field)
            if tree is None:
                continue
            leaves = _leaves(tree)
            if not leaves:
                continue
            n_sharded = sum(sharded_world and x is not None for x in leaves)
            out["fields"][field] = {"leaves": len(leaves),
                                    "replicated": len(leaves) - n_sharded,
                                    "sharded": n_sharded}
        out["regime"] = ("compressed_fsdp"
                         if self.fsdp_param_layouts is not None
                         else ("zero1"
                               if self.zero1_update_layouts is not None
                               else "dp"))
        return out

    @property
    def param_layouts(self) -> Any:
        return self.state_layouts["params"]


def build_plan(mesh: mesh_lib.Mesh, accelerator: Any, module: Any,
               params: Any, opt_layouts: Callable[[List[Any]], List[Any]],
               *,
               grad_compression: Optional[str] = None,
               shard_optimizer_state: bool = False,
               accumulate: int = 1,
               report_fallbacks: bool = True) -> ShardingPlan:
    """Resolve the state layouts for ``mesh`` (the JAX ``build_plan``).

    The accelerator gives the param layouts (logical rules, the FSDP
    heuristic, or replicated) and ``opt_layouts`` maps them onto the
    optimizer's state (``core/optim.py`` ``state_layouts``: moments
    inherit their param's layout); ``grad_compression`` with sharded
    params is the compressed-FSDP regime; ``shard_optimizer_state``
    re-lays replicated-param moments ZeRO-1 style (skipped, with the JAX
    package's warning, when params are sharded).  With compression the
    residuals are per-rank, and the accumulators (``accumulate > 1``)
    too under plain data parallelism, param-shaped (the param layout)
    under FSDP.  Pure: it changes no state."""
    from . import collectives as collectives_lib

    param_l = accelerator.param_shardings(mesh, params, module=module,
                                          report_fallbacks=report_fallbacks)
    flat_params = _leaves(params)
    flat_l = _leaves(param_l)
    params_replicated = all(x is None for x in flat_l)
    opt_l = opt_layouts(flat_l)
    residual_l = grad_accum_l = None
    if grad_compression is not None:
        residual_l = _map_tree(lambda _: stacked_replica_spec(), params)
        if accumulate > 1:
            grad_accum_l = (param_l if not params_replicated else
                            _map_tree(lambda _: stacked_replica_spec(),
                                      params))
    fsdp_param_l = None
    if grad_compression is not None and not params_replicated:
        for x in flat_l:
            collectives_lib.fsdp_shard_dim(x)
        fsdp_param_l = param_l
    zero1_update_l = None
    if shard_optimizer_state:
        if not params_replicated:
            log.warning(
                "shard_optimizer_state=True with sharded params: the "
                "optimizer state already inherits the FSDP/TP layout; "
                "ZeRO-1 re-sharding is skipped")
        else:
            z = [_zero1_layout(mesh, p) for p in flat_params]
            opt_l = opt_layouts(z)
            zero1_update_l = _map_tree(lambda p: _zero1_layout(mesh, p),
                                       params)
    return ShardingPlan(
        mesh=mesh, dp=mesh_lib.data_parallel_size(mesh),
        fsdp=mesh_lib.mesh_axis_size(mesh, mesh_lib.FSDP_AXIS),
        state_layouts={"params": param_l, "opt_state": opt_l,
                       "residual": residual_l, "grad_accum": grad_accum_l},
        fsdp_param_layouts=fsdp_param_l,
        zero1_update_layouts=zero1_update_l,
        seq=mesh_lib.mesh_axis_size(mesh, mesh_lib.SEQUENCE_AXIS))


def _zero1_layout(mesh: mesh_lib.Mesh, leaf: Any) -> Any:
    """``zero1_spec``'s dim as a layout over the batch axes."""
    dim = zero1_spec(mesh, leaf)
    if dim is None:
        return None
    return tuple((a, dim) for a in mesh_lib.BATCH_AXES
                 if mesh_lib.mesh_axis_size(mesh, a) > 1)


def _map_tree(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)
