"""Sharding rules: map logical parameter axes to mesh axes.

Port of the JAX package's ``parallel/sharding.py`` for the fsdp axis.
There a module's ``param_logical_axes()`` names each dimension of each
leaf, a rules table maps the names to mesh axes and XLA derives the
all-gathers and reduce-scatters from the resulting ``NamedSharding``s.
Here a leaf's layout is a plain value: ``None`` when every rank holds
the whole leaf, or the dimension split into equal contiguous slices over
the ranks of the world (rank r holds slice r).  Only ``"embed" ->
fsdp`` can split a leaf in this slice: every other axis of the rules has
size 1 (the model-parallel axes are refused by the trainer until their
slices land), and an axis of size 1 splits nothing.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple

from . import mesh as mesh_lib

# logical -> mesh axis rules, name for name with the JAX package's; a
# logical axis maps to a mesh axis, a tuple of them, or None (replicated)
DEFAULT_RULES: Tuple[Tuple[str, Any], ...] = (
    ("batch", mesh_lib.BATCH_AXES),
    ("seq", mesh_lib.SEQUENCE_AXIS),
    ("embed", mesh_lib.FSDP_AXIS),          # ZeRO-3: params on the fsdp axis
    ("mlp", mesh_lib.TENSOR_AXIS),
    ("heads", mesh_lib.TENSOR_AXIS),
    ("kv", None),
    ("vocab", mesh_lib.TENSOR_AXIS),
    ("expert", mesh_lib.EXPERT_AXIS),
    ("stage", mesh_lib.PIPELINE_AXIS),
    ("layers", mesh_lib.PIPELINE_AXIS),
    (None, None),
)


def logical_to_spec(logical_axes: Sequence[Optional[str]],
                    rules: Sequence[Tuple[str, Any]] = DEFAULT_RULES
                    ) -> tuple:
    """A tuple of logical axis names -> one mesh-axis entry per dim (the
    ``PartitionSpec`` entries of the JAX package).  A mesh axis shards at
    most one dim of a leaf: a later dim that would reuse it replicates."""
    table = dict(rules)
    entries = []
    used = set()
    for name in logical_axes:
        target = table.get(name)
        key = tuple(target) if isinstance(target, (list, tuple)) else target
        if key is not None and key in used:
            target = None
        if key is not None:
            used.add(key)
        entries.append(tuple(target) if isinstance(target, list) else target)
    return tuple(entries)


def spec_layout(spec: tuple, mesh: mesh_lib.Mesh) -> Optional[int]:
    """The dim of ``spec`` that an axis of size > 1 shards, or None.  In
    this slice only the fsdp axis can be > 1 (the trainer refuses the
    model axes first)."""
    dim = None
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        if any(mesh_lib.mesh_axis_size(mesh, a) > 1 for a in axes):
            if dim is not None:
                raise ValueError(f"spec {spec} shards two dims over the "
                                 "ranks; one is supported")
            dim = d
    return dim


def _is_axes_leaf(x: Any) -> bool:
    return x is None or isinstance(x, tuple)


def tree_logical_to_layouts(mesh: mesh_lib.Mesh, logical_tree: Any,
                            rules: Sequence[Tuple[str, Any]] = DEFAULT_RULES
                            ) -> Any:
    """A tree of logical-axis tuples -> a tree of layouts."""
    if _is_axes_leaf(logical_tree):
        return (None if logical_tree is None
                else spec_layout(logical_to_spec(logical_tree, rules), mesh))
    return {k: tree_logical_to_layouts(mesh, v, rules)
            for k, v in logical_tree.items()}


def keystr(path: Sequence[str]) -> str:
    """``jax.tree_util.keystr`` of a dict path: ``['layers']['attn']``."""
    return "".join(f"[{k!r}]" for k in path)


def tree_map_with_path(fn: Callable, tree: Any, *rest: Any,
                       path: tuple = ()) -> Any:
    """``fn(path, leaf, *other_leaves)`` over a nested dict (the others
    must have its structure; a mismatch raises)."""
    if isinstance(tree, dict):
        for other in rest:
            if not isinstance(other, dict) or set(other) != set(tree):
                raise ValueError(f"tree structure mismatch at "
                                 f"{keystr(path)}")
        return {k: tree_map_with_path(fn, tree[k], *(o[k] for o in rest),
                                      path=path + (k,))
                for k in tree}
    return fn(path, tree, *rest)


def validate_shardings(params: Any, layouts: Any,
                       mesh: mesh_lib.Mesh) -> None:
    """Raise a readable error when a param dim doesn't divide by the
    ranks it is split over (structure-checked)."""
    size = mesh_lib.mesh_axis_size(mesh, mesh_lib.FSDP_AXIS)

    def check(path, leaf, dim):
        if dim is None or not hasattr(leaf, "shape"):
            return leaf
        if leaf.shape[dim] % size != 0:
            raise ValueError(
                f"parameter {keystr(path)} dim {dim} (size "
                f"{leaf.shape[dim]}) is not divisible by mesh axes "
                f"{(mesh_lib.FSDP_AXIS,)} (size {size}); adjust the model "
                f"dims or the mesh (e.g. n_layers % pipeline == 0)")
        return leaf

    tree_map_with_path(check, params, layouts)


def infer_fsdp_shardings(params: Any, mesh: mesh_lib.Mesh,
                         min_size: int = 2 ** 12,
                         on_fallback: Optional[Callable] = None) -> Any:
    """The heuristic FSDP layout for models without logical annotations:
    the largest divisible dim of each leaf of ``min_size`` elements or
    more (``plan.fsdp_leaf_spec``); small leaves replicate.
    ``on_fallback(name, leaf)`` fires for each leaf large enough to want
    sharding whose dims all fail to divide; it replicates."""
    from . import plan as plan_lib

    def one(path, leaf):
        dim = plan_lib.fsdp_leaf_spec(mesh, leaf, min_size=min_size)
        if dim is plan_lib.FSDP_FALLBACK:
            if on_fallback is not None:
                on_fallback(keystr(path), leaf)
            dim = plan_lib.replicated_spec()
        return dim

    return tree_map_with_path(one, params)
