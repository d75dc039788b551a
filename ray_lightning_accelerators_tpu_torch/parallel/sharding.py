"""Sharding rules: map logical parameter axes to mesh axes.

Port of the JAX package's ``parallel/sharding.py``.  There a module's
``param_logical_axes()`` names each dimension of each leaf, a rules
table maps the names to mesh axes (``embed`` -> fsdp; ``heads``,
``mlp`` and ``vocab`` -> tensor; ``expert`` -> expert; ``seq`` ->
sequence) and XLA derives the collectives from the resulting
``NamedSharding``s.  Here a leaf's layout is a plain value: ``None``
when every rank holds the whole leaf, else a tuple of ``(mesh axis,
dim)`` pairs, one for each axis of size > 1 that splits a dim of the
leaf into equal contiguous slices (the rank at coordinate c on that
axis holds slice c).  A mesh axis shards at most one dim of a leaf
(``logical_to_spec``); a leaf may be split on two dims by two axes (the
MoE's ``wi`` over expert and tensor).  ``local_part`` cuts a rank's part
of a whole leaf, ``batch_dim`` / ``model_layout`` split a layout into
its batch-axes (fsdp, ZeRO-1) and model-axes (tensor, expert, pipeline)
parts.
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


def spec_layout(spec: tuple, mesh: mesh_lib.Mesh) -> Any:
    """The layout of a leaf with the ``PartitionSpec`` entries ``spec``:
    a ``(axis, dim)`` pair for every mesh axis of size > 1 in an entry,
    or None when no such axis splits the leaf."""
    pairs = []
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if mesh_lib.mesh_axis_size(mesh, a) > 1:
                pairs.append((a, d))
    return tuple(pairs) or None


def layout_dim(layout: Any, axis: str) -> Optional[int]:
    """The dim ``axis`` splits under ``layout``, or None."""
    for a, d in layout or ():
        if a == axis:
            return d
    return None


def batch_dim(layout: Any) -> Optional[int]:
    """The dim the batch axes (fsdp, or ZeRO-1's data) split, or None."""
    for a, d in layout or ():
        if a in mesh_lib.BATCH_AXES:
            return d
    return None


def model_layout(layout: Any) -> Any:
    """The pairs of ``layout`` on the model axes (tensor, expert,
    pipeline), or None."""
    pairs = tuple((a, d) for a, d in layout or ()
                  if a not in mesh_lib.BATCH_AXES)
    return pairs or None


def local_part(full: Any, layout: Any, mesh: Any) -> Any:
    """This rank's part of a whole tensor under the model axes of
    ``layout`` (a view; ``mesh`` a ``RankMesh``)."""
    for a, d in model_layout(layout) or ():
        n = mesh.size(a)
        size = full.shape[d] // n
        full = full.narrow(d, mesh.coord(a) * size, size)
    return full


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
    mesh axes it is split over (structure-checked)."""

    def check(path, leaf, layout):
        if layout is None or not hasattr(leaf, "shape"):
            return leaf
        dims: dict = {}
        for a, d in layout:
            dims.setdefault(d, []).append(a)
        for d, axes in dims.items():
            size = 1
            for a in axes:
                size *= mesh_lib.mesh_axis_size(mesh, a)
            if leaf.shape[d] % size != 0:
                raise ValueError(
                    f"parameter {keystr(path)} dim {d} (size "
                    f"{leaf.shape[d]}) is not divisible by mesh axes "
                    f"{tuple(axes)} (size {size}); adjust the model dims "
                    f"or the mesh (e.g. n_layers % pipeline == 0)")
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
        return None if dim is None else ((mesh_lib.FSDP_AXIS, dim),)

    return tree_map_with_path(one, params)
