"""Rule ``spmd-collective``: every collective's process group is a mesh
axis's group, the world, or None.

Port of the JAX package's rule, recast for PyTorch.  There a
collective's ``axis_name`` must resolve to a declared mesh axis.  Here
the axis a collective runs over is its process group, and the groups
come from one place: ``parallel/mesh.py`` ``build_rank_mesh`` makes one
per axis (``RankMesh.group(axis)``) and one for the batch axes
(``BATCH_GROUP``).  A collective over any other group -- one a
subsystem made for itself, or a group looked up under a name no axis
has -- is a silent cross-subsystem mismatch, or a hang when the ranks
disagree on who is in it.

Checked calls: the ``torch.distributed`` collectives (any alias of the
module: ``all_reduce``, ``all_gather*``, ``reduce_scatter*``,
``all_to_all*``, ``broadcast``, ``barrier``, ``send`` / ``recv`` /
``isend`` / ``irecv``, ``P2POp``) and the group-taking helpers of
``parallel/collectives.py`` (``COLLECTIVE_HELPERS``).  The group
argument (keyword ``group`` / ``groups`` or its position) resolves when
it is, statically:

- absent (the world), ``None`` or ``<dist>.group.WORLD``;
- ``X.group(axis)`` / ``X.groups.get(axis)`` / ``X.groups[axis]`` where
  ``axis`` resolves to a declared name (literal or constant), or is
  derived from one or from a parameter (the JAX rule's axis dataflow);
- a function parameter (the group flows from call sites, checked where
  they pass something concrete);
- a local, loop variable, ``self.`` / ``ctx.`` attribute assigned only
  from resolving expressions, a list, tuple or comprehension of them, a
  conditional of two, or a call to a function of the tree whose every
  return resolves.

Findings: a group looked up under an undeclared axis name, and a group
argument that resolves through none of the paths above.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from ..lint import (Finding, LintContext, ModuleInfo, dotted,
                    function_table, resolve_str_tuple)

RULE = "spmd-collective"

# torch.distributed op -> positional index of the group argument
COLLECTIVE_GROUP_ARG: Dict[str, int] = {
    "all_reduce": 2, "broadcast": 2, "all_gather": 2,
    "all_gather_into_tensor": 2, "all_gather_single": 2,
    "reduce_scatter": 3, "reduce_scatter_tensor": 3,
    "reduce_scatter_single": 3, "all_to_all": 2, "all_to_all_single": 4,
    "barrier": 0, "send": 2, "recv": 2, "isend": 2, "irecv": 2,
    "P2POp": 3,
}

# parallel/collectives.py helper -> positional index of its group(s)
COLLECTIVE_HELPERS: Dict[str, int] = {
    "sum_across_ranks": 2, "copy_to_model": 1, "reduce_from_model": 1,
    "mean_identity_grad": 1, "all_reduce_value": 1, "all_gather_dim": 2,
    "gather_dim": 2, "gather_whole": 2, "ppermute": 1, "all_to_all": 1,
}

COLLECTIVES_MODULE = "parallel/collectives.py"

_DERIVING_BUILTINS = frozenset(("tuple", "list", "sorted", "set",
                                "frozenset", "reversed"))


def dist_aliases(module: ModuleInfo) -> Set[str]:
    """Local names bound to ``torch.distributed`` (``import
    torch.distributed as dist``, anywhere in the module)."""
    out: Set[str] = set()
    if "distributed" not in "\n".join(module.lines):
        return out
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch.distributed" and a.asname:
                    out.add(a.asname)
        elif isinstance(node, ast.ImportFrom) and node.module == "torch":
            for a in node.names:
                if a.name == "distributed":
                    out.add(a.asname or a.name)
    return out


def collective_call(node: ast.AST, module: ModuleInfo,
                    aliases: Set[str]) -> Optional[Tuple[str, int, bool]]:
    """(op, group position, is a helper) when ``node`` calls a
    ``torch.distributed`` collective or a ``parallel/collectives.py``
    helper, else None."""
    if not isinstance(node, ast.Call):
        return None
    name = dotted(node.func)
    if not name:
        return None
    parts = name.split(".")
    leaf = parts[-1]
    if len(parts) > 1:
        mod = ".".join(parts[:-1])
        if leaf in COLLECTIVE_GROUP_ARG and (
                mod in aliases or mod == "torch.distributed"):
            return leaf, COLLECTIVE_GROUP_ARG[leaf], False
        if len(parts) == 2 and leaf in COLLECTIVE_HELPERS and \
                module.mod_aliases.get(parts[0]) == COLLECTIVES_MODULE:
            return leaf, COLLECTIVE_HELPERS[leaf], True
        return None
    if leaf in COLLECTIVE_HELPERS:
        imp = module.imported_names.get(leaf)
        if (imp is not None and imp[0] == COLLECTIVES_MODULE) or (
                module.key.endswith(COLLECTIVES_MODULE)
                and leaf in function_table(module.tree)):
            return leaf, COLLECTIVE_HELPERS[leaf], True
    return None


def group_arg_of(node: ast.Call, pos: int) -> Optional[ast.AST]:
    """The group argument expression, or None when the call omits it
    (the world group)."""
    for kw in node.keywords:
        if kw.arg in ("group", "groups"):
            return kw.value
    if len(node.args) > pos:
        return node.args[pos]
    return None


# --------------------------------------------------------------------- #
# Axis dataflow (the JAX rule's): an axis name flowing from constants    #
# --------------------------------------------------------------------- #
def _axis_derived(ctx: LintContext, module: ModuleInfo, expr: ast.AST,
                  axis_locals: Set[str], params: Set[str]) -> bool:
    if resolve_str_tuple(ctx, module, expr) is not None:
        return True
    if isinstance(expr, ast.Name):
        return expr.id in axis_locals or expr.id in params
    if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
        return all(_axis_derived(ctx, module, e, axis_locals, params)
                   for e in expr.elts)
    if isinstance(expr, ast.Subscript):
        return _axis_derived(ctx, module, expr.value, axis_locals, params)
    if isinstance(expr, ast.IfExp):
        return (_axis_derived(ctx, module, expr.body, axis_locals, params)
                and _axis_derived(ctx, module, expr.orelse, axis_locals,
                                  params))
    if isinstance(expr, ast.BoolOp):  # layout or ()
        return all(_axis_derived(ctx, module, v, axis_locals, params)
                   for v in expr.values)
    return False


# --------------------------------------------------------------------- #
# Group dataflow                                                          #
# --------------------------------------------------------------------- #
class _Scope:
    """What a group expression may lean on inside one top-level
    function (or class method): its params, its locals and loop
    variables assigned from resolving expressions, and the attribute
    assignments of its class."""

    def __init__(self, ctx: LintContext, module: ModuleInfo,
                 fn: ast.AST, cls: Optional[ast.ClassDef],
                 cache: Dict[str, bool], depth: int = 0):
        self.ctx, self.module, self.cache = ctx, module, cache
        self.params: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                args = node.args
                for a in args.args + args.posonlyargs + args.kwonlyargs:
                    self.params.add(a.arg)
                for extra in (args.vararg, args.kwarg):
                    if extra is not None:
                        self.params.add(extra.arg)
        self.params.discard("self")
        self.params.discard("ctx")
        # attribute name -> every value assigned to self.<a> / ctx.<a>
        self.attrs: Dict[str, List[ast.AST]] = {}
        for node in ast.walk(cls if cls is not None else fn):
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Attribute) \
                            and isinstance(tgt.value, ast.Name) \
                            and tgt.value.id in ("self", "ctx"):
                        self.attrs.setdefault(tgt.attr, []).append(
                            node.value)
        self.locals: Set[str] = set()
        self.axis_locals: Set[str] = set()
        for _ in range(3):  # fixed point over chains of locals
            grew = False
            for node in ast.walk(fn):
                pairs: List[Tuple[ast.AST, ast.AST]] = []
                if isinstance(node, ast.Assign):
                    for t in node.targets:
                        # a, b = x, y pairs element-wise
                        if isinstance(t, (ast.Tuple, ast.List)) \
                                and isinstance(node.value,
                                               (ast.Tuple, ast.List)) \
                                and len(t.elts) == len(node.value.elts):
                            pairs += list(zip(t.elts, node.value.elts))
                        else:
                            pairs.append((t, node.value))
                elif isinstance(node, (ast.For, ast.comprehension)):
                    pairs = [(node.target, node.iter)]
                for tgt, value in pairs:
                    names = [n.id for n in ast.walk(tgt)
                             if isinstance(n, ast.Name)]
                    if _axis_derived(ctx, module, value, self.axis_locals,
                                     self.params):
                        for n in names:
                            if n not in self.axis_locals:
                                self.axis_locals.add(n)
                                grew = True
                    if self.group_ok(value, depth=depth + 1):
                        for n in names:
                            if n not in self.locals:
                                self.locals.add(n)
                                grew = True
            if not grew:
                break

    def _axis_ok(self, axis: ast.AST) -> bool:
        return _axis_derived(self.ctx, self.module, axis, self.axis_locals,
                             self.params)

    def group_ok(self, expr: ast.AST, depth: int = 0) -> bool:
        if depth > 4:
            return False
        if isinstance(expr, ast.Constant) and expr.value is None:
            return True
        name = dotted(expr)
        if name and name.endswith("group.WORLD"):
            return True
        if isinstance(expr, ast.Name):
            return expr.id in self.params or expr.id in self.locals
        if isinstance(expr, ast.Attribute) \
                and isinstance(expr.value, ast.Name) \
                and expr.value.id in ("self", "ctx"):
            values = self.attrs.get(expr.attr)
            return bool(values) and all(
                self.group_ok(v, depth + 1) for v in values)
        if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
            return all(self.group_ok(e, depth + 1) for e in expr.elts)
        if isinstance(expr, ast.Starred):
            return self.group_ok(expr.value, depth + 1)
        if isinstance(expr, ast.IfExp):
            return (self.group_ok(expr.body, depth + 1)
                    and self.group_ok(expr.orelse, depth + 1))
        if isinstance(expr, (ast.ListComp, ast.GeneratorExp, ast.SetComp)):
            return self.group_ok(expr.elt, depth + 1)
        if isinstance(expr, ast.Subscript):
            base = dotted(expr.value) or ""
            if base.endswith(".groups"):  # X.groups[axis]
                return self._axis_ok(expr.slice)
            return self.group_ok(expr.value, depth + 1)
        if isinstance(expr, ast.Call):
            f = expr.func
            if isinstance(f, ast.Attribute) and f.attr == "group" \
                    and len(expr.args) == 1:
                return self._axis_ok(expr.args[0])
            if isinstance(f, ast.Attribute) and f.attr == "get" \
                    and (dotted(f.value) or "").endswith(".groups") \
                    and expr.args:
                return self._axis_ok(expr.args[0])
            fname = dotted(f) or ""
            if fname.split(".")[-1] in _DERIVING_BUILTINS and expr.args:
                return self.group_ok(expr.args[0], depth + 1)
            return self._group_function(f, depth)
        return False

    def _group_function(self, func: ast.AST, depth: int) -> bool:
        """A function of this module whose every return resolves (its
        own params allowed: the caller's arguments are checked where
        they are concrete).  Memoized per module; depth-limited so
        mutual recursion cannot loop."""
        if not isinstance(func, ast.Name) or depth > 2:
            return False
        if func.id in self.cache:
            return self.cache[func.id]
        self.cache[func.id] = False  # in progress: recursion resolves no
        fn = function_table(self.module.tree).get(func.id)
        ok = False
        if fn is not None:
            returns = [n.value for n in ast.walk(fn)
                       if isinstance(n, ast.Return) and n.value is not None]
            if returns:
                inner = _Scope(self.ctx, self.module, fn, None, self.cache,
                               depth + 1)
                ok = all(inner.group_ok(r, depth + 1) for r in returns)
        self.cache[func.id] = ok
        return ok


def _undeclared_axes(ctx: LintContext, module: ModuleInfo,
                     expr: ast.AST) -> List[str]:
    """Axis names a ``.group("<name>")`` lookup in ``expr`` resolves to
    that the axes module does not declare."""
    out: List[str] = []
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute) \
                and sub.func.attr in ("group", "get") and sub.args:
            if sub.func.attr == "get" and not (
                    dotted(sub.func.value) or "").endswith(".groups"):
                continue
            names = resolve_str_tuple(ctx, module, sub.args[0])
            if names is not None:
                out.extend(n for n in names
                           if n not in ctx.config.spmd_axis_names)
    return sorted(set(out))


def _scopes(module: ModuleInfo):
    """(function, its class or None) for every top-level function and
    method, plus the module body as one scope."""
    for node in module.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node, None
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    yield sub, node
    yield module.tree, None


def check(module: ModuleInfo, ctx: LintContext) -> Iterable[Finding]:
    declared = ctx.config.spmd_axis_names
    if not declared:
        return []  # no axes module in this tree: nothing to check against
    aliases = dist_aliases(module)
    findings: List[Finding] = []
    seen: Set[int] = set()
    cache: Dict[str, bool] = {}
    for fn, cls in _scopes(module):
        scope = None  # lazy: most functions issue no collective
        for node in ast.walk(fn):
            hit = collective_call(node, module, aliases)
            if hit is None or id(node) in seen:
                continue
            seen.add(id(node))
            op, pos, helper = hit
            what = f"{COLLECTIVES_MODULE} {op}" if helper else f"dist.{op}"
            group = group_arg_of(node, pos)
            if group is None:
                continue  # the world group
            unknown = _undeclared_axes(ctx, module, group)
            if unknown:
                findings.append(Finding(
                    RULE, module.key, node.lineno, node.col_offset,
                    f"'{what}' over the group of undeclared axis name(s) "
                    f"{unknown}: mesh axes and the batch group are "
                    "declared in parallel/mesh.py (DATA_AXIS..EXPERT_AXIS "
                    "/ BATCH_GROUP) -- a group under any other name is "
                    "one no mesh made"))
                continue
            if scope is None:
                scope = _Scope(ctx, module, fn, cls, cache)
            if scope.group_ok(group):
                continue
            findings.append(Finding(
                RULE, module.key, node.lineno, node.col_offset,
                f"'{what}' group argument does not resolve to a mesh "
                "axis's group (RankMesh.group(<declared axis>)), the "
                "world or None: route the group through parallel/mesh.py "
                "so the SPMD layer keeps one vocabulary of groups"))
    return findings
