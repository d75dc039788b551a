"""Rule ``graph-leak``: an autograd graph kept past the step that built it.

The port's counterpart of the JAX package's ``tracer-leak`` rule.  There
a value stored on ``self`` from inside a jitted function is a tracer
that outlives its trace.  The eager hazard with the same shape: a
tensor that a forward or a loss produced, stored on ``self`` or on a
global without ``.detach()``.  It keeps its whole autograd graph (every
saved activation of the step) alive until the next store replaces it
-- a step's worth of device memory held across the optimizer update,
and a second ``backward`` through freed buffers if anything reaches it.

Scope: functions reachable from the hot roots (``LintConfig.hot_roots``,
the within-module call closure), where a store runs every step.
Flagged: an assignment (or aug-assignment) whose target is rooted at
``self`` or is a name declared ``global`` in the function, and whose
value mentions a graph-carrying value -- the result of a forward or
loss call (``self.model(...)`` / ``module(...)``, a ``.forward`` /
``training_step`` call, any call whose name holds ``loss``), directly
or through a local assigned from one -- with no ``.detach()``,
``.item()``, ``.tolist()`` or ``float`` / ``int`` / ``bool`` applied
in the value.  Stores under ``torch.no_grad()`` /
``torch.inference_mode()`` build no graph and are skipped.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Set

from ..lint import (Finding, LintContext, ModuleInfo, dotted,
                    reachable_functions)

RULE = "graph-leak"

_MODEL_NAMES = frozenset(("model", "module", "net"))
_FORWARD_LEAVES = frozenset(("forward", "training_step"))
_DETACHING = frozenset(("detach", "item", "tolist", "float", "int",
                        "bool", "numpy"))
_NO_GRAD = frozenset(("no_grad", "inference_mode"))


def _graph_call(node: ast.AST) -> bool:
    """A call producing a graph-carrying tensor: a model called as a
    function, a forward / training_step, or a loss."""
    if not isinstance(node, ast.Call):
        return False
    name = dotted(node.func)
    if not name:
        return False
    leaf = name.split(".")[-1]
    return (leaf in _MODEL_NAMES or leaf in _FORWARD_LEAVES
            or "loss" in leaf.lower())


def _graph_names(fn: ast.AST) -> Set[str]:
    """Locals assigned from a graph-carrying expression (a small fixed
    point over the function's assignments)."""
    names: Set[str] = set()
    for _ in range(3):
        grew = False
        for node in ast.walk(fn):
            if not isinstance(node, ast.Assign) \
                    or not _carries_graph(node.value, names):
                continue
            for tgt in node.targets:
                elts = tgt.elts if isinstance(tgt, (ast.Tuple, ast.List)) \
                    else [tgt]
                for e in elts:
                    if isinstance(e, ast.Name) and e.id not in names:
                        names.add(e.id)
                        grew = True
        if not grew:
            break
    return names


def _detached(value: ast.AST) -> bool:
    for sub in ast.walk(value):
        if isinstance(sub, ast.Call):
            name = dotted(sub.func) or ""
            if name.split(".")[-1] in _DETACHING:
                return True
    return False


def _carries_graph(value: ast.AST, names: Set[str]) -> bool:
    if _detached(value):
        return False
    return any(_graph_call(sub)
               or (isinstance(sub, ast.Name) and sub.id in names)
               for sub in ast.walk(value))


def _root_is_self(node: ast.AST) -> bool:
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return isinstance(node, ast.Name) and node.id == "self"


def _no_grad_ids(fn: ast.AST) -> Set[int]:
    out: Set[int] = set()
    for node in ast.walk(fn):
        if not isinstance(node, (ast.With, ast.AsyncWith)):
            continue
        if any(isinstance(item.context_expr, ast.Call)
               and (dotted(item.context_expr.func) or "").split(".")[-1]
               in _NO_GRAD for item in node.items):
            for child in node.body:
                out.update(id(sub) for sub in ast.walk(child))
    return out


def check(module: ModuleInfo, ctx: LintContext) -> Iterable[Finding]:
    roots = None
    for suffix, qualnames in ctx.config.hot_roots.items():
        if module.key == suffix or module.key.endswith("/" + suffix):
            roots = qualnames
            break
    if roots is None:
        return []
    findings: List[Finding] = []
    for qualname, fn in reachable_functions(module, roots).items():
        names = _graph_names(fn)
        skip = _no_grad_ids(fn)
        globals_: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Global):
                globals_.update(node.names)
        for node in ast.walk(fn):
            if id(node) in skip:
                continue
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets, value = [node.target], node.value
            else:
                continue
            if value is None or not _carries_graph(value, names):
                continue
            for tgt in targets:
                kept = (isinstance(tgt, (ast.Attribute, ast.Subscript))
                        and _root_is_self(tgt)) or (
                    isinstance(tgt, ast.Name) and tgt.id in globals_)
                if kept:
                    findings.append(Finding(
                        RULE, module.key, node.lineno, node.col_offset,
                        f"'{ast.unparse(tgt)}' keeps a tensor from a "
                        f"forward or a loss in hot path ({qualname}) "
                        "without .detach(): its whole autograd graph "
                        "stays alive until the next store -- store "
                        "value.detach() (or a host number)"))
    return findings
