"""Rule ``rebuild``: a library build or load on a warm path.

The port's counterpart of the JAX package's ``retrace`` rule.  PyTorch
runs eagerly, so there is no trace to redo; what the port can redo at
the wrong time is a build: nvcc or g++ (``ops/_build.py``,
``native/__init__.py``), a ``ctypes.CDLL`` load, a
``torch.utils.cpp_extension.load`` or a ``torch.compile`` /
``torch.jit`` graph.  Each costs seconds (a compile) or at least a
dlopen, and the warm paths promise none: the Trainer builds on its first
step and the serve engine at its first decode, then never again
(``analysis/compile_guard.py`` pins that at run time).  Flagged:

- a build or load inside a ``for`` / ``while`` body or a comprehension:
  one per iteration;
- one reached from a hot root (``LintConfig.hot_roots``, the
  within-module call closure): one per step or decode.

The cached accessors the kernel wrappers call (``_build.library(stem)``,
``native.lib()``) are not builds.  The builder modules themselves
(``LintConfig.build_modules``) are exempt: they are where a build is
supposed to happen, once.  A deliberate build on such a path carries a
pragma with the reason.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set

from ..lint import (Finding, LintContext, ModuleInfo, dotted,
                    reachable_functions)

RULE = "rebuild"

# a dotted call name -> what it builds or loads (leaf-matched where the
# leaf is unambiguous, full-name matched otherwise)
_BUILD_LEAVES = frozenset(("CDLL", "LoadLibrary", "build_all",
                           "load_inline"))
_BUILD_NAMES = frozenset(("torch.compile", "torch.jit.script",
                          "torch.jit.trace", "cpp_extension.load",
                          "torch.utils.cpp_extension.load"))


def build_call(node: ast.AST) -> Optional[str]:
    """The dotted name of a library build or load at this node, else
    None."""
    if not isinstance(node, ast.Call):
        return None
    name = dotted(node.func)
    if not name:
        return None
    if name in _BUILD_NAMES or name.split(".")[-1] in _BUILD_LEAVES:
        return name
    return None


def _loop_bodies(tree: ast.AST) -> Set[int]:
    """ids of every node nested under a for/while body or run per item
    of a comprehension."""
    out: Set[int] = set()
    for node in ast.walk(tree):
        children: list = []
        if isinstance(node, (ast.For, ast.While, ast.AsyncFor)):
            children = node.body + node.orelse
        elif isinstance(node, (ast.ListComp, ast.SetComp,
                               ast.GeneratorExp)):
            children = [node.elt]
        elif isinstance(node, ast.DictComp):
            children = [node.key, node.value]
        for child in children:
            out.update(id(sub) for sub in ast.walk(child))
    return out


def _hot_nodes(module: ModuleInfo, ctx: LintContext) -> Dict[int, str]:
    """id of every node inside a hot function -> its root's qualname."""
    for suffix, qualnames in ctx.config.hot_roots.items():
        if module.key == suffix or module.key.endswith("/" + suffix):
            out: Dict[int, str] = {}
            for qn, fn in reachable_functions(module, qualnames).items():
                for sub in ast.walk(fn):
                    out.setdefault(id(sub), qn)
            return out
    return {}


def check(module: ModuleInfo, ctx: LintContext) -> Iterable[Finding]:
    if any(module.key == m or module.key.endswith("/" + m)
           for m in ctx.config.build_modules):
        return []
    findings: List[Finding] = []
    in_loop = _loop_bodies(module.tree)
    hot = _hot_nodes(module, ctx)
    for node in ast.walk(module.tree):
        name = build_call(node)
        if name is None:
            continue
        if id(node) in in_loop:
            findings.append(Finding(
                RULE, module.key, node.lineno, node.col_offset,
                f"'{name}(...)' inside a loop body: a build or load per "
                "iteration -- hoist it out of the loop (or go through "
                "the cached accessor)"))
        elif id(node) in hot:
            findings.append(Finding(
                RULE, module.key, node.lineno, node.col_offset,
                f"'{name}(...)' in hot path ({hot[id(node)]}): a build "
                "or load per step -- build once before the loop and "
                "reuse it"))
    return findings
