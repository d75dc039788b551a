"""Rule ``wire-exception``: typed raises in worker code must rebuild.

Port of the JAX package's rule, unchanged.  A worker-side exception
crosses the actor pipe and the agent relay as ``(type name, message,
traceback)`` and is rebuilt driver-side by ``runtime/wire.py``.  Types
missing from that registry collapse into a generic ``RemoteError`` --
how a graceful ``Preempted`` drain would burn a retry budget, or a
``CollectiveMismatch`` would read as a retryable crash.

Scope: the configured worker-dispatched modules
(``LintConfig.worker_modules``).  Flagged: ``raise X(...)`` (including
``raise mod.X.classmethod(...)`` constructor chains) where ``X`` is an
exception class defined in the linted tree but absent from
``WIRE_EXCEPTION_NAMES``.  Builtins stay exempt on purpose: only types
a retry or orchestration layer branches on belong in the registry.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Set

from ..lint import Finding, LintContext, ModuleInfo, dotted

RULE = "wire-exception"

_EXC_BASE_HINTS = ("Error", "Exception", "Warning")


def _package_exception_classes(ctx: LintContext) -> Set[str]:
    """Exception classes defined anywhere in the linted tree: ClassDef
    whose base looks exception-ish (a builtin exception name, or a name
    carrying Error/Exception, or another collected class)."""
    names: Set[str] = set()
    classdefs = []
    for module in ctx.modules.values():
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ClassDef):
                classdefs.append(node)
    # two passes so subclasses of package exceptions are collected too
    for _ in range(2):
        for node in classdefs:
            for base in node.bases:
                b = dotted(base) or ""
                leaf = b.split(".")[-1]
                if leaf in names or leaf.endswith(_EXC_BASE_HINTS) \
                        or leaf in ("BaseException", "RuntimeError",
                                    "ValueError", "TypeError", "KeyError"):
                    names.add(node.name)
    return names


def check(module: ModuleInfo, ctx: LintContext) -> Iterable[Finding]:
    if not any(module.key == m or module.key.endswith("/" + m)
               for m in ctx.config.worker_modules):
        return []
    pkg_exceptions = ctx.cache.get("wire-exception")
    if pkg_exceptions is None:
        pkg_exceptions = ctx.cache["wire-exception"] = \
            _package_exception_classes(ctx)
    registered = ctx.config.wire_names
    findings: List[Finding] = []
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Raise) or node.exc is None:
            continue
        exc = node.exc
        if isinstance(exc, ast.Call):
            exc = exc.func
        name = dotted(exc)
        if not name:
            continue
        # match any dotted segment against the class table, so
        # 'preempt_lib.Preempted.at_step(...)' resolves to 'Preempted'
        cls = next((seg for seg in name.split(".")
                    if seg in pkg_exceptions), None)
        if cls is None or cls in registered:
            continue
        findings.append(Finding(
            RULE, module.key, node.lineno, node.col_offset,
            f"'{cls}' raised in worker-dispatched code but missing from "
            "runtime/wire.py WIRE_EXCEPTION_NAMES: it will cross the "
            "pipe as a generic RemoteError and retry layers cannot "
            "classify it — register a rebuild (or pragma if it "
            "genuinely never crosses)"))
    return findings
