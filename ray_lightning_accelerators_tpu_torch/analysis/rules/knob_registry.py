"""Rule ``knob-registry``: every RLA_TPU_* env read goes through knobs.

Port of the JAX package's rule, unchanged.  ``analysis/knobs.py`` is
the one place that reads ``RLA_TPU_*`` names from the environment
(typed getters, registered names, malformed-value policy); everywhere
else:

- a raw ``os.environ[...]`` / ``os.environ.get`` / ``os.getenv`` READ
  whose key resolves to an ``RLA_TPU_*`` literal (directly, via a
  module-level ``*_ENV`` constant, or via a constant imported from
  another module of the tree) is flagged -- route it through a getter;
- a raw read whose key cannot be resolved statically is flagged too
  (a dynamic key is exactly the registry hole this rule closes);
- a knobs getter called with a literal name missing from the registry
  is flagged (the getters also refuse at runtime; this catches it in
  review).

Writes (``os.environ[k] = v``, env propagation into children) are
exempt.  Non-``RLA_TPU_`` names (``PL_GLOBAL_SEED``, ``MASTER_ADDR``)
are out of scope.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional

from ..lint import Finding, LintContext, ModuleInfo, dotted, resolve_str

RULE = "knob-registry"

_GETTERS = ("get_raw", "get_str", "get_int", "get_float", "get_bool",
            "get_flag")


def _environ_read_key(node: ast.AST) -> Optional[ast.AST]:
    """The key expression of an environ READ at this node, else None."""
    # os.environ.get(K) / os.getenv(K) / environ.get(K) / getenv(K)
    if isinstance(node, ast.Call):
        name = dotted(node.func)
        if name in ("os.environ.get", "os.getenv", "environ.get",
                    "getenv") and node.args:
            return node.args[0]
        return None
    # os.environ[K] in Load context (slice read; writes are Store ctx)
    if isinstance(node, ast.Subscript) \
            and isinstance(node.ctx, ast.Load) \
            and dotted(node.value) in ("os.environ", "environ"):
        return node.slice
    return None


def check(module: ModuleInfo, ctx: LintContext) -> Iterable[Finding]:
    findings: List[Finding] = []
    if module.key == ctx.config.knobs_module \
            or module.key.endswith("/" + ctx.config.knobs_module):
        return findings  # the sanctioned reader

    def emit(node: ast.AST, msg: str) -> None:
        findings.append(Finding(RULE, module.key, node.lineno,
                                node.col_offset, msg))

    for node in ast.walk(module.tree):
        key_expr = _environ_read_key(node)
        if key_expr is not None:
            key = resolve_str(ctx, module, key_expr)
            if key is None:
                emit(node, "environ read with a dynamic key: the "
                           "knob registry cannot see it — read through "
                           "analysis.knobs (typed getters) or use a "
                           "resolvable constant")
            elif key.startswith("RLA_TPU_"):
                emit(node, f"raw environ read of {key!r}: RLA_TPU_* "
                           "knobs are read through analysis.knobs "
                           "(typed getter, registered default, "
                           "warn-and-default on malformed values)")
            continue
        # knobs getter with an unregistered literal name
        if isinstance(node, ast.Call):
            name = dotted(node.func)
            if name and name.split(".")[-1] in _GETTERS \
                    and ("knobs." in name or name.split(".")[0] in _GETTERS) \
                    and node.args:
                key = resolve_str(ctx, module, node.args[0])
                if key is not None and key.startswith("RLA_TPU_") \
                        and ctx.config.knob_names \
                        and key not in ctx.config.knob_names:
                    emit(node, f"knob {key!r} is not declared in "
                               "analysis/knobs.py — register it (name, "
                               "type, default, help) first")
    return findings
