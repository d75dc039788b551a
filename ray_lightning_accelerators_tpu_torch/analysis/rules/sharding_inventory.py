"""Rule ``sharding-inventory``: layouts are built on the inventoried
surface.

Port of the JAX package's rule, recast for the port.  There a
``PartitionSpec`` literal outside the audited modules is flagged.  The
port has no ``PartitionSpec``: its layouts come from the spec
constructors of ``parallel/sharding.py`` (``logical_to_spec``, which
maps logical axes to mesh axes, and ``spec_layout``, which turns a spec
into a leaf's layout on a mesh).  ``scripts/torch_sharding_audit.py``
inventories every call of them across the modules of
``LintConfig.inventory_modules``; this rule flags a call anywhere else,
so new sharding logic cannot grow off the audited surface unseen.  A
legitimate out-of-inventory layout carries a reasoned pragma.

Detected spellings: a bare ``logical_to_spec(...)`` / ``spec_layout(...)``
(imported or local), and any dotted call ending in one of them
(``sharding.spec_layout(...)``).
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from ..lint import Finding, LintContext, ModuleInfo, dotted

RULE = "sharding-inventory"

SPEC_CONSTRUCTORS = frozenset(("logical_to_spec", "spec_layout"))


def spec_call(node: ast.AST) -> bool:
    """Is this a call of one of the port's spec constructors?"""
    if not isinstance(node, ast.Call):
        return False
    name = dotted(node.func)
    return bool(name) and name.split(".")[-1] in SPEC_CONSTRUCTORS


def check(module: ModuleInfo, ctx: LintContext) -> Iterable[Finding]:
    if any(module.key == m or module.key.endswith("/" + m)
           for m in ctx.config.inventory_modules):
        return []
    findings: List[Finding] = []
    for node in ast.walk(module.tree):
        if not spec_call(node):
            continue
        findings.append(Finding(
            RULE, module.key, node.lineno, node.col_offset,
            f"spec constructor '{dotted(node.func)}' in uninventoried "
            f"module {module.key!r}: sharding layouts are built in the "
            "audited modules (scripts/torch_sharding_audit.py -- "
            "parallel/*, core/trainer.py, accelerators/base.py) so every "
            "layout shows in one inventory -- move the layout behind "
            "parallel/sharding.py's rules, or pragma with why this "
            "module owns it"))
    return findings
