"""Rule ``host-sync``: device->host synchronization in a hot path.

Port of the JAX package's rule, recast for PyTorch.  A CUDA kernel
launch returns at once; the host runs ahead queueing the next ones.  One
``.item()``, ``.tolist()``, ``.cpu()`` or ``float(loss)`` in the step or
decode loop waits for every kernel queued before it, and the host then
starts the next launch from an idle card: lock-step ping-pong where the
loop promises to stay ahead.

Scope: the transitive within-module call closure of the configured hot
roots (``LintConfig.hot_roots``: ``Trainer._fit_step``, the scanned
epoch, the serve loop, the allocator, the observers).  Flagged:

- ``x.item()``, ``x.tolist()``, ``x.cpu()``, ``x.numpy()`` and the JAX
  package's ``x.block_until_ready()``;
- ``torch.cuda.synchronize(...)`` and ``.synchronize()`` on a CUDA
  event or stream (any receiver: a static rule cannot tell them apart);
- ``jax.device_get`` / ``jax.block_until_ready`` (kept from the JAX
  list; the port has none);
- ``np.asarray(...)`` / ``np.array(...)`` (any numpy alias): on a
  device tensor these copy it to the host;
- ``float(x)`` / ``int(x)`` / ``bool(x)`` where ``x`` involves a value a
  torch op produced in the same function (``torch.*`` / ``F.*`` calls,
  local dataflow; conservative, so host numbers stay unflagged).

Deliberate syncs (the TTFT gate, a feed gate, metrics read at a log
interval) carry an inline pragma with the reason.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Set

from ..lint import (Finding, LintContext, ModuleInfo, dotted,
                    reachable_functions)

RULE = "host-sync"

_NUMPY_MODULES = ("numpy", "np", "onp")
_TENSOR_PRODUCER_ROOTS = ("torch", "F")

# method calls that wait for the device: name -> what it does
_SYNC_METHODS = {
    "item": "blocking device->host sync per call",
    "tolist": "copies the device value to host lists (a sync)",
    "cpu": "copies the device value to the host (a sync)",
    "numpy": "materializes the value on the host (a sync)",
    "block_until_ready": "stalls async dispatch",
    "synchronize": "waits for the device (event / stream / card)",
}


def _numpy_aliases(module: ModuleInfo) -> Set[str]:
    """Local names bound to the numpy module."""
    aliases = {"numpy"}
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "numpy":
                    aliases.add(a.asname or "numpy")
    aliases.update(n for n in _NUMPY_MODULES)
    return aliases


def _torch_call(node: ast.AST) -> bool:
    """Does this expression contain a call producing a tensor -- a
    ``torch.*`` or ``F.*`` (functional) call?"""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            name = dotted(sub.func)
            if name and name.split(".")[0] in _TENSOR_PRODUCER_ROOTS:
                return True
    return False


def _tensorish_names(fn: ast.AST) -> Set[str]:
    """Names assigned (anywhere in the function) from tensor-producing
    expressions: a ``torch.*`` / ``F.*`` call, or a method called on a
    name already tensor-valued (``s = t.sum()``).  A small fixed point;
    conservative by construction."""
    names: Set[str] = set()

    def produces(value: ast.AST) -> bool:
        if _torch_call(value):
            return True
        return any(isinstance(sub, ast.Call)
                   and isinstance(sub.func, ast.Attribute)
                   and isinstance(sub.func.value, ast.Name)
                   and sub.func.value.id in names
                   for sub in ast.walk(value))

    for _ in range(3):
        grew = False
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Assign) and produces(node.value)):
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


def _mentions_tensor(node: ast.AST, tensorish: Set[str]) -> bool:
    if _torch_call(node):
        return True
    return any(isinstance(sub, ast.Name) and sub.id in tensorish
               for sub in ast.walk(node))


def check(module: ModuleInfo, ctx: LintContext) -> Iterable[Finding]:
    roots = None
    for suffix, qualnames in ctx.config.hot_roots.items():
        if module.key == suffix or module.key.endswith("/" + suffix):
            roots = qualnames
            break
    if roots is None:
        return []
    hot = reachable_functions(module, roots)
    if not hot:
        return []
    np_aliases = _numpy_aliases(module)
    findings: List[Finding] = []
    seen: Set[tuple] = set()

    def emit(node: ast.AST, msg: str) -> None:
        key = (node.lineno, msg)
        if key not in seen:
            seen.add(key)
            findings.append(Finding(RULE, module.key, node.lineno,
                                    node.col_offset, msg))

    for qualname, fn in hot.items():
        tensorish = _tensorish_names(fn)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            name = dotted(node.func)
            if name in ("torch.cuda.synchronize", "jax.device_get",
                        "jax.block_until_ready"):
                emit(node, f"'{name}' in hot path ({qualname}): "
                           "blocking device->host wait")
                continue
            if isinstance(node.func, ast.Attribute):
                attr = node.func.attr
                if attr in _SYNC_METHODS and (attr not in ("item", "tolist",
                                                           "numpy")
                                              or not node.args):
                    emit(node, f"'.{attr}()' in hot path ({qualname}): "
                               f"{_SYNC_METHODS[attr]}")
                    continue
            if name and "." in name:
                mod, leaf = name.rsplit(".", 1)
                if mod in np_aliases and leaf in ("asarray", "array"):
                    emit(node, f"'{name}' in hot path ({qualname}): "
                               "materializes the device value on host")
                    continue
            if isinstance(node.func, ast.Name) \
                    and node.func.id in ("float", "int", "bool") \
                    and node.args \
                    and _mentions_tensor(node.args[0], tensorish):
                emit(node, f"'{node.func.id}(...)' on a device value in "
                           f"hot path ({qualname}): implicit host sync")
    return findings
