"""Rule ``rank-divergence``: host behavior that differs across ranks in
SPMD code -- the failure mode that hangs, not raises.

Port of the JAX package's rule, recast for PyTorch.  Every rank must
issue the same collective sequence: a collective, a barrier or a
collective checkpoint commit that only some ranks reach deadlocks the
others, a silent stall the watchdog eventually reaps with no exception
pointing at the branch.  Two statically checkable sources:

- **rank-gated control flow**: an ``if`` / ``while`` whose test depends
  on the rank -- ``dist.get_rank()``, ``world_and_rank()`` (its rank),
  the ``RANK`` / ``LOCAL_RANK`` environment variables, directly or
  through a local -- and whose arms enclose a collective (a
  ``torch.distributed`` one or a ``parallel/collectives.py`` helper), a
  barrier, or a checkpoint commit (``save_sharded`` /
  ``save_checkpoint`` / ``restore_sharded`` / ``wait_until_finished``).
  Branching on the world size is fine: every rank agrees on it.
  Deliberate single-writer blocks carry a reasoned pragma.
- **unseeded host randomness in per-step SPMD paths**: ``random.*``,
  ``np.random.*`` (the module's global generator) and ``torch.rand*``
  without ``generator=`` reachable from a hot root (the within-module
  closure of ``LintConfig.hot_roots``): each rank draws its own value
  where the step needs one the ranks agree on.  A seeded
  ``np.random.default_rng(seed)`` / ``torch.Generator`` is fine.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Set

from ..lint import (Finding, LintContext, ModuleInfo, dotted,
                    function_table, reachable_functions)
from .spmd_collectives import collective_call, dist_aliases

RULE = "rank-divergence"

_BARRIER_LEAVES = frozenset(("barrier", "monitored_barrier"))
_COMMIT_LEAVES = frozenset(("save_sharded", "save_checkpoint",
                            "restore_sharded", "wait_until_finished"))
_RANK_CALLS = frozenset(("get_rank", "get_global_rank", "get_local_rank"))
_RANK_ENV = frozenset(("RANK", "LOCAL_RANK"))

# seeded constructors: not host randomness
_SEEDED = frozenset(("default_rng", "RandomState", "Generator", "seed",
                     "SeedSequence"))
_TORCH_RANDOM = frozenset(("rand", "randn", "randint", "randperm",
                           "rand_like", "randn_like", "randint_like",
                           "bernoulli", "multinomial", "normal"))


def _is_rank_expr(node: ast.AST) -> bool:
    """A sub-expression that reads this process's rank."""
    if isinstance(node, ast.Call):
        leaf = (dotted(node.func) or "").split(".")[-1]
        if leaf in _RANK_CALLS:
            return True
        name = dotted(node.func) or ""
        if name in ("os.environ.get", "os.getenv", "environ.get",
                    "getenv") and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and node.args[0].value in _RANK_ENV:
            return True
    if isinstance(node, ast.Subscript):
        base = dotted(node.value) or ""
        if base in ("os.environ", "environ") \
                and isinstance(node.slice, ast.Constant) \
                and node.slice.value in _RANK_ENV:
            return True
        # world_and_rank()[1]
        if isinstance(node.value, ast.Call) \
                and (dotted(node.value.func) or "").split(".")[-1] \
                == "world_and_rank" \
                and isinstance(node.slice, ast.Constant) \
                and node.slice.value == 1:
            return True
    return False


def _rank_locals(scope: ast.AST) -> Set[str]:
    """Names assigned (anywhere in the scope) from a rank read, and the
    second name of ``world, rank = world_and_rank()``."""
    out: Set[str] = set()
    for node in ast.walk(scope):
        if not isinstance(node, ast.Assign):
            continue
        value = node.value
        if isinstance(value, ast.Call) \
                and (dotted(value.func) or "").split(".")[-1] \
                == "world_and_rank":
            for tgt in node.targets:
                if isinstance(tgt, (ast.Tuple, ast.List)) \
                        and len(tgt.elts) == 2 \
                        and isinstance(tgt.elts[1], ast.Name):
                    out.add(tgt.elts[1].id)
            continue
        if any(_is_rank_expr(sub) for sub in ast.walk(value)):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    out.add(tgt.id)
    return out


def _test_is_rank_divergent(test: ast.AST, rank_names: Set[str]) -> bool:
    for sub in ast.walk(test):
        if _is_rank_expr(sub):
            return True
        if isinstance(sub, ast.Name) and sub.id in rank_names:
            return True
    return False


def _divergence_hazard(node: ast.AST, module: ModuleInfo,
                       aliases: Set[str]) -> str:
    """What a rank-gated arm encloses that needs every rank -- or ''
    when the arm is harmless host-local work."""
    for sub in ast.walk(node):
        hit = collective_call(sub, module, aliases)
        if hit is not None:
            op, _, helper = hit
            if op in _BARRIER_LEAVES:
                return f"barrier '{op}'"
            return (f"collective {op}" if helper
                    else f"collective dist.{op}")
        if isinstance(sub, ast.Call):
            leaf = (dotted(sub.func) or "").split(".")[-1]
            if leaf in _BARRIER_LEAVES:
                return f"barrier '{leaf}'"
            if leaf in _COMMIT_LEAVES:
                return f"checkpoint commit '{leaf}'"
    return ""


def _host_random(node: ast.Call, np_aliases: Set[str]) -> bool:
    name = dotted(node.func)
    if not name or "." not in name:
        return False
    mod, leaf = name.rsplit(".", 1)
    if mod == "random":
        if leaf in ("Random", "SystemRandom"):
            return not node.args
        return leaf != "seed"
    if mod in {f"{a}.random" for a in np_aliases}:
        return leaf not in _SEEDED or not (node.args or node.keywords)
    if mod == "torch" and leaf in _TORCH_RANDOM:
        return not any(kw.arg == "generator" for kw in node.keywords)
    return False


def check(module: ModuleInfo, ctx: LintContext) -> Iterable[Finding]:
    findings: List[Finding] = []
    aliases = dist_aliases(module)

    # ---- rank-gated control flow over collectives/barriers/commits --- #
    text = "\n".join(module.lines)
    scopes: List[ast.AST] = []
    if any(s in text for s in ("rank", "RANK")):  # else nothing reads it
        scopes = list(function_table(module.tree).values())
        scopes.append(module.tree)
    seen: Set[int] = set()
    for scope in scopes:
        rank_names = _rank_locals(scope)
        for node in ast.walk(scope):
            if not isinstance(node, (ast.If, ast.While)) \
                    or id(node) in seen:
                continue
            seen.add(id(node))
            if not _test_is_rank_divergent(node.test, rank_names):
                continue
            hazard = ""
            # every arm of a rank-divergent if is rank-divergent: the
            # body, the else and each elif
            for child in node.body + node.orelse:
                hazard = hazard or _divergence_hazard(child, module,
                                                      aliases)
            if hazard:
                kind = "while" if isinstance(node, ast.While) else "if"
                findings.append(Finding(
                    RULE, module.key, node.lineno, node.col_offset,
                    f"host '{kind}' branching on the rank encloses "
                    f"{hazard}: ranks that skip this branch never join "
                    "it -- a silent cross-rank deadlock (or torn "
                    "commit), not an exception.  Hoist it out of the "
                    "rank branch, or pragma with the single-writer "
                    "rationale"))

    # ---- unseeded host randomness in per-step SPMD paths ------------- #
    roots = None
    for suffix, qualnames in ctx.config.hot_roots.items():
        if module.key == suffix or module.key.endswith("/" + suffix):
            roots = qualnames
            break
    if roots is None:
        return findings
    np_aliases = {"np", "numpy", "onp"}
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "numpy":
                    np_aliases.add(a.asname or "numpy")
    for qualname, fn in reachable_functions(module, roots).items():
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and _host_random(node,
                                                           np_aliases):
                findings.append(Finding(
                    RULE, module.key, node.lineno, node.col_offset,
                    f"'{dotted(node.func)}(...)' in per-step SPMD path "
                    f"({qualname}): an unseeded host draw, so each rank "
                    "gets its own value where the step needs one the "
                    "ranks agree on -- draw from a seeded generator "
                    "(np.random.default_rng(seed), torch.Generator)"))
    return findings
