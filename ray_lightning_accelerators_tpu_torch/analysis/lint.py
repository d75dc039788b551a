"""graftlint for the port: PyTorch-aware AST analysis over this package.

Port of the JAX package's ``analysis/lint.py``: file discovery,
per-module parsing (AST, pragma comments, module-level string constants,
import aliases), the package-wide resolution tables the rules share, and
the report and exit-code surface of the CLI
(``scripts/torch_graftlint.py``) and the tests.  The engine is the JAX
package's; the rules (``analysis/rules/``) and the roots below name the
port's own hazards and functions.

Each rule yields ``Finding``s; a finding is suppressed by an inline
pragma on its line (or the line directly above, for findings inside
multi-line expressions)::

    first = int(tok.item())  # graftlint: ok(host-sync) -- TTFT gate: the
                             # first token's time needs it on the host

The pragma requires a reason after the rule list: a bare ``ok(...)`` is
itself reported (rule ``pragma``), so every deliberate violation says
why it is deliberate.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field, replace
from typing import Dict, Iterable, List, Mapping, Optional, Set, Tuple

# --------------------------------------------------------------------- #
# Findings & pragmas                                                     #
# --------------------------------------------------------------------- #

@dataclass
class Finding:
    rule: str
    path: str          # module key (package-relative posix path)
    line: int
    col: int
    message: str
    suppressed: bool = False

    def format(self) -> str:
        tag = " (suppressed)" if self.suppressed else ""
        return (f"{self.path}:{self.line}:{self.col}: "
                f"[{self.rule}] {self.message}{tag}")


# "# graftlint: ok(rule-a, rule-b) — reason" / "- reason" / ": reason"
_PRAGMA_RE = re.compile(
    r"#\s*graftlint:\s*ok\(([^)]*)\)\s*(?:[—–:-]\s*(.*))?$")


def _parse_pragmas(lines: List[str]) -> Tuple[Dict[int, Set[str]],
                                              List[int]]:
    """line (1-based) -> suppressed rules; plus lines whose pragma has
    no reason (reported as rule 'pragma')."""
    pragmas: Dict[int, Set[str]] = {}
    missing_reason: List[int] = []
    for i, text in enumerate(lines, start=1):
        m = _PRAGMA_RE.search(text)
        if not m:
            continue
        rules = {tok.strip() for tok in m.group(1).split(",") if tok.strip()}
        pragmas[i] = rules
        if not (m.group(2) or "").strip():
            missing_reason.append(i)
    return pragmas, missing_reason


# --------------------------------------------------------------------- #
# Per-module parse                                                       #
# --------------------------------------------------------------------- #

@dataclass
class ModuleInfo:
    key: str                     # package-relative posix path
    tree: ast.Module
    lines: List[str]
    pragmas: Dict[int, Set[str]]
    pragma_missing_reason: List[int]
    consts: Dict[str, str] = field(default_factory=dict)
    # module-level tuples of strings (AXIS_ORDER, BATCH_AXES): name ->
    # resolved string elements, for axis-name-set resolution
    tuple_consts: Dict[str, Tuple[str, ...]] = field(default_factory=dict)
    # alias -> module key ("import x.y as z" / "from ..r import m as z")
    mod_aliases: Dict[str, str] = field(default_factory=dict)
    # local name -> (module key, original name) for "from m import NAME"
    imported_names: Dict[str, Tuple[str, str]] = field(default_factory=dict)


def _module_pkg_parts(key: str) -> List[str]:
    """Package path of a module key: 'runtime/agent.py' -> ['runtime']."""
    parts = key.split("/")[:-1]
    if key.endswith("/__init__.py"):
        parts = parts[:-1]
    return parts


def _resolve_import(key: str, node_module: Optional[str],
                    level: int) -> Optional[str]:
    """Module key a (possibly relative) import refers to, or None when it
    leaves the linted tree (absolute third-party imports)."""
    if level == 0:
        return None  # absolute: stdlib/third-party (or self-absolute; skip)
    base = _module_pkg_parts(key)
    if level - 1 > len(base):
        return None
    if level > 1:
        base = base[:len(base) - (level - 1)]
    mod = (node_module or "").split(".") if node_module else []
    return "/".join(base + mod) + ".py"


def parse_module(key: str, source: str) -> ModuleInfo:
    tree = ast.parse(source, filename=key)
    lines = source.splitlines()
    pragmas, missing = _parse_pragmas(lines)
    info = ModuleInfo(key=key, tree=tree, lines=lines, pragmas=pragmas,
                      pragma_missing_reason=missing)
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            if isinstance(node.value, ast.Constant) \
                    and isinstance(node.value.value, str):
                info.consts[name] = node.value.value
            elif isinstance(node.value, (ast.Tuple, ast.List)):
                # tuple-of-strings constants (AXIS_ORDER, BATCH_AXES):
                # elements are literals or earlier same-module consts
                vals: List[str] = []
                for e in node.value.elts:
                    if isinstance(e, ast.Constant) \
                            and isinstance(e.value, str):
                        vals.append(e.value)
                    elif isinstance(e, ast.Name) and e.id in info.consts:
                        vals.append(info.consts[e.id])
                    else:
                        vals = []
                        break
                if vals:
                    info.tuple_consts[name] = tuple(vals)
    # imports are collected over the WHOLE tree (not just module level):
    # hot paths routinely do function-local relative imports
    # ("from ..parallel import mesh as mesh_lib" inside a builder) and
    # constant/axis resolution must see those aliases too
    for node in ast.walk(tree):
        if not isinstance(node, ast.ImportFrom):
            continue
        target = _resolve_import(key, node.module, node.level)
        for alias in node.names:
            local = alias.asname or alias.name
            if target is None:
                continue
            # "from ..runtime import preemption as preempt_lib":
            # the imported NAME may itself be a module of the tree
            submodule = target[:-3] + "/" + alias.name + ".py" \
                if target.endswith(".py") else None
            info.mod_aliases.setdefault(local, submodule or target)
            info.imported_names.setdefault(local, (target, alias.name))
    return info


# --------------------------------------------------------------------- #
# Shared AST helpers (used by the rule modules)                          #
# --------------------------------------------------------------------- #

def dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def resolve_str(ctx: "LintContext", module: ModuleInfo,
                node: ast.AST) -> Optional[str]:
    """A string the expression statically evaluates to: literals,
    module-level constants, and imported/attribute constants from other
    modules of the linted tree."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name):
        if node.id in module.consts:
            return module.consts[node.id]
        imp = module.imported_names.get(node.id)
        if imp is not None:
            target = ctx.modules.get(imp[0])
            # "from .watchdog import HEARTBEAT_ENV"
            if target is not None and imp[1] in target.consts:
                return target.consts[imp[1]]
            # the name may BE a submodule; no string value then
        return None
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
        modkey = module.mod_aliases.get(node.value.id)
        if modkey is not None:
            target = ctx.modules.get(modkey)
            if target is not None:
                return target.consts.get(node.attr)
    return None


def resolve_str_tuple(ctx: "LintContext", module: ModuleInfo,
                      node: ast.AST) -> Optional[Tuple[str, ...]]:
    """A tuple of strings the expression statically evaluates to: a
    string resolves to a 1-tuple, a tuple/list literal element-wise, a
    name to a registered tuple constant (``BATCH_AXES``) — including
    through import aliases (``mesh_lib.BATCH_AXES``) and ``from m
    import NAME``.  None when any part is not statically resolvable."""
    s = resolve_str(ctx, module, node)
    if s is not None:
        return (s,)
    if isinstance(node, (ast.Tuple, ast.List)):
        out: List[str] = []
        for e in node.elts:
            sub = resolve_str_tuple(ctx, module, e)
            if sub is None:
                return None
            out.extend(sub)
        return tuple(out)
    if isinstance(node, ast.Name):
        if node.id in module.tuple_consts:
            return module.tuple_consts[node.id]
        imp = module.imported_names.get(node.id)
        if imp is not None:
            target = ctx.modules.get(imp[0])
            if target is not None and imp[1] in target.tuple_consts:
                return target.tuple_consts[imp[1]]
        return None
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
        modkey = module.mod_aliases.get(node.value.id)
        if modkey is not None:
            target = ctx.modules.get(modkey)
            if target is not None:
                return target.tuple_consts.get(node.attr)
    return None


def function_table(tree: ast.Module) -> Dict[str, ast.AST]:
    """Call-resolvable functions of a module: top-level defs ('name') and
    class methods ('Class.name').  Nested defs are not call-resolvable
    by name from other functions and stay out of the table."""
    table: Dict[str, ast.AST] = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            table[node.name] = node
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    table[f"{node.name}.{sub.name}"] = sub
    return table


def _call_edges(fn: ast.AST, cls: Optional[str]) -> Set[str]:
    """Qualnames this function may call within its module: self.m() ->
    'Class.m', bare f() -> 'f'."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
                and f.value.id == "self" and cls:
            out.add(f"{cls}.{f.attr}")
        elif isinstance(f, ast.Name):
            out.add(f.id)
    return out


def reachable_functions(module: ModuleInfo,
                        roots: Iterable[str]) -> Dict[str, ast.AST]:
    """Transitive closure of the within-module call graph from root
    qualnames ('Class.method' / 'func').  Cross-module calls and
    unresolvable attribute calls are not followed — hot-path configs
    list roots per module instead."""
    table = function_table(module.tree)
    seen: Dict[str, ast.AST] = {}
    stack = [r for r in roots if r in table]
    while stack:
        qn = stack.pop()
        if qn in seen:
            continue
        seen[qn] = table[qn]
        cls = qn.split(".")[0] if "." in qn else None
        for callee in _call_edges(table[qn], cls):
            if callee in table and callee not in seen:
                stack.append(callee)
    return seen


# --------------------------------------------------------------------- #
# Config & context                                                       #
# --------------------------------------------------------------------- #

# the functions whose transitive (within-module) closure is "the hot
# path": one optimizer step and one decode cycle must stay sync-free.
# Each is the port's counterpart of the JAX package's root.
DEFAULT_HOT_ROOTS: Mapping[str, Tuple[str, ...]] = {
    "core/trainer.py": ("Trainer._fit_step", "Trainer._run_scanned_epoch",
                        "Trainer._place_train_item"),
    # the paged-serve loop plus the block allocator's bookkeeping (alloc
    # / release / lookup run per admit and retire, under the allocator
    # lock) and the chunked-prefill cursor advance, which runs between
    # decode waves (the one deliberate sync is the TTFT gate)
    "serve/engine.py": ("ServeEngine._run", "BlockAllocator.alloc",
                        "BlockAllocator.release",
                        "BlockAllocator.lookup_run",
                        "ServeEngine._advance_prefills",
                        "ServeEngine._advance_cursor"),
    # the paged decode step runs inside the serve loop
    "models/transformer.py": ("GPT.decode_step_rows_paged",
                              "GPT.decode_chunk_paged"),
    "utils/profiler.py": ("Profiler.span",),
    # the flight recorder's emit runs inside every other hot root
    "telemetry/recorder.py": ("FlightRecorder.emit",),
    # the perf observatory's seams run inside the fit loop's step
    # bracket: host scalars and metadata only
    "telemetry/perf.py": ("StepTimeline.step_end",
                          "StepTimeline.observe",
                          "HbmLedger.maybe_sample", "HbmLedger.sample"),
    # the live plane's handlers run beside the loops they observe
    "telemetry/live.py": ("LiveHandler.do_GET", "ClusterView.refresh"),
    # the SLO tracker's observers run per prefill / token in the loop
    "serve/slo.py": ("SloTracker.observe_ttft", "SloTracker.observe_token",
                     "SloTracker.shed"),
    # the JAX package's exchange and gather builders are compiled into
    # the step; the port runs these GradExchange methods every step, and
    # the scan gather's builders (JAX's names) and the per-layer hook the
    # model runs at the top of every layer
    "parallel/collectives.py": ("GradExchange.mean",
                                "GradExchange.reduce_scatter_mean",
                                "GradExchange.gather_params",
                                "GradExchange.gather_zero1",
                                "GradExchange.sum_scalar",
                                "GradExchange.exchange_leaf",
                                "GradExchange.exchange_rs_leaf",
                                "build_scan_param_gather",
                                "build_scan_local_grads",
                                "LayerGather.__call__"),
    "tune/run.py": ("autotune_step",),
    # the sequence-parallel attention bodies run in every layer of a
    # seq > 1 step
    "parallel/ulysses.py": ("ulysses_attention",),
    "parallel/ring_attention.py": ("ring_attention",),
    # the MPMD tick loop (worker) and step dispatcher (driver); the slot
    # barriers live in parallel/mpmd/handoff.py by design
    "parallel/mpmd/stage.py": ("StageRunner.run_step",),
    "parallel/mpmd/driver.py": ("PipelineRunner._run_step",),
}

# modules whose code runs inside dispatched workers: typed exceptions
# raised here cross the pipe as (name, message, tb) and must be
# rebuildable (runtime/wire.py)
DEFAULT_WORKER_MODULES: Tuple[str, ...] = (
    "runtime/actors.py", "runtime/bootstrap.py", "runtime/elastic.py",
    "runtime/object_store.py", "runtime/preemption.py", "runtime/queue.py",
    "runtime/session.py", "runtime/watchdog.py", "core/trainer.py",
    "testing/chaos.py", "testing/spmd_sanitizer.py",
    "parallel/mpmd/stage.py", "parallel/mpmd/handoff.py",
)

# modules that legitimately build layouts from specs -- the surface
# scripts/torch_sharding_audit.py inventories.  A spec constructor
# (``logical_to_spec`` / ``spec_layout``) anywhere else is a
# ``sharding-inventory`` finding, suppressible with a reasoned pragma.
DEFAULT_INVENTORY_MODULES: Tuple[str, ...] = (
    "parallel/mesh.py", "parallel/sharding.py", "parallel/collectives.py",
    "parallel/ulysses.py", "parallel/ring_attention.py",
    "parallel/pipeline.py", "parallel/plan.py", "core/trainer.py",
    "accelerators/base.py",
)

# the modules that build and load the port's libraries: exempt from the
# rebuild rule (they are the sanctioned builders)
DEFAULT_BUILD_MODULES: Tuple[str, ...] = ("ops/_build.py",
                                          "native/__init__.py")


@dataclass(frozen=True)
class LintConfig:
    knob_names: frozenset = frozenset()
    wire_names: frozenset = frozenset()
    # declared mesh axis names (extracted from `axes_module`): the only
    # names a collective's axis argument may resolve to
    spmd_axis_names: frozenset = frozenset()
    hot_roots: Mapping[str, Tuple[str, ...]] = field(
        default_factory=lambda: dict(DEFAULT_HOT_ROOTS))
    worker_modules: Tuple[str, ...] = DEFAULT_WORKER_MODULES
    inventory_modules: Tuple[str, ...] = DEFAULT_INVENTORY_MODULES
    build_modules: Tuple[str, ...] = DEFAULT_BUILD_MODULES
    # file (module key) the knob registry lives in: exempt from the
    # raw-environ rule (it IS the sanctioned reader)
    knobs_module: str = "analysis/knobs.py"
    wire_module: str = "runtime/wire.py"
    # file declaring the canonical mesh axis constants (DATA_AXIS ...
    # EXPERT_AXIS, AXIS_ORDER, BATCH_AXES, BATCH_GROUP)
    axes_module: str = "parallel/mesh.py"

    @classmethod
    def for_tree(cls, files: Mapping[str, str]) -> "LintConfig":
        """Config with knob/wire/axis registries extracted statically
        from the tree being linted (no package import needed)."""
        cfg = cls()
        knobs_src = files.get(cfg.knobs_module)
        if knobs_src is not None:
            cfg = replace(cfg, knob_names=_knob_names_from_source(knobs_src))
        wire_src = files.get(cfg.wire_module)
        if wire_src is not None:
            cfg = replace(cfg, wire_names=_wire_names_from_source(wire_src))
        axes_src = files.get(cfg.axes_module)
        if axes_src is not None:
            cfg = replace(cfg,
                          spmd_axis_names=_axis_names_from_source(axes_src))
        return cfg


def _knob_names_from_source(source: str) -> frozenset:
    """Names from Knob("LITERAL", ...) declarations."""
    names = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Call) and dotted(node.func) and \
                dotted(node.func).split(".")[-1] == "Knob" and node.args:
            first = node.args[0]
            if isinstance(first, ast.Constant) \
                    and isinstance(first.value, str):
                names.add(first.value)
    return frozenset(names)


def _wire_names_from_source(source: str) -> frozenset:
    """String literals of the WIRE_EXCEPTION_NAMES set."""
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == "WIRE_EXCEPTION_NAMES":
            return frozenset(
                c.value for c in ast.walk(node.value)
                if isinstance(c, ast.Constant) and isinstance(c.value, str))
    return frozenset()


def _axis_names_from_source(source: str) -> frozenset:
    """Declared mesh axis names of the axes module: the values of every
    module-level string constant (DATA_AXIS = "data", ...) plus every
    string reachable through a module-level tuple constant (AXIS_ORDER,
    BATCH_AXES) -- the registry the `spmd-collective` rule checks a
    group's axis against."""
    info = parse_module("<axes>", source)
    names = set(info.consts.values())
    for vals in info.tuple_consts.values():
        names.update(vals)
    return frozenset(names)


@dataclass
class LintContext:
    config: LintConfig
    modules: Dict[str, ModuleInfo]
    # tree-wide tables a rule computes once per run (the wire rule's
    # exception classes, each module's torch.distributed aliases)
    cache: Dict[str, object] = field(default_factory=dict)


# --------------------------------------------------------------------- #
# Driver                                                                 #
# --------------------------------------------------------------------- #

# mtime-keyed per-module parse cache (CLI/audit speed): repeated
# lint_path runs in one process — the test suite, multi-target CLI
# invocations, the sharding audit re-linting the package it just
# extracted from — reparse only files whose (mtime_ns, size) changed
_MODULE_CACHE: Dict[str, Tuple[int, int, str, ModuleInfo]] = {}


def _cached_parse(path: str, key: str) -> ModuleInfo:
    st = os.stat(path)
    hit = _MODULE_CACHE.get(path)
    if hit is not None and hit[0] == st.st_mtime_ns \
            and hit[1] == st.st_size and hit[2] == key:
        return hit[3]
    with open(path, encoding="utf-8") as f:
        info = parse_module(key, f.read())
    _MODULE_CACHE[path] = (st.st_mtime_ns, st.st_size, key, info)
    return info


def discover_modules(root: str) -> Tuple[Dict[str, ModuleInfo],
                                         List[Finding]]:
    """Parsed modules for every .py under ``root``, through the mtime
    cache.  Returns (module key -> ModuleInfo, parse-error findings)."""
    modules: Dict[str, ModuleInfo] = {}
    errors: List[Finding] = []
    root = os.path.abspath(root)
    paths: List[Tuple[str, str]] = []
    if os.path.isfile(root):
        paths.append((os.path.basename(root), root))
    else:
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    path = os.path.join(dirpath, fn)
                    key = os.path.relpath(path, root).replace(os.sep, "/")
                    paths.append((key, path))
    for key, path in paths:
        try:
            modules[key] = _cached_parse(path, key)
        except SyntaxError as e:
            errors.append(Finding("parse", key, e.lineno or 0, 0,
                                  f"syntax error: {e.msg}"))
    return modules, errors


def lint_modules(modules: Dict[str, ModuleInfo],
                 config: Optional[LintConfig] = None,
                 pre_findings: Optional[List[Finding]] = None
                 ) -> List[Finding]:
    """Lint pre-parsed modules (the cached-discovery path)."""
    if config is None:
        srcs = {k: "\n".join(m.lines) for k, m in modules.items()
                if k in (LintConfig.knobs_module, LintConfig.wire_module,
                         LintConfig.axes_module)}
        config = LintConfig.for_tree(srcs)
    return _lint_parsed(modules, config, list(pre_findings or []))


def run_lint(files: Mapping[str, str],
             config: Optional[LintConfig] = None) -> List[Finding]:
    """Lint in-memory sources (module key -> source).  Returns ALL
    findings; suppressed ones carry ``suppressed=True``."""
    if config is None:
        config = LintConfig.for_tree(files)
    modules: Dict[str, ModuleInfo] = {}
    findings: List[Finding] = []
    for key, source in files.items():
        try:
            modules[key] = parse_module(key, source)
        except SyntaxError as e:
            findings.append(Finding("parse", key, e.lineno or 0, 0,
                                    f"syntax error: {e.msg}"))
    return _lint_parsed(modules, config, findings)


def _lint_parsed(modules: Dict[str, ModuleInfo], config: LintConfig,
                 findings: List[Finding]) -> List[Finding]:
    from . import rules as rules_pkg

    ctx = LintContext(config=config, modules=modules)
    for module in modules.values():
        for line in module.pragma_missing_reason:
            findings.append(Finding(
                "pragma", module.key, line, 0,
                "graftlint pragma without a reason — write "
                "'# graftlint: ok(<rule>) — <why this is deliberate>'"))
        for rule in rules_pkg.ALL_RULES:
            findings.extend(rule.check(module, ctx))
    # inline suppression: pragma on the finding's line or the line above
    for f in findings:
        if f.rule == "pragma":
            continue
        module = modules.get(f.path)
        if module is None:
            continue
        for line in (f.line, f.line - 1):
            if f.rule in module.pragmas.get(line, ()):  # noqa: SIM110
                f.suppressed = True
                break
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def _package_root(path: str) -> Optional[str]:
    """Topmost enclosing package dir of a .py file (walk up while
    ``__init__.py`` exists), or None for a standalone file."""
    d = os.path.dirname(os.path.abspath(path))
    if not os.path.exists(os.path.join(d, "__init__.py")):
        return None
    while os.path.exists(os.path.join(os.path.dirname(d), "__init__.py")):
        d = os.path.dirname(d)
    return d


def lint_path(root: str,
              config: Optional[LintConfig] = None) -> List[Finding]:
    root_abs = os.path.abspath(root)
    if os.path.isfile(root_abs):
        pkg = _package_root(root_abs)
        if pkg is not None:
            # a file INSIDE a package: lint the whole enclosing package
            # (hot-root/worker-module keys, the knob/wire registries and
            # cross-module constants all resolve exactly as in a package
            # run — a basename key would silently no-op every path-keyed
            # rule and report a false clean), then report only the
            # requested file's findings
            key = os.path.relpath(root_abs, pkg).replace(os.sep, "/")
            modules, errors = discover_modules(pkg)
            return [f for f in lint_modules(modules, config, errors)
                    if f.path == key]
    modules, errors = discover_modules(root)
    return lint_modules(modules, config, errors)


def report(findings: List[Finding], verbose: bool = False) -> Tuple[str, int]:
    """(text, exit code): nonzero iff any unsuppressed finding."""
    active = [f for f in findings if not f.suppressed]
    lines = [f.format() for f in active]
    if verbose:
        lines += [f.format() for f in findings if f.suppressed]
    n_sup = sum(f.suppressed for f in findings)
    lines.append(f"graftlint: {len(active)} finding(s), "
                 f"{n_sup} suppressed by pragma")
    return "\n".join(lines), (1 if active else 0)


def report_json(findings: List[Finding],
                target: Optional[str] = None) -> Dict[str, object]:
    """Machine-readable findings (the CLI's ``--format json`` payload,
    reused by ``scripts/torch_sharding_audit.py``): every finding --
    suppressed ones included, flagged — plus the active/suppressed
    counts and the exit code the text reporter would use."""
    rows = [{"rule": f.rule, "path": f.path, "line": f.line, "col": f.col,
             "message": f.message, "suppressed": bool(f.suppressed)}
            for f in findings]
    active = sum(1 for f in findings if not f.suppressed)
    out: Dict[str, object] = {
        "schema": 1, "findings": rows, "active": active,
        "suppressed": len(rows) - active,
        "exit_code": 1 if active else 0,
    }
    if target is not None:
        out["target"] = target
    return out
