"""Sharding inventory audit of the PyTorch port: one JSON map of every
layout declaration, the spec constructors and the groups.

The port's layouts are built by the spec constructors of
``parallel/sharding.py`` (``logical_to_spec``, ``spec_layout``) and run
over the per-axis groups ``parallel/mesh.py`` makes
(``RankMesh.group(axis)``).  This script extracts them statically (AST
only: it imports neither torch nor the package) into
``ray_lightning_accelerators_tpu_torch/SHARDING_INVENTORY.json``:

- per inventoried module: every spec-constructor call (line, source
  text), every ``.group(...)`` lookup, and the axes module's constants;
- the axis and group-name registry of ``parallel/mesh.py`` (string and
  tuple constants, ``DATA_AXIS`` ... ``BATCH_AXES``, ``BATCH_GROUP``);
- totals, so a diff of the committed artifact shows inventory drift.

Drift gate: the lint's ``sharding-inventory`` rule flags a spec
constructor outside the inventoried modules.  This script runs the lint
in-process (``lint.report_json``, the ``--format json`` payload of
``scripts/torch_graftlint.py``) and exits nonzero when such a finding is
active.

Usage::

    python scripts/torch_sharding_audit.py [--out PATH] [--no-write]
                                           [--quiet] [--skip-drift]

Exit codes: 0 clean, 1 uninventoried spec constructors (listed).
``--skip-drift`` extracts the inventory only (no lint pass).
"""

import ast
import importlib
import importlib.util
import json
import os
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO_ROOT, "ray_lightning_accelerators_tpu_torch")
DEFAULT_OUT = os.path.join(PACKAGE, "SHARDING_INVENTORY.json")


def _load_lint():
    """The port's analysis.lint without the package ``__init__`` (no
    torch import)."""
    pkg_dir = os.path.join(PACKAGE, "analysis")
    spec = importlib.util.spec_from_file_location(
        "_torch_audit_analysis", os.path.join(pkg_dir, "__init__.py"),
        submodule_search_locations=[pkg_dir])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["_torch_audit_analysis"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("_torch_audit_analysis.lint")


def _unparse(node, lines):
    try:
        return ast.unparse(node)
    except Exception:
        return lines[node.lineno - 1].strip()


def extract_inventory(lint):
    """The inventory dict (schema 1) over the configured modules."""
    rule = importlib.import_module(
        "_torch_audit_analysis.rules.sharding_inventory")
    modules, errors = lint.discover_modules(PACKAGE)
    config = lint.LintConfig.for_tree(
        {k: "\n".join(m.lines) for k, m in modules.items()})
    inv_modules = {}
    total_specs = total_groups = 0
    for key in config.inventory_modules:
        info = modules.get(key)
        if info is None:
            inv_modules[key] = {"missing": True}
            continue
        specs, groups = [], []
        for node in ast.walk(info.tree):
            if rule.spec_call(node):
                specs.append({"line": node.lineno,
                              "text": _unparse(node, info.lines)})
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "group" and len(node.args) == 1:
                groups.append({"line": node.lineno,
                               "text": _unparse(node, info.lines)})
        specs.sort(key=lambda r: (r["line"], r["text"]))
        groups.sort(key=lambda r: (r["line"], r["text"]))
        inv_modules[key] = {"spec_constructors": specs,
                            "group_lookups": groups}
        if key == config.axes_module:
            inv_modules[key]["axis_constants"] = dict(info.consts)
            inv_modules[key]["axis_tuples"] = {
                n: list(v) for n, v in info.tuple_consts.items()}
        total_specs += len(specs)
        total_groups += len(groups)
    return {
        "schema": 1,
        "axis_names": sorted(config.spmd_axis_names),
        "inventory_modules": list(config.inventory_modules),
        "modules": inv_modules,
        "totals": {"spec_constructor_calls": total_specs,
                   "group_lookups": total_groups,
                   "modules": len(config.inventory_modules)},
        "parse_errors": [f.format() for f in errors],
    }


def drift_findings(lint):
    """Active sharding-inventory findings, in the ``--format json``
    payload shape."""
    payload = lint.report_json(lint.lint_path(PACKAGE), target=PACKAGE)
    return [f for f in payload["findings"]
            if f["rule"] == "sharding-inventory" and not f["suppressed"]]


def main(argv) -> int:
    out_path = DEFAULT_OUT
    if "--out" in argv:
        out_path = argv[argv.index("--out") + 1]
    write = "--no-write" not in argv
    quiet = "--quiet" in argv

    lint = _load_lint()
    inventory = extract_inventory(lint)
    drift = [] if "--skip-drift" in argv else drift_findings(lint)
    inventory["uninventoried"] = drift

    if write:
        tmp = out_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(inventory, f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, out_path)

    record = {
        "kind": "sharding_audit",
        "spec_constructor_calls":
            inventory["totals"]["spec_constructor_calls"],
        "group_lookups": inventory["totals"]["group_lookups"],
        "modules": inventory["totals"]["modules"],
        "axis_names": len(inventory["axis_names"]),
        # None: the drift pass was skipped
        "uninventoried": (None if "--skip-drift" in argv else len(drift)),
        "out": out_path if write else None,
    }
    print(json.dumps(record, sort_keys=True))
    if drift:
        if not quiet:
            print("torch_sharding_audit: spec constructors OUTSIDE the "
                  "inventoried modules (add a reasoned pragma, or move "
                  "the layout behind parallel/sharding.py):",
                  file=sys.stderr)
            for f in drift:
                print(f"  {f['path']}:{f['line']}: {f['message'][:100]}",
                      file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
