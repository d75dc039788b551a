"""graftlint for the PyTorch port: lint the port's tree, exit nonzero on
findings.

Usage::

    python scripts/torch_graftlint.py [PATH ...] [--verbose] [--format json]

Defaults to the ``ray_lightning_accelerators_tpu_torch`` package next to
this script.  ``--verbose`` also prints pragma-suppressed findings (the
deliberate, documented violations).  ``--format json`` prints one
machine-readable object (schema 1: every finding with rule / path /
line / col / message / suppressed, plus the active and suppressed
counts and the exit code), the shape ``scripts/torch_sharding_audit.py``
reads.  Exit codes: 0 clean, 1 an unsuppressed finding, 2 a bad
argument.

Only the port's ``analysis`` subpackage is loaded (stdlib-only AST
work, mounted on its own so the package ``__init__``, which imports
torch, never runs): linting needs no card and no torch.
"""

import importlib
import importlib.util
import os
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO_ROOT, "ray_lightning_accelerators_tpu_torch")


def _load_lint():
    """The port's analysis.lint, without the package ``__init__``."""
    pkg_dir = os.path.join(PACKAGE, "analysis")
    spec = importlib.util.spec_from_file_location(
        "_torch_graftlint_analysis", os.path.join(pkg_dir, "__init__.py"),
        submodule_search_locations=[pkg_dir])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["_torch_graftlint_analysis"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("_torch_graftlint_analysis.lint")


def main(argv) -> int:
    import json

    lint = _load_lint()

    verbose = "--verbose" in argv
    fmt = "human"
    args = list(argv)
    if "--format" in args:
        i = args.index("--format")
        if i + 1 >= len(args) or args[i + 1] not in ("human", "json"):
            print("graftlint: --format takes 'human' or 'json'",
                  file=sys.stderr)
            return 2
        fmt = args[i + 1]
        del args[i:i + 2]
    paths = [a for a in args if not a.startswith("--")]
    if not paths:
        paths = [PACKAGE]
    rc = 0
    if fmt == "json":
        merged = None
        for path in paths:
            payload = lint.report_json(lint.lint_path(path), target=path)
            if merged is None:
                merged = payload
            else:  # several targets: one object, findings concatenated
                merged["findings"] += payload["findings"]
                merged["active"] += payload["active"]
                merged["suppressed"] += payload["suppressed"]
                merged["target"] = None
            rc = max(rc, payload["exit_code"])
        merged = merged or lint.report_json([])
        merged["exit_code"] = rc
        print(json.dumps(merged, indent=2, sort_keys=True))
        return rc
    for path in paths:
        findings = lint.lint_path(path)
        text, code = lint.report(findings, verbose=verbose)
        print(f"== graftlint: {path}")
        print(text)
        rc = max(rc, code)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
