"""kgct-torch-lint CLI: run the rule suite over the port's source trees.

Exit codes: 0 clean, 1 findings, 2 usage error. The tier-1 test
(tests/test_torch_lint.py) drives the same :func:`run_lint` this wraps,
so the CLI and CI can never disagree on what "clean" means. No allowlist flag exists on
purpose: a finding is fixed, not suppressed.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

from .core import run_lint
from .rules import ALL_RULES, rules_by_code
from .sarif import to_sarif

# Default lint scope: the package itself (this file's grandparent).
PACKAGE_ROOT = Path(__file__).resolve().parents[1]


def default_paths() -> list:
    return [PACKAGE_ROOT]


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="kgct-torch-lint",
        description=("Static analysis for the PyTorch serving engine: "
                     "hot-path host syncs, KV commit and export safety, "
                     "the worker seam, asyncio/metric/logging hygiene. "
                     "Zero findings is the enforced baseline "
                     "(tests/test_torch_lint.py)."))
    p.add_argument("paths", nargs="*", type=Path,
                   help="files/directories to lint (default: the installed "
                        "package)")
    p.add_argument("--select", default="",
                   help="comma-separated rule codes or names to run "
                        "(default: all)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule table and exit")
    p.add_argument("--format", choices=("text", "json", "sarif"),
                   default="text",
                   help="findings output format (default: text)")
    p.add_argument("--sarif", type=Path, metavar="PATH", default=None,
                   help="also write a SARIF 2.1.0 artifact to PATH "
                        "(independent of --format; CI attaches it next to "
                        "the tier-1 log)")
    p.add_argument("--changed", metavar="GIT_REF", default=None,
                   help="lint only .py files changed vs GIT_REF (plus "
                        "untracked ones), intersected with the lint scope "
                        "— pre-commit runs in seconds; the rule set is "
                        "unchanged")
    return p


def changed_files(ref: str, root: Path) -> list:
    """.py files differing from ``ref`` (committed changes) plus
    untracked ones — the files a pre-commit run must re-lint. Deleted
    files are excluded (nothing to parse)."""
    def git(*args: str) -> str:
        return subprocess.run(["git", *args], cwd=root, check=True,
                              capture_output=True, text=True).stdout

    names = git("diff", "--name-only", "--diff-filter=d", ref,
                "--", "*.py").splitlines()
    names += git("ls-files", "--others", "--exclude-standard",
                 "--", "*.py").splitlines()
    return sorted({root / n for n in names if n.strip()
                   if (root / n).is_file()})


def _in_scope(path: Path, scope: list) -> bool:
    path = path.resolve()
    for s in scope:
        s = Path(s).resolve()
        if path == s or (s.is_dir() and s in path.parents):
            return True
    return False


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)

    if args.list_rules:
        for rule in ALL_RULES:
            print(f"{rule.code}  {rule.name:<22} {rule.description}")
        return 0

    try:
        rules = (rules_by_code(args.select.split(","))
                 if args.select else None)
    except ValueError as e:
        print(f"kgct-torch-lint: {e}", file=sys.stderr)
        return 2

    paths = args.paths or default_paths()
    missing = [p for p in paths if not Path(p).exists()]
    if missing:
        print(f"kgct-torch-lint: no such path: "
              f"{', '.join(str(m) for m in missing)}", file=sys.stderr)
        return 2

    root = Path.cwd()
    if args.changed is not None:
        try:
            paths = [p for p in changed_files(args.changed, root)
                     if _in_scope(p, paths)]
        except subprocess.CalledProcessError as e:
            print(f"kgct-torch-lint: git diff vs {args.changed!r} failed: "
                  f"{e.stderr.strip()}", file=sys.stderr)
            return 2
    findings = run_lint(paths, rules=rules, root=root)

    active = rules if rules is not None else ALL_RULES
    if args.sarif is not None:
        args.sarif.write_text(
            json.dumps(to_sarif(findings, active), indent=2) + "\n")
    if args.format == "sarif":
        print(json.dumps(to_sarif(findings, active), indent=2))
    elif args.format == "json":
        print(json.dumps([f.as_dict() for f in findings], indent=2))
    else:
        for f in findings:
            print(f.format())
    n_rules = len(rules) if rules is not None else len(ALL_RULES)
    print(f"kgct-torch-lint: {len(findings)} finding(s) "
          f"({n_rules} rule(s))", file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
