"""``python -m corrosion_tpu_torch.analysis`` — run corrolint (port of
``corrosion_tpu/analysis/__main__.py``).

Exit status: 0 clean, 1 findings, 2 usage error. ``--format json``
emits a machine-readable findings array (one object per finding, the
``Finding`` fields verbatim) for editor/CI integration;
``--output-json PATH`` additionally writes a report (findings, per-rule
counts, file count). ``--changed <git-ref>`` lints only the Python files
touched since the ref (plus untracked ones) for fast pre-commit runs —
interprocedural facts are then derived from the touched subset only, so
the full walk remains the gate of record.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import List, Optional, Sequence

from corrosion_tpu_torch.analysis.base import RULES
from corrosion_tpu_torch.analysis.runner import (
    ALL_CHECKERS,
    PROJECT_CHECKERS,
    _select,
    lint_report,
)


def changed_python_files(ref: str) -> List[str]:
    """Tracked files changed vs ``ref`` plus untracked ones, limited
    to existing ``.py`` paths (repo-root relative, resolved to cwd)."""
    root = subprocess.check_output(
        ["git", "rev-parse", "--show-toplevel"], text=True
    ).strip()
    # -z: NUL-delimited, unquoted output — names with spaces or
    # non-ASCII must not be silently dropped from a pre-commit lint
    diff = subprocess.check_output(
        ["git", "diff", "--name-only", "--diff-filter=d", "-z", ref,
         "--", "*.py"], text=True, cwd=root,
    )
    untracked = subprocess.check_output(
        ["git", "ls-files", "--others", "--exclude-standard", "-z",
         "--", "*.py"], text=True, cwd=root,
    )
    names = {n for n in diff.split("\0") + untracked.split("\0") if n}
    out = []
    for rel in sorted(names):
        path = os.path.join(root, rel)
        if os.path.isfile(path):
            out.append(path)
    return out


def _write_report(path: str, findings, n_files: int) -> None:
    rule_counts: dict = {}
    for f in findings:
        rule_counts[f.rule] = rule_counts.get(f.rule, 0) + 1
    report = {
        "findings": [f.to_json() for f in findings],
        "rule_counts": rule_counts,
        "files_checked": n_files,
        "rules_available": sorted(RULES),
        "clean": not findings,
    }
    out_dir = os.path.dirname(path)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(report, fh, indent=2)
        fh.write("\n")


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m corrosion_tpu_torch.analysis",
        description="corrolint: lock-discipline, strippable-assert, the "
                    "interprocedural lock-order check, the sharding "
                    "contract, dtype-flow and densify",
    )
    parser.add_argument(
        "paths", nargs="*", default=None,
        help="files/directories to check (default: the installed "
             "corrosion_tpu_torch package, wherever the CLI runs from)",
    )
    parser.add_argument(
        "--format", choices=("text", "json"), default="text",
        help="findings output format",
    )
    parser.add_argument(
        "--checkers", default=None,
        help="comma-separated subset of "
             f"{sorted(ALL_CHECKERS) + sorted(PROJECT_CHECKERS)}",
    )
    parser.add_argument(
        "--changed", metavar="GIT_REF", default=None,
        help="lint only .py files changed vs the git ref (plus "
             "untracked ones); zero changed files exits 0",
    )
    parser.add_argument(
        "--output-json", metavar="PATH", default=None,
        help="also write a machine-readable report (findings, rule "
             "counts, files walked) to PATH",
    )
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print the rule catalog and exit",
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule, desc in sorted(RULES.items()):
            print(f"{rule}: {desc}")
        return 0

    checkers = (
        [c.strip() for c in args.checkers.split(",") if c.strip()]
        if args.checkers else None
    )
    if checkers is not None:
        # validate names up front (via the runner's own rule, so the
        # message can never drift) — a typo'd --checkers must fail
        # even on the zero-changed early exit, not lie dormant until
        # the next commit that touches files
        try:
            _select(checkers)
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 2
    paths = args.paths
    if args.changed is not None:
        # explicit paths must exist even in --changed mode — a typo'd
        # scope path would otherwise filter everything out and read as
        # "nothing changed, clean" forever (the same silent-clean the
        # empty-walk error guards against)
        for p in paths or ():
            if not os.path.exists(p):
                print(f"lint path {p!r} does not exist "
                      f"(cwd: {os.getcwd()})", file=sys.stderr)
                return 2
        try:
            changed = changed_python_files(args.changed)
        except (subprocess.CalledProcessError, OSError) as e:
            print(f"--changed failed: {e}", file=sys.stderr)
            return 2
        # keep only changed files inside the lint scope (the given
        # paths, or the gate's default surface: the package and
        # chip_smoke.py) — test files keep their pytest asserts by
        # design and must not drown a pre-commit run
        if paths:
            scope = [os.path.abspath(p) for p in paths]
        else:
            root = subprocess.check_output(
                ["git", "rev-parse", "--show-toplevel"], text=True
            ).strip()
            scope = [
                p for p in (
                    os.path.join(root, "corrosion_tpu_torch"),
                    os.path.join(root, "chip_smoke.py"),
                ) if os.path.exists(p)
            ]
        if scope:
            changed = [
                f for f in changed
                if any(os.path.abspath(f) == s
                       or os.path.abspath(f).startswith(s + os.sep)
                       for s in scope)
            ]
        paths = changed
        if not paths:
            # genuinely nothing to lint — distinct from the empty-walk
            # error below, which guards against typo'd paths. The
            # report artifact (if asked for) still gets refreshed so
            # trend tracking never republishes a stale run as current.
            if args.output_json:
                _write_report(args.output_json, [], 0)
            # keep stdout machine-readable under --format json (an
            # empty findings array); the human note goes to stderr
            if args.format == "json":
                print("[]")
            print(f"no python files changed vs {args.changed} "
                  "(within the lint scope)",
                  file=sys.stderr if args.format == "json" else
                  sys.stdout)
            return 0
    if not paths:
        # default to the package the CLI shipped in — a cwd-relative
        # default would exit 2 anywhere but the checkout root
        import corrosion_tpu_torch

        paths = [os.path.dirname(
            os.path.abspath(corrosion_tpu_torch.__file__))]
    try:
        findings, n_files = lint_report(paths, checkers)
    except (ValueError, OSError) as e:
        print(str(e), file=sys.stderr)
        return 2

    if args.output_json:
        _write_report(args.output_json, findings, n_files)

    if args.format == "json":
        print(json.dumps([f.to_json() for f in findings], indent=2))
    else:
        for f in findings:
            print(f.render())
        if findings:
            print(f"\n{len(findings)} finding(s). Suppress deliberate "
                  "ones with `# corrolint: disable=<rule> -- <reason>`.")
    return 1 if findings else 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:
        # downstream pager/head closed the pipe — normal unix behavior
        try:
            sys.stdout.close()
        finally:
            sys.exit(0)
