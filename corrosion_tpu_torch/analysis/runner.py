"""File walking + checker orchestration for ``corrolint`` (port of
``corrosion_tpu/analysis/runner.py``).

``run_paths`` is the whole engine: walk the given files/directories,
parse each Python file once, run every (selected) per-file checker
over its tree, build the project call graph, run the (selected)
interprocedural project checkers over it, apply inline suppressions,
de-duplicate, and return sorted findings. The CLI (``__main__``,
``python -m corrosion_tpu_torch lint``) and the tier-1 gate
(``tests/test_torch_analysis.py``) both call it, so the lint that
blocks CI is byte-identical to the one run by hand.

Two checker shapes:

- **per-file** (:data:`ALL_CHECKERS`) — ``(tree, source, path) ->
  [Finding]``, pure AST passes over one file;
- **project** (:data:`PROJECT_CHECKERS`) — ``(Project) -> [Finding]``,
  interprocedural passes over the whole walked set (call graph). On a
  partial walk (``--changed``) they still run, over just the walked
  files — facts are derived from the SUBSET's view, so cross-file facts
  whose other half was not walked go missing, and a bare name that is
  only unique within the subset can resolve where the full walk would
  abstain. The full walk is the gate of record; ``--changed`` is the
  fast pre-commit approximation.

The sharding contract (``sharding.py``) holds over the port's mesh
surfaces (``parallel/mesh.py``). The JAX package's jit, donation and
collective tiers have no counterpart here: the port has no jit, no
donation, and writes its cross-shard exchanges out (``parallel/
exchange.py`` counts their bytes); its dtype and shape-interpreter tiers
are still to come (ROADMAP).
"""

from __future__ import annotations

import ast
import os
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

from corrosion_tpu_torch.analysis import asserts, locks, lockorder, sharding
from corrosion_tpu_torch.analysis.base import Finding, parse_suppressions
from corrosion_tpu_torch.analysis.callgraph import (
    ModuleInfo,
    Project,
    module_name_for,
)

#: per-file checker name -> callable(tree, source, path) -> [Finding]
ALL_CHECKERS: Dict[str, Callable] = {
    "lock-discipline": locks.check,
    "strippable-assert": asserts.check,
}

#: project checker name -> callable(Project) -> [Finding]
PROJECT_CHECKERS: Dict[str, Callable] = {
    "lock-order": lockorder.check_project,
    "sharding-contract": sharding.check_project,
}

_SKIP_DIRS = {"__pycache__", ".git", "node_modules"}


def iter_python_files(paths: Iterable[str]) -> Iterator[str]:
    """Python files under ``paths``. A path that does not exist raises:
    for a lint GATE, "walked zero files" must never read as "clean" —
    a typo'd path or wrong cwd would otherwise exit 0."""
    for path in paths:
        if os.path.isfile(path):
            if path.endswith(".py"):
                yield path
            continue
        if not os.path.isdir(path):
            raise FileNotFoundError(
                f"lint path {path!r} does not exist (cwd: {os.getcwd()})"
            )
        for root, dirs, files in os.walk(path):
            dirs[:] = sorted(d for d in dirs if d not in _SKIP_DIRS)
            for name in sorted(files):
                if name.endswith(".py"):
                    yield os.path.join(root, name)


def _select(checkers: Optional[Iterable[str]]) -> Tuple[Dict, Dict]:
    """(per-file, project) checker subsets for a ``--checkers`` spec."""
    if checkers is None:
        return ALL_CHECKERS, PROJECT_CHECKERS
    names = list(checkers)
    unknown = set(names) - set(ALL_CHECKERS) - set(PROJECT_CHECKERS)
    if unknown:
        raise ValueError(
            f"unknown checkers: {sorted(unknown)} (available: "
            f"{sorted(ALL_CHECKERS) + sorted(PROJECT_CHECKERS)})"
        )
    return (
        {k: ALL_CHECKERS[k] for k in names if k in ALL_CHECKERS},
        {k: PROJECT_CHECKERS[k] for k in names if k in PROJECT_CHECKERS},
    )


def _lint_sources(
    sources: List[Tuple[str, str]],
    per_file: Dict[str, Callable],
    project_checkers: Dict[str, Callable],
) -> List[Finding]:
    """The shared engine body over parsed (path, source) pairs."""
    findings: List[Finding] = []
    suppressions: Dict[str, Dict[int, set]] = {}
    modules = []
    for path, source in sources:
        by_line, bad = parse_suppressions(source, path)
        suppressions[path] = by_line
        findings.extend(bad)
        try:
            tree = ast.parse(source)
        except SyntaxError as e:
            findings.append(Finding(
                path=path, line=e.lineno or 0, rule="syntax-error",
                message=f"not parseable: {e.msg}",
            ))
            continue
        for _, checker in sorted(per_file.items()):
            findings.extend(checker(tree, source, path))
        modules.append(ModuleInfo(
            path=path, name=module_name_for(path), tree=tree,
            source=source, suppressions=by_line, bad_suppressions=bad,
        ))
    if project_checkers and modules:
        project = Project(modules)
        for _, checker in sorted(project_checkers.items()):
            findings.extend(checker(project))
    kept = [
        f for f in findings
        if f.rule not in suppressions.get(f.path, {}).get(f.line, ())
    ]
    return sorted(set(kept))


def check_source(
    source: str,
    path: str = "<string>",
    checkers: Optional[Dict[str, Callable]] = None,
) -> List[Finding]:
    """Run checkers over one source blob (the test-fixture entry
    point). Suppressions are honored; a suppression with no reason is
    itself a finding. ``checkers`` maps names to callables — names in
    :data:`PROJECT_CHECKERS` run as project passes over the one-file
    project."""
    if checkers is None:
        per_file, project_checkers = ALL_CHECKERS, PROJECT_CHECKERS
    else:
        per_file = {k: v for k, v in checkers.items()
                    if k not in PROJECT_CHECKERS}
        project_checkers = {k: v for k, v in checkers.items()
                            if k in PROJECT_CHECKERS}
    return _lint_sources([(path, source)], per_file, project_checkers)


def lint_report(
    paths: Iterable[str],
    checkers: Optional[Iterable[str]] = None,
) -> Tuple[List[Finding], int]:
    """(findings, files walked) over ``paths`` — the machine-readable
    artifact's data source."""
    per_file, project_checkers = _select(checkers)
    sources: List[Tuple[str, str]] = []
    for file_path in iter_python_files(paths):
        with open(file_path, "r", encoding="utf-8") as f:
            sources.append((file_path, f.read()))
    if not sources:
        raise FileNotFoundError(
            f"no Python files under {list(paths)!r} — refusing to "
            f"report a clean result for an empty walk"
        )
    return _lint_sources(sources, per_file, project_checkers), len(sources)


def run_paths(
    paths: Iterable[str],
    checkers: Optional[Iterable[str]] = None,
) -> List[Finding]:
    """All findings over ``paths``, suppressions applied, sorted by
    (path, line)."""
    return lint_report(paths, checkers)[0]
