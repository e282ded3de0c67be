"""Shared checker plumbing: findings, rule catalog, suppressions (port
of ``corrosion_tpu/analysis/base.py``).

A checker is a callable ``(tree, source, path) -> list[Finding]``. The
runner owns file walking and suppression filtering so every checker
stays a pure AST pass.

Suppression syntax (reason REQUIRED — a suppression that does not say
why is itself a finding, the same contract as the registry's named
assertions)::

    risky_line()  # corrolint: disable=bare-assert -- validated at boot

The comment suppresses matching findings on its own line; on a line of
its own it suppresses the NEXT line (for statements too long to share a
line with a justification).
"""

from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize
from typing import Dict, List, Tuple

#: rule id -> one-line description (the CLI's ``--list-rules`` catalog)
RULES: Dict[str, str] = {
    "unlocked-mutation": (
        "method of a lock-owning class mutates private shared state "
        "outside `with self.<lock>:`"
    ),
    "blocking-under-lock": (
        "file IO / .result() / device sync / sleep while holding the "
        "instance lock"
    ),
    "bare-assert": (
        "bare `assert` in library code — stripped under `python -O`, the "
        "invariant silently stops being checked"
    ),
    "suppression-missing-reason": (
        "`# corrolint: disable=...` without a `-- reason` justification"
    ),
    # --- interprocedural rules (call graph + lock-order graph) ---
    "lock-cycle": (
        "non-reentrant lock re-acquired while held, or a >2-lock "
        "acquisition cycle across the call graph (deadlock)"
    ),
    "lock-inversion": (
        "two locks acquired in opposite orders on two code paths "
        "(ABBA deadlock across threads)"
    ),
    "shard-gather": (
        "node-sharded state materialized whole (np.asarray/.cpu()/.numpy()/"
        "ShardedTree.assemble/whole-tree drain) outside the sharding drain "
        "registry"
    ),
    "shard-spec-drift": (
        "freshly-built state passed into a sharded entry point without "
        "`shard_state` placement"
    ),
    "dtype-widen": (
        "declared-narrow (int16/int8) state leaf receives a silently "
        "promotion-widened value at a carry/kernel boundary (torch's "
        "promotion) — multiplies the plane's bytes and fails the kernel "
        "wrappers' dtype check on the card"
    ),
    "densify": (
        "intermediate tensor whose N-degree exceeds every input's "
        "(an N x N pairwise broadcast: fits at 100k, OOMs at 1M)"
    ),
}


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    path: str
    line: int
    rule: str
    message: str
    hint: str = ""

    def render(self) -> str:
        tail = f" (fix: {self.hint})" if self.hint else ""
        return f"{self.path}:{self.line}: {self.rule}: {self.message}{tail}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


_SUPPRESS_RE = re.compile(
    r"#\s*corrolint:\s*disable=([a-z0-9_,\- ]+?)\s*(?:--\s*(\S.*))?$"
)


def _comment_tokens(source: str):
    """(line, col, text) for every real COMMENT token. Tokenizing keeps
    directives inside string literals inert — they neither suppress a
    finding nor misfire as a reasonless suppression."""
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                yield tok.start[0], tok.start[1], tok.string
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return  # unparseable tail: the syntax-error finding covers it


def parse_suppressions(
    source: str, path: str
) -> Tuple[Dict[int, set], List[Finding]]:
    """Map line -> suppressed rule ids, plus findings for suppressions
    that carry no reason. A suppression on a line with no code applies
    to the following line."""
    by_line: Dict[int, set] = {}
    bad: List[Finding] = []
    lines = source.splitlines()
    for lineno, col, text in _comment_tokens(source):
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        if not m.group(2):
            bad.append(Finding(
                path=path, line=lineno, rule="suppression-missing-reason",
                message=f"suppression for {', '.join(sorted(rules))} has "
                        "no reason",
                hint="append `-- <why this is deliberate>`",
            ))
            continue
        target = lineno
        if lines[lineno - 1][:col].strip() == "":
            target = lineno + 1  # standalone comment guards the next line
        by_line.setdefault(target, set()).update(rules)
    return by_line, bad


def walk_shallow(node):
    """``ast.walk`` that does not descend into nested function/lambda
    bodies — their statements run at call time, not here."""
    stack = [node]
    while stack:
        cur = stack.pop()
        yield cur
        for child in ast.iter_child_nodes(cur):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            stack.append(child)


def dotted_name(node) -> str:
    """``a.b.c`` for Name/Attribute chains, '' for anything else."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return ""
    parts.append(node.id)
    return ".".join(reversed(parts))
