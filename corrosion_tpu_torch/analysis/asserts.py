"""strippable-assert: bare ``assert`` in library code (port of
``corrosion_tpu/analysis/asserts.py``).

``python -O`` compiles ``assert`` statements away entirely — every
invariant they guard silently stops being checked in exactly the
deployments that run optimized.

The fix is one of:

- ``raise ValueError(...)`` — caller handed in bad arguments/config;
- ``raise CheckpointIntegrityError(...)`` — a persisted artifact fails
  validation;
- ``registry.always(cond, name)`` — an internal invariant worth
  counting/reporting through the Antithesis-style registry.

Test code keeps its asserts (pytest rewrites them); point the runner at
library paths only.
"""

from __future__ import annotations

import ast
from typing import List

from corrosion_tpu_torch.analysis.base import Finding

RULE = "bare-assert"


def check(tree: ast.AST, source: str, path: str) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assert):
            continue
        try:
            cond = ast.unparse(node.test)
        except Exception:  # pragma: no cover - unparse is total on 3.9+
            cond = "<condition>"
        if len(cond) > 60:
            cond = cond[:57] + "..."
        findings.append(Finding(
            path=path, line=node.lineno, rule=RULE,
            message=f"bare assert `{cond}` is stripped under python -O",
            hint="raise ValueError/CheckpointIntegrityError, or route "
                 "through assertions.REGISTRY.always(...)",
        ))
    return findings
