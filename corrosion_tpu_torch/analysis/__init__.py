"""corrolint and corrosan: the host plane's static and runtime analysis
(port of ``corrosion_tpu/analysis/``).

The runtime layers lean on Antithesis-style always/sometimes
instrumentation (``utils/assertions.py``) — check the invariant
everywhere, mechanically. This package applies the same philosophy
*before* runtime with AST checkers over the codebase, catching bug
classes a runtime test only catches on the path it happens to take:

- **lock-discipline** (``locks.py``) — threaded writers/supervisors
  guarding shared state with one ``threading.Lock``: mutations outside
  the lock, blocking IO or a device sync under it.
- **strippable-assert** (``asserts.py``) — bare ``assert`` in library
  code vanishes under ``python -O``.
- **lock-order** (``lockorder.py``, interprocedural over the module
  call graph of ``callgraph.py``) — ``lock-cycle`` /
  ``lock-inversion``: the cross-class lock-acquisition-order graph must
  stay acyclic.

``python -m corrosion_tpu_torch.analysis [--format text|json] [paths]``
(or ``python -m corrosion_tpu_torch lint``) runs them all and exits
nonzero on findings (``--changed <git-ref>`` lints only touched files;
``--output-json`` writes the report). Inline suppressions:
``# corrolint: disable=<rule> -- <reason>`` (the reason is required).

The runtime half, ``sanitizer/`` (corrosan), witnesses one execution:
happens-before attribute races, the lock order it saw against this
package's static graph, file resurrection and thread/executor/fd leaks.
"""

from corrosion_tpu_torch.analysis.base import Finding, RULES
from corrosion_tpu_torch.analysis.runner import (
    ALL_CHECKERS,
    PROJECT_CHECKERS,
    check_source,
    iter_python_files,
    lint_report,
    run_paths,
)

__all__ = [
    "ALL_CHECKERS",
    "PROJECT_CHECKERS",
    "Finding",
    "RULES",
    "check_source",
    "iter_python_files",
    "lint_report",
    "run_paths",
]
