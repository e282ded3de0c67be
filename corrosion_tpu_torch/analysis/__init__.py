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
- **sharding-contract** (``sharding.py``, interprocedural over the same
  call graph with ``dataflow.py``) — ``shard-gather`` / ``shard-spec-
  drift``: node-sharded state is never materialized whole outside the
  drain registry, and a sharded entry point gets placed state.
- **dtype-flow** (``dtypes.py``, on ``dataflow.py``) — ``dtype-widen``:
  a declared-narrow plane (int16/int8) never receives a value that
  torch's promotion widened, at a ``_replace``/constructor keyword or a
  kernel ref store.
- **densify** (``shapes.py``'s symbolic shape interpreter) — an
  intermediate whose N-degree exceeds every input's (the N x N pairwise
  broadcast) outside the full view.

``python -m corrosion_tpu_torch.analysis [--format text|json] [paths]``
(or ``python -m corrosion_tpu_torch lint``) runs them all and exits
nonzero on findings (``--changed <git-ref>`` lints only touched files;
``--output-json`` writes the report). Inline suppressions:
``# corrolint: disable=<rule> -- <reason>`` (the reason is required).

The runtime half, ``sanitizer/`` (corrosan), witnesses one execution:
happens-before attribute races, the lock order it saw against this
package's static graph, file resurrection and thread/executor/fd leaks.

Beside them, corrobudget and corrocost: ``shapes.py`` (the state's
symbolic shape inventory from the ``meta`` device and from the
constructors' source, and the 1M budget gate, ``check_budget``) and
``cost.py`` (a round's operations and memory-model bytes, exact fits in
the extents, the 1M roofline and the degree gate, ``check_degrees``);
both gates run as tests.
"""

from corrosion_tpu_torch.analysis import dtypes, shapes
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
    "dtypes",
    "iter_python_files",
    "lint_report",
    "run_paths",
    "shapes",
]
