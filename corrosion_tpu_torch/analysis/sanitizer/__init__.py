"""corrosan: runtime concurrency sanitizer + leak gate (port of
``corrosion_tpu/analysis/sanitizer/``).

The dynamic complement to corrolint: where the static checkers prove
properties about source text, corrosan *witnesses* one execution —

- a **vector-clock happens-before race detector** over the
  lock-disciplined classes corrolint indexes (``attrs.py``);
- a **runtime lock-order witness** whose edges must stay a subset of
  ``analysis/lockorder.py``'s static graph (``witness.py``);
- a **filesystem witness** for the unsubscribe-vs-persist resurrection
  bug class (``fsops.py``);
- a **thread / executor / fd leak gate** at teardown (``leaks.py``).

Entry points: ``with sanitized() as san: ...; san.gate()`` for scoped
windows, the pytest plugin (``plugin.py``, ``--corrosan`` /
``CORROSAN=1``) for whole sanitized runs, ``CORROSAN=1`` on the CLI's
``chaos``/``fuzz``/``load``, and ``python -m corrosion_tpu_torch san``
(``__main__.py``) to replay the seeded-race fixtures.
"""

from corrosion_tpu_torch.analysis.sanitizer.fixtures import (
    FIXTURES,
    FixtureResult,
    run_all_fixtures,
    run_fixture,
)
from corrosion_tpu_torch.analysis.sanitizer.hooks import watch_dir
from corrosion_tpu_torch.analysis.sanitizer.report import (
    KINDS,
    SanFinding,
    findings_payload,
    write_section,
)
from corrosion_tpu_torch.analysis.sanitizer.runtime import Sanitizer, sanitized
from corrosion_tpu_torch.analysis.sanitizer.witness import static_lock_graph

__all__ = [
    "FIXTURES",
    "FixtureResult",
    "KINDS",
    "SanFinding",
    "Sanitizer",
    "findings_payload",
    "run_all_fixtures",
    "run_fixture",
    "sanitized",
    "static_lock_graph",
    "watch_dir",
    "write_section",
]
