"""Inline always/sometimes assertions — the Antithesis SDK analog.

The reference instruments its hot paths with ``antithesis_sdk`` macros:
``assert_always`` invariants (e.g. "deleted non-contiguous seq ranges!"
``util.rs:1160-1165``, "bookie lock held too long" ``setup.rs:226-231``)
and ``assert_sometimes`` liveness probes (e.g. "Corrosion syncs with
other nodes" ``handlers.rs:837``), which the Antithesis hypervisor
aggregates across fault-injected runs (SURVEY §4).

Here the registry aggregates in-process: ``always`` violations log +
count (and optionally raise under ``CORRO_TPU_STRICT_ASSERTS=1``, the
test-mode equivalent of failing the Antithesis run); ``sometimes`` probes
record whether each liveness property was ever observed, and
``liveness_report`` lists the ones that never fired — the signal
Antithesis calls an unreachable ``assert_sometimes``.
"""

from __future__ import annotations

import os
import threading
from typing import Dict

from corrosion_tpu_torch.utils.tracing import logger


class AssertionRegistry:
    def __init__(self):
        self._always: Dict[str, list] = {}  # name -> [passes, failures]
        self._sometimes: Dict[str, list] = {}  # name -> [checks, hits]
        self._mu = threading.Lock()

    @property
    def strict(self) -> bool:
        return os.environ.get("CORRO_TPU_STRICT_ASSERTS", "") == "1"

    def always(self, condition: bool, name: str, details: str = "") -> bool:
        """Invariant: must hold on every evaluation."""
        with self._mu:
            rec = self._always.setdefault(name, [0, 0])
            rec[0 if condition else 1] += 1
        if not condition:
            logger.error("assert_always violated: %s%s", name,
                         f" ({details})" if details else "")
            if self.strict:
                raise AssertionError(f"assert_always violated: {name} {details}")
        return bool(condition)

    def sometimes(self, condition: bool, name: str) -> bool:
        """Liveness probe: should hold at least once across a run."""
        with self._mu:
            rec = self._sometimes.setdefault(name, [0, 0])
            rec[0] += 1
            if condition:
                rec[1] += 1
        return bool(condition)

    def unreachable(self, name: str, details: str = "") -> None:
        """A state that must never be reached (``assert_unreachable``,
        ``agent.rs:664-667``)."""
        self.always(False, f"unreachable: {name}", details)

    # --- reporting --------------------------------------------------------
    def violations(self) -> Dict[str, int]:
        with self._mu:
            return {k: v[1] for k, v in self._always.items() if v[1]}

    def liveness_report(self) -> Dict[str, dict]:
        """Per-probe evaluation/hit counts; ``never_hit`` marks probes
        that were checked but never observed true."""
        with self._mu:
            return {
                k: {"checks": v[0], "hits": v[1], "never_hit": v[1] == 0}
                for k, v in self._sometimes.items()
            }

    def snapshot(self) -> dict:
        with self._mu:
            return {
                "always": {k: {"passes": v[0], "failures": v[1]}
                           for k, v in self._always.items()},
                "sometimes": {k: {"checks": v[0], "hits": v[1]}
                              for k, v in self._sometimes.items()},
            }


REGISTRY = AssertionRegistry()


def assert_always(condition: bool, name: str, details: str = "") -> bool:
    return REGISTRY.always(condition, name, details)


def assert_sometimes(condition: bool, name: str) -> bool:
    return REGISTRY.sometimes(condition, name)


def assert_unreachable(name: str, details: str = "") -> None:
    REGISTRY.unreachable(name, details)
