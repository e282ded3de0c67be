"""Hybrid logical clock (HLC).

Mirrors the reference's use of ``uhlc`` (``agent/setup.rs:96-101``): a
clock whose timestamps combine wall time with a logical counter so they
are totally ordered, monotonic, and close to physical time. The agent
stamps every local write (``crsql_set_ts``, ``public/mod.rs:88-100``) and
folds in every remote timestamp it sees — from changes
(``handlers.rs:689-701``) and sync handshakes (``peer/mod.rs:1439-1458``)
— rejecting remote clocks that are too far ahead (max drift 300 ms,
``setup.rs:100``).

Timestamp encoding follows uhlc/NTP64: the physical part in the high bits
at micro-ish resolution, a logical counter in the low 16 bits.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, NamedTuple

LOGICAL_BITS = 16
LOGICAL_MASK = (1 << LOGICAL_BITS) - 1
DEFAULT_MAX_DELTA_MS = 300.0  # setup.rs:100


class Timestamp(NamedTuple):
    """(time, id): totally ordered, id breaks ties (uhlc semantics)."""

    ntp: int  # physical micros << 16 | logical counter
    actor: int

    @property
    def physical_us(self) -> int:
        return self.ntp >> LOGICAL_BITS

    @property
    def logical(self) -> int:
        return self.ntp & LOGICAL_MASK

    def __str__(self) -> str:
        return f"{self.physical_us}.{self.logical}@{self.actor}"


class ClockDriftError(Exception):
    """Remote timestamp exceeds the configured max drift."""


class HLClock:
    """Thread-safe hybrid logical clock for one actor."""

    def __init__(
        self,
        actor: int,
        max_delta_ms: float = DEFAULT_MAX_DELTA_MS,
        now_us: Callable[[], int] = lambda: time.time_ns() // 1000,
    ):
        self.actor = actor
        self.max_delta_us = int(max_delta_ms * 1000)
        self._now_us = now_us
        self._last = 0  # last issued ntp value
        self._mu = threading.Lock()

    def new_timestamp(self) -> Timestamp:
        """Issue a strictly monotonic local timestamp."""
        with self._mu:
            phys = self._now_us() << LOGICAL_BITS
            self._last = max(self._last + 1, phys)
            return Timestamp(self._last, self.actor)

    def peek(self) -> Timestamp:
        with self._mu:
            return Timestamp(self._last, self.actor)

    def update_with_timestamp(self, ts: Timestamp) -> None:
        """Fold in a remote timestamp; raise if it is too far ahead.

        Matches uhlc ``update_with_timestamp``: the local clock jumps
        forward to stay >= every observed remote stamp, but refuses stamps
        more than ``max_delta`` ahead of physical time (the reference logs
        and drops those, ``handlers.rs:696-701``)."""
        now_phys = self._now_us()
        if ts.physical_us > now_phys + self.max_delta_us:
            raise ClockDriftError(
                f"remote ts {ts} is {(ts.physical_us - now_phys) / 1000:.1f} ms "
                f"ahead (max {self.max_delta_us / 1000:.0f} ms)"
            )
        with self._mu:
            self._last = max(self._last, ts.ntp)
