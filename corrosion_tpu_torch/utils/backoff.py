"""Jittered exponential backoff iterator (port of
``corrosion_tpu/utils/backoff.py``).

Mirrors the reference's ``backoff`` crate (``crates/backoff/src/lib.rs:7-50``):
an iterator of sleep durations that doubles from ``min`` to ``max``, each
step jittered by up to half its size so a fleet of nodes does not
thunder-herd. The sync loop's policy is 1 s -> 15 s
(``agent/util.rs:352-398``).
"""

from __future__ import annotations

import random
import time
from typing import Callable, Iterator, Optional, Tuple, Type

#: growth of the delay per attempt, and the +-fraction each delay is
#: jittered by (the JAX package's defaults)
FACTOR, JITTER = 2.0, 0.5


class Backoff:
    """``iter(Backoff(...))`` yields jittered, exponentially growing delays,
    each clamped to ``[min_wait, max_wait]``; ``max_retries`` of them, or
    forever when it is None."""

    def __init__(self, min_wait: float = 1.0, max_wait: float = 15.0,
                 max_retries: Optional[int] = None):
        if not 0 < min_wait <= max_wait:
            raise ValueError(
                f"need 0 < min_wait <= max_wait, got min={min_wait} max={max_wait}")
        self.min_wait = min_wait
        self.max_wait = max_wait
        self.max_retries = max_retries

    def __iter__(self) -> Iterator[float]:
        base = self.min_wait
        n = 0
        while self.max_retries is None or n < self.max_retries:
            scale = 1.0 + JITTER * (2.0 * random.random() - 1.0)
            yield max(self.min_wait, min(self.max_wait, base * scale))
            base = min(self.max_wait, base * FACTOR)
            n += 1


def retry_call(
    fn: Callable,
    backoff: Backoff,
    retry_on: Tuple[Type[BaseException], ...],
    sleep: Callable[[float], object] = time.sleep,
    on_retry: Optional[Callable[[BaseException, float, int], None]] = None,
):
    """Call ``fn()`` until it succeeds, sleeping through ``backoff``'s
    delays between attempts. Exceptions of ``retry_on`` trigger a retry,
    anything else propagates at once; when the delays run out the last
    exception propagates, so callers keep their natural ``except`` types.
    ``on_retry(exc, delay, attempt)`` observes each retry (logging,
    supervisor state)."""
    delays = iter(backoff)
    attempt = 0
    while True:
        try:
            return fn()
        except retry_on as e:
            delay = next(delays, None)
            if delay is None:
                raise
            attempt += 1
            if on_retry is not None:
                on_retry(e, delay, attempt)
            sleep(delay)
