"""Vector clocks + epochs: the happens-before substrate (port of
``corrosion_tpu/analysis/sanitizer/vc.py``).

Classic DJIT+/FastTrack bookkeeping, sized for a test-process sanitizer
rather than a production TSan: clocks are plain dicts keyed by a
sanitizer-assigned thread id (NOT ``threading.get_ident()``, which the
OS reuses after a thread dies — a reused ident would alias a dead
thread's epochs onto a fresh thread and invent spurious orderings).

- a **clock** maps tid -> counter;
- an **epoch** ``(tid, c)`` is the cheap record of one event: the
  accessing thread's own counter at access time. ``epoch_before``
  answers "did that event happen-before this thread's present?" with
  one dict lookup, which is all the race detector needs.
"""

from __future__ import annotations

from typing import Dict, Tuple

Clock = Dict[int, int]
Epoch = Tuple[int, int]  # (tid, that thread's counter at the event)


def fresh(tid: int) -> Clock:
    return {tid: 1}


def join(into: Clock, other: Clock) -> None:
    """``into`` |= ``other`` (pointwise max), in place."""
    for tid, c in other.items():
        if into.get(tid, 0) < c:
            into[tid] = c


def epoch_before(epoch: Epoch, clock: Clock) -> bool:
    """True iff the event recorded by ``epoch`` happens-before a thread
    whose current clock is ``clock`` (the standard epoch <= VC check)."""
    tid, c = epoch
    return c <= clock.get(tid, 0)


def clock_before(a: Clock, b: Clock) -> bool:
    """Full-clock ordering: every component of ``a`` is covered by
    ``b``. Used by the filesystem witness, whose rare events keep whole
    snapshots instead of epochs."""
    return all(c <= b.get(tid, 0) for tid, c in a.items())


def concurrent(a: Clock, b: Clock) -> bool:
    return not clock_before(a, b) and not clock_before(b, a)
