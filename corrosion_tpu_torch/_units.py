"""Priced units: calls that an open cost counter prices as one unit each.

``analysis/cost.py``'s counter prices every aten op a round runs. Two
kinds of call are priced from their shapes instead, and what runs inside
them is skipped: the PRNG draws (``random.py``), whose many int64 tensor
ops are one implementation of the threefry hash, and the kernel wrappers
(``ops/megakernel.py``), whose CUDA launch the dispatcher never sees. So a
round counts the same on CPU tensors (plain versions) as on CUDA tensors
(kernels), and a faster draw changes no count.

:func:`arm` marks which host-gated branch of a round ran, for the counter
to check. Outside a count both cost one thread-local lookup.
"""

from __future__ import annotations

import functools
import threading

_LOCAL = threading.local()


def _open():
    return getattr(_LOCAL, "counters", None)


def push(counter) -> None:
    """Open ``counter`` on this thread (innermost last)."""
    if _open() is None:
        _LOCAL.counters = []
    _LOCAL.counters.append(counter)


def pop(counter) -> None:
    stack = _open()
    if not stack or stack[-1] is not counter:
        raise RuntimeError("cost counters must close in the order they opened")
    stack.pop()


def unit(name: str):
    """Decorate a function whose calls an open counter prices as unit
    ``name`` (``counter.add_unit(name, args, kwargs, out)``), skipping the
    ops inside; calls made inside another unit belong to that unit."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            stack = _open()
            if not stack or stack[-1].in_unit:
                return fn(*args, **kwargs)
            counter = stack[-1]
            counter.in_unit = True
            try:
                out = fn(*args, **kwargs)
            finally:
                counter.in_unit = False
            counter.add_unit(name, args, kwargs, out)
            return out

        return call

    return wrap


def arm(name: str) -> None:
    """Record that the host-gated branch ``name`` ran (sync, sweep, dense)."""
    stack = _open()
    if stack:
        stack[-1].add_arm(name)
