"""Cheap call-stack introspection shared by the corrosan components
(port of ``corrosion_tpu/analysis/sanitizer/frames.py``).

``sys._getframe`` walking instead of ``traceback``/``inspect``: the
race detector runs on hot attribute paths and must not allocate a
traceback per access. Frames inside the sanitizer itself, threading,
and queue are "plumbing" — user-facing sites skip them.
"""

from __future__ import annotations

import os
import queue
import sys
import threading
from typing import Iterator, Tuple

_SELF_DIR = os.path.dirname(os.path.abspath(__file__))
_PLUMBING_FILES = {
    os.path.abspath(getattr(threading, "__file__", "") or ""),
    os.path.abspath(getattr(queue, "__file__", "") or ""),
}

_REALPATHS: dict = {}


def realpath_cached(path: str) -> str:
    got = _REALPATHS.get(path)
    if got is None:
        got = os.path.realpath(path)
        _REALPATHS[path] = got
    return got


def _is_plumbing(filename: str) -> bool:
    ab = os.path.abspath(filename)
    return ab.startswith(_SELF_DIR) or ab in _PLUMBING_FILES


def iter_call_frames(skip: int = 2, limit: int = 20
                     ) -> Iterator[Tuple[str, int]]:
    """(filename, lineno) pairs walking outward from the caller's
    caller, plumbing frames included (the lock-naming walk matches them
    against the static creation-site map, which simply never contains
    stdlib paths)."""
    try:
        f = sys._getframe(skip)
    except ValueError:  # shallower stack than skip
        return
    n = 0
    while f is not None and n < limit:
        yield f.f_code.co_filename, f.f_lineno
        f = f.f_back
        n += 1


def call_site(skip: int = 2) -> str:
    """``path:line`` of the nearest non-plumbing frame ('' when the
    whole visible stack is plumbing)."""
    for filename, lineno in iter_call_frames(skip=skip):
        if not _is_plumbing(filename):
            return f"{filename}:{lineno}"
    return ""
