"""Last-write-wins keys and packed SWIM views (port of ``corrosion_tpu/ops/lww.py``).

The LWW rule is a lexicographic max over ``(clp, col_version, value,
site_id)`` int32 planes, the incumbent winning full ties; SWIM views pack
``incarnation * 4 + state`` into one int32 so that plain ``max`` is foca's
update precedence.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

INT32_MIN = -2147483648
INT32_MAX = 2147483647

# SWIM member states, ordered by same-incarnation precedence
STATE_ALIVE = 0
STATE_SUSPECT = 1
STATE_DOWN = 2


def lex_wins(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor]) -> torch.Tensor:
    """Elementwise: does key tuple ``a`` win (>=) against ``b``?"""
    if len(a) != len(b) or len(a) < 1:
        raise ValueError(
            f"key tuples must have equal nonzero length, got {len(a)}/{len(b)}"
        )
    wins = a[-1] >= b[-1]
    for ak, bk in zip(reversed(a[:-1]), reversed(b[:-1])):
        wins = (ak > bk) | ((ak == bk) & wins)
    return wins


def lex_max(a, b, *payloads) -> Tuple[torch.Tensor, ...]:
    """Elementwise lexicographic max over key tuples, carrying ``(pa, pb)``
    payload pairs; returns ``(*keys, *payloads)``."""
    wins = lex_wins(a, b)
    keys = tuple(torch.where(wins, ak, bk) for ak, bk in zip(a, b))
    extra = tuple(torch.where(wins, pa, pb) for pa, pb in payloads)
    return keys + extra


def pack_inc_state(incarnation, state):
    """``incarnation * 4 + state``: max is foca's update precedence."""
    return incarnation * 4 + state


def unpack_inc_state(packed):
    return packed >> 2, packed & 3
