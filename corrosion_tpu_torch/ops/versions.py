"""Per-origin version bookkeeping (port of ``corrosion_tpu/ops/versions.py``).

Per (node, origin slot): ``head`` (all versions ``1..head`` seen),
``known_max`` (highest version heard of), a head-relative seen-bit window
``seen`` of W 32-bit words, and the hash-slotted actor table
``org_id``/``org_last``. The JAX package keeps ``seen`` as uint32; the port
carries the same bit patterns in int32 (torch has no unsigned shifts on the
CPU), so every shift of a window word is done logically on the word widened
to int64 under ``& 0xFFFFFFFF``, and popcount is a bit trick. The
receive-side bookkeeping (``seen_versions``, ``record_versions``,
``bump_known_max``) is what the plain ingest route runs; the ingest kernel
has its own copy of the same steps.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from corrosion_tpu_torch.ops.dense import lookup_cols, scatter_cols_max, scatter_cols_or

_M32 = 0xFFFFFFFF


class Book(NamedTuple):
    head: torch.Tensor  # int32 [N, O]
    known_max: torch.Tensor  # int32 [N, O]
    seen: torch.Tensor  # int32 [N, O, W] — uint32 bit patterns
    org_id: torch.Tensor  # int32 [N, O] — actor tracked per slot (-1 free)
    org_last: torch.Tensor  # int32 [N, O] — round of last fresh activity

    @staticmethod
    def create(n_nodes: int, n_origins: int, buf_slots: int, device) -> "Book":
        words = max(1, -(-buf_slots // 32))

        def z(*s):
            return torch.zeros(s, dtype=torch.int32, device=device)

        return Book(
            head=z(n_nodes, n_origins),
            known_max=z(n_nodes, n_origins),
            seen=z(n_nodes, n_origins, words),
            org_id=torch.arange(n_origins, dtype=torch.int32,
                                device=device).expand(n_nodes, n_origins).clone(),
            org_last=z(n_nodes, n_origins),
        )


def as_u32(x):
    """int32 bit patterns -> their uint32 values, as int64."""
    return x.to(torch.int64) & _M32


def as_i32(u):
    """uint32 values held in int64 -> the same bits as int32."""
    return torch.where(u >= (1 << 31), u - (1 << 32), u).to(torch.int32)


def popcount(u):
    """Set bits of each uint32 value held in int64 (SWAR bit trick)."""
    u = u - ((u >> 1) & 0x55555555)
    u = (u & 0x33333333) + ((u >> 2) & 0x33333333)
    u = (u + (u >> 4)) & 0x0F0F0F0F
    return (((u * 0x01010101) & _M32) >> 24).to(torch.int32)


def org_slot(book: Book, origin):
    """``(slot, owned)``: each origin's hash class ``origin % O`` and whether
    that slot tracks exactly this actor."""
    o = book.head.shape[1]
    slot = torch.where(origin >= 0, origin % o, 0)
    owned = (origin >= 0) & (lookup_cols(book.org_id, slot) == origin)
    return slot, owned


def claim_slots_arrays(head, km, seen_flat, org_id, org_last, origin, fresh,
                       now, keep_rounds: int, seen_words: int):
    """Claim/evict origin slots for fresh foreign-actor messages: per slot,
    the largest fresh origin above the occupant takes it when the slot is
    free or idle for ``keep_rounds``; a claim resets head/known_max/window.
    Returns ``(head, km, seen_flat, org_id, org_last)``."""
    b, o = head.shape
    # per-slot maxima by scatter (O(N m) memory, where an [N, m, O] compare
    # would not fit the card at m = 512, O = 256 and N = 100,000)
    slot = torch.where(origin >= 0, origin % o, 0)
    cand = fresh & (origin >= 0)
    foreign = cand & (origin > lookup_cols(org_id, slot))
    new_owner = scatter_cols_max(torch.full_like(org_id, -1), slot, origin, foreign)
    evictable = (org_id < 0) | (org_last + keep_rounds < now)
    take = (new_owner >= 0) & evictable
    new_id = torch.where(take, new_owner, org_id)
    on_new = cand & (origin == lookup_cols(new_id, slot))
    active = scatter_cols_max(torch.zeros_like(org_id), slot, torch.ones_like(origin), on_new) > 0
    new_last = torch.where(take | active, now, org_last)
    reset_w = take[:, :, None].expand(b, o, seen_words).reshape(b, o * seen_words)
    return (
        torch.where(take, 0, head),
        torch.where(take, 0, km),
        torch.where(reset_w, 0, seen_flat),
        new_id,
        new_last,
    )


def claim_slots(book: Book, origin, fresh, now, keep_rounds: int) -> Book:
    """Book-level wrapper of :func:`claim_slots_arrays`."""
    n, o, w = book.seen.shape
    head, km, seen_flat, org_id, org_last = claim_slots_arrays(
        book.head, book.known_max, book.seen.reshape(n, o * w), book.org_id,
        book.org_last, origin, fresh, now, keep_rounds, w,
    )
    return Book(head, km, seen_flat.reshape(n, o, w), org_id, org_last)


def _window_offsets(book: Book, slot, ver):
    """Per-message window coordinates: ``(head at the slot, bit offset,
    flat word index into seen.reshape(N, O*W), in-window mask)``."""
    w = book.seen.shape[2]
    h = lookup_cols(book.head, slot)
    off = ver - h - 1
    in_win = (off >= 0) & (off < 32 * w)
    word_idx = slot * w + torch.where(off >= 0, off >> 5, 0)
    return h, off, word_idx, in_win


def seen_versions(book: Book, origin, ver, valid):
    """bool [N, M]: the origin's slot tracks it and the version is at or
    below the head or set in the window. Untracked origins are never seen.
    The window word's bit is read after an arithmetic shift of the int32
    pattern, which leaves the low bit as the logical shift would."""
    n, o, w = book.seen.shape
    slot, owned = org_slot(book, origin)
    h, off, word_idx, in_win = _window_offsets(book, slot, ver)
    word = lookup_cols(book.seen.reshape(n, o * w), word_idx, fill=0)
    hit = ((word >> (torch.clamp(off, min=0) & 31)) & 1) == 1
    return valid & owned & ((ver <= h) | (in_win & hit))


def record_versions(book: Book, origin, ver, valid, now=None, keep_rounds: int = 16):
    """Record a per-node batch of (origin, version) pairs [N, M]: returns
    ``(book, fresh, rec)``. ``fresh`` marks messages not seen before and not
    repeated earlier in the batch; fresh ones from untracked actors first
    claim their slot (skipped when ``now`` is None); ``rec`` (fresh and
    owned after the claim) set their window bit when in the window, every
    owned valid message raises ``known_max``, then heads advance."""
    n, o, w = book.seen.shape
    m = origin.shape[1]
    seen = seen_versions(book, origin, ver, valid)
    same = ((origin[:, :, None] == origin[:, None, :])
            & (ver[:, :, None] == ver[:, None, :]) & valid[:, None, :])
    earlier = torch.ones((m, m), dtype=torch.bool, device=origin.device).tril(-1)
    fresh = valid & ~seen & ~(same & earlier).any(dim=2)

    if now is not None:
        book = claim_slots(book, origin, fresh, now, keep_rounds)
    slot, owned = org_slot(book, origin)
    rec = fresh & owned
    _, off, word_idx, in_win = _window_offsets(book, slot, ver)
    bit = (torch.clamp(off, min=0) & 31).to(torch.int64)
    flat = scatter_cols_or(book.seen.reshape(n, o * w), word_idx,
                           as_i32(torch.ones_like(bit) << bit), rec & in_win)
    known_max = scatter_cols_max(book.known_max, slot, ver, valid & owned)
    book = book._replace(known_max=known_max, seen=flat.reshape(n, o, w))
    return advance_heads(book), fresh, rec


def bump_known_max(book: Book, origin, ver, valid) -> Book:
    """Raise ``known_max`` for heard-of (origin, version) pairs without
    recording them as seen (a fragment of a chunked version); only tracked
    actors book."""
    slot, owned = org_slot(book, origin)
    return book._replace(
        known_max=scatter_cols_max(book.known_max, slot, ver, valid & owned))


def _trailing_ones(seen):
    """Trailing-one count of each (n, o) W-word little-endian bitfield."""
    u = as_u32(seen)
    x1 = (u + 1) & _M32
    t_w = torch.where(u == _M32, 32, popcount(u ^ x1) - 1)
    total = t_w[:, :, 0]
    carry = t_w[:, :, 0] == 32
    for j in range(1, seen.shape[2]):
        total = total + torch.where(carry, t_w[:, :, j], 0)
        carry = carry & (t_w[:, :, j] == 32)
    return total.to(torch.int32)


def _shift_right(seen, t):
    """Logical right shift of each (n, o) W-word bitfield by ``t`` >= 0 bits
    (over-shifts clear the field)."""
    n, o, w = seen.shape
    t = torch.minimum(t, torch.tensor(32 * w, dtype=t.dtype, device=t.device))
    s_words = (t >> 5)[:, :, None]
    s_bits = (t & 31).to(torch.int64)[:, :, None]
    has_bits = s_bits > 0
    u = torch.cat([as_u32(seen), torch.zeros((n, o, w + 1), dtype=torch.int64,
                                            device=seen.device)], dim=2)
    out = torch.zeros((n, o, w), dtype=torch.int64, device=seen.device)
    for s in range(w + 1):
        lo = u[:, :, s:s + w]
        hi = u[:, :, s + 1:s + 1 + w]
        part = (lo >> s_bits) | torch.where(
            has_bits, (hi << (32 - s_bits)) & _M32, 0)
        out = torch.where(s_words == s, part, out)
    return as_i32(out)


def advance_heads(book: Book) -> Book:
    """Advance heads over contiguous seen runs: count the window's trailing
    ones, bump the head by that many, shift the window down."""
    t = _trailing_ones(book.seen)
    head = book.head + t
    return book._replace(
        head=head, known_max=torch.maximum(book.known_max, head),
        seen=_shift_right(book.seen, t),
    )


def raise_heads(book: Book, new_head) -> Book:
    """Jump heads to ``new_head`` and rebase the seen windows with them."""
    new_head = torch.maximum(book.head, new_head)
    return book._replace(
        head=new_head,
        known_max=torch.maximum(book.known_max, new_head),
        seen=_shift_right(book.seen, new_head - book.head),
    )


def needs_count(book: Book):
    """Versions heard of but not seen: ``known_max - head - popcount``."""
    buffered = popcount(as_u32(book.seen)).sum(dim=2, dtype=torch.int32)
    return torch.clamp(book.known_max - book.head, min=0) - buffered
