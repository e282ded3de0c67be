// Row-local back half of the bounded-table SWIM round, for Hopper (sm_90a).
//
// Replaces: corrosion_tpu/ops/megakernel.py::swim_tables_fused (_swim_kernel,
// the pallas_call at megakernel.py:1111), whose body is
// corrosion_tpu/sim/scale.py::swim_tables_update, in both channel forms:
//   PACKED = false  aligned rows (pig_members == 0): each channel is the
//                   sender's gathered [M] id/view/sendable row;
//   PACKED = true   bounded member piggyback (pig_members = k > 0): each
//                   channel is a packed [k] list of (id, view) entries.
// Plain PyTorch version beside the wrapper:
// corrosion_tpu_torch/sim/scale.py::swim_tables_update.
//
// Bound on this card: bytes. Per node row it reads four int32 [M] planes
// (front id/view, old id/view), the timer and budget planes, four channels
// (aligned: id and view int32 [M] plus sendable bool [M]; packed: id and
// view int32 [k]) and ~37 per-row scalars, and writes id/view, timer/budget,
// inc and refute; a few hundred integer operations per row is far below the
// card's integer rate, so the kernel can go no faster than those bytes over
// 3.35 TB/s.
//
// Design: one warp per node row, kRowsPerBlock rows (warps) a block. Up to
// kRegSlots = 128 columns (the register form), lane l
// holds the columns l + 32 i, i < SPL (SPL = 1, 2 or 4 for m <= 32, 64,
// 128; columns at or above m are masked), so each access of a warp is one
// contiguous span of a plane row at every dtype (128 bytes of an int32
// plane, 32 of an int8 one), with no alignment test. (An earlier form held
// consecutive columns a lane, read as one vector where aligned; the test on
// every access made it longer in instructions, and it measured slower:
// PERF.md, Findings.) The row's id, view, old id/view, timer and budget stay in registers, in
// arrays indexed only by unrolled loop counters (nothing goes to the
// stack). The channels' per-row valid flag, sender and sender incarnation
// are read by lanes 0..3, one channel a lane, and handed out by shuffle. A
// channel is read only on the rows where it is valid; an aligned channel's
// id and send flags are read together, its view only where the id is live
// and sendable. x mod m is a mask when m is a power of two (the configured
// 64), else the `%` of C with the sign fixed. The phases, in the JAX body's
// order:
//   - column-local, in registers, no traffic between lanes: the aligned
//     form's four channel merges, the budget decrement, the suspicion/down
//     timers and purge, the refill and the stores;
//   - row-addressed steps on the lane that holds the column: the suspect
//     mark at probe_slot (0 <= ps < m only) and the four sender assertions
//     at ((snd % m) + m) % m in channel order, each local to that lane; the
//     refutation reads id/view at self_slot from its lane with one
//     __shfl_sync a column that every lane executes (self_slot is the same
//     for the whole warp), and that lane writes the self refresh. Each step
//     writes every column of a lane through a select, never under a branch
//     on the column: the compiler turns a branch on `column == slot` into
//     an indexed access, which moves the row's arrays to the stack;
//   - the packed form's merges (below), on the row's id/view staged in
//     per-warp shared memory (2 x kRegSlots int32) for this phase only.
//
// The wide form (m > kRegSlots, any m): the row cannot stay in registers
// (at 8 columns a lane the six row planes and the aligned channels would
// take over 100 registers a lane, and no register form covers every m), so
// the warp walks the row in chunks of 32 columns, one column a lane, each
// chunk through every phase from its loads to its stores, in registers.
// Every phase is local to a column but two:
//   - the refutation reads (id, view) at self_slot after the purge, and
//     decides inc, the self refresh and so the refill of that one column.
//     Every other column's result depends on its own column alone, so the
//     chunk that holds self_slot goes first (chunk 0 when self_slot is out
//     of the row): its refutation, one __shfl_sync from the lane of
//     self_slot, is done before any later chunk needs inc;
//   - the packed merges apply entries at hash classes anywhere in the row.
//     The row (after the suspect mark) is staged in the warp's own rows of
//     the outputs o_id / o_view, which hold any m: shared memory sized from
//     m would hold 2 x m int32 a warp only up to m ~ 7,000 at the card's
//     227 KB a block and need a second path past that. The ranked merge
//     below runs on the staged row as it does on shared memory (__syncwarp
//     orders a warp's global writes as its shared ones), and the chunk
//     pass reads each column back from there before it overwrites it.
// The row-addressed steps (the suspect mark at probe_slot, the sender
// assertions at snd % m, the self refresh) are selects on the column
// index in whichever chunk holds it, as in the register form.
//
// The packed merge: the JAX body applies the entries one after another at
// their hash class c = id % m, channels 0..3 and entries 0..k-1 in order;
// an entry reads (id[c], view[c]) and may write both. Here the entries of
// the valid channels, in that order, go through the warp 32 at a time
// (position p -> lane p % 32 of pass p / 32). Within a pass each live
// entry's rank is the number of live entries of its class on lower lanes
// (__match_any_sync on the class, masked to live lower lanes), and rounds
// t = 0, 1, ... apply the entries of rank t, with __syncwarp between rounds.
// Equivalence: entries of different classes touch different slots, so they
// commute. The entries of one class apply in rank order, which is their
// order in the sequence, and none of another class writes their slot, so
// each sees exactly the (id, view) that the sequential loop would show it.
// Passes run in sequence order. Within a round the applying entries have
// distinct classes, so no two lanes write one slot.
//
// Tie and overflow rules are kept: views compare as signed int32, the state
// is the low two bits (also of negative views in `take`, -1 & 3 == 3) while
// is_suspect / is_down require view >= 0, pack_inc_state wraps as uint32,
// `>>` is arithmetic as in JAX. The aligned form's sendable flags of the
// budget are taken as read, before the merges; the packed form has no
// decrement and no clamp (its caller did the decrement for the entries it
// sent). The timer plane (TT) and the budget plane (XT) are read and written
// at their stored dtypes, widened to int32 in registers and cast at the
// store: (int16, int8) under narrow_int8, (int16, int16) under
// narrow_dtypes, else (int32, int32).
//
// Instantiations: 3 type pairs x {aligned, packed} x SPL {1, 2, 4} = 18
// register forms, and 3 type pairs x {aligned, packed} = 6 wide forms;
// chip_smoke.py prints ptxas' report (-Xptxas -v) for each and requires 0
// bytes of stack frame and spill in all of them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// the register form's widest row; past it the wide form
constexpr int kRegSlots = 128;
// warps (node rows) a block: 2 and 4 measured within 5 % of each other, 4
// the faster on five of the six forms, 8 slower (PERF.md, Findings)
constexpr int kRowsPerBlock = 4;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kAlive = 0;
constexpr int kSuspect = 1;
constexpr int kDown = 2;
constexpr int kFree = -1;

// incarnation * 4 + state with JAX's wrapping int32 arithmetic
__device__ __forceinline__ int32_t pack_inc_state(int32_t inc, int32_t state) {
  return static_cast<int32_t>(static_cast<uint32_t>(inc) * 4u +
                              static_cast<uint32_t>(state));
}

// a lane's columns lane + 32 i (i < SPL) of a plane row, widened to int32;
// `fill` at or above m
template <int SPL, typename T>
__device__ __forceinline__ void load_cols(const T* row, int lane, int m, int32_t (&out)[SPL],
                                          int32_t fill) {
#pragma unroll
  for (int i = 0; i < SPL; ++i) {
    const int c = lane + 32 * i;
    out[i] = c < m ? static_cast<int32_t>(row[c]) : fill;
  }
}

// the columns of a lane back to a plane row, cast to T
template <int SPL, typename T>
__device__ __forceinline__ void store_cols(T* row, int lane, int m, const int32_t (&v)[SPL]) {
#pragma unroll
  for (int i = 0; i < SPL; ++i) {
    const int c = lane + 32 * i;
    if (c < m) row[c] = static_cast<T>(v[i]);
  }
}

// x mod m in [0, m), as Python's %: a mask when m is a power of two
// (`mask` = m - 1, else -1), which two's complement makes exact for x < 0
__device__ __forceinline__ int floor_mod(int32_t x, int m, int mask) {
  if (mask >= 0) return x & mask;
  const int s = x % m;
  return s < 0 ? s + m : s;
}

// the merge of one incoming (id, view) into a table entry
__device__ __forceinline__ void merge_entry(int32_t& id, int32_t& view, int32_t in_id,
                                            int32_t in_view) {
  if (id == in_id) {
    view = max(view, in_view);
  } else if (id < 0 || ((view & 3) == kDown && (in_view & 3) == kAlive)) {
    view = in_view;  // insert into a free slot, or take a DOWN incumbent's
    id = in_id;
  }
}

// one pass of up to 32 packed entries (lane order is apply order) into the
// row staged in shared memory: the entries of rank t apply in round t
__device__ __forceinline__ void merge_pass(int32_t* sid, int32_t* sview, int32_t in_id,
                                           int32_t in_view, int m, int mask, unsigned below) {
  const bool live = in_id >= 0;
  const int cls = live ? floor_mod(in_id, m, mask) : -1;
  const unsigned live_b = __ballot_sync(kFull, live);
  const unsigned peers = __match_any_sync(kFull, cls) & live_b & below;
  const int rank = live ? __popc(peers) : -1;
  const int top = __reduce_max_sync(kFull, rank);
  for (int t = 0; t <= top; ++t) {
    if (rank == t) merge_entry(sid[cls], sview[cls], in_id, in_view);
    __syncwarp();
  }
}

}  // namespace

struct SwimArgs {
  const int32_t* mem_id;
  const int32_t* mem_view;
  const int32_t* old_id;
  const int32_t* old_view;
  const void* timer;
  const void* tx;
  const uint8_t* alive;
  const int32_t* inc;
  const int32_t* node_id;
  const int32_t* self_slot;
  const int32_t* sus_heard;
  const int32_t* sends;
  const int32_t* probe_slot;
  const int32_t* suspect_key;
  const uint8_t* probe_failed;
  const int32_t* ch_id[4];
  const int32_t* ch_view[4];
  const uint8_t* ch_send[4];
  const uint8_t* ch_valid[4];
  const int32_t* ch_snd[4];
  const int32_t* ch_snd_inc[4];
  int32_t* o_id;
  int32_t* o_view;
  void* o_timer;
  void* o_tx;
  int32_t* o_inc;
  uint8_t* o_refute;
  int32_t n;
  int32_t m;
  int32_t suspicion_rounds;
  int32_t down_purge_rounds;
  int32_t max_transmissions;
  int32_t pig_k;  // packed entries per channel (PACKED only)
};

namespace {

// the packed entry at position `pos` < 4k of the valid channels' entries,
// in apply order (channel by channel, entry by entry): where its id and its
// view lie
struct EntryAt {
  const int32_t* id;
  const int32_t* view;
};

__device__ __forceinline__ EntryAt entry_at(const SwimArgs& a, const bool (&valid)[4],
                                            int64_t r, int k, int pos) {
  const int vi = (pos >= k) + (pos >= 2 * k) + (pos >= 3 * k);  // the vi-th valid channel
  const int64_t e = r * k + (pos - vi * k);
  EntryAt out{a.ch_id[0], a.ch_view[0]};
  int seen = 0;
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) {
    if (valid[ch]) {
      if (seen == vi) out = EntryAt{a.ch_id[ch], a.ch_view[ch]};
      ++seen;
    }
  }
  return EntryAt{out.id + e, out.view + e};
}

}  // namespace

template <typename TT, typename XT, bool PACKED, int SPL>
__global__ void __launch_bounds__(32 * kRowsPerBlock) swim_tables_kernel(const SwimArgs a) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + warp;
  if (r >= a.n) return;  // the whole warp: rows past n are masked
  const int m = a.m;
  const int mask = (m & (m - 1)) == 0 ? m - 1 : -1;
  const int64_t base = r * m;

  // --- loads: the row's planes, the per-row scalars, the channels ----------
  int32_t id[SPL], view[SPL], old_id[SPL], old_view[SPL], timer[SPL], tx[SPL];
  load_cols(a.mem_id + base, lane, m, id, kFree);
  load_cols(a.mem_view + base, lane, m, view, kFree);
  load_cols(a.old_id + base, lane, m, old_id, kFree);
  load_cols(a.old_view + base, lane, m, old_view, kFree);
  load_cols(static_cast<const TT*>(a.timer) + base, lane, m, timer, 0);
  load_cols(static_cast<const XT*>(a.tx) + base, lane, m, tx, 0);
  const bool alive = a.alive[r] != 0;
  const bool failed = a.probe_failed[r] != 0;
  const int32_t ps = failed ? a.probe_slot[r] : -1;
  const int32_t sus_key = failed ? a.suspect_key[r] : 0;
  const int32_t sends = a.sends[r];
  const int32_t node = a.node_id[r];
  const int32_t ss = a.self_slot[r];
  const int32_t sus_heard = a.sus_heard[r];
  int32_t inc = a.inc[r];
  // the channels' per-row scalars, channel ch on lane ch
  const uint8_t* p_valid = a.ch_valid[0];
  const int32_t* p_snd = a.ch_snd[0];
  const int32_t* p_snd_inc = a.ch_snd_inc[0];
#pragma unroll
  for (int ch = 1; ch < 4; ++ch) {
    p_valid = lane == ch ? a.ch_valid[ch] : p_valid;
    p_snd = lane == ch ? a.ch_snd[ch] : p_snd;
    p_snd_inc = lane == ch ? a.ch_snd_inc[ch] : p_snd_inc;
  }
  const bool my_valid = lane < 4 && p_valid[r] != 0;
  const int32_t my_snd = my_valid ? p_snd[r] : 0;
  const int32_t my_snd_inc = my_valid ? p_snd_inc[r] : 0;
  const unsigned vmask = __ballot_sync(kFull, my_valid);
  bool valid[4];
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) valid[ch] = (vmask >> ch) & 1u;
  // aligned channels: ids and send flags now, views where live and sendable
  int32_t cid[4][SPL], cview[4][SPL];
  if constexpr (!PACKED) {
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
      int32_t send[SPL];
      load_cols(a.ch_id[ch] + base, lane, valid[ch] ? m : 0, cid[ch], kFree);
      load_cols(a.ch_send[ch] + base, lane, valid[ch] ? m : 0, send, 0);
#pragma unroll
      for (int i = 0; i < SPL; ++i) cid[ch][i] = send[i] != 0 ? cid[ch][i] : kFree;
    }
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
#pragma unroll
      for (int i = 0; i < SPL; ++i) {
        cview[ch][i] = cid[ch][i] >= 0 ? a.ch_view[ch][base + lane + 32 * i] : 0;
      }
    }
  }

  // --- failed probe: suspect mark, scatter-max at probe_slot ---------------
  // (a select on every column, see the header; a column at or above m is
  // never stored)
#pragma unroll
  for (int i = 0; i < SPL; ++i) {
    view[i] = lane + 32 * i == ps ? max(view[i], sus_key) : view[i];
  }

  // --- four packet merges ---------------------------------------------------
  if constexpr (PACKED) {
    __shared__ int32_t s_id[kRowsPerBlock][kRegSlots];
    __shared__ int32_t s_view[kRowsPerBlock][kRegSlots];
    int32_t* sid = s_id[warp];
    int32_t* sview = s_view[warp];
#pragma unroll
    for (int i = 0; i < SPL; ++i) {
      const int c = lane + 32 * i;
      if (c < m) {
        sid[c] = id[i];
        sview[c] = view[i];
      }
    }
    __syncwarp();
    const int k = a.pig_k;
    int n_valid = 0;
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) n_valid += valid[ch] ? 1 : 0;
    const int total = n_valid * k;  // positions of the valid channels' entries
    const unsigned below = (1u << lane) - 1u;
    // the first passes' entries are read together, before any merge: their
    // ids, then the views of the live ones. Two passes (64 entries: the 1M
    // point's four packets of 16) where a lane holds at most two columns;
    // one where it holds four, which leaves ptxas too few registers for two
    constexpr int kEarlyPasses = SPL < 4 ? 2 : 1;
    int32_t e_id[kEarlyPasses], e_view[kEarlyPasses];
#pragma unroll
    for (int q = 0; q < kEarlyPasses; ++q) {
      const int pos = 32 * q + lane;
      e_id[q] = pos < total ? *entry_at(a, valid, r, k, pos).id : kFree;
    }
#pragma unroll
    for (int q = 0; q < kEarlyPasses; ++q) {
      e_view[q] = e_id[q] >= 0 ? *entry_at(a, valid, r, k, 32 * q + lane).view : 0;
    }
#pragma unroll
    for (int q = 0; q < kEarlyPasses; ++q) {
      if (32 * q < total) merge_pass(sid, sview, e_id[q], e_view[q], m, mask, below);
    }
    for (int p0 = 32 * kEarlyPasses; p0 < total; p0 += 32) {  // the passes after those
      const int pos = p0 + lane;
      const int32_t in_id = pos < total ? *entry_at(a, valid, r, k, pos).id : kFree;
      const int32_t in_view = in_id >= 0 ? *entry_at(a, valid, r, k, pos).view : 0;
      merge_pass(sid, sview, in_id, in_view, m, mask, below);
    }
#pragma unroll
    for (int i = 0; i < SPL; ++i) {
      const int c = lane + 32 * i;
      if (c < m) {
        id[i] = sid[c];
        view[i] = sview[c];
      }
    }
  } else {
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
#pragma unroll
      for (int i = 0; i < SPL; ++i) {
        if (cid[ch][i] >= 0) merge_entry(id[i], view[i], cid[ch][i], cview[ch][i]);
      }
    }
  }

  // --- sender-alive assertions at snd % m, on the lane holding the slot ----
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) {
    const int32_t snd = __shfl_sync(kFull, my_snd, ch);
    const int32_t s_key = pack_inc_state(__shfl_sync(kFull, my_snd_inc, ch), kAlive);
    const int slot = valid[ch] ? floor_mod(snd, m, mask) : -1;
#pragma unroll
    for (int i = 0; i < SPL; ++i) {
      const bool at = lane + 32 * i == slot;
      const bool free1 = id[i] < 0;
      view[i] = at && (free1 || id[i] == snd) ? max(view[i], s_key) : view[i];
      id[i] = at && free1 ? snd : id[i];
    }
  }

  // --- budget decrement, suspicion / down timers, purge --------------------
#pragma unroll
  for (int i = 0; i < SPL; ++i) {
    int32_t t = tx[i];
    if (!PACKED && t > 0) t -= sends;  // sendable: the budget as read
    tx[i] = PACKED ? t : max(t, 0);

    const bool occupied = id[i] >= 0;
    const bool changed = view[i] != old_view[i] || id[i] != old_id[i];
    const bool is_suspect = occupied && view[i] >= 0 && (view[i] & 3) == kSuspect;
    const bool newly = changed && is_suspect;
    int32_t tm = newly ? a.suspicion_rounds : timer[i];
    if (is_suspect && !newly && alive) tm -= 1;
    const bool expired = is_suspect && tm <= 0 && alive;
    if (expired) view[i] = pack_inc_state(view[i] >> 2, kDown);
    const bool is_down = occupied && view[i] >= 0 && (view[i] & 3) == kDown;
    const bool newly_down = expired || (changed && is_down);
    if (is_down && newly_down) tm = a.down_purge_rounds;
    if (is_down && !newly_down && alive) tm -= 1;
    if (is_down && tm <= 0 && alive) {
      id[i] = kFree;
      view[i] = kFree;
    }
    timer[i] = tm;
  }

  // --- refutation and self refresh -----------------------------------------
  const bool ss_in = ss >= 0 && ss < m;
  int32_t id_at_self = 0, view_at_self = -1;
  if (ss_in) {  // the same for the whole warp: every lane shuffles
#pragma unroll
    for (int i = 0; i < SPL; ++i) {
      const int32_t x_id = __shfl_sync(kFull, id[i], ss & 31);
      const int32_t x_view = __shfl_sync(kFull, view[i], ss & 31);
      if (i == ss >> 5) {
        id_at_self = x_id;
        view_at_self = x_view;
      }
    }
  }
  const int32_t self_gossip = id_at_self == node ? view_at_self : -1;
  const int32_t heard = max(sus_heard, self_gossip);
  const bool refute = alive && heard >= pack_inc_state(inc, kSuspect);
  if (refute) inc = (heard >> 2) + 1;
  const int32_t self_key = pack_inc_state(inc, kAlive);
#pragma unroll
  for (int i = 0; i < SPL; ++i) {
    const bool own = alive && lane + 32 * i == ss;
    view[i] = own ? self_key : view[i];
    id[i] = own ? node : id[i];
  }

  // --- fresh news refills the dissemination budget; stores -----------------
#pragma unroll
  for (int i = 0; i < SPL; ++i) {
    const bool changed = view[i] != old_view[i] || id[i] != old_id[i];
    if (changed) tx[i] = a.max_transmissions;
  }
  store_cols(a.o_id + base, lane, m, id);
  store_cols(a.o_view + base, lane, m, view);
  store_cols(static_cast<TT*>(a.o_timer) + base, lane, m, timer);
  store_cols(static_cast<XT*>(a.o_tx) + base, lane, m, tx);
  if (lane == 0) {
    a.o_inc[r] = inc;
    a.o_refute[r] = refute ? 1 : 0;
  }
}

// The wide form, m > kRegSlots (any m): the row in chunks of 32 columns, one
// column a lane, the chunk holding self_slot first; the packed form's row
// staged in the warp's output rows for its merges (see the header).
template <typename TT, typename XT, bool PACKED>
__global__ void __launch_bounds__(32 * kRowsPerBlock) swim_tables_wide_kernel(const SwimArgs a) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + warp;
  if (r >= a.n) return;  // the whole warp: rows past n are masked
  const int m = a.m;
  const int mask = (m & (m - 1)) == 0 ? m - 1 : -1;
  const int64_t base = r * m;

  // --- the per-row scalars; the channels' on lanes 0..3 --------------------
  const bool alive = a.alive[r] != 0;
  const bool failed = a.probe_failed[r] != 0;
  const int32_t ps = failed ? a.probe_slot[r] : -1;
  const int32_t sus_key = failed ? a.suspect_key[r] : 0;
  const int32_t sends = a.sends[r];
  const int32_t node = a.node_id[r];
  const int32_t ss = a.self_slot[r];
  const int32_t sus_heard = a.sus_heard[r];
  int32_t inc = a.inc[r];
  const uint8_t* p_valid = a.ch_valid[0];
  const int32_t* p_snd = a.ch_snd[0];
  const int32_t* p_snd_inc = a.ch_snd_inc[0];
#pragma unroll
  for (int ch = 1; ch < 4; ++ch) {
    p_valid = lane == ch ? a.ch_valid[ch] : p_valid;
    p_snd = lane == ch ? a.ch_snd[ch] : p_snd;
    p_snd_inc = lane == ch ? a.ch_snd_inc[ch] : p_snd_inc;
  }
  const bool my_valid = lane < 4 && p_valid[r] != 0;
  const int32_t my_snd = my_valid ? p_snd[r] : 0;
  const int32_t my_snd_inc = my_valid ? p_snd_inc[r] : 0;
  const unsigned vmask = __ballot_sync(kFull, my_valid);
  bool valid[4];
  // the sender assertions' ids, keys and slots (-1: channel not valid)
  int32_t snd[4], s_key[4];
  int slot[4];
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) {
    valid[ch] = (vmask >> ch) & 1u;
    snd[ch] = __shfl_sync(kFull, my_snd, ch);
    s_key[ch] = pack_inc_state(__shfl_sync(kFull, my_snd_inc, ch), kAlive);
    slot[ch] = valid[ch] ? floor_mod(snd[ch], m, mask) : -1;
  }

  // --- packed: the suspect-marked row staged in the outputs, the merges ----
  int32_t* const sid = a.o_id + base;
  int32_t* const sview = a.o_view + base;
  if constexpr (PACKED) {
    for (int c = lane; c < m; c += 32) {
      const int32_t v = a.mem_view[base + c];
      sid[c] = a.mem_id[base + c];
      sview[c] = c == ps ? max(v, sus_key) : v;
    }
    __syncwarp();
    const int k = a.pig_k;
    const int total = __popc(vmask) * k;  // positions of the valid channels' entries
    const unsigned below = (1u << lane) - 1u;
    for (int p0 = 0; p0 < total; p0 += 32) {
      const int pos = p0 + lane;
      const int32_t in_id = pos < total ? *entry_at(a, valid, r, k, pos).id : kFree;
      const int32_t in_view = in_id >= 0 ? *entry_at(a, valid, r, k, pos).view : 0;
      merge_pass(sid, sview, in_id, in_view, m, mask, below);
    }
  }

  // --- the chunks, the one holding self_slot first -------------------------
  const int chunks = (m + 31) >> 5;
  const bool ss_in = ss >= 0 && ss < m;
  bool refute = false;
  int32_t self_key = 0;
  for (int j = 0, ci = ss_in ? ss >> 5 : 0; j < chunks; ++j, ci = ci + 1 < chunks ? ci + 1 : 0) {
    const int c = 32 * ci + lane;
    const bool in = c < m;
    const int64_t at = base + c;
    int32_t id, view;
    if constexpr (PACKED) {
      id = in ? sid[c] : kFree;
      view = in ? sview[c] : kFree;
    } else {
      id = in ? a.mem_id[at] : kFree;
      view = in ? a.mem_view[at] : kFree;
      view = c == ps ? max(view, sus_key) : view;  // the failed probe's suspect mark
      // the aligned channels: ids and send flags, then views where live
      // and sendable, then the merges in channel order
      int32_t cid[4], cview[4];
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {
        const bool rd = in && valid[ch];
        const int32_t got = rd ? a.ch_id[ch][at] : kFree;
        const bool send = rd && a.ch_send[ch][at] != 0;
        cid[ch] = send ? got : kFree;
      }
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) cview[ch] = cid[ch] >= 0 ? a.ch_view[ch][at] : 0;
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {
        if (cid[ch] >= 0) merge_entry(id, view, cid[ch], cview[ch]);
      }
    }
    const int32_t old_id = in ? a.old_id[at] : kFree;
    const int32_t old_view = in ? a.old_view[at] : kFree;
    int32_t timer = in ? static_cast<int32_t>(static_cast<const TT*>(a.timer)[at]) : 0;
    int32_t tx = in ? static_cast<int32_t>(static_cast<const XT*>(a.tx)[at]) : 0;

    // sender-alive assertions at snd % m, in channel order
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
      const bool here = c == slot[ch];
      const bool free1 = id < 0;
      view = here && (free1 || id == snd[ch]) ? max(view, s_key[ch]) : view;
      id = here && free1 ? snd[ch] : id;
    }

    // budget decrement, suspicion / down timers, purge
    if (!PACKED && tx > 0) tx -= sends;  // sendable: the budget as read
    tx = PACKED ? tx : max(tx, 0);
    {
      const bool occupied = id >= 0;
      const bool changed = view != old_view || id != old_id;
      const bool is_suspect = occupied && view >= 0 && (view & 3) == kSuspect;
      const bool newly = changed && is_suspect;
      int32_t tm = newly ? a.suspicion_rounds : timer;
      if (is_suspect && !newly && alive) tm -= 1;
      const bool expired = is_suspect && tm <= 0 && alive;
      if (expired) view = pack_inc_state(view >> 2, kDown);
      const bool is_down = occupied && view >= 0 && (view & 3) == kDown;
      const bool newly_down = expired || (changed && is_down);
      if (is_down && newly_down) tm = a.down_purge_rounds;
      if (is_down && !newly_down && alive) tm -= 1;
      if (is_down && tm <= 0 && alive) {
        id = kFree;
        view = kFree;
      }
      timer = tm;
    }

    // the first chunk holds self_slot: the refutation, before any chunk
    // after it needs inc (the same for the whole warp: every lane shuffles)
    if (j == 0) {
      const int32_t x_id = __shfl_sync(kFull, id, ss & 31);
      const int32_t x_view = __shfl_sync(kFull, view, ss & 31);
      const int32_t self_gossip = ss_in && x_id == node ? x_view : -1;
      const int32_t heard = max(sus_heard, self_gossip);
      refute = alive && heard >= pack_inc_state(inc, kSuspect);
      if (refute) inc = (heard >> 2) + 1;
      self_key = pack_inc_state(inc, kAlive);
    }
    const bool own = alive && c == ss;
    view = own ? self_key : view;
    id = own ? node : id;

    // fresh news refills the dissemination budget; stores
    if (view != old_view || id != old_id) tx = a.max_transmissions;
    if (in) {
      a.o_id[at] = id;
      a.o_view[at] = view;
      static_cast<TT*>(a.o_timer)[at] = static_cast<TT>(timer);
      static_cast<XT*>(a.o_tx)[at] = static_cast<XT>(tx);
    }
  }
  if (lane == 0) {
    a.o_inc[r] = inc;
    a.o_refute[r] = refute ? 1 : 0;
  }
}

// the register form's widest row: past it the wide form
extern "C" int swim_tables_register_slots() { return kRegSlots; }

// the columns a lane (SPL) are a template parameter, so that a narrow row
// carries no unused registers; past kRegSlots the wide form
template <typename TT, typename XT, bool PACKED>
static void launch_cols(const SwimArgs* a, dim3 grid, int threads, cudaStream_t s) {
  if (a->m <= 32) {
    swim_tables_kernel<TT, XT, PACKED, 1><<<grid, threads, 0, s>>>(*a);
  } else if (a->m <= 64) {
    swim_tables_kernel<TT, XT, PACKED, 2><<<grid, threads, 0, s>>>(*a);
  } else if (a->m <= kRegSlots) {
    swim_tables_kernel<TT, XT, PACKED, 4><<<grid, threads, 0, s>>>(*a);
  } else {
    swim_tables_wide_kernel<TT, XT, PACKED><<<grid, threads, 0, s>>>(*a);
  }
}

template <typename TT, typename XT>
static void launch_form(const SwimArgs* a, int packed, dim3 grid, int threads,
                        cudaStream_t s) {
  if (packed) {
    launch_cols<TT, XT, true>(a, grid, threads, s);
  } else {
    launch_cols<TT, XT, false>(a, grid, threads, s);
  }
}

// timer_bytes / tx_bytes: the element sizes of the timer and budget planes;
// the valid pairs are (2, 1), (2, 2) and (4, 4). Returns a CUDA error code,
// or cudaErrorInvalidValue for any other pair, for m < 1 or for a packed
// form without entries.
extern "C" int swim_tables_launch(const SwimArgs* a, int timer_bytes,
                                  int tx_bytes, int packed, void* stream) {
  if (a->m < 1 || (packed && a->pig_k < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a->n == 0) return 0;
  const int threads = 32 * kRowsPerBlock;
  const dim3 grid((a->n + kRowsPerBlock - 1) / kRowsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (timer_bytes == 2 && tx_bytes == 1) {
    launch_form<int16_t, int8_t>(a, packed, grid, threads, s);
  } else if (timer_bytes == 2 && tx_bytes == 2) {
    launch_form<int16_t, int16_t>(a, packed, grid, threads, s);
  } else if (timer_bytes == 4 && tx_bytes == 4) {
    launch_form<int32_t, int32_t>(a, packed, grid, threads, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* swim_tables_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
