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
// Design: one thread per node row. The row's id/view entries live in a
// per-thread array (local memory, L1-cached) while the merges, sender
// assertions, timers, purge and refutation run in the same order as the JAX
// body; every other plane is read once and every output written once. Tie
// and overflow rules are kept: views compare as signed int32, the state is
// the low two bits, `>>` is arithmetic as in JAX. The timer plane (TT) and
// the budget plane (XT) are read and written at their stored dtypes, widened
// to int32 in registers and cast at the store: (int16, int8) under
// narrow_int8, (int16, int16) under narrow_dtypes, else (int32, int32). The
// packed form applies a channel's k entries one after another at their hash
// class id % m, so an entry sees the writes of the entries before it (two
// entries of one packet may share a class), and it skips the full-row budget
// decrement, which its caller did for the entries it sent. One warp per row
// with coalesced access would be faster; this version is the simple correct
// one.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSlots = 128;
constexpr int kAlive = 0;
constexpr int kSuspect = 1;
constexpr int kDown = 2;
constexpr int kFree = -1;

// incarnation * 4 + state with JAX's wrapping int32 arithmetic
__device__ __forceinline__ int32_t pack_inc_state(int32_t inc, int32_t state) {
  return static_cast<int32_t>(static_cast<uint32_t>(inc) * 4u +
                              static_cast<uint32_t>(state));
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

template <typename TT, typename XT, bool PACKED>
__global__ void swim_tables_kernel(SwimArgs a) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= a.n) return;
  const int m = a.m;
  const int64_t base = r * m;
  const TT* timer_in = static_cast<const TT*>(a.timer) + base;
  const XT* tx_in = static_cast<const XT*>(a.tx) + base;

  int32_t id[kMaxSlots];
  int32_t view[kMaxSlots];
  for (int c = 0; c < m; ++c) {
    id[c] = a.mem_id[base + c];
    view[c] = a.mem_view[base + c];
  }

  // failed probe: suspect mark, scatter-max at probe_slot
  if (a.probe_failed[r]) {
    const int32_t ps = a.probe_slot[r];
    if (ps >= 0 && ps < m) view[ps] = max(view[ps], a.suspect_key[r]);
  }

  // four packet merges
  for (int ch = 0; ch < 4; ++ch) {
    if (!a.ch_valid[ch][r]) continue;
    if constexpr (PACKED) {
      const int k = a.pig_k;
      const int32_t* cid = a.ch_id[ch] + r * k;
      const int32_t* cview = a.ch_view[ch] + r * k;
      for (int j = 0; j < k; ++j) {
        const int32_t in_id = cid[j];
        if (in_id < 0) continue;
        const int32_t in_view = cview[j];
        const int c = in_id % m;
        const bool same = id[c] == in_id;
        const bool ins = id[c] < 0;
        const bool take = id[c] >= 0 && id[c] != in_id &&
                          (view[c] & 3) == kDown && (in_view & 3) == kAlive;
        if (same) view[c] = max(view[c], in_view);
        if (ins || take) {
          view[c] = in_view;
          id[c] = in_id;
        }
      }
      continue;
    }
    const int32_t* cid = a.ch_id[ch] + base;
    const int32_t* cview = a.ch_view[ch] + base;
    const uint8_t* csend = a.ch_send[ch] + base;
    for (int c = 0; c < m; ++c) {
      const int32_t in_id = cid[c];
      if (in_id < 0 || !csend[c]) continue;
      const int32_t in_view = cview[c];
      const bool same = id[c] == in_id;
      const bool ins = id[c] < 0;
      const bool take = id[c] >= 0 && id[c] != in_id &&
                        (view[c] & 3) == kDown && (in_view & 3) == kAlive;
      if (same) view[c] = max(view[c], in_view);
      if (ins || take) {
        view[c] = in_view;
        id[c] = in_id;
      }
    }
  }

  // sender-alive assertions at snd % m
  for (int ch = 0; ch < 4; ++ch) {
    const int32_t snd = a.ch_snd[ch][r];
    const bool valid = a.ch_valid[ch][r] != 0;
    const int32_t s_key = pack_inc_state(a.ch_snd_inc[ch][r], kAlive);
    const int slot = ((snd % m) + m) % m;
    const int32_t cur = id[slot];
    const bool same1 = cur == snd;
    const bool free1 = cur < 0;
    if (valid && (same1 || free1)) view[slot] = max(view[slot], s_key);
    if (valid && free1) id[slot] = snd;
  }

  const bool alive = a.alive[r] != 0;
  const int32_t sends = a.sends[r];
  const int32_t* old_id = a.old_id + base;
  const int32_t* old_view = a.old_view + base;
  TT* o_timer = static_cast<TT*>(a.o_timer) + base;
  int32_t tx[kMaxSlots];

  // budget decrement, suspicion / down timers, purge
  for (int c = 0; c < m; ++c) {
    int32_t t = static_cast<int32_t>(tx_in[c]);
    if (!PACKED && t > 0) t -= sends;
    tx[c] = PACKED ? t : max(t, 0);

    const bool occupied = id[c] >= 0;
    const bool changed = view[c] != old_view[c] || id[c] != old_id[c];
    const bool is_suspect = occupied && view[c] >= 0 && (view[c] & 3) == kSuspect;
    const bool newly = changed && is_suspect;
    int32_t timer = newly ? a.suspicion_rounds : static_cast<int32_t>(timer_in[c]);
    if (is_suspect && !newly && alive) timer -= 1;
    const bool expired = is_suspect && timer <= 0 && alive;
    if (expired) view[c] = pack_inc_state(view[c] >> 2, kDown);
    const bool is_down = occupied && view[c] >= 0 && (view[c] & 3) == kDown;
    const bool newly_down = expired || (changed && is_down);
    if (is_down && newly_down) timer = a.down_purge_rounds;
    if (is_down && !newly_down && alive) timer -= 1;
    if (is_down && timer <= 0 && alive) {
      id[c] = kFree;
      view[c] = kFree;
    }
    o_timer[c] = static_cast<TT>(timer);
  }

  // refutation and self refresh
  const int32_t node = a.node_id[r];
  const int32_t ss = a.self_slot[r];
  const bool ss_in = ss >= 0 && ss < m;
  const int32_t id_at_self = ss_in ? id[ss] : 0;
  const int32_t view_at_self = ss_in ? view[ss] : -1;
  const int32_t self_gossip = id_at_self == node ? view_at_self : -1;
  const int32_t heard = max(a.sus_heard[r], self_gossip);
  int32_t inc = a.inc[r];
  const bool refute = alive && heard >= pack_inc_state(inc, kSuspect);
  if (refute) inc = (heard >> 2) + 1;
  if (alive && ss_in) {
    view[ss] = pack_inc_state(inc, kAlive);
    id[ss] = node;
  }

  // fresh news refills the dissemination budget
  XT* o_tx = static_cast<XT*>(a.o_tx) + base;
  for (int c = 0; c < m; ++c) {
    const bool changed = view[c] != old_view[c] || id[c] != old_id[c];
    o_tx[c] = static_cast<XT>(changed ? a.max_transmissions : tx[c]);
    a.o_id[base + c] = id[c];
    a.o_view[base + c] = view[c];
  }
  a.o_inc[r] = inc;
  a.o_refute[r] = refute ? 1 : 0;
}

extern "C" int swim_tables_max_slots() { return kMaxSlots; }

template <typename TT, typename XT>
static void launch_form(const SwimArgs* a, int packed, dim3 grid, int threads,
                        cudaStream_t s) {
  if (packed) {
    swim_tables_kernel<TT, XT, true><<<grid, threads, 0, s>>>(*a);
  } else {
    swim_tables_kernel<TT, XT, false><<<grid, threads, 0, s>>>(*a);
  }
}

// timer_bytes / tx_bytes: the element sizes of the timer and budget planes;
// the valid pairs are (2, 1), (2, 2) and (4, 4). Returns a CUDA error code,
// or cudaErrorInvalidValue for any other pair.
extern "C" int swim_tables_launch(const SwimArgs* a, int timer_bytes,
                                  int tx_bytes, int packed, void* stream) {
  if (a->n == 0) return 0;
  const int threads = 128;
  const dim3 grid((a->n + threads - 1) / threads);
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
