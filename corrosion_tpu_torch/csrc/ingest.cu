// Receiver-side changeset ingest, for Hopper (sm_90a).
//
// Replaces: corrosion_tpu/ops/megakernel.py::_ingest_kernel (the pallas_call
// at megakernel.py:918), in each of its forms:
//   EMIT = false  ingest_changes_fused (megakernel.py:795), the scale round's
//                 piggyback receive batch (4 channels x pig_changes messages
//                 per row) and the full view's recv_slots-wide mailbox (m=96);
//                 also the local write without payload (m=1);
//   EMIT = true   local_write_fused (megakernel.py:960), the local write as a
//                 one-message batch that also selects and packs this round's
//                 piggyback payload from the updated queue planes.
// Plain PyTorch version beside the wrapper:
// corrosion_tpu_torch/ops/megakernel.py::ingest_plain.
//
// Bound on this card: bytes. Per node row the kernel reads the message planes
// (10 x m int32), the LWW store (5 x C int32), the book (4 x O int32 + O*W
// seen words), the queue planes (9 x Q, q_cell and q_tx at their own plane
// dtypes), the clock, and with EMIT the pre-drawn uniforms (Q float32) and
// the delivery count; it writes the same planes plus fresh/drift (and the
// payload with EMIT). The per-row work is a few thousand integer operations,
// far below the card's integer rate, so those bytes over 3.35 TB/s are the
// least time it could take.
//
// Design: one warp per node row, kRowsPerBlock rows (warps) a block. Every
// global access of a warp is one contiguous span of its row, so it is
// coalesced. Lanes hold
//   - the row's messages: message lane + 32k in chunk k < KM (KM = 1 for
//     m <= 32, 4 for the full view's m = 96), as registers and, for the
//     per-message flags (live, fresh, recorded, enqueued), as warp ballots;
//   - its origins: lane c < O holds book slot c (head, known_max, org_id,
//     org_last and its W seen words);
//   - its queue slots: slot lane + 32h, h < QH (1 for Q <= 32, else 2), all
//     nine planes in registers;
//   - its cells: cell lane + 32h, h < CH (2 for C <= 64, else 8: up to 256
//     cells, a template parameter, so that the narrower rows keep the
//     smaller shared-memory row); the LWW store row is copied to shared
//     memory with cp.async while the messages are checked, updated there
//     by the batch winners and written out from there.
// A lane reads another lane's element with __shfl_sync. Shared memory holds,
// per warp, the staged store row, the claim's per-slot candidate, the
// record step's seen words and known_max (set with shared atomicOr/atomicMax,
// which are order-free), and the message index of each enqueue rank: 2,304
// bytes a warp at CH = 2, 6,144 at CH = 8. No array is indexed by data in
// registers: every register array is indexed by an unrolled loop counter,
// so nothing goes to the stack.
//
// The pallas body's sequential steps, made lane-parallel, with its tie rules:
//   - HLC fold: a warp max of (ok ? ts : 0) over the batch (not clamped at 0
//     when every message is ok), the drift count a ballot popcount; the
//     m > 0 guard and the arithmetic >> on the signed stamp are kept.
//   - Dedupe: a message is a duplicate when an earlier live message has the
//     same (origin, dbv). Within a chunk, __match_any_sync on the 64-bit key
//     masked to live lanes below this one; across chunks, each live message
//     of an earlier chunk is broadcast once and compared (O(m) each).
//   - Claim: each fresh candidate origin above its slot's owner goes into a
//     shared atomicMax per slot; lane c takes it when the slot is evictable
//     (owner < 0 || org_last + keep_rounds < now, wrapping add). org_last =
//     now on a take or when the slot is active (a recorded message on it,
//     an OR-reduced bitmask). Seen bits are set with shared atomicOr; known
//     max takes live && owned; the head advance keeps the explicit branches
//     for shift counts of 0 and of 32 or more, which C leaves undefined.
//   - LWW: a fresh message on a valid cell is its cell's batch winner under
//     (clp, ver, val, site, dbv), the lower index winning a full tie; each
//     lane checks its own messages against the row's fresh ones, broadcast
//     one at a time (O(m) each). At most one winner per cell, so winners
//     update the staged store without a race, unless the incumbent wins the
//     four keys (it also wins an exact tie).
//   - Enqueue: the pallas body places messages in order, each into the slot
//     of least (evict key, column), where a kNoQ slot's key is INT32_MIN,
//     marks the taken slot INT32_MAX, and stops placing once the least key
//     left is INT32_MAX. Here the enqueued messages (fresh under
//     enqueue_all, else recorded) are ranked by order, an exclusive
//     ballot-popcount prefix carried across chunks; the slots are ranked by
//     their initial (key, column), ascending; and the message of rank r goes
//     to the slot of rank r if r < Q and that slot's initial key is below
//     INT32_MAX, else it is dropped. Equivalence: by induction the first r
//     placed messages took the slots of ranks 0..r-1, now INT32_MAX; every
//     slot left keeps its initial key, and the slot of rank r is the least
//     of them by (key, column), so it is the argmin (lowest column on ties)
//     whenever its key is below INT32_MAX, which beats every taken slot;
//     when its key is INT32_MAX, or r >= Q, the least key left is INT32_MAX
//     and the loop places nothing more. This holds for m > Q too (the full
//     view's m = 96 into Q = 64). Only the ranks below E = min(enqueued, Q)
//     are needed, so the slot of rank r is found by the (r+1)-th round of a
//     warp argmin (__reduce_min_sync of the key, then the lowest column
//     holding it by ballot), which marks its slot taken: E rounds of a few
//     instructions, not a rank count of O(Q) per slot. Each slot of rank
//     r < E gathers its message's fields by shuffle.
//   - EMIT: keep = the first `allowed` live slots (q_origin != kNoQ and
//     tx > 0) ranked by (q_tx descending, column ascending): all live slots
//     when they are no more than `allowed` (the usual case), else an O(Q)
//     rank count per slot. The R picks are the first R slots ranked by
//     (keep ? rand : -1.0 descending, index ascending): R rounds of a warp
//     argmax of the draw as an order-preserving int32 (-0.0 mapped to +0.0,
//     which compare equal as floats), the first index among equal draws, a
//     taken slot dropped below every other (a pick past Q is slot 0, as the
//     pallas body's argmax over all-taken slots gives); sel_ok is value >= 0.
//     The payload is [N, 11 R], field-major in each row, with q_seq = 0 and
//     q_nseq = 1.
//
// Wrapping int32 arithmetic goes through uint32. q_cell (CT) and q_tx (XT)
// have types of their own, widened to int32 in registers and cast at the
// store: (int16, int8) under narrow_q_int8, (int16, int16) under
// narrow_dtypes, else (int32, int32).
//
// Instantiations: 3 type pairs x {EMIT with m <= 32, non-emitting m <= 32,
// non-emitting m <= 128} x QH {1, 2} x CH {2, 8} = 36. ptxas (-Xptxas -v,
// printed by chip_smoke.py's build phase) reports 0 bytes of stack frame
// and 0 bytes of spill for all 18 at CH = 2, 9,216 bytes of shared memory a
// block (4 rows), and registers: m <= 32 non-emitting 56 (Q <= 32) / 70
// (Q = 64), emitting 61-62 / 72, m <= 128 109 / 113-122; at CH = 8, 24,576
// bytes a block and at most 3 registers more (emitting 64).
// Times on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit (kernel device
// time from torch.profiler; chip_smoke.py, random inputs): the 1M point's
// receive 2.11 ms and emitting write 2.02 ms against bounds of 1.68 and
// 1.66 ms by bytes; the flagship's (N = 100,000) 0.22 and 0.21 ms against
// 0.17; the full view's m = 96 receive at N = 8192 0.152 ms against 0.027,
// held back by its O(m) broadcast loops at 2,048 blocks, a few waves deep.

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

// warps (node rows) a block: 2 and 4 measured within 1 %, 8 and 16 4-14 %
// slower on the 1M point's forms (PERF.md, Findings)
constexpr int kRowsPerBlock = 4;
constexpr int kMaxMsgs = 32;  // scale batches, and every emitting form
constexpr int kMaxMsgsWide = 128;  // the full view's recv_slots mailboxes
constexpr int kMaxOrigins = 32;
constexpr int kMaxWords = 4;
constexpr int kMaxQueue = 64;
constexpr int kMaxPig = 16;
constexpr int kMaxCells = 256;  // CH = 8 cells a lane
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int32_t kNoQ = -1;
constexpr int32_t kIntMin = INT32_MIN;
constexpr int32_t kIntMax = INT32_MAX;

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}

// lexicographic compare of (a0..a4) against (b0..b4): 1, 0 or -1
__device__ __forceinline__ int lex_cmp5(int32_t a0, int32_t a1, int32_t a2, int32_t a3,
                                        int32_t a4, int32_t b0, int32_t b1, int32_t b2,
                                        int32_t b3, int32_t b4) {
  if (a0 != b0) return a0 > b0 ? 1 : -1;
  if (a1 != b1) return a1 > b1 ? 1 : -1;
  if (a2 != b2) return a2 > b2 ? 1 : -1;
  if (a3 != b3) return a3 > b3 ? 1 : -1;
  if (a4 != b4) return a4 > b4 ? 1 : -1;
  return 0;
}

// element k of a register array, k a runtime index: an unrolled select, so
// the array stays in registers (0 past n)
template <int N, typename T>
__device__ __forceinline__ T pick(const T (&v)[N], int k, int n) {
  T out = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i == k && i < n) out = v[i];
  }
  return out;
}

// lane `src`'s element of chunk `chunk` of a per-lane register array
template <int N>
__device__ __forceinline__ int32_t shfl_chunk(const int32_t (&v)[N], int src, int chunk,
                                              int n_chunks) {
  int32_t out = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (k < n_chunks) {
      const int32_t x = __shfl_sync(kFull, v[k], src);
      if (k == chunk) out = x;
    }
  }
  return out;
}

__device__ __forceinline__ bool bit(unsigned mask, int lane) { return (mask >> lane) & 1u; }

// the lowest column (lane + 32h) holding `key` among the lanes' QH slots,
// or -1
template <int QH>
__device__ __forceinline__ int warp_lowest_column(const int32_t (&k)[QH], int32_t key) {
  int col = -1;
#pragma unroll
  for (int h = QH - 1; h >= 0; --h) {
    const unsigned b = __ballot_sync(kFull, k[h] == key);
    if (b) col = 32 * h + __ffs(b) - 1;
  }
  return col;
}

// the column of the least key (lowest column on ties), or -1 when that key
// is `stop`
template <int QH>
__device__ __forceinline__ int warp_arg_least(const int32_t (&k)[QH], int32_t stop) {
  int32_t least = k[0];
#pragma unroll
  for (int h = 1; h < QH; ++h) least = min(least, k[h]);
  least = __reduce_min_sync(kFull, least);
  return least == stop ? -1 : warp_lowest_column<QH>(k, least);
}

// the column of the greatest key (lowest column on ties); the key in `most`
template <int QH>
__device__ __forceinline__ int warp_arg_most(const int32_t (&k)[QH], int32_t& most) {
  int32_t m = k[0];
#pragma unroll
  for (int h = 1; h < QH; ++h) m = max(m, k[h]);
  most = __reduce_max_sync(kFull, m);
  return warp_lowest_column<QH>(k, most);
}

// float32 to int32 with the same order (no NaN); -0.0 maps with +0.0
__device__ __forceinline__ int32_t float_order(float f) {
  const int32_t i = __float_as_int(f == 0.0f ? 0.0f : f);
  return i >= 0 ? i : i ^ 0x7FFFFFFF;
}

// One warp's slice of the block's shared memory (CH cells a lane).
template <int CH>
struct WarpSmem {
  int32_t store[5][32 * CH];  // the LWW store row: ver, val, site, dbv, clp
  int32_t cand[kMaxOrigins];  // claim: largest fresh candidate origin a slot
  int32_t km[kMaxOrigins];
  uint32_t seen[kMaxOrigins * kMaxWords];
  int32_t msg_of_rank[kMaxQueue];  // enqueue: message index of each rank
};

}  // namespace

struct IngestArgs {
  // messages [N, m]
  const uint8_t* live;
  const int32_t* origin;
  const int32_t* dbv;
  const int32_t* cell;
  const int32_t* ver;
  const int32_t* val;
  const int32_t* site;
  const int32_t* clp;
  const int32_t* ts;
  const int32_t* budget;
  // LWW store [N, C]: ver, val, site, dbv, clp
  const int32_t* store[5];
  // book [N, O] and seen words [N, O*W]
  const int32_t* head;
  const int32_t* km;
  const int32_t* seen;
  const int32_t* org_id;
  const int32_t* org_last;
  // queue [N, Q]; q_cell and q_tx at their plane dtypes
  const int32_t* q_origin;
  const int32_t* q_dbv;
  const void* q_cell;
  const int32_t* q_ver;
  const int32_t* q_val;
  const int32_t* q_site;
  const int32_t* q_clp;
  const int32_t* q_ts;
  const void* q_tx;
  const int32_t* hlc;
  const int32_t* now;  // device scalar
  const float* rand;  // [N, Q], EMIT only
  const int32_t* carried;  // [N], EMIT only
  // outputs
  int32_t* o_store[5];
  int32_t* o_head;
  int32_t* o_km;
  int32_t* o_seen;
  int32_t* o_org_id;
  int32_t* o_org_last;
  int32_t* o_q_origin;
  int32_t* o_q_dbv;
  void* o_q_cell;
  int32_t* o_q_ver;
  int32_t* o_q_val;
  int32_t* o_q_site;
  int32_t* o_q_clp;
  int32_t* o_q_ts;
  void* o_q_tx;
  int32_t* o_hlc;
  uint8_t* o_fresh;
  int32_t* o_drift;
  int32_t* o_payload;  // [N, 11 * pig_r], EMIT only
  int32_t* o_sel;  // [N, pig_r]
  uint8_t* o_selok;  // [N, pig_r]
  int32_t n;
  int32_t m;
  int32_t n_origins;
  int32_t n_cells;
  int32_t q_slots;
  int32_t seen_words;
  int32_t hlc_round_bits;
  int32_t hlc_max_drift;
  int32_t pig_r;
  int32_t budget_bytes;
  int32_t wire_bytes;
  int32_t keep_rounds;
  int32_t enqueue_all;
};

template <typename CT, typename XT, bool EMIT, int KM, int QH, int CH>
__global__ void __launch_bounds__(32 * kRowsPerBlock) ingest_kernel(const IngestArgs a) {
  __shared__ WarpSmem<CH> smem[kRowsPerBlock];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + warp;
  if (r >= a.n) return;  // the whole warp: rows past n are masked
  WarpSmem<CH>& sm = smem[warp];
  const int m = a.m, O = a.n_origins, W = a.seen_words, C = a.n_cells, Q = a.q_slots;
  const int kn = (m + 31) >> 5;  // chunks in use
  const unsigned below = (1u << lane) - 1u;  // lanes below this one
  const int32_t now = *a.now;

  // --- stage the store row in shared memory (waited for at the LWW step) --
  const int64_t cb = r * C;
#pragma unroll
  for (int h = 0; h < CH; ++h) {
    const int c = lane + 32 * h;
    if (c < C) {
#pragma unroll
      for (int s = 0; s < 5; ++s) __pipeline_memcpy_async(&sm.store[s][c], a.store[s] + cb + c, 4);
    }
  }
  __pipeline_commit();

  // --- loads: messages, book, queue -----------------------------------------
  const int64_t mb = r * m;
  int32_t origin[KM], dbv[KM], ts[KM];
  unsigned live_b[KM];
#pragma unroll
  for (int k = 0; k < KM; ++k) {
    const int j = lane + 32 * k;
    const bool in = j < m;
    origin[k] = in ? a.origin[mb + j] : -1;
    dbv[k] = in ? a.dbv[mb + j] : 0;
    ts[k] = in ? a.ts[mb + j] : 0;
    live_b[k] = __ballot_sync(kFull, in && a.live[mb + j] != 0);
  }
  const bool has_o = lane < O;
  const int64_t ob = r * O;
  int32_t head = has_o ? a.head[ob + lane] : 0;
  int32_t km = has_o ? a.km[ob + lane] : 0;
  int32_t org_id = has_o ? a.org_id[ob + lane] : -1;
  int32_t org_last = has_o ? a.org_last[ob + lane] : 0;
  uint32_t sw[kMaxWords];
  const int64_t sb = r * O * W + lane * W;
#pragma unroll
  for (int w = 0; w < kMaxWords; ++w) {
    sw[w] = (has_o && w < W) ? static_cast<uint32_t>(a.seen[sb + w]) : 0u;
  }
  const int64_t qb = r * Q;
  const CT* q_cell = static_cast<const CT*>(a.q_cell) + qb;
  const XT* q_tx = static_cast<const XT*>(a.q_tx) + qb;
  int32_t qo[QH], qd[QH], qc[QH], qv[QH], qval[QH], qs[QH], qcl[QH], qt[QH], qx[QH];
#pragma unroll
  for (int h = 0; h < QH; ++h) {
    const int q = lane + 32 * h;
    const bool in = q < Q;
    qo[h] = in ? a.q_origin[qb + q] : kNoQ;
    qd[h] = in ? a.q_dbv[qb + q] : 0;
    qc[h] = in ? static_cast<int32_t>(q_cell[q]) : 0;
    qv[h] = in ? a.q_ver[qb + q] : 0;
    qval[h] = in ? a.q_val[qb + q] : 0;
    qs[h] = in ? a.q_site[qb + q] : 0;
    qcl[h] = in ? a.q_clp[qb + q] : 0;
    qt[h] = in ? a.q_ts[qb + q] : 0;
    qx[h] = in ? static_cast<int32_t>(q_tx[q]) : 0;
  }
  float rand[QH];
  int32_t carried = 1;
  if constexpr (EMIT) {
#pragma unroll
    for (int h = 0; h < QH; ++h) {
      const int q = lane + 32 * h;
      rand[h] = q < Q ? a.rand[qb + q] : 0.0f;
    }
    carried = max(a.carried[r], 1);
  }

  // --- HLC fold with max-drift rejection --------------------------------
  const int32_t horizon = wrap_add(now, a.hlc_max_drift);
  int32_t folded = kIntMin;
  int drift = 0;
#pragma unroll
  for (int k = 0; k < KM; ++k) {
    const bool lv = bit(live_b[k], lane);
    const bool ok = lv && (ts[k] >> a.hlc_round_bits) <= horizon;
    if (lane + 32 * k < m) folded = max(folded, ok ? ts[k] : 0);
    drift += __popc(__ballot_sync(kFull, lv && !ok));
    live_b[k] = __ballot_sync(kFull, ok);
  }
  folded = __reduce_max_sync(kFull, folded);
  if (lane == 0) {
    const int32_t hlc_in = a.hlc[r];
    a.o_hlc[r] = m > 0 ? max(hlc_in, folded) : hlc_in;
    a.o_drift[r] = drift;
  }

  // --- seen check + in-batch dedupe ---------------------------------------
  unsigned fresh_b[KM];
  bool dup[KM];
#pragma unroll
  for (int k = 0; k < KM; ++k) {
    const unsigned long long key =
        (static_cast<unsigned long long>(static_cast<uint32_t>(origin[k])) << 32) |
        static_cast<uint32_t>(dbv[k]);
    dup[k] = (__match_any_sync(kFull, key) & live_b[k] & below) != 0u;
  }
#pragma unroll
  for (int ks = 0; ks + 1 < KM; ++ks) {
    unsigned bits = live_b[ks];
    while (bits) {  // each live message of chunk ks against the later chunks
      const int t = __ffs(bits) - 1;
      bits &= bits - 1u;
      const int32_t ot = __shfl_sync(kFull, origin[ks], t);
      const int32_t dt = __shfl_sync(kFull, dbv[ks], t);
#pragma unroll
      for (int kd = ks + 1; kd < KM; ++kd) {
        dup[kd] = dup[kd] || (ot == origin[kd] && dt == dbv[kd]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < KM; ++k) {
    const int32_t o_j = origin[k];
    const int sl = o_j >= 0 ? o_j % O : 0;
    const int32_t owner = __shfl_sync(kFull, org_id, sl);
    const int32_t h = __shfl_sync(kFull, head, sl);
    const int32_t off = wrap_sub(wrap_sub(dbv[k], h), 1);
    const bool in_win = off >= 0 && off < 32 * W;
    const int wi = in_win ? (off >> 5) : 0;
    uint32_t word = 0u;
#pragma unroll
    for (int w = 0; w < kMaxWords; ++w) {
      if (w < W) {
        const uint32_t x = __shfl_sync(kFull, sw[w], sl);
        if (w == wi) word = x;
      }
    }
    const bool hit = ((word >> (off & 31)) & 1u) == 1u;
    const bool lv = bit(live_b[k], lane);
    const bool owned_pre = o_j >= 0 && owner == o_j;
    const bool seen_b = lv && owned_pre && (dbv[k] <= h || (in_win && hit));
    fresh_b[k] = __ballot_sync(kFull, lv && !seen_b && !dup[k]);
  }

  // --- the fresh messages' remaining fields (read now, used from the LWW on)
  int32_t cell[KM], ver[KM], val[KM], site[KM], clp[KM], bud[KM];
#pragma unroll
  for (int k = 0; k < KM; ++k) {
    const int64_t j = mb + lane + 32 * k;
    const bool fr = bit(fresh_b[k], lane);
    cell[k] = fr ? a.cell[j] : -1;
    ver[k] = fr ? a.ver[j] : 0;
    val[k] = fr ? a.val[j] : 0;
    site[k] = fr ? a.site[j] : 0;
    clp[k] = fr ? a.clp[j] : 0;
    bud[k] = fr ? a.budget[j] : 0;
  }

  // --- slot claim/evict (monotone in the actor id) -------------------------
  if (has_o) sm.cand[lane] = -1;
  __syncwarp();
#pragma unroll
  for (int k = 0; k < KM; ++k) {
    const int32_t o_j = origin[k];
    const int sl = o_j >= 0 ? o_j % O : 0;
    const int32_t owner = __shfl_sync(kFull, org_id, sl);
    if (bit(fresh_b[k], lane) && o_j >= 0 && o_j > owner) atomicMax(&sm.cand[sl], o_j);
  }
  __syncwarp();
  bool take = false;
  if (has_o) {
    const int32_t cand = sm.cand[lane];
    const bool evictable = org_id < 0 || wrap_add(org_last, a.keep_rounds) < now;
    take = cand >= 0 && evictable;  // a candidate's origin is >= 0
    if (take) org_id = cand;
  }
  // recorded messages: fresh and owned after the claim; a slot is active
  // when one of them lies on it
  unsigned rec_b[KM], owned_b[KM];
  unsigned active = 0u;
#pragma unroll
  for (int k = 0; k < KM; ++k) {
    const int32_t o_j = origin[k];
    const int sl = o_j >= 0 ? o_j % O : 0;
    const int32_t owner = __shfl_sync(kFull, org_id, sl);  // every lane shuffles
    const bool owned = o_j >= 0 && owner == o_j;
    const bool rec = bit(fresh_b[k], lane) && owned;
    owned_b[k] = __ballot_sync(kFull, owned);
    rec_b[k] = __ballot_sync(kFull, rec);
    active |= rec ? (1u << sl) : 0u;
  }
  active = __reduce_or_sync(kFull, active);
  if (has_o) {
    if (take || bit(active, lane)) org_last = now;
    if (take) {
      head = 0;
      km = 0;
#pragma unroll
      for (int w = 0; w < kMaxWords; ++w) sw[w] = 0u;
    }
    sm.km[lane] = km;
#pragma unroll
    for (int w = 0; w < kMaxWords; ++w) {
      if (w < W) sm.seen[lane * W + w] = sw[w];
    }
  }
  __syncwarp();

  // --- record: seen-bit OR, known_max --------------------------------------
#pragma unroll
  for (int k = 0; k < KM; ++k) {
    const int32_t o_j = origin[k];
    const int sl = o_j >= 0 ? o_j % O : 0;
    const int32_t h = __shfl_sync(kFull, head, sl);
    const int32_t off = wrap_sub(wrap_sub(dbv[k], h), 1);
    const bool in_win = off >= 0 && off < 32 * W;
    if (bit(rec_b[k], lane) && in_win) atomicOr(&sm.seen[sl * W + (off >> 5)], 1u << (off & 31));
    if (bit(live_b[k], lane) && bit(owned_b[k], lane)) atomicMax(&sm.km[sl], dbv[k]);
  }
  __syncwarp();

  // --- head advance: trailing ones, then shift the window down ------------
  if (has_o) {
    km = sm.km[lane];
#pragma unroll
    for (int w = 0; w < kMaxWords; ++w) {
      if (w < W) sw[w] = sm.seen[lane * W + w];
    }
    int32_t total = 0;
    bool carry = true;
#pragma unroll
    for (int w = 0; w < kMaxWords; ++w) {
      if (w < W) {
        const uint32_t x = sw[w];
        const int32_t t = x == 0xFFFFFFFFu ? 32 : __popc(x ^ (x + 1u)) - 1;
        if (carry) total += t;
        carry = carry && t == 32;
      }
    }
    head = wrap_add(head, total);
    const int s_words = total >> 5;
    const int s_bits = total & 31;
    uint32_t shifted[kMaxWords];
#pragma unroll
    for (int w = 0; w < kMaxWords; ++w) {
      const uint32_t lo = pick(sw, w + s_words, W);
      const uint32_t hi = pick(sw, w + s_words + 1, W);
      shifted[w] = s_bits > 0 ? (lo >> s_bits) | (hi << (32 - s_bits)) : lo;
    }
    km = max(km, head);
    a.o_head[ob + lane] = head;
    a.o_km[ob + lane] = km;
    a.o_org_id[ob + lane] = org_id;
    a.o_org_last[ob + lane] = org_last;
#pragma unroll
    for (int w = 0; w < kMaxWords; ++w) {
      if (w < W) a.o_seen[sb + w] = static_cast<int32_t>(shifted[w]);
    }
  }
#pragma unroll
  for (int k = 0; k < KM; ++k) {
    const int j = lane + 32 * k;
    if (j < m) a.o_fresh[mb + j] = bit(fresh_b[k], lane) ? 1 : 0;
  }

  // --- LWW apply of fresh cells --------------------------------------------
  unsigned cand_b[KM];
  bool best[KM];
#pragma unroll
  for (int k = 0; k < KM; ++k) {
    best[k] = bit(fresh_b[k], lane) && cell[k] >= 0 && cell[k] < C;
    cand_b[k] = __ballot_sync(kFull, best[k]);
  }
#pragma unroll
  for (int ks = 0; ks < KM; ++ks) {
    unsigned bits = cand_b[ks];
    while (bits) {  // each candidate against every lane's own candidates
      const int t = __ffs(bits) - 1;
      bits &= bits - 1u;
      const int32_t ct = __shfl_sync(kFull, cell[ks], t);
      const int32_t t0 = __shfl_sync(kFull, clp[ks], t);
      const int32_t t1 = __shfl_sync(kFull, ver[ks], t);
      const int32_t t2 = __shfl_sync(kFull, val[ks], t);
      const int32_t t3 = __shfl_sync(kFull, site[ks], t);
      const int32_t t4 = __shfl_sync(kFull, dbv[ks], t);
      const int tj = t + 32 * ks;
#pragma unroll
      for (int kd = 0; kd < KM; ++kd) {
        const int j = lane + 32 * kd;
        if (best[kd] && ct == cell[kd] && tj != j) {
          const int cmp = lex_cmp5(t0, t1, t2, t3, t4, clp[kd], ver[kd], val[kd], site[kd], dbv[kd]);
          if (cmp > 0 || (cmp == 0 && tj < j)) best[kd] = false;
        }
      }
    }
  }
  __pipeline_wait_prior(0);
  __syncwarp();
#pragma unroll
  for (int k = 0; k < KM; ++k) {
    if (best[k]) {
      const int c = cell[k];
      // the incumbent (clp, ver, val, site) wins ties
      const int cmp = lex_cmp5(sm.store[4][c], sm.store[0][c], sm.store[1][c], sm.store[2][c], 0,
                               clp[k], ver[k], val[k], site[k], 0);
      if (cmp < 0) {
        sm.store[0][c] = ver[k];
        sm.store[1][c] = val[k];
        sm.store[2][c] = site[k];
        sm.store[3][c] = dbv[k];
        sm.store[4][c] = clp[k];
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int h = 0; h < CH; ++h) {
    const int c = lane + 32 * h;
    if (c < C) {
#pragma unroll
      for (int s = 0; s < 5; ++s) a.o_store[s][cb + c] = sm.store[s][c];
    }
  }

  // --- re-broadcast enqueue: the r-th message into the r-th least slot -----
  int n_enq = 0;
#pragma unroll
  for (int k = 0; k < KM; ++k) {
    const unsigned eb = a.enqueue_all ? fresh_b[k] : rec_b[k];
    const int rk = n_enq + __popc(eb & below);
    if (bit(eb, lane) && rk < Q) sm.msg_of_rank[rk] = lane + 32 * k;
    n_enq += __popc(eb);
  }
  // the slot of rank r, r < min(E, Q): r + 1 rounds of a warp argmin of the
  // evict key (the lowest column among equal keys), each taking its slot
  int32_t ekey[QH];
  int my_rank[QH];
#pragma unroll
  for (int h = 0; h < QH; ++h) {
    const int q = lane + 32 * h;
    ekey[h] = q < Q ? (qo[h] == kNoQ ? kIntMin : qx[h]) : kIntMax;
    my_rank[h] = -1;
  }
  const int n_place = min(n_enq, Q);
  for (int rr = 0; rr < n_place; ++rr) {
    const int slot = warp_arg_least<QH>(ekey, kIntMax);
    if (slot < 0) break;  // the least key left is INT32_MAX: nothing more placed
#pragma unroll
    for (int h = 0; h < QH; ++h) {
      if (lane + 32 * h == slot) {
        ekey[h] = kIntMax;
        my_rank[h] = rr;
      }
    }
  }
  __syncwarp();
  CT* o_q_cell = static_cast<CT*>(a.o_q_cell) + qb;
  XT* o_q_tx = static_cast<XT*>(a.o_q_tx) + qb;
#pragma unroll
  for (int h = 0; h < QH; ++h) {
    const int q = lane + 32 * h;
    const bool placed = my_rank[h] >= 0;
    const int j = placed ? sm.msg_of_rank[my_rank[h]] : 0;
    const int src = j & 31, ch = j >> 5;
    const int32_t f_origin = shfl_chunk(origin, src, ch, kn);
    const int32_t f_dbv = shfl_chunk(dbv, src, ch, kn);
    const int32_t f_cell = shfl_chunk(cell, src, ch, kn);
    const int32_t f_ver = shfl_chunk(ver, src, ch, kn);
    const int32_t f_val = shfl_chunk(val, src, ch, kn);
    const int32_t f_site = shfl_chunk(site, src, ch, kn);
    const int32_t f_clp = shfl_chunk(clp, src, ch, kn);
    const int32_t f_ts = shfl_chunk(ts, src, ch, kn);
    const int32_t f_bud = shfl_chunk(bud, src, ch, kn);
    if (placed) {
      qo[h] = f_origin;
      qd[h] = f_dbv;
      qc[h] = static_cast<int32_t>(static_cast<CT>(f_cell));
      qv[h] = f_ver;
      qval[h] = f_val;
      qs[h] = f_site;
      qcl[h] = f_clp;
      qt[h] = f_ts;
      qx[h] = static_cast<int32_t>(static_cast<XT>(f_bud));
    }
    if (q < Q) {
      a.o_q_origin[qb + q] = qo[h];
      a.o_q_dbv[qb + q] = qd[h];
      o_q_cell[q] = static_cast<CT>(qc[h]);
      a.o_q_ver[qb + q] = qv[h];
      a.o_q_val[qb + q] = qval[h];
      a.o_q_site[qb + q] = qs[h];
      a.o_q_clp[qb + q] = qcl[h];
      a.o_q_ts[qb + q] = qt[h];
      o_q_tx[q] = static_cast<XT>(qx[h]);
    }
  }

  if constexpr (EMIT) {
    // --- piggyback payload selection from the updated queue ---------------
    const int R = a.pig_r;
    const int32_t allowed = max(a.budget_bytes / (a.wire_bytes * carried), 1);
    // keep: the first `allowed` live slots by (q_tx descending, column
    // ascending); all of them when they are no more than `allowed`
    bool keep[QH];
    int n_live = 0;
#pragma unroll
    for (int h = 0; h < QH; ++h) {
      keep[h] = lane + 32 * h < Q && qo[h] != kNoQ && qx[h] > 0;
      n_live += __popc(__ballot_sync(kFull, keep[h]));
    }
    if (n_live > allowed) {
      int brank[QH] = {};
#pragma unroll
      for (int hs = 0; hs < QH; ++hs) {
#pragma unroll 8
        for (int t = 0; t < 32; ++t) {
          const bool lt = __shfl_sync(kFull, static_cast<int>(keep[hs]), t) != 0;
          const int32_t bt = __shfl_sync(kFull, qx[hs], t);
          const int idx = t + 32 * hs;
#pragma unroll
          for (int h = 0; h < QH; ++h) {
            const int q = lane + 32 * h;
            brank[h] += (lt && (bt > qx[h] || (bt == qx[h] && idx < q))) ? 1 : 0;
          }
        }
      }
#pragma unroll
      for (int h = 0; h < QH; ++h) keep[h] = keep[h] && brank[h] < allowed;
    }
    // the R picks: R rounds of a warp argmax of (keep ? rand : -1.0), as
    // order-preserving int32 (+0.0 for -0.0, which compares equal), the
    // first index among equal draws; a taken slot drops below every other
    int32_t pkey[QH];
#pragma unroll
    for (int h = 0; h < QH; ++h) {
      const float v = keep[h] ? rand[h] : -1.0f;
      pkey[h] = lane + 32 * h < Q ? float_order(v) : kIntMin;
    }
    int my_pick = 0;
    int32_t my_ok = 0;
    for (int i = 0; i < R; ++i) {
      int32_t best_key = kIntMin;
      const int slot = warp_arg_most<QH>(pkey, best_key);
#pragma unroll
      for (int h = 0; h < QH; ++h) {
        if (lane + 32 * h == slot) pkey[h] = kIntMin;
      }
      if (lane == i) {
        my_pick = slot;
        my_ok = best_key >= 0 ? 1 : 0;  // the draw is >= 0.0
      }
    }
    // lane i < R packs pick i
    const int src = my_pick & 31, hs = my_pick >> 5;
    const int32_t p_origin = shfl_chunk(qo, src, hs, QH);
    const int32_t p_dbv = shfl_chunk(qd, src, hs, QH);
    const int32_t p_cell = shfl_chunk(qc, src, hs, QH);
    const int32_t p_ver = shfl_chunk(qv, src, hs, QH);
    const int32_t p_val = shfl_chunk(qval, src, hs, QH);
    const int32_t p_site = shfl_chunk(qs, src, hs, QH);
    const int32_t p_clp = shfl_chunk(qcl, src, hs, QH);
    const int32_t p_ts = shfl_chunk(qt, src, hs, QH);
    if (lane < R) {
      int32_t* pay = a.o_payload + r * 11 * R;
      pay[0 * R + lane] = p_origin;
      pay[1 * R + lane] = p_dbv;
      pay[2 * R + lane] = p_cell;
      pay[3 * R + lane] = p_ver;
      pay[4 * R + lane] = p_val;
      pay[5 * R + lane] = p_site;
      pay[6 * R + lane] = p_clp;
      pay[7 * R + lane] = 0;  // q_seq: single-cell versions
      pay[8 * R + lane] = 1;  // q_nseq
      pay[9 * R + lane] = p_ts;
      pay[10 * R + lane] = my_ok;
      a.o_sel[r * R + lane] = my_pick;
      a.o_selok[r * R + lane] = static_cast<uint8_t>(my_ok);
    }
  }
}

// out: the widest batch (m) of any form, origins, seen words, queue slots,
// payload entries, the widest batch of the narrow (and every emitting)
// instantiation, and cells.
extern "C" int ingest_limits(int* out) {
  out[0] = kMaxMsgsWide;
  out[1] = kMaxOrigins;
  out[2] = kMaxWords;
  out[3] = kMaxQueue;
  out[4] = kMaxPig;
  out[5] = kMaxMsgs;
  out[6] = kMaxCells;
  return 0;
}

// the queue's slots a lane (QH) and the cells a lane (CH) are template
// parameters, so that a queue of 32 slots carries no second half and a row
// of up to 64 cells keeps the smaller shared-memory row
template <typename CT, typename XT, bool EMIT, int KM, int CH>
static void launch_queue(const IngestArgs* a, dim3 grid, int threads, cudaStream_t s) {
  if (a->q_slots <= 32) {
    ingest_kernel<CT, XT, EMIT, KM, 1, CH><<<grid, threads, 0, s>>>(*a);
  } else {
    ingest_kernel<CT, XT, EMIT, KM, kMaxQueue / 32, CH><<<grid, threads, 0, s>>>(*a);
  }
}

template <typename CT, typename XT, bool EMIT, int KM>
static void launch_cells(const IngestArgs* a, dim3 grid, int threads, cudaStream_t s) {
  if (a->n_cells <= 64) {
    launch_queue<CT, XT, EMIT, KM, 2>(a, grid, threads, s);
  } else {
    launch_queue<CT, XT, EMIT, KM, kMaxCells / 32>(a, grid, threads, s);
  }
}

template <typename CT, typename XT>
static void launch_form(const IngestArgs* a, int emit, dim3 grid, int threads,
                        cudaStream_t s) {
  if (emit) {
    launch_cells<CT, XT, true, kMaxMsgs / 32>(a, grid, threads, s);
  } else if (a->m <= kMaxMsgs) {
    launch_cells<CT, XT, false, kMaxMsgs / 32>(a, grid, threads, s);
  } else {
    launch_cells<CT, XT, false, kMaxMsgsWide / 32>(a, grid, threads, s);
  }
}

// cell_bytes / tx_bytes: the element sizes of the q_cell and q_tx planes;
// the valid pairs are (2, 1), (2, 2) and (4, 4). Returns a CUDA error code,
// or cudaErrorInvalidValue for any other pair or for widths past the limits.
extern "C" int ingest_launch(const IngestArgs* a, int cell_bytes, int tx_bytes,
                             int emit, void* stream) {
  if (a->m < 0 || a->m > (emit ? kMaxMsgs : kMaxMsgsWide) || a->n_origins < 1 ||
      a->n_origins > kMaxOrigins || a->seen_words > kMaxWords || a->q_slots > kMaxQueue ||
      a->n_cells > kMaxCells || a->pig_r > kMaxPig) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a->n == 0) return 0;
  const int threads = 32 * kRowsPerBlock;
  const dim3 grid((a->n + kRowsPerBlock - 1) / kRowsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cell_bytes == 2 && tx_bytes == 1) {
    launch_form<int16_t, int8_t>(a, emit, grid, threads, s);
  } else if (cell_bytes == 2 && tx_bytes == 2) {
    launch_form<int16_t, int16_t>(a, emit, grid, threads, s);
  } else if (cell_bytes == 4 && tx_bytes == 4) {
    launch_form<int32_t, int32_t>(a, emit, grid, threads, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ingest_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
