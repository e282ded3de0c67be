// Receiver-side changeset ingest, for Hopper (sm_90a).
//
// Replaces: corrosion_tpu/ops/megakernel.py::_ingest_kernel (the pallas_call
// at megakernel.py:918), in each of its forms:
//   EMIT = false  ingest_changes_fused (megakernel.py:795), the scale round's
//                 piggyback receive batch (4 channels x pig_changes messages
//                 per row, up to 4 x 128) and the full view's recv_slots-wide
//                 mailbox (m=96, up to 512); also the local write without
//                 payload (m=1);
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
//     per-message flags (live, fresh, recorded, enqueued), as warp ballots.
//     Past 128 messages, or past 32 picks with EMIT (the long form, KM =
//     0, up to 512 messages: the wide packet's receive of 4 x 64, the full
//     view's mailbox at recv_slots = 256), no message stays in registers:
//     each step reads its chunk's fields from the input planes by index (a
//     row's planes are read again from L1/L2, not from device memory), and
//     the flags live in shared memory, a ballot word per chunk (LongFlags,
//     256 bytes a warp); the steps that pair messages (the dedupe, the LWW
//     winner) load one chunk of each side at a time (holding every chunk's
//     keys in registers, to broadcast each message once, took these forms
//     to ~197 registers a thread and was slower at m = 256: PERF.md);
//   - its origins: lane c < O holds book slot c (head, known_max, org_id,
//     org_last and its W seen words) when O <= 32; past 32 origins (the
//     wide book, WO, up to 256) the whole book row is copied to shared
//     memory with cp.async, slot s at index s, and lane l looks after
//     slots l + 32g (g < ceil(O / 32), a runtime loop) where a step is
//     per slot (the claim's take or keep, the head advance and the
//     write-out); a message reads its slot's fields there directly, since
//     its slot is data;
//   - its queue slots: slot lane + 32h, h < QH (1 for Q <= 32, 2 for Q <=
//     64, and 4, the deep form, for Q <= 128 or a window of more than 4
//     seen words), all nine planes in registers;
//   - its cells: cell lane + 32h, h < CH (2 for C <= 64, else 8: up to 256
//     cells, a template parameter, so that the narrower rows keep the
//     smaller shared-memory row); the LWW store row is copied to shared
//     memory with cp.async while the messages are checked, updated there
//     by the batch winners and written out from there. Past 256 cells
//     (CH = 0, the row in global memory: any width the configuration
//     allows) nothing of the row is staged: the warp first copies the
//     input row's five planes to the output row, lane l taking cells
//     l + 32i, kCopy = 4 of them a step with every load before any store
//     (a runtime loop of ceil(C / 128) steps, coalesced, 20 loads in
//     flight a lane: 8.68 -> 6.28 ms at N = 100,000 and 4,096 cells, one
//     cell a step against four, scripts/ingest_ab.py --tables), and each
//     batch winner later reads its cell's incumbent from the input planes
//     and writes the output planes, behind a __syncwarp() that orders its
//     write after the copy of that cell by another lane.
// A lane reads another lane's element with __shfl_sync. Shared memory holds,
// per warp, the staged store row, the claim's per-slot candidate, the
// record step's seen words and known_max (set with shared atomicOr/atomicMax,
// which are order-free), and the message index of each enqueue rank: 2,304
// bytes a warp at CH = 2, 6,144 at CH = 8, 1,024 at CH = 0. The wide book
// adds head, org_id and org_last and sizes the per-slot arrays for 256
// slots of up to 4 words: 14,592 bytes a warp at CH = 8 (a row of up to
// 256 cells), 9,472 at CH = 0, so its blocks hold 2 rows (29,184 bytes at
// CH = 8, under the 48 KB of static shared memory) where the others hold
// 4. The deep form (QH = 4) sizes the seen words for 8 a slot and the
// enqueue's ranks for 128: 3,072 bytes a warp at CH = 2, 6,912 at CH = 8,
// 1,792 at CH = 0; the wide book 18,944 at CH = 8 (37,888 a block of 2
// rows) and 13,824 at CH = 0; the long form adds its 256 bytes of flags
// (38,400 bytes a block at the wide book's CH = 8). No array is indexed by
// data in registers:
// every register array is indexed by an unrolled loop counter, so nothing
// goes to the stack.
//
// The pallas body's sequential steps, made lane-parallel, with its tie rules:
//   - HLC fold: a warp max of (ok ? ts : 0) over the batch (not clamped at 0
//     when every message is ok), the drift count a ballot popcount; the
//     m > 0 guard and the arithmetic >> on the signed stamp are kept.
//   - Dedupe: a message is a duplicate when an earlier live message has the
//     same (origin, dbv). Within a chunk, __match_any_sync on the 64-bit key
//     masked to live lanes below this one; across chunks, each live message
//     of an earlier chunk is broadcast once and compared (O(m) each; the
//     long form loads the earlier chunk's keys for each later chunk).
//   - Claim: each fresh candidate origin above its slot's owner goes into a
//     shared atomicMax per slot; lane c takes it when the slot is evictable
//     (owner < 0 || org_last + keep_rounds < now, wrapping add). org_last =
//     now on a take or when the slot is active (a recorded message on it,
//     an OR-reduced bitmask; in the wide book each recorded message stores
//     now into its slot's org_last, the same value from every lane, after
//     the takes and before the head advance reads it). Seen bits are set
//     with shared atomicOr; known max takes live && owned; the head advance
//     keeps the explicit branches
//     for shift counts of 0 and of 32 or more, which C leaves undefined.
//   - LWW: a fresh message on a valid cell is its cell's batch winner under
//     (clp, ver, val, site, dbv), the lower index winning a full tie; each
//     lane checks its own messages against the row's fresh ones, broadcast
//     one at a time (O(m) each; the long form broadcasts a candidate's cell
//     alone, a lane whose candidate is on that cell reads both messages'
//     keys from the input planes, and a chunk's winners are applied once
//     its comparisons are done). At most one winner per cell, so winners
//     update the staged store (at CH = 0 the output row) without a race,
//     unless the incumbent wins the four keys (it also wins an exact tie).
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
//     r < E gathers its message's fields by shuffle (the long form reads
//     them from the input planes).
//     At Q = 128 and m = 128 the same rule holds: a message of rank r >=
//     128 is dropped, and the rounds stop at the first INT32_MAX key.
//   - EMIT: keep = the first `allowed` live slots (q_origin != kNoQ and
//     tx > 0) ranked by (q_tx descending, column ascending): all live slots
//     when they are no more than `allowed` (the usual case), else an O(Q)
//     rank count per slot. The R picks are the first R slots ranked by
//     (keep ? rand : -1.0 descending, index ascending): R rounds of a warp
//     argmax of the draw as an order-preserving int32 (-0.0 mapped to +0.0,
//     which compare equal as floats), the first index among equal draws, a
//     taken slot dropped below every other (a pick past Q is slot 0, as the
//     pallas body's argmax over all-taken slots gives); sel_ok is value >= 0.
//     Lane i < R keeps pick i, so R is at most 32; past 32 picks (the long
//     form, up to 128) lane i % 32 keeps pick i as its (i / 32)-th of up to
//     QH = 4. The payload is [N, 11 R], field-major in each row, with q_seq
//     = 0 and q_nseq = 1, written in pick order.
//
// Wrapping int32 arithmetic goes through uint32. q_cell (CT) and q_tx (XT)
// have types of their own, widened to int32 in registers and cast at the
// store: (int16, int8) under narrow_q_int8, (int16, int16) under
// narrow_dtypes, else (int32, int32).
//
// Instantiations: 3 type pairs x {EMIT with m <= 32, non-emitting m <= 32,
// non-emitting m <= 128} x QH {1, 2, 4} x {the register book at CH 2, 8 and
// 0, the wide book at CH 8 and 0} = 135, and the long form (KM = 0: the
// emitting batches past 32 messages or 32 picks, the non-emitting ones past
// 128 messages) in the deep form alone (QH = 4, whatever Q and W are) and
// with EMIT alone (it emits when pig_r > 0: the launcher sets pig_r = 0
// for a non-emitting batch, where a twin without EMIT would double the 15
// and the build), 3 x 5 = 15 more, 150 in all. The shallow forms (QH 1 and
// 2) hold
// up to 4 seen words; the deep form (QH 4) up to 8, in registers for the
// register book (the seen check's shuffles and the head advance's selects
// run over 8 words) and in shared memory for the wide book. ptxas
// (-Xptxas -v, printed and checked by chip_smoke.py's build phase) reports
// 0 bytes of stack frame and 0 bytes of spill for all 150. The shallow
// forms: all 18 at CH = 2, 9,216 bytes of shared memory a block (4 rows),
// and registers: m <= 32 non-emitting 56 (Q <= 32) / 70 (Q = 64), emitting
// 61-62 / 72, m <= 128 109 / 113-122; at CH = 8, 24,576 bytes a
// block and at most 3 registers more (emitting 64); the wide book 29,184
// bytes a block (2 rows) and m <= 32 non-emitting 74 / 82, emitting 76 /
// 89-91, m <= 128 112 / 126-128 registers. At CH = 0 (the CH 2 and 8
// reports unchanged by it): 4,096 bytes a block with the register book and
// m <= 32 non-emitting 56 / 64, emitting 64 / 64, m <= 128 108 / 112
// registers; 18,944 bytes a block (2 rows) with the wide book and 76 / 80,
// 80 / 80, 96 / 96-106. The deep form, registers a thread by type pair,
// EMIT / m <= 32 / m <= 128: register book at CH = 2 (12,288 bytes a
// block) 115-119 / 101-102 / 136-138; at CH = 8 (27,648 bytes) 115-127 /
// 96-102 / 128-143; at CH = 0 (7,168 bytes) 112-120 / 96 / 128-145; wide
// book at CH = 8 (37,888 bytes, 2 rows) 126-127 / 121-122 / 152-154; at
// CH = 0 (27,648 bytes) 126 / 113 / 128. The long form, registers a
// thread: the register book at CH = 2 (13,312 bytes a block), 8 (28,672)
// and 0 (8,192) 92-96; the wide book at CH = 8 (38,400 bytes, 2 rows) and
// 0 (28,160) 104-111.
// Times on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit (kernel device
// time from torch.profiler; chip_smoke.py, random inputs): the 1M point's
// receive 2.11 ms and emitting write 2.02 ms against bounds of 1.68 and
// 1.66 ms by bytes; the flagship's (N = 100,000) 0.22 and 0.21 ms against
// 0.17; the full view's m = 96 receive at N = 8192 0.152 ms against 0.027,
// held back by its O(m) broadcast loops at 2,048 blocks, a few waves deep.
// The wide book at the many-writer flagship (N = 100,000, 256 origins,
// 64x4 cells): receive 0.809 ms and emitting write 0.792 ms against bounds
// of 0.685 and 0.683 ms by bytes (the book's five planes, 5 KB a row, are
// most of them). The row in global memory at N = 100,000 and 4,096 cells
// (int16/int16, 16 origins): receive 5.93 ms and emitting write 5.75 ms
// against bounds of 4.98 ms by bytes (the store's ten planes, 16.4 GB of
// the 16.7, are most of them: every launch rewrites the whole row); at
// 4,100 cells (int16/int8) 7.17 ms, its rows off the 128-byte grid. The
// deep form at the deep queue (N = 100,000, 256 origins, 64x4 cells, 128
// queue slots, 8 seen words, int16/int16): the receive of 128 messages 2.95
// ms against a bound of 1.38 ms by bytes, held back by its O(m) broadcast
// loops (the dedupe across chunks and the LWW winner check); the emitting
// write (32 picks) 1.78 ms against 1.35. The long form at the wide packet
// (the deep queue with 64 changes a packet): the receive of 256 messages
// 13.06-14.60 ms against a bound of 1.49 ms by bytes, held back by its
// pairwise loops (O(m^2 / 32) dependent shuffles a row, at 10 warps an SM
// with the wide book); the emitting write (64 picks) 2.06-2.09 ms against
// 1.39; a receive of 512 messages 48.13 ms against 1.69, 128 picks 2.23
// ms against 1.49.

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

// warps (node rows) a block: 2 and 4 measured within 1 %, 8 and 16 4-14 %
// slower on the 1M point's forms (PERF.md, Findings)
constexpr int kRowsPerBlock = 4;
// the wide book's form: 2 rows a block keep its shared rows (14,592 bytes a
// warp) under the 48 KB of static shared memory a block
constexpr int kRowsPerBlockWide = 2;
constexpr int kMaxMsgs = 32;  // scale batches, and the emitting forms of KM = 1
constexpr int kMaxMsgsWide = 128;  // the full view's recv_slots mailboxes
// the long form (KM = 0): the batch stays in global memory, its flags in
// shared memory (a ballot word per 32 messages); it takes up to 4 picks a
// lane (the deep form's 128 queue slots)
constexpr int kMaxMsgsLong = 512;
constexpr int kLongChunks = kMaxMsgsLong / 32;
constexpr int kMaxPigLong = 128;
constexpr int kMaxOrigins = 32;  // a book slot a lane, in registers
constexpr int kMaxOriginsWide = 256;  // the book in shared memory
// the shallow forms (QH 1 and 2) hold up to 4 seen words and 64 queue
// slots; past either the deep form (QH 4) runs, with up to 8 and 128
constexpr int kMaxWords = 4;
constexpr int kMaxQueue = 64;
constexpr int kMaxWordsDeep = 8;
constexpr int kMaxQueueDeep = 128;
constexpr int kMaxPig = 32;  // a pick a lane
constexpr int kMaxStagedCells = 256;  // CH = 8 cells a lane in shared memory
// past kMaxStagedCells the row stays in global memory (CH = 0): its copy
// takes kCopy cells a lane a step, and any width whose copy loop (c0 + 32
// kCopy) stays in int32
constexpr int kCopy = 4;
constexpr int kMaxCells = INT32_MAX - 32 * kCopy + 1;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int32_t kNoQ = -1;
constexpr int32_t kIntMin = INT32_MIN;
constexpr int32_t kIntMax = INT32_MAX;

// seen words and queue slots (the enqueue's ranks) a form with QH queue
// slots a lane holds
template <int QH>
constexpr int kWordsOf = QH * 32 > kMaxQueue ? kMaxWordsDeep : kMaxWords;
template <int QH>
constexpr int kRanksOf = QH * 32 > kMaxQueue ? kMaxQueueDeep : kMaxQueue;

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

// The staged LWW store row (CH cells a lane): ver, val, site, dbv, clp;
// none at CH = 0, where the row stays in global memory.
template <int CH>
struct StoreRow {
  int32_t store[5][32 * CH];
};
template <>
struct StoreRow<0> {};

// One warp's slice of the block's shared memory (CH cells a lane, QH queue
// slots a lane). With WO (more than 32 origins) the whole book lives here,
// slot s at index s.
template <int CH, bool WO, int QH>
struct WarpSmem : StoreRow<CH> {
  int32_t cand[kMaxOrigins];  // claim: largest fresh candidate origin a slot
  int32_t km[kMaxOrigins];
  uint32_t seen[kMaxOrigins * kWordsOf<QH>];
  int32_t msg_of_rank[kRanksOf<QH>];  // enqueue: message index of each rank
};

template <int CH, int QH>
struct WarpSmem<CH, true, QH> : StoreRow<CH> {
  int32_t cand[kMaxOriginsWide];
  int32_t km[kMaxOriginsWide];
  uint32_t seen[kMaxOriginsWide * kWordsOf<QH>];
  int32_t msg_of_rank[kRanksOf<QH>];
  int32_t head[kMaxOriginsWide];
  int32_t org_id[kMaxOriginsWide];
  int32_t org_last[kMaxOriginsWide];
};

// The long form's per-message flags, message lane + 32k at bit `lane` of
// word k; set by lane 0, read after a __syncwarp().
struct LongFlags {
  unsigned live[kLongChunks];  // live and inside the drift horizon
  unsigned fresh[kLongChunks];
  unsigned owned[kLongChunks];  // on a slot that tracks its origin after the claim
  unsigned rec[kLongChunks];  // fresh and owned: recorded
};

template <int CH, bool WO, int QH>
struct LongSmem : WarpSmem<CH, WO, QH>, LongFlags {};

template <int KM, int CH, bool WO, int QH>
using SmemOf = std::conditional_t<KM == 0, LongSmem<CH, WO, QH>, WarpSmem<CH, WO, QH>>;

// the owner and head of book slot `sl` (every lane calls: the register book
// shuffles them from lane sl)
template <bool WO, typename S>
__device__ __forceinline__ void book_slot(const S& sm, int32_t org_id, int32_t head, int sl,
                                          int32_t& owner, int32_t& h) {
  if constexpr (WO) {
    owner = sm.org_id[sl];
    h = sm.head[sl];
  } else {
    owner = __shfl_sync(kFull, org_id, sl);
    h = __shfl_sync(kFull, head, sl);
  }
}

// the long form's LWW write of a batch winner (clp, ver, val, site, dbv) on
// cell c: over the staged row (CH > 0) or the output row (CH = 0), unless
// the incumbent wins the four keys (it also wins an exact tie)
template <int CH, typename S, typename A>
__device__ __forceinline__ void apply_winner(S& sm, const A& a, int64_t cb, int c, int32_t clp,
                                             int32_t ver, int32_t val, int32_t site,
                                             int32_t dbv) {
  if constexpr (CH > 0) {
    if (lex_cmp5(sm.store[4][c], sm.store[0][c], sm.store[1][c], sm.store[2][c], 0, clp, ver,
                 val, site, 0) < 0) {
      sm.store[0][c] = ver;
      sm.store[1][c] = val;
      sm.store[2][c] = site;
      sm.store[3][c] = dbv;
      sm.store[4][c] = clp;
    }
  } else {
    const int64_t i = cb + c;
    if (lex_cmp5(a.store[4][i], a.store[0][i], a.store[1][i], a.store[2][i], 0, clp, ver, val,
                 site, 0) < 0) {
      a.o_store[0][i] = ver;
      a.o_store[1][i] = val;
      a.o_store[2][i] = site;
      a.o_store[3][i] = dbv;
      a.o_store[4][i] = clp;
    }
  }
}

// the head advance of one slot: the trailing ones of its W seen words
// (returned), and the words shifted down past them
template <int WM>
__device__ __forceinline__ int32_t advance_window(const uint32_t (&sw)[WM], int W,
                                                  uint32_t (&shifted)[WM]) {
  int32_t total = 0;
  bool carry = true;
#pragma unroll
  for (int w = 0; w < WM; ++w) {
    if (w < W) {
      const uint32_t x = sw[w];
      const int32_t t = x == 0xFFFFFFFFu ? 32 : __popc(x ^ (x + 1u)) - 1;
      if (carry) total += t;
      carry = carry && t == 32;
    }
  }
  const int s_words = total >> 5;
  const int s_bits = total & 31;
#pragma unroll
  for (int w = 0; w < WM; ++w) {
    const uint32_t lo = pick(sw, w + s_words, W);
    const uint32_t hi = pick(sw, w + s_words + 1, W);
    shifted[w] = s_bits > 0 ? (lo >> s_bits) | (hi << (32 - s_bits)) : lo;
  }
  return total;
}

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

template <typename CT, typename XT, bool EMIT, int KM, int QH, int CH, bool WO>
__global__ void __launch_bounds__(32 * (WO ? kRowsPerBlockWide : kRowsPerBlock))
    ingest_kernel(const IngestArgs a) {
  constexpr int kRows = WO ? kRowsPerBlockWide : kRowsPerBlock;
  constexpr int WM = kWordsOf<QH>;  // seen words this form holds
  constexpr int KA = KM > 0 ? KM : 1;  // register chunks (the long form's unused)
  using Smem = SmemOf<KM, CH, WO, QH>;
  __shared__ Smem smem[kRows];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kRows + warp;
  if (r >= a.n) return;  // the whole warp: rows past n are masked
  Smem& sm = smem[warp];
  const int m = a.m, O = a.n_origins, W = a.seen_words, C = a.n_cells, Q = a.q_slots;
  const int kn = (m + 31) >> 5;  // chunks in use
  const unsigned below = (1u << lane) - 1u;  // lanes below this one
  const int32_t now = *a.now;
  const int64_t ob = r * O;

  // --- WO: stage the book in shared memory (waited for at the seen check) --
  if constexpr (WO) {
    for (int s = lane; s < O; s += 32) {
      __pipeline_memcpy_async(&sm.head[s], a.head + ob + s, 4);
      __pipeline_memcpy_async(&sm.km[s], a.km + ob + s, 4);
      __pipeline_memcpy_async(&sm.org_id[s], a.org_id + ob + s, 4);
      __pipeline_memcpy_async(&sm.org_last[s], a.org_last + ob + s, 4);
    }
    for (int i = lane; i < O * W; i += 32) {
      __pipeline_memcpy_async(&sm.seen[i], a.seen + ob * W + i, 4);
    }
    __pipeline_commit();
  }

  // --- stage the store row in shared memory (waited for at the LWW step);
  // at CH = 0 copy it to the output row instead ---------------------------
  const int64_t cb = r * C;
  if constexpr (CH > 0) {
#pragma unroll
    for (int h = 0; h < CH; ++h) {
      const int c = lane + 32 * h;
      if (c < C) {
#pragma unroll
        for (int s = 0; s < 5; ++s) __pipeline_memcpy_async(&sm.store[s][c], a.store[s] + cb + c, 4);
      }
    }
  } else {
    // kCopy cells a lane a step, every load before any store, so that 5 x
    // kCopy loads are in flight (the compiler may not hoist a load above a
    // store that could alias it)
    for (int c0 = lane; c0 < C; c0 += 32 * kCopy) {
      int32_t v[kCopy][5];
#pragma unroll
      for (int u = 0; u < kCopy; ++u) {
        const int c = c0 + 32 * u;
#pragma unroll
        for (int s = 0; s < 5; ++s) v[u][s] = c < C ? a.store[s][cb + c] : 0;
      }
#pragma unroll
      for (int u = 0; u < kCopy; ++u) {
        const int c = c0 + 32 * u;
        if (c < C) {
#pragma unroll
          for (int s = 0; s < 5; ++s) a.o_store[s][cb + c] = v[u][s];
        }
      }
    }
  }
  __pipeline_commit();  // an empty group at CH = 0: the WO wait counts groups

  // --- loads: messages, book, queue -----------------------------------------
  const int64_t mb = r * m;
  int32_t origin[KA], dbv[KA], ts[KA];
  unsigned live_b[KA];
#pragma unroll
  for (int k = 0; k < KM; ++k) {
    const int j = lane + 32 * k;
    const bool in = j < m;
    origin[k] = in ? a.origin[mb + j] : -1;
    dbv[k] = in ? a.dbv[mb + j] : 0;
    ts[k] = in ? a.ts[mb + j] : 0;
    live_b[k] = __ballot_sync(kFull, in && a.live[mb + j] != 0);
  }
  // a book slot a lane (O <= 32); with WO the book is in shared memory
  const bool has_o = !WO && lane < O;
  int32_t head = has_o ? a.head[ob + lane] : 0;
  int32_t km = has_o ? a.km[ob + lane] : 0;
  int32_t org_id = has_o ? a.org_id[ob + lane] : -1;
  int32_t org_last = has_o ? a.org_last[ob + lane] : 0;
  uint32_t sw[WM];
  const int64_t sb = r * O * W + lane * W;
#pragma unroll
  for (int w = 0; w < WM; ++w) {
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
  if constexpr (EMIT && KM > 0) {  // the long form reads them at the payload
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
  if constexpr (KM == 0) {
    // the long form: a chunk of 32 messages at a time, read where it is used
    for (int k = 0; k < kn; ++k) {
      const int j = lane + 32 * k;
      const bool in = j < m;
      const int32_t t = in ? a.ts[mb + j] : 0;
      const bool lv = in && a.live[mb + j] != 0;
      const bool ok = lv && (t >> a.hlc_round_bits) <= horizon;
      if (in) folded = max(folded, ok ? t : 0);
      drift += __popc(__ballot_sync(kFull, lv && !ok));
      const unsigned ok_b = __ballot_sync(kFull, ok);
      if (lane == 0) sm.live[k] = ok_b;
    }
    __syncwarp();
  }
  folded = __reduce_max_sync(kFull, folded);
  if (lane == 0) {
    const int32_t hlc_in = a.hlc[r];
    a.o_hlc[r] = m > 0 ? max(hlc_in, folded) : hlc_in;
    a.o_drift[r] = drift;
  }

  // --- seen check + in-batch dedupe ---------------------------------------
  if constexpr (WO) {
    __pipeline_wait_prior(1);  // the book's copies, not the store row's
    __syncwarp();
  }
  unsigned fresh_b[KA];
  bool dup[KA];
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
    int32_t owner, h;
    if constexpr (WO) {
      owner = sm.org_id[sl];
      h = sm.head[sl];
    } else {
      owner = __shfl_sync(kFull, org_id, sl);
      h = __shfl_sync(kFull, head, sl);
    }
    const int32_t off = wrap_sub(wrap_sub(dbv[k], h), 1);
    const bool in_win = off >= 0 && off < 32 * W;
    const int wi = in_win ? (off >> 5) : 0;
    uint32_t word = 0u;
    if constexpr (WO) {
      word = sm.seen[sl * W + wi];
    } else {
#pragma unroll
      for (int w = 0; w < WM; ++w) {
        if (w < W) {
          const uint32_t x = __shfl_sync(kFull, sw[w], sl);
          if (w == wi) word = x;
        }
      }
    }
    const bool hit = ((word >> (off & 31)) & 1u) == 1u;
    const bool lv = bit(live_b[k], lane);
    const bool owned_pre = o_j >= 0 && owner == o_j;
    const bool seen_b = lv && owned_pre && (dbv[k] <= h || (in_win && hit));
    fresh_b[k] = __ballot_sync(kFull, lv && !seen_b && !dup[k]);
  }
  if constexpr (KM == 0) {
    for (int k = 0; k < kn; ++k) {
      const int j = lane + 32 * k;
      const bool in = j < m;
      const int32_t o_j = in ? a.origin[mb + j] : -1;
      const int32_t d_j = in ? a.dbv[mb + j] : 0;
      const unsigned live_k = sm.live[k];
      const unsigned long long key =
          (static_cast<unsigned long long>(static_cast<uint32_t>(o_j)) << 32) |
          static_cast<uint32_t>(d_j);
      bool dup_j = (__match_any_sync(kFull, key) & live_k & below) != 0u;
      for (int ks = 0; ks < k; ++ks) {  // each live message of an earlier chunk
        unsigned bits = sm.live[ks];
        if (bits == 0u) continue;
        const int js = lane + 32 * ks;
        const int32_t o_s = js < m ? a.origin[mb + js] : -1;
        const int32_t d_s = js < m ? a.dbv[mb + js] : 0;
        while (bits) {
          const int t = __ffs(bits) - 1;
          bits &= bits - 1u;
          const int32_t ot = __shfl_sync(kFull, o_s, t);
          const int32_t dt = __shfl_sync(kFull, d_s, t);
          dup_j = dup_j || (ot == o_j && dt == d_j);
        }
      }
      const int sl = o_j >= 0 ? o_j % O : 0;
      int32_t owner, h;
      book_slot<WO>(sm, org_id, head, sl, owner, h);
      const int32_t off = wrap_sub(wrap_sub(d_j, h), 1);
      const bool in_win = off >= 0 && off < 32 * W;
      const int wi = in_win ? (off >> 5) : 0;
      uint32_t word = 0u;
      if constexpr (WO) {
        word = sm.seen[sl * W + wi];
      } else {
#pragma unroll
        for (int w = 0; w < WM; ++w) {
          if (w < W) {
            const uint32_t x = __shfl_sync(kFull, sw[w], sl);
            if (w == wi) word = x;
          }
        }
      }
      const bool hit = ((word >> (off & 31)) & 1u) == 1u;
      const bool lv = bit(live_k, lane);
      const bool seen_b = lv && o_j >= 0 && owner == o_j && (d_j <= h || (in_win && hit));
      const unsigned fr = __ballot_sync(kFull, lv && !seen_b && !dup_j);
      if (lane == 0) sm.fresh[k] = fr;
    }
    __syncwarp();
  }

  // --- the fresh messages' remaining fields (read now, used from the LWW on)
  int32_t cell[KA], ver[KA], val[KA], site[KA], clp[KA], bud[KA];
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
  if constexpr (WO) {
    for (int s = lane; s < O; s += 32) sm.cand[s] = -1;
  } else {
    if (has_o) sm.cand[lane] = -1;
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < KM; ++k) {
    const int32_t o_j = origin[k];
    const int sl = o_j >= 0 ? o_j % O : 0;
    int32_t owner;
    if constexpr (WO) {
      owner = sm.org_id[sl];
    } else {
      owner = __shfl_sync(kFull, org_id, sl);
    }
    if (bit(fresh_b[k], lane) && o_j >= 0 && o_j > owner) atomicMax(&sm.cand[sl], o_j);
  }
  if constexpr (KM == 0) {
    for (int k = 0; k < kn; ++k) {
      const int j = lane + 32 * k;
      const int32_t o_j = j < m ? a.origin[mb + j] : -1;
      const int sl = o_j >= 0 ? o_j % O : 0;
      int32_t owner, h;
      book_slot<WO>(sm, org_id, head, sl, owner, h);
      if (bit(sm.fresh[k], lane) && o_j >= 0 && o_j > owner) atomicMax(&sm.cand[sl], o_j);
    }
  }
  __syncwarp();
  bool take = false;
  if constexpr (WO) {
    // each lane takes or keeps its slots s = lane + 32g; a take starts the
    // slot anew (head, known max and seen words 0) and marks it now
    for (int s = lane; s < O; s += 32) {
      const int32_t cand = sm.cand[s];
      const bool evictable = sm.org_id[s] < 0 || wrap_add(sm.org_last[s], a.keep_rounds) < now;
      if (cand >= 0 && evictable) {
        sm.org_id[s] = cand;
        sm.org_last[s] = now;
        sm.head[s] = 0;
        sm.km[s] = 0;
        for (int w = 0; w < W; ++w) sm.seen[s * W + w] = 0u;
      }
    }
    __syncwarp();
  } else if (has_o) {
    const int32_t cand = sm.cand[lane];
    const bool evictable = org_id < 0 || wrap_add(org_last, a.keep_rounds) < now;
    take = cand >= 0 && evictable;  // a candidate's origin is >= 0
    if (take) org_id = cand;
  }
  // recorded messages: fresh and owned after the claim; a slot is active
  // when one of them lies on it (with WO its recorded messages mark it now:
  // every lane stores the same value)
  unsigned rec_b[KA], owned_b[KA];
  unsigned active = 0u;
#pragma unroll
  for (int k = 0; k < KM; ++k) {
    const int32_t o_j = origin[k];
    const int sl = o_j >= 0 ? o_j % O : 0;
    int32_t owner;
    if constexpr (WO) {
      owner = sm.org_id[sl];
    } else {
      owner = __shfl_sync(kFull, org_id, sl);  // every lane shuffles
    }
    const bool owned = o_j >= 0 && owner == o_j;
    const bool rec = bit(fresh_b[k], lane) && owned;
    owned_b[k] = __ballot_sync(kFull, owned);
    rec_b[k] = __ballot_sync(kFull, rec);
    if constexpr (WO) {
      if (rec) sm.org_last[sl] = now;
    } else {
      active |= rec ? (1u << sl) : 0u;
    }
  }
  if constexpr (KM == 0) {
    for (int k = 0; k < kn; ++k) {
      const int j = lane + 32 * k;
      const int32_t o_j = j < m ? a.origin[mb + j] : -1;
      const int sl = o_j >= 0 ? o_j % O : 0;
      int32_t owner, h;
      book_slot<WO>(sm, org_id, head, sl, owner, h);
      const bool owned = o_j >= 0 && owner == o_j;
      const bool rec = bit(sm.fresh[k], lane) && owned;
      const unsigned o_b = __ballot_sync(kFull, owned);
      const unsigned r_b = __ballot_sync(kFull, rec);
      if (lane == 0) {
        sm.owned[k] = o_b;
        sm.rec[k] = r_b;
      }
      if constexpr (WO) {
        if (rec) sm.org_last[sl] = now;
      } else {
        active |= rec ? (1u << sl) : 0u;
      }
    }
  }
  if constexpr (!WO) active = __reduce_or_sync(kFull, active);
  if (has_o) {
    if (take || bit(active, lane)) org_last = now;
    if (take) {
      head = 0;
      km = 0;
#pragma unroll
      for (int w = 0; w < WM; ++w) sw[w] = 0u;
    }
    sm.km[lane] = km;
#pragma unroll
    for (int w = 0; w < WM; ++w) {
      if (w < W) sm.seen[lane * W + w] = sw[w];
    }
  }
  __syncwarp();

  // --- record: seen-bit OR, known_max --------------------------------------
#pragma unroll
  for (int k = 0; k < KM; ++k) {
    const int32_t o_j = origin[k];
    const int sl = o_j >= 0 ? o_j % O : 0;
    int32_t h;
    if constexpr (WO) {
      h = sm.head[sl];
    } else {
      h = __shfl_sync(kFull, head, sl);
    }
    const int32_t off = wrap_sub(wrap_sub(dbv[k], h), 1);
    const bool in_win = off >= 0 && off < 32 * W;
    if (bit(rec_b[k], lane) && in_win) atomicOr(&sm.seen[sl * W + (off >> 5)], 1u << (off & 31));
    if (bit(live_b[k], lane) && bit(owned_b[k], lane)) atomicMax(&sm.km[sl], dbv[k]);
  }
  if constexpr (KM == 0) {
    for (int k = 0; k < kn; ++k) {
      const int j = lane + 32 * k;
      const bool in = j < m;
      const int32_t o_j = in ? a.origin[mb + j] : -1;
      const int32_t d_j = in ? a.dbv[mb + j] : 0;
      const int sl = o_j >= 0 ? o_j % O : 0;
      int32_t owner, h;
      book_slot<WO>(sm, org_id, head, sl, owner, h);
      const int32_t off = wrap_sub(wrap_sub(d_j, h), 1);
      const bool in_win = off >= 0 && off < 32 * W;
      if (bit(sm.rec[k], lane) && in_win) atomicOr(&sm.seen[sl * W + (off >> 5)], 1u << (off & 31));
      if (bit(sm.live[k], lane) && bit(sm.owned[k], lane)) atomicMax(&sm.km[sl], d_j);
    }
  }
  __syncwarp();

  // --- head advance: trailing ones, then shift the window down ------------
  if constexpr (WO) {
    for (int s = lane; s < O; s += 32) {
      uint32_t ws[WM], shifted[WM];
#pragma unroll
      for (int w = 0; w < WM; ++w) ws[w] = w < W ? sm.seen[s * W + w] : 0u;
      const int32_t hd = wrap_add(sm.head[s], advance_window(ws, W, shifted));
      a.o_head[ob + s] = hd;
      a.o_km[ob + s] = max(sm.km[s], hd);
      a.o_org_id[ob + s] = sm.org_id[s];
      a.o_org_last[ob + s] = sm.org_last[s];
#pragma unroll
      for (int w = 0; w < WM; ++w) {
        if (w < W) a.o_seen[ob * W + s * W + w] = static_cast<int32_t>(shifted[w]);
      }
    }
  }
  if (has_o) {
    km = sm.km[lane];
#pragma unroll
    for (int w = 0; w < WM; ++w) {
      if (w < W) sw[w] = sm.seen[lane * W + w];
    }
    uint32_t shifted[WM];
    head = wrap_add(head, advance_window(sw, W, shifted));
    km = max(km, head);
    a.o_head[ob + lane] = head;
    a.o_km[ob + lane] = km;
    a.o_org_id[ob + lane] = org_id;
    a.o_org_last[ob + lane] = org_last;
#pragma unroll
    for (int w = 0; w < WM; ++w) {
      if (w < W) a.o_seen[sb + w] = static_cast<int32_t>(shifted[w]);
    }
  }
#pragma unroll
  for (int k = 0; k < KM; ++k) {
    const int j = lane + 32 * k;
    if (j < m) a.o_fresh[mb + j] = bit(fresh_b[k], lane) ? 1 : 0;
  }
  if constexpr (KM == 0) {
    for (int k = 0; k < kn; ++k) {
      const int j = lane + 32 * k;
      if (j < m) a.o_fresh[mb + j] = bit(sm.fresh[k], lane) ? 1 : 0;
    }
  }

  // --- LWW apply of fresh cells --------------------------------------------
  unsigned cand_b[KA];
  bool best[KA];
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
  __syncwarp();  // at CH = 0: every lane's copy of the row before any winner
#pragma unroll
  for (int k = 0; k < KM; ++k) {
    if (best[k]) {
      const int c = cell[k];
      if constexpr (CH > 0) {
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
      } else {
        // the incumbent from the input row; the winner over the copy
        const int64_t i = cb + c;
        const int cmp = lex_cmp5(a.store[4][i], a.store[0][i], a.store[1][i], a.store[2][i], 0,
                                 clp[k], ver[k], val[k], site[k], 0);
        if (cmp < 0) {
          a.o_store[0][i] = ver[k];
          a.o_store[1][i] = val[k];
          a.o_store[2][i] = site[k];
          a.o_store[3][i] = dbv[k];
          a.o_store[4][i] = clp[k];
        }
      }
    }
  }
  if constexpr (KM == 0) {
    // each chunk's candidates against every chunk's, broadcast one at a
    // time by cell (O(m) each); where a lane's candidate is on that cell,
    // the lane reads both messages' keys where they lie; a chunk's winners
    // are applied once its comparisons are done
    for (int kd = 0; kd < kn; ++kd) {
      const int j = lane + 32 * kd;
      const bool fr = bit(sm.fresh[kd], lane);
      const int32_t c = fr ? a.cell[mb + j] : -1;
      bool win = fr && c >= 0 && c < C;
      if (__ballot_sync(kFull, win) == 0u) continue;
      for (int ks = 0; ks < kn; ++ks) {
        const int js = lane + 32 * ks;
        const bool fs = bit(sm.fresh[ks], lane);
        const int32_t cs = fs ? a.cell[mb + js] : -1;
        unsigned bits = __ballot_sync(kFull, fs && cs >= 0 && cs < C);
        while (bits) {
          const int t = __ffs(bits) - 1;
          bits &= bits - 1u;
          const int32_t ct = __shfl_sync(kFull, cs, t);
          const int tj = t + 32 * ks;
          if (win && ct == c && tj != j) {
            const int64_t ti = mb + tj, ji = mb + j;
            const int cmp = lex_cmp5(a.clp[ti], a.ver[ti], a.val[ti], a.site[ti], a.dbv[ti],
                                     a.clp[ji], a.ver[ji], a.val[ji], a.site[ji], a.dbv[ji]);
            if (cmp > 0 || (cmp == 0 && tj < j)) win = false;
          }
        }
      }
      if (win) {
        const int64_t ji = mb + j;
        apply_winner<CH>(sm, a, cb, c, a.clp[ji], a.ver[ji], a.val[ji], a.site[ji], a.dbv[ji]);
      }
    }
  }
  __syncwarp();
  if constexpr (CH > 0) {
#pragma unroll
    for (int h = 0; h < CH; ++h) {
      const int c = lane + 32 * h;
      if (c < C) {
#pragma unroll
        for (int s = 0; s < 5; ++s) a.o_store[s][cb + c] = sm.store[s][c];
      }
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
  if constexpr (KM == 0) {
    for (int k = 0; k < kn; ++k) {
      const unsigned eb = a.enqueue_all ? sm.fresh[k] : sm.rec[k];
      const int rk = n_enq + __popc(eb & below);
      if (bit(eb, lane) && rk < Q) sm.msg_of_rank[rk] = lane + 32 * k;
      n_enq += __popc(eb);
    }
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
    int32_t f_origin = 0, f_dbv = 0, f_cell = 0, f_ver = 0, f_val = 0, f_site = 0, f_clp = 0,
            f_ts = 0, f_bud = 0;
    if constexpr (KM > 0) {
      f_origin = shfl_chunk(origin, src, ch, kn);
      f_dbv = shfl_chunk(dbv, src, ch, kn);
      f_cell = shfl_chunk(cell, src, ch, kn);
      f_ver = shfl_chunk(ver, src, ch, kn);
      f_val = shfl_chunk(val, src, ch, kn);
      f_site = shfl_chunk(site, src, ch, kn);
      f_clp = shfl_chunk(clp, src, ch, kn);
      f_ts = shfl_chunk(ts, src, ch, kn);
      f_bud = shfl_chunk(bud, src, ch, kn);
    } else if (placed) {
      // the long form reads the placed (fresh) message where it lies
      const int64_t i = mb + j;
      f_origin = a.origin[i];
      f_dbv = a.dbv[i];
      f_cell = a.cell[i];
      f_ver = a.ver[i];
      f_val = a.val[i];
      f_site = a.site[i];
      f_clp = a.clp[i];
      f_ts = a.ts[i];
      f_bud = a.budget[i];
    }
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
    if constexpr (KM == 0) {
      // the long form's one instantiation a book and cell width takes the
      // non-emitting batches too, as pig_r = 0
      if (a.pig_r == 0) return;
#pragma unroll
      for (int h = 0; h < QH; ++h) {
        const int q = lane + 32 * h;
        rand[h] = q < Q ? a.rand[qb + q] : 0.0f;
      }
      carried = max(a.carried[r], 1);
    }
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
    if constexpr (KM > 0) {
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
    } else {
      // the long form: pick i at lane i % 32, the (i / 32)-th of its QH
      int my_pick[QH], my_ok[QH];
#pragma unroll
      for (int p = 0; p < QH; ++p) {
        my_pick[p] = 0;
        my_ok[p] = 0;
      }
      for (int i = 0; i < R; ++i) {
        int32_t best_key = kIntMin;
        const int slot = warp_arg_most<QH>(pkey, best_key);
#pragma unroll
        for (int h = 0; h < QH; ++h) {
          if (lane + 32 * h == slot) pkey[h] = kIntMin;
        }
#pragma unroll
        for (int p = 0; p < QH; ++p) {
          if (lane + 32 * p == i) {
            my_pick[p] = slot;
            my_ok[p] = best_key >= 0 ? 1 : 0;
          }
        }
      }
      int32_t* pay = a.o_payload + r * 11 * R;
#pragma unroll
      for (int p = 0; p < QH; ++p) {
        if (32 * p >= R) break;  // the whole warp
        const int src = my_pick[p] & 31, hs = my_pick[p] >> 5;
        const int32_t p_origin = shfl_chunk(qo, src, hs, QH);
        const int32_t p_dbv = shfl_chunk(qd, src, hs, QH);
        const int32_t p_cell = shfl_chunk(qc, src, hs, QH);
        const int32_t p_ver = shfl_chunk(qv, src, hs, QH);
        const int32_t p_val = shfl_chunk(qval, src, hs, QH);
        const int32_t p_site = shfl_chunk(qs, src, hs, QH);
        const int32_t p_clp = shfl_chunk(qcl, src, hs, QH);
        const int32_t p_ts = shfl_chunk(qt, src, hs, QH);
        const int i = lane + 32 * p;
        if (i < R) {
          pay[0 * R + i] = p_origin;
          pay[1 * R + i] = p_dbv;
          pay[2 * R + i] = p_cell;
          pay[3 * R + i] = p_ver;
          pay[4 * R + i] = p_val;
          pay[5 * R + i] = p_site;
          pay[6 * R + i] = p_clp;
          pay[7 * R + i] = 0;
          pay[8 * R + i] = 1;
          pay[9 * R + i] = p_ts;
          pay[10 * R + i] = my_ok[p];
          a.o_sel[r * R + i] = my_pick[p];
          a.o_selok[r * R + i] = static_cast<uint8_t>(my_ok[p]);
        }
      }
    }
  }
}

// out: the widest batch (m) of any form, origins, seen words, queue slots,
// payload entries (picks), the widest batch of the narrow instantiation
// (and of the emitting one of up to kMaxPig picks), cells (any form: past
// ingest_staged_cells() the row stays in global memory), and the most
// origins of the register book (past them the wide book's instantiation
// runs).
extern "C" int ingest_limits(int* out) {
  out[0] = kMaxMsgsLong;
  out[1] = kMaxOriginsWide;
  out[2] = kMaxWordsDeep;
  out[3] = kMaxQueueDeep;
  out[4] = kMaxPigLong;
  out[5] = kMaxMsgs;
  out[6] = kMaxCells;
  out[7] = kMaxOrigins;
  return 0;
}

// the most cells of a row staged in shared memory (CH = 2 or 8); wider rows
// run the form that keeps the row in global memory (CH = 0)
extern "C" int ingest_staged_cells() { return kMaxStagedCells; }

// out: the most seen words and queue slots of the shallow forms (QH 1 and
// 2); past either the deep form (QH 4) runs
extern "C" int ingest_shallow_limits(int* out) {
  out[0] = kMaxWords;
  out[1] = kMaxQueue;
  return 0;
}

// out: the widest batch held in registers (KM 1 and 4) and the most picks
// of the emitting form with one pick a lane (KM = 1); past either the long
// form (KM = 0) runs
extern "C" int ingest_long_limits(int* out) {
  out[0] = kMaxMsgsWide;
  out[1] = kMaxPig;
  return 0;
}

template <typename CT, typename XT, bool EMIT, int KM, int QH, int CH, bool WO>
static void launch_rows(const IngestArgs* a, cudaStream_t s) {
  constexpr int rows = WO ? kRowsPerBlockWide : kRowsPerBlock;
  const int threads = 32 * rows;
  const dim3 grid((a->n + rows - 1) / rows);
  ingest_kernel<CT, XT, EMIT, KM, QH, CH, WO><<<grid, threads, 0, s>>>(*a);
}

// the queue's slots a lane (QH) and the cells a lane (CH) are template
// parameters, so that a queue of 32 slots carries no second half and a row
// of up to 64 cells keeps the smaller shared-memory row; the wide book (WO)
// is instantiated at 8 cells a lane, which holds any row up to 256, and
// both books at CH = 0 (the row in global memory) for any wider row. A
// window of more than 4 seen words or a queue of more than 64 slots runs
// the deep form (QH = 4, up to 8 words), whatever the other width is
template <typename CT, typename XT, bool EMIT, int KM, int CH, bool WO>
static void launch_queue(const IngestArgs* a, cudaStream_t s) {
  if constexpr (KM == 0) {
    // the long form is instantiated in the deep form alone
    launch_rows<CT, XT, EMIT, 0, kMaxQueueDeep / 32, CH, WO>(a, s);
  } else if (a->seen_words > kMaxWords || a->q_slots > kMaxQueue) {
    launch_rows<CT, XT, EMIT, KM, kMaxQueueDeep / 32, CH, WO>(a, s);
  } else if (a->q_slots <= 32) {
    launch_rows<CT, XT, EMIT, KM, 1, CH, WO>(a, s);
  } else {
    launch_rows<CT, XT, EMIT, KM, kMaxQueue / 32, CH, WO>(a, s);
  }
}

template <typename CT, typename XT, bool EMIT, int KM>
static void launch_cells(const IngestArgs* a, cudaStream_t s) {
  if (a->n_cells > kMaxStagedCells) {
    if (a->n_origins > kMaxOrigins) {
      launch_queue<CT, XT, EMIT, KM, 0, true>(a, s);
    } else {
      launch_queue<CT, XT, EMIT, KM, 0, false>(a, s);
    }
  } else if (a->n_origins > kMaxOrigins) {
    launch_queue<CT, XT, EMIT, KM, kMaxStagedCells / 32, true>(a, s);
  } else if (a->n_cells <= 64) {
    launch_queue<CT, XT, EMIT, KM, 2, false>(a, s);
  } else {
    launch_queue<CT, XT, EMIT, KM, kMaxStagedCells / 32, false>(a, s);
  }
}

template <typename CT, typename XT>
static void launch_form(const IngestArgs* a, int emit, cudaStream_t s) {
  if (emit) {
    if (a->m <= kMaxMsgs && a->pig_r <= kMaxPig) {
      launch_cells<CT, XT, true, kMaxMsgs / 32>(a, s);
    } else {
      launch_cells<CT, XT, true, 0>(a, s);
    }
  } else if (a->m <= kMaxMsgs) {
    launch_cells<CT, XT, false, kMaxMsgs / 32>(a, s);
  } else if (a->m <= kMaxMsgsWide) {
    launch_cells<CT, XT, false, kMaxMsgsWide / 32>(a, s);
  } else {
    // the long form's instantiation emits when pig_r > 0
    IngestArgs b = *a;
    b.pig_r = 0;
    launch_cells<CT, XT, true, 0>(&b, s);
  }
}

// cell_bytes / tx_bytes: the element sizes of the q_cell and q_tx planes;
// the valid pairs are (2, 1), (2, 2) and (4, 4). Returns a CUDA error code,
// or cudaErrorInvalidValue for any other pair or for widths past the limits.
extern "C" int ingest_launch(const IngestArgs* a, int cell_bytes, int tx_bytes,
                             int emit, void* stream) {
  if (a->m < 0 || a->m > kMaxMsgsLong || a->n_origins < 1 ||
      a->n_origins > kMaxOriginsWide || a->seen_words > kMaxWordsDeep ||
      a->q_slots > kMaxQueueDeep ||
      a->n_cells > kMaxCells || a->pig_r > kMaxPigLong) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a->n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cell_bytes == 2 && tx_bytes == 1) {
    launch_form<int16_t, int8_t>(a, emit, s);
  } else if (cell_bytes == 2 && tx_bytes == 2) {
    launch_form<int16_t, int16_t>(a, emit, s);
  } else if (cell_bytes == 4 && tx_bytes == 4) {
    launch_form<int32_t, int32_t>(a, emit, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ingest_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
