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
// dtypes),
// the clock, and with EMIT the pre-drawn uniforms (Q float32) and the
// delivery count; it writes the same planes plus fresh/drift (and the payload
// with EMIT). The per-row work is a few thousand integer operations, orders
// of magnitude below the card's integer rate, so those bytes over 3.35 TB/s
// are the least time it could take.
//
// Design: one thread per node row, running the pallas body's steps in order
// with the row's messages, book and queue keys in per-thread arrays: HLC fold
// with the drift reject; seen check and in-batch dedupe; slot claim/evict;
// seen-bit OR, known_max and head advance (trailing ones, then a window shift
// with explicit branches for shift counts of 0 and 32 or more, which C leaves
// undefined); the LWW apply (each cell takes its batch winner under
// (clp, ver, val, site, dbv) unless the incumbent wins the four keys); the
// evict-min-q_tx enqueue (lowest column on ties); and with EMIT the budget
// mask (first column on ties) and the top pig_r uniforms (first index on
// ties). Received batches wider than the queue (m > Q) place their r-th
// recorded message in the r-th slot by ascending evict key and drop ranks
// >= Q, as alloc_slots_evict does: each taken slot is marked kIntMax and the
// loop stops placing once the smallest key left is kIntMax.
//
// The message capacity MAXM sizes the per-thread message arrays and is a
// template parameter: 32 for the scale round's batches (their stack stays at
// its size), 128 for the full view's recv_slots, non-emitting only. The
// launcher picks the narrowest instantiation that holds m; the in-batch
// dedupe and the batch-winner search are O(m^2) per row.
//
// Wrapping int32 arithmetic goes through uint32; `>>` on the signed
// stamp stays arithmetic as in JAX. The store and queue rows are copied to
// the outputs first and updated there, so each plane is read once and
// written once. q_cell (CT) and q_tx (XT) have types of their own, widened to
// int32 in registers and cast at the store: (int16, int8) under
// narrow_q_int8, (int16, int16) under narrow_dtypes, else (int32, int32).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxMsgs = 32;  // scale batches, and every emitting form
constexpr int kMaxMsgsWide = 128;  // the full view's recv_slots mailboxes
constexpr int kMaxOrigins = 32;
constexpr int kMaxWords = 4;
constexpr int kMaxQueue = 64;
constexpr int kMaxPig = 16;
constexpr int32_t kNoQ = -1;
constexpr int32_t kIntMin = INT32_MIN;
constexpr int32_t kIntMax = INT32_MAX;

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}

// does key tuple a win (>=) against b, lexicographically
__device__ __forceinline__ bool lex_wins4(const int32_t* a, const int32_t* b) {
  for (int k = 0; k < 4; ++k) {
    if (a[k] != b[k]) return a[k] > b[k];
  }
  return true;
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

template <typename CT, typename XT, bool EMIT, int MAXM>
__global__ void ingest_kernel(IngestArgs a) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= a.n) return;
  const int m = a.m, O = a.n_origins, W = a.seen_words, C = a.n_cells, Q = a.q_slots;
  const int32_t now = *a.now;

  // --- messages --------------------------------------------------------
  bool live[MAXM], fresh[MAXM], rec[MAXM];
  int32_t origin[MAXM], dbv[MAXM], ts[MAXM], slot[MAXM];
  const int64_t mb = r * m;
  for (int j = 0; j < m; ++j) {
    live[j] = a.live[mb + j] != 0;
    origin[j] = a.origin[mb + j];
    dbv[j] = a.dbv[mb + j];
    ts[j] = a.ts[mb + j];
  }

  // --- HLC fold with max-drift rejection --------------------------------
  int32_t folded = 0;
  int32_t drift = 0;
  const int32_t horizon = wrap_add(now, a.hlc_max_drift);
  for (int j = 0; j < m; ++j) {
    const bool ok = live[j] && (ts[j] >> a.hlc_round_bits) <= horizon;
    const int32_t v = ok ? ts[j] : 0;
    folded = j == 0 ? v : max(folded, v);
    if (live[j] && !ok) ++drift;
    live[j] = ok;
  }
  const int32_t hlc_in = a.hlc[r];
  a.o_hlc[r] = m > 0 ? max(hlc_in, folded) : hlc_in;
  a.o_drift[r] = drift;

  // --- book ----------------------------------------------------------------
  int32_t head[kMaxOrigins], km[kMaxOrigins], org_id[kMaxOrigins], org_last[kMaxOrigins];
  uint32_t seen[kMaxOrigins * kMaxWords];
  const int64_t ob = r * O;
  for (int o = 0; o < O; ++o) {
    head[o] = a.head[ob + o];
    km[o] = a.km[ob + o];
    org_id[o] = a.org_id[ob + o];
    org_last[o] = a.org_last[ob + o];
  }
  const int ow = O * W;
  for (int k = 0; k < ow; ++k) seen[k] = static_cast<uint32_t>(a.seen[r * ow + k]);

  // --- seen check + in-batch dedupe ---------------------------------------
  for (int j = 0; j < m; ++j) {
    slot[j] = origin[j] >= 0 ? origin[j] % O : 0;
    const bool owned_pre = origin[j] >= 0 && org_id[slot[j]] == origin[j];
    const int32_t h = head[slot[j]];
    const int32_t off = wrap_sub(wrap_sub(dbv[j], h), 1);
    const bool in_win = off >= 0 && off < 32 * W;
    const int widx = slot[j] * W + (off >= 0 ? (off >> 5) : 0);
    const uint32_t word = widx < ow ? seen[widx] : 0u;
    const int bit = (off < 0 ? 0 : off) & 31;
    const bool hit = ((word >> bit) & 1u) == 1u;
    const bool seen_b = live[j] && owned_pre && (dbv[j] <= h || (in_win && hit));
    bool dup = false;
    for (int k = 0; k < j; ++k) {
      dup = dup || (live[k] && origin[k] == origin[j] && dbv[k] == dbv[j]);
    }
    fresh[j] = live[j] && !seen_b && !dup;
  }

  // --- slot claim/evict (monotone in the actor id) -------------------------
  for (int c = 0; c < O; ++c) {
    const int32_t owner = org_id[c];
    bool any_f = false;
    int32_t new_owner = -1;
    for (int j = 0; j < m; ++j) {
      const bool cand = fresh[j] && slot[j] == c && origin[j] >= 0;
      if (cand && origin[j] > owner) {
        any_f = true;
        new_owner = max(new_owner, origin[j]);
      }
    }
    const bool evictable = owner < 0 || wrap_add(org_last[c], a.keep_rounds) < now;
    const bool take = any_f && evictable;
    const int32_t nid = take ? new_owner : owner;
    bool active = false;
    for (int j = 0; j < m; ++j) {
      active = active || (fresh[j] && slot[j] == c && origin[j] >= 0 && origin[j] == nid);
    }
    org_id[c] = nid;
    if (take || active) org_last[c] = now;
    if (take) {
      head[c] = 0;
      km[c] = 0;
      for (int w = 0; w < W; ++w) seen[c * W + w] = 0u;
    }
  }

  // --- record: seen-bit OR, known_max --------------------------------------
  for (int j = 0; j < m; ++j) {
    const bool owned = origin[j] >= 0 && org_id[slot[j]] == origin[j];
    rec[j] = fresh[j] && owned;
    const int32_t off = wrap_sub(wrap_sub(dbv[j], head[slot[j]]), 1);
    const bool in_win = off >= 0 && off < 32 * W;
    if (rec[j] && in_win) seen[slot[j] * W + (off >> 5)] |= 1u << (off & 31);
    if (live[j] && owned) km[slot[j]] = max(km[slot[j]], dbv[j]);
  }

  // --- head advance: trailing ones, then shift the window down ------------
  for (int o = 0; o < O; ++o) {
    uint32_t* win = seen + o * W;
    int32_t total = 0;
    bool carry = true;
    for (int w = 0; w < W; ++w) {
      const uint32_t x = win[w];
      const int32_t t = x == 0xFFFFFFFFu ? 32 : __popc(x ^ (x + 1u)) - 1;
      if (carry) total += t;
      carry = carry && t == 32;
    }
    head[o] = wrap_add(head[o], total);
    const int s_words = total >> 5;
    const int s_bits = total & 31;
    uint32_t shifted[kMaxWords];
    for (int w = 0; w < W; ++w) {
      const int lo_i = w + s_words;
      const int hi_i = lo_i + 1;
      const uint32_t lo = lo_i < W ? win[lo_i] : 0u;
      const uint32_t hi = hi_i < W ? win[hi_i] : 0u;
      shifted[w] = s_bits > 0 ? (lo >> s_bits) | (hi << (32 - s_bits)) : lo;
    }
    for (int w = 0; w < W; ++w) win[w] = shifted[w];
    km[o] = max(km[o], head[o]);
  }
  for (int o = 0; o < O; ++o) {
    a.o_head[ob + o] = head[o];
    a.o_km[ob + o] = km[o];
    a.o_org_id[ob + o] = org_id[o];
    a.o_org_last[ob + o] = org_last[o];
  }
  for (int k = 0; k < ow; ++k) a.o_seen[r * ow + k] = static_cast<int32_t>(seen[k]);
  for (int j = 0; j < m; ++j) a.o_fresh[mb + j] = fresh[j] ? 1 : 0;

  // --- LWW apply of fresh cells --------------------------------------------
  const int64_t cb = r * C;
  for (int s = 0; s < 5; ++s) {
    for (int c = 0; c < C; ++c) a.o_store[s][cb + c] = a.store[s][cb + c];
  }
  for (int j = 0; j < m; ++j) {
    const int32_t cj = a.cell[mb + j];
    if (!fresh[j] || cj < 0 || cj >= C) continue;
    // message j applies when it is its cell's batch winner under
    // (clp, ver, val, site, dbv), the first of identical winners
    const int32_t kj[5] = {a.clp[mb + j], a.ver[mb + j], a.val[mb + j],
                           a.site[mb + j], dbv[j]};
    bool best = true;
    for (int k = 0; k < m && best; ++k) {
      if (k == j || !fresh[k] || a.cell[mb + k] != cj) continue;
      const int32_t kk[5] = {a.clp[mb + k], a.ver[mb + k], a.val[mb + k],
                             a.site[mb + k], dbv[k]};
      int cmp = 0;
      for (int t = 0; t < 5 && cmp == 0; ++t) {
        cmp = kk[t] > kj[t] ? 1 : (kk[t] < kj[t] ? -1 : 0);
      }
      if (cmp > 0 || (cmp == 0 && k < j)) best = false;
    }
    if (!best) continue;
    const int32_t inc[4] = {a.o_store[4][cb + cj], a.o_store[0][cb + cj],
                            a.o_store[1][cb + cj], a.o_store[2][cb + cj]};
    if (lex_wins4(inc, kj)) continue;
    a.o_store[0][cb + cj] = kj[1];
    a.o_store[1][cb + cj] = kj[2];
    a.o_store[2][cb + cj] = kj[3];
    a.o_store[3][cb + cj] = kj[4];
    a.o_store[4][cb + cj] = kj[0];
  }

  // --- re-broadcast enqueue: evict the lowest remaining budget -------------
  const int64_t qb = r * Q;
  const CT* q_cell = static_cast<const CT*>(a.q_cell) + qb;
  const XT* q_tx = static_cast<const XT*>(a.q_tx) + qb;
  CT* o_q_cell = static_cast<CT*>(a.o_q_cell) + qb;
  XT* o_q_tx = static_cast<XT*>(a.o_q_tx) + qb;
  int32_t ekey[kMaxQueue];
  for (int q = 0; q < Q; ++q) {
    const int32_t qo = a.q_origin[qb + q];
    a.o_q_origin[qb + q] = qo;
    a.o_q_dbv[qb + q] = a.q_dbv[qb + q];
    o_q_cell[q] = q_cell[q];
    a.o_q_ver[qb + q] = a.q_ver[qb + q];
    a.o_q_val[qb + q] = a.q_val[qb + q];
    a.o_q_site[qb + q] = a.q_site[qb + q];
    a.o_q_clp[qb + q] = a.q_clp[qb + q];
    a.o_q_ts[qb + q] = a.q_ts[qb + q];
    o_q_tx[q] = q_tx[q];
    ekey[q] = qo == kNoQ ? kIntMin : static_cast<int32_t>(q_tx[q]);
  }
  for (int j = 0; j < m; ++j) {
    int32_t kmin = ekey[0];
    int s = 0;
    for (int q = 1; q < Q; ++q) {
      if (ekey[q] < kmin) {
        kmin = ekey[q];
        s = q;
      }
    }
    const bool enq = a.enqueue_all ? fresh[j] : rec[j];
    if (!enq || kmin >= kIntMax) continue;
    a.o_q_origin[qb + s] = origin[j];
    a.o_q_dbv[qb + s] = dbv[j];
    o_q_cell[s] = static_cast<CT>(a.cell[mb + j]);
    a.o_q_ver[qb + s] = a.ver[mb + j];
    a.o_q_val[qb + s] = a.val[mb + j];
    a.o_q_site[qb + s] = a.site[mb + j];
    a.o_q_clp[qb + s] = a.clp[mb + j];
    a.o_q_ts[qb + s] = ts[j];
    o_q_tx[s] = static_cast<XT>(a.budget[mb + j]);
    ekey[s] = kIntMax;
  }

  if constexpr (EMIT) {
    // --- piggyback payload selection from the updated queue ---------------
    const int R = a.pig_r;
    const int32_t carried = max(a.carried[r], 1);
    const int32_t allowed = max(a.budget_bytes / (a.wire_bytes * carried), 1);
    int32_t bkey[kMaxQueue];
    bool keep[kMaxQueue];
    for (int q = 0; q < Q; ++q) {
      const int32_t t = static_cast<int32_t>(o_q_tx[q]);
      const bool live_slot = a.o_q_origin[qb + q] != kNoQ && t > 0;
      bkey[q] = live_slot ? t : kIntMin;
      keep[q] = false;
    }
    int32_t cnt = 0;
    for (int it = 0; it < Q; ++it) {
      int32_t kmax = bkey[0];
      int s = 0;
      for (int q = 1; q < Q; ++q) {
        if (bkey[q] > kmax) {
          kmax = bkey[q];
          s = q;
        }
      }
      const bool sel = kmax > kIntMin && cnt < allowed;
      if (sel) {
        keep[s] = true;
        ++cnt;
      }
      bkey[s] = kIntMin;
    }
    float rk[kMaxQueue];
    for (int q = 0; q < Q; ++q) rk[q] = keep[q] ? a.rand[qb + q] : -1.0f;
    int sel_slot[kMaxPig];
    bool sel_ok[kMaxPig];
    for (int i = 0; i < R; ++i) {
      float rmax = rk[0];
      int s = 0;
      for (int q = 1; q < Q; ++q) {
        if (rk[q] > rmax) {
          rmax = rk[q];
          s = q;
        }
      }
      sel_slot[i] = s;
      sel_ok[i] = rmax >= 0.0f;
      rk[s] = -2.0f;
    }
    int32_t* pay = a.o_payload + r * 11 * R;
    for (int i = 0; i < R; ++i) {
      const int s = sel_slot[i];
      pay[0 * R + i] = a.o_q_origin[qb + s];
      pay[1 * R + i] = a.o_q_dbv[qb + s];
      pay[2 * R + i] = static_cast<int32_t>(o_q_cell[s]);
      pay[3 * R + i] = a.o_q_ver[qb + s];
      pay[4 * R + i] = a.o_q_val[qb + s];
      pay[5 * R + i] = a.o_q_site[qb + s];
      pay[6 * R + i] = a.o_q_clp[qb + s];
      pay[7 * R + i] = 0;  // q_seq: single-cell versions
      pay[8 * R + i] = 1;  // q_nseq
      pay[9 * R + i] = a.o_q_ts[qb + s];
      pay[10 * R + i] = sel_ok[i] ? 1 : 0;
      a.o_sel[r * R + i] = s;
      a.o_selok[r * R + i] = sel_ok[i] ? 1 : 0;
    }
  }
}

// out: the widest batch (m) of any form, origins, seen words, queue slots,
// payload entries, and the widest batch of the narrow (and every emitting)
// instantiation.
extern "C" int ingest_limits(int* out) {
  out[0] = kMaxMsgsWide;
  out[1] = kMaxOrigins;
  out[2] = kMaxWords;
  out[3] = kMaxQueue;
  out[4] = kMaxPig;
  out[5] = kMaxMsgs;
  return 0;
}

template <typename CT, typename XT>
static void launch_form(const IngestArgs* a, int emit, dim3 grid, int threads,
                        cudaStream_t s) {
  if (emit) {
    ingest_kernel<CT, XT, true, kMaxMsgs><<<grid, threads, 0, s>>>(*a);
  } else if (a->m <= kMaxMsgs) {
    ingest_kernel<CT, XT, false, kMaxMsgs><<<grid, threads, 0, s>>>(*a);
  } else {
    ingest_kernel<CT, XT, false, kMaxMsgsWide><<<grid, threads, 0, s>>>(*a);
  }
}

// cell_bytes / tx_bytes: the element sizes of the q_cell and q_tx planes;
// the valid pairs are (2, 1), (2, 2) and (4, 4). Returns a CUDA error code,
// or cudaErrorInvalidValue for any other pair or for a batch wider than the
// form's instantiation holds.
extern "C" int ingest_launch(const IngestArgs* a, int cell_bytes, int tx_bytes,
                             int emit, void* stream) {
  if (a->m < 0 || a->m > (emit ? kMaxMsgs : kMaxMsgsWide)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a->n == 0) return 0;
  const int threads = 128;
  const dim3 grid((a->n + threads - 1) / threads);
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
