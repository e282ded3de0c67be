// A host stand-in for the parts of the CUDA runtime that the port's kernels
// use, so that a kernel's lane logic runs on the CPU in the tests
// (tests/test_torch_ingest_host.py, tests/test_torch_swim_host.py; built by
// host_build.py here). Each warp runs after the one before, its 32 lanes as
// fibers of one thread (ucontext): a lane runs until it reaches a collective
// (__shfl_sync, __ballot_sync, __match_any_sync, __reduce_*_sync,
// __syncwarp), posts its value there and yields; once every lane has posted,
// each in turn reads what the others posted, and they meet a second time
// before any runs on. The lanes run in rising order between two meetings and
// in falling order between the next two, so a lane that reads another's
// shared memory before a collective orders the two sees it both ways. A
// collective that the lanes of a warp reach from different source lines (a
// divergent collective, undefined on the card) aborts with both lines, as
// does a lane that returns while others wait at a collective, and a warp
// still running after a minute. One thread a warp, where a thread a lane
// met at a barrier slowed to a crawl when the tests ran beside others.
#pragma once
#include <ucontext.h>

#include <algorithm>
#include <chrono>
#include <condition_variable>
#include <climits>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t e) { return e ? "invalid value" : "no error"; }
using std::max;
using std::min;

struct HostWarp {
  uint64_t slot[32];
  int line[32];
  bool done[32];
  ucontext_t lane[32];
  ucontext_t sched;  // the warp's scheduler, where a lane yields to
};
inline thread_local dim3 threadIdx, blockIdx;
inline thread_local HostWarp* host_warp;
inline thread_local int host_lane;
inline thread_local int host_line;
inline thread_local const std::function<void()>* host_body;
inline std::mutex host_atomic_mu;

// a meeting of the warp's lanes: back to the scheduler until every lane is
// here (it restores this lane's threadIdx and host_lane before resuming)
inline void host_meet() { swapcontext(&host_warp->lane[host_lane], &host_warp->sched); }

// every lane posts a value, and all check that they came from one line
inline void host_post(uint64_t v) {
  host_warp->slot[host_lane] = v;
  host_warp->line[host_lane] = host_line;
  host_meet();
  const int mine = host_warp->line[host_lane];
  for (int i = 0; i < 32; ++i) {
    if (host_warp->line[i] != mine) {
      std::fprintf(stderr, "divergent collective: lane %d at line %d, lane %d at line %d\n",
                   host_lane, mine, i, host_warp->line[i]);
      std::abort();
    }
  }
}
inline void host_done() { host_meet(); }
template <class T>
inline uint64_t host_bits(T v) {
  uint64_t b = 0;
  std::memcpy(&b, &v, sizeof(T));
  return b;
}
inline int host_at(int line) {
  host_line = line;
  return 0;
}

template <class T>
inline T host_shfl(unsigned, T v, int src) {
  host_post(host_bits(v));
  const uint64_t got = host_warp->slot[src & 31];
  host_done();
  T out;
  std::memcpy(&out, &got, sizeof(T));
  return out;
}
inline unsigned host_ballot(unsigned, bool p) {
  host_post(p ? 1 : 0);
  unsigned m = 0;
  for (int i = 0; i < 32; ++i) m |= (host_warp->slot[i] ? 1u : 0u) << i;
  host_done();
  return m;
}
inline unsigned host_match_any(unsigned, unsigned long long key) {
  host_post(key);
  unsigned m = 0;
  for (int i = 0; i < 32; ++i) m |= (host_warp->slot[i] == key ? 1u : 0u) << i;
  host_done();
  return m;
}
inline int host_reduce_max(unsigned, int v) {
  host_post(host_bits<int64_t>(v));
  int64_t best = INT64_MIN;
  for (int i = 0; i < 32; ++i) best = std::max(best, static_cast<int64_t>(host_warp->slot[i]));
  host_done();
  return static_cast<int>(best);
}
inline int host_reduce_min(unsigned, int v) {
  host_post(host_bits<int64_t>(v));
  int64_t least = INT64_MAX;
  for (int i = 0; i < 32; ++i) least = std::min(least, static_cast<int64_t>(host_warp->slot[i]));
  host_done();
  return static_cast<int>(least);
}
inline unsigned host_reduce_or(unsigned, unsigned v) {
  host_post(v);
  unsigned m = 0;
  for (int i = 0; i < 32; ++i) m |= static_cast<unsigned>(host_warp->slot[i]);
  host_done();
  return m;
}
inline void host_syncwarp(unsigned = 0xFFFFFFFFu) {
  host_post(0);
  host_done();
}
#define __shfl_sync(...) (host_at(__LINE__), host_shfl(__VA_ARGS__))
#define __ballot_sync(...) (host_at(__LINE__), host_ballot(__VA_ARGS__))
#define __match_any_sync(...) (host_at(__LINE__), host_match_any(__VA_ARGS__))
#define __reduce_max_sync(...) (host_at(__LINE__), host_reduce_max(__VA_ARGS__))
#define __reduce_min_sync(...) (host_at(__LINE__), host_reduce_min(__VA_ARGS__))
#define __reduce_or_sync(...) (host_at(__LINE__), host_reduce_or(__VA_ARGS__))
#define __syncwarp(...) (host_at(__LINE__), host_syncwarp(__VA_ARGS__))

inline int __float_as_int(float f) {
  int i;
  std::memcpy(&i, &f, sizeof(i));
  return i;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs(static_cast<int>(x)); }
inline int atomicMax(int* p, int v) {
  std::lock_guard<std::mutex> g(host_atomic_mu);
  const int old = *p;
  *p = std::max(old, v);
  return old;
}
inline unsigned atomicOr(unsigned* p, unsigned v) {
  std::lock_guard<std::mutex> g(host_atomic_mu);
  const unsigned old = *p;
  *p = old | v;
  return old;
}

// a lane's fiber: the kernel, then back to the scheduler for good
inline void host_lane_main() {
  (*host_body)();
  host_warp->done[host_lane] = true;
}

// the launch: `kernel<<<grid, threads, 0, stream>>>(args)` is rewritten to
// `host_launch(kernel, grid, threads, args)` before the source is compiled.
// Warps run one after another (no __syncthreads here); a watchdog aborts a
// warp that has not finished within a minute.
template <class K, class A>
inline void host_launch(K kernel, dim3 grid, int threads, const A& args) {
  constexpr size_t kStack = size_t(1) << 19;
  std::unique_ptr<char[]> stacks(new char[32 * kStack]);
  const std::function<void()> body = [&] { kernel(args); };
  for (unsigned b = 0; b < grid.x; ++b) {
    for (int w = 0; w < threads / 32; ++w) {
      auto warp = std::make_unique<HostWarp>();
      std::mutex mu;
      std::condition_variable cv;
      bool finished = false;
      std::thread watchdog([&] {
        std::unique_lock<std::mutex> lock(mu);
        if (!cv.wait_for(lock, std::chrono::seconds(60), [&] { return finished; })) {
          std::fprintf(stderr, "block %u warp %d still running after a minute\n", b, w);
          std::abort();
        }
      });
      for (int l = 0; l < 32; ++l) {
        warp->done[l] = false;
        getcontext(&warp->lane[l]);
        warp->lane[l].uc_stack.ss_sp = stacks.get() + l * kStack;
        warp->lane[l].uc_stack.ss_size = kStack;
        warp->lane[l].uc_link = &warp->sched;
        makecontext(&warp->lane[l], host_lane_main, 0);
      }
      blockIdx = dim3(b);
      host_warp = warp.get();
      host_body = &body;
      for (int meeting = 0;; ++meeting) {
        for (int i = 0; i < 32; ++i) {
          const int l = (meeting & 1) ? 31 - i : i;
          if (warp->done[l]) continue;
          threadIdx = dim3(32 * w + l);
          host_lane = l;
          swapcontext(&warp->sched, &warp->lane[l]);
        }
        const int returned = static_cast<int>(std::count(warp->done, warp->done + 32, true));
        if (returned == 32) break;
        if (returned > 0) {
          const int waiting = static_cast<int>(std::find(warp->done, warp->done + 32, false) -
                                               warp->done);
          std::fprintf(stderr, "block %u warp %d: lane %d waits at a collective (line %d) "
                       "that %d lanes returned without reaching\n",
                       b, w, waiting, warp->line[waiting], returned);
          std::abort();
        }
      }
      {
        std::lock_guard<std::mutex> lock(mu);
        finished = true;
      }
      cv.notify_one();
      watchdog.join();
    }
  }
}
