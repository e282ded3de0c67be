// A host stand-in for the parts of the CUDA runtime that the port's kernels
// use, so that a kernel's lane logic runs on the CPU in the tests
// (tests/test_torch_ingest_host.py, tests/test_torch_swim_host.py; built by
// host_build.py here). Each warp runs after the one before,
// its 32 lanes at once as std::threads, and its collectives
// (__shfl_sync, __ballot_sync, __match_any_sync, __reduce_*_sync,
// __syncwarp) meet at a barrier of its 32 lanes. A collective that the lanes
// of a warp reach from different source lines (a divergent collective,
// undefined on the card) aborts with both lines, and a warp that waits
// longer than a minute aborts too.
#pragma once
#include <algorithm>
#include <barrier>
#include <chrono>
#include <condition_variable>
#include <climits>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
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
  std::barrier<> bar{32};
  uint64_t slot[32];
  int line[32];
};
inline thread_local dim3 threadIdx, blockIdx;
inline thread_local HostWarp* host_warp;
inline thread_local int host_lane;
inline thread_local int host_line;
inline std::mutex host_atomic_mu;

// every lane posts a value, and all check that they came from one line
inline void host_post(uint64_t v) {
  host_warp->slot[host_lane] = v;
  host_warp->line[host_lane] = host_line;
  host_warp->bar.arrive_and_wait();
  for (int i = 0; i < 32; ++i) {
    if (host_warp->line[i] != host_line) {
      std::fprintf(stderr, "divergent collective: lane %d at line %d, lane %d at line %d\n",
                   host_lane, host_line, i, host_warp->line[i]);
      std::abort();
    }
  }
}
inline void host_done() { host_warp->bar.arrive_and_wait(); }
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

// the launch: `kernel<<<grid, threads, 0, stream>>>(args)` is rewritten to
// `host_launch(kernel, grid, threads, args)` before the source is compiled.
// Warps run one after another (no __syncthreads here), so 32 threads at a
// time; a watchdog aborts a warp that has not finished within a minute.
template <class K, class A>
inline void host_launch(K kernel, dim3 grid, int threads, const A& args) {
  for (unsigned b = 0; b < grid.x; ++b) {
    for (int w = 0; w < threads / 32; ++w) {
      HostWarp warp;
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
      std::vector<std::thread> lanes;
      for (int l = 0; l < 32; ++l) {
        lanes.emplace_back([&, l] {
          blockIdx = dim3(b);
          threadIdx = dim3(32 * w + l);
          host_warp = &warp;
          host_lane = l;
          kernel(args);
        });
      }
      for (auto& x : lanes) x.join();
      {
        std::lock_guard<std::mutex> lock(mu);
        finished = true;
      }
      cv.notify_one();
      watchdog.join();
    }
  }
}
