// Host stand-in for the CUDA pieces ytpu_torch/csrc/integrate.cu uses, so
// that g++ can compile the kernel source and run its logic on the CPU
// (tests/test_torch_integrate_emulated.py). It is an emulator, not a GPU:
//
//   * every CUDA thread is a std::thread; the CTAs of a launch run one
//     after another;
//   * warp collectives (__ballot_sync, __shfl_sync, __any_sync,
//     __reduce_max_sync, __syncwarp) meet at a per-warp barrier, and the
//     lanes of a warp run freely in between, so code that leans on lanes
//     running in lockstep without a __syncwarp fails here;
//   * mbarriers are counters under one mutex; a bulk copy is a memcpy that
//     completes its bytes on the barrier at once;
//   * integrate.cu's inline-PTX helpers (mbar_*, bulk_copy) are replaced by
//     the functions below when the test rewrites the source.
//
// A warp stuck at a collective is reported on stderr with the source line
// each thread last synchronized at.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <chrono>
#include <condition_variable>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(a, b)
#define __shared__ static
#define __align__(n)
#define __restrict__

struct ulonglong2 {
  unsigned long long x, y;
};
inline ulonglong2 make_ulonglong2(unsigned long long a, unsigned long long b) { return {a, b}; }
struct EmuIndex {
  int x;
};
inline thread_local EmuIndex blockIdx, threadIdx;
using std::max;
using std::min;

// ---- warps and CTAs ---------------------------------------------------------

struct EmuWarp {
  std::barrier<> bar{32};
  unsigned long long v[32];
};
struct EmuCta {
  std::barrier<> bar;
  std::vector<std::unique_ptr<EmuWarp>> warps;
  std::vector<unsigned char> smem;
  EmuCta(int threads, size_t smem_bytes) : bar(threads), smem(smem_bytes + 16) {
    for (int w = 0; w < threads / 32; ++w) warps.emplace_back(new EmuWarp);
  }
};
inline thread_local EmuCta* emu_cta;
inline int emu_line[1024];  // source line of each thread's last collective
inline EmuWarp& emu_warp() { return *emu_cta->warps[threadIdx.x / 32]; }
inline int emu_lane() { return threadIdx.x % 32; }

// every lane posts a value; returns all 32 once all have posted
template <class F>
inline auto emu_collective(unsigned long long mine, int line, F reduce) {
  emu_line[threadIdx.x] = line;
  EmuWarp& w = emu_warp();
  w.v[emu_lane()] = mine;
  w.bar.arrive_and_wait();
  auto r = reduce(w.v);
  w.bar.arrive_and_wait();
  return r;
}
inline unsigned emu_ballot(bool p, int line) {
  return emu_collective(p, line, [](const unsigned long long* v) {
    unsigned r = 0;
    for (int i = 0; i < 32; ++i) r |= (v[i] ? 1u : 0u) << i;
    return r;
  });
}
template <class T>
inline T emu_shfl(T x, int src, int line) {
  unsigned long long u = 0;
  std::memcpy(&u, &x, sizeof(T));
  u = emu_collective(u, line, [src](const unsigned long long* v) { return v[src]; });
  T r;
  std::memcpy(&r, &u, sizeof(T));
  return r;
}
inline int emu_reduce_max(int x, int line) {
  return emu_collective((unsigned long long)(long long)x, line, [](const unsigned long long* v) {
    long long r = (long long)v[0];
    for (int i = 1; i < 32; ++i) r = std::max(r, (long long)v[i]);
    return (int)r;
  });
}
inline void emu_syncwarp(int line) {
  emu_line[threadIdx.x] = line;
  emu_warp().bar.arrive_and_wait();
}
#define __ballot_sync(m, p) emu_ballot(p, __LINE__)
#define __shfl_sync(m, x, s) emu_shfl(x, s, __LINE__)
#define __any_sync(m, p) (emu_ballot(p, __LINE__) != 0)
#define __reduce_max_sync(m, x) emu_reduce_max(x, __LINE__)
#define __syncwarp() emu_syncwarp(__LINE__)
inline void __syncthreads() { emu_cta->bar.arrive_and_wait(); }

inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline int __ffsll(long long x) { return __builtin_ffsll(x); }
inline int __clzll(long long x) { return x ? __builtin_clzll((unsigned long long)x) : 64; }
inline long long clock64() { return 0; }

inline unsigned long long atomicCAS(unsigned long long* p, unsigned long long c, unsigned long long v) {
  __atomic_compare_exchange_n(p, &c, v, false, __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST);
  return c;
}
inline unsigned long long atomicOr(unsigned long long* p, unsigned long long v) {
  return __atomic_fetch_or(p, v, __ATOMIC_SEQ_CST);
}
inline int atomicMin(int* p, int v) {
  int o = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (v < o && !__atomic_compare_exchange_n(p, &o, v, false, __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST)) {
  }
  return o;
}
inline int atomicMax(int* p, int v) {
  int o = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (v > o && !__atomic_compare_exchange_n(p, &o, v, false, __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST)) {
  }
  return o;
}

// ---- mbarriers and bulk copies -----------------------------------------------

// the 8-byte barrier word holds an index into this table
struct EmuBar {
  int count, pending;
  long long tx, done;  // bytes outstanding, phases completed
};
inline std::mutex emu_bar_mu;
inline std::condition_variable emu_bar_cv;
inline std::vector<EmuBar> emu_bars;
inline EmuBar& emu_bar(uint64_t* b) { return emu_bars[*b]; }
inline void emu_bar_step(EmuBar& s) {
  if (s.pending == 0 && s.tx == 0) {
    s.done += 1;
    s.pending = s.count;
    emu_bar_cv.notify_all();
  }
}
inline void mbar_init(uint64_t* bar, int count) {
  std::lock_guard<std::mutex> g(emu_bar_mu);
  emu_bars.push_back(EmuBar{count, count, 0, 0});
  *bar = emu_bars.size() - 1;
}
inline void mbar_arrive(uint64_t* bar) {
  std::lock_guard<std::mutex> g(emu_bar_mu);
  EmuBar& s = emu_bar(bar);
  s.pending -= 1;
  emu_bar_step(s);
}
inline void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  std::lock_guard<std::mutex> g(emu_bar_mu);
  EmuBar& s = emu_bar(bar);
  s.tx += bytes;
  s.pending -= 1;
  emu_bar_step(s);
}
// wait until the phase of parity `parity` has completed
inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  emu_line[threadIdx.x] = -1;
  std::unique_lock<std::mutex> g(emu_bar_mu);
  emu_bar_cv.wait(g, [&] { return (uint32_t)(emu_bar(bar).done & 1) != parity; });
}
inline void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  if (((uintptr_t)dst | (uintptr_t)src | bytes) & 15) {
    std::fprintf(stderr, "bulk copy of %u bytes not 16-byte aligned\n", bytes);
    std::abort();
  }
  std::memcpy(dst, src, bytes);
  std::lock_guard<std::mutex> g(emu_bar_mu);
  EmuBar& s = emu_bar(bar);
  s.tx -= bytes;
  emu_bar_step(s);
}

// ---- the runtime ----------------------------------------------------------------

typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorMisalignedAddress = 716,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8
};
template <class F>
cudaError_t cudaFuncSetAttribute(F, int, int bytes) {
  return bytes > 232448 ? cudaErrorInvalidValue : cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated launch error"; }
inline size_t __cvta_generic_to_shared(const void* p) { return (size_t)p; }
inline unsigned char* emu_dyn_smem() {
  const uintptr_t p = (uintptr_t)emu_cta->smem.data();
  return (unsigned char*)((p + 15) & ~(uintptr_t)15);
}

inline void emu_launch(int grid, int threads, size_t smem, std::function<void()> body) {
  for (int b = 0; b < grid; ++b) {
    EmuCta cta(threads, smem);
    std::atomic<bool> finished{false};
    std::thread watch([&] {
      for (int i = 0; i < 600 && !finished; ++i) std::this_thread::sleep_for(std::chrono::milliseconds(50));
      if (finished) return;
      std::fprintf(stderr, "CTA %d stuck; last collective line per thread:", b);
      for (int t = 0; t < threads; ++t) std::fprintf(stderr, " %d:%d", t, emu_line[t]);
      std::fprintf(stderr, "\n");
    });
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([&, b, t] {
        blockIdx.x = b;
        threadIdx.x = t;
        emu_cta = &cta;
        body();
      });
    for (auto& th : ts) th.join();
    finished = true;
    watch.join();
  }
}
#define EMU_LAUNCH(grid, threads, smem, kernel, ...) \
  emu_launch(grid, threads, smem, [&] { kernel(__VA_ARGS__); })
