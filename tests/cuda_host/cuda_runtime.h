// Host stand-in for the CUDA pieces ytpu_torch/csrc/integrate.cu, decode.cu, the
// column put and the multi call of ytpu_torch/csrc/plane_rmw.cu and the
// map put, the scan and nested sum and the row put and carried sum of
// ytpu_torch/csrc/mosaic_ladder.cu use, so that g++ can compile
// the kernel source and run its logic on the CPU
// (tests/test_torch_integrate_emulated.py, tests/test_torch_decode_emulated.py,
// tests/test_torch_plane_rmw_emulated.py, tests/test_torch_ladder_emulated.py).
// It is an emulator, not a GPU:
//
//   * every warp is a std::thread and each of its lanes a fiber (a
//     ucontext of its own stack) on that thread; the CTAs of a launch (a
//     1-D or 2-D grid) run one after another;
//   * warp collectives (__ballot_sync, __shfl_sync, __any_sync,
//     __reduce_max_sync, __reduce_or_sync, __reduce_add_sync,
//     __match_any_sync, __syncwarp) are where a lane yields to the next:
//     every lane of the warp must reach them (__reduce_or_sync reduces
//     over the lanes of each lane's own mask), and in between each lane
//     runs alone, up to its next collective, before the next lane starts,
//     so code that leans on lanes running in lockstep without a
//     __syncwarp fails here. A lane never waits for another lane of its
//     warp outside a collective (a lane blocked on an mbarrier blocks its
//     warp's thread until another warp completes the phase);
//   * __syncthreads meets the warp's lanes first, then the CTA's warps;
//   * mbarriers are counters under one mutex; a bulk copy is a memcpy that
//     completes its bytes on the barrier at once;
//   * integrate.cu's inline-PTX helpers (mbar_*, bulk_copy) are replaced by
//     the functions below when the test rewrites the source.
//
// A CTA that has not finished after 30 s is reported on stderr with the
// source line each thread last synchronized at.
//
// Lanes are fibers, not threads, so a collective costs context switches
// inside one process rather than a wake-up of every lane by the kernel's
// scheduler: on a loaded machine a thread-per-lane emulator waits for the
// OS to schedule 32 sleeping threads at every collective, and ran a few
// hundred times slower than alone.
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
#include <ucontext.h>
#include <vector>

#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n)
#define __restrict__

struct ulonglong2 {
  unsigned long long x, y;
};
inline ulonglong2 make_ulonglong2(unsigned long long a, unsigned long long b) { return {a, b}; }
struct EmuIndex {
  int x, y;
};
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
inline thread_local EmuIndex blockIdx, threadIdx, gridDim, blockDim;
struct int4 {
  int x, y, z, w;
};
template <class T>
inline T __ldg(const T* p) {
  return *p;
}
// a load the atomics of other threads race with: one 8-byte word at a time
inline ulonglong2 __ldcg(const ulonglong2* p) {
  return {__atomic_load_n(&p->x, __ATOMIC_RELAXED), __atomic_load_n(&p->y, __ATOMIC_RELAXED)};
}
using std::max;
using std::min;

// ---- warps and CTAs ---------------------------------------------------------

constexpr size_t EMU_LANE_STACK = size_t(1) << 18;

// one warp: its lanes' fibers and the collective in progress. Two value
// buffers alternate: the lane that completes a collective runs on to the
// next one, and writes the other buffer while its lanes still read this one
struct EmuWarp {
  int lanes = 32;
  unsigned long long v[2][32];
  int parity = 0, arrived = 0;
  unsigned long long gen = 0;  // collectives completed
  int cur = 0;                 // the running lane
  ucontext_t sched;
  ucontext_t ctx[32];
  bool done[32];
  std::unique_ptr<char[]> stacks;
};
struct EmuCta {
  std::barrier<> bar;  // one arrival a warp
  std::vector<std::unique_ptr<EmuWarp>> warps;
  std::vector<unsigned char> smem;
  EmuCta(int threads, size_t smem_bytes) : bar((threads + 31) / 32), smem(smem_bytes + 16) {
    for (int w = 0; w * 32 < threads; ++w) {
      warps.emplace_back(new EmuWarp);
      warps.back()->lanes = std::min(32, threads - 32 * w);
    }
  }
};
inline thread_local EmuCta* emu_cta;
inline thread_local EmuWarp* emu_cur_warp;
inline int emu_line[1024];  // source line of each thread's last collective
inline EmuWarp& emu_warp() { return *emu_cur_warp; }
inline int emu_lane() { return threadIdx.x % 32; }

// the running lane hands its warp's thread back to the warp's scheduler
inline void emu_yield() {
  EmuWarp& w = emu_warp();
  swapcontext(&w.ctx[w.cur], &w.sched);
}

// every lane posts a value and gets the warp's once all have posted
template <class F>
inline auto emu_collective(unsigned long long mine, int line, F reduce) {
  emu_line[threadIdx.x] = line;
  EmuWarp& w = emu_warp();
  const int p = w.parity;
  w.v[p][emu_lane()] = mine;
  if (++w.arrived == w.lanes) {
    w.arrived = 0;
    w.parity ^= 1;
    ++w.gen;
  } else {
    const unsigned long long g = w.gen;
    while (w.gen == g) emu_yield();
  }
  return reduce(w.v[p]);
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
// over the lanes of `mask` (each lane passes the mask of its own group)
inline unsigned emu_reduce_or(unsigned mask, unsigned x, int line) {
  return emu_collective(x, line, [mask](const unsigned long long* v) {
    unsigned r = 0;
    for (int i = 0; i < 32; ++i)
      if ((mask >> i) & 1u) r |= (unsigned)v[i];
    return r;
  });
}
// the lanes whose value equals this lane's
inline unsigned emu_match_any(unsigned long long x, int line) {
  return emu_collective(x, line, [x](const unsigned long long* v) {
    unsigned r = 0;
    for (int i = 0; i < 32; ++i) r |= (v[i] == x ? 1u : 0u) << i;
    return r;
  });
}
inline unsigned emu_reduce_add(unsigned x, int line) {
  return emu_collective(x, line, [](const unsigned long long* v) {
    unsigned r = 0;
    for (int i = 0; i < 32; ++i) r += (unsigned)v[i];
    return r;
  });
}
inline void emu_syncwarp(int line) {
  emu_collective(0, line, [](const unsigned long long*) { return 0; });
}
#define __ballot_sync(m, p) emu_ballot(p, __LINE__)
#define __shfl_sync(m, x, s) emu_shfl(x, s, __LINE__)
#define __any_sync(m, p) (emu_ballot(p, __LINE__) != 0)
#define __reduce_max_sync(m, x) emu_reduce_max(x, __LINE__)
#define __reduce_or_sync(m, x) emu_reduce_or(m, x, __LINE__)
#define __match_any_sync(m, x) emu_match_any(x, __LINE__)
#define __reduce_add_sync(m, x) emu_reduce_add(x, __LINE__)
#define __syncwarp() emu_syncwarp(__LINE__)
// the warp's lanes meet, lane 0 meets the other warps, the lanes meet again
inline void __syncthreads() {
  emu_syncwarp(-2);
  if (emu_lane() == 0) emu_cta->bar.arrive_and_wait();
  emu_syncwarp(-2);
}

inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline int __ffsll(long long x) { return __builtin_ffsll(x); }
inline int __clzll(long long x) { return x ? __builtin_clzll((unsigned long long)x) : 64; }
inline int __popcll(unsigned long long x) { return __builtin_popcountll(x); }
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
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
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

inline thread_local const std::function<void()>* emu_body;

inline void emu_lane_main() {
  (*emu_body)();
  emu_warp().done[emu_lane()] = true;
}  // returns to the scheduler through uc_link

// one warp's thread: start each lane's fiber, then resume the live lanes
// in turn until every lane has returned
inline void emu_run_warp(EmuWarp& w, int warp) {
  emu_cur_warp = &w;
  w.stacks.reset(new char[EMU_LANE_STACK * w.lanes]);
  for (int l = 0; l < w.lanes; ++l) {
    w.done[l] = false;
    getcontext(&w.ctx[l]);
    w.ctx[l].uc_stack.ss_sp = w.stacks.get() + EMU_LANE_STACK * l;
    w.ctx[l].uc_stack.ss_size = EMU_LANE_STACK;
    w.ctx[l].uc_link = &w.sched;
    makecontext(&w.ctx[l], emu_lane_main, 0);
  }
  for (int live = w.lanes; live > 0;) {
    for (int l = 0; l < w.lanes; ++l) {
      if (w.done[l]) continue;
      w.cur = l;
      threadIdx.x = 32 * warp + l;
      swapcontext(&w.sched, &w.ctx[l]);
      if (w.done[l]) --live;
    }
  }
}

inline void emu_launch(dim3 grid, int threads, size_t smem, std::function<void()> body) {
  for (int b = 0; b < (int)(grid.x * grid.y); ++b) {
    EmuCta cta(threads, smem);
    std::mutex watch_mu;
    std::condition_variable watch_cv;
    bool finished = false;
    std::thread watch([&] {
      std::unique_lock<std::mutex> g(watch_mu);
      if (watch_cv.wait_for(g, std::chrono::seconds(30), [&] { return finished; })) return;
      std::fprintf(stderr, "CTA %d stuck; last collective line per thread:", b);
      for (int t = 0; t < threads; ++t) std::fprintf(stderr, " %d:%d", t, emu_line[t]);
      std::fprintf(stderr, "\n");
    });
    std::vector<std::thread> ts;
    for (int w = 0; w < (int)cta.warps.size(); ++w)
      ts.emplace_back([&, b, w] {
        blockIdx.x = b % grid.x;
        blockIdx.y = b / grid.x;
        gridDim.x = grid.x;
        gridDim.y = grid.y;
        blockDim.x = threads;
        emu_cta = &cta;
        emu_body = &body;
        emu_run_warp(*cta.warps[w], w);
      });
    for (auto& th : ts) th.join();
    {
      std::lock_guard<std::mutex> g(watch_mu);
      finished = true;
    }
    watch_cv.notify_all();
    watch.join();
  }
}
#define EMU_LAUNCH(grid, threads, smem, kernel, ...) \
  emu_launch(grid, threads, smem, [&] { kernel(__VA_ARGS__); })
