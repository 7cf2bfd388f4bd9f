// Hand-written Hopper kernels for rungs 0-7 of the Mosaic fault-isolation
// ladder: each one isolates one construct the fused integrate kernel
// relies on (a plain pass, a one-hot put, a row mask, a carried reduction,
// the conflict-scan `while`, a nested loop, a guarded write, a big tile).
//
// Replaces: the Pallas TPU kernels `main.r0`-`r7` of
// benches/mosaic_ladder.py (pallas_call at :102, :118, :134, :152, :182,
// :201, :218, :232).
//
// What bounds them on this card: nothing but the launch. The ladder's
// shapes are [8, 256] i32 (8 KB) and, for rung 7, [25, 8, 2048] i32
// (1.6 MB); their bytes over 3.35 TB/s take 5 ns and 1 us, well under the
// microsecond or more a launch costs. The design therefore keeps every rung
// to one launch on PyTorch's current stream, with no host synchronization.
//
// Rungs 0 and 7, the elementwise maps, are one kernel, the map put: a
// thread loads its MAP_G 16-byte groups (non-coherent) into registers
// before its first store, then maps and stores them; the grid is sized to
// the element count and covers the tensor once, with no grid-stride loop.
// Since the launch is most of the time, the shape is what a sweep of G x
// threads at both rungs' shapes chose (PERF.md §6): one group a thread in
// CTAs of 256, so rung 0's 512 groups take 2 CTAs and rung 7's 102,400
// groups 400. Fewer, fuller CTAs lost: one CTA of rung 0 moves its 16 KB
// through one SM, and rung 7 in 100-200 CTAs saves less launch time than
// a thread's further groups cost. A grid-stride loop at the same grid
// cost 0.1-0.2 us (its trip count is a 64-bit division). A count that is
// not a multiple of 4, or a tensor that is not 16-byte aligned, takes the
// same kernel one int a group.
//
// Rungs 4 and 5 write one value per row (4) or per tile (5) that a thread
// can compute from at most 32 loads, so each is one pass that stores the
// tile in 16-byte groups with no barrier, no shared memory and no division
// per element (section "scan and nested sum" below: the closed forms and
// the grids). Rung 1 is a map put over row tiles, each thread loading its
// row's index beside its groups; rung 3 sums its head once per CTA, behind
// one barrier, then stores as rung 5 does (section "row put and carried
// sum"). Rungs 1 and 3-5 are also timed at the main path's width, [256,
// 65,536] (PERF.md §6), where the 67 MB tile bounds them: written once,
// 0.0200 ms (rungs 3-5), read and written, 0.0401 ms (rung 1).
//
// Rungs 2 and 6 take a grid sized to the output (one thread per element,
// at most 1,024 CTAs of 256 threads, grid-stride past that); rung 6
// recomputes its guard in every CTA rather than pay a second launch.
//
// Integer arithmetic wraps mod 2^32 as it does in XLA (done in unsigned).
//
// C interface: every rung is `int ytpu_ladder_rN(const int* x, int* o,
// int D, int C, cudaStream_t)` over a row-major [D, C] int32 tensor (the
// elementwise rungs 0 and 7 take any shape flattened to [D, C]); it
// returns the launch's cudaError_t.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libytpu_mosaic_ladder.so mosaic_ladder.cu
// tests/_emulated_ladder.py builds the map-put section, the scan and
// nested-sum section and the row put and carried-sum section, each alone
// with the shared helpers, with g++ against tests/cuda_host (a host
// emulator of CUDA).

#include <cstdint>
#include <cuda_runtime.h>

// ---- shared helpers ----------------------------------------------------------------

namespace {

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

// v in every int of a group T (int4, or int on the one-int path)
template <class T>
__device__ __forceinline__ T splat(int v);
template <>
__device__ __forceinline__ int splat<int>(int v) { return v; }
template <>
__device__ __forceinline__ int4 splat<int4>(int v) {
  int4 r;
  r.x = r.y = r.z = r.w = v;
  return r;
}

}  // namespace

// ---- end shared helpers ------------------------------------------------------------

// ---- map put (rungs 0 and 7) -------------------------------------------------------

namespace {

// 16-byte groups a thread loads before it stores, and the CTA size: the
// best of G in {1, 2, 4} x {32, ..., 512} threads at both rungs' shapes
// (PERF.md §6)
constexpr int MAP_G = 1;
constexpr int MAP_THREADS = 256;
constexpr long long MAP_PER_CTA = (long long)MAP_G * MAP_THREADS;  // groups a CTA maps

struct AddOne {
  __device__ int operator()(int v) const { return (int)((unsigned)v + 1u); }
};
struct Twice {
  __device__ int operator()(int v) const { return (int)((unsigned)v * 2u); }
};

template <class F>
__device__ __forceinline__ void apply(F f, int& v) { v = f(v); }
template <class F>
__device__ __forceinline__ void apply(F f, int4& v) {
  v.x = f(v.x);
  v.y = f(v.y);
  v.z = f(v.z);
  v.w = f(v.w);
}

// o[g] = f(x[g]) over `groups` groups T (int4, or int on the one-int
// path). CTA b maps groups [b * MAP_PER_CTA, +MAP_PER_CTA): a thread takes
// MAP_G of them, MAP_THREADS apart, loads them all, then maps and stores
// them. A group past the end loads the last group instead, so that no load
// waits on a branch and all of them issue before the first store (the
// predicated form let nvcc put a store between them, PERF.md §6).
template <class F, class T>
__global__ void __launch_bounds__(MAP_THREADS)
map_put(const T* __restrict__ x, T* __restrict__ o, long long groups) {
  F f;
  const long long g0 = (long long)blockIdx.x * MAP_PER_CTA + threadIdx.x;
  T v[MAP_G];
#pragma unroll
  for (int j = 0; j < MAP_G; ++j) {
    const long long g = g0 + (long long)j * MAP_THREADS;
    v[j] = __ldg(x + (g < groups ? g : groups - 1));
  }
#pragma unroll
  for (int j = 0; j < MAP_G; ++j) {
    const long long g = g0 + (long long)j * MAP_THREADS;
    if (g < groups) {
      apply(f, v[j]);
      o[g] = v[j];
    }
  }
}

template <class F>
int launch_map(const int* x, int* o, long long n, cudaStream_t st) {
  if (n <= 0) return 0;
  const bool v4 = n % 4 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)o % 16 == 0;
  const long long groups = v4 ? n / 4 : n;
  const long long blocks = (groups + MAP_PER_CTA - 1) / MAP_PER_CTA;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (v4) map_put<F, int4><<<(unsigned)blocks, MAP_THREADS, 0, st>>>((const int4*)x, (int4*)o, groups);
  else map_put<F, int><<<(unsigned)blocks, MAP_THREADS, 0, st>>>(x, o, groups);
  return (int)cudaGetLastError();
}

}  // namespace

// elementwise rungs: any shape, flattened to [D, C]
#define YTPU_MAP_RUNG(NAME, F)                                                 \
  extern "C" int NAME(const void* x, void* o, int D, int C, void* stream) {    \
    return launch_map<F>((const int*)x, (int*)o, (long long)D * C,             \
                         (cudaStream_t)stream);                                \
  }

YTPU_MAP_RUNG(ytpu_ladder_r0, AddOne)
YTPU_MAP_RUNG(ytpu_ladder_r7, Twice)

// ---- end map put -------------------------------------------------------------------

// ---- scan and nested sum (rungs 4 and 5) -----------------------------------------

// Both rungs write a value that a thread computes alone from the head of a
// row, so the Pallas loops become closed forms folded in registers:
//
//   rung 4, the conflict-scan `while`: row d steps o = 0, 1, ... while
//   o < 12 and it has not broken, adding x[d, o] and breaking once its sum
//   exceeds 40; the block-wide `any` condition only decides when every row
//   has stopped, so o[d, :] = S_k with S_j = x[d, 0] + ... + x[d, j], where
//     - the sum wraps mod 2^32 (taken in unsigned, as XLA's does),
//     - columns >= C add 0 (a row of C < 12 columns keeps S_{C-1}),
//     - k is the first j < 12 with (int32) S_j > 40 (a signed compare of
//       the wrapped sum), or 11 if there is none: a row that never breaks
//       sums 12 columns;
//   rung 5, fori(8) around fori(4): o = sum_{j < 32} x[0, j mod C], mod 2^32
//   (the index wraps mod C when C < 32).
//
// Rung 4: a 2-D grid, blockIdx.y the row and blockIdx.x a tile of the row's
// 16-byte groups, so that a CTA reads one row and no index is divided. Every
// thread issues the loads of x[d, 0:12] (three int4, or twelve ints on the
// one-int path; an index past the row is clamped to its last group or int
// and adds 0), folds the scan with its break in registers, then stores
// SCAN_G groups SCAN_THREADS apart (fewer threads when a row has fewer
// groups). Rung 5: a warp has lane j load x[0, j mod C] (the modulo only
// when C < 32), sums the 32 lanes with one __reduce_add_sync, then every
// thread stores SUM_G groups of the tile flattened, SUM_THREADS apart, as
// the map put does. A count of columns that is not a multiple of 4, or an
// input or output that is not 16-byte aligned, takes the same kernels one
// int a group. The G x threads of each are what a sweep at both shapes
// chose (PERF.md §6, the sweep of rungs 4 and 5).

namespace {

constexpr int R4_LIMIT = 12;       // scan while o < 12 ...
constexpr int R4_BREAK = 40;       // ... and break a row once its sum > 40
constexpr int R4_MAX_ROWS = 256;   // the rows a launch takes (the wrapper's limit)
constexpr int R5_TERMS = 32;       // fori(8) around fori(4): one warp's lanes

// 16-byte groups a thread stores, and the CTA size: the best of G in {1, 2,
// 4} x {64, ..., 512} threads at [8, 256] and [256, 65,536] (PERF.md §6):
// 2 x 128 was best for both at the wide shape, where rung 4 at G = 1
// lost 5-84 % (a thread pays the row's loads and fold for one store, and
// an empty launch of 16,384 CTAs alone takes 10.6 us on an H100 80GB HBM3
// at 700 W); at [8, 256] the shapes lay within 0.03 us (rung 4) and
// 0.12 us (rung 5) of each other
constexpr int SCAN_G = 2;
constexpr int SCAN_THREADS = 128;
constexpr int SUM_G = 2;
constexpr int SUM_THREADS = 128;

// x[d, 0:12] of the row at `row` (C columns) into v; an index past the row
// loads its last group (int4) or int instead, so that every load issues
// before the fold, and the fold masks it
__device__ __forceinline__ void load_head(const int* __restrict__ row, int C, int (&v)[R4_LIMIT], int4) {
  const int4* r = (const int4*)row;
  const int last = C / 4 - 1;
  int4 q[R4_LIMIT / 4];
#pragma unroll
  for (int j = 0; j < R4_LIMIT / 4; ++j) q[j] = __ldg(r + (j < last ? j : last));
#pragma unroll
  for (int j = 0; j < R4_LIMIT / 4; ++j) {
    v[4 * j] = q[j].x;
    v[4 * j + 1] = q[j].y;
    v[4 * j + 2] = q[j].z;
    v[4 * j + 3] = q[j].w;
  }
}
__device__ __forceinline__ void load_head(const int* __restrict__ row, int C, int (&v)[R4_LIMIT], int) {
#pragma unroll
  for (int j = 0; j < R4_LIMIT; ++j) v[j] = __ldg(row + (j < C ? j : C - 1));
}

// the scan of one row: S_k of the closed form above
__device__ __forceinline__ int scan_fold(const int (&v)[R4_LIMIT], int C) {
  unsigned s = 0;
  bool brk = false;
#pragma unroll
  for (int j = 0; j < R4_LIMIT; ++j) {
    const unsigned add = j < C ? (unsigned)v[j] : 0u;
    s = brk ? s : s + add;
    brk = brk || (int)s > R4_BREAK;
  }
  return (int)s;
}

// o[d, :] = the scan of row d, over groups T (int4, or int on the one-int
// path): CTA (bx, d) stores groups [bx * G * blockDim.x, +G * blockDim.x)
// of row d's `gpr`
template <class T, int G, int NT>
__global__ void __launch_bounds__(NT)
scan_put(const int* __restrict__ x, T* __restrict__ o, int C, int gpr) {
  const int d = blockIdx.y;
  int v[R4_LIMIT];
  load_head(x + (long long)d * C, C, v, T());
  const T val = splat<T>(scan_fold(v, C));
  T* row = o + (long long)d * gpr;
  const int g0 = blockIdx.x * G * blockDim.x + threadIdx.x;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int g = g0 + j * blockDim.x;
    if (g < gpr) row[g] = val;
  }
}

// o = full(sum_{j < 32} x[0, j mod C]) over `groups` groups T: lane j of
// every warp loads term j, one warp reduce sums them, then a thread stores
// its G groups NT apart
template <class T, int G, int NT>
__global__ void __launch_bounds__(NT)
sum_put(const int* __restrict__ x, T* __restrict__ o, int C, long long groups) {
  int j = threadIdx.x % R5_TERMS;
  if (C < R5_TERMS) j %= C;
  const T val = splat<T>((int)__reduce_add_sync(0xffffffffu, (unsigned)__ldg(x + j)));
  const long long g0 = (long long)blockIdx.x * G * NT + threadIdx.x;
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const long long g = g0 + (long long)k * NT;
    if (g < groups) o[g] = val;
  }
}

template <int G, int NT>
int launch_scan(const int* x, int* o, int D, int C, cudaStream_t st) {
  if (D <= 0 || C <= 0) return 0;
  if (D > R4_MAX_ROWS) return (int)cudaErrorInvalidValue;
  const bool v4 = C % 4 == 0 && aligned16(x) && aligned16(o);
  const int gpr = v4 ? C / 4 : C;
  // a row of fewer groups than a CTA's takes fewer threads (whole warps)
  const int per_thread = (gpr + G - 1) / G;
  const int threads = per_thread < NT ? (per_thread + 31) / 32 * 32 : NT;
  if ((long long)gpr + (long long)G * threads > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((gpr + G * threads - 1) / (G * threads)), (unsigned)D);
  if (v4) scan_put<int4, G, NT><<<grid, threads, 0, st>>>(x, (int4*)o, C, gpr);
  else scan_put<int, G, NT><<<grid, threads, 0, st>>>(x, o, C, gpr);
  return (int)cudaGetLastError();
}

template <int G, int NT>
int launch_sum(const int* x, int* o, int D, int C, cudaStream_t st) {
  const long long n = (long long)D * C;
  if (D <= 0 || C <= 0) return 0;
  const bool v4 = n % 4 == 0 && aligned16(o);
  const long long groups = v4 ? n / 4 : n;
  const long long blocks = (groups + (long long)G * NT - 1) / ((long long)G * NT);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (v4) sum_put<int4, G, NT><<<(unsigned)blocks, NT, 0, st>>>(x, (int4*)o, C, groups);
  else sum_put<int, G, NT><<<(unsigned)blocks, NT, 0, st>>>(x, o, C, groups);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ytpu_ladder_r4(const void* x, void* o, int D, int C, void* stream) {
  return launch_scan<SCAN_G, SCAN_THREADS>((const int*)x, (int*)o, D, C, (cudaStream_t)stream);
}

extern "C" int ytpu_ladder_r5(const void* x, void* o, int D, int C, void* stream) {
  return launch_sum<SUM_G, SUM_THREADS>((const int*)x, (int*)o, D, C, (cudaStream_t)stream);
}

// ---- end scan and nested sum -------------------------------------------------------

// ---- row put and carried sum (rungs 1 and 3) -----------------------------------------

// Rung 1, the one-hot put: o[d, c] = 7 if c == x[d, 0] else x[d, c]. A map
// put over row tiles, on rung 4's 2-D grid: blockIdx.y is a row and
// blockIdx.x a tile of the row's 16-byte groups, so no index is divided. A
// thread loads x[d, 0] (one address for the whole CTA) and its ROW_G groups
// (the row's last group in place of one past it, so that every load issues
// before the first store), puts 7 in the one int, of one group, whose
// column equals x[d, 0] (none when it lies outside [0, C)), and stores.
// No barrier, no shared memory, no division. gridDim.y stops at 65,535, so
// a CTA strides over rows y, y + gridDim.y, ... (one trip below that). A
// count of columns not a multiple of 4, or an input or output not 16-byte
// aligned, puts one int a group.
//
// Rung 3, the carried sum: o = full(S), S = sum_{d < D, i < 16} x[d, i]
// mod 2^32 (the JAX fori carries it column by column; under wrap-around
// the order does not matter). Each CTA sums the head once: its threads
// share the head's groups (at D = 256, four int4 a thread of 256), each
// warp reduces its share with one __reduce_add_sync, and the warps'
// partials meet in shared memory behind one barrier. Then every thread
// stores CARRY_G groups of the tile flattened, CARRY_THREADS apart, as
// rung 5's sum put does. The grid covers the tile once, so at the main
// path's width the 16 KB head is read from L2 by each of 8,192 CTAs; a
// grid sized to the card (k CTAs an SM storing in a loop) and a per-warp
// sum without the barrier both lost (PERF.md §6, the sweep of rungs 1 and
// 3).
// A count of columns not a multiple of 4, or an input not 16-byte aligned,
// reads the head one int a group; a tile of a count not a multiple of 4,
// or an output not 16-byte aligned, stores one int a group.
//
// The G x threads of each are what a sweep at [8, 256] and [256, 65,536]
// chose (PERF.md §6, the sweep of rungs 1 and 3).

namespace {

constexpr int R1_PUT = 7;          // rung 1's value at column x[d, 0]
constexpr int R3_COLS = 16;        // rung 3 sums the first 16 columns of every row
constexpr int MAX_GRID_Y = 65535;  // the card's limit on gridDim.y

// rung 1: groups a thread puts, and the CTA size; rung 3: groups a
// thread stores, and the CTA size
constexpr int ROW_G = 1;
constexpr int ROW_THREADS = 256;
constexpr int CARRY_G = 2;
constexpr int CARRY_THREADS = 256;

// rung 1: 7 at column idx of a group whose first column is c0
__device__ __forceinline__ void put_at(int4& v, int c0, int idx) {
  v.x = c0 == idx ? R1_PUT : v.x;
  v.y = c0 + 1 == idx ? R1_PUT : v.y;
  v.z = c0 + 2 == idx ? R1_PUT : v.z;
  v.w = c0 + 3 == idx ? R1_PUT : v.w;
}
__device__ __forceinline__ void put_at(int& v, int c0, int idx) { v = c0 == idx ? R1_PUT : v; }

// rung 1 over groups T (int4, or int on the one-int path), `gpr` a row:
// CTA (bx, y) puts groups [bx * G * blockDim.x, +G * blockDim.x) of rows
// y, y + gridDim.y, ...
template <class T, int G, int NT>
__global__ void __launch_bounds__(NT)
row_put(const T* __restrict__ x, T* __restrict__ o, unsigned D, int gpr) {
  const int g0 = blockIdx.x * G * blockDim.x + threadIdx.x;
#pragma unroll 1
  for (unsigned d = blockIdx.y; d < D; d += gridDim.y) {
    const long long base = (long long)d * gpr;
    const int idx = __ldg((const int*)(x + base));
    T v[G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int g = g0 + j * blockDim.x;
      v[j] = __ldg(x + base + (g < gpr ? g : gpr - 1));
    }
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int g = g0 + j * blockDim.x;
      if (g < gpr) {
        put_at(v[j], g * (int)(sizeof(T) / sizeof(int)), idx);
        o[base + g] = v[j];
      }
    }
  }
}

// rung 3: the ints of head group j, added in unsigned: x[j / 4, 4 (j % 4)
// : +4] (int4), or x[j / 16, j % 16] (int)
__device__ __forceinline__ unsigned head_group(const int* __restrict__ x, int C, int j, int4) {
  const int4 q = __ldg((const int4*)(x + (long long)(j >> 2) * C) + (j & 3));
  return (unsigned)q.x + (unsigned)q.y + (unsigned)q.z + (unsigned)q.w;
}
__device__ __forceinline__ unsigned head_group(const int* __restrict__ x, int C, int j, int) {
  return (unsigned)__ldg(x + (long long)(j >> 4) * C + (j & 15));
}

// head groups first, first + step, ... below n, summed
template <class TI>
__device__ __forceinline__ unsigned head_sum(const int* __restrict__ x, int C, int n, int first, int step) {
  unsigned s = 0;
#pragma unroll 4
  for (int j = first; j < n; j += step) s += head_group(x, C, j, TI());
  return s;
}

// o = full(S) over `groups` groups T (int4, or int); the head in n groups
// TI: the CTA sums the head, then thread t of CTA b stores groups b * G *
// NT + t, + NT, ..., G of them
template <class TI, class T, int G, int NT>
__global__ void __launch_bounds__(NT)
carry_put(const int* __restrict__ x, T* __restrict__ o, int C, int n, long long groups) {
  __shared__ unsigned part[NT / 32];
  const unsigned s = __reduce_add_sync(0xffffffffu, head_sum<TI>(x, C, n, threadIdx.x, NT));
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = s;
  __syncthreads();
  unsigned total = 0;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) total += part[w];
  const T val = splat<T>((int)total);
  const long long g0 = (long long)blockIdx.x * G * NT + threadIdx.x;
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const long long g = g0 + (long long)k * NT;
    if (g < groups) o[g] = val;
  }
}

// max_y: the rows one grid covers (the card's 65,535; the host tests pass
// fewer, so that CTAs stride over rows)
template <int G, int NT>
int launch_row_put(const int* x, int* o, int D, int C, int max_y, cudaStream_t st) {
  if (D <= 0 || C <= 0) return 0;
  const bool v4 = C % 4 == 0 && aligned16(x) && aligned16(o);
  const int gpr = v4 ? C / 4 : C;
  // a row of fewer groups than a CTA's takes fewer threads (whole warps)
  const long long per_thread = ((long long)gpr + G - 1) / G;
  const int threads = per_thread < NT ? (int)(per_thread + 31) / 32 * 32 : NT;
  const long long tile = (long long)G * threads;
  if (gpr + tile > 0x7fffffffLL || max_y <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((gpr + tile - 1) / tile), (unsigned)(D < max_y ? D : max_y));
  if (v4) row_put<int4, G, NT><<<grid, threads, 0, st>>>((const int4*)x, (int4*)o, D, gpr);
  else row_put<int, G, NT><<<grid, threads, 0, st>>>(x, o, D, gpr);
  return (int)cudaGetLastError();
}

template <class TI, int G, int NT>
int launch_carry_in(const int* x, int* o, bool v4, int C, int n, long long groups, cudaStream_t st) {
  const long long blocks = (groups + (long long)G * NT - 1) / ((long long)G * NT);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (v4) carry_put<TI, int4, G, NT><<<(unsigned)blocks, NT, 0, st>>>(x, (int4*)o, C, n, groups);
  else carry_put<TI, int, G, NT><<<(unsigned)blocks, NT, 0, st>>>(x, o, C, n, groups);
  return (int)cudaGetLastError();
}

template <int G, int NT>
int launch_carry(const int* x, int* o, int D, int C, cudaStream_t st) {
  if (D <= 0 || C <= 0) return 0;
  if (C < R3_COLS || (long long)D * R3_COLS > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long ints = (long long)D * C;
  const bool vo = ints % 4 == 0 && aligned16(o);
  const long long groups = vo ? ints / 4 : ints;
  if (C % 4 == 0 && aligned16(x)) {
    return launch_carry_in<int4, G, NT>(x, o, vo, C, D * (R3_COLS / 4), groups, st);
  }
  return launch_carry_in<int, G, NT>(x, o, vo, C, D * R3_COLS, groups, st);
}

}  // namespace

extern "C" int ytpu_ladder_r1(const void* x, void* o, int D, int C, void* stream) {
  return launch_row_put<ROW_G, ROW_THREADS>((const int*)x, (int*)o, D, C, MAX_GRID_Y,
                                            (cudaStream_t)stream);
}

extern "C" int ytpu_ladder_r3(const void* x, void* o, int D, int C, void* stream) {
  return launch_carry<CARRY_G, CARRY_THREADS>((const int*)x, (int*)o, D, C, (cudaStream_t)stream);
}

// ---- end row put and carried sum ---------------------------------------------------

namespace {

constexpr int THREADS = 256;
constexpr int MAX_CTAS = 1024;
constexpr int R6_GUARD = 100;  // rung 6: write x + 1 if any x[:, 0] > 100

int grid_for(long long n) {
  long long b = (n + THREADS - 1) / THREADS;
  return b < 1 ? 1 : (b > MAX_CTAS ? MAX_CTAS : (int)b);
}

__device__ __forceinline__ long long first_index() {
  return (long long)blockIdx.x * blockDim.x + threadIdx.x;
}
__device__ __forceinline__ long long grid_stride() {
  return (long long)gridDim.x * blockDim.x;
}

// --- rung 2: a per-row mask -------------------------------------------------

// o[d, :] = x[d, :] if x[d, 0] > 2 else -x[d, :]
__global__ void __launch_bounds__(THREADS)
mrow_mask(const int* __restrict__ x, int* __restrict__ o, int D, int C) {
  const long long n = (long long)D * C;
  for (long long i = first_index(); i < n; i += grid_stride()) {
    const long long d = i / C;
    const int v = x[i];
    o[i] = x[d * C] > 2 ? v : (int)(0u - (unsigned)v);
  }
}

// --- rung 6: one flag per tile, then a tile write ----------------------------

// o = x, then x + 1 where any(x[:, 0] > 100) (a block-wide guard)
__global__ void __launch_bounds__(THREADS)
guarded_write(const int* __restrict__ x, int* __restrict__ o, int D, int C) {
  int hit = 0;
  for (int d = threadIdx.x; d < D; d += blockDim.x) hit |= x[(long long)d * C] > R6_GUARD;
  const unsigned add = __syncthreads_or(hit) ? 1u : 0u;
  const long long n = (long long)D * C;
  for (long long i = first_index(); i < n; i += grid_stride()) o[i] = (int)((unsigned)x[i] + add);
}

}  // namespace

// row rungs: one thread per output element of the [D, C] tile
#define YTPU_ROW_RUNG(NAME, KERNEL, MAX_D)                                     \
  extern "C" int NAME(const void* x, void* o, int D, int C, void* stream) {    \
    const long long n = (long long)D * C;                                      \
    if (n <= 0) return 0;                                                      \
    if (D > (MAX_D)) return (int)cudaErrorInvalidValue;                        \
    KERNEL<<<grid_for(n), THREADS, 0, (cudaStream_t)stream>>>(                 \
        (const int*)x, (int*)o, D, C);                                         \
    return (int)cudaGetLastError();                                            \
  }

YTPU_ROW_RUNG(ytpu_ladder_r2, mrow_mask, 0x7fffffff)
YTPU_ROW_RUNG(ytpu_ladder_r6, guarded_write, 0x7fffffff)

extern "C" const char* ytpu_ladder_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
