// Hand-written Hopper kernels for the plane read-modify-write repros: the
// in-place update of one plane of the packed [NC, D, C] int32 state that
// the integrate kernel also does, cut down to the constructs the TPU
// repros isolated (a masked write of one plane, of every plane, of a lane
// slice of the flat [D, NC * C] layout, a passthrough under a raised
// scratch limit, and the five-operand aliased call of the integrate
// kernel whose cols operand is never written).
//
// Replaces: the Pallas TPU kernels of benches/plane_rmw_repro.py (case a
// at :58, case a2 at :127), benches/plane_rmw_repro2.py (`g3d` at :78,
// `g2d` at :113) and benches/plane_rmw_repro3.py (`v_vmem` at :90,
// `multi_call` with its two bodies `v_multi` / `v_body` at :112).
//
// `input_output_aliases` becomes a launch whose output pointer is the
// input's (in place); without aliasing the launch writes a separate
// output. The wrappers refuse an output that overlaps its input without
// being it.
//
// Cases a, a2, g3d, g2d and v_vmem are one kernel, the column put.
// Neither the Pallas doc block nor the layout is part of their function:
// flat element i of the n ints gets `fill` exactly when it lies in the
// patch range [lo, hi) and i mod C == idx (0 <= idx < C), and keeps x[i]
// otherwise. g3d and g2d patch every plane ([0, n); in g2d's [D, NC * C]
// a plane is a lane slice, so a row is still C ints); cases a and a2
// patch one plane ([plane * D * C, +D * C)); v_vmem patches nothing (idx
// -1). In place only that column can change, so the in-place call writes
// the column's ints and reads nothing (at idx -1 its threads return at
// once; the launch still happens). Out of place it is a streaming copy
// bound by the card's memory rate (each element read once and written
// once: 3.49 GB for the main path's [26, 256, 65,536] state, 1.04 ms at
// 3.35 TB/s): each thread issues the non-coherent loads of G 16-byte
// groups before any store and patches the column in registers (one 32-bit
// mod C a group inside the range); the grid covers the state once. A row
// whose width is not a multiple of 4, or a tensor not 16-byte aligned,
// takes the same loop one int at a time. At the repros' [26, 8, 512] (426
// KB) every call is launch latency.
//
// `v_vmem` raised the TPU's scratch limit (vmem_limit_bytes = 64 MB) around
// a passthrough. Its function is the flat copy of n ints, so its
// counterpart is the column put at idx -1. A ring of TMA bulk copies
// through shared memory was measured for it and lost at both shapes
// (PERF.md).
//
// The other kernels are bound by the launch too: their state is [26, 8,
// 512] i32 (426 KB), read once and written once in 0.25 us at 3.35 TB/s,
// far under a launch. They keep one launch per call, a grid of about a
// hundred CTAs (one CTA per SM's worth of work, so the call costs one
// memory round trip) and one 16-byte group per thread where the rows
// allow it.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libytpu_plane_rmw.so plane_rmw.cu
// tests/_emulated_plane_rmw.py builds the column-put section alone with
// g++ against tests/cuda_host (a host emulator of CUDA).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

// ---- column put (a, a2, g3d, g2d, v_vmem) ----------------------------------------

namespace {

// V consecutive ints moved as one load and one store
template <int V>
struct Group;
template <>
struct Group<4> {
  int4 v;
  __device__ void load_nc(const int* __restrict__ p) { v = __ldg(reinterpret_cast<const int4*>(p)); }
  __device__ void store(int* p) const { *reinterpret_cast<int4*>(p) = v; }
  __device__ void set(unsigned k, int val) {
    if (k == 0) v.x = val;
    else if (k == 1) v.y = val;
    else if (k == 2) v.z = val;
    else v.w = val;
  }
};
template <>
struct Group<1> {
  int v;
  __device__ void load_nc(const int* __restrict__ p) { v = __ldg(p); }
  __device__ void store(int* p) const { *p = v; }
  __device__ void set(unsigned, int val) { v = val; }
};

bool vec4(const void* a, const void* b, long long C) {
  return C % 4 == 0 && (uintptr_t)a % 16 == 0 && (uintptr_t)b % 16 == 0;
}

// i mod C, in 32 bits where the index fits in them
__device__ inline int column_of(int i, int C) { return (int)((unsigned)i % (unsigned)C); }
__device__ inline int column_of(long long i, int C) { return (int)(i % C); }

// 16-byte groups a thread loads before it stores, and the CTA size: the
// best of G in {2, 4, 8} x {128, 256} threads at both the repros' and the
// main path's shape (PERF.md)
constexpr int COL_G = 2;
constexpr int COL_THREADS = 256;
constexpr long long COL_PER_CTA = (long long)COL_G * COL_THREADS;  // groups a CTA moves

// in place: x[k * C + idx] = fill for every row k < rows; reads nothing
__global__ void __launch_bounds__(COL_THREADS)
column_fill(int* x, long long rows, int C, int idx, int fill) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k < rows) x[k * C + idx] = fill;
}

// out of place: o[i] = (lo <= i < lo + span and i mod C == idx) ? fill :
// x[i] over `groups` groups of V ints (C % V == 0 and lo, span multiples
// of C, so a group lies in one row, inside the range or outside it). CTA b
// moves groups [b * COL_PER_CTA, +COL_PER_CTA): a thread takes COL_G of
// them, COL_THREADS apart, loads them all, then patches and stores them.
// Index is int unless an index may pass INT_MAX (column_launch decides).
template <int V, class Index>
__global__ void __launch_bounds__(COL_THREADS)
column_put(const int* __restrict__ x, int* __restrict__ o, Index groups, Index lo, Index span, int C,
           int idx, int fill) {
  using U = typename std::make_unsigned<Index>::type;
  const Index g0 = (Index)blockIdx.x * (Index)COL_PER_CTA + (Index)threadIdx.x;
  Group<V> v[COL_G];
#pragma unroll
  for (int j = 0; j < COL_G; ++j) {
    const Index g = g0 + (Index)j * COL_THREADS;
    if (g < groups) v[j].load_nc(x + g * V);
  }
#pragma unroll
  for (int j = 0; j < COL_G; ++j) {
    const Index g = g0 + (Index)j * COL_THREADS;
    if (g < groups) {
      const Index i = g * V;
      if ((U)(i - lo) < (U)span) {
        const unsigned k = (unsigned)(idx - column_of(i, C));
        if (k < (unsigned)V) v[j].set(k, fill);
      }
      v[j].store(o + i);
    }
  }
}

template <int V, class Index>
void launch_column_put(const int* x, int* o, long long n, int C, int idx, int fill, long long lo,
                       long long span, cudaStream_t st) {
  const long long groups = n / V;
  const unsigned blocks = (unsigned)((groups + COL_PER_CTA - 1) / COL_PER_CTA);
  column_put<V, Index><<<blocks, COL_THREADS, 0, st>>>(x, o, (Index)groups, (Index)lo, (Index)span, C,
                                                       idx, fill);
}

// where(lo <= i < hi & i mod C == idx & 0 <= idx < C, fill, x[i]) over
// the n ints of x, into o (lo, hi multiples of C): the column fill when o
// is x, else the streaming copy
int column_launch(const void* x, void* o, long long n, int C, int idx, int fill, long long lo,
                  long long hi, cudaStream_t st) {
  if (n <= 0) return 0;
  if (C <= 0 || n % C || lo < 0 || hi > n || lo > hi || lo % C || hi % C)
    return (int)cudaErrorInvalidValue;
  if (idx < 0 || idx >= C) lo = hi = 0;  // no slot: nothing to patch
  if (x == o) {
    const long long rows = (hi - lo) / C;
    const long long blocks = rows ? (rows + COL_THREADS - 1) / COL_THREADS : 1;
    column_fill<<<(unsigned)blocks, COL_THREADS, 0, st>>>((int*)o + lo, rows, C, idx, fill);
    return (int)cudaGetLastError();
  }
  const bool wide = n + COL_PER_CTA > INT_MAX;  // groups <= n
  const bool v4 = vec4(x, o, C);
  const int* xi = (const int*)x;
  int* oi = (int*)o;
  if (v4 && wide) launch_column_put<4, long long>(xi, oi, n, C, idx, fill, lo, hi - lo, st);
  else if (v4) launch_column_put<4, int>(xi, oi, n, C, idx, fill, lo, hi - lo, st);
  else if (wide) launch_column_put<1, long long>(xi, oi, n, C, idx, fill, lo, hi - lo, st);
  else launch_column_put<1, int>(xi, oi, n, C, idx, fill, lo, hi - lo, st);
  return (int)cudaGetLastError();
}

}  // namespace

// g3d ([NC, D, C]) and g2d ([D, NC * C], plane p the lane slice [p * C,
// (p + 1) * C)): x and o hold n ints, rows of C; at idx -1 the flat copy
// of v_vmem
extern "C" int ytpu_column_put(const void* x, void* o, long long n, int C, int idx, int fill,
                               void* stream) {
  return column_launch(x, o, n, C, idx, fill, 0, n, (cudaStream_t)stream);
}

// cases a / a2 on an [NC, D, C] state: o[plane, d, idx] = val for every
// doc d, every other element copied
extern "C" int ytpu_plane_masked_put(const void* x, void* o, int NC, int D, int C, int plane,
                                     int idx, int val, void* stream) {
  if (plane < 0 || plane >= NC) return (int)cudaErrorInvalidValue;
  const long long dc = (long long)D * C;
  return column_launch(x, o, NC * dc, C, idx, val, plane * dc, (plane + 1) * dc,
                       (cudaStream_t)stream);
}

// ---- end column put ----------------------------------------------------------------

namespace {

constexpr int THREADS = 256;
constexpr int MAX_CTAS = 1024;

int grid_for(long long n) {
  long long b = (n + THREADS - 1) / THREADS;
  return b < 1 ? 1 : (b > MAX_CTAS ? MAX_CTAS : (int)b);
}

// multi_call body v_multi: meta' = meta; cols is never touched
__global__ void __launch_bounds__(THREADS)
copy_meta(const int* meta, int* mo, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x)
    mo[i] = meta[i];
}

// multi_call body v_body, one CTA per doc: meta' = meta; then for every
// valid row (rows[s, u, 14] == 1), in order, the client clock
//   local = max_c (c < meta'[d, 1] & x[0, d, c] == client ? x[1] + x[2] : 0)
// and meta'[d, 2] |= 2 where local < the row's clock. cols is only read.
__global__ void __launch_bounds__(THREADS)
client_clock_body(const int* __restrict__ rows, const int* cols, const int* meta,
                  int* mo, int S, int U, int W, int D, int C, int MP) {
  __shared__ int part[THREADS / 32];
  const int d = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid < MP) mo[(long long)d * MP + tid] = meta[(long long)d * MP + tid];
  __syncthreads();
  const int nb = mo[(long long)d * MP + 1];
  const int* cl = cols + (long long)d * C;
  const int* ck = cols + ((long long)D + d) * C;
  const int* ln = cols + (2LL * D + d) * C;
  for (int s = 0; s < S; ++s) {
    for (int u = 0; u < U; ++u) {
      const int* r = rows + ((long long)s * U + u) * W;
      if (r[14] != 1) continue;
      const int client = r[0];
      int best = INT_MIN;
      for (int c = tid; c < C; c += blockDim.x) {
        const bool m = c < nb && cl[c] == client;
        best = max(best, m ? (int)((unsigned)ck[c] + (unsigned)ln[c]) : 0);
      }
      for (int k = 16; k > 0; k >>= 1) best = max(best, __shfl_down_sync(0xffffffffu, best, k));
      if ((tid & 31) == 0) part[tid >> 5] = best;
      __syncthreads();
      if (tid == 0) {
        int local = part[0];
        for (int w = 1; w < (int)(blockDim.x >> 5); ++w) local = max(local, part[w]);
        if (!(local >= r[1])) mo[(long long)d * MP + 2] |= 2;
      }
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" int ytpu_plane_v_multi(const void* meta, void* mo, int D, int MP, void* stream) {
  const int n = D * MP;
  if (n <= 0) return 0;
  copy_meta<<<grid_for(n), THREADS, 0, (cudaStream_t)stream>>>((const int*)meta, (int*)mo, n);
  return (int)cudaGetLastError();
}

extern "C" int ytpu_plane_v_body(const void* rows, const void* cols, const void* meta, void* mo,
                                 int S, int U, int W, int D, int C, int MP, void* stream) {
  if (D <= 0) return 0;
  if (MP > THREADS || W < 15) return (int)cudaErrorInvalidValue;
  client_clock_body<<<D, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)rows, (const int*)cols, (const int*)meta, (int*)mo, S, U, W, D, C, MP);
  return (int)cudaGetLastError();
}

// the launch floor: a kernel that does nothing, at any grid (timed beside
// the diagnostic kernels in a CUDA graph)
__global__ void empty_kernel() {}

extern "C" int ytpu_empty_launch(int gx, int gy, int gz, int bx, int by, int bz, void* stream) {
  empty_kernel<<<dim3(gx, gy, gz), dim3(bx, by, bz), 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

extern "C" const char* ytpu_plane_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
