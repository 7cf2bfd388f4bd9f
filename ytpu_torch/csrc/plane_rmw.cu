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
// g3d and g2d are one kernel, the column put. Neither the Pallas doc block
// nor the plane index is part of their function: in both layouts ([NC, D,
// C], and [D, NC * C] with a plane a lane slice) flat element i gets
// `fill` exactly when i mod C == idx (0 <= idx < C) and keeps x[i]
// otherwise. In place only that column can change, so the in-place call
// writes NC * D ints and reads nothing (at the repros' idx = -1 its
// threads return at once; the launch still happens). Out of place it is a
// streaming copy bound by the card's memory rate (each element read once
// and written once: 3.49 GB for the main path's [26, 256, 65,536] state,
// 1.04 ms at 3.35 TB/s): each thread issues the non-coherent loads of G
// 16-byte groups before any store and patches the column in registers
// (one 32-bit mod C a group); the grid covers the state once. A row whose
// width is not a multiple of 4, or a tensor not 16-byte aligned, takes
// the same loop one int at a time. At the repros' [26, 8, 512] (426 KB)
// every call is launch latency.
//
// The other kernels are bound by the launch too: their state is [26, 8,
// 512] i32 (426 KB), read once and written once in 0.25 us at 3.35 TB/s,
// far under a launch. They keep one launch per call, a grid of about a
// hundred CTAs (one CTA per SM's worth of work, so the call costs one
// memory round trip) and one 16-byte group per thread where the rows
// allow it (C a multiple of 4, 16-byte aligned tensors).
//
// `v_vmem` raised the TPU's scratch limit (vmem_limit_bytes = 64 MB). Its
// counterpart stages the state plane by plane through dynamic shared
// memory: each CTA copies whole rows of one plane of one doc block (as
// many as make up 4 KB, at least one) into shared memory and back out.
// The kernel's dynamic shared memory limit is raised once to the card's
// opt-in maximum (227 KB on an H100) by cudaFuncSetAttribute, so a row of
// up to 58,112 slots can be staged; the whole [26, 8, 512] block (426 KB)
// could not be resident on one SM.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libytpu_plane_rmw.so plane_rmw.cu
// tests/_emulated_plane_rmw.py builds the column-put section alone with
// g++ against tests/cuda_host (a host emulator of CUDA).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

// ---- column put (g3d, g2d) ---------------------------------------------------------

namespace {

// V consecutive ints moved as one load and one store
template <int V>
struct Group;
template <>
struct Group<4> {
  int4 v;
  __device__ void load(const int* p) { v = *reinterpret_cast<const int4*>(p); }
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
  __device__ void load(const int* p) { v = *p; }
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
  if (idx < 0 || idx >= C) return;
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k < rows) x[k * C + idx] = fill;
}

// out of place: o[i] = (i mod C == idx) ? fill : x[i] over `groups` groups
// of V ints (C % V == 0, so a group lies in one row). CTA b moves groups
// [b * COL_PER_CTA, +COL_PER_CTA): a thread takes COL_G of them,
// COL_THREADS apart, loads them all, then patches and stores them. Index
// is int unless an index may pass INT_MAX (column_launch decides).
template <int V, class Index>
__global__ void __launch_bounds__(COL_THREADS)
column_put(const int* __restrict__ x, int* __restrict__ o, Index groups, int C, int idx, int fill) {
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
      const unsigned k = (unsigned)(idx - column_of(i, C));
      if (k < (unsigned)V) v[j].set(k, fill);
      v[j].store(o + i);
    }
  }
}

template <int V, class Index>
void launch_column_put(const int* x, int* o, long long n, int C, int idx, int fill,
                       cudaStream_t st) {
  const long long groups = n / V;
  const unsigned blocks = (unsigned)((groups + COL_PER_CTA - 1) / COL_PER_CTA);
  column_put<V, Index><<<blocks, COL_THREADS, 0, st>>>(x, o, (Index)groups, C, idx, fill);
}

// where(i mod C == idx & idx >= 0, fill, x[i]) over the n ints of x, into
// o: the column fill when o is x, else the streaming copy
int column_launch(const void* x, void* o, long long n, int C, int idx, int fill,
                  cudaStream_t st) {
  if (n <= 0) return 0;
  if (C <= 0 || n % C) return (int)cudaErrorInvalidValue;
  if (x == o) {
    const long long rows = n / C;
    column_fill<<<(unsigned)((rows + COL_THREADS - 1) / COL_THREADS), COL_THREADS, 0, st>>>(
        (int*)o, rows, C, idx, fill);
    return (int)cudaGetLastError();
  }
  const bool wide = n + COL_PER_CTA > INT_MAX;  // groups <= n
  const bool v4 = vec4(x, o, C);
  if (v4 && wide) launch_column_put<4, long long>((const int*)x, (int*)o, n, C, idx, fill, st);
  else if (v4) launch_column_put<4, int>((const int*)x, (int*)o, n, C, idx, fill, st);
  else if (wide) launch_column_put<1, long long>((const int*)x, (int*)o, n, C, idx, fill, st);
  else launch_column_put<1, int>((const int*)x, (int*)o, n, C, idx, fill, st);
  return (int)cudaGetLastError();
}

}  // namespace

// g3d ([NC, D, C]) and g2d ([D, NC * C], plane p the lane slice [p * C,
// (p + 1) * C)): x and o hold n ints, rows of C
extern "C" int ytpu_column_put(const void* x, void* o, long long n, int C, int idx, int fill,
                               void* stream) {
  return column_launch(x, o, n, C, idx, fill, (cudaStream_t)stream);
}

// ---- end column put ----------------------------------------------------------------

namespace {

constexpr int THREADS = 256;
constexpr int MAX_CTAS = 1024;
constexpr int STAGE_BYTES = THREADS * 16;  // v_vmem: bytes staged per CTA

int grid_for(long long n) {
  long long b = (n + THREADS - 1) / THREADS;
  return b < 1 ? 1 : (b > MAX_CTAS ? MAX_CTAS : (int)b);
}

// cases a / a2: plane `plane` gets o[plane, d, c] = val where c == idx
// (idx >= 0; the same slot in every doc), every other element is copied.
// A group never straddles a row (C % V == 0).
template <int V>
__global__ void __launch_bounds__(THREADS)
masked_plane_put(const int* x, int* o, long long groups, long long dc, int C, int plane,
                 int idx, int val) {
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < groups;
       g += (long long)gridDim.x * blockDim.x) {
    const long long i = g * V;
    Group<V> v;
    v.load(x + i);
    const int c0 = (int)(i % C);
    if (idx >= c0 && idx < c0 + V && i / dc == plane) v.set(idx - c0, val);
    v.store(o + i);
  }
}

// v_vmem: passthrough of the [NC, D, C] state; CTA (p, b, z) stages rows
// [z * stage_rows, +stage_rows) of plane p of doc block b through dynamic
// shared memory
template <int V>
__global__ void __launch_bounds__(THREADS)
staged_passthrough(const int* x, int* o, int D, int C, int DB, int stage_rows) {
  extern __shared__ int4 stage4[];
  int* stage = reinterpret_cast<int*>(stage4);
  const int p = blockIdx.x;
  const int r0 = blockIdx.y * DB + blockIdx.z * stage_rows;
  const int rows = min(stage_rows, min((int)(blockIdx.y + 1) * DB, D) - r0);
  if (rows <= 0) return;
  const long long base = ((long long)p * D + r0) * C;
  const int groups = rows * C / V;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    Group<V> v;
    v.load(x + base + (long long)g * V);
    v.store(stage + g * V);
  }
  __syncthreads();
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    Group<V> v;
    v.load(stage + g * V);
    v.store(o + base + (long long)g * V);
  }
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

int staged_smem_limit = -1;  // the raised limit, set once per process

}  // namespace

extern "C" int ytpu_plane_masked_put(const void* x, void* o, int NC, int D, int C,
                                     int plane, int idx, int val, void* stream) {
  const long long n = (long long)NC * D * C;
  if (n <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (vec4(x, o, C)) {
    masked_plane_put<4><<<grid_for(n / 4), THREADS, 0, st>>>(
        (const int*)x, (int*)o, n / 4, (long long)D * C, C, plane, idx, val);
  } else {
    masked_plane_put<1><<<grid_for(n), THREADS, 0, st>>>(
        (const int*)x, (int*)o, n, (long long)D * C, C, plane, idx, val);
  }
  return (int)cudaGetLastError();
}

extern "C" int ytpu_plane_vmem(const void* x, void* o, int NC, int D, int C, int DB,
                               void* stream) {
  if (NC <= 0 || D <= 0 || C <= 0) return 0;
  if (DB <= 0) return (int)cudaErrorInvalidValue;
  if (staged_smem_limit < 0) {
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(staged_passthrough<4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(staged_passthrough<1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (e != cudaSuccess) return (int)e;
    staged_smem_limit = optin;
  }
  const long long row_bytes = (long long)C * (long long)sizeof(int);
  const long long fit = STAGE_BYTES / row_bytes;  // whole rows in 4 KB
  const int stage_rows = fit < 1 ? 1 : (fit > DB ? DB : (int)fit);
  const long long smem = stage_rows * row_bytes;
  if (smem > staged_smem_limit) return (int)cudaErrorInvalidValue;
  const dim3 grid(NC, (D + DB - 1) / DB, (DB + stage_rows - 1) / stage_rows);
  const cudaStream_t st = (cudaStream_t)stream;
  if (vec4(x, o, C)) {
    staged_passthrough<4><<<grid, THREADS, (size_t)smem, st>>>((const int*)x, (int*)o, D, C, DB,
                                                               stage_rows);
  } else {
    staged_passthrough<1><<<grid, THREADS, (size_t)smem, st>>>((const int*)x, (int*)o, D, C, DB,
                                                               stage_rows);
  }
  return (int)cudaGetLastError();
}

extern "C" int ytpu_plane_staged_smem_limit() { return staged_smem_limit; }

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

extern "C" const char* ytpu_plane_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
