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
// output. The kernels never assume either: an element is read before it
// is written, by the same thread.
//
// What bounds them on this card: the launch. The state is [26, 8, 512]
// i32 (426 KB), read once and written once in 0.25 us at 3.35 TB/s, far
// under a launch. The design keeps one launch per call, a grid of about a
// hundred CTAs for the repros' shapes (one CTA per SM's worth of work, so
// the call costs one memory round trip) and one 16-byte group per thread
// where the rows allow it (C a multiple of 4, 16-byte aligned tensors).
// g3d and g2d keep the Pallas grid over blocks of DB docs as the grid's y
// axis; each plane of a block is cut into CTAs of 256 groups.
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

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_CTAS = 1024;
constexpr int STAGE_BYTES = THREADS * 16;  // v_vmem: bytes staged per CTA

int grid_for(long long n) {
  long long b = (n + THREADS - 1) / THREADS;
  return b < 1 ? 1 : (b > MAX_CTAS ? MAX_CTAS : (int)b);
}

// V consecutive ints moved as one load and one store
template <int V>
struct Group;
template <>
struct Group<4> {
  int4 v;
  __device__ void load(const int* p) { v = *reinterpret_cast<const int4*>(p); }
  __device__ void store(int* p) const { *reinterpret_cast<int4*>(p) = v; }
  __device__ void set(int k, int val) {
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
  __device__ void store(int* p) const { *p = v; }
  __device__ void set(int, int val) { v = val; }
};

bool vec4(const void* a, const void* b, long long C) {
  return C % 4 == 0 && (uintptr_t)a % 16 == 0 && (uintptr_t)b % 16 == 0;
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

// g3d / g2d: CTA (plane p, chunk; doc block b) takes its share of the DB
// rows of plane p of doc block b and writes where(c == idx & idx >= 0,
// fill, x). `row_stride` is the distance between two docs' rows and
// `plane_stride` between two planes: [NC, D, C] has (C, D * C), the flat
// [D, NC * C] layout (NC * C, C).
template <int V>
__global__ void __launch_bounds__(THREADS)
masked_block_put(const int* x, int* o, int D, int C, int DB, long long row_stride,
                 long long plane_stride, int idx, int fill, int chunks) {
  const int p = blockIdx.x / chunks, chunk = blockIdx.x - p * chunks;
  const int d0 = blockIdx.y * DB;
  const int per_row = C / V;
  const int j = chunk * blockDim.x + threadIdx.x;
  if (j >= min(DB, D - d0) * per_row) return;
  const int dd = j / per_row, c0 = (j - dd * per_row) * V;
  const long long i = p * plane_stride + (long long)(d0 + dd) * row_stride + c0;
  Group<V> v;
  v.load(x + i);
  if (idx >= c0 && idx < c0 + V) v.set(idx - c0, fill);
  v.store(o + i);
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

static int launch_block_put(const void* x, void* o, int NC, int D, int C, int DB,
                            long long row_stride, long long plane_stride, int idx, int fill,
                            cudaStream_t st) {
  if (NC <= 0 || D <= 0 || C <= 0) return 0;
  if (DB <= 0) return (int)cudaErrorInvalidValue;
  const int V = vec4(x, o, C) ? 4 : 1;
  const int chunks = (int)(((long long)DB * (C / V) + THREADS - 1) / THREADS);
  const dim3 grid(NC * chunks, (D + DB - 1) / DB);
  if (V == 4) {
    masked_block_put<4><<<grid, THREADS, 0, st>>>((const int*)x, (int*)o, D, C, DB, row_stride,
                                                 plane_stride, idx, fill, chunks);
  } else {
    masked_block_put<1><<<grid, THREADS, 0, st>>>((const int*)x, (int*)o, D, C, DB, row_stride,
                                                 plane_stride, idx, fill, chunks);
  }
  return (int)cudaGetLastError();
}

extern "C" int ytpu_plane_g3d(const void* x, void* o, int NC, int D, int C, int DB,
                              int idx, int fill, void* stream) {
  return launch_block_put(x, o, NC, D, C, DB, C, (long long)D * C, idx, fill,
                          (cudaStream_t)stream);
}

extern "C" int ytpu_plane_g2d(const void* x, void* o, int NC, int D, int C, int DB,
                              int idx, int fill, void* stream) {
  return launch_block_put(x, o, NC, D, C, DB, (long long)NC * C, C, idx, fill,
                          (cudaStream_t)stream);
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
