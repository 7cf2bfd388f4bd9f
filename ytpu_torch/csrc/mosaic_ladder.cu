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
// few microseconds a launch costs. The design therefore keeps every rung
// to one launch on PyTorch's current stream, with no host synchronization
// and a grid sized to the output (one thread per element, at most 1,024
// CTAs of 256 threads, grid-stride past that). The elementwise rungs move
// 16 bytes per thread when the tensors are 16-byte aligned. Rungs whose
// output is one value broadcast over the tile (3, 4, 5, 6) recompute that
// value in every CTA (at most 128 loads) rather than pay a second launch.
// Rung 4 keeps the Pallas loop's block-wide condition: every row steps
// `o` together while any row is still live (`__syncthreads_or`).
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

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_CTAS = 1024;
constexpr int R3_COLS = 16;    // rung 3: fori over the first 16 columns
constexpr int R4_LIMIT = 12;   // rung 4: scan while o < 12 ...
constexpr int R4_BREAK = 40;   // ... and break a row once acc > 40
constexpr int R5_OUTER = 8;    // rung 5: fori(8) around fori(4)
constexpr int R5_INNER = 4;
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

// --- rungs 0 and 7: elementwise maps ---------------------------------------

struct AddOne {
  __device__ int operator()(int v) const { return (int)((unsigned)v + 1u); }
};
struct Twice {
  __device__ int operator()(int v) const { return (int)((unsigned)v * 2u); }
};

template <class F>
__global__ void __launch_bounds__(THREADS)
map_vec4(const int4* __restrict__ x, int4* __restrict__ o, long long n4) {
  F f;
  for (long long i = first_index(); i < n4; i += grid_stride()) {
    int4 v = x[i];
    v.x = f(v.x);
    v.y = f(v.y);
    v.z = f(v.z);
    v.w = f(v.w);
    o[i] = v;
  }
}

template <class F>
__global__ void __launch_bounds__(THREADS)
map_scalar(const int* __restrict__ x, int* __restrict__ o, long long n) {
  F f;
  for (long long i = first_index(); i < n; i += grid_stride()) o[i] = f(x[i]);
}

template <class F>
int launch_map(const int* x, int* o, int D, int C, cudaStream_t st) {
  const long long n = (long long)D * C;
  if (n <= 0) return 0;
  if (n % 4 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)o % 16 == 0) {
    map_vec4<F><<<grid_for(n / 4), THREADS, 0, st>>>((const int4*)x, (int4*)o, n / 4);
  } else {
    map_scalar<F><<<grid_for(n), THREADS, 0, st>>>(x, o, n);
  }
  return (int)cudaGetLastError();
}

// --- rungs 1 and 2: per-row masks ------------------------------------------

// o[d, c] = 7 if c == x[d, 0] else x[d, c]
__global__ void __launch_bounds__(THREADS)
onehot_put(const int* __restrict__ x, int* __restrict__ o, int D, int C) {
  const long long n = (long long)D * C;
  for (long long i = first_index(); i < n; i += grid_stride()) {
    const long long d = i / C;
    const int c = (int)(i - d * C);
    o[i] = c == x[d * C] ? 7 : x[i];
  }
}

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

// --- rungs 3-6: one value (or one flag) per tile, then a tile write ----------

__device__ __forceinline__ unsigned block_sum(unsigned v, unsigned* part) {
  for (int k = 16; k > 0; k >>= 1) v += __shfl_down_sync(0xffffffffu, v, k);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? part[lane] : 0u;
    for (int k = 16; k > 0; k >>= 1) v += __shfl_down_sync(0xffffffffu, v, k);
    if (lane == 0) part[0] = v;
  }
  __syncthreads();
  return part[0];
}

__device__ __forceinline__ void fill(int* __restrict__ o, long long n, int v) {
  for (long long i = first_index(); i < n; i += grid_stride()) o[i] = v;
}

// o = full(sum_{i < 16} sum_d x[d, i])
__global__ void __launch_bounds__(THREADS)
fori_carry(const int* __restrict__ x, int* __restrict__ o, int D, int C) {
  __shared__ unsigned part[THREADS / 32];
  unsigned acc = 0;
  for (int j = threadIdx.x; j < D * R3_COLS; j += blockDim.x) {
    acc += (unsigned)x[(long long)(j / R3_COLS) * C + j % R3_COLS];
  }
  fill(o, (long long)D * C, (int)block_sum(acc, part));
}

// The conflict-scan shape: every row steps o together while any row has
// o < 12 and has not broken; a live row adds x[d, o] and breaks once its
// sum exceeds 40; o = tile(acc). One thread per row (D <= THREADS).
__global__ void __launch_bounds__(THREADS)
while_scan(const int* __restrict__ x, int* __restrict__ o, int D, int C) {
  __shared__ int acc_s[THREADS];
  const int d = threadIdx.x;
  const bool row = d < D;
  int pos = 0, brk = 0;
  unsigned acc = 0;
  int go = __syncthreads_or(row && pos < R4_LIMIT && brk == 0);
  while (go) {
    if (row) {
      if (brk == 0 && pos >= 0 && pos < C) acc += (unsigned)x[(long long)d * C + pos];
      brk |= (int)acc > R4_BREAK;
      pos += 1;
    }
    go = __syncthreads_or(row && pos < R4_LIMIT && brk == 0);
  }
  if (row) acc_s[d] = (int)acc;
  __syncthreads();
  const long long n = (long long)D * C;
  for (long long i = first_index(); i < n; i += grid_stride()) o[i] = acc_s[i / C];
}

// o = full(sum_{s < 8, u < 4} x[0, (4 s + u) % C]), the loops nested as in
// the Pallas kernel (one thread walks them)
__global__ void __launch_bounds__(THREADS)
nested_fori(const int* __restrict__ x, int* __restrict__ o, int D, int C) {
  __shared__ unsigned total;
  if (threadIdx.x == 0) {
    unsigned acc = 0;
    for (int s = 0; s < R5_OUTER; ++s)
      for (int u = 0; u < R5_INNER; ++u) acc += (unsigned)x[(s * R5_INNER + u) % C];
    total = acc;
  }
  __syncthreads();
  fill(o, (long long)D * C, (int)total);
}

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

// elementwise rungs: any shape, flattened to [D, C]
#define YTPU_MAP_RUNG(NAME, F)                                                 \
  extern "C" int NAME(const void* x, void* o, int D, int C, void* stream) {    \
    return launch_map<F>((const int*)x, (int*)o, D, C, (cudaStream_t)stream);  \
  }

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

YTPU_MAP_RUNG(ytpu_ladder_r0, AddOne)
YTPU_ROW_RUNG(ytpu_ladder_r1, onehot_put, 0x7fffffff)
YTPU_ROW_RUNG(ytpu_ladder_r2, mrow_mask, 0x7fffffff)
YTPU_ROW_RUNG(ytpu_ladder_r3, fori_carry, 0x7fffffff)
YTPU_ROW_RUNG(ytpu_ladder_r4, while_scan, THREADS)
YTPU_ROW_RUNG(ytpu_ladder_r5, nested_fori, 0x7fffffff)
YTPU_ROW_RUNG(ytpu_ladder_r6, guarded_write, 0x7fffffff)
YTPU_MAP_RUNG(ytpu_ladder_r7, Twice)

extern "C" const char* ytpu_ladder_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
