// The Yjs V2 (columnar) update decode as one hand-written Hopper program:
// ytpu_torch.ops.decode_v2.decode_updates_v2 and decode_updates_v2_raw on
// CUDA tensors, from the wire bytes (the [S, L] matrix, or the arena of
// pack_updates_v2_raw read in place), the frame spans and the cold-content
// sidecar to the int32 UpdateBatch and the lane flags, in one launch.
//
// Replaces: ytpu/ops/decode_v2.py:1025 `decode_updates_v2` (and :298
// `decode_updates_v2_raw`, a gather first), one jitted XLA program built
// of six `fori_loop`s over [S]-wide lane vectors: the RLE column expanders
// (:516 UIntOptRle, :555 IntDiffOptRle, :587 Rle, one run a step, each
// writing an [S, N] array), the rest-stream walker (:1018, a 16-state
// machine for lanes whose blocks put content bytes in the rest stream),
// the section walk (:1322) and the delete-set walk (:1541), around them
// the lane-parallel tensor algebra (per-block consumption counts as prefix
// sums over the info bytes, the bulk parse of a content-free rest stream,
// the UTF-16 string offsets by an 18-round binary search, the row emission
// as a one-hot scatter), then `_resolve_and_pack` (:1652), the intern
// tables. No `pallas_call` is involved.
//
// What it computes, for lane s of S: the 27 UpdateBatch fields (22 int32
// row planes [S, U] in UpdateBatch order with the valid bytes [S, U], 3
// int32 delete planes [S, R] with their valid bytes [S, R]) and the lane's
// int32 flags [S], bit for bit what the plain composition gives:
// (`gather_raw_lanes` for the arena ->) `decode_v2._decode_v2_reference`
// -> `decode_kernel._resolve_and_pack`, flags and caps included: NB = U + 8
// blocks, NV rest slots, NS = 2U + 4 strings, NCLI client entries, DSEC =
// R + 4 delete sections and SEC client sections (`decode_v2.v2_caps`).
//
// The lane's bytes: byte j of lane s is what the gathered [S, L] matrix
// holds, jc = clamp(j, 0, L - 1), then raw[clamp(offs[s] + jc, 0, RC - 1)]
// where jc < row_lens[s] (the staged extent: payload and cold sidecars),
// else 0. Unlike the V1 decode, that zero mask is not implied by the
// parse: the bulk-parse slots, the vat_id window and the 32-byte name-hash
// window read past a region's end unmasked, so every read applies it. A
// [S, L] matrix is the arena with offs[s] = s * L and row_lens[s] = L (both
// pointers null), read as given. A content ref is s * L + byte.
//
// Semantics kept bit for bit:
//   * values are int32 that wrap (JAX's arithmetic): every sum that can
//     leave 32 bits goes through wadd / wmul in uint32; the varint value of
//     a window is its low 32 bits;
//   * reads clamp their index into [0, L - 1]; the 10-byte varint windows
//     of the columns and of the walker are zero at or past the region's
//     end, the bulk-parse slots, the vat_id window and the 32-byte name
//     hash window are not;
//   * an RLE entry writes every index i of [0, N) its mask covers, even
//     for a run count that wrapped negative (then later entries overwrite
//     earlier ones, as in the vector version), and the expansion stops
//     after N entries or when its cursor leaves the region;
//   * a column's value at a clamped index is what the expansion left
//     there (0 where no entry reached);
//   * the rest stream is walked only for lanes whose blocks (all NB of
//     them, valid or not) carry Any, Binary or Move content; the walker
//     numbers its structural slots as the bulk parse numbers a
//     content-free lane's, and takes at most T steps;
//   * a client id beyond i32 is -2 - client_hash of its unsigned-varint
//     bytes (rebuilt from the 64-bit magnitude of V2's signed varint in
//     the client column; the wire bytes themselves in the rest stream);
//   * a block's clock subtracts the length prefix at its section's first
//     block, which a wrapped section count can put after the block: the
//     prefix is then summed over all blocks first;
// and with `_resolve_and_pack` (resolve.cuh, shared with decode.cu): ids,
// key hashes and root names resolve as each row or range is written, only
// emitted rows and written ranges raise flags, a delete range's client
// resolves after the last section (a later section can overwrite a range),
// rows and ranges not written hold the resolved defaults, and a lane whose
// flags hold an error loses its valid bytes.
//
// Design for the card. The decode of one lane is a chain of dependent
// reads and instructions, so one thread owns one lane and a CTA is one
// warp; a lane's time is the length of its chain. A lane walks each RLE
// column once, entry by entry, and writes its expansion into per-lane
// arrays that the per-block passes then read where the vector version
// gathers; the arrays keep the vector version's meaning of a clamped or
// never-written index and of a wrapped run count exactly. They live in
// shared memory as a [word][lane] block a CTA, so that a warp's threads
// hit different banks: 26 U + 12 R + 9 SEC + 216 words a lane (404 at U =
// R = SEC = 4: 51.7 KB a CTA, four CTAs an SM). Where 32 lanes' words pass
// SMEM_MAX_BYTES (the merged whole-state lanes' U), the host chooses, once
// per launch, the same program over the same blocks in a device-memory
// scratch that the wrapper allocates. What shortens the chain:
//   * a varint window is two aligned 16-byte loads, masked in registers by
//     the region's end and the staged extent; a varint's length and value
//     come from the window's words with bit operations, and an RLE entry's
//     run count from the same window where it ends inside it;
//   * the bulk parse finds the rest stream's terminators 8 bytes at a time,
//     and the slots past its last varint, all alike but the first, are one
//     slot held in registers (`tail`);
//   * the strings' byte offsets come from one forward scan of the blob's
//     UTF-16 prefix sums (counted by 16-byte words), which gives the binary
//     search's answer wherever its rounds are sure to meet (the blob inside
//     the lane);
//   * pass B walks the valid blocks only, and the arrays that only the
//     content walker fills are cleared only where it runs.
// Each thread writes its emitted rows and ranges as resolved int32; then
// the warp writes the defaults of the rows and ranges its lanes did not
// emit and every valid byte, neighbouring threads on neighbouring words,
// each lane's counts and error shared through shuffles. The profiling
// build (-DYTPU_DECODE_V2_PROFILE) adds each lane's cycles per phase
// (ytpu_torch/benches/decode_v2_profile.py).
//
// Bound: bytes. Each lane's wire bytes, offset, staged extent, length, 24
// span words and sidecar row are read once, and each table once; the 22
// int32 row fields and a valid byte a row slot, the 3 int32 delete fields
// and a valid byte a delete slot and the int32 flags written once
// (chip_smoke.py's `decode_v2` phase counts them). The chain of dependent
// reads keeps a lane far above that bound.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libdecode_v2.so decode_v2.cu
// tests/_emulated_decode_v2.py builds it with g++ against tests/cuda_host
// (a host emulator of CUDA) and holds it to the plain composition on the
// CPU.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

#include "resolve.cuh"

constexpr int THREADS = 32;  // one warp a CTA
constexpr unsigned FULL_MASK = 0xFFFFFFFFu;
// the most shared memory a CTA's expansion arrays may take (three CTAs an
// SM); past it the arrays go to the device-memory scratch
constexpr int SMEM_MAX_BYTES = 64 * 1024;
constexpr int W_DEPTH = 4;
constexpr int KEY_HASH_BYTES = 32;

// span indices of the host frame split
enum Span : int {
  SP_KEY_CLOCK, SP_CLIENT, SP_LEFT_CLOCK, SP_RIGHT_CLOCK, SP_INFO, SP_STRING, SP_PARENT_INFO, SP_TYPE_REF,
  SP_LEN, SP_REST, SP_STR_BLOB, SP_STR_LENS
};

// rest-walker states
enum Walk : int {
  W_NC, W_SEC_N, W_SEC_CLK, W_BLK, W_SKIP, W_MVF, W_MSC, W_MSK, W_MEC, W_MEK, W_ANY, W_MKEY, W_MVAL, W_BUF,
  W_DS, W_DONE
};

// content kinds (the info byte's low four bits)
constexpr int K_DELETED = 1, K_JSON = 2, K_BINARY = 3, K_STRING = 4, K_EMBED = 5, K_FORMAT = 6, K_TYPE = 7,
              K_ANY = 8, K_DOC = 9, K_SKIP = 10, K_MOVE = 11;

__device__ __forceinline__ int wadd(int a, int b) { return (int)((u32)a + (u32)b); }
__device__ __forceinline__ int wsub(int a, int b) { return (int)((u32)a - (u32)b); }
__device__ __forceinline__ int wmul(int a, int b) { return (int)((u32)a * (u32)b); }
__device__ __forceinline__ int clampi(int x, int lo, int hi) { return x < lo ? lo : (x > hi ? hi : x); }
__device__ __forceinline__ i64 clampl(i64 x, i64 lo, i64 hi) { return x < lo ? lo : (x > hi ? hi : x); }

struct Params : Interns {
  const uint8_t* raw;  // the arena (or the matrix, row-major)
  i64 n_raw;
  const int* offs;   // [S] lane offsets into raw; null: the matrix, offs[s] = s * L
  const int* rlens;  // [S] staged extents; null: L
  const int* lens;   // [S] payload lengths
  const int* spans;  // [S, 12, 2]
  const int* side;   // [S, n_side]
  int n_side;        // -1: no sidecar
  int S, L, U, R, SEC;
  int NB, DSEC, NV, NS, NCLI, T;
  int* rows;         // [ROW_FIELDS, S, U]
  int* dels;         // [DEL_FIELDS, S, R]
  int* flags;        // [S]
  uint8_t* rvalid;   // [S, U]
  uint8_t* dvalid;   // [S, R]
  int* scratch;      // [CTAs, words, THREADS] on the device-memory path; null: shared memory
};

#ifdef YTPU_DECODE_V2_PROFILE
// The profiling build (library decode_v2_profile): each lane adds the SM
// cycles (clock64) it spent in each phase of decode_lane to
// g_phase_cycles, which ytpu_decode_v2_phase_cycles reads.
constexpr int PHASES = 8;  // spans, expansions, strings, pass A, rest stream, sections, pass B, delete set
__device__ unsigned long long g_phase_cycles[PHASES];
struct PhaseClock {
  long long t;
  unsigned long long acc[PHASES];
};
__device__ __forceinline__ void phase_start(PhaseClock& c) {
  c.t = clock64();
  for (int k = 0; k < PHASES; ++k) c.acc[k] = 0;
}
__device__ __forceinline__ void phase_end(PhaseClock& c, int k) {
  const long long now = clock64();
  c.acc[k] += (unsigned long long)(now - c.t);
  c.t = now;
}
__device__ __forceinline__ void phase_flush(const PhaseClock& c) {
  for (int k = 0; k < PHASES; ++k) atomicAdd(g_phase_cycles + k, c.acc[k]);
}
#else
struct PhaseClock {};
__device__ __forceinline__ void phase_start(PhaseClock&) {}
__device__ __forceinline__ void phase_end(PhaseClock&, int) {}
__device__ __forceinline__ void phase_flush(const PhaseClock&) {}
#endif

// word offsets of a lane's expansion arrays
struct Layout {
  int info, pi, lc, rc, len, tr, cli, str16, strst, cbase, skipi, anyc, lpsum, cst, mvf, msc, msk, mec, mek, v, vst,
      vovf, sech, secb, words;
};

__host__ __device__ inline Layout layout(int U, int R, int SEC) {
  const int NB = U + 8, DSEC = R + 4, NV = 2 + 2 * SEC + NB + 2 * DSEC + 2 * R, NS = 2 * U + 4,
            NCLI = 3 * NB + SEC + 2;
  Layout o;
  int w = 0;
  o.info = w; w += NB;
  o.pi = w; w += NB;
  o.lc = w; w += NB;
  o.rc = w; w += NB;
  o.len = w; w += NB;
  o.tr = w; w += NB;
  o.cli = w; w += NCLI;
  o.str16 = w; w += NS;
  o.strst = w; w += NS;
  o.cbase = w; w += NB;
  o.skipi = w; w += NB;
  o.anyc = w; w += NB;
  o.lpsum = w; w += NB;
  o.cst = w; w += NB;
  o.mvf = w; w += NB;
  o.msc = w; w += NB;
  o.msk = w; w += NB;
  o.mec = w; w += NB;
  o.mek = w; w += NB;
  o.v = w; w += NV;
  o.vst = w; w += NV;
  o.vovf = w; w += NV;
  o.sech = w; w += SEC;
  o.secb = w; w += SEC;
  o.words = w;
  return o;
}

// Shared memory a CTA's expansion arrays take, or 0 where that passes
// SMEM_MAX_BYTES and they go to the device-memory scratch.
__host__ __device__ inline int smem_bytes(int U, int R, int SEC) {
  const i64 bytes = (i64)THREADS * layout(U, R, SEC).words * 4;
  return bytes <= SMEM_MAX_BYTES ? (int)bytes : 0;
}

// A varint window: the ten bytes at a position, bytes 0-7 in `lo` and 8-9
// in `hi` (its other bits zero).
constexpr u64 HIGH_BITS = 0x8080808080808080ull;

__device__ __forceinline__ u32 wbyte(u64 lo, u64 hi, int k) { return (u32)((k < 8 ? lo >> (8 * k) : hi >> (8 * k - 64)) & 0xFF); }

// bytes of the varint at byte 0 of a window: up to and including its first
// byte < 0x80, at most 10
__device__ __forceinline__ int vlen(u64 lo, u64 hi) {
  const u64 t = ~lo & HIGH_BITS;
  if (t) return __ffsll((long long)t) >> 3;
  const u64 t2 = ~hi & 0x8080ull;
  return t2 ? 8 + (__ffsll((long long)t2) >> 3) : 10;
}

// the window k bytes on (1 <= k <= 9); its last k bytes are zero
__device__ __forceinline__ void wshift(u64 lo, u64 hi, int k, u64& lo2, u64& hi2) {
  if (k < 8) {
    lo2 = (lo >> (8 * k)) | (hi << (64 - 8 * k));
    hi2 = hi >> (8 * k);
  } else {
    lo2 = hi >> (8 * k - 64);
    hi2 = 0;
  }
}

// the unsigned varint at byte 0: its low 32 bits (its first five 7-bit
// groups, summed in uint32), byte count and whether it passes 32 bits
__device__ __forceinline__ void uvar_of(u64 lo, u64 hi, int& val, int& nb, bool& ovf) {
  const int n = vlen(lo, hi);
  const u64 x = n < 5 ? lo & ((1ull << (8 * n)) - 1) : lo;
  val = (int)(u32)((x & 0x7F) | ((x >> 1) & (0x7Full << 7)) | ((x >> 2) & (0x7Full << 14)) |
                   ((x >> 3) & (0x7Full << 21)) | ((x >> 4) & (0x7Full << 28)));
  nb = n;
  ovf = n > 5 || (n == 5 && ((lo >> 32) & 0x7F) >= 8);
}

// the signed varint at byte 0 (6 bits and a sign in its first byte):
// magnitude (low 32 bits), sign, byte count and overflow
__device__ __forceinline__ void svar_of(u64 lo, u64 hi, int& mag, bool& neg, int& nb, bool& ovf) {
  const int n = vlen(lo, hi);
  const u64 x = n < 5 ? lo & ((1ull << (8 * n)) - 1) : lo;
  mag = (int)(u32)((x & 0x3F) | ((x >> 2) & (0x7Full << 6)) | ((x >> 3) & (0x7Full << 13)) |
                   ((x >> 4) & (0x7Full << 20)) | ((x >> 5) & (0x7Full << 27)));
  neg = (lo & 0x40) != 0;
  nb = n;
  ovf = n > 5 || (n == 5 && ((lo >> 32) & 0x7F) >= 16);
}

// the 64-bit magnitude of the signed varint of n bytes at byte 0
__device__ u64 smag64(u64 lo, u64 hi, int n) {
  u64 m = lo & 0x3F;
  for (int k = 1; k < n; ++k) m += ((u64)(wbyte(lo, hi, k) & 0x7F)) << (6 + 7 * (k - 1));
  return m;
}

// One lane's view: its bytes in the arena, its expansion words (word w at
// sc[w * THREADS]: its column of a CTA's [word][lane] block) and the
// varint readers of the vector version.
struct Lane {
  const uint8_t* raw;
  i64 off, rc_last;
  int L, rlen;
  int* sc;

  __device__ __forceinline__ int byte(int j) const {
    const int jc = clampi(j, 0, L - 1);
    return jc < rlen ? raw[clampl(off + jc, 0, rc_last)] : 0;
  }
  __device__ __forceinline__ int& at(int word) const { return sc[word * THREADS]; }
  // the window byte at pos + k: zero at or past `end`
  __device__ __forceinline__ int win(int pos, int end, int k) const { return pos + k < end ? byte(pos + k) : 0; }

  // the window at pos, zero at or past `end`: two aligned 16-byte loads
  // where all ten bytes lie inside the lane's width and the arena, masked
  // in registers by `end` and the staged extent; else one byte at a time
  __device__ __forceinline__ void window(int pos, int end, u64& lo, u64& hi) const {
    const i64 p = pos;
    if (p >= 0 && p + 9 <= L - 1 && off + p >= 0 && off + p + 9 <= rc_last) {
      const uintptr_t addr = (uintptr_t)(raw + off + p);
      const ulonglong2* c = (const ulonglong2*)(addr & ~(uintptr_t)15);
      const int o = (int)(addr & 15);
      const ulonglong2 c0 = __ldg(c);
      const ulonglong2 c1 = o > 6 ? __ldg(c + 1) : make_ulonglong2(0, 0);
      const u64 x0 = o < 8 ? c0.x : c0.y, x1 = o < 8 ? c0.y : c1.x, x2 = o < 8 ? c1.x : c1.y;
      const int sh = (o & 7) * 8;
      lo = sh ? (x0 >> sh) | (x1 << (64 - sh)) : x0;
      hi = (sh ? (x1 >> sh) | (x2 << (64 - sh)) : x1) & 0xFFFFull;
      const i64 m = (i64)(end < rlen ? end : rlen) - p;  // bytes of the window kept
      if (m < 8) lo = m <= 0 ? 0 : lo & ((1ull << (8 * m)) - 1);
      if (m < 10) hi = m <= 8 ? 0 : hi & 0xFFull;
    } else {
      lo = hi = 0;
#pragma unroll
      for (int k = 0; k < 10; ++k) {
        const u64 b = (u64)win(pos, end, k);
        if (k < 8) lo |= b << (8 * k);
        else hi |= b << (8 * k - 64);
      }
    }
  }

  // unsigned varint at pos (window masked by end): its low 32 bits, its
  // byte count (up to 10) and whether it passes 32 bits
  __device__ void uvar(int pos, int end, int& val, int& nb, bool& ovf) const {
    u64 lo, hi;
    window(pos, end, lo, hi);
    uvar_of(lo, hi, val, nb, ovf);
  }

  // the unsigned varint k bytes past pos, whose window (masked by end) is
  // (lo, hi): from the same window where its last byte lies in it, else
  // from a window of its own
  __device__ void uvar_after(int pos, int end, u64 lo, u64 hi, int k, int& val, int& nb, bool& ovf) const {
    if (k < 10) {
      u64 lo2, hi2;
      wshift(lo, hi, k, lo2, hi2);
      if (vlen(lo2, hi2) <= 10 - k) {
        uvar_of(lo2, hi2, val, nb, ovf);
        return;
      }
    }
    uvar(pos + k, end, val, nb, ovf);
  }

  // UTF-16 units of the lane's bytes [lo, hi) as `byte` reads them (a
  // UTF-8 head byte, not 0b10xxxxxx, is one unit, a 4-byte lead one more):
  // aligned 16-byte words with population counts where the range lies
  // inside the staged extent, the width and the arena, else byte by byte
  __device__ int units(int lo, int hi) const {
    int u = 0;
    if (lo >= 0 && lo < hi && hi <= rlen && hi <= L && off + lo >= 0 && off + hi - 1 <= rc_last) {
      const uint8_t* p = raw + off + lo;
      int n = hi - lo;
      for (; n > 0 && ((uintptr_t)p & 15); ++p, --n) u += ((*p & 0xC0u) != 0x80u) + (*p >= 0xF0u);
      for (; n >= 16; p += 16, n -= 16) {
        const ulonglong2 w = __ldg((const ulonglong2*)p);
        u += 16 - __popcll(w.x & ~(w.x << 1) & HIGH_BITS) - __popcll(w.y & ~(w.y << 1) & HIGH_BITS) +
             __popcll(w.x & (w.x << 1) & (w.x << 2) & (w.x << 3) & HIGH_BITS) +
             __popcll(w.y & (w.y << 1) & (w.y << 2) & (w.y << 3) & HIGH_BITS);
      }
      for (; n > 0; ++p, --n) u += ((*p & 0xC0u) != 0x80u) + (*p >= 0xF0u);
      return u;
    }
    for (int j = lo; j < hi; ++j) {
      const int b = byte(j);
      u += ((b & 0xC0) != 0x80) + (b >= 0xF0);
    }
    return u;
  }
};

// client_hash_host mixing over nbytes varint bytes
__device__ __forceinline__ int mix_client(u32 h, int nbytes) {
  return (int)((h ^ ((u32)nbytes * 2654435761u)) & 0x3FFFFFFFu);
}

// client_hash_host of the unsigned-varint bytes of a 64-bit value
__device__ int hash_u64(u64 m) {
  int last = 0;
  for (int k = 0; k < 10; ++k)
    if ((m >> (7 * k)) & 0x7F) last = k;
  u32 h = 0, p = 1;
  for (int k = 0; k <= last; ++k) {
    const u32 g = (u32)((m >> (7 * k)) & 0x7F) | (k < last ? 0x80u : 0u);
    h += g * p;
    p *= 31u;
  }
  return mix_client(h, last + 1);
}

// client_hash_host of the varint bytes at byte 0 of a window
__device__ int hash_window(u64 lo, u64 hi) {
  u32 h = 0, p = 1;
  int n = 0;
  for (int k = 0; k < 10; ++k) {
    const u32 w = wbyte(lo, hi, k);
    h += w * p;
    p *= 31u;
    ++n;
    if (w < 0x80) break;
  }
  return mix_client(h, n);
}

// an RLE entry covering [oidx, oidx + count) of [0, N): the mask of the
// vector version, also where the count wrapped
template <typename F>
__device__ __forceinline__ void cover(int oidx, int count, int N, F&& put) {
  const int hi = wadd(oidx, count);
  if (oidx >= 0 && count >= 0 && (i64)oidx + count == (i64)hi) {
    const int e = hi < N ? hi : N;
    for (int i = oidx; i < e; ++i) put(i);
  } else {
    for (int i = 0; i < N; ++i)
      if (i >= oidx && i < hi) put(i);
  }
}

// UIntOptRle column into words [off, off + N); returns the count produced.
// An entry: a signed varint (its sign: a run count follows), one window
// for both where the count ends inside it.
__device__ int expand_uintoptrle(const Lane& ln, int start, int length, int N, int off, bool hash_big) {
  for (int i = 0; i < N; ++i) ln.at(off + i) = 0;
  const int end = wadd(start, length);
  int pos = length > 0 ? start : end, oidx = 0;
  for (int step = 0; step < N; ++step) {
    if (!(pos < end && oidx < N)) break;
    u64 lo, hi;
    ln.window(pos, end, lo, hi);
    int mag, nb, cnt = 0, nb2 = 0;
    bool neg, ovf, ovf2;
    svar_of(lo, hi, mag, neg, nb, ovf);
    if (hash_big && ovf) mag = -2 - hash_u64(smag64(lo, hi, nb));
    if (neg) ln.uvar_after(pos, end, lo, hi, nb, cnt, nb2, ovf2);
    const int count = neg ? wadd(cnt, 2) : 1;
    const int adv = nb + (neg ? nb2 : 0);
    cover(oidx, count, N, [&](int i) { ln.at(off + i) = mag; });
    pos = wadd(pos, adv);
    oidx = wadd(oidx, count);
  }
  return oidx;
}

// IntDiffOptRle column: runs of an arithmetic sequence
__device__ int expand_intdiffoptrle(const Lane& ln, int start, int length, int N, int off) {
  for (int i = 0; i < N; ++i) ln.at(off + i) = 0;
  const int end = wadd(start, length);
  int pos = length > 0 ? start : end, oidx = 0, last = 0;
  for (int step = 0; step < N; ++step) {
    if (!(pos < end && oidx < N)) break;
    u64 lo, hi;
    ln.window(pos, end, lo, hi);
    int mag, nb, cnt = 0, nb2 = 0;
    bool neg, ovf, ovf2;
    svar_of(lo, hi, mag, neg, nb, ovf);
    const int enc = neg ? wsub(0, mag) : mag;
    const bool has_count = (enc & 1) != 0;
    const int diff = enc >> 1;
    if (has_count) ln.uvar_after(pos, end, lo, hi, nb, cnt, nb2, ovf2);
    const int count = has_count ? wadd(cnt, 2) : 1;
    const int adv = nb + (has_count ? nb2 : 0);
    // value at i: last + diff * k, k = i - oidx + 1 in [1, count]
    if (oidx >= 0 && count >= 0 && (i64)oidx + count == (i64)wadd(oidx, count)) {
      const int hi_ = wadd(oidx, count), e = hi_ < N ? hi_ : N;
      for (int i = oidx; i < e; ++i) ln.at(off + i) = wadd(last, wmul(diff, i - oidx + 1));
    } else {
      for (int i = 0; i < N; ++i) {
        const int k = wadd(wsub(i, oidx), 1);
        if (k >= 1 && k <= count) ln.at(off + i) = wadd(last, wmul(diff, k));
      }
    }
    last = wadd(last, wmul(diff, count));
    pos = wadd(pos, adv);
    oidx = wadd(oidx, count);
  }
  return oidx;
}

// Rle column: a u8, then count - 1 (omitted on the last entry: it fills out)
__device__ int expand_rle(const Lane& ln, int start, int length, int N, int off) {
  for (int i = 0; i < N; ++i) ln.at(off + i) = 0;
  const int end = wadd(start, length);
  int pos = length > 0 ? start : end, oidx = 0;
  for (int step = 0; step < N; ++step) {
    if (!(pos < end && oidx < N)) break;
    u64 lo, hi;
    ln.window(pos, end, lo, hi);
    const int value = (int)(lo & 0xFF);
    const bool has_count = pos + 1 < end;
    int cnt = 0, nb2 = 0;
    bool ovf2;
    if (has_count) ln.uvar_after(pos, end, lo, hi, 1, cnt, nb2, ovf2);
    const int count = has_count ? wadd(cnt, 1) : N;
    const int adv = 1 + (has_count ? nb2 : 0);
    cover(oidx, count, N, [&](int i) { ln.at(off + i) = value; });
    pos = wadd(pos, adv);
    oidx = wadd(oidx, count);
  }
  return oidx;
}

// UTF-16 units of the lane's bytes [0, m): a UTF-8 head byte is one unit, a
// 4-byte lead one more. A cursor that moves forward and restarts at a
// base point.
struct Psum {
  const Lane* ln;
  int base_pos, base_val, pos, val;
  __device__ int at(int m) {
    if (m < pos) {
      if (m >= base_pos) {
        pos = base_pos;
        val = base_val;
      } else {
        pos = 0;
        val = 0;
      }
    }
    if (m > pos) {
      val += ln->units(pos, m);
      pos = m;
    }
    return val;
  }
};

// key_hash_host of the string at byte `start` (window clamped, not masked)
__device__ int name_hash(const Lane& ln, int start, int nbytes) {
  u32 h = 0, p = 1;
  for (int i = 0; i < KEY_HASH_BYTES; ++i) {
    if (i < nbytes) h += (u32)ln.byte(start + i) * p;
    p *= 31u;
  }
  return (int)((h ^ ((u32)nbytes * 2654435761u)) & 0x7FFFFFFFu);
}

// Decode lane s into the rows and ranges it emits (resolved int32, written
// straight to the planes); its expansion arrays at sc (word w at
// sc[w * THREADS]). Returns its row and range counts and its flags.
__device__ void decode_lane(const Params& P, const int s, int* sc, int& n_rows, int& n_dels,
                            i64& flags) {
  const int S = P.S, L = P.L, U = P.U, R = P.R, SEC = P.SEC;
  const int NB = P.NB, DSEC = P.DSEC, NV = P.NV, NS = P.NS, NCLI = P.NCLI;
  const Layout O = layout(U, R, SEC);
  Lane ln;
  ln.raw = P.raw;
  ln.off = P.offs != nullptr ? __ldg(P.offs + s) : (i64)s * L;
  ln.rc_last = P.n_raw - 1;
  ln.L = L;
  ln.rlen = P.rlens != nullptr ? __ldg(P.rlens + s) : L;
  ln.sc = sc;
  const int len_s = __ldg(P.lens + s);
  const i64 lane_ref = (i64)s * L;
  const i64 prim = lane_prim(P, s);
  // the 24 span words: six aligned 16-byte loads (the wrapper aligns them)
  int sp[12][2];
  int abs_sum = 0;
  {
    const int4* q = (const int4*)(P.spans + (i64)s * 24);
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const int4 w = __ldg(q + k);
      sp[2 * k][0] = w.x;
      sp[2 * k][1] = w.y;
      sp[2 * k + 1][0] = w.z;
      sp[2 * k + 1][1] = w.w;
      abs_sum |= w.x | w.y | w.z | w.w;
    }
  }
  i64 fl = 0;
  PhaseClock clk;
  phase_start(clk);
  // all-zero spans on a non-empty payload: the host frame split failed
  const bool frame_bad = len_s > 0 && abs_sum == 0;
  if (frame_bad) fl |= FLAG_MALFORMED;

  phase_end(clk, 0);
  // ---- column expansions
  const int info_n = expand_rle(ln, sp[SP_INFO][0], sp[SP_INFO][1], NB, O.info);
  const int pi_n = expand_rle(ln, sp[SP_PARENT_INFO][0], sp[SP_PARENT_INFO][1], NB, O.pi);
  const int cli_n = expand_uintoptrle(ln, sp[SP_CLIENT][0], sp[SP_CLIENT][1], NCLI, O.cli, true);
  const int lc_n = expand_intdiffoptrle(ln, sp[SP_LEFT_CLOCK][0], sp[SP_LEFT_CLOCK][1], NB, O.lc);
  const int rc_n = expand_intdiffoptrle(ln, sp[SP_RIGHT_CLOCK][0], sp[SP_RIGHT_CLOCK][1], NB, O.rc);
  const int len_n = expand_uintoptrle(ln, sp[SP_LEN][0], sp[SP_LEN][1], NB, O.len, false);
  const int tr_n = expand_uintoptrle(ln, sp[SP_TYPE_REF][0], sp[SP_TYPE_REF][1], NB, O.tr, false);
  const int str_n = expand_uintoptrle(ln, sp[SP_STR_LENS][0], sp[SP_STR_LENS][1], NS, O.str16, false);

  phase_end(clk, 1);
  // ---- string byte offsets: the first byte index in the blob whose
  // UTF-16 prefix sum reaches each string's cumulative unit target (the
  // vector version's 18 rounds of binary search, round for round; once lo
  // has met hi, one more round settles lo and the rest change nothing)
  const int blob_start = sp[SP_STR_BLOB][0], blob_end = wadd(sp[SP_STR_BLOB][0], sp[SP_STR_BLOB][1]);
  {
    Psum ps{&ln, 0, 0, 0, 0};
    const int bs = clampi(blob_start, 0, L);
    ps.base_val = ps.at(bs);
    ps.base_pos = bs;
    const int base16 = ps.base_val;
    // a blob inside the lane's width and shorter than 2^17 bytes: the
    // search's bounds meet within 17 rounds, and its 18th steps past hi
    // where hi's prefix is short of the target, so its answer is the first
    // m in [blob_start, blob_end] whose prefix reaches the target, else
    // blob_end + 1: one forward scan for all the strings, which starts
    // over only where a target falls (a wrapped length)
    const bool scan = 0 <= blob_start && blob_start <= blob_end && blob_end <= L && blob_end - blob_start < (1 << 17);
    int tgt_excl = 0, m = blob_start, prev = 0;
    for (int i = 0; i < NS; ++i) {
      const int tgt = wadd(base16, tgt_excl);
      tgt_excl = wadd(tgt_excl, ln.at(O.str16 + i));
      if (scan) {
        if (i > 0 && tgt < prev) m = blob_start;
        prev = tgt;
        while (m <= blob_end && ps.at(m) < tgt) ++m;
        ln.at(O.strst + i) = m;
        continue;
      }
      int lo = blob_start, hi = blob_end;
      for (int r = 0; r < 18; ++r) {
        const int mid = (int)(((i64)lo + hi) >> 1);
        if (ps.at(clampi(mid, 0, L)) < tgt)
          lo = mid + 1;
        else
          hi = mid;
      }
      ln.at(O.strst + i) = lo;
    }
  }
  auto str_bytes = [&](int i) { return (i + 1 < NS ? ln.at(O.strst + i + 1) : blob_end) - ln.at(O.strst + i); };

  phase_end(clk, 2);
  // ---- per-block consumption, pass A: client-column bases, skip counts,
  // the walker's Any counts, and whether the walker runs
  bool has_content = false;
  {
    int pi_idx = 0, c_base = 0, n_idx = 0, skips = 0;
    for (int j = 0; j < NB; ++j) {
      const int info = ln.at(O.info + j);
      const bool is_gc = info == 0, is_skip = info == K_SKIP, is_item = !is_gc && !is_skip;
      const int kind4 = info & 0x0F;
      const bool has_o = is_item && (info & 0x80), has_r = is_item && (info & 0x40);
      const bool cant_copy = is_item && !has_o && !has_r;
      const int pi = ln.at(O.pi + clampi(pi_idx, 0, NB - 1));
      const bool is_nested = cant_copy && pi != 1;
      ln.at(O.cbase + j) = c_base;
      c_base += (int)has_o + (int)has_r + (int)is_nested;
      pi_idx += cant_copy;
      const int len_at = ln.at(O.len + clampi(n_idx, 0, NB - 1));
      const bool is_any = is_item && kind4 == K_ANY;
      n_idx += (is_gc || (is_item && (kind4 == K_DELETED || kind4 == K_ANY || kind4 == K_JSON)));
      const bool one_any = is_item && (kind4 == K_EMBED || kind4 == K_FORMAT || kind4 == K_DOC);
      const int any_cnt = is_any ? len_at : (one_any ? 1 : 0);
      ln.at(O.anyc + j) = any_cnt;
      skips += is_skip;
      ln.at(O.skipi + j) = skips;
      if (any_cnt > 0 || (is_item && (kind4 == K_BINARY || kind4 == K_MOVE))) has_content = true;
    }
  }
  auto skips_upto = [&](int n) { return n > 0 ? ln.at(O.skipi + clampi(n - 1, 0, NB - 1)) : 0; };

  phase_end(clk, 3);
  // ---- the rest stream: slots v / vst / vovf [NV], n_varints. Slots from
  // `tail` on are all (tail_v, tail_vst, tail_ovf), held in registers.
  const int rest_start = sp[SP_REST][0], rest_end = wadd(sp[SP_REST][0], sp[SP_REST][1]);
  int n_varints = 0, tail = NV, tail_v = 0, tail_vst = 0, tail_ovf = 0;
  bool walk_bad = false, deep = false;
  if (!has_content) {
    // bulk parse: varint k ends at the (k + 1)-th byte < 0x80 of the
    // region, found 8 bytes at a time; a slot reads its first five bytes
    // unmasked by the region's end (a window whose end is past any)
    constexpr int NO_END = 0x7FFFFFFF;
    auto slot_of = [&](int st, int tp, int& v, int& ovf) {
      const int nb = clampi(tp - st + 1, 1, 10);
      u64 lo, hi;
      ln.window(st, NO_END, lo, hi);
      const u64 x = nb < 5 ? lo & ((1ull << (8 * nb)) - 1) : lo;
      v = (int)(u32)((x & 0x7F) | ((x >> 1) & (0x7Full << 7)) | ((x >> 2) & (0x7Full << 14)) |
                     ((x >> 3) & (0x7Full << 21)) | ((x >> 4) & (0x7Full << 28)));
      ovf = nb > 5 || (nb == 5 && ((lo >> 32) & 0x7F) >= 8);
    };
    auto slot = [&](int k, int st, int tp) {
      int v, ovf;
      slot_of(st, tp, v, ovf);
      ln.at(O.v + k) = v;
      ln.at(O.vst + k) = st;
      ln.at(O.vovf + k) = ovf;
    };
    int k = 0, next = rest_start;
    const int lo = rest_start > 0 ? rest_start : 0, hi = rest_end < L ? rest_end : L;
    for (int j = lo; j < hi; j += 8) {
      u64 w, unused;
      ln.window(j, NO_END, w, unused);
      u64 t = ~w & HIGH_BITS;
      if (hi - j < 8) t &= (1ull << (8 * (hi - j))) - 1;
      for (; t; t &= t - 1) {
        const int tp = j + (__ffsll((long long)t) >> 3) - 1;
        if (k < NV) slot(k, next, tp);
        next = tp + 1;
        ++k;
        ++n_varints;
      }
    }
    // past the last terminator: the first slot starts there, every later
    // one at L + 1, one byte wide (the clamped byte L - 1): the tail
    if (k < NV) slot(k++, next, L);
    if (k < NV) {
      tail = k;
      tail_vst = L + 1;
      slot_of(L + 1, L, tail_v, tail_ovf);
    }
  } else {
    for (int j = 0; j < NB; ++j) {
      ln.at(O.cst + j) = 0;
      ln.at(O.mvf + j) = 0;
      ln.at(O.msc + j) = -1;
      ln.at(O.msk + j) = 0;
      ln.at(O.mec + j) = -1;
      ln.at(O.mek + j) = 0;
    }
    for (int k = 0; k < NV; ++k) {
      ln.at(O.v + k) = 0;
      ln.at(O.vst + k) = 0;
      ln.at(O.vovf + k) = 0;
    }
    // the walker: structural varints to slots, content excised per block
    const int start = rest_start, end = rest_end;
    int pos = end > start ? start : end;
    int st = end > start ? W_NC : W_DONE;
    int vidx = 0, blk = 0, blocks_left = 0, nc_left = 0, depth = 0;
    bool collapsed = false, bad = false;
    int elems[W_DEPTH] = {0, 0, 0, 0}, pairs[W_DEPTH] = {0, 0, 0, 0};
    auto dd = [](int d) { return clampi(d, 0, W_DEPTH - 1); };
    for (int t = 0; t < P.T; ++t) {
      if (!(st != W_DONE && pos <= end)) break;
      u64 wlo, whi;
      ln.window(pos, end, wlo, whi);
      int val, nb, val2, nb2;
      bool ovf, ovf2;
      uvar_of(wlo, whi, val, nb, ovf);
      const int tag = (int)(wlo & 0xFF);
      const bool is_mv = st == W_MVF || st == W_MSC || st == W_MSK || st == W_MEC || st == W_MEK;
      const bool is_var = st == W_NC || st == W_SEC_N || st == W_SEC_CLK || st == W_SKIP || is_mv || st == W_DS;
      const int hashed_val = ovf ? -2 - hash_window(wlo, whi) : val;
      const bool in_any = st == W_ANY, in_mkey = st == W_MKEY, in_mval = st == W_MVAL;
      const bool in_anyval = in_any || in_mval;
      ln.uvar_after(pos, end, wlo, whi, 1, val2, nb2, ovf2);
      int any_extra = 0;
      if (tag == 127 || tag == 126 || tag == 121 || tag == 120) any_extra = 0;
      else if (tag == 125) any_extra = nb2;
      else if (tag == 124) any_extra = 4;
      else if (tag == 123 || tag == 122) any_extra = 8;
      else if (tag == 119 || tag == 116) any_extra = wadd(nb2, val2);
      else if (tag == 117 || tag == 118) any_extra = nb2;
      const bool scalar_tag = tag >= 116 && tag != 117 && tag != 118;
      const bool bad_tag = tag < 116;
      const bool arr_tag = tag == 117 && val2 > 0, map_tag = tag == 118 && val2 > 0;
      const bool scalar_like = scalar_tag || (tag == 118 && val2 == 0) || (tag == 117 && val2 == 0);
      bool push = in_anyval && map_tag;
      const bool deep_bad = (in_anyval && bad_tag) || (push && depth >= W_DEPTH - 1);
      push = push && !deep_bad;
      const int delta = (in_any && scalar_like) ? -1 : (in_any && arr_tag) ? val2 - 1 : (in_mval && arr_tag) ? val2 : 0;
      const int ed2 = wadd(elems[dd(depth)], delta);
      if (in_anyval) elems[dd(depth)] = ed2;
      int depth_n = push ? depth + 1 : depth;
      if (push) {
        pairs[dd(depth_n)] = val2;
        elems[dd(depth_n)] = 0;
      }
      // a finished value completes its pair when no array children remain;
      // a finished map pops and completes one value below it
      bool pair_done = (in_mval && scalar_like) || (in_any && scalar_like && depth >= 1 && ed2 == 0);
      for (int r = 0; r < W_DEPTH && pair_done; ++r) {
        const int pd = wsub(pairs[dd(depth_n)], 1);
        pairs[dd(depth_n)] = pd;
        const bool map_closed = pd <= 0;
        if (map_closed) depth_n -= 1;
        const int e_at = elems[dd(depth_n)];
        const bool dec_nested = map_closed && depth_n >= 1 && e_at > 0;
        const int e_new = dec_nested ? e_at - 1 : e_at;
        if (dec_nested) elems[dd(depth_n)] = e_new;
        if (map_closed && depth_n == 0) elems[0] = wsub(elems[0], 1);
        pair_done = map_closed && depth_n >= 1 && e_new == 0;
      }
      const bool post_any = in_anyval && !deep_bad;
      const int e_top = elems[dd(depth_n)];
      const bool to_mkey = (post_any && depth_n >= 1 && e_top == 0) || push;
      const bool to_any = post_any && ((depth_n >= 1 && e_top > 0) || (depth_n == 0 && elems[0] > 0));
      const bool any_finished = in_anyval && depth_n == 0 && elems[0] <= 0;

      const int consumed = is_var ? nb
                           : in_anyval ? wadd(1, any_extra)
                           : (in_mkey || st == W_BUF) ? wadd(nb, val)
                                                       : 0;
      // Move payload varints are content: parsed per block, no slot
      const bool emit_slot = is_var && !is_mv;
      if (emit_slot) {
        const int sl = clampi(vidx, 0, NV - 1);
        ln.at(O.v + sl) = val;
        ln.at(O.vst + sl) = pos;
        if (ovf) ln.at(O.vovf + sl) = 1;
      }
      const int vidx2 = vidx + (int)emit_slot;
      const bool mv_num_ovf = ovf && (st == W_MVF || st == W_MSK || st == W_MEK);
      const int sblk = clampi(blk, 0, NB - 1);
      if (st == W_MVF) ln.at(O.mvf + sblk) = val;
      if (st == W_MSC) ln.at(O.msc + sblk) = hashed_val;
      if (st == W_MSK) ln.at(O.msk + sblk) = val;
      if (st == W_MEC) ln.at(O.mec + sblk) = hashed_val;
      if (st == W_MEK) ln.at(O.mek + sblk) = val;
      if (deep_bad) deep = true;
      if ((wadd(pos, consumed) > end && consumed > 0) || mv_num_ovf) bad = true;

      const bool collapsed2 = st == W_MVF ? (val & 1) != 0 : collapsed;
      const int binfo = ln.at(O.info + sblk);
      const bool blk_skip = binfo == K_SKIP;
      const int blk_any = ln.at(O.anyc + sblk);
      const bool blk_buf = (binfo & 0x0F) == K_BINARY, blk_move = (binfo & 0x0F) == K_MOVE;
      const bool blk_content = blk_any > 0 || blk_buf || blk_move;
      int nst = st;
      if (st == W_NC) nst = val > 0 ? W_SEC_N : W_DS;
      if (st == W_SEC_N) nst = W_SEC_CLK;
      if (st == W_SEC_CLK) nst = W_BLK;
      const bool sec_done = blocks_left == 0;
      const bool at_blk = st == W_BLK && !sec_done;
      const bool d_skip = at_blk && blk_skip;
      const bool d_any = at_blk && !blk_skip && blk_any > 0;
      const bool d_buf = at_blk && !blk_skip && blk_buf;
      const bool d_move = at_blk && !blk_skip && blk_move;
      const bool d_none = at_blk && !blk_skip && !blk_content;
      if (d_skip) nst = W_SKIP;
      if (d_any) nst = W_ANY;
      if (d_buf) nst = W_BUF;
      if (d_move) nst = W_MVF;
      if (st == W_BLK && sec_done) nst = nc_left > 1 ? W_SEC_N : W_DS;
      if (d_any || d_buf || d_move) ln.at(O.cst + sblk) = pos;
      const bool fin = st == W_SKIP || any_finished || st == W_BUF || (st == W_MSK && collapsed2) || st == W_MEK;
      if (st == W_MVF) nst = W_MSC;
      if (st == W_MSC) nst = W_MSK;
      if (st == W_MSK && !collapsed2) nst = W_MEC;
      if (st == W_MEC) nst = W_MEK;
      if (to_mkey) nst = W_MKEY;
      if (to_any) nst = W_ANY;
      if (in_mkey) nst = W_MVAL;
      if (fin) nst = W_BLK;
      if (st == W_DS && wadd(pos, consumed) >= end) nst = W_DONE;

      const int adv_blk = (int)(d_none || fin);
      blk += adv_blk;
      blocks_left = st == W_SEC_N ? val : wsub(blocks_left, adv_blk);
      nc_left = wsub(st == W_NC ? val : nc_left, (int)(st == W_BLK && sec_done));
      if (d_any) {
        elems[0] = blk_any;
        for (int d = 1; d < W_DEPTH; ++d) elems[d] = 0;
        for (int d = 0; d < W_DEPTH; ++d) pairs[d] = 0;
        depth = 0;
      } else {
        depth = depth_n;
      }
      pos = wadd(pos, consumed);
      st = nst;
      vidx = vidx2;
      collapsed = collapsed2;
    }
    if (st != W_DONE && end > start) bad = true;
    n_varints = vidx;
    walk_bad = bad;
  }

  // slot reads of the vector version: the value, and whether a used
  // position is past the parsed varints or overflowed
  auto slot_v = [&](int c) { return c < tail ? ln.at(O.v + c) : tail_v; };
  auto slot_ovf = [&](int c) { return c < tail ? ln.at(O.vovf + c) : tail_ovf; };
  auto vat = [&](int idx, bool used, bool& bad) {
    const int c = clampi(idx, 0, NV - 1);
    if (used && (idx >= n_varints || idx >= NV || slot_ovf(c))) bad = true;
    return slot_v(c);
  };
  // a client-id slot: beyond i32, -2 - the hash of its wire bytes
  auto vat_id = [&](int idx, bool used, bool& bad) {
    const int c = clampi(idx, 0, NV - 1);
    if (used && (idx >= n_varints || idx >= NV)) bad = true;
    if (!slot_ovf(c)) return slot_v(c);
    u64 lo, hi;
    ln.window(c < tail ? ln.at(O.vst + c) : tail_vst, 0x7FFFFFFF, lo, hi);
    return -2 - hash_window(lo, hi);
  };

  const int nc = slot_v(0);
  bool malformed = len_s > 0 && n_varints < 1;
  if (nc > 1) fl |= FLAG_MULTI_CLIENT;
  const bool sec_ovf = nc > SEC;

  phase_end(clk, 4);
  // ---- section walk; `mono`: every section starts at or after the one
  // before it (a wrapped block count can break that)
  int total_blocks = 0;
  bool mono = true;
  {
    int vidx = 1, base = 0;
    bool unused = false;
    for (int i = 0; i < SEC; ++i) {
      if (i < nc) {
        const int nb_i = vat(vidx, true, unused);
        ln.at(O.sech + i) = vidx;
        ln.at(O.secb + i) = base;
        const int nxt = clampi(wadd(base, nb_i), 0, NB);
        if (nxt < base) mono = false;
        vidx = wadd(wadd(vidx, 2), skips_upto(nxt) - skips_upto(base));
        base = nxt;
      } else {
        ln.at(O.sech + i) = -1;
        ln.at(O.secb + i) = NB;
      }
    }
    total_blocks = base;
  }
  const bool blk_ovf = total_blocks > NB || total_blocks > info_n || sec_ovf;

  phase_end(clk, 5);
  // ---- per-block pass B: block lengths, their prefix sums and the rows,
  // over the valid blocks [0, total_blocks) (a block past them has length
  // 0 and no effect). A block's clock reads the length prefix at its
  // section's first block; where sections are not in order that block can
  // come later, even past the valid ones, so a first round (no rows, no
  // counts) sums every block's length before the round that emits.
  bool bad_v1 = false, bad_v2 = false, unsupported = deep && has_content, key_too_long = false,
       side_bad = false, row_ovf = false, neg_len = false;
  int need_cli = 0, need_lc = 0, need_rc = 0, need_len = 0, need_str = 0, need_pi = 0, need_tr = 0;
  bool any_cold = false;
  int emit_idx = 0;
  const i64 SU = (i64)S * U;
  for (int round = mono ? 1 : 0; round < 2; ++round) {
    const bool last = round == 1;
    int pi_idx = 0, c_base = 0, l_idx = 0, r_idx = 0, n_idx = 0, tr_idx = 0, s_base = 0, cum_skip = 0, len_psum = 0,
        cold_rank = 0;
    emit_idx = 0;
    for (int j = 0; j < total_blocks; ++j) {
      const int info = ln.at(O.info + j);
      const bool is_gc = info == 0, is_skip = info == K_SKIP, is_item = !is_gc && !is_skip;
      const int kind4 = info & 0x0F;
      const bool has_o = is_item && (info & 0x80), has_r = is_item && (info & 0x40);
      const bool cant_copy = is_item && !has_o && !has_r;
      const bool has_psub = cant_copy && (info & 0x20);
      const int pi = ln.at(O.pi + clampi(pi_idx, 0, NB - 1));
      const bool is_root = cant_copy && pi == 1, is_nested = cant_copy && pi != 1;
      const int c_cnt = (int)has_o + (int)has_r + (int)is_nested;
      const bool l_cnt = has_o || is_nested;
      const bool is_str = is_item && kind4 == K_STRING, is_del = is_item && kind4 == K_DELETED;
      const bool is_any = is_item && kind4 == K_ANY, is_json = is_item && kind4 == K_JSON;
      const bool is_bin = is_item && kind4 == K_BINARY, is_embed = is_item && kind4 == K_EMBED;
      const bool is_format = is_item && kind4 == K_FORMAT, is_type = is_item && kind4 == K_TYPE;
      const bool is_doc = is_item && kind4 == K_DOC, is_move = is_item && kind4 == K_MOVE;
      const bool n_cnt = is_gc || is_del || is_any || is_json;
      const int len_at = ln.at(O.len + clampi(n_idx, 0, NB - 1));
      const int tr_tag = ln.at(O.tr + clampi(tr_idx, 0, NB - 1));
      const bool type_named = is_type && (tr_tag == 3 || tr_tag == 5);
      const bool type_weak = is_type && tr_tag >= 7;
      const int s_cnt = wadd((int)is_root + (int)has_psub + (int)is_str + (int)is_format + (int)type_named,
                             is_json ? len_at : 0);

      // the section of block j: the last one whose first block is <= j
      int cnt = 0;
      for (int i = 0; i < SEC; ++i) cnt += ln.at(O.secb + i) <= j;
      const int sec_id = clampi(cnt - 1, 0, SEC - 1);
      const int blk_h = ln.at(O.sech + sec_id), secbase = clampi(ln.at(O.secb + sec_id), 0, NB - 1);
      const int skips_base = ln.at(O.skipi + secbase) - (ln.at(O.info + secbase) == K_SKIP);
      const int skip_vidx = wadd(wadd(blk_h, 2), cum_skip - skips_base);
      const int skip_len = vat(clampi(skip_vidx, 0, NV - 1), is_skip, bad_v2);

      const int blk_len = is_str ? ln.at(O.str16 + clampi(wadd(wadd(s_base, is_root), has_psub), 0, NS - 1))
                        : n_cnt  ? len_at
                        : is_skip ? skip_len
                        : is_item ? 1
                                  : 0;
      ln.at(O.lpsum + j) = len_psum;

      const bool cold = is_json || is_embed || is_format || (is_type && !type_weak);
      const bool emit = !is_skip && blk_len > 0;
      if (last) {
        const int sec_clk = vat(clampi(blk_h, 0, NV - 1) + 1, blk_h >= 0, bad_v1);
        need_cli += c_cnt;
        need_lc += l_cnt;
        need_rc += has_r;
        need_len += n_cnt;
        need_str = wadd(need_str, s_cnt);
        need_pi += cant_copy;
        need_tr += is_type;
        if (is_doc || type_weak) unsupported = true;
        if (blk_len < 0) neg_len = true;
        if (cold) any_cold = true;
        i64 ref_cold = -1;
        if (P.n_side >= 0) {
          const int NC2 = P.n_side;
          const int cold_off = NC2 > 0 ? __ldg(P.side + (i64)s * NC2 + clampi(cold_rank, 0, NC2 - 1)) : -1;
          if (cold && (cold_rank >= NC2 || cold_off < 0)) side_bad = true;
          ref_cold = lane_ref + cold_off;
        }
        const int psub_idx = wadd(s_base, is_root), content_sidx = wadd(psub_idx, has_psub);
        const int psub_c = clampi(psub_idx, 0, NS - 1);
        const int psub_bytes = str_bytes(psub_c);
        if (has_psub && psub_bytes > KEY_HASH_BYTES) key_too_long = true;

        if (emit && emit_idx >= U) row_ovf = true;
        if (emit && emit_idx < U) {
          // the row, resolved through the intern tables as it is written
          int* o = P.rows + (i64)s * U + emit_idx;
          const int blk_cli_base = sec_id + 1 + c_base;
          const int lc = ln.at(O.lc + clampi(l_idx, 0, NB - 1));
          const int clock = wsub(wadd(sec_clk, len_psum), ln.at(O.lpsum + secbase));
          const int rbytes = str_bytes(clampi(s_base, 0, NS - 1));
          i64 ref;
          if (is_str)
            ref = lane_ref + ln.at(O.strst + clampi(content_sidx, 0, NS - 1));
          else if (is_any || is_bin || is_move)
            ref = lane_ref + ln.at(O.cst + j);
          else
            ref = cold ? ref_cold : -1;
          const int mvf = is_move ? ln.at(O.mvf + j) : 0;
          const bool collapsed = (mvf & 1) != 0;
          const int ptag = is_root ? 1 : (is_nested ? 2 : 0);
          const i64 keyh = has_psub ? name_hash(ln, ln.at(O.strst + psub_c), psub_bytes) : -1;
          const i64 rooth =
              is_root ? (rbytes <= KEY_HASH_BYTES ? name_hash(ln, ln.at(O.strst + clampi(s_base, 0, NS - 1)), rbytes)
                                                  : -2)
                      : -1;
          o[F_CLIENT * SU] = (int)resolve_id(P, ln.at(O.cli + clampi(sec_id + ln.at(O.cbase + secbase), 0, NCLI - 1)), fl);
          o[F_CLOCK * SU] = clock;
          o[F_LENGTH * SU] = blk_len;
          o[F_OCLIENT * SU] = (int)resolve_id(P, has_o ? ln.at(O.cli + clampi(blk_cli_base, 0, NCLI - 1)) : -1, fl);
          o[F_OCLOCK * SU] = has_o ? lc : 0;
          o[F_RCLIENT * SU] =
              (int)resolve_id(P, has_r ? ln.at(O.cli + clampi(blk_cli_base + (int)has_o, 0, NCLI - 1)) : -1, fl);
          o[F_RCLOCK * SU] = has_r ? ln.at(O.rc + clampi(r_idx, 0, NB - 1)) : 0;
          o[F_KIND * SU] = is_gc ? 0 : kind4;
          o[F_REF * SU] = (int)ref;
          o[F_COFF * SU] = 0;
          o[F_KEY * SU] = (int)resolve_key(P, keyh, fl);
          o[F_PTAG * SU] = ptag;
          o[F_PCLIENT * SU] = (int)resolve_id(P, is_nested ? ln.at(O.cli + clampi(blk_cli_base, 0, NCLI - 1)) : -1, fl);
          o[F_PCLOCK * SU] = is_nested ? lc : 0;
          o[F_PROOT * SU] = (int)resolve_root(P, ptag, rooth, prim, fl);
          // ContentMove range fields: assoc 0 = After, -1 = Before; a
          // collapsed move's end id is its start id
          o[F_MSC * SU] = (int)resolve_id(P, is_move ? ln.at(O.msc + j) : -1, fl);
          o[F_MSK * SU] = is_move ? ln.at(O.msk + j) : 0;
          o[F_MSA * SU] = is_move ? ((mvf & 2) ? 0 : -1) : 0;
          o[F_MEC * SU] = (int)resolve_id(P, is_move ? (collapsed ? ln.at(O.msc + j) : ln.at(O.mec + j)) : -1, fl);
          o[F_MEK * SU] = is_move ? (collapsed ? ln.at(O.msk + j) : ln.at(O.mek + j)) : 0;
          o[F_MEA * SU] = is_move ? ((mvf & 4) ? 0 : -1) : 0;
          o[F_MPRIO * SU] = is_move ? (mvf >> 6) : -1;
        }
      }
      emit_idx += emit;
      cold_rank += cold;
      len_psum = wadd(len_psum, blk_len);
      pi_idx += cant_copy;
      c_base += c_cnt;
      l_idx += l_cnt;
      r_idx += has_r;
      n_idx += n_cnt;
      tr_idx += is_type;
      s_base = wadd(s_base, s_cnt);
      cum_skip += is_skip;
    }
    for (int j = total_blocks; j < NB && !last; ++j) ln.at(O.lpsum + j) = len_psum;
  }
  n_rows = emit_idx < U ? emit_idx : U;
  if (P.n_side < 0 && any_cold) unsupported = true;  // no sidecar: cold payloads unaddressable
  if (key_too_long) unsupported = true;
  const bool consumption_ovf = ln.at(O.cbase + NB - 1) + 3 > NCLI || total_blocks > NB;
  need_cli += nc < SEC ? nc : SEC;
  const bool truncated = need_cli > cli_n || need_lc > lc_n || need_rc > rc_n || need_len > len_n ||
                         need_str > str_n || need_pi > pi_n || need_tr > tr_n;
  const bool str_cap_ovf = need_str > NS;

  phase_end(clk, 6);
  // ---- delete set: range m of a section goes to slot out_base + m; the
  // slots written are always [0, n_dels), and a later section can rewrite
  // one (a run count that wrapped), so the clients resolve after the last
  const i64 SR = (i64)S * R, del0 = (i64)s * R;
  bool bad_v3 = false, ds_bad = false, ds_ovf = false;
  const int d0 = wadd(wadd(1, wmul(2, nc < SEC ? nc : SEC)), skips_upto(total_blocks));
  const int ds_n = vat(d0, len_s > 0 && !frame_bad, bad_v3);
  n_dels = 0;
  {
    int p = wadd(d0, 1), out_base = 0;
    for (int k = 0; k < DSEC; ++k) {
      if (!(k < ds_n)) continue;
      const int cli = vat_id(p, true, ds_bad);
      const int nr = vat(wadd(p, 1), true, ds_bad);
      int cum_d = 0, cum_l = 0;
      for (int m = 0; m < R && m < nr; ++m) {
        const int dv = vat(wadd(wadd(p, 2), 2 * m), true, ds_bad);
        const int lv = wadd(vat(wadd(wadd(p, 3), 2 * m), true, ds_bad), 1);  // write_ds_len stores length - 1
        cum_d = wadd(cum_d, dv);
        const int clock = wadd(cum_d, cum_l);
        cum_l = wadd(cum_l, lv);
        const int o = out_base + m;
        if (o < R) {
          P.dels[D_CLIENT * SR + del0 + o] = cli;
          P.dels[D_START * SR + del0 + o] = clock;
          P.dels[D_END * SR + del0 + o] = wadd(clock, lv);
          if (o >= n_dels) n_dels = o + 1;
        }
      }
      if (wadd(out_base, nr) > R) ds_ovf = true;
      p = wadd(p, wadd(2, wmul(2, nr)));
      out_base = clampi(wadd(out_base, nr), 0, R);
    }
  }
  for (int o = 0; o < n_dels; ++o) {
    int* c = P.dels + D_CLIENT * SR + del0 + o;
    *c = (int)resolve_id(P, *c, fl);
  }
  const bool ds_sec_ovf = ds_n > DSEC;

  malformed = malformed || frame_bad || bad_v1 || bad_v2 || bad_v3 || ds_bad || truncated ||
              (walk_bad && has_content) || side_bad || neg_len;
  if (malformed) fl |= FLAG_MALFORMED;
  if (unsupported) fl |= FLAG_UNSUPPORTED;
  if (blk_ovf || row_ovf || consumption_ovf || ds_ovf || ds_sec_ovf || str_cap_ovf) fl |= FLAG_OVERFLOW;
  phase_end(clk, 7);
  phase_flush(clk);
  flags = fl;
}

__global__ void __launch_bounds__(THREADS) decode_v2_kernel(const Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const int s0 = blockIdx.x * THREADS;
  const int s = s0 + lane;
  const int nw = P.S - s0 < THREADS ? P.S - s0 : THREADS;  // lanes of this warp
  i64 ignored = 0;
  const int client0 = (int)resolve_id(P, 0, ignored);
  int n_rows = 0, n_dels = 0;
  i64 flags = 0;
  if (s < P.S) {
    // the lane's expansion arrays: its column of the CTA's [word][lane]
    // block, in shared memory or in the device-memory scratch
    const i64 block = (i64)layout(P.U, P.R, P.SEC).words * THREADS;
    int* sc = (P.scratch != nullptr ? P.scratch + blockIdx.x * block : (int*)smem) + lane;
    decode_lane(P, s, sc, n_rows, n_dels, flags);
    P.flags[s] = (int)flags;
  }
  const bool lane_ok = (flags & FLAG_ERRORS) == 0;

  // the rows and ranges each lane did not emit hold the defaults, and every
  // valid byte is set here, the warp's block [s0, s0 + nw) x U (x R) word
  // by word: lane r's counts and whether it ended clean come from lane r by
  // shuffle (-n - 1: n written, the lane in error)
  const int U = P.U, R = P.R;
  const i64 SU = (i64)P.S * U, SR = (i64)P.S * R;
  const int rcode = lane_ok ? n_rows : -n_rows - 1, dcode = lane_ok ? n_dels : -n_dels - 1;
  for (int base = 0; base < nw * U; base += THREADS) {
    const int i = base + lane;
    const int r = i / U < THREADS ? i / U : THREADS - 1;
    const int n = __shfl_sync(FULL_MASK, rcode, r);
    if (i < nw * U) {
      const int j = i - r * U, nr = n < 0 ? -n - 1 : n;
      const i64 o = (i64)s0 * U + i;
      if (j >= nr)
        for (int f = 0; f < ROW_FIELDS; ++f) P.rows[f * SU + o] = row_default(f, client0);
      P.rvalid[o] = j < n;
    }
  }
  for (int base = 0; base < nw * R; base += THREADS) {
    const int i = base + lane;
    const int r = i / R < THREADS ? i / R : THREADS - 1;
    const int d = __shfl_sync(FULL_MASK, dcode, r);
    if (i < nw * R) {
      const int j = i - r * R, nd = d < 0 ? -d - 1 : d;
      const i64 o = (i64)s0 * R + i;
      if (j >= nd) {
        P.dels[D_CLIENT * SR + o] = client0;
        P.dels[D_START * SR + o] = 0;
        P.dels[D_END * SR + o] = 0;
      }
      P.dvalid[o] = j < d;
    }
  }
}

}  // namespace

// Expansion words a lane needs in the device-memory scratch (times S
// rounded up to whole CTAs of THREADS lanes), or 0 where its CTA's arrays
// fit in shared memory and the launch needs none.
extern "C" int ytpu_decode_v2_scratch_words(int U, int R, int SEC) {
  return smem_bytes(U, R, SEC) > 0 ? 0 : layout(U, R, SEC).words;
}

// Expansion words a lane has on either path.
extern "C" int ytpu_decode_v2_words(int U, int R, int SEC) { return layout(U, R, SEC).words; }

// The launch's arguments, one int64 each (pointers as their addresses), in
// the order of decode_v2._LAUNCH_ARGS: the host passes one array.
struct DecodeV2Args {
  i64 raw, n_raw, offs, rlens, lens, spans, side, n_side, S, L, U, R, SEC;
  i64 ct_keys, ct_perm, ct_n, cht_keys, cht_perm, cht_n, kt_keys, kt_perm, kt_n, prim, n_prim;
  i64 rows, dels, flags, rvalid, dvalid, scratch, stream;
};

// One launch on `stream` over S lanes. `raw` holds n_raw bytes: the arena
// with `offs` and `rlens` [S], or, with both 0, the [S, L] matrix. lens
// [S], spans [S, 12, 2] (16-byte aligned), the sidecar [S, n_side] (n_side
// -1: none), each table's keys and perm (n < 0: no table), prim [n_prim]
// or 0; all int32. Writes rows [22, S, U] and dels [3, S, R] int32, rvalid
// [S, U] and dvalid [S, R] bytes and flags [S] int32; `scratch`
// (ytpu_decode_v2_scratch_words(U, R, SEC) int32 a lane, S rounded up to
// a multiple of 32) only where that is
// not 0. Returns the launch's cudaError_t (0 when it was queued).
extern "C" int ytpu_decode_v2(const DecodeV2Args* a) {
  if (a->S <= 0) return 0;
  auto ptr = [](i64 x) { return (void*)(uintptr_t)x; };
  Params P;
  P.raw = (const uint8_t*)ptr(a->raw);
  P.n_raw = a->n_raw;
  P.offs = (const int*)ptr(a->offs);
  P.rlens = (const int*)ptr(a->rlens);
  P.lens = (const int*)ptr(a->lens);
  P.spans = (const int*)ptr(a->spans);
  P.side = (const int*)ptr(a->side);
  P.n_side = (int)a->n_side;
  P.S = (int)a->S;
  P.L = (int)a->L;
  P.U = (int)a->U;
  P.R = (int)a->R;
  P.SEC = (int)a->SEC;
  P.NB = P.U + 8;
  P.DSEC = P.R + 4;
  P.NV = 2 + 2 * P.SEC + P.NB + 2 * P.DSEC + 2 * P.R;
  P.NS = 2 * P.U + 4;
  P.NCLI = 3 * P.NB + P.SEC + 2;
  P.T = P.NV + 3 * P.NB + 8 * (P.NB / 2 > 1 ? P.NB / 2 : 1) + 16;
  auto table = [&](i64 keys, i64 perm, i64 n) { return Table{(const int*)ptr(keys), (const int*)ptr(perm), n}; };
  P.ct = table(a->ct_keys, a->ct_perm, a->ct_n);
  P.cht = table(a->cht_keys, a->cht_perm, a->cht_n);
  P.kt = table(a->kt_keys, a->kt_perm, a->kt_n);
  P.prim = (const int*)ptr(a->prim);
  P.n_prim = a->n_prim;
  P.rows = (int*)ptr(a->rows);
  P.dels = (int*)ptr(a->dels);
  P.flags = (int*)ptr(a->flags);
  P.rvalid = (uint8_t*)ptr(a->rvalid);
  P.dvalid = (uint8_t*)ptr(a->dvalid);
  P.scratch = (int*)ptr(a->scratch);
  const int smem = smem_bytes(P.U, P.R, P.SEC);
  if (smem > 0) {
    P.scratch = nullptr;
    const cudaError_t e = cudaFuncSetAttribute(decode_v2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  } else if (P.scratch == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = (P.S + THREADS - 1) / THREADS;
  void* stream = ptr(a->stream);
  decode_v2_kernel<<<blocks, THREADS, (size_t)smem, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

#ifdef YTPU_DECODE_V2_PROFILE
// The profiling build's cycle sums, one a phase, copied to `out` (host
// memory), then set to 0 where `reset` is not 0. Synchronous.
extern "C" int ytpu_decode_v2_phase_cycles(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(g_phase_cycles));
  if (e == cudaSuccess && reset) {
    const unsigned long long zero[PHASES] = {};
    e = cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
  }
  return (int)e;
}
#endif

extern "C" const char* ytpu_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
