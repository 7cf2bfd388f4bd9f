// The lib0 / Yjs V1 update decode as one hand-written Hopper program:
// ytpu_torch.ops.decode_kernel.decode_updates_v1 on CUDA tensors, from the
// wire bytes to the int32 UpdateBatch and the lane flags in one launch.
//
// Replaces: ytpu/ops/decode_kernel.py:379 `decode_updates_v1`, one jitted
// XLA program: the `fori_loop` (:1038) that moves every update lane through
// one state of a 41-state machine per iteration, all lanes in lockstep as
// [S]-wide vector ops, then `_resolve_and_pack` (:1047), which looks the
// ids, key hashes and root names up in the intern tables and packs the
// int32 UpdateBatch. XLA needs the lockstep; the card does not. Here each
// lane is one thread that walks its own bytes until it reaches DONE or ERR
// or has taken T steps (a lane that has stopped changes nothing in the
// lockstep loop, so stopping early gives the same result), resolves each
// row's ids as it emits the row, and the warp writes the rows out.
//
// What it computes, for lane s of S: the 27 UpdateBatch fields (22 int32
// row planes [S, U] in UpdateBatch order with the valid bytes [S, U], 3
// int32 delete planes [S, R] with their valid bytes [S, R]) and the lane's
// int32 flags [S], bit for bit what the plain composition gives:
// `gather_raw_lanes` -> `_decode_loop_reference` -> `_resolve_and_pack`.
//
// The lane's bytes: in the arena (`offs` given) byte j of lane s is
// raw[clamp(offs[s] + clamp(j, 0, L - 1), 0, RC - 1)]: what the gathered
// [S, L] matrix holds, except that the gather also zeroes bytes at
// clamp(j) >= lens[s]. That mask is implied by the machine's own: only the
// varint window ever reads at or past lens, and it is masked by lens (a
// string, key or span that would run past lens makes the step `bad`, and a
// bad step reads nothing else). A [S, L] matrix is the arena with
// offs[s] = s * L, read as it is (ytpu reads the matrix it is given).
//
// Semantics kept bit for bit with the plain loop:
//   * the step budget T is part of the result (a lane still parsing after
//     T steps ends FLAG_MALFORMED);
//   * row and delete overflow set FLAG_OVERFLOW and the lane parses on;
//   * reads clamp their index into [0, L - 1] and do not zero it; only the
//     10-byte varint window is masked by lens, the 32-byte key-hash window
//     by i < v alone, and the UTF-16 span clamps its ends to [0, L];
//   * a `bad` lane goes to ERR without moving its cursor or any register;
//     an unsupported one goes to ERR after the step's other updates;
//   * varint values, the any-value length and the clock wrap to 32 bits;
//     the hashes multiply in uint64 (torch wraps int64 silently, C does
//     not), a client id beyond i32 becomes -2 - its byte hash, and a
//     content ref is s * L + byte offset in int64 before the int32 cast;
// and with `_resolve_and_pack`:
//   * ids (the six id columns and the delete client) go through the raw
//     client table, then ids <= -2 through the client-hash table: an empty
//     raw table flags FLAG_UNKNOWN_CLIENT for raw ids (>= 0) and leaves them
//     raw; a raw miss is -1 and flags it; no hash table flags
//     FLAG_BIG_CLIENT, a hash miss FLAG_UNKNOWN_CLIENT;
//   * a key hash >= 0 goes through the key table, a miss (or no table)
//     flags FLAG_UNKNOWN_KEY; a named root equal to the lane's primary maps
//     to p_root -1, another name through the key table (a miss flags
//     FLAG_UNKNOWN_KEY), a name past the hash window FLAG_UNSUPPORTED;
//   * only emitted rows raise flags; rows not emitted hold the resolved
//     defaults (client and delete client are the resolved id 0);
//   * a lane whose flags hold an error loses the valid bits of all its
//     rows and ranges (their values stay).
//
// Design for the card. The parse is a serial chain of dependent steps, so
// one thread still owns one lane, and a lane's time is its steps times
// the latency of one. A step runs only its own state's code (a switch):
// the plain loop computes every state's update in every lane and keeps
// one, which in one thread costs 1.2-1.7 us a step on the card. The CTA is one warp (32 threads), so a B4 chunk's
// 8,192 lanes make 256 CTAs on 132 SMs. The varint window is two aligned
// 16-byte loads from the arena at most, masked by lens in registers, and
// summed in uint32 (its value wraps to 32 bits); the UTF-16 count of a
// string runs over 16-byte words with population counts. Each id is resolved when its row is emitted, by a
// binary search over the sorted table keys (read-only loads); the flags
// are ORed in registers. Output is int32, half the bytes of the pre-resolve
// int64 planes. A warp's 32 lanes own a contiguous 32 x U block of every
// [S, U] plane (32 x R of every [S, R] plane): where that block's stage
// fits in STAGE_MAX_BYTES of shared memory (89 U + 13 R <= 1,536 bytes a
// lane: the B4 chunks, the ingest and sync-server rounds), the warp fills the stage with the
// defaults, each thread writes its emitted rows there and clears its own
// valid bytes if its lane ended in error, and the warp copies the stage
// out with neighbouring threads on neighbouring words. Past that (whole
// state updates with thousands of rows) each thread stores its emitted
// rows directly, and the warp then fills the rows its lanes did not emit
// and every valid byte together, each lane's row count and error shared
// through shuffles. No second pass and no atomics.
//
// Bound: bytes. A lane's wire bytes, offset and length are read once, each
// table once, and the 27 fields, their valid bytes and the flags written
// once (chip_smoke.py's `decode` phase counts them). The parse's chain of
// dependent loads keeps a short lane far above that bound: it is latency,
// not bandwidth, that a B4 chunk's ~11 steps a lane spend.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libdecode.so decode.cu
// tests/_emulated_decode.py builds it with g++ against tests/cuda_host (a
// host emulator of CUDA) and holds it to the plain composition on the CPU.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

typedef long long i64;
typedef unsigned int u32;
typedef unsigned long long u64;

enum State : int {
  ST_NCLIENTS,
  ST_NBLOCKS,
  ST_CLIENT,
  ST_CLOCK,
  ST_INFO,
  ST_ORIGIN_C,
  ST_ORIGIN_K,
  ST_ROR_C,
  ST_ROR_K,
  ST_PARENT_INFO,
  ST_PARENT_NAME,
  ST_PARENT_ID_C,
  ST_PARENT_ID_K,
  ST_PARENT_SUB,
  ST_DEL_LEN,
  ST_GC_LEN,
  ST_SKIP_LEN,
  ST_STR,
  ST_DS_NCLIENTS,
  ST_DS_CLIENT,
  ST_DS_NRANGES,
  ST_DS_CLOCK,
  ST_DS_LEN,
  ST_ANY_COUNT,
  ST_ANY_VAL,
  ST_JSON_COUNT,
  ST_JSON_VAL,
  ST_SPAN1,
  ST_FMT_KEY,
  ST_FMT_VAL,
  ST_TYPE_TAG,
  ST_TYPE_NAME,
  ST_MV_FLAGS,
  ST_MV_SC,
  ST_MV_SK,
  ST_MV_EC,
  ST_MV_EK,
  ST_ANY_MKEY,
  ST_ANY_MVAL,
  ST_DONE,
  ST_ERR,
};

constexpr i64 FLAG_UNSUPPORTED = 1;
constexpr i64 FLAG_OVERFLOW = 2;
constexpr i64 FLAG_MALFORMED = 4;
constexpr i64 FLAG_BIG_CLIENT = 8;
constexpr i64 FLAG_MULTI_CLIENT = 16;
constexpr i64 FLAG_UNKNOWN_CLIENT = 32;
constexpr i64 FLAG_UNKNOWN_KEY = 64;
constexpr i64 FLAG_ERRORS =
    FLAG_UNSUPPORTED | FLAG_OVERFLOW | FLAG_MALFORMED | FLAG_BIG_CLIENT | FLAG_UNKNOWN_CLIENT | FLAG_UNKNOWN_KEY;

constexpr int KEY_HASH_BYTES = 32;
constexpr u32 HASH_MUL = 2654435761u;

// block kinds (ytpu_torch/core/content.py)
constexpr i64 BLOCK_GC = 0;
constexpr i64 CONTENT_DELETED = 1;
constexpr i64 CONTENT_JSON = 2;
constexpr i64 CONTENT_BINARY = 3;
constexpr i64 CONTENT_STRING = 4;
constexpr i64 CONTENT_EMBED = 5;
constexpr i64 CONTENT_FORMAT = 6;
constexpr i64 CONTENT_TYPE = 7;
constexpr i64 CONTENT_ANY = 8;
constexpr i64 BLOCK_SKIP = 10;
constexpr i64 CONTENT_MOVE = 11;

// the int32 row planes, in UpdateBatch order, and the delete planes
enum RowField : int {
  F_CLIENT, F_CLOCK, F_LENGTH, F_OCLIENT, F_OCLOCK, F_RCLIENT, F_RCLOCK, F_KIND, F_REF, F_COFF, F_KEY,
  F_PTAG, F_PCLIENT, F_PCLOCK, F_PROOT, F_MSC, F_MSK, F_MSA, F_MEC, F_MEK, F_MEA, F_MPRIO, ROW_FIELDS
};
enum DelField : int { D_CLIENT, D_START, D_END, DEL_FIELDS };

constexpr int THREADS = 32;  // one warp a CTA
constexpr unsigned FULL_MASK = 0xFFFFFFFFu;
// the largest per-warp stage of shared memory; above it rows go straight
// to device memory (48 KB needs no opt-in attribute)
constexpr int STAGE_MAX_BYTES = 48 * 1024;

// a sorted (keys, perm) intern table; n < 0: no table
struct Table {
  const int* keys;
  const int* perm;
  i64 n;
};

struct Params {
  const uint8_t* raw;  // the arena (or the matrix, row-major)
  i64 n_raw;
  const int* offs;  // [S] lane offsets into raw; null: the matrix, offs[s] = s * L
  const int* lens;  // [S]
  int S, L, U, R, T;
  i64 max_sec;
  Table ct, cht, kt;  // raw clients, client hashes, key hashes
  const int* prim;    // [S] or [1] primary root hash, -1 = single root; null: none
  i64 n_prim;
  int* rows;  // [ROW_FIELDS, S, U]
  int* dels;  // [DEL_FIELDS, S, R]
  int* flags;  // [S]
  int* steps;  // [S] or null
  uint8_t* rvalid;  // [S, U]
  uint8_t* dvalid;  // [S, R]
  bool stage;
};

__device__ __forceinline__ i64 wrap32(i64 x) {
  x &= 0xFFFFFFFFll;
  return x >= (1ll << 31) ? x - (1ll << 32) : x;
}

__device__ __forceinline__ i64 clamp_idx(i64 i, i64 hi) { return i < 0 ? 0 : (i > hi ? hi : i); }

// torch.searchsorted (left) over the sorted keys, clamped into the table:
// true and the perm entry there when that key equals x
__device__ __forceinline__ bool table_find(const Table& t, i64 x, i64& out) {
  i64 lo = 0, hi = t.n;
  while (lo < hi) {
    const i64 mid = (lo + hi) >> 1;
    if (__ldg(t.keys + mid) < x) lo = mid + 1;
    else hi = mid;
  }
  const i64 j = lo < t.n ? lo : t.n - 1;
  if (__ldg(t.keys + j) != x) return false;
  out = __ldg(t.perm + j);
  return true;
}

// an id column's value through the raw client table, then the client-hash
// table; the flags it raises if its row is emitted go into `fl`
__device__ __forceinline__ i64 resolve_id(const Params& P, i64 x, i64& fl) {
  i64 y = x, v = 0;
  if (P.ct.n == 0) {
    if (x >= 0) fl |= FLAG_UNKNOWN_CLIENT;
  } else if (P.ct.n > 0) {
    if (x >= 0 && table_find(P.ct, x, v)) {
      y = v;
    } else {
      if (x >= 0) fl |= FLAG_UNKNOWN_CLIENT;
      y = x <= -2 ? x : -1;
    }
  }
  if (y <= -2) {
    if (P.cht.n <= 0) fl |= FLAG_BIG_CLIENT;
    else if (table_find(P.cht, -2 - y, v)) y = v;
    else fl |= FLAG_UNKNOWN_CLIENT;
  }
  return y;
}

// a parent_sub key hash -> its key index (-1 without a key)
__device__ __forceinline__ i64 resolve_key(const Params& P, i64 keyh, i64& fl) {
  if (keyh < 0) return -1;
  i64 v;
  if (P.kt.n > 0 && table_find(P.kt, keyh, v)) return v;
  fl |= FLAG_UNKNOWN_KEY;
  return -1;
}

// a named root parent -> -1 for the lane's primary root (or no root table),
// else its anchor's key id
__device__ __forceinline__ i64 resolve_root(const Params& P, i64 ptag, i64 rooth, i64 prim, i64& fl) {
  if (P.prim == nullptr || ptag != 1 || prim < 0) return -1;
  i64 r = -1, v;
  if (rooth >= 0 && rooth != prim) {
    if (P.kt.n > 0 && table_find(P.kt, rooth, v)) r = v;
    else fl |= FLAG_UNKNOWN_KEY;
  }
  if (rooth == -2) fl |= FLAG_UNSUPPORTED;
  return r;
}

// the value a row plane holds where no row was emitted
__device__ __forceinline__ int row_default(int f, int client0) {
  switch (f) {
    case F_CLIENT: return client0;
    case F_OCLIENT: case F_RCLIENT: case F_REF: case F_KEY: case F_PCLIENT: case F_PROOT: case F_MSC: case F_MEC: case F_MPRIO:
      return -1;
    default: return 0;
  }
}

// the state after the last pre-content field, from the info byte's kind
__device__ __forceinline__ int content_state(i64 kind4) {
  switch (kind4) {
    case CONTENT_MOVE: return ST_MV_FLAGS;
    case CONTENT_TYPE: return ST_TYPE_TAG;
    case CONTENT_FORMAT: return ST_FMT_KEY;
    case CONTENT_BINARY: return ST_SPAN1;
    case CONTENT_EMBED: return ST_SPAN1;
    case CONTENT_JSON: return ST_JSON_COUNT;
    case CONTENT_ANY: return ST_ANY_COUNT;
    case CONTENT_STRING: return ST_STR;
    case CONTENT_DELETED: return ST_DEL_LEN;
    default: return ST_ERR;
  }
}

// one lane's bytes: byte j is raw[clamp(off + clamp(j, 0, last), 0, rc_last)]
struct Lane {
  const uint8_t* raw;
  i64 off, len, last, rc_last;

  __device__ __forceinline__ u32 at(i64 j) const { return raw[clamp_idx(off + clamp_idx(j, last), rc_last)]; }

  // the 10-byte varint window at `pos`, masked by lens: two aligned 16-byte
  // loads where all ten bytes lie in the lane and the arena, else one byte
  // at a time through the clamps
  __device__ __forceinline__ void window(i64 pos, u32 (&b)[10]) const {
    u64 lo = 0, hi = 0;
    if (pos >= 0 && pos + 9 <= last && off + pos >= 0 && off + pos + 9 <= rc_last) {
      const uintptr_t addr = (uintptr_t)(raw + off + pos);
      const ulonglong2* c = (const ulonglong2*)(addr & ~(uintptr_t)15);
      const int o = (int)(addr & 15);
      const ulonglong2 c0 = __ldg(c);
      const ulonglong2 c1 = o > 6 ? __ldg(c + 1) : make_ulonglong2(0, 0);
      const u64 x0 = o < 8 ? c0.x : c0.y, x1 = o < 8 ? c0.y : c1.x, x2 = o < 8 ? c1.x : c1.y;
      const int sh = (o & 7) * 8;
      lo = sh ? (x0 >> sh) | (x1 << (64 - sh)) : x0;
      hi = sh ? (x1 >> sh) | (x2 << (64 - sh)) : x1;
      const i64 m = len - pos;  // bytes of the window below lens
      if (m < 8) lo = m <= 0 ? 0 : lo & ((1ull << (8 * m)) - 1);
      if (m < 10) hi = m <= 8 ? 0 : hi & 0xFFull;
    } else {
#pragma unroll
      for (int k = 0; k < 10; ++k) {
        const u64 byte = pos + k < len ? at(pos + k) : 0;
        if (k < 8) lo |= byte << (8 * k);
        else hi |= byte << (8 * (k - 8));
      }
    }
#pragma unroll
    for (int k = 0; k < 10; ++k) b[k] = (u32)((k < 8 ? lo >> (8 * k) : hi >> (8 * (k - 8))) & 0xFF);
  }

  // UTF-16 units of lane bytes [lo, hi) (0 <= lo <= hi <= L): a UTF-8 head
  // byte (not 0b10xxxxxx) is one unit, a 4-byte lead (>= 0xF0) one more
  __device__ __forceinline__ i64 utf16_units(i64 lo, i64 hi) const {
    i64 units = 0;
    if (lo >= hi) return 0;
    if (off + lo < 0 || off + hi - 1 > rc_last) {
      for (i64 i = lo; i < hi; ++i) {
        const u32 byte = at(i);
        units += ((byte & 0xC0u) != 0x80u) + (byte >= 0xF0u);
      }
      return units;
    }
    const uint8_t* p = raw + off + lo;
    i64 n = hi - lo;
    for (; n > 0 && ((uintptr_t)p & 15); ++p, --n) units += ((*p & 0xC0u) != 0x80u) + (*p >= 0xF0u);
    constexpr u64 HIGH = 0x8080808080808080ull;
    for (; n >= 16; p += 16, n -= 16) {
      const ulonglong2 w = __ldg((const ulonglong2*)p);
      units += 16 - __popcll(w.x & ~(w.x << 1) & HIGH) - __popcll(w.y & ~(w.y << 1) & HIGH) +
               __popcll(w.x & (w.x << 1) & (w.x << 2) & (w.x << 3) & HIGH) +
               __popcll(w.y & (w.y << 1) & (w.y << 2) & (w.y << 3) & HIGH);
    }
    for (; n > 0; ++p, --n) units += ((*p & 0xC0u) != 0x80u) + (*p >= 0xF0u);
    return units;
  }
};

__global__ void __launch_bounds__(THREADS) decode_v1_kernel(const Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const int s0 = blockIdx.x * THREADS;
  const int s = s0 + lane;
  const bool active = s < P.S;
  const int nw = P.S - s0 < THREADS ? P.S - s0 : THREADS;  // lanes of this warp
  const int U = P.U, R = P.R;
  const i64 SU = (i64)P.S * U, SR = (i64)P.S * R;
  i64 ignored = 0;
  const int client0 = (int)resolve_id(P, 0, ignored);

  // where this lane's rows go: its slice of the warp's stage, or its rows
  // of the planes; field f of row j at rbase[f * rstride + j]
  int* st_rows = (int*)smem;
  int* st_dels = st_rows + ROW_FIELDS * THREADS * U;
  uint8_t* st_rv = (uint8_t*)(st_dels + DEL_FIELDS * THREADS * R);
  uint8_t* st_dv = st_rv + THREADS * U;
  int* rbase;
  int* dbase;
  i64 rstride, dstride;
  if (P.stage) {
    rbase = st_rows + lane * U;
    dbase = st_dels + lane * R;
    rstride = (i64)THREADS * U;
    dstride = (i64)THREADS * R;
    for (int f = 0; f < ROW_FIELDS; ++f) {
      const int v = row_default(f, client0);
      for (int i = lane; i < nw * U; i += THREADS) st_rows[f * THREADS * U + i] = v;
    }
    for (int i = lane; i < nw * U; i += THREADS) st_rv[i] = 0;
    for (int f = 0; f < DEL_FIELDS; ++f) {
      const int v = f == D_CLIENT ? client0 : 0;
      for (int i = lane; i < nw * R; i += THREADS) st_dels[f * THREADS * R + i] = v;
    }
    for (int i = lane; i < nw * R; i += THREADS) st_dv[i] = 0;
    __syncwarp();
  } else {
    rbase = P.rows + (i64)s * U;
    dbase = P.dels + (i64)s * R;
    rstride = SU;
    dstride = SR;
  }

  i64 n_rows = 0, n_dels = 0, flags = 0;
  if (active) {
    const int L = P.L;
    Lane ln;
    ln.raw = P.raw;
    ln.off = P.offs != nullptr ? __ldg(P.offs + s) : (i64)s * L;
    ln.len = __ldg(P.lens + s);
    ln.last = (i64)L - 1;
    ln.rc_last = P.n_raw - 1;
    const i64 len = ln.len;
    const i64 lane_ref = (i64)s * L;
    const i64 prim = P.prim != nullptr ? __ldg(P.prim + (P.n_prim == 1 ? 0 : s)) : -1;

    // the machine's registers (the plain loop's `regs`)
    int st = ST_NCLIENTS;
    i64 pos = 0, clients_left = 0, blocks_left = 0, client = 0, clock = 0, info = 0;
    i64 oc = -1, ok = 0, rc = -1, rk = 0, ptag = 0, pc = -1, pk = 0;
    i64 ds_clients_left = 0, ds_ranges_left = 0, ds_client = 0, ds_clock = 0;
    i64 keyh = -1, rooth = -1, vals_left = 0, vals_n = 0, cref = -1, mpairs = 0, mvf = 0;
    i64 msc = -1, msk = 0, mec = -1;

    int step = 0;
    for (; step < P.T; ++step) {
      if (st == ST_DONE || st == ST_ERR) break;

      // --- one varint at the cursor: the 10-byte window, masked by lens;
      // its value wraps to 32 bits, so it is summed in uint32
      u32 b10[10];
      ln.window(pos, b10);
      int nbytes = 1;
      {
        bool run = true;
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          run = run && b10[k] >= 0x80;
          nbytes += run;
        }
      }
      u32 acc = 0;
#pragma unroll
      for (int k = 0; k < 5; ++k)
        if (k < nbytes) acc += (b10[k] & 0x7Fu) << (7 * k);
      const i64 v = (int)acc;
      const bool ovf = nbytes > 5 || (nbytes == 5 && (b10[4] & 0x7F) >= 8);
      const i64 str_start = pos + nbytes;
      const i64 kind4 = info & 0xF;

      // the step, one state at a time (the plain loop computes every state's
      // step in every lane and keeps its own; a thread runs only its own).
      // Each case checks `bad` before it changes anything.
      i64 consumed = nbytes;
      int st2 = st;
      bool unsupported = false;
      // a block that ends at this step: its length, whether it emits a row,
      // the row's kind and content ref, and the ContentMove fields
      bool block_end = false, row = false, gc = false, move = false;
      i64 blk_len = 0, kind = kind4, ref = -1, msk_col = 0, mec_col = -1;

      // a client id: beyond i32, -2 - the hash of its varint bytes
      auto client_id = [&]() -> i64 {
        if (!ovf) return v;
        u32 h = 0, p = 1;
#pragma unroll
        for (int k = 0; k < 10; ++k) {
          if (k < nbytes) h += b10[k] * p;
          p *= 31u;
        }
        return -2 - (i64)((h ^ ((u32)nbytes * HASH_MUL)) & 0x3FFFFFFFu);
      };
      // parent_sub key / root name hash over the string's first
      // KEY_HASH_BYTES bytes (clamped reads, masked by i < v alone)
      auto key_hash = [&]() -> i64 {
        u32 h = 0, p = 1;
        for (int i = 0; i < KEY_HASH_BYTES && i < v; ++i) {
          h += ln.at(str_start + i) * p;
          p *= 31u;
        }
        return (i64)((h ^ ((u32)v * HASH_MUL)) & 0x7FFFFFFFu);
      };
      // one lib0 Any value: its tag byte, then a tag-dependent payload
      // (`val2` is the varint after the tag); false when it runs past lens
      i64 tag = b10[0], val2 = 0;
      auto any_value = [&]() -> bool {
        int nb2 = 1;
        bool run = true;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          run = run && b10[1 + k] >= 0x80;
          nb2 += run;
        }
        u32 acc2 = 0;
#pragma unroll
        for (int k = 0; k < 5; ++k)
          if (k < nb2) acc2 += (b10[1 + k] & 0x7Fu) << (7 * k);
        val2 = (int)acc2;
        i64 extra = 0;
        if (tag == 125 || tag == 117 || tag == 118) extra = nb2;
        else if (tag == 124) extra = 4;
        else if (tag == 123 || tag == 122) extra = 8;
        else if (tag == 119 || tag == 116) extra = nb2 + val2;
        consumed = 1 + extra;
        return pos + consumed > len || ((tag == 119 || tag == 116) && val2 > L);
      };
      // a string field (length varint, then the bytes): false when bad
      auto skip_string = [&]() -> bool {
        consumed = nbytes + v;
        return pos + consumed > len || v > L || ovf;
      };
      const bool field_bad = pos + nbytes > len || ovf;  // a plain varint field
      const bool id_bad = pos + nbytes > len;            // a client id (may pass 32 bits)
      const bool u8_bad = pos + 1 > len;                 // a one-byte field

      bool bad = false;
      switch (st) {
        case ST_NCLIENTS:
          bad = field_bad || v > P.max_sec;
          if (bad) break;
          if (v > 1) flags |= FLAG_MULTI_CLIENT;
          clients_left = v;
          st2 = v > 0 ? ST_NBLOCKS : ST_DS_NCLIENTS;
          break;
        case ST_NBLOCKS:
          if ((bad = field_bad)) break;
          blocks_left = v;
          st2 = ST_CLIENT;
          break;
        case ST_CLIENT:
          if ((bad = id_bad)) break;
          client = client_id();
          st2 = ST_CLOCK;
          break;
        case ST_CLOCK: {
          if ((bad = field_bad)) break;
          // a section of no blocks ends its client here
          const i64 left = blocks_left == 0 ? clients_left - 1 : clients_left;
          st2 = blocks_left > 0 ? ST_INFO : (left > 0 ? ST_NBLOCKS : ST_DS_NCLIENTS);
          clients_left = left;
          clock = v;
          break;
        }
        case ST_INFO: {
          if ((bad = u8_bad)) break;
          const i64 b = b10[0];
          consumed = 1;
          info = b;  // a fresh block
          keyh = -1;
          rooth = -1;
          oc = -1;
          ok = 0;
          rc = -1;
          rk = 0;
          ptag = 0;
          pc = -1;
          pk = 0;
          if (b == BLOCK_GC) st2 = ST_GC_LEN;
          else if (b == BLOCK_SKIP) st2 = ST_SKIP_LEN;
          else st2 = (b & 0x80) != 0 ? ST_ORIGIN_C : ((b & 0x40) != 0 ? ST_ROR_C : ST_PARENT_INFO);
          break;
        }
        case ST_ORIGIN_C:
          if ((bad = id_bad)) break;
          oc = client_id();
          st2 = ST_ORIGIN_K;
          break;
        case ST_ORIGIN_K:
          if ((bad = field_bad)) break;
          ok = v;
          if ((info & 0x40) != 0) {
            st2 = ST_ROR_C;
          } else {
            st2 = content_state(kind4);
            unsupported = st2 == ST_ERR;
          }
          break;
        case ST_ROR_C:
          if ((bad = id_bad)) break;
          rc = client_id();
          st2 = ST_ROR_K;
          break;
        case ST_ROR_K:
          if ((bad = field_bad)) break;
          rk = v;
          st2 = content_state(kind4);
          unsupported = st2 == ST_ERR;
          break;
        case ST_PARENT_INFO:
          if ((bad = field_bad)) break;
          ptag = v == 1 ? 1 : 2;
          st2 = v == 1 ? ST_PARENT_NAME : ST_PARENT_ID_C;
          break;
        case ST_PARENT_NAME:
        case ST_PARENT_ID_K: {
          if (st == ST_PARENT_NAME) {
            if ((bad = skip_string())) break;
            rooth = v <= KEY_HASH_BYTES ? key_hash() : -2;
          } else {
            if ((bad = field_bad)) break;
            pk = v;
          }
          const bool has_psub = (info & 0xC0) == 0 && (info & 0x20) != 0;
          st2 = has_psub ? ST_PARENT_SUB : content_state(kind4);
          unsupported = st2 == ST_ERR;
          break;
        }
        case ST_PARENT_ID_C:
          if ((bad = id_bad)) break;
          pc = client_id();
          st2 = ST_PARENT_ID_K;
          break;
        case ST_PARENT_SUB:
          if ((bad = skip_string())) break;
          keyh = key_hash();
          st2 = content_state(kind4);
          unsupported = st2 == ST_ERR || v > KEY_HASH_BYTES;
          break;
        case ST_DEL_LEN:
        case ST_GC_LEN:
        case ST_SKIP_LEN:
          if ((bad = field_bad)) break;
          block_end = true;
          row = st != ST_SKIP_LEN;
          gc = st == ST_GC_LEN;
          kind = gc ? BLOCK_GC : kind4;
          blk_len = v;
          break;
        case ST_STR: {
          if ((bad = skip_string())) break;
          // UTF-16 length of the string over the clamped span [a, b)
          const i64 a = clamp_idx(str_start, L), b = clamp_idx(str_start + v, L);
          const i64 units = ln.utf16_units(a < b ? a : b, a < b ? b : a);
          block_end = row = true;
          kind = CONTENT_STRING;
          ref = lane_ref + str_start;
          blk_len = b >= a ? units : -units;
          break;
        }
        case ST_ANY_COUNT:
        case ST_JSON_COUNT:
          if ((bad = field_bad)) break;
          cref = pos;
          vals_n = v;
          vals_left = v;
          if (v > 0) st2 = st == ST_ANY_COUNT ? ST_ANY_VAL : ST_JSON_VAL;
          block_end = v == 0;  // an empty list ends its block with no row
          break;
        case ST_ANY_VAL: {
          if ((bad = any_value())) break;
          unsupported = tag < 116;
          if (tag == 118 && val2 > 0) {  // a map opens: its pairs follow
            mpairs = val2;
            st2 = ST_ANY_MKEY;
            break;
          }
          vals_left = vals_left - 1 + (tag == 117 ? val2 : 0);
          block_end = row = vals_left == 0;
          blk_len = vals_n;
          ref = lane_ref + cref;
          break;
        }
        case ST_ANY_MKEY:
          if ((bad = skip_string())) break;
          st2 = ST_ANY_MVAL;
          break;
        case ST_ANY_MVAL:
          if ((bad = any_value())) break;
          unsupported = tag == 117 || tag == 118 || tag < 116;
          mpairs -= 1;
          if (mpairs != 0) {
            st2 = ST_ANY_MKEY;
            break;
          }
          vals_left -= 1;
          if (vals_left > 0) st2 = ST_ANY_VAL;
          block_end = row = vals_left == 0;
          blk_len = vals_n;
          ref = lane_ref + cref;
          break;
        case ST_JSON_VAL:
          if ((bad = skip_string())) break;
          vals_left -= 1;
          block_end = row = vals_left == 0;
          blk_len = vals_n;
          ref = lane_ref + cref;
          break;
        case ST_SPAN1:
          if ((bad = skip_string())) break;
          block_end = row = true;
          blk_len = 1;
          ref = lane_ref + pos;
          break;
        case ST_FMT_KEY:
          if ((bad = skip_string())) break;
          cref = pos;
          st2 = ST_FMT_VAL;
          break;
        case ST_FMT_VAL:
        case ST_TYPE_NAME:
          if ((bad = skip_string())) break;
          block_end = row = true;
          blk_len = 1;
          ref = lane_ref + cref;
          break;
        case ST_TYPE_TAG: {
          if ((bad = u8_bad)) break;
          const i64 b = b10[0];
          consumed = 1;
          unsupported = b == 7 || b >= 8;
          if (b == 3 || b == 5) {  // XmlElement / XmlHook: a name follows
            st2 = ST_TYPE_NAME;
          } else {
            block_end = row = true;
            blk_len = 1;
            ref = lane_ref + pos;
          }
          cref = pos;
          break;
        }
        case ST_MV_FLAGS:
          if ((bad = field_bad)) break;
          mvf = v;
          st2 = ST_MV_SC;
          break;
        case ST_MV_SC:
          if ((bad = id_bad)) break;
          msc = client_id();
          st2 = ST_MV_SK;
          break;
        case ST_MV_SK:
        case ST_MV_EK:
          if ((bad = field_bad)) break;
          if (st == ST_MV_SK && (mvf & 1) == 0) {
            st2 = ST_MV_EC;
          } else {
            // ContentMove: a collapsed move's end id is its start id
            block_end = row = move = true;
            blk_len = 1;
            msk_col = st == ST_MV_SK ? v : msk;
            mec_col = (mvf & 1) != 0 ? msc : mec;
          }
          if (st == ST_MV_SK) msk = v;
          break;
        case ST_MV_EC:
          if ((bad = id_bad)) break;
          mec = client_id();
          st2 = ST_MV_EK;
          break;
        case ST_DS_NCLIENTS:
          if ((bad = field_bad)) break;
          ds_clients_left = v;
          st2 = v > 0 ? ST_DS_CLIENT : ST_DONE;
          break;
        case ST_DS_CLIENT:
          if ((bad = id_bad)) break;
          ds_client = client_id();
          st2 = ST_DS_NRANGES;
          break;
        case ST_DS_NRANGES:
          if ((bad = field_bad)) break;
          ds_ranges_left = v;
          if (v == 0) ds_clients_left -= 1;  // a client of no ranges
          st2 = v > 0 ? ST_DS_CLOCK : (ds_clients_left > 0 ? ST_DS_CLIENT : ST_DONE);
          break;
        case ST_DS_CLOCK:
          if ((bad = field_bad)) break;
          ds_clock = v;
          st2 = ST_DS_LEN;
          break;
        case ST_DS_LEN:
          if ((bad = field_bad)) break;
          if (v > 0) {  // a delete range, resolved as it is written
            if (n_dels >= R) {
              flags |= FLAG_OVERFLOW;
            } else {
              int* o = dbase + n_dels;
              o[D_CLIENT * dstride] = (int)resolve_id(P, ds_client, flags);
              o[D_START * dstride] = (int)ds_clock;
              o[D_END * dstride] = (int)wrap32(ds_clock + v);
              if (P.stage) st_dv[lane * R + n_dels] = 1;
              ++n_dels;
            }
          }
          ds_ranges_left -= 1;
          if (ds_ranges_left == 0) ds_clients_left -= 1;
          st2 = ds_ranges_left > 0 ? ST_DS_CLOCK : (ds_clients_left > 0 ? ST_DS_CLIENT : ST_DONE);
          break;
        default:
          break;
      }
      if (bad) {  // the lane errs without moving its cursor or a register
        flags |= FLAG_MALFORMED;
        st = ST_ERR;
        continue;
      }

      if (block_end) {
        // the block's row, from the registers before this step, resolved
        // through the tables as it is written
        if (row && blk_len > 0) {
          if (n_rows >= U) {
            flags |= FLAG_OVERFLOW;  // the row does not fit: flagged, and the lane parses on
          } else {
            const i64 ptag_v = gc ? 0 : ptag;
            int* o = rbase + n_rows;
            o[F_CLIENT * rstride] = (int)resolve_id(P, client, flags);
            o[F_CLOCK * rstride] = (int)clock;
            o[F_LENGTH * rstride] = (int)blk_len;
            o[F_OCLIENT * rstride] = (int)resolve_id(P, gc ? -1 : oc, flags);
            o[F_OCLOCK * rstride] = (int)(gc ? 0 : ok);
            o[F_RCLIENT * rstride] = (int)resolve_id(P, gc ? -1 : rc, flags);
            o[F_RCLOCK * rstride] = (int)(gc ? 0 : rk);
            o[F_KIND * rstride] = (int)kind;
            o[F_REF * rstride] = (int)ref;
            o[F_COFF * rstride] = 0;
            o[F_KEY * rstride] = (int)resolve_key(P, gc ? -1 : keyh, flags);
            o[F_PTAG * rstride] = (int)ptag_v;
            o[F_PCLIENT * rstride] = (int)resolve_id(P, gc ? -1 : pc, flags);
            o[F_PCLOCK * rstride] = (int)(gc ? 0 : pk);
            o[F_PROOT * rstride] = (int)resolve_root(P, ptag_v, gc ? -1 : rooth, prim, flags);
            // ContentMove range fields: assoc 0 = After, -1 = Before
            o[F_MSC * rstride] = (int)resolve_id(P, move ? msc : -1, flags);
            o[F_MSK * rstride] = (int)msk_col;
            o[F_MSA * rstride] = move ? ((mvf & 2) != 0 ? 0 : -1) : 0;
            o[F_MEC * rstride] = (int)resolve_id(P, mec_col, flags);
            o[F_MEK * rstride] = move ? (int)v : 0;
            o[F_MEA * rstride] = move ? ((mvf & 4) != 0 ? 0 : -1) : 0;
            o[F_MPRIO * rstride] = (int)(move ? (mvf >> 6) : -1);
            if (P.stage) st_rv[lane * U + n_rows] = 1;
            ++n_rows;
          }
        }
        // the block and client counters, the clock, the next state
        blocks_left -= 1;
        if (blocks_left == 0) clients_left -= 1;
        st2 = blocks_left > 0 ? ST_INFO : (clients_left > 0 ? ST_NBLOCKS : ST_DS_NCLIENTS);
        clock = wrap32(clock + blk_len);
      }
      if (unsupported) {
        flags |= FLAG_UNSUPPORTED;
        st2 = ST_ERR;
      }
      pos += consumed;
      st = st2;
    }

    if (st != ST_DONE) flags |= FLAG_MALFORMED;
    P.flags[s] = (int)flags;
    if (P.steps != nullptr) P.steps[s] = step;
  }
  const bool lane_ok = (flags & FLAG_ERRORS) == 0;

  if (P.stage) {
    // an error lane loses its valid bits; then the warp copies its stage out
    if (!lane_ok) {
      for (i64 j = 0; j < n_rows; ++j) st_rv[lane * U + j] = 0;
      for (i64 j = 0; j < n_dels; ++j) st_dv[lane * R + j] = 0;
    }
    __syncwarp();
    for (int f = 0; f < ROW_FIELDS; ++f) {
      int* dst = P.rows + f * SU + (i64)s0 * U;
      const int* src = st_rows + f * THREADS * U;
      for (int i = lane; i < nw * U; i += THREADS) dst[i] = src[i];
    }
    for (int i = lane; i < nw * U; i += THREADS) P.rvalid[(i64)s0 * U + i] = st_rv[i];
    for (int f = 0; f < DEL_FIELDS; ++f) {
      int* dst = P.dels + f * SR + (i64)s0 * R;
      const int* src = st_dels + f * THREADS * R;
      for (int i = lane; i < nw * R; i += THREADS) dst[i] = src[i];
    }
    for (int i = lane; i < nw * R; i += THREADS) P.dvalid[(i64)s0 * R + i] = st_dv[i];
  } else {
    // the rows each lane did not emit hold the defaults, and every row's
    // valid byte is set here: lane r's row and range counts and whether it
    // ended clean come from lane r by shuffle
    for (int r = 0; r < nw; ++r) {
      const int n = __shfl_sync(FULL_MASK, (int)(lane_ok ? n_rows : -n_rows - 1), r);
      const int nr = n < 0 ? -n - 1 : n;
      const i64 row0 = (i64)(s0 + r) * U;
      for (int j = lane; j < U; j += THREADS) {
        if (j >= nr)
          for (int f = 0; f < ROW_FIELDS; ++f) P.rows[f * SU + row0 + j] = row_default(f, client0);
        P.rvalid[row0 + j] = j < n;
      }
      const int d = __shfl_sync(FULL_MASK, (int)(lane_ok ? n_dels : -n_dels - 1), r);
      const int nd = d < 0 ? -d - 1 : d;
      const i64 del0 = (i64)(s0 + r) * R;
      for (int j = lane; j < R; j += THREADS) {
        if (j >= nd) {
          P.dels[D_CLIENT * SR + del0 + j] = client0;
          P.dels[D_START * SR + del0 + j] = 0;
          P.dels[D_END * SR + del0 + j] = 0;
        }
        P.dvalid[del0 + j] = j < d;
      }
    }
  }
}

}  // namespace

// Bytes of shared memory a launch stages each warp's rows in, or 0 where
// that exceeds STAGE_MAX_BYTES and rows go straight to device memory.
extern "C" int ytpu_decode_stage_bytes(int U, int R) {
  const long long bytes = (long long)THREADS * (4ll * (ROW_FIELDS * (long long)U + DEL_FIELDS * (long long)R) + U + R);
  return bytes <= STAGE_MAX_BYTES ? (int)bytes : 0;
}

// The launch's arguments, one int64 each (pointers as their addresses), in
// the order of decode_kernel._LAUNCH_ARGS: the host passes one array.
struct DecodeArgs {
  i64 raw, n_raw, offs, lens, S, L, U, R, T, max_sec;
  i64 ct_keys, ct_perm, ct_n, cht_keys, cht_perm, cht_n, kt_keys, kt_perm, kt_n;
  i64 prim, n_prim, rows, dels, flags, steps, rvalid, dvalid, stream;
};

// One launch on `stream` over S lanes. `raw` holds n_raw bytes: the arena
// with `offs` [S], or, with offs 0, the [S, L] matrix. lens [S]; each
// table's keys and perm (n < 0: no table); prim [n_prim] or 0; all int32. Writes rows [22, S, U] and dels [3, S, R] int32, rvalid
// [S, U] and dvalid [S, R] bytes, flags [S] int32 and, where `steps` is not
// 0, each lane's step count [S] int32. Returns the launch's cudaError_t (0
// when it was queued).
extern "C" int ytpu_decode_v1(const DecodeArgs* a) {
  if (a->S <= 0) return 0;
  auto ptr = [](i64 x) { return (void*)(uintptr_t)x; };
  Params P;
  P.raw = (const uint8_t*)ptr(a->raw);
  P.n_raw = a->n_raw;
  P.offs = (const int*)ptr(a->offs);
  P.lens = (const int*)ptr(a->lens);
  P.S = (int)a->S;
  P.L = (int)a->L;
  P.U = (int)a->U;
  P.R = (int)a->R;
  P.T = (int)a->T;
  P.max_sec = a->max_sec;
  auto table = [&](i64 keys, i64 perm, i64 n) { return Table{(const int*)ptr(keys), (const int*)ptr(perm), n}; };
  P.ct = table(a->ct_keys, a->ct_perm, a->ct_n);
  P.cht = table(a->cht_keys, a->cht_perm, a->cht_n);
  P.kt = table(a->kt_keys, a->kt_perm, a->kt_n);
  P.prim = (const int*)ptr(a->prim);
  P.n_prim = a->n_prim;
  P.rows = (int*)ptr(a->rows);
  P.dels = (int*)ptr(a->dels);
  P.flags = (int*)ptr(a->flags);
  P.steps = (int*)ptr(a->steps);
  P.rvalid = (uint8_t*)ptr(a->rvalid);
  P.dvalid = (uint8_t*)ptr(a->dvalid);
  const int smem = ytpu_decode_stage_bytes(P.U, P.R);
  P.stage = smem > 0;
  const int blocks = (P.S + THREADS - 1) / THREADS;
  void* stream = ptr(a->stream);
  decode_v1_kernel<<<blocks, THREADS, (size_t)smem, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

extern "C" const char* ytpu_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
