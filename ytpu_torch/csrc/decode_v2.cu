// The Yjs V2 (columnar) update decode as one hand-written Hopper program:
// ytpu_torch.ops.decode_v2.decode_updates_v2 on CUDA tensors, from the
// [S, L] wire matrix, its frame spans and the cold-content sidecar to the
// pre-resolve row and delete columns and the lane flags, in one launch.
//
// Replaces: ytpu/ops/decode_v2.py:1025 `decode_updates_v2`, one jitted XLA
// program built of six `fori_loop`s over [S]-wide lane vectors: the RLE
// column expanders (:516 UIntOptRle, :555 IntDiffOptRle, :587 Rle, one run
// a step, each writing an [S, N] array), the rest-stream walker (:1018,
// a 16-state machine for lanes whose blocks put content bytes in the rest
// stream), the section walk (:1322) and the delete-set walk (:1541), and
// around them the lane-parallel tensor algebra: per-block consumption
// counts as prefix sums over the info bytes, the bulk parse of a
// content-free rest stream (terminators by cumsum and searchsorted), the
// UTF-16 string offsets by an 18-round binary search, and the row
// emission as a one-hot scatter. No `pallas_call` is involved. The intern
// tables (`_resolve_and_pack`, :1652) stay torch ops after the launch, on
// both the card and the CPU.
//
// What it computes, for lane s of S: the 21 pre-resolve row columns
// (decode_kernel.ROW_COLUMNS, int64 [21, S, U]) with their valid bytes
// [S, U], the 3 delete columns (int64 [3, S, R]) with their valid bytes
// [S, R], and the int64 flags [S], bit for bit what the plain version
// `decode_v2._decode_v2_reference` gives, flags and caps included:
// NB = U + 8 blocks, NV rest slots, NS = 2U + 4 strings, NCLI client
// entries, DSEC = R + 4 delete sections and SEC client sections
// (`decode_v2.v2_caps`). A lane that would pass one of them ends with the
// same FLAG_OVERFLOW, FLAG_MALFORMED, FLAG_UNSUPPORTED as the plain
// version; its rows are written as the plain version writes them and lose
// their valid bits only in `_resolve_and_pack`.
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
//   * a content ref is s * L + byte offset in int64.
//
// Design. The decode of one lane is a chain of dependent reads, so one
// thread owns one lane and a CTA is 128 threads. A lane walks each RLE
// column once, entry by entry, and writes its expansion into a per-lane
// scratch array in device memory, laid out word-major ([word][S]) so the
// threads of a warp touch neighbouring words; the per-block pass then
// reads those arrays where the vector version gathers. The scratch keeps
// the vector version's meaning of a clamped or never-written index
// exactly, which a cursor over the runs would not on a malformed column
// (a wrapped run count rewrites earlier entries). The UTF-16 prefix sums
// of the binary search are counted from the row as the search asks for
// them, from a cursor that only moves forward between restarts at the
// blob's start. Each lane writes its own rows, defaults first.
//
// Bound: bytes. Each lane's L bytes, its 24 span words, its sidecar row
// and its length are read once, and the 21 row values, the valid bytes,
// the 3 delete values and the flags written once, each value as the int32
// it wraps to (the content ref as int64), as for the V1 decode's
// UpdateBatch (chip_smoke.py's `decode_v2` phase counts them). Writing
// int64 columns, so that `_resolve_and_pack` reads the plain version's
// layout, is this design's choice and not part of the bound. That, the
// scratch round trip (16 NB + NCLI + 2 NS + 3 NV + 2 SEC words a lane)
// and the chain of dependent loads keep it well above the bound.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libdecode_v2.so decode_v2.cu
// tests/_emulated_decode_v2.py builds it with g++ against tests/cuda_host
// (a host emulator of CUDA) and holds it to the plain version on the CPU.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

typedef long long i64;
typedef unsigned int u32;
typedef unsigned long long u64;

constexpr int THREADS = 128;
constexpr int W_DEPTH = 4;
constexpr int KEY_HASH_BYTES = 32;

constexpr int FLAG_UNSUPPORTED = 1;
constexpr int FLAG_OVERFLOW = 2;
constexpr int FLAG_MALFORMED = 4;
constexpr int FLAG_MULTI_CLIENT = 16;

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

// pre-resolve row columns, in decode_kernel.ROW_COLUMNS order
enum Col : int {
  C_CLIENT, C_CLOCK, C_LENGTH, C_OC, C_OK, C_RC, C_RK, C_KIND, C_REF, C_PTAG, C_PC, C_PK, C_KEYH, C_ROOTH,
  C_MSC, C_MSK, C_MSA, C_MEC, C_MEK, C_MEA, C_MPRIO, ROW_COLS
};

__device__ __forceinline__ int wadd(int a, int b) { return (int)((u32)a + (u32)b); }
__device__ __forceinline__ int wsub(int a, int b) { return (int)((u32)a - (u32)b); }
__device__ __forceinline__ int wmul(int a, int b) { return (int)((u32)a * (u32)b); }
__device__ __forceinline__ int clampi(int x, int lo, int hi) { return x < lo ? lo : (x > hi ? hi : x); }

struct Params {
  const uint8_t* buf;
  const int* lens;
  const int* spans;
  const int* side;
  int n_side;  // -1: no sidecar
  int S, L, U, R, SEC;
  int NB, DSEC, NV, NS, NCLI, T;
  i64* rows;
  uint8_t* rvalid;
  i64* dels;
  uint8_t* dvalid;
  i64* flags;
  int* scratch;
};

// word offsets of the per-lane scratch arrays
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

// One lane's view: its bytes, its scratch words ([word][S]) and the
// varint readers of the vector version.
struct Lane {
  const uint8_t* row;
  int* sc;
  int S, L;

  __device__ __forceinline__ int byte(int j) const { return row[clampi(j, 0, L - 1)]; }
  __device__ __forceinline__ int& at(int word) const { return sc[(i64)word * S]; }
  // the window byte at pos + k: zero at or past `end`
  __device__ __forceinline__ int win(int pos, int end, int k) const { return pos + k < end ? byte(pos + k) : 0; }

  // unsigned varint at pos (window masked by end): its low 32 bits, its
  // byte count (up to 10) and whether it passes 32 bits
  __device__ void uvar(int pos, int end, int& val, int& nb, bool& ovf) const {
    u32 v = 0;
    int n = 1;
    int b4 = 0;
    for (int k = 0; k < 10; ++k) {
      const int w = win(pos, end, k);
      if (k == 4) b4 = w;
      if (k < 5) v += ((u32)(w & 0x7F)) << (7 * k);
      if (w < 0x80) break;
      if (k < 9) ++n;
    }
    val = (int)v;
    nb = n;
    ovf = n > 5 || (n == 5 && (b4 & 0x7F) >= 8);
  }

  // signed varint at pos: magnitude (low 32 bits), sign, byte count,
  // overflow, and the 64-bit magnitude (for the client hash)
  __device__ void svar(int pos, int end, int& mag, bool& neg, int& nb, bool& ovf, u64& mag64) const {
    const int b0 = win(pos, end, 0);
    u32 m = (u32)(b0 & 0x3F);
    u64 m64 = (u64)(b0 & 0x3F);
    int n = 1, b4 = 0;
    bool cont = b0 >= 0x80;
    for (int k = 1; k < 10 && cont; ++k) {
      const int w = win(pos, end, k);
      if (k == 4) b4 = w;
      const int o = 6 + 7 * (k - 1);
      if (k < 5) m += ((u32)(w & 0x7F)) << o;
      m64 += ((u64)(w & 0x7F)) << o;
      ++n;
      cont = w >= 0x80;
    }
    mag = (int)m;
    neg = (b0 & 0x40) != 0;
    nb = n;
    ovf = n > 5 || (n == 5 && (b4 & 0x7F) >= 16);
    mag64 = m64;
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

// client_hash_host of the varint bytes starting at byte 0 of `w`
__device__ int hash_window(const int* w) {
  u32 h = 0, p = 1;
  int n = 0;
  for (int k = 0; k < 10; ++k) {
    h += (u32)w[k] * p;
    p *= 31u;
    ++n;
    if (w[k] < 0x80 || k == 9) break;
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

// UIntOptRle column into words [off, off + N); returns the count produced
__device__ int expand_uintoptrle(const Lane& ln, int start, int length, int N, int off, bool hash_big) {
  for (int i = 0; i < N; ++i) ln.at(off + i) = 0;
  const int end = wadd(start, length);
  int pos = length > 0 ? start : end, oidx = 0;
  for (int step = 0; step < N; ++step) {
    if (!(pos < end && oidx < N)) break;
    int mag, nb, cnt, nb2;
    bool neg, ovf, ovf2;
    u64 m64;
    ln.svar(pos, end, mag, neg, nb, ovf, m64);
    if (hash_big && ovf) mag = -2 - hash_u64(m64);
    ln.uvar(pos + nb, end, cnt, nb2, ovf2);
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
    int mag, nb, cnt, nb2;
    bool neg, ovf, ovf2;
    u64 m64;
    ln.svar(pos, end, mag, neg, nb, ovf, m64);
    const int enc = neg ? wsub(0, mag) : mag;
    const bool has_count = (enc & 1) != 0;
    const int diff = enc >> 1;
    ln.uvar(pos + nb, end, cnt, nb2, ovf2);
    const int count = has_count ? wadd(cnt, 2) : 1;
    const int adv = nb + (has_count ? nb2 : 0);
    // value at i: last + diff * k, k = i - oidx + 1 in [1, count]
    if (oidx >= 0 && count >= 0 && (i64)oidx + count == (i64)wadd(oidx, count)) {
      const int hi = wadd(oidx, count), e = hi < N ? hi : N;
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
    const int value = ln.win(pos, end, 0);
    const bool has_count = pos + 1 < end;
    int cnt, nb2;
    bool ovf2;
    ln.uvar(pos + 1, end, cnt, nb2, ovf2);
    const int count = has_count ? wadd(cnt, 1) : N;
    const int adv = 1 + (has_count ? nb2 : 0);
    cover(oidx, count, N, [&](int i) { ln.at(off + i) = value; });
    pos = wadd(pos, adv);
    oidx = wadd(oidx, count);
  }
  return oidx;
}

// UTF-16 units of the row's bytes [0, m): a UTF-8 head byte is one unit, a
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
    while (pos < m) {
      const int b = ln->byte(pos);
      val += ((b & 0xC0) != 0x80) + (b >= 0xF0);
      ++pos;
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

__global__ void __launch_bounds__(THREADS) decode_v2_kernel(const Params P) {
  const int s = blockIdx.x * THREADS + threadIdx.x;
  if (s >= P.S) return;
  const int S = P.S, L = P.L, U = P.U, R = P.R, SEC = P.SEC;
  const int NB = P.NB, DSEC = P.DSEC, NV = P.NV, NS = P.NS, NCLI = P.NCLI;
  const Layout O = layout(U, R, SEC);
  Lane ln{P.buf + (i64)s * L, P.scratch + s, S, L};
  const int len_s = P.lens[s];
  int sp[12][2];
  int abs_sum = 0;
  for (int k = 0; k < 12; ++k) {
    sp[k][0] = P.spans[((i64)s * 12 + k) * 2];
    sp[k][1] = P.spans[((i64)s * 12 + k) * 2 + 1];
    abs_sum |= sp[k][0] | sp[k][1];
  }
  int flags = 0;
  // all-zero spans on a non-empty payload: the host frame split failed
  const bool frame_bad = len_s > 0 && abs_sum == 0;
  if (frame_bad) flags |= FLAG_MALFORMED;

  // ---- column expansions
  const int info_n = expand_rle(ln, sp[SP_INFO][0], sp[SP_INFO][1], NB, O.info);
  const int pi_n = expand_rle(ln, sp[SP_PARENT_INFO][0], sp[SP_PARENT_INFO][1], NB, O.pi);
  const int cli_n = expand_uintoptrle(ln, sp[SP_CLIENT][0], sp[SP_CLIENT][1], NCLI, O.cli, true);
  const int lc_n = expand_intdiffoptrle(ln, sp[SP_LEFT_CLOCK][0], sp[SP_LEFT_CLOCK][1], NB, O.lc);
  const int rc_n = expand_intdiffoptrle(ln, sp[SP_RIGHT_CLOCK][0], sp[SP_RIGHT_CLOCK][1], NB, O.rc);
  const int len_n = expand_uintoptrle(ln, sp[SP_LEN][0], sp[SP_LEN][1], NB, O.len, false);
  const int tr_n = expand_uintoptrle(ln, sp[SP_TYPE_REF][0], sp[SP_TYPE_REF][1], NB, O.tr, false);
  const int str_n = expand_uintoptrle(ln, sp[SP_STR_LENS][0], sp[SP_STR_LENS][1], NS, O.str16, false);

  // ---- string byte offsets: the first byte index in the blob whose
  // UTF-16 prefix sum reaches each string's cumulative unit target (the
  // vector version's 18 rounds of binary search, round for round)
  const int blob_start = sp[SP_STR_BLOB][0], blob_end = wadd(sp[SP_STR_BLOB][0], sp[SP_STR_BLOB][1]);
  {
    Psum ps{&ln, 0, 0, 0, 0};
    const int bs = clampi(blob_start, 0, L);
    ps.base_val = ps.at(bs);
    ps.base_pos = bs;
    const int base16 = ps.base_val;
    int tgt_excl = 0;
    for (int i = 0; i < NS; ++i) {
      const int tgt = wadd(base16, tgt_excl);
      tgt_excl = wadd(tgt_excl, ln.at(O.str16 + i));
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

  // ---- the rest stream: slots v / vst / vovf [NV], n_varints
  const int rest_start = sp[SP_REST][0], rest_end = wadd(sp[SP_REST][0], sp[SP_REST][1]);
  int n_varints = 0;
  bool walk_bad = false, deep = false;
  for (int j = 0; j < NB; ++j) {
    ln.at(O.cst + j) = 0;
    ln.at(O.mvf + j) = 0;
    ln.at(O.msc + j) = -1;
    ln.at(O.msk + j) = 0;
    ln.at(O.mec + j) = -1;
    ln.at(O.mek + j) = 0;
  }
  if (!has_content) {
    // bulk parse: varint k ends at the (k + 1)-th byte < 0x80 of the region
    auto slot = [&](int k, int st, int tp) {
      const int nb = clampi(tp - st + 1, 1, 10);
      u32 v = 0;
      for (int i = 0; i < 5 && i < nb; ++i) v += ((u32)(ln.byte(st + i) & 0x7F)) << (7 * i);
      ln.at(O.v + k) = (int)v;
      ln.at(O.vst + k) = st;
      ln.at(O.vovf + k) = nb > 5 || (nb == 5 && (ln.byte(st + 4) & 0x7F) >= 8);
    };
    int k = 0, next = rest_start;
    const int lo = rest_start > 0 ? rest_start : 0, hi = rest_end < L ? rest_end : L;
    for (int j = lo; j < hi; ++j) {
      if (ln.byte(j) < 0x80) {
        if (k < NV) slot(k, next, j);
        next = j + 1;
        ++k;
        ++n_varints;
      }
    }
    for (; k < NV; ++k) {
      slot(k, next, L);
      next = L + 1;
    }
  } else {
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
      int w[10];
      for (int k = 0; k < 10; ++k) w[k] = ln.win(pos, end, k);
      int val, nb, val2, nb2;
      bool ovf, ovf2;
      ln.uvar(pos, end, val, nb, ovf);
      const int tag = w[0];
      const bool is_mv = st == W_MVF || st == W_MSC || st == W_MSK || st == W_MEC || st == W_MEK;
      const bool is_var = st == W_NC || st == W_SEC_N || st == W_SEC_CLK || st == W_SKIP || is_mv || st == W_DS;
      const int hashed_val = ovf ? -2 - hash_window(w) : val;
      const bool in_any = st == W_ANY, in_mkey = st == W_MKEY, in_mval = st == W_MVAL;
      const bool in_anyval = in_any || in_mval;
      ln.uvar(pos + 1, end, val2, nb2, ovf2);
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
  auto vat = [&](int idx, bool used, bool& bad) {
    const int c = clampi(idx, 0, NV - 1);
    if (used && (idx >= n_varints || idx >= NV || ln.at(O.vovf + c))) bad = true;
    return ln.at(O.v + c);
  };
  // a client-id slot: beyond i32, -2 - the hash of its wire bytes
  auto vat_id = [&](int idx, bool used, bool& bad) {
    const int c = clampi(idx, 0, NV - 1);
    if (used && (idx >= n_varints || idx >= NV)) bad = true;
    if (!ln.at(O.vovf + c)) return ln.at(O.v + c);
    const int st0 = ln.at(O.vst + c);
    int w[10];
    for (int k = 0; k < 10; ++k) w[k] = ln.byte(st0 + k);
    return -2 - hash_window(w);
  };

  const int nc = ln.at(O.v + 0);
  bool malformed = len_s > 0 && n_varints < 1;
  if (nc > 1) flags |= FLAG_MULTI_CLIENT;
  const bool sec_ovf = nc > SEC;

  // ---- section walk
  int total_blocks = 0;
  {
    int vidx = 1, base = 0;
    bool unused = false;
    for (int i = 0; i < SEC; ++i) {
      if (i < nc) {
        const int nb_i = vat(vidx, true, unused);
        ln.at(O.sech + i) = vidx;
        ln.at(O.secb + i) = base;
        const int nxt = clampi(wadd(base, nb_i), 0, NB);
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

  // ---- rows: defaults first
  const i64 SU = (i64)S * U, row0 = (i64)s * U;
  const i64 defaults[ROW_COLS] = {0, 0, 0, -1, 0, -1, 0, 0, -1, 0, -1, 0, -1, -1, -1, 0, 0, -1, 0, 0, -1};
  for (int u = 0; u < U; ++u) {
    for (int f = 0; f < ROW_COLS; ++f) P.rows[f * SU + row0 + u] = defaults[f];
    P.rvalid[row0 + u] = 0;
  }

  // ---- per-block pass B
  bool bad_v1 = false, bad_v2 = false, unsupported = deep && has_content, key_too_long = false,
       side_bad = false, row_ovf = false, neg_len = false;
  int need_cli = 0, need_lc = 0, need_rc = 0, need_len = 0, need_str = 0, need_pi = 0, need_tr = 0;
  bool any_cold = false;
  {
    int pi_idx = 0, c_base = 0, l_idx = 0, r_idx = 0, n_idx = 0, tr_idx = 0, s_base = 0, cum_skip = 0, len_psum = 0,
        cold_rank = 0, emit_idx = 0;
    for (int j = 0; j < NB; ++j) {
      const int info = ln.at(O.info + j);
      const bool valid = j < total_blocks;
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
      const int sec_clk = vat(clampi(blk_h, 0, NV - 1) + 1, valid && blk_h >= 0, bad_v1);
      const int sec_client = ln.at(O.cli + clampi(sec_id + ln.at(O.cbase + secbase), 0, NCLI - 1));
      const int skips_base = ln.at(O.skipi + secbase) - (ln.at(O.info + secbase) == K_SKIP);
      const int skip_vidx = wadd(wadd(blk_h, 2), cum_skip - skips_base);
      const int skip_len = vat(clampi(skip_vidx, 0, NV - 1), valid && is_skip, bad_v2);

      int blk_len = is_str ? ln.at(O.str16 + clampi(wadd(wadd(s_base, is_root), has_psub), 0, NS - 1))
                  : n_cnt  ? len_at
                  : is_skip ? skip_len
                  : is_item ? 1
                            : 0;
      if (!valid) blk_len = 0;
      ln.at(O.lpsum + j) = len_psum;

      if (valid) {
        need_cli += c_cnt;
        need_lc += l_cnt;
        need_rc += has_r;
        need_len += n_cnt;
        need_str = wadd(need_str, s_cnt);
        need_pi += cant_copy;
        need_tr += is_type;
        if (is_doc || type_weak) unsupported = true;
        if (blk_len < 0) neg_len = true;
      }
      const bool cold = valid && (is_json || is_embed || is_format || (is_type && !type_weak));
      if (cold) any_cold = true;
      i64 ref_cold = -1;
      if (P.n_side >= 0) {
        const int NC2 = P.n_side;
        const int cold_off = NC2 > 0 ? P.side[(i64)s * NC2 + clampi(cold_rank, 0, NC2 - 1)] : -1;
        if (cold && (cold_rank >= NC2 || cold_off < 0)) side_bad = true;
        ref_cold = (i64)s * L + cold_off;
      }
      const int psub_idx = wadd(s_base, is_root), content_sidx = wadd(psub_idx, has_psub);
      const int psub_c = clampi(psub_idx, 0, NS - 1);
      const int psub_bytes = str_bytes(psub_c);
      if (valid && has_psub && psub_bytes > KEY_HASH_BYTES) key_too_long = true;

      const bool emit = valid && !is_skip && blk_len > 0;
      if (emit && emit_idx >= U) row_ovf = true;
      if (emit && emit_idx < U) {
        const i64 o = row0 + emit_idx;
        i64* rw = P.rows;
        const int blk_cli_base = sec_id + 1 + c_base;
        const int lc = ln.at(O.lc + clampi(l_idx, 0, NB - 1));
        const int clock = wsub(wadd(sec_clk, len_psum), ln.at(O.lpsum + secbase));
        const int rbytes = str_bytes(clampi(s_base, 0, NS - 1));
        i64 ref;
        if (is_str)
          ref = (i64)s * L + ln.at(O.strst + clampi(content_sidx, 0, NS - 1));
        else if (is_any || is_bin || is_move)
          ref = (i64)s * L + ln.at(O.cst + j);
        else
          ref = cold ? ref_cold : -1;
        const int mvf = ln.at(O.mvf + j);
        const bool collapsed = (mvf & 1) != 0;
        rw[C_CLIENT * SU + o] = sec_client;
        rw[C_CLOCK * SU + o] = clock;
        rw[C_LENGTH * SU + o] = blk_len;
        rw[C_OC * SU + o] = has_o ? ln.at(O.cli + clampi(blk_cli_base, 0, NCLI - 1)) : -1;
        rw[C_OK * SU + o] = has_o ? lc : 0;
        rw[C_RC * SU + o] = has_r ? ln.at(O.cli + clampi(blk_cli_base + (int)has_o, 0, NCLI - 1)) : -1;
        rw[C_RK * SU + o] = has_r ? ln.at(O.rc + clampi(r_idx, 0, NB - 1)) : 0;
        rw[C_KIND * SU + o] = is_gc ? 0 : kind4;
        rw[C_REF * SU + o] = ref;
        rw[C_PTAG * SU + o] = is_root ? 1 : (is_nested ? 2 : 0);
        rw[C_PC * SU + o] = is_nested ? ln.at(O.cli + clampi(blk_cli_base, 0, NCLI - 1)) : -1;
        rw[C_PK * SU + o] = is_nested ? lc : 0;
        rw[C_KEYH * SU + o] = has_psub ? name_hash(ln, ln.at(O.strst + psub_c), psub_bytes) : -1;
        rw[C_ROOTH * SU + o] =
            is_root ? (rbytes <= KEY_HASH_BYTES ? name_hash(ln, ln.at(O.strst + clampi(s_base, 0, NS - 1)), rbytes) : -2)
                    : -1;
        rw[C_MSC * SU + o] = is_move ? ln.at(O.msc + j) : -1;
        rw[C_MSK * SU + o] = is_move ? ln.at(O.msk + j) : 0;
        rw[C_MSA * SU + o] = is_move ? ((mvf & 2) ? 0 : -1) : 0;
        rw[C_MEC * SU + o] = is_move ? (collapsed ? ln.at(O.msc + j) : ln.at(O.mec + j)) : -1;
        rw[C_MEK * SU + o] = is_move ? (collapsed ? ln.at(O.msk + j) : ln.at(O.mek + j)) : 0;
        rw[C_MEA * SU + o] = is_move ? ((mvf & 4) ? 0 : -1) : 0;
        rw[C_MPRIO * SU + o] = is_move ? (mvf >> 6) : -1;
        P.rvalid[o] = 1;
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
  }
  if (P.n_side < 0 && any_cold) unsupported = true;  // no sidecar: cold payloads unaddressable
  if (key_too_long) unsupported = true;
  const bool consumption_ovf = ln.at(O.cbase + NB - 1) + 3 > NCLI || total_blocks > NB;
  need_cli += nc < SEC ? nc : SEC;
  const bool truncated = need_cli > cli_n || need_lc > lc_n || need_rc > rc_n || need_len > len_n ||
                         need_str > str_n || need_pi > pi_n || need_tr > tr_n;
  const bool str_cap_ovf = need_str > NS;

  // ---- delete set
  const i64 SR = (i64)S * R, del0 = (i64)s * R;
  for (int r = 0; r < R; ++r) {
    P.dels[0 * SR + del0 + r] = 0;
    P.dels[1 * SR + del0 + r] = 0;
    P.dels[2 * SR + del0 + r] = 0;
    P.dvalid[del0 + r] = 0;
  }
  bool bad_v3 = false, ds_bad = false, ds_ovf = false;
  const int d0 = wadd(wadd(1, wmul(2, nc < SEC ? nc : SEC)), skips_upto(total_blocks));
  const int ds_n = vat(d0, len_s > 0 && !frame_bad, bad_v3);
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
          P.dels[0 * SR + del0 + o] = cli;
          P.dels[1 * SR + del0 + o] = clock;
          P.dels[2 * SR + del0 + o] = wadd(clock, lv);
          P.dvalid[del0 + o] = 1;
        }
      }
      if (wadd(out_base, nr) > R) ds_ovf = true;
      p = wadd(p, wadd(2, wmul(2, nr)));
      out_base = clampi(wadd(out_base, nr), 0, R);
    }
  }
  const bool ds_sec_ovf = ds_n > DSEC;

  malformed = malformed || frame_bad || bad_v1 || bad_v2 || bad_v3 || ds_bad || truncated ||
              (walk_bad && has_content) || side_bad || neg_len;
  if (malformed) flags |= FLAG_MALFORMED;
  if (unsupported) flags |= FLAG_UNSUPPORTED;
  if (blk_ovf || row_ovf || consumption_ovf || ds_ovf || ds_sec_ovf || str_cap_ovf) flags |= FLAG_OVERFLOW;
  P.flags[s] = flags;
}

}  // namespace

// Words of per-lane scratch a launch needs (times S).
extern "C" int ytpu_decode_v2_scratch_words(int U, int R, int SEC) { return layout(U, R, SEC).words; }

// The launch's arguments, one int64 each (pointers as their addresses), in
// the order of decode_v2._LAUNCH_ARGS: the host passes one array.
struct DecodeV2Args {
  i64 buf, lens, spans, side, n_side, S, L, U, R, SEC, rows, rvalid, dels, dvalid, flags, scratch, stream;
};

// One launch on `stream` over S lanes of the [S, L] uint8 matrix `buf`:
// lens [S], spans [S, 12, 2] and the sidecar [S, n_side] (n_side -1: none)
// int32; writes rows [21, S, U] and dels [3, S, R] int64, rvalid [S, U]
// and dvalid [S, R] bytes and flags [S] int64, using `scratch`
// (ytpu_decode_v2_scratch_words(U, R, SEC) * S int32). Returns the
// launch's cudaError_t (0 when it was queued).
extern "C" int ytpu_decode_v2(const DecodeV2Args* a) {
  if (a->S <= 0) return 0;
  auto ptr = [](i64 x) { return (void*)(uintptr_t)x; };
  Params P;
  P.buf = (const uint8_t*)ptr(a->buf);
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
  P.rows = (i64*)ptr(a->rows);
  P.rvalid = (uint8_t*)ptr(a->rvalid);
  P.dels = (i64*)ptr(a->dels);
  P.dvalid = (uint8_t*)ptr(a->dvalid);
  P.flags = (i64*)ptr(a->flags);
  P.scratch = (int*)ptr(a->scratch);
  const int blocks = (P.S + THREADS - 1) / THREADS;
  void* stream = ptr(a->stream);
  decode_v2_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

extern "C" const char* ytpu_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
