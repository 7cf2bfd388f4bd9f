// The lib0 / Yjs V1 update decode as a hand-written Hopper kernel: the
// lane-parallel varint state machine behind
// ytpu_torch.ops.decode_kernel.decode_updates_v1.
//
// Replaces: ytpu/ops/decode_kernel.py:379 `decode_updates_v1`, whose body
// is one XLA `fori_loop` (:1038) that moves every update lane through one
// state of a 41-state machine per iteration, all lanes in lockstep as
// [S]-wide vector ops. XLA needs the lockstep; the card does not. Here
// each lane is one thread that walks its own row of the wire matrix until
// it reaches DONE or ERR, or has taken T steps. A lane that has stopped
// changes nothing in the lockstep loop, so stopping early gives the same
// result.
//
// What it computes, for lane s of buf [S, L] uint8 with lens [S] int64:
// the pre-resolve row columns [ROW_COLS, S, U] int64 (client, clock,
// length, oc, ok, rc, rk, kind, ref, ptag, pc, pk, keyh, rooth, msc, msk,
// msa, mec, mek, mea, mprio) with their valid bytes [S, U], the delete
// columns [DEL_COLS, S, R] int64 (client, start, end) with valid [S, R],
// and the lane's flags [S] int64, FLAG_MALFORMED included for a lane not
// at DONE. Rows and ranges that are not emitted hold the plain version's
// defaults. The intern tables resolve afterwards, as torch ops
// (`_resolve_and_pack`), on the output of either version.
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
//     content ref is s * L + byte offset in int64.
//
// Bound: bytes. A lane reads its wire bytes once and writes its U rows of
// 21 int64 columns and a valid byte, its R ranges of 3 int64 columns and
// a valid byte and its flags once (chip_smoke.py's `decode` phase counts
// them). Design for correctness first: one thread per lane, 128 a CTA,
// the machine's registers in thread registers, the varint window and the
// any-value length read byte by byte from the global row. The parse is a
// chain of dependent loads per lane; wide lanes (whole-state updates of
// thousands of steps) run alone on their thread.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libdecode.so decode.cu
// tests/_emulated_decode.py builds it with g++ against tests/cuda_host (a
// host emulator of CUDA) and holds it to the plain loop on the CPU.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

typedef long long i64;
typedef unsigned int u32;

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
constexpr i64 FLAG_MULTI_CLIENT = 16;

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

// output columns, in the order of decode_kernel.ROW_COLUMNS / DEL_COLUMNS
enum RowCol : int {
  COL_CLIENT, COL_CLOCK, COL_LENGTH, COL_OC, COL_OK, COL_RC, COL_RK, COL_KIND, COL_REF, COL_PTAG, COL_PC,
  COL_PK, COL_KEYH, COL_ROOTH, COL_MSC, COL_MSK, COL_MSA, COL_MEC, COL_MEK, COL_MEA, COL_MPRIO, ROW_COLS
};
enum DelCol : int { DEL_CLIENT, DEL_START, DEL_END, DEL_COLS };

constexpr int THREADS = 128;

__device__ __forceinline__ i64 wrap32(i64 x) {
  x &= 0xFFFFFFFFll;
  return x >= (1ll << 31) ? x - (1ll << 32) : x;
}

__device__ __forceinline__ i64 clamp_idx(i64 i, i64 hi) { return i < 0 ? 0 : (i > hi ? hi : i); }

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

__global__ void __launch_bounds__(THREADS) decode_v1_kernel(
    const uint8_t* __restrict__ buf, const i64* __restrict__ lens, int S, int L, int U, int R, int T,
    i64 max_sec, i64* __restrict__ rows, uint8_t* __restrict__ rvalid, i64* __restrict__ dels,
    uint8_t* __restrict__ dvalid, i64* __restrict__ flags_out, int* __restrict__ steps_out) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const uint8_t* row = buf + (i64)s * L;
  const i64 len = lens[s];
  const i64 last = (i64)L - 1;
  const i64 lane_ref = (i64)s * L;
  const i64 SU = (i64)S * U, SR = (i64)S * R;
  i64* my_rows = rows + (i64)s * U;  // column c, row j at my_rows[c * SU + j]
  uint8_t* my_rvalid = rvalid + (i64)s * U;
  i64* my_dels = dels + (i64)s * R;
  uint8_t* my_dvalid = dvalid + (i64)s * R;

  // the machine's registers (the plain loop's `regs`)
  int st = ST_NCLIENTS;
  i64 pos = 0, flags = 0, clients_left = 0, blocks_left = 0, client = 0, clock = 0, info = 0;
  i64 oc = -1, ok = 0, rc = -1, rk = 0, ptag = 0, pc = -1, pk = 0;
  i64 ds_clients_left = 0, ds_ranges_left = 0, ds_client = 0, ds_clock = 0, n_rows = 0, n_dels = 0;
  i64 keyh = -1, rooth = -1, vals_left = 0, vals_n = 0, cref = -1, mpairs = 0, mvf = 0;
  i64 msc = -1, msk = 0, mec = -1;

  int step = 0;
  for (; step < T; ++step) {
    if (st == ST_DONE || st == ST_ERR) break;

    // --- one varint (or u8) at the cursor: the 10-byte window, masked by lens
    i64 b10[10];
#pragma unroll
    for (int k = 0; k < 10; ++k) {
      const i64 i = pos + k;
      b10[k] = i < len ? (i64)row[clamp_idx(i, last)] : 0;
    }
    int nbytes = 1;
    {
      bool run = true;
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        run = run && b10[k] >= 0x80;
        nbytes += run;
      }
    }
    i64 acc = 0;
#pragma unroll
    for (int k = 0; k < 5; ++k)
      if (k < nbytes) acc += (b10[k] & 0x7F) << (7 * k);
    const i64 val = wrap32(acc);
    const bool ovf = nbytes > 5 || (nbytes == 5 && (b10[4] & 0x7F) >= 8);

    const bool is_u8 = st == ST_INFO || st == ST_TYPE_TAG;
    const i64 v = is_u8 ? b10[0] : val;
    i64 consumed = is_u8 ? 1 : nbytes;
    const bool is_str_skip = st == ST_PARENT_NAME || st == ST_PARENT_SUB || st == ST_JSON_VAL ||
                             st == ST_FMT_KEY || st == ST_FMT_VAL || st == ST_SPAN1 ||
                             st == ST_TYPE_NAME || st == ST_ANY_MKEY;
    const bool is_str = st == ST_STR;
    const i64 str_start = pos + nbytes;
    if (is_str_skip || is_str) consumed += v;

    // --- one lib0 Any value: tag byte, then a tag-dependent payload
    const bool is_any_val = st == ST_ANY_VAL;
    const bool is_any_mval = st == ST_ANY_MVAL;
    const i64 tag = b10[0];
    int nb2 = 1;
    {
      bool run = true;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        run = run && b10[1 + k] >= 0x80;
        nb2 += run;
      }
    }
    i64 acc2 = 0;
#pragma unroll
    for (int k = 0; k < 5; ++k)
      if (k < nb2) acc2 += (b10[1 + k] & 0x7F) << (7 * k);
    const i64 val2 = wrap32(acc2);
    i64 any_extra = 0;
    if (tag == 127 || tag == 126 || tag == 121 || tag == 120) any_extra = 0;
    else if (tag == 125) any_extra = nb2;
    else if (tag == 124) any_extra = 4;
    else if (tag == 123 || tag == 122) any_extra = 8;
    else if (tag == 119 || tag == 116) any_extra = nb2 + val2;
    else if (tag == 117 || tag == 118) any_extra = nb2;
    const bool any_bad_tag =
        (is_any_val && tag < 116) || (is_any_mval && (tag == 117 || tag == 118 || tag < 116));
    if (is_any_val || is_any_mval) consumed = 1 + any_extra;

    const bool key_too_long = st == ST_PARENT_SUB && v > KEY_HASH_BYTES;
    const i64 pos_after = pos + consumed;
    const bool is_client_st = st == ST_CLIENT || st == ST_ORIGIN_C || st == ST_ROR_C ||
                              st == ST_PARENT_ID_C || st == ST_DS_CLIENT || st == ST_MV_SC ||
                              st == ST_MV_EC;
    // client ids beyond i32 are represented by -2 - hash of their bytes
    i64 vc = v;
    if (is_client_st && ovf) {
      u32 h = 0, p = 1;
#pragma unroll
      for (int k = 0; k < 10; ++k) {
        if (k < nbytes) h += (u32)b10[k] * p;
        p *= 31u;
      }
      vc = -2 - (i64)((h ^ ((u32)nbytes * HASH_MUL)) & 0x3FFFFFFFu);
    }
    const bool bad = pos_after > len || ((is_str_skip || is_str) && v > L) ||
                     ((is_any_val || is_any_mval) && (tag == 119 || tag == 116) && val2 > L) ||
                     (ovf && !is_u8 && !is_client_st && !is_any_val && !is_any_mval) ||
                     (st == ST_NCLIENTS && v > max_sec);
    if (bad) {
      flags |= FLAG_MALFORMED;
      st = ST_ERR;
      continue;
    }

    // parent_sub key / root name hash over the string's first KEY_HASH_BYTES
    // bytes (clamped reads, masked by i < v alone)
    i64 khash = 0;
    if (st == ST_PARENT_SUB || st == ST_PARENT_NAME) {
      u32 h = 0, p = 1;
      for (int i = 0; i < KEY_HASH_BYTES; ++i) {
        if (i < v) h += (u32)row[clamp_idx(str_start + i, last)] * p;
        p *= 31u;
      }
      khash = (i64)((h ^ ((u32)v * HASH_MUL)) & 0x7FFFFFFFu);
    }

    // --- end-of-block / end-of-ds-range shared bookkeeping
    const i64 any_children = (is_any_val && tag == 117) ? val2 : 0;
    const bool map_open = is_any_val && tag == 118 && val2 > 0;
    const i64 mpairs2 = is_any_mval ? mpairs - 1 : mpairs;
    const bool map_done = is_any_mval && mpairs2 == 0;
    const bool vals_dec = (is_any_val && !map_open) || st == ST_JSON_VAL || map_done;
    const i64 vals_left2 = vals_dec ? vals_left - 1 + any_children : vals_left;
    const bool empty_list = (st == ST_ANY_COUNT || st == ST_JSON_COUNT) && v == 0;
    const bool list_done = vals_dec && vals_left2 == 0;
    const bool type_named = st == ST_TYPE_TAG && (v == 3 || v == 5);
    const bool type_done = (st == ST_TYPE_TAG && !type_named) || st == ST_TYPE_NAME;
    const bool mv_collapsed = (mvf & 1) != 0;
    const bool move_done = (st == ST_MV_SK && mv_collapsed) || st == ST_MV_EK;
    const bool emit_row_st = st == ST_DEL_LEN || st == ST_GC_LEN || st == ST_SKIP_LEN || is_str ||
                             list_done || st == ST_SPAN1 || st == ST_FMT_VAL || type_done || move_done;
    i64 blk_len;
    if (is_str) {
      // UTF-16 length of the string: head bytes plus 4-byte leads over the
      // clamped span [a, b) of the raw row
      const i64 a = clamp_idx(str_start, L), b = clamp_idx(str_start + v, L);
      const i64 lo = a < b ? a : b, hi = a < b ? b : a;
      i64 units = 0;
      for (i64 i = lo; i < hi; ++i) {
        const u32 byte = row[i];
        units += ((byte & 0xC0u) != 0x80u) + (byte >= 0xF0u);
      }
      blk_len = b >= a ? units : -units;
    } else if (list_done) {
      blk_len = vals_n;
    } else if (st == ST_SPAN1 || st == ST_FMT_VAL || type_done || move_done) {
      blk_len = 1;
    } else {
      blk_len = v;
    }
    const bool block_end = emit_row_st || empty_list;
    const i64 blocks_left2 = block_end ? blocks_left - 1 : blocks_left;
    const bool empty_client = st == ST_CLOCK && blocks_left == 0;
    const bool client_done = (block_end && blocks_left2 == 0) || empty_client;
    const i64 clients_left2 = client_done ? clients_left - 1 : clients_left;
    const int after_block = blocks_left2 > 0 ? ST_INFO : (clients_left2 > 0 ? ST_NBLOCKS : ST_DS_NCLIENTS);

    const bool ds_done_range = st == ST_DS_LEN;
    const i64 ds_ranges_left2 = ds_done_range ? ds_ranges_left - 1 : ds_ranges_left;
    const bool ds_client_done = (ds_done_range && ds_ranges_left2 == 0) || (st == ST_DS_NRANGES && v == 0);
    const i64 ds_clients_left2 = ds_client_done ? ds_clients_left - 1 : ds_clients_left;
    const int after_ds_range = ds_ranges_left2 > 0 ? ST_DS_CLOCK : (ds_clients_left2 > 0 ? ST_DS_CLIENT : ST_DONE);

    // --- content dispatch after the last pre-content field
    const i64 kind4 = info & 0xF;
    const int content_st = content_state(kind4);
    const bool content_unsupported = content_st == ST_ERR;
    const bool has_psub = (info & 0xC0) == 0 && (info & 0x20) != 0;
    const int after_parent = has_psub ? ST_PARENT_SUB : content_st;

    // --- next state
    int st2 = st;
    switch (st) {
      case ST_NCLIENTS: st2 = v > 0 ? ST_NBLOCKS : ST_DS_NCLIENTS; break;
      case ST_NBLOCKS: st2 = ST_CLIENT; break;
      case ST_CLIENT: st2 = ST_CLOCK; break;
      case ST_CLOCK: st2 = blocks_left > 0 ? ST_INFO : (clients_left2 > 0 ? ST_NBLOCKS : ST_DS_NCLIENTS); break;
      case ST_INFO:
        if (v == BLOCK_GC) st2 = ST_GC_LEN;
        else if (v == BLOCK_SKIP) st2 = ST_SKIP_LEN;
        else st2 = (v & 0x80) != 0 ? ST_ORIGIN_C : ((v & 0x40) != 0 ? ST_ROR_C : ST_PARENT_INFO);
        break;
      case ST_ORIGIN_C: st2 = ST_ORIGIN_K; break;
      case ST_ORIGIN_K: st2 = (info & 0x40) != 0 ? ST_ROR_C : content_st; break;
      case ST_ROR_C: st2 = ST_ROR_K; break;
      case ST_ROR_K: st2 = content_st; break;
      case ST_PARENT_INFO: st2 = v == 1 ? ST_PARENT_NAME : ST_PARENT_ID_C; break;
      case ST_PARENT_NAME: st2 = after_parent; break;
      case ST_PARENT_ID_C: st2 = ST_PARENT_ID_K; break;
      case ST_PARENT_ID_K: st2 = after_parent; break;
      case ST_PARENT_SUB: st2 = content_st; break;
      case ST_ANY_COUNT: if (v > 0) st2 = ST_ANY_VAL; break;
      case ST_ANY_VAL: if (map_open) st2 = ST_ANY_MKEY; break;
      case ST_ANY_MKEY: st2 = ST_ANY_MVAL; break;
      case ST_ANY_MVAL:
        if (!map_done) st2 = ST_ANY_MKEY;
        else if (vals_left2 > 0) st2 = ST_ANY_VAL;
        break;
      case ST_JSON_COUNT: if (v > 0) st2 = ST_JSON_VAL; break;
      case ST_FMT_KEY: st2 = ST_FMT_VAL; break;
      case ST_TYPE_TAG: if (type_named) st2 = ST_TYPE_NAME; break;
      case ST_MV_FLAGS: st2 = ST_MV_SC; break;
      case ST_MV_SC: st2 = ST_MV_SK; break;
      case ST_MV_SK: if (!mv_collapsed) st2 = ST_MV_EC; break;
      case ST_MV_EC: st2 = ST_MV_EK; break;
      case ST_DS_NCLIENTS: st2 = v > 0 ? ST_DS_CLIENT : ST_DONE; break;
      case ST_DS_CLIENT: st2 = ST_DS_NRANGES; break;
      case ST_DS_NRANGES: st2 = v > 0 ? ST_DS_CLOCK : (ds_clients_left2 > 0 ? ST_DS_CLIENT : ST_DONE); break;
      case ST_DS_CLOCK: st2 = ST_DS_LEN; break;
      default: break;
    }
    if (block_end) st2 = after_block;
    if (ds_done_range) st2 = after_ds_range;

    const bool unsupported = (st == ST_ORIGIN_K && (info & 0x40) == 0 && content_unsupported) ||
                             (st == ST_ROR_K && content_unsupported) ||
                             ((st == ST_PARENT_NAME || st == ST_PARENT_ID_K) && !has_psub && content_unsupported) ||
                             (st == ST_PARENT_SUB && content_unsupported) || key_too_long || any_bad_tag ||
                             (st == ST_TYPE_TAG && (v == 7 || v >= 8));
    if (unsupported) st2 = ST_ERR;

    // --- row / delete-range emission, from the registers before this step
    bool emit = emit_row_st && st != ST_SKIP_LEN && blk_len > 0;
    const bool row_ovf = emit && n_rows >= U;
    emit = emit && !row_ovf;
    if (emit) {
      const bool gc = st == ST_GC_LEN;
      i64 ref = -1;
      if (is_str) ref = lane_ref + str_start;
      else if (list_done || st == ST_FMT_VAL || st == ST_TYPE_NAME) ref = lane_ref + cref;
      else if (st == ST_SPAN1 || st == ST_TYPE_TAG) ref = lane_ref + pos;
      // ContentMove range fields: assoc 0 = After, -1 = Before; a collapsed
      // move's end id is its start id
      i64* out = my_rows + n_rows;
      out[COL_CLIENT * SU] = client;
      out[COL_CLOCK * SU] = clock;
      out[COL_LENGTH * SU] = blk_len;
      out[COL_OC * SU] = gc ? -1 : oc;
      out[COL_OK * SU] = gc ? 0 : ok;
      out[COL_RC * SU] = gc ? -1 : rc;
      out[COL_RK * SU] = gc ? 0 : rk;
      out[COL_KIND * SU] = gc ? BLOCK_GC : (is_str ? CONTENT_STRING : kind4);
      out[COL_REF * SU] = ref;
      out[COL_PTAG * SU] = gc ? 0 : ptag;
      out[COL_PC * SU] = gc ? -1 : pc;
      out[COL_PK * SU] = gc ? 0 : pk;
      out[COL_KEYH * SU] = gc ? -1 : keyh;
      out[COL_ROOTH * SU] = gc ? -1 : rooth;
      out[COL_MSC * SU] = move_done ? msc : -1;
      out[COL_MSK * SU] = move_done ? (st == ST_MV_SK ? v : msk) : 0;
      out[COL_MSA * SU] = move_done ? ((mvf & 2) != 0 ? 0 : -1) : 0;
      out[COL_MEC * SU] = move_done ? (mv_collapsed ? msc : mec) : -1;
      out[COL_MEK * SU] = move_done ? v : 0;
      out[COL_MEA * SU] = move_done ? ((mvf & 4) != 0 ? 0 : -1) : 0;
      out[COL_MPRIO * SU] = move_done ? (mvf >> 6) : -1;
      my_rvalid[n_rows] = 1;
    }
    bool emit_d = ds_done_range && v > 0;
    const bool del_ovf = emit_d && n_dels >= R;
    emit_d = emit_d && !del_ovf;
    if (emit_d) {
      i64* out = my_dels + n_dels;
      out[DEL_CLIENT * SR] = ds_client;
      out[DEL_START * SR] = ds_clock;
      out[DEL_END * SR] = wrap32(ds_clock + v);
      my_dvalid[n_dels] = 1;
    }

    // --- registers
    if (unsupported) flags |= FLAG_UNSUPPORTED;
    if (st == ST_NCLIENTS && v > 1) flags |= FLAG_MULTI_CLIENT;
    if (row_ovf || del_ovf) flags |= FLAG_OVERFLOW;
    const bool count_st = st == ST_ANY_COUNT || st == ST_JSON_COUNT;
    if (count_st || st == ST_FMT_KEY || st == ST_TYPE_TAG) cref = pos;
    pos = pos_after;
    clients_left = st == ST_NCLIENTS ? v : clients_left2;
    blocks_left = st == ST_NBLOCKS ? v : blocks_left2;
    const i64 clock2 = st == ST_CLOCK ? v : clock;
    clock = wrap32(block_end ? clock2 + blk_len : clock2);
    if (count_st) vals_n = v;
    vals_left = count_st ? v : vals_left2;
    ds_clients_left = st == ST_DS_NCLIENTS ? v : ds_clients_left2;
    ds_ranges_left = st == ST_DS_NRANGES ? v : ds_ranges_left2;
    mpairs = map_open ? val2 : mpairs2;
    n_rows += emit;
    n_dels += emit_d;
    switch (st) {
      case ST_CLIENT: client = vc; break;
      case ST_INFO:  // a fresh block
        info = v;
        keyh = -1;
        rooth = -1;
        oc = -1;
        ok = 0;
        rc = -1;
        rk = 0;
        ptag = 0;
        pc = -1;
        pk = 0;
        break;
      case ST_PARENT_SUB: keyh = khash; break;
      case ST_PARENT_NAME: rooth = v <= KEY_HASH_BYTES ? khash : -2; break;
      case ST_ORIGIN_C: oc = vc; break;
      case ST_ORIGIN_K: ok = v; break;
      case ST_ROR_C: rc = vc; break;
      case ST_ROR_K: rk = v; break;
      case ST_PARENT_INFO: ptag = v == 1 ? 1 : 2; break;
      case ST_PARENT_ID_C: pc = vc; break;
      case ST_PARENT_ID_K: pk = v; break;
      case ST_DS_CLIENT: ds_client = vc; break;
      case ST_DS_CLOCK: ds_clock = v; break;
      case ST_MV_FLAGS: mvf = v; break;
      case ST_MV_SC: msc = vc; break;
      case ST_MV_SK: msk = v; break;
      case ST_MV_EC: mec = vc; break;
      default: break;
    }
    st = st2;
  }

  if (st != ST_DONE) flags |= FLAG_MALFORMED;
  flags_out[s] = flags;
  if (steps_out != nullptr) steps_out[s] = step;
  // the rows and ranges not emitted hold the plain version's defaults
  for (i64 j = n_rows; j < U; ++j) {
    i64* out = my_rows + j;
    out[COL_CLIENT * SU] = 0;
    out[COL_CLOCK * SU] = 0;
    out[COL_LENGTH * SU] = 0;
    out[COL_OC * SU] = -1;
    out[COL_OK * SU] = 0;
    out[COL_RC * SU] = -1;
    out[COL_RK * SU] = 0;
    out[COL_KIND * SU] = 0;
    out[COL_REF * SU] = -1;
    out[COL_PTAG * SU] = 0;
    out[COL_PC * SU] = -1;
    out[COL_PK * SU] = 0;
    out[COL_KEYH * SU] = -1;
    out[COL_ROOTH * SU] = -1;
    out[COL_MSC * SU] = -1;
    out[COL_MSK * SU] = 0;
    out[COL_MSA * SU] = 0;
    out[COL_MEC * SU] = -1;
    out[COL_MEK * SU] = 0;
    out[COL_MEA * SU] = 0;
    out[COL_MPRIO * SU] = -1;
    my_rvalid[j] = 0;
  }
  for (i64 j = n_dels; j < R; ++j) {
    i64* out = my_dels + j;
    out[DEL_CLIENT * SR] = 0;
    out[DEL_START * SR] = 0;
    out[DEL_END * SR] = 0;
    my_dvalid[j] = 0;
  }
}

}  // namespace

// One launch on `stream` over S lanes: rows [ROW_COLS, S, U] and dels
// [DEL_COLS, S, R] int64 with their valid bytes [S, U] / [S, R], flags [S]
// int64 and, where `steps` is not null, each lane's step count [S] int32.
// Returns the launch's cudaError_t (0 when it was queued).
extern "C" int ytpu_decode_v1(const void* buf, const void* lens, int S, int L, int U, int R, int T,
                              long long max_sec, void* rows, void* rvalid, void* dels, void* dvalid,
                              void* flags, void* steps, void* stream) {
  if (S <= 0) return 0;
  const int blocks = (S + THREADS - 1) / THREADS;
  decode_v1_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)buf, (const i64*)lens, S, L, U, R, T, max_sec, (i64*)rows, (uint8_t*)rvalid,
      (i64*)dels, (uint8_t*)dvalid, (i64*)flags, (int*)steps);
  return (int)cudaGetLastError();
}

extern "C" const char* ytpu_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
