// The intern-table resolve of `decode_kernel._resolve_and_pack`, shared by
// the V1 decode program (decode.cu) and the V2 one (decode_v2.cu): both
// write the int32 UpdateBatch, and resolve each row's ids, key hash and
// root name through the tables as the row is emitted.
//
// Included once by each source, inside its anonymous namespace, after
// <cuda_runtime.h> and <cstdint>; it includes nothing itself. (The host
// emulator's tests paste it into the source text in place of the
// #include, so that a mutant can rewrite its lines.)
//
// Semantics, bit for bit with `_resolve_and_pack`:
//   * ids go through the raw client table, then ids <= -2 through the
//     client-hash table: an empty raw table flags FLAG_UNKNOWN_CLIENT for
//     raw ids (>= 0) and leaves them raw; a raw miss is -1 and flags it; no
//     hash table flags FLAG_BIG_CLIENT, a hash miss FLAG_UNKNOWN_CLIENT;
//   * a key hash >= 0 goes through the key table, a miss (or no table)
//     flags FLAG_UNKNOWN_KEY; a named root equal to the lane's primary maps
//     to p_root -1, another name through the key table (a miss flags
//     FLAG_UNKNOWN_KEY), a name past the hash window FLAG_UNSUPPORTED;
//   * the callers resolve only the rows and ranges they emit, so only those
//     raise flags; a row not emitted holds `row_default`.

typedef long long i64;
typedef unsigned int u32;
typedef unsigned long long u64;

constexpr i64 FLAG_UNSUPPORTED = 1;
constexpr i64 FLAG_OVERFLOW = 2;
constexpr i64 FLAG_MALFORMED = 4;
constexpr i64 FLAG_BIG_CLIENT = 8;
constexpr i64 FLAG_MULTI_CLIENT = 16;
constexpr i64 FLAG_UNKNOWN_CLIENT = 32;
constexpr i64 FLAG_UNKNOWN_KEY = 64;
constexpr i64 FLAG_ERRORS =
    FLAG_UNSUPPORTED | FLAG_OVERFLOW | FLAG_MALFORMED | FLAG_BIG_CLIENT | FLAG_UNKNOWN_CLIENT | FLAG_UNKNOWN_KEY;

// the int32 row planes, in UpdateBatch order, and the delete planes
enum RowField : int {
  F_CLIENT, F_CLOCK, F_LENGTH, F_OCLIENT, F_OCLOCK, F_RCLIENT, F_RCLOCK, F_KIND, F_REF, F_COFF, F_KEY,
  F_PTAG, F_PCLIENT, F_PCLOCK, F_PROOT, F_MSC, F_MSK, F_MSA, F_MEC, F_MEK, F_MEA, F_MPRIO, ROW_FIELDS
};
enum DelField : int { D_CLIENT, D_START, D_END, DEL_FIELDS };

// a sorted (keys, perm) intern table; n < 0: no table
struct Table {
  const int* keys;
  const int* perm;
  i64 n;
};

// the intern tables of a launch: raw clients, client hashes, key hashes,
// and the primary root hash [1] or [S] (-1 = single root; null: none).
// Each program's Params derives from it.
struct Interns {
  Table ct, cht, kt;
  const int* prim;
  i64 n_prim;
};

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
__device__ __forceinline__ i64 resolve_id(const Interns& P, i64 x, i64& fl) {
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
__device__ __forceinline__ i64 resolve_key(const Interns& P, i64 keyh, i64& fl) {
  if (keyh < 0) return -1;
  i64 v;
  if (P.kt.n > 0 && table_find(P.kt, keyh, v)) return v;
  fl |= FLAG_UNKNOWN_KEY;
  return -1;
}

// lane s's primary root hash (-1: none)
__device__ __forceinline__ i64 lane_prim(const Interns& P, int s) {
  return P.prim != nullptr ? __ldg(P.prim + (P.n_prim == 1 ? 0 : s)) : -1;
}

// a named root parent -> -1 for the lane's primary root (or no root table),
// else its anchor's key id
__device__ __forceinline__ i64 resolve_root(const Interns& P, i64 ptag, i64 rooth, i64 prim, i64& fl) {
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
