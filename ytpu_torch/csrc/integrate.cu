// Hand-written Hopper integrate kernel: one doc per CTA replays a whole
// S-step update stream (rows, then delete ranges, then the move-ownership
// recompute, per step) into that doc's packed block planes, in place.
//
// Replaces: the fused Pallas TPU kernel `_kernel` of
// ytpu/ops/integrate_kernel.py (body :283-1043, launched at :1057).
//
// What bounds it on this card: the YATA integrate is a serial chain of
// dependent lookups per doc (find the origin block, split it, walk the
// conflict scan, link). The Pallas kernel answers every lookup with a
// one-hot sweep over all C slots of a VMEM tile; on a GPU the planes live
// in device memory (26 x C x 4 B per doc, 6.8 MB at C = 65,536), so a
// sweep per lookup would move ~10^13-10^14 bytes over the full B4 replay.
// The kernel is therefore latency-bound on dependent global loads, not
// bandwidth-bound.
//
// What the design does about it:
//   * find_slot never sweeps. At launch start the CTA builds, per doc and
//     in device scratch, (a) a hash map (client, start clock) -> slot and
//     (b) a 5-level hashed bitmap of block starts per client (64-way
//     words, keys (client, level, clock >> 6(level+1))). find_slot asks
//     (b) for the largest start <= clock (a predecessor query of a few
//     probes), maps it to its slot through (a) and checks coverage.
//     Blocks of one client never overlap in clock (the client_clock gate
//     appends only past the client's clock; splits and compaction
//     preserve the partition), so the only covering slot is also the
//     smallest one, which is what the Pallas find_slot returns. Appends
//     and splits add their start to both structures; compaction renumbers
//     slots between launches, so the structures are rebuilt per launch.
//   * client_clock reads a per-doc client -> max clock table (clients in
//     [0, KC)); other clients fall back to the exact sweep.
//   * the delete-range mark walks block starts in [start, end) with a
//     successor query instead of sweeping every slot.
//   * the conflict scan's `before` / `conflicting` sets are epoch-stamped
//     slot arrays: clearing a set is one counter increment.
//   * the two-tier scan accounting (cheap tier of `cheap` trips in
//     lockstep, wide tier of `unroll` steps per trip) is reproduced in
//     closed form from the serial width w: min(w, cheap) cheap trips and
//     ceil((w - cheap) / unroll) wide trips when w > cheap.
//   * after the parallel index build, thread 0 of the CTA runs the doc's
//     serial integrate; the map-chain head, root-anchor and move-recompute
//     searches stay sweeps over the live slots (they run only for map,
//     named-root and move rows).
//
// Semantics follow `_kernel` exactly, including its edge cases: gather of
// idx < 0 yields the fill, of idx >= C yields 0; put drops idx < 0 and
// idx >= C; a split on a full doc sets ERR_CAPACITY without splitting; the
// fused kernel never reads or writes the OS plane.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libytpu_integrate.so integrate.cu

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NC = 26;
enum Plane {
  CL, CK, LN, OC, OK, RC, RK, LT, RT, DL, CN, KD, RF, OF, KEY, PA, HD, MV,
  MSC, MSK, MSA, MEC, MEK, MEA, MPR, OS
};
constexpr int M_START = 0, M_NBLOCKS = 1, M_ERROR = 2, M_MDIRTY = 3;
constexpr int M_HIST0 = 4, M_PAD = 32;
constexpr int SC_MAX = 8, SC_CHEAP = 9, SC_WIDE = 10, SC_CHEAP_TRIPS = 11,
              SC_WIDE_TRIPS = 12, SC_WIDTH_SUM = 13, SC_WORDS = 14;
constexpr int ERR_CAPACITY = 1, ERR_MISSING_DEP = 2;
constexpr int BLOCK_GC = 0, CONTENT_DELETED = 1, CONTENT_FORMAT = 6,
              CONTENT_MOVE = 11, BLOCK_ROOT_ANCHOR = 12;
constexpr int ROW_W = 23, DEL_W = 4;
constexpr int LEVELS = 5;
constexpr unsigned long long EMPTY = ~0ull;
constexpr int THREADS = 256;

}  // namespace

// client -> max clock table width (clients outside [0, KC) use a sweep)
#define YTPU_KC 1024

namespace {

struct Doc {
  int* p[NC];
  int C;
  int nb, start, err, mdirty;
  int sc[SC_WORDS];
  unsigned long long* bkeys;
  unsigned long long* bwords;
  uint32_t bmask;
  unsigned long long* skeys;
  int* svals;
  uint32_t smask;
  int* cclock;
  int* bstamp;
  int* cstamp;
  int row_epoch, conf_epoch;
  const int* rank;
  int K;
  int cheap, unroll;
};

__device__ __forceinline__ uint32_t hmix(unsigned long long k) {
  k ^= k >> 33;
  k *= 0xff51afd7ed558ccdULL;
  k ^= k >> 33;
  k *= 0xc4ceb9fe1a85ec53ULL;
  k ^= k >> 33;
  return (uint32_t)k;
}

__device__ __forceinline__ unsigned long long skey(int c, int k) {
  return ((unsigned long long)(uint32_t)c << 32) | (uint32_t)k;
}

__device__ __forceinline__ unsigned long long bkey(int c, int lvl, uint32_t b) {
  return ((unsigned long long)(uint32_t)c << 32) |
         ((unsigned long long)lvl << 28) | b;
}

// ---- index: parallel build (atomics) -------------------------------------

__device__ void start_put_atomic(Doc& d, int c, int k, int slot) {
  unsigned long long key = skey(c, k);
  uint32_t i = hmix(key) & d.smask;
  while (true) {
    unsigned long long prev = atomicCAS(&d.skeys[i], EMPTY, key);
    if (prev == EMPTY || prev == key) {
      atomicMin(&d.svals[i], slot);
      return;
    }
    i = (i + 1) & d.smask;
  }
}

__device__ void bit_set_atomic(Doc& d, int c, int k) {
  for (int lvl = 0; lvl < LEVELS; ++lvl) {
    uint32_t b = (uint32_t)k >> (6 * (lvl + 1));
    unsigned long long bit = 1ull << (((uint32_t)k >> (6 * lvl)) & 63);
    unsigned long long key = bkey(c, lvl, b);
    uint32_t i = hmix(key) & d.bmask;
    while (true) {
      unsigned long long prev = atomicCAS(&d.bkeys[i], EMPTY, key);
      if (prev == EMPTY || prev == key) break;
      i = (i + 1) & d.bmask;
    }
    unsigned long long old = atomicOr(&d.bwords[i], bit);
    if (old & bit) return;  // the levels above were set by that insert
  }
}

// ---- index: serial use (thread 0 only) -------------------------------------

__device__ int start_find(const Doc& d, int c, int k) {
  unsigned long long key = skey(c, k);
  uint32_t i = hmix(key) & d.smask;
  while (true) {
    unsigned long long kk = d.skeys[i];
    if (kk == key) return d.svals[i];
    if (kk == EMPTY) return -1;
    i = (i + 1) & d.smask;
  }
}

__device__ void start_put(Doc& d, int c, int k, int slot) {
  unsigned long long key = skey(c, k);
  uint32_t i = hmix(key) & d.smask;
  while (true) {
    unsigned long long kk = d.skeys[i];
    if (kk == EMPTY) {
      d.skeys[i] = key;
      d.svals[i] = slot;
      return;
    }
    if (kk == key) {
      if (slot < d.svals[i]) d.svals[i] = slot;
      return;
    }
    i = (i + 1) & d.smask;
  }
}

__device__ unsigned long long word_get(const Doc& d, int c, int lvl, uint32_t b) {
  unsigned long long key = bkey(c, lvl, b);
  uint32_t i = hmix(key) & d.bmask;
  while (true) {
    unsigned long long kk = d.bkeys[i];
    if (kk == key) return d.bwords[i];
    if (kk == EMPTY) return 0;
    i = (i + 1) & d.bmask;
  }
}

__device__ void bit_set(Doc& d, int c, int k) {
  for (int lvl = 0; lvl < LEVELS; ++lvl) {
    uint32_t b = (uint32_t)k >> (6 * (lvl + 1));
    unsigned long long bit = 1ull << (((uint32_t)k >> (6 * lvl)) & 63);
    unsigned long long key = bkey(c, lvl, b);
    uint32_t i = hmix(key) & d.bmask;
    while (true) {
      unsigned long long kk = d.bkeys[i];
      if (kk == key) break;
      if (kk == EMPTY) {
        d.bkeys[i] = key;
        d.bwords[i] = 0;
        break;
      }
      i = (i + 1) & d.bmask;
    }
    unsigned long long old = d.bwords[i];
    d.bwords[i] = old | bit;
    if (old & bit) return;
  }
}

// largest block start <= x for client c, -1 if none (x >= 0)
__device__ int pred_start(const Doc& d, int c, int x) {
  for (int lvl = 0; lvl < LEVELS; ++lvl) {
    uint32_t b = (uint32_t)x >> (6 * (lvl + 1));
    int bit = ((uint32_t)x >> (6 * lvl)) & 63;
    unsigned long long w = word_get(d, c, lvl, b);
    unsigned long long m =
        lvl == 0 ? (w & ((2ull << bit) - 1)) : (w & ((1ull << bit) - 1));
    if (m) {
      uint32_t cur = (b << 6) | (uint32_t)(63 - __clzll((long long)m));
      for (int l = lvl - 1; l >= 0; --l) {
        unsigned long long w2 = word_get(d, c, l, cur);
        if (w2 == 0) return -1;
        cur = (cur << 6) | (uint32_t)(63 - __clzll((long long)w2));
      }
      return (int)cur;
    }
  }
  return -1;
}

// smallest block start >= x for client c, -1 if none (x >= 0)
__device__ int succ_start(const Doc& d, int c, int x) {
  for (int lvl = 0; lvl < LEVELS; ++lvl) {
    uint32_t b = (uint32_t)x >> (6 * (lvl + 1));
    int bit = ((uint32_t)x >> (6 * lvl)) & 63;
    unsigned long long w = word_get(d, c, lvl, b);
    unsigned long long m =
        lvl == 0 ? (w & ~((1ull << bit) - 1)) : (w & ~((2ull << bit) - 1));
    if (m) {
      uint32_t cur = (b << 6) | (uint32_t)(__ffsll((long long)m) - 1);
      for (int l = lvl - 1; l >= 0; --l) {
        unsigned long long w2 = word_get(d, c, l, cur);
        if (w2 == 0) return -1;
        cur = (cur << 6) | (uint32_t)(__ffsll((long long)w2) - 1);
      }
      return (int)cur;
    }
  }
  return -1;
}

// a new block [k, k + l) of client c at `slot`
__device__ void index_add(Doc& d, int c, int k, int l, int slot) {
  if (l > 0 && k >= 0) {
    start_put(d, c, k, slot);
    bit_set(d, c, k);
  }
  if (c >= 0 && c < YTPU_KC) {
    int e = k + l;
    if (e > d.cclock[c]) d.cclock[c] = e;
  }
}

// ---- column access with the Pallas kernel's gather/put semantics ---------

__device__ __forceinline__ int gat(const Doc& d, int plane, int idx, int fill) {
  if (idx < 0) return fill;
  if (idx >= d.C) return 0;  // no one-hot hit
  return d.p[plane][idx];
}

__device__ __forceinline__ void put(Doc& d, int plane, int idx, int v) {
  if (idx >= 0 && idx < d.C) d.p[plane][idx] = v;
}

__device__ __forceinline__ int gather_rank(const Doc& d, int client) {
  int c = client > 0 ? client : 0;
  return c < d.K ? d.rank[c] : 0;
}

__device__ int client_clock(const Doc& d, int c) {
  if (c >= 0 && c < YTPU_KC) return d.cclock[c];
  int best = 0;
  for (int s = 0; s < d.nb; ++s)
    if (d.p[CL][s] == c) {
      int e = d.p[CK][s] + d.p[LN][s];
      if (e > best) best = e;
    }
  return best;
}

// (idx, found) of the block covering (c, x): the smallest such slot
__device__ int find_slot(const Doc& d, int c, int x, bool enable, bool* found) {
  *found = false;
  if (!enable) return -1;
  if (x < 0) {  // not indexed (block clocks are >= 0): exact sweep
    for (int s = 0; s < d.nb; ++s)
      if (d.p[CL][s] == c && d.p[CK][s] <= x && x < d.p[CK][s] + d.p[LN][s]) {
        *found = true;
        return s;
      }
    return -1;
  }
  int st = pred_start(d, c, x);
  if (st < 0) return -1;
  int s = start_find(d, c, st);
  if (s < 0 || s >= d.nb) return -1;
  if (d.p[CL][s] == c && d.p[CK][s] <= x && x < d.p[CK][s] + d.p[LN][s]) {
    *found = true;
    return s;
  }
  return -1;
}

__device__ int split(Doc& d, int i, int off, bool want) {
  int length_i = gat(d, LN, i, 0);
  bool doit = want && i >= 0 && off > 0 && off < length_i;
  int j = d.nb;
  if (doit && j >= d.C) {
    d.err |= ERR_CAPACITY;
    doit = false;
  }
  if (!doit) return i;
  int cl = d.p[CL][i], ck = d.p[CK][i];
  int right_i = d.p[RT][i];
  int rc = d.p[RC][i], rk = d.p[RK][i];
  int dl = d.p[DL][i], cn = d.p[CN][i], kd = d.p[KD][i];
  int rf = d.p[RF][i], of = d.p[OF][i], key = d.p[KEY][i];
  int pa = d.p[PA][i], hd = d.p[HD][i], mv = d.p[MV][i];
  d.p[CL][j] = cl;
  d.p[CK][j] = ck + off;
  d.p[LN][j] = length_i - off;
  d.p[OC][j] = cl;
  d.p[OK][j] = ck + off - 1;
  d.p[RC][j] = rc;
  d.p[RK][j] = rk;
  d.p[LT][j] = i;
  d.p[RT][j] = right_i;
  d.p[DL][j] = dl;
  d.p[CN][j] = cn;
  d.p[KD][j] = kd;
  d.p[RF][j] = rf;
  d.p[OF][j] = of + off;
  d.p[KEY][j] = key;
  d.p[PA][j] = pa;
  d.p[HD][j] = hd;
  d.p[MV][j] = mv;
  d.p[MSC][j] = -1;
  d.p[MSK][j] = 0;
  d.p[MSA][j] = 0;
  d.p[MEC][j] = -1;
  d.p[MEK][j] = 0;
  d.p[MEA][j] = 0;
  d.p[MPR][j] = -1;
  d.p[LN][i] = off;
  d.p[RT][i] = j;
  put(d, LT, right_i, j);
  d.nb += 1;
  index_add(d, cl, ck + off, length_i - off, j);
  return j;
}

__device__ int clean_end(Doc& d, int c, int x, bool enable, bool* found) {
  int i = find_slot(d, c, x, enable, found);
  int off = x - gat(d, CK, i, 0) + 1;
  split(d, i, off, enable && *found);
  return i;
}

__device__ int clean_start(Doc& d, int c, int x, bool enable, bool* found) {
  int i = find_slot(d, c, x, enable, found);
  int off = x - gat(d, CK, i, 0);
  int j = split(d, i, off, enable && *found);
  return (i >= 0 && off > 0) ? j : i;
}

__device__ __forceinline__ bool origins_equal(bool ha, int ca, int ka, bool hb,
                                              int cb, int kb) {
  return (!ha && !hb) || (ha && hb && ca == cb && ka == kb);
}

__device__ int scan_bucket(int w) {
  const int th[7] = {2, 4, 8, 16, 32, 64, 128};
  int b = 0;
  for (int t = 0; t < 7; ++t) b += (w >= th[t]) ? 1 : 0;
  return b;
}

__device__ void integrate_row(Doc& d, const int* r) {
  const int r_client = r[0], r_clock = r[1], r_len = r[2], r_oc = r[3],
            r_ok = r[4], r_rc = r[5], r_rk = r[6], r_kind = r[7], r_ref = r[8],
            r_off = r[9], r_key = r[10], r_ptag = r[11], r_pclient = r[12],
            r_pclock = r[13], r_mv_sc = r[15], r_mv_sk = r[16],
            r_mv_sa = r[17], r_mv_ec = r[18], r_mv_ek = r[19],
            r_mv_ea = r[20], r_mv_prio = r[21], r_proot = r[22];
  const bool is_move_row = r_kind == CONTENT_MOVE;

  const int local = client_clock(d, r_client);
  const bool applicable = local >= r_clock;
  bool missing = !applicable;
  const int offset = local - r_clock;
  const bool dup = applicable && offset >= r_len;
  bool doit = applicable && !dup;

  const int clock = r_clock + offset;
  const int length = r_len - offset;
  const int c_off = r_off + offset;
  const bool has_origin = offset > 0 || r_oc >= 0;
  const int origin_client = offset > 0 ? r_client : r_oc;
  const int origin_clock = offset > 0 ? clock - 1 : r_ok;
  const bool has_ror = r_rc >= 0;
  const bool is_gc = r_kind == BLOCK_GC;
  bool linkable = doit && !is_gc;

  bool lfound, rfound;
  int left_idx = clean_end(d, origin_client, origin_clock, linkable && has_origin, &lfound);
  int right_idx = clean_start(d, r_rc, r_rk, linkable && has_ror, &rfound);
  left_idx = (linkable && has_origin) ? left_idx : -1;
  right_idx = (linkable && has_ror) ? right_idx : -1;
  const bool anchor_missing = (linkable && has_origin && left_idx < 0) ||
                              (linkable && has_ror && right_idx < 0);
  missing = missing || anchor_missing;
  linkable = linkable && !anchor_missing;

  // parent branch: p_tag 2 = nested branch by id; 1 = root; 0 = inherit
  bool pfound;
  const int parent_slot =
      find_slot(d, r_pclient, r_pclock, linkable && r_ptag == 2, &pfound);
  const int left_parent = gat(d, PA, left_idx, -1);
  const int right_parent = gat(d, PA, right_idx, -1);
  const int inherited_parent = left_idx >= 0 ? left_parent : right_parent;
  bool anchor_found = false;
  int anchor_idx = -1;
  if (r_ptag == 1 && r_proot >= 0) {
    for (int s = 0; s < d.nb; ++s)
      if (d.p[KD][s] == BLOCK_ROOT_ANCHOR && d.p[KEY][s] == r_proot) {
        anchor_idx = s;
        anchor_found = true;
        break;
      }
  }
  const int root_row = (r_proot >= 0 && anchor_found) ? anchor_idx : -1;
  const int parent_row =
      r_ptag == 2 ? parent_slot : (r_ptag == 1 ? root_row : inherited_parent);
  const bool parent_missing =
      linkable && ((r_ptag == 2 && parent_slot < 0) ||
                   (r_ptag == 1 && r_proot >= 0 && !anchor_found));
  missing = missing || parent_missing;
  linkable = linkable && !parent_missing;

  // parent_sub inherited from the anchors when omitted on the wire
  const int left_key = gat(d, KEY, left_idx, -1);
  const int right_key = gat(d, KEY, right_idx, -1);
  const int key_v = r_key >= 0 ? r_key : (left_key >= 0 ? left_key : right_key);
  const bool is_map = key_v >= 0;

  // map rows anchor on their (parent, key) chain's leftmost item
  int chain_head = -1;
  if (is_map) {
    for (int s = 0; s < d.nb; ++s)
      if (d.p[KEY][s] == key_v && d.p[PA][s] == parent_row && d.p[LT][s] == -1) {
        chain_head = s;
        break;
      }
  }
  const int seq_head = parent_row >= 0 ? gat(d, HD, parent_row, -1) : d.start;
  const int anchor0_base = is_map ? chain_head : seq_head;

  const int right_left = gat(d, LT, right_idx, -1);
  const bool need_scan =
      linkable && ((left_idx < 0 && (right_idx < 0 || right_left >= 0)) ||
                   (left_idx >= 0 && gat(d, RT, left_idx, -1) != right_idx));

  if (need_scan) {
    int o = left_idx >= 0 ? gat(d, RT, left_idx, -1) : anchor0_base;
    int left = left_idx;
    int width = 0;
    const int rank_r = gather_rank(d, r_client);
    d.row_epoch += 1;
    d.conf_epoch += 1;
    while (o >= 0 && o != right_idx) {
      width += 1;
      if (o < d.C) {  // a one-hot over C lanes has no hit at o >= C
        d.bstamp[o] = d.row_epoch;
        d.cstamp[o] = d.conf_epoch;
      }
      const int o_oc = gat(d, OC, o, -1), o_ok = gat(d, OK, o, 0);
      const bool same_origin = origins_equal(has_origin, origin_client,
                                             origin_clock, o_oc >= 0, o_oc, o_ok);
      const int o_rc = gat(d, RC, o, -1), o_rk = gat(d, RK, o, 0);
      const bool same_ror =
          origins_equal(has_ror, r_rc, r_rk, o_rc >= 0, o_rc, o_rk);
      const int rank_o = gather_rank(d, gat(d, CL, o, -1));
      const bool case1_take = same_origin && rank_o < rank_r;
      const bool case1_break = same_origin && !case1_take && same_ror;
      bool oo_found;
      const int oo_idx = find_slot(d, o_oc, o_ok, o_oc >= 0, &oo_found);
      const bool in_before = oo_found && d.bstamp[oo_idx] == d.row_epoch;
      const bool in_conf = oo_found && d.cstamp[oo_idx] == d.conf_epoch;
      const bool case2_take = !same_origin && in_before && !in_conf;
      const bool case2_break = !same_origin && !in_before;
      if (case1_take || case2_take) {
        left = o;
        d.conf_epoch += 1;  // conflicting := {}
      }
      if (case1_break || case2_break) break;
      o = gat(d, RT, o, -1);
    }
    left_idx = left;
    // scan record: the two-tier trip accounting in closed form
    const int wb = width;
    d.sc[scan_bucket(wb)] += 1;
    if (wb > d.sc[SC_MAX]) d.sc[SC_MAX] = wb;
    const int wide_trips =
        wb > d.cheap ? (wb - d.cheap + d.unroll - 1) / d.unroll : 0;
    if (wide_trips > 0)
      d.sc[SC_WIDE] += 1;
    else
      d.sc[SC_CHEAP] += 1;
    d.sc[SC_CHEAP_TRIPS] += wb < d.cheap ? wb : d.cheap;
    d.sc[SC_WIDE_TRIPS] += wide_trips;
    d.sc[SC_WIDTH_SUM] += wb;
  }

  const int j = d.nb;
  const bool overflow = doit && j >= d.C;
  doit = doit && j < d.C;
  linkable = linkable && j < d.C;

  const bool has_left = linkable && left_idx >= 0;
  const int right_final =
      has_left ? gat(d, RT, left_idx, -1) : (linkable ? anchor0_base : -1);
  if (has_left) put(d, RT, left_idx, j);
  // sequence rows with no left become the head of the root or the parent
  const bool new_head = linkable && !has_left && !is_map;
  if (new_head && parent_row < 0) d.start = j;
  if (new_head && parent_row >= 0) put(d, HD, parent_row, j);
  if (linkable && right_final >= 0) put(d, LT, right_final, j);

  // self-delete on arrival: under a tombstoned parent, or a map row
  // landing with a right neighbor
  const bool parent_deleted = parent_row >= 0 && gat(d, DL, parent_row, 0) == 1;
  const bool dead_on_arrival =
      linkable && (parent_deleted || (is_map && right_final >= 0));
  const bool row_deleted = is_gc || r_kind == CONTENT_DELETED || dead_on_arrival;
  const bool row_countable =
      !row_deleted && r_kind != CONTENT_FORMAT && r_kind != CONTENT_MOVE;

  const int left_moved = has_left ? gat(d, MV, left_idx, -1) : -1;
  const int right_moved = right_final >= 0 ? gat(d, MV, right_final, -1) : -1;
  const int inherit_moved = left_moved == right_moved ? left_moved : -1;
  const bool moved_conflict = linkable && left_moved != right_moved;
  if (moved_conflict || (doit && is_move_row)) d.mdirty = 1;

  if (doit) {
    d.p[CL][j] = r_client;
    d.p[CK][j] = clock;
    d.p[LN][j] = length;
    d.p[OC][j] = has_origin ? origin_client : -1;
    d.p[OK][j] = has_origin ? origin_clock : 0;
    d.p[RC][j] = has_ror ? r_rc : -1;
    d.p[RK][j] = has_ror ? r_rk : 0;
    d.p[LT][j] = linkable ? left_idx : -1;
    d.p[RT][j] = linkable ? right_final : -1;
    d.p[DL][j] = row_deleted ? 1 : 0;
    d.p[CN][j] = row_countable ? 1 : 0;
    d.p[KD][j] = r_kind;
    d.p[RF][j] = r_ref;
    d.p[OF][j] = c_off;
    d.p[KEY][j] = key_v;
    d.p[PA][j] = parent_row;
    d.p[HD][j] = -1;
    d.p[MV][j] = linkable ? inherit_moved : -1;
    d.p[MSC][j] = is_move_row ? r_mv_sc : -1;
    d.p[MSK][j] = is_move_row ? r_mv_sk : 0;
    d.p[MSA][j] = is_move_row ? r_mv_sa : 0;
    d.p[MEC][j] = is_move_row ? r_mv_ec : -1;
    d.p[MEK][j] = is_move_row ? r_mv_ek : 0;
    d.p[MEA][j] = is_move_row ? r_mv_ea : 0;
    d.p[MPR][j] = is_move_row ? r_mv_prio : -1;
  }
  // a map row that became its chain's tail is the key's live value; the
  // previous winner (its immediate left) gets tombstoned
  const bool new_tail = linkable && is_map && right_final < 0;
  if (new_tail && has_left) put(d, DL, left_idx, 1);
  if (doit) {
    d.nb += 1;
    index_add(d, r_client, clock, length, j);
  }
  if (overflow) d.err |= ERR_CAPACITY;
  if (missing) d.err |= ERR_MISSING_DEP;
}

__device__ void delete_range(Doc& d, const int* r) {
  const int client = r[0], start = r[1], end = r[2];
  bool found;
  int i = find_slot(d, client, start, true, &found);
  bool i_ok = found && gat(d, DL, i, 1) == 0;
  split(d, i, start - gat(d, CK, i, 0), i_ok);
  bool kfound;
  int k = find_slot(d, client, end - 1, true, &kfound);
  bool k_ok = kfound && gat(d, DL, k, 1) == 0;
  split(d, k, end - gat(d, CK, k, 0), k_ok);
  // mark every block of `client` with [CK, CK + LN) inside [start, end);
  // tombstoning a live move row dirties the doc
  if (start < 0) {
    for (int s = 0; s < d.nb; ++s)
      if (d.p[CL][s] == client && d.p[CK][s] >= start &&
          d.p[CK][s] + d.p[LN][s] <= end) {
        if (d.p[KD][s] == CONTENT_MOVE && d.p[DL][s] == 0) d.mdirty = 1;
        d.p[DL][s] = 1;
      }
    return;
  }
  int st = succ_start(d, client, start);
  while (st >= 0 && st < end) {
    int s = start_find(d, client, st);
    if (s >= 0 && s < d.nb && d.p[CL][s] == client &&
        d.p[CK][s] + d.p[LN][s] <= end) {
      if (d.p[KD][s] == CONTENT_MOVE && d.p[DL][s] == 0) d.mdirty = 1;
      d.p[DL][s] = 1;
    }
    if (st == 0x7FFFFFFF) break;
    st = succ_start(d, client, st + 1);
  }
}

// ---- move ownership (end-of-step recompute for dirty docs) ---------------

__device__ int resolve_move_ptr(Doc& d, int c, int k, int assoc, bool enable,
                                bool* found) {
  const bool after = assoc >= 0;
  bool found_a, found_b;
  int i_a = clean_start(d, c, k, enable && after && c >= 0, &found_a);
  int i_b = clean_end(d, c, k, enable && !after && c >= 0, &found_b);
  int right_b = gat(d, RT, i_b, -1);
  *found = after ? found_a : found_b;
  return after ? i_a : right_b;
}

__device__ bool claim_move(Doc& d, int s, bool enable) {
  const int msc = gat(d, MSC, s, -1), msk = gat(d, MSK, s, 0),
            msa = gat(d, MSA, s, 0);
  const int mec = gat(d, MEC, s, -1), mek = gat(d, MEK, s, 0),
            mea = gat(d, MEA, s, 0);
  bool s_found, e_found;
  int start = resolve_move_ptr(d, msc, msk, msa, enable, &s_found);
  int endp = resolve_move_ptr(d, mec, mek, mea, enable, &e_found);
  const int par = gat(d, PA, s, -1);
  const int seq_head = par < 0 ? d.start : gat(d, HD, par, -1);
  if (msc < 0) start = seq_head;
  if (mec < 0) endp = -1;
  const bool unresolved =
      enable && ((msc >= 0 && !s_found) || (mec >= 0 && !e_found));
  if (unresolved) d.err |= ERR_MISSING_DEP;
  enable = enable && !unresolved;
  const int prio_s = gat(d, MPR, s, -1);
  const int rank_s = gather_rank(d, gat(d, CL, s, -1));
  const int clock_s = gat(d, CK, s, 0);
  int cur = start;
  for (int n = 0; enable && cur >= 0 && cur != endp && n <= d.C; ++n) {
    const int m = gat(d, MV, cur, -1);
    const int prev_prio = m >= 0 ? gat(d, MPR, m, -1) : -1;
    const int prev_rank = gather_rank(d, gat(d, CL, m, -1));
    const int prev_clock = gat(d, CK, m, 0);
    const bool takes =
        prev_prio < prio_s ||
        (prev_prio == prio_s && m >= 0 &&
         (prev_rank < rank_s || (prev_rank == rank_s && prev_clock < clock_s)));
    // a beaten collapsed move tombstones on the spot
    const int m_msc = gat(d, MSC, m, -1);
    const bool m_collapsed = m >= 0 && m_msc >= 0 && m_msc == gat(d, MEC, m, -2) &&
                             gat(d, MSK, m, 0) == gat(d, MEK, m, -1);
    if (takes && m_collapsed) put(d, DL, m, 1);
    if (takes) put(d, MV, cur, s);
    cur = gat(d, RT, cur, -1);
  }
  return enable;
}

__device__ __forceinline__ bool live_move(const Doc& d, int idx) {
  return gat(d, KD, idx, -1) == CONTENT_MOVE && gat(d, DL, idx, 1) == 0;
}

// does s sit on an ownership cycle of live moves?
__device__ bool move_cycle(const Doc& d, int s, bool enable) {
  int cur = gat(d, MV, s, -1);
  if (!live_move(d, cur)) cur = -1;
  bool hit = false;
  for (int n = 0; enable && cur >= 0 && !hit && n <= d.C; ++n) {
    int nxt = gat(d, MV, cur, -1);
    if (nxt == s && s >= 0) hit = true;
    if (!live_move(d, nxt)) nxt = -1;
    cur = nxt;
  }
  return hit;
}

__device__ void recompute_moves(Doc& d) {
  if (d.mdirty) {
    for (int s = 0; s < d.C; ++s) d.p[MV][s] = -1;
    int from = 0;
    while (true) {
      int s = -1;
      for (int t = from; t < d.nb; ++t)
        if (d.p[KD][t] == CONTENT_MOVE && d.p[DL][t] == 0) {
          s = t;
          break;
        }
      if (s < 0) break;
      bool enable = claim_move(d, s, true);
      bool cyc = move_cycle(d, s, enable);
      if (cyc) {
        // cycle: release every claim and replay without s
        d.p[DL][s] = 1;
        for (int t = 0; t < d.C; ++t) d.p[MV][t] = -1;
        from = 0;
      } else {
        from = s + 1;
      }
    }
  }
  d.mdirty = 0;
}

__global__ void __launch_bounds__(THREADS)
integrate_kernel(int* __restrict__ cols, int* __restrict__ meta,
                 const int* __restrict__ rows, const int* __restrict__ dels,
                 const int* __restrict__ rank, int S, int U, int R, int K,
                 int D, int C, int cheap, int unroll,
                 unsigned long long* bkeys, unsigned long long* bwords, int HB,
                 unsigned long long* skeys, int* svals, int HS, int* cclock,
                 int* bstamp, int* cstamp) {
  const int doc = blockIdx.x;
  const int tid = threadIdx.x;
  Doc d;
  for (int p = 0; p < NC; ++p) d.p[p] = cols + ((size_t)p * D + doc) * C;
  d.C = C;
  d.bkeys = bkeys + (size_t)doc * HB;
  d.bwords = bwords + (size_t)doc * HB;
  d.bmask = (uint32_t)(HB - 1);
  d.skeys = skeys + (size_t)doc * HS;
  d.svals = svals + (size_t)doc * HS;
  d.smask = (uint32_t)(HS - 1);
  d.cclock = cclock + (size_t)doc * YTPU_KC;
  d.bstamp = bstamp + (size_t)doc * C;
  d.cstamp = cstamp + (size_t)doc * C;
  d.rank = rank;
  d.K = K;
  d.cheap = cheap;
  d.unroll = unroll;
  int* m = meta + (size_t)doc * M_PAD;

  // ---- phase 1 (whole CTA): clear scratch, index the live slots -------
  for (int i = tid; i < HB; i += THREADS) {
    d.bkeys[i] = EMPTY;
    d.bwords[i] = 0;
  }
  for (int i = tid; i < HS; i += THREADS) {
    d.skeys[i] = EMPTY;
    d.svals[i] = 0x7FFFFFFF;
  }
  for (int i = tid; i < YTPU_KC; i += THREADS) d.cclock[i] = 0;
  for (int i = tid; i < C; i += THREADS) {
    d.bstamp[i] = 0;
    d.cstamp[i] = 0;
  }
  __syncthreads();
  const int nb0 = m[M_NBLOCKS];
  for (int s = tid; s < nb0; s += THREADS) {
    const int c = d.p[CL][s], k = d.p[CK][s], l = d.p[LN][s];
    if (l > 0 && k >= 0) {
      start_put_atomic(d, c, k, s);
      bit_set_atomic(d, c, k);
    }
    if (c >= 0 && c < YTPU_KC) atomicMax(&d.cclock[c], k + l);
  }
  __syncthreads();
  if (tid != 0) return;

  // ---- phase 2 (thread 0): the doc's serial integrate ------------------
  d.start = m[M_START];
  d.nb = nb0;
  d.err = m[M_ERROR];
  d.mdirty = m[M_MDIRTY];
  for (int w = 0; w < SC_WORDS; ++w) d.sc[w] = m[M_HIST0 + w];
  d.row_epoch = 0;
  d.conf_epoch = 0;
  for (int s = 0; s < S; ++s) {
    for (int u = 0; u < U; ++u) {
      const int* r = rows + ((size_t)s * U + u) * ROW_W;
      if (r[14] == 1) integrate_row(d, r);
    }
    for (int q = 0; q < R; ++q) {
      const int* r = dels + ((size_t)s * R + q) * DEL_W;
      if (r[3] == 1) delete_range(d, r);
    }
    recompute_moves(d);
  }
  m[M_START] = d.start;
  m[M_NBLOCKS] = d.nb;
  m[M_ERROR] = d.err;
  m[M_MDIRTY] = d.mdirty;
  for (int w = 0; w < SC_WORDS; ++w) m[M_HIST0 + w] = d.sc[w];
}

}  // namespace

extern "C" int ytpu_integrate_stream(
    void* cols, void* meta, const void* rows, const void* dels,
    const void* rank, int S, int U, int R, int K, int D, int C, int cheap,
    int unroll, void* bkeys, void* bwords, int HB, void* skeys, void* svals,
    int HS, void* cclock, void* bstamp, void* cstamp, void* stream) {
  if (D <= 0) return 0;
  integrate_kernel<<<D, THREADS, 0, (cudaStream_t)stream>>>(
      (int*)cols, (int*)meta, (const int*)rows, (const int*)dels,
      (const int*)rank, S, U, R, K, D, C, cheap, unroll,
      (unsigned long long*)bkeys, (unsigned long long*)bwords, HB,
      (unsigned long long*)skeys, (int*)svals, HS, (int*)cclock,
      (int*)bstamp, (int*)cstamp);
  return (int)cudaGetLastError();
}

extern "C" int ytpu_integrate_kc() { return YTPU_KC; }

extern "C" const char* ytpu_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
