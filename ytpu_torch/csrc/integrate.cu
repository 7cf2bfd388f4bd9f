// Hand-written Hopper integrate kernel: one warp per doc replays a whole
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
// in device memory (26 x C x 4 B per doc, 6.8 MB at C = 65,536), so the
// kernel is bound by the latency of the dependent global loads on each
// doc's chain, not by bandwidth: the work per step is a few hundred bytes.
//
// What the design does about it, per doc:
//   * the doc's serial logic runs on one warp, all 32 lanes on the same
//     (warp-uniform) scalars and control flow; a load of one address is a
//     broadcast, and every lane stores the same value to the same address
//     (one transaction), so each lane reads back its own writes. Lanes are
//     not bound to run in lockstep, so each group of stores starts with a
//     __syncwarp (warp_stores): no lane's store overtakes another lane's
//     earlier load or store of the same address. Lanes differ only inside
//     the lookup helpers, whose results come back through __ballot_sync /
//     __shfl_sync, and in the sweeps, which scan 32 slots per step
//     (bracketed by __syncwarp where lanes store to different slots).
//   * a cursor cache of the last 32 blocks found or created, one entry
//     (client, start, len, slot) in the registers of each lane, answers
//     find_slot with one ballot and no load. For x >= 0 the block of a
//     client covering x is unique (blocks of one client never overlap in
//     clock: the client_clock gate appends only past the client's clock,
//     splits and compaction keep the partition), so a hit is exact as long
//     as every split updates the entry of the split slot (its len) and
//     enters the new slot. A split refused for capacity leaves the cache as
//     it is. The cache lives for one launch (compaction renumbers slots
//     between launches); x < 0 keeps the exact sweep.
//   * on a miss, a per-launch index in device scratch: a 5-level hashed
//     bitmap of block starts per client (64-way words, keys (client,
//     level, clock >> 6(level+1))) and a hash map (client, start clock) ->
//     slot, both as interleaved 16-byte {key, payload} entries, so one
//     probe is one load. The predecessor query reads the words of all five
//     levels in one round (five lanes per level, each lane one entry of a
//     window of the level's linear-probe chain) and descends only where
//     level 0 misses. Index inserts probe the five levels and the start
//     map in one round, loaded ahead as soon as the new block is known.
//   * a delete range walks the client's blocks block to block through
//     find_slot (the cursor cache first), not through successor queries.
//   * the client -> clock table (clients in [0, KC)) lives in shared
//     memory; other clients sweep.
//   * the stream is staged once per CTA into a ring of shared-memory tiles
//     of T steps by a producer warp with cp.async.bulk (the TMA's 1-D bulk
//     copy) and full/empty mbarriers; a CTA holds DOCS_PER_CTA docs, one
//     consumer warp each, so D = 256 runs as 128 CTAs in one wave.
//   * the loads one step needs from an anchor are issued together, and the
//     doc's scalars (n_blocks, start, error, the move-dirty flag, the 14
//     scan-record words) stay in registers.
//   * the conflict scan's `before` / `conflicting` sets are epoch-stamped
//     slot arrays (clearing a set is one counter increment); its two-tier
//     accounting (min(w, cheap) cheap trips, ceil((w - cheap) / unroll)
//     wide trips when w > cheap) is reproduced in closed form.
//   * phase 1 clears the scratch and indexes the live slots with atomics
//     (the lanes of a warp whose starts share a bitmap word combine their
//     bits into one atomic); the map-chain head, root-anchor and
//     move-recompute searches stay sweeps over the live slots (they run
//     only for map, named-root and move rows).
//   * phase 1's work follows each doc's live rows, not its capacity C: a
//     doc that holds nb0 slots when the launch starts reaches at most
//     n = live_bound(...) of them (the bound is proved there), so its
//     tables are sized from n at the wrapper's load factors (`tables_for`)
//     and only their prefixes and slots [0, n) of the two stamp arrays are
//     cleared: every slot a stamp is written or read for lies below nb, and
//     nb stays below n. The wrapper allocates C-sized scratch and reads
//     nothing back: each doc sizes its own tables from its meta word.
//
// Two entries share the body (`integrate_body`). `ytpu_integrate_stream`
// replays one [S, U, 23] / [S, R, 4] stream into every doc through the
// ring, phase 1 on every warp of its CTA. `ytpu_integrate_batch` (the port
// of `apply_update_batch`'s vmapped `_apply_update_one_doc`) integrates
// one step of each doc's own [U, 23] rows and [R, 4] deletes in two
// launches. Its phase 1 is a kernel of its own,
// `integrate_batch_index_kernel`: one CTA of INDEX_THREADS a doc and few
// registers, so a whole wave of docs indexes at once (phase 1 is a chain
// of dependent atomics a row; on the integrate kernel's 96 threads of 160-
// odd registers per two docs its index build took most of a 0.42 ms
// launch at 1,024 docs x 8,192 slots on an H100). Then `integrate_batch_kernel`
// runs phase 2: its warps read their rows straight from device memory,
// since one step is read once and a ring of DOCS_PER_CTA blocks would only
// copy them first, so its shared memory is the same for every U and R.
//
// Semantics follow `_kernel` exactly, including its edge cases: gather of
// idx < 0 yields the fill, of idx >= C yields 0; put drops idx < 0 and
// idx >= C; a split on a full doc sets ERR_CAPACITY without splitting; the
// fused kernel never reads or writes the OS plane.
//
// Built with -DYTPU_INTEGRATE_PROFILE, each doc also counts clock64()
// cycles per phase (ProfWord) into a [D, PROF_WORDS] int64 buffer.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v -o libytpu_integrate.so integrate.cu

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

// client -> max clock table width (clients outside [0, KC) use a sweep)
#define YTPU_KC 1024

namespace {

constexpr int NC = 26;
enum Plane {
  CL, CK, LN, OC, OK, RC, RK, LT, RT, DL, CN, KD, RF, OF, KEY, PA, HD, MV,
  MSC, MSK, MSA, MEC, MEK, MEA, MPR, OS
};
constexpr int M_START = 0, M_NBLOCKS = 1, M_ERROR = 2, M_MDIRTY = 3;
constexpr int M_HIST0 = 4, M_PAD = 32;
constexpr int SC_BUCKETS = 8, SC_MAX = 8, SC_CHEAP = 9, SC_WIDE = 10,
              SC_CHEAP_TRIPS = 11, SC_WIDE_TRIPS = 12, SC_WIDTH_SUM = 13,
              SC_WORDS = 14;
constexpr int ERR_CAPACITY = 1, ERR_MISSING_DEP = 2;
constexpr int BLOCK_GC = 0, CONTENT_DELETED = 1, CONTENT_FORMAT = 6,
              CONTENT_MOVE = 11, BLOCK_ROOT_ANCHOR = 12;
constexpr int ROW_W = 23, DEL_W = 4;
constexpr int LEVELS = 5;
constexpr unsigned long long EMPTY = ~0ull;
constexpr unsigned FULL = 0xffffffffu;

// launch shape: DOCS_PER_CTA consumer warps and one producer warp; a ring
// of STAGES stream tiles in dynamic shared memory after the barriers and
// the client-clock tables
constexpr int DOCS_PER_CTA = 2;
constexpr int THREADS = (DOCS_PER_CTA + 1) * 32;
constexpr int STAGES = 2;
constexpr int BAR_BYTES = 128;
// lanes of a level probe (level g on lanes [g * LVL_G, (g + 1) * LVL_G))
// and of the start-map probe beside it
constexpr int LVL_G = 5;
constexpr int MAP_BASE = LEVELS * LVL_G, MAP_G = 32 - MAP_BASE;

// shared memory the ring may take, and the longest tile, in steps
constexpr int RING_BUDGET = 64 * 1024, MAX_TILE = 256;
// the dynamic shared memory a block may take on sm_90 (227 KB)
constexpr size_t SMEM_LIMIT = 232448;

// The launch for an [S, U, 23] / [S, R, 4] stream into D docs. The tile T
// is a multiple of 4 steps, so that every tile but the last starts 16-byte
// aligned, and as long as the ring fits RING_BUDGET; the last tile holds
// the rest, whose rows may end up to three words past a 16-byte boundary.
enum PlanWord {
  P_DOCS_PER_CTA, P_CTAS, P_THREADS, P_STAGES, P_TILE, P_TILES, P_LAST,
  P_RAGGED, P_SMEM, P_INDEX_CTAS, P_INDEX_THREADS, P_DOC_WORDS, PLAN_WORDS
};
// the per-doc entry's index kernel: one CTA of INDEX_THREADS a doc; it
// hands each doc's client clocks and slot bound (DOC_WORDS int32) to the
// integrate kernel
constexpr int INDEX_THREADS = 128;
constexpr int DOC_WORDS = YTPU_KC + 1;
void launch_plan(int S, int U, int R, int D, int* p) {
  const int step_b = 4 * (U * ROW_W + R * DEL_W);
  const int fit = step_b ? RING_BUDGET / (STAGES * step_b) : MAX_TILE;
  const int T = std::max(4, std::min({MAX_TILE, fit, (std::max(S, 1) + 3) / 4 * 4}) / 4 * 4);
  const int tiles = (S + T - 1) / T;
  const int last = tiles ? S - (tiles - 1) * T : 0;
  p[P_DOCS_PER_CTA] = DOCS_PER_CTA;
  p[P_CTAS] = (D + DOCS_PER_CTA - 1) / DOCS_PER_CTA;
  p[P_THREADS] = THREADS;
  p[P_STAGES] = STAGES;
  p[P_TILE] = T;
  p[P_TILES] = tiles;
  p[P_LAST] = last;
  p[P_RAGGED] = (last * U * ROW_W) % 4;
  p[P_SMEM] = BAR_BYTES + DOCS_PER_CTA * YTPU_KC * 4 + STAGES * T * step_b;
  p[P_INDEX_CTAS] = p[P_INDEX_THREADS] = p[P_DOC_WORDS] = 0;  // phase 1 in the kernel
}

// The per-doc launches: the index kernel, one CTA a doc; then the
// integrate kernel, one step, no ring (each warp reads its doc's rows from
// device memory), so its shared memory is the barriers and the
// client-clock tables whatever U and R are.
void batch_plan(int D, int* p) {
  p[P_DOCS_PER_CTA] = DOCS_PER_CTA;
  p[P_CTAS] = (D + DOCS_PER_CTA - 1) / DOCS_PER_CTA;
  p[P_THREADS] = THREADS;
  p[P_STAGES] = 0;
  p[P_TILE] = 1;
  p[P_TILES] = 1;
  p[P_LAST] = 1;
  p[P_RAGGED] = 0;
  p[P_SMEM] = BAR_BYTES + DOCS_PER_CTA * YTPU_KC * 4;
  p[P_INDEX_CTAS] = D;
  p[P_INDEX_THREADS] = INDEX_THREADS;
  p[P_DOC_WORDS] = DOC_WORDS;
}

// ---- phase 1's sizing ----------------------------------------------------------

// The slots a launch of S steps of U rows and R delete ranges can reach in
// a doc that holds nb0 slots, `moves` of them live move rows, at its start.
// Every path that adds a slot: `split` (called by clean_end, clean_start
// and delete_range) and integrate_row's own row. A row makes at most three
// (clean_end's split of its origin, clean_start's split of its right
// origin, the row), a delete range at most two (its splits at both ends).
// The move recompute splits through resolve_move_ptr, once per move
// pointer whose boundary does not exist yet: a split leaves the boundary
// in place for the rest of the launch (nothing merges blocks within one),
// so each of a move row's two pointers splits at most once, and the live
// move rows of a launch are those live at its start plus at most U new
// ones a step (DL never goes back to 0). So
//   nb <= nb0 + S * (3U + 2R) + 2 * (moves + S * U),
// and nb never passes C. Root anchors (BLOCK_ROOT_ANCHOR rows, client -1,
// length 0) are made on the host before a launch, so they are among nb0;
// no id names one, so none is split, and phase 1 indexes none (a slot of
// length 0 starts no block). A map row splits like any row (its origin is
// the previous tail of its key chain), so rows that all extend one chain
// make at most the same three slots each.
__host__ __device__ inline int live_bound(int nb0, int moves, int S, int U, int R, int C) {
  const long long n = (long long)nb0 + (long long)S * (5LL * U + 2LL * R) + 2LL * moves;
  return n < C ? (int)n : C;
}

__host__ __device__ inline uint32_t pow2_at_least(long long n) {
  uint32_t p = 1;
  while (p < n && p < (1u << 31)) p <<= 1;
  return p;
}

// The entries of a doc's bitmap and start map for n reachable slots: the
// load factors of the wrapper's `scratch_entries` (every start's five
// level words at most 5/8 full, every start at most 1/2), capped at what
// it allocated (HB, HS entries a doc).
struct Tables {
  uint32_t hb, hs;
};
__host__ __device__ inline Tables tables_for(int n, int HB, int HS) {
  const uint32_t hb = pow2_at_least(8LL * n), hs = pow2_at_least(2LL * n);
  return Tables{hb < (uint32_t)HB ? hb : (uint32_t)HB, hs < (uint32_t)HS ? hs : (uint32_t)HS};
}

// ---- per-phase cycle counters (built only with -DYTPU_INTEGRATE_PROFILE) ---
// Each doc accumulates clock64() cycles per phase, exclusively (a nested
// phase pauses the one around it), and a few event counts; lane 0 keeps
// them in shared memory and the launch writes them out at the end. Phase
// 1 runs on the whole CTA: its two words (sizing and clear, index build)
// are the CTA's cycles, given to each of its docs, and CNT_BOUND is the
// doc's live_bound.
enum ProfWord {
  PH_OTHER, PH_STREAM, PH_CLOCK, PH_FIND_HIT, PH_FIND_INDEX, PH_SPLIT, PH_SCAN,
  PH_LINK, PH_INDEX_ADD, PH_DELETE, PH_MOVES, PH_CLEAR, PH_INDEX_BUILD,
  CNT_STEPS, CNT_ROWS, CNT_DELS, CNT_HITS, CNT_LOOKUPS, CNT_BOUND, PROF_WORDS
};
#ifdef YTPU_INTEGRATE_PROFILE
struct Prof {
  long long* acc;
  bool lane0;
  int cur;
  long long t;
};
__device__ __forceinline__ int prof_switch(Prof& p, int ph) {
  const long long now = clock64();
  if (p.lane0) p.acc[p.cur] += now - p.t;
  p.t = now;
  const int old = p.cur;
  p.cur = ph;
  return old;
}
struct ProfScope {
  Prof& p;
  int prev;
  __device__ ProfScope(Prof& q, int ph) : p(q), prev(prof_switch(q, ph)) {}
  __device__ ~ProfScope() { prof_switch(p, prev); }
};
#define PROF_CAT2(a, b) a##b
#define PROF_CAT(a, b) PROF_CAT2(a, b)
#define PROF_SCOPE(d, ph) ProfScope PROF_CAT(prof_scope_, __LINE__)((d).prof, ph)
#define PROF_COUNT(d, w)                      \
  do {                                        \
    if ((d).prof.lane0) (d).prof.acc[w] += 1; \
  } while (0)
#else
#define PROF_SCOPE(d, ph)
#define PROF_COUNT(d, w)
#endif

// ---- the doc a consumer warp integrates (every field warp-uniform, except
// ---- the lane's own cursor-cache entry) ------------------------------------

struct Doc {
  int* cols;  // plane p, slot i at cols[p * dc + i]
  size_t dc;  // D * C
  int C;
  int lane;
  int nb, start, err, mdirty;
  int sc[SC_WORDS];
  ulonglong2* bidx;  // {key, 64-bit word}
  uint32_t bmask;
  ulonglong2* sidx;  // {key, slot}
  uint32_t smask;
  int* cclock;  // shared memory
  int* bstamp;
  int* cstamp;
  int row_epoch, conf_epoch;
  const int* rank;
  int K;
  int cheap, unroll;
  // this lane's cursor-cache entry (len 0: empty) and the next victim lane
  int cc_client, cc_start, cc_len, cc_slot;
  int cc_next;
  int index_writes;  // stores to the index so far (see Ahead)
#ifdef YTPU_INTEGRATE_PROFILE
  Prof prof;
#endif
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

// ---- column access with the Pallas kernel's gather/put semantics ---------

__device__ __forceinline__ int* plane(const Doc& d, int p) {
  return d.cols + (size_t)p * d.dc;
}

__device__ __forceinline__ int ld(const Doc& d, int p, int idx) {
  return plane(d, p)[idx];
}

__device__ __forceinline__ void st(const Doc& d, int p, int idx, int v) {
  plane(d, p)[idx] = v;
}

__device__ __forceinline__ int gat(const Doc& d, int p, int idx, int fill) {
  int v = 0;  // no one-hot hit at idx >= C
  if (idx >= 0 && idx < d.C) v = ld(d, p, idx);
  return idx < 0 ? fill : v;
}

__device__ __forceinline__ void put(const Doc& d, int p, int idx, int v) {
  if (idx >= 0 && idx < d.C) st(d, p, idx, v);
}

// before a group of stores: every lane's earlier loads and stores are done
__device__ __forceinline__ void warp_stores() { __syncwarp(); }

__device__ __forceinline__ int gather_rank(const Doc& d, int client) {
  const int c = client > 0 ? client : 0;
  return c < d.K ? d.rank[c] : 0;
}

// first slot in [from, to) where pred holds, -1 if none: 32 slots a step
template <class F>
__device__ __forceinline__ int first_slot(const Doc& d, int from, int to, F pred) {
  for (int base = from; base < to; base += 32) {
    const int s = base + d.lane;
    const unsigned b = __ballot_sync(FULL, s < to && pred(s));
    if (b) return base + __ffs(b) - 1;
  }
  return -1;
}

// ---- index: hashed tables of 16-byte entries ---------------------------------

struct Probe {
  bool found;
  uint32_t pos;  // slot of the key, or of the first EMPTY where it would go
  unsigned long long val;
};

// Lanes [base, base + g) look up one key: each round every lane of the
// group loads one entry of a window of g consecutive slots of the key's
// linear-probe chain, and the first slot holding the key or EMPTY ends the
// chain. Every lane of the group returns the group's result. Several
// groups (on several tables) probe side by side; lanes with act false only
// take part in the warp collectives.
// With has_first, `first` is this lane's entry of the first round, loaded
// ahead.
__device__ __forceinline__ Probe probe(const ulonglong2* tab, uint32_t mask,
                                       unsigned long long key, bool act,
                                       int lane, int base, int g,
                                       bool has_first = false,
                                       ulonglong2 first = ulonglong2{}) {
  const unsigned gmask = (g >= 32 ? FULL : ((1u << g) - 1u)) << base;
  uint32_t i = (hmix(key) + (uint32_t)(lane - base)) & mask;
  Probe out{false, 0u, 0ull};
  bool done = !act;
  bool loaded = has_first;
  while (true) {
    ulonglong2 e = make_ulonglong2(EMPTY, 0ull);
    if (!done) e = loaded ? first : tab[i];
    loaded = false;
    const unsigned hit = __ballot_sync(FULL, !done && e.x == key) & gmask;
    const unsigned stop =
        hit | (__ballot_sync(FULL, !done && e.x == EMPTY) & gmask);
    const int first = stop ? __ffs(stop) - 1 : lane;
    const unsigned long long v = __shfl_sync(FULL, e.y, first);
    const uint32_t at = __shfl_sync(FULL, i, first);
    if (!done && stop) {
      done = true;
      out.found = (hit >> first) & 1u;
      out.pos = at;
      out.val = out.found ? v : 0ull;
    }
    if (!__any_sync(FULL, !done)) break;
    i = (i + (uint32_t)g) & mask;
  }
  return out;
}

// the bitmap word (c, lvl, b), 0 if absent: one key over the whole warp
__device__ __forceinline__ unsigned long long word_get(const Doc& d, int c, int lvl,
                                                       uint32_t b) {
  return probe(d.bidx, d.bmask, bkey(c, lvl, b), true, d.lane, 0, 32).val;
}

// the five level words of client c around clock x in one round: lane l
// (l < LEVELS) returns level l's word
__device__ __forceinline__ unsigned long long level_words(const Doc& d, int c,
                                                          int x) {
  const int g = d.lane / LVL_G;
  const bool act = g < LEVELS;
  const int lvl = act ? g : 0;
  const Probe p =
      probe(d.bidx, d.bmask, bkey(c, lvl, (uint32_t)x >> (6 * (lvl + 1))), act,
            d.lane, lvl * LVL_G, LVL_G);
  return __shfl_sync(FULL, p.val, min(d.lane, LEVELS - 1) * LVL_G);
}

// largest block start <= x for client c, -1 if none (x >= 0)
__device__ __forceinline__ int pred_start(const Doc& d, int c, int x) {
  const unsigned long long w = level_words(d, c, x);
  const int l = min(d.lane, LEVELS - 1);
  const int bit = ((uint32_t)x >> (6 * l)) & 63;
  const unsigned long long m =
      l == 0 ? (w & ((2ull << bit) - 1)) : (w & ((1ull << bit) - 1));
  const unsigned any = __ballot_sync(FULL, d.lane < LEVELS && m != 0);
  if (!any) return -1;
  const int lvl = __ffs(any) - 1;
  const unsigned long long ml = __shfl_sync(FULL, m, lvl);
  uint32_t cur = (((uint32_t)x >> (6 * (lvl + 1))) << 6) |
                 (uint32_t)(63 - __clzll((long long)ml));
  for (int k = lvl - 1; k >= 0; --k) {
    const unsigned long long w2 = word_get(d, c, k, cur);
    if (w2 == 0) return -1;
    cur = (cur << 6) | (uint32_t)(63 - __clzll((long long)w2));
  }
  return (int)cur;
}

// smallest block start >= x for client c, -1 if none (x >= 0)
__device__ __forceinline__ int succ_start(const Doc& d, int c, int x) {
  const unsigned long long w = level_words(d, c, x);
  const int l = min(d.lane, LEVELS - 1);
  const int bit = ((uint32_t)x >> (6 * l)) & 63;
  const unsigned long long m =
      l == 0 ? (w & ~((1ull << bit) - 1)) : (w & ~((2ull << bit) - 1));
  const unsigned any = __ballot_sync(FULL, d.lane < LEVELS && m != 0);
  if (!any) return -1;
  const int lvl = __ffs(any) - 1;
  const unsigned long long ml = __shfl_sync(FULL, m, lvl);
  uint32_t cur = (((uint32_t)x >> (6 * (lvl + 1))) << 6) |
                 (uint32_t)(__ffsll((long long)ml) - 1);
  for (int k = lvl - 1; k >= 0; --k) {
    const unsigned long long w2 = word_get(d, c, k, cur);
    if (w2 == 0) return -1;
    cur = (cur << 6) | (uint32_t)(__ffsll((long long)w2) - 1);
  }
  return (int)cur;
}

__device__ __forceinline__ int start_find(const Doc& d, int c, int k) {
  const Probe p = probe(d.sidx, d.smask, skey(c, k), true, d.lane, 0, 32);
  return p.found ? (int)(uint32_t)p.val : -1;
}

// the cursor cache: a new entry goes to the lane after the last one filled
__device__ __forceinline__ void cache_put(Doc& d, int c, int k, int l, int slot) {
  if (l <= 0 || k < 0) return;  // what the index does not hold either
  if (d.lane == d.cc_next) {
    d.cc_client = c;
    d.cc_start = k;
    d.cc_len = l;
    d.cc_slot = slot;
  }
  d.cc_next = (d.cc_next + 1) & 31;
}

// The lanes of an index insert of start k of client c: levels 0..4 of the
// bitmap on lanes [5 lvl, 5 lvl + 5), the start map on lanes 25..31.
struct InsertLane {
  const ulonglong2* tab;
  uint32_t mask;
  unsigned long long key;
  int base, g;
};

__device__ __forceinline__ InsertLane insert_lane(const Doc& d, int c, int k) {
  const int g = d.lane / LVL_G;
  if (g < LEVELS)
    return InsertLane{d.bidx, d.bmask, bkey(c, g, (uint32_t)k >> (6 * (g + 1))),
                      g * LVL_G, LVL_G};
  return InsertLane{d.sidx, d.smask, skey(c, k), MAP_BASE, MAP_G};
}

// The first probe round of an index insert, loaded as soon as the block
// is known, so that its latency overlaps the loads in between; it stands
// only while no index store has happened since.
struct Ahead {
  ulonglong2 e;
  int writes;
};

__device__ __forceinline__ Ahead index_ahead(const Doc& d, int c, int k) {
  const InsertLane t = insert_lane(d, c, k);
  return Ahead{t.tab[(hmix(t.key) + (uint32_t)(d.lane - t.base)) & t.mask],
               d.index_writes};
}

// a new block [k, k + l) of client c at `slot`: the start map and the
// five bitmap levels probed in one round (with has_ahead, `ahead` may hold
// it), then stored
__device__ __forceinline__ void index_add(Doc& d, int c, int k, int l, int slot,
                                          bool has_ahead = false,
                                          Ahead ahead = Ahead{}) {
  PROF_SCOPE(d, PH_INDEX_ADD);
  if (l > 0 && k >= 0) {
    const InsertLane t = insert_lane(d, c, k);
    const Probe p = probe(t.tab, t.mask, t.key, true, d.lane, t.base, t.g,
                          has_ahead && ahead.writes == d.index_writes, ahead.e);
    d.index_writes += 1;
    const bool s_found = __shfl_sync(FULL, p.found, MAP_BASE);
    const uint32_t s_pos = __shfl_sync(FULL, p.pos, MAP_BASE);
    const int s_val = (int)(uint32_t)__shfl_sync(FULL, p.val, MAP_BASE);
    warp_stores();
    if (!s_found)
      d.sidx[s_pos] = make_ulonglong2(skey(c, k), (unsigned long long)(uint32_t)slot);
    else if (slot < s_val)
      reinterpret_cast<int*>(&d.sidx[s_pos])[2] = slot;
    uint32_t ins[LEVELS];
#pragma unroll
    for (int lv = 0; lv < LEVELS; ++lv) {
      ins[lv] = 0xffffffffu;
      bool f = __shfl_sync(FULL, p.found, lv * LVL_G);
      uint32_t pos = __shfl_sync(FULL, p.pos, lv * LVL_G);
      unsigned long long w = __shfl_sync(FULL, p.val, lv * LVL_G);
      const unsigned long long key = bkey(c, lv, (uint32_t)k >> (6 * (lv + 1)));
      // a level below may just have taken the EMPTY this level's probe saw
      bool clash = false;
#pragma unroll
      for (int q = 0; q < lv; ++q) clash = clash || (!f && ins[q] == pos);
      if (clash) {
        const Probe r = probe(d.bidx, d.bmask, key, true, d.lane, 0, 32);
        f = r.found;
        pos = r.pos;
        w = r.val;
        warp_stores();
      }
      const unsigned long long bit = 1ull << (((uint32_t)k >> (6 * lv)) & 63);
      if (f) {
        if (w & bit) break;  // the levels above were set by that insert
        d.bidx[pos].y = w | bit;
      } else {
        d.bidx[pos] = make_ulonglong2(key, bit);
        ins[lv] = pos;
      }
    }
  }
  if (c >= 0 && c < YTPU_KC) {
    const int e = k + l;
    warp_stores();
    if (e > d.cclock[c]) d.cclock[c] = e;
  }
}

__device__ __forceinline__ int client_clock(Doc& d, int c) {
  PROF_SCOPE(d, PH_CLOCK);
  if (c >= 0 && c < YTPU_KC) return d.cclock[c];
  int best = 0;
  for (int base = 0; base < d.nb; base += 32) {
    const int s = base + d.lane;
    if (s < d.nb && ld(d, CL, s) == c) {
      const int e = ld(d, CK, s) + ld(d, LN, s);
      if (e > best) best = e;
    }
  }
  return __reduce_max_sync(FULL, best);
}

// the block covering (c, x): its slot (the smallest such, -1 if none) and
// its clock and length (0 and 0 if none)
struct Hit {
  int slot;
  bool found;
  int ck, ln;
};

__device__ __forceinline__ Hit find_slot(Doc& d, int c, int x, bool enable) {
  Hit h{-1, false, 0, 0};
  if (!enable) return h;
  if (x < 0) {  // not indexed (block clocks are >= 0): exact sweep
    PROF_SCOPE(d, PH_FIND_INDEX);
    const int s = first_slot(d, 0, d.nb, [&](int t) {
      if (ld(d, CL, t) != c) return false;
      const int ck = ld(d, CK, t);
      return ck <= x && x < ck + ld(d, LN, t);
    });
    if (s >= 0) h = Hit{s, true, ld(d, CK, s), ld(d, LN, s)};
    return h;
  }
  {
    PROF_SCOPE(d, PH_FIND_HIT);
    const unsigned hit = __ballot_sync(
        FULL, d.cc_len > 0 && d.cc_client == c && d.cc_start <= x &&
                  x < d.cc_start + d.cc_len);
    if (hit) {
      PROF_COUNT(d, CNT_HITS);
      const int src = __ffs(hit) - 1;
      h.slot = __shfl_sync(FULL, d.cc_slot, src);
      h.ck = __shfl_sync(FULL, d.cc_start, src);
      h.ln = __shfl_sync(FULL, d.cc_len, src);
      h.found = true;
      return h;
    }
  }
  PROF_SCOPE(d, PH_FIND_INDEX);
  PROF_COUNT(d, CNT_LOOKUPS);
  const int stt = pred_start(d, c, x);
  if (stt < 0) return h;
  const int s = start_find(d, c, stt);
  if (s < 0 || s >= d.nb) return h;
  const int cl = ld(d, CL, s), ck = ld(d, CK, s), ln = ld(d, LN, s);
  if (cl == c && ck <= x && x < ck + ln) {
    h = Hit{s, true, ck, ln};
    cache_put(d, c, ck, ln, s);
  }
  return h;
}

// split the block h of client cl at offset off; returns the right half's
// slot, or h's slot when nothing was split
__device__ __forceinline__ int split(Doc& d, const Hit& h, int cl, int off, bool want) {
  PROF_SCOPE(d, PH_SPLIT);
  const int i = h.slot, ck = h.ck, length_i = h.ln;
  bool doit = want && i >= 0 && off > 0 && off < length_i;
  const int j = d.nb;
  if (doit && j >= d.C) {
    d.err |= ERR_CAPACITY;
    doit = false;
  }
  if (!doit) return i;
  const Ahead ahead = index_ahead(d, cl, ck + off);
  const int right_i = ld(d, RT, i);
  const int rc = ld(d, RC, i), rk = ld(d, RK, i);
  const int dl = ld(d, DL, i), cn = ld(d, CN, i), kd = ld(d, KD, i);
  const int rf = ld(d, RF, i), of = ld(d, OF, i), key = ld(d, KEY, i);
  const int pa = ld(d, PA, i), hd = ld(d, HD, i), mv = ld(d, MV, i);
  warp_stores();
  st(d, CL, j, cl);
  st(d, CK, j, ck + off);
  st(d, LN, j, length_i - off);
  st(d, OC, j, cl);
  st(d, OK, j, ck + off - 1);
  st(d, RC, j, rc);
  st(d, RK, j, rk);
  st(d, LT, j, i);
  st(d, RT, j, right_i);
  st(d, DL, j, dl);
  st(d, CN, j, cn);
  st(d, KD, j, kd);
  st(d, RF, j, rf);
  st(d, OF, j, of + off);
  st(d, KEY, j, key);
  st(d, PA, j, pa);
  st(d, HD, j, hd);
  st(d, MV, j, mv);
  st(d, MSC, j, -1);
  st(d, MSK, j, 0);
  st(d, MSA, j, 0);
  st(d, MEC, j, -1);
  st(d, MEK, j, 0);
  st(d, MEA, j, 0);
  st(d, MPR, j, -1);
  st(d, LN, i, off);
  st(d, RT, i, j);
  put(d, LT, right_i, j);
  d.nb += 1;
  if (d.cc_len > 0 && d.cc_slot == i) d.cc_len = off;
  cache_put(d, cl, ck + off, length_i - off, j);
  index_add(d, cl, ck + off, length_i - off, j, true, ahead);
  return j;
}

__device__ __forceinline__ Hit clean_end(Doc& d, int c, int x, bool enable) {
  const Hit h = find_slot(d, c, x, enable);
  split(d, h, c, x - h.ck + 1, enable && h.found);
  return h;
}

__device__ __forceinline__ Hit clean_start(Doc& d, int c, int x, bool enable) {
  Hit h = find_slot(d, c, x, enable);
  const int off = x - h.ck;
  const int j = split(d, h, c, off, enable && h.found);
  h.slot = (h.slot >= 0 && off > 0) ? j : h.slot;
  return h;
}

__device__ __forceinline__ bool origins_equal(bool ha, int ca, int ka, bool hb,
                                              int cb, int kb) {
  return (!ha && !hb) || (ha && hb && ca == cb && ka == kb);
}

__device__ __forceinline__ int scan_bucket(int w) {
  return (w >= 2) + (w >= 4) + (w >= 8) + (w >= 16) + (w >= 32) + (w >= 64) +
         (w >= 128);
}

__device__ __forceinline__ void integrate_row(Doc& d, const int* r) {
  PROF_SCOPE(d, PH_LINK);
  PROF_COUNT(d, CNT_ROWS);
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
  Ahead ahead{};
  if (doit) ahead = index_ahead(d, r_client, clock);

  int left_idx = clean_end(d, origin_client, origin_clock, linkable && has_origin).slot;
  int right_idx = clean_start(d, r_rc, r_rk, linkable && has_ror).slot;
  left_idx = (linkable && has_origin) ? left_idx : -1;
  right_idx = (linkable && has_ror) ? right_idx : -1;
  const bool anchor_missing = (linkable && has_origin && left_idx < 0) ||
                              (linkable && has_ror && right_idx < 0);
  missing = missing || anchor_missing;
  linkable = linkable && !anchor_missing;

  // what this row reads of its anchors, issued together (nothing below
  // writes these planes before their last read here)
  const int left0 = left_idx;
  const int l_pa = gat(d, PA, left_idx, -1), l_key = gat(d, KEY, left_idx, -1);
  const int l_rt = gat(d, RT, left_idx, -1), l_mv = gat(d, MV, left_idx, -1);
  const int r_pa = gat(d, PA, right_idx, -1), r_key2 = gat(d, KEY, right_idx, -1);
  const int r_lt = gat(d, LT, right_idx, -1), r_mv = gat(d, MV, right_idx, -1);

  // parent branch: p_tag 2 = nested branch by id; 1 = root; 0 = inherit
  const int parent_slot =
      find_slot(d, r_pclient, r_pclock, linkable && r_ptag == 2).slot;
  const int inherited_parent = left_idx >= 0 ? l_pa : r_pa;
  int anchor_idx = -1;
  if (r_ptag == 1 && r_proot >= 0)
    anchor_idx = first_slot(d, 0, d.nb, [&](int s) {
      return ld(d, KD, s) == BLOCK_ROOT_ANCHOR && ld(d, KEY, s) == r_proot;
    });
  const bool anchor_found = anchor_idx >= 0;
  const int root_row = (r_proot >= 0 && anchor_found) ? anchor_idx : -1;
  const int parent_row =
      r_ptag == 2 ? parent_slot : (r_ptag == 1 ? root_row : inherited_parent);
  const bool parent_missing =
      linkable && ((r_ptag == 2 && parent_slot < 0) ||
                   (r_ptag == 1 && r_proot >= 0 && !anchor_found));
  missing = missing || parent_missing;
  linkable = linkable && !parent_missing;
  const int p_hd = gat(d, HD, parent_row, -1), p_dl = gat(d, DL, parent_row, 0);

  // parent_sub inherited from the anchors when omitted on the wire
  const int key_v = r_key >= 0 ? r_key : (l_key >= 0 ? l_key : r_key2);
  const bool is_map = key_v >= 0;

  // map rows anchor on their (parent, key) chain's leftmost item
  int chain_head = -1;
  if (is_map)
    chain_head = first_slot(d, 0, d.nb, [&](int s) {
      return ld(d, KEY, s) == key_v && ld(d, PA, s) == parent_row &&
             ld(d, LT, s) == -1;
    });
  const int seq_head = parent_row >= 0 ? p_hd : d.start;
  const int anchor0_base = is_map ? chain_head : seq_head;

  const bool need_scan =
      linkable && ((left_idx < 0 && (right_idx < 0 || r_lt >= 0)) ||
                   (left_idx >= 0 && l_rt != right_idx));

  if (need_scan) {
    PROF_SCOPE(d, PH_SCAN);
    int o = left_idx >= 0 ? l_rt : anchor0_base;
    int left = left_idx;
    int width = 0;
    const int rank_r = gather_rank(d, r_client);
    d.row_epoch += 1;
    d.conf_epoch += 1;
    while (o >= 0 && o != right_idx) {
      width += 1;
      const int o_oc = gat(d, OC, o, -1), o_ok = gat(d, OK, o, 0);
      const int o_rc = gat(d, RC, o, -1), o_rk = gat(d, RK, o, 0);
      const int o_cl = gat(d, CL, o, -1), o_rt = gat(d, RT, o, -1);
      warp_stores();
      if (o < d.C) {  // a one-hot over C lanes has no hit at o >= C
        d.bstamp[o] = d.row_epoch;
        d.cstamp[o] = d.conf_epoch;
      }
      const bool same_origin = origins_equal(has_origin, origin_client,
                                             origin_clock, o_oc >= 0, o_oc, o_ok);
      const bool same_ror =
          origins_equal(has_ror, r_rc, r_rk, o_rc >= 0, o_rc, o_rk);
      const int rank_o = gather_rank(d, o_cl);
      const bool case1_take = same_origin && rank_o < rank_r;
      const bool case1_break = same_origin && !case1_take && same_ror;
      const Hit oo = find_slot(d, o_oc, o_ok, o_oc >= 0);
      const bool in_before = oo.found && d.bstamp[oo.slot] == d.row_epoch;
      const bool in_conf = oo.found && d.cstamp[oo.slot] == d.conf_epoch;
      const bool case2_take = !same_origin && in_before && !in_conf;
      const bool case2_break = !same_origin && !in_before;
      if (case1_take || case2_take) {
        left = o;
        d.conf_epoch += 1;  // conflicting := {}
      }
      if (case1_break || case2_break) break;
      o = o_rt;
    }
    left_idx = left;
    // scan record: the two-tier trip accounting in closed form
    const int wb = width;
    const int b = scan_bucket(wb);
#pragma unroll
    for (int k = 0; k < SC_BUCKETS; ++k) d.sc[k] += b == k ? 1 : 0;
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
  const int left_rt = left_idx == left0 ? l_rt : gat(d, RT, left_idx, -1);
  const int right_final = has_left ? left_rt : (linkable ? anchor0_base : -1);
  const int left_moved =
      has_left ? (left_idx == left0 ? l_mv : gat(d, MV, left_idx, -1)) : -1;
  const int right_moved =
      right_final >= 0
          ? (right_final == right_idx ? r_mv : gat(d, MV, right_final, -1))
          : -1;
  warp_stores();
  if (has_left) put(d, RT, left_idx, j);
  // sequence rows with no left become the head of the root or the parent
  const bool new_head = linkable && !has_left && !is_map;
  if (new_head && parent_row < 0) d.start = j;
  if (new_head && parent_row >= 0) put(d, HD, parent_row, j);
  if (linkable && right_final >= 0) put(d, LT, right_final, j);

  // self-delete on arrival: under a tombstoned parent, or a map row
  // landing with a right neighbor
  const bool parent_deleted = parent_row >= 0 && p_dl == 1;
  const bool dead_on_arrival =
      linkable && (parent_deleted || (is_map && right_final >= 0));
  const bool row_deleted = is_gc || r_kind == CONTENT_DELETED || dead_on_arrival;
  const bool row_countable =
      !row_deleted && r_kind != CONTENT_FORMAT && r_kind != CONTENT_MOVE;

  const int inherit_moved = left_moved == right_moved ? left_moved : -1;
  const bool moved_conflict = linkable && left_moved != right_moved;
  if (moved_conflict || (doit && is_move_row)) d.mdirty = 1;

  if (doit) {
    st(d, CL, j, r_client);
    st(d, CK, j, clock);
    st(d, LN, j, length);
    st(d, OC, j, has_origin ? origin_client : -1);
    st(d, OK, j, has_origin ? origin_clock : 0);
    st(d, RC, j, has_ror ? r_rc : -1);
    st(d, RK, j, has_ror ? r_rk : 0);
    st(d, LT, j, linkable ? left_idx : -1);
    st(d, RT, j, linkable ? right_final : -1);
    st(d, DL, j, row_deleted ? 1 : 0);
    st(d, CN, j, row_countable ? 1 : 0);
    st(d, KD, j, r_kind);
    st(d, RF, j, r_ref);
    st(d, OF, j, c_off);
    st(d, KEY, j, key_v);
    st(d, PA, j, parent_row);
    st(d, HD, j, -1);
    st(d, MV, j, linkable ? inherit_moved : -1);
    st(d, MSC, j, is_move_row ? r_mv_sc : -1);
    st(d, MSK, j, is_move_row ? r_mv_sk : 0);
    st(d, MSA, j, is_move_row ? r_mv_sa : 0);
    st(d, MEC, j, is_move_row ? r_mv_ec : -1);
    st(d, MEK, j, is_move_row ? r_mv_ek : 0);
    st(d, MEA, j, is_move_row ? r_mv_ea : 0);
    st(d, MPR, j, is_move_row ? r_mv_prio : -1);
  }
  // a map row that became its chain's tail is the key's live value; the
  // previous winner (its immediate left) gets tombstoned
  const bool new_tail = linkable && is_map && right_final < 0;
  if (new_tail && has_left) put(d, DL, left_idx, 1);
  if (doit) {
    d.nb += 1;
    cache_put(d, r_client, clock, length, j);
    index_add(d, r_client, clock, length, j, true, ahead);
  }
  if (overflow) d.err |= ERR_CAPACITY;
  if (missing) d.err |= ERR_MISSING_DEP;
}

__device__ __forceinline__ void delete_range(Doc& d, const int* r) {
  PROF_SCOPE(d, PH_DELETE);
  PROF_COUNT(d, CNT_DELS);
  const int client = r[0], start = r[1], end = r[2];
  const Hit hi = find_slot(d, client, start, true);
  split(d, hi, client, start - hi.ck, hi.found && gat(d, DL, hi.slot, 1) == 0);
  const Hit hk = find_slot(d, client, end - 1, true);
  split(d, hk, client, end - hk.ck, hk.found && gat(d, DL, hk.slot, 1) == 0);
  // mark every block of `client` with [CK, CK + LN) inside [start, end);
  // tombstoning a live move row dirties the doc
  if (start < 0) {
    __syncwarp();
    bool hit_move = false;
    for (int base = 0; base < d.nb; base += 32) {
      const int s = base + d.lane;
      if (s < d.nb && ld(d, CL, s) == client && ld(d, CK, s) >= start &&
          ld(d, CK, s) + ld(d, LN, s) <= end) {
        hit_move = hit_move || (ld(d, KD, s) == CONTENT_MOVE && ld(d, DL, s) == 0);
        st(d, DL, s, 1);
      }
    }
    if (__any_sync(FULL, hit_move)) d.mdirty = 1;
    __syncwarp();
    return;
  }
  // x >= 0: walk the client's blocks from `start` in clock order, block to
  // block through find_slot (the cursor cache first), jumping gaps with a
  // successor query. Covering blocks are unique, so this visits exactly
  // the blocks whose start lies in [start, end).
  int x = start;
  while (x < end) {
    const Hit h = find_slot(d, client, x, true);
    if (!h.found) {
      x = succ_start(d, client, x);
      if (x < 0) break;
      continue;
    }
    if (h.ck >= start && h.ck + h.ln <= end) {
      const int kd = ld(d, KD, h.slot), dl = ld(d, DL, h.slot);
      warp_stores();
      if (kd == CONTENT_MOVE && dl == 0) d.mdirty = 1;
      st(d, DL, h.slot, 1);
    }
    x = h.ck + h.ln;
  }
}

// ---- move ownership (end-of-step recompute for dirty docs) ---------------

__device__ __forceinline__ int resolve_move_ptr(Doc& d, int c, int k, int assoc,
                                                bool enable, bool* found) {
  const bool after = assoc >= 0;
  const Hit a = clean_start(d, c, k, enable && after && c >= 0);
  const Hit b = clean_end(d, c, k, enable && !after && c >= 0);
  const int right_b = gat(d, RT, b.slot, -1);
  *found = after ? a.found : b.found;
  return after ? a.slot : right_b;
}

__device__ __forceinline__ bool claim_move(Doc& d, int s, bool enable) {
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
    warp_stores();
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
__device__ __forceinline__ bool move_cycle(const Doc& d, int s, bool enable) {
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

// every MV slot to -1, 32 slots a step
__device__ __forceinline__ void clear_moved(const Doc& d) {
  __syncwarp();
  for (int s = d.lane; s < d.C; s += 32) st(d, MV, s, -1);
  __syncwarp();
}

__device__ __forceinline__ void recompute_moves(Doc& d) {
  PROF_SCOPE(d, PH_MOVES);
  if (d.mdirty) {
    clear_moved(d);
    int from = 0;
    while (true) {
      const int s = first_slot(d, from, d.nb, [&](int t) {
        return ld(d, KD, t) == CONTENT_MOVE && ld(d, DL, t) == 0;
      });
      if (s < 0) break;
      const bool enable = claim_move(d, s, true);
      if (move_cycle(d, s, enable)) {
        // cycle: release every claim and replay without s
        warp_stores();
        st(d, DL, s, 1);
        clear_moved(d);
        from = 0;
      } else {
        from = s + 1;
      }
    }
  }
  d.mdirty = 0;
}

// ---- mbarriers and the TMA bulk copy -----------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// wait for the completion of the barrier's phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// the producer's copy of tile t of the stream into its ring stage: the
// rows and the deletes of up to T steps. Bulk copies move multiples of 16
// bytes; the up to three words of a ragged rows tail are copied by hand
// before the arrival that releases them.
__device__ __forceinline__ void issue_tile(int t, unsigned char* ring, uint64_t* full,
                                           const int* rows, const int* dels,
                                           int S, int U, int R, int T) {
  const int stg = t % STAGES;
  unsigned char* base = ring + (size_t)stg * T * (U * ROW_W + R * DEL_W) * 4;
  const int s0 = t * T;
  const int n = min(T, S - s0);
  const uint32_t rb = (uint32_t)n * U * ROW_W * 4, rb16 = rb & ~15u;
  const uint32_t db = (uint32_t)n * R * DEL_W * 4;
  const int* src_rows = rows + (size_t)s0 * U * ROW_W;
  for (uint32_t w = rb16 / 4; w < rb / 4; ++w)
    reinterpret_cast<int*>(base)[w] = src_rows[w];
  mbar_arrive_expect_tx(&full[stg], rb16 + db);
  if (rb16) bulk_copy(base, src_rows, rb16, &full[stg]);
  if (db)
    bulk_copy(base + (size_t)T * U * ROW_W * 4, dels + (size_t)s0 * R * DEL_W, db,
              &full[stg]);
}

// ---- phase 1: the index of the live slots (atomics) --------------------------

// Each probe loads the entry (from L2, where the atomics are) before it
// takes an atomic: an entry that holds another key needs none, and a
// bitmap word that already holds the bit needs none either. A load can
// only be behind the atomics (a key, once in, stays; bits are only set),
// and a stale entry merely falls through to the atomic. So the words of
// the upper levels, which every start of a client shares, take one atomic
// per bit instead of one per start.
__device__ __forceinline__ uint32_t claim(ulonglong2* tab, uint32_t mask,
                                          unsigned long long key, ulonglong2* seen) {
  uint32_t i = hmix(key) & mask;
  while (true) {
    *seen = __ldcg(&tab[i]);
    if (seen->x == key) return i;
    if (seen->x == EMPTY) {
      const unsigned long long prev = atomicCAS(&tab[i].x, EMPTY, key);
      if (prev == EMPTY || prev == key) {
        seen->y = 0;
        return i;
      }
    }
    i = (i + 1) & mask;
  }
}

__device__ __forceinline__ void start_put_atomic(ulonglong2* tab, uint32_t mask,
                                                 int c, int k, int slot) {
  ulonglong2 seen;
  const uint32_t i = claim(tab, mask, skey(c, k), &seen);
  atomicMin(reinterpret_cast<int*>(&tab[i]) + 2, slot);
}

// Every start of a level-0 word shares the words above it, so the first
// insert into a level-0 word (the one that finds it 0) sets the levels
// above, and any later one stops there. The starts of a warp are indexed
// together: the lanes whose starts share a level-0 word OR their bits in
// with one atomic (slots in insertion order put most of a warp's starts in
// one or two words), and only a lane that found the word 0 goes up.
__device__ __forceinline__ void bit_set_warp(ulonglong2* tab, uint32_t mask, int c, int k,
                                             bool start) {
  const unsigned long long key0 = start ? bkey(c, 0, (uint32_t)k >> 6) : EMPTY;
  const unsigned peers = __match_any_sync(FULL, key0);
  const unsigned long long bit = start ? 1ull << ((uint32_t)k & 63) : 0ull;
  const unsigned long long bits =
      ((unsigned long long)__reduce_or_sync(peers, (unsigned)(bit >> 32)) << 32) |
      __reduce_or_sync(peers, (unsigned)bit);
  if (!start || (int)(threadIdx.x & 31) != __ffs(peers) - 1) return;
  for (int lvl = 0; lvl < LEVELS; ++lvl) {
    const unsigned long long b =
        lvl == 0 ? bits : 1ull << (((uint32_t)k >> (6 * lvl)) & 63);
    ulonglong2 seen;
    const uint32_t i = claim(tab, mask, bkey(c, lvl, (uint32_t)k >> (6 * (lvl + 1))), &seen);
    if ((seen.y & b) == b && lvl > 0) return;  // set by the insert that set that bit
    if (atomicOr(&tab[i].y, b) != 0) return;
  }
}

// Phase 1's three passes over one doc, by `nthreads` threads of which
// this is `tid` (whole warps): count its live move rows into *moves; clear
// the prefixes `t` of its tables and n_stamps slots of its stamps; index
// its first nb0 slots into tables `t` and its client clocks into cclock.
__device__ __forceinline__ void count_moves(const int* p, size_t dc, int nb0, int tid,
                                            int nthreads, int* moves) {
  unsigned k = 0;
  for (int s = tid; s < nb0; s += nthreads)
    k += p[KD * dc + s] == CONTENT_MOVE && p[DL * dc + s] == 0;
  k = __reduce_add_sync(FULL, k);
  if ((tid & 31) == 0 && k) atomicAdd(moves, (int)k);
}

__device__ __forceinline__ void clear_scratch(ulonglong2* b, ulonglong2* sm, int* bs, int* cs,
                                              Tables t, int n_stamps, int tid, int nthreads) {
  for (uint32_t i = tid; i < t.hb; i += nthreads) b[i] = make_ulonglong2(EMPTY, 0ull);
  for (uint32_t i = tid; i < t.hs; i += nthreads) sm[i] = make_ulonglong2(EMPTY, 0x7FFFFFFFull);
  for (int i = tid; i < n_stamps; i += nthreads) {
    bs[i] = 0;
    cs[i] = 0;
  }
}

__device__ __forceinline__ void index_slots(const int* p, size_t dc, int nb0, ulonglong2* b,
                                            ulonglong2* sm, Tables t, int* cclock, int tid,
                                            int nthreads) {
  // whole warps go round together (bit_set_warp is a warp collective)
  for (int base = tid & ~31; base < nb0; base += nthreads) {
    const int s = base + (tid & 31);
    int c = -1, k = -1, l = 0;
    if (s < nb0) {
      c = p[CL * dc + s];
      k = p[CK * dc + s];
      l = p[LN * dc + s];
    }
    const bool start = l > 0 && k >= 0;
    if (start) start_put_atomic(sm, t.hs - 1, c, k, s);
    bit_set_warp(b, t.hb - 1, c, k, start);
    if (c >= 0 && c < YTPU_KC) atomicMax(&cclock[c], k + l);
  }
}

// one step of the doc: its rows, then its delete ranges, then the
// move-ownership recompute
__device__ __forceinline__ void integrate_step(Doc& d, const int* rows, const int* dels,
                                               int U, int R) {
  PROF_COUNT(d, CNT_STEPS);
  for (int u = 0; u < U; ++u) {
    const int* r = rows + (size_t)u * ROW_W;
    if (r[14] == 1) integrate_row(d, r);
  }
  for (int q = 0; q < R; ++q) {
    const int* r = dels + (size_t)q * DEL_W;
    if (r[3] == 1) delete_range(d, r);
  }
  recompute_moves(d);
}

// The body of both integrate kernels. PER_DOC false: one [S, U, 23] /
// [S, R, 4] stream shared by every doc, staged through the ring, and phase
// 1 in this kernel (every warp of the CTA). PER_DOC true: S = 1 and each
// doc has its own rows and deletes ([D, U, 23] / [D, R, 4]); a warp reads
// its doc's block straight from device memory (one step, read once), so no
// ring is planned, and phase 1 ran before, in `integrate_batch_index_kernel`:
// this kernel loads each doc's client clocks and slot bound from
// doc_words. CAPACITY_SIZED (the profiling build's baseline only) is the
// per-doc entry as it was before: phase 1 in this kernel, every doc's
// scratch sized and cleared for C slots.
template <bool PER_DOC, bool CAPACITY_SIZED = false>
__device__ __forceinline__ void integrate_body(
    int* __restrict__ cols, int* __restrict__ meta, const int* __restrict__ rows,
    const int* __restrict__ dels, const int* __restrict__ rank, int S, int U, int R,
    int K, int D, int C, int cheap, int unroll, int T, ulonglong2* bidx, int HB,
    ulonglong2* sidx, int HS, int* bstamp, int* cstamp, int* doc_words, long long* prof) {
  constexpr bool FUSED = !PER_DOC || CAPACITY_SIZED;  // phase 1 in this kernel
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + STAGES;
  int* cclock_all = reinterpret_cast<int*>(smem + BAR_BYTES);
  unsigned char* ring = smem + BAR_BYTES + DOCS_PER_CTA * YTPU_KC * 4;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int doc0 = blockIdx.x * DOCS_PER_CTA;
  const int n_act = min(DOCS_PER_CTA, D - doc0);
  const int n_tiles = (S + T - 1) / T;

  if (!PER_DOC) {
    if (tid == 0) {
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], n_act);  // one arrival per live consumer warp
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    // the first tiles stream in while the CTA builds the index
    if (warp == DOCS_PER_CTA && lane == 0)
      for (int t = 0; t < min(STAGES, n_tiles); ++t)
        issue_tile(t, ring, full, rows, dels, S, U, R, T);
  }

  // ---- phase 1 (whole CTA): size and clear scratch, index the live slots -
#ifdef YTPU_INTEGRATE_PROFILE
  __shared__ long long p1_clock[3];
  if (tid == 0) p1_clock[0] = clock64();
#endif
  const size_t dc = (size_t)D * C;
  __shared__ int moves[DOCS_PER_CTA];  // live move rows a doc holds
  if (FUSED) {
    for (int i = tid; i < DOCS_PER_CTA * YTPU_KC; i += THREADS) cclock_all[i] = 0;
    if (tid < DOCS_PER_CTA) moves[tid] = 0;
    __syncthreads();
    // count a doc's live moves only where its bound can stay below C
    for (int w = 0; w < n_act && !CAPACITY_SIZED; ++w) {
      const int nb0 = meta[(doc0 + w) * M_PAD + M_NBLOCKS];
      if (live_bound(nb0, 0, S, U, R, C) < C)
        count_moves(cols + (doc0 + w) * C, dc, nb0, tid, THREADS, &moves[w]);
    }
    __syncthreads();
  } else {  // the index kernel's client clocks
    for (int i = tid; i < DOCS_PER_CTA * YTPU_KC; i += THREADS) {
      const int w = i / YTPU_KC;
      cclock_all[i] = w < n_act ? doc_words[(doc0 + w) * DOC_WORDS + i % YTPU_KC] : 0;
    }
  }
  auto bound = [&](int w) {
    if (!FUSED) return doc_words[(doc0 + w) * DOC_WORDS + YTPU_KC];
    return CAPACITY_SIZED ? C
                          : live_bound(meta[(doc0 + w) * M_PAD + M_NBLOCKS], moves[w], S, U, R, C);
  };
  if (FUSED) {
    for (int w = 0; w < n_act; ++w) {
      const size_t doc = doc0 + w;
      const int n = bound(w);
      clear_scratch(bidx + doc * HB, sidx + doc * HS, bstamp + doc * C, cstamp + doc * C,
                    tables_for(n, HB, HS), n, tid, THREADS);
    }
    __syncthreads();
#ifdef YTPU_INTEGRATE_PROFILE
    if (tid == 0) p1_clock[1] = clock64();
#endif
    for (int w = 0; w < n_act; ++w) {
      const size_t doc = doc0 + w;
      index_slots(cols + doc * C, dc, meta[doc * M_PAD + M_NBLOCKS], bidx + doc * HB,
                  sidx + doc * HS, tables_for(bound(w), HB, HS), cclock_all + w * YTPU_KC, tid,
                  THREADS);
    }
  }
  __syncthreads();
#ifdef YTPU_INTEGRATE_PROFILE
  if (tid == 0) p1_clock[2] = clock64();
  __syncthreads();
#endif

  if (warp == DOCS_PER_CTA) {  // the producer: refill each stage once freed
    if (!PER_DOC && lane == 0)
      for (int t = STAGES; t < n_tiles; ++t) {
        mbar_wait(&empty[t % STAGES], (uint32_t)((t / STAGES - 1) & 1));
        issue_tile(t, ring, full, rows, dels, S, U, R, T);
      }
    return;
  }
  if (warp >= n_act) return;

  // ---- phase 2 (one warp per doc): the doc's serial integrate -------------
  const size_t doc = doc0 + warp;
  int* m = meta + doc * M_PAD;
  const int n_bound = bound(warp);
  const Tables tab = tables_for(n_bound, HB, HS);
  Doc d;
  d.cols = cols + doc * C;
  d.dc = dc;
  d.C = C;
  d.lane = lane;
  d.bidx = bidx + doc * HB;
  d.bmask = tab.hb - 1;
  d.sidx = sidx + doc * HS;
  d.smask = tab.hs - 1;
  d.cclock = cclock_all + warp * YTPU_KC;
  d.bstamp = bstamp + doc * C;
  d.cstamp = cstamp + doc * C;
  d.rank = rank;
  d.K = K;
  d.cheap = cheap;
  d.unroll = unroll;
  d.start = m[M_START];
  d.nb = m[M_NBLOCKS];
  d.err = m[M_ERROR];
  d.mdirty = m[M_MDIRTY];
#pragma unroll
  for (int w = 0; w < SC_WORDS; ++w) d.sc[w] = m[M_HIST0 + w];
  d.row_epoch = 0;
  d.conf_epoch = 0;
  d.cc_client = 0;
  d.cc_start = 0;
  d.cc_len = 0;
  d.cc_slot = -1;
  d.cc_next = 0;
  d.index_writes = 0;
#ifdef YTPU_INTEGRATE_PROFILE
  __shared__ long long prof_acc[DOCS_PER_CTA][PROF_WORDS];
  if (lane == 0) {
    for (int w = 0; w < PROF_WORDS; ++w) prof_acc[warp][w] = 0;
    // phase 1's words: this CTA's, or those the index kernel left
    const bool own = FUSED || prof == nullptr;
    prof_acc[warp][PH_CLEAR] = own ? p1_clock[1] - p1_clock[0] : prof[doc * PROF_WORDS + PH_CLEAR];
    prof_acc[warp][PH_INDEX_BUILD] =
        own ? p1_clock[2] - p1_clock[1] : prof[doc * PROF_WORDS + PH_INDEX_BUILD];
    prof_acc[warp][CNT_BOUND] = n_bound;
  }
  d.prof.acc = prof_acc[warp];
  d.prof.lane0 = lane == 0;
  d.prof.cur = PH_OTHER;
  d.prof.t = clock64();
#endif
  if (PER_DOC) {
    integrate_step(d, rows + doc * U * ROW_W, dels + doc * R * DEL_W, U, R);
  } else {
    const size_t stage_b = (size_t)T * (U * ROW_W + R * DEL_W) * 4;
    for (int t = 0; t < n_tiles; ++t) {
      const int stg = t % STAGES;
      {
        PROF_SCOPE(d, PH_STREAM);
        mbar_wait(&full[stg], (uint32_t)((t / STAGES) & 1));
      }
      const int* trows = reinterpret_cast<const int*>(ring + stg * stage_b);
      const int* tdels = trows + (size_t)T * U * ROW_W;
      const int n = min(T, S - t * T);
      for (int sl = 0; sl < n; ++sl)
        integrate_step(d, trows + (size_t)sl * U * ROW_W, tdels + (size_t)sl * R * DEL_W, U, R);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stg]);
    }
  }
  if (lane == 0) {
    m[M_START] = d.start;
    m[M_NBLOCKS] = d.nb;
    m[M_ERROR] = d.err;
    m[M_MDIRTY] = d.mdirty;
#pragma unroll
    for (int w = 0; w < SC_WORDS; ++w) m[M_HIST0 + w] = d.sc[w];
  }
#ifdef YTPU_INTEGRATE_PROFILE
  prof_switch(d.prof, PH_OTHER);
  if (lane == 0 && prof != nullptr)
    for (int w = 0; w < PROF_WORDS; ++w) prof[doc * PROF_WORDS + w] = prof_acc[warp][w];
#endif
}

// the shared stream into every doc
__global__ void __launch_bounds__(THREADS, 1)
integrate_kernel(int* __restrict__ cols, int* __restrict__ meta,
                 const int* __restrict__ rows, const int* __restrict__ dels,
                 const int* __restrict__ rank, int S, int U, int R, int K,
                 int D, int C, int cheap, int unroll, int T,
                 ulonglong2* bidx, int HB, ulonglong2* sidx, int HS,
                 int* bstamp, int* cstamp, int* doc_words, long long* prof) {
  integrate_body<false>(cols, meta, rows, dels, rank, S, U, R, K, D, C, cheap, unroll, T,
                        bidx, HB, sidx, HS, bstamp, cstamp, doc_words, prof);
}

// one step of per-doc rows into each doc (S = 1, T = 1)
__global__ void __launch_bounds__(THREADS, 1)
integrate_batch_kernel(int* __restrict__ cols, int* __restrict__ meta,
                       const int* __restrict__ rows, const int* __restrict__ dels,
                       const int* __restrict__ rank, int S, int U, int R, int K,
                       int D, int C, int cheap, int unroll, int T,
                       ulonglong2* bidx, int HB, ulonglong2* sidx, int HS,
                       int* bstamp, int* cstamp, int* doc_words, long long* prof) {
  integrate_body<true>(cols, meta, rows, dels, rank, S, U, R, K, D, C, cheap, unroll, T,
                       bidx, HB, sidx, HS, bstamp, cstamp, doc_words, prof);
}

#ifdef YTPU_INTEGRATE_PROFILE
// the per-doc entry with every doc's scratch sized and cleared for C
// slots: the profile's baseline for live_bound's sizing
__global__ void __launch_bounds__(THREADS, 1)
integrate_batch_capacity_kernel(int* __restrict__ cols, int* __restrict__ meta,
                                const int* __restrict__ rows, const int* __restrict__ dels,
                                const int* __restrict__ rank, int S, int U, int R, int K,
                                int D, int C, int cheap, int unroll, int T,
                                ulonglong2* bidx, int HB, ulonglong2* sidx, int HS,
                                int* bstamp, int* cstamp, int* doc_words, long long* prof) {
  integrate_body<true, true>(cols, meta, rows, dels, rank, S, U, R, K, D, C, cheap, unroll, T,
                             bidx, HB, sidx, HS, bstamp, cstamp, doc_words, prof);
}
#endif

// The per-doc entry's phase 1, one CTA of INDEX_THREADS per doc: its live
// moves counted, its scratch sized by live_bound and cleared, its slots
// indexed; it leaves the doc's client clocks and slot bound in doc_words
// for integrate_batch_kernel. Apart from the integrate kernel it needs few
// registers, so a whole wave of docs runs at once, each chain of dependent
// atomics on its own threads.
__global__ void __launch_bounds__(INDEX_THREADS)
integrate_batch_index_kernel(const int* __restrict__ cols, const int* __restrict__ meta, int U,
                             int R, int D, int C, ulonglong2* bidx, int HB, ulonglong2* sidx,
                             int HS, int* bstamp, int* cstamp, int* doc_words, long long* prof) {
  __shared__ int cclock[YTPU_KC];
  __shared__ int moves;
  const int tid = threadIdx.x;
  const size_t doc = blockIdx.x, dc = (size_t)D * C;
#ifdef YTPU_INTEGRATE_PROFILE
  const long long t0 = clock64();
#endif
  const int* p = cols + doc * C;
  const int nb0 = meta[doc * M_PAD + M_NBLOCKS];
  for (int i = tid; i < YTPU_KC; i += INDEX_THREADS) cclock[i] = 0;
  if (tid == 0) moves = 0;
  __syncthreads();
  if (live_bound(nb0, 0, 1, U, R, C) < C) count_moves(p, dc, nb0, tid, INDEX_THREADS, &moves);
  __syncthreads();
  const int n = live_bound(nb0, moves, 1, U, R, C);
  const Tables t = tables_for(n, HB, HS);
  clear_scratch(bidx + doc * HB, sidx + doc * HS, bstamp + doc * C, cstamp + doc * C, t, n,
                tid, INDEX_THREADS);
  __syncthreads();
#ifdef YTPU_INTEGRATE_PROFILE
  const long long t1 = clock64();
#endif
  index_slots(p, dc, nb0, bidx + doc * HB, sidx + doc * HS, t, cclock, tid, INDEX_THREADS);
  __syncthreads();
  int* out = doc_words + doc * DOC_WORDS;
  for (int i = tid; i < YTPU_KC; i += INDEX_THREADS) out[i] = cclock[i];
  if (tid == 0) out[YTPU_KC] = n;
#ifdef YTPU_INTEGRATE_PROFILE
  if (tid == 0 && prof != nullptr) {
    prof[doc * PROF_WORDS + PH_CLEAR] = t1 - t0;
    prof[doc * PROF_WORDS + PH_INDEX_BUILD] = clock64() - t1;
  }
#endif
}

using Kernel = decltype(&integrate_kernel);

// one launch of `kern` by plan `p`; a plan whose shared memory does not
// fit a block is refused, not clamped
// the tables' entries are powers of two, and start 16-byte aligned
int check_scratch(void* bidx, int HB, void* sidx, int HS) {
  if (HB <= 0 || (HB & (HB - 1)) || HS <= 0 || (HS & (HS - 1)))
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)bidx | (uintptr_t)sidx) & 15) return (int)cudaErrorMisalignedAddress;
  return 0;
}

int launch(Kernel kern, const int* p, void* cols, void* meta, const void* rows,
           const void* dels, const void* rank, int S, int U, int R, int K, int D,
           int C, int cheap, int unroll, void* bidx, int HB, void* sidx, int HS,
           void* bstamp, void* cstamp, void* doc_words, void* prof, void* stream) {
  if (D <= 0) return 0;
  if (const int e = check_scratch(bidx, HB, sidx, HS)) return e;
  const size_t smem = p[P_SMEM];
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<p[P_CTAS], THREADS, smem, (cudaStream_t)stream>>>(
      (int*)cols, (int*)meta, (const int*)rows, (const int*)dels,
      (const int*)rank, S, U, R, K, D, C, cheap, unroll, p[P_TILE],
      (ulonglong2*)bidx, HB, (ulonglong2*)sidx, HS, (int*)bstamp, (int*)cstamp,
      (int*)doc_words, (long long*)prof);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ytpu_integrate_stream(
    void* cols, void* meta, const void* rows, const void* dels,
    const void* rank, int S, int U, int R, int K, int D, int C, int cheap,
    int unroll, void* bidx, int HB, void* sidx, int HS, void* bstamp,
    void* cstamp, void* prof, void* stream) {
  // the ring's bulk copies read 16-byte-aligned sources
  if (((uintptr_t)rows | (uintptr_t)dels) & 15) return (int)cudaErrorMisalignedAddress;
  int p[PLAN_WORDS];
  launch_plan(S, U, R, D, p);
  return launch(integrate_kernel, p, cols, meta, rows, dels, rank, S, U, R, K, D, C, cheap,
                unroll, bidx, HB, sidx, HS, bstamp, cstamp, nullptr, prof, stream);
}

// rows [D, U, 23] and dels [D, R, 4]: one step of each doc's own update,
// as two launches: the index kernel, then the integrate kernel. doc_words
// is [D, DOC_WORDS] int32 scratch. `prof` and `capacity_sized` are the
// profiling build's (its counters, and its baseline: the entry as it was,
// one kernel that clears every doc's scratch for C slots); other builds
// take nullptr and 0.
extern "C" int ytpu_integrate_batch(
    void* cols, void* meta, const void* rows, const void* dels,
    const void* rank, int U, int R, int K, int D, int C, int cheap, int unroll,
    void* bidx, int HB, void* sidx, int HS, void* bstamp, void* cstamp, void* doc_words,
    void* prof, int capacity_sized, void* stream) {
  int p[PLAN_WORDS];
  batch_plan(D, p);
#ifdef YTPU_INTEGRATE_PROFILE
  if (capacity_sized)
    return launch(integrate_batch_capacity_kernel, p, cols, meta, rows, dels, rank, 1, U, R, K,
                  D, C, cheap, unroll, bidx, HB, sidx, HS, bstamp, cstamp, doc_words, prof,
                  stream);
#else
  if (capacity_sized || prof) return (int)cudaErrorInvalidValue;
#endif
  if (D <= 0) return 0;
  if (const int e = check_scratch(bidx, HB, sidx, HS)) return e;
  integrate_batch_index_kernel<<<p[P_INDEX_CTAS], p[P_INDEX_THREADS], 0, (cudaStream_t)stream>>>(
      (const int*)cols, (const int*)meta, U, R, D, C, (ulonglong2*)bidx, HB, (ulonglong2*)sidx, HS,
      (int*)bstamp, (int*)cstamp, (int*)doc_words, (long long*)prof);
  if (const cudaError_t e = cudaGetLastError()) return (int)e;
  return launch(integrate_batch_kernel, p, cols, meta, rows, dels, rank, 1, U, R, K, D, C, cheap,
                unroll, bidx, HB, sidx, HS, bstamp, cstamp, doc_words, prof, stream);
}

// phase 1's sizing of a doc that holds nb0 slots (`moves` live move rows)
// before a launch of S steps of U rows and R delete ranges, into out[4]:
// the slots the launch can reach (live_bound), the bitmap and start-map
// entries, and the bytes its phase 1 clears (16 per table entry, 8 per
// slot of the two stamp arrays)
extern "C" int ytpu_integrate_scratch(int nb0, int moves, int S, int U, int R, int C, int* out) {
  const int n = live_bound(nb0, moves, S, U, R, C);
  const int HB = (int)pow2_at_least(8LL * C), HS = (int)pow2_at_least(2LL * C);
  const Tables tab = tables_for(n, HB, HS);
  out[0] = n;
  out[1] = (int)tab.hb;
  out[2] = (int)tab.hs;
  out[3] = 16 * (int)(tab.hb + tab.hs) + 8 * n;
  return 4;
}

// the launch `ytpu_integrate_stream` makes, as PLAN_WORDS ints in PlanWord
// order
extern "C" int ytpu_integrate_plan(int S, int U, int R, int D, int* out) {
  launch_plan(S, U, R, D, out);
  return PLAN_WORDS;
}

// the launch `ytpu_integrate_batch` makes
extern "C" int ytpu_integrate_batch_plan(int D, int* out) {
  batch_plan(D, out);
  return PLAN_WORDS;
}

extern "C" int ytpu_integrate_prof_words() {
#ifdef YTPU_INTEGRATE_PROFILE
  return PROF_WORDS;
#else
  return 0;
#endif
}

extern "C" const char* ytpu_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
