// lib0 v1 update walker: the host column walk of the port (a copy of
// the JAX package's ytpu/native/lib0_codec.cpp, same semantics).
//
// Grammar: the v1 update framing of yrs (src/updates/decoder.rs:76-190,
// src/update.rs:433-488) and Any skipping per any.rs:37-83. Each update
// becomes struct-of-arrays int64 columns, one row per block (client,
// clock, length, kind, origins, how it names its parent, content span)
// and one per delete range, plus the wire-section counts the device
// decoder's step budget and the ingest fast lane read. Payload bytes stay
// in place and are named by (offset, length) spans into the update.
// Zero-length item blocks are dropped from the columns but counted; Skip
// and GC carriers stay. On malformed input `error` is set and the columns
// keep what was read before the fault, the block it failed in included.
//
// One C entry walks N updates out of one byte arena in one call
// (ytpu_walk_batch), the caller lifts the result with one copy
// (ytpu_walk_take) and frees it (ytpu_walk_free); bound with ctypes by
// ytpu_torch/native/__init__.py.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint8_t BLOCK_GC = 0;
constexpr uint8_t CONTENT_DELETED = 1;
constexpr uint8_t CONTENT_JSON = 2;
constexpr uint8_t CONTENT_BINARY = 3;
constexpr uint8_t CONTENT_STRING = 4;
constexpr uint8_t CONTENT_EMBED = 5;
constexpr uint8_t CONTENT_FORMAT = 6;
constexpr uint8_t CONTENT_TYPE = 7;
constexpr uint8_t CONTENT_ANY = 8;
constexpr uint8_t CONTENT_DOC = 9;
constexpr uint8_t BLOCK_SKIP = 10;
constexpr uint8_t CONTENT_MOVE = 11;

constexpr uint8_t HAS_ORIGIN = 0x80;
constexpr uint8_t HAS_RIGHT_ORIGIN = 0x40;
constexpr uint8_t HAS_PARENT_SUB = 0x20;

constexpr uint8_t TYPE_XML_ELEMENT = 3;
constexpr uint8_t TYPE_XML_HOOK = 5;
constexpr uint8_t TYPE_WEAK = 7;

struct Cursor {
  const uint8_t* buf;
  size_t len;
  size_t pos;
  bool error;

  uint8_t u8() {
    if (pos >= len) {
      error = true;
      return 0;
    }
    return buf[pos++];
  }

  uint64_t var_uint() {
    uint64_t num = 0;
    int shift = 0;
    while (true) {
      uint8_t b = u8();
      if (error) return 0;
      num |= (uint64_t)(b & 0x7F) << shift;
      shift += 7;
      if (b < 0x80) return num;
      if (shift >= 70) {  // 10-byte cap: an 11th byte would shift ≥64 (UB)
        error = true;
        return 0;
      }
    }
  }

  void skip(size_t n) {
    if (pos > len || n > len - pos) {  // overflow-safe bound
      error = true;
      return;
    }
    pos += n;
  }

  // span helpers: record [start, end) of a length-prefixed buffer
  void buf_span(int64_t* start, int64_t* length) {
    uint64_t n = var_uint();
    *start = (int64_t)pos;
    *length = (int64_t)n;
    skip((size_t)n);
  }

  void skip_var_int() {  // signed varint (6-bit head)
    uint8_t b = u8();
    if (error || (b & 0x80) == 0) return;
    while (true) {
      b = u8();
      if (error || b < 0x80) return;
    }
  }

  void skip_f(int n) { skip(n); }

  void skip_any() {  // parity: any.rs:37-83
    uint8_t tag = u8();
    if (error) return;
    switch (tag) {
      case 127:  // undefined
      case 126:  // null
      case 121:  // false
      case 120:  // true
        return;
      case 125:  // integer (signed varint)
        skip_var_int();
        return;
      case 124:  // f32
        skip_f(4);
        return;
      case 123:  // f64
      case 122:  // bigint
        skip_f(8);
        return;
      case 119: {  // string
        uint64_t n = var_uint();
        skip((size_t)n);
        return;
      }
      case 118: {  // map
        uint64_t n = var_uint();
        for (uint64_t i = 0; i < n && !error; i++) {
          uint64_t k = var_uint();
          skip((size_t)k);
          skip_any();
        }
        return;
      }
      case 117: {  // array
        uint64_t n = var_uint();
        for (uint64_t i = 0; i < n && !error; i++) skip_any();
        return;
      }
      case 116: {  // buffer
        uint64_t n = var_uint();
        skip((size_t)n);
        return;
      }
      default:
        error = true;
        return;
    }
  }

  // skip one Any value counting device decode tokens (one step per
  // scalar or array header; maps/unknown tags report as complex)
  void skip_any_tokens(int64_t* tokens, int64_t* complex_vals) {
    if (pos < len) {
      uint8_t tag = buf[pos];
      if (tag < 116) {
        (*complex_vals)++;
      } else if (tag == 118) {
        // depth-1 object: header token + one token per key + one per
        // scalar value; nested arrays/objects inside stay host-lane
        pos++;  // tag
        uint64_t n = var_uint();
        (*tokens)++;
        for (uint64_t i = 0; i < n && !error; i++) {
          uint64_t klen = var_uint();
          skip((size_t)klen);
          (*tokens)++;
          if (pos < len) {
            uint8_t vt = buf[pos];
            if (vt == 117 || vt == 118 || vt < 116) (*complex_vals)++;
          }
          (*tokens)++;
          skip_any();
        }
        return;
      } else if (tag == 117) {
        // array header consumes one token; children count themselves
        size_t save = pos;
        pos++;  // tag
        uint64_t n = var_uint();
        (*tokens)++;
        for (uint64_t i = 0; i < n && !error; i++)
          skip_any_tokens(tokens, complex_vals);
        (void)save;
        return;
      }
    }
    (*tokens)++;
    skip_any();
  }
};

// UTF-16 code-unit length of a UTF-8 byte span (the Yjs clock unit).
int64_t utf16_units(const uint8_t* p, int64_t n) {
  int64_t units = 0;
  for (int64_t i = 0; i < n;) {
    uint8_t b = p[i];
    if (b < 0x80) {
      units += 1;
      i += 1;
    } else if ((b >> 5) == 0x6) {
      units += 1;
      i += 2;
    } else if ((b >> 4) == 0xE) {
      units += 1;
      i += 3;
    } else if ((b >> 3) == 0x1E) {
      units += 2;  // astral char: surrogate pair
      i += 4;
    } else {
      i += 1;  // invalid byte: resynchronize
    }
  }
  return units;
}

struct Columns {
  // one row per block carrier
  std::vector<int64_t> client, clock, length, kind;
  std::vector<int64_t> origin_client, origin_clock;       // -1 clock if none
  std::vector<int64_t> ror_client, ror_clock;             // -1 if none
  std::vector<int64_t> parent_kind;  // 0=none,1=name,2=id,3=inherit(unset)
  std::vector<int64_t> parent_name_start, parent_name_len;
  std::vector<int64_t> parent_id_client, parent_id_clock;
  std::vector<int64_t> parent_sub_start, parent_sub_len;  // -1 if none
  std::vector<int64_t> content_start, content_len_bytes;  // payload span
  // delete set rows
  std::vector<int64_t> del_client, del_start, del_end;
  // wire-section counts (header values, not emitted-row counts): the
  // device decoder's step budget and header guard must cover sections
  // that emit zero rows (covered Skip runs, empty ds-client sections)
  int64_t n_client_sections = 0;
  int64_t n_ds_sections = 0;
  // item blocks with zero CRDT length, dropped from the columns
  // (update.rs:737-742) but still present on the wire: the device
  // decoder spends parse steps on them, so budgets must count them
  int64_t n_zero_len_blocks = 0;
  // extra device decode steps for value-list content (one per Any/Json
  // value, one per Format key) and the count of Any values the device
  // cannot parse (recursive map/array tags)
  int64_t n_value_steps = 0;
  int64_t n_complex_any = 0;
  int error = 0;
};

// skip one content payload, recording its byte span and returning its
// CRDT length (clock units)
int64_t read_content(Cursor& c, uint8_t info, Columns& out) {
  uint8_t ref = info & 0x0F;
  int64_t span_start = (int64_t)c.pos;
  int64_t crdt_len = 1;
  switch (ref) {
    case CONTENT_DELETED:
      crdt_len = (int64_t)c.var_uint();
      break;
    case CONTENT_JSON: {
      uint64_t n = c.var_uint();
      for (uint64_t i = 0; i < n && !c.error; i++) {
        uint64_t k = c.var_uint();
        c.skip((size_t)k);
      }
      crdt_len = (int64_t)n;
      out.n_value_steps += (int64_t)n;
      break;
    }
    case CONTENT_BINARY: {
      uint64_t n = c.var_uint();
      c.skip((size_t)n);
      crdt_len = 1;
      break;
    }
    case CONTENT_STRING: {
      uint64_t n = c.var_uint();
      const uint8_t* p = c.buf + c.pos;
      c.skip((size_t)n);
      if (!c.error) crdt_len = utf16_units(p, (int64_t)n);
      break;
    }
    case CONTENT_EMBED: {
      uint64_t n = c.var_uint();
      c.skip((size_t)n);
      break;
    }
    case CONTENT_FORMAT: {
      uint64_t k = c.var_uint();
      c.skip((size_t)k);
      uint64_t v = c.var_uint();
      c.skip((size_t)v);
      out.n_value_steps += 1;  // device: key step + value step
      break;
    }
    case CONTENT_TYPE: {
      uint8_t tag = c.u8();
      if (tag == TYPE_XML_ELEMENT || tag == TYPE_XML_HOOK) {
        uint64_t n = c.var_uint();
        c.skip((size_t)n);
      } else if (tag == TYPE_WEAK) {
        uint8_t flags = c.u8();
        c.var_uint();
        c.var_uint();
        if (flags & 1) {
          c.var_uint();
          c.var_uint();
        }
      }
      break;
    }
    case CONTENT_ANY: {
      uint64_t n = c.var_uint();
      int64_t tokens = 0;
      for (uint64_t i = 0; i < n && !c.error; i++) {
        // one device step per scalar/array-header/object-header/key
        // token; non-scalar values INSIDE an object and unknown tags
        // exceed the device model (complex -> host lane)
        c.skip_any_tokens(&tokens, &out.n_complex_any);
      }
      crdt_len = (int64_t)n;
      out.n_value_steps += tokens;
      break;
    }
    case CONTENT_DOC: {
      uint64_t n = c.var_uint();  // guid string
      c.skip((size_t)n);
      c.skip_any();
      break;
    }
    case CONTENT_MOVE: {
      uint64_t flags = c.var_uint();
      c.var_uint();
      c.var_uint();
      if (!(flags & 1)) {
        c.var_uint();
        c.var_uint();
      }
      break;
    }
    default:
      c.error = true;
      break;
  }
  out.content_start.push_back(span_start);
  out.content_len_bytes.push_back((int64_t)c.pos - span_start);
  return crdt_len;
}

// Walk one update, appending its blocks and delete ranges to `out`'s
// columns and setting its wire-section counts and `error` (the caller
// resets those between payloads).
void decode_update(const uint8_t* data, size_t n, Columns* out) {
  Cursor c{data, n, 0, false};
  uint64_t n_clients = c.var_uint();
  out->n_client_sections = (int64_t)n_clients;
  for (uint64_t ci = 0; ci < n_clients && !c.error; ci++) {
    uint64_t n_blocks = c.var_uint();
    uint64_t client = c.var_uint();
    uint64_t clock = c.var_uint();
    for (uint64_t bi = 0; bi < n_blocks && !c.error; bi++) {
      uint8_t info = c.u8();
      if (c.error) break;
      if (info == BLOCK_SKIP || info == BLOCK_GC) {
        uint64_t len = c.var_uint();
        out->client.push_back((int64_t)client);
        out->clock.push_back((int64_t)clock);
        out->length.push_back((int64_t)len);
        out->kind.push_back(info == BLOCK_SKIP ? BLOCK_SKIP : BLOCK_GC);
        out->origin_client.push_back(-1);
        out->origin_clock.push_back(-1);
        out->ror_client.push_back(-1);
        out->ror_clock.push_back(-1);
        out->parent_kind.push_back(0);
        out->parent_name_start.push_back(-1);
        out->parent_name_len.push_back(-1);
        out->parent_id_client.push_back(-1);
        out->parent_id_clock.push_back(-1);
        out->parent_sub_start.push_back(-1);
        out->parent_sub_len.push_back(-1);
        out->content_start.push_back(-1);
        out->content_len_bytes.push_back(0);
        clock += len;
        continue;
      }
      bool cant_copy_parent = (info & (HAS_ORIGIN | HAS_RIGHT_ORIGIN)) == 0;
      int64_t oc = -1, ok = -1, rc = -1, rk = -1;
      if (info & HAS_ORIGIN) {
        oc = (int64_t)c.var_uint();
        ok = (int64_t)c.var_uint();
      }
      if (info & HAS_RIGHT_ORIGIN) {
        rc = (int64_t)c.var_uint();
        rk = (int64_t)c.var_uint();
      }
      int64_t pk = 3, pns = -1, pnl = -1, pic = -1, pik = -1, pss = -1,
              psl = -1;
      if (cant_copy_parent) {
        if (c.var_uint() == 1) {
          pk = 1;
          uint64_t len2 = c.var_uint();
          pns = (int64_t)c.pos;
          pnl = (int64_t)len2;
          c.skip((size_t)len2);
        } else {
          pk = 2;
          pic = (int64_t)c.var_uint();
          pik = (int64_t)c.var_uint();
        }
        if (info & HAS_PARENT_SUB) {
          uint64_t len2 = c.var_uint();
          pss = (int64_t)c.pos;
          psl = (int64_t)len2;
          c.skip((size_t)len2);
        }
      }
      out->client.push_back((int64_t)client);
      out->clock.push_back((int64_t)clock);
      out->kind.push_back(info & 0x0F);
      out->origin_client.push_back(oc);
      out->origin_clock.push_back(ok);
      out->ror_client.push_back(rc);
      out->ror_clock.push_back(rk);
      out->parent_kind.push_back(pk);
      out->parent_name_start.push_back(pns);
      out->parent_name_len.push_back(pnl);
      out->parent_id_client.push_back(pic);
      out->parent_id_clock.push_back(pik);
      out->parent_sub_start.push_back(pss);
      out->parent_sub_len.push_back(psl);
      int64_t crdt_len = read_content(c, info, *out);
      if (crdt_len == 0) {
        // historical empty blocks have no effect (parity: update.rs:737-742)
        out->n_zero_len_blocks++;
        out->client.pop_back();
        out->clock.pop_back();
        out->kind.pop_back();
        out->origin_client.pop_back();
        out->origin_clock.pop_back();
        out->ror_client.pop_back();
        out->ror_clock.pop_back();
        out->parent_kind.pop_back();
        out->parent_name_start.pop_back();
        out->parent_name_len.pop_back();
        out->parent_id_client.pop_back();
        out->parent_id_clock.pop_back();
        out->parent_sub_start.pop_back();
        out->parent_sub_len.pop_back();
        out->content_start.pop_back();
        out->content_len_bytes.pop_back();
        continue;
      }
      out->length.push_back(crdt_len);
      clock += (uint64_t)crdt_len;
    }
  }
  // delete set
  if (!c.error) {
    uint64_t ds_clients = c.var_uint();
    out->n_ds_sections = (int64_t)ds_clients;
    for (uint64_t i = 0; i < ds_clients && !c.error; i++) {
      uint64_t client = c.var_uint();
      uint64_t n_ranges = c.var_uint();
      for (uint64_t r = 0; r < n_ranges && !c.error; r++) {
        uint64_t start = c.var_uint();
        uint64_t len2 = c.var_uint();
        out->del_client.push_back((int64_t)client);
        out->del_start.push_back((int64_t)start);
        out->del_end.push_back((int64_t)(start + len2));
      }
    }
  }
  out->error = c.error ? 1 : 0;
}

}  // namespace

namespace {

constexpr int N_BLOCK_COLUMNS = 17;
constexpr int N_DEL_COLUMNS = 3;
constexpr int N_COUNTS = 8;

struct WalkBatch {
  Columns cols;                  // every update's rows, concatenated
  std::vector<uint64_t> counts;  // [n, N_COUNTS]
};

}  // namespace

extern "C" {

// Walk n updates, update i being arena[offs[i], offs[i] + lens[i]).
// Returns the batch; totals[0] is its block rows over all updates,
// totals[1] its delete ranges.
void* ytpu_walk_batch(const uint8_t* arena, const int64_t* offs,
                      const int64_t* lens, int64_t n, int64_t* totals) {
  auto* b = new WalkBatch();
  Columns& out = b->cols;
  b->counts.resize((size_t)n * N_COUNTS);
  for (int64_t i = 0; i < n; i++) {
    const size_t blocks0 = out.client.size(), dels0 = out.del_client.size();
    out.n_client_sections = out.n_ds_sections = out.n_zero_len_blocks = 0;
    out.n_value_steps = out.n_complex_any = 0;
    out.error = 0;
    decode_update(arena + offs[i], (size_t)lens[i], &out);
    uint64_t* c = &b->counts[(size_t)i * N_COUNTS];
    c[0] = out.client.size() - blocks0;
    c[1] = out.del_client.size() - dels0;
    c[2] = (uint64_t)out.n_client_sections;
    c[3] = (uint64_t)out.n_ds_sections;
    c[4] = (uint64_t)out.n_zero_len_blocks;
    c[5] = (uint64_t)out.n_value_steps;
    c[6] = (uint64_t)out.n_complex_any;
    c[7] = (uint64_t)out.error;
  }
  totals[0] = (int64_t)out.client.size();
  totals[1] = (int64_t)out.del_client.size();
  return b;
}

// Copy a walked batch into the caller's arrays: counts [n, 8] (n_blocks,
// n_dels, n_client_sections, n_ds_sections, n_zero_len_blocks,
// n_value_steps, n_complex_any, error), blocks [17, totals[0]] and dels
// [3, totals[1]], one row per column in the order of lib0.BLOCK_COLUMNS
// and lib0.DEL_COLUMNS.
void ytpu_walk_take(void* handle, uint64_t* counts, int64_t* blocks,
                    int64_t* dels) {
  auto* b = static_cast<WalkBatch*>(handle);
  const Columns& c = b->cols;
  std::memcpy(counts, b->counts.data(), b->counts.size() * sizeof(uint64_t));
  const std::vector<int64_t>* bcols[N_BLOCK_COLUMNS] = {
      &c.client, &c.clock, &c.length, &c.kind, &c.origin_client,
      &c.origin_clock, &c.ror_client, &c.ror_clock, &c.parent_kind,
      &c.parent_name_start, &c.parent_name_len, &c.parent_id_client,
      &c.parent_id_clock, &c.parent_sub_start, &c.parent_sub_len,
      &c.content_start, &c.content_len_bytes};
  const size_t nb = c.client.size();
  for (int k = 0; k < N_BLOCK_COLUMNS; k++)
    if (nb) std::memcpy(blocks + k * nb, bcols[k]->data(), nb * sizeof(int64_t));
  const std::vector<int64_t>* dcols[N_DEL_COLUMNS] = {&c.del_client, &c.del_start,
                                                       &c.del_end};
  const size_t nd = c.del_client.size();
  for (int k = 0; k < N_DEL_COLUMNS; k++)
    if (nd) std::memcpy(dels + k * nd, dcols[k]->data(), nd * sizeof(int64_t));
}

void ytpu_walk_free(void* handle) { delete static_cast<WalkBatch*>(handle); }

}  // extern "C"
