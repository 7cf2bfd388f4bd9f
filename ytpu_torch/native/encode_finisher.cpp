// Batched native wire-encode finisher of the port (a copy of the JAX
// package's ytpu/native/encode_finisher.cpp, same bytes).
//
// The host half of `encode_diff_batch`: the device selects which block
// rows ship to a remote (ship mask and first-block clock offsets) and
// compacts them into one [Dsel, 15, R] int32 tensor
// (ytpu_torch/models/batch_doc.py compact_finisher_rows); this module turns
// the selected rows of MANY docs into v1 update payloads in one call,
// byte for byte what the Python finisher (`_finish_rows`) writes.
// Reference equivalent: `Store::write_blocks_from` / `DeleteSet::encode`
// of yrs (src/store.rs:204-248, src/id_set.rs:440-).
//
// Variable-length content is resolved through two ref spaces (those of
// `ChunkedWirePayloads`):
//   ref >= 0  -> host PayloadStore item; the Python side pre-bakes three
//               arenas: UTF-16LE text, pre-encoded content blobs, and
//               per-element pre-encoded Any values.
//   ref <= -2 -> byte offset -(ref+2) into the retained wire chunks; spans
//               are re-emitted by walking the original update bytes.
// A row that would need a host JSON round-trip (wire Format/Embed refs) or
// an unknown content kind marks its whole doc STATUS_FALLBACK, and the
// Python finisher writes that doc alone.
//
// C entries: ytpu_finish_batch_strided (docs split over a thread pool),
// ytpu_finish_spans / ytpu_finish_total_len / ytpu_finish_data to lift the
// result, ytpu_finish_free, and ytpu_finish_in_sizeof, the layout guard of
// the ctypes mirror of FinishIn.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int32_t KIND_GC = 0;
constexpr int32_t KIND_DELETED = 1;
constexpr int32_t KIND_JSON = 2;
constexpr int32_t KIND_BINARY = 3;
constexpr int32_t KIND_STRING = 4;
constexpr int32_t KIND_EMBED = 5;
constexpr int32_t KIND_FORMAT = 6;
constexpr int32_t KIND_TYPE = 7;
constexpr int32_t KIND_ANY = 8;
// engine sentinel, not a wire ref: a synthetic per-doc row anchoring a
// non-primary named root (content.py BLOCK_ROOT_ANCHOR); rows parented
// to one re-emit the root-name wire form with the anchor's key name
constexpr int32_t KIND_ROOT_ANCHOR = 12;

constexpr int32_t STATUS_OK = 0;
constexpr int32_t STATUS_FALLBACK = 1;

struct Buf {
  std::string b;

  void u8(uint8_t v) { b.push_back(static_cast<char>(v)); }

  void var(uint64_t v) {
    while (v >= 0x80) {
      b.push_back(static_cast<char>(0x80 | (v & 0x7F)));
      v >>= 7;
    }
    b.push_back(static_cast<char>(v));
  }

  void raw(const uint8_t* p, size_t n) {
    b.append(reinterpret_cast<const char*>(p), n);
  }

  // write_string for an already-UTF-8 byte span (varint byte len + bytes)
  void str(const uint8_t* p, size_t n) {
    var(n);
    raw(p, n);
  }
};

// UTF-16LE → UTF-8 with lone surrogate halves replaced by U+FFFD —
// parity with Python's bytes.decode("utf-16-le", errors="replace")
// feeding Writer.write_string (PayloadStore.slice_text).
void utf16le_to_utf8(const uint8_t* p, size_t units, std::string& out) {
  size_t i = 0;
  while (i < units) {
    uint32_t u = static_cast<uint32_t>(p[2 * i]) |
                 (static_cast<uint32_t>(p[2 * i + 1]) << 8);
    uint32_t cp;
    if (u >= 0xD800 && u < 0xDC00) {
      if (i + 1 < units) {
        uint32_t lo = static_cast<uint32_t>(p[2 * i + 2]) |
                      (static_cast<uint32_t>(p[2 * i + 3]) << 8);
        if (lo >= 0xDC00 && lo < 0xE000) {
          cp = 0x10000 + ((u - 0xD800) << 10) + (lo - 0xDC00);
          i += 2;
        } else {
          cp = 0xFFFD;
          i += 1;
        }
      } else {
        cp = 0xFFFD;
        i += 1;
      }
    } else if (u >= 0xDC00 && u < 0xE000) {
      cp = 0xFFFD;
      i += 1;
    } else {
      cp = u;
      i += 1;
    }
    if (cp < 0x80) {
      out.push_back(static_cast<char>(cp));
    } else if (cp < 0x800) {
      out.push_back(static_cast<char>(0xC0 | (cp >> 6)));
      out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    } else if (cp < 0x10000) {
      out.push_back(static_cast<char>(0xE0 | (cp >> 12)));
      out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
      out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    } else {
      out.push_back(static_cast<char>(0xF0 | (cp >> 18)));
      out.push_back(static_cast<char>(0x80 | ((cp >> 12) & 0x3F)));
      out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
      out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    }
  }
}

// one UTF-8 lead byte → (bytes, utf-16 units); matches the Python
// unit_at in decode_kernel.utf8_slice_u16 (WTF-8 surrogate sequences are
// 3-byte / 1-unit and round-trip as raw bytes, like surrogatepass).
inline void unit_at(uint8_t b0, int& nb, int& nu) {
  if (b0 < 0x80) {
    nb = 1;
    nu = 1;
  } else if (b0 < 0xE0) {
    nb = 2;
    nu = 1;
  } else if (b0 < 0xF0) {
    nb = 3;
    nu = 1;
  } else {
    nb = 4;
    nu = 2;
  }
}

// Slice `length` UTF-16 units at unit-offset `off` from the UTF-8 bytes
// at wire[start..]; severed surrogate halves render as U+FFFD. Exact
// parity with decode_kernel.utf8_slice_u16. Returns false on overrun.
bool utf8_slice_u16(const uint8_t* wire, int64_t wire_len, int64_t start,
                    int64_t off, int64_t length, std::string& out) {
  static const char kFFFD[] = "\xEF\xBF\xBD";
  int64_t i = start;
  int64_t u = 0;
  int nb, nu;
  while (u < off) {
    if (i >= wire_len) return false;
    unit_at(wire[i], nb, nu);
    i += nb;
    u += nu;
  }
  int64_t need = length;
  if (u > off) {
    out.append(kFFFD, 3);
    need -= u - off;
  }
  int64_t s = i;
  while (need > 0) {
    if (i >= wire_len) return false;
    unit_at(wire[i], nb, nu);
    if (nu > need) {
      out.append(reinterpret_cast<const char*>(wire + s),
                 static_cast<size_t>(i - s));
      out.append(kFFFD, 3);
      return true;
    }
    i += nb;
    need -= nu;
  }
  if (i > wire_len) return false;
  out.append(reinterpret_cast<const char*>(wire + s),
             static_cast<size_t>(i - s));
  return true;
}

// varint reader over the wire buffer; returns false on overrun
bool read_var(const uint8_t* p, int64_t len, int64_t& pos, uint64_t& out) {
  out = 0;
  int shift = 0;
  while (pos < len) {
    uint8_t b = p[pos++];
    out |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) return true;
    shift += 7;
    if (shift > 63) return false;
  }
  return false;
}

constexpr int64_t kMaxSafeInt = (int64_t{1} << 53) - 1;  // F64_MAX_SAFE_INTEGER

// write_var_int — Writer.write_var_int parity (sign bit 0x40 in first byte)
void put_var_int(Buf& out, int64_t v) {
  bool neg = v < 0;
  uint64_t m = neg ? static_cast<uint64_t>(-v) : static_cast<uint64_t>(v);
  uint8_t first = static_cast<uint8_t>((m & 0x3F) | (neg ? 0x40 : 0));
  m >>= 6;
  if (m > 0) first |= 0x80;
  out.u8(first);
  while (m > 0) {
    uint8_t b = static_cast<uint8_t>(m & 0x7F);
    m >>= 7;
    if (m > 0) b |= 0x80;
    out.u8(b);
  }
}

// write_any's integer canonicalization: INTEGER inside the f64-safe range,
// BIGINT outside (lib0.py:301-307)
void put_canonical_int(Buf& out, int64_t v) {
  if (v >= -kMaxSafeInt && v <= kMaxSafeInt) {
    out.u8(125);
    put_var_int(out, v);
  } else {
    out.u8(122);
    for (int i = 7; i >= 0; i--)
      out.u8(static_cast<uint8_t>((static_cast<uint64_t>(v) >> (8 * i)) & 0xFF));
  }
}

// write_any's float canonicalization: integral-and-safe → INTEGER, exact
// f32 round-trip → FLOAT32, else FLOAT64 (lib0.py:308-321)
void put_canonical_float(Buf& out, double v) {
  if (std::isfinite(v) && std::trunc(v) == v &&
      v >= static_cast<double>(-kMaxSafeInt) &&
      v <= static_cast<double>(kMaxSafeInt)) {
    put_canonical_int(out, static_cast<int64_t>(v));
    return;
  }
  if (!std::isnan(v) && std::fabs(v) <= 3.4028234663852886e38 &&
      static_cast<double>(static_cast<float>(v)) == v) {
    out.u8(124);
    float f = static_cast<float>(v);
    uint32_t bits;
    std::memcpy(&bits, &f, 4);
    for (int i = 3; i >= 0; i--)
      out.u8(static_cast<uint8_t>((bits >> (8 * i)) & 0xFF));
    return;
  }
  out.u8(123);
  uint64_t bits;
  std::memcpy(&bits, &v, 8);
  for (int i = 7; i >= 0; i--)
    out.u8(static_cast<uint8_t>((bits >> (8 * i)) & 0xFF));
}

// Re-emit one wire Any value exactly as the Python finisher's
// read_any → write_any round trip would (which canonicalizes: non-minimal
// varints re-encode minimal, BIGINTs inside the safe range become
// INTEGERs, whole-number floats become INTEGERs, f32-exact doubles become
// FLOAT32s). Returns false (→ per-doc Python fallback) on malformed input
// or a map with duplicate keys (dict dedup changes the count).
bool reencode_any(const uint8_t* p, int64_t len, int64_t& pos, Buf& out,
                  int depth = 0) {
  // untrusted wire data: bound recursion so deeply nested arrays/maps
  // degrade to the Python fallback instead of smashing the C stack
  if (depth > 100) return false;
  if (pos >= len) return false;
  uint8_t tag = p[pos++];
  uint64_t n;
  switch (tag) {
    case 127:  // undefined
    case 126:  // null
    case 121:  // false
    case 120:  // true
      out.u8(tag);
      return true;
    case 125: {  // integer (signed varint)
      if (pos >= len) return false;
      uint8_t b = p[pos++];
      uint64_t m = b & 0x3F;
      const bool neg = (b & 0x40) != 0;
      int shift = 6;
      while (b & 0x80) {
        if (pos >= len || shift > 70) return false;
        b = p[pos++];
        m |= static_cast<uint64_t>(b & 0x7F) << shift;
        shift += 7;
      }
      if (m > static_cast<uint64_t>(INT64_MAX)) return false;
      put_canonical_int(out, neg ? -static_cast<int64_t>(m)
                                 : static_cast<int64_t>(m));
      return true;
    }
    case 124: {  // float32 (big-endian)
      if (pos + 4 > len) return false;
      uint32_t bits = 0;
      for (int i = 0; i < 4; i++) bits = (bits << 8) | p[pos++];
      float f;
      std::memcpy(&f, &bits, 4);
      put_canonical_float(out, static_cast<double>(f));
      return true;
    }
    case 123: {  // float64 (big-endian)
      if (pos + 8 > len) return false;
      uint64_t bits = 0;
      for (int i = 0; i < 8; i++) bits = (bits << 8) | p[pos++];
      double v;
      std::memcpy(&v, &bits, 8);
      put_canonical_float(out, v);
      return true;
    }
    case 122: {  // bigint (big-endian i64; read_any returns a plain int)
      if (pos + 8 > len) return false;
      uint64_t bits = 0;
      for (int i = 0; i < 8; i++) bits = (bits << 8) | p[pos++];
      put_canonical_int(out, static_cast<int64_t>(bits));
      return true;
    }
    case 119:    // string (UTF-8 round-trips byte-exact via surrogatepass)
    case 116: {  // buffer
      if (!read_var(p, len, pos, n)) return false;
      // n is an untrusted 64-bit varint: compare against the remaining
      // bytes unsigned, never via pos + (int64)n (which can wrap)
      if (n > static_cast<uint64_t>(len - pos)) return false;
      out.u8(tag);
      out.var(n);
      out.raw(p + pos, static_cast<size_t>(n));
      pos += static_cast<int64_t>(n);
      return true;
    }
    case 118: {  // map: count, then (string key, any value)*
      if (!read_var(p, len, pos, n)) return false;
      out.u8(tag);
      out.var(n);
      std::vector<std::pair<int64_t, int64_t>> seen;  // key spans
      for (uint64_t i = 0; i < n; i++) {
        uint64_t klen;
        if (!read_var(p, len, pos, klen)) return false;
        if (klen > static_cast<uint64_t>(len - pos)) return false;
        for (const auto& s : seen)
          if (s.second == static_cast<int64_t>(klen) &&
              std::memcmp(p + s.first, p + pos, klen) == 0)
            return false;  // duplicate key: dict dedup changes the count
        seen.emplace_back(pos, static_cast<int64_t>(klen));
        out.var(klen);
        out.raw(p + pos, static_cast<size_t>(klen));
        pos += static_cast<int64_t>(klen);
        if (!reencode_any(p, len, pos, out, depth + 1)) return false;
      }
      return true;
    }
    case 117: {  // array
      if (!read_var(p, len, pos, n)) return false;
      out.u8(tag);
      out.var(n);
      for (uint64_t i = 0; i < n; i++)
        if (!reencode_any(p, len, pos, out, depth + 1)) return false;
      return true;
    }
    default:
      return false;
  }
}

// skip one lib0 Any value (tags descend from 127; encoding/lib0.py
// read_any / reference any.rs:93-184)
bool skip_any(const uint8_t* p, int64_t len, int64_t& pos, int depth = 0) {
  if (depth > 100) return false;
  if (pos >= len) return false;
  uint8_t tag = p[pos++];
  uint64_t n;
  switch (tag) {
    case 127:  // undefined
    case 126:  // null
    case 121:  // false
    case 120:  // true
      return true;
    case 125: {  // integer (var_int: first byte 0x40 sign, 0x80 cont)
      if (pos >= len) return false;
      uint8_t b = p[pos++];
      while (b & 0x80) {
        if (pos >= len) return false;
        b = p[pos++];
      }
      return true;
    }
    case 124:  // float32
      pos += 4;
      return pos <= len;
    case 123:  // float64
    case 122:  // bigint
      pos += 8;
      return pos <= len;
    case 119:  // string
    case 116:  // buffer
      if (!read_var(p, len, pos, n)) return false;
      if (n > static_cast<uint64_t>(len - pos)) return false;
      pos += static_cast<int64_t>(n);
      return true;
    case 118: {  // map: count, then (string key, any value)*
      if (!read_var(p, len, pos, n)) return false;
      for (uint64_t i = 0; i < n; i++) {
        uint64_t klen;
        if (!read_var(p, len, pos, klen)) return false;
        if (klen > static_cast<uint64_t>(len - pos)) return false;
        pos += static_cast<int64_t>(klen);
        if (!skip_any(p, len, pos, depth + 1)) return false;
      }
      return true;
    }
    case 117: {  // array
      if (!read_var(p, len, pos, n)) return false;
      for (uint64_t i = 0; i < n; i++)
        if (!skip_any(p, len, pos, depth + 1)) return false;
      return true;
    }
    default:
      return false;
  }
}

struct FinishIn {
  int32_t n_docs_total;
  int32_t n_blocks_cap;
  const int32_t* client;
  const int32_t* clock;
  const int32_t* length;
  const int32_t* origin_client;
  const int32_t* origin_clock;
  const int32_t* ror_client;
  const int32_t* ror_clock;
  const int32_t* kind;
  const int32_t* content_ref;
  const int32_t* content_off;
  const int32_t* key;
  const int32_t* parent;
  const int32_t* ship;
  const int32_t* offsets;
  const int32_t* deleted;
  const int32_t* sel;
  int32_t n_sel;
  const int64_t* from_idx;
  int32_t n_interned;
  const uint8_t* key_blob;
  const int64_t* key_off;  // [n_keys + 1]
  int32_t n_keys;
  const uint8_t* root_name;
  int32_t root_name_len;
  const uint8_t* text_arena;
  int64_t text_arena_len;
  const int64_t* item_text_off;    // [n_items], -1 = not a string payload
  const int64_t* item_text_units;  // [n_items] payload size in UTF-16 units
  const uint8_t* blob_arena;
  int64_t blob_arena_len;
  const int64_t* item_blob_off;  // [n_items], -1 = no pre-encoded blob
  const int64_t* item_blob_len;
  const int64_t* item_elem_base;   // [n_items], -1 = not an Any payload
  const int64_t* item_elem_count;  // [n_items] element count
  const int64_t* elem_off;         // [n_elems + 1] spans into elem_arena
  const uint8_t* elem_arena;
  int64_t elem_arena_len;
  int64_t n_items;
  const uint8_t* wire;
  int64_t wire_len;
};

struct FinishOut {
  std::string data;
  std::vector<int64_t> span_off;
  std::vector<int64_t> span_len;
  std::vector<int32_t> status;
};

class DocEncoder {
 public:
  // The column pointers of `in` all point into ONE host copy of the
  // device's packed [D, 15, R] int32 tensor (the pointer of plane k is
  // arena + k*R); consecutive docs are doc_stride (= 15*R) int32s apart.
  DocEncoder(const FinishIn& in, int32_t doc, int64_t doc_stride)
      : in_(in), base_(static_cast<int64_t>(doc) * doc_stride) {}

  bool ship_at(int32_t r) const { return in_.ship[base_ + r] != 0; }

  bool deleted_at(int32_t r) const { return in_.deleted[base_ + r] != 0; }

  // returns false → caller must fall back to the Python finisher
  bool run(Buf& out) {
    const int32_t B = in_.n_blocks_cap;
    // group shipped rows by interned client
    std::vector<int32_t> rows;
    rows.reserve(64);
    for (int32_t r = 0; r < B; r++)
      if (ship_at(r)) rows.push_back(r);
    // client set, ordered by real id descending
    std::vector<int32_t> clients;
    for (int32_t r : rows) {
      int32_t c = in_.client[base_ + r];
      if (c < 0 || c >= in_.n_interned) return false;
      if (std::find(clients.begin(), clients.end(), c) == clients.end())
        clients.push_back(c);
    }
    std::sort(clients.begin(), clients.end(), [&](int32_t a, int32_t b) {
      return in_.from_idx[a] > in_.from_idx[b];
    });
    out.var(clients.size());
    for (int32_t c : clients) {
      std::vector<int32_t> slots;
      for (int32_t r : rows)
        if (in_.client[base_ + r] == c) slots.push_back(r);
      std::sort(slots.begin(), slots.end(), [&](int32_t a, int32_t b) {
        return in_.clock[base_ + a] < in_.clock[base_ + b];
      });
      out.var(slots.size());
      out.var(static_cast<uint64_t>(in_.from_idx[c]));
      int32_t first_off = in_.offsets[base_ + slots[0]];
      out.var(static_cast<uint64_t>(in_.clock[base_ + slots[0]] + first_off));
      for (size_t pos = 0; pos < slots.size(); pos++) {
        int32_t off = (pos == 0) ? first_off : 0;
        if (!encode_row(out, slots[pos], off)) return false;
      }
    }
    return encode_delete_set(out);
  }

 private:
  bool encode_row(Buf& out, int32_t r, int32_t off) {
    const int64_t i = base_ + r;
    const int32_t kind = in_.kind[i];
    if (kind == KIND_GC) {
      out.u8(KIND_GC);
      out.var(static_cast<uint64_t>(in_.length[i] - off));
      return true;
    }
    int32_t oc = in_.origin_client[i], ok = in_.origin_clock[i];
    int32_t rc = in_.ror_client[i], rk = in_.ror_clock[i];
    const int32_t clock = in_.clock[i];
    if (off > 0) {
      oc = in_.client[i];
      ok = clock + off - 1;
    }
    const bool has_o = oc >= 0, has_r = rc >= 0;
    const int32_t key = in_.key[i];
    const bool has_sub = key >= 0;
    out.u8(static_cast<uint8_t>(kind | (has_o ? 0x80 : 0) |
                                (has_r ? 0x40 : 0) | (has_sub ? 0x20 : 0)));
    if (has_o) {
      if (oc >= in_.n_interned) return false;
      out.var(static_cast<uint64_t>(in_.from_idx[oc]));
      out.var(static_cast<uint64_t>(ok));
    }
    if (has_r) {
      if (rc >= in_.n_interned) return false;
      out.var(static_cast<uint64_t>(in_.from_idx[rc]));
      out.var(static_cast<uint64_t>(rk));
    }
    if (!has_o && !has_r) {
      const int32_t parent_row = in_.parent[i];
      if (parent_row >= 0) {
        if (parent_row >= in_.n_blocks_cap) return false;
        const int64_t p = base_ + parent_row;
        if (in_.kind[p] == KIND_ROOT_ANCHOR) {
          // non-primary named root: emit the root-name form with the
          // anchor's interned key name
          const int32_t rkey = in_.key[p];
          if (rkey < 0 || rkey >= in_.n_keys) return false;
          const int64_t ks = in_.key_off[rkey], ke = in_.key_off[rkey + 1];
          out.var(1);
          out.str(in_.key_blob + ks, static_cast<size_t>(ke - ks));
        } else {
          const int32_t pc = in_.client[p];
          if (pc < 0 || pc >= in_.n_interned) return false;
          out.var(0);  // parent_info: nested (not a root name)
          out.var(static_cast<uint64_t>(in_.from_idx[pc]));
          out.var(static_cast<uint64_t>(in_.clock[p]));
        }
      } else {
        out.var(1);  // parent_info: root name
        out.str(in_.root_name, static_cast<size_t>(in_.root_name_len));
      }
      if (has_sub) {
        if (key >= in_.n_keys) return false;
        const int64_t ks = in_.key_off[key], ke = in_.key_off[key + 1];
        out.str(in_.key_blob + ks, static_cast<size_t>(ke - ks));
      }
    }
    const int32_t ref = in_.content_ref[i];
    const int64_t c_off = static_cast<int64_t>(in_.content_off[i]) + off;
    const int64_t length = in_.length[i] - off;
    return encode_content(out, kind, ref, c_off, length);
  }

  bool encode_content(Buf& out, int32_t kind, int32_t ref, int64_t c_off,
                      int64_t length) {
    if (kind == KIND_DELETED) {
      out.var(static_cast<uint64_t>(length));
      return true;
    }
    if (ref >= 0) return encode_host_content(out, kind, ref, c_off, length);
    if (ref <= -2) {
      const int64_t w = -(static_cast<int64_t>(ref) + 2);
      return encode_wire_content(out, kind, w, c_off, length);
    }
    return false;  // ref == -1 with payload-bearing kind
  }

  bool encode_host_content(Buf& out, int32_t kind, int32_t ref, int64_t c_off,
                           int64_t length) {
    if (ref >= in_.n_items) return false;
    if (kind == KIND_STRING) {
      const int64_t toff = in_.item_text_off[ref];
      if (toff < 0 || c_off < 0 || length < 0) return false;
      // slice must stay inside this item's payload AND the arena
      // (inconsistent content_off/length columns → Python fallback, which
      // slices safely, instead of an out-of-bounds native read)
      if (c_off + length > in_.item_text_units[ref]) return false;
      if (toff + 2 * (c_off + length) > in_.text_arena_len) return false;
      scratch_.clear();
      utf16le_to_utf8(in_.text_arena + toff + 2 * c_off,
                      static_cast<size_t>(length), scratch_);
      out.str(reinterpret_cast<const uint8_t*>(scratch_.data()),
              scratch_.size());
      return true;
    }
    if (kind == KIND_ANY) {
      const int64_t eb = in_.item_elem_base[ref];
      if (eb < 0 || c_off < 0 || length < 0) return false;
      if (c_off + length > in_.item_elem_count[ref]) return false;
      out.var(static_cast<uint64_t>(length));
      const int64_t s = in_.elem_off[eb + c_off];
      const int64_t e = in_.elem_off[eb + c_off + length];
      if (s < 0 || e < s || e > in_.elem_arena_len) return false;
      out.raw(in_.elem_arena + s, static_cast<size_t>(e - s));
      return true;
    }
    // every other host payload pre-encodes its full content bytes
    // (ContentFormat/Embed/Binary/Json/Type/Doc/Move .encode — the Python
    // finisher's else-branch, batch_doc.py _encode_device_row)
    const int64_t boff = in_.item_blob_off[ref];
    const int64_t blen = in_.item_blob_len[ref];
    if (boff < 0 || blen < 0 || boff + blen > in_.blob_arena_len) return false;
    out.raw(in_.blob_arena + boff, static_cast<size_t>(blen));
    return true;
  }

  bool encode_wire_content(Buf& out, int32_t kind, int64_t w, int64_t c_off,
                           int64_t length) {
    const uint8_t* p = in_.wire;
    const int64_t L = in_.wire_len;
    if (w < 0 || w >= L) return false;
    if (kind == KIND_STRING) {
      scratch_.clear();
      if (!utf8_slice_u16(p, L, w, c_off, length, scratch_)) return false;
      out.str(reinterpret_cast<const uint8_t*>(scratch_.data()),
              scratch_.size());
      return true;
    }
    if (kind == KIND_ANY) {
      int64_t pos = w;
      uint64_t n;
      if (!read_var(p, L, pos, n)) return false;
      const int64_t avail =
          (n > static_cast<uint64_t>(INT64_MAX))
              ? c_off + length
              : std::min<int64_t>(static_cast<int64_t>(n), c_off + length);
      for (int64_t k = 0; k < c_off && k < avail; k++)
        if (!skip_any(p, L, pos)) return false;
      // Python emits write_len(length) then re-encodes each value through
      // read_any → write_any; reencode_any reproduces that canonicalization
      out.var(static_cast<uint64_t>(length));
      for (int64_t k = c_off; k < avail; k++)
        if (!reencode_any(p, L, pos, out)) return false;
      return true;
    }
    if (kind == KIND_JSON) {
      int64_t pos = w;
      uint64_t n;
      if (!read_var(p, L, pos, n)) return false;
      const int64_t avail =
          (n > static_cast<uint64_t>(INT64_MAX))
              ? c_off + length
              : std::min<int64_t>(static_cast<int64_t>(n), c_off + length);
      for (int64_t k = 0; k < c_off && k < avail; k++) {
        uint64_t slen;
        if (!read_var(p, L, pos, slen)) return false;
        if (slen > static_cast<uint64_t>(L - pos)) return false;
        pos += static_cast<int64_t>(slen);
      }
      const int64_t s = pos;
      int64_t count = 0;
      for (int64_t k = c_off; k < avail; k++) {
        uint64_t slen;
        if (!read_var(p, L, pos, slen)) return false;
        if (slen > static_cast<uint64_t>(L - pos)) return false;
        pos += static_cast<int64_t>(slen);
        count++;
      }
      out.var(static_cast<uint64_t>(count));
      out.raw(p + s, static_cast<size_t>(pos - s));
      return true;
    }
    if (kind == KIND_BINARY) {
      // read_buf → write_buf round-trips bytes exactly: copy the span
      int64_t pos = w;
      uint64_t n;
      if (!read_var(p, L, pos, n)) return false;
      if (n > static_cast<uint64_t>(L - pos)) return false;
      pos += static_cast<int64_t>(n);
      out.raw(p + w, static_cast<size_t>(pos - w));
      return true;
    }
    if (kind == KIND_TYPE) {
      // device-retained ContentType span: verbatim copy of the TypeRef
      // tag byte (+ XmlElement/XmlHook name buf) — no re-serialization
      int64_t pos = w;
      if (pos >= L) return false;
      const uint8_t tag = p[pos++];
      if (tag == 3 || tag == 5) {
        uint64_t n;
        if (!read_var(p, L, pos, n)) return false;
        if (n > static_cast<uint64_t>(L - pos)) return false;
        pos += static_cast<int64_t>(n);
      }
      out.raw(p + w, static_cast<size_t>(pos - w));
      return true;
    }
    // wire Format/Embed refs re-serialize JSON through Python (json value
    // round-trip — not byte-stable from C++); other kinds are out of the
    // device decoder's raw-wire scope anyway. Fall back.
    return false;
  }

  bool encode_delete_set(Buf& out) {
    const int32_t B = in_.n_blocks_cap;
    // collect (real_client, start, end), squash per client, clients desc
    struct Entry {
      int64_t client;
      std::vector<std::pair<int64_t, int64_t>> ranges;
    };
    std::vector<Entry> entries;
    for (int32_t r = 0; r < B; r++) {
      if (!deleted_at(r)) continue;
      const int32_t c = in_.client[base_ + r];
      if (c < 0 || c >= in_.n_interned) return false;
      const int64_t real = in_.from_idx[c];
      const int64_t s = in_.clock[base_ + r];
      const int64_t e = s + in_.length[base_ + r];
      if (e <= s) continue;
      auto it = std::find_if(entries.begin(), entries.end(),
                             [&](const Entry& x) { return x.client == real; });
      if (it == entries.end()) {
        entries.push_back({real, {{s, e}}});
      } else {
        it->ranges.emplace_back(s, e);
      }
    }
    for (auto& e : entries) {
      std::sort(e.ranges.begin(), e.ranges.end());
      std::vector<std::pair<int64_t, int64_t>> sq;
      for (auto& r : e.ranges) {
        if (!sq.empty() && r.first <= sq.back().second) {
          if (r.second > sq.back().second) sq.back().second = r.second;
        } else {
          sq.push_back(r);
        }
      }
      e.ranges.swap(sq);
    }
    std::sort(entries.begin(), entries.end(),
              [](const Entry& a, const Entry& b) { return a.client > b.client; });
    out.var(entries.size());
    for (const auto& e : entries) {
      out.var(static_cast<uint64_t>(e.client));
      out.var(e.ranges.size());
      for (const auto& r : e.ranges) {
        out.var(static_cast<uint64_t>(r.first));
        out.var(static_cast<uint64_t>(r.second - r.first));
      }
    }
    return true;
  }

  const FinishIn& in_;
  const int64_t base_;
  std::string scratch_;
};

// One worker's output: spans are relative to this shard's `data` and get
// rebased during the merge.
struct Shard {
  std::string data;
  std::vector<int64_t> off;
  std::vector<int64_t> len;
  std::vector<int32_t> status;
};

void encode_range(const FinishIn& in, int64_t doc_stride, int32_t lo,
                  int32_t hi, Shard& sh) {
  const int32_t n = hi - lo;
  sh.off.assign(n, 0);
  sh.len.assign(n, 0);
  sh.status.assign(n, STATUS_FALLBACK);
  Buf buf;
  for (int32_t i = lo; i < hi; i++) {
    const int32_t doc = in.sel[i];
    const size_t start = buf.b.size();
    DocEncoder enc(in, doc, doc_stride);
    if (doc < 0 || doc >= in.n_docs_total || !enc.run(buf)) {
      buf.b.resize(start);  // drop partial output
      continue;
    }
    sh.status[i - lo] = STATUS_OK;
    sh.off[i - lo] = static_cast<int64_t>(start);
    sh.len[i - lo] = static_cast<int64_t>(buf.b.size() - start);
  }
  sh.data.swap(buf.b);
}

}  // namespace

extern "C" {

// layout guard: the Python ctypes mirror asserts this equals
// ctypes.sizeof(FinishIn) before binding (catches field drift between
// the two hand-maintained struct definitions)
int64_t ytpu_finish_in_sizeof() { return static_cast<int64_t>(sizeof(FinishIn)); }

// Docs encode independently (FinishIn is read-only; each DocEncoder owns
// its scratch), so the batch splits into contiguous chunks of `sel`, one
// per worker. n_threads <= 0 means hardware concurrency — the Python
// caller decides whether a pool is worth spawning (it thresholds on
// TOTAL selected rows, not doc count, so a few huge docs still fan out);
// this side only caps workers at one doc per chunk. Called with the GIL
// released (ctypes drops it around foreign calls).
void* finish_batch_impl(const FinishIn* in, int64_t doc_stride,
                        int32_t n_threads) {
  auto* out = new FinishOut();
  const int32_t n = in->n_sel;
  out->span_off.resize(n);
  out->span_len.resize(n);
  out->status.resize(n);
  if (n == 0) return out;
  int32_t hw = static_cast<int32_t>(std::thread::hardware_concurrency());
  if (hw <= 0) hw = 1;
  // one doc per chunk at minimum granularity; the max() keeps a direct
  // ABI caller with a degenerate n_sel from ever sizing zero shards
  int32_t t = n_threads <= 0 ? hw : std::min(n_threads, hw);
  t = std::max(int32_t{1}, std::min(t, n));
  std::vector<Shard> shards(t);
  if (t <= 1) {
    encode_range(*in, doc_stride, 0, n, shards[0]);
  } else {
    std::vector<std::thread> pool;
    pool.reserve(t);
    for (int32_t k = 0; k < t; k++) {
      const int32_t lo = static_cast<int32_t>(static_cast<int64_t>(n) * k / t);
      const int32_t hi =
          static_cast<int32_t>(static_cast<int64_t>(n) * (k + 1) / t);
      pool.emplace_back(encode_range, std::cref(*in), doc_stride, lo, hi,
                        std::ref(shards[k]));
    }
    for (auto& th : pool) th.join();
  }
  size_t total = 0;
  for (const auto& sh : shards) total += sh.data.size();
  out->data.reserve(total);
  int32_t i = 0;
  for (const auto& sh : shards) {
    const int64_t base = static_cast<int64_t>(out->data.size());
    out->data.append(sh.data);
    for (size_t j = 0; j < sh.status.size(); j++, i++) {
      out->status[i] = sh.status[j];
      out->span_off[i] = sh.status[j] == STATUS_OK ? base + sh.off[j] : 0;
      out->span_len[i] = sh.len[j];
    }
  }
  return out;
}

// The packed-arena entry: the column pointers in `in` point into one
// contiguous host copy of the device's packed [D, 15, R] int32 tensor
// (plane k's pointer = arena + k*R) and consecutive docs sit `doc_stride`
// (= 15*R) int32s apart, so no plane is copied.
void* ytpu_finish_batch_strided(const FinishIn* in, int64_t doc_stride,
                                int32_t n_threads) {
  return finish_batch_impl(in, doc_stride, n_threads);
}

const uint8_t* ytpu_finish_data(void* h) {
  return reinterpret_cast<const uint8_t*>(
      static_cast<FinishOut*>(h)->data.data());
}

int64_t ytpu_finish_total_len(void* h) {
  return static_cast<int64_t>(static_cast<FinishOut*>(h)->data.size());
}

// One call fills the caller's offset/length/status tables for the whole
// batch.
void ytpu_finish_spans(void* h, int64_t* off, int64_t* len, int32_t* status) {
  auto* o = static_cast<FinishOut*>(h);
  const size_t n = o->status.size();
  std::memcpy(off, o->span_off.data(), n * sizeof(int64_t));
  std::memcpy(len, o->span_len.data(), n * sizeof(int64_t));
  std::memcpy(status, o->status.data(), n * sizeof(int32_t));
}

void ytpu_finish_free(void* h) { delete static_cast<FinishOut*>(h); }

}  // extern "C"
