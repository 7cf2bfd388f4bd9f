"""lib0 v1 encoding: the cursor and the writer of `ytpu.encoding.lib0`
(with `write_any`, which the diff finisher needs, and `read_any` /
`any_from_json`, which the wire payload readers need) plus a small update
walker.

`update_columns` walks one v1 update into the columns of the port's host
C++ walk (`ytpu_torch/native/lib0_codec.cpp`, a copy of the JAX package's
native decoder), whose plain version it is: per block its
client, clock, length, kind, origins, how it names its parent (root name
span, parent id, parent_sub span) and content span; per delete range its
client, start and end; and the wire-section counts the device decoder's
step budget and the ingest fast lane read (`n_client_sections`,
`n_dels`, `n_ds_sections`, `n_zero_len_blocks`, `n_value_steps`,
`n_complex_any`). It follows the grammar of update.rs:433-488 and
block.rs:1786-1835: zero-length item blocks are dropped from the columns
but counted, Skip and GC carriers stay in them.
"""

from __future__ import annotations

import json
import math
import struct
from typing import Any as PyAny
from typing import List

import numpy as np

from ytpu_torch.core.content import (
    BLOCK_GC,
    BLOCK_SKIP,
    CONTENT_ANY,
    CONTENT_BINARY,
    CONTENT_DELETED,
    CONTENT_DOC,
    CONTENT_EMBED,
    CONTENT_FORMAT,
    CONTENT_JSON,
    CONTENT_MOVE,
    CONTENT_STRING,
    CONTENT_TYPE,
)

__all__ = [
    "BigInt",
    "Cursor",
    "EncodingError",
    "Undefined",
    "BLOCK_COLUMNS",
    "DEL_COLUMNS",
    "UpdateColumns",
    "Writer",
    "any_from_json",
    "any_to_json",
    "read_any",
    "update_columns",
    "utf16_units",
    "write_any",
]

HAS_ORIGIN = 0x80
HAS_RIGHT_ORIGIN = 0x40
HAS_PARENT_SUB = 0x20
TYPE_XML_ELEMENT = 3
TYPE_XML_HOOK = 5
TYPE_WEAK = 7


F64_MAX_SAFE_INTEGER = 2**53 - 1
F64_MIN_SAFE_INTEGER = -F64_MAX_SAFE_INTEGER


class EncodingError(Exception):
    """Malformed lib0 input (truncated buffer, bad varint, bad tag)."""


class _UndefinedType:
    """JS `undefined` sentinel (distinct from None, which maps to JS null)."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:
        return "Undefined"

    def __bool__(self) -> bool:
        return False


Undefined = _UndefinedType()


class BigInt(int):
    """Marker for values that must encode with the BigInt tag (122)."""


class Cursor:
    """Read cursor over an immutable byte buffer."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def has_content(self) -> bool:
        return self.pos < len(self.buf)

    def read_u8(self) -> int:
        if self.pos >= len(self.buf):
            raise EncodingError("end of buffer")
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def read_exact(self, n: int) -> bytes:
        end = self.pos + n
        if n < 0 or end > len(self.buf):
            raise EncodingError("end of buffer")
        out = self.buf[self.pos : end]
        self.pos = end
        return out

    def skip(self, n: int) -> None:
        self.read_exact(n)

    def read_var_uint(self) -> int:
        num = 0
        shift = 0
        while True:
            b = self.read_u8()
            num |= (b & 0x7F) << shift
            shift += 7
            if b < 0x80:
                return num
            if shift >= 70:
                raise EncodingError("varint too long")

    def read_var_int(self) -> int:
        """Signed varint: 6 payload bits + sign in the first byte."""
        b = self.read_u8()
        num = b & 0x3F
        negative = (b & 0x40) != 0
        shift = 6
        while b & 0x80:
            b = self.read_u8()
            num |= (b & 0x7F) << shift
            shift += 7
        return -num if negative else num

    def read_buf(self) -> bytes:
        return self.read_exact(self.read_var_uint())

    def read_string(self) -> str:
        return self.read_buf().decode("utf-8")

    def read_f32(self) -> float:
        return struct.unpack(">f", self.read_exact(4))[0]

    def read_f64(self) -> float:
        return struct.unpack(">d", self.read_exact(8))[0]

    def read_i64(self) -> int:
        return struct.unpack(">q", self.read_exact(8))[0]

    def skip_any(self) -> None:
        """Skip one lib0 Any value (any.rs:37-83)."""
        tag = self.read_u8()
        if tag in (127, 126, 121, 120):
            return
        if tag == 125:
            self.read_var_int()
        elif tag == 124:
            self.skip(4)
        elif tag in (123, 122):
            self.skip(8)
        elif tag in (119, 116):
            self.skip(self.read_var_uint())
        elif tag == 118:
            for _ in range(self.read_var_uint()):
                self.skip(self.read_var_uint())
                self.skip_any()
        elif tag == 117:
            for _ in range(self.read_var_uint()):
                self.skip_any()
        else:
            raise EncodingError(f"unknown Any tag {tag}")


class Writer:
    """Append-only byte writer."""

    __slots__ = ("buf",)

    def __init__(self):
        self.buf = bytearray()

    def to_bytes(self) -> bytes:
        return bytes(self.buf)

    def __len__(self) -> int:
        return len(self.buf)

    def write_u8(self, value: int) -> None:
        self.buf.append(value & 0xFF)

    def write_raw(self, data: bytes) -> None:
        self.buf.extend(data)

    def write_var_uint(self, value: int) -> None:
        if value < 0:
            raise ValueError(f"negative value for var_uint: {value}")
        while value >= 0x80:
            self.buf.append(0x80 | (value & 0x7F))
            value >>= 7
        self.buf.append(value)

    def write_var_int(self, value: int, force_negative: bool = False) -> None:
        negative = value < 0 or force_negative
        if value < 0:
            value = -value
        first = (0x3F & value) | (0x40 if negative else 0)
        value >>= 6
        if value > 0:
            first |= 0x80
        self.buf.append(first)
        while value > 0:
            b = value & 0x7F
            value >>= 7
            if value > 0:
                b |= 0x80
            self.buf.append(b)

    def write_buf(self, data: bytes) -> None:
        self.write_var_uint(len(data))
        self.buf.extend(data)

    def write_string(self, s: str) -> None:
        self.write_buf(s.encode("utf-8", errors="surrogatepass"))

    def write_f32(self, value: float) -> None:
        self.buf.extend(struct.pack(">f", value))

    def write_f64(self, value: float) -> None:
        self.buf.extend(struct.pack(">d", value))

    def write_i64(self, value: int) -> None:
        self.buf.extend(struct.pack(">q", value))


# Any type tags descend from 127 (any.rs:93-116)
_TAG_UNDEFINED, _TAG_NULL, _TAG_INTEGER, _TAG_FLOAT32, _TAG_FLOAT64 = 127, 126, 125, 124, 123
_TAG_BIGINT, _TAG_FALSE, _TAG_TRUE, _TAG_STRING, _TAG_MAP = 122, 121, 120, 119, 118
_TAG_ARRAY, _TAG_BUFFER = 117, 116


def write_any(w: Writer, value: PyAny) -> None:
    """One lib0 Any value (any.rs:37-183)."""
    if value is Undefined:
        w.write_u8(_TAG_UNDEFINED)
    elif value is None:
        w.write_u8(_TAG_NULL)
    elif value is True:
        w.write_u8(_TAG_TRUE)
    elif value is False:
        w.write_u8(_TAG_FALSE)
    elif isinstance(value, str):
        w.write_u8(_TAG_STRING)
        w.write_string(value)
    elif isinstance(value, BigInt):
        w.write_u8(_TAG_BIGINT)
        w.write_i64(value)
    elif isinstance(value, int):
        if F64_MIN_SAFE_INTEGER <= value <= F64_MAX_SAFE_INTEGER:
            w.write_u8(_TAG_INTEGER)
            w.write_var_int(value)
        else:
            w.write_u8(_TAG_BIGINT)
            w.write_i64(value)
    elif isinstance(value, float):
        if value.is_integer() and F64_MIN_SAFE_INTEGER <= value <= F64_MAX_SAFE_INTEGER:
            w.write_u8(_TAG_INTEGER)
            w.write_var_int(int(value))
        elif (
            not math.isnan(value)
            and abs(value) <= 3.4028234663852886e38
            and struct.unpack(">f", struct.pack(">f", value))[0] == value
        ):
            w.write_u8(_TAG_FLOAT32)
            w.write_f32(value)
        else:
            w.write_u8(_TAG_FLOAT64)
            w.write_f64(value)
    elif isinstance(value, (bytes, bytearray, memoryview)):
        w.write_u8(_TAG_BUFFER)
        w.write_buf(bytes(value))
    elif isinstance(value, dict):
        w.write_u8(_TAG_MAP)
        w.write_var_uint(len(value))
        for key, item in value.items():
            w.write_string(str(key))
            write_any(w, item)
    elif isinstance(value, (list, tuple)):
        w.write_u8(_TAG_ARRAY)
        w.write_var_uint(len(value))
        for item in value:
            write_any(w, item)
    else:
        raise TypeError(f"cannot encode {type(value)!r} as Any")


def read_any(cur: Cursor) -> PyAny:
    """One lib0 Any value (any.rs:93-116)."""
    tag = cur.read_u8()
    if tag == _TAG_UNDEFINED:
        return Undefined
    if tag == _TAG_NULL:
        return None
    if tag == _TAG_INTEGER:
        return cur.read_var_int()
    if tag == _TAG_FLOAT32:
        return cur.read_f32()
    if tag == _TAG_FLOAT64:
        return cur.read_f64()
    if tag == _TAG_BIGINT:
        return cur.read_i64()
    if tag == _TAG_FALSE:
        return False
    if tag == _TAG_TRUE:
        return True
    if tag == _TAG_STRING:
        return cur.read_string()
    if tag == _TAG_MAP:
        out = {}
        for _ in range(cur.read_var_uint()):
            key = cur.read_string()
            out[key] = read_any(cur)
        return out
    if tag == _TAG_ARRAY:
        return [read_any(cur) for _ in range(cur.read_var_uint())]
    if tag == _TAG_BUFFER:
        return cur.read_buf()
    raise EncodingError(f"unexpected Any tag {tag}")


def any_to_json(value: PyAny) -> str:
    """JSON string form of the v1 codec's Embed / Format payloads."""
    if value is Undefined:
        return "undefined"
    return json.dumps(value, separators=(",", ":"), ensure_ascii=False)


def any_from_json(src: str) -> PyAny:
    """The inverse of `any_to_json`."""
    if src == "undefined" or src == "":
        return Undefined
    return json.loads(src)


def utf16_units(data: bytes) -> int:
    """UTF-16 code units of a UTF-8 byte span (the Yjs clock unit)."""
    units = 0
    i = 0
    n = len(data)
    while i < n:
        b = data[i]
        if b < 0x80:
            units += 1
            i += 1
        elif (b >> 5) == 0x6:
            units += 1
            i += 2
        elif (b >> 4) == 0xE:
            units += 1
            i += 3
        elif (b >> 3) == 0x1E:
            units += 2
            i += 4
        else:
            i += 1
    return units


# the per-block columns of `UpdateColumns` (the native column set of
# ytpu's lib0_codec.cpp, in its order) and its delete-range columns
BLOCK_COLUMNS = (
    "client",
    "clock",
    "length",
    "kind",
    "origin_client",
    "origin_clock",
    "ror_client",
    "ror_clock",
    "parent_kind",
    "parent_name_start",
    "parent_name_len",
    "parent_id_client",
    "parent_id_clock",
    "parent_sub_start",
    "parent_sub_len",
    "content_start",
    "content_len_bytes",
)
DEL_COLUMNS = ("del_client", "del_start", "del_end")
# parent_kind: how an item names its parent on the wire
PARENT_NONE, PARENT_NAME, PARENT_ID, PARENT_INHERIT = 0, 1, 2, 3


class UpdateColumns:
    """Per-block columns of one walked update (numpy int64 arrays, one
    entry per block in `BLOCK_COLUMNS`, one per delete range in
    `DEL_COLUMNS`) plus its wire-section counts. Absent origins and parent
    fields read -1; spans (``*_start`` / ``*_len``) index the original
    payload."""

    def __init__(self, payload: bytes):
        self.payload = payload
        self.error = False
        self.n_client_sections = 0
        self.n_ds_sections = 0
        self.n_zero_len_blocks = 0
        self.n_value_steps = 0
        self.n_complex_any = 0
        self.n_dels = 0
        self.n_blocks = 0
        for name in BLOCK_COLUMNS + DEL_COLUMNS:
            setattr(self, name, np.empty(0, dtype=np.int64))

    def span(self, start: int, length: int) -> bytes:
        return self.payload[start : start + length]

    def content_bytes(self, i: int) -> bytes:
        return self.span(int(self.content_start[i]), int(self.content_len_bytes[i]))

    def parent_name(self, i: int) -> str:
        return self.span(int(self.parent_name_start[i]), int(self.parent_name_len[i])).decode("utf-8")

    def parent_sub(self, i: int):
        s = int(self.parent_sub_start[i])
        if s < 0:
            return None
        return self.span(s, int(self.parent_sub_len[i])).decode("utf-8")


def _skip_any_tokens(cur: Cursor, out: UpdateColumns) -> None:
    """Skip one Any value of a ContentAny, counting the device decode
    steps it costs (one per scalar or array header; a depth-1 object a
    header step plus a key and a value step per pair) into
    ``out.n_value_steps`` and the values the device cannot parse (an
    object's non-scalar values, unknown tags) into ``out.n_complex_any``."""
    if cur.pos < len(cur.buf):
        tag = cur.buf[cur.pos]
        if tag < 116:
            out.n_complex_any += 1
        elif tag == 118:
            cur.pos += 1
            out.n_value_steps += 1
            for _ in range(cur.read_var_uint()):
                cur.skip(cur.read_var_uint())
                out.n_value_steps += 1
                if cur.pos < len(cur.buf):
                    vt = cur.buf[cur.pos]
                    if vt in (117, 118) or vt < 116:
                        out.n_complex_any += 1
                out.n_value_steps += 1
                cur.skip_any()
            return
        elif tag == 117:
            cur.pos += 1
            out.n_value_steps += 1
            for _ in range(cur.read_var_uint()):
                _skip_any_tokens(cur, out)
            return
    out.n_value_steps += 1
    cur.skip_any()


def _read_content(cur: Cursor, info: int, out: UpdateColumns) -> int:
    """Skip one content payload; returns its CRDT length (clock units)."""
    ref = info & 0x0F
    if ref == CONTENT_DELETED:
        return cur.read_var_uint()
    if ref == CONTENT_JSON:
        n = cur.read_var_uint()
        for _ in range(n):
            cur.skip(cur.read_var_uint())
        out.n_value_steps += n
        return n
    if ref in (CONTENT_BINARY, CONTENT_EMBED):
        cur.skip(cur.read_var_uint())
        return 1
    if ref == CONTENT_STRING:
        return utf16_units(cur.read_exact(cur.read_var_uint()))
    if ref == CONTENT_FORMAT:
        cur.skip(cur.read_var_uint())
        cur.skip(cur.read_var_uint())
        out.n_value_steps += 1
        return 1
    if ref == CONTENT_TYPE:
        tag = cur.read_u8()
        if tag in (TYPE_XML_ELEMENT, TYPE_XML_HOOK):
            cur.skip(cur.read_var_uint())
        elif tag == TYPE_WEAK:
            flags = cur.read_u8()
            cur.read_var_uint()
            cur.read_var_uint()
            if flags & 1:
                cur.read_var_uint()
                cur.read_var_uint()
        return 1
    if ref == CONTENT_ANY:
        n = cur.read_var_uint()
        for _ in range(n):
            _skip_any_tokens(cur, out)
        return n
    if ref == CONTENT_DOC:
        cur.skip(cur.read_var_uint())
        cur.skip_any()
        return 1
    if ref == CONTENT_MOVE:
        flags = cur.read_var_uint()
        cur.read_var_uint()
        cur.read_var_uint()
        if not flags & 1:
            cur.read_var_uint()
            cur.read_var_uint()
        return 1
    raise EncodingError(f"unknown content ref {ref}")


_U64 = (1 << 64) - 1


def _i64(v: int) -> int:
    """A varint's value as the int64 the native walker stores (its low 64
    bits, two's complement)."""
    v &= _U64
    return v - (1 << 64) if v >= 1 << 63 else v


def update_columns(payload: bytes) -> UpdateColumns:
    """Walk one v1 update into `UpdateColumns` (``error`` set on malformed
    input; the columns then hold what was read before the fault, the
    native walk's also the block it failed in). The plain version of the
    port's native walk (`ytpu_torch.native.decode_update_columns`): the
    same columns and counts."""
    out = UpdateColumns(payload)
    cur = Cursor(payload)
    blocks: List[tuple] = []  # one tuple per block, in BLOCK_COLUMNS order
    del_rows: List[tuple] = []
    try:
        n_clients = cur.read_var_uint()
        out.n_client_sections = n_clients
        for _ in range(n_clients):
            n_blocks = cur.read_var_uint()
            client = _i64(cur.read_var_uint())
            clock = cur.read_var_uint()
            for _ in range(n_blocks):
                info = cur.read_u8()
                if info in (BLOCK_SKIP, BLOCK_GC):
                    n = cur.read_var_uint()
                    blocks.append((client, _i64(clock), _i64(n), info, -1, -1, -1, -1, PARENT_NONE,
                                   -1, -1, -1, -1, -1, -1, -1, 0))
                    clock += n
                    continue
                oc = ok = rc = rk = -1
                if info & HAS_ORIGIN:
                    oc, ok = _i64(cur.read_var_uint()), _i64(cur.read_var_uint())
                if info & HAS_RIGHT_ORIGIN:
                    rc, rk = _i64(cur.read_var_uint()), _i64(cur.read_var_uint())
                pk, pns, pnl, pic, pik, pss, psl = PARENT_INHERIT, -1, -1, -1, -1, -1, -1
                if (info & (HAS_ORIGIN | HAS_RIGHT_ORIGIN)) == 0:
                    if cur.read_var_uint() == 1:
                        pk, pnl = PARENT_NAME, cur.read_var_uint()
                        pns = cur.pos
                        cur.skip(pnl)
                    else:
                        pk = PARENT_ID
                        pic, pik = _i64(cur.read_var_uint()), _i64(cur.read_var_uint())
                    if info & HAS_PARENT_SUB:
                        psl = cur.read_var_uint()
                        pss = cur.pos
                        cur.skip(psl)
                start = cur.pos
                n = _read_content(cur, info, out)
                if n == 0:
                    # historical empty blocks have no effect (update.rs:737-742)
                    out.n_zero_len_blocks += 1
                    continue
                blocks.append((client, _i64(clock), _i64(n), info & 0x0F, oc, ok, rc, rk, pk,
                               pns, pnl, pic, pik, pss, psl, start, cur.pos - start))
                clock += n
        n_ds = cur.read_var_uint()
        out.n_ds_sections = n_ds
        for _ in range(n_ds):
            client = _i64(cur.read_var_uint())
            for _ in range(cur.read_var_uint()):
                start = cur.read_var_uint()
                del_rows.append((client, _i64(start), _i64(start + cur.read_var_uint())))
    except EncodingError:
        out.error = True
    out.n_blocks = len(blocks)
    out.n_dels = len(del_rows)
    cols = np.asarray(blocks, dtype=np.int64).reshape(-1, len(BLOCK_COLUMNS))
    for j, name in enumerate(BLOCK_COLUMNS):
        setattr(out, name, np.ascontiguousarray(cols[:, j]))
    dcols = np.asarray(del_rows, dtype=np.int64).reshape(-1, len(DEL_COLUMNS))
    for j, name in enumerate(DEL_COLUMNS):
        setattr(out, name, np.ascontiguousarray(dcols[:, j]))
    return out
