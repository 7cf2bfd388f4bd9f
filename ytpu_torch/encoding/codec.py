"""The update codecs (PyTorch port of `ytpu.encoding.codec`): v1's
`EncoderV1`, the writer half the diff finisher calls, and `DecoderV1`,
the reader half host-lane decode calls (parity target: yrs
updates/encoder.rs:80-180, updates/decoder.rs:76-190), and v2's columnar
`EncoderV2` / `DecoderV2` with their column compressors (encoder.rs:182-528,
decoder.rs:195-505).

The v2 format is struct-of-arrays on the wire: nine RLE-compressed
columns (key clocks, clients, left and right clocks, info bytes, strings,
parent info, type refs, lengths) behind a feature-flag byte, then a
`rest` stream with the structural varints, the delete set and the
content the columns do not carry. Both codecs serve the same channel
interface, so `Update`, `DeleteSet` and the content classes encode and
decode through either."""

from __future__ import annotations

from typing import Any as PyAny
from typing import List, Optional, Tuple

from ytpu_torch.core.content import utf16_len
from ytpu_torch.encoding.lib0 import Cursor, Writer, any_from_json, any_to_json, read_any, write_any

__all__ = ["DecoderV1", "DecoderV2", "EncoderV1", "EncoderV2"]


class EncoderV1:
    """Plain varint streams: every channel writes to one `Writer`."""

    __slots__ = ("w",)

    def __init__(self):
        self.w = Writer()

    def to_bytes(self) -> bytes:
        return self.w.to_bytes()

    def write_u8(self, v: int) -> None:
        self.w.write_u8(v)

    def write_var(self, v: int) -> None:
        self.w.write_var_uint(v)

    def write_buf(self, data: bytes) -> None:
        self.w.write_buf(data)

    def write_string(self, s: str) -> None:
        self.w.write_string(s)

    def reset_ds_cur_val(self) -> None:
        pass

    def write_ds_clock(self, clock: int) -> None:
        self.w.write_var_uint(clock)

    def write_ds_len(self, length: int) -> None:
        self.w.write_var_uint(length)

    def write_left_id(self, id_) -> None:
        self.w.write_var_uint(id_.client)
        self.w.write_var_uint(id_.clock)

    write_right_id = write_left_id

    def write_client(self, client: int) -> None:
        self.w.write_var_uint(client)

    def write_info(self, info: int) -> None:
        self.w.write_u8(info)

    def write_parent_info(self, is_root_name: bool) -> None:
        self.w.write_var_uint(1 if is_root_name else 0)

    def write_type_ref(self, tag: int) -> None:
        self.w.write_u8(tag)

    def write_raw(self, data: bytes) -> None:
        """Verbatim wire bytes (re-emission of device-retained spans)."""
        self.w.write_raw(data)

    def write_len(self, length: int) -> None:
        self.w.write_var_uint(length)

    def write_any(self, value: PyAny) -> None:
        write_any(self.w, value)

    def write_json(self, value: PyAny) -> None:
        self.w.write_string(any_to_json(value))

    def write_key(self, key: str) -> None:
        self.w.write_string(key)


class DecoderV1:
    """Plain varint streams: every channel reads from one `Cursor`."""

    __slots__ = ("cur",)

    def __init__(self, data):
        self.cur = data if isinstance(data, Cursor) else Cursor(data)

    def has_content(self) -> bool:
        return self.cur.has_content()

    def read_u8(self) -> int:
        return self.cur.read_u8()

    def read_var(self) -> int:
        return self.cur.read_var_uint()

    def read_buf(self) -> bytes:
        return self.cur.read_buf()

    def read_string(self) -> str:
        return self.cur.read_string()

    def reset_ds_cur_val(self) -> None:
        pass

    def read_ds_clock(self) -> int:
        return self.cur.read_var_uint()

    def read_ds_len(self) -> int:
        return self.cur.read_var_uint()

    def read_id(self) -> Tuple[int, int]:
        return self.cur.read_var_uint(), self.cur.read_var_uint()

    read_left_id = read_id
    read_right_id = read_id

    def read_client(self) -> int:
        return self.cur.read_var_uint()

    def read_info(self) -> int:
        return self.cur.read_u8()

    def read_parent_info(self) -> bool:
        return self.cur.read_var_uint() == 1

    def read_type_ref(self) -> int:
        return self.cur.read_u8()

    def read_len(self) -> int:
        return self.cur.read_var_uint()

    def read_any(self) -> PyAny:
        return read_any(self.cur)

    def read_json(self) -> PyAny:
        return any_from_json(self.cur.read_string())

    def read_key(self) -> str:
        return self.cur.read_string()


# --- v2 column compressors (encoder.rs:353-528) ------------------------------


class _IntDiffOptRleEncoder:
    """Runs of equal differences: ``(diff << 1) | has_count`` as a signed
    varint, then ``count - 2`` when the run is longer than one."""

    __slots__ = ("w", "last", "count", "diff")

    def __init__(self):
        self.w = Writer()
        self.last = 0
        self.count = 0
        self.diff = 0

    def write_u32(self, value: int) -> None:
        diff = value - self.last
        if self.diff == diff and self.count > 0:
            self.last = value
            self.count += 1
        else:
            self._flush()
            self.count = 1
            self.diff = diff
            self.last = value

    def _flush(self) -> None:
        if self.count > 0:
            self.w.write_var_int((self.diff << 1) | (0 if self.count == 1 else 1))
            if self.count > 1:
                self.w.write_var_uint(self.count - 2)

    def to_bytes(self) -> bytes:
        self._flush()
        return self.w.to_bytes()


class _UIntOptRleEncoder:
    """A single value as a signed varint; a run as the negated value (-0
    marked by the sign bit) and ``count - 2``."""

    __slots__ = ("w", "last", "count")

    def __init__(self):
        self.w = Writer()
        self.last = 0
        self.count = 0

    def write_u64(self, value: int) -> None:
        if self.last == value and self.count > 0:
            self.count += 1
        else:
            self._flush()
            self.count = 1
            self.last = value

    def _flush(self) -> None:
        if self.count > 0:
            if self.count == 1:
                self.w.write_var_int(self.last)
            else:
                self.w.write_var_int(-self.last, force_negative=True)
                self.w.write_var_uint(self.count - 2)

    def to_bytes(self) -> bytes:
        self._flush()
        return self.w.to_bytes()


class _RleEncoder:
    """A u8 value, then ``count - 1`` when another value follows (the last
    run repeats for ever)."""

    __slots__ = ("w", "last", "count")

    def __init__(self):
        self.w = Writer()
        self.last: Optional[int] = None
        self.count = 0

    def write_u8(self, value: int) -> None:
        if self.last == value:
            self.count += 1
        else:
            if self.count > 0:
                self.w.write_var_uint(self.count - 1)
            self.count = 1
            self.w.write_u8(value)
            self.last = value

    def to_bytes(self) -> bytes:
        return self.w.to_bytes()


class _StringEncoder:
    """Every string in one UTF-8 blob, their UTF-16 lengths in a
    `_UIntOptRleEncoder` column after it."""

    __slots__ = ("parts", "lens")

    def __init__(self):
        self.parts: List[str] = []
        self.lens = _UIntOptRleEncoder()

    def write(self, s: str) -> None:
        self.parts.append(s)
        self.lens.write_u64(utf16_len(s))

    def to_bytes(self) -> bytes:
        w = Writer()
        w.write_string("".join(self.parts))
        w.write_raw(self.lens.to_bytes())
        return w.to_bytes()


class _IntDiffOptRleDecoder:
    __slots__ = ("cur", "last", "count", "diff")

    def __init__(self, data: bytes):
        self.cur = Cursor(data)
        self.last = 0
        self.count = 0
        self.diff = 0

    def read_u32(self) -> int:
        if self.count == 0:
            diff = self.cur.read_var_int()
            has_count = diff & 1
            self.diff = diff >> 1
            self.count = self.cur.read_var_uint() + 2 if has_count else 1
        self.last += self.diff
        self.count -= 1
        return self.last


class _UIntOptRleDecoder:
    __slots__ = ("cur", "last", "count")

    def __init__(self, data: bytes, cursor: Optional[Cursor] = None):
        self.cur = cursor if cursor is not None else Cursor(data)
        self.last = 0
        self.count = 0

    def read_u64(self) -> int:
        if self.count == 0:
            value, negative = self.cur.read_var_int_signed()
            if negative:
                self.count = self.cur.read_var_uint() + 2
                self.last = -value
            else:
                self.count = 1
                self.last = value
        self.count -= 1
        return self.last


class _RleDecoder:
    __slots__ = ("cur", "last", "count")

    def __init__(self, data: bytes):
        self.cur = Cursor(data)
        self.last = 0
        self.count = 0

    def read_u8(self) -> int:
        if self.count == 0:
            self.last = self.cur.read_u8()
            if self.cur.has_content():
                self.count = self.cur.read_var_uint() + 1
            else:
                self.count = -1  # the last run repeats for ever
        self.count -= 1
        return self.last


class _StringDecoder:
    __slots__ = ("buf", "pos", "lens")

    def __init__(self, data: bytes):
        cur = Cursor(data)
        self.buf = cur.read_buf().decode("utf-8", errors="surrogatepass")
        self.pos = 0
        self.lens = _UIntOptRleDecoder(b"", cursor=cur)

    def read_str(self) -> str:
        remaining = self.lens.read_u64()
        start = i = self.pos
        n = len(self.buf)
        while remaining > 0 and i < n:
            remaining -= 2 if ord(self.buf[i]) > 0xFFFF else 1
            i += 1
        self.pos = i
        return self.buf[start:i]


# --- v2 encoder / decoder ----------------------------------------------------


class EncoderV2:
    """Columns per channel; raw writes, the delete set, Any values and
    Move payloads go to the rest stream."""

    __slots__ = ("rest", "ds_curr_val", "sequencer", "key_clock", "client", "left_clock", "right_clock", "info",
                 "string", "parent_info", "type_ref", "len_enc")

    def __init__(self):
        self.rest = Writer()
        self.ds_curr_val = 0
        self.sequencer = 0
        self.key_clock = _IntDiffOptRleEncoder()
        self.client = _UIntOptRleEncoder()
        self.left_clock = _IntDiffOptRleEncoder()
        self.right_clock = _IntDiffOptRleEncoder()
        self.info = _RleEncoder()
        self.string = _StringEncoder()
        self.parent_info = _RleEncoder()
        self.type_ref = _UIntOptRleEncoder()
        self.len_enc = _UIntOptRleEncoder()

    def to_bytes(self) -> bytes:
        w = Writer()
        w.write_u8(0)  # feature flag
        for col in (self.key_clock, self.client, self.left_clock, self.right_clock, self.info, self.string,
                    self.parent_info, self.type_ref, self.len_enc):
            w.write_buf(col.to_bytes())
        w.write_raw(self.rest.to_bytes())
        return w.to_bytes()

    def write_u8(self, v: int) -> None:
        self.rest.write_u8(v)

    def write_var(self, v: int) -> None:
        self.rest.write_var_uint(v)

    def write_buf(self, data: bytes) -> None:
        self.rest.write_buf(data)

    def write_string(self, s: str) -> None:
        self.string.write(s)

    def reset_ds_cur_val(self) -> None:
        self.ds_curr_val = 0

    def write_ds_clock(self, clock: int) -> None:
        diff = clock - self.ds_curr_val
        self.ds_curr_val = clock
        self.rest.write_var_uint(diff)

    def write_ds_len(self, length: int) -> None:
        self.rest.write_var_uint(length - 1)
        self.ds_curr_val += length

    def write_left_id(self, id_) -> None:
        self.client.write_u64(id_.client)
        self.left_clock.write_u32(id_.clock)

    def write_right_id(self, id_) -> None:
        self.client.write_u64(id_.client)
        self.right_clock.write_u32(id_.clock)

    def write_client(self, client: int) -> None:
        self.client.write_u64(client)

    def write_info(self, info: int) -> None:
        self.info.write_u8(info)

    def write_parent_info(self, is_root_name: bool) -> None:
        self.parent_info.write_u8(1 if is_root_name else 0)

    def write_type_ref(self, tag: int) -> None:
        self.type_ref.write_u64(tag)

    def write_len(self, length: int) -> None:
        self.len_enc.write_u64(length)

    def write_any(self, value: PyAny) -> None:
        write_any(self.rest, value)

    def write_json(self, value: PyAny) -> None:
        write_any(self.rest, value)

    def write_key(self, key: str) -> None:
        # as Yjs and yrs: the key table is never filled, so every key
        # writes a fresh string and a fresh sequencer clock
        # (encoder.rs:327-334)
        self.key_clock.write_u32(self.sequencer)
        self.sequencer += 1
        self.string.write(key)


class DecoderV2:
    __slots__ = ("rest", "ds_curr_val", "keys", "key_clock", "client", "left_clock", "right_clock", "info",
                 "string", "parent_info", "type_ref", "len_dec")

    def __init__(self, data: bytes):
        cur = Cursor(data)
        if cur.has_content():
            cur.read_u8()  # feature flag
        self.key_clock = _IntDiffOptRleDecoder(cur.read_buf())
        self.client = _UIntOptRleDecoder(cur.read_buf())
        self.left_clock = _IntDiffOptRleDecoder(cur.read_buf())
        self.right_clock = _IntDiffOptRleDecoder(cur.read_buf())
        self.info = _RleDecoder(cur.read_buf())
        self.string = _StringDecoder(cur.read_buf())
        self.parent_info = _RleDecoder(cur.read_buf())
        self.type_ref = _UIntOptRleDecoder(cur.read_buf())
        self.len_dec = _UIntOptRleDecoder(cur.read_buf())
        self.rest = Cursor(cur.read_to_end())
        self.ds_curr_val = 0
        self.keys: List[str] = []

    def has_content(self) -> bool:
        return self.rest.has_content()

    def read_u8(self) -> int:
        return self.rest.read_u8()

    def read_var(self) -> int:
        return self.rest.read_var_uint()

    def read_buf(self) -> bytes:
        return self.rest.read_buf()

    def read_string(self) -> str:
        return self.string.read_str()

    def reset_ds_cur_val(self) -> None:
        self.ds_curr_val = 0

    def read_ds_clock(self) -> int:
        self.ds_curr_val += self.rest.read_var_uint()
        return self.ds_curr_val

    def read_ds_len(self) -> int:
        diff = self.rest.read_var_uint() + 1
        self.ds_curr_val += diff
        return diff

    def read_left_id(self) -> Tuple[int, int]:
        return self.client.read_u64(), self.left_clock.read_u32()

    def read_right_id(self) -> Tuple[int, int]:
        return self.client.read_u64(), self.right_clock.read_u32()

    def read_client(self) -> int:
        return self.client.read_u64()

    def read_info(self) -> int:
        return self.info.read_u8()

    def read_parent_info(self) -> bool:
        return self.parent_info.read_u8() == 1

    def read_type_ref(self) -> int:
        return self.type_ref.read_u64()

    def read_len(self) -> int:
        return self.len_dec.read_u64()

    def read_any(self) -> PyAny:
        return read_any(self.rest)

    def read_json(self) -> PyAny:
        return read_any(self.rest)

    def read_key(self) -> str:
        key_clock = self.key_clock.read_u32()
        if key_clock < len(self.keys):
            return self.keys[key_clock]
        key = self.string.read_str()
        self.keys.append(key)
        return key
