"""The v1 update codec (PyTorch port of `ytpu.encoding.codec`'s
`EncoderV1`, the writer half the diff finisher calls, and `DecoderV1`, the
reader half host-lane decode calls; parity target: yrs
updates/encoder.rs:80-180, updates/decoder.rs:76-190)."""

from __future__ import annotations

from typing import Any as PyAny
from typing import Tuple

from ytpu_torch.encoding.lib0 import Cursor, Writer, any_from_json, any_to_json, read_any, write_any

__all__ = ["DecoderV1", "EncoderV1"]


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
