"""Device-side lib0/V1 update decoding (PyTorch port of
`ytpu.ops.decode_kernel`).

Host half (copied): the flag bits, staging helpers (`pack_updates`,
`pack_updates_into`, `pack_raw_updates_into`), the decode step budgets,
the host key/client hashes and the wire payload readers behind
`RawPayloadView`.

Device half: `gather_raw_lanes` (one gather, torch ops) and the 41-state
lib0 varint machine `decode_updates_v1`. On the card the machine is the
hand-written kernel of ``csrc/decode.cu``: one thread per update lane,
each walking its own bytes until DONE or ERR or the step budget. Its
plain version `_decode_loop_reference` keeps the JAX package's shape:
every iteration decodes one lib0 varint (or one info byte / one string
skip) in every lane at once, all S lanes in lockstep as ``[S]``-wide
tensor ops; it serves the CPU and the tests. The intern tables (clients,
key hashes, big-client hashes, primary roots) resolve after either, as
torch ops (`_resolve_and_pack`).

`ChunkedWirePayloads` resolves the payloads of the batch ingestor's rows:
host-planned rows through a `PayloadStore`, device-decoded rows through
the wire bytes it retains, step by step.

JAX clamps out-of-range gathers; every gather here clamps its index
explicitly. uint32 arithmetic is emulated in int64 with 32-bit masks.
"""

from __future__ import annotations

import ctypes
import json
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ytpu_torch.core.content import (
    BLOCK_GC,
    BLOCK_SKIP,
    CONTENT_ANY,
    CONTENT_BINARY,
    CONTENT_DELETED,
    CONTENT_EMBED,
    CONTENT_FORMAT,
    CONTENT_JSON,
    CONTENT_MOVE,
    CONTENT_STRING,
    CONTENT_TYPE,
)
from ytpu_torch.core.device import resolve_device
from ytpu_torch.encoding.lib0 import TYPE_XML_ELEMENT, TYPE_XML_HOOK, Cursor, any_from_json, read_any
from ytpu_torch.models.batch_doc import UpdateBatch

__all__ = [
    "FLAG_UNSUPPORTED",
    "FLAG_OVERFLOW",
    "FLAG_MALFORMED",
    "FLAG_BIG_CLIENT",
    "FLAG_MULTI_CLIENT",
    "FLAG_UNKNOWN_CLIENT",
    "FLAG_UNKNOWN_KEY",
    "FLAG_ERRORS",
    "EMPTY_UPDATE",
    "pack_updates",
    "pack_updates_into",
    "pack_raw_updates_into",
    "gather_raw_lanes",
    "decode_updates_v1",
    "identity_rank",
    "RawPayloadView",
    "ChunkedWirePayloads",
    "WireTypeRef",
    "utf8_slice_u16",
    "default_steps",
    "exact_steps",
    "steps_for_columns",
    "key_hash_host",
    "client_hash_host",
]

I32 = torch.int32
I64 = torch.int64
U32_MASK = 0xFFFFFFFF

# --- per-update flag bits ----------------------------------------------------
FLAG_UNSUPPORTED = 1  # content kind / parent_sub the device cannot decode
FLAG_OVERFLOW = 2  # more blocks / delete ranges than the U/R buckets
FLAG_MALFORMED = 4  # ran past the buffer or did not reach DONE in T steps
FLAG_BIG_CLIENT = 8  # a client id >= 2^31 (needs host interning)
FLAG_MULTI_CLIENT = 16  # informational: >1 client section
FLAG_UNKNOWN_CLIENT = 32  # a client id absent from the supplied intern table
FLAG_UNKNOWN_KEY = 64  # a parent_sub hash absent from the supplied key table

FLAG_ERRORS = (
    FLAG_UNSUPPORTED
    | FLAG_OVERFLOW
    | FLAG_MALFORMED
    | FLAG_BIG_CLIENT
    | FLAG_UNKNOWN_CLIENT
    | FLAG_UNKNOWN_KEY
)

# --- parser states -----------------------------------------------------------
(
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
    ST_ANY_COUNT,  # ContentAny: value count
    ST_ANY_VAL,  # ContentAny: one scalar value per step
    ST_JSON_COUNT,  # ContentJson: string count
    ST_JSON_VAL,  # ContentJson: one length-prefixed string per step
    ST_SPAN1,  # ContentEmbed/Binary: one length-prefixed span, len 1
    ST_FMT_KEY,  # ContentFormat: key string
    ST_FMT_VAL,  # ContentFormat: one Any value
    ST_TYPE_TAG,  # ContentType: branch TypeRef tag byte
    ST_TYPE_NAME,  # ContentType: XmlElement/XmlHook name string
    ST_MV_FLAGS,  # ContentMove: collapsed/assoc/priority flags varint
    ST_MV_SC,  # ContentMove: range-start id client
    ST_MV_SK,  # ContentMove: range-start id clock
    ST_MV_EC,  # ContentMove: range-end id client (absent if collapsed)
    ST_MV_EK,  # ContentMove: range-end id clock
    ST_ANY_MKEY,  # ContentAny map value: one key string per step
    ST_ANY_MVAL,  # ContentAny map value: one scalar value per step
    ST_DONE,
    ST_ERR,
) = range(41)

# key-hash window: parent_sub keys longer than this take the host lane
KEY_HASH_BYTES = 32

_PAD = 16  # gather guard past the longest update


def pack_updates(
    payloads: List[bytes], pad_to: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Pad raw V1 update byte strings into an ``[S, L] uint8`` matrix."""
    lens = np.array([len(p) for p in payloads], dtype=np.int32)
    L = max(int(lens.max()) + _PAD if len(payloads) else _PAD, pad_to or 0)
    buf = np.zeros((len(payloads), L), dtype=np.uint8)
    for i, p in enumerate(payloads):
        buf[i, : len(p)] = np.frombuffer(p, dtype=np.uint8)
    return buf, lens


# the minimal well-formed V1 update (0 client sections, empty delete set):
# what staging pads short tail chunks with
EMPTY_UPDATE = b"\x00\x00"


def pack_updates_into(payloads: List[bytes], buf: np.ndarray, lens: np.ndarray) -> None:
    """`pack_updates` into caller-provided staging buffers (in place); rows
    past ``len(payloads)`` hold `EMPTY_UPDATE`."""
    S, L = buf.shape
    if len(payloads) > S:
        raise ValueError(f"chunk of {len(payloads)} exceeds staging rows {S}")
    for i in range(S):
        p = payloads[i] if i < len(payloads) else EMPTY_UPDATE
        n = len(p)
        if n + _PAD > L:
            raise ValueError(f"payload of {n} bytes exceeds staging width {L}")
        prev = int(lens[i])
        buf[i, :n] = np.frombuffer(p, dtype=np.uint8)
        if prev + _PAD > n:
            buf[i, n : prev + _PAD] = 0
        lens[i] = n


_EMPTY_NP = np.frombuffer(EMPTY_UPDATE, dtype=np.uint8)


def pack_raw_updates_into(
    wire: np.ndarray,
    wire_offsets: np.ndarray,
    pos: int,
    end: int,
    raw: np.ndarray,
    offs: np.ndarray,
    lens: np.ndarray,
    width: Optional[int] = None,
) -> int:
    """Stage one chunk of the raw ingest lane: a slice copy of the run's
    concatenated wire bytes plus in-chunk offset/length tables. Rows past
    ``end - pos`` point at a staged `EMPTY_UPDATE` tail. Returns the staged
    byte count."""
    n = end - pos
    if n > offs.shape[0]:
        raise ValueError(f"chunk of {n} exceeds staging rows {offs.shape[0]}")
    b0 = int(wire_offsets[pos])
    b1 = int(wire_offsets[end])
    nb = b1 - b0
    if nb + len(EMPTY_UPDATE) > raw.shape[0]:
        raise ValueError(
            f"chunk of {nb} wire bytes exceeds staging capacity {raw.shape[0]}"
        )
    chunk_lens = wire_offsets[pos : end + 1]
    if width is not None and n:
        longest = int((chunk_lens[1:] - chunk_lens[:-1]).max())
        if longest + _PAD > width:
            raise ValueError(f"payload of {longest} bytes exceeds staging width {width}")
    raw[:nb] = wire[b0:b1]
    raw[nb : nb + len(EMPTY_UPDATE)] = _EMPTY_NP
    offs[:n] = chunk_lens[:-1] - b0
    lens[:n] = chunk_lens[1:] - chunk_lens[:-1]
    offs[n:] = nb
    lens[n:] = len(EMPTY_UPDATE)
    return nb + len(EMPTY_UPDATE)


def gather_raw_lanes(raw, offs, lens, width: int):
    """``[RC]`` raw concatenated bytes + per-update offsets -> the padded
    ``[S, width]`` lane matrix `pack_updates` builds on the host: one
    clamped lane-parallel gather, bytes at ``j >= lens[s]`` zeroed."""
    iota = torch.arange(width, dtype=I64, device=raw.device)[None, :]
    idx = (offs[:, None].to(I64) + iota).clamp(0, raw.shape[0] - 1)
    lanes = raw[idx]
    return torch.where(iota < lens[:, None].to(I64), lanes, torch.zeros_like(lanes))


def identity_rank(k: int, device=None) -> torch.Tensor:
    """Rank table for raw-client-id streams: rank(c) = c (on the GPU unless
    `device` says otherwise)."""
    return torch.arange(k, dtype=I32, device=resolve_device(device))


def utf8_slice_u16(buf: np.ndarray, start: int, off: int, length: int) -> str:
    """Slice ``length`` UTF-16 units at unit-offset ``off`` from the UTF-8
    string starting at byte ``start`` of ``buf``. Offsets landing inside a
    surrogate pair render the severed half as U+FFFD."""
    i = int(start)

    def unit_at(i):
        b0 = buf[i]
        if b0 < 0x80:
            return 1, 1
        if b0 < 0xE0:
            return 2, 1
        if b0 < 0xF0:
            return 3, 1
        return 4, 2

    out = []
    u = 0
    while u < off:
        nb, nu = unit_at(i)
        i += nb
        u += nu
    need = length
    if u > off:
        # the slice starts inside a surrogate pair: its severed low half
        out.append("�")
        need -= u - off
    s = i
    while need > 0:
        nb, nu = unit_at(i)
        if nu > need:
            # ends inside a pair: the severed high half
            out.append(bytes(buf[s:i]).decode("utf-8", errors="surrogatepass"))
            out.append("�")
            return "".join(out)
        i += nb
        need -= nu
    out.append(bytes(buf[s:i]).decode("utf-8", errors="surrogatepass"))
    return "".join(out)


def _wire_any_values(flat: np.ndarray, start: int, off: int, length: int) -> list:
    """ContentAny at wire offset `start`: the count varint, then values
    ``[off, off + length)`` of its Any values."""
    cur = Cursor(bytes(flat[start:]))
    n = cur.read_var_uint()
    out = []
    for i in range(min(n, off + length)):
        v = read_any(cur)
        if i >= off:
            out.append(v)
    return out


def _wire_any_values_countless(flat: np.ndarray, start: int, off: int, length: int) -> list:
    """A V2 ContentAny span: its values start AT `start` (V2 keeps the
    count in the len column, so ``off + length`` bounds the read)."""
    cur = Cursor(bytes(flat[start:]))
    out = []
    for i in range(off + length):
        v = read_any(cur)
        if i >= off:
            out.append(v)
    return out


def _wire_json_values(flat: np.ndarray, start: int, off: int, length: int) -> list:
    """ContentJson at `start`: the count, then JSON strings, parsed (None
    where one does not parse, as ``ContentJSON.values``)."""
    out = []
    for s in _wire_json_raw(flat, start, off, length):
        try:
            out.append(json.loads(s))
        except (ValueError, TypeError):
            out.append(None)
    return out


def _wire_json_raw(flat: np.ndarray, start: int, off: int, length: int) -> list:
    """ContentJson's raw strings (the finisher re-emits them as they came)."""
    cur = Cursor(bytes(flat[start:]))
    n = cur.read_var_uint()
    out = []
    for i in range(min(n, off + length)):
        s = cur.read_string()
        if i >= off:
            out.append(s)
    return out


def _wire_embed_value(flat: np.ndarray, start: int):
    return any_from_json(Cursor(bytes(flat[start:])).read_string())


def _wire_binary_value(flat: np.ndarray, start: int) -> bytes:
    return Cursor(bytes(flat[start:])).read_buf()


def _wire_format_kv(flat: np.ndarray, start: int):
    cur = Cursor(bytes(flat[start:]))
    key = cur.read_string()
    return key, any_from_json(cur.read_string())


class WireTypeRef(NamedTuple):
    """What a ContentType payload tells a renderer: its TypeRef tag and,
    for XmlElement and XmlHook, its name (the fields of ytpu's ``Branch``
    that `_wire_type_branch` fills)."""

    type_ref: int
    type_name: Optional[str] = None


def _wire_type_branch(flat: np.ndarray, start: int) -> WireTypeRef:
    """ContentType at wire offset `start`: the TypeRef tag byte, and the
    name of an XmlElement or XmlHook (branch.rs decode_type_ref)."""
    cur = Cursor(bytes(flat[start:]))
    tag = cur.read_u8()
    if tag in (TYPE_XML_ELEMENT, TYPE_XML_HOOK):
        return WireTypeRef(tag, cur.read_string())
    return WireTypeRef(tag)


def _wire_type_raw(flat: np.ndarray, start: int) -> bytes:
    """The wire bytes of a ContentType payload, for the finisher to write
    out again."""
    cur = Cursor(bytes(flat[start:]))
    if cur.read_u8() in (TYPE_XML_ELEMENT, TYPE_XML_HOOK):
        cur.read_buf()  # the name
    return bytes(flat[start : start + cur.pos])


class RawPayloadView:
    """Payload reader over the padded ``[S, L]`` wire-byte matrix of
    `pack_updates`. Device-decoded rows address their content by ``ref =
    s * L + byte_start``: string refs point at the UTF-8 bytes with ``(off,
    len)`` in UTF-16 units, Any and Json refs at their count varint with
    ``(off, len)`` in values, Embed, Binary, Format and Type refs at their
    span. With `v2_any`, Any refs point at the first value (a V2 state)."""

    def __init__(self, buf: np.ndarray, v2_any: bool = False):
        self.buf = np.ascontiguousarray(buf, dtype=np.uint8).reshape(-1)
        self.v2_any = v2_any

    def slice_text(self, ref: int, off: int, length: int) -> str:
        return utf8_slice_u16(self.buf, int(ref), off, length)

    def slice_values(self, ref: int, off: int, length: int) -> list:
        if self.v2_any:
            return _wire_any_values_countless(self.buf, int(ref), off, length)
        return _wire_any_values(self.buf, int(ref), off, length)

    def json_values(self, ref: int, off: int, length: int) -> list:
        return _wire_json_values(self.buf, int(ref), off, length)

    def json_raw(self, ref: int, off: int, length: int) -> list:
        return _wire_json_raw(self.buf, int(ref), off, length)

    def embed_value(self, ref: int):
        return _wire_embed_value(self.buf, int(ref))

    def binary_value(self, ref: int) -> bytes:
        return _wire_binary_value(self.buf, int(ref))

    def format_kv(self, ref: int):
        return _wire_format_kv(self.buf, int(ref))

    def type_branch(self, ref: int) -> WireTypeRef:
        return _wire_type_branch(self.buf, int(ref))

    def type_raw(self, ref: int) -> bytes:
        return _wire_type_raw(self.buf, int(ref))


class ChunkedWirePayloads:
    """Payload resolver over a host `PayloadStore` plus the wire-byte
    chunks the batch ingestor retains from its device-decoded steps.

    Ref space: ``ref >= 0`` -> the PayloadStore (host-planned rows);
    ``ref <= -2`` -> byte ``-(ref + 2)`` of the concatenated chunks
    (device-decoded rows: the ingestor rebases each step's ``s * L +
    start`` refs onto the running total of retained bytes); ``-1`` is no
    payload."""

    def __init__(self, store):
        self.store = store
        self._chunks: List[Tuple[int, np.ndarray]] = []  # (base, flat bytes)
        self.total_bytes = 0

    @property
    def items(self):
        return self.store.items

    def add_chunk(self, buf: np.ndarray) -> int:
        """Retain a step's bytes; returns the base its refs are rebased by."""
        flat = np.ascontiguousarray(buf, dtype=np.uint8).reshape(-1)
        base = self.total_bytes
        self._chunks.append((base, flat))
        self.total_bytes += flat.size
        return base

    def drop_if_unreferenced(self, base: int) -> None:
        """Release the most recent chunk (its rows never went live); only
        the latest can be dropped."""
        if self._chunks and self._chunks[-1][0] == base:
            self._chunks.pop()
            self.total_bytes = base

    def _locate(self, ref: int) -> Tuple[np.ndarray, int]:
        import bisect

        off = -(int(ref) + 2)
        k = bisect.bisect_right([b for b, _ in self._chunks], off) - 1
        base, flat = self._chunks[k]
        return flat, off - base

    def slice_text(self, ref: int, off: int, length: int) -> str:
        if int(ref) >= 0:
            return self.store.slice_text(ref, off, length)
        flat, start = self._locate(ref)
        return utf8_slice_u16(flat, start, off, length)

    def slice_values(self, ref: int, off: int, length: int) -> list:
        if int(ref) >= 0:
            return self.store.slice_values(ref, off, length)
        flat, start = self._locate(ref)
        return _wire_any_values(flat, start, off, length)

    def json_values(self, ref: int, off: int, length: int) -> list:
        if int(ref) >= 0:
            return self.store.json_values(ref, off, length)
        flat, start = self._locate(ref)
        return _wire_json_values(flat, start, off, length)

    def json_raw(self, ref: int, off: int, length: int) -> list:
        if int(ref) >= 0:
            return self.store.json_raw(ref, off, length)
        flat, start = self._locate(ref)
        return _wire_json_raw(flat, start, off, length)

    def embed_value(self, ref: int):
        if int(ref) >= 0:
            return self.store.embed_value(ref)
        flat, start = self._locate(ref)
        return _wire_embed_value(flat, start)

    def binary_value(self, ref: int) -> bytes:
        if int(ref) >= 0:
            return self.store.binary_value(ref)
        flat, start = self._locate(ref)
        return _wire_binary_value(flat, start)

    def format_kv(self, ref: int):
        if int(ref) >= 0:
            return self.store.format_kv(ref)
        flat, start = self._locate(ref)
        return _wire_format_kv(flat, start)

    def type_branch(self, ref: int):
        if int(ref) >= 0:
            return self.store.items[int(ref)][1].branch
        flat, start = self._locate(ref)
        return _wire_type_branch(flat, start)

    def type_raw(self, ref: int) -> bytes:
        flat, start = self._locate(ref)
        return _wire_type_raw(flat, start)


def default_steps(max_rows: int, max_dels: int) -> int:
    """Safe iteration budget for scalar content."""
    return 4 + 13 * max_rows + 4 * max_dels


def key_hash_host(key: bytes) -> int:
    """The device key hash, host side."""
    h = 0
    for i, byte in enumerate(key[:KEY_HASH_BYTES]):
        h = (h + byte * pow(31, i, 1 << 32)) & 0xFFFFFFFF
    h ^= (len(key) * 2654435761) & 0xFFFFFFFF
    return h & 0x7FFFFFFF


def client_hash_host(client: int) -> int:
    """Hash of a client id's varint wire bytes (ids beyond i32)."""
    h = 0
    i = 0
    v = client
    while True:
        byte = v & 0x7F
        v >>= 7
        if v:
            byte |= 0x80
        h = (h + byte * pow(31, i, 1 << 32)) & 0xFFFFFFFF
        i += 1
        if not v:
            break
    h ^= (i * 2654435761) & 0xFFFFFFFF
    return h & 0x3FFFFFFF


def exact_steps(
    n_client_sections: int,
    n_item_blocks: int,
    n_skip_gc_blocks: int,
    n_ds_sections: int,
    n_del_ranges: int,
    n_value_steps: int = 0,
) -> int:
    """Step budget for one update whose wire-section counts are known."""
    return (
        2
        + 3 * n_client_sections
        + 10 * n_item_blocks
        + 2 * n_skip_gc_blocks
        + 2 * n_ds_sections
        + 2 * n_del_ranges
        + n_value_steps
    )


def steps_for_columns(cols) -> int:
    """Exact decode step budget for one update from its column walk
    (`ytpu_torch.encoding.lib0.update_columns`)."""
    n_skip_gc = int(np.count_nonzero((cols.kind == 10) | (cols.kind == 0)))
    return exact_steps(
        cols.n_client_sections,
        cols.n_blocks - n_skip_gc + cols.n_zero_len_blocks,
        n_skip_gc,
        cols.n_ds_sections,
        cols.n_dels,
        getattr(cols, "n_value_steps", 0),
    )


def _pow31(n: int, device) -> torch.Tensor:
    return torch.tensor([pow(31, i, 1 << 32) for i in range(n)], dtype=I64, device=device)


def decode_updates_v1(
    buf: torch.Tensor,
    lens: torch.Tensor,
    max_rows: int,
    max_dels: int,
    n_steps: Optional[int] = None,
    client_table: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    max_sections: Optional[int] = None,
    key_table: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    client_hash_table: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    primary_root_hash: Optional[torch.Tensor] = None,
) -> Tuple[UpdateBatch, torch.Tensor]:
    """Decode S updates (``buf`` ``[S, L]`` uint8, ``lens`` ``[S]``) into an
    ``[S, U] / [S, R]`` UpdateBatch stream. Returns ``(stream, flags)``;
    lanes with ``flags & FLAG_ERRORS`` decoded incompletely and their rows
    are marked invalid.

    The tables (each a ``(sorted keys, perm)`` pair: ``perm[j]`` is the
    interned index of ``keys[j]``) are resolved after the loop by
    `_resolve_and_pack`, with the JAX package's semantics:
    ``client_table`` maps raw client ids to interned indices (a miss flags
    FLAG_UNKNOWN_CLIENT); ``client_hash_table`` maps the varint-byte hash
    of an id beyond i32 (`client_hash_host`) to its interned index
    (without it such lanes flag FLAG_BIG_CLIENT, a miss flags
    FLAG_UNKNOWN_CLIENT); ``key_table`` maps a parent_sub key hash
    (`key_hash_host`) to its key index (a map row with no table or a miss
    flags FLAG_UNKNOWN_KEY); ``primary_root_hash`` (``[S]``, -1 = single
    root) maps a named root whose hash is the lane's primary to the
    implicit branch (``p_root == -1``) and other names through
    ``key_table`` to their anchor's key id (a miss flags
    FLAG_UNKNOWN_KEY, a name beyond the hash window FLAG_UNSUPPORTED).
    Without tables every client id stays raw, map rows flag and
    ``key`` / ``p_root`` are -1.

    Launches on CUDA tensors the hand-written kernel of
    ``csrc/decode.cu`` (one thread per lane, counted in
    ``decode_updates_v1.launches``) and on CPU tensors the plain loop
    `_decode_loop_reference`; any other device raises, and so does a
    kernel that fails to build or launch. Both give the same pre-resolve
    columns and flags."""
    U, R = max_rows, max_dels
    T = n_steps or default_steps(U, R)
    max_sec = max_sections if max_sections is not None else U + 1
    dev = buf.device
    if dev.type == "cpu":
        rows, dels, flags = _decode_loop_reference(buf, lens, U, R, T, max_sec)
    elif dev.type == "cuda":
        rows, dels, flags, _ = _decode_kernel(buf, lens, U, R, T, max_sec)
        decode_updates_v1.launches += 1
    else:
        raise ValueError(f"decode_updates_v1 runs on cuda or cpu tensors, not {dev}")
    return _resolve_and_pack(rows, dels, flags, client_table, key_table, client_hash_table,
                             primary_root_hash)


decode_updates_v1.launches = 0

#: the pre-resolve columns both versions return: ``rows`` holds these
#: ``[S, U]`` int64 columns and ``valid`` (bool), ``dels`` these ``[S, R]``
#: int64 columns and ``valid``; the kernel writes them as planes in this order
ROW_COLUMNS = ("client", "clock", "length", "oc", "ok", "rc", "rk", "kind", "ref", "ptag", "pc", "pk",
               "keyh", "rooth", "msc", "msk", "msa", "mec", "mek", "mea", "mprio")
DEL_COLUMNS = ("client", "start", "end")


def _decode_loop_reference(buf, lens, U: int, R: int, T: int, max_sec: int):
    """The plain version of the decode: the lane-parallel machine as torch
    ops, ``T`` iterations, each decoding one lib0 varint (or one info byte,
    one string skip, one Any value) in every lane at once; lanes at DONE or
    ERR change nothing. Returns the pre-resolve ``(rows, dels, flags)``
    (`ROW_COLUMNS`, `DEL_COLUMNS`)."""
    dev = buf.device
    S, L = buf.shape
    b = buf.to(I64)
    lens = lens.to(I64)

    def full(v, shape=(S,)):
        return torch.full(shape, v, dtype=I64, device=dev)

    # UTF-16 length prefix sums: a UTF-8 head byte (not 0b10xxxxxx) is one
    # code point; a 4-byte lead (>= 0xF0) is a surrogate pair, one extra
    head = ((b & 0xC0) != 0x80).to(I64)
    lead4 = (b >= 0xF0).to(I64)
    u16_psum = torch.cat([full(0, (S, 1)), torch.cumsum(head + lead4, dim=1)], dim=1)

    iota_u = torch.arange(U, device=dev)[None, :]
    iota_r = torch.arange(R, device=dev)[None, :]
    row_ids = torch.arange(S, dtype=I64, device=dev)
    ar10 = torch.arange(10, dtype=I64, device=dev)[None, :]
    arkh = torch.arange(KEY_HASH_BYTES, dtype=I64, device=dev)[None, :]
    shifts = (7 * torch.arange(5, dtype=I64, device=dev))[None, :]
    pow31 = _pow31(KEY_HASH_BYTES, dev)[None, :]
    pow31_10 = _pow31(10, dev)[None, :]

    def take(idx):
        """b[s, clamp(idx[s, k])] (JAX clamps out-of-range gathers)."""
        return torch.gather(b, 1, idx.clamp(0, L - 1))

    def u16_span(a, bnd):
        a = a.clamp(0, L)
        bnd = bnd.clamp(0, L)
        pa = torch.gather(u16_psum, 1, a[:, None])[:, 0]
        pb = torch.gather(u16_psum, 1, bnd[:, None])[:, 0]
        return pb - pa

    def wrap32(x):
        """int64 -> the int32 value with the same low 32 bits (as int64)."""
        x = x & U32_MASK
        return torch.where(x >= (1 << 31), x - (1 << 32), x)

    regs = dict(
        pos=full(0), st=full(ST_NCLIENTS), flags=full(0), clients_left=full(0),
        blocks_left=full(0), client=full(0), clock=full(0), info=full(0),
        oc=full(-1), ok=full(0), rc=full(-1), rk=full(0), ptag=full(0),
        pc=full(-1), pk=full(0), ds_clients_left=full(0), ds_ranges_left=full(0),
        ds_client=full(0), ds_clock=full(0), n_rows=full(0), n_dels=full(0),
        keyh=full(-1), rooth=full(-1), vals_left=full(0), vals_n=full(0),
        cref=full(-1), mpairs=full(0), mvf=full(0), msc=full(-1), msk=full(0),
        mec=full(-1),
    )
    ushape = (S, U)
    rows = dict(
        client=full(0, ushape), clock=full(0, ushape), length=full(0, ushape),
        oc=full(-1, ushape), ok=full(0, ushape), rc=full(-1, ushape),
        rk=full(0, ushape), kind=full(0, ushape), ref=full(-1, ushape),
        ptag=full(0, ushape), pc=full(-1, ushape), pk=full(0, ushape),
        keyh=full(-1, ushape), rooth=full(-1, ushape), msc=full(-1, ushape),
        msk=full(0, ushape), msa=full(0, ushape), mec=full(-1, ushape),
        mek=full(0, ushape), mea=full(0, ushape), mprio=full(-1, ushape),
        valid=torch.zeros(ushape, dtype=torch.bool, device=dev),
    )
    rshape = (S, R)
    dels = dict(
        client=full(0, rshape), start=full(0, rshape), end=full(0, rshape),
        valid=torch.zeros(rshape, dtype=torch.bool, device=dev),
    )

    def where(c, a, b_):
        if not torch.is_tensor(a):
            a = full(a)
        if not torch.is_tensor(b_):
            b_ = full(b_)
        return torch.where(c, a, b_)

    for _ in range(T):
        pos, st = regs["pos"], regs["st"]
        active = (st != ST_DONE) & (st != ST_ERR)

        # --- one varint (or u8) at the cursor, all lanes at once ---------
        win = pos[:, None] + ar10
        in_buf = win < lens[:, None]
        bytes10 = torch.where(in_buf, take(win), torch.zeros_like(win))
        cont = bytes10 >= 0x80
        inb = torch.cat(
            [full(1, (S, 1)), torch.cumprod(cont[:, :9].to(I64), dim=1)], dim=1
        )
        nbytes = inb.sum(dim=1)
        val = wrap32(
            torch.where(inb[:, :5] == 1, (bytes10[:, :5] & 0x7F) << shifts, 0).sum(dim=1)
        )
        ovf = (nbytes > 5) | ((nbytes == 5) & ((bytes10[:, 4] & 0x7F) >= 8))

        is_info = st == ST_INFO
        is_u8 = is_info | (st == ST_TYPE_TAG)
        v = torch.where(is_u8, bytes10[:, 0], val)
        consumed = torch.where(is_u8, full(1), nbytes)

        is_str_skip = (
            (st == ST_PARENT_NAME)
            | (st == ST_PARENT_SUB)
            | (st == ST_JSON_VAL)
            | (st == ST_FMT_KEY)
            | (st == ST_FMT_VAL)
            | (st == ST_SPAN1)
            | (st == ST_TYPE_NAME)
            | (st == ST_ANY_MKEY)
        )
        is_str = st == ST_STR
        str_start = pos + nbytes
        consumed = consumed + torch.where(is_str_skip | is_str, v, 0)

        # --- one lib0 Any value: tag byte, then a tag-dependent payload
        is_any_val = st == ST_ANY_VAL
        is_any_mval = st == ST_ANY_MVAL
        tag = bytes10[:, 0]
        cont2 = bytes10[:, 1:] >= 0x80
        inb2 = torch.cat(
            [full(1, (S, 1)), torch.cumprod(cont2[:, :8].to(I64), dim=1)], dim=1
        )
        nb2 = inb2.sum(dim=1)
        val2 = wrap32(
            torch.where(inb2[:, :5] == 1, (bytes10[:, 1:6] & 0x7F) << shifts, 0).sum(dim=1)
        )
        any_extra = torch.where(
            (tag == 127) | (tag == 126) | (tag == 121) | (tag == 120),
            0,
            torch.where(
                tag == 125,
                nb2,
                torch.where(
                    tag == 124,
                    4,
                    torch.where(
                        (tag == 123) | (tag == 122),
                        8,
                        torch.where(
                            (tag == 119) | (tag == 116),
                            nb2 + val2,
                            torch.where((tag == 117) | (tag == 118), nb2, 0),
                        ),
                    ),
                ),
            ),
        )
        any_bad_tag = (is_any_val & (tag < 116)) | (
            is_any_mval & ((tag == 117) | (tag == 118) | (tag < 116))
        )
        consumed = torch.where(is_any_val | is_any_mval, 1 + any_extra, consumed)

        # --- parent_sub key hash over the string's first KEY_HASH_BYTES bytes
        kh_bytes = take(str_start[:, None] + arkh)
        kh_mask = arkh < v[:, None]
        khash = (torch.where(kh_mask, kh_bytes * pow31, 0).sum(dim=1)) & U32_MASK
        khash = (khash ^ (((v & U32_MASK) * 2654435761) & U32_MASK)) & 0x7FFFFFFF
        key_too_long = (st == ST_PARENT_SUB) & (v > KEY_HASH_BYTES)

        pos_after = pos + consumed
        is_client_st = (
            (st == ST_CLIENT) | (st == ST_ORIGIN_C) | (st == ST_ROR_C)
            | (st == ST_PARENT_ID_C) | (st == ST_DS_CLIENT)
            | (st == ST_MV_SC) | (st == ST_MV_EC)
        )
        # client ids beyond i32 are represented by -2 - hash of their bytes
        cmask = ar10 < nbytes[:, None]
        chash = (torch.where(cmask, bytes10 * pow31_10, 0).sum(dim=1)) & U32_MASK
        chash = (chash ^ ((nbytes * 2654435761) & U32_MASK)) & 0x3FFFFFFF
        vc = torch.where(is_client_st & ovf, -2 - chash, v)
        bad = active & (
            (pos_after > lens)
            | ((is_str_skip | is_str) & (v > L))
            | ((is_any_val | is_any_mval) & ((tag == 119) | (tag == 116)) & (val2 > L))
            | (ovf & ~is_u8 & ~is_client_st & ~is_any_val & ~is_any_mval)
            | ((st == ST_NCLIENTS) & (v > max_sec))
        )
        act = active & ~bad

        def on(s):
            return act & (st == s)

        def upd(reg, cond, new):
            return where(cond, new, reg)

        # --- end-of-block / end-of-ds-range shared bookkeeping -----------
        any_children = torch.where((st == ST_ANY_VAL) & (tag == 117), val2, 0)
        map_open = on(ST_ANY_VAL) & (tag == 118) & (val2 > 0)
        mpairs2 = upd(regs["mpairs"], on(ST_ANY_MVAL), regs["mpairs"] - 1)
        map_done = on(ST_ANY_MVAL) & (mpairs2 == 0)
        vals_dec = (on(ST_ANY_VAL) & ~map_open) | on(ST_JSON_VAL) | map_done
        vals_left2 = upd(regs["vals_left"], vals_dec, regs["vals_left"] - 1 + any_children)
        empty_list = (on(ST_ANY_COUNT) | on(ST_JSON_COUNT)) & (v == 0)
        list_done = vals_dec & (vals_left2 == 0)
        type_named = on(ST_TYPE_TAG) & ((v == 3) | (v == 5))
        type_done = (on(ST_TYPE_TAG) & ~type_named) | on(ST_TYPE_NAME)
        mv_collapsed = (regs["mvf"] & 1) != 0
        move_done = (on(ST_MV_SK) & mv_collapsed) | on(ST_MV_EK)
        emit_row_st = (
            on(ST_DEL_LEN)
            | on(ST_GC_LEN)
            | on(ST_SKIP_LEN)
            | on(ST_STR)
            | list_done
            | on(ST_SPAN1)
            | on(ST_FMT_VAL)
            | type_done
            | move_done
        )
        str_len16 = u16_span(str_start, str_start + v)
        blk_len = torch.where(
            is_str,
            str_len16,
            torch.where(
                list_done,
                regs["vals_n"],
                torch.where(on(ST_SPAN1) | on(ST_FMT_VAL) | type_done | move_done, 1, v),
            ),
        )
        block_end = emit_row_st | empty_list
        blocks_left2 = upd(regs["blocks_left"], block_end, regs["blocks_left"] - 1)
        empty_client = on(ST_CLOCK) & (regs["blocks_left"] == 0)
        client_done = (block_end & (blocks_left2 == 0)) | empty_client
        clients_left2 = upd(regs["clients_left"], client_done, regs["clients_left"] - 1)
        after_block = torch.where(
            blocks_left2 > 0,
            ST_INFO,
            torch.where(clients_left2 > 0, ST_NBLOCKS, ST_DS_NCLIENTS),
        )

        ds_done_range = on(ST_DS_LEN)
        ds_ranges_left2 = upd(regs["ds_ranges_left"], ds_done_range, regs["ds_ranges_left"] - 1)
        ds_client_done = (ds_done_range & (ds_ranges_left2 == 0)) | (
            on(ST_DS_NRANGES) & (v == 0)
        )
        ds_clients_left2 = upd(
            regs["ds_clients_left"], ds_client_done, regs["ds_clients_left"] - 1
        )
        after_ds_range = torch.where(
            ds_ranges_left2 > 0,
            ST_DS_CLOCK,
            torch.where(ds_clients_left2 > 0, ST_DS_CLIENT, ST_DONE),
        )

        # --- content dispatch after the last pre-content field -----------
        kind4 = regs["info"] & 0b1111
        content_st = full(ST_ERR)
        for kind, state in (
            (CONTENT_MOVE, ST_MV_FLAGS),
            (CONTENT_TYPE, ST_TYPE_TAG),
            (CONTENT_FORMAT, ST_FMT_KEY),
            (CONTENT_BINARY, ST_SPAN1),
            (CONTENT_EMBED, ST_SPAN1),
            (CONTENT_JSON, ST_JSON_COUNT),
            (CONTENT_ANY, ST_ANY_COUNT),
            (CONTENT_STRING, ST_STR),
            (CONTENT_DELETED, ST_DEL_LEN),
        ):
            content_st = torch.where(kind4 == kind, state, content_st)
        content_unsupported = content_st == ST_ERR
        has_psub = ((regs["info"] & 0xC0) == 0) & ((regs["info"] & 0x20) != 0)
        after_parent = torch.where(has_psub, full(ST_PARENT_SUB), content_st)

        # --- next state -----------------------------------------------------
        nclients_hdr = on(ST_NCLIENTS)
        info_gc = on(ST_INFO) & (v == BLOCK_GC)
        info_skip = on(ST_INFO) & (v == BLOCK_SKIP)
        info_item = on(ST_INFO) & ~info_gc & ~info_skip
        item_next = torch.where(
            (v & 0x80) != 0,
            ST_ORIGIN_C,
            torch.where((v & 0x40) != 0, ST_ROR_C, ST_PARENT_INFO),
        )

        st2 = st
        st2 = upd(st2, nclients_hdr, torch.where(v > 0, ST_NBLOCKS, ST_DS_NCLIENTS))
        st2 = upd(st2, on(ST_NBLOCKS), ST_CLIENT)
        st2 = upd(st2, on(ST_CLIENT), ST_CLOCK)
        st2 = upd(
            st2,
            on(ST_CLOCK),
            torch.where(
                regs["blocks_left"] > 0,
                ST_INFO,
                torch.where(clients_left2 > 0, ST_NBLOCKS, ST_DS_NCLIENTS),
            ),
        )
        st2 = upd(st2, info_gc, ST_GC_LEN)
        st2 = upd(st2, info_skip, ST_SKIP_LEN)
        st2 = upd(st2, info_item, item_next)
        st2 = upd(st2, on(ST_ORIGIN_C), ST_ORIGIN_K)
        st2 = upd(
            st2,
            on(ST_ORIGIN_K),
            torch.where((regs["info"] & 0x40) != 0, full(ST_ROR_C), content_st),
        )
        st2 = upd(st2, on(ST_ROR_C), ST_ROR_K)
        st2 = upd(st2, on(ST_ROR_K), content_st)
        st2 = upd(st2, on(ST_PARENT_INFO), torch.where(v == 1, ST_PARENT_NAME, ST_PARENT_ID_C))
        st2 = upd(st2, on(ST_PARENT_NAME), after_parent)
        st2 = upd(st2, on(ST_PARENT_ID_C), ST_PARENT_ID_K)
        st2 = upd(st2, on(ST_PARENT_ID_K), after_parent)
        st2 = upd(st2, on(ST_PARENT_SUB), content_st)
        st2 = upd(st2, on(ST_ANY_COUNT) & (v > 0), ST_ANY_VAL)
        st2 = upd(st2, map_open, ST_ANY_MKEY)
        st2 = upd(st2, on(ST_ANY_MKEY), ST_ANY_MVAL)
        st2 = upd(st2, on(ST_ANY_MVAL) & ~map_done, ST_ANY_MKEY)
        st2 = upd(st2, map_done & (vals_left2 > 0), ST_ANY_VAL)
        st2 = upd(st2, on(ST_JSON_COUNT) & (v > 0), ST_JSON_VAL)
        st2 = upd(st2, on(ST_FMT_KEY), ST_FMT_VAL)
        st2 = upd(st2, type_named, ST_TYPE_NAME)
        st2 = upd(st2, on(ST_MV_FLAGS), ST_MV_SC)
        st2 = upd(st2, on(ST_MV_SC), ST_MV_SK)
        st2 = upd(st2, on(ST_MV_SK) & ~mv_collapsed, ST_MV_EC)
        st2 = upd(st2, on(ST_MV_EC), ST_MV_EK)
        st2 = upd(st2, block_end, after_block)
        st2 = upd(st2, on(ST_DS_NCLIENTS), torch.where(v > 0, ST_DS_CLIENT, ST_DONE))
        st2 = upd(st2, on(ST_DS_CLIENT), ST_DS_NRANGES)
        st2 = upd(
            st2,
            on(ST_DS_NRANGES),
            torch.where(
                v > 0,
                ST_DS_CLOCK,
                torch.where(ds_clients_left2 > 0, ST_DS_CLIENT, ST_DONE),
            ),
        )
        st2 = upd(st2, on(ST_DS_CLOCK), ST_DS_LEN)
        st2 = upd(st2, ds_done_range, after_ds_range)

        unsupported = (
            (on(ST_ORIGIN_K) & ((regs["info"] & 0x40) == 0) & content_unsupported)
            | (on(ST_ROR_K) & content_unsupported)
            | ((on(ST_PARENT_NAME) | on(ST_PARENT_ID_K)) & ~has_psub & content_unsupported)
            | (on(ST_PARENT_SUB) & content_unsupported)
            | (act & key_too_long)
            | (act & any_bad_tag)
            | (on(ST_TYPE_TAG) & ((v == 7) | (v >= 8)))
        )
        st2 = upd(st2, unsupported, ST_ERR)
        st2 = upd(st2, bad, ST_ERR)

        # --- registers ------------------------------------------------------
        regs2 = dict(regs)
        regs2["pos"] = torch.where(act, pos_after, pos)
        regs2["st"] = st2
        regs2["clients_left"] = upd(clients_left2, nclients_hdr, v)
        regs2["blocks_left"] = upd(blocks_left2, on(ST_NBLOCKS), v)
        regs2["client"] = upd(regs["client"], on(ST_CLIENT), vc)
        clock2 = upd(regs["clock"], on(ST_CLOCK), v)
        regs2["clock"] = wrap32(upd(clock2, block_end, clock2 + blk_len))
        regs2["keyh"] = upd(upd(regs["keyh"], on(ST_INFO), -1), on(ST_PARENT_SUB), khash)
        regs2["rooth"] = upd(
            upd(regs["rooth"], on(ST_INFO), -1),
            on(ST_PARENT_NAME),
            torch.where(v <= KEY_HASH_BYTES, khash, -2),
        )
        count_st = on(ST_ANY_COUNT) | on(ST_JSON_COUNT)
        regs2["vals_n"] = upd(regs["vals_n"], count_st, v)
        regs2["vals_left"] = upd(vals_left2, count_st, v)
        regs2["cref"] = upd(regs["cref"], count_st | on(ST_FMT_KEY) | on(ST_TYPE_TAG), pos)
        regs2["info"] = upd(regs["info"], on(ST_INFO), v)
        fresh = on(ST_INFO)
        regs2["oc"] = upd(upd(regs["oc"], fresh, -1), on(ST_ORIGIN_C), vc)
        regs2["ok"] = upd(upd(regs["ok"], fresh, 0), on(ST_ORIGIN_K), v)
        regs2["rc"] = upd(upd(regs["rc"], fresh, -1), on(ST_ROR_C), vc)
        regs2["rk"] = upd(upd(regs["rk"], fresh, 0), on(ST_ROR_K), v)
        ptag2 = upd(regs["ptag"], fresh, 0)
        regs2["ptag"] = upd(ptag2, on(ST_PARENT_INFO), torch.where(v == 1, 1, 2))
        regs2["pc"] = upd(upd(regs["pc"], fresh, -1), on(ST_PARENT_ID_C), vc)
        regs2["pk"] = upd(upd(regs["pk"], fresh, 0), on(ST_PARENT_ID_K), v)
        regs2["ds_clients_left"] = upd(ds_clients_left2, on(ST_DS_NCLIENTS), v)
        regs2["ds_ranges_left"] = upd(ds_ranges_left2, on(ST_DS_NRANGES), v)
        regs2["ds_client"] = upd(regs["ds_client"], on(ST_DS_CLIENT), vc)
        regs2["ds_clock"] = upd(regs["ds_clock"], on(ST_DS_CLOCK), v)
        regs2["mpairs"] = upd(mpairs2, map_open, val2)
        regs2["mvf"] = upd(regs["mvf"], on(ST_MV_FLAGS), v)
        regs2["msc"] = upd(regs["msc"], on(ST_MV_SC), vc)
        regs2["msk"] = upd(regs["msk"], on(ST_MV_SK), v)
        regs2["mec"] = upd(regs["mec"], on(ST_MV_EC), vc)

        flags2 = (
            regs["flags"]
            | torch.where(bad, FLAG_MALFORMED, 0)
            | torch.where(unsupported, FLAG_UNSUPPORTED, 0)
            | torch.where(nclients_hdr & (v > 1), FLAG_MULTI_CLIENT, 0)
        )

        # --- row / delete-range emission -----------------------------------
        emit = emit_row_st & ~on(ST_SKIP_LEN) & (blk_len > 0)
        row_ovf = emit & (regs["n_rows"] >= U)
        emit = emit & ~row_ovf
        oh = (iota_u == regs["n_rows"][:, None]) & emit[:, None]

        def put_row(name, vec):
            rows[name] = torch.where(oh, vec[:, None], rows[name])

        is_gc_row = on(ST_GC_LEN)
        row_kind = torch.where(is_gc_row, BLOCK_GC, torch.where(is_str, CONTENT_STRING, kind4))
        row_ref = torch.where(
            is_str,
            row_ids * L + str_start,
            torch.where(
                list_done | on(ST_FMT_VAL) | on(ST_TYPE_NAME),
                row_ids * L + regs["cref"],
                torch.where(on(ST_SPAN1) | on(ST_TYPE_TAG), row_ids * L + pos, -1),
            ),
        )
        put_row("client", regs["client"])
        put_row("clock", regs["clock"])
        put_row("length", blk_len)
        put_row("oc", torch.where(is_gc_row, -1, regs["oc"]))
        put_row("ok", torch.where(is_gc_row, 0, regs["ok"]))
        put_row("rc", torch.where(is_gc_row, -1, regs["rc"]))
        put_row("rk", torch.where(is_gc_row, 0, regs["rk"]))
        put_row("kind", row_kind)
        put_row("ref", row_ref)
        put_row("ptag", torch.where(is_gc_row, 0, regs["ptag"]))
        put_row("pc", torch.where(is_gc_row, -1, regs["pc"]))
        put_row("pk", torch.where(is_gc_row, 0, regs["pk"]))
        put_row("keyh", torch.where(is_gc_row, -1, regs["keyh"]))
        put_row("rooth", torch.where(is_gc_row, -1, regs["rooth"]))
        # ContentMove range fields: assoc 0 = After, -1 = Before; a
        # collapsed move's end id is its start id
        mvf = regs["mvf"]
        msa = torch.where((mvf & 2) != 0, 0, -1)
        mea = torch.where((mvf & 4) != 0, 0, -1)
        msk_cur = torch.where(on(ST_MV_SK), v, regs["msk"])
        mv_end_c = torch.where(mv_collapsed, regs["msc"], regs["mec"])
        put_row("msc", torch.where(move_done, regs["msc"], -1))
        put_row("msk", torch.where(move_done, msk_cur, 0))
        put_row("msa", torch.where(move_done, msa, 0))
        put_row("mec", torch.where(move_done, mv_end_c, -1))
        put_row("mek", torch.where(move_done, v, 0))
        put_row("mea", torch.where(move_done, mea, 0))
        put_row("mprio", torch.where(move_done, mvf >> 6, -1))
        rows["valid"] = rows["valid"] | oh
        regs2["n_rows"] = regs["n_rows"] + emit.to(I64)

        emit_d = ds_done_range & (v > 0)
        del_ovf = emit_d & (regs["n_dels"] >= R)
        emit_d = emit_d & ~del_ovf
        ohd = (iota_r == regs["n_dels"][:, None]) & emit_d[:, None]
        dels["client"] = torch.where(ohd, regs["ds_client"][:, None], dels["client"])
        dels["start"] = torch.where(ohd, regs["ds_clock"][:, None], dels["start"])
        dels["end"] = torch.where(ohd, wrap32(regs["ds_clock"] + v)[:, None], dels["end"])
        dels["valid"] = dels["valid"] | ohd
        regs2["n_dels"] = regs["n_dels"] + emit_d.to(I64)

        regs2["flags"] = flags2 | torch.where(row_ovf | del_ovf, FLAG_OVERFLOW, 0)
        regs = regs2

    flags = regs["flags"] | torch.where(regs["st"] != ST_DONE, FLAG_MALFORMED, 0)
    return rows, dels, flags


#: C signature of ``csrc/decode.cu``'s entry point
DECODE_SIGNATURES = {
    "ytpu_decode_v1": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_longlong]
    + [ctypes.c_void_p] * 7,
}


def _decode_lib():
    """The built decode library with its C signatures declared."""
    from ytpu_torch.ops import _build

    return _build.bind("decode", DECODE_SIGNATURES, "ytpu_cuda_error_string")


def _launch_decode(lib, buf, lens, U: int, R: int, T: int, max_sec: int, stream, steps: bool = False):
    """One launch of the decode kernel in `lib` over contiguous ``buf``
    ``[S, L]`` uint8 and ``lens`` ``[S]`` int64, outputs allocated on their
    device; `stream` is the CUDA stream handle (None in a host build).
    Returns ``(rows, dels, flags, steps)``, ``steps`` each lane's step
    count (int32) when asked for, else None."""
    from ytpu_torch.ops import _build

    dev = buf.device
    S, L = buf.shape
    rows_t = torch.empty((len(ROW_COLUMNS), S, U), dtype=I64, device=dev)
    rvalid = torch.empty((S, U), dtype=torch.bool, device=dev)
    dels_t = torch.empty((len(DEL_COLUMNS), S, R), dtype=I64, device=dev)
    dvalid = torch.empty((S, R), dtype=torch.bool, device=dev)
    flags = torch.empty((S,), dtype=I64, device=dev)
    steps_t = torch.empty((S,), dtype=I32, device=dev) if steps else None
    err = lib.ytpu_decode_v1(
        buf.data_ptr(), lens.data_ptr(), S, L, U, R, T, max_sec, rows_t.data_ptr(), rvalid.data_ptr(),
        dels_t.data_ptr(), dvalid.data_ptr(), flags.data_ptr(),
        None if steps_t is None else steps_t.data_ptr(), stream,
    )
    _build.check(lib, err, "decode kernel")
    rows = dict(zip(ROW_COLUMNS, rows_t.unbind(0)), valid=rvalid)
    dels = dict(zip(DEL_COLUMNS, dels_t.unbind(0)), valid=dvalid)
    return rows, dels, flags, steps_t


def _decode_kernel(buf, lens, U: int, R: int, T: int, max_sec: int, steps: bool = False):
    """The kernel on CUDA tensors, on the current stream: the pre-resolve
    ``(rows, dels, flags)`` of `_decode_loop_reference`, plus each lane's
    step count when `steps` is set. Not counted in
    ``decode_updates_v1.launches``."""
    if buf.dtype != torch.uint8 or buf.dim() != 2:
        raise ValueError(f"the decode kernel takes an [S, L] uint8 matrix, got {buf.dtype} {tuple(buf.shape)}")
    dev = buf.device
    if dev.type != "cuda":
        raise ValueError(f"the decode kernel runs on cuda tensors, not {dev}")
    buf = buf.contiguous()
    lens = lens.to(device=dev, dtype=I64).contiguous()
    if tuple(lens.shape) != (buf.shape[0],):
        raise ValueError(f"lens {tuple(lens.shape)} does not match {buf.shape[0]} lanes")
    stream = torch.cuda.current_stream(dev).cuda_stream
    return _launch_decode(_decode_lib(), buf, lens, int(U), int(R), int(T), int(max_sec), stream, steps)


_ID_COLUMNS = ("client", "oc", "rc", "pc", "msc", "mec")


def _table(t, device):
    """A ``(sorted keys, perm)`` table as int64 tensors on `device`, or
    None for no table."""
    if t is None:
        return None
    keys, perm = t
    return (torch.as_tensor(keys, device=device).to(I64).reshape(-1).contiguous(),
            torch.as_tensor(perm, device=device).to(I64).reshape(-1))


def _lookup(table, arr):
    """``(j, hit)``: where `arr`'s entries would sit in the table's sorted
    keys (clamped into it) and whether the key there equals them."""
    keys = table[0]
    j = torch.searchsorted(keys, arr.contiguous()).clamp(0, keys.numel() - 1)
    return j, keys[j] == arr


def _resolve_and_pack(rows, dels, flags, client_table=None, key_table=None,
                      client_hash_table=None, primary_root_hash=None):
    """Post-decode pass: raw client ids -> interned indices
    (`client_table`), big-client hash entries -> indices
    (`client_hash_table`, else FLAG_BIG_CLIENT), parent_sub hashes -> key
    indices (`key_table`, else FLAG_UNKNOWN_KEY), named roots -> the
    implicit branch or an anchor's key id (`primary_root_hash`), then
    error lanes lose their rows and the columns pack into an int32
    UpdateBatch."""
    S, U = rows["client"].shape
    dev = flags.device
    none = torch.zeros((S,), dtype=torch.bool, device=dev)
    valid = rows["valid"]

    def where_flag(cond, flag):
        return torch.where(cond, flag, 0)

    ct = _table(client_table, dev)
    if ct is not None and ct[0].numel() == 0:
        # an empty raw table: only lanes using raw (>= 0) ids are unknown;
        # hashed big-client entries (<= -2) resolve below
        raw_used = (dels["valid"] & (dels["client"] >= 0)).any(dim=1)
        for name in _ID_COLUMNS:
            raw_used = raw_used | (valid & (rows[name] >= 0)).any(dim=1)
        flags = flags | where_flag(raw_used, FLAG_UNKNOWN_CLIENT)
        ct = None
    if ct is not None:
        perm = ct[1]

        def map_ids(arr, used):
            j, hit = _lookup(ct, arr)
            hit = hit & (arr >= 0)
            out = torch.where(hit, perm[j], torch.where(arr <= -2, arr, -1))
            return out, (used & (arr >= 0) & ~hit).any(dim=1)

        unk = none
        for name in _ID_COLUMNS:
            rows[name], u = map_ids(rows[name], valid)
            unk = unk | u
        dels["client"], u = map_ids(dels["client"], dels["valid"])
        flags = flags | where_flag(unk | u, FLAG_UNKNOWN_CLIENT)

    cht = _table(client_hash_table, dev)
    if cht is not None and cht[0].numel() == 0:
        cht = None

    def map_hashed(arr, used):
        hashed = arr <= -2
        if cht is None:
            return arr, (used & hashed).any(dim=1), none
        j, hit = _lookup(cht, -2 - arr)
        hit = hit & hashed
        return torch.where(hit, cht[1][j], arr), none, (used & hashed & ~hit).any(dim=1)

    bigf, unkh = none, none
    for name, arr, used in [(n, rows[n], valid) for n in _ID_COLUMNS] + [
            ("del", dels["client"], dels["valid"])]:
        out, b, m = map_hashed(arr, used)
        if name == "del":
            dels["client"] = out
        else:
            rows[name] = out
        bigf, unkh = bigf | b, unkh | m
    flags = flags | where_flag(bigf, FLAG_BIG_CLIENT) | where_flag(unkh, FLAG_UNKNOWN_CLIENT)

    # parent_sub key hashes -> interned key indices (map rows)
    has_key = valid & (rows["keyh"] >= 0)
    key_col = torch.full((S, U), -1, dtype=I64, device=dev)
    key_miss = has_key
    kt = _table(key_table, dev)
    if kt is not None and kt[0].numel() == 0:
        kt = None
    if kt is not None:
        j, hit = _lookup(kt, rows["keyh"])
        hit = has_key & hit
        key_col = torch.where(hit, kt[1][j], -1)
        key_miss = has_key & ~hit
    flags = flags | where_flag(key_miss.any(dim=1), FLAG_UNKNOWN_KEY)

    # named-root parents of multi-root docs: the lane's primary root maps
    # to the implicit branch (p_root -1), other names through the key
    # table to their anchor's key id
    p_root_col = torch.full((S, U), -1, dtype=I64, device=dev)
    if primary_root_hash is not None:
        rooth = rows["rooth"]
        prim = torch.as_tensor(primary_root_hash, device=dev).to(I64).reshape(-1)[:, None]
        named = valid & (rows["ptag"] == 1) & (prim >= 0)
        nonprim = named & (rooth >= 0) & (rooth != prim)
        root_miss = nonprim
        if kt is not None:
            j, hit = _lookup(kt, rooth)
            hit = nonprim & hit
            p_root_col = torch.where(hit, kt[1][j], -1)
            root_miss = nonprim & ~hit
        flags = (flags | where_flag(root_miss.any(dim=1), FLAG_UNKNOWN_KEY)
                 | where_flag((named & (rooth == -2)).any(dim=1), FLAG_UNSUPPORTED))

    lane_ok = (flags & FLAG_ERRORS) == 0
    valid = rows["valid"] & lane_ok[:, None]
    dvalid = dels["valid"] & lane_ok[:, None]

    def i32(x):
        return x.to(I32)

    z_u = torch.zeros((S, U), dtype=I32, device=dev)
    stream = UpdateBatch(
        client=i32(rows["client"]),
        clock=i32(rows["clock"]),
        length=i32(rows["length"]),
        origin_client=i32(rows["oc"]),
        origin_clock=i32(rows["ok"]),
        ror_client=i32(rows["rc"]),
        ror_clock=i32(rows["rk"]),
        kind=i32(rows["kind"]),
        content_ref=i32(rows["ref"]),
        content_off=z_u,
        key=i32(key_col),
        p_tag=i32(rows["ptag"]),
        p_client=i32(rows["pc"]),
        p_clock=i32(rows["pk"]),
        p_root=i32(p_root_col),
        mv_sc=i32(rows["msc"]),
        mv_sk=i32(rows["msk"]),
        mv_sa=i32(rows["msa"]),
        mv_ec=i32(rows["mec"]),
        mv_ek=i32(rows["mek"]),
        mv_ea=i32(rows["mea"]),
        mv_prio=i32(rows["mprio"]),
        valid=valid,
        del_client=i32(dels["client"]),
        del_start=i32(dels["start"]),
        del_end=i32(dels["end"]),
        del_valid=dvalid,
    )
    return stream, flags.to(I32)
