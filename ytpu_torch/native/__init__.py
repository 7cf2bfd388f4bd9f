"""The port's host C++: the lib0 column walk and the batched wire finisher.

The host library ``native`` is compiled by g++ from ``lib0_codec.cpp`` and
``encode_finisher.cpp`` (copies of the JAX package's
``ytpu/native/lib0_codec.cpp`` and ``encode_finisher.cpp``) at first use,
into ``ytpu_torch/_build/`` (`ytpu_torch.ops._build`). A failed build
raises: no Python path stands in for a missing library. `load` builds and
binds it once.

- `decode_update_columns(payload)`: one v1 update walked into the port's
  `encoding.lib0.UpdateColumns` (the columns and counts of
  `encoding.lib0.update_columns`, its plain version; on malformed input
  the native walk also keeps the block it failed in).
- `decode_update_columns_batch(payloads)`: N updates walked out of one byte
  arena in one call and lifted with one copy, as a `ColumnBatch`.
- `FinishIn` and `finish_strided`: the finisher's input struct (its size
  checked against the library's before anything binds) and its one call
  over a packed ``[Dsel, 15, R]`` host tensor; `models.batch_doc` builds
  the struct.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ytpu_torch.encoding.lib0 import BLOCK_COLUMNS, DEL_COLUMNS, UpdateColumns

__all__ = [
    "COUNT_NAMES",
    "ColumnBatch",
    "FinishIn",
    "decode_update_columns",
    "decode_update_columns_batch",
    "finish_strided",
    "load",
]

#: the columns of the per-update count table, in the library's order
COUNT_NAMES = ("n_blocks", "n_dels", "n_client_sections", "n_ds_sections", "n_zero_len_blocks",
               "n_value_steps", "n_complex_any", "error")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p


class FinishIn(ctypes.Structure):
    """Mirror of `FinishIn` in encode_finisher.cpp (field order must match;
    `load` refuses to bind unless both sizes agree)."""

    _fields_ = [
        ("n_docs_total", ctypes.c_int32),
        ("n_blocks_cap", ctypes.c_int32),
        ("client", ctypes.POINTER(ctypes.c_int32)),
        ("clock", ctypes.POINTER(ctypes.c_int32)),
        ("length", ctypes.POINTER(ctypes.c_int32)),
        ("origin_client", ctypes.POINTER(ctypes.c_int32)),
        ("origin_clock", ctypes.POINTER(ctypes.c_int32)),
        ("ror_client", ctypes.POINTER(ctypes.c_int32)),
        ("ror_clock", ctypes.POINTER(ctypes.c_int32)),
        ("kind", ctypes.POINTER(ctypes.c_int32)),
        ("content_ref", ctypes.POINTER(ctypes.c_int32)),
        ("content_off", ctypes.POINTER(ctypes.c_int32)),
        ("key", ctypes.POINTER(ctypes.c_int32)),
        ("parent", ctypes.POINTER(ctypes.c_int32)),
        ("ship", ctypes.POINTER(ctypes.c_int32)),
        ("offsets", ctypes.POINTER(ctypes.c_int32)),
        ("deleted", ctypes.POINTER(ctypes.c_int32)),
        ("sel", ctypes.POINTER(ctypes.c_int32)),
        ("n_sel", ctypes.c_int32),
        ("from_idx", ctypes.POINTER(ctypes.c_int64)),
        ("n_interned", ctypes.c_int32),
        ("key_blob", ctypes.POINTER(ctypes.c_uint8)),
        ("key_off", ctypes.POINTER(ctypes.c_int64)),
        ("n_keys", ctypes.c_int32),
        ("root_name", ctypes.POINTER(ctypes.c_uint8)),
        ("root_name_len", ctypes.c_int32),
        ("text_arena", ctypes.POINTER(ctypes.c_uint8)),
        ("text_arena_len", ctypes.c_int64),
        ("item_text_off", ctypes.POINTER(ctypes.c_int64)),
        ("item_text_units", ctypes.POINTER(ctypes.c_int64)),
        ("blob_arena", ctypes.POINTER(ctypes.c_uint8)),
        ("blob_arena_len", ctypes.c_int64),
        ("item_blob_off", ctypes.POINTER(ctypes.c_int64)),
        ("item_blob_len", ctypes.POINTER(ctypes.c_int64)),
        ("item_elem_base", ctypes.POINTER(ctypes.c_int64)),
        ("item_elem_count", ctypes.POINTER(ctypes.c_int64)),
        ("elem_off", ctypes.POINTER(ctypes.c_int64)),
        ("elem_arena", ctypes.POINTER(ctypes.c_uint8)),
        ("elem_arena_len", ctypes.c_int64),
        ("n_items", ctypes.c_int64),
        ("wire", ctypes.POINTER(ctypes.c_uint8)),
        ("wire_len", ctypes.c_int64),
    ]


_SIGNATURES = {
    # name: (restype, argtypes)
    "ytpu_walk_batch": (_P, [ctypes.c_char_p, _P, _P, ctypes.c_int64, _P]),
    "ytpu_walk_take": (None, [_P, _P, _P, _P]),
    "ytpu_walk_free": (None, [_P]),
    "ytpu_finish_in_sizeof": (ctypes.c_int64, []),
    "ytpu_finish_batch_strided": (_P, [ctypes.POINTER(FinishIn), ctypes.c_int64, ctypes.c_int32]),
    "ytpu_finish_data": (_P, [_P]),
    "ytpu_finish_total_len": (ctypes.c_int64, [_P]),
    "ytpu_finish_spans": (None, [_P, _P, _P, _P]),
    "ytpu_finish_free": (None, [_P]),
}


def load() -> ctypes.CDLL:
    """The host library, built first if needed, its C entries typed. Raises
    if it does not build or if its `FinishIn` differs in size from the
    ctypes mirror (a field added or reordered on one side would corrupt
    memory)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            from ytpu_torch.ops import _build

            lib = _build.load("native")
            for fn, (res, args) in _SIGNATURES.items():
                getattr(lib, fn).restype = res
                getattr(lib, fn).argtypes = args
            size = int(lib.ytpu_finish_in_sizeof())
            if size != ctypes.sizeof(FinishIn):
                raise RuntimeError(f"FinishIn is {size} bytes in the library, {ctypes.sizeof(FinishIn)} in ctypes")
            _lib = lib
    return _lib


_BLOCK_ROW = {name: j for j, name in enumerate(BLOCK_COLUMNS)}
_DEL_ROW = {name: j for j, name in enumerate(DEL_COLUMNS)}


class ColumnBatch:
    """The columns of N walked updates, lifted from the library in one copy:
    `blocks` ``[17, total blocks]`` and `dels` ``[3, total ranges]`` int64,
    one row per column of `BLOCK_COLUMNS` / `DEL_COLUMNS`, each update's
    rows together in update order; `counts` ``[N, 8]`` uint64 per update
    (`COUNT_NAMES`; uint64 as the library counts them); `block_off` and
    `del_off` ``[N + 1]`` each update's first row; `arena` the updates'
    bytes concatenated, update i from byte `offs[i]`. Item i is update i's
    `UpdateColumns`, its columns views into these arrays, each sliced at
    its first read."""

    def __init__(self, payloads: Sequence[bytes], arena: bytes, offs: np.ndarray, blocks: np.ndarray,
                 dels: np.ndarray, counts: np.ndarray):
        self.payloads = payloads
        self.arena = arena
        self.offs = offs
        self.blocks = blocks
        self.dels = dels
        self.counts = counts
        n = len(payloads)
        self.block_off = np.zeros(n + 1, dtype=np.int64)
        self.del_off = np.zeros(n + 1, dtype=np.int64)
        self.block_off[1:] = np.cumsum(counts[:, 0])
        self.del_off[1:] = np.cumsum(counts[:, 1])
        self._rows: Optional[Tuple[list, list]] = None

    def __len__(self) -> int:
        return len(self.payloads)

    def __getitem__(self, i: int) -> UpdateColumns:
        if self._rows is None:
            self._rows = (self.counts.tolist(), self.block_off.tolist())
        counts, boff = self._rows
        return _BatchColumns(self, i, counts[i], boff[i])

    def __iter__(self):
        return (self[i] for i in range(len(self)))


class _BatchColumns(UpdateColumns):
    """One update of a `ColumnBatch`: its counts set, each column sliced out
    of the batch's arrays when first read."""

    def __init__(self, batch: ColumnBatch, i: int, counts: list, block0: int):
        d = self.__dict__
        d["payload"] = batch.payloads[i]
        d.update(zip(COUNT_NAMES, counts))
        d["error"] = bool(counts[7])
        d["_batch"], d["_i"], d["_block0"] = batch, i, block0

    def __getattr__(self, name: str):
        j = _BLOCK_ROW.get(name)
        if j is not None:
            b0 = self._block0
            col = self._batch.blocks[j, b0:b0 + self.n_blocks]
        elif name in _DEL_ROW:
            d0 = int(self._batch.del_off[self._i])
            col = self._batch.dels[_DEL_ROW[name], d0:d0 + self.n_dels]
        else:
            raise AttributeError(name)
        self.__dict__[name] = col
        return col


def decode_update_columns_batch(payloads: Sequence[bytes]) -> ColumnBatch:
    """Walk every v1 update of `payloads` in one native call over their
    concatenation; spans (``*_start``) index each update's own bytes."""
    lib = load()
    payloads = list(payloads)
    n = len(payloads)
    lens = np.fromiter((len(p) for p in payloads), dtype=np.int64, count=n)
    offs = np.zeros(n, dtype=np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    arena = b"".join(payloads)
    totals = np.zeros(2, dtype=np.int64)
    handle = lib.ytpu_walk_batch(arena, offs.ctypes.data, lens.ctypes.data, n, totals.ctypes.data)
    try:
        counts = np.empty((n, len(COUNT_NAMES)), dtype=np.uint64)
        blocks = np.empty((len(BLOCK_COLUMNS), int(totals[0])), dtype=np.int64)
        dels = np.empty((len(DEL_COLUMNS), int(totals[1])), dtype=np.int64)
        lib.ytpu_walk_take(handle, counts.ctypes.data, blocks.ctypes.data, dels.ctypes.data)
    finally:
        lib.ytpu_walk_free(handle)
    return ColumnBatch(payloads, arena, offs, blocks, dels, counts)


def decode_update_columns(payload: bytes) -> UpdateColumns:
    """One v1 update walked natively: a batch of one."""
    return decode_update_columns_batch([payload])[0]


def finish_strided(fin: FinishIn, doc_stride: int, n_threads: int) -> Tuple[bytes, List[int], List[int], List[int]]:
    """One finisher call over the packed rows `fin` points at (docs
    `doc_stride` int32s apart; `n_threads` 0 = a pool of hardware
    concurrency, 1 = this thread): ``(output bytes, offsets, lengths,
    statuses)``, one entry per selected doc, status 0 where the library
    wrote the doc and 1 where it leaves the doc to the Python finisher."""
    lib = load()
    n = int(fin.n_sel)
    handle = lib.ytpu_finish_batch_strided(ctypes.byref(fin), doc_stride, n_threads)
    try:
        offs = np.empty(n, dtype=np.int64)
        lens = np.empty(n, dtype=np.int64)
        stat = np.empty(n, dtype=np.int32)
        lib.ytpu_finish_spans(handle, offs.ctypes.data, lens.ctypes.data, stat.ctypes.data)
        total = int(lib.ytpu_finish_total_len(handle))
        blob = ctypes.string_at(lib.ytpu_finish_data(handle), total) if total else b""
    finally:
        lib.ytpu_finish_free(handle)
    return blob, offs.tolist(), lens.tolist(), stat.tolist()
