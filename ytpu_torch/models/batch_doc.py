"""Batched block-state layout, the sync step and host read-out (PyTorch
port of `ytpu.models.batch_doc`).

The layout part mirrors the JAX module name for name: `BlockCols` /
`DocStateBatch` / `UpdateBatch` are NamedTuples of tensors, `init_state`
allocates an empty doc batch on an explicit device, and the scan-record
and commitment helpers are the same functions over torch tensors.

The sync step: the write path `apply_update_batch` (one update per doc)
and `apply_update_stream` run the CUDA integrate kernel
(`ops.integrate_kernel`); the origin-slot cache they leave stale is
rebuilt by `recompute_origin_slot`. The read path is `state_vectors` and
`encode_diff_batch` (torch ops on the device), the row compaction
`compact_finisher_rows` (device), and the host finisher that writes the v1
wire bytes (`finish_encode_diff`, `finish_encode_diff_batch`, and
`DiffPipeline`, which overlaps the device half of sub-batch k+1 with the
finisher of sub-batch k). The batched entries write every doc in one call
of the port's host C++ finisher (`ytpu_torch.native`, through
`_FinisherContext`); a doc the library leaves alone, and every doc of a
payload view it cannot read (`RawPayloadView`, `UnitArenaView`), is
written by the Python finisher `_finish_rows`, and counted in
`DiffStats.fallback_docs`. The interners and the payload store are the
host tables of ytpu's `BatchEncoder` that the finisher reads
(`EncoderTables`); `BatchEncoder` plans host-decoded `Update`s into
batches over them. Root anchors (`ensure_root_anchor`,
`ensure_root_anchor_all`) are torch ops on a `DocStateBatch`. The
read-out part (`get_string`, `get_values`, `get_map`, `get_tree`,
`_visible_walk`, `_move_bounds`) runs on the host over numpy copies of
the columns.

uint32 arithmetic (the commitment fold) is emulated in int64 with
``& 0xFFFFFFFF`` masks: torch has no general uint32 arithmetic.
"""

from __future__ import annotations

import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ytpu_torch import native
from ytpu_torch.core.content import (
    BLOCK_GC,
    BLOCK_ROOT_ANCHOR,
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

__all__ = [
    "BlockCols",
    "DocStateBatch",
    "UpdateBatch",
    "COL_DEFAULTS",
    "init_state",
    "mark_origin_slot_stale",
    "origin_slot_is_stale",
    "recompute_origin_slot",
    "ensure_origin_slot",
    "apply_update_batch",
    "apply_update_stream",
    "apply_update_stream_fused",
    "apply_update_stream_raw",
    "state_vectors",
    "encode_diff_batch",
    "state_capacity_ledger",
    "Diff",
    "get_diff",
    "ClientInterner",
    "KeyInterner",
    "PayloadStore",
    "EncoderTables",
    "BatchEncoder",
    "ensure_root_anchor",
    "ensure_root_anchor_all",
    "finish_encode_diff",
    "compact_finisher_rows",
    "finish_encode_diff_batch",
    "FINISHER_MT_MIN_ROWS",
    "DiffPlan",
    "plan_diff_pipeline",
    "DiffStats",
    "DiffPipeline",
    "CompactionPolicy",
    "DEFAULT_COMPACTION_POLICY",
    "stream_worst_case_adds",
    "SCAN_WIDTH_BUCKETS",
    "SCAN_REC_WORDS",
    "scan_tier_plan",
    "scan_width_bucket",
    "merge_scan_records",
    "scan_width_quantile",
    "commit_fold_blocks",
    "get_string",
    "get_values",
    "get_map",
    "get_tree",
]

I32 = torch.int32
U32_MASK = 0xFFFFFFFF


class BlockCols(NamedTuple):
    """Columnar Item schema; each field is a ``[*, B]`` tensor."""

    client: torch.Tensor  # i32 interned client (-1 = unused slot)
    clock: torch.Tensor
    length: torch.Tensor
    origin_client: torch.Tensor  # -1 = none
    origin_clock: torch.Tensor
    ror_client: torch.Tensor  # right-origin, -1 = none
    ror_clock: torch.Tensor
    left: torch.Tensor  # sequence link (-1 = head)
    right: torch.Tensor  # sequence link (-1 = tail)
    deleted: torch.Tensor  # bool
    countable: torch.Tensor  # bool
    kind: torch.Tensor
    content_ref: torch.Tensor
    content_off: torch.Tensor
    key: torch.Tensor  # interned parent_sub (-1 = sequence item)
    parent: torch.Tensor  # row of the parent ContentType (-1 = root)
    head: torch.Tensor  # child-sequence head for ContentType rows
    moved: torch.Tensor  # slot of the move row owning this row (-1)
    mv_sc: torch.Tensor  # move rows: range-start id client (-1 n/a)
    mv_sk: torch.Tensor
    mv_sa: torch.Tensor  # start assoc (0 after, -1 before)
    mv_ec: torch.Tensor  # range-end id client (-1 n/a)
    mv_ek: torch.Tensor
    mv_ea: torch.Tensor
    mv_prio: torch.Tensor
    origin_slot: torch.Tensor  # cached origin slot (the fused kernel
    # passes this plane through without maintaining it)


class DocStateBatch(NamedTuple):
    blocks: BlockCols
    start: torch.Tensor  # [*] head of the root sequence (-1 empty)
    n_blocks: torch.Tensor  # [*]
    error: torch.Tensor  # [*] sticky error flags (0 = healthy)


class UpdateBatch(NamedTuple):
    """Decoded updates, padded to U rows / R delete ranges per step."""

    client: torch.Tensor  # [*, U]
    clock: torch.Tensor
    length: torch.Tensor
    origin_client: torch.Tensor
    origin_clock: torch.Tensor
    ror_client: torch.Tensor
    ror_clock: torch.Tensor
    kind: torch.Tensor
    content_ref: torch.Tensor
    content_off: torch.Tensor
    key: torch.Tensor
    p_tag: torch.Tensor  # 0 inherit, 1 root, 2 branch id
    p_client: torch.Tensor
    p_clock: torch.Tensor
    p_root: torch.Tensor
    mv_sc: torch.Tensor
    mv_sk: torch.Tensor
    mv_sa: torch.Tensor
    mv_ec: torch.Tensor
    mv_ek: torch.Tensor
    mv_ea: torch.Tensor
    mv_prio: torch.Tensor
    valid: torch.Tensor  # bool
    del_client: torch.Tensor  # [*, R]
    del_start: torch.Tensor
    del_end: torch.Tensor
    del_valid: torch.Tensor  # bool


ERR_CAPACITY = 1
ERR_MISSING_DEP = 2

# empty-slot value per BlockCols field (init_state, compaction fills,
# grow padding)
COL_DEFAULTS: Dict[str, object] = {
    "client": -1,
    "clock": 0,
    "length": 0,
    "origin_client": -1,
    "origin_clock": 0,
    "ror_client": -1,
    "ror_clock": 0,
    "left": -1,
    "right": -1,
    "deleted": False,
    "countable": False,
    "kind": 0,
    "content_ref": -1,
    "content_off": 0,
    "key": -1,
    "parent": -1,
    "head": -1,
    "moved": -1,
    "mv_sc": -1,
    "mv_sk": 0,
    "mv_sa": 0,
    "mv_ec": -1,
    "mv_ek": 0,
    "mv_ea": 0,
    "mv_prio": -1,
    "origin_slot": -1,
}
assert tuple(COL_DEFAULTS) == BlockCols._fields


def init_state(n_docs: int, capacity: int, device=None) -> DocStateBatch:
    """Allocate an empty batch of docs with `capacity` block slots each,
    on the GPU unless `device` says otherwise."""
    device = resolve_device(device)
    shape = (n_docs, capacity)
    blocks = BlockCols(
        **{
            name: torch.full(
                shape, fill,
                dtype=torch.bool if isinstance(fill, bool) else I32,
                device=device,
            )
            for name, fill in COL_DEFAULTS.items()
        }
    )
    return DocStateBatch(
        blocks=blocks,
        start=torch.full((n_docs,), -1, dtype=I32, device=device),
        n_blocks=torch.zeros((n_docs,), dtype=I32, device=device),
        error=torch.zeros((n_docs,), dtype=I32, device=device),
    )


# --- lazy origin_slot refresh ---------------------------------------------------
# The integrate kernel passes the origin_slot plane through without
# maintaining it, so every apply marks its output's plane STALE: a
# host-side flag keyed on the plane tensor's identity, retired by
# `weakref.finalize` when the tensor dies so a recycled id never reads as
# stale. A reader of the plane refreshes it through `ensure_origin_slot`.

_STALE_ORIGIN_SLOT: set = set()


def mark_origin_slot_stale(state: DocStateBatch) -> None:
    """Flag `state.blocks.origin_slot` as stale (fused-lane output)."""
    import weakref

    arr = state.blocks.origin_slot
    key = id(arr)
    if key not in _STALE_ORIGIN_SLOT:
        _STALE_ORIGIN_SLOT.add(key)
        weakref.finalize(arr, _STALE_ORIGIN_SLOT.discard, key)


def origin_slot_is_stale(state: DocStateBatch) -> bool:
    """One set lookup."""
    return id(state.blocks.origin_slot) in _STALE_ORIGIN_SLOT


def _id_key(client: torch.Tensor, clock: torch.Tensor) -> torch.Tensor:
    """int64 key ordering ids by (client, clock) for clients >= 0."""
    return (client.to(torch.int64) << 32) + (clock.to(torch.int64) + (1 << 31))


def recompute_origin_slot(state: DocStateBatch) -> DocStateBatch:
    """Rebuild the `origin_slot` cache plane: for every live row with an
    origin, the slot whose clock range covers (origin_client,
    origin_clock), else -1; -1 for rows past ``n_blocks`` and rows without
    an origin.

    The JAX version compares every row with every row of its doc
    (O(D·B²)). Here each doc's live rows of positive length are sorted by
    (client, clock) and each origin is looked up with one `searchsorted`:
    the last block of that client starting at or before the origin clock
    covers it or nothing does. Blocks of one client never overlap in clock
    (the integrate appends only past a client's clock; splits and
    compaction keep the partition), so the covering slot is unique and
    equals the JAX version's first match."""
    bl = state.blocks
    slots = torch.arange(bl.client.shape[1], device=bl.client.device)
    live = slots[None, :] < state.n_blocks[:, None]
    covers = live & (bl.client >= 0) & (bl.length > 0)
    key = torch.where(covers, _id_key(bl.client, bl.clock), torch.iinfo(torch.int64).max)
    sorted_key, order = torch.sort(key, dim=1, stable=True)
    oc, ok = bl.origin_client, bl.origin_clock
    pos = torch.searchsorted(sorted_key, _id_key(oc, ok).contiguous(), right=True) - 1
    cand = order.gather(1, pos.clamp(min=0))
    c_clock = bl.clock.gather(1, cand)
    hit = (
        (pos >= 0)
        & covers.gather(1, cand)
        & (bl.client.gather(1, cand) == oc)
        & (c_clock <= ok)
        & (ok < c_clock + bl.length.gather(1, cand))
    )
    os_col = torch.where(live & (oc >= 0) & hit, cand.to(I32), torch.full_like(oc, -1))
    return state._replace(blocks=state.blocks._replace(origin_slot=os_col))


def ensure_origin_slot(state: DocStateBatch) -> DocStateBatch:
    """Recompute the cache iff this state was marked stale, so chained
    applies pay the rebuild at most once, on first read."""
    if origin_slot_is_stale(state):
        return recompute_origin_slot(state)
    return state


# --- the write path ------------------------------------------------------------


def _rank_table(client_rank, device) -> torch.Tensor:
    return torch.as_tensor(client_rank, dtype=I32, device=device).reshape(-1).contiguous()


def apply_update_batch(state: DocStateBatch, batch: UpdateBatch, client_rank) -> DocStateBatch:
    """Integrate one decoded update per doc (``batch`` fields ``[D, U]`` /
    ``[D, R]``, doc d gets row d): `pack_state` -> `integrate_batch` (the
    CUDA kernel's per-doc entry on the GPU, its plain version on the CPU)
    -> `unpack_state`, each in a `torch.profiler.record_function` span of
    its name (``ytpu_torch.pack_state`` ...). `client_rank` is the ``[K]`` interned-client rank
    table shared by all docs; the conflict-scan plan is `scan_tier_plan()`,
    read per call. The input state is left as it was. The returned state's
    origin_slot plane is marked stale (the kernel does not maintain it;
    `ensure_origin_slot` refreshes it). With the phase recorder on, the
    call is its ``integrate.xla_batch`` stage (the JAX package's name for
    this entry)."""
    from ytpu_torch.ops import integrate_kernel as ik
    from ytpu_torch.utils.phases import NULL_SPAN, phases, program_memory

    scan_plan = scan_tier_plan()
    res: list = []
    span = NULL_SPAN
    if phases.enabled:
        span = phases.span(
            "integrate.xla_batch",
            (tuple(state.blocks.client.shape), tuple(batch.client.shape), scan_plan),
            axes=("state", "batch", "scan_plan"),
            memory=program_memory(state, batch, client_rank, outputs=lambda: res),
        )
    record = torch.profiler.record_function
    with span:
        with record("ytpu_torch.pack_state"):
            cols, meta = ik.pack_state(state)
        with record("ytpu_torch.pack_stream"):
            rows, dels = ik.pack_stream(batch)
        with record("ytpu_torch.integrate_batch"):
            ik.integrate_batch(cols, meta, rows, dels, _rank_table(client_rank, cols.device), scan_plan)
        with record("ytpu_torch.unpack_state"):
            out = ik.unpack_state(cols, meta)
        res.append(out)
    mark_origin_slot_stale(out)
    return out


def apply_update_stream_raw(
    state: DocStateBatch, stream: UpdateBatch, client_rank, scan_plan=None
):
    """Integrate a stacked ``[S, ...]`` stream (each step's update
    broadcast to every doc) in one kernel launch; returns ``(state,
    scan_hist)``, scan_hist the per-doc ``[D, SCAN_REC_WORDS]``
    conflict-scan record of this stream (the kernel's meta words, which
    `pack_state` starts at 0). The state's origin_slot plane is marked
    stale."""
    from ytpu_torch.ops import integrate_kernel as ik

    cols, meta = ik.pack_state(state)
    rows, dels = ik.pack_stream(stream)
    ik.integrate_stream(cols, meta, rows, dels, _rank_table(client_rank, cols.device), scan_plan)
    out = ik.unpack_state(cols, meta)
    mark_origin_slot_stale(out)
    return out, meta[:, ik.M_HIST0 : ik.M_SCAN_END]


def apply_update_stream(
    state: DocStateBatch, stream: UpdateBatch, client_rank
) -> DocStateBatch:
    """`apply_update_stream_raw` without the scan record. With the phase
    recorder on, the call is its ``integrate.xla_stream`` stage (the JAX
    package's name for this entry)."""
    from ytpu_torch.utils.phases import phases, program_memory

    scan_plan = scan_tier_plan()
    if not phases.enabled:
        return apply_update_stream_raw(state, stream, client_rank, scan_plan)[0]
    res: list = []
    with phases.span(
        "integrate.xla_stream",
        (tuple(state.blocks.client.shape), tuple(stream.client.shape), scan_plan),
        axes=("state", "stream", "scan_plan"),
        memory=program_memory(state, stream, client_rank, outputs=lambda: res),
    ):
        res.append(apply_update_stream_raw(state, stream, client_rank, scan_plan)[0])
    return res[0]


def apply_update_stream_fused(
    state: DocStateBatch, stream: UpdateBatch, client_rank, refresh_cache: bool = False
) -> DocStateBatch:
    """`apply_update_stream` (sequence, map, nested-branch and move rows all
    integrate in the one launch); ``refresh_cache=True`` rebuilds the stale
    origin_slot plane here (`recompute_origin_slot`) instead of leaving it
    to the readers' `ensure_origin_slot`. With the phase recorder on, the
    launch is its ``integrate.fused`` stage, which counts the packed
    stream as host-to-device bytes."""
    from ytpu_torch.ops import integrate_kernel as ik
    from ytpu_torch.utils.phases import NULL_SPAN, _nbytes, phases

    cols, meta = ik.pack_state(state)
    rows, dels = ik.pack_stream(stream)
    rank = _rank_table(client_rank, cols.device)
    scan_plan = scan_tier_plan()
    span = NULL_SPAN
    if phases.enabled:
        phases.transfer("integrate.fused", _nbytes(rows) + _nbytes(dels), "h2d")
        span = phases.span(
            "integrate.fused",
            (tuple(cols.shape), tuple(rows.shape), tuple(dels.shape), scan_plan),
            axes=("state", "rows", "dels", "scan_plan"),
            memory=ik._stream_memory(cols, meta, rows, dels, rank),
        )
    with span:
        ik.integrate_stream(cols, meta, rows, dels, rank, scan_plan)
    out = ik.unpack_state(cols, meta)
    mark_origin_slot_stale(out)
    return recompute_origin_slot(out) if refresh_cache else out


# --- the read path ---------------------------------------------------------------


def state_vectors(state: DocStateBatch, n_clients: int) -> torch.Tensor:
    """``[D, n_clients]`` dense state vectors from the block columns."""
    from ytpu_torch.ops.state_vector import sv_from_blocks

    bl = state.blocks
    return sv_from_blocks(bl.client, bl.clock, bl.length, n_clients)


def _valid_rows(state: DocStateBatch) -> torch.Tensor:
    bl = state.blocks
    slots = torch.arange(bl.client.shape[-1], device=bl.client.device)
    return (slots[None, :] < state.n_blocks[:, None]) & (bl.client >= 0)


def encode_diff_batch(state: DocStateBatch, remote_sv: torch.Tensor, n_clients: int):
    """Device half of the batched sync step 2: for every (doc, block),
    should it ship to a remote whose state vector is ``remote_sv[d]``
    (``[D, n_clients]`` int32 over interned clients), and from which clock
    offset (`Store::write_blocks_from` / `diff_state_vectors`, store.rs:
    204-248). Returns ``(ship [D, B] bool, offsets [D, B] int32, local_sv
    [D, n_clients] int32, deleted [D, B] bool)``; the host finisher turns
    the selected rows into wire bytes. With the phase recorder on, the
    call is its ``encode.diff_batch`` stage."""
    from ytpu_torch.utils.phases import phases, program_memory

    if not phases.enabled:
        return _encode_diff_batch(state, remote_sv, n_clients)
    res: list = []
    with phases.span(
        "encode.diff_batch",
        (tuple(state.blocks.client.shape), tuple(remote_sv.shape), n_clients),
        axes=("state", "remote_sv", "n_clients"),
        memory=program_memory(state, remote_sv, outputs=lambda: res),
    ):
        res.extend(_encode_diff_batch(state, remote_sv, n_clients))
    return tuple(res)


def _encode_diff_batch(state: DocStateBatch, remote_sv, n_clients: int):
    from ytpu_torch.ops.state_vector import sv_from_blocks

    bl = state.blocks
    with torch.profiler.record_function("ytpu_torch.encode_diff_batch"):
        valid = _valid_rows(state)
        safe_client = bl.client.clamp(0, n_clients - 1).long()
        remote_clock = torch.as_tensor(remote_sv, device=bl.client.device).to(I32).gather(1, safe_client)
        ship = valid & (bl.clock + bl.length > remote_clock)
        offsets = (remote_clock - bl.clock).clamp(min=0) * ship
        deleted = bl.deleted & valid
    with torch.profiler.record_function("ytpu_torch.state_vectors"):
        local_sv = sv_from_blocks(bl.client, bl.clock, bl.length, n_clients)
    return ship, offsets.to(I32), local_sv, deleted


def state_capacity_ledger(state: DocStateBatch):
    """Per-doc ``([D] live, [D] dead)`` int32 row counts: dead rows are the
    tombstoned rows `encode_diff_batch` counts as valid, live the rest of
    the ``n_blocks`` prefix."""
    dead = (_valid_rows(state) & state.blocks.deleted).sum(dim=1).to(I32)
    return state.n_blocks.to(I32) - dead, dead


class CompactionPolicy(NamedTuple):
    """When a chunked replay compacts / grows its block state.

    - ``high_watermark``: occupancy fraction above which a between-chunk
      compaction fires even when the next chunk would still fit.
    - ``chunk_budget``: fraction of capacity a single chunk's worst-case
      adds may consume (`replay.plan_chunks` sizes chunks with it).
    """

    high_watermark: float = 0.85
    chunk_budget: float = 0.15

    def occupancy_trips(self, occupancy: int, capacity: int) -> bool:
        return occupancy > self.high_watermark * capacity

    def should_compact(self, occupancy: int, margin: int, capacity: int) -> bool:
        """True when projected growth would overflow, or the
        high-watermark already tripped."""
        return occupancy + margin > capacity or self.occupancy_trips(
            occupancy, capacity
        )

    def chunk_add_budget(self, capacity: int) -> int:
        return max(1, int(self.chunk_budget * capacity))


DEFAULT_COMPACTION_POLICY = CompactionPolicy()


def stream_worst_case_adds(stream: UpdateBatch) -> np.ndarray:
    """[S] worst-case block-slot growth per step: 3 per valid row (itself
    plus two anchor splits), 2 per valid delete range (edge splits)."""
    rows = stream.valid.cpu().numpy().sum(axis=-1).astype(np.int64)
    dels = stream.del_valid.cpu().numpy().sum(axis=-1).astype(np.int64)
    return 3 * rows + 2 * dels


# --- conflict-scan-width record ---------------------------------------------
# bucket 0 holds widths 0-1, bucket k holds [2^k, 2^{k+1}), the last bucket
# is unbounded above; the record adds the observed max, tier occupancy and
# trip accounting words.

SCAN_WIDTH_BUCKETS = 8
SCAN_WIDTH_THRESHOLDS = (2, 4, 8, 16, 32, 64, 128)
SCAN_WIDTH_UPPER = (1, 3, 7, 15, 31, 63, 127)
SCAN_TIER_CHEAP_DEFAULT = 32
SCAN_WIDE_UNROLL_DEFAULT = 8

SCAN_REC_MAX = SCAN_WIDTH_BUCKETS  # observed max width
SCAN_REC_CHEAP = SCAN_WIDTH_BUCKETS + 1  # scans resolved in the cheap tier
SCAN_REC_WIDE = SCAN_WIDTH_BUCKETS + 2  # scans that reached the wide tier
SCAN_REC_CHEAP_TRIPS = SCAN_WIDTH_BUCKETS + 3  # sum of min(width, cheap)
SCAN_REC_WIDE_TRIPS = SCAN_WIDTH_BUCKETS + 4  # sum of wide-tier trips
SCAN_REC_WIDTH_SUM = SCAN_WIDTH_BUCKETS + 5  # sum of widths
SCAN_REC_WORDS = SCAN_WIDTH_BUCKETS + 6


def scan_tier_plan() -> Tuple[int, int]:
    """(cheap_bound, wide_unroll) from ``YTPU_SCAN_TIER_CHEAP`` /
    ``YTPU_SCAN_WIDE_UNROLL``, defaulting to (32, 8)."""
    cheap = int(os.environ.get("YTPU_SCAN_TIER_CHEAP", SCAN_TIER_CHEAP_DEFAULT))
    unroll = int(os.environ.get("YTPU_SCAN_WIDE_UNROLL", SCAN_WIDE_UNROLL_DEFAULT))
    return (max(0, cheap), max(1, unroll))


def scan_width_bucket(w: torch.Tensor) -> torch.Tensor:
    """Bucket index of width samples (elementwise)."""
    b = torch.zeros_like(w)
    for t in SCAN_WIDTH_THRESHOLDS:
        b = b + (w >= t).to(w.dtype)
    return b


def merge_scan_records(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Combine ``[..., SCAN_REC_WORDS]`` records: every word adds except
    the observed max, which maxes."""
    out = a + b
    out[..., SCAN_REC_MAX] = torch.maximum(a[..., SCAN_REC_MAX], b[..., SCAN_REC_MAX])
    return out


def scan_width_quantile(counts, q: float, observed_max: int) -> int:
    """Inclusive upper bound of the bucket holding the q-th sample (the
    unbounded last bucket reports the observed max); 0 when empty."""
    counts = [int(c) for c in counts]
    total = sum(counts)
    if total == 0:
        return 0
    target = q * total
    acc = 0
    for k, c in enumerate(counts):
        acc += c
        if acc >= target:
            if k < len(SCAN_WIDTH_UPPER):
                return min(SCAN_WIDTH_UPPER[k], int(observed_max))
            return int(observed_max)
    return int(observed_max)


# --- state commitment ----------------------------------------------------------


def _commit_mix_u32(x: torch.Tensor) -> torch.Tensor:
    """32-bit integer finalizer over int64 tensors holding uint32 values."""
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & U32_MASK
    x = ((x ^ (x >> 15)) * 0x846CA68B) & U32_MASK
    return x ^ (x >> 16)


def commit_fold_blocks(client, clock, length, valid) -> torch.Tensor:
    """Per-doc commitment fold over ``[..., B]`` (client, clock, length)
    columns under a ``valid`` mask -> ``[...]`` int64 holding the uint32
    value (mod 2^32 throughout). Each row contributes
    ``A(c)*(s*l + l(l-1)/2) + B(c)*l`` with ``A/B = mix32(2c+1 / 2c+2)``;
    the triangular term is computed division-free by parity."""
    c = client.to(torch.int64) & U32_MASK
    a = _commit_mix_u32((2 * c + 1) & U32_MASK)
    b = _commit_mix_u32((2 * c + 2) & U32_MASK)
    s = clock.to(torch.int64) & U32_MASK
    l = length.to(torch.int64) & U32_MASK
    lm1 = (l - 1) & U32_MASK
    tri = torch.where(l % 2 == 0, ((l >> 1) * lm1) & U32_MASK, (l * (lm1 >> 1)) & U32_MASK)
    inner = (((s * l) & U32_MASK) + tri) & U32_MASK
    contrib = (((a * inner) & U32_MASK) + ((b * l) & U32_MASK)) & U32_MASK
    contrib = torch.where(valid, contrib, torch.zeros_like(contrib))
    return contrib.sum(dim=-1) & U32_MASK


# --- host tables the finisher reads ------------------------------------------------


class ClientInterner:
    """Dense int32 interning of 53-bit client ids."""

    def __init__(self):
        self.to_idx: Dict[int, int] = {}
        self.from_idx: List[int] = []

    def intern(self, client: int) -> int:
        idx = self.to_idx.get(client)
        if idx is None:
            idx = len(self.from_idx)
            self.to_idx[client] = idx
            self.from_idx.append(client)
        return idx

    def rank_table(self, pad_to: Optional[int] = None, device=None) -> torch.Tensor:
        """``[K]`` int32: the rank of each interned client in real-id order,
        padded to a power of two (at least 8) unless `pad_to` is given."""
        n = len(self.from_idx)
        size = pad_to or max(8, 1 << (max(1, n - 1)).bit_length())
        ranks = np.zeros(size, dtype=np.int32)
        order = sorted(range(n), key=lambda i: self.from_idx[i])
        for rank, idx in enumerate(order):
            ranks[idx] = rank
        return torch.from_numpy(ranks).to(resolve_device(device))

    def __len__(self) -> int:
        return len(self.from_idx)


class KeyInterner:
    """Dense interning of map keys (parent_sub strings) to int32 ids."""

    def __init__(self):
        self.ids: Dict[str, int] = {}
        self.names: Dict[int, str] = {}

    def intern(self, key: str) -> int:
        kid = self.ids.get(key)
        if kid is None:
            kid = len(self.ids)
            self.ids[key] = kid
            self.names[kid] = key
        return kid

    def __len__(self) -> int:
        return len(self.ids)


class PayloadStore:
    """Host side-buffers for variable-length content, addressed by int32
    refs. Strings are stored as UTF-16LE bytes so (offset, len) columns in
    clock units slice exactly; other payloads store their element lists or
    content objects (anything with ``encode(enc)``)."""

    def __init__(self):
        self.items: List[Tuple[int, object]] = []  # (kind, payload)

    def add(self, kind: int, payload) -> int:
        self.items.append((kind, payload))
        return len(self.items) - 1

    def slice_text(self, ref: int, off: int, length: int) -> str:
        _, payload = self.items[ref]
        # a slice boundary inside a surrogate pair renders the severed half
        # as U+FFFD (split_str_utf16, block.rs:1852-1860)
        return payload[2 * off : 2 * (off + length)].decode("utf-16-le", errors="replace")

    def slice_values(self, ref: int, off: int, length: int) -> list:
        return self.items[ref][1][off : off + length]

    def json_values(self, ref: int, off: int, length: int) -> list:
        return self.items[ref][1].values()[off : off + length]

    def json_raw(self, ref: int, off: int, length: int) -> list:
        return self.items[ref][1].raw[off : off + length]

    def embed_value(self, ref: int):
        return self.items[ref][1].value

    def binary_value(self, ref: int) -> bytes:
        return self.items[ref][1].data

    def format_kv(self, ref: int):
        fmt = self.items[ref][1]
        return fmt.key, fmt.value


class EncoderTables:
    """What the diff finisher reads of a `BatchEncoder`: the client and key
    interners, the payloads (a `PayloadStore`, or a view with `slice_text`
    over device-decoded text: `replay.UnitArenaView`,
    `decode_kernel.RawPayloadView`) and the name of the root branch."""

    def __init__(self, interner=None, keys=None, payloads=None, root_name: str = "text"):
        self.interner = ClientInterner() if interner is None else interner
        self.keys = KeyInterner() if keys is None else keys
        self.payloads = PayloadStore() if payloads is None else payloads
        self.root_name = root_name

    @classmethod
    def identity(cls, n_clients: int, payloads=None, root_name: str = "text") -> "EncoderTables":
        """Tables for rows whose client column holds the raw client id, as
        the device decoder writes it: client i is interned at index i, for
        i < `n_clients`."""
        interner = ClientInterner()
        for c in range(n_clients):
            interner.intern(c)
        return cls(interner, payloads=payloads, root_name=root_name)

    @classmethod
    def from_replay(cls, replay, root_name: str = "text") -> "EncoderTables":
        """Tables for a `FusedReplay`'s state: raw client ids up to the
        plan's largest, text through the replay's unit arena."""
        from ytpu_torch.models.replay import UnitArenaView

        plan = replay.plan
        return cls.identity(
            plan.max_client + 1, UnitArenaView(plan.unit_byte, plan.arena), root_name
        )


_NO_MOVE = (-1, 0, 0, -1, 0, 0, -1)  # mv_sc .. mv_prio of a row that is no move
# the row tuple's columns, in `BatchEncoder.rows_from_carriers` order
_ROW_FIELDS = (
    "client", "clock", "length", "origin_client", "origin_clock", "ror_client", "ror_clock",
    "kind", "content_ref", "content_off", "key", "p_tag", "p_client", "p_clock", "p_root",
    "mv_sc", "mv_sk", "mv_sa", "mv_ec", "mv_ek", "mv_ea", "mv_prio",
)
# a padding row: no key, no parent client, the primary root, no move
_ROW_PAD = np.array([-1 if f in ("key", "p_client", "p_root", "mv_sc", "mv_ec", "mv_prio") else 0
                     for f in _ROW_FIELDS], dtype=np.int32)


class BatchEncoder(EncoderTables):
    """Plans host-decoded `Update`s into padded `UpdateBatch` tensors (copy
    of ytpu's `BatchEncoder`): carriers are ordered by their dependencies
    (`partition_carriers`), turned into row tuples over the client and key
    interners and the payload store (`rows_from_carriers`), and padded
    into one ``[D, U]`` / ``[D, R]`` batch (`batch_from_rows`). Being an
    `EncoderTables`, it is also what the diff finisher reads."""

    def __init__(self, root_name: str = "text"):
        super().__init__(root_name=root_name)
        # until a named root has been seen, the FIRST one encountered is
        # adopted as the batch root; later distinct names are true
        # multi-root and anchor through BLOCK_ROOT_ANCHOR rows
        self._root_adopted = False
        # build_batch slot primaries: doc index -> its first named root
        self.doc_primaries: Dict[int, str] = {}
        # True once an encoded row was a map row or had a branch-id parent,
        # and once one was a ContentMove (kept in checkpoints)
        self.saw_map_or_nested = False
        self.saw_move = False

    def partition_carriers(self, update, local_sv=None):
        """``(applicable, leftover)`` carriers: the host half of the
        reference's integration stack machine (update.rs:169-308, missing()
        :310-385): clients descending, but a block whose origin, right
        origin, parent or move bound points into a range not emitted yet
        waits for it. With `local_sv` (the doc's state-vector mirror) the
        check is exact: dependencies must be covered by the mirror or by
        rows emitted before, and each client's rows must continue its
        clock; the rest is `leftover` (the pending stash,
        transaction.rs:675-727). Without it, dependencies outside the
        update are assumed present and everything is emitted."""
        from ytpu_torch.core.block import Item, SkipRange
        from ytpu_torch.core.content import ContentMove
        from ytpu_torch.core.ids import ID

        queues = {
            c: [x for x in update.blocks[c] if not isinstance(x, SkipRange)]
            for c in sorted(update.blocks.keys(), reverse=True)
        }
        queues = {c: q for c, q in queues.items() if q}
        if local_sv is None:
            emitted = {c: q[0].id.clock for c, q in queues.items()}
        else:
            emitted = {c: local_sv.get(c) for c in queues}
        heads = {c: 0 for c in queues}

        def satisfied(dep) -> bool:
            if dep is None:
                return True
            if dep.client not in emitted:
                if local_sv is None:
                    return True
                return dep.clock < local_sv.get(dep.client)
            return dep.clock < emitted[dep.client]

        out = []
        progress = True
        while progress:
            progress = False
            for c, q in queues.items():
                while heads[c] < len(q):
                    carrier = q[heads[c]]
                    if local_sv is not None and carrier.id.clock > emitted[c]:
                        break  # a clock gap within this client: pending
                    if isinstance(carrier, Item):
                        deps = [
                            carrier.origin,
                            carrier.right_origin,
                            carrier.parent if isinstance(carrier.parent, ID) else None,
                        ]
                        if isinstance(carrier.content, ContentMove):
                            # a move row depends on its range bounds too
                            deps.append(carrier.content.move.start.id)
                            deps.append(carrier.content.move.end.id)
                        if not all(satisfied(d) for d in deps):
                            break
                    out.append(carrier)
                    emitted[c] = max(emitted[c], carrier.id.clock + carrier.len)
                    heads[c] += 1
                    progress = True
        leftover = []
        for c, q in queues.items():
            leftover.extend(q[heads[c] :])
        if local_sv is None:
            return out + leftover, []
        return out, leftover

    def _ordered_carriers(self, update) -> list:
        ordered, _ = self.partition_carriers(update)
        return ordered

    def rows_from_update(self, update, primary_root=None) -> Tuple[list, list]:
        rows = self.rows_from_carriers(self._ordered_carriers(update), primary_root=primary_root)
        dels = []
        for client, ranges in update.delete_set.clients.items():
            c = self.interner.intern(client)
            for s, e in ranges:
                dels.append((c, s, e))
        return rows, dels

    def rows_from_carriers(self, carriers: list, primary_root=None) -> list:
        """Row tuples (`_ROW_FIELDS`) for already-ordered carriers.

        ``primary_root`` is the root name mapped onto the implicit device
        branch (``state.start``); other named roots intern into the key
        table and anchor through per-doc BLOCK_ROOT_ANCHOR rows (doc.rs:
        156-228). When omitted, the batch root is used, and the first
        named root ever seen is adopted as it."""
        from ytpu_torch.core.block import GCRange
        from ytpu_torch.core.ids import ID

        explicit_primary = primary_root
        if primary_root is None:
            primary_root = self.root_name
        rows = []
        for carrier in carriers:
            c = self.interner.intern(carrier.id.client)
            if isinstance(carrier, GCRange):
                rows.append((c, carrier.id.clock, carrier.len, -1, 0, -1, 0, BLOCK_GC, -1, 0, -1, 0,
                             -1, 0, -1) + _NO_MOVE)
                continue
            item = carrier
            kind = item.content.kind
            if kind == CONTENT_STRING:
                ref = self.payloads.add(kind, item.content.text.encode("utf-16-le"))
            elif kind == CONTENT_ANY:
                ref = self.payloads.add(kind, list(item.content.items))
            elif kind == CONTENT_DELETED:
                ref = -1
            else:
                # embed / format / type / doc / json / binary / move
                # payloads: the content object itself
                ref = self.payloads.add(kind, item.content)
            oc = self.interner.intern(item.origin.client) if item.origin else -1
            ok = item.origin.clock if item.origin else 0
            rc = self.interner.intern(item.right_origin.client) if item.right_origin else -1
            rk = item.right_origin.clock if item.right_origin else 0
            key = self.keys.intern(item.parent_sub) if item.parent_sub is not None else -1
            parent = item.parent
            p_root = -1
            if isinstance(parent, ID):
                p_tag = 2
                pc, pk = self.interner.intern(parent.client), parent.clock
            elif parent is not None:  # a named root
                p_tag, pc, pk = 1, -1, 0
                if explicit_primary is None and not self._root_adopted:
                    self.root_name = primary_root = parent
                    self._root_adopted = True
                if parent != primary_root:
                    p_root = self.keys.intern(parent)
            else:  # omitted on the wire: inherited from the anchors
                p_tag, pc, pk = 0, -1, 0
            if key >= 0 or p_tag == 2:
                self.saw_map_or_nested = True
            mv = _NO_MOVE
            if kind == CONTENT_MOVE:
                self.saw_move = True
                move = item.content.move
                # a bound with no item id (a branch-scoped sticky index)
                # reads as the sequence head / tail
                sc, sk, sa = -1, 0, move.start.assoc
                if move.start.id is not None:
                    sc = self.interner.intern(move.start.id.client)
                    sk = move.start.id.clock
                ec, ek, ea = -1, 0, move.end.assoc
                if move.end.id is not None:
                    ec = self.interner.intern(move.end.id.client)
                    ek = move.end.id.clock
                mv = (sc, sk, sa, ec, ek, ea, max(move.priority, 0))
            rows.append((c, item.id.clock, item.len, oc, ok, rc, rk, kind, ref, 0, key, p_tag, pc,
                         pk, p_root) + mv)
        return rows

    def build_batch(self, updates, n_rows=None, n_dels=None, device=None) -> UpdateBatch:
        """Pad per-doc rows of `updates` (None = no-op slot) into one batch.
        Each doc slot's primary root is the first named root it ever used
        (sticky across calls, `doc_primaries`)."""

        def first_root(u):
            for c in sorted(u.blocks, reverse=True):
                for b in u.blocks[c]:
                    p = getattr(b, "parent", None)
                    if isinstance(p, str):
                        return p
            return None

        all_rows, all_dels = [], []
        for d_i, u in enumerate(updates):
            if u is None:
                all_rows.append([])
                all_dels.append([])
                continue
            fr = first_root(u)
            prim = self.doc_primaries.setdefault(d_i, fr) if fr is not None else self.doc_primaries.get(d_i)
            r, d = self.rows_from_update(u, primary_root=prim)
            all_rows.append(r)
            all_dels.append(d)
        return self.batch_from_rows(all_rows, all_dels, n_rows, n_dels, device=device)

    def build_step(self, update, n_rows: int, n_dels: int, primary_root=None, device=None) -> UpdateBatch:
        """One update as a doc-axis-free batch (leaves ``[U]`` / ``[R]``) for
        `apply_update_stream`, on `device` (the GPU unless it says
        otherwise)."""
        rows, dels = self.rows_from_update(update, primary_root=primary_root)
        if len(rows) > n_rows or len(dels) > n_dels:
            raise ValueError(
                f"update needs {len(rows)} rows/{len(dels)} dels, "
                f"buckets are {n_rows}/{n_dels}"
            )
        batch = self.batch_from_rows([rows], [dels], n_rows, n_dels, device=device)
        return UpdateBatch(*(a[0] for a in batch))

    @staticmethod
    def stack_steps(steps: List[UpdateBatch]) -> UpdateBatch:
        """Stack per-step batches into ``[S, ...]`` leaves."""
        return UpdateBatch(*(torch.stack(xs) for xs in zip(*steps)))

    def batch_from_rows(self, all_rows, all_dels, n_rows=None, n_dels=None, device=None) -> UpdateBatch:
        """Pad per-doc row / delete tuple lists into one ``[D, U]`` /
        ``[D, R]`` batch on `device` (the GPU unless it says otherwise);
        one host-to-device copy for the rows and one for the deletes."""
        device = resolve_device(device)
        U = n_rows or max(1, max(len(r) for r in all_rows))
        R = n_dels or max(1, max(len(d) for d in all_dels))
        D = len(all_rows)
        rows = np.empty((D, U, len(_ROW_FIELDS) + 1), dtype=np.int32)
        rows[:, :, :-1] = _ROW_PAD
        rows[:, :, -1] = 0
        dels = np.zeros((D, R, 4), dtype=np.int32)
        for d, (rr, dd) in enumerate(zip(all_rows, all_dels)):
            if rr:
                rows[d, : len(rr), :-1] = rr
                rows[d, : len(rr), -1] = 1
            if dd:
                dels[d, : len(dd), :3] = dd
                dels[d, : len(dd), 3] = 1
        rows_t = torch.from_numpy(rows).to(device)
        dels_t = torch.from_numpy(dels).to(device)
        cols = {f: rows_t[:, :, i] for i, f in enumerate(_ROW_FIELDS)}
        return UpdateBatch(
            **cols,
            valid=rows_t[:, :, -1] != 0,
            del_client=dels_t[:, :, 0],
            del_start=dels_t[:, :, 1],
            del_end=dels_t[:, :, 2],
            del_valid=dels_t[:, :, 3] != 0,
        )


# --- root anchors -------------------------------------------------------------------


def _append_root_anchor_masked(state: DocStateBatch, doc_mask: torch.Tensor, key_id: int) -> DocStateBatch:
    """Append the BLOCK_ROOT_ANCHOR row of root `key_id` in every doc
    selected by ``doc_mask`` (``[D]`` bool) that has none yet: the shared
    core of `ensure_root_anchor` and `ensure_root_anchor_all`. A doc at
    capacity gets ERR_CAPACITY instead. The input state is left as it
    was.

    Anchors give non-primary named roots (doc.rs:156-228) a per-doc row the
    integrate path parents through (its `head` is the root's child-sequence
    head, as a nested ContentType row's is). They have no wire identity:
    client -1 keeps them out of state vectors, ship masks and delete
    sets."""
    bl = state.blocks
    D, B = bl.client.shape
    dev = bl.client.device
    slots = torch.arange(B, device=dev)[None, :]
    exists = ((slots < state.n_blocks[:, None]) & (bl.kind == BLOCK_ROOT_ANCHOR)
              & (bl.key == key_id)).any(dim=1)
    j = state.n_blocks.long()
    want = doc_mask & ~exists
    do = want & (j < B)
    docs = torch.nonzero(do).reshape(-1)
    at = j[docs]
    new = {}
    for name, val in (("kind", BLOCK_ROOT_ANCHOR), ("key", key_id), ("client", -1), ("length", 0),
                      ("head", -1), ("left", -1), ("right", -1), ("deleted", False),
                      ("countable", False)):
        col = getattr(bl, name).clone()
        col[docs, at] = val
        new[name] = col
    return DocStateBatch(
        blocks=bl._replace(**new),
        start=state.start,
        n_blocks=state.n_blocks + do.to(state.n_blocks.dtype),
        # error is a bitmask: OR the flag in
        error=state.error | torch.where(want & (j >= B), ERR_CAPACITY, 0).to(state.error.dtype),
    )


def ensure_root_anchor(state: DocStateBatch, doc: int, key_id: int) -> DocStateBatch:
    """Create doc's anchor row for a non-primary root (a no-op when it
    exists). Call it before applying rows that carry ``p_root == key_id``:
    the integrate path resolves anchors, it never creates them."""
    D = state.blocks.client.shape[0]
    mask = torch.arange(D, device=state.start.device) == int(doc)
    return _append_root_anchor_masked(state, mask, int(key_id))


def ensure_root_anchor_all(state: DocStateBatch, key_id: int) -> DocStateBatch:
    """Create the anchor row of root `key_id` in every doc slot."""
    D = state.blocks.client.shape[0]
    return _append_root_anchor_masked(state, torch.ones(D, dtype=torch.bool, device=state.start.device),
                                      int(key_id))


# --- the host finisher --------------------------------------------------------------


def _encode_device_row(out, bl, r, off, enc) -> None:
    """One block row of the diff in v1 (block.rs:868-908): row ``r`` of the
    columns `bl`, its first `off` clock units trimmed."""
    from ytpu_torch.core.ids import ID

    payloads = enc.payloads
    kind = int(bl.kind[r])
    if kind == BLOCK_GC:
        out.write_info(BLOCK_GC)
        out.write_len(int(bl.length[r]) - off)
        return
    oc, ok = int(bl.origin_client[r]), int(bl.origin_clock[r])
    rc, rk = int(bl.ror_client[r]), int(bl.ror_clock[r])
    clock = int(bl.clock[r])
    if off > 0:
        oc, ok = int(bl.client[r]), clock + off - 1
    has_o, has_r = oc >= 0, rc >= 0
    key = int(bl.key[r])
    has_sub = key >= 0
    info = kind | (0x80 if has_o else 0) | (0x40 if has_r else 0) | (0x20 if has_sub else 0)
    out.write_info(info)
    if has_o:
        out.write_left_id(ID(enc.interner.from_idx[oc], ok))
    if has_r:
        out.write_right_id(ID(enc.interner.from_idx[rc], rk))
    if not has_o and not has_r:
        parent_row = int(bl.parent[r])
        if parent_row >= 0 and int(bl.kind[parent_row]) == BLOCK_ROOT_ANCHOR:
            # non-primary named root: the anchor row has no wire identity,
            # so the root-name form is written with the anchor's name
            out.write_parent_info(True)
            out.write_string(enc.keys.names[int(bl.key[parent_row])])
        elif parent_row >= 0:
            # nested branch: the parent is the ContentType item's id
            out.write_parent_info(False)
            out.write_left_id(
                ID(enc.interner.from_idx[int(bl.client[parent_row])], int(bl.clock[parent_row]))
            )
        else:
            out.write_parent_info(True)
            out.write_string(enc.root_name)
        if has_sub:
            out.write_string(enc.keys.names[key])
    ref = int(bl.content_ref[r])
    c_off = int(bl.content_off[r]) + off
    length = int(bl.length[r]) - off
    if kind == CONTENT_STRING:
        out.write_string(payloads.slice_text(ref, c_off, length))
    elif kind == CONTENT_ANY:
        out.write_len(length)
        for v in payloads.slice_values(ref, c_off, length):
            out.write_any(v)
    elif kind == CONTENT_DELETED:
        out.write_len(length)
    elif ref < 0 and kind == CONTENT_FORMAT:
        fkey, fval = payloads.format_kv(ref)
        out.write_key(fkey)
        out.write_json(fval)
    elif ref < 0 and kind == CONTENT_EMBED:
        out.write_json(payloads.embed_value(ref))
    elif ref < 0 and kind == CONTENT_BINARY:
        out.write_buf(payloads.binary_value(ref))
    elif ref < 0 and kind == CONTENT_JSON:
        raw = payloads.json_raw(ref, c_off, length)
        out.write_len(len(raw))
        for s in raw:
            out.write_string(s)
    elif ref < -1 and kind == CONTENT_TYPE:
        # a retained wire span: its original bytes, verbatim
        out.write_raw(payloads.type_raw(ref))
    else:
        # other payload kinds keep the host content object itself
        payloads.items[ref][1].encode(out)


def _finish_rows(bl, ship, offsets, deleted, enc) -> bytes:
    """The v1 update of one doc's selected rows: `bl` the doc's columns,
    `ship` / `offsets` / `deleted` its ``[rows]`` selection. Clients in
    descending id order, each client's rows by clock, the first one
    offset-trimmed, then the delete set."""
    from ytpu_torch.core.id_set import DeleteSet
    from ytpu_torch.encoding.codec import EncoderV1

    from_idx = enc.interner.from_idx
    per_client: Dict[int, List[int]] = {}
    for r in np.nonzero(ship)[0].tolist():
        per_client.setdefault(int(bl.client[r]), []).append(r)
    out = EncoderV1()
    out.write_var(len(per_client))
    for cidx in sorted(per_client, key=lambda c: -from_idx[c]):
        slots = sorted(per_client[cidx], key=lambda r: int(bl.clock[r]))
        out.write_var(len(slots))
        out.write_client(from_idx[cidx])
        first_off = int(offsets[slots[0]])
        out.write_var(int(bl.clock[slots[0]]) + first_off)
        for pos, r in enumerate(slots):
            _encode_device_row(out, bl, r, first_off if pos == 0 else 0, enc)
    ds = DeleteSet()
    for r in np.nonzero(deleted)[0].tolist():
        start = int(bl.clock[r])
        ds.insert_range(from_idx[int(bl.client[r])], start, start + int(bl.length[r]))
    ds.encode(out)
    return out.to_bytes()


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def finish_encode_diff(state: DocStateBatch, doc: int, ship, offsets, deleted, enc) -> bytes:
    """Host finisher of one doc: its selected rows (`encode_diff_batch`'s
    outputs) -> a v1 update payload, in the host oracle's wire layout.
    `enc` holds the interners, the payloads and the root name
    (`EncoderTables`)."""
    bl = BlockCols(*(a[doc].cpu().numpy() for a in state.blocks))
    return _finish_rows(bl, _host(ship[doc]), _host(offsets[doc]), _host(deleted[doc]), enc)


# the columns of the compacted finisher rows, then ship, offsets, deleted
_FINISH_COLS = (
    "client", "clock", "length", "origin_client", "origin_clock", "ror_client",
    "ror_clock", "kind", "content_ref", "content_off", "key", "parent",
)
FINISH_PLANES = len(_FINISH_COLS) + 3


class _FinishCols(NamedTuple):
    client: list
    clock: list
    length: list
    origin_client: list
    origin_clock: list
    ror_client: list
    ror_clock: list
    kind: list
    content_ref: list
    content_off: list
    key: list
    parent: list


def _finish_compacted(arr: np.ndarray, enc) -> bytes:
    """`_finish_rows` of one doc's compacted ``[15, R]`` rows."""
    bl = _FinishCols(*arr[: len(_FINISH_COLS)].tolist())
    k = len(_FINISH_COLS)
    return _finish_rows(bl, arr[k] != 0, arr[k + 1], arr[k + 2] != 0, enc)


def _next_pow2(n: int, floor: int = 8) -> int:
    return max(floor, 1 << max(0, int(n - 1).bit_length()))


def _finish_include(parent, ship, deleted):
    """Rows the finisher must see: shipped, deleted, or the parent of a
    shipped row (the finisher walks one parent hop for rows with neither
    origin). Returns ``(include [D, B] bool, shipped-with-parent, parent
    index or 0)``."""
    pv = ship & (parent >= 0)
    spar = torch.where(pv, parent, torch.zeros_like(parent)).long()
    incl = (ship | deleted).to(I32).scatter_reduce(1, spar, pv.to(I32), reduce="amax")
    return incl > 0, pv, spar


def _finish_counts(parent, ship, deleted, idx) -> torch.Tensor:
    """``[len(idx)]`` rows each selected doc sends to the finisher."""
    incl, _, _ = _finish_include(parent[idx], ship[idx], deleted[idx])
    return incl.sum(dim=1)


def compact_finisher_rows(bl: BlockCols, ship, offsets, deleted, idx, R: int) -> torch.Tensor:
    """The finisher's rows of the docs `idx`, compacted on the device into
    one ``[len(idx), 15, R]`` int32 tensor: the 12 `_FINISH_COLS`, then
    ship, offsets and deleted, each doc's included rows in slot order in
    its first columns (`R` at least the largest per-doc count), so that
    only these rows cross to the host. The parent column is renumbered
    into the compacted rows for shipped rows and -1 elsewhere. With the
    phase recorder on, the call is its ``encode.pack`` stage, keyed by
    its ``(sub, R)`` family."""
    from ytpu_torch.utils.phases import phases, program_memory

    if not phases.enabled:
        return _compact_finisher_rows(bl, ship, offsets, deleted, idx, R)
    res: list = []
    with phases.span(
        "encode.pack",
        (tuple(bl.client.shape), tuple(idx.shape), R),
        axes=("state", "idx", "R"),
        memory=program_memory(bl, ship, offsets, deleted, idx, outputs=lambda: res),
    ):
        res.append(_compact_finisher_rows(bl, ship, offsets, deleted, idx, R))
    return res[0]


def _compact_finisher_rows(bl: BlockCols, ship, offsets, deleted, idx, R: int) -> torch.Tensor:
    ship, deleted = ship[idx], deleted[idx]
    cols = [getattr(bl, n)[idx].to(I32) for n in _FINISH_COLS]
    incl, pv, spar = _finish_include(cols[-1], ship, deleted)
    incl_i = incl.to(I32)
    new_idx = torch.cumsum(incl_i, dim=1, dtype=I32) - incl_i
    cols[-1] = torch.where(pv, new_idx.gather(1, spar), torch.full_like(new_idx, -1))
    planes = torch.stack(cols + [ship.to(I32), offsets[idx].to(I32), deleted.to(I32)], dim=1)
    Ds, P, B = planes.shape
    # rows left out go to column R, which is cut off
    tgt = torch.where(incl, new_idx, torch.full_like(new_idx, R)).long()
    out = torch.zeros((Ds, P, R + 1), dtype=I32, device=planes.device)
    out.scatter_(2, tgt[:, None, :].expand(Ds, P, B), planes)
    return out[:, :, :R].contiguous()  # the native finisher reads it at doc stride 15 * R


def _check_doc_selection(sel: np.ndarray, n_docs: int) -> None:
    if sel.size and (sel.min() < 0 or sel.max() >= n_docs):
        raise IndexError(f"doc selection out of range: {sel.min()}..{sel.max()} for {n_docs} docs")


def _selection(docs, n_docs: int, width: int, dev) -> torch.Tensor:
    """``[width]`` doc indices on `dev`: `docs`, then the first selected
    doc repeated as padding. A fresh host array each call, copied
    synchronously, so no later call rewrites one a copy still reads."""
    sel = np.full(width, docs[0] if len(docs) else 0, dtype=np.int64)
    sel[: len(docs)] = docs
    return torch.from_numpy(sel).to(dev)


# --- the native finisher ----------------------------------------------------------


# total selected rows from which the native finisher spreads its docs over
# a thread pool (below it, one thread: starting the pool costs more)
FINISHER_MT_MIN_ROWS = 4096


def _finisher_threads(total_rows: int) -> int:
    """The native finisher's thread count: 0 = a pool of hardware
    concurrency, 1 = the calling thread. Keyed on the call's total
    selected rows, not its doc count, so a few huge docs still fan out."""
    return 0 if int(total_rows) >= FINISHER_MT_MIN_ROWS else 1


def _payload_native_arenas(store) -> dict:
    """Per-item arenas the native finisher reads, cached on the
    `PayloadStore`. The store is append-only, so the cache extends with
    each new item: UTF-16LE text bytes of string payloads, the pre-encoded
    content blob of other payloads (the bytes ``content.encode(EncoderV1())``
    writes: the Python finisher's last branch), and the per-element
    ``write_any`` bytes of ContentAny payloads."""
    from ytpu_torch.encoding.codec import EncoderV1

    ar = getattr(store, "_nat_arena", None)
    if ar is None:
        ar = {
            "n": 0,
            "text": bytearray(),
            "text_off": [],
            "text_units": [],
            "blob": bytearray(),
            "blob_off": [],
            "blob_len": [],
            "elem_base": [],
            "elem_count": [],
            "elem_off": [0],
            "elem": bytearray(),
        }
        store._nat_arena = ar
    items = store.items
    for i in range(ar["n"], len(items)):
        kind, payload = items[i]
        text_off = blob_off = blob_len = elem_base = -1
        text_units = elem_count = 0
        if kind == CONTENT_STRING and isinstance(payload, (bytes, bytearray)):
            text_off = len(ar["text"])
            text_units = len(payload) // 2
            ar["text"] += payload
        elif kind == CONTENT_ANY and isinstance(payload, list):
            elem_base = len(ar["elem_off"]) - 1
            elem_count = len(payload)
            for v in payload:
                enc = EncoderV1()
                enc.write_any(v)
                ar["elem"] += enc.to_bytes()
                ar["elem_off"].append(len(ar["elem"]))
        else:
            try:
                enc = EncoderV1()
                payload.encode(enc)
                blob = enc.to_bytes()
                blob_off = len(ar["blob"])
                blob_len = len(blob)
                ar["blob"] += blob
            except Exception:
                pass  # a row of this item is left to the Python finisher
        ar["text_off"].append(text_off)
        ar["text_units"].append(text_units)
        ar["blob_off"].append(blob_off)
        ar["blob_len"].append(blob_len)
        ar["elem_base"].append(elem_base)
        ar["elem_count"].append(elem_count)
    ar["n"] = len(items)

    # numpy mirrors, rebuilt only when the store grew: a long-lived server
    # answering single-doc syncs must not copy the whole store per reply
    key = (ar["n"], len(ar["text"]), len(ar["blob"]), len(ar["elem"]))
    if ar.get("np_key") != key:
        ar["np"] = {
            "text": np.frombuffer(bytes(ar["text"]) or b"\0", dtype=np.uint8),
            "blob": np.frombuffer(bytes(ar["blob"]) or b"\0", dtype=np.uint8),
            "elem": np.frombuffer(bytes(ar["elem"]) or b"\0", dtype=np.uint8),
            "text_off": np.asarray(ar["text_off"] or [0], dtype=np.int64),
            "text_units": np.asarray(ar["text_units"] or [0], dtype=np.int64),
            "blob_off": np.asarray(ar["blob_off"] or [0], dtype=np.int64),
            "blob_len": np.asarray(ar["blob_len"] or [0], dtype=np.int64),
            "elem_base": np.asarray(ar["elem_base"] or [0], dtype=np.int64),
            "elem_count": np.asarray(ar["elem_count"] or [0], dtype=np.int64),
            "elem_off": np.asarray(ar["elem_off"] or [0], dtype=np.int64),
        }
        ar["np_key"] = key
    return ar


def _wire_concat(payloads) -> np.ndarray:
    """One contiguous buffer over a `ChunkedWirePayloads`' retained chunks
    (refs <= -2 index into it directly), cached on it. Chunks are appended,
    so each call copies only the chunks added since the last one; a chunk
    dropped since then (`generation` moved; a new chunk may since sit at
    its base) makes the buffer start over."""
    state = getattr(payloads, "_nat_wire", None)
    if state is None:
        state = {
            "arr": np.empty(4096, dtype=np.uint8),
            "len": 0,
            "n_chunks": 0,
            "gen": payloads.generation,
        }
        payloads._nat_wire = state
    chunks = payloads._chunks
    if state["gen"] != payloads.generation:
        state["len"] = 0
        state["n_chunks"] = 0
        state["gen"] = payloads.generation
    for _, flat in chunks[state["n_chunks"] :]:
        need = state["len"] + flat.size
        if need > state["arr"].size:
            grown = np.empty(max(need, state["arr"].size * 2), dtype=np.uint8)
            grown[: state["len"]] = state["arr"][: state["len"]]
            state["arr"] = grown
        state["arr"][state["len"] : need] = flat
        state["len"] = need
    state["n_chunks"] = len(chunks)
    return state["arr"][: state["len"]]


def _interner_tables(enc) -> dict:
    """The client and key tables the native finisher reads. Both interners
    only grow, so each table is cached on its interner and rebuilt only
    when it grew (a server answering single-doc syncs must not copy them
    per reply; it makes a new `EncoderTables` per reply over the same
    interners)."""
    interner, keys = enc.interner, enc.keys
    clients = getattr(interner, "_nat_table", None)
    if clients is None or clients[0] != len(interner):
        from_idx = np.asarray(interner.from_idx or [0], dtype=np.int64)
        clients = interner._nat_table = (len(interner), from_idx)
    names = getattr(keys, "_nat_table", None)
    if names is None or names[0] != len(keys):
        key_names = [keys.names[k].encode("utf-8") for k in range(len(keys))]
        key_blob = np.frombuffer(b"".join(key_names) or b"\0", dtype=np.uint8)
        key_off = np.zeros(len(key_names) + 1, dtype=np.int64)
        key_off[1:] = np.cumsum([len(k) for k in key_names], dtype=np.int64)
        names = keys._nat_table = (len(keys), key_blob, key_off)
    return {"n_interned": clients[0], "from_idx": clients[1], "n_keys": names[0], "key_blob": names[1],
            "key_off": names[2]}


class _FinisherContext:
    """What the native finisher reads of one `EncoderTables`, resolved once
    per call of `finish_encode_diff_batch` or `DiffPipeline.run`: the
    payload arenas, the retained wire bytes and the client and key tables.
    `native_route` is False for payload views the library cannot read (no
    ``items``: `RawPayloadView`, `UnitArenaView`); then `write` hands every
    doc to the Python finisher."""

    def __init__(self, enc):
        from ytpu_torch.ops.decode_kernel import ChunkedWirePayloads

        self.enc = enc
        payloads = enc.payloads
        self.native_route = isinstance(payloads, (PayloadStore, ChunkedWirePayloads))
        if not self.native_route:
            return
        if isinstance(payloads, ChunkedWirePayloads):
            store, wire, wire_len = payloads.store, _wire_concat(payloads), payloads.total_bytes
        else:
            store, wire, wire_len = payloads, np.empty(0, dtype=np.uint8), 0
        self.ar = _payload_native_arenas(store)
        self.wire = wire if wire.size else np.zeros(1, dtype=np.uint8)
        self.wire_len = wire_len
        self.tables = _interner_tables(enc)
        root = enc.root_name.encode("utf-8")
        self.root_len = len(root)
        self.root = np.frombuffer(root or b"\0", dtype=np.uint8)

    def _native_finish(self, arr: np.ndarray, n: int, n_threads: int) -> Tuple[List[Optional[bytes]], List[int]]:
        """The first `n` docs of the packed ``[d_pad, 15, R]`` int32 host
        rows `arr` in one library call: per doc its bytes, or None where
        the library left it to the Python finisher; and the statuses."""
        import ctypes

        if arr.dtype != np.int32 or not arr.flags.c_contiguous or arr.ndim != 3 or arr.shape[1] != FINISH_PLANES:
            raise ValueError(f"the finisher reads C-contiguous int32 [D, {FINISH_PLANES}, R] rows")
        d_pad, _, R = arr.shape
        if n > d_pad:
            raise ValueError(f"{n} docs asked of {d_pad} packed")
        base = arr.ctypes.data
        ar, np_ar, tables = self.ar, self.ar["np"], self.tables
        sel = np.arange(n, dtype=np.int32)

        def plane(k):
            return ctypes.cast(base + k * R * 4, ctypes.POINTER(ctypes.c_int32))

        def ptr(a, typ):
            return a.ctypes.data_as(ctypes.POINTER(typ))

        u8, i64 = ctypes.c_uint8, ctypes.c_int64
        fin = native.FinishIn(
            n_docs_total=d_pad,
            n_blocks_cap=R,
            **{name: plane(k) for k, name in enumerate(_FINISH_COLS)},
            ship=plane(12),
            offsets=plane(13),
            deleted=plane(14),
            sel=ptr(sel, ctypes.c_int32),
            n_sel=n,
            from_idx=ptr(tables["from_idx"], i64),
            n_interned=tables["n_interned"],
            key_blob=ptr(tables["key_blob"], u8),
            key_off=ptr(tables["key_off"], i64),
            n_keys=tables["n_keys"],
            root_name=ptr(self.root, u8),
            root_name_len=self.root_len,
            text_arena=ptr(np_ar["text"], u8),
            text_arena_len=len(ar["text"]),
            item_text_off=ptr(np_ar["text_off"], i64),
            item_text_units=ptr(np_ar["text_units"], i64),
            blob_arena=ptr(np_ar["blob"], u8),
            blob_arena_len=len(ar["blob"]),
            item_blob_off=ptr(np_ar["blob_off"], i64),
            item_blob_len=ptr(np_ar["blob_len"], i64),
            item_elem_base=ptr(np_ar["elem_base"], i64),
            item_elem_count=ptr(np_ar["elem_count"], i64),
            elem_off=ptr(np_ar["elem_off"], i64),
            elem_arena=ptr(np_ar["elem"], u8),
            elem_arena_len=len(ar["elem"]),
            n_items=ar["n"],
            wire=ptr(self.wire, u8),
            wire_len=self.wire_len,
        )
        blob, offs, lens, stat = native.finish_strided(fin, FINISH_PLANES * R, n_threads)
        return [blob[o : o + ln] if st == 0 else None for o, ln, st in zip(offs, lens, stat)], stat

    def write(self, arr: np.ndarray, n: int, n_threads: int, stats: "DiffStats") -> List[bytes]:
        """The wire bytes of the first `n` docs of the packed host rows
        `arr`: the native finisher's, and `_finish_rows`' for each doc it
        left alone (every doc where there is no native route), counted in
        ``stats.fallback_docs``; the library's statuses go to
        ``stats.statuses``."""
        if not self.native_route:
            stats.fallback_docs += n
            return [_finish_compacted(arr[j], self.enc) for j in range(n)]
        res, stat = self._native_finish(arr, n, n_threads)
        stats.statuses.extend(stat)
        out = []
        for j, payload in enumerate(res):
            if payload is None:
                stats.fallback_docs += 1
                payload = _finish_compacted(arr[j], self.enc)
            out.append(payload)
        return out


def finish_encode_diff_batch(state: DocStateBatch, docs, ship, offsets, deleted, enc,
                             stats: Optional["DiffStats"] = None) -> List[bytes]:
    """Wire payloads of many docs, byte-identical to `finish_encode_diff`
    of each: the device counts each selected doc's rows and compacts them
    (`compact_finisher_rows`; the width R is the largest count rounded up
    to a power of two, the doc selection padded to a power of two), one
    tensor crosses to the host, and one call of the native finisher writes
    every doc (on a thread pool from `FINISHER_MT_MIN_ROWS` rows), the
    Python finisher each doc it leaves. `docs` may repeat a doc. A given
    `stats` gets R, the rows, the threads, the library's statuses and the
    docs the Python finisher wrote."""
    docs = [int(d) for d in docs]
    stats = DiffStats() if stats is None else stats
    stats.n_docs = len(docs)
    bl = state.blocks
    D, B = bl.client.shape
    _check_doc_selection(np.asarray(docs, dtype=np.int64), D)
    if not docs:
        return []
    ctx = _FinisherContext(enc)
    dev = bl.client.device
    idx = _selection(docs, D, _next_pow2(len(docs)), dev)
    ship, offsets, deleted = (torch.as_tensor(a, device=dev) for a in (ship, offsets, deleted))
    counts = _finish_counts(bl.parent, ship, deleted, idx).cpu().numpy()
    R = stats.R = min(_next_pow2(int(counts.max(initial=1))), B)
    stats.total_rows = int(counts[: len(docs)].sum())
    stats.threads = _finisher_threads(stats.total_rows)
    arr = compact_finisher_rows(bl, ship, offsets, deleted, idx, R).cpu().numpy()
    return ctx.write(arr, len(docs), stats.threads, stats)


# --- the pipelined finisher ------------------------------------------------------------


@dataclass(frozen=True)
class DiffPlan:
    """Sub-batch plan of one `DiffPipeline.run`."""

    n_docs: int
    sub: int  # docs per sub-batch (a power of two)
    n_sub: int
    depth: int  # sub-batches in flight at most
    host_buffers: int  # pinned host buffers of compacted rows, one per in-flight sub-batch
    buffer_reuses: int  # times a host buffer is filled again


def plan_diff_pipeline(n_docs: int, sub_batch: int = 512, depth: int = 2) -> DiffPlan:
    """Sub-batches of a power-of-two width, never wider than the power-of-two
    bucket of the selection itself."""
    n = max(0, int(n_docs))
    if n == 0:
        return DiffPlan(0, 0, 0, depth, 0, 0)
    sub = min(_next_pow2(int(sub_batch), 1), _next_pow2(n, 1))
    n_sub = -(-n // sub)
    bufs = min(depth, n_sub)
    return DiffPlan(n, sub, n_sub, depth, bufs, n_sub - bufs)


@dataclass
class DiffStats:
    """One `DiffPipeline.run`: time per stage and what crossed to the host."""

    n_docs: int = 0
    sub: int = 0
    n_sub: int = 0
    depth: int = 0
    R: int = 0  # compacted row width (a power of two)
    total_rows: int = 0  # rows sent to the finisher over the whole call
    threads: int = 0  # the native finisher's threads for the whole call (0 = a pool, 1 = one)
    select_s: float = 0.0  # host time to issue counts, compaction and copies
    stall_s: float = 0.0  # host time waiting for a sub-batch's rows
    finish_s: float = 0.0  # host finisher
    d2h_bytes: int = 0
    max_inflight: int = 0
    syncs: int = 0  # blocking waits on the device (the counts, then one per sub-batch)
    buffer_reuses: int = 0
    fallback_docs: int = 0  # docs the Python finisher wrote: left by the library, or no native route
    statuses: List[int] = field(default_factory=list)  # the library's, per doc it was given (0 = written)


class DiffPipeline:
    """`finish_encode_diff_batch` in sub-batches that overlap: the device
    compacts sub-batch k+1 and copies it into a pinned host buffer, on a
    side CUDA stream, while the host finisher writes sub-batch k. One
    blocking pull of the per-doc counts sizes R for the whole call, so a
    run makes ``n_sub + 1`` blocking waits, none per doc. Each in-flight
    sub-batch has its own host buffer, filled again only after its
    finisher has returned; the doc selection is a fresh host array per
    sub-batch, copied synchronously. Each sub-batch is one call of the
    native finisher (threads by its rows), with the Python finisher for
    each doc it leaves. On CPU tensors the stages run one after another.
    Byte output equals `finish_encode_diff_batch`'s."""

    def __init__(self, sub_batch: int = 512, depth: int = 2):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if sub_batch < 1:
            raise ValueError(f"sub_batch must be >= 1, got {sub_batch}")
        self.sub_batch = sub_batch
        self.depth = depth
        self.stats = DiffStats()

    def plan(self, n_docs: int) -> DiffPlan:
        return plan_diff_pipeline(n_docs, self.sub_batch, self.depth)

    def run(self, state: DocStateBatch, docs, ship, offsets, deleted, enc) -> List[bytes]:
        """The payloads of `docs`, in order. Counts ``encode.pipeline_runs``
        for a non-empty selection and, with the phase recorder on, folds
        the run's stage times into ``encode.select`` / ``encode.finish``
        and its host-bound bytes into ``encode.d2h_bytes`` / ``encode.d2h``."""
        from ytpu_torch.utils.metrics import metrics
        from ytpu_torch.utils.phases import phases

        with torch.profiler.record_function("ytpu_torch.finisher"):
            out = self._run(state, docs, ship, offsets, deleted, enc)
        stats = self.stats
        if stats.n_docs:
            metrics.counter("encode.pipeline_runs").inc()
            if phases.enabled:
                phases.add_time("encode.select", stats.select_s, stats.n_sub)
                phases.add_time("encode.finish", stats.finish_s, stats.n_sub)
                phases.add_value("encode.d2h_bytes", stats.d2h_bytes)
                phases.transfer("encode.d2h", stats.d2h_bytes, "d2h")
        return out

    def _run(self, state: DocStateBatch, docs, ship, offsets, deleted, enc) -> List[bytes]:
        docs = [int(d) for d in docs]
        stats = self.stats = DiffStats(n_docs=len(docs), depth=self.depth)
        if not docs:
            return []
        bl = state.blocks
        D, B = bl.client.shape
        _check_doc_selection(np.asarray(docs, dtype=np.int64), D)
        ctx = _FinisherContext(enc)
        dev = bl.client.device
        ship, offsets, deleted = (torch.as_tensor(a, device=dev) for a in (ship, offsets, deleted))
        plan = self.plan(len(docs))
        stats.sub, stats.n_sub, stats.buffer_reuses = plan.sub, plan.n_sub, plan.buffer_reuses

        t0 = time.perf_counter()
        idx = _selection(docs, D, _next_pow2(len(docs)), dev)
        counts = _finish_counts(bl.parent, ship, deleted, idx).cpu().numpy()[: len(docs)]
        stats.syncs += 1
        stats.select_s += time.perf_counter() - t0
        R = stats.R = min(_next_pow2(int(counts.max(initial=1))), B)
        stats.total_rows = int(counts.sum())
        stats.threads = _finisher_threads(stats.total_rows)

        cuda = dev.type == "cuda"
        side = torch.cuda.Stream(dev) if cuda else None
        if cuda:
            side.wait_stream(torch.cuda.current_stream(dev))
        bufs = [
            torch.empty((plan.sub, FINISH_PLANES, R), dtype=I32, pin_memory=cuda)
            for _ in range(plan.host_buffers)
        ]
        out: List[bytes] = [b""] * len(docs)
        inflight: deque = deque()

        def produce(k: int):
            lo, hi = k * plan.sub, min((k + 1) * plan.sub, len(docs))
            buf = bufs[k % len(bufs)]
            t0 = time.perf_counter()
            if cuda:
                with torch.cuda.stream(side):
                    sel = _selection(docs[lo:hi], D, plan.sub, dev)
                    rows = compact_finisher_rows(bl, ship, offsets, deleted, sel, R)
                    buf.copy_(rows, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record(side)
            else:
                sel = _selection(docs[lo:hi], D, plan.sub, dev)
                buf.copy_(compact_finisher_rows(bl, ship, offsets, deleted, sel, R))
                done = None
            stats.select_s += time.perf_counter() - t0
            inflight.append((lo, hi, buf, done))
            stats.max_inflight = max(stats.max_inflight, len(inflight))

        def consume():
            lo, hi, buf, done = inflight.popleft()
            t0 = time.perf_counter()
            if done is not None:
                done.synchronize()
            stats.syncs += 1
            stats.stall_s += time.perf_counter() - t0
            t0 = time.perf_counter()
            arr = buf.numpy()
            stats.d2h_bytes += arr.nbytes
            out[lo:hi] = ctx.write(arr, hi - lo, _finisher_threads(counts[lo:hi].sum()), stats)
            stats.finish_s += time.perf_counter() - t0

        for k in range(plan.n_sub):
            if len(inflight) == len(bufs):
                consume()  # frees the buffer sub-batch k fills
            produce(k)
        while inflight:
            consume()
        return out


# --- host read-out ---------------------------------------------------------------


def _move_bounds(bl, n: int, s: int, doc_start: int = -1):
    """Host resolution of move row s's (start, end) slots: assoc After ->
    the slot starting at the sticky id; assoc Before -> the right neighbor
    of the slot ending at it. Branch-scoped bounds (id client -1) read as
    sequence head / tail."""

    def covering(c: int, k: int) -> int:
        m = np.nonzero(
            (bl.client[:n] == c)
            & (bl.clock[:n] <= k)
            & (k < bl.clock[:n] + bl.length[:n])
        )[0]
        return int(m[0]) if len(m) else -1

    if int(bl.mv_sc[s]) < 0:
        i = doc_start
    else:
        i = covering(int(bl.mv_sc[s]), int(bl.mv_sk[s]))
        if int(bl.mv_sa[s]) < 0:  # assoc Before: exclusive left bound
            i = int(bl.right[i]) if i >= 0 else -1
    if int(bl.mv_ec[s]) < 0:
        j = -1  # walk to the sequence tail
    else:
        j = covering(int(bl.mv_ec[s]), int(bl.mv_ek[s]))
        if int(bl.mv_ea[s]) < 0:
            j = int(bl.right[j]) if j >= 0 else -1
    return i, j


def _visible_walk(bl, n: int, start: int):
    """Yield slots in visible order, honoring move ranges: a row whose
    `moved` owner differs from the current scope is skipped (it renders at
    its destination); a live move row descends into its range. Callers
    apply their own deleted/countable filters."""
    stack: List[Tuple[int, int, int]] = []
    cur, scope, scope_end = start, -1, -1
    n_moves = int(np.sum((bl.kind[:n] == CONTENT_MOVE) & ~bl.deleted[:n]))
    steps, limit = 0, (n + 2) * (n_moves + 2)
    while True:
        if cur < 0 or (scope_end >= 0 and cur == scope_end):
            if stack:
                cur, scope, scope_end = stack.pop()
                continue
            break
        steps += 1
        if steps > limit:
            raise RuntimeError("cycle detected in move-aware walk")
        kind = int(bl.kind[cur])
        if kind == CONTENT_MOVE and not bl.deleted[cur] and int(bl.moved[cur]) == scope:
            s_ptr, e_ptr = _move_bounds(bl, n, cur, doc_start=start)
            stack.append((int(bl.right[cur]), scope, scope_end))
            scope, scope_end = cur, e_ptr
            cur = s_ptr
            continue
        if int(bl.moved[cur]) == scope and kind != CONTENT_MOVE:
            yield cur
        cur = int(bl.right[cur])


def get_string(state: DocStateBatch, doc: int, payloads) -> str:
    """Visible text of one doc: the block columns are pulled to the host
    and walked in move-aware sequence order; `payloads` resolves
    ``(content_ref, content_off, length)`` to text (`slice_text`)."""
    bl = BlockCols(*(np.asarray(a[doc].cpu()) for a in state.blocks))
    out: List[str] = []
    n = int(state.n_blocks[doc])
    for idx in _visible_walk(bl, n, int(state.start[doc])):
        if not bl.deleted[idx] and bl.kind[idx] == CONTENT_STRING:
            out.append(
                payloads.slice_text(
                    int(bl.content_ref[idx]),
                    int(bl.content_off[idx]),
                    int(bl.length[idx]),
                )
            )
    return "".join(out)


class Diff:
    """One run of a formatted text rendering: a value and the formatting
    attributes in force (copy of the JAX package's ``types.text.Diff``;
    types/text.rs:1103). ``ychange`` is always None here: a device
    rendering has no snapshot to diff against (the host `Text.diff_range`
    of `ytpu_torch.types.text` has)."""

    __slots__ = ("insert", "attributes", "ychange")

    def __init__(self, insert, attributes: Optional[dict] = None, ychange=None):
        self.insert = insert
        self.attributes = attributes
        self.ychange = ychange

    def __eq__(self, other):
        if not isinstance(other, Diff):
            return NotImplemented
        return (
            self.insert == other.insert
            and (self.attributes or None) == (other.attributes or None)
            and self.ychange == other.ychange
        )

    def __repr__(self):
        return f"Diff({self.insert!r}, {self.attributes!r})"


def get_diff(state: DocStateBatch, doc: int, payloads) -> list:
    """A doc's visible root text as formatted runs, the device-state form
    of ``Text.diff()`` (types/text.rs:534-): string content in runs under
    the formatting attributes in force, a ContentFormat that changes an
    attribute ending the run, embeds and shared types each a run of their
    own. A shared type's run holds its decoded TypeRef (`payloads.
    type_branch`, or the host-lane `Branch`): the port has no
    user-facing shared-type views."""
    bl = BlockCols(*(np.asarray(a[doc].cpu()) for a in state.blocks))
    n = int(state.n_blocks[doc])
    runs: list = []
    attrs: dict = {}
    buf: List[str] = []

    def flush():
        if buf:
            runs.append(Diff("".join(buf), dict(attrs) if attrs else None))
            buf.clear()

    for i in _visible_walk(bl, n, int(state.start[doc])):
        if bl.deleted[i]:
            continue
        kind = int(bl.kind[i])
        ref = int(bl.content_ref[i])
        if kind == CONTENT_STRING:
            buf.append(payloads.slice_text(ref, int(bl.content_off[i]), int(bl.length[i])))
        elif kind == CONTENT_FORMAT:
            fkey, fval = payloads.format_kv(ref)
            if attrs.get(fkey) != fval:
                flush()
            if fval is None:
                attrs.pop(fkey, None)
            else:
                attrs[fkey] = fval
        elif kind in (CONTENT_EMBED, CONTENT_TYPE):
            flush()
            if kind == CONTENT_EMBED:
                value = payloads.embed_value(ref)
            else:
                tb = getattr(payloads, "type_branch", None)
                value = tb(ref) if tb is not None else payloads.items[ref][1].branch
            runs.append(Diff(value, dict(attrs) if attrs else None))
    flush()
    return runs


def get_values(state: DocStateBatch, doc: int, payloads) -> list:
    """A doc's visible sequence values (the Array tenant)."""
    bl = BlockCols(*(np.asarray(a[doc].cpu()) for a in state.blocks))
    out: list = []
    for idx in _visible_walk(bl, int(state.n_blocks[doc]), int(state.start[doc])):
        if not bl.deleted[idx] and bl.countable[idx]:
            kind = int(bl.kind[idx])
            ref = int(bl.content_ref[idx])
            off = int(bl.content_off[idx])
            ln = int(bl.length[idx])
            if kind == CONTENT_STRING:
                out.extend(payloads.slice_text(ref, off, ln))
            elif kind == CONTENT_ANY:
                out.extend(payloads.slice_values(ref, off, ln))
    return out


def get_map(state: DocStateBatch, doc: int, payloads, keys: KeyInterner) -> dict:
    """The root branch's visible map component: the live value of key k is
    the tail of k's item chain (the row with key k and right -1; a deleted
    tail means the key is absent, map.rs:285)."""
    return get_tree(state, doc, payloads, keys)["map"]


def get_tree(state: DocStateBatch, doc: int, payloads, keys: KeyInterner, interner=None) -> dict:
    """A doc's full branch tree: the root's sequence and map components,
    nested shared types rendered by their TypeRef (text -> str, map ->
    dict, array and xml -> list), and the non-primary named roots under
    ``"roots"``.

    Nested branches live in the same block table: a ContentType row owns a
    child sequence through its `head` column, and child map chains name it
    in their `parent` column (the Branch projections of branch.rs:173-215).
    With the `ClientInterner`, WeakRef branches render as their quoted
    values (weak.rs:303-372); without it as empty sequences."""
    from ytpu_torch.core.branch import TYPE_MAP, TYPE_TEXT, TYPE_WEAK, TYPE_XML_TEXT
    from ytpu_torch.core.moving import ASSOC_BEFORE

    bl = BlockCols(*(np.asarray(a[doc].cpu()) for a in state.blocks))
    n = int(state.n_blocks[doc])

    def render_type(i: int):
        ref = int(bl.content_ref[i])
        tb = getattr(payloads, "type_branch", None)
        branch = tb(ref) if tb is not None else payloads.items[ref][1].branch
        tr = branch.type_ref
        if tr == TYPE_WEAK:
            # weak branches only come from the host lane (the device
            # decoder flags WeakRef ContentType)
            return render_weak(payloads.items[ref][1])
        seq, mp = render_branch(int(bl.head[i]), i)
        if tr in (TYPE_TEXT, TYPE_XML_TEXT):
            return "".join(v for v in seq if isinstance(v, str))
        if tr == TYPE_MAP:
            return mp
        return seq

    def render_weak(content):
        """Quoted-range values from the columns: whole covering blocks,
        trimmed where a bound id falls inside one, up to the end id."""
        src = getattr(content.branch, "link_source", None)
        if interner is None or src is None or src.quote_start.id is None:
            return []
        sc = interner.to_idx.get(src.quote_start.id.client)
        if sc is None:
            return []
        sk = src.quote_start.id.clock
        m = np.nonzero((bl.client[:n] == sc) & (bl.clock[:n] <= sk) & (sk < bl.clock[:n] + bl.length[:n]))[0]
        if not len(m):
            return []
        i = int(m[0])
        eid = src.quote_end.id
        ec = interner.to_idx.get(eid.client) if eid is not None else None
        out: list = []
        steps = 0
        first = True
        while i >= 0 and steps <= n:
            steps += 1
            ck, ln = int(bl.clock[i]), int(bl.length[i])
            same_client = eid is not None and ec is not None and int(bl.client[i]) == ec
            contains_end = same_client and ck <= eid.clock < ck + ln
            if not bl.deleted[i] and bl.countable[i]:
                vals = render_row_values(i)
                a = 0
                if first and int(bl.client[i]) == sc and ck <= sk < ck + ln:
                    a = sk - ck
                    if src.quote_start.assoc == ASSOC_BEFORE:
                        a += 1
                b = len(vals)
                if contains_end:
                    b = eid.clock - ck
                    if src.quote_end.assoc != ASSOC_BEFORE:
                        b += 1
                out.extend(vals[a:b])
            first = False
            if contains_end:
                break
            i = int(bl.right[i])
        return out

    def render_row_values(i: int) -> list:
        kind = int(bl.kind[i])
        ref = int(bl.content_ref[i])
        off = int(bl.content_off[i])
        ln = int(bl.length[i])
        if kind == CONTENT_STRING:
            return list(payloads.slice_text(ref, off, ln))
        if kind == CONTENT_ANY:
            return payloads.slice_values(ref, off, ln)
        if kind == CONTENT_TYPE:
            return [render_type(i)]
        if kind == CONTENT_JSON:
            return payloads.json_values(ref, off, ln)
        if kind == CONTENT_EMBED:
            return [payloads.embed_value(ref)]
        if kind == CONTENT_BINARY:
            return [payloads.binary_value(ref)]
        if ref >= 0:
            payload = payloads.items[ref][1]
            if hasattr(payload, "values"):
                return list(payload.values())
        return []

    def render_branch(head: int, parent_row: int):
        seq: list = []
        for idx in _visible_walk(bl, n, head):
            if not bl.deleted[idx] and bl.countable[idx] and bl.key[idx] < 0:
                seq.extend(render_row_values(idx))
        mp: dict = {}
        for i in range(n):
            if (int(bl.key[i]) >= 0 and int(bl.parent[i]) == parent_row and int(bl.right[i]) == -1
                    and not bl.deleted[i]):
                name = keys.names.get(int(bl.key[i]))
                vals = render_row_values(i)
                if name is not None and vals:
                    mp[name] = vals[-1]
        return seq, mp

    seq, mp = render_branch(int(state.start[doc]), -1)
    out = {"seq": seq, "map": mp}
    # non-primary named roots live behind per-doc anchor rows
    roots: dict = {}
    for i in range(n):
        if int(bl.kind[i]) == BLOCK_ROOT_ANCHOR:
            name = keys.names.get(int(bl.key[i]))
            r_seq, r_mp = render_branch(int(bl.head[i]), i)
            if name is not None:
                roots[name] = {"seq": r_seq, "map": r_mp}
    if roots:
        out["roots"] = roots
    return out
