"""Batched block-state layout and host read-out (PyTorch port of
`ytpu.models.batch_doc`).

The layout part mirrors the JAX module name for name: `BlockCols` /
`DocStateBatch` / `UpdateBatch` are NamedTuples of tensors, `init_state`
allocates an empty doc batch on an explicit device, and the scan-record
and commitment helpers are the same functions over torch tensors. The
read-out part (`get_string`, `_visible_walk`, `_move_bounds`) runs on the
host over numpy copies of the columns.

uint32 arithmetic (the commitment fold) is emulated in int64 with
``& 0xFFFFFFFF`` masks: torch has no general uint32 arithmetic.
"""

from __future__ import annotations

import os
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from ytpu_torch.core.content import CONTENT_MOVE, CONTENT_STRING
from ytpu_torch.core.device import resolve_device

__all__ = [
    "BlockCols",
    "DocStateBatch",
    "UpdateBatch",
    "COL_DEFAULTS",
    "init_state",
    "mark_origin_slot_stale",
    "origin_slot_is_stale",
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
# The fused integrate passes the origin_slot plane through without
# maintaining it, so its output marks the plane STALE: a host-side flag
# keyed on the plane tensor's identity, retired by `weakref.finalize` when
# the tensor dies so a recycled id never reads as stale. The port has no
# reader of the plane yet (the XLA-lane applies that rebuild it are not
# ported), so nothing refreshes it.

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
