"""Packed-state integrate: the hand-written CUDA kernel, its plain PyTorch
version, the chunk program and the chunked replay driver (PyTorch port of
`ytpu.ops.integrate_kernel`).

The state lives in the packed layout of the JAX package: ``cols`` is an
``[NC=26, D, C]`` int32 plane stack and ``meta`` a ``[D, M_PAD=32]`` int32
tile. `integrate_stream` integrates an ``[S, U, 23]`` row / ``[S, R, 4]``
delete stream into every doc, in place. On a CUDA tensor it launches the
kernel of ``csrc/integrate.cu``; on a CPU tensor it runs
`integrate_stream_reference`, the plain version of the same function
written like the Pallas kernel (vectorized over docs with ``[D, C]``
masks). `integrate_batch` integrates one step of each doc's own ``[D, U,
23]`` rows / ``[D, R, 4]`` deletes (the write path of
`batch_doc.apply_update_batch`) through the kernel's per-doc entry; its
plain version is the stream one run on each doc's one-step stream.
"""

from __future__ import annotations

import ctypes
import time
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ytpu_torch.core.content import (
    BLOCK_GC,
    BLOCK_ROOT_ANCHOR,
    CONTENT_DELETED,
    CONTENT_FORMAT,
    CONTENT_MOVE,
)
from ytpu_torch.models.batch_doc import (
    DEFAULT_COMPACTION_POLICY,
    SCAN_REC_CHEAP,
    SCAN_REC_MAX,
    SCAN_REC_WORDS,
    SCAN_WIDTH_BUCKETS,
    U32_MASK,
    BlockCols,
    DocStateBatch,
    UpdateBatch,
    apply_update_stream_fused,  # re-exported: ytpu keeps it in ops.integrate_kernel
    commit_fold_blocks,
    scan_tier_plan,
    scan_width_bucket,
    scan_width_quantile,
)
from ytpu_torch.utils.faults import FaultError, faults
from ytpu_torch.utils.metrics import metrics as _metrics
from ytpu_torch.utils.phases import NULL_SPAN, _nbytes, phases as _phases, program_memory as _program_memory

__all__ = [
    "NC",
    "M_PAD",
    "N_READOUT",
    "pack_state",
    "unpack_state",
    "pack_stream",
    "integrate_stream",
    "integrate_stream_profile",
    "integrate_stream_reference",
    "integrate_batch",
    "integrate_batch_profile",
    "integrate_batch_reference",
    "launch_plan",
    "batch_launch_plan",
    "scratch_cleared",
    "apply_update_stream_fused",
    "replay_stream_fused",
    "replay_chunk_program",
    "replay_chunk_program_raw",
    "packed_capacity_ledger",
    "ChunkUpload",
    "PackedReplayDriver",
    "ReplayChunkStats",
    "ReplayFault",
    "lane_health",
]

I32 = torch.int32

# plane indices in the packed [NC, D, C] state
(
    CL,  # client
    CK,  # clock
    LN,  # length
    OC,  # origin client
    OK,  # origin clock
    RC,  # right-origin client
    RK,  # right-origin clock
    LT,  # left link
    RT,  # right link
    DL,  # deleted flag
    CN,  # countable flag
    KD,  # content kind
    RF,  # content ref
    OF,  # content offset
    KEY,  # interned parent_sub (-1 = sequence item)
    PA,  # parent ContentType row (-1 = root)
    HD,  # child-sequence head (ContentType rows)
    MV,  # slot of the move row owning this row (-1 = unowned)
    MSC,  # move rows: range-start id client
    MSK,  # move rows: range-start id clock
    MSA,  # move rows: start assoc
    MEC,  # move rows: range-end id client
    MEK,  # move rows: range-end id clock
    MEA,  # move rows: end assoc
    MPR,  # move rows: conflict priority
    OS,  # cached origin slot: the integrate kernel neither reads nor writes it
) = range(26)
NC = 26

# meta words of the packed [D, 32] tile
M_START, M_NBLOCKS, M_ERROR, M_MDIRTY = 0, 1, 2, 3
M_HIST0 = 4
M_SCANW_MAX = M_HIST0 + SCAN_REC_MAX  # 12
M_TIER_CHEAP = M_HIST0 + SCAN_REC_CHEAP  # 13
M_TIER_WIDE = M_TIER_CHEAP + 1  # 14
M_CHEAP_TRIPS = M_TIER_CHEAP + 2  # 15
M_WIDE_TRIPS = M_TIER_CHEAP + 3  # 16
M_WIDTH_SUM = M_TIER_CHEAP + 4  # 17
M_SCAN_END = M_HIST0 + SCAN_REC_WORDS  # 18 (exclusive)
M_PAD = 32

#: capacity-ledger readout words: sum of occupied rows, sum of dead rows,
#: max per-doc dead rows
LEDGER_WORDS = 3
#: per-chunk readout: (max n_blocks, max error, decode flags), the scan
#: record summed over docs (max for its max word), the commitment word,
#: the ledger words
N_READOUT = 3 + SCAN_REC_WORDS + 1 + LEDGER_WORDS

ERR_CAPACITY = 1
ERR_MISSING_DEP = 2

_FIELD_PLANES = (
    "client", "clock", "length", "origin_client", "origin_clock",
    "ror_client", "ror_clock", "left", "right", "deleted", "countable",
    "kind", "content_ref", "content_off", "key", "parent", "head", "moved",
    "mv_sc", "mv_sk", "mv_sa", "mv_ec", "mv_ek", "mv_ea", "mv_prio",
    "origin_slot",
)


def pack_state(state: DocStateBatch) -> Tuple[torch.Tensor, torch.Tensor]:
    cols = torch.stack(
        [getattr(state.blocks, name).to(I32) for name in _FIELD_PLANES]
    )  # [NC, D, C]
    D = state.start.shape[0]
    meta = torch.zeros((D, M_PAD), dtype=I32, device=cols.device)
    meta[:, M_START] = state.start
    meta[:, M_NBLOCKS] = state.n_blocks
    meta[:, M_ERROR] = state.error
    return cols, meta


def unpack_state(cols: torch.Tensor, meta: torch.Tensor) -> DocStateBatch:
    planes = {name: cols[i] for i, name in enumerate(_FIELD_PLANES)}
    planes["deleted"] = planes["deleted"].to(torch.bool)
    planes["countable"] = planes["countable"].to(torch.bool)
    return DocStateBatch(
        blocks=BlockCols(**planes),
        start=meta[:, M_START],
        n_blocks=meta[:, M_NBLOCKS],
        error=meta[:, M_ERROR],
    )


def pack_stream(stream: UpdateBatch) -> Tuple[torch.Tensor, torch.Tensor]:
    """Doc-free stream -> rows [S, U, 23] / dels [S, R, 4] int32."""
    rows = torch.stack(
        [
            stream.client, stream.clock, stream.length,
            stream.origin_client, stream.origin_clock,
            stream.ror_client, stream.ror_clock,
            stream.kind, stream.content_ref, stream.content_off,
            stream.key, stream.p_tag, stream.p_client, stream.p_clock,
            stream.valid.to(I32),
            stream.mv_sc, stream.mv_sk, stream.mv_sa,
            stream.mv_ec, stream.mv_ek, stream.mv_ea, stream.mv_prio,
            stream.p_root,
        ],
        dim=-1,
    ).to(I32)
    dels = torch.stack(
        [stream.del_client, stream.del_start, stream.del_end, stream.del_valid.to(I32)],
        dim=-1,
    ).to(I32)
    return rows.contiguous(), dels.contiguous()


# --- plain version -------------------------------------------------------------


def integrate_stream_reference(cols, meta, rows, dels, rank, scan_plan=(32, 8)):
    """Integrate the stream into every doc, in place: the plain PyTorch
    version of the Pallas `_kernel` (ytpu/ops/integrate_kernel.py:283),
    written the same way: every per-doc lookup is a one-hot sweep over the
    C slots, every branch a mask, and the conflict scan runs the two-tier
    (cheap / wide) loop of the kernel. Returns ``(cols, meta)``."""
    _, D, C = cols.shape
    dev = cols.device
    cheap_bound, wide_unroll = scan_plan
    rows_l = rows.cpu().tolist()
    dels_l = dels.cpu().tolist()
    rank = rank.reshape(-1).to(dev)
    K = rank.shape[0]
    iota_c = torch.arange(C, dtype=I32, device=dev)[None, :].expand(D, C)
    didx = torch.arange(D, device=dev)

    def full(v):
        return torch.full((D,), int(v), dtype=I32, device=dev)

    def n_blocks():
        return meta[:, M_NBLOCKS].clone()

    def gather(i, idx, fill):
        """cols[i][d, idx[d]]; idx < 0 -> fill, idx >= C -> 0."""
        v = cols[i].gather(1, idx.clamp(0, C - 1).long()[:, None])[:, 0]
        v = torch.where(idx >= C, torch.zeros_like(v), v)
        return torch.where(idx >= 0, v, fill if torch.is_tensor(fill) else full(fill))

    def put(i, idx, val, active):
        """cols[i][d, idx[d]] = val[d] where active[d] and 0 <= idx < C."""
        mask = active & (idx >= 0) & (idx < C)
        val = val if torch.is_tensor(val) else full(val)
        cols[i, didx[mask], idx[mask].long()] = val[mask]

    def put_many(idx, active, writes):
        """Several planes at one slot per doc, as one indexed store."""
        mask = active & (idx >= 0) & (idx < C)
        planes = torch.tensor([i for i, _ in writes], device=dev)
        vals = torch.stack([v if torch.is_tensor(v) else full(v) for _, v in writes])
        cols[planes[:, None], didx[mask][None, :], idx[mask].long()[None, :]] = vals[:, mask]

    def gather_all(idx):
        """Every plane at idx[d] per doc ([NC, D]); idx >= C -> 0. Callers
        read it only for docs whose idx is a valid slot."""
        v = cols[:, didx, idx.clamp(0, C - 1).long()]
        return torch.where((idx >= C)[None, :], torch.zeros_like(v), v)

    def gather_rank(client_v):
        c = client_v.clamp(min=0)
        r = rank[c.clamp(max=max(K - 1, 0)).long()]
        return torch.where(c < K, r, torch.zeros_like(r))

    def find_slot(client_v, clock_v, enable):
        valid = iota_c < n_blocks()[:, None]
        m = (
            valid
            & (cols[CL] == client_v[:, None])
            & (cols[CK] <= clock_v[:, None])
            & (clock_v[:, None] < cols[CK] + cols[LN])
            & enable[:, None]
        )
        idx = torch.where(m, iota_c, C).min(dim=1).values.to(I32)
        found = idx < C
        return torch.where(found, idx, full(-1)), found

    def client_clock(client_s):
        valid = iota_c < n_blocks()[:, None]
        m = valid & (cols[CL] == client_s)
        return torch.where(m, cols[CK] + cols[LN], 0).max(dim=1).values.to(I32)

    def first_slot(mask):
        idx = torch.where(mask, iota_c, C).min(dim=1).values.to(I32)
        return idx, idx < C

    def split(i_idx, off, want):
        length_i = gather(LN, i_idx, 0)
        do = want & (i_idx >= 0) & (off > 0) & (off < length_i)
        j = n_blocks()
        overflow = do & (j >= C)
        do = do & (j < C)
        meta[:, M_ERROR] |= torch.where(overflow, ERR_CAPACITY, 0).to(I32)
        if bool(do.any()):
            # written only where do, i.e. where i_idx is a valid slot
            row = gather_all(i_idx)
            right_i = torch.where(i_idx >= 0, row[RT], full(-1))
            put_many(
                j, do,
                [
                    (CL, row[CL]),
                    (CK, row[CK] + off),
                    (LN, length_i - off),
                    (OC, row[CL]),
                    (OK, row[CK] + off - 1),
                    (RC, row[RC]),
                    (RK, row[RK]),
                    (LT, i_idx),
                    (RT, right_i),
                    (DL, row[DL]),
                    (CN, row[CN]),
                    (KD, row[KD]),
                    (RF, row[RF]),
                    (OF, row[OF] + off),
                    (KEY, row[KEY]),
                    (PA, row[PA]),
                    (HD, row[HD]),
                    (MV, row[MV]),
                    (MSC, -1), (MSK, 0), (MSA, 0),
                    (MEC, -1), (MEK, 0), (MEA, 0), (MPR, -1),
                ],
            )
            put_many(i_idx, do, [(LN, off), (RT, j)])
            put(LT, right_i, j, do & (right_i >= 0))
            meta[:, M_NBLOCKS] = n_blocks() + do.to(I32)
        return torch.where(do, j, i_idx)

    def clean_end(client_v, clock_v, enable):
        i, found = find_slot(client_v, clock_v, enable)
        off = clock_v - gather(CK, i, 0) + 1
        split(i, off, enable & found)
        return i, found

    def clean_start(client_v, clock_v, enable):
        i, found = find_slot(client_v, clock_v, enable)
        off = clock_v - gather(CK, i, 0)
        j = split(i, off, enable & found)
        return torch.where((i >= 0) & (off > 0), j, i), found

    def origins_equal(ha, ca, ka, hb, cb, kb):
        return (~ha & ~hb) | (ha & hb & (ca == cb) & (ka == kb))

    def integrate_row(r):
        (r_client, r_clock, r_len, r_oc, r_ok, r_rc, r_rk, r_kind, r_ref,
         r_off, r_key, r_ptag, r_pclient, r_pclock, _valid, r_mv_sc, r_mv_sk,
         r_mv_sa, r_mv_ec, r_mv_ek, r_mv_ea, r_mv_prio, r_proot) = r
        is_move_row = r_kind == CONTENT_MOVE

        local = client_clock(r_client)
        applicable = local >= r_clock
        missing = ~applicable
        offset = local - r_clock
        dup = applicable & (offset >= r_len)
        do = applicable & ~dup

        clock = r_clock + offset
        length = r_len - offset
        c_off = r_off + offset
        has_origin = (offset > 0) | (r_oc >= 0)
        origin_client = torch.where(offset > 0, full(r_client), full(r_oc))
        origin_clock = torch.where(offset > 0, clock - 1, full(r_ok))
        has_ror = r_rc >= 0
        has_ror_v = torch.full((D,), has_ror, dtype=torch.bool, device=dev)
        is_gc = r_kind == BLOCK_GC
        linkable = do & (not is_gc)

        left_idx, _ = clean_end(origin_client, origin_clock, linkable & has_origin)
        right_idx, _ = clean_start(full(r_rc), full(r_rk), linkable & has_ror)
        left_idx = torch.where(linkable & has_origin, left_idx, full(-1))
        right_idx = torch.where(linkable & has_ror, right_idx, full(-1))
        anchor_missing = (linkable & has_origin & (left_idx < 0)) | (
            linkable & has_ror & (right_idx < 0)
        )
        missing = missing | anchor_missing
        linkable = linkable & ~anchor_missing

        parent_slot, _ = find_slot(
            full(r_pclient), full(r_pclock), linkable & (r_ptag == 2)
        )
        left_parent = gather(PA, left_idx, -1)
        right_parent = gather(PA, right_idx, -1)
        inherited_parent = torch.where(left_idx >= 0, left_parent, right_parent)
        anchor_idx, anchor_found = first_slot(
            (iota_c < n_blocks()[:, None])
            & (cols[KD] == BLOCK_ROOT_ANCHOR)
            & (cols[KEY] == r_proot)
        )
        root_row = torch.where((r_proot >= 0) & anchor_found, anchor_idx, full(-1))
        if r_ptag == 2:
            parent_row = parent_slot
        elif r_ptag == 1:
            parent_row = root_row
        else:
            parent_row = inherited_parent
        parent_missing = linkable & (
            ((r_ptag == 2) & (parent_slot < 0))
            | ((r_ptag == 1) & (r_proot >= 0) & ~anchor_found)
        )
        missing = missing | parent_missing
        linkable = linkable & ~parent_missing

        left_key = gather(KEY, left_idx, -1)
        right_key = gather(KEY, right_idx, -1)
        key_v = full(r_key) if r_key >= 0 else torch.where(left_key >= 0, left_key, right_key)
        is_map = key_v >= 0

        chain_idx, chain_ok = first_slot(
            (iota_c < n_blocks()[:, None])
            & (cols[KEY] == key_v[:, None])
            & (cols[PA] == parent_row[:, None])
            & (cols[LT] == -1)
            & is_map[:, None]
        )
        chain_head = torch.where(chain_ok, chain_idx, full(-1))
        seq_head = torch.where(
            parent_row >= 0, gather(HD, parent_row, -1), meta[:, M_START].clone()
        )
        anchor0_base = torch.where(is_map, chain_head, seq_head)

        right_left = gather(LT, right_idx, -1)
        need_scan = linkable & (
            ((left_idx < 0) & ((right_idx < 0) | (right_left >= 0)))
            | ((left_idx >= 0) & (gather(RT, left_idx, -1) != right_idx))
        )
        o0 = torch.where(left_idx >= 0, gather(RT, left_idx, -1), anchor0_base)
        o0 = torch.where(need_scan, o0, full(-1))
        rank_r = gather_rank(full(r_client))

        def scan_step(carry):
            o, left, conflicting, before, brk, width = carry
            active = (o >= 0) & (o != right_idx) & (brk == 0)
            width = width + active.to(I32)
            onehot_o = (iota_c == o[:, None]) & active[:, None]
            before = before | onehot_o
            conflicting = conflicting | onehot_o
            o_oc = gather(OC, o, -1)
            o_ok = gather(OK, o, 0)
            same_origin = origins_equal(
                has_origin, origin_client, origin_clock, o_oc >= 0, o_oc, o_ok
            )
            o_rc = gather(RC, o, -1)
            o_rk = gather(RK, o, 0)
            same_ror = origins_equal(has_ror_v, r_rc, r_rk, o_rc >= 0, o_rc, o_rk)
            rank_o = gather_rank(gather(CL, o, -1))
            case1_take = same_origin & (rank_o < rank_r)
            case1_break = same_origin & ~case1_take & same_ror
            oo_idx, oo_found = find_slot(o_oc, o_ok, active & (o_oc >= 0))
            at_oo = iota_c == oo_idx[:, None]
            in_before = oo_found & (before & at_oo).any(dim=1)
            in_conflicting = oo_found & (conflicting & at_oo).any(dim=1)
            case2_take = ~same_origin & in_before & ~in_conflicting
            case2_break = ~same_origin & ~in_before
            take = (case1_take | case2_take) & active
            left = torch.where(take, o, left)
            conflicting = conflicting & ~take[:, None]
            brk = brk | ((case1_break | case2_break) & active).to(I32)
            o_next = gather(RT, o, -1)
            o = torch.where(active & (brk == 0), o_next, o)
            return (o, left, conflicting, before, brk, width)

        def still_active(carry):
            o, _, _, _, brk, _ = carry
            return (o >= 0) & (o != right_idx) & (brk == 0)

        zeros = torch.zeros((D, C), dtype=torch.bool, device=dev)
        carry = (o0, left_idx, zeros, zeros, full(0), full(0))
        # cheap tier: one candidate per trip, all active docs in lockstep
        while bool((still_active(carry) & (carry[5] < cheap_bound)).any()):
            carry = scan_step(carry)
        # wide tier: `wide_unroll` masked candidate steps per trip
        wide_trips = full(0)
        while bool(still_active(carry).any()):
            wide_trips = wide_trips + still_active(carry).to(I32)
            for _ in range(wide_unroll):
                carry = scan_step(carry)
        left_scanned, scan_width = carry[1], carry[5]
        left_idx = torch.where(need_scan, left_scanned, left_idx)

        wb = scan_width.clamp(min=0)
        bucket = scan_width_bucket(wb)
        for k in range(SCAN_WIDTH_BUCKETS):
            meta[:, M_HIST0 + k] += (need_scan & (bucket == k)).to(I32)
        meta[:, M_SCANW_MAX] = torch.maximum(
            meta[:, M_SCANW_MAX], torch.where(need_scan, wb, 0).to(I32)
        )
        wide_used = need_scan & (wide_trips > 0)
        meta[:, M_TIER_CHEAP] += (need_scan & ~wide_used).to(I32)
        meta[:, M_TIER_WIDE] += wide_used.to(I32)
        meta[:, M_CHEAP_TRIPS] += torch.where(
            need_scan, wb.clamp(max=cheap_bound), 0
        ).to(I32)
        meta[:, M_WIDE_TRIPS] += torch.where(need_scan, wide_trips, 0).to(I32)
        meta[:, M_WIDTH_SUM] += torch.where(need_scan, wb, 0).to(I32)

        j = n_blocks()
        overflow = do & (j >= C)
        do = do & (j < C)
        linkable = linkable & (j < C)

        has_left = linkable & (left_idx >= 0)
        right_final = torch.where(
            has_left,
            gather(RT, left_idx, -1),
            torch.where(linkable, anchor0_base, full(-1)),
        )
        put(RT, left_idx, j, has_left)
        new_head = linkable & ~has_left & ~is_map
        meta[:, M_START] = torch.where(
            new_head & (parent_row < 0), j, meta[:, M_START]
        )
        put(HD, parent_row, j, new_head & (parent_row >= 0))
        put(LT, right_final, j, linkable & (right_final >= 0))

        parent_deleted = (parent_row >= 0) & (gather(DL, parent_row, 0) == 1)
        dead_on_arrival = linkable & (parent_deleted | (is_map & (right_final >= 0)))
        row_deleted = dead_on_arrival | (
            is_gc or r_kind == CONTENT_DELETED
        )
        row_countable = ~row_deleted & (
            r_kind != CONTENT_FORMAT and r_kind != CONTENT_MOVE
        )

        left_moved = torch.where(has_left, gather(MV, left_idx, -1), full(-1))
        right_moved = torch.where(
            right_final >= 0, gather(MV, right_final, -1), full(-1)
        )
        inherit_moved = torch.where(left_moved == right_moved, left_moved, full(-1))
        moved_conflict = linkable & (left_moved != right_moved)
        meta[:, M_MDIRTY] |= (moved_conflict | (do & is_move_row)).to(I32)

        put_many(
            j, do,
            [
                (CL, r_client),
                (CK, clock),
                (LN, length),
                (OC, torch.where(has_origin, origin_client, full(-1))),
                (OK, torch.where(has_origin, origin_clock, full(0))),
                (RC, r_rc if has_ror else -1),
                (RK, r_rk if has_ror else 0),
                (LT, torch.where(linkable, left_idx, full(-1))),
                (RT, torch.where(linkable, right_final, full(-1))),
                (DL, row_deleted.to(I32)),
                (CN, row_countable.to(I32)),
                (KD, r_kind),
                (RF, r_ref),
                (OF, c_off),
                (KEY, key_v),
                (PA, parent_row),
                (HD, -1),
                (MV, torch.where(linkable, inherit_moved, full(-1))),
                (MSC, r_mv_sc if is_move_row else -1),
                (MSK, r_mv_sk if is_move_row else 0),
                (MSA, r_mv_sa if is_move_row else 0),
                (MEC, r_mv_ec if is_move_row else -1),
                (MEK, r_mv_ek if is_move_row else 0),
                (MEA, r_mv_ea if is_move_row else 0),
                (MPR, r_mv_prio if is_move_row else -1),
            ],
        )
        new_tail = linkable & is_map & (right_final < 0)
        put(DL, left_idx, 1, new_tail & has_left)
        meta[:, M_NBLOCKS] = n_blocks() + do.to(I32)
        meta[:, M_ERROR] |= (
            torch.where(overflow, ERR_CAPACITY, 0) | torch.where(missing, ERR_MISSING_DEP, 0)
        ).to(I32)

    def delete_range(r):
        client, start, end = r[0], r[1], r[2]
        enable = torch.ones((D,), dtype=torch.bool, device=dev)
        client_v, start_v, end_v = full(client), full(start), full(end)
        i, found = find_slot(client_v, start_v, enable)
        i_ok = found & (gather(DL, i, 1) == 0)
        split(i, start_v - gather(CK, i, 0), i_ok)
        k, kfound = find_slot(client_v, end_v - 1, enable)
        k_ok = kfound & (gather(DL, k, 1) == 0)
        split(k, end_v - gather(CK, k, 0), k_ok)
        valid = iota_c < n_blocks()[:, None]
        m = (
            valid
            & (cols[CL] == client)
            & (cols[CK] >= start)
            & (cols[CK] + cols[LN] <= end)
        )
        hit_move = (m & (cols[KD] == CONTENT_MOVE) & (cols[DL] == 0)).any(dim=1)
        meta[:, M_MDIRTY] |= hit_move.to(I32)
        cols[DL] = torch.where(m, 1, cols[DL]).to(I32)

    # --- move ownership --------------------------------------------------
    def resolve_move_ptr(c_v, k_v, assoc_v, enable):
        after = assoc_v >= 0
        i_a, found_a = clean_start(c_v, k_v, enable & after & (c_v >= 0))
        i_b, found_b = clean_end(c_v, k_v, enable & ~after & (c_v >= 0))
        right_b = gather(RT, i_b, -1)
        ptr = torch.where(after, i_a, right_b)
        found = (after & found_a) | (~after & found_b)
        return ptr, found

    def claim_move(s_v, enable):
        msc = gather(MSC, s_v, -1)
        msk = gather(MSK, s_v, 0)
        msa = gather(MSA, s_v, 0)
        mec = gather(MEC, s_v, -1)
        mek = gather(MEK, s_v, 0)
        mea = gather(MEA, s_v, 0)
        start, s_found = resolve_move_ptr(msc, msk, msa, enable)
        endp, e_found = resolve_move_ptr(mec, mek, mea, enable)
        par = gather(PA, s_v, -1)
        seq_head = torch.where(par < 0, meta[:, M_START].clone(), gather(HD, par, -1))
        start = torch.where(msc < 0, seq_head, start)
        endp = torch.where(mec < 0, full(-1), endp)
        unresolved = enable & (((msc >= 0) & ~s_found) | ((mec >= 0) & ~e_found))
        meta[:, M_ERROR] |= torch.where(unresolved, ERR_MISSING_DEP, 0).to(I32)
        enable = enable & ~unresolved
        prio_s = gather(MPR, s_v, -1)
        rank_s = gather_rank(gather(CL, s_v, -1))
        clock_s = gather(CK, s_v, 0)
        cur, n = start, full(0)
        while True:
            active = enable & (cur >= 0) & (cur != endp) & (n <= C)
            if not bool(active.any()):
                break
            m = gather(MV, cur, -1)
            prev_prio = torch.where(m >= 0, gather(MPR, m, -1), full(-1))
            prev_rank = gather_rank(gather(CL, m, -1))
            prev_clock = gather(CK, m, 0)
            takes = (prev_prio < prio_s) | (
                (prev_prio == prio_s)
                & (m >= 0)
                & ((prev_rank < rank_s) | ((prev_rank == rank_s) & (prev_clock < clock_s)))
            )
            m_msc = gather(MSC, m, -1)
            m_collapsed = (
                (m >= 0)
                & (m_msc >= 0)
                & (m_msc == gather(MEC, m, -2))
                & (gather(MSK, m, 0) == gather(MEK, m, -1))
            )
            put(DL, m, 1, active & takes & m_collapsed)
            put(MV, cur, s_v, active & takes)
            cur = torch.where(active, gather(RT, cur, -1), cur)
            n = n + 1
        return enable

    def move_cycle(s_v, enable):
        def live_move(idx):
            return (gather(KD, idx, -1) == CONTENT_MOVE) & (gather(DL, idx, 1) == 0)

        first = gather(MV, s_v, -1)
        cur = torch.where(live_move(first), first, full(-1))
        n, hit = full(0), full(0)
        while True:
            active = enable & (cur >= 0) & (hit == 0) & (n <= C)
            if not bool(active.any()):
                break
            nxt = gather(MV, cur, -1)
            hit = hit | (active & (nxt == s_v) & (s_v >= 0)).to(I32)
            nxt = torch.where(live_move(nxt), nxt, full(-1))
            cur = torch.where(active, nxt, cur)
            n = n + 1
        return hit > 0

    def recompute_moves():
        dirty = meta[:, M_MDIRTY] > 0
        if bool(dirty.any()):
            cols[MV] = torch.where(dirty[:, None], -1, cols[MV]).to(I32)
            done = torch.zeros((D, C), dtype=torch.bool, device=dev)
            while True:
                am = (
                    (iota_c < n_blocks()[:, None])
                    & (cols[KD] == CONTENT_MOVE)
                    & (cols[DL] == 0)
                    & ~done
                    & dirty[:, None]
                )
                if not bool(am.any()):
                    break
                s_idx, exists = first_slot(am)
                s_v = torch.where(exists, s_idx, full(-1))
                enable = claim_move(s_v, dirty & exists)
                cyc = move_cycle(s_v, enable) & exists
                put(DL, s_v, 1, cyc)
                cols[MV] = torch.where(cyc[:, None], -1, cols[MV]).to(I32)
                onehot_s = (iota_c == s_v[:, None]) & exists[:, None]
                done = torch.where(cyc[:, None], False, done | onehot_s)
        meta[:, M_MDIRTY] = 0

    for s in range(len(rows_l)):
        for r in rows_l[s]:
            if r[14] == 1:
                integrate_row(r)
        for r in dels_l[s]:
            if r[3] == 1:
                delete_range(r)
        recompute_moves()
    return cols, meta


# --- the CUDA kernel -------------------------------------------------------------


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


def _check_int32(name, t, ndim, device):
    if not torch.is_tensor(t):
        raise TypeError(f"{name} must be a tensor")
    if t.dtype != I32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, cols on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


#: the C signatures of the integrate library (``csrc/integrate.cu``)
INTEGRATE_SIGNATURES = {
    "ytpu_integrate_stream": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4,
    "ytpu_integrate_batch": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
    + [ctypes.c_int, ctypes.c_void_p],
    "ytpu_integrate_plan": [ctypes.c_int] * 4 + [ctypes.c_void_p],
    "ytpu_integrate_batch_plan": [ctypes.c_int, ctypes.c_void_p],
    "ytpu_integrate_scratch": [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "ytpu_integrate_prof_words": [],
}
#: the words of ``ytpu_integrate_plan``, in the kernel's ``PlanWord`` order
PLAN_KEYS = ("docs_per_cta", "ctas", "threads", "ring_stages", "tile_steps", "tiles",
             "last_tile_steps", "last_tile_ragged_words", "smem_bytes", "index_ctas",
             "index_threads", "doc_words")


def scratch_entries(C: int):
    """Entries per doc of the kernel's two scratch tables for ``C`` slots:
    the 5-level bitmap (every start's five level words at a load of at
    most 5/8) and the start map (every start at a load of at most 1/2),
    each a power of two of 16-byte entries. The wrapper allocates these;
    each launch uses and clears only the prefix its doc can reach
    (`scratch_cleared`)."""
    return _next_pow2(8 * C), _next_pow2(2 * C)


#: the words of ``ytpu_integrate_scratch``
SCRATCH_KEYS = ("slots_bound", "bitmap_entries", "start_map_entries", "cleared_bytes")


def scratch_cleared(nb0: int, C: int, S: int = 1, U: int = 1, R: int = 1, moves: int = 0,
                    lib=None) -> dict:
    """Phase 1's sizing of a doc of ``C`` slots that holds ``nb0`` of them,
    ``moves`` live move rows among them, before a launch of ``S`` steps of
    ``U`` rows and ``R`` delete ranges, as the kernel library `lib`
    (default: the card's build) computes it: the slots the launch can
    reach, the table entries it uses and the bytes it clears."""
    lib = _integrate_lib() if lib is None else lib
    out = (ctypes.c_int * len(SCRATCH_KEYS))()
    if lib.ytpu_integrate_scratch(nb0, moves, S, U, R, C, out) != len(SCRATCH_KEYS):
        raise RuntimeError("the kernel library sizes scratch in other words than SCRATCH_KEYS")
    return dict(zip(SCRATCH_KEYS, out))


def launch_plan(S: int, U: int, R: int, D: int, C: int, lib=None) -> dict:
    """The launch the kernel makes for an ``[S, U, 23]`` / ``[S, R, 4]``
    stream into ``D`` docs of ``C`` slots, as the kernel library `lib`
    (default: the card's build) plans it: CTAs, the tile of steps each ring
    stage holds, the ragged last tile, the dynamic shared memory; plus the
    per-doc scratch the wrapper allocates."""
    lib = _integrate_lib() if lib is None else lib
    return _plan(lambda out: lib.ytpu_integrate_plan(S, U, R, D, out), C)


def batch_launch_plan(D: int, C: int, lib=None, nb0=None, U: int = 1, R: int = 1) -> dict:
    """The launches `integrate_batch` makes into ``D`` docs of ``C`` slots,
    in `launch_plan`'s words: the index kernel (``index_ctas`` of
    ``index_threads``, handing ``doc_words`` int32 a doc to the next), then
    the integrate kernel (one step, no ring: its shared memory does not
    depend on U or R). With ``nb0`` (the slots each doc holds, a
    sequence; docs without move rows) it adds the bytes the launch's phase
    1 clears for ``U`` rows and ``R`` delete ranges a doc, beside the
    allocated ``scratch_bytes_per_doc``."""
    lib = _integrate_lib() if lib is None else lib
    out = _plan(lambda out: lib.ytpu_integrate_batch_plan(D, out), C)
    if nb0 is not None:
        out["cleared_bytes"] = sum(scratch_cleared(int(n), C, 1, U, R, 0, lib)["cleared_bytes"] for n in nb0)
    return out


def _plan(ask, C: int) -> dict:
    out = (ctypes.c_int * len(PLAN_KEYS))()
    if ask(out) != len(PLAN_KEYS):
        raise RuntimeError("the kernel library plans a launch in other words than PLAN_KEYS")
    hb, hs = scratch_entries(C)
    return {**dict(zip(PLAN_KEYS, out)), "bitmap_entries": hb, "start_map_entries": hs,
            "scratch_bytes_per_doc": 16 * hb + 16 * hs + 2 * 4 * C}


def _integrate_lib(name: str = "integrate"):
    """The built kernel library `name` (``integrate``, or its profiling
    build ``integrate_profile``) with its C signatures declared."""
    from ytpu_torch.ops import _build

    return _build.bind(name, INTEGRATE_SIGNATURES, "ytpu_cuda_error_string")


def _check_args(cols, meta, rows, dels, rank, scan_plan):
    if scan_plan is None:
        scan_plan = scan_tier_plan()
    cheap, unroll = int(scan_plan[0]), int(scan_plan[1])
    if cheap < 0 or unroll < 1:
        raise ValueError(f"scan_plan needs cheap >= 0 and unroll >= 1, got {scan_plan}")
    dev = cols.device
    _check_int32("cols", cols, 3, dev)
    _check_int32("meta", meta, 2, dev)
    _check_int32("rows", rows, 3, dev)
    _check_int32("dels", dels, 3, dev)
    _check_int32("rank", rank, 1, dev)
    n_planes, D, C = cols.shape
    if n_planes != NC or tuple(meta.shape) != (D, M_PAD):
        raise ValueError(f"state shapes {tuple(cols.shape)} / {tuple(meta.shape)} are not [26, D, C] / [D, 32]")
    if rows.shape[2] != 23 or dels.shape[2] != 4 or rows.shape[0] != dels.shape[0]:
        raise ValueError(f"stream shapes {tuple(rows.shape)} / {tuple(dels.shape)} are not [S, U, 23] / [S, R, 4]")
    return cheap, unroll


def _scratch_bytes(D: int, C: int) -> int:
    """Device bytes `_scratch` allocates for a launch into ``D`` docs of
    ``C`` slots."""
    hb, hs = scratch_entries(C)
    return D * (hb + hs) * 16 + 2 * D * C * 4


def _stream_memory(cols, meta, rows, dels, rank):
    """The ``memory=`` thunk of a stream launch's phase span: ``cols`` and
    ``meta`` are written in place (argument, output and alias bytes) and a
    launch on the card allocates `_scratch`."""
    _, D, C = cols.shape
    cuda = cols.device.type == "cuda"
    return _program_memory(
        cols, meta, rows, dels, rank, outputs=(cols, meta), aliased=(cols, meta),
        scratch_bytes=lambda: _scratch_bytes(D, C) if cuda else 0,
    )


def _scratch(D: int, C: int, dev):
    """The kernel's per-doc scratch: the bitmap index and the start map
    ({key, payload} pairs of int64), the two scan stamps."""
    hb, hs = scratch_entries(C)
    return (torch.empty((D, hb, 2), dtype=torch.int64, device=dev), hb,
            torch.empty((D, hs, 2), dtype=torch.int64, device=dev), hs,
            torch.empty((D, C), dtype=I32, device=dev), torch.empty((D, C), dtype=I32, device=dev))


def _launch(lib, cols, meta, rows, dels, rank, cheap, unroll, prof):
    """One launch of the kernel in `lib` on the current stream; `prof` is
    the [D, words] int64 counter buffer of the profiling build, or None.
    The stream is copied into shared memory by bulk copies, which need
    16-byte-aligned sources: a misaligned ``rows`` or ``dels`` raises."""
    from ytpu_torch.ops import _build

    for name, t in (("rows", rows), ("dels", dels)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start 16-byte aligned on the device, got address {t.data_ptr():#x}")
    dev = cols.device
    _, D, C = cols.shape
    S, U = rows.shape[0], rows.shape[1]
    R, K = dels.shape[1], rank.shape[0]
    bidx, hb, sidx, hs, bstamp, cstamp = _scratch(D, C, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.ytpu_integrate_stream(
        cols.data_ptr(), meta.data_ptr(), rows.data_ptr(), dels.data_ptr(),
        rank.data_ptr(), S, U, R, K, D, C, cheap, unroll,
        bidx.data_ptr(), hb, sidx.data_ptr(), hs, bstamp.data_ptr(), cstamp.data_ptr(),
        None if prof is None else prof.data_ptr(), stream,
    )
    _build.check(lib, err, "integrate kernel")


def integrate_stream(cols, meta, rows, dels, rank, scan_plan=None):
    """Integrate an ``[S, U, 23]`` row / ``[S, R, 4]`` delete stream into
    every doc of the packed state, updating ``cols`` ``[26, D, C]`` and
    ``meta`` ``[D, 32]`` IN PLACE (the port's counterpart of the JAX
    package's buffer donation) and returning them. ``rank`` is the
    ``[K]`` client tie-break table, ``scan_plan`` the (cheap, unroll)
    conflict-scan accounting plan (default `scan_tier_plan()`).

    On CUDA tensors this launches the hand-written kernel
    (``csrc/integrate.cu``) on the current stream and counts the launch in
    ``integrate_stream.launches``; on CPU tensors it runs
    `integrate_stream_reference`. Any other device raises."""
    cheap, unroll = _check_args(cols, meta, rows, dels, rank, scan_plan)
    dev = cols.device
    if dev.type == "cpu":
        return integrate_stream_reference(cols, meta, rows, dels, rank, (cheap, unroll))
    if dev.type != "cuda":
        raise ValueError(f"integrate_stream runs on cuda or cpu tensors, not {dev}")
    _launch(_integrate_lib(), cols, meta, rows, dels, rank, cheap, unroll, None)
    integrate_stream.launches += 1
    return cols, meta


def integrate_stream_profile(cols, meta, rows, dels, rank, scan_plan=None):
    """`integrate_stream` through the profiling build of the kernel
    (``-DYTPU_INTEGRATE_PROFILE``), on CUDA tensors only: updates the
    state in place the same way and returns the ``[D, words]`` int64
    per-doc cycle counters (see `PROFILE_WORDS`). Not counted in
    ``integrate_stream.launches``: it is a measurement, not the main
    path."""
    cheap, unroll = _check_args(cols, meta, rows, dels, rank, scan_plan)
    if cols.device.type != "cuda":
        raise ValueError("integrate_stream_profile runs the CUDA kernel only")
    lib, prof = _profile_lib(cols)
    _launch(lib, cols, meta, rows, dels, rank, cheap, unroll, prof)
    return prof


def _profile_lib(cols):
    """The profiling build and a zeroed ``[D, words]`` counter buffer."""
    lib = _integrate_lib("integrate_profile")
    words = lib.ytpu_integrate_prof_words()
    if words != len(PROFILE_WORDS):
        raise RuntimeError(f"the profiling build has {words} counter words, expected {len(PROFILE_WORDS)}")
    return lib, torch.zeros((cols.shape[1], words), dtype=torch.int64, device=cols.device)


#: the counter words of the profiling build, in the order of
#: ``csrc/integrate.cu``'s ``ProfWord``: cycles per phase (exclusive; the
#: two phase-1 words are the CTA's, given to each of its docs), then event
#: counts and the doc's slot bound
PROFILE_WORDS = (
    "other", "stream_fetch", "client_clock", "find_slot_cache_hit", "find_slot_index",
    "split", "conflict_scan", "link_and_writes", "index_add", "delete_mark",
    "move_recompute", "phase1_clear", "phase1_index", "steps", "rows", "delete_ranges",
    "cache_hits", "index_lookups", "slots_bound",
)
PROFILE_PHASES = PROFILE_WORDS[:13]
#: the phases of phase 1 (the whole CTA, before the doc's own integrate)
PHASE1 = ("phase1_clear", "phase1_index")


integrate_stream.launches = 0


def integrate_batch_reference(cols, meta, rows, dels, rank, scan_plan=(32, 8)):
    """The plain version of the per-doc entry: doc d integrates its own
    rows ``rows[d]`` / deletes ``dels[d]`` as the one-step stream of
    `integrate_stream_reference`. Updates ``cols`` / ``meta`` in place and
    returns them."""
    for d in range(cols.shape[1]):
        c, m = cols[:, d : d + 1].clone(), meta[d : d + 1].clone()
        integrate_stream_reference(c, m, rows[d : d + 1], dels[d : d + 1], rank, scan_plan)
        cols[:, d : d + 1] = c
        meta[d : d + 1] = m
    return cols, meta


def integrate_batch(cols, meta, rows, dels, rank, scan_plan=None):
    """Integrate one step of per-doc updates, ``rows`` ``[D, U, 23]`` and
    ``dels`` ``[D, R, 4]`` (doc d gets ``rows[d]`` / ``dels[d]``), into
    the packed state IN PLACE and return ``(cols, meta)``; the other
    arguments are `integrate_stream`'s.

    On CUDA tensors this launches the kernel's per-doc entry
    (``ytpu_integrate_batch`` of ``csrc/integrate.cu``) on the current
    stream and counts the launch in ``integrate_batch.launches``; on CPU
    tensors it runs `integrate_batch_reference`. Any other device
    raises."""
    cheap, unroll = _check_args(cols, meta, rows, dels, rank, scan_plan)
    if rows.shape[0] != cols.shape[1]:
        raise ValueError(f"rows hold {rows.shape[0]} docs, the state {cols.shape[1]}")
    dev = cols.device
    if dev.type == "cpu":
        return integrate_batch_reference(cols, meta, rows, dels, rank, (cheap, unroll))
    if dev.type != "cuda":
        raise ValueError(f"integrate_batch runs on cuda or cpu tensors, not {dev}")
    _launch_batch(_integrate_lib(), cols, meta, rows, dels, rank, cheap, unroll, None, False)
    integrate_batch.launches += 1
    return cols, meta


def _launch_batch(lib, cols, meta, rows, dels, rank, cheap, unroll, prof, capacity_sized):
    from ytpu_torch.ops import _build

    dev = cols.device
    _, D, C = cols.shape
    bidx, hb, sidx, hs, bstamp, cstamp = _scratch(D, C, dev)
    doc_words = torch.empty((D, batch_launch_plan(D, C, lib)["doc_words"]), dtype=I32, device=dev)
    err = lib.ytpu_integrate_batch(
        cols.data_ptr(), meta.data_ptr(), rows.data_ptr(), dels.data_ptr(), rank.data_ptr(),
        rows.shape[1], dels.shape[1], rank.shape[0], D, C, cheap, unroll,
        bidx.data_ptr(), hb, sidx.data_ptr(), hs, bstamp.data_ptr(), cstamp.data_ptr(),
        doc_words.data_ptr(), None if prof is None else prof.data_ptr(), int(capacity_sized),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, err, "integrate batch kernel")


def integrate_batch_profile(cols, meta, rows, dels, rank, scan_plan=None, capacity_sized=False):
    """`integrate_batch` through the profiling build of the kernel, on CUDA
    tensors only: updates the state in place the same way and returns the
    ``[D, words]`` int64 per-doc counters (`PROFILE_WORDS`). With
    ``capacity_sized`` every doc's phase 1 sizes and clears its scratch for
    all C slots, as the kernel did before it sized them from the doc's live
    rows: the baseline of the profile. Not counted in
    ``integrate_batch.launches``."""
    cheap, unroll = _check_args(cols, meta, rows, dels, rank, scan_plan)
    if rows.shape[0] != cols.shape[1]:
        raise ValueError(f"rows hold {rows.shape[0]} docs, the state {cols.shape[1]}")
    if cols.device.type != "cuda":
        raise ValueError("integrate_batch_profile runs the CUDA kernel only")
    lib, prof = _profile_lib(cols)
    _launch_batch(lib, cols, meta, rows, dels, rank, cheap, unroll, prof, capacity_sized)
    return prof


integrate_batch.launches = 0


# --- readout ----------------------------------------------------------------------


def _live_rows(cols, meta):
    C = cols.shape[-1]
    slots = torch.arange(C, device=cols.device)
    return (slots[None, :] < meta[:, M_NBLOCKS][:, None]) & (cols[CL] >= 0)


def _packed_commit_fold(cols, meta):
    """[D] int64 per-doc commitment words (uint32 values) over live rows."""
    return commit_fold_blocks(cols[CL], cols[CK], cols[LN], _live_rows(cols, meta))


def _packed_dead_rows(cols, meta):
    """[D] per-doc tombstoned rows inside the occupied prefix."""
    return (_live_rows(cols, meta) & (cols[DL] > 0)).sum(dim=1).to(I32)


def packed_capacity_ledger(cols, meta):
    """Per-doc ``([D] occupied-live, [D] dead)`` int32 rows."""
    dead = _packed_dead_rows(cols, meta)
    return meta[:, M_NBLOCKS] - dead, dead


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a uint32 value -> the int32 with the same bits."""
    x = x & U32_MASK
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(I32)


def _readout_words(cols, meta, err):
    """``[N_READOUT]`` int32: max n_blocks, max sticky error, decode flags,
    scan bucket totals, max scan width, tier/trip totals, the commitment
    word (wrap-sum over docs), sum occupied, sum dead, max dead."""
    hist = meta[:, M_HIST0:M_SCANW_MAX].sum(dim=0)
    tiers = meta[:, M_TIER_CHEAP:M_SCAN_END].sum(dim=0)
    commit = _to_i32(_packed_commit_fold(cols, meta).sum())
    dead = _packed_dead_rows(cols, meta)
    head = torch.stack(
        [meta[:, M_NBLOCKS].max(), meta[:, M_ERROR].max(), err.reshape(()).to(I32)]
    )
    ledger = torch.stack([meta[:, M_NBLOCKS].sum(), dead.sum(), dead.max()])
    return torch.cat(
        [
            head.to(I32),
            hist.to(I32),
            meta[:, M_SCANW_MAX].max()[None].to(I32),
            tiers.to(I32),
            commit[None],
            ledger.to(I32),
        ]
    )


def decode_chunk(
    err, buf, lens, refs, *, offs=None, width=None, max_rows: int, max_dels: int,
    n_steps: int, max_sections: int,
):
    """The decode half of a chunk: `decode_updates_v1` (of the ``[S, L]``
    matrix ``buf``, or with ``offs`` / ``width`` of the flat arena read in
    place) -> global unit-ref rebase (``refs`` >= 0 replaces the decoded
    ref) -> `pack_stream`, and the OR of the decode error flags into the
    sticky ``err``. Returns ``(rows, dels, err)``."""
    from ytpu_torch.ops.decode_kernel import FLAG_ERRORS, decode_updates_v1

    stream, flags = decode_updates_v1(
        buf, lens, max_rows=max_rows, max_dels=max_dels, n_steps=n_steps,
        max_sections=max_sections, offs=offs, width=width,
    )
    stream = stream._replace(
        content_ref=torch.where(refs >= 0, refs, stream.content_ref)
    )
    rows, dels = pack_stream(stream)
    return rows, dels, err | _or_reduce(flags & FLAG_ERRORS)


def _chunk_core(cols, meta, err, buf, lens, refs, rank, *, stage, key, axes, scan_plan=None, **decode_kw):
    """The body both chunk programs share: `decode_chunk` -> integrate
    -> readout. ``cols``/``meta`` update in place; returns ``(cols, meta,
    err, readout)``. Each phase is a `torch.profiler` span
    (``ytpu_torch.decode`` / ``.integrate`` / ``.readout``). With the
    phase recorder on, the decode is its ``decode.v1`` stage and the
    integrate and readout that follow it the chunk program's `stage`
    (``key`` after the state's shape, named by ``axes``): the two spans
    are one after the other, so the profile counts each launch once."""
    record = torch.profiler.record_function
    with record("ytpu_torch.decode"):
        rows, dels, err = decode_chunk(err, buf, lens, refs, **decode_kw)
    span = (
        _phases.span(stage, (tuple(cols.shape), *key, "fused", scan_plan),
                     axes=("state", *axes, "lane", "scan_plan"),
                     memory=_stream_memory(cols, meta, rows, dels, rank))
        if _phases.enabled
        else NULL_SPAN
    )
    with span:
        with record("ytpu_torch.integrate"):
            integrate_stream(cols, meta, rows, dels, rank, scan_plan)
        with record("ytpu_torch.readout"):
            readout = _readout_words(cols, meta, err)
    return cols, meta, err, readout


def replay_chunk_program(
    cols, meta, err, buf, lens, refs, rank, *, max_rows: int, max_dels: int,
    n_steps: int, max_sections: int, scan_plan=None,
):
    """One replay chunk from the host-packed ``[S, L]`` lane matrix
    (`pack_updates_into` staging): `_chunk_core`. Flagged lanes integrate
    as no-ops (the decode clears their valid masks) and their flags fold
    into the sticky ``err``. Its phase stage is ``replay.chunk_async``."""
    dims = (max_rows, max_dels, n_steps, max_sections)
    return _chunk_core(
        cols, meta, err, buf, lens, refs, rank, stage="replay.chunk_async",
        key=(tuple(buf.shape), tuple(refs.shape), dims), axes=("buf", "refs", "dims"),
        scan_plan=scan_plan, max_rows=max_rows, max_dels=max_dels, n_steps=n_steps,
        max_sections=max_sections,
    )


def replay_chunk_program_raw(
    cols, meta, err, raw, offs, lens, refs, rank, *, width: int, max_rows: int,
    max_dels: int, n_steps: int, max_sections: int, scan_plan=None,
):
    """One replay chunk from raw concatenated wire bytes and their
    offsets table: `_chunk_core` with the decode reading the arena in
    place. Its phase stage is ``replay.chunk_raw``."""
    dims = (max_rows, max_dels, n_steps, max_sections)
    return _chunk_core(
        cols, meta, err, raw, lens, refs, rank, stage="replay.chunk_raw",
        key=(tuple(raw.shape), tuple(refs.shape), dims, width), axes=("raw", "refs", "dims", "width"),
        scan_plan=scan_plan, offs=offs, width=width, max_rows=max_rows, max_dels=max_dels,
        n_steps=n_steps, max_sections=max_sections,
    )


def _or_reduce(x: torch.Tensor) -> torch.Tensor:
    """Bitwise OR over a 1-D int32 tensor (flag bits < 2^7)."""
    bits = torch.zeros((), dtype=I32, device=x.device)
    for b in range(8):
        bits = bits | (((x >> b) & 1).any().to(I32) << b)
    return bits


# --- chunked replay driver ----------------------------------------------------------


@dataclass
class ReplayChunkStats:
    """Counters of one chunked replay."""

    chunks: int = 0
    compactions: int = 0
    growths: int = 0
    syncs: int = 0  # readouts actually materialized
    capacity: int = 0
    peak_blocks: int = 0  # max occupancy observed at readouts
    final_blocks: int = 0
    quarantined: int = 0  # update indices recorded by the quarantine hook
    scan_hist: tuple = ()
    scan_max: int = 0
    scan_p50: int = 0
    scan_p99: int = 0
    scan_tier_cheap: int = 0
    scan_tier_wide: int = 0
    scan_trips_serial: int = 0
    scan_trips_two_tier: int = 0
    commit_word: int = 0
    occupied_rows: int = 0
    dead_rows: int = 0
    dead_max: int = 0
    reclaimed_rows: int = 0
    compact_gap_chunks: int = 0
    # sums over integrate launches, all docs: the occupied rows before the
    # launch (their CL/CK/LN are read to index them) and the rows it added
    # (written whole): the state rows the launches must move at least
    launch_rows_read: int = 0
    launch_rows_added: int = 0


_QUARANTINED = _metrics.counter("replay.quarantined")

#: wall clock of the most recent chunk dispatch: the telemetry `/healthz`
#: last-dispatch age (a wedged device shows as a growing age while the
#: HTTP plane, on its own thread, keeps answering)
_LAST_DISPATCH = _metrics.gauge("integrate.last_dispatch_unix")


def lane_health() -> dict:
    """The lane-demotion ladder's view that `/healthz` serves: always
    empty. The JAX package demotes a shape family from its Pallas lane to
    XLA and the host after device faults; the port has one integrate lane,
    its hand-written kernel, and nothing below it to demote to."""
    return {}


class ReplayFault(RuntimeError):
    """A mid-replay fault the driver does not absorb (simulated worker
    death at the ``replay.kill`` site): the state is treated as lost, and
    a recovering caller (`FusedReplay`, `UpdatePipeline`) restores its
    last chunk-boundary checkpoint, or the initial state, and runs again."""

    def __init__(self, msg: str, *, chunk: int, cause: Optional[BaseException] = None):
        super().__init__(msg)
        self.chunk = chunk
        self.cause = cause


class ChunkUpload(NamedTuple):
    """A chunk's inputs on the state's device and the CUDA event recorded
    right after their host-to-device copies (None on the CPU, where the
    copy is done when the call returns)."""

    tensors: tuple
    copied: Optional[object]

    def wait(self) -> None:
        """Block until the copies have read their host buffers: after
        this the staging buffers may be written again."""
        if self.copied is not None:
            self.copied.synchronize()


def _upload(host_arrays, device) -> ChunkUpload:
    """Copy numpy arrays or CPU tensors to `device`, asynchronously where a
    tensor is pinned, and record the event that ends the copies."""
    tensors = tuple(
        (a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))).to(
            device, non_blocking=True
        )
        for a in host_arrays
    )
    copied = None
    if device.type == "cuda":
        copied = torch.cuda.Event()
        copied.record()
    return ChunkUpload(tensors, copied)


class PackedReplayDriver:
    """Chunked replay over a packed ``[NC, D, C]`` state with between-chunk
    compaction under one `CompactionPolicy`.

    Occupancy protocol: the host keeps an optimistic upper bound on the
    max per-doc block count (each chunk adds its worst-case growth) and
    every chunk leaves a readout tensor un-materialized; only when the
    bound says the next chunk might not fit does the host read the newest
    readout. If the actual occupancy still trips the policy, the state is
    compacted in place and, when even that cannot make room, grown. Sticky
    integrate errors and decode flags surface at every materialized
    readout and at `finish()`.

    Decode errors: `on_decode_error(flags)` (set by the caller) is called
    first and is expected to raise a message naming the updates. With
    ``quarantine=True`` and an `on_quarantine(flags)` hook, flagged lanes
    (which integrated as no-ops) are recorded through the hook instead and
    the sticky flags start again from 0. Each chunk dispatch passes the
    ``replay.kill`` fault site; a real device error propagates unchanged."""

    def __init__(
        self,
        cols,
        meta,
        client_rank,
        *,
        policy=None,
        unit_refs: bool = False,
        gc_ranges: bool = False,
        max_capacity: Optional[int] = None,
        sync_every_chunk: bool = False,
        initial_occupancy: int = 0,
        quarantine: bool = False,
    ):
        self.cols = cols
        self.meta = meta
        self.rank = client_rank
        self.policy = policy or DEFAULT_COMPACTION_POLICY
        self.unit_refs = unit_refs
        self.gc_ranges = gc_ranges
        self.max_capacity = max_capacity or cols.shape[2]
        self.sync_every_chunk = sync_every_chunk
        self.stats = ReplayChunkStats(capacity=cols.shape[2])
        self._hi_bound = int(initial_occupancy)
        self._pending: List[torch.Tensor] = []  # un-materialized launch readouts
        self._err = torch.zeros((), dtype=I32, device=cols.device)
        self._last_compact_chunk = -1
        self._occupied = int(meta[:, M_NBLOCKS].sum())  # as of the last readout
        self.on_decode_error = None
        self.quarantine = quarantine
        self.on_quarantine = None

    @property
    def capacity(self) -> int:
        return self.cols.shape[2]

    def _absorb(self, readout: torch.Tensor) -> Tuple[int, int]:
        """Fold one readout into the stats; returns its max occupancy and
        its decode flags. Raises on a sticky integrate error, and on decode
        flags unless the quarantine hook takes them."""
        vals = readout.cpu().numpy()
        occ, kerr, derr = int(vals[0]), int(vals[1]), int(vals[2])
        self._record_scan_width(
            vals[3 : 3 + SCAN_WIDTH_BUCKETS],
            int(vals[3 + SCAN_WIDTH_BUCKETS]),
            vals[3 + SCAN_WIDTH_BUCKETS + 1 : 3 + SCAN_REC_WORDS],
        )
        self.stats.commit_word = int(vals[3 + SCAN_REC_WORDS]) & U32_MASK
        base = 4 + SCAN_REC_WORDS
        self.stats.occupied_rows = int(vals[base])
        self.stats.dead_rows = int(vals[base + 1])
        self.stats.dead_max = int(vals[base + 2])
        if _phases.enabled:
            _phases.set_value("integrate.commit_word", self.stats.commit_word)
            self._record_capacity_ledger()
        self.stats.peak_blocks = max(self.stats.peak_blocks, occ)
        if derr != 0 and not (self.quarantine and self.on_quarantine is not None):
            self._raise_decode_error(derr)
        if kerr != 0:
            self._raise_device_error()
        return occ, derr

    def _drain_readouts(self) -> int:
        """Materialize every pending launch readout; returns the freshest
        actual occupancy. Flagged decode lanes go to the quarantine hook
        once, after the loop."""
        hi = self._hi_bound
        if not self._pending:
            return hi
        self._note_readout_bytes(len(self._pending))
        sticky = 0
        for fut in self._pending:
            hi, derr = self._absorb(fut)
            sticky |= derr
            # the launch read the rows its docs held before it and wrote
            # the rows it added (an integrate never frees a row)
            self.stats.launch_rows_read += self._occupied
            self.stats.launch_rows_added += self.stats.occupied_rows - self._occupied
            self._occupied = self.stats.occupied_rows
        self._pending.clear()
        self.stats.syncs += 1
        self._hi_bound = hi
        if sticky:
            # flagged lanes already integrated as no-ops: recording the
            # offenders and clearing the sticky flags is the recovery
            newly = self.on_quarantine(sticky) or []
            self.stats.quarantined += len(newly)
            _QUARANTINED.inc(len(newly))
            self._err = torch.zeros((), dtype=I32, device=self.cols.device)
        return hi

    @staticmethod
    def _note_readout_bytes(n: int) -> None:
        """Phase accounting of ``n`` materialized readouts, as the JAX
        package splits its readout words: ``replay.readout`` keeps the 12
        bytes of the occupancy / error words, the conflict-scan record,
        the commitment word and the capacity ledger count under their own
        stages."""
        if not _phases.enabled:
            return
        _phases.transfer("replay.readout", 12 * n, "d2h")
        _phases.transfer("integrate.scan_hist", 4 * SCAN_REC_WORDS * n, "d2h")
        _phases.transfer("integrate.commit_word", 4 * n, "d2h")
        _phases.transfer("capacity.ledger", 4 * LEDGER_WORDS * n, "d2h")

    def _record_scan_width(self, buckets, observed_max: int, tiers) -> None:
        """Fold a readout's conflict-scan words into the stats and, with
        the phase recorder on, the ``integrate.scan_*`` gauges (each also
        under its lane's suffix, ``.fused``, as the JAX package keys
        them)."""
        counts = [int(c) for c in buckets]
        st = self.stats
        st.scan_hist = tuple(counts)
        st.scan_max = int(observed_max)
        st.scan_p50 = scan_width_quantile(counts, 0.50, st.scan_max)
        st.scan_p99 = scan_width_quantile(counts, 0.99, st.scan_max)
        cheap, wide, cheap_trips, wide_trips, width_sum = (int(t) for t in tiers)
        st.scan_tier_cheap = cheap
        st.scan_tier_wide = wide
        st.scan_trips_serial = width_sum
        st.scan_trips_two_tier = cheap_trips + wide_trips
        if _phases.enabled and sum(counts):
            for name, v in (
                ("width_p50", st.scan_p50),
                ("width_p99", st.scan_p99),
                ("width_max", st.scan_max),
                ("tier_cheap", st.scan_tier_cheap),
                ("tier_wide", st.scan_tier_wide),
                ("trips_serial", st.scan_trips_serial),
                ("trips_two_tier", st.scan_trips_two_tier),
            ):
                _phases.set_value(f"integrate.scan_{name}", v)
                _phases.set_value(f"integrate.scan_{name}.fused", v)

    def _record_capacity_ledger(self) -> None:
        """The ``capacity.*`` occupancy gauges of the freshest readout."""
        st = self.stats
        total = self.cols.shape[1] * self.capacity
        for name, v in (
            ("occupied_rows", st.occupied_rows),
            ("dead_rows", st.dead_rows),
            ("dead_max", st.dead_max),
            ("free_rows", total - st.occupied_rows),
            ("dead_fraction", st.dead_rows / max(st.occupied_rows, 1)),
            ("occupancy_fraction", st.occupied_rows / max(total, 1)),
        ):
            _phases.set_value(f"capacity.{name}", v)

    def _raise_device_error(self):
        meta_np = self.meta.cpu().numpy()
        bad = meta_np[meta_np[:, M_ERROR] != 0][:4]
        raise RuntimeError(f"device error flags {bad}")

    def _raise_decode_error(self, flags_or: int):
        if self.on_decode_error is not None:
            self.on_decode_error(flags_or)  # expected to raise
        raise RuntimeError(
            f"device decode flagged errors in a deferred chunk (sticky flags "
            f"{flags_or}); replay with sync_every_chunk=True to localize the update"
        )

    def _dispatch(self, fn):
        """Run one chunk dispatch, then pass the ``replay.kill`` fault site:
        a firing spec raises `ReplayFault` (simulated worker death, the
        state treated as lost). Nothing is retried here."""
        out = fn()
        spec = faults.fire("replay.kill")
        if spec is not None:
            raise ReplayFault(
                "injected mid-replay kill (state treated as lost)",
                chunk=self.stats.chunks,
                cause=FaultError("replay.kill", spec),
            )
        _LAST_DISPATCH.set(time.time())
        return out

    def compact(self) -> int:
        """Compact the packed state in place; returns the actual high-water
        block count afterwards."""
        from ytpu_torch.ops.compaction import compact_packed

        self._drain_readouts()
        occ_before = self.stats.occupied_rows
        with torch.profiler.record_function("ytpu_torch.compaction"):
            self.cols, self.meta = compact_packed(
                self.cols, self.meta, self.unit_refs, self.gc_ranges
            )
        self.stats.compactions += 1
        if self._last_compact_chunk >= 0:
            self.stats.compact_gap_chunks = self.stats.chunks - self._last_compact_chunk
        self._last_compact_chunk = self.stats.chunks
        self._note_readout_bytes(1)
        hi, _ = self._absorb(_readout_words(self.cols, self.meta, self._err))
        self._hi_bound = hi
        self._occupied = self.stats.occupied_rows
        self.stats.syncs += 1
        reclaimed = max(0, occ_before - self.stats.occupied_rows)
        self.stats.reclaimed_rows += reclaimed
        if _phases.enabled:
            _phases.add_value("capacity.reclaimed_rows", reclaimed)
            _phases.set_value("capacity.compact_gap_chunks", self.stats.compact_gap_chunks)
        return hi

    def ensure_room(self, margin: int) -> None:
        """Compact (and grow, when allowed) before a chunk whose worst-case
        growth is `margin`, so ERR_CAPACITY cannot fire mid-chunk."""
        if not self.policy.should_compact(self._hi_bound, margin, self.capacity):
            return
        hi = self._drain_readouts()
        if not self.policy.should_compact(hi, margin, self.capacity):
            return
        hi = self.compact()
        while hi + margin > self.capacity:
            new_cap = min(self.capacity * 2, self.max_capacity)
            if new_cap <= self.capacity:
                raise RuntimeError(
                    f"state needs {hi + margin} block slots but replay is "
                    f"capacity-exhausted: max_capacity {self.max_capacity} "
                    f"(current capacity {self.capacity})"
                )
            from ytpu_torch.ops.compaction import grow_packed

            with torch.profiler.record_function("ytpu_torch.grow"):
                self.cols, self.meta = grow_packed(self.cols, self.meta, new_cap)
            self.stats.growths += 1
            self.stats.capacity = new_cap

    def _chunk_done(self, margin: int) -> None:
        self._hi_bound += margin
        self.stats.chunks += 1
        if self.sync_every_chunk:
            self._drain_readouts()

    def step(self, stream: UpdateBatch, margin: Optional[int] = None) -> None:
        """Integrate one ``[S, ...]`` stream chunk (a doc-free leading step
        axis, on the state's device): room check -> `pack_stream` ->
        integrate -> lazy readout. ``margin`` is the chunk's worst-case
        slot growth; when None it is read from the stream's valid masks."""
        from ytpu_torch.models.batch_doc import stream_worst_case_adds

        if margin is None:
            margin = int(stream_worst_case_adds(stream).sum()) + 8
        self.ensure_room(margin)

        def dispatch():
            rows, dels = pack_stream(stream)
            scan_plan = scan_tier_plan()
            span = NULL_SPAN
            if _phases.enabled:
                _phases.transfer("replay.chunk_fused", _nbytes(rows) + _nbytes(dels), "h2d")
                span = _phases.span(
                    "replay.chunk_fused",
                    (tuple(self.cols.shape), tuple(rows.shape), tuple(dels.shape), scan_plan),
                    axes=("state", "rows", "dels", "scan_plan"),
                    memory=_stream_memory(self.cols, self.meta, rows, dels, self.rank),
                )
            with span:
                with torch.profiler.record_function("ytpu_torch.integrate"):
                    integrate_stream(self.cols, self.meta, rows, dels, self.rank, scan_plan)
                with torch.profiler.record_function("ytpu_torch.readout"):
                    return _readout_words(self.cols, self.meta, self._err)

        self._pending.append(self._dispatch(dispatch))
        self._chunk_done(margin)

    def _step_program(self, stage, program, host_arrays, dims, margin: int, **kw) -> ChunkUpload:
        """What `step_bytes` and `step_raw` share: room check -> the inputs'
        copy to the state's device (counted as the chunk `stage`'s
        host-to-device bytes) -> one chunk program -> lazy readout."""
        max_rows, max_dels, n_steps, max_sections = dims
        self.ensure_room(margin)
        if _phases.enabled:
            _phases.transfer(stage, sum(_nbytes(a) for a in host_arrays), "h2d")
        upload = _upload(host_arrays, self.cols.device)
        self.cols, self.meta, self._err, readout = self._dispatch(
            lambda: program(
                self.cols, self.meta, self._err, *upload.tensors, self.rank, max_rows=max_rows,
                max_dels=max_dels, n_steps=n_steps, max_sections=max_sections,
                scan_plan=scan_tier_plan(), **kw,
            )
        )
        self._pending.append(readout)
        self._chunk_done(margin)
        return upload

    def step_bytes(self, buf, lens, refs, dims, margin: int) -> ChunkUpload:
        """Integrate one chunk from the host-packed ``[S, L]`` lane matrix
        `buf` and its ``lens`` (`replay_chunk_program`). ``dims`` is
        ``(max_rows, max_dels, n_steps, max_sections)``; ``refs`` the
        chunk's ``[S, U]`` global unit refs; ``margin`` its worst-case slot
        growth. Decode errors fold into the sticky flags and surface at the
        next drain or `finish()`. Returns the `ChunkUpload`: the caller
        writes the staging buffers again only after its `wait()`."""
        return self._step_program("replay.chunk_async", replay_chunk_program, (buf, lens, refs), dims, margin)

    def step_raw(self, raw, offs, lens, refs, dims, width: int, margin: int) -> ChunkUpload:
        """Integrate one chunk from raw concatenated wire bytes plus its
        offsets table: decode from the arena -> rebase -> integrate ->
        readout (`replay_chunk_program_raw`). ``width`` is the per-lane
        window; the rest is as in `step_bytes`."""
        return self._step_program(
            "replay.chunk_raw", replay_chunk_program_raw, (raw, offs, lens, refs), dims, margin, width=width
        )

    def finish(self):
        """Drain every pending readout (surfacing sticky errors) and
        return the packed (cols, meta)."""
        self._drain_readouts()
        self.stats.capacity = self.capacity
        self.stats.final_blocks = int(self.meta[:, M_NBLOCKS].max())
        return self.cols, self.meta


def replay_stream_fused(
    state: DocStateBatch,
    stream: UpdateBatch,
    client_rank,
    *,
    chunk_steps: int = 64,
    policy=None,
    max_capacity: Optional[int] = None,
) -> Tuple[DocStateBatch, ReplayChunkStats]:
    """Chunked replay of a stacked ``[S, ...]`` update stream with
    between-chunk compaction: `apply_update_stream_fused` for streams whose
    peak block count exceeds the capacity. The stream is cut into windows
    of `chunk_steps` steps (the tail padded with invalid steps, so every
    launch sees one shape); each window is one `PackedReplayDriver.step`
    and, between windows, the `CompactionPolicy` decides when the packed
    state compacts or grows (up to `max_capacity`). Returns the final
    state, its origin_slot plane marked stale, and the driver's stats."""
    from ytpu_torch.models.batch_doc import mark_origin_slot_stale, stream_worst_case_adds

    S = stream.valid.shape[0]
    if S == 0:
        return state, ReplayChunkStats(capacity=state.blocks.client.shape[-1])
    adds = stream_worst_case_adds(stream)
    initial = int(state.n_blocks.max())
    cols, meta = pack_state(state)
    rank = torch.as_tensor(client_rank, dtype=I32, device=cols.device).reshape(-1).contiguous()
    driver = PackedReplayDriver(
        cols, meta, rank, policy=policy, max_capacity=max_capacity, initial_occupancy=initial
    )
    for s in range(0, S, chunk_steps):
        e = min(S, s + chunk_steps)
        chunk = UpdateBatch(*(a[s:e] for a in stream))
        if e - s < chunk_steps:
            # pad the tail to the window shape: replicate the last step,
            # then invalidate the padding rows and deletes
            pad = chunk_steps - (e - s)
            chunk = UpdateBatch(
                *(torch.cat([a, a[-1:].expand((pad,) + tuple(a.shape[1:]))]) for a in chunk)
            )
            chunk.valid[e - s :] = False
            chunk.del_valid[e - s :] = False
        driver.step(chunk, margin=int(adds[s:e].sum()) + 8)
    cols, meta = driver.finish()
    out = unpack_state(cols, meta)
    mark_origin_slot_stale(out)
    return out, driver.stats
