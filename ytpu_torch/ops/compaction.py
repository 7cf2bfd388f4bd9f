"""Device compaction of the packed state: GC conversion, squash and
defragmentation (PyTorch port of `ytpu.ops.compaction`'s packed half).

`compact_packed` runs every doc at once as ``[D, C]`` tensor ops:

1. **GC conversion**: tombstoned value rows drop their payload and become
   CONTENT_DELETED rows; with ``gc_ranges`` every tombstone becomes an
   origin-free BLOCK_GC range (move range planes cleared with it).
2. **Squash**: a row merges into its sequence-right neighbor under the
   try_squash conditions (block.rs:775-799); chains collapse in one pass by
   pointer doubling and segment sums. With ``unit_refs`` string runs from
   different updates merge when their arena unit refs are contiguous.
3. **Defragmentation**: surviving rows pack to the front in slot order and
   every slot-valued plane (links, parent, head, moved, origin slot) and
   the sequence start are remapped.

JAX clamps out-of-range gathers and drops out-of-range scatters; every
gather and scatter here clamps or masks its index explicitly.
"""

from __future__ import annotations

import torch

from ytpu_torch.core.content import (
    BLOCK_GC,
    CONTENT_ANY,
    CONTENT_BINARY,
    CONTENT_DELETED,
    CONTENT_EMBED,
    CONTENT_FORMAT,
    CONTENT_JSON,
    CONTENT_STRING,
)

__all__ = ["compact_packed", "grow_packed"]

I32 = torch.int32

_GCABLE = (
    CONTENT_JSON,
    CONTENT_BINARY,
    CONTENT_STRING,
    CONTENT_EMBED,
    CONTENT_FORMAT,
    CONTENT_ANY,
)
_SPLICEABLE = (CONTENT_STRING, CONTENT_ANY)


def compact_packed(cols, meta, unit_refs: bool = False, gc_ranges: bool = False):
    """Squash + GC + defragment every doc of a packed ``[26, D, C]`` state;
    returns new ``(cols, meta)``."""
    from ytpu_torch.ops.integrate_kernel import (
        CK, CL, CN, DL, HD, KD, KEY, LN, LT, M_NBLOCKS, M_START, MEA, MEC, MEK,
        MPR, MSA, MSC, MSK, MV, OC, OF, OK, OS, PA, RC, RF, RK, RT,
    )

    _, D, C = cols.shape
    dev = cols.device
    slots = torch.arange(C, dtype=I32, device=dev)[None, :].expand(D, C)
    n = meta[:, M_NBLOCKS][:, None]
    active = slots < n

    def isin(x, kinds):
        m = torch.zeros_like(x, dtype=torch.bool)
        for k in kinds:
            m = m | (x == k)
        return m

    def where(c, a, b):
        return torch.where(c, a, b).to(I32)

    deleted = cols[DL] == 1
    if gc_ranges:
        convert = active & deleted & (cols[KD] != BLOCK_GC)
    else:
        convert = active & deleted & isin(cols[KD], _GCABLE)
    gcv = convert & gc_ranges
    kind = where(convert, BLOCK_GC if gc_ranges else CONTENT_DELETED, cols[KD])
    rf = where(convert, -1, cols[RF])
    of = where(convert, 0, cols[OF])
    oc = where(gcv, -1, cols[OC])
    ok = where(gcv, 0, cols[OK])
    rc = where(gcv, -1, cols[RC])
    rk = where(gcv, 0, cols[RK])
    os_c = where(gcv, -1, cols[OS])
    msc = where(gcv, -1, cols[MSC])
    msk = where(gcv, 0, cols[MSK])
    msa = where(gcv, 0, cols[MSA])
    mec = where(gcv, -1, cols[MEC])
    mek = where(gcv, 0, cols[MEK])
    mea = where(gcv, 0, cols[MEA])
    mpr = where(gcv, -1, cols[MPR])

    cl, ck, ln, lt, rt = cols[CL], cols[CK], cols[LN], cols[LT], cols[RT]

    def g(col, idx):
        """col[d, idx[d, c]] with the index clamped like a JAX gather."""
        return torch.gather(col, 1, idx.clamp(0, C - 1).long())

    # --- squash eligibility a -> b = right[a] ------------------------------
    b = rt
    key_c, pa_c = cols[KEY], cols[PA]
    base = (
        active
        & (b >= 0)
        & (b < n)
        & (cl == g(cl, b))
        & (g(ck, b) == ck + ln)
        & (g(lt, b) == slots)
        & (deleted == g(deleted.to(I32), b).bool())
        & (key_c == g(key_c, b))
        & (pa_c == g(pa_c, b))
        & (cols[MV] == g(cols[MV], b))
        & (mpr < 0)
        & (g(mpr, b) < 0)
    )
    gcish = kind == BLOCK_GC
    no_head = (cols[HD] < 0) & (g(cols[HD], b) < 0)
    gc_merge = base & gcish & g(gcish.to(I32), b).bool() & no_head

    origin_chain = (g(oc, b) == cl) & (g(ok, b) == ck + ln - 1)
    ror_eq = (rc == g(rc, b)) & ((rc < 0) | (rk == g(rk, b)))
    if unit_refs:
        content_contig = (g(rf, b) >= 0) & (rf >= 0) & (g(rf, b) + g(of, b) == rf + of + ln)
    else:
        content_contig = (rf == g(rf, b)) & (g(of, b) == of + ln)
    live_merge = (
        base
        & ~deleted
        & isin(kind, _SPLICEABLE)
        & (kind == g(kind, b))
        & origin_chain
        & ror_eq
        & content_contig
    )
    dead_merge = (
        base
        & (kind == CONTENT_DELETED)
        & (g(kind, b) == CONTENT_DELETED)
        & origin_chain
        & ror_eq
    )
    elig = gc_merge | live_merge | dead_merge

    merged_away = active & (lt >= 0) & g(elig.to(I32), lt).bool()

    rep = where(merged_away, lt, slots)
    for _ in range(max(1, C.bit_length())):
        rep = g(rep, rep)

    rep_l = rep.clamp(0, C - 1).long()
    seg_len = torch.zeros((D, C), dtype=torch.int64, device=dev).scatter_add_(
        1, rep_l, torch.where(active, ln, 0).to(torch.int64)
    ).to(I32)
    tail = active & ~elig
    # scatter with drop: non-tail rows write into a discarded column C
    tail_w = torch.where(tail, rep_l, C)
    chain_right = torch.full((D, C + 1), -1, dtype=I32, device=dev)
    chain_right.scatter_(1, tail_w, rt)
    chain_right = chain_right[:, :C]

    keep = active & ~merged_away
    length = where(keep, seg_len, ln)
    right = where(keep, chain_right, rt)

    # --- defragment ----------------------------------------------------------
    new_idx = (torch.cumsum(keep.to(I32), dim=1) - 1).to(I32)
    old2new = where(keep, new_idx, g(new_idx, rep))

    def remap(col):
        return where(col >= 0, g(old2new, col), -1)

    n_new = keep.to(I32).sum(dim=1)
    order = torch.argsort(torch.where(keep, slots, C + slots), dim=1)
    blank = slots >= n_new[:, None]

    def pack(col, fill):
        return where(blank, fill, torch.gather(col, 1, order))

    out = torch.stack(
        [
            pack(cl, -1),  # CL
            pack(ck, 0),  # CK
            pack(length, 0),  # LN
            pack(oc, -1),  # OC
            pack(ok, 0),  # OK
            pack(rc, -1),  # RC
            pack(rk, 0),  # RK
            pack(remap(lt), -1),  # LT
            pack(remap(right), -1),  # RT
            pack(cols[DL], 0),  # DL
            pack(where(convert, 0, cols[CN]), 0),  # CN
            pack(kind, 0),  # KD
            pack(rf, -1),  # RF
            pack(of, 0),  # OF
            pack(key_c, -1),  # KEY
            pack(remap(pa_c), -1),  # PA
            pack(remap(cols[HD]), -1),  # HD
            pack(remap(cols[MV]), -1),  # MV
            pack(msc, -1),  # MSC
            pack(msk, 0),  # MSK
            pack(msa, 0),  # MSA
            pack(mec, -1),  # MEC
            pack(mek, 0),  # MEK
            pack(mea, 0),  # MEA
            pack(mpr, -1),  # MPR
            pack(remap(os_c), -1),  # OS
        ]
    )
    start = meta[:, M_START]
    start = where(start >= 0, torch.gather(old2new, 1, start.clamp(0, C - 1).long()[:, None])[:, 0], -1)
    meta = meta.clone()
    meta[:, M_START] = start
    meta[:, M_NBLOCKS] = n_new
    return out, meta


def grow_packed(cols, meta, new_capacity: int):
    """Widen a packed state's capacity (slot indices survive unchanged)."""
    from ytpu_torch.ops.integrate_kernel import (
        CL, HD, KEY, LT, MEC, MPR, MSC, MV, OC, OS, PA, RC, RF, RT,
    )

    n_planes, D, C = cols.shape
    if new_capacity < C:
        raise ValueError(f"cannot shrink capacity {C} -> {new_capacity}")
    if new_capacity == C:
        return cols, meta
    pad = torch.zeros((n_planes, D, new_capacity - C), dtype=I32, device=cols.device)
    for p in (CL, OC, RC, LT, RT, RF, KEY, PA, HD, MV, MSC, MEC, MPR, OS):
        pad[p] = -1
    return torch.cat([cols, pad], dim=2), meta
