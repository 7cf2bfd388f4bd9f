"""Device-side V2 (columnar) update decoding (PyTorch port of
`ytpu.ops.decode_v2`): wire bytes -> block rows.

The V2 format (yrs updates/encoder.rs:182-528, decoder.rs:195-505) is
struct-of-arrays on the wire: nine RLE-compressed column buffers (key
clock, client, left and right clock, info, string, parent info, type ref,
len) and then a `rest` stream of structural varints (section headers,
Skip lengths, the delete set) and of the content the columns do not
carry (Any values, Binary bufs, Move payloads).

Host half (copied): `pack_updates_v2` splits each update into its twelve
spans (`SP_*`: the nine columns, the rest, the string column's blob and
its length column) with one varint read each, and transcodes the
payloads of Json, Embed, Format and Type content, which the V2 wire
scatters over several columns, into a V1-form sidecar after the update's
bytes (`_cold_sidecar`), so that every V1-shaped payload reader can
address them. `pack_updates_v2_raw` ships the same as one flat arena.

Device half: `decode_updates_v2` (from the ``[S, L]`` matrix) and
`decode_updates_v2_raw` (from the arena), with the spans and the sidecar,
to the int32 UpdateBatch and the lane flags, the contract of
`decode_kernel.decode_updates_v1`. On the card each call is one launch of
the hand-written program of ``csrc/decode_v2.cu`` (one thread a lane; the
arena read in place, the intern tables resolved inside). Its plain
version is the composition `gather_raw_lanes` (the arena only) ->
`_decode_v2_reference` -> `decode_kernel._resolve_and_pack`; the
reference is the JAX package's lane-parallel program as torch ops on
``[S, N]`` tensors: the RLE column expanders (one run a step), the UTF-16
string offsets by binary search, the per-block consumption counts as
prefix sums, the rest stream parsed in bulk (terminators by cumsum) or,
for lanes whose blocks put content bytes there, walked by `_rest_walker`,
the section walk, the delete set and the row emission.

JAX computes in int32 and uint32 and wraps; here values live in int64
and every sum that can leave 32 bits is wrapped back (`_w32`), and every
gather clamps its index as JAX does.
"""

from __future__ import annotations

import ctypes
import struct
from typing import List, Optional, Tuple

import numpy as np
import torch

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
from ytpu_torch.encoding.lib0 import Cursor
from ytpu_torch.models.batch_doc import UpdateBatch
from ytpu_torch.ops.decode_kernel import (
    DEL_COLUMNS,
    FLAG_MALFORMED,
    FLAG_MULTI_CLIENT,
    FLAG_OVERFLOW,
    FLAG_UNSUPPORTED,
    KEY_HASH_BYTES,
    ROW_FIELDS,
    _ints,
    _resolve_and_pack,
    gather_raw_lanes,
)

__all__ = [
    "pack_updates_v2",
    "pack_updates_v2_raw",
    "decode_updates_v2",
    "decode_updates_v2_raw",
]

I64 = torch.int64
I32 = torch.int32
_MASK = 0xFFFFFFFF

# span indices into the host-split frame table
(
    SP_KEY_CLOCK,
    SP_CLIENT,
    SP_LEFT_CLOCK,
    SP_RIGHT_CLOCK,
    SP_INFO,
    SP_STRING,
    SP_PARENT_INFO,
    SP_TYPE_REF,
    SP_LEN,
    SP_REST,
    SP_STR_BLOB,
    SP_STR_LENS,
) = range(12)

# content kinds whose V2 payloads scatter across columns in forms the
# V1-shaped span readers cannot address: pack transcodes them into a
# V1-form sidecar appended after the update bytes
_COLD_KINDS = (CONTENT_JSON, CONTENT_EMBED, CONTENT_FORMAT, CONTENT_TYPE)


def _info_has_cold(p: bytes, start: int, length: int) -> bool:
    """Scan the info column's RLE runs for cold content kinds: O(runs)."""
    cur = Cursor(p[start : start + length])
    try:
        while cur.pos < length:
            v = cur.read_u8()
            if cur.pos < length:
                cur.read_var_uint()  # run count - 1
            if v not in (0, BLOCK_SKIP) and (v & 0x0F) in _COLD_KINDS:
                return True
    except Exception:
        pass
    return False


def _cold_sidecar(p: bytes) -> Optional[List[bytes]]:
    """V1-form payload bytes of every cold-kind block, in wire block order
    (sections as written, blocks within each in order): the content
    decoded by `_decode_block` and written back by `EncoderV1`. None when
    the update cannot be walked (the device flags it malformed anyway)."""
    from ytpu_torch.core.ids import ID
    from ytpu_torch.core.update import _decode_block
    from ytpu_torch.encoding.codec import DecoderV2, EncoderV1

    try:
        dec = DecoderV2(p)
        out: List[bytes] = []
        for _ in range(dec.read_var()):
            n_blocks = dec.read_var()
            client = dec.read_client()
            clock = dec.read_var()
            for _ in range(n_blocks):
                carrier = _decode_block(ID(client, clock), dec)
                if carrier is None:
                    continue
                clock += carrier.len
                content = getattr(carrier, "content", None)
                if content is not None and content.kind in _COLD_KINDS:
                    enc = EncoderV1()
                    content.encode(enc)
                    out.append(enc.to_bytes())
        return out
    except Exception:
        return None


def pack_updates_v2(
    payloads: List[bytes], pad_to: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Pad raw V2 update byte strings into ``[S, L] uint8`` + frame spans.

    Eleven varint reads per update (the feature flag, nine column length
    prefixes and the string column's blob length), unless its info column
    holds cold content kinds: then their payloads are transcoded into a
    V1-form sidecar appended after its bytes.

    Returns ``(buf, lens, spans, sidecar)``: ``spans[s, k] = (start,
    len)`` of the twelve regions (`SP_*`), int32 ``[S, 12, 2]``;
    ``sidecar`` an ``[S, NCOLD] int32`` of per-cold-block byte offsets
    into the lane row (wire block order, -1 padded), or None when no lane
    has cold content. A lane that fails the frame split gets all-zero
    spans, which `decode_updates_v2` flags malformed."""
    S = len(payloads)
    spans = np.zeros((S, 12, 2), dtype=np.int32)
    side: List[Optional[List[bytes]]] = [None] * S
    side_failed = [False] * S
    for s, p in enumerate(payloads):
        try:
            cur = Cursor(p)
            cur.read_u8()  # feature flag
            for k in range(9):
                n = cur.read_var_uint()
                spans[s, k] = (cur.pos, n)
                cur.read_exact(n)
            spans[s, SP_REST] = (cur.pos, len(p) - cur.pos)
            # string column: [varint blob_len][blob][lens rle]
            st, sl = spans[s, SP_STRING]
            if sl > 0:
                scur = Cursor(p[st : st + sl])
                bn = scur.read_var_uint()
                spans[s, SP_STR_BLOB] = (st + scur.pos, bn)
                spans[s, SP_STR_LENS] = (st + scur.pos + bn, sl - scur.pos - bn)
            ist, isl = spans[s, SP_INFO]
            if isl > 0 and _info_has_cold(p, int(ist), int(isl)):
                side[s] = _cold_sidecar(p)
                side_failed[s] = side[s] is None
        except Exception:
            spans[s] = 0  # malformed frame: flagged on the device
    n_cold = max((len(c) for c in side if c), default=0)
    lens = np.asarray([len(p) for p in payloads], dtype=np.int32)
    if n_cold == 0:
        L = max(pad_to or 0, int(lens.max()) if S else 1, 1)
        buf = np.zeros((S, L), dtype=np.uint8)
        for s, p in enumerate(payloads):
            buf[s, : len(p)] = np.frombuffer(p, dtype=np.uint8)
        return buf, lens, spans, None
    sidecar = np.full((S, n_cold), -1, dtype=np.int32)
    need = max(len(p) + sum(len(c) for c in (side[s] or [])) for s, p in enumerate(payloads))
    L = max(pad_to or 0, need, 1)
    buf = np.zeros((S, L), dtype=np.uint8)
    for s, p in enumerate(payloads):
        buf[s, : len(p)] = np.frombuffer(p, dtype=np.uint8)
        off = len(p)
        for k, cbytes in enumerate(side[s] or []):
            buf[s, off : off + len(cbytes)] = np.frombuffer(cbytes, dtype=np.uint8)
            sidecar[s, k] = off
            off += len(cbytes)
        if side_failed[s]:
            spans[s] = 0  # cold walk failed: flag the lane malformed
    return buf, lens, spans, sidecar


def pack_updates_v2_raw(payloads: List[bytes]):
    """`pack_updates_v2` for the raw ingest lane: the same spans, but the
    bytes ship as one flat arena with per-update offsets; the lane matrix
    is gathered on the device (`decode_updates_v2_raw`).

    Returns ``(wire, offsets, row_lens, lens, spans, sidecar, width)``:
    ``wire`` the flat u8 arena (each update's bytes followed by its
    V1-form sidecars, the packed row layout), ``offsets`` the ``[S]`` i32
    arena starts, ``row_lens`` the ``[S]`` i32 staged extent per lane
    (payload + sidecars: the gather's zero mask must not cut sidecar
    refs past the payload), ``lens`` the ``[S]`` payload lengths and
    ``width`` the per-lane window (the packed ``L``)."""
    buf, lens, spans, sidecar = pack_updates_v2(payloads)
    S, L = buf.shape
    row_lens = lens.copy()
    if sidecar is not None:
        # the staged extent of a sidecar-carrying lane: its last nonzero
        # byte, read from the pack itself so the two layouts agree
        for s in np.nonzero(sidecar[:, 0] >= 0)[0]:
            nz = buf[s].nonzero()[0]
            last = int(nz[-1]) + 1 if nz.size else 0
            row_lens[s] = max(int(lens[s]), last)
    offsets = np.zeros(S, dtype=np.int32)
    if S > 1:
        offsets[1:] = np.cumsum(row_lens[:-1])
    wire = np.zeros(max(int(row_lens.sum()), 1), dtype=np.uint8)
    for s in range(S):
        o, n = int(offsets[s]), int(row_lens[s])
        wire[o : o + n] = buf[s, :n]
    return wire, offsets, row_lens, lens, spans, sidecar, L


# --- caps ----------------------------------------------------------------------

# rest-walker container stack depth: maps nest up to W_DEPTH - 1 levels
# (arrays nest at any level: they spend their level's elems counter);
# deeper wire sets `deep` -> FLAG_UNSUPPORTED
W_DEPTH = 4

# rest-walker states
(
    W_NC,
    W_SEC_N,
    W_SEC_CLK,
    W_BLK,
    W_SKIP,
    W_MVF,
    W_MSC,
    W_MSK,
    W_MEC,
    W_MEK,
    W_ANY,
    W_MKEY,
    W_MVAL,
    W_BUF,
    W_DS,
    W_DONE,
) = range(16)


def v2_caps(U: int, R: int, SEC: int) -> dict:
    """The plain version's per-lane caps: blocks NB (Skip runs included),
    rest slots NV, strings NS, client-column entries NCLI, delete
    sections DSEC and the walker's step budget T."""
    NB = U + 8
    DSEC = R + 4
    NV = 2 + 2 * SEC + NB + 2 * DSEC + 2 * R
    return dict(NB=NB, DSEC=DSEC, NV=NV, NS=2 * U + 4, NCLI=3 * NB + SEC + 2,
                T=NV + 3 * NB + 8 * max(1, NB // 2) + 16)


# --- 32-bit helpers -------------------------------------------------------------


def _w32(x):
    """int64 -> the int32 value with the same low 32 bits (as int64)."""
    x = x & _MASK
    return torch.where(x >= (1 << 31), x - (1 << 32), x)


def _mul32(a, c: int):
    """``(a * c) mod 2**32`` for a uint32 constant `c`, exact in int64."""
    a = a & _MASK
    lo = (a & 0xFFFF) * c
    hi = (((a >> 16) & 0xFFFF) * c) & 0xFFFF
    return (lo + (hi << 16)) & _MASK


def _pow31(n: int, device) -> torch.Tensor:
    return torch.tensor([pow(31, i, 1 << 32) for i in range(n)], dtype=I64, device=device)


def _gather(a, idx, hi: int):
    """``a[s, clamp(idx[s, k], 0, hi)]`` (JAX clamps out-of-range gathers)."""
    return torch.gather(a, 1, idx.clamp(0, hi))


def _cumsum_excl(x):
    return torch.cumsum(x, dim=1) - x


def _window(b, pos, end, width: int):
    """``[S, width]`` byte window at per-lane `pos`, zero at or past `end`."""
    L = b.shape[1]
    at = pos[:, None] + torch.arange(width, dtype=I64, device=b.device)[None, :]
    return torch.where(at < end[:, None], _gather(b, at, L - 1), 0)


def _in_varint(w):
    """``[..., 10]`` mask of the bytes of the varint that starts at byte 0."""
    ones = torch.ones_like(w[..., :1])
    return torch.cat([ones, torch.cumprod((w[..., :9] >= 0x80).to(I64), dim=-1)], dim=-1)


def _uvar_from(w):
    """Unsigned lib0 varint from an ``[S, 10]`` window -> (value wrapped to
    32 bits, nbytes, ovf)."""
    inb = _in_varint(w)
    nbytes = inb.sum(dim=1)
    shifts = (7 * torch.arange(5, dtype=I64, device=w.device))[None, :]
    terms = torch.where(inb[:, :5] == 1, ((w[:, :5] & 0x7F) << shifts) & _MASK, 0)
    val = _w32(terms.sum(dim=1))
    ovf = (nbytes > 5) | ((nbytes == 5) & ((w[:, 4] & 0x7F) >= 8))
    return val, nbytes, ovf


def _svar_from(w):
    """Signed lib0 varint (6 bits + sign in byte 0, then 7-bit groups) from
    an ``[S, 10]`` window -> (magnitude wrapped to 32 bits, negative,
    nbytes, ovf)."""
    inb = _in_varint(w)
    nbytes = inb.sum(dim=1)
    neg = (w[:, 0] & 0x40) != 0
    shifts = (6 + 7 * torch.arange(4, dtype=I64, device=w.device))[None, :]
    terms = torch.where(inb[:, 1:5] == 1, ((w[:, 1:5] & 0x7F) << shifts) & _MASK, 0)
    mag = _w32((w[:, 0] & 0x3F) + terms.sum(dim=1))
    ovf = (nbytes > 5) | ((nbytes == 5) & ((w[:, 4] & 0x7F) >= 16))
    return mag, neg, nbytes, ovf


def _svar_limbs(w):
    """64-bit magnitude of a signed lib0 varint as (lo, hi) uint32 limbs:
    byte 0 gives 6 bits, byte k >= 1 7 bits at offset 6 + 7(k-1)."""
    inb = _in_varint(w)
    lo = w[:, 0] & 0x3F
    hi = torch.zeros_like(lo)
    for k in range(1, 10):
        o = 6 + 7 * (k - 1)
        g = torch.where(inb[:, k] == 1, w[:, k] & 0x7F, 0)
        if o < 32:
            lo = (lo + ((g << o) & _MASK)) & _MASK
            if o > 25:  # straddles bit 32
                hi = (hi + (g >> (32 - o))) & _MASK
        else:
            hi = (hi + ((g << (o - 32)) & _MASK)) & _MASK
    return lo, hi


def _varint_hash(byte_k, in_seq, nbytes, pow31):
    """`client_hash_host` mixing over varint bytes: ``(sum byte_k * 31**k)
    ^ (nbytes * 2654435761)``, 30 bits."""
    h = torch.where(in_seq, byte_k * pow31, 0).sum(dim=-1) & _MASK
    return (h ^ _mul32(nbytes, 2654435761)) & 0x3FFFFFFF


def _hash_u64_varint(lo, hi, pow31_10):
    """`client_hash_host` of the value's unsigned-varint bytes, rebuilt
    from its (lo, hi) limbs: V2's signed client varints resolve through
    the same hash table as V1's unsigned ones."""
    groups = []
    for k in range(10):
        o = 7 * k
        if o < 32:
            g = (lo >> o) & 0x7F
            if o > 25:
                g = g | (((hi << (32 - o)) & _MASK) & 0x7F)
        else:
            g = (hi >> (o - 32)) & 0x7F
        groups.append(g)
    gs = torch.stack(groups, dim=-1)
    idx10 = torch.arange(10, dtype=I64, device=lo.device)
    last = torch.where(gs != 0, idx10[None, :], 0).max(dim=1).values
    nbytes = last + 1
    in_seq = idx10[None, :] < nbytes[:, None]
    is_last = idx10[None, :] == last[:, None]
    byte_k = torch.where(in_seq, gs | torch.where(is_last, 0, 0x80), 0)
    return _varint_hash(byte_k, in_seq, nbytes, pow31_10[None, :])


# --- RLE column expanders --------------------------------------------------------


def _expand_uintoptrle(b, start, length, N: int, pow31_10=None):
    """UIntOptRle column -> ``([S, N] values, produced)``: a signed varint;
    negative opens a run of its magnitude, ``count = next uvarint + 2``,
    else one value. With `pow31_10` (the client column) a value beyond
    i32 becomes ``-2 - client_hash`` of its unsigned-varint bytes."""
    S = b.shape[0]
    dev = b.device
    end = start + length
    iota = torch.arange(N, dtype=I64, device=dev)[None, :]
    pos = torch.where(length > 0, start, end)
    oidx = torch.zeros(S, dtype=I64, device=dev)
    vals = torch.zeros((S, N), dtype=I64, device=dev)
    for _ in range(N):
        active = (pos < end) & (oidx < N)
        if not bool(active.any()):
            break
        w = _window(b, pos, end, 10)
        mag, neg, nb, ovf = _svar_from(w)
        if pow31_10 is not None:
            lo, hi = _svar_limbs(w)
            mag = torch.where(ovf, -2 - _hash_u64_varint(lo, hi, pow31_10), mag)
        cnt, nb2, _ = _uvar_from(_window(b, pos + nb, end, 10))
        count = torch.where(neg, _w32(cnt + 2), 1)
        adv = nb + torch.where(neg, nb2, 0)
        mask = (iota >= oidx[:, None]) & (iota < _w32(oidx + count)[:, None]) & active[:, None]
        vals = torch.where(mask, mag[:, None], vals)
        pos = torch.where(active, pos + adv, pos)
        oidx = torch.where(active, _w32(oidx + count), oidx)
    return vals, oidx


def _expand_intdiffoptrle(b, start, length, N: int):
    """IntDiffOptRle column -> ``([S, N] values, produced)``: a signed
    varint ``(diff << 1) | has_count``; a run's values are last + diff,
    last + 2 diff, ..."""
    S = b.shape[0]
    dev = b.device
    end = start + length
    iota = torch.arange(N, dtype=I64, device=dev)[None, :]
    pos = torch.where(length > 0, start, end)
    oidx = torch.zeros(S, dtype=I64, device=dev)
    last = torch.zeros(S, dtype=I64, device=dev)
    vals = torch.zeros((S, N), dtype=I64, device=dev)
    for _ in range(N):
        active = (pos < end) & (oidx < N)
        if not bool(active.any()):
            break
        mag, neg, nb, _ = _svar_from(_window(b, pos, end, 10))
        enc = _w32(torch.where(neg, -mag, mag))
        has_count = (enc & 1) != 0
        diff = enc >> 1
        cnt, nb2, _ = _uvar_from(_window(b, pos + nb, end, 10))
        count = torch.where(has_count, _w32(cnt + 2), 1)
        adv = nb + torch.where(has_count, nb2, 0)
        k = _w32(iota - oidx[:, None] + 1)  # 1-based position in the run
        mask = (k >= 1) & (k <= count[:, None]) & active[:, None]
        vals = torch.where(mask, _w32(last[:, None] + _w32(diff[:, None] * k)), vals)
        last = torch.where(active, _w32(last + _w32(diff * count)), last)
        pos = torch.where(active, pos + adv, pos)
        oidx = torch.where(active, _w32(oidx + count), oidx)
    return vals, oidx


def _expand_rle(b, start, length, N: int):
    """Rle column -> ``([S, N] u8 values, produced)``: a u8 value, then
    ``count - 1`` as a uvarint, omitted on the last entry (it fills out)."""
    S = b.shape[0]
    dev = b.device
    end = start + length
    iota = torch.arange(N, dtype=I64, device=dev)[None, :]
    pos = torch.where(length > 0, start, end)
    oidx = torch.zeros(S, dtype=I64, device=dev)
    vals = torch.zeros((S, N), dtype=I64, device=dev)
    for _ in range(N):
        active = (pos < end) & (oidx < N)
        if not bool(active.any()):
            break
        value = _window(b, pos, end, 1)[:, 0]
        has_count = (pos + 1) < end
        cnt, nb2, _ = _uvar_from(_window(b, pos + 1, end, 10))
        count = torch.where(has_count, _w32(cnt + 1), N)
        adv = 1 + torch.where(has_count, nb2, 0)
        mask = (iota >= oidx[:, None]) & (iota < _w32(oidx + count)[:, None]) & active[:, None]
        vals = torch.where(mask, value[:, None], vals)
        pos = torch.where(active, pos + adv, pos)
        oidx = torch.where(active, _w32(oidx + count), oidx)
    return vals, oidx


# --- the rest stream --------------------------------------------------------------


def _bulk_uvarints(b, start, end, NV: int):
    """Every unsigned varint of a region at once: a lib0 varint ends at its
    first byte < 0x80, so terminator k ends value k; positions by cumsum +
    searchsorted, values from 5-byte windows. Returns ``(vals [S, NV],
    n_varints [S], ovf [S, NV], starts [S, NV])``."""
    S, L = b.shape
    dev = b.device
    iota = torch.arange(L, dtype=I64, device=dev)[None, :]
    term = (iota >= start[:, None]) & (iota < end[:, None]) & (b < 0x80)
    cum = torch.cumsum(term.to(I64), dim=1)
    n_varints = cum[:, -1]
    targets = torch.arange(1, NV + 1, dtype=I64, device=dev)[None, :].expand(S, NV).contiguous()
    term_pos = torch.searchsorted(cum, targets)
    starts = torch.cat([start[:, None], (term_pos + 1)[:, :-1]], dim=1)
    idx = (starts[:, :, None] + torch.arange(5, dtype=I64, device=dev)[None, None, :]).reshape(S, -1)
    w = _gather(b, idx, L - 1).reshape(S, NV, 5)
    nb = (term_pos - starts + 1).clamp(1, 10)
    inb = torch.arange(5, dtype=I64, device=dev)[None, None, :] < nb.clamp(max=5)[:, :, None]
    shifts = (7 * torch.arange(5, dtype=I64, device=dev))[None, None, :]
    vals = _w32(torch.where(inb, ((w & 0x7F) << shifts) & _MASK, 0).sum(dim=2))
    ovf = (nb > 5) | ((nb == 5) & ((w[:, :, 4] & 0x7F) >= 8))
    return vals, n_varints, ovf, starts


def _walker_defaults(S: int, NV: int, NB: int, dev) -> dict:
    z_nv = torch.zeros((S, NV), dtype=I64, device=dev)
    z_nb = torch.zeros((S, NB), dtype=I64, device=dev)
    return dict(
        vv=z_nv, vstart=z_nv.clone(), vovf=torch.zeros((S, NV), dtype=torch.bool, device=dev),
        c_start=z_nb, mvf=z_nb.clone(), msc=torch.full((S, NB), -1, dtype=I64, device=dev), msk=z_nb.clone(),
        mec=torch.full((S, NB), -1, dtype=I64, device=dev), mek=z_nb.clone(),
        bad=torch.zeros(S, dtype=torch.bool, device=dev), deep=torch.zeros(S, dtype=torch.bool, device=dev),
        n_varints=torch.zeros(S, dtype=I64, device=dev),
    )


def _rest_walker(b, start, end, NV: int, NB: int, T: int, is_skip, any_cnt, is_buf, is_move):
    """The rest stream of lanes whose blocks put non-varint bytes there
    (Any values, Binary bufs, Move payloads), walked by a per-lane state
    machine driven by the per-block content plan (all ``[S, NB]``):
    structural varints go to slots numbered as the bulk parse numbers a
    content-free lane's, content regions are skipped with their start
    recorded per block (`c_start`), Move fields parsed per block. Any
    values step one token a step over a W_DEPTH container stack; maps
    nested deeper set `deep`. A Move client id beyond i32 becomes ``-2 -
    client_hash`` of its bytes. `T` steps; a lane not DONE by then, or
    one that read past `end`, is `bad`."""
    S, L = b.shape
    dev = b.device
    ar = torch.arange(S, device=dev)
    pow31_10 = _pow31(10, dev)[None, :]
    out = _walker_defaults(S, NV, NB, dev)
    pos = torch.where(end > start, start, end)
    st = torch.where(end > start, W_NC, W_DONE)
    zero = torch.zeros(S, dtype=I64, device=dev)
    vidx, blk, blocks_left, nc_left, depth = zero, zero, zero, zero, zero
    elems = torch.zeros((S, W_DEPTH), dtype=I64, device=dev)
    pairs = torch.zeros((S, W_DEPTH), dtype=I64, device=dev)
    collapsed = torch.zeros(S, dtype=torch.bool, device=dev)

    def sget(a, d):
        return a[ar, d.clamp(0, W_DEPTH - 1)]

    def sset(a, d, v, mask):
        dd = d.clamp(0, W_DEPTH - 1)
        a = a.clone()
        a[ar, dd] = torch.where(mask, v, a[ar, dd])
        return a

    def gat(arr, idx):
        return arr[ar, idx.clamp(0, NB - 1)]

    for _ in range(T):
        active = (st != W_DONE) & (pos <= end)
        if not bool(active.any()):
            break
        w = _window(b, pos, end, 10)
        val, nb, ovf = _uvar_from(w)
        tag = w[:, 0]
        is_mv_state = (st == W_MVF) | (st == W_MSC) | (st == W_MSK) | (st == W_MEC) | (st == W_MEK)
        is_var_state = (st == W_NC) | (st == W_SEC_N) | (st == W_SEC_CLK) | (st == W_SKIP) | is_mv_state | (
            st == W_DS)
        inb = _in_varint(w)
        hashed_val = torch.where(ovf, -2 - _varint_hash(w, inb == 1, inb.sum(dim=1), pow31_10), val)

        in_any, in_mkey, in_mval = st == W_ANY, st == W_MKEY, st == W_MVAL
        val2, nb2, _ = _uvar_from(_window(b, pos + 1, end, 10))
        any_extra = torch.where(
            (tag == 127) | (tag == 126) | (tag == 121) | (tag == 120), 0,
            torch.where(tag == 125, nb2,
                        torch.where(tag == 124, 4,
                                    torch.where((tag == 123) | (tag == 122), 8,
                                                torch.where((tag == 119) | (tag == 116), _w32(nb2 + val2),
                                                            torch.where((tag == 117) | (tag == 118), nb2, 0))))))
        in_anyval = in_any | in_mval
        scalar_tag = (tag >= 116) & (tag != 117) & (tag != 118)
        bad_tag = tag < 116
        arr_tag = (tag == 117) & (val2 > 0)
        map_tag = (tag == 118) & (val2 > 0)
        scalar_like = scalar_tag | ((tag == 118) & (val2 == 0)) | ((tag == 117) & (val2 == 0))
        push = active & in_anyval & map_tag
        deep_bad = (active & in_anyval & bad_tag) | (push & (depth >= W_DEPTH - 1))
        push = push & ~deep_bad

        elems_delta = torch.where(
            active & in_any & scalar_like, -1,
            torch.where(active & in_any & arr_tag, val2 - 1, torch.where(active & in_mval & arr_tag, val2, 0)))
        ed2 = _w32(sget(elems, depth) + elems_delta)
        elems_n = sset(elems, depth, ed2, active & in_anyval)
        depth_n = torch.where(push, depth + 1, depth)
        pairs_n = sset(pairs, depth_n, val2, push)
        elems_n = sset(elems_n, depth_n, torch.zeros_like(val2), push)

        # a finished value completes its pair when no array children
        # remain; a finished map pops and completes a value below it
        pair_done = active & ((in_mval & scalar_like) | (in_any & scalar_like & (depth >= 1) & (ed2 == 0)))
        for _ in range(W_DEPTH):
            pd = _w32(sget(pairs_n, depth_n) - 1)
            pairs_n = sset(pairs_n, depth_n, pd, pair_done)
            map_closed = pair_done & (pd <= 0)
            depth_n = torch.where(map_closed, depth_n - 1, depth_n)
            e_at = sget(elems_n, depth_n)
            dec_nested = map_closed & (depth_n >= 1) & (e_at > 0)
            e_new = torch.where(dec_nested, e_at - 1, e_at)
            elems_n = sset(elems_n, depth_n, e_new, dec_nested)
            dec_top = map_closed & (depth_n == 0)
            elems_n = sset(elems_n, zero, _w32(elems_n[:, 0] - 1), dec_top)
            pair_done = map_closed & (depth_n >= 1) & (e_new == 0)
        post_any = active & in_anyval & ~deep_bad
        e_top = sget(elems_n, depth_n)
        to_mkey = (post_any & (depth_n >= 1) & (e_top == 0)) | push
        to_any = post_any & (((depth_n >= 1) & (e_top > 0)) | ((depth_n == 0) & (elems_n[:, 0] > 0)))
        any_finished = active & in_anyval & (depth_n == 0) & (elems_n[:, 0] <= 0)

        consumed = torch.where(
            is_var_state, nb,
            torch.where(in_any | in_mval, _w32(1 + any_extra),
                        torch.where(in_mkey | (st == W_BUF), _w32(nb + val), 0)))
        consumed = torch.where(active, consumed, 0)
        # Move payload varints are content: parsed per block, no slot
        emit_slot = active & is_var_state & ~is_mv_state
        slot = vidx.clamp(0, NV - 1)
        stored = torch.where((st == W_MSC) | (st == W_MEC), hashed_val, val)
        for name, v in (("vv", stored), ("vstart", pos)):
            out[name] = out[name].clone()
            out[name][ar, slot] = torch.where(emit_slot, v, out[name][ar, slot])
        out["vovf"] = out["vovf"].clone()
        out["vovf"][ar, slot] = out["vovf"][ar, slot] | (emit_slot & ovf)
        vidx2 = vidx + emit_slot.to(I64)
        mv_num_ovf = active & ovf & ((st == W_MVF) | (st == W_MSK) | (st == W_MEK))

        sblk = blk.clamp(0, NB - 1)

        def put_blk(name, cond, value):
            out[name] = out[name].clone()
            out[name][ar, sblk] = torch.where(active & cond, value, out[name][ar, sblk])

        put_blk("mvf", st == W_MVF, val)
        put_blk("msc", st == W_MSC, hashed_val)
        put_blk("msk", st == W_MSK, val)
        put_blk("mec", st == W_MEC, hashed_val)
        put_blk("mek", st == W_MEK, val)
        out["deep"] = out["deep"] | (active & deep_bad)
        out["bad"] = out["bad"] | (active & (pos + consumed > end) & (consumed > 0)) | mv_num_ovf

        collapsed2 = torch.where(st == W_MVF, (val & 1) != 0, collapsed)
        blk_is_skip, blk_any = gat(is_skip, blk), gat(any_cnt, blk)
        blk_buf, blk_move = gat(is_buf, blk), gat(is_move, blk)
        has_content = (blk_any > 0) | blk_buf | blk_move

        nst = st
        nst = torch.where(st == W_NC, torch.where(val > 0, W_SEC_N, W_DS), nst)
        nst = torch.where(st == W_SEC_N, W_SEC_CLK, nst)
        nst = torch.where(st == W_SEC_CLK, W_BLK, nst)
        sec_done = blocks_left == 0
        at_blk = (st == W_BLK) & ~sec_done
        dispatch_skip = at_blk & blk_is_skip
        dispatch_any = at_blk & ~blk_is_skip & (blk_any > 0)
        dispatch_buf = at_blk & ~blk_is_skip & blk_buf
        dispatch_move = at_blk & ~blk_is_skip & blk_move
        dispatch_none = at_blk & ~blk_is_skip & ~has_content
        nst = torch.where(dispatch_skip, W_SKIP, nst)
        nst = torch.where(dispatch_any, W_ANY, nst)
        nst = torch.where(dispatch_buf, W_BUF, nst)
        nst = torch.where(dispatch_move, W_MVF, nst)
        nst = torch.where((st == W_BLK) & sec_done, torch.where(nc_left > 1, W_SEC_N, W_DS), nst)
        put_blk("c_start", dispatch_any | dispatch_buf | dispatch_move, pos)
        fin = (st == W_SKIP) | any_finished | (st == W_BUF) | ((st == W_MSK) & collapsed2) | (st == W_MEK)
        nst = torch.where(st == W_MVF, W_MSC, nst)
        nst = torch.where(st == W_MSC, W_MSK, nst)
        nst = torch.where((st == W_MSK) & ~collapsed2, W_MEC, nst)
        nst = torch.where(st == W_MEC, W_MEK, nst)
        nst = torch.where(to_mkey, W_MKEY, nst)
        nst = torch.where(to_any, W_ANY, nst)
        nst = torch.where(in_mkey, W_MVAL, nst)
        nst = torch.where(fin, W_BLK, nst)
        nst = torch.where((st == W_DS) & (pos + consumed >= end), W_DONE, nst)
        nst = torch.where(active, nst, st)

        adv_blk = torch.where(active, (dispatch_none | fin).to(I64), 0)
        blk = blk + adv_blk
        blocks_left = torch.where(active & (st == W_SEC_N), val, blocks_left - adv_blk)
        nc_left = torch.where(active & (st == W_NC), val, nc_left) - (active & (st == W_BLK) & sec_done).to(I64)
        first = torch.zeros_like(elems_n)
        first[:, 0] = blk_any
        elems = torch.where(dispatch_any[:, None], first, elems_n)
        pairs = torch.where(dispatch_any[:, None], 0, pairs_n)
        depth = torch.where(dispatch_any, 0, depth_n)
        pos = torch.where(active, pos + consumed, pos)
        st, vidx, collapsed = nst, vidx2, collapsed2
    out["bad"] = out["bad"] | ((st != W_DONE) & (end > start))
    out["n_varints"] = vidx
    return out


# --- the plain version -----------------------------------------------------------


def _decode_v2_reference(buf, lens, spans, U: int, R: int, SEC: int, sidecar=None):
    """The plain version of the V2 decode: the JAX package's lane-parallel
    composition as torch ops. ``buf`` ``[S, L]`` uint8, ``lens`` ``[S]``,
    ``spans`` ``[S, 12, 2]``, ``sidecar`` ``[S, NCOLD]`` or None. Returns
    the pre-resolve ``(rows, dels, flags)`` (`decode_kernel.ROW_COLUMNS` ``[S, U]`` and
    `DEL_COLUMNS` ``[S, R]`` int64 with ``valid``; flags int64 ``[S]``)."""
    dev = buf.device
    S, L = buf.shape
    caps = v2_caps(U, R, SEC)
    NB, DSEC, NV, NS, NCLI = caps["NB"], caps["DSEC"], caps["NV"], caps["NS"], caps["NCLI"]
    b = buf.to(I64)
    lens = lens.to(I64).reshape(-1)
    sp = torch.as_tensor(spans, device=dev).to(I64).reshape(S, 12, 2)
    pow31_10 = _pow31(10, dev)
    bool_ = torch.bool

    def span(k):
        return sp[:, k, 0], sp[:, k, 1]

    flags = torch.zeros(S, dtype=I64, device=dev)
    # all-zero spans with a non-empty payload: the host frame split failed
    frame_bad = (lens > 0) & (sp.reshape(S, -1).abs().sum(dim=1) == 0)
    flags = flags | torch.where(frame_bad, FLAG_MALFORMED, 0)

    # --- column expansions ---------------------------------------------------
    info_vals, info_n = _expand_rle(b, *span(SP_INFO), NB)
    pi_vals, pi_n = _expand_rle(b, *span(SP_PARENT_INFO), NB)
    cli_vals, cli_n = _expand_uintoptrle(b, *span(SP_CLIENT), NCLI, pow31_10=pow31_10)
    lc_vals, lc_n = _expand_intdiffoptrle(b, *span(SP_LEFT_CLOCK), NB)
    rc_vals, rc_n = _expand_intdiffoptrle(b, *span(SP_RIGHT_CLOCK), NB)
    len_vals, len_n = _expand_uintoptrle(b, *span(SP_LEN), NB)
    tr_vals, tr_n = _expand_uintoptrle(b, *span(SP_TYPE_REF), NB)
    str16, str_n = _expand_uintoptrle(b, *span(SP_STR_LENS), NS)

    # string byte offsets: binary search of the row's UTF-16 prefix sums
    # for each string's cumulative unit target inside the blob
    head = ((b & 0xC0) != 0x80).to(I64)
    lead4 = (b >= 0xF0).to(I64)
    u16_psum = torch.cat([torch.zeros((S, 1), dtype=I64, device=dev), torch.cumsum(head + lead4, dim=1)], dim=1)
    blob_start, blob_len = span(SP_STR_BLOB)
    base16 = _gather(u16_psum, blob_start[:, None], L)
    tgt16 = _w32(base16 + _cumsum_excl(str16))
    lo = blob_start[:, None].expand(S, NS)
    hi = (blob_start + blob_len)[:, None].expand(S, NS)
    for _ in range(18):  # L < 2**18: the first byte index with psum >= target
        mid = (lo + hi) // 2
        go_right = _gather(u16_psum, mid, L) < tgt16
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    str_start = lo
    str_end = torch.cat([str_start[:, 1:], (blob_start + blob_len)[:, None]], dim=1)
    str_bytes = str_end - str_start

    # --- per-block column consumption (the info bytes decide it) -------------
    iota_nb = torch.arange(NB, dtype=I64, device=dev)[None, :]
    info = info_vals
    is_gc = info == BLOCK_GC
    is_skip = info == BLOCK_SKIP
    is_item = ~is_gc & ~is_skip
    kind4 = info & 0x0F
    has_o = is_item & ((info & 0x80) != 0)
    has_r = is_item & ((info & 0x40) != 0)
    cant_copy = is_item & ~has_o & ~has_r
    has_psub = cant_copy & ((info & 0x20) != 0)
    pi = _gather(pi_vals, _cumsum_excl(cant_copy.to(I64)), NB - 1)
    is_root = cant_copy & (pi == 1)
    is_nested = cant_copy & (pi != 1)
    # client column: one entry per origin id, right-origin id, nested parent
    c_cnt = has_o.to(I64) + has_r.to(I64) + is_nested.to(I64)
    c_base = _cumsum_excl(c_cnt)
    l_cnt = (has_o | is_nested).to(I64)
    l_idx = _cumsum_excl(l_cnt)
    r_idx = _cumsum_excl(has_r.to(I64))
    is_str = is_item & (kind4 == CONTENT_STRING)
    is_del = is_item & (kind4 == CONTENT_DELETED)
    is_any = is_item & (kind4 == CONTENT_ANY)
    is_json = is_item & (kind4 == CONTENT_JSON)
    is_bin = is_item & (kind4 == CONTENT_BINARY)
    is_embed = is_item & (kind4 == CONTENT_EMBED)
    is_format = is_item & (kind4 == CONTENT_FORMAT)
    is_type = is_item & (kind4 == CONTENT_TYPE)
    is_doc = is_item & (kind4 == (CONTENT_DOC & 0x0F))
    is_move = is_item & (kind4 == (CONTENT_MOVE & 0x0F))
    # one Any value rides the rest stream for Embed, Format and Doc
    is_one_any = is_item & (is_embed | is_format | is_doc)
    # len column: GC and Deleted lengths, Any and Json element counts
    n_cnt = (is_gc | is_del | is_any | is_json).to(I64)
    len_at_blk = _gather(len_vals, _cumsum_excl(n_cnt), NB - 1)
    w_any_cnt = torch.where(is_any, len_at_blk, torch.where(is_one_any, 1, 0))
    # type-ref column: one entry per ContentType; XmlElement / XmlHook
    # also consume a string (the node name)
    tr_tag = _gather(tr_vals, _cumsum_excl(is_type.to(I64)), NB - 1)
    is_type_named = is_type & ((tr_tag == 3) | (tr_tag == 5))
    type_weak_or_unknown = is_type & (tr_tag >= 7)
    # string column per block: root name, parent_sub, then content strings
    s_cnt = _w32(is_root.to(I64) + has_psub.to(I64) + is_str.to(I64) + torch.where(is_json, len_at_blk, 0)
                 + is_format.to(I64) + is_type_named.to(I64))
    s_base = _w32(_cumsum_excl(s_cnt))
    cum_skip = _cumsum_excl(is_skip.to(I64))
    cum_skip_incl = torch.cumsum(is_skip.to(I64), dim=1)

    def skips_upto(n):
        """Skip blocks among blocks [0, n) per lane."""
        at = _gather(cum_skip_incl, (n - 1)[:, None], NB - 1)[:, 0]
        return torch.where(n > 0, at, 0)

    # --- rest stream ------------------------------------------------------------
    rest_start, rest_len = span(SP_REST)
    rest_end = rest_start + rest_len
    v, n_varints, v_ovf, v_starts = _bulk_uvarints(b, rest_start, rest_end, NV)
    lane_has_content = ((w_any_cnt > 0) | is_bin | is_move).any(dim=1)
    walker = _walker_defaults(S, NV, NB, dev)
    sel = lane_has_content.nonzero()[:, 0]
    if sel.numel():
        part = _rest_walker(b[sel], rest_start[sel], rest_end[sel], NV, NB, caps["T"], is_skip[sel],
                            w_any_cnt[sel], is_bin[sel], is_move[sel])
        for name, val in part.items():
            walker[name] = walker[name].clone()
            walker[name][sel] = val
    selc = lane_has_content[:, None]
    v = torch.where(selc, walker["vv"], v)
    v_starts = torch.where(selc, walker["vstart"], v_starts)
    v_ovf = torch.where(selc, walker["vovf"], v_ovf)
    n_varints = torch.where(lane_has_content, walker["n_varints"], n_varints)
    walk_bad = lane_has_content & walker["bad"]
    deep_any = lane_has_content & walker["deep"]

    def vat(idx, used):
        """v[idx] and whether a used position is past the parsed varints or
        overflowed."""
        out = _gather(v, idx, NV - 1)
        bad = used & ((idx >= n_varints[:, None]) | (idx >= NV))
        ob = used & _gather(v_ovf.to(I64), idx, NV - 1).to(bool_)
        return out, (bad | ob).any(dim=1)

    def vat_id(idx, used):
        """`vat` for a client-id position: a value beyond i32 is a real
        53-bit client, ``-2 - client_hash`` of its wire bytes."""
        out = _gather(v, idx, NV - 1)
        bad = used & ((idx >= n_varints[:, None]) | (idx >= NV))
        ovf = _gather(v_ovf.to(I64), idx, NV - 1).to(bool_)
        st = _gather(v_starts, idx, NV - 1)
        K = st.shape[1]
        wb = _gather(b, (st[:, :, None] + torch.arange(10, dtype=I64, device=dev)[None, None, :]).reshape(S, -1),
                     L - 1).reshape(S, K, 10)
        inb = _in_varint(wb)
        h = _varint_hash(wb, inb == 1, inb.sum(dim=2), pow31_10[None, None, :])
        return torch.where(ovf, -2 - h, out), bad.any(dim=1)

    nc = v[:, 0]
    malformed = (lens > 0) & (n_varints < 1)
    flags = flags | torch.where(nc > 1, FLAG_MULTI_CLIENT, 0)
    sec_ovf = nc > SEC

    # --- section walk -------------------------------------------------------------
    vidx = torch.ones(S, dtype=I64, device=dev)
    base = torch.zeros(S, dtype=I64, device=dev)
    sec_h = torch.full((S, SEC), -1, dtype=I64, device=dev)
    sec_base = torch.full((S, SEC), NB, dtype=I64, device=dev)
    for i in range(SEC):
        active = i < nc
        nb_i = vat(vidx[:, None], active[:, None])[0][:, 0]
        sec_h[:, i] = torch.where(active, vidx, -1)
        sec_base[:, i] = torch.where(active, base, NB)
        nxt = _w32(base + nb_i).clamp(0, NB)
        skips_i = skips_upto(nxt) - skips_upto(base)
        vidx = torch.where(active, _w32(vidx + 2 + skips_i), vidx)
        base = torch.where(active, nxt, base)
    total_blocks = base
    blk_ovf = (total_blocks > NB) | (total_blocks > info_n) | sec_ovf

    valid_blk = iota_nb < total_blocks[:, None]
    sec_id = ((sec_base[:, None, :] <= iota_nb[:, :, None]).to(I64).sum(dim=2) - 1).clamp(0, SEC - 1)
    blk_h = torch.gather(sec_h, 1, sec_id)
    blk_secbase = torch.gather(sec_base, 1, sec_id)
    sec_clk, bad_v1 = vat(blk_h.clamp(0, NV - 1) + 1, valid_blk & (blk_h >= 0))
    sec_client = _gather(cli_vals, sec_id + _gather(c_base, blk_secbase, NB - 1), NCLI - 1)

    # skip lengths ride the rest stream between their section's blocks
    skip_vidx = _w32(blk_h + 2 + cum_skip - _gather(cum_skip, blk_secbase, NB - 1))
    skip_len, bad_v2 = vat(skip_vidx.clamp(0, NV - 1), valid_blk & is_skip)

    blk_cli_base = sec_id + 1 + c_base
    lc_at = _gather(lc_vals, l_idx, NB - 1)
    oc = torch.where(valid_blk & has_o, _gather(cli_vals, blk_cli_base, NCLI - 1), -1)
    ok = torch.where(valid_blk & has_o, lc_at, 0)
    rc = torch.where(valid_blk & has_r, _gather(cli_vals, blk_cli_base + has_o.to(I64), NCLI - 1), -1)
    rk = torch.where(valid_blk & has_r, _gather(rc_vals, r_idx, NB - 1), 0)
    pc = torch.where(valid_blk & is_nested, _gather(cli_vals, blk_cli_base, NCLI - 1), -1)
    pk = torch.where(valid_blk & is_nested, lc_at, 0)
    ptag = torch.where(is_root, 1, torch.where(is_nested, 2, 0))

    # string indices: root name at s_base, parent_sub next, content last
    psub_idx = _w32(s_base + is_root.to(I64))
    content_sidx = _w32(psub_idx + has_psub.to(I64))
    psub_start = _gather(str_start, psub_idx, NS - 1)
    psub_bytes = _gather(str_bytes, psub_idx, NS - 1)
    content_start = _gather(str_start, content_sidx, NS - 1)
    content_len16 = _gather(str16, content_sidx, NS - 1)
    pow31k = _pow31(KEY_HASH_BYTES, dev)[None, None, :]
    arkh = torch.arange(KEY_HASH_BYTES, dtype=I64, device=dev)[None, None, :]

    def name_hash(start, nbytes):
        """The V1 lane's `key_hash_host` of the string at byte `start`."""
        w = _gather(b, (start[:, :, None] + arkh).reshape(S, -1), L - 1).reshape(S, NB, KEY_HASH_BYTES)
        h = torch.where(arkh < nbytes[:, :, None], w * pow31k, 0).sum(dim=2) & _MASK
        return (h ^ _mul32(nbytes, 2654435761)) & 0x7FFFFFFF

    keyh = torch.where(valid_blk & has_psub, name_hash(psub_start, psub_bytes), -1)
    key_too_long = valid_blk & has_psub & (psub_bytes > KEY_HASH_BYTES)
    rname_start = _gather(str_start, s_base, NS - 1)
    rname_bytes = _gather(str_bytes, s_base, NS - 1)
    rooth = torch.where(valid_blk & is_root,
                        torch.where(rname_bytes <= KEY_HASH_BYTES, name_hash(rname_start, rname_bytes), -2), -1)

    # block lengths and clocks
    blk_len = torch.where(
        is_str, content_len16,
        torch.where(is_gc | is_del | is_any | is_json, len_at_blk,
                    torch.where(is_skip, skip_len, torch.where(is_item, 1, 0))))
    blk_len = torch.where(valid_blk, blk_len, 0)
    len_psum = _w32(_cumsum_excl(blk_len))
    clock = _w32(sec_clk + len_psum - _gather(len_psum, blk_secbase, NB - 1))

    # --- unsupported / overflow flags -------------------------------------------
    cold_mask = valid_blk & (is_json | is_embed | is_format | (is_type & ~type_weak_or_unknown))
    unsupported = (valid_blk & (is_doc | type_weak_or_unknown)).any(dim=1) | key_too_long.any(dim=1) | deep_any
    if sidecar is None:
        # no sidecar: the cold payload bytes cannot be addressed
        unsupported = unsupported | cold_mask.any(dim=1)
    consumption_ovf = (c_base[:, NB - 1] + 3 > NCLI) | (total_blocks > NB)
    # truncated columns: the info bytes imply counts each expansion must
    # have produced
    vb = valid_blk.to(I64)
    need_cli = nc.clamp(max=SEC) + (c_cnt * vb).sum(dim=1)
    need_str = _w32((s_cnt * vb).sum(dim=1))
    truncated = ((need_cli > cli_n) | ((l_cnt * vb).sum(dim=1) > lc_n) | ((has_r.to(I64) * vb).sum(dim=1) > rc_n)
                 | ((n_cnt * vb).sum(dim=1) > len_n) | (need_str > str_n)
                 | ((cant_copy.to(I64) * vb).sum(dim=1) > pi_n) | ((is_type.to(I64) * vb).sum(dim=1) > tr_n))
    str_cap_ovf = need_str > NS

    # --- delete set -----------------------------------------------------------------
    d0 = _w32(1 + 2 * nc.clamp(max=SEC) + skips_upto(total_blocks))
    ds_n, bad_v3 = vat(d0[:, None], ((lens > 0) & ~frame_bad)[:, None])
    ds_n = ds_n[:, 0]
    iota_r = torch.arange(R, dtype=I64, device=dev)[None, :]
    dels = dict(client=torch.zeros((S, R), dtype=I64, device=dev), start=torch.zeros((S, R), dtype=I64, device=dev),
                end=torch.zeros((S, R), dtype=I64, device=dev), valid=torch.zeros((S, R), dtype=bool_, device=dev))
    p = _w32(d0 + 1)
    out_base = torch.zeros(S, dtype=I64, device=dev)
    ds_bad = torch.zeros(S, dtype=bool_, device=dev)
    ds_ovf = torch.zeros(S, dtype=bool_, device=dev)
    for k in range(DSEC):
        active = k < ds_n
        cli, b1 = vat_id(p[:, None], active[:, None])
        nr, b2 = vat(_w32(p + 1)[:, None], active[:, None])
        cli, nr = cli[:, 0], nr[:, 0]
        in_sec = active[:, None] & (iota_r < nr[:, None])
        dv, b3 = vat(_w32(p[:, None] + 2 + 2 * iota_r), in_sec)
        lv, b4 = vat(_w32(p[:, None] + 3 + 2 * iota_r), in_sec)
        lv = _w32(lv + 1)  # write_ds_len stores length - 1
        dvm = torch.where(in_sec, dv, 0)
        lvm = torch.where(in_sec, lv, 0)
        clocks = _w32(torch.cumsum(dvm, dim=1) + _cumsum_excl(lvm))
        # range m of this section goes to output slot out_base + m
        tgt = out_base[:, None] + iota_r
        ohm = (iota_r[:, :, None] == tgt[:, None, :]) & in_sec[:, None, :]  # [S, out, m]
        hit = ohm.any(dim=2)
        ohm64 = ohm.to(I64)

        def put(cur, val):
            return torch.where(hit, (ohm64 * val[:, None, :]).sum(dim=2), cur)

        dels["client"] = put(dels["client"], cli[:, None].expand(S, R))
        dels["start"] = put(dels["start"], clocks)
        dels["end"] = put(dels["end"], _w32(clocks + lvm))
        dels["valid"] = dels["valid"] | hit
        ds_ovf = ds_ovf | (active & (_w32(out_base + nr) > R))
        ds_bad = ds_bad | b1 | b2 | b3 | b4
        p = torch.where(active, _w32(p + 2 + _w32(2 * nr)), p)
        out_base = torch.where(active, _w32(out_base + nr).clamp(0, R), out_base)
    ds_sec_ovf = ds_n > DSEC

    # --- row emission (Skip blocks compacted out) -------------------------------
    emit = valid_blk & ~is_skip & (blk_len > 0)
    emit_idx = _cumsum_excl(emit.to(I64))
    row_ovf = (emit & (emit_idx >= U)).any(dim=1)
    iota_u = torch.arange(U, dtype=I64, device=dev)[None, None, :]
    oh = (iota_u == emit_idx[:, :, None]) & (emit & (emit_idx < U))[:, :, None]  # [S, NB, U]
    oh64 = oh.to(I64)
    row_hit = oh.any(dim=1)

    def scatter(vec, fill):
        return torch.where(row_hit, (oh64 * vec[:, :, None]).sum(dim=1), fill)

    row_ids = torch.arange(S, dtype=I64, device=dev)[:, None]
    c_start = walker["c_start"]
    # content refs: strings point into the string blob, Any values at their
    # first value byte (count-less), Binary and Move spans are their V1
    # forms; cold kinds point at their V1-form sidecar spans, matched by
    # cold-block rank in wire block order
    has_span = is_any | is_bin | is_move
    side_bad = torch.zeros(S, dtype=bool_, device=dev)
    ref_cold = torch.full((S, NB), -1, dtype=I64, device=dev)
    if sidecar is not None:
        side_t = torch.as_tensor(sidecar, device=dev).to(I64).reshape(S, -1)
        NC2 = side_t.shape[1]
        cold_rank = _cumsum_excl(cold_mask.to(I64))
        if NC2:
            cold_off = _gather(side_t, cold_rank, NC2 - 1)
        else:
            cold_off = torch.full((S, NB), -1, dtype=I64, device=dev)
        side_bad = (cold_mask & ((cold_rank >= NC2) | (cold_off < 0))).any(dim=1)
        ref_cold = row_ids * L + cold_off
    ref_col = torch.where(is_str, row_ids * L + content_start,
                          torch.where(has_span, row_ids * L + c_start, torch.where(cold_mask, ref_cold, -1)))
    mvf = walker["mvf"]
    mv_collapsed = (mvf & 1) != 0
    mv_on = is_move & valid_blk
    rows = dict(
        client=scatter(sec_client, 0),
        clock=scatter(clock, 0),
        length=scatter(blk_len, 0),
        oc=scatter(oc, -1),
        ok=scatter(ok, 0),
        rc=scatter(rc, -1),
        rk=scatter(rk, 0),
        kind=scatter(torch.where(is_gc, BLOCK_GC, kind4), 0),
        ref=scatter(ref_col, -1),
        ptag=scatter(ptag, 0),
        pc=scatter(pc, -1),
        pk=scatter(pk, 0),
        keyh=scatter(keyh, -1),
        rooth=scatter(rooth, -1),
        msc=scatter(torch.where(mv_on, walker["msc"], -1), -1),
        msk=scatter(torch.where(mv_on, walker["msk"], 0), 0),
        msa=scatter(torch.where(mv_on, torch.where((mvf & 2) != 0, 0, -1), 0), 0),
        mec=scatter(torch.where(mv_on, torch.where(mv_collapsed, walker["msc"], walker["mec"]), -1), -1),
        mek=scatter(torch.where(mv_on, torch.where(mv_collapsed, walker["msk"], walker["mek"]), 0), 0),
        mea=scatter(torch.where(mv_on, torch.where((mvf & 4) != 0, 0, -1), 0), 0),
        mprio=scatter(torch.where(mv_on, mvf >> 6, -1), -1),
        valid=row_hit,
    )

    malformed = (malformed | frame_bad | bad_v1 | bad_v2 | bad_v3 | ds_bad | truncated | walk_bad | side_bad
                 | (valid_blk & (blk_len < 0)).any(dim=1))
    flags = (flags | torch.where(malformed, FLAG_MALFORMED, 0) | torch.where(unsupported, FLAG_UNSUPPORTED, 0)
             | torch.where(blk_ovf | row_ovf | consumption_ovf | ds_ovf | ds_sec_ovf | str_cap_ovf,
                           FLAG_OVERFLOW, 0))
    return rows, dels, flags


# --- the kernel ---------------------------------------------------------------------

#: C signatures of ``csrc/decode_v2.cu``'s entry points: the launch takes its
#: arguments as one packed array of int64 (`_LAUNCH_ARGS`), passed as one pointer
DECODE_V2_SIGNATURES = {"ytpu_decode_v2": [ctypes.c_char_p], "ytpu_decode_v2_scratch_words": [ctypes.c_int] * 3,
                        "ytpu_decode_v2_words": [ctypes.c_int] * 3}
#: the launch's arguments, in the order of ``DecodeV2Args`` in decode_v2.cu
_LAUNCH_ARGS = ("raw", "n_raw", "offs", "rlens", "lens", "spans", "side", "n_side", "S", "L", "U", "R", "SEC",
                "ct_keys", "ct_perm", "ct_n", "cht_keys", "cht_perm", "cht_n", "kt_keys", "kt_perm", "kt_n",
                "prim", "n_prim", "rows", "dels", "flags", "rvalid", "dvalid", "scratch", "stream")
_PACK = struct.Struct(f"<{len(_LAUNCH_ARGS)}q").pack
_NR, _ND = len(ROW_FIELDS), len(DEL_COLUMNS)


def _decode_v2_lib():
    from ytpu_torch.ops import _build

    return _build.bind("decode_v2", DECODE_V2_SIGNATURES, "ytpu_cuda_error_string")


def _launch_decode_v2(lib, buf, lens, spans, U: int, R: int, SEC: int, sidecar=None, offs=None, row_lens=None,
                      width=None, client_table=None, key_table=None, client_hash_table=None,
                      primary_root_hash=None, stream=None):
    """One launch of the V2 decode program in `lib` over ``buf``: the flat
    arena with ``offs`` and ``row_lens`` ``[S]`` and its `width`, or, with
    ``offs`` None, the contiguous ``[S, L]`` matrix; ``lens`` ``[S]``,
    ``spans`` ``[S, 12, 2]``, the sidecar and the intern tables; `stream`
    the CUDA stream handle (None in a host build). Returns ``(stream,
    flags, path)``: the int32 UpdateBatch and flags, views of one
    allocation, and where the program kept its lanes' column expansions,
    ``"shared"`` (the CTA's shared memory) or ``"global"`` (a
    device-memory scratch allocated here)."""
    from ytpu_torch.ops import _build

    dev = buf.device
    lens = _ints(lens, dev, "lens")
    S = lens.numel()
    if offs is None:
        if buf.dim() != 2 or buf.shape[0] != S:
            raise ValueError(f"decode_v2: an [S, L] matrix of {S} lanes, got {tuple(buf.shape)}")
        L, offs_p, rlens_p = buf.shape[1], 0, 0
    else:
        offs, row_lens = _ints(offs, dev, "offsets"), _ints(row_lens, dev, "row_lens")
        if buf.dim() != 1 or width is None or offs.numel() != S or row_lens.numel() != S:
            raise ValueError(f"decode_v2: a flat arena with [S] offsets and row_lens and a width, got "
                             f"{tuple(buf.shape)}, {offs.numel()} offsets, {row_lens.numel()} row_lens, width {width}")
        L, offs_p, rlens_p = int(width), offs.data_ptr(), row_lens.data_ptr()
    spans = _ints(spans, dev, "spans")
    if spans.numel() != 24 * S:
        raise ValueError(f"decode_v2: spans has {spans.numel()} words for {S} lanes of 12 spans")
    if spans.data_ptr() % 16:
        spans = spans.clone()  # the program reads a lane's spans as six 16-byte words
    side, n_side = None, -1
    if sidecar is not None:
        side = _ints(sidecar, dev, "sidecar")
        n_side = side.numel() // S if S else 0
    tabs = []
    for name, t in (("ct", client_table), ("cht", client_hash_table), ("kt", key_table)):
        if t is None:
            tabs += [0, 0, -1]
            continue
        keys, perm = _ints(t[0], dev, f"{name} keys"), _ints(t[1], dev, f"{name} perm")
        if perm.numel() < keys.numel():
            raise ValueError(f"decode_v2: the {name} table has {keys.numel()} keys and {perm.numel()} perm entries")
        tabs += [keys.data_ptr(), perm.data_ptr(), keys.numel()]
    prim = None if primary_root_hash is None else _ints(primary_root_hash, dev, "primary_root_hash")
    if prim is not None and prim.numel() not in (1, S):
        raise ValueError(f"decode_v2: primary_root_hash has {prim.numel()} entries for {S} lanes")

    # one allocation: the int32 row planes, delete planes and flags, then
    # the valid bytes of rows and ranges; the scratch only on its path
    n32 = (_NR * U + _ND * R + 1) * S
    o_dels, o_flags = _NR * S * U, (_NR * U + _ND * R) * S
    out = torch.empty(4 * n32 + -(-S * (U + R) // 4) * 4, dtype=torch.uint8, device=dev)
    words, bools = out.view(I32), out.view(torch.bool)
    n_scratch = int(lib.ytpu_decode_v2_scratch_words(U, R, SEC))
    scratch = torch.empty(n_scratch * -(-S // 32) * 32, dtype=I32, device=dev) if n_scratch else None
    base = out.data_ptr()
    err = lib.ytpu_decode_v2(_PACK(
        buf.data_ptr(), buf.numel(), offs_p, rlens_p, lens.data_ptr(), spans.data_ptr(),
        0 if side is None else side.data_ptr(), n_side, S, L, U, R, SEC, *tabs,
        0 if prim is None else prim.data_ptr(), 0 if prim is None else prim.numel(),
        base, base + 4 * o_dels, base + 4 * o_flags, base + 4 * n32, base + 4 * n32 + S * U,
        0 if scratch is None else scratch.data_ptr(), stream or 0))
    _build.check(lib, err, "decode_v2 kernel")
    stream_out = UpdateBatch(*words.as_strided((_NR, S, U), (S * U, U, 1), 0).unbind(0),
                             bools.as_strided((S, U), (U, 1), 4 * n32),
                             *words.as_strided((_ND, S, R), (S * R, R, 1), o_dels).unbind(0),
                             bools.as_strided((S, R), (R, 1), 4 * n32 + S * U))
    return stream_out, words.as_strided((S,), (1,), o_flags), ("global" if n_scratch else "shared")


def _decode_v2_kernel(buf, lens, spans, U: int, R: int, SEC: int, sidecar=None, offs=None, row_lens=None,
                      width=None, **tables):
    """The V2 decode program on CUDA tensors, on the current stream:
    `_launch_decode_v2`'s ``(stream, flags, path)``. Not counted in
    ``decode_updates_v2.launches``."""
    dev = buf.device
    if dev.type != "cuda":
        raise ValueError(f"the decode_v2 kernel runs on cuda tensors, not {dev}")
    if buf.dtype != torch.uint8 or not buf.is_contiguous():
        raise ValueError(f"the decode_v2 kernel takes contiguous uint8 bytes, got {buf.dtype}")
    stream = torch.cuda.current_stream(dev).cuda_stream
    return _launch_decode_v2(_decode_v2_lib(), buf, lens, spans, int(U), int(R), int(SEC), sidecar, offs, row_lens,
                             width, stream=stream, **tables)


def _decode(buf, lens, spans, max_rows, max_dels, max_sections, sidecar, tables: dict, arena=None):
    """`decode_updates_v2` (``arena`` None) and `decode_updates_v2_raw`
    (``arena`` = (offsets, row_lens, width)): one launch on CUDA tensors,
    the plain composition on CPU tensors."""
    U, R = int(max_rows), int(max_dels)
    SEC = int(max_sections) if max_sections is not None else 4
    if SEC < 1:
        raise ValueError(f"decode_updates_v2 needs max_sections >= 1, got {SEC}")
    dev = buf.device
    with torch.profiler.record_function("ytpu_torch.decode.v2"):
        if dev.type == "cuda":
            offs, row_lens, width = arena if arena is not None else (None, None, None)
            stream, flags, path = _decode_v2_kernel(buf, lens, spans, U, R, SEC, sidecar, offs, row_lens, width,
                                                    **tables)
            decode_updates_v2.launches += 1
            decode_updates_v2.paths[path] += 1
            return stream, flags
        if dev.type != "cpu":
            raise ValueError(f"decode_updates_v2 runs on cuda or cpu tensors, not {dev}")
        if arena is not None:
            offs, row_lens, width = arena
            buf = gather_raw_lanes(buf, torch.as_tensor(offs), torch.as_tensor(row_lens), width)
        rows, dels, flags = _decode_v2_reference(buf, torch.as_tensor(lens), spans, U, R, SEC, sidecar)
        return _resolve_and_pack(dict(rows), dict(dels), flags, **tables)


def decode_updates_v2(
    buf: torch.Tensor,
    lens,
    spans,
    max_rows: int,
    max_dels: int,
    max_sections: Optional[int] = None,
    client_table: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    key_table: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    client_hash_table: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    primary_root_hash: Optional[torch.Tensor] = None,
    sidecar=None,
):
    """Decode S V2 updates into an ``[S, U] / [S, R]`` UpdateBatch stream;
    returns ``(stream, flags)``.

    The contract of `decode_updates_v1` (its docstring has the tables'
    semantics); ``spans`` and ``sidecar`` come from `pack_updates_v2` (the
    sidecar carries the V1-form payload spans of Json, Embed, Format and
    Type content). Client ids beyond i32 hash to the same
    `client_hash_table` entries as on the V1 lane. String refs are byte
    offsets ``s * L + byte`` into ``buf``, read by `RawPayloadView`
    (``v2_any=True`` for Any values, which are count-less here).

    On CUDA tensors the whole call is one launch of the hand-written
    program of ``csrc/decode_v2.cu``, tables included (counted in
    ``decode_updates_v2.launches``, and by where it kept its column
    expansions in ``decode_updates_v2.paths``); on CPU tensors the plain
    composition `_decode_v2_reference` -> `_resolve_and_pack`. Any other
    device raises, and so does a kernel that fails to build or launch.
    The work runs inside the profiler span ``ytpu_torch.decode.v2``."""
    tables = dict(client_table=client_table, key_table=key_table, client_hash_table=client_hash_table,
                  primary_root_hash=primary_root_hash)
    return _decode(buf, lens, spans, max_rows, max_dels, max_sections, sidecar, tables)


decode_updates_v2.launches = 0
decode_updates_v2.paths = {"shared": 0, "global": 0}


def decode_updates_v2_raw(wire, offsets, row_lens, lens, spans, width: int, max_rows: int, max_dels: int,
                          max_sections: Optional[int] = None, sidecar=None, **tables):
    """`decode_updates_v2` over the raw arena of `pack_updates_v2_raw`.
    On CUDA tensors the program reads the arena in place: byte j of lane s
    is the byte `gather_raw_lanes` would put in the ``[S, width]`` lane
    matrix (zero at or past each lane's staged extent ``row_lens``, so cold
    sidecars survive). On CPU tensors the matrix is gathered first, then
    decoded as `decode_updates_v2` decodes it. The tables pass through as
    keywords."""
    return _decode(wire, lens, spans, max_rows, max_dels, max_sections, sidecar, tables,
                   arena=(offsets, row_lens, int(width)))
