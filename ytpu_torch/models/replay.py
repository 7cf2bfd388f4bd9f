"""Full-trace chunked replay of one shared update stream over a doc batch
(PyTorch port of `ytpu.models.replay`).

The stream is pre-scanned on the host (`plan_replay`: decode budgets,
worst-case growth per update, and a global UTF-16 unit arena for string
content), then replayed chunk by chunk through
`integrate_kernel.PackedReplayDriver.step_raw`: each chunk's raw wire bytes
are staged with `pack_raw_updates_into`, gathered into update lanes and
decoded on the device, rebased onto the unit arena, integrated by the CUDA
kernel and read out. Between chunks the driver compacts (and grows) the
packed state under the `CompactionPolicy`. Chunks dispatch serially.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np
import torch

from ytpu_torch.core.device import resolve_device

__all__ = [
    "ReplayPlan",
    "UnitArenaView",
    "plan_replay",
    "FusedReplay",
    "ChunkPlan",
    "plan_chunks",
    "build_wire_table",
    "raw_chunk_cap",
]


@dataclass
class ReplayPlan:
    """Host pre-scan of an update stream."""

    n_updates: int
    max_rows: int  # U bucket
    max_dels: int  # R bucket
    max_len: int  # longest update in bytes
    max_steps: int  # decode step budget
    max_sections: int
    max_client: int  # largest raw client id in the stream
    # per (update, row-slot): absolute UTF-16 unit offset of the row's
    # string content (-1 for non-string rows), assigned in wire order
    unit_refs: np.ndarray  # [S, U] i32
    # unit -> byte-start of its character within `arena` (both units of a
    # surrogate pair share the char start); sentinel entry = len(arena)
    unit_byte: np.ndarray  # [total_units + 1] i64
    arena: bytes  # concatenated string payload bytes (UTF-8)
    # worst-case state rows each update can add (rows x 3, delete ranges x 2)
    adds: np.ndarray = None  # [S] i32


def plan_replay(payloads: List[bytes]) -> ReplayPlan:
    from ytpu_torch.encoding.lib0 import update_columns
    from ytpu_torch.ops.decode_kernel import steps_for_columns

    S = len(payloads)
    max_rows = max_dels = max_len = max_steps = max_sections = 0
    max_client = 0
    adds = np.zeros(S, dtype=np.int32)
    rows_per: List[List[int]] = []
    arena_parts: List[bytes] = []
    unit_byte: List[int] = []
    total_bytes = 0
    for p in payloads:
        cols = update_columns(p)
        if cols.error:
            raise ValueError("malformed update in stream")
        max_len = max(max_len, len(p))
        max_sections = max(max_sections, cols.n_client_sections)
        refs_here: List[int] = []
        for i in range(cols.n_blocks):
            kind = int(cols.kind[i])
            if kind == 10:
                continue
            # the unit-ref arena covers text streams only
            if kind not in (0, 1, 4):
                raise ValueError(
                    f"replay plan supports text streams only (GC/Deleted/"
                    f"String); update carries content kind {kind}"
                )
            max_client = max(max_client, int(cols.client[i]))
            if int(cols.length[i]) <= 0:
                continue
            if kind == 4:
                # strip the varint length prefix from the content span
                span = cols.content_bytes(i)
                j, blen, shift = 0, 0, 0
                while True:
                    b = span[j]
                    blen |= (b & 0x7F) << shift
                    shift += 7
                    j += 1
                    if b < 0x80:
                        break
                sbytes = span[j : j + blen]
                refs_here.append(len(unit_byte))
                # per-unit char starts (surrogate pairs take two entries)
                k = 0
                while k < len(sbytes):
                    b0 = sbytes[k]
                    w = 1 if b0 < 0x80 else 2 if b0 < 0xE0 else 3 if b0 < 0xF0 else 4
                    unit_byte.append(total_bytes + k)
                    if w == 4:
                        unit_byte.append(total_bytes + k)
                    k += w
                arena_parts.append(sbytes)
                total_bytes += len(sbytes)
            else:
                refs_here.append(-1)
        rows_per.append(refs_here)
        adds[len(rows_per) - 1] = 3 * len(refs_here) + 2 * cols.n_dels
        max_rows = max(max_rows, len(refs_here))
        max_dels = max(max_dels, cols.n_dels)
        max_steps = max(max_steps, steps_for_columns(cols))
    U = max(1, max_rows)
    refs = np.full((S, U), -1, dtype=np.int32)
    for s, rr in enumerate(rows_per):
        refs[s, : len(rr)] = rr
    unit_byte.append(total_bytes)
    return ReplayPlan(
        n_updates=S,
        max_rows=U,
        max_dels=max(1, max_dels),
        max_len=max_len,
        max_steps=max_steps,
        max_sections=max(1, max_sections),
        max_client=max_client,
        unit_refs=refs,
        unit_byte=np.asarray(unit_byte, dtype=np.int64),
        arena=b"".join(arena_parts),
        adds=adds,
    )


class UnitArenaView:
    """Resolver over unit-addressed arena content: rows carry ``ref`` =
    absolute UTF-16 unit offset of their content start and ``off``/``len``
    in units; splits inside a surrogate pair render U+FFFD halves."""

    def __init__(self, unit_byte: np.ndarray, arena: bytes):
        self.unit_byte = unit_byte
        self.arena = arena

    def _is_second_half(self, u: int) -> bool:
        return u > 0 and self.unit_byte[u] == self.unit_byte[u - 1] and (
            u >= len(self.unit_byte) - 1 or self.unit_byte[u + 1] != self.unit_byte[u]
        )

    def slice_text(self, ref: int, off: int, length: int) -> str:
        p = int(ref) + int(off)
        q = p + int(length)
        if length <= 0:
            return ""
        prefix = suffix = ""
        if self._is_second_half(p):
            prefix = "�"
            p += 1
        end_mid = q < len(self.unit_byte) - 1 and self._is_second_half(q)
        b0 = int(self.unit_byte[p])
        b1 = int(self.unit_byte[q])
        if end_mid:
            suffix = "�"
        return prefix + self.arena[b0:b1].decode("utf-8") + suffix


@dataclass
class ReplayStats:
    chunks: int = 0
    compactions: int = 0
    growths: int = 0
    capacity: int = 0
    peak_blocks: int = 0
    final_blocks: int = 0
    syncs: int = 0
    chunk_seconds: List[float] = field(default_factory=list)
    stage_bytes: int = 0
    scan_hist: tuple = ()
    scan_max: int = 0
    scan_tier_cheap: int = 0
    scan_tier_wide: int = 0
    scan_trips_serial: int = 0
    scan_trips_two_tier: int = 0
    commit_word: int = 0
    occupied_rows: int = 0
    dead_rows: int = 0
    dead_max: int = 0
    reclaimed_rows: int = 0
    launch_rows_read: int = 0
    launch_rows_added: int = 0


@dataclass(frozen=True)
class ChunkPlan:
    """Host-side chunk/compaction plan for a fixed-capacity chunked replay."""

    chunk: int
    n_chunks: int
    max_chunk_adds: int
    budget: int
    capacity: int
    needs_compaction: bool

    @property
    def feasible(self) -> bool:
        return self.max_chunk_adds <= self.budget


def plan_chunks(adds, capacity: int, max_chunk: int = 8192, policy=None) -> ChunkPlan:
    """The largest power-of-two chunk <= `max_chunk` whose worst window of
    per-update adds fits the policy's per-chunk budget."""
    from ytpu_torch.models.batch_doc import DEFAULT_COMPACTION_POLICY

    policy = policy or DEFAULT_COMPACTION_POLICY
    adds = np.asarray(adds, dtype=np.int64)
    S = int(adds.shape[0])
    budget = policy.chunk_add_budget(capacity)
    cum = np.concatenate([[0], np.cumsum(adds)])

    def worst_window(chunk: int) -> int:
        starts = np.arange(0, S, chunk)
        ends = np.minimum(starts + chunk, S)
        return int((cum[ends] - cum[starts]).max(initial=0))

    chunk = 1 << max(0, int(max_chunk).bit_length() - 1)
    while chunk > 1 and worst_window(chunk) > budget:
        chunk //= 2
    return ChunkPlan(
        chunk=chunk,
        n_chunks=(S + chunk - 1) // chunk,
        max_chunk_adds=worst_window(chunk),
        budget=budget,
        capacity=capacity,
        needs_compaction=int(adds.sum()) > capacity,
    )


def build_wire_table(payloads) -> Tuple[np.ndarray, np.ndarray]:
    """``(wire, wire_offsets)``: the concatenated u8 bytes of the stream and
    its ``[S+1]`` prefix table."""
    n = len(payloads)
    lens = np.fromiter((len(p) for p in payloads), dtype=np.int64, count=n)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    wire = np.frombuffer(b"".join(payloads), dtype=np.uint8)
    return wire, offsets


def raw_chunk_cap(wire_offsets: np.ndarray, chunk: int) -> int:
    """Staging capacity for the raw lane: the worst byte span of any
    ``chunk``-update window plus the staged `EMPTY_UPDATE` tail, rounded
    up to 64."""
    from ytpu_torch.ops.decode_kernel import EMPTY_UPDATE

    S = len(wire_offsets) - 1
    if S <= 0:
        return 64
    ends = np.minimum(np.arange(S, dtype=np.int64) + chunk, S)
    worst = int((wire_offsets[ends] - wire_offsets[:S]).max())
    cap = worst + len(EMPTY_UPDATE)
    return -(-cap // 64) * 64


class _RawStagingSlot:
    """Staging buffer of the raw ingest lane: the chunk's concatenated wire
    bytes, per-update offset/length tables and global unit-ref rows."""

    __slots__ = ("raw", "offs", "lens", "refs", "pos", "end")

    def __init__(self, raw_cap: int, chunk: int, u: int):
        self.raw = np.zeros((raw_cap,), dtype=np.uint8)
        self.offs = np.zeros((chunk,), dtype=np.int32)
        self.lens = np.zeros((chunk,), dtype=np.int32)
        self.refs = np.full((chunk, u), -1, dtype=np.int32)
        self.pos = 0
        self.end = 0


class FusedReplay:
    """Chunked replay of one shared update stream over a doc batch, on the
    raw ingest lane: per chunk, the host stages the raw wire bytes and the
    device gathers, decodes, rebases, integrates (the CUDA kernel) and reads
    out; between chunks the driver compacts or grows the packed state.
    ``device=None`` runs on the GPU."""

    def __init__(
        self,
        n_docs: int,
        plan: ReplayPlan,
        capacity: int = 4096,
        max_capacity: int = 1 << 17,
        chunk: int = 8192,
        policy=None,
        device=None,
    ):
        from ytpu_torch.models.batch_doc import init_state
        from ytpu_torch.ops.integrate_kernel import pack_state

        self.device = resolve_device(device)
        self.plan = plan
        self.n_docs = n_docs
        self.chunk = chunk
        self.max_capacity = max_capacity
        self.policy = policy
        self.cols, self.meta = pack_state(init_state(n_docs, capacity, self.device))
        self.stats = ReplayStats(capacity=capacity)
        self._hi = 0
        self.driver = None

    def _resolve_rank(self, client_rank):
        from ytpu_torch.ops.decode_kernel import identity_rank

        if client_rank is None:
            # raw ids double as ranks only while they fit the identity table
            if self.plan.max_client >= 256:
                raise ValueError(
                    f"stream contains client id {self.plan.max_client}; "
                    "pass an explicit client_rank table"
                )
            client_rank = identity_rank(256, self.device)
        return torch.as_tensor(client_rank, dtype=torch.int32, device=self.device).contiguous()

    def make_driver(self, client_rank=None):
        from ytpu_torch.ops.integrate_kernel import PackedReplayDriver

        return PackedReplayDriver(
            self.cols,
            self.meta,
            self._resolve_rank(client_rank),
            policy=self.policy,
            unit_refs=True,
            gc_ranges=True,
            max_capacity=self.max_capacity,
            initial_occupancy=self._hi,
        )

    def stage_chunks(self, payloads: List[bytes]):
        """Yield one `_RawStagingSlot` per chunk (the same slot, restaged)."""
        from ytpu_torch.ops.decode_kernel import pack_raw_updates_into

        plan = self.plan
        wire, woffs = build_wire_table(payloads)
        slot = _RawStagingSlot(raw_chunk_cap(woffs, self.chunk), self.chunk, plan.unit_refs.shape[1])
        width = plan.max_len + 16
        for pos in range(0, len(payloads), self.chunk):
            end = min(pos + self.chunk, len(payloads))
            self.stats.stage_bytes += pack_raw_updates_into(
                wire, woffs, pos, end, slot.raw, slot.offs, slot.lens, width=width
            )
            slot.refs[: end - pos] = plan.unit_refs[pos:end]
            slot.refs[end - pos :] = -1
            slot.pos, slot.end = pos, end
            yield slot

    def dims(self):
        p = self.plan
        return (p.max_rows, p.max_dels, p.max_steps, p.max_sections)

    def run(self, payloads: List[bytes], client_rank=None) -> ReplayStats:
        """Replay `payloads` chunk by chunk, serially."""
        plan = self.plan
        driver = self.driver = self.make_driver(client_rank)
        width = plan.max_len + 16
        for slot in self.stage_chunks(payloads):
            t0 = time.perf_counter()
            margin = int(plan.adds[slot.pos : slot.end].sum()) + 8
            driver.step_raw(
                slot.raw, slot.offs, slot.lens, slot.refs, self.dims(), width,
                margin=margin,
            )
            self.cols, self.meta = driver.cols, driver.meta
            self.stats.chunk_seconds.append(time.perf_counter() - t0)
        self.cols, self.meta = driver.finish()
        self._merge_driver_stats(driver)
        return self.stats

    def _merge_driver_stats(self, driver) -> None:
        d = driver.stats
        st = self.stats
        st.chunks += d.chunks
        st.compactions += d.compactions
        st.growths += d.growths
        st.syncs += d.syncs
        st.peak_blocks = max(st.peak_blocks, d.peak_blocks)
        st.capacity = self.cols.shape[2]
        st.final_blocks = d.final_blocks
        st.scan_hist = d.scan_hist
        st.scan_max = d.scan_max
        st.scan_tier_cheap = d.scan_tier_cheap
        st.scan_tier_wide = d.scan_tier_wide
        st.scan_trips_serial = d.scan_trips_serial
        st.scan_trips_two_tier = d.scan_trips_two_tier
        st.commit_word = d.commit_word
        st.occupied_rows = d.occupied_rows
        st.dead_rows = d.dead_rows
        st.dead_max = d.dead_max
        st.reclaimed_rows += d.reclaimed_rows
        st.launch_rows_read += d.launch_rows_read
        st.launch_rows_added += d.launch_rows_added
        self._hi = d.final_blocks

    def get_string(self, doc: int) -> str:
        """Final text of one doc slot: a host walk over the sequence links
        of its rows, rendering live countable rows through the unit arena."""
        from ytpu_torch.ops.integrate_kernel import CN, DL, LN, M_NBLOCKS, M_START, OF, RF, RT

        cols = self.cols[:, doc, :].cpu().numpy()
        meta = self.meta[doc].cpu().numpy()
        view = UnitArenaView(self.plan.unit_byte, self.plan.arena)
        out: List[str] = []
        i = int(meta[M_START])
        hops = 0
        limit = int(meta[M_NBLOCKS]) + 2
        while i >= 0 and hops <= limit:
            if cols[DL, i] == 0 and cols[CN, i] == 1 and cols[RF, i] >= 0:
                out.append(view.slice_text(int(cols[RF, i]), int(cols[OF, i]), int(cols[LN, i])))
            i = int(cols[RT, i])
            hops += 1
        if hops > limit:
            raise RuntimeError("cycle in sequence links")
        return "".join(out)
