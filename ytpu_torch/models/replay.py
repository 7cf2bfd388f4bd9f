"""Full-trace chunked replay of one shared update stream over a doc batch
(PyTorch port of `ytpu.models.replay`).

The stream is pre-scanned on the host (`plan_replay`: decode budgets,
worst-case growth per update, and a global UTF-16 unit arena for string
content), then replayed chunk by chunk through
`integrate_kernel.PackedReplayDriver`: each chunk is decoded on the
device, rebased onto the unit arena, integrated by the CUDA kernel and
read out, and between chunks the driver compacts (and grows) the packed
state under the `CompactionPolicy`. `FusedReplay` runs the chunks
serially (host-packed lanes, a blocking flag check per chunk) or through
`OverlapPipeline`, a staging thread filling reusable page-locked slots
while the device runs the chunk before (raw wire bytes decoded in place,
or host-packed lanes). It checkpoints the packed state to the host,
resumes after a fault and quarantines updates the decode flags.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from functools import partial
from typing import Callable, Iterable, List, Optional, Tuple

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
    "OverlapPipeline",
    "OverlapStats",
    "OverlapPlan",
    "plan_overlap",
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
    """One native column walk over the whole log (`decode_update_columns_batch`),
    the budgets and worst-case adds from its columns and counts as array
    operations, then one pass over the string rows in wire order for the
    unit arena. Raises on the first update in log order that is malformed
    or carries a content kind other than GC, Deleted or String."""
    from ytpu_torch.core.content import BLOCK_GC, BLOCK_SKIP, CONTENT_DELETED, CONTENT_STRING
    from ytpu_torch.encoding.lib0 import BLOCK_COLUMNS
    from ytpu_torch.native import decode_update_columns_batch
    from ytpu_torch.ops.decode_kernel import exact_steps

    S = len(payloads)
    walk = decode_update_columns_batch(payloads)
    n_blocks, n_dels, n_sections, n_ds, n_zero, n_value, _, error = walk.counts.T.astype(np.int64)
    cols = dict(zip(BLOCK_COLUMNS, walk.blocks))
    kind, length, client = cols["kind"], cols["length"], cols["client"]
    upd = np.repeat(np.arange(S), n_blocks)
    live = kind != BLOCK_SKIP
    # the unit-ref arena covers text streams only
    foreign = np.flatnonzero(live & (kind != BLOCK_GC) & (kind != CONTENT_DELETED) & (kind != CONTENT_STRING))
    bad = np.flatnonzero(error)
    if bad.size and (not foreign.size or bad[0] <= upd[foreign[0]]):
        raise ValueError("malformed update in stream")
    if foreign.size:
        raise ValueError(
            f"replay plan supports text streams only (GC/Deleted/"
            f"String); update carries content kind {int(kind[foreign[0]])}"
        )
    row = live & (length > 0)
    rows_per = np.bincount(upd[row], minlength=S)
    skip_gc = np.bincount(upd[(kind == BLOCK_SKIP) | (kind == BLOCK_GC)], minlength=S)
    steps = exact_steps(n_sections, n_blocks - skip_gc + n_zero, skip_gc, n_ds, n_dels, n_value)
    max_rows = int(rows_per.max(initial=0))

    # string rows in wire order: strip the varint length prefix of each
    # content span; one unit_byte entry per UTF-16 unit (both units of a
    # surrogate pair share the char start)
    arena, starts = walk.arena, (walk.offs[upd] + cols["content_start"])[row & (kind == CONTENT_STRING)].tolist()
    arena_parts: List[bytes] = []
    unit_byte: List[int] = []
    str_refs: List[int] = []
    total_bytes = 0
    for j in starts:
        blen, shift = 0, 0
        while True:
            b = arena[j]
            blen |= (b & 0x7F) << shift
            shift += 7
            j += 1
            if b < 0x80:
                break
        sbytes = arena[j : j + blen]
        str_refs.append(len(unit_byte))
        if sbytes.isascii():
            unit_byte.extend(range(total_bytes, total_bytes + len(sbytes)))
        else:
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
    U = max(1, max_rows)
    refs = np.full((S, U), -1, dtype=np.int32)
    row_upd = upd[row]
    slot = np.arange(row_upd.size) - (np.cumsum(rows_per) - rows_per)[row_upd]
    is_str = kind[row] == CONTENT_STRING
    refs[row_upd[is_str], slot[is_str]] = str_refs
    unit_byte.append(total_bytes)
    lens = np.fromiter((len(p) for p in payloads), dtype=np.int64, count=S)
    max_dels = int(n_dels.max(initial=0))
    max_len = int(lens.max(initial=0))
    max_steps = int(steps.max(initial=0))
    max_sections = int(n_sections.max(initial=0))
    max_client = int(client[live].max(initial=0))
    adds = (3 * rows_per + 2 * n_dels).astype(np.int32)
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

    def slice_values(self, ref: int, off: int, length: int) -> list:
        """The slice's characters (the arena holds text only)."""
        return list(self.slice_text(ref, off, length))


@dataclass
class ReplayStats:
    chunks: int = 0
    compactions: int = 0
    growths: int = 0
    capacity: int = 0
    peak_blocks: int = 0
    final_blocks: int = 0
    chunk_seconds: List[float] = field(default_factory=list)
    syncs: int = 0  # readout drains materialized on the host
    # overlap lane: staging seconds on the worker thread, seconds the
    # dispatch thread waited for staging, the share of staging hidden,
    # the most chunks staged ahead, and staging slots written again
    stage_s: float = 0.0
    stall_s: float = 0.0
    overlap_ratio: float = 0.0
    max_inflight: int = 0
    buffer_reuses: int = 0
    # overlap lane: "raw" ships concatenated bytes and an offsets table,
    # "packed" the host-packed [S, L] matrix; payload bytes staged; the
    # one-time wire-table build (not in stage_s)
    ingest: str = ""
    stage_bytes: int = 0
    prescan_s: float = 0.0
    # resilience: resumes after a fault, chunk-boundary checkpoints taken
    # (with their d2h seconds and bytes), update indices quarantined, and
    # the positions the replay resumed from
    recoveries: int = 0
    checkpoints: int = 0
    checkpoint_s: float = 0.0
    checkpoint_bytes: int = 0
    quarantined: List[int] = field(default_factory=list)
    resumes: List[int] = field(default_factory=list)
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
    launch_rows_read: int = 0
    launch_rows_added: int = 0


@dataclass
class _ReplayCheckpoint:
    """Chunk-boundary snapshot of the packed state: host numpy copies,
    which the next chunk's in-place integrate and compaction cannot
    reach."""

    cols: np.ndarray
    meta: np.ndarray
    pos: int  # first update not integrated
    hi: int  # actual occupancy at the snapshot (after a drain)


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




# --- host staging <-> device dispatch overlap ---------------------------------


@dataclass
class OverlapStats:
    """One overlap-loop run: staging and stall seconds, and depth."""

    staged: int = 0
    consumed: int = 0
    stage_s: float = 0.0  # worker thread: staging time
    stall_s: float = 0.0  # caller thread: time waited on staging
    max_depth: int = 0  # most staged chunks not yet consumed
    overlap_ratio: float = 0.0  # share of stage_s hidden behind dispatch


class OverlapPipeline:
    """Bounded producer/consumer loop shared by the replay's overlap lane
    and `UpdatePipeline`: a staging worker thread runs the host work of
    chunk k+1 while the caller thread dispatches chunk k to the device,
    so the wall clock approaches max(stage, dispatch) instead of their sum.

    `run(produce, consume)`: `produce` is an iterator driven on the worker
    thread (each `next()` is timed as staging) and `consume(item)` runs on
    the calling thread. The queue holds at most `depth` staged items. An
    exception on either side stops the other and re-raises on the caller.
    The end-of-stream sentinel is put with the same blocking, stop-checked
    loop as the items, so a slow consumer with a full queue is never
    stranded. (The JAX package's optional middle `drain` stage serves its
    encode pipeline only and is left out.)

    `overlap_ratio` = 1 - stall_s / stage_s, clamped to [0, 1]: 1 means all
    staging was hidden behind dispatch. stage_s includes the producer's
    own wait for a free slot, which happens only when the device side is
    the bottleneck (and then stall_s is about 0).

    Worker threads run host code only: the producers in this package make
    no CUDA call there, and all device work runs on the caller thread.
    """

    def __init__(self, depth: int = 2, stage_prefix: str = "replay"):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.depth = depth
        self.stage_prefix = stage_prefix
        self._stop = threading.Event()

    @property
    def stopping(self) -> bool:
        """True once the loop is tearing down: a producer blocked on a
        buffer slot that a dead consumer will never free polls this and
        returns."""
        return self._stop.is_set()

    def run(self, produce: Iterable, consume: Callable) -> OverlapStats:
        # fresh per run(): a stale set event would skip the worker's
        # sentinel put on reuse and strand the caller in q.get()
        self._stop = threading.Event()
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        SENTINEL = object()
        err: List[BaseException] = []
        stop = self._stop
        stats = OverlapStats()

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            from ytpu_torch.utils.faults import faults

            try:
                it = iter(produce)
                while not stop.is_set():
                    faults.maybe_raise("stage.raise", prefix=self.stage_prefix)
                    t0 = time.perf_counter()
                    try:
                        item = next(it)
                    except StopIteration:
                        return
                    stats.stage_s += time.perf_counter() - t0
                    stats.staged += 1
                    if not _put(item):
                        return
            except BaseException as e:  # re-raised on the caller
                err.append(e)
            finally:
                _put(SENTINEL)

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                stats.stall_s += time.perf_counter() - t0
                if item is SENTINEL or err:
                    # the staging thread died: abandon the staged backlog
                    # rather than integrate ahead of an error that voids
                    # the run
                    break
                # the queue cap bounds what is in flight at this boundary
                stats.max_depth = max(stats.max_depth, min(self.depth, q.qsize() + 1))
                consume(item)
                stats.consumed += 1
        finally:
            stop.set()
            while True:  # unblock a worker mid-put
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            thread.join()
        if err:
            raise err[0]
        if stats.stage_s > 0:
            stats.overlap_ratio = max(0.0, min(1.0, 1.0 - stats.stall_s / stats.stage_s))
        return stats


@dataclass(frozen=True)
class OverlapPlan:
    """The overlap lane's static staging plan."""

    depth: int  # most chunks in flight
    buffers: int  # preallocated staging slots
    n_chunks: int
    buffer_reuses: int  # times a slot is staged again after its first use


def plan_overlap(n_updates: int, chunk: int, depth: int = 2) -> OverlapPlan:
    """`depth` preallocated slots; every chunk beyond the first `depth`
    stages into a recycled slot."""
    n_chunks = max(0, -(-int(n_updates) // int(chunk)))
    return OverlapPlan(
        depth=depth,
        buffers=depth,
        n_chunks=n_chunks,
        buffer_reuses=max(0, n_chunks - depth),
    )


def _host_buffer(shape, dtype, pin: bool, fill: int = 0):
    """``(tensor, numpy view)`` of one CPU staging buffer, page-locked
    when `pin` (then its copy to the GPU runs asynchronously)."""
    t = torch.full(shape, fill, dtype=dtype, pin_memory=pin)
    return t, t.numpy()


class _StagingSlot:
    """One reusable staging buffer of the host-packed lane: the padded
    ``[S, L]`` wire bytes, their lengths and the chunk's global unit-ref
    rows. ``host`` holds the tensors the driver takes, ``buf`` / ``lens``
    / ``refs`` numpy views of them."""

    __slots__ = ("host", "buf", "lens", "refs", "pos", "end")

    def __init__(self, chunk: int, width: int, u: int, pin: bool = False):
        (tb, self.buf), (tl, self.lens), (tr, self.refs) = (
            _host_buffer((chunk, width), torch.uint8, pin),
            _host_buffer((chunk,), torch.int32, pin),
            _host_buffer((chunk, u), torch.int32, pin, -1),
        )
        self.host = (tb, tl, tr)
        self.pos = 0
        self.end = 0

    def stage(self, batch: List[bytes], pos: int, end: int, unit_refs: np.ndarray) -> int:
        """Pack updates ``pos:end`` (`batch`) into the slot; returns the
        payload bytes staged."""
        from ytpu_torch.ops.decode_kernel import pack_updates_into

        pack_updates_into(batch, self.buf, self.lens)
        _stage_refs(self, pos, end, unit_refs)
        return sum(len(p) for p in batch)


class _RawStagingSlot:
    """One reusable staging buffer of the raw ingest lane: the chunk's
    concatenated wire bytes, per-update offset and length tables and
    global unit-ref rows; staging into it is a memcpy
    (`pack_raw_updates_into`). ``host`` holds the tensors the driver takes,
    ``raw`` / ``offs`` / ``lens`` / ``refs`` numpy views of them."""

    __slots__ = ("host", "raw", "offs", "lens", "refs", "pos", "end")

    def __init__(self, raw_cap: int, chunk: int, u: int, pin: bool = False):
        (ta, self.raw), (to, self.offs), (tl, self.lens), (tr, self.refs) = (
            _host_buffer((raw_cap,), torch.uint8, pin),
            _host_buffer((chunk,), torch.int32, pin),
            _host_buffer((chunk,), torch.int32, pin),
            _host_buffer((chunk, u), torch.int32, pin, -1),
        )
        self.host = (ta, to, tl, tr)
        self.pos = 0
        self.end = 0

    def stage(self, wire, woffs, pos: int, end: int, unit_refs: np.ndarray, width: int) -> int:
        """Copy updates ``pos:end`` of the wire table into the slot; returns
        the bytes staged."""
        from ytpu_torch.ops.decode_kernel import pack_raw_updates_into

        n = pack_raw_updates_into(wire, woffs, pos, end, self.raw, self.offs, self.lens, width=width)
        _stage_refs(self, pos, end, unit_refs)
        return n


def _stage_refs(slot, pos: int, end: int, unit_refs: np.ndarray) -> None:
    """The chunk's global unit-ref rows (-1 past its end) and its range."""
    slot.refs[: end - pos] = unit_refs[pos:end]
    slot.refs[end - pos :] = -1
    slot.pos, slot.end = pos, end


class FusedReplay:
    """Chunked replay of one shared update stream over a doc batch
    (``device=None``: the GPU). Between chunks the driver
    (`integrate_kernel.PackedReplayDriver`) compacts or grows the packed
    state under the `CompactionPolicy`.

    ``overlap=False`` (the serial lane): per chunk the host packs the
    ``[S, L]`` lane matrix (`pack_updates`), the device decodes it, the
    host reads the decode flags (a blocking check that names flagged
    updates) and the driver integrates the stream; ``sync_per_chunk``
    drains the readout after every chunk.

    ``overlap=True``: a staging thread fills chunk k+1 into one of `depth`
    reusable page-locked slots while the device runs chunk k as one chunk
    program; readouts stay on the device until a watermark drain or
    `finish()`, and a decode error surfaces there, the offending updates
    found again on the host for the serial lane's message. Under
    ``ingest="raw"`` staging is a memcpy of the wire bytes and the decode
    reads the arena in place (`replay_chunk_program_raw`); under
    ``"packed"`` the host packs the lane matrix (`replay_chunk_program`).
    A slot is staged again only after the copies of its last chunk have
    read it (`ChunkUpload.wait`).

    Resilience: ``checkpoint_every`` > 0 copies the packed state to the
    host every N chunks (a blocking pull); a `ReplayFault` or injected
    fault resumes from the last checkpoint, or from the initial state, at
    most ``max_recoveries`` times. ``quarantine=True`` records updates the
    decode flags (they integrate as no-ops) instead of raising."""

    def __init__(
        self,
        n_docs: int,
        plan: ReplayPlan,
        capacity: int = 4096,
        max_capacity: int = 1 << 17,
        chunk: int = 8192,
        policy=None,
        sync_per_chunk: bool = True,
        overlap: bool = False,
        ingest: str = "raw",
        depth: int = 2,
        checkpoint_every: int = 0,
        quarantine: bool = False,
        max_recoveries: int = 3,
        device=None,
    ):
        from ytpu_torch.models.batch_doc import init_state
        from ytpu_torch.ops.integrate_kernel import pack_state

        if ingest not in ("raw", "packed"):
            raise ValueError(f"ingest must be 'raw' or 'packed', got {ingest!r}")
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.device = resolve_device(device)
        self.plan = plan
        self.n_docs = n_docs
        self.chunk = chunk
        self.max_capacity = max_capacity
        self.policy = policy
        self.sync_per_chunk = sync_per_chunk
        self.overlap = overlap
        self.ingest = ingest
        self.depth = depth
        self.checkpoint_every = checkpoint_every
        self.quarantine = quarantine
        self.max_recoveries = max_recoveries
        self.capacity0 = capacity
        self.cols, self.meta = pack_state(init_state(n_docs, capacity, self.device))
        self.stats = ReplayStats(capacity=capacity)
        self._hi = 0  # occupancy carried across run()/compact()
        # chunk ranges dispatched through the overlap lane, for finding
        # flagged updates again (the sticky flags name none)
        self._dispatched_ranges: List[Tuple[int, int]] = []
        self._ckpt: Optional[_ReplayCheckpoint] = None
        self._corrupted: dict = {}  # idx -> injected corrupt wire bytes
        self._qset: set = set()  # quarantined update indices
        self._recoveries_used = 0
        self._needs_restore = False
        self._base_hi = 0  # occupancy carried into the current run()
        self._driver = None  # the driver of the run in progress
        self.driver = None  # the last driver made

    def _make_driver(self, rank):
        from ytpu_torch.ops.integrate_kernel import PackedReplayDriver

        self.driver = PackedReplayDriver(
            self.cols,
            self.meta,
            rank,
            policy=self.policy,
            unit_refs=True,
            gc_ranges=True,
            max_capacity=self.max_capacity,
            # the overlap lane keeps readouts on the device
            sync_every_chunk=self.sync_per_chunk and not self.overlap,
            initial_occupancy=self._hi,
            quarantine=self.quarantine,
        )
        return self.driver

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

    def dims(self):
        p = self.plan
        return (p.max_rows, p.max_dels, p.max_steps, p.max_sections)

    def stage_chunks(self, payloads: List[bytes]):
        """Yield one `_RawStagingSlot` per chunk (the same slot, restaged)."""
        plan = self.plan
        wire, woffs = build_wire_table(payloads)
        slot = _RawStagingSlot(raw_chunk_cap(woffs, self.chunk), self.chunk, plan.unit_refs.shape[1])
        for pos in range(0, len(payloads), self.chunk):
            end = min(pos + self.chunk, len(payloads))
            slot.stage(wire, woffs, pos, end, plan.unit_refs, plan.max_len + 16)
            yield slot

    def run(self, payloads: List[bytes], client_rank=None) -> ReplayStats:
        """Replay `payloads`, resuming after a mid-replay fault from the
        last chunk-boundary checkpoint (or the initial state)."""
        from ytpu_torch.ops.integrate_kernel import ReplayFault
        from ytpu_torch.utils.faults import FaultError

        client_rank = self._resolve_rank(client_rank)
        self._recoveries_used = 0
        # checkpoint positions and corrupt-byte records index this call's
        # payloads: nothing carries over from an earlier run()
        self._ckpt = None
        self._corrupted.clear()
        self._qset.clear()
        self._base_hi = self._hi
        if self._hi and self.checkpoint_every:
            # a continuation replay: snapshot the entry state, so a fault
            # before the first checkpoint cannot reset to empty
            self._checkpoint_now(pos=0)
        while True:
            try:
                if self.overlap:
                    return self._run_overlap(payloads, client_rank)
                return self._run_serial(payloads, client_rank)
            except (ReplayFault, FaultError) as e:
                self._recover(e)

    def _decode(self, buf: np.ndarray, lens: np.ndarray):
        """`decode_updates_v1` of a host-packed lane matrix on the replay's
        device; returns ``(stream, flags)``."""
        from ytpu_torch.ops.decode_kernel import decode_updates_v1

        p = self.plan
        return decode_updates_v1(
            torch.from_numpy(buf).to(self.device), torch.from_numpy(lens).to(self.device),
            max_rows=p.max_rows, max_dels=p.max_dels, n_steps=p.max_steps,
            max_sections=p.max_sections,
        )

    def _packed_batch(self, batch: List[bytes]):
        """The host-packed ``[chunk, L]`` lane matrix of `batch`, padded
        with `EMPTY_UPDATE` lanes."""
        from ytpu_torch.ops.decode_kernel import EMPTY_UPDATE, pack_updates

        if len(batch) < self.chunk:
            batch = batch + [EMPTY_UPDATE] * (self.chunk - len(batch))
        return pack_updates(batch, pad_to=self.plan.max_len + 16)

    def _run_serial(self, payloads: List[bytes], client_rank) -> ReplayStats:
        from ytpu_torch.ops.decode_kernel import FLAG_ERRORS

        plan = self.plan
        start = self._restore_state()
        driver = self._driver = self._make_driver(client_rank)
        S = len(payloads)
        pos = start
        while pos < S:
            t0 = time.perf_counter()
            end = min(pos + self.chunk, S)
            buf, lens = self._packed_batch(self._stage_batch(payloads, pos, end))
            with torch.profiler.record_function("ytpu_torch.decode"):
                stream, flags = self._decode(buf, lens)
                refs = np.full((self.chunk, plan.unit_refs.shape[1]), -1, dtype=np.int32)
                refs[: end - pos] = plan.unit_refs[pos:end]
                refs_t = torch.from_numpy(refs).to(self.device)
                stream = stream._replace(
                    content_ref=torch.where(refs_t >= 0, refs_t, stream.content_ref)
                )
            f = flags[: end - pos].cpu().numpy() & FLAG_ERRORS
            if f.any():
                bad = np.nonzero(f)[0]
                if self.quarantine:
                    # the decode cleared the flagged lanes' valid masks, so
                    # they integrate as no-ops: record them and go on
                    self._note_quarantined([int(pos + b) for b in bad], count_metric=True)
                else:
                    raise RuntimeError(
                        f"device decode flagged updates "
                        f"{(pos + bad[:8]).tolist()}: "
                        f"flags {f[bad[:8]].tolist()}"
                    )
            # the chunk's worst-case growth: the driver compacts or grows
            # before integrating, so ERR_CAPACITY cannot fire mid-chunk
            driver.step(stream, margin=int(plan.adds[pos:end].sum()) + 8)
            self.cols, self.meta = driver.cols, driver.meta
            self.stats.chunk_seconds.append(time.perf_counter() - t0)
            pos = end
            self._maybe_checkpoint(driver, pos)
        self.cols, self.meta = driver.finish()
        self._merge_driver_stats(driver)
        self._driver = None
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
        if d.scan_hist:
            st.scan_hist = d.scan_hist
            st.scan_max = d.scan_max
            st.scan_p50 = d.scan_p50
            st.scan_p99 = d.scan_p99
            st.scan_tier_cheap = d.scan_tier_cheap
            st.scan_tier_wide = d.scan_tier_wide
            st.scan_trips_serial = d.scan_trips_serial
            st.scan_trips_two_tier = d.scan_trips_two_tier
        st.commit_word = d.commit_word
        st.occupied_rows = d.occupied_rows
        st.dead_rows = d.dead_rows
        st.dead_max = d.dead_max
        st.reclaimed_rows += d.reclaimed_rows
        st.compact_gap_chunks = d.compact_gap_chunks
        st.launch_rows_read += d.launch_rows_read
        st.launch_rows_added += d.launch_rows_added
        self._hi = d.final_blocks

    # --- fault recovery ----------------------------------------------------------

    def _recover(self, e: BaseException) -> None:
        """Roll back to the last chunk-boundary checkpoint (or the initial
        state) for the next attempt, or re-raise `e` when the recovery
        budget is spent or a continuation replay has no checkpoint."""
        from ytpu_torch.utils.metrics import metrics

        if self._driver is not None:
            self._merge_driver_stats(self._driver)
            self._driver = None
        self._recoveries_used += 1
        if self._recoveries_used > self.max_recoveries:
            raise e
        if self._ckpt is None and self._base_hi:
            # a continuation replay with no checkpoint: rebuilding an empty
            # state would silently drop what earlier runs integrated
            raise e
        self.stats.recoveries += 1
        metrics.counter("replay.recoveries").inc()
        self._needs_restore = True
        self.stats.resumes.append(self._ckpt.pos if self._ckpt else 0)

    def _restore_state(self) -> int:
        """(Re)build the packed state for a new driver attempt; returns the
        update index to resume from."""
        if not self._needs_restore:
            return 0
        from ytpu_torch.models.batch_doc import init_state
        from ytpu_torch.ops.integrate_kernel import pack_state

        self._needs_restore = False
        ck = self._ckpt
        if ck is None:
            self.cols, self.meta = pack_state(init_state(self.n_docs, self.capacity0, self.device))
            self._hi = 0
            return 0
        # torch.tensor copies: the next chunk writes cols in place, and a
        # second resume must find the snapshot intact
        self.cols = torch.tensor(ck.cols, device=self.device)
        self.meta = torch.tensor(ck.meta, device=self.device)
        self._hi = ck.hi
        return ck.pos

    def _checkpoint_now(self, pos: int, driver=None) -> None:
        """Snapshot the packed state as host copies. With a driver, drain
        its readouts first, so errors and quarantine surface before the
        snapshot is trusted; without one, snapshot the carried state (the
        entry snapshot of a continuation replay)."""
        t0 = time.perf_counter()
        if driver is not None:
            hi = driver._drain_readouts()
            cols, meta = driver.cols, driver.meta
        else:
            hi, cols, meta = self._hi, self.cols, self.meta
        # copy=True: on the CPU .cpu() would alias the state
        cols_np = cols.to("cpu", copy=True).numpy()
        meta_np = meta.to("cpu", copy=True).numpy()
        self._ckpt = _ReplayCheckpoint(cols=cols_np, meta=meta_np, pos=pos, hi=hi)
        self.stats.checkpoints += 1
        self.stats.checkpoint_s += time.perf_counter() - t0
        self.stats.checkpoint_bytes += cols_np.nbytes + meta_np.nbytes

    def _maybe_checkpoint(self, driver, pos: int) -> None:
        if not self.checkpoint_every or driver.stats.chunks % self.checkpoint_every:
            return
        self._checkpoint_now(pos, driver=driver)

    def _stage_batch(self, payloads: List[bytes], pos: int, end: int):
        """One chunk's wire payloads, through the ``update.corrupt`` fault
        site. Injected corruption is remembered per index, so finding
        flagged updates again and re-running from a checkpoint see the
        bytes the device integrated."""
        from ytpu_torch.utils.faults import faults

        if not faults.active and not self._corrupted:
            return payloads[pos:end]
        batch = list(payloads[pos:end])
        for i in range(len(batch)):
            idx = pos + i
            prev = self._corrupted.get(idx)
            if prev is not None:
                batch[i] = prev
                continue
            if faults.active:
                c = faults.corrupt("update.corrupt", batch[i])
                if c is not batch[i]:
                    self._corrupted[idx] = c
                    batch[i] = c
        return batch

    def _note_quarantined(self, idxs: List[int], count_metric: bool):
        newly = [i for i in idxs if i not in self._qset]
        self._qset.update(newly)
        self.stats.quarantined.extend(newly)
        if newly and count_metric:
            from ytpu_torch.utils.metrics import metrics

            metrics.counter("replay.quarantined").inc(len(newly))
        return newly

    def _flagged_chunks(self, payloads: List[bytes]):
        """Decode the dispatched chunk ranges again from the bytes the
        device saw (injected corruption included) and yield ``(pos,
        bad_offsets, flags)`` for every chunk with a flagged lane."""
        from ytpu_torch.ops.decode_kernel import FLAG_ERRORS

        for pos, end in self._dispatched_ranges:
            batch = [self._corrupted.get(i, payloads[i]) for i in range(pos, end)]
            _, flags = self._decode(*self._packed_batch(batch))
            f = flags[: end - pos].cpu().numpy() & FLAG_ERRORS
            if f.any():
                yield pos, np.nonzero(f)[0], f

    def _quarantine_collect(self, payloads: List[bytes], flags_or: int):
        """The driver's quarantine hook (overlap lane): record every newly
        flagged update index; the driver counts the metric."""
        idxs = [int(pos + b) for pos, bad, _ in self._flagged_chunks(payloads) for b in bad]
        self._dispatched_ranges.clear()
        return self._note_quarantined(idxs, count_metric=False)

    # --- the overlap lane ------------------------------------------------------

    def overlap_plan(self, n_updates: Optional[int] = None) -> OverlapPlan:
        """The static staging plan of the overlap lane."""
        return plan_overlap(
            self.plan.n_updates if n_updates is None else n_updates,
            self.chunk,
            depth=self.depth,
        )

    def _build_wire(self, payloads: List[bytes]):
        """The raw lane's wire table of this run's payloads. With
        corruption armed (or injected on an earlier attempt) it is built
        from the corrupted batch: the ``update.corrupt`` site fires here
        once per update, in stream order, as the packed staging does."""
        from ytpu_torch.utils.faults import faults

        t0 = time.perf_counter()
        if faults.active or self._corrupted:
            batch = self._stage_batch(payloads, 0, len(payloads))
        else:
            batch = payloads
        wire, offsets = build_wire_table(batch)
        self.stats.prescan_s += time.perf_counter() - t0
        return wire, offsets

    def _run_overlap(self, payloads: List[bytes], client_rank) -> ReplayStats:
        plan = self.plan
        S = len(payloads)
        chunk = self.chunk
        width = plan.max_len + 16  # the serial lane's pad_to
        dims = self.dims()
        use_raw = self.ingest == "raw"
        start = self._restore_state()
        driver = self._driver = self._make_driver(client_rank)
        self._dispatched_ranges = []
        driver.on_decode_error = partial(self._reidentify_decode_error, payloads)
        driver.on_quarantine = partial(self._quarantine_collect, payloads)
        oplan = self.overlap_plan(S)
        pipe = OverlapPipeline(depth=oplan.depth, stage_prefix="replay")
        # page-locked slots on the GPU: their copies run asynchronously
        pin = self.device.type == "cuda"
        u = plan.unit_refs.shape[1]
        if use_raw:
            wire, woffs = self._build_wire(payloads)
            cap = raw_chunk_cap(woffs, chunk)
            slots = [_RawStagingSlot(cap, chunk, u, pin) for _ in range(oplan.buffers)]
        else:
            slots = [_StagingSlot(chunk, width, u, pin) for _ in range(oplan.buffers)]
        free_q: "queue.Queue" = queue.Queue()
        for s in slots:
            free_q.put(s)
        inflight: deque = deque()
        acquisitions = 0
        staged_bytes = 0

        def produce():
            # numpy only: this runs on the staging thread
            nonlocal acquisitions, staged_bytes
            for pos in range(start, S, chunk):
                while True:
                    try:
                        slot = free_q.get(timeout=0.1)
                        break
                    except queue.Empty:
                        # a dead consumer never frees slots
                        if pipe.stopping:
                            return
                end = min(pos + chunk, S)
                if use_raw:
                    staged_bytes += slot.stage(wire, woffs, pos, end, plan.unit_refs, width)
                else:
                    staged_bytes += slot.stage(self._stage_batch(payloads, pos, end), pos, end, plan.unit_refs)
                acquisitions += 1
                yield slot

        def consume(slot):
            t0 = time.perf_counter()
            margin = int(plan.adds[slot.pos : slot.end].sum()) + 8
            if use_raw:
                raw, offs, lens, refs = slot.host
                upload = driver.step_raw(raw, offs, lens, refs, dims, width, margin=margin)
            else:
                upload = driver.step_bytes(*slot.host, dims, margin=margin)
            self._dispatched_ranges.append((slot.pos, slot.end))
            self.cols, self.meta = driver.cols, driver.meta
            inflight.append((slot, upload))
            if len(inflight) >= oplan.depth:
                # a slot is staged again only after its copies have read it
                old_slot, old = inflight.popleft()
                old.wait()
                free_q.put(old_slot)
            self.stats.chunk_seconds.append(time.perf_counter() - t0)
            self._maybe_checkpoint(driver, slot.end)

        ostats = pipe.run(produce(), consume)
        while inflight:
            slot, upload = inflight.popleft()
            upload.wait()
            free_q.put(slot)
        self.cols, self.meta = driver.finish()
        self._merge_driver_stats(driver)
        self._driver = None
        self.stats.stage_s += ostats.stage_s
        self.stats.stall_s += ostats.stall_s
        self.stats.overlap_ratio = ostats.overlap_ratio
        self.stats.max_inflight = max(self.stats.max_inflight, ostats.max_depth)
        self.stats.buffer_reuses += max(0, acquisitions - len(slots))
        self.stats.ingest = "raw" if use_raw else "packed"
        self.stats.stage_bytes += staged_bytes
        return self.stats

    def _reidentify_decode_error(self, payloads: List[bytes], flags_or: int):
        """The deferred decode error: the sticky flags say some chunk since
        the driver started held flagged lanes; decode the dispatched ranges
        again and raise the serial lane's message for the first."""
        for pos, bad, f in self._flagged_chunks(payloads):
            raise RuntimeError(
                f"device decode flagged updates "
                f"{(pos + bad[:8]).tolist()}: flags {f[bad[:8]].tolist()}"
            )
        raise RuntimeError(
            f"device decode flagged errors (sticky flags {flags_or}) but "
            "the host re-scan found none — payloads mutated mid-replay?"
        )

    def compact(self) -> int:
        """Force a compaction; returns the high-water block count after it."""
        from ytpu_torch.ops.compaction import compact_packed
        from ytpu_torch.ops.integrate_kernel import M_NBLOCKS

        self.cols, self.meta = compact_packed(self.cols, self.meta, True, True)
        self.stats.compactions += 1
        self._hi = int(self.meta[:, M_NBLOCKS].max())
        return self._hi

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
