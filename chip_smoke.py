"""GPU smoke run of the port: build the CUDA kernels and the host C++
library, hold each against its plain version, and replay the full B4 wire
log through the port's main path.

Usage (on a machine with one NVIDIA GPU and the CUDA toolkit):

    python3 chip_smoke.py

Phases, one JSON line each: ``build`` (the five CUDA libraries, one nvcc
each, and the host library ``native``, g++, all in parallel; the
integrate kernel must use no stack frame and no
spills, the column put, the map put, rungs 1, 3, 4 and 5 and v_multi's
sized copy must issue their loads before their first store and use no
local memory, v_body's one-pass kernel must use no local memory),
``native`` (the host C++ column walk against the Python walk
`update_columns`, every count and column, on the whole B4 log in one call
and on the ingest phase's 512 steps in one call each; host µs per update
of both),
``decode`` (the decode program against the plain composition
`gather_raw_lanes` -> plain loop -> `_resolve_and_pack`, every UpdateBatch
field and the flags equal, on one B4 chunk of 8,192 lanes from its arena,
one ingest step's fast lanes from their arena with their intern tables
and four merged whole-state lanes from their matrix, each also from the
other layout and without its tables; the sync server's round 5 is held
the same way inside its phase; the kernel must use no stack frame and no
spills),
``kernel_vs_plain`` (small
cases: B4 chunks, synthetic streams at three scan plans and a capacity
cut, 8 clients typing, clients above the client-clock table, a
misaligned stream view that must raise),
``integrate_profile`` (cycles per step per phase of the profiling build
on one late B4 chunk), ``kernel_vs_plain_full_width`` (that chunk at the
main path's capacity and chunk size), ``b4_replay`` (`FusedReplay.run`
on the main path's lane, overlap with raw ingest at depth 2, over the
whole log at 256 docs; the serial lane beside it, its cols and meta
equal bit for bit; then the overlap run under `torch.profiler`),
``replay_lanes`` (raw ingest at depths 1 and 3 and host-packed ingest
at depth 2, each ending in the main run's state bit for bit; checkpoints
every 8 chunks with a ``replay.kill`` at chunk 20, resumed from a
checkpoint to the same state; a corrupted last update quarantined on
the raw and packed lanes, the text that of a healthy replay without it,
and raising the serial lane's message without quarantine),
``sync_step`` (the write path: one
`apply_update_batch` per step through the integrate kernel's per-doc
entry at 1,024 docs x 8,192 slots over the first 2,048 B4 updates, each
doc lagging by (doc mod 8) x 64 updates, held against stream replays of
each prefix, with the per-doc kernel's profile (phase 1 against phase 2,
its scratch sized from each doc's live rows and, as before, for C), the
bytes its phase 1 clears and its launch floor; the per-doc kernel against
its plain version, on synthetic streams and on edge cases; the read path
at BASELINE config 5's width, 10,240 docs x 64 clients, the rows' refs
rebased onto one wire chunk as the batch ingestor keeps them:
`state_vectors`, `encode_diff_batch`, the native finisher and
`DiffPipeline`, both against the Python finisher on every doc with no doc
left to it, a sample also against the CPU finisher; and
`encode_diff_batch` on the B4 replay's final state), ``ingest`` (one `BatchIngestor` at 1,024 docs x 8,192 slots, one
`apply_bytes` call per step over 512 steps of four tenant cohorts: B4 text
with per-doc lags and, in one doc of eight, swapped update pairs; BASELINE
config 4's map + XML tenant; config 3's 256-client array; a 53-bit
client's text; their values held against stream replays and the committed
logs' values, no error, no stash, no recovery; 16 calls under
`torch.profiler`; the per-doc kernel against its plain version on one
step's captured inputs with anchor, map and big-client rows),
``sync_server`` (one device-authoritative `DeviceSyncServer` at 1,024
tenants x 8,192 slots, the ingest phase's cohorts, a writer and a reader
session each: 32 write rounds of Update frames, each followed by one
`flush_device` step, then each log's rest as one SyncStep2 frame; the
readers' SyncStep1s, even tenants with an empty state vector, odd ones
with the middle round's; one `device_encode_diff_many` over every tenant;
greetings, drained broadcasts, texts, values and every reply held to the
device state vectors, the writers' frames, stream replays, the committed
logs and the CPU finisher; a fresh server caught up from the fan-out
(then a second one, its flush under `torch.profiler`); rebalances; 8 flush
steps, 8 replies and the rest's flush under `torch.profiler`; the
per-doc kernel against its plain version on one round's captured inputs),
``sync_server_mirrored`` (the same plan through one `DeviceSyncServer` in
its default, mirrored mode: a host `Doc` per tenant answers the protocol
and its update observer queues each transaction's update to the tenant's
slot; every host doc against its committed value and the B4 stream
replays, the device against every host doc (state vector, rendered value,
the fan-out applied to a fresh `Doc`), greetings and SyncStep1 replies
from the host docs, the readers' outboxes against what the host docs
sent, 8 tenants released to their host docs while late tenants take the
freed slots, 8 rebalances in place, a checkpoint round trip; the per-doc
and decode kernels against their plain versions on round 5's inputs),
``pipeline_checkpoint`` (`UpdatePipeline` on both lanes over the first
8,192 B4 updates at 1,024 docs x 8,192 slots, its texts equal to
`FusedReplay`'s; the ingest phase's ingestor saved, loaded and run 64
more steps beside the unbroken one, both ending equal; the sync-server
phase's server saved and loaded, its greetings carrying the same state
vectors; seconds and bytes on disk of both),
``stream_replay_full_width`` (the whole log decoded
into one stream and replayed through `replay_stream_fused` at 256 docs;
the decode call's kernels read from a CUDA graph of it; the replay again
under `torch.profiler` for the time of each launch, then the
kernel against its plain version on one late window at the grown
capacity),
``decode_v2`` (the whole log transcoded to V2 by the port's codec; the V2
decode kernel against its plain composition, every UpdateBatch field and
flag of every lane, from the matrix and from the arena read in place, with
the intern tables and without, on the crafted sets of
``ytpu_torch/benches/data/v2_cases.json``, one B4 chunk of 8,192 lanes and
merged B4 prefixes past the kernel's shared-memory budget, each entry
point one launch a call (its count and a CUDA graph of one node), with
device ms from a CUDA graph; the whole V2 log decoded by one
`decode_updates_v2` call and one `decode_updates_v2_raw` call, no lane
flagged, and replayed through `replay_stream_fused` at 256 docs to the
log's text; `BatchIngestor.apply(v2=True)` over 32 steps of the ingest
phase's cohorts equal to `apply` of their V1 bytes, cols and meta, after
every step; the kernel's registers, spills and shared memory),
``observability`` (the main path's B4 replay again with the phase
recorder and the tracer on inside one request trace context: the JAX
package's replay stages, a stage-slot and a dispatch-slot span a chunk
naming the trace id, the same readout syncs as untraced; then, in a child
process ``python3 chip_smoke.py --observability-server OUT``, the default
mirrored sync server at 1,024 tenants x 8,192 slots over 8 write rounds
with the telemetry plane on port 0, an admission controller that defers
part of each round and a thread scraping its six endpoints every ~100 ms,
against the same plan without the planes: every scrape answered,
``/healthz`` "never" until the first flush, Busy replies counted in
``sync.busy_replies``, every tenant's value the same), ``mosaic_ladder``
(rungs 0-10), ``plane_rmw`` (the three repros), ``diag_kernels`` (each
diagnostic kernel against its plain version, then timed beside its
library call in the same mode and beside an empty kernel at its grid, the
launch floor; the column puts a, a2, g3d and g2d also in place on a live
slot and at the main path's width, v_vmem and v_body at that width, rungs
1, 3, 4 and 5 at ``[256, 65,536]``, rung 1 beside ``torch.add(x, 1)``, the
others beside ``fill_``); then
the card's name and power limit, the ``kernels`` line and, last,
``{"ok": true, "device": {...}}``; before them ``decode_timing`` (the
decode kernel's device ms on each set of its phase, from CUDA graphs
captured after every traced phase) and a ``total`` line with the
script's seconds against its 1,200 s limit. Launch counts are set to 0
just before each program runs and read just after it: the decode
kernel's on the B4 replay (one a chunk), each run of `replay_lanes` and
`pipeline_checkpoint`, the stream replay's one decode call, the ingest
and both sync-server phases' calls and rungs 8-10, and the V2 decode kernel's on the
V2 stream's one decode call. Any failure exits
non-zero without the last line. The traced B4 replay, ingest and sync
server phases check that each `decode_updates_v1` call is one device
kernel, ``decode_v1_kernel``, inside its span ``ytpu_torch.decode.v1``;
the stream replay phase checks its call's one kernel in a CUDA graph of
the call (`_graph_launches`).
It imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import bisect
import gzip
import json
import os
import pickle
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
B4_LOG = os.path.join(HERE, "benches", "data", "b4_log.pkl.gz")

# the flagship envelope of bench.py: 256 docs at a fixed capacity (growth
# off), chunks of 8,192 updates, the whole log
N_DOCS = 256
CAPACITY = 1 << 16
CHUNK = 8192
# the full-width comparison integrates this chunk (the last full one)
LATE_CHUNK = 30

# the stream replay's byte refs keep rows of different updates apart, so
# its state may grow past CAPACITY up to this many slots
STREAM_MAX_CAPACITY = 1 << 18

# card peak used for the bound (H100 SXM data sheet): HBM3 bytes per second
HBM_BYTES_PER_S = 3.35e12
INTEGRATE_REPLACES = "ytpu/ops/integrate_kernel.py:1057"
# the main path's lane of `FusedReplay`
MAIN_LANE = {"overlap": True, "ingest": "raw", "depth": 2}
KERNEL_KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
               "bound_ms", "bound_by", "library_ms")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# --- phases ---------------------------------------------------------------------------


def _ptxas(log: str, kernel: str) -> dict:
    """Registers, stack frame, spills and shared memory of `kernel` from a
    ``-Xptxas -v`` build log."""
    import re

    out, inside = {}, False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            inside = kernel in line
        elif inside:
            for key, pat in (("stack_frame_bytes", r"(\d+) bytes stack frame"),
                             ("spill_store_bytes", r"(\d+) bytes spill stores"),
                             ("spill_load_bytes", r"(\d+) bytes spill loads"),
                             ("registers", r"Used (\d+) registers"),
                             ("static_smem_bytes", r"(\d+) bytes smem")):
                m = re.search(pat, line)
                if m:
                    out[key] = int(m.group(1))
    if "registers" not in out or "stack_frame_bytes" not in out:
        raise RuntimeError(f"no ptxas report for {kernel} in the build log")
    return out


def _sass_summary(lib_path: str, kernel: str) -> dict:
    """Per instantiation of `kernel` in a built library, from ``cuobjdump
    -sass``: its global loads and stores, how many loads come before the
    first store, and its local-memory instructions (a spill or a stack
    array)."""
    import re

    from ytpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    out = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {out.stderr.strip()[:500]}")
    summary, fn = {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = summary[m.group(1)] = {"ldg": 0, "stg": 0, "ldg_before_first_stg": None, "local": 0} \
                if kernel in m.group(1) else None
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
        if fn is None or m is None:
            continue
        op = m.group(1)
        if op == "LDG":
            fn["ldg"] += 1
        elif op == "STG":
            if fn["stg"] == 0:
                fn["ldg_before_first_stg"] = fn["ldg"]
            fn["stg"] += 1
        elif op in ("LDL", "STL"):
            fn["local"] += 1
    return {k: v for k, v in summary.items() if v is not None}


def phase_build(gpu):
    """Every library, one nvcc each in parallel; the ptxas report of the
    integrate kernels (the stream entry's, and the per-doc entry's index
    and integrate kernels) must show no stack frame and no spills, every
    instantiation of the column put, of the map put (rungs 0 and 7), of
    rung 1's row put, rung 3's carry put, rung 4's scan put and rung 5's
    sum put and of v_multi's sized copy must issue all its loads before its
    first store and use no local memory, and v_body's one-pass kernel must
    use no local memory (`_sass_summary`)."""
    from ytpu_torch import native
    from ytpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    # load each library now, so that no timed launch pays for the dlopen;
    # the host library through its binding, which checks FinishIn's size
    for name in libs:
        _build.load(name)
    native.load()
    host = {name: {"compiler": "g++", "flags": _build.GXX_FLAGS, "sources": list(srcs),
                   "library": os.path.relpath(libs[name], HERE)} for name, srcs in _build.HOST_SOURCES.items()}
    ptxas = {name: _ptxas(_build.build_log(name), "integrate_kernel")
             for name in ("integrate", "integrate_profile")}
    ptxas["integrate_batch"] = _ptxas(_build.build_log("integrate"), "integrate_batch_kernel")
    ptxas["integrate_batch_index"] = _ptxas(_build.build_log("integrate"), "integrate_batch_index_kernel")
    sass = {"column_put_sass": _sass_summary(libs["plane_rmw"], "column_put"),
            "map_put_sass": _sass_summary(libs["mosaic_ladder"], "map_put"),
            "row_put_sass": _sass_summary(libs["mosaic_ladder"], "row_put"),
            "carry_put_sass": _sass_summary(libs["mosaic_ladder"], "carry_put"),
            "scan_put_sass": _sass_summary(libs["mosaic_ladder"], "scan_put"),
            "sum_put_sass": _sass_summary(libs["mosaic_ladder"], "sum_put")}
    copy_sass = _sass_summary(libs["plane_rmw"], "sized_copy")
    body_sass = _sass_summary(libs["plane_rmw"], "client_clock_pass")
    multi = {**copy_sass, **body_sass}
    emit({"phase": "build", "seconds": build_s, "load_seconds": time.perf_counter() - t0 - build_s,
          "libraries": sorted(libs), "host_libraries": host, "integrate_ptxas": ptxas, **sass,
          "multi_call_sass": multi, "gpu": gpu})
    for name in ("integrate", "integrate_batch", "integrate_batch_index"):
        k = ptxas[name]
        if k["stack_frame_bytes"] or k["spill_store_bytes"] or k["spill_load_bytes"]:
            raise RuntimeError(f"{name} kernel uses local memory: {k}")
    # the column put's streaming copy, the map put and rungs 1, 3, 4 and 5
    # issue every load before their first store and keep their values in
    # registers
    for name, summary in sass.items():
        if not summary or any(f["local"] or f["ldg_before_first_stg"] != f["ldg"] for f in summary.values()):
            raise RuntimeError(f"{name}: a kernel stores before its last load or uses local memory: {summary}")
    # v_multi's copy likewise; v_body's pass loops over tiles, so only its
    # local memory is checked
    if not copy_sass or not body_sass or any(f["local"] for f in multi.values()) or any(
            f["ldg_before_first_stg"] != f["ldg"] for f in copy_sass.values()):
        raise RuntimeError(f"multi_call_sass: v_multi's copy stores before its last load, or a multi call "
                           f"kernel uses local memory: {multi}")
    return ptxas


# --- the host C++ column walk ------------------------------------------------------

NATIVE_CHECK_CHUNK = 8192  # updates held against the Python walk at a time


def _walk_vs_python(calls):
    """`calls`: lists of payloads, one native batch walk each (as its
    caller makes it). Every count and column of every update against the
    Python walk `update_columns`, in chunks of NATIVE_CHECK_CHUNK updates;
    host-clock seconds of the native calls, of making each update's
    `UpdateColumns` view, and of the Python walk."""
    import numpy as np

    from ytpu_torch import native
    from ytpu_torch.encoding.lib0 import BLOCK_COLUMNS, DEL_COLUMNS, update_columns

    t0 = time.perf_counter()
    batches = [native.decode_update_columns_batch(c) for c in calls]
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for b in batches:
        for cols in b:
            pass
    views_s = time.perf_counter() - t0
    python_s, bad, errors = 0.0, [], 0
    for k, b in enumerate(batches):
        errors += int(b.counts[:, 7].sum())
        for lo in range(0, len(b), NATIVE_CHECK_CHUNK):
            hi = min(lo + NATIVE_CHECK_CHUNK, len(b))
            t0 = time.perf_counter()
            walked = [update_columns(p) for p in b.payloads[lo:hi]]
            python_s += time.perf_counter() - t0
            counts = np.array([[int(getattr(c, n)) for n in native.COUNT_NAMES] for c in walked], dtype=np.uint64)
            if not np.array_equal(counts, b.counts[lo:hi]):
                bad.append((k, lo, "counts"))
            for rows, off, names in ((b.blocks, b.block_off, BLOCK_COLUMNS), (b.dels, b.del_off, DEL_COLUMNS)):
                for j, name in enumerate(names):
                    want = np.concatenate([getattr(c, name) for c in walked])
                    if not np.array_equal(rows[j, off[lo]:off[hi]], want):
                        bad.append((k, lo, name))
    n = sum(len(c) for c in calls)
    if bad or errors:
        raise RuntimeError(f"native: the column walk differs from update_columns at {bad[:8]} "
                           f"(call, first update, column); {errors} updates flagged as malformed")
    return {"calls": len(calls), "updates": n, "bytes": sum(len(p) for c in calls for p in c),
            "blocks": sum(b.blocks.shape[1] for b in batches), "native_s": native_s,
            "native_us_per_update": native_s / n * 1e6, "views_us_per_update": views_s / n * 1e6,
            "python_s": python_s, "python_us_per_update": python_s / n * 1e6, "columns_equal": True}


def phase_native(gpu, log):
    """The host C++ column walk (`ytpu_torch.native`, built in `build`)
    against its plain version, the Python walk: the whole B4 log in one
    call, as `plan_replay` makes it, and the ingest phase's 512 steps in
    one call each over the step's payloads, as `apply_bytes` makes it."""
    from ytpu_torch.benches import ingest as bench

    logs = bench.load_ingest_logs()
    b4 = log[: bench.INGEST_STEPS]
    steps = [[p for p in bench.step_payloads(t, b4, logs) if p is not None] for t in range(bench.INGEST_STEPS)]
    line = {"phase": "native", "b4_log": _walk_vs_python([log]), "ingest_steps": _walk_vs_python(steps),
            "gpu": gpu}
    emit(line)
    return line


# --- the decode kernel -------------------------------------------------------------

DECODE_REPLACES = "ytpu/ops/decode_kernel.py:379"
DECODE_LOOP = "ytpu/ops/decode_kernel.py:1038 (the XLA fori_loop of decode_updates_v1)"
# merged whole-state lanes: B4 prefixes of these lengths and the big-client
# cohort's whole log, each merged into one update (the longest, ~2,000
# steps, keeps the plain version near 20 s at ~11 ms of host time a step)
DECODE_MERGED_B4 = (64, 128, 192)
DECODE_KERNEL_REPS = 10
DECODE_GRAPH_REPS = 50
# the decode kernel's name in a profiler trace
DECODE_KERNEL = "decode_v1_kernel"


def _capture_decode(module, captured: dict):
    """A stand-in for `module.decode_updates_v1` that records the arguments
    of its call in `captured`, then decodes."""
    real = module.decode_updates_v1

    def capture(buf, lens, max_rows, max_dels, **kw):
        captured.update(buf=buf, lens=lens, U=max_rows, R=max_dels, **kw)
        return real(buf, lens, max_rows, max_dels, **kw)

    return capture


def _stream_diff(name: str, got, want) -> int:
    """Max abs difference of two ``(UpdateBatch, flags)`` pairs; raises
    naming the fields where they differ."""
    import torch

    (stream_k, flags_k), (stream_p, flags_p) = got, want
    pairs = list(zip(stream_p._fields, stream_k, stream_p)) + [("flags", flags_k, flags_p)]
    err, differ = 0, []
    for field, a, b in pairs:
        if a.shape != b.shape:
            differ.append(field)
            continue
        if a.numel():
            err = max(err, int((a.long() - b.long()).abs().max()))
        if not torch.equal(a.long(), b.long()):
            differ.append(field)
    if differ:
        raise RuntimeError(f"decode {name}: kernel and plain composition differ in {differ[:8]}")
    return err


def _decode_bound_bytes(lens, S: int, U: int, R: int, offs=None, tables=()) -> int:
    """Bytes the decode must move at least: each lane's wire bytes, its
    length and offset read once, each table once; the 22 int32 row fields
    and their valid bytes, the 3 delete fields and theirs and the int32
    flags written once."""
    reads = int(lens.long().sum()) + lens.numel() * lens.element_size()
    if offs is not None:
        reads += offs.numel() * offs.element_size()
    for t in tables:
        for x in (t if isinstance(t, tuple) else (t,)):
            reads += x.numel() * x.element_size()
    return reads + S * U * (22 * 4 + 1) + S * R * (3 * 4 + 1) + 4 * S


def _decode_vs_plain(name: str, buf, lens, U: int, R: int, n_steps=None, max_sections=None, offs=None,
                     width=None, **tables) -> dict:
    """The decode program against the plain composition on the card (the
    gather for an arena, the plain loop, `_resolve_and_pack`), on the lanes
    as their path gives them (the arena with ``offs``, or a matrix) with
    the intern tables `tables`, then from the other layout (the gathered
    matrix, or an arena of the matrix's rows) and, where there are tables,
    without them: every UpdateBatch field and the flags equal (max abs err
    0), or it raises. Issued ms: CUDA events over DECODE_KERNEL_REPS calls
    issued one after another, the wrapper's host work included; plain ms:
    the gather, the loop and the resolve, each between CUDA events.
    Returns the result and the kernel's arguments, for `_decode_graph_ms`."""
    import torch

    from ytpu_torch.ops import decode_kernel as dk

    U, R = int(U), int(R)
    T = n_steps or dk.default_steps(U, R)
    max_sec = max_sections if max_sections is not None else U + 1
    S = lens.shape[0]
    main = dict(buf=buf, lens=lens, offs=offs, width=width)
    if offs is None:
        L = buf.shape[1]
        mat, g_ms = buf, 0.0
        other = dict(buf=buf.reshape(-1), lens=lens, offs=torch.arange(S, dtype=torch.int32, device=buf.device) * L,
                     width=L)
    else:
        L = int(width)
        mat, g_ms = _event_ms(lambda: dk.gather_raw_lanes(buf, offs, lens, L))
        other = dict(buf=mat, lens=lens, offs=None, width=None)
    (rows, dels, fl), l_ms = _event_ms(lambda: dk._decode_loop_reference(mat, lens, U, R, T, max_sec))
    plain, r_ms = _event_ms(lambda: dk._resolve_and_pack(dict(rows), dict(dels), fl, **tables))

    def kernel(layout, tabs, steps=False):
        return dk._decode_kernel(layout["buf"], layout["lens"], U, R, T, max_sec, offs=layout["offs"],
                                 width=layout["width"], steps=steps, **tabs)

    stream_k, flags_k, steps = kernel(main, tables, steps=True)
    err = _stream_diff(name, (stream_k, flags_k), plain)
    # the other layout: its gathered matrix is the main one's where the
    # matrix holds zeros past lens, and then shares its plain result
    if other["offs"] is None or torch.equal(dk.gather_raw_lanes(other["buf"], other["offs"], lens, L), mat):
        other_plain = plain
    else:
        other_plain = dk._decode_plain(**other, U=U, R=R, T=T, max_sec=max_sec, **tables)
    err = max(err, _stream_diff(f"{name} (other layout)", kernel(other, tables)[:2], other_plain))
    held = ["arena" if offs is not None else "matrix", "matrix" if offs is not None else "arena"]
    if any(v is not None for v in tables.values()):
        bare = dk._resolve_and_pack(dict(rows), dict(dels), fl)
        err = max(err, _stream_diff(f"{name} (no tables)", kernel(main, {})[:2], bare))
        held.append("no tables")
    issued_ms = _time_ms(lambda: kernel(main, tables), reps=DECODE_KERNEL_REPS)
    bound_b = _decode_bound_bytes(lens, S, U, R, offs, [v for v in tables.values() if v is not None])
    flags_p = plain[1]
    wire = int(lens.long().sum())
    return {"lanes": S, "width": L, "U": U, "R": R, "T": T, "wire_bytes": wire,
            "layout": held[0], "held": held, "staged": bool(dk._decode_lib().ytpu_decode_stage_bytes(U, R)),
            "longest_lane_steps": int(steps.max()), "lanes_at_budget": int((steps == T).sum()),
            "error_lanes": int(((flags_p & dk.FLAG_ERRORS) != 0).sum()), "max_abs_err": err,
            "issued_ms": issued_ms, "plain_ms": g_ms + l_ms + r_ms,
            "plain_ms_parts": {"gather": g_ms, "loop": l_ms, "resolve": r_ms}, "bound_bytes": bound_b,
            "bound_ms": bound_b / HBM_BYTES_PER_S * 1e3,
            "tables": sorted(k for k, v in tables.items() if v is not None)}, dict(
                buf=buf, lens=lens, U=U, R=R, T=T, max_sec=max_sec, offs=offs, width=width, **tables)


def _decode_graph_ms(inputs: dict) -> dict:
    """Device ms a launch of the decode program on each input set (name ->
    the kernel's arguments), from a CUDA graph of DECODE_GRAPH_REPS
    launches (`graph_ms`: min, mean and max of its rounds, no host issue
    time). Run after the traced phases, as the diagnostic kernels' graphs
    are: no graph is captured before a profiler window."""
    from ytpu_torch.benches._kernels import graph_ms
    from ytpu_torch.ops import decode_kernel as dk

    def launch(a):
        return dk._decode_kernel(a["buf"], a["lens"], a["U"], a["R"], a["T"], a["max_sec"],
                                 **{k: v for k, v in a.items() if k not in ("buf", "lens", "U", "R", "T", "max_sec")})

    return {name: graph_ms(lambda a=args: launch(a), reps=DECODE_GRAPH_REPS) for name, args in inputs.items()}


TRACE_ATTEMPTS = 3  # traced windows a phase that can repeat its window runs at most


def _lost_launches(prof, spans) -> int:
    """The kernel launches inside the trace's ``ytpu_torch.<span>`` spans
    (any of `spans`) whose runtime call the trace holds but whose device
    record it does not. The profiler loses device records now and then, a
    whole call's at once (kineto's log counts them "Out-of-range"); the
    runtime call of the launch stays."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    names = {f"ytpu_torch.{s}" for s in spans}
    windows = sorted((e.start_ns(), e.end_ns()) for e in events
                     if e.device_type() == DeviceType.CPU and e.name() in names)
    starts = [a for a, _ in windows]
    recorded = {e.correlation_id() for e in events
                if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()}
    lost = 0
    for e in events:
        if (e.device_type() != DeviceType.CPU or "LaunchKernel" not in e.name()
                or e.correlation_id() in recorded):
            continue
        i = bisect.bisect_right(starts, e.start_ns()) - 1
        # spans nest: any span open at the call holds it
        lost += any(a <= e.start_ns() <= b for a, b in windows[: i + 1])
    return lost


def _kernel_records(phase: str, prof, found: dict, calls: int, spans) -> dict:
    """Checks a traced window of `calls` calls, each of which launched
    every kernel of `found` once (the wrappers' counts, checked by the
    caller, show the calls made them): `found` maps each kernel to the
    device records of it that the trace holds. More records than calls is
    a fault; fewer must be accounted for by launches inside `spans` whose
    device record the trace lost (`_lost_launches`), else the launches are
    missing and this raises. Returns each kernel's missing records (empty
    for a whole trace)."""
    over = {k: n for k, n in found.items() if n > calls}
    short = {k: calls - n for k, n in found.items() if n < calls}
    lost = _lost_launches(prof, spans) if short else 0
    if over or sum(short.values()) > lost:
        raise RuntimeError(f"{phase}: the trace holds {found} kernels for {calls} calls; {lost} launches in "
                           f"its spans {list(spans)} lost their device record")
    return short


def _decode_calls(prof, phase: str) -> dict:
    """Each `decode_updates_v1` call of a trace is one device kernel: the
    device events launched inside each ``ytpu_torch.decode.v1`` span (the
    host time of the runtime call that launched them) must be exactly one,
    ``decode_v1_kernel``; raises otherwise. Returns the count of calls,
    the kernels' device ms and the least and most time from a launch's
    runtime call to its kernel's start on the trace's clock. A call whose
    one launch lost its device record (its runtime call is in the span,
    no device event is) counts in ``records_missing``, not as a fault."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    spans, launched_at, launches = [], {}, []
    for e in events:
        if e.device_type() != DeviceType.CPU:
            continue
        if e.name() == "ytpu_torch.decode.v1":
            spans.append((e.start_ns(), e.end_ns()))
        elif e.name().startswith("cu"):
            launched_at[e.correlation_id()] = e.start_ns()
            if "LaunchKernel" in e.name():
                launches.append(e.start_ns())
    spans.sort()
    starts = [a for a, _ in spans]
    inside, lag_ms = [[] for _ in spans], []
    for e in events:
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        t = launched_at.get(e.correlation_id())
        i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        if i >= 0 and t <= spans[i][1]:
            inside[i].append((e.name(), e.duration_ns() / 1e6))
            lag_ms.append((e.start_ns() - t) / 1e6)
    launched = [0] * len(spans)
    for t in launches:
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= spans[i][1]:
            launched[i] += 1
    missing = sum(1 for names, n in zip(inside, launched) if not names and n == 1)
    bad = [names for names, n in zip(inside, launched)
           if (names or n != 1) and (len(names) != 1 or DECODE_KERNEL not in names[0][0])]
    if not spans or bad:
        # what the trace holds, to tell a missing device event from a
        # missing launch: the runtime calls inside the spans and the
        # trace's device kernels by name
        calls = sorted({e.name() for e in events if e.device_type() == DeviceType.CPU and e.name().startswith("cu")
                        and any(a <= e.start_ns() <= b for a, b in spans)})
        kernels = sorted({e.name()[:60] for e in events if e.device_type() == DeviceType.CUDA})
        raise RuntimeError(f"{phase}: of {len(spans)} decode_updates_v1 calls, {len(bad)} are not one "
                           f"{DECODE_KERNEL} launch: {[[n for n, _ in b] for b in bad[:3]]}; runtime calls "
                           f"in the spans {calls[:8]}, device events in the trace {kernels[:8]}")
    kept = [ms for names in inside for _, ms in names]
    return {"calls": len(spans), "device_kernels_per_call": 1, "kernel": DECODE_KERNEL,
            "records_missing": missing, "kernel_ms_mean": sum(kept) / len(kept),
            "launch_to_kernel_start_ms": [min(lag_ms), max(lag_ms)]}


def _graph_launches(fn) -> list:
    """What one call of `fn` puts on the device, read without the
    profiler: the nodes of a CUDA graph captured around the call (after a
    warm call on a side stream), each as its kernel's name, or as its
    driver node type for a node that is not a kernel (a copy or a
    memset), through the driver API (`cuGraphGetNodes`,
    `cuGraphNodeGetType`, `cuGraphKernelNodeGetParams`, `cuFuncGetName`
    or `cuKernelGetName`)."""
    import ctypes

    import torch

    class KernelNodeParams(ctypes.Structure):  # the driver's CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = ([("func", ctypes.c_void_p)]
                    + [(f, ctypes.c_uint) for f in ("gx", "gy", "gz", "bx", "by", "bz", "smem")]
                    + [(f, ctypes.c_void_p) for f in ("params", "extra", "kern", "ctx")])

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")

    def check(err, what):
        if err:
            raise RuntimeError(f"graph nodes: {what} returned CUresult {err}")

    g, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(g, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    out = []
    for node in nodes:
        kind = ctypes.c_int()
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)), "cuGraphNodeGetType")
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            out.append(f"node type {kind.value}")
            continue
        params, name = KernelNodeParams(), ctypes.c_char_p()
        check(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), ctypes.byref(params)),
              "cuGraphKernelNodeGetParams")
        if params.func:
            check(cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(params.func)), "cuFuncGetName")
        else:
            check(cu.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(params.kern)), "cuKernelGetName")
        out.append(name.value.decode())
    del graph
    return out


def _ingest_decode_inputs(log, dev) -> dict:
    """The arguments of the fast lane's decode call at step
    INGEST_SNAPSHOT_STEP of the ingest phase's traffic: a `BatchIngestor`
    at its width on the card, fed its first steps."""
    from ytpu_torch.benches import ingest as bench
    from ytpu_torch.models import ingest as ingest_mod

    logs = bench.load_ingest_logs()
    b4 = log[: bench.INGEST_STEPS]
    ing = ingest_mod.BatchIngestor(bench.INGEST_DOCS, bench.INGEST_CAPACITY, device=dev)
    real, captured = ingest_mod.decode_updates_v1, {}
    try:
        for t in range(INGEST_SNAPSHOT_STEP + 1):
            ingest_mod.decode_updates_v1 = _capture_decode(ingest_mod, captured) if t == INGEST_SNAPSHOT_STEP \
                else real
            ing.apply_bytes(bench.step_payloads(t, b4, logs))
    finally:
        ingest_mod.decode_updates_v1 = real
    if not captured:
        raise RuntimeError(f"decode: ingest step {INGEST_SNAPSHOT_STEP} made no fast-lane decode call")
    return captured


def _merged_lanes(log):
    """Whole-state lanes: B4 prefixes and the big-client cohort's log, each
    merged into one update, with their step budget from the column walk."""
    from ytpu_torch.benches import ingest as bench
    from ytpu_torch.core.update import merge_updates_v1
    from ytpu_torch.models.replay import plan_replay

    merged = [merge_updates_v1(log[:n]) for n in DECODE_MERGED_B4]
    merged.append(merge_updates_v1(bench.load_ingest_logs()["big_client_text"]["log"]))
    return merged, plan_replay(merged)


def _arena_of(payloads, dev):
    """``(raw, offs, lens)`` on `dev`: the payloads concatenated, int32
    offsets and lengths (the layout `pack_raw_updates_into` stages)."""
    import numpy as np
    import torch

    lens = np.asarray([len(p) for p in payloads], dtype=np.int32)
    offs = np.zeros(len(payloads), dtype=np.int32)
    offs[1:] = np.cumsum(lens[:-1])
    raw = np.frombuffer(b"".join(payloads), dtype=np.uint8).copy()
    return tuple(torch.from_numpy(x).to(dev) for x in (raw, offs, lens))


def phase_decode(gpu, log, plan, dev="cuda"):
    """The decode program against the plain composition on the card, on the
    lanes its paths give it: one B4 chunk of 8,192 lanes at the replay's
    budgets (chunk LATE_CHUNK) from its arena, the fast lanes of one ingest
    step from their arena with their intern tables, and a few merged
    whole-state lanes from their matrix (each also from the other layout
    and without its tables; the sync server's round SYNC_SNAPSHOT_STEP is
    held the same way inside its phase, where its inputs exist). Then the
    build's ptxas report. Returns the sets, the report and each set's
    kernel arguments, which `_decode_graph_ms` times after the traced
    phases."""
    import torch

    from ytpu_torch.ops import _build
    from ytpu_torch.ops.decode_kernel import pack_updates

    dev = torch.device(dev)
    t0 = time.perf_counter()
    chunk = log[LATE_CHUNK * CHUNK:(LATE_CHUNK + 1) * CHUNK]
    raw, offs, lens = _arena_of(chunk, dev)
    sets, inputs = {}, {}
    sets["b4_chunk"], inputs["b4_chunk"] = _decode_vs_plain(
        "b4_chunk", raw, lens, plan.max_rows, plan.max_dels, n_steps=plan.max_steps,
        max_sections=plan.max_sections, offs=offs, width=plan.max_len + 16)
    sets["ingest_step"], inputs["ingest_step"] = _decode_vs_plain("ingest_step", **_ingest_decode_inputs(log, dev))
    sets["ingest_step"]["step"] = INGEST_SNAPSHOT_STEP
    merged, mplan = _merged_lanes(log)
    buf_np, lens_np = pack_updates(merged)
    sets["merged_whole_state"], inputs["merged_whole_state"] = _decode_vs_plain(
        "merged_whole_state", torch.from_numpy(buf_np).to(dev), torch.from_numpy(lens_np).to(dev),
        mplan.max_rows, mplan.max_dels, n_steps=mplan.max_steps, max_sections=mplan.max_sections)
    sets["merged_whole_state"]["lane_updates"] = list(DECODE_MERGED_B4) + ["big_client_text"]
    ptxas = _ptxas(_build.build_log("decode"), DECODE_KERNEL)
    emit({"phase": "decode", "sets": sets, "ptxas": ptxas, "seconds": time.perf_counter() - t0, "gpu": gpu})
    if ptxas["stack_frame_bytes"] or ptxas["spill_store_bytes"] or ptxas["spill_load_bytes"]:
        raise RuntimeError(f"the decode kernel uses local memory: {ptxas}")
    return sets, ptxas, inputs


def _time_ms(fn, reps: int = 1):
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _compare(name, cols_k, meta_k, cols_p, meta_p):
    import torch

    err = max(
        int((cols_k.long() - cols_p.long()).abs().max()),
        int((meta_k.long() - meta_p.long()).abs().max()),
    )
    if not (torch.equal(cols_k, cols_p) and torch.equal(meta_k, meta_p)):
        bad = (cols_k != cols_p).nonzero()[:5].tolist()
        bad_meta = (meta_k != meta_p).nonzero()[:5].tolist()
        raise RuntimeError(f"kernel_vs_plain {name}: kernel and plain version differ at "
                           f"planes {bad}, meta {bad_meta}")
    return err


def phase_kernel_vs_plain(gpu, log, plan):
    import numpy as np
    import torch

    from ytpu_torch.benches.integrate_profile import b4_chunks
    from ytpu_torch.benches.streams import anchored_state, synthetic_stream
    from ytpu_torch.models.batch_doc import init_state
    from ytpu_torch.ops.decode_kernel import identity_rank
    from ytpu_torch.ops.integrate_kernel import (
        integrate_stream, integrate_stream_reference, pack_state,
    )

    dev = torch.device("cuda")
    cases = []
    max_err = 0
    plan_scan = (32, 8)

    # B4: the first 2 chunks of 512 updates at 32 docs, C = 2048
    rank = identity_rank(256, dev)
    cols_k, meta_k = pack_state(init_state(32, 2048, dev))
    chunks = b4_chunks(plan, log, (0, 512), 512, dev)
    # one untimed launch first, so the timed ones do not pay for module loading
    integrate_stream(cols_k.clone(), meta_k.clone(), *chunks[0], rank, plan_scan)
    kernel_ms = plain_ms = 0.0
    for i, (rows, dels) in enumerate(chunks):
        cols_p, meta_p = cols_k.clone(), meta_k.clone()
        plain_ms += _time_ms(lambda: integrate_stream_reference(cols_p, meta_p, rows, dels, rank, plan_scan))
        kernel_ms += _time_ms(lambda: integrate_stream(cols_k, meta_k, rows, dels, rank, plan_scan))
        max_err = max(max_err, _compare(f"b4 chunk {i}", cols_k, meta_k, cols_p, meta_p))
    cases.append({"case": "b4_2x512_32docs_C2048", "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                  "max_blocks": int(meta_k[:, 1].max()), "error_max": int(meta_k[:, 2].max())})

    # synthetic: concurrent clients, map, nested, move rows, same-origin
    # storms at 8 docs, C = 256; every doc starts from its own warm stream
    D, C = 8, 256
    rank = torch.from_numpy(np.random.default_rng(11).permutation(256).astype(np.int32)).to(dev)
    cols0, meta0 = anchored_state(D, C, "cpu")
    for d in range(D):
        wr, wd = synthetic_stream(100 + d, 6)
        c1, m1 = cols0[:, d : d + 1].contiguous(), meta0[d : d + 1].contiguous()
        integrate_stream_reference(c1, m1, torch.from_numpy(wr), torch.from_numpy(wd), rank.cpu())
        cols0[:, d : d + 1], meta0[d : d + 1] = c1, m1
    rows_np, dels_np = synthetic_stream(7, 48)
    rows, dels = torch.from_numpy(rows_np).to(dev), torch.from_numpy(dels_np).to(dev)
    # the three scan plans, then a capacity cut to 144 slots so that
    # splits and appends overflow (ERR_CAPACITY)
    for scan_plan, cap in (((32, 8), C), ((0, 8), C), ((4, 1), C), ((32, 8), 144)):
        cols_k, meta_k = cols0[:, :, :cap].contiguous().to(dev), meta0.to(dev)
        cols_p, meta_p = cols_k.clone(), meta_k.clone()
        p_ms = _time_ms(lambda: integrate_stream_reference(cols_p, meta_p, rows, dels, rank, scan_plan))
        k_ms = _time_ms(lambda: integrate_stream(cols_k, meta_k, rows, dels, rank, scan_plan))
        max_err = max(max_err, _compare(f"synthetic {scan_plan}", cols_k, meta_k, cols_p, meta_p))
        cases.append({
            "case": f"synthetic_48x4_8docs_C{cap}_plan{scan_plan[0]}_{scan_plan[1]}",
            "kernel_ms": k_ms, "plain_ms": p_ms,
            "max_blocks": int(meta_k[:, 1].max()), "error_max": int(meta_k[:, 2].max()),
            "scan_width_max": int(meta_k[:, 12].max()), "moves_claimed": int((cols_k[17] >= 0).sum()),
        })
    max_err = max(max_err, _typing_cases(cases, dev))
    emit({"phase": "kernel_vs_plain", "equal": True, "max_abs_err": max_err, "cases": cases, "gpu": gpu})
    return max_err


def _typing_cases(cases, dev):
    """Cases aimed at the kernel's launch plan, cursor cache and tables:
    8 clients typing and deleting at random positions (cache entries split
    and evicted) at D = 5 (not a multiple of the docs per CTA) over 1,001
    steps (not a multiple of the tile: the ring wraps and the last tile is
    ragged); clients at indices >= KC with a 2,048-entry rank table (the
    client-clock sweep); and a misaligned ``rows`` view, which must raise."""
    import numpy as np
    import torch

    from ytpu_torch.benches.streams import typing_stream
    from ytpu_torch.models.batch_doc import init_state
    from ytpu_torch.ops import integrate_kernel as ik

    max_err = 0
    for name, D, C, S, first, K in (("typing_8clients_D5_S1001", 5, 8192, 1001, 1, 256),
                                    ("typing_clients_above_KC_K2048", 3, 2048, 300, 1500, 2048)):
        rank = torch.from_numpy(np.random.default_rng(5).permutation(K).astype(np.int32)).to(dev)
        rows, dels = (torch.from_numpy(a).to(dev) for a in typing_stream(17, S, first_client=first))
        cols_k, meta_k = ik.pack_state(init_state(D, C, dev))
        cols_p, meta_p = cols_k.clone(), meta_k.clone()
        p_ms = _time_ms(lambda: ik.integrate_stream_reference(cols_p, meta_p, rows, dels, rank))
        k_ms = _time_ms(lambda: ik.integrate_stream(cols_k, meta_k, rows, dels, rank))
        max_err = max(max_err, _compare(name, cols_k, meta_k, cols_p, meta_p))
        if int(meta_k[:, ik.M_ERROR].max()):
            raise RuntimeError(f"kernel_vs_plain {name}: sticky error {int(meta_k[:, ik.M_ERROR].max())}")
        cases.append({"case": name, "kernel_ms": k_ms, "plain_ms": p_ms,
                      "max_blocks": int(meta_k[:, ik.M_NBLOCKS].max()),
                      "launch_plan": ik.launch_plan(S, 1, 1, D, C)})
    # a view of the stream that starts 4 bytes past a 16-byte boundary
    buf = torch.zeros(rows.numel() + 4, dtype=torch.int32, device=dev)
    off = 1 if buf.data_ptr() % 16 == 0 else 0
    rows_m = buf[off : off + rows.numel()].view(rows.shape)
    rows_m.copy_(rows)
    launches = ik.integrate_stream.launches
    try:
        ik.integrate_stream(cols_k, meta_k, rows_m, dels, rank)
    except ValueError as e:
        cases.append({"case": "misaligned_rows_view", "raised": str(e)})
    else:
        raise RuntimeError("kernel_vs_plain: a misaligned rows view did not raise")
    if ik.integrate_stream.launches != launches:
        raise RuntimeError("kernel_vs_plain: a refused launch was counted")
    return max_err


def phase_full_width_vs_plain(gpu, log, plan):
    """The kernel against its plain version at the main path's capacity
    and chunk size, on a compacted state with the clocks of a late chunk.
    Docs are independent and the B4 stream is shared by every doc, so two
    docs replayed through `FusedReplay.run` up to LATE_CHUNK hold the state
    that each doc of the main path holds there."""
    import torch

    from ytpu_torch.benches.integrate_profile import late_chunk, profile_table
    from ytpu_torch.ops.integrate_kernel import (
        CK, M_NBLOCKS, integrate_stream, integrate_stream_reference,
    )

    pos = LATE_CHUNK * CHUNK
    cols_k, meta_k, rank, rows, dels = late_chunk(plan, log, LATE_CHUNK, CHUNK, CAPACITY)
    blocks_before = int(meta_k[:, M_NBLOCKS].max())
    # where the cycles of a step go: the profiling build on copies of this
    # state (its launches are not counted)
    profile = profile_table(cols_k, meta_k, rows, dels, rank)
    emit({"phase": "integrate_profile", "case": f"B4 updates {pos}..{pos + CHUNK}, 2 docs, C={CAPACITY}",
          **profile, "gpu": gpu})
    cols_p, meta_p = cols_k.clone(), meta_k.clone()
    cols_0, nb0 = cols_k.clone(), meta_k[:, M_NBLOCKS].clone()
    k_ms = _time_ms(lambda: integrate_stream(cols_k, meta_k, rows, dels, rank))
    t0 = time.perf_counter()
    p_ms = _time_ms(lambda: integrate_stream_reference(cols_p, meta_p, rows, dels, rank))
    plain_s = time.perf_counter() - t0
    max_err = _compare("full width", cols_k, meta_k, cols_p, meta_p)
    # what the launch wrote: the rows it added, and the words it changed in
    # the rows the docs held before it (which the byte bound leaves out)
    old_rows = torch.arange(cols_k.shape[2], device=cols_k.device)[None, :] < nb0[:, None]
    written = {"rows_read": int(nb0.sum()), "rows_added": int((meta_k[:, M_NBLOCKS] - nb0).sum()),
               "old_row_words_changed": int(((cols_k != cols_0) & old_rows).sum())}
    del cols_0
    line = {
        "phase": "kernel_vs_plain_full_width", "equal": True, "max_abs_err": max_err,
        "case": f"B4 updates {pos}..{pos + CHUNK} after a compaction, 2 docs, C={CAPACITY}, S={CHUNK}",
        "blocks_before": blocks_before, "blocks_after": int(meta_k[:, M_NBLOCKS].max()),
        "max_clock": int(cols_k[CK].max()), "kernel_ms": k_ms, "plain_ms": p_ms,
        "plain_wall_s": plain_s, "launch_wrote": written, "gpu": gpu,
    }
    emit(line)
    return max_err, k_ms, p_ms, profile


def _trace_breakdown(prof, wall_s: float, kernel: str = "integrate_kernel"):
    """From the raw events of a `torch.profiler` trace: device and host
    seconds per phase span (``ytpu_torch.*``; device work launched outside
    any span is ``other``), the device time of every `kernel` (by default
    the stream integrate), and the device's idle share of the traced wall
    time. A device event is placed by the host time of the runtime call
    that launched it (the CPU event of the same CUPTI correlation id), and
    counts in every span open at that time: spans nest (``decode.v1``
    inside ``decode`` or ``ingest.decode``), and each span's device and
    host seconds include those of the spans inside it. Returns the
    breakdown, the `kernel` launches as ``(launch host ns, device ms)`` in
    launch order, and the spans as ``(start ns, end ns, name)``."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    spans, launched_at = [], {}
    for e in events:
        if e.device_type() != DeviceType.CPU:
            continue
        if e.name().startswith("ytpu_torch."):
            spans.append((e.start_ns(), e.end_ns(), e.name()[len("ytpu_torch."):]))
        elif e.name().startswith("cu"):  # CUDA runtime and driver calls
            launched_at[e.correlation_id()] = e.start_ns()
    spans.sort()
    span_starts = [s for s, _, _ in spans]
    # each span's enclosing span (-1: none)
    parent, open_ = [], []
    for s, t, _ in spans:
        while open_ and spans[open_[-1]][1] < s:
            open_.pop()
        parent.append(open_[-1] if open_ else -1)
        open_.append(len(parent) - 1)
    host_s, device_s = {}, {"other": 0.0}
    for s, t, name in spans:
        host_s[name] = host_s.get(name, 0.0) + (t - s) / 1e9
        device_s.setdefault(name, 0.0)
    busy, integrate_ms = [], []
    for e in events:
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        busy.append((e.start_ns(), e.end_ns()))
        t = launched_at.get(e.correlation_id())
        if kernel in e.name():
            integrate_ms.append((t, e.duration_ns() / 1e6))
        i = bisect.bisect_right(span_starts, t) - 1 if t is not None else -1
        while i >= 0 and spans[i][1] < t:
            i = parent[i]
        if i < 0:
            device_s["other"] += e.duration_ns() / 1e9
        names = set()
        while i >= 0:
            names.add(spans[i][2])
            i = parent[i]
        for name in names:
            device_s[name] += e.duration_ns() / 1e9
    busy.sort()
    busy_ns, end = 0, None
    for s, t in busy:
        if end is None or s > end:
            busy_ns += t - s
            end = t
        elif t > end:
            busy_ns += t - end
            end = t
    return {
        "host_s": host_s, "device_s": device_s, "device_busy_s": busy_ns / 1e9,
        "device_idle_share": 1.0 - busy_ns / 1e9 / wall_s, "device_events": len(busy),
    }, sorted(integrate_ms), spans


def _replay(plan, log, expect, traced: bool, **kw):
    """One `FusedReplay.run` over the whole log at the flagship envelope
    (the keywords pick the lane: the main path is the overlap lane, raw
    ingest, depth 2), with the integrate and decode kernels' launch counts
    reset just before it and read just after (one of each a chunk); checks
    the text of the first and last doc and the sticky error."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ytpu_torch.models.replay import FusedReplay
    from ytpu_torch.ops import integrate_kernel as ik
    from ytpu_torch.ops.decode_kernel import decode_updates_v1

    kw = {**MAIN_LANE, **kw}
    rep = FusedReplay(N_DOCS, plan, capacity=CAPACITY, max_capacity=CAPACITY, chunk=CHUNK, device="cuda", **kw)
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if traced else None
    if prof is not None:
        prof.start()
    _reset_counts([ik.integrate_stream, decode_updates_v1])
    t0 = time.perf_counter()
    st = rep.run(log)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ik.integrate_stream.launches
    decode_launches = decode_updates_v1.launches
    if prof is not None:
        prof.stop()
    err = int(rep.meta[:, ik.M_ERROR].max())
    text_ok = rep.get_string(0) == expect and rep.get_string(N_DOCS - 1) == expect
    readout = ik._readout_words(rep.cols, rep.meta, rep.driver._err).cpu().tolist()
    if err != 0:
        raise RuntimeError(f"b4_replay: sticky error {err}")
    if not text_ok:
        raise RuntimeError(f"b4_replay: replayed text differs from the log's expected text ({kw})")
    if launches != st.chunks or decode_launches != st.chunks:
        raise RuntimeError(f"b4_replay: {launches} integrate and {decode_launches} decode launches for "
                           f"{st.chunks} chunks ({kw})")
    return st, wall, launches, err, readout, prof, rep, decode_launches


def _launch_bound_bytes(plan, launches: int, rows_read: int, rows_added: int) -> float:
    """Bytes one integrate launch of the main path must move at least, the
    mean over its `launches`: the stream (rows and deletes), the rank table
    and meta (read and written); CL, CK and LN of every row the docs held
    before the launch (read to index them); the 25 planes the kernel writes
    of every row it added (it never touches OS). Words a launch changes in
    rows that existed before it are left out, so this is a lower bound
    (`phase_full_width_vs_plain` counts them on one chunk)."""
    stream_b = 4 * CHUNK * (plan.max_rows * 23 + plan.max_dels * 4)
    launch_b = stream_b + 4 * (2 * N_DOCS * 32 + 256)
    return launch_b + 4 * (3 * rows_read + 25 * rows_added) / launches


OVERLAP_KEYS = ("stage_s", "stall_s", "overlap_ratio", "max_inflight", "buffer_reuses", "stage_bytes",
                "prescan_s", "syncs")


def phase_b4_replay(gpu, log, expect, plan, plan_s: float):
    """The main path: `FusedReplay.run` on the overlap lane (raw ingest,
    depth 2) over the whole log (its wall clock gives updates/s), the
    serial lane beside it (its cols and meta must equal the overlap run's
    bit for bit), then the overlap lane again under `torch.profiler` for
    the device time per phase, per integrate launch and the idle share.
    Returns the traced run's replay (its final state feeds `replay_lanes`
    and `sync_step`)."""
    import torch

    st, wall, launches, err, readout, _, rep0, decode_launches = _replay(plan, log, expect, traced=False)
    st_s, wall_s, launches_s, _, _, _, serial, decodes_s = _replay(plan, log, expect, traced=False, overlap=False)
    serial_equal = torch.equal(serial.cols, rep0.cols) and torch.equal(serial.meta, rep0.meta)
    del rep0, serial
    if not serial_equal:
        raise RuntimeError("b4_replay: the serial lane's cols or meta differ from the overlap lane's")
    # the traced run again while its trace lost device records
    trace_missing = []
    for _ in range(TRACE_ATTEMPTS):
        rep = prof = None
        torch.cuda.empty_cache()
        st_t, wall_t, launches_t, _, _, prof, rep, _ = _replay(plan, log, expect, traced=True)
        trace, integrate, _ = _trace_breakdown(prof, wall_t)
        _, decodes, _ = _trace_breakdown(prof, wall_t, kernel=DECODE_KERNEL)
        decode_calls = _decode_calls(prof, "b4_replay")
        trace_missing.append(_kernel_records("b4_replay", prof, {"integrate": len(integrate),
                                                                 "decode": len(decodes)},
                                             launches_t, ("integrate", "decode.v1")))
        if not trace_missing[-1]:
            break
    del prof
    integrate_ms = [ms for _, ms in integrate]
    decode_ms = [ms for _, ms in decodes]
    bound_b = _launch_bound_bytes(plan, launches, st.launch_rows_read, st.launch_rows_added)
    bound_ms = bound_b / HBM_BYTES_PER_S * 1e3
    line = {
        "phase": "b4_replay", "lane": MAIN_LANE, "updates": len(log), "docs": N_DOCS, "capacity": CAPACITY,
        "chunk": CHUNK, "updates_per_s": len(log) / wall, "doc_updates_per_s": len(log) * N_DOCS / wall,
        "wall_s": wall, "plan_s": plan_s, "chunks": st.chunks, "compactions": st.compactions,
        "growths": st.growths, "peak_blocks": st.peak_blocks, "final_blocks": st.final_blocks,
        "sticky_error": err, "launches": launches, "decode_launches": decode_launches,
        "launch_rows_read": st.launch_rows_read,
        "launch_rows_added": st.launch_rows_added, "bound_bytes_per_launch": bound_b,
        "overlap": {k: getattr(st, k) for k in OVERLAP_KEYS},
        "serial": {"wall_s": wall_s, "updates_per_s": len(log) / wall_s, "syncs": st_s.syncs,
                   "launches": launches_s, "decode_launches": decodes_s, "cols_meta_equal_overlap": serial_equal},
        "readout": readout, "text_ok": True,
        "traced": {"wall_s": wall_t, "updates_per_s": len(log) / wall_t, "launches": launches_t,
                   "overlap": {k: getattr(st_t, k) for k in OVERLAP_KEYS},
                   "integrate_ms_mean": sum(integrate_ms) / len(integrate_ms),
                   "integrate_ms_max": max(integrate_ms), "decode_kernel_ms_mean": sum(decode_ms) / len(decode_ms),
                   "decode_kernel_ms_max": max(decode_ms), "decode_calls": decode_calls,
                   "trace_records_missing": trace_missing, **trace},
        "gpu": gpu,
    }
    emit(line)
    return launches, sum(integrate_ms) / len(integrate_ms), bound_ms, rep, line


# replay_lanes: the kill fires at this chunk's dispatch, after checkpoints
# every LANES_CHECKPOINT_EVERY chunks
LANES_CHECKPOINT_EVERY, LANES_KILL_AFTER = 8, 20


def _lane_run(plan, log, ref, what: str, arm=None, **kw):
    """One `FusedReplay.run` of `log` with the launch counts reset just
    before it and read just after; `arm` = (site, keywords) is armed in the
    port's fault injector for the run. Returns the replay, the stats, the
    wall seconds, the launches, and whether its cols and meta equal
    `ref`'s bit for bit (None when `ref` is None)."""
    import torch

    from ytpu_torch.models.replay import FusedReplay
    from ytpu_torch.ops import integrate_kernel as ik
    from ytpu_torch.ops.decode_kernel import decode_updates_v1
    from ytpu_torch.utils.faults import faults

    rep = FusedReplay(N_DOCS, plan, capacity=CAPACITY, max_capacity=CAPACITY, chunk=CHUNK, device="cuda",
                      **{**MAIN_LANE, **kw})
    torch.cuda.synchronize()
    faults.clear()
    if arm is not None:
        faults.arm(arm[0], **arm[1])
    _reset_counts([ik.integrate_stream, decode_updates_v1])
    t0 = time.perf_counter()
    try:
        st = rep.run(log)
        torch.cuda.synchronize()
    finally:
        faults.clear()
    wall = time.perf_counter() - t0
    launches = {"integrate_stream": ik.integrate_stream.launches, "decode_v1": decode_updates_v1.launches}
    if int(rep.meta[:, ik.M_ERROR].max()):
        raise RuntimeError(f"replay_lanes: {what}: sticky error")
    equal = None if ref is None else bool(torch.equal(rep.cols, ref[0]) and torch.equal(rep.meta, ref[1]))
    return rep, st, wall, launches, equal


def phase_replay_lanes(gpu, log, expect, plan, rep_main):
    """The other lanes of `FusedReplay` on the main path's envelope, each
    held bit for bit to the main path's final state `rep_main` (the overlap
    lane, raw ingest, depth 2): raw ingest at depths 1 and 3, host-packed
    ingest at depth 2, the serial lane being in `b4_replay`; checkpoints
    every LANES_CHECKPOINT_EVERY chunks with a `replay.kill` at chunk
    LANES_KILL_AFTER (it must resume from a checkpoint past 0); quarantine
    of a corrupted last update on the raw and packed lanes (exactly that
    index, the text of a healthy replay of the log without it); the same
    corruption without quarantine must raise the serial lane's message.
    Every run's launches are counted."""
    import torch

    ref = (rep_main.cols, rep_main.meta)
    runs, launches = {}, {"integrate_stream": 0, "decode_v1": 0}

    def record(name, st, wall, n, equal, **extra):
        runs[name] = {"wall_s": wall, "chunks": st.chunks, "launches": n, "state_equal_main": equal,
                      **{k: getattr(st, k) for k in OVERLAP_KEYS}, **extra}
        for k in launches:
            launches[k] += n[k]

    for name, kw in (("raw_depth1", dict(depth=1)), ("raw_depth3", dict(depth=3)),
                     ("packed_depth2", dict(ingest="packed"))):
        rep, st, wall, n, equal = _lane_run(plan, log, ref, name, **kw)
        if not equal or n["integrate_stream"] != st.chunks or n["decode_v1"] != st.chunks:
            raise RuntimeError(f"replay_lanes: {name}: state equal {equal}, launches {n} for {st.chunks} chunks")
        record(name, st, wall, n, equal, ingest=st.ingest)
        del rep
    torch.cuda.empty_cache()

    rep, st, wall, n, equal = _lane_run(plan, log, ref, "kill_resume", arm=("replay.kill", {"after": LANES_KILL_AFTER}),
                                        checkpoint_every=LANES_CHECKPOINT_EVERY)
    resumed = st.resumes[0] if st.resumes else None
    # the killed dispatch ran its chunk but does not count as one
    if not equal or not resumed or st.recoveries != 1 or n["integrate_stream"] != st.chunks + 1:
        raise RuntimeError(f"replay_lanes: kill_resume: state equal {equal}, resumes {st.resumes}, "
                           f"recoveries {st.recoveries}, launches {n} for {st.chunks} chunks")
    record("kill_resume", st, wall, n, equal, resumes=st.resumes, recoveries=st.recoveries,
           checkpoints=st.checkpoints, checkpoint_s=st.checkpoint_s, checkpoint_bytes=st.checkpoint_bytes,
           checkpoint_s_each=st.checkpoint_s / st.checkpoints)
    del rep
    torch.cuda.empty_cache()

    poison = len(log) - 1
    rep, st, wall, n, _ = _lane_run(plan, log[:poison], None, "healthy_without_last")
    expect_m1 = rep.get_string(0)
    record("healthy_without_last", st, wall, n, None)
    del rep
    for name, kw in (("quarantine_raw", {}), ("quarantine_packed", dict(ingest="packed"))):
        rep, st, wall, n, _ = _lane_run(plan, log, None, name, arm=("update.corrupt", {"after": poison}),
                                        quarantine=True, **kw)
        texts = (rep.get_string(0), rep.get_string(N_DOCS - 1))
        if st.quarantined != [poison] or texts != (expect_m1, expect_m1):
            raise RuntimeError(f"replay_lanes: {name}: quarantined {st.quarantined[:8]}, text equal to the healthy "
                               f"replay without update {poison}: {texts[0] == expect_m1}, {texts[1] == expect_m1}")
        record(name, st, wall, n, None, quarantined=st.quarantined, ingest=st.ingest)
        del rep
        torch.cuda.empty_cache()
    try:
        _lane_run(plan, log, None, "poison_raw", arm=("update.corrupt", {"after": poison}))
        raised = None
    except RuntimeError as e:
        raised = str(e)
    want = f"device decode flagged updates [{poison}]: flags"
    if raised is None or not raised.startswith(want):
        raise RuntimeError(f"replay_lanes: the corrupted update without quarantine raised {raised!r}")
    torch.cuda.empty_cache()
    line = {"phase": "replay_lanes", "docs": N_DOCS, "capacity": CAPACITY, "chunk": CHUNK, "runs": runs,
            "poison_error": raised, "launches": launches, "gpu": gpu}
    emit(line)
    return line


# pipeline_checkpoint: UpdatePipeline over this B4 prefix at the ingest
# phase's width, in chunks of this many updates; the ingestor checkpoint
# then runs this many steps past the ingest phase's on both ingestors; the
# server checkpoint's greetings are compared for every this-many-th tenant
PIPE_UPDATES, PIPE_CHUNK_STEPS = 8192, 64
CKPT_MORE_STEPS = 64
CKPT_GREETING_STRIDE = 8


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(base, f)) for base, _, files in os.walk(path) for f in files)


def _pipeline_lanes(gpu, log, dev):
    """`UpdatePipeline` on both lanes over the first PIPE_UPDATES B4
    updates at 1,024 docs x 8,192 slots, each doc's text held to
    `FusedReplay`'s (the overlap lane) over the same prefix."""
    import torch

    from ytpu_torch.benches import ingest as ingest_bench
    from ytpu_torch.models.batch_doc import BatchEncoder, get_string, init_state
    from ytpu_torch.models.pipeline import UpdatePipeline
    from ytpu_torch.models.replay import FusedReplay, plan_chunks, plan_replay
    from ytpu_torch.ops import integrate_kernel as ik
    from ytpu_torch.ops.decode_kernel import decode_updates_v1

    docs, capacity = ingest_bench.INGEST_DOCS, ingest_bench.INGEST_CAPACITY
    prefix = log[:PIPE_UPDATES]
    plan = plan_replay(prefix)
    # the largest chunk whose worst-case growth fits the policy's budget
    chunk = plan_chunks(plan.adds, capacity).chunk
    rep = FusedReplay(docs, plan, capacity=capacity, max_capacity=capacity, chunk=chunk, device=dev, **MAIN_LANE)
    _reset_counts([ik.integrate_stream, decode_updates_v1])
    rep.run(prefix)
    launches = {"replay": {"integrate_stream": ik.integrate_stream.launches, "decode_v1": decode_updates_v1.launches}}
    want = rep.get_string(0)
    if rep.get_string(docs - 1) != want:
        raise RuntimeError("pipeline_checkpoint: the prefix replay's docs differ")
    del rep
    torch.cuda.empty_cache()
    out = {}
    for lane in ("xla", "fused"):
        enc = BatchEncoder(root_name="text")
        pipe = UpdatePipeline(enc, plan.max_rows, plan.max_dels, chunk_steps=PIPE_CHUNK_STEPS, lane=lane)
        state = init_state(docs, capacity, dev)
        torch.cuda.synchronize()
        _reset_counts([ik.integrate_stream, decode_updates_v1])
        t0 = time.perf_counter()
        state, chunks = pipe.run(state, prefix)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = {"integrate_stream": ik.integrate_stream.launches, "decode_v1": decode_updates_v1.launches}
        texts = [get_string(state, d, enc.payloads) for d in (0, docs // 2, docs - 1)]
        err = int(state.error.max())
        if err or texts != [want] * 3 or n["integrate_stream"] != chunks:
            raise RuntimeError(f"pipeline_checkpoint: UpdatePipeline lane {lane}: error {err}, texts equal "
                               f"{[t == want for t in texts]}, launches {n} for {chunks} chunks")
        launches[lane] = n
        out[lane] = {"wall_s": wall, "chunks": chunks, "updates_per_s": len(prefix) / wall,
                     "final_blocks_max": int(state.n_blocks.max()), "launches": n}
        del state
        torch.cuda.empty_cache()
    return {"updates": len(prefix), "docs": docs, "capacity": capacity, "chunk_steps": PIPE_CHUNK_STEPS,
            "replay_chunk": chunk, "lanes": out, "text_equal_replay": True}, launches


def _ingestors_equal(a, b) -> bool:
    import torch

    from ytpu_torch.models.batch_doc import ensure_origin_slot

    sa, sb = ensure_origin_slot(a.state), ensure_origin_slot(b.state)
    fields = zip(list(sa.blocks) + [sa.start, sa.n_blocks, sa.error], list(sb.blocks) + [sb.start, sb.n_blocks, sb.error])
    return (all(torch.equal(x, y) for x, y in fields)
            and [sv.clocks for sv in a.svs] == [sv.clocks for sv in b.svs]
            and [sorted(p) for p in a._pending] == [sorted(p) for p in b._pending]
            and a.payloads.total_bytes == b.payloads.total_bytes)


def _ingestor_checkpoint(log, ing, dev, tmp: str):
    """`save_ingestor` / `load_ingestor` of the ingest phase's ingestor:
    the loaded one must equal it, and after CKPT_MORE_STEPS more steps on
    both (the B4 cohort goes on, the other logs are done) they must still
    be equal."""
    import torch

    from ytpu_torch.benches import ingest as bench
    from ytpu_torch.models.checkpoint import load_ingestor, save_ingestor
    from ytpu_torch.ops import integrate_kernel as ik

    path = os.path.join(tmp, "ingestor")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_ingestor(path, ing)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = load_ingestor(path, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if not _ingestors_equal(loaded, ing):
        raise RuntimeError("pipeline_checkpoint: the loaded ingestor differs from the saved one")
    logs = bench.load_ingest_logs()
    _reset_counts([ik.integrate_batch])
    for t in range(bench.INGEST_STEPS, bench.INGEST_STEPS + CKPT_MORE_STEPS):
        payloads = bench.step_payloads(t, log, logs)
        ing.apply_bytes(payloads)
        loaded.apply_bytes(payloads)
    launches = ik.integrate_batch.launches
    if not _ingestors_equal(loaded, ing) or launches != 2 * CKPT_MORE_STEPS:
        raise RuntimeError(f"pipeline_checkpoint: after {CKPT_MORE_STEPS} more steps the loaded ingestor differs "
                           f"from the unbroken one ({launches} per-doc launches)")
    return {"save_s": save_s, "load_s": load_s, "bytes_on_disk": _dir_bytes(path), "more_steps": CKPT_MORE_STEPS,
            "equal_after_more_steps": True}, launches


def _server_checkpoint(server, dev, tmp: str):
    """`save_device_server` / `load_device_server` of the sync-server
    phase's server: slots and root names kept, and the greetings of every
    CKPT_GREETING_STRIDE-th tenant carry the same state vectors."""
    import torch

    from ytpu_torch.models.checkpoint import load_device_server, save_device_server

    path = os.path.join(tmp, "server")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_device_server(path, server)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored = load_device_server(path, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    names = sorted(server._slot_of)[::CKPT_GREETING_STRIDE]
    # frame 0 of a greeting is the SyncStep1 with the device state vector
    bad = [n for n in names if restored.connect_frames(n)[1][0] != server.connect_frames(n)[1][0]
           or restored.device_state_vector(n) != server.device_state_vector(n)]
    if bad or restored._slot_of != server._slot_of or restored._root_names != server._root_names:
        raise RuntimeError(f"pipeline_checkpoint: the restored server greets tenants {bad[:8]} differently")
    return {"save_s": save_s, "load_s": load_s, "bytes_on_disk": _dir_bytes(path), "tenants": len(server._slot_of),
            "greetings_compared": len(names), "greetings_equal": True}


def phase_pipeline_checkpoint(gpu, log, ing, server):
    """`UpdatePipeline` on both lanes (`_pipeline_lanes`), then the
    checkpoint files of the ingest phase's ingestor (`_ingestor_checkpoint`)
    and of the sync-server phase's server (`_server_checkpoint`), written
    to a temporary directory that is removed after."""
    import shutil
    import tempfile

    import torch

    dev = torch.device("cuda")
    pipeline, launches = _pipeline_lanes(gpu, log, dev)
    tmp = tempfile.mkdtemp(prefix="ytpu_torch_ckpt_")
    try:
        ingestor, launches["checkpoint_integrate_batch"] = _ingestor_checkpoint(log, ing, dev, tmp)
        torch.cuda.empty_cache()
        srv = _server_checkpoint(server, dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    line = {"phase": "pipeline_checkpoint", "pipeline": pipeline, "ingestor_checkpoint": ingestor,
            "server_checkpoint": srv, "launches": launches, "gpu": gpu}
    emit(line)
    return line


# --- the sync step -----------------------------------------------------------------

# write path: BASELINE config 2's width, the first updates of the B4 log,
# doc d lagging (d mod LAG_GROUPS) * LAG_STEP updates behind
WRITE_DOCS, WRITE_CAPACITY, WRITE_UPDATES = 1024, 8192, 2048
LAG_GROUPS, LAG_STEP = 8, 64
# the steps timed piece by piece from a snapshot of the write path's state
WRITE_TIMED_FROM, WRITE_TIMED_STEPS = 1536, 64
# kernel vs plain on per-doc synthetic streams
BATCH_PLAIN_DOCS, BATCH_PLAIN_CAPACITY, BATCH_PLAIN_STEPS = 8, 1024, 16
# read path: BASELINE config 5's width
READ_DOCS, READ_CLIENTS, READ_CAPACITY, READ_SAMPLE = 10240, 64, 1024, 64
# the B4 read: the state vector of this many updates
B4_MID_UPDATES = 130_000


def _event_ms(fn):
    """``(result, device ms)`` of `fn` between two CUDA events; waits for
    the second."""
    import torch

    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    stop.synchronize()
    return out, start.elapsed_time(stop)


def _states_equal(a, b, docs_a, docs_b) -> bool:
    """Every `DocStateBatch` field of docs `docs_a` of `a` equals that of
    docs `docs_b` of `b`."""
    import torch

    fields = list(a.blocks) + [a.start, a.n_blocks, a.error]
    other = list(b.blocks) + [b.start, b.n_blocks, b.error]
    return all(torch.equal(x[docs_a], y[docs_b]) for x, y in zip(fields, other))


def _write_path(gpu, log, plan, dev):
    """(a) One `apply_update_batch` per step at 1,024 docs x 8,192 slots over
    the first 2,048 B4 updates with per-doc lags; checks equal cols within a
    lag group, the lag-0 docs against one `apply_update_stream` launch of
    the prefix, and each group's text against the stream replay of its
    prefix. Then the pieces of a call from a `torch.profiler` trace of 64
    steps replayed from a snapshot of the state at step 1,536, the plain
    version on that snapshot's step, the per-doc kernel's profile there
    (phase 1 against phase 2, scratch sized from the live rows and for C)
    and its launch floor."""
    import torch

    from ytpu_torch.benches._kernels import empty_launch, graph_ms
    from ytpu_torch.benches.integrate_profile import batch_profile_table
    from ytpu_torch.benches.sync_step import batch_bound_bytes, lagged_batch
    from ytpu_torch.models import batch_doc as bd
    from ytpu_torch.ops import integrate_kernel as ik
    from ytpu_torch.ops.decode_kernel import (
        FLAG_ERRORS, RawPayloadView, decode_updates_v1, identity_rank, pack_updates,
    )

    prefix = log[:WRITE_UPDATES]
    buf_np, lens_np = pack_updates(prefix)
    stream, flags = decode_updates_v1(
        torch.from_numpy(buf_np).to(dev), torch.from_numpy(lens_np).to(dev), max_rows=plan.max_rows,
        max_dels=plan.max_dels, n_steps=plan.max_steps, max_sections=plan.max_sections)
    if int(((flags & FLAG_ERRORS) != 0).sum()):
        raise RuntimeError("sync_step: decode flagged the write path's updates")
    view = RawPayloadView(buf_np)
    rank = identity_rank(256, dev)
    lag = (torch.arange(WRITE_DOCS, device=dev) % LAG_GROUPS) * LAG_STEP
    state = bd.init_state(WRITE_DOCS, WRITE_CAPACITY, dev)
    snapshot = None
    torch.cuda.synchronize()
    _reset_counts([ik.integrate_batch, ik.integrate_stream])
    t0 = time.perf_counter()
    for t in range(WRITE_UPDATES):
        if t == WRITE_TIMED_FROM:
            snapshot = state
        state = bd.apply_update_batch(state, lagged_batch(stream, t, lag), rank)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"batch": ik.integrate_batch.launches, "stream": ik.integrate_stream.launches}
    if launches != {"batch": WRITE_UPDATES, "stream": 0}:
        raise RuntimeError(f"sync_step: the write path made launches {launches}")
    err = int(state.error.max())
    groups_equal = all(
        _states_equal(state, state, slice(g, None, LAG_GROUPS), torch.full(
            (WRITE_DOCS // LAG_GROUPS,), g, device=dev))
        for g in range(LAG_GROUPS))
    texts_ok, lag0_equal = [], None
    for g in range(LAG_GROUPS):
        n = WRITE_UPDATES - g * LAG_STEP
        ref = bd.apply_update_stream(bd.init_state(1, WRITE_CAPACITY, dev),
                                     type(stream)(*(f[:n] for f in stream)), rank)
        if g == 0:
            lag0_equal = _states_equal(state, ref, slice(0, None, LAG_GROUPS),
                                       torch.zeros(WRITE_DOCS // LAG_GROUPS, dtype=torch.long, device=dev))
        texts_ok.append(bd.get_string(state, g, view) == bd.get_string(ref, 0, view))
    if err or not groups_equal or not lag0_equal or not all(texts_ok):
        raise RuntimeError(f"sync_step write path: error {err}, groups equal {groups_equal}, lag-0 "
                           f"equal to the stream replay {lag0_equal}, texts {texts_ok}")

    # the pieces of a call from the snapshot, each in a profiler span: the
    # device time of each, free of the host's allocation latency (these
    # launches are not counted)
    pieces = ("pack_state", "pack_stream", "integrate_batch", "unpack_state")
    record = torch.profiler.record_function
    # the window again, from the same snapshot, while its trace lost device
    # records
    trace_missing = []
    for _ in range(TRACE_ATTEMPTS):
        rows_read = rows_added = 0
        st = snapshot
        calls_before = ik.integrate_batch.launches
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for t in range(WRITE_TIMED_FROM, WRITE_TIMED_FROM + WRITE_TIMED_STEPS):
                batch = lagged_batch(stream, t, lag)
                with record("ytpu_torch.pack_state"):
                    cols, meta = ik.pack_state(st)
                with record("ytpu_torch.pack_stream"):
                    rows, dels = ik.pack_stream(batch)
                nb0 = int(meta[:, ik.M_NBLOCKS].sum())
                with record("ytpu_torch.integrate_batch"):
                    ik.integrate_batch(cols, meta, rows, dels, rank)
                rows_read, rows_added = rows_read + nb0, rows_added + int(meta[:, ik.M_NBLOCKS].sum()) - nb0
                with record("ytpu_torch.unpack_state"):
                    st = ik.unpack_state(cols, meta)
            torch.cuda.synchronize()
            traced_s = time.perf_counter() - t0
        if ik.integrate_batch.launches - calls_before != WRITE_TIMED_STEPS:
            raise RuntimeError(f"sync_step: {ik.integrate_batch.launches - calls_before} per-doc launches in "
                               f"the traced window of {WRITE_TIMED_STEPS} calls")
        # each call of the per-doc entry launches the index kernel, then the
        # integrate kernel
        trace, integrates, _ = _trace_breakdown(prof, traced_s, kernel="integrate_batch_kernel")
        _, indexes, _ = _trace_breakdown(prof, traced_s, kernel="integrate_batch_index_kernel")
        trace_missing.append(_kernel_records("sync_step", prof, {"index": len(indexes), "integrate": len(integrates)},
                                             WRITE_TIMED_STEPS, ("integrate_batch",)))
        if not trace_missing[-1]:
            break
    del prof
    per ={k: trace["device_s"].get(k, 0.0) * 1e3 / WRITE_TIMED_STEPS for k in pieces}
    kernel_ms = [a + b for (_, a), (_, b) in zip(indexes, integrates)]
    # the plain version on one step at full width, from the snapshot
    cols_k, meta_k = ik.pack_state(snapshot)
    batch = lagged_batch(stream, WRITE_TIMED_FROM, lag)
    rows, dels = ik.pack_stream(batch)
    cols_p, meta_p = cols_k.clone(), meta_k.clone()
    ik.integrate_batch(cols_k, meta_k, rows, dels, rank)
    plain_ms = _time_ms(lambda: ik.integrate_batch_reference(cols_p, meta_p, rows, dels, rank))
    full_err = _compare("integrate_batch at the write path's width", cols_k, meta_k, cols_p, meta_p)
    del cols_k, meta_k, cols_p, meta_p
    bound_b = batch_bound_bytes(WRITE_DOCS, rows.shape[1], dels.shape[1], rank.shape[0],
                                rows_read // WRITE_TIMED_STEPS, rows_added // WRITE_TIMED_STEPS)
    # phase 1 against phase 2 on the snapshot's step, each doc's scratch
    # sized from its live rows and, the sizing before it, for all C slots;
    # the bytes phase 1 clears; the launch floor at the entry's grid and at
    # the grid it had before
    cols_k, meta_k = ik.pack_state(snapshot)
    plan_b = ik.batch_launch_plan(WRITE_DOCS, WRITE_CAPACITY, nb0=meta_k[:, ik.M_NBLOCKS].tolist(),
                                  U=rows.shape[1], R=dels.shape[1])
    profile = batch_profile_table(cols_k, meta_k, rows, dels, rank)
    if profile["live_rows"]["cleared_bytes"] != plan_b["cleared_bytes"]:
        raise RuntimeError(f"sync_step: the kernel cleared {profile['live_rows']['cleared_bytes']} bytes, "
                           f"its plan says {plan_b['cleared_bytes']}")
    floor = _launch_floor(lambda: ik.integrate_batch(cols_k, meta_k, rows, dels, rank))
    if (floor["grid"][0], floor["block"][0]) != (WRITE_DOCS // 2, 96):
        floor["before_ms"] = graph_ms(empty_launch((WRITE_DOCS // 2,), (96,), dev))["mean"]
    del snapshot, st, cols, meta, cols_k, meta_k
    return {
        "docs": WRITE_DOCS, "capacity": WRITE_CAPACITY, "updates": WRITE_UPDATES,
        "lag": f"(doc mod {LAG_GROUPS}) * {LAG_STEP}", "U": int(stream.client.shape[1]),
        "R": int(stream.del_client.shape[1]), "launches": launches, "wall_s": wall,
        "ms_per_apply_update_batch": wall * 1e3 / WRITE_UPDATES,
        "timed_steps": f"{WRITE_TIMED_FROM}..{WRITE_TIMED_FROM + WRITE_TIMED_STEPS}",
        "device_ms_per_call": per, "kernel_ms": sum(kernel_ms) / len(kernel_ms),
        "kernel_ms_min": min(kernel_ms), "kernel_ms_max": max(kernel_ms),
        "index_kernel_ms": sum(ms for _, ms in indexes) / len(indexes),
        "integrate_kernel_ms": sum(ms for _, ms in integrates) / len(integrates),
        "trace_records_missing": trace_missing, "plain_ms_full_width_step": plain_ms, "max_abs_err_full_width_step": full_err,
        "bound_bytes_per_launch": bound_b, "bound_ms": bound_b / HBM_BYTES_PER_S * 1e3,
        "rows_read_per_launch": rows_read / WRITE_TIMED_STEPS,
        "rows_added_per_launch": rows_added / WRITE_TIMED_STEPS,
        "final_blocks_max": int(state.n_blocks.max()), "sticky_error": err, "groups_equal": True,
        "lag0_equals_stream": True, "texts_ok": texts_ok, "launch_plan": plan_b,
        "cleared_bytes_per_launch": plan_b["cleared_bytes"], "profile": profile, "launch_floor": floor,
    }


def _batch_vs_plain(dev):
    """(b) The per-doc kernel against `integrate_batch_reference` on the
    card: 8 docs x 1,024 slots, 16 steps, doc d's rows step t of its own
    synthetic stream (string, GC, deleted, format, nested, map and move
    rows, gaps, duplicates, same-origin storms); then `batch_edge_steps`
    (an empty doc, a doc whose launches start within their bound of C,
    splits of both origins and of both ends of delete ranges, moves that
    split blocks). Every plane and meta word is compared after each
    step."""
    import numpy as np
    import torch

    from ytpu_torch.benches.streams import (
        EDGE_CAPACITY, EDGE_DOCS, anchored_state, batch_edge_steps, synthetic_stream,
    )
    from ytpu_torch.models.batch_doc import init_state
    from ytpu_torch.ops import integrate_kernel as ik

    rank = torch.from_numpy(np.random.default_rng(11).permutation(256).astype(np.int32)).to(dev)
    streams = [synthetic_stream(300 + d, BATCH_PLAIN_STEPS) for d in range(BATCH_PLAIN_DOCS)]
    rows = torch.from_numpy(np.stack([r for r, _ in streams], 1)).to(dev)
    dels = torch.from_numpy(np.stack([d for _, d in streams], 1)).to(dev)
    cols_k, meta_k = anchored_state(BATCH_PLAIN_DOCS, BATCH_PLAIN_CAPACITY, dev)
    cols_p, meta_p = cols_k.clone(), meta_k.clone()
    ik.integrate_batch(cols_k.clone(), meta_k.clone(), rows[0], dels[0], rank)  # module load
    k_ms = p_ms = 0.0
    max_err = 0
    for t in range(BATCH_PLAIN_STEPS):
        k_ms += _time_ms(lambda: ik.integrate_batch(cols_k, meta_k, rows[t], dels[t], rank))
        p_ms += _time_ms(lambda: ik.integrate_batch_reference(cols_p, meta_p, rows[t], dels[t], rank))
        max_err = max(max_err, _compare(f"integrate_batch step {t}", cols_k, meta_k, cols_p, meta_p))
    live = torch.arange(BATCH_PLAIN_CAPACITY, device=dev)[None, :] < meta_k[:, ik.M_NBLOCKS][:, None]
    erows, edels = (torch.from_numpy(a).to(dev) for a in batch_edge_steps())
    ecols_k, emeta_k = ik.pack_state(init_state(EDGE_DOCS, EDGE_CAPACITY, dev))
    ecols_p, emeta_p = ecols_k.clone(), emeta_k.clone()
    edge_err = 0
    for t in range(erows.shape[0]):
        ik.integrate_batch(ecols_k, emeta_k, erows[t], edels[t], rank)
        ik.integrate_batch_reference(ecols_p, emeta_p, erows[t], edels[t], rank)
        edge_err = max(edge_err, _compare(f"integrate_batch edge step {t}", ecols_k, emeta_k, ecols_p, emeta_p))
    max_err = max(max_err, edge_err)
    return {
        "case": f"{BATCH_PLAIN_DOCS} docs, C={BATCH_PLAIN_CAPACITY}, {BATCH_PLAIN_STEPS} steps of "
                f"per-doc synthetic streams", "max_abs_err": max_err,
        "kernel_ms_per_launch": k_ms / BATCH_PLAIN_STEPS, "plain_ms_per_launch": p_ms / BATCH_PLAIN_STEPS,
        "max_blocks": int(meta_k[:, ik.M_NBLOCKS].max()), "error_max": int(meta_k[:, ik.M_ERROR].max()),
        "map_rows": int(((cols_k[ik.KEY] >= 0) & live).sum()),
        "move_rows": int(((cols_k[ik.KD] == 11) & live).sum()),
        "nested_rows": int(((cols_k[ik.PA] >= 0) & live).sum()),
        "edge_case": {"docs": EDGE_DOCS, "capacity": EDGE_CAPACITY, "steps": int(erows.shape[0]),
                      "max_abs_err": edge_err, "final_blocks": emeta_k[:, ik.M_NBLOCKS].tolist(),
                      "errors": emeta_k[:, ik.M_ERROR].tolist()},
    }


def _finish_check(state, docs, ship, off, dele, tables, got):
    """`got` (the card's bytes of `docs`) against `finish_encode_diff_batch`
    of the same docs on a CPU copy of their rows, and against the Python
    finisher (`finish_encode_diff`, i.e. `_finish_rows`) of each; each must
    parse as a v1 update."""
    import torch

    from ytpu_torch.encoding.lib0 import update_columns
    from ytpu_torch.models import batch_doc as bd

    idx = torch.as_tensor(docs, device=state.start.device)
    cpu = bd.DocStateBatch(bd.BlockCols(*(a[idx].cpu() for a in state.blocks)),
                           *(a[idx].cpu() for a in (state.start, state.n_blocks, state.error)))
    sel = ship[idx].cpu(), off[idx].cpu(), dele[idx].cpu()
    want = bd.finish_encode_diff_batch(cpu, range(len(docs)), *sel, tables)
    plain = [bd.finish_encode_diff(cpu, j, *sel, tables) for j in range(len(docs))]
    if got != want or got != plain:
        bad = [d for d, g, w, p in zip(docs, got, want, plain) if not g == w == p][:5]
        raise RuntimeError(f"sync_step: the card's diff bytes differ from the CPU finisher's or the Python "
                           f"finisher's for docs {bad}")
    if any(update_columns(b).error for b in got):
        raise RuntimeError("sync_step: a diff does not parse as a v1 update")
    return want


def _read_path(gpu, dev):
    """(c) BASELINE config 5: the 64 one-insert updates decoded on the card
    and applied as one stream to 10,240 docs x 1,024 slots, their content
    refs rebased onto one chunk of a `ChunkedWirePayloads` as the batch
    ingestor keeps its fast lane's bytes (`wire_chunk_tables`), remote
    state vectors from ``default_rng(5).integers(0, 12)``; then
    `state_vectors`, `encode_diff_batch`, the serial finisher and
    `DiffPipeline` over every doc (the native finisher), and the Python
    finisher (`_finish_rows`, its plain version) over the same compacted
    rows: every doc's bytes equal, no doc left to the Python finisher; a
    sample of 64 docs is held against the CPU finisher."""
    import numpy as np
    import torch

    from ytpu_torch.benches.sync_step import config5_updates, encode_diff_bound_bytes, wire_chunk_tables
    from ytpu_torch.models import batch_doc as bd
    from ytpu_torch.ops import integrate_kernel as ik
    from ytpu_torch.ops.decode_kernel import FLAG_ERRORS, decode_updates_v1, identity_rank, pack_updates

    updates = config5_updates(READ_CLIENTS)
    buf_np, lens_np = pack_updates(updates)
    stream, flags = decode_updates_v1(torch.from_numpy(buf_np).to(dev), torch.from_numpy(lens_np).to(dev),
                                      max_rows=1, max_dels=1)
    if int(((flags & FLAG_ERRORS) != 0).sum()):
        raise RuntimeError("sync_step: decode flagged a config-5 update")
    n = READ_CLIENTS + 1  # clients 1..64 at their raw ids
    stream, tables = wire_chunk_tables(updates, stream, buf_np.shape[1], n)
    _reset_counts([ik.integrate_stream])
    state = bd.apply_update_stream(bd.init_state(READ_DOCS, READ_CAPACITY, dev), stream,
                                   identity_rank(256, dev))
    torch.cuda.synchronize()
    if ik.integrate_stream.launches != 1 or int(state.error.max()):
        raise RuntimeError(f"sync_step: the seed took {ik.integrate_stream.launches} launches, "
                           f"error {int(state.error.max())}")
    remote = np.zeros((READ_DOCS, n), dtype=np.int32)
    remote[:, 1:] = np.random.default_rng(5).integers(0, 12, size=(READ_DOCS, READ_CLIENTS))
    remote_t = torch.from_numpy(remote).to(dev)
    local_sv, sv_ms = _event_ms(lambda: bd.state_vectors(state, n))
    want_sv = torch.tensor([0] + [len(f"client-{c} ") for c in range(READ_CLIENTS)], dtype=torch.int32,
                           device=dev)
    if not bool((local_sv == want_sv).all()):
        raise RuntimeError("sync_step: the config-5 state vectors are not every client's insert")
    bd.encode_diff_batch(state, remote_t, n)  # warm the allocator
    enc_ms = []
    for _ in range(5):
        (ship, off, _, dele), m = _event_ms(lambda: bd.encode_diff_batch(state, remote_t, n))
        enc_ms.append(m)
    docs = list(range(READ_DOCS))
    serial_stats = bd.DiffStats()
    t0 = time.perf_counter()
    serial = bd.finish_encode_diff_batch(state, docs, ship, off, dele, tables, stats=serial_stats)
    finisher_s = time.perf_counter() - t0
    pipe = bd.DiffPipeline(sub_batch=512, depth=2)
    t0 = time.perf_counter()
    piped = pipe.run(state, docs, ship, off, dele, tables)
    pipeline_s = time.perf_counter() - t0
    if piped != serial:
        raise RuntimeError("sync_step: DiffPipeline's bytes differ from the serial finisher's")
    # the Python finisher over the rows the serial call compacted
    idx = bd._selection(docs, READ_DOCS, bd._next_pow2(len(docs)), dev)
    R = min(bd._next_pow2(int(bd._finish_counts(state.blocks.parent, ship, dele, idx).max())), READ_CAPACITY)
    rows = bd.compact_finisher_rows(state.blocks, ship, off, dele, idx, R).cpu().numpy()
    t0 = time.perf_counter()
    plain = [bd._finish_compacted(rows[j], tables) for j in docs]
    python_s = time.perf_counter() - t0
    del rows
    bad = [d for d in docs if plain[d] != serial[d]]
    fallback = {"serial": serial_stats.fallback_docs, "pipeline": pipe.stats.fallback_docs}
    if bad or any(fallback.values()):
        raise RuntimeError(f"sync_step: the native finisher's bytes differ from the Python finisher's for docs "
                           f"{bad[:5]} ({len(bad)} docs); docs left to the Python finisher {fallback}")
    sample = sorted(np.random.default_rng(7).choice(READ_DOCS, READ_SAMPLE, replace=False).tolist())
    _finish_check(state, sample, ship, off, dele, tables, [serial[d] for d in sample])
    bound_b = encode_diff_bound_bytes(READ_DOCS, READ_CAPACITY, n)
    st = pipe.stats
    out = {
        "docs": READ_DOCS, "clients": READ_CLIENTS, "capacity": READ_CAPACITY,
        "state_gb": sum(a.numel() * a.element_size() for a in state.blocks) / 1e9,
        "state_vectors_ms": sv_ms, "encode_diff_batch_ms": enc_ms,
        "encode_diff_batch_ms_min": min(enc_ms), "encode_diff_bound_bytes": bound_b,
        "encode_diff_bound_ms": bound_b / HBM_BYTES_PER_S * 1e3,
        "shipped_rows": int(ship.sum()), "bytes_out": sum(len(b) for b in serial),
        "finisher_s": finisher_s, "pipeline_s": pipeline_s, "python_finisher_s": python_s,
        "finisher_threads": serial_stats.threads, "finisher_rows": serial_stats.total_rows,
        "fallback_docs": fallback, "docs_equal_python_finisher": len(docs),
        "pipeline": {"sub": st.sub, "n_sub": st.n_sub, "depth": st.depth, "R": st.R,
                     "select_s": st.select_s, "stall_s": st.stall_s, "finish_s": st.finish_s,
                     "d2h_bytes": st.d2h_bytes, "syncs": st.syncs, "threads": st.threads},
        "sample_equal_cpu": READ_SAMPLE,
    }
    del state
    return out, min(enc_ms), bound_b / HBM_BYTES_PER_S * 1e3


def _b4_read(gpu, rep, log, plan, dev):
    """(d) `encode_diff_batch` on the B4 replay's final state (256 docs x
    65,536 slots) against an empty state vector and against the state
    vector of the first 130,000 updates' rows; docs 0 and 255 finished
    through the unit arena must be equal (same history) and equal to the
    CPU finisher's bytes. The unit arena has no native route: both docs
    are the Python finisher's, counted in ``fallback_docs``."""
    import numpy as np
    import torch

    from ytpu_torch.benches.sync_step import encode_diff_bound_bytes, stream_state_vector
    from ytpu_torch.models import batch_doc as bd
    from ytpu_torch.ops import integrate_kernel as ik
    from ytpu_torch.ops.decode_kernel import decode_updates_v1, pack_updates

    state = ik.unpack_state(rep.cols, rep.meta)
    tables = bd.EncoderTables.from_replay(rep)
    n = len(tables.interner)
    D, B = state.blocks.client.shape
    buf_np, lens_np = pack_updates(log[:B4_MID_UPDATES])
    stream, _ = decode_updates_v1(torch.from_numpy(buf_np).to(dev), torch.from_numpy(lens_np).to(dev),
                                  max_rows=plan.max_rows, max_dels=plan.max_dels,
                                  n_steps=plan.max_steps, max_sections=plan.max_sections)
    mid = stream_state_vector(stream, B4_MID_UPDATES, n)
    del stream
    bd.state_vectors(state, n)
    _, sv_ms = _event_ms(lambda: bd.state_vectors(state, n))
    out = {"docs": D, "capacity": B, "clients": n, "final_blocks_max": int(state.n_blocks.max()),
           "state_vectors_ms": sv_ms}
    for name, sv in (("empty", torch.zeros((D, n), dtype=torch.int32, device=dev)),
                     ("after_130000", mid.expand(D, n).contiguous())):
        bd.encode_diff_batch(state, sv, n)
        (ship, off, local_sv, dele), ms = _event_ms(lambda: bd.encode_diff_batch(state, sv, n))
        stats = bd.DiffStats()
        t0 = time.perf_counter()
        got = bd.finish_encode_diff_batch(state, [0, D - 1], ship, off, dele, tables, stats=stats)
        fin_s = time.perf_counter() - t0
        if got[0] != got[1]:
            raise RuntimeError(f"sync_step: B4 docs 0 and {D - 1} diff differently ({name})")
        _finish_check(state, [0, D - 1], ship, off, dele, tables, got)
        out[name] = {"encode_diff_batch_ms": ms, "shipped_rows_doc0": int(ship[0].sum()),
                     "deleted_rows_doc0": int(dele[0].sum()), "bytes": len(got[0]),
                     "finisher_s_2docs": fin_s, "fallback_docs": stats.fallback_docs}
    if out["after_130000"]["shipped_rows_doc0"] >= out["empty"]["shipped_rows_doc0"]:
        raise RuntimeError("sync_step: the mid-history state vector did not cut the diff")
    bound_b = encode_diff_bound_bytes(D, B, n)
    out["encode_diff_bound_ms"] = bound_b / HBM_BYTES_PER_S * 1e3
    return out


def phase_sync_step(gpu, log, plan, rep):
    """The sync step: (a) the write path at BASELINE config 2's width, (b)
    the per-doc kernel against its plain version, (c) the read path at
    config 5's width, (d) the read path on the B4 replay's final state
    `rep`. Returns the phase line."""
    import torch

    dev = torch.device("cuda")
    write = _write_path(gpu, log, plan, dev)
    torch.cuda.empty_cache()
    vs_plain = _batch_vs_plain(dev)
    read, enc_ms, enc_bound_ms = _read_path(gpu, dev)
    torch.cuda.empty_cache()
    b4 = _b4_read(gpu, rep, log, plan, dev)
    line = {"phase": "sync_step", "write": write, "kernel_vs_plain": vs_plain, "read": read,
            "b4_read": b4, "gpu": gpu}
    emit(line)
    return line


# ingest: the traced window of calls, and the step whose per-doc kernel
# inputs are held against the plain version (the config 4 docs' first
# XML element, the first row that names an anchored root)
INGEST_TRACED_FROM, INGEST_TRACED_STEPS = 256, 16
INGEST_SNAPSHOT_STEP = 5


def _cohort_equal(state, first: int, n: int) -> bool:
    """Every plane but content_ref (each doc keeps its own wire bytes), and
    start / n_blocks / error, of docs ``first .. first + n`` equal doc
    `first`'s: the docs of a cohort took the same updates."""
    import torch

    fields = [f for name, f in zip(state.blocks._fields, state.blocks) if name != "content_ref"]
    fields += [state.start, state.n_blocks, state.error]
    return all(torch.equal(f[first:first + n], f[first:first + 1].expand_as(f[first:first + n]))
               for f in fields)


def _b4_prefix_texts(b4, prefixes, capacity: int, dev, phase: str) -> dict:
    """``{n: text}``: the text of B4's first n updates for each n of
    `prefixes`, by a stream replay on the card (one decode of `b4`, then
    `apply_update_stream` of each prefix into one doc)."""
    import torch

    from ytpu_torch.models import batch_doc as bd
    from ytpu_torch.ops.decode_kernel import FLAG_ERRORS, RawPayloadView, decode_updates_v1, identity_rank, pack_updates

    buf_np, lens_np = pack_updates(b4)
    stream, flags = decode_updates_v1(torch.from_numpy(buf_np).to(dev), torch.from_numpy(lens_np).to(dev),
                                      max_rows=4, max_dels=4)
    if int(((flags & FLAG_ERRORS) != 0).sum()):
        raise RuntimeError(f"{phase}: decode flagged a B4 update of the reference replay")
    view = RawPayloadView(buf_np)
    rank = identity_rank(256, dev)
    out = {}
    for n in sorted(set(prefixes)):
        ref = bd.apply_update_stream(bd.init_state(1, capacity, dev), type(stream)(*(f[:n] for f in stream)), rank)
        out[n] = bd.get_string(ref, 0, view)
    return out


def phase_ingest(gpu, log, dev="cuda"):
    """One `BatchIngestor` at 1,024 docs x 8,192 slots on the card, one
    `apply_bytes` call per step over `benches/ingest.py`'s four cohorts
    (B4 text with lags and swapped pairs, config 4's map + XML, config 3's
    array, a 53-bit client's text). Counts are reset just before the calls
    and read just after; steps INGEST_TRACED_FROM.. run under
    `torch.profiler` (left out of the per-call times). Checks: every B4
    lag group's text equals a stream replay of its prefix on the card (the
    swapped docs too), each other cohort's docs hold the same columns and
    the committed values, no error, no stash, no recovery; then the
    per-doc kernel against its plain version on the captured inputs of step
    INGEST_SNAPSHOT_STEP."""
    import statistics

    import torch

    from ytpu_torch.benches import ingest as bench
    from ytpu_torch.models import batch_doc as bd
    from ytpu_torch.models import ingest as ingest_mod
    from ytpu_torch.ops import integrate_kernel as ik
    from ytpu_torch.ops.decode_kernel import decode_updates_v1

    dev = torch.device(dev)
    logs = bench.load_ingest_logs()
    b4 = log[: bench.INGEST_STEPS]
    ing = ingest_mod.BatchIngestor(bench.INGEST_DOCS, bench.INGEST_CAPACITY, device=dev)
    captured = {}
    real_apply = ingest_mod.apply_update_batch

    def capture(state, batch, rank):
        cols, meta = ik.pack_state(state)
        rows, dels = ik.pack_stream(batch)
        captured.update(cols=cols, meta=meta, rows=rows, dels=dels, rank=rank.clone())
        return real_apply(state, batch, rank)

    call_ms, traced_ms, lanes = [], [], []
    prof = None
    torch.cuda.synchronize()
    _reset_counts([ik.integrate_batch, ik.integrate_stream, decode_updates_v1])
    t_all = time.perf_counter()
    for t in range(bench.INGEST_STEPS):
        payloads = bench.step_payloads(t, b4, logs)
        before = (ing.fast_docs, ing.slow_docs, ing.fast_recoveries)
        traced = INGEST_TRACED_FROM <= t < INGEST_TRACED_FROM + INGEST_TRACED_STEPS
        if t == INGEST_TRACED_FROM:
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                      torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
            t_traced = time.perf_counter()
        ingest_mod.apply_update_batch = capture if t == INGEST_SNAPSHOT_STEP else real_apply
        t0 = time.perf_counter()
        ing.apply_bytes(payloads)
        torch.cuda.synchronize()
        (traced_ms if traced else call_ms).append((time.perf_counter() - t0) * 1e3)
        lanes.append(tuple(a - b for a, b in zip((ing.fast_docs, ing.slow_docs, ing.fast_recoveries), before)))
        if t == INGEST_TRACED_FROM + INGEST_TRACED_STEPS - 1:
            traced_s = time.perf_counter() - t_traced
            prof.__exit__(None, None, None)
    ingest_mod.apply_update_batch = real_apply
    wall = time.perf_counter() - t_all
    launches = {"batch": ik.integrate_batch.launches, "stream": ik.integrate_stream.launches}
    decode_launches = decode_updates_v1.launches
    fast_calls = sum(1 for f, _, _ in lanes if f)
    if launches != {"batch": bench.INGEST_STEPS, "stream": 0} or decode_launches < 1:
        raise RuntimeError(f"ingest: the calls made launches {launches}, {decode_launches} decode launches")

    # the checks
    err = int(ing.state.error.max())
    stash = [d for d in range(bench.INGEST_DOCS) if ing.pending_update(d) is not None
             or ing.pending_ds(d) is not None]
    if err or stash or ing.fast_recoveries:
        raise RuntimeError(f"ingest: error {err}, docs with a stash {stash[:8]}, "
                           f"recoveries {ing.fast_recoveries}")
    b4_docs = range(bench.COHORTS[0][1], bench.COHORTS[0][1] + bench.COHORTS[0][2])
    want = _b4_prefix_texts(b4, [bench.b4_prefix(g) for g in range(bench.LAG_GROUPS)], bench.INGEST_CAPACITY,
                            dev, "ingest")
    texts_bad = [d for d in b4_docs
                 if bd.get_string(ing.state, d, ing.payloads) != want[bench.b4_prefix(d % bench.LAG_GROUPS)]]
    if texts_bad:
        raise RuntimeError(f"ingest: B4 docs {texts_bad[:8]} differ from the stream replay of their prefix")
    values = {}
    for name, first, n in bench.COHORTS[1:]:
        if not _cohort_equal(ing.state, first, n):
            raise RuntimeError(f"ingest: the {name} docs hold different columns")
        expect = logs[name]["expect"]
        for d in (first, first + n - 1):
            if name == "map_xml":
                tree = bd.get_tree(ing.state, d, ing.payloads, ing.enc.keys)
                got = {"m": bench.root_map(tree, ing.primary_roots[d], "m"),
                       "x": bench.xml_string(ing.state, d, ing.payloads, ing.enc.keys, "x")}
            elif name == "array":
                got = bd.get_values(ing.state, d, ing.payloads)
            else:
                got = bd.get_string(ing.state, d, ing.payloads)
            if got != expect:
                raise RuntimeError(f"ingest: doc {d} of {name} does not hold the committed value")
        values[name] = {"docs": n, "blocks": int(ing.state.n_blocks[first])}

    # the pieces of a call from the traced window
    pieces = ("ingest.plan", "ingest.plan.walk", "ingest.plan.intern", "ingest.plan.host_lane", "ingest.decode",
              "decode.v1", "pack_state", "pack_stream", "integrate_batch", "unpack_state")
    trace, integrates, _ = _trace_breakdown(prof, traced_s, kernel="integrate_batch_kernel")
    _, indexes, _ = _trace_breakdown(prof, traced_s, kernel="integrate_batch_index_kernel")
    _, decodes, _ = _trace_breakdown(prof, traced_s, kernel=DECODE_KERNEL)
    decode_calls = _decode_calls(prof, "ingest")
    # one per-doc call a step (the launch count above): the window cannot be
    # run again, so records its trace lost are reported
    trace_missing = _kernel_records("ingest", prof, {"index": len(indexes), "integrate": len(integrates)},
                                    INGEST_TRACED_STEPS, ("integrate_batch",))
    device_ms = {k: trace["device_s"].get(k, 0.0) * 1e3 / INGEST_TRACED_STEPS for k in pieces + ("other",)}
    host_ms = {k: trace["host_s"].get(k, 0.0) * 1e3 / INGEST_TRACED_STEPS for k in pieces}
    index_ms = [ms for _, ms in indexes]
    kernel_ms = [ms for _, ms in integrates]
    del prof

    # the per-doc kernel against its plain version on the snapshot step
    c = captured
    cols_p, meta_p = c["cols"].clone(), c["meta"].clone()
    live = torch.arange(bench.INGEST_CAPACITY, device=dev)[None, :] < c["meta"][:, ik.M_NBLOCKS][:, None]
    valid = c["rows"][..., 14] == 1
    held = {"anchors": int(((c["cols"][ik.KD] == 12) & live).sum()),
            "anchor_rows": int((valid & (c["rows"][..., 22] >= 0)).sum()),
            "map_rows": int((valid & (c["rows"][..., 10] >= 0)).sum()),
            "big_client_rows": int((valid & torch.isin(c["rows"][..., 0], torch.tensor(
                [ing.enc.interner.to_idx[x] for x in ing.enc.interner.to_idx if x > 2**31 - 1],
                dtype=torch.int32, device=dev))).sum())}
    if not all(held.values()):
        raise RuntimeError(f"ingest: the snapshot step lacks a row shape: {held}")
    k_ms = _time_ms(lambda: ik.integrate_batch(c["cols"], c["meta"], c["rows"], c["dels"], c["rank"]))
    p_ms = _time_ms(lambda: ik.integrate_batch_reference(cols_p, meta_p, c["rows"], c["dels"], c["rank"]))
    snap_err = _compare("integrate_batch on the ingest snapshot step", c["cols"], c["meta"], cols_p, meta_p)
    del cols_p, meta_p, captured

    line = {
        "phase": "ingest", "docs": bench.INGEST_DOCS, "capacity": bench.INGEST_CAPACITY,
        "steps": bench.INGEST_STEPS,
        "cohorts": {name: n for name, _, n in bench.COHORTS},
        "b4_lag": f"(doc mod {bench.LAG_GROUPS}) * {bench.LAG_STEP}", "launches": launches,
        "decode_launches": decode_launches, "calls_with_fast_docs": fast_calls, "wall_s": wall,
        "ms_per_apply_bytes": statistics.fmean(call_ms), "ms_per_apply_bytes_median": statistics.median(call_ms),
        "ms_per_apply_bytes_min": min(call_ms), "ms_per_apply_bytes_max": max(call_ms),
        "ms_per_apply_bytes_traced": statistics.fmean(traced_ms),
        "traced_steps": f"{INGEST_TRACED_FROM}..{INGEST_TRACED_FROM + INGEST_TRACED_STEPS}",
        "host_plan_ms_per_call": host_ms["ingest.plan"], "host_ms_per_call": host_ms,
        "device_ms_per_call": device_ms, "index_kernel_ms": statistics.fmean(index_ms),
        "integrate_kernel_ms": statistics.fmean(kernel_ms),
        "decode_kernel_ms": statistics.fmean(ms for _, ms in decodes) if decodes else None,
        "decode_kernels_traced": len(decodes), "trace_records_missing": trace_missing,
        "decode_calls": decode_calls, "device_idle_share_traced": trace["device_idle_share"],
        "fast_docs_per_call": ing.fast_docs / bench.INGEST_STEPS,
        "slow_docs_per_call": ing.slow_docs / bench.INGEST_STEPS,
        "recovery_docs_per_call": ing.fast_recoveries / bench.INGEST_STEPS,
        "wire_bytes_per_call": ing.wire_bytes / bench.INGEST_STEPS,
        "retained_wire_bytes": ing.payloads.total_bytes, "interned_clients": len(ing.enc.interner),
        "keys": len(ing.enc.keys), "final_blocks_max": int(ing.state.n_blocks.max()),
        "cohort_values": values, "b4_texts_equal_stream_replay": True, "sticky_error": err,
        "snapshot_step": INGEST_SNAPSHOT_STEP, "snapshot_rows": held, "snapshot_kernel_ms": k_ms,
        "snapshot_plain_ms": p_ms, "max_abs_err": snap_err, "gpu": gpu,
    }
    emit(line)
    return line, ing


# sync server: the traced window of flush steps (rounds), the traced
# single-tenant replies, and the round whose per-doc kernel inputs are held
# against the plain version (fast docs and the swapped B4 docs' host lane)
SYNC_TRACED_FROM, SYNC_TRACED_STEPS = 20, 8
SYNC_TRACED_REPLIES = 8
SYNC_SNAPSHOT_STEP = 5
# two tenants of each cohort rebalanced in place after the middle round's
# flush, when a swapped B4 tenant holds a stash (tenant 56: lag 0, swapped);
# the other cohorts' last two, so each cohort's first tenants keep equal
# columns. At the end each re-ingest would decode thousands of steps.
SYNC_REBALANCED = (0, 56, 894, 895, 958, 959, 1022, 1023)


def _progress(t0: float, what: str) -> None:
    print(f"[{time.perf_counter() - t0:8.1f} s] {what}", file=sys.stderr, flush=True)


def _cpu_state(state):
    from ytpu_torch.models import batch_doc as bd

    return bd.DocStateBatch(bd.BlockCols(*(a.cpu() for a in state.blocks)),
                            *(a.cpu() for a in (state.start, state.n_blocks, state.error)))


def _cpu_finisher_replies(server, tenants, clocks):
    """The SyncStep2 payloads the CPU finisher writes for each tenant
    against state vector ``clocks[name]``, over a CPU copy of the server's
    device state: `encode_diff_batch`, then `finish_encode_diff_batch` per
    wire root name."""
    import torch

    from ytpu_torch.core.state_vector import StateVector
    from ytpu_torch.models import batch_doc as bd

    cpu = _cpu_state(server.ingestor.state)
    remote, n_clients = server._remote_matrix([(server.slot_of(t.name), StateVector(clocks[t.name]))
                                               for t in tenants])
    ship, off, _, dele = bd.encode_diff_batch(cpu, remote.cpu(), n_clients)
    groups = {}
    for t in tenants:
        groups.setdefault(server._root_names.get(t.name), []).append(t)
    out = {}
    for root, ts in groups.items():
        got = bd.finish_encode_diff_batch(cpu, [server.slot_of(t.name) for t in ts], ship, off, dele,
                                          server._tables(root))
        out.update({t.name: g for t, g in zip(ts, got)})
    del cpu, ship, off, dele
    torch.cuda.empty_cache()
    return out


def _traced_catch_up(new_server, tenants, fanout, pieces):
    """`benches.sync_server.catch_up` of a second fresh server from the
    fan-out, its stages on the host clock (the connects, the SyncStep2
    frames, the flush) and the flush under `torch.profiler`: host and
    device ms of each span in `pieces`."""
    import torch

    from ytpu_torch.benches import sync_server as bench

    t0 = time.perf_counter()
    fresh = new_server()
    sessions = [fresh.connect_frames(t.name)[0] for t in tenants]
    t1 = time.perf_counter()
    for t, session in zip(tenants, sessions):
        if fresh.receive_frames(session, bench._step2_frame(fanout[t.index])):
            raise RuntimeError(f"sync_server: the catch-up SyncStep2 of {t.name} got a reply")
    t2 = time.perf_counter()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        steps = fresh.flush_device()
        torch.cuda.synchronize()
    t3 = time.perf_counter()
    trace, _, _ = _trace_breakdown(prof, t3 - t2)
    out = {"s": t3 - t0, "connect_s": t1 - t0, "frames_s": t2 - t1, "flush_s": t3 - t2, "steps": steps,
           "flush_host_ms": {k: trace["host_s"].get(k, 0.0) * 1e3 for k in pieces},
           "flush_device_ms": {k: trace["device_s"].get(k, 0.0) * 1e3 for k in pieces + ("other",)},
           "flush_device_idle_share": trace["device_idle_share"]}
    del prof, fresh
    return out


def _bad_frames() -> int:
    """The port's process-wide ``net.bad_frames`` count (phases read it as
    a delta: the registry is shared by every server of the script)."""
    from ytpu_torch.utils.metrics import metrics

    return int(metrics.counter("net.bad_frames").value)


def phase_sync_server(gpu, log, dev="cuda"):
    """One device-authoritative `DeviceSyncServer` at 1,024 tenants x 8,192
    slots on the card (`benches/sync_server.py`'s `FULL` plan: the ingest
    phase's four cohorts, a writer and a reader session each), driven
    through its entry points: `connect_frames`, `receive_frames` with
    Update, SyncStep2 and SyncStep1 frames, `drain`, `flush_device`,
    `device_encode_diff_many`, `rebalance_tenant`. Counts are reset just
    before the write rounds and read after the fan-out; flush steps
    SYNC_TRACED_FROM.., replies SYNC_TRACED_REPLIES..2 * SYNC_TRACED_REPLIES
    and the rest's flush run under `torch.profiler` (left out of the
    per-step and per-reply times; the rest's flush is timed traced).
    After the middle round's flush a rebalance on the full batch must raise
    and move nothing, and eight in-place rebalances (SYNC_REBALANCED, one
    of them over a pending stash) must change no value, state vector or
    stash. Checks: every greeting's state vector is the device's at
    connection; each reader drained its writer's updates in order; B4
    texts equal stream replays of their prefix, each other cohort's
    tenants hold the same columns (the rebalanced ones aside) and the
    committed values; no error, stash or bad frame; every reply equals the
    CPU finisher's bytes over the same state, an empty state vector's also
    the fan-out's; a fresh server fed the fan-out as SyncStep2 frames and
    flushed once holds the same state vectors and values; the per-doc
    kernel equals its plain version on round SYNC_SNAPSHOT_STEP's inputs.
    Progress goes to stderr."""
    import statistics

    import torch

    from ytpu_torch.benches import ingest as ingest_bench
    from ytpu_torch.benches import sync_server as bench
    from ytpu_torch.core.state_vector import StateVector
    from ytpu_torch.models import ingest as ingest_mod
    from ytpu_torch.ops import integrate_kernel as ik
    from ytpu_torch.ops.decode_kernel import decode_updates_v1
    from ytpu_torch.sync import DeviceSyncServer
    from ytpu_torch.sync.protocol import Message, SyncMessage
    from ytpu_torch.core.doc import Doc
    from ytpu_torch.sync.server import DeviceBatchFull

    dev = torch.device(dev)
    plan = bench.FULL
    logs = ingest_bench.load_ingest_logs()
    tenants = bench.make_tenants(plan, log, logs)
    ids = {t.name: bench.tenant_client_id(t.index) for t in tenants}
    bad0 = _bad_frames()

    def new_server():
        return DeviceSyncServer(n_docs=plan.n_docs, capacity=plan.capacity, device_authoritative=True,
                                device=dev, doc_factory=lambda name: Doc(client_id=ids[name]))

    server = new_server()
    ing = server.ingestor
    captured, decode_captured = {}, {}
    real_apply, real_decode = ingest_mod.apply_update_batch, ingest_mod.decode_updates_v1
    capture_decode = _capture_decode(ingest_mod, decode_captured)

    def capture(state, batch, rank):
        cols, meta = ik.pack_state(state)
        rows, dels = ik.pack_stream(batch)
        captured.update(cols=cols, meta=meta, rows=rows, dels=dels, rank=rank.clone())
        return real_apply(state, batch, rank)

    step_ms, traced_ms, lanes, window = [], [], [], {}

    def flush(step):
        before = (ing.fast_docs, ing.slow_docs, ing.fast_recoveries)
        window["decode_before_rest"] = decode_updates_v1.launches
        traced = SYNC_TRACED_FROM <= step < SYNC_TRACED_FROM + SYNC_TRACED_STEPS
        if step == SYNC_TRACED_FROM:
            window["prof"] = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                                torch.profiler.ProfilerActivity.CUDA])
            window["prof"].__enter__()
            window["t0"] = time.perf_counter()
        ingest_mod.apply_update_batch = capture if step == SYNC_SNAPSHOT_STEP else real_apply
        ingest_mod.decode_updates_v1 = capture_decode if step == SYNC_SNAPSHOT_STEP else real_decode
        if step == plan.rounds:  # the rest's flush, under the profiler for its span breakdown
            window["rest"] = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                                torch.profiler.ProfilerActivity.CUDA])
            window["rest"].__enter__()
        gc_writes.flushing = True
        t0 = time.perf_counter()
        n = server.flush_device()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        gc_writes.flushing = False
        if step == plan.rounds:
            window["rest"].__exit__(None, None, None)
            window["rest_ms"] = ms
            window["rest_decode_launches"] = decode_updates_v1.launches - window["decode_before_rest"]
        else:
            (traced_ms if traced else step_ms).append(ms)
        ingest_mod.apply_update_batch = real_apply
        ingest_mod.decode_updates_v1 = real_decode
        lanes.append(tuple(a - b for a, b in zip((ing.fast_docs, ing.slow_docs, ing.fast_recoveries), before)))
        if step % 8 == 7:
            recent = (step_ms + traced_ms)[-8:]
            _progress(t_all, f"round {step}: {statistics.fmean(recent):.1f} ms a flush step over the last 8, "
                             f"lanes {lanes[-1]}, round wall {(time.perf_counter() - window['round_t0']) * 1e3:.0f} ms")
        window["round_t0"] = time.perf_counter()
        if step == SYNC_TRACED_FROM + SYNC_TRACED_STEPS - 1:
            window["write_s"] = time.perf_counter() - window["t0"]
            window["prof"].__exit__(None, None, None)
            window["write"] = window.pop("prof")
        return n

    reply_ms, reply_traced_ms = [], []

    def reply(session, frame):
        # the traced replies come after SYNC_TRACED_REPLIES untraced ones, so
        # that the finisher's first-call work (its payload and wire caches)
        # stays out of the trace
        k = len(reply_ms) + len(reply_traced_ms)
        traced = SYNC_TRACED_REPLIES <= k < 2 * SYNC_TRACED_REPLIES
        if k == SYNC_TRACED_REPLIES:
            window["prof"] = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                                torch.profiler.ProfilerActivity.CUDA])
            window["prof"].__enter__()
            window["t0"] = time.perf_counter()
        t0 = time.perf_counter()
        out = server.receive_frames(session, frame)
        torch.cuda.synchronize()
        (reply_traced_ms if traced else reply_ms).append((time.perf_counter() - t0) * 1e3)
        if k == 2 * SYNC_TRACED_REPLIES - 1:
            window["read_s"] = time.perf_counter() - window["t0"]
            window["prof"].__exit__(None, None, None)
            window["read"] = window.pop("prof")
        return out

    def tenant_state(t):
        p = ing.pending_update(t.index)
        return (server.slot_of(t.name), bench.tenant_value(server, t), server.device_state_vector(t.name),
                None if p is None else p.encode_v1())

    rebalance = {}

    def after_round(r):
        if r != plan.rounds // 2:
            return
        probe = tenants[SYNC_REBALANCED[0]]
        before = tenant_state(probe)
        try:
            server.rebalance_tenant(probe.name)
        except DeviceBatchFull:
            pass
        else:
            raise RuntimeError("sync_server: a rebalance found a free slot in a full batch")
        if tenant_state(probe) != before:
            raise RuntimeError("sync_server: a refused rebalance changed its tenant")
        rebalance["stashed"] = [tenants[i].name for i in SYNC_REBALANCED if ing.pending_update(i) is not None]
        t0 = time.perf_counter()
        for i in SYNC_REBALANCED:
            t = tenants[i]
            before = tenant_state(t)
            t1 = time.perf_counter()
            if server.rebalance_tenant(t.name, t.index) != t.index or tenant_state(t) != before:
                raise RuntimeError(f"sync_server: rebalancing {t.name} changed its value, state vector or stash")
            _progress(t_all, f"rebalanced {t.name} in {time.perf_counter() - t1:.2f} s")
        rebalance["s_per_tenant"] = (time.perf_counter() - t0) / len(SYNC_REBALANCED)
        _progress(t_all, f"rebalanced {len(SYNC_REBALANCED)} tenants after round {r}")

    torch.cuda.synchronize()
    _reset_counts([ik.integrate_batch, ik.integrate_stream, decode_updates_v1])
    with _GcPauses() as gc_writes:
        t_all = window["round_t0"] = time.perf_counter()
        run = bench.drive_writes(server, plan, tenants, flush=flush, after_round=after_round)
        write_s = time.perf_counter() - t_all
    _progress(t_all, f"writes: {plan.rounds} rounds, the rest flush {window['rest_ms']:.0f} ms")
    t0 = time.perf_counter()
    bench.drive_reads(server, run, tenants, reply=reply)
    read_s = time.perf_counter() - t0
    _progress(t_all, f"reads: {len(tenants)} replies")
    t0 = time.perf_counter()
    fanout = server.device_encode_diff_many([(t.name, StateVector()) for t in tenants])
    fanout_s = time.perf_counter() - t0
    _progress(t_all, "fan-out")
    launches = {"batch": ik.integrate_batch.launches, "stream": ik.integrate_stream.launches}
    decode_launches = decode_updates_v1.launches
    want_launches = plan.rounds + 1 + len(SYNC_REBALANCED)
    if launches != {"batch": want_launches, "stream": 0} or run.flush_steps != [1] * (plan.rounds + 1) \
            or decode_launches < 1 or window["rest_decode_launches"] < 1:
        raise RuntimeError(f"sync_server: flush steps {run.flush_steps} made launches {launches}, "
                           f"{decode_launches} decode launches ({window['rest_decode_launches']} in the rest)")
    if not rebalance.get("stashed"):
        raise RuntimeError("sync_server: no rebalanced tenant held a stash")

    # the checks of the write side
    for t in tenants:
        w, r = run.greetings[t.name]
        for g, sv in zip((w, r), run.connect_svs[t.name]):
            if g[0] != Message.sync(SyncMessage.step1(StateVector(sv))).encode_v1() or len(g) != 2:
                raise RuntimeError(f"sync_server: {t.name}'s greeting does not carry its device state vector")
        if run.drained[t.name] != run.sent[t.name] or run.writer_outbox[t.name]:
            raise RuntimeError(f"sync_server: {t.name}'s reader did not drain what its writer sent")
    if run.write_replies:
        raise RuntimeError(f"sync_server: writes got {len(run.write_replies)} replies")
    err = int(ing.state.error.max())
    stash = [t.name for t in tenants if ing.pending_update(t.index) is not None or ing.pending_ds(t.index) is not None]
    bad_frames = _bad_frames() - bad0
    if err or stash or ing.fast_recoveries or bad_frames:
        raise RuntimeError(f"sync_server: error {err}, tenants with a stash {stash[:8]}, recoveries "
                           f"{ing.fast_recoveries}, bad frames {bad_frames}")
    b4_tenants = [t for t in tenants if t.cohort == "b4"]
    want = _b4_prefix_texts(log[: plan.b4_len], [len(t.log) for t in b4_tenants], plan.capacity, dev, "sync_server")
    texts_bad = [t.name for t in b4_tenants if server.device_text(t.name) != want[len(t.log)]]
    if texts_bad:
        raise RuntimeError(f"sync_server: B4 tenants {texts_bad[:8]} differ from the stream replay of their log")
    values = {}
    for name, n in zip(bench.COHORT_NAMES[1:], plan.cohort_docs[1:]):
        first = [t.index for t in tenants if t.cohort == name][0]
        moved = [i for i in SYNC_REBALANCED if first <= i < first + n]
        if not _cohort_equal(ing.state, first, n - len(moved)):
            raise RuntimeError(f"sync_server: the {name} tenants hold different columns")
        for i in [first] + moved:
            if bench.tenant_value(server, tenants[i]) != logs[name]["expect"]:
                raise RuntimeError(f"sync_server: {tenants[i].name} does not hold the committed value")
        values[name] = {"tenants": n, "blocks": int(ing.state.n_blocks[first])}
    _progress(t_all, "write-side checks")

    # the read side: every reply against the CPU finisher, the empty state
    # vectors' also against the fan-out
    replies = {t.name: bench.step2_payload(run.step1_replies[t.name]) for t in tenants}
    clocks = {t.name: ({} if t.index % 2 == 0 else run.mid_svs[t.name]) for t in tenants}
    cpu_replies = _cpu_finisher_replies(server, tenants, clocks)
    bad = [t.name for t in tenants if replies[t.name] != cpu_replies[t.name]
           or (t.index % 2 == 0 and replies[t.name] != fanout[t.index])]
    if bad:
        raise RuntimeError(f"sync_server: replies of {bad[:8]} differ from the CPU finisher's or the fan-out's")
    _progress(t_all, "replies against the CPU finisher")

    # the pieces of a flush step and of a reply, from the traced windows
    write_pieces = ("sync.dispatch", "ingest.plan", "ingest.plan.walk", "ingest.plan.intern",
                    "ingest.plan.host_lane", "ingest.decode", "decode.v1", "pack_state", "pack_stream",
                    "integrate_batch", "unpack_state")
    read_pieces = ("encode_diff_batch", "state_vectors", "finisher")
    w_trace, integrates, _ = _trace_breakdown(window["write"], window["write_s"], kernel="integrate_batch_kernel")
    _, indexes, _ = _trace_breakdown(window["write"], window["write_s"], kernel="integrate_batch_index_kernel")
    _, decodes, _ = _trace_breakdown(window["write"], window["write_s"], kernel=DECODE_KERNEL)
    decode_calls = _decode_calls(window["write"], "sync_server")
    # one per-doc call a flush step (the launch counts): the window cannot
    # be run again, so records its trace lost are reported
    trace_missing = _kernel_records("sync_server", window["write"],
                                    {"index": len(indexes), "integrate": len(integrates)}, SYNC_TRACED_STEPS,
                                    ("integrate_batch",))
    r_trace, _, _ = _trace_breakdown(window["read"], window["read_s"])
    rest_trace, _, _ = _trace_breakdown(window["rest"], window["rest_ms"] / 1e3)
    _progress(t_all, "trace breakdowns")
    write_device_ms = {k: w_trace["device_s"].get(k, 0.0) * 1e3 / SYNC_TRACED_STEPS for k in write_pieces + ("other",)}
    write_host_ms = {k: w_trace["host_s"].get(k, 0.0) * 1e3 / SYNC_TRACED_STEPS for k in write_pieces}
    read_device_ms = {k: r_trace["device_s"].get(k, 0.0) * 1e3 / SYNC_TRACED_REPLIES for k in read_pieces + ("other",)}
    read_host_ms = {k: r_trace["host_s"].get(k, 0.0) * 1e3 / SYNC_TRACED_REPLIES for k in read_pieces}
    rest_host_ms = {k: rest_trace["host_s"].get(k, 0.0) * 1e3 for k in write_pieces}
    rest_device_ms = {k: rest_trace["device_s"].get(k, 0.0) * 1e3 for k in write_pieces + ("other",)}
    del window["write"], window["read"], window["rest"]

    # a fresh replica catches up from the fan-out
    t0 = time.perf_counter()
    fresh = new_server()
    catch_up_decodes = decode_updates_v1.launches
    catch_up_steps = bench.catch_up(fresh, tenants, {t.name: fanout[t.index] for t in tenants})
    torch.cuda.synchronize()
    catch_up_s = time.perf_counter() - t0
    catch_up_decodes = decode_updates_v1.launches - catch_up_decodes
    _progress(t_all, f"catch-up flush: {catch_up_s:.1f} s, lanes fast {fresh.ingestor.fast_docs} "
                     f"slow {fresh.ingestor.slow_docs}")
    # every state vector and text; the values of each cohort's first and
    # last tenant (the config 4 XML render walks every row per element)
    bad = [t.name for t in tenants if fresh.device_state_vector(t.name) != server.device_state_vector(t.name)
           or fresh.device_text(t.name) != server.device_text(t.name)]
    for name in bench.COHORT_NAMES:
        ts = [t for t in tenants if t.cohort == name]
        bad += [t.name for t in (ts[0], ts[-1]) if bench.tenant_value(fresh, t) != bench.tenant_value(server, t)]
    if catch_up_steps != 1 or bad or int(fresh.ingestor.state.error.max()):
        raise RuntimeError(f"sync_server: the catch-up took {catch_up_steps} steps; tenants {bad[:8]} differ")
    _progress(t_all, "catch-up")
    del fresh
    torch.cuda.empty_cache()
    catch_up_traced = _traced_catch_up(new_server, tenants, fanout, write_pieces)
    if catch_up_traced["steps"] != 1:
        raise RuntimeError(f"sync_server: the traced catch-up took {catch_up_traced['steps']} steps")
    _progress(t_all, f"traced catch-up: {catch_up_traced['s']:.1f} s")
    torch.cuda.empty_cache()

    # the per-doc kernel against its plain version on the snapshot round
    c = captured
    snap_lanes = lanes[SYNC_SNAPSHOT_STEP]
    if not (snap_lanes[0] and snap_lanes[1]):
        raise RuntimeError(f"sync_server: round {SYNC_SNAPSHOT_STEP} had fast / slow / recovered docs {snap_lanes}")
    cols_p, meta_p = c["cols"].clone(), c["meta"].clone()
    k_ms = _time_ms(lambda: ik.integrate_batch(c["cols"], c["meta"], c["rows"], c["dels"], c["rank"]))
    p_ms = _time_ms(lambda: ik.integrate_batch_reference(cols_p, meta_p, c["rows"], c["dels"], c["rank"]))
    snap_err = _compare("integrate_batch on the sync_server snapshot round", c["cols"], c["meta"], cols_p, meta_p)
    del cols_p, meta_p, captured
    # the decode kernel against its plain version on the same round's fast lanes
    if not decode_captured:
        raise RuntimeError(f"sync_server: round {SYNC_SNAPSHOT_STEP} made no fast-lane decode call")
    decode_vs_plain, decode_args = _decode_vs_plain("sync_server round", **decode_captured)
    decode_vs_plain["step"] = SYNC_SNAPSHOT_STEP
    del decode_captured

    n_steps = plan.rounds
    lanes_rest = lanes.pop()
    line = {
        "phase": "sync_server", "tenants": plan.n_docs, "capacity": plan.capacity, "rounds": plan.rounds,
        "cohorts": dict(zip(bench.COHORT_NAMES, plan.cohort_docs)),
        "b4_lag": f"(tenant mod {plan.lag_groups}) * {plan.lag_step} rounds", "launches": launches,
        "decode_launches": decode_launches, "decode_launches_rest": window["rest_decode_launches"],
        "decode_launches_catch_up": catch_up_decodes, "write_s": write_s, "read_s": read_s,
        "ms_per_flush_step": statistics.fmean(step_ms), "ms_per_flush_step_median": statistics.median(step_ms),
        "ms_per_flush_step_min": min(step_ms), "ms_per_flush_step_max": max(step_ms),
        "ms_rest_flush_step": window["rest_ms"], "ms_per_flush_step_traced": statistics.fmean(traced_ms),
        "gc_during_writes": gc_writes.summary(),
        "traced_steps": f"{SYNC_TRACED_FROM}..{SYNC_TRACED_FROM + SYNC_TRACED_STEPS}",
        "ms_per_reply": statistics.fmean(reply_ms), "ms_per_reply_median": statistics.median(reply_ms),
        "ms_per_reply_min": min(reply_ms), "ms_per_reply_max": max(reply_ms),
        "ms_per_reply_traced": statistics.fmean(reply_traced_ms),
        "fanout_s": fanout_s,
        "reply_bytes": sum(len(v) for v in replies.values()),
        "frames_broadcast": sum(len(v) for v in run.drained.values()),
        "updates_applied": server.applied_local,
        "fast_docs_per_step": sum(f for f, _, _ in lanes) / n_steps,
        "slow_docs_per_step": sum(s_ for _, s_, _ in lanes) / n_steps,
        "recovery_docs_per_step": sum(r for _, _, r in lanes) / n_steps,
        "lanes_rest_step": lanes_rest, "wire_bytes": ing.wire_bytes,
        "write_host_ms_per_step": write_host_ms, "write_device_ms_per_step": write_device_ms,
        "index_kernel_ms": statistics.fmean(ms for _, ms in indexes),
        "integrate_kernel_ms": statistics.fmean(ms for _, ms in integrates),
        "decode_kernel_ms": statistics.fmean(ms for _, ms in decodes) if decodes else None,
        "decode_kernels_traced": len(decodes), "trace_records_missing": trace_missing,
        "decode_calls": decode_calls, "write_device_idle_share_traced": w_trace["device_idle_share"],
        "read_host_ms_per_reply": read_host_ms, "read_device_ms_per_reply": read_device_ms,
        "read_device_idle_share_traced": r_trace["device_idle_share"],
        "rest_flush_traced": {"host_ms": rest_host_ms, "device_ms": rest_device_ms,
                              "device_idle_share": rest_trace["device_idle_share"]},
        "catch_up_s": catch_up_s, "catch_up_traced": catch_up_traced,
        "fallback_docs": server.fallback_docs,
        "rebalanced": [tenants[i].name for i in SYNC_REBALANCED],
        "rebalanced_with_stash": rebalance["stashed"], "rebalance_s_per_tenant": rebalance["s_per_tenant"],
        "cohort_values": values, "b4_texts_equal_stream_replay": True, "replies_equal_cpu_finisher": True,
        "catch_up_equal": True, "sticky_error": err,
        "snapshot_step": SYNC_SNAPSHOT_STEP, "snapshot_lanes": snap_lanes, "snapshot_kernel_ms": k_ms,
        "snapshot_plain_ms": p_ms, "max_abs_err": snap_err, "decode_vs_plain": decode_vs_plain, "gpu": gpu,
    }
    emit(line)
    del ing
    return line, decode_args, server


# mirrored sync server: the round whose per-doc kernel inputs are held
# against the plain version; the tenants of each cohort (by their position
# in it) released to the host, and the ones rebalanced in place at the end
# (the batch is full again once late tenants take the released slots)
MIRRORED_SNAPSHOT_STEP = 5
MIRRORED_RELEASED_AT = (1, 2)
MIRRORED_REBALANCED_AT = (3, 0)


def _cohort_picks(plan, positions):
    """Tenant indices: the given positions within each cohort of `plan`."""
    out, first = [], 0
    for n in plan.cohort_docs:
        out += [first + p for p in positions]
        first += n
    return out


def phase_sync_server_mirrored(gpu, log):
    """One `DeviceSyncServer` in its default, mirrored mode at 1,024 tenants
    x 8,192 slots on the card, on the sync-server phase's `FULL` plan: each
    tenant's host `Doc` (the port's host CRDT) answers the protocol, and
    an update observer queues each host transaction's update to the
    tenant's slot, so every flush step is one `apply_bytes` call (the
    decode kernel, then the per-doc integrate kernel). Counts are reset
    just before the write rounds and read after the rebalances. Checks:
    the greetings carry the host docs' state vectors; each reader drained
    exactly the updates its tenant's host doc sent to the device, and
    their merge rebuilds the host doc; every host doc holds its committed
    log's value (B4: the stream replay's text of its prefix); the device
    shadows every host doc (state vector, rendered value, and the fan-out
    reply applied to a fresh doc); every SyncStep1 reply is the host
    doc's state and rebuilds it; the MIRRORED_RELEASED_AT tenants of each
    cohort leave their
    slots for late tenants, keep serving from their host docs and queue
    nothing; the MIRRORED_REBALANCED_AT tenants keep their device state; a
    checkpoint round trip keeps every host doc's value, state vector and
    greeting, its bytes those of a fresh doc given the saved state; the
    per-doc kernel equals its plain version on round
    MIRRORED_SNAPSHOT_STEP's inputs, the decode kernel on its fast lanes.
    Progress goes to stderr."""
    import shutil
    import statistics
    import tempfile
    import types

    import torch

    from ytpu_torch.benches import ingest as ingest_bench
    from ytpu_torch.benches import sync_server as bench
    from ytpu_torch.core.doc import Doc
    from ytpu_torch.core.state_vector import StateVector
    from ytpu_torch.core.update import merge_updates_v1
    from ytpu_torch.models import ingest as ingest_mod
    from ytpu_torch.models.checkpoint import load_device_server, save_device_server
    from ytpu_torch.ops import integrate_kernel as ik
    from ytpu_torch.ops.decode_kernel import decode_updates_v1
    from ytpu_torch.sync import DeviceSyncServer
    from ytpu_torch.sync.protocol import Message, SyncMessage

    dev = torch.device("cuda")
    plan = bench.FULL
    released, rebalanced = _cohort_picks(plan, MIRRORED_RELEASED_AT), _cohort_picks(plan, MIRRORED_REBALANCED_AT)
    logs = ingest_bench.load_ingest_logs()
    tenants = bench.make_tenants(plan, log, logs)
    ids = {t.name: bench.tenant_client_id(t.index) for t in tenants}
    late = [f"late-{k}" for k in range(len(released))]
    ids.update({name: 200_000 + k for k, name in enumerate(late)})

    def factory(name):
        return Doc(client_id=ids[name])

    bad0 = _bad_frames()
    server = DeviceSyncServer(n_docs=plan.n_docs, capacity=plan.capacity, device=dev, doc_factory=factory)
    if server.device_authoritative:
        raise RuntimeError("sync_server_mirrored: the default DeviceSyncServer is not mirrored")
    ing = server.ingestor

    # what each host doc's update observer queued to the device, in order
    mirrored = {t.name: [] for t in tenants}
    for t in tenants:
        server.tenant(t.name)
        server.doc(t.name).observe_update_v1(lambda p, o, txn, _n=t.name: mirrored[_n].append(p))
    # the host side of every frame: `receive_frames` (the host apply, the
    # broadcast and the mirror's enqueue)
    host_s = {"rounds": 0.0, "rest": 0.0}
    real_receive = server.receive_frames
    stage = {"part": "rounds"}

    def receive(session, frame):
        t0 = time.perf_counter()
        out = real_receive(session, frame)
        host_s[stage["part"]] += time.perf_counter() - t0
        return out

    server.receive_frames = receive
    # one decode launch per `apply_bytes` call with fast docs, one per-doc
    # integrate launch per call
    calls = []
    real_apply_bytes = ing.apply_bytes

    def apply_bytes(payloads):
        before = ing.fast_docs
        out = real_apply_bytes(payloads)
        calls.append(ing.fast_docs - before)
        return out

    ing.apply_bytes = apply_bytes
    captured, decode_captured = {}, {}
    real_apply, real_decode = ingest_mod.apply_update_batch, ingest_mod.decode_updates_v1
    capture_decode = _capture_decode(ingest_mod, decode_captured)

    def capture(state, batch, rank):
        cols, meta = ik.pack_state(state)
        rows, dels = ik.pack_stream(batch)
        captured.update(cols=cols, meta=meta, rows=rows, dels=dels, rank=rank.clone())
        return real_apply(state, batch, rank)

    step_ms, lanes, window = [], [], {}

    def flush(step):
        before = (ing.fast_docs, ing.slow_docs, ing.fast_recoveries)
        ingest_mod.apply_update_batch = capture if step == MIRRORED_SNAPSHOT_STEP else real_apply
        ingest_mod.decode_updates_v1 = capture_decode if step == MIRRORED_SNAPSHOT_STEP else real_decode
        gc_writes.flushing = True
        t0 = time.perf_counter()
        n = server.flush_device()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        gc_writes.flushing = False
        ingest_mod.apply_update_batch, ingest_mod.decode_updates_v1 = real_apply, real_decode
        if step == plan.rounds:
            window["rest_ms"] = ms
        else:
            step_ms.append(ms)
            stage["part"] = "rest" if step == plan.rounds - 1 else "rounds"
        lanes.append(tuple(a - b for a, b in zip((ing.fast_docs, ing.slow_docs, ing.fast_recoveries), before)))
        if step % 8 == 7:
            _progress(t_all, f"mirrored round {step}: {statistics.fmean(step_ms[-8:]):.1f} ms a flush step")
        return n

    # the B4 tenants' texts by stream replays of their prefixes, before the
    # counts are reset (the replays launch the decode and stream kernels)
    want_b4 = _b4_prefix_texts(log[: plan.b4_len], [len(t.log) for t in tenants if t.cohort == "b4"],
                               plan.capacity, dev, "sync_server_mirrored")
    torch.cuda.synchronize()
    _reset_counts([ik.integrate_batch, ik.integrate_stream, decode_updates_v1])
    with _GcPauses() as gc_writes:
        t_all = time.perf_counter()
        run = bench.drive_writes(server, plan, tenants, flush=flush)
        write_s = time.perf_counter() - t_all
    server.receive_frames = real_receive
    _progress(t_all, f"mirrored writes: {plan.rounds} rounds, the rest's flush {window['rest_ms']:.0f} ms")

    # the write side: greetings, the readers' broadcasts, the host docs
    empty_step1 = Message.sync(SyncMessage.step1(StateVector())).encode_v1()
    committed = {name: logs[name]["expect"] for name in bench.COHORT_NAMES[1:]}
    host_values = {}
    for t in tenants:
        if any(g[0] != empty_step1 or len(g) != 2 for g in run.greetings[t.name]):
            raise RuntimeError(f"sync_server_mirrored: {t.name}'s greeting is not its empty host doc's")
        if run.drained[t.name] != mirrored[t.name] or run.writer_outbox[t.name]:
            raise RuntimeError(f"sync_server_mirrored: {t.name}'s reader did not drain what the host doc sent")
        doc = server.doc(t.name)
        value = host_values[t.name] = bench.host_value(doc, t)
        want = want_b4[len(t.log)] if t.cohort == "b4" else committed[t.cohort]
        if value != want:
            raise RuntimeError(f"sync_server_mirrored: {t.name}'s host doc does not hold its committed value")
    bad_frames = _bad_frames() - bad0
    if run.write_replies or bad_frames:
        raise RuntimeError(f"sync_server_mirrored: {len(run.write_replies)} write replies, "
                           f"{bad_frames} bad frames")
    for name in bench.COHORT_NAMES:  # each cohort's first and last reader: the drained merge rebuilds the doc
        ts = [t for t in tenants if t.cohort == name]
        for t in (ts[0], ts[-1]):
            d = Doc(client_id=1)
            d.apply_update_v1(merge_updates_v1(run.drained[t.name]))
            if bench.host_value(d, t) != host_values[t.name] or d.state_vector() != server.doc(t.name).state_vector():
                raise RuntimeError(f"sync_server_mirrored: {t.name}'s drained updates do not rebuild its host doc")
    _progress(t_all, "mirrored write-side checks")

    # the device shadows the host docs: state vectors, rendered values (from
    # a CPU copy of the device state) and the fan-out
    err = int(ing.state.error.max())
    cpu = types.SimpleNamespace(ingestor=types.SimpleNamespace(
        state=_cpu_state(ing.state), payloads=ing.payloads, enc=ing.enc, primary_roots=ing.primary_roots),
        slot_of=server.slot_of)
    t0 = time.perf_counter()
    bad = [t.name for t in tenants if server.device_state_vector(t.name) != server.doc(t.name).state_vector()
           or bench.tenant_value(cpu, t) != host_values[t.name]]
    render_s = time.perf_counter() - t0
    del cpu
    if err or bad:
        raise RuntimeError(f"sync_server_mirrored: error {err}; the device differs from the host doc of {bad[:8]}")
    t0 = time.perf_counter()
    fanout = server.device_encode_diff_many([(t.name, StateVector()) for t in tenants])
    torch.cuda.synchronize()
    fanout_s = time.perf_counter() - t0
    bad = []
    for t in tenants:
        d = Doc(client_id=2)
        d.apply_update_v1(fanout[t.index])
        if bench.host_value(d, t) != host_values[t.name] or d.state_vector() != server.doc(t.name).state_vector():
            bad.append(t.name)
    if bad:
        raise RuntimeError(f"sync_server_mirrored: the fan-out of {bad[:8]} does not rebuild the host doc")
    _progress(t_all, "mirrored device-shadow checks")

    # the reads: a SyncStep1 with the empty state vector from every reader,
    # answered from the host doc
    reply_ms, bad = [], []
    for t in tenants:
        t0 = time.perf_counter()
        frames = server.receive_frames(run.sessions[t.name][1], bench._step1_frame({}))
        reply_ms.append((time.perf_counter() - t0) * 1e3)
        payload = bench.step2_payload(frames)
        d = Doc(client_id=3)
        d.apply_update_v1(payload)
        if payload != server.doc(t.name).encode_state_as_update_v1() or bench.host_value(d, t) != host_values[t.name]:
            bad.append(t.name)
    greet_bad = []
    for t in tenants:  # a second greeting carries the host doc's state vector now
        session, frames = server.connect_frames(t.name)
        if frames[0] != Message.sync(SyncMessage.step1(server.doc(t.name).state_vector())).encode_v1():
            greet_bad.append(t.name)
        server.disconnect(session)
    if bad or greet_bad:
        raise RuntimeError(f"sync_server_mirrored: replies of {bad[:8]}, greetings of {greet_bad[:8]} "
                           "differ from their host docs")
    _progress(t_all, "mirrored reads")

    # releases: the slot goes to a late tenant; the released tenant serves
    # SyncStep1 and writes from its host doc and queues nothing
    release_ms = []
    freed = []
    for k, i in enumerate(released):
        t = tenants[i]
        slot = server.slot_of(t.name)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        server.release_tenant(t.name)
        torch.cuda.synchronize()
        release_ms.append((time.perf_counter() - t0) * 1e3)
        freed.append(slot)
        doc = server.doc(t.name)
        if (t.name in server._slot_of or t.name not in server._host_tenants or slot not in server._free_slots
                or bench.host_value(doc, t) != host_values[t.name]):
            raise RuntimeError(f"sync_server_mirrored: releasing {t.name} kept its slot or changed its doc")
        writer, reader = run.sessions[t.name]
        reply = bench.step2_payload(server.receive_frames(reader, bench._step1_frame({})))
        if reply != doc.encode_state_as_update_v1():
            raise RuntimeError(f"sync_server_mirrored: released {t.name}'s SyncStep1 reply is not its host doc's")
        c = Doc(client_id=300_000 + k)
        c.apply_update_v1(reply)
        root = next(iter(c.store.types))
        with c.transact() as txn:
            if t.cohort == "array":
                c.get_array(root).insert(txn, 0, "after release")
            elif t.cohort == "map_xml":
                c.get_map("m").insert(txn, "released", k)
            else:
                c.get_text(root).insert(txn, 0, "after release ")
        server.receive_frames(writer, bench._update_frame(c.encode_state_as_update_v1(doc.state_vector())))
        if (server.pending_device_updates() or len(server.drain(reader)) != 1
                or bench.host_value(doc, t) != bench.host_value(c, t)):
            raise RuntimeError(f"sync_server_mirrored: a write to released {t.name} did not stay on its host doc")
    late_sessions = {}
    for k, name in enumerate(late):  # late tenants take the freed slots and write to the device
        late_sessions[name] = server.connect_frames(name)[0]
        c = Doc(client_id=ids[name])
        with c.transact() as txn:
            c.get_text("text").insert(txn, 0, f"late tenant {k}")
        server.receive_frames(late_sessions[name], bench._update_frame(c.encode_state_as_update_v1()))
    late_steps = server.flush_device()
    if sorted(server.slot_of(n) for n in late) != sorted(freed) or late_steps != 1 or any(
            server.device_state_vector(n) != server.doc(n).state_vector()
            or server.device_text(n) != f"late tenant {k}" for k, n in enumerate(late)):
        raise RuntimeError("sync_server_mirrored: the late tenants did not take the released slots")
    _progress(t_all, "mirrored releases")

    # rebalances in place (the batch is full again): state vectors and the
    # values rendered from CPU copies of the device state before and after
    def device_values():
        view = types.SimpleNamespace(ingestor=types.SimpleNamespace(
            state=_cpu_state(ing.state), payloads=ing.payloads, enc=ing.enc, primary_roots=ing.primary_roots),
            slot_of=server.slot_of)
        return {i: (server.device_state_vector(tenants[i].name), bench.tenant_value(view, tenants[i]))
                for i in rebalanced}

    before = device_values()
    rebalance_ms = []
    for i in rebalanced:
        t = tenants[i]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        slot = server.rebalance_tenant(t.name, server.slot_of(t.name))
        torch.cuda.synchronize()
        rebalance_ms.append((time.perf_counter() - t0) * 1e3)
        if slot != t.index:
            raise RuntimeError(f"sync_server_mirrored: rebalancing {t.name} in place moved it to slot {slot}")
    after = device_values()
    bad = [tenants[i].name for i in rebalanced if after[i] != before[i]
           or after[i] != (server.doc(tenants[i].name).state_vector(), host_values[tenants[i].name])]
    if bad:
        raise RuntimeError(f"sync_server_mirrored: rebalancing {bad} changed their device state")
    launches = {"batch": ik.integrate_batch.launches, "stream": ik.integrate_stream.launches}
    decode_launches = decode_updates_v1.launches
    want_decodes = sum(1 for f in calls if f)
    if launches != {"batch": len(calls), "stream": 0} or decode_launches != want_decodes \
            or sum(run.flush_steps) + late_steps + len(rebalanced) != len(calls):
        raise RuntimeError(f"sync_server_mirrored: {len(calls)} apply_bytes calls ({want_decodes} with fast docs), "
                           f"flush steps {run.flush_steps}, launches {launches}, {decode_launches} decode launches")
    _progress(t_all, "mirrored rebalances")

    # a checkpoint round trip of the mirrored server
    tmp = tempfile.mkdtemp(prefix="ytpu_torch_mirrored_")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_device_server(os.path.join(tmp, "server"), server)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored = load_device_server(os.path.join(tmp, "server"), device=dev, doc_factory=factory)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        ckpt_bytes = _dir_bytes(os.path.join(tmp, "server"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    names = [t.name for t in tenants] + late

    def restored_wrong(n):
        # a doc rebuilt from its state update squashes its blocks in one
        # transaction, so it encodes as a fresh doc given the saved state
        # does (ytpu's too), not as the incrementally built original
        fresh = Doc(client_id=4)
        fresh.apply_update_v1(server.doc(n).encode_state_as_update_v1())
        got = restored.doc(n)
        return (got.encode_state_as_update_v1() != fresh.encode_state_as_update_v1()
                or got.to_json() != server.doc(n).to_json() or got.state_vector() != server.doc(n).state_vector()
                or restored.connect_frames(n)[1][0] != Message.sync(SyncMessage.step1(
                    server.doc(n).state_vector())).encode_v1())

    bad = [n for n in names if restored_wrong(n)]
    if bad or restored.device_authoritative or restored._slot_of != server._slot_of \
            or restored._host_tenants != server._host_tenants:
        raise RuntimeError(f"sync_server_mirrored: the restored server differs for {bad[:8]}")
    del restored
    torch.cuda.empty_cache()
    _progress(t_all, "mirrored checkpoint")

    # the per-doc kernel and the decode kernel against their plain versions
    # on the snapshot round's captured inputs
    c = captured
    snap_lanes = lanes[MIRRORED_SNAPSHOT_STEP]
    if not c or not snap_lanes[0]:
        raise RuntimeError(f"sync_server_mirrored: round {MIRRORED_SNAPSHOT_STEP} had lanes {snap_lanes}")
    cols_p, meta_p = c["cols"].clone(), c["meta"].clone()
    k_ms = _time_ms(lambda: ik.integrate_batch(c["cols"], c["meta"], c["rows"], c["dels"], c["rank"]))
    p_ms = _time_ms(lambda: ik.integrate_batch_reference(cols_p, meta_p, c["rows"], c["dels"], c["rank"]))
    snap_err = _compare("integrate_batch on the sync_server_mirrored snapshot round", c["cols"], c["meta"],
                        cols_p, meta_p)
    del cols_p, meta_p, captured
    if not decode_captured:
        raise RuntimeError(f"sync_server_mirrored: round {MIRRORED_SNAPSHOT_STEP} made no fast-lane decode call")
    decode_vs_plain, decode_args = _decode_vs_plain("sync_server_mirrored round", **decode_captured)
    decode_vs_plain["step"] = MIRRORED_SNAPSHOT_STEP
    del decode_captured

    n_updates = sum(len(t.log) for t in tenants)
    rest_lanes = lanes[plan.rounds]
    line = {
        "phase": "sync_server_mirrored", "tenants": plan.n_docs, "capacity": plan.capacity, "rounds": plan.rounds,
        "cohorts": dict(zip(bench.COHORT_NAMES, plan.cohort_docs)), "launches": launches,
        "decode_launches": decode_launches, "apply_bytes_calls": len(calls), "flush_steps": sum(run.flush_steps),
        "write_s": write_s,
        "ms_per_flush_step": statistics.fmean(step_ms), "ms_per_flush_step_median": statistics.median(step_ms),
        "ms_per_flush_step_min": min(step_ms), "ms_per_flush_step_max": max(step_ms),
        "rest_flush_s": window["rest_ms"] / 1e3, "rest_lanes": rest_lanes, "gc_during_writes": gc_writes.summary(),
        "host_receive_s": host_s, "updates_sent": n_updates,
        "host_apply_us_per_update": (host_s["rounds"] + host_s["rest"]) / n_updates * 1e6,
        "host_updates_mirrored": sum(len(v) for v in mirrored.values()),
        "mirrored_bytes": sum(len(p) for v in mirrored.values() for p in v),
        "ms_per_reply": statistics.fmean(reply_ms), "ms_per_reply_median": statistics.median(reply_ms),
        "ms_per_release": statistics.fmean(release_ms), "ms_per_rebalance": statistics.fmean(rebalance_ms),
        "fanout_s": fanout_s, "device_render_s": render_s,
        "fast_docs_per_step": sum(f for f, _, _ in lanes[: plan.rounds]) / plan.rounds,
        "slow_docs_per_step": sum(s_ for _, s_, _ in lanes[: plan.rounds]) / plan.rounds,
        "recovery_docs": sum(r for _, _, r in lanes),
        "released": [tenants[i].name for i in released], "rebalanced": [tenants[i].name for i in rebalanced],
        "checkpoint": {"save_s": save_s, "load_s": load_s, "bytes_on_disk": ckpt_bytes, "tenants": len(names)},
        "host_values_equal_committed": True, "device_equals_host": True, "fanout_rebuilds_host": True,
        "replies_equal_host": True, "sticky_error": err,
        "snapshot_step": MIRRORED_SNAPSHOT_STEP, "snapshot_lanes": snap_lanes, "snapshot_kernel_ms": k_ms,
        "snapshot_plain_ms": p_ms, "max_abs_err": snap_err, "decode_vs_plain": decode_vs_plain, "gpu": gpu,
    }
    emit(line)
    del ing, server
    return line, decode_args


def _diag_cases():
    from ytpu_torch.benches import mosaic_ladder, plane_rmw_repro, plane_rmw_repro2, plane_rmw_repro3

    return mosaic_ladder.CASES + plane_rmw_repro.CASES + plane_rmw_repro2.CASES + plane_rmw_repro3.CASES


class _GcPauses:
    """Python's garbage-collector runs and pause ms by generation while
    open (`gc.callbacks`), in all and inside the windows where `flushing`
    is set: host time that no profiler span names, which a full
    collection over the script's heap puts into single flush steps."""

    def __enter__(self):
        import gc

        self.objects = len(gc.get_objects())
        self.flushing, self._t = False, None
        self.runs, self.ms, self.runs_in_flush, self.ms_in_flush = [0] * 3, [0.0] * 3, [0] * 3, [0.0] * 3
        self.max_ms = 0.0
        gc.callbacks.append(self._on_gc)
        return self

    def _on_gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            ms, g = (time.perf_counter() - self._t) * 1e3, info["generation"]
            self._t = None
            self.runs[g] += 1
            self.ms[g] += ms
            self.max_ms = max(self.max_ms, ms)
            if self.flushing:
                self.runs_in_flush[g] += 1
                self.ms_in_flush[g] += ms

    def __exit__(self, *exc):
        import gc

        gc.callbacks.remove(self._on_gc)

    def summary(self):
        return {"objects_tracked_at_start": self.objects, "runs": self.runs, "pause_ms": self.ms,
                "max_pause_ms": self.max_ms, "runs_in_flush": self.runs_in_flush, "pause_ms_in_flush": self.ms_in_flush}


def _reset_counts(wrappers):
    for w in wrappers:
        w.launches = 0


def phase_mosaic_ladder(gpu, dev="cuda"):
    """The ladder's main path: rungs 0-7 launch their CUDA kernels (each
    held against the JAX rung's assert and its plain version), rungs 8-10
    the integrate kernel through `apply_update_stream_fused` on the
    committed logs. Each rung's name goes to stderr before it launches."""
    from ytpu_torch.benches import mosaic_ladder
    from ytpu_torch.ops import integrate_kernel as ik
    from ytpu_torch.ops.decode_kernel import decode_updates_v1

    wrappers = [fn for _, fn, *_ in mosaic_ladder.RUNGS]
    _reset_counts(wrappers + [ik.integrate_stream, decode_updates_v1])
    state = mosaic_ladder.run_ladder(
        dev, on_attempt=lambda name: print(f"mosaic_ladder: attempting {name}", file=sys.stderr,
                                              flush=True))
    launches = {w.__name__: w.launches for w in wrappers}
    launches["integrate_stream"] = ik.integrate_stream.launches
    launches["decode_updates_v1"] = decode_updates_v1.launches
    emit({"phase": "mosaic_ladder", "steps": state["steps"], "failures": state["failures"],
          "launches": launches, "gpu": gpu})
    if state["failures"]:
        raise RuntimeError(f"mosaic_ladder: rungs failed: {state['failures']}")
    idle = [name for name, n in launches.items() if n == 0]
    if idle or launches["integrate_stream"] != 3 or launches["decode_updates_v1"] != 3:
        raise RuntimeError(f"mosaic_ladder: launches {launches}")
    # rungs 8-10 each held the integrate kernel's state against the plain version's
    integrate_err = max(s["max_abs_err"] for name, s in state["steps"].items() if "_kernel_" in name)
    return launches, integrate_err


def phase_plane_rmw(gpu, dev="cuda"):
    """The three plane RMW repros' main paths: every case in place, g3d
    also out of place, each against its expected output."""
    from ytpu_torch.benches import plane_rmw_repro, plane_rmw_repro2, plane_rmw_repro3

    wrappers = [c.fn for c in plane_rmw_repro.CASES + plane_rmw_repro2.CASES + plane_rmw_repro3.CASES]
    _reset_counts(wrappers)
    results = {"plane_rmw_repro": plane_rmw_repro.main(dev),
               "plane_rmw_repro2": plane_rmw_repro2.main(dev),
               "plane_rmw_repro3": plane_rmw_repro3.main(dev)}
    launches = {w.__name__: w.launches for w in wrappers}
    bad = [f"{prog}.{name}" for prog, r in results.items()
           for name, c in r["cases"].items() if c["status"] != "ok"]
    emit({"phase": "plane_rmw", "results": results, "launches": launches,
          "gpu": gpu})
    if bad:
        raise RuntimeError(f"plane_rmw: cases failed: {bad}")
    if results["plane_rmw_repro3"]["cases"]["v_body"]["meta"] != [[0, 0, 2, 0, 0, 0, 0, 0]] * 8:
        raise RuntimeError("plane_rmw: v_body flagged other meta words than the missing dependency")
    idle = [name for name, n in launches.items() if n == 0]
    if idle:
        raise RuntimeError(f"plane_rmw: kernels never launched: {idle}")
    return launches


# fills a separate output before a launch: an element the kernel misses or
# misplaces keeps it, and the comparison with the plain version fails
SENTINEL = -123456789
# the diagnostic kernels that can write a separate output (``out=``)
OUT_OF_PLACE = ("a_static3d_allfalse", "a2_static3d_slot0", "g3d", "g2d_flat", "v_vmem", "v_multi")
# the entry points of the map put (rungs 0 and 7), also held against their
# plain versions on a view one int off a 16-byte boundary (the one-int path)
MAP_PUTS = ("rung0_copy", "rung7_big_tile")
# rungs 1, 3, 4 and 5 (the row put, the carry put, the scan put and the
# sum put), also held against their plain versions on narrow tiles and on a
# view one int off a 16-byte boundary, and timed at the main path's width
TILE_RUNGS = ("rung1_onehot_put", "rung3_fori_carry", "rung4_while_scan", "rung5_nested_fori")
# the entry points of the column put (a and a2 restricted to one plane),
# also timed in place on a live slot and at the main path's width
COLUMN_PUTS = ("a_static3d_allfalse", "a2_static3d_slot0", "g3d", "g2d_flat")


def _variants(case, args, seed: int):
    """The inputs a diagnostic kernel is held against its plain version on,
    as ``[(inputs, kwargs maker)]``: the program's own; a seeded variant
    where the kernel decides on data; for the kernels in OUT_OF_PLACE the
    program's inputs written into an output filled with SENTINEL; for the
    map puts, rungs 1, 3, 4 and 5, and v_multi's meta, the seeded input at
    a view one int off a 16-byte boundary; for rungs 1, 3, 4 and 5 the
    full-range, narrow and tall tiles of `_tile_inputs`; and
    for the column puts a seeded state with a live slot (`_live_slot`), in
    place and into a SENTINEL-filled output."""
    import torch

    out = [(args, dict)]
    seeded = _seeded_inputs(case, args, seed)
    if seeded is not None:
        out.append((seeded, dict))
    if case.name in OUT_OF_PLACE:
        target = args[-1]  # x, or meta for v_multi

        out.append((args, lambda: {"out": torch.full_like(target, SENTINEL)}))
    if case.name in MAP_PUTS + TILE_RUNGS:
        out.append(((_at_offset(seeded[0], 4),), dict))
    if case.name in TILE_RUNGS:
        out.extend(((x,), dict) for x in _tile_inputs(case.name, args[0], seed))
    if case.name == "v_multi":  # in place on the one-int path
        out.append((seeded[:4] + (_at_offset(seeded[4], 4),), dict))
    if case.name in COLUMN_PUTS:
        x, live = _live_slot(case.name, args[0], seed)
        out.append(((x,), lambda: dict(live)))
        out.append(((x,), lambda: {"out": torch.full_like(x, SENTINEL), **live}))
    return out


def _at_offset(x, offset: int):
    """A copy of `x` that starts `offset` bytes past a 16-byte boundary."""
    import torch

    size = x.element_size()
    buf = torch.empty(x.numel() + 32 // size, dtype=x.dtype, device=x.device)
    start = ((-buf.data_ptr()) % 16 + offset) // size
    return buf[start : start + x.numel()].view(x.shape).copy_(x)


def _tile_inputs(name: str, like, seed: int):
    """Further seeded inputs of rungs 1, 3, 4 and 5 on `like`'s device: for
    rung 1 5 and 11 columns (the one-int path; head indices in [-2, C + 2))
    and 70,000 rows of 4 (more rows than one grid's 65,535: CTAs stride over
    rows); for rung 3 8 x 16 (the fewest columns it takes), 8 x 17 (its head
    read one int a group) and 256 x 17 (sixteen head ints a thread), all
    over the full int32 range (sums wrap past 2^31); for rung 4 the program's
    shape over the full range, and 11 columns (fewer than its 12 steps, not
    a multiple of 4) of values in [0, 12) and of the full range; for rung 5
    3 x 11 and 5 x 31 ints (fewer than its 32 terms: the index wraps mod C;
    an odd count, so the one-int path) and 8 x 31 (the 16-byte path)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed + 1)
    full = lambda shape: rng.integers(-(2**31), 2**31, size=shape, dtype=np.int64)  # noqa: E731

    def heads(shape):
        a = full(shape)
        a[:, 0] = rng.integers(-2, shape[1] + 2, size=shape[0])
        return a

    if name == "rung1_onehot_put":
        arrays = [heads((8, 5)), heads((8, 11)), heads((70000, 4))]
    elif name == "rung3_fori_carry":
        arrays = [full((8, 16)), full((8, 17)), full((256, 17))]
    elif name == "rung4_while_scan":
        arrays = [full(tuple(like.shape)), rng.integers(0, 12, size=(8, 11)), full((8, 11))]
    else:
        arrays = [full((3, 11)), full((5, 31)), full((8, 31))]
    return [torch.from_numpy(a.astype(np.int32)).to(like.device) for a in arrays]


def _slots(name: str, x) -> int:
    """The plane width C of an ``[NC, D, C]`` state or of g2d's ``[D, NC * C]``."""
    from ytpu_torch.benches.plane_rmw_repro2 import NC

    return x.shape[1] // NC if name == "g2d_flat" else x.shape[-1]


def _live_slot(name: str, like, seed: int):
    """A seeded int32 state of `like`'s shape and device, and a live slot
    (``idx`` in ``[0, C)``, fill 12,345) for a column put."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(-(2**31), 2**31, size=tuple(like.shape), dtype=np.int64)
                         .astype(np.int32)).to(like.device)
    return x, {"idx": int(rng.integers(_slots(name, x))), "fill": 12345}


def _seeded_inputs(case, args, seed: int):
    """A seeded variant of a case's inputs that reaches the data-dependent
    branches (wrapping sums, out-of-range one-hot indices, rows breaking at
    different steps, a firing guard, live slots for the client clock; for
    v_multi a meta of random words), or None for the plane passthroughs
    (their seeded variants are in `_variants`, as are rung 4's over the
    full range, `_tile_inputs`)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    if case.source.endswith("mosaic_ladder.cu"):
        (x,) = args
        full = rng.integers(-(2**31), 2**31, size=tuple(x.shape), dtype=np.int64).astype(np.int32)
        if case.name == "rung1_onehot_put":
            full[:, 0] = rng.integers(-2, x.shape[1] + 2, size=x.shape[0])
        elif case.name in ("rung2_mrow_mask", "rung4_while_scan"):
            full = rng.integers(0 if case.name == "rung4_while_scan" else -10, 12,
                                size=tuple(x.shape)).astype(np.int32)
        elif case.name == "rung6_pl_when":
            full[:, 0] = rng.integers(-50, 100, size=x.shape[0])
            full[3, 0] = 101
        return (torch.from_numpy(full).to(x.device),)
    if case.name == "v_multi":
        meta = rng.integers(-(2**31), 2**31, size=tuple(args[4].shape), dtype=np.int64).astype(np.int32)
        return args[:4] + (torch.from_numpy(meta).to(args[4].device),)
    if case.name == "v_body":
        rows, dels, rank, cols, meta = (a.clone() for a in args)
        D, C = cols.shape[1], cols.shape[2]
        dev = cols.device
        cols[0] = torch.from_numpy(rng.integers(0, 4, size=(D, C)).astype(np.int32)).to(dev)
        cols[1] = torch.from_numpy(rng.integers(0, 50, size=(D, C)).astype(np.int32)).to(dev)
        cols[2] = torch.from_numpy(rng.integers(1, 4, size=(D, C)).astype(np.int32)).to(dev)
        meta[:, 1] = torch.from_numpy(rng.integers(0, C + 1, size=D).astype(np.int32)).to(dev)
        rows[0, :, 0] = torch.from_numpy(rng.integers(0, 5, size=rows.shape[1]).astype(np.int32)).to(dev)
        rows[0, :, 1] = torch.from_numpy(rng.integers(0, 60, size=rows.shape[1]).astype(np.int32)).to(dev)
        rows[0, 1, 14] = 0
        return rows, dels, rank, cols, meta
    return None


def _abs_err(got, want) -> int:
    """Max abs difference of tensors or tuples of tensors (computed only
    where they differ: at full width the difference alone takes GBs)."""
    import torch

    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise RuntimeError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        if not torch.equal(g, w):
            err = max(err, int((g.long() - w.long()).abs().max()))
    return err


def _full_width(name: str, like, seed: int):
    """The main path's ``[26, 256, 65,536]`` int32 state (g2d: ``[256, 26 *
    65,536]``), made on `like`'s card from a seeded generator."""
    import torch

    from ytpu_torch.benches.plane_rmw_repro2 import NC

    shape = (N_DOCS, NC * CAPACITY) if name == "g2d_flat" else (NC, N_DOCS, CAPACITY)
    gen = torch.Generator(device=like.device)
    gen.manual_seed(seed)
    return torch.empty(shape, dtype=torch.int32, device=like.device).random_(-(2**31), 2**31, generator=gen)


def _launch_floor(fn) -> dict:
    """The grid and block of the kernels `fn` launches (read back from a
    CUDA graph that captured a call) and the time of as many empty kernel
    nodes at those grids in a CUDA graph (`graph_ms`): the least launches
    of that shape cost. ``grid`` and ``block`` are the first kernel's,
    ``nodes`` lists every kernel's where there are more."""
    import torch

    from ytpu_torch.benches._kernels import empty_launch, graph_ms, graph_nodes

    nodes = graph_nodes(fn)
    if not nodes or any(n["type"] != "kernel" for n in nodes):
        raise RuntimeError(f"expected kernel nodes only, got {nodes}")
    empties = [empty_launch(k["grid"], k["block"], torch.device("cuda")) for k in nodes]
    floor = graph_ms(lambda: [e() for e in empties])
    out = {"launch_floor_ms": floor["mean"], "launch_floor_spread": floor, "grid": nodes[0]["grid"],
           "block": nodes[0]["block"]}
    if len(nodes) > 1:
        out["nodes"] = [{"grid": k["grid"], "block": k["block"]} for k in nodes]
    return out


def _column_put_pairs(case, like, seed: int):
    """A column put (a, a2, g3d, g2d) beside the one PyTorch call that
    computes the same function, in the same mode, on the same input: in
    place on `_live_slot`'s input at the program's shape, beside the fill
    of that column (a, a2: of their plane only); then at the main path's width
    (`_full_width`): out of place (held on the live slot and at the
    program's idx, timed at the program's idx) beside ``copy_``, in place
    on a live slot beside the column fill, and in place at the program's
    idx (no library call). Every kernel result is held against the plain
    version's, and each library call's against the kernel's. Returns the
    fields and the max abs error."""
    import numpy as np
    import torch

    from ytpu_torch.benches._kernels import graph_ms
    from ytpu_torch.benches.plane_rmw_repro import PLANE
    from ytpu_torch.benches.plane_rmw_repro2 import NC

    fn, name = case.fn, case.name

    def column_fill(x, idx, fill):
        if name == "g2d_flat":
            planes = x.view(x.shape[0], NC, -1)
        else:
            planes = x if name == "g3d" else x[PLANE]
        return lambda: planes.select(-1, idx).fill_(fill)

    x, live = _live_slot(name, like, seed)
    xk, xl = x.clone(), x.clone()
    fields = {"in_place_live_ms": graph_ms(lambda: fn(xk, **live)),
              "in_place_library_ms": graph_ms(column_fill(xl, **live))}
    want = case.plain(x.clone(), **live)
    err = max(_abs_err(xk, want), _abs_err(xl, want))
    del x, xk, xl, want

    x = _full_width(name, like, seed)
    shape = tuple(x.shape)
    live = {"idx": int(np.random.default_rng(seed).integers(CAPACITY)), "fill": 12345}
    # out of place into SENTINEL, the input left as it was: on the live
    # slot, then at the program's idx
    x0, o = x.clone(), torch.full_like(x, SENTINEL)
    fn(x, out=o, **live)
    want = case.plain(x, out=torch.empty_like(x), **live)
    err = max(err, _abs_err(o, want), _abs_err(x, x0))
    del want
    o.fill_(SENTINEL)
    fn(x, out=o)
    want = case.plain(x, out=torch.empty_like(x))
    err = max(err, _abs_err(o, want), _abs_err(x, x0))
    del x0
    copy_out = torch.empty_like(x)
    wide = {"shape": list(shape), "out_of_place_ms": graph_ms(lambda: fn(x, out=o)),
            "library_ms": graph_ms(lambda: copy_out.copy_(x)),
            "launch_floor": _launch_floor(lambda: fn(x, out=o))}
    # copy_ computes the function where the program's idx changes nothing
    err = max(err, _abs_err(o, want))
    if torch.equal(want, x):
        err = max(err, _abs_err(copy_out, o))
    del copy_out, want
    # in place, live slot: the kernel on `o`, the plain version and the
    # column fill on copies of `x`
    o.copy_(x)
    fn(o, **live)
    want = case.plain(x.clone(), **live)
    err = max(err, _abs_err(o, want))
    wide["in_place_live_ms"] = graph_ms(lambda: fn(o, **live))
    wide["in_place_library_ms"] = graph_ms(column_fill(x, **live))
    err = max(err, _abs_err(x, o))
    # in place at the program's idx, on the state the live slot made
    fn(o)
    err = max(err, _abs_err(o, case.plain(want)))
    del want
    wide["in_place_ms"] = graph_ms(lambda: fn(o))
    rows = x.numel() // _slots(name, x)
    if name in ("a_static3d_allfalse", "a2_static3d_slot0"):
        rows //= NC  # one plane's column
    wide["full_width_bound_ms"] = {"out_of_place": 2 * 4 * x.numel() / HBM_BYTES_PER_S * 1e3,
                                   "in_place": 4 * rows / HBM_BYTES_PER_S * 1e3}
    wide["live"] = live
    del x, o
    torch.cuda.empty_cache()
    fields["full_width"] = wide
    return fields, err


def _passthrough_pairs(case, like, seed: int):
    """v_vmem (the column put at idx -1) at the main path's width
    (`_full_width`): out of place into SENTINEL, held against the plain
    version and timed beside ``copy_`` (in a graph and issued eagerly),
    with its launch floor; then in place. Returns the fields and the max
    abs error."""
    import torch

    from ytpu_torch.benches._kernels import graph_ms

    x = _full_width(case.name, like, seed)
    x0 = x.clone()
    o = torch.full_like(x, SENTINEL)
    case.fn(x, out=o)
    err = _abs_err(o, case.plain(x, out=torch.empty_like(x)))
    copy_out = torch.empty_like(x)
    wide = {"shape": list(x.shape), "out_of_place_ms": graph_ms(lambda: case.fn(x, out=o)),
            "library_ms": graph_ms(lambda: copy_out.copy_(x)),
            "launch_floor": _launch_floor(lambda: case.fn(x, out=o)),
            "library_host_issued_ms": _time_ms(lambda: copy_out.copy_(x), 20)}
    err = max(err, _abs_err(copy_out, x), _abs_err(o, x))
    wide["in_place_ms"] = graph_ms(lambda: case.fn(x))
    err = max(err, _abs_err(x, x0))
    wide["full_width_bound_ms"] = 2 * 4 * x.numel() / HBM_BYTES_PER_S * 1e3
    del x, x0, o, copy_out
    torch.cuda.empty_cache()
    return {"full_width": wide}, err


def _body_full_width(args, seed: int):
    """v_body's inputs at the main path's width: the ``[26, 256, 65,536]``
    state of `_full_width` with planes 0-2 seeded as `_seeded_inputs` seeds
    them at the program's shape (clients 0-3, clocks 0-49, lengths 1-3)
    and every slot live (``meta[:, 1] = 65,536``; ``meta[:, 2]`` 0 or 1);
    the program's 4 rows with seeded clients 0-4 and clocks 0-59, row 1
    invalid. Row 3 asks client 2 for clock 59, past every seeded slot's,
    and one random slot in a random half of the docs meets it, so that
    ``mo[:, 2]`` varies by doc."""
    import numpy as np
    import torch

    rows, dels, rank = (a.clone() for a in args[:3])
    dev = rows.device
    cols = _full_width("v_body", rows, seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    cols[0].random_(0, 4, generator=gen)
    cols[1].random_(0, 50, generator=gen)
    cols[2].random_(1, 4, generator=gen)
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, dtype=np.int32)).to(dev)  # noqa: E731
    rows[0, :, 0] = t(rng.integers(0, 5, size=rows.shape[1]))
    rows[0, :, 1] = t(rng.integers(0, 60, size=rows.shape[1]))
    rows[0, 1, 14] = 0
    rows[0, 3, 0], rows[0, 3, 1] = 2, 59
    docs = torch.from_numpy(rng.choice(N_DOCS, N_DOCS // 2, replace=False)).to(dev)
    slots = torch.from_numpy(rng.integers(0, CAPACITY, size=N_DOCS // 2)).to(dev)
    cols[0, docs, slots], cols[1, docs, slots], cols[2, docs, slots] = 2, 58, 1
    meta = torch.zeros((N_DOCS, args[4].shape[1]), dtype=torch.int32, device=dev)
    meta[:, 1] = CAPACITY
    meta[:, 2] = t(rng.integers(0, 2, size=N_DOCS))
    return rows, dels, rank, cols, meta


def _body_pairs(case, args, seed: int):
    """v_body at the main path's width (`_body_full_width`): held against
    the plain version (meta in place; cols must come back as it was),
    timed in a graph (in place, so every launch after the first meets a
    meta it already flagged: the result is the same), with its launch
    floor and its bound. No PyTorch call computes it. Returns the fields
    and the max abs error."""
    import torch

    from ytpu_torch.benches._kernels import graph_ms

    wide_args = _body_full_width(args, seed)
    rows, dels, rank, cols, meta = wide_args
    cols0 = cols.clone()
    plain_args = (rows, dels, rank, cols, meta.clone())
    plain_ms = _time_ms(lambda: case.plain(*plain_args))
    want = plain_args[4]
    case.fn(*wide_args)
    err = max(_abs_err(meta, want), _abs_err(cols, cols0))
    wide = {"shape": list(cols.shape), "ms": graph_ms(lambda: case.fn(*wide_args)),
            "plain_ms": plain_ms, "launch_floor": _launch_floor(lambda: case.fn(*wide_args)),
            "full_width_bound_ms": case.bound_bytes(wide_args) / HBM_BYTES_PER_S * 1e3,
            "docs_flagged": int(((want[:, 2] & 2) != 0).sum())}
    err = max(err, _abs_err(meta, want), _abs_err(cols, cols0))
    del wide_args, rows, cols, cols0, meta, plain_args, want
    torch.cuda.empty_cache()
    return {"full_width": wide}, err


def _tile_pairs(case, like, seed: int):
    """Rung 1, 3, 4 or 5 at the main path's width, ``[256, 65,536]`` int32
    made on `like`'s card from a seeded generator (rung 4: values in [0,
    12), so that rows break at different steps; rung 1: the full range with
    head indices in [-2, C + 2); rungs 3 and 5: the full range): held
    against the plain version, timed in a graph beside its yardstick into an
    output of the same shape: for rung 1 ``torch.add(x, 1)``, a pass that
    reads and writes the tile, for the others ``fill_``, a pass that writes
    it (neither computes the rung's function), with the launch floor at its
    grid and the bound of this input (what the function reads, plus the
    tile written once). Returns the fields and the max abs error."""
    import torch

    from ytpu_torch.benches._kernels import graph_ms

    gen = torch.Generator(device=like.device)
    gen.manual_seed(seed)
    x = torch.empty((N_DOCS, CAPACITY), dtype=torch.int32, device=like.device)
    if case.name == "rung4_while_scan":
        x.random_(0, 12, generator=gen)
    else:
        x.random_(-(2**31), 2**31, generator=gen)
    if case.name == "rung1_onehot_put":
        x[:, 0] = torch.empty(N_DOCS, dtype=torch.int32, device=like.device).random_(-2, CAPACITY + 2,
                                                                                     generator=gen)
    want = case.plain(x)
    got = case.fn(x)
    err = _abs_err(got, want)
    yard_out = torch.empty_like(x)
    if case.name == "rung1_onehot_put":
        yardstick, yard = "torch.add(x, 1, out=o)", lambda: torch.add(x, 1, out=yard_out)
    else:
        yardstick, yard = "o.fill_(v)", lambda: yard_out.fill_(7)
    wide = {"shape": list(x.shape), "ms": graph_ms(lambda: case.fn(x)),
            "yardstick": yardstick, "yardstick_ms": graph_ms(yard),
            "plain_ms": _time_ms(lambda: case.plain(x)),
            "launch_floor": _launch_floor(lambda: case.fn(x)),
            "full_width_bound_ms": case.bound_bytes((x,)) / HBM_BYTES_PER_S * 1e3}
    del x, want, got, yard_out
    torch.cuda.empty_cache()
    return {"full_width": wide}, err


def phase_diag_kernels(gpu, launches, dev="cuda"):
    """Every diagnostic kernel at its program's shapes: held against its
    plain version on the inputs of `_variants`, then timed beside the one
    PyTorch call that computes the same function (where there is one), in
    the same mode on the same input: device time per launch of a CUDA graph
    (`graph_ms`: min, mean and max over its rounds) and back-to-back
    launches from the host; the plain version with CUDA events. The
    kernels in OUT_OF_PLACE are timed out of place, the mode of their
    library call (``copy_``, ``torch.where``), with the in-place call
    beside it (``in_place_ms``); the column puts also get
    `_column_put_pairs`, v_vmem `_passthrough_pairs`, v_body `_body_pairs`
    (its main path's width), rungs 1, 3, 4 and 5 `_tile_pairs` (the main
    path's width, beside ``torch.add`` or ``fill_``). Each entry carries
    the launch floor at its kernel's grid (`_launch_floor`); the floor of
    one CTA of 32, 64, 128 and 256 threads and the nodes a ``copy_`` of the
    program's state and of v_multi's meta make in a CUDA graph (a memcpy or
    a kernel) are in the phase's line. These launches are not counted: the counts come from the
    programs' own runs."""
    import torch

    from ytpu_torch.benches._kernels import empty_launch, graph_ms, graph_nodes

    one_cta = {t: graph_ms(empty_launch([1], [t], torch.device(dev))) for t in (32, 64, 128, 256)}
    entries = []
    for case in _diag_cases():
        args = case.inputs(dev)
        err = 0
        variants = _variants(case, args, 11)
        for inputs, make_kw in variants:
            # the kernel's copies keep their inputs' offset from a 16-byte boundary
            k_inputs = tuple(_at_offset(a, a.data_ptr() % 16) for a in inputs)
            kw = make_kw()
            got = case.fn(*k_inputs, **kw)
            want = case.plain(*(a.clone() for a in inputs), **make_kw())
            err = max(err, _abs_err(got, want))
            if "out" in kw and not all(torch.equal(a, b) for a, b in zip(k_inputs, inputs)):
                raise RuntimeError(f"{case.name} out of place wrote its input")
        extra = {}
        if case.name in COLUMN_PUTS:
            pairs, pair_err = _column_put_pairs(case, args[0], 11)
            err = max(err, pair_err)
            extra.update(pairs)
        elif case.name == "v_vmem":
            pairs, pair_err = _passthrough_pairs(case, args[0], 11)
            err = max(err, pair_err)
            extra.update(pairs)
        elif case.name == "v_body":
            pairs, pair_err = _body_pairs(case, args, 11)
            err = max(err, pair_err)
            extra.update(pairs)
        elif case.name in TILE_RUNGS:
            pairs, pair_err = _tile_pairs(case, args[0], 11)
            err = max(err, pair_err)
            extra.update(pairs)
        if err != 0:
            raise RuntimeError(f"{case.name}: kernel and plain version differ (max abs err {err})")
        run_args = tuple(a.clone() for a in args)
        plain_args = tuple(a.clone() for a in args)
        kw = plain_kw = {}
        if case.name in OUT_OF_PLACE:
            extra["in_place_ms"] = graph_ms(lambda: case.fn(*run_args))
            kw = {"out": torch.empty_like(args[-1])}
            plain_kw = {"out": torch.empty_like(args[-1])}
        timed = graph_ms(lambda: case.fn(*run_args, **kw))
        stream_ms = _time_ms(lambda: case.fn(*run_args, **kw), 200)
        plain_ms = _time_ms(lambda: case.plain(*plain_args, **plain_kw), 20)
        library = library_stream_ms = None
        if case.library is not None:
            lib_call = case.library(args)
            library = graph_ms(lib_call)
            library_stream_ms = _time_ms(lib_call, 200)
        bound_b = case.bound_bytes(args)
        extra["launch_floor"] = _launch_floor(lambda: case.fn(*run_args, **kw))
        entries.append({
            "name": case.name, "route": "cuda", "source": case.source, "replaces": case.replaces,
            "launches": launches[case.fn.__name__], "max_abs_err": err, "ms": timed["mean"],
            "plain_ms": plain_ms, "bound_ms": bound_b / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": library and library["mean"], "ms_spread": timed, "library_spread": library,
            "host_issued_ms": stream_ms, "library_host_issued_ms": library_stream_ms, "bound_bytes": bound_b,
            "variants_compared": len(variants), "shapes": [list(a.shape) for a in args],
            "launch_floor_ms": extra["launch_floor"]["launch_floor_ms"], **extra,
        })
    state = next(c for c in _diag_cases() if c.name == "v_vmem").inputs(dev)[0]
    copy_out = torch.empty_like(state)
    meta = next(c for c in _diag_cases() if c.name == "v_multi").inputs(dev)[4]
    meta_out = torch.empty_like(meta)
    emit({"phase": "diag_kernels", "kernels": entries, "launch_floor_one_cta_ms": one_cta,
          "copy_nodes": graph_nodes(lambda: copy_out.copy_(state)),
          "meta_copy_nodes": graph_nodes(lambda: meta_out.copy_(meta)), "gpu": gpu})
    return entries


def phase_stream_replay_full_width(gpu, log, expect, plan, dev="cuda"):
    """The packed-stream entry point at the flagship envelope: the whole B4
    log decoded on the device into one ``[S, U]`` stream (`pack_updates`,
    content refs ``s * L + byte``), then `replay_stream_fused` over 256 docs
    from 65,536 slots in windows of 8,192 steps. Byte refs do not let
    compaction merge rows of different updates, so the live rows outgrow
    65,536 slots and the driver grows the state (up to STREAM_MAX_CAPACITY).
    Checks the text of the first and last doc, the sticky error, one launch
    per window, and the kernel against its plain version on one late window
    at the final capacity (`_late_window_vs_plain`). A CUDA graph of the
    decode call shows that it is one kernel (`_graph_launches`); a
    second, traced run of the replay times each integrate launch
    (`_stream_launch_ms`)."""
    import torch

    from ytpu_torch.models.batch_doc import get_string, init_state
    from ytpu_torch.ops import integrate_kernel as ik
    from ytpu_torch.ops.decode_kernel import (
        FLAG_ERRORS, RawPayloadView, decode_updates_v1, identity_rank, pack_updates,
    )

    t0 = time.perf_counter()
    buf_np, lens_np = pack_updates(log)
    buf, lens = torch.from_numpy(buf_np).to(dev), torch.from_numpy(lens_np).to(dev)
    torch.cuda.synchronize()
    decode_updates_v1.launches = 0
    t1 = time.perf_counter()
    stream, flags = decode_updates_v1(
        buf, lens, max_rows=plan.max_rows, max_dels=plan.max_dels, n_steps=plan.max_steps,
        max_sections=plan.max_sections,
    )
    torch.cuda.synchronize()
    decode_call_s = time.perf_counter() - t1
    bad = int(((flags & FLAG_ERRORS) != 0).sum())
    decode_s = time.perf_counter() - t0
    decode_launches = decode_updates_v1.launches
    if bad or decode_launches != 1:
        raise RuntimeError(f"stream_replay_full_width: decode flagged {bad} updates in {decode_launches} launches")
    # the call's one kernel, read from a CUDA graph of the same call: here,
    # late in the script, the profiler drops the device records at the
    # start of its windows (kineto's "Out-of-range" count), torch's own
    # kernels too, so a trace cannot show this call's kernel
    decode_nodes = _graph_launches(lambda: decode_updates_v1(
        buf, lens, max_rows=plan.max_rows, max_dels=plan.max_dels, n_steps=plan.max_steps,
        max_sections=plan.max_sections))
    if len(decode_nodes) != 1 or DECODE_KERNEL not in decode_nodes[0]:
        raise RuntimeError(f"stream_replay_full_width: the decode call launched {decode_nodes}, not one "
                           f"{DECODE_KERNEL}")
    state = init_state(N_DOCS, CAPACITY, dev)
    rank = identity_rank(256, dev)
    torch.cuda.synchronize()
    ik.integrate_stream.launches = 0
    t0 = time.perf_counter()
    state, st = ik.replay_stream_fused(state, stream, rank, chunk_steps=CHUNK,
                                       max_capacity=STREAM_MAX_CAPACITY)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ik.integrate_stream.launches
    err = int(state.error.max())
    view = RawPayloadView(buf_np)
    text_ok = [get_string(state, d, view) == expect for d in (0, N_DOCS - 1)]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del state
    torch.cuda.empty_cache()
    launch_ms = _stream_launch_ms(stream, rank, dev)
    vs_plain = _late_window_vs_plain(stream, rank, st.capacity, dev)
    line = {
        "phase": "stream_replay_full_width", "updates": len(log), "docs": N_DOCS,
        "capacity_start": CAPACITY, "capacity_end": st.capacity, "chunk_steps": CHUNK,
        "lane_width": int(buf_np.shape[1]), "decode_s": decode_s, "decode_call_s": decode_call_s,
        "decode_launches": decode_launches, "decode_graph_nodes": decode_nodes, "wall_s": wall,
        "updates_per_s": len(log) / wall, "doc_updates_per_s": len(log) * N_DOCS / wall,
        "chunks": st.chunks, "compactions": st.compactions, "growths": st.growths,
        "peak_blocks": st.peak_blocks, "final_blocks": st.final_blocks, "launches": launches,
        "sticky_error": err, "text_ok": text_ok, "peak_memory_gb": peak_gb,
        "integrate_launch_ms": launch_ms, "kernel_vs_plain": vs_plain, "gpu": gpu,
    }
    emit(line)
    if err != 0:
        raise RuntimeError(f"stream_replay_full_width: sticky error {err}")
    if not all(text_ok):
        raise RuntimeError("stream_replay_full_width: replayed text differs from the log's expected text")
    if launches != -(-len(log) // CHUNK) or launches != st.chunks:
        raise RuntimeError(f"stream_replay_full_width: {launches} launches for {st.chunks} windows")
    return launches, vs_plain, launch_ms, decode_launches


def _stream_launch_ms(stream, rank, dev):
    """`replay_stream_fused` as in the phase, under `torch.profiler`: the
    device ms of each integrate launch, grouped by the capacity it ran at
    (the state doubles at each ``ytpu_torch.grow`` span)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ytpu_torch.models.batch_doc import init_state
    from ytpu_torch.ops import integrate_kernel as ik

    state = init_state(N_DOCS, CAPACITY, dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = ik.replay_stream_fused(state, stream, rank, chunk_steps=CHUNK,
                                          max_capacity=STREAM_MAX_CAPACITY)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    del state
    _, integrate, spans = _trace_breakdown(prof, wall)
    grows = [t for t, _, name in spans if name == "grow"]
    by_cap = {}
    for t, ms in integrate:
        cap = min(CAPACITY << sum(1 for g in grows if g < t), STREAM_MAX_CAPACITY)
        by_cap.setdefault(str(cap), []).append(ms)
    return {cap: {"launches": len(v), "ms_mean": sum(v) / len(v), "ms_max": max(v), "ms": v}
            for cap, v in by_cap.items()}


def _late_window_vs_plain(stream, rank, capacity: int, dev):
    """The integrate kernel against its plain version at the stream
    replay's final `capacity`, on the state of 2 docs before window
    LATE_CHUNK (docs are independent and share the stream, so every doc of
    the run held this state): the prefix replayed through
    `replay_stream_fused`, room made for the window as
    `PackedReplayDriver.step` makes it, the state grown to `capacity` if
    the prefix had not grown it yet, then the window through both. All 26
    planes and all meta words must be equal, with sticky error 0."""
    from ytpu_torch.models.batch_doc import UpdateBatch, init_state, stream_worst_case_adds
    from ytpu_torch.ops import integrate_kernel as ik
    from ytpu_torch.ops.compaction import grow_packed

    pos = LATE_CHUNK * CHUNK
    prefix = UpdateBatch(*(a[:pos] for a in stream))
    window = UpdateBatch(*(a[pos : pos + CHUNK] for a in stream))
    state, _ = ik.replay_stream_fused(init_state(2, CAPACITY, dev), prefix, rank, chunk_steps=CHUNK,
                                      max_capacity=STREAM_MAX_CAPACITY)
    driver = ik.PackedReplayDriver(*ik.pack_state(state), rank, max_capacity=STREAM_MAX_CAPACITY,
                                   initial_occupancy=int(state.n_blocks.max()))
    driver.ensure_room(int(stream_worst_case_adds(window).sum()) + 8)
    cols_k, meta_k = driver.cols, driver.meta
    grown = cols_k.shape[2] < capacity
    if grown:
        cols_k, meta_k = grow_packed(cols_k, meta_k, capacity)
    blocks_before = int(meta_k[:, ik.M_NBLOCKS].max())
    rows, dels = ik.pack_stream(window)
    cols_p, meta_p = cols_k.clone(), meta_k.clone()
    k_ms = _time_ms(lambda: ik.integrate_stream(cols_k, meta_k, rows, dels, rank))
    p_ms = _time_ms(lambda: ik.integrate_stream_reference(cols_p, meta_p, rows, dels, rank))
    max_err = _compare("grown capacity", cols_k, meta_k, cols_p, meta_p)
    sticky = int(meta_k[:, ik.M_ERROR].max())
    if sticky != 0:
        raise RuntimeError(f"stream_replay_full_width: sticky error {sticky} in the compared window")
    return {
        "case": f"stream window {pos}..{pos + CHUNK}, 2 docs, C={cols_k.shape[2]}, S={CHUNK}",
        "capacity": cols_k.shape[2], "grown_for_check": grown, "blocks_before": blocks_before,
        "blocks_after": int(meta_k[:, ik.M_NBLOCKS].max()), "max_abs_err": max_err,
        "kernel_ms": k_ms, "plain_ms": p_ms,
    }


# --- the V2 lane -------------------------------------------------------------------

DECODE_V2_REPLACES = "ytpu/ops/decode_v2.py:1025"
DECODE_V2_LOOPS = ("ytpu/ops/decode_v2.py:516, :555, :587, :1018, :1322, :1541 (the XLA fori_loops of "
                   "decode_updates_v2)")
DECODE_V2_KERNEL = "decode_v2_kernel"
# the crafted V2 sets, written by tests/_torch_v2_cases.py
V2_CASES = os.path.join(HERE, "ytpu_torch", "benches", "data", "v2_cases.json")
# the JAX package's full-log V2 test: lanes padded to 64 bytes, 4 rows and
# 4 delete ranges a lane, 4 client sections
V2_PAD, V2_U, V2_R, V2_SEC = 64, 4, 4, 4
# CUDA-graph calls a round when the whole log's launch is timed
V2_FULL_GRAPH_REPS = 10
# merged B4 prefixes (whole-state lanes of up to ~100 blocks) at a U whose
# column expansions pass the kernel's shared-memory budget
V2_MERGED_PREFIXES, V2_MERGED_U, V2_MERGED_R = (8, 40, 96), 128, 8
# steps of the ingest phase's cohorts that V2 ingest runs
V2_INGEST_STEPS = 32


def _or_lanes(flags) -> int:
    import numpy as np

    f = flags.cpu().numpy()
    return int(np.bitwise_or.reduce(f)) if f.size else 0


def _v2_bound_bytes(lens, spans, sidecar, tables, U: int, R: int, arena: bool = False) -> int:
    """Bytes the V2 decode must move at least, as `_decode_bound_bytes`
    counts the V1 decode: each lane's wire bytes, its length (from the
    arena also its offset and staged extent), its 24 span words and its
    sidecar row read once, each intern table once; the 22 int32 row fields
    and a valid byte a row slot, the 3 int32 delete fields and a valid byte
    a delete slot and the int32 flags written once."""
    S = lens.shape[0]
    reads = int(lens.long().sum()) + 4 * S * (3 if arena else 1) + 4 * spans.numel()
    if sidecar is not None:
        reads += 4 * sidecar.numel()
    for t in tables.values():
        if t is not None:
            reads += sum(x.numel() * x.element_size() for x in (t if isinstance(t, tuple) else (t,)))
    return reads + S * U * (22 * 4 + 1) + S * R * (3 * 4 + 1) + 4 * S


def _one_launch(name: str, call, path: str) -> list:
    """A call of a V2 decode entry point puts exactly one node on the
    device, `decode_v2_kernel` (read from a CUDA graph of it), and counts
    one launch in ``decode_updates_v2.launches`` and one on `path` in
    ``decode_updates_v2.paths`` (both set to 0 just before it), or it
    raises. Returns the graph's nodes."""
    import torch

    from ytpu_torch.ops import decode_v2 as dv2

    dv2.decode_updates_v2.launches = 0
    dv2.decode_updates_v2.paths = dict.fromkeys(dv2.decode_updates_v2.paths, 0)
    call()
    torch.cuda.synchronize()
    launches, paths = dv2.decode_updates_v2.launches, dict(dv2.decode_updates_v2.paths)
    nodes = _graph_launches(call)
    if launches != 1 or paths[path] != 1 or len(nodes) != 1 or DECODE_V2_KERNEL not in nodes[0]:
        raise RuntimeError(f"decode_v2 {name}: a call made {launches} counted launches ({paths}) and put "
                           f"{nodes[:8]} on the device")
    return nodes


def _decode_v2_vs_plain(name: str, payloads, U: int, R: int, SEC: int, tables: dict, dev, pad_to=None,
                        path: str = "shared") -> dict:
    """The V2 decode kernel against the plain composition on the card, on
    `payloads` packed as a matrix (`pack_updates_v2`) and as an arena
    (`pack_updates_v2_raw`, read in place): `_decode_v2_reference` (of the
    gathered arena) -> `_resolve_and_pack`, with `tables` and, where there
    are tables, without; every UpdateBatch field and the flags of every
    lane equal (max abs err 0), the column expansions on `path`, and each
    entry point one launch a call (`_one_launch`), or it raises. Device ms
    a launch from a CUDA graph (`graph_ms`) from the matrix and from the
    arena, issued ms from CUDA events over DECODE_KERNEL_REPS calls, plain
    ms (the reference and the resolve) between CUDA events."""
    import torch

    from ytpu_torch.benches._kernels import graph_ms
    from ytpu_torch.ops import decode_kernel as dk
    from ytpu_torch.ops import decode_v2 as dv2

    def on_dev(x):
        return None if x is None else torch.from_numpy(x).to(dev)

    buf, lens, spans, side = (on_dev(x) for x in dv2.pack_updates_v2(payloads, pad_to=pad_to))
    raw = dv2.pack_updates_v2_raw(payloads)
    wire, offs, row_lens, alens, aspans, aside = (on_dev(x) for x in raw[:6])
    width = raw[6]
    pre, ref_ms = _event_ms(lambda: dv2._decode_v2_reference(buf, lens, spans, U, R, SEC, side))
    plain, res_ms = _event_ms(lambda: dk._resolve_and_pack(dict(pre[0]), dict(pre[1]), pre[2], **tables))
    gathered = dk.gather_raw_lanes(wire, offs, row_lens, width)
    same = (gathered.shape == buf.shape and torch.equal(gathered, buf) and torch.equal(alens, lens)
            and torch.equal(aspans, spans) and (side is None) == (aside is None)
            and (side is None or torch.equal(aside, side)))
    pre_a = pre if same else dv2._decode_v2_reference(gathered, alens, aspans, U, R, SEC, aside)
    plain_a = dk._resolve_and_pack(dict(pre_a[0]), dict(pre_a[1]), pre_a[2], **tables)

    def matrix(tabs):
        return dv2._decode_v2_kernel(buf, lens, spans, U, R, SEC, side, **tabs)

    def arena(tabs):
        return dv2._decode_v2_kernel(wire, alens, aspans, U, R, SEC, aside, offs, row_lens, width, **tabs)

    stream_m, flags_m, path_m = matrix(tables)
    stream_a, flags_a, path_a = arena(tables)
    torch.cuda.synchronize()
    if (path_m, path_a) != (path, path):
        raise RuntimeError(f"decode_v2 {name}: the expansions went to {path_m} / {path_a}, not {path}")
    err = max(_stream_diff(f"v2 {name}", (stream_m, flags_m), plain),
              _stream_diff(f"v2 {name} (arena)", (stream_a, flags_a), plain_a))
    held = ["matrix", "arena"]
    if any(v is not None for v in tables.values()):
        bare = dk._resolve_and_pack(dict(pre[0]), dict(pre[1]), pre[2])
        err = max(err, _stream_diff(f"v2 {name} (no tables)", matrix({})[:2], bare))
        held.append("no tables")
    nodes = {
        "decode_updates_v2": _one_launch(name, lambda: dv2.decode_updates_v2(
            buf, lens, spans, U, R, max_sections=SEC, sidecar=side, **tables), path),
        "decode_updates_v2_raw": _one_launch(f"{name} (arena)", lambda: dv2.decode_updates_v2_raw(
            wire, offs, row_lens, alens, aspans, width, U, R, max_sections=SEC, sidecar=aside, **tables), path),
    }
    issued_ms = _time_ms(lambda: matrix(tables), reps=DECODE_KERNEL_REPS)
    dev_ms = graph_ms(lambda: matrix(tables), reps=DECODE_GRAPH_REPS)
    arena_ms = graph_ms(lambda: arena(tables), reps=DECODE_GRAPH_REPS)
    bound_b = _v2_bound_bytes(lens, spans, side, tables, U, R)
    arena_bound_b = _v2_bound_bytes(alens, aspans, aside, tables, U, R, arena=True)
    words = int(dv2._decode_v2_lib().ytpu_decode_v2_words(U, R, SEC))
    S = int(lens.shape[0])
    flags = plain[1]
    return {"lanes": S, "width": int(buf.shape[1]), "U": U, "R": R, "SEC": SEC,
            "wire_bytes": int(lens.long().sum()), "sidecar": side is not None, "flags_or": _or_lanes(flags),
            "error_lanes": int(((flags & dk.FLAG_ERRORS) != 0).sum()), "max_abs_err": err, "held": held,
            "path": path_m, "words_per_lane": words,
            "smem_bytes_per_cta": 32 * 4 * words if path_m == "shared" else 0,
            "scratch_bytes": 4 * words * S if path_m == "global" else 0, "graph_nodes": nodes,
            "kernel_ms": dev_ms["mean"], "kernel_ms_min_max": [dev_ms["min"], dev_ms["max"]],
            "arena_kernel_ms": arena_ms["mean"], "arena_kernel_ms_min_max": [arena_ms["min"], arena_ms["max"]],
            "issued_ms": issued_ms, "plain_ms": ref_ms + res_ms,
            "plain_ms_parts": {"reference": ref_ms, "resolve": res_ms}, "bound_bytes": bound_b,
            "bound_ms": bound_b / HBM_BYTES_PER_S * 1e3, "arena_bound_ms": arena_bound_b / HBM_BYTES_PER_S * 1e3,
            "tables": sorted(k for k, v in tables.items() if v is not None)}


def _decode_v2_sets(v2_log, log, dev) -> dict:
    """Part (a): the kernel against the plain composition on the crafted
    sets (each with the key and big-client tables; the big clients also
    without them), on one B4 chunk of CHUNK lanes (LATE_CHUNK) at the JAX
    package's full-log settings with a raw client table (its ids
    reversed) and without, and on merged B4 prefixes past the shared-memory
    budget (the device-memory scratch path)."""
    import torch

    from ytpu_torch.core.update import Update, merge_updates_v1

    with open(V2_CASES, encoding="utf-8") as f:
        data = json.load(f)
    tables = {k: tuple(torch.tensor(x, dtype=torch.int32, device=dev) for x in v) for k, v in data["tables"].items()}
    sets = {}
    for name, c in data["sets"].items():
        payloads = [bytes.fromhex(p) for p in c["payloads"]]
        sets[name] = _decode_v2_vs_plain(name, payloads, c["U"], c["R"], c["SEC"], tables, dev)
        if name == "big_clients":
            sets["big_clients_no_tables"] = _decode_v2_vs_plain(name, payloads, c["U"], c["R"], c["SEC"], {}, dev)
    chunk = v2_log[LATE_CHUNK * CHUNK:(LATE_CHUNK + 1) * CHUNK]
    ids = torch.arange(256, dtype=torch.int32, device=dev)
    sets["b4_chunk"] = _decode_v2_vs_plain("b4_chunk", chunk, V2_U, V2_R, V2_SEC, {}, dev, pad_to=V2_PAD)
    sets["b4_chunk"]["chunk"] = LATE_CHUNK
    sets["b4_chunk_client_table"] = _decode_v2_vs_plain(
        "b4_chunk_client_table", chunk, V2_U, V2_R, V2_SEC, {"client_table": (ids, ids.flip(0))}, dev,
        pad_to=V2_PAD)
    merged = [Update.decode_v1(merge_updates_v1(log[:n])).encode_v2() for n in V2_MERGED_PREFIXES]
    sets["merged_global"] = _decode_v2_vs_plain("merged_global", merged, V2_MERGED_U, V2_MERGED_R, V2_SEC, {}, dev,
                                                path="global")
    return sets


def _decode_v2_profile(v2_log, dev) -> dict:
    """Where a lane's cycles go on the B4 chunk of `_decode_v2_sets`: the
    profiling build's mean SM cycles a lane in each phase
    (`ytpu_torch.benches.decode_v2_profile.profile_table`)."""
    import torch

    from ytpu_torch.benches.decode_v2_profile import profile_table
    from ytpu_torch.ops.decode_v2 import pack_updates_v2

    chunk = v2_log[LATE_CHUNK * CHUNK:(LATE_CHUNK + 1) * CHUNK]
    buf, lens, spans = (torch.from_numpy(x).to(dev) for x in pack_updates_v2(chunk, pad_to=V2_PAD)[:3])
    return dict(profile_table(buf, lens, spans, V2_U, V2_R, V2_SEC), chunk=LATE_CHUNK)


def _decode_v2_full_log(v2_log, expect, dev) -> dict:
    """Part (b): the whole V2 log packed (`pack_updates_v2`), decoded on the
    card by one `decode_updates_v2` call (content refs ``s * L + byte`` of
    the one matrix), then replayed through `replay_stream_fused` as the
    stream_replay_full_width phase replays the V1 stream. Gates: no lane
    flagged, the first and last doc's text (read through `RawPayloadView`
    over the V2 matrix) equal to the log's, sticky error 0, one launch a
    call and one node, `decode_v2_kernel`, in a CUDA graph of the call
    (`_one_launch`). The same for `decode_updates_v2_raw` on the log's
    arena (the matrix's rows up to their lengths, made on the card), whose
    stream must equal the matrix call's. Also each entry's launch over the
    whole log in a CUDA graph, and one call's host wall."""
    import torch

    from ytpu_torch.models.batch_doc import get_string, init_state
    from ytpu_torch.ops import integrate_kernel as ik
    from ytpu_torch.ops.decode_kernel import FLAG_ERRORS, RawPayloadView, identity_rank
    from ytpu_torch.benches._kernels import graph_ms
    from ytpu_torch.ops.decode_v2 import _decode_v2_kernel, decode_updates_v2, decode_updates_v2_raw, pack_updates_v2

    t0 = time.perf_counter()
    buf_np, lens_np, spans_np, side_np = pack_updates_v2(v2_log, pad_to=V2_PAD)
    pack_s = time.perf_counter() - t0
    if side_np is not None:
        raise RuntimeError("decode_v2: the B4 log has no cold content, yet the pack made a sidecar")
    buf, lens, spans = (torch.from_numpy(x).to(dev) for x in (buf_np, lens_np, spans_np))
    S, L = buf.shape
    # the arena of `pack_updates_v2_raw` (no sidecar: each lane's bytes up to
    # its length, back to back), made on the card
    wire = buf[torch.arange(L, device=dev)[None, :] < lens[:, None].long()]
    offs = (torch.cumsum(lens, 0, dtype=torch.int32) - lens).contiguous()
    torch.cuda.synchronize()
    decode_updates_v2.launches = 0
    t1 = time.perf_counter()
    stream, flags = decode_updates_v2(buf, lens, spans, V2_U, V2_R, max_sections=V2_SEC)
    torch.cuda.synchronize()
    decode_call_s = time.perf_counter() - t1
    launches = decode_updates_v2.launches
    t1 = time.perf_counter()
    stream_a, flags_a = decode_updates_v2_raw(wire, offs, lens, lens, spans, L, V2_U, V2_R, max_sections=V2_SEC)
    torch.cuda.synchronize()
    arena_call_s = time.perf_counter() - t1
    arena_err = _stream_diff("v2 full log (arena against matrix)", (stream_a, flags_a), (stream, flags))
    del stream_a, flags_a
    flagged = int(((flags & FLAG_ERRORS) != 0).sum())
    nodes = _one_launch("full log", lambda: decode_updates_v2(buf, lens, spans, V2_U, V2_R, max_sections=V2_SEC),
                        "shared")
    nodes_a = _one_launch("full log (arena)", lambda: decode_updates_v2_raw(
        wire, offs, lens, lens, spans, L, V2_U, V2_R, max_sections=V2_SEC), "shared")
    kernel_ms = graph_ms(lambda: _decode_v2_kernel(buf, lens, spans, V2_U, V2_R, V2_SEC), reps=V2_FULL_GRAPH_REPS)
    arena_ms = graph_ms(lambda: _decode_v2_kernel(wire, lens, spans, V2_U, V2_R, V2_SEC, None, offs, lens, L),
                        reps=V2_FULL_GRAPH_REPS)
    bound_b = _v2_bound_bytes(lens, spans, None, {}, V2_U, V2_R)
    arena_bound_b = _v2_bound_bytes(lens, spans, None, {}, V2_U, V2_R, arena=True)
    del wire, offs
    torch.cuda.empty_cache()
    state = init_state(N_DOCS, CAPACITY, dev)
    rank = identity_rank(256, dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    state, st = ik.replay_stream_fused(state, stream, rank, chunk_steps=CHUNK, max_capacity=STREAM_MAX_CAPACITY)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t2
    err = int(state.error.max())
    view = RawPayloadView(buf_np)
    text_ok = [get_string(state, d, view) == expect for d in (0, N_DOCS - 1)]
    del state
    torch.cuda.empty_cache()
    out = {"updates": len(v2_log), "lane_width": int(L), "wire_bytes": int(lens_np.sum()),
           "pack_s": pack_s, "decode_call_s": decode_call_s, "arena_call_s": arena_call_s,
           "decode_launches": launches, "path": "shared",
           "kernel_ms": kernel_ms["mean"], "kernel_ms_min_max": [kernel_ms["min"], kernel_ms["max"]],
           "arena_kernel_ms": arena_ms["mean"], "arena_kernel_ms_min_max": [arena_ms["min"], arena_ms["max"]],
           "bound_bytes": bound_b, "bound_ms": bound_b / HBM_BYTES_PER_S * 1e3,
           "arena_bound_ms": arena_bound_b / HBM_BYTES_PER_S * 1e3, "arena_max_abs_err": arena_err,
           "decode_graph_nodes": nodes, "arena_graph_nodes": nodes_a,
           "flagged_lanes": flagged, "replay_wall_s": wall, "updates_per_s": len(v2_log) / wall,
           "capacity_end": st.capacity, "chunks": st.chunks, "sticky_error": err, "text_ok": text_ok}
    if flagged:
        raise RuntimeError(f"decode_v2: {flagged} lanes of the V2 B4 log flagged")
    if launches != 1:
        raise RuntimeError(f"decode_v2: the full-log call made {launches} counted launches")
    if err or not all(text_ok):
        raise RuntimeError(f"decode_v2: the V2 stream replay ended with sticky error {err}, texts {text_ok}")
    return out


def _decode_v2_ingest(log, dev) -> dict:
    """Part (c): `BatchIngestor.apply(v2=True)` at the ingest phase's width
    over V2_INGEST_STEPS steps of its cohorts transcoded to V2, beside
    `apply` of the same updates as V1 bytes: the two ingestors' packed
    cols and meta, state vectors and stashes equal after every step. ms a
    step on the host clock, each call ending in a synchronize."""
    import torch

    from ytpu_torch.benches import ingest as bench
    from ytpu_torch.core.update import Update
    from ytpu_torch.models.ingest import BatchIngestor
    from ytpu_torch.ops import integrate_kernel as ik

    logs = bench.load_ingest_logs()
    b4 = log[: bench.INGEST_STEPS]
    steps = [bench.step_payloads(t, b4, logs) for t in range(V2_INGEST_STEPS)]
    t0 = time.perf_counter()
    steps_v2 = [[None if p is None else Update.decode_v1(p).encode_v2() for p in step] for step in steps]
    transcode_s = time.perf_counter() - t0
    ing_v1 = BatchIngestor(bench.INGEST_DOCS, bench.INGEST_CAPACITY, device=dev)
    ing_v2 = BatchIngestor(bench.INGEST_DOCS, bench.INGEST_CAPACITY, device=dev)
    ms_v1, ms_v2, unequal = [], [], []
    for t in range(V2_INGEST_STEPS):
        for ing, payloads, v2, ms in ((ing_v1, steps[t], False, ms_v1), (ing_v2, steps_v2[t], True, ms_v2)):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ing.apply(payloads, v2=v2)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
        (c1, m1), (c2, m2) = ik.pack_state(ing_v1.state), ik.pack_state(ing_v2.state)
        if not (torch.equal(c1, c2) and torch.equal(m1, m2) and [s.clocks for s in ing_v1.svs]
                == [s.clocks for s in ing_v2.svs] and [sorted(p) for p in ing_v1._pending]
                == [sorted(p) for p in ing_v2._pending]):
            unequal.append(t)
    err = int(ing_v2.state.error.max())
    out = {"docs": bench.INGEST_DOCS, "capacity": bench.INGEST_CAPACITY, "steps": V2_INGEST_STEPS,
           "updates": sum(p is not None for s in steps for p in s), "transcode_s": transcode_s,
           "v2_ms_per_step": sum(ms_v2) / len(ms_v2), "v2_ms_min_max": [min(ms_v2), max(ms_v2)],
           "v1_ms_per_step": sum(ms_v1) / len(ms_v1), "unequal_steps": unequal, "sticky_error": err,
           "blocks": int(ing_v2.state.n_blocks.sum())}
    if unequal or err:
        raise RuntimeError(f"decode_v2: V2 ingest differs from V1 ingest after steps {unequal[:8]} "
                           f"(sticky error {err})")
    return out


def phase_decode_v2(gpu, log, expect, dev="cuda"):
    """The V2 lane on the card: the whole B4 log transcoded to V2 by the
    port's own codec (`Update.decode_v1(p).encode_v2()`, timed); (a) the
    decode kernel against its plain composition (`_decode_v2_sets`); (b)
    the whole log decoded and replayed (`_decode_v2_full_log`; the launch
    count is set to 0 just before its decode call and read just after);
    (c) V2 ingest against V1 ingest (`_decode_v2_ingest`). Also the
    profiling build's cycles a lane by phase on the B4 chunk
    (`_decode_v2_profile`), and the build's ptxas report of the kernel
    (registers, stack frame, spills; its shared memory is dynamic,
    `smem_bytes_per_cta` of each set)."""
    import torch

    from ytpu_torch.core.update import Update
    from ytpu_torch.ops import _build

    dev = torch.device(dev)
    t0 = time.perf_counter()
    v2_log = [Update.decode_v1(p).encode_v2() for p in log]
    transcode_s = time.perf_counter() - t0
    sets = _decode_v2_sets(v2_log, log, dev)
    profile = _decode_v2_profile(v2_log, dev)
    full = _decode_v2_full_log(v2_log, expect, dev)
    del v2_log
    ingest = _decode_v2_ingest(log, dev)
    ptxas = _ptxas(_build.build_log("decode_v2"), DECODE_V2_KERNEL)
    line = {"phase": "decode_v2", "transcode_s": transcode_s, "transcode_updates_per_s": len(log) / transcode_s,
            "sets": sets, "profile": profile, "full_log": full, "ingest": ingest, "ptxas": ptxas,
            "seconds": time.perf_counter() - t0, "gpu": gpu}
    emit(line)
    return line


def ik_launch_plan(plan) -> dict:
    """The integrate kernel's launch on the main path: one B4 chunk into
    the flagship envelope."""
    from ytpu_torch.ops.integrate_kernel import launch_plan

    return launch_plan(CHUNK, plan.max_rows, plan.max_dels, N_DOCS, CAPACITY)


# observability: the B4 replay with the recorders on, then the default
# sync server with the telemetry plane and admission, in a child process
OBS_TRACE = "b4-observability"
OBS_ROUNDS = 8  # FULL's write rounds, cut from 32 to bound time
OBS_MAX_QUEUE, OBS_RATE, OBS_BURST = 1, 2000.0, 64  # the admission controller: queue bound, updates/s, burst
OBS_SCRAPE_EVERY_S = 0.1
OBS_ENDPOINTS = ("metrics", "fleet", "snapshot", "profile", "healthz", "capacity")
OBS_CHILD_TIMEOUT_S = 420


def _median(xs):
    import statistics

    return statistics.median(xs) if xs else None


def phase_observability(gpu, log, expect, plan, b4):
    """The planes on the card. First the main path again, the B4 overlap
    lane at the main envelope over the whole log, with the phase recorder
    and the tracer on inside one `trace_context`: the text must be the
    log's, the snapshot must carry the JAX package's replay stages (the
    chunk stage a call a chunk, the decode stage with its host-to-device
    bytes, compaction as often as in the untraced run, the overlap
    engine's stage / stall / overlap_ratio / inflight_depth / stage_bytes),
    the tracer must hold a ``replay.stage_slot`` and a
    ``replay.dispatch_slot`` span a chunk naming the ambient trace id, and
    the readout syncs must equal the untraced run's (the recorders add
    none). Then `_observability_server` in a child process (a fresh
    registry, as a serving process starts). Returns the launches of both
    parts by kernel."""
    import torch

    from ytpu_torch.utils import phases, trace_context, tracer

    phases.reset()
    tracer.clear()
    phases.enable()
    tracer.enable()
    try:
        with trace_context(trace=OBS_TRACE):
            st, wall, launches, _, _, _, rep, decodes = _replay(plan, log, expect, traced=False)
    finally:
        phases.disable()
        tracer.disable()
    del rep
    snap = phases.snapshot()
    events = json.loads(tracer.export_chrome_trace())["traceEvents"]
    phases.reset()
    tracer.clear()
    torch.cuda.empty_cache()
    want_stages = ("replay.chunk_raw", "decode.v1", "compact.packed", "replay.stage", "replay.stall",
                   "replay.overlap_ratio", "replay.inflight_depth", "replay.stage_bytes")
    missing = [s for s in want_stages if s not in snap]
    slots = {name: [e for e in events if e["name"] == name] for name in ("replay.stage_slot", "replay.dispatch_slot")}
    problems = []
    if missing:
        problems.append(f"stages missing: {missing}")
    else:
        if not snap["replay.chunk_raw"]["calls"] == st.chunks == launches:
            problems.append(f"chunk stage {snap['replay.chunk_raw']['calls']} calls, {st.chunks} chunks")
        if snap["decode.v1"]["calls"] != decodes or snap["decode.v1"]["h2d_bytes"] <= 0:
            problems.append(f"decode stage {snap['decode.v1']}")
        if snap["compact.packed"]["calls"] != b4["compactions"]:
            problems.append(f"compaction stage {snap['compact.packed']['calls']} calls, untraced run "
                            f"{b4['compactions']}")
        if snap["replay.stage_bytes"].get("value") != st.stage_bytes:
            problems.append(f"stage bytes {snap['replay.stage_bytes']} against {st.stage_bytes}")
    for name, spans in slots.items():
        if len(spans) != st.chunks or any(e.get("args", {}).get("trace") != OBS_TRACE for e in spans):
            problems.append(f"{len(spans)} {name} spans for {st.chunks} chunks, or one without the trace id")
    if st.syncs != b4["overlap"]["syncs"]:
        problems.append(f"{st.syncs} readout syncs with the recorders on, {b4['overlap']['syncs']} off")
    if problems:
        raise RuntimeError("observability: " + "; ".join(problems))
    replay = {
        "wall_s": wall, "wall_s_untraced_main_run": b4["wall_s"], "wall_ratio": wall / b4["wall_s"],
        "chunks": st.chunks, "syncs": st.syncs, "launches": launches, "decode_launches": decodes,
        "spans": len(events), "stages": {k: snap[k] for k in want_stages},
        "compile_calls": {k: v["compile_calls"] for k, v in snap.items() if v["compile_calls"]},
    }
    server = _observability_server_in_child()
    line = {"phase": "observability", "replay": replay, "server": server, "gpu": gpu}
    emit(line)
    return {"integrate_stream": launches, "decode_v1": decodes + server["launches"]["decode_v1"],
            "integrate_batch": server["launches"]["integrate_batch"]}


def _observability_server_in_child() -> dict:
    """`_observability_server` in a fresh interpreter (``python3
    chip_smoke.py --observability-server OUT``), so its registry, recorder
    and tracer hold only that run; returns its result, or raises with the
    child's stderr tail."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "observability_server.json")
        proc = subprocess.run([sys.executable, os.path.join(HERE, "chip_smoke.py"), "--observability-server", out],
                              cwd=HERE, capture_output=True, text=True, timeout=OBS_CHILD_TIMEOUT_S)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0 or not os.path.exists(out):
            raise RuntimeError(f"observability: the server child exited {proc.returncode}: {proc.stderr[-2000:]}")
        with open(out) as f:
            return json.load(f)


class _Scraper:
    """A thread that fetches every telemetry endpoint each
    `OBS_SCRAPE_EVERY_S` and records each answer's status, latency and
    whether its body parses (JSON, or Prometheus text lines)."""

    def __init__(self, url: str):
        import threading

        self.url = url
        self.records = []  # (endpoint, status, seconds, parsed, body or None)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def scrape(self, ep: str):
        import re
        import urllib.request

        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(f"{self.url}/{ep}", timeout=30) as r:
                status, body = r.status, r.read().decode()
        except Exception as e:  # recorded as a failed scrape
            self.records.append((ep, None, time.perf_counter() - t0, False, repr(e)))
            return None
        dt = time.perf_counter() - t0
        parsed = None
        try:
            if ep in ("metrics", "fleet"):
                sample = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? (\S+)$')
                for ln in body.splitlines():
                    if ln and not ln.startswith("#"):
                        float(sample.match(ln).group(2))
                parsed = body
            else:
                parsed = json.loads(body)
        except Exception:
            parsed = None
        self.records.append((ep, status, dt, parsed is not None, parsed if ep in ("healthz", "profile") else None))
        return parsed

    def _loop(self):
        while not self._stop.is_set():
            for ep in OBS_ENDPOINTS:
                self.scrape(ep)
            self._stop.wait(OBS_SCRAPE_EVERY_S)

    def start(self):
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._thread.join()


def _observability_server(out_path: str) -> int:
    """The child of `phase_observability`: the default (mirrored)
    `DeviceSyncServer` at 1,024 tenants x 8,192 slots on `FULL`'s cohorts,
    cut to `OBS_ROUNDS` write rounds, with ``telemetry_port=0``, the phase
    recorder and the tracer on and an `AdmissionController(policy="defer")`
    whose queue bound and rate refuse part of each round; the writers
    (`benches/sync_server.drive_admitted_writes`) send each frame in its
    own request trace context and send a deferred update again after its
    ``retry_after_s``. A scraper thread fetches all six endpoints every
    ~100 ms. Then the same plan through a server without the planes
    (`drive_writes`). Holds: every scrape 200 with a parseable body;
    ``/healthz`` "never" before the first flush and an age after the
    last; Busy replies > 0 and equal to ``sync.busy_replies``; every
    tenant's device value equal between the two runs and its host doc's
    value too; every ``/profile`` sum of fractions 1 within 1e-6; the
    Chrome dump's ``sync.dispatch`` spans name only the writers' trace
    ids, and some. Writes the result to `out_path`."""
    import dataclasses
    import tempfile

    import torch

    sys.path.insert(0, HERE)
    from ytpu_torch.benches import ingest as ingest_bench
    from ytpu_torch.benches import sync_server as bench
    from ytpu_torch.core.doc import Doc
    from ytpu_torch.ops import integrate_kernel as ik
    from ytpu_torch.ops.decode_kernel import decode_updates_v1
    from ytpu_torch.serving import AdmissionController
    from ytpu_torch.sync import DeviceSyncServer
    from ytpu_torch.utils import metrics, phases, tracer

    with gzip.open(B4_LOG, "rb") as f:
        log = pickle.load(f)["log"]
    plan = dataclasses.replace(bench.FULL, rounds=OBS_ROUNDS)
    tenants = bench.make_tenants(plan, log, ingest_bench.load_ingest_logs())
    ids = {t.name: bench.tenant_client_id(t.index) for t in tenants}

    def make(**kw):
        return DeviceSyncServer(n_docs=plan.n_docs, capacity=plan.capacity, device="cuda",
                                doc_factory=lambda name: Doc(client_id=ids[name]), **kw)

    def timed(server, out):
        def flush(step):
            t0 = time.perf_counter()
            n = server.flush_device()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
            return n
        return flush

    problems = []
    # --- the planes attached
    phases.enable()
    tracer.enable()
    server = make(telemetry_port=0)
    server.admission = AdmissionController(max_queue=OBS_MAX_QUEUE, rate=OBS_RATE, burst=OBS_BURST, policy="defer")
    scraper = _Scraper(server.telemetry.url)
    before = {ep: scraper.scrape(ep) for ep in OBS_ENDPOINTS}
    if before["healthz"] is None or before["healthz"].get("last_dispatch") != "never":
        problems.append(f"/healthz before the first flush: {before['healthz']}")
    on_ms = []
    _reset_counts([ik.integrate_batch, decode_updates_v1])
    scraper.start()
    t0 = time.perf_counter()
    try:
        run = bench.drive_admitted_writes(server, plan, tenants, flush=timed(server, on_ms))
    finally:
        scraper.stop()
    write_s = time.perf_counter() - t0
    launches = {"integrate_batch": ik.integrate_batch.launches, "decode_v1": decode_updates_v1.launches}
    after = scraper.scrape("healthz")
    if after is None or "last_dispatch_age_s" not in after or "last_dispatch" in after:
        problems.append(f"/healthz after the flushes: {after}")
    tracer.disable()
    phases.disable()
    with tempfile.TemporaryDirectory() as tmp:
        dump = os.path.join(tmp, "trace.json")
        tracer.export_chrome_trace(dump)
        with open(dump) as f:
            events = json.load(f)["traceEvents"]
    named = {tid for e in events if e["name"] == "sync.dispatch" for tid in e.get("args", {}).get("traces", [])}
    admitted = set(run.admitted_traces)
    if not named or not named <= admitted:
        problems.append(f"sync.dispatch spans name {len(named)} trace ids, {len(named - admitted)} not a writer's")
    busy_metric = int(metrics.counter("sync.busy_replies").value)
    if run.busy <= 0 or run.busy != busy_metric:
        problems.append(f"{run.busy} Busy replies, sync.busy_replies {busy_metric}")
    if run.other_replies:
        problems.append(f"{len(run.other_replies)} replies to writes that were not Busy")
    bad = [r[:4] for r in scraper.records if r[1] != 200 or not r[3]]
    if bad:
        problems.append(f"{len(bad)} failed scrapes, first {bad[:3]}")
    sums = [r[4]["fractions_sum"] for r in scraper.records if r[0] == "profile" and r[4]]
    if not sums or any(abs(s - 1.0) > 1e-6 for s in sums):
        problems.append(f"/profile fraction sums {sums[:5]}")
    values_on = [bench.tenant_value(server, t) for t in tenants]
    host_on = [bench.host_value(server.doc(t.name), t) for t in tenants]
    server.telemetry.stop()
    rejected = {k: v for k, v in metrics.snapshot().items() if k.startswith("admission.rejected")}
    del server
    torch.cuda.empty_cache()
    # --- the same plan without the planes
    off_ms = []
    plain = make()
    t0 = time.perf_counter()
    bench.drive_writes(plain, plan, tenants, flush=timed(plain, off_ms))
    plain_write_s = time.perf_counter() - t0
    values_off = [bench.tenant_value(plain, t) for t in tenants]
    if values_on != values_off or host_on != values_off:
        diff = [t.name for t, a, b, h in zip(tenants, values_on, values_off, host_on) if a != b or h != b]
        problems.append(f"{len(diff)} tenants end differently with the planes attached, first {diff[:4]}")
    scrape_ms = [r[2] * 1e3 for r in scraper.records]
    result = {
        "tenants": len(tenants), "capacity": plan.capacity, "rounds": plan.rounds,
        "admission": {"max_queue": OBS_MAX_QUEUE, "rate": OBS_RATE, "burst": OBS_BURST, "policy": "defer"},
        "busy_replies": run.busy, "sync_busy_replies": busy_metric, "rejected": rejected, "resent": run.resent,
        "drain_rounds": run.drain_rounds, "admitted_frames": len(admitted), "dispatch_named_traces": len(named),
        # the write rounds' steps alone beside every step (the rest's and
        # the resend rounds' flushes carry other loads)
        "flush_ms_planes": {"median": _median(on_ms), "mean": sum(on_ms) / len(on_ms), "steps": len(on_ms),
                            "rounds_median": _median(on_ms[:plan.rounds])},
        "flush_ms_plain": {"median": _median(off_ms), "mean": sum(off_ms) / len(off_ms), "steps": len(off_ms),
                           "rounds_median": _median(off_ms[:plan.rounds])},
        "write_s_planes": write_s, "write_s_plain": plain_write_s,
        "scrapes": len(scraper.records), "scrape_ms": {"median": _median(scrape_ms), "max": max(scrape_ms)},
        "scrape_ms_by_endpoint": {ep: {"median": _median(ms), "max": max(ms)} for ep in OBS_ENDPOINTS
                                  for ms in [[r[2] * 1e3 for r in scraper.records if r[0] == ep]] if ms},
        "healthz_before": before["healthz"], "healthz_after": after, "profile_fraction_sums": [min(sums), max(sums)]
        if sums else None, "trace_events": len(events), "launches": launches,
        "values_equal_plain": values_on == values_off, "problems": problems,
    }
    with open(out_path, "w") as f:
        json.dump(result, f)
    if problems:
        print("observability server: " + "; ".join(problems), file=sys.stderr)
        return 1
    return 0


def main() -> int:
    import torch

    t_script = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import ytpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    from ytpu_torch.models.replay import plan_replay

    gpu = gpu_line()
    with gzip.open(B4_LOG, "rb") as f:
        data = pickle.load(f)
    log, expect = data["log"], data["expect"]

    ptxas = phase_build(gpu)
    phase_native(gpu, log)
    t0 = time.perf_counter()
    plan = plan_replay(log)
    plan_s = time.perf_counter() - t0
    decode_sets, decode_ptxas, decode_inputs = phase_decode(gpu, log, plan)
    max_err = phase_kernel_vs_plain(gpu, log, plan)
    err_full, full_kernel_ms, full_plain_ms, profile = phase_full_width_vs_plain(gpu, log, plan)
    launches, ms, bound_ms, rep, b4 = phase_b4_replay(gpu, log, expect, plan, plan_s)
    torch.cuda.empty_cache()
    lanes = phase_replay_lanes(gpu, log, expect, plan, rep)
    torch.cuda.empty_cache()
    sync = phase_sync_step(gpu, log, plan, rep)
    del rep
    torch.cuda.empty_cache()
    ingest, ing = phase_ingest(gpu, log)
    torch.cuda.empty_cache()
    sync_server, decode_inputs["sync_server_round"], server = phase_sync_server(gpu, log)
    torch.cuda.empty_cache()
    mirrored, decode_inputs["sync_server_mirrored_round"] = phase_sync_server_mirrored(gpu, log)
    torch.cuda.empty_cache()
    pipe_ckpt = phase_pipeline_checkpoint(gpu, log, ing, server)
    del ing, server
    torch.cuda.empty_cache()
    stream_launches, stream_vs_plain, stream_launch_ms, stream_decodes = phase_stream_replay_full_width(
        gpu, log, expect, plan)
    torch.cuda.empty_cache()
    v2 = phase_decode_v2(gpu, log, expect)
    torch.cuda.empty_cache()
    obs = phase_observability(gpu, log, expect, plan, b4)
    torch.cuda.empty_cache()
    diag_launches, ladder_err = phase_mosaic_ladder(gpu)
    ladder_integrate = diag_launches.pop("integrate_stream")
    ladder_decodes = diag_launches.pop("decode_updates_v1")
    diag_launches.update(phase_plane_rmw(gpu))
    diag = phase_diag_kernels(gpu, diag_launches)
    decode_sets["sync_server_round"] = sync_server["decode_vs_plain"]
    decode_sets["sync_server_mirrored_round"] = mirrored["decode_vs_plain"]
    decode_ms = _decode_graph_ms(decode_inputs)
    del decode_inputs
    for name, t in decode_ms.items():
        decode_sets[name].update(kernel_ms=t["mean"], kernel_ms_min_max=[t["min"], t["max"]])
    emit({"phase": "decode_timing", "kernel_ms": decode_ms, "graph_launches": DECODE_GRAPH_REPS, "gpu": gpu})
    decode_by_path = {"b4_replay": b4["decode_launches"], "b4_replay_serial": b4["serial"]["decode_launches"],
                      "replay_lanes": lanes["launches"]["decode_v1"],
                      "pipeline_checkpoint": pipe_ckpt["launches"]["replay"]["decode_v1"],
                      "ingest": ingest["decode_launches"],
                      "sync_server": sync_server["decode_launches"],
                      "sync_server_mirrored": mirrored["decode_launches"], "stream_replay_full_width": stream_decodes,
                      "mosaic_ladder": ladder_decodes, "observability": obs["decode_v1"]}
    chunk = decode_sets["b4_chunk"]
    v2_chunk = v2["sets"]["b4_chunk"]
    script_s = time.perf_counter() - t_script
    emit({"phase": "total", "seconds": script_s, "limit_s": 1200})
    print(f"gpu: {gpu}", flush=True)
    emit({"kernels": [{
        "name": "integrate_stream", "route": "cuda", "source": "ytpu_torch/csrc/integrate.cu",
        "replaces": INTEGRATE_REPLACES, "launches": launches,
        "max_abs_err": max(max_err, err_full, stream_vs_plain["max_abs_err"], ladder_err),
        "ms": ms, "plain_ms": full_plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
        "library_ms": None,
        "launches_by_path": {"b4_replay": launches, "b4_replay_serial": b4["serial"]["launches"],
                             "replay_lanes": lanes["launches"]["integrate_stream"],
                             "pipeline_checkpoint": sum(v["integrate_stream"] for k, v in pipe_ckpt["launches"].items()
                                                        if isinstance(v, dict)),
                             "stream_replay_full_width": stream_launches, "mosaic_ladder": ladder_integrate,
                             "observability": obs["integrate_stream"]},
        "launches_by_entry": {"stream": launches,
                              "batch": sync["write"]["launches"]["batch"] + ingest["launches"]["batch"]
                              + sync_server["launches"]["batch"] + mirrored["launches"]["batch"]
                              + pipe_ckpt["launches"]["checkpoint_integrate_batch"] + obs["integrate_batch"]},
        "plain_vs_kernel_case": {
            "shape": f"one B4 chunk, 2 docs, C={CAPACITY}, S={CHUNK}",
            "kernel_ms": full_kernel_ms, "plain_ms": full_plain_ms,
        },
        "plain_vs_kernel_grown": stream_vs_plain,
        "stream_replay_launch_ms": {cap: {k: v[k] for k in ("launches", "ms_mean", "ms_max")}
                                    for cap, v in stream_launch_ms.items()},
        "cycles_per_step": profile["cycles_per_step"],
        "launch_plan": ik_launch_plan(plan), "ptxas": ptxas["integrate"],
        "gpu": gpu,
    }, {
        "name": "integrate_batch", "route": "cuda", "source": "ytpu_torch/csrc/integrate.cu",
        "replaces": INTEGRATE_REPLACES,
        "launches": sync["write"]["launches"]["batch"] + ingest["launches"]["batch"]
        + sync_server["launches"]["batch"] + mirrored["launches"]["batch"]
        + pipe_ckpt["launches"]["checkpoint_integrate_batch"] + obs["integrate_batch"],
        "launches_by_path": {"sync_step": sync["write"]["launches"]["batch"],
                             "ingest": ingest["launches"]["batch"],
                             "sync_server": sync_server["launches"]["batch"],
                             "sync_server_mirrored": mirrored["launches"]["batch"],
                             "pipeline_checkpoint": pipe_ckpt["launches"]["checkpoint_integrate_batch"],
                             "observability": obs["integrate_batch"]},
        "max_abs_err": max(sync["kernel_vs_plain"]["max_abs_err"],
                           sync["write"]["max_abs_err_full_width_step"], ingest["max_abs_err"],
                           sync_server["max_abs_err"], mirrored["max_abs_err"]),
        "ms": sync["write"]["kernel_ms"], "plain_ms": sync["write"]["plain_ms_full_width_step"],
        "bound_ms": sync["write"]["bound_ms"], "bound_by": "bytes", "library_ms": None,
        "entry": "ytpu_integrate_batch (integrate_batch_kernel), the port of apply_update_batch's "
                 "vmapped _apply_update_one_doc (ytpu/models/batch_doc.py:1379, :1462)",
        "shape": f"{WRITE_DOCS} docs, C={WRITE_CAPACITY}, one update per doc per launch",
        "launch_plan": sync["write"]["launch_plan"], "ptxas": ptxas["integrate_batch"],
        "index_ptxas": ptxas["integrate_batch_index"],
        "index_kernel_ms": sync["write"]["index_kernel_ms"],
        "integrate_kernel_ms": sync["write"]["integrate_kernel_ms"],
        "cleared_bytes_per_launch": sync["write"]["cleared_bytes_per_launch"],
        "launch_floor": sync["write"]["launch_floor"],
        "phase_split": {k: {w: v[w] for w in ("phase1_cycles", "phase2_cycles", "phase1_share", "cleared_bytes")}
                        for k, v in sync["write"]["profile"].items() if isinstance(v, dict)},
        "plain_vs_kernel_case": sync["kernel_vs_plain"],
        "plain_vs_kernel_ingest_step": {k: ingest[k] for k in ("snapshot_step", "snapshot_rows",
                                                               "snapshot_kernel_ms", "snapshot_plain_ms",
                                                               "max_abs_err")},
        "ingest_kernel_ms": {"index": ingest["index_kernel_ms"], "integrate": ingest["integrate_kernel_ms"]},
        "plain_vs_kernel_sync_server_round": {k: sync_server[k] for k in (
            "snapshot_step", "snapshot_lanes", "snapshot_kernel_ms", "snapshot_plain_ms", "max_abs_err")},
        "sync_server_kernel_ms": {"index": sync_server["index_kernel_ms"],
                                  "integrate": sync_server["integrate_kernel_ms"]},
        "plain_vs_kernel_sync_server_mirrored_round": {k: mirrored[k] for k in (
            "snapshot_step", "snapshot_lanes", "snapshot_kernel_ms", "snapshot_plain_ms", "max_abs_err")},
        "gpu": gpu,
    }, {
        "name": "decode_v1", "route": "cuda", "source": "ytpu_torch/csrc/decode.cu",
        "replaces": DECODE_REPLACES, "loop": DECODE_LOOP, "launches": sum(decode_by_path.values()),
        "launches_by_path": decode_by_path,
        "max_abs_err": max(v["max_abs_err"] for v in decode_sets.values()),
        "ms": chunk["kernel_ms"], "plain_ms": chunk["plain_ms"], "bound_ms": chunk["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "shape": f"one B4 chunk: S={chunk['lanes']} lanes of L={chunk['width']}, U={chunk['U']}, "
                 f"R={chunk['R']}, T={chunk['T']}",
        "ms_by_path": {"b4_replay": b4["traced"]["decode_kernel_ms_mean"],
                       "ingest": ingest["decode_kernel_ms"], "sync_server": sync_server["decode_kernel_ms"]},
        "longest_lane_steps": max(v["longest_lane_steps"] for v in decode_sets.values()),
        "sets": {k: {w: v[w] for w in ("lanes", "U", "R", "T", "longest_lane_steps", "max_abs_err", "kernel_ms",
                                       "issued_ms", "plain_ms", "bound_ms")} for k, v in decode_sets.items()},
        "ptxas": decode_ptxas, "gpu": gpu,
    }, {
        "name": "decode_v2", "route": "cuda", "source": "ytpu_torch/csrc/decode_v2.cu",
        "replaces": DECODE_V2_REPLACES, "loops": DECODE_V2_LOOPS, "launches": v2["full_log"]["decode_launches"],
        "launches_by_path": {"decode_v2 (the V2 B4 stream)": v2["full_log"]["decode_launches"]},
        "max_abs_err": max([v["max_abs_err"] for v in v2["sets"].values()] + [v2["full_log"]["arena_max_abs_err"]]),
        "ms": v2_chunk["kernel_ms"], "plain_ms": v2_chunk["plain_ms"], "bound_ms": v2_chunk["bound_ms"],
        "bound_by": "bytes", "library_ms": None, "issued_ms": v2_chunk["issued_ms"],
        "arena_ms": v2_chunk["arena_kernel_ms"],
        "shape": f"one V2 B4 chunk: S={v2_chunk['lanes']} lanes of L={v2_chunk['width']}, U={v2_chunk['U']}, "
                 f"R={v2_chunk['R']}, {v2_chunk['SEC']} sections",
        "sets": {k: {w: v[w] for w in ("lanes", "error_lanes", "flags_or", "max_abs_err", "path", "kernel_ms",
                                       "arena_kernel_ms", "issued_ms", "plain_ms", "bound_ms")}
                 for k, v in v2["sets"].items()},
        "full_log": {k: v2["full_log"][k] for k in ("updates", "decode_call_s", "arena_call_s", "kernel_ms",
                                                    "arena_kernel_ms", "bound_ms", "path", "decode_graph_nodes",
                                                    "replay_wall_s", "flagged_lanes")},
        "ptxas": v2["ptxas"], "gpu": gpu,
    }] + [{**{k: e[k] for k in KERNEL_KEYS}, **({"full_width": e["full_width"]} if "full_width" in e else {})}
          for e in diag]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--observability-server"]:
        sys.exit(_observability_server(sys.argv[2]))
    sys.exit(main())
