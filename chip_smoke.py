"""GPU smoke run of the port: build the CUDA kernels, hold each against its
plain PyTorch version, and replay the full B4 wire log through the port's
main path.

Usage (on a machine with one NVIDIA GPU and the CUDA toolkit):

    python3 chip_smoke.py

Phases, one JSON line each: ``build``, ``kernel_vs_plain`` (small cases),
``kernel_vs_plain_full_width`` (one late B4 chunk at the main path's
capacity and chunk size), ``b4_replay`` (`FusedReplay.run` over the whole
log at 256 docs, then the same run under `torch.profiler`); then the
card's name and power limit, the ``kernels`` line and, last,
``{"ok": true, "device": {...}}``. Any failure exits non-zero without the
last line. It imports neither JAX nor the JAX package.
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

# card peak used for the bound (H100 SXM data sheet): HBM3 bytes per second
HBM_BYTES_PER_S = 3.35e12
INTEGRATE_REPLACES = "ytpu/ops/integrate_kernel.py:1057"


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


# --- synthetic stream: concurrent clients, map, nested, move rows ---------------


def synthetic_stream(seed: int, steps: int, U: int = 4, R: int = 2, storm_every: int = 5):
    """A seeded ``[S, U, 23]`` row / ``[S, R, 4]`` delete stream over six
    clients (one above the rank table, one above the client-clock table):
    string, deleted, GC, format, nested-type and move rows, map rows on
    three keys, root-anchor parents, gaps and duplicates, and every
    `storm_every`-th step a same-origin storm of U concurrent inserts."""
    import numpy as np

    rng = np.random.default_rng(seed)
    clients = [1, 2, 3, 7, 300, 5000]
    nxt = {c: 0 for c in clients}
    ids = []  # (client, clock, len, kind)
    types = []
    rows = np.zeros((steps, U, 23), dtype=np.int32)
    dels = np.zeros((steps, R, 4), dtype=np.int32)
    ref = 0

    def some_id():
        c, k, n, _ = ids[int(rng.integers(len(ids)))]
        return c, k + int(rng.integers(n))

    for s in range(steps):
        storm = s % storm_every == storm_every - 1 and ids
        storm_origin = some_id() if storm else None
        for u in range(U):
            r = rows[s, u]
            c = clients[u % len(clients)] if storm else clients[int(rng.integers(len(clients)))]
            kind = int(rng.choice([4, 4, 4, 4, 1, 0, 6, 7, 11]))
            length = 1 if kind in (6, 7, 11) else int(rng.integers(1, 4))
            clock = nxt[c]
            roll = rng.random()
            if roll < 0.05:
                clock += 1  # gap: missing dependency
            elif roll < 0.10 and clock > 0:
                clock = max(0, clock - 1)  # partial duplicate
            oc = ok = -1
            rc, rk = -1, 0
            if storm:
                oc, ok = storm_origin
            elif ids and rng.random() < 0.75:
                oc, ok = some_id()
            if not storm and ids and rng.random() < 0.4:
                rc, rk = some_id()
            key, ptag, pc, pk, proot = -1, 0, -1, 0, -1
            if oc < 0 and rc < 0:
                ptag = int(rng.choice([1, 1, 2])) if types else 1
                if ptag == 2:
                    pc, pk = types[int(rng.integers(len(types)))]
                elif rng.random() < 0.2:
                    proot = int(rng.choice([7, 9]))  # anchor 7 exists, 9 does not
                if rng.random() < 0.3:
                    key = int(rng.integers(3))
            mv = (-1, 0, 0, -1, 0, 0, -1)
            if kind == 11 and ids:
                sc, sk = some_id()
                if rng.random() < 0.4:
                    ec, ek = sc, sk  # collapsed
                else:
                    ec, ek = some_id()
                mv = (sc, sk, int(rng.choice([0, -1])), ec, ek, int(rng.choice([0, -1])),
                      int(rng.integers(3)))
            valid = 0 if rng.random() < 0.05 else 1
            r[:] = [c, clock, length, oc, max(ok, 0), rc, rk, kind, ref, 0, key, ptag,
                    pc, pk, valid, *mv, proot]
            ref += length
            if valid:
                ids.append((c, clock, length, kind))
                nxt[c] = max(nxt[c], clock + length)
                if kind == 7:
                    types.append((c, clock))
        for q in range(R):
            if ids and rng.random() < 0.6:
                c, k, n, _ = ids[int(rng.integers(len(ids)))]
                a = k + int(rng.integers(n))
                b = a + int(rng.integers(1, 4))
                dels[s, q] = [c, a, b, 1]
    return rows, dels


def anchored_state(n_docs: int, capacity: int, device):
    """Empty packed state with a root-anchor row for key 7 in every doc."""
    from ytpu_torch.models.batch_doc import init_state
    from ytpu_torch.ops.integrate_kernel import CL, KD, KEY, LN, M_NBLOCKS, pack_state

    cols, meta = pack_state(init_state(n_docs, capacity, device))
    cols[KD, :, 0] = 12
    cols[KEY, :, 0] = 7
    cols[CL, :, 0] = -1
    cols[LN, :, 0] = 0
    meta[:, M_NBLOCKS] = 1
    return cols, meta


# --- phases ---------------------------------------------------------------------------


def phase_build(gpu):
    from ytpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    # load each library now, so that no timed launch pays for the dlopen
    for name in libs:
        _build.load(name)
    emit({"phase": "build", "seconds": build_s, "load_seconds": time.perf_counter() - t0 - build_s,
          "libraries": sorted(libs), "gpu": gpu})


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


def _b4_chunks(plan, log, starts, chunk: int, device):
    """Stage and decode the B4 chunks of `chunk` updates that begin at
    `starts`, as the main path does: ``[(rows, dels), ...]`` with global
    unit refs."""
    import numpy as np
    import torch

    from ytpu_torch.models.replay import build_wire_table, raw_chunk_cap
    from ytpu_torch.ops.decode_kernel import pack_raw_updates_into
    from ytpu_torch.ops.integrate_kernel import decode_chunk_raw

    wire, woffs = build_wire_table(log)
    cap = raw_chunk_cap(woffs, chunk)
    width = plan.max_len + 16
    out = []
    for pos in starts:
        end = min(pos + chunk, len(log))
        raw = np.zeros(cap, np.uint8)
        offs = np.zeros(chunk, np.int32)
        lens = np.zeros(chunk, np.int32)
        pack_raw_updates_into(wire, woffs, pos, end, raw, offs, lens, width=width)
        refs = np.full((chunk, plan.unit_refs.shape[1]), -1, np.int32)
        refs[: end - pos] = plan.unit_refs[pos:end]
        t = [torch.from_numpy(a).to(device) for a in (raw, offs, lens, refs)]
        err = torch.zeros((), dtype=torch.int32, device=device)
        rows, dels, err = decode_chunk_raw(
            err, *t, width=width, max_rows=plan.max_rows, max_dels=plan.max_dels,
            n_steps=plan.max_steps, max_sections=plan.max_sections,
        )
        if int(err):
            raise RuntimeError(f"decode flagged the B4 chunk at {pos}: {int(err)}")
        out.append((rows, dels))
    return out


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
    chunks = _b4_chunks(plan, log, (0, 512), 512, dev)
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
    emit({"phase": "kernel_vs_plain", "equal": True, "max_abs_err": max_err, "cases": cases, "gpu": gpu})
    return max_err


def phase_full_width_vs_plain(gpu, log, plan):
    """The kernel against its plain version at the main path's capacity
    and chunk size, on a compacted state with the clocks of a late chunk.
    Docs are independent and the B4 stream is shared by every doc, so two
    docs replayed through `FusedReplay.run` up to LATE_CHUNK hold the state
    that each doc of the main path holds there."""
    import torch

    from ytpu_torch.models.replay import FusedReplay
    from ytpu_torch.ops.integrate_kernel import (
        CK, M_NBLOCKS, integrate_stream, integrate_stream_reference,
    )

    pos = LATE_CHUNK * CHUNK
    rep = FusedReplay(2, plan, capacity=CAPACITY, max_capacity=CAPACITY, chunk=CHUNK, device="cuda")
    rep.run(log[:pos])
    rep.driver.compact()  # slots renumbered, as after a compaction in the run
    cols_k, meta_k, rank = rep.driver.cols, rep.driver.meta, rep.driver.rank
    blocks_before = int(meta_k[:, M_NBLOCKS].max())
    ((rows, dels),) = _b4_chunks(plan, log, (pos,), CHUNK, cols_k.device)
    cols_p, meta_p = cols_k.clone(), meta_k.clone()
    k_ms = _time_ms(lambda: integrate_stream(cols_k, meta_k, rows, dels, rank))
    t0 = time.perf_counter()
    p_ms = _time_ms(lambda: integrate_stream_reference(cols_p, meta_p, rows, dels, rank))
    plain_s = time.perf_counter() - t0
    max_err = _compare("full width", cols_k, meta_k, cols_p, meta_p)
    line = {
        "phase": "kernel_vs_plain_full_width", "equal": True, "max_abs_err": max_err,
        "case": f"B4 updates {pos}..{pos + CHUNK} after a compaction, 2 docs, C={CAPACITY}, S={CHUNK}",
        "blocks_before": blocks_before, "blocks_after": int(meta_k[:, M_NBLOCKS].max()),
        "max_clock": int(cols_k[CK].max()), "kernel_ms": k_ms, "plain_ms": p_ms,
        "plain_wall_s": plain_s, "gpu": gpu,
    }
    emit(line)
    return max_err, k_ms, p_ms


def _trace_breakdown(prof, wall_s: float):
    """From the raw events of a `torch.profiler` trace: device and host
    seconds per phase span (``ytpu_torch.*``; device work launched outside
    any span is ``other``), the device time of every integrate kernel, and
    the device's idle share of the traced wall time. A device event is
    placed by the host time of the runtime call that launched it (the CPU
    event of the same CUPTI correlation id)."""
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
    host_s, device_s = {}, {"other": 0.0}
    for s, t, name in spans:
        host_s[name] = host_s.get(name, 0.0) + (t - s) / 1e9
        device_s.setdefault(name, 0.0)
    busy, integrate_ms = [], []
    for e in events:
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        busy.append((e.start_ns(), e.end_ns()))
        if "integrate_kernel" in e.name():
            integrate_ms.append(e.duration_ns() / 1e6)
        t = launched_at.get(e.correlation_id())
        i = bisect.bisect_right(span_starts, t) - 1 if t is not None else -1
        name = spans[i][2] if i >= 0 and t <= spans[i][1] else "other"
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
    }, integrate_ms


def _replay(plan, log, expect, traced: bool):
    """One `FusedReplay.run` over the whole log at the flagship envelope,
    with the kernel's launch count reset just before it and read just
    after; checks the text of the first and last doc and the sticky error."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ytpu_torch.models.replay import FusedReplay
    from ytpu_torch.ops import integrate_kernel as ik

    rep = FusedReplay(N_DOCS, plan, capacity=CAPACITY, max_capacity=CAPACITY, chunk=CHUNK,
                      device="cuda")
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if traced else None
    if prof is not None:
        prof.start()
    ik.integrate_stream.launches = 0
    t0 = time.perf_counter()
    st = rep.run(log)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ik.integrate_stream.launches
    if prof is not None:
        prof.stop()
    err = int(rep.meta[:, ik.M_ERROR].max())
    text_ok = rep.get_string(0) == expect and rep.get_string(N_DOCS - 1) == expect
    readout = ik._readout_words(rep.cols, rep.meta, rep.driver._err).cpu().tolist()
    if err != 0:
        raise RuntimeError(f"b4_replay: sticky error {err}")
    if not text_ok:
        raise RuntimeError("b4_replay: replayed text differs from the log's expected text")
    if launches != st.chunks:
        raise RuntimeError(f"b4_replay: {launches} kernel launches for {st.chunks} chunks")
    return st, wall, launches, err, readout, prof


def phase_b4_replay(gpu, log, expect, plan, plan_s: float):
    """The main path: `FusedReplay.run` over the whole log (its wall clock
    gives updates/s), then the same run again under `torch.profiler` for
    the device time per phase, per integrate launch and the idle share."""
    import torch

    st, wall, launches, err, readout, _ = _replay(plan, log, expect, traced=False)
    torch.cuda.empty_cache()
    st_t, wall_t, launches_t, _, _, prof = _replay(plan, log, expect, traced=True)
    trace, integrate_ms = _trace_breakdown(prof, wall_t)
    if len(integrate_ms) != launches_t:
        raise RuntimeError(f"b4_replay: the trace holds {len(integrate_ms)} integrate kernels "
                           f"for {launches_t} launches")
    # bytes the launches must move at least: the occupied rows of every doc
    # read before and written after each launch, plus its rows, deletes,
    # meta (read and written) and rank table
    stream_b = 4 * CHUNK * (plan.max_rows * 23 + plan.max_dels * 4)
    launch_b = stream_b + 4 * (2 * N_DOCS * 32 + 256)
    bound_ms = (4 * 26 * st.launch_rows + launches * launch_b) / launches / HBM_BYTES_PER_S * 1e3
    line = {
        "phase": "b4_replay", "updates": len(log), "docs": N_DOCS, "capacity": CAPACITY,
        "chunk": CHUNK, "updates_per_s": len(log) / wall, "doc_updates_per_s": len(log) * N_DOCS / wall,
        "wall_s": wall, "plan_s": plan_s, "chunks": st.chunks, "compactions": st.compactions,
        "growths": st.growths, "peak_blocks": st.peak_blocks, "final_blocks": st.final_blocks,
        "sticky_error": err, "launches": launches, "launch_rows": st.launch_rows,
        "readout": readout, "text_ok": True,
        "traced": {"wall_s": wall_t, "updates_per_s": len(log) / wall_t, "launches": launches_t,
                   "integrate_ms_mean": sum(integrate_ms) / len(integrate_ms),
                   "integrate_ms_max": max(integrate_ms), **trace},
        "gpu": gpu,
    }
    emit(line)
    return launches, sum(integrate_ms) / len(integrate_ms), bound_ms


def main() -> int:
    import torch

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

    phase_build(gpu)
    t0 = time.perf_counter()
    plan = plan_replay(log)
    plan_s = time.perf_counter() - t0
    max_err = phase_kernel_vs_plain(gpu, log, plan)
    err_full, full_kernel_ms, full_plain_ms = phase_full_width_vs_plain(gpu, log, plan)
    launches, ms, bound_ms = phase_b4_replay(gpu, log, expect, plan, plan_s)
    print(f"gpu: {gpu}", flush=True)
    emit({"kernels": [{
        "name": "integrate_stream", "route": "cuda", "source": "ytpu_torch/csrc/integrate.cu",
        "replaces": INTEGRATE_REPLACES, "launches": launches, "max_abs_err": max(max_err, err_full),
        "ms": ms, "plain_ms": full_plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
        "library_ms": None,
        "plain_vs_kernel_case": {
            "shape": f"one B4 chunk, 2 docs, C={CAPACITY}, S={CHUNK}",
            "kernel_ms": full_kernel_ms, "plain_ms": full_plain_ms,
        },
        "gpu": gpu,
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
