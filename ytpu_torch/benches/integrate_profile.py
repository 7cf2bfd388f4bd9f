"""Where the integrate kernel's cycles go: one late B4 chunk at the main
path's capacity and chunk size, through the profiling build of
``csrc/integrate.cu`` (``-DYTPU_INTEGRATE_PROFILE``), reported as mean
SM cycles per stream step and per phase.

Usage (on a machine with an NVIDIA GPU and the CUDA toolkit):

    python3 -m ytpu_torch.benches.integrate_profile

Prints one JSON object: the cycle table, the event counts, the profiled
launch's time and the time of the normal build on the same inputs.
`chip_smoke.py`'s ``integrate_profile`` phase calls `profile_table` on the
state of its full-width comparison, and its ``sync_step`` phase calls
`batch_profile_table` (the per-doc entry, phase 1 against phase 2, its
scratch sized for each doc's live rows and, as the baseline, for C) on
the write path's state.
"""

from __future__ import annotations

import gzip
import json
import os
import pickle

__all__ = ["b4_chunks", "batch_profile_table", "late_chunk", "profile_table", "main"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
B4_LOG = os.path.join(_ROOT, "benches", "data", "b4_log.pkl.gz")


def b4_chunks(plan, log, starts, chunk: int, device):
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


def late_chunk(plan, log, index: int, chunk: int, capacity: int):
    """The state every doc of the main path holds before chunk `index`
    (docs are independent and share the stream): two docs replayed on the
    card through `FusedReplay.run` up to it and compacted, plus that chunk.
    Returns ``(cols, meta, rank, rows, dels)``."""
    from ytpu_torch.models.replay import FusedReplay

    pos = index * chunk
    rep = FusedReplay(2, plan, capacity=capacity, max_capacity=capacity, chunk=chunk, device="cuda")
    rep.run(log[:pos])
    rep.driver.compact()  # slots renumbered, as after a compaction in the run
    ((rows, dels),) = b4_chunks(plan, log, (pos,), chunk, rep.driver.cols.device)
    return rep.driver.cols, rep.driver.meta, rep.driver.rank, rows, dels


def _time_ms(fn) -> float:
    import torch

    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def profile_table(cols, meta, rows, dels, rank):
    """Run the profiling build once on copies of the state and the normal
    build once on other copies; returns the mean cycles per step of each
    phase (summed over docs, divided by the steps all docs ran), the
    event counts and both launches' ms. The two results must be equal."""
    import torch

    from ytpu_torch.ops import integrate_kernel as ik

    cols_p, meta_p = cols.clone(), meta.clone()
    holder = {}
    prof_ms = _time_ms(lambda: holder.setdefault(
        "prof", ik.integrate_stream_profile(cols_p, meta_p, rows, dels, rank)))
    prof = holder["prof"].sum(dim=0).cpu().tolist()
    cols_k, meta_k = cols.clone(), meta.clone()
    launches = ik.integrate_stream.launches
    kernel_ms = _time_ms(lambda: ik.integrate_stream(cols_k, meta_k, rows, dels, rank))
    ik.integrate_stream.launches = launches  # a measurement, not the main path
    if not (torch.equal(cols_p, cols_k) and torch.equal(meta_p, meta_k)):
        raise RuntimeError("integrate_profile: the profiling build and the normal build differ")
    words = dict(zip(ik.PROFILE_WORDS, prof))
    steps = max(words["steps"], 1)
    cycles = {ph: words[ph] / steps for ph in ik.PROFILE_PHASES}
    total = sum(cycles.values())
    n_docs = cols.shape[1]
    return {
        "docs": n_docs, "capacity": cols.shape[2], "steps_per_doc": words["steps"] / n_docs,
        "cycles_per_step": cycles, "cycles_per_step_total": total,
        "share": {ph: c / total for ph, c in cycles.items()} if total else {},
        "counts_per_doc": {w: words[w] / n_docs for w in ik.PROFILE_WORDS[len(ik.PROFILE_PHASES):]},
        "profiled_ms": prof_ms, "kernel_ms": kernel_ms,
        "kernel_us_per_step": kernel_ms * 1e3 / max(words["steps"] / n_docs, 1),
    }


def batch_profile_table(cols, meta, rows, dels, rank):
    """The per-doc entry's profiling build on copies of the state, once
    with each doc's scratch sized from its live rows (``live_rows``, the
    kernel's sizing) and once sized for all C slots (``capacity_sized``,
    the sizing before it), beside the normal build on another copy; all
    three results must be equal. Per sizing: mean cycles per doc of each
    phase, phase 1 (its sizing and clear, then its index build) against
    phase 2 (the doc's own integrate), the bytes phase 1 clears in the
    launch, and the profiled call's ms. The ms are CUDA events around one
    wrapper call each, the allocation of its scratch included: the trace
    of `chip_smoke.py`'s write path times the kernels alone."""
    import torch

    from ytpu_torch.ops import integrate_kernel as ik

    D, C = cols.shape[1], cols.shape[2]
    cols_k, meta_k = cols.clone(), meta.clone()
    launches = ik.integrate_batch.launches
    call_ms = _time_ms(lambda: ik.integrate_batch(cols_k, meta_k, rows, dels, rank))
    ik.integrate_batch.launches = launches  # a measurement, not the main path
    full = ik.batch_launch_plan(D, C)["scratch_bytes_per_doc"]
    out = {"docs": D, "capacity": C, "call_ms": call_ms}
    for name, capacity_sized in (("capacity_sized", True), ("live_rows", False)):
        cols_p, meta_p = cols.clone(), meta.clone()
        holder = {}
        prof_ms = _time_ms(lambda: holder.setdefault("prof", ik.integrate_batch_profile(
            cols_p, meta_p, rows, dels, rank, capacity_sized=capacity_sized)))
        if not (torch.equal(cols_p, cols_k) and torch.equal(meta_p, meta_k)):
            raise RuntimeError(f"batch profile ({name}): the profiling build and the normal build differ")
        prof = holder["prof"].cpu()
        words = dict(zip(ik.PROFILE_WORDS, prof.sum(dim=0).tolist()))
        cycles = {ph: words[ph] / D for ph in ik.PROFILE_PHASES}
        phase1 = sum(cycles[ph] for ph in ik.PHASE1)
        total = sum(cycles.values())
        bounds = prof[:, ik.PROFILE_WORDS.index("slots_bound")].tolist()
        # a doc bounded at b slots clears what a doc holding b slots clears
        # before an empty launch
        per_bound = {b: ik.scratch_cleared(b, C, S=0, U=0, R=0)["cleared_bytes"] for b in set(bounds)}
        cleared = sum(per_bound[b] for b in bounds)
        if capacity_sized and cleared != D * full:
            raise RuntimeError("batch profile: the capacity-sized launch did not clear all its scratch")
        out[name] = {
            "cycles_per_doc": cycles, "phase1_cycles": phase1, "phase2_cycles": total - phase1,
            "phase1_share": phase1 / total if total else 0.0, "slots_bound_mean": sum(bounds) / D,
            "cleared_bytes": cleared, "profiled_call_ms": prof_ms,
        }
    return out


def main() -> int:
    import torch

    from ytpu_torch.models.replay import plan_replay
    from ytpu_torch.ops import _build

    if not torch.cuda.is_available():
        raise SystemExit("integrate_profile: no CUDA device")
    with gzip.open(B4_LOG, "rb") as f:
        log = pickle.load(f)["log"]
    _build.build_all()
    plan = plan_replay(log)
    cols, meta, rank, rows, dels = late_chunk(plan, log, 30, 8192, 1 << 16)
    table = profile_table(cols, meta, rows, dels, rank)
    table["device"] = torch.cuda.get_device_name(0)
    table["ptxas"] = [ln for ln in _build.build_log("integrate").splitlines()
                      if "integrate_kernel" in ln or "bytes stack frame" in ln or "registers" in ln]
    print(json.dumps(table), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
