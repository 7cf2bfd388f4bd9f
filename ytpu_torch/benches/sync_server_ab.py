"""Runs the device-authoritative sync-server phase of the checkout at ROOT
on the card, so that two trees (a change and its parent) can be compared
in one run, and times Python's garbage collector over the phase.

Usage (on a machine with an NVIDIA GPU and the CUDA toolkit), as a script
so that ROOT's package and ROOT's ``chip_smoke.py`` are the ones imported:

    python3 ytpu_torch/benches/sync_server_ab.py ROOT

It builds ROOT's kernels (``chip_smoke.phase_build``), then runs
``chip_smoke.phase_sync_server`` alone (1,024 tenants x 8,192 slots, its
every check), which prints its own phase line. Its last line is one JSON
object: the flush step's ms (mean, median, min, max; the traced steps'
mean), the host ms a traced step spends in each ingest-planning span, the
phase's seconds, and the collector's runs and pause ms for each
generation over the phase and inside ``DeviceSyncServer.flush_device``
calls (from ``gc.callbacks``), with the most objects the collector
tracked at the start of a full collection.
"""

import gc
import gzip
import json
import os
import pickle
import sys
import time


def main(root: str) -> None:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import chip_smoke

    gpu = chip_smoke.gpu_line()
    with gzip.open(chip_smoke.B4_LOG, "rb") as f:
        log = pickle.load(f)["log"]
    chip_smoke.phase_build(gpu)
    from ytpu_torch.sync.device_server import DeviceSyncServer

    pauses = {g: [] for g in range(3)}
    in_flush = {g: [] for g in range(3)}
    started = {}
    tracked = {"max_full": 0, "flushing": False, "flushes": 0, "flush_ms": 0.0}
    real_flush = DeviceSyncServer.flush_device

    def flush_device(self, *a, **k):
        tracked["flushing"] = True
        t = time.perf_counter()
        try:
            return real_flush(self, *a, **k)
        finally:
            tracked["flushing"] = False
            tracked["flushes"] += 1
            tracked["flush_ms"] += (time.perf_counter() - t) * 1e3

    DeviceSyncServer.flush_device = flush_device

    def on_gc(phase, info):
        if phase == "start":
            if info["generation"] == 2:
                tracked["max_full"] = max(tracked["max_full"], len(gc.get_objects()))
            started["t"] = time.perf_counter()
        elif "t" in started:
            ms = (time.perf_counter() - started.pop("t")) * 1e3
            pauses[info["generation"]].append(ms)
            if tracked["flushing"]:
                in_flush[info["generation"]].append(ms)

    gc.callbacks.append(on_gc)
    t0 = time.perf_counter()
    line = chip_smoke.phase_sync_server(gpu, log)[0]
    phase_s = time.perf_counter() - t0
    gc.callbacks.remove(on_gc)
    host = line["write_host_ms_per_step"]
    print(json.dumps({
        "root": root, "gpu": gpu, "phase_s": phase_s,
        "ms_per_flush_step": line["ms_per_flush_step"],
        "ms_per_flush_step_median": line["ms_per_flush_step_median"],
        "ms_per_flush_step_min": line["ms_per_flush_step_min"],
        "ms_per_flush_step_max": line["ms_per_flush_step_max"],
        "ms_per_flush_step_traced": line["ms_per_flush_step_traced"],
        "traced_host_ms": {k: host.get(k) for k in ("sync.dispatch", "ingest.plan", "ingest.plan.walk",
                                                     "ingest.plan.intern", "ingest.plan.host_lane")},
        "gc_runs": {g: len(p) for g, p in pauses.items()},
        "gc_pause_ms": {g: sum(p) for g, p in pauses.items()},
        "gc_max_pause_ms": {g: max(p, default=0.0) for g, p in pauses.items()},
        "gc_runs_in_flush": {g: len(p) for g, p in in_flush.items()},
        "gc_pause_ms_in_flush": {g: sum(p) for g, p in in_flush.items()},
        "flushes": tracked["flushes"], "flush_ms": tracked["flush_ms"],
        "gc_objects_at_full_max": tracked["max_full"],
    }), flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
