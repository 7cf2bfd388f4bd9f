"""Where the V2 decode kernel's cycles go: one B4 chunk of the V2 log at
the JAX package's full-log settings, through the profiling build of
``csrc/decode_v2.cu`` (``-DYTPU_DECODE_V2_PROFILE``), reported as mean SM
cycles per lane and per phase of a lane's decode.

Usage (on a machine with an NVIDIA GPU and the CUDA toolkit):

    python3 -m ytpu_torch.benches.decode_v2_profile

Prints one JSON object: the cycle table, the profiled launch's time and
the time of the normal build on the same inputs. `chip_smoke.py`'s
``decode_v2`` phase calls `profile_table` on its B4 chunk.
"""

from __future__ import annotations

import ctypes
import gzip
import json
import os
import pickle

__all__ = ["PHASES", "profile_table", "main"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
B4_LOG = os.path.join(_ROOT, "benches", "data", "b4_log.pkl.gz")
#: the phases of a lane's decode, in the kernel's order (`PhaseClock.mark`)
PHASES = ("spans", "expansions", "strings", "pass_a", "rest_stream", "sections", "pass_b", "delete_set")
# the B4 chunk, its size and the caps of `chip_smoke.py`'s decode_v2 phase
CHUNK, LATE_CHUNK, PAD, U, R, SEC = 8192, 30, 64, 4, 4, 4


def _profile_lib():
    from ytpu_torch.ops import _build
    from ytpu_torch.ops.decode_v2 import DECODE_V2_SIGNATURES

    sigs = dict(DECODE_V2_SIGNATURES, ytpu_decode_v2_phase_cycles=[ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int])
    return _build.bind("decode_v2_profile", sigs, "ytpu_cuda_error_string")


def profile_table(buf, lens, spans, U: int, R: int, SEC: int, sidecar=None, **tables) -> dict:
    """One launch of the profiling build on the ``[S, L]`` matrix (CUDA
    tensors): mean SM cycles a lane in each phase and in all, and the
    device ms a launch of the profiling and the normal build (CUDA graphs,
    `graph_ms`)."""
    import torch

    from ytpu_torch.benches._kernels import graph_ms
    from ytpu_torch.ops import _build
    from ytpu_torch.ops import decode_v2 as dv2

    lib = _profile_lib()
    sums = (ctypes.c_ulonglong * len(PHASES))()

    def launch(which):
        stream = torch.cuda.current_stream(buf.device).cuda_stream
        return dv2._launch_decode_v2(which, buf, lens, spans, U, R, SEC, sidecar, stream=stream, **tables)

    torch.cuda.synchronize()
    _build.check(lib, lib.ytpu_decode_v2_phase_cycles(sums, 1), "decode_v2 phase cycle read")
    launch(lib)
    torch.cuda.synchronize()
    _build.check(lib, lib.ytpu_decode_v2_phase_cycles(sums, 1), "decode_v2 phase cycle read")
    S = int(lens.shape[0])
    cycles = {name: sums[k] / S for k, name in enumerate(PHASES)}
    total = sum(cycles.values())
    return {"lanes": S, "cycles_per_lane": cycles, "cycles_per_lane_total": total,
            "share": {k: v / total if total else 0.0 for k, v in cycles.items()},
            "profiled_ms": graph_ms(lambda: launch(lib), reps=50)["mean"],
            "kernel_ms": graph_ms(lambda: launch(dv2._decode_v2_lib()), reps=50)["mean"]}


def main() -> None:
    import torch

    from ytpu_torch.core.update import Update
    from ytpu_torch.ops.decode_v2 import pack_updates_v2

    with gzip.open(B4_LOG, "rb") as f:
        log = pickle.load(f)["log"]
    chunk = [Update.decode_v1(p).encode_v2() for p in log[LATE_CHUNK * CHUNK:(LATE_CHUNK + 1) * CHUNK]]
    buf, lens, spans = (torch.from_numpy(x).cuda() for x in pack_updates_v2(chunk, pad_to=PAD)[:3])
    out = profile_table(buf, lens, spans, U, R, SEC)
    out.update(case=f"V2 B4 updates {LATE_CHUNK * CHUNK}..{(LATE_CHUNK + 1) * CHUNK}, U={U}, R={R}, {SEC} sections",
               gpu=torch.cuda.get_device_name(0))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
