"""Child process of tests/test_torch_integrate_emulated.py: builds
``ytpu_torch/csrc/integrate.cu`` for the host through tests/cuda_host (a
CUDA emulator), runs its stream entry on seeded streams next to
`integrate_stream_reference` and its per-doc entry on per-doc streams
next to `integrate_batch_reference` (and a mutant of the per-doc entry,
each doc reading its neighbour's rows), and prints one JSON object, case
-> max abs difference over all planes and meta words.

Usage: python tests/_emulated_integrate.py BUILD_DIR
"""

import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from ytpu_torch.benches.streams import anchored_state, synthetic_stream, typing_stream  # noqa: E402
from ytpu_torch.models.batch_doc import init_state  # noqa: E402
from ytpu_torch.ops import integrate_kernel as ik  # noqa: E402

torch.set_num_threads(1)


def host_source(src: str) -> str:
    """integrate.cu with its inline-PTX helpers, its dynamic shared memory
    and its launch replaced by the emulator's."""
    out, n1 = re.subn(r"// ---- mbarriers and the TMA bulk copy.*?(?=// the producer's copy of tile t)", "",
                      src, flags=re.S)
    out, n2 = re.subn(r"kern<<<(.*?),\s*THREADS,\s*smem,\s*\(cudaStream_t\)stream>>>\(",
                      r"EMU_LAUNCH(\1, THREADS, smem, kern, ", out, flags=re.S)
    out, n3 = re.subn(r"extern __shared__ __align__\(128\) unsigned char smem\[\];",
                      "unsigned char* smem = emu_dyn_smem();", out)
    out, n4 = re.subn(r'asm volatile\("fence\.mbarrier_init\.release\.cluster;\\n" ::: "memory"\);', "", out)
    if (n1, n2, n3, n4) != (1, 1, 1, 1):
        raise RuntimeError(f"integrate.cu no longer has the shape the emulator rewrites: {(n1, n2, n3, n4)}")
    return out


# the per-doc entry's row and delete offsets, and a mutant of them in
# which every doc reads its neighbour's block (a check that the batch
# cases can tell docs apart)
PER_DOC_ROWS = "integrate_step(d, rows + doc * U * ROW_W, dels + doc * R * DEL_W, U, R);"
NEIGHBOUR_ROWS = ("integrate_step(d, rows + (doc ^ 1) * U * ROW_W, dels + (doc ^ 1) * R * DEL_W, "
                  "U, R);")


def build(build_dir: Path, mutant: bool = False) -> Path:
    text = host_source((ROOT / "ytpu_torch" / "csrc" / "integrate.cu").read_text())
    if text.count(PER_DOC_ROWS) != 1:
        raise RuntimeError("integrate.cu no longer reads per-doc rows where the mutant expects")
    tag = "_neighbour" if mutant else ""
    src = build_dir / f"integrate_host{tag}.cpp"
    src.write_text(text.replace(PER_DOC_ROWS, NEIGHBOUR_ROWS) if mutant else text)
    lib = build_dir / f"libintegrate_host{tag}.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-Wno-unknown-pragmas",
                    "-I", str(ROOT / "tests" / "cuda_host"), "-o", str(lib), str(src)],
                   check=True, capture_output=True, text=True)
    return lib


def load(build_dir: Path, mutant: bool = False) -> ctypes.CDLL:
    """The host build of the kernel source with its C signatures declared."""
    lib = ctypes.CDLL(str(build(build_dir, mutant)))
    for fn, args in ik.INTEGRATE_SIGNATURES.items():
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = args
    return lib


def aligned(t: torch.Tensor) -> torch.Tensor:
    """A copy of `t` that starts 16-byte aligned, as the bulk copies need."""
    buf = torch.empty(t.numel() + 4, dtype=t.dtype)
    off = (-(buf.data_ptr() // 4)) % 4
    out = buf[off : off + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def launch(lib, cols, meta, rows, dels, rank, scan_plan):
    _, D, C = cols.shape
    S, U = rows.shape[:2]
    R, K = dels.shape[1], rank.shape[0]
    hb, hs = ik.scratch_entries(C)
    rows, dels = aligned(rows), aligned(dels)
    bidx = torch.empty((D, hb, 2), dtype=torch.int64)
    sidx = torch.empty((D, hs, 2), dtype=torch.int64)
    bstamp, cstamp = (torch.empty((D, C), dtype=torch.int32) for _ in range(2))
    err = lib.ytpu_integrate_stream(
        cols.data_ptr(), meta.data_ptr(), rows.data_ptr(), dels.data_ptr(), rank.data_ptr(),
        S, U, R, K, D, C, scan_plan[0], scan_plan[1],
        bidx.data_ptr(), hb, sidx.data_ptr(), hs, bstamp.data_ptr(), cstamp.data_ptr(), None, None,
    )
    if err:
        raise RuntimeError(f"emulated launch returned {err}")


def launch_batch(lib, cols, meta, rows, dels, rank, scan_plan):
    """One launch of the per-doc entry: rows [D, U, 23], dels [D, R, 4]."""
    _, D, C = cols.shape
    hb, hs = ik.scratch_entries(C)
    bidx = torch.empty((D, hb, 2), dtype=torch.int64)
    sidx = torch.empty((D, hs, 2), dtype=torch.int64)
    bstamp, cstamp = (torch.empty((D, C), dtype=torch.int32) for _ in range(2))
    err = lib.ytpu_integrate_batch(
        cols.data_ptr(), meta.data_ptr(), rows.data_ptr(), dels.data_ptr(), rank.data_ptr(),
        rows.shape[1], dels.shape[1], rank.shape[0], D, C, scan_plan[0], scan_plan[1],
        bidx.data_ptr(), hb, sidx.data_ptr(), hs, bstamp.data_ptr(), cstamp.data_ptr(), None,
    )
    if err:
        raise RuntimeError(f"emulated batch launch returned {err}")


def batch_cases():
    """Per-doc streams: doc d's step t is step t of its own stream, so
    every launch gives each doc other rows. Four docs fill two CTAs, three
    leave the second CTA's second warp idle."""
    rank = torch.from_numpy(np.random.default_rng(11).permutation(256).astype(np.int32))
    cols, meta = anchored_state(4, 256, "cpu")
    streams = [synthetic_stream(200 + d, 24) for d in range(4)]
    yield ("batch_synthetic_D4", cols, meta, np.stack([r for r, _ in streams], 1),
           np.stack([d for _, d in streams], 1), rank, (32, 8))
    cols, meta = ik.pack_state(init_state(3, 512, "cpu"))
    streams = [typing_stream(30 + d, 40) for d in range(3)]
    yield ("batch_typing_D3", cols, meta, np.stack([r for r, _ in streams], 1),
           np.stack([d for _, d in streams], 1), rank, (4, 1))


def run_batch_case(lib, cols, meta, rows, dels, rank, plan):
    """Every step through the per-doc entry and through
    `integrate_batch_reference`; the largest difference over all planes
    and meta words after any step."""
    rows, dels = torch.as_tensor(rows), torch.as_tensor(dels)
    ck, mk = cols.clone(), meta.clone()
    cp, mp = cols.clone(), meta.clone()
    err = 0
    for t in range(rows.shape[0]):
        launch_batch(lib, ck, mk, rows[t].contiguous(), dels[t].contiguous(), rank, plan)
        ik.integrate_batch_reference(cp, mp, rows[t], dels[t], rank, plan)
        err = max(err, int((ck.long() - cp.long()).abs().max()), int((mk.long() - mp.long()).abs().max()))
    return {"max_abs_err": err, "blocks": int(mk[:, ik.M_NBLOCKS].min()), "error": int(mk[:, ik.M_ERROR].max())}


def cases():
    rank = torch.from_numpy(np.random.default_rng(11).permutation(256).astype(np.int32))
    cols, meta = anchored_state(3, 256, "cpu")
    rows, dels = synthetic_stream(7, 48)
    for plan, cap in (((32, 8), 256), ((4, 1), 256), ((32, 8), 64)):
        yield (f"synthetic_plan{plan[0]}_{plan[1]}_C{cap}", cols[:, :, :cap].contiguous(), meta,
               rows, dels, rank, plan)
    # delete ranges that start below clock 0 take the sweep, which marks
    # blocks of other lanes' cache entries
    rows, dels = synthetic_stream(3, 40)
    dels[::3, 0, 1] = np.where(dels[::3, 0, 3] == 1, -2, dels[::3, 0, 1])
    yield ("synthetic_negative_start_deletes", cols[:, :, :256].contiguous(), meta, rows, dels, rank, (32, 8))
    cols, meta = ik.pack_state(init_state(3, 2048, "cpu"))
    # 601 steps: three tiles of 256 wrap the two-stage ring; the last tile's
    # rows end 12 bytes past a 16-byte boundary
    yield ("typing_8clients_D3_S601", cols, meta, *typing_stream(3, 601), rank, (32, 8))
    rank_k = torch.from_numpy(np.random.default_rng(5).permutation(2048).astype(np.int32))
    cols, meta = ik.pack_state(init_state(2, 1024, "cpu"))
    yield ("typing_clients_above_KC", cols, meta, *typing_stream(4, 150, first_client=1500), rank_k, (32, 8))


def main() -> int:
    lib = load(Path(sys.argv[1]))
    mutant = load(Path(sys.argv[1]), mutant=True)
    out = {}
    for case in batch_cases():
        out[case[0]] = run_batch_case(lib, *case[1:])
        if case[0] == "batch_synthetic_D4":
            out["batch_neighbour_rows_mutant"] = run_batch_case(mutant, *case[1:])
    for name, cols, meta, rows, dels, rank, plan in cases():
        rows, dels = torch.as_tensor(rows), torch.as_tensor(dels)
        ck, mk = cols.clone(), meta.clone()
        cp, mp = cols.clone(), meta.clone()
        launch(lib, ck, mk, rows, dels, rank, plan)
        ik.integrate_stream_reference(cp, mp, rows, dels, rank, plan)
        out[name] = {
            "max_abs_err": max(int((ck.long() - cp.long()).abs().max()), int((mk.long() - mp.long()).abs().max())),
            "blocks": int(mk[:, ik.M_NBLOCKS].max()),
            "error": int(mk[:, ik.M_ERROR].max()),
        }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.exit(main())
