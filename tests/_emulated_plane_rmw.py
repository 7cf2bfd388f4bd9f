"""Child process of tests/test_torch_plane_rmw_emulated.py: builds the
column-put section of ``ytpu_torch/csrc/plane_rmw.cu`` (the g3d and g2d
kernel) for the host through tests/cuda_host (a CUDA emulator), runs it on
each case beside `g3d_plain` / `g2d_flat_plain` and prints one JSON
object, case -> max abs difference, whether the input was left as it was,
and whether the 16-byte path ran. The cases marked wide launch the copy
with 64-bit indices (the instantiation the card takes from 2^31 ints on)
through a host-only entry point, on a small input.

Usage: python tests/_emulated_plane_rmw.py BUILD_DIR
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

from ytpu_torch.benches.plane_rmw_repro2 import NC, g2d_flat_plain, g3d_plain  # noqa: E402

torch.set_num_threads(1)
SENTINEL = -123456789
D, C = 8, 512


# host-only: the out-of-place copy with 64-bit indices at any n
WIDE_ENTRY = """
extern "C" int emu_column_put_wide(const void* x, void* o, long long n, int C, int idx, int fill) {
  if (vec4(x, o, C)) launch_column_put<4, long long>((const int*)x, (int*)o, n, C, idx, fill, nullptr);
  else launch_column_put<1, long long>((const int*)x, (int*)o, n, C, idx, fill, nullptr);
  return 0;
}
"""


def host_source(src: str) -> str:
    """The column-put section of plane_rmw.cu with its launches replaced by
    the emulator's, and `WIDE_ENTRY` after it."""
    m = re.search(r"// ---- column put \(g3d, g2d\).*?// ---- end column put", src, flags=re.S)
    if m is None:
        raise RuntimeError("plane_rmw.cu has no column-put section")
    body, n = re.subn(r"(\w+(?:<[^<>]*>)?)<<<(.*?),\s*COL_THREADS,\s*0,\s*st>>>\(",
                      r"EMU_LAUNCH(\2, COL_THREADS, 0, (\1), ", m.group(0), flags=re.S)
    if n != 2:
        raise RuntimeError(f"the column-put section no longer has the launches the emulator rewrites: {n}")
    head, ns_end = body.rsplit("}  // namespace", 1)
    return ("#include <climits>\n#include <cstdint>\n#include <cuda_runtime.h>\n\n" + head
            + WIDE_ENTRY + "}  // namespace\n" + ns_end)


def load(build_dir: Path) -> ctypes.CDLL:
    src = build_dir / "column_put_host.cpp"
    src.write_text(host_source((ROOT / "ytpu_torch" / "csrc" / "plane_rmw.cu").read_text()))
    lib_path = build_dir / "libcolumn_put_host.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-Wno-unknown-pragmas",
                    "-I", str(ROOT / "tests" / "cuda_host"), "-o", str(lib_path), str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ytpu_column_put.restype = lib.emu_column_put_wide.restype = i
    lib.ytpu_column_put.argtypes = [p, p, q, i, i, i, p]
    lib.emu_column_put_wide.argtypes = [p, p, q, i, i, i]
    return lib


def seeded(shape, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-(2**31), 2**31, size=shape, dtype=np.int64).astype(np.int32))


def pattern(shape) -> torch.Tensor:
    n = int(np.prod(shape))
    return torch.from_numpy((np.arange(n, dtype=np.int32) % 997 - 400).reshape(shape))


def offset_by_one(t: torch.Tensor) -> torch.Tensor:
    """A copy of `t` that starts 4 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 8, dtype=t.dtype)
    off = (-(buf.data_ptr() // 4)) % 4 + 1
    out = buf[off : off + t.numel()].view(t.shape)
    out.copy_(t)
    return out


# name -> (layout, input maker, out of place, idx, fill, misaligned operand);
# the one-int cases hold 2 docs (an emulated CTA is 256 host threads)
CASES = {
    "g3d_in_place_idx_minus1": ("g3d", lambda: pattern((NC, D, C)), False, -1, 0, None),
    "g3d_in_place_live": ("g3d", lambda: seeded((NC, D, C), 1), False, 137, 12345, None),
    "g3d_in_place_idx_C": ("g3d", lambda: seeded((NC, D, C), 2), False, C, 12345, None),
    "g3d_out_of_place_idx_minus1": ("g3d", lambda: pattern((NC, D, C)), True, -1, 0, None),
    "g3d_out_of_place_live": ("g3d", lambda: seeded((NC, D, C), 3), True, 3, 12345, None),
    "g3d_out_of_place_idx_C": ("g3d", lambda: seeded((NC, D, C), 4), True, C, 12345, None),
    "g3d_C510_out_of_place_live": ("g3d", lambda: seeded((NC, 2, 510), 5), True, 509, 12345, None),
    "g3d_C510_in_place_live": ("g3d", lambda: seeded((NC, 2, 510), 6), False, 2, 12345, None),
    "g3d_misaligned_x": ("g3d", lambda: seeded((NC, 2, C), 7), True, 511, 12345, "x"),
    "g3d_misaligned_out": ("g3d", lambda: seeded((NC, 2, C), 8), True, 0, 12345, "out"),
    # 1,014 groups of 4, not a multiple of a CTA's: the last CTA partly empty
    "g3d_ragged_last_cta": ("g3d", lambda: seeded((NC, 3, 52), 9), True, 50, 12345, None),
    # 53,248 groups of 4: many CTAs
    "g3d_many_ctas": ("g3d", lambda: seeded((NC, 16, C), 10), True, 260, 12345, None),
    "g2d_in_place_idx_minus1": ("g2d", lambda: pattern((D, NC * C)), False, -1, 0, None),
    "g2d_in_place_live": ("g2d", lambda: seeded((D, NC * C), 11), False, 255, 12345, None),
    "g2d_in_place_idx_C": ("g2d", lambda: seeded((D, NC * C), 12), False, C, 12345, None),
    "g2d_out_of_place_live": ("g2d", lambda: seeded((D, NC * C), 13), True, 4, 12345, None),
    "g2d_C510_out_of_place_live": ("g2d", lambda: seeded((2, NC * 510), 14), True, 7, 12345, None),
    "g3d_wide_out_of_place_live": ("g3d", lambda: seeded((NC, 3, 52), 15), True, 49, 12345, None),
    "g3d_wide_misaligned_x": ("g3d", lambda: seeded((NC, 2, 510), 16), True, 1, 12345, "x"),
    "g2d_wide_out_of_place_live": ("g2d", lambda: seeded((D, NC * C), 17), True, 511, 12345, None),
}


def run(lib, name):
    layout, make, out_of_place, idx, fill, misaligned = CASES[name]
    x = make()
    x_k = offset_by_one(x) if misaligned == "x" else x.clone()
    o = None
    if out_of_place:
        o = torch.full_like(x, SENTINEL)
        if misaligned == "out":
            o = offset_by_one(o)
    target = x_k if o is None else o
    width, plain = (x.shape[2], g3d_plain) if layout == "g3d" else (x.shape[1] // NC, g2d_flat_plain)
    call = (x_k.data_ptr(), target.data_ptr(), x.numel(), width, idx, fill)
    err = lib.emu_column_put_wide(*call) if "wide" in name else lib.ytpu_column_put(*call, None)
    if err:
        raise RuntimeError(f"{name}: emulated launch returned {err}")
    want = plain(x.clone(), torch.empty_like(x) if out_of_place else None, idx, fill)
    return {
        "max_abs_err": int((target.long() - want.long()).abs().max()),
        "input_kept": bool(torch.equal(x_k, x)) if out_of_place else None,
        "vec4": out_of_place and width % 4 == 0 and x_k.data_ptr() % 16 == 0 and target.data_ptr() % 16 == 0,
    }


def main() -> int:
    lib = load(Path(sys.argv[1]))
    print(json.dumps({name: run(lib, name) for name in CASES}), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.exit(main())
