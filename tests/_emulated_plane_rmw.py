"""Child process of tests/test_torch_plane_rmw_emulated.py: builds the
column-put section of ``ytpu_torch/csrc/plane_rmw.cu`` (the kernel of
cases a / a2, g3d / g2d and v_vmem) for the host through tests/cuda_host
(a CUDA emulator), runs each case beside its plain version
(`masked_put_plain`, `g3d_plain`, `g2d_flat_plain`, `v_vmem_plain`) and
prints one JSON object: case -> max abs difference, whether the input was
left as it was, and whether the 16-byte path ran.

The cases marked wide launch the column put with 64-bit indices (the
instantiation the card takes from 2^31 ints on) through a host-only entry
point, on a small input; the others go through the library's own C entry
points.

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

from ytpu_torch.benches.plane_rmw_repro import masked_put_plain  # noqa: E402
from ytpu_torch.benches.plane_rmw_repro2 import NC, g2d_flat_plain, g3d_plain  # noqa: E402
from ytpu_torch.benches.plane_rmw_repro3 import v_vmem_plain  # noqa: E402

torch.set_num_threads(1)
SENTINEL = -123456789
D, C = 8, 512


# host-only: the out-of-place column put with 64-bit indices at any n
HOST_ENTRIES = """
extern "C" int emu_column_put_wide(const void* x, void* o, long long n, int C, int idx, int fill,
                                   long long lo, long long hi) {
  if (idx < 0 || idx >= C) lo = hi = 0;
  if (vec4(x, o, C)) launch_column_put<4, long long>((const int*)x, (int*)o, n, C, idx, fill, lo, hi - lo, nullptr);
  else launch_column_put<1, long long>((const int*)x, (int*)o, n, C, idx, fill, lo, hi - lo, nullptr);
  return 0;
}
"""


def _section(src: str, start: str, end: str) -> str:
    m = re.search(re.escape(start) + r".*?" + re.escape(end), src, flags=re.S)
    if m is None:
        raise RuntimeError(f"plane_rmw.cu has no section {start!r}")
    return m.group(0)


def host_source(src: str) -> str:
    """The includes and the column-put section of plane_rmw.cu with its
    launches replaced by the emulator's, and `HOST_ENTRIES` inside the
    section's namespace."""
    includes = "".join(line + "\n" for line in src.splitlines() if line.startswith("#include"))
    body, n = re.subn(r"(\w+(?:<[^<>]*>)?)<<<(.*?),\s*COL_THREADS,\s*0,\s*st>>>\(",
                      r"EMU_LAUNCH(\2, COL_THREADS, 0, (\1), ",
                      _section(src, "// ---- column put", "// ---- end column put"), flags=re.S)
    if n != 2:
        raise RuntimeError(f"the column-put section no longer has the launches the emulator rewrites: {n}")
    head, ns_end = body.rsplit("}  // namespace", 1)
    return includes + "\n" + head + HOST_ENTRIES + "}  // namespace\n" + ns_end


def load(build_dir: Path) -> ctypes.CDLL:
    src = build_dir / "plane_rmw_host.cpp"
    src.write_text(host_source((ROOT / "ytpu_torch" / "csrc" / "plane_rmw.cu").read_text()))
    lib_path = build_dir / "libplane_rmw_host.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-Wno-unknown-pragmas",
                    "-I", str(ROOT / "tests" / "cuda_host"), "-o", str(lib_path), str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn, args in (("ytpu_column_put", [p, p, q, i, i, i, p]),
                     ("ytpu_plane_masked_put", [p, p, i, i, i, i, i, i, p]),
                     ("emu_column_put_wide", [p, p, q, i, i, i, q, q])):
        getattr(lib, fn).restype = i
        getattr(lib, fn).argtypes = args
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


# name -> (layout, input maker, out of place, idx, fill, misaligned operand,
# plane); layout "plane" is case a / a2 (plane `plane` of [NC, D, C]),
# "vmem" is v_vmem's call (idx -1 over the whole state, a flat copy), the
# others patch every plane. The one-int cases hold 2 docs (an emulated CTA
# is 256 host threads)
CASES = {
    "g3d_in_place_idx_minus1": ("g3d", lambda: pattern((NC, D, C)), False, -1, 0, None, None),
    "g3d_in_place_live": ("g3d", lambda: seeded((NC, D, C), 1), False, 137, 12345, None, None),
    "g3d_in_place_idx_C": ("g3d", lambda: seeded((NC, D, C), 2), False, C, 12345, None, None),
    "g3d_out_of_place_idx_minus1": ("g3d", lambda: pattern((NC, D, C)), True, -1, 0, None, None),
    "g3d_out_of_place_live": ("g3d", lambda: seeded((NC, D, C), 3), True, 3, 12345, None, None),
    "g3d_out_of_place_idx_C": ("g3d", lambda: seeded((NC, D, C), 4), True, C, 12345, None, None),
    "g3d_C510_out_of_place_live": ("g3d", lambda: seeded((NC, 2, 510), 5), True, 509, 12345, None, None),
    "g3d_C510_in_place_live": ("g3d", lambda: seeded((NC, 2, 510), 6), False, 2, 12345, None, None),
    "g3d_misaligned_x": ("g3d", lambda: seeded((NC, 2, C), 7), True, 511, 12345, "x", None),
    "g3d_misaligned_out": ("g3d", lambda: seeded((NC, 2, C), 8), True, 0, 12345, "out", None),
    # 1,014 groups of 4, not a multiple of a CTA's: the last CTA partly empty
    "g3d_ragged_last_cta": ("g3d", lambda: seeded((NC, 3, 52), 9), True, 50, 12345, None, None),
    # 53,248 groups of 4: many CTAs
    "g3d_many_ctas": ("g3d", lambda: seeded((NC, 16, C), 10), True, 260, 12345, None, None),
    "g2d_in_place_idx_minus1": ("g2d", lambda: pattern((D, NC * C)), False, -1, 0, None, None),
    "g2d_in_place_live": ("g2d", lambda: seeded((D, NC * C), 11), False, 255, 12345, None, None),
    "g2d_in_place_idx_C": ("g2d", lambda: seeded((D, NC * C), 12), False, C, 12345, None, None),
    "g2d_out_of_place_live": ("g2d", lambda: seeded((D, NC * C), 13), True, 4, 12345, None, None),
    "g2d_C510_out_of_place_live": ("g2d", lambda: seeded((2, NC * 510), 14), True, 7, 12345, None, None),
    "g3d_wide_out_of_place_live": ("g3d", lambda: seeded((NC, 3, 52), 15), True, 49, 12345, None, None),
    "g3d_wide_misaligned_x": ("g3d", lambda: seeded((NC, 2, 510), 16), True, 1, 12345, "x", None),
    "g2d_wide_out_of_place_live": ("g2d", lambda: seeded((D, NC * C), 17), True, 511, 12345, None, None),
    # cases a / a2: one plane's column, at the first, the repros' and the
    # last plane, idx -1, 0, C - 1 and C
    "a_out_of_place_idx_minus1": ("plane", lambda: pattern((NC, D, C)), True, -1, 0, None, 7),
    "a_in_place_idx_minus1": ("plane", lambda: pattern((NC, D, C)), False, -1, 0, None, 7),
    "a2_out_of_place_slot0": ("plane", lambda: pattern((NC, D, C)), True, 0, 555, None, 7),
    "a2_in_place_slot0": ("plane", lambda: pattern((NC, D, C)), False, 0, 555, None, 7),
    "plane0_out_of_place_last_slot": ("plane", lambda: seeded((NC, 2, C), 18), True, C - 1, 12345, None, 0),
    "plane0_in_place_last_slot": ("plane", lambda: seeded((NC, 2, C), 19), False, C - 1, 12345, None, 0),
    "plane_last_out_of_place_live": ("plane", lambda: seeded((NC, 2, C), 20), True, 300, 12345, None, NC - 1),
    "plane_last_in_place_live": ("plane", lambda: seeded((NC, 2, C), 21), False, 301, 12345, None, NC - 1),
    "plane_out_of_place_idx_C": ("plane", lambda: seeded((NC, 2, C), 22), True, C, 12345, None, 7),
    "plane_in_place_idx_C": ("plane", lambda: seeded((NC, 2, C), 23), False, C, 12345, None, 7),
    "plane_C510_out_of_place_live": ("plane", lambda: seeded((NC, 2, 510), 24), True, 509, 12345, None, 7),
    "plane_C510_in_place_live": ("plane", lambda: seeded((NC, 2, 510), 25), False, 0, 12345, None, 3),
    "plane_misaligned_x": ("plane", lambda: seeded((NC, 2, C), 26), True, 5, 12345, "x", 7),
    "plane_misaligned_out": ("plane", lambda: seeded((NC, 2, C), 27), True, 6, 12345, "out", 12),
    # 1,014 groups of 4 over 2 CTAs, the last partly empty; the plane at
    # the end of the state
    "plane_ragged_last_cta": ("plane", lambda: seeded((NC, 3, 52), 28), True, 51, 12345, None, NC - 1),
    "plane_wide_out_of_place_live": ("plane", lambda: seeded((NC, 3, 52), 29), True, 48, 12345, None, 9),
    "plane_wide_misaligned_x": ("plane", lambda: seeded((NC, 2, 510), 30), True, 2, 12345, "x", 25),
    # v_vmem: the flat copy out of place and in place, on the one-int path
    # (C = 510, views one int off), and over a partly empty last CTA
    "vmem_out_of_place": ("vmem", lambda: seeded((NC, D, C), 31), True, -1, 0, None, None),
    "vmem_in_place": ("vmem", lambda: seeded((NC, D, C), 32), False, -1, 0, None, None),
    "vmem_C510_out_of_place": ("vmem", lambda: seeded((NC, 2, 510), 33), True, -1, 0, None, None),
    "vmem_misaligned_x": ("vmem", lambda: seeded((NC, 2, C), 34), True, -1, 0, "x", None),
    "vmem_misaligned_out": ("vmem", lambda: seeded((NC, 2, C), 35), True, -1, 0, "out", None),
    "vmem_ragged_last_cta": ("vmem", lambda: seeded((NC, 3, 52), 36), True, -1, 0, None, None),
}


def run(lib, name):
    layout, make, out_of_place, idx, fill, misaligned, plane = CASES[name]
    x = make()
    x_k = offset_by_one(x) if misaligned == "x" else x.clone()
    o = None
    if out_of_place:
        o = torch.full_like(x, SENTINEL)
        if misaligned == "out":
            o = offset_by_one(o)
    target = x_k if o is None else o
    width = x.shape[1] // NC if layout == "g2d" else x.shape[-1]
    if layout == "vmem":
        want = v_vmem_plain(x.clone(), torch.empty_like(x) if out_of_place else None)
    elif plane is None:
        lo, hi = 0, x.numel()
        plain = g3d_plain if layout == "g3d" else g2d_flat_plain
        want = plain(x.clone(), torch.empty_like(x) if out_of_place else None, idx, fill)
    else:
        lo = plane * x.shape[1] * width
        hi = lo + x.shape[1] * width
        want = masked_put_plain(x.clone(), plane, idx, fill, torch.empty_like(x) if out_of_place else None)
    if "wide" in name:
        err = lib.emu_column_put_wide(x_k.data_ptr(), target.data_ptr(), x.numel(), width, idx, fill, lo, hi)
    elif plane is None:
        err = lib.ytpu_column_put(x_k.data_ptr(), target.data_ptr(), x.numel(), width, idx, fill, None)
    else:
        err = lib.ytpu_plane_masked_put(x_k.data_ptr(), target.data_ptr(), *x.shape, plane, idx, fill, None)
    if err:
        raise RuntimeError(f"{name}: emulated launch returned {err}")
    return {
        "max_abs_err": int((target.long() - want.long()).abs().max()),
        "input_kept": bool(torch.equal(x_k, x)) if out_of_place else None,
        "vec4": out_of_place and width % 4 == 0 and x_k.data_ptr() % 16 == 0 and target.data_ptr() % 16 == 0,
    }


def main() -> int:
    lib = load(Path(sys.argv[1]))
    out = {"column_put": {name: run(lib, name) for name in CASES}}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.exit(main())
