"""Child process of tests/test_torch_ladder_emulated.py: builds the map-put
section of ``ytpu_torch/csrc/mosaic_ladder.cu`` (the kernel of rungs 0 and
7) for the host through tests/cuda_host (a CUDA emulator), runs each case
through both rungs' C entry points beside their plain versions
(`copy_plain`, `big_tile_plain`) and prints one JSON object: rung -> case
-> max abs difference, whether the input and the memory around the
output were left as they were, whether the 16-byte path ran, its groups,
and the groups a CTA maps.

Usage: python tests/_emulated_ladder.py BUILD_DIR
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

from ytpu_torch.benches.mosaic_ladder import big_tile_plain, copy_plain  # noqa: E402

torch.set_num_threads(1)
SENTINEL = -123456789
I32_MIN, I32_MAX = -(2**31), 2**31 - 1

# host-only: the groups a CTA maps
HOST_ENTRIES = """
extern "C" long long emu_map_per_cta() { return MAP_PER_CTA; }
"""

RUNGS = {"r0": ("ytpu_ladder_r0", copy_plain), "r7": ("ytpu_ladder_r7", big_tile_plain)}


def host_source(src: str) -> str:
    """The includes and the map-put section of mosaic_ladder.cu with its
    launches replaced by the emulator's, and `HOST_ENTRIES` inside the
    section's namespace."""
    includes = "".join(line + "\n" for line in src.splitlines() if line.startswith("#include"))
    m = re.search(r"// ---- map put.*?// ---- end map put", src, flags=re.S)
    if m is None:
        raise RuntimeError("mosaic_ladder.cu has no map-put section")
    body, n = re.subn(r"(\w+(?:<[^<>]*>)?)<<<([^,]+),\s*([^,]+),\s*0,\s*st>>>\(",
                      r"EMU_LAUNCH(\2, \3, 0, (\1), ", m.group(0))
    if n != 2:
        raise RuntimeError(f"the map-put section no longer has the launches the emulator rewrites: {n}")
    head, tail = body.split("}  // namespace", 1)
    return includes + "\n" + head + HOST_ENTRIES + "}  // namespace" + tail


def load(build_dir: Path) -> ctypes.CDLL:
    src = build_dir / "ladder_host.cpp"
    src.write_text(host_source((ROOT / "ytpu_torch" / "csrc" / "mosaic_ladder.cu").read_text()))
    lib_path = build_dir / "libladder_host.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-Wno-unknown-pragmas",
                    "-I", str(ROOT / "tests" / "cuda_host"), "-o", str(lib_path), str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn, _ in RUNGS.values():
        getattr(lib, fn).restype = i
        getattr(lib, fn).argtypes = [p, p, i, i, p]
    lib.emu_map_per_cta.restype = ctypes.c_longlong
    return lib


def seeded(shape, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(I32_MIN, I32_MAX + 1, size=shape, dtype=np.int64).astype(np.int32))


def at_wrap(shape) -> torch.Tensor:
    """INT_MAX, INT_MIN, -1, 2^30, 2^30 - 1, -2^30, 0, 1 over and over."""
    vals = np.array([I32_MAX, I32_MIN, -1, 2**30, 2**30 - 1, -(2**30), 0, 1], dtype=np.int64)
    n = int(np.prod(shape))
    return torch.from_numpy(np.resize(vals, n).astype(np.int32).reshape(shape))


def offset_by_one(t: torch.Tensor) -> torch.Tensor:
    """A copy of `t` that starts 4 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 8, dtype=t.dtype)
    off = (-(buf.data_ptr() // 4)) % 4 + 1
    out = buf[off : off + t.numel()].view(t.shape)
    out.copy_(t)
    return out


# name -> (input maker, misaligned operand or None). The test checks that
# the cases named for a launch shape have it
CASES = {
    # rung 0's program shape: 512 groups of 4
    "vec4_8x256": (lambda: seeded((8, 256), 1), None),
    # rung 7's shape with fewer columns: 3,200 groups over several CTAs
    "vec4_25x8x64": (lambda: seeded((25, 8, 64), 2), None),
    # 3,300 groups: the last CTA partly empty
    "vec4_ragged_last_cta": (lambda: seeded((25, 528), 3), None),
    # 63 groups: fewer than one CTA's
    "vec4_63_groups": (lambda: seeded((7, 36), 4), None),
    # the one-int path: 999 ints (not a multiple of 4)
    "scalar_3x333": (lambda: seeded((3, 333), 5), None),
    # the one-int path: 4,096 ints, the input or the output one int off a
    # 16-byte boundary
    "scalar_misaligned_x": (lambda: seeded((16, 256), 6), "x"),
    "scalar_misaligned_out": (lambda: seeded((16, 256), 7), "out"),
    # values at the wrap on both paths
    "wrap_vec4": (lambda: at_wrap((8, 256)), None),
    "wrap_scalar": (lambda: at_wrap((5, 7)), None),
}


def run(lib, rung: str, name: str) -> dict:
    symbol, plain = RUNGS[rung]
    make, misaligned = CASES[name]
    x = make()
    x_k = offset_by_one(x) if misaligned == "x" else x.clone()
    # the output inside a SENTINEL-filled buffer, 16-byte aligned or one int
    # past that, with SENTINELs on both sides
    buf = torch.full((x.numel() + 16,), SENTINEL, dtype=x.dtype)
    off = (-(buf.data_ptr() // 4)) % 4 + 4 + (1 if misaligned == "out" else 0)
    o = buf[off : off + x.numel()].view(x.shape)
    cols = x.shape[-1]
    err = getattr(lib, symbol)(x_k.data_ptr(), o.data_ptr(), x.numel() // cols, cols, None)
    if err:
        raise RuntimeError(f"{rung} {name}: emulated launch returned {err}")
    vec4 = x.numel() % 4 == 0 and x_k.data_ptr() % 16 == 0 and o.data_ptr() % 16 == 0
    return {
        "max_abs_err": int((o.long() - plain(x).long()).abs().max()),
        "input_kept": bool(torch.equal(x_k, x)),
        "outside_kept": bool((buf[:off] == SENTINEL).all() and (buf[off + x.numel():] == SENTINEL).all()),
        "vec4": vec4,
        "groups": x.numel() // 4 if vec4 else x.numel(),
        "per_cta": lib.emu_map_per_cta(),
    }


def main() -> int:
    lib = load(Path(sys.argv[1]))
    out = {rung: {name: run(lib, rung, name) for name in CASES} for rung in RUNGS}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.exit(main())
