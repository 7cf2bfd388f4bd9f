"""Child process of tests/test_torch_ladder_emulated.py: builds three
sections of ``ytpu_torch/csrc/mosaic_ladder.cu``, each alone with the
shared helpers, for the host through tests/cuda_host (a CUDA emulator):
the map put (the kernel of rungs 0 and 7), the scan and nested sum (rungs
4 and 5) and the row put and carried sum (rungs 1 and 3). It runs each
case through the rungs' C entry points (or, for rung 1, a host-only entry
that sets how many rows one grid covers) beside their plain versions
(`copy_plain`, `big_tile_plain`, `while_scan_plain`, `nested_fori_plain`,
`onehot_put_plain`, `fori_carry_plain`) and prints one JSON object: rung
-> case -> max abs difference, whether the input and the memory around
the output were left as they were, whether the 16-byte path ran, its
groups (per row for rungs 1 and 4), and the groups a CTA stores at most
(rung 3: also whether its head was read in int4).

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

from ytpu_torch.benches.mosaic_ladder import (  # noqa: E402
    big_tile_plain, copy_plain, fori_carry_plain, nested_fori_plain, onehot_put_plain, while_scan_plain,
)

torch.set_num_threads(1)
SENTINEL = -123456789
I32_MIN, I32_MAX = -(2**31), 2**31 - 1

# host-only: the groups a CTA maps (map put) or stores at most (rungs 4, 5)
MAP_ENTRIES = """
extern "C" long long emu_map_per_cta() { return MAP_PER_CTA; }
"""
SCAN_ENTRIES = """
extern "C" long long emu_scan_per_cta() { return (long long)SCAN_G * SCAN_THREADS; }
extern "C" long long emu_sum_per_cta() { return (long long)SUM_G * SUM_THREADS; }
"""

# host-only: rung 1 with the rows one grid covers set (CTAs stride over
# rows past it); the groups a CTA puts (rung 1) or stores (rung 3)
ROW_ENTRIES = """
extern "C" int emu_r1_rows(const void* x, void* o, int D, int C, int max_y) {
  return launch_row_put<ROW_G, ROW_THREADS>((const int*)x, (int*)o, D, C, max_y, nullptr);
}
extern "C" long long emu_row_per_cta() { return (long long)ROW_G * ROW_THREADS; }
extern "C" long long emu_carry_per_cta() { return (long long)CARRY_G * CARRY_THREADS; }
"""

SHARED = ("// ---- shared helpers", "// ---- end shared helpers")
# section -> (start marker, end marker, launches in it, host-only entries)
SECTIONS = {
    "map_put": ("// ---- map put", "// ---- end map put", 2, MAP_ENTRIES),
    "scan_sum": ("// ---- scan and nested sum", "// ---- end scan and nested sum", 4, SCAN_ENTRIES),
    "row_carry": ("// ---- row put and carried sum", "// ---- end row put and carried sum", 4, ROW_ENTRIES),
}

# the map put's rungs, and those of the scan and nested sum: rung ->
# (section, C entry point, plain version, host entry of the groups a CTA stores)
RUNGS = {"r0": ("map_put", "ytpu_ladder_r0", copy_plain, "emu_map_per_cta"),
         "r7": ("map_put", "ytpu_ladder_r7", big_tile_plain, "emu_map_per_cta")}
SCAN_RUNGS = {"r4": ("scan_sum", "ytpu_ladder_r4", while_scan_plain, "emu_scan_per_cta"),
              "r5": ("scan_sum", "ytpu_ladder_r5", nested_fori_plain, "emu_sum_per_cta")}
ROW_RUNGS = {"r1": ("row_carry", "ytpu_ladder_r1", onehot_put_plain, "emu_row_per_cta"),
             "r3": ("row_carry", "ytpu_ladder_r3", fori_carry_plain, "emu_carry_per_cta")}
ALL_RUNGS = RUNGS | SCAN_RUNGS | ROW_RUNGS


def section_text(src: str, start: str, end: str) -> str:
    m = re.search(re.escape(start) + r".*?" + re.escape(end), src, flags=re.S)
    if m is None:
        raise RuntimeError(f"mosaic_ladder.cu has no section {start!r}")
    return m.group(0)


def host_source(src: str, section: str) -> str:
    """The includes, the shared helpers and one section of mosaic_ladder.cu
    with its launches replaced by the emulator's, and the section's
    host-only entries inside its namespace."""
    start, end, launches, entries = SECTIONS[section]
    includes = "".join(line + "\n" for line in src.splitlines() if line.startswith("#include"))
    shared = section_text(src, *SHARED)
    body, n = re.subn(r"(\w+(?:<[^<>]*>)?)<<<([^,]+),\s*([^,]+),\s*0,\s*st>>>\(",
                      r"EMU_LAUNCH(\2, \3, 0, (\1), ", section_text(src, start, end))
    if n != launches:
        raise RuntimeError(f"the {section} section no longer has the {launches} launches the emulator "
                           f"rewrites: {n}")
    head, tail = body.split("}  // namespace", 1)
    return includes + "\n" + shared + "\n\n" + head + entries + "}  // namespace" + tail


def load(build_dir: Path) -> dict:
    """Both sections' host libraries, compiled by two g++ at once."""
    src = (ROOT / "ytpu_torch" / "csrc" / "mosaic_ladder.cu").read_text()
    jobs = {}
    for section in SECTIONS:
        path = build_dir / f"{section}_host.cpp"
        path.write_text(host_source(src, section))
        lib_path = build_dir / f"lib{section}_host.so"
        jobs[section] = (lib_path, subprocess.Popen(
            ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-Wno-unknown-pragmas",
             "-I", str(ROOT / "tests" / "cuda_host"), "-o", str(lib_path), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for section, (lib_path, job) in jobs.items():
        out, _ = job.communicate()
        if job.returncode:
            raise RuntimeError(f"g++ failed on the {section} section:\n{out[-4000:]}")
        libs[section] = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    for section, fn, _, per_cta in ALL_RUNGS.values():
        getattr(libs[section], fn).restype = i
        getattr(libs[section], fn).argtypes = [p, p, i, i, p]
        getattr(libs[section], per_cta).restype = ctypes.c_longlong
    libs["row_carry"].emu_r1_rows.restype = i
    libs["row_carry"].emu_r1_rows.argtypes = [p, p, i, i, i]
    return libs


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


def uniform(shape, lo: int, hi: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(lo, hi, size=shape, dtype=np.int64).astype(np.int32))


# the value rung 4 gives each row of `break_steps`
BREAK_VALUES = [41, 50, 12, 2**30 + 10, I32_MIN + 39, 41]


def break_steps() -> torch.Tensor:
    """Six rows of 16 columns, columns past each row's end of scan 1,000:
    row 0 breaks at step 0 (41); row 1 at step 11 (eleven 0s, then 50); row
    2 never breaks and sums 12 columns of 1; row 3 crosses 40 only after
    its sum wraps (INT_MIN + 10, then -2^30: 2^30 + 10); row 4 wraps the
    other way (40, then INT_MAX: INT_MIN + 39, negative, so no break, then
    0s); row 5 sits at 40, not above it, then breaks at step 1 (41)."""
    x = np.full((6, 16), 1000, dtype=np.int64)
    x[0, 0] = 41
    x[1, :11], x[1, 11] = 0, 50
    x[2, :12] = 1
    x[3, 0], x[3, 1] = I32_MIN + 10, -(2**30)
    x[4, 0], x[4, 1], x[4, 2:12] = 40, I32_MAX, 0
    x[5, 0], x[5, 1] = 40, 1
    return torch.from_numpy(x.astype(np.int32))


# rung 4's cases, as CASES: its 16-byte path takes a row of C % 4 == 0
# columns with the input and the output 16-byte aligned
R4_CASES = {
    # the JAX rung's input (x[d, c] = c) and seeded ones at the program's shape
    "vec4_jax_input": (lambda: torch.arange(256, dtype=torch.int32)[None, :].repeat(8, 1), None),
    "vec4_seeded_0_12": (lambda: uniform((8, 256), 0, 12, 21), None),
    "vec4_full_range": (lambda: seeded((8, 256), 22), None),
    "vec4_break_steps": (break_steps, None),
    # fewer than 12 columns: on the 16-byte path (the third group clamped),
    # and on the one-int path
    "vec4_narrow_C8": (lambda: uniform((8, 8), 0, 12, 23), None),
    "scalar_C5": (lambda: uniform((8, 5), 0, 12, 24), None),
    "scalar_C11": (lambda: uniform((8, 11), 0, 12, 25), None),
    "scalar_C11_full_range": (lambda: seeded((8, 11), 26), None),
    "scalar_misaligned_x": (lambda: uniform((16, 256), 0, 12, 27), "x"),
    "scalar_misaligned_out": (lambda: uniform((16, 256), 0, 12, 28), "out"),
    "vec4_D1": (lambda: uniform((1, 256), 0, 12, 29), None),
    "vec4_D256": (lambda: uniform((256, 16), 0, 12, 30), None),
    # rows of more groups than a CTA stores: several CTAs a row, the last
    # partly empty
    "vec4_row_tiles": (lambda: uniform((2, 8200), 0, 12, 31), None),
    "scalar_row_tiles": (lambda: uniform((2, 2051), 0, 12, 32), None),
    "wrap_vec4": (lambda: at_wrap((8, 256)), None),
}

# rung 5's cases: its 16-byte path takes D * C % 4 == 0 ints with the output
# 16-byte aligned (it loads x[0, 0:32] one int a lane)
R5_CASES = {
    "vec4_jax_input": (lambda: torch.ones((8, 256), dtype=torch.int32), None),
    "vec4_full_range": (lambda: seeded((8, 256), 41), None),
    "vec4_D1": (lambda: seeded((1, 256), 42), None),
    "vec4_D256": (lambda: seeded((256, 16), 43), None),
    # fewer than 32 columns: the index wraps mod C
    "scalar_C5": (lambda: seeded((3, 5), 44), None),
    "scalar_C11": (lambda: seeded((3, 11), 45), None),
    "scalar_C31": (lambda: seeded((1, 31), 46), None),
    "vec4_C31": (lambda: seeded((4, 31), 47), None),
    # 33 columns, past one warp's terms; 132 ints, so the 16-byte path
    "vec4_C33": (lambda: seeded((4, 33), 48), None),
    "vec4_x_off_16_bytes": (lambda: seeded((16, 256), 49), "x"),
    "scalar_misaligned_out": (lambda: seeded((16, 256), 50), "out"),
    "vec4_ragged_last_cta": (lambda: seeded((25, 528), 51), None),
    "wrap_vec4": (lambda: at_wrap((8, 256)), None),
    "wrap_scalar": (lambda: at_wrap((5, 7)), None),
}

def with_heads(shape, heads, seed: int) -> torch.Tensor:
    """A seeded tile whose rows take the column indices `heads` in turn."""
    x = seeded(shape, seed)
    x[:, 0] = torch.tensor(np.resize(np.array(heads, dtype=np.int64), shape[0]).astype(np.int32))
    return x


def edge_heads(C: int) -> list:
    """Rung 1's head indices at the edges: the first column (the head cell
    itself), the last, one past it, -1, INT_MIN and INT_MAX."""
    return [0, C - 1, C, -1, I32_MIN, I32_MAX]


def seeded_heads(shape, seed: int) -> torch.Tensor:
    """A seeded tile with head indices in [-2, C + 2)."""
    rng = np.random.default_rng(seed + 1000)
    return with_heads(shape, rng.integers(-2, shape[1] + 2, size=shape[0]), seed)


# rung 1's cases: (input maker, misaligned operand or None, the rows one
# grid covers or None for the card's 65,535). Its 16-byte path takes a row
# of C % 4 == 0 columns with the input and the output 16-byte aligned
R1_CASES = {
    # the JAX rung's input (x[d, c] = d: row d puts 7 at column d)
    "vec4_jax_input": (lambda: torch.arange(8, dtype=torch.int32)[:, None].repeat(1, 256), None, None),
    "vec4_seeded": (lambda: seeded_heads((8, 256), 61), None, None),
    "vec4_edges": (lambda: with_heads((6, 256), edge_heads(256), 62), None, None),
    # an index in the last int of a row on the one-int path, and the other edges
    "scalar_edges_C5": (lambda: with_heads((6, 5), edge_heads(5), 63), None, None),
    "scalar_edges_C11": (lambda: with_heads((6, 11), edge_heads(11), 64), None, None),
    "scalar_seeded_C11": (lambda: seeded_heads((16, 11), 65), None, None),
    # rows of more groups than a CTA puts, indices in their last tiles
    "vec4_row_tiles": (lambda: with_heads((3, 8200), [8199, 4097, 1030], 66), None, None),
    "scalar_row_tiles": (lambda: with_heads((3, 2051), [2050, 1000, 256], 67), None, None),
    "vec4_D1": (lambda: with_heads((1, 256), [200], 68), None, None),
    "scalar_misaligned_x": (lambda: seeded_heads((16, 256), 69), "x", None),
    "scalar_misaligned_out": (lambda: seeded_heads((16, 256), 70), "out", None),
    # more rows than one grid covers: CTAs stride over rows
    "vec4_rows_stride": (lambda: seeded_heads((9, 64), 71), None, 4),
    "scalar_rows_stride": (lambda: with_heads((7, 5), [4, 0, 3, 5, -1, 2, 1], 72), None, 3),
    "wrap_vec4": (lambda: at_wrap((8, 256)), None, None),
}

# rung 3's cases, as CASES. It reads its head in int4 when C % 4 == 0 with
# the input 16-byte aligned (else the name says head_ints), and stores in
# int4 (the name's vec4) when D * C % 4 == 0 with the output 16-byte aligned
R3_CASES = {
    # the JAX rung's input: 16 * 8 = 128
    "vec4_jax_input": (lambda: torch.ones((8, 256), dtype=torch.int32), None),
    "vec4_full_range": (lambda: seeded((8, 256), 81), None),
    "vec4_C16": (lambda: seeded((8, 16), 82), None),
    # 17 and 18 columns: the head one int a group, the tile stored in int4
    "vec4_C17_head_ints": (lambda: seeded((8, 17), 83), None),
    "vec4_C18_head_ints": (lambda: seeded((8, 18), 84), None),
    # 51 ints: both one int a group
    "scalar_3x17_head_ints": (lambda: seeded((3, 17), 85), None),
    "vec4_D1": (lambda: seeded((1, 256), 86), None),
    # 1,024 head groups over 256 threads (four a thread), 400 (some threads
    # take two), 4,096 ints (sixteen a thread)
    "vec4_D256": (lambda: seeded((256, 16), 87), None),
    "vec4_D100": (lambda: seeded((100, 20), 88), None),
    "vec4_D256_head_ints": (lambda: seeded((256, 17), 89), None),
    # several CTAs, each summing the head, the last partly empty
    "vec4_ctas_ragged": (lambda: seeded((64, 1000), 90), None),
    "scalar_ctas_ragged_head_ints": (lambda: seeded((9, 333), 91), None),
    "vec4_misaligned_x_head_ints": (lambda: seeded((16, 256), 92), "x"),
    "scalar_misaligned_out": (lambda: seeded((16, 256), 93), "out"),
    "wrap_vec4": (lambda: at_wrap((8, 256)), None),
}

CASES_OF = {"r0": CASES, "r7": CASES, "r4": R4_CASES, "r5": R5_CASES, "r1": R1_CASES, "r3": R3_CASES}


def run(libs, rung: str, name: str) -> dict:
    section, symbol, plain, per_cta = ALL_RUNGS[rung]
    lib = libs[section]
    make, misaligned, *grid = CASES_OF[rung][name]
    grid = grid[0] if grid else None
    x = make()
    x_k = offset_by_one(x) if misaligned == "x" else x.clone()
    # the output inside a SENTINEL-filled buffer, 16-byte aligned or one int
    # past that, with SENTINELs on both sides
    buf = torch.full((x.numel() + 16,), SENTINEL, dtype=x.dtype)
    off = (-(buf.data_ptr() // 4)) % 4 + 4 + (1 if misaligned == "out" else 0)
    o = buf[off : off + x.numel()].view(x.shape)
    cols = x.shape[-1]
    rows = x.numel() // cols
    args = (x_k.data_ptr(), o.data_ptr(), rows, cols)
    if grid is None:
        err = getattr(lib, symbol)(*args, None)
    else:
        err = lib.emu_r1_rows(*args, grid)
    if err:
        raise RuntimeError(f"{rung} {name}: emulated launch returned {err}")
    x_al, o_al = x_k.data_ptr() % 16 == 0, o.data_ptr() % 16 == 0
    out = {}
    if rung in ("r1", "r4"):  # a row's groups
        vec4 = cols % 4 == 0 and x_al and o_al
        groups = cols // 4 if vec4 else cols
    else:
        vec4 = x.numel() % 4 == 0 and o_al and (x_al or rung in ("r3", "r5"))
        groups = x.numel() // 4 if vec4 else x.numel()
    if rung == "r3":
        out["head_vec4"] = cols % 4 == 0 and x_al
    return out | {
        "max_abs_err": int((o.long() - plain(x).long()).abs().max()),
        "input_kept": bool(torch.equal(x_k, x)),
        "outside_kept": bool((buf[:off] == SENTINEL).all() and (buf[off + x.numel():] == SENTINEL).all()),
        "vec4": vec4,
        "groups": groups,
        "per_cta": getattr(lib, per_cta)(),
        "rows_per_grid": grid if rung == "r1" else None,
    }


def main() -> int:
    libs = load(Path(sys.argv[1]))
    out = {rung: {name: run(libs, rung, name) for name in CASES_OF[rung]} for rung in CASES_OF}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.exit(main())
