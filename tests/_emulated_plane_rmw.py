"""Child process of tests/test_torch_plane_rmw_emulated.py: builds two
sections of ``ytpu_torch/csrc/plane_rmw.cu``, each alone, for the host
through tests/cuda_host (a CUDA emulator): the column put (the kernel of
cases a / a2, g3d / g2d and v_vmem) and the multi call (v_multi's sized
copy and v_body's one-pass client clock). It runs each case beside its
plain version (`masked_put_plain`, `g3d_plain`, `g2d_flat_plain`,
`v_vmem_plain`, `v_multi_plain`, `v_body_plain`) and prints one JSON
object: section -> case -> max abs difference, whether the inputs were
left as they were, and whether the 16-byte path ran.

The column-put cases marked wide launch it with 64-bit indices (the
instantiation the card takes from 2^31 ints on) through a host-only entry
point, on a small input; the v_body cases with a ``shape`` launch the
one-pass kernel at a small CTA (32 or 64 threads, 1 or 4 groups a thread)
through another, so that a doc's live slots take several tiles; the
others go through the library's own C entry points.

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
from ytpu_torch.benches.plane_rmw_repro3 import (  # noqa: E402
    inputs as multi_program_inputs, v_body_plain, v_multi_plain, v_vmem_plain,
)

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


# host-only: the one-pass v_body at small CTAs (G groups a thread, T threads)
MULTI_HOST_ENTRIES = """
extern "C" int emu_v_body_shape(const void* rows, const void* cols, const void* meta, void* mo, int S, int U,
                                int W, int D, int C, int MP, int shape) {
  const int* r = (const int*)rows;
  const int* x = (const int*)cols;
  const int* m = (const int*)meta;
  if (shape == 0) return client_clock_launch<1, 32>(r, x, m, (int*)mo, S * U, W, D, C, MP, nullptr);
  return client_clock_launch<4, 64>(r, x, m, (int*)mo, S * U, W, D, C, MP, nullptr);
}
"""
SHAPES = {"G1_T32": 0, "G4_T64": 1}


def _section(src: str, start: str, end: str) -> str:
    m = re.search(re.escape(start) + r".*?" + re.escape(end), src, flags=re.S)
    if m is None:
        raise RuntimeError(f"plane_rmw.cu has no section {start!r}")
    return m.group(0)


# section -> (start marker, end marker, launches in it, host-only entries)
SECTIONS = {
    "column_put": ("// ---- column put", "// ---- end column put", 2, HOST_ENTRIES),
    "multi_call": ("// ---- multi call", "// ---- end multi call", 4, MULTI_HOST_ENTRIES),
}


def host_source(src: str, section: str) -> str:
    """The includes and one section of plane_rmw.cu with its launches
    (``kernel<<<grid, threads, 0, st>>>(``) replaced by the emulator's,
    and the section's host-only entries inside its namespace."""
    start, end, launches, entries = SECTIONS[section]
    includes = "".join(line + "\n" for line in src.splitlines() if line.startswith("#include"))
    body, n = re.subn(r"(\w+(?:<[^<>]*>)?)<<<(.*?),\s*(\w+),\s*0,\s*st>>>\(",
                      r"EMU_LAUNCH(\2, \3, 0, (\1), ", _section(src, start, end), flags=re.S)
    if n != launches:
        raise RuntimeError(f"the {section} section no longer has the {launches} launches the emulator "
                           f"rewrites: {n}")
    head, ns_end = body.rsplit("}  // namespace", 1)
    return includes + "\n" + head + entries + "}  // namespace\n" + ns_end


# C entry points of each section's host library
SIGNATURES = {
    "column_put": (("ytpu_column_put", "ppqiiip"), ("ytpu_plane_masked_put", "ppiiiiiip"),
                   ("emu_column_put_wide", "ppqiiiqq")),
    "multi_call": (("ytpu_plane_v_multi", "ppiip"), ("ytpu_plane_v_body", "ppppiiiiiip"),
                   ("emu_v_body_shape", "ppppiiiiiii")),
}
CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "q": ctypes.c_longlong}


def load(build_dir: Path) -> dict:
    """Both sections' host libraries, compiled by two g++ at once."""
    src = (ROOT / "ytpu_torch" / "csrc" / "plane_rmw.cu").read_text()
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
        lib = libs[section] = ctypes.CDLL(str(lib_path))
        for fn, sig in SIGNATURES[section]:
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = [CTYPES[c] for c in sig]
    return libs


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
# is 256 lanes)
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


# --- the multi call ---------------------------------------------------------------------


def body_inputs(seed: int, D: int = 6, C: int = 512, S: int = 1, U: int = 4, nb="random",
                wrap: float = 0.0, clocks=(-3, 53)):
    """Seeded (rows, dels, rank, cols, meta) for v_body: planes 0-2 of 4
    hold clients 0-3, clocks 0-49 (a `wrap` share of them within 3 of
    2^31 - 1, so clock + length wraps negative) and lengths 1-3; plane 3
    is noise no kernel reads; rows of clients 0-3 and `clocks` (so
    whether a row is met depends on the doc), row 1 invalid and row 2 at
    clock 0; meta noise with ``meta[:, 1]`` = `nb` ("random": 0..C, every
    other doc under 24, one doc below 0 and one past C; else an int) and
    the missing-dependency
    bit clear but in doc 1 (the body must keep it)."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(-(2**31), 2**31, size=(4, D, C), dtype=np.int64).astype(np.int32)
    cols[0] = rng.integers(0, 4, size=(D, C))
    cols[1] = rng.integers(0, 50, size=(D, C))
    cols[2] = rng.integers(1, 4, size=(D, C))
    near = rng.random((D, C)) < wrap
    cols[1][near] = rng.integers(2**31 - 3, 2**31, size=int(near.sum()))
    rows = (np.arange(S * U * 23, dtype=np.int32) % 7).reshape(S, U, 23)
    rows[:, :, 14] = 1
    rows[:, :, 0] = rng.integers(0, 4, size=(S, U))
    rows[:, :, 1] = rng.integers(*clocks, size=(S, U))
    rows[0, 1, 14] = 0
    rows[0, 2, 1] = 0
    meta = rng.integers(-1000, 1000, size=(D, 8)).astype(np.int32)
    if nb == "random":
        meta[:, 1] = rng.integers(0, C + 1, size=D)
        meta[2::2, 1] = rng.integers(0, 24, size=len(meta[2::2]))  # few live slots: rows missed
        meta[0, 1], meta[1, 1] = -5, C + 7
    else:
        meta[:, 1] = nb
    meta[:, 2] &= ~2
    meta[1, 2] |= 2
    return rows, np.zeros((S, 4, 4), np.int32), np.arange(256, dtype=np.int32).reshape(1, 256), cols, meta


def all_match_inputs():
    """Every slot of every doc holds client 2 with clock 2^31 - 2 and
    length 3, so every live slot offers the wrapped 2^31 + 1 (negative):
    with nb = C no slot offers 0 and a row of clock -5 or 0 is unsatisfied;
    with nb = C - 1 or 0 the slots past nb offer 0 and satisfy it. A row at
    clock -2^31 is met by any slot."""
    rows, dels, rank, cols, meta = body_inputs(40, D=4, C=64)
    cols[0], cols[1], cols[2] = 2, 2**31 - 2, 3
    meta[:, 1] = [64, 63, 0, 64]
    meta[:, 2] &= ~2
    rows[0, :, 14] = 1
    rows[0, :, 0] = [2, 2, 3, 2]
    rows[0, :, 1] = [-5, 0, 0, -(2**31)]
    return rows, dels, rank, cols, meta


def many_rows_inputs(U: int, invalid: slice, seed: int):
    """`U` rows (more than the 32 a pass decides), the rows of `invalid`
    not valid, over docs of random nb. The first 32 rows ask for clocks
    <= 0, which every doc meets here, so the flag rests on the later
    passes."""
    rows, dels, rank, cols, meta = body_inputs(seed, U=U)
    rows[0, :32, 1] = np.minimum(rows[0, :32, 1], 0)
    rows[0, invalid, 14] = 0
    return rows, dels, rank, cols, meta


# name -> (maker, options): "out" writes a separate SENTINEL-filled meta,
# "misaligned" views cols one int off a 16-byte boundary, "shape" launches
# at a small CTA (`SHAPES`)
BODY_CASES = {
    "program": (lambda: tuple(a.numpy() for a in multi_program_inputs("cpu")), {}),
    "nb_zero": (lambda: body_inputs(1, nb=0), {}),
    "nb_zero_clocks_at_most_0": (lambda: body_inputs(16, nb=0, clocks=(-3, 1)), {}),
    "nb_random_clocks_at_most_0": (lambda: body_inputs(17, clocks=(-3, 1)), {}),
    "nb_C": (lambda: body_inputs(2, nb=512), {}),
    "nb_random": (lambda: body_inputs(3), {}),
    "nb_random_out": (lambda: body_inputs(4), {"out": True}),
    "wrapping_clocks": (lambda: body_inputs(5, wrap=0.5), {}),
    "wrapping_clocks_nb_C": (lambda: body_inputs(6, nb=512, wrap=0.9), {}),
    "all_slots_match_wrapped": (all_match_inputs, {}),
    "rows_48": (lambda: many_rows_inputs(48, slice(30, 36), 7), {}),
    "rows_70_second_pass_invalid": (lambda: many_rows_inputs(70, slice(32, 64), 8), {}),
    "C510": (lambda: body_inputs(9, C=510), {}),
    "C510_nb_C": (lambda: body_inputs(10, C=510, nb=510, wrap=0.3), {}),
    "misaligned_cols": (lambda: body_inputs(11), {"misaligned": True}),
    "tiles_G1_T32": (lambda: body_inputs(12, C=1024), {"shape": "G1_T32"}),
    "tiles_G1_T32_rows_48": (lambda: many_rows_inputs(48, slice(0, 3), 13), {"shape": "G1_T32"}),
    "tiles_G4_T64_C510": (lambda: body_inputs(14, C=510, nb=510, wrap=0.2), {"shape": "G4_T64"}),
    "tiles_G4_T64_nb_random": (lambda: body_inputs(15, C=2048), {"shape": "G4_T64"}),
}


# name -> (meta maker, out of place, misaligned operand)
MULTI_CASES = {
    "program_in_place": (lambda: multi_program_inputs("cpu")[4].numpy(), False, None),
    "program_out": (lambda: multi_program_inputs("cpu")[4].numpy(), True, None),
    "seeded_out": (lambda: seeded((8, 8), 50).numpy(), True, None),
    "seeded_in_place": (lambda: seeded((8, 8), 51).numpy(), False, None),
    "misaligned_meta": (lambda: seeded((8, 8), 52).numpy(), True, "x"),
    "misaligned_out": (lambda: seeded((8, 8), 53).numpy(), True, "out"),
    "n_35": (lambda: seeded((7, 5), 54).numpy(), True, None),
    "many_ctas": (lambda: seeded((300, 8), 55).numpy(), True, None),
}


def run_multi(lib, name):
    make, out_of_place, misaligned = MULTI_CASES[name]
    meta = torch.from_numpy(make())
    m_k = offset_by_one(meta) if misaligned == "x" else meta.clone()
    o = m_k
    if out_of_place:
        o = torch.full_like(meta, SENTINEL)
        if misaligned == "out":
            o = offset_by_one(o)
    args = multi_program_inputs("cpu")
    _, want = v_multi_plain(*args[:4], meta.clone(), torch.empty_like(meta) if out_of_place else None)
    err = lib.ytpu_plane_v_multi(m_k.data_ptr(), o.data_ptr(), *meta.shape, None)
    if err:
        raise RuntimeError(f"{name}: emulated launch returned {err}")
    return {
        "max_abs_err": int((o.long() - want.long()).abs().max()),
        "input_kept": bool(torch.equal(m_k, meta)) if out_of_place else None,
        "vec4": meta.numel() % 4 == 0 and m_k.data_ptr() % 16 == 0 and o.data_ptr() % 16 == 0,
    }


def run_body(lib, name):
    make, opts = BODY_CASES[name]
    rows, dels, rank, cols, meta = (torch.from_numpy(np.ascontiguousarray(a)) for a in make())
    c_k = offset_by_one(cols) if opts.get("misaligned") else cols.clone()
    m_k = meta.clone()
    mo = torch.full_like(meta, SENTINEL) if opts.get("out") else m_k
    _, want = v_body_plain(rows, dels, rank, cols.clone(), meta.clone())
    S, U, W = rows.shape
    _, D, C = cols.shape
    call = (rows.data_ptr(), c_k.data_ptr(), m_k.data_ptr(), mo.data_ptr(), S, U, W, D, C, meta.shape[1])
    if "shape" in opts:
        err = lib.emu_v_body_shape(*call, SHAPES[opts["shape"]])
    else:
        err = lib.ytpu_plane_v_body(*call, None)
    if err:
        raise RuntimeError(f"{name}: emulated launch returned {err}")
    return {
        "max_abs_err": int((mo.long() - want.long()).abs().max()),
        "cols_kept": bool(torch.equal(c_k, cols)),
        "meta_kept": bool(torch.equal(m_k, meta)) if opts.get("out") else None,
        # docs whose missing-dependency bit the body set (it was clear)
        "flagged": ((want[:, 2] & 2) & ~meta[:, 2]).nonzero().flatten().tolist(),
        "docs": D,
        "vec4": C % 4 == 0 and c_k.data_ptr() % 16 == 0,
    }


def main() -> int:
    libs = load(Path(sys.argv[1]))
    out = {"column_put": {name: run(libs["column_put"], name) for name in CASES},
           "v_multi": {name: run_multi(libs["multi_call"], name) for name in MULTI_CASES},
           "v_body": {name: run_body(libs["multi_call"], name) for name in BODY_CASES}}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.exit(main())
