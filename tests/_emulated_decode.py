"""Child process of tests/test_torch_decode_emulated.py: builds
``ytpu_torch/csrc/decode.cu`` for the host through tests/cuda_host (a CUDA
emulator), runs it on sets of update lanes next to the plain loop
`decode_kernel._decode_loop_reference`, and runs three mutants of the
source on the set that each must fail, then prints one JSON object: case
-> {max_abs_err, lanes, flags (OR over the lanes), max_steps}, and
``mutants`` -> mutant -> max abs difference on its case.

The kernel and its mutants are compiled in one g++ call: each copy of the
source sits in a namespace of its own, with its C entry points renamed.

Usage: python tests/_emulated_decode.py BUILD_DIR
"""

import ctypes
import gzip
import json
import os
import pickle
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

from ytpu_torch.core.update import merge_updates_v1  # noqa: E402
from ytpu_torch.models.replay import plan_replay  # noqa: E402
from ytpu_torch.ops import decode_kernel as dk  # noqa: E402

torch.set_num_threads(1)

B4_LOG = ROOT / "benches" / "data" / "b4_log.pkl.gz"
B4_LANES = 1024
MERGED_PREFIXES = (8, 24, 40)

# mutants of the source, each a (line, replacement) pair, and the case
# each must fail: the varint window read past lens; a step budget that is
# ignored; a row or delete overflow that stops the lane
MUTANTS = {
    "window_not_masked_by_lens": (
        "b10[k] = i < len ? (i64)row[clamp_idx(i, last)] : 0;",
        "b10[k] = (i64)row[clamp_idx(i, last)];", "lens_cut"),
    "step_budget_ignored": (
        "for (; step < T; ++step) {", "for (; step < (1 << 16); ++step) {", "overflow_U1_R1_T12"),
    "overflow_stops_lane": (
        "if (row_ovf || del_ovf) flags |= FLAG_OVERFLOW;",
        "if (row_ovf || del_ovf) { flags |= FLAG_OVERFLOW; st2 = ST_ERR; }", "overflow_U1_R1_T96"),
}
# a lane that tells a varint window masked by lens from one that is not:
# one block of ContentAny under a named root holding one string value whose
# length varint is ff ff ff ff 8f (-1 after the 32-bit wrap, and a
# continuation bit on its fifth byte). Masked, the window ends at lens
# (nb2 = 6, the value takes 6 bytes and ends at lens: a row); unmasked,
# the ff bytes past lens run the varint on (nb2 = 9, past lens: ERR, no row)
CRAFTED = [(bytes.fromhex("01010100080101610177ffffffff8fffffff"), 15)]
EXPORTS = ("ytpu_decode_v1", "ytpu_cuda_error_string")


def host_source(src: str) -> str:
    """decode.cu with its launch replaced by the emulator's."""
    out, n = re.subn(r"(\w+)<<<([^,]*),\s*([^,]*),\s*([^,]*),\s*\(cudaStream_t\)stream>>>\(",
                     r"EMU_LAUNCH(\2, \3, \4, \1, ", src)
    if n != 1:
        raise RuntimeError(f"decode.cu no longer has the one launch the emulator rewrites: {n}")
    return out


def variant(src: str, name: str) -> str:
    """The host source as namespace `name`, its C entry points suffixed
    with ``_name``; a mutant has its line replaced."""
    body = src.replace("#include <cuda_runtime.h>\n", "").replace("#include <cstdint>\n", "")
    if name in MUTANTS:
        line, other, _ = MUTANTS[name]
        if body.count(line) != 1:
            raise RuntimeError(f"decode.cu no longer has the line the {name} mutant rewrites")
        body = body.replace(line, other)
    for fn in EXPORTS:
        body, n = re.subn(rf"\b{fn}\(", f"{fn}_{name}(", body)
        if n != 1:
            raise RuntimeError(f"decode.cu defines {fn} {n} times")
    return f"namespace {name} {{\n{body}\n}}  // namespace {name}\n"


def build(build_dir: Path) -> ctypes.CDLL:
    src = host_source((ROOT / "ytpu_torch" / "csrc" / "decode.cu").read_text())
    text = "#include <cuda_runtime.h>\n#include <cstdint>\n" + "".join(
        variant(src, name) for name in ("kernel",) + tuple(MUTANTS))
    cpp = build_dir / "decode_host.cpp"
    cpp.write_text(text)
    lib = build_dir / "libdecode_host.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-Wno-unknown-pragmas",
                    "-I", str(ROOT / "tests" / "cuda_host"), "-o", str(lib), str(cpp)],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def entry(lib: ctypes.CDLL, name: str):
    """The C entry points of variant `name`, under the names
    `decode_kernel._launch_decode` calls."""
    out = types.SimpleNamespace()
    for fn in EXPORTS:
        f = getattr(lib, f"{fn}_{name}")
        f.restype = ctypes.c_char_p if fn == "ytpu_cuda_error_string" else ctypes.c_int
        f.argtypes = [ctypes.c_int] if fn == "ytpu_cuda_error_string" else dk.DECODE_SIGNATURES[fn]
        setattr(out, fn, f)
    out._ytpu_error_string = out.ytpu_cuda_error_string
    return out


# ---- the lane sets ---------------------------------------------------------------


def b4_log(n):
    with gzip.open(B4_LOG, "rb") as f:
        return pickle.load(f)["log"][:n]


def garbage_lanes(rng) -> list:
    """Seeded random bytes, bare and behind the header of one client
    section with one block (so the machine goes deep before it errs)."""
    out = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes() for n in rng.integers(1, 80, 48)]
    out += [b"\x01\x01" + rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
            for n in rng.integers(1, 60, 48)]
    # varints of 5 and more bytes where the machine reads counts, clients
    # and any-value lengths
    out += [b"\x01\x01\xff\xff\xff\xff\x7f\x00\x04", b"\x01\x01\x81\x80\x80\x80\x10\x00",
            b"\x00\x01\xff\xff\xff\xff\xff\x01", b"\xff\xff\xff\xff\x0f"]
    return out


def lane_sets() -> dict:
    """case -> (payloads or (buf, lens), U, R, T, max_sections)."""
    from test_torch_decode import corpus

    rng = np.random.default_rng(20261018)
    c = corpus()
    b4 = b4_log(B4_LANES)
    plan = plan_replay(b4)
    sets = {
        "corpus": (c, 4, 4, 96, None),
        "b4_slice": (b4, plan.max_rows, plan.max_dels, plan.max_steps, plan.max_sections),
        "overflow_U1_R1_T12": (c[:8], 1, 1, 12, None),
        "sections_U4_R4_T96_sec0": (c[:8], 4, 4, 96, 0),
        "overflow_U1_R1_T96": (c, 1, 1, 96, None),
        "truncated": ([p[:k] for p in c for k in sorted({1, len(p) // 3, len(p) // 2, len(p) - 1}) if k > 0],
                      4, 4, 96, None),
        "garbage": (garbage_lanes(rng), 4, 4, 96, None),
    }
    # lanes whose bytes run on past lens: the full payload in the matrix,
    # lens cut short; then CRAFTED, whose lens ends inside an Any value's
    # length varint
    buf, lens = dk.pack_updates(c + [p for p, _ in CRAFTED])
    cut = lens.copy()
    for i, n in enumerate(lens[: len(c)]):
        cut[i] = int(rng.integers(1, max(2, int(n))))
    cut[len(c):] = [n for _, n in CRAFTED]
    sets["lens_cut"] = ((buf, cut), 4, 4, 96, None)
    # merged updates of B4 prefixes: long lanes of different lengths
    merged = [merge_updates_v1(b4[:n]) for n in MERGED_PREFIXES]
    mp = plan_replay(merged)
    sets["merged"] = (merged, mp.max_rows, mp.max_dels, mp.max_steps, mp.max_sections)
    return sets


def run_case(lib, payloads, U, R, T, max_sections):
    if isinstance(payloads, tuple):
        buf, lens = payloads
    else:
        buf, lens = dk.pack_updates(payloads)
    max_sec = max_sections if max_sections is not None else U + 1
    buf_t = torch.from_numpy(np.ascontiguousarray(buf))
    lens_t = torch.from_numpy(np.asarray(lens)).to(torch.int64).contiguous()
    rows_p, dels_p, flags_p = dk._decode_loop_reference(buf_t, lens_t, U, R, T, max_sec)
    rows_k, dels_k, flags_k, steps = dk._launch_decode(lib, buf_t, lens_t, U, R, T, max_sec, None, steps=True)
    err = int((flags_k - flags_p).abs().max()) if flags_p.numel() else 0
    for want, got in ((rows_p, rows_k), (dels_p, dels_k)):
        if set(want) != set(got):
            raise RuntimeError(f"column sets differ: {sorted(want)} vs {sorted(got)}")
        for name in want:
            if want[name].numel():
                err = max(err, int((got[name].to(torch.int64) - want[name].to(torch.int64)).abs().max()))
    return {"max_abs_err": err, "lanes": int(buf.shape[0]),
            "flags": int(np.bitwise_or.reduce(flags_p.numpy())) if flags_p.numel() else 0,
            "max_steps": int(steps.max()) if steps.numel() else 0, "T": T}


def main(build_dir: str) -> None:
    lib = build(Path(build_dir))
    sets = lane_sets()
    kernel = entry(lib, "kernel")
    out = {case: run_case(kernel, *args) for case, args in sets.items()}
    out["mutants"] = {name: run_case(entry(lib, name), *sets[case])["max_abs_err"]
                      for name, (_, _, case) in MUTANTS.items()}
    print(json.dumps(out))


if __name__ == "__main__":
    os.makedirs(sys.argv[1], exist_ok=True)
    main(sys.argv[1])
