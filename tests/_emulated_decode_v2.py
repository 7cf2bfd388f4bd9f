"""Child process of tests/test_torch_decode_v2_emulated.py: builds
``ytpu_torch/csrc/decode_v2.cu`` for the host through tests/cuda_host (a
CUDA emulator), runs it on the V2 lane sets next to the plain version
`decode_v2._decode_v2_reference`, runs mutants of the source that each
must differ, and prints one JSON object: case -> {max_abs_err over the 21
pre-resolve row columns, the 3 delete columns, both valid masks and the
flags (every lane, every row), resolved_err (the same after
`_resolve_and_pack` with the set's tables), lanes, flags (OR over the
lanes after the tables), error_lanes}, and ``mutants`` -> mutant -> max
abs difference on its case.

The kernel and its mutants are compiled by two g++ calls at once; each
copy of the source sits in a namespace of its own, its C entry points
renamed.

Usage: python tests/_emulated_decode_v2.py BUILD_DIR
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

from ytpu_torch.core.update import Update  # noqa: E402
from ytpu_torch.ops import decode_kernel as dk  # noqa: E402
from ytpu_torch.ops import decode_v2 as dv2  # noqa: E402

torch.set_num_threads(1)

B4_LOG = ROOT / "benches" / "data" / "b4_log.pkl.gz"
CASES = ROOT / "ytpu_torch" / "benches" / "data" / "v2_cases.json"
B4_LANES = 1024
EXPORTS = ("ytpu_decode_v2", "ytpu_cuda_error_string", "ytpu_decode_v2_scratch_words")

# mutants of the source, each a (line, replacement, case it must fail): a
# varint window not masked by its region's end; the rest walker's step
# budget ignored; big client ids kept truncated; every cold block taking
# the first sidecar span; Any maps nested past the stack not flagged
MUTANTS = {
    "window_not_masked_by_end": (
        "__device__ __forceinline__ int win(int pos, int end, int k) const { return pos + k < end ? byte(pos + k) : 0; }",
        "__device__ __forceinline__ int win(int pos, int end, int k) const { return byte(pos + k); }",
        "rest_past_span"),
    "walker_budget_ignored": ("for (int t = 0; t < P.T; ++t) {", "for (int t = 0; t < (1 << 16); ++t) {",
                              "overflow"),
    "big_client_not_hashed": ("if (hash_big && ovf) mag = -2 - hash_u64(m64);", "if (false) mag = 0;",
                              "big_clients"),
    "sidecar_rank_ignored": ("P.side[(i64)s * NC2 + clampi(cold_rank, 0, NC2 - 1)]", "P.side[(i64)s * NC2]",
                             "content_kinds"),
    "deep_maps_not_flagged": ("if (deep_bad) deep = true;", "if (false) deep = true;", "nested_any"),
}


def host_source(src: str) -> str:
    """decode_v2.cu with its launch replaced by the emulator's."""
    out, n = re.subn(r"(\w+)<<<([^,]*),\s*([^,]*),\s*([^,]*),\s*\(cudaStream_t\)stream>>>\(",
                     r"EMU_LAUNCH(\2, \3, \4, \1, ", src)
    if n != 1:
        raise RuntimeError(f"decode_v2.cu no longer has the one launch the emulator rewrites: {n}")
    return out


def variant(src: str, name: str) -> str:
    body = src.replace("#include <cuda_runtime.h>\n", "").replace("#include <cstdint>\n", "")
    if name in MUTANTS:
        line, other, _ = MUTANTS[name]
        if body.count(line) != 1:
            raise RuntimeError(f"decode_v2.cu no longer has the line the {name} mutant rewrites")
        body = body.replace(line, other)
    for fn in EXPORTS:
        body, n = re.subn(rf"\b{fn}\(", f"{fn}_{name}(", body)
        if n < 1:
            raise RuntimeError(f"decode_v2.cu does not define {fn}")
    return f"namespace {name} {{\n{body}\n}}  // namespace {name}\n"


def build(build_dir: Path, names) -> subprocess.Popen:
    src = host_source((ROOT / "ytpu_torch" / "csrc" / "decode_v2.cu").read_text())
    text = "#include <cuda_runtime.h>\n#include <cstdint>\n" + "".join(variant(src, name) for name in names)
    cpp = build_dir / f"decode_v2_{names[0]}.cpp"
    cpp.write_text(text)
    return subprocess.Popen(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-Wno-unknown-pragmas",
                             "-I", str(ROOT / "tests" / "cuda_host"), "-o", str(build_dir / f"lib{names[0]}.so"),
                             str(cpp)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def load(build_dir: Path, job: subprocess.Popen, name: str) -> ctypes.CDLL:
    _, err = job.communicate()
    if job.returncode:
        raise RuntimeError(f"g++ failed for {name}: {err[-4000:]}")
    return ctypes.CDLL(str(build_dir / f"lib{name}.so"))


def entry(lib: ctypes.CDLL, name: str):
    """The C entry points of variant `name` under the names
    `decode_v2._launch_decode_v2` calls."""
    out = types.SimpleNamespace()
    for fn in EXPORTS:
        f = getattr(lib, f"{fn}_{name}")
        if fn == "ytpu_cuda_error_string":
            f.restype, f.argtypes = ctypes.c_char_p, [ctypes.c_int]
        else:
            f.restype, f.argtypes = ctypes.c_int, dv2.DECODE_V2_SIGNATURES[fn]
        setattr(out, fn, f)
    out._ytpu_error_string = out.ytpu_cuda_error_string
    return out


def torch_tables(tables: dict) -> dict:
    return {k: tuple(torch.tensor(x, dtype=torch.int32) for x in v) for k, v in tables.items()}


def lane_sets() -> dict:
    """case -> dict(buf, lens, spans, sidecar, U, R, SEC, tables): the
    committed sets (with their tables), the B4 slice as a matrix and as a
    gathered arena, and the big-client set without tables."""
    data = json.loads(CASES.read_text())
    tables = torch_tables(data["tables"])
    sets = {}
    for name, c in data["sets"].items():
        payloads = [bytes.fromhex(p) for p in c["payloads"]]
        buf, lens, spans, side = dv2.pack_updates_v2(payloads)
        sets[name] = dict(buf=torch.from_numpy(buf), lens=torch.from_numpy(lens), spans=torch.from_numpy(spans),
                          sidecar=None if side is None else torch.from_numpy(side), U=c["U"], R=c["R"],
                          SEC=c["SEC"], tables=tables)
    sets["big_clients_no_tables"] = dict(sets["big_clients"], tables={})
    with gzip.open(B4_LOG, "rb") as f:
        b4 = [Update.decode_v1(p).encode_v2() for p in pickle.load(f)["log"][:B4_LANES]]
    buf, lens, spans, side = dv2.pack_updates_v2(b4, pad_to=64)
    sets["b4_slice"] = dict(buf=torch.from_numpy(buf), lens=torch.from_numpy(lens), spans=torch.from_numpy(spans),
                            sidecar=None, U=4, R=4, SEC=4, tables={})
    wire, offs, row_lens, lens, spans, side, width = dv2.pack_updates_v2_raw(b4)
    gathered = dk.gather_raw_lanes(torch.from_numpy(wire), torch.from_numpy(offs), torch.from_numpy(row_lens), width)
    sets["b4_slice_arena"] = dict(buf=gathered.contiguous(), lens=torch.from_numpy(lens),
                                  spans=torch.from_numpy(spans), sidecar=None, U=4, R=4, SEC=4, tables={})
    return sets


def _err(want, got) -> int:
    if tuple(want.shape) != tuple(got.shape):
        raise RuntimeError(f"shape {tuple(got.shape)} against {tuple(want.shape)}")
    return int((got.long() - want.long()).abs().max()) if want.numel() else 0


def run_case(lib, case, plain=None):
    args = (case["buf"], case["lens"], case["spans"], case["U"], case["R"], case["SEC"], case["sidecar"])
    rows_p, dels_p, flags_p = plain if plain is not None else dv2._decode_v2_reference(*args)
    rows_k, dels_k, flags_k = dv2._launch_decode_v2(lib, case["buf"].contiguous(), *args[1:])
    err = _err(flags_p, flags_k)
    for name in rows_p:
        err = max(err, _err(rows_p[name], rows_k[name]))
    for name in dels_p:
        err = max(err, _err(dels_p[name], dels_k[name]))
    sp, fp = dk._resolve_and_pack(dict(rows_p), dict(dels_p), flags_p, **case["tables"])
    sk, fk = dk._resolve_and_pack(dict(rows_k), dict(dels_k), flags_k, **case["tables"])
    resolved = max([_err(fp, fk)] + [_err(a, b) for a, b in zip(sp, sk)])
    return {"max_abs_err": err, "resolved_err": resolved, "lanes": int(case["lens"].shape[0]),
            "flags": int(np.bitwise_or.reduce(fp.numpy())) if fp.numel() else 0,
            "error_lanes": int(((fp & dk.FLAG_ERRORS) != 0).sum())}, (rows_p, dels_p, flags_p)


def main(build_dir: str) -> None:
    build_dir = Path(build_dir)
    jobs = {"kernel": build(build_dir, ("kernel",)), "mutants": build(build_dir, tuple(MUTANTS))}
    sets = lane_sets()
    kernel = entry(load(build_dir, jobs["kernel"], "kernel"), "kernel")
    out, plains = {}, {}
    for name, case in sets.items():
        out[name], plains[name] = run_case(kernel, case)
    lib = load(build_dir, jobs["mutants"], next(iter(MUTANTS)))
    out["mutants"] = {name: run_case(entry(lib, name), sets[case], plains[case])[0]["max_abs_err"]
                      for name, (_, _, case) in MUTANTS.items()}
    print(json.dumps(out))


if __name__ == "__main__":
    os.makedirs(sys.argv[1], exist_ok=True)
    main(sys.argv[1])
