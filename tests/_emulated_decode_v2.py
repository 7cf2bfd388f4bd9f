"""Child process of tests/test_torch_decode_v2_emulated.py: builds
``ytpu_torch/csrc/decode_v2.cu`` for the host through tests/cuda_host (a
CUDA emulator), runs it on the V2 lane sets, each from the ``[S, L]``
matrix and from the arena of `pack_updates_v2_raw` read in place, next to
the plain composition (`gather_raw_lanes` for the arena ->
`decode_v2._decode_v2_reference` -> `_resolve_and_pack` with the set's
tables), runs mutants of the source that each must differ, and prints one
JSON object: case -> {max_abs_err over the 27 UpdateBatch fields and the
flags from the matrix, arena_err the same from the arena, path (where the
program kept its column expansions), lanes, flags (OR over the lanes),
error_lanes}, and ``mutants`` -> mutant -> max abs difference on its case.

The kernel and its mutants are compiled by two g++ calls at once; each
copy of the source sits in a namespace of its own, its headers pasted in
and its C entry points renamed.

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

from ytpu_torch.core.update import Update, merge_updates_v1  # noqa: E402
from ytpu_torch.ops import decode_kernel as dk  # noqa: E402
from ytpu_torch.ops import decode_v2 as dv2  # noqa: E402

torch.set_num_threads(1)

B4_LOG = ROOT / "benches" / "data" / "b4_log.pkl.gz"
CASES = ROOT / "ytpu_torch" / "benches" / "data" / "v2_cases.json"
CSRC = ROOT / "ytpu_torch" / "csrc"
B4_LANES = 1024
# merged B4 prefixes: whole-state lanes of up to ~100 blocks, at a U whose
# expansion words do not fit a CTA's shared memory
MERGED_PREFIXES = (8, 40, 96)
MERGED_U, MERGED_R = 128, 8
EXPORTS = ("ytpu_decode_v2", "ytpu_cuda_error_string", "ytpu_decode_v2_scratch_words", "ytpu_decode_v2_words")
# the intern-table cases of the combined crafted sets (`table_cases`)
TABLE_CASES = ("all", "client_miss", "empty_client_table", "no_hash_table", "hash_miss", "no_key_table",
               "key_miss", "root_miss", "no_primary", "primary_per_lane")

# mutants of the source, each a (line, replacement, case it must fail): a
# varint window not masked by its region's end; the rest walker's step
# budget ignored; big client ids kept truncated; every cold block taking
# the first sidecar span; Any maps nested past the stack not flagged; the
# arena read past a lane's staged extent; an error lane that keeps its
# valid bytes; the key table skipped; a section that starts after its
# block read before the block lengths are summed; the strings' forward
# scan not started over where a wrapped length makes a target fall
MUTANTS = {
    "window_not_masked_by_end": (
        "const i64 m = (i64)(end < rlen ? end : rlen) - p;  // bytes of the window kept",
        "const i64 m = (i64)rlen - p;", "rest_past_span"),
    "walker_budget_ignored": ("for (int t = 0; t < P.T; ++t) {", "for (int t = 0; t < (1 << 16); ++t) {",
                              "overflow"),
    "big_client_not_hashed": ("if (hash_big && ovf) mag = -2 - hash_u64(smag64(lo, hi, nb));", "if (false) mag = 0;",
                              "big_clients"),
    "sidecar_rank_ignored": ("__ldg(P.side + (i64)s * NC2 + clampi(cold_rank, 0, NC2 - 1))",
                             "__ldg(P.side + (i64)s * NC2)", "content_kinds"),
    "deep_maps_not_flagged": ("if (deep_bad) deep = true;", "if (false) deep = true;", "nested_any"),
    "arena_not_masked_by_row_lens": ("ln.rlen = P.rlens != nullptr ? __ldg(P.rlens + s) : L;", "ln.rlen = L;",
                                     "mutated"),
    "error_lane_keeps_rows": ("const bool lane_ok = (flags & FLAG_ERRORS) == 0;", "const bool lane_ok = true;",
                              "mutated"),
    "key_table_skipped": ("o[F_KEY * SU] = (int)resolve_key(P, keyh, fl);", "o[F_KEY * SU] = -1;", "map_keys"),
    "sections_out_of_order_ignored": ("if (nxt < base) mono = false;", "", "sections_out_of_order"),
    "string_scan_not_restarted": ("if (i > 0 && tgt < prev) m = blob_start;", "", "tables_all"),
}


def with_headers(src: str) -> str:
    """The source with each ``#include "x.cuh"`` of ``csrc/`` replaced by
    that header's text, so that a mutant can rewrite the header's lines
    and each variant's namespace holds its own copy."""
    return re.sub(r'#include "(\w+\.cuh)"\n', lambda m: (CSRC / m.group(1)).read_text(), src)


def host_source(src: str) -> str:
    """decode_v2.cu, its headers inlined, with its launch and its dynamic
    shared memory replaced by the emulator's."""
    out, n = re.subn(r"(\w+)<<<([^,]*),\s*([^,]*),\s*([^,]*),\s*\(cudaStream_t\)stream>>>\(",
                     r"EMU_LAUNCH(\2, \3, \4, \1, ", with_headers(src))
    out, n2 = re.subn(r"extern __shared__ __align__\(16\) unsigned char smem\[\];",
                      "unsigned char* smem = emu_dyn_smem();", out)
    if (n, n2) != (1, 1):
        raise RuntimeError(f"decode_v2.cu no longer has the one launch and shared array the emulator rewrites: "
                           f"{n}, {n2}")
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
    src = host_source((CSRC / "decode_v2.cu").read_text())
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


# ---- the lane sets ---------------------------------------------------------------


def torch_tables(tables: dict) -> dict:
    return {k: tuple(torch.tensor(x, dtype=torch.int32) for x in v) for k, v in tables.items()}


def _set(payloads, U: int, R: int, SEC: int, tables: dict, pad_to=None) -> dict:
    """A case: the payloads packed as a matrix and as an arena."""
    buf, lens, spans, side = dv2.pack_updates_v2(payloads, pad_to=pad_to)
    wire, offs, row_lens, alens, aspans, aside, width = dv2.pack_updates_v2_raw(payloads)
    t = torch.from_numpy
    return dict(buf=t(buf), lens=t(lens), spans=t(spans), sidecar=None if side is None else t(side), U=U, R=R,
                SEC=SEC, tables=tables, wire=t(wire), offs=t(offs), row_lens=t(row_lens), alens=t(alens),
                aspans=t(aspans), asidecar=None if aside is None else t(aside), width=width)


def _sorted_table(mapping: dict):
    ks = sorted(mapping)
    return torch.tensor(ks, dtype=torch.int32), torch.tensor([mapping[k] for k in ks], dtype=torch.int32)


def table_cases(case: dict, json_tables: dict) -> dict:
    """name -> tables for TABLE_CASES, from the plain version's
    pre-resolve columns of `case`: every raw id its rows and ranges use
    (ranked from 100), the committed big-client table, every key hash and
    root name (ranked from 1,000) and, as the primary root, the most common
    root name; then each with one entry left out or a table absent, and
    with a primary root a lane (its first root name, else -1)."""
    rows, dels, _ = pre_resolve(case)
    valid = rows["valid"]
    raw = torch.cat([rows[n][valid] for n in dk._ID_COLUMNS] + [dels["client"][dels["valid"]]])
    raw = sorted(set(int(x) for x in raw if x >= 0))
    keys = [int(x) for x in rows["keyh"][valid & (rows["keyh"] >= 0)]]
    roots = [int(x) for x in rows["rooth"][valid & (rows["rooth"] >= 0)]]
    prim = max(set(roots), key=roots.count)
    named = valid & (rows["ptag"] == 1)
    lane_roots = [int(r[m][0]) if m.any() else -1 for r, m in zip(rows["rooth"], named)]
    other_root = next(r for r in sorted(set(roots)) if r != prim and r not in keys)
    ct = {c: 100 + i for i, c in enumerate(raw)}
    kt = {k: 1000 + i for i, k in enumerate(sorted(set(keys) | set(roots)))}
    cht_keys, cht_perm = (x.tolist() for x in json_tables["client_hash_table"])
    cht = dict(zip(cht_keys, cht_perm))
    most = max(raw, key=lambda c: int(sum((rows[n][valid] == c).sum() for n in dk._ID_COLUMNS)))

    def drop(m, k):
        return {a: b for a, b in m.items() if a != k}

    full = dict(client_table=_sorted_table(ct), key_table=_sorted_table(kt), client_hash_table=_sorted_table(cht),
                primary_root_hash=torch.tensor([prim], dtype=torch.int32))
    empty = (torch.zeros(0, dtype=torch.int32), torch.zeros(0, dtype=torch.int32))
    return {
        "all": full,
        "client_miss": dict(full, client_table=_sorted_table(drop(ct, most))),
        "empty_client_table": dict(full, client_table=empty),
        "no_hash_table": dict(full, client_hash_table=None),
        "hash_miss": dict(full, client_hash_table=_sorted_table(drop(cht, cht_keys[0]))),
        "no_key_table": dict(full, key_table=None),
        "key_miss": dict(full, key_table=_sorted_table(drop(kt, keys[0]))),
        "root_miss": dict(full, key_table=_sorted_table(drop(kt, other_root))),
        "no_primary": dict(full, primary_root_hash=None),
        "primary_per_lane": dict(full, primary_root_hash=torch.tensor(lane_roots, dtype=torch.int32)),
    }


def lane_sets() -> dict:
    """case -> `_set`: the committed sets with their tables (the big
    clients also without), the combined sets under each intern-table case,
    a B4 slice as a matrix and from its arena, and merged B4 prefixes past
    the shared-memory budget."""
    data = json.loads(CASES.read_text())
    tables = torch_tables(data["tables"])
    sets, combined = {}, []
    for name, c in data["sets"].items():
        payloads = [bytes.fromhex(p) for p in c["payloads"]]
        sets[name] = _set(payloads, c["U"], c["R"], c["SEC"], tables)
        if name not in ("mutated", "truncated_columns", "zero_spans", "rest_past_span"):
            combined += payloads
            U, R, SEC = c["U"], c["R"], c["SEC"]
    sets["big_clients_no_tables"] = dict(sets["big_clients"], tables={})
    base = _set(combined, U, R, SEC, {})
    for case, t in table_cases(base, tables).items():
        sets[f"tables_{case}"] = dict(base, tables=t)
    with gzip.open(B4_LOG, "rb") as f:
        log = pickle.load(f)["log"]
    b4 = [Update.decode_v1(p).encode_v2() for p in log[:B4_LANES]]
    sets["b4_slice"] = _set(b4, 4, 4, 4, {}, pad_to=64)
    # the slice again, with a raw client table of its clients (identity)
    ranks = dk.identity_rank(256, device="cpu")
    sets["b4_slice_arena"] = dict(sets["b4_slice"], tables=dict(
        client_table=(torch.arange(256, dtype=torch.int32), ranks.to(torch.int32))))
    merged = [Update.decode_v1(merge_updates_v1(log[:n])).encode_v2() for n in MERGED_PREFIXES]
    sets["merged_global"] = _set(merged, MERGED_U, MERGED_R, 4, {})
    return sets


# the plain version's pre-resolve output by its input: each form of a set
# and the table cases of the combined sets share one
_PRE = {}


def pre_resolve(case, arena: bool = False):
    """`_decode_v2_reference` of the case's matrix, or of its arena
    gathered as `decode_updates_v2_raw` gathers it on the CPU."""
    if arena:
        buf = dk.gather_raw_lanes(case["wire"], case["offs"], case["row_lens"], case["width"])
        lens, spans, side = case["alens"], case["aspans"], case["asidecar"]
    else:
        buf, lens, spans, side = case["buf"], case["lens"], case["spans"], case["sidecar"]
    key = (buf.numpy().tobytes(), buf.shape, lens.numpy().tobytes(), spans.numpy().tobytes(),
           None if side is None else side.numpy().tobytes(), case["U"], case["R"], case["SEC"])
    if key not in _PRE:
        _PRE[key] = dv2._decode_v2_reference(buf, lens, spans, case["U"], case["R"], case["SEC"], side)
    return _PRE[key]


def _err(want, got) -> int:
    if tuple(want.shape) != tuple(got.shape):
        raise RuntimeError(f"shape {tuple(got.shape)} against {tuple(want.shape)}")
    return int((got.long() - want.long()).abs().max()) if want.numel() else 0


def _stream_err(want, got) -> int:
    (sw, fw), (sg, fg) = want, got
    return max([_err(fw, fg)] + [_err(a, b) for a, b in zip(sw, sg)])


def run_case(lib, case):
    U, R, SEC, tables = case["U"], case["R"], case["SEC"], case["tables"]
    rows, dels, flags = pre_resolve(case)
    want = dk._resolve_and_pack(dict(rows), dict(dels), flags, **tables)
    got_m, flags_m, path = dv2._launch_decode_v2(lib, case["buf"].contiguous(), case["lens"], case["spans"], U, R, SEC,
                                                 case["sidecar"], **tables)
    rows_a, dels_a, flags_a = pre_resolve(case, arena=True)
    want_a = dk._resolve_and_pack(dict(rows_a), dict(dels_a), flags_a, **tables)
    got_a, flags_ga, path_a = dv2._launch_decode_v2(lib, case["wire"], case["alens"], case["aspans"], U, R, SEC,
                                                    case["asidecar"], case["offs"], case["row_lens"], case["width"],
                                                    **tables)
    fp = want[1]
    return {"max_abs_err": _stream_err(want, (got_m, flags_m)), "arena_err": _stream_err(want_a, (got_a, flags_ga)),
            "path": path if path == path_a else f"{path}/{path_a}", "lanes": int(case["lens"].shape[0]),
            "flags": int(np.bitwise_or.reduce(fp.numpy())) if fp.numel() else 0,
            "error_lanes": int(((fp & dk.FLAG_ERRORS) != 0).sum())}


def main(build_dir: str) -> None:
    build_dir = Path(build_dir)
    jobs = {"kernel": build(build_dir, ("kernel",)), "mutants": build(build_dir, tuple(MUTANTS))}
    sets = lane_sets()
    kernel = entry(load(build_dir, jobs["kernel"], "kernel"), "kernel")
    out = {name: run_case(kernel, case) for name, case in sets.items()}
    lib = load(build_dir, jobs["mutants"], next(iter(MUTANTS)))
    out["mutants"] = {}
    for name, (_, _, case) in MUTANTS.items():
        r = run_case(entry(lib, name), sets[case])
        out["mutants"][name] = max(r["max_abs_err"], r["arena_err"])
    print(json.dumps(out))


if __name__ == "__main__":
    os.makedirs(sys.argv[1], exist_ok=True)
    main(sys.argv[1])
