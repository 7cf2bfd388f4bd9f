"""Child process of tests/test_torch_decode_emulated.py: builds
``ytpu_torch/csrc/decode.cu`` for the host through tests/cuda_host (a CUDA
emulator), runs it on sets of update lanes next to the plain composition
`decode_kernel._decode_plain` (`gather_raw_lanes` for an arena ->
`_decode_loop_reference` -> `_resolve_and_pack`), and runs mutants of the
source on the set that each must fail, then prints one JSON object: case
-> {max_abs_err over the 27 UpdateBatch fields and the flags, lanes, flags
(OR over the lanes), max_steps, T, staged}, and ``mutants`` -> mutant ->
max abs difference on its case.

The kernel and its mutants are compiled by two g++ calls at once (the
kernel alone, the mutants together): each copy of the source sits in a
namespace of its own, with its C entry points renamed.

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
INGEST_STEP = 5

# mutants of the source, each a (line, replacement) pair, and the case
# each must fail: the varint window read past lens (its 16-byte path; the
# matrix's lanes run on past lens); the arena read at the arena's end (the
# window's byte path, which the last lane of an arena takes) not masked by
# lens; a step budget that is ignored; a row or delete overflow that stops
# the lane; an error lane that keeps its valid rows; an empty raw client
# table treated as no table
MUTANTS = {
    "window_not_masked_by_lens": (
        "const i64 m = len - pos;  // bytes of the window below lens",
        "const i64 m = 10;", "lens_cut"),
    "arena_read_not_masked_by_lens": (
        "const u64 byte = pos + k < len ? at(pos + k) : 0;",
        "const u64 byte = at(pos + k);", "lens_cut_arena"),
    "step_budget_ignored": (
        "for (; step < P.T; ++step) {", "for (; step < (1 << 16); ++step) {", "overflow_U1_R1_T12"),
    "overflow_stops_lane": (
        "flags |= FLAG_OVERFLOW;  // the row does not fit: flagged, and the lane parses on",
        "{ flags |= FLAG_OVERFLOW; st = ST_ERR; continue; }", "overflow_U1_R1_T96"),
    "error_lane_keeps_rows": ("if (!lane_ok) {", "if (false) {", "corpus"),
    "empty_client_table_as_absent": ("if (P.ct.n == 0) {", "if (false) {", "tables_empty_client_table"),
}
# a lane that tells a varint window masked by lens from one that is not:
# one block of ContentAny under a named root holding one string value whose
# length varint is ff ff ff ff 8f (-1 after the 32-bit wrap, and a
# continuation bit on its fifth byte). Masked, the window ends at lens
# (nb2 = 6, the value takes 6 bytes and ends at lens: a row); unmasked,
# the ff bytes past lens run the varint on (nb2 = 9, past lens: ERR, no row)
CRAFTED = [(bytes.fromhex("01010100080101610177ffffffff8fffffff"), 15)]
EXPORTS = ("ytpu_decode_v1", "ytpu_cuda_error_string", "ytpu_decode_stage_bytes")
# the table cases of tests/test_torch_update_decode.py, run from the arena
TABLE_CASES = ("all", "client_miss", "empty_client_table", "no_hash_table", "hash_miss", "no_key_table",
               "key_miss", "root_miss", "no_primary")


def host_source(src: str) -> str:
    """decode.cu with its launch and its dynamic shared memory replaced by
    the emulator's."""
    out, n = re.subn(r"(\w+)<<<([^,]*),\s*([^,]*),\s*([^,]*),\s*\(cudaStream_t\)stream>>>\(",
                     r"EMU_LAUNCH(\2, \3, \4, \1, ", src)
    out, n2 = re.subn(r"extern __shared__ __align__\(16\) unsigned char smem\[\];",
                      "unsigned char* smem = emu_dyn_smem();", out)
    if (n, n2) != (1, 1):
        raise RuntimeError(f"decode.cu no longer has the one launch and shared stage the emulator rewrites: {n}, {n2}")
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
        if n < 1:
            raise RuntimeError(f"decode.cu does not define {fn}")
    return f"namespace {name} {{\n{body}\n}}  // namespace {name}\n"


def build(build_dir: Path, names) -> subprocess.Popen:
    """Start one g++ that builds the variants `names` into one library;
    returns the process (its library is ``lib<first name>.so``)."""
    src = host_source((ROOT / "ytpu_torch" / "csrc" / "decode.cu").read_text())
    text = "#include <cuda_runtime.h>\n#include <cstdint>\n" + "".join(variant(src, name) for name in names)
    cpp = build_dir / f"decode_{names[0]}.cpp"
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
    """The C entry points of variant `name`, under the names
    `decode_kernel._launch_decode` calls."""
    out = types.SimpleNamespace()
    for fn in EXPORTS:
        f = getattr(lib, f"{fn}_{name}")
        if fn == "ytpu_cuda_error_string":
            f.restype, f.argtypes = ctypes.c_char_p, [ctypes.c_int]
        else:
            f.restype, f.argtypes = ctypes.c_int, dk.DECODE_SIGNATURES[fn]
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


def mutated_lanes(payloads, rng, n: int) -> list:
    """`n` seeded copies of the payloads, each with one to three bytes
    overwritten by random ones and, one in four, cut short: lanes that go
    deep into the machine before they err, through every state the
    payloads reach."""
    out = []
    for i in range(n):
        p = bytearray(payloads[i % len(payloads)])
        for _ in range(int(rng.integers(1, 4))):
            p[int(rng.integers(0, len(p)))] = int(rng.integers(0, 256))
        if rng.integers(0, 4) == 0:
            p = p[: int(rng.integers(1, len(p) + 1))]
        out.append(bytes(p))
    return out


def _torch_tables(mappings) -> dict:
    """`_case_tables` mappings as the int32 ``(sorted keys, perm)`` tensors
    the ingestor hands the decode."""
    out = {}
    for name, m in zip(("client_table", "key_table", "client_hash_table"), mappings[:3]):
        ks = sorted(m) if m is not None else None
        out[name] = None if m is None else (torch.tensor(ks, dtype=torch.int32),
                                            torch.tensor([m[k] for k in ks], dtype=torch.int32))
    prim = mappings[3]
    out["primary_root_hash"] = None if prim is None else torch.tensor(prim, dtype=torch.int32)
    return out


def ingest_step_call() -> dict:
    """The arguments of the fast lane's decode call at step INGEST_STEP of
    a small CPU `BatchIngestor` over the committed ingest logs (map + XML,
    a 53-bit client's text, the 256-client array): an arena with its
    offsets and every intern table."""
    from ytpu_torch.benches.ingest import load_ingest_logs
    from ytpu_torch.benches.streams import INGEST_EMU_CAPACITY, INGEST_EMU_DOCS, INGEST_EMU_LOGS
    from ytpu_torch.models import ingest

    logs = load_ingest_logs()
    ing = ingest.BatchIngestor(INGEST_EMU_DOCS, INGEST_EMU_CAPACITY, device="cpu")
    real, captured = ingest.decode_updates_v1, {}

    def capture(buf, lens, max_rows, max_dels, **kw):
        captured.update(buf=buf, lens=lens, U=max_rows, R=max_dels, **kw)
        return real(buf, lens, max_rows, max_dels, **kw)

    try:
        for t in range(INGEST_STEP + 1):
            ingest.decode_updates_v1 = capture if t == INGEST_STEP else real
            ing.apply_bytes([logs[name]["log"][t] for name in INGEST_EMU_LOGS])
    finally:
        ingest.decode_updates_v1 = real
    if captured.get("offs") is None:
        raise RuntimeError("the ingest step made no arena decode call")
    return captured


def arena(payloads, lens=None):
    """``(raw, offs, lens, width)``: the payloads concatenated with no
    padding after the last (so its tail reads clamp at the arena's end),
    and the width `pack_updates` gives them."""
    n = np.asarray([len(p) for p in payloads], dtype=np.int64)
    offs = np.zeros(len(payloads), dtype=np.int32)
    offs[1:] = np.cumsum(n[:-1])
    raw = np.frombuffer(b"".join(payloads), dtype=np.uint8).copy()
    lens = n.astype(np.int32) if lens is None else np.asarray(lens, dtype=np.int32)
    width = int(n.max()) + 16
    return torch.from_numpy(raw), torch.from_numpy(offs), torch.from_numpy(lens), width


def matrix(payloads, lens=None):
    buf, plens = dk.pack_updates(payloads)
    lens = plens if lens is None else lens
    return torch.from_numpy(buf), torch.from_numpy(np.asarray(lens)).to(torch.int32)


def lane_sets() -> dict:
    """case -> dict(buf, lens, offs, width, U, R, T, max_sections, tables)."""
    from test_torch_decode import corpus
    from test_torch_update_decode import TABLE_PAYLOADS, _case_tables

    rng = np.random.default_rng(20261018)
    c = corpus()
    b4 = b4_log(B4_LANES)
    plan = plan_replay(b4)
    merged = [merge_updates_v1(b4[:n]) for n in MERGED_PREFIXES]
    mp = plan_replay(merged)
    # lanes whose bytes run on past lens: the full payload in the matrix
    # (and the arena), lens cut short; then CRAFTED, whose lens ends inside
    # an Any value's length varint
    cut_payloads = c + [p for p, _ in CRAFTED]
    cut = np.asarray([len(p) for p in cut_payloads], dtype=np.int32)
    for i, n in enumerate(cut[: len(c)]):
        cut[i] = int(rng.integers(1, max(2, int(n))))
    cut[len(c):] = [n for _, n in CRAFTED]
    payload_sets = {
        "corpus": (c, 4, 4, 96, None, None),
        "b4_slice": (b4, plan.max_rows, plan.max_dels, plan.max_steps, plan.max_sections, None),
        "overflow_U1_R1_T12": (c[:8], 1, 1, 12, None, None),
        "sections_U4_R4_T96_sec0": (c[:8], 4, 4, 96, 0, None),
        "overflow_U1_R1_T96": (c, 1, 1, 96, None, None),
        "truncated": ([p[:k] for p in c for k in sorted({1, len(p) // 3, len(p) // 2, len(p) - 1}) if k > 0],
                      4, 4, 96, None, None),
        "garbage": (garbage_lanes(rng), 4, 4, 96, None, None),
        "mutated": (mutated_lanes(c, rng, 1536), 4, 4, 96, None, None),
        "lens_cut": (cut_payloads, 4, 4, 96, None, cut),
        "merged": (merged, mp.max_rows, mp.max_dels, mp.max_steps, mp.max_sections, None),
        # rows past the shared-memory stage: stored straight, error lanes too
        "corpus_unstaged_U24": (c, 24, 4, 96, None, None),
    }
    sets = {}
    for name, (payloads, U, R, T, sec, lens) in payload_sets.items():
        dims = dict(U=U, R=R, T=T, max_sections=sec, tables={})
        buf, mlens = matrix(payloads, lens)
        sets[name] = dict(buf=buf, lens=mlens, offs=None, width=None, **dims)
        raw, offs, alens, width = arena(payloads, lens)
        sets[f"{name}_arena"] = dict(buf=raw, lens=alens, offs=offs, width=width, **dims)
    # the intern tables, from the arena
    raw, offs, alens, width = arena(TABLE_PAYLOADS)
    for case in TABLE_CASES:
        sets[f"tables_{case}"] = dict(buf=raw, lens=alens, offs=offs, width=width, U=8, R=4, T=160,
                                      max_sections=4, tables=_torch_tables(_case_tables(case)))
    call = ingest_step_call()
    sets["ingest_step"] = dict(
        buf=call["buf"], lens=call["lens"], offs=call["offs"], width=call["width"], U=call["U"], R=call["R"],
        T=call.get("n_steps") or dk.default_steps(call["U"], call["R"]), max_sections=call.get("max_sections"),
        tables={k: call.get(k) for k in ("client_table", "key_table", "client_hash_table", "primary_root_hash")})
    return sets


# the plain loop's pre-resolve output by its input: the arena and matrix
# forms of a set, and the table cases of one corpus, share one loop
_LOOPS = {}


def plain(case):
    """`decode_kernel._decode_plain` of the case: the gather for an arena,
    the plain loop, then the tables."""
    U, R, T = case["U"], case["R"], case["T"]
    sec = case["max_sections"]
    max_sec = sec if sec is not None else U + 1
    buf, lens, offs = case["buf"], case["lens"], case["offs"]
    mat = buf if offs is None else dk.gather_raw_lanes(buf, offs, lens, case["width"])
    key = (mat.numpy().tobytes(), lens.to(torch.int64).numpy().tobytes(), U, R, T, max_sec)
    if key not in _LOOPS:
        _LOOPS[key] = dk._decode_loop_reference(mat, lens, U, R, T, max_sec)
    rows, dels, flags = _LOOPS[key]
    return dk._resolve_and_pack(dict(rows), dict(dels), flags, **case["tables"])


def run_case(lib, case):
    U, R, T = case["U"], case["R"], case["T"]
    sec = case["max_sections"]
    max_sec = sec if sec is not None else U + 1
    buf, lens, offs, width, tables = case["buf"], case["lens"], case["offs"], case["width"], case["tables"]
    stream_p, flags_p = plain(case)
    L = buf.shape[1] if offs is None else width
    stream_k, flags_k, steps = dk._launch_decode(lib, buf.contiguous(), offs, lens, L, U, R, T, max_sec,
                                                 **tables, steps=True)
    err = int((flags_k.long() - flags_p.long()).abs().max()) if flags_p.numel() else 0
    for name, want, got in zip(stream_p._fields, stream_p, stream_k):
        if tuple(want.shape) != tuple(got.shape):
            raise RuntimeError(f"{name}: shape {tuple(got.shape)} against {tuple(want.shape)}")
        if want.numel():
            err = max(err, int((got.long() - want.long()).abs().max()))
    return {"max_abs_err": err, "lanes": int(lens.shape[0]),
            "flags": int(np.bitwise_or.reduce(flags_p.numpy())) if flags_p.numel() else 0,
            "max_steps": int(steps.max()) if steps.numel() else 0, "T": T,
            "staged": bool(lib.ytpu_decode_stage_bytes(U, R))}


def main(build_dir: str) -> None:
    # the kernel and the mutants build in two g++ at once; the mutants'
    # finishes while the kernel runs the sets
    build_dir = Path(build_dir)
    jobs = {"kernel": build(build_dir, ("kernel",)), "mutants": build(build_dir, tuple(MUTANTS))}
    sets = lane_sets()
    kernel = entry(load(build_dir, jobs["kernel"], "kernel"), "kernel")
    out = {name: run_case(kernel, case) for name, case in sets.items()}
    lib = load(build_dir, jobs["mutants"], next(iter(MUTANTS)))
    out["mutants"] = {name: run_case(entry(lib, name), sets[case])["max_abs_err"]
                      for name, (_, _, case) in MUTANTS.items()}
    print(json.dumps(out))


if __name__ == "__main__":
    os.makedirs(sys.argv[1], exist_ok=True)
    main(sys.argv[1])
