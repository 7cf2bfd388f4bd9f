"""Child process of tests/test_torch_integrate_emulated.py: builds
``ytpu_torch/csrc/integrate.cu`` for the host through tests/cuda_host (a
CUDA emulator), runs its stream entry on seeded streams next to
`integrate_stream_reference` and its per-doc entry on per-doc streams
next to `integrate_batch_reference` (among them the rows a
`BatchIngestor` emits from wire bytes, `benches.streams.ingest_steps`),
and four mutants of the source on the per-doc cases (each doc reading its
neighbour's rows; the stamps cleared only below the doc's first slot
count; the tables cleared as if sized from that count alone, on the edge
case; a root-anchor lookup that ignores the anchor's key, on the ingest
rows), and prints one JSON object, case -> max abs difference over all
planes and meta words.

Before every launch the scratch is poisoned as the card may hand it over:
the table entries of every key the launch can touch, at the key's hash
position under every table size, hold that key with a wrong payload, and
every stamp holds an epoch the launch uses. A kernel that reads a word it
did not clear reads poison.

Usage: python tests/_emulated_integrate.py BUILD_DIR
"""

import ctypes
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from ytpu_torch.benches.streams import (  # noqa: E402
    EDGE_CAPACITY, EDGE_DOCS, anchored_state, batch_edge_steps, ingest_steps, synthetic_stream,
    typing_stream,
)
from ytpu_torch.models.batch_doc import init_state  # noqa: E402
from ytpu_torch.ops import integrate_kernel as ik  # noqa: E402

torch.set_num_threads(1)


def host_source(src: str) -> str:
    """integrate.cu with its inline-PTX helpers, its dynamic shared memory
    and its launches replaced by the emulator's."""
    out, n1 = re.subn(r"// ---- mbarriers and the TMA bulk copy.*?(?=// the producer's copy of tile t)", "",
                      src, flags=re.S)
    out, n2 = re.subn(r"(\w+)<<<([^,]*),\s*([^,]*),\s*([^,]*),\s*\(cudaStream_t\)stream>>>\(",
                      r"EMU_LAUNCH(\2, \3, \4, \1, ", out)
    out, n3 = re.subn(r"extern __shared__ __align__\(128\) unsigned char smem\[\];",
                      "unsigned char* smem = emu_dyn_smem();", out)
    out, n4 = re.subn(r'asm volatile\("fence\.mbarrier_init\.release\.cluster;\\n" ::: "memory"\);', "", out)
    if (n1, n2, n3, n4) != (1, 2, 1, 1):
        raise RuntimeError(f"integrate.cu no longer has the shape the emulator rewrites: {(n1, n2, n3, n4)}")
    return out


# mutants of the source, each a (line, replacement) pair, that the batch
# cases must tell from the kernel: every doc reads its neighbour's block;
# phase 1 clears the stamps only below the doc's slot count nb0; it clears
# the tables as if they were sized from nb0 alone (probes keep the bound's
# sizes). In a mutant a delete range walks at most C blocks, so that an
# index that lies fails the comparison instead of walking forever.
MUTANTS = {
    "neighbour_rows": (
        "integrate_step(d, rows + doc * U * ROW_W, dels + doc * R * DEL_W, U, R);",
        "integrate_step(d, rows + (doc ^ 1) * U * ROW_W, dels + (doc ^ 1) * R * DEL_W, U, R);"),
    "stamps_to_nb0": ("cstamp + doc * C, t, n,", "cstamp + doc * C, t, nb0,"),
    "tables_cleared_for_nb0": ("cstamp + doc * C, t, n,", "cstamp + doc * C, tables_for(nb0, HB, HS), n,"),
    "anchor_ignores_key": (
        "return ld(d, KD, s) == BLOCK_ROOT_ANCHOR && ld(d, KEY, s) == r_proot;",
        "return ld(d, KD, s) == BLOCK_ROOT_ANCHOR;"),
}


# the batch case each mutant runs
MUTANT_CASE = "batch_edges_D4"
MUTANT_CASES = {"anchor_ignores_key": "batch_ingest_rows_D4"}
INGEST_CASE = "batch_ingest_rows_D4"
# steps of the ingest case: the map + XML docs anchor their second root at step 5
INGEST_STEPS = 12
WALK = "  while (x < end) {"
GUARDED_WALK = "  for (int walked = 0; x < end && walked <= d.C; ++walked) {"


def build(build_dir: Path, mutant: str = "") -> Path:
    text = host_source((ROOT / "ytpu_torch" / "csrc" / "integrate.cu").read_text())
    if mutant:
        line, other = MUTANTS[mutant]
        if text.count(line) != 1 or text.count(WALK) != 1:
            raise RuntimeError(f"integrate.cu no longer has the line the {mutant} mutant rewrites")
        text = text.replace(line, other).replace(WALK, GUARDED_WALK)
    tag = f"_{mutant}" if mutant else ""
    src = build_dir / f"integrate_host{tag}.cpp"
    src.write_text(text)
    lib = build_dir / f"libintegrate_host{tag}.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-Wno-unknown-pragmas",
                    "-I", str(ROOT / "tests" / "cuda_host"), "-o", str(lib), str(src)],
                   check=True, capture_output=True, text=True)
    return lib


def load(build_dir: Path, mutant: str = "") -> ctypes.CDLL:
    """The host build of the kernel source (or of a mutant of it) with its
    C signatures declared."""
    lib = ctypes.CDLL(str(build(build_dir, mutant)))
    for fn, args in ik.INTEGRATE_SIGNATURES.items():
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = args
    return lib


# ---- poisoned scratch ----------------------------------------------------------

M64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def hmix(k: np.ndarray) -> np.ndarray:
    """The kernel's hash of a table key (``hmix``), as uint64."""
    k = k.astype(np.uint64)
    with np.errstate(over="ignore"):
        k ^= k >> np.uint64(33)
        k = (k * np.uint64(0xFF51AFD7ED558CCD)) & M64
        k ^= k >> np.uint64(33)
        k = (k * np.uint64(0xC4CEB9FE1A85EC53)) & M64
        k ^= k >> np.uint64(33)
    return k & np.uint64(0xFFFFFFFF)


def doc_keys(cols, meta, rows, dels, d):
    """The start-map and bitmap keys a launch can touch in doc d: every
    (client, clock) of its live slots, of its rows (each clock of their
    span and their origins) and of its delete ranges' ends."""
    nb = int(meta[d, ik.M_NBLOCKS])
    pairs = set()
    for c, k, n in zip(*(cols[p, d, :nb].tolist() for p in (ik.CL, ik.CK, ik.LN))):
        pairs.update((c, k + i) for i in range(max(n, 1)))
    for r in rows.reshape(-1, 23).tolist():
        pairs.update((r[0], r[1] + i) for i in range(r[2] + 1))
        pairs.update({(r[3], r[4]), (r[3], r[4] + 1), (r[5], r[6])})
    for c, a, b, _ in dels.reshape(-1, 4).tolist():
        pairs.update({(c, a), (c, b)})
    pairs = np.array(sorted((c, k) for c, k in pairs if c >= 0 and k >= 0), dtype=np.uint64).reshape(-1, 2)
    starts = (pairs[:, 0] << np.uint64(32)) | pairs[:, 1]
    levels = [(pairs[:, 0] << np.uint64(32)) | (np.uint64(lv) << np.uint64(28))
              | (pairs[:, 1] >> np.uint64(6 * (lv + 1))) for lv in range(5)]
    return np.unique(starts), np.unique(np.concatenate(levels))


def poison_table(tab: np.ndarray, keys: np.ndarray, payload, rng):
    """Each key, with a wrong payload (``payload(n, rng)``), at its hash
    position under every table size up to the table's (a power of two); at
    most an eighth of each size's entries, so that every probe still meets
    an EMPTY."""
    m = 1
    while m <= tab.shape[0]:
        pick = rng.permutation(keys)[: m // 8]
        pos = (hmix(pick) & np.uint64(m - 1)).astype(np.int64)
        tab[pos, 0] = pick.view(np.int64)
        tab[pos, 1] = payload(len(pick), rng)
        m *= 2


def poisoned_scratch(cols, meta, rows_of_doc, seed):
    """The kernel's scratch for `cols`, poisoned (see the module doc):
    start-map entries name small slots, bitmap entries hold random words,
    and launch `seed` finds every row stamp at 1 + seed % 4 and every
    conflict stamp two above it, epochs of the launch's first scans;
    ``rows_of_doc(d)`` gives doc d's rows and deletes of the launch."""
    _, D, C = cols.shape
    hb, hs = ik.scratch_entries(C)
    rng = np.random.default_rng(seed)
    bidx = np.full((D, hb, 2), -1, dtype=np.int64)
    sidx = np.full((D, hs, 2), -1, dtype=np.int64)
    for d in range(D):
        starts, levels = doc_keys(cols, meta, *rows_of_doc(d), d)
        poison_table(sidx[d], starts, lambda n, r: r.integers(0, 8, size=n), rng)
        poison_table(bidx[d], levels, lambda n, r: r.integers(0, 1 << 62, size=n), rng)
    epoch = 1 + seed % 4
    stamps = [torch.full((D, C), e, dtype=torch.int32) for e in (epoch, epoch + 2)]
    return torch.from_numpy(bidx), hb, torch.from_numpy(sidx), hs, *stamps


def aligned(t: torch.Tensor) -> torch.Tensor:
    """A copy of `t` that starts 16-byte aligned, as the bulk copies need."""
    buf = torch.empty(t.numel() + 4, dtype=t.dtype)
    off = (-(buf.data_ptr() // 4)) % 4
    out = buf[off : off + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def launch(lib, cols, meta, rows, dels, rank, scan_plan, seed=0):
    _, D, C = cols.shape
    S, U = rows.shape[:2]
    R, K = dels.shape[1], rank.shape[0]
    bidx, hb, sidx, hs, bstamp, cstamp = poisoned_scratch(cols, meta, lambda d: (rows, dels), seed)
    rows, dels = aligned(rows), aligned(dels)
    err = lib.ytpu_integrate_stream(
        cols.data_ptr(), meta.data_ptr(), rows.data_ptr(), dels.data_ptr(), rank.data_ptr(),
        S, U, R, K, D, C, scan_plan[0], scan_plan[1],
        bidx.data_ptr(), hb, sidx.data_ptr(), hs, bstamp.data_ptr(), cstamp.data_ptr(), None, None,
    )
    if err:
        raise RuntimeError(f"emulated launch returned {err}")


def launch_batch(lib, cols, meta, rows, dels, rank, scan_plan, seed=0):
    """One launch of the per-doc entry: rows [D, U, 23], dels [D, R, 4]."""
    _, D, C = cols.shape
    bidx, hb, sidx, hs, bstamp, cstamp = poisoned_scratch(
        cols, meta, lambda d: (rows[d].numpy(), dels[d].numpy()), seed)
    words = ik.batch_launch_plan(D, C, lib)["doc_words"]
    doc_words = torch.from_numpy(np.random.default_rng(seed).integers(-5, 1 << 20, size=(D, words), dtype=np.int32))
    err = lib.ytpu_integrate_batch(
        cols.data_ptr(), meta.data_ptr(), rows.data_ptr(), dels.data_ptr(), rank.data_ptr(),
        rows.shape[1], dels.shape[1], rank.shape[0], D, C, scan_plan[0], scan_plan[1],
        bidx.data_ptr(), hb, sidx.data_ptr(), hs, bstamp.data_ptr(), cstamp.data_ptr(),
        doc_words.data_ptr(), None, 0, None,
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
    cols, meta = ik.pack_state(init_state(EDGE_DOCS, EDGE_CAPACITY, "cpu"))
    yield ("batch_edges_D4", cols, meta, *batch_edge_steps(), rank, (32, 8))


def run_batch_case(lib, cols, meta, rows, dels, rank, plan):
    """Every step through the per-doc entry and through
    `integrate_batch_reference`, each from the plain version's state (so
    that one wrong launch does not hide the next); the largest difference
    over all planes and meta words after any step, the fewest and most
    slots a doc held when a launch started, and the most slots short of C
    a launch started at where its bound reached C."""
    rows, dels = torch.as_tensor(rows), torch.as_tensor(dels)
    cp, mp = cols.clone(), meta.clone()
    C = cols.shape[2]
    err, nb0s, capped = 0, [], 0
    for t in range(rows.shape[0]):
        ck, mk = cp.clone(), mp.clone()
        nb0 = mp[:, ik.M_NBLOCKS].tolist()
        nb0s += nb0
        U, R = rows.shape[2], dels.shape[2]
        capped = max([capped] + [C - n for n in nb0 if n < C <= n + 5 * U + 2 * R])
        launch_batch(lib, ck, mk, rows[t].contiguous(), dels[t].contiguous(), rank, plan, seed=t)
        ik.integrate_batch_reference(cp, mp, rows[t], dels[t], rank, plan)
        err = max(err, int((ck.long() - cp.long()).abs().max()), int((mk.long() - mp.long()).abs().max()))
    return {"max_abs_err": err, "blocks": int(mp[:, ik.M_NBLOCKS].min()), "error": int(mp[:, ik.M_ERROR].max()),
            "first_slots_min": min(nb0s), "first_slots_max": max(nb0s), "capped_below_C": capped}


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


def run_captured_steps(lib, steps, plan=(32, 8)):
    """Each captured step ``(cols, meta, rows, dels, rank)`` of a run of the
    plain version through the per-doc entry and through
    `integrate_batch_reference`, both from the captured state; the largest
    difference over all planes and meta words, and what the steps held."""
    err, anchors, proot_rows, map_rows = 0, 0, 0, 0
    for t, (cols, meta, rows, dels, rank) in enumerate(steps):
        ck, mk = cols.clone(), meta.clone()
        cp, mp = cols.clone(), meta.clone()
        launch_batch(lib, ck, mk, rows.contiguous(), dels.contiguous(), rank, plan, seed=t)
        ik.integrate_batch_reference(cp, mp, rows, dels, rank, plan)
        err = max(err, int((ck.long() - cp.long()).abs().max()), int((mk.long() - mp.long()).abs().max()))
        proot_rows += int(((rows[..., 22] >= 0) & (rows[..., 14] == 1)).sum())
        map_rows += int(((rows[..., 10] >= 0) & (rows[..., 14] == 1)).sum())
    live = torch.arange(cp.shape[2])[None, :] < mp[:, ik.M_NBLOCKS][:, None]
    anchors = int(((cp[ik.KD] == 12) & live).sum())
    return {"max_abs_err": err, "steps": len(steps), "blocks": int(mp[:, ik.M_NBLOCKS].min()),
            "error": int(mp[:, ik.M_ERROR].max()), "anchors": anchors, "proot_rows": proot_rows,
            "map_rows": map_rows}


def main() -> int:
    build_dir = Path(sys.argv[1])
    with ThreadPoolExecutor(len(MUTANTS) + 1) as pool:
        libs = dict(zip(["", *MUTANTS], pool.map(lambda m: load(build_dir, m), ["", *MUTANTS])))
    lib = libs[""]
    out = {}
    for case in batch_cases():
        out[case[0]] = run_batch_case(lib, *case[1:])
        for m in MUTANTS:
            if MUTANT_CASES.get(m, MUTANT_CASE) == case[0]:
                out[f"batch_{m}_mutant"] = run_batch_case(libs[m], *case[1:])
    steps = ingest_steps(INGEST_STEPS)
    out[INGEST_CASE] = run_captured_steps(lib, steps)
    for m in MUTANTS:
        if MUTANT_CASES.get(m) == INGEST_CASE:
            out[f"batch_{m}_mutant"] = run_captured_steps(libs[m], steps)
    for i, (name, cols, meta, rows, dels, rank, plan) in enumerate(cases()):
        rows, dels = torch.as_tensor(rows), torch.as_tensor(dels)
        ck, mk = cols.clone(), meta.clone()
        cp, mp = cols.clone(), meta.clone()
        launch(lib, ck, mk, rows, dels, rank, plan, seed=i)
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
