"""What the port's CUDA integrate kernel rests on, checked on the CPU.

The kernel (``ytpu_torch/csrc/integrate.cu``) runs only on the card, where
`chip_smoke.py` holds it against `integrate_stream_reference`. Two things it
relies on are plain arithmetic or plain-version facts, and are held here:

* its cursor cache answers `find_slot` for ``x >= 0`` from the last blocks
  found or created, which is exact only because at most one block of a
  client covers a clock: a property of every state the plain version
  produces, through storms, splits, deletes, capacity overflow and a
  compaction;
* the launch plan (docs per CTA, CTAs, the stream tile and its ragged
  last tile, shared memory, scratch) keeps the bulk copies' 16-byte rules
  and the ring's shared-memory budget. The kernel library plans its own
  launch; here its source is built for the host with g++ (as
  tests/test_torch_integrate_emulated.py builds it) and asked through the
  wrapper's `launch_plan`.
"""

import shutil

import numpy as np
import pytest
import torch

from _emulated_integrate import load as load_host_build
from ytpu_torch.benches.streams import anchored_state, synthetic_stream, typing_stream
from ytpu_torch.models.batch_doc import init_state
from ytpu_torch.ops import integrate_kernel as ik
from ytpu_torch.ops.compaction import compact_packed

torch.set_num_threads(1)


# --- the cursor cache's premise ------------------------------------------------------


def covering_blocks(cols, meta, d):
    """{client: [(start, end, slot), ...]} of doc d's live blocks of
    positive length, sorted by start."""
    nb = int(meta[d, ik.M_NBLOCKS])
    cl, ck, ln = (cols[p, d, :nb].tolist() for p in (ik.CL, ik.CK, ik.LN))
    out = {}
    for s in range(nb):
        if ln[s] > 0:
            out.setdefault(cl[s], []).append((ck[s], ck[s] + ln[s], s))
    for blocks in out.values():
        blocks.sort()
    return out


def find_slot(cols, meta, d, c, x):
    """The plain version's find_slot: the smallest live slot of client c
    whose [CK, CK + LN) holds x, -1 if none."""
    nb = int(meta[d, ik.M_NBLOCKS])
    m = (cols[ik.CL, d, :nb] == c) & (cols[ik.CK, d, :nb] <= x) & (x < cols[ik.CK, d, :nb] + cols[ik.LN, d, :nb])
    hits = torch.nonzero(m).flatten()
    return int(hits[0]) if len(hits) else -1


def assert_one_cover(cols, meta):
    """For x >= 0 at most one block of a client covers x, and it is the
    slot find_slot returns; checked at every block's first and last clock
    and one past its end."""
    for d in range(cols.shape[1]):
        for c, blocks in covering_blocks(cols, meta, d).items():
            for (s0, e0, _), (s1, _, _) in zip(blocks, blocks[1:]):
                if e0 > 0:
                    assert e0 <= max(s1, 0), f"doc {d} client {c}: [{s0}, {e0}) overlaps a block at {s1}"
            for start, end, slot in blocks:
                for x in {start, end - 1, end}:
                    if x < 0:
                        continue
                    owners = [s for a, b, s in blocks if a <= x < b]
                    assert len(owners) <= 1
                    assert find_slot(cols, meta, d, c, x) == (owners[0] if owners else -1)


def run(cols, meta, rows, dels, rank):
    ik.integrate_stream_reference(cols, meta, torch.from_numpy(rows), torch.from_numpy(dels), rank)
    return cols, meta


RANK = torch.from_numpy(np.random.default_rng(11).permutation(256).astype(np.int32))


@pytest.mark.parametrize("seed", [3, 40_961])
@pytest.mark.parametrize("capacity", [24, 160])
def test_one_block_covers_a_clock_in_synthetic_streams(capacity, seed):
    """Storms, gaps, duplicates, map, nested and move rows and deletes, at a
    capacity that overflows (24) or not, then a compaction and more rows."""
    cols, meta = anchored_state(2, capacity, "cpu")
    rows, dels = synthetic_stream(seed, 16)
    run(cols, meta, rows, dels, RANK)
    if capacity == 24:
        assert int(meta[:, ik.M_ERROR].max()) & ik.ERR_CAPACITY
    assert_one_cover(cols, meta)
    cols, meta = compact_packed(cols, meta)
    assert_one_cover(cols, meta)
    rows, dels = synthetic_stream(seed + 1, 8)
    run(cols, meta, rows, dels, RANK)
    assert_one_cover(cols, meta)


@pytest.mark.parametrize("seed", [8, 27_183])
@pytest.mark.parametrize("first_client", [1, 1500])
def test_one_block_covers_a_clock_while_typing(seed, first_client):
    """Eight clients typing and deleting at random positions: every insert
    inside a run and every delete splits a block."""
    cols, meta = ik.pack_state(init_state(1, 256, "cpu"))
    rows, dels = typing_stream(seed, 40, first_client=first_client)
    rank = torch.arange(2048, dtype=torch.int32)
    run(cols, meta, rows, dels, rank)
    assert int(meta[0, ik.M_ERROR]) == 0 and int(meta[0, ik.M_NBLOCKS]) > 40
    assert_one_cover(cols, meta)


def test_typing_stream_is_the_editor_it_models():
    """typing_stream's own model of the text is what the plain version
    integrates: the doc order of the clocks equals the visible walk of a
    stream with the deletes dropped."""
    rows, dels = typing_stream(5, 30)
    dels[:] = 0
    cols, meta = ik.pack_state(init_state(1, 256, "cpu"))
    run(cols, meta, rows, dels, RANK)
    order, o = [], int(meta[0, ik.M_START])
    while o >= 0:
        c, k, n = (int(cols[p, 0, o]) for p in (ik.CL, ik.CK, ik.LN))
        order += [(c, k + i) for i in range(n)]
        o = int(cols[ik.RT, 0, o])
    assert int(meta[0, ik.M_ERROR]) == 0
    # the editor's text: each insert right after its origin, or first
    model = []
    for c, k, n, oc, ok in rows[:, 0, :5].tolist():
        at = model.index((oc, ok)) + 1 if oc >= 0 else 0
        model[at:at] = [(c, k + i) for i in range(n)]
    assert order == model


# --- the launch plan ------------------------------------------------------------------


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    return load_host_build(tmp_path_factory.mktemp("integrate_plan"))


def test_launch_refuses_a_misaligned_stream(host_lib):
    """The bulk copies need 16-byte-aligned sources: the kernel's entry
    point refuses a ``rows`` pointer 4 bytes past a boundary before it
    launches (cudaErrorMisalignedAddress)."""
    D, C = 1, 64
    hb, hs = ik.scratch_entries(C)
    buf = torch.zeros(23 * 4 + 8, dtype=torch.int32)
    rows_at = buf.data_ptr() + (-buf.data_ptr()) % 16 + 4
    dels = torch.zeros(16, dtype=torch.int32)
    tabs = [torch.zeros(n, dtype=torch.int64) for n in (2 * hb, 2 * hs)]
    err = host_lib.ytpu_integrate_stream(
        0, 0, rows_at, dels.data_ptr() + (-dels.data_ptr()) % 16, 0, 4, 1, 1, 256, D, C, 32, 8,
        tabs[0].data_ptr() + (-tabs[0].data_ptr()) % 16, hb,
        tabs[1].data_ptr() + (-tabs[1].data_ptr()) % 16, hs, 0, 0, None, None)
    assert err == 716  # cudaErrorMisalignedAddress


def test_main_path_plan(host_lib):
    """One B4 chunk into the flagship envelope: 128 CTAs (one wave on 132
    SMs), 32 tiles of 256 steps, 63,616 bytes of shared memory."""
    p = ik.launch_plan(8192, 1, 1, 256, 65536, host_lib)
    assert (p["docs_per_cta"], p["ctas"], p["threads"], p["ring_stages"]) == (2, 128, 96, 2)
    assert (p["tile_steps"], p["tiles"], p["last_tile_steps"], p["last_tile_ragged_words"]) == (256, 32, 256, 0)
    assert p["smem_bytes"] == 128 + 2 * 1024 * 4 + 2 * 256 * (23 + 4) * 4 == 63616
    assert (p["index_ctas"], p["index_threads"], p["doc_words"]) == (0, 0, 0)
    assert (p["bitmap_entries"], p["start_map_entries"]) == (1 << 19, 1 << 17)
    assert p["scratch_bytes_per_doc"] == 16 * (1 << 19) + 16 * (1 << 17) + 8 * 65536


@pytest.mark.parametrize(
    "S,U,R,D,C",
    [(1001, 1, 1, 5, 8192), (48, 4, 2, 8, 256), (331, 4, 2, 3, 144), (1, 1, 1, 1, 1),
     (6, 4, 2, 5, 256), (8192, 3, 2, 256, 1 << 17), (7, 40, 9, 2, 64), (0, 1, 1, 4, 64)],
)
def test_launch_plan_rules(host_lib, S, U, R, D, C):
    p = ik.launch_plan(S, U, R, D, C, host_lib)
    T = p["tile_steps"]
    step_bytes = 4 * (23 * U + 4 * R)
    assert p["ctas"] == -(-D // 2) and p["ctas"] * 2 - D in (0, 1)
    # a tile is a multiple of 4 steps, at least 4, at most 256, and the
    # ring fits 64 KiB unless the tile is the smallest
    assert T % 4 == 0 and 4 <= T <= 256
    assert T == 4 or p["ring_stages"] * T * step_bytes <= 64 * 1024
    assert p["smem_bytes"] <= 232448
    # tiles cover the stream; every tile starts 16-byte aligned
    assert p["tiles"] * T >= S > (p["tiles"] - 1) * T or S == p["tiles"] == 0
    for t in range(p["tiles"]):
        assert (t * T * U * 23 * 4) % 16 == 0 and (t * T * R * 4 * 4) % 16 == 0
    # the bulk copy of the last tile moves a multiple of 16 bytes; the
    # ragged words are the rest
    last_bytes = p["last_tile_steps"] * U * 23 * 4
    assert (last_bytes - 4 * p["last_tile_ragged_words"]) % 16 == 0
    assert 0 <= p["last_tile_ragged_words"] <= 3
    # the tables hold every start's five level words and every start at a
    # load of at most 5/8 and 1/2
    assert p["bitmap_entries"] >= 8 * C and p["start_map_entries"] >= 2 * C
    assert p["bitmap_entries"] & (p["bitmap_entries"] - 1) == 0
    assert p["start_map_entries"] & (p["start_map_entries"] - 1) == 0


def test_ragged_tile_of_the_chip_case(host_lib):
    """chip_smoke's typing case: 1,001 steps wrap the two-stage ring twice
    and end on a tile whose rows end 12 bytes past a 16-byte boundary."""
    p = ik.launch_plan(1001, 1, 1, 5, 8192, host_lib)
    assert (p["ctas"], p["tile_steps"], p["tiles"], p["last_tile_steps"]) == (3, 256, 4, 233)
    assert p["last_tile_ragged_words"] == 3
    assert p["tiles"] > 2 * p["ring_stages"] - 1


def test_batch_plan_of_the_write_path(host_lib):
    """The per-doc entry at BASELINE config 2's width: the index kernel,
    one CTA of 128 threads a doc, handing 1,024 client clocks and the slot
    bound a doc to the integrate kernel; that one takes one step, no ring,
    so its shared memory is the barriers and the client-clock tables."""
    p = ik.batch_launch_plan(1024, 8192, host_lib)
    assert (p["index_ctas"], p["index_threads"], p["doc_words"]) == (1024, 128, 1025)
    assert (p["docs_per_cta"], p["ctas"], p["threads"], p["ring_stages"]) == (2, 512, 96, 0)
    assert (p["tile_steps"], p["tiles"], p["last_tile_steps"], p["last_tile_ragged_words"]) == (1, 1, 1, 0)
    assert p["smem_bytes"] == 128 + 2 * 1024 * 4 == 8320
    assert ik.batch_launch_plan(5, 64, host_lib)["ctas"] == 3


@pytest.mark.parametrize("U", [400, 2000])
def test_a_plan_past_the_shared_memory_limit_is_refused(host_lib, U):
    """A stream step of ``U`` rows leaves the ring its smallest tile, whose
    two stages still take more than the 227 KB a block may have: the entry
    refuses the launch (cudaErrorInvalidValue) instead of clamping it."""
    D, C = 2, 64
    assert ik.launch_plan(8, U, 1, D, C, host_lib)["smem_bytes"] > 232448
    hb, hs = ik.scratch_entries(C)
    err = host_lib.ytpu_integrate_stream(0, 0, 0, 0, 0, 8, U, 1, 256, D, C, 32, 8,
                                         0, hb, 0, hs, 0, 0, None, None)
    assert err == 1


@pytest.mark.parametrize(
    "nb0,moves,S,U,R,C,bound",
    [(1305, 0, 1, 1, 1, 8192, 1312), (0, 0, 1, 1, 1, 8192, 7), (100, 10, 1, 4, 2, 256, 144),
     (8190, 0, 1, 1, 1, 8192, 8192), (17658, 0, 8192, 1, 1, 65536, 65536), (40, 3, 2, 4, 2, 64, 64)],
)
def test_scratch_follows_the_live_rows(host_lib, nb0, moves, S, U, R, C, bound):
    """Phase 1 sizes a doc's tables from the slots the launch can reach,
    nb0 + S (5U + 2R) + 2 moves, capped at C, at the load factors of
    `scratch_entries`, and clears their prefixes and that many slots of
    both stamps: the write path's doc clears 338,176 of the 1,376,256
    bytes the wrapper allocates; a doc within its bound of C, and the B4
    chunk, clear everything."""
    got = ik.scratch_cleared(nb0, C, S, U, R, moves, host_lib)
    hb, hs = ik.scratch_entries(bound)
    assert got == {"slots_bound": bound, "bitmap_entries": hb, "start_map_entries": hs,
                   "cleared_bytes": 16 * (hb + hs) + 8 * bound}
    full = ik.batch_launch_plan(1, C, host_lib)["scratch_bytes_per_doc"]
    assert (got["cleared_bytes"] == full) == (bound == C)
    if (nb0, C) == (1305, 8192):
        assert got["cleared_bytes"] == 338176 and full == 1376256


def test_batch_plan_reports_the_bytes_cleared(host_lib):
    """`batch_launch_plan` with each doc's slot count: the bytes its
    launch's phase 1 clears, beside the scratch it allocates."""
    p = ik.batch_launch_plan(3, 8192, host_lib, nb0=[0, 1305, 8190], U=1, R=1)
    want = sum(ik.scratch_cleared(n, 8192, lib=host_lib)["cleared_bytes"] for n in (0, 1305, 8190))
    assert p["cleared_bytes"] == want == 1336 + 338176 + 1376256
