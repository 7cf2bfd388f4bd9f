"""The CUDA decode program's own source, run on the CPU through a host
emulator of the CUDA pieces it uses (tests/cuda_host/cuda_runtime.h), held
exactly against the plain composition `decode_kernel._decode_plain`
(`gather_raw_lanes` for an arena -> `_decode_loop_reference` ->
`_resolve_and_pack`): all 27 UpdateBatch fields and every lane's flags.

The kernel itself is compiled and run only on the card (`chip_smoke.py`'s
``decode`` phase). Here g++ compiles the same ``csrc/decode.cu`` with
every warp a host thread and each lane a fiber on it, from the ``[S, L]`` matrix and from the
flat arena, on the mixed corpus of tests/test_torch_decode.py, a B4 slice,
merged whole-state lanes, the overflow and step-budget settings,
truncated and garbage lanes, 1,536 corpus lanes with random bytes
overwritten, lanes whose bytes run on past ``lens`` and the corpus at a
row count past the shared-memory stage; then with the
intern tables of tests/test_torch_update_decode.py (every hit, a raw
client miss, an empty raw table, no hash table and a hash miss, no key
table and a key miss, a root miss, no primary root) and
those of a small CPU `BatchIngestor`'s fast-lane call. Mutants of the
source (a varint window not masked by ``lens``, the arena read at the
arena's end not masked by ``lens``, a step budget that is ignored, an
overflow that stops the lane, an error lane that keeps its rows, an
empty client table treated as absent) must each differ from the plain
composition. It says nothing of speed, and nothing of what nvcc makes of
the source.

The emulation runs in a child process under a time limit, so that a
kernel that hangs fails the test instead of stopping the suite.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
SETS = [
    "corpus",
    "b4_slice",
    "overflow_U1_R1_T12",
    "sections_U4_R4_T96_sec0",
    "overflow_U1_R1_T96",
    "truncated",
    "garbage",
    "mutated",
    "lens_cut",
    "merged",
    "corpus_unstaged_U24",
]
TABLE_CASES = ["all", "client_miss", "empty_client_table", "no_hash_table", "hash_miss", "no_key_table",
               "key_miss", "root_miss", "no_primary"]
CASES = (SETS + [f"{s}_arena" for s in SETS] + [f"tables_{c}" for c in TABLE_CASES]
         + ["ingest_step"])
MUTANTS = ["window_not_masked_by_lens", "arena_read_not_masked_by_lens", "step_budget_ignored",
           "overflow_stops_lane", "error_lane_keeps_rows", "empty_client_table_as_absent"]


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, str(HERE / "_emulated_decode.py"), str(tmp_path_factory.mktemp("decode_host"))],
        capture_output=True, text=True, timeout=300, env=env,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", CASES)
def test_kernel_source_matches_plain_loop(emulated, case):
    r = emulated[case]
    assert r["max_abs_err"] == 0, r
    assert r["max_steps"] <= r["T"]


# each set exercises what it is named for, read from the plain version's
# flags (OR over the lanes): overflow and a spent step budget, the section
# guard, malformed lanes, each table's miss; B4, merged and ingest lanes
# decode clean
@pytest.mark.parametrize("case, flags_all, flags_none", [
    ("overflow_U1_R1_T12", 2 | 4, 0),
    ("overflow_U1_R1_T96", 2, 0),
    ("sections_U4_R4_T96_sec0", 4, 0),
    ("truncated", 4, 0),
    ("garbage", 4, 0),
    ("mutated", 1 | 4, 0),
    ("lens_cut", 4, 0),
    ("b4_slice", 0, 1 | 2 | 4 | 8 | 32 | 64),
    ("merged", 0, 1 | 2 | 4 | 8 | 32 | 64),
    ("tables_all", 1, 2 | 4 | 8 | 32 | 64),
    ("tables_client_miss", 32, 0),
    ("tables_empty_client_table", 32, 0),
    ("tables_no_hash_table", 8, 0),
    ("tables_hash_miss", 32, 0),
    ("tables_no_key_table", 64, 0),
    ("tables_key_miss", 64, 0),
    ("tables_root_miss", 64, 0),
    ("ingest_step", 0, 1 | 2 | 4 | 8 | 32 | 64),
])
def test_case_flags(emulated, case, flags_all, flags_none):
    r = emulated[case]
    assert r["flags"] & flags_all == flags_all, r
    assert r["flags"] & flags_none == 0, r


def test_merged_lanes_are_long(emulated):
    assert emulated["merged"]["max_steps"] > 100


def test_both_output_paths_run(emulated):
    """Rows go through the warp's shared-memory stage at small U and
    straight to the planes past it."""
    assert emulated["corpus"]["staged"] and emulated["ingest_step"]["staged"]
    assert not emulated["corpus_unstaged_U24"]["staged"] and not emulated["merged"]["staged"]


@pytest.mark.parametrize("mutant", MUTANTS)
def test_mutant_is_caught(emulated, mutant):
    assert emulated["mutants"][mutant] > 0
