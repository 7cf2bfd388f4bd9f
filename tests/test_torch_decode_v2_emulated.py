"""The V2 decode program's own source, run on the CPU through a host
emulator of the CUDA pieces it uses (tests/cuda_host/cuda_runtime.h), held
exactly against the plain composition (`gather_raw_lanes` for the arena
-> `decode_v2._decode_v2_reference` -> `_resolve_and_pack`): all 27
UpdateBatch fields and every lane's flags, from the ``[S, L]`` matrix and
from the arena of `pack_updates_v2_raw` read in place.

The kernel itself is compiled and run only on the card (`chip_smoke.py`'s
``decode_v2`` phase). Here g++ compiles the same ``csrc/decode_v2.cu``
with every warp a host thread and each lane a fiber on it, on the crafted sets of
``ytpu_torch/benches/data/v2_cases.json`` with their tables (the big
clients also without them), those sets together under each intern-table
case (every hit, a raw client miss, an empty raw table, no hash table and
a hash miss, no key table and a key miss, a root miss, no primary root, a
primary root a lane), a
1,024-update B4 slice without tables and with a raw client table, and
merged B4 prefixes at a U whose column expansions pass the shared-memory
budget (the device-memory scratch path; every other set keeps them in
shared memory). Mutants of the source (a varint window not masked by its
region's end, the walker's step budget ignored, big client ids not
hashed, every cold block taking the first sidecar span, deep Any maps not
flagged, the arena read past a lane's staged extent, an error lane that
keeps its valid bytes, the key table skipped, a section that starts after
its block read before the block lengths are summed, the strings' forward
scan not started over where a wrapped length makes a target fall) must
each differ from the plain composition. It says nothing of speed, and nothing of what nvcc
makes of the source.

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
TABLE_CASES = ["all", "client_miss", "empty_client_table", "no_hash_table", "hash_miss", "no_key_table",
               "key_miss", "root_miss", "no_primary", "primary_per_lane"]
CASES = ["text", "deletes", "multi_client_skips", "map_keys", "big_clients", "big_clients_no_tables",
         "content_kinds", "nested_any", "overflow", "truncated_columns", "zero_spans", "rest_past_span",
         "mutated", "sections_out_of_order", "wrapped_string_length", "b4_slice", "b4_slice_arena", "merged_global"] + [
             f"tables_{c}" for c in TABLE_CASES]
MUTANTS = ["window_not_masked_by_end", "walker_budget_ignored", "big_client_not_hashed", "sidecar_rank_ignored",
           "deep_maps_not_flagged", "arena_not_masked_by_row_lens", "error_lane_keeps_rows", "key_table_skipped",
           "sections_out_of_order_ignored", "string_scan_not_restarted"]


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, str(HERE / "_emulated_decode_v2.py"), str(tmp_path_factory.mktemp("decode_v2_host"))],
        capture_output=True, text=True, timeout=300, env=env,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", CASES)
def test_kernel_source_matches_plain_version(emulated, case):
    r = emulated[case]
    assert r["max_abs_err"] == 0 and r["arena_err"] == 0, r


# each set exercises what it is named for, read from the plain version's
# resolved flags (OR over the lanes)
@pytest.mark.parametrize("case, flags_all, flags_none", [
    ("text", 0, 1 | 2 | 4 | 8 | 32 | 64),
    ("big_clients", 0, 1 | 2 | 4 | 8 | 32 | 64),
    ("big_clients_no_tables", 8, 0),
    ("content_kinds", 1, 2 | 4 | 8),
    ("nested_any", 1, 2 | 4 | 8),
    ("overflow", 2 | 4, 0),
    ("zero_spans", 4, 0),
    ("rest_past_span", 4, 0),
    ("sections_out_of_order", 16, 1 | 2 | 4 | 8 | 32 | 64),
    ("wrapped_string_length", 64, 1 | 2 | 4 | 8 | 32),
    ("b4_slice", 0, 1 | 2 | 4 | 8 | 32 | 64),
    ("b4_slice_arena", 0, 1 | 2 | 4 | 8 | 32 | 64),
    ("merged_global", 0, 1 | 2 | 4 | 8 | 32 | 64),
    ("tables_client_miss", 32, 0),
    ("tables_empty_client_table", 32, 0),
    ("tables_no_hash_table", 8, 0),
    ("tables_hash_miss", 32, 0),
    ("tables_no_key_table", 64, 0),
    ("tables_key_miss", 64, 0),
    ("tables_root_miss", 64, 0),
])
def test_case_flags(emulated, case, flags_all, flags_none):
    r = emulated[case]
    assert r["flags"] & flags_all == flags_all, r
    assert r["flags"] & flags_none == 0, r


def test_both_scratch_paths_run(emulated):
    """The column expansions stay in shared memory at the crafted sets' and
    the B4 slice's caps, and go to the device-memory scratch past the
    budget."""
    assert all(emulated[c]["path"] == "shared" for c in CASES if c != "merged_global")
    assert emulated["merged_global"]["path"] == "global"


def test_table_cases_differ_only_by_their_table(emulated):
    """Each table case adds its own flag to the flags of every hit."""
    base = emulated["tables_all"]["flags"]
    assert emulated["tables_no_primary"]["flags"] == base
    for case, flag in (("client_miss", 32), ("empty_client_table", 32), ("no_hash_table", 8), ("hash_miss", 32),
                       ("no_key_table", 64), ("key_miss", 64), ("root_miss", 64)):
        assert emulated[f"tables_{case}"]["flags"] == base | flag, case
        assert emulated[f"tables_{case}"]["error_lanes"] > emulated["tables_all"]["error_lanes"], case


@pytest.mark.parametrize("mutant", MUTANTS)
def test_mutant_is_caught(emulated, mutant):
    assert emulated["mutants"][mutant] > 0
