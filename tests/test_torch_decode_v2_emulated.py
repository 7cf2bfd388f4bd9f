"""The V2 decode program's own source, run on the CPU through a host
emulator of the CUDA pieces it uses (tests/cuda_host/cuda_runtime.h), held
exactly against the plain version `decode_v2._decode_v2_reference`: the 21
pre-resolve row columns, the 3 delete columns, both valid masks and every
lane's flags, and the stream after `_resolve_and_pack` with each set's
tables.

The kernel itself is compiled and run only on the card (`chip_smoke.py`'s
``decode_v2`` phase). Here g++ compiles the same ``csrc/decode_v2.cu``
with every CUDA thread a host thread, on the crafted sets of
``ytpu_torch/benches/data/v2_cases.json`` (the big clients also without
their tables) and a 1,024-update B4 slice as a matrix and as a gathered
arena. Mutants of the source (a varint window not masked by its region's
end, the walker's step budget ignored, big client ids not hashed, every
cold block taking the first sidecar span, deep Any maps not flagged) must
each differ from the plain version. It says nothing of speed, and
nothing of what nvcc makes of the source.

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
CASES = ["text", "deletes", "multi_client_skips", "map_keys", "big_clients", "big_clients_no_tables",
         "content_kinds", "nested_any", "overflow", "truncated_columns", "zero_spans", "rest_past_span",
         "mutated", "b4_slice", "b4_slice_arena"]
MUTANTS = ["window_not_masked_by_end", "walker_budget_ignored", "big_client_not_hashed", "sidecar_rank_ignored",
           "deep_maps_not_flagged"]


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
    assert r["max_abs_err"] == 0 and r["resolved_err"] == 0, r


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
    ("b4_slice", 0, 1 | 2 | 4 | 8 | 32 | 64),
])
def test_case_flags(emulated, case, flags_all, flags_none):
    r = emulated[case]
    assert r["flags"] & flags_all == flags_all, r
    assert r["flags"] & flags_none == 0, r


@pytest.mark.parametrize("mutant", MUTANTS)
def test_mutant_is_caught(emulated, mutant):
    assert emulated["mutants"][mutant] > 0
