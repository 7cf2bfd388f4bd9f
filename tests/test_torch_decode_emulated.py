"""The CUDA decode kernel's own source, run on the CPU through a host
emulator of the CUDA pieces it uses (tests/cuda_host/cuda_runtime.h), held
exactly against its plain version `decode_kernel._decode_loop_reference`:
every pre-resolve row and delete column and every lane's flags.

The kernel itself is compiled and run only on the card (`chip_smoke.py`'s
``decode`` phase). Here g++ compiles the same ``csrc/decode.cu`` with
every CUDA thread a host thread, on the mixed corpus of
tests/test_torch_decode.py, a B4 slice, merged whole-state lanes, the
overflow and step-budget settings, truncated and garbage lanes and lanes
whose bytes run on past ``lens``; three mutants of the source (a varint
window not masked by ``lens``, a step budget that is ignored, an overflow
that stops the lane) must each differ from the plain version. It says
nothing of speed, and nothing of what nvcc makes of the source.

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
CASES = [
    "corpus",
    "b4_slice",
    "overflow_U1_R1_T12",
    "sections_U4_R4_T96_sec0",
    "overflow_U1_R1_T96",
    "truncated",
    "garbage",
    "lens_cut",
    "merged",
]
MUTANTS = ["window_not_masked_by_lens", "step_budget_ignored", "overflow_stops_lane"]


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
# guard, malformed lanes; B4 and merged lanes decode clean
@pytest.mark.parametrize("case, flags_all, flags_none", [
    ("overflow_U1_R1_T12", 2 | 4, 0),
    ("overflow_U1_R1_T96", 2, 0),
    ("sections_U4_R4_T96_sec0", 4, 0),
    ("truncated", 4, 0),
    ("garbage", 4, 0),
    ("lens_cut", 4, 0),
    ("b4_slice", 0, 1 | 2 | 4 | 8 | 32 | 64),
    ("merged", 0, 1 | 2 | 4 | 8 | 32 | 64),
])
def test_case_flags(emulated, case, flags_all, flags_none):
    r = emulated[case]
    assert r["flags"] & flags_all == flags_all, r
    assert r["flags"] & flags_none == 0, r


def test_merged_lanes_are_long(emulated):
    assert emulated["merged"]["max_steps"] > 100


@pytest.mark.parametrize("mutant", MUTANTS)
def test_mutant_is_caught(emulated, mutant):
    assert emulated["mutants"][mutant] > 0
