"""Two sections of ``ytpu_torch/csrc/mosaic_ladder.cu``, run on the CPU
through a host emulator of the CUDA pieces they use
(tests/cuda_host/cuda_runtime.h): the map put (the kernel of rungs 0 and 7),
held exactly against the plain versions `copy_plain` (``x + 1``) and
`big_tile_plain` (``2x``), and the scan and nested sum (rungs 4 and 5),
held exactly against `while_scan_plain` and `nested_fori_plain`.

The kernels themselves are compiled and run only on the card
(`chip_smoke.py`). Here g++ compiles each section alone with every CUDA
thread a host thread. The map put's C entry points run on: rung 0's program
shape, a rung-7-shaped tile over several CTAs, a last CTA partly empty, a
count below one CTA's groups, the one-int path (a count not a multiple of
4, the input or the output one int off a 16-byte boundary) and values at
the wrap (INT_MAX, INT_MIN, -1, 2^30). Rung 4's and rung 5's run on: the JAX
rung's input; seeded values in [0, 12) and over the full range (sums that
wrap past 2^31); rows that break at step 0 and at step 11, a row that never
breaks, a row whose signed sum crosses 40 only after a wrap and one that
wraps negative instead of breaking; fewer than 12 columns (C = 5, 8, 11) and,
for rung 5, fewer than 32 (C = 5, 11, 31: the index wraps mod C); counts of
columns not a multiple of 4; the input or the output one int off a 16-byte
boundary; D = 1 and D = 256; rows over several CTAs. Every output lies
inside a SENTINEL-filled buffer that must keep its SENTINELs around it.
It says nothing of speed, and nothing of what nvcc makes of the source.

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
sys.path.insert(0, str(HERE))

from _emulated_ladder import (  # noqa: E402
    BREAK_VALUES, CASES, R4_CASES, R5_CASES, RUNGS, break_steps,
)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, str(HERE / "_emulated_ladder.py"), str(tmp_path_factory.mktemp("ladder_host"))],
        capture_output=True, text=True, timeout=120, env=env,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("rung", list(RUNGS))
def test_map_put_source_matches_plain_version(emulated, rung, case):
    r = emulated[rung][case]
    assert r["max_abs_err"] == 0, r
    assert r["input_kept"] and r["outside_kept"], r
    # the 16-byte path runs on aligned tensors of a multiple of 4 ints
    assert r["vec4"] == case.startswith(("vec4", "wrap_vec4")), r
    # the cases named for a launch shape have it (a CTA maps per_cta groups)
    per_cta, ctas = r["per_cta"], -(-r["groups"] // r["per_cta"])
    if case in ("vec4_8x256", "vec4_25x8x64"):
        assert ctas > 1, r
    elif case == "vec4_ragged_last_cta":
        assert ctas > 1 and r["groups"] % per_cta, r
    elif case == "vec4_63_groups":
        assert r["groups"] < per_cta, r


def _scan_sum_checks(r, case):
    assert r["max_abs_err"] == 0, r
    assert r["input_kept"] and r["outside_kept"], r
    assert r["vec4"] == case.startswith(("vec4", "wrap_vec4")), r


@pytest.mark.parametrize("case", list(R4_CASES))
def test_scan_source_matches_plain_version(emulated, case):
    r = emulated["r4"][case]
    _scan_sum_checks(r, case)
    # rows of more groups than a CTA stores take several CTAs
    if case.endswith("row_tiles"):
        assert r["groups"] > r["per_cta"], r


@pytest.mark.parametrize("case", list(R5_CASES))
def test_nested_sum_source_matches_plain_version(emulated, case):
    r = emulated["r5"][case]
    _scan_sum_checks(r, case)
    if case == "vec4_ragged_last_cta":
        assert r["groups"] > r["per_cta"] and r["groups"] % r["per_cta"], r


def test_scan_cases_reach_their_edges():
    """The plain version gives the crafted rows the values their
    description names (break at step 0 and 11, no break, the wraps)."""
    from ytpu_torch.benches.mosaic_ladder import while_scan_plain

    got = while_scan_plain(break_steps())
    assert got[:, 0].tolist() == BREAK_VALUES
    assert (got == got[:, :1]).all()
