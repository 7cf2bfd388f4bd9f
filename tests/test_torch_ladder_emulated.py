"""Three sections of ``ytpu_torch/csrc/mosaic_ladder.cu``, run on the CPU
through a host emulator of the CUDA pieces they use
(tests/cuda_host/cuda_runtime.h): the map put (the kernel of rungs 0 and 7),
held exactly against the plain versions `copy_plain` (``x + 1``) and
`big_tile_plain` (``2x``); the scan and nested sum (rungs 4 and 5), held
exactly against `while_scan_plain` and `nested_fori_plain`; and the row put
and carried sum (rungs 1 and 3), held exactly against `onehot_put_plain`
and `fori_carry_plain`.

The kernels themselves are compiled and run only on the card
(`chip_smoke.py`). Here g++ compiles each section alone, with the shared
helpers, with every warp a host thread and each lane a fiber on it. The map put's C entry points
run on: rung 0's program shape, a rung-7-shaped tile over several CTAs, a
last CTA partly empty, a count below one CTA's groups, the one-int path (a
count not a multiple of 4, the input or the output one int off a 16-byte
boundary) and values at the wrap (INT_MAX, INT_MIN, -1, 2^30). Rung 4's and
rung 5's run on: the JAX rung's input; seeded values in [0, 12) and over the
full range (sums that wrap past 2^31); rows that break at step 0 and at
step 11, a row that never breaks, a row whose signed sum crosses 40 only
after a wrap and one that wraps negative instead of breaking; fewer than 12
columns (C = 5, 8, 11) and, for rung 5, fewer than 32 (C = 5, 11, 31: the
index wraps mod C); counts of columns not a multiple of 4; the input or the
output one int off a 16-byte boundary; D = 1 and D = 256; rows over several
CTAs.

Rung 1's run on: the JAX rung's input; seeded head indices in [-2, C + 2);
rows whose index is 0 (the head cell itself), C - 1, C, -1, INT_MIN and
INT_MAX, at C = 256 and on the one-int path at C = 5 and 11 (the index in a
row's last int); rows over several CTAs with the index in a late tile; D =
1; the input or the output one int off 16 bytes; and, through a host-only
entry that lets one grid cover only 3 or 4 rows, more rows than the grid
(CTAs stride over rows, as past 65,535 rows on the card). Rung 3's run on:
the JAX rung's input (``ones``: 16 D); the full range (the sum wraps); C =
16, 17 and 18 (the head one int a group past 16); D = 1, 8, 100 and 256
(400 head groups: some threads load two; 1,024: four a thread); several
CTAs with the last partly empty; the input or the output one int off 16
bytes. Every output lies inside a SENTINEL-filled buffer that must keep
its SENTINELs around it.

What each edge catches, by mutations of a copy of the source: a lane
offset off by one in the index compare (the JAX input and seeded rows); the
index read from row 0 for every row (every case); the stride over rows
dropped (only the two rows-stride cases); the index clamped into [0, C)
(the edge rows, the seeded C = 11 and wrap cases); the index narrowed to
16 bits (only the edge rows: INT_MIN becomes 0); the one-int path taking
four columns a group (the one-int cases); rung 3's head row stride taken
as 16 (C != 16); its sum narrowed to 16 bits (the full-range cases); only
the first warp's partial read (every head of more than 32 groups); the
CTA offset without its G (the multi-CTA cases); its head's one-int path
taking 8 columns (the head_ints cases). One rule rests on reading the code
alone: rung 1 clamps the load of a group past its row to the row's last
group, and a mutation that drops the clamp still passes (the value is
never stored, and the emulator cannot see the read).

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
    BREAK_VALUES, CASES, R1_CASES, R3_CASES, R4_CASES, R5_CASES, RUNGS, break_steps, edge_heads,
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


@pytest.mark.parametrize("case", list(R1_CASES))
def test_row_put_source_matches_plain_version(emulated, case):
    r = emulated["r1"][case]
    _scan_sum_checks(r, case)
    if case.endswith("row_tiles"):  # several CTAs a row
        assert r["groups"] > r["per_cta"], r
    if case.endswith("rows_stride"):  # more rows than one grid covers
        assert R1_CASES[case][0]().shape[0] > r["rows_per_grid"], r


@pytest.mark.parametrize("case", list(R3_CASES))
def test_carried_sum_source_matches_plain_version(emulated, case):
    r = emulated["r3"][case]
    _scan_sum_checks(r, case)
    assert r["head_vec4"] == ("head_ints" not in case), r
    if "_ctas_ragged" in case:  # several CTAs, the last partly empty
        assert r["groups"] > r["per_cta"] and r["groups"] % r["per_cta"], r


def test_row_put_cases_reach_their_edges():
    """The plain version puts 7 where the crafted rows say: in the head
    cell itself (index 0) and in the last column; nowhere for C, -1, INT_MIN
    and INT_MAX; in rows over several CTAs, past the first CTA's groups."""
    from ytpu_torch.benches.mosaic_ladder import onehot_put_plain

    for case, C in (("vec4_edges", 256), ("scalar_edges_C5", 5), ("scalar_edges_C11", 11)):
        x = R1_CASES[case][0]()
        assert x[:, 0].tolist() == edge_heads(C)
        changed = onehot_put_plain(x) != x
        assert [changed[d].nonzero().flatten().tolist() for d in range(6)] == [[0], [C - 1], [], [], [], []]
    x = R1_CASES["vec4_row_tiles"][0]()
    assert [int(onehot_put_plain(x)[d, int(x[d, 0])]) for d in range(3)] == [7, 7, 7]
    assert int(x[:, 0].min()) >= 4 * 256  # past the groups of a CTA of 256 threads
