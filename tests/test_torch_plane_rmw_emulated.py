"""Two sections of ``ytpu_torch/csrc/plane_rmw.cu``, each built alone and
run on the CPU through a host emulator of the CUDA pieces they use
(tests/cuda_host/cuda_runtime.h), held exactly against the plain versions.

The column put (the kernel of cases a / a2, g3d / g2d and v_vmem) against
`masked_put_plain` / `g3d_plain` / `g2d_flat_plain` / `v_vmem_plain`:
the in-place column fill (at idx -1, 0, a live idx, C - 1 and C; every
plane, or one plane: the first, the repros' 7 and the last), the
streaming copy into a SENTINEL-filled output on its 16-byte path and on
its one-int path (C = 510, a view one int off a 16-byte boundary), a last
CTA partly empty, a grid of many CTAs, v_vmem's flat copy (idx -1) in and
out of place, and the copy with 64-bit indices (the card's path from 2^31
ints on) on small inputs.

The multi call against `v_multi_plain` / `v_body_plain`: v_multi's sized
copy in place and into a SENTINEL-filled output, on its 16-byte path and
its one-int path (35 ints, views one int off), over several CTAs; v_body's
one pass at nb = 0, nb = C and random nb (below 0 and past C too), with an
invalid row, a row at clock 0, clocks + lengths that wrap past 2^31, every
slot of a doc holding the row's client (no slot offers 0), more than 32
rows (a second and third pass, one of them all invalid), C = 510 and a
view one int off (the one-int path), into a separate SENTINEL-filled meta,
and at small CTAs whose threads take several tiles of a doc.

The kernels themselves are compiled and run only on the card
(`chip_smoke.py`). Here g++ compiles each section with every warp a host
thread and each lane a fiber on it. It says nothing of speed, and nothing of what nvcc makes of
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
sys.path.insert(0, str(HERE))

from _emulated_plane_rmw import BODY_CASES, CASES, MULTI_CASES  # noqa: E402


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, str(HERE / "_emulated_plane_rmw.py"),
         str(tmp_path_factory.mktemp("plane_rmw_host"))],
        capture_output=True, text=True, timeout=120, env=env,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", list(CASES))
def test_column_put_source_matches_plain_version(emulated, case):
    r = emulated["column_put"][case]
    assert r["max_abs_err"] == 0, r
    out_of_place = CASES[case][2]
    assert r["input_kept"] is (True if out_of_place else None)
    # the 16-byte path runs out of place on aligned rows of a multiple of 4
    assert r["vec4"] == (out_of_place and "C510" not in case and "misaligned" not in case)


@pytest.mark.parametrize("case", list(MULTI_CASES))
def test_v_multi_source_matches_plain_version(emulated, case):
    r = emulated["v_multi"][case]
    assert r["max_abs_err"] == 0, r
    out_of_place = MULTI_CASES[case][1]
    assert r["input_kept"] is (True if out_of_place else None)
    assert r["vec4"] == ("misaligned" not in case and case != "n_35")


@pytest.mark.parametrize("case", list(BODY_CASES))
def test_v_body_source_matches_plain_version(emulated, case):
    r = emulated["v_body"][case]
    assert r["max_abs_err"] == 0, r
    assert r["cols_kept"], r
    assert r["meta_kept"] is (True if BODY_CASES[case][1].get("out") else None)
    assert r["vec4"] == ("C510" not in case and "misaligned" not in case)


def test_v_body_cases_reach_both_outcomes(emulated):
    """The cases flag some docs and leave others; where every slot holds
    the row's client with a wrapped (negative) clock, exactly the docs
    with no slot past nb (nb = C) miss the rows of clock -5 and 0."""
    runs = emulated["v_body"].values()
    assert any(0 < len(r["flagged"]) < r["docs"] for r in runs)
    assert emulated["v_body"]["all_slots_match_wrapped"]["flagged"] == [0, 3]
