"""The column put of ``ytpu_torch/csrc/plane_rmw.cu`` (the kernel of cases
a / a2, g3d / g2d and v_vmem), run on the CPU through a host emulator of
the CUDA pieces it uses (tests/cuda_host/cuda_runtime.h), held exactly
against the plain versions `masked_put_plain` / `g3d_plain` /
`g2d_flat_plain` / `v_vmem_plain`.

The kernel itself is compiled and run only on the card (`chip_smoke.py`).
Here g++ compiles the source's column-put section with every CUDA thread
a host thread: the in-place column fill (at idx -1, 0, a live idx, C - 1
and C; every plane, or one plane: the first, the repros' 7 and the last),
the streaming copy into a SENTINEL-filled output on its 16-byte path and
on its one-int path (C = 510, a view one int off a 16-byte boundary), a
last CTA partly empty, a grid of many CTAs, v_vmem's flat copy (idx -1)
in and out of place, and the copy with 64-bit indices (the card's path
from 2^31 ints on) on small inputs. It says nothing of speed, and nothing
of what nvcc makes of the source.

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

from _emulated_plane_rmw import CASES  # noqa: E402


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
