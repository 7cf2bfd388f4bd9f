"""The map put of ``ytpu_torch/csrc/mosaic_ladder.cu`` (the kernel of rungs
0 and 7), run on the CPU through a host emulator of the CUDA pieces it uses
(tests/cuda_host/cuda_runtime.h), held exactly against the plain versions
`copy_plain` (``x + 1``) and `big_tile_plain` (``2x``).

The kernel itself is compiled and run only on the card (`chip_smoke.py`).
Here g++ compiles the source's map-put section with every CUDA thread a
host thread, and both rungs' C entry points run on: rung 0's program shape,
a rung-7-shaped tile over several CTAs, a last CTA partly empty, a count
below one CTA's groups, the one-int path (a count not a multiple of 4, the
input or the output one int off a 16-byte boundary) and values at the wrap
(INT_MAX, INT_MIN, -1, 2^30), each into an output inside a SENTINEL-filled
buffer that must keep its SENTINELs around the output. It says
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
sys.path.insert(0, str(HERE))

from _emulated_ladder import CASES, RUNGS  # noqa: E402


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
