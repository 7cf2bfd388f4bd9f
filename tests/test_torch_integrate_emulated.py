"""The CUDA integrate kernel's own source, run on the CPU through a host
emulator of the CUDA pieces it uses (tests/cuda_host/cuda_runtime.h), held
exactly against its plain version: the stream entry against
`integrate_stream_reference`, the per-doc entry against
`integrate_batch_reference` after every launch (docs whose rows differ),
every launch on scratch poisoned with keys and epochs it could mistake
for its own.

The kernel itself is compiled and run only on the card (`chip_smoke.py`).
Here g++ compiles the same ``csrc/integrate.cu`` with every warp a host
thread and each lane a fiber on it: the warp collectives, the mbarrier ring and the bulk copies
of the stream, the cursor cache, the index and the store ordering between
lanes all run, and a result that differs from `integrate_stream_reference`
in any plane or meta word fails. It says nothing of speed, and nothing of
what nvcc makes of the source.

The emulation runs in a child process under a time limit, so that a
kernel that deadlocks fails the test instead of stopping the suite.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BATCH_CASES = ["batch_synthetic_D4", "batch_typing_D3"]
CASES = [
    "synthetic_plan32_8_C256",
    "synthetic_plan4_1_C256",
    "synthetic_plan32_8_C64",
    "synthetic_negative_start_deletes",
    "typing_8clients_D3_S601",
    "typing_clients_above_KC",
]


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, str(HERE / "_emulated_integrate.py"), str(tmp_path_factory.mktemp("integrate_host"))],
        capture_output=True, text=True, timeout=300, env=env,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", CASES)
def test_kernel_source_matches_plain_version(emulated, case):
    r = emulated[case]
    assert r["max_abs_err"] == 0, r
    if case == "synthetic_plan32_8_C64":
        assert r["error"] & 1  # the capacity cut overflows
    else:
        assert r["blocks"] > 90


@pytest.mark.parametrize("case", BATCH_CASES)
def test_per_doc_entry_matches_plain_version(emulated, case):
    r = emulated[case]
    assert r["max_abs_err"] == 0, r
    assert r["blocks"] > 20 and r["error"] & 1 == 0


def test_per_doc_entry_matches_plain_version_at_the_edges(emulated):
    """`batch_edge_steps`: an empty doc launched, a doc whose launches
    start within their bound of C (its phase 1 sized for all C slots) until
    it is full, rows that split both origins, delete ranges split at both
    ends, map rows and moves whose pointers split blocks."""
    r = emulated["batch_edges_D4"]
    assert r["max_abs_err"] == 0, r
    assert r["first_slots_min"] == 0 and r["capped_below_C"] > 0 and r["error"] & 1


def test_a_doc_reading_its_neighbours_rows_fails(emulated):
    """The edge case through a mutant of the source in which each doc
    reads its neighbour's rows: the comparison must catch it."""
    assert emulated["batch_neighbour_rows_mutant"]["max_abs_err"] > 0


@pytest.mark.parametrize("mutant", ["stamps_to_nb0", "tables_cleared_for_nb0"])
def test_a_short_clear_fails(emulated, mutant):
    """The edge case through a mutant whose phase 1 clears the stamps only
    below the doc's slot count at the launch's start, or clears the tables
    as if they were sized from that count alone: on poisoned scratch the
    comparison must catch both."""
    assert emulated[f"batch_{mutant}_mutant"]["max_abs_err"] > 0


def test_per_doc_entry_matches_plain_version_on_ingest_rows(emulated):
    """`benches.streams.ingest_steps`: the rows a `BatchIngestor` emits from
    the committed ingest logs' wire bytes (root anchors made by
    `ensure_root_anchor`, map key chains from the key table, 53-bit
    clients interned through the hash table), each step from the plain
    version's state."""
    r = emulated["batch_ingest_rows_D4"]
    assert r["max_abs_err"] == 0, r
    assert r["error"] == 0 and r["steps"] == 12
    assert r["anchors"] == 3 and r["proot_rows"] >= 2 and r["map_rows"] > 5


def test_an_anchor_lookup_ignoring_its_key_fails(emulated):
    """The ingest rows through a mutant whose root-anchor lookup takes the
    first anchor of any root: the doc that holds two anchors must show it."""
    assert emulated["batch_anchor_ignores_key_mutant"]["max_abs_err"] > 0
