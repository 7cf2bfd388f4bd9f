"""The port's packed layout, conversion and readout helpers against the JAX
package, byte for byte: `init_state` -> `pack_state`, `unpack_state`,
`pack_stream`, `convert` round trips, the scan record, the uint32
commitment fold and the per-chunk readout words.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ytpu.models import batch_doc as jbd
from ytpu.ops import decode_kernel as jdk
from ytpu.ops import integrate_kernel as jik

from ytpu_torch import convert
from ytpu_torch.models import batch_doc as tbd
from ytpu_torch.ops import integrate_kernel as tik

from test_torch_integrate import XLA_C, XLA_D, _xla_case, empty_packed, packed_numpy, run_port

# one intra-op thread: these cases are op-bound, and the suite runs
# several test processes side by side
torch.set_num_threads(1)


def test_constants_match():
    for name in ("NC", "M_PAD", "M_START", "M_NBLOCKS", "M_ERROR", "M_MDIRTY", "M_HIST0",
                 "M_SCANW_MAX", "M_TIER_CHEAP", "M_TIER_WIDE", "M_CHEAP_TRIPS",
                 "M_WIDE_TRIPS", "M_WIDTH_SUM", "M_SCAN_END", "LEDGER_WORDS", "N_READOUT",
                 "ERR_CAPACITY", "ERR_MISSING_DEP", "CL", "CK", "LN", "RT", "KEY", "MV", "MPR", "OS"):
        assert getattr(tik, name) == getattr(jik, name), name
    for name in ("SCAN_WIDTH_BUCKETS", "SCAN_REC_WORDS", "SCAN_REC_MAX", "SCAN_REC_CHEAP",
                 "SCAN_WIDTH_THRESHOLDS", "SCAN_WIDTH_UPPER"):
        assert getattr(tbd, name) == getattr(jbd, name), name
    assert tuple(tbd.COL_DEFAULTS.items()) == tuple(jbd.COL_DEFAULTS.items())
    assert tbd.BlockCols._fields == jbd.BlockCols._fields
    assert tbd.UpdateBatch._fields == jbd.UpdateBatch._fields


@pytest.mark.parametrize("n_docs,capacity", [(1, 8), (3, 64)])
def test_init_state_packs_byte_equal(n_docs, capacity):
    j_cols, j_meta = jik.pack_state(jbd.init_state(n_docs, capacity))
    t_cols, t_meta = tik.pack_state(tbd.init_state(n_docs, capacity, "cpu"))
    np.testing.assert_array_equal(np.asarray(j_cols), t_cols.numpy())
    np.testing.assert_array_equal(np.asarray(j_meta), t_meta.numpy())
    assert t_cols.dtype == torch.int32 and t_meta.dtype == torch.int32


def test_unpack_state_and_convert_round_trip():
    stream, rank, _, _ = _xla_case("moves")
    rows, dels = packed_numpy(stream)
    cols, meta = run_port(*empty_packed(XLA_D, XLA_C), rows, dels, rank)
    j_state = jik.unpack_state(jnp.asarray(cols), jnp.asarray(meta), None)
    t_state = tik.unpack_state(*convert.packed_from_numpy(cols, meta, "cpu"))
    for name in jbd.BlockCols._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(j_state.blocks, name)), getattr(t_state.blocks, name).numpy(), err_msg=name
        )
    for name in ("start", "n_blocks", "error"):
        np.testing.assert_array_equal(np.asarray(getattr(j_state, name)), getattr(t_state, name).numpy())
    back = convert.packed_to_numpy(*convert.packed_from_numpy(cols, meta, "cpu"))
    np.testing.assert_array_equal(back[0], cols)
    np.testing.assert_array_equal(back[1], meta)
    r, d = convert.stream_from_numpy(rows, dels, "cpu")
    np.testing.assert_array_equal(r.numpy(), rows)
    np.testing.assert_array_equal(d.numpy(), dels)
    with pytest.raises(ValueError):
        convert.packed_from_numpy(cols[:25], meta, "cpu")


def test_pack_stream_matches_on_a_decoded_stream():
    from test_torch_decode import corpus

    buf, lens = jdk.pack_updates(corpus())
    j_stream, _ = jdk.decode_updates_v1(jnp.asarray(buf), jnp.asarray(lens), 4, 4, n_steps=96)
    t_stream = tbd.UpdateBatch(*(torch.from_numpy(np.array(a)) for a in j_stream))
    j_rows, j_dels = jik.pack_stream(j_stream)
    t_rows, t_dels = tik.pack_stream(t_stream)
    np.testing.assert_array_equal(np.asarray(j_rows), t_rows.numpy())
    np.testing.assert_array_equal(np.asarray(j_dels), t_dels.numpy())
    np.testing.assert_array_equal(jbd.stream_worst_case_adds(j_stream), tbd.stream_worst_case_adds(t_stream))


def test_commit_fold_wraps_like_uint32():
    rng = np.random.default_rng(3)
    client = rng.integers(-1, 1 << 31, size=(4, 257), dtype=np.int64).astype(np.int32)
    clock = rng.integers(0, 1 << 31, size=(4, 257), dtype=np.int64).astype(np.int32)
    length = rng.integers(0, 1 << 20, size=(4, 257), dtype=np.int64).astype(np.int32)
    length[:, :4] = [0, 1, 2, 3]
    valid = rng.random((4, 257)) < 0.8
    j = np.asarray(jbd.commit_fold_blocks(*(jnp.asarray(a) for a in (client, clock, length, valid))))
    t = tbd.commit_fold_blocks(*(torch.from_numpy(a) for a in (client, clock, length, valid)))
    np.testing.assert_array_equal(j.astype(np.int64), t.numpy())


def test_scan_record_helpers_match():
    w = np.arange(-1, 300, dtype=np.int32)
    np.testing.assert_array_equal(
        np.asarray(jbd.scan_width_bucket(jnp.asarray(w))), tbd.scan_width_bucket(torch.from_numpy(w)).numpy()
    )
    rng = np.random.default_rng(1)
    a = rng.integers(0, 100, size=(5, jbd.SCAN_REC_WORDS)).astype(np.int32)
    b = rng.integers(0, 100, size=(5, jbd.SCAN_REC_WORDS)).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(jbd.merge_scan_records(jnp.asarray(a), jnp.asarray(b))),
        tbd.merge_scan_records(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
    )
    for counts, mx in (([0] * 8, 0), ([5, 0, 3, 1, 0, 0, 0, 2], 300), ([0, 0, 0, 4, 0, 0, 0, 0], 9)):
        for q in (0.5, 0.99):
            assert tbd.scan_width_quantile(counts, q, mx) == jbd.scan_width_quantile(counts, q, mx)
    policy = tbd.CompactionPolicy()
    assert policy == tuple(jbd.CompactionPolicy())
    for occ, margin, cap in ((10, 5, 16), (14, 1, 16), (0, 3, 16)):
        assert policy.should_compact(occ, margin, cap) == jbd.DEFAULT_COMPACTION_POLICY.should_compact(occ, margin, cap)


@pytest.mark.parametrize("case", ["storm", "capacity_overflow", "moves"])
def test_readout_words_and_ledger_match(case):
    stream, rank, _, _ = _xla_case(case)
    rows, dels = packed_numpy(stream)
    cols, meta = run_port(*empty_packed(XLA_D, XLA_C), rows, dels, rank)
    err = np.int32(5)
    j = np.asarray(jax.jit(jik._readout_words)(jnp.asarray(cols), jnp.asarray(meta), jnp.asarray(err)))
    t_cols, t_meta = convert.packed_from_numpy(cols, meta, "cpu")
    t = tik._readout_words(t_cols, t_meta, torch.tensor(int(err), dtype=torch.int32))
    np.testing.assert_array_equal(j, t.numpy())
    j_occ, j_dead = jik.packed_capacity_ledger(jnp.asarray(cols), jnp.asarray(meta))
    t_occ, t_dead = tik.packed_capacity_ledger(t_cols, t_meta)
    np.testing.assert_array_equal(np.asarray(j_occ), t_occ.numpy())
    np.testing.assert_array_equal(np.asarray(j_dead), t_dead.numpy())
