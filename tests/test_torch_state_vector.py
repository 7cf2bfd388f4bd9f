"""The port's state-vector math and origin-slot cache against the JAX
package on the CPU: the `sv_*` functions on seeded clock tensors,
`state_vectors` and `state_capacity_ledger` on an integrated state, and
`recompute_origin_slot` on a fused-lane state that holds map, nested,
move and split rows. Tolerance: none, every output is an integer tensor
and must be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ytpu.models import batch_doc as jbd
from ytpu.ops import state_vector as jsv

from ytpu_torch.benches.streams import anchored_state, synthetic_stream
from ytpu_torch.models import batch_doc as tbd
from ytpu_torch.ops import integrate_kernel as tik
from ytpu_torch.ops import state_vector as tsv

from _torch_sync_cases import to_jax_state

torch.set_num_threads(1)

D, C, N_CLIENTS = 3, 256, 8


def clocks(seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 9, size=(4, 16)).astype(np.int32)


@pytest.mark.parametrize("name", ["sv_merge", "sv_contains_all", "sv_diff_mask", "diff_start_clocks"])
def test_sv_ops_match_jax(name):
    a, b = clocks(1), clocks(2)
    b[1] = a[1]  # one doc where neither side is ahead
    want = np.array(getattr(jsv, name)(jnp.asarray(a), jnp.asarray(b)))
    got = getattr(tsv, name)(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_sv_from_blocks_matches_jax():
    """Unused rows (-1), clients past the table (dropped) and a client
    with no rows (0)."""
    rng = np.random.default_rng(3)
    client = rng.integers(-1, N_CLIENTS + 3, size=(4, 64)).astype(np.int32)
    client[:, :] = np.where(client == 4, 5, client)
    clock = rng.integers(0, 50, size=(4, 64)).astype(np.int32)
    length = rng.integers(1, 5, size=(4, 64)).astype(np.int32)
    want = np.array(jsv.sv_from_blocks(*map(jnp.asarray, (client, clock, length)), N_CLIENTS))
    got = tsv.sv_from_blocks(*map(torch.from_numpy, (client, clock, length)), N_CLIENTS).numpy()
    assert np.array_equal(got, want)
    assert (got[:, 4] == 0).all()


def stream_batch(rows, dels) -> tbd.UpdateBatch:
    """The `UpdateBatch` that `pack_stream` packs to `rows` / `dels`."""
    r, d = torch.from_numpy(rows), torch.from_numpy(dels)
    cols = dict(zip(
        ("client", "clock", "length", "origin_client", "origin_clock", "ror_client", "ror_clock",
         "kind", "content_ref", "content_off", "key", "p_tag", "p_client", "p_clock", "valid",
         "mv_sc", "mv_sk", "mv_sa", "mv_ec", "mv_ek", "mv_ea", "mv_prio", "p_root"),
        r.unbind(-1),
    ))
    cols["valid"] = cols["valid"] != 0
    return tbd.UpdateBatch(**cols, del_client=d[..., 0], del_start=d[..., 1], del_end=d[..., 2],
                           del_valid=d[..., 3] != 0)


@pytest.fixture(scope="module")
def fused_state():
    """3 docs, each warmed by its own synthetic stream, then one shared
    stream through the fused lane: string, GC, deleted, format, nested,
    map and move rows, splits, gaps and a root anchor."""
    cols, meta = anchored_state(D, C, "cpu")
    rank = torch.from_numpy(np.random.default_rng(11).permutation(256).astype(np.int32))
    for d in range(D):
        wr, wd = synthetic_stream(100 + d, 6)
        c1, m1 = cols[:, d : d + 1].clone(), meta[d : d + 1].clone()
        tik.integrate_stream_reference(c1, m1, torch.from_numpy(wr), torch.from_numpy(wd), rank)
        cols[:, d : d + 1], meta[d : d + 1] = c1, m1
    state = tik.unpack_state(cols, meta)
    out = tik.apply_update_stream_fused(state, stream_batch(*synthetic_stream(7, 40)), rank)
    assert tbd.origin_slot_is_stale(out)
    return out


def test_fused_state_holds_every_row_kind(fused_state):
    bl = fused_state.blocks
    n = int(fused_state.n_blocks.max())
    live = torch.arange(bl.client.shape[1])[None, :] < fused_state.n_blocks[:, None]
    assert n > 100
    assert bool(((bl.key >= 0) & live).any()) and bool(((bl.kind == 11) & live).any())
    assert bool(((bl.parent >= 0) & live).any())


def test_recompute_origin_slot_matches_jax(fused_state):
    want = jbd.recompute_origin_slot(to_jax_state(fused_state))
    got = tbd.recompute_origin_slot(fused_state)
    assert np.array_equal(got.blocks.origin_slot.numpy(), np.array(want.blocks.origin_slot))
    # the rebuild found origins, and rows past n_blocks hold -1
    os_ = got.blocks.origin_slot
    assert int((os_ >= 0).sum()) > 50
    assert bool((os_[0, int(fused_state.n_blocks[0]) :] == -1).all())


def test_ensure_origin_slot_rebuilds_a_stale_state_only(fused_state):
    fresh = tbd.ensure_origin_slot(fused_state)
    assert fresh is not fused_state and not tbd.origin_slot_is_stale(fresh)
    assert tbd.ensure_origin_slot(fresh) is fresh


def test_state_vectors_match_jax(fused_state):
    n = 6000  # past the largest client (5000) of the synthetic stream
    want = np.array(jbd.state_vectors(to_jax_state(fused_state), n))
    got = tbd.state_vectors(fused_state, n).numpy()
    assert np.array_equal(got, want)
    assert got[:, 5000].max() > 0


def test_state_capacity_ledger_matches_jax(fused_state):
    want = jbd.state_capacity_ledger(to_jax_state(fused_state))
    got = tbd.state_capacity_ledger(fused_state)
    for w, g in zip(want, got):
        assert np.array_equal(g.numpy(), np.array(w))
    assert int(got[1].sum()) > 0
