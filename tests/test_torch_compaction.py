"""The port's compaction (`ytpu_torch.ops.compaction`) against the JAX
package's `compact_packed` / `grow_packed` on the CPU, byte for byte, on
packed states taken from the integrate cases: text edits with tombstones,
map chains, nested parents, a same-origin storm, an overflowed doc, and a
state cut mid-stream whose live moves claim ranges the next chunk keeps
editing.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

from ytpu.ops import compaction as jcomp

from ytpu_torch.convert import packed_from_numpy, packed_to_numpy
from ytpu_torch.ops import compaction as tcomp
from ytpu_torch.ops import integrate_kernel as tik

from test_torch_integrate import (
    XLA_C,
    XLA_D,
    _xla_case,
    empty_packed,
    packed_numpy,
    run_port,
)

STATES = ["random_edits", "map_lww", "nested", "storm", "capacity_overflow", "moves_midstream"]


@functools.lru_cache(maxsize=None)
def state_of(name):
    case = "moves" if name == "moves_midstream" else name
    stream, rank, _, _ = _xla_case(case)
    rows, dels = packed_numpy(stream)
    if name == "moves_midstream":
        # cut after the moves landed, before the insert into / removal
        # from their ranges that the later steps make
        rows, dels = rows[:4], dels[:4]
    cols, meta = run_port(*empty_packed(XLA_D, XLA_C), rows, dels, rank)
    if name == "moves_midstream":
        assert (cols[tik.MV] >= 0).any()
    return cols, meta


@pytest.mark.parametrize("unit_refs,gc_ranges", [(False, False), (True, False), (False, True), (True, True)])
@pytest.mark.parametrize("name", STATES)
def test_compact_packed_matches(name, unit_refs, gc_ranges):
    cols, meta = state_of(name)
    j_cols, j_meta = jcomp.compact_packed(jnp.array(cols), jnp.array(meta), unit_refs, gc_ranges)
    t_cols, t_meta = tcomp.compact_packed(*packed_from_numpy(cols, meta, "cpu"), unit_refs, gc_ranges)
    t_cols, t_meta = packed_to_numpy(t_cols, t_meta)
    np.testing.assert_array_equal(np.asarray(j_cols), t_cols)
    np.testing.assert_array_equal(np.asarray(j_meta), t_meta)
    if gc_ranges and name == "random_edits":
        assert (t_meta[:, tik.M_NBLOCKS] < meta[:, tik.M_NBLOCKS]).all()


@pytest.mark.parametrize("new_capacity", [XLA_C, 2 * XLA_C])
def test_grow_packed_matches(new_capacity):
    cols, meta = state_of("moves_midstream")
    j_cols, j_meta = jcomp.grow_packed(jnp.array(cols), jnp.array(meta), new_capacity)
    t_cols, t_meta = tcomp.grow_packed(*packed_from_numpy(cols, meta, "cpu"), new_capacity)
    np.testing.assert_array_equal(np.asarray(j_cols), t_cols.numpy())
    np.testing.assert_array_equal(np.asarray(j_meta), t_meta.numpy())
    with pytest.raises(ValueError):
        tcomp.grow_packed(t_cols, t_meta, XLA_C // 2)


def test_compacted_state_keeps_replaying():
    """Compact mid-stream, then integrate the rest: the port and the JAX
    compaction feed the same next chunk the same state."""
    stream, rank, _, _ = _xla_case("random_edits")
    rows, dels = packed_numpy(stream)
    cols, meta = run_port(*empty_packed(XLA_D, XLA_C), rows[:12], dels[:12], rank)
    j_cols, j_meta = (np.asarray(a) for a in jcomp.compact_packed(jnp.array(cols), jnp.array(meta), True, True))
    t_cols, t_meta = tcomp.compact_packed(*packed_from_numpy(cols, meta, "cpu"), True, True)
    a = run_port(j_cols, j_meta, rows[12:], dels[12:], rank)
    b = run_port(*packed_to_numpy(t_cols, t_meta), rows[12:], dels[12:], rank)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert int(b[1][:, tik.M_ERROR].max()) == 0
