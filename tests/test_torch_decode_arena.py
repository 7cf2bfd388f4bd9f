"""The port's arena entry of `decode_updates_v1` (``offs=``, ``width=``: the
flat wire bytes read in place, as the B4 chunk program and the ingest fast
lane call it) against the JAX package's `decode_updates_v1` on the gathered
matrix (`gather_raw_lanes`), on the CPU, with every intern table.

The lanes are the table corpus of tests/test_torch_update_decode.py (map
rows, three named roots, a 53-bit client, two clients, nested types, a
root name beyond the hash window), seeded garbage lanes and lens-cut
copies, laid into one arena with seeded garbage between and after them.
Each case swaps table contents at fixed table sizes, so ytpu traces one
program for the file. Every UpdateBatch field and every lane's flags must
be equal (tolerance 0).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

from ytpu.ops import decode_kernel as jdk  # noqa: E402

from test_torch_update_decode import TABLE_PAYLOADS, _case_tables  # noqa: E402
from ytpu_torch.ops import decode_kernel as tdk  # noqa: E402

torch.set_num_threads(1)

DIMS = dict(max_rows=8, max_dels=4, n_steps=160, max_sections=4)
SEED = 20261018
# a key no table holds: where a case drops a key it takes this one instead,
# so every case keeps the table sizes of "all"
ABSENT = 2**31 - 7


def _lanes_and_arena():
    """``(raw, offs, lens, width)``: the lanes in one arena with seeded
    garbage before, between and after them."""
    rng = np.random.default_rng(SEED)
    lanes = list(TABLE_PAYLOADS)
    lanes += [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes() for n in rng.integers(1, 40, 6)]
    lanes += [b"\x01\x01" + rng.integers(0, 256, int(n), dtype=np.uint8).tobytes() for n in rng.integers(1, 30, 6)]
    # lens-cut lanes: the full bytes in the arena, lens short of them
    items = [(p, len(p)) for p in lanes] + [(p, int(rng.integers(1, len(p)))) for p in TABLE_PAYLOADS[:6]]
    parts, offs, lens, pos = [], [], [], 0
    for p, n in items:
        gap = rng.integers(0, 256, int(rng.integers(0, 9)), dtype=np.uint8).tobytes()
        parts += [gap, p]
        offs.append(pos + len(gap))
        lens.append(n)
        pos += len(gap) + len(p)
    raw = np.frombuffer(b"".join(parts) + rng.integers(0, 256, 24, dtype=np.uint8).tobytes(), dtype=np.uint8)
    width = max(len(p) for p in lanes) + 16
    return raw.copy(), np.asarray(offs, np.int32), np.asarray(lens, np.int32), width


RAW, OFFS, LENS, WIDTH = _lanes_and_arena()
N_TABLE_LANES = len(TABLE_PAYLOADS)


def _fixed(mapping, full, size):
    """`mapping` at `size` entries: each key of `full` it lacks is replaced
    by an absent key carrying the same index, then absent keys fill the
    rest."""
    out = dict(mapping)
    for i, k in enumerate(sorted(set(full) - set(mapping))):
        out[ABSENT - i] = full[k]
    for i in range(len(full), len(full) + size - len(out)):
        out[ABSENT - i] = 0
    return out


def _case(case):
    """The ytpu and port tables of `case`, each at its largest size over
    the cases."""
    full = _case_tables("all")
    ct, kt, ht, prim = _case_tables(case)
    maps = [_fixed(m, f, n) for m, f, n in zip((ct, kt, ht), full[:3], SIZES)]
    prim = full[3] if prim is None else prim
    prim = [-1] * len(LENS) if case == "no_primary" else list(prim) + [-1] * (len(LENS) - N_TABLE_LANES)
    j, t = {}, {}
    for name, m in zip(("client_table", "key_table", "client_hash_table"), maps):
        ks = sorted(m)
        vs = [m[k] for k in ks]
        j[name] = (jnp.asarray(np.asarray(ks, np.int32)), jnp.asarray(np.asarray(vs, np.int32)))
        t[name] = (torch.tensor(ks, dtype=torch.int32), torch.tensor(vs, dtype=torch.int32))
    j["primary_root_hash"] = jnp.asarray(np.asarray(prim, np.int32))
    t["primary_root_hash"] = torch.tensor(prim, dtype=torch.int32)
    return j, t


# the flag each case must raise somewhere (0: none beyond the root name past
# the hash window, which every case with a primary root flags)
CASES = {
    "all": tdk.FLAG_UNSUPPORTED,
    "client_miss": tdk.FLAG_UNKNOWN_CLIENT,
    "hash_miss": tdk.FLAG_UNKNOWN_CLIENT,
    "key_miss": tdk.FLAG_UNKNOWN_KEY,
    "root_miss": tdk.FLAG_UNKNOWN_KEY,
    "no_primary": 0,
}
# each table's size in every case: the most entries any case needs, so
# that ytpu traces one program for the file
SIZES = [max(len(set(_case_tables(c)[i]) | set(_case_tables("all")[i])) for c in CASES) for i in range(3)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_arena_decode_matches_ytpu(case):
    jt, tt = _case(case)
    j_buf = jdk.gather_raw_lanes(jnp.asarray(RAW), jnp.asarray(OFFS), jnp.asarray(LENS), WIDTH)
    j_stream, j_flags = jdk.decode_updates_v1(j_buf, jnp.asarray(LENS), **DIMS, **jt)
    t_stream, t_flags = tdk.decode_updates_v1(torch.from_numpy(RAW), torch.from_numpy(LENS), **DIMS, **tt,
                                              offs=torch.from_numpy(OFFS), width=WIDTH)
    for name in j_stream._fields:
        np.testing.assert_array_equal(np.asarray(getattr(j_stream, name)), getattr(t_stream, name).numpy(),
                                      err_msg=name)
    np.testing.assert_array_equal(np.asarray(j_flags), t_flags.numpy())
    flags = t_flags.numpy()
    want = CASES[case]
    if want:
        assert np.bitwise_or.reduce(flags[:N_TABLE_LANES]) & want
    assert (flags[N_TABLE_LANES:] & tdk.FLAG_MALFORMED).any()  # garbage and cut lanes
    ok = (flags & tdk.FLAG_ERRORS) == 0
    assert t_stream.valid.numpy()[ok].any() and not t_stream.valid.numpy()[~ok].any()


def test_arena_entry_is_the_gathered_matrix():
    """On the CPU the arena entry is `gather_raw_lanes` then the matrix
    entry, field for field."""
    _, tt = _case("all")
    raw, offs, lens = torch.from_numpy(RAW), torch.from_numpy(OFFS), torch.from_numpy(LENS)
    a_stream, a_flags = tdk.decode_updates_v1(raw, lens, **DIMS, **tt, offs=offs, width=WIDTH)
    m_stream, m_flags = tdk.decode_updates_v1(tdk.gather_raw_lanes(raw, offs, lens, WIDTH), lens, **DIMS, **tt)
    for a, m in zip(a_stream, m_stream):
        assert torch.equal(a, m)
    assert torch.equal(a_flags, m_flags)


def test_decode_refuses_other_devices():
    buf = torch.zeros((2, 8), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tdk.decode_updates_v1(buf, torch.zeros(2, dtype=torch.int32, device="meta"), 1, 1)
