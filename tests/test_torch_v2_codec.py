"""The port's V2 update codec (`ytpu_torch.encoding.codec.EncoderV2` /
`DecoderV2` and their column compressors) and the V2 functions of
`ytpu_torch.core.update` against the JAX package on the CPU.

Each group of V1 updates (built by the JAX package's host doc in
tests/_torch_v2_cases.py: text, deletes, merged multi-client updates with
Skips, maps, 53-bit clients, every content kind with arrays and XML,
nested Any values, whole states) must give the same V2 bytes in both
packages, and the port's `Update.decode_v2` must read back what its V1
decode reads. `merge_updates_v2`, `encode_state_vector_from_update_v2` and
`diff_updates_v1` / `diff_updates_v2` must give ytpu's bytes.
"""

import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

from ytpu.core import update as jupdate  # noqa: E402
from ytpu.core.id_set import DeleteSet as JDeleteSet  # noqa: E402
from ytpu.encoding import codec as jcodec  # noqa: E402

import _torch_v2_cases as cases  # noqa: E402
from ytpu_torch.core import update as tupdate  # noqa: E402
from ytpu_torch.core.id_set import DeleteSet  # noqa: E402
from ytpu_torch.encoding import codec as tcodec  # noqa: E402

JU, TU = jupdate.Update, tupdate.Update

GROUPS = {
    "text": cases._text,
    "deletes": cases._deletes,
    "multi_client_skips": cases._multi_client_skips,
    "map": cases._map_keys,
    "big_clients": cases._big_clients,
    "content_kinds": lambda: [JU.decode_v2(p).encode_v1() for p in cases._content_kinds()],
    "nested_any": cases._nested_any,
    "whole_states": cases._overflow,
}
_BUILT = {}


def group(name):
    """The group's V1 updates, built once per process."""
    if name not in _BUILT:
        _BUILT[name] = GROUPS[name]()
    return _BUILT[name]


@pytest.mark.parametrize("name", list(GROUPS))
def test_encode_v2_matches_ytpu(name):
    for i, p in enumerate(group(name)):
        assert TU.decode_v1(p).encode_v2() == JU.decode_v1(p).encode_v2(), i


@pytest.mark.parametrize("name", list(GROUPS))
def test_decode_v2_reads_what_v1_reads(name):
    """The port's V2 decode of ytpu's V2 bytes holds the same blocks and
    delete set as the port's V1 decode of the V1 form (compared through
    their V1 encodings and their state vectors), and ytpu's V2 decode."""
    for i, p in enumerate(group(name)):
        v2 = JU.decode_v1(p).encode_v2()
        got, want = TU.decode_v2(v2), TU.decode_v1(p)
        assert got.encode_v1() == want.encode_v1() == JU.decode_v2(v2).encode_v1(), i
        assert got.state_vector() == want.state_vector(), i
        assert got.delete_set == want.delete_set, i
        assert got.encode_v2() == v2, i


@pytest.mark.parametrize("name", list(GROUPS))
def test_merge_updates_v2_matches_ytpu(name):
    v1 = group(name)
    v2 = [JU.decode_v1(p).encode_v2() for p in v1]
    assert tupdate.merge_updates_v2(v2) == jupdate.merge_updates_v2(v2)
    assert tupdate.merge_updates_v1(v1) == jupdate.merge_updates_v1(v1)


@pytest.mark.parametrize("name", list(GROUPS))
def test_state_vector_from_update_matches_ytpu(name):
    for i, p in enumerate(group(name)):
        v2 = JU.decode_v1(p).encode_v2()
        assert tupdate.encode_state_vector_from_update_v2(v2) == jupdate.encode_state_vector_from_update_v2(v2), i


@pytest.mark.parametrize("name", list(GROUPS))
def test_diff_updates_match_ytpu(name):
    """Each update diffed against the state vector of the group's first
    half merged (and against the empty one)."""
    v1 = group(name)
    half = jupdate.merge_updates_v1(v1[: max(1, len(v1) // 2)])
    svs = [jupdate.encode_state_vector_from_update_v1(half), b"\x00"]
    for i, p in enumerate(v1):
        v2 = JU.decode_v1(p).encode_v2()
        for sv in svs:
            assert tupdate.diff_updates_v1(p, sv) == jupdate.diff_updates_v1(p, sv), i
            assert tupdate.diff_updates_v2(v2, sv) == jupdate.diff_updates_v2(v2, sv), i


# --- the column compressors ---------------------------------------------------------


def _values(kind, rng):
    """Seeded value columns with runs, repeats, zeros and big values."""
    if kind == "rle":
        return [int(v) for v in np.repeat(rng.integers(0, 256, 40), rng.integers(1, 6, 40))]
    runs = np.repeat(rng.integers(0, 1 << 20, 30), rng.integers(1, 5, 30))
    vals = [int(v) for v in runs] + [0, 0, 0, (1 << 53) - 1, 1 << 40, 7]
    if kind == "intdiff":
        vals += list(range(100, 140, 3)) + list(range(90, 40, -7))
    return vals


COMPRESSORS = {
    "uintoptrle": ("_UIntOptRleEncoder", "write_u64", "_UIntOptRleDecoder", "read_u64"),
    "intdiff": ("_IntDiffOptRleEncoder", "write_u32", "_IntDiffOptRleDecoder", "read_u32"),
    "rle": ("_RleEncoder", "write_u8", "_RleDecoder", "read_u8"),
}


@pytest.mark.parametrize("kind", list(COMPRESSORS))
def test_column_compressor_matches_ytpu(kind):
    enc_name, write, dec_name, read = COMPRESSORS[kind]
    vals = _values(kind, np.random.default_rng(18))
    encs = [getattr(mod, enc_name)() for mod in (tcodec, jcodec)]
    for v in vals:
        for e in encs:
            getattr(e, write)(v)
    data = encs[0].to_bytes()
    assert data == encs[1].to_bytes()
    dec = getattr(tcodec, dec_name)(data)
    assert [getattr(dec, read)() for _ in vals] == vals


def test_string_column_matches_ytpu():
    strings = ["", "a", "héllo", "π🙂x", "🙂🙂", "plain text", ""]
    t, j = tcodec._StringEncoder(), jcodec._StringEncoder()
    for s in strings:
        t.write(s)
        j.write(s)
    data = t.to_bytes()
    assert data == j.to_bytes()
    dec = tcodec._StringDecoder(data)
    assert [dec.read_str() for _ in strings] == strings


def test_delete_set_rides_the_v2_ds_channel():
    """`DeleteSet.encode` / `decode` take the V2 encoder's delete-set
    channel (clock diffs and lengths - 1 in the rest stream) unchanged."""
    ranges = {5: [(0, 3), (7, 8), (20, 31)], 1 << 40: [(2, 4)], 9: [(100, 101)]}
    t, j = DeleteSet(), JDeleteSet()
    for c, rs in ranges.items():
        for a, b in rs:
            t.insert_range(c, a, b)
            j.insert_range(c, a, b)
    te, je = tcodec.EncoderV2(), jcodec.EncoderV2()
    t.encode(te)
    j.encode(je)
    data = te.to_bytes()
    assert data == je.to_bytes()
    assert DeleteSet.decode(tcodec.DecoderV2(data)) == t
