"""The port's V2 lane (`ytpu_torch.ops.decode_v2`) against the JAX package's
(`ytpu.ops.decode_v2`) on the CPU.

`pack_updates_v2` and `pack_updates_v2_raw` must give ytpu's arrays bit for
bit; the plain `decode_updates_v2` and `decode_updates_v2_raw` must give
ytpu's `decode_updates_v2` on every UpdateBatch field and every lane's
flags, on the crafted sets of ``ytpu_torch/benches/data/v2_cases.json``
(text, deletes, multi-client with Skips, map keys with the key table, big
clients with and without the hash table, every content kind with a
sidecar, truncated columns, all-zero spans, rest varints running past
their span, row / delete / section overflow and the walker's step budget,
maps nested 4 deep, mutated bytes, a section that starts before the one
ahead of it, a string length that wraps negative) and a 2,048-update B4
prefix, all
decoded together at one shape (U = 8, R = 4, 4 sections), so that ytpu
compiles its program twice (with and without the tables). The B4 prefix
then integrates (`apply_update_stream`) to the text of ytpu's host replay.
"""

import gzip
import json
import os
import pickle
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

from ytpu.core import Doc  # noqa: E402
from ytpu.ops import decode_v2 as jv2  # noqa: E402

import _torch_v2_cases as cases  # noqa: E402
from ytpu_torch.core.update import Update  # noqa: E402
from ytpu_torch.models import batch_doc as tbd  # noqa: E402
from ytpu_torch.ops import decode_v2 as tv2  # noqa: E402
from ytpu_torch.ops.decode_kernel import FLAG_ERRORS, RawPayloadView, identity_rank  # noqa: E402

torch.set_num_threads(1)

B4_LOG = os.path.join(ROOT, "benches", "data", "b4_log.pkl.gz")
B4_LANES = 2048
U, R, SEC = cases.U, cases.R, cases.SEC
DATA = json.loads(cases.DATA.read_text())
SETS = {name: [bytes.fromhex(p) for p in c["payloads"]] for name, c in DATA["sets"].items()}
NAMES = list(SETS) + ["b4_prefix"]
# bits that each set's flags (OR over its lanes, with the tables) must hold
# and must not hold: the sets exercise what they are named for
EXPECT = {
    "text": (0, FLAG_ERRORS),
    "deletes": (2, 1 | 4 | 8 | 32 | 64),
    "multi_client_skips": (16, FLAG_ERRORS),
    "map_keys": (0, FLAG_ERRORS),
    "big_clients": (0, FLAG_ERRORS),
    "content_kinds": (1, 2 | 4 | 8 | 32 | 64),
    "nested_any": (1, 2 | 4 | 8 | 32 | 64),
    "overflow": (2 | 4 | 16, 8 | 32 | 64),
    "truncated_columns": (4, 0),
    "zero_spans": (4, 0),
    "rest_past_span": (4, 0),
    "mutated": (1 | 2 | 4, 0),
    "sections_out_of_order": (16, FLAG_ERRORS),
    "wrapped_string_length": (64, 1 | 2 | 4 | 8 | 32),
    "b4_prefix": (0, FLAG_ERRORS),
}


def b4_log():
    with gzip.open(B4_LOG, "rb") as f:
        return pickle.load(f)["log"][:B4_LANES]


_RUNS = {}


def combined():
    """Every set's lanes and the B4 prefix in one batch: ``(payloads,
    name -> lane slice, port pack, ytpu pack)``, built once per process."""
    if "combined" not in _RUNS:
        payloads, slices = [], {}
        for name in NAMES:
            lanes = SETS[name] if name != "b4_prefix" else [Update.decode_v1(p).encode_v2() for p in b4_log()]
            slices[name] = slice(len(payloads), len(payloads) + len(lanes))
            payloads += lanes
        _RUNS["combined"] = (payloads, slices, tv2.pack_updates_v2(payloads), jv2.pack_updates_v2(payloads))
    return _RUNS["combined"]


def _tables(to):
    return {k: tuple(to(np.asarray(x, dtype=np.int32)) for x in v) for k, v in DATA["tables"].items()}


def decoded(variant):
    """``(port (stream, flags), ytpu (stream, flags))`` of the combined
    batch: ``tables`` with the key and big-client tables, ``no_tables``
    without, ``raw`` through `decode_updates_v2_raw` with the tables."""
    if variant not in _RUNS:
        payloads, _, tpack, jpack = combined()
        with_tables = variant != "no_tables"
        tt = _tables(torch.from_numpy) if with_tables else {}
        jt = _tables(jnp.asarray) if with_tables else {}
        kw = dict(max_rows=U, max_dels=R, max_sections=SEC)
        if variant == "raw":
            traw, jraw = tv2.pack_updates_v2_raw(payloads), jv2.pack_updates_v2_raw(payloads)
            port = tv2.decode_updates_v2_raw(torch.from_numpy(traw[0]), *traw[1:5], traw[6], sidecar=traw[5],
                                             **kw, **tt)
            ytpu = jv2.decode_updates_v2_raw(*jraw[:5], jraw[6], sidecar=jraw[5], **kw, **jt)
        else:
            buf, lens, spans, side = tpack
            port = tv2.decode_updates_v2(torch.from_numpy(buf), torch.from_numpy(lens), torch.from_numpy(spans),
                                         sidecar=side, **kw, **tt)
            ytpu = jv2.decode_updates_v2(*jpack[:3], sidecar=jpack[3], **kw, **jt)
        _RUNS[variant] = (port, ytpu)
    return _RUNS[variant]


def test_cases_file_is_current():
    """The committed sets are what tests/_torch_v2_cases.py builds."""
    assert json.loads(json.dumps(cases.to_json(cases.build_sets()))) == DATA


@pytest.mark.parametrize("name", NAMES)
def test_pack_matches_ytpu(name):
    payloads, slices, _, _ = combined()
    lanes = payloads[slices[name]]
    for got, want in ((tv2.pack_updates_v2(lanes), jv2.pack_updates_v2(lanes)),
                      (tv2.pack_updates_v2(lanes, pad_to=256), jv2.pack_updates_v2(lanes, pad_to=256)),
                      (tv2.pack_updates_v2_raw(lanes), jv2.pack_updates_v2_raw(lanes))):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            if w is None or isinstance(w, int):
                assert g == w
            else:
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("variant", ["tables", "no_tables", "raw"])
@pytest.mark.parametrize("name", NAMES)
def test_plain_decode_matches_ytpu(name, variant):
    (stream, flags), (jstream, jflags) = decoded(variant)
    sl = combined()[1][name]
    np.testing.assert_array_equal(flags.numpy()[sl], np.asarray(jflags)[sl], err_msg="flags")
    for field, got, want in zip(jstream._fields, stream, jstream):
        np.testing.assert_array_equal(got.numpy()[sl], np.asarray(want)[sl], err_msg=field)


@pytest.mark.parametrize("name", NAMES)
def test_set_flags(name):
    (_, flags), _ = decoded("tables")
    f = int(np.bitwise_or.reduce(flags.numpy()[combined()[1][name]]))
    must, must_not = EXPECT[name]
    assert f & must == must and f & must_not == 0, f


def test_tables_decide_map_and_big_client_lanes():
    """Without the tables the map rows flag FLAG_UNKNOWN_KEY and the big
    clients FLAG_BIG_CLIENT."""
    (_, flags), _ = decoded("no_tables")
    _, slices, _, _ = combined()
    assert (flags.numpy()[slices["map_keys"]] & 64).any()
    assert (flags.numpy()[slices["big_clients"]] & 8).all()


def test_b4_prefix_integrates_to_host_text():
    """decode -> `apply_update_stream` -> `get_string` of the V2 B4 prefix
    equals ytpu's host replay of the same updates."""
    (stream, flags), _ = decoded("tables")
    payloads, slices, tpack, _ = combined()
    sl = slices["b4_prefix"]
    assert not (flags[sl] & FLAG_ERRORS).any()
    part = tbd.UpdateBatch(*(a[sl] for a in stream))
    state = tbd.apply_update_stream(tbd.init_state(1, 4096, "cpu"), part, identity_rank(2, "cpu"))
    assert int(state.error.max()) == 0
    doc = Doc(client_id=99)
    for p in b4_log():
        doc.apply_update_v1(p)
    assert tbd.get_string(state, 0, RawPayloadView(tpack[0])) == doc.get_text("text").get_string()
