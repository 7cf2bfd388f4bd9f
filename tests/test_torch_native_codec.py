"""The port's host C++ column walk (`ytpu_torch.native`) on the CPU:

- against ytpu's native walk (`ytpu.native.decode_update_columns`): every
  column, every count and `error`, on every payload, malformed ones too
  (both keep the columns read before the fault, the block they failed in
  included);
- against the port's Python walk (`encoding.lib0.update_columns`, the plain
  version): every column, count and span on well-formed payloads; on a
  malformed one the same `error`, and the Python walk's columns are the
  native walk's without the block or delete range it failed in;
- the batch entry against one call per payload, with malformed payloads in
  the middle of the batch.

Corpora: B4's first 2,048 updates, the committed ingest logs
(`ytpu_torch/benches/data/ingest_logs.json`), the intern-table payloads of
tests/test_torch_update_decode.py, the decode corpus of
tests/_torch_ingest_cases.py, a 53-bit client, varints past 2^63 and
2^64, the empty payload, truncated, garbage and 512 mutated payloads.
Tolerance: none, the columns are int64 and must be equal. One g++ build of
the host library per session (hash-keyed under ``ytpu_torch/_build/``)."""

import gzip
import os
import pickle
import random
import sys
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import ytpu.native as ytpu_native  # noqa: E402

import _torch_ingest_cases as cases  # noqa: E402
from ytpu_torch import native  # noqa: E402
from ytpu_torch.benches.ingest import load_ingest_logs  # noqa: E402
from ytpu_torch.encoding.lib0 import BLOCK_COLUMNS, DEL_COLUMNS, Writer, update_columns  # noqa: E402

COUNTS = native.COUNT_NAMES


def _varint_update(client: int, clock: int, ds_client: int, ds_start: int) -> bytes:
    """One String block of `client` at `clock` under root "text", then a
    delete range of `ds_client` from `ds_start`."""
    w = Writer()
    w.write_var_uint(1)
    w.write_var_uint(1)
    w.write_var_uint(client)
    w.write_var_uint(clock)
    w.write_u8(4)
    w.write_var_uint(1)
    w.write_string("text")
    w.write_string("hi")
    w.write_var_uint(1)
    w.write_var_uint(ds_client)
    w.write_var_uint(1)
    w.write_var_uint(ds_start)
    w.write_var_uint(3)
    return w.to_bytes()


def _edge_payloads():
    """A 53-bit client; varints past 2^63 (client, clock, delete range); a
    ten-byte clock varint carrying bits past 2^64; an eleven-byte one; the
    empty payload."""
    big = (1 << 53) - 1
    base = _varint_update(2, 0, 1, 0)  # byte 3 is the clock varint
    return [
        _varint_update(big, 5, big, 1),
        _varint_update((1 << 63) + 7, 1, 3, (1 << 63) + 2),
        _varint_update(9, (1 << 64) - 3, (1 << 64) - 1, 4),
        base[:3] + b"\xff" * 9 + b"\x7f" + base[4:],
        base[:3] + b"\xff" * 10 + b"\x01" + base[4:],
        b"",
    ]


def _malformed(seed_payloads):
    """Truncations of each seed at several cuts, garbage, and 512 mutations
    (a byte flipped, dropped or repeated) of the seeds."""
    rng = random.Random(16)
    out = []
    for p in seed_payloads:
        for cut in sorted({1, len(p) // 3, len(p) // 2, len(p) - 1}):
            if 0 < cut < len(p):
                out.append(p[:cut])
    out += [bytes(rng.randrange(256) for _ in range(rng.randint(1, 40))) for _ in range(32)]
    out += [b"\x01", b"\x80", b"\xff" * 12, b"\x01\x01\x05\x00\x0f"]
    for _ in range(512):
        p = bytearray(rng.choice(seed_payloads))
        i = rng.randrange(len(p))
        op = rng.randrange(3)
        if op == 0:
            p[i] = rng.randrange(256)
        elif op == 1:
            del p[i]
        else:
            p[i:i] = p[i:i + 1]
        out.append(bytes(p))
    return out


def _b4(n: int):
    with gzip.open(os.path.join(ROOT, "benches", "data", "b4_log.pkl.gz"), "rb") as f:
        return pickle.load(f)["log"][:n]


def _table_payloads():
    from test_torch_update_decode import TABLE_PAYLOADS

    return list(TABLE_PAYLOADS)


CORPORA = {
    "b4_2048": lambda: _b4(2048),
    "ingest_logs": lambda: [p for v in load_ingest_logs().values() for p in v["log"]],
    "table_payloads": _table_payloads,
    "wire_corpus": lambda: list(cases.wire_corpus()),
    "edges": _edge_payloads,
    "malformed": lambda: _malformed(_b4(64) + list(cases.wire_corpus())[:16] + _edge_payloads()[:3]),
}


@pytest.fixture(scope="module")
def corpora():
    return {name: make() for name, make in CORPORA.items()}


@pytest.fixture(scope="module")
def ytpu_walk():
    """ytpu's native walk, its library loaded again if this worker lost a
    build race with another (ytpu builds straight to its final path)."""
    for _ in range(5):
        if ytpu_native.load() is not None:
            return ytpu_native.decode_update_columns
        ytpu_native._tried = False
        time.sleep(1.0)
    pytest.fail("ytpu's native library did not load")


def _columns_equal(a, b, what):
    for name in COUNTS:
        assert getattr(a, name) == getattr(b, name), (what, name)
    for name in BLOCK_COLUMNS + DEL_COLUMNS:
        got, want = getattr(a, name), getattr(b, name)
        assert got.dtype == np.int64 and want.dtype == np.int64, (what, name)
        np.testing.assert_array_equal(got, want, err_msg=f"{what}: {name}")


@pytest.mark.parametrize("corpus", list(CORPORA))
def test_native_walk_matches_ytpu_native(corpora, ytpu_walk, corpus):
    payloads = corpora[corpus]
    walked = native.decode_update_columns_batch(payloads)
    assert len(walked) == len(payloads)
    for i, (p, got) in enumerate(zip(payloads, walked)):
        want = ytpu_walk(p)
        _columns_equal(got, want, f"{corpus}[{i}]")
        for j in range(got.n_blocks):
            if got.content_start[j] >= 0:
                assert got.content_bytes(j) == want.content_bytes(j)


@pytest.mark.parametrize("corpus", list(CORPORA))
def test_native_walk_matches_python_walk(corpora, corpus):
    payloads = corpora[corpus]
    n_error = 0
    for i, (p, got) in enumerate(zip(payloads, native.decode_update_columns_batch(payloads))):
        want = update_columns(p)
        assert got.error == want.error, i
        if got.error:
            n_error += 1
            # the Python walk drops the block (or delete range) it failed in
            assert got.n_blocks - want.n_blocks in (0, 1) and got.n_dels - want.n_dels in (0, 1), i
            for name in BLOCK_COLUMNS:
                np.testing.assert_array_equal(getattr(got, name)[:want.n_blocks], getattr(want, name))
            for name in DEL_COLUMNS:
                np.testing.assert_array_equal(getattr(got, name)[:want.n_dels], getattr(want, name))
            continue
        _columns_equal(got, want, f"{corpus}[{i}]")
        for j in range(got.n_blocks):  # the spans, read through each object's payload
            assert got.content_bytes(j) == want.content_bytes(j)
            for start, n in (("parent_name_start", "parent_name_len"), ("parent_sub_start", "parent_sub_len")):
                s, ln = int(getattr(got, start)[j]), int(getattr(got, n)[j])
                assert got.span(s, ln) == want.span(s, ln)
    if corpus == "malformed":
        assert n_error > 400
    elif corpus in ("b4_2048", "ingest_logs", "table_payloads"):
        assert n_error == 0


@pytest.mark.parametrize("corpus", ["malformed", "wire_corpus", "edges"])
def test_batch_equals_single_calls(corpora, corpus):
    """One call over all payloads, good and malformed interleaved, equals
    one call per payload."""
    payloads = corpora[corpus] + corpora["b4_2048"][:64]
    random.Random(3).shuffle(payloads)
    walked = native.decode_update_columns_batch(payloads)
    errors = [c.error for c in walked]
    assert any(errors) and not all(errors)
    for i, (p, got) in enumerate(zip(payloads, walked)):
        _columns_equal(got, native.decode_update_columns(p), f"{corpus}[{i}]")
        assert got.payload == p


def test_batch_arrays_and_empty_batch(corpora):
    payloads = corpora["b4_2048"][:100]
    walked = native.decode_update_columns_batch(payloads)
    assert walked.blocks.shape == (len(BLOCK_COLUMNS), int(walked.block_off[-1]))
    assert walked.dels.shape == (len(DEL_COLUMNS), int(walked.del_off[-1]))
    assert walked.arena == b"".join(payloads)
    np.testing.assert_array_equal(walked.offs, np.cumsum([0] + [len(p) for p in payloads[:-1]]))
    kinds = np.concatenate([update_columns(p).kind for p in payloads])
    np.testing.assert_array_equal(walked.blocks[BLOCK_COLUMNS.index("kind")], kinds)
    empty = native.decode_update_columns_batch([])
    assert len(empty) == 0 and empty.blocks.shape == (len(BLOCK_COLUMNS), 0)


def test_edge_values(corpora):
    """The 53-bit client reads back whole; varints past 2^63 read as their
    low 64 bits in two's complement, as ytpu's walk stores them, a ten-byte
    varint too; an eleven-byte varint is an error."""
    big, past63, past64, ten, eleven, empty = native.decode_update_columns_batch(corpora["edges"])
    assert int(big.client[0]) == (1 << 53) - 1 and int(big.del_client[0]) == (1 << 53) - 1
    assert int(past63.client[0]) == (1 << 63) + 7 - (1 << 64)
    assert int(past63.del_start[0]) == (1 << 63) + 2 - (1 << 64)
    assert int(past64.clock[0]) == -3 and int(past64.del_client[0]) == -1
    assert int(ten.clock[0]) == -1
    assert not any(c.error for c in (big, past63, past64, ten))
    assert eleven.error
    assert empty.error and empty.n_blocks == 0 and empty.n_client_sections == 0
