"""The port's Mosaic ladder (`ytpu_torch.benches.mosaic_ladder`) against the
JAX package's ladder (`benches/mosaic_ladder.py`) on the CPU.

The Pallas bodies of rungs 0-7 are closures inside the bench's `main()`,
and running the bench would overwrite a committed file, so this file
holds a verbatim copy of each body (file and line beside it) and runs it
through `pl.pallas_call(..., interpret=True)` on the same numpy inputs as
the port's plain version: the rung's own input and a seeded one. A guard
asserts that every copy still occurs, re-indented, in the bench's text.
Rungs 8-10 hold the port's `apply_update_stream_fused` (plain integrate on
CPU tensors) against the JAX one in interpret mode on cols (all planes but
the stale origin_slot cache), meta words 0-3 and text. The ladder's logs
are committed as ``ytpu_torch/benches/data/ladder_logs.json``; a test
regenerates them with ytpu's `Doc` through the bench's own `replay` and
asserts equal bytes (``python tests/test_torch_ladder.py`` rewrites the
file). Every comparison is exact: the data are int32.
"""

import inspect
import json
import os
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

# run as a script (to rewrite the logs), the repo root is not on the path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ytpu.core.doc import Doc
from ytpu.models.batch_doc import get_string as jax_get_string
from ytpu.models.batch_doc import init_state as jax_init_state
from ytpu.ops import decode_kernel as jdk
from ytpu.ops import integrate_kernel as jik

from ytpu_torch.benches import mosaic_ladder as tml
from ytpu_torch.models.batch_doc import get_string, init_state
from ytpu_torch.ops import decode_kernel as tdk
from ytpu_torch.ops import integrate_kernel as tik

from _fused_interpret import run_or_skip
from test_torch_integrate import pad_stream

# one intra-op thread: these cases are op-bound, and the suite runs
# several test processes side by side
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benches", "mosaic_ladder.py")
I32 = jnp.int32
DB, C = 8, 256
OS = tik.OS

# --- verbatim copies of the Pallas bodies of benches/mosaic_ladder.py -----------------


def _r0():  # benches/mosaic_ladder.py:98-99
    def k(x_ref, o_ref):
        o_ref[...] = x_ref[...] + 1

    return k


def _r1():  # benches/mosaic_ladder.py:111-115
    def k(x_ref, o_ref):
        iota_c = jax.lax.broadcasted_iota(I32, (1, C), 1)
        idx = x_ref[:, 0][:, None]  # (DB, 1)
        oh = (iota_c == idx).astype(I32)
        o_ref[...] = x_ref[...] * (1 - oh) + 7 * oh

    return k


def _r2():  # benches/mosaic_ladder.py:127-130
    def k(x_ref, o_ref):
        mask = x_ref[:, 0] > 2  # (DB,) i1
        m2 = mask.astype(I32)[:, None] > 0  # (DB, 1) — Mosaic r3 fix path
        o_ref[...] = jnp.where(m2, x_ref[...], -x_ref[...])

    return k


def _r3():  # benches/mosaic_ladder.py:144-149
    def k(x_ref, o_ref):
        def body(i, acc):
            return acc + jnp.sum(x_ref[:, i])

        total = jax.lax.fori_loop(0, 16, body, jnp.int32(0))
        o_ref[...] = jnp.full((DB, C), total, I32)

    return k


def _r4():  # benches/mosaic_ladder.py:161-179
    def k(x_ref, o_ref):
        iota_c = jax.lax.broadcasted_iota(I32, (1, C), 1)

        def cond(carry):
            o, brk, _ = carry
            return jnp.any((o < 12) & (brk == 0))

        def body(carry):
            o, brk, acc = carry
            oh = ((iota_c == o[:, None]) & (brk[:, None] == 0)).astype(I32)
            acc = acc + jnp.sum(oh * x_ref[...], axis=1)
            brk = brk | (acc > 40).astype(I32)
            return o + 1, brk, acc

        o0 = jnp.zeros((DB,), I32)
        _, _, acc = jax.lax.while_loop(
            cond, body, (o0, jnp.zeros((DB,), I32), jnp.zeros((DB,), I32))
        )
        o_ref[...] = jnp.tile(acc[:, None], (1, C))

    return k


def _r5():  # benches/mosaic_ladder.py:190-198
    def k(x_ref, o_ref):
        def outer(s, acc):
            def inner(u, a):
                return a + x_ref[0, (s * 4 + u) % C]

            return jax.lax.fori_loop(0, 4, inner, acc)

        total = jax.lax.fori_loop(0, 8, outer, jnp.int32(0))
        o_ref[...] = jnp.full((DB, C), total, I32)

    return k


def _r6():  # benches/mosaic_ladder.py:209-215
    def k(x_ref, o_ref):
        o_ref[...] = x_ref[...]
        do = x_ref[:, 0] > 100

        @pl.when(jnp.any(do))
        def _():
            o_ref[...] = x_ref[...] + 1

    return k


def _r7():  # benches/mosaic_ladder.py:228-229
    def k(x_ref, o_ref):
        o_ref[...] = x_ref[...] * 2

    return k


def _replay_factory():  # benches/mosaic_ladder.py:254-273
    def replay(n_ops, with_moves=False):
        doc = Doc(client_id=1)
        log = []
        doc.observe_update_v1(lambda p, o, t: log.append(p))
        if with_moves:
            arr = doc.get_array("text")
            with doc.transact() as txn:
                for i in range(8):
                    arr.insert(txn, i, f"e{i}")
            for i in range(min(n_ops, 6)):
                with doc.transact() as txn:
                    arr.move_to(txn, i % 4, (i + 3) % 6)
            expect = None
        else:
            txt = doc.get_text("text")
            for i in range(n_ops):
                with doc.transact() as txn:
                    txt.insert(txn, i % max(1, min(i, 40)), f"w{i % 7}")
            expect = txt.get_string()
        return log, expect

    return replay


BODIES = {"0_copy": _r0, "1_onehot_put": _r1, "2_mrow_mask": _r2, "3_fori_carry": _r3,
          "4_while_scan": _r4, "5_nested_fori": _r5, "6_pl_when": _r6, "7_big_tile": _r7}
LOG_RUNGS = (("8_kernel_s1", (1,)), ("9_kernel_quick", (200,)), ("10_kernel_moves", (6, True)))


def occurs_in(src: str, text: str) -> bool:
    """`src` (dedented) occurs in `text` at some indentation."""
    return any(textwrap.indent(src, " " * n) in text for n in range(0, 17, 4))


@pytest.mark.parametrize("factory", [*BODIES.values(), _replay_factory],
                         ids=[*BODIES, "replay"])
def test_copied_bodies_are_verbatim(factory):
    src = textwrap.dedent(inspect.getsource(factory()))
    with open(BENCH) as f:
        assert occurs_in(src, f.read())


# --- rungs 0-7: the plain version against the Pallas body ------------------------------


def jax_inputs(name):
    """The JAX rung's own input, as numpy."""
    rows = np.tile(np.arange(DB, dtype=np.int32)[:, None], (1, C))
    return {
        "0_copy": np.zeros((DB, C), np.int32),
        "1_onehot_put": rows,
        "2_mrow_mask": rows,
        "3_fori_carry": np.ones((DB, C), np.int32),
        "4_while_scan": np.tile(np.arange(C, dtype=np.int32)[None, :], (DB, 1)),
        "5_nested_fori": np.ones((DB, C), np.int32),
        "6_pl_when": np.zeros((DB, C), np.int32),
        "7_big_tile": np.ones(tml.BIG_SHAPE, np.int32),
    }[name]


def seeded_inputs(name, seed=7):
    """A seeded input that reaches every branch of the rung (int32 wraps,
    out-of-range one-hot indices, rows breaking at different steps, a
    firing guard)."""
    rng = np.random.default_rng(seed)
    shape = tml.BIG_SHAPE if name == "7_big_tile" else (DB, C)
    full = rng.integers(-(2**31), 2**31, size=shape, dtype=np.int64).astype(np.int32)
    if name == "1_onehot_put":
        full[:, 0] = rng.integers(-2, C + 2, size=DB)
    elif name == "2_mrow_mask":
        full = rng.integers(-10, 10, size=shape).astype(np.int32)
    elif name == "4_while_scan":
        full = rng.integers(0, 12, size=shape).astype(np.int32)
    elif name == "6_pl_when":
        full[:, 0] = rng.integers(-50, 100, size=DB)
        full[3, 0] = 101
    return full


@pytest.mark.parametrize("source", ["jax_input", "seeded"])
@pytest.mark.parametrize("name", list(BODIES))
def test_rung_plain_matches_pallas_body(name, source):
    x = jax_inputs(name) if source == "jax_input" else seeded_inputs(name)
    want = np.asarray(pl.pallas_call(
        BODIES[name](), out_shape=jax.ShapeDtypeStruct(x.shape, I32), interpret=True
    )(jnp.asarray(x)))
    wrapper = {n: fn for n, fn, *_ in tml.RUNGS}[name]
    got = wrapper(torch.from_numpy(x.copy()))  # a CPU tensor: the plain version
    np.testing.assert_array_equal(got.numpy(), want)
    case = {c.name: c for c in tml.CASES}[wrapper.__name__]
    np.testing.assert_array_equal(case.plain(torch.from_numpy(x.copy())).numpy(), want)
    assert case.bound_bytes((torch.from_numpy(x),)) > 0


def test_rung_asserts_hold_on_the_plain_versions():
    for name, fn, _, make, jax_assert, _line in tml.RUNGS:
        if jax_assert is not None:
            assert jax_assert(fn(make("cpu"))), name
    # the values of the rungs that assert nothing
    assert int(tml.rung4_while_scan(jax_and_cpu("4_while_scan")).max()) == 45
    assert int(tml.rung5_nested_fori(jax_and_cpu("5_nested_fori")).max()) == 32


def jax_and_cpu(name):
    return torch.from_numpy(jax_inputs(name))


def test_wrappers_check_their_arguments():
    with pytest.raises(TypeError):
        tml.rung0_copy(torch.zeros((DB, C), dtype=torch.int64))
    with pytest.raises(ValueError):
        tml.rung3_fori_carry(torch.zeros((DB, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        tml.rung4_while_scan(torch.zeros((300, C), dtype=torch.int32))
    with pytest.raises(ValueError):
        tml.rung7_big_tile(torch.zeros((DB, C), dtype=torch.int32))


@pytest.mark.parametrize("name", ["rung4_while_scan", "rung5_nested_fori"])
def test_chip_smoke_scan_sum_variants(name):
    """`chip_smoke._variants` for rungs 4 and 5, made here on the CPU: the
    program's input, the seeded one, the seeded one one int off 16 bytes,
    then (rung 4) the full range and 11 columns, or (rung 5) 3 x 11, 5 x 31
    and 8 x 31; each runs through the wrapper as the plain version does."""
    import chip_smoke

    case = next(c for c in tml.CASES if c.name == name)
    variants = chip_smoke._variants(case, case.inputs("cpu"), 11)
    xs = [inputs[0] for inputs, make_kw in variants]
    assert all(make_kw() == {} for _, make_kw in variants)
    assert [x.data_ptr() % 16 for x in xs[:3]] == [0, 0, 4]
    assert torch.equal(xs[1], xs[2])
    if name == "rung4_while_scan":
        assert [tuple(x.shape) for x in xs] == [(DB, C)] * 4 + [(DB, 11)] * 2
        assert 0 <= int(xs[1].min()) and int(xs[1].max()) < 12 and 0 <= int(xs[4].min())
        assert int(xs[3].min()) < -(2**30) and int(xs[3].max()) > 2**30
        # rows of the seeded input break at different steps
        assert len(set(tml.while_scan_plain(xs[1])[:, 0].tolist())) > 1
    else:
        assert [tuple(x.shape) for x in xs] == [(DB, C)] * 3 + [(3, 11), (5, 31), (DB, 31)]
    for x in xs:
        assert torch.equal(case.fn(x.clone()), case.plain(x.clone()))


@pytest.mark.parametrize("name", ["rung1_onehot_put", "rung3_fori_carry"])
def test_chip_smoke_row_carry_variants(name):
    """`chip_smoke._variants` for rungs 1 and 3, made here on the CPU: the
    program's input, the seeded one, the seeded one one int off 16 bytes,
    then (rung 1) 5 and 11 columns and 70,000 rows of 4, head indices in
    [-2, C + 2), or (rung 3) 8 x 16, 8 x 17 and 256 x 17 over the full
    range; each runs through the wrapper as the plain version does."""
    import chip_smoke

    case = next(c for c in tml.CASES if c.name == name)
    variants = chip_smoke._variants(case, case.inputs("cpu"), 11)
    xs = [inputs[0] for inputs, make_kw in variants]
    assert all(make_kw() == {} for _, make_kw in variants)
    assert [x.data_ptr() % 16 for x in xs[:3]] == [0, 0, 4]
    assert torch.equal(xs[1], xs[2])
    if name == "rung1_onehot_put":
        assert [tuple(x.shape) for x in xs] == [(DB, C)] * 3 + [(DB, 5), (DB, 11), (70000, 4)]
        for x in xs[1:]:
            heads = x[:, 0]
            assert int(heads.min()) >= -2 and int(heads.max()) < x.shape[1] + 2
        # more rows than one grid's 65,535; heads that put 7 and heads that put nothing
        assert xs[-1].shape[0] > 65535
        assert ((xs[-1][:, 0] >= 0) & (xs[-1][:, 0] < 4)).any() and (xs[-1][:, 0] >= 4).any()
    else:
        assert [tuple(x.shape) for x in xs] == [(DB, C)] * 3 + [(DB, 16), (DB, 17), (256, 17)]
        assert int(xs[-1].min()) < -(2**30) and int(xs[-1].max()) > 2**30
    for x in xs:
        assert torch.equal(case.fn(x.clone()), case.plain(x.clone()))


# --- the committed logs of rungs 8-10 ---------------------------------------------------


def ladder_logs_json() -> str:
    """The logs of rungs 8-10, generated with ytpu's `Doc` by the bench's
    `replay`, as the committed file holds them."""
    replay = _replay_factory()
    out = {}
    for name, args in LOG_RUNGS:
        log, expect = replay(*args)
        out[name] = {"log": [p.hex() for p in log], "expect": expect}
    return json.dumps(out, indent=1) + "\n"


def test_committed_ladder_logs_regenerate():
    with open(tml.LOGS) as f:
        assert f.read() == ladder_logs_json()
    logs = tml.load_ladder_logs()
    assert [len(logs[n][0]) for n, _ in LOG_RUNGS] == [1, 200, 5]


# --- rungs 8-10: the port's one-call entry point against the JAX one -------------------


@pytest.mark.parametrize("name", [n for n, _ in LOG_RUNGS])
def test_fused_apply_matches_jax_interpret(name):
    log, expect = tml.load_ladder_logs()[name]
    buf_np, lens_np = jdk.pack_updates(log)
    stream, _ = jdk.decode_updates_v1(jnp.asarray(buf_np), jnp.asarray(lens_np), max_rows=4, max_dels=8)
    # padded with invalid steps to the longest log, so that the three logs
    # share one interpret trace of the Pallas kernel
    stream = pad_stream(stream, 200)
    j_state = run_or_skip(lambda: jik.apply_update_stream_fused(
        jax_init_state(8, 512), stream, jdk.identity_rank(256), d_block=8, guard=False,
        interpret=True, refresh_cache=False,
    ))
    t_stream, _ = tdk.decode_updates_v1(
        torch.from_numpy(buf_np), torch.from_numpy(lens_np), max_rows=4, max_dels=8
    )
    t_state = tik.apply_update_stream_fused(
        init_state(8, 512, "cpu"), t_stream, tdk.identity_rank(256, "cpu")
    )
    j_cols, j_meta = (np.array(a) for a in jik.pack_state(j_state))
    t_cols, t_meta = (a.numpy() for a in tik.pack_state(t_state))
    for p in range(tik.NC):
        if p != OS:
            np.testing.assert_array_equal(t_cols[p], j_cols[p], err_msg=f"plane {p}")
    np.testing.assert_array_equal(t_meta[:, :4], j_meta[:, :4])
    assert int(t_meta[:, tik.M_ERROR].max()) == 0 and int(t_meta[:, tik.M_NBLOCKS].max()) > 0
    t_text = get_string(t_state, 0, tdk.RawPayloadView(buf_np))
    assert t_text == jax_get_string(j_state, 0, jdk.RawPayloadView(buf_np))
    if expect is not None:
        assert t_text == expect
    # the same run through the ladder's own rung function
    detail = tml.run_kernel(log, expect, "cpu")
    assert detail["n_blocks_max"] == int(t_meta[:, tik.M_NBLOCKS].max())
    assert detail["max_abs_err"] == 0


def test_refresh_cache_is_not_ported_yet():
    log, _ = tml.load_ladder_logs()["8_kernel_s1"]
    buf_np, lens_np = tdk.pack_updates(log)
    stream, _ = tdk.decode_updates_v1(torch.from_numpy(buf_np), torch.from_numpy(lens_np), 4, 8)
    with pytest.raises(NotImplementedError, match="A.7"):
        tik.apply_update_stream_fused(init_state(8, 64, "cpu"), stream, tdk.identity_rank(256, "cpu"),
                                      refresh_cache=True)


def test_run_ladder_names_each_rung_before_it_runs():
    seen = []
    state = tml.run_ladder("cpu", on_attempt=seen.append)
    assert seen == list(state["steps"]) and len(seen) == 11
    assert state["failures"] == [], state
    assert state["last_attempt"] == "10_kernel_moves"


if __name__ == "__main__":
    with open(tml.LOGS, "w") as f:
        f.write(ladder_logs_json())
