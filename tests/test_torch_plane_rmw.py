"""The port's plane read-modify-write repros (`ytpu_torch.benches.
plane_rmw_repro{,2,3}`) against the JAX package's (`benches/plane_rmw_repro
{,2,3}.py`) on the CPU.

The Pallas bodies are closures inside each bench's `main()`, and running a
bench would overwrite a committed file, so this file holds a verbatim copy
of each body (file and line beside it) and runs it through
`pl.pallas_call(..., interpret=True)` with the bench's grid, block specs
and aliasing, on the same numpy inputs as the port's plain version. A
guard asserts that every copy still occurs, re-indented, in its bench's
text. One body does not run as written: `v_body`'s `client_clock` indexes
a 0-d client with ``[:, None]`` and raises IndexError (the committed TPU
result records the same failure); the test asserts that, and holds the
port against a copy that differs from it in that one line. Every
comparison is exact: the data are int32.
"""

import difflib
import inspect
import os
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ytpu_torch.benches import plane_rmw_repro as t1
from ytpu_torch.benches import plane_rmw_repro2 as t2
from ytpu_torch.benches import plane_rmw_repro3 as t3

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCHES = {n: os.path.join(ROOT, "benches", f"plane_rmw_repro{n}.py") for n in ("", "2", "3")}
I32 = jnp.int32
NC, D, C, DB = 26, 8, 512, 8
S, U, W = 1, 4, 23
M_PAD = 8

# --- verbatim copies of the Pallas bodies ---------------------------------------------


def _k_a():  # benches/plane_rmw_repro.py:86-99
    def k_a(x_ref, o_ref):
        iota_c = jax.lax.broadcasted_iota(I32, (DB, C), 1)
        idx = jnp.full((DB,), -1, I32)  # invalid slot -> mask all False
        active = jnp.ones((DB,), bool)
        mask = (iota_c == idx[:, None]) & (
            active.astype(I32)[:, None] > 0
        ) & (idx[:, None] >= 0)
        val = jnp.zeros((DB,), I32)
        o_ref[7] = jnp.where(mask, val[:, None], x_ref[7])
        # copy every other plane through unchanged, same as the kernel's
        # aliased in-place update leaves them
        for i in range(NC):
            if i != 7:
                o_ref[i] = x_ref[i]

    return k_a


def _k_a2():  # benches/plane_rmw_repro.py:104-115
    def k_a2(x_ref, o_ref):
        iota_c = jax.lax.broadcasted_iota(I32, (DB, C), 1)
        idx = jnp.zeros((DB,), I32)
        active = jnp.ones((DB,), bool)
        mask = (iota_c == idx[:, None]) & (
            active.astype(I32)[:, None] > 0
        ) & (idx[:, None] >= 0)
        val = jnp.full((DB,), 555, I32)
        o_ref[7] = jnp.where(mask, val[:, None], x_ref[7])
        for i in range(NC):
            if i != 7:
                o_ref[i] = x_ref[i]

    return k_a2


def _g3d_k():  # benches/plane_rmw_repro2.py:68-75
    def k(x_ref, o_ref):
        # the kernel's plane RMW with an all-False mask: semantics are
        # identity, so any output change is a layout/DMA bug
        iota_c = jax.lax.broadcasted_iota(I32, (DB, C), 1)
        idx = jnp.full((DB,), -1, I32)
        mask = (iota_c == idx[:, None]) & (idx[:, None] >= 0)
        for i in range(NC):
            o_ref[i] = jnp.where(mask, 0, x_ref[i])

    return k


def _g2d_k():  # benches/plane_rmw_repro2.py:105-111
    def k(x_ref, o_ref):
        iota_c = jax.lax.broadcasted_iota(I32, (DB, C), 1)
        idx = jnp.full((DB,), -1, I32)
        mask = (iota_c == idx[:, None]) & (idx[:, None] >= 0)
        for i in range(NC):
            sl = slice(i * C, (i + 1) * C)
            o_ref[:, sl] = jnp.where(mask, 0, x_ref[:, sl])

    return k


def _passthrough_k():  # benches/plane_rmw_repro3.py:85-87
    def passthrough_k(x_ref, o_ref):
        for i in range(NC):
            o_ref[i] = x_ref[i]

    return passthrough_k


def _multi_k(body):  # benches/plane_rmw_repro3.py:106-109
    def k(rows_ref, dels_ref, rank_ref, x_ref, meta_ref, o_ref, mo_ref):
        body(rows_ref, dels_ref, rank_ref, x_ref, meta_ref, mo_ref)
        # NOTE: cols output (o_ref) is intentionally NEVER written —
        # with aliasing {3:0} it must come back as the input

    return k


def _body_noop():  # benches/plane_rmw_repro3.py:145-146
    def body_noop(rows_ref, dels_ref, rank_ref, x_ref, meta_ref, mo_ref):
        mo_ref[:, :] = meta_ref[:, :]

    return body_noop


def _body_full():  # benches/plane_rmw_repro3.py:150-173
    def body_full(rows_ref, dels_ref, rank_ref, x_ref, meta_ref, mo_ref):
        mo_ref[:, :] = meta_ref[:, :]
        iota_c = jax.lax.broadcasted_iota(I32, (DB, C), 1)

        def client_clock(client_v):
            m = (iota_c < mo_ref[:, 1][:, None]) & (
                x_ref[0] == client_v[:, None]
            )
            return jnp.max(jnp.where(m, x_ref[1] + x_ref[2], 0), axis=1)

        def step(s, _):
            def row_body(u, __):
                @pl.when(rows_ref[s, u, 14] == 1)
                def _():
                    local = client_clock(rows_ref[s, u, 0])
                    missing = ~(local >= rows_ref[s, u, 1])
                    mo_ref[:, 2] = mo_ref[:, 2] | jnp.where(missing, 2, 0)

                return 0

            jax.lax.fori_loop(0, U, row_body, 0)
            return 0

        jax.lax.fori_loop(0, S, step, 0)

    return body_full


def _body_full_fixed():  # _body_full with the 0-d client broadcast instead of indexed
    def body_full(rows_ref, dels_ref, rank_ref, x_ref, meta_ref, mo_ref):
        mo_ref[:, :] = meta_ref[:, :]
        iota_c = jax.lax.broadcasted_iota(I32, (DB, C), 1)

        def client_clock(client_v):
            m = (iota_c < mo_ref[:, 1][:, None]) & (
                x_ref[0] == client_v
            )
            return jnp.max(jnp.where(m, x_ref[1] + x_ref[2], 0), axis=1)

        def step(s, _):
            def row_body(u, __):
                @pl.when(rows_ref[s, u, 14] == 1)
                def _():
                    local = client_clock(rows_ref[s, u, 0])
                    missing = ~(local >= rows_ref[s, u, 1])
                    mo_ref[:, 2] = mo_ref[:, 2] | jnp.where(missing, 2, 0)

                return 0

            jax.lax.fori_loop(0, U, row_body, 0)
            return 0

        jax.lax.fori_loop(0, S, step, 0)

    return body_full


COPIES = {
    "a": ("", lambda: _k_a()), "a2": ("", lambda: _k_a2()), "g3d": ("2", lambda: _g3d_k()),
    "g2d": ("2", lambda: _g2d_k()), "passthrough": ("3", lambda: _passthrough_k()),
    "multi_k": ("3", lambda: _multi_k(None)), "body_noop": ("3", lambda: _body_noop()),
    "body_full": ("3", lambda: _body_full()),
}


def _src(fn):
    return textwrap.dedent(inspect.getsource(fn))


@pytest.mark.parametrize("name", list(COPIES))
def test_copied_bodies_are_verbatim(name):
    bench, make = COPIES[name]
    with open(BENCHES[bench]) as f:
        text = f.read()
    src = _src(make())
    assert any(textwrap.indent(src, " " * n) in text for n in range(0, 17, 4))


def test_fixed_body_differs_in_one_line():
    diff = [line for line in difflib.unified_diff(
        _src(_body_full()).splitlines(), _src(_body_full_fixed()).splitlines(), lineterm="", n=0)
        if line[:1] in "+-" and not line.startswith(("+++", "---"))]
    assert diff == ["-            x_ref[0] == client_v[:, None]", "+            x_ref[0] == client_v"]


# --- the JAX calls, as the benches make them --------------------------------------------


def pattern():
    return np.arange(NC * DB * C, dtype=np.int32).reshape(NC, DB, C) % 997


def x3():
    return (np.arange(NC * D * C, dtype=np.int32).reshape(NC, D, C) % 997) - 400


def x2():
    return np.ascontiguousarray(np.transpose(x3(), (1, 0, 2)).reshape(D, NC * C))


def jax_aliased(kernel, x):  # plane_rmw_repro.py:58-62, :127-131
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(x.shape, I32), input_output_aliases={0: 0},
        interpret=True,
    )(jnp.asarray(x)))


def jax_g3d(x, alias):  # plane_rmw_repro2.py:78-85
    return np.asarray(pl.pallas_call(
        _g3d_k(), grid=(D // DB,),
        in_specs=[pl.BlockSpec((NC, DB, C), lambda d: (0, d, 0))],
        out_specs=pl.BlockSpec((NC, DB, C), lambda d: (0, d, 0)),
        out_shape=jax.ShapeDtypeStruct((NC, D, C), I32),
        input_output_aliases={0: 0} if alias else {}, interpret=True,
    )(jnp.asarray(x)))


def jax_g2d(x):  # plane_rmw_repro2.py:113-120
    return np.asarray(pl.pallas_call(
        _g2d_k(), grid=(D // DB,),
        in_specs=[pl.BlockSpec((DB, NC * C), lambda d: (d, 0))],
        out_specs=pl.BlockSpec((DB, NC * C), lambda d: (d, 0)),
        out_shape=jax.ShapeDtypeStruct((D, NC * C), I32),
        input_output_aliases={0: 0}, interpret=True,
    )(jnp.asarray(x)))


def jax_vmem(x):  # plane_rmw_repro3.py:90-100
    return np.asarray(pl.pallas_call(
        _passthrough_k(), grid=(D // DB,),
        in_specs=[pl.BlockSpec((NC, DB, C), lambda d: (0, d, 0))],
        out_specs=pl.BlockSpec((NC, DB, C), lambda d: (0, d, 0)),
        out_shape=jax.ShapeDtypeStruct((NC, D, C), I32), input_output_aliases={0: 0},
        compiler_params=pltpu.CompilerParams(vmem_limit_bytes=64 * 1024 * 1024), interpret=True,
    )(jnp.asarray(x)))


def jax_multi(body, rows, dels, rank, x, meta):  # plane_rmw_repro3.py:112-140
    out, mo = pl.pallas_call(
        _multi_k(body), grid=(D // DB,),
        in_specs=[
            pl.BlockSpec(rows.shape, lambda d: (0, 0, 0)),
            pl.BlockSpec(dels.shape, lambda d: (0, 0, 0)),
            pl.BlockSpec(rank.shape, lambda d: (0, 0)),
            pl.BlockSpec((NC, DB, C), lambda d: (0, d, 0)),
            pl.BlockSpec((DB, M_PAD), lambda d: (d, 0)),
        ],
        out_specs=[pl.BlockSpec((NC, DB, C), lambda d: (0, d, 0)),
                   pl.BlockSpec((DB, M_PAD), lambda d: (d, 0))],
        out_shape=[jax.ShapeDtypeStruct((NC, D, C), I32), jax.ShapeDtypeStruct((D, M_PAD), I32)],
        input_output_aliases={3: 0, 4: 1},
        compiler_params=pltpu.CompilerParams(vmem_limit_bytes=64 * 1024 * 1024), interpret=True,
    )(*(jnp.asarray(a) for a in (rows, dels, rank, x, meta)))
    return np.asarray(out), np.asarray(mo)


def multi_inputs(seeded: bool):
    """The repro's (rows, dels, rank, cols, meta), or a seeded set whose
    docs hold live slots of the rows' clients (so the masked max and the
    missing-dependency flag both vary by doc)."""
    rows, dels, rank, cols, meta = (a.numpy().copy() for a in t3.inputs("cpu"))
    if seeded:
        rng = np.random.default_rng(5)
        cols[0] = rng.integers(0, 4, size=(D, C))
        cols[1] = rng.integers(0, 50, size=(D, C))
        cols[2] = rng.integers(1, 4, size=(D, C))
        meta[:, 1] = rng.integers(0, C + 1, size=D)
        meta[:, 2] = rng.integers(0, 2, size=D)
        rows[0, :, 0] = rng.integers(0, 5, size=U)
        rows[0, :, 1] = rng.integers(0, 60, size=U)
        rows[0, 1, 14] = 0
    return rows, dels, rank, cols, meta


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# --- the plain versions against the Pallas bodies -----------------------------------------


def test_a_and_a2_match():
    for kernel, fn in ((_k_a(), t1.a_static3d_allfalse), (_k_a2(), t1.a2_static3d_slot0)):
        want = jax_aliased(kernel, pattern())
        x = _t(pattern())
        assert fn(x) is x  # in place
        np.testing.assert_array_equal(x.numpy(), want)
    assert (jax_aliased(_k_a2(), pattern())[7, :, 0] == 555).all()


@pytest.mark.parametrize("alias", [True, False])
def test_g3d_matches(alias):
    want = jax_g3d(x3(), alias)
    x = _t(x3())
    out = t2.g3d(x) if alias else t2.g3d(x, out=torch.empty_like(x))
    assert (out is x) == alias
    np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_array_equal(want, x3())


SENTINEL = -123456789


@pytest.mark.parametrize("name", ["a_static3d_allfalse", "a2_static3d_slot0", "g3d", "g2d_flat",
                                  "v_vmem", "v_multi"])
def test_out_of_place_writes_every_element(name):
    """Into a separate output filled with a sentinel, each passthrough
    writes every element its in-place call yields and leaves its input."""
    case = {c.name: c for c in t1.CASES + t2.CASES + t3.CASES}[name]
    args = case.inputs("cpu")
    want = case.fn(*(a.clone() for a in args))
    target = args[-1]
    out = torch.full_like(target, SENTINEL)
    kept = tuple(a.clone() for a in args)
    got = case.fn(*args, out=out)
    got, want = (got[-1], want[-1]) if isinstance(got, tuple) else (got, want)
    assert got is out
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(args, kept))


@pytest.mark.parametrize("name", ["a_static3d_allfalse", "a2_static3d_slot0", "g3d", "g2d_flat",
                                  "v_vmem", "v_multi"])
def test_out_overlapping_x_raises(name):
    """An `out` one element past `x` in the same buffer is refused: a kernel
    would read elements its own stores had already changed."""
    case = {c.name: c for c in t1.CASES + t2.CASES + t3.CASES}[name]
    args = list(case.inputs("cpu"))
    target = args[-1]
    buf = torch.empty(target.numel() + 1, dtype=target.dtype)
    args[-1] = buf[: target.numel()].view(target.shape).copy_(target)
    with pytest.raises(ValueError, match="overlaps x"):
        case.fn(*args, out=buf[1:].view(target.shape))
    with pytest.raises(ValueError, match="overlaps x"):
        case.plain(*args, out=buf[1:].view(target.shape))


@pytest.mark.parametrize("fn", [t2.g3d, t2.g2d_flat, t1.a_static3d_allfalse, t1.a2_static3d_slot0])
def test_out_at_the_address_of_x_is_the_in_place_call(fn):
    x = _t(x3()) if fn is not t2.g2d_flat else _t(x2())
    want = fn(x.clone(), idx=9, fill=-5)
    same = x.view(x.shape)
    assert fn(x, out=same, idx=9, fill=-5) is same
    assert torch.equal(x, want)


@pytest.mark.parametrize("fn", [t2.g3d, t2.g2d_flat])
def test_masked_write_of_a_live_slot(fn):
    """idx >= 0 puts `fill` at that slot of every plane and doc, in place
    and out of place; every other element is copied."""
    x3d = np.random.default_rng(3).integers(-1000, 1000, size=(NC, D, C)).astype(np.int32)
    want = x3d.copy()
    want[:, :, 17] = 4242
    if fn is t2.g2d_flat:
        x3d, want = (np.ascontiguousarray(a.transpose(1, 0, 2).reshape(D, NC * C)) for a in (x3d, want))
    x = _t(x3d)
    out = fn(x, out=torch.full_like(x, SENTINEL), idx=17, fill=4242)
    np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_array_equal(x.numpy(), x3d)
    assert fn(x, idx=17, fill=4242) is x
    np.testing.assert_array_equal(x.numpy(), want)


@pytest.mark.parametrize("plane", range(NC))
def test_masked_put_of_a_live_slot_in_each_plane(plane):
    """Cases a and a2 with their plane, slot and fill given: only that
    plane's slot changes in every doc, in place and into a separate
    output; every other element is copied. The program's own call (a:
    idx -1, a2: slot 0 of plane 7, 555) is the default."""
    rng = np.random.default_rng(100 + plane)
    x3d = rng.integers(-(2**31), 2**31, size=(NC, D, C), dtype=np.int64).astype(np.int32)
    idx = int(rng.integers(C))
    want = x3d.copy()
    want[plane, :, idx] = -77
    for fn, plain in ((t1.a_static3d_allfalse, t1.a_static3d_allfalse_plain),
                      (t1.a2_static3d_slot0, t1.a2_static3d_slot0_plain)):
        x = _t(x3d)
        out = fn(x, out=torch.full_like(x, SENTINEL), plane=plane, idx=idx, fill=-77)
        np.testing.assert_array_equal(out.numpy(), want)
        np.testing.assert_array_equal(x.numpy(), x3d)
        assert fn(x, plane=plane, idx=idx, fill=-77) is x
        np.testing.assert_array_equal(x.numpy(), want)
        np.testing.assert_array_equal(plain(_t(x3d), plane=plane, idx=idx, fill=-77).numpy(), want)
    np.testing.assert_array_equal(t1.a_static3d_allfalse(_t(x3d)).numpy(), x3d)
    want = x3d.copy()
    want[7, :, 0] = 555
    np.testing.assert_array_equal(t1.a2_static3d_slot0(_t(x3d)).numpy(), want)


@pytest.mark.parametrize("plane", [-1, NC])
def test_masked_put_refuses_a_plane_outside_the_state(plane):
    with pytest.raises(ValueError, match="writes plane"):
        t1.a2_static3d_slot0(_t(x3()), plane=plane)


@pytest.mark.parametrize("idx", [-1, C])
def test_masked_put_of_no_slot_copies_every_element(idx):
    x = _t(x3())
    out = t1.a2_static3d_slot0(x, out=torch.full_like(x, SENTINEL), idx=idx)
    np.testing.assert_array_equal(out.numpy(), x3())


def test_g2d_and_vmem_match():
    x = _t(x2())
    np.testing.assert_array_equal(t2.g2d_flat(x).numpy(), jax_g2d(x2()))
    x = _t(x3())
    np.testing.assert_array_equal(t3.v_vmem(x).numpy(), jax_vmem(x3()))


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("case", ["v_multi", "v_body"])
def test_multi_call_matches(case, seeded):
    args = multi_inputs(seeded)
    body = _body_noop() if case == "v_multi" else _body_full_fixed()
    want_cols, want_meta = jax_multi(body, *args)
    fn = t3.v_multi if case == "v_multi" else t3.v_body
    t_args = [_t(a) for a in args]
    cols, meta = fn(*t_args)
    assert cols is t_args[3] and meta is t_args[4]  # both in place
    np.testing.assert_array_equal(cols.numpy(), want_cols)
    np.testing.assert_array_equal(meta.numpy(), want_meta)
    np.testing.assert_array_equal(want_cols, args[3])  # cols never written
    if case == "v_body" and not seeded:
        assert meta[:, 2].tolist() == [2] * D


def test_body_full_as_written_raises_like_on_the_tpu():
    with pytest.raises(IndexError):
        jax_multi(_body_full(), *multi_inputs(False))


def test_mains_run_on_cpu_and_report_like_the_jax_scripts():
    r1, r2, r3 = t1.main("cpu"), t2.main("cpu"), t3.main("cpu")
    assert set(r1["cases"]) == {"a_static3d_allfalse", "a2_static3d_slot0"}
    assert set(r2["cases"]) == {"g3d_alias", "g3d_noalias", "g2d_flat"}
    assert set(r3["cases"]) == {"v_vmem", "v_multi", "v_body"}
    for r in (r1, r2, r3):
        for name, c in r["cases"].items():
            assert c["status"] == "ok" and c["n_bad"] == 0, (name, c)
    assert r1["cases"]["a_static3d_allfalse"]["first_bad_ncd"] is None
    assert r3["cases"]["v_body"]["meta"][0][2] == 2


def test_first_bad_reports_like_the_jax_script():
    want = x3()
    got = want.copy()
    got[0, 0, 3] += 1
    got[5, 1, 2] = 9
    n_bad, first = t2.first_bad(got, want)
    assert n_bad == 2
    assert first == [[0, 0, 3, int(want[0, 0, 3]), int(got[0, 0, 3])],
                     [5, 1, 2, int(want[5, 1, 2]), 9]]


def test_cases_list_every_site_with_its_bound():
    sites = sorted({c.replaces for c in t1.CASES + t2.CASES + t3.CASES})
    assert sites == ["benches/plane_rmw_repro.py:127", "benches/plane_rmw_repro.py:58",
                     "benches/plane_rmw_repro2.py:113", "benches/plane_rmw_repro2.py:78",
                     "benches/plane_rmw_repro3.py:112", "benches/plane_rmw_repro3.py:90"]
    for case in t1.CASES + t2.CASES + t3.CASES:
        args = case.inputs("cpu")
        assert case.bound_bytes(args) > 0
        want = case.plain(*(a.clone() for a in args))
        got = case.fn(*(a.clone() for a in args))
        for w, g in zip(want if isinstance(want, tuple) else (want,),
                        got if isinstance(got, tuple) else (got,)):
            assert torch.equal(w, g), case.name
