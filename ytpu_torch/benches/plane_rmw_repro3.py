"""Plane read-modify-write repro 3 on the GPU (port of
`benches/plane_rmw_repro3.py`).

The integrate kernel's call context, layered in around a state that the
kernel never changes:

  v_vmem : an in-place passthrough of the [NC, D, C] state under a raised
           scratch limit (on the card the flat copy: the column put at
           idx -1)
  v_multi: the five operands of the integrate call (rows, dels, rank,
           cols, meta) with cols and meta updated in place; cols is never
           written and meta is copied through
  v_body : v_multi plus the body of the integrate's first phase: for every
           valid row, the client clock (a masked max of clock + length over
           the doc's live slots of that client) and ``meta[:, 2] |= 2``
           where it falls short of the row's clock

The kernels are ``ytpu_column_put`` / ``ytpu_plane_v_multi`` /
``ytpu_plane_v_body`` of ``csrc/plane_rmw.cu``; beside them are their
plain PyTorch versions. `main` returns each case's ``status`` / ``n_bad``
/ ``first_bad`` over cols, as the JAX script records them, and the meta
words the case wrote.

Usage (on a machine with an NVIDIA GPU): ``python -m
ytpu_torch.benches.plane_rmw_repro3``.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from ytpu_torch.benches._kernels import (
    KernelCase, check_i32, copy_library, kernel_device, out_for, stream_of, wrap_i32,
)
from ytpu_torch.benches.plane_rmw_repro import SOURCE, plane_lib
from ytpu_torch.benches.plane_rmw_repro2 import first_bad
from ytpu_torch.core.device import resolve_device

__all__ = ["CASES", "main", "v_body", "v_multi", "v_vmem"]

NC, D, C = 26, 8, 512
S, U, W = 1, 4, 23
M_PAD = 8


def inputs(device=None):
    """``(rows, dels, rank, cols, meta)`` of the repro: a ``% 997 - 400``
    pattern state, rows ``arange % 7`` with the valid flag set, zero
    deletes and meta, the identity rank."""
    dev = resolve_device(device)
    x3 = (np.arange(NC * D * C, dtype=np.int32).reshape(NC, D, C) % 997) - 400
    rows = np.arange(S * U * W, dtype=np.int32).reshape(S, U, W) % 7
    rows[:, :, 14] = 1  # valid flag
    dels = np.zeros((S, 4, 4), np.int32)
    rank = np.arange(256, dtype=np.int32).reshape(1, 256)
    meta = np.zeros((D, M_PAD), np.int32)
    return tuple(torch.from_numpy(a).to(dev) for a in (rows, dels, rank, x3, meta))


def v_vmem_plain(x, out=None):
    """The passthrough: `x` unchanged, or copied into `out`."""
    o = out_for(x, out)
    return o if o is x else o.copy_(x)


def v_vmem(x, out=None):
    """Passthrough of a ``[NC, D, C]`` int32 state, in place unless `out` is
    given; the CUDA kernel on CUDA tensors (counted in ``v_vmem.launches``):
    the column put at idx -1, a flat copy (in place its threads return at
    once); `v_vmem_plain` on CPU ones."""
    check_i32("x", x, ndim=3)
    o = out_for(x, out)
    if kernel_device(x).type == "cpu":
        return v_vmem_plain(x, out)
    from ytpu_torch.ops import _build

    lib = plane_lib()
    err = lib.ytpu_column_put(x.data_ptr(), o.data_ptr(), x.numel(), x.shape[2], -1, 0, stream_of(x))
    _build.check(lib, err, "v_vmem")
    v_vmem.launches += 1
    return o


v_vmem.launches = 0


def _check_multi(rows, dels, rank, cols, meta):
    check_i32("rows", rows, ndim=3)
    check_i32("dels", dels, ndim=3)
    check_i32("rank", rank, ndim=2)
    check_i32("cols", cols, ndim=3)
    check_i32("meta", meta, ndim=2)
    if meta.shape[0] != cols.shape[1] or rows.shape[2] < 15:
        raise ValueError(f"shapes {tuple(rows.shape)} / {tuple(cols.shape)} / {tuple(meta.shape)} "
                         "are not [S, U, W >= 15] / [NC, D, C] / [D, M]")
    return kernel_device(rows, dels, rank, cols, meta)


def v_multi_plain(rows, dels, rank, cols, meta, out=None):
    """cols and meta come back unchanged (meta is copied onto itself, or
    into `out`)."""
    mo = out_for(meta, out)
    return cols, (mo if mo is meta else mo.copy_(meta))


def v_multi(rows, dels, rank, cols, meta, out=None):
    """The five-operand call with ``{cols, meta}`` updated in place: meta is
    copied through (into `out` when given), cols never written; the CUDA
    kernel on CUDA tensors (counted in ``v_multi.launches``),
    `v_multi_plain` on CPU ones."""
    mo = out_for(meta, out)
    if _check_multi(rows, dels, rank, cols, meta).type == "cpu":
        return v_multi_plain(rows, dels, rank, cols, meta, out)
    from ytpu_torch.ops import _build

    lib = plane_lib()
    err = lib.ytpu_plane_v_multi(meta.data_ptr(), mo.data_ptr(), meta.shape[0], meta.shape[1],
                                 stream_of(meta))
    _build.check(lib, err, "v_multi")
    v_multi.launches += 1
    return cols, mo


v_multi.launches = 0


def v_body_plain(rows, dels, rank, cols, meta):
    """For every valid row in order: ``local = max_c(c < meta[:, 1] &
    cols[0] == client ? cols[1] + cols[2] : 0)`` and ``meta[:, 2] |= 2``
    where ``local < clock``. Updates meta in place; cols is only read."""
    C_ = cols.shape[2]
    iota = torch.arange(C_, device=cols.device)
    clocks = wrap_i32(cols[1].to(torch.int64) + cols[2].to(torch.int64))
    for r in rows.reshape(-1, rows.shape[2]).tolist():
        if r[14] != 1:
            continue
        m = (iota[None, :] < meta[:, 1:2]) & (cols[0] == r[0])
        local = torch.where(m, clocks, 0).max(dim=1).values
        meta[:, 2] |= torch.where(local >= r[1], 0, 2).to(meta.dtype)
    return cols, meta


def v_body(rows, dels, rank, cols, meta):
    """`v_multi` plus the client-clock body, meta updated in place; the
    CUDA kernel on CUDA tensors (counted in ``v_body.launches``),
    `v_body_plain` on CPU ones."""
    if _check_multi(rows, dels, rank, cols, meta).type == "cpu":
        return v_body_plain(rows, dels, rank, cols, meta)
    from ytpu_torch.ops import _build

    lib = plane_lib()
    n_steps, n_rows, width = rows.shape
    _, n_docs, slots = cols.shape
    err = lib.ytpu_plane_v_body(rows.data_ptr(), cols.data_ptr(), meta.data_ptr(), meta.data_ptr(),
                                n_steps, n_rows, width, n_docs, slots, meta.shape[1], stream_of(meta))
    _build.check(lib, err, "v_body")
    v_body.launches += 1
    return cols, meta


v_body.launches = 0


def _body_bytes(rows, dels, rank, cols, meta):
    """Valid flags, clients and clocks of the rows, meta read and written,
    and planes 0-2 of every doc's live slots (c < meta[:, 1])."""
    live = int(meta[:, 1].clamp(0, cols.shape[2]).sum())
    return 4 * (3 * rows.shape[0] * rows.shape[1] + 2 * meta.numel() + 3 * live)


def _meta_library(rows, dels, rank, cols, meta):
    out = torch.empty_like(meta)
    return lambda: out.copy_(meta)


CASES = [
    KernelCase("v_vmem", SOURCE, "benches/plane_rmw_repro3.py:90", v_vmem, v_vmem_plain,
               lambda dev: (inputs(dev)[3],), lambda args: 2 * 4 * args[0].numel(),
               lambda args: copy_library(args[0])),
    KernelCase("v_multi", SOURCE, "benches/plane_rmw_repro3.py:112", v_multi, v_multi_plain,
               inputs, lambda args: 2 * 4 * args[4].numel(),
               lambda args: _meta_library(*args)),
    KernelCase("v_body", SOURCE, "benches/plane_rmw_repro3.py:112", v_body, v_body_plain,
               inputs, lambda args: _body_bytes(*args)),
]


def main(device=None) -> dict:
    """Run the three cases on `device` (the GPU by default); returns
    ``{"device", "cases": {name: {"status", "n_bad", "first_bad", "meta",
    "seconds"}}}``: ``n_bad`` counts cols elements that changed (none may)."""
    dev = resolve_device(device)
    x3 = inputs("cpu")[3].numpy()
    state = {"device": str(dev), "cases": {}}
    cases = (
        ("v_vmem", lambda: (v_vmem(inputs(dev)[3]), None)),
        ("v_multi", lambda: v_multi(*inputs(dev))),
        ("v_body", lambda: v_body(*inputs(dev))),
    )
    for name, run in cases:
        t0 = time.perf_counter()
        try:
            cols, meta = run()
            n_bad, first = first_bad(cols.cpu().numpy(), x3)
            state["cases"][name] = {"status": "ok" if n_bad == 0 else "CORRUPT", "n_bad": n_bad,
                                    "first_bad": first}
            if meta is not None:
                state["cases"][name]["meta"] = meta.cpu().tolist()
        except Exception as e:  # noqa: BLE001 - record and go on, as the JAX script does
            state["cases"][name] = {"status": "fail", "error": f"{type(e).__name__}: {e}"[:250]}
        state["cases"][name]["seconds"] = time.perf_counter() - t0
    return state


if __name__ == "__main__":
    out = main()
    print(json.dumps(out))
    sys.exit(0 if all(c["status"] == "ok" for c in out["cases"].values()) else 1)
