"""Plane read-modify-write repro 2 on the GPU (port of
`benches/plane_rmw_repro2.py`).

The integrate kernel's own call shape against a flat layout, on a known
pattern with every plane given a masked write under an all-False mask (so
the result must equal the input):

  g3d_alias   : grid over blocks of DB docs, the [NC, D, C] state, in place
  g3d_noalias : the same into a separate output tensor
  g2d_flat    : the [D, NC * C] layout, a plane being a lane slice, in place

The kernels are ``ytpu_plane_g3d`` / ``ytpu_plane_g2d`` of
``csrc/plane_rmw.cu``; beside them are their plain PyTorch versions.
`main` returns each case's ``status`` / ``n_bad`` / ``first_bad`` as the
JAX script records them.

Usage (on a machine with an NVIDIA GPU): ``python -m
ytpu_torch.benches.plane_rmw_repro2``.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from ytpu_torch.benches._kernels import (
    KernelCase, check_i32, copy_library, kernel_device, out_for, stream_of,
)
from ytpu_torch.benches.plane_rmw_repro import SOURCE, plane_lib
from ytpu_torch.core.device import resolve_device

__all__ = ["CASES", "g3d", "g2d_flat", "main"]

NC, D, C, DB = 26, 8, 512, 8
IDX, FILL = -1, 0  # the all-False mask: no slot, fill 0


def pattern3(device=None) -> torch.Tensor:
    """``(arange(NC * D * C) % 997) - 400`` as ``[NC, D, C]``."""
    x = (np.arange(NC * D * C, dtype=np.int32).reshape(NC, D, C) % 997) - 400
    return torch.from_numpy(x).to(resolve_device(device))


def pattern2(device=None) -> torch.Tensor:
    """The same values in the flat ``[D, NC * C]`` layout."""
    x3 = pattern3("cpu").numpy()
    x2 = np.ascontiguousarray(np.transpose(x3, (1, 0, 2)).reshape(D, NC * C))
    return torch.from_numpy(x2).to(resolve_device(device))


def _mask(n, device, idx):
    iota = torch.arange(n, device=device)
    return (iota == idx) & (idx >= 0)


def g3d_plain(x, out=None, idx: int = IDX, fill: int = FILL):
    """Every plane p: ``o[p] = where(c == idx & idx >= 0, fill, x[p])``;
    ``o`` is `x` itself (in place) unless `out` is given."""
    o = out_for(x, out)
    mask = _mask(x.shape[2], x.device, idx)
    for p in range(x.shape[0]):
        o[p] = torch.where(mask[None, :], fill, x[p])
    return o


def g2d_flat_plain(x, out=None, idx: int = IDX, fill: int = FILL):
    """The same on the flat ``[D, NC * C]`` layout: plane p is the lane
    slice ``[p * C, (p + 1) * C)``."""
    o = out_for(x, out)
    width = x.shape[1] // NC
    mask = _mask(width, x.device, idx)
    for p in range(NC):
        sl = slice(p * width, (p + 1) * width)
        o[:, sl] = torch.where(mask[None, :], fill, x[:, sl])
    return o


def g3d(x, out=None, idx: int = IDX, fill: int = FILL):
    """The g3d masked write of every plane on a ``[NC, D, C]`` int32 state,
    in place unless `out` is given (the JAX case without aliasing); the
    CUDA kernel on CUDA tensors (counted in ``g3d.launches``), `g3d_plain`
    on CPU ones. The repro's call is ``idx = -1``, no slot."""
    check_i32("x", x, ndim=3)
    o = out_for(x, out)
    if kernel_device(x).type == "cpu":
        return g3d_plain(x, out, idx, fill)
    from ytpu_torch.ops import _build

    lib = plane_lib()
    n_planes, n_docs, width = x.shape
    err = lib.ytpu_plane_g3d(x.data_ptr(), o.data_ptr(), n_planes, n_docs, width, DB, idx, fill,
                             stream_of(x))
    _build.check(lib, err, "g3d")
    g3d.launches += 1
    return o


g3d.launches = 0


def g2d_flat(x, out=None, idx: int = IDX, fill: int = FILL):
    """The g2d masked write of every lane-slice plane of a flat
    ``[D, NC * C]`` int32 state, in place unless `out` is given; the CUDA
    kernel on CUDA tensors (counted in ``g2d_flat.launches``),
    `g2d_flat_plain` on CPU ones."""
    check_i32("x", x, ndim=2)
    if x.shape[1] % NC:
        raise ValueError(f"{x.shape[1]} lanes do not split into {NC} planes")
    o = out_for(x, out)
    if kernel_device(x).type == "cpu":
        return g2d_flat_plain(x, out, idx, fill)
    from ytpu_torch.ops import _build

    lib = plane_lib()
    n_docs, lanes = x.shape
    err = lib.ytpu_plane_g2d(x.data_ptr(), o.data_ptr(), NC, n_docs, lanes // NC, DB, idx, fill,
                             stream_of(x))
    _build.check(lib, err, "g2d_flat")
    g2d_flat.launches += 1
    return o


g2d_flat.launches = 0


def _io_bytes(args):
    return 2 * 4 * args[0].numel()


CASES = [
    KernelCase("g3d", SOURCE, "benches/plane_rmw_repro2.py:78", g3d, g3d_plain,
               lambda dev: (pattern3(dev),), _io_bytes, lambda args: copy_library(args[0])),
    KernelCase("g2d_flat", SOURCE, "benches/plane_rmw_repro2.py:113", g2d_flat, g2d_flat_plain,
               lambda dev: (pattern2(dev),), _io_bytes, lambda args: copy_library(args[0])),
]


def first_bad(got, want):
    """Up to four ``[index..., want, got]`` of the differing elements."""
    bad = np.nonzero(got != want)
    if not bad[0].size:
        return 0, None
    nd = len(bad)
    return int(bad[0].size), [
        [int(bad[j][k]) for j in range(nd)]
        + [int(want[tuple(b[k] for b in bad)]), int(got[tuple(b[k] for b in bad)])]
        for k in range(min(4, bad[0].size))
    ]


def main(device=None) -> dict:
    """Run the three cases on `device` (the GPU by default); returns
    ``{"device", "cases": {name: {"status", "n_bad", "first_bad", "seconds"}}}``."""
    dev = resolve_device(device)
    x3, x2 = pattern3("cpu").numpy(), pattern2("cpu").numpy()
    state = {"device": str(dev), "cases": {}}
    cases = (
        ("g3d_alias", lambda: g3d(torch.from_numpy(x3.copy()).to(dev)), x3),
        ("g3d_noalias", lambda: g3d(torch.from_numpy(x3.copy()).to(dev),
                                    out=torch.empty(x3.shape, dtype=torch.int32, device=dev)), x3),
        ("g2d_flat", lambda: g2d_flat(torch.from_numpy(x2.copy()).to(dev)), x2),
    )
    for name, run, want in cases:
        t0 = time.perf_counter()
        try:
            n_bad, first = first_bad(run().cpu().numpy(), want)
            state["cases"][name] = {"status": "ok" if n_bad == 0 else "CORRUPT", "n_bad": n_bad,
                                    "first_bad": first}
        except Exception as e:  # noqa: BLE001 - record and go on, as the JAX script does
            state["cases"][name] = {"status": "fail", "error": f"{type(e).__name__}: {e}"[:250]}
        state["cases"][name]["seconds"] = time.perf_counter() - t0
    return state


if __name__ == "__main__":
    out = main()
    print(json.dumps(out))
    sys.exit(0 if all(c["status"] == "ok" for c in out["cases"].values()) else 1)
