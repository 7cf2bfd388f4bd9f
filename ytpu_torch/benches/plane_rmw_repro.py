"""Plane read-modify-write repro 1 on the GPU (port of
`benches/plane_rmw_repro.py`).

The packed state is one ``[NC, DB, C]`` int32 tensor and the integrate
kernel updates a plane as ``plane = where(mask, val, plane)``, in place.
Two cases write plane 7 of a known pattern in place and copy every other
plane through: case ``a`` with an all-False mask (the output must equal
the input) and case ``a2`` with the mask on slot 0 (``o[7, :, 0] = 555``).
The kernel is ``ytpu_plane_masked_put`` of ``csrc/plane_rmw.cu``; beside
it is its plain PyTorch version. `main` returns each case's
``status`` / ``n_bad`` / ``first_bad_ncd`` as the JAX script records them.

Usage (on a machine with an NVIDIA GPU): ``python -m
ytpu_torch.benches.plane_rmw_repro``.
"""

from __future__ import annotations

import ctypes
import json
import sys
import time

import numpy as np
import torch

from ytpu_torch.benches._kernels import (
    KernelCase, check_i32, copy_library, kernel_device, out_for, stream_of,
)
from ytpu_torch.core.device import resolve_device

__all__ = ["CASES", "a_static3d_allfalse", "a2_static3d_slot0", "main", "plane_lib"]

NC, DB, C = 26, 8, 512
PLANE = 7  # the plane cases a and a2 write
SOURCE = "ytpu_torch/csrc/plane_rmw.cu"


def plane_lib():
    """The plane RMW kernel library with its C signatures declared."""
    from ytpu_torch.ops import _build

    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return _build.bind(
        "plane_rmw",
        {
            "ytpu_plane_masked_put": [p, p, i, i, i, i, i, i, p],
            "ytpu_column_put": [p, p, q, i, i, i, p],
            "ytpu_plane_v_multi": [p, p, i, i, p],
            "ytpu_plane_v_body": [p, p, p, p, i, i, i, i, i, i, p],
            "ytpu_empty_launch": [i, i, i, i, i, i, p],
        },
        "ytpu_plane_error_string",
    )


def pattern(device=None) -> torch.Tensor:
    """The repro's input: ``arange(NC * DB * C) % 997`` as ``[NC, DB, C]``."""
    x = np.arange(NC * DB * C, dtype=np.int32).reshape(NC, DB, C) % 997
    return torch.from_numpy(x).to(resolve_device(device))


def masked_put_plain(x, plane: int, idx: int, val: int, out=None):
    """``o[plane] = where(c == idx & idx >= 0, val, x[plane])`` for every
    doc, every other plane copied; ``o`` is `x` itself (in place) unless
    `out` is given."""
    o = out_for(x, out)
    if o is not x:
        o.copy_(x)
    iota = torch.arange(x.shape[2], device=x.device)
    mask = (iota == idx) & (idx >= 0)
    o[plane] = torch.where(mask[None, :], val, x[plane])
    return o


def _masked_put(name: str, plane: int, idx: int, val: int):
    def plain(x, out=None, plane: int = plane, idx: int = idx, fill: int = val):
        return masked_put_plain(x, plane, idx, fill, out)

    def wrapper(x, out=None, plane: int = plane, idx: int = idx, fill: int = val):
        check_i32("x", x, ndim=3)
        o = out_for(x, out)
        n_planes, D, C_ = x.shape
        if not 0 <= plane < n_planes:
            raise ValueError(f"{name} writes plane {plane} of a {n_planes}-plane state")
        if kernel_device(x).type == "cpu":
            return plain(x, out, plane, idx, fill)
        from ytpu_torch.ops import _build

        lib = plane_lib()
        err = lib.ytpu_plane_masked_put(x.data_ptr(), o.data_ptr(), n_planes, D, C_, plane, idx, fill,
                                        stream_of(x))
        _build.check(lib, err, name)
        wrapper.launches += 1
        return o

    wrapper.launches = 0
    wrapper.__name__ = name
    wrapper.__doc__ = (f"On a [NC, D, C] int32 state, in place unless `out` is given: plane `plane` "
                       f"(default {plane}) gets `fill` (default {val}) at slot `idx` (default {idx}) "
                       f"of every doc, no slot when idx < 0; every other element is copied.")
    plain.__name__ = f"{name}_plain"
    return wrapper, plain


a_static3d_allfalse, a_static3d_allfalse_plain = _masked_put("a_static3d_allfalse", PLANE, -1, 0)
a2_static3d_slot0, a2_static3d_slot0_plain = _masked_put("a2_static3d_slot0", PLANE, 0, 555)


def _slot0_library(x):
    # one torch.where with the write's mask as a broadcast constant
    mask = torch.zeros((x.shape[0], 1, x.shape[2]), dtype=torch.bool, device=x.device)
    mask[7, 0, 0] = True
    val = torch.tensor(555, dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    return lambda: torch.where(mask, val, x, out=out)


CASES = [
    KernelCase("a_static3d_allfalse", SOURCE, "benches/plane_rmw_repro.py:58", a_static3d_allfalse,
               a_static3d_allfalse_plain, lambda dev: (pattern(dev),),
               lambda args: 2 * 4 * args[0].numel(), lambda args: copy_library(*args)),
    KernelCase("a2_static3d_slot0", SOURCE, "benches/plane_rmw_repro.py:127", a2_static3d_slot0,
               a2_static3d_slot0_plain, lambda dev: (pattern(dev),),
               lambda args: 2 * 4 * args[0].numel(), lambda args: _slot0_library(*args)),
]


def main(device=None) -> dict:
    """Run both cases on `device` (the GPU by default); returns
    ``{"device", "cases": {name: {"status", "n_bad", "first_bad_ncd",
    "seconds"}}}``."""
    dev = resolve_device(device)
    x_np = pattern("cpu").numpy()
    state = {"device": str(dev), "cases": {}}
    for name, fn in (("a_static3d_allfalse", a_static3d_allfalse),
                     ("a2_static3d_slot0", a2_static3d_slot0)):
        want = x_np.copy()
        if name == "a2_static3d_slot0":
            want[7, :, 0] = 555
        t0 = time.perf_counter()
        try:
            got = fn(torch.from_numpy(x_np.copy()).to(dev)).cpu().numpy()
            bad = np.nonzero(got != want)
            n_bad = int(bad[0].size)
            state["cases"][name] = {
                "status": "ok" if n_bad == 0 else "CORRUPT",
                "n_bad": n_bad,
                "first_bad_ncd": [int(bad[k][0]) for k in range(3)] if n_bad else None,
                "seconds": time.perf_counter() - t0,
            }
        except Exception as e:  # noqa: BLE001 - record and go on, as the JAX script does
            state["cases"][name] = {"status": "fail", "error": f"{type(e).__name__}: {e}"[:250],
                                    "seconds": time.perf_counter() - t0}
    return state


if __name__ == "__main__":
    out = main()
    print(json.dumps(out))
    sys.exit(0 if all(c["status"] == "ok" for c in out["cases"].values()) else 1)
