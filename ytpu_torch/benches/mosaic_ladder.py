"""The Mosaic fault-isolation ladder on the GPU (port of
`benches/mosaic_ladder.py`).

The ladder runs a staircase of small programs, each isolating one
construct the fused integrate kernel relies on, in increasing order of
suspicion. Rungs 0-7 are hand-written CUDA kernels (``csrc/
mosaic_ladder.cu``) beside their plain PyTorch versions; rungs 8-10 run the
port's real integrate kernel through `apply_update_stream_fused` on three
logs of ytpu's host `Doc` (committed as ``data/ladder_logs.json``):

  0 copy          o = x + 1
  1 onehot_put    o[d, c] = 7 if c == x[d, 0] else x[d, c]
  2 mrow_mask     o[d, :] = x[d, :] if x[d, 0] > 2 else -x[d, :]
  3 fori_carry    o = full(sum over the first 16 columns)
  4 while_scan    the conflict-scan loop: block-wide `any` condition
  5 nested_fori   o = full(sum_{s<8, u<4} x[0, (4s + u) % C])
  6 pl_when       o = x, or x + 1 if any(x[:, 0] > 100)
  7 big_tile      o = 2x over a [25, 8, 2048] tile
  8 kernel_s1     the integrate kernel, a 1-update stream
  9 kernel_quick  the integrate kernel, 200 text updates
 10 kernel_moves  the integrate kernel, an array stream with move rows

`run_ladder` records each rung's name before the rung launches (through
``on_attempt``), so a hard fault still names the rung, and synchronizes
the device after each rung, so an error is charged to that rung. Each of
rungs 0-7 is checked against the value the JAX rung asserts and against
its plain version; rungs 8-10 check the state against the plain integrate
on the same decoded stream, the sticky error and, for 8 and 9, the text of
doc 0. The result is returned, never written to a file.

Usage (on a machine with an NVIDIA GPU): ``python -m
ytpu_torch.benches.mosaic_ladder``.
"""

from __future__ import annotations

import ctypes
import json
import os
import sys
import time

import numpy as np
import torch

from ytpu_torch.benches._kernels import (
    I32, KernelCase, check_i32, kernel_device, stream_of, wrap_i32,
)
from ytpu_torch.core.device import resolve_device

__all__ = [
    "RUNGS",
    "CASES",
    "load_ladder_logs",
    "run_ladder",
    "run_kernel",
]

DB, C = 8, 256
BIG_SHAPE = (25, DB, 2048)
SOURCE = "ytpu_torch/csrc/mosaic_ladder.cu"
LOGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "ladder_logs.json")

# --- plain versions ----------------------------------------------------------------


def copy_plain(x):
    return x + 1


def onehot_put_plain(x):
    iota = torch.arange(x.shape[1], dtype=I32, device=x.device)
    return torch.where(iota[None, :] == x[:, :1], 7, x)


def mrow_mask_plain(x):
    return torch.where(x[:, :1] > 2, x, -x)


def fori_carry_plain(x):
    total = wrap_i32(x[:, :16].to(torch.int64).sum())
    return total.expand(x.shape).clone()


def while_scan_plain(x):
    D, C_ = x.shape
    iota = torch.arange(C_, device=x.device)
    o = torch.zeros(D, dtype=torch.int64, device=x.device)
    brk = torch.zeros(D, dtype=torch.bool, device=x.device)
    acc = torch.zeros(D, dtype=I32, device=x.device)
    while bool(((o < 12) & ~brk).any()):
        oh = (iota[None, :] == o[:, None]) & ~brk[:, None]
        acc = wrap_i32(acc.to(torch.int64) + (oh * x).to(torch.int64).sum(dim=1))
        brk = brk | (acc > 40)
        o = o + 1
    return acc[:, None].expand(D, C_).clone()


def nested_fori_plain(x):
    idx = torch.tensor([(4 * s + u) % x.shape[1] for s in range(8) for u in range(4)],
                       device=x.device)
    total = wrap_i32(x[0, idx].to(torch.int64).sum())
    return total.expand(x.shape).clone()


def pl_when_plain(x):
    return torch.where((x[:, 0] > 100).any(), x + 1, x)


def big_tile_plain(x):
    return x * 2


# --- the CUDA kernels --------------------------------------------------------------

_SYMBOLS = [f"ytpu_ladder_r{i}" for i in range(8)]


def _lib():
    from ytpu_torch.ops import _build

    sig = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return _build.bind("mosaic_ladder", {s: sig for s in _SYMBOLS}, "ytpu_ladder_error_string")


def _rung(index: int, name: str, plain, ndim: int = 2, min_cols: int = 1, max_rows: int = 1 << 30):
    """The wrapper of rung `index`'s kernel: on a CUDA tensor it launches
    the kernel into a new output on the current stream (counted in
    ``.launches``); on a CPU tensor it runs `plain`."""

    def wrapper(x):
        check_i32("x", x, ndim=ndim)
        if x.shape[-1] < min_cols or x.numel() // max(1, x.shape[-1]) > max_rows:
            raise ValueError(f"{name} takes at least {min_cols} columns and at most "
                             f"{max_rows} rows, got {tuple(x.shape)}")
        if kernel_device(x).type == "cpu":
            return plain(x)
        from ytpu_torch.ops import _build

        lib = _lib()
        o = torch.empty_like(x)
        cols = x.shape[-1]
        err = getattr(lib, _SYMBOLS[index])(x.data_ptr(), o.data_ptr(), x.numel() // cols, cols,
                                            stream_of(x))
        _build.check(lib, err, name)
        wrapper.launches += 1
        return o

    wrapper.launches = 0
    wrapper.__name__ = name
    wrapper.__doc__ = (f"Rung {index} of the ladder: the CUDA kernel on CUDA tensors, "
                       f"`{plain.__name__}` on CPU tensors.")
    return wrapper


rung0_copy = _rung(0, "rung0_copy", copy_plain, ndim=2)
rung1_onehot_put = _rung(1, "rung1_onehot_put", onehot_put_plain)
rung2_mrow_mask = _rung(2, "rung2_mrow_mask", mrow_mask_plain)
rung3_fori_carry = _rung(3, "rung3_fori_carry", fori_carry_plain, min_cols=16)
rung4_while_scan = _rung(4, "rung4_while_scan", while_scan_plain, max_rows=256)
rung5_nested_fori = _rung(5, "rung5_nested_fori", nested_fori_plain)
rung6_pl_when = _rung(6, "rung6_pl_when", pl_when_plain)
rung7_big_tile = _rung(7, "rung7_big_tile", big_tile_plain, ndim=3)

# --- the rungs' inputs and asserts, as in the JAX ladder ----------------------------


def _zeros(dev):
    return torch.zeros((DB, C), dtype=I32, device=dev)


def _ones(dev):
    return torch.ones((DB, C), dtype=I32, device=dev)


def _row_ids(dev):
    return torch.arange(DB, dtype=I32, device=dev)[:, None].repeat(1, C)


def _col_ids(dev):
    return torch.arange(C, dtype=I32, device=dev)[None, :].repeat(DB, 1)


def _big_ones(dev):
    return torch.ones(BIG_SHAPE, dtype=I32, device=dev)


def _scan_reads(x) -> int:
    """Elements rung 4 reads on this input: each live row's x[d, o] for
    the steps before it breaks (a host replay of the loop)."""
    xs = x.cpu().numpy().astype(np.int64)
    D, C_ = xs.shape
    o, reads = 0, 0
    acc, brk = np.zeros(D, np.int64), np.zeros(D, bool)
    while ((o < 12) & ~brk).any():
        live = ~brk & (o < C_)
        reads += int(live.sum())
        acc = np.where(live, (acc + xs[:, min(o, C_ - 1)] + (1 << 31)) % (1 << 32) - (1 << 31), acc)
        brk |= acc > 40
        o += 1
    return reads


# (name, wrapper, plain, input maker, the JAX rung's assert or None, line)
RUNGS = [
    ("0_copy", rung0_copy, copy_plain, _zeros, lambda o: int(o[0, 0]) == 1, 102),
    ("1_onehot_put", rung1_onehot_put, onehot_put_plain, _row_ids,
     lambda o: int(o[3, 3]) == 7, 118),
    ("2_mrow_mask", rung2_mrow_mask, mrow_mask_plain, _row_ids,
     lambda o: int(o[1, 1]) == -1 and int(o[3, 3]) == 3, 134),
    ("3_fori_carry", rung3_fori_carry, fori_carry_plain, _ones,
     lambda o: int(o[0, 0]) == 16 * DB, 152),
    ("4_while_scan", rung4_while_scan, while_scan_plain, _col_ids, None, 182),
    ("5_nested_fori", rung5_nested_fori, nested_fori_plain, _ones, None, 201),
    ("6_pl_when", rung6_pl_when, pl_when_plain, _zeros, None, 218),
    ("7_big_tile", rung7_big_tile, big_tile_plain, _big_ones, None, 232),
]


def _io_bytes(x):
    return 2 * 4 * x.numel()


_BOUND_BYTES = {
    "0_copy": _io_bytes,
    "1_onehot_put": _io_bytes,
    "2_mrow_mask": _io_bytes,
    "3_fori_carry": lambda x: 4 * (x.shape[0] * 16 + x.numel()),
    "4_while_scan": lambda x: 4 * (_scan_reads(x) + x.numel()),
    "5_nested_fori": lambda x: 4 * (len({(4 * s + u) % x.shape[1] for s in range(8) for u in range(4)})
                                    + x.numel()),
    "6_pl_when": _io_bytes,
    "7_big_tile": _io_bytes,
}
_LIBRARY = {
    "0_copy": lambda x: (lambda: torch.add(x, 1)),
    "7_big_tile": lambda x: (lambda: torch.mul(x, 2)),
}

CASES = [
    KernelCase(
        name=fn.__name__, source=SOURCE, replaces=f"benches/mosaic_ladder.py:{line}", fn=fn,
        plain=plain, inputs=lambda dev, make=make: (make(dev),),
        bound_bytes=lambda args, b=_BOUND_BYTES[name]: b(*args),
        library=(lambda args, lib=_LIBRARY[name]: lib(*args)) if name in _LIBRARY else None,
    )
    for name, fn, plain, make, _, line in RUNGS
]

# --- rungs 8-10: the real integrate kernel ------------------------------------------


def load_ladder_logs():
    """``{rung name: (updates as bytes, expected text or None)}``."""
    with open(LOGS) as f:
        data = json.load(f)
    return {name: ([bytes.fromhex(h) for h in v["log"]], v["expect"]) for name, v in data.items()}


def run_kernel(log, expect, device=None) -> dict:
    """Decode `log` on the device and integrate it into 8 empty docs of 512
    slots through `apply_update_stream_fused`; raise unless the state
    equals the plain version's on the same decoded stream (every plane,
    start, block count and sticky error of every doc), the sticky error is
    0 and (when `expect` is given) doc 0 renders it."""
    from ytpu_torch.models.batch_doc import get_string, init_state
    from ytpu_torch.ops.decode_kernel import (
        RawPayloadView, decode_updates_v1, identity_rank, pack_updates,
    )
    from ytpu_torch.ops.integrate_kernel import (
        apply_update_stream_fused, integrate_stream_reference, pack_state, pack_stream,
        unpack_state,
    )

    dev = resolve_device(device)
    buf_np, lens_np = pack_updates(log)
    stream, _ = decode_updates_v1(
        torch.from_numpy(buf_np).to(dev), torch.from_numpy(lens_np).to(dev), max_rows=4, max_dels=8
    )
    rank = identity_rank(256, dev)
    st = apply_update_stream_fused(init_state(8, 512, dev), stream, rank)
    cols_k, meta_k = pack_state(st)
    cols_p, meta_p = pack_state(init_state(8, 512, dev))
    integrate_stream_reference(cols_p, meta_p, *pack_stream(stream), rank)
    cols_p, meta_p = pack_state(unpack_state(cols_p, meta_p))  # the words a state keeps
    max_abs_err = max(int((cols_k.long() - cols_p.long()).abs().max()),
                      int((meta_k.long() - meta_p.long()).abs().max()))
    if max_abs_err != 0:
        raise AssertionError(f"kernel and plain version differ (max abs err {max_abs_err}) at planes "
                             f"{(cols_k != cols_p).nonzero()[:4].tolist()}")
    err = int(st.error.max())
    if err != 0:
        raise AssertionError(f"kernel error flag {err}")
    if expect is not None:
        got = get_string(st, 0, RawPayloadView(buf_np))
        if got != expect:
            raise AssertionError(f"{got[:40]!r} != {expect[:40]!r}")
    return {"updates": len(log), "n_blocks_max": int(st.n_blocks.max()), "max_abs_err": max_abs_err}


# --- the ladder ---------------------------------------------------------------------


def run_ladder(device=None, on_attempt=None) -> dict:
    """Run rungs 0-10 on `device` (the GPU by default) and return
    ``{"device", "steps": {rung: {"status", "seconds", ...}}, "failures"}``.
    ``on_attempt(name)`` is called before each rung launches."""
    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    state = {"device": str(dev), "steps": {}}

    def run(name, fn):
        state["steps"][name] = {"status": "attempting"}
        state["last_attempt"] = name
        if on_attempt is not None:
            on_attempt(name)
        t0 = time.perf_counter()
        try:
            detail = fn()
            sync()
            state["steps"][name] = {"status": "ok", "seconds": time.perf_counter() - t0, **detail}
        except Exception as e:  # noqa: BLE001 - record and go on, as the JAX ladder does
            state["steps"][name] = {"status": "fail", "seconds": time.perf_counter() - t0,
                                    "error": f"{type(e).__name__}: {e}"[:800]}

    def rung(fn, plain, make, jax_assert):
        def go():
            x = make(dev)
            out = fn(x)
            sync()
            if jax_assert is not None and not jax_assert(out):
                raise AssertionError("the JAX rung's assert fails")
            want = plain(x)
            if not torch.equal(out, want):
                raise AssertionError(f"kernel and plain version differ at "
                                     f"{(out != want).nonzero()[:4].tolist()}")
            return {"max_abs_err": 0}

        return go

    for name, fn, plain, make, jax_assert, _ in RUNGS:
        run(name, rung(fn, plain, make, jax_assert))
    for name, (log, expect) in load_ladder_logs().items():
        run(name, lambda log=log, expect=expect: run_kernel(log, expect, dev))
    state["failures"] = [k for k, v in state["steps"].items() if v["status"] != "ok"]
    return state


def main() -> int:
    state = run_ladder(on_attempt=lambda name: print(f"attempting {name}", file=sys.stderr, flush=True))
    print(json.dumps(state))
    return 1 if state["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
