"""What the diagnostic kernels' wrappers share: argument checks, the
launch stream, the `KernelCase` record that lists each kernel with its
plain version, its inputs and the least bytes it must move, for the
comparisons and timings of ``chip_smoke.py``, and `graph_ms`, the device
time of a call inside a CUDA graph."""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ytpu_torch.ops.integrate_kernel import _check_int32
from ytpu_torch.ops.integrate_kernel import _to_i32 as wrap_i32  # int64 -> int32, wrapping

I32 = torch.int32


class KernelCase(NamedTuple):
    """One diagnostic kernel at the shapes its program gives it."""

    name: str
    source: str  # the CUDA source in the repo
    replaces: str  # file:line of the TPU kernel's pallas_call
    fn: Callable  # the wrapper (kernel on CUDA tensors, plain on CPU ones)
    plain: Callable  # the plain PyTorch version, called with the same args
    inputs: Callable  # device -> tuple of fresh input tensors
    bound_bytes: Callable  # args -> bytes the function must move at least
    library: Optional[Callable] = None  # args -> () -> one PyTorch call


def check_i32(name: str, t, ndim: int) -> None:
    """A contiguous int32 tensor of `ndim` dims (the integrate wrapper's check)."""
    _check_int32(name, t, ndim, t.device if torch.is_tensor(t) else None)


def kernel_device(*tensors) -> torch.device:
    """The one device of `tensors`: ``cpu`` selects the plain version,
    ``cuda`` the kernel; any other device, or a mix, raises."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the kernels run on cuda or cpu tensors, not {dev}")
    return dev


def out_for(x: torch.Tensor, out: Optional[torch.Tensor]) -> torch.Tensor:
    """Where a kernel writes `x`'s result: `x` itself (in place) when `out`
    is None, else `out`, checked to match `x` in shape and device. An `out`
    at `x`'s address is the in-place call; one that overlaps `x` elsewhere
    raises (the kernels read `x` as memory no store of theirs touches)."""
    if out is None:
        return x
    check_i32("out", out, ndim=x.dim())
    if out.shape != x.shape or out.device != x.device:
        raise ValueError(f"out is {tuple(out.shape)} on {out.device}, x {tuple(x.shape)} on {x.device}")
    x0, o0 = x.data_ptr(), out.data_ptr()
    if o0 != x0 and o0 < x0 + x.numel() * x.element_size() and x0 < o0 + out.numel() * out.element_size():
        raise ValueError(f"out overlaps x {(o0 - x0) // x.element_size():+d} elements from it")
    return out


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current CUDA stream on `t`'s device (a launch goes there)."""
    return torch.cuda.current_stream(t.device).cuda_stream


def copy_library(x: torch.Tensor):
    """The one PyTorch call of a passthrough: ``out.copy_(x)`` into a
    preallocated tensor."""
    out = torch.empty_like(x)
    return lambda: out.copy_(x)


def graph_ms(fn, reps: int = 200, rounds: int = 5) -> dict:
    """Device ms per call of `fn` on the GPU: `reps` calls captured in one
    CUDA graph, replayed `rounds` times, each between two CUDA events (no
    host issue time in the measure); the min, mean and max over the
    rounds. A capture the runtime refuses raises."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    per_round = []
    for _ in range(rounds):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        graph.replay()
        stop.record()
        torch.cuda.synchronize()
        per_round.append(start.elapsed_time(stop) / reps)
    del graph
    return {"min": min(per_round), "mean": sum(per_round) / rounds, "max": max(per_round)}


def empty_launch(grid, block, device):
    """A call that launches the empty kernel of ``csrc/plane_rmw.cu`` at
    `grid` x `block` (up to 3 dims each) on `device`'s current stream:
    the launch floor, timed with `graph_ms` beside a kernel of that grid."""
    from ytpu_torch.benches.plane_rmw_repro import plane_lib
    from ytpu_torch.ops import _build

    lib = plane_lib()
    g = (list(grid) + [1, 1])[:3]
    b = (list(block) + [1, 1])[:3]

    def call():  # the stream is read at each call: a graph capture switches it
        err = lib.ytpu_empty_launch(*g, *b, torch.cuda.current_stream(device).cuda_stream)
        _build.check(lib, err, "empty_launch")

    return call


# CUgraphNodeType of the driver API
_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty"}


def graph_nodes(fn) -> list:
    """The nodes of a CUDA graph that captured one call of `fn`, read back
    through the driver API: ``{"type", "grid", "block"}`` each (``type``
    ``kernel``, ``memcpy``, ``memset``...; grid and block only for
    kernels), in the driver's order."""
    import ctypes

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    cuda = ctypes.CDLL("libcuda.so.1")
    graph = ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)

    def check(err, what):
        if err:
            raise RuntimeError(f"{what} failed: CUresult {err}")

    check(cuda.cuGraphGetNodes(graph, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(cuda.cuGraphGetNodes(graph, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    out = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)), "cuGraphNodeGetType")
        entry = {"type": _NODE_TYPES.get(kind.value, str(kind.value)), "grid": None, "block": None}
        if kind.value == 0:
            # CUDA_KERNEL_NODE_PARAMS: a function handle, then grid x/y/z and
            # block x/y/z as unsigned ints (the buffer covers the v2 layout)
            params = (ctypes.c_uint32 * 32)()
            check(cuda.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), params),
                  "cuGraphKernelNodeGetParams")
            entry["grid"], entry["block"] = list(params[2:5]), list(params[5:8])
        out.append(entry)
    del g
    return out
