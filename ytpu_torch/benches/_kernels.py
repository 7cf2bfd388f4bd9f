"""What the diagnostic kernels' wrappers share: argument checks, the
launch stream, and the `KernelCase` record that lists each kernel with its
plain version, its inputs and the least bytes it must move, for the
comparisons and timings of ``chip_smoke.py``."""

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
    is None, else `out`, checked to match `x` in shape and device."""
    if out is None:
        return x
    check_i32("out", out, ndim=x.dim())
    if out.shape != x.shape or out.device != x.device:
        raise ValueError(f"out is {tuple(out.shape)} on {out.device}, x {tuple(x.shape)} on {x.device}")
    return out


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current CUDA stream on `t`'s device (a launch goes there)."""
    return torch.cuda.current_stream(t.device).cuda_stream


def copy_library(x: torch.Tensor):
    """The one PyTorch call of a passthrough: ``out.copy_(x)`` into a
    preallocated tensor."""
    out = torch.empty_like(x)
    return lambda: out.copy_(x)
