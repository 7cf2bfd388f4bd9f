"""The one rule for where the port's entry points put their tensors.

``device=None`` means the GPU; a missing GPU raises instead of falling
back to the CPU. Callers that want the CPU (the tests, the plain
versions) pass ``device="cpu"``.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU; a missing GPU raises (no CPU fallback)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
