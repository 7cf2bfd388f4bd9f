"""Carry packed state and streams between numpy arrays and the port's
tensors.

The JAX package's packed state is an ``[26, D, C]`` int32 plane stack and a
``[D, 32]`` int32 meta tile; its stacked stream packs to ``[S, U, 23]``
rows and ``[S, R, 4]`` deletes. ``np.asarray`` of those arrays converts
here to contiguous int32 tensors on a device, and back. A `DocStateBatch`
(its `BlockCols` planes, ``start``, ``n_blocks``, ``error``) converts
through a dict of numpy arrays, so both packages can start from one
snapshot.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ytpu_torch.core.device import resolve_device

__all__ = [
    "packed_from_numpy",
    "packed_to_numpy",
    "state_from_numpy",
    "state_to_numpy",
    "stream_from_numpy",
]


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(a), dtype=np.int32, order="C")).to(device)


def packed_from_numpy(cols, meta, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """numpy ``[26, D, C]`` cols / ``[D, 32]`` meta -> int32 tensors (on the
    GPU unless `device` says otherwise)."""
    device = resolve_device(device)
    cols_t, meta_t = _tensor(cols, device), _tensor(meta, device)
    if cols_t.dim() != 3 or cols_t.shape[0] != 26 or tuple(meta_t.shape) != (cols_t.shape[1], 32):
        raise ValueError(f"not a packed state: {tuple(cols_t.shape)} / {tuple(meta_t.shape)}")
    return cols_t, meta_t


def packed_to_numpy(cols: torch.Tensor, meta: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    """Packed tensors -> numpy int32 arrays on the host."""
    return cols.cpu().numpy().astype(np.int32), meta.cpu().numpy().astype(np.int32)


def stream_from_numpy(rows, dels, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """numpy ``[S, U, 23]`` rows / ``[S, R, 4]`` deletes -> int32 tensors (on
    the GPU unless `device` says otherwise)."""
    device = resolve_device(device)
    rows_t, dels_t = _tensor(rows, device), _tensor(dels, device)
    if rows_t.dim() != 3 or rows_t.shape[2] != 23 or dels_t.dim() != 3 or dels_t.shape[2] != 4:
        raise ValueError(f"not a packed stream: {tuple(rows_t.shape)} / {tuple(dels_t.shape)}")
    return rows_t, dels_t


def state_to_numpy(state) -> Dict[str, np.ndarray]:
    """A `DocStateBatch` (either package's: a NamedTuple of array-likes)
    -> ``{plane name: [D, C] array, "start" / "n_blocks" / "error": [D]}``,
    int32 except the bool planes ``deleted`` and ``countable``."""
    out = {}
    for name in state.blocks._fields:
        a = getattr(state.blocks, name)
        a = a.cpu().numpy() if torch.is_tensor(a) else np.array(a)
        out[name] = a.astype(bool if a.dtype == bool else np.int32)
    for name in ("start", "n_blocks", "error"):
        a = getattr(state, name)
        out[name] = (a.cpu().numpy() if torch.is_tensor(a) else np.array(a)).astype(np.int32)
    return out


def state_from_numpy(arrays: Dict[str, np.ndarray], device=None):
    """The inverse of `state_to_numpy`: a port `DocStateBatch` on a device
    (the GPU unless `device` says otherwise)."""
    from ytpu_torch.models.batch_doc import BlockCols, DocStateBatch

    device = resolve_device(device)

    def t(name):
        a = np.asarray(arrays[name])
        dtype = torch.bool if a.dtype == bool else torch.int32
        return torch.from_numpy(np.array(a, dtype=bool if a.dtype == bool else np.int32, order="C")).to(
            device, dtype)

    blocks = BlockCols(*(t(name) for name in BlockCols._fields))
    return DocStateBatch(blocks, t("start"), t("n_blocks"), t("error"))
