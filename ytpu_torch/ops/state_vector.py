"""Batched state-vector math (PyTorch port of `ytpu.ops.state_vector`).

A batch of state vectors is a dense ``[n_docs, n_clients]`` int32 tensor
over a host-interned client dictionary; every op is elementwise or a
reduction (yrs state_vector.rs:21-105, store.rs:234-248).
"""

from __future__ import annotations

import torch

__all__ = [
    "sv_merge",
    "sv_contains_all",
    "sv_diff_mask",
    "sv_from_blocks",
    "diff_start_clocks",
]


def sv_merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise max over ``[D, C]`` clock tensors."""
    return torch.maximum(a, b)


def sv_contains_all(local: torch.Tensor, remote: torch.Tensor) -> torch.Tensor:
    """``[D]`` bool: does `local` dominate `remote` per doc?"""
    return (local >= remote).all(dim=-1)


def sv_diff_mask(local: torch.Tensor, remote: torch.Tensor) -> torch.Tensor:
    """``[D, C]`` bool: clients for which local has blocks the remote lacks
    (the batched `diff_state_vectors`, store.rs:234-248)."""
    return local > remote


def diff_start_clocks(local: torch.Tensor, remote: torch.Tensor) -> torch.Tensor:
    """``[D, C]`` int32: first clock to ship per (doc, client); -1 if none."""
    return torch.where(local > remote, remote, torch.full_like(remote, -1))


def sv_from_blocks(
    blk_client: torch.Tensor,  # [D, B] int32 interned client (-1 unused)
    blk_clock: torch.Tensor,
    blk_len: torch.Tensor,
    n_clients: int,
) -> torch.Tensor:
    """``[D, n_clients]`` int32 state vectors from block columns: the
    per-(doc, client) max of ``clock + length`` over rows with a client,
    0 where a client has none. Clients at or past `n_clients` are
    dropped, as a segment max drops out-of-range segment ids."""
    end = blk_clock + blk_len
    keep = (blk_client >= 0) & (blk_client < n_clients)
    idx = torch.where(keep, blk_client, torch.zeros_like(blk_client)).long()
    contrib = torch.where(keep, end, torch.zeros_like(end)).to(torch.int32)
    out = torch.zeros(
        (blk_client.shape[0], n_clients), dtype=torch.int32, device=blk_client.device
    )
    return out.scatter_reduce_(1, idx, contrib, reduce="amax", include_self=True)
