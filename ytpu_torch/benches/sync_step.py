"""Inputs and byte counts of the sync-step phase of ``chip_smoke.py``: the
write path (`apply_update_batch` on per-doc updates) and the read path
(`state_vectors` -> `encode_diff_batch` -> finisher / `DiffPipeline`).

- `config5_updates`: the seed of BASELINE config 5 (ytpu's
  ``benches/device.py::bench_config5``): client c+1 inserts
  ``"client-{c} "`` at index 0 of root ``text``, one update each, written
  with the port's `EncoderV1`.
- `lagged_batch`: step t of a stream replayed with a per-doc lag, doc d
  getting update ``t - lag[d]`` (the empty update before it starts), so
  every step's batch holds different updates per doc.
- `stream_state_vector`: the state vector of the rows of a decoded
  stream's first updates.
- `wire_chunk_tables`: the finisher tables of a stream decoded from an
  ``[S, L]`` wire matrix, as the batch ingestor keeps its fast lane's
  bytes: one chunk of a `ChunkedWirePayloads`, the stream's content refs
  rebased onto it (what the native finisher reads).
- `batch_bound_bytes` / `encode_diff_bound_bytes`: the bytes a launch of
  the per-doc integrate and a call of `encode_diff_batch` must move at
  least, counted from the inputs.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ytpu_torch.core.content import BLOCK_SKIP, CONTENT_STRING

__all__ = [
    "config5_updates",
    "lagged_batch",
    "stream_state_vector",
    "wire_chunk_tables",
    "batch_bound_bytes",
    "encode_diff_bound_bytes",
]


def config5_updates(n_clients: int = 64) -> List[bytes]:
    """One v1 update per client: one string item with no origin, parent the
    root ``text``, and an empty delete set."""
    from ytpu_torch.core.id_set import DeleteSet
    from ytpu_torch.encoding.codec import EncoderV1

    out = []
    for c in range(n_clients):
        enc = EncoderV1()
        enc.write_var(1)  # client sections
        enc.write_var(1)  # blocks of this client
        enc.write_client(c + 1)
        enc.write_var(0)  # first clock
        enc.write_info(CONTENT_STRING)
        enc.write_parent_info(True)
        enc.write_string("text")
        enc.write_string(f"client-{c} ")
        DeleteSet().encode(enc)
        out.append(enc.to_bytes())
    return out


def wire_chunk_tables(updates: List[bytes], stream, width: int, n_clients: int,
                      root_name: str = "text") -> Tuple[object, object]:
    """``(stream, tables)`` for a `stream` decoded from `updates` packed as
    an ``[S, width]`` matrix (`pack_updates`): the updates' bytes become the
    one chunk of a `ChunkedWirePayloads`, and each valid row's content ref
    ``s * width + start`` becomes ``-2 - (base + offset of update s in the
    chunk + start)``, as `BatchIngestor._merge_fast_lane` rebases its fast
    lane; the tables intern clients 0..`n_clients` - 1 at their raw ids."""
    from ytpu_torch.models.batch_doc import EncoderTables, PayloadStore
    from ytpu_torch.ops.decode_kernel import ChunkedWirePayloads

    payloads = ChunkedWirePayloads(PayloadStore())
    base = payloads.add_chunk(np.frombuffer(b"".join(updates), dtype=np.uint8))
    prefix = np.zeros(len(updates), dtype=np.int64)
    prefix[1:] = np.cumsum([len(p) for p in updates[:-1]])
    ref = stream.content_ref
    dev = ref.device
    lane = torch.arange(len(updates), dtype=torch.int64, device=dev)[:, None]
    start = torch.from_numpy(prefix).to(dev)[:, None] + ref.long() - lane * width
    rebased = torch.where(stream.valid & (ref >= 0), -2 - base - start, ref.long()).to(ref.dtype)
    return stream._replace(content_ref=rebased), EncoderTables.identity(n_clients, payloads, root_name)


def lagged_batch(stream, t: int, lag: torch.Tensor):
    """The ``[D, ...]`` `UpdateBatch` of step `t`: doc d gets step ``t -
    lag[d]`` of the ``[S, ...]`` `stream`, or an update with no valid row
    and no valid delete while ``t < lag[d]``."""
    src = t - lag
    started = src >= 0
    batch = type(stream)(*(f[src.clamp(min=0)] for f in stream))
    return batch._replace(valid=batch.valid & started[:, None],
                          del_valid=batch.del_valid & started[:, None])


def stream_state_vector(stream, n_updates: int, n_clients: int) -> torch.Tensor:
    """``[n_clients]`` int32: per client the largest ``clock + length`` over
    the valid rows (Skip rows left out) of the stream's first `n_updates`
    steps: the state vector of a doc that integrated them."""
    from ytpu_torch.ops.state_vector import sv_from_blocks

    keep = stream.valid[:n_updates] & (stream.kind[:n_updates] != BLOCK_SKIP)
    client = torch.where(keep, stream.client[:n_updates], torch.full_like(keep, -1, dtype=torch.int32))
    return sv_from_blocks(client.reshape(1, -1), stream.clock[:n_updates].reshape(1, -1),
                          stream.length[:n_updates].reshape(1, -1), n_clients)[0]


def batch_bound_bytes(D: int, U: int, R: int, K: int, rows_read: int, rows_added: int) -> int:
    """Bytes one per-doc integrate launch must move at least: the rows and
    deletes, the rank table, meta read and written, CL / CK / LN of every
    row the docs held before the launch (read to index them) and the 25
    planes the kernel writes of every row it added. Words changed in rows
    that existed before are left out, so this is a lower bound."""
    return 4 * (D * (U * 23 + R * 4) + K + 2 * D * 32 + 3 * rows_read + 25 * rows_added)


def encode_diff_bound_bytes(D: int, B: int, n_clients: int) -> int:
    """Bytes `encode_diff_batch` must move: it reads client, clock and
    length (int32) and deleted (bool) of every slot, n_blocks and the
    remote state vectors; it writes ship (bool), offsets (int32), deleted
    (bool) and the local state vectors."""
    reads = D * B * (3 * 4 + 1) + D * 4 + D * n_clients * 4
    writes = D * B * (1 + 4 + 1) + D * n_clients * 4
    return reads + writes
