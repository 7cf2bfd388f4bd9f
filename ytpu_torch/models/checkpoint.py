"""Checkpoint and resume of the batched device state (PyTorch port of
`ytpu.models.checkpoint`).

A checkpoint directory holds
- ``arrays.npz`` — the `DocStateBatch` fields as numpy arrays;
- ``host.pkl`` — the host sidecars that give the tensors meaning: the
  encoder's client interner, key interner, payload store and root name,
  plus (for a `BatchIngestor`) the per-doc state-vector mirrors, pending
  stashes and retained wire chunks, and (for a `DeviceSyncServer`) the
  tenant overlay.

The layout is the JAX package's (format 3), and this module reads files
that package wrote: its loader maps the pickled ``ytpu.core.*`` classes
(content objects in the payload store, carriers in the pending stashes)
to the same-named classes of ``ytpu_torch.core.*`` and refuses every other
class. A file whose arrays were saved with orbax is refused.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional, Tuple

import numpy as np
import torch

from ytpu_torch.core.device import resolve_device
from ytpu_torch.models.batch_doc import BatchEncoder, BlockCols, DocStateBatch
from ytpu_torch.models.ingest import BatchIngestor

__all__ = [
    "save_state",
    "load_state",
    "save_ingestor",
    "load_ingestor",
    "load_ingestor_with_extra",
    "save_device_server",
    "load_device_server",
]

# 3: BlockCols holds the origin_slot cache column; format-2 files restore
#    with the cache recomputed at load
_FORMAT = 3
_READABLE_FORMATS = (2, 3)


def _state_to_numpy(state: DocStateBatch) -> dict:
    flat = {f"blocks.{k}": v.cpu().numpy() for k, v in state.blocks._asdict().items()}
    flat["start"] = state.start.cpu().numpy()
    flat["n_blocks"] = state.n_blocks.cpu().numpy()
    flat["error"] = state.error.cpu().numpy()
    return flat


def _state_from_numpy(flat: dict, device) -> DocStateBatch:
    def tensor(a):
        return torch.tensor(a, device=device)

    cols = {k.split(".", 1)[1]: tensor(v) for k, v in flat.items() if k.startswith("blocks.")}
    needs_cache = "origin_slot" not in cols  # a format-2 checkpoint
    if needs_cache:
        cols["origin_slot"] = torch.full_like(cols["client"], -1)
    state = DocStateBatch(
        blocks=BlockCols(**cols),
        start=tensor(flat["start"]),
        n_blocks=tensor(flat["n_blocks"]),
        error=tensor(flat["error"]),
    )
    if needs_cache:
        from ytpu_torch.models.batch_doc import recompute_origin_slot

        state = recompute_origin_slot(state)
    return state


def _enc_sidecar(enc: BatchEncoder) -> dict:
    return {
        "root_name": enc.root_name,
        "root_adopted": getattr(enc, "_root_adopted", False),
        "interner_from_idx": list(enc.interner.from_idx),
        "key_names": dict(enc.keys.names),
        "payload_items": list(enc.payloads.items),
        "saw_map_or_nested": enc.saw_map_or_nested,
        "saw_move": enc.saw_move,
    }


def _enc_restore(side: dict) -> BatchEncoder:
    enc = BatchEncoder(root_name=side["root_name"])
    enc._root_adopted = bool(side.get("root_adopted", False))
    for client in side["interner_from_idx"]:
        enc.interner.intern(client)
    for kid in sorted(side["key_names"]):
        if enc.keys.intern(side["key_names"][kid]) != kid:
            raise ValueError(f"checkpoint key table is not dense at key id {kid}")
    enc.payloads.items = list(side["payload_items"])
    enc.saw_map_or_nested = side["saw_map_or_nested"]
    enc.saw_move = side["saw_move"]
    return enc


def save_state(path: str, state: DocStateBatch, enc: BatchEncoder) -> None:
    """Persist a device state and its host sidecars under `path` (a dir)."""
    _save(path, state, {"format": _FORMAT, "enc": _enc_sidecar(enc)})


def load_state(path: str, device=None) -> Tuple[DocStateBatch, BatchEncoder]:
    """The state (on `device`, the GPU unless it says otherwise) and its
    encoder."""
    state, side = _load(path, device)
    return state, _enc_restore(side["enc"])


def save_ingestor(path: str, ing: BatchIngestor, extra: Optional[dict] = None) -> None:
    """Persist a BatchIngestor: device state, encoder, pending stashes and
    retained wire chunks. `extra` rides the sidecar for embedding layers
    (the `DeviceSyncServer` tenant overlay)."""
    from ytpu_torch.models.batch_doc import ensure_origin_slot

    # refresh a stale cache once and keep it: save-then-continue must not
    # pay the rebuild again on the next apply
    ing.state = ensure_origin_slot(ing.state)
    side = {
        "extra": extra or {},
        "format": _FORMAT,
        "enc": _enc_sidecar(ing.enc),
        "n_docs": ing.n_docs,
        "ingest": ing.ingest,
        "svs": [dict(sv.clocks) for sv in ing.svs],
        "pending": [{c: list(q) for c, q in stash.items()} for stash in ing._pending],
        "pending_ds": [{c: list(rs) for c, rs in ds.clients.items()} for ds in ing._pending_ds],
        # retained wire chunks resolve device-decoded refs (<= -2)
        "wire_chunks": [(base, flat.tobytes()) for base, flat in ing.payloads._chunks],
        "wire_total": ing.payloads.total_bytes,
        # multi-root docs: the name mapped to the implicit branch, and
        # the roots already anchored (their anchor rows are in the state)
        "primary_roots": dict(ing.primary_roots),
        "anchored_roots": [sorted(s) for s in ing._anchored_roots],
    }
    _save(path, ing.state, side)


def load_ingestor(path: str, device=None) -> BatchIngestor:
    return load_ingestor_with_extra(path, device)[0]


def load_ingestor_with_extra(path: str, device=None) -> Tuple[BatchIngestor, dict]:
    """Like `load_ingestor`, also returning the embedder sidecar saved via
    `save_ingestor(..., extra=...)`."""
    from ytpu_torch.core.id_set import DeleteSet
    from ytpu_torch.core.state_vector import StateVector

    device = resolve_device(device)
    state, side = _load(path, device)
    # capacity 1: the loaded state replaces the one the constructor makes
    ing = BatchIngestor(side["n_docs"], 1, enc=_enc_restore(side["enc"]), ingest=side.get("ingest", "raw"),
                        device=device)
    ing.state = state
    ing.svs = [StateVector(dict(c)) for c in side["svs"]]
    ing._pending = [dict(p) for p in side["pending"]]
    ing._pending_ds = [DeleteSet(dict(d)) for d in side["pending_ds"]]
    ing.payloads._chunks = [(base, np.frombuffer(raw, dtype=np.uint8)) for base, raw in side.get("wire_chunks", [])]
    ing.payloads.total_bytes = side.get("wire_total", 0)
    # the device hash tables, from the restored interners
    for key in list(ing.enc.keys.ids):
        ing._register_key(key)
    for cid in list(ing.enc.interner.from_idx):
        if cid > 2**31 - 1:
            ing._register_big_client(cid)
    ing.primary_roots = {int(d): name for d, name in side.get("primary_roots", {}).items()}
    ing._anchored_roots = [set(s) for s in side.get("anchored_roots", [[] for _ in range(ing.n_docs)])]
    return ing, dict(side.get("extra", {}))


def save_device_server(path: str, server) -> None:
    """Persist a DeviceSyncServer: the ingestor checkpoint plus the tenant
    overlay (slot assignments, wire root names, host-resident tenants) and
    the host docs that are authoritative (every tenant's in mirrored mode,
    the host-resident tenants' in device-authoritative mode), each as its
    v1 state update. Queued updates integrate first, so an acknowledged
    update is never lost across a restart."""
    server.flush_device()
    names = server.tenants if not server.device_authoritative else server._host_tenants
    host_docs = {name: server.doc(name).encode_state_as_update_v1() for name in names}
    save_ingestor(
        path,
        server.ingestor,
        extra={
            "slot_of": dict(server._slot_of),
            "root_names": dict(server._root_names),
            "host_tenants": sorted(server._host_tenants),
            "host_docs": host_docs,
            "device_authoritative": server.device_authoritative,
        },
    )


def load_device_server(path: str, device=None, **server_kwargs):
    """Restore a DeviceSyncServer around a checkpointed ingestor, in the
    mode it was saved in unless `server_kwargs` say otherwise. Sessions are
    transient (clients resync through the greeting); slot assignments, root
    names and the saved host docs are durable. The host docs are rebuilt by
    the server's ``doc_factory`` and the saved state applied to them: pass
    the factory the server had where client ids matter."""
    from ytpu_torch.sync.device_server import DeviceSyncServer

    ing, extra = load_ingestor_with_extra(path, device)
    server_kwargs.setdefault("device_authoritative", extra.get("device_authoritative", False))
    server = DeviceSyncServer(ingestor=ing, **server_kwargs)
    server._slot_of = dict(extra.get("slot_of", {}))
    server._root_names = dict(extra.get("root_names", {}))
    server._host_tenants = set(extra.get("host_tenants", []))
    used = set(server._slot_of.values())
    server._next_slot = max(used, default=-1) + 1
    server._free_slots = sorted(set(range(server._next_slot)) - used)
    # register the tenants, so greetings answer from the restored slots
    for name in server._slot_of:
        server.tenant(name)
    for name, payload in extra.get("host_docs", {}).items():
        server.doc(name).apply_update_v1(payload)
    return server


# --- storage -------------------------------------------------------------------------


class _PortUnpickler(pickle._Unpickler):
    """Reads host sidecars written by either package: ``ytpu.core.*`` and
    ``ytpu_torch.core.*`` classes resolve to ``ytpu_torch.core.*`` and every
    other global is refused. An object's saved slots that its port class
    lacks (the JAX package's host-CRDT links of an Item or a Branch, which
    a stashed carrier or a stored content object does not use) are
    dropped. The pure-Python unpickler is the one whose BUILD step a
    subclass can replace."""

    dispatch = dict(pickle._Unpickler.dispatch)

    def find_class(self, module, name):
        import importlib

        for prefix in ("ytpu.core.", "ytpu_torch.core."):
            if module.startswith(prefix):
                try:
                    mod = importlib.import_module("ytpu_torch.core." + module[len(prefix):])
                    return getattr(mod, name)
                except (ImportError, AttributeError):
                    break
        raise pickle.UnpicklingError(f"checkpoint sidecar refers to {module}.{name}, which the port lacks")

    def load_build(self):
        state = self.stack.pop()
        inst = self.stack[-1]
        setstate = getattr(inst, "__setstate__", None)
        if setstate is not None:
            setstate(state)
            return
        slots = {s for c in type(inst).__mro__ for s in getattr(c, "__slots__", ())}
        inst_dict, slot_state = state if isinstance(state, tuple) else (state, None)
        for k, v in {**(inst_dict or {}), **(slot_state or {})}.items():
            if k in slots:
                setattr(inst, k, v)
            elif hasattr(inst, "__dict__"):
                inst.__dict__[k] = v

    dispatch[pickle.BUILD[0]] = load_build


def _save(path: str, state: DocStateBatch, sidecar: dict) -> None:
    """Overwrites an earlier checkpoint at `path`."""
    import shutil

    from ytpu_torch.models.batch_doc import ensure_origin_slot

    os.makedirs(path, exist_ok=True)
    # format 3 persists the origin_slot cache: refresh it where stale
    flat = _state_to_numpy(ensure_origin_slot(state))
    arrays_dir = os.path.join(path, "arrays")
    if os.path.exists(arrays_dir):  # an earlier orbax save of the JAX package
        shutil.rmtree(arrays_dir)
    np.savez_compressed(os.path.join(path, "arrays.npz"), **flat)
    sidecar = dict(sidecar)
    sidecar["saved_with"] = "npz"
    with open(os.path.join(path, "host.pkl"), "wb") as f:
        pickle.dump(sidecar, f)


def _load(path: str, device=None) -> Tuple[DocStateBatch, dict]:
    with open(os.path.join(path, "host.pkl"), "rb") as f:
        side = _PortUnpickler(f).load()
    if side.get("format") not in _READABLE_FORMATS:
        raise ValueError(f"unsupported checkpoint format {side.get('format')}")
    if side.get("saved_with") == "orbax":
        raise ValueError(f"checkpoint {path} holds orbax arrays, which the port cannot read: "
                         "save it where orbax is absent (arrays.npz)")
    with np.load(os.path.join(path, "arrays.npz"), allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    return _state_from_numpy(flat, resolve_device(device)), side
