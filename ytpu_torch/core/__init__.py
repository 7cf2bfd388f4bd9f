"""The host CRDT core (copy of `ytpu.core`): ids, state vectors and id sets;
blocks and the block store; the doc store, transactions, updates and `Doc`.
The shared types are in `ytpu_torch.types`, and `device` holds the port's
device resolution.

The names below load on first use: the wire codecs import `core.content`,
and an eager import of `Doc` from here would import them back.
"""

import importlib

_EXPORTS = {
    "ID": "ids",
    "ClientID": "ids",
    "StateVector": "state_vector",
    "Snapshot": "state_vector",
    "IdSet": "id_set",
    "DeleteSet": "id_set",
    "Item": "block",
    "GCRange": "block",
    "SkipRange": "block",
    "BlockStore": "block_store",
    "ClientBlockList": "block_store",
    "Branch": "branch",
    "Doc": "doc",
    "Options": "doc",
    "Transaction": "transaction",
    "Update": "update",
    "PendingUpdate": "update",
    "decode_update_v1": "update",
    "merge_updates_v1": "update",
    "encode_state_vector_from_update_v1": "update",
    "diff_updates_v1": "update",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
