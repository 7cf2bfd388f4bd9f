"""Doc, the document handle, and its options (copy of `ytpu.core.doc`;
parity target: yrs doc.rs, `Doc` :57, constructors :77-123, root-type
getters :156-228, observers :230-621, sub-documents :625-678, `Options`
:754-838, wire form :840-872, and the `Transact` trait :886-965).

`Doc()` draws its client id from `random` and its guid from `uuid`, as the
JAX package's does: pass `client_id` (and `guid`) for a reproducible doc.
"""

from __future__ import annotations

import random
import uuid
from typing import Callable, Dict, List, Optional

from ytpu_torch.encoding.lib0 import Cursor, Writer, read_any, write_any

from .branch import (
    Branch,
    TYPE_ARRAY,
    TYPE_MAP,
    TYPE_TEXT,
    TYPE_XML_ELEMENT,
    TYPE_XML_FRAGMENT,
    TYPE_XML_TEXT,
)
from .state_vector import Snapshot, StateVector
from .store import DocStore
from .transaction import Transaction
from .update import Update

__all__ = ["Doc", "Options", "OFFSET_UTF16", "OFFSET_BYTES"]

OFFSET_UTF16 = 0
OFFSET_BYTES = 1


class Options:
    __slots__ = (
        "client_id",
        "guid",
        "collection_id",
        "offset_kind",
        "skip_gc",
        "auto_load",
        "should_load",
    )

    def __init__(
        self,
        client_id: Optional[int] = None,
        guid: Optional[str] = None,
        collection_id: Optional[str] = None,
        offset_kind: int = OFFSET_UTF16,
        skip_gc: bool = False,
        auto_load: bool = False,
        should_load: bool = True,
    ):
        if client_id is None:
            client_id = random.getrandbits(32)
        if guid is None:
            guid = str(uuid.uuid4())
        self.client_id = client_id
        self.guid = guid
        self.collection_id = collection_id
        self.offset_kind = offset_kind
        self.skip_gc = skip_gc
        self.auto_load = auto_load
        self.should_load = should_load

    def encode(self, enc) -> None:
        """Parity: doc.rs:814-845."""
        from ytpu_torch.encoding.lib0 import BigInt

        enc.write_string(self.guid)
        m: Dict[str, object] = {"gc": not self.skip_gc}
        if self.collection_id is not None:
            m["collectionId"] = self.collection_id
        m["encoding"] = BigInt(1 if self.offset_kind == OFFSET_BYTES else 0)
        m["autoLoad"] = self.auto_load
        m["shouldLoad"] = self.should_load
        enc.write_any(m)

    @classmethod
    def decode(cls, dec) -> "Options":
        guid = dec.read_string()
        opts = cls(guid=guid, should_load=False)
        m = dec.read_any()
        if isinstance(m, dict):
            if isinstance(m.get("gc"), bool):
                opts.skip_gc = not m["gc"]
            if isinstance(m.get("autoLoad"), bool):
                opts.auto_load = m["autoLoad"]
            if isinstance(m.get("collectionId"), str):
                opts.collection_id = m["collectionId"]
            if m.get("encoding") == 1:
                opts.offset_kind = OFFSET_BYTES
        opts.should_load = opts.should_load or opts.auto_load
        return opts


class Doc:
    """A CRDT document: a set of root shared types over one block store."""

    def __init__(self, client_id: Optional[int] = None, options: Optional[Options] = None, **kw):
        if options is None:
            options = Options(client_id=client_id, **kw)
        self.options = options
        self.store = DocStore(self)
        self.parent_doc: Optional["Doc"] = None
        self.parent_item = None
        self.destroyed = False
        self.loaded = False
        self._txn: Optional[Transaction] = None
        # observers
        self.update_v1_subs: List[Callable] = []
        self.update_v2_subs: List[Callable] = []
        self.after_transaction_subs: List[Callable] = []
        self.transaction_cleanup_subs: List[Callable] = []
        self.subdocs_subs: List[Callable] = []
        self.destroy_subs: List[Callable] = []

    # --- identity --------------------------------------------------------------

    @property
    def client_id(self) -> int:
        return self.options.client_id

    @client_id.setter
    def client_id(self, value: int) -> None:
        self.options.client_id = value

    @property
    def guid(self) -> str:
        return self.options.guid

    # --- transactions ----------------------------------------------------------

    def transact(self, origin=None) -> Transaction:
        if self._txn is not None:
            raise RuntimeError("a transaction is already active on this Doc")
        txn = Transaction(self, origin)
        self._txn = txn
        return txn

    # --- root types ------------------------------------------------------------

    def get_text(self, name: str):
        from ytpu_torch.types.text import Text

        return Text(self.store.get_or_create_type(name, TYPE_TEXT))

    def get_array(self, name: str):
        from ytpu_torch.types.array import Array

        return Array(self.store.get_or_create_type(name, TYPE_ARRAY))

    def get_map(self, name: str):
        from ytpu_torch.types.map import Map

        return Map(self.store.get_or_create_type(name, TYPE_MAP))

    def get_xml_fragment(self, name: str):
        from ytpu_torch.types.xml import XmlFragment

        return XmlFragment(self.store.get_or_create_type(name, TYPE_XML_FRAGMENT))

    def get_xml_text(self, name: str):
        from ytpu_torch.types.xml import XmlText

        return XmlText(self.store.get_or_create_type(name, TYPE_XML_TEXT))

    # --- convenience -----------------------------------------------------------

    def apply_update_v1(self, data: bytes, origin=None) -> None:
        with self.transact(origin) as txn:
            txn.apply_update(Update.decode_v1(data))

    def apply_update_v2(self, data: bytes, origin=None) -> None:
        with self.transact(origin) as txn:
            txn.apply_update(Update.decode_v2(data))

    def encode_state_as_update_v1(self, remote_sv: Optional[StateVector] = None) -> bytes:
        return self.store.encode_state_as_update_v1(remote_sv or StateVector())

    def encode_state_as_update_v2(self, remote_sv: Optional[StateVector] = None) -> bytes:
        return self.store.encode_state_as_update_v2(remote_sv or StateVector())

    def state_vector(self) -> StateVector:
        return self.store.blocks.get_state_vector()

    def snapshot(self) -> Snapshot:
        return self.store.snapshot()

    def encode_state_from_snapshot(self, snapshot: Snapshot) -> bytes:
        """Encode the document as it looked at `snapshot` (requires skip_gc)."""
        return self.store.encode_state_from_snapshot(snapshot)

    def to_json(self) -> dict:
        from ytpu_torch.types import wrap_branch

        out = {}
        for name, branch in self.store.types.items():
            out[name] = wrap_branch(branch).to_json()
        return out

    # --- observers -------------------------------------------------------------

    def observe_update_v1(self, cb: Callable) -> Callable[[], None]:
        self.update_v1_subs.append(cb)
        return lambda: self.update_v1_subs.remove(cb)

    def observe_update_v2(self, cb: Callable) -> Callable[[], None]:
        self.update_v2_subs.append(cb)
        return lambda: self.update_v2_subs.remove(cb)

    def observe_after_transaction(self, cb: Callable) -> Callable[[], None]:
        self.after_transaction_subs.append(cb)
        return lambda: self.after_transaction_subs.remove(cb)

    def observe_transaction_cleanup(self, cb: Callable) -> Callable[[], None]:
        self.transaction_cleanup_subs.append(cb)
        return lambda: self.transaction_cleanup_subs.remove(cb)

    def observe_subdocs(self, cb: Callable) -> Callable[[], None]:
        self.subdocs_subs.append(cb)
        return lambda: self.subdocs_subs.remove(cb)

    def observe_destroy(self, cb: Callable) -> Callable[[], None]:
        self.destroy_subs.append(cb)
        return lambda: self.destroy_subs.remove(cb)

    # --- subdoc lifecycle ------------------------------------------------------

    def load(self, parent_txn=None) -> None:
        """Request loading of a sub-document (parity: doc.rs:625-648)."""
        if self.loaded or self.parent_doc is None:
            self.loaded = True
            return
        self.loaded = True
        item = self.parent_item
        if item is not None and not item.deleted:
            self.options.should_load = True
            if parent_txn is not None:
                parent_txn.subdocs_loaded[self.guid] = self

    def destroy(self) -> None:
        if self.destroyed:
            return
        self.destroyed = True
        for cb in self.destroy_subs:
            cb(self)
        self.update_v1_subs.clear()
        self.after_transaction_subs.clear()
        self.transaction_cleanup_subs.clear()
        self.subdocs_subs.clear()
        self.destroy_subs.clear()

    def __repr__(self) -> str:
        return f"Doc(client_id={self.client_id}, guid={self.guid!r})"
