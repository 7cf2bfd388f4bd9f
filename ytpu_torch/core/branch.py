"""Branch, the shared-type node of the host CRDT (copy of
`ytpu.core.branch`; parity target: yrs branch.rs:173-215 and `TypeRef`,
types/mod.rs:36-199).

Every shared type (Text, Array, Map, XmlElement, ...) is a view of a
`Branch`: a sequence component (the `start` linked chain) and a map
component (per-key chains in `map`), tagged with a `type_ref`. A
`ContentType` carries one on the wire as its TypeRef; on the device a
ContentType row owns its child sequence through its `head` column.
"""

from __future__ import annotations

from typing import Dict, List, Optional, TYPE_CHECKING

from ytpu_torch.encoding.lib0 import Cursor, Writer

from .ids import ID
from .moving import ASSOC_AFTER, ASSOC_BEFORE, StickyIndex

if TYPE_CHECKING:
    from .block import Item

__all__ = [
    "TYPE_ARRAY",
    "TYPE_MAP",
    "TYPE_TEXT",
    "TYPE_XML_ELEMENT",
    "TYPE_XML_FRAGMENT",
    "TYPE_XML_HOOK",
    "TYPE_XML_TEXT",
    "TYPE_WEAK",
    "TYPE_DOC",
    "TYPE_UNDEFINED",
    "Branch",
    "LinkSource",
]

# Wire tags; parity: types/mod.rs:36-64.
TYPE_ARRAY = 0
TYPE_MAP = 1
TYPE_TEXT = 2
TYPE_XML_ELEMENT = 3
TYPE_XML_FRAGMENT = 4
TYPE_XML_HOOK = 5
TYPE_XML_TEXT = 6
TYPE_WEAK = 7
TYPE_DOC = 9
TYPE_UNDEFINED = 15


class LinkSource:
    """Quoted range backing a WeakRef (reference: types/weak.rs:487)."""

    __slots__ = ("quote_start", "quote_end", "first_item")

    def __init__(self, quote_start: StickyIndex, quote_end: StickyIndex):
        self.quote_start = quote_start
        self.quote_end = quote_end
        self.first_item = None

    def is_single(self) -> bool:
        return self.quote_start.id == self.quote_end.id


class Branch:
    __slots__ = (
        "item",
        "name",
        "type_ref",
        "type_name",
        "link_source",
        "start",
        "map",
        "block_len",
        "content_len",
        "observers",
        "deep_observers",
        "store",
    )

    def __init__(
        self,
        type_ref: int,
        type_name: Optional[str] = None,
        link_source: Optional[LinkSource] = None,
    ):
        self.item: Optional["Item"] = None  # integration anchor (None for roots)
        self.name: Optional[str] = None  # root-type name
        self.type_ref = type_ref
        self.type_name = type_name  # XmlElement tag / XmlHook key
        self.link_source = link_source
        self.start: Optional["Item"] = None
        self.map: Dict[str, "Item"] = {}
        self.block_len = 0  # total clock length of alive sequence items
        self.content_len = 0  # user-visible length
        self.observers: List = []
        self.deep_observers: List = []
        self.store = None  # back-ref set when registered

    def is_deleted(self) -> bool:
        return self.item is not None and self.item.deleted

    # --- wire ---

    def encode_type_ref(self, enc) -> None:
        """Parity: types/mod.rs:118-158."""
        enc.write_type_ref(self.type_ref)
        if self.type_ref in (TYPE_XML_ELEMENT, TYPE_XML_HOOK):
            enc.write_key(self.type_name or "")
        elif self.type_ref == TYPE_WEAK:
            src = self.link_source
            info = 0 if src.is_single() else 1
            if src.quote_start.assoc == ASSOC_AFTER:
                info |= 2
            if src.quote_end.assoc == ASSOC_AFTER:
                info |= 4
            enc.write_u8(info)
            enc.write_var(src.quote_start.id.client)
            enc.write_var(src.quote_start.id.clock)
            if not src.is_single():
                enc.write_var(src.quote_end.id.client)
                enc.write_var(src.quote_end.id.clock)

    @classmethod
    def decode_type_ref(cls, dec) -> "Branch":
        tag = dec.read_type_ref()
        if tag in (TYPE_XML_ELEMENT, TYPE_XML_HOOK):
            return cls(tag, type_name=dec.read_key())
        if tag == TYPE_WEAK:
            flags = dec.read_u8()
            single = flags & 1 == 0
            start_assoc = ASSOC_AFTER if flags & 2 else ASSOC_BEFORE
            end_assoc = ASSOC_AFTER if flags & 4 else ASSOC_BEFORE
            start_id = ID(dec.read_var(), dec.read_var())
            end_id = start_id if single else ID(dec.read_var(), dec.read_var())
            src = LinkSource(
                StickyIndex.from_id(start_id, start_assoc),
                StickyIndex.from_id(end_id, end_assoc),
            )
            return cls(tag, link_source=src)
        return cls(tag)

    # --- traversal helpers used by the shared types ---

    def first(self) -> Optional["Item"]:
        item = self.start
        while item is not None and item.deleted:
            item = item.right
        return item

    def __repr__(self) -> str:
        tag = self.name or (f"@{self.item.id}" if self.item else "?")
        return f"Branch[{self.type_ref}]({tag})"
