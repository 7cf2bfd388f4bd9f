"""Block carriers of a decoded update: Item / GC / Skip (copy of
`ytpu.core.block`'s fields, `len`, `last_id` and v1 `encode`; parity
target: yrs block.rs, Item :1088-1133, encode :868-908). Integration is
the host CRDT's and is not ported: the batch ingestor turns carriers into
device rows; the doc-less update merge splits detached carriers
(`Item.split_off`).
"""

from __future__ import annotations

from typing import Optional, Union

from ytpu_torch.core.content import BLOCK_GC, BLOCK_SKIP, Content
from ytpu_torch.core.ids import ID

HAS_ORIGIN = 0x80
HAS_RIGHT_ORIGIN = 0x40
HAS_PARENT_SUB = 0x20

__all__ = ["Item", "GCRange", "SkipRange"]


class GCRange:
    """A garbage-collected block range (yrs BlockCell::GC, block.rs:101)."""

    __slots__ = ("id", "len")
    is_item = False
    is_skip = False

    def __init__(self, id_: ID, length: int):
        self.id = id_
        self.len = length

    @property
    def last_id(self) -> ID:
        return ID(self.id.client, self.id.clock + self.len - 1)

    def encode(self, enc, offset: int = 0) -> None:
        enc.write_info(BLOCK_GC)
        enc.write_len(self.len - offset)

    def __repr__(self) -> str:
        return f"GC{self.id}+{self.len}"


class SkipRange:
    """A hole marker inside an update stream (never stored in a doc)."""

    __slots__ = ("id", "len")
    is_item = False
    is_skip = True

    def __init__(self, id_: ID, length: int):
        self.id = id_
        self.len = length

    def encode(self, enc, offset: int = 0) -> None:
        enc.write_info(BLOCK_SKIP)
        # skip lengths ride the main stream, not the len column (update.rs:437)
        enc.write_var(self.len - offset)

    def __repr__(self) -> str:
        return f"Skip{self.id}+{self.len}"


class Item:
    """An item carrier: its id, origins, parent (a root name, a nested
    type's id, or None when the wire omits it) and content."""

    __slots__ = ("id", "len", "origin", "right_origin", "parent", "parent_sub", "content")
    is_item = True
    is_skip = False

    def __init__(
        self,
        id_: ID,
        origin: Optional[ID],
        right_origin: Optional[ID],
        parent: Union[str, ID, None],
        parent_sub: Optional[str],
        content: Content,
    ):
        self.id = id_
        self.len = content.length()
        self.origin = origin
        self.right_origin = right_origin
        self.parent = parent
        self.parent_sub = parent_sub
        self.content = content

    @property
    def countable(self) -> bool:
        return self.content.countable

    @property
    def last_id(self) -> ID:
        return ID(self.id.client, self.id.clock + self.len - 1)

    def split_off(self, offset: int) -> "Item":
        """A new item for this item's clocks from `offset` on, its origin
        the unit before it (block_store.rs:456 splitItem); this item is
        left unchanged."""
        return Item(
            ID(self.id.client, self.id.clock + offset),
            ID(self.id.client, self.id.clock + offset - 1),
            self.right_origin,
            self.parent,
            self.parent_sub,
            self.content.copy().splice(offset),
        )

    def encode(self, enc, offset: int = 0) -> None:
        """Encode, optionally skipping the first `offset` clock units
        (block.rs:868-908; the partial-block slice encode of slice.rs:
        101-199, whose origin is the preceding unit of this block)."""
        origin = ID(self.id.client, self.id.clock + offset - 1) if offset > 0 else self.origin
        info = (
            self.content.kind
            | (HAS_ORIGIN if origin is not None else 0)
            | (HAS_RIGHT_ORIGIN if self.right_origin is not None else 0)
            | (HAS_PARENT_SUB if self.parent_sub is not None else 0)
        )
        enc.write_info(info)
        if origin is not None:
            enc.write_left_id(origin)
        if self.right_origin is not None:
            enc.write_right_id(self.right_origin)
        if origin is None and self.right_origin is None:
            parent = self.parent
            if isinstance(parent, ID):
                enc.write_parent_info(False)
                enc.write_left_id(parent)
            elif isinstance(parent, str):
                enc.write_parent_info(True)
                enc.write_string(parent)
            else:
                raise ValueError(f"cannot encode item {self.id}: unknown parent")
            if self.parent_sub is not None:
                enc.write_string(self.parent_sub)
        if offset > 0:
            self.content.copy().splice(offset).encode(enc)
        else:
            self.content.encode(enc)

    def __repr__(self) -> str:
        return f"Item{self.id}+{self.len}"
