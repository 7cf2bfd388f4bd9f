"""Block carriers of a decoded update: Item / GC / Skip (copy of
`ytpu.core.block`'s fields, `len` and `last_id`; parity target: yrs
block.rs, Item :1088-1133). Integration and splitting are the host CRDT's
and are not ported: the batch ingestor turns carriers into device rows.
"""

from __future__ import annotations

from typing import Optional, Union

from ytpu_torch.core.content import Content
from ytpu_torch.core.ids import ID

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

    def __repr__(self) -> str:
        return f"Item{self.id}+{self.len}"
