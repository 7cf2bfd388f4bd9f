"""The block layer: Item / GC / Skip (copy of `ytpu.core.block`; parity
target: yrs block.rs, `Item` :1088-1133, flags :967-1071, encode :868-908,
`BlockRange` :1137, split semantics (`splice`) :435-478, squash :775-799).
YATA `integrate` (block.rs:482-769) and `repair` (:1287-1343) live in
`ytpu_torch.core.store` next to the block store.

Host form: Python objects with direct left/right references. The device
state holds the same schema as columns (`ytpu_torch.models.batch_doc`).
"""

from __future__ import annotations

from typing import Optional, Union

from .branch import Branch
from .content import (
    BLOCK_GC,
    BLOCK_SKIP,
    Content,
    ContentDeleted,
    ContentString,
    ContentType,
    utf16_len,
)
from .ids import ID

__all__ = ["Item", "GCRange", "SkipRange", "Parent", "UNKNOWN_PARENT"]

HAS_ORIGIN = 0x80
HAS_RIGHT_ORIGIN = 0x40
HAS_PARENT_SUB = 0x20

# Item.parent is one of: Branch (resolved), str (unresolved root name),
# ID (unresolved nested-type anchor), or None (unknown).
Parent = Union[Branch, str, ID, None]
UNKNOWN_PARENT = None


class GCRange:
    """A garbage-collected block range (reference: BlockCell::GC, block.rs:101)."""

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
    __slots__ = (
        "id",
        "len",
        "left",
        "right",
        "origin",
        "right_origin",
        "parent",
        "parent_sub",
        "content",
        "deleted",
        "keep",
        "moved",
        "redone",
        "linked",
    )
    is_item = True
    is_skip = False

    def __init__(
        self,
        id_: ID,
        left: Optional["Item"],
        origin: Optional[ID],
        right: Optional["Item"],
        right_origin: Optional[ID],
        parent: Parent,
        parent_sub: Optional[str],
        content: Content,
    ):
        self.id = id_
        self.len = content.length()
        self.left = left
        self.right = right
        self.origin = origin
        self.right_origin = right_origin
        self.parent = parent
        self.parent_sub = parent_sub
        self.content = content
        self.deleted = False
        self.keep = False
        self.moved: Optional["Item"] = None
        self.redone: Optional[ID] = None
        self.linked = False
        if isinstance(content, ContentType):
            content.branch.item = self
            if content.branch.name is None and isinstance(parent, str):
                content.branch.name = parent

    @property
    def countable(self) -> bool:
        return self.content.countable

    @property
    def last_id(self) -> ID:
        return ID(self.id.client, self.id.clock + self.len - 1)

    def contains(self, id_: ID) -> bool:
        return (
            self.id.client == id_.client
            and self.id.clock <= id_.clock < self.id.clock + self.len
        )

    def mark_deleted(self) -> None:
        self.deleted = True

    def visible_len(self) -> int:
        return 0 if self.deleted or not self.countable else self.len

    # --- wire (v1) ---

    def encode(self, enc, offset: int = 0) -> None:
        """Encode, optionally skipping the first `offset` clock units.

        Parity: block.rs:868-908 (plain) and the partial-block slice encode
        at slice.rs:101-199; with offset > 0 the origin is rewritten to point
        at the preceding unit of this same block.
        """
        origin = (
            ID(self.id.client, self.id.clock + offset - 1) if offset > 0 else self.origin
        )
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
            if isinstance(parent, Branch):
                if parent.item is not None:
                    enc.write_parent_info(False)
                    enc.write_left_id(parent.item.id)
                else:
                    enc.write_parent_info(True)
                    enc.write_string(parent.name or "")
            elif isinstance(parent, ID):
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
            head = self.content.copy()
            tail = head.splice(offset)  # splice keeps the head, returns the tail
            tail.encode(enc)
        else:
            self.content.encode(enc)

    # --- splitting & squashing ---

    def split(self, offset: int) -> "Item":
        """Split at `offset` clock units; returns the new right item.

        Caller is responsible for inserting the new item into the client block
        list and (if needed) parent map. Parity: splitItem semantics
        (reference: block_store.rs:456, store.rs:284-331).
        """
        right_content = self.content.splice(offset)
        right = Item(
            ID(self.id.client, self.id.clock + offset),
            self,
            ID(self.id.client, self.id.clock + offset - 1),
            self.right,
            self.right_origin,
            self.parent,
            self.parent_sub,
            right_content,
        )
        right.len = self.len - offset
        if self.deleted:
            right.deleted = True
        if self.keep:
            right.keep = True
        if self.moved is not None:
            right.moved = self.moved
        if self.redone is not None:
            right.redone = ID(self.redone.client, self.redone.clock + offset)
        self.len = offset
        if self.right is not None:
            self.right.left = right
        self.right = right
        return right

    def try_squash(self, other: "Item") -> bool:
        """Merge `other` (immediate right neighbor block) into self if compatible.

        Parity: block.rs:775-799.
        """
        if (
            self.id.client == other.id.client
            and self.id.clock + self.len == other.id.clock
            and other.origin == self.last_id
            and self.right_origin == other.right_origin
            and self.right is other
            and self.deleted == other.deleted
            and self.redone is None
            and other.redone is None
            and self.moved is other.moved
            and not self.linked
            and not other.linked
            and type(self.content) is type(other.content)
            and self.content.merge(other.content)
        ):
            if other.keep:
                self.keep = True
            self.right = other.right
            if self.right is not None:
                self.right.left = self
            self.len += other.len
            return True
        return False

    def __repr__(self) -> str:
        flags = "D" if self.deleted else ""
        return f"Item{self.id}+{self.len}{flags}:{self.content!r}"
