"""Shared-type base machinery: branch projections, prelims, find_position.

Copy of `ytpu.types.shared`; parity targets: yrs branch.rs:335-503
(insert_at/remove_at/get_at), the `Prelim` system (block.rs:2091-2136), and
`Text::find_position` (types/text.rs:734), which walks the item chain as
the reference does.
"""

from __future__ import annotations

from typing import Any as PyAny, List, Optional, Tuple

from ytpu_torch.core.block import Item
from ytpu_torch.core.branch import (
    Branch,
    TYPE_ARRAY,
    TYPE_MAP,
    TYPE_TEXT,
    TYPE_XML_ELEMENT,
    TYPE_XML_FRAGMENT,
    TYPE_XML_HOOK,
    TYPE_XML_TEXT,
)
from ytpu_torch.core.content import (
    Content,
    ContentAny,
    ContentBinary,
    ContentDoc,
    ContentEmbed,
    ContentFormat,
    ContentString,
    ContentType,
)
from ytpu_torch.core.transaction import ItemPosition, Transaction

__all__ = [
    "SharedType",
    "Prelim",
    "TextPrelim",
    "ArrayPrelim",
    "MapPrelim",
    "XmlTextPrelim",
    "XmlElementPrelim",
    "XmlFragmentPrelim",
    "find_position",
    "out_value",
    "to_content",
]


class SharedType:
    """Base for Text/Array/Map/Xml — a view over a `Branch`."""

    type_ref: int = -1
    __slots__ = ("branch",)

    def __init__(self, branch: Branch):
        self.branch = branch

    # --- sticky indices (parity: moving.rs IndexedSequence :809) ---------------

    def sticky_index(self, index: int, assoc: int = 0):
        """A position that follows its neighborhood across concurrent edits."""
        from ytpu_torch.core.moving import StickyIndex

        return StickyIndex.from_type_index(self.branch, index, assoc)

    def sticky_index_offset(self, txn, sticky) -> Optional[int]:
        """Resolve a sticky index to the current absolute offset (or None)."""
        resolved = sticky.get_offset(txn.store)
        if resolved is None:
            return None
        branch, index = resolved
        if branch is not self.branch:
            return None
        return index

    def observe(self, cb) -> callable:
        self.branch.observers.append(cb)
        return lambda: self.branch.observers.remove(cb)

    def observe_deep(self, cb) -> callable:
        self.branch.deep_observers.append(cb)
        return lambda: self.branch.deep_observers.remove(cb)

    def is_deleted(self) -> bool:
        return self.branch.is_deleted()

    def __eq__(self, other: object) -> bool:
        if isinstance(other, SharedType):
            return self.branch is other.branch
        return NotImplemented

    def __hash__(self) -> int:
        return id(self.branch)


class Prelim:
    """A value that materializes into a nested shared type on insertion."""

    type_ref: int = -1

    def make_branch(self) -> Branch:
        return Branch(self.type_ref)

    def fill(self, txn: Transaction, branch: Branch) -> None:
        """Populate the freshly integrated branch with initial content."""


class TextPrelim(Prelim):
    type_ref = TYPE_TEXT

    def __init__(self, text: str = ""):
        self.text = text

    def fill(self, txn: Transaction, branch: Branch) -> None:
        if self.text:
            from .text import Text

            Text(branch).insert(txn, 0, self.text)


class ArrayPrelim(Prelim):
    type_ref = TYPE_ARRAY

    def __init__(self, items: Optional[List[PyAny]] = None):
        self.items = list(items) if items else []

    def fill(self, txn: Transaction, branch: Branch) -> None:
        if self.items:
            from .array import Array

            Array(branch).insert_range(txn, 0, self.items)


class MapPrelim(Prelim):
    type_ref = TYPE_MAP

    def __init__(self, entries: Optional[dict] = None):
        self.entries = dict(entries) if entries else {}

    def fill(self, txn: Transaction, branch: Branch) -> None:
        if self.entries:
            from .map import Map

            m = Map(branch)
            for key, value in self.entries.items():
                m.insert(txn, key, value)


class XmlTextPrelim(TextPrelim):
    type_ref = TYPE_XML_TEXT


class XmlFragmentPrelim(Prelim):
    """Nested XML fragment (parity: yrs XmlFragmentPrelim, types/xml.rs:384;
    ywasm YXmlFragment::new(children))."""

    type_ref = TYPE_XML_FRAGMENT

    def __init__(self, children=()):
        self.children = list(children)

    def fill(self, txn: Transaction, branch: Branch) -> None:
        if self.children:
            from .xml import XmlFragment

            XmlFragment(branch).insert_range(txn, 0, self.children)


class XmlHookPrelim(Prelim):
    """Opaque hook node keyed by name (parity: xml.rs XmlHook; ywasm
    YXmlHook) — attributes behave like a map on the hook branch."""

    type_ref = TYPE_XML_HOOK

    def __init__(self, name: str, attributes: Optional[dict] = None):
        self.name = name
        self.attributes = dict(attributes) if attributes else {}

    def make_branch(self) -> Branch:
        return Branch(self.type_ref, type_name=self.name)

    def fill(self, txn: Transaction, branch: Branch) -> None:
        from .xml import XmlHook

        hook = XmlHook(branch)
        for key, value in self.attributes.items():
            hook.insert_attribute(txn, key, value)


class XmlElementPrelim(Prelim):
    type_ref = TYPE_XML_ELEMENT

    def __init__(self, tag: str, attributes: Optional[dict] = None, children=()):
        self.tag = tag
        self.attributes = dict(attributes) if attributes else {}
        self.children = list(children)

    def make_branch(self) -> Branch:
        return Branch(self.type_ref, type_name=self.tag)

    def fill(self, txn: Transaction, branch: Branch) -> None:
        from .xml import XmlElement

        el = XmlElement(branch)
        for key, value in self.attributes.items():
            el.insert_attribute(txn, key, value)
        if self.children:
            el.insert_range(txn, 0, self.children)


def to_content(value: PyAny) -> Tuple[Content, Optional[Prelim]]:
    """Convert a user value into item content (parity: Prelim::into_content)."""
    if isinstance(value, Prelim):
        branch = value.make_branch()
        return ContentType(branch), value
    if isinstance(value, SharedType):
        raise TypeError("cannot re-insert an already integrated shared type")
    if isinstance(value, (bytes, bytearray, memoryview)):
        return ContentBinary(bytes(value)), None
    from ytpu_torch.core.doc import Doc

    if isinstance(value, Doc):
        return ContentDoc(value), None
    return ContentAny([value]), None


def out_value(item: Item, index: int = -1) -> PyAny:
    """User-facing value of one element of an item (parity: block.rs:1650-1706)."""
    content = item.content
    if isinstance(content, ContentType):
        from . import wrap_branch

        return wrap_branch(content.branch)
    if isinstance(content, ContentDoc):
        return content.doc
    vals = content.values()
    if not vals:
        return None
    return vals[index]


def visible_items(branch: Branch):
    """Iterate sequence items in *visible* order, honoring move ranges.

    Parity: the move-aware traversal of iter.rs:46-116 (MoveIter): an item
    whose `moved` pointer differs from the current move scope is skipped
    (it renders at its destination); an alive ContentMove item descends
    into its range.
    """
    from ytpu_torch.core.content import ContentMove

    store = branch.store
    stack = []  # (resume_item, outer_scope_move, outer_scope_end)
    cur = branch.start
    scope_move = None
    scope_end = None
    while True:
        if cur is None or (scope_end is not None and cur is scope_end):
            if stack:
                cur, scope_move, scope_end = stack.pop()
                continue
            break
        if (
            isinstance(cur.content, ContentMove)
            and not cur.deleted
            and cur.moved is scope_move
            and store is not None
        ):
            start, end = cur.content.move.get_coords(store)
            stack.append((cur.right, scope_move, scope_end))
            scope_move, scope_end = cur, end
            cur = start
            continue
        if cur.moved is scope_move and not isinstance(cur.content, ContentMove):
            yield cur
        cur = cur.right


def find_position(
    branch: Branch,
    txn: Transaction,
    index: int,
    track_attrs: bool = False,
) -> Optional[ItemPosition]:
    """Walk the sequence to the `index`-th visible element, splitting blocks
    as needed. Parity: types/text.rs:734 (linear scan; device path uses a
    prefix-sum lookup instead)."""
    left: Optional[Item] = None
    right: Optional[Item] = branch.start
    attrs = {} if track_attrs else None
    remaining = index
    store = txn.store
    while right is not None and remaining > 0:
        if not right.deleted:
            if right.countable:
                if remaining < right.len:
                    store.blocks.split_at(right, remaining)
                remaining -= right.len
            elif attrs is not None and isinstance(right.content, ContentFormat):
                if right.content.value is None:
                    attrs.pop(right.content.key, None)
                else:
                    attrs[right.content.key] = right.content.value
        left = right
        right = right.right
    if remaining > 0:
        return None  # index out of bounds
    return ItemPosition(branch, left, right, index, attrs)
