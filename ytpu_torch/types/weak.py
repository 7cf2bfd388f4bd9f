"""Weak links & quotations — references into other shared types.

Copy of `ytpu.types.weak`; parity target: yrs types/weak.rs (`WeakRef`
:78, `WeakPrelim` :327, `LinkSource` :487 with `materialize` :553,
`Quotable::quote` :702) plus the integration hooks at block.rs:642-674.

A weak link is a branch tagged `TypeRef::WeakLink(LinkSource)` whose quoted
range is a pair of sticky indices. Materialization marks the referenced
items `linked` and registers back-references in `store.linked_by` so edits
and deletions inside the range notify the link's observers.
"""

from __future__ import annotations

from typing import Any as PyAny, Iterator, List, Optional

from ytpu_torch.core.branch import Branch, LinkSource, TYPE_WEAK
from ytpu_torch.core.ids import ID
from ytpu_torch.core.moving import ASSOC_AFTER, ASSOC_BEFORE, StickyIndex
from ytpu_torch.core.transaction import Transaction

from .shared import Prelim, SharedType, out_value

__all__ = ["WeakRef", "WeakPrelim", "materialize_link", "quote_range", "map_link"]


def materialize_link(store, branch: Branch) -> None:
    """Resolve the quoted range and register back-refs.

    Parity: weak.rs:553-597.
    """
    src = branch.link_source
    if src is None or src.quote_start.id is None:
        return
    start = store.blocks.get_item(src.quote_start.id)
    if start is None:
        return  # referenced element already GCed
    if start.parent_sub is not None:
        # map entry: track the most recent item of the key chain
        last = start
        while last.right is not None:
            last = last.right
        src.first_item = last
        last.linked = True
        store.linked_by.setdefault(last, set()).add(branch)
        return
    # sequence range: mark every item between start and end ids. The walk
    # is MOVE-AWARE (parity: weak.rs:581 `.moved().within_range(..)`) — a
    # quoted range follows document order, so items moved into the range
    # are linked and items moved out are not.
    end_id = src.quote_end.id
    item = store.blocks.get_item_clean_start(src.quote_start.id)
    if item is None:
        return
    if end_id is not None:
        store.blocks.get_item_clean_end(end_id)  # align the boundary
    src.first_item = item
    for it in _range_items(store, item, src.quote_start.id, end_id):
        it.linked = True
        store.linked_by.setdefault(it, set()).add(branch)


def _range_items(store, start_item, start_id: ID, end_id: Optional[ID]):
    """Items of the quoted range in move-aware document order.

    Mirrors the reference's `Unquote` iterator (weak.rs:638-700:
    `Values<RangeIter<MoveIter>>`): the parent sequence is walked with
    move semantics (`visible_items`), the range opening at the item
    containing the start id and closing after the one containing the end
    id. Tombstoned items inside the range are yielded too — callers
    filter (`materialize` links them; `unquote` skips their values)."""
    from .shared import visible_items

    parent = start_item.parent
    if not isinstance(parent, Branch):
        return
    inside = False
    for it in visible_items(parent):
        if not inside and start_id is not None and it.contains(start_id):
            inside = True
        if inside:
            yield it
            if end_id is not None and it.contains(end_id):
                return
    # anchors vanished from the walk (e.g. the whole range was moved and
    # the bounds now invert): nothing further to yield


def unlink_all(store, branch: Branch) -> None:
    """Remove this link's back-references from every quoted item.

    Parity: weak.rs:509-517 (`LinkSource::unlink`) — deleting the weak
    link must stop target edits from notifying its (dead) observers."""
    src = branch.link_source
    if src is None:
        return
    stale = [
        item for item, links in store.linked_by.items() if branch in links
    ]
    for item in stale:
        links = store.linked_by[item]
        links.discard(branch)
        if not links:
            del store.linked_by[item]
            item.linked = False
    src.first_item = None


class WeakPrelim(Prelim):
    """A not-yet-integrated weak link (parity: weak.rs:327)."""

    type_ref = TYPE_WEAK

    def __init__(self, source: LinkSource):
        self.source = source

    def make_branch(self) -> Branch:
        return Branch(TYPE_WEAK, link_source=self.source)

    def fill(self, txn: Transaction, branch: Branch) -> None:
        materialize_link(txn.store, branch)


class WeakRef(SharedType):
    """An integrated weak link (parity: weak.rs:78)."""

    type_ref = TYPE_WEAK
    __slots__ = ()

    @property
    def source(self) -> LinkSource:
        return self.branch.link_source

    def unquote(self) -> List[PyAny]:
        """Visible values inside the quoted range (parity: weak.rs:303-372).

        The walk is move-aware (weak.rs:638: `RangeIter<MoveIter>`):
        elements moved INTO the quoted span appear, elements moved out
        don't — quotation follows document order, not insertion order."""
        store = self.branch.store
        src = self.source
        if store is None or src is None or src.quote_start.id is None:
            return []
        item = store.blocks.get_item(src.quote_start.id)
        if item is None:
            return []
        end_id = src.quote_end.id
        out: List[PyAny] = []
        for it in _range_items(store, item, src.quote_start.id, end_id):
            if not it.deleted and it.countable:
                for i in range(it.len):
                    out.append(out_value(it, i))
        return out

    def try_deref(self) -> Optional[PyAny]:
        """Single-value dereference (parity: weak.rs:374).

        Map links follow the key chain to the *current* live value.
        """
        store = self.branch.store
        src = self.source
        if store is None or src is None or src.quote_start.id is None:
            return None
        item = src.first_item or store.blocks.get_item(src.quote_start.id)
        if item is None:
            return None
        if item.parent_sub is not None:
            # advance to the newest item of the key chain
            while item.right is not None:
                item = item.right
            src.first_item = item
            if item.deleted:
                return None
            return out_value(item)
        if item.deleted:
            return None
        return out_value(item)

    def to_json(self) -> PyAny:
        values = self.unquote()
        return values


def quote_range(seq: SharedType, txn: Transaction, index: int, length: int) -> WeakPrelim:
    """Quote `length` elements starting at `index` (parity: Quotable::quote,
    weak.rs:702)."""
    if length < 1:
        raise ValueError("cannot quote an empty range")
    start = StickyIndex.from_type_index(seq.branch, index, ASSOC_AFTER)
    end = StickyIndex.from_type_index(seq.branch, index + length - 1, ASSOC_AFTER)
    if start.id is None or end.id is None:
        raise IndexError(f"quote range [{index}, {index + length}) out of bounds")
    return WeakPrelim(LinkSource(start, end))


def map_link(m: SharedType, key: str) -> Optional[WeakPrelim]:
    """Link to a map entry (parity: Map::link)."""
    item = m.branch.map.get(key)
    if item is None or item.deleted:
        return None
    sticky = StickyIndex.from_id(item.id, ASSOC_AFTER)
    return WeakPrelim(LinkSource(sticky, sticky))
