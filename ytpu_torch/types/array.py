"""Array — an ordered sequence of values.

Copy of `ytpu.types.array`; parity target: yrs types/array.rs (`Array`
trait :171 — insert/push/remove :245-343, iteration :424, to_json).
Uses the same sequence kernel as Text; payloads are `Any` values, nested
shared types, binaries, or sub-documents.
"""

from __future__ import annotations

from typing import Any as PyAny, Iterator, List, Optional

from ytpu_torch.core.branch import TYPE_ARRAY
from ytpu_torch.core.content import ContentAny
from ytpu_torch.core.transaction import Transaction

from .shared import Prelim, SharedType, out_value, to_content, visible_items

__all__ = ["Array"]


class Array(SharedType):
    type_ref = TYPE_ARRAY
    __slots__ = ()

    def __len__(self) -> int:
        return self.branch.content_len

    # --- writes ----------------------------------------------------------------

    def insert(self, txn: Transaction, index: int, value: PyAny) -> None:
        self.insert_range(txn, index, [value])

    def _visible_position(self, txn: Transaction, index: int):
        """Insertion cursor at a *visible* index (move-aware; the raw
        neighbors are adjacent so moved-flag inheritance at integrate places
        the new item inside moved ranges correctly, block.rs:677-702)."""
        from ytpu_torch.core.transaction import ItemPosition

        if index == 0:
            return ItemPosition(self.branch, None, self.branch.start, 0, None)
        remaining = index
        last = None
        for item in visible_items(self.branch):
            if remaining == 0:
                break
            if item.deleted or not item.countable:
                continue
            if remaining < item.len:
                txn.store.blocks.split_at(item, remaining)
                last = item
                remaining = 0
                break
            remaining -= item.len
            last = item
        if remaining > 0:
            raise IndexError(index)
        return ItemPosition(
            self.branch, last, last.right if last is not None else self.branch.start
        )

    def insert_range(self, txn: Transaction, index: int, values: List[PyAny]) -> None:
        """Parity: types/array.rs:245 (consecutive primitives batch into one
        ContentAny block)."""
        pos = self._visible_position(txn, index)
        batch: List[PyAny] = []

        def flush_batch():
            if batch:
                item = txn.create_item(pos, ContentAny(list(batch)), None)
                pos.left = item
                batch.clear()

        for value in values:
            if isinstance(value, Prelim) or isinstance(value, (bytes, bytearray)) or (
                hasattr(value, "store") and hasattr(value, "guid")
            ):
                flush_batch()
                content, prelim = to_content(value)
                item = txn.create_item(pos, content, None)
                pos.left = item
                if prelim is not None:
                    prelim.fill(txn, item.content.branch)
            else:
                batch.append(value)
        flush_batch()

    def push_back(self, txn: Transaction, value: PyAny) -> None:
        self.insert(txn, len(self), value)

    def push_front(self, txn: Transaction, value: PyAny) -> None:
        self.insert(txn, 0, value)

    def remove(self, txn: Transaction, index: int) -> None:
        self.remove_range(txn, index, 1)

    def remove_range(self, txn: Transaction, index: int, length: int) -> None:
        """Move-aware removal over the visible order."""
        to_skip = index
        to_del = length
        store = txn.store
        for item in visible_items(self.branch):
            if to_del == 0:
                break
            if item.deleted or not item.countable:
                continue
            if to_skip > 0:
                if to_skip >= item.len:
                    to_skip -= item.len
                    continue
                store.blocks.split_at(item, to_skip)
                to_skip = 0
                continue  # next visible item is the split-off right half
            if to_del < item.len:
                store.blocks.split_at(item, to_del)
            to_del -= min(to_del, item.len)
            txn.delete(item)
        if to_del > 0:
            raise IndexError(f"remove_range past end of array ({to_del} left)")

    def move_to(self, txn: Transaction, source: int, target: int) -> None:
        """Move the element at `source` before the current element at `target`.

        Parity: types/array.rs move_to (a collapsed ContentMove marker).
        """
        if source == target or source + 1 == target:
            return  # moving into itself is a no-op
        self.move_range_to(txn, source, source, target)

    def move_range_to(self, txn: Transaction, start: int, end: int, target: int) -> None:
        """Move elements [start..=end] before the element at `target`.

        Parity: types/array.rs move_range_to (start anchored After, end
        anchored Before — see moving.rs:100-111 for coordinate semantics).
        """
        from ytpu_torch.core.content import ContentMove
        from ytpu_torch.core.moving import ASSOC_AFTER, ASSOC_BEFORE, Move, StickyIndex

        if start <= target <= end:
            return  # moving a range into itself is a no-op
        left = StickyIndex.from_type_index(self.branch, start, ASSOC_AFTER)
        right = StickyIndex.from_type_index(self.branch, end + 1, ASSOC_BEFORE)
        if left.id is None or right.id is None:
            raise IndexError(f"move range [{start}..{end}] out of bounds")
        pos = self._visible_position(txn, target)
        # priority -1: adapted to max(overridden priorities) + 1 on integrate
        txn.create_item(pos, ContentMove(Move(left, right, -1)), None)

    # --- reads -----------------------------------------------------------------

    def get(self, index: int) -> Optional[PyAny]:
        remaining = index
        for item in visible_items(self.branch):
            if not item.deleted and item.countable:
                if remaining < item.len:
                    return out_value(item, remaining)
                remaining -= item.len
        return None

    def __iter__(self) -> Iterator[PyAny]:
        for item in visible_items(self.branch):
            if not item.deleted and item.countable:
                for i in range(item.len):
                    yield out_value(item, i)

    def to_list(self) -> List[PyAny]:
        return list(self)

    def to_json(self) -> List[PyAny]:
        out = []
        for v in self:
            if isinstance(v, SharedType):
                out.append(v.to_json())
            else:
                out.append(v)
        return out
