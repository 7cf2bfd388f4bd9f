"""Map — a key-value store with last-writer-wins conflict resolution.

Copy of `ytpu.types.map`; parity target: yrs types/map.rs (`Map` trait
:152 — insert/remove :285, clear :383, iterators :391-480). Conflict rule:
for concurrent writes to one key, the entry created by the higher
(client, clock) chain survives (lib.rs:427-430). A map write is an item
with `parent_sub`.
"""

from __future__ import annotations

from typing import Any as PyAny, Dict, Iterator, Optional, Tuple

from ytpu_torch.core.block import Item
from ytpu_torch.core.branch import TYPE_MAP
from ytpu_torch.core.transaction import ItemPosition, Transaction

from .shared import SharedType, out_value, to_content

__all__ = ["Map"]


class Map(SharedType):
    type_ref = TYPE_MAP
    __slots__ = ()

    def __len__(self) -> int:
        return sum(1 for _ in self.keys())

    # --- writes ----------------------------------------------------------------

    def insert(self, txn: Transaction, key: str, value: PyAny) -> None:
        """Parity: types/map.rs:285 (new item shadows the key's chain)."""
        left = self.branch.map.get(key)
        pos = ItemPosition(self.branch, left, None, 0, None)
        content, prelim = to_content(value)
        item = txn.create_item(pos, content, key)
        if prelim is not None:
            prelim.fill(txn, item.content.branch)

    def remove(self, txn: Transaction, key: str) -> bool:
        item = self._live(key)
        if item is None:
            return False
        txn.delete(item)
        return True

    def clear(self, txn: Transaction) -> None:
        for key in list(self.keys()):
            self.remove(txn, key)

    # --- reads -----------------------------------------------------------------

    def _live(self, key: str) -> Optional[Item]:
        item = self.branch.map.get(key)
        if item is not None and not item.deleted:
            return item
        return None

    def get(self, key: str, default: PyAny = None) -> PyAny:
        item = self._live(key)
        if item is None:
            return default
        return out_value(item)

    def contains_key(self, key: str) -> bool:
        return self._live(key) is not None

    def keys(self) -> Iterator[str]:
        for key, item in self.branch.map.items():
            if not item.deleted:
                yield key

    def items(self) -> Iterator[Tuple[str, PyAny]]:
        for key, item in self.branch.map.items():
            if not item.deleted:
                yield key, out_value(item)

    def values(self) -> Iterator[PyAny]:
        for _, v in self.items():
            yield v

    def to_json(self) -> Dict[str, PyAny]:
        out = {}
        for key, value in self.items():
            if isinstance(value, SharedType):
                out[key] = value.to_json()
            else:
                out[key] = value
        return out
