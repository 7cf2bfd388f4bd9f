"""BlockStore: per-client sorted block lists (copy of
`ytpu.core.block_store`; parity target: yrs block_store.rs,
`ClientBlockList` and the interpolation-seeded `find_pivot` :70-96,
`BlockStore` :300-475, `split_block` :456, clean start and end :402-417,
`squash_left` :243).

A client's blocks are stored sorted by clock and contiguous (no gaps), so
`find_pivot` can seed a binary search with the interpolated index
``clock * n_blocks / client_clock``.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Union

from .block import GCRange, Item
from .ids import ID, ClientID
from .state_vector import StateVector

__all__ = ["ClientBlockList", "BlockStore"]

Block = Union[Item, GCRange]


class ClientBlockList:
    __slots__ = ("blocks",)

    def __init__(self):
        self.blocks: List[Block] = []

    def __len__(self) -> int:
        return len(self.blocks)

    def __getitem__(self, i: int) -> Block:
        return self.blocks[i]

    def __iter__(self) -> Iterator[Block]:
        return iter(self.blocks)

    def clock(self) -> int:
        """Next expected clock = end of the last block."""
        if not self.blocks:
            return 0
        last = self.blocks[-1]
        return last.id.clock + last.len

    def find_pivot(self, clock: int) -> Optional[int]:
        """Index of the block whose clock range covers `clock`.

        Interpolation-seeded binary search (parity: block_store.rs:70-96).
        """
        blocks = self.blocks
        if not blocks:
            return None
        left = 0
        right = len(blocks) - 1
        last = blocks[right]
        total = last.id.clock + last.len
        if clock >= total:
            return None
        # interpolation seed — exact when blocks are uniform length-1 runs
        mid = min((clock * len(blocks)) // total, right)
        while left <= right:
            b = blocks[mid]
            start = b.id.clock
            if start <= clock:
                if clock < start + b.len:
                    return mid
                left = mid + 1
            else:
                right = mid - 1
            mid = (left + right) // 2
        return None

    def insert_at(self, index: int, block: Block) -> None:
        self.blocks.insert(index, block)

    def push(self, block: Block) -> None:
        self.blocks.append(block)

    def squash_left(self, index: int) -> bool:
        """Try to merge blocks[index] into blocks[index-1].

        Parity: block_store.rs:243 + the map fixup from the Yjs algorithm
        (if the squashed right block was a map entry, repoint the entry).
        """
        if index <= 0 or index >= len(self.blocks):
            return False
        left = self.blocks[index - 1]
        right = self.blocks[index]
        if not (left.is_item and right.is_item):
            return False
        if left.try_squash(right):
            from .branch import Branch

            if right.parent_sub is not None and isinstance(right.parent, Branch):
                if right.parent.map.get(right.parent_sub) is right:
                    right.parent.map[right.parent_sub] = left
            del self.blocks[index]
            return True
        return False


class BlockStore:
    __slots__ = ("clients",)

    def __init__(self):
        self.clients: Dict[ClientID, ClientBlockList] = {}

    def get_client(self, client: ClientID) -> Optional[ClientBlockList]:
        return self.clients.get(client)

    def get_client_or_create(self, client: ClientID) -> ClientBlockList:
        lst = self.clients.get(client)
        if lst is None:
            lst = ClientBlockList()
            self.clients[client] = lst
        return lst

    def get_clock(self, client: ClientID) -> int:
        lst = self.clients.get(client)
        return lst.clock() if lst else 0

    def get_state_vector(self) -> StateVector:
        return StateVector({c: lst.clock() for c, lst in self.clients.items() if len(lst)})

    def push_block(self, block: Block) -> None:
        self.get_client_or_create(block.id.client).push(block)

    def get_block(self, id_: ID) -> Optional[Block]:
        lst = self.clients.get(id_.client)
        if lst is None:
            return None
        idx = lst.find_pivot(id_.clock)
        if idx is None:
            return None
        return lst[idx]

    def get_item(self, id_: ID) -> Optional[Item]:
        b = self.get_block(id_)
        return b if isinstance(b, Item) else None

    def split_at(self, item: Item, offset: int) -> Item:
        """Physically split `item` at `offset`, registering the right half."""
        right = item.split(offset)
        lst = self.clients[item.id.client]
        idx = lst.find_pivot(item.id.clock)
        # right half sits immediately after the left half
        lst.insert_at(idx + 1, right)
        return right

    def get_item_clean_start(self, id_: ID) -> Optional[Item]:
        """Item starting exactly at `id_` (splitting a covering block if needed).

        Parity: block_store.rs:402-417 + store.rs:284-331 (materialize).
        """
        item = self.get_item(id_)
        if item is None:
            return None
        if item.id.clock == id_.clock:
            return item
        return self.split_at(item, id_.clock - item.id.clock)

    def get_item_clean_end(self, id_: ID) -> Optional[Item]:
        """Item ending exactly at `id_` (splitting a covering block if needed)."""
        item = self.get_item(id_)
        if item is None:
            return None
        if id_.clock == item.id.clock + item.len - 1:
            return item
        self.split_at(item, id_.clock - item.id.clock + 1)
        return item

    def __iter__(self) -> Iterator:
        return iter(self.clients.items())

    def __repr__(self) -> str:
        lines = []
        for client, lst in sorted(self.clients.items()):
            lines.append(f"  {client}: " + " ".join(repr(b) for b in lst))
        return "BlockStore{\n" + "\n".join(lines) + "\n}"
