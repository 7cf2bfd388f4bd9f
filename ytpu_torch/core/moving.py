"""Move ranges and sticky indices (copy of `ytpu.core.moving`; parity
target: yrs moving.rs, Move :16, StickyIndex :403, Assoc :723): the wire
format, the data model, a move's integration and deletion, and sticky
indices resolved against a doc's `ytpu_torch.core.store.DocStore`.
"""

from __future__ import annotations

from typing import Optional

from ytpu_torch.encoding.lib0 import Cursor, Writer

from .ids import ID

__all__ = ["ASSOC_BEFORE", "ASSOC_AFTER", "StickyIndex", "Move"]

ASSOC_BEFORE = -1
ASSOC_AFTER = 0


class StickyIndex:
    """A position that sticks to its neighborhood across concurrent edits.

    Scope is either an item ID (relative), or a root-type name / branch id
    (start or end of a sequence).
    """

    __slots__ = ("id", "name", "branch_id", "assoc")

    def __init__(
        self,
        id_: Optional[ID] = None,
        name: Optional[str] = None,
        branch_id: Optional[ID] = None,
        assoc: int = ASSOC_AFTER,
    ):
        self.id = id_
        self.name = name
        self.branch_id = branch_id
        self.assoc = assoc

    @classmethod
    def from_id(cls, id_: ID, assoc: int) -> "StickyIndex":
        return cls(id_=id_, assoc=assoc)

    @classmethod
    def from_type_index(cls, branch, index: int, assoc: int = ASSOC_AFTER) -> "StickyIndex":
        """Sticky position at `index` of a sequence (parity: moving.rs:809 /
        IndexedSequence::sticky_index)."""
        if assoc == ASSOC_BEFORE:
            if index == 0:
                return cls._from_branch(branch, assoc)
            index -= 1
        # the walk is MOVE-AWARE: `index` is a VISIBLE position, and after
        # a move the raw link order no longer matches document order
        # (parity: moving.rs:809 via the move-aware block iterator — a
        # raw walk would anchor a second move on the wrong element)
        from ytpu_torch.types.shared import visible_items

        for item in visible_items(branch):
            if not item.deleted and item.countable:
                if item.len > index:
                    return cls(
                        id_=ID(item.id.client, item.id.clock + index), assoc=assoc
                    )
                index -= item.len
        return cls._from_branch(branch, assoc)

    @classmethod
    def _from_branch(cls, branch, assoc: int) -> "StickyIndex":
        if branch.item is not None:
            return cls(branch_id=branch.item.id, assoc=assoc)
        return cls(name=branch.name, assoc=assoc)

    def get_offset(self, store) -> Optional[tuple]:
        """Resolve back to (branch, index) against the current doc state
        (parity: moving.rs:483 / Yjs createAbsolutePositionFromRelativePosition).
        """
        from ytpu_torch.core.content import ContentType

        if self.id is not None:
            if store.blocks.get_clock(self.id.client) <= self.id.clock:
                return None
            right = store.follow_redone(self.id)
            if right is None:
                return None
            diff = self.id.clock - right.id.clock if right.contains(self.id) else 0
            branch = right.parent
            from ytpu_torch.core.branch import Branch

            if not isinstance(branch, Branch):
                return None
            index = 0
            if branch.item is None or not branch.item.deleted:
                if not right.deleted and right.countable:
                    index = diff + (0 if self.assoc >= 0 else 1)
                node = right.left
                while node is not None:
                    if not node.deleted and node.countable:
                        index += node.len
                    node = node.left
            return branch, index
        if self.name is not None:
            branch = store.types.get(self.name)
        elif self.branch_id is not None:
            anchor = store.blocks.get_item(self.branch_id)
            branch = (
                anchor.content.branch
                if anchor is not None and isinstance(anchor.content, ContentType)
                else None
            )
        else:
            return None
        if branch is None:
            return None
        return branch, (branch.content_len if self.assoc >= 0 else 0)

    def encode_v1(self) -> bytes:
        """Wire form: IndexScope tag + payload, then assoc as a signed varint
        (parity: moving.rs:610-614, IndexScope :672-691, Assoc :786-793)."""
        w = Writer()
        if self.id is not None:
            w.write_var_uint(0)
            w.write_var_uint(self.id.client)
            w.write_var_uint(self.id.clock)
        elif self.branch_id is not None:
            w.write_var_uint(2)
            w.write_var_uint(self.branch_id.client)
            w.write_var_uint(self.branch_id.clock)
        else:
            w.write_var_uint(1)
            w.write_string(self.name or "")
        w.write_var_int(self.assoc)
        return w.to_bytes()

    @classmethod
    def decode_v1(cls, data: bytes) -> "StickyIndex":
        """Parity: moving.rs:617-623, :693-710, :795-801 (assoc optional for
        pre-assoc payloads, defaulting to After)."""
        cur = Cursor(data)
        tag = cur.read_var_uint()
        id_ = name = branch_id = None
        if tag == 0:
            id_ = ID(cur.read_var_uint(), cur.read_var_uint())
        elif tag == 1:
            name = cur.read_string()
        elif tag == 2:
            branch_id = ID(cur.read_var_uint(), cur.read_var_uint())
        else:
            raise ValueError(f"unknown sticky-index scope tag {tag}")
        assoc = ASSOC_AFTER
        if cur.has_content():
            assoc = ASSOC_BEFORE if cur.read_var_int() < 0 else ASSOC_AFTER
        return cls(id_=id_, name=name, branch_id=branch_id, assoc=assoc)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, StickyIndex):
            return NotImplemented
        return (
            self.id == other.id
            and self.name == other.name
            and self.branch_id == other.branch_id
            and self.assoc == other.assoc
        )

    def __repr__(self) -> str:
        where = self.id or self.name or self.branch_id
        arrow = "<" if self.assoc == ASSOC_BEFORE else ">"
        return f"Sticky({where}{arrow})"


class Move:
    """A moved range ``[start, end]`` with a conflict-resolution priority."""

    __slots__ = ("start", "end", "priority", "overrides", "origin")

    def __init__(self, start: StickyIndex, end: StickyIndex, priority: int):
        self.start = start
        self.end = end
        self.priority = priority
        # runtime state (set during integration):
        self.overrides = None  # set[Item] of moves this one shadows
        self.origin = None  # previous `moved` markers

    def is_collapsed(self) -> bool:
        return self.start.id == self.end.id

    def copy(self) -> "Move":
        return Move(self.start, self.end, self.priority)

    def encode(self, enc) -> None:
        collapsed = self.is_collapsed()
        flags = 0
        if collapsed:
            flags |= 0b001
        if self.start.assoc == ASSOC_AFTER:
            flags |= 0b010
        if self.end.assoc == ASSOC_AFTER:
            flags |= 0b100
        flags |= self.priority << 6
        enc.write_var(flags)
        enc.write_var(self.start.id.client)
        enc.write_var(self.start.id.clock)
        if not collapsed:
            enc.write_var(self.end.id.client)
            enc.write_var(self.end.id.clock)

    @classmethod
    def decode(cls, dec) -> "Move":
        flags = dec.read_var()
        collapsed = flags & 0b001 != 0
        start_assoc = ASSOC_AFTER if flags & 0b010 else ASSOC_BEFORE
        end_assoc = ASSOC_AFTER if flags & 0b100 else ASSOC_BEFORE
        priority = flags >> 6
        start_id = ID(dec.read_var(), dec.read_var())
        end_id = start_id if collapsed else ID(dec.read_var(), dec.read_var())
        return cls(
            StickyIndex.from_id(start_id, start_assoc),
            StickyIndex.from_id(end_id, end_assoc),
            priority,
        )

    # --- integration (parity: moving.rs:100-265) -------------------------------

    @staticmethod
    def _item_ptr(store, sticky: StickyIndex):
        """Range coordinate resolution (parity: moving.rs:100-111):
        assoc After → the item starting at id (in-range); assoc Before →
        the item *after* the one ending at id (exclusive bound)."""
        if sticky.id is None:
            return None
        if sticky.assoc == ASSOC_AFTER:
            return store.blocks.get_item_clean_start(sticky.id)
        item = store.blocks.get_item_clean_end(sticky.id)
        return item.right if item is not None else None

    def get_coords(self, store):
        return self._item_ptr(store, self.start), self._item_ptr(store, self.end)

    def push_override(self, item) -> None:
        if self.overrides is None:
            self.overrides = set()
        self.overrides.add(item)

    def find_move_loop(self, store, moved_item, tracked) -> bool:
        """Cycle detection across nested moves (parity: moving.rs:113-141)."""
        if moved_item in tracked:
            return True
        tracked.add(moved_item)
        from ytpu_torch.core.content import ContentMove

        start, end = self.get_coords(store)
        cur = start
        while cur is not None and cur is not end:
            if not cur.deleted and cur.moved is moved_item:
                if isinstance(cur.content, ContentMove):
                    if cur.content.move.find_move_loop(store, cur, tracked):
                        return True
            cur = cur.right
        return False

    def integrate_block(self, txn, item) -> None:
        """Claim the moved range, reconciling concurrent moves by priority
        (parity: moving.rs:149-227). `item` is the ContentMove item."""
        from ytpu_torch.core.content import ContentMove

        store = txn.store
        start, end = self.get_coords(store)
        max_priority = 0
        adapt = self.priority < 0
        cur = start
        while cur is not None and cur is not end:
            prev_move = cur.moved
            if prev_move is not None and isinstance(prev_move.content, ContentMove):
                next_prio = prev_move.content.move.priority
            else:
                next_prio = -1
            takes = (
                adapt
                or next_prio < self.priority
                or (
                    prev_move is not None
                    and next_prio == self.priority
                    and (prev_move.id.client, prev_move.id.clock)
                    < (item.id.client, item.id.clock)
                )
            )
            if takes:
                if prev_move is not None:
                    if (
                        isinstance(prev_move.content, ContentMove)
                        and prev_move.content.move.is_collapsed()
                    ):
                        self._delete_as_cleanup(txn, prev_move, adapt)
                    self.push_override(prev_move)
                    if cur is not start:
                        txn.merge_blocks.append(cur.id)
                    max_priority = max(max_priority, next_prio)
                    # remember who moved this item before (for event diffing),
                    # unless the previous move was created in this very txn
                    if cur not in txn.prev_moved and not txn.has_added(prev_move.id):
                        txn.prev_moved[cur] = prev_move
                cur.moved = item
                if not cur.deleted and isinstance(cur.content, ContentMove):
                    if cur.content.move.find_move_loop(store, cur, {item}):
                        if adapt:
                            # the tombstoned move still re-encodes: its
                            # priority must leave the adapt sentinel (-1)
                            # before the early return, or a later
                            # encode_state_as_update writes a negative
                            # varint and throws
                            self.priority = max_priority + 1
                        self._delete_as_cleanup(txn, item, adapt)
                        return
            else:
                if prev_move is not None and isinstance(prev_move.content, ContentMove):
                    prev_move.content.move.push_override(item)
            cur = cur.right
        if adapt:
            self.priority = max_priority + 1

    def delete(self, txn, item) -> None:
        """Release the moved range and reintegrate overridden moves
        (parity: moving.rs:229-280)."""
        from ytpu_torch.core.content import ContentMove

        store = txn.store
        start, end = self.get_coords(store)
        cur = start
        while cur is not None and cur is not end:
            if cur.moved is item:
                if cur in txn.prev_moved:
                    if txn.has_added(item.id) and txn.prev_moved[cur] is item:
                        del txn.prev_moved[cur]
                else:
                    txn.prev_moved[cur] = item
                cur.moved = None
            cur = cur.right

        def reintegrate(it):
            if isinstance(it.content, ContentMove):
                if it.deleted:
                    inner_overrides = it.content.move.overrides
                    if inner_overrides:
                        for inner in list(inner_overrides):
                            reintegrate(inner)
                else:
                    it.content.move.integrate_block(txn, it)

        if self.overrides:
            for inner in list(self.overrides):
                reintegrate(inner)

    @staticmethod
    def _delete_as_cleanup(txn, item, adapt_priority: bool) -> None:
        txn.delete(item)
        if adapt_priority:
            # losing move markers created concurrently clean up silently
            txn.merge_blocks.append(item.id)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Move):
            return NotImplemented
        return (
            self.start == other.start
            and self.end == other.end
            and self.priority == other.priority
        )

    def __repr__(self) -> str:
        return f"Move({self.start}..{self.end}, prio={self.priority})"
