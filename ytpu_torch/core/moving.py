"""Move ranges and sticky indices, the wire half (copy of
`ytpu.core.moving`'s `StickyIndex` data model and `Move.decode` /
`Move.encode`; parity target: yrs moving.rs, Move :16, StickyIndex :403,
Assoc :723). Resolving a sticky index against a doc is the host CRDT's
work and is not ported: the device resolves move bounds by id.
"""

from __future__ import annotations

from typing import Optional

from ytpu_torch.core.ids import ID

__all__ = ["ASSOC_BEFORE", "ASSOC_AFTER", "StickyIndex", "Move"]

ASSOC_BEFORE = -1
ASSOC_AFTER = 0


class StickyIndex:
    """A position that sticks to its neighbourhood across concurrent edits:
    an item id, or a root-type name / branch id (start or end of a
    sequence)."""

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

    __slots__ = ("start", "end", "priority")

    def __init__(self, start: StickyIndex, end: StickyIndex, priority: int):
        self.start = start
        self.end = end
        self.priority = priority

    def is_collapsed(self) -> bool:
        return self.start.id == self.end.id

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

    def __repr__(self) -> str:
        return f"Move({self.start}..{self.end}, prio={self.priority})"
