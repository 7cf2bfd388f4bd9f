"""A decoded-but-not-integrated update (copy of `ytpu.core.update.Update`'s
v1 decode, `is_empty` and `state_vector`; parity target: yrs update.rs,
`Update` :91, block decode :433-488).

An update carries, per client, a clock-contiguous run of block carriers
(Item / GC / Skip) plus a delete set. The batch ingestor's host lane
decodes with it; integration is the device's.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Dict, Optional, Union

from ytpu_torch.core.block import GCRange, Item, SkipRange
from ytpu_torch.core.content import BLOCK_GC, BLOCK_SKIP, decode_content
from ytpu_torch.core.id_set import DeleteSet
from ytpu_torch.core.ids import ID
from ytpu_torch.core.state_vector import StateVector
from ytpu_torch.encoding.codec import DecoderV1

__all__ = ["Update"]

Carrier = Union[Item, GCRange, SkipRange]

HAS_ORIGIN = 0x80
HAS_RIGHT_ORIGIN = 0x40
HAS_PARENT_SUB = 0x20


class Update:
    __slots__ = ("blocks", "delete_set")

    def __init__(
        self,
        blocks: Optional[Dict[int, Deque[Carrier]]] = None,
        delete_set: Optional[DeleteSet] = None,
    ):
        self.blocks: Dict[int, Deque[Carrier]] = blocks if blocks is not None else {}
        self.delete_set = delete_set if delete_set is not None else DeleteSet()

    def is_empty(self) -> bool:
        return not self.blocks and self.delete_set.is_empty()

    def state_vector(self) -> StateVector:
        """Highest contiguous clock per client described by this update."""
        sv = StateVector()
        for client, blocks in self.blocks.items():
            if blocks:
                last = blocks[-1]
                sv.set_max(client, last.id.clock + last.len)
        return sv

    @classmethod
    def decode(cls, dec) -> "Update":
        blocks: Dict[int, Deque[Carrier]] = {}
        for _ in range(dec.read_var()):
            n_blocks = dec.read_var()
            client = dec.read_client()
            clock = dec.read_var()
            dq = blocks.setdefault(client, deque())
            for _ in range(n_blocks):
                carrier = _decode_block(ID(client, clock), dec)
                if carrier is not None:
                    clock += carrier.len
                    dq.append(carrier)
        return cls(blocks, DeleteSet.decode(dec))

    @classmethod
    def decode_v1(cls, data: bytes) -> "Update":
        return cls.decode(DecoderV1(data))

    @classmethod
    def decode_v2(cls, data: bytes) -> "Update":
        raise NotImplementedError("V2 decode is not ported yet (ROADMAP A.11)")


def _decode_block(id_: ID, dec) -> Optional[Carrier]:
    """update.rs:433-488: zero-length items are dropped (they have no
    effect, update.rs:737-742)."""
    info = dec.read_info()
    if info == BLOCK_SKIP:
        return SkipRange(id_, dec.read_var())
    if info == BLOCK_GC:
        return GCRange(id_, dec.read_len())
    cant_copy_parent = info & (HAS_ORIGIN | HAS_RIGHT_ORIGIN) == 0
    origin = ID(*dec.read_left_id()) if info & HAS_ORIGIN else None
    right_origin = ID(*dec.read_right_id()) if info & HAS_RIGHT_ORIGIN else None
    parent = None
    parent_sub = None
    if cant_copy_parent:
        parent = dec.read_string() if dec.read_parent_info() else ID(*dec.read_left_id())
        if info & HAS_PARENT_SUB:
            parent_sub = dec.read_string()
    content = decode_content(dec, info)
    if content.length() == 0:
        return None
    return Item(id_, origin, right_origin, parent, parent_sub, content)
