"""A decoded-but-not-integrated update (copy of `ytpu.core.update.Update`'s
v1 and v2 decode and encode, `encode_diff`, `merge`, `is_empty` and
`state_vector`, and of its doc-less utilities `merge_updates_v1/v2`,
`encode_state_vector_from_update_v2` and `diff_updates_v1/v2`; parity
target: yrs update.rs, `Update` :91, block decode :433-488, `encode_diff`
:490-535, `merge_updates` :537-704, alt.rs:15-95).

An update carries, per client, a clock-contiguous run of block carriers
(Item / GC / Skip) plus a delete set. The batch ingestor's host lane
decodes with it; integration is the device's. The sync server merges a
slot's pending stash into a reply with `merge_updates_v1`.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional, Tuple, Union

from ytpu_torch.core.block import HAS_ORIGIN, HAS_PARENT_SUB, HAS_RIGHT_ORIGIN, GCRange, Item, SkipRange
from ytpu_torch.core.content import BLOCK_GC, BLOCK_SKIP, decode_content
from ytpu_torch.core.id_set import DeleteSet
from ytpu_torch.core.ids import ID
from ytpu_torch.core.state_vector import StateVector
from ytpu_torch.encoding.codec import DecoderV1, DecoderV2, EncoderV1, EncoderV2

__all__ = [
    "Update",
    "diff_updates_v1",
    "diff_updates_v2",
    "encode_state_vector_from_update_v2",
    "merge_updates_v1",
    "merge_updates_v2",
]

Carrier = Union[Item, GCRange, SkipRange]


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
        return cls.decode(DecoderV2(data))

    # --- encoding ---

    def encode(self, enc) -> None:
        self.encode_diff(StateVector(), enc)

    def encode_v1(self) -> bytes:
        enc = EncoderV1()
        self.encode(enc)
        return enc.to_bytes()

    def encode_v2(self) -> bytes:
        enc = EncoderV2()
        self.encode(enc)
        return enc.to_bytes()

    def encode_diff(self, remote_sv: StateVector, enc) -> None:
        """Encode only what `remote_sv` is missing (update.rs:490-535):
        per client, from the first carrier that reaches past the remote's
        clock (Skips before it dropped), higher clients first."""
        per_client: List[Tuple[int, int, List[Carrier]]] = []
        for client, blocks in self.blocks.items():
            remote_clock = remote_sv.get(client)
            out: List[Carrier] = []
            offset = 0
            it = iter(blocks)
            for block in it:
                if block.is_skip:
                    continue
                if block.id.clock + block.len > remote_clock:
                    offset = max(0, remote_clock - block.id.clock)
                    out.append(block)
                    out.extend(it)  # everything after the first match
                    break
            if out:
                per_client.append((client, offset, out))
        per_client.sort(key=lambda e: -e[0])
        enc.write_var(len(per_client))
        for client, offset, out in per_client:
            enc.write_var(len(out))
            enc.write_client(client)
            enc.write_var(out[0].id.clock + offset)
            out[0].encode(enc, offset)
            for block in out[1:]:
                block.encode(enc, 0)
        self.delete_set.encode(enc)

    def encode_diff_v1(self, remote_sv: StateVector) -> bytes:
        enc = EncoderV1()
        self.encode_diff(remote_sv, enc)
        return enc.to_bytes()

    # --- merge ---

    @classmethod
    def merge(cls, updates: List["Update"]) -> "Update":
        """Merge updates into one. Per client, carriers are sorted by clock
        (Items before Skips on ties); a carrier already covered is dropped,
        a partly covered one keeps its uncovered suffix (a detached split:
        the inputs are never changed), clock gaps become Skip carriers and
        trailing Skips are dropped. Delete sets are unioned."""
        all_blocks: Dict[int, List[Carrier]] = {}
        delete_set = DeleteSet()
        for u in updates:
            for client, dq in u.blocks.items():
                all_blocks.setdefault(client, []).extend(dq)
            delete_set.merge(u.delete_set)

        merged: Dict[int, Deque[Carrier]] = {}
        for client, carriers in all_blocks.items():
            carriers.sort(key=lambda c: (c.id.clock, c.is_skip))
            out: Deque[Carrier] = deque()
            current_end: Optional[int] = None  # clock after the last carrier out
            for c in carriers:
                start, length = c.id.clock, c.len
                if current_end is None:
                    out.append(c)
                    current_end = start + length
                    continue
                if start >= current_end:
                    if start > current_end:
                        out.append(SkipRange(ID(client, current_end), start - current_end))
                    # whole: a split at offset 0 would rewrite its origin
                    out.append(c)
                    current_end = start + length
                elif start + length <= current_end:
                    continue  # fully covered
                else:
                    overlap = current_end - start
                    if c.is_skip:
                        out.append(SkipRange(ID(client, current_end), length - overlap))
                    elif isinstance(c, GCRange):
                        out.append(GCRange(ID(client, current_end), length - overlap))
                    else:
                        out.append(c.split_off(overlap))
                    current_end = start + length
            while out and out[-1].is_skip:
                out.pop()
            if out:
                merged[client] = out
        return cls(merged, delete_set)


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


# --- doc-less v1 utilities (alt.rs:15-95) ------------------------------------


def merge_updates_v1(updates: List[bytes]) -> bytes:
    """One v1 update holding everything `updates` hold (the JAX package's
    ``compat.merge_updates``)."""
    return Update.merge([Update.decode_v1(u) for u in updates]).encode_v1()


def merge_updates_v2(updates: List[bytes]) -> bytes:
    return Update.merge([Update.decode_v2(u) for u in updates]).encode_v2()


def encode_state_vector_from_update_v2(update: bytes) -> bytes:
    """The state vector is written in v1 form, as yrs writes it."""
    return Update.decode_v2(update).state_vector().encode_v1()


def diff_updates_v1(update: bytes, state_vector: bytes) -> bytes:
    """What `update` holds past the v1 `state_vector`, as a v1 update."""
    return Update.decode_v1(update).encode_diff_v1(StateVector.decode_v1(state_vector))


def diff_updates_v2(update: bytes, state_vector: bytes) -> bytes:
    """What the v2 `update` holds past the v1 `state_vector`, as a v2
    update."""
    enc = EncoderV2()
    Update.decode_v2(update).encode_diff(StateVector.decode_v1(state_vector), enc)
    return enc.to_bytes()
