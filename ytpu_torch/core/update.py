"""Update: a decoded, not yet integrated set of foreign blocks (copy of
`ytpu.core.update`; parity target: yrs update.rs, `Update` :91, block
decode :433-488, the `integrate` stack machine :169-308, `missing`
:310-385, `merge_updates` :537-704, `encode_diff` :490-535, and the
doc-less utilities of alt.rs:15-95).

An update carries, per client, a clock-contiguous run of block carriers
(Item / GC / Skip) plus a delete set. Integration applies blocks in causal
waves: a block whose origin, right origin or parent clocks are not known
locally is stashed, with the rest of its client's queue, into a pending
update. The batch ingestor's host lane decodes with it too; the sync
server merges a slot's pending stash into a reply with `merge_updates_v1`.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional, Tuple, Union

from ytpu_torch.encoding.codec import DecoderV1, DecoderV2, EncoderV1, EncoderV2
from ytpu_torch.encoding.lib0 import Cursor, Writer

from .block import GCRange, Item, SkipRange
from .branch import Branch
from .content import BLOCK_GC, BLOCK_SKIP, decode_content
from .id_set import DeleteSet
from .ids import ID, ClientID
from .moving import Move
from .state_vector import StateVector

__all__ = [
    "Update",
    "PendingUpdate",
    "decode_update_v1",
    "merge_updates_v1",
    "merge_updates_v2",
    "encode_state_vector_from_update_v1",
    "encode_state_vector_from_update_v2",
    "diff_updates_v1",
    "diff_updates_v2",
]

Carrier = Union[Item, GCRange, SkipRange]

HAS_ORIGIN = 0x80
HAS_RIGHT_ORIGIN = 0x40
HAS_PARENT_SUB = 0x20


class PendingUpdate:
    """Blocks that couldn't be integrated + the clocks they're waiting for.

    Parity: update.rs:289-299, store.rs:42-50.
    """

    __slots__ = ("update", "missing")

    def __init__(self, update: "Update", missing: StateVector):
        self.update = update
        self.missing = missing


class Update:
    __slots__ = ("blocks", "delete_set")

    def __init__(
        self,
        blocks: Optional[Dict[ClientID, Deque[Carrier]]] = None,
        delete_set: Optional[DeleteSet] = None,
    ):
        self.blocks: Dict[ClientID, Deque[Carrier]] = blocks if blocks is not None else {}
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

    # --- decoding ---

    @classmethod
    def decode(cls, dec) -> "Update":
        n_clients = dec.read_var()
        blocks: Dict[ClientID, Deque[Carrier]] = {}
        for _ in range(n_clients):
            n_blocks = dec.read_var()
            client = dec.read_client()
            clock = dec.read_var()
            dq = blocks.setdefault(client, deque())
            for _ in range(n_blocks):
                carrier = _decode_block(ID(client, clock), dec)
                if carrier is not None:
                    clock += carrier.len
                    dq.append(carrier)
        delete_set = DeleteSet.decode(dec)
        return cls(blocks, delete_set)

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
        """Encode only what `remote_sv` is missing (parity: update.rs:490-535)."""
        per_client: List[Tuple[ClientID, int, List[Carrier]]] = []
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
        per_client.sort(key=lambda e: -e[0])  # higher clients first
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

    # --- integration driver (parity: update.rs:169-308) ---

    def integrate(self, txn) -> Tuple[Optional[PendingUpdate], Optional[DeleteSet]]:
        """Integrate this update into the doc behind `txn`.

        Returns (pending blocks or None, unapplied delete-set or None).
        """
        store = txn.store
        pending: Optional[PendingUpdate] = None
        if self.blocks:
            client_ids = sorted(self.blocks.keys())  # popped from the end: descending
            current_client = client_ids.pop()
            current_target: Optional[Deque[Carrier]] = self.blocks.get(current_client)
            stack_head: Optional[Carrier] = (
                current_target.popleft() if current_target else None
            )
            local_sv = store.blocks.get_state_vector()
            missing_sv = StateVector()
            remaining: Dict[ClientID, Deque[Carrier]] = {}
            stack: List[Carrier] = []

            while stack_head is not None:
                block = stack_head
                if not block.is_skip:
                    id_ = block.id
                    local_clock = local_sv.get(id_.client)
                    if local_clock >= id_.clock:
                        offset = local_clock - id_.clock
                        dep = _missing_dep(block, local_sv)
                        if dep is not None:
                            stack.append(block)
                            dep_queue = self.blocks.get(dep)
                            if dep_queue:
                                # dependency may be satisfied later in this update
                                stack_head = dep_queue.popleft()
                                current_target = self.blocks.get(current_client)
                                continue
                            # causally depends on updates we don't have
                            missing_sv.set_min(dep, local_sv.get(dep))
                            _return_stack(stack, self.blocks, remaining)
                            current_target = self.blocks.get(current_client)
                            stack = []
                        elif offset == 0 or offset < block.len:
                            local_sv.set_max(id_.client, id_.clock + block.len)
                            if block.is_item:
                                store.repair(block)
                            should_delete = store.integrate_block(txn, block, offset)
                            delete_ptr = block if (should_delete and block.is_item) else None
                            if block.is_item:
                                if block.parent is not None:
                                    store.blocks.push_block(block)
                                else:
                                    # unresolvable parent: degrade to GC range
                                    store.blocks.push_block(GCRange(block.id, block.len))
                                    delete_ptr = None
                            elif isinstance(block, GCRange):
                                store.blocks.push_block(block)
                            if delete_ptr is not None:
                                txn.delete(delete_ptr)
                    else:
                        # gap in this client's own sequence
                        missing_sv.set_min(id_.client, id_.clock - 1)
                        stack.append(block)
                        _return_stack(stack, self.blocks, remaining)
                        current_target = self.blocks.get(current_client)
                        stack = []

                # pick next head
                if stack:
                    stack_head = stack.pop()
                elif current_target:
                    stack_head = current_target.popleft()
                else:
                    stack_head = None
                    while client_ids:
                        cid = client_ids.pop()
                        dq = self.blocks.get(cid)
                        if dq:
                            current_client = cid
                            current_target = dq
                            stack_head = dq.popleft()
                            break

            if any(remaining.values()):
                pending = PendingUpdate(Update(remaining), missing_sv)

        remaining_ds = txn.apply_delete(self.delete_set)
        return pending, remaining_ds

    # --- merge (parity: update.rs:537-704, fresh algorithm) ---

    @classmethod
    def merge(cls, updates: List["Update"]) -> "Update":
        """Merge updates into one, synthesizing Skip markers over gaps.

        Fresh design (not the reference's k-way lazy merge): per client,
        carriers are sorted by clock; overlaps are resolved by preferring the
        carrier that extends furthest (splitting off already-covered
        prefixes), and clock gaps become explicit Skip carriers so the result
        remains a valid contiguous run.
        """
        all_blocks: Dict[ClientID, List[Carrier]] = {}
        delete_set = DeleteSet()
        for u in updates:
            for client, dq in u.blocks.items():
                all_blocks.setdefault(client, []).extend(dq)
            delete_set.merge(u.delete_set)

        merged: Dict[ClientID, Deque[Carrier]] = {}
        for client, carriers in all_blocks.items():
            # stable order: by clock; prefer Items over Skips on ties
            carriers.sort(key=lambda c: (c.id.clock, c.is_skip))
            out: Deque[Carrier] = deque()
            current_end: Optional[int] = None  # clock after last emitted carrier
            for c in carriers:
                start, length = c.id.clock, c.len
                if current_end is None:
                    out.append(c)
                    current_end = start + length
                    continue
                if start >= current_end:
                    if start > current_end:
                        # hole: synthesize a skip
                        out.append(
                            SkipRange(ID(client, current_end), start - current_end)
                        )
                    # contiguous (or after the skip): emit the carrier whole —
                    # splitting at offset 0 would rewrite its origin to
                    # (client, clock-1), which only coincides with the true
                    # origin for append-only streams
                    out.append(c)
                    current_end = start + length
                elif start + length <= current_end:
                    continue  # fully covered
                else:
                    # partial overlap: emit only the uncovered suffix
                    overlap = current_end - start  # > 0 here
                    if c.is_skip:
                        out.append(SkipRange(ID(client, current_end), length - overlap))
                    elif isinstance(c, GCRange):
                        out.append(GCRange(ID(client, current_end), length - overlap))
                    else:
                        # split a detached clone — merge() must never mutate
                        # its input updates (their carriers stay re-encodable)
                        clone = Item(
                            c.id, None, c.origin, None, c.right_origin,
                            c.parent, c.parent_sub, c.content.copy(),
                        )
                        clone.deleted = c.deleted
                        clone.keep = c.keep
                        clone.moved = c.moved
                        clone.redone = c.redone
                        right = clone.split(overlap)
                        right.left = None
                        out.append(right)
                    current_end = start + length
            # drop trailing skips: they carry no information
            while out and out[-1].is_skip:
                out.pop()
            if out:
                merged[client] = out
        return cls(merged, delete_set)


# --- block decode helper -------------------------------------------------------


def _decode_branch(dec) -> Branch:
    return Branch.decode_type_ref(dec)


def _decode_doc(dec):
    from .doc import Doc, Options

    opts = Options.decode(dec)
    return Doc(options=opts)


def _decode_block(id_: ID, dec) -> Optional[Carrier]:
    """Parity: update.rs:433-488."""
    info = dec.read_info()
    if info == BLOCK_SKIP:
        return SkipRange(id_, dec.read_var())
    if info == BLOCK_GC:
        return GCRange(id_, dec.read_len())
    cant_copy_parent = info & (HAS_ORIGIN | HAS_RIGHT_ORIGIN) == 0
    origin = None
    right_origin = None
    if info & HAS_ORIGIN:
        origin = ID(*dec.read_left_id())
    if info & HAS_RIGHT_ORIGIN:
        right_origin = ID(*dec.read_right_id())
    parent = None
    parent_sub = None
    if cant_copy_parent:
        if dec.read_parent_info():
            parent = dec.read_string()
        else:
            parent = ID(*dec.read_left_id())
        if info & HAS_PARENT_SUB:
            parent_sub = dec.read_string()
    content = decode_content(dec, info, _decode_branch, _decode_doc, Move.decode)
    if content.length() == 0:
        return None  # historical empty blocks have no effect
    return Item(id_, None, origin, None, right_origin, parent, parent_sub, content)


def _missing_dep(block: Carrier, local_sv: StateVector) -> Optional[ClientID]:
    """First unmet causal dependency of `block` (parity: update.rs:310-385)."""
    if not block.is_item:
        return None
    item: Item = block
    origin = item.origin
    if origin is not None and origin.client != item.id.client:
        if origin.clock >= local_sv.get(origin.client):
            return origin.client
    right_origin = item.right_origin
    if right_origin is not None and right_origin.client != item.id.client:
        if right_origin.clock >= local_sv.get(right_origin.client):
            return right_origin.client
    parent = item.parent
    if isinstance(parent, Branch):
        anchor = parent.item
        if anchor is not None and anchor.id.client != item.id.client:
            if anchor.id.clock >= local_sv.get(anchor.id.client):
                return anchor.id.client
    elif isinstance(parent, ID):
        if parent.client != item.id.client and parent.clock >= local_sv.get(parent.client):
            return parent.client
    content = item.content
    from .content import ContentMove, ContentType

    if isinstance(content, ContentMove):
        m = content.move
        start = m.start.id
        if start is not None and start.clock >= local_sv.get(start.client):
            return start.client
        if not m.is_collapsed():
            end = m.end.id
            if end is not None and end.clock >= local_sv.get(end.client):
                return end.client
    elif isinstance(content, ContentType):
        src = content.branch.link_source
        if src is not None:
            start = src.quote_start.id
            end = src.quote_end.id
            if start is not None and start.clock >= local_sv.get(start.client):
                return start.client
            if start != end and end is not None and end.clock >= local_sv.get(end.client):
                return end.client
    return None


def _return_stack(
    stack: List[Carrier],
    refs: Dict[ClientID, Deque[Carrier]],
    remaining: Dict[ClientID, Deque[Carrier]],
) -> None:
    """Move stacked carriers (plus the rest of their client queues) aside.

    Parity: update.rs:411-431 (with the same-client collision handled by
    appending instead of overwriting).
    """
    for item in stack:
        client = item.id.client
        rest = refs.pop(client, None)
        if rest is not None:
            rest.appendleft(item)
            if client in remaining:
                remaining[client].extend(rest)
            else:
                remaining[client] = rest
        else:
            if client in remaining:
                remaining[client].appendleft(item)
            else:
                remaining[client] = deque([item])
    stack.clear()


# --- doc-less binary utilities (parity: alt.rs:15-95) -------------------------


def decode_update_v1(data: bytes) -> Update:
    return Update.decode_v1(data)


def merge_updates_v1(updates: List[bytes]) -> bytes:
    return Update.merge([Update.decode_v1(u) for u in updates]).encode_v1()


def merge_updates_v2(updates: List[bytes]) -> bytes:
    return Update.merge([Update.decode_v2(u) for u in updates]).encode_v2()


def encode_state_vector_from_update_v1(update: bytes) -> bytes:
    return Update.decode_v1(update).state_vector().encode_v1()


def encode_state_vector_from_update_v2(update: bytes) -> bytes:
    return Update.decode_v2(update).state_vector().encode_v1()


def diff_updates_v1(update: bytes, state_vector: bytes) -> bytes:
    sv = StateVector.decode_v1(state_vector)
    return Update.decode_v1(update).encode_diff_v1(sv)


def diff_updates_v2(update: bytes, state_vector: bytes) -> bytes:
    sv = StateVector.decode_v1(state_vector)
    u = Update.decode_v2(update)
    enc = EncoderV2()
    u.encode_diff(sv, enc)
    return enc.to_bytes()
