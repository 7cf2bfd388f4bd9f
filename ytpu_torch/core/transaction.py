"""Transactions, the unit of change over a document (copy of
`ytpu.core.transaction`; parity target: yrs transaction.rs,
`TransactionMut` fields :317-338, `apply_delete` :472-575, recursive
`delete` :579-663, `apply_update` and the pending retry :675-727,
`create_item` :729-776, the 11-step `commit` :828-962, and `GCCollector`,
gc.rs).

A commit fires, in order: the shared types' events, the v1 and v2 update
observers, the after-transaction and cleanup observers, and the
sub-document observers.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from ytpu_torch.encoding.lib0 import Writer

from .block import GCRange, Item
from .branch import Branch
from .content import ContentDeleted, ContentDoc, ContentMove, ContentType
from .id_set import DeleteSet
from .ids import ID
from .state_vector import Snapshot, StateVector
from .update import PendingUpdate, Update

__all__ = ["Transaction", "ItemPosition"]


class ItemPosition:
    """Insertion cursor (parity: block.rs:916-925)."""

    __slots__ = ("parent", "left", "right", "index", "current_attrs")

    def __init__(self, parent: Branch, left=None, right=None, index=0, current_attrs=None):
        self.parent = parent
        self.left = left
        self.right = right
        self.index = index
        self.current_attrs = current_attrs

    def forward(self) -> bool:
        right = self.right
        if right is None:
            return False
        if not right.deleted:
            from .content import ContentFormat, ContentString, ContentEmbed

            if isinstance(right.content, (ContentString, ContentEmbed)):
                self.index += right.len
            elif isinstance(right.content, ContentFormat):
                if self.current_attrs is None:
                    self.current_attrs = {}
                _update_attrs(self.current_attrs, right.content.key, right.content.value)
        self.left = right
        self.right = right.right
        return True


def _update_attrs(attrs: dict, key: str, value) -> None:
    if value is None:
        attrs.pop(key, None)
    else:
        attrs[key] = value


class Transaction:
    """A read/write transaction; writes are committed on `__exit__`/commit()."""

    __slots__ = (
        "doc",
        "store",
        "origin",
        "before_state",
        "after_state",
        "delete_set",
        "merge_blocks",
        "changed",
        "changed_parent_types",
        "subdocs_added",
        "subdocs_removed",
        "subdocs_loaded",
        "committed",
        "prev_moved",
        "_events",
    )

    def __init__(self, doc, origin=None):
        self.doc = doc
        self.store = doc.store
        self.origin = origin
        self.before_state: StateVector = self.store.blocks.get_state_vector()
        self.after_state: Optional[StateVector] = None
        self.delete_set = DeleteSet()
        self.merge_blocks: List[ID] = []
        self.changed: Dict[Branch, Set[Optional[str]]] = {}
        self.changed_parent_types: List[Branch] = []
        self.subdocs_added: Dict[str, object] = {}
        self.subdocs_removed: Dict[str, object] = {}
        self.subdocs_loaded: Dict[str, object] = {}
        self.committed = False
        self.prev_moved: Dict[Item, Item] = {}  # item -> move that owned it
        self._events = []

    # --- context manager -------------------------------------------------------

    def __enter__(self) -> "Transaction":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.commit()
        self.doc._txn = None

    # --- reads -----------------------------------------------------------------

    def state_vector(self) -> StateVector:
        return self.store.blocks.get_state_vector()

    def snapshot(self) -> Snapshot:
        return self.store.snapshot()

    def encode_state_as_update_v1(self, remote_sv: Optional[StateVector] = None) -> bytes:
        return self.store.encode_state_as_update_v1(remote_sv or StateVector())

    def encode_diff_v1(self, remote_sv: StateVector) -> bytes:
        return self.store.encode_diff_v1(remote_sv)

    def encode_diff_v2(self, remote_sv: StateVector) -> bytes:
        return self.store.encode_diff_v2(remote_sv)

    def encode_update_v1(self) -> bytes:
        """This transaction's own delta (the update-event payload).

        Parity: transaction.rs:464-468.
        """
        from ytpu_torch.encoding.codec import EncoderV1

        enc = EncoderV1()
        self.store.write_blocks_from(self.before_state, enc)
        self.delete_set.encode(enc)
        return enc.to_bytes()

    def encode_update_v2(self) -> bytes:
        from ytpu_torch.encoding.codec import EncoderV2

        enc = EncoderV2()
        self.store.write_blocks_from(self.before_state, enc)
        self.delete_set.encode(enc)
        return enc.to_bytes()

    def has_added(self, id_: ID) -> bool:
        """Was the block at `id_` created inside this transaction?"""
        return id_.clock >= self.before_state.get(id_.client)

    # --- change tracking -------------------------------------------------------

    def add_changed_type(self, parent: Branch, parent_sub: Optional[str]) -> None:
        """Parity: transaction.rs:964-984."""
        anchor = parent.item
        if anchor is not None:
            trigger = (
                anchor.id.clock < self.before_state.get(anchor.id.client)
                and not anchor.deleted
            )
        else:
            trigger = True
        if trigger:
            self.changed.setdefault(parent, set()).add(parent_sub)

    # --- deletion --------------------------------------------------------------

    def delete(self, item: Item) -> bool:
        """Tombstone `item` (recursively for nested types).

        Parity: transaction.rs:579-663.
        """
        recurse: List[Item] = []
        result = False
        if not item.deleted:
            if item.parent_sub is None and item.countable:
                if isinstance(item.parent, Branch):
                    item.parent.block_len -= item.len
                    item.parent.content_len -= item.len
            item.mark_deleted()
            self.delete_set.insert(item.id, item.len)
            if isinstance(item.parent, Branch):
                self.add_changed_type(item.parent, item.parent_sub)
            content = item.content
            if isinstance(content, ContentDoc):
                guid = content.doc.guid
                if guid in self.subdocs_added:
                    del self.subdocs_added[guid]
                else:
                    self.subdocs_removed[guid] = content.doc
            elif isinstance(content, ContentType):
                branch = content.branch
                self.store.deregister(branch)
                self.changed.pop(branch, None)
                if branch.link_source is not None:
                    # deleting a weak link unlinks its quoted items
                    # (parity: weak.rs:509-517 LinkSource::unlink)
                    from ytpu_torch.types.weak import unlink_all

                    unlink_all(self.store, branch)
                node = branch.start
                while node is not None:
                    if not node.deleted:
                        recurse.append(node)
                    node = node.right
                for node in branch.map.values():
                    while node is not None:
                        if not node.deleted:
                            recurse.append(node)
                        node = node.left
            elif isinstance(content, ContentMove):
                content.move.delete(self, item)
            if item.linked:
                # notify links that the element was removed
                # (parity: transaction.rs:634-647)
                links = self.store.linked_by.pop(item, None)
                if links:
                    for link in links:
                        self.add_changed_type(link, item.parent_sub)
                        src = link.link_source
                        if src is not None and src.is_single():
                            src.first_item = None
            result = True

        for node in recurse:
            if not self.delete(node):
                self.merge_blocks.append(node.id)
        return result

    def apply_delete(self, ds: DeleteSet) -> Optional[DeleteSet]:
        """Apply a remote delete-set; returns ranges that couldn't be applied.

        Parity: transaction.rs:472-575.
        """
        unapplied = DeleteSet()
        for client, ranges in list(ds.clients.items()):
            blocks = self.store.blocks.get_client(client)
            if blocks is None:
                for start, end in ranges:
                    unapplied.insert_range(client, start, end)
                continue
            state = blocks.clock()
            for start, end in sorted(ranges):
                if start >= state:
                    unapplied.insert_range(client, start, end)
                    continue
                if state < end:
                    unapplied.insert_range(client, state, end)
                index = blocks.find_pivot(start)
                if index is None:
                    continue
                b = blocks[index]
                if b.is_item and not b.deleted and b.id.clock < start:
                    # split off the unaffected prefix
                    self.store.blocks.split_at(b, start - b.id.clock)
                    index += 1
                    self.merge_blocks.append(blocks[index].id)
                while index < len(blocks):
                    b = blocks[index]
                    if b.id.clock >= end:
                        break
                    if b.is_item and not b.deleted:
                        if b.id.clock + b.len > end:
                            self.store.blocks.split_at(b, end - b.id.clock)
                            self.merge_blocks.append(blocks[index + 1].id)
                        self.delete(b)
                    index += 1
        if unapplied.is_empty():
            return None
        return unapplied

    # --- update application ----------------------------------------------------

    def apply_update(self, update: Update) -> None:
        """Parity: transaction.rs:675-727 (pending stash & retry loop)."""
        remaining, remaining_ds = update.integrate(self)
        store = self.store
        retry = False
        if store.pending is not None:
            pending = store.pending
            for client, clock in pending.missing.clocks.items():
                if clock < store.blocks.get_clock(client):
                    retry = True
                    break
            if remaining is not None:
                for client, clock in remaining.missing.clocks.items():
                    pending.missing.set_min(client, clock)
                pending.update = Update.merge([pending.update, remaining.update])
            store.pending = pending
        else:
            store.pending = remaining

        if store.pending_ds is not None:
            pending_ds = store.pending_ds
            store.pending_ds = None
            ds2 = self.apply_delete(pending_ds)
            if remaining_ds is not None and ds2 is not None:
                remaining_ds.merge(ds2)
                store.pending_ds = remaining_ds
            else:
                store.pending_ds = remaining_ds or ds2
        else:
            store.pending_ds = remaining_ds

        if retry:
            pending = store.pending
            store.pending = None
            ds = store.pending_ds
            store.pending_ds = None
            self.apply_update(pending.update)
            ds_update = Update()
            if ds is not None:
                ds_update.delete_set = ds
            self.apply_update(ds_update)

    def apply_update_v1(self, data: bytes) -> None:
        self.apply_update(Update.decode_v1(data))

    def split_by_snapshot(self, snapshot: Snapshot) -> None:
        """Split blocks at snapshot boundaries so historical visibility
        checks are block-aligned (parity: transaction.rs:986-1018)."""
        store = self.store
        for client, clock in snapshot.state_vector.clocks.items():
            item = store.blocks.get_item(ID(client, clock))
            if item is not None and item.id.clock < clock:
                store.blocks.split_at(item, clock - item.id.clock)
                self.merge_blocks.append(ID(client, clock))
        for client, ranges in snapshot.delete_set.clients.items():
            for start, end in ranges:
                for edge in (start, end):
                    item = store.blocks.get_item(ID(client, edge))
                    if item is not None and item.id.clock < edge:
                        store.blocks.split_at(item, edge - item.id.clock)
                        self.merge_blocks.append(ID(client, edge))

    # --- local inserts ---------------------------------------------------------

    def create_item(self, pos: ItemPosition, content, parent_sub: Optional[str]) -> Optional[Item]:
        """Parity: transaction.rs:729-776."""
        left = pos.left
        right = pos.right
        origin = left.last_id if left is not None else None
        store = self.store
        id_ = ID(self.doc.client_id, store.get_local_state())
        if content.length() == 0:
            return None
        item = Item(
            id_,
            left,
            origin,
            right,
            right.id if right is not None else None,
            pos.parent,
            parent_sub,
            content,
        )
        store.integrate_block(self, item, 0)
        store.blocks.push_block(item)
        return item

    # --- commit pipeline -------------------------------------------------------

    def commit(self) -> None:
        """Parity: transaction.rs:828-962 (steps numbered as in the reference)."""
        if self.committed:
            return
        self.committed = True
        store = self.store
        doc = self.doc

        # 1. squash delete set
        self.delete_set.squash()
        self.after_state = store.blocks.get_state_vector()

        # changed branches + their ancestors (used by undo scope filtering;
        # parity: txn.changed_parent_types)
        seen = set()
        for branch in self.changed:
            node = branch
            while node is not None and id(node) not in seen:
                seen.add(id(node))
                self.changed_parent_types.append(node)
                node = (
                    node.item.parent
                    if node.item is not None and isinstance(node.item.parent, Branch)
                    else None
                )

        # 2-3. per-type observers + deep observers
        if self.changed:
            from ytpu_torch.types.events import fire_type_events

            fire_type_events(self)

        for cb in doc.after_transaction_subs:
            cb(self)

        # 4. GC delete set (unless disabled)
        if not doc.options.skip_gc:
            self._gc_collect()

        # 5-6. squash new blocks to the left
        for client, clock in self.after_state.clocks.items():
            before_clock = self.before_state.get(client)
            if before_clock != clock:
                blocks = store.blocks.get_client(client)
                pivot = blocks.find_pivot(before_clock)
                first_change = max(1, pivot if pivot is not None else 1)
                i = len(blocks) - 1
                while i >= first_change:
                    if blocks.squash_left(i):
                        pass
                    i -= 1

        # 7. squash explicitly queued merge candidates
        for bid in self.merge_blocks:
            blocks = store.blocks.get_client(bid.client)
            if blocks is None:
                continue
            pos = blocks.find_pivot(bid.clock)
            if pos is None:
                continue
            if pos + 1 < len(blocks):
                blocks.squash_left(pos + 1)
            elif pos > 0:
                blocks.squash_left(pos)

        # 8-10. cleanup + update events
        for cb in doc.transaction_cleanup_subs:
            cb(self)
        if doc.update_v1_subs:
            payload = self.encode_update_v1()
            if payload != b"\x00\x00":  # skip no-op transactions
                for cb in doc.update_v1_subs:
                    cb(payload, self.origin, self)
        if doc.update_v2_subs:
            payload = self.encode_update_v2()
            for cb in doc.update_v2_subs:
                cb(payload, self.origin, self)

        # 11. subdoc bookkeeping
        if self.subdocs_added or self.subdocs_removed or self.subdocs_loaded:
            for guid, subdoc in self.subdocs_added.items():
                subdoc.client_id = doc.client_id
                if subdoc.options.collection_id is None:
                    subdoc.options.collection_id = doc.options.collection_id
                store.subdocs[guid] = subdoc
            for guid in self.subdocs_removed:
                store.subdocs.pop(guid, None)
            for cb in doc.subdocs_subs:
                cb(self, self.subdocs_added, self.subdocs_removed, self.subdocs_loaded)
            for subdoc in self.subdocs_removed.values():
                subdoc.destroy()

    def _gc_collect(self) -> None:
        """Parity: gc.rs:11-65 + block.rs:1371-1382,1907-1928."""
        marked: List[Tuple[int, int]] = []

        def gc_item(item: Item, parent_gc: bool) -> None:
            if item.deleted and not item.keep:
                content = item.content
                if isinstance(content, ContentType):
                    branch = content.branch
                    node = branch.start
                    branch.start = None
                    while node is not None:
                        nxt = node.right
                        gc_item(node, True)
                        node = nxt
                    for node in branch.map.values():
                        while node is not None:
                            prev = node.left
                            gc_item(node, True)
                            node = prev
                    branch.map.clear()
                if parent_gc:
                    marked.append((item.id.client, item.id.clock))
                else:
                    item.content = ContentDeleted(item.len)

        for client, ranges in self.delete_set.clients.items():
            blocks = self.store.blocks.get_client(client)
            if blocks is None:
                continue
            for start, end in reversed(sorted(ranges)):
                idx = blocks.find_pivot(start)
                if idx is None:
                    continue
                clock = start
                while idx < len(blocks):
                    b = blocks[idx]
                    clock = b.id.clock + b.len
                    if clock > end:
                        break
                    if b.is_item:
                        gc_item(b, False)
                    idx += 1

        for client, clock in marked:
            blocks = self.store.blocks.get_client(client)
            if blocks is None:
                continue
            idx = blocks.find_pivot(clock)
            if idx is None:
                continue
            b = blocks[idx]
            if b.is_item and b.deleted and not b.keep:
                blocks.blocks[idx] = GCRange(b.id, b.len)
