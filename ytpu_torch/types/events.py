"""Type events: per-branch observer dispatch at commit time.

Copy of `ytpu.types.events`; parity target: the event layer in
yrs types/mod.rs:727-1183 (Event/Change/Delta/EntryChange)
and the firing order contract documented at lib.rs:501-519: (1) per-type
observers, (2) deep observers bubbling to parents, then the transaction-level
events (handled in `ytpu_torch.core.transaction.Transaction.commit`).

Deltas are computed lazily from the block chains, mirroring
types/text.rs:1213-1305 / array's Change reconstruction.
"""

from __future__ import annotations

from typing import Any as PyAny, Dict, List, Optional, Set, Tuple

from ytpu_torch.core.block import Item
from ytpu_torch.core.branch import Branch
from ytpu_torch.core.content import ContentFormat, ContentString

__all__ = ["Event", "Change", "EntryChange", "fire_type_events"]


class Change:
    """A sequence delta segment: ('insert', values) / ('delete', n) / ('retain', n).

    Insert and retain segments may carry formatting `attributes` (parity:
    the `Delta` variants of types/mod.rs:1068-1183 / types/text.rs:1213-1305).
    """

    __slots__ = ("kind", "values", "len", "attributes")

    def __init__(
        self,
        kind: str,
        values: Optional[List[PyAny]] = None,
        length: int = 0,
        attributes: Optional[Dict[str, PyAny]] = None,
    ):
        self.kind = kind
        self.values = values
        self.len = length
        self.attributes = attributes or None

    @classmethod
    def insert(cls, values: List[PyAny], attributes=None) -> "Change":
        return cls("insert", values, len(values), attributes)

    @classmethod
    def delete(cls, n: int) -> "Change":
        return cls("delete", None, n)

    @classmethod
    def retain(cls, n: int, attributes=None) -> "Change":
        return cls("retain", None, n, attributes)

    def __repr__(self) -> str:
        suffix = f", {self.attributes!r}" if self.attributes else ""
        if self.kind == "insert":
            return f"Insert({self.values!r}{suffix})"
        return f"{self.kind.capitalize()}({self.len}{suffix})"

    def __eq__(self, other):
        if not isinstance(other, Change):
            return NotImplemented
        return (
            self.kind == other.kind
            and self.len == other.len
            and self.values == other.values
            and (self.attributes or None) == (other.attributes or None)
        )


class EntryChange:
    """A map delta: action is 'add' | 'update' | 'remove'."""

    __slots__ = ("action", "old_value", "new_value")

    def __init__(self, action: str, old_value: PyAny = None, new_value: PyAny = None):
        self.action = action
        self.old_value = old_value
        self.new_value = new_value

    def __repr__(self) -> str:
        return f"EntryChange({self.action}, {self.old_value!r} -> {self.new_value!r})"


class Event:
    """Fired for every branch changed inside a committed transaction."""

    __slots__ = ("target", "current_target", "keys_changed", "txn", "_delta", "_keys")

    def __init__(self, target: Branch, keys_changed: Set[Optional[str]], txn):
        self.target = target
        self.current_target = target
        self.keys_changed = keys_changed
        self.txn = txn
        self._delta = None
        self._keys = None

    # --- path from root (parity: branch.rs:504) --------------------------------

    def path(self) -> List[PyAny]:
        path: List[PyAny] = []
        branch = self.target
        current = self.current_target
        while branch is not current and branch.item is not None:
            item = branch.item
            if item.parent_sub is not None:
                path.append(item.parent_sub)
            else:
                parent = item.parent
                if isinstance(parent, Branch):
                    index = 0
                    node = parent.start
                    while node is not None and node is not item:
                        if not node.deleted and node.countable:
                            index += node.len
                        node = node.right
                    path.append(index)
            branch = item.parent if isinstance(item.parent, Branch) else None
            if branch is None:
                break
        path.reverse()
        return path

    # --- sequence delta --------------------------------------------------------

    def delta(self) -> List[Change]:
        """Reconstruct insert/delete/retain runs for the sequence component,
        carrying formatting attributes (parity: the event-delta state machine
        of types/text.rs:1213-1305: track current vs. pre-transaction
        attributes; a surviving new Format mark turns into a retain-with-
        attributes segment unless it restores the old value)."""
        if self._delta is None:
            from ytpu_torch.types.shared import out_value

            txn = self.txn
            before = txn.before_state
            changes: List[Change] = []
            action: Optional[str] = None
            insert_buf: List[PyAny] = []
            retain = 0
            delete_len = 0
            current_attrs: Dict[str, PyAny] = {}   # formatting left of the cursor, now
            old_attrs: Dict[str, PyAny] = {}       # formatting left of the cursor, before txn
            pending_attrs: Dict[str, PyAny] = {}   # attribute changes for retain segments

            def add_op():
                nonlocal action, retain, delete_len
                if action == "insert" and insert_buf:
                    attrs = {
                        k: v for k, v in current_attrs.items() if v is not None
                    }
                    changes.append(Change.insert(insert_buf[:], attrs or None))
                    insert_buf.clear()
                elif action == "delete" and delete_len:
                    changes.append(Change.delete(delete_len))
                    delete_len = 0
                elif action == "retain" and retain:
                    changes.append(
                        Change.retain(retain, dict(pending_attrs) or None)
                    )
                    retain = 0
                action = None

            def set_action(a: str):
                nonlocal action
                if action != a:
                    add_op()
                    action = a

            item = self.target.start
            while item is not None:
                adds = item.id.clock >= before.get(item.id.client)
                dels = txn.delete_set.contains(item.id)
                content = item.content
                if isinstance(content, ContentFormat):
                    key, value = content.key, content.value
                    if adds:
                        if not dels:
                            cur = current_attrs.get(key)
                            if cur != value:
                                if action == "retain":
                                    add_op()
                                if value == old_attrs.get(key):
                                    pending_attrs.pop(key, None)
                                else:
                                    pending_attrs[key] = value
                    elif dels:
                        old_attrs[key] = value
                        cur = current_attrs.get(key)
                        if cur != value:
                            if action == "retain":
                                add_op()
                            pending_attrs[key] = cur
                    elif not item.deleted:
                        old_attrs[key] = value
                        if key in pending_attrs and pending_attrs[key] != value:
                            if action == "retain":
                                add_op()
                            if value is None:
                                pending_attrs.pop(key)
                            else:
                                pending_attrs[key] = value
                        # equal pending value: keep it — the run between the
                        # change and this old mark still needs the attribute
                    if not item.deleted:
                        if action == "insert":
                            add_op()
                        if value is None:
                            current_attrs.pop(key, None)
                        else:
                            current_attrs[key] = value
                elif item.countable:
                    if adds:
                        if not dels:
                            set_action("insert")
                            insert_buf.extend(
                                out_value(item, i) for i in range(item.len)
                            )
                    elif dels:
                        set_action("delete")
                        delete_len += item.len
                    elif not item.deleted:
                        set_action("retain")
                        retain += item.len
                item = item.right
            add_op()
            while changes and changes[-1].kind == "retain" and not changes[-1].attributes:
                changes.pop()
            self._delta = changes
        return self._delta

    # --- map delta -------------------------------------------------------------

    def keys(self) -> Dict[str, EntryChange]:
        """Per-key changes of the map component."""
        if self._keys is None:
            from ytpu_torch.types.shared import out_value

            txn = self.txn
            before = txn.before_state
            out: Dict[str, EntryChange] = {}
            for key in self.keys_changed:
                if key is None:
                    continue
                item = self.target.map.get(key)
                if item is None:
                    continue
                known_before = item.id.clock < before.get(item.id.client)
                if not known_before:
                    # new live entry; find the previous live value underneath
                    old = None
                    node = item.left
                    while node is not None:
                        if node.id.clock < before.get(node.id.client) and not (
                            txn.delete_set.contains(node.id) and not node.deleted
                        ):
                            if not node.deleted or txn.delete_set.contains(node.id):
                                old = out_value(node)
                                break
                        node = node.left
                    if item.deleted:
                        if old is not None:
                            out[key] = EntryChange("remove", old_value=old)
                    elif old is None:
                        out[key] = EntryChange("add", new_value=out_value(item))
                    else:
                        out[key] = EntryChange(
                            "update", old_value=old, new_value=out_value(item)
                        )
                elif item.deleted and txn.delete_set.contains(item.id):
                    out[key] = EntryChange("remove", old_value=out_value(item))
            self._keys = out
        return self._keys


def fire_type_events(txn) -> None:
    """Steps 2-3 of the commit pipeline (parity: transaction.rs:839-877)."""
    events: List[Tuple[Branch, Event]] = []
    for branch, keys in txn.changed.items():
        if branch.observers or _has_deep_parent(branch):
            events.append((branch, Event(branch, keys, txn)))

    # 2. direct observers
    for branch, event in events:
        for cb in list(branch.observers):
            cb(txn, event)

    # 3. deep observers: bubble each event up the parent chain
    deep: Dict[int, Tuple[Branch, List[Event]]] = {}
    for branch, event in events:
        node = branch
        while node is not None:
            if node.deep_observers:
                entry = deep.setdefault(id(node), (node, []))
                entry[1].append(event)
            node = (
                node.item.parent
                if node.item is not None and isinstance(node.item.parent, Branch)
                else None
            )
    for node, evts in deep.values():
        # top-level events first: sort by path length
        evts.sort(key=lambda e: len(e.path()))
        for e in evts:
            e.current_target = node
        for cb in list(node.deep_observers):
            cb(txn, evts)


def _has_deep_parent(branch: Branch) -> bool:
    node = branch
    while node is not None:
        if node.deep_observers:
            return True
        node = (
            node.item.parent
            if node.item is not None and isinstance(node.item.parent, Branch)
            else None
        )
    return False
