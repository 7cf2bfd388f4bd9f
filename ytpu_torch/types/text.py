"""Text — collaborative rich text.

Copy of `ytpu.types.text`; parity target: yrs types/text.rs (`Text` trait
:158 — insert :212, insert_with_attributes :275, format :353-452,
remove_range, push; `find_position` :734; diff :534).

Indices are measured in UTF-16 code units (the Yjs clock unit) — the same
unit the batched device engine uses for its prefix-sum position lookups.
"""

from __future__ import annotations

from typing import Any as PyAny, Dict, List, Optional

from ytpu_torch.core.block import Item
from ytpu_torch.core.branch import TYPE_TEXT
from ytpu_torch.core.content import (
    ContentEmbed,
    ContentFormat,
    ContentString,
    ContentType,
)
from ytpu_torch.core.transaction import ItemPosition, Transaction

from .shared import SharedType, find_position, to_content

__all__ = ["Text", "Diff", "YChange"]


class YChange:
    """Change annotation on a snapshot diff run (parity: types/text.rs:1190 —
    `YChange { kind, id }`; kinds Added/Removed)."""

    ADDED = "added"
    REMOVED = "removed"

    __slots__ = ("kind", "id")

    def __init__(self, kind: str, id):
        self.kind = kind
        self.id = id

    def __eq__(self, other):
        if not isinstance(other, YChange):
            return NotImplemented
        return self.kind == other.kind and self.id == other.id

    def __repr__(self):
        return f"YChange({self.kind}, {self.id})"


class Diff:
    """One run of a text diff: a value plus its formatting attributes and an
    optional snapshot-change annotation (parity: types/text.rs:1103 `Diff`)."""

    __slots__ = ("insert", "attributes", "ychange")

    def __init__(
        self,
        insert: PyAny,
        attributes: Optional[Dict[str, PyAny]] = None,
        ychange: Optional[YChange] = None,
    ):
        self.insert = insert
        self.attributes = attributes
        self.ychange = ychange

    def __eq__(self, other):
        if not isinstance(other, Diff):
            return NotImplemented
        return (
            self.insert == other.insert
            and (self.attributes or None) == (other.attributes or None)
            and self.ychange == other.ychange
        )

    def __repr__(self):
        parts = [repr(self.insert)]
        if self.attributes:
            parts.append(repr(self.attributes))
        if self.ychange:
            parts.append(repr(self.ychange))
        return f"Diff({', '.join(parts)})"


class Text(SharedType):
    type_ref = TYPE_TEXT
    __slots__ = ()

    def __len__(self) -> int:
        return self.branch.content_len

    # --- reads -----------------------------------------------------------------

    def get_string(self) -> str:
        """Concatenation of all alive string chunks (parity: GetString)."""
        out: List[str] = []
        item = self.branch.start
        while item is not None:
            if not item.deleted and isinstance(item.content, ContentString):
                out.append(item.content.text)
            item = item.right
        return "".join(out)

    def diff(self) -> List[Diff]:
        """Current content as runs annotated with formatting attributes."""
        return self.diff_range(None, None, None)

    def diff_range(
        self,
        txn: Optional[Transaction],
        hi=None,
        lo=None,
        compute_ychange=None,
    ) -> List[Diff]:
        """Diff runs between two historical states (parity: types/text.rs:534-
        `diff_range` / DiffIterator with snapshot visibility :577).

        `hi` is the snapshot to render (None = current state); `lo` is an
        earlier snapshot used to annotate runs: content visible in `hi` but
        not in `lo` is marked `YChange.ADDED`; content visible in `lo` but
        deleted by `hi` is included and marked `YChange.REMOVED`.
        """
        if compute_ychange is None:
            compute_ychange = YChange
        for snap in (hi, lo):
            if snap is not None:
                if txn is None:
                    raise ValueError("diff_range with snapshots needs a write txn")
                txn.split_by_snapshot(snap)

        def visible(item: Item, snap) -> bool:
            if snap is None:
                return not item.deleted
            return item.id.clock < snap.state_vector.get(
                item.id.client
            ) and not snap.delete_set.contains(item.id)

        runs: List[Diff] = []
        attrs: Dict[str, PyAny] = {}
        buf: List[str] = []
        cur_kind: Optional[str] = None
        cur_change: Optional[YChange] = None

        def flush():
            if buf:
                runs.append(
                    Diff("".join(buf), dict(attrs) if attrs else None, cur_change)
                )
                buf.clear()

        item = self.branch.start
        while item is not None:
            vis_hi = visible(item, hi)
            vis_lo = lo is not None and visible(item, lo)
            if vis_hi or vis_lo:
                content = item.content
                if isinstance(content, ContentString):
                    if not vis_hi:
                        kind = YChange.REMOVED
                    elif lo is not None and not vis_lo:
                        kind = YChange.ADDED
                    else:
                        kind = None
                    if kind != cur_kind:
                        flush()
                        cur_kind = kind
                        cur_change = (
                            compute_ychange(kind, item.id) if kind else None
                        )
                    buf.append(content.text)
                elif isinstance(content, ContentFormat):
                    if vis_hi:
                        if attrs.get(content.key) != content.value:
                            flush()
                        if content.value is None:
                            attrs.pop(content.key, None)
                        else:
                            attrs[content.key] = content.value
                elif isinstance(content, (ContentEmbed, ContentType)):
                    flush()
                    from .shared import out_value

                    if not vis_hi:
                        kind = YChange.REMOVED
                    elif lo is not None and not vis_lo:
                        kind = YChange.ADDED
                    else:
                        kind = None
                    runs.append(
                        Diff(
                            out_value(item),
                            dict(attrs) if attrs else None,
                            compute_ychange(kind, item.id) if kind else None,
                        )
                    )
                    cur_kind, cur_change = None, None
            item = item.right
        flush()
        return runs

    def to_json(self) -> str:
        return self.get_string()

    # --- time travel -----------------------------------------------------------

    def get_string_at(self, txn: Transaction, snapshot) -> str:
        """Render the text as it was at `snapshot` (parity: the snapshot
        visibility rule of types/text.rs:569-634: an element is visible iff
        it was inserted before the snapshot and not deleted by it)."""
        txn.split_by_snapshot(snapshot)
        sv = snapshot.state_vector
        ds = snapshot.delete_set
        out: List[str] = []
        item = self.branch.start
        while item is not None:
            if (
                item.id.clock < sv.get(item.id.client)
                and not ds.contains(item.id)
                and isinstance(item.content, ContentString)
            ):
                out.append(item.content.text)
            item = item.right
        return "".join(out)

    # --- writes ----------------------------------------------------------------

    def insert(self, txn: Transaction, index: int, chunk: str) -> None:
        """Parity: types/text.rs:212."""
        if not chunk:
            return
        pos = self._pos(txn, index)
        txn.create_item(pos, ContentString(chunk), None)

    def insert_embed(self, txn: Transaction, index: int, value: PyAny) -> None:
        pos = self._pos(txn, index)
        if hasattr(value, "make_branch"):
            content, prelim = to_content(value)
            item = txn.create_item(pos, content, None)
            prelim.fill(txn, item.content.branch)
        else:
            txn.create_item(pos, ContentEmbed(value), None)

    def insert_with_attributes(
        self, txn: Transaction, index: int, chunk: str, attrs: Dict[str, PyAny]
    ) -> None:
        """Parity: types/text.rs:275 — wraps the inserted chunk in format marks."""
        if not chunk:
            return
        pos = find_position(self.branch, txn, index, track_attrs=True)
        if pos is None:
            raise IndexError(index)
        current = pos.current_attrs or {}
        # only emit marks that actually change the surrounding formatting
        changed = {k: v for k, v in attrs.items() if current.get(k) != v}
        reset = {k: None for k in current if k not in attrs}
        opens = {**changed}
        for key, value in opens.items():
            item = txn.create_item(pos, ContentFormat(key, value), None)
            pos.left = item
        inserted = txn.create_item(pos, ContentString(chunk), None)
        pos.left = inserted
        # close marks so the following text keeps its old formatting
        for key in opens:
            old = current.get(key)
            item = txn.create_item(pos, ContentFormat(key, old), None)
            pos.left = item
        del reset  # negations beyond the insert range are format()'s job

    def format(
        self, txn: Transaction, index: int, length: int, attrs: Dict[str, PyAny]
    ) -> None:
        """Apply formatting over an existing range (parity: types/text.rs:353-452)."""
        if length == 0 or not attrs:
            return
        pos = find_position(self.branch, txn, index, track_attrs=True)
        if pos is None:
            raise IndexError(index)
        current = dict(pos.current_attrs or {})
        # open marks for attributes that differ at the cursor; `negated`
        # remembers what to restore after the range
        negated: Dict[str, PyAny] = {}
        for key, value in attrs.items():
            if current.get(key) != value:
                negated[key] = current.get(key)
                item = txn.create_item(pos, ContentFormat(key, value), None)
                pos.left = item
        # walk `length` visible units; old marks for formatted keys inside
        # the range are deleted (they would override ours) and fold into
        # `negated` so the close restores the right value
        remaining = length
        right = pos.left.right if pos.left is not None else pos.right
        store = txn.store
        while right is not None and remaining > 0:
            if not right.deleted:
                content = right.content
                if isinstance(content, ContentFormat):
                    key = content.key
                    if key in attrs:
                        if attrs[key] == content.value:
                            negated.pop(key, None)
                        else:
                            negated[key] = content.value
                        txn.delete(right)
                elif right.countable:
                    if remaining < right.len:
                        store.blocks.split_at(right, remaining)
                    remaining -= right.len
            pos.left = right
            right = right.right
        # close the range: restore previous values
        for key, value in negated.items():
            item = txn.create_item(
                ItemPosition(self.branch, pos.left, right, 0, None),
                ContentFormat(key, value),
                None,
            )
            pos.left = item

    def apply_delta(self, txn: Transaction, delta) -> None:
        """Apply a Quill-style delta (parity: types/text.rs:233-265
        `apply_delta`, with helpers insert :703, remove :806, insert_format
        :875; surfaced as ywasm YText.applyDelta).

        `delta` is an iterable of ops: ``{"insert": str | embed | prelim,
        "attributes"?}``, ``{"delete": n}``, ``{"retain": n, "attributes"?}``.
        A single cursor walks the sequence across ops; inserts explicitly
        unset surrounding formats not named in their attributes (Quill
        semantics — unlike `insert`, which inherits them).
        """
        branch = self.branch
        pos = ItemPosition(branch, None, branch.start, 0, {})
        for op in delta:
            if "insert" in op:
                attrs = dict(op.get("attributes") or {})
                _delta_insert(branch, txn, pos, op["insert"], attrs)
            elif "delete" in op:
                _delta_remove(txn, pos, int(op["delete"]))
            elif "retain" in op:
                attrs = dict(op.get("attributes") or {})
                _delta_retain(branch, txn, pos, int(op["retain"]), attrs)

    def push(self, txn: Transaction, chunk: str) -> None:
        self.insert(txn, len(self), chunk)

    def remove_range(self, txn: Transaction, index: int, length: int) -> None:
        """Parity: types/text.rs remove_range."""
        if length == 0:
            return
        pos = self._pos(txn, index)
        remaining = length
        right = pos.right
        store = txn.store
        while right is not None and remaining > 0:
            if not right.deleted and right.countable:
                if remaining < right.len:
                    store.blocks.split_at(right, remaining)
                remaining -= min(remaining, right.len)
                txn.delete(right)
            right = right.right
        if remaining > 0:
            raise IndexError(f"remove_range past end of text ({remaining} left)")

    # --- helpers ---------------------------------------------------------------

    def _pos(self, txn: Transaction, index: int) -> ItemPosition:
        pos = find_position(self.branch, txn, index)
        if pos is None:
            raise IndexError(index)
        return pos


# --- apply_delta cursor machinery ---------------------------------------------
# Faithful ports of the reference free functions the Delta walker composes
# (types/text.rs: unset_missing block.rs:954, minimize_attr_changes :943,
# insert_attributes :965, insert_negated_attributes :1008, insert :703,
# remove :806 + clean_format_gap :1058, insert_format :875). Attribute
# values use None for the wire's Null (an explicit format reset).


def _unset_missing(pos: ItemPosition, attrs: Dict[str, PyAny]) -> None:
    if pos.current_attrs:
        for k in pos.current_attrs:
            if k not in attrs:
                attrs[k] = None


def _minimize_attr_changes(pos: ItemPosition, attrs: Dict[str, PyAny]) -> None:
    """Skip over existing format marks that already state what we'd insert."""
    while pos.right is not None:
        right = pos.right
        if right.deleted:
            pos.forward()
        elif (
            isinstance(right.content, ContentFormat)
            and right.content.key in attrs
            and attrs[right.content.key] == right.content.value
        ):
            pos.forward()
        else:
            break


def _insert_attributes(branch, txn: Transaction, pos: ItemPosition, attrs):
    negated: Dict[str, PyAny] = {}
    for k, v in attrs.items():
        current = (pos.current_attrs or {}).get(k)
        if v != current:
            negated[k] = current
            item = txn.create_item(pos, ContentFormat(k, v), None)
            pos.right = item
            pos.forward()
    return negated


def _insert_negated_attributes(branch, txn: Transaction, pos: ItemPosition, negated):
    while pos.right is not None:
        right = pos.right
        if right.deleted:
            pos.forward()
        elif (
            isinstance(right.content, ContentFormat)
            and right.content.key in negated
            and negated[right.content.key] == right.content.value
        ):
            del negated[right.content.key]
            pos.forward()
        else:
            break
    for k, v in negated.items():
        item = txn.create_item(pos, ContentFormat(k, v), None)
        pos.right = item
        pos.forward()


def _delta_insert(branch, txn: Transaction, pos: ItemPosition, value, attrs) -> None:
    _unset_missing(pos, attrs)
    _minimize_attr_changes(pos, attrs)
    negated = _insert_attributes(branch, txn, pos, attrs)
    if isinstance(value, str):
        item = txn.create_item(pos, ContentString(value), None)
    elif hasattr(value, "make_branch"):  # a prelim shared type as embed
        content, prelim = to_content(value)
        item = txn.create_item(pos, content, None)
        prelim.fill(txn, item.content.branch)
    else:
        item = txn.create_item(pos, ContentEmbed(value), None)
    if item is not None:  # zero-length content creates no item (text.rs:714)
        pos.right = item
        pos.forward()
    _insert_negated_attributes(branch, txn, pos, negated)


def _delta_remove(txn: Transaction, pos: ItemPosition, length: int) -> None:
    remaining = length
    start = pos.right
    start_attrs = dict(pos.current_attrs or {})
    store = txn.store
    while pos.right is not None and remaining > 0:
        item = pos.right
        if not item.deleted and isinstance(
            item.content, (ContentString, ContentEmbed, ContentType)
        ):
            if remaining < item.len:
                store.blocks.split_at(item, remaining)
                remaining = 0
            else:
                remaining -= item.len
            txn.delete(item)
        pos.forward()
    if remaining > 0:
        raise IndexError(f"delta delete past end of text ({remaining} left)")
    _clean_format_gap(txn, start, pos.right, start_attrs, dict(pos.current_attrs or {}))


def _clean_format_gap(txn: Transaction, start, end, start_attrs, end_attrs) -> None:
    """Drop format marks in a deleted gap that restate the surrounding
    formatting (parity: types/text.rs:1058 clean_format_gap)."""
    while end is not None:
        content = end.content
        if isinstance(content, (ContentString, ContentEmbed)):
            break
        if not end.deleted and isinstance(content, ContentFormat):
            if content.value is None:
                end_attrs.pop(content.key, None)
            else:
                end_attrs[content.key] = content.value
        end = end.right
    while start is not None and start is not end:
        right = start.right
        if not start.deleted and isinstance(start.content, ContentFormat):
            key, value = start.content.key, start.content.value
            if end_attrs.get(key) != value or start_attrs.get(key) == value:
                txn.delete(start)
        start = right


def _is_valid_format_target(item: Item) -> bool:
    return item.deleted or isinstance(item.content, ContentFormat)


def _delta_retain(branch, txn: Transaction, pos: ItemPosition, length: int, attrs) -> None:
    """insert_format parity (types/text.rs:875): walk `length` units applying
    `attrs`, deleting overridden marks inside the range, closing with the
    negated values after it. With empty attrs this is a plain cursor skip."""
    _minimize_attr_changes(pos, attrs)
    negated = _insert_attributes(branch, txn, pos, dict(attrs))
    remaining = length
    store = txn.store
    while pos.right is not None and (
        remaining > 0 or (negated and _is_valid_format_target(pos.right))
    ):
        item = pos.right
        if not item.deleted:
            content = item.content
            if isinstance(content, ContentFormat):
                if content.key in attrs:
                    if attrs[content.key] == content.value:
                        negated.pop(content.key, None)
                    else:
                        negated[content.key] = content.value
                    txn.delete(item)
            elif item.countable:
                if remaining < item.len:
                    store.blocks.split_at(item, remaining)
                    remaining = 0
                    pos.forward()
                    break
                remaining -= item.len
        if not pos.forward():
            break
    _insert_negated_attributes(branch, txn, pos, negated)
