"""XML shared types: XmlFragment / XmlElement / XmlText.

Copy of `ytpu.types.xml`; parity target: yrs types/xml.rs
(XmlElementRef :237, XmlTextRef :520, XmlFragmentRef :778, attribute trait
:976, tree trait :1034). XML nodes reuse the sequence kernel (children) and
the map kernel (attributes) over the same `Branch` — both components active.
"""

from __future__ import annotations

from typing import Any as PyAny, Iterator, List, Optional

from ytpu_torch.core.branch import (
    Branch,
    TYPE_XML_ELEMENT,
    TYPE_XML_FRAGMENT,
    TYPE_XML_HOOK,
    TYPE_XML_TEXT,
)
from ytpu_torch.core.content import ContentFormat, ContentString
from ytpu_torch.core.transaction import ItemPosition, Transaction

from .array import Array
from .map import Map
from .shared import SharedType, out_value, to_content
from .text import Text

__all__ = ["XmlFragment", "XmlElement", "XmlText", "XmlHook", "TreeWalker"]


def _attr_str(value) -> str:
    """XML attribute values render as strings (parity: xml.rs attr iter)."""
    if isinstance(value, str):
        return value
    if value is True:
        return "true"
    if value is False:
        return "false"
    if value is None:
        return "null"
    if isinstance(value, float) and value.is_integer():
        return str(int(value))
    return str(value)


class _XmlAttrs:
    """Attribute component shared by XmlElement / XmlText."""

    def insert_attribute(self, txn: Transaction, name: str, value: str) -> None:
        Map(self.branch).insert(txn, name, str(value))

    def get_attribute(self, name: str) -> Optional[str]:
        value = Map(self.branch).get(name)
        return None if value is None else _attr_str(value)

    def remove_attribute(self, txn: Transaction, name: str) -> None:
        Map(self.branch).remove(txn, name)

    def attributes(self) -> Iterator:
        for key, value in Map(self.branch).items():
            yield key, _attr_str(value)


class _XmlChildren:
    """Child-sequence component shared by XmlFragment / XmlElement."""

    def __len__(self) -> int:
        return self.branch.content_len

    def insert(self, txn: Transaction, index: int, value):
        """Insert a node; returns the integrated child (parity: xml.rs
        XmlFragment::insert returning the node ref)."""
        Array(self.branch).insert(txn, index, value)
        return self.get(index)

    def insert_range(self, txn: Transaction, index: int, values: List[PyAny]) -> None:
        Array(self.branch).insert_range(txn, index, values)

    def push_back(self, txn: Transaction, value) -> None:
        Array(self.branch).push_back(txn, value)

    def remove_range(self, txn: Transaction, index: int, length: int) -> None:
        Array(self.branch).remove_range(txn, index, length)

    def get(self, index: int):
        return Array(self.branch).get(index)

    def children(self) -> Iterator:
        return iter(Array(self.branch))

    def children_str(self) -> str:
        out = []
        for child in self.children():
            if isinstance(child, SharedType):
                out.append(child.get_string())
            else:
                out.append(str(child))
        return "".join(out)


class _XmlNode:
    """Tree navigation shared by all XML nodes (parity: xml.rs Xml trait
    :976 + tree traversal)."""

    def parent(self):
        item = self.branch.item
        if item is None or not isinstance(item.parent, Branch):
            return None
        from . import wrap_branch

        return wrap_branch(item.parent)

    def _sibling(self, forward: bool):
        item = self.branch.item
        if item is None:
            return None
        node = item.right if forward else item.left
        while node is not None:
            if not node.deleted and node.countable:
                return out_value(node)
            node = node.right if forward else node.left
        return None

    def next_sibling(self):
        return self._sibling(True)

    def prev_sibling(self):
        return self._sibling(False)


class TreeWalker:
    """Depth-first iterator over an XML subtree (parity: xml.rs TreeWalker)."""

    def __init__(self, root):
        self.stack = list(reversed(list(root.children()))) if hasattr(
            root, "children"
        ) else []

    def __iter__(self):
        return self

    def __next__(self):
        if not self.stack:
            raise StopIteration
        node = self.stack.pop()
        if hasattr(node, "children"):
            self.stack.extend(reversed(list(node.children())))
        return node


class XmlFragment(_XmlChildren, _XmlNode, SharedType):
    type_ref = TYPE_XML_FRAGMENT
    __slots__ = ()

    def get_string(self) -> str:
        return self.children_str()

    def successors(self) -> TreeWalker:
        return TreeWalker(self)

    def first_child(self):
        return self.get(0)

    def to_json(self) -> str:
        return self.get_string()


class XmlElement(_XmlChildren, _XmlAttrs, _XmlNode, SharedType):
    type_ref = TYPE_XML_ELEMENT
    __slots__ = ()

    @property
    def tag(self) -> str:
        return self.branch.type_name or "UNDEFINED"

    def successors(self) -> TreeWalker:
        return TreeWalker(self)

    def first_child(self):
        return self.get(0)

    def get_string(self) -> str:
        attrs = "".join(f' {k}="{v}"' for k, v in sorted(self.attributes()))
        inner = self.children_str()
        return f"<{self.tag}{attrs}>{inner}</{self.tag}>"

    def to_json(self) -> str:
        return self.get_string()


class XmlHook(_XmlAttrs, SharedType):
    """An opaque hook node keyed by name (parity: xml.rs XmlHook / map
    component only)."""

    type_ref = TYPE_XML_HOOK
    __slots__ = ()

    @property
    def hook_name(self) -> str:
        return self.branch.type_name or ""

    def to_json(self) -> dict:
        return {k: v for k, v in self.attributes()}


class XmlText(_XmlAttrs, _XmlNode, Text):
    type_ref = TYPE_XML_TEXT
    __slots__ = ()

    def get_string(self) -> str:
        """Render with embedded formatting as XML-ish tags (reference:
        types/xml.rs XmlTextRef::get_string)."""
        out: List[str] = []
        open_tags: List[str] = []
        item = self.branch.start
        while item is not None:
            if not item.deleted:
                content = item.content
                if isinstance(content, ContentString):
                    out.append(content.text)
                elif isinstance(content, ContentFormat):
                    if content.value is None:
                        if content.key in open_tags:
                            open_tags.remove(content.key)
                            out.append(f"</{content.key}>")
                    else:
                        open_tags.append(content.key)
                        out.append(f"<{content.key}>")
            item = item.right
        for tag in reversed(open_tags):
            out.append(f"</{tag}>")
        return "".join(out)

    def to_json(self) -> str:
        return self.get_string()
