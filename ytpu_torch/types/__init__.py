"""Shared types over a `Branch` (Text, Array, Map, Xml…).

Copy of `ytpu.types`; parity target: yrs types/ — every shared type is
a projection over the universal branch node (lib.rs:433-437).
"""

from __future__ import annotations

from ytpu_torch.core.branch import (
    Branch,
    TYPE_ARRAY,
    TYPE_MAP,
    TYPE_TEXT,
    TYPE_XML_ELEMENT,
    TYPE_XML_FRAGMENT,
    TYPE_XML_HOOK,
    TYPE_XML_TEXT,
)

from .array import Array
from .map import Map
from .shared import (
    ArrayPrelim,
    MapPrelim,
    Prelim,
    SharedType,
    TextPrelim,
    XmlElementPrelim,
    XmlFragmentPrelim,
    XmlHookPrelim,
    XmlTextPrelim,
)
from .text import Diff, Text
from .weak import WeakPrelim, WeakRef, map_link, quote_range
from .xml import TreeWalker, XmlElement, XmlFragment, XmlHook, XmlText

__all__ = [
    "Array",
    "Map",
    "Text",
    "Diff",
    "XmlElement",
    "XmlFragment",
    "XmlHook",
    "XmlText",
    "TreeWalker",
    "SharedType",
    "Prelim",
    "TextPrelim",
    "ArrayPrelim",
    "MapPrelim",
    "XmlElementPrelim",
    "XmlFragmentPrelim",
    "XmlHookPrelim",
    "XmlTextPrelim",
    "WeakRef",
    "WeakPrelim",
    "quote_range",
    "map_link",
    "wrap_branch",
]

from ytpu_torch.core.branch import TYPE_WEAK

_WRAPPERS = {
    TYPE_ARRAY: Array,
    TYPE_MAP: Map,
    TYPE_TEXT: Text,
    TYPE_XML_ELEMENT: XmlElement,
    TYPE_XML_FRAGMENT: XmlFragment,
    TYPE_XML_TEXT: XmlText,
    TYPE_XML_HOOK: XmlHook,
    TYPE_WEAK: WeakRef,
}


def wrap_branch(branch: Branch) -> SharedType:
    """Wrap a branch in its user-facing shared type (by runtime type tag).

    Root branches decoded off the wire are `Undefined` until first typed
    access (reference: root-type reinterpretation, transaction.rs:123-180);
    for display purposes infer a view from the branch contents.
    """
    cls = _WRAPPERS.get(branch.type_ref)
    if cls is None:
        from ytpu_torch.core.content import ContentString

        if branch.start is None and branch.map:
            cls = Map
        else:
            from ytpu_torch.core.content import ContentType

            xml_refs = (TYPE_XML_ELEMENT, TYPE_XML_FRAGMENT, TYPE_XML_TEXT)
            node = branch.start
            cls = Array
            while node is not None:
                if isinstance(node.content, ContentString):
                    cls = Text
                    break
                if (
                    isinstance(node.content, ContentType)
                    and node.content.branch.type_ref in xml_refs
                ):
                    cls = XmlFragment
                    break
                node = node.right
    return cls(branch)
