"""Item content variants (copy of `ytpu.core.content`; parity target: yrs
`ItemContent`, block.rs:1507-1928, wire ref-numbers at :28-61).

Each content kind knows its CRDT length (UTF-16 code units for strings,
element count for sequences: what advances the Lamport clock), whether it
is countable (contributes to the visible length of a sequence), how to
split at an offset, how to merge with a right neighbour, and its wire
encoding. On the device a row carries ``(content_kind, content_ref,
len)`` columns and the payloads stay in host-side stores
(`ytpu_torch.models.batch_doc.PayloadStore`).
"""

from __future__ import annotations

import json
from typing import Any as PyAny, List, Optional, Tuple

__all__ = [
    "BLOCK_GC",
    "BLOCK_SKIP",
    "CONTENT_DELETED",
    "CONTENT_JSON",
    "CONTENT_BINARY",
    "CONTENT_STRING",
    "CONTENT_EMBED",
    "CONTENT_FORMAT",
    "CONTENT_TYPE",
    "CONTENT_ANY",
    "CONTENT_DOC",
    "CONTENT_MOVE",
    "utf16_len",
    "utf16_index",
    "split_str_utf16",
    "Content",
    "ContentDeleted",
    "ContentJSON",
    "ContentBinary",
    "ContentString",
    "ContentEmbed",
    "ContentFormat",
    "ContentType",
    "ContentAny",
    "ContentDoc",
    "ContentMove",
    "decode_content",
]

# Wire ref-numbers (low bits of the item info byte); parity: block.rs:28-61.
BLOCK_GC = 0
CONTENT_DELETED = 1
CONTENT_JSON = 2
CONTENT_BINARY = 3
CONTENT_STRING = 4
CONTENT_EMBED = 5
CONTENT_FORMAT = 6
CONTENT_TYPE = 7
CONTENT_ANY = 8
CONTENT_DOC = 9
BLOCK_SKIP = 10
CONTENT_MOVE = 11
# Device-engine sentinel (NOT a wire ref): a synthetic per-doc block row
# anchoring a non-primary named root branch (doc.rs:156-228 multi-root
# shape). Anchor rows have client == -1 (no wire identity, never ship);
# blocks parented to one re-emit the root-name wire form at encode time.
BLOCK_ROOT_ANCHOR = 12


def utf16_len(s: str) -> int:
    """Length of `s` in UTF-16 code units (the Yjs clock unit for text)."""
    n = len(s)
    # Astral characters (> U+FFFF) take two code units.
    for ch in s:
        if ord(ch) > 0xFFFF:
            n += 1
    return n


def utf16_index(s: str, offset: int) -> int:
    """Convert a UTF-16 code-unit offset into a Python string index."""
    if offset <= 0:
        return 0
    units = 0
    for i, ch in enumerate(s):
        if units >= offset:
            return i
        units += 2 if ord(ch) > 0xFFFF else 1
    return len(s)


def split_str_utf16(s: str, offset: int) -> Tuple[str, str]:
    """Split at a UTF-16 code-unit offset.

    If the offset lands inside a surrogate pair (astral char), both halves
    get a U+FFFD replacement for their severed half so the UTF-16 lengths
    stay consistent with the clock split (the workaround documented at
    reference block.rs:1852-1860).
    """
    if offset <= 0:
        return "", s
    units = 0
    for i, ch in enumerate(s):
        if units == offset:
            return s[:i], s[i:]
        width = 2 if ord(ch) > 0xFFFF else 1
        if units + width > offset:
            # offset splits this astral char
            return s[:i] + "\ufffd", "\ufffd" + s[i + 1 :]
        units += width
    return s, ""


class Content:
    """Base class for item content."""

    kind: int = -1
    countable: bool = False

    def length(self) -> int:
        raise NotImplementedError

    def splice(self, offset: int) -> "Content":
        """Split in place at `offset` (clock units); returns the right part."""
        raise NotImplementedError(f"{type(self).__name__} is not splittable")

    def merge(self, other: "Content") -> bool:
        """Try to append `other` (right neighbor's content). True on success."""
        return False

    def encode(self, enc) -> None:
        raise NotImplementedError

    def values(self) -> List[PyAny]:
        """User-facing element values (for countable sequence content)."""
        return []

    def copy(self) -> "Content":
        raise NotImplementedError


class ContentDeleted(Content):
    kind = CONTENT_DELETED
    countable = False
    __slots__ = ("len",)

    def __init__(self, length: int):
        self.len = length

    def length(self) -> int:
        return self.len

    def splice(self, offset: int) -> "ContentDeleted":
        right = ContentDeleted(self.len - offset)
        self.len = offset
        return right

    def merge(self, other: Content) -> bool:
        if isinstance(other, ContentDeleted):
            self.len += other.len
            return True
        return False

    def encode(self, enc) -> None:
        enc.write_len(self.len)

    def copy(self) -> "ContentDeleted":
        return ContentDeleted(self.len)

    def __repr__(self) -> str:
        return f"Deleted({self.len})"


class ContentJSON(Content):
    """Legacy JSON content: a list of raw JSON strings (one clock unit each)."""

    kind = CONTENT_JSON
    countable = True
    __slots__ = ("raw",)

    def __init__(self, raw: List[str]):
        self.raw = raw

    def length(self) -> int:
        return len(self.raw)

    def splice(self, offset: int) -> "ContentJSON":
        right = ContentJSON(self.raw[offset:])
        self.raw = self.raw[:offset]
        return right

    def merge(self, other: Content) -> bool:
        if isinstance(other, ContentJSON):
            self.raw.extend(other.raw)
            return True
        return False

    def encode(self, enc) -> None:
        enc.write_len(len(self.raw))
        for s in self.raw:
            enc.write_string(s)

    def values(self) -> List[PyAny]:
        out = []
        for s in self.raw:
            try:
                out.append(json.loads(s))
            except (ValueError, TypeError):
                out.append(None)
        return out

    def copy(self) -> "ContentJSON":
        return ContentJSON(list(self.raw))

    def __repr__(self) -> str:
        return f"JSON({self.raw!r})"


class ContentBinary(Content):
    kind = CONTENT_BINARY
    countable = True
    __slots__ = ("data",)

    def __init__(self, data: bytes):
        self.data = data

    def length(self) -> int:
        return 1

    def encode(self, enc) -> None:
        enc.write_buf(self.data)

    def values(self) -> List[PyAny]:
        return [self.data]

    def copy(self) -> "ContentBinary":
        return ContentBinary(self.data)

    def __repr__(self) -> str:
        return f"Binary({len(self.data)}b)"


class ContentString(Content):
    kind = CONTENT_STRING
    countable = True
    __slots__ = ("text", "_u16len")

    def __init__(self, text: str):
        self.text = text
        self._u16len = utf16_len(text)

    def length(self) -> int:
        return self._u16len

    def splice(self, offset: int) -> "ContentString":
        left, right = split_str_utf16(self.text, offset)
        self.text = left
        self._u16len = offset
        return ContentString(right)

    def merge(self, other: Content) -> bool:
        if isinstance(other, ContentString):
            self.text += other.text
            self._u16len += other._u16len
            return True
        return False

    def encode(self, enc) -> None:
        enc.write_string(self.text)

    def values(self) -> List[PyAny]:
        return list(self.text)

    def copy(self) -> "ContentString":
        return ContentString(self.text)

    def __repr__(self) -> str:
        return f"Str({self.text!r})"


class ContentEmbed(Content):
    kind = CONTENT_EMBED
    countable = True
    __slots__ = ("value",)

    def __init__(self, value: PyAny):
        self.value = value

    def length(self) -> int:
        return 1

    def encode(self, enc) -> None:
        enc.write_json(self.value)

    def values(self) -> List[PyAny]:
        return [self.value]

    def copy(self) -> "ContentEmbed":
        return ContentEmbed(self.value)

    def __repr__(self) -> str:
        return f"Embed({self.value!r})"


class ContentFormat(Content):
    kind = CONTENT_FORMAT
    countable = False
    __slots__ = ("key", "value")

    def __init__(self, key: str, value: PyAny):
        self.key = key
        self.value = value

    def length(self) -> int:
        return 1

    def encode(self, enc) -> None:
        enc.write_key(self.key)
        enc.write_json(self.value)

    def copy(self) -> "ContentFormat":
        return ContentFormat(self.key, self.value)

    def __repr__(self) -> str:
        return f"Format({self.key}={self.value!r})"


class ContentType(Content):
    """An embedded shared type; holds the `Branch` node (`ytpu_torch.core.branch`)."""

    kind = CONTENT_TYPE
    countable = True
    __slots__ = ("branch",)

    def __init__(self, branch):
        self.branch = branch

    def length(self) -> int:
        return 1

    def encode(self, enc) -> None:
        self.branch.encode_type_ref(enc)

    def values(self) -> List[PyAny]:
        return [self.branch]

    def copy(self) -> "ContentType":
        # Branch copy only makes sense for carriers that were never integrated.
        return ContentType(self.branch)

    def __repr__(self) -> str:
        return f"Type({self.branch.type_ref})"


class ContentAny(Content):
    kind = CONTENT_ANY
    countable = True
    __slots__ = ("items",)

    def __init__(self, items: List[PyAny]):
        self.items = items

    def length(self) -> int:
        return len(self.items)

    def splice(self, offset: int) -> "ContentAny":
        right = ContentAny(self.items[offset:])
        self.items = self.items[:offset]
        return right

    def merge(self, other: Content) -> bool:
        if isinstance(other, ContentAny):
            self.items.extend(other.items)
            return True
        return False

    def encode(self, enc) -> None:
        enc.write_len(len(self.items))
        for v in self.items:
            enc.write_any(v)

    def values(self) -> List[PyAny]:
        return list(self.items)

    def copy(self) -> "ContentAny":
        return ContentAny(list(self.items))

    def __repr__(self) -> str:
        return f"Any({self.items!r})"


class ContentDoc(Content):
    """A nested sub-document (reference: block.rs:1518, doc.rs:840-872)."""

    kind = CONTENT_DOC
    countable = True
    __slots__ = ("doc",)

    def __init__(self, doc):
        self.doc = doc

    def length(self) -> int:
        return 1

    def encode(self, enc) -> None:
        self.doc.options.encode(enc)

    def values(self) -> List[PyAny]:
        return [self.doc]

    def copy(self) -> "ContentDoc":
        return ContentDoc(self.doc)

    def __repr__(self) -> str:
        return f"Doc({self.doc.guid})"


class ContentMove(Content):
    """A move-range marker (reference: moving.rs:16)."""

    kind = CONTENT_MOVE
    countable = False
    __slots__ = ("move",)

    def __init__(self, move):
        self.move = move

    def length(self) -> int:
        return 1

    def encode(self, enc) -> None:
        self.move.encode(enc)

    def copy(self) -> "ContentMove":
        return ContentMove(self.move.copy())

    def __repr__(self) -> str:
        return f"Move({self.move})"


def decode_content(dec, info: int, decode_branch=None, decode_doc=None, decode_move=None) -> Content:
    """Decode an item's content given its info byte and a v1/v2 decoder.

    `decode_branch(dec)` / `decode_doc(dec)` / `decode_move(dec)` are injected
    to avoid circular imports with the branch/doc/move modules; left out,
    they are the update decoder's (a `Branch` from its TypeRef, a `Doc`
    from its options, a `Move`).
    Parity: block.rs:1786-1835 (note: the reference masks with 0b1111).
    """
    if decode_branch is None or decode_doc is None or decode_move is None:
        from ytpu_torch.core import update as _update

        decode_branch = decode_branch or _update._decode_branch
        decode_doc = decode_doc or _update._decode_doc
        decode_move = decode_move or _update.Move.decode
    ref = info & 0b1111
    if ref == CONTENT_DELETED:
        return ContentDeleted(dec.read_len())
    if ref == CONTENT_JSON:
        # Note: Yjs writes n then n JSON strings; yrs's decoder (block.rs:1790-1797)
        # reads n+1 which is asymmetric with its own encoder — we follow Yjs.
        n = dec.read_len()
        return ContentJSON([dec.read_string() for _ in range(n)])
    if ref == CONTENT_BINARY:
        return ContentBinary(dec.read_buf())
    if ref == CONTENT_STRING:
        return ContentString(dec.read_string())
    if ref == CONTENT_EMBED:
        return ContentEmbed(dec.read_json())
    if ref == CONTENT_FORMAT:
        key = dec.read_key()
        return ContentFormat(key, dec.read_json())
    if ref == CONTENT_TYPE:
        return ContentType(decode_branch(dec))
    if ref == CONTENT_ANY:
        n = dec.read_len()
        return ContentAny([dec.read_any() for _ in range(n)])
    if ref == CONTENT_DOC:
        return ContentDoc(decode_doc(dec))
    if ref == CONTENT_MOVE:
        return ContentMove(decode_move(dec))
    raise ValueError(f"unexpected content ref {ref}")
