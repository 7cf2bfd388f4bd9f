"""Item content: the kind numbers the device code reads, and the content
classes a host-decoded update carries (copy of `ytpu.core.content`;
parity target: yrs block.rs:1507-1928, wire ref-numbers at :28-61).

Each content kind knows its CRDT length (UTF-16 code units for strings,
element count for sequences: what advances the Lamport clock), whether
it is countable, its user-facing values, its v1 wire encoding, and for
the kinds that can be longer than one unit a copy and a split at a clock
offset (`splice`), which the doc-less update merge needs. Squashing neighbours is
the host CRDT's and is not ported. `ContentDoc` keeps the
sub-document's guid and options as plain values.
"""

from __future__ import annotations

import json
from typing import Any as PyAny
from typing import List, Tuple

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
# anchoring a non-primary named root branch. Anchor rows have client == -1
# and length 0 (no wire identity, never ship).
BLOCK_ROOT_ANCHOR = 12


def utf16_len(s: str) -> int:
    """Length of `s` in UTF-16 code units (the Yjs clock unit for text)."""
    return len(s) + sum(1 for ch in s if ord(ch) > 0xFFFF)


def split_str_utf16(s: str, offset: int) -> Tuple[str, str]:
    """Split at a UTF-16 code-unit offset. An offset inside a surrogate
    pair gives each half a U+FFFD for its severed half, so the halves'
    UTF-16 lengths stay those of the clock split (block.rs:1852-1860)."""
    if offset <= 0:
        return "", s
    units = 0
    for i, ch in enumerate(s):
        if units == offset:
            return s[:i], s[i:]
        width = 2 if ord(ch) > 0xFFFF else 1
        if units + width > offset:
            return s[:i] + "\ufffd", "\ufffd" + s[i + 1 :]
        units += width
    return s, ""


class Content:
    """Base class for item content."""

    kind: int = -1
    countable: bool = False

    def length(self) -> int:
        return 1

    def values(self) -> List[PyAny]:
        """User-facing element values (for countable sequence content)."""
        return []

    def splice(self, offset: int) -> "Content":
        """Split in place at `offset` (clock units); returns the right part."""
        raise NotImplementedError(f"{type(self).__name__} is not splittable")

    def copy(self) -> "Content":
        raise NotImplementedError


class ContentDeleted(Content):
    kind = CONTENT_DELETED
    __slots__ = ("len",)

    def __init__(self, length: int):
        self.len = length

    def length(self) -> int:
        return self.len

    def encode(self, enc) -> None:
        enc.write_len(self.len)

    def splice(self, offset: int) -> "ContentDeleted":
        right = ContentDeleted(self.len - offset)
        self.len = offset
        return right

    def copy(self) -> "ContentDeleted":
        return ContentDeleted(self.len)


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

    def copy(self) -> "ContentJSON":
        return ContentJSON(list(self.raw))

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


class ContentBinary(Content):
    kind = CONTENT_BINARY
    countable = True
    __slots__ = ("data",)

    def __init__(self, data: bytes):
        self.data = data

    def encode(self, enc) -> None:
        enc.write_buf(self.data)

    def values(self) -> List[PyAny]:
        return [self.data]


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

    def copy(self) -> "ContentString":
        return ContentString(self.text)

    def encode(self, enc) -> None:
        enc.write_string(self.text)

    def values(self) -> List[PyAny]:
        return list(self.text)


class ContentEmbed(Content):
    kind = CONTENT_EMBED
    countable = True
    __slots__ = ("value",)

    def __init__(self, value: PyAny):
        self.value = value

    def encode(self, enc) -> None:
        enc.write_json(self.value)

    def values(self) -> List[PyAny]:
        return [self.value]


class ContentFormat(Content):
    kind = CONTENT_FORMAT
    __slots__ = ("key", "value")

    def __init__(self, key: str, value: PyAny):
        self.key = key
        self.value = value

    def encode(self, enc) -> None:
        enc.write_key(self.key)
        enc.write_json(self.value)


class ContentType(Content):
    """An embedded shared type: its `ytpu_torch.core.branch.Branch` (the
    TypeRef tag, an XML name, a WeakRef's quoted range)."""

    kind = CONTENT_TYPE
    countable = True
    __slots__ = ("branch",)

    def __init__(self, branch):
        self.branch = branch

    def encode(self, enc) -> None:
        self.branch.encode_type_ref(enc)

    def values(self) -> List[PyAny]:
        return [self.branch]


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

    def copy(self) -> "ContentAny":
        return ContentAny(list(self.items))

    def encode(self, enc) -> None:
        enc.write_len(len(self.items))
        for v in self.items:
            enc.write_any(v)

    def values(self) -> List[PyAny]:
        return list(self.items)


class ContentDoc(Content):
    """A nested sub-document, kept as its wire values: the guid and the
    options map (doc.rs:814-845)."""

    kind = CONTENT_DOC
    countable = True
    __slots__ = ("guid", "options")

    def __init__(self, guid: str, options: PyAny):
        self.guid = guid
        self.options = options

    def encode(self, enc) -> None:
        """The options as the JAX package's `Options` reads and writes them
        back: the known keys, defaults where absent, ``encoding`` with the
        BigInt tag."""
        from ytpu_torch.encoding.lib0 import BigInt

        m = self.options if isinstance(self.options, dict) else {}
        auto_load = m["autoLoad"] if isinstance(m.get("autoLoad"), bool) else False
        out = {"gc": m["gc"] if isinstance(m.get("gc"), bool) else True}
        if isinstance(m.get("collectionId"), str):
            out["collectionId"] = m["collectionId"]
        out["encoding"] = BigInt(1 if m.get("encoding") == 1 else 0)
        out["autoLoad"] = auto_load
        out["shouldLoad"] = auto_load
        enc.write_string(self.guid)
        enc.write_any(out)

    def values(self) -> List[PyAny]:
        return [self.guid]


class ContentMove(Content):
    """A move-range marker (`ytpu_torch.core.moving.Move`)."""

    kind = CONTENT_MOVE
    __slots__ = ("move",)

    def __init__(self, move):
        self.move = move

    def encode(self, enc) -> None:
        self.move.encode(enc)


def decode_content(dec, info: int) -> Content:
    """Decode an item's content given its info byte and a v1 decoder
    (block.rs:1786-1835; the ref is the info byte's low four bits)."""
    from ytpu_torch.core.branch import Branch
    from ytpu_torch.core.moving import Move

    ref = info & 0b1111
    if ref == CONTENT_DELETED:
        return ContentDeleted(dec.read_len())
    if ref == CONTENT_JSON:
        # Yjs writes n then n JSON strings (yrs's decoder reads n + 1; the
        # JAX package follows Yjs)
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
        return ContentType(Branch.decode_type_ref(dec))
    if ref == CONTENT_ANY:
        n = dec.read_len()
        return ContentAny([dec.read_any() for _ in range(n)])
    if ref == CONTENT_DOC:
        guid = dec.read_string()
        return ContentDoc(guid, dec.read_any())
    if ref == CONTENT_MOVE:
        return ContentMove(Move.decode(dec))
    raise ValueError(f"unexpected content ref {ref}")
