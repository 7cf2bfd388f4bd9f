"""Content/block kind numbers the device code reads.

A copy of the wire ref-numbers of `ytpu.core.content` (block.rs:28-61):
the low four bits of an item's info byte, plus the device engine's
root-anchor sentinel. The port keeps its own copy so it never imports
the JAX package.
"""

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
