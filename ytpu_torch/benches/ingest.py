"""Inputs and checks of the ingest phase of ``chip_smoke.py``: one
`BatchIngestor` at BASELINE config 2's width (1,024 doc slots x 8,192
slots) taking one `apply_bytes` call per step, its doc slots shared by
four tenant cohorts as a multi-tenant sync server sees them:

- docs 0-767, B4 text: doc d takes the B4 log's updates with a lag of
  (d mod 8) x `LAG_STEP` steps; one doc in eight (``(d // 8) mod 8 == 7``)
  gets each pair of consecutive updates swapped, so its second update
  goes pending and drains a step later (the host lane);
- docs 768-895, BASELINE config 4 (map "m" + XML fragment "x", two named
  roots, so a root anchor, and map keys through the key table);
- docs 896-959, BASELINE config 3 (256 clients editing one array);
- docs 960-1023, a text typed by a client with a 53-bit id (the
  big-client hash table).

The last three logs and their final values were written by ytpu's host
`Doc` and are committed in ``data/ingest_logs.json`` (regenerated by
``python tests/test_torch_ingest.py``). `xml_string` renders a named
root's XML elements from the columns, as ytpu's ``XmlElement.
get_string`` does, for the config 4 check.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from ytpu_torch.core.branch import TYPE_XML_ELEMENT
from ytpu_torch.core.content import BLOCK_ROOT_ANCHOR, CONTENT_TYPE

__all__ = [
    "COHORTS",
    "INGEST_DOCS",
    "INGEST_CAPACITY",
    "INGEST_STEPS",
    "LAG_GROUPS",
    "LAG_STEP",
    "b4_doc_lag",
    "b4_prefix",
    "b4_swapped",
    "load_ingest_logs",
    "root_map",
    "step_payloads",
    "xml_string",
]

INGEST_DOCS, INGEST_CAPACITY = 1024, 8192
# steps of the phase: the config 3 log (510 updates) is the longest of
# the committed logs; every B4 doc's prefix is even, so swapped pairs end
# whole
INGEST_STEPS = 512
LAG_GROUPS, LAG_STEP = 8, 32
# (name, first doc, docs)
COHORTS = (("b4", 0, 768), ("map_xml", 768, 128), ("array", 896, 64), ("big_client_text", 960, 64))

_LOGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "ingest_logs.json")


def load_ingest_logs() -> Dict[str, dict]:
    """``{name: {"log": [bytes], "expect": ...}}`` of the committed logs."""
    with open(_LOGS, encoding="utf-8") as f:
        data = json.load(f)
    for v in data.values():
        v["log"] = [bytes.fromhex(p) for p in v["log"]]
    return data


def b4_doc_lag(d: int) -> int:
    return (d % LAG_GROUPS) * LAG_STEP


def b4_swapped(d: int) -> bool:
    return (d // LAG_GROUPS) % LAG_GROUPS == LAG_GROUPS - 1


def b4_prefix(d: int) -> int:
    """How many B4 updates doc d has taken after the phase's steps."""
    return max(0, INGEST_STEPS - b4_doc_lag(d))


def step_payloads(t: int, b4_log: List[bytes], logs: Dict[str, dict]) -> List[Optional[bytes]]:
    """The 1,024 payloads of step `t` (None = no update for that doc)."""
    out: List[Optional[bytes]] = [None] * INGEST_DOCS
    for name, first, n in COHORTS:
        for d in range(first, first + n):
            if name == "b4":
                i = t - b4_doc_lag(d)
                if i >= 0:
                    out[d] = b4_log[i ^ 1 if b4_swapped(d) else i]
            else:
                log = logs[name]["log"]
                out[d] = log[t] if t < len(log) else None
    return out


def root_map(tree: dict, primary: str, name: str) -> dict:
    """The map component of root `name` in a `get_tree` result."""
    return tree["map"] if name == primary else tree["roots"][name]["map"]


def xml_string(state, doc: int, payloads, keys, root: str) -> str:
    """The XML string of named root `root` of one doc (an XmlFragment of
    XmlElements), rendered from the columns as ytpu's
    ``XmlElement.get_string``: ``<tag a="v">children</tag>``, attributes
    sorted by name. Raises on other child types."""
    from ytpu_torch.models.batch_doc import BlockCols, _visible_walk

    bl = BlockCols(*(np.asarray(a[doc].cpu()) for a in state.blocks))
    n = int(state.n_blocks[doc])
    anchor = [i for i in range(n) if int(bl.kind[i]) == BLOCK_ROOT_ANCHOR
              and keys.names.get(int(bl.key[i])) == root]
    head = int(bl.head[anchor[0]]) if anchor else int(state.start[doc])

    def attrs(row: int) -> dict:
        out = {}
        for i in range(n):
            if (int(bl.key[i]) >= 0 and int(bl.parent[i]) == row and int(bl.right[i]) == -1
                    and not bl.deleted[i]):
                vals = payloads.slice_values(int(bl.content_ref[i]), int(bl.content_off[i]),
                                             int(bl.length[i]))
                out[keys.names[int(bl.key[i])]] = vals[-1]
        return out

    def render(first: int) -> str:
        out = []
        for i in _visible_walk(bl, n, first):
            if bl.deleted[i] or not bl.countable[i] or int(bl.key[i]) >= 0:
                continue
            branch = payloads.type_branch(int(bl.content_ref[i])) if int(bl.kind[i]) == CONTENT_TYPE else None
            if branch is None or branch.type_ref != TYPE_XML_ELEMENT:
                raise ValueError(f"row {i} of doc {doc} is not an XmlElement")
            tag = branch.type_name or "UNDEFINED"
            a = "".join(f' {k}="{v}"' for k, v in sorted(attrs(i).items()))
            out.append(f"<{tag}{a}>{render(int(bl.head[i]))}</{tag}>")
        return "".join(out)

    return render(head)
