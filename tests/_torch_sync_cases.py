"""Shared inputs of the sync-step tests (tests/test_torch_apply_batch.py,
tests/test_torch_encode_diff.py): per-doc update logs made with ytpu's host
`Doc`, the same `UpdateBatch` steps for both packages from ytpu's
`BatchEncoder`, and conversions of states and tables between the packages
(through numpy, so both sides get identical int32 inputs)."""

import random
import string

import jax.numpy as jnp
import numpy as np
import torch

from ytpu.core import Doc, Update
from ytpu.models import batch_doc as jbd
from ytpu.types.shared import ArrayPrelim, MapPrelim, TextPrelim

from ytpu_torch.models import batch_doc as tbd

# the per-doc batch shape of every apply in these tests: 4 docs of 256
# slots, 8 rows and 4 delete ranges per doc and step
N_DOCS, CAPACITY, ROWS, DELS = 4, 256, 8, 4


def capture(doc):
    log = []
    doc.observe_update_v1(lambda p, o, t: log.append(p))
    return log


def text_two_clients(seed: int = 3):
    """Two clients typing into one text and deleting, each update sent to
    the other as it is made (concurrent inserts at one spot now and then)."""
    rng = random.Random(seed)
    a, b = Doc(client_id=11), Doc(client_id=7)
    log = []
    for d in (a, b):
        d.observe_update_v1(lambda p, o, t: log.append(p) if o is None else None)
    for i in range(14):
        src, dst = (a, b) if rng.random() < 0.5 else (b, a)
        t = src.get_text("text")
        with src.transact() as txn:
            n = len(t)
            if n > 6 and rng.random() < 0.3:
                pos = rng.randint(0, n - 3)
                t.remove_range(txn, pos, 2)
            else:
                word = "".join(rng.choice(string.ascii_lowercase) for _ in range(rng.randint(1, 4)))
                t.insert(txn, rng.randint(0, n), word)
        if rng.random() < 0.7:
            dst.apply_update_v1(src.encode_state_as_update_v1(dst.state_vector()))
    return log


def map_edits():
    """Sets, overwrites and removes on a root map, two clients."""
    a, b = Doc(client_id=21), Doc(client_id=22)
    log = []
    for d in (a, b):
        d.observe_update_v1(lambda p, o, t: log.append(p) if o is None else None)
    for i in range(10):
        d = a if i % 3 else b
        m = d.get_map("text")
        with d.transact() as txn:
            if i % 4 == 3:
                m.remove(txn, f"k{i % 3}")
            else:
                m.insert(txn, f"k{i % 3}", i * 7 if i % 2 else f"v{i}")
    return log


def nested_edits():
    """A root array holding a nested text, map and array, edited after
    creation through branch-id parents."""
    doc = Doc(client_id=31)
    log = capture(doc)
    arr = doc.get_array("text")
    with doc.transact() as txn:
        arr.insert_range(txn, 0, [1, "s"])
        arr.insert(txn, 2, TextPrelim("ab"))
        arr.insert(txn, 3, MapPrelim({"x": 5}))
    with doc.transact() as txn:
        arr.get(2).insert(txn, 2, "-tail")
    with doc.transact() as txn:
        arr.get(3).insert(txn, "y", 6)
    with doc.transact() as txn:
        arr.insert(txn, 4, ArrayPrelim([2, 3]))
    with doc.transact() as txn:
        arr.get(2).remove_range(txn, 0, 1)
    with doc.transact() as txn:
        arr.remove_range(txn, 0, 1)
    return log


def move_edits():
    """An array with moves, removals and inserts."""
    doc = Doc(client_id=41)
    log = capture(doc)
    arr = doc.get_array("text")
    with doc.transact() as txn:
        for i in range(5):
            arr.insert(txn, i, f"e{i}")
    for i in range(9):
        with doc.transact() as txn:
            arr.move_to(txn, i % 4, (i * 3 + 2) % 5)
        if i % 3 == 2:
            with doc.transact() as txn:
                arr.remove_range(txn, i % 4, 1)
            with doc.transact() as txn:
                arr.insert(txn, 0, f"n{i}")
    return log


def doc_logs():
    """One log per doc slot: text, map, nested branches, moves."""
    return [text_two_clients(), map_edits(), nested_edits(), move_edits()]


def batch_steps(logs, rows: int = ROWS, dels: int = DELS):
    """ytpu `UpdateBatch` steps (step t holds update t of every doc that
    has one) and the encoder that interned them."""
    enc = jbd.BatchEncoder(root_name="text")
    steps = []
    for t in range(max(len(lg) for lg in logs)):
        ups = [Update.decode_v1(lg[t]) if t < len(lg) else None for lg in logs]
        steps.append(enc.build_batch(ups, n_rows=rows, n_dels=dels))
    return steps, enc


def to_port_batch(batch) -> tbd.UpdateBatch:
    return tbd.UpdateBatch(*(torch.from_numpy(np.array(a)) for a in batch))


def to_port_state(state) -> tbd.DocStateBatch:
    blocks = tbd.BlockCols(*(torch.from_numpy(np.array(a)) for a in state.blocks))
    return tbd.DocStateBatch(
        blocks, *(torch.from_numpy(np.array(a)) for a in (state.start, state.n_blocks, state.error))
    )


def to_jax_state(state) -> jbd.DocStateBatch:
    blocks = jbd.BlockCols(*(jnp.asarray(a.numpy()) for a in state.blocks))
    return jbd.DocStateBatch(
        blocks, *(jnp.asarray(a.numpy()) for a in (state.start, state.n_blocks, state.error))
    )


def field_diffs(port_state, jax_state):
    """Names of the `DocStateBatch` fields that differ (empty: equal)."""
    bad = [n for n in tbd.BlockCols._fields
           if not np.array_equal(getattr(port_state.blocks, n).numpy(), np.array(getattr(jax_state.blocks, n)))]
    return bad + [n for n in ("start", "n_blocks", "error")
                  if not np.array_equal(getattr(port_state, n).numpy(), np.array(getattr(jax_state, n)))]


def port_tables(enc, root_name=None) -> tbd.EncoderTables:
    """The port's finisher tables holding the same interned clients, keys
    and payload items as ytpu's encoder; the root name is the encoder's
    unless `root_name` is given."""
    tables = tbd.EncoderTables(root_name=enc.root_name if root_name is None else root_name)
    for c in enc.interner.from_idx:
        tables.interner.intern(c)
    for k in range(len(enc.keys)):
        tables.keys.intern(enc.keys.names[k])
    tables.payloads.items = list(enc.payloads.items)
    return tables
