"""Seeded update streams and states for holding the integrate kernel
against its plain version (`chip_smoke.py`, the CPU tests): packed
``[S, U, 23]`` rows and ``[S, R, 4]`` delete ranges as numpy int32.

`synthetic_stream` mixes every row kind the kernel handles; `typing_stream`
is several clients typing and deleting at random positions of one text,
the traffic the kernel's cursor cache and block index are built for;
`batch_edge_steps` gives the per-doc entry docs of very different sizes
and the steps that make the most slots; `ingest_steps` gives the per-doc
entry the rows a `BatchIngestor` emits from wire bytes (root anchors,
map key chains through the key table, interned 53-bit clients).
"""

from __future__ import annotations

import numpy as np

__all__ = ["anchored_state", "batch_edge_steps", "ingest_steps", "synthetic_stream", "typing_stream"]

# synthetic_stream: rows and delete ranges per step, and a same-origin
# storm every STORM_EVERY steps
SYN_U, SYN_R, STORM_EVERY = 4, 2, 5
# typing_stream: clients typing, the chance that the last one keeps the
# keyboard, the chance that a step also deletes
N_CLIENTS, RUN_P, DEL_P = 8, 0.8, 0.5


def synthetic_stream(seed: int, steps: int):
    """A seeded ``[S, 4, 23]`` row / ``[S, 2, 4]`` delete stream over six
    clients (one above the rank table, one above the client-clock table):
    string, deleted, GC, format, nested-type and move rows, map rows on
    three keys, root-anchor parents, gaps and duplicates, and every fifth
    step a same-origin storm of four concurrent inserts."""
    U, R, storm_every = SYN_U, SYN_R, STORM_EVERY
    rng = np.random.default_rng(seed)
    clients = [1, 2, 3, 7, 300, 5000]
    nxt = {c: 0 for c in clients}
    ids = []  # (client, clock, len, kind)
    types = []
    rows = np.zeros((steps, U, 23), dtype=np.int32)
    dels = np.zeros((steps, R, 4), dtype=np.int32)
    ref = 0

    def some_id():
        c, k, n, _ = ids[int(rng.integers(len(ids)))]
        return c, k + int(rng.integers(n))

    for s in range(steps):
        storm = s % storm_every == storm_every - 1 and ids
        storm_origin = some_id() if storm else None
        for u in range(U):
            r = rows[s, u]
            c = clients[u % len(clients)] if storm else clients[int(rng.integers(len(clients)))]
            kind = int(rng.choice([4, 4, 4, 4, 1, 0, 6, 7, 11]))
            length = 1 if kind in (6, 7, 11) else int(rng.integers(1, 4))
            clock = nxt[c]
            roll = rng.random()
            if roll < 0.05:
                clock += 1  # gap: missing dependency
            elif roll < 0.10 and clock > 0:
                clock = max(0, clock - 1)  # partial duplicate
            oc = ok = -1
            rc, rk = -1, 0
            if storm:
                oc, ok = storm_origin
            elif ids and rng.random() < 0.75:
                oc, ok = some_id()
            if not storm and ids and rng.random() < 0.4:
                rc, rk = some_id()
            key, ptag, pc, pk, proot = -1, 0, -1, 0, -1
            if oc < 0 and rc < 0:
                ptag = int(rng.choice([1, 1, 2])) if types else 1
                if ptag == 2:
                    pc, pk = types[int(rng.integers(len(types)))]
                elif rng.random() < 0.2:
                    proot = int(rng.choice([7, 9]))  # anchor 7 exists, 9 does not
                if rng.random() < 0.3:
                    key = int(rng.integers(3))
            mv = (-1, 0, 0, -1, 0, 0, -1)
            if kind == 11 and ids:
                sc, sk = some_id()
                if rng.random() < 0.4:
                    ec, ek = sc, sk  # collapsed
                else:
                    ec, ek = some_id()
                mv = (sc, sk, int(rng.choice([0, -1])), ec, ek, int(rng.choice([0, -1])),
                      int(rng.integers(3)))
            valid = 0 if rng.random() < 0.05 else 1
            r[:] = [c, clock, length, oc, max(ok, 0), rc, rk, kind, ref, 0, key, ptag,
                    pc, pk, valid, *mv, proot]
            ref += length
            if valid:
                ids.append((c, clock, length, kind))
                nxt[c] = max(nxt[c], clock + length)
                if kind == 7:
                    types.append((c, clock))
        for q in range(R):
            if ids and rng.random() < 0.6:
                c, k, n, _ = ids[int(rng.integers(len(ids)))]
                a = k + int(rng.integers(n))
                b = a + int(rng.integers(1, 4))
                dels[s, q] = [c, a, b, 1]
    return rows, dels


def anchored_state(n_docs: int, capacity: int, device):
    """Empty packed state with a root-anchor row for key 7 in every doc."""
    from ytpu_torch.models.batch_doc import init_state
    from ytpu_torch.ops.integrate_kernel import CL, KD, KEY, LN, M_NBLOCKS, pack_state

    cols, meta = pack_state(init_state(n_docs, capacity, device))
    cols[KD, :, 0] = 12
    cols[KEY, :, 0] = 7
    cols[CL, :, 0] = -1
    cols[LN, :, 0] = 0
    meta[:, M_NBLOCKS] = 1
    return cols, meta


def typing_stream(seed: int, steps: int, first_client: int = 1):
    """A seeded ``[S, 1, 23]`` row / ``[S, 1, 4]`` delete stream: the eight
    clients ``first_client .. first_client + 7`` type runs of one to three
    characters into one root text, mostly right after their own last
    character (a client keeps the keyboard with probability RUN_P),
    otherwise at a random position, and with probability DEL_P a step also
    deletes a random range of one to three clocks of the client of a
    random character. Each insert names its left and right neighbours as
    origins, as a sequential editor does, so the doc order is known; the
    deletes split blocks anywhere."""
    rng = np.random.default_rng(seed)
    clients = list(range(first_client, first_client + N_CLIENTS))
    nxt = {c: 0 for c in clients}
    cursor = {}  # client -> doc index of its last typed character
    doc = []  # (client, clock) of every character, in doc order
    rows = np.zeros((steps, 1, 23), dtype=np.int32)
    dels = np.zeros((steps, 1, 4), dtype=np.int32)
    c = clients[0]
    ref = 0
    for s in range(steps):
        if rng.random() >= RUN_P:
            c = clients[int(rng.integers(N_CLIENTS))]
        if c in cursor and rng.random() < 0.7:
            pos = cursor[c] + 1
        else:
            pos = int(rng.integers(len(doc) + 1))
        n = int(rng.integers(1, 4))
        oc, ok = doc[pos - 1] if pos > 0 else (-1, 0)
        rc, rk = doc[pos] if pos < len(doc) else (-1, 0)
        ptag = 1 if oc < 0 and rc < 0 else 0
        clock = nxt[c]
        rows[s, 0] = [c, clock, n, oc, ok, rc, rk, 4, ref, 0, -1, ptag, -1, 0, 1,
                      -1, 0, 0, -1, 0, 0, -1, -1]
        doc[pos:pos] = [(c, clock + i) for i in range(n)]
        for other, at in cursor.items():
            if at >= pos:
                cursor[other] = at + n
        cursor[c] = pos + n - 1
        nxt[c] += n
        ref += n
        if rng.random() < DEL_P:
            dc, dk = doc[int(rng.integers(len(doc)))]
            dels[s, 0] = [dc, dk, dk + int(rng.integers(1, 4)), 1]
    return rows, dels


# batch_edge_steps: docs, slots, rows and delete ranges a doc and step
EDGE_DOCS, EDGE_CAPACITY, EDGE_U, EDGE_R = 4, 64, 4, 2


def _row(c, k, n, oc=-1, ok=0, rc=-1, rk=0, kind=4, key=-1, mv=(-1, 0, 0, -1, 0, 0, -1)):
    """One row of the packed stream: root-parented when it has no origin."""
    ptag = 1 if oc < 0 and rc < 0 else 0
    return [c, k, n, oc, ok, rc, rk, kind, 0, 0, key, ptag, -1, 0, 1, *mv, -1]


def batch_edge_steps(steps: int = 24):
    """Per-doc steps for `integrate_batch` on ``EDGE_DOCS`` empty docs of
    ``EDGE_CAPACITY`` slots, ``EDGE_U`` rows and ``EDGE_R`` delete ranges a
    doc and step: ``(rows [S, D, U, 23], dels [S, D, R, 4])``. Doc 0 is
    empty until step 2 puts a row behind a same-origin conflict of rows of
    that launch (its conflict scan reads the stamp of the launch's first
    new slot), then types slowly; doc 1 types fast and runs into its capacity, so
    its launches pass through the slot counts within a launch's bound of C;
    doc 2's rows split both origins, its delete ranges split both ends, and
    one step puts a row behind a same-origin conflict of rows of the same
    launch; doc 3 holds map rows and move rows whose pointers split blocks,
    with moves live when later launches start."""
    rows = np.zeros((steps, EDGE_DOCS, EDGE_U, 23), dtype=np.int32)
    dels = np.zeros((steps, EDGE_DOCS, EDGE_R, 4), dtype=np.int32)
    slow, _ = typing_stream(61, steps)
    fast, fast_dels = typing_stream(62, steps * EDGE_U, first_client=20)
    for t in range(steps):
        if t % 3 == 0 and t > 2:
            rows[t, 0, 0] = slow[t // 3 - 1, 0]
        rows[t, 1] = fast[t * EDGE_U : (t + 1) * EDGE_U, 0]
        dels[t, 1, :] = fast_dels[t * EDGE_U : t * EDGE_U + EDGE_R, 0]
    # doc 0, still empty: two rows on the same new origin, then a row behind
    # the second, whose conflict scan reads the stamp of the first new slot
    rows[2, 0] = [_row(9, 0, 1), _row(9, 1, 1, oc=9, ok=0), _row(10, 0, 1, oc=9, ok=0),
                  _row(11, 0, 1, oc=10, ok=0)]
    doc2 = {
        0: [_row(1, 0, 6)],
        1: [_row(2, 0, 6, oc=1, ok=5)],
        # origin inside client 1's block, right origin inside client 2's
        2: [_row(3, 0, 2, oc=1, ok=2, rc=2, rk=3), _row(3, 2, 1, oc=3, ok=1)],
        4: [_row(4, 0, 3, oc=2, ok=1, rc=1, rk=1)],
        # two rows on the same new origin, then a row behind the second
        6: [_row(9, 0, 1, oc=1, ok=0), _row(9, 1, 1, oc=9, ok=0), _row(10, 0, 1, oc=9, ok=0),
            _row(11, 0, 1, oc=10, ok=0)],
        8: [_row(12, 0, 1, oc=4, ok=0), _row(12, 1, 1, oc=12, ok=0), _row(5, 0, 1, oc=12, ok=0),
            _row(13, 0, 1, oc=5, ok=0)],
    }
    doc2_dels = {3: [(2, 4, 5), (1, 4, 6)], 5: [(1, 1, 2)], 7: [(9, 0, 2)]}
    doc3 = {
        0: [_row(5, 0, 8)],
        # a move of [(5, 2), (5, 5)]: the recompute splits at both pointers
        1: [_row(6, 0, 1, oc=5, ok=7, kind=11, mv=(5, 2, 0, 5, 5, -1, 0))],
        2: [_row(7, 0, 1, key=0), _row(7, 1, 1, key=1)],
        3: [_row(7, 2, 1, oc=7, ok=0, key=0)],
        4: [_row(8, 0, 1, oc=5, ok=3, kind=11, mv=(5, 3, 0, 5, 4, 0, 1))],
        # an insert inside the moved range, with both moves live
        5: [_row(5, 8, 2, oc=5, ok=3, rc=5, rk=4)],
        7: [_row(8, 1, 1, oc=8, ok=0, kind=11, mv=(5, 0, 0, 5, 1, -1, 2))],
    }
    doc3_dels = {6: [(6, 0, 1)], 9: [(7, 1, 2)]}
    for doc, by_step, del_step in ((2, doc2, doc2_dels), (3, doc3, doc3_dels)):
        for t, rr in by_step.items():
            rows[t, doc, : len(rr)] = rr
        for t, dd in del_step.items():
            for q, (c, a, b) in enumerate(dd):
                dels[t, doc, q] = [c, a, b, 1]
    return rows, dels


# ingest_steps: docs, slots, the committed log each doc takes, and the
# root each doc anchors before its first update
INGEST_EMU_DOCS, INGEST_EMU_CAPACITY = 4, 256
INGEST_EMU_LOGS = ("map_xml", "big_client_text", "array", "map_xml")


def ingest_steps(steps: int = 40, device="cpu"):
    """The per-doc entry's inputs of `steps` `apply_bytes` calls of a
    `BatchIngestor` (the plain version, on `device`) over the first
    updates of the committed ingest logs (``data/ingest_logs.json``): doc
    0 the map + XML tenant (its second root anchored by the ingestor, its
    map rows on key chains from the key table), doc 1 the text of a 53-bit
    client (interned through the big-client hash table), doc 2 the
    256-client array, doc 3 the map + XML tenant again in a doc that holds
    an anchor of another root before it starts, so that its anchor lookup
    has two anchors to choose from. Returns a list of ``(cols, meta, rows,
    dels, rank)``: the packed state before each apply and what the apply
    gave the kernel."""
    from ytpu_torch.benches.ingest import load_ingest_logs
    from ytpu_torch.models import batch_doc as bd
    from ytpu_torch.models import ingest
    from ytpu_torch.ops import integrate_kernel as ik

    logs = load_ingest_logs()
    ing = ingest.BatchIngestor(INGEST_EMU_DOCS, INGEST_EMU_CAPACITY, device=device)
    other = ing.enc.keys.intern("another root")
    ing.state = bd.ensure_root_anchor(ing.state, 3, other)
    captured = []

    def capture(state, batch, rank):
        cols, meta = ik.pack_state(state)
        rows, dels = ik.pack_stream(batch)
        captured.append((cols, meta, rows, dels, rank.clone()))
        return real(state, batch, rank)

    real = ingest.apply_update_batch
    ingest.apply_update_batch = capture
    try:
        for t in range(steps):
            ing.apply_bytes([logs[name]["log"][t] for name in INGEST_EMU_LOGS])
    finally:
        ingest.apply_update_batch = real
    if ing.slow_docs or int(ing.state.error.max()):
        raise RuntimeError("ingest_steps: a doc left the fast lane or set its error")
    return captured
