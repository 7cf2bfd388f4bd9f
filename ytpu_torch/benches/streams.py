"""Seeded update streams and states for holding the integrate kernel
against its plain version (`chip_smoke.py`, the CPU tests): packed
``[S, U, 23]`` rows and ``[S, R, 4]`` delete ranges as numpy int32.

`synthetic_stream` mixes every row kind the kernel handles; `typing_stream`
is several clients typing and deleting at random positions of one text,
the traffic the kernel's cursor cache and block index are built for.
"""

from __future__ import annotations

import numpy as np

__all__ = ["anchored_state", "synthetic_stream", "typing_stream"]

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
