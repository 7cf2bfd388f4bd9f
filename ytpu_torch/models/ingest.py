"""Batched ingestion with exact pending-update semantics (PyTorch port of
`ytpu.models.ingest.BatchIngestor`).

The reference stashes an update whose dependencies are unmet and retries
it when the missing clocks arrive (transaction.rs:675-727, update.rs:
289-299; pending delete sets store.rs:42-50). `BatchIngestor` keeps that
contract for a batch of doc slots on the device:

- per doc slot, a host `StateVector` mirror tracks exactly what the device
  holds (rows are planned on the host, so the mirror is exact);
- each update is partitioned against the mirror
  (`BatchEncoder.partition_carriers`): the applicable prefix ships in this
  step's batch, the rest is stashed per doc, and delete ranges beyond the
  mirror go to a per-doc pending delete set;
- every later step merges the stash with new arrivals, so blocks integrate
  the moment their dependencies land; other doc slots are never stalled,
  and the device never sees a row with a missing dependency.

`apply_bytes` adds the fast lane: a doc whose update is in order and
holds only content the device decodes ships its wire bytes to the device,
where `decode_updates_v1` turns them into rows through the ingestor's
intern tables (clients, big-client hashes, map keys, named roots). The
column walk that proves a doc eligible always runs: one call of the
port's host C++ walk over the step's payloads
(`ytpu_torch.native.decode_update_columns_batch`). Both lanes merge into
one `apply_update_batch` step: the per-doc entry of the CUDA integrate
kernel on the GPU, its plain version on the CPU. Host planning runs in
the profiler span ``ytpu_torch.ingest.plan``, split into
``ytpu_torch.ingest.plan.walk`` (the native walk),
``ytpu_torch.ingest.plan.intern`` (the eligibility checks and the
per-block interning of fast docs) and ``ytpu_torch.ingest.plan.host_lane``
(`Update.decode_v1`, `_plan_doc` and `batch_from_rows` of the host lane);
the fast lane's upload and decode run in ``ytpu_torch.ingest.decode``.

V2 payloads take the host lane (`apply(payloads, v2=True)`, a host
`Update.decode_v2`), as in the JAX package. Left out: doc-axis sharding
(multi-device, ROADMAP A.12).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ytpu_torch.core.content import CONTENT_MOVE, CONTENT_TYPE, BLOCK_SKIP
from ytpu_torch.core.device import resolve_device
from ytpu_torch.core.id_set import DeleteSet
from ytpu_torch.core.state_vector import StateVector
from ytpu_torch.core.update import Update
from ytpu_torch.encoding.lib0 import PARENT_ID, PARENT_NAME, Cursor, EncodingError
from ytpu_torch.models.batch_doc import (
    BatchEncoder,
    DocStateBatch,
    UpdateBatch,
    apply_update_batch,
    ensure_root_anchor,
    init_state,
    state_capacity_ledger,
)
from ytpu_torch.native import decode_update_columns_batch
from ytpu_torch.ops.decode_kernel import (
    FLAG_ERRORS,
    KEY_HASH_BYTES,
    ChunkedWirePayloads,
    client_hash_host,
    decode_updates_v1,
    key_hash_host,
    pack_updates,
    steps_for_columns,
)

__all__ = ["BatchIngestor"]

# content kinds the device decoder handles: GC, Deleted, Json, Binary,
# String, Embed, Format, Type (non-weak), Any (scalar), Skip, Move
_FAST_KINDS = frozenset((0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 11))
# kinds whose rows keep content refs into the retained wire bytes
_WIRE_REF_KINDS = frozenset((2, 3, 4, 5, 6, 7, 8))
_I32_MAX = 2**31 - 1


def _bucket(n: int, lo: int = 4) -> int:
    """Round a per-step dimension up to a power of two (floor `lo`), so the
    set of shapes a stream of steps launches with stays small."""
    b = lo
    while b < n:
        b *= 2
    return b


def _sorted_table(mapping: Dict[int, int], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sorted keys, value perm)`` as int32 tensors: the shape of every
    device lookup table (clients, key hashes, client hashes)."""
    ks = sorted(mapping)
    return (
        torch.tensor(ks, dtype=torch.int32, device=device),
        torch.tensor([mapping[k] for k in ks], dtype=torch.int32, device=device),
    )


class BatchIngestor:
    """`n_docs` doc slots of `capacity` block slots each, on `device` (the
    GPU unless it says otherwise). ``ingest="raw"`` ships the fast lane's
    wire bytes as one flat arena plus offsets, which the decode reads in
    place (`decode_updates_v1` with ``offs``); ``"packed"`` ships the
    host-padded matrix (`pack_updates`). The two feed the decoder the same
    lanes."""

    def __init__(
        self,
        n_docs: int,
        capacity: int,
        enc: Optional[BatchEncoder] = None,
        ingest: str = "raw",
        device=None,
    ):
        if ingest not in ("raw", "packed"):
            raise ValueError(f"ingest must be 'raw' or 'packed', got {ingest!r}")
        self.device = resolve_device(device)
        self.enc = enc or BatchEncoder()
        self.n_docs = n_docs
        self.ingest = ingest
        self.state: DocStateBatch = init_state(n_docs, capacity, self.device)
        self.svs: List[StateVector] = [StateVector() for _ in range(n_docs)]
        # per-doc stash: carriers waiting for dependencies + deferred deletes
        self._pending: List[Dict[int, list]] = [{} for _ in range(n_docs)]
        self._pending_ds: List[DeleteSet] = [DeleteSet() for _ in range(n_docs)]
        # PayloadStore refs (>= 0) for host-planned rows, retained wire
        # chunks (<= -2) for device-decoded rows
        self.payloads = ChunkedWirePayloads(self.enc.payloads)
        self.fast_docs = 0
        self.slow_docs = 0
        self.fast_recoveries = 0  # flagged fast lanes replayed through the host lane
        # fast-lane bytes copied to the device (the wire arena or padded
        # matrix, offsets and lengths), summed over steps
        self.wire_bytes = 0
        # map keys on the fast lane: device hash -> key idx; keys whose hash
        # collides with another key's take the host lane
        self._key_hashes: Dict[int, int] = {}
        self._key_collisions: set = set()
        # ids beyond i32: varint-byte hash -> interned idx; colliding ids
        # take the host lane
        self._client_hashes: Dict[int, int] = {}
        self._client_id_collisions: set = set()
        # multi-root docs (doc.rs:156-228): the first named root seen per
        # doc maps onto the implicit device branch; the others anchor
        # through BLOCK_ROOT_ANCHOR rows created before the apply
        self.primary_roots: Dict[int, str] = {}
        self._anchored_roots: List[set] = [set() for _ in range(n_docs)]

    def reset_slot(self, doc: int) -> None:
        """Return a doc slot to its empty state (start -1, no blocks, no
        error, empty mirror and stashes). The block columns stay: n_blocks
        masks them."""
        st = self.state
        start, n_blocks, error = st.start.clone(), st.n_blocks.clone(), st.error.clone()
        start[doc], n_blocks[doc], error[doc] = -1, 0, 0
        self.state = st._replace(start=start, n_blocks=n_blocks, error=error)
        self.svs[doc] = StateVector()
        self._pending[doc] = {}
        self._pending_ds[doc] = DeleteSet()
        self.primary_roots.pop(doc, None)
        self._anchored_roots[doc] = set()

    # --- introspection (the shape of ytransaction_pending_update / _ds) ------

    def pending_update(self, doc: int) -> Optional[Update]:
        blocks = self._pending[doc]
        if not blocks:
            return None
        return Update({c: list(q) for c, q in blocks.items()}, DeleteSet())

    def pending_ds(self, doc: int) -> Optional[DeleteSet]:
        ds = self._pending_ds[doc]
        return None if ds.is_empty() else ds

    def capacity_ledger(self):
        """Per-slot ``(live, dead, free)`` row counts, each numpy ``[n_docs]``,
        summing to the slot capacity (one device read)."""
        live, dead = state_capacity_ledger(self.state)
        live, dead = live.cpu().numpy(), dead.cpu().numpy()
        cap = int(self.state.blocks.client.shape[-1])
        return live, dead, cap - live - dead

    # --- the host lane -----------------------------------------------------------

    def _merge_with_stash(self, doc: int, incoming: Optional[Update]) -> Update:
        blocks: Dict[int, list] = {c: list(q) for c, q in self._pending[doc].items()}
        ds = DeleteSet({c: list(rs) for c, rs in self._pending_ds[doc].clients.items()})
        if incoming is not None:
            for c, q in incoming.blocks.items():
                blocks.setdefault(c, []).extend(q)
            for c, ranges in incoming.delete_set.clients.items():
                for s, e in ranges:
                    ds.insert_range(c, s, e)
        sv = self.svs[doc]
        for c in blocks:
            blocks[c].sort(key=lambda carrier: carrier.id.clock)
            # redelivery: drop exact re-sends (same start clock; the device's
            # offset check handles partial overlaps) and carriers the mirror
            # already covers
            seen = set()
            kept = []
            for carrier in blocks[c]:
                if carrier.id.clock in seen or carrier.id.clock + carrier.len <= sv.get(c):
                    continue
                seen.add(carrier.id.clock)
                kept.append(carrier)
            blocks[c] = kept
        blocks = {c: q for c, q in blocks.items() if q}
        self._pending[doc] = {}
        self._pending_ds[doc] = DeleteSet()
        return Update(blocks, ds)

    def _plan_doc(self, doc: int, incoming: Optional[Update]) -> Tuple[list, list]:
        """(rows, dels) applicable now; the rest returns to the stash."""
        if incoming is None:
            # a stuck stash cannot progress without new data for this doc
            return [], []
        merged = self._merge_with_stash(doc, incoming)
        self._register_roots_from_update(doc, merged)
        sv = self.svs[doc]
        applicable, leftover = self.enc.partition_carriers(merged, sv)
        for carrier in applicable:
            sv.set_max(carrier.id.client, carrier.id.clock + carrier.len)
        for carrier in leftover:
            self._pending[doc].setdefault(carrier.id.client, []).append(carrier)
        dels: list = []
        for client, ranges in merged.delete_set.clients.items():
            covered = sv.get(client)
            c = self.enc.interner.intern(client)
            for start, end in ranges:
                if end <= covered:
                    dels.append((c, start, end))
                elif start >= covered:
                    self._pending_ds[doc].insert_range(client, start, end)
                else:  # split: tombstone what exists, defer the tail
                    dels.append((c, start, covered))
                    self._pending_ds[doc].insert_range(client, covered, end)
        rows = self.enc.rows_from_carriers(applicable, primary_root=self.primary_roots.get(doc))
        return rows, dels

    def _apply(self, batch: UpdateBatch) -> None:
        self.state = apply_update_batch(
            self.state, batch, self.enc.interner.rank_table(device=self.device)
        )

    def _host_batch(self, updates: List[Optional[Update]], n_rows=None, n_dels=None) -> UpdateBatch:
        all_rows, all_dels = [], []
        for d, u in enumerate(updates):
            rows, dels = self._plan_doc(d, u)
            all_rows.append(rows)
            all_dels.append(dels)
        return self.enc.batch_from_rows(all_rows, all_dels, n_rows, n_dels, device=self.device)

    def apply(self, payloads: List[Optional[bytes]], v2: bool = False) -> DocStateBatch:
        """One batched step through the host lane: per-doc update payloads,
        v1 or with `v2` v2 (None = no-op slot)."""
        if len(payloads) != self.n_docs:
            raise ValueError(f"expected {self.n_docs} payload slots")
        decode = Update.decode_v2 if v2 else Update.decode_v1
        updates = [None if p is None else decode(p) for p in payloads]
        self._apply(self._host_batch(updates))
        return self.state

    # --- the fast lane ---------------------------------------------------------------

    def _fast_eligible(self, doc: int, cols) -> bool:
        """Can this update's wire bytes go straight to the device? The
        column walk proves, before anything ships, that integrating its
        blocks in wire order needs no stash and no host-only feature, so
        the device decode cannot flag and the integrate cannot miss a
        dependency."""
        if cols.error or self._pending[doc] or not self._pending_ds[doc].is_empty():
            return False
        # named roots: record primaries, anchor the others; a root name the
        # device cannot hash routes the doc to the host lane (the anchors
        # made here are needed by both lanes)
        if not self._register_roots_from_cols(doc, cols):
            return False
        # degenerate but legal wire shapes (many client sections of covered
        # Skip runs, many empty delete-set sections) must not balloon the
        # step's decode budget
        if cols.n_client_sections > cols.n_blocks + 16 or cols.n_ds_sections > cols.n_dels + 16:
            return False
        if cols.n_complex_any > 0:
            return False  # recursive Any values: host lane
        sv = self.svs[doc]
        covered: Dict[int, int] = {}

        def cov(c: int) -> int:
            return covered.get(c, sv.get(c))

        for i in range(cols.n_blocks):
            kind = int(cols.kind[i])
            if kind not in _FAST_KINDS:
                return False
            if kind == CONTENT_TYPE:
                # WeakRef branches (host-resolved link sources) and unknown
                # TypeRef tags stay on the host
                span = cols.content_bytes(i)
                if not span or span[0] >= 7:
                    return False
            if kind == CONTENT_MOVE:
                # the range bounds must be covered already (the device
                # resolves them by id)
                cur = Cursor(bytes(cols.content_bytes(i)))
                try:
                    flags = cur.read_var_uint()
                    bounds = [(cur.read_var_uint(), cur.read_var_uint())]
                    if not flags & 1:
                        bounds.append((cur.read_var_uint(), cur.read_var_uint()))
                except EncodingError:
                    return False
                for bc, bk in bounds:
                    if not self._client_ok(bc) or bk >= cov(bc):
                        return False
            psl = int(cols.parent_sub_len[i])
            if psl > KEY_HASH_BYTES:
                return False  # the key exceeds the device hash window
            if psl >= 0 and not self._register_key(cols.parent_sub(i)):
                return False  # hash collision
            if int(cols.parent_kind[i]) == PARENT_ID:
                # a nested branch: its ContentType item must be covered
                pic, pik = int(cols.parent_id_client[i]), int(cols.parent_id_clock[i])
                if not self._client_ok(pic) or pik >= cov(pic):
                    return False
            c, ck, ln = int(cols.client[i]), int(cols.clock[i]), int(cols.length[i])
            if not self._client_ok(c) or ck + ln > _I32_MAX:
                return False
            if ck > cov(c):
                return False  # a clock gap needs pending semantics
            if kind != BLOCK_SKIP:  # Skip advances no state
                ok = int(cols.origin_clock[i])
                if ok >= 0:
                    oc = int(cols.origin_client[i])
                    if not self._client_ok(oc) or ok >= cov(oc):
                        return False
                rk = int(cols.ror_clock[i])
                if rk >= 0:
                    rc = int(cols.ror_client[i])
                    if not self._client_ok(rc) or rk >= cov(rc):
                        return False
                covered[c] = max(cov(c), ck + ln)
        for i in range(cols.n_dels):
            c = int(cols.del_client[i])
            if not self._client_ok(c) or int(cols.del_end[i]) > cov(c):
                return False
        return True

    def _client_ok(self, client: int) -> bool:
        """Small ids ride raw; ids beyond i32 resolve through the device
        hash table (registered here; a collision is host-lane work)."""
        return client <= _I32_MAX or self._register_big_client(client)

    def _register_big_client(self, client: int) -> bool:
        if client in self._client_id_collisions:
            return False
        idx = self.enc.interner.intern(client)
        h = client_hash_host(client)
        prev = self._client_hashes.get(h)
        if prev is not None and prev != idx:
            self._client_id_collisions.add(client)
            self._client_id_collisions.add(self.enc.interner.from_idx[prev])
            del self._client_hashes[h]
            return False
        self._client_hashes[h] = idx
        return True

    def _register_key(self, key: str) -> bool:
        """Intern `key` and record its device hash; False on a collision
        (then neither key may use the device table)."""
        if key in self._key_collisions:
            return False
        kid = self.enc.keys.intern(key)
        h = key_hash_host(key.encode("utf-8"))
        prev = self._key_hashes.get(h)
        if prev is not None and prev != kid:
            self._key_collisions.add(key)
            self._key_collisions.add(self.enc.keys.names[prev])
            del self._key_hashes[h]
            return False
        self._key_hashes[h] = kid
        return True

    def _ensure_anchor(self, doc: int, name: str) -> None:
        """Create doc's BLOCK_ROOT_ANCHOR row for a non-primary named root
        (idempotent). A doc at capacity is left unanchored, so the next
        update retries instead of wedging the root's rows as missing
        dependencies."""
        if name in self._anchored_roots[doc]:
            return
        if int(self.state.n_blocks[doc]) >= int(self.state.blocks.client.shape[-1]):
            return
        kid = self.enc.keys.intern(name)
        self.state = ensure_root_anchor(self.state, doc, kid)
        self._anchored_roots[doc].add(name)

    def _register_roots_from_cols(self, doc: int, cols) -> bool:
        """Record named roots from the column walk; False -> host lane.
        The first named root a doc mentions becomes its primary; later
        names anchor. Names beyond the hash window or whose hash collides
        are host-lane work. The primary's hash registers too, so a later
        root colliding with it cannot alias onto the primary branch."""
        ok = True
        for i in range(cols.n_blocks):
            if int(cols.parent_kind[i]) != PARENT_NAME:
                continue
            name = cols.parent_name(i)
            prim = self.primary_roots.setdefault(doc, name)
            if len(name.encode("utf-8")) > KEY_HASH_BYTES:
                ok = False
                continue
            if not self._register_key(name):
                ok = False
                continue
            if name != prim:
                self._ensure_anchor(doc, name)
        return ok

    def _register_roots_from_update(self, doc: int, update: Update) -> None:
        """Host-lane root registration from a decoded Update (no hash
        window: the host encodes names directly). The primary's device
        hash registers too, for the collision guard."""
        for blocks in update.blocks.values():
            for b in blocks:
                p = getattr(b, "parent", None)
                if isinstance(p, str):
                    prim = self.primary_roots.setdefault(doc, p)
                    if p == prim:
                        self._register_key(p)
                    else:
                        self._ensure_anchor(doc, p)

    def _client_table(self):
        """Raw-id intern table: ids in [0, 2^31) only; larger ids resolve
        through the hash table."""
        to_idx = self.enc.interner.to_idx
        return _sorted_table({c: i for c, i in to_idx.items() if 0 <= c <= _I32_MAX}, self.device)

    def _prim_hash(self, doc: int) -> int:
        name = self.primary_roots.get(doc)
        return -1 if name is None else key_hash_host(name.encode("utf-8"))

    def apply_bytes(self, payloads: List[Optional[bytes]]) -> DocStateBatch:
        """One batched step straight from v1 wire bytes (None = no-op
        slot). Eligible docs (no stash, in order, device-decodable
        content) decode on the device; the rest take the exact host lane.
        Both lanes merge into one `apply_update_batch` step."""
        if len(payloads) != self.n_docs:
            raise ValueError(f"expected {self.n_docs} payload slots")
        with torch.profiler.record_function("ytpu_torch.ingest.plan"):
            fast_idx: List[int] = []
            fast_payloads: List[bytes] = []
            # recovery: per fast doc, first-touch (client -> pre-step clock)
            fast_sv_deltas: Dict[int, Dict[int, int]] = {}
            fast_has_str: List[bool] = []
            slow_docs: List[int] = []
            max_fast_rows = max_fast_dels = max_sections = max_steps = 0
            interner = self.enc.interner
            with torch.profiler.record_function("ytpu_torch.ingest.plan.walk"):
                docs = [d for d, p in enumerate(payloads) if p is not None]
                walked = decode_update_columns_batch([payloads[d] for d in docs])
            with torch.profiler.record_function("ytpu_torch.ingest.plan.intern"):
                for d, cols in zip(docs, walked):
                    if not self._fast_eligible(d, cols):
                        slow_docs.append(d)
                        continue
                    fast_idx.append(d)
                    fast_payloads.append(cols.payload)
                    sv = self.svs[d]
                    deltas = fast_sv_deltas[d] = {}
                    rows_here = 0
                    has_str = False
                    for i in range(cols.n_blocks):
                        kind = int(cols.kind[i])
                        if kind == BLOCK_SKIP:
                            continue
                        ln = int(cols.length[i])
                        has_str = has_str or (kind in _WIRE_REF_KINDS and ln > 0)
                        c = int(cols.client[i])
                        interner.intern(c)
                        if int(cols.origin_clock[i]) >= 0:
                            interner.intern(int(cols.origin_client[i]))
                        if int(cols.ror_clock[i]) >= 0:
                            interner.intern(int(cols.ror_client[i]))
                        deltas.setdefault(c, sv.get(c))
                        sv.set_max(c, int(cols.clock[i]) + ln)
                        rows_here += ln > 0
                    for i in range(cols.n_dels):
                        interner.intern(int(cols.del_client[i]))
                    fast_has_str.append(has_str)
                    max_fast_rows = max(max_fast_rows, rows_here)
                    max_fast_dels = max(max_fast_dels, cols.n_dels)
                    max_sections = max(max_sections, cols.n_client_sections)
                    max_steps = max(max_steps, steps_for_columns(cols))
            self.fast_docs += len(fast_idx)
            self.slow_docs += len(slow_docs)
            with torch.profiler.record_function("ytpu_torch.ingest.plan.host_lane"):
                slow_updates: List[Optional[Update]] = [None] * self.n_docs
                for d in slow_docs:
                    slow_updates[d] = Update.decode_v1(payloads[d])
                all_rows, all_dels = [], []
                for d, u in enumerate(slow_updates):
                    rows, dels = self._plan_doc(d, u)
                    all_rows.append(rows)
                    all_dels.append(dels)
                n_rows = _bucket(max(max_fast_rows, 1, max(len(r) for r in all_rows)))
                n_dels = _bucket(max(max_fast_dels, 1, max(len(d_) for d_ in all_dels)))
                batch = self.enc.batch_from_rows(all_rows, all_dels, n_rows, n_dels, device=self.device)

        flags = chunk_base = None
        if fast_idx:
            # keep the wire bytes only of lanes that emitted rows with
            # content refs (delete- or GC-only payloads reference nothing)
            with torch.profiler.record_function("ytpu_torch.ingest.decode"):
                batch, flags, chunk_base = self._merge_fast_lane(
                    batch, fast_idx, fast_payloads, n_rows, n_dels,
                    retain_lanes=fast_has_str,
                    n_steps=16 * ((max_steps + 15) // 16) or None,
                    max_sections=_bucket(max_sections, 2) if max_sections else None,
                )
        self._apply(batch)
        if flags is None:
            return self.state
        # `_fast_eligible` proved these lanes decode clean, and a flagged
        # lane integrates nothing (its rows are invalid), so a flag means
        # the device saw something the column walk did not. Recover
        # exactly: rewind the mirror and replay the payload through the
        # host lane in one more step.
        f = flags.cpu().numpy()
        if (f & FLAG_ERRORS).any():
            bad_lanes = set(np.nonzero(f & FLAG_ERRORS)[0].tolist())
            bad = [fast_idx[i] for i in bad_lanes]
            self.fast_recoveries += len(bad)
            # release the retained chunk if every lane with content refs in
            # it was flagged (its refs never went live)
            if chunk_base is not None and all(
                i in bad_lanes for i, has in enumerate(fast_has_str) if has
            ):
                self.payloads.drop_if_unreferenced(chunk_base)
            recovery: List[Optional[Update]] = [None] * self.n_docs
            for d in bad:
                clocks = self.svs[d].clocks
                for c, old in fast_sv_deltas[d].items():
                    if old == 0:
                        clocks.pop(c, None)
                    else:
                        clocks[c] = old
                recovery[d] = Update.decode_v1(payloads[d])
            self._apply(self._host_batch(recovery))
        return self.state

    def _merge_fast_lane(self, batch, fast_idx, fast_payloads, n_rows, n_dels, retain_lanes=None,
                         n_steps=None, max_sections=None):
        """Decode the fast lanes on the device and put their rows into the
        host lane's batch; returns ``(batch, flags, chunk base or None)``."""
        dev = self.device
        maxlen = max(len(p) for p in fast_payloads)
        S = len(fast_payloads)
        arena = {}
        if self.ingest == "raw":
            # the wire bytes and an offsets table; the decode reads the
            # lanes straight from the arena (byte for byte the packed ones)
            L = _bucket(maxlen + 16, 64)
            lens = np.asarray([len(p) for p in fast_payloads], dtype=np.int32)
            offsets = np.zeros(S, dtype=np.int32)
            if S > 1:
                offsets[1:] = np.cumsum(lens[:-1])
            flat = b"".join(fast_payloads)
            # the arena is padded to a bucket (the zero tail is masked out)
            wire = np.zeros(_bucket(len(flat), 256), dtype=np.uint8)
            wire[: len(flat)] = np.frombuffer(flat, dtype=np.uint8)
            dev_buf = torch.from_numpy(wire).to(dev)
            arena = dict(offs=torch.from_numpy(offsets).to(dev), width=L)
            self.wire_bytes += wire.nbytes + offsets.nbytes + lens.nbytes
        else:
            buf, lens = pack_updates(fast_payloads, pad_to=_bucket(maxlen + 16, 64))
            S, L = buf.shape
            dev_buf = torch.from_numpy(buf).to(dev)
            self.wire_bytes += buf.nbytes + lens.nbytes
        # retain only the bytes of lanes with content refs (lens-trimmed,
        # concatenated); refs are rebased from the padded s * L layout
        keep = np.ones(S, dtype=bool) if retain_lanes is None else np.asarray(retain_lanes, dtype=bool)
        kept_lens = np.where(keep, lens, 0).astype(np.int64)
        prefix = np.zeros(S, dtype=np.int64)
        prefix[1:] = np.cumsum(kept_lens[:-1])
        base = 0
        if keep.any():
            compact = b"".join(p for p, k in zip(fast_payloads, keep) if k)
            base = self.payloads.add_chunk(np.frombuffer(compact, dtype=np.uint8))
        prim_hash = np.asarray([self._prim_hash(d) for d in fast_idx], dtype=np.int32)
        stream, flags = decode_updates_v1(
            dev_buf,
            torch.from_numpy(np.asarray(lens, dtype=np.int32)).to(dev),
            n_rows,
            n_dels,
            n_steps=n_steps,
            client_table=self._client_table(),
            max_sections=max_sections,
            key_table=_sorted_table(self._key_hashes, dev),
            client_hash_table=_sorted_table(self._client_hashes, dev),
            primary_root_hash=torch.from_numpy(prim_hash).to(dev),
            **arena,
        )
        ref = stream.content_ref
        is_str_ref = stream.valid & (ref >= 0)
        local = ref - torch.arange(S, dtype=ref.dtype, device=dev)[:, None] * L
        compact_ref = torch.from_numpy(prefix.astype(np.int32)).to(dev)[:, None] + local
        stream = stream._replace(content_ref=torch.where(is_str_ref, -2 - base - compact_ref, ref))
        idx = torch.as_tensor(fast_idx, dtype=torch.long, device=dev)
        fields = []
        for full, fast in zip(batch, stream):
            merged = full.clone()
            merged[idx] = fast.to(full.dtype)
            fields.append(merged)
        return UpdateBatch(*fields), flags, (base if keep.any() else None)
