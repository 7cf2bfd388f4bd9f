"""Device-backed sync server: y-sync tenants fanned into batch doc slots
(PyTorch port of `ytpu.sync.device_server`).

Clients speak the y-sync protocol to `SyncServer` sessions; each tenant
owns one doc slot of a `BatchIngestor`. Updates queue per slot and ship on
`flush_device()`: one `apply_bytes` call integrates one queued update per
slot (the decode kernel, then the integrate kernel's per-doc entry on the
GPU), the ingestor's pending stashes absorbing out-of-order arrival per
slot without stalling the batch.

Two serving modes:

- mirrored (the default, ``device_authoritative=False``): each tenant's
  host `Doc` stays the protocol endpoint (greetings and SyncStep1 replies
  come from `Doc.encode_state_as_update_v1`) and the device batch shadows
  it. An update observer on the host doc queues every transaction's
  update, as the host doc re-encodes it, to the tenant's current slot, so
  every update integrates twice and the device sees only what the host
  has integrated (an out-of-order update waits in the host doc's pending
  stash).
- device-authoritative (``device_authoritative=True``): the device batch
  IS the document store. A SyncStep1 is answered from device state
  through `encode_diff_batch` and the pipelined finisher
  (`batch_doc.DiffPipeline`; store.rs:204-248 semantics over block
  columns), any pending stash folded in; inbound updates queue straight to
  the slot, and the tenant's host doc is an awareness and metadata anchor
  that never sees document content.

In both modes `_demote_to_host` / `release_tenant` move a tenant off its
slot to the host path (its host doc materialised from device state), and
`rebalance_tenant` moves it to another slot. The server runs on the GPU
unless the caller passes ``device="cpu"`` (handed to the `BatchIngestor`);
a missing GPU raises. Doc-axis sharding (``shard_docs=True``, ROADMAP
A.12) is not ported and raises `NotImplementedError`.

Observability, under the JAX package's names: each flush step is timed
into the `sync.apply_update` histogram, opens the profiler span
``ytpu_torch.sync.dispatch`` and, with the tracer on, a ``sync.dispatch``
trace span naming the request trace ids whose updates it ships (each
queued update carries the id ambient when it was queued); a failing step
dumps the tracer's ring (``YTPU_TRACE``) and re-raises. The flush keeps
the `sync.device_queue_depth` and `sync.last_dispatch_unix` gauges, slot
assignment `sync.device_slots_assigned`. ``telemetry_port`` (0 = any free
port) starts a `TelemetryServer` whose `/snapshot` carries the server's
slot and queue view (`server.telemetry`; its `stop()` ends it).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ytpu_torch.core.state_vector import StateVector
from ytpu_torch.core.update import Update, merge_updates_v1
from ytpu_torch.models.batch_doc import (
    DiffPipeline,
    EncoderTables,
    encode_diff_batch,
    get_diff,
    get_string,
    get_tree,
)
from ytpu_torch.models.ingest import BatchIngestor
from ytpu_torch.native import decode_update_columns
from ytpu_torch.utils import metrics, tracer
from ytpu_torch.utils.phases import NULL_SPAN
from ytpu_torch.utils.trace import current_trace_id

from .protocol import MSG_SYNC, MSG_SYNC_STEP_1, Message, SyncMessage, message_reader
from .server import DeviceBatchFull, Session, SyncServer

__all__ = ["DeviceBatchFull", "DeviceSyncServer"]


class DeviceSyncServer(SyncServer):
    """A SyncServer whose tenants live in device doc slots.

    `n_docs` bounds the tenant count (one slot per tenant, assigned on
    first touch). Updates accumulate per slot and ship on `flush_device()`
    — call it per request batch, on a timer, or from the serving loop.
    Multi-root tenants (doc.rs:156-228) are device-resident: the first
    named root maps onto the implicit device branch, later ones anchor
    through per-doc BLOCK_ROOT_ANCHOR rows the ingestor creates.
    """

    def __init__(
        self,
        n_docs: Optional[int] = None,
        capacity: int = 2048,
        ingestor: Optional[BatchIngestor] = None,
        device_authoritative: bool = False,
        diff_sub_batch: int = 512,
        diff_depth: int = 2,
        telemetry_port: Optional[int] = None,
        shard_docs: bool = False,
        device=None,
        **kwargs,
    ):
        if shard_docs:
            raise NotImplementedError("shard_docs=True: doc-axis sharding is not ported yet (ROADMAP A.12)")
        super().__init__(**kwargs)
        if ingestor is None:
            if n_docs is None:
                raise ValueError("pass n_docs or an ingestor")
            ingestor = BatchIngestor(n_docs, capacity, device=device)
        # the ingestor is the single source of truth for the slot count
        self.ingestor = ingestor
        self.device_authoritative = device_authoritative
        self.shard_docs = False
        self._diffs_encoded = metrics.counter("sync.diffs_encoded", labelnames=("tenant",))
        self._slots_gauge = metrics.gauge("sync.device_slots_assigned")
        self._queue_depth = metrics.gauge("sync.device_queue_depth")
        self._last_dispatch = metrics.gauge("sync.last_dispatch_unix")
        #: replies the Python finisher wrote (docs the native finisher left,
        #: or tables it cannot read), this server's count
        self.fallback_docs = 0
        self._slot_of: Dict[str, int] = {}
        # every SyncStep1 answer and batched fan-out routes through the
        # pipelined finisher: single-tenant calls take one sub-batch,
        # many-tenant fan-outs overlap device compaction, copies and the
        # host finisher
        self._diff_pipeline = DiffPipeline(sub_batch=diff_sub_batch, depth=diff_depth)
        # per-tenant wire root name (the first named root of its updates:
        # root branches are keyed by name on the wire, doc.rs)
        self._root_names: Dict[str, str] = {}
        # tenants moved off their slot to the host path (`_demote_to_host`):
        # served by `SyncServer` from their host doc from then on
        self._host_tenants: set = set()
        # slot allocation: next fresh slot + slots freed by demotions and
        # rebalances
        self._next_slot = 0
        self._free_slots: List[int] = []
        self._queues: List[List[bytes]] = [[] for _ in range(ingestor.n_docs)]
        # the request trace id of each queued update, in lockstep with
        # _queues: the dispatch span names the requests whose updates it ships
        self._queue_traces: List[List[Optional[str]]] = [[] for _ in range(ingestor.n_docs)]
        self.telemetry = None
        if telemetry_port is not None:
            from ytpu_torch.utils.telemetry import TelemetryServer

            self.telemetry = TelemetryServer(port=telemetry_port)
            self.telemetry.add_provider("server", self._telemetry_provider)
            self.telemetry.start()

    def _telemetry_provider(self) -> Dict:
        """`/snapshot` extras: the serving-side state a scraper wants next
        to the raw metrics, plus the per-tenant occupancy ledger (one
        scrape-time device read per snapshot, never on the serve path)."""
        out = {
            "tenants": len(self.tenants),
            "slots_assigned": len(self._slot_of),
            "n_docs": self.ingestor.n_docs,
            "queued_updates": self.pending_device_updates(),
            "device_authoritative": self.device_authoritative,
            "shard_docs": self.shard_docs,
        }
        try:
            out["capacity"] = self.capacity_snapshot()
        except Exception as e:  # a scrape must not take the server down
            out["capacity"] = {"error": f"{type(e).__name__}: {e}"}
        return out

    def capacity_snapshot(self) -> Dict:
        """Per-tenant slot-occupancy ledger: live / dead (tombstoned,
        GC-able) / free rows per assigned tenant slot, summing to the slot
        capacity, plus batch-wide totals. Refreshes the per-tenant
        ``capacity.tenant_{live,dead,free}_rows`` gauges."""
        live, dead, free = self.ingestor.capacity_ledger()
        slot_cap = int(live[0] + dead[0] + free[0]) if len(live) else 0
        tenants: Dict[str, Dict] = {}
        live_g = metrics.gauge("capacity.tenant_live_rows", labelnames=("tenant",))
        dead_g = metrics.gauge("capacity.tenant_dead_rows", labelnames=("tenant",))
        free_g = metrics.gauge("capacity.tenant_free_rows", labelnames=("tenant",))
        for name, slot in sorted(self._slot_of.items()):
            row = tenants[name] = {
                "slot": slot,
                "live_rows": int(live[slot]),
                "dead_rows": int(dead[slot]),
                "free_rows": int(free[slot]),
                "dead_fraction": round(int(dead[slot]) / float(max(int(live[slot]) + int(dead[slot]), 1)), 6),
            }
            live_g.labels(tenant=name).set(row["live_rows"])
            dead_g.labels(tenant=name).set(row["dead_rows"])
            free_g.labels(tenant=name).set(row["free_rows"])
        return {
            "slot_capacity": slot_cap,
            "live_rows": int(sum(int(x) for x in live)),
            "dead_rows": int(sum(int(x) for x in dead)),
            "free_rows": int(sum(int(x) for x in free)),
            "tenants": tenants,
        }

    def _enqueue(self, slot: int, payload: bytes) -> None:
        """Queue one update for a slot, with the ambient request trace id
        (None outside a traced request) in lockstep."""
        self._queues[slot].append(payload)
        self._queue_traces[slot].append(current_trace_id())

    # --- slot management -------------------------------------------------------

    def slot_of(self, tenant_name: str) -> int:
        """The device slot of an EXISTING tenant (KeyError otherwise)."""
        slot = self._slot_of.get(tenant_name)
        if slot is None:
            raise KeyError(f"tenant {tenant_name!r} has no device slot")
        return slot

    def _take_slot(self, what: str) -> int:
        if self._free_slots:
            return self._free_slots.pop()
        if self._next_slot < self.ingestor.n_docs:
            self._next_slot += 1
            return self._next_slot - 1
        raise DeviceBatchFull(f"{what} ({self.ingestor.n_docs} tenant slots)")

    def _assign_slot(self, tenant_name: str) -> int:
        slot = self._slot_of.get(tenant_name)
        if slot is None:
            slot = self._take_slot("device batch is full")
            self._slot_of[tenant_name] = slot
            self._slots_gauge.set(len(self._slot_of))
        return slot

    def tenant(self, name: str):
        first_touch = name not in self.tenants
        if first_touch and name not in self._host_tenants:
            # reserve the slot FIRST: exhaustion must fail before the tenant
            # registers, or retries would create a slotless ghost tenant. A
            # host-resident tenant (a restored checkpoint's) takes none: the
            # JAX package's server gives it one it never uses, or raises
            # when the batch is full
            self._assign_slot(name)
        t = super().tenant(name)
        if first_touch and not self.device_authoritative:
            # mirrored mode: shadow every host apply into the device queue,
            # after the broadcast observer. The slot is looked up per event,
            # not captured: a rebalance moves the tenant's slot under this
            # observer, and a tenant demoted to the host has no slot and
            # mirrors nothing
            def mirror(payload: bytes, origin, txn, _name=name):
                slot = self._slot_of.get(_name)
                if slot is not None:
                    self._enqueue(slot, payload)

            t.awareness.doc.observe_update_v1(mirror)
        return t

    # --- protocol path -----------------------------------------------------------

    def connect_frames(self, tenant_name: str):
        if not self.device_authoritative or tenant_name in self._host_tenants:
            return super().connect_frames(tenant_name)
        t, session = self._open_session(tenant_name)
        # the greeting SyncStep1 carries the DEVICE state vector (flush
        # first so queued updates are reflected in the mirror)
        self.flush_device()
        sv = self.device_state_vector(tenant_name)
        return session, [
            Message.sync(SyncMessage.step1(sv)).encode_v1(),
            Message.awareness(t.awareness.update()).encode_v1(),
        ]

    def receive_frames(self, session: Session, data: bytes) -> List[bytes]:
        """Like `SyncServer.receive_frames`, but an error while handling
        the frames (a frame that fails to parse or apply) marks THIS
        session dead, counts it under ``net.bad_frames``, records what
        threw as a ``net.bad_frame`` tracer instant and returns no replies
        instead of propagating into the serving loop: one hostile peer
        cannot take down a batch that serves every other tenant. Errors of
        `flush_device` are not caught here: they indict the batch, not a
        session."""
        try:
            return self._receive_frames_unsafe(session, data)
        except Exception as e:
            metrics.counter("net.bad_frames").inc()
            tracer.instant("net.bad_frame", error=repr(e), tenant=session.tenant, session=session.id)
            self._drop(session, "bad_frame")
            return []

    def _receive_frames_unsafe(self, session: Session, data: bytes) -> List[bytes]:
        if not self.device_authoritative or session.tenant in self._host_tenants:
            return super().receive_frames(session, data)
        t = self.tenant(session.tenant)
        slot = self.slot_of(session.tenant)
        replies: List[bytes] = []
        for msg in list(message_reader(data)):
            if msg.kind == MSG_SYNC:
                sub: SyncMessage = msg.body
                if sub.tag == MSG_SYNC_STEP_1:
                    diff = self.device_encode_diff(session.tenant, sub.payload)
                    replies.append(Message.sync(SyncMessage.step2(diff)).encode_v1())
                else:  # SyncStep2 / Update: straight to the device slot
                    ok, busy = self._admit_update(session)
                    if not ok:
                        if busy is not None:
                            replies.append(busy)
                        if session.dead:
                            break  # shed
                        continue
                    # the first root name becomes the wire primary; later
                    # roots stay device-resident through root anchors
                    self._note_roots(session.tenant, sub.payload)
                    self._enqueue(slot, sub.payload)
                    self._note_applied(t)
                    # broadcast at-least-once (CRDT updates are idempotent;
                    # the device path never touches a host doc to dedup)
                    frame = Message.sync(SyncMessage.update(sub.payload)).encode_v1()
                    tframe = self._trace_frame()
                    for other in t.sessions:
                        if other is not session:
                            if tframe is not None:
                                other.push(tframe)
                            other.push(frame)
                continue
            reply = self.protocol.handle_message(t.awareness, msg)
            if reply is not None:
                replies.append(reply.encode_v1())
        return replies

    @staticmethod
    def _scan_root_names(payload: bytes) -> List[str]:
        """Distinct root-parent names in a wire update, in block order: the
        native column walk the ingest fast lane runs (a batch of one),
        falling back to the host decoder where the walk fails."""
        cols = decode_update_columns(payload)
        names: List[str] = []
        if not cols.error:
            for i in range(cols.n_blocks):
                n = cols.parent_name(i)
                if n and n not in names:
                    names.append(n)
            return names
        try:
            up = Update.decode_v1(payload)
        except Exception:
            return names
        for blocks in up.blocks.values():
            for b in blocks:
                p = getattr(b, "parent", None)
                if isinstance(p, str) and p not in names:
                    names.append(p)
        return names

    def _note_roots(self, tenant: str, payload: bytes) -> bool:
        """Record the tenant's root names from one inbound update; True
        when the tenant just turned multi-root (observability only)."""
        names = self._scan_root_names(payload)
        if not names:
            return False
        known = self._root_names.get(tenant)
        if known is None:
            self._root_names[tenant] = known = names[0]
        if any(n != known for n in names):
            metrics.counter("sync.multi_root_tenants").inc()
            return True
        return False

    def _demote_to_host(self, tenant: str) -> None:
        """Move a tenant from its device slot to the host path: integrate
        everything queued, bring the host doc up to the device state (a
        mirrored tenant's host doc already holds it), free the slot, and
        serve the tenant through `SyncServer` from then on."""
        self.flush_device()
        doc = self.doc(tenant)
        diff = self.device_encode_diff(tenant, doc.state_vector())
        self._host_tenants.add(tenant)
        # the apply fires the tenant's broadcast observer once where it
        # changes the doc (every session gets a full-state update frame)
        doc.apply_update_v1(diff)
        slot = self._slot_of.pop(tenant)
        self._slots_gauge.set(len(self._slot_of))
        self.ingestor.reset_slot(slot)
        self._free_slots.append(slot)

    def _tenant_queue_depth(self, tenant_name: str) -> int:
        """The admission input: this tenant's queued device updates (0 for
        a tenant without a slot: nothing of it is device-bound)."""
        slot = self._slot_of.get(tenant_name)
        return 0 if slot is None else len(self._queues[slot])

    def release_tenant(self, tenant_name: str) -> None:
        """Free a tenant's device slot (its ownership moved elsewhere). The
        tenant stays servable: `_demote_to_host` materialises its host doc
        from device state first, so its sessions keep their endpoint. A
        no-op for a tenant that is host-resident or never held a slot."""
        if tenant_name in self._host_tenants or tenant_name not in self._slot_of:
            return
        self._demote_to_host(tenant_name)

    def rebalance_tenant(self, tenant_name: str, to_slot: Optional[int] = None) -> int:
        """Move a tenant to another device slot LIVE; returns the new slot.
        The tenant's full device state (pending stash folded in: exactly
        `device_encode_diff` against the empty state vector) re-ingests
        into the fresh slot as one wire update, so the move rides the same
        exactness contract as any other update; a mirrored tenant re-ingests
        from its host doc instead. Sessions stay connected; queued updates
        flush first."""
        old = self.slot_of(tenant_name)  # a host-resident tenant has none: KeyError
        self.flush_device()
        if self.device_authoritative:
            payload = self.device_encode_diff(tenant_name, StateVector())
        else:
            payload = self.doc(tenant_name).encode_state_as_update_v1()
        # allocate the destination BEFORE releasing the source: a full
        # batch must fail the rebalance, not strand the tenant slotless
        if to_slot is None:
            to_slot = self._take_slot("no free slot to rebalance into")
        else:
            if not 0 <= to_slot < self.ingestor.n_docs:
                raise ValueError(f"slot {to_slot} out of range ({self.ingestor.n_docs} tenant slots)")
            if any(t != tenant_name and s == to_slot for t, s in self._slot_of.items()):
                raise ValueError(f"slot {to_slot} is already assigned")
            # claim the destination out of the allocator: from the free
            # list, or past the frontier (freeing the slots skipped over)
            if to_slot in self._free_slots:
                self._free_slots.remove(to_slot)
            elif to_slot >= self._next_slot:
                self._free_slots.extend(range(self._next_slot, to_slot))
                self._next_slot = to_slot + 1
        self.ingestor.reset_slot(old)
        if old != to_slot:
            self._free_slots.append(old)
        self._slot_of[tenant_name] = to_slot
        self._enqueue(to_slot, payload)
        self.flush_device()
        metrics.counter("sync.rebalances").inc()
        return to_slot

    def tenant_state_vector(self, tenant_name: str) -> StateVector:
        if not self.device_authoritative or tenant_name in self._host_tenants:
            return super().tenant_state_vector(tenant_name)
        return self.device_state_vector(tenant_name)

    def device_state_vector(self, tenant_name: str) -> StateVector:
        """The device mirror's state vector for one tenant (real ids)."""
        return StateVector(dict(self.ingestor.svs[self.slot_of(tenant_name)].clocks))

    def _remote_matrix(self, slot_svs):
        """One ``[n_docs, n_clients]`` remote-clock matrix over interned
        clients (n_clients a power of two), each (slot, StateVector) pair
        filling its slot's row."""
        interner = self.ingestor.enc.interner
        n_clients = 1
        while n_clients < max(2, len(interner)):
            n_clients *= 2
        remote = np.zeros((self.ingestor.n_docs, n_clients), dtype=np.int32)
        for slot, sv in slot_svs:
            for client, clock in sv:
                idx = interner.to_idx.get(client)
                if idx is not None and idx < n_clients:
                    remote[slot, idx] = clock
        return torch.from_numpy(remote).to(self.ingestor.device), n_clients

    def _root_name(self, tenant_name: str, slot: int) -> Optional[str]:
        """The wire name of a tenant's primary root: the first root name of
        its inbound updates, or where none was noted (a mirrored tenant's
        updates reach the device through its host doc) the one the
        ingestor adopted for its slot. The JAX package's mirrored server
        has only the former and names such a tenant's root by the batch's
        default."""
        name = self._root_names.get(tenant_name)
        return name if name is not None else self.ingestor.primary_roots.get(slot)

    def _tables(self, root_name: Optional[str]) -> EncoderTables:
        """What the finisher reads: the ingestor's interners and payloads,
        under the tenant's wire root name."""
        ing = self.ingestor
        return EncoderTables(ing.enc.interner, ing.enc.keys, ing.payloads,
                             root_name if root_name is not None else ing.enc.root_name)

    def _merge_pending(self, slot: int, payload: bytes) -> bytes:
        """Fold a slot's pending stash into an encoded diff, as the
        reference's merge_pending does (transaction.rs:247-263)."""
        ing = self.ingestor
        pending = ing.pending_update(slot)
        pending_ds = ing.pending_ds(slot)
        if pending is None and pending_ds is None:
            return payload
        extras = []
        if pending is not None:
            extras.append(pending.encode_v1())
        if pending_ds is not None:
            # stashed delete ranges must reach fresh replicas too
            extras.append(Update({}, pending_ds).encode_v1())
        return merge_updates_v1([payload, *extras])

    def device_encode_diff(self, tenant_name: str, remote_sv: StateVector) -> bytes:
        """Sync step 2 answered from device state: `encode_diff_batch`
        selects rows and offsets on the device, the pipelined finisher
        compacts the shipped rows there and writes wire bytes from one
        host copy, and any pending stash folds in."""
        self.flush_device()
        ing = self.ingestor
        slot = self.slot_of(tenant_name)
        remote, n_clients = self._remote_matrix([(slot, remote_sv)])
        ship, offsets, _local, deleted = encode_diff_batch(ing.state, remote, n_clients)
        payload = self._diff_pipeline.run(
            ing.state, [slot], ship, offsets, deleted, self._tables(self._root_name(tenant_name, slot))
        )[0]
        self.fallback_docs += self._diff_pipeline.stats.fallback_docs
        payload = self._merge_pending(slot, payload)
        self._diffs_encoded.labels(tenant_name).inc()
        return payload

    def device_encode_diff_many(self, requests) -> List[bytes]:
        """Batched sync-step-2 fan-out: answer MANY tenants' SyncStep1s in
        one device selection and one pipelined finisher pass per wire root
        name. `requests` is an iterable of (tenant_name, StateVector);
        returns the v1 payloads in request order. One request per tenant
        (two state vectors for one tenant would collide on the slot's
        remote-clock row)."""
        requests = list(requests)
        if not requests:
            return []
        self.flush_device()
        ing = self.ingestor
        slots = [self.slot_of(t) for t, _ in requests]
        if len(set(slots)) != len(slots):
            raise ValueError(
                "device_encode_diff_many takes one request per tenant; "
                "duplicate tenants collide on the slot's remote-clock row"
            )
        remote, n_clients = self._remote_matrix([(s, sv) for s, (_, sv) in zip(slots, requests)])
        ship, offsets, _local, deleted = encode_diff_batch(ing.state, remote, n_clients)
        out: List[Optional[bytes]] = [None] * len(requests)
        groups: Dict[Optional[str], List[int]] = {}
        for i, (t, _) in enumerate(requests):
            groups.setdefault(self._root_name(t, slots[i]), []).append(i)
        for root, idxs in groups.items():
            res = self._diff_pipeline.run(
                ing.state, [slots[i] for i in idxs], ship, offsets, deleted, self._tables(root)
            )
            self.fallback_docs += self._diff_pipeline.stats.fallback_docs
            for i, p in zip(idxs, res):
                out[i] = self._merge_pending(slots[i], p)
        for t, _ in requests:
            self._diffs_encoded.labels(t).inc()
        return out  # type: ignore[return-value]

    # --- device dispatch -------------------------------------------------------

    def pending_device_updates(self) -> int:
        return sum(len(q) for q in self._queues)

    def flush_device(self, max_steps: Optional[int] = None) -> int:
        """Ship queued updates to the device; one update per slot per step.

        Returns the number of batch steps dispatched. Slots with deeper
        queues keep shipping while others ride as no-ops, so a chatty
        tenant never blocks a quiet one. Each step peeks, applies, THEN
        pops: a failing step drops no slot's update; it dumps the tracer's
        ring (``YTPU_TRACE``) and re-raises. The `sync.apply_update`
        histogram times each step, the `sync.device_queue_depth` gauge
        holds the queued total before and after, and a flush that
        dispatched refreshes `sync.last_dispatch_unix`."""
        depth_gauge = self._queue_depth
        depth_gauge.set(sum(len(q) for q in self._queues))
        steps = 0
        while any(self._queues) and (max_steps is None or steps < max_steps):
            payloads = [q[0] if q else None for q in self._queues]
            span = (
                tracer.span("sync.dispatch", step=steps, traces=[t[0] for t in self._queue_traces if t and t[0]])
                if tracer.enabled
                else NULL_SPAN
            )
            try:
                with self._apply_hist.time(), span, torch.profiler.record_function("ytpu_torch.sync.dispatch"):
                    self.ingestor.apply_bytes(payloads)
            except Exception as e:
                tracer.dump_on_error(error=e)
                raise
            for q in self._queues:
                if q:
                    q.pop(0)
            for t in self._queue_traces:
                if t:
                    t.pop(0)
            steps += 1
        if steps:
            # only a real dispatch refreshes the freshness gauge: an empty
            # flush must not make /healthz call an idle device fresh
            self._last_dispatch.set(time.time())
        depth_gauge.set(sum(len(q) for q in self._queues))
        return steps

    def device_text(self, tenant_name: str) -> str:
        """The device-side rendering of a tenant's root text."""
        return get_string(self.ingestor.state, self.slot_of(tenant_name), self.ingestor.payloads)

    def device_diff(self, tenant_name: str) -> list:
        """Formatted-run rendering (the ``Text.diff()`` shape) of a tenant's
        root text straight from the device block columns."""
        return get_diff(self.ingestor.state, self.slot_of(tenant_name), self.ingestor.payloads)

    def device_tree(self, tenant_name: str) -> dict:
        ing = self.ingestor
        return get_tree(ing.state, self.slot_of(tenant_name), ing.payloads, ing.enc.keys,
                        interner=ing.enc.interner)
