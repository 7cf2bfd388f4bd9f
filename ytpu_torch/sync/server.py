"""Multi-tenant sync server loop, host control plane (copy of
`ytpu.sync.server`).

One server hosts many tenant docs, terminates the y-sync protocol per
(tenant, session) and broadcasts document and awareness changes to the
tenant's other sessions. Transport-agnostic: callers pump bytes through
`connect` / `receive` and deliver the returned frames. The default
``doc_factory`` builds a host `Doc` (`ytpu_torch.core.doc`) per tenant,
which answers SyncStep1 and applies every inbound update; its update
observer rebroadcasts what each transaction changed.

Observability: the servers feed the port's metrics registry
(`ytpu_torch.utils.metrics`) under the JAX package's family names —
`sync.updates_applied`, `sync.tenant_updates_applied{tenant}`,
`sync.sessions`, `sync.outbox_depth`, `sync.slow_consumer_evictions`,
`net.sessions_dropped{reason}`, `sync.busy_replies` and the
`sync.apply_update` latency histogram; the registry is process-global,
so `applied_local` keeps a per-instance count. Every host apply opens an
``apply_update`` trace span, and with the tracer on a rebroadcast update
is preceded by a trace-context frame naming the ambient request.

Admission: `admission` (an `ytpu_torch.serving.AdmissionController`,
None by default) is consulted per inbound update; a refused update is
answered with a Busy reply (policy "defer"), dropped ("drop") or sheds
its session ("shed"). Mesh links bypass it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ytpu_torch.core.doc import Doc
from ytpu_torch.utils import metrics, trace_span
from ytpu_torch.utils.trace import current_trace, tracer

from .awareness import Awareness
from .protocol import (
    TRACE_WIRE_VERSION,
    Message,
    Protocol,
    SyncMessage,
    message_reader,
    trace_message,
)

__all__ = ["DeviceBatchFull", "SyncServer", "Session"]


class DeviceBatchFull(RuntimeError):
    """All tenant slots of a device-backed server's batch are assigned."""


class Session:
    __slots__ = ("id", "tenant", "server", "outbox", "dead", "mesh_link", "_depth_gauge")

    #: broadcast frames a session may hold undelivered before it is
    #: declared a slow consumer and evicted (its transport handler sees
    #: `dead` and closes). Unbounded outboxes let one stalled peer grow
    #: server memory without limit while its tenant stays busy.
    OUTBOX_CAP = 4096

    def __init__(self, id_: int, tenant: str, server: "SyncServer"):
        self.id = id_
        self.tenant = tenant
        self.server = server
        self.outbox: List[bytes] = []
        self.dead = False
        # mesh-internal sessions (peer replication links) are not client
        # traffic: admission never refuses them
        self.mesh_link = False
        # the server's outbox high-water gauge, cached: one O(1) call a push
        self._depth_gauge = server._outbox_depth

    def push(self, frame: bytes) -> None:
        """Queue a broadcast frame, evicting the session when it is too
        far behind. Dead sessions drop frames (their connection is about
        to close; a reconnect resyncs via SyncStep1)."""
        if self.dead:
            return
        self.outbox.append(frame)
        self._depth_gauge.set_max(len(self.outbox))
        if len(self.outbox) > self.OUTBOX_CAP:
            self.dead = True
            self.outbox = []
            self.server._evictions.inc()
            # a slow-consumer eviction is a shed, counted beside admission sheds
            self.server._dropped.labels("shed").inc()


class _Tenant:
    __slots__ = ("awareness", "sessions", "applied")

    def __init__(self, doc: Doc):
        self.awareness = Awareness(doc)
        self.sessions: List[Session] = []
        self.applied = None  # the tenant's `sync.tenant_updates_applied` child


class SyncServer:
    def __init__(self, protocol: Optional[Protocol] = None, doc_factory=None):
        self.protocol = protocol or Protocol()
        self.tenants: Dict[str, _Tenant] = {}
        self._doc_factory = doc_factory or (lambda name: Doc())
        self._next_session = 0
        self._apply_hist = metrics.histogram("sync.apply_update")
        self._applied = metrics.counter("sync.updates_applied")
        self._tenant_applied = metrics.counter("sync.tenant_updates_applied", labelnames=("tenant",))
        self._sessions_gauge = metrics.gauge("sync.sessions")
        self._outbox_depth = metrics.gauge("sync.outbox_depth")
        self._evictions = metrics.counter("sync.slow_consumer_evictions")
        self._dropped = metrics.counter("net.sessions_dropped", labelnames=("reason",))
        self._busy_replies = metrics.counter("sync.busy_replies")
        #: per-instance applied count (the registry's counters are
        #: process-global: servers in one process share them)
        self.applied_local = 0
        #: an admission controller consulted per inbound update; None (the
        #: default) admits everything
        self.admission = None

    # --- tenant / doc management ----------------------------------------------

    def tenant(self, name: str) -> _Tenant:
        t = self.tenants.get(name)
        if t is None:
            doc = self._doc_factory(name)
            t = _Tenant(doc)
            t.applied = self._tenant_applied.labels(name)
            self.tenants[name] = t

            # live update broadcast: one observer per tenant doc
            def broadcast(payload: bytes, origin, txn, _name=name):
                frame = Message.sync(SyncMessage.update(payload)).encode_v1()
                tframe = self._trace_frame()
                for session in self.tenants[_name].sessions:
                    if origin is not session:
                        if tframe is not None:
                            session.push(tframe)
                        session.push(frame)

            doc.observe_update_v1(broadcast)
        return t

    def _trace_frame(self) -> Optional[bytes]:
        """The wire trace-context frame to push just before a rebroadcast
        update, or None when tracing is off, no request context is ambient,
        or this server speaks a protocol version before trace frames."""
        if not tracer.enabled:
            return None
        if getattr(self.protocol, "version", 1) < TRACE_WIRE_VERSION:
            return None
        ctx = current_trace()
        if ctx is None:
            return None
        return trace_message(str(ctx.get("trace", "")), str(ctx.get("replica", "") or "")).encode_v1()

    def doc(self, name: str) -> Doc:
        return self.tenant(name).awareness.doc

    def tenant_state_vector(self, name: str):
        """The authoritative state vector for a tenant (the host doc's here;
        device-backed servers override it for device-authoritative slots)."""
        return self.doc(name).state_vector()

    # --- session lifecycle ------------------------------------------------------

    def connect(self, tenant_name: str) -> Tuple[Session, bytes]:
        """Open a session; returns (session, greeting bytes to send)."""
        session, frames = self.connect_frames(tenant_name)
        return session, b"".join(frames)

    def _open_session(self, tenant_name: str) -> Tuple[_Tenant, Session]:
        t = self.tenant(tenant_name)
        self._next_session += 1
        session = Session(self._next_session, tenant_name, self)
        t.sessions.append(session)
        self._sessions_gauge.inc()
        return t, session

    def connect_frames(self, tenant_name: str) -> Tuple[Session, List[bytes]]:
        """Like `connect`, but one bytes object per greeting message."""
        t, session = self._open_session(tenant_name)
        return session, self.protocol.start_messages(t.awareness)

    def disconnect(self, session: Session) -> None:
        t = self.tenants.get(session.tenant)
        if t and session in t.sessions:
            t.sessions.remove(session)
            self._sessions_gauge.dec()

    def _drop(self, session: Session, reason: str) -> None:
        session.dead = True
        session.outbox = []
        self.disconnect(session)
        self._dropped.labels(reason).inc()

    def drop_sessions(self, reason: str = "failover") -> int:
        """Kill every live session at once (replica failover, shutdown):
        each is marked dead, disconnected and counted under
        ``net.sessions_dropped`` by `reason`. Returns the number dropped;
        clients recover by reconnecting (the state-vector handshake
        resyncs)."""
        n = 0
        for t in list(self.tenants.values()):
            for session in list(t.sessions):
                self._drop(session, reason)
                n += 1
        return n

    # --- admission ----------------------------------------------------------------

    def _tenant_queue_depth(self, tenant_name: str) -> int:
        """A tenant's device-queue depth, the admission controller's input:
        0 on a host-only server (there is no device queue to bound; the
        rate limit still applies). `DeviceSyncServer` overrides it."""
        return 0

    def _admit_update(self, session: Session):
        """Consult the admission controller for ONE inbound update.

        Returns ``(admitted, reply)``: admitted updates proceed; refused
        ones carry a Busy ``reply`` (policy "defer"), drop silently
        ("drop", counted under ``net.sessions_dropped{reason=
        "update_drop"}``) or shed the session ("shed": marked dead and
        disconnected). With no controller (the default) or on a mesh link
        every update is admitted: a refused peer update would be data
        loss in flight, not load shedding."""
        adm = self.admission
        if adm is None or session.mesh_link:
            return True, None
        from ytpu_torch.serving.admission import Overload

        try:
            adm.admit(session.tenant, queue_depth=self._tenant_queue_depth(session.tenant))
            return True, None
        except Overload as e:
            if adm.policy == "shed":
                self._drop(session, "shed")
                return False, None
            if adm.policy == "drop":
                self._dropped.labels("update_drop").inc()
                return False, None
            self._busy_replies.inc()
            return False, adm.busy_reply(e)

    # --- message pumping --------------------------------------------------------

    def receive(self, session: Session, data: bytes) -> bytes:
        """Process incoming frames; returns direct reply bytes (concatenated).

        Broadcasts to other sessions land in their `outbox`."""
        return b"".join(self.receive_frames(session, data))

    def receive_frames(self, session: Session, data: bytes) -> List[bytes]:
        """Like `receive`, but one bytes object per reply message — framed
        transports forward these without re-parsing. Every applied update
        is counted and its apply latency lands in the `sync.apply_update`
        histogram."""
        t = self.tenant(session.tenant)
        replies: List[bytes] = []
        for msg in message_reader(data):
            if msg.kind == 0 and msg.body.tag in (1, 2):  # SyncStep2 / Update
                ok, busy = self._admit_update(session)
                if not ok:
                    if busy is not None:
                        replies.append(busy)
                    if session.dead:
                        break  # shed: the transport sees dead and closes
                    continue
                # apply with the session as origin so we don't echo it back
                with self._apply_hist.time(), trace_span("apply_update", tenant=session.tenant):
                    t.awareness.doc.apply_update_v1(msg.body.payload, origin=session)
                self._note_applied(t)
                continue
            if msg.kind == 1:  # Awareness: apply + broadcast to others
                t.awareness.apply_update(msg.body)
                frame = Message.awareness(msg.body).encode_v1()
                for other in t.sessions:
                    if other is not session:
                        other.push(frame)
                continue
            reply = self.protocol.handle_message(t.awareness, msg)
            if reply is not None:
                replies.append(reply.encode_v1())
        return replies

    def _note_applied(self, t: _Tenant) -> None:
        self._applied.inc()
        t.applied.inc()
        self.applied_local += 1

    def drain(self, session: Session) -> List[bytes]:
        out = session.outbox
        session.outbox = []
        return out
