"""Multi-tenant sync server loop, host control plane (copy of
`ytpu.sync.server`).

One server hosts many tenant docs, terminates the y-sync protocol per
(tenant, session) and broadcasts document and awareness changes to the
tenant's other sessions. Transport-agnostic: callers pump bytes through
`connect` / `receive` and deliver the returned frames. The default
``doc_factory`` builds a host `Doc` (`ytpu_torch.core.doc`) per tenant,
which answers SyncStep1 and applies every inbound update; its update
observer rebroadcasts what each transaction changed.

What differs from the JAX package, until the modules it needs are ported:

- The metrics registry (ROADMAP A.10) is not ported: each server keeps
  the same tallies in `metrics`, a plain dict keyed by the registry's
  names (labelled families as ``{label: count}``).
- Tracing is off: `_trace_frame` returns None, as the JAX package's does
  while its tracer is disabled (the default).
- Admission control waits for the ``serving/`` slice: setting
  `admission` makes the first admitted update raise.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ytpu_torch.core.doc import Doc

from .awareness import Awareness
from .protocol import Message, Protocol, SyncMessage, message_reader

__all__ = ["DeviceBatchFull", "SyncServer", "Session"]


class DeviceBatchFull(RuntimeError):
    """All tenant slots of a device-backed server's batch are assigned."""


class Session:
    __slots__ = ("id", "tenant", "server", "outbox", "dead", "mesh_link")

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

    def push(self, frame: bytes) -> None:
        """Queue a broadcast frame, evicting the session when it is too
        far behind. Dead sessions drop frames (their connection is about
        to close; a reconnect resyncs via SyncStep1)."""
        if self.dead:
            return
        self.outbox.append(frame)
        if len(self.outbox) > self.OUTBOX_CAP:
            self.dead = True
            self.outbox = []
            self.server._count("sync.slow_consumer_evictions")
            # a slow-consumer eviction is a shed, counted beside admission sheds
            self.server._count("net.sessions_dropped", "shed")


class _Tenant:
    __slots__ = ("awareness", "sessions")

    def __init__(self, doc: Doc):
        self.awareness = Awareness(doc)
        self.sessions: List[Session] = []


class SyncServer:
    def __init__(self, protocol: Optional[Protocol] = None, doc_factory=None):
        self.protocol = protocol or Protocol()
        self.tenants: Dict[str, _Tenant] = {}
        self._doc_factory = doc_factory or (lambda name: Doc())
        self._next_session = 0
        #: per-instance tallies under the metrics registry's names
        self.metrics: Dict[str, object] = {
            "sync.updates_applied": 0,
            "sync.tenant_updates_applied": {},
            "sync.sessions": 0,
            "sync.slow_consumer_evictions": 0,
            "sync.busy_replies": 0,
            "net.sessions_dropped": {},
            "net.bad_frames": 0,
        }
        self.applied_local = 0
        #: an admission controller consulted per inbound update; None (the
        #: default) admits everything
        self.admission = None

    def _count(self, name: str, label: Optional[str] = None, n: int = 1) -> None:
        if label is None:
            self.metrics[name] = self.metrics.get(name, 0) + n
        else:
            family = self.metrics.setdefault(name, {})
            family[label] = family.get(label, 0) + n

    # --- tenant / doc management ----------------------------------------------

    def tenant(self, name: str) -> _Tenant:
        t = self.tenants.get(name)
        if t is None:
            doc = self._doc_factory(name)
            t = _Tenant(doc)
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
        update, or None: the port has no tracer yet, so tracing is off."""
        return None

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
        self._count("sync.sessions")
        return t, session

    def connect_frames(self, tenant_name: str) -> Tuple[Session, List[bytes]]:
        """Like `connect`, but one bytes object per greeting message."""
        t, session = self._open_session(tenant_name)
        return session, self.protocol.start_messages(t.awareness)

    def disconnect(self, session: Session) -> None:
        t = self.tenants.get(session.tenant)
        if t and session in t.sessions:
            t.sessions.remove(session)
            self._count("sync.sessions", n=-1)

    def _drop(self, session: Session, reason: str) -> None:
        session.dead = True
        session.outbox = []
        self.disconnect(session)
        self._count("net.sessions_dropped", reason)

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

    def _admit_update(self, session: Session):
        """``(admitted, reply)`` for one inbound update: with no admission
        controller (the default) or on a mesh link, admitted with no
        reply."""
        if self.admission is None or session.mesh_link:
            return True, None
        raise NotImplementedError(
            "admission control is not ported yet (the serving/ slice: "
            "ytpu/serving/admission.py needs the metrics and faults utilities)"
        )

    # --- message pumping --------------------------------------------------------

    def receive(self, session: Session, data: bytes) -> bytes:
        """Process incoming frames; returns direct reply bytes (concatenated).

        Broadcasts to other sessions land in their `outbox`."""
        return b"".join(self.receive_frames(session, data))

    def receive_frames(self, session: Session, data: bytes) -> List[bytes]:
        """Like `receive`, but one bytes object per reply message — framed
        transports forward these without re-parsing. Every applied update
        is counted."""
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
                t.awareness.doc.apply_update_v1(msg.body.payload, origin=session)
                self._note_applied(session.tenant)
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

    def _note_applied(self, tenant_name: str) -> None:
        self._count("sync.updates_applied")
        self._count("sync.tenant_updates_applied", tenant_name)
        self.applied_local += 1

    def drain(self, session: Session) -> List[bytes]:
        out = session.outbox
        session.outbox = []
        return out
