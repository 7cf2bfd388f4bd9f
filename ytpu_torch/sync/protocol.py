"""y-sync protocol: the transport-agnostic sync state machine (copy of
`ytpu.sync.protocol`).

Behavioral parity target: yrs src/sync/protocol.rs
(`Protocol` trait with default handlers :42-135, message tags :138-147 and
:219-224, `Message`/`SyncMessage` codecs :158-272, `MessageReader` :312-330).

Handshake (protocol.rs header comment): on connect each side sends
SyncStep1(its state vector) + its Awareness snapshot; a SyncStep1 is answered
with SyncStep2(missing update); live changes flow as Update messages.

The batched server loop in `ytpu_torch.sync.server` replaces the reference's
per-connection state machine with per-tenant queues feeding
`apply_update_batch` — the protocol bytes stay identical.
"""

from __future__ import annotations

from typing import Iterator, List, NamedTuple, Optional, Tuple

from ytpu_torch.core.state_vector import StateVector
from ytpu_torch.encoding.lib0 import Cursor, Writer

from .awareness import Awareness, AwarenessUpdate

__all__ = [
    "MSG_SYNC",
    "MSG_AWARENESS",
    "MSG_AUTH",
    "MSG_QUERY_AWARENESS",
    "MSG_BUSY",
    "MSG_COMMIT",
    "MSG_OWNERSHIP",
    "MSG_TRACE",
    "PROTOCOL_VERSION",
    "TRACE_WIRE_VERSION",
    "busy_message",
    "decode_busy",
    "commit_message",
    "decode_commit",
    "OwnershipHandoff",
    "ownership_message",
    "decode_ownership",
    "trace_message",
    "decode_trace",
    "MSG_SYNC_STEP_1",
    "MSG_SYNC_STEP_2",
    "MSG_SYNC_UPDATE",
    "Message",
    "SyncMessage",
    "message_reader",
    "Protocol",
    "PermissionDenied",
    "UnsupportedMessage",
]

MSG_SYNC = 0
MSG_AWARENESS = 1
MSG_AUTH = 2
MSG_QUERY_AWARENESS = 3
# ytpu extension (admission control): a server under overload
# answers an Update with a Busy message instead of silently killing the
# session — body is lib0 [var_uint retry_after_ms][string reason].  Rides
# the generic custom-tag encode/decode path, so peers that predate it see
# an unknown-tag Message they may ignore (SyncClient.pump skips non-sync
# kinds by design).
MSG_BUSY = 4
# ytpu federation extensions (server↔server only — the replica
# mesh intercepts these at the link layer; they never reach a tenant's
# protocol handler):
# - Commit: one tenant's incrementally-maintained state commitment
#   (the JAX package's sync/commitment.py, not ported), the O(1)-per-tenant anti-entropy probe a
#   peer compares against its own before deciding whether to pull a
#   diff. Body: lib0 [string tenant][var_uint lo32][var_uint hi32]
#   [var_uint round].
# - Ownership: a typed tenant-ownership handoff (live cross-replica
#   migration / failover), epoch-guarded so a stale handoff replayed out
#   of order can never regress the owner map. Body: lib0 [string tenant]
#   [string owner replica id][var_uint epoch].
# Both ride the generic custom-tag path, so pre-federation peers see an
# unknown-tag Message they may ignore.
MSG_COMMIT = 5
MSG_OWNERSHIP = 6
# ytpu fleet-observability extension: an optional trace-context
# frame carrying the ambient trace id across replica links and real
# sockets.  A trace frame stands alone and applies to the IMMEDIATELY
# FOLLOWING frame only — transports that understand it re-enter the
# originating `trace_context()` around that next frame, so one Chrome
# trace shows a single update's id from the client frame through the
# owner replica to every peer rebroadcast.  Body: lib0
# [var_uint ext_version][string trace id][string origin replica id].
# Backward compatible on both sides: emission is gated on the peer
# protocol's `version` (old peers are never sent one), and
# `Protocol.handle_message` ignores the tag unconditionally (a stray
# trace frame reaching an old-style handler is dropped, never fatal).
MSG_TRACE = 7

#: current wire-protocol version of this build; `Protocol(version=1)`
#: models a pre-fleet peer (tolerates trace frames, never emits them)
PROTOCOL_VERSION = 2
#: first protocol version whose peers may be sent MSG_TRACE frames
TRACE_WIRE_VERSION = 2
#: version field inside the trace-frame body (room for richer context —
#: baggage, sampling flags — without a new message tag)
TRACE_EXT_VERSION = 1

PERMISSION_DENIED = 0
PERMISSION_GRANTED = 1

MSG_SYNC_STEP_1 = 0
MSG_SYNC_STEP_2 = 1
MSG_SYNC_UPDATE = 2


class PermissionDenied(Exception):
    pass


class UnsupportedMessage(Exception):
    pass


class SyncMessage:
    """One of SyncStep1(sv) / SyncStep2(update bytes) / Update(update bytes)."""

    __slots__ = ("tag", "payload")

    def __init__(self, tag: int, payload):
        self.tag = tag
        self.payload = payload

    @classmethod
    def step1(cls, sv: StateVector) -> "SyncMessage":
        return cls(MSG_SYNC_STEP_1, sv)

    @classmethod
    def step2(cls, update: bytes) -> "SyncMessage":
        return cls(MSG_SYNC_STEP_2, update)

    @classmethod
    def update(cls, update: bytes) -> "SyncMessage":
        return cls(MSG_SYNC_UPDATE, update)

    def encode(self, w: Writer) -> None:
        w.write_var_uint(self.tag)
        if self.tag == MSG_SYNC_STEP_1:
            w.write_buf(self.payload.encode_v1())
        else:
            w.write_buf(self.payload)

    @classmethod
    def decode(cls, cur: Cursor) -> "SyncMessage":
        tag = cur.read_var_uint()
        buf = cur.read_buf()
        if tag == MSG_SYNC_STEP_1:
            return cls(tag, StateVector.decode_v1(buf))
        if tag in (MSG_SYNC_STEP_2, MSG_SYNC_UPDATE):
            return cls(tag, buf)
        raise UnsupportedMessage(f"sync tag {tag}")

    def __eq__(self, other):
        if not isinstance(other, SyncMessage):
            return NotImplemented
        return self.tag == other.tag and self.payload == other.payload

    def __repr__(self):
        names = {0: "SyncStep1", 1: "SyncStep2", 2: "Update"}
        return f"{names.get(self.tag, self.tag)}({self.payload!r})"


class Message:
    """Top-level protocol message (parity: protocol.rs:150-156)."""

    __slots__ = ("kind", "body")

    def __init__(self, kind: int, body):
        self.kind = kind
        self.body = body

    @classmethod
    def sync(cls, msg: SyncMessage) -> "Message":
        return cls(MSG_SYNC, msg)

    @classmethod
    def awareness(cls, update: AwarenessUpdate) -> "Message":
        return cls(MSG_AWARENESS, update)

    @classmethod
    def awareness_query(cls) -> "Message":
        return cls(MSG_QUERY_AWARENESS, None)

    @classmethod
    def auth(cls, deny_reason: Optional[str]) -> "Message":
        return cls(MSG_AUTH, deny_reason)

    @classmethod
    def custom(cls, tag: int, data: bytes) -> "Message":
        return cls(tag, data)

    def encode(self, w: Optional[Writer] = None) -> Writer:
        w = w if w is not None else Writer()
        if self.kind == MSG_SYNC:
            w.write_var_uint(MSG_SYNC)
            self.body.encode(w)
        elif self.kind == MSG_AUTH:
            w.write_var_uint(MSG_AUTH)
            if self.body is not None:
                w.write_var_uint(PERMISSION_DENIED)
                w.write_string(self.body)
            else:
                w.write_var_uint(PERMISSION_GRANTED)
        elif self.kind == MSG_QUERY_AWARENESS:
            w.write_var_uint(MSG_QUERY_AWARENESS)
        elif self.kind == MSG_AWARENESS:
            w.write_var_uint(MSG_AWARENESS)
            w.write_buf(self.body.encode_v1())
        else:
            w.write_u8(self.kind)
            w.write_buf(self.body)
        return w

    def encode_v1(self) -> bytes:
        return self.encode().to_bytes()

    @classmethod
    def decode(cls, cur: Cursor) -> "Message":
        tag = cur.read_var_uint()
        if tag == MSG_SYNC:
            return cls(MSG_SYNC, SyncMessage.decode(cur))
        if tag == MSG_AWARENESS:
            return cls(MSG_AWARENESS, AwarenessUpdate.decode_v1(cur.read_buf()))
        if tag == MSG_AUTH:
            if cur.read_var_uint() == PERMISSION_DENIED:
                return cls(MSG_AUTH, cur.read_string())
            return cls(MSG_AUTH, None)
        if tag == MSG_QUERY_AWARENESS:
            return cls(MSG_QUERY_AWARENESS, None)
        return cls(tag, cur.read_buf())

    def __eq__(self, other):
        if not isinstance(other, Message):
            return NotImplemented
        return self.kind == other.kind and self.body == other.body

    def __repr__(self):
        names = {0: "Sync", 1: "Awareness", 2: "Auth", 3: "AwarenessQuery"}
        return f"Message.{names.get(self.kind, self.kind)}({self.body!r})"


def busy_message(reason: str, retry_after_s: float = 0.0) -> Message:
    """Protocol-level overload reply: ``Busy(retry_after_ms,
    reason)``.  Sent instead of applying an update when admission control
    rejects it — the session stays alive and the client may re-send after
    ``retry_after_ms``."""
    w = Writer()
    w.write_var_uint(max(0, int(retry_after_s * 1e3)))
    w.write_string(reason)
    return Message.custom(MSG_BUSY, w.to_bytes())


def decode_busy(body: bytes) -> Tuple[float, str]:
    """(retry_after_s, reason) from a Busy message body."""
    cur = Cursor(body)
    retry_ms = cur.read_var_uint()
    return retry_ms / 1e3, cur.read_string()


def commit_message(tenant: str, commitment: int, round_: int = 0) -> Message:
    """Anti-entropy probe: one tenant's 64-bit state
    commitment, split lo/hi so each var_uint stays within 32 bits."""
    w = Writer()
    w.write_string(tenant)
    w.write_var_uint(commitment & 0xFFFFFFFF)
    w.write_var_uint((commitment >> 32) & 0xFFFFFFFF)
    w.write_var_uint(round_)
    return Message.custom(MSG_COMMIT, w.to_bytes())


def decode_commit(body: bytes) -> Tuple[str, int, int]:
    """(tenant, commitment, round) from a Commit message body."""
    cur = Cursor(body)
    tenant = cur.read_string()
    lo = cur.read_var_uint()
    hi = cur.read_var_uint()
    return tenant, (hi << 32) | lo, cur.read_var_uint()


class OwnershipHandoff(NamedTuple):
    """Typed cross-replica tenant-ownership transfer: the
    wire record a live migration or a failover broadcasts.  ``epoch``
    is a per-tenant monotonic counter — a receiver applies a handoff
    only when its epoch EXCEEDS the known one, so replayed or
    out-of-order handoffs can never regress ownership."""

    tenant: str
    owner: str  # replica id taking ownership
    epoch: int


def ownership_message(handoff: OwnershipHandoff) -> Message:
    w = Writer()
    w.write_string(handoff.tenant)
    w.write_string(handoff.owner)
    w.write_var_uint(handoff.epoch)
    return Message.custom(MSG_OWNERSHIP, w.to_bytes())


def decode_ownership(body: bytes) -> OwnershipHandoff:
    cur = Cursor(body)
    return OwnershipHandoff(
        cur.read_string(), cur.read_string(), cur.read_var_uint()
    )


def trace_message(trace: str, origin: str = "") -> Message:
    """Trace-context extension frame: the ambient trace id
    plus the replica id it is crossing FROM.  Applies to the next frame
    only; see the MSG_TRACE tag comment for the compatibility contract."""
    w = Writer()
    w.write_var_uint(TRACE_EXT_VERSION)
    w.write_string(trace)
    w.write_string(origin)
    return Message.custom(MSG_TRACE, w.to_bytes())


def decode_trace(body: bytes) -> Tuple[int, str, str]:
    """(ext_version, trace id, origin replica id) from a trace body."""
    cur = Cursor(body)
    return cur.read_var_uint(), cur.read_string(), cur.read_string()


def message_reader(data: bytes) -> Iterator[Message]:
    """Iterate over messages packed one after another (parity: MessageReader,
    protocol.rs:312-330)."""
    cur = Cursor(data)
    while cur.has_content():
        yield Message.decode(cur)


class Protocol:
    """Default y-sync handlers (parity: protocol.rs:42-135). Subclass to
    customize (e.g. auth); `handle_message` dispatches one incoming message
    and returns an optional reply.

    ``version`` is the wire-protocol version this peer SPEAKS — it gates
    what extensions other endpoints may send it (a ``version=1`` peer is
    never sent MSG_TRACE frames).  Tolerance is not gated: every Protocol
    ignores stray trace frames regardless of version, which is what lets
    a trace-annotated stream round-trip through an old peer unharmed."""

    def __init__(self, version: int = PROTOCOL_VERSION):
        self.version = version

    def start(self, awareness: Awareness) -> bytes:
        """Connection opening: SyncStep1(local sv) + awareness snapshot."""
        return b"".join(self.start_messages(awareness))

    def start_messages(self, awareness: Awareness) -> List[bytes]:
        """`start`, one bytes object per message (for framed transports).

        Subclasses overriding `start()` (the historical hook) still take
        effect: their concatenated greeting ships as one frame —
        `message_reader` on the receiving side handles both shapes. The
        `_in_start` guard keeps `super().start()` delegation from
        recursing (base `start` itself routes through this method)."""
        if type(self).start is not Protocol.start and not getattr(
            self, "_in_start", False
        ):
            self._in_start = True
            try:
                return [self.start(awareness)]
            finally:
                self._in_start = False
        sv = awareness.doc.state_vector()
        return [
            Message.sync(SyncMessage.step1(sv)).encode_v1(),
            Message.awareness(awareness.update()).encode_v1(),
        ]

    def handle_sync_step1(
        self, awareness: Awareness, sv: StateVector
    ) -> Optional[Message]:
        update = awareness.doc.encode_state_as_update_v1(sv)
        return Message.sync(SyncMessage.step2(update))

    def handle_sync_step2(
        self, awareness: Awareness, update: bytes
    ) -> Optional[Message]:
        awareness.doc.apply_update_v1(update)
        return None

    def handle_update(self, awareness: Awareness, update: bytes) -> Optional[Message]:
        return self.handle_sync_step2(awareness, update)

    def handle_auth(
        self, awareness: Awareness, deny_reason: Optional[str]
    ) -> Optional[Message]:
        if deny_reason is not None:
            raise PermissionDenied(deny_reason)
        return None

    def handle_awareness_query(self, awareness: Awareness) -> Optional[Message]:
        return Message.awareness(awareness.update())

    def handle_awareness_update(
        self, awareness: Awareness, update: AwarenessUpdate
    ) -> Optional[Message]:
        awareness.apply_update(update)
        return None

    def missing_handle(
        self, awareness: Awareness, tag: int, data: bytes
    ) -> Optional[Message]:
        raise UnsupportedMessage(f"message tag {tag}")

    def handle_message(self, awareness: Awareness, msg: Message) -> Optional[Message]:
        if msg.kind == MSG_SYNC:
            sub: SyncMessage = msg.body
            if sub.tag == MSG_SYNC_STEP_1:
                return self.handle_sync_step1(awareness, sub.payload)
            if sub.tag == MSG_SYNC_STEP_2:
                return self.handle_sync_step2(awareness, sub.payload)
            return self.handle_update(awareness, sub.payload)
        if msg.kind == MSG_AUTH:
            return self.handle_auth(awareness, msg.body)
        if msg.kind == MSG_QUERY_AWARENESS:
            return self.handle_awareness_query(awareness)
        if msg.kind == MSG_AWARENESS:
            return self.handle_awareness_update(awareness, msg.body)
        if msg.kind == MSG_TRACE:
            # forward-compat contract: trace frames are advisory context,
            # never content — any handler that sees one (transports
            # normally intercept them first) drops it without reply
            return None
        return self.missing_handle(awareness, msg.kind, msg.body)
