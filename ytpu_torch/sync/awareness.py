"""Awareness — ephemeral per-client presence state (copy of
`ytpu.sync.awareness`).

Behavioral parity target: yrs src/sync/awareness.rs
(`Awareness` :35, apply semantics with clock precedence + local-state
resurrection :364-470, `AwarenessUpdate` wire form :511-563, pluggable
`Clock` sync/time.rs:5).

Presence is not CRDT data: it's a per-client (clock, json) cell with
last-writer-wins on the clock, a remove-on-null convention, and a liveness
timeout (30s in the y-protocols ecosystem). Device-optional by design — in
the batched engine this is a host-side `[clients] x (clock, json)` table.
"""

from __future__ import annotations

import json as _json
import time as _time
from typing import Any as PyAny, Callable, Dict, List, NamedTuple, Optional

from ytpu_torch.encoding.lib0 import Cursor, Writer

__all__ = ["Awareness", "AwarenessUpdate", "AwarenessUpdateEntry", "AwarenessEvent"]

NULL_STR = "null"
# The y-protocols liveness convention: entries older than this are dropped.
OUTDATED_TIMEOUT_MS = 30_000


class AwarenessUpdateEntry(NamedTuple):
    clock: int
    json: str


class AwarenessUpdate:
    """Serializable snapshot of awareness states (parity: awareness.rs:511-545)."""

    __slots__ = ("clients",)

    def __init__(self, clients: Optional[Dict[int, AwarenessUpdateEntry]] = None):
        self.clients: Dict[int, AwarenessUpdateEntry] = clients or {}

    def encode_v1(self) -> bytes:
        w = Writer()
        w.write_var_uint(len(self.clients))
        for client_id, entry in self.clients.items():
            w.write_var_uint(client_id)
            w.write_var_uint(entry.clock)
            w.write_string(entry.json)
        return w.to_bytes()

    @classmethod
    def decode_v1(cls, data: bytes) -> "AwarenessUpdate":
        cur = Cursor(data)
        n = cur.read_var_uint()
        clients = {}
        for _ in range(n):
            client_id = cur.read_var_uint()
            clock = cur.read_var_uint()
            json = cur.read_string()
            clients[client_id] = AwarenessUpdateEntry(clock, json)
        return cls(clients)

    def __eq__(self, other):
        if not isinstance(other, AwarenessUpdate):
            return NotImplemented
        return self.clients == other.clients


class AwarenessEvent(NamedTuple):
    added: List[int]
    updated: List[int]
    removed: List[int]


class _MetaClientState(NamedTuple):
    clock: int
    last_updated: float  # ms


class Awareness:
    def __init__(self, doc, clock: Optional[Callable[[], float]] = None):
        self.doc = doc
        self.states: Dict[int, str] = {}  # client -> JSON string
        self.meta: Dict[int, _MetaClientState] = {}
        self.on_update_subs: List[Callable] = []
        self.on_change_subs: List[Callable] = []
        self._now = clock or (lambda: _time.time() * 1000.0)

    @property
    def client_id(self) -> int:
        return self.doc.client_id

    # --- local state -----------------------------------------------------------

    def local_state(self) -> Optional[PyAny]:
        raw = self.states.get(self.client_id)
        return _json.loads(raw) if raw is not None else None

    def set_local_state(self, state: PyAny) -> None:
        """Set (or with None: clear) this client's presence."""
        client = self.client_id
        if state is None:
            self.remove_state(client)
            return
        prev = self.meta.get(client)
        clock = (prev.clock if prev else 0) + 1
        json = _json.dumps(state, separators=(",", ":"))
        self._apply_entry(client, clock, json)

    def clean_local_state(self) -> None:
        self.remove_state(self.client_id)

    def remove_state(self, client: int) -> None:
        """Clear a client's state, marking it disconnected (parity:
        awareness.rs:217 remove_state; surfaced as ywasm
        removeAwarenessStates). A DIRECT removal — the local-state
        resurrection guard in `apply_update` only applies to entries
        received from remote peers, never to deliberate local removals.
        The bumped clock makes the removal win precedence at peers."""
        prev = self.meta.get(client)
        clock = (prev.clock if prev else 0) + 1
        self.meta[client] = _MetaClientState(clock, self._now())
        was_present = self.states.pop(client, None) is not None
        if was_present:
            event = AwarenessEvent([], [], [client])
            for cb in list(self.on_change_subs):
                cb(self, event)
            for cb in list(self.on_update_subs):
                cb(self, event)

    def remove_states(self, clients) -> None:
        for client in clients:
            self.remove_state(client)

    # --- wire ------------------------------------------------------------------

    def update(self) -> AwarenessUpdate:
        """Snapshot of all known client states."""
        return self.update_with_clients(list(self.states.keys()))

    def update_with_clients(self, clients) -> AwarenessUpdate:
        out = {}
        for client in clients:
            meta = self.meta.get(client)
            if meta is None:
                continue
            out[client] = AwarenessUpdateEntry(
                meta.clock, self.states.get(client, NULL_STR)
            )
        return AwarenessUpdate(out)

    def apply_update(self, update: AwarenessUpdate) -> Optional[AwarenessEvent]:
        """Parity: awareness.rs:364-470 (clock precedence, null removal,
        local-state resurrection)."""
        added: List[int] = []
        updated: List[int] = []
        removed: List[int] = []
        now = self._now()
        for client_id, entry in update.clients.items():
            clock = entry.clock
            new = None if entry.json == NULL_STR else entry.json
            prev = self.meta.get(client_id)
            if prev is not None:
                is_removed = (
                    prev.clock == clock and new is None and client_id in self.states
                )
                if prev.clock < clock or is_removed:
                    if new is None:
                        if client_id == self.client_id and client_id in self.states:
                            # never let a remote peer remove our own state:
                            # bump the clock and keep it (re-broadcast upstream)
                            clock += 1
                        else:
                            if self.states.pop(client_id, None) is not None:
                                removed.append(client_id)
                    else:
                        updated.append(client_id)
                        self.states[client_id] = new
                    self.meta[client_id] = _MetaClientState(clock, now)
            else:
                self.meta[client_id] = _MetaClientState(clock, now)
                if new is not None:
                    self.states[client_id] = new
                    added.append(client_id)
        if added or updated or removed:
            event = AwarenessEvent(added, updated, removed)
            for cb in list(self.on_change_subs):
                cb(self, event)
            for cb in list(self.on_update_subs):
                cb(self, event)
            return event
        return None

    def _apply_entry(self, client: int, clock: int, json: str) -> None:
        self.apply_update(
            AwarenessUpdate({client: AwarenessUpdateEntry(clock, json)})
        )

    # --- liveness --------------------------------------------------------------

    def remove_outdated(self, timeout_ms: float = OUTDATED_TIMEOUT_MS) -> List[int]:
        """Drop remote entries not refreshed within `timeout_ms`."""
        now = self._now()
        stale = [
            c
            for c, m in self.meta.items()
            if c != self.client_id and now - m.last_updated > timeout_ms
        ]
        removed = []
        for client in stale:
            meta = self.meta[client]
            if client in self.states:
                removed.append(client)
            # removal is modeled as a null update with a bumped clock
            self.apply_update(
                AwarenessUpdate(
                    {client: AwarenessUpdateEntry(meta.clock + 1, NULL_STR)}
                )
            )
        return removed

    # --- observers -------------------------------------------------------------

    def on_update(self, cb: Callable) -> Callable[[], None]:
        self.on_update_subs.append(cb)
        return lambda: self.on_update_subs.remove(cb)

    def on_change(self, cb: Callable) -> Callable[[], None]:
        self.on_change_subs.append(cb)
        return lambda: self.on_change_subs.remove(cb)

    def all_states(self) -> Dict[int, PyAny]:
        return {c: _json.loads(s) for c, s in self.states.items()}
