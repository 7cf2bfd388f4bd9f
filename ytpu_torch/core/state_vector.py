"""State vectors and snapshots (copy of `ytpu.core.state_vector`; parity
target: yrs state_vector.rs:19-154).

A state vector maps ``client -> next expected clock`` (the number of
operations observed from that client). Diff sync sends a state vector
(SyncStep1) and receives the blocks above those clocks (SyncStep2). The
batch ingestor keeps one per doc slot as its host mirror of what the
device holds. A `Snapshot` is a state vector and a delete set.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

from ytpu_torch.encoding.lib0 import Cursor, Writer

from .ids import ID, ClientID

__all__ = ["StateVector", "Snapshot"]


class StateVector:
    __slots__ = ("clocks",)

    def __init__(self, clocks: Optional[Dict[ClientID, int]] = None):
        self.clocks: Dict[ClientID, int] = dict(clocks) if clocks else {}

    def get(self, client: ClientID) -> int:
        return self.clocks.get(client, 0)

    def set_min(self, client: ClientID, clock: int) -> None:
        if client in self.clocks:
            self.clocks[client] = min(self.clocks[client], clock)
        else:
            self.clocks[client] = clock

    def set_max(self, client: ClientID, clock: int) -> None:
        if clock > self.clocks.get(client, 0):
            self.clocks[client] = clock

    def inc_by(self, client: ClientID, delta: int) -> None:
        if delta:
            self.clocks[client] = self.clocks.get(client, 0) + delta

    def contains(self, id_: ID) -> bool:
        """True if a block starting at `id_` can be applied without a gap
        (parity: state_vector.rs — `id.clock <= get(client)`)."""
        return id_.clock <= self.get(id_.client)

    def contains_all(self, other: "StateVector") -> bool:
        return all(self.get(c) >= k for c, k in other.clocks.items())

    def merge(self, other: "StateVector") -> None:
        for client, clock in other.clocks.items():
            self.set_max(client, clock)

    def copy(self) -> "StateVector":
        return StateVector(self.clocks)

    def __iter__(self) -> Iterator[Tuple[ClientID, int]]:
        return iter(self.clocks.items())

    def __len__(self) -> int:
        return len(self.clocks)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, StateVector):
            return NotImplemented
        a = {c: k for c, k in self.clocks.items() if k}
        b = {c: k for c, k in other.clocks.items() if k}
        return a == b

    def __repr__(self) -> str:
        inner = ", ".join(f"{c}:{k}" for c, k in sorted(self.clocks.items()))
        return f"StateVector({{{inner}}})"

    # --- wire format (v1) ---

    def encode(self, w: Optional[Writer] = None) -> Writer:
        w = w if w is not None else Writer()
        entries = [(c, k) for c, k in self.clocks.items() if k > 0]
        # Deterministic order: higher clients first, mirroring update encoding
        # conventions (reference sorts updates by descending client id).
        entries.sort(key=lambda e: -e[0])
        w.write_var_uint(len(entries))
        for client, clock in entries:
            w.write_var_uint(client)
            w.write_var_uint(clock)
        return w

    def encode_v1(self) -> bytes:
        return self.encode().to_bytes()

    @classmethod
    def decode(cls, cur: Cursor) -> "StateVector":
        n = cur.read_var_uint()
        clocks: Dict[ClientID, int] = {}
        for _ in range(n):
            client = cur.read_var_uint()
            clock = cur.read_var_uint()
            if clock:
                clocks[client] = max(clocks.get(client, 0), clock)
        return cls(clocks)

    @classmethod
    def decode_v1(cls, data: bytes) -> "StateVector":
        return cls.decode(Cursor(data))


class Snapshot:
    """A point-in-time document version: state vector + accumulated deletions.

    Parity: yrs state_vector.rs:135-154.
    """

    __slots__ = ("state_vector", "delete_set")

    def __init__(self, state_vector: StateVector, delete_set) -> None:
        self.state_vector = state_vector
        self.delete_set = delete_set

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Snapshot):
            return NotImplemented
        return (
            self.state_vector == other.state_vector
            and self.delete_set == other.delete_set
        )

    def encode_v1(self) -> bytes:
        from ytpu_torch.encoding.codec import EncoderV1

        enc = EncoderV1()
        self.delete_set.encode(enc)
        self.state_vector.encode(enc.w)
        return enc.to_bytes()

    @classmethod
    def decode_v1(cls, data: bytes) -> "Snapshot":
        from ytpu_torch.encoding.codec import DecoderV1

        from .id_set import DeleteSet

        dec = DecoderV1(data)
        ds = DeleteSet.decode(dec)
        sv = StateVector.decode(dec.cur)
        return cls(sv, ds)

    def encode_v2(self) -> bytes:
        """Same layout through the v2 columnar codec (parity:
        Snapshot::encode_v2, state_vector.rs)."""
        from ytpu_torch.encoding.codec import EncoderV2

        enc = EncoderV2()
        self.delete_set.encode(enc)
        self.state_vector.encode(enc.rest)
        return enc.to_bytes()

    @classmethod
    def decode_v2(cls, data: bytes) -> "Snapshot":
        from ytpu_torch.encoding.codec import DecoderV2

        from .id_set import DeleteSet

        dec = DecoderV2(data)
        ds = DeleteSet.decode(dec)
        sv = StateVector.decode(dec.rest)
        return cls(sv, ds)
