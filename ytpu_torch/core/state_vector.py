"""Per-client version clocks (copy of `ytpu.core.state_vector.StateVector`'s
reads, `set_max` and its v1 wire form; parity target: yrs
state_vector.rs:19-154). A state vector maps ``client -> next expected
clock``. The batch ingestor keeps one per doc slot as its host mirror of
what the device holds; a sync step 1 carries one on the wire.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

from ytpu_torch.encoding.lib0 import Cursor, Writer

__all__ = ["StateVector"]


class StateVector:
    __slots__ = ("clocks",)

    def __init__(self, clocks: Optional[Dict[int, int]] = None):
        self.clocks: Dict[int, int] = dict(clocks) if clocks else {}

    def get(self, client: int) -> int:
        return self.clocks.get(client, 0)

    def set_max(self, client: int, clock: int) -> None:
        if clock > self.clocks.get(client, 0):
            self.clocks[client] = clock

    def __iter__(self) -> Iterator[Tuple[int, int]]:
        return iter(self.clocks.items())

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
        """Entries with a clock above 0, higher clients first."""
        w = w if w is not None else Writer()
        entries = [(c, k) for c, k in self.clocks.items() if k > 0]
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
        clocks: Dict[int, int] = {}
        for _ in range(n):
            client = cur.read_var_uint()
            clock = cur.read_var_uint()
            if clock:
                clocks[client] = max(clocks.get(client, 0), clock)
        return cls(clocks)

    @classmethod
    def decode_v1(cls, data: bytes) -> "StateVector":
        return cls.decode(Cursor(data))
