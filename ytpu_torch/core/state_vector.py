"""Per-client version clocks (copy of `ytpu.core.state_vector.StateVector`'s
reads and `set_max`; parity target: yrs state_vector.rs:19-154). A state
vector maps ``client -> next expected clock``. The batch ingestor keeps
one per doc slot as its host mirror of what the device holds.
"""

from __future__ import annotations

from typing import Dict, Optional

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

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, StateVector):
            return NotImplemented
        a = {c: k for c, k in self.clocks.items() if k}
        b = {c: k for c, k in other.clocks.items() if k}
        return a == b

    def __repr__(self) -> str:
        inner = ", ".join(f"{c}:{k}" for c, k in sorted(self.clocks.items()))
        return f"StateVector({{{inner}}})"
