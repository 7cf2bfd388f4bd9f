"""Delete sets (copy of `ytpu.core.id_set`'s `DeleteSet`: `insert_range`,
`is_empty`, `ranges`, `merge`, `squash`, `decode` and `encode`; parity
target: yrs id_set.rs:440-652).

A delete set maps each client to half-open clock ranges ``[start, end)``,
kept unsorted until read: then each client's ranges are sorted and
merged, and clients are written in descending id order.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

__all__ = ["DeleteSet"]

Range = Tuple[int, int]


def _squash_ranges(ranges: List[Range]) -> List[Range]:
    """Sort and merge overlapping or adjacent ranges."""
    if len(ranges) <= 1:
        return ranges
    ranges = sorted(ranges)
    out = [ranges[0]]
    for start, end in ranges[1:]:
        last_start, last_end = out[-1]
        if start <= last_end:
            if end > last_end:
                out[-1] = (last_start, end)
        else:
            out.append((start, end))
    return out


class DeleteSet:
    __slots__ = ("clients",)

    def __init__(self, clients: Optional[Dict[int, List[Range]]] = None):
        self.clients: Dict[int, List[Range]] = clients if clients is not None else {}

    def is_empty(self) -> bool:
        return all(not rs for rs in self.clients.values())

    def insert_range(self, client: int, start: int, end: int) -> None:
        if end > start:
            self.clients.setdefault(client, []).append((start, end))

    def ranges(self, client: int) -> List[Range]:
        return _squash_ranges(self.clients.get(client, []))

    def squash(self) -> None:
        """Sort and merge each client's ranges; drop clients left empty."""
        for client in list(self.clients):
            rs = _squash_ranges(self.clients[client])
            if rs:
                self.clients[client] = rs
            else:
                del self.clients[client]

    def merge(self, other: "DeleteSet") -> None:
        for client, rs in other.clients.items():
            self.clients.setdefault(client, []).extend(rs)
        self.squash()

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, DeleteSet):
            return NotImplemented
        a = {c: _squash_ranges(rs) for c, rs in self.clients.items() if rs}
        b = {c: _squash_ranges(rs) for c, rs in other.clients.items() if rs}
        return a == b

    def __repr__(self) -> str:
        parts = []
        for client, rs in sorted(self.clients.items()):
            rr = ",".join(f"[{s}..{e})" for s, e in _squash_ranges(rs))
            parts.append(f"{client}:{rr}")
        return f"DeleteSet({'; '.join(parts)})"

    def encode(self, enc) -> None:
        """Clients count, then per client (descending id): id, range
        count, (clock, len) pairs."""
        entries = [(c, _squash_ranges(rs)) for c, rs in self.clients.items() if rs]
        entries.sort(key=lambda e: -e[0])
        enc.write_var(len(entries))
        for client, rs in entries:
            enc.reset_ds_cur_val()
            enc.write_var(client)
            enc.write_var(len(rs))
            for start, end in rs:
                enc.write_ds_clock(start)
                enc.write_ds_len(end - start)

    @classmethod
    def decode(cls, dec) -> "DeleteSet":
        """The wire form `encode` writes; zero-length ranges are dropped,
        and a client section with no ranges keeps an empty entry."""
        out = cls()
        for _ in range(dec.read_var()):
            dec.reset_ds_cur_val()
            client = dec.read_var()
            rs = out.clients.setdefault(client, [])
            for _ in range(dec.read_var()):
                clock = dec.read_ds_clock()
                length = dec.read_ds_len()
                if length:
                    rs.append((clock, clock + length))
        return out
