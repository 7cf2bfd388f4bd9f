"""Clock-range sets: IdSet / DeleteSet (copy of `ytpu.core.id_set`; parity
target: yrs id_set.rs, IdRange :36-248, IdSet :324-439, DeleteSet
:440-652).

An IdSet maps each client to half-open clock ranges ``[start, end)``,
kept unsorted until read: then each client's ranges are sorted and merged
(clients are written in descending id order). A DeleteSet is the IdSet of
tombstoned blocks that every update and snapshot carries.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

from ytpu_torch.encoding.lib0 import Cursor, Writer

from .ids import ID, ClientID

__all__ = ["IdSet", "DeleteSet"]

Range = Tuple[int, int]  # half-open [start, end)


def _squash_ranges(ranges: List[Range]) -> List[Range]:
    """Sort and merge overlapping/adjacent ranges."""
    if len(ranges) <= 1:
        return ranges
    ranges = sorted(ranges)
    out = [ranges[0]]
    for start, end in ranges[1:]:
        last_start, last_end = out[-1]
        if start <= last_end:  # overlap or adjacency joins
            if end > last_end:
                out[-1] = (last_start, end)
        else:
            out.append((start, end))
    return out


class IdSet:
    __slots__ = ("clients",)

    def __init__(self, clients: Optional[Dict[ClientID, List[Range]]] = None):
        self.clients: Dict[ClientID, List[Range]] = clients if clients is not None else {}

    def is_empty(self) -> bool:
        return all(not rs for rs in self.clients.values())

    def insert(self, id_: ID, length: int) -> None:
        if length <= 0:
            return
        self.clients.setdefault(id_.client, []).append((id_.clock, id_.clock + length))

    def insert_range(self, client: ClientID, start: int, end: int) -> None:
        if end > start:
            self.clients.setdefault(client, []).append((start, end))

    def squash(self) -> None:
        for client in list(self.clients):
            rs = _squash_ranges(self.clients[client])
            if rs:
                self.clients[client] = rs
            else:
                del self.clients[client]

    def contains(self, id_: ID) -> bool:
        rs = self.clients.get(id_.client)
        if not rs:
            return False
        return any(start <= id_.clock < end for start, end in rs)

    def ranges(self, client: ClientID) -> List[Range]:
        return _squash_ranges(self.clients.get(client, []))

    def merge(self, other: "IdSet") -> None:
        for client, rs in other.clients.items():
            self.clients.setdefault(client, []).extend(rs)
        self.squash()

    def invert(self) -> "IdSet":
        """Ranges *not* covered, from clock 0 up to each client's max covered clock."""
        out = IdSet()
        for client, rs in self.clients.items():
            rs = _squash_ranges(rs)
            prev = 0
            holes: List[Range] = []
            for start, end in rs:
                if start > prev:
                    holes.append((prev, start))
                prev = end
            if holes:
                out.clients[client] = holes
        return out

    def copy(self) -> "IdSet":
        return IdSet({c: list(rs) for c, rs in self.clients.items()})

    def __iter__(self) -> Iterator[Tuple[ClientID, List[Range]]]:
        return iter(self.clients.items())

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, IdSet):
            return NotImplemented
        a = {c: _squash_ranges(rs) for c, rs in self.clients.items() if rs}
        b = {c: _squash_ranges(rs) for c, rs in other.clients.items() if rs}
        return a == b

    def __repr__(self) -> str:
        parts = []
        for client, rs in sorted(self.clients.items()):
            rr = ",".join(f"[{s}..{e})" for s, e in _squash_ranges(rs))
            parts.append(f"{client}:{rr}")
        return f"{type(self).__name__}({'; '.join(parts)})"

    # --- wire format: clients count, then per client: id, range count,
    # (clock, len) pairs (v2 delta-encodes clocks via the ds channel) ---

    def encode(self, enc) -> None:
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

    def encode_v1(self) -> bytes:
        from ytpu_torch.encoding.codec import EncoderV1

        enc = EncoderV1()
        self.encode(enc)
        return enc.to_bytes()

    @classmethod
    def decode(cls, dec) -> "IdSet":
        n_clients = dec.read_var()
        out = cls()
        for _ in range(n_clients):
            dec.reset_ds_cur_val()
            client = dec.read_var()
            n_ranges = dec.read_var()
            rs = out.clients.setdefault(client, [])
            for _ in range(n_ranges):
                clock = dec.read_ds_clock()
                length = dec.read_ds_len()
                if length:
                    rs.append((clock, clock + length))
        return out

    @classmethod
    def decode_v1(cls, data: bytes) -> "IdSet":
        from ytpu_torch.encoding.codec import DecoderV1

        return cls.decode(DecoderV1(data))


class DeleteSet(IdSet):
    """IdSet of deleted block ranges (reference: id_set.rs:440)."""

    __slots__ = ()

    @classmethod
    def from_id_set(cls, ids: IdSet) -> "DeleteSet":
        return cls({c: list(rs) for c, rs in ids.clients.items()})
