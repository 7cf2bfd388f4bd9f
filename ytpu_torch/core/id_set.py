"""Delete sets, the writer half (copy of `ytpu.core.id_set`'s
`DeleteSet.insert_range` / `encode`; parity target: yrs id_set.rs:440-652).

A delete set maps each client to half-open clock ranges ``[start, end)``,
kept unsorted until it is encoded: then each client's ranges are sorted
and merged, and clients are written in descending id order.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

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

    def __init__(self):
        self.clients: Dict[int, List[Range]] = {}

    def insert_range(self, client: int, start: int, end: int) -> None:
        if end > start:
            self.clients.setdefault(client, []).append((start, end))

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
