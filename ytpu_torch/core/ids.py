"""Block identifiers (copy of `ytpu.core.ids`): a block is addressed by a
Lamport-style ``(client, clock)`` pair and covers ``clock .. clock+len-1``
(yrs block.rs:75-93). On the device these are two int columns of the
block state (`ytpu_torch.models.batch_doc`)."""

from __future__ import annotations

from typing import NamedTuple

__all__ = ["ID", "ClientID"]

ClientID = int


class ID(NamedTuple):
    client: int
    clock: int

    def __repr__(self) -> str:
        return f"<{self.client}#{self.clock}>"
