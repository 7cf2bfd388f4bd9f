"""Update ingestion with host decode overlapped with device integration
(PyTorch port of `ytpu.models.pipeline`).

A decode worker turns raw lib0 V1 payloads into `UpdateBatch` chunks on the
host (CPU tensors, no CUDA call) while the caller thread integrates the
chunk before on the state's device: the wall clock approaches
max(decode, integrate) instead of their sum. The loop is the replay's
`OverlapPipeline`.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

from ytpu_torch.core.update import Update
from ytpu_torch.models.batch_doc import (
    BatchEncoder,
    DocStateBatch,
    UpdateBatch,
    apply_update_stream,
)
from ytpu_torch.utils.phases import phases

__all__ = ["UpdatePipeline"]

# restarts after a fault before it propagates
_MAX_RESTARTS = 3


class UpdatePipeline:
    """Two-stage decode -> integrate pipeline over update payload streams.

    Chunks are `chunk_steps` updates stacked into one ``[S, ...]`` stream
    (each step broadcast to every doc slot); one integrate launch takes a
    whole chunk. `depth` bounds how far the decode worker runs ahead.

    `lane` routes the integrate stage:

    - ``"xla"`` (the default; the name is the JAX package's) —
      `apply_update_stream` per chunk on the unpacked state;
    - ``"fused"`` — the chunks feed `integrate_kernel.PackedReplayDriver`:
      the state stays packed ``[NC, D, C]`` for the whole run, and between
      chunks the `CompactionPolicy` compacts it (and grows it up to
      `max_capacity`). The returned state's origin_slot plane is marked
      stale.

    ``lane="packed_xla"`` (the JAX package's XLA chunk step) is outside the
    port and raises `ValueError`. ``decode_v2=True`` reads the payloads as
    v2 updates (host decode, as for v1).

    ``admission`` (an `ytpu_torch.serving.AdmissionController`) throttles
    the staging producer: before each chunk goes to the overlap engine it
    calls ``throttle(steps)``, so a rate-limited pipeline blocks its
    producer instead of growing the staged backlog.

    With the phase recorder on, each payload's host decode is a
    ``pipeline.decode`` span and a run adds its payload bytes to
    ``pipeline.stage_bytes``.

    A `ReplayFault` or an injected staging fault restarts the whole run
    from the caller's `state` (which no lane writes) when `payloads` is a
    list or tuple, at most three times (`pipeline.restarts` metric);
    one-shot iterators re-raise.
    """

    def __init__(
        self,
        enc: BatchEncoder,
        n_rows: int,
        n_dels: int,
        chunk_steps: int = 64,
        depth: int = 2,
        decode_v2: bool = False,
        lane: str = "xla",
        policy=None,
        max_capacity: Optional[int] = None,
        admission=None,
    ):
        if lane == "packed_xla":
            raise ValueError("lane 'packed_xla' is the JAX package's XLA chunk step, outside the port: "
                             "use 'fused' or 'xla'")
        if lane not in ("xla", "fused"):
            raise ValueError(f"lane must be 'xla' or 'fused', got {lane!r}")
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.enc = enc
        self.decode_v2 = decode_v2
        self.n_rows = n_rows
        self.n_dels = n_dels
        self.chunk_steps = chunk_steps
        self.depth = depth
        self.lane = lane
        self.policy = policy
        self.max_capacity = max_capacity
        self.admission = admission
        self._staged_bytes = 0

    def _chunks(self, payloads: Iterable[bytes]):
        """Decode and build padded chunks as CPU tensors (runs on the
        worker thread)."""
        steps: List[UpdateBatch] = []
        for p in payloads:
            self._staged_bytes += len(p)
            with phases.span("pipeline.decode"):
                u = Update.decode_v2(p) if self.decode_v2 else Update.decode_v1(p)
                steps.append(self.enc.build_step(u, self.n_rows, self.n_dels, device="cpu"))
            if len(steps) == self.chunk_steps:
                if self.admission is not None:
                    self.admission.throttle(len(steps))
                yield BatchEncoder.stack_steps(steps)
                steps = []
        if steps:
            if self.admission is not None:
                self.admission.throttle(len(steps))
            # pad the tail to the chunk's S: padding steps hold invalid rows
            pad = steps[-1]._replace(valid=steps[-1].valid.new_zeros(steps[-1].valid.shape),
                                     del_valid=steps[-1].del_valid.new_zeros(steps[-1].del_valid.shape))
            steps += [pad] * (self.chunk_steps - len(steps))
            yield BatchEncoder.stack_steps(steps)

    def run(self, state: DocStateBatch, payloads: Iterable[bytes], client_rank=None) -> Tuple[DocStateBatch, int]:
        """Integrate every payload on `state`'s device; returns ``(state,
        chunks dispatched)``."""
        from ytpu_torch.ops.integrate_kernel import ReplayFault
        from ytpu_torch.utils.faults import FaultError
        from ytpu_torch.utils.metrics import metrics

        replayable = isinstance(payloads, (list, tuple))
        attempts = 0
        while True:
            try:
                return self._run_once(state, payloads, client_rank)
            except (ReplayFault, FaultError):
                attempts += 1
                if not replayable or attempts > _MAX_RESTARTS:
                    raise
                metrics.counter("pipeline.restarts").inc()
                metrics.counter("replay.recoveries").inc()

    def _run_once(self, state: DocStateBatch, payloads, client_rank) -> Tuple[DocStateBatch, int]:
        from ytpu_torch.models.replay import OverlapPipeline

        dev = state.n_blocks.device
        holder = {"state": state, "rank": client_rank}
        n = 0
        rank_clients = -1
        driver = None
        self._staged_bytes = 0

        def consume(chunk):
            nonlocal n, rank_clients, driver
            chunk = UpdateBatch(*(a.to(dev) for a in chunk))
            if client_rank is None and len(self.enc.interner) != rank_clients:
                # rebuilt only when a new client appeared
                rank_clients = len(self.enc.interner)
                holder["rank"] = self.enc.interner.rank_table(device=dev)
            if self.lane == "xla":
                holder["state"] = apply_update_stream(holder["state"], chunk, holder["rank"])
            else:
                if driver is None:
                    driver = self._make_driver(holder["state"], holder["rank"])
                driver.rank = holder["rank"]
                driver.step(chunk)
            n += 1

        OverlapPipeline(depth=self.depth, stage_prefix="pipeline").run(self._chunks(payloads), consume)
        if phases.enabled and self._staged_bytes:
            phases.add_value("pipeline.stage_bytes", self._staged_bytes)
        state = holder["state"]
        if driver is not None:
            state = self._finish_driver(driver)
        return state, n

    def _make_driver(self, state: DocStateBatch, rank):
        from ytpu_torch.ops.integrate_kernel import PackedReplayDriver, pack_state

        cols, meta = pack_state(state)
        return PackedReplayDriver(
            cols,
            meta,
            rank,
            policy=self.policy,
            max_capacity=self.max_capacity,
            initial_occupancy=int(state.n_blocks.max()),
        )

    @staticmethod
    def _finish_driver(driver) -> DocStateBatch:
        from ytpu_torch.models.batch_doc import mark_origin_slot_stale
        from ytpu_torch.ops.integrate_kernel import unpack_state

        out = unpack_state(*driver.finish())
        mark_origin_slot_stale(out)
        return out
