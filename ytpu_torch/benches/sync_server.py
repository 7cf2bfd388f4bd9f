"""Inputs and run functions of the sync-server phases of ``chip_smoke.py`` (and of
their small CPU twins in ``tests/test_torch_sync_server.py`` and
``tests/test_torch_sync_mirrored.py``): one `DeviceSyncServer`, device
authoritative or mirrored, whose tenants are the four cohorts
of ``benches/ingest.py`` (B4 text with per-tenant lags, some tenants
with swapped update pairs; BASELINE config 4's map + XML; config 3's
256-client array; a 53-bit client's text).

Each tenant has a writer and a reader session, both connected before any
write. In each of ``rounds`` rounds every writer sends its next update as
one ``Update`` frame through `receive_frames`, every reader's outbox is
drained and the server flushes; then each writer sends the rest of its log
as one SyncStep2 frame (the rest merged by `merge_updates_v1`, as a
client's reply to the greeting carries its whole diff), and a final flush
follows. Readers then send SyncStep1: even tenants with an empty state
vector, odd ones with the state vector the tenant had at round
``rounds // 2``.

The run functions take any server with the JAX package's `DeviceSyncServer`
interface, so the CPU test runs both packages on the same frames; they
build frames with the port's protocol module and never import the JAX
package.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ytpu_torch.benches import ingest as ingest_bench
from ytpu_torch.core.state_vector import StateVector
from ytpu_torch.core.update import merge_updates_v1
from ytpu_torch.sync.protocol import (
    MSG_BUSY,
    MSG_SYNC,
    MSG_SYNC_UPDATE,
    Message,
    SyncMessage,
    decode_busy,
    message_reader,
)

__all__ = [
    "FULL",
    "SMALL",
    "Plan",
    "Run",
    "Tenant",
    "catch_up",
    "drive_admitted_writes",
    "drive_reads",
    "host_value",
    "drive_writes",
    "make_tenants",
    "tenant_client_id",
    "tenant_value",
]

COHORT_NAMES = ("b4", "map_xml", "array", "big_client_text")


@dataclass(frozen=True)
class Plan:
    """A width and its schedule: tenants per cohort (in `COHORT_NAMES`
    order), slots per tenant, write rounds, B4 updates of an unlagged
    tenant, the lag groups and the lag step (tenant i of the B4 cohort
    starts ``(i mod lag_groups) * lag_step`` rounds late, and swaps its
    update pairs when ``(i // lag_groups) mod lag_groups`` is the last
    group), and the updates kept of each committed log (None: all)."""

    cohort_docs: Tuple[int, int, int, int]
    capacity: int
    rounds: int
    b4_len: int
    lag_groups: int
    lag_step: int
    log_len: Optional[int] = None

    @property
    def n_docs(self) -> int:
        return sum(self.cohort_docs)


# BASELINE config 2's width, the ingest phase's cohorts and B4 schedule.
# 32 rounds: on an H100 a round's flush step (one `apply_bytes` call) takes
# about 0.4 s, while an update merged into the rest costs the rest's flush
# about 0.12 s (its decode steps, ~10 an update, at ~12 ms of host time
# each), so fewer rounds make a shorter phase
FULL = Plan((768, 128, 64, 64), 8192, 32, ingest_bench.INGEST_STEPS, ingest_bench.LAG_GROUPS,
            ingest_bench.LAG_STEP)
# the CPU twin: four tenants of each cohort, logs cut to fit 512 slots
# and to keep the decode of whole-state updates short on the CPU
SMALL = Plan((4, 4, 4, 4), 512, 12, 40, 2, 4, 28)


@dataclass
class Tenant:
    name: str
    cohort: str
    index: int  # position among all tenants: its slot, in connection order
    log: List[bytes]  # every update its writer sends, in order
    lag: int  # rounds before its first update
    swapped: bool = False

    def round_payload(self, r: int) -> Optional[bytes]:
        i = r - self.lag
        return self.log[i] if 0 <= i < len(self.log) else None

    def rest(self, rounds: int) -> List[bytes]:
        """The updates the rounds did not send."""
        return self.log[max(0, rounds - self.lag):]


def tenant_client_id(index: int) -> int:
    """The client id of tenant `index`'s host doc (both packages'
    `doc_factory` give it this id)."""
    return 100_000 + index


def make_tenants(plan: Plan, b4_log: List[bytes], logs: Dict[str, dict]) -> List[Tenant]:
    """The tenants of `plan`, cohort by cohort; tenants of a cohort with the
    same schedule share one log object."""
    out: List[Tenant] = []
    shared: Dict[tuple, List[bytes]] = {}
    for cohort, n in zip(COHORT_NAMES, plan.cohort_docs):
        for k in range(n):
            i = len(out)
            if cohort == "b4":
                lag = (k % plan.lag_groups) * plan.lag_step
                swapped = (k // plan.lag_groups) % plan.lag_groups == plan.lag_groups - 1
                n_up = max(0, plan.b4_len - lag)
                key = (cohort, n_up, swapped)
                if key not in shared:
                    shared[key] = [b4_log[j ^ 1 if swapped else j] for j in range(n_up)]
            else:
                lag, swapped = 0, False
                key = (cohort,)
                if key not in shared:
                    shared[key] = logs[cohort]["log"][: plan.log_len]
            out.append(Tenant(f"{cohort}-{i:04d}", cohort, i, shared[key], lag, swapped))
    return out


def _update_frame(payload: bytes) -> bytes:
    return Message.sync(SyncMessage.update(payload)).encode_v1()


def _step2_frame(payload: bytes) -> bytes:
    return Message.sync(SyncMessage.step2(payload)).encode_v1()


def _step1_frame(clocks: Dict[int, int]) -> bytes:
    return Message.sync(SyncMessage.step1(StateVector(clocks))).encode_v1()


def _broadcast_payloads(frames: List[bytes]) -> List[bytes]:
    """The update payloads of drained broadcast frames, in order (raises on
    any other frame)."""
    out = []
    for f in frames:
        for m in message_reader(f):
            if m.kind != MSG_SYNC or m.body.tag != MSG_SYNC_UPDATE:
                raise ValueError(f"a broadcast frame is not an Update: {m!r}")
            out.append(m.body.payload)
    return out


@dataclass
class Run:
    """What a write-and-read run returned: the greetings, the state vector
    the server reported right after each connection, the payloads each
    writer sent and each reader drained, every reply, the state vectors at
    the middle round, the flush steps, and the readers' SyncStep2 replies."""

    greetings: Dict[str, List[List[bytes]]] = field(default_factory=dict)
    connect_svs: Dict[str, List[Dict[int, int]]] = field(default_factory=dict)
    sent: Dict[str, List[bytes]] = field(default_factory=dict)
    drained: Dict[str, List[bytes]] = field(default_factory=dict)
    writer_outbox: Dict[str, List[bytes]] = field(default_factory=dict)
    write_replies: List[bytes] = field(default_factory=list)
    mid_svs: Dict[str, Dict[int, int]] = field(default_factory=dict)
    flush_steps: List[int] = field(default_factory=list)
    merged_rest: Dict[str, bytes] = field(default_factory=dict)
    step1_replies: Dict[str, List[bytes]] = field(default_factory=dict)
    sessions: Dict[str, tuple] = field(default_factory=dict)


def drive_writes(server, plan: Plan, tenants: List[Tenant],
                 flush: Optional[Callable[[int], int]] = None,
                 after_round: Optional[Callable[[int], None]] = None) -> Run:
    """Connect each tenant's writer and reader, run the write rounds, send
    each log's rest as one SyncStep2 frame and flush. `flush(step)` runs a
    flush step (default `server.flush_device()`); steps are numbered from
    0, the rest's flush last. `after_round(r)` runs after round r's
    flush."""
    flush = flush or (lambda step: server.flush_device())
    run = Run()
    for t in tenants:
        run.greetings[t.name], run.connect_svs[t.name] = [], []
        pair = []
        for _ in range(2):
            session, frames = server.connect_frames(t.name)
            run.greetings[t.name].append(list(frames))
            run.connect_svs[t.name].append(dict(server.device_state_vector(t.name).clocks))
            pair.append(session)
        run.sessions[t.name] = tuple(pair)
        run.sent[t.name], run.drained[t.name], run.writer_outbox[t.name] = [], [], []

    def drain():
        for t in tenants:
            writer, reader = run.sessions[t.name]
            run.drained[t.name] += _broadcast_payloads(server.drain(reader))
            run.writer_outbox[t.name] += server.drain(writer)

    for r in range(plan.rounds):
        if r == plan.rounds // 2:
            run.mid_svs = {t.name: dict(server.device_state_vector(t.name).clocks) for t in tenants}
        for t in tenants:
            p = t.round_payload(r)
            if p is not None:
                run.write_replies += server.receive_frames(run.sessions[t.name][0], _update_frame(p))
                run.sent[t.name].append(p)
        drain()
        run.flush_steps.append(flush(r))
        if after_round is not None:
            after_round(r)
    merged: Dict[tuple, bytes] = {}
    for t in tenants:
        rest = t.rest(plan.rounds)
        if not rest:
            continue
        key = (id(t.log), len(rest))
        if key not in merged:
            merged[key] = merge_updates_v1(rest)
        run.merged_rest[t.name] = merged[key]
        run.write_replies += server.receive_frames(run.sessions[t.name][0], _step2_frame(merged[key]))
        run.sent[t.name].append(merged[key])
    drain()
    run.flush_steps.append(flush(plan.rounds))
    return run


@dataclass
class AdmittedRun:
    """What `drive_admitted_writes` returned: the Busy replies the writers
    got, the updates they sent again, the rounds of sending again after
    the write rounds, the trace id of every frame the server admitted, and
    any reply that was not Busy."""

    busy: int = 0
    resent: int = 0
    drain_rounds: int = 0
    admitted_traces: List[str] = field(default_factory=list)
    other_replies: List[bytes] = field(default_factory=list)


def _busy_retry_after(replies: List[bytes]) -> Optional[float]:
    """The ``retry_after_s`` of a Busy reply among `replies`, or None."""
    for f in replies:
        for m in message_reader(f):
            if m.kind == MSG_BUSY:
                return decode_busy(m.body)[0]
    return None


def drive_admitted_writes(server, plan: Plan, tenants: List[Tenant],
                          flush: Optional[Callable[[int], int]] = None) -> AdmittedRun:
    """`drive_writes`' schedule against a server whose admission controller
    defers: each tenant's writer keeps what a Busy reply refused and sends
    it again, before anything newer, once the reply's ``retry_after_s``
    has passed, so no writer reorders its updates. After the rounds each
    writer sends its log's rest as one SyncStep2 frame; then rounds of
    sending again and flushing follow until nothing is deferred. Every
    frame goes in a request trace context of its own, whose id (with the
    tracer on) is recorded when the frame is admitted."""
    from ytpu_torch.utils.trace import trace_context

    flush = flush or (lambda step: server.flush_device())
    run = AdmittedRun()
    writers, readers = {}, {}
    for t in tenants:
        writers[t.name] = server.connect_frames(t.name)[0]
        readers[t.name] = server.connect_frames(t.name)[0]
    backlog: Dict[str, List[bytes]] = {t.name: [] for t in tenants}
    not_before: Dict[str, float] = {}

    def send(t: Tenant, frame: bytes) -> bool:
        with trace_context() as fields:
            replies = server.receive_frames(writers[t.name], frame)
        retry = _busy_retry_after(replies)
        if retry is not None:
            run.busy += 1
            not_before[t.name] = time.perf_counter() + retry
            return False
        run.other_replies += replies
        if fields is not None:
            run.admitted_traces.append(fields["trace"])
        return True

    def send_backlog(t: Tenant) -> None:
        q = backlog[t.name]
        if not q:
            return
        wait = not_before.get(t.name, 0.0) - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        while q:
            if not send(t, q[0]):
                return
            q.pop(0)
            run.resent += 1

    def settle(step: int) -> None:
        for t in tenants:
            server.drain(readers[t.name])
            server.drain(writers[t.name])
        flush(step)

    for r in range(plan.rounds):
        for t in tenants:
            send_backlog(t)
            p = t.round_payload(r)
            if p is None:
                continue
            frame = _update_frame(p)
            if backlog[t.name] or not send(t, frame):
                backlog[t.name].append(frame)
        settle(r)
    merged: Dict[tuple, bytes] = {}
    for t in tenants:
        rest = t.rest(plan.rounds)
        if rest:
            key = (id(t.log), len(rest))
            if key not in merged:
                merged[key] = merge_updates_v1(rest)
            backlog[t.name].append(_step2_frame(merged[key]))
    step = plan.rounds
    while any(backlog.values()):
        for t in tenants:
            send_backlog(t)
        settle(step)
        step += 1
        run.drain_rounds += 1
    return run


def drive_reads(server, run: Run, tenants: List[Tenant],
                reply: Optional[Callable[[object, bytes], List[bytes]]] = None) -> None:
    """Each reader sends SyncStep1 through `receive_frames`: even tenants
    an empty state vector, odd ones the middle round's. `reply(session,
    frame)` makes the call (default `server.receive_frames`)."""
    reply = reply or server.receive_frames
    for t in tenants:
        clocks = {} if t.index % 2 == 0 else run.mid_svs[t.name]
        run.step1_replies[t.name] = reply(run.sessions[t.name][1], _step1_frame(clocks))


def step2_payload(frames: List[bytes]) -> bytes:
    """The payload of the one SyncStep2 message in `frames`."""
    msgs = [m for f in frames for m in message_reader(f)]
    if len(msgs) != 1 or msgs[0].kind != MSG_SYNC or msgs[0].body.tag != 1:
        raise ValueError(f"expected one SyncStep2 reply, got {msgs!r}")
    return msgs[0].body.payload


def catch_up(server, tenants: List[Tenant], payloads: Dict[str, bytes]) -> int:
    """A fresh replica's catch-up: each tenant's writer connects to the
    empty `server` (in tenant order, so each takes its slot), then each
    sends its payload as one SyncStep2 frame; one flush follows. Returns
    its steps. (Connecting flushes the queues, so every session connects
    before the first frame.)"""
    sessions = [server.connect_frames(t.name)[0] for t in tenants]
    for t, session in zip(tenants, sessions):
        if server.receive_frames(session, _step2_frame(payloads[t.name])):
            raise ValueError(f"the catch-up SyncStep2 of {t.name} got a reply")
    return server.flush_device()


def tenant_value(server, tenant: Tenant):
    """The port server's rendering of a tenant, in the committed logs'
    form: text for the B4 and big-client cohorts, the array's values, and
    config 4's map "m" and XML string "x"."""
    from ytpu_torch.models import batch_doc as bd

    ing = server.ingestor
    slot = server.slot_of(tenant.name)
    if tenant.cohort == "map_xml":
        tree = bd.get_tree(ing.state, slot, ing.payloads, ing.enc.keys)
        return {"m": ingest_bench.root_map(tree, ing.primary_roots[slot], "m"),
                "x": ingest_bench.xml_string(ing.state, slot, ing.payloads, ing.enc.keys, "x")}
    if tenant.cohort == "array":
        return bd.get_values(ing.state, slot, ing.payloads)
    return bd.get_string(ing.state, slot, ing.payloads)


def host_value(doc, tenant: Tenant):
    """A tenant's host `Doc` in the committed logs' form (`tenant_value`'s):
    text for the B4 and big-client cohorts, the array's values, and config
    4's map "m" and XML string "x"."""
    js = doc.to_json()
    if tenant.cohort == "map_xml":
        return {"m": js.get("m", {}), "x": js.get("x", "")}
    return next(iter(js.values()), [] if tenant.cohort == "array" else "")
