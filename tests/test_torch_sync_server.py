"""The port's device-authoritative `DeviceSyncServer` against the JAX
package's on the CPU: the device-authoritative scenarios of
``tests/test_device_server.py`` and a whole-slice run of the chip phase's
four tenant cohorts (``ytpu_torch/benches/sync_server.py``'s `SMALL`
plan), every client frame made once (by ytpu's host `Doc`, or by the
bench module) and fed to both servers. Greetings, replies, drained
outboxes, state vectors, texts, trees, formatted diffs, capacity
ledgers, rebalances and fan-out payloads must be equal; then the port's
own rules: a malformed frame kills only its session, and the unported
options raise. (The mirrored mode is held to ytpu's in
``tests/test_torch_sync_mirrored.py``.)"""

import gzip
import os
import pickle
import zlib

import pytest

from ytpu.core import Doc
from ytpu.sync.device_server import DeviceSyncServer as YServer
from ytpu.sync.protocol import Protocol as YProtocol
from ytpu_torch.benches import ingest as ingest_bench
from ytpu_torch.benches import sync_server as bench
from ytpu_torch.core.doc import Doc as TDoc
from ytpu_torch.core.state_vector import StateVector
from ytpu_torch.sync.device_server import DeviceSyncServer as TServer
from ytpu_torch.sync.protocol import MSG_BUSY, Message, SyncMessage, message_reader
from ytpu_torch.sync.server import DeviceBatchFull
from ytpu_torch.utils.metrics import metrics as t_metrics
from ytpu.utils.metrics import metrics as y_metrics

from _torch_obs import RegistryDelta

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _client_id(name: str) -> int:
    return 10_000 + zlib.crc32(name.encode()) % 10_000


class Pair:
    """One server of each package at the same width; every call goes to
    both and the results must be equal."""

    def __init__(self, n_docs, capacity, client_id=_client_id):
        # each package's registry, read as deltas from here
        self.ytally, self.tally = RegistryDelta(y_metrics), RegistryDelta(t_metrics)
        self.y = YServer(n_docs=n_docs, capacity=capacity, device_authoritative=True,
                         doc_factory=lambda name: Doc(client_id=client_id(name)))
        self.t = TServer(n_docs=n_docs, capacity=capacity, device_authoritative=True, device="cpu",
                         doc_factory=lambda name: TDoc(client_id=client_id(name)))

    def connect(self, tenant):
        sy, gy = self.y.connect_frames(tenant)
        st, gt = self.t.connect_frames(tenant)
        assert gt == gy
        return (sy, st), gy

    def receive(self, sessions, frame):
        ry = self.y.receive_frames(sessions[0], frame)
        rt = self.t.receive_frames(sessions[1], frame)
        assert rt == ry
        return ry

    def flush(self):
        steps = self.y.flush_device()
        assert self.t.flush_device() == steps
        return steps

    def drain(self, sessions):
        dy = self.y.drain(sessions[0])
        assert self.t.drain(sessions[1]) == dy
        return dy

    def state_vector(self, tenant):
        sv = dict(self.y.device_state_vector(tenant).clocks)
        assert dict(self.t.device_state_vector(tenant).clocks) == sv
        return sv

    def check(self, tenant):
        """State vector, text, tree, formatted diff and capacity ledger of
        `tenant` equal in both."""
        self.state_vector(tenant)
        assert self.t.device_text(tenant) == self.y.device_text(tenant)
        assert self.t.device_tree(tenant) == self.y.device_tree(tenant)
        assert _runs(self.t.device_diff(tenant)) == _runs(self.y.device_diff(tenant))
        assert self.t.capacity_snapshot() == self.y.capacity_snapshot()
        assert self.t.pending_device_updates() == self.y.pending_device_updates()


def _runs(diff):
    return [(d.insert, d.attributes or None) for d in diff]


def _update(payload):
    return Message.sync(SyncMessage.update(payload)).encode_v1()


def _step1(clocks):
    return Message.sync(SyncMessage.step1(StateVector(clocks))).encode_v1()


def _client_pump(doc, frames):
    """One client side of the handshake: process the server's frames
    against a local ytpu `Doc`; returns the reply bytes."""

    class _A:
        def __init__(self, d):
            self.doc = d

        def update(self):
            from ytpu.sync.awareness import Awareness

            return Awareness(self.doc).update()

        def apply_update(self, u):
            pass

    proto, aw, out = YProtocol(), _A(doc), []
    for frame in frames:
        from ytpu.sync.protocol import message_reader as y_reader

        for msg in y_reader(frame):
            reply = proto.handle_message(aw, msg)
            if reply is not None:
                out.append(reply.encode_v1())
    return b"".join(out)


def _apply_step2(doc, frames):
    for f in frames:
        for m in message_reader(f):
            if m.kind == 0 and m.body.tag in (1, 2):
                doc.apply_update_v1(m.body.payload)


def _log(doc):
    log = []
    doc.observe_update_v1(lambda p, o, t: log.append(p))
    return log


def test_device_authoritative_serving_converges_without_host_doc():
    pair = Pair(2, 512)
    alice = Doc(client_id=1)
    with alice.transact() as txn:
        alice.get_text("text").insert(txn, 0, "hello from alice")
    s_a, greeting_a = pair.connect("pad")
    reply = _client_pump(alice, greeting_a)  # step1 -> the client's step2
    assert pair.receive(s_a, reply) == []
    pair.receive(s_a, _update(alice.encode_state_as_update_v1()))
    assert pair.flush() == 2
    pair.check("pad")
    assert pair.t.device_text("pad") == "hello from alice"
    # the tenant's host doc is an anchor that never sees content
    assert isinstance(pair.t.doc("pad"), TDoc)
    assert pair.t.doc("pad").state_vector() == StateVector()
    assert pair.t.doc("pad").encode_state_as_update_v1() == pair.y.doc("pad").encode_state_as_update_v1()

    bob = Doc(client_id=2)
    s_b, greeting_b = pair.connect("pad")
    _client_pump(bob, greeting_b)
    replies = pair.receive(s_b, _step1({}))
    _apply_step2(bob, replies)
    assert bob.get_text("text").get_string() == "hello from alice"

    # a live edit from B broadcasts to A and lands on the device
    with bob.transact() as txn:
        bob.get_text("text").insert(txn, 0, ">> ")
    from ytpu.core.state_vector import StateVector as YSV

    sv = pair.state_vector("pad")
    pair.receive(s_b, _update(bob.encode_state_as_update_v1(YSV(sv))))
    pair.flush()
    pair.check("pad")
    assert pair.t.device_text("pad") == ">> hello from alice"
    frames = pair.drain(s_a)
    assert frames and pair.drain(s_b) == []
    _apply_step2(alice, frames)
    assert alice.get_text("text").get_string() == ">> hello from alice"
    assert pair.tally["sync.updates_applied"] == pair.ytally["sync.updates_applied"] == 3
    assert pair.tally['sync.diffs_encoded{tenant="pad"}'] == pair.ytally['sync.diffs_encoded{tenant="pad"}'] == 1


def test_device_authoritative_incremental_diff():
    pair = Pair(2, 512)
    writer = Doc(client_id=7)
    with writer.transact() as txn:
        writer.get_text("text").insert(txn, 0, "part one. ")
    s, _ = pair.connect("doc")
    pair.receive(s, _update(writer.encode_state_as_update_v1()))
    pair.flush()
    reader = Doc(client_id=8)
    _apply_step2(reader, pair.receive(s, _step1({})))
    assert reader.get_text("text").get_string() == "part one. "

    from ytpu.core.state_vector import StateVector as YSV

    with writer.transact() as txn:
        t = writer.get_text("text")
        t.insert(txn, len(t.get_string()), "part two.")
    pair.receive(s, _update(writer.encode_state_as_update_v1(YSV(pair.state_vector("doc")))))
    pair.flush()
    replies = pair.receive(s, _step1(dict(reader.state_vector().clocks)))
    _apply_step2(reader, replies)
    assert reader.get_text("text").get_string() == "part one. part two."
    pair.check("doc")


def test_multi_root_tenant_stays_device_resident():
    pair = Pair(2, 256)
    session, _ = pair.connect("app")
    c = Doc(client_id=31)
    log = _log(c)
    with c.transact() as txn:
        c.get_text("body").insert(txn, 0, "words")
    with c.transact() as txn:
        c.get_map("meta").insert(txn, "title", "doc one")
    with c.transact() as txn:
        c.get_text("body").insert(txn, 5, "!")
    for p in log:
        pair.receive(session, _update(p))
    pair.flush()
    pair.check("app")
    assert pair.t.device_text("app") == "words!"
    assert pair.t.device_tree("app")["roots"]["meta"]["map"] == {"title": "doc one"}
    assert pair.tally["sync.multi_root_tenants"] == pair.ytally["sync.multi_root_tenants"] == 1

    session2, greeting = pair.connect("app")
    replies = pair.receive(session2, _step1({}))
    d = Doc(client_id=32)
    _apply_step2(d, list(greeting) + replies)
    assert d.get_text("body").get_string() == "words!"
    assert d.get_map("meta").to_json() == {"title": "doc one"}


def test_slot_exhaustion_retry_raises_and_leaves_no_ghost():
    pair = Pair(1, 64)
    pair.connect("one")
    for server in (pair.y, pair.t):
        for _ in range(2):  # a retry fails identically
            with pytest.raises(RuntimeError):
                server.connect_frames("two")
        assert "two" not in server.tenants
    with pytest.raises(DeviceBatchFull):
        pair.t.connect_frames("two")


def test_unknown_tenant_read_raises_instead_of_allocating():
    pair = Pair(2, 64)
    pair.connect("pad")
    for server in (pair.y, pair.t):
        for read in (server.device_text, server.device_state_vector, server.device_tree):
            with pytest.raises(KeyError):
                read("padd")  # typo: no silent slot allocation
        assert len(server._slot_of) == 1


def test_chatty_tenant_does_not_block_quiet_one():
    pair = Pair(2, 512)
    s_a, _ = pair.connect("chatty")
    s_b, _ = pair.connect("quiet")  # a connection flushes the queues first
    peer = Doc(client_id=5)
    log = _log(peer)
    for i in range(6):
        with peer.transact() as txn:
            t = peer.get_text("text")
            t.insert(txn, t.branch.content_len, f"{i}")
    for p in log:
        pair.receive(s_a, _update(p))
    other = Doc(client_id=6)
    with other.transact() as txn:
        other.get_text("text").insert(txn, 0, "q")
    pair.receive(s_b, _update(other.encode_state_as_update_v1()))
    assert pair.t.pending_device_updates() == 7
    assert pair.t.flush_device(max_steps=2) == pair.y.flush_device(max_steps=2) == 2
    assert pair.t.device_text("quiet") == pair.y.device_text("quiet") == "q"
    assert pair.flush() == 4
    for name in ("chatty", "quiet"):
        pair.check(name)
    assert pair.t.device_text("chatty") == "012345"


def test_formatted_text_diff_fanout_and_rebalance():
    """A formatted tenant's `device_diff`; `device_encode_diff_many` over
    two tenants; a live rebalance into the free slot of a 3-slot batch,
    then a rebalance with no slot free, which must raise and leave the
    tenant where it was."""
    pair = Pair(3, 256)
    s, _ = pair.connect("fmt")
    c = Doc(client_id=61)
    log = _log(c)
    txt = c.get_text("text")
    with c.transact() as txn:
        txt.insert(txn, 0, "plain ")
    with c.transact() as txn:
        txt.insert_with_attributes(txn, 6, "bold", {"b": True})
    with c.transact() as txn:
        txt.insert(txn, 10, " tail")
    for p in log:
        pair.receive(s, _update(p))
    s2, _ = pair.connect("other")
    d = Doc(client_id=62)
    with d.transact() as txn:
        d.get_array("list").insert_range(txn, 0, [1, "two", {"k": 3}])
    pair.receive(s2, _update(d.encode_state_as_update_v1()))
    pair.flush()
    pair.check("fmt")
    pair.check("other")
    assert _runs(pair.t.device_diff("fmt")) == [(r.insert, r.attributes or None) for r in txt.diff()]

    from ytpu.core.state_vector import StateVector as YSV

    reqs = [("fmt", {}), ("other", {62: 1})]
    many_y = pair.y.device_encode_diff_many([(n, YSV(c)) for n, c in reqs])
    many_t = pair.t.device_encode_diff_many([(n, StateVector(c)) for n, c in reqs])
    assert many_t == many_y
    with pytest.raises(ValueError):
        pair.t.device_encode_diff_many([("fmt", StateVector()), ("fmt", StateVector())])

    before = (pair.t.device_text("fmt"), pair.state_vector("fmt"))
    assert pair.t.rebalance_tenant("fmt") == pair.y.rebalance_tenant("fmt") == 2
    pair.check("fmt")
    assert (pair.t.device_text("fmt"), pair.state_vector("fmt")) == before
    assert pair.tally["sync.rebalances"] == pair.ytally["sync.rebalances"] == 1
    pair.connect("third")  # takes the slot the rebalance freed
    assert pair.t.slot_of("third") == pair.y.slot_of("third") == 0
    for server in (pair.y, pair.t):
        with pytest.raises(RuntimeError, match="no free slot"):
            server.rebalance_tenant("other")
        assert server.slot_of("other") == 1
    with pytest.raises(DeviceBatchFull):
        pair.t.rebalance_tenant("other")
    pair.check("other")


def test_malformed_frame_kills_only_its_session():
    pair = Pair(2, 256)
    good, _ = pair.connect("a")
    bad, _ = pair.connect("a")
    other, _ = pair.connect("b")
    assert pair.receive(bad, b"\x00\x01\x05\xff\xff") == []  # a truncated SyncStep2
    assert bad[1].dead and bad[0].dead
    assert not good[1].dead and not other[1].dead
    for tally in (pair.tally, pair.ytally):
        assert tally["net.bad_frames"] == 1
        assert tally['net.sessions_dropped{reason="bad_frame"}'] == 1
        assert tally["sync.sessions"] == 2
    c = Doc(client_id=71)
    with c.transact() as txn:
        c.get_text("text").insert(txn, 0, "still serving")
    pair.receive(good, _update(c.encode_state_as_update_v1()))
    pair.flush()
    pair.check("a")
    assert pair.t.device_text("a") == "still serving"
    assert pair.drain(other) == []


def test_port_only_rules_raise():
    import torch

    from ytpu_torch.serving import AdmissionController

    for kwargs in ({"shard_docs": True}, {"device_authoritative": True, "shard_docs": True}):
        with pytest.raises(NotImplementedError):
            TServer(n_docs=2, capacity=64, device="cpu", **kwargs)
    for kwargs in ({"telemetry_port": 0}, {"device_authoritative": True, "telemetry_port": 0}):
        served = TServer(n_docs=2, capacity=64, device="cpu", **kwargs)
        try:
            assert served.telemetry.port > 0  # the telemetry plane is ported
        finally:
            served.telemetry.stop()
    with pytest.raises(ValueError):
        TServer(device_authoritative=True, device="cpu")
    # the default mode is the mirrored one
    assert TServer(n_docs=2, capacity=64, device="cpu").device_authoritative is False
    server = TServer(n_docs=2, capacity=64, device_authoritative=True, device="cpu")
    session, _ = server.connect_frames("pad")
    server.release_tenant("pad")  # a content-less tenant: its host doc stays empty
    assert "pad" in server._host_tenants and server._free_slots == [0]
    assert server.doc("pad").state_vector() == StateVector()
    # admission is ported: a bound of 0 answers an update with a Busy reply
    server.admission = AdmissionController(max_queue=0)
    (busy,) = server._receive_frames_unsafe(session, _update(b"\x00\x00"))
    assert next(iter(message_reader(busy))).kind == MSG_BUSY
    if not torch.cuda.is_available():
        # no device named and no GPU: it raises, it does not run on the CPU
        with pytest.raises(RuntimeError):
            TServer(n_docs=2, capacity=64, device_authoritative=True)


def test_tenant_anchor_draws_its_id_from_the_given_rng():
    """A tenant's default doc is a host `Doc` whose client id comes from the
    `random` generator, as ytpu's does; a no-op update fires no observer."""
    import random

    from ytpu.core import Doc as YDoc
    from ytpu_torch.sync.server import SyncServer

    saved = random.getstate()
    try:
        random.seed(5)
        a = SyncServer().doc("pad")
        random.seed(5)
        y = YDoc()
    finally:
        random.setstate(saved)
    assert isinstance(a, TDoc)
    assert a.client_id == random.Random(5).getrandbits(32) == y.client_id
    fired = []
    a.observe_update_v1(lambda *args: fired.append(args))
    a.apply_update_v1(b"\x00\x00")
    assert fired == []
    assert a.state_vector() == StateVector()
    assert a.encode_state_as_update_v1() == y.encode_state_as_update_v1() == b"\x00\x00"


# --- the whole slice: the chip phase's cohorts at 16 tenants x 512 slots ------


def _slice_inputs():
    with gzip.open(os.path.join(ROOT, "benches", "data", "b4_log.pkl.gz"), "rb") as f:
        b4 = pickle.load(f)["log"]
    return bench.make_tenants(bench.SMALL, b4, ingest_bench.load_ingest_logs())


def test_whole_slice_small_plan_matches_ytpu():
    plan = bench.SMALL
    tenants = _slice_inputs()
    ids = {t.name: bench.tenant_client_id(t.index) for t in tenants}
    pair = Pair(plan.n_docs, plan.capacity, client_id=ids.__getitem__)
    run_y = bench.drive_writes(pair.y, plan, tenants)
    run_t = bench.drive_writes(pair.t, plan, tenants)
    for f in ("greetings", "connect_svs", "sent", "drained", "writer_outbox", "write_replies", "mid_svs",
              "flush_steps", "merged_rest"):
        assert getattr(run_t, f) == getattr(run_y, f), f
    assert run_t.drained == run_t.sent  # each reader saw its writer's updates, in order
    for t in tenants:  # both sessions connected before any write: empty state vectors
        writer, reader = run_t.greetings[t.name]
        assert writer == reader and writer[0] == _step1({}) and run_t.connect_svs[t.name] == [{}, {}]
    assert pair.t.ingestor.slow_docs > 0 and pair.t.ingestor.fast_docs > 0  # both lanes ran
    for t in tenants:
        pair.check(t.name)
    assert pair.tally["net.bad_frames"] == pair.ytally["net.bad_frames"] == 0

    bench.drive_reads(pair.y, run_y, tenants)
    bench.drive_reads(pair.t, run_t, tenants)
    assert run_t.step1_replies == run_y.step1_replies
    from ytpu.core.state_vector import StateVector as YSV

    many_y = pair.y.device_encode_diff_many([(t.name, YSV()) for t in tenants])
    many_t = pair.t.device_encode_diff_many([(t.name, StateVector()) for t in tenants])
    assert many_t == many_y
    for t in tenants:
        if t.index % 2 == 0:
            assert bench.step2_payload(run_t.step1_replies[t.name]) == many_t[t.index]

    # tenants whose root names were never noted (as a server restored from a
    # checkpoint that holds none): the port names each root as the ingestor
    # adopted it, so its replies stay the same; ytpu names every root by the
    # batch's default
    noted = {s: dict(s._root_names) for s in (pair.y, pair.t)}
    for s in noted:
        s._root_names.clear()
    unnoted_y = pair.y.device_encode_diff_many([(t.name, YSV()) for t in tenants])
    unnoted_t = pair.t.device_encode_diff_many([(t.name, StateVector()) for t in tenants])
    for s, names in noted.items():
        s._root_names.update(names)
    assert unnoted_t == many_t
    default, renamed = pair.t.ingestor.enc.root_name, 0
    for t in tenants:
        root = noted[pair.t][t.name]
        if root == default:
            assert unnoted_y[t.index] == many_y[t.index]
            continue
        renamed += 1
        theirs, ours = TDoc(client_id=1), TDoc(client_id=2)
        theirs.apply_update_v1(unnoted_y[t.index])
        ours.apply_update_v1(unnoted_t[t.index])
        assert theirs.to_json()[default] == ours.to_json()[root] and root not in theirs.to_json()
    assert renamed

    # a fresh port replica catches up from the fan-out (its bytes equal
    # ytpu's, above) and holds what both original servers hold
    fresh = TServer(n_docs=plan.n_docs, capacity=plan.capacity, device_authoritative=True, device="cpu")
    assert bench.catch_up(fresh, tenants, {t.name: many_t[t.index] for t in tenants}) == 1
    for t in tenants:
        assert dict(fresh.device_state_vector(t.name).clocks) == pair.state_vector(t.name)
        assert fresh.device_text(t.name) == pair.y.device_text(t.name)
        assert fresh.device_tree(t.name) == pair.y.device_tree(t.name)
        assert bench.tenant_value(fresh, t) == bench.tenant_value(pair.t, t)

    # a live rebalance in place (the batch is full) of a B4 and an array
    # tenant of the port (both packages' rebalances are held equal above, in
    # test_formatted_text_diff_fanout_and_rebalance): ytpu's unmoved tenant
    # still renders the same
    for t in tenants[::8]:
        before = (bench.tenant_value(pair.t, t), pair.state_vector(t.name))
        assert pair.t.rebalance_tenant(t.name, t.index) == t.index
        assert (bench.tenant_value(pair.t, t), pair.state_vector(t.name)) == before
        assert pair.t.device_text(t.name) == pair.y.device_text(t.name)
        assert pair.t.device_tree(t.name) == pair.y.device_tree(t.name)
