"""The port's mirrored `DeviceSyncServer` (the default mode: a host `Doc`
per tenant answers the protocol and the device batch shadows it) against
ytpu's on the CPU, both fed the same frames: the chip phase's four tenant
cohorts at the `SMALL` plan's width and logs (``ytpu_torch/benches/
sync_server.py``) in four write rounds (`PLAN`), each log's rest then as
one SyncStep2 frame. ytpu compiles a decode program for each round (its
intern tables grow every round), so the rounds are what the file's time
is made of.

One test drives each package's server through the writes and the reads, a
fan-out, releases, a demotion, rebalances, a late tenant on a freed slot
and a checkpoint, then holds the port's replies, broadcasts, host docs,
device state and checkpoint to ytpu's, and the port's device state to its
own host docs (one test, not a module fixture: the suite's workers would
each run a fixture again). A plain `SyncServer` serves
content from its default doc factory, as ytpu's does."""

import dataclasses
import gzip
import os
import pickle
import sys

import pytest

from ytpu_torch.benches import ingest as ingest_bench
from ytpu_torch.benches import sync_server as bench
from ytpu_torch.convert import state_to_numpy
from ytpu_torch.core.doc import Doc as TDoc
from ytpu_torch.core.state_vector import StateVector
from ytpu_torch.models import batch_doc as tbd
from ytpu_torch.models import checkpoint as tck
from ytpu_torch.sync.device_server import DeviceSyncServer as TServer
from ytpu_torch.sync.protocol import Message, SyncMessage

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RELEASED = (1, 5, 9, 13)  # one tenant of each cohort
DEMOTED = 2
REBALANCED = (14, 15)  # two big-client tenants: one log, one re-ingest shape
LATE = "late-tenant"
# SMALL cut to four rounds; the lagged B4 tenants start in round 2 and the
# swapped ones still send a swapped pair in the rounds
PLAN = dataclasses.replace(bench.SMALL, rounds=4, lag_step=2)


def _step1(clocks):
    return Message.sync(SyncMessage.step1(StateVector(clocks))).encode_v1()


def _update(payload):
    return Message.sync(SyncMessage.update(payload)).encode_v1()


def _drive(package, tenants, plan, ids, tmp):
    """Everything one package's mirrored server produces on the plan."""
    if package == "ytpu":
        from ytpu.core import Doc
        from ytpu.core.state_vector import StateVector as SV
        from ytpu.models import batch_doc as bd
        from ytpu.models import checkpoint as ck
        from ytpu.sync.device_server import DeviceSyncServer as Server

        server = Server(n_docs=plan.n_docs, capacity=plan.capacity, doc_factory=lambda n: Doc(client_id=ids[n]))
    else:
        Doc, SV, bd, ck = TDoc, StateVector, tbd, tck
        server = TServer(n_docs=plan.n_docs, capacity=plan.capacity, device="cpu",
                         doc_factory=lambda n: Doc(client_id=ids[n]))
    out = {"server": server}
    run = bench.drive_writes(server, plan, tenants)
    bench.drive_reads(server, run, tenants)
    out["run"] = run
    ing = server.ingestor
    out["planes"] = state_to_numpy(bd.ensure_origin_slot(ing.state))
    out["host"] = {t.name: server.doc(t.name).encode_state_as_update_v1() for t in tenants}
    out["host_sv"] = {t.name: dict(server.doc(t.name).state_vector().clocks) for t in tenants}
    out["device_sv"] = {t.name: dict(server.device_state_vector(t.name).clocks) for t in tenants}
    out["tenant_sv"] = {t.name: dict(server.tenant_state_vector(t.name).clocks) for t in tenants}
    out["trees"] = [bd.get_tree(ing.state, d, ing.payloads, ing.enc.keys, interner=ing.enc.interner)
                    for d in range(ing.n_docs)]
    out["strings"] = [bd.get_string(ing.state, d, ing.payloads) for d in range(ing.n_docs)]
    out["fanout"] = server.device_encode_diff_many([(t.name, SV()) for t in tenants])
    out["primary_roots"] = dict(ing.primary_roots)

    # releases: a second write to each released tenant goes to its host doc
    # only; a late tenant takes a freed slot
    extra = {}
    for i in RELEASED:
        t = tenants[i]
        server.release_tenant(t.name)
        server.release_tenant(t.name)  # a no-op the second time
        c = Doc(client_id=900 + i)
        c.apply_update_v1(server.doc(t.name).encode_state_as_update_v1())
        with c.transact() as txn:
            if t.cohort == "array":
                c.get_array(next(iter(c.store.types))).insert(txn, 0, "after release")
            elif t.cohort == "map_xml":
                c.get_map("m").insert(txn, "released", i)
            else:
                c.get_text(next(iter(c.store.types))).insert(txn, 0, "after release ")
        w, r = run.sessions[t.name]
        extra[t.name] = {
            "write_replies": server.receive_frames(w, _update(c.encode_state_as_update_v1(
                SV(dict(server.doc(t.name).state_vector().clocks))))),
            "reader_outbox": server.drain(r),
            "step1": server.receive_frames(r, _step1({})),
            "greeting": server.connect_frames(t.name)[1],
            "host": server.doc(t.name).encode_state_as_update_v1(),
            "queued": server.pending_device_updates(),
        }
    out["released"] = extra
    out["free_slots"] = list(server._free_slots)
    out["late_greeting"] = server.connect_frames(LATE)[1]
    out["late_slot"] = server.slot_of(LATE)
    out["after_release_steps"] = server.flush_device()

    # a demotion, then two rebalances into the freed slots
    server._demote_to_host(tenants[DEMOTED].name)
    out["demoted"] = {"host_tenants": sorted(server._host_tenants), "free": list(server._free_slots),
                      "host": server.doc(tenants[DEMOTED].name).encode_state_as_update_v1()}
    out["rebalanced"] = {}
    for i in REBALANCED:
        t = tenants[i]
        slot = server.rebalance_tenant(t.name)
        out["rebalanced"][t.name] = (slot, dict(server.device_state_vector(t.name).clocks),
                                     bench.tenant_value(server, t) if package == "ytpu_torch" else None)
    with pytest.raises(KeyError):  # a host-resident tenant has no slot to move
        server.rebalance_tenant(tenants[DEMOTED].name)
    out["slot_of"] = dict(server._slot_of)
    out["planes_after"] = state_to_numpy(bd.ensure_origin_slot(ing.state))
    path = os.path.join(tmp, package)
    with pytest.MonkeyPatch.context() as mp:
        # ytpu writes orbax arrays where orbax imports, which the port refuses
        mp.setitem(sys.modules, "orbax", None)
        mp.setitem(sys.modules, "orbax.checkpoint", None)
        ck.save_device_server(path, server)
    out["checkpoint"] = path
    return out


def _both(tmp):
    """Both packages' runs on `PLAN`'s frames."""
    with gzip.open(os.path.join(ROOT, "benches", "data", "b4_log.pkl.gz"), "rb") as f:
        b4 = pickle.load(f)["log"]
    plan = PLAN
    logs = ingest_bench.load_ingest_logs()
    tenants = bench.make_tenants(plan, b4, logs)
    ids = {t.name: bench.tenant_client_id(t.index) for t in tenants}
    ids[LATE] = 555
    y = _drive("ytpu", tenants, plan, ids, tmp)
    t = _drive("ytpu_torch", tenants, plan, ids, tmp)
    return {"y": y, "t": t, "tenants": tenants, "ids": ids}


def test_default_server_is_mirrored_on_the_given_device():
    s = TServer(n_docs=2, capacity=64, device="cpu")
    assert s.device_authoritative is False and s.ingestor.device.type == "cpu"
    assert isinstance(s.doc("a"), TDoc)


def _check_replies_and_broadcasts_match_ytpu(both):
    ry, rt = both["y"]["run"], both["t"]["run"]
    for f in ("greetings", "connect_svs", "sent", "drained", "writer_outbox", "write_replies", "mid_svs",
              "flush_steps", "merged_rest", "step1_replies"):
        assert getattr(rt, f) == getattr(ry, f), f
    for t in both["tenants"]:
        # greetings carry the host doc's state vector; the reader drained
        # one update frame for each host transaction that changed the doc
        assert rt.greetings[t.name][0][0] == _step1({})
        assert rt.writer_outbox[t.name] == [] and rt.drained[t.name]
    assert rt.write_replies == []


def _check_host_docs_match_ytpu_and_the_committed_values(both):
    y, t = both["y"], both["t"]
    assert t["host"] == y["host"]
    assert t["host_sv"] == y["host_sv"]
    for ten in both["tenants"]:
        # each host doc holds what its writer sent: the tenant's log applied
        # in order to a fresh doc
        want = TDoc(client_id=1)
        for p in ten.log:
            want.apply_update_v1(p)
        assert bench.host_value(_doc_of(t["host"][ten.name]), ten) == bench.host_value(want, ten)
        assert want.state_vector() == _doc_of(t["host"][ten.name]).state_vector()


def _doc_of(update: bytes) -> TDoc:
    d = TDoc(client_id=3)
    d.apply_update_v1(update)
    return d


def _value_before_releases(run, ten):
    """Tenant `ten`'s host value in `run` before the releases changed any."""
    return bench.host_value(_doc_of(run["host"][ten.name]), ten)


def _check_device_state_matches_ytpu(both):
    y, t = both["y"], both["t"]
    for name, want in y["planes"].items():
        assert (t["planes"][name] == want).all(), name
    assert t["trees"] == y["trees"]
    assert t["strings"] == y["strings"]
    assert t["device_sv"] == y["device_sv"]
    assert t["tenant_sv"] == y["tenant_sv"] == t["host_sv"]
    # a fan-out reply names the tenant's primary root as the ingestor
    # adopted it; ytpu's mirrored server names every root by the batch's
    # default, so the replies agree where the tenant's root is that name
    roots, default = t["primary_roots"], t["server"].ingestor.enc.root_name
    same_root = [x.index for x in both["tenants"] if roots.get(x.index) == default]
    assert same_root and len(same_root) < len(both["tenants"])
    assert [t["fanout"][i] for i in same_root] == [y["fanout"][i] for i in same_root]
    for x in both["tenants"]:
        if x.index in same_root:
            continue
        # the other tenants' replies differ in that name only: ytpu's puts
        # the content under the default root, the port's under the adopted
        adopted = roots[x.index]
        got, theirs = _doc_of(t["fanout"][x.index]).to_json(), _doc_of(y["fanout"][x.index]).to_json()
        assert adopted in got and default in theirs and adopted not in theirs
        assert theirs[default] == got[adopted]
    _assert_live_rows_equal(t["planes_after"], y["planes_after"])


def _assert_live_rows_equal(got, want):
    """Equal planes in each slot's live rows (after a slot is reset, its dead
    rows keep stale cache words in ytpu; the port clears them)."""
    n = want["n_blocks"]
    assert (got["n_blocks"] == n).all()
    for name, w in want.items():
        if w.ndim == 2:
            for d in range(w.shape[0]):
                assert (got[name][d, : n[d]] == w[d, : n[d]]).all(), (name, d)
        else:
            assert (got[name] == w).all(), name


def _check_device_shadows_the_host_docs(both):
    t, server = both["t"], both["t"]["server"]
    for ten in both["tenants"]:
        assert t["device_sv"][ten.name] == t["host_sv"][ten.name]
        host = TDoc(client_id=4)
        host.apply_update_v1(t["host"][ten.name])
        fresh = TDoc(client_id=5)
        fresh.apply_update_v1(t["fanout"][ten.index])
        assert fresh.to_json() == host.to_json()
        assert fresh.state_vector() == host.state_vector()
        # the reader's SyncStep1 reply comes from the host doc
        reply = TDoc(client_id=6)
        reply.apply_update_v1(bench.step2_payload(t["run"].step1_replies[ten.name]))
        if ten.index % 2 == 0:
            assert reply.to_json() == host.to_json()
    for ten in both["tenants"]:
        if ten.index not in RELEASED and ten.index != DEMOTED and ten.cohort in ("b4", "big_client_text"):
            assert bench.tenant_value(server, ten) == bench.host_value(server.doc(ten.name), ten)


def _check_release_demote_and_rebalance_match_ytpu(both):
    y, t = both["y"], both["t"]
    assert t["released"] == y["released"]
    for name, r in t["released"].items():
        assert r["write_replies"] == [] and r["queued"] == 0  # the host doc only
        assert len(r["reader_outbox"]) == 1  # the write reached the reader
        assert r["greeting"][0] == _step1(dict(_doc_of(r["host"]).state_vector().clocks))
        assert bench.step2_payload(r["step1"]) == r["host"]
    assert t["free_slots"] == y["free_slots"] and len(t["free_slots"]) == len(RELEASED)
    assert t["late_slot"] in [both["tenants"][i].index for i in RELEASED]  # a freed slot, reused
    assert t["late_greeting"] == y["late_greeting"]
    assert t["after_release_steps"] == y["after_release_steps"] == 0
    assert t["demoted"] == y["demoted"]
    assert {k: v[:2] for k, v in t["rebalanced"].items()} == {k: v[:2] for k, v in y["rebalanced"].items()}
    for name, (slot, sv, value) in t["rebalanced"].items():
        assert sv == t["device_sv"][name]
        ten = next(x for x in both["tenants"] if x.name == name)
        assert value == _value_before_releases(t, ten)  # unchanged by the move
    assert t["slot_of"] == y["slot_of"]


def _check_checkpoint_round_trip_and_ytpu_checkpoint(both):
    t, y = both["t"], both["y"]
    ids = both["ids"]
    for path, src in ((t["checkpoint"], t), (y["checkpoint"], y)):
        server = tck.load_device_server(path, device="cpu", doc_factory=lambda n: TDoc(client_id=ids[n]))
        assert server.device_authoritative is False
        assert server._host_tenants == set(src["demoted"]["host_tenants"])
        assert not server._host_tenants & set(server._slot_of)  # host tenants take no slot
        for ten in both["tenants"]:
            # a doc rebuilt from its state update encodes as a fresh doc given
            # that state does (its blocks squash in one transaction)
            saved = src["server"].doc(ten.name)
            got = server.doc(ten.name)
            fresh = _doc_of(saved.encode_state_as_update_v1())
            assert got.encode_state_as_update_v1() == fresh.encode_state_as_update_v1()
            assert got.to_json() == saved.to_json()
            assert got.state_vector().clocks == saved.state_vector().clocks
            greeting = server.connect_frames(ten.name)[1]
            assert greeting[0] == _step1(dict(saved.state_vector().clocks))
        assert server._slot_of == t["slot_of"]
        _assert_live_rows_equal(state_to_numpy(tbd.ensure_origin_slot(server.ingestor.state)), t["planes_after"])


def test_mirrored_server_matches_ytpu(tmp_path):
    """One run of each package's server (ytpu's compiles a program per
    flush shape, so the run is made once and every check reads it)."""
    both = _both(str(tmp_path))
    _check_replies_and_broadcasts_match_ytpu(both)
    _check_host_docs_match_ytpu_and_the_committed_values(both)
    _check_device_state_matches_ytpu(both)
    _check_device_shadows_the_host_docs(both)
    _check_release_demote_and_rebalance_match_ytpu(both)
    _check_checkpoint_round_trip_and_ytpu_checkpoint(both)


def test_plain_sync_server_serves_content():
    """`SyncServer()` builds a host `Doc` per tenant and serves it: a write
    is applied and broadcast, a SyncStep1 is answered from the doc, as
    ytpu's plain server does."""
    from ytpu.core import Doc as YDoc
    from ytpu.sync.server import SyncServer as YSyncServer
    from ytpu_torch.sync.server import SyncServer

    servers = [SyncServer(doc_factory=lambda n: TDoc(client_id=3)),
               YSyncServer(doc_factory=lambda n: YDoc(client_id=3))]
    c = YDoc(client_id=8)
    with c.transact() as txn:
        c.get_text("t").insert(txn, 0, "served by the host doc")
    results = []
    for s in servers:
        w, g = s.connect_frames("pad")
        r, _ = s.connect_frames("pad")
        res = [g, s.receive_frames(w, _update(c.encode_state_as_update_v1())), s.drain(r), s.drain(w),
               s.receive_frames(r, _step1({})), s.receive_frames(r, _step1({8: 5}))]
        res.append(s.doc("pad").encode_state_as_update_v1())
        res.append(dict(s.tenant_state_vector("pad").clocks))
        results.append(res)
    assert results[0] == results[1]
    assert servers[0].doc("pad").get_text("t").get_string() == "served by the host doc"
    assert servers[0].metrics["sync.updates_applied"] == 1
