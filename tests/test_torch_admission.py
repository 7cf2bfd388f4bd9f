"""The port's admission controller against the JAX package's, on the CPU,
and the sync servers wired to it.

Unit level: `TokenBucket` and `AdmissionController` take the same seeded
decision sequences under injected clocks (admit / throttle / live
retunes / per-tenant overrides / the ``admission.reject`` fault site) and
must decide, wait, reply (`busy_reply` bytes) and count (registry deltas)
the same. End to end: the plain `SyncServer` and `DeviceSyncServer` on
the CPU, in both serving modes and under each policy, get the same frames
as the JAX package's servers (writers resending what a Busy reply
deferred, reconnecting when shed) and must give the same replies,
registry counts and final state. Neither package's registry or injector
is reset: counts are deltas, and armed faults are cleared in ``finally``.
"""

import importlib

import numpy as np
import pytest

from ytpu.utils.faults import faults as y_faults
from ytpu.utils.metrics import metrics as y_metrics
from ytpu_torch.core.doc import Doc as TDoc
from ytpu_torch.sync.protocol import MSG_BUSY, Message, SyncMessage, message_reader
from ytpu_torch.utils.faults import faults as t_faults
from ytpu_torch.utils.metrics import metrics as t_metrics

from _torch_obs import FakeClock, ObjectDelta, RegistryDelta, admission_families

y_adm = importlib.import_module("ytpu.serving.admission")
t_adm = importlib.import_module("ytpu_torch.serving.admission")
y_faults_mod = importlib.import_module("ytpu.utils.faults")
t_faults_mod = importlib.import_module("ytpu_torch.utils.faults")
PACKAGES = ((y_adm, y_faults, y_metrics), (t_adm, t_faults, t_metrics))
FAULT_MODULES = {y_adm: y_faults_mod, t_adm: t_faults_mod}
# the servers' families, which each server looks up in the registry; the
# admission and fault counters are read from the objects their modules
# made at import (`ObjectDelta`)
FAMILIES = ("sync.", "net.")
# gauges the servers set (not add to): their deltas depend on what earlier
# tests left in each process-wide registry, so their final values compare
SET_GAUGES = ("sync.outbox_depth", "sync.device_queue_depth", "sync.device_slots_assigned",
              "sync.last_dispatch_unix")


def _decide(fn):
    """``fn()``'s outcome as data: ``("ok", value)`` or the refusal's
    type, reason, tenant, hint and message."""
    try:
        return ("ok", fn())
    except Exception as e:
        return (type(e).__name__, getattr(e, "reason", None), getattr(e, "tenant", None),
                round(getattr(e, "retry_after_s", 0.0), 12), str(e))


def test_token_bucket_matches_ytpu():
    rng = np.random.default_rng(7)
    ops = [("deficit", float(rng.integers(1, 4))) if k < 6 else ("debt", float(rng.integers(1, 20))) if k < 9
           else ("rate", float(rng.integers(5, 50)), None if rng.integers(2) else float(rng.integers(1, 30)))
           for k in rng.integers(0, 10, 120)]
    outs = []
    for mod, _, _ in PACKAGES:
        clock = FakeClock(step=0.013)
        b = mod.TokenBucket(20.0, 8.0, clock=clock.monotonic)
        out = []
        for op in ops:
            if op[0] == "deficit":
                out.append(round(b.deficit(op[1]), 12))
            elif op[0] == "debt":
                out.append(round(b.take_debt(op[1]), 12))
            else:
                b.set_rate(op[1], op[2])
                out.append((b.rate, b.burst))
        outs.append(out)
    assert outs[1] == outs[0]
    for mod, _, _ in PACKAGES:
        with pytest.raises(ValueError):
            mod.TokenBucket(0)


def _controller_script(mod, clock, sleeps):
    ctl = mod.AdmissionController(max_queue=3, rate=40.0, burst=6.0, clock=clock.monotonic,
                                  sleep=lambda s: (sleeps.append(round(s, 12)), clock.sleep(s)))
    rng = np.random.default_rng(23)
    out = []
    for i in range(150):
        k = int(rng.integers(12))
        tenant = f"t{int(rng.integers(3))}"
        if k < 7:
            depth, n = int(rng.integers(0, 5)), int(rng.integers(1, 3))
            out.append(_decide(lambda: ctl.admit(tenant, queue_depth=depth, n=n)))
        elif k == 7:
            out.append(round(ctl.throttle(int(rng.integers(1, 12))), 12))
        elif k == 8:
            ctl.set_tenant_rate(tenant, None if rng.integers(3) == 0 else float(rng.integers(5, 80)))
        elif k == 9:
            ctl.set_tenant_queue_bound(tenant, None if rng.integers(3) == 0 else int(rng.integers(0, 4)))
        elif k == 10:
            ctl.set_rate(None if rng.integers(4) == 0 else float(rng.integers(10, 60)))
        else:
            ctl.set_queue_bound(None if rng.integers(4) == 0 else int(rng.integers(1, 5)))
        if i % 10 == 0:
            out.append(ctl.policy_snapshot())
    return out


def test_controller_decisions_match_ytpu():
    results = []
    for mod, _, _ in PACKAGES:
        tally = ObjectDelta(*admission_families(mod))
        sleeps = []
        out = _controller_script(mod, FakeClock(step=0.011), sleeps)
        results.append((out, sleeps, tally.changed()))
    assert results[1] == results[0]
    out, sleeps, counts = results[1]
    kinds = {o[0] for o in out if isinstance(o, tuple)}
    assert {"ok", "QueueFull", "RateLimited"} <= kinds and sleeps
    assert counts["admission.policy_changes"] > 0 and counts['admission.rejected{reason="queue_full"}'] > 0
    for mod, _, _ in PACKAGES:
        with pytest.raises(ValueError):
            mod.AdmissionController(policy="lifo")


def test_busy_reply_and_reject_fault_match_ytpu():
    results = []
    for mod, faults, _ in PACKAGES:
        fm = FAULT_MODULES[mod]
        tally = ObjectDelta(*admission_families(mod), fm._INJECTED, fm._INJECTED_BY_SITE)
        ctl = mod.AdmissionController(max_queue=None, clock=FakeClock().monotonic)
        faults.arm("admission.reject", n=2, tenant="hot")
        try:
            out = [_decide(lambda t=t: ctl.admit(t)) for t in ("cold", "hot", "hot", "hot", "cold")]
        finally:
            faults.clear()
        replies = [mod.AdmissionController.busy_reply(e) for e in (
            mod.QueueFull("a", "full"), mod.RateLimited("b", "rate", retry_after_s=0.25), mod.Overload("c", "x", 1.5))]
        results.append((out, replies, tally.changed()))
    assert results[1] == results[0]
    out, replies, counts = results[1]
    assert [o[0] for o in out] == ["ok", "QueueFull", "QueueFull", "ok", "ok"]
    assert counts['admission.rejected{reason="injected"}'] == 2
    for r in replies:
        assert next(iter(message_reader(r))).kind == MSG_BUSY


# --- the servers ----------------------------------------------------------------

N_TENANTS, ROUNDS, PER_ROUND = 2, 4, 3


def _updates():
    """Each tenant's updates: one-character inserts by its own client (the
    same bytes for both packages' servers)."""
    out = {}
    for t in range(N_TENANTS):
        doc, prev, ups = TDoc(client_id=70 + t), None, []
        for i in range(ROUNDS * PER_ROUND):
            with doc.transact() as txn:
                doc.get_text("text").insert(txn, i, "abcdefgh"[(i + t) % 8])
            ups.append(doc.encode_state_as_update_v1(prev))
            prev = doc.state_vector()
        out[f"ten{t}"] = ups
    return out


def _update_frame(payload):
    return Message.sync(SyncMessage.update(payload)).encode_v1()


def _drive(make_server, adm_mod, policy, updates):
    """Writers send ``PER_ROUND`` updates a round (resending what a Busy
    reply deferred first, reconnecting after a shed), then the server
    flushes; readers drain. Returns everything observable."""
    clock = FakeClock(step=0.004)
    server = make_server()
    server.admission = adm_mod.AdmissionController(max_queue=2, rate=200.0, burst=4.0, policy=policy,
                                                   clock=clock.monotonic)
    out = {"replies": [], "drained": [], "steps": []}
    writers = {t: server.connect_frames(t)[0] for t in updates}
    readers = {t: server.connect_frames(t)[0] for t in updates}
    todo = {t: [] for t in updates}
    for r in range(ROUNDS):
        for t, ups in updates.items():
            todo[t] += ups[r * PER_ROUND:(r + 1) * PER_ROUND]
            resend = []
            for p in todo[t]:
                if writers[t].dead:
                    writers[t] = server.connect_frames(t)[0]
                replies = server.receive_frames(writers[t], _update_frame(p))
                out["replies"].append(replies)
                if any(next(iter(message_reader(x))).kind == MSG_BUSY for x in replies):
                    resend.append(p)
            todo[t] = resend
        out["steps"].append(getattr(server, "flush_device", lambda: 0)())
        out["drained"].append({t: server.drain(s) for t, s in readers.items()})
    server.admission = None
    for t in updates:  # the deferred rest, unthrottled
        for p in todo[t]:
            server.receive_frames(writers[t] if not writers[t].dead else server.connect_frames(t)[0],
                                  _update_frame(p))
    getattr(server, "flush_device", lambda: 0)()
    out["host"] = {t: server.doc(t).encode_state_as_update_v1() for t in updates}
    if hasattr(server, "device_text"):
        out["device"] = {t: (server.device_text(t), dict(server.device_state_vector(t).clocks)) for t in updates}
    out["applied_local"] = server.applied_local
    return out


def _servers(kind):
    from ytpu.core import Doc as YDoc
    from ytpu.sync.device_server import DeviceSyncServer as YDevice
    from ytpu.sync.server import SyncServer as YPlain
    from ytpu_torch.sync.device_server import DeviceSyncServer as TDevice
    from ytpu_torch.sync.server import SyncServer as TPlain

    ids = lambda name: 500 + int(name[3:])  # noqa: E731 -- the servers' own client ids
    if kind == "plain":
        return (lambda: YPlain(doc_factory=lambda n: YDoc(client_id=ids(n))),
                lambda: TPlain(doc_factory=lambda n: TDoc(client_id=ids(n))))
    auth = kind == "device_authoritative"
    return (lambda: YDevice(n_docs=N_TENANTS, capacity=64, device_authoritative=auth,
                            doc_factory=lambda n: YDoc(client_id=ids(n))),
            lambda: TDevice(n_docs=N_TENANTS, capacity=64, device_authoritative=auth, device="cpu",
                            doc_factory=lambda n: TDoc(client_id=ids(n))))


@pytest.mark.parametrize("kind", ["plain", "mirrored", "device_authoritative"])
def test_servers_under_each_policy_match_ytpu(kind):
    updates = _updates()
    made = _servers(kind)
    for policy in ("defer", "drop", "shed"):
        runs = []
        for make, (mod, _, reg) in zip(made, PACKAGES):
            tally, adm_tally = RegistryDelta(reg), ObjectDelta(*admission_families(mod))
            run = _drive(make, mod, policy, updates)
            run["counts"] = {k: v for k, v in tally.changed(FAMILIES).items() if not k.startswith(SET_GAUGES)}
            run["counts"].update(adm_tally.changed())
            if kind != "plain":  # set by the device server itself
                run["gauges"] = [reg.gauge(g).value for g in SET_GAUGES[1:3]]
            runs.append(run)
        y, t = runs
        assert t == y, policy
        refused = sum(v for k, v in t["counts"].items() if k.startswith("admission.rejected"))
        assert refused > 0, policy
        if policy == "defer":
            assert t["counts"]["sync.busy_replies"] == refused
            assert t["counts"]["sync.updates_applied"] == N_TENANTS * ROUNDS * PER_ROUND
        elif policy == "drop":
            assert t["counts"]['net.sessions_dropped{reason="update_drop"}'] == refused
        else:
            assert t["counts"]['net.sessions_dropped{reason="shed"}'] == refused
