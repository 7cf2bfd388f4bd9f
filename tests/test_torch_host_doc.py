"""The port's host CRDT (`ytpu_torch.core.Doc` and `ytpu_torch.types`)
against ytpu's on the same seeded operations and client ids
(``tests/_torch_host_doc_cases.py``): every transaction's v1 and v2
update, the deep events' paths, deltas and key changes, the sub-document
events, and at the end the v1 and v2 state updates, the state vector, the
diff against a middle state vector, the values and, with gc off, the
state at a middle snapshot, for each doc of the scenario. Every scenario
runs with gc on and with gc off."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _torch_host_doc_cases as cases  # noqa: E402

FIELDS = ("updates_v1", "updates_v2", "events", "subdocs", "finals")


@pytest.mark.parametrize("gc", [True, False], ids=["gc", "no_gc"])
@pytest.mark.parametrize("scenario", cases.SCENARIOS)
def test_scenario_matches_ytpu(scenario, gc):
    want = cases.run(scenario, "ytpu", gc)
    got = cases.run(scenario, "ytpu_torch", gc)
    for name in FIELDS:
        assert getattr(got, name) == getattr(want, name), name
    assert want.finals and (want.updates_v1 or scenario == "peers")
    if scenario == "peers":
        # the seeded exchange orders leave updates waiting in the stash
        assert sum(len(v["stashes"]) for k, v in want.finals.items() if "round" in k) > 0
    if not gc and scenario in cases.AUTHORED and scenario != "peers":
        assert any("at_snapshot" in v for v in want.finals.values())


def test_state_carries_across_packages():
    """A doc's state update, written by either package, applied to a fresh
    doc of each package gives the source's values, and the two fresh docs
    the same v1 and v2 state updates: the wire update carries the host
    state between the packages."""
    for scenario in ("text", "map", "xml", "weak", "subdocs", "log_map_xml"):
        for src in ("ytpu", "ytpu_torch"):
            for name, final in cases.run(scenario, src, True).finals.items():
                out = []
                for dst in ("ytpu", "ytpu_torch"):
                    P = cases.pkg(dst)
                    d = P.Doc(options=P.Options(client_id=99, guid="carrier"))
                    d.apply_update_v1(final["v1"])
                    d2 = P.Doc(options=P.Options(client_id=98, guid="carrier"))
                    d2.apply_update_v2(final["v2"])
                    assert cases.norm(d.to_json()) == cases.norm(d2.to_json()) == final["json"]
                    out.append((d.encode_state_as_update_v1(), d.encode_state_as_update_v2(),
                                d2.encode_state_as_update_v1()))
                assert out[0] == out[1], (scenario, src, name)


def test_port_doc_defaults_and_observers():
    """`Doc()` draws its client id and guid as ytpu's does; the v1 observer
    skips a no-op transaction; the after-transaction, cleanup and update
    observers fire in ytpu's order."""
    import random

    from ytpu.core import Doc as YDoc
    from ytpu_torch.core import Doc

    saved = random.getstate()
    try:
        random.seed(11)
        a = Doc()
        random.seed(11)
        b = YDoc()
    finally:
        random.setstate(saved)
    assert a.client_id == b.client_id
    order = {}
    for d in (Doc(client_id=4), YDoc(client_id=4)):
        seen = order.setdefault(type(d).__module__, [])
        d.observe_after_transaction(lambda txn, s=seen: s.append("after"))
        d.observe_transaction_cleanup(lambda txn, s=seen: s.append("cleanup"))
        d.observe_update_v1(lambda p, o, t, s=seen: s.append(("v1", p)))
        d.observe_update_v2(lambda p, o, t, s=seen: s.append(("v2", p)))
        with d.transact():
            pass
        with d.transact() as txn:
            d.get_text("t").insert(txn, 0, "x")
    assert order["ytpu_torch.core.doc"] == order["ytpu.core.doc"]
    assert ("v1", b"\x00\x00") not in order["ytpu.core.doc"]
