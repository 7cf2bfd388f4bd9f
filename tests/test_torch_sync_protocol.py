"""The port's y-sync wire forms against the JAX package's, byte for byte:
every message kind of `sync/protocol.py` (each package decoding the
other's bytes), state vectors, awareness updates (encode, decode, apply),
and `Update.encode_v1` / `merge_updates_v1` on the committed ingest logs
and a 512-update B4 prefix, merges that leave clock gaps among them."""

import gzip
import os
import pickle
import random

import pytest

from ytpu.compat import merge_updates as y_merge_updates
from ytpu.core.state_vector import StateVector as YStateVector
from ytpu.core.update import Update as YUpdate
from ytpu.sync import awareness as y_aw
from ytpu.sync import protocol as yp
from ytpu_torch.benches.ingest import load_ingest_logs
from ytpu_torch.core.state_vector import StateVector
from ytpu_torch.core.update import Update, merge_updates_v1
from ytpu_torch.sync import awareness as t_aw
from ytpu_torch.sync import protocol as tp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLOCKS = {0: 5, 7: 1, 300: 2**31 + 9, (1 << 40) + 7: 44, 12: 0}


def _messages(p, aw):
    """Every message kind of protocol module `p`, built with its own
    classes (`aw` its awareness module)."""
    sv = (YStateVector if p is yp else StateVector)(CLOCKS)
    upd = aw.AwarenessUpdate({3: aw.AwarenessUpdateEntry(2, '{"c":1}'), 9: aw.AwarenessUpdateEntry(7, "null")})
    return {
        "step1": p.Message.sync(p.SyncMessage.step1(sv)),
        "step1_empty": p.Message.sync(p.SyncMessage.step1(type(sv)())),
        "step2": p.Message.sync(p.SyncMessage.step2(b"\x01\x02\x03")),
        "update": p.Message.sync(p.SyncMessage.update(b"\x00\x00")),
        "awareness": p.Message.awareness(upd),
        "awareness_query": p.Message.awareness_query(),
        "auth_denied": p.Message.auth("no entry"),
        "auth_granted": p.Message.auth(None),
        "busy": p.busy_message("overloaded", 0.25),
        "commit": p.commit_message("tenant-a", (0xDEADBEEF << 32) | 0x12345678, 7),
        "ownership": p.ownership_message(p.OwnershipHandoff("tenant-b", "replica-2", 11)),
        "trace": p.trace_message("trace-xyz", "replica-1"),
        "custom": p.Message.custom(42, b"payload"),
    }


KINDS = sorted(_messages(tp, t_aw))


@pytest.mark.parametrize("kind", KINDS)
def test_message_bytes_equal_and_cross_decode(kind):
    y = _messages(yp, y_aw)[kind].encode_v1()
    t = _messages(tp, t_aw)[kind].encode_v1()
    assert t == y
    # each package decodes the other's bytes and re-encodes them unchanged
    ty = list(tp.message_reader(y))
    yt = list(yp.message_reader(t))
    assert len(ty) == len(yt) == 1
    assert ty[0].encode_v1() == y and yt[0].encode_v1() == t
    assert ty[0].kind == yt[0].kind


def test_extension_bodies_decode_in_both():
    m = _messages(tp, t_aw)
    assert tp.decode_busy(m["busy"].body) == yp.decode_busy(m["busy"].body) == (0.25, "overloaded")
    assert tp.decode_commit(m["commit"].body) == yp.decode_commit(m["commit"].body)
    assert tuple(tp.decode_ownership(m["ownership"].body)) == tuple(yp.decode_ownership(m["ownership"].body))
    assert tp.decode_trace(m["trace"].body) == yp.decode_trace(m["trace"].body) == (1, "trace-xyz", "replica-1")


def test_frames_packed_back_to_back_read_in_order():
    msgs = _messages(tp, t_aw)
    data = b"".join(msgs[k].encode_v1() for k in KINDS)
    assert [m.encode_v1() for m in tp.message_reader(data)] == [m.encode_v1() for m in yp.message_reader(data)]
    with pytest.raises(tp.UnsupportedMessage):
        list(tp.message_reader(b"\x00\x05\x00"))


class _Anchor:
    def __init__(self, client_id):
        self.client_id = client_id


def test_protocol_handlers_answer_alike():
    """`Protocol.handle_message` on an awareness anchor: queries answered,
    auth denial raised, trace frames dropped, unknown tags refused."""
    msgs = _messages(tp, t_aw)
    ymsgs = _messages(yp, y_aw)
    t_a, y_a = t_aw.Awareness(_Anchor(5)), y_aw.Awareness(_Anchor(5))
    t_a.set_local_state({"name": "x"})
    y_a.set_local_state({"name": "x"})
    tr = tp.Protocol().handle_message(t_a, msgs["awareness_query"])
    yr = yp.Protocol().handle_message(y_a, ymsgs["awareness_query"])
    assert tr.encode_v1() == yr.encode_v1()
    assert tp.Protocol().handle_message(t_a, msgs["trace"]) is None
    assert tp.Protocol().handle_message(t_a, msgs["auth_granted"]) is None
    with pytest.raises(tp.PermissionDenied):
        tp.Protocol().handle_message(t_a, msgs["auth_denied"])
    with pytest.raises(tp.UnsupportedMessage):
        tp.Protocol().handle_message(t_a, msgs["custom"])
    assert tp.Protocol().handle_message(t_a, msgs["awareness"]) is None
    assert yp.Protocol().handle_message(y_a, ymsgs["awareness"]) is None
    assert t_a.update().encode_v1() == y_a.update().encode_v1()


@pytest.mark.parametrize("seed", range(4))
def test_state_vector_wire(seed):
    rng = random.Random(seed)
    clocks = {rng.choice([rng.randrange(1 << 8), rng.randrange(1 << 53)]): rng.randrange(0, 1 << 20)
              for _ in range(rng.randrange(0, 40))}
    t, y = StateVector(clocks), YStateVector(clocks)
    assert t.encode_v1() == y.encode_v1()
    assert StateVector.decode_v1(y.encode_v1()) == t
    assert YStateVector.decode_v1(t.encode_v1()) == y
    assert dict(StateVector.decode_v1(y.encode_v1()).clocks) == dict(YStateVector.decode_v1(t.encode_v1()).clocks)


def _awareness_script(aw, seed):
    """Seeded presence traffic through module `aw`: local sets and
    removals, remote updates of every precedence case, outdated removal on
    a fake clock; returns each step's update bytes and events."""
    rng = random.Random(seed)
    now = [1000.0]
    a = aw.Awareness(_Anchor(1), clock=lambda: now[0])
    out = []
    for step in range(40):
        r = rng.random()
        if r < 0.25:
            a.set_local_state({"cursor": rng.randrange(100), "step": step} if rng.random() < 0.8 else None)
        elif r < 0.8:
            client = rng.choice([1, 2, 3, 4])
            prev = a.meta.get(client)
            clock = (prev.clock if prev else 0) + rng.choice([-1, 0, 1, 2])
            json = "null" if rng.random() < 0.3 else f'{{"v":{step}}}'
            ev = a.apply_update(aw.AwarenessUpdate({client: aw.AwarenessUpdateEntry(max(clock, 0), json)}))
            out.append(None if ev is None else (sorted(ev.added), sorted(ev.updated), sorted(ev.removed)))
        else:
            now[0] += rng.choice([10.0, 40_000.0])
            out.append(sorted(a.remove_outdated()))
        out.append(a.update().encode_v1())
    out.append(sorted(a.all_states().items()))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_awareness_apply_and_wire(seed):
    t, y = _awareness_script(t_aw, seed), _awareness_script(y_aw, seed)
    assert t == y
    for b in (x for x in y if isinstance(x, bytes)):
        assert t_aw.AwarenessUpdate.decode_v1(b) == t_aw.AwarenessUpdate(
            {c: t_aw.AwarenessUpdateEntry(*e) for c, e in y_aw.AwarenessUpdate.decode_v1(b).clients.items()})
        assert t_aw.AwarenessUpdate.decode_v1(b).encode_v1() == b


def _logs():
    logs = {name: v["log"] for name, v in load_ingest_logs().items()}
    with gzip.open(os.path.join(ROOT, "benches", "data", "b4_log.pkl.gz"), "rb") as f:
        logs["b4_prefix"] = pickle.load(f)["log"][:512]
    return logs


LOGS = _logs()


@pytest.mark.parametrize("name", sorted(LOGS))
def test_update_encode_v1_round_trips_like_ytpu(name):
    for p in LOGS[name]:
        assert Update.decode_v1(p).encode_v1() == YUpdate.decode_v1(p).encode_v1()
        assert Update.decode_v1(p).state_vector().encode_v1() == YUpdate.decode_v1(p).state_vector().encode_v1()


# (first, stop, step) slices of each log to merge: the whole log, a
# suffix (a client's reply to a greeting), every third update and a
# shuffled half (clock gaps: Skip carriers), pairs in reverse order
MERGES = [(0, None, 1), (100, None, 1), (0, None, 3), (0, 64, 2), (200, 232, -1)]


@pytest.mark.parametrize("name", sorted(LOGS))
@pytest.mark.parametrize("merge", MERGES, ids=lambda m: f"{m[0]}:{m[1]}:{m[2]}")
def test_merge_updates_v1_bytes_equal(name, merge):
    first, stop, step = merge
    log = LOGS[name]
    part = log[first:stop:step] if step > 0 else log[first:stop][::-1]
    got = merge_updates_v1(part)
    assert got == y_merge_updates(*part)
    merged = Update.decode_v1(got)
    if step > 1:
        # every other update left out of one client's run leaves holes
        assert any(c.is_skip for q in merged.blocks.values() for c in q) or len(merged.blocks) > 1
    # a diff against a state vector taken mid-way matches too
    sv = Update.decode_v1(merge_updates_v1(log[: len(log) // 2])).state_vector()
    assert Update.decode_v1(got).encode_diff_v1(sv) == YUpdate.decode_v1(got).encode_diff_v1(
        YStateVector(dict(sv.clocks)))


def test_merge_with_partial_overlap_splits_a_detached_copy():
    """Two updates whose ranges overlap: the merge keeps the covered
    prefix once and the uncovered suffix of the longer carrier, and leaves
    its inputs re-encodable unchanged."""
    from ytpu_torch.core.block import Item
    from ytpu_torch.core.content import ContentString
    from ytpu_torch.core.ids import ID
    from ytpu.core.block import Item as YItem
    from ytpu.core.content import ContentString as YString
    from ytpu.core.ids import ID as YID

    def pair(I, S, Id, U, mk):
        a = U({5: [mk(I, Id(5, 0), None, None, "text", None, S("héllo🙂"))]})
        b = U({5: [mk(I, Id(5, 3), Id(5, 2), None, None, None, S("lo🙂 world"))]})
        return a, b

    mk = lambda I, i, o, r, p, s, c: I(i, None, o, None, r, p, s, c)  # noqa: E731
    t_items = pair(Item, ContentString, ID, Update, mk)
    y_items = pair(YItem, YString, YID, YUpdate, mk)
    before = [u.encode_v1() for u in t_items]
    got = Update.merge(list(t_items)).encode_v1()
    assert got == YUpdate.merge(list(y_items)).encode_v1()
    assert [u.encode_v1() for u in t_items] == before
    # a diff from inside the first item re-bases its origin
    assert Update.decode_v1(got).encode_diff_v1(StateVector({5: 2})) == YUpdate.decode_v1(got).encode_diff_v1(
        YStateVector({5: 2}))
