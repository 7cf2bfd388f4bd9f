"""The port's checkpoint files against the JAX package's, on the CPU: an
ingestor checkpoint the JAX package wrote (its arrays in ``arrays.npz``,
orbax blocked) loads in the port to an equal state, with its pending
stashes, state vectors, retained wire chunks and interners, and the
steps after the load give the state the JAX package's unbroken ingestor
reaches; the port's own round trips of a state, an ingestor and a
device-authoritative sync server; and what the loader refuses.
"""

import os
import pickle
import sys

import numpy as np
import pytest
import torch

from ytpu.core import Doc
from ytpu.core.state_vector import StateVector as JStateVector
from ytpu.models import checkpoint as jck
from ytpu.models.ingest import BatchIngestor as JIngestor
from ytpu.native import available as native_available

from ytpu_torch.core.state_vector import StateVector
from ytpu_torch.models import checkpoint as tck
from ytpu_torch.models.batch_doc import get_map, get_string
from ytpu_torch.models.ingest import BatchIngestor
from ytpu_torch.sync.device_server import DeviceSyncServer
from ytpu_torch.sync.protocol import Message, SyncMessage

torch.set_num_threads(1)

needs_native = pytest.mark.skipif(not native_available(), reason="native codec unavailable (JAX ingest lanes)")

N_DOCS, CAPACITY = 2, 256


def _updates():
    """Doc 0's text edits (one insert, a dependent insert, a delete) and
    doc 1's map writes, each transaction one update."""
    text, mp = Doc(client_id=9), Doc(client_id=11)
    t_up, m_up = [], []
    text.observe_update_v1(lambda p, o, t: t_up.append(p))
    mp.observe_update_v1(lambda p, o, t: m_up.append(p))
    for i, s in enumerate(("base", "-tail", "!")):
        with text.transact() as txn:
            text.get_text("text").insert(txn, len(text.get_text("text").get_string()), s)
        with mp.transact() as txn:
            mp.get_map("m").insert(txn, f"k{i}", i)
    with text.transact() as txn:
        text.get_text("text").remove_range(txn, 1, 2)
    return t_up, m_up


def _steps():
    """Four apply_bytes steps: doc 0 receives a dependent update first (a
    pending stash), then the update it waits on."""
    t, m = _updates()
    return [[t[1], m[0]], [t[0], m[1]], [t[2], m[2]], [t[3], None]]


SAVE_AFTER = 1  # steps before the checkpoint


def _block_orbax(mp):
    """The JAX package writes orbax arrays where orbax imports: block it,
    so that it writes arrays.npz."""
    mp.setitem(sys.modules, "orbax", None)
    mp.setitem(sys.modules, "orbax.checkpoint", None)


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """The JAX ingestor's checkpoint after SAVE_AFTER steps, and the same
    ingestor after every step."""
    path = str(tmp_path_factory.mktemp("jax") / "ing")
    ing = JIngestor(n_docs=N_DOCS, capacity=CAPACITY)
    mp = pytest.MonkeyPatch()
    _block_orbax(mp)
    try:
        for k, step in enumerate(_steps()):
            if k == SAVE_AFTER:
                jck.save_ingestor(path, ing)
            ing.apply_bytes(step)
    finally:
        mp.undo()
    return path, ing


def _assert_state_equal(t_state, j_state):
    for name in t_state.blocks._fields:
        np.testing.assert_array_equal(getattr(t_state.blocks, name).numpy(),
                                      np.asarray(getattr(j_state.blocks, name)), err_msg=name)
    for name in ("start", "n_blocks", "error"):
        np.testing.assert_array_equal(getattr(t_state, name).numpy(), np.asarray(getattr(j_state, name)))


def _assert_ingestors_equal(t, j):
    from ytpu_torch.models.batch_doc import ensure_origin_slot as t_ensure
    from ytpu.models.batch_doc import ensure_origin_slot as j_ensure

    _assert_state_equal(t_ensure(t.state), j_ensure(j.state))
    assert [sv.clocks for sv in t.svs] == [sv.clocks for sv in j.svs]
    assert [sorted(p) for p in t._pending] == [sorted(p) for p in j._pending]
    assert [ds.clients for ds in t._pending_ds] == [ds.clients for ds in j._pending_ds]
    assert t.payloads.total_bytes == j.payloads.total_bytes
    assert [(b, f.tobytes()) for b, f in t.payloads._chunks] == [(b, f.tobytes()) for b, f in j.payloads._chunks]
    assert t.enc.interner.from_idx == j.enc.interner.from_idx
    assert t.enc.keys.names == j.enc.keys.names
    assert len(t.enc.payloads.items) == len(j.enc.payloads.items)
    assert t.primary_roots == j.primary_roots and t._anchored_roots == j._anchored_roots
    assert t._key_hashes == j._key_hashes and t._client_hashes == j._client_hashes


@needs_native
def test_jax_checkpoint_loads_and_continues(jax_checkpoint):
    """The JAX-written file loads to the JAX ingestor's saved state (the
    stash included), and the remaining steps end where the JAX ingestor
    ended."""
    path, j_final = jax_checkpoint
    with open(os.path.join(path, "host.pkl"), "rb") as f:
        assert pickle.load(f)["saved_with"] == "npz"
    ing = tck.load_ingestor(path, device="cpu")
    assert ing.pending_update(0) is not None and ing.n_docs == N_DOCS
    assert get_string(ing.state, 0, ing.payloads) == ""
    for step in _steps()[SAVE_AFTER:]:
        ing.apply_bytes(step)
    _assert_ingestors_equal(ing, j_final)
    assert ing.pending_update(0) is None
    assert get_string(ing.state, 0, ing.payloads) == "be-tail!"
    assert get_map(ing.state, 1, ing.payloads, ing.enc.keys) == {"k0": 0, "k1": 1, "k2": 2}


@needs_native
def test_port_checkpoint_round_trip_continues_like_unbroken(tmp_path):
    """The port's own save and load mid-run: the rest of the steps give the
    state of an ingestor that never stopped."""
    from ytpu_torch.models.batch_doc import ensure_origin_slot

    steps = _steps()
    unbroken, saved = BatchIngestor(N_DOCS, CAPACITY, device="cpu"), BatchIngestor(N_DOCS, CAPACITY, device="cpu")
    for step in steps[:2]:
        unbroken.apply_bytes(step)
        saved.apply_bytes(step)
    tck.save_ingestor(str(tmp_path / "ing"), saved, extra={"note": 1})
    loaded, extra = tck.load_ingestor_with_extra(str(tmp_path / "ing"), device="cpu")
    assert extra == {"note": 1}
    for step in steps[2:]:
        unbroken.apply_bytes(step)
        loaded.apply_bytes(step)
    a, b = ensure_origin_slot(loaded.state), ensure_origin_slot(unbroken.state)
    for x, y in zip(list(a.blocks) + [a.start, a.n_blocks, a.error], list(b.blocks) + [b.start, b.n_blocks, b.error]):
        assert torch.equal(x, y)
    assert [sv.clocks for sv in loaded.svs] == [sv.clocks for sv in unbroken.svs]
    assert get_string(loaded.state, 0, loaded.payloads) == get_string(unbroken.state, 0, unbroken.payloads)


def test_state_round_trip_and_fixed_path_overwrite(tmp_path):
    from ytpu_torch.core.update import Update
    from ytpu_torch.models.batch_doc import BatchEncoder, apply_update_batch, init_state

    t, _ = _updates()
    enc = BatchEncoder(root_name="text")
    state = init_state(N_DOCS, 64, "cpu")
    path = str(tmp_path / "fixed")
    for p in t[:2]:
        u = Update.decode_v1(p)
        state = apply_update_batch(state, enc.build_batch([u, u], device="cpu"), enc.interner.rank_table(device="cpu"))
        tck.save_state(path, state, enc)  # a periodic save to one path
    state2, enc2 = tck.load_state(path, device="cpu")
    assert get_string(state2, 1, enc2.payloads) == "base-tail"
    assert enc2.interner.from_idx == enc.interner.from_idx and enc2.root_name == "text"
    assert sorted(os.listdir(path)) == ["arrays.npz", "host.pkl"]


def test_format_2_restores_the_origin_slot_cache(tmp_path):
    """A format-2 file has no origin_slot column: the loader recomputes it."""
    from ytpu_torch.models.batch_doc import ensure_origin_slot

    ing = BatchIngestor(N_DOCS, 64, device="cpu")
    ing.apply_bytes(_steps()[1])
    path = str(tmp_path / "v2")
    tck.save_state(path, ing.state, ing.enc)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = {k: z[k] for k in z.files if k != "blocks.origin_slot"}
    np.savez_compressed(os.path.join(path, "arrays.npz"), **flat)
    with open(os.path.join(path, "host.pkl"), "rb") as f:
        side = pickle.load(f)
    side["format"] = 2
    with open(os.path.join(path, "host.pkl"), "wb") as f:
        pickle.dump(side, f)
    state, _ = tck.load_state(path, device="cpu")
    assert torch.equal(state.blocks.origin_slot, ensure_origin_slot(ing.state).blocks.origin_slot)


def test_loader_refuses(tmp_path):
    """An unknown format, orbax arrays, and a sidecar naming a class outside
    the core packages are refused."""
    for name, side in (("format", {"format": 999}), ("orbax", {"format": 3, "saved_with": "orbax"})):
        path = tmp_path / name
        path.mkdir()
        with open(path / "host.pkl", "wb") as f:
            pickle.dump(side, f)
        with pytest.raises(ValueError, match=name):
            tck.load_state(str(path), device="cpu")
    path = tmp_path / "foreign"
    path.mkdir()
    with open(path / "host.pkl", "wb") as f:
        pickle.dump({"format": 3, "x": np.int64(1)}, f)
    with pytest.raises(pickle.UnpicklingError, match="numpy"):
        tck.load_state(str(path), device="cpu")


def test_device_server_round_trip(tmp_path):
    """A restored device-authoritative server keeps slots and root names,
    greets with the same state vector and serves the same diff."""
    pod = DeviceSyncServer(n_docs=N_DOCS, capacity=CAPACITY, device_authoritative=True, device="cpu")
    session, _ = pod.connect_frames("pad")
    c = Doc(client_id=7)
    with c.transact() as txn:
        c.get_text("notes").insert(txn, 0, "persisted")
    upd = c.encode_state_as_update_v1(JStateVector({}))
    pod.receive_frames(session, Message.sync(SyncMessage.update(upd)).encode_v1())
    tck.save_device_server(str(tmp_path / "pod"), pod)  # flushes the queued update
    restored = tck.load_device_server(str(tmp_path / "pod"), device="cpu")
    assert restored.device_authoritative and restored._root_names == {"pad": "notes"}
    assert restored.slot_of("pad") == pod.slot_of("pad")
    assert restored.device_state_vector("pad").clocks == pod.device_state_vector("pad").clocks == {7: 9}
    assert restored.connect_frames("pad")[1] == pod.connect_frames("pad")[1]
    diff = restored.device_encode_diff("pad", StateVector({}))
    d = Doc(client_id=9)
    d.apply_update_v1(diff)
    assert d.get_text("notes").get_string() == "persisted"
    with open(os.path.join(tmp_path, "pod", "host.pkl"), "rb") as f:
        side = pickle.load(f)
    side["extra"]["device_authoritative"] = False
    with open(os.path.join(tmp_path, "pod", "host.pkl"), "wb") as f:
        pickle.dump(side, f)
    # a file that says mirrored loads as a mirrored server: the device state
    # is restored, and the host docs (none saved here) answer the greeting
    mirrored = tck.load_device_server(str(tmp_path / "pod"), device="cpu")
    assert not mirrored.device_authoritative
    assert mirrored.device_state_vector("pad").clocks == {7: 9}
    assert mirrored.doc("pad").state_vector().clocks == {}
    assert mirrored.connect_frames("pad")[1][0] == Message.sync(SyncMessage.step1(StateVector({}))).encode_v1()
