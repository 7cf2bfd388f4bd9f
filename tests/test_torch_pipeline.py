"""The port's `UpdatePipeline` against the JAX package's, on the CPU: the
same payload stream (`test_pipeline.make_payload_stream`) through the
``"xla"`` lane of both packages and through the port's ``"fused"`` lane
against the JAX package's driver lane on its XLA chunk step
(``"packed_xla"``), the restart after a `ReplayFault`, and the encoder's
`build_step` / `stack_steps`. The JAX package runs each lane once, in one
module fixture.
"""

import numpy as np
import pytest
import torch

from ytpu.core import Update as JUpdate
from ytpu.models.batch_doc import BatchEncoder as JEncoder
from ytpu.models.batch_doc import init_state as j_init
from ytpu.models.pipeline import UpdatePipeline as JPipeline
from ytpu.ops import integrate_kernel as jik
from ytpu.utils.faults import faults as j_faults
from ytpu.utils.metrics import metrics as j_metrics

from ytpu_torch.core.update import Update
from ytpu_torch.models.batch_doc import BatchEncoder, get_string, init_state
from ytpu_torch.models.pipeline import UpdatePipeline
from ytpu_torch.utils.faults import faults
from ytpu_torch.utils.metrics import metrics

from test_pipeline import make_payload_stream

torch.set_num_threads(1)

N_DOCS, CAPACITY, N_ROWS, N_DELS, CHUNK_STEPS = 4, 256, 8, 4, 8
# the port's lane -> the JAX package's lane it is held to
LANES = {"xla": "xla", "fused": "packed_xla"}


def _clear():
    j_faults.clear()
    faults.clear()
    jik.reset_lane_health()


@pytest.fixture(autouse=True)
def _clean_slate():
    _clear()
    yield
    _clear()


def _jax_run(lane, payloads, kill=False, **kw):
    enc = JEncoder(root_name="t")
    pipe = JPipeline(enc, N_ROWS, N_DELS, chunk_steps=CHUNK_STEPS, lane=lane, max_capacity=2 * CAPACITY, **kw)
    if kill:
        j_faults.arm("replay.kill", after=2)
    state, n = pipe.run(j_init(N_DOCS, CAPACITY), payloads)
    _clear()
    return state, n, enc


def _port_run(lane, payloads, **kw):
    enc = BatchEncoder(root_name="t")
    pipe = UpdatePipeline(enc, N_ROWS, N_DELS, chunk_steps=CHUNK_STEPS, lane=lane, max_capacity=2 * CAPACITY, **kw)
    state, n = pipe.run(init_state(N_DOCS, CAPACITY, "cpu"), payloads)
    return state, n, enc


@pytest.fixture(scope="module")
def stream():
    return make_payload_stream()


def _v2(payloads):
    return [JUpdate.decode_v1(p).encode_v2() for p in payloads]


@pytest.fixture(scope="module")
def jax_states(stream):
    """``{port lane: (state, chunks, encoder, restarts under a kill, the
    state after that restart)}``, and under ``"v2"`` ``{port lane: (state,
    chunks, encoder)}`` of the stream as V2 bytes with ``decode_v2=True``."""
    payloads, _ = stream
    out = {"v2": {}}
    for lane, j_lane in LANES.items():
        state, n, enc = _jax_run(j_lane, payloads)
        before = j_metrics.counter("pipeline.restarts").value
        killed = _jax_run(j_lane, payloads, kill=True)[0]
        out[lane] = (state, n, enc, j_metrics.counter("pipeline.restarts").value - before, killed)
        out["v2"][lane] = _jax_run(j_lane, _v2(payloads), decode_v2=True)
    return out


def _assert_states_equal(t_state, j_state, skip=()):
    for name in t_state.blocks._fields:
        if name == "origin_slot" or name in skip:  # the kernel does not maintain origin_slot
            continue
        np.testing.assert_array_equal(getattr(t_state.blocks, name).numpy(),
                                      np.asarray(getattr(j_state.blocks, name)), err_msg=name)
    for name in ("start", "n_blocks", "error"):
        np.testing.assert_array_equal(getattr(t_state, name).numpy(), np.asarray(getattr(j_state, name)))


@pytest.mark.parametrize("lane", list(LANES))
def test_lane_matches_jax(jax_states, stream, lane):
    payloads, expected = stream
    j_state, j_n, j_enc, _, _ = jax_states[lane]
    state, n, enc = _port_run(lane, payloads)
    assert n == j_n >= len(payloads) // CHUNK_STEPS
    _assert_states_equal(state, j_state)
    assert enc.interner.from_idx == j_enc.interner.from_idx
    assert len(enc.payloads.items) == len(j_enc.payloads.items)
    for d in range(N_DOCS):
        assert get_string(state, d, enc.payloads) == expected


@pytest.mark.parametrize("lane", list(LANES))
def test_decode_v2_lane_matches_jax(jax_states, stream, lane):
    """``decode_v2=True`` over the stream's V2 form ends in the JAX
    package's state for the same lane and in the port's own V1 state."""
    payloads, expected = stream
    j_state, j_n, j_enc = jax_states["v2"][lane]
    state, n, enc = _port_run(lane, _v2(payloads), decode_v2=True)
    assert n == j_n
    _assert_states_equal(state, j_state)
    assert enc.interner.from_idx == j_enc.interner.from_idx
    _assert_states_equal(state, _port_run(lane, payloads)[0])
    for d in range(N_DOCS):
        assert get_string(state, d, enc.payloads) == expected


@pytest.mark.parametrize("lane", list(LANES))
def test_restart_after_replay_fault_matches_jax(jax_states, stream, lane):
    """An injected kill restarts the run from the caller's state, in both
    packages, with the same restart count; the classic lane never passes
    the kill site. The encoder is kept across the restart, so payload refs
    move by however many updates the decode worker had read ahead: the
    state is compared apart from them, and the text in full."""
    payloads, expected = stream
    _, _, _, j_restarts, j_killed = jax_states[lane]
    before = metrics.counter("pipeline.restarts").value
    faults.arm("replay.kill", after=2)
    state, _, enc = _port_run(lane, payloads)
    assert metrics.counter("pipeline.restarts").value - before == j_restarts == (1 if lane == "fused" else 0)
    _assert_states_equal(state, j_killed, skip=("content_ref",))
    for d in range(N_DOCS):
        assert get_string(state, d, enc.payloads) == expected


def test_restart_budget_and_one_shot_iterators(stream):
    payloads, _ = stream
    from ytpu_torch.ops.integrate_kernel import ReplayFault

    faults.arm("replay.kill", n=0)
    with pytest.raises(ReplayFault):
        _port_run("fused", payloads)
    faults.clear()
    faults.arm("replay.kill")
    with pytest.raises(ReplayFault):
        _port_run("fused", iter(payloads))


def test_tail_chunk_padding():
    """A payload count not divisible by chunk_steps integrates fully."""
    payloads, expected = make_payload_stream(n_txns=13, seed=6)
    enc = BatchEncoder(root_name="t")
    state, chunks = UpdatePipeline(enc, N_ROWS, N_DELS, chunk_steps=5).run(init_state(2, CAPACITY, "cpu"), payloads)
    assert chunks == (len(payloads) + 4) // 5
    assert int(state.error.max()) == 0
    assert get_string(state, 0, enc.payloads) == expected


def test_decode_error_surfaces():
    pipe = UpdatePipeline(BatchEncoder(root_name="t"), N_ROWS, N_DELS, chunk_steps=4)
    with pytest.raises(Exception):
        pipe.run(init_state(1, 64, "cpu"), [b"\xff\xff\xff garbage"])


def test_options_outside_the_port_raise():
    enc = BatchEncoder()
    with pytest.raises(ValueError, match="packed_xla"):
        UpdatePipeline(enc, N_ROWS, N_DELS, lane="packed_xla")
    with pytest.raises(ValueError, match="lane"):
        UpdatePipeline(enc, N_ROWS, N_DELS, lane="host")
    with pytest.raises(ValueError, match="depth"):
        UpdatePipeline(enc, N_ROWS, N_DELS, depth=0)
    with pytest.raises(NotImplementedError, match="A.2c"):
        UpdatePipeline(enc, N_ROWS, N_DELS, admission=object())


def test_build_step_and_stack_steps_match_jax(stream):
    """The encoder's one-update step and its stacking equal the JAX
    package's, field by field; a bucket too small raises."""
    payloads, _ = stream
    j_enc, t_enc = JEncoder(root_name="t"), BatchEncoder(root_name="t")
    j_steps = [j_enc.build_step(JUpdate.decode_v1(p), N_ROWS, N_DELS) for p in payloads[:6]]
    t_steps = [t_enc.build_step(Update.decode_v1(p), N_ROWS, N_DELS, device="cpu") for p in payloads[:6]]
    for j, t in ((JEncoder.stack_steps(j_steps), BatchEncoder.stack_steps(t_steps)), (j_steps[3], t_steps[3])):
        for name in t._fields:
            np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)), err_msg=name)
    with pytest.raises(ValueError, match="buckets"):
        t_enc.build_step(Update.decode_v1(payloads[0]), 0, N_DELS, device="cpu")
