"""The port's entry points put their tensors on the GPU unless told
otherwise: `init_state`, `identity_rank`, `packed_from_numpy` and
`stream_from_numpy` with no device go to ``cuda``, and without a GPU they
raise instead of falling back to the CPU; ``device="cpu"`` works
everywhere."""

import numpy as np
import pytest
import torch

from ytpu_torch.convert import packed_from_numpy, stream_from_numpy
from ytpu_torch.core.device import resolve_device
from ytpu_torch.models.batch_doc import init_state
from ytpu_torch.ops.decode_kernel import identity_rank


def _calls():
    cols = np.zeros((26, 2, 8), np.int32)
    meta = np.zeros((2, 32), np.int32)
    rows = np.zeros((3, 1, 23), np.int32)
    dels = np.zeros((3, 1, 4), np.int32)
    return {
        "init_state": lambda **kw: init_state(2, 8, **kw).blocks.client,
        "identity_rank": lambda **kw: identity_rank(16, **kw),
        "packed_from_numpy": lambda **kw: packed_from_numpy(cols, meta, **kw)[0],
        "stream_from_numpy": lambda **kw: stream_from_numpy(rows, dels, **kw)[0],
    }


@pytest.mark.parametrize("name", ["init_state", "identity_rank", "packed_from_numpy",
                                  "stream_from_numpy"])
def test_default_device_is_the_gpu(name):
    call = _calls()[name]
    assert call(device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert call().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device()
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
