"""Times the V2 decode of the checkout at ROOT on the card, so that two
trees (a change and its parent) can be compared in one run: the B4 log
transcoded to V2 (once, cached in the system's temporary directory for
the next run), one B4 chunk and the whole log packed as the JAX package's
full-log test packs them (lanes of 64 bytes, U = R = 4, 4 sections).

Usage (on a machine with an NVIDIA GPU and the CUDA toolkit), as a script
so that ROOT's package is the one imported:

    python3 ytpu_torch/benches/decode_v2_ab.py ROOT

Prints one JSON line: for the chunk and the whole log, the device ms of a
`_decode_v2_kernel` launch from a CUDA graph (`graph_ms`: min, mean, max
over its rounds) and the host wall ms of five `decode_updates_v2` calls,
each ending in a synchronize, sorted.
"""

import gzip
import json
import os
import pickle
import sys
import tempfile
import time

CHUNK, LATE_CHUNK, PAD, U, R, SEC = 8192, 30, 64, 4, 4, 4


def main(root: str) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from ytpu_torch.benches._kernels import graph_ms
    from ytpu_torch.core.update import Update
    from ytpu_torch.ops import decode_v2 as dv2

    cache = os.path.join(tempfile.gettempdir(), "ytpu_torch_v2_b4_log.pkl")
    if os.path.exists(cache):
        with open(cache, "rb") as f:
            v2_log = pickle.load(f)
    else:
        with gzip.open(os.path.join(root, "benches", "data", "b4_log.pkl.gz"), "rb") as f:
            v2_log = [Update.decode_v1(p).encode_v2() for p in pickle.load(f)["log"]]
        with open(cache, "wb") as f:
            pickle.dump(v2_log, f)
    dev = torch.device("cuda")
    out = {"root": root, "gpu": torch.cuda.get_device_name(0)}
    for name, payloads in (("b4_chunk", v2_log[LATE_CHUNK * CHUNK:(LATE_CHUNK + 1) * CHUNK]), ("full_log", v2_log)):
        buf, lens, spans = (torch.from_numpy(x).to(dev) for x in dv2.pack_updates_v2(payloads, pad_to=PAD)[:3])
        ms = graph_ms(lambda: dv2._decode_v2_kernel(buf, lens, spans, U, R, SEC), reps=50 if name == "b4_chunk" else 10)
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            dv2.decode_updates_v2(buf, lens, spans, U, R, max_sections=SEC)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
        out[name] = {"kernel_ms": ms, "call_ms": sorted(walls)}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
