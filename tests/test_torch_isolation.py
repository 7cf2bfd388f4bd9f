"""The port stands alone: importing it pulls in neither JAX nor any module
of the JAX package, no source file of the port (or chip_smoke.py) imports
them, and its host C++ library builds from sources under ``ytpu_torch/``
only."""

import ast
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, files in os.walk(os.path.join(ROOT, "ytpu_torch")):
        out += [os.path.join(base, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_import_leaves_jax_and_ytpu_unloaded():
    code = (
        "import json, sys\n"
        "import ytpu_torch, ytpu_torch.models.replay, ytpu_torch.ops.integrate_kernel\n"
        "import ytpu_torch.ops.compaction, ytpu_torch.ops.decode_kernel, ytpu_torch.convert\n"
        "import ytpu_torch.models.batch_doc, ytpu_torch.encoding.lib0, ytpu_torch.ops._build\n"
        "import ytpu_torch.core.device, ytpu_torch.benches.mosaic_ladder\n"
        "import ytpu_torch.benches.plane_rmw_repro, ytpu_torch.benches.plane_rmw_repro2\n"
        "import ytpu_torch.benches.plane_rmw_repro3, ytpu_torch.benches.sync_step\n"
        "import ytpu_torch.encoding.codec, ytpu_torch.core.ids, ytpu_torch.core.id_set\n"
        "import ytpu_torch.ops.state_vector, ytpu_torch.models.ingest, ytpu_torch.core.update\n"
        "import ytpu_torch.core.block, ytpu_torch.core.branch, ytpu_torch.core.moving\n"
        "import ytpu_torch.core.state_vector, ytpu_torch.core.content, ytpu_torch.benches.ingest\n"
        "import ytpu_torch.benches.streams, ytpu_torch.benches.sync_server\n"
        "import ytpu_torch.sync, ytpu_torch.sync.awareness, ytpu_torch.sync.protocol\n"
        "import ytpu_torch.sync.server, ytpu_torch.sync.device_server, ytpu_torch.native\n"
        "import ytpu_torch.utils, ytpu_torch.utils.faults, ytpu_torch.utils.metrics\n"
        "import ytpu_torch.models.pipeline, ytpu_torch.models.checkpoint, ytpu_torch.ops.decode_v2\n"
        "import ytpu_torch.core.block_store, ytpu_torch.core.store, ytpu_torch.core.transaction\n"
        "import ytpu_torch.core.doc, ytpu_torch.types, ytpu_torch.types.shared, ytpu_torch.types.text\n"
        "import ytpu_torch.types.array, ytpu_torch.types.map, ytpu_torch.types.xml, ytpu_torch.types.weak\n"
        "import ytpu_torch.types.events\n"
        "from ytpu_torch.core import Doc\n"
        "from ytpu_torch.sync import DeviceSyncServer\n"
        "d = Doc(client_id=1)\n"
        "with d.transact() as txn:\n"
        "    d.get_text('t').insert(txn, 0, 'x')\n"
        "DeviceSyncServer(n_docs=1, capacity=8, device='cpu').doc('a').apply_update_v1(d.encode_state_as_update_v1())\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "    if m == 'jax' or m.startswith('jax.') or m == 'ytpu' or m.startswith('ytpu.'))))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _foreign_imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "ytpu"):
                bad.append(name)
    return bad


@pytest.mark.parametrize("path", port_sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_source_imports_no_jax_or_ytpu(path):
    assert _foreign_imports(path) == []


@pytest.mark.parametrize("rel", ["ytpu_torch/sync/__init__.py", "ytpu_torch/sync/awareness.py",
                                 "ytpu_torch/sync/protocol.py", "ytpu_torch/sync/server.py",
                                 "ytpu_torch/sync/device_server.py", "ytpu_torch/benches/sync_server.py"])
def test_sync_slice_is_scanned(rel):
    """The sync slice's modules exist and are among the scanned sources."""
    assert os.path.join(ROOT, rel) in port_sources()


HOST_CRDT = ["ytpu_torch/core/" + m + ".py" for m in (
    "ids", "id_set", "state_vector", "content", "branch", "block", "moving", "block_store", "store",
    "transaction", "update", "doc")] + ["ytpu_torch/types/" + m + ".py" for m in (
    "__init__", "shared", "text", "array", "map", "xml", "weak", "events")]


@pytest.mark.parametrize("rel", HOST_CRDT)
def test_host_crdt_slice_is_scanned(rel):
    """The host CRDT's modules exist and are among the scanned sources (their
    imports inside functions too: `ast.walk` reaches every node)."""
    assert os.path.join(ROOT, rel) in port_sources()


def test_scan_catches_a_foreign_import(tmp_path):
    p = tmp_path / "bad.py"
    p.write_text("import numpy\nfrom ytpu.ops import integrate_kernel\nimport jax.numpy as jnp\nimport ytpu_torch\n")
    assert _foreign_imports(str(p)) == ["ytpu.ops", "jax.numpy"]


def test_host_library_sources_lie_in_the_port():
    """Every source of the host library lies under ``ytpu_torch/`` (none in
    the JAX package's ``ytpu/native``), and none includes a file by a
    relative or package path."""
    from ytpu_torch.ops import _build

    pkg = os.path.join(ROOT, "ytpu_torch") + os.sep
    srcs = [os.path.realpath(src) for name in _build.HOST_SOURCES for src in _build._sources(name)]
    assert srcs and all(src.startswith(pkg) and os.path.isfile(src) for src in srcs), srcs
    for src in srcs:
        includes = [ln for ln in open(src, encoding="utf-8") if ln.startswith("#include")]
        assert all(ln.split()[1].startswith("<") for ln in includes), (src, includes)
