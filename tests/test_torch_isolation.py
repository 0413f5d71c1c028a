"""The port stands alone: no JAX, no ``repro``, and no silent CPU fallback.

- No module under ``src/repro_torch/``, nor ``chip_smoke.py`` or
  ``examples/recall_torch.py``, imports ``jax`` or ``repro[.*]``.
- Importing the port's entry modules in a fresh interpreter loads neither.
- ``device=None`` means CUDA: without a card the entry points raise before
  any work, and ``chip_smoke.py`` exits non-zero at its device check.
"""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.device import resolve_device

pytestmark = pytest.mark.quick

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "examples" / "recall_torch.py",
]


def _imported_roots(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_repro_imports(path):
    bad = {m for m in _imported_roots(path) if m in ("jax", "jaxlib", "repro")}
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_entry_modules_load_no_jax():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.infer, repro_torch.retrieval\n"
        "import repro_torch.convert, repro_torch.kernels.ops, recall_torch\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), str(REPO / "examples")]))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()


def test_entry_points_default_to_cuda():
    """Without a card, device=None raises; it never runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None runs there")
    from repro_torch import convert, graph
    from repro_torch.core.recall import evaluate_recall
    from repro_torch.infer import embed_all_nodes
    from repro_torch.retrieval import chunked_topk
    from test_torch_model import _cfgs

    g = graph.generate(graph.TOY, seed=0).graph
    _, tcfg = _cfgs(g)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.init_params(tcfg)
    model = convert.init_params(tcfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        embed_all_nodes(model, graph.DistributedGraphEngine(g, 2), g)
    q = np.ones((3, 4), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        chunked_topk(q, q, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate_recall(q, q, np.array([[0, 1]]), np.array([[0, 2]]), method="device")


def test_chip_smoke_fails_at_the_device_check():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run in full")
    res = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert "torch.cuda.is_available() is False" in res.stderr
    assert res.stdout == ""  # failed before any phase: nothing built or generated
