"""The port stands alone: no module of ``stencil_tpu_torch``, and not
``chip_smoke.py``, imports JAX or the JAX package; the package imports
on a machine with no CUDA toolkit."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (the test environment of the port's tests)
import numpy as np  # noqa: F401
import pytest
import torch  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "stencil_tpu")
FILES = sorted((ROOT / "stencil_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported(tree)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_imports_without_nvcc_or_jax():
    code = ("import sys, stencil_tpu_torch, stencil_tpu_torch.ops.cuda_stencil,"
            " stencil_tpu_torch.ops._build, stencil_tpu_torch.convert,"
            " stencil_tpu_torch.apps.jacobi3d, stencil_tpu_torch.ops.fd6,"
            " stencil_tpu_torch.ops.cuda_mhd, stencil_tpu_torch.models.astaroth,"
            " stencil_tpu_torch.apps.astaroth, stencil_tpu_torch.ops.cuda_halo,"
            " stencil_tpu_torch.parallel.mesh, stencil_tpu_torch.placement,"
            " stencil_tpu_torch.ops.cuda_exchange, stencil_tpu_torch.ops.cuda_overlap,"
            " stencil_tpu_torch.parallel.cuda_exchange,"
            " stencil_tpu_torch.parallel.overlap, stencil_tpu_torch.apps.measure_overlap,"
            " stencil_tpu_torch.ops.cuda_mhd_overlap, stencil_tpu_torch.apps._common,"
            " stencil_tpu_torch.parallel.multihost, stencil_tpu_torch.analysis.costmodel;"
            " bad = [m for m in sys.modules if m.split('.')[0] in"
            " ('jax', 'jaxlib', 'stencil_tpu')];"
            " assert not bad, bad")
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT),
           "NVCC": "", "CUDA_HOME": str(ROOT / "no-cuda-here")}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr


def test_build_without_nvcc_raises(monkeypatch):
    from stencil_tpu_torch.ops import _build

    monkeypatch.setenv("NVCC", "")
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setenv("CUDA_HOME", str(ROOT / "no-cuda-here"))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
    assert set(_build.sources()) == {"exchange_dma", "ipc", "jacobi7",
                                     "jacobi_halo", "jacobi_overlap",
                                     "laplace6", "mhd", "mhd_overlap"}
    assert os.path.basename(_build.library_path("jacobi7")).startswith(
        "libjacobi7-")
