"""The port stands alone: no JAX, no import of the JAX package.

The scan reads the sources (an AST walk), because the interpreter may have
imported jax before any test runs, so sys.modules proves nothing.
"""
import ast
import pathlib

import pytest
import torch

from spark_rapids_tpu_torch.api.session import GpuSession

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "spark_rapids_tpu")
PORT_FILES = sorted((ROOT / "spark_rapids_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", None)) in (
                    "__import__", "import_module") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_nothing_of_jax(path):
    bad = sorted({m for m in _imported_roots(path) if m in FORBIDDEN})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_the_port():
    assert len(PORT_FILES) > 20
    assert "torch" in set(_imported_roots(ROOT / "chip_smoke.py"))


def test_session_defaults_to_the_card():
    if torch.cuda.is_available():
        assert GpuSession().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GpuSession()
    assert GpuSession(device="cpu").device == torch.device("cpu")
