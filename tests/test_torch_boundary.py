"""Import boundary and size rules of the PyTorch port.

`rt3d_torch` and `chip_smoke.py` must run where JAX is not installed, so
they import nothing of `jax`, `flax` or the JAX package `rt3d`; and the
port ships sources only: no weights, build output or file over 1 MB.
"""

import ast
import os
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_PY = sorted(str(p.relative_to(ROOT)) for p in (ROOT / "rt3d_torch").rglob("*.py")) + [
    "chip_smoke.py"]
PORT_FILES = sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "rt3d_torch").rglob("*")
    if p.is_file() and "__pycache__" not in p.parts
) + ["chip_smoke.py", "PERF.md"] + sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "tests").glob("test_torch_*.py"))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "rt3d")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module
        elif isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if name in ("import_module", "__import__") and node.args and isinstance(
                    node.args[0], ast.Constant) and isinstance(node.args[0].value, str):
                yield node.lineno, node.args[0].value


@pytest.mark.parametrize("rel", PORT_PY)
def test_port_module_imports_no_jax_or_rt3d(rel):
    bad = [(line, mod) for line, mod in _imports(ROOT / rel) if _forbidden(mod)]
    assert not bad, f"{rel} imports {bad}"


def test_forbidden_import_detector():
    assert _forbidden("jax.numpy") and _forbidden("rt3d.geometry.ops") and _forbidden("flax")
    assert not _forbidden("rt3d_torch.geometry.ops") and not _forbidden("torch")


@pytest.mark.parametrize("rel", PORT_FILES)
def test_port_file_is_small_source(rel):
    path = ROOT / rel
    assert path.stat().st_size < 1 << 20, f"{rel} is over 1 MB"
    assert path.suffix not in (".pt", ".pth", ".safetensors", ".npy", ".npz", ".so", ".o"), rel


def test_build_output_is_ignored():
    lines = (ROOT / ".gitignore").read_text().splitlines()
    assert "build/" in lines
    assert not any(p.suffix == ".so" for p in (ROOT / "rt3d_torch").rglob("*"))
    assert os.path.isdir(ROOT / "rt3d_torch" / "csrc")
