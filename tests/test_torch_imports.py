"""Import hygiene of the PyTorch port: no JAX and nothing of ``repro`` in
``src/repro_torch`` or ``chip_smoke.py``; GPU by default."""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


def test_port_files_exist():
    files = _port_files()
    assert (ROOT / "chip_smoke.py").exists()
    assert len(files) > 15


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [(mod, line) for mod, line in _imported_roots(path) if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_build_model_defaults_to_cuda():
    from repro_torch.configs import smoke_config
    from repro_torch.models import build_model

    cfg = smoke_config("gemma-2b")
    if torch.cuda.is_available():
        assert build_model(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_model(cfg)


def test_kernel_modules_import_without_a_toolkit():
    """Importing builds nothing: the library is built at the first launch."""
    from repro_torch.kernels import _build

    assert _build._LIB is None or torch.cuda.is_available()
    assert {p.name for p in _build.sources()} == {
        "rmsnorm.cu", "decode_attention.cu", "flash_attention.cu", "rglru_scan.cu", "wkv6.cu"}
