"""The port stands alone: ``src/repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, every module of the port imports on a
machine without a CUDA toolkit, and ``chip_smoke.py`` fails (printing no
result) where there is no card or no repository around it."""
import importlib
import pkgutil
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import repro_torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro)(?:[.\s,]|$)",
                       re.MULTILINE)


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_neither_jax_nor_repro(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path}: {hits}"


def test_forbidden_pattern_catches_what_it_should():
    for bad in ("import jax", "from jax import numpy", "import repro.quant",
                "from repro.kernels import ops", "  from repro import x"):
        assert FORBIDDEN.search(bad), bad
    for ok in ("import repro_torch", "from repro_torch.quant import pack",
               "import jaxtyping"):
        assert not FORBIDDEN.search(ok), ok


def test_every_port_module_imports_without_cuda():
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")]
    assert "repro_torch.kernels.packed_matmul" in names
    for core in ("formats", "ref_mac", "mac", "packing", "pipeline",
                 "resource_model", "gemv_engine"):
        assert f"repro_torch.core.{core}" in names
    assert "repro_torch.kernels.xtramac_mac" in names
    for name in names:
        importlib.import_module(name)


def test_chip_smoke_fails_without_card_or_repository(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    for cwd in (ROOT, tmp_path):
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
