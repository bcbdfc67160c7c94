"""The PyTorch port runs without JAX and without the JAX package.

Every module of ``uvic_tpu_torch`` is imported in a fresh interpreter in
which ``import jax`` and ``import uvic_tpu`` fail, and the port's
sources, ``chip_smoke.py`` among them, hold no import of either.
"""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

import uvic_tpu_torch

ROOT = Path(__file__).resolve().parents[1]
PKG = Path(uvic_tpu_torch.__file__).resolve().parent
MODULES = sorted(m.name for m in pkgutil.walk_packages(
    [str(PKG)], prefix="uvic_tpu_torch."))
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
# "uvic_tpu" as a module name: not followed by "_torch" (the port)
REFERENCE = re.compile(r"\buvic_tpu(?!_torch)\b\s*(\.|import\b)")
IMPORT_JAX = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax)\b", re.M)
IMPORT_REF = re.compile(
    r"^\s*(from\s+uvic_tpu(?!_torch)\b|import\s+uvic_tpu(?!_torch)\b)", re.M)
IMPORT_SCRIPTS = re.compile(r"^\s*(from|import)\s+scripts\b", re.M)

BLOCKED_IMPORT = """
import importlib, sys
for name in ("jax", "jaxlib", "flax", "uvic_tpu"):
    sys.modules[name] = None          # any import of them raises
for name in sys.argv[1:]:
    importlib.import_module(name)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "flax", "uvic_tpu")
             and sys.modules[n] is not None)
assert not bad, bad
print(len(sys.argv) - 1)
"""


def test_every_module_imports_without_jax():
    assert "uvic_tpu_torch.models.bgc.mobi" in MODULES
    assert {"uvic_tpu_torch.models.sed.porewater",
            "uvic_tpu_torch.models.sed.sediment",
            "uvic_tpu_torch.models.ice.cpts", "uvic_tpu_torch.diag.energy",
            "uvic_tpu_torch.spinup", "uvic_tpu_torch.io.timeforce",
            "uvic_tpu_torch.io.bcest", "uvic_tpu_torch.io.regrid",
            "uvic_tpu_torch.diag.regions", "uvic_tpu_torch.diag.sections",
            "uvic_tpu_torch.diag.tmm", "uvic_tpu_torch.debug",
            "uvic_tpu_torch.models.ocean.hmix",
            "uvic_tpu_torch.models.ocean.neptune",
            "uvic_tpu_torch.models.ocean.surfpress",
            "uvic_tpu_torch.parallel.shard_step",
            "uvic_tpu_torch.parallel.shard_segment",
            "uvic_tpu_torch.precision_year",
            "uvic_tpu_torch.precision_study", "uvic_tpu_torch.run_earth",
            "uvic_tpu_torch.tune_earth", "uvic_tpu_torch.diag.climate",
            *(f"uvic_tpu_torch.probes.{name}" for name in (
                "year_closure", "segment_closure", "replay_vs_manual",
                "energy", "toa_decompose", "closure", "moc", "triage"))
            } <= set(MODULES)
    out = subprocess.run(
        [sys.executable, "-c", BLOCKED_IMPORT, *MODULES], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == str(len(MODULES))


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_neither_jax_nor_the_reference(path):
    text = path.read_text()
    assert not IMPORT_JAX.search(text), f"{path}: imports jax"
    assert not IMPORT_REF.search(text), f"{path}: imports uvic_tpu"
    assert not IMPORT_SCRIPTS.search(text), f"{path}: imports scripts/"
    # no dynamic import of the reference either
    for line in text.splitlines():
        if "import_module" in line or "__import__" in line:
            assert not REFERENCE.search(line), f"{path}: {line.strip()}"
