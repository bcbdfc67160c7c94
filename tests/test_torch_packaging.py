"""The port installs on its own, without JAX.

``packaging/uvic_tpu_torch/pyproject.toml`` is the port's project file
(the root ``pyproject.toml`` installs the JAX package).  Its
``package-dir`` points at the repo root, and setuptools writes its
``build/`` beside the project file and its ``.egg-info`` beside the
package, so the wheel is built from a copy laid out as in the repo: the
project file, the port, and a stand-in ``uvic_tpu`` package that must
stay out of the wheel.  The build is offline: no index, no build
isolation, no dependencies fetched.
"""

import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PROJECT = Path("packaging") / "uvic_tpu_torch"
PORT = ROOT / "uvic_tpu_torch"
SKIP = shutil.ignore_patterns("__pycache__", "_build", "*.pyc")


@pytest.fixture(scope="module")
def wheel(tmp_path_factory):
    """(file names in the wheel, its METADATA text)."""
    tmp = tmp_path_factory.mktemp("wheel")
    src = tmp / "src"
    shutil.copytree(ROOT / PROJECT, src / PROJECT, ignore=SKIP)
    shutil.copytree(PORT, src / "uvic_tpu_torch", ignore=SKIP)
    for pkg in ("uvic_tpu", "uvic_tpu/ops"):
        (src / pkg).mkdir()
        (src / pkg / "__init__.py").write_text("")
    out = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", "--no-build-isolation",
         "--no-deps", "--no-index", "--no-cache-dir",
         "--disable-pip-version-check", "-w", str(tmp / "dist"),
         str(src / PROJECT)],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    (whl,) = (tmp / "dist").glob("*.whl")
    with zipfile.ZipFile(whl) as z:
        names = z.namelist()
        meta = next(n for n in names if n.endswith(".dist-info/METADATA"))
        return names, z.read(meta).decode()


def test_wheel_holds_every_module_and_cuda_source(wheel):
    names, _ = wheel
    want = sorted(str(p.relative_to(ROOT)) for p in
                  list(PORT.rglob("*.py")) + list(PORT.glob("csrc/*.cu"))
                  if "_build" not in p.parts and "__pycache__" not in p.parts)
    assert "uvic_tpu_torch/csrc/convect_apply.cu" in want
    assert {"uvic_tpu_torch/models/sed/__init__.py",
            "uvic_tpu_torch/models/sed/porewater.py",
            "uvic_tpu_torch/models/sed/sediment.py"} <= set(want)
    assert not sorted(set(want) - set(names))


def test_wheel_holds_nothing_of_the_jax_package(wheel):
    names, _ = wheel
    tops = {n.split("/")[0] for n in names}
    assert tops == {"uvic_tpu_torch", "uvic_tpu_torch-0.1.0.dist-info"}


def test_wheel_requires_torch_numpy_scipy_and_no_jax(wheel):
    _, meta = wheel
    reqs = sorted(line.split(":", 1)[1].strip() for line in meta.splitlines()
                  if line.startswith("Requires-Dist:"))
    assert reqs == ["numpy", "scipy", "torch"]
    assert "jax" not in meta.lower()
