"""``python3 -m uvic_tpu_torch.exp_shdiff`` (the twin of
``scripts/exp_shdiff.py``) against the script, on the CPU, without a
spin-up.

The script runs in this process with a stand-in ``spinup_earth`` module
that records what the spin-up would have read: the JAX package's
``core.earth.earth_atm_diff`` and ``earth_atm_coalbedo`` on the earth
grid (patched by the script) and ``sys.argv``.  The twin runs with a
stand-in ``spinup.main`` that records the port's authors on the port's
earth grid and its argv.  For two (polar-sh, so-coalb) pairs the fields
agree bitwise in float64, the argv and the copied restart pair are the
script's, and the port's authors are unpatched afterwards.  The JAX
module, ``sys.argv``, ``sys.path`` and ``sys.modules`` are restored
after the script's run.
"""

import importlib.util
import sys
import types
from pathlib import Path

import numpy as np
import pytest

import uvic_tpu.core.earth as j_earth
from uvic_tpu.config import earth_config as j_earth_config
from uvic_tpu.core.grid import make_grid as j_make_grid

import uvic_tpu_torch.core.earth as t_earth
from uvic_tpu_torch import exp_shdiff, spinup
from uvic_tpu_torch.config import earth_config as t_earth_config
from uvic_tpu_torch.core.grid import make_grid as t_make_grid
from torch_threads import torch_one_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "earth_accept"
RESTART = ("restart.npz", "restart_meta.json")
# (polar-sh, so-coalb): the card's experiment, and both knobs moved
PAIRS = [(6.0, -0.005), (3.0, -0.015)]


def _script_run(polar_sh, so_coalb, out):
    """The JAX script's main with a recording ``spinup_earth``."""
    grid = j_make_grid(j_earth_config().grid)
    seen = {}

    def record():
        seen["diff"] = j_earth.earth_atm_diff(grid)
        seen["coalbedo"] = j_earth.earth_atm_coalbedo(grid)
        seen["argv"] = list(sys.argv)

    stand_in = types.ModuleType("spinup_earth")
    stand_in.main = record
    saved = (j_earth.earth_atm_diff, j_earth.earth_atm_coalbedo,
             list(sys.argv), list(sys.path),
             sys.modules.get("spinup_earth"))
    try:
        sys.modules["spinup_earth"] = stand_in
        spec = importlib.util.spec_from_file_location(
            "exp_shdiff_script", ROOT / "scripts" / "exp_shdiff.py")
        script = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(script)
        sys.argv = ["exp_shdiff.py", "1", "--polar-sh", str(polar_sh),
                    "--so-coalb", str(so_coalb), "--out", str(out),
                    "--from", str(SOURCE)]
        script.main()
    finally:
        (j_earth.earth_atm_diff, j_earth.earth_atm_coalbedo, sys.argv,
         sys.path[:]) = saved[:4]
        if saved[4] is None:
            sys.modules.pop("spinup_earth", None)
        else:
            sys.modules["spinup_earth"] = saved[4]
    return seen


def _port_run(polar_sh, so_coalb, out, *extra):
    """The twin's main with a recording ``spinup.main``."""
    grid = t_make_grid(t_earth_config().grid)
    seen = {}

    def record(argv):
        seen["diff"] = t_earth.earth_atm_diff(grid)
        seen["coalbedo"] = t_earth.earth_atm_coalbedo(grid)
        seen["argv"] = list(argv)
        return 0

    real = spinup.main
    spinup.main = record
    try:
        code = exp_shdiff.main(["1", "--polar-sh", str(polar_sh),
                                "--so-coalb", str(so_coalb), "--out",
                                str(out), "--from", str(SOURCE), *extra])
    finally:
        spinup.main = real
    assert code == 0
    return seen


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("exp_sh")
    out = {}
    for n, (psh, soc) in enumerate(PAIRS):
        out[psh, soc] = dict(
            jax=_script_run(psh, soc, tmp / f"jax{n}"),
            port=_port_run(psh, soc, tmp / f"port{n}"),
            jax_out=tmp / f"jax{n}", port_out=tmp / f"port{n}")
    return out


@pytest.mark.parametrize("pair", PAIRS)
def test_patched_fields_are_the_scripts_bitwise(runs, pair):
    j, t = runs[pair]["jax"], runs[pair]["port"]
    for name in ("diff_t", "diff_q"):
        k = ("diff_t", "diff_q").index(name)
        a, b = t["diff"][k], np.asarray(j["diff"][k])
        assert a.dtype == b.dtype == np.float64 and a.shape == b.shape
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(t["coalbedo"], np.asarray(j["coalbedo"]))
    assert t["coalbedo"].dtype == np.float64


@pytest.mark.parametrize("pair", PAIRS)
def test_hand_off_is_the_scripts(runs, pair):
    """The argv that ``spinup.main`` gets is the script's
    ``spinup_earth`` argv (its program name aside), the out directory
    aside; the restart pair is copied byte for byte."""
    r = runs[pair]
    j_argv, t_argv = r["jax"]["argv"][1:], r["port"]["argv"]
    out_at = j_argv.index("--out") + 1
    assert t_argv[out_at] == str(r["port_out"])
    assert j_argv[out_at] == str(r["jax_out"])
    assert t_argv[:out_at] + t_argv[out_at + 1:] \
        == j_argv[:out_at] + j_argv[out_at + 1:]
    assert t_argv[-1] == "exp-psh%.1f-soc%.3f" % pair
    for f in RESTART:
        src = (SOURCE / f).read_bytes()
        assert (r["port_out"] / f).read_bytes() == src
        assert (r["jax_out"] / f).read_bytes() == src


def test_device_is_passed_on(tmp_path):
    seen = _port_run(6.0, -0.005, tmp_path, "--device", "cpu")
    assert seen["argv"] == exp_shdiff.spinup_argv(
        1, str(tmp_path), 6.0, -0.005) + ["--device", "cpu"]


def test_authors_are_unpatched_after_the_run(runs, tmp_path):
    """After the runs, and after a spin-up that raises."""
    grid = t_make_grid(t_earth_config().grid)
    diff, coalb = t_earth.earth_atm_diff, t_earth.earth_atm_coalbedo
    assert diff.__module__ == coalb.__module__ == t_earth.__name__

    def fail(argv):
        raise SystemExit("the spin-up failed")
    real = spinup.main
    spinup.main = fail
    try:
        with pytest.raises(SystemExit, match="the spin-up failed"):
            exp_shdiff.main(["1", "--polar-sh", "6.0", "--out",
                             str(tmp_path), "--from", str(SOURCE)])
    finally:
        spinup.main = real
    assert (t_earth.earth_atm_diff, t_earth.earth_atm_coalbedo) \
        == (diff, coalb)
    # the defaults reproduce the production fields bitwise
    for a, b in zip(exp_shdiff.sh_diff(grid, 4.0), diff(grid)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(exp_shdiff.sh_coalbedo(grid, -0.005),
                                  coalb(grid))


def test_the_jax_module_is_restored(runs):
    assert j_earth.earth_atm_diff.__module__ == j_earth.__name__
    assert j_earth.earth_atm_coalbedo.__module__ == j_earth.__name__
    assert "spinup_earth" not in sys.modules
