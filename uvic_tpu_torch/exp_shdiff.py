"""The Southern-Hemisphere tuning experiment (the twin of
``scripts/exp_shdiff.py``): the spin-up with a patched Southern-
Hemisphere high-latitude atmospheric heat diffusivity and/or
Southern-Ocean coalbedo bump, the knobs for the SH winter ice.

    python3 -m uvic_tpu_torch.exp_shdiff YEARS --polar-sh F
        [--so-coalb D] [--out DIR] [--from SRC] [--device cpu|cuda]

Copies ``restart.npz`` and ``restart_meta.json`` from ``--from`` into
``--out`` (a throwaway directory: experiments never touch the
production lineage), then runs ``uvic_tpu_torch.spinup.main`` with the
arguments the script gives ``spinup_earth`` (``YEARS --resume --out DIR
--run-id exp-psh<F>-soc<D>``, and ``--device`` when given).  The model
reads its diffusivity and coalbedo from ``core.earth.earth_atm_diff``
and ``earth_atm_coalbedo`` when it is built (``coupler.driver``); they
are replaced by ``sh_diff`` and ``sh_coalbedo`` for the run only
(``patched_authors``) and restored after it, however it ends.  Without
``--device`` the model runs on the card.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import shutil
import tempfile

import numpy as np

from .core import earth


def sh_diff(grid, polar_sh: float):
    """(diff_t, diff_q) [cm^2/s] of ``core.earth.earth_atm_diff`` with
    the SH polar enhancement ``polar_sh`` (4.0 in production)."""
    lat = np.asarray(grid.yt, dtype=float)
    polar_nh = 1.0 / (1.0 + np.exp(-(lat - 63.0) / 5.0))
    polar_sh_ = 1.0 / (1.0 + np.exp(-(-lat - 63.0) / 5.0))
    dt_ = 5.0e9 * (0.9 + 1.5 * earth._gauss(lat, 47.0, 13.0)
                   + 1.8 * earth._gauss(lat, -52.0, 14.0)
                   + 2.8 * polar_nh + polar_sh * polar_sh_)
    dq = 5.0e9 * (0.9 + 0.7 * earth._gauss(lat, 0.0, 11.0))
    jmt, imt = grid.jmt, grid.imt
    return (np.broadcast_to(dt_[:, None], (jmt, imt)).copy(),
            np.broadcast_to(dq[:, None], (jmt, imt)).copy())


def sh_coalbedo(grid, so_coalb: float):
    """(jmt, imt) coalbedo of ``core.earth.earth_atm_coalbedo`` with the
    Southern-Ocean gaussian at 57S of amplitude ``so_coalb`` (-0.005 in
    production)."""
    lat = np.asarray(grid.yt, dtype=float)
    aca = (0.81 - 0.085 * np.sin(np.deg2rad(lat)) ** 2
           - 0.01 * earth._gauss(lat, 52.0, 12.0)
           + so_coalb * earth._gauss(lat, -57.0, 8.0)
           + 0.025 * earth._gauss(lat, 72.0, 12.0))
    aca *= 0.9934
    return np.broadcast_to(aca[:, None], (grid.jmt, grid.imt)).copy()


@contextlib.contextmanager
def patched_authors(polar_sh: float, so_coalb: float):
    """``core.earth``'s diffusivity and coalbedo authors replaced by the
    experiment's inside the block, restored after it."""
    saved = earth.earth_atm_diff, earth.earth_atm_coalbedo
    earth.earth_atm_diff = lambda grid: sh_diff(grid, polar_sh)
    earth.earth_atm_coalbedo = lambda grid: sh_coalbedo(grid, so_coalb)
    try:
        yield
    finally:
        earth.earth_atm_diff, earth.earth_atm_coalbedo = saved


def spinup_argv(years: int, out: str, polar_sh: float, so_coalb: float,
                device=None) -> list:
    """The arguments ``spinup.main`` gets: the script's for
    ``spinup_earth``, and ``--device`` when given."""
    argv = [str(years), "--resume", "--out", out,
            "--run-id", "exp-psh%.1f-soc%.3f" % (polar_sh, so_coalb)]
    return argv + (["--device", device] if device else [])


def main(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m uvic_tpu_torch.exp_shdiff",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("years", type=int)
    p.add_argument("--polar-sh", type=float, default=4.0,
                   help="SH polar diff_t enhancement (production 4.0)")
    p.add_argument("--so-coalb", type=float, default=-0.005,
                   help="SO coalbedo gaussian amplitude at 57S "
                        "(base -0.005)")
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                 "exp_sh"))
    p.add_argument("--from", dest="src", default="earth_spinup")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from . import spinup
    os.makedirs(args.out, exist_ok=True)
    for f in ("restart.npz", "restart_meta.json"):
        shutil.copy(os.path.join(args.src, f), os.path.join(args.out, f))
    with patched_authors(args.polar_sh, args.so_coalb):
        return spinup.main(spinup_argv(args.years, args.out, args.polar_sh,
                                       args.so_coalb, args.device))


if __name__ == "__main__":
    raise SystemExit(main())
