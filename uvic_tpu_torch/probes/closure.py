"""Ocean heat-closure bisection: which feature of the earth ocean breaks
d(inventory) == applied flux.

    python3 -m uvic_tpu_torch.probes.closure [--device D]

The port of ``scripts/probe_closure.py``: the ocean of the tools' earth
model (the land off) under a fixed surface forcing (the idealized wind,
~17 W/m^2 of cooling, a freshening), 24 steps for each variant of
``VARIANTS`` (the full model, then one feature off at a time, then all
off), and one JSON line each: the audit's relative closure of T and S
(``diag.conservation.FullAudit.ocean_closure``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from . import add_device, earth_model

NSTEPS = 24
VARIANTS = {
    "earth-full": {},
    "no-fourfil": dict(fourfil=False),
    "no-isopyc": dict(isopycmix=False, gent_mcwilliams=False),
    "no-tidal": dict(tidal_kv=False, gthflx=False),
    "no-aniso": dict(aniso_visc=False, aniso_zonal=False),
    "bare": dict(fourfil=False, isopycmix=False, gent_mcwilliams=False,
                 tidal_kv=False, gthflx=False, aniso_visc=False,
                 aniso_zonal=False),
}


def variant_config(ocean_over):
    from ..config import tools_earth_config
    cfg = tools_earth_config(land=False)
    return cfg.replace(ocean=dataclasses.replace(cfg.ocean, **ocean_over))


def fixed_forcing(m):
    """The script's forcing: the zonal wind sin(3 lat), -4e-6 K cm/s of
    heat and -2e-8 of salt over the ocean."""
    from ..models.ocean.model import make_forcing
    g = m.grid
    yu = np.asarray(g.yu)
    taux = np.sin(np.deg2rad(yu * 3))[:, None] * np.ones((1, g.imt))
    smf = np.stack([taux / 1.035, np.zeros_like(taux)])
    stf = np.zeros((m.ocean.nt, g.jmt, g.imt))
    stf[0] = -4.0e-6 * np.ones((g.jmt, g.imt))
    stf[1] = -2.0e-8
    stf *= np.asarray(m.topo.tmask[0])

    def tn(x):
        return torch.as_tensor(x, dtype=m.dtype, device=m.device)

    return make_forcing(tn(smf), tn(stf))


def closure_row(name, errs) -> dict:
    return dict(variant=name, temp=round(errs["temp"], 5),
                salt=round(errs["salt"], 5))


def run_variant(name, ocean_over, device=None, nsteps=NSTEPS) -> dict:
    from ..diag.conservation import FullAudit
    m = earth_model(device, variant_config(ocean_over))
    audit = FullAudit(m)
    forcing = fixed_forcing(m)
    ocean = m.init_state().ocean
    before_t = ocean.t.clone()
    for i in range(nsteps):
        ocean = m.ocean.step(ocean, forcing,
                             leapfrog=(i % m.cfg.ocean.nmix != 0))
    return closure_row(name, audit.ocean_closure(
        before_t, ocean.t, forcing, nsteps, m.cfg.ocean.dtts))


def main(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m uvic_tpu_torch.probes.closure")
    add_device(p)
    a = p.parse_args(argv)
    for name, over in VARIANTS.items():
        print(json.dumps(run_variant(name, over, a.device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
