"""Time-interpolated 2-D boundary forcing (data.F / timeinterp.F), torch.

Port of ``uvic_tpu.io.timeforce``.  The reference reads monthly
climatology records from netCDF (`O_tempsur.nc`, `O_salsur.nc`, ... —
data.F:60-200), centers each record in time (timeinterpi,
timeinterp.F:1-54) and linearly interpolates between the bracketing
records each segment (timeinterp method 1, timeinterp.F:56-146);
`get_tdsbc` applies a scale and offset on read (data.F:206-267).

All records live as one (nrec, jmt, imt) tensor on the model's device.
The bracketing-record search and the linear weight are tensor
arithmetic with no host read, so a lookup can run inside a captured
step.  Restoring boundary conditions (O_restorst, data.F:119-142)
turn interpolated surface data into fluxes with
stf = dampdz/(dampts*daylen) * (data - model_surface).

The records are built in NumPy in the given dtype exactly as the
reference builds them, then moved to the device, so that both packages
interpolate the same numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..constants import DAYLEN


class TimeInterpField:
    """Periodic (climatological) time-interpolated 2-D field.

    records : (nrec, jmt, imt) — e.g. 12 monthly means
    centers : record centers in fractional years (timeinterpi);
              default = centered months of an equal-month year
    scale/offset applied on construction (get_tdsbc semantics).
    ``dtype`` is a NumPy dtype; the tensors go to ``device`` (``cuda``
    unless the caller says otherwise).
    """

    def __init__(self, records, centers=None, scale=1.0, offset=0.0,
                 dtype=np.float64, device=None):
        device = resolve_device(device)
        rec = np.asarray(records, dtype) * scale + offset
        self.nrec = rec.shape[0]
        if centers is None:
            centers = (np.arange(self.nrec) + 0.5) / self.nrec
        self.centers = torch.as_tensor(np.array(centers, dtype),
                                       device=device)
        self.records = torch.as_tensor(rec, device=device)

    def __call__(self, relyr):
        """Linear interpolation at fractional year ``relyr`` (a float or
        a 0-d tensor; periodic), in the records' dtype."""
        c = self.centers
        t = torch.remainder(torch.as_tensor(relyr, dtype=c.dtype,
                                            device=c.device), 1.0)
        # index of the last center <= t (or nrec-1 wrapped when t is
        # before the first center)
        ia = torch.remainder((c <= t).sum() - 1, self.nrec)
        ib = torch.remainder(ia + 1, self.nrec)
        ca = c[ia]
        cb = c[ib]
        # periodic gap handling
        span = torch.where(cb > ca, cb - ca, cb - ca + 1.0)
        dt = torch.where(t >= ca, t - ca, t - ca + 1.0)
        wb = torch.clamp(dt / span, 0.0, 1.0)
        return (1.0 - wb) * self.records[ia] + wb * self.records[ib]


def restoring_flux(data_surf, model_surf, dampts_days, dampdz_cm):
    """Newtonian restoring flux (O_restorst, data.F:130-141):
    stf = dampdz/(dampts*daylen) * (data - model) [tracer-unit cm/s].
    """
    return dampdz_cm / (dampts_days * DAYLEN) * (data_surf - model_surf)


def restoring_stf(stf, t_surface, sst_field, sss_field, relyr,
                  dampts, dampdz, tmask_surf):
    """Fill the T/S rows of a copy of stf with restoring fluxes toward
    the time-interpolated SST/SSS climatology (setvbc restoring path).

    t_surface : (nt, jmt, imt) model surface tracers
    sst_field/sss_field : TimeInterpField or None
    """
    stf = stf.clone()
    if sst_field is not None:
        stf[0] = restoring_flux(sst_field(relyr), t_surface[0], dampts[0],
                                dampdz[0]) * tmask_surf
    if sss_field is not None:
        stf[1] = restoring_flux(sss_field(relyr), t_surface[1], dampts[1],
                                dampdz[1]) * tmask_surf
    return stf


def default_surface_climatology(grid, dtype=np.float64, device=None):
    """Analytic seasonal SST/SSS monthly climatology — the in-repo
    stand-in for O_tempsur.nc / O_salsur.nc (data.F:60-200 readers;
    the reference's files are not shipped).

    SST: zonal profile with a +/-1.8 deg-lat-dependent seasonal cycle
    peaking in late summer of each hemisphere; floor at freezing.
    SSS: zonal profile with subtropical maxima (model salinity units
    (S-35)/1000).

    Returns (sst_field, sss_field) as TimeInterpField (12 records).
    """
    lat = np.asarray(grid.yt)[:, None]
    jmt, imt = grid.jmt, grid.imt
    months = (np.arange(12) + 0.5) / 12.0
    sst = np.zeros((12, jmt, imt))
    sss = np.zeros((12, jmt, imt))
    latr = np.deg2rad(lat)
    annual_sst = -1.9 + 29.0 * np.maximum(np.cos(latr), 0.0) ** 2
    # amplitude grows poleward, capped; phase opposite per hemisphere
    amp = np.minimum(8.0, 0.14 * np.abs(lat))
    sss_zonal = (35.0 + 1.2 * np.exp(-((np.abs(lat) - 25.0) / 15.0) ** 2)
                 - 1.5 * np.exp(-(lat / 10.0) ** 2)
                 - 2.0 * np.maximum(np.abs(lat) - 55.0, 0.0) / 35.0)
    for mrec, tfrac in enumerate(months):
        # NH max late August (t ~ 0.65), SH opposite
        phase = np.cos(2.0 * np.pi * (tfrac - 0.65))
        cyc = amp * phase * np.sign(lat)
        sst[mrec] = np.maximum(annual_sst + cyc, -1.9)
        sss[mrec] = sss_zonal
    return (TimeInterpField(sst, dtype=dtype, device=device),
            TimeInterpField((sss - 35.0) / 1000.0, dtype=dtype,
                            device=device))
