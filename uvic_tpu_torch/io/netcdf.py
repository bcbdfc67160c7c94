"""NetCDF output of the time means (mom_tavg.F, def_files.F).

Port of ``uvic_tpu.io.netcdf`` (NumPy and scipy, unchanged): a writer
over scipy's NetCDF3 implementation that exports time-averaged fields
with CF-style coordinates, a units/long-name catalog for the tavg rows
(def_files.F analog), and an UNLIMITED time dimension so successive
averaging periods append to one file.  A file written here carries the
reference's variables, dimensions and attributes, so either package
reads the other's stream.
"""

from __future__ import annotations

import os

import numpy as np
from scipy.io import netcdf_file

# def_files.F-style variable catalog: name -> (units, long_name).
# Rows absent from the catalog are still written, just without
# attributes (the reference errors instead; being permissive keeps
# user-added diagnostics flowing).
VAR_ATTRS = {
    "temp": ("degC", "potential temperature"),
    "salt": ("psu", "salinity"),
    "u": ("cm s-1", "zonal velocity"),
    "v": ("cm s-1", "meridional velocity"),
    "w": ("cm s-1", "vertical velocity (adv_vbt)"),
    "rho": ("g cm-3", "in-situ density anomaly"),
    "psi": ("cm3 s-1", "barotropic streamfunction"),
    "adv_fe_temp": ("degC cm s-1", "advective heat flux, east face"),
    "adv_fn_temp": ("degC cm s-1", "advective heat flux, north face"),
    "adv_fb_temp": ("degC cm s-1", "advective heat flux, bottom face"),
    "dif_fe_temp": ("degC cm s-1", "diffusive heat flux, east face"),
    "dif_fn_temp": ("degC cm s-1", "diffusive heat flux, north face"),
    "dif_fb_temp": ("degC cm s-1", "diffusive heat flux, bottom face"),
    "vetiso": ("cm s-1", "GM bolus zonal velocity"),
    "vntiso": ("cm s-1", "GM bolus meridional velocity"),
    "wbtiso": ("cm s-1", "GM bolus vertical velocity"),
    "diff_cbt_eff": ("cm2 s-1",
                     "effective vertical tracer diffusivity"),
    "convect_depth": ("cm", "surface-connected convection depth"),
    "convect_nreg": ("1", "stable-region count per column"),
    "hflx": ("cal cm-2 s-1", "surface heat flux as applied"),
    "sflx": ("g cm-2 s-1 (salt)", "virtual salt flux as applied"),
    "taux": ("dyn cm-2", "zonal surface momentum flux"),
    "tauy": ("dyn cm-2", "meridional surface momentum flux"),
    "sat": ("degC", "surface air temperature"),
    "shum": ("g g-1", "surface specific humidity"),
    "hice": ("cm", "sea-ice thickness"),
    "aice": ("1", "sea-ice area fraction"),
    "hsno": ("cm", "snow thickness"),
    "uice": ("cm s-1", "zonal ice velocity"),
    "vice": ("cm s-1", "meridional ice velocity"),
    "tice": ("degC", "ice surface temperature"),
    "soilm": ("g cm-2", "EMBM bucket soil moisture"),
    "precip": ("g cm-2 s-1", "precipitation"),
    "psno": ("g cm-2 s-1", "snowfall"),
    "evap": ("g cm-2 s-1", "evaporation"),
    "runoff": ("g cm-2 s-1", "runoff"),
    "olr": ("erg cm-2 s-1", "outgoing longwave radiation"),
    "swr": ("erg cm-2 s-1", "surface absorbed shortwave"),
    "toa_sw": ("erg cm-2 s-1", "planetary absorbed shortwave"),
    "uplwr": ("erg cm-2 s-1", "surface net upward longwave"),
    "upsens": ("erg cm-2 s-1", "surface sensible heat flux"),
    "upltnt": ("erg cm-2 s-1", "surface latent heat flux"),
    "wspd": ("cm s-1", "surface wind speed"),
    "m_soil": ("kg m-2", "MTLM soil moisture"),
    "lying_snow": ("kg m-2", "MTLM lying snow"),
    "tsoil": ("K", "MTLM soil temperature"),
    "cs": ("kg C m-2", "MTLM soil carbon"),
    "veg_frac": ("1", "vegetated fraction"),
    "nep": ("kg C m-2 s-1", "net ecosystem productivity"),
}


def _define(f, grid, fields):
    f.createDimension("time", None)   # UNLIMITED (must be first: scipy)
    f.createDimension("longitude", grid.imt)
    f.createDimension("latitude", grid.jmt)
    f.createDimension("depth", grid.km)

    def coord(name, dim, data, units):
        v = f.createVariable(name, "d", (dim,))
        v[:] = np.asarray(data)
        v.units = units

    coord("longitude", "longitude", grid.xt, "degrees_east")
    coord("latitude", "latitude", grid.yt, "degrees_north")
    coord("depth", "depth", grid.zt / 100.0, "m")
    tv = f.createVariable("time", "d", ("time",))
    tv.units = "days since 0000-01-01"
    for name, data in fields.items():
        data = np.asarray(data)
        if data.ndim == 2:
            v = f.createVariable(
                name, "f", ("time", "latitude", "longitude"))
        elif data.ndim == 3:
            v = f.createVariable(
                name, "f", ("time", "depth", "latitude", "longitude"))
        else:
            continue
        if name in VAR_ATTRS:
            units, long_name = VAR_ATTRS[name]
            v.units = units
            v.long_name = long_name


def write_tavg(path: str, grid, fields: dict, time_days: float,
               title: str = "uvic_tpu time averages",
               append: bool = False):
    """Write one time-average record.  Fields may be 2-D (jmt, imt) or
    3-D (km, jmt, imt).  With ``append=True`` and an existing file the
    record extends the UNLIMITED time dimension (one file per stream
    across segments, def_files.F/mom_tavg.F behavior); otherwise the
    file is (re)created."""
    mode = "a" if (append and os.path.exists(path)) else "w"
    f = netcdf_file(path, mode)
    try:
        if mode == "w":
            f.title = title
            _define(f, grid, fields)
        tv = f.variables["time"]
        rec = tv.shape[0] if tv.shape and tv.shape[0] else 0
        tv[rec] = time_days
        written = set()
        for name, data in fields.items():
            data = np.asarray(data)
            if name in f.variables and data.ndim in (2, 3):
                f.variables[name][rec] = data.astype(np.float32)
                written.add(name)
        if mode == "a":
            # a config change between resume legs must not silently
            # corrupt the stream: fields missing from this call leave
            # zero-filled planes, new fields cannot be added to a
            # NetCDF3 file — surface both
            coords = {"time", "longitude", "latitude", "depth"}
            stale = set(f.variables) - coords - written
            dropped = {k for k, v in fields.items()
                       if k not in f.variables
                       and getattr(np.asarray(v), "ndim", 0) in (2, 3)}
            if stale or dropped:
                import warnings
                warnings.warn(
                    f"tavg append to {path}: record {rec} leaves "
                    f"{sorted(stale)} zero-filled and cannot add "
                    f"{sorted(dropped)} (NetCDF3 fixed schema) — the "
                    "field set changed since the stream was created",
                    stacklevel=2)
    finally:
        f.close()


def read_var(path: str, name: str) -> np.ndarray:
    f = netcdf_file(path, "r", mmap=False)
    try:
        return np.array(f.variables[name][:])
    finally:
        f.close()
