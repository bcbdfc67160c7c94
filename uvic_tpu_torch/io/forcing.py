"""Transient forcing time series (CO2, solar, volcanic, sulphate, ...).

Port of ``uvic_tpu.io.forcing`` (NumPy only, unchanged): the
source/common/*data.F reader family (co2data.F, c14data.F, solardata.F,
volcdata.F, sulphdata.F, sealevdata.F, ...) and the linear time
interpolation they share (timeinterp.F).  Each forcing is a
TransientSeries: a (time, value) table read from a NetCDF/CSV file when
given, else built from the documented defaults written below, sampled
by linear interpolation at the model year.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class TransientSeries:
    """Piecewise-linear time series (timeinterp.F semantics: clamp at
    the ends, linear in between)."""
    times: np.ndarray     # years
    values: np.ndarray

    def at(self, year: float) -> float:
        return float(np.interp(year, self.times, self.values))

    @classmethod
    def from_netcdf(cls, path, time_var, value_var):
        from scipy.io import netcdf_file
        f = netcdf_file(path, "r", mmap=False)
        try:
            t = np.array(f.variables[time_var][:], dtype=float)
            v = np.array(f.variables[value_var][:], dtype=float)
        finally:
            f.close()
        return cls(times=t, values=v)

    @classmethod
    def from_csv(cls, path):
        data = np.loadtxt(path, delimiter=",", ndmin=2)
        return cls(times=data[:, 0], values=data[:, 1])

    @classmethod
    def constant(cls, value):
        return cls(times=np.array([0.0, 1.0]), values=np.array([value,
                                                                value]))


def co2_series(path=None) -> TransientSeries:
    """Atmospheric CO2 [ppmv] vs year (co2data.F). Default: a compact
    ice-core + Mauna Loa history (decadal anchor points)."""
    if path:
        return TransientSeries.from_csv(path)
    years = np.array([1000, 1750, 1800, 1850, 1900, 1930, 1950, 1970,
                      1990, 2000, 2010, 2020], dtype=float)
    ppm = np.array([280, 277, 283, 285, 296, 307, 311, 326, 354, 369,
                    389, 414], dtype=float)
    return TransientSeries(years, ppm)


def solar_series(path=None) -> TransientSeries:
    """Total solar irradiance [erg/cm^2/s] vs year (solardata.F).
    Default: constant modern value."""
    if path:
        return TransientSeries.from_csv(path)
    return TransientSeries.constant(1.368e6)


def volcanic_series(path=None) -> TransientSeries:
    """Volcanic radiative forcing reduction [erg/cm^2/s] (volcdata.F).
    Default: zero."""
    if path:
        return TransientSeries.from_csv(path)
    return TransientSeries.constant(0.0)


def c14_series(path=None) -> TransientSeries:
    """Atmospheric Delta-14C [permil] (c14data.F). Default: the
    bomb-spike history (tropospheric mean, decadal anchors)."""
    if path:
        return TransientSeries.from_csv(path)
    years = np.array([1000, 1850, 1900, 1950, 1955, 1960, 1964, 1967,
                      1970, 1975, 1980, 1990, 2000, 2010, 2020],
                     dtype=float)
    permil = np.array([0, 0, -3, -20, 20, 220, 700, 570, 525, 390,
                       260, 150, 70, 25, 0], dtype=float)
    return TransientSeries(years, permil)


def agg_series(path=None) -> TransientSeries:
    """Additional (non-CO2) greenhouse-gas radiative forcing vs year
    (aggdata.F O_aggfor_data): CH4 + N2O + halocarbons, in erg/cm^2/s
    (1 W/m^2 = 1e3 erg/cm^2/s).  Default: the published anthropogenic
    non-CO2 GHG forcing history (decadal anchors)."""
    if path:
        return TransientSeries.from_csv(path)
    years = np.array([1000, 1850, 1900, 1950, 1970, 1990, 2000, 2010,
                      2020], dtype=float)
    wm2 = np.array([0.0, 0.0, 0.06, 0.18, 0.38, 0.72, 0.82, 0.92,
                    1.05])
    return TransientSeries(years, wm2 * 1.0e3)


def sealev_series(path=None) -> TransientSeries:
    """Sea level relative to present [cm] vs year (sealevdata.F);
    default zero (the 21ka deglaciation curve is paleo data)."""
    if path:
        return TransientSeries.from_csv(path)
    return TransientSeries.constant(0.0)


def sulphate_series(path=None) -> TransientSeries:
    """Anthropogenic sulphate aerosol optical-depth SCALE vs year
    (sulphdata.F reads gridded loadings; we carry the global burden
    history as a scalar multiplying a fixed NH-industrial spatial
    pattern, `sulphate_pattern`).  Units: peak surface-coalbedo
    reduction (dimensionless, applied as sca - sulph)."""
    if path:
        return TransientSeries.from_csv(path)
    years = np.array([1000, 1850, 1900, 1930, 1950, 1970, 1980, 1990,
                      2000, 2010, 2020], dtype=float)
    # scaled to a peak regional coalbedo reduction ~0.03 around 1980
    scale = np.array([0.0, 0.001, 0.006, 0.012, 0.018, 0.028, 0.030,
                      0.028, 0.022, 0.018, 0.015])
    return TransientSeries(years, scale)


def sulphate_pattern(yt_deg, xt_deg=None, imt=None):
    """Fixed spatial pattern of the anthropogenic sulphate burden:
    northern-hemisphere industrial band (30N-60N) with smooth falloff
    (stand-in for the sulphdata.F gridded loading, whose data file is
    not shipped).  Returns (jmt, imt), peak 1.0."""
    lat = np.asarray(yt_deg, dtype=float)
    band = np.exp(-0.5 * ((lat - 45.0) / 15.0) ** 2)
    if imt is None:
        imt = 1
    return np.broadcast_to(band[:, None], (lat.shape[0], imt)).copy()


_CFC_YEARS = np.array([1930, 1940, 1950, 1955, 1960, 1965, 1970, 1975,
                       1980, 1985, 1990, 1994, 1998, 2002, 2006, 2010],
                      dtype=float)
# northern-hemisphere dry mole fractions [pptv]; decadal anchor points
# of the Walker/Weiss/Salameh reconstruction used by cfcdata.F (the
# reference's data file is not shipped; values are the published curve)
_CFC11_NH = np.array([0.0, 0.1, 1.0, 3.3, 9.5, 23.0, 52.8, 106.1,
                      161.9, 203.7, 255.3, 268.0, 266.4, 260.5, 251.3,
                      240.9])
_CFC12_NH = np.array([0.0, 0.4, 4.3, 11.2, 29.5, 58.8, 114.3, 203.1,
                      297.1, 376.3, 481.7, 516.3, 533.8, 540.7, 537.8,
                      531.6])


def cfc_series(which: int = 11, hemisphere: str = "n",
               path=None) -> TransientSeries:
    """Atmospheric CFC-11/12 [pptv] vs year by hemisphere (cfcdata.F).
    The southern hemisphere lags the northern source regions by ~1.5
    years along the rising limb."""
    if path:
        return TransientSeries.from_csv(path)
    vals = _CFC11_NH if which == 11 else _CFC12_NH
    years = _CFC_YEARS if hemisphere == "n" else _CFC_YEARS + 1.5
    return TransientSeries(years, vals)


@dataclass
class TransientForcing:
    """The forcing bundle evaluated each segment (gasbc.F data calls)."""
    co2: TransientSeries
    solar: TransientSeries
    volcanic: TransientSeries
    c14: TransientSeries
    cfc11_n: TransientSeries = None
    cfc11_s: TransientSeries = None
    cfc12_n: TransientSeries = None
    cfc12_s: TransientSeries = None
    sulph: TransientSeries = None
    agg: TransientSeries = None
    sealev: TransientSeries = None
    landice: TransientSeries = None

    @classmethod
    def default(cls):
        return cls(co2=co2_series(), solar=solar_series(),
                   volcanic=volcanic_series(), c14=c14_series(),
                   cfc11_n=cfc_series(11, "n"), cfc11_s=cfc_series(11, "s"),
                   cfc12_n=cfc_series(12, "n"), cfc12_s=cfc_series(12, "s"),
                   sulph=sulphate_series(), agg=agg_series(),
                   sealev=sealev_series(), landice=landice_series())

    def at(self, year: float) -> dict:
        out = dict(
            co2ccn=self.co2.at(year),
            solarconst=self.solar.at(year) - self.volcanic.at(year),
            dc14ccn=self.c14.at(year),
        )
        if self.sulph is not None:
            out["sulph_scale"] = self.sulph.at(year)
        if self.agg is not None:
            out["aggfor"] = self.agg.at(year)
        if self.sealev is not None:
            out["sealev"] = self.sealev.at(year)
        if self.landice is not None:
            out["icesheet"] = self.landice.at(year)
        if self.cfc11_n is not None:
            out.update(
                cfc11ccnn=self.cfc11_n.at(year),
                cfc11ccns=self.cfc11_s.at(year),
                cfc12ccnn=self.cfc12_n.at(year),
                cfc12ccns=self.cfc12_s.at(year))
        return out


def landice_series(path=None) -> TransientSeries:
    """Continental ice-sheet EXTENT scale vs year (icedata.F
    O_landice_data reads gridded L_icefra/L_icethk histories; we carry
    a scalar 0..1 interpolating the authored modern -> LGM footprint,
    core/earth.landice_fields).  Default: constant 0 (modern)."""
    if path:
        return TransientSeries.from_csv(path)
    return TransientSeries.constant(0.0)
