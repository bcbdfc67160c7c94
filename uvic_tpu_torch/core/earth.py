"""Coarse real-Earth geography for the standard 3.6 x 1.8 deg grid.

Host-side NumPy, the port's own copy of ``uvic_tpu.core.earth``: the
reference reads its bathymetry, elevation and surface climatologies from
data files that do not ship with the source tree (topog.F, setembm.F),
and the earth configuration authors them in-repo instead: continental
outlines as lon/lat polygons rasterized onto the grid, a
distance-to-coast shelf/slope bathymetry with the major ridges,
connectivity repair, analytic wind stress, surface winds, atmospheric
coalbedo and diffusivities, a Levitus-like initial hydrography, a
coarse land elevation and the LGM ice-sheet footprint of the transient
land-ice forcing.  Every field equals the reference's bitwise.
"""

from __future__ import annotations

import numpy as np

from .grid import Grid

# ----------------------------------------------------------------------
# continental outlines: (lon [0-360), lat) vertex lists, coarse
# hand-authored polygons at ~3 deg fidelity

AFRICA = [
    (350.0, 35.5), (11.0, 37.0), (20.0, 32.5), (32.0, 31.0),
    (35.0, 28.0), (43.0, 11.5), (51.5, 11.8), (48.0, 4.0),
    (40.0, -3.0), (40.5, -11.0), (35.0, -20.0), (33.0, -26.0),
    (27.0, -33.5), (19.0, -34.5), (14.0, -28.0), (12.0, -18.0),
    (13.0, -10.0), (9.5, 4.0), (357.0, 5.0), (350.0, 6.5),
    (343.0, 8.0), (342.5, 14.5), (344.0, 19.0), (349.0, 27.0),
    (354.0, 34.0),
]

# Eurasia incl. Arabia and India; the Red Sea / Persian Gulf / Black
# Sea / Caspian close to land at this resolution (the connectivity
# repair would fill them anyway)
EURASIA = [
    (355.0, 36.5), (351.0, 39.0), (351.0, 43.5), (358.0, 48.0),
    (3.0, 51.0), (5.0, 58.0), (5.0, 62.0), (12.0, 65.0),
    (18.0, 69.5), (26.0, 71.0), (40.0, 67.5), (55.0, 69.0),
    (70.0, 73.0), (90.0, 76.0), (105.0, 77.5), (130.0, 72.0),
    (150.0, 70.0), (170.0, 67.0), (189.5, 66.0), (184.0, 63.0),
    (170.0, 60.0), (162.0, 56.0), (157.0, 51.0), (143.0, 47.0),
    (136.0, 41.0), (130.0, 36.0), (122.0, 31.0), (110.0, 20.0),
    (105.0, 10.0), (103.5, 1.5), (98.0, 8.0), (95.0, 16.0),
    (91.0, 22.0), (87.0, 21.0), (80.0, 15.0), (77.0, 8.0),
    (72.0, 19.0), (66.5, 24.5), (57.5, 25.5), (59.0, 22.0),
    (53.0, 16.5), (45.0, 12.5), (43.0, 16.0), (38.0, 22.0),
    (34.5, 28.5), (33.0, 31.0), (35.5, 36.5), (30.0, 41.0),
    (26.5, 40.5), (22.5, 40.0), (19.0, 42.0), (13.5, 45.5),
    (10.0, 44.0), (4.0, 43.0), (0.0, 39.5), (358.5, 36.5),
]

AMERICAS = [
    # Alaska -> Canadian Arctic -> Labrador (Arctic coast)
    (192.0, 66.0), (200.0, 70.5), (235.0, 70.0), (260.0, 71.0),
    (278.0, 69.0), (292.0, 61.0),
    # Atlantic coast southward
    (295.5, 53.0), (288.0, 47.0), (282.0, 44.0), (286.0, 41.0),
    (281.0, 33.0), (279.5, 25.5),
    # around the Gulf of Mexico
    (276.0, 29.0), (270.0, 30.3), (262.5, 29.5), (262.8, 22.0),
    (271.0, 21.5), (273.5, 17.0), (277.0, 8.5),
    # South America Atlantic coast
    (285.0, 11.0), (300.0, 10.0), (310.0, 3.0), (325.0, -6.0),
    (320.0, -23.0), (308.0, -34.0), (297.0, -39.0), (294.5, -52.0),
    (288.5, -55.3),
    # Pacific coast northward
    (286.0, -45.0), (289.5, -30.0), (289.0, -18.0), (281.0, -6.0),
    (279.0, 1.0), (277.5, 7.5),
    # Central America + North America Pacific coast
    (266.0, 16.0), (255.0, 19.5), (245.0, 27.0), (236.0, 35.0),
    (235.5, 43.0), (229.0, 49.5), (215.0, 60.0), (200.0, 64.0),
]

AUSTRALIA = [
    (113.5, -22.0), (115.5, -34.5), (129.0, -32.0), (138.0, -35.5),
    (146.5, -38.5), (153.0, -33.0), (153.5, -25.0), (146.0, -19.0),
    (142.5, -10.8), (136.0, -12.2), (130.0, -12.0), (122.0, -14.5),
]

GREENLAND = [
    (313.0, 60.0), (305.0, 66.0), (298.0, 76.0), (300.0, 82.5),
    (330.0, 82.5), (338.0, 77.0), (335.0, 70.0), (322.0, 65.0),
]

# a Lincoln-Sea land bridge closing the open cyclic channel around the
# North Pole, kept for reference and NOT active: the reference's
# enclosed-basin adjustment with it destabilized the polar cells; the
# channel's free zonal mode is removed at its source instead (the
# ice-ocean drag law and the central-Arctic wind-stress taper)
GREENLAND_POLAR = [
    (300.0, 81.0), (304.0, 90.0), (330.0, 90.0), (331.0, 81.0),
]

NEW_GUINEA = [
    (131.0, -1.5), (141.0, -3.0), (147.0, -6.0), (150.5, -10.0),
    (143.0, -9.0), (134.0, -4.0),
]

MADAGASCAR = [
    (44.0, -12.5), (50.0, -16.0), (47.5, -25.0), (44.0, -25.0),
    (43.2, -16.0),
]

# the polar channel stays open; the ice-ocean drag law and the
# central-Arctic wind-stress taper keep its zonal mode in check
POLYGONS = [AFRICA, EURASIA, AMERICAS, AUSTRALIA, GREENLAND,
            NEW_GUINEA, MADAGASCAR]

# Antarctica: everything south of this latitude, plus the peninsula
ANTARCTIC_LAT = -70.2
PENINSULA = [
    (292.0, -73.0), (297.0, -69.0), (300.5, -63.5), (296.0, -63.0),
    (293.0, -68.0), (288.0, -71.0),
]

# carved straits [(lon_range, lat_range, depth_m)]: kept ocean after
# rasterization (the reference widens these in its 3.6 deg kmt)
STRAITS = [
    ((352.0, 360.0), (34.5, 37.5), 400.0),     # Gibraltar (widened)
]


def _point_in_poly(lon, lat, poly):
    """Vectorized even-odd rule; lon in [0, 360), polygon may cross the
    seam.  The polygon is unwrapped into continuous longitudes, then the
    full even-odd test runs for each 360-shifted copy of the query
    points and the results are OR-ed (a point is inside if any copy
    is)."""
    xs = [float(poly[0][0])]
    for x, _ in poly[1:]:
        x = float(x)
        while x - xs[-1] > 180.0:
            x -= 360.0
        while x - xs[-1] < -180.0:
            x += 360.0
        xs.append(x)
    ys = [float(p[1]) for p in poly]
    n = len(xs)
    result = np.zeros(lon.shape, dtype=bool)
    for shift in (-360.0, 0.0, 360.0):
        xl = lon + shift
        inside = np.zeros(lon.shape, dtype=bool)
        for i in range(n):
            x1, y1 = xs[i], ys[i]
            x2, y2 = xs[(i + 1) % n], ys[(i + 1) % n]
            cond = (y1 > lat) != (y2 > lat)
            with np.errstate(divide="ignore", invalid="ignore"):
                xint = x1 + (lat - y1) / (y2 - y1 + 1e-30) * (x2 - x1)
            inside ^= cond & (xl < xint)
        result |= inside
    return result


def land_mask(grid: Grid) -> np.ndarray:
    """(jmt, imt) bool land mask at T-cell centers."""
    lon = np.asarray(grid.xt) % 360.0
    lat = np.asarray(grid.yt)
    LON, LAT = np.meshgrid(lon, lat)
    land = np.zeros(LON.shape, dtype=bool)
    for poly in POLYGONS:
        land |= _point_in_poly(LON, LAT, poly)
    land |= LAT <= ANTARCTIC_LAT
    land |= _point_in_poly(LON, LAT, PENINSULA)
    return land


def _coast_distance(land: np.ndarray) -> np.ndarray:
    """Distance (in cells) of each ocean cell from the nearest land,
    cyclic in x."""
    from scipy import ndimage
    wide = np.concatenate([land, land, land], axis=1)
    d = ndimage.distance_transform_edt(~wide)
    n = land.shape[1]
    return d[:, n:2 * n]


def earth_depth(grid: Grid) -> np.ndarray:
    """(jmt, imt) T-cell depth [cm]: shelf/slope by distance to coast,
    deep basins, the major mid-ocean ridge systems, shallower Arctic.

    The ridges matter dynamically, not just cosmetically: without
    topographic form stress a flat-bottom circumpolar channel spins up
    an unbounded ACC (the momentum balance of the real Southern Ocean
    runs through the Drake/Kerguelen/Pacific-Antarctic sills)."""
    land = land_mask(grid)
    lat = np.asarray(grid.yt)[:, None]
    d = _coast_distance(land)
    # slope: 1 cell off coast ~2200 m, 2 cells ~3800 m, deep ~5000 m
    depth_m = 5000.0 * (1.0 - np.exp(-np.maximum(d, 0.0) / 1.2))
    depth_m = np.where(lat > 70.0, np.minimum(depth_m, 2500.0), depth_m)
    # Greenland-Scotland/Fram sill band: the Arctic exchanges with the
    # Atlantic over a shallow ridge system; without it warm deep
    # Atlantic water floods the Arctic basin and erodes the halocline
    depth_m = np.where((lat >= 74.0) & (lat <= 80.0),
                       np.minimum(depth_m, 1200.0), depth_m)

    lonf = np.asarray(grid.xt)[None, :] % 360.0
    LON = np.broadcast_to(lonf, depth_m.shape)
    LAT = np.broadcast_to(lat, depth_m.shape)

    def ridge(lon_of_lat, la1, la2, half_w, sill):
        """Meridional ridge along lon_of_lat(lat), gaussian flanks."""
        lr = lon_of_lat(LAT)
        dlon = (LON - lr + 180.0) % 360.0 - 180.0
        inlat = (LAT >= la1) & (LAT <= la2)
        bump = np.exp(-0.5 * (dlon / half_w) ** 2)
        return np.where(inlat, sill + (5000.0 - sill) * (1.0 - bump),
                        5000.0)

    # Mid-Atlantic Ridge (meandering S-shape)
    depth_m = np.minimum(depth_m, ridge(
        lambda la: 342.0 + 0.25 * la - 12.0 * (la < -5.0), -55.0, 65.0,
        6.0, 3000.0))
    # East Pacific Rise
    depth_m = np.minimum(depth_m, ridge(
        lambda la: 247.0 - 0.5 * la, -60.0, 5.0, 7.0, 3200.0))
    # Southwest/Central Indian Ridge
    depth_m = np.minimum(depth_m, ridge(
        lambda la: 68.0 - 0.4 * la, -55.0, -10.0, 7.0, 3300.0))
    # circumpolar sills: Drake/Scotia arc and Kerguelen plateau
    drake = ((LON >= 288.0) & (LON < 306.0)
             & (LAT >= -64.0) & (LAT <= -54.0))
    depth_m = np.where(drake, np.minimum(depth_m, 3000.0), depth_m)
    kerg = ((LON >= 68.0) & (LON < 84.0)
            & (LAT >= -58.0) & (LAT <= -46.0))
    depth_m = np.where(kerg, np.minimum(depth_m, 2200.0), depth_m)
    pac_ant = ((LON >= 180.0) & (LON < 230.0)
               & (LAT >= -66.0) & (LAT <= -56.0))
    depth_m = np.where(pac_ant, np.minimum(depth_m, 3000.0), depth_m)

    depth_m = np.where(land, 0.0, np.maximum(depth_m, 0.0))
    # carved straits override
    lon = np.asarray(grid.xt)[None, :] % 360.0
    latg = np.broadcast_to(lat, depth_m.shape)
    for (lo1, lo2), (la1, la2), dep in STRAITS:
        sel = (lon >= lo1) & (lon < lo2) & (latg >= la1) & (latg < la2)
        depth_m = np.where(sel, dep, depth_m)
    return depth_m * 100.0   # cm


def repair_connectivity(kmt: np.ndarray, cyclic: bool = True
                        ) -> np.ndarray:
    """Fill ocean cells not connected to the main ocean (isolated seas
    that the coarse polygons pinch off) — the topog.F kmt-repair
    equivalent."""
    from scipy import ndimage
    ocean = kmt[:, 1:-1] > 0 if cyclic else kmt > 0
    lab, n = ndimage.label(ocean)
    if cyclic:
        # merge labels across the seam
        for j in range(lab.shape[0]):
            a, b = lab[j, 0], lab[j, -1]
            if a > 0 and b > 0 and a != b:
                lab[lab == b] = a
    sizes = np.bincount(lab.ravel())
    sizes[0] = 0
    main = int(np.argmax(sizes))
    keep = lab == main
    out = kmt.copy()
    if cyclic:
        interior = out[:, 1:-1]
        interior[~keep & (interior > 0)] = 0
        out[:, 1:-1] = interior
        out[:, 0] = out[:, -2]
        out[:, -1] = out[:, 1]
    else:
        out[~keep & (out > 0)] = 0
    return out


def earth_kmt(grid: Grid) -> np.ndarray:
    """kmt for the coarse real Earth (topog.F path with in-repo data)."""
    from .topog import kmt_from_depth
    depth = earth_depth(grid)
    kmt = kmt_from_depth(grid, depth)
    kmt = repair_connectivity(kmt, grid.cyclic)
    # drop 1-cell land islands that only touch diagonally (they break
    # no physics but add needless island constraint equations)
    return kmt


def atlantic_mask(grid: Grid) -> np.ndarray:
    """(jmt, imt) 1.0 on Atlantic-sector cells (for the basin MOC
    diagnostic, diagi.F overturning by basin): lon 260-360/0-20
    narrowing to the Atlantic proper north of the Gulf of Mexico,
    lat -34..70."""
    lon = np.asarray(grid.xt)[None, :] % 360.0
    lat = np.asarray(grid.yt)[:, None]
    LON = np.broadcast_to(lon, (grid.jmt, grid.imt))
    LAT = np.broadcast_to(lat, (grid.jmt, grid.imt))
    west = np.where(LAT > 18.0, 278.0, 290.0)   # exclude Gulf/Caribbean
    sector = ((LON >= west) | (LON < 20.0)) & (LAT >= -34.0) \
        & (LAT <= 70.0)
    # exclude the Pacific side south of Panama
    sector &= ~((LON >= 260.0) & (LON < 285.0) & (LAT < 8.0))
    return sector.astype(np.float64)


def _gauss(lat, c, w):
    return np.exp(-0.5 * ((np.asarray(lat, dtype=float) - c) / w) ** 2)


def earth_wind_stress(grid: Grid) -> np.ndarray:
    """(2, jmt, imt) surface wind stress [dyn/cm^2] at U cells.

    Analytic zonal-mean climatology standing in for the NCEP
    A_windstrX/Y.nc fields the reference reads (setembm.F wind stress;
    the data files are not shipped).  Magnitudes follow the published
    zonal means: trade easterlies ~0.06 Pa, NH westerlies ~0.1 Pa, the
    stronger SH westerlies ~0.17 Pa over the circumpolar channel, weak
    polar easterlies.  1 Pa = 10 dyn/cm^2."""
    lat = grid.yu
    tx = (-0.65 * (_gauss(lat, 15.0, 9.0) + _gauss(lat, -15.0, 9.0))
          + 1.0 * _gauss(lat, 45.0, 9.0) + 1.5 * _gauss(lat, -50.0, 9.0)
          - 0.25 * _gauss(lat, 75.0, 7.0) - 0.15 * _gauss(lat, -66.0, 6.0))
    # meridional component: trade-wind convergence toward the ITCZ
    ty = (-0.20 * _gauss(lat, 12.0, 8.0) + 0.20 * _gauss(lat, -12.0, 8.0))
    # central-Arctic taper: the polar-easterly band belongs to the
    # Beaufort High at ~75-80 N; observed central-Arctic curl is weak
    taper_n = 1.0 / (1.0 + np.exp((lat - 81.0) / 1.5))
    tx = tx * taper_n
    ty = ty * taper_n
    jmt, imt = grid.jmt, grid.imt
    return np.stack([np.broadcast_to(tx[:, None], (jmt, imt)),
                     np.broadcast_to(ty[:, None], (jmt, imt))]).copy()


def earth_surface_wind(grid: Grid):
    """(winds (2, jmt, imt) [cm/s], wspd (jmt, imt) [cm/s]).

    Advecting winds for the EMBM transport operator plus the surface
    wind speed entering every bulk formula (evaporation, sensible
    heat, ice sublimation, gas-exchange piston velocity) — analytic
    stand-ins for the reference's wind data at realistic amplitudes
    (trades ~5 m/s easterly, SH westerlies ~9 m/s; scalar mean speed
    ~5-8 m/s with the Southern Ocean maximum)."""
    lat = grid.yu
    u = 100.0 * (-5.0 * (_gauss(lat, 15.0, 10.0) + _gauss(lat, -15.0, 10.0))
                 + 7.0 * _gauss(lat, 46.0, 11.0)
                 + 9.0 * _gauss(lat, -50.0, 11.0)
                 - 2.0 * _gauss(lat, 75.0, 7.0)
                 - 2.0 * _gauss(lat, -66.0, 6.0))
    # no meridional ADVECTING component: a sustained convergent v in
    # the flux-form upstream operator (solve.F:571-607) pumps tracer
    # into the convergence line faster than diffusion can remove it
    # (e-folding |div v| ~ days); the real meridional moisture
    # transport is carried by the Hadley-cell diffusivity enhancement
    # (earth_atm_diff).  The ITCZ convergence lives in the STRESS
    # field only (earth_wind_stress), where it belongs.
    v = np.zeros_like(u)
    wspd = 100.0 * (4.5 + 2.5 * (_gauss(lat, 15.0, 12.0)
                                 + _gauss(lat, -15.0, 12.0))
                    + 3.0 * _gauss(lat, 46.0, 12.0)
                    + 5.0 * _gauss(lat, -52.0, 12.0))
    jmt, imt = grid.jmt, grid.imt
    winds = np.stack([np.broadcast_to(u[:, None], (jmt, imt)),
                      np.broadcast_to(v[:, None], (jmt, imt))]).copy()
    return winds, np.broadcast_to(wspd[:, None], (jmt, imt)).copy()


def earth_atm_coalbedo(grid: Grid) -> np.ndarray:
    """(jmt, imt) atmospheric coalbedo (stand-in for A_calb.nc).

    Tuned against the annual-mean zonal TOA budget of the coupled
    model: the meridional gradient sets the poleward heat transport
    the circulation must carry."""
    lat = np.asarray(grid.yt, dtype=float)
    aca = (0.81 - 0.085 * np.sin(np.deg2rad(lat)) ** 2
           - 0.01 * _gauss(lat, 52.0, 12.0)
           - 0.005 * _gauss(lat, -57.0, 8.0)
           + 0.025 * _gauss(lat, 72.0, 12.0))
    # uniform -0.66% rescale, for the conserving row-1 transport
    # operator (asw is linear in aca)
    aca *= 0.9934
    return np.broadcast_to(aca[:, None], (grid.jmt, grid.imt)).copy()


def earth_atm_diff(grid: Grid):
    """(diff_t, diff_q) atmospheric eddy diffusivities [cm^2/s]
    (stand-in for the A_diff.nc A_difft*/A_diffq* fields; reference
    fallback is a flat 5e9, setembm.F:265-266).

    Heat: storm-track (baroclinic eddy) enhancement over the flat
    background.  Moisture: Hadley-region enhancement with the flat
    background elsewhere (the subtropical minimum keeps the dry zones
    dry)."""
    lat = np.asarray(grid.yt, dtype=float)
    # polar caps: without the enhancement the polar annual SAT settles
    # near -55 C (transport-starved); the reference's A_difft fields
    # carry the same high-latitude rise
    polar_nh = 1.0 / (1.0 + np.exp(-(lat - 63.0) / 5.0))
    polar_sh = 1.0 / (1.0 + np.exp(-(-lat - 63.0) / 5.0))
    # the stronger SH polar enhancement carries heat to the winter ice
    # edge
    dt_ = 5.0e9 * (0.9 + 1.5 * _gauss(lat, 47.0, 13.0)
                   + 1.8 * _gauss(lat, -52.0, 14.0)
                   + 2.8 * polar_nh + 4.0 * polar_sh)
    dq = 5.0e9 * (0.9 + 0.7 * _gauss(lat, 0.0, 11.0))
    jmt, imt = grid.jmt, grid.imt
    return (np.broadcast_to(dt_[:, None], (jmt, imt)).copy(),
            np.broadcast_to(dq[:, None], (jmt, imt)).copy())


def earth_initial_ts(grid: Grid, kmt: np.ndarray):
    """(temp (km,jmt,imt) [C], salt (km,jmt,imt) [model units
    (S-35)/1000]) — a zonal-mean Levitus-like initial hydrography
    (stand-in for the reference's Levitus IC data, setmom.F ic read).

    Structure matters more than detail here: the polar halocline
    (fresh, near-freezing surface over warmer deep water) is what
    permits winter sea ice on a multi-year spinup — a uniform-salinity
    warm start instead convects the full polar column and delays ice
    onset by decades."""
    lat = np.asarray(grid.yt)[:, None]
    z = np.asarray(grid.zt)[:, None, None]      # cm
    jmt, imt = grid.jmt, grid.imt
    LAT = np.broadcast_to(lat, (jmt, imt))

    # surface temperature: warm tropics to freezing poles
    sst = -1.5 + 29.0 * np.exp(-(LAT / 38.0) ** 2)
    # thermocline decay to a 1C abyss; thinner thermocline at high lat
    scale = (350.0 + 650.0 * np.exp(-(LAT / 30.0) ** 2)) * 100.0  # cm
    # deep water is coldest under the polar formation regions (the
    # 1 C-everywhere start kept melting Arctic ice from below); the
    # Southern-Ocean subsurface stays CDW-warm (real ~1.5 C at
    # 500-2000 m) so winter convection can limit the ice edge
    deep = 0.2 + 1.3 * np.exp(-(LAT / 45.0) ** 2)
    deep = np.where(LAT < -45.0,
                    0.5 + 0.8 * np.exp(-((LAT + 45.0) / 30.0) ** 2),
                    deep)
    temp = deep[None] + (sst - deep)[None] * np.exp(-z / scale[None])

    # salinity [psu]: subtropical evaporation maxima, ITCZ minimum,
    # fresh polar caps (Arctic fresher than Southern Ocean)
    # polar caps: Arctic strongly fresh (real halocline); Southern
    # Ocean only ~0.8 psu fresh
    sss = (34.7 + 1.3 * (np.exp(-((LAT - 22.0) / 14.0) ** 2)
                         + np.exp(-((LAT + 18.0) / 14.0) ** 2))
           - 0.6 * np.exp(-(LAT / 6.0) ** 2)
           - 2.5 / (1.0 + np.exp(-(LAT - 68.0) / 4.0))
           - 1.2 / (1.0 + np.exp(-(-LAT - 60.0) / 4.0)))
    deep_s = 34.7
    hal_scale = 60000.0    # 600 m halocline
    salt = deep_s + (sss - deep_s)[None] * np.exp(-z / hal_scale)

    tmask = (np.arange(grid.km)[:, None, None]
             < kmt[None]).astype(float)
    temp = temp * tmask
    salt_model = (salt - 35.0) / 1000.0 * tmask
    return temp, salt_model


def earth_elevation(grid: Grid) -> np.ndarray:
    """(jmt, imt) land surface elevation [cm] for the EMBM lapse-rate
    terms (setembm.F elevation data analog): major orography only."""
    land = land_mask(grid)
    lon = np.asarray(grid.xt)[None, :] % 360.0
    lat = np.asarray(grid.yt)[:, None]
    LAT = np.broadcast_to(lat, land.shape)
    LON = np.broadcast_to(lon, land.shape)
    elev = np.where(land, 400.0, 0.0)   # m

    def bump(lo1, lo2, la1, la2, h):
        sel = (LON >= lo1) & (LON < lo2) & (LAT >= la1) & (LAT < la2)
        return np.where(sel & land, h, 0.0)

    elev = np.maximum(elev, bump(72.0, 105.0, 27.0, 40.0, 4500.0))   # Tibet
    elev = np.maximum(elev, bump(286.0, 293.0, -40.0, 10.0, 3500.0))  # Andes
    elev = np.maximum(elev, bump(240.0, 258.0, 33.0, 58.0, 1800.0))  # Rockies
    elev = np.maximum(elev, np.where(
        _point_in_poly(LON, LAT, GREENLAND), 2000.0, 0.0))
    elev = np.maximum(elev, np.where(LAT <= ANTARCTIC_LAT, 2400.0, 0.0))
    return elev * 100.0   # cm


# LGM continental ice-sheet outlines (~21 ka footprint at 3-deg
# fidelity): Laurentide+Cordilleran, Fennoscandian+Barents-Kara,
# Patagonian; Greenland and Antarctica are ice in the modern albedo
# profile already (icedata.F reads these from L_icefra data)
LGM_ICE = [
    [(215.0, 47.0), (240.0, 48.0), (262.0, 38.0), (283.0, 38.0),
     (295.0, 45.0), (300.0, 60.0), (290.0, 72.0), (260.0, 74.0),
     (230.0, 72.0), (212.0, 62.0)],                       # N America
    [(348.0, 51.0), (10.0, 50.0), (35.0, 52.0), (62.0, 58.0),
     (90.0, 68.0), (95.0, 77.0), (60.0, 80.0), (20.0, 75.0),
     (352.0, 62.0)],                                      # Eurasia
    [(287.0, -56.0), (290.0, -38.0), (293.5, -38.0), (293.0, -55.0)],
]


def landice_fields(grid: Grid, scale: float):
    """(aicel, hicel): land-ice fraction (0/1) and ice-sheet surface
    elevation anomaly [cm] at ice-sheet extent ``scale`` (0 = modern,
    1 = LGM), following icedata.F's >=0.5 binarization of the
    time-interpolated fraction and its hicel elevation addition
    (applied as elev + hicel in fluxes.F:112,344).  The elevation grows
    continuously from 0 at the 0.5 crossing to the full ~2.5 km domes
    at scale 1, as icedata.F's time interpolation of gridded hicel
    does."""
    land = land_mask(grid)
    lon = np.asarray(grid.xt) % 360.0
    lat = np.asarray(grid.yt)
    LON, LAT = np.meshgrid(lon, lat)
    lgm = np.zeros(LON.shape, dtype=bool)
    for poly in LGM_ICE:
        lgm |= _point_in_poly(LON, LAT, poly)
    lgm &= land
    aicel = ((lgm.astype(float) * float(scale)) >= 0.5).astype(float)
    ramp = min(max((float(scale) - 0.5) / 0.5, 0.0), 1.0)
    hicel = aicel * 2500.0e2 * ramp
    return aicel, hicel
