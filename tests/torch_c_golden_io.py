"""Inputs and blobs of the four C golden programs
(``golden/c_golden/{tracer,clinic,congrad,isopyc}_golden.c``) built from
the port's models: the recipes of ``tests/test_c_golden*.py`` (the same
grids, seeds, fields and blob layouts), which write theirs inside their
test functions.  No JAX here: the port's grid constants go into the blob,
and the port's steps are held against what the C programs compute from
it.
"""

import dataclasses
import os
import struct
import subprocess

import numpy as np
import torch

from uvic_tpu_torch.config import small_config
from uvic_tpu_torch.models.ocean.model import eos_state_from, make_ocean
from uvic_tpu_torch.ops.stencil import setbcx

CDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                    "golden", "c_golden")
SCHEME_ID = {"centered": 0, "fct": 1, "fct_dlm2": 2}


def compile_program(name, out_dir, std="c99"):
    """gcc -O2 of ``golden/c_golden/<name>.c`` into ``out_dir``."""
    exe = os.path.join(str(out_dir), name)
    subprocess.run(["gcc", "-O2", f"-std={std}", "-o", exe,
                    os.path.join(CDIR, name + ".c"), "-lm"], check=True)
    return exe


def run_program(exe, blob, out, header_fmt, header, dheader_fmt, dheader,
                arrays, shape):
    """Write the blob (int header, double header, the arrays as <f8), run
    the program and read its output (reshaped to ``shape`` if given)."""
    with open(blob, "wb") as f:
        f.write(struct.pack(header_fmt, *header))
        f.write(struct.pack(dheader_fmt, *dheader))
        for a in arrays:
            f.write(np.ascontiguousarray(np.asarray(a), dtype="<f8")
                    .tobytes())
    subprocess.run([exe, str(blob), str(out)], check=True)
    raw = np.fromfile(out, dtype="<f8")
    return raw if shape is None else raw.reshape(shape)


def _bc(a):
    return setbcx(torch.as_tensor(a), True).numpy()


def tracer_case(scheme, fct3d=False, nsteps=10, ncon=2):
    """``tests/test_c_golden.py:_run_case``'s model and inputs: (model,
    dict of t0, u, v, stf, btf, c2dtts), the blob headers and arrays."""
    cfg = small_config(imt=40, jmt=34, km=8)
    m = make_ocean(cfg, device="cpu")
    g, bag = m.params.grid, m.g
    nt, km, jmt, imt = 2, g.km, g.jmt, g.imt
    c2dtts = 2.0 * 21600.0
    rng = np.random.default_rng(7)
    tmask, umask = np.asarray(m.tmask), np.asarray(m.umask)
    t0 = np.zeros((nt, km, jmt, imt))
    t0[0] = (18.0 * np.exp(-np.asarray(g.zt) / 800e2))[:, None, None]
    t0[0, 0, 10:14, 8:14] = 2.0
    t0[0, :3, 18:22, 20:28] = 0.5
    t0[1] = 1e-3 * rng.normal(size=(km, jmt, imt))
    t0 = _bc(t0 * tmask)
    u = 5.0 * np.cos(np.deg2rad(np.asarray(g.yu)))[None, :, None] \
        * np.ones((km, jmt, imt))
    v = 2.0 * np.sin(np.deg2rad(2 * np.asarray(g.yu)))[None, :, None] \
        * np.ones((km, jmt, imt))
    u, v = _bc(u * umask), _bc(v * umask)
    stf = np.zeros((nt, jmt, imt))
    stf[0] = 2e-5 * np.cos(np.deg2rad(np.asarray(g.yt)))[:, None]
    stf[1] = -1e-8
    stf *= tmask[0]
    btf = np.zeros((nt, jmt, imt))
    arrays = [g.dxu, g.dyu, g.csu, g.dxt2r, g.dyt2r, g.dxtr, g.dytr, g.cstr,
              g.dzt, bag.cstdxt2r, bag.cstdyt2r, g.dzt2r, bag.cstdxur,
              bag.cstdxtr, m.params.ahc_north, m.params.ahc_south, g.dztr,
              g.dztur, g.dztlr, bag.dtxcel, m.dztxcl, m.eos_c, m.eos_to,
              m.eos_so, np.asarray(m.kmt).astype(np.float64), tmask,
              m.diff_cbt, u, v, stf, btf, t0, t0]
    header = (nt, km, jmt, imt, nsteps, ncon, SCHEME_ID[scheme], int(fct3d))
    inputs = dict(t0=t0, u=u, v=v, stf=stf, btf=btf, c2dtts=c2dtts,
                  nsteps=nsteps, ncon=ncon, shape=(nt, km, jmt, imt))
    return m, inputs, ("<8i", header, "<2d", (c2dtts, cfg.ocean.ah), arrays)


def clinic_case(nsteps=10):
    """``tests/test_c_golden_clinic.py``'s model and inputs."""
    cfg = small_config(imt=40, jmt=34, km=8)
    m = make_ocean(cfg, device="cpu")
    g, bag, params = m.params.grid, m.g, m.params
    km, jmt, imt = g.km, g.jmt, g.imt
    c2dtuv = 2.0 * 1800.0
    rng = np.random.default_rng(11)
    umask, tmask = np.asarray(m.umask), np.asarray(m.tmask)
    t0 = np.zeros((2, km, jmt, imt))
    lat = np.asarray(g.yt)[:, None]
    t0[0] = ((18.0 * np.exp(-np.asarray(g.zt) / 800e2))[:, None, None]
             * (0.6 + 0.4 * np.cos(np.deg2rad(lat)))[None])
    t0[1] = 1e-3 * rng.normal(size=(km, jmt, imt))
    t0 = _bc(t0 * tmask)
    rho = eos_state_from(m.eos_c, m.eos_to, m.eos_so,
                         torch.as_tensor(t0)).numpy()
    u0 = np.zeros((2, km, jmt, imt))
    u0[0] = (4.0 * np.cos(np.deg2rad(np.asarray(g.yu)))[None, :, None]
             * np.exp(-np.asarray(g.zt) / 1500e2)[:, None, None])
    u0[1] = (1.5 * np.sin(np.deg2rad(2 * np.asarray(g.yu)))[None, :, None]
             * np.exp(-np.asarray(g.zt) / 1500e2)[:, None, None])
    u0 = _bc(u0 * umask)
    smf = np.zeros((2, jmt, imt))
    smf[0] = 0.8 * np.sin(np.deg2rad(3 * np.asarray(g.yu)))[:, None]
    smf *= umask[0]
    bmf = np.zeros((2, jmt, imt))
    am_csudxtr = (bag.am * np.asarray(g.csur)[:, None]
                  * np.roll(np.asarray(g.dxtr), -1)[None, :])
    arrays = [g.dxu, g.dyu, g.csu, g.dxt2r, g.dyt2r, g.dxtr, g.dytr, g.cstr,
              g.dzt, g.duw, g.due, g.dun, g.dus, g.dxur, g.dyur, g.csur,
              g.cst, g.dzt2r, g.dztr, np.asarray(g.dzw)[:km],
              np.asarray(g.dzwr)[1:], g.dxu2r, g.dyu2r, g.dyu4r,
              bag.csudxu2r, bag.csudxur, bag.csudyu2r, am_csudxtr,
              params.amc_north, params.amc_south, params.am3, params.am4,
              params.advmet, g.dxmetr, params.cori, bag.hr,
              np.asarray(m.kmu).astype(np.float64), umask, m.visc_cbu, smf,
              bmf, rho, u0]
    inputs = dict(u0=u0, rho=rho, smf=smf, bmf=bmf, c2dtuv=c2dtuv,
                  nsteps=nsteps, shape=(2, km, jmt, imt))
    return m, inputs, ("<4i", (km, jmt, imt, nsteps), "<2d",
                       (c2dtuv, float(bag.grav_rho0r)), arrays)


def congrad_forcing(m):
    """``tests/test_c_golden_congrad.py``'s depth-averaged forcing zu."""
    g = m.params.grid
    jmt, imt = g.jmt, g.imt
    yu = np.asarray(g.yu)
    zu = np.zeros((2, jmt, imt))
    zu[0] = 1.0e-4 * np.sin(np.deg2rad(3.0 * yu))[:, None]
    zu[1] = 3.0e-5 * np.cos(np.deg2rad(2.0 * yu))[:, None] \
        * np.sin(np.linspace(0, 4 * np.pi, imt))[None, :]
    return zu * np.asarray(m.umask)[0][None]


def isopyc_case(nsteps=8, ncon=2):
    """``tests/test_c_golden_isopyc.py``'s model and inputs."""
    cfg = small_config(imt=40, jmt=34, km=8)
    cfg = cfg.replace(ocean=dataclasses.replace(
        cfg.ocean, isopycmix=True, gent_mcwilliams=True, aniso_zonal=True))
    m = make_ocean(cfg, device="cpu")
    o = cfg.ocean
    g, bag = m.params.grid, m.g
    nt, km, jmt, imt = 2, g.km, g.jmt, g.imt
    c2dtts = 2.0 * 21600.0
    rng = np.random.default_rng(13)
    tmask, umask = np.asarray(m.tmask), np.asarray(m.umask)
    t0 = isopyc_stratification(m)
    t0[0, 0, 10:14, 8:14] = 2.0
    t0[0, :3, 18:22, 20:28] = 1.0
    t0[1] = 2e-4 * rng.normal(size=(km, jmt, imt))
    t0 = _bc(t0 * tmask)
    u = 4.0 * np.cos(np.deg2rad(np.asarray(g.yu)))[None, :, None] \
        * np.ones((km, jmt, imt))
    v = 1.5 * np.sin(np.deg2rad(2 * np.asarray(g.yu)))[None, :, None] \
        * np.ones((km, jmt, imt))
    u, v = _bc(u * umask), _bc(v * umask)
    stf = np.zeros((nt, jmt, imt))
    stf[0] = 2e-5 * np.cos(np.deg2rad(np.asarray(g.yt)))[:, None]
    stf[1] = -1e-8
    stf *= tmask[0]
    btf = np.zeros((nt, jmt, imt))
    addisop = np.asarray(m.addisop)
    arrays = [g.dxu, g.dyu, g.csu, g.cst, g.dxt, g.dyt, g.dxt2r, g.dyt2r,
              g.dxtr, g.dytr, g.cstr, g.dxur, g.dyur, g.dzt, g.dztr, g.dzt2r,
              g.dzw, np.asarray(g.dzwr)[1:], g.dztur, g.dztlr, bag.dtxcel,
              bag.cstdxt2r, bag.cstdyt2r, bag.cstdxur, bag.cstdxtr,
              m.dztxcl, addisop, m.eos_c, m.eos_to, m.eos_so,
              np.asarray(m.kmt).astype(np.float64), tmask, m.diff_cbt, u, v,
              stf, btf, t0]
    inputs = dict(t0=t0, u=u, v=v, stf=stf, btf=btf, c2dtts=c2dtts,
                  nsteps=nsteps, ncon=ncon, shape=(nt, km, jmt, imt))
    return m, inputs, ("<6i", (nt, km, jmt, imt, nsteps, ncon), "<6d",
                       (c2dtts, bag.ah, o.slmx, o.ahisop, o.athkdf, o.aidif),
                       arrays)


def isopyc_stratification(m):
    """The laterally structured stratification of the isopycnal case."""
    g = m.params.grid
    lat = np.asarray(g.yt)[:, None]
    t0 = np.zeros((2, g.km, g.jmt, g.imt))
    t0[0] = ((16.0 * np.exp(-np.asarray(g.zt) / 800e2))[:, None, None]
             * (0.5 + 0.5 * np.cos(np.deg2rad(lat)))[None])
    return t0
