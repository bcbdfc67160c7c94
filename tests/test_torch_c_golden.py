"""The port held directly against the four C golden programs
(``golden/c_golden/*.c``), as ``tests/test_c_golden*.py`` hold the JAX
package: the same grids, seeds, step counts, blob layouts and tolerances
(rtol 1e-9, atol 1e-12 on trajectories; the CG to 100 x its tolerance),
with the port's own constants in the blobs (``tests/torch_c_golden_io.py``).

Eight cases:
- the tracer step (``tracer_golden.c``): the centered scheme, FCT dlm1,
  FCT dlm2 with the 3-D delimiter (the generic ``tracer_step``), and the
  limiter's non-vacuity; FCT dlm1 also through the fused step's plain
  version (``ops.tracer_kernel.fct_tracer_step_ref``, what B1 computes);
- the baroclinic momentum step (``clinic_golden.c``, ``clinic_step``);
- the island-constrained CG (``congrad_golden.c``): the CG's plain
  version (``ops.cg_kernel.congrad_ref``, what B2 computes);
- the isopycnal/GM tracer step (``isopyc_golden.c``): ``compute_isopyc``
  with the generic step and with the fused step's plain version (the
  18-slot weight stack), and the GM and Redi fields' non-vacuity.
"""

import numpy as np
import pytest
import torch

import torch_c_golden_io as cio
from uvic_tpu_torch.models.ocean.isopyc import (compute_isopyc,
                                                iso_weight_pack,
                                                iso_weight_stack)
from uvic_tpu_torch.models.ocean.kernels import (adv_vel, clinic_step,
                                                 tracer_step)
from uvic_tpu_torch.models.ocean.tropic import sfforc
from uvic_tpu_torch.ops.cg_kernel import congrad_ref
from uvic_tpu_torch.ops.convection import convct_ncon
from uvic_tpu_torch.ops.stencil import setbcx
from uvic_tpu_torch.ops.tracer_kernel import (TracerStepConsts,
                                              fct_tracer_step_ref)
from torch_threads import torch_one_thread  # noqa: F401  (autouse)

RTOL, ATOL = 1e-9, 1e-12


@pytest.fixture(scope="module")
def programs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cgold_torch")
    return {name: cio.compile_program(name, d,
                                      "gnu99" if name == "isopyc_golden"
                                      else "c99")
            for name in ("tracer_golden", "clinic_golden",
                         "congrad_golden", "isopyc_golden")}


def _tn(x):
    return torch.as_tensor(np.asarray(x, np.float64))


def _c_run(exe, tmp_path, tag, case, shape):
    hfmt, header, dfmt, dheader, arrays = case
    return cio.run_program(exe, tmp_path / f"in_{tag}.bin",
                           tmp_path / f"out_{tag}.bin", hfmt, header, dfmt,
                           dheader, arrays, shape)


def _tracer_trajectory(m, inp, step):
    """``nsteps`` leapfrog steps of ``step(tau, tm1)`` followed by ncon
    convection and setbcx, as the C program takes them."""
    tau = tm1 = _tn(inp["t0"])
    for _ in range(inp["nsteps"]):
        t_new = convct_ncon(step(tau, tm1), m.kmt, m.eos_c, m.eos_to,
                            m.eos_so, m.dztxcl, inp["ncon"])
        tau, tm1 = setbcx(t_new, True), tau
    return tau.numpy()


def _tracer_port(scheme, fct3d, fused):
    m, inp, case = cio.tracer_case(scheme, fct3d)
    bag = m.g
    vet, vnt, vbt, *_ = adv_vel(_tn(inp["u"]), _tn(inp["v"]), bag, True)
    stf, btf = _tn(inp["stf"]), _tn(inp["btf"])
    c2dtts = inp["c2dtts"]
    if fused:
        consts = TracerStepConsts(bag, bag.ah, 1.0, ydiff_fluxform=False,
                                  has_iso=False)

        def step(tau, tm1):
            return fct_tracer_step_ref(consts, tau, tm1, vet, vnt, vbt,
                                       m.diff_cbt, stf, btf, None,
                                       c2dtts * bag.dtxcel, m.tmask, m.kmt)
    else:
        variant = "dlm2" if scheme == "fct_dlm2" else "dlm1"

        def step(tau, tm1):
            return tracer_step(tau, tm1, vet, vnt, vbt, stf, btf, None,
                               m.diff_cbt, m.kmt, m.tmask, bag, c2dtts,
                               "fct" if scheme.startswith("fct") else scheme,
                               1.0, True, fct_variant=variant, fct3d=fct3d)

    t = _tracer_trajectory(m, inp, step)
    assert np.isfinite(t).all()
    # non-vacuity: the trajectory is active (advection moved tracer,
    # convection fired somewhere)
    assert np.abs(t[0]).max() > 1.0
    assert np.abs(t - inp["t0"]).max() > 1e-3
    return t, inp, case


@pytest.mark.parametrize("scheme,fct3d", [("centered", False),
                                          ("fct", False),
                                          ("fct_dlm2", True)],
                         ids=["trajectory", "fct_dlm1", "fct_dlm2_3d"])
def test_tracer_step_matches_c(scheme, fct3d, programs, tmp_path):
    t, inp, case = _tracer_port(scheme, fct3d, fused=False)
    t_c = _c_run(programs["tracer_golden"], tmp_path, scheme, case,
                 inp["shape"])
    assert np.isfinite(t_c).all()
    np.testing.assert_allclose(t, t_c, rtol=RTOL, atol=ATOL)
    if scheme == "fct":
        # the fused step (B1's plain version) on the same trajectory
        t_f, _, _ = _tracer_port(scheme, fct3d, fused=True)
        np.testing.assert_allclose(t_f, t_c, rtol=RTOL, atol=ATOL)


def test_fct_limiter_active():
    """Non-vacuity: the FCT trajectory differs from the centered one (the
    limiter clipped antidiffusive fluxes somewhere)."""
    t_fct, _, _ = _tracer_port("fct", False, fused=False)
    t_cen, _, _ = _tracer_port("centered", False, fused=False)
    assert np.abs(t_fct - t_cen).max() > 1e-6


def test_clinic_matches_c(programs, tmp_path):
    m, inp, case = cio.clinic_case()
    u_c = _c_run(programs["clinic_golden"], tmp_path, "clinic", case,
                 inp["shape"])
    rho, smf, bmf = _tn(inp["rho"]), _tn(inp["smf"]), _tn(inp["bmf"])
    u_tau = u_tm1 = _tn(inp["u0"])
    for _ in range(inp["nsteps"]):
        _, _, _, veu, vnu, vbu = adv_vel(u_tau[0], u_tau[1], m.g, True)
        u_int, _ = clinic_step(u_tau, u_tm1, rho, veu, vnu, vbu, smf, bmf,
                               m.visc_cbu, m.kmu, m.umask, m.g,
                               inp["c2dtuv"], True)
        u_tau, u_tm1 = u_int, u_tau
    u = u_tau.numpy()
    assert np.isfinite(u_c).all() and np.isfinite(u).all()
    # non-vacuity: the flow evolved and the pressure gradients acted
    assert np.abs(u - inp["u0"]).max() > 1e-2
    np.testing.assert_allclose(u, u_c, rtol=RTOL, atol=ATOL)


def test_congrad_matches_c(programs, tmp_path):
    from uvic_tpu_torch.config import small_config
    from uvic_tpu_torch.models.ocean.model import make_ocean
    m = make_ocean(small_config(imt=40, jmt=34, km=8), device="cpu")
    g = m.params.grid
    jmt, imt = g.jmt, g.imt
    c2dtsf = 2.0 * 1800.0
    isl = m.isl
    assert isl.nisle >= 1
    forc = sfforc(_tn(cio.congrad_forcing(m)), _tn(g.dxu), _tn(g.dyu),
                  _tn(g.csu))
    guess = torch.zeros((jmt, imt), dtype=torch.float64)
    x_ref, _ = congrad_ref(m.cf_unit, isl, guess, forc, c2dtsf, 0.0, 300,
                           True)
    scale = float(x_ref.abs().max())
    assert scale > 0.0
    tol = 1.0e-8 * scale
    x_p, it_p = congrad_ref(m.cf_unit, isl, guess, forc, c2dtsf, tol, 300,
                            True)
    assert 5 < int(it_p) < 300
    raw = _c_run(programs["congrad_golden"], tmp_path, "cg",
                 ("<5i", (jmt, imt, isl.nisle, isl.imain, 300), "<d",
                  (tol,), [(m.cf_unit / c2dtsf).numpy(), guess.numpy(),
                           forc.numpy(), isl.perim_id.double().numpy(),
                           isl.counts.double().numpy()]), None)
    x_c = raw[:jmt * imt].reshape(jmt, imt)
    it_c, conv_c = raw[jmt * imt], raw[jmt * imt + 1]
    assert conv_c == 1.0 and it_c > 5
    # solutions agree to solver-tolerance level
    assert np.abs(x_p.numpy() - x_c).max() < 100.0 * tol
    # seeded with the C solution, the port's CG accepts it at once
    _, it_fp = congrad_ref(m.cf_unit, isl, _tn(x_c), forc, c2dtsf, tol, 300,
                           True)
    assert int(it_fp) <= 2


@pytest.fixture(scope="module")
def isopyc_run():
    m, inp, case = cio.isopyc_case()
    o, bag = m.cfg.ocean, m.g
    vet, vnt, vbt, *_ = adv_vel(_tn(inp["u"]), _tn(inp["v"]), bag, True)
    stf, btf = _tn(inp["stf"]), _tn(inp["btf"])
    c2dtts = inp["c2dtts"]
    consts = TracerStepConsts(bag, bag.ah, o.aidif, ydiff_fluxform=True,
                              has_iso=True)

    def iso_of(tm1):
        return compute_isopyc(tm1, m.tmask, m.kmt, m.eos_c, m.eos_to,
                              m.eos_so, bag, o, True, addisop=m.addisop)

    def generic(tau, tm1):
        iso = iso_of(tm1)
        return tracer_step(tau, tm1, vet + iso.vetiso, vnt + iso.vntiso,
                           vbt + iso.vbtiso, stf, btf, None,
                           m.diff_cbt + iso.K33, m.kmt, m.tmask, bag,
                           c2dtts, "fct", o.aidif, True, iso=iso)

    def fused(tau, tm1):
        iso = iso_of(tm1)
        return fct_tracer_step_ref(
            consts, tau, tm1, vet + iso.vetiso, vnt + iso.vntiso,
            vbt + iso.vbtiso, m.diff_cbt + iso.K33, stf, btf, None,
            c2dtts * bag.dtxcel, m.tmask, m.kmt,
            isow=iso_weight_stack(iso_weight_pack(iso, bag)))

    return m, inp, case, {"generic": _tracer_trajectory(m, inp, generic),
                          "fused": _tracer_trajectory(m, inp, fused)}


def test_isopyc_gm_matches_c(isopyc_run, programs, tmp_path):
    m, inp, case, runs = isopyc_run
    t_c = _c_run(programs["isopyc_golden"], tmp_path, "iso", case,
                 inp["shape"])
    assert np.isfinite(t_c).all()
    for form, t in runs.items():
        assert np.isfinite(t).all(), form
        assert np.abs(t - inp["t0"]).max() > 1e-3, form
        np.testing.assert_allclose(t, t_c, rtol=RTOL, atol=ATOL,
                                   err_msg=form)


def test_isopyc_gm_active(isopyc_run):
    """Non-vacuity: the GM velocities and the Redi fluxes are non-zero for
    the case's stratification, and the zonal addition is live."""
    m = isopyc_run[0]
    assert float(m.addisop.abs().max()) > 0.0
    t0 = cio.isopyc_stratification(m) * np.asarray(m.tmask)
    iso = compute_isopyc(_tn(t0), m.tmask, m.kmt, m.eos_c, m.eos_to,
                         m.eos_so, m.g, m.cfg.ocean, True,
                         addisop=m.addisop)
    assert float(iso.vntiso.abs().max()) > 0.0
    assert float(iso.K33.abs().max()) > 0.0
    assert float(iso.K11.abs().max()) > 0.0
