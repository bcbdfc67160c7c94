"""The port's barotropic, time-stepping and grid options against
``uvic_tpu`` on the CPU, in float64 (``tests/torch_option_runs.py`` has
the set-up of ``tests/test_variants.py``).

Each option runs 4 or 5 steps in both packages from the same state, the
first a mixing step (Euler-backward where ``eb`` is set): t, u,
psi0/psi1 (the surface pressure in its modes), ptd and ubar agree to
1e-9 of each field's largest magnitude after every step, itt and nconv
exactly.  ``run_scan`` is held against the reference's where the
reference's own tests run it (``tests/test_variants.py``: the default
options and the surface pressure).  The surface-pressure modes solve to
convergence (``torch_option_runs.SP_CONVERGED``), and their
external-mode state goes through the coupled restart of both packages.
"""

import pytest
import torch

from torch_option_runs import SP_CONVERGED, assert_close, scan_both, \
    step_both

SP = dict(barotropic="surface_pressure", **SP_CONVERGED)
IFS = dict(barotropic="implicit_free_surface", **SP_CONVERGED)
CASES = {
    "surface_pressure": (SP, None),
    "implicit_free_surface": (IFS, None),
    "sf_npt_9": (dict(sf_npt=9), None),
    "acor": (dict(acor=0.5), None),
    "sf_npt_9_acor": (dict(sf_npt=9, acor=0.5), None),
    "fourier": (dict(hlat_filter="fourier"), None),
    "eb": (dict(eb=True), None),
    "surface_pressure_eb": (dict(eb=True, **SP), None),
    "implicit_free_surface_eb": (dict(eb=True, **IFS), None),
    "acor_eb": (dict(eb=True, acor=0.5), None),
    "walls": (dict(), dict(cyclic=False)),
    "walls_isopycnal": (dict(isopycmix=True, gent_mcwilliams=True),
                        dict(cyclic=False)),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the steps are many small operations, which a
    thread pool slows down when other test processes share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", list(CASES))
def test_option_steps_match_jax(name):
    ocean, grid = CASES[name]
    for n, (ref, got) in enumerate(step_both(ocean, grid)):
        assert_close(ref, got, f"{name} step {n}")


@pytest.mark.parametrize("name,ocean", [("default", {}),
                                        ("surface_pressure", SP)])
def test_run_scan_matches_jax(name, ocean):
    ref, got = scan_both(ocean, nsteps=5)
    assert_close(ref, got, f"{name} run_scan")


@pytest.mark.parametrize("mode", ["surface_pressure",
                                  "implicit_free_surface"])
def test_surface_pressure_state_through_a_restart(mode, tmp_path):
    """The surface-pressure modes' external-mode state (the pressure
    levels, pguess, ubar, ubarm1) goes through the coupled restart: the
    port reads its own file back bitwise and continues bitwise, and the
    reference reads the port's file to the same values."""
    import dataclasses

    import numpy as np

    from uvic_tpu.coupler.driver import CoupledModel as JCoupled
    from uvic_tpu.io.restart import load_restart as j_load
    from uvic_tpu_torch.coupler.driver import CoupledModel
    from uvic_tpu_torch.io.restart import load_restart, save_restart

    from torch_option_runs import configs, setup

    ocean = dict(barotropic=mode, **SP_CONVERGED)
    _, tm, _, ts, _, tf = setup(ocean)
    nmix = tm.cfg.ocean.nmix
    for _ in range(3):
        ts = tm.step(ts, tf, leapfrog=(ts.itt % nmix) != 0)
    assert float(ts.ubar.abs().max()) > 0.0
    jc, tc = configs(ocean)
    tcm = CoupledModel(tc, device="cpu")
    path = str(tmp_path / "restart.npz")
    save_restart(path, dataclasses.replace(tcm.init_state(), ocean=ts))
    back = load_restart(path, tcm.init_state()).ocean
    fields = ("t", "u", "psi0", "psi1", "ptd", "ptdb", "ubar", "ubarm1")
    for f in fields:
        assert torch.equal(getattr(back, f), getattr(ts, f)), f
    a, b = ts, back
    for _ in range(2):
        a = tm.step(a, tf, leapfrog=(a.itt % nmix) != 0)
        b = tm.step(b, tf, leapfrog=(b.itt % nmix) != 0)
    for f in fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    jback = j_load(path, JCoupled(jc).init_state()).ocean
    for f in fields:
        np.testing.assert_array_equal(np.asarray(getattr(jback, f)),
                                      getattr(ts, f).numpy(), err_msg=f)
