"""The port's coupled carbon cycle against ``uvic_tpu`` on the CPU, in
float64.

Both packages' ``Run`` drive two segments of the configuration of
``tests/test_mobi_inventory.py`` (``small_config()``, ``mobi_full()``:
41 tracers, pore-water sediments on), with the EMBM solves run to
convergence as in ``test_torch_coupled.py``, the time means and a
restart written at the second segment:

- every field of the state (ocean, atmosphere, ice, sediments) agrees to
  1e-9 of its largest value, the counters exactly;
- the last segment's time means (``surf_<tracer>`` included) agree to
  1e-9, the convection extent against the reference's function taken
  op by op (as in ``test_torch_coupled.py``);
- the forcing the ocean steps took (``stf`` on all 41 tracers: gas
  exchange and virtual fluxes; ``btf`` on dic and alk from the
  sediments) agrees to 1e-9;
- the time means ``Run`` writes agree to 1e-9 before they are written,
  and ``tavg.nc`` holds the same variables, ``surf_*`` included, whose
  float32 values agree to 1e-6 (one float32 rounding) of each field's
  largest value;
- the nt=41 restart with sediments round-trips between the packages
  bitwise, and an nt=2 restart read into an nt=41 model raises;
- ``run_production --bgc npzd --device cpu`` runs a segment.

``test_torch_coupled_bgc_variants.py`` holds the NPZD suite, the legacy
sediments and the transient CFC forcing.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

import uvic_tpu.config as j_config
import uvic_tpu.io.forcing as j_forcing
import uvic_tpu.io.netcdf as j_netcdf
from uvic_tpu.coupler.driver import CoupledModel as JCoupled
from uvic_tpu.coupler.run import Run as JRun
from uvic_tpu.io.restart import _flatten_state
from uvic_tpu.io.restart import load_restart as j_load
from uvic_tpu.io.restart import save_restart as j_save

import uvic_tpu_torch.config as t_config
import uvic_tpu_torch.coupler.run as t_run_mod
import uvic_tpu_torch.io.forcing as t_forcing
from uvic_tpu_torch import run_production
from uvic_tpu_torch.config import BgcConfig, earth_config, mobi_full
from uvic_tpu_torch.convert import coupled_state_to_numpy
from uvic_tpu_torch.coupler.driver import CoupledModel
from uvic_tpu_torch.coupler.run import Run
from uvic_tpu_torch.coupler.tracers import build_registry
from uvic_tpu_torch.io.restart import load_restart, save_restart

ROOT = Path(__file__).resolve().parents[1]
RESTART = ROOT / "earth_accept" / "restart.npz"
NSEG = 2
TOL = 1e-9
TOL_TAVG_FILE = 1e-6
CONVERGED = dict(solver_tol=1e-13, solver_maxiter=1000)
OCEAN = dict(isopycmix=False, gent_mcwilliams=False, dtts=43200.0,
             dtuv=1800.0, dtsf=1800.0, tolrsf=1e8)
TIME = dict(tsiint=5.0, timavgint=10.0, restint=10.0)
# the convection extent of the end state is held op by op (see above)
HELD = ("convect_depth", "convect_nreg")


def bgc_config(C):
    """The MOBI inventory test's configuration with sediments on,
    converged EMBM solves and the Run's intervals, from the config
    module ``C`` of either package."""
    cfg = C.small_config()
    return cfg.replace(
        ocean=dataclasses.replace(cfg.ocean, **OCEAN), bgc=C.mobi_full(),
        sed=dataclasses.replace(cfg.sed, enabled=True),
        embm=dataclasses.replace(cfg.embm, **CONVERGED),
        time=dataclasses.replace(cfg.time, **TIME))


def _close(got, ref, what, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    scale = max(float(np.abs(ref).max()), 1e-300)
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"{what}: err {err:.3e}, scale {scale:.3e}"


def record_reference_forcing(jm):
    """Keep the ocean forcing (stf, btf) of the reference's last segment
    in the returned dict: its gosbc's output, passed out of the jitted
    segment beside the diagnostics."""
    rec = {}
    gosbc, core = jm.gosbc, jm._segment_core

    def gosbc_rec(*a, **k):
        f = gosbc(*a, **k)
        rec["traced"] = (f.stf, f.btf)
        return f

    def core_rec(state, sc):
        new, diag = core(state, sc)
        diag["forcing"] = rec.pop("traced")
        return new, diag

    jitted = jax.jit(core_rec)

    def segment(state, sc):
        new, diag = jitted(state, sc)
        rec["stf"], rec["btf"] = (np.asarray(x) for x in diag.pop("forcing"))
        return new, diag

    jm.gosbc = gosbc_rec
    jm._segment_jit = segment
    return rec


def run_both(tmp, over=None, transient=None):
    """Both packages' Run over NSEG segments of ``bgc_config``, changed
    by ``over(cfg, config module)`` when given; ``transient(forcing
    module)`` makes each package's TransientForcing.  Returns the
    models, end states, the reference's last forcing, the means each Run
    wrote and the output directories."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    written = {"jax": [], "port": []}
    j_write, t_write = j_netcdf.write_tavg, t_run_mod.write_tavg

    def recorder(key, write):
        def rec(path, grid, fields, *a, **k):
            written[key].append({n: np.array(v) for n, v in fields.items()})
            return write(path, grid, fields, *a, **k)
        return rec

    j_netcdf.write_tavg = recorder("jax", j_write)
    t_run_mod.write_tavg = recorder("port", t_write)
    try:
        over = over or (lambda cfg, C: cfg)
        jm = JCoupled(over(bgc_config(j_config), j_config))
        tm = CoupledModel(over(bgc_config(t_config), t_config),
                          device="cpu")
        if transient is not None:
            jm.set_transient_forcing(transient(j_forcing))
            tm.set_transient_forcing(transient(t_forcing))
        rec = record_reference_forcing(jm)
        out = {"jax": tmp / "jax", "port": tmp / "port"}
        js = JRun(jm, str(out["jax"])).run(jm.init_state(), nseg=NSEG)
        ts0 = tm.init_state()
        ts = Run(tm, str(out["port"])).run(ts0, nseg=NSEG)
    finally:
        j_netcdf.write_tavg, t_run_mod.write_tavg = j_write, t_write
        torch.set_num_threads(threads)
    return dict(jm=jm, js=js, tm=tm, ts=ts, ts0=ts0, rec=rec,
                written=written, out=out)


def check_state(r, component):
    got = coupled_state_to_numpy(r["ts"])
    ref = _flatten_state(r["js"])
    keys = sorted(k for k in got if k.startswith(component + "/"))
    assert keys and keys == sorted(k for k in ref
                                   if k.startswith(component + "/"))
    for k in keys:
        if got[k].dtype.kind == "i":
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        elif k in ("ocean/t", "ocean/tm1", "sed/carb"):
            for n in range(got[k].shape[0]):
                _close(got[k][n], ref[k][n], f"{k}[{n}]")
        else:
            _close(got[k], ref[k], k)


def check_means(r):
    jm, tm = r["jm"], r["tm"]
    got, ref = tm.last_tavg, jm.last_tavg
    assert set(got) == set(ref)
    names = [t.name for t in tm.ocean.tracer_index.tracers]
    assert {"surf_" + n for n in names[2:]} <= set(got)
    for k in ref:
        if k not in HELD:
            _close(got[k], ref[k], f"tavg {k}")
    from uvic_tpu.ops.convection import convection_extent
    om = jm.ocean
    with jax.disable_jit():
        depth, nreg = convection_extent(
            jnp.asarray(r["ts"].ocean.t.numpy()), om.kmt, om.eos_c,
            om.eos_to, om.eos_so, om.dztxcl, jnp.asarray(om.g.dzt))
    np.testing.assert_array_equal(got["convect_depth"].numpy(),
                                  np.asarray(depth))
    np.testing.assert_array_equal(got["convect_nreg"].numpy(),
                                  np.asarray(nreg))


def check_forcing(r, gas=("dic", "o2", "c14"), bottom=("dic", "alk")):
    """stf and btf of the last segment agree; the gas tracers exchange
    and the sediments return dic and alk (else the check proves little);
    btf is zero elsewhere."""
    tm, rec = r["tm"], r["rec"]
    idx = tm.ocean.tracer_index
    for name in ("stf", "btf"):
        got = tm.last_forcing[name]
        assert got.shape == rec[name].shape
        for n, tr in enumerate(idx.tracers):
            _close(got[n], rec[name][n], f"{name} {tr.name}")
    stf, btf = tm.last_forcing["stf"], tm.last_forcing["btf"]
    for name in gas:
        assert bool(torch.any(stf[idx[name]] != 0)), name
    for n, tr in enumerate(idx.tracers):
        assert bool(torch.any(btf[n] != 0)) == (tr.name in bottom), tr.name


def check_written_means(r):
    """The means each Run wrote: float64 at 1e-9 before writing; the
    files' variables equal and their float32 records within one
    rounding."""
    wj, wt = r["written"]["jax"], r["written"]["port"]
    assert len(wj) == len(wt) == 1
    assert set(wj[0]) == set(wt[0])
    for k in wj[0]:
        if k not in HELD:
            _close(wt[0][k], wj[0][k], f"written {k}")
    files = {}
    for key in ("jax", "port"):
        f = netcdf_file(str(r["out"][key] / "tavg.nc"), "r", mmap=False)
        try:
            files[key] = {k: np.array(v[:]) for k, v in f.variables.items()}
        finally:
            f.close()
    assert set(files["port"]) == set(files["jax"])
    names = [t.name for t in r["tm"].ocean.tracer_index.tracers]
    assert {"surf_" + n for n in names[2:]} <= set(files["port"])
    for k, ref in files["jax"].items():
        assert np.isfinite(files["port"][k]).all(), k
        if k not in HELD:
            _close(files["port"][k], ref, f"tavg.nc {k}", TOL_TAVG_FILE)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_both(tmp_path_factory.mktemp("bgc"))


@pytest.mark.parametrize("component", ["ocean", "atm", "ice", "sed"])
def test_segments_state_matches_reference(component, runs):
    check_state(runs, component)


def test_segments_advance_counters(runs):
    tm, ts = runs["tm"], runs["ts"]
    assert ts.ocean.itt == int(runs["js"].ocean.itt) \
        == runs["ts0"].ocean.itt + NSEG * tm.ntspos
    assert ts.atm.nats == int(runs["js"].atm.nats)
    assert tm.ocean.nt == 41


def test_segment_means_match_reference(runs):
    check_means(runs)


def test_forcing_matches_reference(runs):
    check_forcing(runs)


def test_run_writes_the_reference_means(runs):
    check_written_means(runs)


def test_restart_with_sediments_round_trips(runs, tmp_path):
    """The port's nt=41 restart with sediments read by ``uvic_tpu``'s
    load_restart and written back, then read by the port: bitwise; the
    Run's restart.npz under the reference's keys."""
    jm, tm, ts = runs["jm"], runs["tm"], runs["ts"]
    with np.load(runs["out"]["port"] / "restart.npz") as d, \
            np.load(runs["out"]["jax"] / "restart.npz") as e:
        assert set(d.files) == set(e.files)
        assert d["ocean/t"].shape[0] == 41
        assert {"sed/calgg", "sed/carb", "sed/zrct"} <= set(d.files)
    port_file, ref_file = tmp_path / "port.npz", tmp_path / "ref.npz"
    save_restart(str(port_file), ts)
    js = j_load(str(port_file), jm.init_state())
    j_save(str(ref_file), js)
    back = load_restart(str(ref_file), tm.init_state())
    want, got = coupled_state_to_numpy(ts), coupled_state_to_numpy(back)
    assert set(got) == set(want) and any(k.startswith("sed/") for k in got)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_restart_of_another_shape_raises():
    """The year-1060 earth restart (nt=2) read into the earth model with
    MOBI (nt=41): a ValueError naming the field."""
    cfg = earth_config(dtype="float64").replace(bgc=mobi_full())
    m = CoupledModel(cfg, topo_kind="earth", device="cpu")
    with pytest.raises(ValueError, match="ocean/t"):
        load_restart(str(RESTART), m.init_state())


def test_cli_runs_npzd_on_the_cpu(tmp_path, capsys):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        code = run_production.main([
            "--bgc", "npzd", "--device", "cpu", "--years", str(5.0 / 360.0),
            "--tsiint", "5", "--timavgint", "5", "--outdir", str(tmp_path)])
    finally:
        torch.set_num_threads(threads)
    assert code == 0
    assert "model years" in capsys.readouterr().out
    with np.load(tmp_path / "restart.npz") as d:
        assert d["ocean/t"].shape[0] == len(build_registry(BgcConfig(
            suite="npzd", carbon=True, alk=True, o2=True, nitrogen=True)))
        assert all(np.isfinite(d[k]).all() for k in d.files)
    f = netcdf_file(str(tmp_path / "tavg.nc"), "r", mmap=False)
    try:
        names = set(f.variables)
        assert {"surf_dic", "surf_alk", "surf_o2", "surf_no3"} <= names
        assert all(np.isfinite(np.array(v[:])).all()
                   for v in f.variables.values())
    finally:
        f.close()
    rows = (tmp_path / "tsi.csv").read_text().splitlines()
    assert len(rows) == 2
    assert np.isfinite(np.array(rows[1].split(","), float)).all()
    assert "drift" in json.loads((tmp_path / "run_summary.json").read_text())


def test_float32_model_runs_its_carbon_chemistry_in_float64():
    """The card's precision on the CPU.  The float32 model's sediment
    step is the float64 model's on the same values, rounded to float32
    (``CHEM_DTYPE``), bitwise; a float32 segment keeps every field and
    the forcing in float32, finite."""
    from uvic_tpu_torch.convert import coupled_state_from_numpy
    from uvic_tpu_torch.coupler.driver import CHEM_DTYPE
    assert CHEM_DTYPE == torch.float64
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = bgc_config(t_config)
        m32 = CoupledModel(cfg.replace(dtype="float32"), device="cpu")
        m64 = CoupledModel(cfg, device="cpu")
        s32 = m32.init_state()
        s64 = coupled_state_from_numpy(coupled_state_to_numpy(s32),
                                       m64.init_state())
        co2 = torch.tensor(354.0)
        sed32, fl32 = m32.sediment_step(s32, co2.float())
        sed64, fl64 = m64.sediment_step(s64, co2.double())
        for f in ("calgg", "orggg", "carb", "o2", "zrct", "buried"):
            a, b = getattr(sed32, f), getattr(sed64, f)
            assert a.dtype == torch.float32, f
            assert torch.equal(a, b.float()), f
        for k in ("dic", "alk"):
            assert fl32[k].dtype == torch.float32
            assert torch.equal(fl32[k], fl64[k].float()), k
        s32 = m32.run(s32, 1)
    finally:
        torch.set_num_threads(threads)
    for k, v in coupled_state_to_numpy(s32).items():
        assert v.dtype.kind == "i" or v.dtype == np.float32, k
        assert np.isfinite(v).all(), k
    for k in ("stf", "btf"):
        assert m32.last_forcing[k].dtype == torch.float32
        assert bool(torch.isfinite(m32.last_forcing[k]).all())
