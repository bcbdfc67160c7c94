"""Production run loop (UVic_ESCM.F:296-416 observability wiring).

Port of ``uvic_tpu.coupler.run``: the segment loop of a coupled model
evaluated against the alarm system (switch.F ``set_time_switches``),
emitting

- tsi scalar rows every ``tsiint`` days (mom_tsi.F/embm_tsi.F, the
  regression signal),
- time means every ``timavgint`` days, appended as records of one netCDF
  file (mom_tavg.F),
- restarts every ``restint`` days and at the end of the run, carrying
  the calendar (mom_rest.F: a split run reproduces a continuous one),
- conservation audits and the stability report at the start, at the end
  of each year and at the end of the run (global_sums.F, stab.F),
- and an abort when the barotropic solver failed more than 50 times
  (tropic.F:242-250 ``if (nconv .gt. 50) stop``).

Each segment is ``CoupledModel.run(state, 1)``: on the card the replay
of the segment's stage graphs.  Around it the host reads ``nconv`` once,
adds the segment's means (``last_tavg``) to the running sums on the
device, and reads back what an alarm asks for.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..core.calendar import Switches, TimeManager
from ..diag.conservation import ConservationAudit
from ..diag.stability import StabilityMonitor
from ..diag.tsi import TsiDiagnostics, TsiWriter
from ..io.netcdf import read_var, write_tavg
from ..io.restart import load_restart, save_restart
from ..io.tavg import TavgAccumulator
from .driver import CoupledModel, CoupledState

NCONV_ABORT = 50   # tropic.F:249 'nconv > 50 in tropic.f'


class Run:
    """Alarm-cadenced production driver around a CoupledModel."""

    def __init__(self, model: CoupledModel, outdir: str,
                 log=None, deterministic_audit=False):
        self.m = model
        self.outdir = outdir
        os.makedirs(outdir, exist_ok=True)
        tcfg = model.cfg.time
        self.tm = TimeManager(eqyear=tcfg.eqyear, year0=tcfg.year0,
                              month0=tcfg.month0, day0=tcfg.day0)
        self.switches = Switches.from_config(tcfg)
        self.tsi = TsiDiagnostics(
            model.ocean, model.embm,
            deterministic=model.cfg.parallel.deterministic_reductions)
        self.tsi_writer = TsiWriter(os.path.join(outdir, "tsi.csv"))
        self.tavg = TavgAccumulator()
        self.audit = ConservationAudit(
            model.ocean, deterministic=deterministic_audit)
        self.stab = StabilityMonitor(model.ocean)
        self._audit_start = None
        self._tavg_n = 0
        self._log = log or (lambda msg: None)
        # the configuration's adjust-and-warn rules (checks.F)
        for w in model.config_warnings:
            self._log(f"config warning: {w}")

    # -- restart ---------------------------------------------------------
    def restart_path(self, tag="restart"):
        return os.path.join(self.outdir, f"{tag}.npz")

    def save(self, state: CoupledState, tag="restart"):
        save_restart(self.restart_path(tag), state, self.tm)

    def load(self, template: CoupledState, tag="restart") -> CoupledState:
        state = load_restart(self.restart_path(tag), template, self.tm)
        # keep the coupler's clock consistent with the calendar
        self.m.relyr = self.tm.days / self.tm.yrlen
        # resume the tavg stream instead of truncating it: the first
        # write after a resume appends to the existing records
        tavg_path = os.path.join(self.outdir, "tavg.nc")
        if self._tavg_n == 0 and os.path.exists(tavg_path):
            try:
                self._tavg_n = int(read_var(tavg_path, "time").shape[0])
            except (OSError, KeyError, TypeError, ValueError):
                self._tavg_n = 1    # unreadable: still never truncate
        return state

    # -- the loop ---------------------------------------------------------
    def run(self, state: CoupledState, days: float | None = None,
            nseg: int | None = None) -> CoupledState:
        seg_days = self.m.cfg.time.segtim_days
        if nseg is None:
            days = days if days is not None else self.m.cfg.time.runlen_days
            nseg = max(1, round(days / seg_days))

        if self._audit_start is None:
            self._audit_start = self.audit.inventories(state.ocean)
            self._log(f"start {self.tm.stamp()} "
                      f"inventories={self._audit_start}")

        for _ in range(nseg):
            state = self.m.run(state, 1)     # one segment (+ transient bc)
            self.tm.itt = int(state.ocean.itt)
            self.tm.days += seg_days

            # solver health (tropic.F nconv semantics)
            nconv = int(state.ocean.nconv)
            if nconv > NCONV_ABORT:
                self.save(state, tag="restart_abort")
                raise RuntimeError(
                    f"barotropic solver failed {nconv} times "
                    f"(> {NCONV_ABORT}): aborting like tropic.F:249; "
                    f"state saved to restart_abort.npz")

            # the segment's per-step time means (tracer.F:420-443
            # in-step accumulation)
            self.tavg.accumulate(self.m.last_tavg)

            sw = self.switches.evaluate(self.tm.days, seg_days)
            if sw["tsits"]:
                row = self.tsi.compute(state.ocean, state.atm, state.ice)
                row["nconv"] = float(nconv)
                self.tsi_writer.write(self.tm.days, row)
            if sw["timavgts"]:
                self._write_tavg()
            if sw["restts"]:
                self.save(state)
                self._log(f"restart written at {self.tm.stamp()}")
            if sw["eoyear"]:
                inv = self.audit.inventories(state.ocean)
                drift = self.audit.drift(self._audit_start, inv)
                self._log(f"{self.tm.stamp()} conservation drift {drift}")
                # stab.F yearly triage line: CFL/Reynolds/Peclet maxima
                # with offender locations (O_stability_tests)
                self._log(f"{self.tm.stamp()} "
                          + self.stab.report(state.ocean))
                if not all(np.isfinite(v) for v in inv.values()):
                    self.save(state, tag="restart_abort")
                    raise RuntimeError(
                        "non-finite tracer inventory (NaN guard, "
                        "checks.F analog); state saved")

        # end of run (eorun): final restart + audit
        self.save(state)
        inv = self.audit.inventories(state.ocean)
        summary = dict(
            stamp=self.tm.stamp(), days=self.tm.days,
            itt=self.tm.itt,
            drift=self.audit.drift(self._audit_start, inv))
        with open(os.path.join(self.outdir, "run_summary.json"), "w") as f:
            json.dump(summary, f)
        self._log(f"end {summary}")
        return state

    def _write_tavg(self):
        fields = self.tavg.normalize()
        if not fields:
            return
        self._tavg_n += 1
        # one stream file per run, records appended along the UNLIMITED
        # time dimension (mom_tavg.F/def_files.F single-file behavior)
        path = os.path.join(self.outdir, "tavg.nc")
        write_tavg(path, self.m.grid, fields, self.tm.days,
                   append=self._tavg_n > 1)
        self._log(f"tavg record {self._tavg_n} written: {path}")
