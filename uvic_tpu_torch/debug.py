"""Step-level NaN debugging harness (SURVEY §5.2 sanitizers), torch.

Port of ``uvic_tpu.debug``.  The production Run already guards yearly
inventories (NaN -> abort with saved restart).  This module is the
step-level instrument for WHEN a run dies: ``nan_report`` walks a state
(dataclasses, dicts, tuples and lists of tensors) and names every
non-finite tensor with its first offending location; ``bisect_segment``
replays the CORE of one coupled segment phase by phase (atm/ice
substeps, gosbc forcing, ocean substeps), eagerly and outside the
segment's stage graphs, and reports the first phase — and for the
stepped phases the first substep — that introduces a non-finite value.
Limits: the land and sediment sub-models and the transient forcings
(anthro, awind, sulphate, land ice) are NOT replayed; a NaN born only in
those paths will not reproduce here — use ``nan_report`` on the dying
state to see which component is poisoned first.

Usage (host-side):

    from uvic_tpu_torch.debug import bisect_segment, nan_report
    print(nan_report(state))
    print(bisect_segment(model, state))
"""

from __future__ import annotations

import dataclasses

import torch


def _leaves(tree, path=()):
    """(path, tensor) of every tensor in a state, in the reference's
    pytree order: dataclass fields in order, dict keys sorted, sequence
    items by index; path entries are field names, "['key']" and
    indices, as the reference's key paths print."""
    if torch.is_tensor(tree):
        yield path, tree
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), path + (f.name,))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (f"[{k!r}]",))
    elif isinstance(tree, (tuple, list)):
        for n, v in enumerate(tree):
            yield from _leaves(v, path + (str(n),))


def nan_report(tree, prefix="state") -> list:
    """List of (path, n_nonfinite, first_index) for every non-finite
    floating tensor in the state."""
    out = []
    for path, leaf in _leaves(tree):
        if not leaf.is_floating_point():
            continue
        bad = ~torch.isfinite(leaf)
        n = int(bad.sum())
        if n:
            first = tuple(int(v) for v in torch.nonzero(bad)[0]) \
                if leaf.dim() else ()
            out.append((prefix + "/".join(path), n, first))
    return out


def _check(tag, tree, log):
    rep = nan_report(tree, prefix=tag + ":")
    if rep:
        log.append((tag, rep[:4]))
        return True
    return False


def segment_phases(model, state, max_substeps=None):
    """Replay the core of one segment eagerly with the public API, as the
    reference's tools do by hand (``scripts/probe_segment_closure.py:
    55-83``): the atmosphere/ice substeps, gosbc's forcing and the ocean
    steps (``OceanModel.step``).  Yields, in order, ``("atm_ice", s, atm,
    ice, acc_s)`` after each substep (``acc_s`` its own fluxes),
    ``("gosbc", forcing, acc)`` with the segment's flux totals, and
    ``("ocean", s, ocean)`` after each ocean step.  ``state`` is left as
    it is (the replay runs on a copy); ``model.relyr`` is not advanced."""
    from .coupler.driver import host_of, pack_state, unpack_state
    from .models.embm.insolation import daily_insolation

    state = unpack_state({k: v.clone() for k, v in pack_state(state).items()},
                         host_of(state))
    cfg = model.cfg
    sst, _, frzpt = model.gasbc(state)
    u_surf = model.ocean.full_velocity(state.ocean.u, state.ocean.psi0)
    uocn, vocn = u_surf[0, 0], u_surf[1, 0]
    if cfg.embm.seasonal:
        yrlen = 360.0 if cfg.time.eqyear else 365.0
        day = (model.relyr % 1.0) * yrlen + 0.5 * cfg.time.segtim_days
        solins = daily_insolation(
            model.tlat_rad2d,
            torch.as_tensor(day, dtype=sst.dtype, device=sst.device), yrlen)
    else:
        solins = model.embm.solins
    land_gc = None
    if state.land is not None and state.land.gc is not None:
        land_gc = state.land.gc * 100.0

    atm, ice = state.atm, state.ice
    anthro = torch.zeros((), dtype=sst.dtype, device=sst.device)
    acc = None
    nsub = model.ntspas if max_substeps is None \
        else min(model.ntspas, max_substeps)
    for s in range(nsub):
        mixing = atm.nats + 1 > cfg.embm.namix
        atm, ice, a, _ = model._atm_ice_step_impl(
            atm, ice, sst, frzpt, uocn, vocn, anthro, solins, land_gc,
            mixing=mixing)
        acc = a if acc is None else {k: acc[k] + a[k] for k in acc}
        yield "atm_ice", s, atm, ice, a

    st2 = dataclasses.replace(state, atm=atm, ice=ice)
    swr_mean = acc["swr"] / acc["time"]
    forcing = model.gosbc(acc, st2, swr_mean, relyr=model.relyr)
    yield "gosbc", forcing, acc

    ocean = state.ocean
    for s in range(model.ntspos):
        lf = ocean.itt % cfg.ocean.nmix != 0
        ocean = model.ocean.step(ocean, forcing, leapfrog=lf)
        yield "ocean", s, ocean


def bisect_segment(model, state, max_substeps=None) -> dict:
    """Replay one segment phase by phase (``segment_phases``); return the
    first phase that produces a non-finite value (or ok=True).  ``model``
    is a CoupledModel; ``state`` the CoupledState entering the segment,
    which is left as it is."""
    log = []
    for phase in segment_phases(model, state, max_substeps):
        if phase[0] == "atm_ice":
            _, s, atm, ice, _ = phase
            if _check(f"atm_ice[{s}]", (atm, ice), log):
                return dict(ok=False, phase=f"atm_ice substep {s}",
                            detail=log)
        elif phase[0] == "gosbc":
            forcing = phase[1]
            if _check("gosbc_forcing", (forcing.stf, forcing.smf), log):
                return dict(ok=False, phase="gosbc forcing", detail=log)
        else:
            _, s, ocean = phase
            if _check(f"ocean[{s}]", (ocean.t, ocean.u, ocean.psi0), log):
                return dict(ok=False, phase=f"ocean substep {s}",
                            detail=log)
    return dict(ok=True, phase=None, detail=[])
