"""CUDA graphs of the ocean step: the card's ``run_scan``.

The reference runs N steps as one ``lax.scan`` with the leapfrog/mixing
choice traced (``uvic_tpu/models/ocean/model.py:827-847``).  Here the
host knows the schedule (``itt % nmix``, ``itt`` a Python int), so one
graph is captured per step type, a leapfrog step and a mixing step, and
each step replays one of them.  One graph per step type keeps the
capture and instantiation bounded at ~1e5 kernels a MOBI step, where a
graph of N steps would hold N times that.

The graphs read and write static buffers: the state, the forcing and the
CG's iteration count.  A step's outputs are copied back into the state
buffers inside its graph, so replays chain.  ``run`` copies the caller's
state and forcing in, replays, and returns fresh tensors, so an earlier
state stays valid, as the reference's functional ``run_scan`` keeps it.

A capture that fails raises: there is no fallback to eager steps.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
import weakref

import torch

from ...core.state import OceanState
from ...ops.cg_kernel import congrad_launch
from ...ops.convection import apply_region_means
from ...ops.tracer_kernel import fct_tracer_step

STATE_FIELDS = ("tm1", "t", "um1", "u", "psi0", "psi1", "ptd", "ptdb",
                "ubar", "ubarm1", "nconv")
KERNEL_WRAPPERS = {"fct_tracer_step": fct_tracer_step,
                   "apply_region_means": apply_region_means,
                   "congrad": congrad_launch}


@contextlib.contextmanager
def capturing():
    """Collect garbage first and hold the collector off while graphs are
    captured.  A CUDA graph destroyed during another graph's capture (the
    graphs of a dropped model, freed when the collector runs) ends that
    capture with cudaErrorStreamCaptureInvalidated; the graph classes
    keep only a weak reference to their model, so that no cycle holds
    graphs for the collector in the first place."""
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def forcing_fields(forcing):
    """The names of the forcing's tensor fields (the brine fields ``cbf``
    and ``cba`` are None without O_convect_brine)."""
    return [f.name for f in dataclasses.fields(forcing)
            if getattr(forcing, f.name) is not None]


class StepGraphs:
    """The two captured steps of one model, on static buffers.

    capture_s / instantiate_s : seconds each graph took to capture and
    to instantiate, keyed by the leapfrog flag.
    captured : the launches each kernel wrapper made during each capture,
    i.e. its kernel nodes in that graph, keyed by the leapfrog flag.
    replays : how many times each graph was replayed, keyed by the
    leapfrog flag.
    """

    def __init__(self, model, state: OceanState, forcing):
        from ...cuda import LIBRARY
        LIBRARY.get()                     # build/load before any capture
        self.model = weakref.proxy(model)
        self.state = dataclasses.replace(
            state, **{f: getattr(state, f).clone() for f in STATE_FIELDS})
        self.forcing = dataclasses.replace(
            forcing, **{f: getattr(forcing, f).clone()
                        for f in forcing_fields(forcing)})
        self.iters = torch.zeros((), dtype=torch.int32, device=model.device)

        # warm up on a side stream (lazy library handles, the kernels'
        # attribute calls, the allocator), without touching the buffers
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for lf in (True, False):
                model._step(self.state, self.forcing, leapfrog=lf, scan=True)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()

        self.graphs, self.capture_s, self.instantiate_s = {}, {}, {}
        self.captured = {}
        self.replays = {True: 0, False: 0}
        with capturing():
            for lf in (True, False):
                self._capture(model, lf)

    def _capture(self, model, lf):
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        before = {k: w.launches for k, w in KERNEL_WRAPPERS.items()}
        t0 = time.perf_counter()
        with torch.cuda.graph(graph):
            out = model._step(self.state, self.forcing, leapfrog=lf,
                              scan=True)
            self._write_back(out)
            self.iters.copy_(model.last_cg_iters)
        torch.cuda.synchronize()
        self.capture_s[lf] = time.perf_counter() - t0
        self.captured[lf] = {k: w.launches - before[k]
                             for k, w in KERNEL_WRAPPERS.items()}
        t0 = time.perf_counter()
        graph.instantiate()
        torch.cuda.synchronize()
        self.instantiate_s[lf] = time.perf_counter() - t0
        self.graphs[lf] = graph

    def _write_back(self, out: OceanState):
        """Copy a step's outputs into the state buffers.  An output that
        is one of the buffers (tm1 <- t, um1 <- u, ...) is cloned first,
        so no copy reads a buffer another copy has overwritten."""
        bufs = [getattr(self.state, f) for f in STATE_FIELDS]
        ptrs = {b.untyped_storage().data_ptr() for b in bufs}
        pairs = []
        for f, dst in zip(STATE_FIELDS, bufs):
            src = getattr(out, f)
            if src is dst:
                continue
            if src.untyped_storage().data_ptr() in ptrs:
                src = src.clone()
            pairs.append((dst, src))
        for dst, src in pairs:
            dst.copy_(src)

    def run(self, state: OceanState, forcing, nsteps: int, nmix: int,
            iters_log: torch.Tensor | None = None) -> OceanState:
        """``nsteps`` replays from ``state``; ``iters_log`` (int32,
        ``nsteps`` long, on the card) receives each step's CG
        iterations."""
        for f in STATE_FIELDS:
            getattr(self.state, f).copy_(getattr(state, f))
        for f in forcing_fields(forcing):
            getattr(self.forcing, f).copy_(getattr(forcing, f))
        itt = state.itt
        for n in range(nsteps):
            lf = (itt % nmix) != 0
            self.graphs[lf].replay()
            self.replays[lf] += 1
            if iters_log is not None:
                iters_log[n].copy_(self.iters)
            itt += 1
        self.model.last_cg_iters = self.iters.clone()
        return dataclasses.replace(
            self.state, itt=itt,
            **{f: getattr(self.state, f).clone() for f in STATE_FIELDS})
