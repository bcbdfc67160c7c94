"""CUDA graphs of the coupled segment: the card's ``CoupledModel.run``.

The reference runs a segment as one jitted program with the atmosphere's
mixing flag and the ocean's leapfrog flag traced
(``uvic_tpu/coupler/driver.py:_segment_core``).  Here the host knows the
schedule (``nats``, ``itt``), so one graph is captured per stage type,
as ``models/ocean/graphs.StepGraphs`` does for the ocean step: the
segment head, an atmosphere/ice step (mixing and leapfrog), the middle
(segment means, land update, sediments, gosbc), an ocean step (leapfrog
and mixing) and the tail (the ocean's means), seven graphs, each
replayed as the schedule says.

Every graph reads and writes one set of static buffers, the segment's
workspace (``driver.py``), the segment's inputs among them
(``CoupledModel.segment_inputs``: the fractional year, the transient
forcing with its Delta-14C and CFCs, the anomalous-wind climatology),
copied in before each segment.  A stage's outputs are copied back into
the buffers inside its graph, so replays chain.  Inside the graphs the
EMBM's BiCGSTAB runs ``solver_maxiter`` trips with its freeze, where an
eager segment stops on a host read of its convergence flag: the same
iterate, bitwise.  ``run`` copies the caller's state in and returns
fresh tensors, so an earlier state stays valid.

A capture that fails raises: there is no fallback to eager stages.
"""

from __future__ import annotations

import time
import weakref

import torch

from ..models.ocean.graphs import capturing
from ..ops.cg_kernel import congrad_launch
from ..ops.convection import apply_region_means
from ..ops.tracer_kernel import fct_tracer_step
from .driver import host_of, pack_state

KERNEL_WRAPPERS = {"fct_tracer_step": fct_tracer_step,
                   "apply_region_means": apply_region_means,
                   "congrad": congrad_launch}
STAGE_TYPES = (("head", None), ("atm", True), ("atm", False), ("mid", None),
               ("ocean", True), ("ocean", False), ("tail", None))


class SegmentGraphs:
    """The seven captured stages of one coupled model on static buffers.

    capture_s / instantiate_s : seconds each graph took, by stage type.
    captured : the launches each kernel wrapper made during each capture
    (its kernel nodes in that graph), by stage type.
    replays : how many times each graph was replayed, by stage type.
    inputs : the names of the segment inputs the graphs read.
    """

    def __init__(self, model, state, inputs):
        from ..cuda import LIBRARY
        LIBRARY.get()                     # build/load before any capture
        self.model = weakref.proxy(model)   # no cycle (graphs.capturing)
        self.inputs = tuple(inputs)
        embm = model.embm
        every = embm.check_every

        # one eager segment on a side stream fills the workspace with
        # every entry the stages write (its shapes and dtypes), warms up
        # the allocator and the kernels' attribute calls; the buffers are
        # clones, so the caller's state is untouched
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            ws = {k: v.clone() for k, v in pack_state(state).items()}
            ws.update({k: v.clone() for k, v in inputs.items()})
            host = host_of(state)
            for name, flag in STAGE_TYPES:
                embm.check_every = None
                ws.update(model.stage(name, flag, ws, dict(host)))
            self.ws = {k: v.clone() for k, v in ws.items()}
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()

        self.graphs, self.capture_s, self.instantiate_s = {}, {}, {}
        self.captured = {}
        self.replays = dict.fromkeys(STAGE_TYPES, 0)
        try:
            embm.check_every = None
            with capturing():
                for key in STAGE_TYPES:
                    self._capture(model, key, host)
        finally:
            embm.check_every = every

    def _capture(self, model, key, host):
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        before = {k: w.launches for k, w in KERNEL_WRAPPERS.items()}
        t0 = time.perf_counter()
        with torch.cuda.graph(graph):
            out = model.stage(key[0], key[1], self.ws, dict(host))
            self._write_back(out)
        torch.cuda.synchronize()
        self.capture_s[key] = time.perf_counter() - t0
        self.captured[key] = {k: w.launches - before[k]
                              for k, w in KERNEL_WRAPPERS.items()}
        t0 = time.perf_counter()
        graph.instantiate()
        torch.cuda.synchronize()
        self.instantiate_s[key] = time.perf_counter() - t0
        self.graphs[key] = graph

    def _write_back(self, out):
        """Copy a stage's outputs into the workspace buffers.  An output
        that shares storage with a buffer (atm1 <- at, a view of t, ...)
        is cloned first, so no copy reads a buffer another copy has
        overwritten."""
        ptrs = {b.untyped_storage().data_ptr() for b in self.ws.values()}
        pairs = []
        for k, src in out.items():
            dst = self.ws[k]
            if src is dst:
                continue
            if src.untyped_storage().data_ptr() in ptrs:
                src = src.clone()
            pairs.append((dst, src))
        for dst, src in pairs:
            dst.copy_(src)

    def run(self, state, inputs):
        """One segment from ``state`` with the segment ``inputs`` by
        replays; the logs and means are left on the model as
        ``run_segment`` leaves them."""
        m = self.model
        for k, v in pack_state(state).items():
            self.ws[k].copy_(v)
        for k, v in inputs.items():
            self.ws[k].copy_(v)
        host = host_of(state)
        logs = dict(cg_iters=[], trips_q=[], trips_t=[])
        for name, flag in m.schedule(host):
            self.graphs[(name, flag)].replay()
            self.replays[(name, flag)] += 1
            if name == "ocean":
                logs["cg_iters"].append(self.ws["cg_iters"].clone())
                host["itt"] += 1
            elif name == "atm":
                logs["trips_q"].append(self.ws["trips_q"].clone())
                logs["trips_t"].append(self.ws["trips_t"].clone())
                host["nats"] = 1 if flag else host["nats"] + 1
        ws = {k: v.clone() for k, v in self.ws.items()}
        return m._finish(ws, host, logs)
