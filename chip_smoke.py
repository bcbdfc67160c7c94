#!/usr/bin/env python3
"""Drive the PyTorch port's flagship ocean step on one NVIDIA card.

    python3 chip_smoke.py            # the whole check, below
    python3 chip_smoke.py --times    # kernel times only, one JSON line

Phases (each failure ends the run with a non-zero exit code):

0. A watchdog (faulthandler, WATCHDOG_S) turns a hang into a traceback
   and exit 1; the card's name and power limit as nvidia-smi reports
   them; a CUDA card is required; the TF32 settings.
1. Build the CUDA kernels (one nvcc call, uvic_tpu_torch/cuda.py) and
   print the seconds it took and ptxas' report (registers, shared memory,
   spills); fail if a kernel spills.
2. Build the flagship ocean (102x102x19, nt=2, float32) on the card,
   prime it and take a few leapfrog steps.  Add seeded noise to T and S
   (unstable columns for convection, horizontal gradients for the
   diffusion, isopycnal and limiter terms) and capture the inputs each
   kernel receives in one more step from there.  Each kernel is held
   against its plain PyTorch version on those inputs, on the card,
   within the tolerance stated below.  Times are CUDA-event medians:
   `ms`, `plain_ms` and `library_ms` are one call between two events, as
   a caller that waits on each call sees it (the wrapper's host time
   included); `device_ms` is the device time of one wrapper call, from
   a CUDA graph of GRAPH_REPS calls replayed back to back (no host time
   in it).  The plain versions' and the library call's device times
   are printed too (not the CG's: its host loop reads scalars back).
   `launches_per_call` is the number of device kernels torch.profiler
   records for one wrapper call.  The tracer step is also timed with
   the L2 cache flushed (64 MB written) before each launch; the CG
   reads back the CTAs its cluster launched with (`cluster`), prints
   its time per iteration from a zero guess, the time of a solve
   started from the solution (setup, one trip and the close), and its
   zero-guess time per iteration at the default cluster and at 8, the
   portable size, in the order 8, default, default, 8.
3. A small-input reference: the flagship physics on a 34x40x8 grid,
   float32 on the card against float64 on the CPU (plain versions).
4. The main path: from the flagship state of phase 2 without the noise,
   the launch counters are set to 0, 20 leapfrog steps run through the
   model's entry points, the counters must each read 20, and t, u and
   psi must be finite.

The last two lines of standard output are a JSON line describing each
kernel and the result line {"ok": true, "device": {...}}.

With --times the script builds the flagship and captures the kernels'
inputs as in phase 2, then prints one JSON line of the three wrappers'
`ms` and `device_ms` and the CG's iteration counts.  It uses only entry
points that every version of the port has, so a copy of this script run
from another checkout's root times that checkout's kernels: the way two
commits are compared on one card in one call.
"""

import dataclasses
import faulthandler
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

WATCHDOG_S = 600
N_STEPS = 20
N_WARM = 3
N_TIMED = 30
GRAPH_REPS = 20
L2_FLUSH_BYTES = 64 << 20       # more than the H100's 50 MB L2
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12         # H100 SXM, fp32 outside the tensor cores

# Noise added to the flagship state before the kernels' inputs are
# captured (standard deviations at the equator, scaled by cos(latitude);
# S is in model units, (psu - 35) / 1000).
NOISE_T, NOISE_S, NOISE_SEED = 0.5, 1e-4, 0

# Tolerances.
#   tracer step and region-mean apply: max |kernel - plain| relative to
#     the largest increment the plain version makes (|t_new - tm1| for
#     the tracer step, |out - t| for the apply), so that a dropped or
#     wrong term shows against what the step changes, not against the
#     ~20 K of the field.  Both kernels contract multiply-adds (FMA);
#     the tracer step also sums its tendency terms in another order than
#     the plain version.  On these inputs an H100 measured 2.6e-6 (tracer
#     step) and 1.3e-6 (apply, one f32 ulp of ~16 K against a 1.4 K
#     increment); the limits are ~10x those.  Kernels that drop the x
#     diffusion or the isopycnal tendency, or pass t through the apply,
#     measured 0.13, 0.51 and 1.0.
#   CG: both solves stop once the extrapolated error is below tolrsf,
#     along different f32 round-off paths -> the two solutions agree to
#     10 x tolrsf (absolute), and the iteration counts to within
#     max(3, 10%).
#   small-input reference (f32 card vs f64 CPU, 4 steps): the same
#     comparison on the CPU (f32 vs f64 plain versions) drifts 4e-6 (t),
#     2e-6 (u), 1e-6 (psi); t and u get 1e-4 for the card's other
#     summation orders, psi 1e-3 (the CG stops at tolrsf = 5e-4 of psi).
TOL_TRACER = 3e-5
TOL_CONVECT = 1.5e-5
TOL_CG_TOLRSF = 10.0
TOL_SMALL = dict(t=1e-4, u=1e-4, psi0=1e-3)


def say(*args):
    print(*args, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, n=N_TIMED, warm=3):
    """Median time of fn() over n calls, each between two CUDA events
    (host time of fn included)."""
    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, flush=None, n=5):
    """Device time of one fn() call: the median over n replays of a CUDA
    graph of GRAPH_REPS calls, divided by GRAPH_REPS.  With flush, the
    graph runs flush() before each call and the time of a graph of the
    flushes alone is taken off."""
    import torch

    def per_call(body):
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            for _ in range(3):
                body()
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(GRAPH_REPS):
                body()
        graph.replay()
        times = []
        for _ in range(n):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / GRAPH_REPS)
        return statistics.median(times)

    if flush is None:
        return per_call(fn)

    def both():
        flush()
        fn()

    return per_call(both) - per_call(flush)


def inc_err(got, ref, base):
    """max |got - ref|, that relative to max |ref - base|, and the latter."""
    import torch
    err = float(torch.max(torch.abs(got.double() - ref.double())))
    scale = float(torch.max(torch.abs(ref.double() - base.double())))
    return err, err / max(scale, 1e-30), scale


def rel_err(got, ref):
    import torch
    err = float(torch.max(torch.abs(got.double() - ref.double())))
    scale = float(torch.max(torch.abs(ref.double())))
    return err, err / max(scale, 1e-30)


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def perturbed(m, state):
    """The state with seeded noise added to T and S at both time levels
    on ocean cells, periodic in i like the state itself.  The noise is
    scaled by cos(latitude): grid-scale noise of one size everywhere
    would make the few rows next to the poles, where the cells are
    narrowest, take increments ~20x larger than elsewhere, and those
    would set the scale of the tracer step's check."""
    import numpy as np
    import torch
    from uvic_tpu_torch.ops.stencil import setbcx
    rng = np.random.default_rng(NOISE_SEED)
    shape = tuple(state.t.shape[1:])
    noise = np.stack([NOISE_T * rng.standard_normal(shape),
                      NOISE_S * rng.standard_normal(shape)])
    noise *= np.asarray(m.params.grid.cst)[:, None]
    d = torch.as_tensor(noise, dtype=state.t.dtype,
                        device=state.t.device) * m.tmask
    d = setbcx(d, m.cyclic)
    return dataclasses.replace(state, t=state.t + d, tm1=state.tm1 + d)


def capture_step(m, state, forcing):
    """One leapfrog step of the model with the arguments each kernel
    wrapper receives recorded."""
    import uvic_tpu_torch.models.ocean.model as model_mod
    seen = {}
    tracer, convect, solver = (model_mod.fct_tracer_step,
                               model_mod.convct_full, m.cg_solver)

    def rec_tracer(*a, **k):
        seen["tracer"] = (a, k)
        return tracer(*a, **k)

    def rec_convect(*a):
        seen["convect"] = a
        return convect(*a)

    def rec_solver(*a):
        seen["cg"] = a
        return solver(*a)

    model_mod.fct_tracer_step = rec_tracer
    model_mod.convct_full = rec_convect
    m.cg_solver = rec_solver
    try:
        state = m.step(state, forcing, leapfrog=True)
    finally:
        model_mod.fct_tracer_step = tracer
        model_mod.convct_full = convect
        m.cg_solver = solver
    return state, seen


def kernels_per_call(fn):
    """Device kernels (and other device activities) that one fn() call
    launches, as torch.profiler records them."""
    import warnings
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings():   # the profiler warns when run again
        warnings.simplefilter("ignore")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    n = sum(1 for e in prof.events()
            if "CUDA" in str(getattr(e, "device_type", "")))
    if n < 1:
        raise AssertionError("torch.profiler recorded no device kernel")
    return n


def check_tracer(m, seen):
    import torch
    from uvic_tpu_torch.ops.tracer_kernel import (blocks_per_sm,
                                                  fct_tracer_step,
                                                  fct_tracer_step_ref,
                                                  tracer_launch)
    args, kw = seen["tracer"]
    got = fct_tracer_step(*args, **kw)
    ref = fct_tracer_step_ref(*args, **kw)
    torch.cuda.synchronize()
    tm1 = args[2]
    worst, worst_abs = 0.0, 0.0
    for n in range(got.shape[0]):
        err, rel, inc = inc_err(got[n], ref[n], tm1[n])
        say(f"  tracer {n}: max abs err {err:.3e}, max increment {inc:.3e},"
            f" err / increment {rel:.3e} (tolerance {TOL_TRACER})")
        worst, worst_abs = max(worst, rel), max(worst_abs, err)
    if not worst <= TOL_TRACER:
        raise AssertionError(f"tracer step: err / increment {worst} > "
                             f"{TOL_TRACER}")

    def kernel():
        return fct_tracer_step(*args, **kw)

    def plain():
        return fct_tracer_step_ref(*args, **kw)

    ms = cuda_time_ms(kernel)
    dev_ms = device_ms(kernel)
    scratch = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    cold_ms = device_ms(kernel, flush=lambda: scratch.fill_(1.0))
    plain_ms = cuda_time_ms(plain)
    plain_dev_ms = device_ms(plain)
    per_call = kernels_per_call(kernel)
    consts, t_tau, tm1, vet, vnt, vbt, dcb, stf, btf, src, twodt, tmask, \
        kmt = args
    isow = kw.get("isow")
    nt, km, jmt, imt = t_tau.shape
    blocks, threads, smem = tracer_launch(nt, km, jmt, imt)
    say(f"  one launch: {blocks} blocks of {threads} threads, {smem} bytes "
        f"of shared memory each, {blocks_per_sm(km, imt)} blocks per SM; "
        f"{per_call} device kernel(s) per call")
    say(f"  device time {dev_ms:.4f} ms with the inputs in L2, "
        f"{cold_ms:.4f} ms with L2 flushed before each launch; plain "
        f"version {plain_dev_ms:.4f} ms")
    vol, plane = km * jmt * imt, jmt * imt
    nbytes = 4 * (3 * nt * vol + 5 * vol + 2 * nt * plane
                  + (18 * vol if isow is not None else 0)
                  + 6 * km + 7 * plane)
    # ~400 flops per tracer cell, counted from csrc/tracer_step.cu
    b_ms, b_by = bound(nbytes, 400.0 * nt * vol)
    return dict(name="fct_tracer_step", max_abs_err=worst_abs, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, bytes=nbytes, device_ms=dev_ms,
                launches_per_call=per_call)


def check_convect(seen):
    import torch
    from uvic_tpu_torch.ops.convection import (apply_region_means,
                                               apply_region_means_ref,
                                               region_mixing_matrix)
    ts, kmt, eos_c, eos_to, eos_so, dztxcl = seen["convect"]
    km = ts.shape[1]
    mnorm = region_mixing_matrix(ts, kmt, eos_c, eos_to, eos_so,
                                 dztxcl).contiguous()
    idx = torch.arange(km, device=ts.device).reshape(km, 1, 1)
    ocean = torch.broadcast_to((idx < kmt[None]).to(ts.dtype),
                               ts.shape[1:]).contiguous()
    # columns whose mixing matrix is not the identity on some level
    eye = torch.eye(km, dtype=ts.dtype, device=ts.device)[:, :, None, None]
    mixed = int(((mnorm - eye).abs() > 0).any(0).any(0)
                .logical_and(kmt > 0).sum())
    say(f"  {mixed} of {int((kmt > 0).sum())} ocean columns convect")
    if not mixed > 0:
        raise AssertionError("convection: no column mixes in the captured "
                             "inputs")
    got = apply_region_means(ts, mnorm, ocean)
    ref = apply_region_means_ref(ts, mnorm, ocean)
    torch.cuda.synchronize()
    worst, worst_abs = 0.0, 0.0
    for n in range(got.shape[0]):
        err, rel, inc = inc_err(got[n], ref[n], ts[n])
        say(f"  tracer {n}: max abs err {err:.3e}, max increment {inc:.3e},"
            f" err / increment {rel:.3e} (tolerance {TOL_CONVECT})")
        worst, worst_abs = max(worst, rel), max(worst_abs, err)
    if not worst <= TOL_CONVECT:
        raise AssertionError(f"convection: err / increment {worst} > "
                             f"{TOL_CONVECT}")

    def kernel():
        return apply_region_means(ts, mnorm, ocean)

    def plain():
        return apply_region_means_ref(ts, mnorm, ocean)

    def library():
        return torch.where(ocean[None] > 0,
                           torch.einsum("klji,nlji->nkji", mnorm, ts), ts)

    ms = cuda_time_ms(kernel)
    dev_ms = device_ms(kernel)
    plain_ms = cuda_time_ms(plain)
    library_ms = cuda_time_ms(library)
    per_call = kernels_per_call(kernel)
    say(f"  device time {dev_ms:.4f} ms; plain version "
        f"{device_ms(plain):.4f} ms, library call {device_ms(library):.4f}"
        f" ms; {per_call} device kernel(s) per call")
    nt, km, jmt, imt = ts.shape
    vol = km * jmt * imt
    nbytes = 4 * (2 * nt * vol + km * vol + vol)
    b_ms, b_by = bound(nbytes, 2.0 * km * nt * vol)
    return dict(name="apply_region_means", max_abs_err=worst_abs, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms, bytes=nbytes, device_ms=dev_ms,
                launches_per_call=per_call)


def check_cg(m, seen):
    """The captured solve (warm guess, as in the main path) and the same
    system from a zero guess, which takes the iteration loop through
    tens of trips at the flagship shape.  The JSON line carries the
    captured solve."""
    import torch
    from uvic_tpu_torch.ops.cg_kernel import (CGSolver, congrad_cuda,
                                              congrad_launch, congrad_ref,
                                              max_active_clusters)
    guess, forc, c2dtsf, tol = seen["cg"]
    solver = m.cg_solver
    lay = solver.layout
    jmt, imt = guess.shape
    say(f"  clusters of {lay.cluster} CTAs, bands of at most {lay.rmax} "
        f"rows, {lay.smem_bytes} bytes of shared memory per CTA; the card "
        f"holds {max_active_clusters(solver)} such clusters at once")
    plane = jmt * imt
    nbytes = 4 * (9 + 1 + 1 + 2 + 1) * plane
    out = {}
    for case, g0 in (("warm", guess), ("cold", torch.zeros_like(guess))):
        got, info = congrad_launch(solver, g0, forc, c2dtsf, tol)
        ref, it_ref = congrad_ref(solver.cf_unit, solver.isl, g0, forc,
                                  c2dtsf, tol, solver.max_iter,
                                  solver.cyclic)
        torch.cuda.synchronize()
        it_got, ctas, it_ref = int(info[0]), int(info[1]), int(it_ref)
        err, rel = rel_err(got, ref)
        say(f"  {case} guess: launched as a cluster of {ctas} CTAs; dpsi "
            f"max abs err {err:.3e} (rel {rel:.3e}, tolrsf {tol:.1e}); "
            f"iterations kernel {it_got}, plain {it_ref}")
        if not err <= TOL_CG_TOLRSF * tol:
            raise AssertionError(f"CG: err {err} > {TOL_CG_TOLRSF} x tolrsf")
        if not abs(it_got - it_ref) <= max(3, 0.1 * it_ref):
            raise AssertionError(f"CG: iterations {it_got} vs {it_ref}")
        if not it_got < solver.max_iter:
            raise AssertionError("CG kernel did not converge")
        if not ctas >= 2:
            raise AssertionError(f"CG: a cluster of {ctas} CTAs")

        def kernel():
            return congrad_cuda(solver, g0, forc, c2dtsf, tol)

        ms = cuda_time_ms(kernel)
        dev_ms = device_ms(kernel)
        plain_ms = cuda_time_ms(
            lambda: congrad_ref(solver.cf_unit, solver.isl, g0, forc,
                                c2dtsf, tol, solver.max_iter,
                                solver.cyclic), n=5, warm=1)
        say(f"  {case} guess: {ms:.4f} ms, device time {dev_ms:.4f} ms "
            f"({dev_ms / it_got * 1e3:.2f} us per iteration), plain "
            f"{plain_ms:.4f} ms")
        # per iteration: 9-point stencil (18 flops) + ~30 elementwise and
        # reduction flops per cell, counted from csrc/congrad.cu
        b_ms, b_by = bound(nbytes, 48.0 * plane * it_got)
        out[case] = dict(name="congrad", max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=None, bytes=nbytes, device_ms=dev_ms,
                         cluster=ctas, iters=it_got)
        if case == "warm":
            out[case]["launches_per_call"] = kernels_per_call(kernel)
            # from the plain version's solution: setup, a trip, the close
            _, it_sol = congrad_cuda(solver, ref, forc, c2dtsf, tol)
            sol_ms = device_ms(lambda: congrad_cuda(solver, ref, forc,
                                                    c2dtsf, tol))
            say(f"  from the solution: device time {sol_ms:.4f} ms, "
                f"{int(it_sol)} iteration(s)")
    cold = out["cold"]
    say(f"  zero guess: {cold['device_ms'] / cold['iters'] * 1e3:.2f} us per"
        f" iteration")
    # the default cluster against the portable size, on the zero guess
    zero = torch.zeros_like(guess)
    portable = CGSolver(solver.cf_unit, solver.isl, solver.max_iter,
                        solver.cyclic, cluster=8)
    per_iter = {}
    for sv in (portable, solver, solver, portable):
        _, info = congrad_launch(sv, zero, forc, c2dtsf, tol)
        ctas, it = int(info[1]), int(info[0])
        us = device_ms(lambda: congrad_cuda(sv, zero, forc, c2dtsf,
                                            tol)) / it * 1e3
        per_iter.setdefault(ctas, []).append(f"{us:.3f}")
    say("  zero guess, us per iteration by cluster size (order 8, "
        f"default, default, 8): {json.dumps(per_iter)}")
    return out["warm"]


def small_reference():
    """Flagship physics on a small grid: card f32 vs CPU f64, 4 steps."""
    import dataclasses
    import numpy as np
    import torch
    from uvic_tpu_torch.config import small_config
    from uvic_tpu_torch.convert import ocean_state_to_numpy
    from uvic_tpu_torch.models.ocean.model import make_forcing, make_ocean
    out = {}
    for device, dtype in (("cuda", "float32"), ("cpu", "float64")):
        cfg = small_config(imt=40, jmt=34, km=8).replace(dtype=dtype)
        cfg = cfg.replace(ocean=dataclasses.replace(
            cfg.ocean, isopycmix=True, gent_mcwilliams=True, tidal_kv=True,
            gthflx=True, aniso_visc=True, aniso_zonal=True))
        m = make_ocean(cfg, device=device)
        g = m.params.grid
        rng = np.random.default_rng(0)
        t0 = np.zeros((2, g.km, g.jmt, g.imt))
        t0[0] = (20.0 * np.exp(-np.asarray(g.zt) / 1000e2))[:, None, None] \
            + 0.5 * rng.standard_normal((g.km, g.jmt, g.imt))
        t0[1] = 1e-4 * rng.standard_normal((g.km, g.jmt, g.imt))
        t0 *= np.asarray(m.params.topo.tmask)
        taux = np.sin(np.deg2rad(np.asarray(g.yu) * 3))[:, None] \
            * np.ones((1, g.imt))
        smf = np.stack([taux / 1.035, np.zeros_like(taux)])

        def tn(x):
            return torch.as_tensor(x, dtype=m.dtype, device=m.device)

        f = make_forcing(tn(smf), tn(np.zeros((2, g.jmt, g.imt))))
        s = m.step(m.init_state(t0), f, leapfrog=False)
        for _ in range(3):
            s = m.step(s, f, leapfrog=True)
        out[device] = ocean_state_to_numpy(s)
    for name, tol in TOL_SMALL.items():
        a, b = out["cuda"][name], out["cpu"][name]
        rel = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
        say(f"  {name}: rel err {rel:.3e} (tolerance {tol})")
        if not (np.isfinite(a).all() and rel <= tol):
            raise AssertionError(f"small reference: {name} rel err {rel}")


def flagship_inputs():
    """The flagship model on the card, its state after N_WARM leapfrog
    steps, its forcing, and the arguments each kernel wrapper receives in
    one step from that state with seeded noise added."""
    from uvic_tpu_torch.entry import _flagship
    m, state, forcing = _flagship(small=False)
    for _ in range(N_WARM):
        state = m.step(state, forcing, leapfrog=True)
    _, seen = capture_step(m, perturbed(m, state), forcing)
    return m, state, forcing, seen


def times_only():
    """--times: `ms` and `device_ms` of the three kernel wrappers on the
    captured flagship inputs, one JSON line."""
    import torch
    import uvic_tpu_torch
    from uvic_tpu_torch.ops.cg_kernel import congrad_cuda
    from uvic_tpu_torch.ops.convection import (apply_region_means,
                                               region_mixing_matrix)
    from uvic_tpu_torch.ops.tracer_kernel import fct_tracer_step
    m, _, _, seen = flagship_inputs()
    args, kw = seen["tracer"]
    ts, kmt, eos_c, eos_to, eos_so, dztxcl = seen["convect"]
    km = ts.shape[1]
    mnorm = region_mixing_matrix(ts, kmt, eos_c, eos_to, eos_so,
                                 dztxcl).contiguous()
    idx = torch.arange(km, device=ts.device).reshape(km, 1, 1)
    ocean = torch.broadcast_to((idx < kmt[None]).to(ts.dtype),
                               ts.shape[1:]).contiguous()
    guess, forc, c2dtsf, tol = seen["cg"]
    zero = torch.zeros_like(guess)
    solver = m.cg_solver
    calls = {
        "fct_tracer_step": lambda: fct_tracer_step(*args, **kw),
        "apply_region_means": lambda: apply_region_means(ts, mnorm, ocean),
        "congrad_warm": lambda: congrad_cuda(solver, guess, forc, c2dtsf,
                                             tol),
        "congrad_zero": lambda: congrad_cuda(solver, zero, forc, c2dtsf,
                                             tol),
    }
    out = {"package": str(Path(uvic_tpu_torch.__file__).parent),
           "card": card_line()}
    for name, fn in calls.items():
        out[name] = {"ms": cuda_time_ms(fn), "device_ms": device_ms(fn)}
    out["cg_iters"] = {"warm": int(calls["congrad_warm"]()[1]),
                       "zero": int(calls["congrad_zero"]()[1])}
    say(json.dumps(out))
    return 0


def main(argv):
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    t_start = time.perf_counter()
    card = card_line()
    say(card)

    import torch
    if not torch.cuda.is_available():
        say("no CUDA device")
        return 1
    if argv == ["--times"]:
        code = times_only()
        faulthandler.cancel_dump_traceback_later()
        return code
    if argv:
        say(f"unknown arguments {argv}")
        return 2
    import uvic_tpu_torch  # noqa: F401  (sets the TF32 switches)
    from uvic_tpu_torch.cuda import LIBRARY
    from uvic_tpu_torch.ops.cg_kernel import congrad_launch
    from uvic_tpu_torch.ops.convection import apply_region_means
    from uvic_tpu_torch.ops.tracer_kernel import fct_tracer_step
    say(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    say(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}")

    say("phase 1: build")
    LIBRARY.get()
    say(f"  kernels built/loaded in {LIBRARY.build_seconds:.1f} s")
    for line in LIBRARY.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            say("  ptxas: " + line.strip())
        spill = re.search(r"(\d+) bytes spill stores", line)
        if spill and int(spill.group(1)) > 0:
            raise AssertionError("a kernel spills: " + line.strip())

    say("phase 2: kernels against their plain versions, flagship shapes")
    m, state, forcing, seen = flagship_inputs()
    say(" fct_tracer_step")
    k_tracer = check_tracer(m, seen)
    say(" apply_region_means")
    k_convect = check_convect(seen)
    say(" congrad")
    k_cg = check_cg(m, seen)
    for k in (k_tracer, k_convect, k_cg):
        lib = ("" if k["library_ms"] is None
               else f", library {k['library_ms']:.4f} ms")
        say(f"  {k['name']}: {k['ms']:.4f} ms one call between events "
            f"(device time {k['device_ms']:.4f} ms; plain "
            f"{k['plain_ms']:.4f} ms{lib}; bound {k['bound_ms']:.4f} ms by "
            f"{k['bound_by']}, {k['bytes']} bytes)")

    say("phase 3: small-input reference, f32 card vs f64 CPU")
    small_reference()

    say(f"phase 4: main path, {N_STEPS} flagship leapfrog steps")
    fct_tracer_step.launches = 0
    apply_region_means.launches = 0
    congrad_launch.launches = 0
    step_ms, cg_iters = [], []
    for _ in range(N_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = m.step(state, forcing, leapfrog=True)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        cg_iters.append(int(m.last_cg_iters))
    launches = {"fct_tracer_step": fct_tracer_step.launches,
                "apply_region_means": apply_region_means.launches,
                "congrad": congrad_launch.launches}
    for name in ("t", "u", "psi0"):
        if not bool(torch.isfinite(getattr(state, name)).all()):
            raise AssertionError(f"non-finite {name} after the main path")
    for name, count in launches.items():
        if count != N_STEPS:
            raise AssertionError(f"{name} launched {count} times in "
                                 f"{N_STEPS} steps")
    say(f"  step time median {statistics.median(step_ms):.3f} ms "
        f"(min {min(step_ms):.3f}, max {max(step_ms):.3f})")
    say(f"  CG iterations per step: {cg_iters}")
    say(f"  |t| max {float(state.t.abs().max()):.4f}, |u| max "
        f"{float(state.u.abs().max()):.4f}, |psi| max "
        f"{float(state.psi0.abs().max()):.4e}")
    say(f"  kernels: {json.dumps(launches)}")

    sources = {"fct_tracer_step": ("uvic_tpu_torch/csrc/tracer_step.cu",
                                   "uvic_tpu/ops/pallas_tracer.py:86"),
               "apply_region_means": ("uvic_tpu_torch/csrc/convect_apply.cu",
                                      "uvic_tpu/ops/convection.py:90"),
               "congrad": ("uvic_tpu_torch/csrc/congrad.cu",
                           "uvic_tpu/ops/pallas_cg.py:87")}
    kernels = []
    for k in (k_tracer, k_convect, k_cg):
        src, rep = sources[k["name"]]
        entry = {"name": k["name"], "route": "cuda", "source": src,
                 "replaces": rep, "launches": launches[k["name"]],
                 "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                 "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                 "bound_by": k["bound_by"], "library_ms": k["library_ms"],
                 "device_ms": k["device_ms"],
                 "launches_per_call": k["launches_per_call"]}
        if "cluster" in k:
            entry["cluster"] = k["cluster"]
        kernels.append(entry)
    say(f"total {time.perf_counter() - t_start:.1f} s")
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
