#!/usr/bin/env python3
"""Drive the PyTorch port's flagship ocean steps, its restoring run, its
coupled earth segment and its rank-decomposed ocean step on one NVIDIA
card.

    python3 chip_smoke.py                  # the whole check, below
    python3 chip_smoke.py --times          # kernel times only, one JSON line
    python3 chip_smoke.py --golden-years N # N earth years against the golden
    python3 chip_smoke.py --precision-year DIR  # the float32 year, into DIR
    python3 chip_smoke.py --golden-gaps TSI_CSV  # a run's tsi, by year

Phases (each failure ends the run with a non-zero exit code):

0. A watchdog (faulthandler, WATCHDOG_S) turns a hang into a traceback
   and exit 1; the card's name and power limit as nvidia-smi reports
   them; a CUDA card is required; the TF32 settings.
1. Build the CUDA kernels (one nvcc a source, in parallel, and a link;
   uvic_tpu_torch/cuda.py) and
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
   The tracer step and the apply are also timed with
   the L2 cache flushed (64 MB written) before each launch; the apply
   prints its launch geometry and the blocks an SM holds, and is held
   against its plain version on seeded random inputs at CONVECT_SHAPES
   (odd planes, km 1 to 64, nt 1 to 41) and must refuse km 65; the CG
   reads back the CTAs its cluster launched with (`cluster`), prints
   its time per iteration from a zero guess, the time of a solve
   started from the solution (setup, one trip and the close), and its
   zero-guess time per iteration at the default cluster and at 8, the
   portable size, in the order 8, default, default, 8.
   Then the full-MOBI flagship (nt=41): the inputs of one MOBI step,
   with its bgc source, from the primed MOBI state with the same T/S
   noise and NOISE_BGC of log-normal noise on every bgc tracer; the
   tracer step and the apply are held against their plain versions on
   them, and the tracer step also in its non-isopycnal form (harmonic
   y-diffusion, no weight stack, aidif = 0) on the nt=2 inputs.
3. A small-input reference: the flagship physics on a 34x40x8 grid,
   float32 on the card against float64 on the CPU (plain versions).
4. The main path at nt=2: from the flagship state of phase 2 without the
   noise, the launch counters are set to 0, 20 leapfrog steps run
   through the model's entry points, the counters must each read 20,
   and t, u and psi must be finite.  Then `run_scan` over N_SCAN steps
   (one CUDA graph per step type, a mixing step included) must equal
   the same steps taken eagerly with run_scan's semantics bitwise, and
   each graph must hold exactly one launch of each kernel (the
   wrappers' counters, read across each capture).
5. The main path at nt=41, the full-MOBI flagship: the MOBI sources,
   float32 on the card against float64 on the CPU on the 34x40x8 MOBI
   grid (plain versions); `run_scan` over N_SCAN41 steps from the primed
   state set to itt nmix - 2, so that its third step is a mixing step
   (capture, instantiation, replay times, CG iterations, one
   launch of each kernel captured in each graph); two
   eager steps with run_scan's semantics from its state after
   N_SCAN41 - 2 steps (a mixing step and a leapfrog step; the launch
   counters must read 2) equal to their replay bitwise; every field
   finite.
6. The coupled earth segment: ``CoupledModel(earth_config(),
   topo_kind="earth")`` built on the card from EARTH_RESTART (year 1060)
   with its relyr; the stages up to the first ocean step of a segment,
   then the three kernels held against their plain versions on that
   ocean step's inputs (the segment's forcing, phase 2's noise on T and
   S; the CG on the earth's six islands, its iteration counts printed)
   with phase 2's tolerances; EARTH_SEGMENTS segments eagerly (launch
   counters: ntspos of each kernel a segment) and the same segments
   replayed from CUDA graphs, one per stage type, equal bitwise (state
   and time means), with each graph's capture and instantiation seconds,
   its nodes and its kernel launches.  Then one year (EARTH_YEAR
   segments) through the port's Run (``coupler/run.py``) with the
   output intervals of the golden's run (EARTH_RUN_TIME), its graphs
   dropped first so that its first segment captures them with the launch
   counters from 0 (each graph must hold one launch of each kernel an
   ocean step, ntspos a segment, every later segment replay the same
   graphs, and the graphs' replays over the year times their captured
   launches make ntspos a segment): every tsi row it writes held
   against the golden stream's row of that day within TOL_GOLDEN, nconv
   equal; tavg.nc read back through the port's read_var as one record at
   the year's end holding TAVG_VARIABLES, every field finite; restart.npz
   with the calendar (``__itt``, ``__days``); run_summary.json with the
   drift; the segment time inside Run (median) beside the bare replay's.
   Then a split run: a fresh Run resumed from the year's restart.npz
   takes EARTH_SPLIT segments, the year's Run as many more: equal
   bitwise, state and tsi rows.  Last, EARTH_BARE bare replayed segments
   (``m.run``) timed beside the segments inside Run.
7. Transient forcing and anomalous winds, each on its own earth model:
   EARTH_TRANSIENT segments under a TransientForcing whose CO2 rises
   steeply, with a volcanic drop, the sulphate scale above 0 and the ice
   sheets crossing their 0.5 extent, eagerly and replayed: equal
   bitwise (state and time means); the same graphs replayed under
   constant forcing must move atm/at (the graphs read the forcing from
   the workspace).  Then ``embm.awind`` with a climatology set from the
   restart's SAT, perturbed: EARTH_AWIND segments eager and replayed,
   equal bitwise, and one more of each under another climatology, equal
   bitwise on the same graphs and different from the first.  Each
   graph's capture and instantiation seconds are printed.
8. The earth carbon cycle: the earth model with ``mobi_full()`` (41
   tracers), pore-water sediments and the default transient forcing from
   year EARTH_BGC_YEAR0, from ``init_state()`` (the configuration of
   ``golden/regression/bgc_earth_month.py``).  The stages up to the
   first ocean step, then the three kernels held against their plain
   versions on that step's inputs (phase 2's noise on T and S, phase 2's
   tolerances), which must carry a non-zero surface flux in each of
   EARTH_BGC_GAS (gas exchange) and a non-zero bottom flux in each of
   EARTH_BGC_BOTTOM (the sediments); EARTH_BGC_SEGMENTS segments eagerly
   (launch counters: ntspos of each kernel a segment) and the same
   segments replayed, equal bitwise (state with the sediments, time
   means with the surf_* rows), each graph's capture and instantiation
   seconds, nodes and kernel launches.  Then EARTH_BGC_MONTH segments
   through the port's Run (EARTH_BGC_RUN_TIME) on the same graphs: each
   segment's row (``bgc_row``: each tracer's volume and surface mean, the
   area integrals of its surface flux and of the dic and alk bottom
   flux, the sediments' means, nconv) held against the JAX package's
   float64 row of EARTH_BGC_GOLDEN within that file's tolerances, nconv
   equal; ``tavg.nc`` with every surf_<tracer>, all finite;
   ``restart.npz`` with 41 tracers and the sediments' seven fields.
9. The spin-up and the coupled options.  (a) The earth model at
   acceleration ACCEL (``earth_config(accel=ACCEL)``, from EARTH_RESTART):
   B1's twodt_k must differ by level; the three kernels held against
   their plain versions on an ocean step's inputs (phase 2's noise and
   tolerances; B3's M from dzt/dtxcel); EARTH_ACCEL_SEGMENTS segments
   eager and replayed, bitwise equal (launch counters: ntspos of each
   kernel a segment, eager and in the graphs); EARTH_OPTION_BARE more
   replays timed.  Then one year through ``uvic_tpu_torch.spinup.main``
   (``1 --accel ACCEL --resume``) from a copy of SPINUP_START: the row
   with the script's keys and year 1061, every key within the limits of
   SPINUP_GOLDEN, ``restart.npz`` and ``restart_meta.json`` written, the
   year's seconds and simulated years a day, the wrappers' counters over
   it (the captures); and a second ``--resume`` of one segment that
   must start from year 1061.  (b) Each of EARTH_OPTIONS (multi-category
   ice, brine convection, the ice off, no EVP, free drift) on its own
   earth model from EARTH_RESTART: EARTH_OPTION_SEGMENTS segments eager
   and replayed, bitwise equal and finite, each graph set's capture and
   instantiation seconds and nodes, EARTH_OPTION_BARE more replays
   timed; on the brine path B3 held against
   its plain version on each of an ocean step's BRINE_CONVECTIONS
   convections, and its counter BRINE_CONVECTIONS an ocean step (eager
   and in the graph).  (c) The multi-category ice run of CPTS_GOLDEN in
   float32 on the card against float64 on the CPU, both eager with the
   barotropic CG's trips printed: every field within its limit (5x the
   JAX package's own float32 gap), the barotropic fields
   (CPTS_BAROTROPIC) too unless a solve's trips differ between the two.
10. The ocean-only restoring run: the flagship of ``entry._flagship()``
   restored toward the seasonal climatology (``io/timeforce.py``).  The
   three kernels held against their plain versions (phase 2's
   tolerances) on a restoring step's inputs: phase 2's noise on T and S,
   the climatology at the first segment's midpoint, so that B1's stf is
   non-zero in both rows.  Then RESTORING_SEGMENTS segments of
   RESTORING_SEG_DAYS days (24 steps) through ``OceanModel.run_restoring``,
   one call a segment with relyr0 accumulated as run_restoring
   accumulates it: the first call captures the two step graphs (each must
   hold one launch of each kernel), and over it the wrappers launch only
   in the capture's warm-up and the captures, and the graphs' replays
   (``StepGraphs.replays``) times their captured launches make 24 of
   each kernel; its result must equal run_scan on the same forcing and
   the same 24 steps taken eagerly (launch counters 24), bitwise; the
   year keeps the same graphs, launches nothing outside them and
   replays them 288 times; the second segment under
   a climatology RESTORING_WARMER K warmer, on the same graphs, must warm
   the mean SST and equal its eager steps bitwise; each segment's
   row (``restoring_row``: area-mean SST and SSS, their mean gap to the
   climatology, volume-mean T and S, psi max and min, the mean CG
   iterations, nconv) is held against RESTORING_GOLDEN within that
   segment's limits, with the segment times and the simulated years a day; then one
   "bcest" segment, finite.  On the year's final state ``Regions.
   volume_mean`` of T and S, ``XbtStations``, ``cross_section``,
   ``zonal_mean_sbc`` and ``extract_matrices`` at TMM_SPACING (75 tiles
   in one tracer step, timed on the card and on the CPU) are held
   against the same functions on a float64 CPU copy within TOL_TOOLS.
   Last, ``debug.bisect_segment`` on phase 6's earth model: ok on its
   restart, and on a copy with the thickest ice cell's hice set to NaN
   not ok, in phase "atm_ice substep 0".
11. torch.profiler, last but the options (a session taken after an
   earlier one and ~1e5
   eager launches records nothing on the card): `launches_per_call`,
   the device kernels one call of each checked wrapper launches (one for
   the apply); and,
   one replay of each step type at nt=2, in which each of the three
   kernels must run exactly once, with the device kernels per replayed
   step (profiled again, up to REPLAY_SESSIONS times, when the profiler
   lost a kernel's record; see check_replay_counts).  The sessions of
   the eager and the replayed earth segment and of the nt=41 mixing
   step, ~370,000, ~155,000 and ~138,000 recorded activities, went to
   pay for phase 13, and that of the nt=41 leapfrog step (~138,000) for
   phase 15 (the nt=41 graphs hold one launch of each kernel by the
   capture's counters, phase 5; the replayed segment's graph nodes are
   printed in phase 6).
12. The ocean options, after the profiler (the first profiler session
   taken after this phase recorded no device activity).  Three flagship
   models (``entry._flagship`` with
   OPTION_MODELS' options on top: 102x102x19, float32) that between
   them set every option of the reference's OceanModel but the rigid-lid
   surface pressure and the upstream and centered schemes: for each, the
   kernels its path runs held against their plain versions on the
   inputs of a leapfrog and a mixing step with phase 2's noise and
   tolerances (B1 only where the step takes the fused tracer step, B3
   only under full convection, and neither launched elsewhere; B2 on
   each distinct operator of the model, the 9-point, implicit-Coriolis
   and free-surface ones among them, compared after the step's own
   removal of the operator's null space, with its iterations from the
   captured guess and from zero); with Euler-backward mixing, one EB
   mixing step launching each kernel of the path twice, and `run` over
   a leapfrog and a mixing step launching it 3 (EB) or 2 times;
   run_scan over N_SCAN steps equal to the same steps taken eagerly,
   bitwise, each graph holding the path's launches of each kernel; one
   OPTION_RESTORING_DAYS segment of `run_restoring` replaying the same
   graphs; every field finite.  Then every option alone in the small form of phase 3
   (SMALL_OPTIONS, the rigid lid, upstream and centered among them):
   float32 on the card against float64 on the CPU within TOL_SMALL, and
   for SMALL_KERNEL_CHECKS the kernels held against their plain
   versions as above.
13. The rank-decomposed flagship (``uvic_tpu_torch.parallel``): eight
   ranks of a SHARDED_MESH mesh spawned on the one card (gloo; the
   halos and the gathers staged through the host, the transport
   printed), each building the full-width flagship and stepping its
   block through ``ShardedOceanStep`` (SHARDED_SCHEDULE: a forward and
   a leapfrog step from phase 2's perturbed state; three leapfrog steps
   until the earth part came to pay for).  The gathered
   state is held against the unsharded step on the same tracer path
   (the generic step) within TOL_SHARDED of each field's scale (the gap
   from the default fused step printed beside it); every rank's psi0,
   psi1, ptd and ptdb bitwise equal; every rank's launch counters: B3
   and B2 once a step, B1 never (the sharded core takes the generic
   tracer step, as the reference's does); B3 on rank 0's block and B2
   on rank 0's replicated solve (its last step's inputs) held against
   their plain versions at phase 2's tolerances; rank 0's step and
   message times, labelled as eight ranks sharing one card.  Then, in
   the same ranks, the rank-decomposed coupled segment
   (``parallel.shard_segment.ShardedCoupledModel``): each rank builds
   the full-width earth model from EARTH_RESTART (earth_config, float32,
   six islands) and runs one segment (8 atmosphere and 4 ocean steps),
   the ocean on its block, the atmosphere, ice and land replicated.
   The gathered state and time means are held against the unsharded
   eager segment on the generic tracer step within TOL_SHARDED_EARTH
   (the gap from the default segment with B1 printed beside it); every
   rank's whole components bitwise equal (one digest each); every
   rank's counters, set to 0 before the segment: B3 and B2 once an
   ocean step, B1 never; B3 on rank 0's block and B2 on rank 0's
   replicated solve (its last ocean step's inputs) against their plain
   versions; rank 0's segment and message times and peak allocated
   memory.  Then, in the same ranks, the three option models of phase
   12 (OPTION_MODELS at full width: walls, the full tensor, ppmix,
   shortwave, Neptune, the 9-point operator, the Fourier filter and
   Euler-backward mixing; dlm2 with the 3-D delimiter, Smagorinsky
   mixing, ncon and implicit Coriolis; the implicit free surface,
   QUICKER and biharmonic mixing), each through ``ShardedOceanStep``:
   SHARDED_OPTIONS_SCHEDULE, a mixing step (Euler-backward for the
   first) and a leapfrog step from phase 2's perturbed state.  The
   gathered state is held against the unsharded steps on the generic
   tracer step within TOL_SHARDED_OPTIONS (0; the gap from the default
   steps, with B1 where the model takes it, printed beside it); every
   rank's replicated fields (psi0, psi1, ptd, ptdb, ubar, ubarm1)
   bitwise equal; every rank's counters, set to 0 before each model: B2
   once a step pass (an Euler-backward mixing step takes two), B3 once
   a pass under full convection and never under ncon, B1 never; B3 on
   rank 0's block and B2 on rank 0's replicated solve (the
   streamfunction's or the free surface's, its last step's inputs)
   against their plain versions; rank 0's step and message times.  A
   failing or hung rank (SHARDED_TIMEOUT_S) fails the phase.
14. The repo's precision and closure tools on the card: the precision
   study (``uvic_tpu_torch.precision_study``: the 34x40x8 isopycnal/GM
   ocean, STUDY_STEPS leapfrog steps, physics and full MOBI), float32 on
   the card (the leapfrog steps replayed) against float64 on the CPU
   (computed by two worker processes started after phase 1), each drift
   key of each row held to PRECISION_FACTOR x the JAX package's float32
   figure for it (PRECISION_STUDY_JAX); then ``probes.segment_closure``
   on phase 6's earth model from EARTH_RESTART: one segment phase by
   phase with its forcing in hand and the replayed segment, each one's
   ocean heat closure held to the probe's float32 limit
   (``RESID_LIMIT_WM2``).
15. The multi-process bootstrap (``multihost_phase``): the (2, 3) mesh
   of ``uvic_tpu_torch.make_multihost_artifact`` on the card in float32,
   MULTIHOST_STEPS steps after the first, from a single launch (the
   mesh on six of the eight ranks phase 13's ``spawn`` started, run at
   the end of that phase) and from the artifact's two launchers
   (``python3 -m torch.distributed.run``, two of four ranks, one world
   of eight over TCP, gloo with host-staged CUDA tensors; ranks 6 and 7
   idle and must exit 0), the two held bitwise (the gathered state's
   digest and both checksums); B2 and B3 launched once a step on the
   mesh's rank 0 of each run by the wrappers' counters (B1 never: the
   sharded step takes the generic tracer step); B3 on rank 0's block
   (its last step's inputs, seeded noise on T and S) and B2 on its
   replicated solve against their plain versions; rank 0's step and
   message times.  Budget MULTIHOST_BUDGET_S.

The last two lines of standard output are a JSON line describing each
kernel (`launches` is phase 4's eager count; `launches_by_path` the
counts on each path by the wrappers' counters: over the eager steps,
and per replayed step type as captured in its graph, and a segment of
the earth path, eager and replayed, and over the year through Run each
graph's replays times the launches captured in it, and the same on the
earth carbon-cycle path, and on the paths of phases 9 and 10 (the
restoring segment eager, and replayed: a segment and the year, each
graph's counted replays times its captured launches); `nt41` the phase
2 readings on the MOBI inputs, `earth` the phase 6 readings on the earth
inputs, `earth_bgc` the phase 8 readings on the earth carbon cycle's
inputs, `earth_accel` the phase 9 readings on the accelerated inputs,
`earth_brine` the apply's on the brine path, `restoring` the phase 10
readings on the restoring step's inputs, `options` the phase 12
readings by option model, the CG's by operator, `sharded` and
`sharded_earth` the phase 13 readings on rank 0's flagship and earth
inputs (B3, B2), `sharded_options` those on rank 0's inputs of each
option model, and `launches_by_path`
the option models' launches a step, eager and per replayed step, and of
an Euler-backward mixing step, `sharded` each rank's launches over
phase 13's flagship steps, `sharded_earth_per_segment` over its
earth segment and `sharded_options_per_step` over each option model's
steps, by step pass, on every rank; `multihost_rank0_*` rank 0's
launches in phase 15's two runs; `multihost` the phase 15 readings on
rank 0's inputs) and the result line {"ok": true,
"device": {...}}.  Each phase's end prints its seconds (``phase N: ...
s``), and the line before the card's name all of them.

With --times the script builds the flagship and the full-MOBI flagship
and captures the kernels' inputs as in phase 2, then prints one JSON
line of the three wrappers' `ms`, `device_ms` and output digest (the
tracer step and the apply at nt=2 and at nt=41) and the CG's iteration
counts; equal digests mean bitwise equal outputs.  It uses only entry
points that every version of the port has, so a copy of this script run
from another checkout's root times that checkout's kernels: the way two
commits are compared on one card in one call.

With --golden-years N the script builds the kernels and runs N years of
the earth model from EARTH_RESTART through the port's Run (EARTH_RUN_TIME),
holds every tsi row against the golden stream's and prints each
column's largest relative gap by year against TOL_GOLDEN, the wall time
and the simulated years a day, then one JSON line of the same; it exits
1 when a column leaves its limit or nconv differs.  Its watchdog grows
by GOLDEN_YEAR_S a year.  With --golden-gaps TSI_CSV it prints the same
table for a tsi stream another run wrote from EARTH_RESTART (no card
needed: the JAX package's ``scripts/run_production.py --earth
--from-restart earth_accept/restart.npz`` in float32, for one).

With --precision-year DIR the script builds the kernels and runs the
float32 year of ``uvic_tpu_torch.precision_year`` (73 replayed segments
of ``earth_config()`` from ``init_state()``) on the card, writes its
stream and its divergence from PRECISION_F64 (the JAX package's float64
year) into DIR as ``tsi_year_f32_h100.json`` and
``divergence_h100.json``, and exits 1 when a key's max_rel exceeds
PRECISION_FACTOR x the JAX package's float32 max_rel of
PRECISION_JAX_DIVERGENCE; its watchdog is PRECISION_YEAR_S.
"""

import contextlib
import dataclasses
import faulthandler
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

WATCHDOG_S = 600
GOLDEN_YEAR_S = 75              # --golden-years: more watchdog a year
N_STEPS = 20
N_SCAN = 17                     # run_scan steps: nmix + 1, a mixing step
N_SCAN41 = 4                    # nt=41 run_scan steps from itt nmix - 2
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
# Relative (log-normal) noise on every bgc tracer of the nt=41 inputs, so
# that each tracer's increment is a sizeable fraction of its value and
# the tolerance below, relative to the increment, means the same for
# every tracer.
NOISE_BGC = 0.05

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
#   MOBI sources on the small grid (f32 card vs f64 CPU, one call of
#     the leapfrog instance on mobi_small_inputs): max |err| relative to
#     each tracer's largest |source|.  The same comparison on the CPU
#     (f32 vs f64 plain versions, printed by phase 5 beside the card's)
#     drifts 2.2e-4 at worst (diatn15, then diat, o2, the carbon
#     tracers): a source is (final - initial pool) / c2dtts, an increment
#     ~1e-3 of the pool, so f32 keeps ~4 digits of it.  The limit is ~10x
#     that.
TOL_TRACER = 3e-5
TOL_CONVECT = 1.5e-5
TOL_CG_TOLRSF = 10.0
# phase 12's solves: where 10 x the solver's tolerance is below what
# float32 resolves in the solution (the free surface: tolrfs 1e-4 on
# pressures ~5e4, whose ulp is ~4e-3), the limit is this share of the
# solution's largest magnitude, ~84 float32 ulps
TOL_CG_REL = 1e-5
TOL_SMALL = dict(t=1e-4, u=1e-4, psi0=1e-3)
TOL_MOBI_SRC_CPU_DRIFT = 2.2e-4
TOL_MOBI_SRC = 2e-3
REPLAY_SESSIONS = 3
H100_SMS = 132
# Shapes (nt, km, jmt, imt) on which the apply is also held against its
# plain version, on seeded random inputs: planes that are not a multiple
# of 4 (rows not 16-byte aligned) or of the tile's columns (a partial
# last tile), km from 1 to the kernel's 64, nt 1, 2, 8 and 9 (a ring of
# tiles exactly full, and wrapping once) and 41.
CONVECT_SHAPES = ((41, 19, 7, 13), (1, 1, 5, 7), (41, 1, 4, 9),
                  (41, 8, 9, 11), (2, 19, 10, 10), (1, 19, 6, 7),
                  (8, 19, 5, 9), (9, 8, 3, 11), (1, 64, 6, 10),
                  (41, 64, 3, 7))
CONVECT_SEED = 5
# The coupled earth segment (phases 6 and 7): the restart it starts from
# (year 1060, the first row of the golden tsi stream), the golden stream,
# the segments run eagerly and replayed, the bare replays timed, the year
# through Run, the segments of the split run, of the transient and of
# the anomalous-wind checks, and each golden column's limit, relative
# to the golden value: ~5x the largest gaps of the JAX
# package in float32 on a CPU over the same year (a_sat 6.1e-4, a_shum
# 4.2e-5, i_area 4.5e-3, i_vol 7.3e-4, o_ke 2.1e-5, o_psi_max 1.8e-4,
# o_psi_min 2.2e-4, o_sbar 1.4e-11, o_sst 3.5e-5, o_tbar 1.1e-5), two
# float32 machines' round-off; nconv must be equal.  The limits hold for
# the year the main path runs; over ten years the gaps of two float32
# runs grow past some of them from the eighth or ninth year on, the JAX
# package's own on a CPU too (--golden-years, --golden-gaps; PERF.md).
EARTH_RESTART = "earth_accept/restart.npz"
EARTH_GOLDEN = "golden/regression/tsi_10yr_earth_r5.csv"
EARTH_SEGMENTS = 2
EARTH_BARE = 2
EARTH_YEAR = 72
EARTH_SPLIT = 2
EARTH_TRANSIENT = 2
EARTH_AWIND = 2
# the output intervals of the run that wrote the golden stream
# (scripts/run_production.py's defaults) [days]
EARTH_RUN_TIME = dict(tsiint=10.0, timavgint=360.0, restint=360.0)
# the tavg stream's variables: the reference's run10/tavg.nc holds these,
# the 49 time means of the earth segment and the 4 coordinates
TAVG_VARIABLES = (
    "adv_fb_temp", "adv_fe_temp", "adv_fn_temp", "aice", "convect_depth",
    "convect_nreg", "cs", "depth", "dif_fb_temp", "dif_fe_temp",
    "dif_fn_temp", "diff_cbt_eff", "evap", "hflx", "hice", "hsno",
    "latitude", "longitude", "lying_snow", "m_soil", "nep", "olr", "precip",
    "psi", "psno", "rho", "runoff", "salt", "sat", "sflx", "shum", "soilm",
    "swr", "taux", "tauy", "temp", "tice", "time", "toa_sw", "tsoil", "u",
    "uice", "upltnt", "uplwr", "upsens", "v", "veg_frac", "vetiso", "vice",
    "vntiso", "w", "wbtiso", "wspd")
TOL_GOLDEN = dict(a_sat=3e-3, a_shum=2e-4, i_area=2.5e-2, i_vol=4e-3,
                  o_ke=1e-4, o_psi_max=1e-3, o_psi_min=1e-3, o_sbar=1e-6,
                  o_sst=2e-4, o_tbar=1e-4)
# The earth carbon cycle (phase 8): the configuration of
# golden/regression/bgc_earth_month.py (earth_config() with mobi_full(),
# 41 tracers, pore-water sediments, year0 EARTH_BGC_YEAR0 and
# set_transient_forcing(), from init_state()), in float32; the segments
# run eagerly and replayed, the month through Run (tsi every 5 days, the
# time means and a restart at its end), the reference rows of that month
# (float64, each quantity's tolerance 5x the JAX package's own
# float32-float64 gap, at least 1e-6; written by the generator into the
# JSON), the tracers whose surface flux and bottom flux the kernel checks
# require non-zero.
EARTH_BGC_YEAR0 = 1990
# one segment eager against its replay and one more replay timed (two
# eager segments went to pay for phase 13's option models)
EARTH_BGC_SEGMENTS = 1
EARTH_BGC_MONTH = 6
EARTH_BGC_RUN_TIME = dict(tsiint=5.0, timavgint=30.0, restint=30.0)
EARTH_BGC_GOLDEN = "golden/regression/bgc_earth_month.json"
EARTH_BGC_GAS = ("dic", "o2", "c14", "cfc11", "cfc12")
EARTH_BGC_BOTTOM = ("dic", "alk")
# The spin-up and the coupled options (phase 9): the deep acceleration of
# the spin-up (accel.h dtxcel at the bottom level), the golden row of
# its year (golden/regression/spinup_earth_year.py: the JAX package's
# float64 row, each key's limit 5x its largest gap over five float32
# runs, four from a restart moved by round-off, at least one unit of
# the key's rounding), the segments each option runs eagerly and
# replayed, the bare replays timed at acceleration, the options with the
# changes they make to earth_config(), and the multi-category ice run of
# golden/regression/cpts_small_segments.py (the port's float32 on the
# card against its float64 on the CPU, each field within 5x the JAX
# package's own float32 gap on the same run).
ACCEL = 4.0
SPINUP_START = "earth_accept"
SPINUP_GOLDEN = "golden/regression/spinup_earth_year.json"
# one segment each, one bare replay (two went to pay for phase 13's
# option models)
EARTH_ACCEL_SEGMENTS = 1
EARTH_OPTION_SEGMENTS = 1
EARTH_OPTION_BARE = 1
EARTH_OPTIONS = {
    "cpts": ("ice", dict(cpts=3)),
    "convect_brine": ("ocean", dict(convect_brine=True)),
    "no_ice": ("ice", dict(enabled=False)),
    "no_evp": ("ice", dict(evp=False)),
    "freedrift": ("ice", dict(ice_ocn_stress="freedrift")),
}
BRINE_CONVECTIONS = 3           # convct_full calls a brine ocean step
CPTS_GOLDEN = "golden/regression/cpts_small_segments.json"
# The barotropic solve's fields of that run are held unless a float32
# solve took another number of CG trips than float64's.  The run's CG
# tolerance (tolrsf 1e8 on a psi of ~3.7e12) leaves some solves at the
# edge of the stop: float64's first trip moves psi by 0.992 tolrsf at
# the fifth ocean step and by 0.975 at the tenth, so a 1% gap of
# round-off decides between one trip and ~30 (the port's float32 run
# on a CPU: 1.001, then 29 trips; the JAX package's: 0.983, one trip),
# and the fields then differ by up to the solve's tolerance
# (golden/regression/cpts_small_segments.py --trips).
CPTS_BAROTROPIC = ("ocean/psi0", "ocean/psi1", "ocean/ptd", "ocean/ptdb")
# The ocean-only restoring run (phase 10): the flagship from
# entry._flagship() restored toward the seasonal climatology of
# io/timeforce.py (OceanModel.run_restoring): RESTORING_SEGMENTS segments
# of RESTORING_SEG_DAYS days (24 ocean steps each at dtts 108,000 s), the
# reference rows of that year (golden/regression/restoring_year.py: the
# JAX package's float64 rows, each key's limit 5x its largest gap over
# five float32 runs, four from a state moved by one float32 ulp, at
# least the key's floor there), the warmer climatology that shows the
# graphs read each segment's fluxes, and the tooling's checks on the
# year's final state against a float64 CPU copy: the spacing of the
# transport-matrix tiles (100 physical columns, a multiple of 5; 75
# tiles) and each check's limit on max |card - float64|, relative to the
# largest magnitude of the field reduced or sampled (regions, stations,
# zonal means, sections) or of the float64 matrices (tmm): float32
# round-off over the few dozen operations of a tracer step, an invtri or
# a reduction is ~1e-6 of it; sections are gathers of the same values,
# exact.
RESTORING_SEGMENTS = 12
RESTORING_SEG_DAYS = 30.0
RESTORING_YRLEN = 365.0
RESTORING_GOLDEN = "golden/regression/restoring_year.json"
RESTORING_WARMER = 1.0          # K added to the climatology's SST
TMM_SPACING = (3, 5, 5)
TOL_TOOLS = dict(regions=1e-5, xbt=1e-5, section=0.0, zonal=1e-5,
                 tmm_exp=1e-5, tmm_imp=1e-5)
# The ocean options (phase 12): three flagship models (102x102x19,
# float32, entry._flagship with options on top) that between them set
# every option the reference's OceanModel takes but the surface-pressure
# rigid lid and the upstream and centered schemes, which run in the
# small form of phase 3 with every other option.  Expected launches of
# each kernel a step follow from each model's routing (B1 only where the
# reference takes its fused kernel, B3 only under full convection).
OPTION_MODELS = {
    # B1 with walls and the full tensor's Redi tendency as its source,
    # B3, B2 on the 9-point operator; Euler-backward mixing steps
    "walls_fulltensor_eb": dict(
        ocean=dict(vmix="ppmix", shortwave=True, neptune=True, sf_npt=9,
                   hlat_filter="fourier", eb=True, full_tensor=True),
        grid=dict(cyclic=False)),
    # the generic tracer step, ncon convection, B2 on the implicit
    # Coriolis operators
    "dlm2_fct3d_smagnl_ncon_acor": dict(
        ocean=dict(fct_variant="dlm2", fct_3d=True, hmix="smagnl",
                   convection="ncon", acor=0.5)),
    # B2 on the free surface's operators (no islands), B3
    "ifs_quicker_biharmonic": dict(
        ocean=dict(barotropic="implicit_free_surface",
                   tracer_advection="quicker", hmix="biharmonic")),
}
OPTION_RESTORING_DAYS = 2.5     # a run_restoring segment of each model
SMALL_OPTIONS = {
    "quicker": dict(tracer_advection="quicker"),
    "centered": dict(tracer_advection="centered"),
    "upstream": dict(tracer_advection="upstream"),
    "dlm2": dict(fct_variant="dlm2"),
    "fct_3d": dict(fct_3d=True),
    "smagnl": dict(hmix="smagnl"),
    "biharmonic": dict(hmix="biharmonic", ambi=1.0e21, ahbi=5.0e20),
    "ppmix": dict(vmix="ppmix"),
    "ncon": dict(convection="ncon"),
    "surface_pressure": dict(barotropic="surface_pressure"),
    "implicit_free_surface": dict(barotropic="implicit_free_surface"),
    "sf_npt_9": dict(sf_npt=9),
    "acor": dict(acor=0.5),
    "fourier": dict(hlat_filter="fourier"),
    "shortwave": dict(shortwave=True),
    "neptune": dict(neptune=True),
    "full_tensor": dict(full_tensor=True),
    "eb": dict(eb=True),
    "walls": dict(),
}
SMALL_GRID = {"walls": dict(cyclic=False)}
# small-form options whose kernels are also held against their plain
# versions on the card (the rigid lid's B2 runs at full width nowhere)
SMALL_KERNEL_CHECKS = ("surface_pressure",)
# The rank-decomposed flagship (phase 13): eight gloo ranks of a (2, 4)
# mesh share the card, their halos staged through the host; a forward and
# a leapfrog step from the perturbed flagship state, the gathered
# state held against the unsharded step on the same tracer path (the
# generic step) within TOL_SHARDED of each field's largest magnitude.
SHARDED_MESH = (2, 4)
SHARDED_SCHEDULE = (False, True)
SHARDED_TIMEOUT_S = 240
# The gap measured on the card was 0 in every field (bitwise: the same
# arithmetic on each cell, island sums in a fixed order), so the limit
# is 0; before the island sums' repair the ranks' preconditioners parted
# by round-off and the gaps read 1e-7 (t, u) to 6e-6 (ptd).
TOL_SHARDED = dict(t=0.0, tm1=0.0, u=0.0, um1=0.0, psi0=0.0, psi1=0.0,
                   ptd=0.0, ptdb=0.0)
# The rank-decomposed option models (phase 13's third part): in the same
# ranks, each of OPTION_MODELS at full width through ShardedOceanStep, a
# mixing step (Euler-backward where the model sets it) and a leapfrog
# step from phase 2's perturbed state; the gathered state held against
# the unsharded step on the generic tracer step within
# TOL_SHARDED_OPTIONS of each field's largest magnitude.  The limit is
# the flagship's and the earth segment's: the same arithmetic cell by
# cell (the padded block holds what the whole field's rolls read, and
# setbcx acts on it as on the whole field) and the barotropic solves
# replicated, so any gap is a fault to find, not round-off.
SHARDED_OPTIONS_SCHEDULE = (False, True)
TOL_SHARDED_OPTIONS = 0.0
# The rank-decomposed earth segment (phase 13's second part): in the same
# ranks, one ShardedCoupledModel segment of the earth model from
# EARTH_RESTART, the gathered state and time means held against the
# unsharded eager segment on the same tracer path (the generic step)
# within TOL_SHARDED_EARTH of each field's largest magnitude: the same
# arithmetic on each cell, the 2-D components replicated.
TOL_SHARDED_EARTH = 0.0
# The precision tools (phase 14, --precision-year).  The JAX package's
# float32 drift from float64 of scripts/precision_study.py, by row (step)
# and key, as ``python3 scripts/precision_study.py 40 [--mobi]`` printed
# it on one CPU (JAX 0.9.0; both dtypes on the CPU); the card's float32
# against the CPU's float64 is held to PRECISION_FACTOR x each figure
# (the golden limits' rule, golden/regression/spinup_earth_year.json).
# Phase 15: make_multihost_artifact's (2, 3) mesh on the card, its step
# count and the phase's budget
MULTIHOST_STEPS = 2
MULTIHOST_BUDGET_S = 45
STUDY_STEPS = 40
PRECISION_FACTOR = 5.0
_STUDY_PHYSICS = {
    10: dict(temp_max_err=7.084623430131387e-06,
             temp_rel=3.915154556842178e-07, salt_max_err=0.0,
             u_rel=4.7082876273621155e-06, psi_rel=7.901522887551306e-06),
    20: dict(temp_max_err=1.4309315879756923e-05,
             temp_rel=7.908254262108267e-07, salt_max_err=0.0,
             u_rel=7.379175860786101e-06, psi_rel=7.236774014812587e-06),
    40: dict(temp_max_err=3.191840118432765e-05,
             temp_rel=1.7642563852380335e-06, salt_max_err=0.0,
             u_rel=2.190020277640082e-05, psi_rel=8.455407182830116e-06)}
PRECISION_STUDY_JAX = {
    False: _STUDY_PHYSICS,
    True: {
        10: dict(_STUDY_PHYSICS[10], dic_rel=9.093562490140788e-07,
                 o2_rel=4.6715195748105116e-06, po4_rel=6.19019707453427e-06,
                 no3_rel=9.729841682722811e-06),
        20: dict(_STUDY_PHYSICS[20], dic_rel=1.6294989130774694e-06,
                 o2_rel=6.919698837975904e-06, po4_rel=7.79151933339087e-06,
                 no3_rel=1.2432878893657705e-05),
        40: dict(_STUDY_PHYSICS[40], dic_rel=2.627772693564266e-06,
                 o2_rel=9.45175879842734e-06, po4_rel=5.573025596407381e-06,
                 no3_rel=9.019466253947543e-06)}}
STUDY_WORKER_THREADS = 2
STUDY_WORKER_TIMEOUT_S = 300
# --precision-year: the JAX package's float64 year as it computes it now
# (``scripts/precision_year.py run float64``; golden/precision/
# tsi_year_f64.json predates the earth configuration's last changes and
# sits 2.7e-3 from it in sat_gm at the first segment), and the limits'
# float32 divergence
PRECISION_F64 = "golden/precision_torch/tsi_year_f64_jax.json"
PRECISION_F64_OLD = "golden/precision/tsi_year_f64.json"
PRECISION_JAX_DIVERGENCE = "golden/precision/divergence.json"
PRECISION_YEAR_S = 900
KERNEL_NAMES = {"fct_tracer_step": "fct_tracer_kernel",
                "apply_region_means": "region_means_kernel",
                "congrad": "congrad_cluster_kernel"}


def bgc_weights(grid, tmask, area2d):
    """(cell volumes of the ocean without the cyclic columns, the ocean
    surface areas, the ocean cells) for ``bgc_row``, NumPy float64, from
    either package's grid, T mask and ``CoupledModel.area2d``."""
    import numpy as np
    dvol = (np.asarray(grid.dzt)[:, None, None]
            * np.asarray(grid.cst)[None, :, None]
            * np.asarray(grid.dyt)[None, :, None]
            * np.asarray(grid.dxt)[None, None, :]) * np.asarray(tmask)
    dvol[:, :, 0] = 0.0
    dvol[:, :, -1] = 0.0
    area = np.asarray(area2d, np.float64)
    return dvol, area, area > 0


def bgc_row(weights, names, t, stf, btf, sed, nconv):
    """One segment's row of the carbon-cycle month (NumPy float64): each
    tracer's volume and surface mean (``vol/``, ``surf/``), the area
    integral of its surface flux (``stf/``) and of the bottom flux of dic
    and alk (``btf/``), each integral's scale, the integral of the flux's
    magnitude (``stf_abs/``, ``btf_abs/``), the means of the sediments'
    calgg, orggg (all levels) and zrct over the ocean cells (``sed/``),
    and nconv."""
    import numpy as np
    dvol, area, wet = weights
    t, stf, btf = (np.asarray(x, np.float64) for x in (t, stf, btf))
    row = {"nconv": int(nconv)}
    for n, name in enumerate(names):
        row["vol/" + name] = float((t[n] * dvol).sum() / dvol.sum())
        row["surf/" + name] = float((t[n, 0] * area).sum() / area.sum())
        row["stf/" + name] = float((stf[n] * area).sum())
        row["stf_abs/" + name] = float((np.abs(stf[n]) * area).sum())
    for name in ("dic", "alk"):
        n = names.index(name)
        row["btf/" + name] = float((btf[n] * area).sum())
        row["btf_abs/" + name] = float((np.abs(btf[n]) * area).sum())
    for name in ("calgg", "orggg", "zrct"):
        v = np.asarray(sed[name], np.float64)
        row["sed/" + name] = float(v[..., wet].mean())
    return row


def port_bgc_row(m, weights, names, state):
    """``bgc_row`` of a port model's state after a segment and of the
    forcing that segment's ocean steps took."""
    sed = {k: getattr(state.sed, k).double().cpu().numpy()
           for k in ("calgg", "orggg", "zrct")}
    return bgc_row(weights, names, state.ocean.t.double().cpu().numpy(),
                   m.last_forcing["stf"].double().cpu().numpy(),
                   m.last_forcing["btf"].double().cpu().numpy(), sed,
                   state.ocean.nconv)


def restoring_weights(grid, tmask):
    """(ocean cell volumes, ocean surface areas), both without the
    cyclic columns, for ``restoring_row``, NumPy float64, from either
    package's grid and T mask."""
    import numpy as np
    tmask = np.asarray(tmask, np.float64)
    area = (np.asarray(grid.cst)[:, None] * np.asarray(grid.dyt)[:, None]
            * np.asarray(grid.dxt)[None, :])
    area[:, 0] = 0.0
    area[:, -1] = 0.0
    return np.asarray(grid.dzt)[:, None, None] * area[None] * tmask, \
        area * tmask[0]


def restoring_row(weights, t, psi0, clim_sst, clim_sss, cg_iters, nconv):
    """One segment's row of the restoring year (NumPy float64): the
    area-mean SST and SSS [degC, psu], the area-mean absolute gap of each
    to the climatology at the segment's midpoint, the volume-mean T and S,
    the streamfunction's max and min [Sv], the mean CG iterations of the
    segment's steps, and nconv."""
    import numpy as np
    dvol, area = weights
    t, psi0, clim_sst, clim_sss = (np.asarray(x, np.float64) for x in (
        t, psi0, clim_sst, clim_sss))

    def amean(x):
        return float((x * area).sum() / area.sum())

    def vmean(x):
        return float((x * dvol).sum() / dvol.sum())

    return dict(
        sst=amean(t[0, 0]), sss=amean(t[1, 0]) * 1000.0 + 35.0,
        sst_gap=amean(np.abs(t[0, 0] - clim_sst)),
        sss_gap=amean(np.abs(t[1, 0] - clim_sss)) * 1000.0,
        tbar=vmean(t[0]), sbar=vmean(t[1]) * 1000.0 + 35.0,
        psi_max=float(psi0.max()) / 1e12, psi_min=float(psi0.min()) / 1e12,
        cg_iters=float(np.mean(np.asarray(cg_iters, np.float64))),
        nconv=int(nconv))


def restoring_gaps(rows, golden):
    """Each key's largest share of its limit over ``rows`` against the
    reference year ``golden`` (the JSON, a limit of each key for each
    segment) as {key: (share, gap, segment)}, and the (segment, key, gap,
    limit) out of limits, nconv unequal among them."""
    worst, failed = {}, []
    for n, (row, ref, limits) in enumerate(zip(rows, golden["rows"],
                                                golden["limit"])):
        if row["nconv"] != ref["nconv"]:
            failed.append((n + 1, "nconv", row["nconv"], ref["nconv"]))
        for key, limit in limits.items():
            gap = abs(row[key] - ref[key])
            if gap / limit > worst.get(key, (-1.0,))[0]:
                worst[key] = (gap / limit, gap, n + 1)
            if not gap <= limit:
                failed.append((n + 1, key, gap, limit))
    if len(rows) != len(golden["rows"]):
        failed.append((len(rows), "rows", len(rows), len(golden["rows"])))
    return worst, failed


def restoring_year_rows(m, state, smf, sst, sss, row, sync=None):
    """The restoring year of phase 10 and of its reference
    (``golden/regression/restoring_year.py``): RESTORING_SEGMENTS calls
    of ``m.run_restoring`` (either package's model) with one segment each
    and ``relyr0`` accumulated as ``run_restoring`` accumulates it.
    ``row(state, mid)`` is a segment's row from the state after it and
    the segment's midpoint; ``sync(state)`` waits for the device before
    a segment (state None) and after it.  Returns (rows, seconds of each
    segment, the final state, relyr after the year)."""
    rows, seg_s, relyr = [], [], 0.0
    seg = RESTORING_SEG_DAYS / RESTORING_YRLEN
    for _ in range(RESTORING_SEGMENTS):
        mid = relyr + 0.5 * seg
        if sync is not None:
            sync(None)
        t0 = time.perf_counter()
        state = m.run_restoring(state, smf, sst, sss, nseg=1,
                                seg_days=RESTORING_SEG_DAYS, relyr0=relyr,
                                yrlen=RESTORING_YRLEN)
        if sync is not None:
            sync(state)
        seg_s.append(time.perf_counter() - t0)
        rows.append(row(state, mid))
        relyr += seg
    return rows, seg_s, state, relyr


def bgc_month_gaps(rows, golden):
    """The quantity of each kind nearest its limit over ``rows`` against
    the reference month ``golden`` (the JSON), as (gap / limit, gap, key,
    segment, limit), and the (segment, key, gap, limit) out of limits,
    nconv unequal among them."""
    worst, failed = {}, []
    for n, (row, ref) in enumerate(zip(rows, golden["rows"])):
        if row["nconv"] != ref["nconv"]:
            failed.append((n + 1, "nconv", row["nconv"], ref["nconv"]))
        for key, lim in golden["tolerance"].items():
            gap = bgc_gap(key, row[key], ref)
            kind = key.split("/")[0]
            if gap / lim > worst.get(kind, (-1.0,))[0]:
                worst[kind] = (gap / lim, gap, key, n + 1, lim)
            if not gap <= lim:
                failed.append((n + 1, key, gap, lim))
    if len(rows) != len(golden["rows"]):
        failed.append((len(rows), "rows", len(rows), len(golden["rows"])))
    return worst, failed


def bgc_gap(key, got, ref_row):
    """The gap of ``got`` against the reference row's value at ``key``:
    relative to the value, for a flux integral relative to the integral
    of the flux's magnitude, absolute where that scale is 0."""
    kind, name = key.split("/")
    scale = (ref_row[f"{kind}_abs/{name}"] if kind in ("stf", "btf")
             else abs(ref_row[key]))
    diff = abs(got - ref_row[key])
    return diff / scale if scale > 0 else diff


def say(*args):
    print(*args, flush=True)


def clocks_line():
    """The card's SM clock, power draw and temperature (nvidia-smi)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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
    cst = np.asarray(m.params.grid.cst)[:, None]
    noise = np.stack([NOISE_T * rng.standard_normal(shape),
                      NOISE_S * rng.standard_normal(shape)]) * cst
    d = torch.as_tensor(noise, dtype=state.t.dtype,
                        device=state.t.device) * m.tmask
    d = setbcx(d, m.cyclic)
    t, tm1 = state.t.clone(), state.tm1.clone()
    t[:2] += d
    tm1[:2] += d
    nbgc = state.t.shape[0] - 2
    if nbgc > 0:
        f = np.exp(NOISE_BGC * rng.standard_normal((nbgc,) + shape) * cst)
        f = setbcx(torch.as_tensor(f, dtype=t.dtype, device=t.device),
                   m.cyclic)
        t[2:] *= f
        tm1[2:] *= f
    return dataclasses.replace(state, t=t, tm1=tm1)


def capture_step(m, state, forcing):
    """One leapfrog step of the model with the arguments each kernel
    wrapper receives recorded: the last convection's in ``convect``, and
    every convection's in ``convect_calls`` (three on the brine path,
    whose ``convct_brine`` calls ``convct_full`` in ops/convection.py)."""
    import uvic_tpu_torch.models.ocean.model as model_mod
    import uvic_tpu_torch.ops.convection as conv_mod
    seen = {"convect_calls": []}
    tracer, convect, solver = (model_mod.fct_tracer_step,
                               model_mod.convct_full, m.cg_solver)

    def rec_tracer(*a, **k):
        seen["tracer"] = (a, k)
        return tracer(*a, **k)

    def rec_convect(*a):
        seen["convect"] = a
        seen["convect_calls"].append(a)
        return convect(*a)

    def rec_solver(*a):
        seen["cg"] = a
        return solver(*a)

    model_mod.fct_tracer_step = rec_tracer
    model_mod.convct_full = rec_convect
    conv_mod.convct_full = rec_convect
    m.cg_solver = rec_solver
    try:
        state = m.step(state, forcing, leapfrog=True)
    finally:
        model_mod.fct_tracer_step = tracer
        model_mod.convct_full = convect
        conv_mod.convct_full = convect
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


def say_kernel(label, k):
    """One kernel check's times, bound and error on one line."""
    lib = ("" if k["library_ms"] is None
           else f", library {k['library_ms']:.4f} ms")
    say(f"  {k['name']} {label}: {k['ms']:.4f} ms one call between "
        f"events (device time {k['device_ms']:.4f} ms; plain "
        f"{k['plain_ms']:.4f} ms{lib}; bound {k['bound_ms']:.4f} ms by "
        f"{k['bound_by']}, {k['bytes']} bytes; max abs err "
        f"{k['max_abs_err']:.3e})")


def say_errors(errs, tol):
    """Print each tracer's (err, rel, inc), or the three worst and a
    summary when there are many; return the worst rel and err."""
    order = sorted(range(len(errs)), key=lambda n: -errs[n][1])
    shown = order if len(errs) <= 2 else order[:3]
    for n in shown:
        err, rel, inc = errs[n]
        say(f"  tracer {n}: max abs err {err:.3e}, max increment {inc:.3e},"
            f" err / increment {rel:.3e} (tolerance {tol})")
    if len(errs) > len(shown):
        say(f"  ({len(errs)} tracers, the {len(shown)} worst shown)")
    return max(e[1] for e in errs), max(e[0] for e in errs)


def check_tracer(m, seen, label="fct_tracer_step", consts=None):
    """The tracer step against its plain version on captured inputs;
    ``consts`` replaces the captured step's constants (and drops the
    isopycnal weight stack) for another form of the step."""
    import torch
    from uvic_tpu_torch.ops.tracer_kernel import (blocks_per_sm,
                                                  fct_tracer_step,
                                                  fct_tracer_step_ref,
                                                  tracer_launch)
    args, kw = seen["tracer"]
    if consts is not None:
        args, kw = (consts,) + tuple(args[1:]), dict(kw, isow=None)
    got = fct_tracer_step(*args, **kw)
    ref = fct_tracer_step_ref(*args, **kw)
    torch.cuda.synchronize()
    tm1 = args[2]
    worst, worst_abs = say_errors(
        [inc_err(got[n], ref[n], tm1[n]) for n in range(got.shape[0])],
        TOL_TRACER)
    if not worst <= TOL_TRACER:
        raise AssertionError(f"{label}: err / increment {worst} > "
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
    consts, t_tau, tm1, vet, vnt, vbt, dcb, stf, btf, src, twodt, tmask, \
        kmt = args
    isow = kw.get("isow")
    nt, km, jmt, imt = t_tau.shape
    blocks, threads, smem = tracer_launch(nt, km, jmt, imt)
    say(f"  one launch: {blocks} blocks of {threads} threads, {smem} bytes "
        f"of shared memory each, {blocks_per_sm(km, imt)} blocks per SM")
    say(f"  device time {dev_ms:.4f} ms with the inputs in L2, "
        f"{cold_ms:.4f} ms with L2 flushed before each launch; plain "
        f"version {plain_dev_ms:.4f} ms")
    vol, plane = km * jmt * imt, jmt * imt
    nbytes = 4 * (3 * nt * vol + 5 * vol + 2 * nt * plane
                  + (nt * vol if src is not None else 0)
                  + (18 * vol if isow is not None else 0)
                  + 6 * km + 7 * plane)
    # ~400 flops per tracer cell, counted from csrc/tracer_step.cu
    b_ms, b_by = bound(nbytes, 400.0 * nt * vol)
    return dict(name="fct_tracer_step", max_abs_err=worst_abs, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, bytes=nbytes, device_ms=dev_ms,
                plain_device_ms=plain_dev_ms, cold_device_ms=cold_ms,
                per_call_fn=kernel)


def convect_inputs(seen):
    """(ts, mnorm, ocean, kmt): the apply's arguments in a captured step."""
    import torch
    from uvic_tpu_torch.ops.convection import region_mixing_matrix
    ts, kmt, eos_c, eos_to, eos_so, dztxcl = seen["convect"]
    ts = ts.contiguous()              # as convct_full passes it
    km = ts.shape[1]
    mnorm = region_mixing_matrix(ts, kmt, eos_c, eos_to, eos_so,
                                 dztxcl).contiguous()
    idx = torch.arange(km, device=ts.device).reshape(km, 1, 1)
    ocean = torch.broadcast_to((idx < kmt[None]).to(ts.dtype),
                               ts.shape[1:]).contiguous()
    return ts, mnorm, ocean, kmt


def check_convect(seen):
    import torch
    from uvic_tpu_torch.ops.convection import (apply_region_means,
                                               apply_region_means_ref,
                                               region_means_blocks_per_sm,
                                               region_means_launch)
    ts, mnorm, ocean, kmt = convect_inputs(seen)
    km = ts.shape[1]
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
    worst, worst_abs = say_errors(
        [inc_err(got[n], ref[n], ts[n]) for n in range(got.shape[0])],
        TOL_CONVECT)
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
    scratch = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    cold_ms = device_ms(kernel, flush=lambda: scratch.fill_(1.0))
    plain_ms = cuda_time_ms(plain)
    library_ms = cuda_time_ms(library)
    plain_dev_ms, library_dev_ms = device_ms(plain), device_ms(library)
    nt, km, jmt, imt = ts.shape
    blocks, cols, slots, smem = region_means_launch(nt, km, jmt, imt)
    per_sm = region_means_blocks_per_sm(nt, km, cols)
    say(f"  one launch: {blocks} blocks of {cols} x {km} threads, a ring of "
        f"{slots} tracer tiles, {smem} bytes of shared memory each; "
        f"{per_sm} blocks per SM, {blocks / (per_sm * H100_SMS):.2f} waves")
    say(f"  device time {dev_ms:.4f} ms with the inputs in L2, "
        f"{cold_ms:.4f} ms with L2 flushed before each launch; plain "
        f"version {plain_dev_ms:.4f} ms, library call {library_dev_ms:.4f} "
        "ms")
    vol = km * jmt * imt
    nbytes = 4 * (2 * nt * vol + km * vol + vol)
    b_ms, b_by = bound(nbytes, 2.0 * km * nt * vol)
    return dict(name="apply_region_means", max_abs_err=worst_abs, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms, bytes=nbytes, device_ms=dev_ms,
                plain_device_ms=plain_dev_ms,
                library_device_ms=library_dev_ms, cold_device_ms=cold_ms,
                blocks_per_sm=per_sm, per_call_fn=kernel)


def random_convect_inputs(rng, nt, km, jmt, imt):
    """(ts, mnorm, ocean) on the card from a NumPy generator: T-like
    tracers, a random mixing matrix, a random depth per column."""
    import numpy as np
    import torch
    shape = (km, jmt, imt)
    kmt = rng.integers(0, km + 1, size=(jmt, imt))
    ocean = (np.arange(km)[:, None, None] < kmt[None]).astype(np.float64)
    return [torch.as_tensor(x, dtype=torch.float32, device="cuda")
            for x in (15.0 + 5.0 * rng.standard_normal((nt,) + shape),
                      rng.uniform(0.0, 2.0 / km, (km,) + shape), ocean)]


def check_convect_shapes():
    """The apply against its plain version on seeded random inputs at the
    CONVECT_SHAPES, and its refusal of more levels than it takes."""
    import numpy as np
    import torch
    from uvic_tpu_torch.ops.convection import (MAX_KM, apply_region_means,
                                               apply_region_means_ref,
                                               region_means_launch)
    rng = np.random.default_rng(CONVECT_SEED)
    for nt, km, jmt, imt in CONVECT_SHAPES:
        args = random_convect_inputs(rng, nt, km, jmt, imt)
        got = apply_region_means(*args)
        ref = apply_region_means_ref(*args)
        torch.cuda.synchronize()
        err, rel, _ = max((inc_err(got[n], ref[n], args[0][n])
                           for n in range(nt)), key=lambda e: e[1])
        _, cols, slots, _ = region_means_launch(nt, km, jmt, imt)
        plane = jmt * imt
        say(f"  nt {nt}, km {km}, {jmt}x{imt} (plane {plane}: {cols}-column "
            f"tiles, the last {plane - (plane - 1) // cols * cols} wide; "
            f"{slots} slot(s)): max abs err {err:.3e}, err / increment "
            f"{rel:.3e}")
        if not rel <= TOL_CONVECT:
            raise AssertionError(f"convection at {(nt, km, jmt, imt)}: err / "
                                 f"increment {rel} > {TOL_CONVECT}")
    ts = torch.zeros((1, MAX_KM + 1, 2, 2), device="cuda")
    try:
        apply_region_means(ts, torch.zeros((MAX_KM + 1,) + ts.shape[1:],
                                           device="cuda"), ts[0])
    except ValueError as e:
        say(f"  km {MAX_KM + 1} refused: {e}")
    else:
        raise AssertionError(f"convection: km {MAX_KM + 1} was not refused")


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
            out[case]["per_call_fn"] = kernel
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


def small_reference(ocean=None, grid=None, label="", models=None):
    """Flagship physics on a small grid, with the options ``ocean`` and
    ``grid`` on top: card f32 vs CPU f64, 4 steps (a mixing step and 3
    leapfrog steps).  ``models`` (a dict) receives the two models."""
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
            gthflx=True, aniso_visc=True, aniso_zonal=True, **(ocean or {})))
        if grid:
            cfg = cfg.replace(grid=dataclasses.replace(cfg.grid, **grid))
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
        if models is not None:
            models[device] = (m, s, f)
    tols = dict(TOL_SMALL)
    if m.sp_mode:
        tols["ubar"] = TOL_SMALL["psi0"]    # the external mode's velocity
    rels = {}
    for name, tol in tols.items():
        a, b = out["cuda"][name], out["cpu"][name]
        rel = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
        rels[name] = rel
        if not label:
            say(f"  {name}: rel err {rel:.3e} (tolerance {tol})")
        if not (np.isfinite(a).all() and rel <= tol):
            raise AssertionError(f"small reference {label}: {name} rel err "
                                 f"{rel} > {tol}")
    if label:
        say(f"  {label}: rel err " + ", ".join(
            f"{k} {v:.3e}" for k, v in rels.items()) + " (tolerances "
            + ", ".join(f"{k} {v:g}" for k, v in tols.items()) + ")")
    return rels


def mobi_small_inputs(m):
    """A healthy MOBI state on the model's grid (registry values, a
    thermocline, 5% of log-normal noise) and seeded light and ice fields,
    as NumPy arrays."""
    import numpy as np
    g = m.params.grid
    idx = m.tracer_index
    rng = np.random.default_rng(2)
    shape = (g.km, g.jmt, g.imt)
    t = np.empty((m.nt,) + shape)
    for i, tr in enumerate(idx.tracers):
        t[i] = tr.init * np.exp(0.05 * rng.standard_normal(shape))
    t[idx.itemp] = (2.0 + 20.0 * np.exp(-np.asarray(g.zt) / 800e2)
                    )[:, None, None] + 0.5 * rng.standard_normal(shape)
    t[idx.isalt] = 1e-4 * rng.standard_normal(shape)
    t *= np.asarray(m.params.topo.tmask)
    plane = (g.jmt, g.imt)
    swr = 2.0e5 * (1.0 + 0.2 * rng.standard_normal(plane))
    aice = rng.uniform(0.0, 1.0, plane) * (rng.uniform(size=plane) < 0.3)
    return t, swr, aice, 100.0 * aice, 20.0 * aice


def mobi_small_sources(device, dtype):
    """The leapfrog instance's MOBI sources on the 34x40x8 flagship-
    physics grid with ``mobi_full()``, as a float64 NumPy array."""
    import dataclasses
    import torch
    from uvic_tpu_torch.config import mobi_full, small_config
    from uvic_tpu_torch.models.ocean.model import make_ocean
    cfg = small_config(imt=40, jmt=34, km=8).replace(dtype=dtype,
                                                     bgc=mobi_full())
    cfg = cfg.replace(ocean=dataclasses.replace(
        cfg.ocean, isopycmix=True, gent_mcwilliams=True, tidal_kv=True,
        gthflx=True, aniso_visc=True, aniso_zonal=True))
    m = make_ocean(cfg, device=device)
    t, swr, aice, hice, hsno = (torch.as_tensor(x, dtype=m.dtype,
                                                device=m.device)
                                for x in mobi_small_inputs(m))
    src = m.npzd[True].sources(t, m.kmt, m.tmask, swr, aice, hice, hsno,
                               m.tlat_rad, torch.tensor(0.45, dtype=m.dtype,
                                                        device=m.device))
    return src.double().cpu().numpy(), m.tracer_index.names


def mobi_small_reference():
    """MOBI sources: card f32 against CPU f64 on the small grid, beside
    the same comparison of CPU f32 against CPU f64 (the drift the
    tolerance is set from)."""
    import numpy as np
    got, names = mobi_small_sources("cuda", "float32")
    ref, _ = mobi_small_sources("cpu", "float64")
    cpu32, _ = mobi_small_sources("cpu", "float32")

    def worst(a):
        out = (0.0, None)
        for n, name in enumerate(names):
            scale = np.abs(ref[n]).max()
            err = np.abs(a[n] - ref[n]).max()
            rel = err / scale if scale > 0 else (0.0 if err == 0 else np.inf)
            if not np.isfinite(a[n]).all():
                raise AssertionError(f"MOBI sources: non-finite {name}")
            out = max(out, (rel, name), key=lambda x: x[0])
        return out

    (rel, name), (drift, drift_name) = worst(got), worst(cpu32)
    say(f"  worst tracer {name}: err / largest source {rel:.3e} "
        f"(tolerance {TOL_MOBI_SRC}); CPU f32 against f64: {drift:.3e} "
        f"({drift_name}; {TOL_MOBI_SRC_CPU_DRIFT} when the limit was set)")
    if not rel <= TOL_MOBI_SRC:
        raise AssertionError(f"MOBI sources: {name} rel err {rel}")


def same_state(a, b):
    """max |a - b| over every tensor field of two states (0 = bitwise)."""
    import torch
    from uvic_tpu_torch.models.ocean.graphs import STATE_FIELDS
    return max(float(torch.max(torch.abs(getattr(a, f).double()
                                         - getattr(b, f).double())))
               for f in STATE_FIELDS)


def replay_counts(m, state, forcing):
    """Device kernels of one replayed step, by kernel, for the step type
    the state's itt selects (torch.profiler, CUDA activity only)."""
    import warnings
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            m.run_scan(state, forcing, 1)
            torch.cuda.synchronize()
    counts = {k: 0 for k in KERNEL_NAMES}
    total = 0
    for e in prof.events():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        total += 1
        for k, kname in KERNEL_NAMES.items():
            if kname in e.name:
                counts[k] += 1
    return counts, total


def check_replay_counts(m, state, forcing, label,
                        kinds=("leapfrog", "mixing")):
    """One launch of each kernel on the device in a replay of each step
    type; returns the device kernels per step by step type.

    The exact count of each kernel's nodes in a graph is say_graphs's,
    taken at capture; this is the device's side of it.  torch.profiler
    loses a few kernel records in a session of ~1.4e5 (42 in one run on
    the card, the CG's among them), so a step type whose session does
    not show each kernel exactly once is profiled again, up to
    REPLAY_SESSIONS times, and each kernel's largest count over the
    sessions must be 1.  ``kinds``: the step types profiled."""
    import dataclasses
    nmix = m.cfg.ocean.nmix
    per_step = {}
    for kind, itt in (("leapfrog", 1), ("mixing", nmix)):
        if kind not in kinds:
            continue
        most, totals = {k: 0 for k in KERNEL_NAMES}, []
        for _ in range(REPLAY_SESSIONS):
            counts, total = replay_counts(
                m, dataclasses.replace(state, itt=itt), forcing)
            most = {k: max(most[k], c) for k, c in counts.items()}
            totals.append(total)
            if all(c == 1 for c in counts.values()):
                break
        say(f"  {label} replayed {kind} step: {max(totals)} device kernels "
            f"(sessions: {totals}); {json.dumps(most)}")
        for k, c in most.items():
            if c != 1:
                raise AssertionError(f"{label} {kind} replay: {k} ran {c} "
                                     "times")
        per_step[kind] = max(totals)
    return per_step


def scan_vs_eager(m, state, forcing, nsteps, label, per_step=None):
    """``run_scan`` from ``state`` against the same steps taken eagerly
    with run_scan's semantics (launch counters reset before them, each
    kernel's launches ``per_step`` of it a step, by default 1): bitwise.
    Returns (eager end state, eager wall ms per step, counts)."""
    import torch
    from uvic_tpu_torch.ops.cg_kernel import congrad_launch
    from uvic_tpu_torch.ops.convection import apply_region_means
    from uvic_tpu_torch.ops.tracer_kernel import fct_tracer_step
    nmix = m.cfg.ocean.nmix
    fct_tracer_step.launches = 0
    apply_region_means.launches = 0
    congrad_launch.launches = 0
    e, step_ms = state, []
    for _ in range(nsteps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e = m._step(e, forcing, leapfrog=(e.itt % nmix) != 0, scan=True)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = {"fct_tracer_step": fct_tracer_step.launches,
              "apply_region_means": apply_region_means.launches,
              "congrad": congrad_launch.launches}
    for k, c in counts.items():
        want = nsteps * (1 if per_step is None else per_step[k])
        if c != want:
            raise AssertionError(f"{label} eager: {k} launched {c} times in "
                                 f"{nsteps} steps, {want} expected")
    r = m.run_scan(state, forcing, nsteps)
    torch.cuda.synchronize()
    diff = same_state(r, e)
    say(f"  {label}: run_scan over {nsteps} steps (itt {state.itt}.."
        f"{state.itt + nsteps - 1}) against the same steps taken eagerly: "
        f"max |diff| {diff:.3e} (bitwise required)")
    if diff != 0.0 or r.itt != e.itt:
        raise AssertionError(f"{label}: run_scan differs from the eager "
                             f"steps by {diff}")
    return e, statistics.median(step_ms), counts


def timed_scan(m, state, forcing, nsteps):
    """(end state, wall ms per replayed step) of a run_scan call."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = m.run_scan(state, forcing, nsteps)
    torch.cuda.synchronize()
    return r, (time.perf_counter() - t0) * 1e3 / nsteps


def say_graphs(m, label, per_step=None):
    """Capture and instantiation times of the model's two graphs, and
    the kernel nodes each holds: the launches each wrapper made while
    its graph was captured (counted by the wrappers, not the profiler),
    which must be exactly ``per_step`` of each kernel (by default one).
    Returns {kernel: {"leapfrog": n, "mixing": n}}."""
    g = m._graphs
    say(f"  graphs: capture {g.capture_s[True]:.2f} s (leapfrog), "
        f"{g.capture_s[False]:.2f} s (mixing); instantiation "
        f"{g.instantiate_s[True]:.2f} s, {g.instantiate_s[False]:.2f} s")
    per_kernel = {k: {"leapfrog": g.captured[True][k],
                      "mixing": g.captured[False][k]}
                  for k in KERNEL_NAMES}
    say(f"  kernel launches captured per step type: "
        f"{json.dumps(per_kernel)}")
    for k, by_kind in per_kernel.items():
        want = 1 if per_step is None else per_step[k]
        for kind, c in by_kind.items():
            if c != want:
                raise AssertionError(f"{label} {kind} graph holds {c} "
                                     f"launches of {k}, {want} expected")
    return per_kernel


def check_finite(state, label):
    import torch
    from uvic_tpu_torch.models.ocean.graphs import STATE_FIELDS
    for name in STATE_FIELDS:
        if not bool(torch.isfinite(getattr(state, name)).all()):
            raise AssertionError(f"non-finite {name} after {label}")


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


def digest(out):
    """First 16 hex digits of the SHA-256 of a call's output tensor (the
    first of a tuple): equal digests mean bitwise equal outputs."""
    import hashlib
    t = out[0] if isinstance(out, tuple) else out
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()[:16]


def times_only():
    """--times: `ms`, `device_ms` and the output digest of the three
    kernel wrappers on the captured flagship inputs, of the tracer step
    and the apply on the captured inputs of one MOBI step (nt=41), and of
    the apply on seeded random inputs at both shapes, one JSON line.  The
    captured inputs can differ between two processes (the flagship state
    they come from is not always bitwise the same), the seeded ones
    cannot: their digests show whether two trees' kernels agree bitwise."""
    import numpy as np
    import torch
    import uvic_tpu_torch
    from uvic_tpu_torch.entry import _flagship
    from uvic_tpu_torch.ops.cg_kernel import congrad_cuda
    from uvic_tpu_torch.ops.convection import apply_region_means
    from uvic_tpu_torch.ops.tracer_kernel import fct_tracer_step
    m, _, _, seen = flagship_inputs()
    m41, s41, f41 = _flagship(mobi=True)
    _, seen41 = capture_step(m41, perturbed(m41, s41), f41)
    args, kw = seen["tracer"]
    args41, kw41 = seen41["tracer"]
    ts, mnorm, ocean, _ = convect_inputs(seen)
    ts41, mnorm41, ocean41, _ = convect_inputs(seen41)
    seeded = {nt: random_convect_inputs(np.random.default_rng(CONVECT_SEED),
                                        nt, *ts41.shape[1:])
              for nt in (2, 41)}
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
        "fct_tracer_step_nt41": lambda: fct_tracer_step(*args41, **kw41),
        "apply_region_means_nt41": lambda: apply_region_means(
            ts41, mnorm41, ocean41),
        "apply_region_means_seeded": lambda: apply_region_means(*seeded[2]),
        "apply_region_means_seeded_nt41": lambda: apply_region_means(
            *seeded[41]),
    }
    out = {"package": str(Path(uvic_tpu_torch.__file__).parent),
           "card": card_line()}
    for name, fn in calls.items():
        out[name] = {"ms": cuda_time_ms(fn), "device_ms": device_ms(fn),
                     "digest": digest(fn())}
    out["cg_iters"] = {"warm": int(calls["congrad_warm"]()[1]),
                       "zero": int(calls["congrad_zero"]()[1])}
    say(json.dumps(out))
    return 0


def earth_capture(m, state):
    """The coupled segment's stages taken eagerly from ``state`` up to
    its first ocean step, and the arguments each kernel wrapper receives
    in an ocean step from there, with the segment's forcing and the
    phase 2 noise added to T and S."""
    from uvic_tpu_torch.coupler.driver import host_of, pack_state
    from uvic_tpu_torch.models.ocean.model import make_forcing
    if m.transient is not None:
        m._update_transient()       # the segment's forcing, as run() does
    ws = pack_state(state)
    ws.update(m.segment_inputs())
    host = host_of(state)
    for name, flag in m.schedule(host):
        if name == "ocean":
            break
        ws.update(m.stage(name, flag, ws, host))
    forcing = make_forcing(**{k: ws["forcing/" + k]
                              for k in m.forcing_names})
    return capture_step(m.ocean, perturbed(m.ocean, state.ocean), forcing)[1]


def earth_bgc_model(device=None, dtype="float32"):
    """The earth carbon-cycle model (on the card unless ``device`` says
    otherwise) from its initial state, with the default transient
    forcing."""
    from uvic_tpu_torch.config import SedConfig, earth_config, mobi_full
    from uvic_tpu_torch.coupler.driver import CoupledModel
    cfg = earth_config(dtype=dtype)
    cfg = cfg.replace(bgc=mobi_full(),
                      sed=SedConfig(enabled=True, porewater=True),
                      time=dataclasses.replace(cfg.time, year0=EARTH_BGC_YEAR0,
                                               **EARTH_BGC_RUN_TIME))
    m = CoupledModel(cfg, topo_kind="earth", device=device)
    m.set_transient_forcing()
    return m, m.init_state()


def coupled_tavg_diff(m, ref):
    """max |diff| between the model's last time means and ``ref``, and
    whether their names agree."""
    import torch
    if set(m.last_tavg) != set(ref):
        return float("inf")
    return max(float(torch.max(torch.abs(m.last_tavg[k].double()
                                         - ref[k].double())))
               for k in ref)


def earth_bgc_phase():
    """Phase 8: the earth carbon cycle on the card.  The kernels on an
    ocean step's inputs with the gas exchange and the sediments' bottom
    flux in them, eager segments against replayed ones, a month inside
    Run against the JAX package's float64 month.  Returns the kernel
    checks, the launch counts and the times."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from uvic_tpu_torch.coupler.run import Run
    out = {}
    t0 = time.perf_counter()
    m, start = earth_bgc_model()
    idx = m.ocean.tracer_index
    names = [tr.name for tr in idx.tracers]
    say(f"  built the earth model with mobi_full() ({m.ocean.nt} tracers), "
        f"pore-water sediments, year0 {EARTH_BGC_YEAR0} and the default "
        f"transient forcing in {time.perf_counter() - t0:.1f} s: "
        f"{m.topo.nisle} islands; a segment is {m.ntspas} atmosphere and "
        f"{m.ntspos} ocean steps")
    if m.ocean.nt != 41 or m.topo.nisle != 6:
        raise AssertionError(f"earth bgc: nt {m.ocean.nt}, "
                             f"{m.topo.nisle} islands")

    say(" kernels on the inputs of the first ocean step (the segment's "
        "forcing with the gas exchange and the sediments, phase 2's noise "
        "on T and S)")
    seen = earth_capture(m, start)
    args = seen["tracer"][0]
    stf, btf, src = args[7], args[8], args[9]
    nonzero = {f"stf {n}": int(torch.count_nonzero(stf[idx[n]]))
               for n in EARTH_BGC_GAS}
    nonzero.update({f"btf {n}": int(torch.count_nonzero(btf[idx[n]]))
                    for n in EARTH_BGC_BOTTOM})
    say(f"  cells with a non-zero flux: {json.dumps(nonzero)}; the tracer "
        f"step's inputs: t {tuple(args[1].shape)}, stf "
        f"{tuple(stf.shape)}, btf {tuple(btf.shape)}, a MOBI source "
        f"{src is not None}")
    if src is None or not all(nonzero.values()):
        raise AssertionError("earth bgc: the ocean step's inputs lack the "
                             "gas exchange, the bottom flux or the source")
    say(" fct_tracer_step, earth bgc")
    out["tracer"] = check_tracer(m.ocean, seen, "earth bgc tracer step")
    say(" apply_region_means, earth bgc")
    out["convect"] = check_convect(seen)
    say(" congrad, earth bgc (six islands)")
    out["cg"] = check_cg(m.ocean, seen)
    del seen, args, stf, btf, src

    from uvic_tpu_torch.coupler.graphs import KERNEL_WRAPPERS
    relyr0 = m.relyr
    seg = eager_against_replayed(m, start, EARTH_BGC_SEGMENTS, "earth bgc",
                                 bare=1, stage_graphs=True)
    g = m._graphs
    surf = sorted(k for k in seg["eager_tavg"] if k.startswith("surf_"))
    say(f"  surf_* time means {len(surf)}; workspace inputs "
        f"{sorted(g.inputs)}; graph nodes by stage "
        f"{json.dumps(seg['nodes'])}")
    if surf != sorted("surf_" + n for n in names[2:]):
        raise AssertionError(f"earth bgc: time means {surf}")

    with open(EARTH_BGC_GOLDEN) as f:
        golden = json.load(f)
    say(f"  a month inside the port's Run ({EARTH_BGC_MONTH} segments; "
        f"{json.dumps(EARTH_BGC_RUN_TIME)}) on the same graphs, each "
        f"segment's row held against {EARTH_BGC_GOLDEN} ({golden['command']}"
        f"; {golden['tolerance_rule']})")
    weights = bgc_weights(m.grid, m.ocean.tmask.cpu().numpy(),
                          m.area2d.cpu().numpy())
    rows, stamps = [], []
    inner = m.run

    def segment(state, n, eager=False):
        stamps.append(time.perf_counter())
        state = inner(state, n, eager)
        rows.append(port_bgc_row(m, weights, names, state))
        return state

    replays0 = dict(g.replays)
    m.relyr = relyr0
    outdir = tempfile.mkdtemp(prefix="earth_bgc_run_")
    run = Run(m, outdir)
    m.run = segment
    try:
        t1 = time.perf_counter()
        state = run.run(start, nseg=EARTH_BGC_MONTH)
        torch.cuda.synchronize()
        month_s = time.perf_counter() - t1
    finally:
        del m.run
    stamps.append(time.perf_counter())
    run_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    if m._graphs is not g:
        raise AssertionError("earth bgc Run: graphs captured again")
    month_counts = {k: sum((n - replays0[key]) * g.captured[key][k]
                           for key, n in g.replays.items())
                    for k in KERNEL_WRAPPERS}
    worst, failed = bgc_month_gaps(rows, golden)
    say(f"  {month_s:.1f} s; segment time inside Run "
        f"{', '.join(f'{t:.1f}' for t in run_ms)} ms (the row's reductions "
        f"included); the kernels' launches by replay over the month "
        f"{json.dumps(month_counts)}")
    for kind, (frac, gap, key, n, lim) in sorted(worst.items()):
        say(f"  {kind}: nearest its limit {key} (segment {n}): gap "
            f"{gap:.3e} of {lim:.3e} ({frac:.2f})")
    say(f"  nconv by segment {[r['nconv'] for r in rows]}; cfc11 (N, S) "
        f"{m.cfcccn[0]:.2f} {m.cfcccn[1]:.2f} pptv")
    if len(rows) != EARTH_BGC_MONTH or failed:
        raise AssertionError(f"earth bgc month: out of limits {failed[:20]}")
    if any(c != m.ntspos * EARTH_BGC_MONTH for c in month_counts.values()):
        raise AssertionError(f"earth bgc month: launches {month_counts}")

    from scipy.io import netcdf_file
    f = netcdf_file(os.path.join(outdir, "tavg.nc"), "r", mmap=False)
    try:
        tavg = {k: np.array(v[:]) for k, v in f.variables.items()}
    finally:
        f.close()
    want = {"surf_" + n for n in names[2:]}
    bad = [k for k, v in tavg.items() if not np.isfinite(v).all()]
    if not want <= set(tavg) or bad:
        raise AssertionError(f"earth bgc tavg.nc: missing "
                             f"{sorted(want - set(tavg))}, non-finite {bad}")
    with np.load(os.path.join(outdir, "restart.npz")) as d:
        nt_file = d["ocean/t"].shape[0]
        sed_keys = sorted(k for k in d.files if k.startswith("sed/"))
    if nt_file != 41 or len(sed_keys) != 7:
        raise AssertionError(f"earth bgc restart.npz: ocean/t holds "
                             f"{nt_file} tracers, sediments {sed_keys}")
    say(f"  tavg.nc: {len(tavg)} variables, the {len(want)} surf_* among "
        f"them, every one finite; restart.npz: ocean/t with {nt_file} "
        f"tracers, {sed_keys}")
    check_finite(state.ocean, "the earth bgc month")
    shutil.rmtree(outdir)
    out.update(eager_ms=seg["eager_ms"], replay_ms=seg["replay_ms"],
               run_ms=statistics.median(run_ms),
               eager_counts=seg["eager_counts"],
               run_counts=seg["run_counts"], month_counts=month_counts,
               graph_nodes=seg["nodes"], capture_s=seg["first_s"])
    del m, g, seg, state, run
    torch.cuda.empty_cache()
    return out


def coupled_diff(a, b):
    """max |a - b| over every tensor of two coupled states (0 = bitwise)
    and whether their counters agree."""
    import torch
    from uvic_tpu_torch.coupler.driver import pack_state
    pa, pb = pack_state(a), pack_state(b)
    diff = max(float(torch.max(torch.abs(pa[k].double() - pb[k].double())))
               for k in pa)
    return diff, (a.ocean.itt, a.atm.nats) == (b.ocean.itt, b.atm.nats)


def graph_nodes(graph):
    """Nodes of a captured CUDA graph (kernels, copies, memsets), read
    with the driver's cuGraphGetNodes; None where the graph's handle is
    not exposed."""
    import ctypes
    raw = getattr(graph, "raw_cuda_graph", None)
    if raw is None:
        return None
    n = ctypes.c_size_t(0)
    rc = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(raw()), None, ctypes.byref(n))
    return int(n.value) if rc == 0 else None


def tsi_rows(path):
    """{days: row} of a tsi stream (the golden's or one a Run wrote), each
    row {column: value}."""
    with open(path) as f:
        header = f.readline().strip().split(",")
        rows = {}
        for line in f:
            vals = [float(v) for v in line.strip().split(",")]
            rows[round(vals[0], 4)] = dict(zip(header[1:], vals[1:]))
    return rows


def golden_gaps(rows, golden):
    """Each golden column's largest relative gap over ``rows`` as (gap,
    days, value, golden value), and the days whose nconv differs."""
    worst, nconv_off = {}, []
    for days, row in rows.items():
        ref = golden[days]
        for col in TOL_GOLDEN:
            gap = abs(row[col] - ref[col]) / abs(ref[col])
            if gap > worst.get(col, (-1.0,))[0]:
                worst[col] = (gap, days, row[col], ref[col])
        if row["nconv"] != ref["nconv"]:
            nconv_off.append(days)
    return worst, nconv_off


def earth_model(cfg=None):
    """The earth model on the card from EARTH_RESTART with its relyr, the
    Run's output intervals (EARTH_RUN_TIME) in its configuration."""
    from uvic_tpu_torch.config import earth_config
    from uvic_tpu_torch.entry import _earth
    cfg = cfg or earth_config()
    cfg = cfg.replace(time=dataclasses.replace(cfg.time, **EARTH_RUN_TIME))
    return _earth(EARTH_RESTART, cfg=cfg)


def timed_run(m, run, state, nseg):
    """``run.run(state, nseg=nseg)`` with the host clock read as each
    segment's ``m.run`` starts: the segment times inside Run (the replay
    and the loop's host work around it), and the graphs each segment
    found."""
    stamps, graphs = [], []
    inner = m.run

    def segment(state, n, eager=False):
        stamps.append(time.perf_counter())
        graphs.append(m._graphs)
        return inner(state, n, eager)

    m.run = segment
    try:
        state = run.run(state, nseg=nseg)
    finally:
        del m.run
    seg_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    return state, seg_ms, graphs


def earth_phase():
    """Phase 6: the coupled earth segment on the card, and a year of it
    through the port's Run.  Returns the kernel checks on earth inputs,
    the launch counts and the times."""
    import tempfile

    import torch
    from uvic_tpu_torch.coupler.graphs import KERNEL_WRAPPERS
    from uvic_tpu_torch.coupler.run import Run
    out = {}
    t0 = time.perf_counter()
    m, start = earth_model()
    relyr0 = m.relyr
    say(f"  built CoupledModel(earth_config(), topo_kind='earth') from "
        f"{EARTH_RESTART} in {time.perf_counter() - t0:.1f} s: "
        f"{m.topo.nisle} islands, itt {start.ocean.itt}, nats "
        f"{start.atm.nats}, relyr {relyr0!r}; a segment is {m.ntspas} "
        f"atmosphere and {m.ntspos} ocean steps")
    if m.topo.nisle != 6:
        raise AssertionError(f"earth: {m.topo.nisle} islands, not 6")

    say(" kernels on the inputs of an earth segment's ocean step (its "
        "forcing, phase 2's noise on T and S)")
    seen = earth_capture(m, start)
    say(" fct_tracer_step, earth")
    out["tracer"] = check_tracer(m.ocean, seen, "earth tracer step")
    say(" apply_region_means, earth")
    out["convect"] = check_convect(seen)
    say(" congrad, earth (six islands)")
    out["cg"] = check_cg(m.ocean, seen)

    seg = eager_against_replayed(m, start, EARTH_SEGMENTS, "earth", bare=0,
                                 stage_graphs=True)

    say(f"  one year through the port's Run from {EARTH_RESTART} "
        f"({EARTH_YEAR} segments; {json.dumps(EARTH_RUN_TIME)}), the graphs "
        "captured again by its first segment, launch counters from 0")
    import shutil
    say(f"  card before the year: {clocks_line()} (clocks.sm, power.draw, "
        "temperature.gpu)")
    outdir = tempfile.mkdtemp(prefix="earth_run_")
    m._graphs = None
    for w in KERNEL_WRAPPERS.values():
        w.launches = 0
    logs = []
    m.relyr = relyr0
    run = Run(m, outdir, log=logs.append)
    run.tm.days = relyr0 * run.tm.yrlen
    t1 = time.perf_counter()
    state, run_ms, seen_graphs = timed_run(m, run, start, EARTH_YEAR)
    torch.cuda.synchronize()
    year_s = time.perf_counter() - t1
    relyr_year = m.relyr
    g = m._graphs
    run_counts = {k: 0 for k in KERNEL_WRAPPERS}
    nodes = 0
    for name, flag in m.schedule(dict(itt=start.ocean.itt,
                                      nats=start.atm.nats)):
        for k in run_counts:
            run_counts[k] += g.captured[(name, flag)][k]
        nodes += graph_nodes(g.graphs[(name, flag)]) or 0
    captures = {k: w.launches for k, w in KERNEL_WRAPPERS.items()}
    # the year's kernel launches through the graphs: each graph's replays
    # over the year times the launches captured in it
    year_counts = {k: sum(n * g.captured[key][k]
                          for key, n in g.replays.items())
                   for k in KERNEL_WRAPPERS}
    say(f"  {EARTH_YEAR} segments in {year_s:.1f} s; segment time inside "
        f"Run median {statistics.median(run_ms):.1f} ms (min "
        f"{min(run_ms):.1f}, max {max(run_ms):.1f}, the first with the "
        f"captures)")
    say(f"  each segment inside Run, ms: "
        f"{' '.join(str(round(x)) for x in run_ms)}")
    say(f"  wrappers' launch counters over the year: {json.dumps(captures)} "
        f"(the capture's warm-up segment and the captures); a replayed "
        f"segment holds {nodes} graph nodes and the launches "
        f"{json.dumps(run_counts)}; every segment after the first replayed "
        f"the same graphs; graph replays over the year "
        f"{json.dumps({f'{n} {f}': c for (n, f), c in g.replays.items()})}"
        f", so the kernels' launches by replay {json.dumps(year_counts)}")
    for k, c in run_counts.items():
        if (c != m.ntspos or captures[k] == 0
                or year_counts[k] != m.ntspos * EARTH_YEAR):
            raise AssertionError(f"earth Run: {k} launched {c} times a "
                                 f"segment, {year_counts[k]} by replay and "
                                 f"{captures[k]} by its counter over the "
                                 "year")
    if any(seen is not g for seen in seen_graphs[1:]):
        raise AssertionError("earth Run: graphs captured again mid-year")
    for line in logs:
        if "drift" in line or "stab:" in line:
            say("  Run log: " + line)
    check_finite(state.ocean, "the earth year")
    out.update(year=check_run_outputs(run, state, outdir, EARTH_YEAR))

    check_split(m, run, state, outdir, relyr_year)
    shutil.rmtree(outdir)
    bare_ms = []
    m.relyr = relyr0
    state = start
    for _ in range(EARTH_BARE):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state = m.run(state, 1)
        torch.cuda.synchronize()
        bare_ms.append((time.perf_counter() - t1) * 1e3)
    say(f"  {EARTH_BARE} bare replayed segments (m.run, the Run's graphs): "
        f"{', '.join(f'{x:.1f}' for x in bare_ms)} ms, median "
        f"{statistics.median(bare_ms):.1f} ms against "
        f"{statistics.median(run_ms):.1f} ms inside Run; card after them: "
        f"{clocks_line()}")
    out.update(eager_ms=seg["eager_ms"],
               replay_ms=statistics.median(bare_ms),
               run_ms=statistics.median(run_ms),
               eager_counts=seg["eager_counts"],
               run_counts=run_counts, year_counts=year_counts,
               graph_nodes=nodes, model=m, start=start)
    return out


def check_split(m, run, state, outdir, relyr):
    """A fresh Run resumed from ``outdir``'s restart.npz takes EARTH_SPLIT
    segments; ``run`` (which wrote it, ending at ``state`` with the
    model's clock at ``relyr``) takes as many more: the same state and
    tsi rows, bitwise."""
    import shutil
    import tempfile
    from uvic_tpu_torch.coupler.run import Run
    say(f"  split run: a fresh Run resumed from the year's restart.npz and "
        f"{EARTH_SPLIT} segments, against {EARTH_SPLIT} more segments of "
        "the continuous Run")
    split_dir = tempfile.mkdtemp(prefix="earth_split_")
    shutil.copy(os.path.join(outdir, "restart.npz"), split_dir)
    run_b = Run(m, split_dir)
    state_b = run_b.load(state)
    if (run_b.tm.itt, run_b.tm.days) != (run.tm.itt, run.tm.days):
        raise AssertionError("split run: the restart's calendar "
                             f"{run_b.tm.itt, run_b.tm.days} against "
                             f"{run.tm.itt, run.tm.days}")
    state_b = run_b.run(state_b, nseg=EARTH_SPLIT)
    m.relyr = relyr
    state_a = run.run(state, nseg=EARTH_SPLIT)
    diff, counters_equal = coupled_diff(state_a, state_b)
    with open(os.path.join(outdir, "tsi.csv")) as f:
        rows_a = f.read().splitlines()[-(EARTH_SPLIT // 2):]
    with open(os.path.join(split_dir, "tsi.csv")) as f:
        rows_b = f.read().splitlines()[1:]
    say(f"  split against continuous: max |diff| {diff:.3e} in the state, "
        f"tsi rows {rows_b} and {rows_a} (bitwise required)")
    if diff != 0.0 or not counters_equal or rows_a != rows_b \
            or len(rows_b) != EARTH_SPLIT // 2:
        raise AssertionError("earth: the split run differs from the "
                             "continuous one")
    shutil.rmtree(split_dir)


def say_segment_graphs(g):
    """Each stage graph's capture and instantiation seconds, nodes and
    captured kernel launches."""
    for key in g.graphs:
        say(f"  graph {key[0]}{'' if key[1] is None else f' {key[1]}'}: "
            f"capture {g.capture_s[key]:.2f} s, instantiation "
            f"{g.instantiate_s[key]:.2f} s, {graph_nodes(g.graphs[key])} "
            f"nodes, kernel launches captured {json.dumps(g.captured[key])}")


def check_run_outputs(run, state, outdir, nseg):
    """The files a Run of ``nseg`` segments from EARTH_RESTART wrote: each
    tsi row against the golden's of its day (TOL_GOLDEN, nconv equal),
    the tavg stream (TAVG_VARIABLES, a record every timavgint days, every
    field finite), the restart's calendar and the run summary's drift.
    Returns the golden gaps."""
    import numpy as np
    from scipy.io import netcdf_file
    from uvic_tpu_torch.io.netcdf import read_var
    tcfg = run.m.cfg.time
    rows = tsi_rows(os.path.join(outdir, "tsi.csv"))
    worst, nconv_off = golden_gaps(rows, tsi_rows(EARTH_GOLDEN))
    say(f"  {len(rows)} tsi rows held against {EARTH_GOLDEN}; nconv "
        f"{'equal in each' if not nconv_off else f'differs at {nconv_off}'}")
    failed = list(nconv_off)
    for col, lim in TOL_GOLDEN.items():
        gap, days, got, ref = worst[col]
        say(f"  {col}: largest relative gap {gap:.3e} (limit {lim:.0e}) at "
            f"day {days}: {got:.10e} against {ref:.10e}")
        if not gap <= lim:
            failed.append(col)
    nrows = int(nseg * tcfg.segtim_days // tcfg.tsiint)
    if len(rows) != nrows or failed:
        raise AssertionError(f"earth Run: {len(rows)} tsi rows, out of "
                             f"limits: {failed}")

    path = os.path.join(outdir, "tavg.nc")
    f = netcdf_file(path, "r", mmap=False)
    try:
        names = sorted(f.variables)
    finally:
        f.close()
    times = read_var(path, "time")
    days0 = round(run.tm.days - nseg * tcfg.segtim_days, 4)
    want = [days0 + tcfg.timavgint * (n + 1)
            for n in range(int(nseg * tcfg.segtim_days // tcfg.timavgint))]
    if names != sorted(TAVG_VARIABLES):
        raise AssertionError(f"tavg.nc: variables {names} are not the "
                             "reference's")
    if len(times) != len(want) or np.abs(times - want).max() > 1e-3:
        raise AssertionError(f"tavg.nc: records at {times}, not {want}")
    for name in names:
        v = read_var(path, name)
        if not np.isfinite(v).all():
            raise AssertionError(f"tavg.nc: non-finite {name}")
    say(f"  tavg.nc: {len(names)} variables (the reference's), records at "
        f"days {times.tolist()}, every field finite")
    with np.load(os.path.join(outdir, "restart.npz")) as d:
        cal = (int(d["__itt"]), float(d["__days"]))
    if cal != (state.ocean.itt, run.tm.days):
        raise AssertionError(f"restart.npz: calendar {cal}")
    with open(os.path.join(outdir, "run_summary.json")) as f:
        summary = json.load(f)
    if "drift" not in summary:
        raise AssertionError(f"run_summary.json: {summary}")
    say(f"  restart.npz: __itt {cal[0]}, __days {cal[1]!r}; run_summary: "
        f"{json.dumps(summary)}")
    return worst


def transient_phase():
    """Phase 7: transient forcing and the anomalous-wind feedback on the
    earth model; eager segments against replayed ones, bitwise."""
    import numpy as np
    import torch
    from uvic_tpu_torch.config import earth_config
    from uvic_tpu_torch.io.forcing import TransientForcing
    from uvic_tpu_torch.io.forcing import TransientSeries as S
    from uvic_tpu_torch.models.embm.constants import SOLARCONST
    m, start = earth_model()
    relyr0 = m.relyr
    y0 = m.year0 + relyr0
    span = EARTH_TRANSIENT * m.cfg.time.segtim_days / 360.0
    forced = TransientForcing(
        co2=S(np.array([y0, y0 + span]), np.array([280.0, 1120.0])),
        solar=S.constant(SOLARCONST),
        volcanic=S(np.array([y0, y0 + span / 2, y0 + span]),
                   np.array([0.0, 3.0e4, 0.0])),
        c14=S.constant(0.0),
        sulph=S(np.array([y0, y0 + span]), np.array([0.02, 0.05])),
        landice=S(np.array([y0, y0 + span]), np.array([0.4, 1.0])))
    constant = TransientForcing(
        co2=S.constant(280.0), solar=S.constant(SOLARCONST),
        volcanic=S.constant(0.0), c14=S.constant(0.0),
        sulph=S.constant(0.02), landice=S.constant(0.4))
    say(f"  transient forcing over {EARTH_TRANSIENT} segments from year "
        f"{y0!r}: CO2 280 -> 1120 ppm, a volcanic drop of 3e4 erg/cm2/s, "
        "sulphate scale 0.02 -> 0.05, ice sheets 0.4 -> 1.0")
    m.set_transient_forcing(forced)
    m.relyr = relyr0
    eager = start
    forcing_seen = []
    for _ in range(EARTH_TRANSIENT):
        eager = m.run(eager, 1, eager=True)
        forcing_seen.append((m.co2ccn, float(m.anthro), m.solar_scale,
                             float(m.landice[1].max())
                             if m.landice is not None else 0.0))
    eager_tavg = {k: v.clone() for k, v in m.last_tavg.items()}
    m.relyr = relyr0
    t1 = time.perf_counter()
    replayed = m.run(start, EARTH_TRANSIENT)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t1
    g = m._graphs
    diff, counters_equal = coupled_diff(replayed, eager)
    tavg_diff = coupled_tavg_diff(m, eager_tavg)
    say(f"  (co2, anthro, solar scale, ice-sheet extent) by segment: "
        f"{forcing_seen}; workspace inputs {sorted(m.segment_inputs())}")
    say(f"  replayed ({first_s:.1f} s with the captures) against eager: max "
        f"|diff| {diff:.3e} in the state, {tavg_diff:.3e} in the time means "
        "(bitwise required)")
    if diff != 0.0 or tavg_diff != 0.0 or not counters_equal:
        raise AssertionError("transient: replayed segments differ from the "
                             "eager ones")
    say_segment_graphs(g)
    m.set_transient_forcing(constant)
    m.relyr = relyr0
    steady = m.run(start, EARTH_TRANSIENT)
    moved = float(torch.max(torch.abs(steady.atm.at - replayed.atm.at)))
    say(f"  the same graphs replayed under constant forcing: max |diff| of "
        f"atm/at {moved:.4f} against the transient replay")
    if m._graphs is not g or not moved > 0.0:
        raise AssertionError("transient: the replay did not follow the "
                             "forcing in the workspace")
    check_finite(replayed.ocean, "the transient segments")
    del m, g, eager, replayed, steady

    cfg = earth_config()
    cfg = cfg.replace(embm=dataclasses.replace(cfg.embm, awind=True))
    m, start = earth_model(cfg)
    relyr0 = m.relyr
    sat = start.atm.at[0].cpu().numpy()
    wave = np.sin(np.deg2rad(np.asarray(m.grid.xt)) * 3.0)[None, :]
    clims = (sat - 1.0 + 0.5 * wave, sat - 0.5 - 0.5 * wave)
    say(f"  anomalous winds (embm.awind) against the restart's SAT "
        f"perturbed: {EARTH_AWIND} segments eager and replayed, then one "
        "more of each under another climatology")
    m.awind.set_climatology(clims[0])
    m.relyr = relyr0
    eager = m.run(start, EARTH_AWIND, eager=True)
    m.relyr = relyr0
    t1 = time.perf_counter()
    first = m.run(start, 1)
    replayed = m.run(first, EARTH_AWIND - 1)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t1
    g = m._graphs
    diff, counters_equal = coupled_diff(replayed, eager)
    m.awind.set_climatology(clims[1])
    m.relyr = relyr0
    eager2 = m.run(start, 1, eager=True)
    m.relyr = relyr0
    replayed2 = m.run(start, 1)
    diff2, counters_equal2 = coupled_diff(replayed2, eager2)
    moved = float(torch.max(torch.abs(replayed2.atm.at - first.atm.at)))
    say(f"  replayed ({first_s:.1f} s with the captures) against eager: max "
        f"|diff| {diff:.3e}; under the second climatology {diff2:.3e} "
        f"(bitwise required), same graphs {m._graphs is g}, atm/at moved "
        f"{moved:.4f} against the first climatology's segment")
    if diff != 0.0 or diff2 != 0.0 or not counters_equal \
            or not counters_equal2 or m._graphs is not g or not moved > 0.0:
        raise AssertionError("awind: replayed segments differ from the "
                             "eager ones or ignore the climatology")
    say_segment_graphs(g)
    check_finite(replayed.ocean, "the awind segments")
    del m, g
    torch.cuda.empty_cache()


def golden_years(nyears):
    """--golden-years: ``nyears`` years from EARTH_RESTART through the
    port's Run, every tsi row held against the golden stream; each
    column's worst gap by year."""
    import shutil
    import tempfile

    import torch
    from uvic_tpu_torch.coupler.run import Run
    from uvic_tpu_torch.cuda import LIBRARY
    LIBRARY.get()
    m, start = earth_model()
    outdir = tempfile.mkdtemp(prefix="earth_golden_")
    run = Run(m, outdir)
    run.tm.days = m.relyr * run.tm.yrlen
    days0 = round(run.tm.days, 4)
    nseg = 72 * nyears
    say(f"{nyears} years ({nseg} segments) through the port's Run from "
        f"{EARTH_RESTART}, day {days0}")
    t0 = time.perf_counter()
    state, run_ms, _ = timed_run(m, run, start, nseg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_finite(state.ocean, "the golden years")
    rows = tsi_rows(os.path.join(outdir, "tsi.csv"))
    shutil.rmtree(outdir)
    by_year, failed = gaps_by_year(rows, days0, nyears)
    say(f"  {len(rows)} rows in {wall:.1f} s wall "
        f"({nyears / (wall / 86400.0):.0f} simulated years a day); segment "
        f"time inside Run median "
        f"{statistics.median(run_ms):.1f} ms")
    say(json.dumps({"golden_years": nyears, "rows": len(rows),
                    "wall_s": wall, "run_ms_median": statistics.median(run_ms),
                    "worst_by_year": by_year, "out_of_limits": failed}))
    if len(rows) != nseg // 2 or failed:
        say(f"golden run: {len(rows)} rows, out of limits {failed}")
        return 1
    return 0


def gaps_by_year(rows, days0, nyears):
    """Each golden column's largest relative gap in each year of tsi
    ``rows`` from day ``days0``, printed against TOL_GOLDEN; returns the
    table and the (year, column, gap) out of limits."""
    golden = tsi_rows(EARTH_GOLDEN)
    by_year, failed = [], []
    for year in range(nyears):
        lo, hi = days0 + 360.0 * year, days0 + 360.0 * (year + 1)
        sel = {d: r for d, r in rows.items() if lo < d <= hi + 1e-3}
        worst, nconv_off = golden_gaps(sel, golden)
        gaps = {col: worst[col][0] for col in TOL_GOLDEN}
        by_year.append(dict(year=year + 1, rows=len(sel), nconv_off=nconv_off,
                            **gaps))
        out = [col for col, lim in TOL_GOLDEN.items() if not gaps[col] <= lim]
        failed += [(year + 1, col, gaps[col]) for col in out]
        failed += [(year + 1, "nconv", d) for d in nconv_off]
        say(f"  year {year + 1}: {len(sel)} rows; "
            + ", ".join(f"{col} {gap:.2e}" for col, gap in gaps.items())
            + ("" if not out else f"; OUT OF LIMITS: {out}"))
    say(f"  limits: {json.dumps(TOL_GOLDEN)}")
    return by_year, failed


def golden_gaps_of(path):
    """--golden-gaps: the per-year table of a tsi stream written from
    EARTH_RESTART by any run (the JAX package's own float32 runs too):
    no card needed."""
    rows = tsi_rows(path)
    days0 = round(min(rows) - 10.0, 4)
    nyears = int(round((max(rows) - days0) / 360.0))
    say(f"{path}: {len(rows)} rows from day {days0}, against {EARTH_GOLDEN}")
    by_year, failed = gaps_by_year(rows, days0, nyears)
    say(json.dumps({"tsi": path, "rows": len(rows), "worst_by_year": by_year,
                    "out_of_limits": failed}))
    return 0


def earth_option_model(section=None, change=None, accel=1.0):
    """The earth model on the card from EARTH_RESTART with its relyr, its
    configuration ``earth_config(accel=accel)`` with ``change`` made to
    the ``section`` (ice or ocean) part."""
    from uvic_tpu_torch.config import earth_config
    cfg = earth_config(accel=accel)
    if section is not None:
        cfg = cfg.replace(**{section: dataclasses.replace(
            getattr(cfg, section), **change)})
    return earth_model(cfg)


def eager_against_replayed(m, start, nseg, label, per_step=None,
                           bare=EARTH_OPTION_BARE, stage_graphs=False):
    """``nseg`` segments from ``start`` eagerly (the wrappers' counters
    from 0), then the same segments replayed from stage graphs captured
    anew: bitwise equal in the state and the time means, each kernel
    launched ``per_step`` times an ocean step (once where not given) in
    both, every field finite; then ``bare`` more replays timed (the
    first replays after a capture can run slow, PERF.md section 7).
    ``stage_graphs`` prints each stage graph.  Returns the times, the
    launches, the graphs' nodes (in all and by stage) and the eager
    segments' time means."""
    import torch
    from uvic_tpu_torch.coupler.graphs import KERNEL_WRAPPERS
    per_step = dict(dict.fromkeys(KERNEL_WRAPPERS, 1), **(per_step or {}))
    relyr0 = m.relyr
    for w in KERNEL_WRAPPERS.values():
        w.launches = 0
    eager_ms, eager = [], start
    for _ in range(nseg):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        eager = m.run(eager, 1, eager=True)
        torch.cuda.synchronize()
        eager_ms.append((time.perf_counter() - t1) * 1e3)
    eager_tavg = {k: v.clone() for k, v in m.last_tavg.items()}
    per_seg = {k: w.launches / nseg for k, w in KERNEL_WRAPPERS.items()}
    say(f"  {label}: {nseg} eager segments "
        f"{', '.join(f'{t:.1f}' for t in eager_ms)} ms, launches a segment "
        f"{json.dumps(per_seg)}; BiCGSTAB trips (humidity, temperature) of "
        f"the last segment's atmosphere steps {m.seg_trips.tolist()}; CG "
        f"iterations {m.seg_cg_iters.tolist()}")
    m.relyr = relyr0
    m._graphs = None
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    replayed = m.run(start, 1)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t1
    replay_ms = []
    for _ in range(nseg - 1):
        t1 = time.perf_counter()
        replayed = m.run(replayed, 1)
        torch.cuda.synchronize()
        replay_ms.append((time.perf_counter() - t1) * 1e3)
    diff, counters_equal = coupled_diff(replayed, eager)
    tavg_diff = coupled_tavg_diff(m, eager_tavg)
    g = m._graphs
    run_counts = {k: 0 for k in KERNEL_WRAPPERS}
    nodes, total_nodes = {}, 0
    for name, flag in m.schedule(dict(itt=start.ocean.itt,
                                      nats=start.atm.nats)):
        for k in run_counts:
            run_counts[k] += g.captured[(name, flag)][k]
        key = name if flag is None else f"{name} {flag}"
        nodes[key] = graph_nodes(g.graphs[(name, flag)])
        total_nodes += nodes[key] or 0
    capture_s = sum(g.capture_s.values())
    instantiate_s = sum(g.instantiate_s.values())
    say(f"  {label}: replayed: the first {first_s:.2f} s (captures "
        f"{capture_s:.2f} s, instantiations {instantiate_s:.2f} s), then "
        f"{', '.join(f'{t:.1f}' for t in replay_ms)} ms; {total_nodes} "
        f"graph nodes, launches a replayed segment {json.dumps(run_counts)}"
        f"; max |diff| against the eager ones {diff:.3e} in the state, "
        f"{tavg_diff:.3e} in the time means (bitwise required)")
    if stage_graphs:
        say_segment_graphs(g)
    if diff != 0.0 or tavg_diff != 0.0 or not counters_equal:
        raise AssertionError(f"{label}: replayed segments differ from the "
                             "eager ones")
    for k in KERNEL_WRAPPERS:
        want = per_step[k] * m.ntspos
        if per_seg[k] != want or run_counts[k] != want:
            raise AssertionError(f"{label}: {k} launched {per_seg[k]} times "
                                 f"an eager segment, {run_counts[k]} a "
                                 f"replayed one, not {want}")
    check_finite(replayed.ocean, label)
    for name, field in (("atm/at", replayed.atm.at),
                        ("ice/hice", replayed.ice.hice)):
        if not bool(torch.isfinite(field).all()):
            raise AssertionError(f"{label}: non-finite {name}")
    if replayed.cpts is not None:
        for f in ("A", "heff", "E"):
            if not bool(torch.isfinite(getattr(replayed.cpts, f)).all()):
                raise AssertionError(f"{label}: non-finite cpts/{f}")
    bare_ms, state = [], replayed
    for _ in range(bare):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state = m.run(state, 1)
        torch.cuda.synchronize()
        bare_ms.append((time.perf_counter() - t1) * 1e3)
    if bare:
        say(f"  {label}: {bare} more replayed segments "
            f"{', '.join(f'{x:.1f}' for x in bare_ms)} ms, median "
            f"{statistics.median(bare_ms):.1f} ms")
    return dict(eager_ms=statistics.median(eager_ms),
                replay_ms=statistics.median(bare_ms or replay_ms),
                eager_counts=per_seg, run_counts=run_counts,
                graph_nodes=total_nodes, nodes=nodes, capture_s=capture_s,
                instantiate_s=instantiate_s, first_s=first_s,
                eager_tavg=eager_tavg)


def spinup_out_of_limits(row, golden):
    """The keys of a spin-up row outside ``golden``'s limits (element by
    element for a list), or not equal where the golden holds them equal,
    with (value, reference, limit)."""
    ref, limits = golden["row"], golden["limit"]
    bad = {}
    for key in golden["equal"]:
        if row.get(key) != ref[key]:
            bad[key] = (row.get(key), ref[key], 0)
    for key, lim in limits.items():
        got, want = row.get(key), ref[key]
        if got is None:
            bad[key] = (None, want, lim)
            continue
        vals = (zip(got, want, lim) if isinstance(lim, list)
                else [(got, want, lim)])
        # both rows are rounded to a key's digits: the difference of two
        # such decimals carries binary round-off (17.1 - 17.0 >
        # 0.1), taken off at 9 digits
        if any(not round(abs(a - b), 9) <= c for a, b, c in vals):
            bad[key] = (got, want, lim)
    return bad


def spinup_year():
    """One accelerated spin-up year through ``uvic_tpu_torch.spinup.main``
    (``1 --accel ACCEL --resume``) from a copy of SPINUP_START: the row
    against SPINUP_GOLDEN, the restart and its meta, and a second
    ``--resume`` of one segment starting from the year the first wrote.
    Returns the year's seconds and the wrappers' launches over it."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    import uvic_tpu_torch.spinup as spinup
    from uvic_tpu_torch.coupler.graphs import KERNEL_WRAPPERS
    with open(SPINUP_GOLDEN) as f:
        golden = json.load(f)
    work = tempfile.mkdtemp(prefix="spinup_")
    for name in ("restart.npz", "restart_meta.json"):
        shutil.copy(os.path.join(SPINUP_START, name), work)
    log = os.path.join(work, "spinup_log.jsonl")
    args = ["--accel", f"{ACCEL:g}", "--resume", "--out", work,
            "--run-id", "chip_smoke"]
    for w in KERNEL_WRAPPERS.values():
        w.launches = 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    spinup.main(["1"] + args)
    torch.cuda.synchronize()
    year_s = time.perf_counter() - t1
    launches = {k: w.launches for k, w in KERNEL_WRAPPERS.items()}
    with open(log) as f:
        rows = [json.loads(line) for line in f]
    row = rows[-1]
    say(f"  python3 -m uvic_tpu_torch.spinup 1 {' '.join(args)} (from a "
        f"copy of {SPINUP_START}/): {year_s:.1f} s with the model's build "
        f"and the graphs' capture, the row's wall_s {row['wall_s']} s, "
        f"{86400.0 / year_s:.0f} simulated years a day; the wrappers' "
        f"launches over it (the captures and the capture's warm-up "
        f"segment) {json.dumps(launches)}")
    say(f"  row: {json.dumps(row)}")
    bad = spinup_out_of_limits(row, golden)
    nearest = max(((abs(row[k] - golden['row'][k]) / lim, k)
                   for k, lim in golden["limit"].items()
                   if not isinstance(lim, list)), default=(0.0, None))
    say(f"  held against {SPINUP_GOLDEN} ({golden['limit_rule']}): "
        f"{len(golden['limit'])} keys, out of limits {json.dumps(bad)}; "
        f"nearest its limit {nearest[1]} at {nearest[0]:.2f} of it")
    if len(rows) != 1 or list(row) != golden["keys"] or bad \
            or min(launches.values()) == 0:
        raise AssertionError(f"spin-up year: {len(rows)} rows, keys "
                             f"{list(row)}, out of limits {bad}")
    with open(os.path.join(work, "restart_meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(work, "restart.npz")) as d:
        nkeys = len(d.files)
    say(f"  restart_meta.json {json.dumps(meta)}; restart.npz with {nkeys} "
        "fields")
    if meta["year"] != 1061 or meta["accel"] != ACCEL:
        raise AssertionError(f"spin-up: restart_meta.json {meta}")

    # the second --resume, one segment for its year
    loop = spinup.run_years
    spinup.run_years = lambda *a, **k: loop(*a, seg_per_year=1, **k)
    try:
        spinup.main(["1"] + args)
    finally:
        spinup.run_years = loop
    with open(log) as f:
        rows = [json.loads(line) for line in f]
    with open(os.path.join(work, "restart_meta.json")) as f:
        meta2 = json.load(f)
    say(f"  a second --resume (one segment): row year {rows[-1]['year']}, "
        f"restart_meta.json {json.dumps(meta2)}")
    if len(rows) != 2 or rows[-1]["year"] != 1062 \
            or meta2["relyr"] <= meta["relyr"]:
        raise AssertionError("spin-up: the second --resume did not start "
                             "from the first's year")
    shutil.rmtree(work)
    torch.cuda.empty_cache()
    return dict(year_s=year_s, wall_s=row["wall_s"], launches=launches,
                row=row)


def cpts_small_config(cfg):
    """tests/test_cpts.py::test_coupled_cpts_segments's configuration
    from a ``small_config()`` of either package."""
    return cfg.replace(
        ocean=dataclasses.replace(
            cfg.ocean, isopycmix=False, gent_mcwilliams=False,
            dtts=43200.0, dtuv=1800.0, dtsf=1800.0, tolrsf=1e8),
        ice=dataclasses.replace(cfg.ice, cpts=3, nlay=4))


def cpts_small_initial_t(grid, tmask):
    """test_coupled_cpts_segments's initial temperature, salinity 0."""
    import numpy as np
    g = grid
    t0 = np.zeros((2, g.km, g.jmt, g.imt))
    lat = np.broadcast_to(g.yt[:, None], (g.jmt, g.imt))
    sst = np.maximum(29.0 * np.cos(np.deg2rad(lat)) ** 2 - 1.93, -1.93)
    t0[0] = np.where(np.abs(lat)[None] > 60, -1.93,
                     sst[None] * np.exp(-np.asarray(g.zt) / 800e2)
                     [:, None, None])
    return t0 * np.asarray(tmask)


def field_gap(got, ref):
    """max |got - ref| over max |ref| (0 where both are all zero)."""
    import numpy as np
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = float(np.abs(got - ref).max())
    scale = float(np.abs(ref).max())
    return err / scale if scale > 0 else (0.0 if err == 0 else np.inf)


def port_cg_trips(m, state, nseg):
    """``nseg`` eager segments of the port's coupled model ``m`` from
    ``state``: the end state and the barotropic CG's trips of each ocean
    step (``seg_cg_iters``)."""
    trips = []
    for _ in range(nseg):
        state = m.run(state, 1, eager=True)
        trips += m.seg_cg_iters.tolist()
    return state, trips


def cpts_float32(device="cuda"):
    """The multi-category ice run of CPTS_GOLDEN, the port in float32 on
    ``device`` against the port in float64 on the CPU, both eager with
    the barotropic CG's trips read back: each field's gap against its
    limit.  The barotropic fields (CPTS_BAROTROPIC) are held unless a
    solve took another number of trips in float32 than in float64.
    Returns the gaps, the fields out of limits, each field's share of
    its limit, the trips of each precision and the ocean steps whose
    trips differ."""
    import numpy as np
    from uvic_tpu_torch.config import small_config
    from uvic_tpu_torch.convert import coupled_state_to_numpy
    from uvic_tpu_torch.coupler.driver import CoupledModel
    with open(CPTS_GOLDEN) as f:
        golden = json.load(f)
    states, trips = {}, {}
    for dtype, dev in (("float64", "cpu"), ("float32", device)):
        m = CoupledModel(cpts_small_config(small_config()).replace(
            dtype=dtype), device=dev)
        t0 = cpts_small_initial_t(m.grid, m.topo.tmask)
        state, trips[dtype] = port_cg_trips(m, m.init_state(t0),
                                            golden["segments"])
        states[dtype] = coupled_state_to_numpy(state)
    r64, r32 = states["float64"], states["float32"]
    flips = [n + 1 for n, (a, b) in enumerate(zip(trips["float32"],
                                                  trips["float64"]))
             if a != b]
    exempt = CPTS_BAROTROPIC if flips else ()
    gaps = {k: field_gap(r32[k], r64[k]) for k in golden["limit"]}
    share = {k: g / golden["limit"][k] for k, g in gaps.items()}
    bad = {k: (g, golden["limit"][k]) for k, g in gaps.items()
           if not share[k] <= 1.0 and k not in exempt}
    bad.update({k: (r32[k].tolist(), r64[k].tolist())
                for k in golden["equal"]
                if not np.array_equal(r32[k], r64[k])})
    return gaps, bad, share, trips, flips


def spinup_options_phase():
    """Phase 9: the spin-up's deep acceleration (the kernels on its
    inputs, eager against replayed, a spin-up year through
    ``uvic_tpu_torch.spinup``), each remaining coupled option eager
    against replayed (brine convection with the apply held on its three
    convections), and the multi-category ice in float32."""
    import torch
    from uvic_tpu_torch.ops.convection import (apply_region_means,
                                               apply_region_means_ref)
    out = {}
    say(f" (a) the spin-up: earth_config(accel={ACCEL:g}) from "
        f"{EARTH_RESTART}")
    t0 = time.perf_counter()
    m, start = earth_option_model(accel=ACCEL)
    dtxcel = m.ocean.g.dtxcel
    say(f"  built in {time.perf_counter() - t0:.1f} s; dtxcel by level "
        f"{[round(float(x), 3) for x in dtxcel]}")
    seen = earth_capture(m, start)
    twodt = seen["tracer"][0][10]
    say(f"  the tracer step's twodt_k: min {float(twodt.min()):.1f} s, max "
        f"{float(twodt.max()):.1f} s ({twodt.numel()} levels)")
    if not float(twodt.max()) > float(twodt.min()):
        raise AssertionError("accelerated twodt_k is the same on every "
                             "level")
    say(" fct_tracer_step, earth accel")
    out["tracer"] = check_tracer(m.ocean, seen, "earth accel tracer step")
    say(" apply_region_means, earth accel (M from dzt / dtxcel)")
    out["convect"] = check_convect(seen)
    say(" congrad, earth accel")
    out["cg"] = check_cg(m.ocean, seen)
    del seen
    out["accel"] = eager_against_replayed(m, start, EARTH_ACCEL_SEGMENTS,
                                          f"accel {ACCEL:g}")
    del m, start
    torch.cuda.empty_cache()
    out["year"] = spinup_year()

    say(f" (b) the coupled options, each from {EARTH_RESTART}, "
        f"{EARTH_OPTION_SEGMENTS} segments eager and replayed")
    out["options"] = {}
    for name, (section, change) in EARTH_OPTIONS.items():
        t0 = time.perf_counter()
        m, start = earth_option_model(section, change)
        say(f"  {name} ({section} {json.dumps(change)}): built in "
            f"{time.perf_counter() - t0:.1f} s")
        per_step = None
        if name == "convect_brine":
            seen = earth_capture(m, start)
            calls = len(seen["convect_calls"])
            say(f"  an ocean step's convections: {calls}")
            if calls != BRINE_CONVECTIONS:
                raise AssertionError(f"brine: {calls} convections a step")
            for n, args in enumerate(seen["convect_calls"][:-1]):
                ts, mnorm, ocean, _ = convect_inputs({"convect": args})
                got = apply_region_means(ts, mnorm, ocean)
                ref = apply_region_means_ref(ts, mnorm, ocean)
                worst, _ = say_errors(
                    [inc_err(got[i], ref[i], ts[i])
                     for i in range(got.shape[0])], TOL_CONVECT)
                if not worst <= TOL_CONVECT:
                    raise AssertionError(f"brine convection {n}: err / "
                                         f"increment {worst}")
            say(" apply_region_means, earth brine (the ice category's "
                "convection, timed)")
            out["brine_convect"] = check_convect(seen)
            del seen
            per_step = {"apply_region_means": BRINE_CONVECTIONS}
        out["options"][name] = eager_against_replayed(
            m, start, EARTH_OPTION_SEGMENTS, name, per_step)
        if name == "convect_brine":
            key = ("ocean", True)
            captured = m._graphs.captured[key]["apply_region_means"]
            say(f"  the leapfrog ocean graph holds {captured} launches of "
                "the apply")
            if captured != BRINE_CONVECTIONS:
                raise AssertionError(f"brine graph: {captured} applies")
        del m, start
        torch.cuda.empty_cache()

    say(f" (c) the multi-category ice in float32: {CPTS_GOLDEN}'s run, the "
        "port in float32 on the card against float64 on the CPU")
    gaps, bad, share, trips, flips = cpts_float32()
    say("  gaps " + json.dumps({k: float(f"{g:.3e}")
                                for k, g in gaps.items()}))
    say(f"  barotropic CG trips by ocean step, float32 on the card "
        f"{trips['float32']}, float64 on the CPU {trips['float64']}; "
        f"steps whose trips differ (from 1) {flips}")
    held = {k: v for k, v in share.items()
            if not flips or k not in CPTS_BAROTROPIC}
    worst = max(held, key=held.get)
    say(f"  largest share of a limit {held[worst]:.2f} ({worst}); out of "
        f"limits {json.dumps(bad)}; the barotropic fields at "
        + json.dumps({k: round(share[k], 2) for k in CPTS_BAROTROPIC})
        + " of their limits, "
        + ("not held: a solve's stop fell on the other side of tolrsf "
           "(CPTS_BAROTROPIC)" if flips else "held"))
    if bad:
        raise AssertionError(f"cpts float32: out of limits {bad}")
    out["cpts_share"] = share
    return out


def replayed_launches(g, replays0):
    """The kernel launches of the replays of ``g`` (a model's StepGraphs)
    since its replay counts were ``replays0``: each graph's replays
    counted by ``StepGraphs.run`` times the launches captured in it."""
    return {k: sum((g.replays[lf] - replays0[lf]) * g.captured[lf][k]
                   for lf in (True, False))
            for k in KERNEL_NAMES}


def port_restoring_row(m, weights, state, sst, sss, mid):
    """``restoring_row`` of a port model's state after a segment, against
    the climatology (TimeInterpField) at the segment's midpoint."""
    def host(x):
        return x.double().cpu().numpy()

    return restoring_row(weights, host(state.t), host(state.psi0),
                         host(sst(mid)), host(sss(mid)),
                         m.scan_cg_iters.cpu().numpy(), state.nconv)


def tool_gap(got, ref, scale):
    """max |got - ref| over max |scale| (NumPy or tensors)."""
    import numpy as np
    got, ref, scale = (np.asarray(x.double().cpu() if hasattr(x, "cpu")
                                  else x, np.float64)
                       for x in (got, ref, scale))
    return float(np.abs(got - ref).max() / max(np.abs(scale).max(), 1e-300))


def restoring_tools(m, state, smf):
    """Regions, stations, sections, zonal means and the transport-matrix
    extraction on the card's state against the same functions on a
    float64 CPU copy of it; returns the seconds the extraction took on
    the card and on the CPU."""
    import torch
    from uvic_tpu_torch.convert import (ocean_state_from_numpy,
                                        ocean_state_to_numpy)
    from uvic_tpu_torch.diag.regions import build_regions
    from uvic_tpu_torch.diag.sections import (XbtStations, cross_section,
                                              zonal_mean_sbc)
    from uvic_tpu_torch.diag.tmm import extract_matrices
    from uvic_tpu_torch.models.ocean.model import make_forcing, make_ocean
    g = m.params.grid
    t0 = time.perf_counter()
    m64 = make_ocean(m.cfg.replace(dtype="float64"), device="cpu")
    s64 = ocean_state_from_numpy(ocean_state_to_numpy(state), "cpu",
                                 torch.float64)
    smf64 = smf.double().cpu()
    say(f"  float64 CPU copy of the model and the state built in "
        f"{time.perf_counter() - t0:.1f} s")
    gaps = {}

    kmt = m.params.topo.kmt
    r32 = build_regions(g, kmt, dtype=m.cfg.np_dtype, device=m.device)
    r64 = build_regions(g, kmt, device="cpu")
    for n, name in enumerate(("T", "S")):
        got = r32.volume_mean(state.t[n])
        ref = r64.volume_mean(s64.t[n])
        gaps[f"regions {name}"] = ("regions", tool_gap(got, ref, s64.t[n]))
        say(f"  Regions.volume_mean({name}) by basin x layer "
            f"({', '.join(r64.hregnm)} x {', '.join(r64.vregnm)}): "
            f"{json.dumps(ref.tolist())}")

    cols = XbtStations(g).sample(state, m)
    cols64 = XbtStations(g).sample(s64, m64)
    for k in ("temp", "salt", "u", "v"):
        scale = [c[k] for c in cols64.values()]
        gaps[f"xbt {k}"] = ("xbt", tool_gap([c[k] for c in cols.values()],
                                            scale, scale))
    say(f"  XbtStations: {len(cols)} stations, n_atlantic temp "
        f"{cols['n_atlantic']['temp'][:3].tolist()} ...")
    for kw in (dict(lat=0.0), dict(lat=-60.0), dict(lon=330.0)):
        for n in range(2):
            got = cross_section(state.t[n], g, **kw)
            ref = cross_section(s64.t[n], g, **kw)
            gaps[f"section {n} {kw}"] = ("section", tool_gap(got, ref, ref))
    zm = zonal_mean_sbc(dict(sst=state.t[0, 0], sss=state.t[1, 0],
                             taux=smf[0]), m.tmask[0], g.dxt)
    zm64 = zonal_mean_sbc(dict(sst=s64.t[0, 0], sss=s64.t[1, 0],
                               taux=smf64[0]), m64.tmask[0], g.dxt)
    scales = dict(sst=s64.t[0, 0], sss=s64.t[1, 0], taux=smf64[0])
    for k in zm:
        gaps[f"zonal {k}"] = ("zonal", tool_gap(zm[k], zm64[k], scales[k]))

    forcing = make_forcing(smf, torch.zeros_like(state.t[:, 0]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    aexp, aimp, tiles = extract_matrices(m, state, forcing, TMM_SPACING)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    aexp64, aimp64, _ = extract_matrices(
        m64, s64, make_forcing(smf64, s64.t[:, 0] * 0.0), TMM_SPACING)
    cpu_s = time.perf_counter() - t0
    say(f"  extract_matrices at spacing {TMM_SPACING}: {tiles.shape[0]} "
        f"tiles of {tuple(tiles.shape[1:])} in one tracer step, "
        f"{aimp.shape[0]} sheets in one invtri: {card_s:.2f} s on the card "
        f"(float32, with the copy to the host), {cpu_s:.2f} s on the CPU "
        f"(float64)")
    gaps["tmm Aexp"] = ("tmm_exp", tool_gap(aexp, aexp64, aexp64))
    gaps["tmm Aimp"] = ("tmm_imp", tool_gap(aimp, aimp64, aimp64))
    for name, (kind, gap) in gaps.items():
        say(f"  {name}: max |card - float64 CPU| / scale {gap:.3e} "
            f"(tolerance {TOL_TOOLS[kind]:g})")
        if not gap <= TOL_TOOLS[kind]:
            raise AssertionError(f"tooling: {name} {gap} > "
                                 f"{TOL_TOOLS[kind]}")
    del m64, s64
    return card_s, cpu_s


def restoring_phase(earth):
    """Phase 10: the ocean-only restoring run of the flagship, its
    tooling, and the bisector on phase 6's earth model.  Returns the
    kernel checks on a restoring step's inputs, the launch counts and the
    times."""
    import numpy as np
    import torch
    from uvic_tpu_torch.debug import bisect_segment, nan_report
    from uvic_tpu_torch.entry import _flagship
    from uvic_tpu_torch.io.bcest import bcest_fields
    from uvic_tpu_torch.io.timeforce import (TimeInterpField,
                                             default_surface_climatology)
    from uvic_tpu_torch.models.ocean.graphs import KERNEL_WRAPPERS
    from uvic_tpu_torch.models.ocean.model import make_forcing
    with open(RESTORING_GOLDEN) as f:
        golden = json.load(f)
    t0 = time.perf_counter()
    m, start, forcing = _flagship()
    g = m.params.grid
    smf = forcing.smf
    sst, sss = default_surface_climatology(g, dtype=m.cfg.np_dtype,
                                           device=m.device)
    seg = RESTORING_SEG_DAYS / RESTORING_YRLEN
    nsteps = max(1, round(RESTORING_SEG_DAYS * 86400.0 / m.cfg.ocean.dtts))
    say(f"  flagship built and primed in {time.perf_counter() - t0:.1f} s; "
        f"a {RESTORING_SEG_DAYS:g}-day segment is {nsteps} steps (dtts "
        f"{m.cfg.ocean.dtts:g} s), itt {start.itt}")
    if nsteps != 24:
        raise AssertionError(f"restoring: {nsteps} steps a segment")

    def seg_forcing(state, sst_f, mid):
        """The forcing run_restoring gives a segment's steps."""
        return m.apply_restoring(
            make_forcing(smf, torch.zeros_like(forcing.stf), relyr=mid),
            state, sst_f, sss, relyr=mid)

    say(" kernels on the inputs of a restoring step (the seasonal "
        "climatology at the first segment's midpoint, phase 2's noise on T "
        "and S)")
    noisy = perturbed(m, start)
    _, seen = capture_step(m, noisy, seg_forcing(noisy, sst, 0.5 * seg))
    stf = seen["tracer"][0][7]
    nonzero = [int((stf[n] != 0).sum()) for n in range(2)]
    say(f"  the tracer step's stf: {nonzero} non-zero cells in the T and S "
        f"rows, |stf| max {float(stf[0].abs().max()):.3e} (T), "
        f"{float(stf[1].abs().max()):.3e} (S)")
    if min(nonzero) == 0:
        raise AssertionError("restoring: a row of stf is zero")
    out = dict(tracer=check_tracer(m, seen, "restoring tracer step"),
               convect=check_convect(seen), cg=check_cg(m, seen))

    say(f" the restoring year: {RESTORING_SEGMENTS} segments through "
        "OceanModel.run_restoring, one call a segment")
    for w in KERNEL_WRAPPERS.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = m.run_restoring(start, smf, sst, sss, nseg=1,
                            seg_days=RESTORING_SEG_DAYS, relyr0=0.0,
                            yrlen=RESTORING_YRLEN)
    torch.cuda.synchronize()
    graphs = m._graphs
    launched = {k: w.launches for k, w in KERNEL_WRAPPERS.items()}
    say(f"  first segment {time.perf_counter() - t0:.2f} s with the capture; "
        f"the wrappers' launches over it (the capture's warm-up steps and "
        f"the captures) {json.dumps(launched)}; replays by step type "
        f"(leapfrog, mixing) {graphs.replays[True]}, {graphs.replays[False]}")
    say_graphs(m, "restoring")
    # the warm-up takes one step of each type, the captures another: any
    # launch beyond them would be an eager step inside the segment
    outside = {k: launched[k] - 2 * (graphs.captured[True][k]
                                     + graphs.captured[False][k])
               for k in KERNEL_WRAPPERS}
    out["run_counts"] = replayed_launches(graphs, {True: 0, False: 0})
    if any(outside.values()) \
            or graphs.replays[True] + graphs.replays[False] != nsteps \
            or any(c != nsteps for c in out["run_counts"].values()):
        raise AssertionError(f"restoring: the first segment launched "
                             f"{json.dumps(outside)} outside the captures "
                             f"and {json.dumps(out['run_counts'])} by replay")
    _, eager_ms, out["eager_counts"] = scan_vs_eager(
        m, start, seg_forcing(start, sst, 0.5 * seg), nsteps,
        "restoring segment 1")
    diff = same_state(first, m.run_scan(start, seg_forcing(start, sst,
                                                           0.5 * seg),
                                        nsteps))
    say(f"  run_restoring's first segment against run_scan on the same "
        f"forcing: max |diff| {diff:.3e} (bitwise required); launches by "
        f"the segment's replays {json.dumps(out['run_counts'])}")
    if diff != 0.0:
        raise AssertionError("restoring: the first segment's replay differs "
                             "from the eager steps")

    warm = TimeInterpField(sst.records.cpu().numpy() + RESTORING_WARMER,
                           centers=sst.centers.cpu().numpy(),
                           dtype=m.cfg.np_dtype, device=m.device)
    old = m.run_restoring(first, smf, sst, sss, nseg=1,
                          seg_days=RESTORING_SEG_DAYS, relyr0=seg,
                          yrlen=RESTORING_YRLEN)
    new = m.run_restoring(first, smf, warm, sss, nseg=1,
                          seg_days=RESTORING_SEG_DAYS, relyr0=seg,
                          yrlen=RESTORING_YRLEN)
    wet = m.tmask[0] > 0
    dsst = (new.t[0, 0] - old.t[0, 0])[wet]
    say(f"  segment 2 under a climatology {RESTORING_WARMER:g} K warmer, on "
        f"the same graphs: SST moved by {float(dsst.mean()):.4f} K on "
        f"average (min {float(dsst.min()):.4f}, max "
        f"{float(dsst.max()):.4f})")
    if not float(dsst.mean()) > 0.0:
        raise AssertionError("restoring: the graphs did not follow the new "
                             "climatology")
    scan_vs_eager(m, first, seg_forcing(first, warm, 1.5 * seg), nsteps,
                  "segment 2, warmer climatology")

    weights = restoring_weights(g, m.tmask.cpu().numpy())

    def year_row(state, mid):
        if not rows_done and same_state(state, first) != 0.0:
            raise AssertionError("restoring: the year's first segment "
                                 "differs from the first replay")
        rows_done.append(mid)
        return port_restoring_row(m, weights, state, sst, sss, mid)

    rows_done = []
    replays0 = dict(graphs.replays)
    launches0 = {k: w.launches for k, w in KERNEL_WRAPPERS.items()}
    rows, seg_s, state, relyr = restoring_year_rows(
        m, start, smf, sst, sss, year_row,
        lambda _: torch.cuda.synchronize())
    year_counts = replayed_launches(graphs, replays0)
    eager = {k: w.launches - launches0[k]
             for k, w in KERNEL_WRAPPERS.items()}
    say(f"  the year's launches by replay {json.dumps(year_counts)}, "
        f"outside the graphs {json.dumps(eager)}")
    if m._graphs is not graphs or any(eager.values()) \
            or any(c != RESTORING_SEGMENTS * nsteps
                   for c in year_counts.values()):
        raise AssertionError("restoring: the year did not replay the first "
                             "segment's graphs alone")
    check_finite(state, "the restoring year")
    year_s = sum(seg_s)
    say(f"  segments {', '.join(f'{1e3 * s:.1f}' for s in seg_s)} ms; the "
        f"year {year_s:.3f} s ({86400.0 / year_s:.0f} simulated years a "
        f"day; {1e3 * statistics.median(seg_s) / nsteps:.3f} ms a step)")
    for n, row in enumerate(rows):
        say(f"  segment {n + 1}: {json.dumps(row)}")
    worst, failed = restoring_gaps(rows, golden)
    say(f"  held against {RESTORING_GOLDEN} ({golden['limit_rule']}); each "
        "key's largest share of its limit (share, gap, segment): "
        + json.dumps({k: [round(v[0], 4), v[1], v[2]]
                      for k, v in worst.items()}))
    if failed:
        raise AssertionError(f"restoring year out of limits: {failed}")

    bstate = m.run_restoring(state, smf, nseg=1,
                             seg_days=RESTORING_SEG_DAYS, relyr0=relyr,
                             yrlen=RESTORING_YRLEN, climatology="bcest")
    check_finite(bstate, "the bcest segment")
    b = bcest_fields(g)
    brow = restoring_row(weights, bstate.t.double().cpu().numpy(),
                         bstate.psi0.double().cpu().numpy(), b["sst"],
                         (b["sss"] - 35.0) / 1000.0,
                         m.scan_cg_iters.cpu().numpy(), bstate.nconv)
    say(f"  one bcest segment after the year: {json.dumps(brow)}")

    say(" the tooling on the year's final state, against a float64 CPU "
        "copy")
    out["tmm_card_s"], out["tmm_cpu_s"] = restoring_tools(m, state, smf)

    say(" the bisector (uvic_tpu_torch.debug) on phase 6's earth model")
    em, estart = earth["model"], earth["start"]
    t0 = time.perf_counter()
    res = bisect_segment(em, estart)
    say(f"  the restart's state: ok {res['ok']}, phase {res['phase']} "
        f"({time.perf_counter() - t0:.1f} s, eager)")
    hice = estart.ice.hice.clone()
    j, i = np.unravel_index(int(hice.argmax()), tuple(hice.shape))
    hice[j, i] = float("nan")
    bad = dataclasses.replace(estart, ice=dataclasses.replace(estart.ice,
                                                              hice=hice))
    rep = nan_report(bad)
    res_bad = bisect_segment(em, bad)
    say(f"  hice[{j}, {i}] set to NaN: nan_report {rep}; bisect ok "
        f"{res_bad['ok']}, phase {res_bad['phase']!r}, detail "
        f"{res_bad['detail']}")
    if not res["ok"] or res_bad["ok"] \
            or res_bad["phase"] != "atm_ice substep 0" \
            or [k for k, _, _ in rep] != ["stateice/hice"]:
        raise AssertionError(f"bisector: {res} {res_bad} {rep}")
    out.update(eager_ms=eager_ms, year_s=year_s,
               seg_ms=1e3 * statistics.median(seg_s),
               year_counts=year_counts)
    return out


def option_launches(m):
    """Launches of each kernel one step of the model makes: B1 where the
    step takes the fused tracer step, B3 under full convection, B2
    always (one solve a step)."""
    return {"fct_tracer_step": int(m.fused_tracer),
            "apply_region_means": int(m.cfg.ocean.convection == "full"),
            "congrad": 1}


def capture_option_step(m, state, forcing, leapfrog):
    """One step of an option model (run_scan's semantics, no
    Euler-backward) with the kernel wrappers' arguments recorded:
    ``tracer`` and ``convect`` as ``capture_step``, and ``cg`` the list
    of (solver, arguments) of every barotropic solve."""
    import uvic_tpu_torch.models.ocean.model as model_mod
    from uvic_tpu_torch.ops.cg_kernel import CGSolver
    seen = {"convect_calls": [], "cg": []}
    tracer, convect, call = (model_mod.fct_tracer_step,
                             model_mod.convct_full, CGSolver.__call__)

    def rec_tracer(*a, **k):
        seen["tracer"] = (a, k)
        return tracer(*a, **k)

    def rec_convect(*a):
        seen["convect"] = a
        seen["convect_calls"].append(a)
        return convect(*a)

    def rec_call(solver, *a):
        seen["cg"].append((solver, a))
        return call(solver, *a)

    model_mod.fct_tracer_step = rec_tracer
    model_mod.convct_full = rec_convect
    CGSolver.__call__ = rec_call
    try:
        state = m._step(state, forcing, leapfrog=leapfrog, scan=True)
    finally:
        model_mod.fct_tracer_step = tracer
        model_mod.convct_full = convect
        CGSolver.__call__ = call
    return state, seen


def solution_projection(m):
    """The projection the model's step applies to a barotropic solution,
    which removes what the operator leaves undetermined: the checkerboard
    of the 9-point streamfunction operator (tropic_step's deflation), the
    checkerboard and the mean of the rigid lid's (checkerboard_remove,
    zero_level); None where the operator determines the solution."""
    import torch
    from uvic_tpu_torch.ops.solvers import border
    g, cyc = m.g, m.cyclic
    if m.sp_mode:
        if m.barotropic != "surface_pressure":
            return None
        from uvic_tpu_torch.models.ocean.surfpress import (
            checkerboard_remove, zero_level)
        return lambda x: border(zero_level(
            border(checkerboard_remove(x, m.sp_omask), cyc), m.sp_omask,
            g.dxt, g.dyt, g.cst), cyc)
    if m.cfg.ocean.sf_npt != 9:
        return None
    from uvic_tpu_torch.models.ocean.tropic import checkerboard_weights
    w = checkerboard_weights(*m.cf_unit.shape[-2:], m.dtype, m.device)
    return lambda x: x - (torch.sum(x * w) / torch.sum(w * w)) * w


def check_cg_solve(solver, args, label, project=None):
    """One captured barotropic solve of any operator (the unit operator
    with 1/c2dtsf, or a step's whole operator called with c2dtsf 1): the
    kernel against its plain version, and the iterations of both from the
    captured guess and from zero.  Where the operator has a null space
    beyond the constant the CG deflates, the two solutions are compared
    after ``project``, the step's own removal of it (the raw gap is
    printed too)."""
    import torch
    from uvic_tpu_torch.ops.cg_kernel import (congrad_cuda, congrad_launch,
                                              congrad_ref)
    guess, forc, c2dtsf, tol = args
    jmt, imt = guess.shape
    iters = {}
    for case, g0 in (("warm", guess), ("zero", torch.zeros_like(guess))):
        got, info = congrad_launch(solver, g0, forc, c2dtsf, tol)
        ref, it_ref = congrad_ref(solver.cf_unit, solver.isl, g0, forc,
                                  c2dtsf, tol, solver.max_iter,
                                  solver.cyclic)
        torch.cuda.synchronize()
        it_got, ctas, it_ref = int(info[0]), int(info[1]), int(it_ref)
        raw = ""
        if project is not None:
            raw = f" (before the step's projection {rel_err(got, ref)[0]:.3e})"
            got, ref = project(got), project(ref)
        err, rel = rel_err(got, ref)
        limit = max(TOL_CG_TOLRSF * tol,
                    TOL_CG_REL * float(ref.abs().max()))
        say(f"  {label}, {case} guess: {solver.isl.nisle} islands, c2dtsf "
            f"{c2dtsf:g}; dpsi max abs err {err:.3e}{raw} (rel {rel:.3e}, "
            f"tol {tol:.1e}, limit {limit:.3e}); iterations kernel "
            f"{it_got}, plain {it_ref}")
        if not err <= limit:
            raise AssertionError(f"{label}: err {err} > {limit}")
        if not abs(it_got - it_ref) <= max(3, 0.1 * it_ref):
            raise AssertionError(f"{label}: iterations {it_got} vs {it_ref}")
        if not (it_got < solver.max_iter or it_ref >= solver.max_iter):
            raise AssertionError(f"{label}: the CG kernel did not converge "
                                 "where its plain version did")
        iters[case] = (it_got, it_ref)
        if case == "warm":
            err_warm, cluster = err, ctas

    def kernel():
        return congrad_cuda(solver, guess, forc, c2dtsf, tol)

    ms = cuda_time_ms(kernel)
    dev_ms = device_ms(kernel)
    plain_ms = cuda_time_ms(
        lambda: congrad_ref(solver.cf_unit, solver.isl, guess, forc, c2dtsf,
                            tol, solver.max_iter, solver.cyclic), n=5, warm=1)
    plane = jmt * imt
    nbytes = 4 * (9 + 1 + 1 + 2 + 1) * plane
    b_ms, b_by = bound(nbytes, 48.0 * plane * iters["warm"][0])
    say(f"  {label}: {ms:.4f} ms, device time {dev_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}")
    return dict(name="congrad", max_abs_err=err_warm, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, bytes=nbytes, device_ms=dev_ms,
                cluster=cluster, iters=iters["warm"][0],
                iters_zero=iters["zero"][0], c2dtsf=float(c2dtsf))


def check_option_kernels(m, state, forcing, label):
    """The kernels of one option model's path held against their plain
    versions on the inputs of a leapfrog and a mixing step from the state
    with phase 2's noise: B1 and B3 where the path runs them (and not
    launched where it does not), B2 on each distinct operator."""
    want = option_launches(m)
    noisy = perturbed(m, state)
    _, seen = capture_option_step(m, noisy, forcing, True)
    _, seen_mix = capture_option_step(m, noisy, forcing, False)
    out = {}
    for key, got in (("fct_tracer_step", "tracer" in seen),
                     ("apply_region_means", "convect" in seen)):
        if got != bool(want[key]):
            raise AssertionError(f"{label}: {key} called {got}, expected "
                                 f"{bool(want[key])}")
    if want["fct_tracer_step"]:
        say(f" {label}: fct_tracer_step")
        out["tracer"] = check_tracer(m, seen, f"{label} tracer step")
    if want["apply_region_means"]:
        say(f" {label}: apply_region_means")
        out["convect"] = check_convect(seen)
    solves = [("leapfrog", seen["cg"]), ("mixing", seen_mix["cg"])]
    done = {}
    for kind, calls in solves:
        if len(calls) != 1:
            raise AssertionError(f"{label} {kind}: {len(calls)} solves")
        solver, args = calls[0]
        if id(solver) in done:
            say(f"  {label}: the {kind} step solves with the "
                f"{done[id(solver)]} step's operator")
            continue
        done[id(solver)] = kind
        out["cg" if kind == "leapfrog" else "cg_mixing"] = check_cg_solve(
            solver, args, f"{label} congrad, {kind} operator",
            solution_projection(m))
    for k in out.values():
        k.pop("per_call_fn", None)
    return out


def option_model_phase(name, spec):
    """Phase 12 for one option model: the flagship with ``spec``'s
    options, its kernels against their plain versions, an
    Euler-backward mixing step's launches, run_scan against the same
    steps taken eagerly (bitwise) with its graphs' launches, and every
    field finite."""
    import gc
    import torch
    from uvic_tpu_torch.entry import _flagship
    from uvic_tpu_torch.ops.cg_kernel import congrad_launch
    from uvic_tpu_torch.ops.convection import apply_region_means
    from uvic_tpu_torch.ops.tracer_kernel import fct_tracer_step
    t0 = time.perf_counter()
    m, state, forcing = _flagship(ocean=spec["ocean"], grid=spec.get("grid"))
    g = m.params.grid
    say(f" {name}: {g.imt}x{g.jmt}x{g.km}, {m.dtype}, options "
        f"{json.dumps(spec)}; built and primed in "
        f"{time.perf_counter() - t0:.1f} s")
    for _ in range(N_WARM):
        state = m.step(state, forcing, leapfrog=True)
    want = option_launches(m)
    out = check_option_kernels(m, state, forcing, name)
    counts = {}
    if m.cfg.ocean.eb:
        fct_tracer_step.launches = 0
        apply_region_means.launches = 0
        congrad_launch.launches = 0
        eb = m.step(dataclasses.replace(state, itt=m.cfg.ocean.nmix),
                    forcing, leapfrog=False)
        torch.cuda.synchronize()
        counts["eb_mixing_step"] = {
            "fct_tracer_step": fct_tracer_step.launches,
            "apply_region_means": apply_region_means.launches,
            "congrad": congrad_launch.launches}
        say(f"  {name}: an Euler-backward mixing step launched "
            f"{json.dumps(counts['eb_mixing_step'])}")
        for k, c in counts["eb_mixing_step"].items():
            if c != 2 * want[k]:
                raise AssertionError(f"{name}: EB mixing step launched {k} "
                                     f"{c} times, {2 * want[k]} expected")
        check_finite(eb, f"{name} EB mixing step")
    # `run` over a leapfrog and a mixing step (Euler-backward where set)
    nmix = m.cfg.ocean.nmix
    fct_tracer_step.launches = 0
    apply_region_means.launches = 0
    congrad_launch.launches = 0
    ran = m.run(dataclasses.replace(state, itt=nmix - 1), forcing, 2)
    torch.cuda.synchronize()
    counts["run_two_steps"] = {
        "fct_tracer_step": fct_tracer_step.launches,
        "apply_region_means": apply_region_means.launches,
        "congrad": congrad_launch.launches}
    mix = 2 if m.cfg.ocean.eb else 1
    say(f"  {name}: run over itt {nmix - 1}..{nmix} launched "
        f"{json.dumps(counts['run_two_steps'])}")
    for k, c in counts["run_two_steps"].items():
        if c != (1 + mix) * want[k]:
            raise AssertionError(f"{name}: run launched {k} {c} times, "
                                 f"{(1 + mix) * want[k]} expected")
    check_finite(ran, f"{name} run")
    say(f"  {name}: run_scan, {N_SCAN} steps from itt {state.itt}; "
        f"launches a step {json.dumps(want)}")
    e, eager_ms, eager = scan_vs_eager(m, state, forcing, N_SCAN, name,
                                       per_step=want)
    counts["eager_per_step"] = {k: c // N_SCAN for k, c in eager.items()}
    captured = say_graphs(m, name, per_step=want)
    counts["run_per_step"] = {k: v["leapfrog"] for k, v in captured.items()}
    r, scan_ms = timed_scan(m, state, forcing, N_SCAN)
    if same_state(r, e) != 0.0:
        raise AssertionError(f"{name}: a second run_scan differs")
    check_finite(r, f"{name} run_scan")
    scan_iters = m.scan_cg_iters.tolist()
    # one restoring segment of OPTION_RESTORING_DAYS on the same graphs
    graphs, replays = m._graphs, sum(m._graphs.replays.values())
    rr = m.run_restoring(r, forcing.smf, nseg=1,
                         seg_days=OPTION_RESTORING_DAYS)
    torch.cuda.synchronize()
    nrest = sum(m._graphs.replays.values()) - replays
    say(f"  {name}: run_restoring, one {OPTION_RESTORING_DAYS:g}-day "
        f"segment: {nrest} replays of the same graphs "
        f"{m._graphs is graphs}")
    if m._graphs is not graphs or nrest != round(
            OPTION_RESTORING_DAYS * 86400.0 / m.cfg.ocean.dtts):
        raise AssertionError(f"{name}: run_restoring did not replay the "
                             "model's graphs")
    check_finite(rr, f"{name} run_restoring")
    ext = r.ubar if m.sp_mode else r.psi0
    say(f"  {name}: eager step {eager_ms:.3f} ms, replayed {scan_ms:.3f} ms;"
        f" CG iterations {scan_iters}; |t| max "
        f"{float(r.t.abs().max()):.4f}, |u| max {float(r.u.abs().max()):.4f},"
        f" |{'ubar' if m.sp_mode else 'psi'}| max "
        f"{float(ext.abs().max()):.4e}; {time.perf_counter() - t0:.1f} s")
    out.update(counts=counts, eager_ms=eager_ms, replay_ms=scan_ms)
    del m, state, r, e
    gc.collect()
    return out


def options_phase():
    """Phase 12: the option models at full width, then every option in
    phase 3's small form (the card's float32 against the CPU's float64),
    the rigid lid's B2 held against its plain version there."""
    res = {name: option_model_phase(name, spec)
           for name, spec in OPTION_MODELS.items()}
    say(" every option in the small form of phase 3 (34x40x8, the "
        "flagship physics and the option; card f32 vs CPU f64, a mixing "
        "step and 3 leapfrog steps)")
    small = {}
    for name, ocean in SMALL_OPTIONS.items():
        models = {}
        small[name] = small_reference(ocean, SMALL_GRID.get(name),
                                      label=name, models=models)
        if name in SMALL_KERNEL_CHECKS:
            m, s, f = models["cuda"]
            res[f"small_{name}"] = check_option_kernels(m, s, f,
                                                        f"small {name}")
    res["small"] = small
    return res



def sharded_rank(mesh, job, option_jobs):
    """Phase 13's rank: ``run_sharded`` on the card; rank 0 also returns
    the arguments of its last step's convection (B3's inputs on its
    block) and barotropic solve (B2's, replicated); then the earth
    segment and the option models (``option_jobs``, a job each)."""
    import torch
    import uvic_tpu_torch.parallel.shard_step as ss_mod
    seen = {}
    convect, tropic = ss_mod.convct_full, ss_mod.tropic_step

    def rec_convect(*a):
        seen["convect"] = a
        return convect(*a)

    def rec_tropic(*a, **k):
        a = list(a)
        solver = a[13]

        def rec_solver(*sa):
            seen["cg"] = sa
            return solver(*sa)
        a[13] = rec_solver
        return tropic(*a, **k)

    def inputs():
        out = {k: [x.cpu().numpy() if torch.is_tensor(x) else x
                   for x in v] for k, v in seen.items()}
        seen.clear()
        return out

    if mesh.rank == 0:
        ss_mod.convct_full, ss_mod.tropic_step = rec_convect, rec_tropic
    try:
        out = ss_mod.run_sharded(mesh, **job)
        out["inputs"] = inputs()
        out["earth"] = sharded_earth_rank(mesh)
        out["earth"]["inputs"] = inputs()
    finally:
        ss_mod.convct_full, ss_mod.tropic_step = convect, tropic
    out["options"] = sharded_option_ranks(mesh, option_jobs)
    out["multihost"] = multihost_single_launch(mesh)
    return out


@contextlib.contextmanager
def recorded_inputs(on=True):
    """Yields a dict that, when ``on``, receives the last inputs of the
    sharded step's convection (``"convect"``: B3's on the block, under
    full convection) and of every barotropic solve (``"cg"``: B2's,
    replicated, recorded at ``OceanModel.barotropic_solver``'s solver)
    made inside the block, as NumPy arrays once it ends."""
    import torch
    import uvic_tpu_torch.parallel.shard_step as ss_mod
    from uvic_tpu_torch.models.ocean.model import OceanModel
    seen = {}
    convect, solver_of = ss_mod.convct_full, OceanModel.barotropic_solver

    def rec_convect(*a):
        seen["convect"] = a
        return convect(*a)

    def rec_solver_of(model, leapfrog):
        solver, c2dtsf = solver_of(model, leapfrog)

        def rec_solver(*a):
            seen["cg"] = a
            return solver(*a)
        return rec_solver, c2dtsf

    if on:
        ss_mod.convct_full = rec_convect
        OceanModel.barotropic_solver = rec_solver_of
    try:
        yield seen
    finally:
        ss_mod.convct_full = convect
        OceanModel.barotropic_solver = solver_of
        for k, v in seen.items():
            seen[k] = [x.cpu().numpy() if torch.is_tensor(x) else x
                       for x in v]


def sharded_option_ranks(mesh, jobs):
    """Phase 13's option models on a rank: each job through
    ``run_sharded`` (its launch counters set to 0 before its steps);
    rank 0 also returns, for each, the arguments of its last step's
    convection (B3's on its block, under full convection) and its last
    barotropic solve (B2's, replicated: the streamfunction's or the
    surface pressure's, recorded at the model's solver)."""
    import torch
    import uvic_tpu_torch.parallel.shard_step as ss_mod
    out = {}
    for name, job in jobs.items():
        with recorded_inputs(mesh.rank == 0) as seen:
            out[name] = ss_mod.run_sharded(mesh, **job)
        out[name]["inputs"] = seen
        torch.cuda.empty_cache()
    return out


def sharded_earth_rank(mesh):
    """Phase 13's earth part on a rank: the earth model from
    EARTH_RESTART, one ``ShardedCoupledModel`` segment from the rank's
    block of its state, the launch counters set to 0 just before it and
    read just after; on rank 0 the gathered state and time means."""
    import torch
    from uvic_tpu_torch.coupler.driver import pack_state
    from uvic_tpu_torch.coupler.graphs import KERNEL_WRAPPERS
    from uvic_tpu_torch.entry import _earth
    from uvic_tpu_torch.parallel.shard_segment import (ShardedCoupledModel,
                                                       replicated_digest)
    t0 = time.perf_counter()
    m, start = _earth(EARTH_RESTART)
    sm = ShardedCoupledModel(m, mesh)
    block = sm.shard(start)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    for w in KERNEL_WRAPPERS.values():
        w.launches = 0
    ex0, msg0 = mesh.exchange_s, mesh.messages
    t1 = time.perf_counter()
    out = sm.run_segment(block)
    torch.cuda.synchronize()
    seg_s = time.perf_counter() - t1
    launches = {k: w.launches for k, w in KERNEL_WRAPPERS.items()}
    res = dict(build_s=build_s, seg_s=seg_s,
               exchange_s=mesh.exchange_s - ex0,
               messages=mesh.messages - msg0, launches=launches,
               digest=replicated_digest(out),
               cg_iters=sm.seg_cg_iters.cpu().numpy().tolist(),
               max_memory=torch.cuda.max_memory_allocated(),
               block=tuple(out.ocean.t.shape))
    whole = sm.gather(out, root=0)
    tavg = sm.gather_tavg(root=0)
    if whole is not None:
        res["state"] = {k: v.cpu().numpy()
                        for k, v in pack_state(whole).items()}
        res["tavg"] = {k: v.cpu().numpy() for k, v in tavg.items()}
        res["counters"] = (whole.ocean.itt, whole.atm.nats)
    return res


def sharded_earth_check(res):
    """Phase 13's earth part in the parent: the gathered state and time
    means of the ranks' segment against the unsharded eager segment on
    the generic tracer step (within TOL_SHARDED_EARTH of each field's
    scale; the gap from the default segment with B1 printed beside it),
    every rank's whole components bitwise alike (their digests), every
    rank's launches (B3 and B2 once an ocean step, B1 never), and B3 on
    rank 0's block and B2 on rank 0's replicated solve against their
    plain versions."""
    import numpy as np
    import torch
    from uvic_tpu_torch.coupler.driver import pack_state
    from uvic_tpu_torch.entry import _earth
    r0 = res[0]["earth"]
    n = len(res)
    em, start = _earth(EARTH_RESTART)
    say(f"  earth: {n} ranks built the earth model from {EARTH_RESTART} "
        f"(rank 0 {r0['build_s']:.1f} s) and ran one segment of "
        f"{em.ntspas} atmosphere and {em.ntspos} ocean steps on blocks "
        f"{r0['block']}; CG iterations by step {r0['cg_iters']}")

    def unsharded(fused):
        em.ocean.fused_tracer, saved = fused, em.ocean.fused_tracer
        try:
            out = em.run_segment(start)
        finally:
            em.ocean.fused_tracer = saved
        return ({k: v.cpu().numpy() for k, v in pack_state(out).items()},
                {k: v.cpu().numpy() for k, v in em.last_tavg.items()},
                (out.ocean.itt, out.atm.nats))

    def gaps(got, ref):
        if set(got) != set(ref):
            raise AssertionError("sharded earth: fields differ "
                                 f"{sorted(set(got) ^ set(ref))}")
        return {k: float(np.abs(got[k].astype(np.float64) - ref[k]).max()
                         / max(float(np.abs(ref[k]).max()), 1e-30))
                for k in ref}
    ref_state, ref_tavg, counters = unsharded(False)
    b1_state, b1_tavg, _ = unsharded(True)
    g_state = gaps(r0["state"], ref_state)
    g_tavg = gaps(r0["tavg"], ref_tavg)
    worst = max(list(g_state.values()) + list(g_tavg.values()))
    say(f"  earth: gathered state and time means against the unsharded "
        f"eager segment (generic tracer step), largest gap over a field's "
        f"scale {worst!r} (limit {TOL_SHARDED_EARTH}); nonzero: "
        + json.dumps({k: v for k, v in {**g_state, **{
            "tavg/" + k: v for k, v in g_tavg.items()}}.items() if v > 0}))
    say("  ... against the default unsharded segment (B1): largest gap "
        "by field " + json.dumps({k: v for k, v in sorted(
            {**gaps(r0["state"], b1_state), **{
                "tavg/" + k: v for k, v in gaps(r0["tavg"],
                                                b1_tavg).items()}}.items(),
            key=lambda kv: -kv[1])[:8]}))
    if not worst <= TOL_SHARDED_EARTH:
        raise AssertionError(f"sharded earth segment: gap {worst} > "
                             f"{TOL_SHARDED_EARTH}")
    if tuple(r0["counters"]) != tuple(counters):
        raise AssertionError(f"sharded earth counters {r0['counters']} "
                             f"against {counters}")
    digests = {r["earth"]["digest"] for r in res}
    if len(digests) != 1:
        raise AssertionError(f"sharded earth: the ranks' whole components "
                             f"differ ({len(digests)} digests)")
    want = {"fct_tracer_step": 0, "apply_region_means": em.ntspos,
            "congrad": em.ntspos}
    for rank, r in enumerate(res):
        if r["earth"]["launches"] != want:
            raise AssertionError(f"sharded earth: rank {rank} launched "
                                 f"{r['earth']['launches']}, the path "
                                 f"{want}")
    say(f"  earth: atmosphere, ice, land and barotropic fields bitwise "
        f"equal on all {n} ranks (one digest); launches on every rank "
        f"{json.dumps(want)}")
    timing = dict(segment_ms=1e3 * r0["seg_s"],
                  exchange_ms=1e3 * r0["exchange_s"],
                  messages=r0["messages"],
                  max_memory_gb=r0["max_memory"] / 2**30)
    say(f"  earth: {n} ranks sharing one H100 (a check of the machinery, "
        f"not a speed-up): rank 0's segment {timing['segment_ms']:.1f} ms, "
        f"{timing['exchange_ms']:.1f} ms of it in messages, host staging "
        f"and the waits inside them ({r0['messages']} messages); rank 0's "
        f"peak allocated memory {timing['max_memory_gb']:.2f} GiB; "
        f"{card_line()}")

    def cuda(v):
        return tuple(torch.as_tensor(x, device="cuda")
                     if isinstance(x, np.ndarray) else x for x in v)
    say(" apply_region_means on rank 0's earth block (its last ocean "
        "step's inputs)")
    k_convect = check_convect({"convect": cuda(r0["inputs"]["convect"])})
    say(" congrad on rank 0's replicated earth solve (its last ocean "
        "step's inputs)")
    k_cg = check_cg_solve(em.ocean.cg_solver, cuda(r0["inputs"]["cg"]),
                          "sharded earth rank 0")
    for k in (k_convect, k_cg):
        k.pop("per_call_fn", None)
        say_kernel("sharded earth rank 0", k)
    return dict(convect=k_convect, cg=k_cg, timing=timing,
                gap=worst, launches=[r["earth"]["launches"] for r in res])


def sharded_phase(m, state, forcing):
    """Phase 13: the flagship on SHARDED_MESH's eight ranks of one card,
    against the unsharded step; B3 and B2 on rank 0's inputs against
    their plain versions; then, in the same ranks, the earth segment
    (``sharded_earth_check``), the option models
    (``sharded_option_check``) and phase 15's single launch
    (``multihost_single_launch``).  Returns the kernel checks, the
    ranks' launch counts and rank 0's single launch."""
    import numpy as np
    import torch
    from uvic_tpu_torch.convert import ocean_state_to_numpy
    from uvic_tpu_torch.parallel.launch import spawn
    start = perturbed(m, state)
    fields = ("t", "tm1", "u", "um1", "psi0", "psi1", "ptd", "ptdb")

    def unsharded(fused):
        m.fused_tracer, saved = fused, m.fused_tracer
        try:
            s = start
            for lf in SHARDED_SCHEDULE:
                s = m._step(s, forcing, leapfrog=lf)
        finally:
            m.fused_tracer = saved
        return ocean_state_to_numpy(s)
    ref, ref_fused = unsharded(False), unsharded(True)
    job = sharded_job(m, start, forcing, SHARDED_SCHEDULE)
    t0 = time.perf_counter()
    options = sharded_option_references()
    say(f"  the option models built, with their unsharded steps, in "
        f"{time.perf_counter() - t0:.1f} s")
    n = SHARDED_MESH[0] * SHARDED_MESH[1]
    t0 = time.perf_counter()
    res = spawn(sharded_rank, SHARDED_MESH, "gloo", "cuda",
                SHARDED_TIMEOUT_S, job,
                {name: o["job"] for name, o in options.items()})
    spawn_s = time.perf_counter() - t0
    r0 = res[0]
    got = r0["state"]
    say(f"  {n} ranks of a {SHARDED_MESH} mesh on one card in {spawn_s:.1f}"
        f" s (start, model builds, {len(SHARDED_SCHEDULE)} flagship steps, "
        f"gather, the earth model builds, its segment, gathers, the "
        f"{len(options)} option models' builds, steps and gathers); "
        f"transport: {r0['transport']}; CG iterations by step "
        f"{r0['cg_iters']}")

    def gap(a, b):
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
    gaps = {k: gap(got[k], ref[k]) for k in fields}
    say(f"  gathered state against the unsharded step (generic tracer "
        f"step), largest gap over each field's scale: {json.dumps(gaps)}")
    say("  ... against the unsharded step with the fused tracer step (B1): "
        + json.dumps({k: gap(got[k], ref_fused[k]) for k in fields}))
    for k, g in gaps.items():
        if not g <= TOL_SHARDED[k]:
            raise AssertionError(f"sharded {k}: gap {g} > {TOL_SHARDED[k]}")
    if int(got["itt"]) != int(ref["itt"]) \
            or int(got["nconv"]) != int(ref["nconv"]):
        raise AssertionError("sharded itt/nconv differ from the unsharded")
    for rank, r in enumerate(res):
        for k, v in r["barotropic"].items():
            if not np.array_equal(v, r0["barotropic"][k]):
                raise AssertionError(f"rank {rank}'s {k} differs from rank "
                                     "0's")
        want = {"fct_tracer_step": 0,
                "apply_region_means": len(SHARDED_SCHEDULE),
                "congrad": len(SHARDED_SCHEDULE)}
        if r["launches"] != want:
            raise AssertionError(f"rank {rank} launched {r['launches']}, "
                                 f"the path {want}")
    say(f"  psi0, psi1, ptd, ptdb bitwise equal on all {n} ranks; launches "
        f"on every rank {json.dumps(r0['launches'])}")
    step_ms = statistics.median(
        1e3 * t for t, lf in zip(r0["step_s"], SHARDED_SCHEDULE) if lf)
    ex_ms = statistics.median(
        1e3 * t for t, lf in zip(r0["exchange_s"], SHARDED_SCHEDULE) if lf)
    timing = dict(step_ms=step_ms, exchange_ms=ex_ms,
                  messages=r0["messages"] / len(SHARDED_SCHEDULE))
    say(f"  {n} ranks sharing one H100 (a check of the machinery, not a "
        f"speed-up): rank 0's leapfrog step {step_ms:.1f} ms, {ex_ms:.1f} "
        f"ms of it in messages and host staging (medians; by step "
        f"{[round(1e3 * t, 1) for t in r0['step_s']]} and "
        f"{[round(1e3 * t, 1) for t in r0['exchange_s']]} ms, the first "
        f"waiting for the slowest rank's start; {timing['messages']:.0f} "
        f"messages a step); {card_line()}")

    def cuda(v):
        return tuple(torch.as_tensor(x, device="cuda")
                     if isinstance(x, np.ndarray) else x for x in v)
    say(" apply_region_means on rank 0's block (its last step's inputs)")
    k_convect = check_convect({"convect": cuda(r0["inputs"]["convect"])})
    say(" congrad on rank 0's replicated solve (its last step's inputs)")
    k_cg = check_cg_solve(m.cg_solver, cuda(r0["inputs"]["cg"]),
                          "sharded rank 0")
    for k in (k_convect, k_cg):
        k.pop("per_call_fn", None)
        say_kernel("sharded rank 0", k)
    earth = sharded_earth_check(res)
    opt = {name: sharded_option_check(name, o, [r["options"][name]
                                                for r in res])
           for name, o in options.items()}
    return dict(convect=k_convect, cg=k_cg, gaps=gaps, timing=timing,
                spawn_s=spawn_s, earth=earth, options=opt,
                launches=[r["launches"] for r in res],
                multihost=r0["multihost"])


def sharded_job(m, start, forcing, schedule):
    """The keyword arguments of ``run_sharded`` for the model ``m`` from
    the state ``start`` under ``forcing``."""
    from uvic_tpu_torch.convert import ocean_state_to_numpy
    job = dict(cfg=m.cfg, state=ocean_state_to_numpy(start),
               forcing={k: getattr(forcing, k).cpu().numpy()
                        for k in ("smf", "stf", "swr", "aice", "hice",
                                  "hsno", "btf")},
               schedule=list(schedule))
    job["forcing"]["relyr"] = float(forcing.relyr)
    return job


def sharded_option_references():
    """Phase 13's option models in the parent: each of OPTION_MODELS at
    full width, phase 2's perturbed state, its unsharded steps over
    SHARDED_OPTIONS_SCHEDULE on the generic tracer step and on the
    default one (B1 where the model takes it), and the ranks' job."""
    from uvic_tpu_torch.convert import ocean_state_to_numpy
    from uvic_tpu_torch.entry import _flagship
    out = {}
    for name, spec in OPTION_MODELS.items():
        m, state, forcing = _flagship(ocean=spec["ocean"],
                                      grid=spec.get("grid"))
        start = perturbed(m, state)
        refs = {}
        for fused in (False, True):
            m.fused_tracer, saved = fused and m.fused_tracer, m.fused_tracer
            try:
                s = start
                for lf in SHARDED_OPTIONS_SCHEDULE:
                    s = m.step(s, forcing, leapfrog=lf)
            finally:
                m.fused_tracer = saved
            refs[fused] = ocean_state_to_numpy(s)
        out[name] = dict(model=m, ref=refs[False], ref_fused=refs[True],
                         job=sharded_job(m, start, forcing,
                                         SHARDED_OPTIONS_SCHEDULE))
    return out


def sharded_option_check(name, o, ranks):
    """Phase 13's option model ``name`` in the parent: the gathered state
    against the unsharded generic-step steps within TOL_SHARDED_OPTIONS
    (the gap from the default steps printed beside it), every rank's
    replicated fields bitwise alike, every rank's launches (B2 once a
    step pass, B3 once a pass under full convection, B1 never), and B3 on
    rank 0's block and B2 on rank 0's replicated solve against their
    plain versions."""
    import numpy as np
    import torch
    m, r0 = o["model"], ranks[0]
    got, ref = r0["state"], o["ref"]
    fields = ("t", "tm1", "u", "um1", "psi0", "psi1", "ptd", "ptdb",
              "ubar", "ubarm1")

    def gap(a, b):
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
    gaps = {k: gap(got[k], ref[k]) for k in fields}
    say(f" {name}: {len(ranks)} ranks, blocks "
        f"{tuple(r0['blocks']['t'].shape)}, CG iterations by step "
        f"{r0['cg_iters']}; gathered state against the unsharded steps "
        f"(generic tracer step), largest gap over each field's scale: "
        f"{json.dumps(gaps)}")
    say(f"  ... against the unsharded default steps"
        f"{' (B1)' if m.fused_tracer else ''}: "
        + json.dumps({k: gap(got[k], o["ref_fused"][k]) for k in fields}))
    for k, g in gaps.items():
        if not g <= TOL_SHARDED_OPTIONS:
            raise AssertionError(f"sharded {name} {k}: gap {g} > "
                                 f"{TOL_SHARDED_OPTIONS}")
    if int(got["itt"]) != int(ref["itt"]) \
            or int(got["nconv"]) != int(ref["nconv"]):
        raise AssertionError(f"sharded {name}: itt/nconv differ")
    for rank, r in enumerate(ranks):
        for k, v in r["barotropic"].items():
            if not np.array_equal(v, r0["barotropic"][k]):
                raise AssertionError(f"sharded {name}: rank {rank}'s {k} "
                                     "differs from rank 0's")
    eb = m.cfg.ocean.eb
    passes = sum(2 if (eb and not lf) else 1
                 for lf in SHARDED_OPTIONS_SCHEDULE)
    full = m.cfg.ocean.convection == "full"
    want = {"fct_tracer_step": 0,
            "apply_region_means": passes if full else 0,
            "congrad": passes}
    for rank, r in enumerate(ranks):
        if r["launches"] != want:
            raise AssertionError(f"sharded {name}: rank {rank} launched "
                                 f"{r['launches']}, the path {want}")
    say(f"  {name}: {', '.join(sorted(r0['barotropic']))} bitwise equal on "
        f"all {len(ranks)} ranks; launches on every rank over "
        f"{len(SHARDED_OPTIONS_SCHEDULE)} steps ({passes} step passes) "
        f"{json.dumps(want)}")
    timing = dict(step_ms=[1e3 * t for t in r0["step_s"]],
                  exchange_ms=[1e3 * t for t in r0["exchange_s"]],
                  messages=r0["messages"])
    say(f"  {name}: {len(ranks)} ranks sharing one H100 (a check of the "
        f"machinery, not a speed-up): rank 0's steps "
        f"{[round(t, 1) for t in timing['step_ms']]} ms (mixing, leapfrog),"
        f" {[round(t, 1) for t in timing['exchange_ms']]} ms of them in "
        f"messages and host staging, the first waiting for the slowest "
        f"rank's start; {r0['messages']} messages; {card_line()}")

    def cuda(v):
        return tuple(torch.as_tensor(x, device="cuda")
                     if isinstance(x, np.ndarray) else x for x in v)
    out = dict(gaps=gaps, timing=timing, passes=passes,
               launches=[r["launches"] for r in ranks])
    if full:
        say(f" {name}: apply_region_means on rank 0's block (its last "
            "step's inputs)")
        out["convect"] = check_convect({"convect": cuda(r0["inputs"]
                                                        ["convect"])})
    elif "convect" in r0["inputs"]:
        raise AssertionError(f"sharded {name}: full convection ran")
    say(f" {name}: congrad on rank 0's replicated solve (its last step's "
        "inputs)")
    solver, _ = m.barotropic_solver(SHARDED_OPTIONS_SCHEDULE[-1])
    out["cg"] = check_cg_solve(solver, cuda(r0["inputs"]["cg"]),
                               f"sharded {name} rank 0",
                               solution_projection(m))
    for key in ("convect", "cg"):
        if key in out:
            out[key].pop("per_call_fn", None)
            say_kernel(f"sharded {name} rank 0", out[key])
    return out


def multihost_single_launch(mesh):
    """Phase 15's single launch, on phase 13's ranks: the (2, 3) mesh of
    ``make_multihost_artifact`` on the first six of them (the other two
    idle, as in the JAX artifact's 6 of 8 devices), each running
    ``run_multihost.rank_run`` (its launch counters set to 0 before its
    steps and read after); rank 0 returns its result with the arguments
    of its last step's convection (B3's on its block) and barotropic
    solve (B2's, replicated), the others None.  Every rank waits for the
    others at a barrier of the world before it returns."""
    import torch.distributed as dist
    from uvic_tpu_torch import make_multihost_artifact as art
    from uvic_tpu_torch.parallel.mesh import make_mesh
    from uvic_tpu_torch.run_multihost import rank_run
    sub = make_mesh(art.MESH, device=mesh.device)
    out = None
    if sub is not None:
        with recorded_inputs(sub.rank == 0) as seen:
            out = rank_run(sub, MULTIHOST_STEPS)
        if out is not None:
            out["inputs"] = seen
    dist.barrier()
    return out


def multihost_phase(single):
    """Phase 15: the (2, 3) mesh of ``make_multihost_artifact`` on the
    card, MULTIHOST_STEPS steps after the first, from the artifact's
    two-launcher run (two ``torch.distributed.run`` launchers of four
    ranks, one world of eight, ranks 6 and 7 idle), held bitwise (state
    digest and checksums) to ``single``, rank 0's result of the single
    launch (``multihost_single_launch``: the mesh on six of the eight
    ranks that phase 13's one ``spawn`` started); the launches of B2 and
    B3 on the mesh's rank 0 of both; B3 on rank 0's block (its last
    step's inputs with seeded noise on T and S, so that columns convect:
    the cold start convects nowhere) and B2 on its replicated solve
    against their plain versions."""
    import tempfile

    import numpy as np
    import torch
    from uvic_tpu_torch import make_multihost_artifact as art
    from uvic_tpu_torch.config import ModelConfig
    from uvic_tpu_torch.models.ocean.model import make_ocean
    t_phase = t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_multihost_") as tmp:
        two, statuses, codes = art.two_launchers(MULTIHOST_STEPS, "cuda",
                                                 tmp)
    two_s = time.perf_counter() - t0
    art.check_two_launchers(two, statuses)
    r0 = statuses[0]
    idle = {r: s["code"] for r, s in statuses.items() if not s["on_mesh"]}
    say(f"  two launchers x {two['local_devices']} ranks = "
        f"{two['global_devices']} global {two_s:.1f} s, launchers' exit "
        f"codes {codes}, idle ranks' exit codes {json.dumps(idle)}; "
        f"transport {r0['transport']}; the single launch: phase 13's "
        f"spawn, the mesh on {art.MESH[0] * art.MESH[1]} of its "
        f"{SHARDED_MESH[0] * SHARDED_MESH[1]} ranks")
    same = {"digest": r0["digest"] == single["digest"],
            **{k: two[k] == single[k]
               for k in ("checksum_t0", "checksum_ke")}}
    say(f"  two launchers against the single launch, bitwise: "
        f"{json.dumps(same)} (checksum_t0 {two['checksum_t0']!r}, "
        f"checksum_ke {two['checksum_ke']!r})")
    if not all(same.values()) or two["nan"] or single["nan"]:
        raise AssertionError("the two-launcher run differs from the single "
                             "launch")
    want = {"fct_tracer_step": 0, "apply_region_means": MULTIHOST_STEPS + 1,
            "congrad": MULTIHOST_STEPS + 1}
    for label, got in (("two launchers", r0["launches"]),
                       ("single launch", single["launches"])):
        say(f"  launches on the mesh's rank 0, {label}: {json.dumps(got)}")
        if got != want:
            raise AssertionError(f"{label}: rank 0 launched {got}, the path "
                                 f"{want}")
    say(f"  rank 0's step: two launchers {r0['ms_per_step']} ms, "
        f"{r0['exchange_ms_per_step']} ms of it in messages; single launch "
        f"{single['ms_per_step']} ms, {single['exchange_ms_per_step']} ms "
        f"(eight processes sharing one card: a check of the bootstrap, not "
        f"a speed-up); {card_line()}")
    ts, kmt, *rest = [torch.as_tensor(x, device="cuda")
                      if isinstance(x, np.ndarray) else x
                      for x in single["inputs"]["convect"]]
    rng = np.random.default_rng(NOISE_SEED)
    noise = np.stack([NOISE_T * rng.standard_normal(ts.shape[1:]),
                      NOISE_S * rng.standard_normal(ts.shape[1:])])
    idx = torch.arange(ts.shape[1], device="cuda").reshape(-1, 1, 1)
    ts = ts.clone()
    ts[:2] += torch.as_tensor(noise, dtype=ts.dtype, device="cuda") \
        * (idx < kmt[None]).to(ts.dtype)
    say(" apply_region_means on rank 0's block (its last step's inputs, "
        "noise on T and S)")
    k_convect = check_convect({"convect": (ts, kmt, *rest)})
    say(" congrad on rank 0's replicated solve (its last step's inputs)")
    m = make_ocean(ModelConfig().replace(dtype="float32"), device="cuda")
    solver, _ = m.barotropic_solver(True)
    k_cg = check_cg_solve(solver, tuple(
        torch.as_tensor(x, device="cuda") if isinstance(x, np.ndarray)
        else x for x in single["inputs"]["cg"]), "multihost rank 0")
    for k in (k_convect, k_cg):
        k.pop("per_call_fn", None)
        say_kernel("multihost rank 0", k)
    say(f"  phase 15 took {time.perf_counter() - t_phase:.1f} s (budget "
        f"{MULTIHOST_BUDGET_S} s)")
    return dict(convect=k_convect, cg=k_cg, launches=r0["launches"],
                single_launches=single["launches"],
                step_ms=r0["ms_per_step"],
                exchange_ms=r0["exchange_ms_per_step"], idle=idle)


def start_study_references():
    """Two worker processes computing phase 14's float64 CPU side (the
    precision study's snapshots, physics and MOBI) while the card runs
    the earlier phases.  Returns (the pool, {mobi: async result})."""
    import multiprocessing

    import torch
    from uvic_tpu_torch.precision_study import snapshots
    pool = multiprocessing.get_context("spawn").Pool(
        2, initializer=torch.set_num_threads,
        initargs=(STUDY_WORKER_THREADS,))
    refs = {mobi: pool.apply_async(snapshots, ("float64", STUDY_STEPS, mobi,
                                               "cpu"))
            for mobi in (False, True)}
    return pool, refs


def precision_phase(earth, pool, refs):
    """Phase 14: the precision study, float32 on the card against the
    workers' float64 on the CPU, and the segment closure probe on phase
    6's earth model."""
    import torch
    from uvic_tpu_torch import precision_study
    from uvic_tpu_torch.models.ocean.graphs import KERNEL_WRAPPERS
    from uvic_tpu_torch.probes import segment_closure
    out, bad = {}, []
    for mobi in (False, True):
        label = "MOBI" if mobi else "physics"
        before = {k: w.launches for k, w in KERNEL_WRAPPERS.items()}
        t0 = time.perf_counter()
        m32, snap32 = precision_study.run("float32", STUDY_STEPS, mobi,
                                          "cuda")
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        launches = {k: w.launches - before[k]
                    for k, w in KERNEL_WRAPPERS.items()}
        t0 = time.perf_counter()
        snap64 = refs[mobi].get(timeout=STUDY_WORKER_TIMEOUT_S)
        wait_s = time.perf_counter() - t0
        rows = precision_study.drift_rows(m32, snap64, snap32, mobi)
        say(f"  precision study, {label}: {STUDY_STEPS} steps float32 on the "
            f"card {card_s:.1f} s (launches outside the graphs and in their "
            f"captures {json.dumps(launches)}), float64 from the CPU worker "
            f"(waited {wait_s:.1f} s)")
        for row in rows:
            jax = PRECISION_STUDY_JAX[mobi][row["step"]]
            for key, v in row.items():
                if key == "step":
                    continue
                lim = PRECISION_FACTOR * jax[key]
                say(f"    step {row['step']:2d} {key:13s} {v:.3e} (JAX float32 "
                    f"{jax[key]:.3e}, limit {lim:.3e})")
                if not v <= lim:
                    bad.append((label, row["step"], key, v, lim))
        out[label] = dict(rows=rows, card_s=card_s, launches=launches)
        if min(launches.values()) < 1:
            bad.append((label, "a kernel did not launch", launches))
    pool.close()
    pool.join()

    em, estart = earth["model"], earth["start"]
    t0 = time.perf_counter()
    manual, replay, after = segment_closure.closure_rows(em, estart)
    closure_s = time.perf_counter() - t0
    check_finite(after.ocean, "the replayed closure segment")
    replay_resid = (replay["fused_d_heat_wm2"] - replay["fused_acc_heat_wm2"]
                    - manual["bhf_wm2"])
    lim = segment_closure.RESID_LIMIT_WM2
    say(f"  segment closure on {EARTH_RESTART} ({closure_s:.1f} s): "
        f"{json.dumps(manual)} {json.dumps(replay)}; the replayed segment's "
        f"residual {replay_resid:.3f} W/m^2; limit {lim} W/m^2")
    for what, r in (("manual", manual["resid_wm2"]),
                    ("replayed", replay_resid)):
        if not abs(r) <= lim:
            bad.append(("segment closure", what, r, lim))
    out["closure"] = dict(manual=manual, replay=replay,
                          replay_resid_wm2=replay_resid)
    if bad:
        raise AssertionError(f"precision tools out of limits: {bad}")
    return out


def precision_year_mode(outdir):
    """--precision-year: the float32 year on the card, its stream and its
    divergence from PRECISION_F64 into ``outdir``."""
    import torch
    from uvic_tpu_torch import precision_year
    from uvic_tpu_torch.cuda import LIBRARY
    LIBRARY.get()
    os.makedirs(outdir, exist_ok=True)
    stream = os.path.join(outdir, "tsi_year_f32_h100.json")
    t0 = time.perf_counter()
    precision_year.run("float32", stream, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    def load(path):
        with open(path) as f:
            return json.load(f)

    card = load(stream)
    div = precision_year.divergence(card, load(PRECISION_F64))
    jax32 = load(PRECISION_JAX_DIVERGENCE)["divergence"]
    old = precision_year.divergence(card, load(PRECISION_F64_OLD))
    limits = {k: PRECISION_FACTOR * jax32[k]["max_rel"] for k in jax32}
    out_of = {k: d["max_rel"] for k, d in div["divergence"].items()
              if not d["max_rel"] <= limits[k]}
    res = dict(div, reference=PRECISION_F64, limits_max_rel=limits,
               limit_rule=f"{PRECISION_FACTOR:g} x the JAX package's float32 "
               f"max_rel of {PRECISION_JAX_DIVERGENCE}",
               card=card_line(), wall_s=wall,
               against_old_golden={k: d["max_rel"] for k, d in
                                   old["divergence"].items()},
               out_of_limits=out_of)
    with open(os.path.join(outdir, "divergence_h100.json"), "w") as f:
        json.dump(res, f, indent=1)
    for k, d in div["divergence"].items():
        say(f"  {k:8s} max_rel {d['max_rel']:.3e} (limit {limits[k]:.3e}), "
            f"final_rel {d['final_rel']:.3e}; against {PRECISION_F64_OLD} "
            f"{old['divergence'][k]['max_rel']:.3e}")
    say(f"  {div['segments']} segments in {wall:.1f} s "
        f"({86400.0 / wall:.0f} simulated years a day)")
    say(json.dumps(res))
    return 1 if out_of else 0


PHASE_CLOCK = []     # (number, start) of the phase that runs
PHASE_S = {}         # seconds of each finished phase, by number


def phase(title):
    """Print the seconds of the phase that ends (``phase N: ... s``) and
    the title of the one that starts (None: the last has ended)."""
    now = time.perf_counter()
    if PHASE_CLOCK:
        n, t0 = PHASE_CLOCK.pop()
        PHASE_S[n] = now - t0
        say(f"phase {n}: {now - t0:.1f} s")
    if title is not None:
        PHASE_CLOCK.append((title.split(":")[0].split()[1], now))
        say(title)


def main(argv):
    if len(argv) == 2 and argv[0] == "--golden-gaps":
        return golden_gaps_of(argv[1])
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    t_start = time.perf_counter()
    PHASE_CLOCK.append(("0", t_start))
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
    if len(argv) == 2 and argv[0] == "--golden-years" \
            and argv[1].isdigit() and int(argv[1]) > 0:
        faulthandler.dump_traceback_later(
            WATCHDOG_S + GOLDEN_YEAR_S * int(argv[1]), exit=True)
        code = golden_years(int(argv[1]))
        say(card)
        faulthandler.cancel_dump_traceback_later()
        return code
    if len(argv) == 2 and argv[0] == "--precision-year":
        faulthandler.dump_traceback_later(PRECISION_YEAR_S, exit=True)
        code = precision_year_mode(argv[1])
        say(card)
        faulthandler.cancel_dump_traceback_later()
        return code
    if argv:
        say(f"unknown arguments {argv}")
        return 2
    import uvic_tpu_torch  # noqa: F401  (sets the TF32 switches)
    from uvic_tpu_torch.cuda import LIBRARY
    from uvic_tpu_torch.ops.cg_kernel import congrad_launch
    from uvic_tpu_torch.ops.convection import apply_region_means
    from uvic_tpu_torch.ops.tracer_kernel import (TracerStepConsts,
                                                  fct_tracer_step)
    from uvic_tpu_torch.entry import _flagship
    say(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    say(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}")

    phase("phase 1: build")
    LIBRARY.get()
    say(f"  kernels built/loaded in {LIBRARY.build_seconds:.1f} s")
    for line in LIBRARY.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            say("  ptxas: " + line.strip())
        spill = re.search(r"(\d+) bytes spill stores", line)
        if spill and int(spill.group(1)) > 0:
            raise AssertionError("a kernel spills: " + line.strip())
    study_pool, study_refs = start_study_references()

    phase("phase 2: kernels against their plain versions, flagship shapes")
    m, state, forcing, seen = flagship_inputs()
    say(" fct_tracer_step")
    k_tracer = check_tracer(m, seen)
    say(" apply_region_means")
    k_convect = check_convect(seen)
    say(" apply_region_means on random inputs at other shapes")
    check_convect_shapes()
    say(" congrad")
    k_cg = check_cg(m, seen)
    say(" fct_tracer_step, non-isopycnal form (harmonic y-diffusion, "
        "no weight stack, aidif 0), nt=2 inputs")
    k_plain_form = check_tracer(m, seen, "non-isopycnal tracer step",
                                TracerStepConsts(m.g, m.cfg.ocean.ah, 0.0,
                                                 ydiff_fluxform=False,
                                                 has_iso=False))
    say(" the full-MOBI flagship (nt=41): inputs of one step with its "
        "bgc source")
    m41, s41, f41 = _flagship(mobi=True)
    _, seen41 = capture_step(m41, perturbed(m41, s41), f41)
    if seen41["tracer"][0][9] is None:
        raise AssertionError("the MOBI step passed no source to the "
                             "tracer step")
    say(" fct_tracer_step, nt=41 with the MOBI source")
    k_tracer41 = check_tracer(m41, seen41, "nt=41 tracer step")
    say(" apply_region_means, nt=41")
    k_convect41 = check_convect(seen41)
    for label, k in (("nt=2", k_tracer), ("nt=2", k_convect),
                     ("nt=2", k_cg), ("nt=2 non-isopycnal", k_plain_form),
                     ("nt=41", k_tracer41), ("nt=41", k_convect41)):
        say_kernel(label, k)

    phase("phase 3: small-input reference, f32 card vs f64 CPU")
    small_reference()

    phase(f"phase 4: main path, {N_STEPS} flagship leapfrog steps")
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
    say(f"  run_scan, nt=2: {N_SCAN} steps from itt {state.itt}")
    r, first_ms = timed_scan(m, state, forcing, N_SCAN)
    captured2 = say_graphs(m, "nt=2")
    r2, scan_ms = timed_scan(m, state, forcing, N_SCAN)
    if same_state(r, r2) != 0.0:
        raise AssertionError("nt=2 run_scan: two replays differ")
    check_finite(r, "the nt=2 run_scan")
    say(f"  replayed step {scan_ms:.3f} ms (first call {first_ms:.3f} ms a "
        f"step with the capture); CG iterations per step: "
        f"{m.scan_cg_iters.tolist()}")
    _, eager2_ms, _ = scan_vs_eager(m, state, forcing, N_SCAN, "nt=2")
    say(f"  the same steps eagerly: {eager2_ms:.3f} ms a step (median)")

    phase("phase 5: main path at nt=41, the full-MOBI flagship")
    say("  MOBI sources, 34x40x8, f32 card vs f64 CPU")
    mobi_small_reference()
    s41 = dataclasses.replace(s41, itt=m41.cfg.ocean.nmix - 2)
    say(f"  run_scan, nt=41: {N_SCAN41} steps from itt {s41.itt}")
    r41, first41_ms = timed_scan(m41, s41, f41, N_SCAN41)
    captured41 = say_graphs(m41, "nt=41")
    say(f"  first call {first41_ms:.1f} ms a step with the capture; CG "
        f"iterations per step: {m41.scan_cg_iters.tolist()}")
    r41b, scan41_ms = timed_scan(m41, s41, f41, N_SCAN41)
    if same_state(r41, r41b) != 0.0:
        raise AssertionError("nt=41 run_scan: two replays differ")
    check_finite(r41, "the nt=41 run_scan")
    say(f"  replayed MOBI step {scan41_ms:.1f} ms")
    mid = m41.run_scan(s41, f41, N_SCAN41 - 2)
    _, eager41_ms, eager41 = scan_vs_eager(m41, mid, f41, 2, "nt=41")
    say(f"  eager MOBI step {eager41_ms:.1f} ms (median of 2); launch "
        f"counters {json.dumps(eager41)}")
    idx = m41.tracer_index
    say(f"  |t| max {float(r41.t[idx.itemp].abs().max()):.4f}, po4 max "
        f"{float(r41.t[idx['po4']].max()):.4f}, dic max "
        f"{float(r41.t[idx['dic']].max()):.4f}, |psi| max "
        f"{float(r41.psi0.abs().max()):.4e}")

    phase("phase 6: the coupled earth segment from the year-1060 restart, "
        "and a year of it through the port's Run")
    earth = earth_phase()
    for key in ("tracer", "convect", "cg"):
        earth[key].pop("per_call_fn", None)
    say(f"  earth segment: eager {earth['eager_ms']:.1f} ms, replayed "
        f"{earth['replay_ms']:.1f} ms, inside Run {earth['run_ms']:.1f} ms "
        "(medians)")

    phase("phase 7: transient forcing and anomalous winds on the earth model, "
        "eager against replayed")
    transient_phase()

    phase("phase 8: the earth carbon cycle (MOBI gas exchange and virtual "
        "fluxes, pore-water sediments) under transient forcing, and a month "
        "of it through the port's Run")
    bgc = earth_bgc_phase()
    for key in ("tracer", "convect", "cg"):
        bgc[key].pop("per_call_fn", None)
        say_kernel("earth bgc", bgc[key])
    say(f"  earth bgc segment: eager {bgc['eager_ms']:.1f} ms, replayed "
        f"{bgc['replay_ms']:.1f} ms, inside Run {bgc['run_ms']:.1f} ms "
        "(medians)")

    phase("phase 9: the spin-up and the coupled options")
    opts = spinup_options_phase()
    for key in ("tracer", "convect", "cg"):
        opts[key].pop("per_call_fn", None)
        say_kernel("earth accel", opts[key])
    opts["brine_convect"].pop("per_call_fn", None)
    say_kernel("earth brine", opts["brine_convect"])
    say(f"  accel {ACCEL:g} segment: eager {opts['accel']['eager_ms']:.1f} "
        f"ms, replayed {opts['accel']['replay_ms']:.1f} ms; spin-up year "
        f"{opts['year']['year_s']:.1f} s "
        f"({86400.0 / opts['year']['year_s']:.0f} simulated years a day)")
    for name, r in opts["options"].items():
        say(f"  {name}: eager {r['eager_ms']:.1f} ms, replayed "
            f"{r['replay_ms']:.1f} ms, {r['graph_nodes']} graph nodes, "
            f"captures {r['capture_s']:.2f} s, instantiations "
            f"{r['instantiate_s']:.2f} s")

    phase("phase 10: the ocean-only restoring run (OceanModel.run_restoring) "
        "of the flagship, its tooling (regions, sections, the transport "
        "matrix) and the NaN bisector")
    rest = restoring_phase(earth)
    for key in ("tracer", "convect", "cg"):
        rest[key].pop("per_call_fn", None)
        say_kernel("restoring", rest[key])
    say(f"  restoring segment: eager {rest['eager_ms']:.3f} ms a step, "
        f"replayed {rest['seg_ms']:.1f} ms a segment; the year "
        f"{rest['year_s']:.3f} s ({86400.0 / rest['year_s']:.0f} simulated "
        f"years a day); extract_matrices {rest['tmm_card_s']:.2f} s on the "
        f"card, {rest['tmm_cpu_s']:.2f} s on the CPU in float64")

    # The profiler sessions come after every other phase but the ocean
    # options: on the card, a torch.profiler session taken after an
    # earlier session and ~1e5 eager launches in between recorded no
    # device activity at all (PyTorch 2.11), and so did the first
    # session taken after the options phase; that phase takes none.
    phase("phase 11: torch.profiler counts")
    checked = (("nt=2", k_tracer), ("nt=2", k_convect), ("nt=2", k_cg),
               ("nt=2 non-isopycnal", k_plain_form), ("nt=41", k_tracer41),
               ("nt=41", k_convect41))
    for label, k in checked:
        k["launches_per_call"] = kernels_per_call(k.pop("per_call_fn"))
        say(f"  {k['name']} {label}: {k['launches_per_call']} device "
            "kernel(s) per call")
        if k["name"] == "apply_region_means" and k["launches_per_call"] != 1:
            raise AssertionError(f"apply_region_means {label}: "
                                 f"{k['launches_per_call']} device kernels "
                                 "per call")
    per_step2 = check_replay_counts(m, state, forcing, "nt=2")
    phase("phase 12: the ocean options at full width (three flagship "
          "models with options on top) and every option in the small form")
    optres = options_phase()

    phase(f"phase 13: the rank-decomposed flagship, earth segment and "
          f"option models, {SHARDED_MESH} mesh of ranks sharing the card, "
          "against the unsharded steps and segment")
    shard = sharded_phase(m, state, forcing)

    phase(f"phase 14: the precision study ({STUDY_STEPS} steps, physics and "
          "MOBI, float32 on the card against float64 on the CPU) and the "
          "segment closure probe")
    prec = precision_phase(earth, study_pool, study_refs)

    phase(f"phase 15: the multi-process bootstrap, {MULTIHOST_STEPS} steps "
          "of the (2, 3) mesh from two launchers of four ranks against a "
          "single launch")
    multi = multihost_phase(shard["multihost"])

    by_path = {k: {"nt2_eager": launches[k],
                   "nt2_run_scan_per_step": captured2[k],
                   "nt41_eager": eager41[k],
                   "nt41_run_scan_per_step": captured41[k],
                   "earth_eager_per_segment": earth["eager_counts"][k],
                   "earth_run_per_segment": earth["run_counts"][k],
                   "earth_run_year_by_replays": earth["year_counts"][k],
                   "earth_bgc_eager_per_segment": bgc["eager_counts"][k],
                   "earth_bgc_run_per_segment": bgc["run_counts"][k],
                   "earth_bgc_month_by_replays": bgc["month_counts"][k],
                   "earth_accel_eager_per_segment":
                       opts["accel"]["eager_counts"][k],
                   "earth_accel_run_per_segment":
                       opts["accel"]["run_counts"][k],
                   "spinup_year_counter": opts["year"]["launches"][k],
                   **{f"earth_{o}_eager_per_segment":
                      opts["options"][o]["eager_counts"][k]
                      for o in EARTH_OPTIONS},
                   **{f"earth_{o}_run_per_segment":
                      opts["options"][o]["run_counts"][k]
                      for o in EARTH_OPTIONS},
                   "restoring_eager_per_segment": rest["eager_counts"][k],
                   "restoring_run_per_segment": rest["run_counts"][k],
                   "restoring_year_by_replays": rest["year_counts"][k],
                   **{f"options_{o}_{kind}": c[k]
                      for o, r in optres.items() if "counts" in r
                      for kind, c in r["counts"].items()},
                   "sharded": [c[k] for c in shard["launches"]],
                   "sharded_earth_per_segment":
                       [c[k] for c in shard["earth"]["launches"]],
                   "sharded_options_per_step": {
                       name: [c[k] / r["passes"] for c in r["launches"]]
                       for name, r in shard["options"].items()},
                   "precision_study_eager_and_captured": {
                       label: prec[label]["launches"][k]
                       for label in ("physics", "MOBI")},
                   "multihost_rank0_two_launchers": multi["launches"][k],
                   "multihost_rank0_single_launch":
                       multi["single_launches"][k]}
               for k in launches}

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
                 "launches_per_call": k["launches_per_call"],
                 "launches_by_path": by_path[k["name"]]}
        if "cluster" in k:
            entry["cluster"] = k["cluster"]
        k41 = {"fct_tracer_step": k_tracer41,
               "apply_region_means": k_convect41}.get(k["name"])
        if k41 is not None:
            entry["nt41"] = {key: k41[key] for key in (
                "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "cold_device_ms")}
        if "blocks_per_sm" in k:
            entry["blocks_per_sm"] = k["blocks_per_sm"]
        ke = {"fct_tracer_step": earth["tracer"],
              "apply_region_means": earth["convect"],
              "congrad": earth["cg"]}[k["name"]]
        entry["earth"] = {key: ke[key] for key in (
            "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")}
        if "iters" in ke:
            entry["earth"]["iters"] = ke["iters"]
        kb = {"fct_tracer_step": bgc["tracer"],
              "apply_region_means": bgc["convect"],
              "congrad": bgc["cg"]}[k["name"]]
        entry["earth_bgc"] = {key: kb[key] for key in (
            "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")}
        if "iters" in kb:
            entry["earth_bgc"]["iters"] = kb["iters"]
        ka = opts[{"fct_tracer_step": "tracer",
                   "apply_region_means": "convect",
                   "congrad": "cg"}[k["name"]]]
        entry["earth_accel"] = {key: ka[key] for key in (
            "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")}
        if "iters" in ka:
            entry["earth_accel"]["iters"] = ka["iters"]
        kr = rest[{"fct_tracer_step": "tracer",
                   "apply_region_means": "convect",
                   "congrad": "cg"}[k["name"]]]
        entry["restoring"] = {key: kr[key] for key in (
            "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")}
        if "iters" in kr:
            entry["restoring"]["iters"] = kr["iters"]
        entry["options"] = {}
        for o, r in optres.items():
            for key in {"fct_tracer_step": ("tracer",),
                        "apply_region_means": ("convect",),
                        "congrad": ("cg", "cg_mixing")}[k["name"]]:
                if key in r:
                    entry["options"][o + ("_mixing" if key == "cg_mixing"
                                          else "")] = {
                        f: r[key][f] for f in (
                            "max_abs_err", "ms", "device_ms", "plain_ms",
                            "bound_ms", "bound_by", "library_ms", "iters",
                            "iters_zero") if f in r[key]}
        ks = {"apply_region_means": shard["convect"],
              "congrad": shard["cg"]}.get(k["name"])
        if ks is not None:
            entry["sharded"] = {key: ks[key] for key in (
                "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms") if key in ks}
            ke = shard["earth"][{"apply_region_means": "convect",
                                 "congrad": "cg"}[k["name"]]]
            entry["sharded_earth"] = {key: ke[key] for key in (
                "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "iters") if key in ke}
            entry["sharded_options"] = {
                name: {key: r[kk][key] for key in (
                    "max_abs_err", "ms", "device_ms", "plain_ms",
                    "bound_ms", "bound_by", "library_ms", "iters")
                    if key in r[kk]}
                for name, r in shard["options"].items()
                for kk in [{"apply_region_means": "convect",
                            "congrad": "cg"}[k["name"]]] if kk in r}
        km = {"apply_region_means": multi["convect"],
              "congrad": multi["cg"]}.get(k["name"])
        if km is not None:
            entry["multihost"] = {key: km[key] for key in (
                "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "iters") if key in km}
        if k["name"] == "apply_region_means":
            kbr = opts["brine_convect"]
            entry["earth_brine"] = {key: kbr[key] for key in (
                "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms")}
        kernels.append(entry)
    say(f"steps: nt=2 eager {statistics.median(step_ms):.3f} ms, replayed "
        f"{scan_ms:.3f} ms ({per_step2['leapfrog']} kernels); nt=41 eager "
        f"{eager41_ms:.1f} ms, replayed {scan41_ms:.1f} ms; earth segment "
        f"eager "
        f"{earth['eager_ms']:.1f} ms, replayed {earth['replay_ms']:.1f} ms "
        f"({earth['graph_nodes']} graph nodes), inside Run "
        f"{earth['run_ms']:.1f} ms "
        f"({EARTH_YEAR} segments against the golden tsi); earth bgc "
        f"segment eager {bgc['eager_ms']:.1f} ms, replayed "
        f"{bgc['replay_ms']:.1f} ms, inside Run {bgc['run_ms']:.1f} ms "
        f"({EARTH_BGC_MONTH} segments against {EARTH_BGC_GOLDEN}); "
        f"restoring segment replayed {rest['seg_ms']:.1f} ms "
        f"({RESTORING_SEGMENTS} segments against {RESTORING_GOLDEN}); "
        f"sharded flagship step {shard['timing']['step_ms']:.1f} ms with "
        f"{shard['timing']['exchange_ms']:.1f} ms of messages, sharded "
        f"earth segment {shard['earth']['timing']['segment_ms']:.1f} ms "
        f"with {shard['earth']['timing']['exchange_ms']:.1f} ms of "
        f"messages, sharded option models' leapfrog steps "
        + ", ".join(f"{name} {r['timing']['step_ms'][-1]:.1f} ms"
                    for name, r in shard["options"].items())
        + f" ({SHARDED_MESH[0] * SHARDED_MESH[1]} ranks sharing one card); "
        f"precision study on the card {prec['physics']['card_s']:.1f} s "
        f"(physics) and {prec['MOBI']['card_s']:.1f} s (MOBI), segment "
        f"closure residual {prec['closure']['manual']['resid_wm2']} W/m^2; "
        f"two-launcher bootstrap rank 0 step {multi['step_ms']} ms with "
        f"{multi['exchange_ms']} ms of messages")
    phase(None)
    say("phase seconds: " + json.dumps(
        {n: round(t, 1) for n, t in PHASE_S.items()}))
    say(f"total {time.perf_counter() - t_start:.1f} s "
        f"(watchdog {WATCHDOG_S} s)")
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
