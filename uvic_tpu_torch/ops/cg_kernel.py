"""Island-constrained barotropic CG: CUDA kernel wrapper and plain version.

Counterpart of ``uvic_tpu/ops/pallas_cg.py:make_pallas_congrad``: the
whole preconditioned CG of ``ops/solvers.congrad`` (congrad.F) in one
launch of one thread block (``csrc/congrad.cu``).  ``CGSolver`` binds
the static geometry; calling it solves A dpsi = forc for one timestep:
CPU tensors take ``congrad_ref``, CUDA tensors launch the kernel.
"""

from __future__ import annotations

import torch

from ..cuda import check_cuda, launch, ptr
from .solvers import IslandIndex, congrad, make_inv

_MAX_ISLANDS = 16           # csrc/congrad.cu MAXISLE
_SMEM_LIMIT = 232448        # bytes of shared memory a block may use


def congrad_ref(cf_unit, isl, guess, forc, c2dtsf, tol, max_iter, cyclic):
    """Plain version: ``solvers.congrad`` on the operator cf_unit/c2dtsf,
    the host looping to the same max_iter and stop rule.  Returns
    (dpsi, iters) with iters a 0-d int32 tensor."""
    dpsi, iters, _, _ = congrad(cf_unit / c2dtsf, guess, forc, isl, tol,
                                max_iter, cyclic)
    return dpsi, torch.tensor(iters, dtype=torch.int32, device=dpsi.device)


class CGSolver:
    """Barotropic solver bound to static geometry.

    cf_unit : (3, 3, jmt, imt) operator coefficients at unit timestep
    isl     : IslandIndex of the island perimeters
    Call ``solver(guess, forc, c2dtsf, tol) -> (dpsi, iters)``.
    """

    def __init__(self, cf_unit, isl: IslandIndex, max_iter: int,
                 cyclic: bool = True):
        self.cf_unit = cf_unit
        self.isl = isl
        self.max_iter = int(max_iter)
        self.cyclic = bool(cyclic)
        jmt, imt = cf_unit.shape[-2:]
        self.z_unit = make_inv(cf_unit, isl).contiguous()
        self.cf9 = cf_unit.reshape(9, jmt, imt).contiguous()
        self.pid = isl.perim_id.to(torch.int32).contiguous()
        self.rcount = (1.0 / torch.clamp(isl.counts, min=1.0)).contiguous()

    def __call__(self, guess, forc, c2dtsf, tol):
        if guess.device.type == "cpu":
            return congrad_ref(self.cf_unit, self.isl, guess, forc, c2dtsf,
                               tol, self.max_iter, self.cyclic)
        return congrad_cuda(self, guess, forc, c2dtsf, tol)


def congrad_cuda(solver: CGSolver, guess, forc, c2dtsf, tol):
    """Launch the single-block CG kernel (float32)."""
    jmt, imt = solver.pid.shape
    if solver.isl.nisle > _MAX_ISLANDS:
        raise ValueError(f"congrad_cuda: {solver.isl.nisle} islands, "
                         f"kernel takes {_MAX_ISLANDS}")
    if 16 * jmt * imt + 4096 > _SMEM_LIMIT:
        raise ValueError("congrad_cuda: grid too large for shared memory")
    check_cuda("congrad_cuda", dict(
        cf=(solver.cf9, (9, jmt, imt)), z=(solver.z_unit, (jmt, imt)),
        rcount=(solver.rcount, None), guess=(guess, (jmt, imt)),
        forc=(forc, (jmt, imt))))
    check_cuda("congrad_cuda", dict(pid=(solver.pid, (jmt, imt))),
               dtype=torch.int32)
    dpsi = torch.empty_like(guess)
    iters = torch.empty(1, dtype=torch.int32, device=guess.device)
    launch("uvic_congrad", ptr(solver.cf9), ptr(solver.z_unit),
           ptr(solver.pid), ptr(solver.rcount), ptr(guess), ptr(forc),
           ptr(dpsi), ptr(iters), jmt, imt, solver.isl.nisle,
           solver.max_iter, int(solver.cyclic), float(c2dtsf), float(tol))
    congrad_cuda.launches += 1
    return dpsi, iters[0]


congrad_cuda.launches = 0
