"""Vertical tridiagonal solve (implicit vertical diffusion), torch.

Port of ``uvic_tpu.ops.tridiag`` (source/mom/invtri.F): the Thomas
algorithm over all (j, i) columns at once, the short k recursion
(km <= ~20) as a Python loop.
"""

from __future__ import annotations

import torch


def solve_tridiag_masked(a, b, c, f, mask, eps=1.0e-30):
    """Solve the masked tridiagonal systems a*z[k-1] + b*z[k] + c*z[k+1] = f.

    All inputs are (km, ...) with per-column land masking: masked levels
    produce 0 (invtri.F multiplies the decomposition by mask with an eps
    regularizer so land columns stay finite).
    """
    km = a.shape[0]
    bet = mask[0] / (b[0] + eps)
    z = [f[0] * bet]
    e = [torch.zeros_like(f[0])]
    for k in range(1, km):
        e_k = c[k - 1] * bet
        bet = mask[k] / (b[k] - a[k] * e_k + eps)
        z.append((f[k] - a[k] * z[-1]) * bet)
        e.append(e_k)
    for k in range(km - 2, -1, -1):
        z[k] = z[k] - e[k + 1] * z[k + 1]
    return torch.stack(z)


def invtri(z, topbc, botbc, dcb, tdt, kmz, mask, grid_dztr, grid_dztur,
           grid_dztlr, aidif):
    """Implicit vertical diffusion update (invtri.F:1-115).

    z      : (km, jmt, imt) right-hand side (tracer or velocity at tau+1)
    topbc  : (jmt, imt) surface flux b.c.
    botbc  : (jmt, imt) bottom flux b.c.
    dcb    : (km, jmt, imt) mixing coefficient at cell bottoms
    tdt    : (km,) effective 2*dt per level (includes dtxcel acceleration)
    kmz    : (jmt, imt) int level count (kmt or kmu)
    mask   : (km, jmt, imt) land mask
    returns: (km, jmt, imt) solution

    The system A z = f is solved for the increment y = z - x of
    x = z_in * mask: every wet row of A sums to one (b = 1 - a - c), so
    A y = f - A x = fluxes - a (x[k-1] - x[k]) - c (x[k+1] - x[k]).  The
    Thomas recursion's rounding then scales with the diffusion's
    increment, not with the tracer's value: solved for z itself in
    float32, a column mixed by a large diffusivity (K33 of the isopycnal
    scheme) carries an error of the order of an ulp of the tracer at
    every level, the same sign at every level, and the mean SST of the
    flagship drifts by ~5e-7 K a step.
    """
    km = z.shape[0]
    tdt = tdt.reshape(km, 1, 1)
    factu = grid_dztur.reshape(km, 1, 1) * tdt * aidif
    factl = grid_dztlr.reshape(km, 1, 1) * tdt * aidif

    dcb_up = torch.cat([dcb[:1], dcb[:-1]], dim=0)  # dcb[k-1], k=0->0
    mask_dn = torch.cat([mask[1:], mask[-1:]], dim=0)
    a = -dcb_up * factu * mask
    c = -dcb * factl * mask_dn
    a[0] = 0.0
    c[-1] = 0.0
    b = 1.0 - a - c
    x = z * mask

    # top flux enters level 0; bottom flux leaves level kb-1
    dztr = grid_dztr.reshape(km, 1, 1)
    r = torch.zeros_like(x)
    r[0] = topbc * tdt[0] * dztr[0] * aidif * mask[0]
    kb = torch.clamp(kmz - 1, min=1)  # invtri.F:79 max(2,kmz), 0-based
    levels = torch.arange(km, device=z.device).reshape(km, 1, 1)
    is_bot = levels == kb[None]
    r = r - torch.where(is_bot, botbc[None] * tdt * dztr * aidif * mask,
                        torch.zeros_like(r))
    r[1:] = r[1:] - a[1:] * (x[:-1] - x[1:])
    r[:-1] = r[:-1] - c[:-1] * (x[1:] - x[:-1])
    return x + solve_tridiag_masked(a, b, c, r, mask)


def invtri_columns(z, topbc, botbc, dcb, tdt, kmz, mask, grid_dztr,
                   grid_dztur, grid_dztlr, aidif):
    """``invtri`` of a stack of fields z (n, km, jmt, imt) with their
    fluxes topbc, botbc (n, jmt, imt) and common coefficients, as one
    call: invtri is local to each column, so the n fields are laid side
    by side in i (km, jmt, n*imt) with the column coefficients
    repeated."""
    n, km, jmt, imt = z.shape

    def side_by_side(f):          # (n, ..., jmt, imt) -> (..., jmt, n*imt)
        return torch.movedim(f, 0, -2).reshape(f.shape[1:-1] + (n * imt,))

    out = invtri(side_by_side(z), side_by_side(topbc), side_by_side(botbc),
                 dcb.repeat(1, 1, n), tdt, kmz.repeat(1, n),
                 mask.repeat(1, 1, n), grid_dztr, grid_dztur, grid_dztlr,
                 aidif)
    return torch.movedim(out.reshape(km, jmt, n, imt), 2, 0)
