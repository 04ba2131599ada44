"""Newton constraint solver with Newton-on-alpha linesearch, batched.

Counterpart of the JAX package's ``ops/solver.py``. Solves the convex
acceleration-level problem MuJoCo defines:

    min_qacc  0.5 (qacc - qacc_smooth)^T M (qacc - qacc_smooth)
              + sum_i cost_i(J_i qacc - aref_i)

where unilateral rows (limits, contacts) cost 0.5 D x^2 for x < 0 (and the
row exists, pos < 0), and dof-friction rows cost a Huber function saturating
at the frictionloss bound. Every loop has a static length (``iterations``
and ``ls_iterations`` come from the model); every branch is a
``torch.where`` with both sides evaluated, as ``jnp.where`` is.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from open_duck_playground_tpu_torch.ops import linalg
from open_duck_playground_tpu_torch.ops.constraint import Efc
from open_duck_playground_tpu_torch.ops.types import Model

_TINY = 1e-12


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (A @ x[..., None])[..., 0]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a[..., None, :] @ b[..., :, None])[..., 0, 0]


def _force_and_hessian_mask(efc: Efc, Jaref: torch.Tensor):
    """Per-row force f(x) and whether the row is in its quadratic zone."""
    exists = efc.pos < 0.0
    quad_active = efc.is_quad & exists & (Jaref < 0.0)
    Dx = efc.D * Jaref
    inside = efc.is_friction & (torch.abs(Dx) <= efc.floss)
    f = torch.where(quad_active, -Dx, 0.0)
    f = torch.where(efc.is_friction, -torch.minimum(torch.maximum(Dx, -efc.floss), efc.floss), f)
    hess_mask = quad_active | inside
    return f, hess_mask


def _cost(efc: Efc, Jaref: torch.Tensor, gauss: torch.Tensor) -> torch.Tensor:
    """Total primal cost (B,): Gauss term + per-row constraint costs, as
    MuJoCo's mj_constraintUpdate computes it for the warmstart comparison."""
    exists = efc.pos < 0.0
    quad_active = efc.is_quad & exists & (Jaref < 0.0)
    Dx = efc.D * Jaref
    inside = torch.abs(Dx) <= efc.floss
    quad = 0.5 * efc.D * Jaref * Jaref
    huber = torch.where(
        inside, quad, efc.floss * torch.abs(Jaref) - 0.5 * efc.floss * efc.floss / efc.D
    )
    c = torch.where(quad_active, quad, 0.0)
    c = torch.where(efc.is_friction, huber, c)
    return gauss + c.sum(-1)


def solve(m: Model, M: torch.Tensor, qacc_smooth: torch.Tensor, efc: Efc,
          warmstart: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (qacc, qfrc_constraint), each (B, nv).

    `warmstart` is the previous step's qacc: like MuJoCo's Newton solver,
    the start point is whichever of {warmstart, qacc_smooth} has the lower
    primal cost. At iterations=1 the start point decides the answer.
    """
    if efc.J.shape[1] == 0:
        return qacc_smooth, torch.zeros_like(qacc_smooth)

    J, Jt = efc.J, efc.J.transpose(-1, -2)
    qacc = qacc_smooth
    if warmstart is not None:
        Jaref_ws = _mv(J, warmstart) - efc.aref
        Jaref_sm = _mv(J, qacc_smooth) - efc.aref
        dws = warmstart - qacc_smooth
        gauss_ws = 0.5 * _dot(dws, _mv(M, dws))
        cost_ws = _cost(efc, Jaref_ws, gauss_ws)
        cost_sm = _cost(efc, Jaref_sm, torch.zeros_like(gauss_ws))
        qacc = torch.where((cost_ws < cost_sm)[:, None], warmstart, qacc_smooth)
    Jaref = _mv(J, qacc) - efc.aref

    for _ in range(max(1, m.opt.iterations)):
        f, hess_mask = _force_and_hessian_mask(efc, Jaref)
        # grad = M (qacc - qacc_smooth) - J^T f
        Ma_err = _mv(M, qacc - qacc_smooth)
        grad = Ma_err - _mv(Jt, f)
        # H = M + J^T diag(D * hess_mask) J
        w = efc.D * hess_mask
        H = M + (J * w[..., None]).transpose(-1, -2) @ J
        direction = -linalg.solve_psd(H, grad)

        # --- linesearch on alpha (piecewise-quadratic 1D objective) ---
        # bracket the minimum (phi' sign change), then ls_iterations of
        # safeguarded Newton/bisection
        Jd = _mv(J, direction)
        Md = _mv(M, direction)
        smooth_b = _dot(direction, Ma_err)  # phi_s'(0)
        smooth_a = _dot(direction, Md)  # phi_s''
        exists = efc.pos < 0.0

        def dphi(alpha):
            # alpha (B,) or (B, K): one phi' / phi'' per env and candidate
            if alpha.dim() == 2:
                x = Jaref[:, None] + alpha[..., None] * Jd[:, None]
                D, floss, jd = efc.D[:, None], efc.floss[:, None], Jd[:, None]
                sb, sa = smooth_b[:, None], smooth_a[:, None]
                ex = exists[:, None]
            else:
                x = Jaref + alpha[..., None] * Jd
                D, floss, jd, sb, sa, ex = efc.D, efc.floss, Jd, smooth_b, smooth_a, exists
            quad_active = efc.is_quad & ex & (x < 0.0)
            Dx = D * x
            inside = efc.is_friction & (torch.abs(Dx) <= floss)
            saturated = efc.is_friction & ~inside
            act = quad_active | inside
            d1 = (
                sb
                + sa * alpha
                + (D * x * jd * act).sum(-1)
                + (floss * torch.sign(x) * jd * saturated).sum(-1)
            )
            d2 = sa + (D * jd * jd * act).sum(-1)
            return d1, d2

        zero = torch.zeros_like(smooth_a)
        d1_0, d2_0 = dphi(zero)
        descent = d1_0 < 0.0
        # expand hi until phi'(hi) >= 0: all 8 doublings at once
        hi0 = torch.where(d2_0 > _TINY, -d1_0 / torch.clamp(d2_0, min=_TINY), 1.0)
        hi0 = torch.clamp(hi0, min=1e-8)
        doublings = 2.0 ** torch.arange(8, dtype=qacc.dtype, device=qacc.device)
        d1_cand, _ = dphi(hi0[:, None] * doublings)
        still_neg = torch.cumprod((d1_cand < 0.0).to(qacc.dtype), dim=-1)
        hi = hi0 * 2.0 ** still_neg.sum(-1)
        lo = zero
        alpha = 0.5 * (lo + hi)
        for _ls in range(max(1, m.opt.ls_iterations)):
            d1_a, d2_a = dphi(alpha)
            lo = torch.where(d1_a < 0.0, alpha, lo)
            hi = torch.where(d1_a >= 0.0, alpha, hi)
            newton = alpha - d1_a / torch.clamp(d2_a, min=_TINY)
            mid = 0.5 * (lo + hi)
            alpha = torch.where((newton > lo) & (newton < hi) & (d2_a > _TINY), newton, mid)
        alpha = torch.where(descent, alpha, 0.0)

        qacc = qacc + alpha[:, None] * direction
        Jaref = Jaref + alpha[:, None] * Jd

    f, _ = _force_and_hessian_mask(efc, Jaref)
    return qacc, _mv(Jt, f)
