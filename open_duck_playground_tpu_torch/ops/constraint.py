"""Constraint row assembly: dof friction, joint limits, pyramidal contacts.

Counterpart of the JAX package's ``ops/constraint.py``, batched over envs:
a static-shape dense efc system (J, D, aref, pos, frictionloss) following
MuJoCo's constraint model (solref/solimp impedances, pyramidal cone,
condim 3 on the floor).

Row order: [dof friction] [joint limits] [contact pyramid rows]. The rows of
one kind are built together (one batched operation per kind, not per row);
each row's arithmetic is the JAX package's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from open_duck_playground_tpu_torch.ops import lane as ln
from open_duck_playground_tpu_torch.ops import smooth
from open_duck_playground_tpu_torch.ops.types import Contact, Model

_MINVAL = 1e-10


class Efc(NamedTuple):
    J: torch.Tensor  # (B, nefc, nv)
    D: torch.Tensor  # (B, nefc)
    aref: torch.Tensor  # (B, nefc)
    pos: torch.Tensor  # (B, nefc)  (<= 0 means violated; friction rows: 0)
    floss: torch.Tensor  # (B, nefc) friction loss bound (0 for non-friction rows)
    is_friction: torch.Tensor  # (nefc,) bool
    is_quad: torch.Tensor  # (nefc,) bool (limits + contacts: unilateral)


def kbi(solref: torch.Tensor, solimp: torch.Tensor, pos: torch.Tensor):
    """MuJoCo stiffness/damping/impedance from solver parameters.

    Returns (k, b, imp) with k = 1/(dmax^2 tc^2 dr^2), b = 2/(dmax tc) and
    imp the position-dependent impedance interpolated through solimp.
    """
    timeconst, dampratio = solref[..., 0], solref[..., 1]
    dmin, dmax, width, mid, power = (solimp[..., i] for i in range(5))
    dmin = torch.clamp(dmin, _MINVAL, 0.9999)
    dmax = torch.clamp(dmax, _MINVAL, 0.9999)
    k = 1.0 / torch.clamp(dmax * dmax * timeconst * timeconst * dampratio * dampratio,
                          min=_MINVAL)
    b = 2.0 / torch.clamp(dmax * timeconst, min=_MINVAL)
    # negative solref means direct (stiffness, damping) specification
    k = torch.where(timeconst <= 0, -timeconst / (dmax * dmax), k)
    b = torch.where(dampratio <= 0, -dampratio / dmax, b)

    x = torch.abs(pos) / torch.clamp(width, min=_MINVAL)
    power = torch.clamp(power, min=1.0)
    y_low = (x ** power) * (mid ** (1.0 - power))
    y_high = 1.0 - ((1.0 - x) ** power) * ((1.0 - mid) ** (1.0 - power))
    y = torch.where(x < mid, y_low, y_high)
    imp = dmin + y * (dmax - dmin)
    imp = torch.where(x >= 1.0, dmax, imp)
    imp = torch.minimum(torch.maximum(imp, dmin), dmax)
    return k, b, imp


def _combine_pair_params(m: Model, p: int):
    """Contact parameters for static pair p with MuJoCo's priority rule:
    friction (1|B, 3), solref (2,), solimp (5,)."""
    m = smooth.dr_view(m)
    g1, g2 = int(m.pair_geom1[p]), int(m.pair_geom2[p])
    p1, p2 = int(m.geom_priority[g1]), int(m.geom_priority[g2])
    if p1 > p2:
        return m.geom_friction[:, g1], m.geom_solref[g1], m.geom_solimp[g1]
    if p2 > p1:
        return m.geom_friction[:, g2], m.geom_solref[g2], m.geom_solimp[g2]
    fri = torch.maximum(m.geom_friction[:, g1], m.geom_friction[:, g2])
    solref = 0.5 * (m.geom_solref[g1] + m.geom_solref[g2])
    solimp = 0.5 * (m.geom_solimp[g1] + m.geom_solimp[g2])
    return fri, solref, solimp


def make_efc(m: Model, qvel: torch.Tensor, qpos: torch.Tensor, contact: Contact,
             cdof: torch.Tensor, subtree_com: torch.Tensor) -> Efc:
    m = smooth.dr_view(m)
    B, dev, dtype = qvel.shape[0], qvel.device, qvel.dtype
    rows_J, rows_D, rows_aref, rows_pos, rows_floss = [], [], [], [], []

    # ---- dof friction rows ----
    fri_dofs = [i for i in range(m.nv) if bool(m.dof_hasfrictionloss[i])]
    n_fri = len(fri_dofs)
    if n_fri:
        fi = smooth.index(fri_dofs, dev)
        # one-hot rows, made once: writing 1.0 through a device index would
        # copy a host scalar to the card at every step
        onehot = np.zeros((n_fri, m.nv), np.float32)
        onehot[np.arange(n_fri), fri_dofs] = 1.0
        J = smooth.constant(onehot, ("friction rows", tuple(fri_dofs)), dev, dtype)
        k, b, imp = kbi(m.dof_solref[fi], m.dof_solimp[fi], torch.zeros(n_fri, dtype=dtype,
                                                                         device=dev))
        R = torch.clamp((1.0 - imp) / imp * m.dof_invweight0[fi], min=_MINVAL)
        rows_J.append(J.expand(B, n_fri, m.nv))
        rows_D.append((1.0 / R).expand(B, n_fri))
        rows_aref.append(-b * qvel[:, fi])
        rows_pos.append(qvel.new_zeros(B, n_fri))
        rows_floss.append(m.dof_frictionloss[:, fi].expand(B, n_fri))

    # ---- joint limit rows ----
    lim_jnts = [j for j in range(m.njnt) if bool(m.jnt_limited[j])]
    n_lim = len(lim_jnts)
    if n_lim:
        lj = smooth.index(lim_jnts, dev)
        qadr = smooth.index([int(m.jnt_qposadr[j]) for j in lim_jnts], dev)
        dofadr = smooth.index([int(m.jnt_dofadr[j]) for j in lim_jnts], dev)
        q = qpos[:, qadr]
        lo, hi = m.jnt_range[lj, 0], m.jnt_range[lj, 1]
        dist_lo = q - lo
        dist_hi = hi - q
        dist = torch.minimum(dist_lo, dist_hi)
        side = torch.where(dist_lo < dist_hi, 1.0, -1.0).to(dtype)
        J = qvel.new_zeros(B, n_lim, m.nv)
        J[:, torch.arange(n_lim, device=dev), dofadr] = side
        pos = dist - m.jnt_margin[lj]
        k, b, imp = kbi(m.jnt_solref[lj], m.jnt_solimp[lj], pos)
        R = torch.clamp((1.0 - imp) / imp * m.dof_invweight0[dofadr], min=_MINVAL)
        rows_J.append(J)
        rows_D.append(1.0 / R)
        rows_aref.append(-b * (side * qvel[:, dofadr]) - k * imp * pos)
        rows_pos.append(pos)
        rows_floss.append(qvel.new_zeros(B, n_lim))

    # ---- contact rows (pyramidal, condim 3 -> 4 rows per candidate) ----
    for p in range(m.npair):
        g1, g2 = int(m.pair_geom1[p]), int(m.pair_geom2[p])
        b1, b2 = int(m.geom_bodyid[g1]), int(m.geom_bodyid[g2])
        fri, solref, solimp = _combine_pair_params(m, p)
        mu = fri[:, 0]  # (1|B,)
        invweight = m.body_invweight0[b1, 0] + m.body_invweight0[b2, 0]
        diag = invweight + mu * mu * invweight
        diag = ln.div(diag * 2.0 * mu * mu, m.opt.impratio)
        diag = torch.clamp(diag, min=_MINVAL)
        sl = slice(p * 4, p * 4 + 4)
        pos_c = contact.dist[:, sl]  # (B, 4)
        point = contact.pos[:, sl]  # (B, 4, 3)
        frame = contact.frame[:, sl]  # (B, 4, 3, 3)
        jacp1, _ = smooth.jac_point(m, cdof, subtree_com, point, b1)
        jacp2, _ = smooth.jac_point(m, cdof, subtree_com, point, b2)
        djac = jacp2 - jacp1  # (B, 4, nv, 3)
        Jn = djac @ frame[:, :, 0, :, None]
        Jt1 = djac @ frame[:, :, 1, :, None]
        Jt2 = djac @ frame[:, :, 2, :, None]
        neg = torch.clamp(pos_c, max=0.0)
        k, b, imp = kbi(solref, solimp, neg)
        R = torch.clamp((1.0 - imp) / imp * diag[:, None], min=_MINVAL)
        D = 1.0 / R  # (B, 4)
        mu_ = mu[:, None, None, None]
        Jrows = torch.stack([Jn + mu_ * Jt1, Jn - mu_ * Jt1, Jn + mu_ * Jt2, Jn - mu_ * Jt2],
                            dim=2)[..., 0]  # (B, 4 candidates, 4 rows, nv)
        Jv = (Jrows @ qvel[:, None, :, None])[..., 0]  # (B, 4, 4)
        rows_J.append(Jrows.reshape(B, 16, m.nv))
        rows_D.append(D[:, :, None].expand(B, 4, 4).reshape(B, 16))
        rows_aref.append((-b * Jv - (k * imp * neg)[..., None]).reshape(B, 16))
        rows_pos.append(pos_c[:, :, None].expand(B, 4, 4).reshape(B, 16))
        rows_floss.append(qvel.new_zeros(B, 16))

    nefc = n_fri + n_lim + 16 * m.npair
    ar = torch.arange(nefc, device=dev)
    if nefc == 0:
        z = qvel.new_zeros(B, 0)
        return Efc(qvel.new_zeros(B, 0, m.nv), z, z, z, z, ar < 0, ar < 0)
    return Efc(torch.cat(rows_J, 1), torch.cat(rows_D, 1), torch.cat(rows_aref, 1),
               torch.cat(rows_pos, 1), torch.cat(rows_floss, 1), ar < n_fri, ar >= n_fri)
