"""Smooth (unconstrained) dynamics: kinematics, com quantities, CRB, RNE.

Counterpart of the JAX package's ``ops/smooth.py``, batched over envs: every
state tensor carries a leading env dim ``(B, ...)``. The loops over bodies,
joints and dofs are python loops over the model's structure, read from its
host copies (``StaticArray``), so a step never reads a device value back.

Model fields are shared, or ``(B, ...)`` where domain randomization replaced
them (``DR_FIELDS``). ``dr_view`` gives every DR field a leading dim (1 when
shared), so the stages index them as ``[:, i]`` and broadcast both forms.

Spatial vectors are (angular, linear) at the root-subtree-com origin in
world orientation (see ops.math3d).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from open_duck_playground_tpu_torch.ops import math3d as m3
from open_duck_playground_tpu_torch.ops.lane_physics import DR_FIELDS
from open_duck_playground_tpu_torch.ops.types import JointType, Model


def dr_view(m: Model) -> Model:
    """`m` with a leading env dim on every DR field: 1 where the field is
    shared, B where domain randomization batched it (idempotent)."""
    if m.body_mass.dim() == 2:
        return m
    return m.replace(**{f: getattr(m, f)[None] for f in DR_FIELDS})


_INDEX_CACHE: Dict[tuple, torch.Tensor] = {}


def index(ids, device) -> torch.Tensor:
    """A host index list as an int64 tensor on `device`, made once: indexing
    a CUDA tensor with a host array would copy it to the card at every call."""
    a = np.asarray(ids, np.int64)
    key = (a.tobytes(), a.shape, str(device))
    t = _INDEX_CACHE.get(key)
    if t is None:
        t = _INDEX_CACHE[key] = torch.as_tensor(a, device=device)
    return t


def constant(a: np.ndarray, key: tuple, device, dtype) -> torch.Tensor:
    """A host table (a mask, one-hot rows) as a `dtype` tensor on `device`,
    made once per key."""
    k = ("constant",) + key + (str(device), dtype)
    t = _INDEX_CACHE.get(k)
    if t is None:
        t = _INDEX_CACHE[k] = torch.as_tensor(a, device=device, dtype=dtype)
    return t


def _unit(B: int, n: int, i: int, like: torch.Tensor) -> torch.Tensor:
    e = torch.zeros(B, n, dtype=like.dtype, device=like.device)
    e[:, i] = 1.0
    return e


def kinematics(m: Model, qpos: torch.Tensor):
    """Forward kinematics of qpos (B, nq).

    Returns: xpos (B,nbody,3), xquat (B,nbody,4), xmat (B,nbody,3,3),
             xanchor (B,njnt,3), xaxis (B,njnt,3)
    Hinge angles are measured relative to qpos0 (domain randomization of
    qpos0 shifts the joint zero).
    """
    m = dr_view(m)
    B = qpos.shape[0]
    xpos = [torch.zeros(B, 3, dtype=qpos.dtype, device=qpos.device)]
    xquat = [_unit(B, 4, 0, qpos)]
    xanchor = [None] * m.njnt
    xaxis = [None] * m.njnt

    for b in range(1, m.nbody):
        p = int(m.body_parentid[b])
        pos = xpos[p] + m3.quat_rot(xquat[p], m.body_pos[b])
        quat = m3.quat_mul(xquat[p], m.body_quat[b])
        jadr, jnum = int(m.body_jntadr[b]), int(m.body_jntnum[b])
        for j in range(jadr, jadr + jnum):
            jtype = int(m.jnt_type[j])
            qadr = int(m.jnt_qposadr[j])
            if jtype == JointType.FREE:
                pos = qpos[:, qadr : qadr + 3]
                quat = m3.normalize(qpos[:, qadr + 3 : qadr + 7])
                xanchor[j] = pos
                xaxis[j] = m3.quat_rot(quat, m.jnt_axis[j])
            elif jtype == JointType.HINGE:
                angle = qpos[:, qadr] - m.qpos0[:, qadr]
                anchor = pos + m3.quat_rot(quat, m.jnt_pos[j])
                qloc = m3.axis_angle_to_quat(m.jnt_axis[j], angle)
                quat = m3.quat_mul(quat, qloc)
                quat = m3.normalize(quat)
                pos = anchor - m3.quat_rot(quat, m.jnt_pos[j])
                xanchor[j] = anchor
                xaxis[j] = m3.quat_rot(quat, m.jnt_axis[j])
            else:
                raise NotImplementedError(f"joint type {jtype}")
        xpos.append(pos.expand(B, 3))
        xquat.append(quat.expand(B, 4))

    xpos = torch.stack(xpos, 1)
    xquat = torch.stack(xquat, 1)
    xmat = m3.quat_to_mat(xquat)
    if m.njnt == 0:
        xanchor = xaxis = qpos.new_zeros(B, 0, 3)
    else:
        z = qpos.new_zeros(B, 3)
        xanchor = torch.stack([a if a is not None else z for a in xanchor], 1)
        xaxis = torch.stack([a if a is not None else _unit(B, 3, 2, qpos) for a in xaxis], 1)
    return xpos, xquat, xmat, xanchor, xaxis


def site_kinematics(m: Model, xpos, xquat):
    """World pose of all sites."""
    bid = index(m.site_bodyid.np, xpos.device)
    spos = xpos[:, bid] + m3.quat_rot(xquat[:, bid], m.site_pos)
    squat = m3.quat_mul(xquat[:, bid], m.site_quat)
    return spos, m3.quat_to_mat(squat)


def geom_kinematics(m: Model, xpos, xquat):
    bid = index(m.geom_bodyid.np, xpos.device)
    gpos = xpos[:, bid] + m3.quat_rot(xquat[:, bid], m.geom_pos)
    gquat = m3.quat_mul(xquat[:, bid], m.geom_quat)
    return gpos, m3.quat_to_mat(gquat)


def com_pos(m: Model, xpos, xquat, xmat, xanchor, xaxis):
    """Center-of-mass based quantities: subtree_com (B,nbody,3), xipos
    (B,nbody,3), cinert (B,nbody,6,6), cdof (B,nv,6).

    All spatial quantities are expressed at each kinematic tree's root
    subtree com (MuJoCo's "c-frame").
    """
    m = dr_view(m)
    B = xpos.shape[0]
    xipos = xpos + m3.quat_rot(xquat, m.body_ipos)
    ximat = m3.quat_to_mat(m3.quat_mul(xquat, m.body_iquat))

    # subtree com, bottom-up
    mass = m.body_mass  # (1|B, nbody)
    seg = [mass[:, b, None] * xipos[:, b] for b in range(m.nbody)]
    segm = [mass[:, b] for b in range(m.nbody)]
    for b in range(m.nbody - 1, 0, -1):
        p = int(m.body_parentid[b])
        seg[p] = seg[p] + seg[b]
        segm[p] = segm[p] + segm[b]
    subtree_com = torch.stack(
        [seg[b] / torch.clamp(segm[b], min=1e-12)[:, None] for b in range(m.nbody)], 1
    )

    root_com = subtree_com[:, index(m.body_rootid.np, xpos.device)]

    # spatial inertia of each body about its root com, world orientation
    inertia_world = ximat @ (m.body_inertia[..., None] * ximat.transpose(-1, -2))
    offset = xipos - root_com
    cinert = m3.spatial_inertia(mass, inertia_world, offset)

    # cdof
    cdof = [None] * m.nv
    for j in range(m.njnt):
        jtype = int(m.jnt_type[j])
        vadr = int(m.jnt_dofadr[j])
        b = int(m.jnt_bodyid[j])
        anc_off = xanchor[:, j] - root_com[:, b]
        if jtype == JointType.FREE:
            for i in range(3):
                cdof[vadr + i] = _unit(B, 6, 3 + i, xpos)
            for i in range(3):
                axis = xmat[:, b, :, i]  # body axes in world (local angular velocity)
                cdof[vadr + 3 + i] = torch.cat([axis, m3.cross(axis, -anc_off)], -1)
        else:  # hinge
            axis = xaxis[:, j]
            cdof[vadr] = torch.cat([axis, m3.cross(axis, -anc_off)], -1)
    cdof = torch.stack(cdof, 1) if m.nv else xpos.new_zeros(B, 0, 6)

    return subtree_com, xipos, cinert, cdof


def crb(m: Model, cinert, cdof) -> torch.Tensor:
    """Composite-rigid-body dense joint-space inertia matrix M (B, nv, nv)."""
    m = dr_view(m)
    crb_inert = [cinert[:, b] for b in range(m.nbody)]
    for b in range(m.nbody - 1, 0, -1):
        p = int(m.body_parentid[b])
        if p > 0:
            crb_inert[p] = crb_inert[p] + crb_inert[b]

    # F[i] = crb[body(dof_i)] @ cdof[i]
    dof_body = m.dof_bodyid.np
    crb_stack = torch.stack([crb_inert[int(dof_body[i])] for i in range(m.nv)], 1)
    F = torch.einsum("bvij,bvj->bvi", crb_stack, cdof)

    # dense M with kinematic-tree sparsity mask (j ancestor-or-self of i)
    mask = constant(_ancestor_mask(m), ("anc", m.dof_parentid, m.nv), cdof.device, cdof.dtype)
    L = (F @ cdof.transpose(-1, -2)) * mask
    M = L + L.transpose(-1, -2) - torch.diag_embed(torch.diagonal(L, dim1=-2, dim2=-1))
    M = M + torch.diag_embed(m.dof_armature)
    return M


_ANCESTOR_MASK_CACHE = {}


def _ancestor_mask(m: Model) -> np.ndarray:
    """mask[i, j] = 1 if dof j is an ancestor of (or equal to) dof i."""
    key = (m.dof_parentid, m.nv)
    cached = _ANCESTOR_MASK_CACHE.get(key)
    if cached is not None:
        return cached
    mask = np.zeros((m.nv, m.nv), dtype=np.float32)
    for i in range(m.nv):
        j = i
        while j >= 0:
            mask[i, j] = 1.0
            j = int(m.dof_parentid[j])
    _ANCESTOR_MASK_CACHE[key] = mask
    return mask


def com_vel(m: Model, cdof, qvel) -> Tuple[torch.Tensor, torch.Tensor]:
    """Body spatial velocities and cdof time-derivatives.

    Returns cvel (B, nbody, 6), cdofdot (B, nv, 6). Matches mj_comVel: each
    dof's cdofdot uses the spatial velocity accumulated so far (ancestors
    plus earlier dofs of the same joint).
    """
    B = cdof.shape[0]
    zero6 = cdof.new_zeros(B, 6)
    cvel = [zero6]
    cdofdot = [None] * m.nv
    for b in range(1, m.nbody):
        p = int(m.body_parentid[b])
        v = cvel[p]
        jadr, jnum = int(m.body_jntadr[b]), int(m.body_jntnum[b])
        for j in range(jadr, jadr + jnum):
            jtype = int(m.jnt_type[j])
            vadr = int(m.jnt_dofadr[j])
            if jtype == JointType.FREE:
                # translation dofs: world-fixed axes, cdofdot = 0
                for i in range(vadr, vadr + 3):
                    cdofdot[i] = zero6
                    v = v + cdof[:, i] * qvel[:, i, None]
                # rotation dofs: body-fixed axes; all three cdofdots use the
                # velocity excluding this joint's own rotational dofs
                v_pre = v
                for i in range(vadr + 3, vadr + 6):
                    cdofdot[i] = m3.motion_cross(v_pre, cdof[:, i])
                    v = v + cdof[:, i] * qvel[:, i, None]
            else:  # hinge: axis carried by parent chain + earlier joints
                i = vadr
                cdofdot[i] = m3.motion_cross(v, cdof[:, i])
                v = v + cdof[:, i] * qvel[:, i, None]
        cvel.append(v)
    cvel = torch.stack(cvel, 1)
    cdofdot = (torch.stack([d if d is not None else zero6 for d in cdofdot], 1)
               if m.nv else cdof.new_zeros(B, 0, 6))
    return cvel, cdofdot


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product A (..., n, k) x (..., k)."""
    return (A @ x[..., None])[..., 0]


def _gravity_acc(m: Model, B: int, like: torch.Tensor) -> torch.Tensor:
    g = m.opt.gravity.to(like.dtype)
    return torch.cat([torch.zeros_like(g), -g]).expand(B, 6)


def rne(m: Model, cinert, cdof, cdofdot, cvel, qvel) -> torch.Tensor:
    """Recursive Newton-Euler bias force C(q, qvel) (gravity + coriolis),
    (B, nv); the flg_acc = 0 variant (no qacc) of forward dynamics."""
    B = cdof.shape[0]
    cacc = [_gravity_acc(m, B, cdof)]
    cfrc = [cdof.new_zeros(B, 6)]
    for b in range(1, m.nbody):
        p = int(m.body_parentid[b])
        a = cacc[p]
        dofadr, dofnum = int(m.body_dofadr[b]), int(m.body_dofnum[b])
        for i in range(dofadr, dofadr + dofnum):
            a = a + cdofdot[:, i] * qvel[:, i, None]
        cacc.append(a)
        Iv = _mv(cinert[:, b], cvel[:, b])
        f = _mv(cinert[:, b], a) + m3.force_cross(cvel[:, b], Iv)
        cfrc.append(f)

    # backward accumulation
    for b in range(m.nbody - 1, 0, -1):
        p = int(m.body_parentid[b])
        if p > 0:
            cfrc[p] = cfrc[p] + cfrc[b]

    dof_body = m.dof_bodyid.np
    cfrc_stack = torch.stack([cfrc[int(dof_body[i])] for i in range(m.nv)], 1)
    return torch.einsum("bvi,bvi->bv", cdof, cfrc_stack)


def rne_postconstraint_cacc(m: Model, cinert, cdof, cdofdot, qvel, qacc) -> torch.Tensor:
    """Body spatial accelerations (B, nbody, 6) including the actual qacc
    (for acceleration sensors; MuJoCo's mj_rnePostConstraint)."""
    B = cdof.shape[0]
    cacc = [_gravity_acc(m, B, cdof)]
    for b in range(1, m.nbody):
        p = int(m.body_parentid[b])
        a = cacc[p]
        dofadr, dofnum = int(m.body_dofadr[b]), int(m.body_dofnum[b])
        for i in range(dofadr, dofadr + dofnum):
            a = a + cdofdot[:, i] * qvel[:, i, None] + cdof[:, i] * qacc[:, i, None]
        cacc.append(a)
    return torch.stack(cacc, 1)


def jac_point(m: Model, cdof, subtree_com, point: torch.Tensor, body: int):
    """Translational and rotational jacobians of world points on `body`.

    point (B, ..., 3). Returns jacp, jacr (B, ..., nv, 3):
    d(point linear / angular velocity)/dqvel.
    """
    lead = point.shape[1:-1]
    offset = point - subtree_com[:, int(m.body_rootid[body])].reshape(
        (point.shape[0],) + (1,) * len(lead) + (3,))
    c = cdof.reshape((cdof.shape[0],) + (1,) * len(lead) + cdof.shape[1:])
    jacp = c[..., 3:] + m3.cross(c[..., :3], offset[..., None, :])
    jacr = c[..., :3]
    mask = constant(_body_dof_mask(m, body), ("body", m.dof_parentid, m.body_dofadr, body),
                    cdof.device, cdof.dtype)
    return jacp * mask[:, None], jacr * mask[:, None]


_BODY_DOF_MASK_CACHE = {}


def _body_dof_mask(m: Model, body: int) -> np.ndarray:
    """(nv,) mask of dofs that influence `body` (dofs of ancestor chain)."""
    key = (m.dof_parentid, m.body_dofadr, body)
    cached = _BODY_DOF_MASK_CACHE.get(key)
    if cached is not None:
        return cached
    mask = np.zeros((m.nv,), dtype=np.float32)
    b = body
    while b > 0:
        adr, num = int(m.body_dofadr[b]), int(m.body_dofnum[b])
        for i in range(adr, adr + num):
            mask[i] = 1.0
        b = int(m.body_parentid[b])
    _BODY_DOF_MASK_CACHE[key] = mask
    return mask


def integrate(m: Model, qpos: torch.Tensor, qvel: torch.Tensor, dt: float) -> torch.Tensor:
    """MuJoCo mj_integratePos: advance qpos by qvel*dt (quaternion-aware)."""
    out = qpos.clone()
    hinge_q, hinge_v = [], []
    for j in range(m.njnt):
        jtype = int(m.jnt_type[j])
        qadr = int(m.jnt_qposadr[j])
        vadr = int(m.jnt_dofadr[j])
        if jtype == JointType.FREE:
            out[:, qadr : qadr + 3] = qpos[:, qadr : qadr + 3] + dt * qvel[:, vadr : vadr + 3]
            out[:, qadr + 3 : qadr + 7] = m3.quat_integrate(
                qpos[:, qadr + 3 : qadr + 7], qvel[:, vadr + 3 : vadr + 6], dt)
        else:  # hinge
            hinge_q.append(qadr)
            hinge_v.append(vadr)
    if hinge_q:
        q, v = index(hinge_q, qpos.device), index(hinge_v, qpos.device)
        out[:, q] = qpos[:, q] + dt * qvel[:, v]
    return out
