"""Compile-time rigid-body quantities in float64 numpy.

MuJoCo derives several model constants from the dynamics at the reference
configuration qpos0 (mj_setConst): dof_invweight0 = diag(M^-1) and
body_invweight0 = mean diagonal of the body-com Jacobian pullback of M^-1.
These feed constraint impedances at runtime (see ops/constraint.py).

This module is an independent float64 implementation of FK/CoM/CRB used
only at model-compile time; it doubles as a cross-check oracle for the f32
JAX pipeline in tests.
"""

from __future__ import annotations

import numpy as np


def quat_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ]
    )


def quat_rot(q, v):
    qw, qv = q[0], q[1:4]
    uv = np.cross(qv, v)
    return v + 2.0 * (qw * uv + np.cross(qv, uv))


def quat_to_mat(q):
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def axis_angle_to_quat(axis, angle):
    return np.concatenate([[np.cos(angle / 2)], axis * np.sin(angle / 2)])


def skew(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])


class NpModel:
    """Duck-typed container: plain numpy versions of the fields FK needs."""

    pass


def fk(nm, qpos):
    """Returns xpos, xquat, xanchor, xaxis (all numpy, f64)."""
    nbody, njnt = nm.nbody, nm.njnt
    xpos = np.zeros((nbody, 3))
    xquat = np.zeros((nbody, 4))
    xquat[0, 0] = 1.0
    xanchor = np.zeros((njnt, 3))
    xaxis = np.zeros((njnt, 3))
    for b in range(1, nbody):
        p = nm.body_parentid[b]
        pos = xpos[p] + quat_rot(xquat[p], nm.body_pos[b])
        quat = quat_mul(xquat[p], nm.body_quat[b])
        for j in range(nm.body_jntadr[b], nm.body_jntadr[b] + nm.body_jntnum[b]):
            qadr = nm.jnt_qposadr[j]
            if nm.jnt_type[j] == 0:  # free
                pos = qpos[qadr : qadr + 3].copy()
                quat = qpos[qadr + 3 : qadr + 7].copy()
                quat = quat / np.linalg.norm(quat)
                xanchor[j] = pos
                xaxis[j] = quat_rot(quat, nm.jnt_axis[j])
            else:  # hinge
                angle = qpos[qadr] - nm.qpos0[qadr]
                anchor = pos + quat_rot(quat, nm.jnt_pos[j])
                quat = quat_mul(quat, axis_angle_to_quat(nm.jnt_axis[j], angle))
                quat = quat / np.linalg.norm(quat)
                pos = anchor - quat_rot(quat, nm.jnt_pos[j])
                xanchor[j] = anchor
                xaxis[j] = quat_rot(quat, nm.jnt_axis[j])
        xpos[b] = pos
        xquat[b] = quat
    return xpos, xquat, xanchor, xaxis


def com_quantities(nm, xpos, xquat, xanchor, xaxis):
    nbody, nv = nm.nbody, nm.nv
    xipos = np.zeros((nbody, 3))
    ximat = np.zeros((nbody, 3, 3))
    for b in range(nbody):
        xipos[b] = xpos[b] + quat_rot(xquat[b], nm.body_ipos[b])
        ximat[b] = quat_to_mat(quat_mul(xquat[b], nm.body_iquat[b]))

    seg = (nm.body_mass[:, None] * xipos).copy()
    segm = nm.body_mass.copy()
    for b in range(nbody - 1, 0, -1):
        p = nm.body_parentid[b]
        seg[p] += seg[b]
        segm[p] += segm[b]
    subtree_com = seg / np.maximum(segm, 1e-12)[:, None]
    root_com = subtree_com[nm.body_rootid]

    cinert = np.zeros((nbody, 6, 6))
    for b in range(nbody):
        Ic = ximat[b] @ np.diag(nm.body_inertia[b]) @ ximat[b].T
        c = skew(xipos[b] - root_com[b])
        mass = nm.body_mass[b]
        cinert[b, :3, :3] = Ic - mass * (c @ c)
        cinert[b, :3, 3:] = mass * c
        cinert[b, 3:, :3] = -mass * c
        cinert[b, 3:, 3:] = mass * np.eye(3)

    cdof = np.zeros((nv, 6))
    for j in range(nm.njnt):
        vadr = nm.jnt_dofadr[j]
        b = nm.jnt_bodyid[j]
        off = xanchor[j] - root_com[b]
        if nm.jnt_type[j] == 0:  # free
            for i in range(3):
                cdof[vadr + i, 3 + i] = 1.0
            xmat = quat_to_mat(xquat[b])
            for i in range(3):
                axis = xmat[:, i]
                cdof[vadr + 3 + i, :3] = axis
                cdof[vadr + 3 + i, 3:] = np.cross(axis, -off)
        else:
            axis = xaxis[j]
            cdof[vadr, :3] = axis
            cdof[vadr, 3:] = np.cross(axis, -off)
    return subtree_com, xipos, cinert, cdof


def crb_matrix(nm, cinert, cdof):
    nbody, nv = nm.nbody, nm.nv
    crb = cinert.copy()
    for b in range(nbody - 1, 0, -1):
        p = nm.body_parentid[b]
        if p > 0:
            crb[p] += crb[b]
    M = np.zeros((nv, nv))
    for i in range(nv):
        F = crb[nm.dof_bodyid[i]] @ cdof[i]
        j = i
        while j >= 0:
            M[i, j] = M[j, i] = F @ cdof[j]
            j = nm.dof_parentid[j]
    M += np.diag(nm.dof_armature)
    return M


def body_jacobians(nm, cdof, subtree_com, point, body):
    nv = nm.nv
    mask = np.zeros(nv)
    b = body
    while b > 0:
        adr, num = nm.body_dofadr[b], nm.body_dofnum[b]
        mask[adr : adr + num] = 1.0
        b = nm.body_parentid[b]
    off = point - subtree_com[nm.body_rootid[body]]
    jacp = (cdof[:, 3:] + np.cross(cdof[:, :3], off[None, :])) * mask[:, None]
    jacr = cdof[:, :3] * mask[:, None]
    return jacp, jacr


def set_const(nm):
    """Compute dof_invweight0, body_invweight0 at qpos0 (mj_setConst)."""
    xpos, xquat, xanchor, xaxis = fk(nm, nm.qpos0)
    subtree_com, xipos, cinert, cdof = com_quantities(nm, xpos, xquat, xanchor, xaxis)
    M = crb_matrix(nm, cinert, cdof)
    Minv = np.linalg.inv(M) if nm.nv else np.zeros((0, 0))
    dof_invweight0 = np.diag(Minv).copy() if nm.nv else np.zeros(0)
    # MuJoCo averages invweight0 over the translational and rotational dof
    # triples of free (and ball) joints (verified empirically vs mujoco 3.10).
    for j in range(nm.njnt):
        if nm.jnt_type[j] == 0:
            a = nm.jnt_dofadr[j]
            dof_invweight0[a : a + 3] = dof_invweight0[a : a + 3].mean()
            dof_invweight0[a + 3 : a + 6] = dof_invweight0[a + 3 : a + 6].mean()
    body_invweight0 = np.zeros((nm.nbody, 2))
    for b in range(1, nm.nbody):
        jacp, jacr = body_jacobians(nm, cdof, subtree_com, xipos[b], b)
        At = jacp.T @ Minv @ jacp
        Ar = jacr.T @ Minv @ jacr
        body_invweight0[b, 0] = np.trace(At) / 3.0
        body_invweight0[b, 1] = np.trace(Ar) / 3.0
    return dof_invweight0, body_invweight0, M
