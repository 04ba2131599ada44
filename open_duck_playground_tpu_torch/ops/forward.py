"""Forward dynamics + semi-implicit Euler stepping + sensors, batched.

Counterpart of the JAX package's ``ops/forward.py``: the general physics
pipeline, MuJoCo's mj_step for the feature subset the duck scenes use
(Euler integrator, eulerdamp disabled, position servos, pyramidal contacts):
position stage -> velocity stage -> actuation -> smooth acceleration ->
Newton constraint solve -> integrate.

Every function takes and returns tensors with a leading env dim on the
device of its inputs; the model's DR fields may be shared or ``(B, ...)``.
``step_n`` is a python loop of ``step`` (the JAX package's ``lax.scan``).
This is the plain, stage-by-stage engine the env runs with
``physics="pipeline"``: thousands of small batched operations per substep,
no fused kernel (the kernel is ``ops/cuda_step.py``). After its first call
a step makes no tensor from host memory and reads nothing back (the
index and constant tables are made once, ``smooth.index`` and
``smooth.constant``), so on the card a
control step can be recorded as one CUDA graph and replayed
(``envs/wrapper.EnvStepProgram``, ``train/ppo.RolloutProgram``): the
counterpart of the JAX package's ``step_n`` compiled by XLA inside its
jitted programs.
"""

from __future__ import annotations

import torch

from open_duck_playground_tpu_torch.ops import collision as coll
from open_duck_playground_tpu_torch.ops import constraint as con
from open_duck_playground_tpu_torch.ops import linalg
from open_duck_playground_tpu_torch.ops import math3d as m3
from open_duck_playground_tpu_torch.ops import smooth
from open_duck_playground_tpu_torch.ops import solver as nsolver
from open_duck_playground_tpu_torch.ops.types import (
    Contact,
    Data,
    Model,
    PairType,
    SensorType,
)

# ---------------------------------------------------------------------------
# Collision over the static pair list
# ---------------------------------------------------------------------------


def collide(m: Model, geom_xpos, geom_xmat) -> Contact:
    """Narrowphase over the static pair list -> 4 * npair contacts per env."""
    B, dev, dtype = geom_xpos.shape[0], geom_xpos.device, geom_xpos.dtype
    dists, poss, frames, valids, g1s, g2s = [], [], [], [], [], []
    for p in range(m.npair):
        g1, g2 = int(m.pair_geom1[p]), int(m.pair_geom2[p])
        ptype = int(m.pair_type[p])
        if ptype == PairType.PLANE_HULL:
            verts = m.hull_vert[int(m.geom_dataid[g2])]
            dist, pos, frame, valid = coll.plane_hull(
                geom_xpos[:, g1], geom_xmat[:, g1], geom_xpos[:, g2], geom_xmat[:, g2], verts)
        elif ptype == PairType.HFIELD_HULL:
            verts = m.hull_vert[int(m.geom_dataid[g2])]
            dist, pos, frame, valid = coll.hfield_hull(
                geom_xpos[:, g1], geom_xmat[:, g1], m.hfield_data, m.hfield_size,
                geom_xpos[:, g2], geom_xmat[:, g2], verts)
        elif ptype == PairType.HULL_HULL:
            h1, h2 = int(m.geom_dataid[g1]), int(m.geom_dataid[g2])
            dist, pos, frame, valid = coll.hull_hull(
                geom_xpos[:, g1], geom_xmat[:, g1], m.hull_vert[h1],
                m.hull_face_n[h1], m.hull_face_d[h1],
                geom_xpos[:, g2], geom_xmat[:, g2], m.hull_vert[h2],
                m.hull_face_n[h2], m.hull_face_d[h2])
        else:
            raise NotImplementedError(f"pair type {ptype}")
        dists.append(dist)
        poss.append(pos)
        frames.append(frame[:, None].expand(B, 4, 3, 3))
        valids.append(valid)
        g1s += [g1] * 4
        g2s += [g2] * 4

    ncon = 4 * m.npair
    z = lambda *s, dt=dtype: torch.zeros(B, ncon, *s, dtype=dt, device=dev)  # noqa: E731
    if m.npair == 0:
        return Contact(dist=z(), pos=z(3), frame=z(3, 3), friction=z(3), solref=z(2),
                       solimp=z(5), geom1=z(dt=torch.int32), geom2=z(dt=torch.int32),
                       efc_valid=z(dt=torch.bool))
    geom = lambda g: smooth.index(g, dev).to(torch.int32).expand(B, ncon)  # noqa: E731
    return Contact(
        dist=torch.cat(dists, 1),
        pos=torch.cat(poss, 1),
        frame=torch.cat(frames, 1),
        friction=z(3),
        solref=z(2),
        solimp=z(5),
        geom1=geom(g1s),
        geom2=geom(g2s),
        efc_valid=torch.cat(valids, 1),
    )


# ---------------------------------------------------------------------------
# Actuation (position servos over joints)
# ---------------------------------------------------------------------------


def actuation(m: Model, qpos, qvel, ctrl):
    """Position-servo forces: gain*ctrl + bias(q, qdot), forcerange-clamped;
    returns actuator_force (B, nu) and qfrc_actuator (B, nv).

    MuJoCo <position kp kv>: gainprm=(kp,0,0), biasprm=(0,-kp,-kv), with
    ctrl clamped to ctrlrange.
    """
    m = smooth.dr_view(m)
    trn = m.actuator_trnid.np
    qadr = smooth.index([int(m.jnt_qposadr[j]) for j in trn], qpos.device)
    vadr = smooth.index([int(m.jnt_dofadr[j]) for j in trn], qpos.device)
    ctrl_c = torch.minimum(torch.maximum(ctrl, m.actuator_ctrlrange[:, 0]),
                           m.actuator_ctrlrange[:, 1])
    length = qpos[:, qadr] * m.actuator_gear
    velocity = qvel[:, vadr] * m.actuator_gear
    gain, bias = m.actuator_gainprm, m.actuator_biasprm
    force = (
        gain[:, :, 0] * ctrl_c
        + bias[:, :, 0]
        + bias[:, :, 1] * length
        + bias[:, :, 2] * velocity
    )
    force = torch.minimum(torch.maximum(force, m.actuator_forcerange[:, 0]),
                          m.actuator_forcerange[:, 1])
    qfrc = torch.zeros_like(qvel).index_add_(1, vadr, force * m.actuator_gear)
    return force, qfrc


# ---------------------------------------------------------------------------
# Sensors
# ---------------------------------------------------------------------------


def _point_vel(cvel_body, point, origin):
    w = cvel_body[..., :3]
    v = cvel_body[..., 3:]
    return v + m3.cross(w, point - origin)


def _rt(R, v):
    """R^T v for R (B, 3, 3), v (B, 3)."""
    return (R.transpose(-1, -2) @ v[..., None])[..., 0]


def sensors(m: Model, d_xquat, site_xpos, site_xmat, subtree_com, cvel, cacc, m_site_quat):
    """Evaluate the sensor table -> sensordata (B, nsensordata).

    Covers the 15 sensors of the duck model: gyro, velocimeter,
    accelerometer, framexaxis/zaxis, framelinvel, frameangvel, framepos,
    framequat (all on sites).
    """
    out = []
    for s in range(len(m.sensor_type)):
        stype = int(m.sensor_type[s])
        sid = int(m.sensor_objid[s])
        body = int(m.site_bodyid[sid])
        root = int(m.body_rootid[body])
        origin = subtree_com[:, root]
        p = site_xpos[:, sid]
        R = site_xmat[:, sid]
        w_world = cvel[:, body, :3]
        if stype == SensorType.GYRO:
            out.append(_rt(R, w_world))
        elif stype == SensorType.VELOCIMETER:
            out.append(_rt(R, _point_vel(cvel[:, body], p, origin)))
        elif stype == SensorType.ACCELEROMETER:
            a_ang = cacc[:, body, :3]
            a_lin = cacc[:, body, 3:] + m3.cross(a_ang, p - origin)
            v_p = _point_vel(cvel[:, body], p, origin)
            a_point = a_lin + m3.cross(w_world, v_p)
            out.append(_rt(R, a_point))
        elif stype == SensorType.FRAMEXAXIS:
            out.append(R[..., :, 0])
        elif stype == SensorType.FRAMEZAXIS:
            out.append(R[..., :, 2])
        elif stype == SensorType.FRAMELINVEL:
            out.append(_point_vel(cvel[:, body], p, origin))
        elif stype == SensorType.FRAMEANGVEL:
            out.append(w_world)
        elif stype == SensorType.FRAMEPOS:
            out.append(p)
        elif stype == SensorType.FRAMEQUAT:
            out.append(m3.quat_mul(d_xquat[:, body], m_site_quat[sid]))
        else:
            raise NotImplementedError(f"sensor type {stype}")
    if not out:
        return site_xpos.new_zeros(site_xpos.shape[0], 0)
    return torch.cat(out, -1)


# ---------------------------------------------------------------------------
# Forward + step
# ---------------------------------------------------------------------------


def forward(m: Model, d: Data) -> Data:
    """Full forward dynamics: fills every derived field of Data."""
    m = smooth.dr_view(m)
    qpos, qvel, ctrl = d.qpos, d.qvel, d.ctrl

    # position stage
    xpos, xquat, xmat, xanchor, xaxis = smooth.kinematics(m, qpos)
    site_xpos, site_xmat = smooth.site_kinematics(m, xpos, xquat)
    geom_xpos, geom_xmat = smooth.geom_kinematics(m, xpos, xquat)
    subtree_com, xipos, cinert, cdof = smooth.com_pos(m, xpos, xquat, xmat, xanchor, xaxis)
    M = smooth.crb(m, cinert, cdof)
    contact = collide(m, geom_xpos, geom_xmat)

    # velocity stage
    cvel, cdofdot = smooth.com_vel(m, cdof, qvel)
    qfrc_bias = smooth.rne(m, cinert, cdof, cdofdot, cvel, qvel)
    qfrc_passive = -m.dof_damping * qvel

    # actuation
    actuator_force, qfrc_actuator = actuation(m, qpos, qvel, ctrl)

    # smooth acceleration
    qfrc_smooth = qfrc_passive - qfrc_bias + qfrc_actuator
    qacc_smooth = linalg.solve_psd(M, qfrc_smooth)

    # constraints, warmstarted from the previous solve (saved back into
    # qacc_warmstart below)
    efc = con.make_efc(m, qvel, qpos, contact, cdof, subtree_com)
    qacc, qfrc_constraint = nsolver.solve(m, M, qacc_smooth, efc, warmstart=d.qacc_warmstart)

    # acceleration-stage sensors need post-constraint body accelerations
    cacc = smooth.rne_postconstraint_cacc(m, cinert, cdof, cdofdot, qvel, qacc)
    sdata = sensors(m, xquat, site_xpos, site_xmat, subtree_com, cvel, cacc, m.site_quat)

    return d.replace(
        qacc=qacc,
        qacc_warmstart=qacc,
        xpos=xpos,
        xquat=xquat,
        xmat=xmat,
        xipos=xipos,
        site_xpos=site_xpos,
        site_xmat=site_xmat,
        subtree_com=subtree_com,
        actuator_force=actuator_force,
        qfrc_actuator=qfrc_actuator,
        qfrc_smooth=qfrc_smooth,
        qfrc_constraint=qfrc_constraint,
        cvel=cvel,
        sensordata=sdata,
        contact=contact,
    )


def step(m: Model, d: Data) -> Data:
    """One physics step: forward dynamics then semi-implicit Euler.

    Derived fields in the returned Data belong to the pre-integration state,
    as in MuJoCo's mj_step (sensors lag integration by one step).
    """
    d = forward(m, d)
    dt = m.opt.timestep
    qvel_new = d.qvel + dt * d.qacc
    qpos_new = smooth.integrate(m, d.qpos, qvel_new, dt)
    return d.replace(qpos=qpos_new, qvel=qvel_new, time=d.time + dt)


def step_n(m: Model, d: Data, ctrl: torch.Tensor, n_substeps: int) -> Data:
    """n_substeps physics steps holding ctrl fixed (control decimation)."""
    d = d.replace(ctrl=ctrl)
    m = smooth.dr_view(m)
    for _ in range(n_substeps):
        d = step(m, d)
    return d


def make_data(m: Model, B: int, device=None, dtype=torch.float32) -> Data:
    """Fresh Data for B envs at qpos0 (per env where DR batched it), zero
    velocity, on `device` (the model's if None)."""
    device = m.qpos0.device if device is None else torch.device(device)
    ncon = m.ncon
    z = lambda *s, dt=dtype: torch.zeros(B, *s, dtype=dt, device=device)  # noqa: E731
    xquat = z(m.nbody, 4)
    xquat[..., 0] = 1.0
    return Data(
        qpos=m.qpos0.to(device, dtype).expand(B, m.nq).clone(),
        qvel=z(m.nv),
        ctrl=z(m.nu),
        qacc=z(m.nv),
        qacc_warmstart=z(m.nv),
        time=z(),
        xpos=z(m.nbody, 3),
        xquat=xquat,
        xmat=z(m.nbody, 3, 3),
        xipos=z(m.nbody, 3),
        site_xpos=z(m.nsite, 3),
        site_xmat=z(m.nsite, 3, 3),
        subtree_com=z(m.nbody, 3),
        actuator_force=z(m.nu),
        qfrc_actuator=z(m.nv),
        qfrc_smooth=z(m.nv),
        qfrc_constraint=z(m.nv),
        cvel=z(m.nbody, 6),
        sensordata=z(m.nsensordata),
        contact=Contact(
            dist=torch.full((B, ncon), coll.BIG, dtype=dtype, device=device),
            pos=z(ncon, 3),
            frame=z(ncon, 3, 3),
            friction=z(ncon, 3),
            solref=z(ncon, 2),
            solimp=z(ncon, 5),
            geom1=z(ncon, dt=torch.int32),
            geom2=z(ncon, dt=torch.int32),
            efc_valid=z(ncon, dt=torch.bool),
        ),
    )


def init(m: Model, qpos: torch.Tensor, qvel: torch.Tensor, ctrl: torch.Tensor) -> Data:
    """mjx_env.init: set the state (B, ...) and run one forward pass."""
    d = make_data(m, qpos.shape[0], qpos.device, qpos.dtype)
    d = d.replace(qpos=qpos, qvel=qvel, ctrl=ctrl)
    return forward(m, d)
