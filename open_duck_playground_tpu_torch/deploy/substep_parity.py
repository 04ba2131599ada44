"""Active-set-matched single-substep parity comparison against MuJoCo C,
on the port's general pipeline (``ops/forward.py``).

Counterpart of the JAX package's ``deploy/substep_parity.py``. Both engines
evaluate ONE forward-dynamics pass from an IDENTICAL (qpos, qvel, ctrl) with
ALIGNED warmstart (zero on both sides), removing trajectory chaos from the
comparison, so the well-posed pipeline stages can be held to float32-tight
bounds while solver-branch divergence is quantified separately:

  - qfrc_smooth / qacc_smooth  smooth dynamics (bias, passive, actuation)
  - contact geometry           (dist, normal) for matched contacts
  - efc row params             (J, D, aref) for matched friction / contact
                               pyramid rows, with the row permutation solved
                               per contact
  - post-solve qacc            split by whether the Newton ACTIVE SET agrees
                               (MuJoCo efc_state vs our quadratic-zone mask)

Reference anchor: mj_forward (MuJoCo 3.x engine_forward.c). ``mujoco`` is
imported by this module only (``deploy/__init__.py`` does not import it).
"""

from __future__ import annotations

import mujoco
import numpy as np
import torch

from open_duck_playground_tpu_torch.ops import constraint as con
from open_duck_playground_tpu_torch.ops import forward as fwd
from open_duck_playground_tpu_torch.ops import linalg, smooth
from open_duck_playground_tpu_torch.ops import solver as nsolver

STAT_KEYS = (
    "qfrc_smooth qacc_smooth con_pos con_dist con_normal_dot "
    "con_matched_frac fri_D fri_aref fri_J con_J con_D con_aref "
    "con_row_perm_fail qacc_all qacc_as_match qacc_as_mismatch as_agree"
).split()


def _row(x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.float32)[None]


def _np(x: torch.Tensor, dtype=None) -> np.ndarray:
    a = x[0].cpu().numpy()
    return a if dtype is None else a.astype(dtype)


def our_forward_pieces(om, qpos, qvel, ctrl):
    """One forward pass of one env (B=1, on the model's device), exposing
    the intermediates the comparison needs. The same call sequence as
    ops/forward.py:forward (kept in lockstep by the port's tests)."""
    dev = om.qpos0.device
    qpos, qvel, ctrl = (_row(x).to(dev) for x in (qpos, qvel, ctrl))
    xpos, xquat, xmat, xanchor, xaxis = smooth.kinematics(om, qpos)
    geom_xpos, geom_xmat = smooth.geom_kinematics(om, xpos, xquat)
    subtree_com, xipos, cinert, cdof = smooth.com_pos(om, xpos, xquat, xmat, xanchor, xaxis)
    M = smooth.crb(om, cinert, cdof)
    contact = fwd.collide(om, geom_xpos, geom_xmat)
    cvel, cdofdot = smooth.com_vel(om, cdof, qvel)
    qfrc_bias = smooth.rne(om, cinert, cdof, cdofdot, cvel, qvel)
    qfrc_passive = -om.dof_damping * qvel
    _, qfrc_actuator = fwd.actuation(om, qpos, qvel, ctrl)
    qfrc_smooth = qfrc_passive - qfrc_bias + qfrc_actuator
    qacc_smooth = linalg.solve_psd(M, qfrc_smooth)
    efc = con.make_efc(om, qvel, qpos, contact, cdof, subtree_com)
    qacc, _ = nsolver.solve(om, M, qacc_smooth, efc, warmstart=torch.zeros_like(qvel))
    # the post-solve quadratic-zone mask = our active set
    Jaref = (efc.J @ qacc[..., None])[..., 0] - efc.aref
    quad_active = efc.is_quad & (efc.pos < 0.0) & (Jaref < 0.0)
    return dict(qfrc_smooth=_np(qfrc_smooth, np.float64),
                qacc_smooth=_np(qacc_smooth, np.float64),
                qacc=_np(qacc, np.float64),
                efc=con.Efc(*(_np(x) if x.dim() > 1 else x.cpu().numpy() for x in efc)),
                contact=type(contact)(**{k: _np(v) for k, v in vars(contact).items()}),
                active=_np(quad_active))


def mj_forward_pieces(mm, dd, qpos, qvel, ctrl):
    mujoco.mj_resetData(mm, dd)
    dd.qpos[:] = qpos
    dd.qvel[:] = qvel
    dd.ctrl[:] = ctrl
    dd.qacc_warmstart[:] = 0.0
    mujoco.mj_forward(mm, dd)
    nefc, nv = dd.nefc, mm.nv
    return dict(qfrc_smooth=dd.qfrc_smooth.copy(),
                qacc_smooth=dd.qacc_smooth.copy(),
                qacc=dd.qacc.copy(),
                efc_J=dd.efc_J[: nefc * nv].reshape(nefc, nv).copy(),
                efc_D=dd.efc_D[:nefc].copy(),
                efc_aref=dd.efc_aref[:nefc].copy(),
                efc_type=dd.efc_type[:nefc].copy(),
                efc_id=dd.efc_id[:nefc].copy(),
                efc_state=dd.efc_state[:nefc].copy(),
                ncon=dd.ncon,
                con_geom=np.array([[dd.contact[i].geom1, dd.contact[i].geom2]
                                   for i in range(dd.ncon)], int).reshape(-1, 2),
                con_pos=np.array([dd.contact[i].pos for i in range(dd.ncon)],
                                 float).reshape(-1, 3),
                con_dist=np.array([dd.contact[i].dist for i in range(dd.ncon)],
                                  float),
                con_frame=np.array([dd.contact[i].frame for i in range(dd.ncon)],
                                   float).reshape(-1, 3, 3))


def geom_name_map(om, mm):
    """our geom index -> mujoco geom index, matched by name."""
    return {g: mujoco.mj_name2id(mm, mujoco.mjtObj.mjOBJ_GEOM, name)
            for name, g in om.names.geom.items()}


def compare_state(om, mm, dd, qpos, qvel, ctrl, gmap, stats):
    """Compare one state; append per-quantity errors into `stats` lists."""
    ours = our_forward_pieces(om, qpos, qvel, ctrl)
    mj = mj_forward_pieces(mm, dd, qpos, qvel, ctrl)

    stats["qfrc_smooth"].append(np.abs(ours["qfrc_smooth"] - mj["qfrc_smooth"]).max())
    stats["qacc_smooth"].append(np.abs(ours["qacc_smooth"] - mj["qacc_smooth"]).max())

    # ---- match contacts: (geom pair, nearest position) ----
    oc = ours["contact"]
    matched = []  # (our_slot, mj_con_index)
    used = set()
    for i in range(mj["ncon"]):
        mg1, mg2 = mj["con_geom"][i]
        best, best_d = None, 1e9
        for s in range(len(oc.dist)):
            if not oc.efc_valid[s] and oc.dist[s] > 0:
                continue
            og1, og2 = gmap[int(oc.geom1[s])], gmap[int(oc.geom2[s])]
            if {og1, og2} != {mg1, mg2} or s in used:
                continue
            d = np.linalg.norm(oc.pos[s] - mj["con_pos"][i])
            if d < best_d:
                best, best_d = s, d
        if best is not None and best_d < 0.02:
            matched.append((best, i))
            used.add(best)
            stats["con_pos"].append(best_d)
            stats["con_dist"].append(abs(float(oc.dist[best]) - mj["con_dist"][i]))
            # normal agreement (frame row 0)
            stats["con_normal_dot"].append(float(np.dot(oc.frame[best][0],
                                                         mj["con_frame"][i][0])))
    mj_active_con = int((mj["con_dist"] < 0).sum())
    stats["con_matched_frac"].append(
        len(matched) / max(mj_active_con, 1) if mj_active_con else 1.0)

    # ---- efc row params for matched rows ----
    # friction dof rows: both sides emit one per frictionloss dof, dof order
    efc = ours["efc"]
    mj_fri = np.where(mj["efc_type"] == int(mujoco.mjtConstraint.mjCNSTR_FRICTION_DOF))[0]
    our_fri = np.where(np.asarray(efc.is_friction))[0]
    if len(mj_fri) == len(our_fri):
        stats["fri_D"].append(np.abs(efc.D[our_fri] - mj["efc_D"][mj_fri]).max()
                              / max(np.abs(mj["efc_D"][mj_fri]).max(), 1e-9))
        stats["fri_aref"].append(np.abs(efc.aref[our_fri] - mj["efc_aref"][mj_fri]).max())
        stats["fri_J"].append(np.abs(efc.J[our_fri] - mj["efc_J"][mj_fri]).max())

    # contact pyramid rows: per matched contact, best row assignment
    con_rows_mj = {i: np.where((mj["efc_type"] == int(
        mujoco.mjtConstraint.mjCNSTR_CONTACT_PYRAMIDAL)) & (mj["efc_id"] == i))[0]
        for i in range(mj["ncon"])}
    nfri = len(our_fri)
    # our row layout: [nfri friction][nlim limits][npair*4 slots x 4 pyramid]
    nlim = int((~np.asarray(efc.is_friction)).sum()) - 16 * om.npair
    perms = {}  # our slot -> mj-pyramid-order permutation of our 4 rows
    for s, i in matched:
        rows_mj = con_rows_mj[i]
        if len(rows_mj) != 4:
            continue
        r0 = nfri + nlim + 4 * s
        ours_J = efc.J[r0:r0 + 4]
        # assignment: for each mj row find the closest of our rows
        perm = [int(np.argmin(np.abs(ours_J - mj["efc_J"][r]).max(axis=1))) for r in rows_mj]
        if sorted(perm) != [0, 1, 2, 3]:
            stats["con_row_perm_fail"].append(1.0)
            continue
        stats["con_row_perm_fail"].append(0.0)
        perms[s] = perm
        stats["con_J"].append(np.abs(ours_J[perm] - mj["efc_J"][rows_mj]).max())
        stats["con_D"].append(np.abs(efc.D[r0:r0 + 4][perm] - mj["efc_D"][rows_mj]).max()
                              / max(np.abs(mj["efc_D"][rows_mj]).max(), 1e-9))
        stats["con_aref"].append(
            np.abs(efc.aref[r0:r0 + 4][perm] - mj["efc_aref"][rows_mj]).max())

    # ---- post-solve qacc, split by active-set agreement ----
    # mj active set: efc_state == mjCNSTRSTATE_QUADRATIC for quad rows
    pyramidal = int(mujoco.mjtConstraint.mjCNSTR_CONTACT_PYRAMIDAL)
    mj_quad_rows = np.where(mj["efc_type"] != int(
        mujoco.mjtConstraint.mjCNSTR_FRICTION_DOF))[0]
    mj_active_ids = set()
    for r in mj_quad_rows:
        if mj["efc_state"][r] == int(mujoco.mjtConstraintState.mjCNSTRSTATE_QUADRATIC):
            typ, cid = int(mj["efc_type"][r]), int(mj["efc_id"][r])
            mj_active_ids.add((typ, cid, int(r - (con_rows_mj[cid][0] if typ == pyramidal
                                                  else 0))))
    # ours: quadratic-zone rows, mapped to mj pyramid order via the matched
    # row permutation (perm[mj_pos] = our row offset)
    our_active_ids = set()
    active = ours["active"]
    for s, i in matched:
        if s not in perms:
            continue
        r0 = nfri + nlim + 4 * s
        for mj_pos, our_off in enumerate(perms[s]):
            if active[r0 + our_off]:
                our_active_ids.add((pyramidal, i, mj_pos))
    # an active slot of ours that is unmatched or perm-failed cannot appear
    # in our_active_ids, so require every active slot to be mapped before
    # comparing the id sets (else a partial map could fake agreement)
    n_slots = (len(active) - nfri - nlim) // 4
    our_active_slots = {
        s for s in range(n_slots)
        if bool(oc.efc_valid[s]) and active[nfri + nlim + 4 * s:nfri + nlim + 4 * s + 4].any()
    }
    mj_con_active = {k for k in mj_active_ids if k[0] == pyramidal}
    agree = our_active_slots <= set(perms) and mj_con_active == our_active_ids
    qerr = np.abs(ours["qacc"] - mj["qacc"]).max()
    stats["qacc_all"].append(qerr)
    (stats["qacc_as_match"] if agree else stats["qacc_as_mismatch"]).append(qerr)
    stats["as_agree"].append(1.0 if agree else 0.0)


def settle_mj(mm, dd, kf, seconds=2.0):
    """MuJoCo's own settled standing state: the shared well-posed anchor."""
    mujoco.mj_resetData(mm, dd)
    dd.qpos[:] = np.asarray(kf.qpos, np.float64)
    dd.ctrl[:] = np.asarray(kf.ctrl, np.float64)
    for _ in range(int(seconds / mm.opt.timestep)):
        mujoco.mj_step(mm, dd)
    return dd.qpos.copy(), dd.qvel.copy()


def run_mode(om, mm, dd, gmap, kf, mode: str, K: int, rngmaster):
    """`perturbed`: random penetrating starts (manifolds ambiguous;
    quantifies solver-branch divergence). `settled`: MuJoCo's settled
    stance +- small velocity/ctrl noise (manifolds well-posed: the
    near-exactness regime the tests pin)."""
    stats = {k: [] for k in STAT_KEYS}
    if mode == "settled":
        qpos_s, qvel_s = settle_mj(mm, dd, kf)
    for _ in range(K):
        if mode == "settled":
            qpos = qpos_s.copy()
            qvel = qvel_s + rngmaster.uniform(-0.05, 0.05, om.nv)
            ctrl = np.asarray(kf.ctrl) + rngmaster.uniform(-0.02, 0.02, om.nu)
        else:
            qpos = np.asarray(kf.qpos, np.float64).copy()
            qpos[0:2] += rngmaster.uniform(-0.05, 0.05, 2)
            qpos[2] += rngmaster.uniform(-0.01, 0.01)
            qpos[7:] += rngmaster.uniform(-0.1, 0.1, om.nq - 7)
            qvel = rngmaster.uniform(-0.3, 0.3, om.nv)
            ctrl = np.asarray(kf.ctrl) + rngmaster.uniform(-0.1, 0.1, om.nu)
        compare_state(om, mm, dd, qpos, qvel, ctrl, gmap, stats)
    return stats
