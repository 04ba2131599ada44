"""One physics substep as a straight-line program over ``(B,)`` tensors.

This is the plain PyTorch version of the fused CUDA kernel
(``csrc/physics_step.cu``, wrapped by ``cuda_step.py``). It is the JAX
package's ``ops/lane_physics.py::LanePhysics`` with ``torch`` in place of
``jax.numpy`` (and ``ops/lane.py``'s ``maximum``/``minimum`` where a python
float may meet a tile): the same program, the same order of operations, so
the tests hold it against the JAX lane program on identical inputs.

A "tile" is one scalar per environment (a ``(B,)`` tensor) or a python float
for a model constant. All structural model data (tree topology, joint
addresses, constant parameters) is read once into python floats; only the
per-env state and the domain-randomized model fields are tiles. The linear
algebra follows the kinematic tree's sparsity (tree-sparse LDL^T, sparse
constraint rows).

MuJoCo Euler pipeline with the Newton solver at iterations=1 /
ls_iterations=5. PLANE_HULL, HULL_HULL and HFIELD_HULL contact pairs: every
duck scene. The heightfield's corner heights come from the model's
(nrow, ncol) table by indexed loads (``lane.hf_window_corners``), the JAX
package's "direct" gather; its one-hot matmul gather is a TPU device for a
machine without vector gathers and is not ported.

On a CUDA device every one of its thousands of elementwise operations is a
separate kernel launch; it runs there only as the reference the fused
kernel is compared with.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from duckbench.ref.ops import lane as ln
from duckbench.ref.ops.types import JointType, Model, PairType, SensorType

# Model fields that domain randomization batches per env
# (envs/randomize.py); when present in `dr`, these are tiles.
DR_FIELDS = (
    "geom_friction",
    "body_ipos",
    "dof_frictionloss",
    "dof_armature",
    "body_mass",
    "qpos0",
    "actuator_gainprm",
    "actuator_biasprm",
)

_MINVAL = 1e-10
_TINY = 1e-12
_BIG = 1e10


class _Const:
    """Trace-time numpy view of every model field (python float access)."""

    _FIELDS = (
        "body_pos", "body_quat", "body_ipos", "body_iquat", "body_mass",
        "body_inertia", "body_invweight0", "jnt_pos", "jnt_axis",
        "jnt_range", "jnt_solref", "jnt_solimp", "jnt_margin",
        "dof_armature", "dof_damping", "dof_frictionloss",
        "dof_invweight0", "dof_solref", "dof_solimp", "geom_pos",
        "geom_quat", "geom_friction", "geom_solref", "geom_solimp",
        "site_pos", "site_quat", "actuator_gainprm", "actuator_biasprm",
        "actuator_ctrlrange", "actuator_forcerange", "actuator_gear",
        "qpos0", "hull_vert", "hull_face_n", "hull_face_d", "hfield_data",
        "hfield_size",
    )

    def __init__(self, m: Model):
        self.m = m
        for name in self._FIELDS:
            v = getattr(m, name)
            setattr(self, name, None if v is None else _np64(v))
        self.gravity = _np64(m.opt.gravity)


def _np64(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


def _dr_get(dr: Optional[Dict], const: _Const, field: str, *idx):
    """Model scalar: DR tile if the field is randomized, else python float."""
    if dr is not None and field in dr:
        v = dr[field]
        for i in idx:
            v = v[i]
        return v
    v = getattr(const, field)
    for i in idx:
        v = v[i]
    return float(v)


def _ancestors(dof_parentid, i):
    out = []
    j = i
    while j >= 0:
        out.append(j)
        j = int(dof_parentid[j])
    return sorted(out)


def _tree_pattern(m: Model):
    """Lower-triangle (i, j) pairs (j ancestor-or-self of i) of the dof tree."""
    pat = []
    for i in range(m.nv):
        for j in _ancestors(m.dof_parentid, i):
            pat.append((i, j))
    return pat


def _ldl_pattern(nv: int, pattern):
    """Symbolic LDL^T fill-in over an arbitrary symmetric pattern."""
    have = {(i, j) for (i, j) in pattern}
    for i in range(nv):
        have.add((i, i))
    # standard symbolic elimination: processing column j, any two nonzero
    # rows i1 < i2 below the diagonal create fill at (i2, i1)
    for j in range(nv):
        rows = sorted(i for (i, jj) in list(have) if jj == j and i > j)
        for a in range(len(rows)):
            for b in range(a):
                have.add((rows[a], rows[b]))
    return have


class LDLTree:
    """Sparse LDL^T with a static sparsity pattern (built at trace time)."""

    def __init__(self, nv: int, pattern):
        self.nv = nv
        self.pat = _ldl_pattern(nv, pattern)
        # column lists: for each j, rows i > j with (i, j) in pattern
        self.cols = {j: sorted(i for (i, jj) in self.pat if jj == j and i > j)
                     for j in range(nv)}
        # row lists: for each i, cols j < i
        self.rows = {i: sorted(j for (ii, j) in self.pat if ii == i and j < i)
                     for i in range(nv)}

    def factor(self, M: Dict):
        """M: dict {(i,j): tile, i>=j} covering self.pat. Returns (L, dinv)."""
        L: Dict = {}
        d = [None] * self.nv
        dinv = [None] * self.nv
        for j in range(self.nv):
            s = M[(j, j)]
            for k in self.rows[j]:
                s = s - L[(j, k)] * L[(j, k)] * d[k]
            d[j] = s
            dinv[j] = 1.0 / s
            rj = set(self.rows[j])
            for i in self.cols[j]:
                t = M.get((i, j), 0.0)
                for k in self.rows[i]:
                    if k in rj:
                        t = t - L[(i, k)] * L[(j, k)] * d[k]
                L[(i, j)] = t * dinv[j]
        return L, dinv

    def solve(self, L, dinv, b: List):
        """Solve L D L^T x = b (b: list of nv tiles)."""
        z = list(b)
        for i in range(self.nv):
            for k in self.rows[i]:
                z[i] = z[i] - L[(i, k)] * z[k]
        for i in range(self.nv):
            z[i] = z[i] * dinv[i]
        for i in range(self.nv - 1, -1, -1):
            for k in self.rows[i]:
                z[k] = z[k] - L[(i, k)] * z[i]
        return z


# ---------------------------------------------------------------------------
# impedance (constraint.kbi) on tiles with constant solref/solimp
# ---------------------------------------------------------------------------


def _kbi_const(solref, solimp):
    """Constant part of kbi: returns (k, b, dmin, dmax, width, mid, power)."""
    timeconst, dampratio = float(solref[0]), float(solref[1])
    dmin, dmax, width, mid, power = (float(x) for x in solimp)
    dmin = min(max(dmin, _MINVAL), 0.9999)
    dmax = min(max(dmax, _MINVAL), 0.9999)
    k = 1.0 / max(dmax * dmax * timeconst * timeconst * dampratio * dampratio, _MINVAL)
    b = 2.0 / max(dmax * timeconst, _MINVAL)
    if timeconst <= 0:
        k = -timeconst / (dmax * dmax)
    if dampratio <= 0:
        b = -dampratio / dmax
    return k, b, dmin, dmax, max(width, _MINVAL), mid, max(power, 1.0)


def _impedance(pos, dmin, dmax, width, mid, power):
    """Position-dependent impedance on a tile `pos`."""
    x = ln.div(torch.abs(pos), width)
    if power == 2.0:
        y_low = x * x * (mid ** (1.0 - power))
        xm = 1.0 - x
        y_high = 1.0 - xm * xm * ((1.0 - mid) ** (1.0 - power))
    elif power == 1.0:
        y_low = x
        y_high = x
    else:
        y_low = (x ** power) * (mid ** (1.0 - power))
        y_high = 1.0 - ((1.0 - x) ** power) * ((1.0 - mid) ** (1.0 - power))
    y = torch.where(x < mid, y_low, y_high)
    imp = dmin + y * (dmax - dmin)
    imp = torch.where(x >= 1.0, dmax, imp)
    return torch.clamp(imp, dmin, dmax)


# ---------------------------------------------------------------------------
# the lane program
# ---------------------------------------------------------------------------


class LanePhysics:
    """Build-once object holding the static structure; `substep` is traced."""

    def __init__(self, m: Model):
        self.m = m
        self.c = _Const(m)
        self.tree_pat = _tree_pattern(m)
        # constraint-row supports (built in _efc_meta)
        self._efc_meta()
        pat = set(self.tree_pat)
        for row in self.con_rows_support:
            for a in range(len(row)):
                for b in range(a + 1):
                    i, j = max(row[a], row[b]), min(row[a], row[b])
                    pat.add((i, j))
        self.ldl = LDLTree(m.nv, self.tree_pat)
        self.ldl_h = LDLTree(m.nv, sorted(pat))
        self._hf_tables = {}  # device -> the heightfield table there

    # -- static structure for constraint rows --------------------------------
    def _efc_meta(self):
        m = self.m
        self.fri_dofs = [i for i in range(m.nv) if bool(m.dof_hasfrictionloss[i])]
        self.lim_jnts = [j for j in range(m.njnt) if bool(m.jnt_limited[j])]
        # per contact-pair: dofs that influence the two bodies
        self.pair_dofs = []
        self.con_rows_support = []
        for p in range(m.npair):
            g1, g2 = int(m.pair_geom1[p]), int(m.pair_geom2[p])
            b1, b2 = int(m.geom_bodyid[g1]), int(m.geom_bodyid[g2])
            dofs = sorted(set(self._body_dofs(b1)) | set(self._body_dofs(b2)))
            self.pair_dofs.append(dofs)
            self.con_rows_support.append(dofs)

    def _body_dofs(self, body):
        m = self.m
        out = []
        b = body
        while b > 0:
            adr, num = int(m.body_dofadr[b]), int(m.body_dofnum[b])
            out.extend(range(adr, adr + num))
            b = int(m.body_parentid[b])
        return out

    # ------------------------------------------------------------------
    # forward kinematics -> (xpos, xquat, xanchor, xaxis) lists of lanes
    # ------------------------------------------------------------------
    def kinematics(self, qpos, dr):
        m, c = self.m, self.c
        zero = qpos[0] * 0.0
        one = zero + 1.0
        xpos = [[zero, zero, zero]]
        xquat = [[one, zero, zero, zero]]
        xanchor = [None] * m.njnt
        xaxis = [None] * m.njnt
        for b in range(1, m.nbody):
            p = int(m.body_parentid[b])
            bp = [float(v) for v in c.body_pos[b]]
            bq = [float(v) for v in c.body_quat[b]]
            pos = ln.v3_add(xpos[p], ln.q_rot(xquat[p], bp))
            quat = ln.q_mul(xquat[p], bq)
            jadr, jnum = int(m.body_jntadr[b]), int(m.body_jntnum[b])
            for j in range(jadr, jadr + jnum):
                jtype = int(m.jnt_type[j])
                qadr = int(m.jnt_qposadr[j])
                if jtype == JointType.FREE:
                    pos = [qpos[qadr], qpos[qadr + 1], qpos[qadr + 2]]
                    quat = ln.q_normalize(
                        [qpos[qadr + 3], qpos[qadr + 4], qpos[qadr + 5], qpos[qadr + 6]]
                    )
                    xanchor[j] = pos
                    ax = [float(v) for v in c.jnt_axis[j]]
                    xaxis[j] = ln.q_rot(quat, ax)
                elif jtype == JointType.HINGE:
                    q0 = _dr_get(dr, c, "qpos0", qadr)
                    angle = qpos[qadr] - q0
                    jp = [float(v) for v in c.jnt_pos[j]]
                    ax = [float(v) for v in c.jnt_axis[j]]
                    anchor = ln.v3_add(pos, ln.q_rot(quat, jp))
                    qloc = ln.axis_angle_q(ax, angle)
                    quat = ln.q_normalize(ln.q_mul(quat, qloc))
                    pos = ln.v3_sub(anchor, ln.q_rot(quat, jp))
                    xanchor[j] = anchor
                    xaxis[j] = ln.q_rot(quat, ax)
                else:
                    raise NotImplementedError(f"joint type {jtype}")
            xpos.append(pos)
            xquat.append(quat)
        return xpos, xquat, xanchor, xaxis

    # ------------------------------------------------------------------
    def com_pos(self, xpos, xquat, xanchor, xaxis, dr):
        m, c = self.m, self.c
        xipos = []
        cinert = [None] * m.nbody
        for b in range(m.nbody):
            if dr is not None and "body_ipos" in dr:
                ip = dr["body_ipos"][b]
            else:
                ip = [float(v) for v in c.body_ipos[b]]
            xipos.append(ln.v3_add(xpos[b], ln.q_rot(xquat[b], ip)) if b else xpos[b])

        # subtree com bottom-up (mass may be DR tiles)
        def mass(b):
            return _dr_get(dr, c, "body_mass", b)

        seg = [ln.v3_scale(xipos[b], mass(b)) for b in range(m.nbody)]
        segm = [mass(b) for b in range(m.nbody)]
        for b in range(m.nbody - 1, 0, -1):
            p = int(m.body_parentid[b])
            seg[p] = ln.v3_add(seg[p], seg[b])
            segm[p] = segm[p] + segm[b]
        subtree_com = []
        for b in range(m.nbody):
            denom = segm[b]
            if isinstance(denom, float):
                inv = 1.0 / max(denom, 1e-12)
            else:
                inv = 1.0 / ln.maximum(denom, 1e-12)
            subtree_com.append(ln.v3_scale(seg[b], inv))

        root_com = [subtree_com[int(m.body_rootid[b])] for b in range(m.nbody)]

        for b in range(m.nbody):
            ximat = ln.q_to_mat(ln.q_mul(xquat[b], [float(v) for v in c.body_iquat[b]]))
            I_world = ln.rotate_inertia([float(v) for v in c.body_inertia[b]], ximat)
            off = ln.v3_sub(xipos[b], root_com[b])
            cinert[b] = ln.spatial_inertia_sym(mass(b), I_world, off)

        # cdof
        cdof = [None] * m.nv
        xmat = [ln.q_to_mat(q) for q in xquat]
        for j in range(m.njnt):
            jtype = int(m.jnt_type[j])
            vadr = int(m.jnt_dofadr[j])
            b = int(m.jnt_bodyid[j])
            if jtype == JointType.FREE:
                zero = xpos[b][0] * 0.0
                for i in range(3):
                    e = [0.0, 0.0, 0.0]
                    e[i] = 1.0
                    cdof[vadr + i] = [zero, zero, zero,
                                      zero + e[0], zero + e[1], zero + e[2]]
                anc_off = ln.v3_sub(xanchor[j], root_com[b])
                neg = ln.v3_scale(anc_off, -1.0)
                for i in range(3):
                    axis = ln.m3_col(xmat[b], i)
                    cdof[vadr + 3 + i] = axis + ln.v3_cross(axis, neg)
            else:
                axis = xaxis[j]
                anc_off = ln.v3_sub(xanchor[j], root_com[b])
                neg = ln.v3_scale(anc_off, -1.0)
                cdof[vadr] = axis + ln.v3_cross(axis, neg)
        return subtree_com, xipos, cinert, cdof

    # ------------------------------------------------------------------
    def crb(self, cinert, cdof, dr):
        m = self.m
        crb_inert = list(cinert)
        for b in range(m.nbody - 1, 0, -1):
            p = int(m.body_parentid[b])
            if p > 0:
                crb_inert[p] = ln.sym6_add(crb_inert[p], crb_inert[b])
        F = [ln.sym6_vec(crb_inert[int(m.dof_bodyid[i])], cdof[i]) for i in range(m.nv)]
        M = {}
        for (i, j) in self.tree_pat:
            M[(i, j)] = ln.v6_dot(F[i], cdof[j])
        for i in range(m.nv):
            M[(i, i)] = M[(i, i)] + _dr_get(dr, self.c, "dof_armature", i)
        return M

    # ------------------------------------------------------------------
    def com_vel(self, cdof, qvel):
        m = self.m
        zero6 = [qvel[0] * 0.0] * 6
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
                    for i in range(vadr, vadr + 3):
                        cdofdot[i] = zero6
                        v = ln.v6_add(v, ln.v6_scale(cdof[i], qvel[i]))
                    v_pre = v
                    for i in range(vadr + 3, vadr + 6):
                        cdofdot[i] = ln.motion_cross(v_pre, cdof[i])
                        v = ln.v6_add(v, ln.v6_scale(cdof[i], qvel[i]))
                else:
                    i = vadr
                    cdofdot[i] = ln.motion_cross(v, cdof[i])
                    v = ln.v6_add(v, ln.v6_scale(cdof[i], qvel[i]))
            cvel.append(v)
        return cvel, cdofdot

    # ------------------------------------------------------------------
    def rne(self, cinert, cdof, cdofdot, cvel, qvel):
        m, c = self.m, self.c
        zero = qvel[0] * 0.0
        g = c.gravity
        cacc0 = [zero, zero, zero, zero - g[0], zero - g[1], zero - g[2]]
        cacc = [cacc0]
        cfrc = [[zero] * 6]
        for b in range(1, m.nbody):
            p = int(m.body_parentid[b])
            a = cacc[p]
            dofadr, dofnum = int(m.body_dofadr[b]), int(m.body_dofnum[b])
            for i in range(dofadr, dofadr + dofnum):
                a = ln.v6_add(a, ln.v6_scale(cdofdot[i], qvel[i]))
            cacc.append(a)
            Iv = ln.sym6_vec(cinert[b], cvel[b])
            f = ln.v6_add(ln.sym6_vec(cinert[b], a), ln.force_cross(cvel[b], Iv))
            cfrc.append(f)
        for b in range(m.nbody - 1, 0, -1):
            p = int(m.body_parentid[b])
            if p > 0:
                cfrc[p] = ln.v6_add(cfrc[p], cfrc[b])
        return [ln.v6_dot(cdof[i], cfrc[int(m.dof_bodyid[i])]) for i in range(m.nv)]

    # ------------------------------------------------------------------
    def actuation(self, qpos, qvel, ctrl, dr):
        m, c = self.m, self.c
        force_out = []
        qfrc = [qvel[0] * 0.0 for _ in range(m.nv)]
        for u in range(m.nu):
            j = int(m.actuator_trnid[u])
            qadr = int(m.jnt_qposadr[j])
            vadr = int(m.jnt_dofadr[j])
            lo, hi = float(c.actuator_ctrlrange[u, 0]), float(c.actuator_ctrlrange[u, 1])
            gear = float(c.actuator_gear[u])
            ctrl_c = torch.clamp(ctrl[u], lo, hi)
            length = qpos[qadr] * gear
            velocity = qvel[vadr] * gear
            gain0 = _dr_get(dr, c, "actuator_gainprm", u, 0)
            bias0 = float(c.actuator_biasprm[u, 0])
            bias1 = _dr_get(dr, c, "actuator_biasprm", u, 1)
            bias2 = float(c.actuator_biasprm[u, 2])
            force = gain0 * ctrl_c + bias0 + bias1 * length + bias2 * velocity
            flo = float(c.actuator_forcerange[u, 0])
            fhi = float(c.actuator_forcerange[u, 1])
            force = torch.clamp(force, flo, fhi)
            force_out.append(force)
            qfrc[vadr] = qfrc[vadr] + force * gear
        return force_out, qfrc

    # ------------------------------------------------------------------
    # collision: static pair list -> per-candidate dist/pos + frame
    # ------------------------------------------------------------------
    def _static_body_pose(self, body):
        """Constant world pose of a body with no joints on its ancestor path."""
        m, c = self.m, self.c
        chain = []
        b = body
        while b != 0:
            if int(m.body_jntnum[b]) != 0:
                raise NotImplementedError("plane on a movable body")
            chain.append(b)
            b = int(m.body_parentid[b])
        pos = np.zeros(3)
        quat = np.array([1.0, 0.0, 0.0, 0.0])
        for b in reversed(chain):
            pos = pos + _np_quat_rot(quat, c.body_pos[b])
            quat = _np_quat_mul(quat, c.body_quat[b])
        return pos, quat

    def _geom_pose(self, g, xpos, xquat):
        c = self.c
        b = int(self.m.geom_bodyid[g])
        gp = [float(v) for v in c.geom_pos[g]]
        gq = [float(v) for v in c.geom_quat[g]]
        pos = ln.v3_add(xpos[b], ln.q_rot(xquat[b], gp))
        quat = ln.q_mul(xquat[b], gq)
        return pos, ln.q_to_mat(quat)

    @staticmethod
    def _running_argmax(scores, payloads):
        """First-max argmax over a static list.

        scores: list of tiles; payloads: list of tuples of tiles carried
        along. Returns (best_idx_tile, best_payload_tuple). Ties keep the
        first occurrence (matches ln.argmax).
        """
        best_s = scores[0]
        zero = scores[0] * 0.0
        best_i = zero
        best_p = list(payloads[0])
        for v in range(1, len(scores)):
            take = scores[v] > best_s
            best_s = torch.where(take, scores[v], best_s)
            best_i = torch.where(take, zero + float(v), best_i)
            best_p = [torch.where(take, payloads[v][k], best_p[k])
                      for k in range(len(best_p))]
        return best_i, best_p

    def _manifold(self, w, support, mask, normal_const):
        """ops/collision._manifold_points + _dedup on lane tiles.

        w: list of V vec3 (world hull vertices); support: list of V tiles
        (penetration depth, > 0 when penetrating); mask: list of V tiles
        (bool); normal_const: python float vec3 (shared contact normal).
        Returns 4 candidates: list of (dist, pos_vec3, valid).
        """
        V = len(w)
        neg = -1e6
        dist_mask = [torch.where(mask[v], 0.0, neg) for v in range(V)]
        payload = [(support[v], w[v][0], w[v][1], w[v][2],
                    torch.where(mask[v], 1.0, 0.0)) for v in range(V)]

        # a: deepest vertex overall (ops/collision._manifold_points: the
        # support vertex always carries contact 0, and doubles as the
        # min-distance query point when separated)
        a_i, a_p = self._running_argmax(support, payload)
        a = [a_p[1], a_p[2], a_p[3]]
        # b: farthest from a
        sc_b = [ln.v3_dot(ln.v3_sub(a, w[v]), ln.v3_sub(a, w[v])) + dist_mask[v]
                for v in range(V)]
        b_i, b_p = self._running_argmax(sc_b, payload)
        b = [b_p[1], b_p[2], b_p[3]]
        # c: max |ap . ab|, ab = n x (a - b)
        ab = ln.v3_cross(normal_const, ln.v3_sub(a, b))
        sc_c = [torch.abs(ln.v3_dot(ln.v3_sub(a, w[v]), ab)) + dist_mask[v]
                for v in range(V)]
        c_i, c_p = self._running_argmax(sc_c, payload)
        cpt = [c_p[1], c_p[2], c_p[3]]
        # d: max |bp.bc| + |ap.ac|
        ac = ln.v3_cross(normal_const, ln.v3_sub(a, cpt))
        bc = ln.v3_cross(normal_const, ln.v3_sub(b, cpt))
        sc_d = [torch.abs(ln.v3_dot(ln.v3_sub(b, w[v]), bc))
                + torch.abs(ln.v3_dot(ln.v3_sub(a, w[v]), ac)) + dist_mask[v]
                for v in range(V)]
        d_i, d_p = self._running_argmax(sc_d, payload)

        idxs = [a_i, b_i, c_i, d_i]
        pays = [a_p, b_p, c_p, d_p]
        out = []
        for k in range(4):
            sup_k = pays[k][0]
            pos_k = [pays[k][1], pays[k][2], pays[k][3]]
            mask_k = pays[k][4] > 0.5
            # dedup: candidate k invalid if an earlier candidate chose the
            # same vertex index
            seen = None
            for j in range(k):
                eq = idxs[k] == idxs[j]
                seen = eq if seen is None else (seen | eq)
            valid = mask_k if seen is None else (~seen & mask_k)
            if k == 0:
                valid = torch.ones_like(valid)  # first candidate always reports dist
            dist = -sup_k
            # pos = w - 0.5 * dist * n
            pos = [pos_k[i] - 0.5 * dist * normal_const[i] for i in range(3)]
            dist = torch.where(valid, dist, _BIG)
            out.append((dist, pos, valid))
        return out

    def collide(self, xpos, xquat):
        """Returns per-pair list of 4 candidates (dist, pos, frame_const).

        HFIELD_HULL pairs read the model's own heightfield table."""
        m, c = self.m, self.c
        contacts = []
        for p in range(m.npair):
            g1, g2 = int(m.pair_geom1[p]), int(m.pair_geom2[p])
            ptype = int(m.pair_type[p])
            if ptype == PairType.PLANE_HULL:
                # plane is on a static body in the duck scenes: constant pose
                bpos, bquat = self._static_body_pose(int(m.geom_bodyid[g1]))
                pp = bpos + _np_quat_rot(bquat, c.geom_pos[g1])
                pq = _np_quat_mul(bquat, c.geom_quat[g1])
                # constant plane frame
                w_, x_, y_, z_ = pq
                Rp = np.array([
                    [1 - 2 * (y_ * y_ + z_ * z_), 2 * (x_ * y_ - w_ * z_), 2 * (x_ * z_ + w_ * y_)],
                    [2 * (x_ * y_ + w_ * z_), 1 - 2 * (x_ * x_ + z_ * z_), 2 * (y_ * z_ - w_ * x_)],
                    [2 * (x_ * z_ - w_ * y_), 2 * (y_ * z_ + w_ * x_), 1 - 2 * (x_ * x_ + y_ * y_)],
                ])
                n = [float(v) for v in Rp[:, 2]]
                hull = int(m.geom_dataid[g2])
                verts = c.hull_vert[hull]
                gpos, gmat = self._geom_pose(g2, xpos, xquat)
                w = [ln.v3_add(gpos, ln.m3_vec(gmat, [float(vv) for vv in verts[v]]))
                     for v in range(verts.shape[0])]
                # support = (plane_pos - w) . n
                ppn = float(np.dot(pp, Rp[:, 2]))
                support = [ppn - ln.v3_dot(w[v], n) for v in range(len(w))]
                # candidate band within 1mm of the deepest vertex (see
                # ops/collision.plane_hull for rationale)
                smax = support[0]
                for s in support[1:]:
                    smax = ln.maximum(smax, s)
                band = ln.maximum(0.0, smax - 1e-3)
                mask = [s > band for s in support]
                cand = self._manifold(w, support, mask, n)
                frame = self._const_frame(n)
                contacts.append((cand, frame, None))
            elif ptype == PairType.HULL_HULL:
                contacts.append(self._hull_hull(p, g1, g2, xpos, xquat))
            elif ptype == PairType.HFIELD_HULL:
                contacts.append(self._hfield_hull(p, g1, g2, xpos, xquat))
            else:
                raise NotImplementedError(f"pair type {ptype} in lane kernel")
        return contacts

    def _hf_table(self, device) -> torch.Tensor:
        """The (nrow, ncol) float32 heightfield table on `device`."""
        key = str(device)
        if key not in self._hf_tables:
            self._hf_tables[key] = torch.as_tensor(
                np.asarray(self.c.hfield_data, np.float32), device=device)
        return self._hf_tables[key]

    def _hf_indices(self, x, y):
        """Local hfield-frame (x, y) -> integer cell indices + fractions."""
        c = self.c
        nrow, ncol = c.hfield_data.shape
        rx = float(c.hfield_size[0])
        ry = float(c.hfield_size[1])
        gx = ln.div(x + rx, 2.0 * rx) * (ncol - 1)
        gy = ln.div(y + ry, 2.0 * ry) * (nrow - 1)
        gx = torch.clamp(gx, 0.0, ncol - 1.001)
        gy = torch.clamp(gy, 0.0, nrow - 1.001)
        ix = torch.floor(gx).to(torch.int32)
        iy = torch.floor(gy).to(torch.int32)
        fx = gx - ix.to(gx.dtype)
        fy = gy - iy.to(gy.dtype)
        return ix, iy, fx, fy

    def _hf_interp(self, fx, fy, corners):
        """Triangulated surface height + local normal from cell corners
        (collision.hfield_height_normal on lane tiles)."""
        c = self.c
        nrow, ncol = c.hfield_data.shape
        rx = float(c.hfield_size[0])
        ry = float(c.hfield_size[1])
        ztop = float(c.hfield_size[2])
        z00, z10, z01, z11 = (z * ztop for z in corners)
        dx = 2.0 * rx / (ncol - 1)
        dy = 2.0 * ry / (nrow - 1)
        lower = fx + fy < 1.0
        z_lo = z00 + fx * (z10 - z00) + fy * (z01 - z00)
        gx_lo = ln.div(z10 - z00, dx)
        gy_lo = ln.div(z01 - z00, dy)
        z_hi = z11 + (1.0 - fx) * (z01 - z11) + (1.0 - fy) * (z10 - z11)
        gx_hi = ln.div(z11 - z01, dx)
        gy_hi = ln.div(z11 - z10, dy)
        z = torch.where(lower, z_lo, z_hi)
        gxs = torch.where(lower, gx_lo, gx_hi)
        gys = torch.where(lower, gy_lo, gy_hi)
        nvec = [-gxs, -gys, torch.ones_like(gxs)]
        nrm = torch.sqrt(ln.v3_dot(nvec, nvec))
        nvec = ln.v3_scale(nvec, 1.0 / nrm)
        return z, nvec

    def _hfield_hull(self, p, g1, g2, xpos, xquat):
        """collision.hfield_hull on lane tiles: per-vertex surface test,
        manifold spread along the hfield up axis, frame from the deepest
        vertex's surface normal."""
        m, c = self.m, self.c
        bpos, bquat = self._static_body_pose(int(m.geom_bodyid[g1]))
        hp = bpos + _np_quat_rot(bquat, c.geom_pos[g1])
        hq = _np_quat_mul(bquat, c.geom_quat[g1])
        R = _np_quat_to_mat(hq)  # hfield frame: world <- local

        hull = int(m.geom_dataid[g2])
        verts = c.hull_vert[hull]
        gpos, gmat = self._geom_pose(g2, xpos, xquat)
        V = verts.shape[0]
        w = [ln.v3_add(gpos, ln.m3_vec(gmat, [float(x) for x in verts[v]]))
             for v in range(V)]
        # per-vertex local coords + cell indices; corner heights by indexed
        # loads from the table
        locs, ixs, iys, fxs, fys = [], [], [], [], []
        for v in range(V):
            d = [w[v][i] - float(hp[i]) for i in range(3)]
            # local = R^T d
            loc = [
                sum(float(R[i][j]) * d[i] for i in range(3)) for j in range(3)
            ]
            locs.append(loc)
            ix, iy, fx, fy = self._hf_indices(loc[0], loc[1])
            ixs.append(ix)
            iys.append(iy)
            fxs.append(fx)
            fys.append(fy)
        corners = ln.hf_window_corners(self._hf_table(w[0][0].device), iys, ixs)
        support, n_loc = [], []
        for v in range(V):
            z_surf, nv = self._hf_interp(fxs[v], fys[v], corners[v])
            gap = (locs[v][2] - z_surf) * nv[2]
            support.append(-gap)
            n_loc.append(nv)
        # candidate band within 1mm of the deepest vertex (see plane path)
        smax = support[0]
        for s in support[1:]:
            smax = ln.maximum(smax, s)
        band = ln.maximum(0.0, smax - 1e-3)
        mask = [s > band for s in support]
        up = [float(R[i][2]) for i in range(3)]
        cand, n0_loc = self._manifold_hf(w, support, mask, up, n_loc)
        # world normal of the deepest vertex -> shared contact frame
        n0 = [
            sum(float(R[i][j]) * n0_loc[j] for j in range(3)) for i in range(3)
        ]
        nrm = ln.maximum(torch.sqrt(ln.v3_dot(n0, n0)), 1e-12)
        n0 = ln.v3_scale(n0, 1.0 / nrm)
        # pos = w[idx] - 0.5 * dist * n0 with the per-lane n0
        out = []
        for (dist, pos_k, valid) in cand:
            pos = [pos_k[i] - 0.5 * dist * n0[i] for i in range(3)]
            dist = torch.where(valid, dist, _BIG)
            out.append((dist, pos, valid))
        frame = self._dyn_frame(n0)
        return (out, frame, None)

    def _manifold_hf(self, w, support, mask, up_const, n_loc):
        """_manifold with the spreading axis constant (hfield up) but the
        deepest vertex's LOCAL normal carried through for the frame.

        Returns ([(dist, pos_raw, valid)] x4, n0_local vec3 of candidate a);
        pos_raw is the raw vertex position (caller applies the n0 offset)."""
        V = len(w)
        neg = -1e6
        dist_mask = [torch.where(mask[v], 0.0, neg) for v in range(V)]
        payload = [(support[v], w[v][0], w[v][1], w[v][2],
                    torch.where(mask[v], 1.0, 0.0),
                    n_loc[v][0], n_loc[v][1], n_loc[v][2]) for v in range(V)]
        # a: deepest vertex overall (see _manifold)
        a_i, a_p = self._running_argmax(support, payload)
        a = [a_p[1], a_p[2], a_p[3]]
        n0_loc = [a_p[5], a_p[6], a_p[7]]
        sc_b = [ln.v3_dot(ln.v3_sub(a, w[v]), ln.v3_sub(a, w[v])) + dist_mask[v]
                for v in range(V)]
        b_i, b_p = self._running_argmax(sc_b, payload)
        b = [b_p[1], b_p[2], b_p[3]]
        ab = ln.v3_cross(up_const, ln.v3_sub(a, b))
        sc_c = [torch.abs(ln.v3_dot(ln.v3_sub(a, w[v]), ab)) + dist_mask[v]
                for v in range(V)]
        c_i, c_p = self._running_argmax(sc_c, payload)
        cpt = [c_p[1], c_p[2], c_p[3]]
        ac = ln.v3_cross(up_const, ln.v3_sub(a, cpt))
        bc = ln.v3_cross(up_const, ln.v3_sub(b, cpt))
        sc_d = [torch.abs(ln.v3_dot(ln.v3_sub(b, w[v]), bc))
                + torch.abs(ln.v3_dot(ln.v3_sub(a, w[v]), ac)) + dist_mask[v]
                for v in range(V)]
        d_i, d_p = self._running_argmax(sc_d, payload)
        idxs = [a_i, b_i, c_i, d_i]
        pays = [a_p, b_p, c_p, d_p]
        out = []
        for k in range(4):
            sup_k = pays[k][0]
            pos_k = [pays[k][1], pays[k][2], pays[k][3]]
            mask_k = pays[k][4] > 0.5
            seen = None
            for j in range(k):
                eq = idxs[k] == idxs[j]
                seen = eq if seen is None else (seen | eq)
            valid = mask_k if seen is None else (~seen & mask_k)
            if k == 0:
                valid = torch.ones_like(valid)
            dist = -sup_k
            out.append((dist, pos_k, valid))
        return out, n0_loc

    @staticmethod
    def _const_frame(n):
        """Constant frame rows [n, t1, t2] from a python-float normal."""
        n = np.asarray(n, np.float64)
        ref = np.array([0.0, 1.0, 0.0]) if abs(n[1]) < 0.9 else np.array([0.0, 0.0, 1.0])
        t1 = np.cross(ref, n)
        t1 = t1 / max(np.linalg.norm(t1), 1e-12)
        t2 = np.cross(n, t1)
        return [[float(v) for v in n], [float(v) for v in t1], [float(v) for v in t2]]

    def _hull_hull(self, p, g1, g2, xpos, xquat):
        """Face-normal SAT convex-convex (ops/collision.hull_hull on lanes)."""
        m, c = self.m, self.c
        h1, h2 = int(m.geom_dataid[g1]), int(m.geom_dataid[g2])
        pos1, mat1 = self._geom_pose(g1, xpos, xquat)
        pos2, mat2 = self._geom_pose(g2, xpos, xquat)
        v1 = c.hull_vert[h1]
        v2 = c.hull_vert[h2]
        w1 = [ln.v3_add(pos1, ln.m3_vec(mat1, [float(x) for x in v1[v]]))
              for v in range(v1.shape[0])]
        w2 = [ln.v3_add(pos2, ln.m3_vec(mat2, [float(x) for x in v2[v]]))
              for v in range(v2.shape[0])]
        axes = []
        for fn in c.hull_face_n[h1]:
            axes.append(ln.m3_vec(mat1, [float(x) for x in fn]))
        for fn in c.hull_face_n[h2]:
            axes.append(ln.m3_vec(mat2, [float(x) for x in fn]))
        # depth along each axis; keep the minimizing axis (first-min)
        best = None
        for a in axes:
            p1 = [ln.v3_dot(w, a) for w in w1]
            p2 = [ln.v3_dot(w, a) for w in w2]
            mx1 = p1[0]
            mn1 = p1[0]
            for t in p1[1:]:
                mx1 = ln.maximum(mx1, t)
                mn1 = ln.minimum(mn1, t)
            mx2 = p2[0]
            mn2 = p2[0]
            for t in p2[1:]:
                mx2 = ln.maximum(mx2, t)
                mn2 = ln.minimum(mn2, t)
            depth_f = mx1 - mn2
            depth_b = mx2 - mn1
            depth = ln.minimum(depth_f, depth_b)
            # axis oriented 1 -> 2
            flip = depth_f > depth_b
            ax = [torch.where(flip, -a[i], a[i]) for i in range(3)]
            if best is None:
                best = (depth, ax)
            else:
                take = depth < best[0]
                best = (
                    torch.where(take, depth, best[0]),
                    [torch.where(take, ax[i], best[1][i]) for i in range(3)],
                )
        d, axis = best
        # contact points: hull2 vertices deepest along -axis
        support2 = [-(ln.v3_dot(w, axis)) for w in w2]
        smax = support2[0]
        for t in support2[1:]:
            smax = ln.maximum(smax, t)
        thresh = smax - 1e-4
        mask = [(support2[v] >= thresh) & (d > 0) for v in range(len(w2))]
        # manifold with per-lane axis: reuse _manifold but with a per-lane
        # normal; _manifold only uses the normal via cross/dot, so pass tiles
        cand = self._manifold_dyn(w2, support2, mask, axis, d)
        # frame from the per-lane axis
        frame = self._dyn_frame(axis)
        return (cand, frame, d)

    def _manifold_dyn(self, w, support, mask, normal, depth):
        V = len(w)
        neg = -1e6
        dist_mask = [torch.where(mask[v], 0.0, neg) for v in range(V)]
        payload = [(support[v], w[v][0], w[v][1], w[v][2],
                    torch.where(mask[v], 1.0, 0.0)) for v in range(V)]
        a_i, a_p = self._running_argmax(dist_mask, payload)
        a = [a_p[1], a_p[2], a_p[3]]
        sc_b = [ln.v3_dot(ln.v3_sub(a, w[v]), ln.v3_sub(a, w[v])) + dist_mask[v]
                for v in range(V)]
        b_i, b_p = self._running_argmax(sc_b, payload)
        b = [b_p[1], b_p[2], b_p[3]]
        ab = ln.v3_cross(normal, ln.v3_sub(a, b))
        sc_c = [torch.abs(ln.v3_dot(ln.v3_sub(a, w[v]), ab)) + dist_mask[v]
                for v in range(V)]
        c_i, c_p = self._running_argmax(sc_c, payload)
        cpt = [c_p[1], c_p[2], c_p[3]]
        ac = ln.v3_cross(normal, ln.v3_sub(a, cpt))
        bc = ln.v3_cross(normal, ln.v3_sub(b, cpt))
        sc_d = [torch.abs(ln.v3_dot(ln.v3_sub(b, w[v]), bc))
                + torch.abs(ln.v3_dot(ln.v3_sub(a, w[v]), ac)) + dist_mask[v]
                for v in range(V)]
        d_i, d_p = self._running_argmax(sc_d, payload)
        idxs = [a_i, b_i, c_i, d_i]
        pays = [a_p, b_p, c_p, d_p]
        out = []
        for k in range(4):
            pos_k = [pays[k][1], pays[k][2], pays[k][3]]
            mask_k = pays[k][4] > 0.5
            seen = None
            for j in range(k):
                eq = idxs[k] == idxs[j]
                seen = eq if seen is None else (seen | eq)
            valid = mask_k if seen is None else (~seen & mask_k)
            if k == 0:
                valid = torch.ones_like(valid)
            dist = torch.where(valid & (depth > 0), -depth, _BIG)
            # pos = w2[idx] + 0.5 * d * axis
            pos = [pos_k[i] + 0.5 * depth * normal[i] for i in range(3)]
            out.append((dist, pos, valid))
        return out

    def _dyn_frame(self, n):
        """Per-lane orthonormal frame rows [n, t1, t2] (make_tangents)."""
        refy = torch.abs(n[1]) < 0.9
        ref = [torch.where(refy, 0.0, 0.0),
               torch.where(refy, 1.0, 0.0),
               torch.where(refy, 0.0, 1.0)]
        t1 = ln.v3_cross(ref, n)
        nrm = ln.maximum(torch.sqrt(ln.v3_dot(t1, t1)), 1e-12)
        t1 = ln.v3_scale(t1, 1.0 / nrm)
        t2 = ln.v3_cross(n, t1)
        return [n, t1, t2]

    # ------------------------------------------------------------------
    # constraint rows (constraint.make_efc on lanes)
    # ------------------------------------------------------------------
    def make_efc(self, qvel, qpos, contacts, cdof, subtree_com, dr):
        """Returns a list of row dicts:
        {support: [(dof, coeff)], D, aref, pos, floss, is_fri, is_quad}
        coeff/D/aref/pos/floss are tiles or python floats.
        """
        m, c = self.m, self.c
        rows = []
        # dof friction rows
        for i in self.fri_dofs:
            k, b, dmin, dmax, width, mid, power = _kbi_const(
                c.dof_solref[i], c.dof_solimp[i]
            )
            # pos = 0 -> imp = dmin (x=0 -> y=0 -> imp=dmin)
            imp = dmin
            R = max(_MINVAL, (1.0 - imp) / imp * float(c.dof_invweight0[i]))
            rows.append(dict(
                support=[(i, 1.0)], D=1.0 / R, aref=-b * qvel[i],
                pos=None, floss=_dr_get(dr, c, "dof_frictionloss", i),
                is_fri=True, is_quad=False,
            ))
        # joint limit rows
        for j in self.lim_jnts:
            qadr, dofadr = int(m.jnt_qposadr[j]), int(m.jnt_dofadr[j])
            q = qpos[qadr]
            lo, hi = float(c.jnt_range[j, 0]), float(c.jnt_range[j, 1])
            dist_lo = q - lo
            dist_hi = hi - q
            dist = ln.minimum(dist_lo, dist_hi)
            side = torch.where(dist_lo < dist_hi, 1.0, -1.0)
            pos = dist - float(c.jnt_margin[j])
            k, b, dmin, dmax, width, mid, power = _kbi_const(
                c.jnt_solref[j], c.jnt_solimp[j]
            )
            imp = _impedance(pos, dmin, dmax, width, mid, power)
            R = (1.0 - imp) / imp * float(c.dof_invweight0[dofadr])
            R = ln.maximum(R, _MINVAL)
            rows.append(dict(
                support=[(dofadr, side)], D=1.0 / R,
                aref=-b * (side * qvel[dofadr]) - k * imp * pos,
                pos=pos, floss=0.0, is_fri=False, is_quad=True,
            ))
        # contact rows: 4 candidates x 4 pyramid directions per pair
        for p in range(m.npair):
            g1, g2 = int(m.pair_geom1[p]), int(m.pair_geom2[p])
            b1, b2 = int(m.geom_bodyid[g1]), int(m.geom_bodyid[g2])
            # combine params (geom priority all equal in duck scenes)
            p1, p2 = int(m.geom_priority[g1]), int(m.geom_priority[g2])
            if p1 == p2:
                mu1 = _dr_get(dr, c, "geom_friction", g1, 0)
                mu2 = _dr_get(dr, c, "geom_friction", g2, 0)
                if isinstance(mu1, float) and isinstance(mu2, float):
                    mu = max(mu1, mu2)
                else:
                    mu = ln.maximum(mu1, mu2)
                solref = 0.5 * (c.geom_solref[g1] + c.geom_solref[g2])
                solimp = 0.5 * (c.geom_solimp[g1] + c.geom_solimp[g2])
            else:
                gsrc = g1 if p1 > p2 else g2
                mu = _dr_get(dr, c, "geom_friction", gsrc, 0)
                solref = c.geom_solref[gsrc]
                solimp = c.geom_solimp[gsrc]
            k, b, dmin, dmax, width, mid, power = _kbi_const(solref, solimp)
            invweight = float(c.body_invweight0[b1, 0] + c.body_invweight0[b2, 0])
            diag = (invweight + mu * mu * invweight) * 2.0 * mu * mu / float(
                self.m.opt.impratio
            )
            if isinstance(diag, float):
                diag = max(diag, _MINVAL)
            else:
                diag = ln.maximum(diag, _MINVAL)
            dofs = self.pair_dofs[p]
            dofs1 = set(self._body_dofs(b1))
            dofs2 = set(self._body_dofs(b2))
            cand, frame, _ = contacts[p]
            for (dist, pos_c, valid) in cand:
                pos_neg = ln.minimum(dist, 0.0)
                imp = _impedance(pos_neg, dmin, dmax, width, mid, power)
                R = ln.maximum((1.0 - imp) / imp * diag, _MINVAL)
                D = 1.0 / R
                # djac over supported dofs: d(point vel)/dqvel difference
                jac_rows = {}
                for dof in dofs:
                    cd = cdof[dof]
                    # jacp = cdof[3:] + cross(cdof[:3], point - root_com)
                    contrib = [0.0, 0.0, 0.0]
                    if dof in dofs2:
                        off2 = ln.v3_sub(pos_c, subtree_com[int(m.body_rootid[b2])])
                        jp2 = ln.v3_add(cd[3:], ln.v3_cross(cd[:3], off2))
                        contrib = jp2
                    if dof in dofs1:
                        off1 = ln.v3_sub(pos_c, subtree_com[int(m.body_rootid[b1])])
                        jp1 = ln.v3_add(cd[3:], ln.v3_cross(cd[:3], off1))
                        contrib = ln.v3_sub(contrib, jp1) if dof in dofs2 else [
                            -jp1[0], -jp1[1], -jp1[2]]
                    jac_rows[dof] = contrib
                # frame rows may be constant (plane) or tiles (hull-hull)
                fr_n, fr_t1, fr_t2 = frame[0], frame[1], frame[2]
                Jn = {d: ln.v3_dot(jac_rows[d], fr_n) for d in dofs}
                Jt1 = {d: ln.v3_dot(jac_rows[d], fr_t1) for d in dofs}
                Jt2 = {d: ln.v3_dot(jac_rows[d], fr_t2) for d in dofs}
                for sgn, Jt in ((1.0, Jt1), (-1.0, Jt1), (1.0, Jt2), (-1.0, Jt2)):
                    pass  # expanded below for clarity
                for (Jt, sgn) in ((Jt1, 1.0), (Jt1, -1.0), (Jt2, 1.0), (Jt2, -1.0)):
                    support = [(d, Jn[d] + sgn * mu * Jt[d]) for d in dofs]
                    Jq = None
                    for (d, coeff) in support:
                        t = coeff * qvel[d]
                        Jq = t if Jq is None else Jq + t
                    rows.append(dict(
                        support=support, D=D,
                        aref=-b * Jq - k * imp * pos_neg,
                        pos=dist, floss=0.0, is_fri=False, is_quad=True,
                    ))
        return rows

    # ------------------------------------------------------------------
    # Newton solve (solver.solve on lanes)
    # ------------------------------------------------------------------
    def _mat_vec_tree(self, M, v):
        """Symmetric tree-pattern matvec: out[i] = sum_j M[i,j] v[j]."""
        out = [None] * self.m.nv
        for (i, j) in self.tree_pat:
            t = M[(i, j)] * v[j]
            out[i] = t if out[i] is None else out[i] + t
            if i != j:
                t2 = M[(i, j)] * v[i]
                out[j] = t2 if out[j] is None else out[j] + t2
        return out

    def _jv(self, row, v):
        out = None
        for (d, cf) in row["support"]:
            t = cf * v[d]
            out = t if out is None else out + t
        return out

    def _primal_cost(self, M, qacc_smooth, rows, q):
        """Gauss + constraint cost at q (MuJoCo's warmstart comparison)."""
        nv = self.m.nv
        diff = [q[i] - qacc_smooth[i] for i in range(nv)]
        Md = self._mat_vec_tree(M, diff)
        cost = diff[0] * 0.0
        for i in range(nv):
            cost = cost + 0.5 * diff[i] * Md[i]
        for r in rows:
            x = self._jv(r, q) - r["aref"]
            Dx = r["D"] * x
            if r["is_fri"]:
                inside = torch.abs(Dx) <= r["floss"]
                c = torch.where(
                    inside,
                    0.5 * r["D"] * x * x,
                    r["floss"] * torch.abs(x) - 0.5 * r["floss"] * r["floss"] / r["D"],
                )
            else:
                act = (r["pos"] < 0.0) & (x < 0.0)
                c = torch.where(act, 0.5 * r["D"] * x * x, 0.0)
            cost = cost + c
        return cost

    def solve_constraints(self, M, qacc_smooth, rows, warm=None):
        m = self.m
        nv = m.nv
        zero = qacc_smooth[0] * 0.0
        cold = warm is None
        if cold:
            qacc = list(qacc_smooth)
        else:
            # MuJoCo Newton warmstart: start from whichever of
            # {qacc_warmstart, qacc_smooth} has lower primal cost
            cost_ws = self._primal_cost(M, qacc_smooth, rows, warm)
            cost_sm = self._primal_cost(M, qacc_smooth, rows, qacc_smooth)
            use_ws = cost_ws < cost_sm
            qacc = [
                torch.where(use_ws, warm[i], qacc_smooth[i]) for i in range(nv)
            ]

        jv = self._jv
        Jaref = [jv(r, qacc) - r["aref"] for r in rows]

        for it in range(max(1, m.opt.iterations)):
            # forces + hessian mask
            fs, hmask = [], []
            for r, ja in zip(rows, Jaref):
                Dx = r["D"] * ja
                if r["is_fri"]:
                    f = -torch.clamp(Dx, -r["floss"], r["floss"])
                    inside = torch.abs(Dx) <= r["floss"]
                    fs.append(f)
                    hmask.append(inside)
                else:
                    exists = r["pos"] < 0.0
                    active = exists & (ja < 0.0)
                    fs.append(torch.where(active, -Dx, 0.0))
                    hmask.append(active)
            # grad = M (qacc - qacc_smooth) - J^T f
            if it == 0 and cold:
                Ma_err = [zero] * nv
                grad = [zero] * nv
            else:
                diff = [qacc[i] - qacc_smooth[i] for i in range(nv)]
                Ma_err = self._mat_vec_tree(M, diff)
                grad = list(Ma_err)
            for r, f in zip(rows, fs):
                for (d, cf) in r["support"]:
                    grad[d] = grad[d] - cf * f
            # H = M + J^T diag(D*mask) J  on the (extended) pattern
            H = dict(M)
            for r, hm in zip(rows, hmask):
                w = r["D"] * torch.where(hm, 1.0, 0.0)
                sup = r["support"]
                for a in range(len(sup)):
                    da, ca = sup[a]
                    for bidx in range(a + 1):
                        db, cb = sup[bidx]
                        i, j = (da, db) if da >= db else (db, da)
                        H[(i, j)] = H[(i, j)] + w * ca * cb if (i, j) in H else w * ca * cb
            L, dinv = self.ldl_h.factor(H)
            neg_grad = [-g for g in grad]
            direction = self.ldl_h.solve(L, dinv, neg_grad)

            Jd = [jv(r, direction) for r in rows]
            Md = self._mat_vec_tree(M, direction)
            smooth_b = zero
            for i in range(nv):
                smooth_b = smooth_b + direction[i] * Ma_err[i]
            smooth_a = zero
            for i in range(nv):
                smooth_a = smooth_a + direction[i] * Md[i]

            def dphi(alpha):
                d1 = smooth_b + smooth_a * alpha
                d2 = smooth_a
                for r, ja, jd in zip(rows, Jaref, Jd):
                    x = ja + alpha * jd
                    Dx = r["D"] * x
                    if r["is_fri"]:
                        inside = torch.abs(Dx) <= r["floss"]
                        d1 = d1 + torch.where(
                            inside, Dx * jd, r["floss"] * torch.sign(x) * jd
                        )
                        d2 = d2 + torch.where(inside, r["D"] * jd * jd, 0.0)
                    else:
                        act = (r["pos"] < 0.0) & (x < 0.0)
                        d1 = d1 + torch.where(act, Dx * jd, 0.0)
                        d2 = d2 + torch.where(act, r["D"] * jd * jd, 0.0)
                return d1, d2

            d1_0, d2_0 = dphi(zero)
            descent = d1_0 < 0.0
            hi0 = torch.where(d2_0 > _TINY, -d1_0 / ln.maximum(d2_0, _TINY), 1.0)
            hi0 = ln.maximum(hi0, 1e-8)
            still_neg = None
            count = zero
            for kk in range(8):
                d1_k, _ = dphi(hi0 * float(2.0 ** kk))
                neg = torch.where(d1_k < 0.0, 1.0, 0.0)
                still_neg = neg if still_neg is None else still_neg * neg
                count = count + still_neg
            hi = hi0 * torch.exp2(count)
            lo = zero
            alpha = 0.5 * (lo + hi)
            for _ls in range(max(1, m.opt.ls_iterations)):
                d1_a, d2_a = dphi(alpha)
                lo = torch.where(d1_a < 0.0, alpha, lo)
                hi = torch.where(d1_a >= 0.0, alpha, hi)
                newton = alpha - d1_a / ln.maximum(d2_a, _TINY)
                mid = 0.5 * (lo + hi)
                alpha = torch.where(
                    (newton > lo) & (newton < hi) & (d2_a > _TINY), newton, mid
                )
            alpha = torch.where(descent, alpha, 0.0)
            qacc = [qacc[i] + alpha * direction[i] for i in range(nv)]
            Jaref = [ja + alpha * jd for ja, jd in zip(Jaref, Jd)]

        # final forces -> qfrc_constraint
        qfrc = [zero] * nv
        for r, ja in zip(rows, Jaref):
            Dx = r["D"] * ja
            if r["is_fri"]:
                f = -torch.clamp(Dx, -r["floss"], r["floss"])
            else:
                exists = r["pos"] < 0.0
                f = torch.where(exists & (ja < 0.0), -Dx, 0.0)
            for (d, cf) in r["support"]:
                qfrc[d] = qfrc[d] + cf * f
        return qacc, qfrc

    # ------------------------------------------------------------------
    # sensors (forward.sensors on lanes)
    # ------------------------------------------------------------------
    def site_kin(self, xpos, xquat):
        m, c = self.m, self.c
        spos, smat = [], []
        for s in range(m.nsite):
            b = int(m.site_bodyid[s])
            sp = [float(v) for v in c.site_pos[s]]
            sq = [float(v) for v in c.site_quat[s]]
            spos.append(ln.v3_add(xpos[b], ln.q_rot(xquat[b], sp)))
            smat.append(ln.q_to_mat(ln.q_mul(xquat[b], sq)))
        return spos, smat

    def rne_post_cacc(self, cdof, cdofdot, qvel, qacc):
        m, c = self.m, self.c
        zero = qvel[0] * 0.0
        g = c.gravity
        cacc = [[zero, zero, zero, zero - g[0], zero - g[1], zero - g[2]]]
        for b in range(1, m.nbody):
            p = int(m.body_parentid[b])
            a = cacc[p]
            dofadr, dofnum = int(m.body_dofadr[b]), int(m.body_dofnum[b])
            for i in range(dofadr, dofadr + dofnum):
                a = ln.v6_add(
                    a,
                    ln.v6_add(ln.v6_scale(cdofdot[i], qvel[i]),
                              ln.v6_scale(cdof[i], qacc[i])),
                )
            cacc.append(a)
        return cacc

    def sensors(self, xquat, spos, smat, subtree_com, cvel, cacc):
        m, c = self.m, self.c

        def point_vel(cv, point, origin):
            w = cv[:3]
            v = cv[3:]
            return ln.v3_add(v, ln.v3_cross(w, ln.v3_sub(point, origin)))

        out = []
        for s in range(len(m.sensor_type)):
            stype = int(m.sensor_type[s])
            sid = int(m.sensor_objid[s])
            body = int(m.site_bodyid[sid])
            root = int(m.body_rootid[body])
            origin = subtree_com[root]
            p = spos[sid]
            R = smat[sid]
            w_world = cvel[body][:3]
            if stype == SensorType.GYRO:
                out.extend(ln.m3_t_vec(R, w_world))
            elif stype == SensorType.VELOCIMETER:
                out.extend(ln.m3_t_vec(R, point_vel(cvel[body], p, origin)))
            elif stype == SensorType.ACCELEROMETER:
                a_ang = cacc[body][:3]
                a_lin = ln.v3_add(cacc[body][3:],
                                  ln.v3_cross(a_ang, ln.v3_sub(p, origin)))
                v_p = point_vel(cvel[body], p, origin)
                a_point = ln.v3_add(a_lin, ln.v3_cross(w_world, v_p))
                out.extend(ln.m3_t_vec(R, a_point))
            elif stype == SensorType.FRAMEXAXIS:
                out.extend(ln.m3_col(R, 0))
            elif stype == SensorType.FRAMEZAXIS:
                out.extend(ln.m3_col(R, 2))
            elif stype == SensorType.FRAMELINVEL:
                out.extend(point_vel(cvel[body], p, origin))
            elif stype == SensorType.FRAMEANGVEL:
                out.extend(w_world)
            elif stype == SensorType.FRAMEPOS:
                out.extend(p)
            elif stype == SensorType.FRAMEQUAT:
                sq = [float(v) for v in c.site_quat[sid]]
                out.extend(ln.q_mul(xquat[body], sq))
            else:
                raise NotImplementedError(f"sensor type {stype}")
        return out

    # ------------------------------------------------------------------
    # integration (smooth.integrate on lanes)
    # ------------------------------------------------------------------
    def integrate(self, qpos, qvel_new, dt):
        m = self.m
        out = list(qpos)
        for j in range(m.njnt):
            jtype = int(m.jnt_type[j])
            qadr = int(m.jnt_qposadr[j])
            vadr = int(m.jnt_dofadr[j])
            if jtype == JointType.FREE:
                for i in range(3):
                    out[qadr + i] = qpos[qadr + i] + dt * qvel_new[vadr + i]
                quat = [qpos[qadr + 3], qpos[qadr + 4], qpos[qadr + 5], qpos[qadr + 6]]
                w_local = [qvel_new[vadr + 3], qvel_new[vadr + 4], qvel_new[vadr + 5]]
                qn = ln.q_integrate(quat, w_local, dt)
                for i in range(4):
                    out[qadr + 3 + i] = qn[i]
            else:
                out[qadr] = qpos[qadr] + dt * qvel_new[vadr]
        return out

    # ------------------------------------------------------------------
    # one full substep + n-substep entry
    # ------------------------------------------------------------------
    def substep(self, qpos, qvel, ctrl, dr, want_derived=False, warm=None):
        """One physics substep on lane lists.

        Returns (qpos', qvel', warm', derived): warm' is the Newton solution
        (the next substep's qacc_warmstart, MuJoCo semantics); pass warm=None
        for a cold start (mj_resetData-equivalent).

        derived (when requested): dict with sensordata, actuator_force,
        contact_dist, site_xpos, site_xmat lane lists — everything the envs
        consume from Data (envs/base.py accessors), evaluated pre-integration
        like mj_step.
        """
        m = self.m
        xpos, xquat, xanchor, xaxis = self.kinematics(qpos, dr)
        subtree_com, xipos, cinert, cdof = self.com_pos(xpos, xquat, xanchor, xaxis, dr)
        M = self.crb(cinert, cdof, dr)
        contacts = self.collide(xpos, xquat)
        cvel, cdofdot = self.com_vel(cdof, qvel)
        qfrc_bias = self.rne(cinert, cdof, cdofdot, cvel, qvel)
        actuator_force, qfrc_act = self.actuation(qpos, qvel, ctrl, dr)
        qfrc_smooth = [
            qfrc_act[i] - qfrc_bias[i] - float(self.c.dof_damping[i]) * qvel[i]
            for i in range(m.nv)
        ]
        L, dinv = self.ldl.factor(M)
        qacc_smooth = self.ldl.solve(L, dinv, qfrc_smooth)
        rows = self.make_efc(qvel, qpos, contacts, cdof, subtree_com, dr)
        qacc, qfrc_constraint = self.solve_constraints(
            M, qacc_smooth, rows, warm=warm
        )

        dt = float(m.opt.timestep)
        qvel_new = [qvel[i] + dt * qacc[i] for i in range(m.nv)]
        qpos_new = self.integrate(qpos, qvel_new, dt)

        derived = None
        if want_derived:
            spos, smat = self.site_kin(xpos, xquat)
            cacc = self.rne_post_cacc(cdof, cdofdot, qvel, qacc)
            sdata = self.sensors(xquat, spos, smat, subtree_com, cvel, cacc)
            contact_dist = []
            for (cand, frame, _) in contacts:
                for (dist, pos, valid) in cand:
                    contact_dist.append(dist)
            derived = dict(
                sensordata=sdata,
                actuator_force=actuator_force,
                contact_dist=contact_dist,
                site_xpos=[x for sp in spos for x in sp],
                site_xmat=[x for sm in smat for x in sm],
                qacc=qacc,
                qfrc_constraint=qfrc_constraint,
            )
        return qpos_new, qvel_new, qacc, derived

    def step_n(self, qpos, qvel, ctrl, n_substeps, dr=None, warm=None):
        """n substeps with fixed ctrl; derived from the LAST substep's
        pre-integration state (mjx_env.step semantics, forward.step_n).
        Returns (qpos, qvel, warm, derived)."""
        derived = None
        for k in range(n_substeps):
            qpos, qvel, warm, derived = self.substep(
                qpos, qvel, ctrl, dr, want_derived=(k == n_substeps - 1),
                warm=warm,
            )
        return qpos, qvel, warm, derived


def _np_quat_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ])


def _np_quat_rot(q, v):
    qw = q[0]
    qv = np.asarray(q[1:4])
    uv = np.cross(qv, v)
    return np.asarray(v) + 2.0 * (qw * uv + np.cross(qv, uv))


def _np_quat_to_mat(q):
    w, x, y, z = [float(v) for v in q]
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])

