"""MJCF spec -> Model compiler.

Replaces the MuJoCo compile stage the reference relies on
(`mujoco.MjModel.from_xml_string` + `mjx.put_model`, reference base.py:53-61)
for the MJCF subset of the duck scenes. All derivations happen in float64
numpy and are cast to float32 torch tensors (on the CPU) at the end:

- depth-first body/joint/dof/geom/site tables with addresses
- inertial frames: fullinertia -> principal moments + iquat
- qpos0 (free-joint world reference pose; hinge ref angles)
- actuator gain/bias from <position kp kv>, inheritrange ctrl ranges
- convex hulls (+ face planes) of collision meshes, heightfield raster
- static collision pair list with MuJoCo contype/conaffinity + parent filter
- dof/body invweight0 via f64 CRB at qpos0 (mj_setConst semantics)
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import torch
import numpy as np

from duckbench.ref.mjcf import npdynamics as npd
from duckbench.ref.mjcf.parser import BodySpec, ElemSpec, MjcfSpec, parse_mjcf
from duckbench.ref.mjcf.stl import convex_hull, load_stl
from duckbench.ref.ops.types import (
    GeomType,
    JointType,
    Keyframes,
    Model,
    Names,
    Option,
    PairType,
    SensorType,
)
from duckbench.ref.utils.static import sarr

_DEFAULT_SOLREF = np.array([0.02, 1.0])
_DEFAULT_SOLIMP = np.array([0.9, 0.95, 0.001, 0.5, 2.0])
_DEFAULT_FRICTION = np.array([1.0, 0.005, 0.0001])
_BIG = 1e10

_SENSOR_TYPES = {
    "gyro": (SensorType.GYRO, 3),
    "velocimeter": (SensorType.VELOCIMETER, 3),
    "accelerometer": (SensorType.ACCELEROMETER, 3),
    "framexaxis": (SensorType.FRAMEXAXIS, 3),
    "framezaxis": (SensorType.FRAMEZAXIS, 3),
    "framelinvel": (SensorType.FRAMELINVEL, 3),
    "frameangvel": (SensorType.FRAMEANGVEL, 3),
    "framepos": (SensorType.FRAMEPOS, 3),
    "framequat": (SensorType.FRAMEQUAT, 4),
}

_GEOM_TYPES = {
    "plane": GeomType.PLANE,
    "hfield": GeomType.HFIELD,
    "sphere": GeomType.SPHERE,
    "capsule": GeomType.CAPSULE,
    "box": GeomType.BOX,
    "mesh": GeomType.MESH,
}


def _quat_from_mat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (w, x, y, z)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array(
            [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s]
        )
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(1e-12, 1.0 + R[i, i] - R[j, j] - R[k, k])) * 2
    q = np.zeros(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q / np.linalg.norm(q)


def _principal_inertia(inertial: Optional[ElemSpec], body_pos: np.ndarray):
    """(mass, ipos, iquat, principal moments) from an <inertial> element.

    MuJoCo quirks replicated for field parity with mujoco.MjModel:
    - a body with no <inertial> (and no colliding geoms) gets mass 0 and
      body_ipos equal to its own body_pos (observed in mujoco 3.10 on the
      duck's massless `base` body, open_duck_mini_v2.xml:58);
    - principal moments are sorted in DECREASING order, with iquat rotated
      accordingly (mju_eig3 semantics).
    """
    if inertial is None:
        return 0.0, np.asarray(body_pos, np.float64), np.array([1.0, 0, 0, 0]), np.zeros(3)
    mass = inertial.num("mass", 0.0)
    ipos = inertial.vec("pos", [0, 0, 0])
    iquat = inertial.vec("quat", [1, 0, 0, 0])
    iquat = iquat / np.linalg.norm(iquat)
    if inertial.get("fullinertia") is not None:
        ixx, iyy, izz, ixy, ixz, iyz = inertial.vec("fullinertia", None)
        I = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
        w, V = np.linalg.eigh(I)
        w, V = w[::-1], V[:, ::-1]  # MuJoCo sorts principal moments decreasing
        if np.linalg.det(V) < 0:
            V[:, -1] *= -1
        q_eig = _quat_from_mat(V)
        iquat = npd.quat_mul(iquat, q_eig)
        inertia = np.maximum(w, 0.0)
    elif inertial.get("diaginertia") is not None:
        inertia = inertial.vec("diaginertia", None)
    else:
        inertia = np.zeros(3)
    return mass, ipos, iquat, inertia


class _Tables:
    """Mutable accumulation of all model tables during the body walk."""

    def __init__(self):
        self.body = dict(
            parentid=[], name=[], pos=[], quat=[], ipos=[], iquat=[], mass=[],
            inertia=[], jntadr=[], jntnum=[], dofadr=[], dofnum=[], rootid=[],
            has_inertial=[],
        )
        self.jnt = dict(
            type=[], name=[], qposadr=[], dofadr=[], bodyid=[], pos=[], axis=[],
            range=[], limited=[], solref=[], solimp=[], margin=[], ref=[],
        )
        self.dof = dict(
            bodyid=[], jntid=[], parentid=[], armature=[], damping=[], frictionloss=[],
            solref=[], solimp=[],
        )
        self.geom = dict(
            type=[], name=[], bodyid=[], dataid=[], pos=[], quat=[], size=[],
            friction=[], contype=[], conaffinity=[], condim=[], priority=[],
            solref=[], solimp=[], margin=[], gap=[], mesh=[], hfield=[],
        )
        self.site = dict(name=[], bodyid=[], pos=[], quat=[])
        self.nq = 0
        self.nv = 0


def _walk_body(t: _Tables, spec: BodySpec, parent: int) -> None:
    b = len(t.body["name"])
    t.body["parentid"].append(parent)
    t.body["name"].append(spec.name)
    t.body["pos"].append(spec.pos)
    t.body["quat"].append(spec.quat)
    mass, ipos, iquat, inertia = _principal_inertia(spec.inertial, np.asarray(spec.pos))
    t.body["mass"].append(mass)
    t.body["ipos"].append(ipos)
    t.body["iquat"].append(iquat)
    t.body["inertia"].append(inertia)
    t.body["has_inertial"].append(spec.inertial is not None)
    if parent < 0:  # world
        t.body["rootid"].append(0)
    elif parent == 0:
        t.body["rootid"].append(b)
    else:
        t.body["rootid"].append(t.body["rootid"][parent])

    t.body["jntadr"].append(len(t.jnt["name"]))
    t.body["jntnum"].append(len(spec.joints))
    t.body["dofadr"].append(t.nv)
    ndof_before = t.nv

    # last dof of nearest ancestor with dofs
    anc_last_dof = -1
    p = parent
    while p > 0:
        if t.body["dofnum"][p] > 0:
            anc_last_dof = t.body["dofadr"][p] + t.body["dofnum"][p] - 1
            break
        p = t.body["parentid"][p]

    for j_spec in spec.joints:
        j = len(t.jnt["name"])
        jtype = JointType.FREE if j_spec.get("type") == "free" else JointType.HINGE
        t.jnt["type"].append(int(jtype))
        t.jnt["name"].append(j_spec.get("name", f"joint{j}"))
        t.jnt["qposadr"].append(t.nq)
        t.jnt["dofadr"].append(t.nv)
        t.jnt["bodyid"].append(b)
        t.jnt["pos"].append(j_spec.vec("pos", [0, 0, 0]))
        t.jnt["axis"].append(j_spec.vec("axis", [0, 0, 1]))
        has_range = j_spec.get("range") is not None
        rng = j_spec.vec("range", [0, 0])
        limited_attr = j_spec.get("limited")
        if limited_attr is not None:
            limited = limited_attr in ("true", "1")
        else:  # autolimits (MuJoCo default true)
            limited = has_range
        t.jnt["range"].append(rng)
        t.jnt["limited"].append(limited and jtype == JointType.HINGE)
        t.jnt["solref"].append(j_spec.vec("solreflimit", _DEFAULT_SOLREF))
        t.jnt["solimp"].append(j_spec.vec("solimplimit", _DEFAULT_SOLIMP))
        t.jnt["margin"].append(j_spec.num("margin", 0.0))
        t.jnt["ref"].append(j_spec.num("ref", 0.0))

        ndof = 6 if jtype == JointType.FREE else 1
        nqpos = 7 if jtype == JointType.FREE else 1
        for k in range(ndof):
            t.dof["bodyid"].append(b)
            t.dof["jntid"].append(j)
            prev = t.nv + k - 1
            t.dof["parentid"].append(prev if k > 0 or t.nv > ndof_before else anc_last_dof)
            t.dof["armature"].append(j_spec.num("armature", 0.0))
            t.dof["damping"].append(j_spec.num("damping", 0.0))
            t.dof["frictionloss"].append(j_spec.num("frictionloss", 0.0))
            t.dof["solref"].append(j_spec.vec("solreffriction", _DEFAULT_SOLREF))
            t.dof["solimp"].append(j_spec.vec("solimpfriction", _DEFAULT_SOLIMP))
        t.nv += ndof
        t.nq += nqpos
    t.body["dofnum"].append(t.nv - ndof_before)

    for g_spec in spec.geoms:
        gtype_name = g_spec.get("type", "mesh" if g_spec.get("mesh") else "sphere")
        t.geom["type"].append(int(_GEOM_TYPES[gtype_name]))
        t.geom["name"].append(g_spec.get("name", f"geom{len(t.geom['name'])}"))
        t.geom["bodyid"].append(b)
        t.geom["dataid"].append(-1)  # filled later for hulls / hfields
        t.geom["mesh"].append(g_spec.get("mesh"))
        t.geom["hfield"].append(g_spec.get("hfield"))
        t.geom["pos"].append(g_spec.vec("pos", [0, 0, 0]))
        q = g_spec.vec("quat", [1, 0, 0, 0])
        t.geom["quat"].append(q / np.linalg.norm(q))
        size = g_spec.vec("size", [0, 0, 0])
        size = np.pad(size, (0, 3 - len(size)))[:3]
        t.geom["size"].append(size)
        fr = g_spec.vec("friction", _DEFAULT_FRICTION)
        fr = np.concatenate([fr, _DEFAULT_FRICTION[len(fr):]])[:3]
        t.geom["friction"].append(fr)
        t.geom["contype"].append(int(g_spec.num("contype", 1)))
        t.geom["conaffinity"].append(int(g_spec.num("conaffinity", 1)))
        t.geom["condim"].append(int(g_spec.num("condim", 3)))
        t.geom["priority"].append(int(g_spec.num("priority", 0)))
        t.geom["solref"].append(g_spec.vec("solref", _DEFAULT_SOLREF))
        t.geom["solimp"].append(g_spec.vec("solimp", _DEFAULT_SOLIMP))
        t.geom["margin"].append(g_spec.num("margin", 0.0))
        t.geom["gap"].append(g_spec.num("gap", 0.0))

    for s_spec in spec.sites:
        t.site["name"].append(s_spec.get("name", f"site{len(t.site['name'])}"))
        t.site["bodyid"].append(b)
        t.site["pos"].append(s_spec.vec("pos", [0, 0, 0]))
        q = s_spec.vec("quat", [1, 0, 0, 0])
        t.site["quat"].append(q / np.linalg.norm(q))

    for child in spec.children:
        _walk_body(t, child, b)


def _reference_qpos0(t: _Tables) -> np.ndarray:
    """qpos0: hinges at `ref`; free joints at the XML world pose of the body."""
    nbody = len(t.body["name"])
    xpos = np.zeros((nbody, 3))
    xquat = np.zeros((nbody, 4))
    xquat[0, 0] = 1.0
    for b in range(1, nbody):
        p = t.body["parentid"][b]
        xpos[b] = xpos[p] + npd.quat_rot(xquat[p], t.body["pos"][b])
        xquat[b] = npd.quat_mul(xquat[p], t.body["quat"][b])
    qpos0 = np.zeros(t.nq)
    for j in range(len(t.jnt["name"])):
        qadr = t.jnt["qposadr"][j]
        if t.jnt["type"][j] == int(JointType.FREE):
            b = t.jnt["bodyid"][j]
            qpos0[qadr : qadr + 3] = xpos[b]
            qpos0[qadr + 3 : qadr + 7] = xquat[b]
        else:
            qpos0[qadr] = t.jnt["ref"][j]
    return qpos0


def _collision_pairs(t: _Tables):
    """Static geom pair list with MuJoCo's contype/conaffinity+parent filter."""
    ngeom = len(t.geom["name"])
    nbody = len(t.body["name"])
    # weld id: body with no joints is welded to its parent's weld
    weld = np.zeros(nbody, dtype=int)
    for b in range(1, nbody):
        weld[b] = b if t.body["dofnum"][b] > 0 else weld[t.body["parentid"][b]]
    # note: dofnum counts only own dofs; a body with joints is its own weld root
    for b in range(1, nbody):
        if t.body["jntnum"][b] == 0:
            weld[b] = weld[t.body["parentid"][b]]
        else:
            weld[b] = b

    pairs = []
    for g1 in range(ngeom):
        for g2 in range(g1 + 1, ngeom):
            c1, a1 = t.geom["contype"][g1], t.geom["conaffinity"][g1]
            c2, a2 = t.geom["contype"][g2], t.geom["conaffinity"][g2]
            if not ((c1 & a2) or (c2 & a1)):
                continue
            b1, b2 = t.geom["bodyid"][g1], t.geom["bodyid"][g2]
            w1, w2 = weld[b1], weld[b2]
            if w1 == w2:
                continue
            wp1 = weld[t.body["parentid"][w1]] if w1 > 0 else -1
            wp2 = weld[t.body["parentid"][w2]] if w2 > 0 else -1
            # parent-child filter, except when the parent is the world
            if (wp1 == w2 and w2 != 0) or (wp2 == w1 and w1 != 0):
                continue
            ty1, ty2 = t.geom["type"][g1], t.geom["type"][g2]
            # orient: plane/hfield first
            if ty2 in (int(GeomType.PLANE), int(GeomType.HFIELD)):
                g1_, g2_ = g2, g1
                ty1, ty2 = ty2, ty1
            else:
                g1_, g2_ = g1, g2
            if ty1 == int(GeomType.PLANE) and ty2 == int(GeomType.MESH):
                ptype = PairType.PLANE_HULL
            elif ty1 == int(GeomType.HFIELD) and ty2 == int(GeomType.MESH):
                ptype = PairType.HFIELD_HULL
            elif ty1 == int(GeomType.MESH) and ty2 == int(GeomType.MESH):
                ptype = PairType.HULL_HULL
            else:
                raise NotImplementedError(
                    f"collision pair types ({ty1}, {ty2}) not supported"
                )
            condim = max(t.geom["condim"][g1_], t.geom["condim"][g2_])
            p1, p2 = t.geom["priority"][g1_], t.geom["priority"][g2_]
            if p1 != p2:
                condim = t.geom["condim"][g1_ if p1 > p2 else g2_]
            pairs.append((g1_, g2_, int(ptype), condim))
    return pairs


def _load_hfield(path: str) -> np.ndarray:
    from PIL import Image

    im = Image.open(path).convert("L")
    data = np.asarray(im, dtype=np.float64) / 255.0
    lo, hi = data.min(), data.max()
    if hi > lo:
        data = (data - lo) / (hi - lo)
    # image row 0 is +y in MuJoCo's convention: store row 0 at -y
    return data[::-1].copy()


def compile_mjcf(path: str, timestep: Optional[float] = None) -> Model:
    """Compile an MJCF scene file into a Model of float32 CPU tensors."""
    spec = parse_mjcf(path)
    t = _Tables()
    _walk_body(t, spec.worldbody, -1)

    nbody = len(t.body["name"])
    njnt = len(t.jnt["name"])
    ngeom = len(t.geom["name"])
    nsite = len(t.site["name"])
    nq, nv = t.nq, t.nv

    qpos0 = _reference_qpos0(t)

    # ---- meshes: convex hulls for collision geoms ----
    mesh_files = {m.get("name"): m.get("file") for m in spec.meshes}
    meshdir = os.path.join(spec.base_dir, spec.meshdir)
    hull_map: Dict[str, int] = {}
    hull_verts: List[np.ndarray] = []
    hull_faces: List[np.ndarray] = []
    for g in range(ngeom):
        if t.geom["type"][g] != int(GeomType.MESH):
            continue
        if not (t.geom["contype"][g] or t.geom["conaffinity"][g]):
            continue
        mesh_name = t.geom["mesh"][g]
        if mesh_name not in hull_map:
            verts = load_stl(os.path.join(meshdir, mesh_files[mesh_name]))
            hv = convex_hull(verts)
            hull_map[mesh_name] = len(hull_verts)
            hull_verts.append(hv)
            try:
                from scipy.spatial import ConvexHull

                eq = ConvexHull(verts).equations
            except Exception:
                eq = np.zeros((1, 4))
            hull_faces.append(eq)
        t.geom["dataid"][g] = hull_map[mesh_name]

    nhull = len(hull_verts)
    if nhull:
        max_v = max(len(v) for v in hull_verts)
        max_f = max(len(f) for f in hull_faces)
        hv_arr = np.zeros((nhull, max_v, 3))
        hn_arr = np.zeros((nhull, max_f, 3))
        hd_arr = np.zeros((nhull, max_f))
        hull_nvert = []
        hull_nface = []
        for i, v in enumerate(hull_verts):
            centroid = v.mean(0)
            hv_arr[i] = np.vstack([v, np.tile(centroid, (max_v - len(v), 1))])
            hull_nvert.append(len(v))
            f = hull_faces[i]
            hn_arr[i, : len(f)] = f[:, :3]
            hd_arr[i, : len(f)] = f[:, 3]
            if len(f) < max_f:
                hn_arr[i, len(f):] = f[0, :3]
                hd_arr[i, len(f):] = f[0, 3]
            hull_nface.append(len(f))
    else:
        hv_arr = np.zeros((0, 1, 3))
        hn_arr = np.zeros((0, 1, 3))
        hd_arr = np.zeros((0, 1))
        hull_nvert = []
        hull_nface = []

    # ---- heightfield ----
    hf_data = None
    hf_size = None
    hf_nrow = hf_ncol = 0
    for h_idx, h in enumerate(spec.hfields):
        hf_size = h.vec("size", None)
        hf_data = _load_hfield(os.path.join(spec.base_dir, h.get("file")))
        hf_nrow, hf_ncol = hf_data.shape
        for g in range(ngeom):
            if t.geom["type"][g] == int(GeomType.HFIELD) and t.geom["hfield"][g] == h.get("name"):
                t.geom["dataid"][g] = h_idx

    # ---- geom-derived inertial (MuJoCo computes body mass/inertia from
    # geom volumes when <inertial> is absent; here that only applies to the
    # rough scenes' static terrain body, whose hfield geom MuJoCo treats as
    # a box with half-height (ztop*max(data)+zbase)/2 and density 1000.
    # Verified against mujoco 3.10 body_mass/body_inertia field values.) ----
    if hf_data is not None:
        for b in range(nbody):
            if t.body["has_inertial"][b] or t.body["mass"][b] != 0.0:
                continue
            for g in range(ngeom):
                if t.geom["bodyid"][g] != b:
                    continue
                if t.geom["type"][g] != int(GeomType.HFIELD):
                    continue
                rx, ry = float(hf_size[0]), float(hf_size[1])
                # equivalent box preserving the volume under the surface:
                # half-height (ztop*mean(data) + zbase)/2
                hz = (float(hf_size[2]) * float(hf_data.mean())
                      + float(hf_size[3])) / 2.0
                rho = 1000.0
                mass = rho * 8.0 * rx * ry * hz
                t.body["mass"][b] = mass
                t.body["inertia"][b] = (mass / 3.0) * np.array(
                    [ry * ry + hz * hz, rx * rx + hz * hz, rx * rx + ry * ry])
                t.body["ipos"][b] = np.asarray(
                    t.geom["pos"][g], np.float64).copy()
                t.body["iquat"][b] = np.array([1.0, 0.0, 0.0, 0.0])

    # ---- actuators ----
    nu = len(spec.actuators)
    jnt_name2id = {n: i for i, n in enumerate(t.jnt["name"])}
    act = dict(trnid=[], gainprm=[], biasprm=[], ctrlrange=[], forcerange=[], gear=[], name=[])
    for a in spec.actuators:
        if a.attrs.get("__kind__") != "position":
            raise NotImplementedError("only <position> actuators supported")
        jid = jnt_name2id[a.get("joint")]
        kp = a.num("kp", 1.0)
        kv = a.num("kv", 0.0)
        if a.get("dampratio") is not None and a.get("kv") is None:
            raise NotImplementedError("dampratio without explicit kv unsupported")
        act["trnid"].append(jid)
        act["name"].append(a.get("name", a.get("joint")))
        act["gainprm"].append([kp, 0.0, 0.0])
        act["biasprm"].append([0.0, -kp, -kv])
        act["gear"].append(a.num("gear", 1.0))
        if a.get("inheritrange") is not None and float(a.get("inheritrange")) > 0:
            r = float(a.get("inheritrange"))
            lo, hi = t.jnt["range"][jid]
            c, hw = (lo + hi) / 2, (hi - lo) / 2
            act["ctrlrange"].append([c - r * hw, c + r * hw])
        elif a.get("ctrlrange") is not None:
            act["ctrlrange"].append(list(a.vec("ctrlrange", None)))
        else:
            act["ctrlrange"].append([-_BIG, _BIG])
        if a.get("forcerange") is not None:
            act["forcerange"].append(list(a.vec("forcerange", None)))
        else:
            act["forcerange"].append([-_BIG, _BIG])

    # ---- sensors ----
    site_name2id = {n: i for i, n in enumerate(t.site["name"])}
    sens = dict(type=[], objid=[], adr=[], dim=[], name=[])
    adr = 0
    for s in spec.sensors:
        stype, dim = _SENSOR_TYPES[s.tag]
        objname = s.get("site") or s.get("objname")
        sens["type"].append(int(stype))
        sens["objid"].append(site_name2id[objname])
        sens["adr"].append(adr)
        sens["dim"].append(dim)
        sens["name"].append(s.get("name", s.tag))
        adr += dim
    nsensordata = adr

    # ---- collision pairs ----
    pairs = _collision_pairs(t)
    npair = len(pairs)

    # ---- invweight0 via f64 dynamics at qpos0 ----
    nm = npd.NpModel()
    nm.nbody, nm.njnt, nm.nv, nm.nq = nbody, njnt, nv, nq
    nm.body_parentid = np.asarray(t.body["parentid"])
    nm.body_rootid = np.asarray(t.body["rootid"])
    nm.body_jntadr = np.asarray(t.body["jntadr"])
    nm.body_jntnum = np.asarray(t.body["jntnum"])
    nm.body_dofadr = np.asarray(t.body["dofadr"])
    nm.body_dofnum = np.asarray(t.body["dofnum"])
    nm.body_pos = np.asarray(t.body["pos"])
    nm.body_quat = np.asarray(t.body["quat"])
    nm.body_ipos = np.asarray(t.body["ipos"])
    nm.body_iquat = np.asarray(t.body["iquat"])
    nm.body_mass = np.asarray(t.body["mass"])
    nm.body_inertia = np.asarray(t.body["inertia"])
    nm.jnt_type = np.asarray(t.jnt["type"])
    nm.jnt_qposadr = np.asarray(t.jnt["qposadr"])
    nm.jnt_dofadr = np.asarray(t.jnt["dofadr"])
    nm.jnt_bodyid = np.asarray(t.jnt["bodyid"])
    nm.jnt_pos = np.asarray(t.jnt["pos"])
    nm.jnt_axis = np.asarray([a / np.linalg.norm(a) for a in t.jnt["axis"]]) if njnt else np.zeros((0, 3))
    nm.dof_bodyid = np.asarray(t.dof["bodyid"])
    nm.dof_parentid = np.asarray(t.dof["parentid"])
    nm.dof_armature = np.asarray(t.dof["armature"])
    nm.qpos0 = qpos0
    dof_invweight0, body_invweight0, _M0 = npd.set_const(nm)

    subtreemass = nm.body_mass.copy()
    for b in range(nbody - 1, 0, -1):
        subtreemass[t.body["parentid"][b]] += subtreemass[b]

    # ---- option ----
    opt_timestep = timestep if timestep is not None else float(spec.option.get("timestep", 0.002))
    gravity = np.asarray(
        [float(x) for x in spec.option.get("gravity", "0 0 -9.81").split()]
    )
    opt = Option(
        gravity=torch.as_tensor(gravity, dtype=torch.float32),
        timestep=opt_timestep,
        iterations=int(spec.option.get("iterations", 100)),
        ls_iterations=int(spec.option.get("ls_iterations", 50)),
        impratio=float(spec.option.get("impratio", 1.0)),
    )

    # ---- names / keyframes ----
    names = Names(
        body={n: i for i, n in enumerate(t.body["name"])},
        joint=jnt_name2id,
        geom={n: i for i, n in enumerate(t.geom["name"])},
        site=site_name2id,
        actuator={n: i for i, n in enumerate(act["name"])},
        sensor={n: i for i, n in enumerate(sens["name"])},
    )
    keyframes = {}
    for k in spec.keyframes:
        kq = np.asarray([float(x) for x in k.get("qpos", "").split()])
        kc = np.asarray([float(x) for x in k.get("ctrl", "").split()])
        keyframes[k.get("name", f"key{len(keyframes)}")] = (kq, kc)

    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float64), dtype=torch.float32)  # noqa: E731

    return Model(
        opt=opt,
        nq=nq, nv=nv, nu=nu, nbody=nbody, njnt=njnt, ngeom=ngeom, nsite=nsite,
        nsensordata=nsensordata, npair=npair, ncon=npair * 4,
        body_parentid=sarr(t.body["parentid"], np.int32),
        body_rootid=sarr(t.body["rootid"], np.int32),
        body_jntadr=sarr(t.body["jntadr"], np.int32),
        body_jntnum=sarr(t.body["jntnum"], np.int32),
        body_dofadr=sarr(t.body["dofadr"], np.int32),
        body_dofnum=sarr(t.body["dofnum"], np.int32),
        body_pos=f32(t.body["pos"]),
        body_quat=f32(t.body["quat"]),
        body_ipos=f32(t.body["ipos"]),
        body_iquat=f32(t.body["iquat"]),
        body_mass=f32(t.body["mass"]),
        body_inertia=f32(t.body["inertia"]),
        body_invweight0=f32(body_invweight0),
        body_subtreemass=f32(subtreemass),
        jnt_type=sarr(t.jnt["type"], np.int32),
        jnt_qposadr=sarr(t.jnt["qposadr"], np.int32),
        jnt_dofadr=sarr(t.jnt["dofadr"], np.int32),
        jnt_bodyid=sarr(t.jnt["bodyid"], np.int32),
        jnt_limited=sarr(t.jnt["limited"], bool),
        jnt_pos=f32(t.jnt["pos"]) if njnt else f32(np.zeros((0, 3))),
        jnt_axis=f32(nm.jnt_axis),
        jnt_range=f32(t.jnt["range"]) if njnt else f32(np.zeros((0, 2))),
        jnt_solref=f32(t.jnt["solref"]) if njnt else f32(np.zeros((0, 2))),
        jnt_solimp=f32(t.jnt["solimp"]) if njnt else f32(np.zeros((0, 5))),
        jnt_margin=f32(t.jnt["margin"]) if njnt else f32(np.zeros(0)),
        dof_bodyid=sarr(t.dof["bodyid"], np.int32),
        dof_jntid=sarr(t.dof["jntid"], np.int32),
        dof_parentid=sarr(t.dof["parentid"], np.int32),
        dof_hasfrictionloss=sarr(np.asarray(t.dof["frictionloss"]) > 0, bool),
        dof_armature=f32(t.dof["armature"]),
        dof_damping=f32(t.dof["damping"]),
        dof_frictionloss=f32(t.dof["frictionloss"]),
        dof_invweight0=f32(dof_invweight0),
        dof_solref=f32(t.dof["solref"]),
        dof_solimp=f32(t.dof["solimp"]),
        geom_type=sarr(t.geom["type"], np.int32),
        geom_bodyid=sarr(t.geom["bodyid"], np.int32),
        geom_dataid=sarr(t.geom["dataid"], np.int32),
        geom_contype=sarr(t.geom["contype"], np.int32),
        geom_conaffinity=sarr(t.geom["conaffinity"], np.int32),
        geom_condim=sarr(t.geom["condim"], np.int32),
        geom_priority=sarr(t.geom["priority"], np.int32),
        geom_pos=f32(t.geom["pos"]) if ngeom else f32(np.zeros((0, 3))),
        geom_quat=f32(t.geom["quat"]) if ngeom else f32(np.zeros((0, 4))),
        geom_size=f32(t.geom["size"]) if ngeom else f32(np.zeros((0, 3))),
        geom_friction=f32(t.geom["friction"]) if ngeom else f32(np.zeros((0, 3))),
        geom_solref=f32(t.geom["solref"]) if ngeom else f32(np.zeros((0, 2))),
        geom_solimp=f32(t.geom["solimp"]) if ngeom else f32(np.zeros((0, 5))),
        geom_margin=f32(t.geom["margin"]) if ngeom else f32(np.zeros(0)),
        geom_gap=f32(t.geom["gap"]) if ngeom else f32(np.zeros(0)),
        site_bodyid=sarr(t.site["bodyid"], np.int32),
        site_pos=f32(t.site["pos"]) if nsite else f32(np.zeros((0, 3))),
        site_quat=f32(t.site["quat"]) if nsite else f32(np.zeros((0, 4))),
        hull_vert=f32(hv_arr),
        hull_nvert=sarr(hull_nvert, np.int32),
        hull_face_n=f32(hn_arr),
        hull_face_d=f32(hd_arr),
        hull_nface=sarr(hull_nface, np.int32),
        hfield_data=f32(hf_data) if hf_data is not None else None,
        hfield_size=f32(hf_size) if hf_size is not None else None,
        hfield_nrow=hf_nrow,
        hfield_ncol=hf_ncol,
        actuator_trnid=sarr(act["trnid"], np.int32),
        actuator_gainprm=f32(act["gainprm"]) if nu else f32(np.zeros((0, 3))),
        actuator_biasprm=f32(act["biasprm"]) if nu else f32(np.zeros((0, 3))),
        actuator_ctrlrange=f32(act["ctrlrange"]) if nu else f32(np.zeros((0, 2))),
        actuator_forcerange=f32(act["forcerange"]) if nu else f32(np.zeros((0, 2))),
        actuator_gear=f32(act["gear"]) if nu else f32(np.zeros(0)),
        sensor_type=sarr(sens["type"], np.int32),
        sensor_objid=sarr(sens["objid"], np.int32),
        sensor_adr=sarr(sens["adr"], np.int32),
        sensor_dim=sarr(sens["dim"], np.int32),
        pair_geom1=sarr([p[0] for p in pairs], np.int32),
        pair_geom2=sarr([p[1] for p in pairs], np.int32),
        pair_type=sarr([p[2] for p in pairs], np.int32),
        pair_condim=sarr([p[3] for p in pairs], np.int32),
        qpos0=f32(qpos0),
        names=names,
        keyframes=Keyframes(keyframes),
    )
