"""The port against MuJoCo C (mujoco 3.10) on the stand-in duck: the port's
MJCF compiler field by field against `mujoco.MjModel`, and the port's
general pipeline against `mj_forward` in one forward pass from identical
states (deploy/substep_parity.py, the JAX package's harness on the port).

The JAX package's tests/test_substep_parity.py and test_mujoco_parity.py
hold the same quantities on the real duck, whose assets are not in the
repository. Where the stand-in reads differently, its bound is its own and
says why:

- the stand-in's soles are octagonal slabs whose 8 bottom vertices lie in
  one plane. At the settled stance MuJoCo emits 3 contacts per sole, the
  port (as the JAX package) 4 per pair; 2 of MuJoCo's 3 coincide with ours
  and the third is a tied corner we do not pick (nearest of ours 1.4 cm
  away). So "every MuJoCo contact matched" becomes "4 of 6 matched at the
  same point", the tight contact bounds (dist, J, D, aref) hold on the
  contacts matched at the same point, and the post-solve qacc, whose
  active sets never agree with a different manifold, gets 2x the
  stand-in's own K=20 ceiling on the backlash scene (27.4 there; the flat
  scene stays within the real duck's 6.0).
  The JAX package's harness reads the same on the stand-in (flat, K=4:
  con_pos max 0.0141, 5 of 6 matched within 2 cm, con_J max 0.0102).
- The rest holds at the real duck's bounds: smooth dynamics, friction rows,
  normals, the row permutation.

`mujoco` is imported here and in deploy/substep_parity.py only; the card's
machine has none, so these tests run on the CPU."""

import os

import numpy as np
import pytest
import torch

mujoco = pytest.importorskip("mujoco")

from open_duck_playground_tpu_torch.deploy import substep_parity as sp  # noqa: E402
from open_duck_playground_tpu_torch.mjcf import compile_mjcf  # noqa: E402
from open_duck_playground_tpu_torch.ops import forward as fwd  # noqa: E402
from tests.torch_helpers import scene, standin_assets  # noqa: E402

pytest_plugins = ["tests.torch_lock"]  # never beside tests/test_resume.py (see there)

K = 20  # states sampled (the JAX test's K)
SCENES = {"flat": "scene_flat_terrain.xml", "backlash": "scene_flat_terrain_backlash.xml",
          "rough": "scene_rough_terrain_backlash.xml"}
# post-solve qacc ceiling: the real duck's 6.0, and 2x the stand-in's K=20
# reading on the backlash scene (27.4)
QACC_MAX = {"flat": 6.0, "backlash": 55.0}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    with standin_assets(str(tmp_path_factory.mktemp("standin"))) as r:
        yield r


def load_mj(path):
    """MjModel from the scene with its assets passed by name (as
    tests/test_mujoco_parity.py loads the real duck; from_xml_path
    mis-joins the asset dir for a heightfield PNG)."""
    root = os.path.dirname(path)
    assets = {}
    for dirpath, _, files in os.walk(os.path.join(root, "assets")):
        for f in files:
            with open(os.path.join(dirpath, f), "rb") as fh:
                assets[f] = fh.read()
    for f in os.listdir(root):
        if f.endswith(".xml"):
            with open(os.path.join(root, f), "rb") as fh:
                assets[f] = fh.read()
    with open(path) as fh:
        return mujoco.MjModel.from_xml_string(fh.read(), assets)


def _np(x):
    return np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x, np.float64)


def _close(name, ours, theirs, atol=1e-6, rtol=1e-5):
    ours, theirs = _np(ours), _np(theirs)
    assert ours.shape == theirs.shape, (name, ours.shape, theirs.shape)
    if ours.size:
        np.testing.assert_allclose(ours, theirs, atol=atol, rtol=rtol, err_msg=name)


# ---------------------------------------------------------------------------
# the port's compiler against mujoco.MjModel (tests/test_mujoco_parity.py's fields)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=list(SCENES))
def scene_pair(request, root):
    path = scene(root, SCENES[request.param])
    return request.param, compile_mjcf(path, timestep=0.002), load_mj(path)


def test_compiler_sizes(scene_pair):
    _, om, mm = scene_pair
    assert (om.nq, om.nv, om.nu) == (mm.nq, mm.nv, mm.nu)
    assert (om.nbody, om.njnt, om.ngeom, om.nsite) == (mm.nbody, mm.njnt, mm.ngeom, mm.nsite)
    assert om.nsensordata == mm.nsensordata
    assert om.opt.timestep == pytest.approx(mm.opt.timestep)
    assert om.opt.iterations == mm.opt.iterations
    assert om.opt.ls_iterations == mm.opt.ls_iterations
    _close("gravity", om.opt.gravity, mm.opt.gravity)


def test_compiler_joints_and_dofs(scene_pair):
    _, om, mm = scene_pair
    for f in ("jnt_qposadr", "jnt_dofadr", "jnt_type", "jnt_bodyid", "dof_bodyid",
              "dof_parentid"):
        _close(f, getattr(om, f).np, getattr(mm, f))
    for f in ("jnt_range", "jnt_pos", "jnt_axis", "qpos0", "dof_armature", "dof_damping",
              "dof_frictionloss"):
        _close(f, getattr(om, f), getattr(mm, f))


def test_compiler_bodies_and_inertia(scene_pair):
    """The real duck's bounds on every body but a static terrain body (a
    jointless child of the world, not in the dynamics): the stand-in's
    heightfield terrain has a geom-derived mass 2.1% below MuJoCo's
    hfield box-equivalent (the real duck's reads 1.4e-4), so it is held at
    3e-2 (mass, inertia) and the world's subtree mass, which absorbs it,
    with it."""
    _, om, mm = scene_pair
    _close("body_rootid", om.body_rootid.np, mm.body_rootid)
    _close("body_pos", om.body_pos, mm.body_pos)
    _close("body_quat", om.body_quat, mm.body_quat, atol=1e-5)
    _close("body_ipos", om.body_ipos, mm.body_ipos)
    # world body parent: MuJoCo uses 0 (itself), we use -1 (none)
    _close("body_parentid", om.body_parentid.np[1:], mm.body_parentid[1:])
    terrain = [b for b in range(1, om.nbody)
               if int(om.body_rootid[b]) == b and int(om.body_jntnum[b]) == 0]
    rest = [b for b in range(om.nbody) if b not in terrain]
    for idx, rtol in ((rest, 2e-4), (terrain, 3e-2)):
        _close("body_mass", om.body_mass[idx], mm.body_mass[idx], rtol=rtol)
        _close("body_inertia", om.body_inertia[idx], mm.body_inertia[idx], atol=1e-9, rtol=rtol)
    _close("body_subtreemass", om.body_subtreemass[rest[1:]], mm.body_subtreemass[rest[1:]],
           rtol=2e-4)
    _close("body_subtreemass", om.body_subtreemass[[0] + terrain],
           mm.body_subtreemass[[0] + terrain], rtol=3e-2)

    def tensor(q, inertia):
        w, x, y, z = _np(q)
        R = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ])
        return R @ np.diag(_np(inertia)) @ R.T

    # iquat is sign/frame ambiguous for degenerate inertia: compare tensors
    for b in range(om.nbody):
        np.testing.assert_allclose(tensor(om.body_iquat[b], om.body_inertia[b]),
                                   tensor(mm.body_iquat[b], mm.body_inertia[b]), atol=1e-8,
                                   rtol=3e-2 if b in terrain else 2e-4,
                                   err_msg=f"body {b} inertia tensor")


def test_compiler_invweight0(scene_pair):
    """invweight0 drives the constraint impedances."""
    _, om, mm = scene_pair
    _close("body_invweight0", om.body_invweight0, mm.body_invweight0, rtol=2e-3, atol=1e-6)
    _close("dof_invweight0", om.dof_invweight0, mm.dof_invweight0, rtol=2e-3, atol=1e-6)


def test_compiler_actuators(scene_pair):
    _, om, mm = scene_pair
    _close("actuator_trnid", om.actuator_trnid.np, mm.actuator_trnid[:, 0])
    _close("gainprm", om.actuator_gainprm, mm.actuator_gainprm[:, :3])
    _close("biasprm", om.actuator_biasprm, mm.actuator_biasprm[:, :3])
    _close("ctrlrange", om.actuator_ctrlrange, mm.actuator_ctrlrange)
    _close("forcerange", om.actuator_forcerange, mm.actuator_forcerange)


def test_compiler_geoms_sites_keyframe(scene_pair):
    _, om, mm = scene_pair
    for f in ("geom_type", "geom_bodyid", "geom_condim", "geom_contype", "geom_conaffinity",
              "site_bodyid"):
        _close(f, getattr(om, f).np, getattr(mm, f))
    for f in ("geom_friction", "geom_solref", "geom_solimp", "site_pos"):
        _close(f, getattr(om, f), getattr(mm, f))
    kid = mujoco.mj_name2id(mm, mujoco.mjtObj.mjOBJ_KEY, "home")
    kf = om.keyframe("home")
    _close("key qpos", kf.qpos, mm.key_qpos[kid])
    _close("key ctrl", kf.ctrl, mm.key_ctrl[kid])


def test_compiler_mesh_vertices_compose_identically(scene_pair):
    """MuJoCo recenters mesh vertices into the principal frame and moves
    geom_pos/quat to match; the compiler keeps the raw frame. The composed
    body-frame vertex clouds (what collision sees) must agree."""
    _, om, mm = scene_pair

    def to_body(pos, quat, verts):
        w, x, y, z = _np(quat)
        R = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ])
        return _np(verts) @ R.T + _np(pos)

    checked = 0
    for g in range(om.ngeom):
        if int(om.geom_type.np[g]) != 7:  # mjGEOM_MESH
            continue
        if int(om.geom_contype.np[g]) == 0 and int(om.geom_conaffinity.np[g]) == 0:
            continue  # visual-only: no hull built
        hull = int(om.geom_dataid.np[g])
        mid = mm.geom_dataid[g]
        va, vn = mm.mesh_vertadr[mid], mm.mesh_vertnum[mid]
        ours = to_body(om.geom_pos[g], om.geom_quat[g], om.hull_vert[hull][: int(om.hull_nvert[hull])])
        theirs = to_body(mm.geom_pos[g], mm.geom_quat[g], mm.mesh_vert[va:va + vn])
        # the same cloud (as sets; hull order may differ)
        d = np.linalg.norm(ours[:, None] - theirs[None], axis=-1)
        assert d.min(axis=1).max() < 1e-5 and d.min(axis=0).max() < 1e-5, g
        checked += 1
    assert checked == 2  # the two soles


# ---------------------------------------------------------------------------
# one forward pass against mj_forward, active-set matched
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["flat", "backlash"])
def settled(request, root):
    path = scene(root, SCENES[request.param])
    om = compile_mjcf(path, timestep=0.002)
    mm = mujoco.MjModel.from_xml_path(path)
    dd = mujoco.MjData(mm)
    stats = sp.run_mode(om, mm, dd, sp.geom_name_map(om, mm), om.keyframe("home"), "settled", K,
                        np.random.default_rng(0))
    return request.param, stats


def test_smooth_dynamics_tight(settled):
    """Bias/passive/actuation forces agree to float32 round-off (the real
    duck's bounds). Readings (flat / backlash): 2.9e-6 / 2.1e-6; qacc_smooth
    3.8e-5 / 3.9e-5."""
    _, s = settled
    assert max(s["qfrc_smooth"]) < 1e-5
    assert max(s["qacc_smooth"]) < 2e-4


def test_friction_rows_tight(settled):
    """Readings: fri_D 3.4e-7 / 3.0e-7, fri_aref 5.2e-7 / 5.1e-7, fri_J 0."""
    _, s = settled
    assert max(s["fri_D"]) < 1e-6
    assert max(s["fri_aref"]) < 2e-6
    assert max(s["fri_J"]) < 1e-7


def test_contact_geometry_tight(settled):
    """The real duck's bounds, on the contacts matched at the same point
    (con_pos < 5e-7; the stand-in's tied corners, see the module
    docstring): 4 of MuJoCo's 6 per state. Readings (flat / backlash),
    same-point contacts: dist 9.0e-9 / 2.1e-8, J 2.6e-8 / 2.2e-8, aref
    2.5e-5 / 5.8e-5, D 7.8e-6 / 2.1e-5 relative."""
    _, s = settled
    assert min(s["con_normal_dot"]) > 0.9999
    assert max(s["con_row_perm_fail"]) == 0.0
    pos = np.asarray(s["con_pos"])
    # one entry per matched contact in every list (no permutation failed)
    assert len(pos) == len(s["con_J"]) == len(s["con_dist"]) == len(s["con_aref"])
    same = pos < 5e-7
    assert same.sum() >= 4 * K, same.sum()
    assert np.asarray(s["con_dist"])[same].max() < 1e-7
    assert np.asarray(s["con_J"])[same].max() < 5e-7
    assert np.asarray(s["con_aref"])[same].max() < 3e-4
    assert np.asarray(s["con_D"])[same].max() < 1e-4
    assert min(s["con_matched_frac"]) >= 4 / 6


def test_solver_divergence_bounded(settled):
    """Post-solve qacc (see QACC_MAX). Readings (K=20): max 5.4 / 27.4."""
    name, s = settled
    assert np.isfinite(s["qacc_all"]).all()
    assert max(s["qacc_all"]) < QACC_MAX[name]


def test_pieces_match_forward(root):
    """our_forward_pieces stays in lockstep with ops/forward.forward."""
    om = compile_mjcf(scene(root, SCENES["flat"]), timestep=0.002)
    kf = om.keyframe("home")
    rng = np.random.default_rng(1)
    qpos = np.asarray(kf.qpos, np.float64).copy()
    qpos[7:] += rng.uniform(-0.05, 0.05, om.nq - 7)
    qvel = rng.uniform(-0.1, 0.1, om.nv)
    ctrl = np.asarray(kf.ctrl) + rng.uniform(-0.02, 0.02, om.nu)

    pieces = sp.our_forward_pieces(om, qpos, qvel, ctrl)
    row = lambda x: torch.tensor(np.asarray(x, np.float32))[None]  # noqa: E731
    d = fwd.forward(om, fwd.make_data(om, 1).replace(qpos=row(qpos), qvel=row(qvel),
                                                     ctrl=row(ctrl)))
    np.testing.assert_allclose(pieces["qfrc_smooth"], _np(d.qfrc_smooth[0]), atol=1e-6)
    np.testing.assert_allclose(pieces["qacc"], _np(d.qacc[0]), atol=1e-4)
