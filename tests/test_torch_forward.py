"""The port's general physics pipeline (open_duck_playground_tpu_torch/ops:
math3d, linalg, smooth, collision, constraint, solver, forward) against the
JAX package's, on the stand-in duck's flat, backlash and rough scenes.

Both packages compute on the same model (carried across with interop) and
the same numpy inputs (seeded). The JAX side runs its stage functions under
`jax.vmap` without `jit` (eager dispatch; jitting its duck pipeline costs
about a minute per scene on the CPU), and jits once per module only where
many substeps are needed (the settled 10-substep comparison).

- math3d: each function at 1e-6.
- stages, each on the JAX stage's own inputs carried across (so a stage is
  held alone), on random states (tests/torch_helpers.random_states; DR on
  for the flat and rough scenes, shared fields on the backlash one). The
  bounds start from tests/test_lane.py's; the readings on this draw are in
  each test's docstring.
- full substeps: one substep from random states, and step_n(..., 10) from
  settled states, against JAX's fwd.step / fwd.step_n; the iterations=1
  Newton step is discontinuous where a friction row sits at its Huber
  breakpoint or a contact at activation, so the solve's outputs are held by
  quantiles (test_lane's), the kinematic outputs tightly.
- toy models: tests/test_physics.py's analytic oracles on the port's
  pipeline, on the same MJCF strings.
- the twin (ops/lane_physics.py, the kernel's plain version) against the
  pipeline, as test_lane.py holds the JAX lane program against the JAX
  pipeline.
- the slice: Joystick("flat_terrain", physics="pipeline", device="cpu") at
  4 DR envs, one control step against the JAX Joystick on its CPU default
  (its pipeline), from JAX's reset state carried across: TrainEnv.step,
  and the body a CUDA graph of the step records (wrapper.step_into over
  buffers)."""

import fcntl
import functools
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_duck_playground_tpu.envs import randomize as jax_randomize
from open_duck_playground_tpu.mjcf import compile_mjcf as jax_compile
from open_duck_playground_tpu.ops import constraint as jcon
from open_duck_playground_tpu.ops import forward as jfwd
from open_duck_playground_tpu.ops import linalg as jlinalg
from open_duck_playground_tpu.ops import math3d as jm3
from open_duck_playground_tpu.ops import smooth as jsmooth
from open_duck_playground_tpu.ops import solver as jsolver
from open_duck_playground_tpu_torch import interop
from open_duck_playground_tpu_torch.envs import randomize
from open_duck_playground_tpu_torch.mjcf import compile_mjcf
from open_duck_playground_tpu_torch.mjcf import npdynamics as npd
from open_duck_playground_tpu_torch.ops import constraint as tcon
from open_duck_playground_tpu_torch.ops import forward as tfwd
from open_duck_playground_tpu_torch.ops import linalg as tlinalg
from open_duck_playground_tpu_torch.ops import math3d as tm3
from open_duck_playground_tpu_torch.ops import smooth as tsmooth
from open_duck_playground_tpu_torch.ops import solver as tsolver
from open_duck_playground_tpu_torch.ops.cuda_step import FusedPhysics, flatten_dr_fields
from open_duck_playground_tpu_torch.ops.types import Contact, Data
from tests.duck_standin import pipeline_outputs, settled_states
from tests.test_physics import FREE_BODY, PENDULUM
from tests.torch_helpers import jax_model_fields, numpy_tree, random_states, scene, standin_assets

pytest_plugins = ["tests.torch_lock"]  # never beside tests/test_resume.py (see there)

B = 8
SCENES = {"flat": ("scene_flat_terrain.xml", True),
          "backlash": ("scene_flat_terrain_backlash.xml", False),
          "rough": ("scene_rough_terrain_backlash.xml", True)}  # name: (xml, DR on)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    with standin_assets(str(tmp_path_factory.mktemp("standin"))) as r:
        yield r


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _n(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


# ---------------------------------------------------------------------------
# math3d
# ---------------------------------------------------------------------------


def _math_inputs():
    rng = np.random.RandomState(0)
    q = rng.normal(size=(16, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    v = rng.normal(size=(16, 3)).astype(np.float32)
    s6 = rng.normal(size=(16, 6)).astype(np.float32)
    t6 = rng.normal(size=(16, 6)).astype(np.float32)
    mass = rng.uniform(0.1, 2.0, 16).astype(np.float32)
    a = rng.normal(size=(16, 3, 3)).astype(np.float32)
    inertia = (a @ a.transpose(0, 2, 1)).astype(np.float32)
    w = rng.normal(size=(16, 3)).astype(np.float32)
    w[0] = 0.0  # the zero-velocity branch of quat_integrate
    return dict(q=q, v=v, s6=s6, t6=t6, mass=mass, inertia=inertia, w=w)


MATH = {
    "quat_inv": lambda M, x: M.quat_inv(x["q"]),
    "quat_rot": lambda M, x: M.quat_rot(x["q"], x["v"]),
    "quat_rot_inv": lambda M, x: M.quat_rot_inv(x["q"], x["v"]),
    "quat_to_mat": lambda M, x: M.quat_to_mat(x["q"]),
    "quat_integrate": lambda M, x: M.quat_integrate(x["q"], x["w"], 0.002),
    "normalize": lambda M, x: M.normalize(x["v"]),
    "motion_cross": lambda M, x: M.motion_cross(x["s6"], x["t6"]),
    "force_cross": lambda M, x: M.force_cross(x["s6"], x["t6"]),
    "skew": lambda M, x: M.skew(x["v"]),
    "spatial_inertia": lambda M, x: M.spatial_inertia(x["mass"], x["inertia"], x["v"]),
    "transform_motion": lambda M, x: M.transform_motion(x["s6"], x["v"]),
}


@pytest.mark.parametrize("fn", list(MATH))
def test_math3d_matches_jax(fn):
    x = _math_inputs()
    ours = MATH[fn](tm3, {k: _t(v) for k, v in x.items()})
    ref = MATH[fn](jm3, {k: jnp.asarray(v) for k, v in x.items()})
    assert ours.shape == ref.shape
    np.testing.assert_allclose(_n(ours), np.asarray(ref), atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# stages on random states
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def shared_dir(tmp_path_factory):
    """A directory every xdist worker of this pytest run sees (the run's
    own base directory without xdist)."""
    base = tmp_path_factory.getbasetemp()
    return base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base


@functools.lru_cache(maxsize=None)
def _scene_run(shared_dir, root, name):
    """JAX's stages of one scene on random states, with the port's model
    (DR fields carried across); computed by one worker of the pytest run
    and read back by the others."""
    path = os.path.join(str(shared_dir), f"jax_stages_{name}.pkl")
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(path):
            with open(path + ".tmp", "wb") as f:
                pickle.dump(_jax_stages(root, name), f)
            os.replace(path + ".tmp", path)
        with open(path, "rb") as f:
            fields, states, out = pickle.load(f)
    return interop.model_from_numpy(fields), states, out


def _jax_stages(root, name):
    """JAX's stages of one scene on random states (eager vmap): the port's
    model fields, the states and every output as numpy."""
    xml, with_dr = SCENES[name]
    jm = jax_compile(scene(root, xml), timestep=0.002)
    qpos, qvel, ctrl = random_states(jm.keyframe("home"), jm.nq, jm.nv, jm.nu, B, seed=1)
    if with_dr:
        mv, axes = jax_randomize.domain_randomize(
            jm, jax.random.split(jax.random.PRNGKey(3), B))
    else:
        mv, axes = jm, None

    def stages(m, q, v, c):
        xpos, xquat, xmat, xanchor, xaxis = jsmooth.kinematics(m, q)
        gpos, gmat = jsmooth.geom_kinematics(m, xpos, xquat)
        spos, smat = jsmooth.site_kinematics(m, xpos, xquat)
        subtree_com, xipos, cinert, cdof = jsmooth.com_pos(m, xpos, xquat, xmat, xanchor, xaxis)
        M = jsmooth.crb(m, cinert, cdof)
        contact = jfwd.collide(m, gpos, gmat)
        cvel, cdofdot = jsmooth.com_vel(m, cdof, v)
        bias = jsmooth.rne(m, cinert, cdof, cdofdot, cvel, v)
        _, qfrc_act = jfwd.actuation(m, q, v, c)
        qfrc_smooth = qfrc_act - bias - m.dof_damping * v
        qacc_smooth = jlinalg.solve_psd(M, qfrc_smooth)
        efc = jcon.make_efc(m, v, q, contact, cdof, subtree_com)
        H = M + (efc.J * efc.D[:, None]).T @ efc.J
        warm = 0.5 * qacc_smooth  # a warmstart that differs from qacc_smooth
        qacc, qfrc_con = jsolver.solve(m, M, qacc_smooth, efc, warmstart=warm)
        d = jfwd.step(m, jfwd.make_data(m).replace(qpos=q, qvel=v, ctrl=c))
        return dict(xpos=xpos, xquat=xquat, xmat=xmat, xanchor=xanchor, xaxis=xaxis,
                    gpos=gpos, gmat=gmat, spos=spos, smat=smat, subtree_com=subtree_com,
                    xipos=xipos, cinert=cinert, cdof=cdof, M=M, contact=contact,
                    cvel=cvel, cdofdot=cdofdot, bias=bias, qfrc_smooth=qfrc_smooth,
                    qacc_smooth=qacc_smooth, efc=efc._asdict(), H=H, warm=warm, qacc=qacc,
                    qfrc_con=qfrc_con, step=d)

    out = jax.vmap(stages, in_axes=(axes, 0, 0, 0))(mv, *map(jnp.asarray, (qpos, qvel, ctrl)))
    return jax_model_fields(mv), (qpos, qvel, ctrl), numpy_tree(out)


STAGES = ("kinematics", "com_pos", "crb", "collide", "make_efc", "solve_psd", "solver", "step")


def _stage_kinematics(tm, x, r):
    """Readings (flat / backlash / rough): xpos 5.6e-9 / 3.7e-9 / 3.7e-9,
    xquat 6e-8, xmat 1.2e-7 / 6e-8 / 6e-8; geom and site poses 0."""
    ours = tsmooth.kinematics(tm, _t(x[0]))
    for k, o in zip(("xpos", "xquat", "xmat", "xanchor", "xaxis"), ours):
        np.testing.assert_allclose(_n(o), r[k], atol=1e-6, err_msg=k)
    for k, o in zip(("gpos", "gmat"), tsmooth.geom_kinematics(tm, _t(r["xpos"]), _t(r["xquat"]))):
        np.testing.assert_allclose(_n(o), r[k], atol=1e-6, err_msg=k)
    for k, o in zip(("spos", "smat"), tsmooth.site_kinematics(tm, _t(r["xpos"]), _t(r["xquat"]))):
        np.testing.assert_allclose(_n(o), r[k], atol=1e-6, err_msg=k)


def _stage_com_pos(tm, x, r):
    """com_pos, com_vel and rne. Readings (flat / backlash / rough):
    cinert 4.7e-10, the rest of com_pos and com_vel 0; bias 1.9e-6 /
    4.5e-8 / 3e-8."""
    ours = tsmooth.com_pos(tm, *(_t(r[k]) for k in ("xpos", "xquat", "xmat", "xanchor", "xaxis")))
    for k, o in zip(("subtree_com", "xipos", "cinert", "cdof"), ours):
        np.testing.assert_allclose(_n(o), r[k], atol=1e-6, err_msg=k)
    cvel, cdofdot = tsmooth.com_vel(tm, _t(r["cdof"]), _t(x[1]))
    np.testing.assert_allclose(_n(cvel), r["cvel"], atol=1e-6)
    np.testing.assert_allclose(_n(cdofdot), r["cdofdot"], atol=1e-6)
    bias = tsmooth.rne(tm, *(_t(r[k]) for k in ("cinert", "cdof", "cdofdot", "cvel")), _t(x[1]))
    np.testing.assert_allclose(_n(bias), r["bias"], rtol=1e-5, atol=1e-5)


def _stage_crb(tm, x, r):
    """M at atol 2e-5 (test_lane's). Readings: 3.7e-9 / 1.9e-9 / 1.9e-9."""
    M = tsmooth.crb(tm, _t(r["cinert"]), _t(r["cdof"]))
    np.testing.assert_allclose(_n(M), r["M"], atol=2e-5)


def _stage_collide(tm, x, r):
    """dist at rtol 1e-4 / atol 1e-6 on every slot, the frame at 1e-6, the
    validity and geoms exactly; the positions match on more than 90% of the
    slots (the soles' tied vertices let a spread pick flip on a last bit).
    Readings (flat / backlash / rough): dist 9.3e-10 / 1.9e-9 / 1.9e-9,
    frame 0, positions matching on 98% / 95% / 96%."""
    c = tfwd.collide(tm, _t(r["gpos"]), _t(r["gmat"]))
    rc = r["contact"]
    np.testing.assert_allclose(np.minimum(_n(c.dist), 1e9), np.minimum(rc["dist"], 1e9),
                               rtol=1e-4, atol=1e-6)
    match = (np.abs(_n(c.pos) - rc["pos"]) < 1e-4).all(-1)
    assert match.mean() > 0.9, match.mean()
    np.testing.assert_allclose(_n(c.frame), rc["frame"], atol=1e-6)
    np.testing.assert_array_equal(_n(c.efc_valid), rc["efc_valid"])
    np.testing.assert_array_equal(_n(c.geom1), rc["geom1"])
    np.testing.assert_array_equal(_n(c.geom2), rc["geom2"])


def _stage_make_efc(tm, x, r):
    """J at 2e-5, D at rtol 2e-3, aref at rtol 2e-3 / atol 1e-3 (test_lane's),
    on JAX's contacts. Readings (flat / backlash / rough): J 1.5e-8 / 3e-8
    / 3e-8, D 0, aref 9.5e-7 / 3.8e-6 / 3.8e-6."""
    rc = r["contact"]
    contact = Contact(**{k: _t(v) for k, v in rc.items()})
    efc = tcon.make_efc(tm, _t(x[1]), _t(x[0]), contact, _t(r["cdof"]), _t(r["subtree_com"]))
    re = r["efc"]
    np.testing.assert_allclose(_n(efc.J), re["J"], atol=2e-5)
    np.testing.assert_allclose(_n(efc.D), re["D"], rtol=2e-3)
    np.testing.assert_allclose(_n(efc.aref), re["aref"], rtol=2e-3, atol=1e-3)
    np.testing.assert_allclose(_n(efc.pos), re["pos"], atol=1e-6)
    np.testing.assert_allclose(_n(efc.floss), re["floss"], atol=1e-6)
    np.testing.assert_array_equal(_n(efc.is_friction), re["is_friction"][0])
    np.testing.assert_array_equal(_n(efc.is_quad), re["is_quad"][0])


def _stage_solve_psd(tm, x, r):
    """The LDL solve (the default backend, as JAX's) of M and of the Newton
    Hessian H = M + J^T D J, against JAX's LDL at rtol 1e-3 / atol 1e-3
    (test_lane's qacc_smooth bound), and the cholesky backend against it.
    Readings (flat / backlash / rough): |qacc_smooth err| 3.8e-5 / 5.3e-5 /
    5.3e-5; on H (backlash) the port's LDL reads 3e-7 relative to a float64
    solve, JAX's 1.5e-6."""
    M, H, b = _t(r["M"]), _t(r["H"]), _t(r["qfrc_smooth"])
    np.testing.assert_allclose(_n(tlinalg.solve_psd(M, b)), r["qacc_smooth"],
                               rtol=1e-3, atol=1e-3)
    ref_h = np.asarray(jax.vmap(jlinalg.solve_psd)(jnp.asarray(r["H"]), jnp.asarray(r["qfrc_smooth"])))
    np.testing.assert_allclose(_n(tlinalg.solve_psd(H, b)), ref_h, rtol=1e-3, atol=1e-3)
    try:
        tlinalg.set_backend("cholesky")
        np.testing.assert_allclose(_n(tlinalg.solve_psd(M, b)), r["qacc_smooth"],
                                   rtol=1e-3, atol=1e-3)
    finally:
        tlinalg.set_backend("ldl")


def _stage_solver(tm, x, r):
    """The Newton solve on JAX's M, qacc_smooth, efc and warmstart. Its
    iterations=1 step is discontinuous in last bits of its inputs on these
    random states: the port's own LDL and cholesky backends part on other
    envs at the same size (the port's LDL reads 3e-7 relative to a float64
    solve of H, JAX's 1.5e-6). So, as test_lane.py's backlash test: some
    envs track exactly, and the forces agree where qacc does; loose bounds
    on the rest. Readings (backlash / rough): 3 / 3 of 8 envs within 4e-6
    relative, their qfrc_constraint within 7e-5; the rest up to 0.10."""
    re = r["efc"]
    efc = tcon.Efc(*(_t(re[k]) if k not in ("is_friction", "is_quad") else _t(re[k][0])
                     for k in tcon.Efc._fields))
    qacc, qfrc = tsolver.solve(tm, _t(r["M"]), _t(r["qacc_smooth"]), efc, warmstart=_t(r["warm"]))
    assert np.isfinite(_n(qacc)).all() and np.isfinite(_n(qfrc)).all()
    err = (np.abs(_n(qacc) - r["qacc"]).max(axis=1) / np.abs(r["qacc"]).max(axis=1))
    tracked = err < 1e-5
    assert tracked.sum() >= 2, err
    assert err.max() < 0.25, err
    ferr = (np.abs(_n(qfrc) - r["qfrc_con"]).max(axis=1)
            / np.maximum(np.abs(r["qfrc_con"]).max(axis=1), 1e-6))
    assert ferr[tracked].max() < 1e-3, ferr


# ---------------------------------------------------------------------------
# full substeps
# ---------------------------------------------------------------------------


def _stage_step(tm, x, r):
    """One fwd.step from random states (warmstart 0). Kinematic outputs of
    the given state tightly; the solve's outputs by test_lane's quantiles.
    Readings (flat / backlash / rough): kinematic outputs 1.9e-6 / 1.2e-7 /
    6e-8; qpos q95 1.2e-5 / 7.1e-6 / 2.2e-5, max 2e-5 / 5.7e-5 / 5.8e-5;
    qvel q50 1.5e-8 / 2.8e-7 / 3.9e-5, max 0.010 / 0.028 / 0.029."""
    qpos, qvel, ctrl = x
    d = tfwd.step(tm, tfwd.make_data(tm, B).replace(qpos=_t(qpos), qvel=_t(qvel), ctrl=_t(ctrl)))
    ref = r["step"]
    for k in ("site_xpos", "site_xmat", "xpos", "subtree_com", "actuator_force",
              "qfrc_actuator", "qfrc_smooth"):
        np.testing.assert_allclose(_n(getattr(d, k)), ref[k], rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(np.minimum(_n(d.contact.dist), 1e9),
                               np.minimum(ref["contact"]["dist"], 1e9), rtol=1e-4, atol=1e-6)
    qp_err = np.abs(_n(d.qpos) - ref["qpos"])
    qv_err = np.abs(_n(d.qvel) - ref["qvel"])
    assert np.quantile(qp_err, 0.95) < 2e-4, np.quantile(qp_err, 0.95)
    assert qp_err.max() < 2e-3, qp_err.max()
    assert np.quantile(qv_err, 0.5) < 1e-3, np.quantile(qv_err, 0.5)
    assert qv_err.max() < 0.5, qv_err.max()


# a scene's stages run one after another, so a worker computes its JAX
# fixture once
@pytest.mark.parametrize("name,stage", [(n, s) for n in SCENES for s in STAGES])
def test_stage_matches_jax(shared_dir, root, name, stage):
    tm, x, r = _scene_run(str(shared_dir), root, name)
    globals()[f"_stage_{stage}"](tm, x, r)


@pytest.fixture(scope="module")
def settled_run(root):
    """JAX's step_n(..., 10) from settled states of the flat scene (jitted
    once), and the port's model."""
    jm = jax_compile(scene(root, SCENES["flat"][0]), timestep=0.002)
    qpos, qvel, ctrl = settled_states(jm.keyframe("home"), jm.nq, jm.nv, jm.nu, 16, seed=2)
    run = jax.jit(jax.vmap(lambda q, v, c: jfwd.step_n(
        jm, jfwd.make_data(jm).replace(qpos=q, qvel=v), c, 10)))
    ref = numpy_tree(run(*map(jnp.asarray, (qpos, qvel, ctrl))))
    return interop.model_from_numpy(jax_model_fields(jm)), (qpos, qvel, ctrl), ref


def test_step_n_from_settled_states_matches_jax(settled_run):
    """10 substeps from settled states (test_lane's regime and bounds, over
    a control step): quantiles of qpos and qvel, the contact set exact, the
    contact depths and site positions by quantiles (an env that leaves
    moves its contacts). Readings: qpos q95 5.9e-5, max 3.2e-4; qvel q50
    2.2e-4, max 2.4e-2; dist q95 9e-6, max 4.3e-4; site_xpos q95 6.6e-6,
    max 3.6e-5; no contact slot flips."""
    tm, (qpos, qvel, ctrl), ref = settled_run
    d = tfwd.step_n(tm, tfwd.make_data(tm, 16).replace(qpos=_t(qpos), qvel=_t(qvel)), _t(ctrl), 10)
    qp_err = np.abs(_n(d.qpos) - ref["qpos"])
    qv_err = np.abs(_n(d.qvel) - ref["qvel"])
    assert np.quantile(qp_err, 0.95) < 2e-4, np.quantile(qp_err, 0.95)
    assert qp_err.max() < 2e-3, qp_err.max()
    assert np.quantile(qv_err, 0.5) < 1e-3, np.quantile(qv_err, 0.5)
    assert qv_err.max() < 0.5, qv_err.max()
    np.testing.assert_allclose(_n(d.time), ref["time"], rtol=1e-6)
    cd, rcd = _n(d.contact.dist), ref["contact"]["dist"]
    np.testing.assert_array_equal(cd < 1e9, rcd < 1e9)
    both = (cd < 1e9) & (rcd < 1e9)
    dist_err = np.abs(cd[both] - rcd[both])
    assert np.quantile(dist_err, 0.95) < 1e-4 and dist_err.max() < 2e-3, dist_err.max()
    site_err = np.abs(_n(d.site_xpos) - ref["site_xpos"])
    assert np.quantile(site_err, 0.95) < 1e-4 and site_err.max() < 2e-3, site_err.max()


# ---------------------------------------------------------------------------
# toy models: tests/test_physics.py's analytic oracles on the port's pipeline
# ---------------------------------------------------------------------------

SERVO = """
<mujoco model="servo">
  <compiler angle="radian"/>
  <option timestep="0.002"/>
  <worldbody>
    <body name="arm" pos="0 0 1">
      <joint name="hinge" type="hinge" axis="0 1 0" damping="0.5"/>
      <inertial pos="0 0 0" mass="0.1" diaginertia="0.01 0.01 0.01"/>
    </body>
  </worldbody>
  <actuator>
    <position name="hinge" joint="hinge" kp="20"/>
  </actuator>
</mujoco>
"""
_HINGE = '<joint name="hinge" type="hinge" axis="0 1 0" pos="0 0 0"/>'
LIMITED = PENDULUM.replace(_HINGE, _HINGE[:-2] + ' range="-0.2 0.2"/>')
FRICTIONLOSS = PENDULUM.replace(_HINGE, _HINGE[:-2] + ' frictionloss="5.0"/>')


def _compile_str(tmp_path, xml):
    p = tmp_path / "model.xml"
    p.write_text(xml)
    return compile_mjcf(str(p))


def _init(m, qpos, qvel=None, ctrl=None):
    row = lambda x, n: torch.zeros(1, n) if x is None else torch.tensor([x], dtype=torch.float32)  # noqa: E731
    return tfwd.init(m, row(qpos, m.nq), row(qvel, m.nv), row(ctrl, m.nu))


def _free_fall(m):
    d = _init(m, m.qpos0.tolist())
    for _ in range(100):
        d = tfwd.step(m, d)
    t = 0.1
    # semi-implicit Euler bias: z_n = 1 - 0.5 g t(t+dt)
    z_euler = 1.0 - 0.5 * 9.81 * t * (t + 0.001)
    assert abs(float(d.qpos[0, 2]) - z_euler) < 1e-4


def _angular_momentum(m):
    m = m.replace(opt=m.opt.replace(gravity=torch.zeros(3)))
    d = _init(m, m.qpos0.tolist(), [0, 0, 0, 3.0, -2.0, 1.0])

    def ang_mom(d):
        q = d.qpos[0, 3:7]
        R = tm3.quat_to_mat(tm3.quat_mul(q, m.body_iquat[1]))
        w_local_inertial = R.T @ tm3.quat_rot(q, d.qvel[0, 3:6])
        return _n(R @ (m.body_inertia[1] * w_local_inertial))

    L0 = ang_mom(d)
    for _ in range(500):
        d = tfwd.step(m, d)
    np.testing.assert_allclose(ang_mom(d), L0, rtol=2e-2, atol=1e-3)


def _pendulum_dynamics(m):
    """qacc at release = -m g l sin(theta) / (I + m l^2)."""
    theta0 = 0.3
    d = _init(m, [theta0])
    l, mass, inertia = 0.5, 1.0, 0.001
    qacc_expected = -mass * 9.81 * l * np.sin(theta0) / (inertia + mass * l * l)
    np.testing.assert_allclose(float(d.qacc[0, 0]), qacc_expected, rtol=1e-4)


def _pendulum_period(m):
    """Small-angle period T = 2 pi sqrt((I + m l^2)/(m g l))."""
    theta0 = 0.05
    d = _init(m, [theta0])
    T_expected = 2 * np.pi * np.sqrt((0.001 + 0.25) / (1.0 * 9.81 * 0.5))
    d = tfwd.step_n(m, d, torch.zeros(1, 0), int(round(T_expected / 0.001)))
    assert abs(float(d.qpos[0, 0]) - theta0) < 0.004
    assert abs(float(d.qvel[0, 0])) < 0.05


def _pendulum_energy_drift(m):
    d = _init(m, [1.0])

    def energy(d):
        th, w = float(d.qpos[0, 0]), float(d.qvel[0, 0])
        return 0.5 * (0.001 + 0.25) * w * w + 1.0 * 9.81 * 0.5 * (1 - np.cos(th))

    e0 = energy(d)
    d = tfwd.step_n(m, d, torch.zeros(1, 0), 2000)
    assert abs(energy(d) - e0) / e0 < 0.02


def _joint_limit(m):
    d = _init(m, [0.19])
    worst = 0.0
    for _ in range(300):
        d = tfwd.step_n(m, d, torch.zeros(1, 0), 10)
        worst = max(worst, abs(float(d.qpos[0, 0])))
    assert worst < 0.25, worst  # the soft limit allows a small overshoot


def _frictionloss(m):
    """gravity torque at 0.3 rad (1.45 Nm) below the 5 Nm frictionloss:
    near-stick (MuJoCo's friction-loss constraint is regularized)."""
    d = _init(m, [0.3])
    d = tfwd.step_n(m, d, torch.zeros(1, 0), 200)
    assert abs(float(d.qpos[0, 0]) - 0.3) < 1e-2
    assert abs(float(d.qvel[0, 0])) < 0.05


def _position_servo(m):
    m = m.replace(opt=m.opt.replace(gravity=torch.zeros(3)))
    d = _init(m, [0.0], [0.0], [0.0])
    d = tfwd.step_n(m, d, torch.tensor([[0.7]]), 2000)
    assert abs(float(d.qpos[0, 0]) - 0.7) < 1e-2


TOYS = {"free_fall": (FREE_BODY, _free_fall),
        "angular_momentum": (FREE_BODY, _angular_momentum),
        "pendulum_dynamics": (PENDULUM, _pendulum_dynamics),
        "pendulum_period": (PENDULUM, _pendulum_period),
        "pendulum_energy_drift": (PENDULUM, _pendulum_energy_drift),
        "joint_limit": (LIMITED, _joint_limit),
        "frictionloss": (FRICTIONLOSS, _frictionloss),
        "position_servo": (SERVO, _position_servo)}


@pytest.mark.parametrize("toy", list(TOYS))
def test_toy_model_oracle(tmp_path, toy):
    xml, check = TOYS[toy]
    check(_compile_str(tmp_path, xml))


def test_crb_matches_numpy_oracle(root):
    """M, xpos and subtree_com of the stand-in's flat scene against the
    float64 numpy oracle (mjcf/npdynamics), at test_physics.py's bounds."""
    m = compile_mjcf(scene(root, SCENES["flat"][0]), timestep=0.002)
    nm = npd.NpModel()
    nm.nbody, nm.njnt, nm.nv, nm.nq = m.nbody, m.njnt, m.nv, m.nq
    for f in ("body_parentid", "body_rootid", "body_jntadr", "body_jntnum", "body_dofadr",
              "body_dofnum", "jnt_type", "jnt_qposadr", "jnt_dofadr", "jnt_bodyid",
              "dof_bodyid", "dof_parentid"):
        setattr(nm, f, getattr(m, f).np)
    for f in ("body_pos", "body_quat", "body_ipos", "body_iquat", "body_mass", "body_inertia",
              "jnt_pos", "jnt_axis", "dof_armature", "qpos0"):
        setattr(nm, f, _n(getattr(m, f)).astype(np.float64))
    qpos = np.array(m.keyframe("home").qpos, np.float64)
    qpos[7:] += np.random.RandomState(3).uniform(-0.3, 0.3, m.nq - 7)
    xpos, xquat, xanchor, xaxis = npd.fk(nm, qpos)
    sc, _, cinert, cdof = npd.com_quantities(nm, xpos, xquat, xanchor, xaxis)
    M_np = npd.crb_matrix(nm, cinert, cdof)
    xp, xq, xm, xa, xx = tsmooth.kinematics(m, _t(qpos[None].astype(np.float32)))
    sc_t, _, cinert_t, cdof_t = tsmooth.com_pos(m, xp, xq, xm, xa, xx)
    np.testing.assert_allclose(_n(tsmooth.crb(m, cinert_t, cdof_t))[0], M_np, rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(_n(xp)[0], xpos, atol=1e-5)
    np.testing.assert_allclose(_n(sc_t)[0], sc, atol=1e-5)


def test_home_keyframe_holds_base_height(root):
    """The verify flow: step_n(model, data, ctrl, 10) at `home` holds base z
    in [0.1, 0.25] (20 control steps, flat and rough)."""
    for xml in (SCENES["flat"][0], SCENES["rough"][0]):
        m = compile_mjcf(scene(root, xml), timestep=0.002)
        kf = m.keyframe("home")
        ctrl = torch.tensor(kf.ctrl, dtype=torch.float32)[None]
        d = tfwd.init(m, torch.tensor(kf.qpos, dtype=torch.float32)[None], torch.zeros(1, m.nv),
                      ctrl)
        for _ in range(20):
            d = tfwd.step_n(m, d, ctrl, 10)
        z = float(d.qpos[0, 2])
        assert 0.1 < z < 0.25, (xml, z)
        assert float(d.sensordata[0, 11]) > 0.95  # upvector z


# ---------------------------------------------------------------------------
# the twin (the kernel's plain version) against the pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["flat", "rough"])
def test_twin_matches_pipeline(root, name):
    """One substep from settled states (16 envs; DR on for the rough scene):
    the kinematic outputs to 1e-6, contacts on the same slots, the rest by
    test_lane.py's quantiles (its lane-vs-pipeline substep bounds).
    Readings (flat / rough): kinematic 6.7e-8 / 7.5e-8; qpos q95 6.7e-6 /
    1.5e-6, max 1.8e-5; qvel q50 8.3e-8 / 2.7e-6, max 9e-3."""
    xml, with_dr = SCENES[name]
    m = compile_mjcf(scene(root, xml), timestep=0.002)
    n = 16
    qpos, qvel, ctrl = (_t(x) for x in settled_states(m.keyframe("home"), m.nq, m.nv, m.nu, n,
                                                      seed=4))
    mv = randomize.domain_randomize(m, n, torch.Generator().manual_seed(5)) if with_dr else m
    dr = flatten_dr_fields(mv) if with_dr else None
    warm = torch.zeros_like(qvel)
    twin = FusedPhysics(m).plain(qpos, qvel, warm, ctrl, 1, dr)
    d = tfwd.step_n(mv, tfwd.make_data(mv, n).replace(qpos=qpos, qvel=qvel), ctrl, 1)
    pipe = pipeline_outputs(d)
    for k in ("site_xpos", "site_xmat", "actuator_force"):
        np.testing.assert_allclose(_n(pipe[k]), _n(twin[k]), atol=1e-6, err_msg=k)
    cd, rcd = _n(pipe["contact_dist"]), _n(twin["contact_dist"])
    np.testing.assert_array_equal(cd < 1e9, rcd < 1e9)
    both = (cd < 1e9) & (rcd < 1e9)
    np.testing.assert_allclose(cd[both], rcd[both], rtol=1e-3, atol=1e-5)
    qp_err = np.abs(_n(pipe["qpos"]) - _n(twin["qpos"]))
    qv_err = np.abs(_n(pipe["qvel"]) - _n(twin["qvel"]))
    assert np.quantile(qp_err, 0.95) < 2e-4, np.quantile(qp_err, 0.95)
    assert qp_err.max() < 2e-3, qp_err.max()
    assert np.quantile(qv_err, 0.5) < 1e-3, np.quantile(qv_err, 0.5)
    assert qv_err.max() < 0.5, qv_err.max()


# ---------------------------------------------------------------------------
# the slice: Joystick(physics="pipeline") against the JAX Joystick
# ---------------------------------------------------------------------------

N_ENVS = 4
OVERRIDES = {  # a step deterministic apart from physics (as test_torch_env.py)
    "noise_config.level": 0.0,
    "noise_config.action_max_delay": 1,
    "noise_config.imu_max_delay": 1,
    "push_config.enable": False,
}


@pytest.fixture(scope="module")
def jax_slice(root):
    """The JAX TrainEnv (DR on, its CPU pipeline): reset and one step."""
    from open_duck_playground_tpu.envs.joystick import Joystick as JaxJoystick
    from open_duck_playground_tpu.envs.wrapper import TrainEnv as JaxTrainEnv

    env = JaxJoystick("flat_terrain", config_overrides=OVERRIDES)
    te = JaxTrainEnv(env, num_envs=N_ENVS, episode_length=1000,
                     randomization_fn=jax_randomize.domain_randomize,
                     randomization_rng=jax.random.PRNGKey(0))
    action = np.random.RandomState(0).uniform(-1.0, 1.0, (N_ENVS, env.action_size)).astype(
        np.float32)
    state = jax.jit(te.reset)(jax.random.PRNGKey(1))
    nxt = jax.jit(te.step)(state, action)
    return dict(states=[numpy_tree(state), numpy_tree(nxt)], action=action,
                model=jax_model_fields(te._model_v))


def _pipeline_slice(jax_slice):
    """The port's TrainEnv of Joystick("flat_terrain", physics="pipeline") on
    the CPU with JAX's DR model, and JAX's reset state carried across."""
    from open_duck_playground_tpu_torch.envs.joystick import Joystick
    from open_duck_playground_tpu_torch.envs.wrapper import TrainEnv

    env = Joystick("flat_terrain", config_overrides=OVERRIDES, device="cpu", physics="pipeline")
    model_v = interop.model_from_numpy(jax_slice["model"])
    te = TrainEnv(env, num_envs=N_ENVS, episode_length=1000,
                  randomization_fn=lambda model, n, g: model_v)
    return env, te, interop.state_from_numpy(jax_slice["states"][0])


def _check_slice(env, out, ref):
    """test_torch_env.py's slice bounds on obs and reward, done identical,
    qpos and qvel by quantiles; the kernel never launched."""
    assert env.physics.launches == 0
    assert isinstance(out.data, Data) and out.data.qacc is not None
    np.testing.assert_array_equal(_n(out.done), ref["done"])
    qp_err = np.abs(_n(out.data.qpos) - ref["data"]["qpos"])
    qv_err = np.abs(_n(out.data.qvel) - ref["data"]["qvel"])
    assert np.quantile(qp_err, 0.5) < 1e-4 and qp_err.max() < 2e-3, qp_err.max()
    assert np.quantile(qv_err, 0.5) < 1e-2 and qv_err.max() < 0.5, qv_err.max()
    err = np.concatenate([np.abs(_n(out.obs[k]) - ref["obs"][k]).ravel()
                          for k in ("state", "privileged_state")])
    assert np.isfinite(err).all()
    assert np.quantile(err, 0.5) < 1e-5, np.quantile(err, 0.5)
    assert np.quantile(err, 0.9) < 1e-2, np.quantile(err, 0.9)
    assert err.max() < 2.0, err.max()
    np.testing.assert_allclose(_n(out.reward), ref["reward"], atol=0.05)


def test_slice_on_the_pipeline_matches_jax(jax_slice):
    """One control step from JAX's reset state (feet landing from the
    keyframe with the reset's joint scaling: not a settled state), both on
    their pipelines; test_torch_env.py's slice bounds on obs and reward, done
    identical. Readings: qpos |err| q50 2.3e-5 / max 6.0e-4, qvel q50
    1.5e-3 / max 3.9e-2; obs q50 0, q90 1.5e-3, max 1.54 (the accelerometer);
    reward max 7.6e-3."""
    env, te, first = _pipeline_slice(jax_slice)
    out = te.step(first, torch.from_numpy(jax_slice["action"]))
    _check_slice(env, out, jax_slice["states"][1])


def test_captured_body_on_the_pipeline_matches_jax(jax_slice):
    """The body a CUDA graph of the pipeline's env step records
    (wrapper.step_into over buffers cloned from JAX's reset state, every
    field of the pipeline's Data and Contact included) against the JAX
    TrainEnv's jitted step on its CPU pipeline, at
    test_slice_on_the_pipeline_matches_jax's bounds; the buffers hold the
    port's dtypes."""
    from open_duck_playground_tpu_torch.envs.wrapper import step_into
    from open_duck_playground_tpu_torch.utils.graphs import clone_tree, tree_leaves

    env, te, first = _pipeline_slice(jax_slice)
    buffers = clone_tree(first)
    leaves = tree_leaves(buffers)
    assert leaves["/data/contact/geom1"].dtype == torch.int32
    assert leaves["/data/contact/efc_valid"].dtype == torch.bool
    assert step_into(te, buffers, torch.from_numpy(jax_slice["action"])) is buffers
    assert all(t is leaves[k] for k, t in tree_leaves(buffers).items())
    _check_slice(env, buffers, jax_slice["states"][1])


def test_physics_choice_is_explicit(root):
    """The kernel stays the default; "pipeline" only when asked; anything
    else raises."""
    from open_duck_playground_tpu_torch.envs.joystick import Joystick
    from open_duck_playground_tpu_torch.envs.standing import Standing

    assert Joystick("flat_terrain", device="cpu").physics_mode == "kernel"
    assert Standing("flat_terrain", device="cpu", physics="pipeline").physics_mode == "pipeline"
    with pytest.raises(ValueError):
        Joystick("flat_terrain", device="cpu", physics="mjx")
