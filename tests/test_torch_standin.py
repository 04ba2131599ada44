"""The generated stand-in duck: it compiles in both packages and in MuJoCo,
carries every name and width the envs look up, and stands (on the flat
floor, and on the rough scene's heightfield)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_duck_playground_tpu.mjcf import compile_mjcf as jax_compile
from open_duck_playground_tpu.ops import forward as fwd
from open_duck_playground_tpu_torch.mjcf import compile_mjcf as torch_compile
from open_duck_playground_tpu_torch.models.open_duck_mini_v2 import constants
from open_duck_playground_tpu_torch.ops.cuda_step import FusedPhysics
from tests import duck_standin
from tests.torch_helpers import scene, standin_assets

pytest_plugins = ["tests.torch_lock"]  # never beside tests/test_resume.py (see there)

SCENES = {
    "scene_flat_terrain.xml": dict(nq=21, nv=20, nu=14),
    "scene_flat_terrain_backlash.xml": dict(nq=31, nv=30, nu=14),
}
ROUGH = "scene_rough_terrain_backlash.xml"
SIZES = {**SCENES, ROUGH: dict(nq=31, nv=30, nu=14)}
SENSORS = ["upvector", "global_linvel", "global_angvel", "local_linvel", "accelerometer",
           "gyro", "left_foot_pos", "right_foot_pos", "left_foot_global_linvel",
           "right_foot_global_linvel"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    with standin_assets(str(tmp_path_factory.mktemp("standin"))) as r:
        yield r


@pytest.mark.parametrize("name", sorted(SIZES))
def test_standin_names_and_widths(root, name):
    for m in (jax_compile(scene(root, name)), torch_compile(scene(root, name))):
        for k, v in SIZES[name].items():
            assert getattr(m, k) == v, (name, k)
        assert m.njnt == 1 + 14 + (10 if "backlash" in name else 0)
        assert int(m.jnt_type[m.joint("floating_base")]) == 0
        assert m.body("trunk_assembly") == 2 and m.nbody >= 3
        assert float(m.body_mass[1]) == 0.0  # body 1: the massless base
        assert int(m.geom_contype[0]) == 0 and int(m.geom_conaffinity[0]) == 0  # geom 0 visual
        joints = [n for n in m.names.list("joint")]
        legs = [j for j in joints if j in constants.JOINTS_ORDER_NO_HEAD]
        assert legs == constants.JOINTS_ORDER_NO_HEAD
        for n in SENSORS:
            m.sensor(n)
        for n in ("imu", "left_foot", "right_foot"):
            m.site(n)
        floor = m.geom("floor")
        left, right = (m.geom(n) for n in constants.FEET_GEOMS)
        for g in (left, right):
            assert int(m.geom_type[g]) == 7  # mesh
        # PLANE_HULL (HFIELD_HULL on the rough scene), HULL_HULL
        assert {int(t) for t in m.pair_type} == ({1, 2} if name == ROUGH else {0, 2})
        for a, b in ((floor, left), (floor, right), (left, right)):
            m.find_pair(a, b)
        assert int(m.hull_nvert[0]) >= 8
        assert m.nsensordata == 46
        assert "home" in m.keyframes


def test_standin_compiles_in_mujoco(root):
    mujoco = pytest.importorskip("mujoco")
    for name, sizes in SCENES.items():
        mm = mujoco.MjModel.from_xml_path(scene(root, name))
        assert (mm.nq, mm.nv, mm.nu) == (sizes["nq"], sizes["nv"], sizes["nu"])
        assert mm.nsensordata == 46


def test_rough_standin_compiles_in_mujoco(root):
    """Compile only: MuJoCo's prism collider ejects the duck at 256x256
    (models/open_duck_mini_v2/judge_terrain.py)."""
    pytest.importorskip("mujoco")
    from open_duck_playground_tpu.deploy.mujoco_infer_base import load_mj_model

    mm = load_mj_model(scene(root, ROUGH))
    assert (mm.nq, mm.nv, mm.nu) == (31, 30, 14) and mm.nsensordata == 46
    assert (int(mm.hfield_nrow[0]), int(mm.hfield_ncol[0])) == (256, 256)
    np.testing.assert_allclose(mm.hfield_size[0], duck_standin.HFIELD_SIZE)


def test_rough_home_stands_on_the_bumps(root):
    """At the home keyframe the highest terrain point under the soles
    touches a sole vertex (contact dist 0 up to float32 rounding), the
    rest hover within the bumps' 1 cm, on both feet."""
    m = torch_compile(scene(root, ROUGH), timestep=0.002)
    kf = m.keyframe("home")
    assert abs(float(kf.qpos[2]) - duck_standin.standing_height()
               - duck_standin.rough_home_lift()) < 1e-6
    qpos, qvel, ctrl = (torch.tensor(np.asarray(x, np.float32))[None] for x in (
        kf.qpos, np.zeros(m.nv), kf.ctrl))
    cd = FusedPhysics(m).plain(qpos, qvel, torch.zeros_like(qvel), ctrl, 1)["contact_dist"][0]
    deepest = [float(cd[4 * p]) for p in range(m.npair) if int(m.pair_type[p]) == 1]
    assert len(deepest) == 2 and all(-1e-5 < d < 0.01 for d in deepest), deepest
    assert min(abs(d) for d in deepest) < 1e-5, deepest


def test_rough_standin_stands_under_the_twin(root):
    """Zero action (ctrl = home ctrl) from the home keyframe on the rough
    scene, through the twin for 5 control steps (0.1 s, 50 substeps; 1 s
    is held on the card through the kernel, tests/test_torch_cuda.py): no
    fall through the terrain, no ejection, both soles in contact."""
    m = torch_compile(scene(root, ROUGH), timestep=0.002)
    fp = FusedPhysics(m)
    kf = m.keyframe("home")
    qpos = torch.tensor(np.asarray(kf.qpos, np.float32))[None]
    ctrl = torch.tensor(np.asarray(kf.ctrl, np.float32))[None]
    qvel = warm = torch.zeros(1, m.nv)
    z0 = float(qpos[0, 2])
    for _ in range(5):
        out = fp.plain(qpos, qvel, warm, ctrl, 10)
        qpos, qvel, warm = out["qpos"], out["qvel"], out["qacc_warmstart"]
        assert abs(float(qpos[0, 2]) - z0) < 0.01, float(qpos[0, 2])
    assert float(qvel.abs().max()) < 0.5
    assert float(out["sensordata"][0, 11]) > 0.99  # upvector z
    cd = out["contact_dist"][0]
    for p in range(m.npair):
        if int(m.pair_type[p]) == 1:
            assert float(cd[4 * p]) < 1e-3  # the sole rests on the terrain


def test_standin_stands(root):
    """20 control steps at `home` with ctrl = home ctrl on the XLA path."""
    m = jax_compile(scene(root, "scene_flat_terrain.xml"), timestep=0.002)
    kf = m.keyframe("home")
    ctrl = jnp.asarray(kf.ctrl, jnp.float32)
    d = fwd.make_data(m).replace(qpos=jnp.asarray(kf.qpos, jnp.float32))
    step = jax.jit(lambda d: fwd.step_n(m, d, ctrl, 10))
    zs = []
    for _ in range(20):
        d = step(d)
        zs.append(float(d.qpos[2]))
    lo, hi = duck_standin.STAND_Z_BAND
    assert all(lo < z < hi for z in zs), zs
    assert float(d.sensordata[11]) > 0.95  # upvector z
    assert abs(float(kf.qpos[2]) - duck_standin.standing_height()) < 1e-6


def test_standin_sizes_as_stated():
    m_legs = 2 * sum(c[3] for c in duck_standin._LEG_CHAIN)
    m_head = sum(c[3] for c in duck_standin._HEAD_CHAIN)
    assert abs(0.8 + m_legs + m_head - 1.66) < 1e-9
    leg = sum(-c[2][2] for c in duck_standin._LEG_CHAIN[1:]) + duck_standin.SOLE_DROP
    assert abs(leg - 0.185) < 1e-9
    assert abs(duck_standin.standing_height() - 0.1992) < 1e-4


@pytest.fixture(scope="module")
def twin_outputs(root):
    """The twin's outputs on 64 envs, DR off, per variant: 10 substeps and 1
    from settled states, 1 from tilted states."""
    m = torch_compile(scene(root, "scene_flat_terrain.xml"), timestep=0.002)
    fp = FusedPhysics(m)
    accel = int(m.sensor_adr[m.sensor("accelerometer")])
    out = {}
    for variant, n, make in (("step", 10, duck_standin.settled_states),
                             ("init", 1, duck_standin.settled_states),
                             ("tilted", 1, duck_standin.tilted_states)):
        qpos, qvel, ctrl = (torch.from_numpy(x) for x in make(
            m.keyframe("home"), m.nq, m.nv, m.nu, 64, seed=1))
        out[variant] = duck_standin.parity_outputs(
            fp.plain(qpos, qvel, torch.zeros_like(qvel), ctrl, n), accel)
    return out


def test_tilted_states_turn_the_base(root):
    m = torch_compile(scene(root, "scene_flat_terrain.xml"), timestep=0.002)
    qpos, qvel, _ = duck_standin.tilted_states(m.keyframe("home"), m.nq, m.nv, m.nu, 256)
    quat = qpos[:, 3:7].astype(np.float64)
    np.testing.assert_allclose(np.linalg.norm(quat, axis=1), 1.0, atol=1e-6)
    angle = 2 * np.arccos(np.clip(np.abs(quat[:, 0]), 0, 1))
    assert angle.max() <= 0.5 + 1e-6 and np.quantile(angle, 0.5) > 0.1
    assert np.abs(qvel[:, 3:6]).max() <= 2.0 and np.quantile(np.abs(qvel[:, 3:6]), 0.5) > 0.5


@pytest.mark.parametrize(
    "variant,field,rough",
    [pytest.param(v, f, False, id=f"{v}-{f}") for (v, dr) in duck_standin.PARITY_LIMITS
     if not dr for f in duck_standin.PARITY_LIMITS[(v, dr)]]
    + [pytest.param(v, f, True, id=f"rough-{v}-{f}") for (v, dr) in duck_standin.PARITY_LIMITS
       if not dr for f in duck_standin.PARITY_LIMITS[(v, dr)]]
    + [pytest.param(v, f, "trainer", id=f"trainer-{v}-{f}")
       for (v, dr) in duck_standin.TRAINER_PARITY_LIMITS
       if not dr for f in duck_standin.TRAINER_PARITY_LIMITS[(v, dr)]])
def test_parity_limits_catch_a_wrong_column_or_env(twin_outputs, field, variant, rough):
    """The kernel-vs-twin check (duck_standin.parity) passes a kernel equal
    to the twin, and fails one that is wrong in a single column (every env)
    or in every column of one env in ten, by as much as the column's own
    values (q95 of |twin|), although q50 over the output stays 0; on the
    flat and rough limits, and (`rough` "trainer") the trainer path's."""
    p = twin_outputs[variant][field].astype(np.float64)
    valid = p < 1e9  # contact slots without a contact read 1e10
    mag = np.array([np.quantile(np.abs(p[valid[:, c], c]), 0.95) if valid[:, c].any() else 0.0
                    for c in range(p.shape[1])])
    col = int(np.argmax(mag * valid.mean(0)))
    one_col = p.copy()
    one_col[:, col] += np.where(valid[:, col], mag[col], 0.0)
    env_subset = p.copy()
    env_subset[::10] += np.where(valid[::10], mag, 0.0)
    for with_dr in (False, True):
        kw = dict(rough=rough is True, limits=duck_standin.TRAINER_PARITY_LIMITS[
            (variant, with_dr)] if rough == "trainer" else None)
        assert duck_standin.parity(p, p, variant, with_dr, field, **kw)["ok"]
        for wrong in (one_col, env_subset):
            r = duck_standin.parity(wrong, p, variant, with_dr, field, **kw)
            assert r["q50"] == 0.0 and not r["ok"], (with_dr, rough, r)


def test_parity_q50_limits_within_the_tpu_table():
    """No step-variant q50 limit is looser than 10x the TPU kernel's q50,
    on the flat scenes, the heightfield ones or the trainer path."""
    for with_dr in (False, True):
        tables = [duck_standin.parity_limits("step", with_dr, rough) for rough in (False, True)]
        for limits in tables + [duck_standin.TRAINER_PARITY_LIMITS[("step", with_dr)]]:
            for f, q50 in duck_standin.TPU_Q50.items():
                assert limits[f][0] <= 10 * q50, (f, with_dr, limits)
