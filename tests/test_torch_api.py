"""The port's smaller API against the JAX package: the reward terms no task
wires up (the JAX package ships them as a library), the env's qpos / qvel
setters and its global-velocity and feet-position getters, and three
one-liners (`wrapper.wrap_for_training`, `Names.id2name`,
`Data.replace_qpos`).

The reward terms are batched over envs in the port and per env in JAX
(held against `jax.vmap`), fed the same seeded numpy inputs, with a NaN in
env 0's first input (every term but cost_termination is NaN-guarded).
Tolerance: rtol 1e-5, atol 1e-6 (float32 on both sides; only
reward_base_y_swing's sin and the exps may round differently).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_duck_playground_tpu.envs import rewards as jrw
from open_duck_playground_tpu.envs import wrapper as jwrapper
from open_duck_playground_tpu.envs.joystick import Joystick as JaxJoystick
from open_duck_playground_tpu.mjcf import compile_mjcf as jax_compile_mjcf
from open_duck_playground_tpu.ops import forward as jax_fwd
from open_duck_playground_tpu_torch import interop
from open_duck_playground_tpu_torch.envs import rewards as rw
from open_duck_playground_tpu_torch.envs import wrapper
from open_duck_playground_tpu_torch.envs.joystick import Joystick
from open_duck_playground_tpu_torch.mjcf import compile_mjcf
from open_duck_playground_tpu_torch.models.open_duck_mini_v2 import constants
from open_duck_playground_tpu_torch.utils.graphs import tree_leaves
from tests.torch_helpers import numpy_tree, standin_assets

pytest_plugins = ["tests.torch_lock"]  # never beside tests/test_resume.py (see there)

B = 16


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    with standin_assets(str(tmp_path_factory.mktemp("standin"))) as r:
        yield r


def _f32(rng, *shape, lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


# name: (inputs from a RandomState; JAX vmap in_axes: 0 per env, None shared)
REWARD_CASES = {
    "cost_lin_vel_z": (lambda r: [_f32(r, B, 3)], (0,)),
    "cost_ang_vel_xy": (lambda r: [_f32(r, B, 3)], (0,)),
    "cost_base_height": (lambda r: [_f32(r, B, lo=0.1, hi=0.3), np.float32(0.18)], (0, None)),
    "reward_base_y_swing": (lambda r: [_f32(r, B), _f32(r, B, lo=0.5, hi=1.5),
                                       _f32(r, B, lo=0.0, hi=0.2), _f32(r, B, lo=0.0, hi=1.0),
                                       np.float32(0.01)], (0, 0, 0, 0, None)),
    "cost_energy": (lambda r: [_f32(r, B, 14), _f32(r, B, 14)], (0, 0)),
    "cost_joint_pos_limits": (lambda r: [_f32(r, B, 14, lo=-2, hi=2), _f32(r, 14, lo=-1.5, hi=-0.5),
                                         _f32(r, 14, lo=0.5, hi=1.5)], (0, None, None)),
    "cost_termination": (lambda r: [(r.rand(B) < 0.5).astype(np.float32)], (0,)),
    "cost_joint_deviation_hip": (lambda r: [_f32(r, B, 14), _f32(r, B, 7, lo=-0.3, hi=0.3),
                                            np.array([0, 1, 9, 10]), _f32(r, 14)],
                                 (0, 0, None, None)),
    "cost_joint_deviation_knee": (lambda r: [_f32(r, B, 14), np.array([3, 12]), _f32(r, 14)],
                                  (0, None, None)),
    "cost_pose": (lambda r: [_f32(r, B, 14), _f32(r, 14), _f32(r, 14, lo=0.0, hi=2.0)],
                  (0, None, None)),
    "cost_feet_slip": (lambda r: [(r.rand(B, 2) < 0.5).astype(np.float32), _f32(r, B, 3)], (0, 0)),
    "cost_feet_clearance": (lambda r: [_f32(r, B, 2, 3), _f32(r, B, 2, 3, lo=0.0, hi=0.1),
                                       np.float32(0.04)], (0, 0, None)),
    "cost_feet_height": (lambda r: [_f32(r, B, 2, lo=0.0, hi=0.1),
                                    (r.rand(B, 2) < 0.5).astype(np.float32), np.float32(0.04)],
                         (0, 0, None)),
    "reward_feet_air_time": (lambda r: [_f32(r, B, 2, lo=0.0, hi=0.8),
                                        (r.rand(B, 2) < 0.5).astype(np.float32),
                                        _f32(r, B, 7, lo=-0.02, hi=0.02)], (0, 0, 0)),
    "reward_feet_phase": (lambda r: [_f32(r, B, 2, 3, lo=0.0, hi=0.1), _f32(r, B, lo=0.0, hi=0.1)],
                          (0, 0)),
}


@pytest.mark.parametrize("name", sorted(REWARD_CASES))
def test_reward_term_matches_jax(name):
    make, in_axes = REWARD_CASES[name]
    args = make(np.random.RandomState(sorted(REWARD_CASES).index(name)))
    if name != "cost_termination":
        args[0] = args[0].copy()
        args[0][0] = np.nan
    want = np.asarray(jax.vmap(getattr(jrw, name), in_axes=in_axes)(
        *[jnp.asarray(a) if ax == 0 or isinstance(a, np.ndarray) else a
          for a, ax in zip(args, in_axes)]))
    got = getattr(rw, name)(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else float(a)
                              for a in args]).numpy()
    assert got.shape == want.shape == (B,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if name != "cost_termination":
        assert got[0] == 0.0 and np.isfinite(got).all()  # NaN-guarded


def test_env_accessors_match_jax(root):
    """The setters write what JAX's .at[].set writes (the input left as it
    was); get_global_linvel and get_feet_pos read the same sensor slots."""
    env, jenv = Joystick("flat_terrain", device="cpu"), JaxJoystick("flat_terrain")
    m = env.model
    rng = np.random.RandomState(11)
    qpos, qvel = _f32(rng, B, m.nq), _f32(rng, B, m.nv)
    new = {"set_floating_base_qpos": (_f32(rng, B, 7), qpos),
           "set_floating_base_qvel": (_f32(rng, B, 6), qvel),
           "set_actuator_joints_qpos": (_f32(rng, B, m.nu), qpos),
           "set_actuator_joints_qvel": (_f32(rng, B, m.nu), qvel)}
    for name, (v, x) in new.items():
        before = torch.from_numpy(x.copy())
        got = getattr(env, name)(torch.from_numpy(v), before)
        want = jax.vmap(getattr(jenv, name))(jnp.asarray(v), jnp.asarray(x))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
        assert torch.equal(before, torch.from_numpy(x)), name
    sd = _f32(rng, B, m.nsensordata)
    for name in ("get_global_linvel", "get_feet_pos"):
        got = getattr(env, name)(types.SimpleNamespace(sensordata=torch.from_numpy(sd)))
        want = np.stack([np.asarray(getattr(jenv, name)(
            types.SimpleNamespace(sensordata=jnp.asarray(row)))) for row in sd])
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        assert got.shape == ((B, 3) if name == "get_global_linvel" else (B, 2, 3)), name


def test_one_liners_match_jax(root):
    """wrap_for_training builds the TrainEnv JAX's builds; Names.id2name
    names each id of each kind as JAX's does; Data.replace_qpos replaces
    qpos alone."""
    env, jenv = Joystick("flat_terrain", device="cpu"), JaxJoystick("flat_terrain")
    te = wrapper.wrap_for_training(env, num_envs=4, episode_length=100, action_repeat=2)
    jte = jwrapper.wrap_for_training(jenv, num_envs=4, episode_length=100, action_repeat=2)
    assert isinstance(te, wrapper.TrainEnv) and te.env is env
    for k in ("num_envs", "episode_length", "action_repeat"):
        assert getattr(te, k) == getattr(jte, k), k

    xml = constants.task_to_xml("flat_terrain")
    jm = jax_compile_mjcf(xml)
    names, jnames = compile_mjcf(xml).names, jm.names
    for kind in ("body", "joint", "geom", "site", "actuator", "sensor"):
        n = len(jnames.list(kind))
        assert n > 0 and [names.id2name(kind, i) for i in range(n)] == [
            jnames.id2name(kind, i) for i in range(n)], kind

    jd = jax_fwd.make_data(jm)
    q = _f32(np.random.RandomState(12), jm.nq)
    want = numpy_tree(jd.replace_qpos(jnp.asarray(q)))
    data = interop.data_from_numpy(numpy_tree(jd))
    got = data.replace_qpos(torch.from_numpy(q))
    assert got.qvel is data.qvel and got.contact is data.contact
    got_leaves = tree_leaves(got)
    want_leaves = tree_leaves(interop.data_from_numpy(want))
    assert got_leaves.keys() == want_leaves.keys()
    for k, v in want_leaves.items():
        assert torch.equal(got_leaves[k], v), k
