"""The env path of the port against the JAX package: Joystick + TrainEnv
with domain randomization on the stand-in duck, 8 envs (flat scene; the
rough scene for the env logic and a port-only rollout).

The config overrides make a step deterministic apart from physics: noise
level 0, action and IMU max delay 1 (every delay index is 0), pushes off.
The JAX reset state and its DR model are carried across with interop, and
both packages take the same numpy actions.

- env logic: JAX's physics outputs are injected into the port's step, so
  obs, reward, done and info must match to 1e-5; on the rough scene the
  JAX side's physics is a cheap deterministic stand-in (compiling its XLA
  heightfield pipeline takes minutes), which the terrain-blind env logic
  consumes like any other physics output;
- the slice: 5 control steps, JAX on its CPU XLA pipeline, the port on the
  kernel's plain version (its CPU path); `done` must be identical, obs and
  reward are held to quantile bounds;
- the port's own draws (DR recipe, reset jitter) fall in the JAX ranges;
- importing the port (its env path, flat and rough, run; the trainer,
  checkpoint, runner, parallel, export, standing, env utils and deploy
  modules imported) never imports jax, flax, optax, orbax, ml_collections,
  tensorboard, mujoco or the JAX package;
- the env runs on the card unless given device="cpu"."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from open_duck_playground_tpu.envs import randomize as jax_randomize
from open_duck_playground_tpu.envs.joystick import Joystick as JaxJoystick
from open_duck_playground_tpu.envs.wrapper import TrainEnv as JaxTrainEnv
from open_duck_playground_tpu_torch import interop
from open_duck_playground_tpu_torch.envs import randomize
from open_duck_playground_tpu_torch.envs.joystick import Joystick
from open_duck_playground_tpu_torch.envs.wrapper import TrainEnv
from tests.torch_helpers import (
    env_logic_matches_jax,
    jax_model_fields,
    numpy_tree,
    standin_assets,
    standin_physics,
)

pytest_plugins = ["tests.torch_lock"]  # never beside tests/test_resume.py (see there)

N_ENVS, N_STEPS = 8, 5
OVERRIDES = {
    "noise_config.level": 0.0,
    "noise_config.action_max_delay": 1,
    "noise_config.imu_max_delay": 1,
    "push_config.enable": False,
}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    with standin_assets(str(tmp_path_factory.mktemp("standin"))) as r:
        yield r


def _jax_run(task):
    """JAX TrainEnv (DR on): reset + N_STEPS steps, every state as numpy."""
    env = JaxJoystick(task, config_overrides=OVERRIDES)
    if task != "flat_terrain":
        env._physics_init_fn, env._physics_step_fn = standin_physics(env)
    te = JaxTrainEnv(env, num_envs=N_ENVS, episode_length=1000,
                     randomization_fn=jax_randomize.domain_randomize,
                     randomization_rng=jax.random.PRNGKey(0))
    actions = np.random.RandomState(0).uniform(
        -1.0, 1.0, (N_STEPS, N_ENVS, env.action_size)).astype(np.float32)
    state = jax.jit(te.reset)(jax.random.PRNGKey(1))
    step = jax.jit(te.step)
    states = [numpy_tree(state)]
    for k in range(N_STEPS):
        state = step(state, actions[k])
        states.append(numpy_tree(state))
    return dict(task=task, states=states, actions=actions, model=jax_model_fields(te._model_v))


@pytest.fixture(scope="module")
def jax_run(root):
    return _jax_run("flat_terrain")


@pytest.fixture(scope="module")
def jax_run_rough(root):
    return _jax_run("rough_terrain_backlash")


def _port(jax_run):
    env = Joystick(jax_run["task"], config_overrides=OVERRIDES, device="cpu")
    model_v = interop.model_from_numpy(jax_run["model"])
    te = TrainEnv(env, num_envs=N_ENVS, episode_length=1000,
                  randomization_fn=lambda model, n, g: model_v)
    return env, te


def _env_logic_matches_jax(jax_run, monkeypatch):
    env, te = _port(jax_run)
    env_logic_matches_jax(env, te, jax_run["states"], jax_run["actions"], monkeypatch,
                          {"state": 101, "privileged_state": 212})


def test_env_logic_matches_jax_with_injected_physics(jax_run, monkeypatch):
    _env_logic_matches_jax(jax_run, monkeypatch)


def test_env_logic_matches_jax_with_injected_physics_rough(jax_run_rough, monkeypatch):
    """The same on the rough scene (nq=31, a heightfield floor): the env
    logic is terrain-blind."""
    _env_logic_matches_jax(jax_run_rough, monkeypatch)


def test_slice_matches_jax(jax_run):
    """5 control steps of the whole slice (the port's physics is the kernel's
    plain version; JAX's is its XLA pipeline, a different program with the
    same semantics). Tight median, loose physical tails: a foot-contact flag
    that flips between the two is an obs difference of 1. Measured on this
    draw (bounds in brackets), obs |err| after 5 steps: q50 2e-11 [1e-5],
    q90 6.2e-3 [1e-2], max 1.0 [2.0]; reward |err| max 1.9e-2 [0.05]; done
    identical at every step."""
    env, te = _port(jax_run)
    states, actions = jax_run["states"], jax_run["actions"]
    state = interop.state_from_numpy(states[0])
    for k in range(N_STEPS):
        state = te.step(state, torch.from_numpy(actions[k]))
        ref = states[k + 1]
        np.testing.assert_array_equal(state.done.numpy(), ref["done"], err_msg=f"step {k}")
    assert env.physics.launches == 0
    err = np.concatenate([np.abs(state.obs[key].numpy() - ref["obs"][key]).ravel()
                          for key in ("state", "privileged_state")])
    assert np.isfinite(err).all()
    assert np.quantile(err, 0.5) < 1e-5, np.quantile(err, 0.5)
    assert np.quantile(err, 0.9) < 1e-2, np.quantile(err, 0.9)
    assert err.max() < 2.0, err.max()
    r_err = np.abs(state.reward.numpy() - ref["reward"])
    assert r_err.max() < 0.05, r_err


def test_port_draws_fall_in_jax_ranges(root):
    """The DR recipe and the reset jitter: the port's draws and JAX's land
    in the same ranges (their streams differ: torch is not threefry)."""
    n = 64
    env = Joystick("flat_terrain", device="cpu")
    base = env.model
    mv = randomize.domain_randomize(base, n, torch.Generator().manual_seed(3))
    jenv = JaxJoystick("flat_terrain")
    jmv, _ = jax_randomize.domain_randomize(jenv.model, jax.random.split(jax.random.PRNGKey(3), n))
    act_dof = np.asarray([int(base.jnt_dofadr[j]) for j in range(base.njnt)
                          if bool(base.dof_hasfrictionloss[int(base.jnt_dofadr[j])])])
    for m, arr in ((mv, lambda f: getattr(mv, f).numpy()),
                   (jmv, lambda f: np.asarray(getattr(jmv, f)))):
        b = lambda f: getattr(base, f).numpy()  # noqa: E731
        gf = arr("geom_friction")[:, 0, 0]
        assert gf.min() >= 0.5 and gf.max() <= 1.0 and gf.std() > 0.05
        r = arr("dof_frictionloss")[:, act_dof] / b("dof_frictionloss")[act_dof]
        assert r.min() >= 0.9 - 1e-6 and r.max() <= 1.1 + 1e-6
        r = arr("dof_armature")[:, act_dof] / b("dof_armature")[act_dof]
        assert r.min() >= 1.0 - 1e-6 and r.max() <= 1.05 + 1e-6
        d = arr("body_ipos")[:, 1] - b("body_ipos")[1]
        assert np.abs(d).max() <= 0.05 + 1e-6 and np.abs(d).max() > 0.03
        dm = arr("body_mass")[:, 1]
        assert np.abs(dm).max() <= 0.1 + 1e-6  # massless body 1: only the offset
        massive = b("body_mass") > 0
        r = arr("body_mass")[:, massive] / b("body_mass")[massive]
        assert r.min() >= 0.9 - 1e-6 and r.max() <= 1.1 + 1e-6
        d = arr("qpos0")[:, 7:] - b("qpos0")[7:]
        assert np.abs(d).max() <= 0.03 + 1e-6
        kp = arr("actuator_gainprm")[:, :, 0]
        r = kp / b("actuator_gainprm")[:, 0]
        assert r.min() >= 0.9 - 1e-6 and r.max() <= 1.1 + 1e-6
        np.testing.assert_array_equal(arr("actuator_biasprm")[:, :, 1], -kp)

    # reset jitter: base xy +-5 cm, yaw in (-pi, pi), joints x U(0.5, 1.5),
    # base velocity +-0.05
    st = env.reset(n, torch.Generator().manual_seed(4))
    jst = jax.jit(jax.vmap(jenv.reset))(jax.random.split(jax.random.PRNGKey(4), n))
    home = np.asarray(base.keyframe("home").qpos, np.float32)
    act_q = env._actuator_qpos_addr.numpy()
    for qpos, qvel in ((st.data.qpos.numpy(), st.data.qvel.numpy()),
                       (np.asarray(jst.data.qpos), np.asarray(jst.data.qvel))):
        assert np.abs(qpos[:, :2] - home[:2]).max() <= 0.05 + 1e-6
        yaw = 2 * np.arctan2(qpos[:, 6], qpos[:, 3])
        assert np.abs(yaw).max() <= 3.14 + 1e-4 and yaw.std() > 1.0
        nz = np.abs(home[act_q]) > 1e-3
        r = qpos[:, act_q][:, nz] / home[act_q][nz]
        assert r.min() >= 0.5 - 1e-5 and r.max() <= 1.5 + 1e-5
        assert np.abs(qvel[:, :6]).max() <= 0.05 + 1e-6
        np.testing.assert_allclose(np.linalg.norm(qpos[:, 3:7], axis=1), 1.0, atol=1e-5)
    assert st.obs["state"].shape == (n, 101) and st.obs["privileged_state"].shape == (n, 212)


def test_port_never_imports_jax(root):
    code = (
        "import sys, torch\n"
        "import open_duck_playground_tpu_torch\n"
        "from open_duck_playground_tpu_torch import interop\n"
        "from open_duck_playground_tpu_torch.envs import randomize\n"
        "from open_duck_playground_tpu_torch.envs.joystick import Joystick\n"
        "from open_duck_playground_tpu_torch.envs import standing, utils\n"
        "from open_duck_playground_tpu_torch.deploy import (\n"
        "    custom_rewards_numpy, mujoco_infer, mujoco_infer_base, policy_loop, policy_runtime,\n"
        "    poly_reference_motion_numpy, rewards_numpy, sim2sim_check, sim_infer,\n"
        "    sim_infer_base)\n"
        "from open_duck_playground_tpu_torch.envs.wrapper import TrainEnv\n"
        "from open_duck_playground_tpu_torch.export.export import export_onnx\n"
        "from open_duck_playground_tpu_torch.train import checkpoint, ppo, runner\n"
        "import open_duck_playground_tpu_torch.parallel\n"
        "from open_duck_playground_tpu_torch.parallel import dist\n"
        "for task in ('flat_terrain', 'rough_terrain_backlash'):\n"
        "    te = TrainEnv(Joystick(task, device='cpu'), num_envs=2, episode_length=10,\n"
        "                  randomization_fn=randomize.domain_randomize)\n"
        "    st = te.step(te.reset(torch.Generator().manual_seed(0)), torch.zeros(2, 14))\n"
        "    assert st.obs['state'].shape == (2, 101)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'ml_collections', 'mujoco',\n"
        "                                    'optax', 'orbax', 'tensorboardX', 'tensorboard',\n"
        "                                    'open_duck_playground_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = dict(os.environ, OPEN_DUCK_ASSETS=root)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0 and "clean" in proc.stdout, proc.stderr[-2000:]


def test_nan_action_terminates_on_cpu(root):
    """NaN action probe on the port's CPU path: done -> 1 within 3 control
    steps (the delay buffer may serve an older clean action first)."""
    env = Joystick("flat_terrain", device="cpu")
    te = TrainEnv(env, num_envs=2, episode_length=1000)
    state = te.reset(torch.Generator().manual_seed(0))
    nan = torch.full((2, env.action_size), float("nan"))
    done = torch.zeros(2)
    for _ in range(3):
        state = te.step(state, nan)
        done = torch.maximum(done, state.done)
    assert bool((done == 1).all()), done


def test_env_defaults_to_the_card(root):
    """The env runs on the card unless given a CPU device: without CUDA, a
    call that names no device raises instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Joystick("flat_terrain")
    assert Joystick("flat_terrain", device="cpu").device == torch.device("cpu")


def test_rough_rollout_on_cpu(root):
    """The rough path end to end on the port's CPU path (the kernel's plain
    version): TrainEnv on rough_terrain_backlash, 4 envs, DR on, reset + 3
    random steps."""
    env = Joystick("rough_terrain_backlash", device="cpu")
    assert env.model.hfield_nrow == 256
    te = TrainEnv(env, num_envs=4, episode_length=1000,
                  randomization_fn=randomize.domain_randomize,
                  randomization_generator=torch.Generator().manual_seed(0))
    state = te.reset(torch.Generator().manual_seed(1))
    actions = torch.rand((3, 4, env.action_size), generator=torch.Generator().manual_seed(2)) * 2 - 1
    for a in actions:
        state = te.step(state, a)
    assert {k: tuple(v.shape) for k, v in state.obs.items()} == {
        "state": (4, 101), "privileged_state": (4, 212)}
    for v in (*state.obs.values(), state.reward, state.data.qpos, state.data.contact.dist):
        assert torch.isfinite(v).all()
    assert env.physics.launches == 0
