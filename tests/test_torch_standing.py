"""The standing task of the port against the JAX package, on the stand-in
duck's flat_terrain_backlash scene (the recipe's scene).

- env logic: TrainEnv(Standing) with DR on, 8 envs, 5 steps; the config
  overrides make a step deterministic apart from physics (noise level 0,
  action and IMU max delay 1, pushes off); the JAX side's physics is the
  cheap stand-in of tests/torch_helpers.py (no XLA pipeline compiles), and
  JAX's states and physics outputs are injected into the port's step: obs,
  reward, info and metrics to 1e-5, done identical. One more step from
  info["step"] = 501: every env takes a new command and step 0;
- the port's draws (sample_command at 4096 envs, the reset jitter) by their
  distributions (the streams differ: torch is not threefry);
- shard invariance: rows 0-1 and 2-3 of a 2-rank shard equal the 4-row
  run bit for bit (parallel.dist.draw needs no process group);
- the two rewards Standing adds, and LowPassActionFilter, against JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_duck_playground_tpu.envs import randomize as jax_randomize
from open_duck_playground_tpu.envs import rewards as jrw
from open_duck_playground_tpu.envs.standing import Standing as JaxStanding
from open_duck_playground_tpu.envs.utils import LowPassActionFilter as JaxLowPassActionFilter
from open_duck_playground_tpu.envs.wrapper import TrainEnv as JaxTrainEnv
from open_duck_playground_tpu_torch import interop
from open_duck_playground_tpu_torch.envs import randomize
from open_duck_playground_tpu_torch.envs import rewards as rw
from open_duck_playground_tpu_torch.envs.standing import Standing
from open_duck_playground_tpu_torch.envs.utils import LowPassActionFilter
from open_duck_playground_tpu_torch.envs.wrapper import TrainEnv
from open_duck_playground_tpu_torch.parallel.dist import EnvShard
from tests.torch_helpers import (
    env_logic_matches_jax,
    jax_model_fields,
    numpy_tree,
    standin_assets,
    standin_physics,
    torch_standin_physics,
)

pytest_plugins = ["tests.torch_lock"]  # never beside tests/test_resume.py (see there)

TASK = "flat_terrain_backlash"
N_ENVS, N_STEPS = 8, 5
OVERRIDES = {
    "noise_config.level": 0.0,
    "noise_config.action_max_delay": 1,
    "noise_config.imu_max_delay": 1,
    "push_config.enable": False,
}
SIZES = {"state": 85, "privileged_state": 153}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    with standin_assets(str(tmp_path_factory.mktemp("standin"))) as r:
        yield r


@pytest.fixture(scope="module")
def jax_run(root):
    """JAX TrainEnv(Standing) with DR on and the stand-in physics: reset, 5
    steps, then one step from the last state with info["step"] = 501; every
    state as numpy."""
    env = JaxStanding(TASK, config_overrides=OVERRIDES)
    env._physics_init_fn, env._physics_step_fn = standin_physics(env)
    te = JaxTrainEnv(env, num_envs=N_ENVS, episode_length=1000,
                     randomization_fn=jax_randomize.domain_randomize,
                     randomization_rng=jax.random.PRNGKey(0))
    actions = np.random.RandomState(0).uniform(
        -1.0, 1.0, (N_STEPS + 1, N_ENVS, env.action_size)).astype(np.float32)
    state = jax.jit(te.reset)(jax.random.PRNGKey(1))
    step = jax.jit(te.step)
    states = [numpy_tree(state)]
    for k in range(N_STEPS):
        state = step(state, actions[k])
        states.append(numpy_tree(state))
    late = state.replace(info={**state.info, "step": jnp.full((N_ENVS,), 501, jnp.int32)})
    return dict(states=states, actions=actions, late=[numpy_tree(late),
                                                      numpy_tree(step(late, actions[N_STEPS]))],
                model=jax_model_fields(te._model_v), obs_size=dict(env.observation_size))


def _port(jax_run):
    env = Standing(TASK, config_overrides=OVERRIDES, device="cpu")
    model_v = interop.model_from_numpy(jax_run["model"])
    te = TrainEnv(env, num_envs=N_ENVS, episode_length=1000,
                  randomization_fn=lambda model, n, g: model_v)
    return env, te


def test_standing_env_logic_matches_jax_with_injected_physics(jax_run, monkeypatch):
    assert jax_run["obs_size"] == {k: (v,) for k, v in SIZES.items()}
    env, te = _port(jax_run)
    assert env.observation_size == {k: (v,) for k, v in SIZES.items()}
    env_logic_matches_jax(env, te, jax_run["states"], jax_run["actions"][:N_STEPS],
                          monkeypatch, SIZES)


def test_standing_resamples_the_command_after_step_500(jax_run, monkeypatch):
    """From info["step"] = 501 every env draws a new command and restarts
    its step count at 0; everything else still matches JAX (the commands
    come from the two packages' own streams)."""
    env, te = _port(jax_run)
    before, after = jax_run["late"]
    out = env_logic_matches_jax(env, te, [before, after], jax_run["actions"][N_STEPS:],
                                monkeypatch, SIZES, skip=("command",))
    np.testing.assert_array_equal(out.info["step"].numpy(), 0)
    np.testing.assert_array_equal(after["info"]["step"], 0)
    old, new = before["info"]["command"], out.info["command"].numpy()
    zero_both = (old == 0).all(1) & (new == 0).all(1)
    assert ((old != new).any(1) | zero_both).all(), (old, new)
    assert (new[:, :3] == 0).all()


def test_standing_draws_fall_in_jax_ranges(root):
    """sample_command at 4096 envs: locomotion always 0, the zero-command
    share within 5 sigma of 0.1, each head column inside its range (and
    spread over it); the reset jitter inside JAX's ranges, on both sides."""
    env = Standing(TASK, device="cpu")
    cfg = env._config
    n = 4096
    cmd = env.sample_command(n, torch.Generator().manual_seed(5)).numpy()
    assert cmd.shape == (n, 7) and (cmd[:, :3] == 0).all()
    zero = (cmd == 0).all(1)
    sigma = np.sqrt(n * 0.1 * 0.9)
    assert abs(zero.sum() - 0.1 * n) < 5 * sigma, zero.sum()
    for col, r in zip(range(3, 7), (cfg.neck_pitch_range, cfg.head_pitch_range,
                                    cfg.head_yaw_range, cfg.head_roll_range)):
        v = cmd[~zero, col]
        lo, hi = r[0] * cfg.head_range_factor, r[1] * cfg.head_range_factor
        assert v.min() >= lo and v.max() <= hi, (col, v.min(), v.max())
        assert v.max() - v.min() > 0.9 * (hi - lo)

    # reset jitter: base xy +-5 cm, yaw in (-3.14, 3.14), joints x U(0.5,
    # 1.5), base velocity +-0.05 (both packages on the stand-in physics)
    m = 64
    env.physics_init, _ = torch_standin_physics(env)
    st = env.reset(m, torch.Generator().manual_seed(4))
    jenv = JaxStanding(TASK)
    jenv._physics_init_fn, jenv._physics_step_fn = standin_physics(jenv)
    jst = jax.jit(jax.vmap(jenv.reset))(jax.random.split(jax.random.PRNGKey(4), m))
    home = np.asarray(env.model.keyframe("home").qpos, np.float32)
    act_q = env._actuator_qpos_addr.numpy()
    for qpos, qvel, c in ((st.data.qpos.numpy(), st.data.qvel.numpy(), st.info["command"].numpy()),
                          (np.asarray(jst.data.qpos), np.asarray(jst.data.qvel),
                           np.asarray(jst.info["command"]))):
        assert np.abs(qpos[:, :2] - home[:2]).max() <= 0.05 + 1e-6
        yaw = 2 * np.arctan2(qpos[:, 6], qpos[:, 3])
        assert np.abs(yaw).max() <= 3.14 + 1e-4 and yaw.std() > 1.0
        nz = np.abs(home[act_q]) > 1e-3
        r = qpos[:, act_q][:, nz] / home[act_q][nz]
        assert r.min() >= 0.5 - 1e-5 and r.max() <= 1.5 + 1e-5
        assert np.abs(qvel[:, :6]).max() <= 0.05 + 1e-6
        np.testing.assert_allclose(np.linalg.norm(qpos[:, 3:7], axis=1), 1.0, atol=1e-5)
        assert (c[:, :3] == 0).all()
    assert {k: tuple(v.shape) for k, v in st.obs.items()} == {
        "state": (m, 85), "privileged_state": (m, 153)}


def test_standing_shards_equal_the_whole_batch(root):
    """Reset and 2 steps (DR, noise, delays and pushes on) at 2 + 2 rows,
    as ranks 0 and 1 of a world of 2, equal the 4-row run row for row, bit
    for bit."""
    B = 4
    actions = torch.rand((2, B, 14), generator=torch.Generator().manual_seed(6)) * 2 - 1

    def run(shard):
        env = Standing(TASK, device="cpu", seed=3)
        env.shard = shard
        env.physics_init, env.physics_step = torch_standin_physics(env)
        rows = slice(None) if shard is None else shard.rows(B)
        te = TrainEnv(env, num_envs=B if shard is None else shard.local(B), episode_length=1000,
                      randomization_fn=randomize.domain_randomize,
                      randomization_generator=torch.Generator().manual_seed(7))
        states = [te.reset(torch.Generator().manual_seed(8))]
        for a in actions:
            states.append(te.step(states[-1], a[rows]))
        return states

    whole = run(None)
    parts = [run(EnvShard(r, 2)) for r in range(2)]
    for k in range(3):
        flat = {}
        for name, tree in (("obs", whole[k].obs), ("info", whole[k].info),
                           ("metrics", whole[k].metrics)):
            for key, v in tree.items():
                if isinstance(v, torch.Tensor):
                    flat[f"{name}/{key}"] = v
        flat["reward"], flat["done"] = whole[k].reward, whole[k].done
        flat["qpos"], flat["qvel"] = whole[k].data.qpos, whole[k].data.qvel
        for key, v in flat.items():
            got = []
            for p in parts:
                name, _, sub = key.partition("/")
                tree = {"obs": p[k].obs, "info": p[k].info, "metrics": p[k].metrics}.get(name)
                got.append(tree[sub] if tree is not None else
                           {"reward": p[k].reward, "done": p[k].done,
                            "qpos": p[k].data.qpos, "qvel": p[k].data.qvel}[key])
            assert torch.equal(torch.cat(got), v), (k, key)


def test_standing_rewards_match_jax():
    """cost_orientation and cost_head_pos, batched, against JAX's vmap, with
    commands on both sides of cost_head_pos's 0.01 locomotion gate."""
    rng = np.random.RandomState(9)
    B = 32
    upvec = rng.randn(B, 3).astype(np.float32)
    qpos = rng.randn(B, 14).astype(np.float32)
    qvel = rng.randn(B, 14).astype(np.float32)
    cmd = rng.randn(B, 7).astype(np.float32)
    cmd[: B // 2, :3] *= 1e-3  # |cmd[:3]| < 0.01: gated off
    cmd[0, :3] = 0.0
    a = rw.cost_orientation(torch.from_numpy(upvec)).numpy()
    b = np.asarray(jax.vmap(jrw.cost_orientation)(jnp.asarray(upvec)))
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    a = rw.cost_head_pos(torch.from_numpy(qpos), torch.from_numpy(qvel),
                         torch.from_numpy(cmd)).numpy()
    b = np.asarray(jax.vmap(jrw.cost_head_pos)(jnp.asarray(qpos), jnp.asarray(qvel),
                                                jnp.asarray(cmd)))
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    assert (a[: B // 2] == 0).all() and (a[B // 2:] > 0).all()


def test_low_pass_action_filter_matches_jax():
    rng = np.random.RandomState(10)
    f, jf = LowPassActionFilter(50.0, 30.0), JaxLowPassActionFilter(50.0, 30.0)
    assert f.alpha == jf.alpha
    for _ in range(20):
        a = rng.uniform(-1, 1, 14).astype(np.float32)
        f.push(torch.from_numpy(a))
        jf.push(jnp.asarray(a))
        np.testing.assert_allclose(f.get_filtered_action().numpy(),
                                   np.asarray(jf.get_filtered_action()), atol=1e-6)
