"""Shared helpers of the tests that hold the PyTorch port against the JAX
package (tests/test_torch_*.py): the stand-in asset tree for both packages,
numpy carry-across of the JAX package's models and states, a cheap
deterministic stand-in for either package's physics, and the env-logic
comparison with JAX's physics outputs injected into the port's step."""

from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np

from tests.duck_standin import write_standin


@contextlib.contextmanager
def standin_assets(root: str):
    """Write the stand-in duck under `root` and point both packages at it:
    the JAX package through its candidate roots, the port through
    $OPEN_DUCK_ASSETS (read at each call)."""
    import pytest

    from open_duck_playground_tpu.models.open_duck_mini_v2 import constants as jc

    write_standin(root)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OPEN_DUCK_ASSETS", root)
        mp.setattr(jc, "_CANDIDATE_ROOTS", [root] + list(jc._CANDIDATE_ROOTS))
        yield root


def scene(root: str, name: str) -> str:
    return os.path.join(root, "xmls", name)


def jax_model_fields(m) -> dict:
    """A JAX-package Model as the dict interop.model_from_numpy takes."""
    out = {}
    for f in dataclasses.fields(m):
        v = getattr(m, f.name)
        if f.name == "opt":
            v = {g.name: getattr(v, g.name) for g in dataclasses.fields(v)}
            v["gravity"] = np.asarray(v["gravity"])
        elif f.name == "names":
            v = {k: dict(d) for k, d in v._d.items()}
        elif f.name == "keyframes":
            v = {k: (q.np, c.np) for k, (q, c) in v._frames.items()}
        elif hasattr(v, "np"):
            v = v.np
        elif v is not None and hasattr(v, "shape"):
            v = np.asarray(v)
        out[f.name] = v
    return out


def numpy_tree(x):
    """Nested dicts of numpy arrays from a JAX pytree of dataclasses/dicts."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: numpy_tree(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: numpy_tree(v) for k, v in x.items()}
    return np.asarray(x)


def random_states(kf, nq, nv, nu, B, seed=0):
    """tests/test_lane.py's random states, as numpy."""
    rng = np.random.RandomState(seed)
    qpos = np.tile(np.asarray(kf.qpos, np.float32), (B, 1))
    qpos[:, :2] += rng.uniform(-0.02, 0.02, (B, 2)).astype(np.float32)
    qpos[:, 2] += rng.uniform(-0.005, 0.02, B).astype(np.float32)
    qpos[:, 7:] += rng.uniform(-0.1, 0.1, (B, nq - 7)).astype(np.float32)
    qvel = rng.uniform(-0.2, 0.2, (B, nv)).astype(np.float32)
    ctrl = (np.asarray(kf.ctrl, np.float32)
            + rng.uniform(-0.2, 0.2, (B, nu)).astype(np.float32))
    return qpos, qvel, ctrl


def standin_physics(env):
    """A cheap, deterministic stand-in for the JAX env's physics (init and
    step, one env): joints drift, sensors, sites, forces and contact
    distances move with time and ctrl, the upvector stays near +z."""
    import jax.numpy as jnp

    from open_duck_playground_tpu.ops import forward as jax_fwd

    m = env.model
    up = int(m.sensor_adr[m.sensor("upvector")])

    def fill(d, ctrl, t):
        ph = 7.0 * t + jnp.sum(ctrl)
        sd = 0.3 * jnp.sin(ph + jnp.arange(m.nsensordata))
        sd = sd.at[up:up + 3].set(jnp.stack([0.1 * jnp.sin(ph), 0.1 * jnp.cos(ph), 0.99]))
        return d.replace(
            ctrl=ctrl, time=t, actuator_force=0.5 * jnp.tanh(ctrl), sensordata=sd,
            site_xpos=0.05 * jnp.sin(ph + jnp.arange(3 * m.nsite)).reshape(m.nsite, 3),
            site_xmat=jnp.tile(jnp.eye(3), (m.nsite, 1, 1)),
            contact=d.contact.replace(dist=0.01 * jnp.sin(3.0 * ph + jnp.arange(m.ncon))))

    def init(model, qpos, qvel, ctrl):
        return fill(jax_fwd.make_data(m).replace(qpos=qpos, qvel=qvel), ctrl, jnp.float32(0.0))

    def step(model, d, ctrl):
        t = d.time + env.dt
        qpos = d.qpos.at[7:].add(0.01 * jnp.sin(7.0 * t + jnp.arange(m.nq - 7)))
        qvel = 0.1 * jnp.cos(7.0 * t + jnp.arange(m.nv))
        return fill(d.replace(qpos=qpos, qvel=qvel, qacc_warmstart=qvel), ctrl, t)

    return init, step


def torch_standin_physics(env):
    """standin_physics for the port's batched env: the same formulas, row
    by row (each row's outputs depend on that row's inputs alone), as
    (physics_init, physics_step) of the env's signatures."""
    import torch

    from open_duck_playground_tpu_torch.ops.types import Contact, Data

    m = env.model
    up = int(m.sensor_adr[m.sensor("upvector")])

    def fill(qpos, qvel, warm, ctrl, t):
        B = qpos.shape[0]
        ph = (7.0 * t + ctrl.sum(1))[:, None]
        sd = 0.3 * torch.sin(ph + torch.arange(m.nsensordata))
        sd[:, up:up + 3] = torch.cat([0.1 * torch.sin(ph), 0.1 * torch.cos(ph),
                                      torch.full_like(ph, 0.99)], 1)
        return Data(
            qpos=qpos, qvel=qvel, ctrl=ctrl, qacc_warmstart=warm, time=t,
            site_xpos=(0.05 * torch.sin(ph + torch.arange(3 * m.nsite))).reshape(B, m.nsite, 3),
            site_xmat=torch.eye(3).expand(B, m.nsite, 3, 3).clone(),
            actuator_force=0.5 * torch.tanh(ctrl), sensordata=sd,
            contact=Contact(dist=0.01 * torch.sin(3.0 * ph + torch.arange(m.ncon))))

    def init(model, qpos, qvel, ctrl):
        return fill(qpos, qvel, torch.zeros_like(qvel), ctrl, torch.zeros(qpos.shape[0]))

    def step(model, d, ctrl):
        t = d.time + env.dt
        qpos = d.qpos.clone()
        qpos[:, 7:] += 0.01 * torch.sin(7.0 * t[:, None] + torch.arange(m.nq - 7))
        qvel = 0.1 * torch.cos(7.0 * t[:, None] + torch.arange(m.nv))
        return fill(qpos, qvel, qvel, ctrl, t)

    return init, step


def _info_keys(info):
    return [k for k in info if k not in ("rng", "first_data", "first_obs")]


def env_logic_matches_jax(env, te, states, actions, monkeypatch, sizes, skip=()):
    """Step the port's TrainEnv `te` (env `env`) from each JAX state of
    `states` with JAX's action and JAX's next physics outputs injected:
    obs, reward, info (but the keys in `skip`) and metrics must match JAX's
    next state to 1e-5, done exactly, and the obs have the per-env `sizes`
    ({"state": n, "privileged_state": n}). Returns the port's last state."""
    import torch

    from open_duck_playground_tpu_torch import interop

    for k in range(len(states) - 1):
        nxt = states[k + 1]
        injected = interop.data_from_numpy(nxt["data"])
        monkeypatch.setattr(env, "physics_step", lambda model, data, ctrl: injected)
        out = te.step(interop.state_from_numpy(states[k]), torch.from_numpy(actions[k]))
        for key in ("state", "privileged_state"):
            np.testing.assert_allclose(out.obs[key].numpy(), nxt["obs"][key], atol=1e-5,
                                       err_msg=f"step {k} obs {key}")
            assert out.obs[key].shape == (actions.shape[1], sizes[key])
        np.testing.assert_allclose(out.reward.numpy(), nxt["reward"], atol=1e-5)
        np.testing.assert_array_equal(out.done.numpy(), nxt["done"])
        for key in _info_keys(nxt["info"]):
            if key in skip:
                continue
            np.testing.assert_allclose(
                out.info[key].numpy().astype(np.float64),
                nxt["info"][key].astype(np.float64), atol=1e-5, err_msg=f"step {k} info {key}")
        assert set(out.metrics) == set(nxt["metrics"])
        for key, v in nxt["metrics"].items():
            np.testing.assert_allclose(out.metrics[key].numpy(), v, atol=1e-5, err_msg=key)
    return out


class TorchToyEnv:
    """tests/test_resume.py's ToyEnv, batched for the port: a point mass the
    action nudges; reward -|pos|; done when |pos| escapes 5. With `noise` > 0
    each step adds U(-noise, noise) from the env's own generator (so resume
    must restore that stream too); with noise 0 a step is the JAX ToyEnv's,
    which computes its obs from info["t"] + 1 and keeps the old info.
    Runs on the CPU unless given another device. With a `shard` (set by
    ppo.train, as on the duck), its draws are made at the global shape and
    cut to the shard's rows."""

    action_size = 3
    observation_size = {"state": (6,), "privileged_state": (8,)}
    model = None
    shard = None

    def __init__(self, device="cpu", seed=0, noise=0.0):
        import torch

        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.noise = noise

    def reset_with_model(self, model, num_envs, generator=None):
        import torch

        from open_duck_playground_tpu_torch.envs.types import State
        from open_duck_playground_tpu_torch.parallel.dist import draw

        g = generator if generator is not None else self.generator
        pos = draw(self.shard, torch.rand, (num_envs, 3), generator=g, device=self.device) - 0.5
        info = {"t": torch.zeros(num_envs, device=self.device)}
        zeros = torch.zeros(num_envs, device=self.device)
        return State(data=pos, obs=self._obs(pos, info), reward=zeros, done=zeros,
                     metrics={"dist": torch.linalg.norm(pos, dim=1)}, info=info)

    def step_with_model(self, model, state, action):
        import torch

        from open_duck_playground_tpu_torch.parallel.dist import draw

        pos = state.data * 0.95 + 0.1 * torch.tanh(action)
        if self.noise:
            u = draw(self.shard, torch.rand, pos.shape, generator=self.generator,
                     device=self.device)
            pos = pos + self.noise * (2.0 * u - 1.0)
        info = dict(state.info)
        info["t"] = info["t"] + 1.0
        dist = torch.linalg.norm(pos, dim=1)
        return state.replace(data=pos, obs=self._obs(pos, info), reward=-dist,
                             done=(dist > 5.0).to(torch.float32), metrics={"dist": dist})

    def _obs(self, pos, info):
        import torch

        s = torch.cat([pos, pos * 0.5], dim=1)
        p = torch.cat([s, info["t"][:, None], torch.ones_like(info["t"])[:, None]], dim=1)
        return {"state": s, "privileged_state": p}
