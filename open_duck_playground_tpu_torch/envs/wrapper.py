"""Training env wrapper (mujoco_playground's ``wrap_for_brax_training``).

Counterpart of the JAX package's ``envs/wrapper.py``, in the same order:
- the batch of envs, optionally with a per-env randomized model
  (``randomize.domain_randomize``), stepped as one batch (no vmap); for an
  env with a shard (``env.shard``), the batch is that rank's rows of a
  global batch, randomized at the global size and cut to them;
- episode bookkeeping (step count, ``truncation`` flag at episode_length);
- auto-reset to the episode's FIRST state on done (Brax semantics: envs
  restart from their cached initial state, not a fresh randomized reset).

The JAX package jits ``TrainEnv.step``. Its counterpart is
``EnvStepProgram`` (a utils.graphs.Captured): the step over fixed buffers
(``step_into``), replayed as one CUDA graph on a CUDA device and run
eagerly on the CPU, at any world size (an env-sharded step draws at the
global shape and cuts its rows inside the graph; no collective runs in a
step), on either engine: the fused kernel, or the general pipeline's
``forward.step_n`` that XLA compiles into the JAX package's jitted step
off the TPU.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from open_duck_playground_tpu_torch.envs import randomize
from open_duck_playground_tpu_torch.envs.types import State
from open_duck_playground_tpu_torch.utils import profiling
from open_duck_playground_tpu_torch.utils.graphs import Captured, copy_into


class TrainEnv:
    def __init__(
        self,
        env,
        num_envs: int,
        episode_length: int,
        action_repeat: int = 1,
        randomization_fn: Optional[Callable] = None,
        randomization_generator: Optional[torch.Generator] = None,
    ):
        self._env = env
        self.num_envs = num_envs
        self.episode_length = episode_length
        self.action_repeat = action_repeat
        self._model_v = None
        if randomization_fn is not None:
            shard = getattr(env, "shard", None)
            world = 1 if shard is None else shard.world
            self._model_v = randomization_fn(env.model, world * num_envs, randomization_generator)
            if world > 1:
                self._model_v = randomize.take_rows(self._model_v, shard.rows(world * num_envs))

    @property
    def env(self):
        return self._env

    @property
    def model(self):
        """The (randomized, if DR is on) model the batch steps with."""
        return self._model_v if self._model_v is not None else self._env.model

    @property
    def generators(self) -> list:
        """The generators a step draws from (a graph of it registers them)."""
        return [self._env.generator]

    @property
    def kernels(self) -> list:
        """The hand-written kernels a step launches, by their launch counters:
        the fused physics, or none on the general pipeline."""
        return [self._env.physics] if getattr(self._env, "physics_mode", None) == "kernel" else []

    @property
    def action_size(self) -> int:
        return self._env.action_size

    @property
    def observation_size(self):
        return self._env.observation_size

    def reset(self, generator: Optional[torch.Generator] = None) -> State:
        """The batch's first state (the tracer's span ``env.reset``)."""
        with profiling.span("env.reset", getattr(self._env, "device", None)):
            return self._reset(generator)

    def _reset(self, generator: Optional[torch.Generator]) -> State:
        state = self._env.reset_with_model(self.model, self.num_envs, generator)
        info = dict(state.info)
        dev = state.reward.device
        info["steps"] = torch.zeros(self.num_envs, device=dev)
        info["truncation"] = torch.zeros(self.num_envs, device=dev)
        # auto-reset caches (Brax AutoResetWrapper semantics)
        info["first_data"] = state.data
        info["first_obs"] = state.obs
        return state.replace(info=info)

    def step(self, state: State, action: torch.Tensor) -> State:
        """One step of every env (the tracer's span ``env.step``)."""
        with profiling.span("env.step", action.device):
            return self._step(state, action)

    def _step(self, state: State, action: torch.Tensor) -> State:
        # --- auto-reset: restart finished envs from their first state ---
        done_prev = state.done
        data = _where_done(done_prev, state.info["first_data"], state.data)
        obs = _where_done(done_prev, state.info["first_obs"], state.obs)
        info = dict(state.info)
        info["steps"] = torch.where(done_prev > 0, torch.zeros_like(info["steps"]),
                                    info["steps"])
        state = state.replace(data=data, obs=obs, info=info)

        # --- episode wrapper: action_repeat + truncation bookkeeping ---
        first_data, first_obs = state.info["first_data"], state.info["first_obs"]
        steps_prev = state.info["steps"]
        inner = state.replace(
            info={k: v for k, v in state.info.items()
                  if k not in ("steps", "truncation", "first_data", "first_obs")}
        )
        for _ in range(self.action_repeat):
            inner = self._env.step_with_model(self.model, inner, action)

        steps = steps_prev + self.action_repeat
        at_limit = steps >= self.episode_length
        env_done = inner.done
        done = torch.where(at_limit, torch.ones_like(env_done), env_done)
        truncation = torch.where(at_limit, 1.0 - env_done, torch.zeros_like(env_done))

        info = dict(inner.info)
        info["steps"] = steps
        info["truncation"] = truncation
        info["first_data"] = first_data
        info["first_obs"] = first_obs
        return inner.replace(done=done, info=info)


def _where_done(done: torch.Tensor, first, cur):
    """Per env: `first` where done > 0, else `cur`; over tensors, dicts and
    dataclasses of tensors. A field one of the two does not hold (None: the
    fused kernel fills fewer of Data's fields than the pipeline) stays None."""
    if cur is None or first is None:
        return None
    if isinstance(cur, torch.Tensor):
        mask = (done > 0).reshape((done.shape[0],) + (1,) * (cur.dim() - 1))
        return torch.where(mask, first, cur)
    if isinstance(cur, dict):
        return {k: _where_done(done, first[k], v) for k, v in cur.items()}
    return dataclasses.replace(cur, **{
        f.name: _where_done(done, getattr(first, f.name), getattr(cur, f.name))
        for f in dataclasses.fields(cur)
    })


def wrap_for_training(env, num_envs: int, episode_length: int, action_repeat: int = 1,
                      randomization_fn: Optional[Callable] = None,
                      randomization_generator: Optional[torch.Generator] = None) -> TrainEnv:
    return TrainEnv(env, num_envs=num_envs, episode_length=episode_length,
                    action_repeat=action_repeat, randomization_fn=randomization_fn,
                    randomization_generator=randomization_generator)


# ---------------------------------------------------------------------------
# the step over fixed buffers, and its program
# ---------------------------------------------------------------------------


@torch.no_grad()
def step_into(train_env: TrainEnv, buffers: State, action: torch.Tensor) -> State:
    """`train_env.step(buffers, action)` written into `buffers` in place;
    returns `buffers`. The buffers must not share storage (`clone_tree` of
    a state: reset hands the first state to the autoreset cache itself, and
    a step writing into it would make the next autoreset restore the
    stepped state)."""
    copy_into(buffers, train_env.step(buffers, action))
    return buffers


class EnvStepProgram(Captured):
    """`TrainEnv.step` as a device program (utils.graphs.Captured), called
    as `train_env.step` is: the JAX package's jitted env step, one CUDA
    graph replay per step on the card. Its body is `step_into` over static
    copies of the state and the action, made at the first call (or at
    `capture`); the state returned is the static buffers, which the next
    call overwrites (clone it to keep it). Every draw comes from the env's
    generator, registered with the graph."""

    def __init__(self, train_env: TrainEnv, log=None):
        super().__init__(lambda s: step_into(train_env, s["state"], s["action"]), (),
                         train_env.generators, train_env.kernels, train_env.env.device,
                         "[env] TrainEnv.step", "env.step", "one replay per env step", log)

    def capture(self, state: State, action: torch.Tensor) -> None:
        """Capture from `state` and `action` (their values are kept for the
        next call), without stepping."""
        self.load({"state": state, "action": action})
        self.graph.capture()

    def __call__(self, state: State, action: torch.Tensor) -> State:
        return self.run({"state": state, "action": action})
