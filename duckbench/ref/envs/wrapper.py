"""Training env wrapper (mujoco_playground's ``wrap_for_brax_training``).

A frozen copy of the port's ``envs/wrapper.py`` (``TrainEnv``), for the
benchmark's plain reference, without the port's CUDA graphs and env
sharding:
- the batch of envs, optionally with a per-env randomized model
  (``randomize.domain_randomize``), stepped as one batch;
- episode bookkeeping (step count, ``truncation`` flag at episode_length);
- auto-reset to the episode's FIRST state on done (Brax semantics: envs
  restart from their cached initial state, not a fresh randomized reset).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from duckbench.ref.envs.types import State


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
            self._model_v = randomization_fn(env.model, num_envs, randomization_generator)

    @property
    def env(self):
        return self._env

    @property
    def model(self):
        """The (randomized, if DR is on) model the batch steps with."""
        return self._model_v if self._model_v is not None else self._env.model

    @property
    def action_size(self) -> int:
        return self._env.action_size

    @property
    def observation_size(self):
        return self._env.observation_size

    def reset(self, generator: Optional[torch.Generator] = None) -> State:
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
