"""The system under test, built from a configuration and a run's seeds.

The port's own entry points, as its trainer runs them:

- ``TrainProgram``: the env batch (``TrainEnv`` over the task's env, domain
  randomized), the learner state, the rollout and the SGD step that
  ``ppo.make_rollout`` / ``ppo.make_sgd_step`` pick (CUDA graphs on the
  card, captured at their first call), stepped as ``ppo.training_step``:
  train()'s epoch loop without its evals, saves and callbacks.
- ``EvalProgram``: the eval env batch (no randomization) and the eval step
  ``ppo.make_eval_step`` picks, run as ``ppo.run_eval`` runs an episode:
  the env's eager reset, then episode_length replays of the step.

The weights (and the eval loop's normalizer) are the benchmark's, drawn by
``traffic.py`` and copied into the port's tensors. The port is imported
here and in nothing the reference uses.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from duckbench import traffic

HYPER = ("num_envs", "unroll_length", "num_minibatches", "batch_size", "num_updates_per_batch",
         "action_repeat", "learning_rate", "entropy_cost", "discounting", "gae_lambda",
         "clipping_epsilon", "normalize_advantage", "reward_scaling", "normalize_observations",
         "max_grad_norm")


def param_shapes(cfg: dict) -> List[tuple]:
    """The networks' parameter shapes in PPONetworks.parameters() order:
    the policy's layers, then the value's, each weight [out, in] then bias."""
    from duckbench.roofline import networks

    shapes = []
    for layers in networks(cfg):
        for i, o in layers:
            shapes += [(o, i), (o,)]
    return shapes


def _env(cfg: dict, device):
    """The configuration's env (``env``) on its task, on the engine its
    optional ``physics`` names ("kernel", the fused step, by default)."""
    from open_duck_playground_tpu_torch.envs.joystick import Joystick
    from open_duck_playground_tpu_torch.envs.standing import Standing

    cls = {"joystick": Joystick, "standing": Standing}[cfg["env"]]
    return cls(task=cfg["task"], config_overrides=cfg["env_overrides"] or None, device=device,
               physics=cfg.get("physics", "kernel"))


def _learner(cfg: dict, env, sd: Dict[str, int], device):
    from open_duck_playground_tpu_torch.train import ppo

    obs_sizes = {k: v[0] for k, v in env.observation_size.items()}
    if obs_sizes != cfg["obs_sizes"] or env.action_size != cfg["action_size"]:
        raise ValueError(f"the env's observations {obs_sizes} and actions {env.action_size} "
                         f"are not the configuration's")
    net = dict(cfg["network"])
    for k in ("policy_hidden_layer_sizes", "value_hidden_layer_sizes"):
        net[k] = tuple(net[k])
    ts = ppo.init_training_state(obs_sizes, env.action_size, net,
                                 traffic.generator(0, device), device)
    with torch.no_grad():
        for p, w in zip(ts.params.parameters(), traffic.weights(sd["weights"], param_shapes(cfg),
                                                                 device), strict=True):
            p.copy_(w)
    return ts


class TrainProgram:
    """With a `shard` (an EnvShard of world > 1, one rank of an env-sharded
    run, as ppo.train builds it): the env draws at the global shape, the
    TrainEnv holds the rank's rows, the SGD step sums over the ranks, and
    every training step takes the global draws."""

    def __init__(self, cfg: dict, sd: Dict[str, int], device, log=None, shard=None):
        from open_duck_playground_tpu_torch.envs import randomize
        from open_duck_playground_tpu_torch.envs.wrapper import TrainEnv
        from open_duck_playground_tpu_torch.train import ppo

        self.ppo, self.cfg, self.device, self.shard = ppo, cfg, device, shard
        p = cfg["ppo"]
        self.hp = ppo.Hyper(**{k: p[k] for k in HYPER})
        self.env = _env(cfg, device)
        self.env.generator.manual_seed(sd["env"])
        if shard is not None:
            self.env.shard = shard
        self.train_env = TrainEnv(
            self.env, num_envs=p["num_envs"] if shard is None else shard.local(p["num_envs"]),
            episode_length=p["episode_length"], action_repeat=p["action_repeat"],
            randomization_fn=randomize.domain_randomize if cfg["domain_randomization"] else None,
            randomization_generator=traffic.generator(sd["randomization"], device))
        self.ts = _learner(cfg, self.env, sd, device)
        self.sgd = ppo.make_sgd_step(self.ts, self.hp, shard, log=log)
        self.roll = ppo.make_rollout(self.train_env, self.ts, self.hp, log=log)
        self.state = self.train_env.reset(traffic.generator(sd["reset"], device))
        self.g_draws = traffic.generator(sd["draws"], device)
        self.env_steps = 0

    def draws(self):
        """One training step's draws, by the port's own draw step."""
        return self.ppo.draw_training_step(self.g_draws, self.hp, self.env.action_size,
                                           self.device)

    def step(self, draws, roll=None, sgd=None) -> Dict[str, torch.Tensor]:
        """One training step with `draws`; returns its mean losses."""
        self.ts, self.state, losses = self.ppo.training_step(
            self.ts, self.train_env, self.state, draws, self.hp, self.shard,
            sgd=sgd or self.sgd, roll=roll or self.roll)
        self.env_steps += self.hp.env_steps_per_training_step
        return losses


class EvalProgram:
    def __init__(self, cfg: dict, sd: Dict[str, int], device, log=None):
        from open_duck_playground_tpu_torch.envs.wrapper import TrainEnv
        from open_duck_playground_tpu_torch.train import ppo

        self.ppo, self.cfg, self.device = ppo, cfg, device
        p = cfg["ppo"]
        self.env = _env(cfg, device)
        self.env.generator.manual_seed(sd["env"])
        self.eval_env = TrainEnv(self.env, num_envs=p["num_eval_envs"],
                                 episode_length=p["episode_length"],
                                 action_repeat=p["action_repeat"], randomization_fn=None)
        self.ts = _learner(cfg, self.env, sd, device)
        with torch.no_grad():
            for k, (mean, std) in traffic.normalizer_stats(sd["normalizer"], cfg["obs_sizes"],
                                                           device).items():
                self.ts.normalizer.mean[k].copy_(mean)
                self.ts.normalizer.std[k].copy_(std)
        self.deterministic = p["deterministic_eval"]
        self.g_eval = traffic.generator(sd["eval"], device)
        self.step_fn = ppo.make_eval_step(self.eval_env, self.ts, self.g_eval,
                                          self.deterministic, log=log)
        self.steps = p["episode_length"] // p["action_repeat"]
        self.env_steps = 0

    def reset(self):
        """The episode's start, as run_eval makes it."""
        return self.ppo.eval_start(self.eval_env.reset(self.g_eval))

    def step(self, carry):
        self.env_steps += self.eval_env.num_envs
        return self.step_fn(self.eval_env, self.ts.normalizer, self.ts.params, self.g_eval,
                            carry, self.deterministic, None)

    @staticmethod
    def summary(carry) -> Dict[str, torch.Tensor]:
        """run_eval's means over the eval envs."""
        return {"eval/episode_reward": torch.mean(carry.sums),
                "eval/episode_reward_std": torch.std(carry.sums, correction=0),
                "eval/avg_episode_length": torch.mean(carry.length)}


def program(cfg: dict, loop: str, sd: Dict[str, int], device, log=None, shard=None):
    if loop == "train":
        return TrainProgram(cfg, sd, device, log, shard)
    return EvalProgram(cfg, sd, device, log)


def free(prog: Optional[object]) -> None:
    """Drop the program's tensors and graphs from the card."""
    if prog is not None:
        prog.__dict__.clear()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
