"""PPO actor-learner, Brax-PPO semantics, on one device.

Counterpart of the JAX package's ``train/ppo.py``: batched rollouts over
``TrainEnv.step``, GAE with truncation masking, clipped surrogate +
0.25*value-error^2 + entropy bonus, running-statistics obs normalization
(asymmetric actor/critic keys), minibatched Adam epochs with global-norm
clipping, per-epoch full-state checkpoints and curve-exact resume.

Every random draw is an argument of the function that uses it: ``rollout``
takes its policy noise, ``sgd_step`` its per-epoch permutations and
per-minibatch entropy noise, as tensors. ``train`` makes them from its own
``torch.Generator``s on the device, one per purpose, seeded from ``seed``
(``draw_training_step``), and reseeds the envs' own generators from it too.

The learner's products, its Adam and its GAE are plain PyTorch; every env
step goes through the env's physics (the fused CUDA kernel on the card).
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import json
import os
import shutil
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from open_duck_playground_tpu_torch import interop
from open_duck_playground_tpu_torch.envs.wrapper import TrainEnv
from open_duck_playground_tpu_torch.train import checkpoint as ckpt
from open_duck_playground_tpu_torch.train import networks as nets
from open_duck_playground_tpu_torch.train import optim

# train()'s generators, in the order seeded_generators spawns them
GENERATORS = ("net", "randomization", "reset", "epoch", "eval", "env", "eval_env")
# set by train(profile_breakdown=True): the timing dict of the last
# breakdown, for harnesses that want the artifact without parsing stdout
LAST_PROFILE_BREAKDOWN: Optional[Dict[str, Any]] = None


def _map(fn, x):
    """`fn` over every tensor of nested dicts and dataclasses."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: _map(fn, v) for k, v in x.items()}
    return dataclasses.replace(x, **{f.name: _map(fn, getattr(x, f.name))
                                     for f in dataclasses.fields(x)})


@dataclasses.dataclass(frozen=True)
class Transition:
    """Rollout data; every leaf [T, num_envs, ...] (or [T, b, ...])."""

    observation: Dict[str, torch.Tensor]
    action: torch.Tensor
    reward: torch.Tensor
    discount: torch.Tensor
    next_observation: Dict[str, torch.Tensor]
    truncation: torch.Tensor
    raw_action: torch.Tensor
    log_prob: torch.Tensor


@dataclasses.dataclass(frozen=True)
class TrainingState:
    params: nets.PPONetworks  # updated in place by each Adam step
    normalizer: nets.RunningStatisticsState
    opt_state: optim.AdamState
    env_steps: torch.Tensor  # () int64

    def replace(self, **updates) -> "TrainingState":
        return dataclasses.replace(self, **updates)


@dataclasses.dataclass(frozen=True)
class Hyper:
    """The hyperparameters the rollout, the loss and the SGD step read;
    their defaults are train()'s."""

    num_envs: int
    unroll_length: int
    num_minibatches: int
    batch_size: int
    num_updates_per_batch: int
    action_repeat: int
    learning_rate: float
    entropy_cost: float
    discounting: float
    gae_lambda: float
    clipping_epsilon: float
    normalize_advantage: bool
    reward_scaling: float
    normalize_observations: bool
    max_grad_norm: Optional[float]

    @property
    def env_steps_per_training_step(self) -> int:
        return self.batch_size * self.unroll_length * self.num_minibatches * self.action_repeat


@torch.no_grad()
def compute_gae(truncation, termination, rewards, values, bootstrap_value,
                lambda_: float, discount: float):
    """Brax-semantics GAE: deltas masked at truncation boundaries; a reverse
    loop over T. Returns (vs, advantages), outside autograd."""
    truncation_mask = 1 - truncation
    values_t_plus_1 = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    deltas = rewards + discount * (1 - termination) * values_t_plus_1 - values
    deltas = deltas * truncation_mask

    acc = torch.zeros_like(bootstrap_value)
    vs_minus_v = [None] * values.shape[0]
    for t in reversed(range(values.shape[0])):
        acc = deltas[t] + discount * (1 - termination[t]) * truncation_mask[t] * lambda_ * acc
        vs_minus_v[t] = acc
    vs = torch.stack(vs_minus_v) + values
    vs_t_plus_1 = torch.cat([vs[1:], bootstrap_value[None]], dim=0)
    advantages = (rewards + discount * (1 - termination) * vs_t_plus_1 - values) * truncation_mask
    return vs, advantages


def loss_fn(networks: nets.PPONetworks, normalizer, data: Transition,
            entropy_noise: torch.Tensor, hp: Hyper):
    """The PPO loss over one minibatch (leaves [T, b, ...]); `entropy_noise`
    [T, b, action_size] is the entropy term's standard-normal draw.
    Returns (total, {name: detached scalar})."""
    logits = networks.policy_logits(normalizer, data.observation)
    loc, scale = nets.dist_create(logits)
    baseline = networks.value_fn(normalizer, data.observation)
    terminal_obs = {k: v[-1] for k, v in data.next_observation.items()}
    bootstrap_value = networks.value_fn(normalizer, terminal_obs)

    rewards = data.reward * hp.reward_scaling
    truncation = data.truncation
    termination = (1 - data.discount) * (1 - truncation)

    target_lp = nets.dist_log_prob(loc, scale, data.raw_action)
    rho = torch.exp(target_lp - data.log_prob)

    vs, advantages = compute_gae(truncation, termination, rewards, baseline.detach(),
                                 bootstrap_value.detach(), lambda_=hp.gae_lambda,
                                 discount=hp.discounting)
    if hp.normalize_advantage:
        # population std, as jnp.std
        advantages = (advantages - advantages.mean()) / (advantages.std(correction=0) + 1e-8)

    surrogate1 = rho * advantages
    surrogate2 = torch.clamp(rho, 1 - hp.clipping_epsilon, 1 + hp.clipping_epsilon) * advantages
    policy_loss = -torch.mean(torch.minimum(surrogate1, surrogate2))

    v_error = vs - baseline
    v_loss = torch.mean(v_error * v_error) * 0.5 * 0.5

    entropy = torch.mean(nets.dist_entropy(loc, scale, entropy_noise))
    entropy_loss = -hp.entropy_cost * entropy

    total = policy_loss + v_loss + entropy_loss
    return total, {"total_loss": total.detach(), "policy_loss": policy_loss.detach(),
                   "v_loss": v_loss.detach(), "entropy_loss": entropy_loss.detach()}


def rollout(train_env: TrainEnv, env_state, normalizer, networks: nets.PPONetworks,
            noise: torch.Tensor):
    """unroll_length = noise.shape[0] steps of the stochastic policy; `noise`
    is [T, num_envs, action_size] standard-normal. Returns (env_state,
    Transition with leaves [T, num_envs, ...])."""
    steps = []
    state = env_state
    for t in range(noise.shape[0]):
        action, raw, log_prob = nets.sample_actions(networks, normalizer, state.obs, noise[t])
        nstate = train_env.step(state, action)
        steps.append(Transition(
            observation=state.obs, action=action, reward=nstate.reward,
            discount=1.0 - nstate.done, next_observation=nstate.obs,
            truncation=nstate.info["truncation"], raw_action=raw, log_prob=log_prob))
        state = nstate
    data = Transition(**{
        f.name: (torch.stack([getattr(s, f.name) for s in steps])
                 if isinstance(getattr(steps[0], f.name), torch.Tensor) else
                 {k: torch.stack([getattr(s, f.name)[k] for s in steps])
                  for k in getattr(steps[0], f.name)})
        for f in dataclasses.fields(Transition)})
    return state, data


def sgd_step(training_state: TrainingState, data: Transition, perms: torch.Tensor,
             entropy_noise: torch.Tensor, hp: Hyper):
    """Normalizer update from the whole rollout, then num_updates_per_batch
    epochs of num_minibatches Adam steps. `perms` [epochs, num_envs] are the
    per-epoch env permutations (minibatch j of epoch e takes envs
    perms[e, j*b:(j+1)*b] at every t, as `take(perm, axis=1)` then
    `reshape(T, nmb, b).swapaxes(0, 1)`); `entropy_noise` [epochs, nmb, T,
    b, action_size]. The params are updated in place; returns
    (training_state, {name: [epochs, nmb] losses})."""
    if hp.normalize_observations:
        normalizer = nets.rs_update(training_state.normalizer, data.observation)
    else:
        normalizer = training_state.normalizer
    networks = training_state.params
    params = list(networks.parameters())
    opt_state = training_state.opt_state
    b = hp.batch_size
    aux = []
    for e in range(hp.num_updates_per_batch):
        for j in range(hp.num_minibatches):
            idx = perms[e, j * b:(j + 1) * b]
            mb = _map(lambda x: x.index_select(1, idx), data)
            total, mb_aux = loss_fn(networks, normalizer, mb, entropy_noise[e, j], hp)
            grads = torch.autograd.grad(total, params)
            if hp.max_grad_norm is not None:
                grads = optim.clip_by_global_norm(grads, hp.max_grad_norm)
            opt_state = optim.adam(params, grads, opt_state, hp.learning_rate)
            aux.append(mb_aux)
    stacked = {k: torch.stack([a[k] for a in aux]).reshape(
        hp.num_updates_per_batch, hp.num_minibatches) for k in aux[0]}
    return training_state.replace(normalizer=normalizer, opt_state=opt_state), stacked


def draw_training_step(generator: torch.Generator, hp: Hyper, action_size: int, device):
    """One training step's draws, in this order: the rollout's policy noise
    [T, num_envs, A], the epochs' permutations [E, num_envs], the minibatches'
    entropy noise [E, nmb, T, b, A]."""
    T, E = hp.unroll_length, hp.num_updates_per_batch
    noise = torch.randn((T, hp.num_envs, action_size), generator=generator, device=device)
    perms = torch.stack([torch.randperm(hp.num_envs, generator=generator, device=device)
                         for _ in range(E)])
    ent = torch.randn((E, hp.num_minibatches, T, hp.batch_size, action_size),
                      generator=generator, device=device)
    return noise, perms, ent


def training_step(training_state: TrainingState, train_env: TrainEnv, env_state, draws,
                  hp: Hyper):
    """Rollout with the current (normalizer, params), then the SGD step.
    Returns (training_state, env_state, {name: mean loss})."""
    noise, perms, ent = draws
    env_state, data = rollout(train_env, env_state, training_state.normalizer,
                              training_state.params, noise)
    training_state, aux = sgd_step(training_state, data, perms, ent, hp)
    training_state = training_state.replace(
        env_steps=training_state.env_steps + hp.env_steps_per_training_step)
    return training_state, env_state, {k: v.mean() for k, v in aux.items()}


@torch.no_grad()
def run_eval(eval_env: TrainEnv, normalizer, networks: nets.PPONetworks,
             generator: torch.Generator, *, episode_length: int, action_repeat: int = 1,
             deterministic: bool = False) -> Dict[str, torch.Tensor]:
    """One episode of every eval env: reset from `generator`, then
    episode_length // action_repeat steps, each env's sums masked once it is
    done. The stochastic policy draws its noise from `generator`."""
    policy = networks.make_policy_fn(deterministic=deterministic)
    state = eval_env.reset(generator)
    n, dev = eval_env.num_envs, state.reward.device
    active = torch.ones(n, device=dev)
    sums = torch.zeros(n, device=dev)
    length = torch.zeros(n, device=dev)
    metric_sums = {k: torch.zeros(n, device=dev) for k in state.metrics}
    for _ in range(episode_length // action_repeat):
        action, _ = policy((normalizer, networks), state.obs, generator)
        state = eval_env.step(state, action)
        sums = sums + state.reward * active
        metric_sums = {k: v + state.metrics[k] * active for k, v in metric_sums.items()}
        length = length + active
        active = active * (1.0 - state.done)
    out = {
        "eval/episode_reward": torch.mean(sums),
        "eval/episode_reward_std": torch.std(sums, correction=0),
        "eval/avg_episode_length": torch.mean(length),
    }
    for k, v in metric_sums.items():
        out[f"eval/episode_{k}"] = torch.mean(v)
    return out


# ---------------------------------------------------------------------------
# full training state <-> named arrays
# ---------------------------------------------------------------------------


def _tensors(x, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    if isinstance(x, torch.Tensor):
        out[prefix] = x
    elif isinstance(x, dict):
        for k, v in x.items():
            _tensors(v, f"{prefix}/{k}", out)
    else:
        for f in dataclasses.fields(x):
            _tensors(getattr(x, f.name), f"{prefix}/{f.name}", out)


def _rebuild(template, prefix: str, arrays: Dict[str, np.ndarray]):
    if isinstance(template, torch.Tensor):
        a = arrays[prefix]
        if tuple(a.shape) != tuple(template.shape):
            raise ValueError(f"{prefix}: shape {a.shape} in the checkpoint, "
                             f"{tuple(template.shape)} in the run")
        return torch.as_tensor(a, dtype=template.dtype).to(template.device)
    if isinstance(template, dict):
        return {k: _rebuild(v, f"{prefix}/{k}", arrays) for k, v in template.items()}
    return dataclasses.replace(template, **{
        f.name: _rebuild(getattr(template, f.name), f"{prefix}/{f.name}", arrays)
        for f in dataclasses.fields(template)})


def full_state(training_state: TrainingState, env_state,
               generators: Dict[str, torch.Generator]) -> Dict[str, torch.Tensor]:
    """The whole training state as {name: tensor}, in a fixed order: the
    params and Adam moments by brax path, the normalizer, env_steps, every
    tensor of the env batch (info's first_data / first_obs and the delay
    histories included) and each generator's state."""
    named = interop.brax_paths(training_state.params)

    def brax(prefix, tensors):
        return {f"{prefix}/{'/'.join(path)}": (t.T if path[-1] == "kernel" else t)
                for (path, _), t in zip(named, tensors)}

    out = brax("training_state/params", [p.detach() for _, p in named])
    _tensors(training_state.normalizer, "training_state/normalizer", out)
    opt = training_state.opt_state
    out["training_state/opt_state/count"] = opt.count
    out.update(brax("training_state/opt_state/mu", opt.mu))
    out.update(brax("training_state/opt_state/nu", opt.nu))
    out["training_state/env_steps"] = training_state.env_steps
    _tensors(env_state, "env_state", out)
    for name, g in generators.items():
        out[f"generators/{name}"] = g.get_state()
    return out


def full_state_to_numpy(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in state.items()}


def restore_full_state(arrays: Dict[str, np.ndarray], training_state: TrainingState,
                       env_state, generators: Dict[str, torch.Generator]):
    """Inverse of `full_state` against templates of the same run: loads the
    params in place, sets each generator's state, and returns
    (training_state, env_state)."""

    def tree(prefix):
        return ckpt.unflatten({k[len(prefix) + 1:]: v for k, v in arrays.items()
                               if k.startswith(prefix + "/")})

    nw = training_state.params
    dev = training_state.env_steps.device
    interop.ppo_params_from_numpy(tree("training_state/params"), nw)
    opt = tree("training_state/opt_state")
    opt_state = interop.adam_state_from_numpy(opt, nw, dev)
    normalizer = _rebuild(training_state.normalizer, "training_state/normalizer", arrays)
    env_steps = _rebuild(training_state.env_steps, "training_state/env_steps", arrays)
    env_state = _rebuild(env_state, "env_state", arrays)
    for name, g in generators.items():
        g.set_state(torch.as_tensor(arrays[f"generators/{name}"]))
    return training_state.replace(normalizer=normalizer, opt_state=opt_state,
                                  env_steps=env_steps), env_state


def seeded_generators(seed: int, device) -> Dict[str, torch.Generator]:
    """train()'s generators on `device`, one per purpose (GENERATORS), their
    seeds spawned from `seed`."""
    seqs = np.random.SeedSequence(seed).spawn(len(GENERATORS))
    return {name: torch.Generator(device=device).manual_seed(int(s.generate_state(1, np.uint64)[0]))
            for name, s in zip(GENERATORS, seqs)}


def _canonical(device) -> torch.device:
    """`device` with its index made explicit (cuda -> cuda:<current>), so
    that two names of one device compare equal; raises without CUDA."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: ppo.train runs on the card unless given a CPU "
                               "env and device='cpu'")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(
    environment,
    eval_env=None,
    *,
    num_timesteps: int,
    episode_length: int = 1000,
    num_envs: int = 8192,
    num_eval_envs: int = 128,
    action_repeat: int = 1,
    unroll_length: int = 20,
    num_minibatches: int = 32,
    batch_size: int = 256,
    num_updates_per_batch: int = 4,
    learning_rate: float = 3e-4,
    entropy_cost: float = 5e-3,
    discounting: float = 0.97,
    gae_lambda: float = 0.95,
    clipping_epsilon: float = 0.2,
    normalize_advantage: bool = True,
    reward_scaling: float = 1.0,
    normalize_observations: bool = True,
    max_grad_norm: Optional[float] = 1.0,
    num_evals: int = 15,
    deterministic_eval: bool = False,
    seed: int = 0,
    network_factory: Optional[Dict[str, Any]] = None,
    randomization_fn=None,
    progress_fn: Optional[Callable] = None,
    policy_params_fn: Optional[Callable] = None,
    restore_checkpoint_path: Optional[str] = None,
    save_full_state_dir: Optional[str] = None,
    auto_resume: bool = False,
    keep_full_states: int = 2,
    save_full_state_every: int = 1,
    stop_after_epochs: Optional[int] = None,
    profile_breakdown: bool = False,
    device=None,
):
    """Train PPO; returns (make_policy, (normalizer, params), metrics).

    The contract of brax ppo.train as the reference runner consumes it:
    `params[0]` is the obs normalizer, `params[1]` the PPONetworks.
    `device` (default: the env's) is where the learner runs; it must be the
    env's, and a CUDA device must exist: nothing moves to the CPU by itself.
    """
    if num_envs != batch_size * num_minibatches:
        raise ValueError("brax-PPO layout requires num_envs == batch_size * num_minibatches")
    dev = _canonical(device if device is not None else environment.device)
    if _canonical(environment.device) != dev:
        raise ValueError(f"the env runs on {environment.device}, the learner on {dev}")

    g_net, g_rand, g_reset, g_epoch, g_eval, g_env, g_eval_env = seeded_generators(
        seed, dev).values()
    # the envs' own streams (noise, pushes, delays, commands) start from `seed` too
    environment.generator.set_state(g_env.get_state())
    if eval_env is not None:
        eval_env.generator.set_state(g_eval_env.get_state())

    hp = Hyper(num_envs=num_envs, unroll_length=unroll_length,
               num_minibatches=num_minibatches, batch_size=batch_size,
               num_updates_per_batch=num_updates_per_batch, action_repeat=action_repeat,
               learning_rate=learning_rate, entropy_cost=entropy_cost,
               discounting=discounting, gae_lambda=gae_lambda,
               clipping_epsilon=clipping_epsilon, normalize_advantage=normalize_advantage,
               reward_scaling=reward_scaling, normalize_observations=normalize_observations,
               max_grad_norm=max_grad_norm)

    train_env = TrainEnv(environment, num_envs=num_envs, episode_length=episode_length,
                         action_repeat=action_repeat, randomization_fn=randomization_fn,
                         randomization_generator=g_rand)

    obs_sizes = {k: v[0] for k, v in environment.observation_size.items()}
    action_size = environment.action_size
    network = nets.PPONetworks(obs_sizes, action_size, **(network_factory or {}),
                               generator=g_net, device=dev)
    normalizer = nets.rs_init(obs_sizes, dev)
    if restore_checkpoint_path is not None:
        normalizer, network = ckpt.load(restore_checkpoint_path, (normalizer, network))
    training_state = TrainingState(
        params=network, normalizer=normalizer,
        opt_state=optim.adam_init(list(network.parameters())),
        env_steps=torch.zeros((), dtype=torch.int64, device=dev))

    def make_policy(full_params, deterministic: bool = False):
        return functools.partial(network.make_policy_fn(deterministic=deterministic),
                                 full_params)

    env_step_per_training_step = hp.env_steps_per_training_step
    num_evals_after_init = max(num_evals - 1, 1)
    num_training_steps_per_epoch = int(
        np.ceil(num_timesteps / (num_evals_after_init * env_step_per_training_step)))

    def training_epoch(training_state, env_state):
        step_metrics = []
        for _ in range(num_training_steps_per_epoch):
            draws = draw_training_step(g_epoch, hp, action_size, dev)
            training_state, env_state, m = training_step(
                training_state, train_env, env_state, draws, hp)
            step_metrics.append(m)
        metrics = {k: torch.stack([m[k] for m in step_metrics]).mean() for k in step_metrics[0]}
        return training_state, env_state, metrics

    eval_wrapped = None
    if eval_env is not None:
        eval_wrapped = TrainEnv(eval_env, num_envs=num_eval_envs, episode_length=episode_length,
                                action_repeat=action_repeat, randomization_fn=None)

    def evaluate(full_params, generator):
        normalizer, params = full_params
        return run_eval(eval_wrapped, normalizer, params, generator,
                        episode_length=episode_length, action_repeat=action_repeat,
                        deterministic=deterministic_eval)

    # ------------------------------------------------------------------
    # main loop
    # ------------------------------------------------------------------
    t0 = time.monotonic()
    env_state = train_env.reset(g_reset)
    _sync(dev)
    print(f"[ppo] env reset ({num_envs} envs) ran in {time.monotonic() - t0:.1f}s", flush=True)

    generators = {"epoch": g_epoch, "env": environment.generator}
    if eval_env is not None:
        generators.update(eval=g_eval, eval_env=eval_env.generator)

    start_epoch = 0
    if auto_resume and save_full_state_dir is not None:
        found = ckpt.latest_full(save_full_state_dir)
        if found is not None:
            resume_epoch, resume_path = found
            training_state, env_state = restore_full_state(
                ckpt.load_full(resume_path), training_state, env_state, generators)
            start_epoch = resume_epoch + 1
            print(f"[ppo] resumed full train state from {resume_path} (epoch "
                  f"{resume_epoch}, env_steps {int(training_state.env_steps)})", flush=True)

    def _save_full_state(epoch_i: int, directory: Optional[str] = save_full_state_dir):
        if directory is None:
            return
        t_g = time.monotonic()
        arrays = full_state_to_numpy(full_state(training_state, env_state, generators))
        t_g = time.monotonic() - t_g
        try:
            t_w = time.monotonic()
            ckpt.save_full(directory, epoch_i, arrays, keep=keep_full_states)
            t_w = time.monotonic() - t_w
            print(f"[ppo] full-state save epoch {epoch_i}: host copy {t_g:.2f}s "
                  f"write {t_w:.2f}s", flush=True)
        except OSError as e:  # keep training alive if the save breaks
            print(f"[ppo] full-state checkpoint failed: {e}", flush=True)

    metrics: Dict[str, float] = {}

    def _eval_and_report(step_count: int):
        if eval_wrapped is not None:
            t0 = time.monotonic()
            eval_metrics = evaluate((training_state.normalizer, training_state.params), g_eval)
            # merge, don't replace: the caller just wrote training/* metrics
            # (sps, losses) into `metrics` and progress_fn must see both
            metrics.update({k: float(v) for k, v in eval_metrics.items()})
            print(f"[ppo] eval rollout done in {time.monotonic() - t0:.1f}s", flush=True)
        if progress_fn is not None:
            progress_fn(step_count, metrics)
        if policy_params_fn is not None:
            policy_params_fn(step_count, make_policy,
                             (training_state.normalizer, training_state.params))

    if profile_breakdown:
        # Time the real rollout, SGD step, training step, eval and full-state
        # save, each run twice and timed the second time. Training is left
        # as it is: the rollouts and evals draw from throwaway generators and
        # the envs' own generators are restored afterwards; SGD runs on
        # copies of the params and the optimizer state; outputs are dropped.
        def _timed(fn):
            fn()
            _sync(dev)
            t = time.monotonic()
            out = fn()
            _sync(dev)
            return time.monotonic() - t, out

        def throwaway():
            return torch.Generator(device=dev).manual_seed(0xB0)

        def copied(ts):
            return ts.replace(params=copy.deepcopy(ts.params),
                              opt_state=optim.clone_state(ts.opt_state))

        env_gens = {k: g.get_state() for k, g in generators.items() if k in ("env", "eval_env")}
        draws0 = draw_training_step(throwaway(), hp, action_size, dev)
        bd: Dict[str, Any] = {"num_envs": num_envs, "unroll_length": unroll_length,
                              "env_steps_per_training_step": env_step_per_training_step}
        t_roll, (_, data0) = _timed(lambda: rollout(
            train_env, env_state, training_state.normalizer, training_state.params, draws0[0]))
        bd["rollout_s"] = round(t_roll, 4)
        bd["rollout_env_sps"] = round(num_envs * unroll_length / t_roll, 1)
        ts0 = copied(training_state)
        t_sgd, _ = _timed(lambda: sgd_step(ts0, data0, draws0[1], draws0[2], hp))
        bd["sgd_s"] = round(t_sgd, 4)
        ts0 = copied(training_state)
        t_step, _ = _timed(lambda: training_step(ts0, train_env, env_state, draws0, hp))
        bd["training_step_s"] = round(t_step, 4)
        bd["e2e_env_sps"] = round(env_step_per_training_step / t_step, 1)
        del data0, ts0, draws0
        if eval_wrapped is not None:
            t_eval, _ = _timed(lambda: evaluate(
                (training_state.normalizer, training_state.params), throwaway()))
            bd["eval_s"] = round(t_eval, 4)
        for k, s in env_gens.items():
            generators[k].set_state(s)
        if save_full_state_dir is not None:
            # into a scratch directory, deleted after: full_<n>.npz only ever
            # holds the state after epoch n, which auto_resume relies on
            scratch = os.path.join(save_full_state_dir, "profile_breakdown")
            t0p = time.monotonic()
            _save_full_state(start_epoch, scratch)
            bd["full_state_save_s"] = round(time.monotonic() - t0p, 4)
            shutil.rmtree(scratch, ignore_errors=True)
        bd["num_training_steps_per_epoch"] = num_training_steps_per_epoch
        global LAST_PROFILE_BREAKDOWN
        LAST_PROFILE_BREAKDOWN = bd
        print(f"[ppo] profile_breakdown {json.dumps(bd)}", flush=True)

    if start_epoch == 0:
        _eval_and_report(0)

    walltimes = []
    print(f"[ppo] entering training loop: {num_evals_after_init} epochs x "
          f"{num_training_steps_per_epoch} training steps", flush=True)
    for epoch_i in range(start_epoch, num_evals_after_init):
        t0 = time.monotonic()
        training_state, env_state, train_metrics = training_epoch(training_state, env_state)
        _sync(dev)
        walltimes.append(time.monotonic() - t0)
        sps = num_training_steps_per_epoch * env_step_per_training_step / walltimes[-1]
        metrics = {f"training/{k}": float(v) for k, v in train_metrics.items()}
        metrics["training/sps"] = sps
        metrics["training/walltime"] = sum(walltimes)
        _eval_and_report(int(training_state.env_steps))
        stopping = stop_after_epochs is not None and (
            epoch_i + 1 - start_epoch >= stop_after_epochs)
        # cadence knob: every-N saves trade resume granularity for epoch
        # time. Always save on the final epoch and on the stop_after_epochs
        # crash-simulation exit (resume relies on the stopped epoch's state
        # being on disk).
        if ((epoch_i + 1 - start_epoch) % max(save_full_state_every, 1) == 0
                or epoch_i == num_evals_after_init - 1 or stopping):
            _save_full_state(epoch_i)
        if stopping:
            # crash-simulation hook for resume tests: exit mid-recipe with
            # the full state of `epoch_i` on disk, like a kill would
            print(f"[ppo] stop_after_epochs={stop_after_epochs}: stopping "
                  f"after epoch {epoch_i}", flush=True)
            break

    full_params = (training_state.normalizer, training_state.params)
    return make_policy, full_params, metrics
