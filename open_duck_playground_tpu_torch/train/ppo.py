"""PPO actor-learner, Brax-PPO semantics, on one device or env-sharded.

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

The learner's products are plain PyTorch, and so are its clip + Adam, its
GAE and the MLPs' swish on the CPU; on the card each of the first two is
one launch of a hand-written kernel (``optim.clip_and_adam``, ``gae``),
and the swish one forward and one backward kernel (``networks.swish``,
in the rollout, the SGD step and the eval step). Every env
step goes through the env's physics (the fused CUDA kernel on the card, or
the general pipeline with physics="pipeline"). The JAX package jits its
rollout scan, its eval scan and its SGD step, one SPMD program at any
device count. Here each is a device program (utils.graphs.Captured), a
CUDA graph on the card: a training step is the replays of
``RolloutProgram`` (one of the unroll_length env steps and the policy on
the kernel; one per env step on the general pipeline, whose control step
is ~50,000 kernels) and of ``SGDStepProgram`` (the normalizer update and
every minibatch step: one graph at world size 1, a chain of graph segments
with the collectives between them at world > 1), and an eval step one
replay of ``EvalStepProgram``. Each replays a body over fixed buffers
(``rollout_into``, ``sgd_points``, ``eval_step``), which the CPU runs
eagerly through the same objects (``make_rollout``, ``make_sgd_step`` and
``make_eval_step`` make them, and each logs how it runs).

Env-sharded runs (``shard``, ``parallel/dist.py``) keep the JAX package's
global view: every draw is made at the global shape on every rank, each
rank steps its own rows, and the normalizer, the loss, the gradients, the
eval's statistics and the full state are taken over the global batch. At
world size 1 no collective runs and the arithmetic is the one-device one.
"""

from __future__ import annotations

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
from open_duck_playground_tpu_torch.envs.types import State
from open_duck_playground_tpu_torch.envs.wrapper import TrainEnv
from open_duck_playground_tpu_torch.ops import cuda_step
from open_duck_playground_tpu_torch.parallel.dist import (
    Collectives,
    EnvShard,
    current_shard,
    draw,
    run_points,
)
from open_duck_playground_tpu_torch.train import checkpoint as ckpt
from open_duck_playground_tpu_torch.train import networks as nets
from open_duck_playground_tpu_torch.train import optim
from open_duck_playground_tpu_torch.utils import profiling
from open_duck_playground_tpu_torch.utils.graphs import (
    Captured,
    clone_tree,
    copy_into,
    tree_leaves,
    tree_map,
)

# train()'s generators, in the order seeded_generators spawns them
GENERATORS = ("net", "randomization", "reset", "epoch", "eval", "env", "eval_env")
# set by train(profile_breakdown=True): the timing dict of the last
# breakdown, for harnesses that want the artifact without parsing stdout
LAST_PROFILE_BREAKDOWN: Optional[Dict[str, Any]] = None


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


# gae's steps on compute_gae (the CPU's path); a fused step is one launch of
# the GAE kernel, counted where it launches
GAE_PLAIN = optim.PlainSteps()
profiling.watch(GAE_PLAIN, "steps", "gae.plain_steps")
profiling.watch(cuda_step.GAE, "launches", "gae.fused_steps")


@torch.no_grad()
def gae(data: Transition, baseline: torch.Tensor, bootstrap_value: torch.Tensor, hp: Hyper):
    """compute_gae over one minibatch (leaves [T, b]) on the rewards
    ``data.reward * hp.reward_scaling`` and the termination ``(1 -
    data.discount) * (1 - data.truncation)``; returns (vs, advantages),
    outside autograd. CPU tensors run those torch ops and compute_gae (the
    tracer's ``gae.plain_steps``); CUDA tensors one launch of the GAE kernel
    (``cuda_step.gae_step``, ``gae.fused_steps``), with the same result bit
    for bit."""
    if baseline.device.type != "cuda":
        GAE_PLAIN.steps += 1
        rewards = data.reward * hp.reward_scaling
        termination = (1 - data.discount) * (1 - data.truncation)
        return compute_gae(data.truncation, termination, rewards, baseline, bootstrap_value,
                           lambda_=hp.gae_lambda, discount=hp.discounting)
    return cuda_step.gae_step(data.reward.contiguous(), data.discount.contiguous(),
                              data.truncation.contiguous(), baseline.contiguous(),
                              bootstrap_value.contiguous(), hp.reward_scaling, hp.discounting,
                              hp.gae_lambda)


def loss_fn(networks: nets.PPONetworks, normalizer, data: Transition,
            entropy_noise: torch.Tensor, hp: Hyper):
    """The PPO loss over one minibatch (leaves [T, b, ...]); `entropy_noise`
    [T, b, action_size] is the entropy term's standard-normal draw.
    Returns (total, {name: detached scalar}). `loss_points` at world 1."""
    return run_points(loss_points(networks, normalizer, data, entropy_noise, hp), None)


def loss_points(networks: nets.PPONetworks, normalizer, data: Transition,
                entropy_noise: torch.Tensor, hp: Hyper, mask: Optional[torch.Tensor] = None,
                points: Optional[Collectives] = None):
    """`loss_fn` as a generator with its collective points; returns (total,
    {name: detached scalar}).

    With `points` (an env-sharded run, world > 1), `data` and
    `entropy_noise` hold all hp.batch_size positions of a minibatch of the
    global batch, and `mask` [b] says which of them are this rank's envs
    (the others hold a stand-in row of this rank's data): every sum is
    taken over the rank's members alone, `torch.where(mask, term, 0)`, so
    that a stand-in row carries nothing, not even a NaN, into it. The
    advantages are normalized by the whole minibatch's mean and population
    std (two points, in two passes as jnp.std), every mean is over all T x
    hp.batch_size samples, and each term returned is this rank's share of
    it. The ranks' shares sum to the loss (sgd_points sums them with the
    gradients). GAE runs along T per column, stand-ins included."""
    sharded = points is not None
    n = data.reward.shape[0] * hp.batch_size

    def mean(x):
        return torch.sum(torch.where(mask, x, 0.0)) / n if sharded else torch.mean(x)

    logits = networks.policy_logits(normalizer, data.observation)
    loc, scale = nets.dist_create(logits)
    baseline = networks.value_fn(normalizer, data.observation)
    terminal_obs = {k: v[-1] for k, v in data.next_observation.items()}
    bootstrap_value = networks.value_fn(normalizer, terminal_obs)

    target_lp = nets.dist_log_prob(loc, scale, data.raw_action)
    rho = torch.exp(target_lp - data.log_prob)

    vs, advantages = gae(data, baseline.detach(), bootstrap_value.detach(), hp)
    if hp.normalize_advantage and sharded:
        adv_sum = yield from points.total("advantage/sum",
                                          torch.sum(torch.where(mask, advantages, 0.0)))
        adv_mean = adv_sum / n
        deviation = torch.square(advantages - adv_mean)
        adv_sq = yield from points.total("advantage/deviation",
                                         torch.sum(torch.where(mask, deviation, 0.0)))
        advantages = (advantages - adv_mean) / (torch.sqrt(adv_sq / n) + 1e-8)
    elif hp.normalize_advantage:
        # population std, as jnp.std
        advantages = (advantages - advantages.mean()) / (advantages.std(correction=0) + 1e-8)

    surrogate1 = rho * advantages
    surrogate2 = torch.clamp(rho, 1 - hp.clipping_epsilon, 1 + hp.clipping_epsilon) * advantages
    policy_loss = -mean(torch.minimum(surrogate1, surrogate2))

    v_error = vs - baseline
    v_loss = mean(v_error * v_error) * 0.5 * 0.5

    entropy = mean(nets.dist_entropy(loc, scale, entropy_noise))
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
        with profiling.span("policy", noise.device):
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


def _sharded(shard: Optional[EnvShard]) -> Optional[EnvShard]:
    """`shard` where it splits the envs (world > 1), else None."""
    return shard if shard is not None and shard.world > 1 else None


def _policy_tensors(normalizer, networks: nets.PPONetworks) -> list:
    return [*networks.parameters(), *tree_leaves(normalizer).values()]


@torch.no_grad()
def rollout_into(train_env: TrainEnv, buffers: State, normalizer, networks: nets.PPONetworks,
                 noise: torch.Tensor):
    """`rollout` from the env state `buffers`, whose final state is written
    into `buffers` in place (utils.graphs.copy_into); returns (buffers,
    Transition). The body RolloutProgram replays."""
    state, data = rollout(train_env, buffers, normalizer, networks, noise)
    copy_into(buffers, state)
    return buffers, data


class RolloutProgram(Captured):
    """`rollout` as a device program (utils.graphs.Captured), called as
    `rollout` is: the JAX package's `lax.scan` of the policy and
    `train_env.step`. Its body, `rollout_into`, runs `span` steps over
    static copies of the env state and of `span` steps of policy noise; a
    call replays it unroll_length / span times and returns (the static env
    state, the Transition). `span` is the whole unroll on the fused kernel
    (the Transition is the graph's own) and one control step on the
    general pipeline (~43,000-56,000 small kernels: a 20-step graph would
    hold ~1M nodes), each replay's Transition then copied into stacked
    tensors. It reads the env and, by address, the params and normalizer
    (the SGD step updates them in place)."""

    def __init__(self, train_env: TrainEnv, normalizer, networks: nets.PPONetworks, hp: Hyper,
                 log=None):
        pipeline = getattr(train_env.env, "physics_mode", None) == "pipeline"
        self.span = span = 1 if pipeline else hp.unroll_length
        what = (f"{hp.unroll_length // span} replays per training step, each {span} env step of "
                f"the policy and TrainEnv.step (physics='pipeline': ~50,000 kernels per control "
                f"step, a graph per control step at most)" if pipeline else
                f"one replay per training step ({span} env steps)")
        super().__init__(lambda s: rollout_into(train_env, s["state"], normalizer, networks,
                                                s["noise"]),
                         [train_env, *_policy_tensors(normalizer, networks)], train_env.generators,
                         [*train_env.kernels, cuda_step.SWISH], train_env.env.device,
                         "[ppo] rollout", "ppo.rollout", what, log,
                         extra={"env_steps_per_replay": span})

    def __call__(self, train_env: TrainEnv, env_state: State, normalizer,
                 networks: nets.PPONetworks, noise: torch.Tensor):
        reads = [train_env, *_policy_tensors(normalizer, networks)]
        T, span, stacked = noise.shape[0], self.span, None
        for t in range(0, T, span):
            env_state, data = self.run({"state": env_state, "noise": noise[t:t + span]}, reads)
            if span < T:
                if stacked is None:
                    stacked = tree_map(lambda x: x.new_empty((T,) + x.shape[1:]), data)
                for buf, x in zip(tree_leaves(stacked).values(), tree_leaves(data).values()):
                    buf[t:t + span].copy_(x)
        return env_state, data if stacked is None else stacked


def make_rollout(train_env: TrainEnv, training_state: TrainingState, hp: Hyper,
                 log=None) -> RolloutProgram:
    """The rollout train() runs; it logs how it runs."""
    return RolloutProgram(train_env, training_state.normalizer, training_state.params, hp, log)


def sgd_step(training_state: TrainingState, data: Transition, perms: torch.Tensor,
             entropy_noise: torch.Tensor, hp: Hyper, shard: Optional[EnvShard] = None):
    """Normalizer update from the whole rollout, then num_updates_per_batch
    epochs of num_minibatches Adam steps. `perms` [epochs, num_envs] are the
    per-epoch env permutations (minibatch j of epoch e takes envs
    perms[e, j*b:(j+1)*b] at every t, as `take(perm, axis=1)` then
    `reshape(T, nmb, b).swapaxes(0, 1)`); `entropy_noise` [epochs, nmb, T,
    b, action_size]. The params, the Adam state and the normalizer are
    updated in place (the same tensors before and after); returns
    (training_state, {name: [epochs, nmb] losses}).

    This runs the one body of the SGD step, `sgd_points`, eagerly, each of
    its collectives (world > 1) between the segments it separates.
    `SGDStepProgram` replays the same body, on the card as one CUDA graph
    at world size 1 and as a chain of graph segments at world > 1. It
    reads nothing back to the host.

    With a shard of world > 1, `data` holds this rank's envs and the draws
    are the global ones: the normalizer takes the global batch's
    statistics, each rank takes every position of every global minibatch,
    its own envs' rows at its members' positions and a masked stand-in
    elsewhere, and the gradients and loss terms are summed over the ranks
    in one all-reduce per minibatch, before the clip and Adam, so that
    every rank makes the same update."""
    points = None if _sharded(shard) is None else Collectives(shard)
    return training_state, run_points(
        sgd_points(training_state, data, perms, entropy_noise, hp, points), shard)


def sgd_points(training_state: TrainingState, data: Transition, perms: torch.Tensor,
               entropy_noise: torch.Tensor, hp: Hyper, points: Optional[Collectives] = None):
    """The SGD step's body (`sgd_step`) as a generator: with `points` (world
    > 1) it yields at each of its `sgd_collectives` collective points a
    fixed buffer to be summed over the ranks; returns the [epochs, nmb]
    losses. Without, it yields nothing.

    Each rank's minibatch has the world-1 shape, fixed: for minibatch j of
    epoch e the global members p = perms[e, j*b:(j+1)*b]; this rank's are
    mine = lo <= p < lo + n_local, gathered as rows `where(mine, p - lo,
    0)` of its envs, and `mine` masks every sum of the loss (loss_points).
    The segments between the points run the autograd forward of a
    minibatch in one segment and its backward two points later: the saved
    activations stay in the graphs' shared pool, as torch's
    make_graphed_callables keeps them between its forward and backward
    graphs, so the arithmetic is the unsegmented body's."""
    normalizer = training_state.normalizer
    if hp.normalize_observations:
        updated = yield from nets.rs_update_points(normalizer, data.observation, points)
        copy_into(normalizer, updated)
    networks = training_state.params
    params = list(networks.parameters())
    opt_state = training_state.opt_state
    E, nmb, b = hp.num_updates_per_batch, hp.num_minibatches, hp.batch_size
    if points is not None:
        n_local = points.shard.local(hp.num_envs)
        lo = points.shard.rank * n_local
        members = perms.reshape(E, nmb, b)
        mine = (members >= lo) & (members < lo + n_local)
        rows = torch.where(mine, members - lo, 0)
    aux = []
    for e in range(E):
        for j in range(nmb):
            if points is None:
                idx, mask = perms[e, j * b:(j + 1) * b], None
            else:
                idx, mask = rows[e, j], mine[e, j]
            mb = tree_map(lambda x: x.index_select(1, idx), data)
            total, mb_aux = yield from loss_points(networks, normalizer, mb, entropy_noise[e, j],
                                                   hp, mask, points)
            grads = torch.autograd.grad(total, params)
            if points is not None:
                grads, mb_aux = yield from _sum_over_ranks(grads, mb_aux, points)
            optim.clip_and_adam(params, grads, opt_state, hp.learning_rate, hp.max_grad_norm)
            aux.append(mb_aux)
    return {k: torch.stack([a[k] for a in aux]).reshape(E, nmb) for k in aux[0]}


def sgd_collectives(hp: Hyper, obs_keys: int) -> int:
    """The collectives of one env-sharded SGD step: 2 per obs key for the
    normalizer, and per minibatch step 2 for the advantages' mean and
    variance and 1 for the gradients and loss terms (388 at the recipe's
    4 x 32 minibatches and 2 obs keys)."""
    per_minibatch = 1 + (2 if hp.normalize_advantage else 0)
    return ((2 * obs_keys if hp.normalize_observations else 0)
            + hp.num_updates_per_batch * hp.num_minibatches * per_minibatch)


def learner_tensors(training_state: TrainingState) -> list:
    """The tensors an SGD step updates in place, in a fixed order: the
    params, the Adam count and moments, the normalizer."""
    norm: Dict[str, torch.Tensor] = {}
    tree_leaves(training_state.normalizer, "normalizer", norm)
    opt = training_state.opt_state
    return [*training_state.params.parameters(), opt.count, *opt.mu, *opt.nu, *norm.values()]


def snapshot_learner(training_state: TrainingState) -> list:
    """Copies of learner_tensors, for `restore_learner`."""
    return [t.detach().clone() for t in learner_tensors(training_state)]


@torch.no_grad()
def restore_learner(training_state: TrainingState, saved: list) -> None:
    """Copy a `snapshot_learner` back into the state's own tensors."""
    for t, s in zip(learner_tensors(training_state), saved, strict=True):
        t.copy_(s)


class SGDStepProgram(Captured):
    """`sgd_step` as a device program (utils.graphs.Captured), called as
    `sgd_step` is with the hyperparameters and shard it was made for: the
    JAX package's jitted SGD step (normalizer + epochs x minibatches, its
    collectives placed inside by XLA). Its body, `sgd_points`, runs over
    static copies of the Transition, the permutations and the entropy
    noise, and updates the params, Adam state and normalizer of the
    `training_state` it was made for in place (a restore copies into
    them). On the card at world size 1 it is one CUDA graph of ~31,400
    kernels (per minibatch step one launch each of the GAE and optimizer
    kernels and 15 of the swish's: 9 forward, 6 backward). With a `shard`
    of world > 1 it is a chain of `sgd_collectives` + 1 segments in one memory pool, each point's fixed
    buffer (dist.Collectives) summed over the ranks in place between two
    (EnvShard.all_reduce_sum_, eagerly: gloo cannot be captured, and
    NCCL's capture needs a card per rank to check). The loss terms come
    back as copies (``ppo.sgd.losses``)."""

    def __init__(self, training_state: TrainingState, hp: Hyper,
                 shard: Optional[EnvShard] = None, log=None):
        shard = _sharded(shard)
        points = None if shard is None else Collectives(shard)

        def body(s):
            return (yield from sgd_points(training_state, s["data"], s["perms"],
                                          s["entropy_noise"], hp, points))

        what, extra = "one replay per training step", {}
        if shard is not None:
            n = extra["collectives_per_replay"] = sgd_collectives(
                hp, len(training_state.normalizer.mean))
            what += (f" at world {shard.world} ({shard.backend or 'no process group'}; {n} sums "
                     f"over the ranks between {n + 1} segments, on fixed buffers"
                     f"{' in pinned host memory' if shard.stages_on_host else ''})")
        super().__init__(body, [hp, shard, *learner_tensors(training_state)],
                         kernels=[cuda_step.ADAM, cuda_step.GAE, cuda_step.SWISH],
                         device=training_state.env_steps.device, name="[ppo] SGD step",
                         prefix="ppo.sgd", what=what, log=log,
                         between=None if shard is None else shard.all_reduce_sum_, extra=extra)

    def __call__(self, training_state: TrainingState, data: Transition, perms: torch.Tensor,
                 entropy_noise: torch.Tensor, hp: Hyper, shard: Optional[EnvShard] = None):
        losses = self.run({"data": data, "perms": perms, "entropy_noise": entropy_noise},
                          [hp, _sharded(shard), *learner_tensors(training_state)])
        with profiling.span("ppo.sgd.losses", self.device):
            return training_state, {k: v.clone() for k, v in losses.items()}


def make_sgd_step(training_state: TrainingState, hp: Hyper, shard: Optional[EnvShard] = None,
                  log=None) -> SGDStepProgram:
    """The SGD step train() runs; it logs how it runs."""
    return SGDStepProgram(training_state, hp, shard, log)


def _sum_over_ranks(grads, aux: Dict[str, torch.Tensor], points: Collectives):
    """The gradients and the loss terms summed over the ranks, at one
    collective point of one flat buffer; total_loss is the sum of the
    summed terms."""
    terms = ("policy_loss", "v_loss", "entropy_loss")
    flat = yield from points.total("gradients", torch.cat(
        [g.reshape(-1) for g in grads] + [torch.stack([aux[k] for k in terms])]))
    out, at = [], 0
    for g in grads:
        out.append(flat[at:at + g.numel()].view_as(g))
        at += g.numel()
    summed = dict(zip(terms, flat[at:]))
    summed["total_loss"] = summed["policy_loss"] + summed["v_loss"] + summed["entropy_loss"]
    return out, {k: summed[k] for k in aux}


def draw_training_step(generator: torch.Generator, hp: Hyper, action_size: int, device):
    """One training step's draws, in this order: the rollout's policy noise
    [T, num_envs, A], the epochs' permutations [E, num_envs], the minibatches'
    entropy noise [E, nmb, T, b, A]."""
    T, E = hp.unroll_length, hp.num_updates_per_batch
    with profiling.span("ppo.draws", device):
        noise = torch.randn((T, hp.num_envs, action_size), generator=generator, device=device)
        perms = torch.stack([torch.randperm(hp.num_envs, generator=generator, device=device)
                             for _ in range(E)])
        ent = torch.randn((E, hp.num_minibatches, T, hp.batch_size, action_size),
                          generator=generator, device=device)
    return noise, perms, ent


def training_step(training_state: TrainingState, train_env: TrainEnv, env_state, draws,
                  hp: Hyper, shard: Optional[EnvShard] = None, sgd=sgd_step, roll=rollout):
    """The rollout `roll` (`rollout`, or a RolloutProgram of this state)
    with the current (normalizer, params), then the SGD step `sgd`
    (`sgd_step`, or an SGDStepProgram of this state).
    Returns (training_state, env_state, {name: mean loss}). With a shard,
    `env_state` is this rank's rows and `draws` the global draws: the
    rollout takes its rows of the policy noise."""
    with profiling.span("ppo.training_step", unit=True):
        noise, perms, ent = draws
        if shard is not None:
            noise = shard.take(noise, dim=1)
        with profiling.span("ppo.rollout"):
            env_state, data = roll(train_env, env_state, training_state.normalizer,
                                   training_state.params, noise)
        with profiling.span("ppo.sgd"):
            training_state, aux = sgd(training_state, data, perms, ent, hp, shard)
        training_state = training_state.replace(
            env_steps=training_state.env_steps + hp.env_steps_per_training_step)
        return training_state, env_state, {k: v.mean() for k, v in aux.items()}


@dataclasses.dataclass(frozen=True)
class EvalCarry:
    """What an eval episode carries from step to step: the env state, and
    per env the reward and metric sums, the steps counted and whether it
    is still running (1.0 until its first done)."""

    state: State
    sums: torch.Tensor
    metric_sums: Dict[str, torch.Tensor]
    length: torch.Tensor
    active: torch.Tensor


def eval_start(state: State) -> EvalCarry:
    n, dev = state.reward.shape[0], state.reward.device
    return EvalCarry(state=state, sums=torch.zeros(n, device=dev),
                     metric_sums={k: torch.zeros(n, device=dev) for k in state.metrics},
                     length=torch.zeros(n, device=dev), active=torch.ones(n, device=dev))


@torch.no_grad()
def eval_step(eval_env: TrainEnv, normalizer, networks: nets.PPONetworks,
              generator: torch.Generator, carry: EvalCarry, deterministic: bool = False,
              shard: Optional[EnvShard] = None) -> EvalCarry:
    """One step of every eval env, each env's sums masked once it is done.
    The stochastic policy draws its noise from `generator` (at the global
    shape with a shard). The tracer's span ``ppo.eval_step``, a unit."""
    with profiling.span("ppo.eval_step", unit=True):
        return _eval_step(eval_env, normalizer, networks, generator, carry, deterministic, shard)


def _eval_step(eval_env: TrainEnv, normalizer, networks: nets.PPONetworks,
               generator: torch.Generator, carry: EvalCarry, deterministic: bool,
               shard: Optional[EnvShard]) -> EvalCarry:
    """`eval_step`'s body (what EvalStepProgram replays)."""
    state = carry.state
    if deterministic:
        action, _ = networks.make_policy_fn(deterministic=True)((normalizer, networks), state.obs)
    else:
        noise = draw(shard, torch.randn, (eval_env.num_envs, networks.action_size),
                     generator=generator, device=state.reward.device)
        action = nets.sample_actions(networks, normalizer, state.obs, noise)[0]
    state = eval_env.step(state, action)
    active = carry.active
    return EvalCarry(state=state, sums=carry.sums + state.reward * active,
                     metric_sums={k: v + state.metrics[k] * active
                                  for k, v in carry.metric_sums.items()},
                     length=carry.length + active, active=active * (1.0 - state.done))


class EvalStepProgram(Captured):
    """`eval_step` as a device program (utils.graphs.Captured; either
    physics engine, any world size), called as `eval_step` is with the
    eval env's shard: the step of the JAX package's jitted eval scan.
    `run_eval` calls it episode_length // action_repeat times after its
    eager reset. Its body steps a static copy of the carry, which it
    returns (handed back, nothing is copied in); it reads the eval env,
    the generator, the policy and, by address, the params and normalizer
    it was made for, and draws from `generator` (at the global shape with
    a shard) and the eval env's own generator."""

    def __init__(self, eval_env: TrainEnv, normalizer, networks: nets.PPONetworks,
                 generator: torch.Generator, deterministic: bool, log=None):
        shard = _sharded(getattr(eval_env.env, "shard", None))

        @torch.no_grad()
        def body(s):
            carry = s["carry"]
            copy_into(carry, _eval_step(eval_env, normalizer, networks, generator, carry,
                                        deterministic, shard))
            return carry

        gens = eval_env.generators if deterministic else [generator, *eval_env.generators]
        super().__init__(body, [eval_env, generator, bool(deterministic), shard,
                                *_policy_tensors(normalizer, networks)],
                         gens, [*eval_env.kernels, cuda_step.SWISH], eval_env.env.device,
                         "[ppo] eval step", "ppo.eval_step", "one replay per eval step", log)

    def __call__(self, eval_env: TrainEnv, normalizer, networks: nets.PPONetworks,
                 generator: torch.Generator, carry: EvalCarry, deterministic: bool = False,
                 shard: Optional[EnvShard] = None) -> EvalCarry:
        with profiling.span("ppo.eval_step", unit=True):
            return self.run({"carry": carry}, [eval_env, generator, bool(deterministic),
                                               _sharded(shard),
                                               *_policy_tensors(normalizer, networks)])


def make_eval_step(eval_env: TrainEnv, training_state: TrainingState, generator: torch.Generator,
                   deterministic: bool, log=None) -> EvalStepProgram:
    """The eval step train() runs; it logs how it runs."""
    return EvalStepProgram(eval_env, training_state.normalizer, training_state.params, generator,
                           deterministic, log)


@torch.no_grad()
def run_eval(eval_env: TrainEnv, normalizer, networks: nets.PPONetworks,
             generator: torch.Generator, *, episode_length: int, action_repeat: int = 1,
             deterministic: bool = False, shard: Optional[EnvShard] = None,
             step=eval_step) -> Dict[str, torch.Tensor]:
    """One episode of every eval env: reset from `generator`, then
    episode_length // action_repeat calls of `step` (`eval_step`, or an
    EvalStepProgram), each env's sums masked once it is done. The
    stochastic policy draws its noise from `generator`. With a shard,
    `eval_env` holds this rank's rows: the noise is drawn at the global
    shape, and the per-env sums are gathered from every rank before the
    mean and std are taken over all eval envs. The tracer's span
    ``ppo.run_eval``, a unit."""
    with profiling.span("ppo.run_eval", unit=True):
        return _run_eval(eval_env, normalizer, networks, generator, episode_length,
                         action_repeat, deterministic, shard, step)


def _run_eval(eval_env: TrainEnv, normalizer, networks: nets.PPONetworks,
              generator: torch.Generator, episode_length: int, action_repeat: int,
              deterministic: bool, shard: Optional[EnvShard], step) -> Dict[str, torch.Tensor]:
    carry = eval_start(eval_env.reset(generator))
    for _ in range(episode_length // action_repeat):
        carry = step(eval_env, normalizer, networks, generator, carry, deterministic, shard)
    sums, length, metric_sums = carry.sums, carry.length, carry.metric_sums
    if shard is not None and shard.world > 1:
        per_env = shard.all_gather_rows(torch.stack([sums, length, *metric_sums.values()], 1))
        sums, length, *cols = per_env.T.contiguous()
        metric_sums = dict(zip(metric_sums, cols))
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


def _rebuild(template, prefix: str, arrays: Dict[str, np.ndarray]):
    if template is None:
        return None
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
               generators: Dict[str, torch.Generator],
               shard: Optional[EnvShard] = None) -> Dict[str, torch.Tensor]:
    """The whole training state as {name: tensor}, in a fixed order: the
    params and Adam moments by brax path, the normalizer, env_steps, every
    tensor of the env batch (info's first_data / first_obs and the delay
    histories included) and each generator's state. With a shard, the env
    batch is gathered from every rank to its global rows, in rank order
    (a collective: every rank calls this); the replicated parts and the
    generators, equal on every rank, are this rank's. The result does not
    depend on the world size."""
    named = interop.brax_paths(training_state.params)

    def brax(prefix, tensors):
        return {f"{prefix}/{'/'.join(path)}": (t.T if path[-1] == "kernel" else t)
                for (path, _), t in zip(named, tensors)}

    out = brax("training_state/params", [p.detach() for _, p in named])
    tree_leaves(training_state.normalizer, "training_state/normalizer", out)
    opt = training_state.opt_state
    out["training_state/opt_state/count"] = opt.count
    out.update(brax("training_state/opt_state/mu", opt.mu))
    out.update(brax("training_state/opt_state/nu", opt.nu))
    out["training_state/env_steps"] = training_state.env_steps
    env: Dict[str, torch.Tensor] = {}
    tree_leaves(env_state, "env_state", env)
    if shard is not None:
        env = {k: shard.all_gather_rows(v) for k, v in env.items()}
    out.update(env)
    for name, g in generators.items():
        out[f"generators/{name}"] = g.get_state()
    return out


def full_state_to_numpy(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in state.items()}


def restore_full_state(arrays: Dict[str, np.ndarray], training_state: TrainingState,
                       env_state, generators: Dict[str, torch.Generator],
                       shard: Optional[EnvShard] = None):
    """Inverse of `full_state` against templates of the same run: loads the
    params, the Adam state and the normalizer into the template's own
    tensors (a captured SGD step keeps updating them), sets each
    generator's state, and returns (training_state, env_state). With a
    shard, this rank takes its rows of the global env batch, so a state
    saved at any world size restores at any other that divides its envs."""
    if shard is not None:
        arrays = {k: (v[shard.rows(v.shape[0])] if k.startswith("env_state/") else v)
                  for k, v in arrays.items()}

    def tree(prefix):
        return ckpt.unflatten({k[len(prefix) + 1:]: v for k, v in arrays.items()
                               if k.startswith(prefix + "/")})

    nw = training_state.params
    dev = training_state.env_steps.device
    interop.ppo_params_from_numpy(tree("training_state/params"), nw)
    optim.copy_state_(training_state.opt_state,
                      interop.adam_state_from_numpy(tree("training_state/opt_state"), nw, dev))
    copy_into(training_state.normalizer,
               _rebuild(training_state.normalizer, "training_state/normalizer", arrays))
    env_steps = _rebuild(training_state.env_steps, "training_state/env_steps", arrays)
    env_state = _rebuild(env_state, "env_state", arrays)
    for name, g in generators.items():
        g.set_state(torch.as_tensor(arrays[f"generators/{name}"]))
    return training_state.replace(env_steps=env_steps), env_state


def seeded_generators(seed: int, device) -> Dict[str, torch.Generator]:
    """train()'s generators on `device`, one per purpose (GENERATORS), their
    seeds spawned from `seed`."""
    seqs = np.random.SeedSequence(seed).spawn(len(GENERATORS))
    return {name: torch.Generator(device=device).manual_seed(int(s.generate_state(1, np.uint64)[0]))
            for name, s in zip(GENERATORS, seqs)}


def init_training_state(obs_sizes: Dict[str, int], action_size: int,
                        network_factory: Optional[Dict[str, Any]], generator: torch.Generator,
                        device) -> TrainingState:
    """train()'s initial state: the networks drawn from `generator` (its
    "net" generator), a fresh normalizer and Adam state, env_steps 0."""
    network = nets.PPONetworks(obs_sizes, action_size, **(network_factory or {}),
                               generator=generator, device=device)
    return TrainingState(params=network, normalizer=nets.rs_init(obs_sizes, device),
                         opt_state=optim.adam_init(list(network.parameters())),
                         env_steps=torch.zeros((), dtype=torch.int64, device=device))


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
    shard: Optional[EnvShard] = None,
    resume_shared_fs: bool = False,
):
    """Train PPO; returns (make_policy, (normalizer, params), metrics).

    The contract of brax ppo.train as the reference runner consumes it:
    `params[0]` is the obs normalizer, `params[1]` the PPONetworks.
    `device` (default: the env's) is where the learner runs; it must be the
    env's, and a CUDA device must exist: nothing moves to the CPU by itself.

    `shard` (default: the default process group's, rank 0 of 1 without one)
    splits the env batch over the ranks of an env-sharded run: this process
    steps rows `shard.rows(num_envs)` of the train envs and of the eval
    envs, and the learner computes what the one-process trainer computes on
    the global batch (`parallel/dist.py`). Every rank calls train() with the
    same arguments; only rank 0 prints, calls `progress_fn` and
    `policy_params_fn` and writes the full-state checkpoints, while the
    other ranks wait at a barrier. With `auto_resume`, rank 0 finds the
    latest full state and broadcasts its epoch; with `resume_shared_fs`
    (a directory every rank reads alike), every rank finds it itself and
    no collective runs.

    The rollout, the eval step and the SGD step are device programs
    (make_rollout, make_eval_step, make_sgd_step; each logs how it runs):
    on a CUDA device each is replayed as CUDA graphs, captured at its first
    call, and on the CPU each runs its body eagerly. At world > 1 the SGD
    step is a chain of graph segments, its collectives run between them;
    on the general pipeline no graph spans more than one control step
    (RolloutProgram.span).
    """
    if num_envs != batch_size * num_minibatches:
        raise ValueError("brax-PPO layout requires num_envs == batch_size * num_minibatches")
    dev = _canonical(device if device is not None else environment.device)
    if _canonical(environment.device) != dev:
        raise ValueError(f"the env runs on {environment.device}, the learner on {dev}")
    shard = shard if shard is not None else current_shard(dev)
    log = functools.partial(print, flush=True) if shard.is_main else (lambda *a, **k: None)
    # the envs draw at the global shape and keep this rank's rows
    environment.shard = shard
    if eval_env is not None:
        eval_env.shard = shard

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

    train_env = TrainEnv(environment, num_envs=shard.local(num_envs),
                         episode_length=episode_length, action_repeat=action_repeat,
                         randomization_fn=randomization_fn, randomization_generator=g_rand)

    obs_sizes = {k: v[0] for k, v in environment.observation_size.items()}
    action_size = environment.action_size
    training_state = init_training_state(obs_sizes, action_size, network_factory, g_net, dev)
    network = training_state.params
    if restore_checkpoint_path is not None:
        normalizer, network = ckpt.load(restore_checkpoint_path,
                                        (training_state.normalizer, network))
        training_state = training_state.replace(
            params=network, normalizer=normalizer,
            opt_state=optim.adam_init(list(network.parameters())))

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
                training_state, train_env, env_state, draws, hp, shard, sgd, roll)
            step_metrics.append(m)
        metrics = {k: torch.stack([m[k] for m in step_metrics]).mean() for k in step_metrics[0]}
        return training_state, env_state, metrics

    eval_wrapped = None
    if eval_env is not None:
        eval_wrapped = TrainEnv(eval_env, num_envs=shard.local(num_eval_envs),
                                episode_length=episode_length, action_repeat=action_repeat,
                                randomization_fn=None)

    def evaluate(full_params):
        normalizer, params = full_params
        return run_eval(eval_wrapped, normalizer, params, g_eval,
                        episode_length=episode_length, action_repeat=action_repeat,
                        deterministic=deterministic_eval, shard=shard, step=eval_fn)

    # ------------------------------------------------------------------
    # main loop
    # ------------------------------------------------------------------
    t0 = time.monotonic()
    env_state = train_env.reset(g_reset)
    _sync(dev)
    log(f"[ppo] env reset ({num_envs} envs, {train_env.num_envs} on each of {shard.world} "
        f"ranks) ran in {time.monotonic() - t0:.1f}s")

    generators = {"epoch": g_epoch, "env": environment.generator}
    if eval_env is not None:
        generators.update(eval=g_eval, eval_env=eval_env.generator)

    def replicated():
        """What every rank holds alike, by group, for the per-epoch check."""
        opt, norm = training_state.opt_state, {}
        tree_leaves(training_state.normalizer, "normalizer", norm)
        return {"params": list(training_state.params.parameters()),
                "adam": [opt.count, *opt.mu, *opt.nu],
                "normalizer": list(norm.values()),
                "env_steps": [training_state.env_steps],
                "generators": [g.get_state() for g in generators.values()]}

    start_epoch = 0
    if auto_resume and save_full_state_dir is not None:
        if resume_shared_fs:
            # every rank reads the same directory and decides alike: no collective
            found = ckpt.latest_full(save_full_state_dir)
            resume_epoch = -1 if found is None else found[0]
        else:
            # rank 0 decides; every rank reads the same file and takes its rows
            found = ckpt.latest_full(save_full_state_dir) if shard.is_main else None
            resume_epoch = int(shard.broadcast(torch.tensor(-1 if found is None else found[0],
                                                            device=shard.device)))
        if resume_epoch >= 0:
            resume_path = ckpt.full_path(save_full_state_dir, resume_epoch)
            training_state, env_state = restore_full_state(
                ckpt.load_full(resume_path), training_state, env_state, generators, shard)
            start_epoch = resume_epoch + 1
            log(f"[ppo] resumed full train state from {resume_path} (epoch "
                f"{resume_epoch}, env_steps {int(training_state.env_steps)})")

    # after any restore: the captured programs read and update this
    # state's own tensors
    sgd = make_sgd_step(training_state, hp, shard, log)
    roll = make_rollout(train_env, training_state, hp, log)
    eval_fn = (make_eval_step(eval_wrapped, training_state, g_eval, deterministic_eval, log)
               if eval_wrapped is not None else None)

    def _save_full_state(epoch_i: int, directory: Optional[str] = save_full_state_dir):
        if directory is None:
            return
        t_g = time.monotonic()
        arrays = full_state_to_numpy(full_state(training_state, env_state, generators, shard))
        t_g = time.monotonic() - t_g
        if shard.is_main:
            try:
                t_w = time.monotonic()
                ckpt.save_full(directory, epoch_i, arrays, keep=keep_full_states)
                t_w = time.monotonic() - t_w
                log(f"[ppo] full-state save epoch {epoch_i}: host copy {t_g:.2f}s "
                    f"write {t_w:.2f}s")
            except OSError as e:  # keep training alive if the save breaks
                log(f"[ppo] full-state checkpoint failed: {e}")
        shard.barrier()

    metrics: Dict[str, float] = {}

    def _eval_and_report(step_count: int):
        if eval_wrapped is not None:
            t0 = time.monotonic()
            eval_metrics = evaluate((training_state.normalizer, training_state.params))
            # merge, don't replace: the caller just wrote training/* metrics
            # (sps, losses) into `metrics` and progress_fn must see both
            metrics.update({k: float(v) for k, v in eval_metrics.items()})
            log(f"[ppo] eval rollout done in {time.monotonic() - t0:.1f}s")
        if shard.is_main:
            if progress_fn is not None:
                progress_fn(step_count, metrics)
            if policy_params_fn is not None:
                policy_params_fn(step_count, make_policy,
                                 (training_state.normalizer, training_state.params))
        shard.barrier()

    if profile_breakdown:
        # Time the real rollout, SGD step and eval step (the ones the loop
        # runs: on the card at world 1, their graphs, each captured by the
        # first of these calls), training step, eval and full-state save,
        # each run twice and timed the second time. Training is left as it
        # is: the policy noise and SGD draws come from a throwaway generator;
        # the generators the envs and the eval draw from (those the graphs
        # registered) are restored afterwards, and so are the env state (a
        # captured rollout steps its buffers in place: the loop resumes from
        # a copy taken before) and the learner's tensors (the SGD steps
        # update them in place); outputs are dropped. Every rank runs the
        # same passes, so the collectives stay in step.
        def _timed(fn):
            fn()
            _sync(dev)
            t = time.monotonic()
            out = fn()
            _sync(dev)
            return time.monotonic() - t, out

        gen_states = {k: g.get_state() for k, g in generators.items()
                      if k in ("env", "eval", "eval_env")}
        saved_env = clone_tree(env_state)
        draws0 = draw_training_step(torch.Generator(device=dev).manual_seed(0xB0), hp,
                                    action_size, dev)
        bd: Dict[str, Any] = {"num_envs": num_envs, "unroll_length": unroll_length,
                              "env_steps_per_training_step": env_step_per_training_step}
        if shard.world > 1:
            bd.update(world=shard.world, rank=shard.rank, device=str(dev),
                      num_envs_per_rank=train_env.num_envs)
        t_roll, (_, data0) = _timed(lambda: roll(
            train_env, env_state, training_state.normalizer, training_state.params,
            shard.take(draws0[0], dim=1)))
        bd["rollout_s"] = round(t_roll, 4)
        bd["rollout_env_sps"] = round(num_envs * unroll_length / t_roll, 1)
        bd["rollout_graph"] = roll.info
        saved = snapshot_learner(training_state)
        t_sgd, _ = _timed(lambda: sgd(training_state, data0, draws0[1], draws0[2], hp, shard))
        bd["sgd_s"] = round(t_sgd, 4)
        bd["sgd_graph"] = sgd.info
        if shard.world > 1:
            # once more under the tracer: the collectives within an SGD step
            # and the host time of their dist.collective spans
            n0 = shard.collectives
            with profiling.sample() as host_ms:
                sgd(training_state, data0, draws0[1], draws0[2], hp, shard)
            bd["sgd_collectives"] = shard.collectives - n0
            bd["sgd_collective_s"] = round(host_ms.get("dist.collective", 0.0) / 1e3, 4)
        t_step, _ = _timed(lambda: training_step(training_state, train_env, env_state, draws0,
                                                 hp, shard, sgd, roll))
        bd["training_step_s"] = round(t_step, 4)
        bd["e2e_env_sps"] = round(env_step_per_training_step / t_step, 1)
        restore_learner(training_state, saved)
        del data0, draws0, saved
        if eval_wrapped is not None:
            t_eval, _ = _timed(lambda: evaluate((training_state.normalizer,
                                                 training_state.params)))
            bd["eval_s"] = round(t_eval, 4)
            bd["eval_graph"] = eval_fn.info
        for k, s in gen_states.items():
            generators[k].set_state(s)
        env_state = saved_env
        del saved_env
        if save_full_state_dir is not None:
            # into a scratch directory, deleted after: full_<n>.npz only ever
            # holds the state after epoch n, which auto_resume relies on
            scratch = os.path.join(save_full_state_dir, "profile_breakdown")
            t0p = time.monotonic()
            _save_full_state(start_epoch, scratch)
            bd["full_state_save_s"] = round(time.monotonic() - t0p, 4)
            if shard.is_main:
                shutil.rmtree(scratch, ignore_errors=True)
        bd["num_training_steps_per_epoch"] = num_training_steps_per_epoch
        global LAST_PROFILE_BREAKDOWN
        LAST_PROFILE_BREAKDOWN = bd
        log(f"[ppo] profile_breakdown {json.dumps(bd)}")

    if start_epoch == 0:
        _eval_and_report(0)

    walltimes = []
    log(f"[ppo] entering training loop: {num_evals_after_init} epochs x "
        f"{num_training_steps_per_epoch} training steps")
    for epoch_i in range(start_epoch, num_evals_after_init):
        t0 = time.monotonic()
        training_state, env_state, train_metrics = training_epoch(training_state, env_state)
        _sync(dev)
        walltimes.append(time.monotonic() - t0)
        shard.assert_replicated(replicated())
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
            log(f"[ppo] stop_after_epochs={stop_after_epochs}: stopping "
                f"after epoch {epoch_i}")
            break

    for name, fn in (("rollout", roll), ("eval step", eval_fn), ("SGD step", sgd)):
        if fn is not None:
            log(f"[ppo] {name}: {fn.replays} replays")
    full_params = (training_state.normalizer, training_state.params)
    return make_policy, full_params, metrics
