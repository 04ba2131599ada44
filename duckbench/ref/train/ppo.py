"""PPO's rollout policy, loss and SGD step at one process (Brax-PPO
semantics).

A frozen copy of the world-size-1 path of the port's ``train/ppo.py``
(``compute_gae``, ``loss_points``, ``sgd_points``, ``sample_actions``),
for the benchmark's plain reference: every random draw is an argument, the
normalizer update comes first, then num_updates_per_batch epochs of
num_minibatches Adam steps over the permuted envs, with optax's
global-norm clip. The learner's params, Adam state and normalizer are
updated in place, as in the port."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from duckbench.ref.train import networks as nets
from duckbench.ref.train import optim


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
class Hyper:
    num_envs: int
    unroll_length: int
    num_minibatches: int
    batch_size: int
    num_updates_per_batch: int
    learning_rate: float
    entropy_cost: float
    discounting: float
    gae_lambda: float
    clipping_epsilon: float
    normalize_advantage: bool
    reward_scaling: float
    normalize_observations: bool
    max_grad_norm: Optional[float]


@dataclasses.dataclass
class Learner:
    """What an SGD step updates: the networks (in place), the Adam state
    (in place) and the normalizer (replaced)."""

    params: nets.PPONetworks
    normalizer: nets.RunningStatisticsState
    opt_state: optim.AdamState


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


def _map(fn, data: Transition) -> Transition:
    return Transition(**{
        f.name: ({k: fn(v) for k, v in getattr(data, f.name).items()}
                 if isinstance(getattr(data, f.name), dict) else fn(getattr(data, f.name)))
        for f in dataclasses.fields(Transition)})


def sgd_step(learner: Learner, data: Transition, perms: torch.Tensor,
             entropy_noise: torch.Tensor, hp: Hyper) -> Dict[str, torch.Tensor]:
    """Normalizer update from the whole rollout, then num_updates_per_batch
    epochs of num_minibatches Adam steps. `perms` [epochs, num_envs]: minibatch
    j of epoch e takes envs perms[e, j*b:(j+1)*b] at every t; `entropy_noise`
    [epochs, nmb, T, b, action_size]. Updates `learner`; returns {name:
    [epochs, nmb] losses}."""
    if hp.normalize_observations:
        learner.normalizer = nets.rs_update(learner.normalizer, data.observation)
    networks, normalizer = learner.params, learner.normalizer
    params = list(networks.parameters())
    E, nmb, b = hp.num_updates_per_batch, hp.num_minibatches, hp.batch_size
    aux = []
    for e in range(E):
        for j in range(nmb):
            idx = perms[e, j * b:(j + 1) * b]
            mb = _map(lambda x: x.index_select(1, idx), data)
            total, mb_aux = loss_fn(networks, normalizer, mb, entropy_noise[e, j], hp)
            grads = torch.autograd.grad(total, params)
            if hp.max_grad_norm is not None:
                grads = optim.clip_by_global_norm(grads, hp.max_grad_norm)
            optim.adam(params, grads, learner.opt_state, hp.learning_rate)
            aux.append(mb_aux)
    return {k: torch.stack([a[k] for a in aux]).reshape(E, nmb) for k in aux[0]}
