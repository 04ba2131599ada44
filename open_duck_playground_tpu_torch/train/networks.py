"""Policy/value networks, tanh-squashed Normal policy, running obs stats.

Counterpart of the JAX package's ``train/networks.py`` (Brax PPO semantics):
lecun-uniform MLPs with swish activation (on CUDA tensors two hand-written
kernels, ``swish``), a 2*act_size policy head read as
(loc, pre-softplus scale) of a tanh-squashed Normal (min_std 0.001), running
mean/std obs normalization over every obs key, asymmetric actor ("state") /
critic ("privileged_state") observations, deterministic action tanh(loc).

Every random draw is an argument: the sampling and entropy functions take
their standard-normal noise as a tensor, and the init takes a
``torch.Generator``. A ``Linear``'s ``weight`` is the transpose of the brax
``kernel`` (``interop.ppo_params_to_numpy`` gives the brax layout).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.autograd.function import once_differentiable

from open_duck_playground_tpu_torch.ops import cuda_step
from open_duck_playground_tpu_torch.parallel.dist import Collectives, EnvShard, run_points
from open_duck_playground_tpu_torch.train.optim import PlainSteps
from open_duck_playground_tpu_torch.utils import profiling

_MIN_STD = 0.001
_LOG_2PI = math.log(2.0 * math.pi)
_LOG_2 = math.log(2.0)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: log(1 + exp(x)). torch's threshold (x itself above 20)
    differs from it by < exp(-20) ~ 2e-9, under half an ulp of x in float32."""
    return F.softplus(x, beta=1.0, threshold=20.0)


# ---------------------------------------------------------------------------
# Swish and the MLP
# ---------------------------------------------------------------------------


class _FusedSwish(torch.autograd.Function):
    """swish by the two kernels of ``ops/csrc/swish.cu``: the forward saves x
    alone, the backward recomputes sigmoid(x) from it."""

    @staticmethod
    def forward(ctx, x):
        x = x.contiguous()
        ctx.save_for_backward(x)
        return cuda_step.swish_forward(x)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return cuda_step.swish_backward(g.contiguous(), x)


# swish's calls on the plain expression (the CPU's path); a fused call is
# one launch of either kernel, counted where it launches
SWISH_PLAIN = PlainSteps()
profiling.watch(SWISH_PLAIN, "steps", "swish.plain_calls")
profiling.watch(cuda_step.SWISH, "launches", "swish.fused_calls")


def swish(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)``. CPU tensors run that expression (the tracer's
    ``swish.plain_calls``); CUDA tensors one launch of the swish's forward
    kernel, and one of its backward kernel in the backward pass
    (``cuda_step.swish_forward`` / ``swish_backward``, ``swish.fused_calls``),
    with torch's forward and autograd's gradient bit for bit."""
    if x.device.type != "cuda":
        SWISH_PLAIN.steps += 1
        return x * torch.sigmoid(x)
    return _FusedSwish.apply(x)


class MLP(nn.Module):
    """``hidden_0`` ... ``hidden_{n-1}`` Linear layers, swish between them."""

    def __init__(self, sizes: Sequence[int], generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.sizes = list(sizes)
        for i in range(len(sizes) - 1):
            layer = nn.Linear(sizes[i], sizes[i + 1], device=device)
            self.add_module(f"hidden_{i}", layer)
        if generator is not None:
            self.lecun_init_(generator)

    @property
    def layers(self):
        return [getattr(self, f"hidden_{i}") for i in range(len(self.sizes) - 1)]

    @torch.no_grad()
    def lecun_init_(self, generator: torch.Generator) -> None:
        """Kernels ~ U(-sqrt(3/fan_in), sqrt(3/fan_in)) drawn in the brax
        (in, out) layout, layer by layer; biases zero."""
        for layer in self.layers:
            fan_in, fan_out = layer.in_features, layer.out_features
            scale = math.sqrt(3.0 / fan_in)
            u = torch.rand((fan_in, fan_out), generator=generator,
                           device=layer.weight.device)
            layer.weight.copy_((2.0 * u - 1.0).mul_(scale).T)
            layer.bias.zero_()

    def forward(self, x: torch.Tensor, activate_final: bool = False) -> torch.Tensor:
        layers = self.layers
        for i, layer in enumerate(layers):
            x = layer(x)
            if i < len(layers) - 1 or activate_final:
                x = swish(x)
        return x


# ---------------------------------------------------------------------------
# Tanh-squashed Normal action distribution (brax NormalTanhDistribution)
# ---------------------------------------------------------------------------


def dist_create(logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    loc, scale = torch.chunk(logits, 2, dim=-1)
    return loc, softplus(scale) + _MIN_STD


def dist_sample_no_postprocess(loc, scale, noise: torch.Tensor) -> torch.Tensor:
    """`noise`: standard-normal draws of loc's shape."""
    return loc + scale * noise


def dist_postprocess(raw: torch.Tensor) -> torch.Tensor:
    return torch.tanh(raw)


def _tanh_log_det(raw: torch.Tensor) -> torch.Tensor:
    # log |d tanh(x)/dx| = 2 (log2 - x - softplus(-2x))
    return 2.0 * (_LOG_2 - raw - softplus(-2.0 * raw))


def dist_log_prob(loc, scale, raw_sample) -> torch.Tensor:
    """log prob of the tanh-squashed sample, parameterized by the raw sample."""
    log_unnormalized = -0.5 * torch.square((raw_sample - loc) / scale)
    log_normalization = 0.5 * _LOG_2PI + torch.log(scale)
    log_prob = log_unnormalized - log_normalization
    return torch.sum(log_prob - _tanh_log_det(raw_sample), dim=-1)


def dist_entropy(loc, scale, noise: torch.Tensor) -> torch.Tensor:
    """Normal entropy plus a single-sample tanh log-det correction (brax);
    `noise` is the sample's standard-normal draw."""
    entropy = 0.5 + 0.5 * _LOG_2PI + torch.log(scale)
    raw = dist_sample_no_postprocess(loc, scale, noise)
    return torch.sum(entropy + _tanh_log_det(raw), dim=-1)


# ---------------------------------------------------------------------------
# Running statistics (Welford over batches, brax running_statistics semantics)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RunningStatisticsState:
    count: torch.Tensor  # () float32
    mean: Dict[str, torch.Tensor]
    summed_variance: Dict[str, torch.Tensor]
    std: Dict[str, torch.Tensor]

    def replace(self, **updates) -> "RunningStatisticsState":
        return dataclasses.replace(self, **updates)


def rs_init(obs_sizes: Dict[str, int], device=None) -> RunningStatisticsState:
    """A fresh state; every tensor its own (the SGD step updates them in place)."""
    def zeros():
        return {k: torch.zeros(v, device=device) for k, v in obs_sizes.items()}

    return RunningStatisticsState(
        count=torch.zeros((), device=device), mean=zeros(), summed_variance=zeros(),
        std={k: torch.ones(v, device=device) for k, v in obs_sizes.items()})


@torch.no_grad()
def rs_update(state: RunningStatisticsState, batch: Dict[str, torch.Tensor], *,
              std_min_value: float = 1e-6, std_max_value: float = 1e6,
              shard: Optional[EnvShard] = None) -> RunningStatisticsState:
    """Welford update over all leading batch dims of each obs key. With a
    shard, `batch` is this rank's equal share of a global batch, and the
    statistics are the global batch's: its count, and two sum all-reduces
    per key (the sum of diff_to_old for the new mean, then the sum of
    diff_to_old * diff_to_new). Runs `rs_update_points` eagerly."""
    points = Collectives(shard) if shard is not None and shard.world > 1 else None
    return run_points(rs_update_points(state, batch, points, std_min_value=std_min_value,
                                       std_max_value=std_max_value), shard)


def rs_update_points(state: RunningStatisticsState, batch: Dict[str, torch.Tensor],
                     points: Optional[Collectives] = None, *, std_min_value: float = 1e-6,
                     std_max_value: float = 1e6):
    """`rs_update` as a generator with its collective points: with `points`
    (world > 1) it yields, per obs key, the buffer of the sum of
    diff_to_old and then that of diff_to_old * diff_to_new, each to be
    summed over the ranks (dist.run_points, or between two graph segments);
    returns the new state. Without, it yields nothing."""
    world = 1 if points is None else points.shard.world
    first = next(iter(batch.values()))
    batch_size = math.prod(first.shape[:-1]) * world
    count = state.count + batch_size
    means, svars, stds = {}, {}, {}
    for k, data in batch.items():
        dims = tuple(range(data.dim() - 1))
        diff_to_old = data - state.mean[k]
        summed = torch.sum(diff_to_old, dim=dims)
        if points is not None:
            summed = yield from points.total(f"normalizer/mean/{k}", summed)
        mean_new = state.mean[k] + summed / count
        diff_to_new = data - mean_new
        summed = torch.sum(diff_to_old * diff_to_new, dim=dims)
        if points is not None:
            summed = yield from points.total(f"normalizer/variance/{k}", summed)
        svar = state.summed_variance[k] + summed
        svar = torch.clamp_min(svar, 0.0)
        means[k], svars[k] = mean_new, svar
        stds[k] = torch.clamp(torch.sqrt(svar / count), std_min_value, std_max_value)
    return RunningStatisticsState(count=count, mean=means, summed_variance=svars, std=stds)


def rs_normalize(state: RunningStatisticsState, obs: Dict[str, torch.Tensor]):
    return {k: (v - state.mean[k]) / state.std[k] for k, v in obs.items()}


# ---------------------------------------------------------------------------
# PPO networks bundle
# ---------------------------------------------------------------------------


class PPONetworks(nn.Module):
    """The policy and value MLPs, with the obs keys each reads."""

    def __init__(
        self,
        obs_sizes: Dict[str, int],
        action_size: int,
        policy_hidden_layer_sizes: Sequence[int] = (512, 256, 128),
        value_hidden_layer_sizes: Sequence[int] = (512, 256, 128),
        policy_obs_key: str = "state",
        value_obs_key: str = "privileged_state",
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        """With a `generator`, the policy's kernels are drawn first, then the
        value's (lecun-uniform); without one, torch's default init."""
        super().__init__()
        self.obs_sizes = dict(obs_sizes)
        self.action_size = action_size
        self.policy_obs_key = policy_obs_key
        self.value_obs_key = value_obs_key
        self.policy = MLP([obs_sizes[policy_obs_key], *policy_hidden_layer_sizes,
                           2 * action_size], generator, device)
        self.value = MLP([obs_sizes[value_obs_key], *value_hidden_layer_sizes, 1],
                         generator, device)

    def policy_logits(self, normalizer: RunningStatisticsState, obs) -> torch.Tensor:
        k = self.policy_obs_key
        return self.policy((obs[k] - normalizer.mean[k]) / normalizer.std[k])

    def value_fn(self, normalizer: RunningStatisticsState, obs) -> torch.Tensor:
        k = self.value_obs_key
        return self.value((obs[k] - normalizer.mean[k]) / normalizer.std[k])[..., 0]

    def make_policy_fn(self, deterministic: bool = False):
        """policy(full_params=(normalizer, PPONetworks), obs, generator) ->
        (action, extras), as brax make_policy; the stochastic policy draws
        its noise from `generator`."""

        @torch.no_grad()
        def policy(full_params, obs, generator: Optional[torch.Generator] = None):
            normalizer, nets = full_params
            if deterministic:
                loc, _ = dist_create(nets.policy_logits(normalizer, obs))
                return torch.tanh(loc), {}
            x = obs[nets.policy_obs_key]
            noise = torch.randn(x.shape[:-1] + (nets.action_size,), generator=generator,
                                device=x.device)
            action, raw, log_prob = sample_actions(nets, normalizer, obs, noise)
            return action, {"raw_action": raw, "log_prob": log_prob}

        return policy


@torch.no_grad()
def sample_actions(networks: PPONetworks, normalizer, obs, noise: torch.Tensor):
    """The stochastic policy with its standard-normal noise given:
    (tanh(raw), raw, log_prob of raw)."""
    loc, scale = dist_create(networks.policy_logits(normalizer, obs))
    raw = dist_sample_no_postprocess(loc, scale, noise)
    return torch.tanh(raw), raw, dist_log_prob(loc, scale, raw)
