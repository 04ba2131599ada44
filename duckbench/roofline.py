"""Peaks of the card and the work of a step, counted from a configuration.

The fused physics kernel's bound is ``chip_smoke.py``'s ``step_bound``: the
larger of its arithmetic over the float32 peak and the bytes it has to move
(state in, DR fields, heightfield table, outputs, each once) over the
memory rate. Its arithmetic per env and substep is frozen in each
configuration's file (``counts``), made once by ``counts.py`` from the plain
reference's physics, so that the yardstick does not move with the port.

The networks' work is counted from their shapes: 2 operations per
multiply-add of every Linear layer; the backward pass adds the weight
gradient and, for every layer but the first (the observations take no
gradient), the input gradient, each as many operations as the forward.
Elementwise work (activations, the loss, Adam) is not counted.
"""

from __future__ import annotations

from typing import Dict, Sequence

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores; HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
FUSED_KERNEL = "physics_step_kernel"  # the __global__ of the port's ops/csrc/physics_step.cu


def kernel_bound_s(counts: Dict, dr: bool, rows: int, n_substeps: int) -> dict:
    """The least time one launch of the fused step could take at `rows` envs
    and `n_substeps`, with (`dr`) or without domain randomization."""
    key = "dr" if dr else "nominal"
    flops = counts["physics_flops_per_env_substep"][key] * rows * n_substeps
    words = counts["physics_words_per_env"][key]
    nbytes = 4 * (rows * words + counts["hfield_floats"])
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return dict(flops=flops, bytes=nbytes, bound_s=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def mlp_layers(in_size: int, hidden: Sequence[int], out_size: int):
    sizes = [in_size, *hidden, out_size]
    return list(zip(sizes[:-1], sizes[1:]))


def mlp_forward(layers) -> float:
    return float(sum(2 * i * o for i, o in layers))


def mlp_backward(layers) -> float:
    """Weight gradients of every layer, input gradients of all but the first."""
    return float(sum(2 * i * o for i, o in layers) + sum(2 * i * o for i, o in layers[1:]))


def networks(cfg: dict):
    obs, net, act = cfg["obs_sizes"], cfg["network"], cfg["action_size"]
    policy = mlp_layers(obs[net["policy_obs_key"]], net["policy_hidden_layer_sizes"], 2 * act)
    value = mlp_layers(obs[net["value_obs_key"]], net["value_hidden_layer_sizes"], 1)
    return policy, value


def training_step_flops(cfg: dict) -> Dict[str, float]:
    """Counted operations of one training step: the rollout's physics and
    policy, and the SGD step's forward and backward passes."""
    ppo = cfg["ppo"]
    B, T = ppo["num_envs"], ppo["unroll_length"]
    policy, value = networks(cfg)
    physics = (cfg["counts"]["physics_flops_per_env_substep"]["dr" if cfg["domain_randomization"]
                                                             else "nominal"]
               * B * cfg["n_substeps"] * T)
    rollout_policy = mlp_forward(policy) * B * T
    rows = T * ppo["batch_size"]  # one minibatch
    per_mb = (rows * (mlp_forward(policy) + mlp_backward(policy) + mlp_forward(value)
                      + mlp_backward(value))
              + ppo["batch_size"] * mlp_forward(value))  # the bootstrap value, no gradient
    sgd = per_mb * ppo["num_minibatches"] * ppo["num_updates_per_batch"]
    return dict(physics=physics, rollout_policy=rollout_policy, sgd=sgd,
                total=physics + rollout_policy + sgd)


def eval_step_flops(cfg: dict) -> Dict[str, float]:
    """Counted operations of one eval step: physics (no domain
    randomization) and the policy's forward pass at the eval envs."""
    B = cfg["ppo"]["num_eval_envs"]
    policy, _ = networks(cfg)
    physics = cfg["counts"]["physics_flops_per_env_substep"]["nominal"] * B * cfg["n_substeps"]
    pol = mlp_forward(policy) * B
    return dict(physics=physics, policy=pol, total=physics + pol)
