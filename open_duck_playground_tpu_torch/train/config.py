"""PPO hyperparameter presets.

Counterpart of the JAX package's ``train/config.py``: the same keys and
values, on the port's ``utils.config.Config``. Every field is
CLI-overridable through the runner.
"""

from __future__ import annotations

from open_duck_playground_tpu_torch.utils.config import Config


def brax_ppo_config(env_name: str = "BerkeleyHumanoidJoystickFlatTerrain") -> Config:
    """The recipe the reference trains with, whatever `env_name` names."""
    del env_name
    return Config(
        num_timesteps=150_000_000,
        num_evals=15,
        reward_scaling=1.0,
        episode_length=1000,
        normalize_observations=True,
        action_repeat=1,
        unroll_length=20,
        num_minibatches=32,
        num_updates_per_batch=4,
        discounting=0.97,
        learning_rate=3e-4,
        entropy_cost=5e-3,
        num_envs=8192,
        batch_size=256,
        max_grad_norm=1.0,
        clipping_epsilon=0.2,
        gae_lambda=0.95,
        normalize_advantage=True,
        num_eval_envs=128,
        deterministic_eval=False,
        network_factory=dict(
            policy_hidden_layer_sizes=(512, 256, 128),
            value_hidden_layer_sizes=(512, 256, 128),
            policy_obs_key="state",
            value_obs_key="privileged_state",
        ),
    )
