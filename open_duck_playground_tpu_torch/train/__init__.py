"""Training stack: networks, PPO, checkpoints, the runner CLI."""
