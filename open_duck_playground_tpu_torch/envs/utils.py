"""Small env utilities (the JAX package's ``envs/utils.py``, for torch)."""

from __future__ import annotations

import torch


class LowPassActionFilter:
    """First-order low-pass filter on actions.

    The reference ships this but keeps every call site commented out; it is
    provided for the same opt-in experimentation. The state is kept as
    tensors (python 0 until the first push).
    """

    def __init__(self, control_freq: float, cutoff_frequency: float = 30.0):
        self.last_action = 0
        self.current_action = 0
        self.control_freq = float(control_freq)
        self.cutoff_frequency = float(cutoff_frequency)
        self.alpha = self.compute_alpha()

    def compute_alpha(self) -> float:
        return (1.0 / self.cutoff_frequency) / (
            1.0 / self.control_freq + 1.0 / self.cutoff_frequency
        )

    def push(self, action: torch.Tensor) -> None:
        self.current_action = torch.as_tensor(action).clone()

    def get_filtered_action(self) -> torch.Tensor:
        self.last_action = (
            self.alpha * self.last_action + (1 - self.alpha) * self.current_action
        )
        return self.last_action
