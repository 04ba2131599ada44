"""Environment State (mujoco_playground's mjx_env.State), batched."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from duckbench.ref.ops.types import Data

Observation = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class State:
    """Env state of a batch of envs; every tensor has a leading env dim."""

    data: Data
    obs: Observation
    reward: torch.Tensor  # (B,)
    done: torch.Tensor  # (B,)
    metrics: Dict[str, torch.Tensor]
    info: Dict[str, Any]

    def replace(self, **updates) -> "State":
        return dataclasses.replace(self, **updates)
