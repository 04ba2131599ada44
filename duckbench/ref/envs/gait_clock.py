"""Command-conditioned gait-clock law (the JAX package's, for torch).

The constants (vx_ref, f_max) are trained in and shipped with the policy,
so training and deploy run one law.
"""

from __future__ import annotations

import numpy as np
import torch


def phase_frequency_from_command(cmd_vx, vx_ref: float, f_max: float):
    """Command-conditioned gait-clock factor: clip(|vx| / vx_ref, 1, f_max).

    vx_ref <= 0 disables the law (factor 1.0 — reference parity). Works on
    torch tensors (training) and numpy scalars (deploy).
    """
    if isinstance(cmd_vx, torch.Tensor):
        if vx_ref <= 0.0:
            return torch.ones_like(cmd_vx)
        return torch.clamp(cmd_vx.abs() / vx_ref, 1.0, f_max)
    if vx_ref <= 0.0:
        return np.float32(1.0)
    return np.clip(np.abs(cmd_vx) / vx_ref, 1.0, f_max).astype(np.float32)
