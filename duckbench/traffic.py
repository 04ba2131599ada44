"""The one generator of every traffic mix: seeds, weights and draws.

A mix is a data file (``traffic/<name>.json``) with a ``loop`` ("train":
back-to-back PPO training steps; "eval": back-to-back eval episodes) and the
parameters of its correctness check and traced window. Everything random in
a run comes from ``--seed`` through ``seeds``: the networks' weights (made
here, on the device, in one draw), the domain randomization, the resets,
the envs' own streams and the generator from which the port's own draw
step (``ppo.draw_training_step``) makes each training step's draws. The
same seed gives the same inputs.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

PURPOSES = ("weights", "normalizer", "randomization", "reset", "env", "draws", "eval", "sample")


def seeds(seed: int) -> Dict[str, int]:
    """One 63-bit seed per purpose, spawned from `seed` (any whole number >= 0)."""
    seqs = np.random.SeedSequence(int(seed)).spawn(len(PURPOSES))
    return {p: int(s.generate_state(1, np.uint64)[0] >> np.uint64(1))
            for p, s in zip(PURPOSES, seqs)}


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def weights(seed: int, shapes: List[tuple], device) -> List[torch.Tensor]:
    """The networks' weights and biases in float32 on `device`, from one
    uniform draw: a weight [out, in] is U(-sqrt(3/in), sqrt(3/in)) (lecun
    uniform), a bias U(-0.05, 0.05)."""
    total = sum(math.prod(s) for s in shapes)
    u = torch.rand(total, generator=generator(seed, device), device=device) * 2.0 - 1.0
    out, at = [], 0
    for s in shapes:
        n = math.prod(s)
        scale = math.sqrt(3.0 / s[1]) if len(s) == 2 else 0.05
        out.append((u[at:at + n] * scale).reshape(s))
        at += n
    return out


def normalizer_stats(seed: int, sizes: Dict[str, int], device) -> Dict[str, tuple]:
    """An observation normalizer's (mean, std) per key, for the eval loop's
    policy: mean U(-0.5, 0.5), std U(0.5, 2.0)."""
    g = generator(seed, device)
    out = {}
    for k in sorted(sizes):
        u = torch.rand((2, sizes[k]), generator=g, device=device)
        out[k] = (u[0] - 0.5, 0.5 + 1.5 * u[1])
    return out


def sample(seed: int, n: int, k: int) -> List[int]:
    """`k` distinct sorted indices of range(n), from `seed`."""
    rng = np.random.default_rng(seed)
    return sorted(int(i) for i in rng.choice(n, size=min(k, n), replace=False))
