"""What the per-layer metrics' readers (``metrics/<name>.py``) share: each
takes one number from the run's context and returns None where the run has
nothing to read (another loop, no trace, no launch of the kernel)."""

from __future__ import annotations

import statistics
from typing import Optional

from duckbench import roofline


def mean_ms(ctx: dict, part: str) -> Optional[float]:
    """The mean milliseconds of one part of the window's units (CUDA events)."""
    ms = ctx["spans"].get(part)
    return statistics.fmean(ms) if ms else None


def kernel_roofline(ctx: dict, loop: str) -> Optional[float]:
    """The fused physics kernel's share of its roofline: its least time at
    the loop's rows and substeps over its device time per launch in the
    traced window."""
    t = ctx["trace"]
    if ctx["loop"] != loop or not t or not t["kernel_launches"] or t["kernel_s"] <= 0:
        return None
    cfg = ctx["cfg"]
    train = loop == "train"
    rows = cfg["ppo"]["num_envs"] if train else cfg["ppo"]["num_eval_envs"]
    dr = cfg["domain_randomization"] and train
    bound = roofline.kernel_bound_s(cfg["counts"], dr, rows, cfg["n_substeps"])["bound_s"]
    return 100.0 * bound / (t["kernel_s"] / t["kernel_launches"])


def step_mfu(ctx: dict, loop: str) -> Optional[float]:
    """The counted work of the window's units over the window's time at the
    card's float32 peak."""
    if ctx["loop"] != loop or not ctx["units"]:
        return None
    flops = ctx["flops_per_unit"]["total"] * ctx["units"]
    return 100.0 * flops / (ctx["window_s"] * roofline.PEAK_F32_FLOPS)
