"""Mean milliseconds of rank 0's rollout call (a RolloutProgram replay over
its 2048 rows), CUDA events around the call, over the window's units (the
world-4 cell)."""

from duckbench.readers import mean_ms


def read(ctx):
    return mean_ms(ctx, "rollout")
