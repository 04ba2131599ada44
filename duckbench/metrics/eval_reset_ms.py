"""Mean milliseconds of the eval episode's eager reset (TrainEnv.reset),
CUDA events around the call, over the window's units."""

from duckbench.readers import mean_ms


def read(ctx):
    return mean_ms(ctx, "eval_reset")
