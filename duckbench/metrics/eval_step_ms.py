"""Mean milliseconds of one eval step call (a CapturedEvalStep replay),
CUDA events around the call, over the window's units."""

from duckbench.readers import mean_ms


def read(ctx):
    return mean_ms(ctx, "eval_step")
