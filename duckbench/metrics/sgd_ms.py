"""Mean milliseconds of the trainer's SGD step call (a CapturedSGDStep replay),
CUDA events around the call, over the window's units."""

from duckbench.readers import mean_ms


def read(ctx):
    return mean_ms(ctx, "sgd")
