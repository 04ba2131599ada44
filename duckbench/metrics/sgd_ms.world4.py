"""Mean milliseconds of rank 0's SGD step call (an SGDStepProgram replay:
its graph segments and the sums over the ranks between them), CUDA events
around the call, over the window's units (the world-4 cell)."""

from duckbench.readers import mean_ms


def read(ctx):
    return mean_ms(ctx, "sgd")
