"""The whole train unit's share of the card's float32 peak: the counted
physics and network work of the window's units over the window's time."""

from duckbench.readers import step_mfu


def read(ctx):
    return step_mfu(ctx, "train")
