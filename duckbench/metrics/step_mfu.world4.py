"""The whole training step's share of the float32 peak of the cell's cards:
the counted physics and network work of the window's global training
steps over the window's time at `world` cards' peak."""

from duckbench.readers import step_mfu


def read(ctx):
    mfu = step_mfu(ctx, "train")
    return None if mfu is None else mfu / ctx["world"]
