"""The fused physics kernel's share of its roofline in the traced train
window: the bound from the configuration's frozen counts at the loop's rows
and substeps over the kernel's device time per launch."""

from duckbench.readers import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, "train")
