"""Kernels one replay of the trainer's SGD graph runs (CapturedSGDStep,
summed over its segments): its kernel nodes and its memcpy nodes, each of
which the CUDA driver runs as a kernel of its own (``memcpy32_post`` in the
profiler's trace; the graph's copies are all device to device). Its memset
nodes are not kernels and are left out. The program counts the nodes once,
at capture, from the instantiated graph (utils/graphs.py node_counts), and
keeps the counts by graph name (utils/profiling.py graphs()); None where
the program keeps no such count."""


def read(ctx):
    if ctx["loop"] != "train":
        return None
    from open_duck_playground_tpu_torch.utils import profiling

    graphs = getattr(profiling, "graphs", None)
    sgd = graphs().get("[ppo] SGD step") if graphs is not None else None
    return None if sgd is None else sgd["kernel_nodes"] + sgd["memcpy_nodes"]
