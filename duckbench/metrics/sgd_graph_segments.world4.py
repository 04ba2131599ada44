"""Graph segments one replay of the trainer's SGD step runs (SGDStepProgram;
at world > 1 one more than its sums over the ranks, which run between the
segments: 389 at the recipe), as the program counts them at capture and
keeps them by graph name (utils/profiling.py graphs()); None where the
program keeps no such count."""


def read(ctx):
    if ctx["loop"] != "train":
        return None
    from open_duck_playground_tpu_torch.utils import profiling

    graphs = getattr(profiling, "graphs", None)
    sgd = graphs().get("[ppo] SGD step") if graphs is not None else None
    return None if sgd is None else float(sgd["segments"])
