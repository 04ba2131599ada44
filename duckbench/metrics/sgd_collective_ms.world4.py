"""Device milliseconds of rank 0's NCCL kernels per training step in the
traced window: the sums over the ranks of its SGD step (nothing else in a
training step runs a collective; the window's stop flag is not traced).
A collective's kernel runs from its launch until every rank has joined, so
this holds the wait for the slowest rank. None without a trace or without
an NCCL kernel in it."""

NCCL = "nccl"


def read(ctx):
    t = ctx["trace"]
    if not t or not t.get("units"):
        return None
    nccl = [w for w in t.get("inside", ()) if w[0] == "kernel" and NCCL in w[1].lower()]
    if not nccl:
        return None
    return sum(w[3] - w[2] for w in nccl) / 1e3 / t["units"]
