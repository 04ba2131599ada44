"""A cell on more than one card: the ranks, their process group, the
window's stop and the followed steps gathered on rank 0.

``python3 -m duckbench.run --workload <cell> ...`` for a cell whose
``chips`` is more than 1 starts its ranks with ``launch``: the same command
under ``torch.distributed.run --standalone``, one process per card, which
gives each its ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` and the
rendezvous on this host, and ends every rank when one fails. The launcher
runs in a session of its own under a timeout: past it, the session is ended
and the command exits 124. ``T0`` hands each rank the command's start
(``setup_s`` counts from it) and marks a process as a rank. Only rank 0
writes to standard output: the launcher passes on its last line once every
rank has exited with 0.

Each rank joins an NCCL group with one card of its own (``join``: the
port's ``parallel.dist.init_distributed``, as the port's trainer joins it
under ``torch.distributed.run``) and runs the cell on its rows of the env
batch (``program.TrainProgram`` with the rank's ``EnvShard``). The window's
stop reaches every rank on the stream (``run.window``); the followed steps
are gathered on rank 0 in rank order (``gather_train``) for the plain
reference, which runs there alone.
"""

from __future__ import annotations

import glob
import os
import signal
import subprocess
import sys
from typing import List, Optional

from duckbench import manifest

# seconds a run may take: the contract's 360 (1200 for a checkout's first
# run, which builds the port's kernels), less the time torch.distributed.run
# takes to end its ranks (SIGTERM, then SIGKILL after 30 s) and a margin
RUN_S, FIRST_RUN_S, CLOSE_S = 315.0, 1140.0, 35.0
KERNELS = os.path.join(manifest.ROOT, "build", "kernels")
T0 = "DUCKBENCH_T0"


def run_limit_s() -> float:
    """The launcher's timeout for one run: longer while the checkout holds
    no built kernel library yet."""
    return RUN_S if glob.glob(os.path.join(KERNELS, "*.so")) else FIRST_RUN_S


def rank_t0() -> Optional[float]:
    """The command's start when this process is a rank the launcher
    started, else None."""
    t0 = os.environ.get(T0)
    return None if t0 is None else float(t0)


def launch(command: List[str], world: int, timeout_s: float, t0: float,
           capture: bool = True, log=None) -> tuple:
    """Run `command` as `world` ranks (``torch.distributed.run
    --standalone``) in a session of its own, and wait for it. With
    `capture`, the ranks' standard output is collected (rank 0 alone writes
    to it), else it is this process's. Returns (code, output): code 0 when
    every rank exited with 0, 124 past `timeout_s`, else the launcher's."""
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc_per_node={world}", "--monitor_interval=0.5", "--no_python", *command]
    proc = subprocess.Popen(argv, cwd=manifest.ROOT, env=dict(os.environ, **{T0: repr(t0)}),
                            stdin=subprocess.DEVNULL,
                            stdout=subprocess.PIPE if capture else None, text=True,
                            start_new_session=True)
    old = signal.signal(signal.SIGTERM, lambda signum, frame: sys.exit(128 + signum))
    try:
        out, _ = proc.communicate(timeout=timeout_s)
        return proc.returncode, out or ""
    except subprocess.TimeoutExpired:
        log(f"[duckbench] the ranks are still running after {timeout_s:.0f} s: ending them")
        return 124, ""
    finally:
        if proc.poll() is None:
            _end(proc)
        signal.signal(signal.SIGTERM, old)


def _end(proc: subprocess.Popen) -> None:
    """End the launcher's session: SIGTERM, on which torch.distributed.run
    ends its ranks, then SIGKILL to what is left after CLOSE_S."""
    try:
        os.killpg(proc.pid, signal.SIGTERM)
        proc.communicate(timeout=CLOSE_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
    except ProcessLookupError:
        proc.wait()


def join(device: str = "cuda", timeout_s: float = RUN_S):
    """This rank's EnvShard of the group that ``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR`` and ``MASTER_PORT`` name: NCCL with a card of its own
    (``LOCAL_RANK``) on CUDA, gloo on the CPU. The port's kernels are built
    first by rank 0 while the others wait."""
    from open_duck_playground_tpu_torch.parallel import dist as pdist

    return pdist.init_distributed(None, device=device, timeout_s=timeout_s)


def leave() -> None:
    from open_duck_playground_tpu_torch.parallel import dist as pdist

    pdist.destroy()


def fullest(peak: int, shard) -> int:
    """The largest of every rank's peak memory (on every rank)."""
    import torch

    if shard is None or shard.world == 1:
        return peak
    every = shard.all_gather_rows(torch.tensor([peak], dtype=torch.int64, device=shard.device))
    return int(every.max())


def gather_train(rec, shard):
    """The followed steps of every rank on rank 0, rows in rank order: the
    reset state (rows first) and each rollout's Transition (rows second);
    the draws, losses, Adam moment, params and normalizers, alike on every
    rank, are rank 0's. None on the other ranks."""
    from duckbench.check import TrainRecord

    if shard is None or shard.world == 1:
        return rec

    def rows_second(x):
        return shard.all_gather_rows(x.transpose(0, 1).contiguous()).transpose(0, 1)

    reset = {k: shard.all_gather_rows(v) for k, v in rec.reset.items()}
    data = [{k: rows_second(v) for k, v in d.items()} for d in rec.data]
    if not shard.is_main:
        return None
    return TrainRecord(reset, data, rec.draws, rec.losses, rec.mu1, rec.params_end,
                       rec.normalizers)

