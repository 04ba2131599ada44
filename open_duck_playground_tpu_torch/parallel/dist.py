"""Env-sharded data parallel over ``torch.distributed``.

Counterpart of the JAX package's ``parallel/mesh.py`` and of the fused
step's ``shard_map`` (``ops/pallas_step.py:238-262``, ``call_sharded``):
the env batch is split in equal rows over the ranks, the learner's params
are replicated, and the reductions that XLA's SPMD partitioner inserted
there are explicit collectives here, outside the kernel.

The semantics are the JAX package's global view:
- every random draw is made on every rank at the global shape, from
  generators seeded alike, and each rank keeps its own rows (``draw``): rank
  r's envs are rows r of the one-process run, and every rank's generators
  stay equal, as JAX's keys do;
- each rank launches the fused kernel once per step on its own rows, on its
  own card (``FusedPhysics`` keeps its tables per device); no collective
  runs inside a step;
- the learner sums over the ranks (normalizer statistics, loss terms,
  gradients), and every rank applies the same update.

A body that sums over the ranks in its middle (the SGD step) is written as
a generator over fixed buffers (``Collectives``): each ``yield`` is a
collective point, which ``run_points`` sums eagerly and
``utils.graphs.GraphedBody`` sums between two replayed graph segments.

With world size 1 every helper returns its input untouched, so a
one-process run does exactly the arithmetic it did without a shard.
"""

from __future__ import annotations

import datetime
import hashlib
import os
from typing import Callable, Dict, Generator, Iterable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from open_duck_playground_tpu_torch.utils import profiling


class EnvShard:
    """This process's part of an env-sharded run: rank `rank` of `world`,
    holding rows ``rank * n / world`` up to ``(rank + 1) * n / world`` of
    every global env batch of n rows. `device` is the rank's device; the
    collectives of host values (hashes, the resume epoch) run there.
    `backend` is the process group's ("gloo", "nccl"; None without one).

    ``collectives`` counts the collectives this shard has made (the
    tracer's ``dist.collectives``); each is the tracer's span
    ``dist.collective`` (utils/profiling.py)."""

    def __init__(self, rank: int = 0, world: int = 1, device=None,
                 backend: Optional[str] = None):
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} of a world of {world}")
        self.rank = rank
        self.world = world
        self.device = torch.device(device if device is not None else "cpu")
        self.backend = backend
        self.collectives = 0
        profiling.watch(self, "collectives", "dist.collectives")

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def stages_on_host(self) -> bool:
        """Whether the sums of a body's collective points read host memory:
        gloo over a card copies every tensor through the host, so those
        buffers are pinned host memory (Collectives)."""
        return self.world > 1 and self.device.type == "cuda" and self.backend == "gloo"

    # -- rows -----------------------------------------------------------------
    def local(self, n: int) -> int:
        """This rank's share of a global batch of n rows."""
        if n % self.world:
            raise ValueError(f"{n} envs do not split evenly over {self.world} ranks")
        return n // self.world

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of n rows."""
        k = self.local(n)
        return slice(self.rank * k, (self.rank + 1) * k)

    def take(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's rows of the global tensor `x` along `dim`."""
        if self.world == 1:
            return x
        idx = [slice(None)] * x.dim()
        idx[dim] = self.rows(x.shape[dim])
        return x[tuple(idx)]

    # -- collectives ------------------------------------------------------------
    def _run(self, op: Callable[[], None]) -> None:
        self.collectives += 1
        with profiling.span("dist.collective", self.device):
            op()

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of `x` over the ranks (a new tensor; `x` is left as it is)."""
        if self.world == 1:
            return x
        return self.all_reduce_sum_(x.clone())

    def all_reduce_sum_(self, buf: torch.Tensor) -> torch.Tensor:
        """`buf` summed over the ranks in place, with no copy; returns it. A
        host buffer of a shard on a card (Collectives, gloo) is read once
        the card has run what the current stream holds: the copy into it."""
        if self.world == 1:
            return buf
        if buf.device.type == "cpu" and self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self._run(lambda: dist.all_reduce(buf))
        return buf

    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's `x` concatenated along dim 0, in rank order."""
        if self.world == 1:
            return x
        y = x.contiguous()
        if y.dtype == torch.bool:
            return self.all_gather_rows(y.to(torch.uint8)).to(torch.bool)
        parts = [torch.empty_like(y) for _ in range(self.world)]
        self._run(lambda: dist.all_gather(parts, y))
        return torch.cat(parts)

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank `src`'s `x` on every rank (a new tensor)."""
        if self.world == 1:
            return x
        out = x.clone()
        self._run(lambda: dist.broadcast(out, src))
        return out

    def barrier(self) -> None:
        if self.world > 1:
            self._run(dist.barrier)

    def assert_replicated(self, groups: Dict[str, Iterable[torch.Tensor]]) -> None:
        """Raise unless every group of tensors is bit-identical on every
        rank: a sha256 of each group's bytes, gathered and compared."""
        if self.world == 1:
            return
        digests = torch.tensor(np.stack([np.frombuffer(_digest(ts), np.int64)
                                         for ts in groups.values()]), device=self.device)
        every = self.all_gather_rows(digests[None])
        differ = [name for i, name in enumerate(groups)
                  if not bool((every[:, i] == every[0, i]).all())]
        if differ:
            raise RuntimeError(f"rank {self.rank}: replicated state differs across the "
                               f"{self.world} ranks in {differ}")


class Collectives:
    """The fixed buffers of a body's collective points, one per name, made
    at the point's first use and reused by every later run: a body replayed
    as CUDA graph segments (utils.graphs.GraphedBody) writes, and reads back,
    the addresses the collective between two segments sums in place. On a
    card under gloo the buffers are pinned host memory (gloo copies through
    the host anyway): the copies into and out of them are then device work
    inside the segments, and a collective costs one host wait and no launch.
    Elsewhere they are on the tensors' device."""

    def __init__(self, shard: EnvShard):
        self.shard = shard
        self.buffers: Dict[str, torch.Tensor] = {}

    def total(self, name: str, x: torch.Tensor) -> Generator[torch.Tensor, None, torch.Tensor]:
        """Used as ``s = yield from points.total(name, x)``: `x` is copied
        into point `name`'s buffer, which is yielded to be summed over the
        ranks in place; returns a copy of the sum on x's device."""
        buf = self.buffers.get(name)
        if buf is None:
            host = self.shard.stages_on_host
            buf = self.buffers[name] = torch.empty(x.shape, dtype=x.dtype, pin_memory=host,
                                                   device="cpu" if host else x.device)
        buf.copy_(x, non_blocking=True)
        yield buf
        return buf.to(x.device, non_blocking=True, copy=True)


def run_points(body: Generator, shard: Optional[EnvShard]):
    """Run `body` (a generator written with collective points,
    Collectives.total) eagerly: each buffer it yields is summed over the
    ranks in place before it goes on. Returns the body's return value."""
    try:
        while True:
            buf = next(body)  # before `shard` is read: a body without points has none
            shard.all_reduce_sum_(buf)
    except StopIteration as stop:
        return stop.value


def _digest(tensors: Iterable[torch.Tensor]) -> bytes:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().reshape(-1).contiguous().cpu().view(torch.uint8).numpy().tobytes())
    return h.digest()


def draw(shard: Optional[EnvShard], fn: Callable[..., torch.Tensor], shape: Sequence[int],
         **kwargs) -> torch.Tensor:
    """``fn(shape, **kwargs)`` (``torch.rand``, ``torch.randn``, ...) for this
    rank's rows: with a shard of world > 1, drawn at the global shape
    ``(world * shape[0], ...)`` and cut to the shard's rows, so that the
    generator advances as in the one-process run."""
    if shard is None or shard.world == 1:
        return fn(tuple(shape), **kwargs)
    n = shape[0]
    out = fn((shard.world * n,) + tuple(shape[1:]), **kwargs)
    return out[shard.rank * n:(shard.rank + 1) * n]


# ---------------------------------------------------------------------------
# process group
# ---------------------------------------------------------------------------


def init_distributed(backend: Optional[str] = None, *, device="cuda",
                     init_method: Optional[str] = None, rank: Optional[int] = None,
                     world_size: Optional[int] = None, timeout_s: float = 900.0) -> EnvShard:
    """Join the process group and return this process's EnvShard.

    Rank and world size come from the arguments or else from
    ``torch.distributed.run``'s ``RANK`` and ``WORLD_SIZE``; the rank on
    this host and the ranks on it from ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE`` (else 0 and 1: one process per host, as the JAX
    runner's flags assume). ``MASTER_ADDR``/``MASTER_PORT`` are read by the
    default ``env://`` rendezvous. Without either, world size 1 and no
    process group. On CUDA the rank's card is made the current device here,
    before any env, model or generator is made on "cuda".

    Backend: NCCL when every rank of this host has a card of its own. More
    ranks than cards raises, unless `backend` is "gloo": the ranks then
    share the cards (``cuda:{local_rank % device_count}``), and the choice
    is printed. On the CPU the backend is gloo. A collective that waits
    longer than `timeout_s` raises, so a rank that failed does not hang the
    others for ever.

    On CUDA, local rank 0 builds the fused kernel's library first while the
    other ranks wait at a barrier; they then find the build."""
    env = os.environ
    rank = rank if rank is not None else int(env.get("RANK", 0))
    world = world_size if world_size is not None else int(env.get("WORLD_SIZE", 1))
    local_rank = int(env.get("LOCAL_RANK", 0))
    local_world = int(env.get("LOCAL_WORLD_SIZE", 1))
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the sharded trainer runs on the card unless "
                               "given device='cpu' (--device cpu)")
        cards = torch.cuda.device_count()
        if local_world > cards and backend != "gloo":
            raise ValueError(f"{local_world} ranks on this host and {cards} card(s): NCCL needs "
                             f"a card per rank; pass backend='gloo' (--dist_backend gloo) to "
                             f"share the cards")
        backend = backend or "nccl"
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
        if local_world > cards:
            print(f"[dist] rank {rank}: {local_world} ranks share {cards} card(s) over gloo; "
                  f"this rank on {dev}", flush=True)
    else:
        backend = backend or "gloo"
        if backend != "gloo":
            raise ValueError(f"backend {backend!r} on the CPU: only gloo runs there")
    shard = EnvShard(rank, world, dev, backend if world > 1 else None)
    if world > 1:
        dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s))
    if dev.type == "cuda":
        from open_duck_playground_tpu_torch.ops import cuda_step

        if local_rank == 0:
            cuda_step.build_library()
        shard.barrier()
        cuda_step.build_library()
    return shard


def destroy() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def current_shard(device) -> EnvShard:
    """The EnvShard of the default process group (rank 0 of 1 without one)."""
    if dist.is_available() and dist.is_initialized():
        return EnvShard(dist.get_rank(), dist.get_world_size(), device, dist.get_backend())
    return EnvShard(0, 1, device)
