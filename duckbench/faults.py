"""Faults planted in the program, for the test that shows the correctness
check fails a broken timed path, and for reading each fault's numbers on
the card (``probe.py``). Each breaks the port from outside, as a later
change might break it inside:

- ``sgd_unchanged``: the SGD step returns the learner state unchanged;
- ``half_batch``: the PPO loss leaves out half of each minibatch and takes
  its means over the rest (on many ranks too: the minibatch's first half);
- ``answer_altered``: the physics step's answer is altered where it is
  produced (one velocity of the first env, by 1e-3);
- ``state_unchanged``: the physics step returns the state it was given;
- ``exchange_skipped``: the sums over the ranks are left out (each rank
  goes on with its own part); nothing changes on one card.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

FAULTS = ("sgd_unchanged", "half_batch", "answer_altered", "state_unchanged",
          "exchange_skipped")
LOSSES = ("total_loss", "policy_loss", "v_loss", "entropy_loss")


@contextlib.contextmanager
def planted(fault: Optional[str]):
    """Patch the port's module-level functions for `fault` inside the block
    (the program is built inside it, so that its CUDA graphs capture the
    fault)."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"no fault {fault!r}: one of {FAULTS}")
    undo = []
    if fault == "half_batch":
        from open_duck_playground_tpu_torch.train import ppo

        orig = ppo.loss_points

        def half(networks, normalizer, data, entropy_noise, hp, mask=None, points=None):
            h = data.reward.shape[1] // 2
            data = ppo.tree_map(lambda x: x[:, :h], data)
            # on many ranks the means divide by the minibatch's size: the half's
            return (yield from orig(networks, normalizer, data, entropy_noise[:, :h],
                                    dataclasses.replace(hp, batch_size=h),
                                    None if mask is None else mask[:h], points))

        ppo.loss_points = half
        undo.append(lambda: setattr(ppo, "loss_points", orig))
    if fault in ("answer_altered", "state_unchanged"):
        from open_duck_playground_tpu_torch.ops.cuda_step import FusedPhysics

        call = FusedPhysics.__call__

        def broken(self, qpos, qvel, warm, ctrl, n_substeps, dr=None):
            out = dict(call(self, qpos, qvel, warm, ctrl, n_substeps, dr))
            if fault == "state_unchanged":
                out["qpos"], out["qvel"] = qpos.clone(), qvel.clone()
            else:
                out["qvel"] = out["qvel"].clone()
                out["qvel"][0, 0] += 1e-3
            return out

        FusedPhysics.__call__ = broken
        undo.append(lambda: setattr(FusedPhysics, "__call__", call))
    if fault == "exchange_skipped":
        from open_duck_playground_tpu_torch.parallel.dist import EnvShard

        reduce = EnvShard.all_reduce_sum_
        EnvShard.all_reduce_sum_ = lambda self, buf: buf
        undo.append(lambda: setattr(EnvShard, "all_reduce_sum_", reduce))
    try:
        yield
    finally:
        for u in reversed(undo):
            u()


def plant_in_program(fault: Optional[str], prog) -> None:
    """Faults that replace a part of a built program."""
    if fault == "sgd_unchanged" and hasattr(prog, "sgd"):
        hp = prog.hp
        shape = (hp.num_updates_per_batch, hp.num_minibatches)

        def unchanged(training_state, data, perms, entropy_noise, hp, shard=None):
            return training_state, {k: torch.zeros(shape, device=perms.device) for k in LOSSES}

        prog.sgd = unchanged
