"""Rank programs of tests/test_torch_dist.py, and the launcher that runs
them on gloo ranks of one machine.

This module is not collected by pytest and imports neither JAX nor the JAX
package, so `spawn` can import it in each rank. Every rank joins a gloo
group through a FileStore under the test's tmp_path (no port is opened),
runs one function of this module with its EnvShard, and leaves its result
(or its traceback) in a file there; `run_ranks` joins them with a time
limit and raises, never hangs.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import shutil
import time
import traceback
from typing import Any, Dict, List

import numpy as np
import torch

from open_duck_playground_tpu_torch import interop
from open_duck_playground_tpu_torch.envs.types import State
from open_duck_playground_tpu_torch.envs.wrapper import TrainEnv
from open_duck_playground_tpu_torch.parallel import dist as pdist
from open_duck_playground_tpu_torch.train import checkpoint as ckpt
from open_duck_playground_tpu_torch.train import optim, ppo
from open_duck_playground_tpu_torch.utils.graphs import tree_map
from tests.torch_helpers import TorchToyEnv


def run_ranks(fn: str, tmp_path, *args, world: int = 2, timeout_s: float = 120.0) -> List[Any]:
    """Run `fn` (a name in this module) as `fn(shard, *args)` on `world`
    gloo ranks; returns each rank's result, in rank order. Raises with the
    ranks' tracebacks if one fails, and kills them if they outlast
    `timeout_s`."""
    out = os.path.join(str(tmp_path), f"ranks_{fn}")
    os.makedirs(out)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, out, args), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    t0 = time.monotonic()
    for p in procs:
        p.join(max(timeout_s - (time.monotonic() - t0), 0.1))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errors = {r: open(os.path.join(out, f"rank{r}.err")).read()
              for r in range(world) if os.path.exists(os.path.join(out, f"rank{r}.err"))}
    if hung or errors or any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"{fn}: ranks still running after {timeout_s} s: {hung}; exit codes "
                             f"{[p.exitcode for p in procs]}; errors:\n"
                             + "\n".join(f"rank {r}:\n{e}" for r, e in errors.items()))
    results = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def _rank_main(fn: str, rank: int, world: int, out: str, args) -> None:
    torch.set_num_threads(1)
    try:
        shard = pdist.init_distributed("gloo", device="cpu", rank=rank, world_size=world,
                                       init_method=f"file://{os.path.join(out, 'store')}",
                                       timeout_s=60)
        try:
            result = globals()[fn](shard, *args)
        finally:
            pdist.destroy()
        with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(os.path.join(out, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _np(x):
    """Nested dicts / dataclasses of tensors as numpy; a dataclass field
    the engine leaves None (Data's pipeline-only fields) is left out."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if hasattr(x, "__dataclass_fields__"):
        return {k: _np(v) for k, v in vars(x).items() if v is not None}
    return x


# ---------------------------------------------------------------------------
# 1. the helpers
# ---------------------------------------------------------------------------


def helpers(shard: pdist.EnvShard) -> Dict[str, Any]:
    r = shard.rank
    mine = torch.tensor([[10.0 * r, 10.0 * r + 1], [10.0 * r + 2, 10.0 * r + 3]])
    glob = torch.rand((2 * shard.world, 3), generator=torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(5)
    drawn = pdist.draw(shard, torch.rand, (2, 3), generator=g)
    out = {
        "rows": shard.rows(8),
        "take": shard.take(torch.arange(8)).numpy(),
        "gathered": shard.all_gather_rows(mine).numpy(),
        "gathered_bool": shard.all_gather_rows(torch.tensor([r == 0, True])).numpy(),
        "summed": shard.all_reduce_sum(torch.tensor([1.0 + r, 2.0])).numpy(),
        "broadcast": shard.broadcast(torch.tensor([7 + r])).numpy(),
        "drawn": drawn.numpy(),
        "drawn_want": glob[shard.rows(2 * shard.world)].numpy(),
        "generator": g.get_state().numpy(),
    }
    shard.assert_replicated({"same": [torch.arange(4.0)]})
    try:
        shard.assert_replicated({"same": [torch.arange(4.0)], "differs": [torch.tensor([r])]})
        out["caught"] = None
    except RuntimeError as e:
        out["caught"] = str(e)
    out["collectives"] = shard.collectives
    return out


# ---------------------------------------------------------------------------
# 2. the duck: a sharded batch against the one-process batch
# ---------------------------------------------------------------------------


def duck_rows(shard, task: str, n_global: int, actions: np.ndarray, seed: int) -> Dict[str, Any]:
    """TrainEnv(Joystick(task), DR on) on this shard's rows of n_global
    envs: reset and one step per row of `actions` [steps, n_global, nu]
    (shard None: the whole batch). Returns the DR rows and every state."""
    from open_duck_playground_tpu_torch.envs import randomize
    from open_duck_playground_tpu_torch.envs.joystick import Joystick

    env = Joystick(task, device="cpu", seed=seed)
    env.shard = shard
    n = n_global if shard is None else shard.local(n_global)
    te = TrainEnv(env, num_envs=n, episode_length=1000,
                  randomization_fn=randomize.domain_randomize,
                  randomization_generator=torch.Generator().manual_seed(seed + 1))
    state = te.reset(torch.Generator().manual_seed(seed + 2))
    states = [_np(state)]
    acts = torch.as_tensor(actions)
    for a in acts:
        state = te.step(state, a if shard is None else shard.take(a))
        states.append(_np(state))
    return {"dr": {f: getattr(te.model, f).numpy() for f in randomize.RANDOMIZED_FIELDS},
            "states": states, "generator": env.generator.get_state().numpy(),
            "launches": env.physics.launches}


# ---------------------------------------------------------------------------
# 3. one training step on the ToyEnv from given inputs (the JAX rebuild's)
# ---------------------------------------------------------------------------


def toy_state(tree) -> State:
    """A JAX TrainEnv state of the ToyEnv, as numpy, into the port's State."""
    t = lambda x: torch.as_tensor(np.array(x))  # noqa: E731
    info = {k: t(v) for k, v in tree["info"].items() if k not in ("rng", "first_data", "first_obs")}
    info["first_data"] = t(tree["info"]["first_data"])
    info["first_obs"] = {k: t(v) for k, v in tree["info"]["first_obs"].items()}
    return State(data=t(tree["data"]), obs={k: t(v) for k, v in tree["obs"].items()},
                 reward=t(tree["reward"]), done=t(tree["done"]),
                 metrics={k: t(v) for k, v in tree["metrics"].items()}, info=info)


def _rows(shard, state: State) -> State:
    if shard is None:
        return state
    return tree_map(lambda x: shard.take(x), state)


def toy_step_given(shard, params, normalizer, start, draws, hp_kw) -> Dict[str, Any]:
    """ppo.rollout and ppo.training_step on this shard's rows of the
    ToyEnv state `start` (numpy, JAX layout), from the given (normalizer,
    params) and global draws."""
    hp = ppo.Hyper(**hp_kw)
    tp = interop.ppo_params_from_numpy(params)
    ts = ppo.TrainingState(params=tp, normalizer=interop.normalizer_from_numpy(normalizer),
                           opt_state=optim.adam_init(list(tp.parameters())),
                           env_steps=torch.zeros((), dtype=torch.int64))
    env = TorchToyEnv()
    env.shard = shard
    tenv = TrainEnv(env, num_envs=shard.local(hp.num_envs), episode_length=6)
    noise, perms, ent = (torch.as_tensor(d) for d in draws)
    state = _rows(shard, toy_state(start))
    env_after, data = ppo.rollout(tenv, state, ts.normalizer, tp, shard.take(noise, dim=1))
    ts2, _, metrics = ppo.training_step(ts, tenv, state, (noise, perms.long(), ent), hp, shard)
    return {"data": _np(data), "obs_after": env_after.obs["state"].numpy(),
            "normalizer": interop.normalizer_to_numpy(ts2.normalizer),
            "params": interop.ppo_params_to_numpy(tp), "count": int(ts2.opt_state.count),
            "env_steps": int(ts2.env_steps), "metrics": {k: float(v) for k, v in metrics.items()}}


# ---------------------------------------------------------------------------
# 4. one training step on the ToyEnv with the port's own draws
# ---------------------------------------------------------------------------


def toy_step_own(shard, hp_kw, seed: int) -> Dict[str, Any]:
    """train()'s init from `seed`, a reset of the noisy ToyEnv, and one
    training step with draw_training_step's draws, on this shard's rows
    (shard None: the one-process run)."""
    hp = ppo.Hyper(**hp_kw)
    gens = ppo.seeded_generators(seed, "cpu")
    env = TorchToyEnv(noise=0.01)
    env.shard = shard
    env.generator.set_state(gens["env"].get_state())
    n = hp.num_envs if shard is None else shard.local(hp.num_envs)
    tenv = TrainEnv(env, num_envs=n, episode_length=6)
    obs_sizes = {k: v[0] for k, v in TorchToyEnv.observation_size.items()}
    ts = ppo.init_training_state(obs_sizes, TorchToyEnv.action_size,
                                 {"policy_hidden_layer_sizes": (16, 16),
                                  "value_hidden_layer_sizes": (16, 16)}, gens["net"], "cpu")
    state = tenv.reset(gens["reset"])
    draws = ppo.draw_training_step(gens["epoch"], hp, 3, "cpu")
    ts2, state2, metrics = ppo.training_step(ts, tenv, state, draws, hp, shard)
    return {"params": interop.ppo_params_to_numpy(ts2.params),
            "normalizer": interop.normalizer_to_numpy(ts2.normalizer),
            "adam": interop.adam_state_to_numpy(ts2.opt_state, ts2.params),
            "state": _np(state2), "metrics": {k: float(v) for k, v in metrics.items()},
            "generators": {k: gens[k].get_state().numpy() for k in ("epoch", "reset")},
            "env_generator": env.generator.get_state().numpy()}


# ---------------------------------------------------------------------------
# 5 and 6. ppo.train on the ToyEnv: kill-and-resume, full state, rank 0 writes
# ---------------------------------------------------------------------------


def toy_train(shard, directory=None, stop_after=None, auto_resume=False, num_evals=5,
              policy_dir=None, resume_shared_fs=False) -> Dict[str, Any]:
    """tests/test_torch_resume.py's recipe (8 envs, seed 7, the noisy
    ToyEnv) through ppo.train with this shard. Records what progress_fn
    saw and how many broadcasts the shard made; with `policy_dir`,
    policy_params_fn writes a checkpoint there named by rank."""
    evals, calls, broadcasts = [], [], []
    broadcast = shard.broadcast

    def counted(*a, **k):
        broadcasts.append(1)
        return broadcast(*a, **k)

    def progress(step, metrics):
        if "eval/episode_reward" in metrics:
            evals.append((step, metrics["eval/episode_reward"]))

    def policy_params(step, make_policy, params):
        calls.append(step)
        if policy_dir is not None:
            ckpt.save(os.path.join(policy_dir, f"rank{shard.rank}_{step}"), params)

    shard.broadcast = counted
    try:
        _, (normalizer, params), _ = ppo.train(
            TorchToyEnv(noise=0.01), eval_env=TorchToyEnv(noise=0.01),
            num_timesteps=2048, episode_length=16, num_envs=8, num_eval_envs=4,
            unroll_length=4, num_minibatches=2, batch_size=4, num_updates_per_batch=1,
            num_evals=num_evals, seed=7,
            network_factory={"policy_hidden_layer_sizes": (16,),
                             "value_hidden_layer_sizes": (16,)},
            progress_fn=progress, policy_params_fn=policy_params, save_full_state_dir=directory,
            auto_resume=auto_resume, stop_after_epochs=stop_after, shard=shard,
            resume_shared_fs=resume_shared_fs)
    finally:
        del shard.broadcast
    return {"evals": evals, "policy_calls": calls, "broadcasts": len(broadcasts),
            "normalizer": interop.normalizer_to_numpy(normalizer),
            "params": interop.ppo_params_to_numpy(params)}


def toy_kill_and_resume(shard, directory: str) -> Dict[str, Any]:
    """Uninterrupted, then killed after 2 epochs and auto-resumed: "c" as
    rank 0 decides (a broadcast), "d" from a copy of the killed run's
    directory with resume_shared_fs (every rank reads it alike)."""
    out = {"a": toy_train(shard), "b": toy_train(shard, directory, stop_after=2)}
    if shard.is_main:
        shutil.copytree(directory, directory + "_shared")
    shard.barrier()
    out["c"] = toy_train(shard, directory, auto_resume=True)
    out["d"] = toy_train(shard, directory + "_shared", auto_resume=True, resume_shared_fs=True)
    return out
