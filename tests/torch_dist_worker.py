"""Rank programs of tests/test_torch_dist.py, and the launcher that runs
them on gloo ranks of one machine.

This module is not collected by pytest and imports neither JAX nor the JAX
package, so `spawn` can import it in each rank; nor, at its top, any other
module of tests/ (the card test imports it as a top-level module: an
installed `tests` package may shadow ours there). Every rank joins a gloo
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
from open_duck_playground_tpu_torch.utils import profiling
from open_duck_playground_tpu_torch.utils.graphs import tree_map


def run_ranks(fn: str, tmp_path, *args, world: int = 2, timeout_s: float = 120.0,
              device: str = "cpu") -> List[Any]:
    """Run `fn` (a name in this module) as `fn(shard, *args)` on `world`
    gloo ranks, each on `device` ("cuda": the ranks share the card);
    returns each rank's result, in rank order. Raises with the ranks'
    tracebacks if one fails, and kills them if they outlast `timeout_s`."""
    out = os.path.join(str(tmp_path), f"ranks_{fn}")
    os.makedirs(out)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, out, args, device), daemon=True)
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


def _rank_main(fn: str, rank: int, world: int, out: str, args, device: str = "cpu") -> None:
    torch.set_num_threads(1)
    try:
        shard = pdist.init_distributed("gloo", device=device, rank=rank, world_size=world,
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
    from tests.torch_helpers import TorchToyEnv

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
    from tests.torch_helpers import TorchToyEnv

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
    from tests.torch_helpers import TorchToyEnv

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


# ---------------------------------------------------------------------------
# 7. the env-sharded SGD step as a chain of segments (test_torch_sharded_graph.py)
# ---------------------------------------------------------------------------


SEG_OBS = {"state": 6, "privileged_state": 10}
SEG_ACT = 3
SEG_NF = {"policy_hidden_layer_sizes": (16, 16), "value_hidden_layer_sizes": (16, 16)}


def seg_hyper(num_envs=32, unroll_length=4, num_minibatches=4, batch_size=8,
              num_updates_per_batch=2) -> ppo.Hyper:
    return ppo.Hyper(num_envs=num_envs, unroll_length=unroll_length,
                     num_minibatches=num_minibatches, batch_size=batch_size,
                     num_updates_per_batch=num_updates_per_batch, action_repeat=1,
                     learning_rate=3e-4, entropy_cost=5e-3, discounting=0.97, gae_lambda=0.95,
                     clipping_epsilon=0.2, normalize_advantage=True, reward_scaling=1.0,
                     normalize_observations=True, max_grad_norm=1.0)


def seg_inputs(hp: ppo.Hyper, seed: int):
    """train()'s init from `seed` and one SGD step's global inputs, made
    alike on every rank from seeded numpy: a Transition [T, num_envs, ...]
    (actions, raw actions and log probs from the init's policy, some dones
    and truncations), the epochs' permutations and the entropy noise."""
    ts = ppo.init_training_state(SEG_OBS, SEG_ACT, SEG_NF, torch.Generator().manual_seed(seed),
                                 "cpu")
    rng = np.random.RandomState(seed)
    T, N = hp.unroll_length, hp.num_envs
    f32 = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))  # noqa: E731
    obs = {k: f32(T, N, n) * 2.0 + 0.5 for k, n in SEG_OBS.items()}
    nxt = {k: v + 0.1 * f32(T, N, v.shape[-1]) for k, v in obs.items()}
    with torch.no_grad():
        action, raw, log_prob = ppo.nets.sample_actions(ts.params, ts.normalizer, obs,
                                                        f32(T, N, SEG_ACT))
    done = torch.from_numpy((rng.rand(T, N) < 0.2).astype(np.float32))
    trunc = torch.from_numpy((rng.rand(T, N) < 0.3).astype(np.float32)) * done
    data = ppo.Transition(observation=obs, action=action, reward=f32(T, N), discount=1.0 - done,
                          next_observation=nxt, truncation=trunc, raw_action=raw,
                          log_prob=log_prob)
    perms = torch.from_numpy(np.stack([rng.permutation(N)
                                       for _ in range(hp.num_updates_per_batch)]))
    ent = f32(hp.num_updates_per_batch, hp.num_minibatches, T, hp.batch_size, SEG_ACT)
    return ts, data, perms, ent


def _members(perms, shard, hp):
    """The host-built member lists the SGD step used before its minibatches
    were static: per minibatch, this rank's env rows and their positions,
    from a copy of the permutations to the host."""
    n_local = shard.local(hp.num_envs)
    lo = shard.rank * n_local
    E, nmb, b = hp.num_updates_per_batch, hp.num_minibatches, hp.batch_size
    p = perms.cpu().numpy().reshape(E, nmb, b)
    mine = (p >= lo) & (p < lo + n_local)
    both = torch.from_numpy(np.stack([p[mine] - lo, np.nonzero(mine)[2]]).astype(np.int64))
    parts = both.to(perms.device).split(mine.sum(-1).ravel().tolist(), dim=1)
    return [[(parts[e * nmb + j][0], parts[e * nmb + j][1]) for j in range(nmb)]
            for e in range(E)]


def straight_sgd_step(ts, data, perms, ent, hp, shard, members: str):
    """The env-sharded SGD step written straight, every sum over the ranks
    a `shard.all_reduce_sum` in line, no segment and no fixed buffer: with
    members "host", the member lists of `_members` (the step as it stood
    before); with "masked", every minibatch position, the sums masked by
    `torch.where` (what ppo.sgd_points computes). Returns the losses."""
    from open_duck_playground_tpu_torch.train import networks as nets
    from open_duck_playground_tpu_torch.utils.graphs import copy_into

    normalizer = ts.normalizer
    copy_into(normalizer, nets.rs_update(normalizer, data.observation, shard=shard))
    params = list(ts.params.parameters())
    E, nmb, b = hp.num_updates_per_batch, hp.num_minibatches, hp.batch_size
    n_local = shard.local(hp.num_envs)
    lo = shard.rank * n_local
    listed = _members(perms, shard, hp) if members == "host" else None
    terms = ("policy_loss", "v_loss", "entropy_loss")
    aux = []
    for e in range(E):
        for j in range(nmb):
            if listed is not None:
                idx, pos = listed[e][j]
                noise, mask = ent[e, j].index_select(1, pos), None
            else:
                p = perms[e, j * b:(j + 1) * b]
                mask = (p >= lo) & (p < lo + n_local)
                idx, noise = torch.where(mask, p - lo, 0), ent[e, j]
            mb = tree_map(lambda x: x.index_select(1, idx), data)
            n = mb.reward.shape[0] * b
            keep = (lambda x: x) if mask is None else (lambda x: torch.where(mask, x, 0.0))
            mean = lambda x: torch.sum(keep(x)) / n  # noqa: E731
            loc, scale = nets.dist_create(ts.params.policy_logits(normalizer, mb.observation))
            baseline = ts.params.value_fn(normalizer, mb.observation)
            terminal = {k: v[-1] for k, v in mb.next_observation.items()}
            boot = ts.params.value_fn(normalizer, terminal)
            termination = (1 - mb.discount) * (1 - mb.truncation)
            rho = torch.exp(nets.dist_log_prob(loc, scale, mb.raw_action) - mb.log_prob)
            vs, adv = ppo.compute_gae(mb.truncation, termination, mb.reward * hp.reward_scaling,
                                      baseline.detach(), boot.detach(), lambda_=hp.gae_lambda,
                                      discount=hp.discounting)
            adv_mean = shard.all_reduce_sum(torch.sum(keep(adv))) / n
            adv_var = shard.all_reduce_sum(torch.sum(keep(torch.square(adv - adv_mean)))) / n
            adv = (adv - adv_mean) / (torch.sqrt(adv_var) + 1e-8)
            clipped = torch.clamp(rho, 1 - hp.clipping_epsilon, 1 + hp.clipping_epsilon)
            policy_loss = -mean(torch.minimum(rho * adv, clipped * adv))
            v_error = vs - baseline
            v_loss = mean(v_error * v_error) * 0.5 * 0.5
            entropy_loss = -hp.entropy_cost * mean(nets.dist_entropy(loc, scale, noise))
            total = policy_loss + v_loss + entropy_loss
            grads = torch.autograd.grad(total, params)
            flat = shard.all_reduce_sum(torch.cat(
                [g.reshape(-1) for g in grads]
                + [torch.stack([x.detach() for x in (policy_loss, v_loss, entropy_loss)])]))
            summed, at = [], 0
            for g in grads:
                summed.append(flat[at:at + g.numel()].view_as(g))
                at += g.numel()
            mb_aux = dict(zip(terms, flat[at:]))
            mb_aux["total_loss"] = mb_aux["policy_loss"] + mb_aux["v_loss"] + mb_aux["entropy_loss"]
            optim.adam(params, optim.clip_by_global_norm(summed, hp.max_grad_norm), ts.opt_state,
                       hp.learning_rate)
            aux.append(mb_aux)
    return {k: torch.stack([a[k] for a in aux]).reshape(E, nmb)
            for k in ("total_loss", "policy_loss", "v_loss", "entropy_loss")}


HOST_READS = ("__bool__", "__int__", "__float__", "__index__", "item", "tolist", "numpy", "cpu")


class HostSpy:
    """Records, while on, every tensor made from host data (torch.tensor /
    as_tensor / from_numpy), every read of a tensor back to the host (item,
    bool, int, float, index, tolist, numpy, cpu) and every synchronize:
    what a CUDA graph segment must not hold."""

    def __init__(self):
        self.calls: List[str] = []
        self.on = False
        self._saved = []
        targets = [(torch, n) for n in ("tensor", "as_tensor", "from_numpy")]
        targets += [(torch.Tensor, n) for n in HOST_READS]
        targets += [(torch.cuda, "synchronize"), (torch.cuda.Stream, "synchronize")]
        for owner, name in targets:
            fn = getattr(owner, name)
            self._saved.append((owner, name, fn))
            setattr(owner, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        def spied(*a, **k):
            if self.on:
                self.calls.append(name)
            return fn(*a, **k)
        return spied

    def close(self):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)


def sgd_segment_checks(shard, hp_kw, seed: int) -> Dict[str, Any]:
    """On each rank, from `seg_inputs(seed)` cut to this rank's rows:
    (1) ppo.sgd_step (the segment chain, run eagerly with its collectives
    between the segments), (2) straight_sgd_step "masked" and (3) "host" on
    copies of the init; (4) the collective points of two runs of
    sgd_points on one Collectives (their buffers, in order); (5) the host
    spy over each segment of a third run, collectives excluded, and over
    the host member lists; (6) all_reduce_sum_ in place, counted, timed;
    (7) make_sgd_step's program of the shard (its body run eagerly here)
    against ppo.sgd_step over two consecutive steps, seed's inputs and then
    seed + 1's: its log line, and the learner and losses equal or not."""
    hp = ppo.Hyper(**hp_kw)

    def start(s=seed):
        ts, data, perms, ent = seg_inputs(hp, s)
        return ts, tree_map(lambda x: shard.take(x, dim=1), data), perms, ent

    out = {}
    for name, step in (("chain", lambda *a: ppo.sgd_step(*a, shard)[1]),
                       ("masked", lambda *a: straight_sgd_step(*a, shard, "masked")),
                       ("host", lambda *a: straight_sgd_step(*a, shard, "host"))):
        ts, data, perms, ent = start()
        losses = step(ts, data, perms, ent, hp)
        out[name] = {"learner": [t.detach().numpy().copy() for t in ppo.learner_tensors(ts)],
                     "losses": {k: v.numpy() for k, v in losses.items()},
                     "params": interop.ppo_params_to_numpy(ts.params)}

    ts, data, perms, ent = start()
    points = pdist.Collectives(shard)
    runs = []
    for _ in range(2):
        seen, body = [], ppo.sgd_points(ts, data, perms, ent, hp, points)
        try:
            while True:
                buf = next(body)
                seen.append((id(buf), buf.data_ptr()))
                shard.all_reduce_sum_(buf)
        except StopIteration:
            pass
        runs.append(seen)
    out["points"] = runs
    out["collectives_expected"] = ppo.sgd_collectives(hp, len(SEG_OBS))

    spy = HostSpy()
    try:
        body, segments, per_segment = ppo.sgd_points(ts, data, perms, ent, hp, points), 0, []
        while True:
            spy.on = True
            try:
                buf = next(body)
            except StopIteration:
                break
            finally:
                spy.on, segments = False, segments + 1
                per_segment.append(list(spy.calls))
                spy.calls.clear()
            shard.all_reduce_sum_(buf)
        out["spy_segments"] = segments
        out["spy_calls"] = sorted({c for s in per_segment for c in s})
        spy.on = True
        _members(perms, shard, hp)
        spy.on = False
        out["spy_host_members"] = sorted(set(spy.calls))
    finally:
        spy.close()

    buf = torch.tensor([1.0 + shard.rank, 2.0])
    n0 = shard.collectives
    same = shard.all_reduce_sum_(buf) is buf
    profiling.enable()
    try:
        profiling.reset()
        shard.all_reduce_sum_(buf)
        spans = profiling.summary()["spans"]
    finally:
        profiling.disable()
        profiling.reset()
    out["in_place"] = {"same": same, "value": buf.numpy(), "counted": shard.collectives - n0,
                       "spans": spans}

    lines, equal = [], []
    ts, ref = start()[0], start()[0]
    program = ppo.make_sgd_step(ts, hp, shard, lines.append)
    for s in (seed, seed + 1):
        _, data, perms, ent = start(s)
        got = program(ts, data, perms, ent, hp, shard)[1]
        want = ppo.sgd_step(ref, data, perms, ent, hp, shard)[1]
        equal.append(all(torch.equal(a, b) for a, b in zip(ppo.learner_tensors(ts),
                                                           ppo.learner_tensors(ref)))
                     and all(torch.equal(got[k], v) for k, v in want.items()))
    out["program"] = {"lines": lines, "equal": equal, "replays": program.replays}
    return out


def seg_world_1(hp_kw, seed: int) -> Dict[str, Any]:
    """ppo.sgd_step at world size 1 on all of seg_inputs(seed)."""
    hp = ppo.Hyper(**hp_kw)
    ts, data, perms, ent = seg_inputs(hp, seed)
    losses = ppo.sgd_step(ts, data, perms, ent, hp)[1]
    return {"learner": [t.detach().numpy().copy() for t in ppo.learner_tensors(ts)],
            "losses": {k: v.numpy() for k, v in losses.items()},
            "params": interop.ppo_params_to_numpy(ts.params)}


def sharded_graph_vs_eager(shard, task: str, n_global: int, seed: int) -> Dict[str, Any]:
    """On the card: two training steps at this world size from train()'s
    init (seed) and the same global draws, once through the eager bodies
    (ppo.rollout, ppo.sgd_step) and once through the graphs (make_rollout's
    RolloutProgram, make_sgd_step's SGDStepProgram of the shard: the first
    call captures, the second replays). Per step, on this rank: the
    Transition, the env state, the learner's tensors, the loss terms and
    the generators' states, each equal bit for bit or not; the replays, the
    SGD chain's segments and the collectives of each SGD step."""
    from open_duck_playground_tpu_torch.envs import randomize
    from open_duck_playground_tpu_torch.envs.joystick import Joystick

    dev = shard.device
    hp = seg_hyper(num_envs=n_global, unroll_length=4, num_minibatches=4,
                   batch_size=n_global // 4, num_updates_per_batch=2)

    def bits(tree):
        from open_duck_playground_tpu_torch.utils.graphs import tree_leaves

        return {k: v.detach().reshape(-1).view(torch.uint8).cpu().numpy()
                for k, v in tree_leaves(tree).items()}

    def run(graphs: bool):
        gens = ppo.seeded_generators(seed, dev)
        env = Joystick(task, device=dev)
        env.shard = shard
        env.generator.set_state(gens["env"].get_state())
        te = TrainEnv(env, num_envs=shard.local(n_global), episode_length=100,
                      randomization_fn=randomize.domain_randomize,
                      randomization_generator=gens["randomization"])
        obs_sizes = {k: v[0] for k, v in env.observation_size.items()}
        ts = ppo.init_training_state(obs_sizes, env.action_size,
                                     {"policy_hidden_layer_sizes": (32, 16),
                                      "value_hidden_layer_sizes": (32, 16)}, gens["net"], dev)
        state = te.reset(gens["reset"])
        roll = ppo.make_rollout(te, ts, hp) if graphs else ppo.rollout
        sgd = ppo.make_sgd_step(ts, hp, shard) if graphs else ppo.sgd_step
        steps, collectives = [], []
        for _ in range(2):
            noise, perms, ent = ppo.draw_training_step(gens["epoch"], hp, env.action_size, dev)
            state, data = roll(te, state, ts.normalizer, ts.params, shard.take(noise, dim=1))
            got = {"data": bits(data), "state": bits(state)}
            n0 = shard.collectives
            ts, losses = sgd(ts, data, perms, ent, hp, shard)
            collectives.append(shard.collectives - n0)
            got.update(learner=bits(dict(enumerate(ppo.learner_tensors(ts)))),
                       losses=bits(losses),
                       generators={k: g.get_state().numpy() for k, g in
                                   (("epoch", gens["epoch"]), ("env", env.generator))})
            steps.append(got)
        out = {"steps": steps, "collectives": collectives}
        if graphs:
            out.update(kinds=[type(roll).__name__, type(sgd).__name__],
                       replays=[roll.replays, sgd.replays], segments=sgd.info.get("segments"),
                       fused_per_replay=roll.graph.info["launches_per_replay"][
                           "fused_physics_step"])
        return out

    eager, graph = run(False), run(True)
    equal = []
    for a, b in zip(eager["steps"], graph["steps"]):
        equal.append({part: all(np.array_equal(v, b[part][k]) for k, v in a[part].items())
                      for part in a})
    return {"equal": equal, "collectives": [eager["collectives"], graph["collectives"]],
            "want_collectives": ppo.sgd_collectives(hp, 2),
            **{k: graph[k] for k in ("kinds", "replays", "segments", "fused_per_replay")}}
