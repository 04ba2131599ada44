"""The port's env-sharded path (``parallel/dist.py`` and the trainer's
multi-rank branches) on 2 gloo ranks of this machine, against the
one-process port and against the JAX package's global-view step.

The JAX package defines what a sharded run computes: params replicated,
the env batch sharded, every draw from the seed at global shape, the
minibatch permutation over all envs (``ppo.py:140-149, 240-320``), so a
sharded step is the one-device step on the global batch. Here:

1. the helpers: rows, all-gather in rank order, sum, broadcast, global
   draws cut to rows, the replication check; world size 1 is the identity;
2. the duck (flat_terrain, DR on, the kernel's plain version): reset and 2
   steps at 2 ranks x 2 envs equal the 1-process 4-env run row for row, bit
   for bit (the twin is per-row independent), and the ranks' generators
   stay equal;
3. one training step at world 2 on the ToyEnv, with JAX's draws, against
   the JAX rebuild of ppo.py:240-320 on the global batch
   (test_torch_ppo.py's, to that test's bounds);
4. world 2 against world 1 with the port's own draws: params to the bounds
   of 3, the normalizer count exactly, params bit-identical across ranks;
5. kill-and-resume at world 2 reproduces the uninterrupted world-2 curve
   exactly;
6. a world-2 full state has the names and shapes of a world-1 one, and only
   rank 0 writes files.

The ranks run tests/torch_dist_worker.py (no JAX there); each test joins
them with its own time limit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from open_duck_playground_tpu.envs.wrapper import TrainEnv as JaxTrainEnv
from open_duck_playground_tpu.train import networks as jnets
from open_duck_playground_tpu_torch.parallel import dist as pdist
from open_duck_playground_tpu_torch.train import checkpoint as ckpt
from tests.test_resume import ToyEnv as JaxToyEnv
from tests.test_torch_ppo import STEP, TOY_OBS, _hyper, _jax_training_step
from tests.torch_dist_worker import duck_rows, run_ranks, toy_step_own, toy_train
from tests.torch_helpers import numpy_tree, standin_assets

pytest_plugins = ["tests.torch_lock"]  # never beside tests/test_resume.py (see there)


def _hp_kw(**kw):
    hp = _hyper(**kw)
    return {f: getattr(hp, f) for f in hp.__dataclass_fields__}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield "/".join(path), np.asarray(tree)


def _params_diff(a, b):
    return np.concatenate([np.abs(x - dict(_leaves(b))[k]).ravel() for k, x in _leaves(a)])


# ---------------------------------------------------------------------------
# 1. helpers
# ---------------------------------------------------------------------------


def test_dist_helpers_on_two_ranks(tmp_path):
    r0, r1 = run_ranks("helpers", tmp_path)
    assert r0["rows"] == slice(0, 4) and r1["rows"] == slice(4, 8)
    np.testing.assert_array_equal(r1["take"], np.arange(4, 8))
    for r in (r0, r1):
        np.testing.assert_array_equal(r["gathered"], [[0, 1], [2, 3], [10, 11], [12, 13]])
        np.testing.assert_array_equal(r["gathered_bool"], [True, True, False, True])
        np.testing.assert_array_equal(r["summed"], [3.0, 4.0])
        np.testing.assert_array_equal(r["broadcast"], [7])
        np.testing.assert_array_equal(r["drawn"], r["drawn_want"])
        assert r["caught"] is not None and "['differs']" in r["caught"]
    assert not np.array_equal(r0["drawn"], r1["drawn"])
    np.testing.assert_array_equal(r0["generator"], r1["generator"])
    assert r0["collectives"] == r1["collectives"] > 0


def test_world_size_1_is_the_identity():
    shard = pdist.init_distributed(device="cpu", rank=0, world_size=1)
    assert (shard.rank, shard.world, shard.device) == (0, 1, torch.device("cpu"))
    assert not torch.distributed.is_initialized()
    x = torch.arange(6.0).reshape(3, 2)
    assert shard.all_reduce_sum(x) is x and shard.all_gather_rows(x) is x
    assert shard.broadcast(x) is x and shard.take(x) is x
    shard.barrier()
    shard.assert_replicated({"x": [x]})
    assert shard.collectives == 0 and shard.rows(3) == slice(0, 3)
    a = pdist.draw(shard, torch.rand, (3, 2), generator=torch.Generator().manual_seed(1))
    b = torch.rand((3, 2), generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="split evenly"):
        pdist.EnvShard(0, 2).local(5)
    with pytest.raises(ValueError, match="gloo"):
        pdist.init_distributed("nccl", device="cpu", rank=0, world_size=1)


# ---------------------------------------------------------------------------
# 2. the duck
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    with standin_assets(str(tmp_path_factory.mktemp("standin"))) as r:
        yield r


def test_duck_two_ranks_equal_one_process(root, tmp_path):
    """flat_terrain, DR on, reset + 2 steps of the same global actions: the
    ranks' rows of the DR model, of every state tensor (data, obs, reward,
    done, metrics, info) equal the 1-process run's, bit for bit."""
    n, steps = 4, 2
    actions = np.random.RandomState(3).uniform(-1, 1, (steps, n, 14)).astype(np.float32)
    ranks = run_ranks("duck_rows", tmp_path, "flat_terrain", n, actions, 11, timeout_s=240)
    torch.set_num_threads(1)
    whole = duck_rows(None, "flat_terrain", n, actions, 11)
    for r, got in enumerate(ranks):
        rows = slice(2 * r, 2 * r + 2)
        for f, v in got["dr"].items():
            np.testing.assert_array_equal(v, whole["dr"][f][rows], err_msg=f)
        assert len(got["states"]) == steps + 1
        for t, (a, b) in enumerate(zip(got["states"], whole["states"])):
            for name, x in _leaves(a):
                np.testing.assert_array_equal(x, dict(_leaves(b))[name][rows],
                                              err_msg=f"step {t} {name}")
        np.testing.assert_array_equal(got["generator"], whole["generator"])
    assert float(np.abs(whole["states"][-1]["obs"]["state"]).max()) > 0


# ---------------------------------------------------------------------------
# 3. held against JAX: the world-2 step against the JAX global-batch rebuild
# ---------------------------------------------------------------------------


def test_sharded_training_step_matches_jax_rebuild(tmp_path):
    """test_torch_ppo.py::test_training_step_matches_jax_rebuild at world
    2: the ToyEnv's 8 envs as 2 x 4 rows, JAX's draws given to both ranks.
    Transitions and the normalizer to atol 1e-6; params to q99 |d| <= 1e-6
    and max |d| <= 2 lr per Adam step; the params bit-identical across
    ranks; the metrics to rtol 1e-3."""
    network = jnets.PPONetworks(TOY_OBS, 3, (32, 32), (32, 32))
    jp = network.init(jax.random.PRNGKey(9))
    jn = jnets.rs_init(TOY_OBS)
    tx = optax.chain(optax.clip_by_global_norm(STEP["max_grad_norm"]),
                     optax.adam(STEP["learning_rate"]))
    jenv = JaxTrainEnv(JaxToyEnv(), num_envs=STEP["num_envs"], episode_length=6)
    env_state = jax.jit(jenv.reset)(jax.random.PRNGKey(10))
    for _ in range(4):
        env_state = jax.jit(jenv.step)(env_state, jnp.zeros((STEP["num_envs"], 3)))
    start = numpy_tree(env_state)
    jp2, jn2, _, jenv2, jdata, jmetrics, (noise, perms, ent) = _jax_training_step(
        network, jenv, tx)(jp, jn, tx.init(jp), env_state, jax.random.PRNGKey(11))
    draws = tuple(np.asarray(d) for d in (noise, perms, ent))

    ranks = run_ranks("toy_step_given", tmp_path, numpy_tree(jp), numpy_tree(jn), start,
                      draws, _hp_kw(**STEP))
    jd = numpy_tree(jdata)
    assert float(jd["truncation"].sum()) > 0
    cat = lambda f: np.concatenate([r["data"][f] for r in ranks], axis=1)  # noqa: E731
    for f in ("action", "reward", "discount", "truncation", "raw_action", "log_prob"):
        np.testing.assert_allclose(cat(f), jd[f], rtol=0, atol=1e-6, err_msg=f)
    for f in ("observation", "next_observation"):
        for k in TOY_OBS:
            got = np.concatenate([r["data"][f][k] for r in ranks], axis=1)
            np.testing.assert_allclose(got, jd[f][k], rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.concatenate([r["obs_after"] for r in ranks]),
                               np.asarray(jenv2.obs["state"]), atol=1e-6)
    jnorm = numpy_tree(jn2)
    adam_steps = STEP["num_updates_per_batch"] * STEP["num_minibatches"]
    for r in ranks:
        assert float(r["normalizer"]["count"]) == float(jnorm["count"]) == 32
        for f in ("mean", "summed_variance", "std"):
            for k in TOY_OBS:
                np.testing.assert_allclose(r["normalizer"][f][k], jnorm[f][k], rtol=0, atol=1e-6)
        assert r["count"] == adam_steps
        assert r["env_steps"] == STEP["num_envs"] * STEP["unroll_length"]
        for k, v in r["metrics"].items():
            np.testing.assert_allclose(v, float(jmetrics[k]), rtol=1e-3, atol=1e-5, err_msg=k)
    assert not _params_diff(ranks[0]["params"], ranks[1]["params"]).any()
    d = _params_diff(ranks[0]["params"], numpy_tree(jp2))
    assert np.quantile(d, 0.99) <= 1e-6 and d.max() <= 2 * STEP["learning_rate"] * adam_steps, (
        np.quantile(d, 0.99), d.max())


# ---------------------------------------------------------------------------
# 4. world 2 against world 1, the port's own draws
# ---------------------------------------------------------------------------


def test_world_2_matches_world_1_on_the_toy_env(tmp_path):
    """train()'s init and draw_training_step's draws from one seed, one
    training step of the noisy ToyEnv: params to the bounds of the JAX
    test, the normalizer count exactly and its statistics to atol 1e-6,
    the env batch and every generator equal, the params and Adam state
    bit-identical across ranks."""
    kw = _hp_kw(**STEP)
    ranks = run_ranks("toy_step_own", tmp_path, kw, 21)
    torch.set_num_threads(1)
    one = toy_step_own(None, kw, 21)
    adam_steps = STEP["num_updates_per_batch"] * STEP["num_minibatches"]
    for r, got in enumerate(ranks):
        rows = slice(4 * r, 4 * r + 4)
        assert float(got["normalizer"]["count"]) == float(one["normalizer"]["count"]) == 32
        for f in ("mean", "summed_variance", "std"):
            for k in TOY_OBS:
                np.testing.assert_allclose(got["normalizer"][f][k], one["normalizer"][f][k],
                                           rtol=0, atol=1e-6)
        for name, x in _leaves(got["state"]):
            np.testing.assert_array_equal(x, dict(_leaves(one["state"]))[name][rows],
                                          err_msg=name)
        for k, v in got["generators"].items():
            np.testing.assert_array_equal(v, one["generators"][k])
        np.testing.assert_array_equal(got["env_generator"], one["env_generator"])
        d = _params_diff(got["params"], one["params"])
        assert np.quantile(d, 0.99) <= 1e-6 and d.max() <= 2 * STEP["learning_rate"] * adam_steps
        for k, v in got["metrics"].items():
            np.testing.assert_allclose(v, one["metrics"][k], rtol=1e-3, atol=1e-5, err_msg=k)
    assert not _params_diff(ranks[0]["params"], ranks[1]["params"]).any()
    assert not _params_diff(ranks[0]["adam"], ranks[1]["adam"]).any()


# ---------------------------------------------------------------------------
# 5 and 6. ppo.train at world 2: kill-and-resume, full state, rank 0 writes
# ---------------------------------------------------------------------------


def test_kill_and_resume_at_world_2_reproduces_curve(tmp_path):
    """Killed after 2 epochs and auto-resumed, the world-2 run reproduces the
    uninterrupted curve and params exactly, both when rank 0 decides and
    broadcasts the epoch to resume and with resume_shared_fs, where every
    rank reads the shared directory itself and no broadcast runs."""
    r0, r1 = run_ranks("toy_kill_and_resume", tmp_path, str(tmp_path / "run"))
    a, b = r0["a"], r0["b"]
    assert len(a["evals"]) == 5 and len(b["evals"]) == 3
    for resumed in ("c", "d"):
        c = r0[resumed]
        assert len(c["evals"]) == 2
        merged = b["evals"] + c["evals"]
        assert [s for s, _ in merged] == [s for s, _ in a["evals"]]
        np.testing.assert_array_equal(np.asarray([v for _, v in merged], np.float64),
                                      np.asarray([v for _, v in a["evals"]], np.float64))
        for x, y in ((a, c), (r0[resumed], r1[resumed])):
            assert not _params_diff(x["params"], y["params"]).any()
            assert not _params_diff(x["normalizer"], y["normalizer"]).any()
    assert [r["c"]["broadcasts"] for r in (r0, r1)] == [1, 1]
    assert [r["d"]["broadcasts"] for r in (r0, r1)] == [0, 0]
    assert r1["a"]["evals"] == [] and r1["a"]["policy_calls"] == []  # only rank 0 reports


def test_world_2_full_state_layout_matches_world_1(tmp_path):
    """The same recipe at world 1 (this process) and world 2: the last
    full_<n>.npz has the same names, shapes and dtypes, the env batch at
    its global 8 rows; only rank 0's policy checkpoints exist."""
    d1, d2, pol = tmp_path / "w1", tmp_path / "w2", tmp_path / "policy"
    torch.set_num_threads(1)
    toy_train(pdist.EnvShard(), str(d1), num_evals=2)
    run_ranks("toy_train", tmp_path, str(d2), None, False, 2, str(pol))
    one = ckpt.load_full(ckpt.latest_full(str(d1))[1])
    two = ckpt.load_full(ckpt.latest_full(str(d2))[1])
    assert [e for e, _ in ckpt.list_full(str(d2))] == [e for e, _ in ckpt.list_full(str(d1))]
    assert list(one) == list(two)
    for k in one:
        assert (one[k].shape, one[k].dtype) == (two[k].shape, two[k].dtype), k
    assert two["env_state/reward"].shape == (8,)
    assert sorted(os.listdir(pol)) == ["rank0_0.npz", "rank0_2048.npz"]
    assert sorted(os.listdir(d2)) == ["full_00000.npz"]
